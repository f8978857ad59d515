"""Gate decision quality: loop-closure precision, recall and F1 on synthetic
multi-floor scenes with known ground truth.

Counterpart of ``mlis_tpu/eval/quality.py`` for the matcher, retrieval
and CricaVPR-rerank rows of ``bench.py``'s ``quality2`` mode:

* scenes: ``make_quality_scene`` (v1, one homography per revisit) and
  ``make_quality_scene_v2`` (layered planes seen from two camera poses:
  parallax, occlusion, scale change, floors 5/2/4/1 that share each
  place's structure at varying texture similarity). Each is one draw step
  (``draw_quality_scene*``, every random number from a ``torch.Generator``
  on the target device) and one deterministic render step
  (``render_quality_scene*``), so the JAX package's own draws can be fed
  to the render step;
* scoring: ``score_gate_decisions``, ``retrieval_recall`` and
  ``retrieval_metrics`` (with the CricaVPR rerank);
* ``build_verifier`` for every matcher family (LightGlue ``"trained"``
  and ``"random"``, ``"superglue"``, ``"loftr"``, ``"orb"``), and
  ``run_gate_quality``, which renders or takes a scene, runs
  ``FullGatePipeline.process`` and scores its decisions;
  ``run_gate_quality_rerank`` scores the same flow with the CricaVPR
  rerank in its retrieval stage.

The scenes drawn here are other scenes of the same distribution as the
JAX package's: its draws come from ``jax.random``.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from mlis_tpu_torch.eval.semantic_eval import LoopClosureMetrics
from mlis_tpu_torch.ops.image import resize_nhwc
from mlis_tpu_torch.ops.knn import cosine_topk
from mlis_tpu_torch.train.matcher_trainer import (  # noqa: F401 (the scene tests' helpers)
    Draws,
    _blob_mask,
    _plane_homography,
    _rotation_matrix,
    draw_homography_jitter,
    draw_texture_noise,
    random_homography,
    synthetic_textures,
    uniform_range,
    warp_image,
)

RENDER_CHUNK = 32  # frames warped at once by the v2 render step


@dataclass
class QualityScene:
    images: np.ndarray  # (N, H, W) mono8
    timestamps: np.ndarray  # (N,)
    floors: np.ndarray  # (N,) int
    gt_pairs: Set[Tuple[int, int]]  # true loop closures, (lo, hi)
    aliased_pairs: Set[Tuple[int, int]]  # cross-floor same-structure traps
    K: np.ndarray  # 3x3 intrinsics for the verifier


def _intrinsics(H: int, W: int) -> List[List[float]]:
    f = 200.0 * (W / 360.0)
    return [[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]]


def _generator(seed: int, generator: Optional[torch.Generator], device) -> torch.Generator:
    return generator if generator is not None else torch.Generator(device=device).manual_seed(seed)


# -- v1: one homography per revisit ------------------------------------------------

@dataclass
class SceneDrawsV1(Draws):
    tex_grids: List[torch.Tensor]  # U[0, 1) block noise of the P textures, per scale
    tex_gains: torch.Tensor  # (P, 2) N(0, 1) ramp gains
    corners: torch.Tensor  # (N, 4, 2) U[0, 1) corner draws
    bright: torch.Tensor  # (N,) U[0, 1) brightness draws


def draw_quality_scene(n_places: int = 8, hw: Tuple[int, int] = (270, 360), seed: int = 0,
                       generator: Optional[torch.Generator] = None,
                       device="cuda") -> SceneDrawsV1:
    g = _generator(seed, generator, device)
    H, W = hw
    grids, gains = draw_texture_noise(n_places, H, W, g, device)
    N = 4 * n_places
    corners = draw_homography_jitter(N, g, device)
    bright = torch.rand((N,), generator=g, device=device)
    return SceneDrawsV1(grids, gains, corners, bright)


def render_quality_scene(draws: SceneDrawsV1, n_places: int = 8,
                         hw: Tuple[int, int] = (270, 360), corner_jitter: float = 0.08,
                         brightness_jitter: float = 0.08, frame_dt: float = 6.0) -> QualityScene:
    """Two floors (5, 2) x n_places x two passes -> 4 n_places keyframes,
    visited per floor as [pass 1 places 0..P-1, pass 2 places 0..P-1]. The
    first pass on floor 5 is the canonical view; every other observation
    is warped by its own homography. Floor 2 reuses floor 5's textures, so
    every cross-floor pair of a place is an aliased trap."""
    H, W = hw
    P = n_places
    textures = synthetic_textures(draws.tex_grids, draws.tex_gains, H, W)
    N = 4 * P
    bright = uniform_range(draws.bright, -brightness_jitter, brightness_jitter)
    place = torch.arange(N, device=textures.device) % P
    Hm = random_homography(draws.corners, H, W, corner_jitter)
    warped = warp_image(textures[place], Hm)
    canonical = (torch.arange(N, device=textures.device) < P)[:, None, None]
    obs = torch.where(canonical, textures[place], warped)
    obs = (obs + bright[:, None, None]).clamp(0.0, 1.0)
    images = (obs * 255.0).to(torch.uint8).cpu().numpy()
    timestamps = np.arange(N) * frame_dt
    floors = np.asarray([5] * (2 * P) + [2] * (2 * P))

    # ground truth: the two observations of a place on the SAME floor;
    # aliased traps: observations of the same texture on DIFFERENT floors
    gt_pairs, aliased = set(), set()
    for p in range(P):
        f5 = (p, p + P)
        f2 = (2 * P + p, 3 * P + p)
        gt_pairs.add(f5)
        gt_pairs.add(f2)
        for a in f5:
            for b in f2:
                aliased.add((min(a, b), max(a, b)))
    return QualityScene(images, timestamps, floors, gt_pairs, aliased, np.array(_intrinsics(H, W)))


def make_quality_scene(n_places: int = 8, hw: Tuple[int, int] = (270, 360),
                       corner_jitter: float = 0.08, brightness_jitter: float = 0.08,
                       frame_dt: float = 6.0, seed: int = 0,
                       generator: Optional[torch.Generator] = None,
                       device="cuda") -> QualityScene:
    """Draw and render a v1 scene on ``device`` (see :func:`render_quality_scene`)."""
    draws = draw_quality_scene(n_places, hw, seed, generator, device)
    return render_quality_scene(draws, n_places, hw, corner_jitter, brightness_jitter, frame_dt)


# -- v2: layered planes under two camera poses -------------------------------------

@dataclass
class SceneDrawsV2(Draws):
    fam_grids: List[torch.Tensor]  # texture families, P * L textures
    fam_gains: torch.Tensor
    uni_grids: List[torch.Tensor]  # per-floor uniqueness, F * P * L textures
    uni_gains: torch.Tensor
    mask_noise: torch.Tensor  # (P, L - 1, H // 40 + 2, W // 40 + 2) layer-mask noise
    angles: torch.Tensor  # (N, 3) U[0, 1) rotation draws
    trans: torch.Tensor  # (N, 3) U[0, 1) translation draws
    occ_apply: torch.Tensor  # (N,) U[0, 1): occluder present where < occluder_prob
    occ_noise: torch.Tensor  # (N, H // 64 + 2, W // 64 + 2) occluder-mask noise
    bright: torch.Tensor  # (N,) U[0, 1) brightness draws
    occ_grids: List[torch.Tensor]  # the 8 occluder textures
    occ_gains: torch.Tensor


def _floors_list(n_floors: int) -> List[int]:
    return ([5, 2, 4, 1] + list(range(6, 6 + max(0, n_floors - 4))))[:n_floors]


def draw_quality_scene_v2(n_floors: int = 4, n_places: int = 32,
                          hw: Tuple[int, int] = (270, 360), n_layers: int = 3, seed: int = 0,
                          generator: Optional[torch.Generator] = None,
                          device="cuda") -> SceneDrawsV2:
    g = _generator(seed, generator, device)
    H, W = hw
    P, F, L = n_places, n_floors, n_layers
    N = F * 2 * P
    fam = draw_texture_noise(P * L, H, W, g, device)
    uni = draw_texture_noise(F * P * L, H, W, g, device)
    mask_noise = torch.rand((P, L - 1, H // 40 + 2, W // 40 + 2), generator=g, device=device)
    angles = torch.rand((N, 3), generator=g, device=device)
    trans = torch.rand((N, 3), generator=g, device=device)
    occ_apply = torch.rand((N,), generator=g, device=device)
    occ_noise = torch.rand((N, H // 64 + 2, W // 64 + 2), generator=g, device=device)
    bright = torch.rand((N,), generator=g, device=device)
    occ = draw_texture_noise(8, H, W, g, device)
    return SceneDrawsV2(*fam, *uni, mask_noise, angles, trans, occ_apply, occ_noise, bright, *occ)


def render_quality_scene_v2(
    draws: SceneDrawsV2,
    n_floors: int = 4,
    n_places: int = 32,
    hw: Tuple[int, int] = (270, 360),
    depths: Tuple[float, ...] = (4.0, 7.0, 12.0),
    layer_coverage: Tuple[float, ...] = (0.22, 0.40, 1.0),
    max_rot_deg: float = 5.0,
    max_trans: float = 0.45,
    max_trans_z: float = 1.2,
    occluder_frac: float = 0.20,
    occluder_prob: float = 0.6,
    brightness_jitter: float = 0.10,
    alias_strengths: Tuple[float, ...] = (1.0, 0.85, 0.7),
    frame_dt: float = 6.0,
) -> QualityScene:
    """Each place is ``len(depths)`` fronto-parallel textured layers (the
    near ones behind irregular blob masks, the farthest a full wall). The
    second pass renders the same layers from a random pose (rotation up to
    max_rot_deg, translation up to max_trans / max_trans_z metres), every
    layer warped by its own plane-induced homography: real parallax,
    occlusion edges and scale change, consistent with one essential matrix
    and with no single homography. A near occluder hides ~occluder_frac of
    a share of the revisits. Floor 0 sees each place's texture family;
    floor k > 0 blends it with its own texture at the place's alias
    strength, so cross-floor traps come at varying similarity.

    n_floors x n_places x 2 passes keyframes, each floor's frames as
    [pass 1 places 0..P-1, pass 2 places 0..P-1]."""
    H, W = hw
    P, F, L = n_places, n_floors, len(depths)
    dev = draws.angles.device
    floors_list = _floors_list(F)
    fam = synthetic_textures(draws.fam_grids, draws.fam_gains, H, W).reshape(P, L, H, W)
    uni = synthetic_textures(draws.uni_grids, draws.uni_gains, H, W).reshape(F, P, L, H, W)
    alpha = torch.tensor([alias_strengths[p % len(alias_strengths)] for p in range(P)],
                         dtype=torch.float32, device=dev)

    # layer support masks, per (place, layer) and shared across floors; the
    # farthest layer has full support
    masks = torch.ones((P, L, H, W), dtype=torch.float32, device=dev)
    for l in range(L - 1):
        masks[:, l] = _blob_mask(draws.mask_noise[:, l], H, W, layer_coverage[l])

    K = torch.tensor(_intrinsics(H, W), dtype=torch.float32, device=dev)
    Kinv = torch.linalg.inv(K)

    N = F * 2 * P
    frame = np.arange(N)
    fi_arr, pass_arr, p_arr = frame // (2 * P), (frame // P) % 2, frame % P
    p2 = torch.as_tensor((pass_arr == 1).astype(np.float32), device=dev)
    rot = float(torch.deg2rad(torch.tensor(max_rot_deg, dtype=torch.float32)))
    angles = uniform_range(draws.angles, -rot, rot) * p2[:, None]
    ts = (uniform_range(draws.trans, -1.0, 1.0)
          * torch.tensor([max_trans, max_trans, max_trans_z], dtype=torch.float32, device=dev)
          * p2[:, None])
    Rs = _rotation_matrix(angles)
    occ_apply = ((draws.occ_apply < occluder_prob) & (p2 > 0)).to(torch.float32)
    occ_masks = _blob_mask(draws.occ_noise, H, W, occluder_frac, block=64) * occ_apply[:, None, None]
    occ_tex = synthetic_textures(draws.occ_grids, draws.occ_gains, H, W)
    bright = uniform_range(draws.bright, -brightness_jitter, brightness_jitter)

    frames = []
    for s in range(0, N, RENDER_CHUNK):
        sl = slice(s, min(s + RENDER_CHUNK, N))
        fi = torch.as_tensor(fi_arr[sl], device=dev)
        pi = torch.as_tensor(p_arr[sl], device=dev)
        a = alpha[pi][:, None, None, None]
        tex = torch.where((fi == 0)[:, None, None, None], fam[pi], a * fam[pi] + (1 - a) * uni[fi, pi])
        out = torch.zeros((len(fi), H, W), dtype=torch.float32, device=dev)
        for l in range(L - 1, -1, -1):
            Hm = _plane_homography(K, Kinv, Rs[sl], ts[sl], depths[l])
            img_l = warp_image(tex[:, l], Hm)
            m_l = warp_image(masks[pi, l], Hm)
            # the farthest (full-support) layer keeps zero fill where its
            # source left the view
            out = torch.where(m_l > 0.5, img_l, out)
        occ_t = occ_tex[torch.as_tensor(frame[sl] % occ_tex.shape[0], device=dev)]
        out = torch.where(occ_masks[sl] > 0.5, occ_t, out)
        out = (out + bright[sl, None, None]).clamp(0.0, 1.0)
        frames.append((out * 255.0).to(torch.uint8))
    images = torch.cat(frames).cpu().numpy()
    timestamps = np.arange(N) * frame_dt
    floors = np.asarray([floors_list[f] for f in fi_arr])

    # GT: each place's pass-1/pass-2 observations on the same floor; traps:
    # its cross-floor observation pairs (texture similarity = its alpha)
    gt_pairs, aliased = set(), set()

    def obs_idx(fi, pass_i, p):
        return fi * 2 * P + pass_i * P + p

    for p in range(P):
        per_floor = [(obs_idx(fi, 0, p), obs_idx(fi, 1, p)) for fi in range(F)]
        gt_pairs.update(per_floor)
        for fi in range(F):
            for fj in range(fi + 1, F):
                for a in per_floor[fi]:
                    for b in per_floor[fj]:
                        aliased.add((min(a, b), max(a, b)))
    return QualityScene(images, timestamps, floors, gt_pairs, aliased, K.cpu().numpy())


def make_quality_scene_v2(n_floors: int = 4, n_places: int = 32,
                          hw: Tuple[int, int] = (270, 360), seed: int = 0,
                          generator: Optional[torch.Generator] = None, device="cuda",
                          **render_kw) -> QualityScene:
    """Draw and render a v2 scene on ``device`` (see
    :func:`render_quality_scene_v2` for the keywords)."""
    n_layers = len(render_kw.get("depths", (4.0, 7.0, 12.0)))
    draws = draw_quality_scene_v2(n_floors, n_places, hw, n_layers, seed, generator, device)
    return render_quality_scene_v2(draws, n_floors, n_places, hw, **render_kw)


# -- scoring -------------------------------------------------------------------------

def _pixel_encoder(imgs) -> torch.Tensor:
    """Deterministic VPR encoder: grey, antialiased bilinear resize to 18x24,
    mean-centred and L2-normalised. A warped revisit stays nearby in this
    space, so the benchmark isolates the gate and verification decisions."""
    x = torch.as_tensor(imgs).to(torch.float32)
    if x.dim() == 4:
        x = x.mean(-1)
    pooled = resize_nhwc(x[..., None], (18, 24), antialias=True).reshape(x.shape[0], -1)
    pooled = pooled - pooled.mean(dim=1, keepdim=True)
    return pooled / (torch.linalg.vector_norm(pooled, dim=1, keepdim=True) + 1e-8)


def score_gate_decisions(res, scene: QualityScene) -> LoopClosureMetrics:
    """Score a FullGateResult's final decisions (accepted and geometrically
    valid) against the scene's ground truth."""
    accepted = {
        (min(r.query_idx, r.match_idx), max(r.query_idx, r.match_idx))
        for r in res.results
        if r.is_valid
    }
    gt = scene.gt_pairs
    fl = scene.floors
    cross_valid = sum(1 for a, b in accepted if fl[a] != fl[b])
    return LoopClosureMetrics(
        total_candidates=res.total_pairs,
        true_positives=len(accepted & gt),
        false_positives=len(accepted - gt),
        false_negatives=len(gt - accepted),
        same_floor_candidates=res.total_pairs - res.cross_floor_rejected - cross_valid,
        cross_floor_candidates=res.cross_floor_rejected + cross_valid,
        cross_floor_rejected=res.cross_floor_rejected,
    )


def _retrieve(scene: QualityScene, db: torch.Tensor, k: int, min_time_gap: float):
    t = torch.as_tensor(np.asarray(scene.timestamps, np.float32), device=db.device)
    scores, idx = cosine_topk(db, db, t, t, k=k, min_time_gap=min_time_gap)
    return scores.cpu().numpy(), idx.cpu().numpy()


def retrieval_recall(scene: QualityScene, encoder, top_k: int = 5, threshold: float = 0.5,
                     min_time_gap: float = 10.0, device="cuda") -> float:
    """Share of GT pairs that retrieval surfaces (before any gating)."""
    db = encoder(torch.as_tensor(scene.images, device=device))
    scores, idx = _retrieve(scene, db, top_k, min_time_gap)
    found = set()
    for q in range(len(scene.images)):
        for kk in range(scores.shape[1]):
            if np.isfinite(scores[q, kk]) and scores[q, kk] >= threshold:
                m = int(idx[q, kk])
                found.add((min(q, m), max(q, m)))
    return len(found & scene.gt_pairs) / max(len(scene.gt_pairs), 1)


def retrieval_metrics(
    scene: QualityScene,
    vpr,  # encoder fn (B, H, W) -> (B, D), or a CricaVPR-style instance
    top_k: int = 16,
    threshold: float = 0.3,
    min_time_gap: float = 10.0,
    rerank: bool = False,
    rerank_pool: Optional[int] = None,
    device="cuda",
) -> Dict:
    """Retrieval-stage quality: GT recall@k, aliased-trap rate, GT found,
    with or without the CricaVPR rerank (a pool of 2 top_k by global
    cosine, re-scored as (1 - w) global + w patch correlation, the re-sorted
    top_k kept). The threshold stays on the global cosine score, so the
    rerank changes which pairs make the top-k cut. ``rerank`` needs an
    instance with a patch cache and ``rerank_scores_all``."""
    imgs = torch.as_tensor(scene.images, device=device)
    if hasattr(vpr, "encode_batch_device"):
        if hasattr(vpr, "patch_cache"):
            vpr.patch_cache = []
            vpr._patch_matrix = None
        db = vpr.encode_batch_device(imgs)
    else:
        db = vpr(imgs)
        if rerank:
            raise ValueError("rerank requires a CricaVPR-style instance")
    N = int(db.shape[0])
    pool = int(rerank_pool or 2 * top_k) if rerank else top_k
    scores, idx = _retrieve(scene, db, min(pool, N), min_time_gap)
    if rerank:
        cc = vpr.rerank_scores_all(np.arange(N), idx)
        w = getattr(vpr, "rerank_weight", 0.5)
        mixed = np.where(np.isfinite(scores), (1 - w) * scores + w * cc, -np.inf)
        order = np.argsort(-mixed, axis=1)[:, :top_k]
        rows = np.arange(N)[:, None]
        scores, idx = scores[rows, order], idx[rows, order]

    found = set()
    n_above = n_aliased = 0
    for q in range(N):
        for kk in range(scores.shape[1]):
            if np.isfinite(scores[q, kk]) and scores[q, kk] >= threshold:
                m = int(idx[q, kk])
                pair = (min(q, m), max(q, m))
                found.add(pair)
                n_above += 1
                if pair in scene.aliased_pairs:
                    n_aliased += 1
    hits = found & scene.gt_pairs
    return {
        "retrieval_recall": len(hits) / max(len(scene.gt_pairs), 1),
        "aliased_rate": n_aliased / max(n_above, 1),
        "candidates_above_threshold": n_above,
        "gt_found": len(hits),
        "rerank": bool(rerank),
        "top_k": top_k,
    }


# calibrated SuperGlue-family confident-match cut (mlis_tpu's v2 seeds 0-3,
# validated on 4-7)
SUPERGLUE_CONFIDENT_CUT = 16
# the coarse threshold of the shipped LoFTR checkpoints: they are
# conservative, so a low threshold buys recall (mlis_tpu's quality runs)
LOFTR_TRAINED_MATCH_THRESHOLD = 0.05


def build_verifier(
    matcher: str,
    max_keypoints: int,
    hw: Tuple[int, int],
    weights_path: Optional[str] = None,
    min_confident_matches: int = 6,
    loftr_match_threshold: Optional[float] = None,
    device="cuda",
    model_dtype: torch.dtype = torch.bfloat16,
):
    """(GeometricVerifier, weights label) for a matcher family:

    * "trained" loads the shipped LightGlue checkpoint (the 540x720-trained
      one when hw is 540 rows or more; ``weights_path`` overrides), its
      structure read from the npz; "random" keeps a random initialisation;
      both accept a pair only with at least ``min_confident_matches``
      matches of score >= 0.5;
    * "superglue" loads ``weights_path`` or the homography-trained
      SuperGlue, with the family's confident cut of 16;
    * "loftr" loads ``weights_path`` or the homography-trained LoFTR, with
      the coarse threshold ``loftr_match_threshold`` (0.05 when a checkpoint
      loads, else the config's 0.2);
    * "orb" is weight-free ("orb_weight_free").

    Without its checkpoint a family keeps a random initialisation and
    reports "random_init". ``model_dtype`` is the learned models' compute
    dtype: bf16 as shipped, float32 for parity checks."""
    from mlis_tpu_torch.gating.verification import GeometricVerifier
    from mlis_tpu_torch.models.lightglue import LightGlue, MatcherConfig, SuperGlue
    from mlis_tpu_torch.models.superpoint import SuperPointConfig
    from mlis_tpu_torch.weights import (
        default_fullres_matcher_checkpoint,
        default_loftr_checkpoint,
        default_matcher_checkpoint,
        default_superglue_checkpoint,
        matcher_arch_from_npz,
    )

    if matcher == "orb":
        from mlis_tpu_torch.models.orb import ORBMatcher

        return GeometricVerifier(matcher=ORBMatcher(device=device)), "orb_weight_free"
    if matcher == "loftr":
        from mlis_tpu_torch.models.loftr import LoFTR, LoFTRConfig

        path = weights_path or default_loftr_checkpoint()
        have = bool(path and os.path.exists(path))
        if loftr_match_threshold is None and have:
            loftr_match_threshold = LOFTR_TRAINED_MATCH_THRESHOLD
        cfg = LoFTRConfig(dtype=model_dtype)
        if loftr_match_threshold is not None:
            cfg = dataclasses.replace(cfg, match_threshold=loftr_match_threshold)
        lf, weights = LoFTR(cfg, device=device), "random_init"
        if have:
            lf.load_weights(path, image_hw=hw)
            weights = os.path.basename(path)
        return GeometricVerifier(matcher=lf), weights
    if matcher == "superglue":
        sg = SuperGlue(sp_cfg=SuperPointConfig(max_keypoints=max_keypoints, dtype=model_dtype),
                       matcher_cfg=MatcherConfig.superglue(dtype=model_dtype), device=device)
        weights = "random_init"
        path = weights_path or default_superglue_checkpoint()
        if path and os.path.exists(path):
            sg.load_weights(path, image_hw=hw)
            weights = os.path.basename(path)
        return GeometricVerifier(matcher=sg, min_confident_matches=SUPERGLUE_CONFIDENT_CUT), weights
    if matcher not in ("trained", "random"):
        raise ValueError(f"unknown matcher family {matcher!r}")
    weights, path = "random_init", None
    if matcher == "trained":
        default = (default_fullres_matcher_checkpoint() if hw[0] >= 540
                   else default_matcher_checkpoint())
        path = weights_path or default
        if not (path and os.path.exists(path)):
            path = None
    cfg_kw = matcher_arch_from_npz(path) if path else {}
    lg = LightGlue(sp_cfg=SuperPointConfig(max_keypoints=max_keypoints, dtype=model_dtype),
                   matcher_cfg=MatcherConfig.lightglue(**cfg_kw, dtype=model_dtype),
                   device=device)
    if path:
        lg.load_weights(path)
        weights = os.path.basename(path)
    return GeometricVerifier(matcher=lg, min_confident_matches=min_confident_matches), weights


def _encoder_for(encoder: str, device):
    """(encode fn or None, the encoder's name as it ran): the trained tiny
    encoders fall back to the homography-trained checkpoint, then to the
    pixel encoder; CricaVPR and MixVPR run random weights without their
    checkpoint. Any other name returns None (the gate builds it)."""
    if encoder in ("trained_vpr", "trained_vpr_v2"):
        from mlis_tpu_torch.train.pretrain_vpr import load_encoder

        enc = None
        if encoder == "trained_vpr_v2":
            enc = load_encoder("checkpoints/vpr_tiny_v2.npz", device=device)
            if enc is None:
                encoder = "trained_vpr"
        if enc is None:
            enc = load_encoder(device=device)
        if enc is None:
            return _pixel_encoder, "pixel"
        return enc, encoder
    if encoder == "pixel":
        return _pixel_encoder, encoder
    if encoder == "cricavpr_trained":
        from mlis_tpu_torch.models.cricavpr import CricaVPR
        from mlis_tpu_torch.weights import default_crica_checkpoint

        have = default_crica_checkpoint() is not None
        crica = CricaVPR(checkpoint="auto" if have else None, device=device)
        return crica.encode_batch_device, encoder if have else "cricavpr_random"
    if encoder == "mixvpr_trained":
        from mlis_tpu_torch.models.mixvpr import MixVPR
        from mlis_tpu_torch.weights import default_mixvpr_checkpoint

        have = default_mixvpr_checkpoint() is not None
        mv = MixVPR(checkpoint="auto" if have else None, device=device)
        return mv.encode_batch_device, encoder if have else "mixvpr_random"
    return None, encoder


def run_gate_quality(
    matcher: str = "trained",  # 'trained' | 'random' | 'orb' | 'loftr' | 'superglue'
    # 'trained_vpr' | 'trained_vpr_v2' | 'pixel' | 'cricavpr_trained' |
    # 'mixvpr_trained', or a VPR method the gate builds itself
    encoder: str = "trained_vpr",
    n_places: int = 8,
    hw: Tuple[int, int] = (270, 360),
    max_keypoints: int = 512,
    strict_floor: bool = True,
    floor_gate: bool = True,  # False = ablation: no floor gating at all
    top_k: int = 8,
    similarity_threshold: float = 0.45,
    verify_batch: int = 64,
    seed: int = 0,
    scene: Optional[QualityScene] = None,
    weights_path: Optional[str] = None,
    match_top_k: Optional[int] = None,
    ransac_subset: int = 0,
    min_confident_matches: int = 6,
    loftr_match_threshold: Optional[float] = None,
    return_pairs: bool = False,
    ransac_uniforms: Optional[torch.Tensor] = None,
    model_dtype: torch.dtype = torch.bfloat16,
    device="cuda",
) -> Dict:
    """Build (or take) the scene, run the full gate, score its decisions.

    Returns a flat JSON-ready dict: precision, recall, F1, gating
    effectiveness, retrieval recall and the raw counts (with ``pairs``, the
    per-pair outcomes, when ``return_pairs``; each also carries its inlier
    ratio, which the reference's pairs leave out). ``ransac_uniforms`` goes
    straight to ``FullGatePipeline.process``: (n_survivors, 512, 8) draws,
    one block per survivor in compaction order. ``model_dtype`` and
    ``loftr_match_threshold`` go to ``build_verifier``."""
    from mlis_tpu_torch.gating.full_gate import FullGatePipeline

    scene = scene or make_quality_scene(n_places=n_places, hw=hw, seed=seed, device=device)
    verifier, weights = build_verifier(matcher, max_keypoints, hw, weights_path,
                                       min_confident_matches, loftr_match_threshold,
                                       device=device, model_dtype=model_dtype)
    enc_fn, encoder = _encoder_for(encoder, device)
    common = dict(
        verifier=verifier, top_k=top_k, similarity_threshold=similarity_threshold,
        min_time_gap=10.0, verify_batch=verify_batch, strict_floor=strict_floor,
        # the verifier already holds its weights: "auto" would load the
        # homography checkpoint over them
        matcher_weights=None, match_top_k=match_top_k, ransac_subset=ransac_subset,
        device=device,
    )
    if enc_fn is not None:
        pipe = FullGatePipeline(
            vpr=SimpleNamespace(vpr=SimpleNamespace(encode_batch_device=enc_fn)), **common)
    else:
        pipe = FullGatePipeline(vpr_method=encoder, **common)
        enc_fn = getattr(pipe.spr.vpr, "encode_batch_device", None)

    # no-gate ablation: constant floor labels send every candidate to
    # verification; decisions are still scored against the real floors
    fl = scene.floors if floor_gate else np.zeros_like(scene.floors)
    res = pipe.process(scene.images, scene.timestamps, fl, scene.K, encode_batch_size=64,
                       ransac_uniforms=ransac_uniforms)
    m = score_gate_decisions(res, scene)
    rr = (retrieval_recall(scene, enc_fn, top_k=top_k, threshold=similarity_threshold,
                           device=device)
          if enc_fn is not None else float("nan"))
    return {
        "matcher": matcher,
        "weights": weights,
        "encoder": encoder,
        "strict_floor": strict_floor,
        "n_frames": int(len(scene.images)),
        "gt_pairs": len(scene.gt_pairs),
        "precision": m.precision,
        "recall": m.recall,
        "f1": m.f1_score,
        "retrieval_recall": rr,
        "gating_effectiveness": m.gating_effectiveness,
        "cross_floor_rate": m.cross_floor_rate,
        "total_candidates": m.total_candidates,
        "true_positives": m.true_positives,
        "false_positives": m.false_positives,
        "false_negatives": m.false_negatives,
        "verified": res.verified,
        "geometrically_valid": res.geometrically_valid,
        "elapsed_s": res.elapsed_s,
        "pairs": [
            {
                "q": int(r.query_idx),
                "m": int(r.match_idx),
                "is_valid": bool(r.is_valid),
                "num_inliers": int(r.num_inliers),
                "inlier_ratio": float(r.inlier_ratio),
                "num_confident_matches": int(r.num_confident_matches),
            }
            for r in res.results
        ] if return_pairs else None,
    }


def run_gate_quality_rerank(
    scene: QualityScene,
    rerank: bool = True,
    matcher: str = "trained",
    top_k: int = 16,
    similarity_threshold: float = 0.3,
    rerank_pool: Optional[int] = None,
    max_keypoints: int = 512,
    min_time_gap: float = 10.0,
    min_confident_matches: int = 6,
    weights_path: Optional[str] = None,
    crica=None,
    ransac_uniforms: Optional[torch.Tensor] = None,
    device="cuda",
) -> Dict:
    """End-to-end decisions with the CricaVPR rerank in the retrieval stage:
    a cosine pool of 2 top_k, re-sorted by 0.5 global + 0.5 patch
    correlation, the top_k kept, then the threshold (on the global score),
    the strict floor gate and fused match + RANSAC verification in batches
    of 64, scored against the scene's ground truth. ``rerank=False`` runs
    the same flow without the re-sort, so the F1 difference is the rerank's
    end-decision value. ``crica`` reuses one encoder across the A/B pair
    (its patch cache is refilled); without it the shipped ``vpr_crica.npz``
    is loaded, or a random CricaVPR when it is not there.
    ``ransac_uniforms`` is as in :func:`run_gate_quality`."""
    from mlis_tpu_torch.gating.full_gate import FullGatePipeline
    from mlis_tpu_torch.gating.gate import gate_mask

    if crica is None:
        from mlis_tpu_torch.models.cricavpr import CricaVPR
        from mlis_tpu_torch.train.pretrain_vpr import load_crica_vpr

        crica, encoder_name = load_crica_vpr(device=device), "cricavpr_trained"
        if crica is None:
            crica, encoder_name = CricaVPR(checkpoint=None, device=device), "cricavpr_random"
    else:
        encoder_name = "cricavpr_provided"

    imgs = torch.as_tensor(scene.images, device=device)
    crica.patch_cache = []
    crica._patch_matrix = None
    db = crica.encode_batch_device(imgs)
    N = int(db.shape[0])
    pool = int(rerank_pool or 2 * top_k) if rerank else top_k
    scores, idx = _retrieve(scene, db, min(pool, N), min_time_gap)
    if rerank:
        cc = crica.rerank_scores_all(np.arange(N), idx)
        w = getattr(crica, "rerank_weight", 0.5)
        mixed = np.where(np.isfinite(scores), (1 - w) * scores + w * cc, -np.inf)
        order = np.argsort(-mixed, axis=1)[:, :top_k]
        rows = np.arange(N)[:, None]
        scores, idx = scores[rows, order], idx[rows, order]

    qi, kk = np.nonzero(np.isfinite(scores) & (scores >= similarity_threshold))
    mj = idx[qi, kk]
    pairs = np.unique(np.stack([np.minimum(qi, mj), np.maximum(qi, mj)], axis=1), axis=0)
    total = len(pairs)
    survivors, rejected = pairs, 0
    if total:
        accept = gate_mask(torch.as_tensor(np.asarray(scene.floors)),
                           torch.as_tensor(pairs[:, 0]), torch.as_tensor(pairs[:, 1]),
                           True).numpy()
        survivors, rejected = pairs[accept], int((~accept).sum())

    verifier, weights = build_verifier(matcher, max_keypoints, tuple(imgs.shape[1:3]),
                                       weights_path, min_confident_matches, device=device)
    pipe = FullGatePipeline(vpr=SimpleNamespace(vpr=SimpleNamespace(encode_batch_device=None)),
                            verifier=verifier, verify_batch=64, matcher_weights=None,
                            device=device)
    results = []
    if len(survivors):
        qs, ms = (torch.as_tensor(survivors[:, c], device=device) for c in (0, 1))
        results = pipe._verify_survivors(pipe._detect_all(imgs), qs, ms, scene.K,
                                         tuple(imgs.shape[1:3]), ransac_uniforms, None)
    res = SimpleNamespace(results=results, total_pairs=total, cross_floor_rejected=rejected,
                          verified=len(results))
    m = score_gate_decisions(res, scene)
    return {
        "matcher": matcher,
        "weights": weights,
        "encoder": encoder_name,
        "rerank": bool(rerank),
        "precision": m.precision,
        "recall": m.recall,
        "f1": m.f1_score,
        "gating_effectiveness": m.gating_effectiveness,
        "total_candidates": total,
        "cross_floor_rejected": rejected,
        "verified": len(results),
        "true_positives": m.true_positives,
        "false_positives": m.false_positives,
    }


# the cuts a decision is made at: GeometricVerifier's inlier count and
# inlier ratio, and each family's confident-match cut (None where the
# matcher reports no confident count: LoFTR, ORB)
DECISION_CUTS = {"num_inliers": 20, "inlier_ratio": 0.25}
CONFIDENT_CUTS = {"trained": 6, "random": 6, "superglue": SUPERGLUE_CONFIDENT_CUT,
                  "loftr": None, "orb": None}
RATIO_BAND = 0.01


def decision_drift(a: List[Dict], b: List[Dict], conf_band: int, inlier_band: int,
                   bound_inliers: bool, confident_cut: Optional[int] = 6,
                   ) -> Tuple[Dict, List[Tuple[Dict, Dict]]]:
    """Two runs' ``pairs`` on the same verified pairs, held to the band rule.

    Confident matches must agree within ``conf_band``. A decision may differ
    only where a count of either run lies in the band around its cut:
    ``conf_band`` of the family's ``confident_cut`` (6 for LightGlue, 16 for
    SuperGlue, None for a family without confident counts), ``inlier_band``
    of 20 inliers or 0.01 of a 0.25 inlier ratio (a pair without
    ``inlier_ratio``, as the JAX package's are, is judged on its counts).
    With ``bound_inliers``, inliers must also agree within ``inlier_band``
    on every pair that reaches the confident cut in either run (every pair
    when there is no cut). Returns the drift and the pairs that break the
    rule."""
    if [(p["q"], p["m"]) for p in a] != [(p["q"], p["m"]) for p in b]:
        raise ValueError("the two runs verified different pairs")
    cuts = DECISION_CUTS
    stats = {"pairs": len(a), "pairs_in_band": 0, "decisions_differing": 0,
             "max_confident_diff": 0, "max_inlier_diff": 0, "max_inlier_diff_past_cut": 0}
    broken = []
    for x, y in zip(a, b):
        conf_diff = abs(x["num_confident_matches"] - y["num_confident_matches"])
        inl_diff = abs(x["num_inliers"] - y["num_inliers"])
        if confident_cut is None:
            past_cut, near_conf = True, False
        else:
            past_cut = max(x["num_confident_matches"],
                           y["num_confident_matches"]) >= confident_cut
            near_conf = any(abs(p["num_confident_matches"] - confident_cut) <= conf_band
                            for p in (x, y))
        band = near_conf or any(abs(p["num_inliers"] - cuts["num_inliers"]) <= inlier_band
                                or abs(p.get("inlier_ratio", np.inf) - cuts["inlier_ratio"])
                                <= RATIO_BAND for p in (x, y))
        stats["pairs_in_band"] += band
        stats["decisions_differing"] += x["is_valid"] != y["is_valid"]
        stats["max_confident_diff"] = max(stats["max_confident_diff"], conf_diff)
        stats["max_inlier_diff"] = max(stats["max_inlier_diff"], inl_diff)
        if past_cut:
            stats["max_inlier_diff_past_cut"] = max(stats["max_inlier_diff_past_cut"], inl_diff)
        if (conf_diff > conf_band or (not band and x["is_valid"] != y["is_valid"])
                or (bound_inliers and past_cut and inl_diff > inlier_band)):
            broken.append((x, y))
    return stats, broken
