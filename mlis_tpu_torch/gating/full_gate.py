"""Full semantic gate: VPR retrieval -> floor gate -> geometric verification.

Counterpart of ``mlis_tpu/gating/full_gate.py``. Stage order:

1. keypoints detected once per keyframe (SuperPoint, optionally pruned to
   the top ``match_top_k`` by score) and VPR descriptors (CricaVPR by
   default, or MixVPR);
2. cosine top-k retrieval with the temporal mask, unique (lo, hi) pairs
   above the similarity threshold, the strict floor gate and survivor
   compaction in ascending (lo, hi) order -- all on the device
   (:func:`_gate_compact`);
3. LightGlue (or SuperGlue) matching + essential RANSAC + cheirality pose
   on the survivors' pre-detected keypoints, in batches of
   ``verify_batch`` pairs. A matcher without ``make_fused_match_verify``
   (LoFTR, ORB) instead gets the survivors' grayscale pairs (the keyframes
   converted once) through ``GeometricVerifier.verify_pairs_batch`` with
   ``batch_size=verify_batch``; no keypoints are detected up front.

``process`` runs one of three paths, as the JAX package does:

* the exact two-phase path above (no ``survivor_budget``);
* the budgeted path (``survivor_budget`` set): stage 2 compacts the
  survivors into a static number of slots on the device, the fused
  matcher runs over them in power-of-two buckets, and one packed fetch
  brings back every pair, result and count;
* the one-fetch path (``monolithic=True``): the keyframes uploaded once
  (not copied when already on the pipeline's device), detect and encode
  of every frame in one call each, the static gate, one fused call over
  all slots, one packed fetch. ``upload_chunk`` changes nothing here: the
  JAX package uploads host keyframes in slices to hide a high-latency link
  to its TPU, and its sliced program is pinned bit-identical to the
  single one, so one upload gives the same result.

"One packed fetch" is the results' single device-to-host copy; the
matcher and RANSAC still synchronise with the host inside a fused call.

A budget path whose survivors overflow its slots runs the exact path's
retrieval and verification on the keypoints and descriptors it already
has on the device, so the result never depends on the budget.

Each stage runs inside a ``torch.profiler`` range (``gate.detect``,
``gate.encode``, ``gate.retrieval``, ``lightglue.match`` with
``superglue.sinkhorn`` inside it for SuperGlue, ``loftr.match``,
``orb.match``, ``epipolar.ransac``, ``gate.results``), the whole call
inside ``gate.process``, so that a profile attributes device time to
stages; each host wait on the exact path sits in a ``sync.<site>`` range
(:func:`mlis_tpu_torch.utils.profiling.sync_point`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mlis_tpu_torch.gating.gate import gate_mask
from mlis_tpu_torch.gating.place_recognition import SemanticPlaceRecognition
from mlis_tpu_torch.gating.verification import GeometricVerifier, MatchResult, pack_rows
from mlis_tpu_torch.models.superpoint import Keypoints
from mlis_tpu_torch.ops.image import to_grayscale
from mlis_tpu_torch.ops.knn import cosine_topk
from mlis_tpu_torch.utils.profiling import span, sync_point


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gate_compact(
    db: torch.Tensor,  # (n, D) descriptors
    times: torch.Tensor,  # (n,)
    floors: torch.Tensor,  # (n,) int
    *,
    k: int,
    threshold: float,
    min_time_gap: float,
    strict: bool,
    M: Optional[int] = None,
):
    """Retrieval -> unique-pair dedup -> floor gate -> survivor compaction.

    Each above-threshold candidate is packed as the int64 key lo * n + hi;
    sorting the keys and keeping first occurrences is ``np.unique`` over
    (lo, hi) rows, so survivors come out in ascending (lo, hi) order.

    Without ``M``: returns (qi (S,), mi (S,), (total_unique_pairs,
    rejected_by_floor)) with the counts as host ints (one sync).

    With a static slot count ``M`` (at most n * k): no sync. Survivors go
    to the first M slots by a stable argsort on the reject mask, slots past
    min(n_survivors, M) hold the pair (0, 0), and the counts stay on the
    device: returns (qi (M,), mi (M,), stats (3,) = [total, rejected,
    n_survivors])."""
    n = db.shape[0]
    scores, idx = cosine_topk(db, db, times, times, k=k, min_time_gap=min_time_gap)
    q = torch.arange(n, device=db.device)[:, None].expand(n, k)
    idx = idx.to(torch.int64)
    valid = torch.isfinite(scores) & (scores >= threshold)
    lo, hi = torch.minimum(q, idx), torch.maximum(q, idx)
    sentinel = n * n
    skeys = torch.sort(torch.where(valid, lo * n + hi, torch.full_like(lo, sentinel)).reshape(-1))[0]
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[1:] = skeys[1:] != skeys[:-1]
    uniq = first & (skeys < sentinel)
    lo_s = torch.div(skeys, n, rounding_mode="floor").clamp(max=n - 1)
    hi_s = skeys % n
    accept = uniq & gate_mask(floors, lo_s, hi_s, strict)
    total, rejected = uniq.sum(), (uniq & ~accept).sum()
    if M is None:
        # only the host reads sit in sync ranges: the kernels before and
        # after them stay in the caller's range, whose device annotation
        # then spans the compaction (``t[mask]`` is ``t[mask.nonzero()[:, 0]]``)
        counts = torch.stack([total, rejected])
        with sync_point("counts"):
            total, rejected = (int(v) for v in counts.tolist())
        with sync_point("survivors"):
            iq = accept.nonzero().select(1, 0)
        qi = lo_s[iq]
        with sync_point("survivors"):
            im = accept.nonzero().select(1, 0)
        return qi, hi_s[im], (total, rejected)
    if not 0 <= M <= skeys.numel():
        raise ValueError(f"slot count M={M} must lie in [0, n * k = {skeys.numel()}]")
    nsurv = accept.sum()
    # an integer key: CUDA sorts no bool tensor
    order = torch.argsort((~accept).to(torch.int32), stable=True)[:M]
    in_budget = torch.arange(M, device=db.device) < torch.clamp(nsurv, max=M)
    qi = torch.where(in_budget, lo_s[order], 0)
    mi = torch.where(in_budget, hi_s[order], 0)
    return qi, mi, torch.stack([total, rejected, nsurv])


def _slot_rows(qi: torch.Tensor, mi: torch.Tensor, out) -> torch.Tensor:
    """(B, 33) float32 rows: [qi, mi] then :func:`pack_rows`' 31 columns."""
    return torch.cat([torch.stack([qi, mi], 1).to(torch.float32), pack_rows(out)], 1)


def _stats_row(stats: torch.Tensor) -> torch.Tensor:
    """The (1, 33) row [total, rejected, n_survivors, 0, ...] under the slots."""
    return torch.cat([stats.to(torch.float32), stats.new_zeros(30, dtype=torch.float32)])[None]


@dataclass
class FullGateResult:
    total_pairs: int = 0
    cross_floor_rejected: int = 0
    verified: int = 0
    geometrically_valid: int = 0
    results: List[MatchResult] = field(default_factory=list)
    elapsed_s: float = 0.0
    vpr_s: float = 0.0
    retrieval_s: float = 0.0
    verify_s: float = 0.0

    @property
    def pairs_per_sec(self) -> float:
        return self.total_pairs / self.elapsed_s if self.elapsed_s > 0 else 0.0

    def summary(self) -> Dict:
        return {
            "total_pairs": self.total_pairs,
            "cross_floor_rejected": self.cross_floor_rejected,
            "rejection_rate": self.cross_floor_rejected / self.total_pairs
            if self.total_pairs
            else 0.0,
            "verified": self.verified,
            "geometrically_valid": self.geometrically_valid,
            "pairs_per_sec": self.pairs_per_sec,
            "stage_seconds": {
                "vpr": self.vpr_s,
                "retrieval": self.retrieval_s,
                "verification": self.verify_s,
            },
        }


class FullGatePipeline:
    """End-to-end keyframe gating with stage timing."""

    @classmethod
    def from_config(cls, cfg, device="cuda") -> "FullGatePipeline":
        """Build from a :class:`mlis_tpu_torch.config.PipelineConfig`."""
        from mlis_tpu_torch.models.superpoint import SuperPointConfig

        verifier = GeometricVerifier(
            matcher_type=cfg.verification.matcher,
            min_inliers=cfg.verification.min_inliers,
            min_inlier_ratio=cfg.verification.min_inlier_ratio,
            ransac_threshold=cfg.verification.ransac_threshold_px,
            sp_cfg=SuperPointConfig(max_keypoints=cfg.verification.max_keypoints),
            device=device,
        )
        return cls(
            vpr_method=cfg.vpr.method,
            verifier=verifier,
            top_k=cfg.vpr.top_k,
            similarity_threshold=cfg.vpr.similarity_threshold,
            min_time_gap=cfg.vpr.min_time_gap_s,
            strict_floor=cfg.gating.gate.strict_mode,
            device=device,
        )

    def __init__(
        self,
        vpr: Optional[SemanticPlaceRecognition] = None,
        verifier: Optional[GeometricVerifier] = None,
        vpr_method: str = "cricavpr",
        matcher_type: str = "lightglue",
        top_k: int = 10,
        similarity_threshold: float = 0.5,
        min_time_gap: float = 10.0,
        verify_batch: int = 64,
        strict_floor: bool = True,
        detect_scale: float = 1.0,
        match_top_k: Optional[int] = None,
        matcher_weights: Optional[str] = "auto",
        num_hypotheses: int = 512,
        ransac_subset: int = 0,
        device="cuda",
        **model_kwargs,
    ):
        """matcher_weights: "auto" loads the shipped LightGlue checkpoint
        when its shapes fit the matcher (a tiny test matcher keeps its own
        weights); a path must load; None loads nothing."""
        self.device = torch.device(device)
        self.detect_scale = detect_scale
        self.num_hypotheses = int(num_hypotheses)
        self.ransac_subset = int(ransac_subset)
        self.match_top_k = match_top_k
        self.spr = vpr or SemanticPlaceRecognition(
            vpr_method=vpr_method,
            similarity_threshold=similarity_threshold,
            min_time_gap=min_time_gap,
            device=device,
            **model_kwargs,
        )
        self.verifier = verifier or GeometricVerifier(matcher_type=matcher_type, device=device)
        self.matcher_weights_loaded = None
        if matcher_weights is not None:
            import os

            from mlis_tpu_torch.weights import default_matcher_checkpoint

            auto = matcher_weights == "auto"
            path = default_matcher_checkpoint() if auto else matcher_weights
            if path and os.path.exists(path) and hasattr(self.verifier.matcher, "load_weights"):
                try:
                    self.verifier.matcher.load_weights(path)
                    self.matcher_weights_loaded = path
                except (KeyError, ValueError, RuntimeError):
                    if not auto:
                        raise
        self.top_k = top_k
        self.similarity_threshold = similarity_threshold
        self.min_time_gap = min_time_gap
        self.verify_batch = verify_batch
        self.strict_floor = strict_floor
        self._fused_cache: Dict = {}

    def process(
        self,
        images,  # (N, H, W, 3) colour or (N, H, W) mono8 keyframes: array or tensor
        timestamps: np.ndarray,
        floor_labels: np.ndarray,
        K: np.ndarray,
        encode_batch_size: int = 64,
        verify: bool = True,
        upload_chunk: int = 32,
        survivor_budget: Optional[int] = None,
        monolithic: bool = False,
        ransac_uniforms: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> FullGateResult:
        """survivor_budget: with a fused matcher and an encoder with
        ``encode_batch_device``, retrieval, dedup, floor gate and
        compaction fill min(survivor_budget, n * k) static slots on the
        device, and verification ends in one packed fetch. monolithic (with
        a budget): the one-fetch path, which rounds the budget up by
        :meth:`_budget_slots`; ``upload_chunk`` is accepted for the JAX
        package's signature and changes nothing. An overflow reruns the
        exact path, so no result depends on the budget.

        ransac_uniforms: RANSAC's draws, one (num_hypotheses, 8) block per
        verified pair: (n_survivors, ...) in compaction order on the exact
        path, (M, ...) over the slots on a budget path (any other shape
        raises). Without them, and on an overflow's exact rerun, the draws
        come from ``generator`` on the device; an overflow rewinds
        ``generator`` to its state before the budget path drew, so the
        rerun draws as a plain exact call would.

        Stage seconds: on the budget paths the split is indicative only
        (work is queued, not finished, when a stage's clock stops; the
        one-fetch path leaves ``retrieval_s`` at 0 with the gate inside
        ``verify_s``), and ``elapsed_s`` is what compares across paths.

        ``images`` may be a tensor already on the device (as bench.py passes
        device arrays), which then is not copied."""
        with span("gate.process"):
            return self._process(images, timestamps, floor_labels, K, encode_batch_size,
                                 verify, upload_chunk, survivor_budget, monolithic,
                                 ransac_uniforms, generator)

    def _process(self, images, timestamps, floor_labels, K, encode_batch_size, verify,
                 upload_chunk, survivor_budget, monolithic, ransac_uniforms,
                 generator) -> FullGateResult:
        """:meth:`process` inside its ``gate.process`` range."""
        n = len(images)
        res = FullGateResult()
        dev = self.device
        t_start = time.perf_counter()
        fused_ok = verify and hasattr(self.verifier.matcher, "make_fused_match_verify")
        encode_dev = getattr(self.spr.vpr, "encode_batch_device", None)
        budget_ok = (survivor_budget is not None and fused_ok and encode_dev is not None
                     and n * n < 2**31)
        k = min(self.top_k, n)
        with sync_point("upload_floors"):
            floors = torch.as_tensor(np.asarray(floor_labels).astype(np.int64), device=dev)
        hw = (int(images.shape[1]), int(images.shape[2]))
        gen_state = generator.get_state() if budget_ok and generator is not None else None
        if not isinstance(images, torch.Tensor):
            images = np.ascontiguousarray(images)
        with sync_point("upload_images"):
            imgs = torch.as_tensor(images, device=dev)  # no copy when already there

        if budget_ok and monolithic:
            M = int(min(self._budget_slots(min(survivor_budget, n * k)), n * k))
            uniforms = self._slot_uniforms(ransac_uniforms, M)
            with sync_point("upload_times"):
                times = torch.as_tensor(np.asarray(timestamps, np.float32), device=dev)
            kp_all, db = self._detect_encode_once(imgs)
            res.vpr_s = time.perf_counter() - t_start
            t0 = time.perf_counter()
            out = self._verify_slots(kp_all, db, times, floors, K, hw, k, M, uniforms, generator)
            if out is not None:
                return self._finish(res, out, t0, t_start)
        else:
            # 1) keypoints once per keyframe + VPR descriptors, device-resident
            with span("gate.detect"):
                kp_all = self._detect_all(imgs) if fused_ok else None
            if encode_dev is not None:
                with span("gate.encode"):
                    db = torch.cat([
                        encode_dev(imgs[s : s + encode_batch_size])
                        for s in range(0, n, encode_batch_size)
                    ])
                with sync_point("upload_times"):
                    times = torch.as_tensor(np.asarray(timestamps, np.float32), device=dev)
            else:
                for s in range(0, n, encode_batch_size):
                    e = min(s + encode_batch_size, n)
                    self.spr.add_images_batch(images[s:e], timestamps[s:e], floor_labels[s:e])
                db = torch.as_tensor(self.spr.vpr.build_descriptor_matrix(), device=dev)
                times = torch.as_tensor(self.spr.vpr.timestamps().astype(np.float32), device=dev)
            if not budget_ok:
                with sync_point("detect_encode"):
                    _sync(dev)
            res.vpr_s = time.perf_counter() - t_start

            # 2-4 budgeted) static compaction, bucketed fused verify, one fetch
            if budget_ok:
                M = int(min(survivor_budget, n * k))
                uniforms = self._slot_uniforms(ransac_uniforms, M)
                t0 = time.perf_counter()
                with span("gate.retrieval"):
                    qi, mi, stats = _gate_compact(
                        db, times, floors, k=k, M=M, **self._gate_kw())
                res.retrieval_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                out = self._verify_compacted(kp_all, qi, mi, stats, K, hw, uniforms, generator)
                if out is not None:
                    return self._finish(res, out, t0, t_start)

        if budget_ok:  # overflow: the exact path on what is already on the device
            ransac_uniforms = None
            if gen_state is not None:
                generator.set_state(gen_state)

        # 2-3) retrieval, dedup, floor gate, compaction
        t0 = time.perf_counter()
        with span("gate.retrieval"):
            qi, mi, (total, rejected) = _gate_compact(db, times, floors, k=k, **self._gate_kw())
        res.total_pairs, res.cross_floor_rejected = total, rejected
        res.retrieval_s = time.perf_counter() - t0
        if total == 0:
            res.elapsed_s = time.perf_counter() - t_start
            return res

        # 4) match + RANSAC + pose over the survivors: fused over the
        # detected keypoints, or pair batches of grayscale images
        if verify and qi.numel():
            t0 = time.perf_counter()
            if fused_ok:
                res.results = self._verify_survivors(kp_all, qi, mi, K, hw, ransac_uniforms,
                                                     generator)
            else:
                res.results = self._verify_gray_pairs(imgs, qi, mi, K, ransac_uniforms, generator)
            res.verify_s = time.perf_counter() - t0
            res.verified = len(res.results)
            res.geometrically_valid = sum(1 for r in res.results if r.is_valid)
        res.elapsed_s = time.perf_counter() - t_start
        return res

    def _gate_kw(self) -> Dict:
        return dict(threshold=float(self.similarity_threshold),
                    min_time_gap=float(self.min_time_gap), strict=bool(self.strict_floor))

    @staticmethod
    def _finish(res: FullGateResult, out, t0: float, t_start: float) -> FullGateResult:
        res.results, res.total_pairs, res.cross_floor_rejected, _nsurv = out
        res.verified = len(res.results)
        res.geometrically_valid = sum(1 for r in res.results if r.is_valid)
        res.verify_s = time.perf_counter() - t0
        res.elapsed_s = time.perf_counter() - t_start
        return res

    def _slot_uniforms(self, uniforms: Optional[torch.Tensor], M: int) -> Optional[torch.Tensor]:
        """A budget path's draws: one block per slot, on the device."""
        if uniforms is None:
            return None
        if tuple(uniforms.shape) != (M, self.num_hypotheses, 8):
            raise ValueError(
                f"ransac_uniforms must be {(M, self.num_hypotheses, 8)} on a budget path "
                f"({M} slots), got {tuple(uniforms.shape)}")
        return uniforms.to(self.device)

    def _detect_all(self, images: torch.Tensor, detect_batch: int = 128) -> Keypoints:
        """Keypoints for every keyframe, coordinates in input pixels."""
        H, W = int(images.shape[1]), int(images.shape[2])
        scale = self.detect_scale
        h8 = (int(H * scale) // 8) * 8
        w8 = (int(W * scale) // 8) * 8
        gray = to_grayscale(images, size=(h8, w8))
        with sync_point("upload_scale"):
            sxy = torch.tensor([W / w8, H / h8], dtype=torch.float32, device=images.device)
        sp = self.verifier.matcher.sp
        top_m = self.match_top_k
        kps = []
        for s in range(0, images.shape[0], detect_batch):
            kp = sp.detect(gray[s : s + detect_batch])
            kp = kp._replace(coords=kp.coords * sxy)
            if top_m and top_m < kp.coords.shape[1]:
                kp = kp.map(lambda x: x[:, :top_m])
            kps.append(kp)
        return Keypoints(*(torch.cat(parts) for parts in zip(*kps)))

    def _detect_encode_once(self, imgs: torch.Tensor) -> Tuple[Keypoints, torch.Tensor]:
        """Keypoints and descriptors of every frame, one call each (the
        one-fetch path ignores ``encode_batch_size``, as the JAX package's
        single program does)."""
        n = int(imgs.shape[0])
        with span("gate.detect"):
            kp_all = self._detect_all(imgs, detect_batch=max(n, 1))
        with span("gate.encode"):
            db = self.spr.vpr.encode_batch_device(imgs)
        return kp_all, db

    def _verify_gray_pairs(self, imgs, qi, mi, K, uniforms, generator) -> List[MatchResult]:
        """Survivors as grayscale pairs through ``verify_pairs_batch`` in
        chunks of ``verify_batch`` (LoFTR, ORB)."""
        S = qi.numel()
        if uniforms is not None and tuple(uniforms.shape) != (S, self.num_hypotheses, 8):
            raise ValueError(
                f"ransac_uniforms must be {(S, self.num_hypotheses, 8)}, got {tuple(uniforms.shape)}"
            )
        gray = to_grayscale(imgs)
        with sync_point("fetch_pairs"):
            pairs = torch.stack([qi, mi], 1).cpu().numpy()
        return self.verifier.verify_pairs_batch(
            gray[qi], gray[mi], K, indices=[(int(a), int(b)) for a, b in pairs],
            batch_size=self.verify_batch, uniforms=uniforms, generator=generator)

    def _get_fused(self, hw, K):
        key = (hw, float(np.asarray(K)[0, 0]), self.num_hypotheses, self.ransac_subset)
        if key not in self._fused_cache:
            self._fused_cache[key] = self.verifier.matcher.make_fused_match_verify(
                hw, K, self.verifier.ransac_threshold,
                num_hypotheses=self.num_hypotheses, ransac_subset=self.ransac_subset,
            )
        return self._fused_cache[key]

    def _verify_survivors(self, kp_all, qi, mi, K, hw, uniforms, generator) -> List[MatchResult]:
        """The exact path's verify: fused over the survivors in chunks of
        ``verify_batch``, one packed fetch."""
        fused = self._get_fused(hw, K)
        S, B = qi.numel(), self.verify_batch
        if uniforms is not None and tuple(uniforms.shape) != (S, self.num_hypotheses, 8):
            raise ValueError(
                f"ransac_uniforms must be {(S, self.num_hypotheses, 8)}, got {tuple(uniforms.shape)}"
            )
        rows = []
        for s in range(0, S, B):
            u = uniforms[s : s + B].to(self.device) if uniforms is not None else None
            rows.append(pack_rows(fused(kp_all, qi[s : s + B], mi[s : s + B],
                                        uniforms=u, generator=generator)))
        with sync_point("fetch_rows"):
            flat = torch.cat(rows).cpu().numpy()  # one fetch
        with sync_point("fetch_pairs"):
            pairs = torch.stack([qi, mi], 1).cpu().numpy()
        with span("gate.results"):
            return self.verifier.results_from_rows(pairs, flat)

    def _verify_compacted(self, kp_all, qi_all, mi_all, stats, K, hw, uniforms, generator):
        """The budgeted path's verify: the fused matcher over the M slots in
        :meth:`_bucket_sizes` buckets (the last may hold fewer than its
        size), every bucket's rows and the stats row in one packed fetch.
        None on an overflow."""
        fused = self._get_fused(hw, K)
        M = int(qi_all.numel())
        rows, s = [], 0
        for size in self._bucket_sizes(M, self.verify_batch):
            qi, mi = qi_all[s : s + size], mi_all[s : s + size]
            u = uniforms[s : s + size] if uniforms is not None else None
            rows.append(_slot_rows(qi, mi, fused(kp_all, qi, mi, uniforms=u, generator=generator)))
            s += size
        return self._parse_packed(self._fetch(torch.cat(rows + [_stats_row(stats)])), M)

    def _verify_slots(self, kp_all, db, times, floors, K, hw, k, M, uniforms, generator):
        """The one-fetch path's tail: the static gate, one fused call over
        all M slots, one packed fetch. None on an overflow."""
        with span("gate.retrieval"):
            qi, mi, stats = _gate_compact(db, times, floors, k=k, M=M, **self._gate_kw())
        out = self._get_fused(hw, K)(kp_all, qi, mi, uniforms=uniforms, generator=generator)
        return self._parse_packed(self._fetch(torch.cat([_slot_rows(qi, mi, out),
                                                         _stats_row(stats)])), M)

    @staticmethod
    def _fetch(packed: torch.Tensor) -> np.ndarray:
        """The budget paths' one packed fetch of the (M + 1, 33) rows."""
        with sync_point("fetch_rows"):
            return packed.cpu().numpy()

    def _parse_packed(self, flat: np.ndarray, M: int):
        """Decode fetched (M + 1, 33) slot rows and stats row into (results,
        total, rejected, n_survivors); None when the survivors overflow the
        M slots. Slots past the survivors (the padding pair (0, 0)) are
        dropped; a pair with fewer than 5 matches is invalid."""
        total, rejected, nsurv = (int(v) for v in flat[-1, :3])
        if nsurv > M:
            return None
        with span("gate.results"):
            results = self.verifier.results_from_rows(flat[:nsurv, :2], flat[:nsurv, 2:])
        return results, total, rejected, nsurv

    @staticmethod
    def _budget_slots(s) -> int:
        """Round a survivor budget up to quarter-octave granularity
        ({5, 6, 7, 8} * 2^k, at least 16): padding slots are matcher work,
        and four sizes an octave bound the distinct shapes."""
        s = max(int(s), 1)
        if s <= 16:
            return 16
        p = 1 << (s - 1).bit_length()  # next power of two >= s, so s in (p/2, p]
        q = p // 8
        return -(-s // q) * q  # ceil to a multiple of p/8: {5,6,7,8}*p/8

    @staticmethod
    def _bucket_sizes(n_pairs: int, B: int) -> List[int]:
        """Greedy power-of-two buckets of at least min(64, B): 411 pairs
        run as 256 + 128 + 64 = 448 slots rather than 2 x 256."""
        sizes: List[int] = []
        floor = min(64, B)
        rem = n_pairs
        while rem > 0:
            if rem >= B:
                take = B
            else:
                take = floor
                while take * 2 <= rem:
                    take *= 2
            sizes.append(take)
            rem -= min(take, rem)
        return sizes
