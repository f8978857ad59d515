"""LightGlue matcher: fixed-depth batched transformer over SuperPoint keypoints.

Counterpart of ``mlis_tpu/models/lightglue.py``, both heads:

* keypoints are normalised by half the larger image side; a learnable
  Fourier rotary encoding rotates interleaved (even, odd) feature pairs of
  q and k in self-attention only;
* each of ``depth`` blocks runs self-attention then cross-attention, both
  images on one (2B, K, D) batch; the cross source is the batch rolled by B;
* padding is a suffix (keypoints are score-sorted), so attention masks keys
  at positions >= kv_len;
* LightGlue's head is dual softmax times sigmoid matchability; matches are
  mutual argmax above the threshold (0.1);
* SuperGlue's head (``assignment="sinkhorn"``) is 20 log-space Sinkhorn
  iterations with a learnable dustbin (``ops/sinkhorn.sinkhorn_with_dustbin``)
  on the similarities, those of a masked keypoint set to -1e9 so that they
  stay finite in the log-sum-exp; the marginals count every padded slot, as
  in the JAX package; matches are mutual argmax above 0.2.

Attention (:func:`masked_attention`) follows its input. On a CUDA device,
with bf16 or f16 operands, nothing for autograd to differentiate and a
head width the kernel is built for (:func:`flash_kernel_route`), it runs
the hand-written flash kernel at every size, on the q, k, v views in place,
with the key lengths repeated over the heads: Q K^T on the compute-dtype
operands with float32 sums, float32 logits and softmax, P cast to V's
dtype before P V with a float32 accumulator. Anywhere else it keeps the
JAX package's dispatch: up to Kx*Ks = 1024^2 (``FLASH_MIN_PRODUCT``)
plain tensor code, as XLA's dense attention there (logits in float32 from
the compute-dtype operands, masked with a large negative number, softmax
in float32, probabilities cast back and multiplied by V); above it
:func:`mlis_tpu_torch.ops.flash_attention.flash_mha` (the flash kernel's
plain version on the CPU). A row with no valid key takes the answer of
its size in the JAX package: up to 1024^2 the mean of V over every key
(the dense softmax of equal logits; the kernel is told so), above it
zeros, as the JAX package's flash kernel gives.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from mlis_tpu_torch.gating.verification import BaseFeatureMatcher
from mlis_tpu_torch.models.layers import Dense, LayerNorm, flax_init_
from mlis_tpu_torch.models.superpoint import Keypoints, SuperPoint, SuperPointConfig
from mlis_tpu_torch.ops.flash_attention import HEAD_DIMS, MAX_BH, _launch_flash, flash_mha
from mlis_tpu_torch.ops.image import to_grayscale
from mlis_tpu_torch.ops.sinkhorn import sinkhorn_with_dustbin
from mlis_tpu_torch.utils.profiling import span, sync_point
from mlis_tpu_torch.weights import load_npz, matcher_arch_from_npz

FLASH_MIN_PRODUCT = 1024 * 1024  # Kx * Ks above which the reference uses flash attention
_LARGE_NEGATIVE = -0.7 * float(torch.finfo(torch.float32).max)


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    descriptor_dim: int = 256
    dim: int = 256
    num_heads: int = 4
    depth: int = 9
    match_threshold: float = 0.1
    assignment: str = "dual_softmax"  # 'dual_softmax' (LightGlue) | 'sinkhorn' (SuperGlue)
    sinkhorn_iterations: int = 20
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def lightglue(**kw) -> "MatcherConfig":
        return MatcherConfig(**kw)

    @staticmethod
    def superglue(**kw) -> "MatcherConfig":
        kw.setdefault("assignment", "sinkhorn")
        kw.setdefault("match_threshold", 0.2)
        return MatcherConfig(**kw)

    @staticmethod
    def tiny_test(**kw) -> "MatcherConfig":
        kw.setdefault("descriptor_dim", 32)
        kw.setdefault("dim", 32)
        kw.setdefault("num_heads", 2)
        kw.setdefault("depth", 2)
        return MatcherConfig(**kw)


class Matches(NamedTuple):
    idx0: torch.Tensor  # (B, K0) int32, best match in image 1, -1 invalid
    scores: torch.Tensor  # (B, K0) matched confidence
    valid: torch.Tensor  # (B, K0) bool, mutual + threshold + mask


def normalize_keypoints(coords: torch.Tensor, image_hw) -> torch.Tensor:
    h, w = image_hw
    with sync_point("image_size"):
        size = torch.tensor([w, h], dtype=torch.float32, device=coords.device)
    return (coords - size / 2.0) / (size.max() / 2.0)


class RotaryEncoding(nn.Module):
    """Bias-free (2 -> Dh/2) projection of normalised coords to angles."""

    def __init__(self, head_dim: int):
        super().__init__()
        self.Wr = nn.Parameter(torch.zeros(2, head_dim // 2))

    def forward(self, coords_norm: torch.Tensor):
        ang = coords_norm.to(torch.float32) @ self.Wr
        return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved feature pairs: x (B, K, H, Dh), cos/sin (B, K, Dh/2)."""
    B, K, H, Dh = x.shape
    x2 = x.reshape(B, K, H, Dh // 2, 2)
    a, b = x2[..., 0], x2[..., 1]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.stack([a * c - b * s, a * s + b * c], dim=-1).reshape(B, K, H, Dh)


def flash_kernel_route(q, k, v) -> bool:
    """Whether :func:`masked_attention` runs on the flash kernel: q on a
    CUDA device, q, k, v all bf16 or all f16, nothing that autograd would
    differentiate (the kernel is forward-only), a head width and a batch of
    heads the kernel is built for, and at least one key. Reads only the
    tensors' device, dtype, shape and ``requires_grad``."""
    B, _, H, Dh = q.shape
    return (q.device.type == "cuda"
            and q.dtype in (torch.bfloat16, torch.float16) and k.dtype == v.dtype == q.dtype
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)))
            and Dh in HEAD_DIMS and B * H <= MAX_BH and k.shape[1] > 0)


def dense_masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """The plain route of :func:`masked_attention` up to Kx*Ks = 1024^2, as
    XLA's dense attention computes it: float32 logits from the operands,
    keys >= kv_len at a large negative number (so a row with no valid key
    averages V), float32 softmax, probabilities cast to v's dtype before
    the product with v."""
    keep = torch.arange(k.shape[1], device=k.device)[None, :] < kv_len[:, None]  # (B, S)
    logits = torch.einsum("btnh,bsnh->bnts", q.to(torch.float32), k.to(torch.float32))
    logits = logits * torch.tensor(1.0 / np.sqrt(q.shape[-1]), dtype=torch.float32)
    logits = logits.masked_fill(~keep[:, None, None, :], _LARGE_NEGATIVE)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bnts,bsnh->btnh", probs, v)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh), keys >= kv_len masked) v.

    q (B, T, N, Dh), k/v (B, S, N, Dh), kv_len (B,) -> (B, T, N, Dh) in v's
    dtype, logits and softmax in float32. The flash kernel where
    :func:`flash_kernel_route` allows it, told to average V in a row with
    kv_len = 0 up to Kx*Ks = 1024^2 (zeros above); elsewhere
    :func:`dense_masked_attention` up to 1024^2 and :func:`flash_mha` above
    (bf16 p v operands, as in the JAX package)."""
    with span("lightglue.attention"):
        dense_size = q.shape[1] * k.shape[1] <= FLASH_MIN_PRODUCT
        if flash_kernel_route(q, k, v):
            lens = kv_len[:, None].expand(-1, q.shape[2]).to(device=q.device, dtype=torch.int32)
            return _launch_flash(q, k, v, lens.reshape(-1), mean_empty=dense_size)
        if dense_size:
            return dense_masked_attention(q, k, v, kv_len)
        keep = torch.arange(k.shape[1], device=k.device)[None, :] < kv_len[:, None]
        return flash_mha(q, k, v, kv_valid=keep).to(v.dtype)


class AttnLayer(nn.Module):
    """Residual MHA(x <- source) + MLP on concat(x, message), LayerNorm inside."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.q = Dense(dim, dim, dtype=dtype)
        self.k = Dense(dim, dim, dtype=dtype)
        self.v = Dense(dim, dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.ffn1 = Dense(2 * dim, 2 * dim, dtype=dtype)
        self.ffn_norm = LayerNorm(2 * dim)
        self.ffn2 = Dense(2 * dim, dim, dtype=dtype)

    def forward(self, x, source, source_valid, rot_x=None, rot_src=None):
        B, Kx, D = x.shape
        Ks, H = source.shape[1], self.num_heads
        q = self.q(x).reshape(B, Kx, H, D // H)
        k = self.k(source).reshape(B, Ks, H, D // H)
        v = self.v(source).reshape(B, Ks, H, D // H)
        if rot_x is not None:
            q = apply_rotary(q, *rot_x)
        if rot_src is not None:
            k = apply_rotary(k, *rot_src)
        kv_len = source_valid.sum(-1)
        msg = masked_attention(q, k, v, kv_len).reshape(B, Kx, D).to(self.dtype)
        msg = self.proj(msg)
        h = self.ffn1(torch.cat([x, msg], dim=-1))
        h = F.gelu(self.ffn_norm(h).to(self.dtype), approximate="tanh")
        return x + self.ffn2(h)


class MatcherNet(nn.Module):
    def __init__(self, cfg: MatcherConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.in_proj = Dense(cfg.descriptor_dim, cfg.dim, dtype=dt)
        self.posenc = RotaryEncoding(cfg.dim // cfg.num_heads)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({
                "self": AttnLayer(cfg.dim, cfg.num_heads, dt),
                "cross": AttnLayer(cfg.dim, cfg.num_heads, dt),
            })
            for _ in range(cfg.depth)
        )
        self.final_proj = Dense(cfg.dim, cfg.dim, dtype=dt)
        if cfg.assignment == "sinkhorn":
            self.dustbin = nn.Parameter(torch.ones(()))
        else:
            self.matchability = Dense(cfg.dim, 1, dtype=torch.float32)

    def forward(self, d0, c0, m0, d1, c1, m1, image_hw, return_matchability: bool = False):
        """d: (B, K, Dd) descriptors, c: (B, K, 2) coords, m: (B, K) masks ->
        scores (B, K0, K1). ``return_matchability`` adds each keypoint's
        matchable probability, (mp0 (B, K0), mp1 (B, K1)): the sigmoid
        matchability for dual softmax, 1 - the dustbin mass for Sinkhorn
        (the training loss supervises unmatchable points with them)."""
        B, K0, K1 = d0.shape[0], d0.shape[1], d1.shape[1]
        if K0 != K1:  # pad the smaller stream with masked slots
            K = max(K0, K1)

            def pad(a, k):
                return torch.cat([a, a.new_zeros((a.shape[0], K - k, *a.shape[2:]))], 1)

            d0, c0, m0 = pad(d0, K0), pad(c0, K0), pad(m0, K0)
            d1, c1, m1 = pad(d1, K1), pad(c1, K1), pad(m1, K1)
        xc = self.in_proj(torch.cat([d0, d1]).to(self.cfg.dtype))
        rot = self.posenc(normalize_keypoints(torch.cat([c0, c1]), image_hw))
        mc = torch.cat([m0, m1])
        ms = torch.roll(mc, B, dims=0)
        for blk in self.blocks:
            xc = blk["self"](xc, xc, mc, rot_x=rot, rot_src=rot)
            xc = blk["cross"](xc, torch.roll(xc, B, dims=0), ms)
        with span("lightglue.assign"):
            fc = self.final_proj(xc)
            f0, f1 = fc[:B], fc[B:]
            sim = torch.einsum("bkd,bld->bkl", f0.to(torch.float32), f1.to(torch.float32))
            sim = sim / (self.cfg.dim**0.5)
            mask2d = m0[:, :, None] & m1[:, None, :]
            if self.cfg.assignment == "sinkhorn":
                with record_function("superglue.sinkhorn"):
                    # in place (B x K x K float32): the division saved nothing
                    # that autograd needs, so the backward pass is unaffected
                    sim = sim.masked_fill_(~mask2d, -1e9)
                    log_p = sinkhorn_with_dustbin(sim, self.dustbin, self.cfg.sinkhorn_iterations)
                    del sim
                    scores = torch.exp(log_p[:, :-1, :-1])[:, :K0, :K1]
                    if return_matchability:
                        return (scores, 1.0 - torch.exp(log_p[:, :-1, -1])[:, :K0],
                                1.0 - torch.exp(log_p[:, -1, :-1])[:, :K1])
                    return scores
            z0 = self.matchability(f0)[..., 0]
            z1 = self.matchability(f1)[..., 0]
            sim_m = torch.where(mask2d, sim, torch.full_like(sim, -1e30))
            p = torch.softmax(sim_m, dim=2) * torch.softmax(sim_m, dim=1)
            scores = p * torch.sigmoid(z0)[:, :, None] * torch.sigmoid(z1)[:, None, :]
            if return_matchability:
                return scores[:, :K0, :K1], torch.sigmoid(z0)[:, :K0], torch.sigmoid(z1)[:, :K1]
            return scores[:, :K0, :K1]


def extract_matches(scores, m0, m1, threshold: float) -> Matches:
    """Mutual argmax + threshold, static shapes (argmax takes the first max)."""
    mask2d = m0[:, :, None] & m1[:, None, :]
    s = torch.where(mask2d, scores, torch.full_like(scores, -1.0))
    best1 = s.argmax(dim=2)  # (B, K0)
    best0 = s.argmax(dim=1)  # (B, K1)
    k0 = torch.arange(s.shape[1], device=s.device)
    mutual = best0.gather(1, best1) == k0[None, :]
    sc = s.gather(2, best1[..., None])[..., 0]
    valid = mutual & (sc > threshold) & m0
    return Matches(
        torch.where(valid, best1, torch.full_like(best1, -1)).to(torch.int32),
        torch.where(valid, sc, torch.zeros_like(sc)),
        valid,
    )


class LightGlue(BaseFeatureMatcher):
    """SuperPoint + fixed-depth LightGlue, batched over pairs."""

    matcher_cfg_factory = staticmethod(MatcherConfig.lightglue)
    # match confidences are probabilities: the scale of the confident cut
    confidence_is_calibrated = True

    def __init__(
        self,
        sp_cfg: Optional[SuperPointConfig] = None,
        matcher_cfg: Optional[MatcherConfig] = None,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.sp = SuperPoint(sp_cfg or SuperPointConfig(), device=self.device)
        self.cfg = matcher_cfg or type(self).matcher_cfg_factory(
            descriptor_dim=self.sp.cfg.descriptor_dim)
        self.net = MatcherNet(self.cfg).to(self.device).eval()

    @classmethod
    def from_checkpoint(cls, path: str, sp_cfg: Optional[SuperPointConfig] = None,
                        dtype: torch.dtype = torch.bfloat16, device="cuda") -> "LightGlue":
        """Matcher whose structure is read from the checkpoint, weights loaded."""
        cfg = cls.matcher_cfg_factory(dtype=dtype, **matcher_arch_from_npz(path))
        m = cls(sp_cfg=sp_cfg, matcher_cfg=cfg, device=device)
        m.load_weights(path)
        return m

    def load_weights(self, path: str, image_hw=None) -> None:
        """Load a checkpoint holding the matcher and, where present, its
        SuperPoint front end (``image_hw`` is the JAX package's init shape,
        which torch modules do not need)."""
        groups = load_npz(path)
        if "superpoint" in groups:
            self.sp.load_state(groups["superpoint"])
        self.net.load_state_dict(groups["matcher"], strict=True)
        self.net.to(self.device)

    def load_torch_state_dict(self, matcher_sd=None, superpoint_sd=None,
                              image_hw=(540, 720)) -> None:
        """Load official checkpoints: a cvg/LightGlue matcher state dict
        (``transformers.{i}.self_attn.Wqkv`` split into q / k / v, the cross
        block's shared ``to_qk`` into both q and k, the last layer's
        assignment head) and / or a magicleap SuperPoint one (``conv1a`` ...
        ``convDb``), torch tensors or numpy arrays. ``image_hw`` is the JAX
        package's init shape, which torch modules do not need."""
        from mlis_tpu_torch.models.convert import (
            convert_lightglue_torch,
            convert_superpoint_torch,
        )
        from mlis_tpu_torch.weights import from_jax_params, to_jax_params

        if superpoint_sd is not None:
            tree = convert_superpoint_torch(superpoint_sd, to_jax_params(self.sp.net.state_dict()))
            self.sp.load_state(from_jax_params(tree))
        if matcher_sd is not None:
            template = to_jax_params(self.net.state_dict(), scan_prefixes=("blocks",))
            tree = convert_lightglue_torch(matcher_sd, template)
            self.net.load_state_dict(from_jax_params(tree), strict=True)
            self.net.to(self.device)

    def save_weights(self, path: str) -> None:
        """Write the matcher and its SuperPoint front end into one npz as the
        JAX package's ``save_weights`` does: the ``matcher:`` tree (``blocks``
        restacked along the depth axis) and the ``superpoint:`` tree, flax
        layout, float16."""
        from mlis_tpu_torch.weights import save_params_npz, to_jax_params

        save_params_npz(path,
                        matcher=to_jax_params(self.net.state_dict(), scan_prefixes=("blocks",)),
                        superpoint=to_jax_params(self.sp.net.state_dict()))

    @torch.no_grad()
    def init_random_(self, seed: int = 0) -> "LightGlue":
        """SuperPoint and the matcher drawn with flax's initialisers from
        ``torch.Generator().manual_seed(seed)`` (the global RNG is left
        alone): lecun-normal kernels, zero biases, LayerNorm ones and
        zeros, the rotary projection from N(0, 1), the dustbin at 1."""
        gen = torch.Generator().manual_seed(int(seed))
        for net in (self.sp.net, self.net):
            net.cpu()
            flax_init_(net, gen)
        self.net.posenc.Wr.normal_(0.0, 1.0, generator=gen)
        if self.cfg.assignment == "sinkhorn":
            self.net.dustbin.fill_(1.0)
        self.sp.net.to(self.device)
        self.net.to(self.device)
        return self

    @torch.no_grad()
    def match_keypoints(self, kp0: Keypoints, kp1: Keypoints, image_hw) -> Matches:
        scores = self.net(kp0.descriptors, kp0.coords, kp0.mask,
                          kp1.descriptors, kp1.coords, kp1.mask, tuple(image_hw))
        return extract_matches(scores, kp0.mask, kp1.mask, self.cfg.match_threshold)

    @torch.no_grad()
    def match_batch(self, images0: torch.Tensor, images1: torch.Tensor):
        """(B, H, W, 1) grayscale pairs -> (kp0, kp1, matches), on the device."""
        kp0 = self.sp.detect(torch.as_tensor(images0, device=self.device))
        kp1 = self.sp.detect(torch.as_tensor(images1, device=self.device))
        hw = (int(images0.shape[1]), int(images0.shape[2]))
        return kp0, kp1, self.match_keypoints(kp0, kp1, hw)

    @torch.no_grad()
    def detect_and_match(self, image1, image2):
        """One pair of uint8 images -> (matched kpts1 (M, 2), kpts2 (M, 2),
        confidences (M,)), tensors on the device. ``last_detector_counts``
        holds the detector's totals."""
        g1 = to_grayscale(torch.as_tensor(image1, device=self.device)[None])
        g2 = to_grayscale(torch.as_tensor(image2, device=self.device)[None])
        kp0, kp1, matches = self.match_batch(g1, g2)
        valid = matches.valid[0]
        idx = matches.idx0[0][valid].long()
        self.last_detector_counts = tuple(
            int(n) for n in torch.stack([kp0.mask[0].sum(), kp1.mask[0].sum()]).tolist())
        return kp0.coords[0][valid], kp1.coords[0][idx], matches.scores[0][valid]

    def make_fused_match_verify(
        self,
        image_hw: Tuple[int, int],
        K: np.ndarray,
        ransac_threshold: float = 3.0,
        num_hypotheses: int = 512,
        confident_threshold: float = 0.5,
        ransac_subset: int = 0,
    ):
        """Matcher + RANSAC + pose over pre-detected keypoints.

        Returns ``run(kp_all, qi, mi, uniforms=None, generator=None)`` giving
        (n_kp0, n_kp1, n_match, n_inliers, inlier_ratio, E, T, n_confident)
        per pair; the last is the count of matches with score >=
        ``confident_threshold``. ``uniforms`` (P, H, 8) feeds RANSAC's
        hypothesis draws; without it they come from ``generator``."""
        from mlis_tpu_torch.ops.epipolar import essential_ransac_batch

        image_hw = (int(image_hw[0]), int(image_hw[1]))
        with sync_point("upload_intrinsics"):
            K_t = torch.as_tensor(np.asarray(K, np.float32), device=self.device)

        @torch.no_grad()
        def run(kp_all: Keypoints, qi, mi, uniforms=None, generator=None):
            with span("lightglue.match"):
                kp0 = kp_all.map(lambda x: x[qi])
                kp1 = kp_all.map(lambda x: x[mi])
                matches = self.match_keypoints(kp0, kp1, image_hw)
                idx = matches.idx0.clamp(0, kp1.coords.shape[1] - 1).long()
                mk1 = kp1.coords.gather(1, idx[..., None].expand(-1, -1, 2))
            with span("epipolar.ransac"):
                res, T, _good = essential_ransac_batch(
                    kp0.coords, mk1, matches.valid, K_t, num_hypotheses,
                    ransac_threshold, ransac_subset, uniforms=uniforms, generator=generator,
                )
            return (
                kp0.mask.sum(1),
                kp1.mask.sum(1),
                matches.valid.sum(1),
                res.num_inliers,
                res.inlier_ratio,
                res.E,
                T,
                (matches.valid & (matches.scores >= confident_threshold)).sum(1),
            )

        return run


class SuperGlue(LightGlue):
    """The Sinkhorn-assignment variant: 20 iterations, match threshold 0.2,
    the LightGlue skeleton otherwise."""

    matcher_cfg_factory = staticmethod(MatcherConfig.superglue)
