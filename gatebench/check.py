"""What decides ``correct``: the timed calls' outputs against the reference.

Every completed call is held to the gate's structure exactly: one result
per survivor, survivors unique, ascending and on one floor, the counts
consistent. A sample of calls drawn from the seed, with the one that
verified the most pairs, is judged stage by stage against
``gatebench/reference`` in float32 with TF32 off:

* ``detector``: per frame, the Jaccard distance between the program's and
  the reference's valid keypoint sets (positions on the detect grid); the
  worst frame;
* ``detector_desc``: per frame, the mean 1 - cos of the descriptors at the
  keypoints both found; the worst frame;
* ``encoder``: 1 - cos of each frame's global descriptor; the worst frame;
* ``retrieval``: survivors and counts from the program's own descriptors
  through the reference retrieval and floor gate, exact (symmetric
  difference of survivors plus the count differences);
* ``matcher``: LightGlue's matches on the program's own keypoints: over
  the verified pairs, sum |A xor B| / sum |A or B| of the program's and
  the reference's (i, j) match sets;
* ``ransac``: inlier counts of the reference RANSAC on the program's own
  matches with the call's own draws, sum |prog - ref| / sum ref;
* ``decisions``: pairs whose accept/reject differs from the reference's
  on those inliers, while neither side's inlier count lies within 3 of
  its cut (20) nor its inlier ratio within 0.02 of its cut (0.25).

The matcher follows the program from its own keypoints, RANSAC from its
own matches and retrieval from its own descriptors; the stages that this
skips are judged by themselves: the detector and the encoder from the
images, the matcher against the reference matcher.

:func:`control_outputs` puts the reference in the program's place one
precision below the configuration's: the networks (bf16 in the gate) at
float8 e4m3 with one scale a tensor, RANSAC (float32 with TF32 off) with
TF32 products. That is the control that has to fail.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gatebench.reference import lightglue as ref_lg
from gatebench.reference import ransac as ref_ransac
from gatebench.reference import retrieval as ref_retrieval
from gatebench.reference import superpoint as ref_sp
from gatebench.reference.nets import F32, FP8

INLIER_BAND = 3
RATIO_BAND = 0.02
MIN_MATCHES = 5  # fewer matches: the gate reports the pair invalid with zero counts
NUMBERS = ("structure", "retrieval", "detector", "detector_desc", "encoder", "matcher",
           "ransac", "decisions")


@dataclass
class Row:
    """One verified pair as the gate reported it."""
    q: int
    m: int
    n_match: int
    n_inl: int
    ratio: float
    valid: bool


@dataclass
class CallOutput:
    """What one call produced: its counts and pair rows, and the keypoints
    (coords, descriptors, mask) and descriptors its stages made."""
    total: int
    rejected: int
    rows: List[Row]
    kp: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    db: torch.Tensor
    matches: Tuple[torch.Tensor, torch.Tensor]  # (idx0, valid) of every verified pair


def structure_faults(total: int, rejected: int, rows: Sequence[Row], floors) -> int:
    """Violations of the gate's structure in one call's result."""
    bad = 0
    if len(rows) != total - rejected or rejected < 0 or rejected > total:
        bad += 1
    keys = [(r.q, r.m) for r in rows]
    bad += sum(1 for a, b in zip(keys, keys[1:]) if not a < b)
    for r in rows:
        bad += not (0 <= r.q < r.m < len(floors)) or floors[r.q] != floors[r.m]
        bad += r.n_match < 0 or r.n_inl > r.n_match or (r.valid and r.n_match < MIN_MATCHES)
    return bad


class tf32:
    """TF32 matrix products inside the block when ``on`` (the control's
    RANSAC), float32 otherwise; the previous settings restored after."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def _chunks(n: int, size: int):
    for s in range(0, n, size):
        yield slice(s, min(s + size, n))


class Reference:
    """The reference gate of one configuration, weights on ``device``."""

    def __init__(self, cfg: dict, weights: dict, encoder, device):
        self.cfg, self.w, self.encoder, self.device = cfg, weights, encoder, device
        det = cfg["detector"]
        self.max_kp = int(det["max_keypoints"])
        self.keep = int(det["match_top_k"] or self.max_kp)
        self.hw = tuple(cfg["keyframe_hw"])
        g = cfg["gate"]
        self.gate_kw = dict(k=int(g["top_k"]), threshold=float(g["similarity_threshold"]),
                            min_time_gap=float(g["min_time_gap"]), strict=bool(g["strict_floor"]))
        self.heads = int(cfg["matcher"]["heads"])
        self.threshold = float(cfg["matcher"]["match_threshold"])
        self.frame_chunk = int(cfg["reference_chunks"]["frames"])
        self.pair_chunk = int(cfg["reference_chunks"]["pairs"])

    # -- stages ---------------------------------------------------------------------
    def detect(self, images: np.ndarray, prec: str) -> ref_sp.Keypoints:
        parts = []
        for sl in _chunks(len(images), self.frame_chunk):
            x = torch.as_tensor(images[sl], device=self.device)
            parts.append(ref_sp.detect(self.w["superpoint"], x, self.max_kp, self.keep, prec))
        return ref_sp.Keypoints(*(torch.cat(p) for p in zip(*parts)))

    def encode(self, images: np.ndarray, prec: str) -> torch.Tensor:
        return torch.cat([self.encoder.encode(self.w["vpr"], torch.as_tensor(images[sl], device=self.device),
                                              self.cfg["vpr"], prec)
                          for sl in _chunks(len(images), self.frame_chunk)])

    def match(self, kp, pairs: np.ndarray, prec: str):
        """(idx0, valid) of every pair, matched on keypoints ``kp``."""
        coords, desc, mask = kp
        idx, valid = [], []
        for sl in _chunks(len(pairs), self.pair_chunk):
            q = torch.as_tensor(pairs[sl, 0], device=self.device)
            m = torch.as_tensor(pairs[sl, 1], device=self.device)
            mt = ref_lg.match(self.w["matcher"], (coords[q], desc[q], mask[q]),
                              (coords[m], desc[m], mask[m]), self.hw, self.heads,
                              self.threshold, prec)
            idx.append(mt.idx0)
            valid.append(mt.valid)
        return torch.cat(idx), torch.cat(valid)

    def verdict(self, kp, pairs: np.ndarray, matches, draws: torch.Tensor,
                K: np.ndarray, prec: str = F32) -> List[Row]:
        """The gate's verdict on ``pairs`` from keypoints ``kp`` and the
        (idx0, valid) ``matches``: RANSAC on ``draws`` (one block a pair) in
        float32 (TF32 products for the float8 control), in the gate's own
        verify batches (batched solves and SVDs round alike only at equal
        batch sizes), then the cuts."""
        if len(pairs) == 0:
            return []
        idx0, valid = matches
        coords = kp[0]
        Kt = torch.as_tensor(K, dtype=torch.float32, device=self.device)
        thr = float(self.cfg["gate"]["ransac_threshold_px"])
        n_inl, ratio = [], []
        with tf32(prec == FP8):
            for sl in _chunks(len(pairs), int(self.cfg["gate"]["verify_batch"])):
                q = torch.as_tensor(pairs[sl, 0], device=self.device)
                m = torch.as_tensor(pairs[sl, 1], device=self.device)
                ix = idx0[sl].to(self.device).long().clamp(min=0)
                k1 = coords[m].gather(1, ix[..., None].expand(-1, -1, 2))
                a, b = ref_ransac.inliers(coords[q], k1, valid[sl].to(self.device), Kt,
                                          draws[sl].to(self.device), thr)
                n_inl.append(a)
                ratio.append(b)
        n_match = valid.sum(1).cpu().numpy()
        n_inl = torch.cat(n_inl).cpu().numpy()
        ratio = torch.cat(ratio).cpu().numpy()
        g = self.cfg["gate"]
        out = []
        for i, (a, b) in enumerate(pairs):
            if n_match[i] < MIN_MATCHES:
                out.append(Row(int(a), int(b), 0, 0, 0.0, False))
                continue
            ok = n_inl[i] >= g["min_inliers"] and ratio[i] >= g["min_inlier_ratio"]
            out.append(Row(int(a), int(b), int(n_match[i]), int(n_inl[i]), float(ratio[i]), bool(ok)))
        return out

    # -- the judgement ------------------------------------------------------------------
    def judge(self, images: np.ndarray, times, floors, K, out: CallOutput,
              draws_for: Callable[[int], torch.Tensor]) -> Dict[str, float]:
        """Every number but ``structure`` for one call's output."""
        got = {}
        ref_kp = self.detect(images, F32)
        got.update(self._detector(out.kp, ref_kp, images.shape[1:]))
        del ref_kp
        ref_db = self.encode(images, F32)
        a = torch.nn.functional.normalize(out.db.to(torch.float32), dim=-1)
        b = torch.nn.functional.normalize(ref_db, dim=-1)
        got["encoder"] = float((1.0 - (a * b).sum(-1)).max())
        del ref_db, a, b
        total, rejected, surv = ref_retrieval.gate(out.db, times, floors, **self.gate_kw)
        mine = [(r.q, r.m) for r in out.rows]
        got["retrieval"] = float(len(set(mine) ^ set(surv)) + abs(total - out.total)
                                 + abs(rejected - out.rejected))
        pairs = np.asarray(mine, dtype=np.int64).reshape(-1, 2)
        if len(pairs):
            got["matcher"] = match_gap(out.matches, self.match(out.kp, pairs, F32))
            got.update(compare_rows(out.rows, self.verdict(out.kp, pairs, out.matches,
                                                           draws_for(len(pairs)), K)))
        else:
            got.update(matcher=0.0, ransac=0.0, decisions=0.0)
        return got

    def _detector(self, kp, ref: ref_sp.Keypoints, hw) -> Dict[str, float]:
        H, W = hw
        h8, w8 = ref_sp.detect_size(H, W)
        coords, desc, mask = kp
        sxy = torch.tensor([W / w8, H / h8], dtype=torch.float32, device=coords.device)
        g = torch.round(coords / sxy).to(torch.int64)
        grid = (g[..., 1] * w8 + g[..., 0]).cpu().numpy()
        mask_np, ref_mask = mask.cpu().numpy(), ref.mask.cpu().numpy()
        ref_grid = ref.grid.cpu().numpy()
        worst_j, worst_d = 0.0, 0.0
        for f in range(grid.shape[0]):
            mine = {int(x): i for i, x in enumerate(grid[f]) if mask_np[f, i]}
            theirs = {int(x): i for i, x in enumerate(ref_grid[f]) if ref_mask[f, i]}
            both = mine.keys() & theirs.keys()
            union = len(mine.keys() | theirs.keys())
            worst_j = max(worst_j, 1.0 - len(both) / union if union else 0.0)
            if both:
                ia = torch.as_tensor([mine[x] for x in both], device=desc.device)
                ib = torch.as_tensor([theirs[x] for x in both], device=desc.device)
                cos = (desc[f, ia].to(torch.float32) * ref.descriptors[f, ib.to(ref.descriptors.device)]).sum(-1)
                worst_d = max(worst_d, float((1.0 - cos).mean()))
        return {"detector": worst_j, "detector_desc": worst_d}

    def control_outputs(self, images: np.ndarray, times, floors, K,
                        draws_for: Callable[[int], torch.Tensor]) -> CallOutput:
        """The reference in the program's place at float8: one call's output."""
        kp = self.detect(images, FP8)
        kp3 = (kp.coords, kp.descriptors, kp.mask)
        db = self.encode(images, FP8)
        total, rejected, surv = ref_retrieval.gate(db, times, floors, **self.gate_kw)
        pairs = np.asarray(surv, dtype=np.int64).reshape(-1, 2)
        matches = self.match(kp3, pairs, FP8) if len(pairs) else (None, None)
        rows = self.verdict(kp3, pairs, matches, draws_for(len(pairs)), K, FP8)
        return CallOutput(total, rejected, rows, kp3, db, matches)


def match_gap(a, b) -> float:
    """sum |A xor B| / sum |A or B| over pairs of two (idx0, valid) match sets."""
    (ia, va), (ib, vb) = a, b
    va, vb = va.to(vb.device), vb
    agree = (va & vb & (ia.to(ib.device).long() == ib.long())).sum().item()
    na, nb = va.sum().item(), vb.sum().item()
    return (na + nb - 2 * agree) / max(na + nb - agree, 1)


def compare_rows(mine: Sequence[Row], ref: Sequence[Row]) -> Dict[str, float]:
    """``ransac`` and ``decisions`` of two verdicts on the same pairs."""
    ni = sum(abs(a.n_inl - b.n_inl) for a, b in zip(mine, ref))
    flips = 0
    for a, b in zip(mine, ref):
        if a.valid == b.valid:
            continue
        near = any(abs(r.n_inl - 20) <= INLIER_BAND or abs(r.ratio - 0.25) <= RATIO_BAND
                   for r in (a, b))
        flips += not near
    return {"ransac": ni / max(sum(b.n_inl for b in ref), 1),
            "decisions": float(flips)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[str]]:
    """(every number within its limit, one line per number: name, value, limit)."""
    ok, lines = True, []
    for name in NUMBERS:
        v, lim = numbers.get(name), limits[name]
        good = v is not None and np.isfinite(v) and v <= lim
        ok &= bool(good)
        lines.append(f"{name} {v!r} limit {lim!r}")
    return ok, lines


def draws_replay(seed: int, verify_batch: int, hypotheses: int, device) -> Callable[[int], torch.Tensor]:
    """RANSAC's draws of a call as the gate makes them from its generator:
    one (batch, hypotheses, 8) block a verify batch, in survivor order."""
    def draws(n_pairs: int) -> torch.Tensor:
        g = torch.Generator(device=device).manual_seed(seed)
        blocks = [torch.rand((sl.stop - sl.start, hypotheses, 8), generator=g, device=device,
                             dtype=torch.float32)
                  for sl in _chunks(n_pairs, verify_batch)]
        return torch.cat(blocks) if blocks else torch.zeros((0, hypotheses, 8), device=device)
    return draws


def worst(per_call: Sequence[Dict[str, float]], structure: float) -> Dict[str, Optional[float]]:
    """The worst reading of each number over the judged calls."""
    out: Dict[str, Optional[float]] = {"structure": float(structure)}
    for name in NUMBERS[1:]:
        vals = [d[name] for d in per_call if name in d]
        out[name] = max(vals) if vals else None
    return out
