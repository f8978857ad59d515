"""bench.py quality2's SuperGlue, ORB and LoFTR rows in the port held
against mlis_tpu on the JAX package's seed-0 v2 scene (2 floors x 4 places
x 2 passes at 135x180, the scene of test_torch_quality.py): each row's
matcher from its shipped checkpoint (superglue_parallax.npz, ORB
weight-free, loftr_parallax.npz at its 0.05 coarse threshold) behind the
parallax-trained tiny encoder, top-16 retrieval at 0.30, with the RANSAC
draws of the JAX package's own path for the family, fed to the port:

* SuperGlue rides the fused path, as LightGlue does: one key per survivor
  from its verify bucket;
* ORB is verified pair by pair through ``verify``: ``PRNGKey(0)`` for
  every pair;
* LoFTR goes through the dense branch of ``verify_pairs_batch`` in chunks
  of 32: chunk s draws from ``PRNGKey(s)`` split over the chunk padded to a
  power of two.

Both packages' pair lists are held to ``eval/quality.decision_drift``
with the family's confident cut (16 for SuperGlue, none for ORB and LoFTR,
which report no confident count): identical candidates, floor rejections
and verified pairs, equal weights labels, and decisions equal except where
a count lies in the band around its cut. The bands, measured on this
scene:

* SuperGlue, float32 models (the JAX package's configs swapped for
  float32 ones inside the test): confident matches equal on all 42 pairs
  (band 1), inliers within 3 past the cut (measured: no pair reaches 16
  confident matches in either run without equal inliers); below the cut
  inliers drift by up to 15 on wrong-place pairs, the float32 8-point
  drift of test_torch_quality.py;
* SuperGlue, bf16 as shipped: confident matches within 8 (measured 7:
  bf16 SuperPoint and matcher layers summed in another order move the
  20-iteration transport, which pools every keypoint's similarities), so
  a decision may differ within 8 of the cut of 16; measured: none does;
* ORB, no learned model: inliers within 9 of 20 (measured 9). One
  descriptor bit in some 10^4 flips with the last ulp of the moments'
  sums, atan2 and cos (XLA and PyTorch sum 961 terms in another order),
  which moves one match in the distance order, or in or out of the mutual
  set; RANSAC's 512 draws then pick other correspondences. Fed the JAX
  package's own matches, the port's RANSAC gives its inliers exactly
  (test_torch_orb.py); one decision differs here (25 against 16 inliers);
* LoFTR, bf16 as shipped: inliers within 3 of 20 (measured: no pair
  within 11 of the cut differs; bf16 convolutions summed in another order
  move a few coarse matches and their top-k order).
"""

import dataclasses
from typing import Any

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.eval import quality as jq  # noqa: E402
from mlis_tpu.models import weights as jw  # noqa: E402
from test_torch_quality import HW, HYP, jax_ransac_uniforms  # noqa: E402

from mlis_tpu_torch import weights as tw  # noqa: E402
from mlis_tpu_torch.eval import quality as tq  # noqa: E402

PROTOCOL = dict(encoder="trained_vpr_v2", top_k=16, similarity_threshold=0.30, max_keypoints=128,
                return_pairs=True)
VERIFY_BATCH = {"superglue": 256, "orb": 256, "loftr": 32}  # bench.py quality2's
BANDS = {"superglue": dict(conf_band=8, inlier_band=3, bound_inliers=False),
         "superglue_f32": dict(conf_band=1, inlier_band=3, bound_inliers=True),
         "orb": dict(conf_band=0, inlier_band=9, bound_inliers=False),
         "loftr": dict(conf_band=0, inlier_band=3, bound_inliers=False)}
LABELS = {"superglue": "superglue_parallax.npz", "orb": "orb_weight_free",
          "loftr": "loftr_parallax.npz"}


@pytest.fixture(scope="module")
def scene():
    return jq.make_quality_scene_v2(n_floors=2, n_places=4, hw=HW, seed=0)


def jax_family_uniforms(family: str, n_surv: int, verify_batch: int) -> np.ndarray:
    """The (n_surv, HYP, 8) RANSAC uniforms mlis_tpu draws for each survivor
    on the family's path."""
    def draw(keys):
        return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (HYP, 8)))(keys))

    if family == "superglue":
        return jax_ransac_uniforms(n_surv, verify_batch, HYP)
    if family == "orb":
        one = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (HYP, 8)))
        return np.broadcast_to(one, (n_surv, HYP, 8)).copy()
    out = []
    for s in range(0, n_surv, verify_batch):
        b = min(verify_batch, n_surv - s)
        pad = 1 << max(3, (b - 1).bit_length())
        out.append(draw(jax.random.split(jax.random.PRNGKey(s), pad)[:b]))
    return np.concatenate(out)


def _weights(family):
    if family == "superglue":
        return jw.default_parallax_superglue_checkpoint(), tw.default_parallax_superglue_checkpoint()
    if family == "loftr":
        return jw.default_parallax_loftr_checkpoint(), tw.default_parallax_loftr_checkpoint()
    return None, None


def _float32_configs(mp) -> None:
    """Swap the JAX package's SuperPoint, matcher and LoFTR configs for
    float32 subclasses (no file of the package changes)."""
    from mlis_tpu.models import lightglue as jlg
    from mlis_tpu.models import loftr as jlf
    from mlis_tpu.models import superpoint as jsp

    for mod, name in ((jsp, "SuperPointConfig"), (jlg, "MatcherConfig"), (jlf, "LoFTRConfig")):
        cls = getattr(mod, name)
        mp.setattr(mod, name, dataclasses.dataclass(frozen=True)(type(
            name, (cls,), {"__annotations__": {"dtype": Any}, "dtype": jnp.float32})))


@pytest.mark.parametrize("family,float32", [
    ("superglue", False), ("superglue", True), ("orb", False), ("loftr", False)])
def test_matcher_row_matches_jax(scene, family, float32):
    """quality2's row for ``family``: the same weights label, candidates,
    floor rejections and verified pairs as mlis_tpu, decisions within the
    family's band (module docstring)."""
    jpath, tpath = _weights(family)
    vb = VERIFY_BATCH[family]
    with pytest.MonkeyPatch.context() as mp:
        if float32:
            _float32_configs(mp)
        ref = jq.run_gate_quality(family, scene=scene, weights_path=jpath, verify_batch=vb,
                                  **PROTOCOL)
    u = torch.from_numpy(jax_family_uniforms(family, ref["verified"], vb))
    got = tq.run_gate_quality(family, scene=scene, weights_path=tpath, verify_batch=vb,
                              ransac_uniforms=u, device="cpu",
                              model_dtype=torch.float32 if float32 else torch.bfloat16,
                              **PROTOCOL)
    assert got["weights"] == ref["weights"] == LABELS[family]
    for key in ("encoder", "total_candidates", "verified", "gt_pairs", "n_frames"):
        assert got[key] == ref[key], key
    assert got["verified"] > 0
    bands = BANDS[family + ("_f32" if float32 else "")]
    stats, broken = tq.decision_drift(ref["pairs"], got["pairs"],
                                      confident_cut=tq.CONFIDENT_CUTS[family], **bands)
    print(family, {k: ref[k] for k in ("f1", "precision", "recall", "geometrically_valid")},
          {k: got[k] for k in ("f1", "precision", "recall", "geometrically_valid")}, stats)
    assert not broken, broken
    if family != "superglue":  # no confident count on the classical and dense paths
        assert {p["num_confident_matches"] for p in got["pairs"]} == {-1}
    if stats["decisions_differing"] == 0:
        for key in ("f1", "precision", "recall", "true_positives", "false_positives"):
            assert got[key] == ref[key], key


def test_build_verifier_labels_and_cuts():
    """build_verifier's weights labels, cuts and thresholds for the three
    families, as mlis_tpu's: SuperGlue's cut of 16, LoFTR's 0.05 coarse
    threshold only when its checkpoint loads, ORB weight-free."""
    for fam in ("superglue", "loftr", "orb"):
        jpath, tpath = _weights(fam)
        rv, rw = jq.build_verifier(fam, 64, HW, weights_path=jpath)
        v, w = tq.build_verifier(fam, 64, HW, weights_path=tpath, device="cpu")
        assert w == rw == LABELS[fam]
        assert v.min_confident_matches == rv.min_confident_matches
        assert type(v.matcher).__name__ == type(rv.matcher).__name__
    v, _ = tq.build_verifier("loftr", 64, HW, weights_path=tw.default_parallax_loftr_checkpoint(),
                             device="cpu")
    assert v.matcher.cfg.match_threshold == 0.05
    v, w = tq.build_verifier("loftr", 64, HW, weights_path="no/such.npz", device="cpu")
    assert (w, v.matcher.cfg.match_threshold) == ("random_init", 0.2)
    v, w = tq.build_verifier("loftr", 64, HW, weights_path=tw.default_parallax_loftr_checkpoint(),
                             loftr_match_threshold=0.3, device="cpu")
    assert v.matcher.cfg.match_threshold == 0.3
    assert tq.CONFIDENT_CUTS == {"trained": 6, "random": 6, "superglue": 16, "loftr": None,
                                 "orb": None}
