"""bench.py quality2's retrieval and CricaVPR-rerank rows in the port
held against mlis_tpu on the JAX package's seed-0 v2 scene (2 floors x 4
places x 2 passes at 135x180): each row's encoder from its shipped
checkpoint in both packages (the tiny trained ViT, the small SALAD, AnyLoc
over the tiny ViT, MixVPR, the CricaVPR rerank over the tiny encoder) gives
equal retrieval recall and aliased-trap rate, and the end-decision flow of
``run_gate_quality_rerank`` the same candidates, floor rejections,
verified pairs and scores with the rerank on and off."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from mlis_tpu.eval import quality as jq  # noqa: E402
from test_torch_quality import HW, HYP, jax_ransac_uniforms, shared_v2_scene  # noqa: E402

from mlis_tpu_torch.eval import quality as tq  # noqa: E402
from mlis_tpu_torch.weights import default_parallax_matcher_checkpoint  # noqa: E402


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return shared_v2_scene(tmp_path_factory)


def _row_encoders(name):
    """(JAX package's encoder, the port's) for one retrieval row of
    bench.py quality2, each from its shipped checkpoint."""
    from mlis_tpu.train import pretrain_vpr as jpv

    from mlis_tpu_torch.train import pretrain_vpr as tpv

    if name == "trained_vpr":
        return jpv.load_encoder(), tpv.load_encoder(device="cpu")
    if name in ("salad", "anyloc"):
        return jpv.load_encoder(arch=name), tpv.load_encoder(arch=name, device="cpu")
    if name == "mixvpr_trained":
        return (jpv.load_mixvpr_vpr().encode_batch_device,
                tpv.load_mixvpr_vpr(device="cpu").encode_batch_device)
    return jpv.load_crica_tiny_vpr(), tpv.load_crica_tiny_vpr(device="cpu")  # crica_tiny


@pytest.mark.parametrize("name,rerank", [
    ("trained_vpr", False), ("salad", False), ("anyloc", False), ("mixvpr_trained", False),
    ("crica_tiny", False), ("crica_tiny", True)])
def test_retrieval_rows_match_jax(scene, name, rerank):
    """bench.py quality2's rr_<name> (and, for the CricaVPR rerank over the
    tiny encoder, its aliased rate) on the JAX package's seed-0 scene:
    equal retrieval recall and aliased-trap rate."""
    ref_enc, enc = _row_encoders(name)
    assert enc is not None and ref_enc is not None
    kw = dict(top_k=16, threshold=0.30, rerank=rerank)
    want = jq.retrieval_metrics(scene, ref_enc, **kw)
    got = tq.retrieval_metrics(scene, enc, device="cpu", **kw)
    print(name, rerank, got)
    assert got["gt_found"] > 0
    for key in ("retrieval_recall", "aliased_rate", "gt_found"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("rerank", [False, True])
def test_gate_quality_rerank_matches_jax(scene, rerank):
    """run_gate_quality_rerank (the f1_crica_rerank_off/on rows' flow) with
    the CricaVPR rerank over the tiny encoder, the shipped bf16 SuperPoint
    and parallax LightGlue at 128 keypoints, and the reference's RANSAC
    draws: the same candidates, floor rejections and verified pairs, and
    (every decision equal on this scene) the same scores."""
    from mlis_tpu.train.pretrain_vpr import load_crica_tiny_vpr as jax_crica_tiny

    from mlis_tpu_torch.train.pretrain_vpr import load_crica_tiny_vpr

    kw = dict(rerank=rerank, top_k=16, similarity_threshold=0.30, max_keypoints=128,
              weights_path=default_parallax_matcher_checkpoint())
    ref = jq.run_gate_quality_rerank(scene, crica=jax_crica_tiny(), **kw)
    u = torch.from_numpy(jax_ransac_uniforms(ref["verified"], 64, HYP))
    got = tq.run_gate_quality_rerank(scene, crica=load_crica_tiny_vpr(device="cpu"),
                                     ransac_uniforms=u, device="cpu", **kw)
    print(ref, got)
    assert got["verified"] > 0 and got["true_positives"] > 0
    for key in ("total_candidates", "cross_floor_rejected", "verified", "encoder", "weights",
                "rerank", "f1", "precision", "recall", "true_positives", "false_positives"):
        assert got[key] == ref[key], key
