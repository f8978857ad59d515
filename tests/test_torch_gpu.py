"""Card-only tests of the port: the CUDA kernel against its plain version
and the gate on the card against the CPU. They need an NVIDIA card and
``nvcc``; without a card they skip. Run them on the card with

    MLIS_TEST_PLATFORM=gpu python -m pytest -m gpu tests/test_torch_gpu.py

(the variable keeps tests/conftest.py from importing JAX, which the card's
machine does not have). This file imports neither JAX nor mlis_tpu."""

import numpy as np
import pytest
import torch

from mlis_tpu_torch.ops import pairwise as pw

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, 3)) * 30
    return centers[rng.integers(0, 8, n)] + rng.normal(size=(n, 3)), rng.integers(1, 6, n)


@pytest.mark.parametrize("n,min_gap", [(50, 30), (700, 25), (1500, 100), (5000, 100), (2100, 0)])
def test_kernel_equals_plain_version(cuda, n, min_gap):
    pos, floors = _cloud(n, n)
    p, f, ti, tj = pw.pack_sweep_inputs(pos, floors, min_gap, cuda)
    before = pw.tri_count.launches
    got = pw.tri_count(p, f, ti, tj, min_gap, 4.0)
    assert pw.tri_count.launches == before + 1
    assert got == pw.tri_count_plain(p, f, ti, tj, min_gap, 4.0)
    assert got == pw.candidate_counts_host(pos, floors, 2.0, min_gap)[:2]
    ai, aj = (torch.as_tensor(t, device=cuda) for t in pw.all_tiles(n))
    assert pw.tri_count(p, f, ai, aj, min_gap, 4.0) == got


def test_kernel_boundary_pairs(cuda):
    pos = np.zeros((300, 3))
    pos[:, 0] = np.arange(300) * 10.0
    pos[250] = pos[0] + [2.0, 0, 0]
    pos[251] = pos[1] + [2.0 - 1e-9, 0, 0]
    pos[252] = pos[2] + [2.0 + 1e-9, 0, 0]
    got = pw.candidate_counts(pos, np.ones(300, int), 2.0, 100, device=cuda)
    assert got == pw.candidate_counts_host(pos, np.ones(300, int), 2.0, 100) and got[0] == 2


def test_kernel_wrapper_rejects_mixed_devices(cuda):
    p, f, ti, tj = pw.pack_sweep_inputs(*_cloud(100, 1), 10, cuda)
    with pytest.raises(ValueError, match="is on cpu"):
        pw.tri_count(p, f.cpu(), ti, tj, 10, 4.0)


def test_long_attention_raises_on_the_card(cuda):
    from mlis_tpu_torch.models.lightglue import masked_attention

    q = torch.zeros(1, 1025, 1, 8, device=cuda)
    with pytest.raises(NotImplementedError, match="K2"):
        masked_attention(q, q, q, torch.tensor([1025], device=cuda))


def test_tiny_gate_card_matches_cpu(cuda):
    """A tiny random-weight gate, float32 with TF32 off, on both devices."""
    from mlis_tpu_torch.gating.full_gate import FullGatePipeline
    from mlis_tpu_torch.gating.place_recognition import SemanticPlaceRecognition
    from mlis_tpu_torch.gating.verification import GeometricVerifier
    from mlis_tpu_torch.models.lightglue import LightGlue, MatcherConfig
    from mlis_tpu_torch.models.resnet import ResNetConfig
    from mlis_tpu_torch.models.superpoint import SuperPointConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    bases = [np.kron(rng.integers(0, 255, (15, 20), dtype=np.uint8), np.ones((8, 8), np.uint8))
             for _ in range(4)]
    images = np.stack([bases[i % 4] for i in range(16)])
    times, floors = np.arange(16) * 30.0, np.asarray([5] * 8 + [2] * 8)
    K = np.array([[300.0, 0, 80.0], [0, 300.0, 60.0], [0, 0, 1.0]])
    torch.manual_seed(0)
    lg = LightGlue(sp_cfg=SuperPointConfig.tiny_test(max_keypoints=64, dtype=torch.float32),
                   matcher_cfg=MatcherConfig.tiny_test(dtype=torch.float32), device="cpu")
    spr = SemanticPlaceRecognition("mixvpr", similarity_threshold=0.5, device="cpu",
                                   backbone_cfg=ResNetConfig.tiny_test(dtype=torch.float32),
                                   input_size=(64, 64), checkpoint=None)
    sp_state, net_state = lg.sp.net.state_dict(), lg.net.state_dict()
    vpr_state = spr.vpr.module.state_dict()
    results = {}
    for dev in ("cpu", cuda):
        m = LightGlue(sp_cfg=lg.sp.cfg, matcher_cfg=lg.cfg, device=dev)
        m.sp.load_state(sp_state)
        m.net.load_state_dict(net_state)
        s = SemanticPlaceRecognition("mixvpr", similarity_threshold=0.5, device=dev,
                                     backbone_cfg=ResNetConfig.tiny_test(dtype=torch.float32),
                                     input_size=(64, 64), checkpoint=None)
        s.vpr.load_state(vpr_state)
        pipe = FullGatePipeline(vpr=s, verifier=GeometricVerifier(matcher=m),
                                similarity_threshold=0.5, verify_batch=8,
                                matcher_weights=None, device=dev)
        probe = pipe.process(images, times, floors, K, verify=False)
        u = torch.rand((probe.total_pairs - probe.cross_floor_rejected, 512, 8),
                       generator=torch.Generator().manual_seed(1))
        results[str(dev)] = pipe.process(images, times, floors, K, ransac_uniforms=u)
    a, b = results["cuda"], results["cpu"]
    assert (a.total_pairs, a.cross_floor_rejected) == (b.total_pairs, b.cross_floor_rejected)
    assert [(r.query_idx, r.match_idx) for r in a.results] == [
        (r.query_idx, r.match_idx) for r in b.results]
    for ra, rb in zip(a.results, b.results):
        assert ra.num_matches == rb.num_matches
        # float32 on two devices: an inlier at the Sampson threshold may flip
        assert abs(ra.num_inliers - rb.num_inliers) <= 3
