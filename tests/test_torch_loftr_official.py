"""The port's official LoFTR architecture (``LoFTRConfig(official=True)`` in
mlis_tpu_torch/models/loftr.py) against mlis_tpu's and against the torch
re-implementation of the published model in tests/loftr_torch_ref.py.

One official-layout state dict is drawn from ``np.random.default_rng(0)``
at ``official_tiny`` widths, Kaiming-scaled at 0.5x (unit scale drives the
dual-softmax confidences into subnormals, where torch and XLA differ), and
loaded into all three through ``load_torch_state_dict``. In float32:

* ``sine_pos_encoding`` is exact (host numpy in both packages) for both
  ``temp_bug_fix`` settings;
* ``ResNetFPN82``, ``OfficialLoFTRNet`` and ``OfficialFineModule`` agree
  with the JAX package within 2e-4 absolute and 1e-3 relative, the
  tolerance tests/test_convert.py holds the JAX package to against the
  torch oracle;
* ``gather_fine_windows`` is exact, ``fine_spatial_expectation`` within
  1e-6;
* end to end, with a coarse threshold of 1e-6 (at which matches exist), the
  valid masks and matched cells equal the JAX package's and the oracle's,
  the refined keypoints agree within 5e-3 px and the scores within 1e-5
  absolute and 1e-3 relative (tests/test_convert.py's band);
* the resize contract on a 68x70 pair (resized down to 64x64, keypoints
  scaled back) and the dense branch of ``verify_pairs_batch`` with the JAX
  package's RANSAC draws: match counts equal, inliers within 3, decisions
  equal.

The weights cross between the packages through ``save_weights`` /
``load_weights`` in both directions (the float16 npz trees equal), and the
full-size template (``official_full``) takes the lightning layout. Every
JAX ``match_batch`` runs 8 pairs at 64x64, so it compiles once.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.gating import verification as jv  # noqa: E402
from mlis_tpu.models import loftr as jl  # noqa: E402
from mlis_tpu.models.weights import load_params_npz as jax_load_params  # noqa: E402

from mlis_tpu_torch.gating import verification as tv  # noqa: E402
from mlis_tpu_torch.models import loftr as tl  # noqa: E402
from mlis_tpu_torch.weights import flatten_params, load_params_npz, to_jax_params  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
from loftr_torch_ref import LoFTRTorch, PositionEncodingSine  # noqa: E402
from test_torch_convert import LOFTR_TINY, _shape_template, fake_loftr_sd  # noqa: E402

STAGE_ATOL, STAGE_RTOL = 2e-4, 1e-3
KPT_ATOL = 5e-3
THRESHOLD = 1e-6
B = 8


def _jax_loftr(cfg, sd):
    """A JAX LoFTR with ``sd`` loaded; the template from ``eval_shape``, so
    the JAX package's eager init (tens of seconds) is skipped."""
    m = jl.LoFTR(cfg)
    im = jnp.zeros((1, 64, 64, 1))
    m.params = {"params": _shape_template(m.net, im, im)}
    if sd is not None:
        m.load_torch_state_dict(sd)
    return m


@pytest.fixture(scope="module")
def models():
    sd = fake_loftr_sd(np.random.default_rng(0), LOFTR_TINY)
    oracle = LoFTRTorch(**LOFTR_TINY, window=5)
    oracle.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    oracle.eval()
    J = _jax_loftr(jl.LoFTRConfig.official_tiny(dtype=jnp.float32, match_threshold=THRESHOLD), sd)
    T = tl.LoFTR(tl.LoFTRConfig.official_tiny(dtype=torch.float32, match_threshold=THRESHOLD),
                 device="cpu")
    T.load_torch_state_dict(sd)
    return sd, oracle, J, T


def _pairs(seed, hw=(64, 64), shift=8):
    """B pairs of a blocky random texture and its copy shifted by ``shift``
    columns, grayscale in [0, 1]."""
    rng = np.random.default_rng(seed)
    cells = rng.random((B, hw[0] // 4 + 1, (hw[1] + shift) // 4 + 1)).astype(np.float32)
    tex = np.kron(cells, np.ones((4, 4), np.float32))
    return (np.ascontiguousarray(tex[:, : hw[0], : hw[1], None]),
            np.ascontiguousarray(tex[:, : hw[0], shift : shift + hw[1], None]))


@pytest.mark.parametrize("temp_bug_fix", [False, True])
def test_sine_pos_encoding_exact(temp_bug_fix):
    got = tl.sine_pos_encoding(256, 67, 90, temp_bug_fix)
    want = jl.sine_pos_encoding(256, 67, 90, temp_bug_fix)
    assert got.dtype == want.dtype == np.float32 and got.shape == (67, 90, 256)
    assert np.array_equal(got, want)
    if not temp_bug_fix:  # the released checkpoints' div term is exp(-arange)
        x = np.arange(1, 91, dtype=np.float32)
        np.testing.assert_allclose(got[0, :, 4], np.sin(x * np.exp(np.float32(-2.0))), atol=1e-6)
    ref = PositionEncodingSine(256, (67, 90), temp_bug_fix).pe[0].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_backbone_and_coarse_net_match_jax(models):
    _, _, J, T = models
    im0, im1 = _pairs(1)
    cfg = J.cfg
    coarse_params = {"params": J.params["params"]["coarse"]}
    want_c, want_f = jax.jit(lambda p, x: jl.ResNetFPN82(cfg).apply(p, x))(
        {"params": coarse_params["params"]["backbone"]}, jnp.asarray(im0))
    with torch.no_grad():
        got_c, got_f = T.net.coarse.backbone(torch.from_numpy(im0))
    for got, want in ((got_c, want_c), (got_f, want_f)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   atol=STAGE_ATOL, rtol=STAGE_RTOL)
    want = jax.jit(lambda p, a, b: jl.OfficialLoFTRNet(cfg).apply(p, a, b))(
        coarse_params, jnp.asarray(im0), jnp.asarray(im1))
    with torch.no_grad():
        got = T.net.coarse(torch.from_numpy(im0), torch.from_numpy(im1))
    assert got[4] == want[4] == (8, 8)
    for g, w in zip(got[:4], want[:4]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=STAGE_ATOL, rtol=STAGE_RTOL)


def test_fine_module_matches_jax(models):
    _, _, J, T = models
    rng = np.random.default_rng(2)
    w0, w1 = (rng.normal(size=(2, 7, 25, 16)).astype(np.float32) for _ in range(2))
    c0, c1 = (rng.normal(size=(2, 7, 32)).astype(np.float32) for _ in range(2))
    want = jax.jit(lambda p, *a: jl.OfficialFineModule(J.cfg).apply(p, *a))(
        {"params": J.params["params"]["fine"]}, *map(jnp.asarray, (w0, w1, c0, c1)))
    with torch.no_grad():
        got = T.net.fine(*map(torch.from_numpy, (w0, w1, c0, c1)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=STAGE_ATOL, rtol=STAGE_RTOL)


def test_fine_windows_and_spatial_expectation():
    rng = np.random.default_rng(3)
    f = rng.normal(size=(2, 32, 40, 6)).astype(np.float32)
    cx = rng.integers(0, 10, (2, 9))  # cells on the border pad with zeros
    cy = rng.integers(0, 8, (2, 9))
    cx[0, 0], cy[0, 0] = 0, 0
    want = np.asarray(jl.gather_fine_windows(jnp.asarray(f), jnp.asarray(cx), jnp.asarray(cy), 5))
    got = tl.gather_fine_windows(torch.from_numpy(f), torch.from_numpy(cx),
                                 torch.from_numpy(cy), 5).numpy()
    assert got.shape == (2, 9, 25, 6) and np.array_equal(got, want)
    assert (got[0, 0, :2] == 0).all()
    # F.unfold(kernel 5, stride 4, padding 2) at the same cells
    unf = torch.nn.functional.unfold(torch.from_numpy(f).permute(0, 3, 1, 2), 5, stride=4,
                                     padding=2).reshape(2, 6, 25, 8, 10)
    ref = unf[torch.arange(2)[:, None], :, :, torch.from_numpy(cy), torch.from_numpy(cx)]
    assert np.array_equal(got, ref.permute(0, 1, 3, 2).numpy())
    w0, w1 = (rng.normal(size=(2, 9, 25, 6)).astype(np.float32) for _ in range(2))
    want = np.asarray(jl.fine_spatial_expectation(jnp.asarray(w0), jnp.asarray(w1), 5))
    got = tl.fine_spatial_expectation(torch.from_numpy(w0), torch.from_numpy(w1), 5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _oracle_matches(oracle, cfg, im0, im1):
    """The torch oracle's official match set for one pair: {cell0: (kpt1,
    score)}, with tests/test_convert.py's selection logic."""
    t_im0, t_im1 = (torch.from_numpy(x).permute(0, 3, 1, 2) for x in (im0, im1))
    tt0, tt1, tf0, tf1, (hc, wc) = oracle.forward_coarse(t_im0, t_im1)
    conf = oracle.conf_matrix(tt0, tt1)[0].numpy()
    xs, ys = np.arange(hc * wc) % wc, np.arange(hc * wc) // wc
    r = cfg.border_rm
    interior = (xs >= r) & (xs < wc - r) & (ys >= r) & (ys < hc - r)
    conf = conf * interior[:, None] * interior[None, :]
    best1, best0 = conf.argmax(1), conf.argmax(0)
    cvals = conf[np.arange(hc * wc), best1]
    sel = np.nonzero((best0[best1] == np.arange(hc * wc)) & (cvals > cfg.match_threshold))[0]
    if not len(sel):
        return {}
    _, _, coords = oracle.forward_fine(tf0, tf1, tt0, tt1, torch.zeros(len(sel), dtype=torch.long),
                                       torch.from_numpy(sel), torch.from_numpy(best1[sel]))
    out = {}
    for n, (i, j) in enumerate(zip(sel, best1[sel])):
        k1 = np.array([(j % wc) * 8.0, (j // wc) * 8.0]) + coords[n].numpy() * (cfg.fine_window // 2) * 2.0
        out[(i % wc, i // wc)] = (k1, cvals[i])
    return out


def test_matches_end_to_end_against_jax_and_the_torch_oracle(models):
    _, oracle, J, T = models
    im0, im1 = _pairs(4)
    want = [np.asarray(x) for x in J.match_batch(jnp.asarray(im0), jnp.asarray(im1))]
    got = [x.numpy() for x in T.match_batch(torch.from_numpy(im0), torch.from_numpy(im1))]
    assert got[3].sum() > 2 * B  # matches exist at this threshold
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[0], want[0])  # the matched cells of image 0
    np.testing.assert_allclose(got[1], want[1], atol=KPT_ATOL, rtol=0)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=1e-3)
    for p in range(B):
        ref = _oracle_matches(oracle, T.cfg, im0[p : p + 1], im1[p : p + 1])
        v = got[3][p]
        assert len(ref) == int(v.sum())
        for k0, k1, sc in zip(got[0][p][v], got[1][p][v], got[2][p][v]):
            tk1, tsc = ref[(int(k0[0]) // 8, int(k0[1]) // 8)]
            np.testing.assert_allclose(k1, tk1, atol=KPT_ATOL)
            np.testing.assert_allclose(sc, tsc, atol=1e-5, rtol=1e-3)


def test_resize_contract_on_sides_not_multiples_of_8(models):
    _, _, J, T = models
    im0, im1 = _pairs(5, hw=(68, 70))
    want = [np.asarray(x) for x in J.match_batch(jnp.asarray(im0), jnp.asarray(im1))]
    got = [x.numpy() for x in T.match_batch(torch.from_numpy(im0), torch.from_numpy(im1))]
    assert got[3].sum() > 0
    np.testing.assert_array_equal(got[3], want[3])
    # keypoints scaled back by (70 / 64, 68 / 64)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=KPT_ATOL, rtol=0)


def test_dense_branch_of_verify_pairs_batch(models):
    _, _, J, T = models
    im0, im1 = _pairs(6)
    K = np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]], np.float32)
    pairs = [(p, p + B) for p in range(B)]
    ref = jv.GeometricVerifier(matcher=J).verify_pairs_batch(im0, im1, K, indices=pairs, seed=0,
                                                             batch_size=B)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (512, 8)))(keys))
    got = tv.GeometricVerifier(matcher=T).verify_pairs_batch(im0, im1, K, indices=pairs,
                                                             batch_size=B, uniforms=torch.tensor(u))
    assert [(r.query_idx, r.match_idx) for r in got] == pairs
    assert [r.num_matches for r in got] == [r.num_matches for r in ref]
    assert max(abs(a.num_inliers - b.num_inliers) for a, b in zip(got, ref)) <= 3
    assert [r.is_valid for r in got] == [r.is_valid for r in ref]
    assert all(r.num_matches > 0 and r.num_confident_matches == -1 for r in got)


def test_weights_cross_between_the_packages(models, tmp_path):
    """Port save_weights -> JAX load_weights and JAX save_weights -> port
    load_weights: the float16 npz trees equal, and a port matcher loaded
    from the JAX package's file gives the saving matcher's matches within
    the float16 rounding of its weights."""
    _, _, J, T = models
    port_file, jax_file = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    T.save_weights(port_file)
    J2 = _jax_loftr(J.cfg, None)
    J2.load_weights(port_file, image_hw=(64, 64))
    back = flatten_params(jax.device_get(J2.params["params"]))
    mine = flatten_params(load_params_npz(port_file)["loftr"])
    assert sorted(back) == sorted(mine) and len(mine) == len(flatten_params(J.params["params"]))
    for k, v in mine.items():
        assert np.array_equal(np.asarray(back[k]), v), k
    J.save_weights(jax_file)
    T2 = tl.LoFTR(T.cfg, device="cpu")
    T2.load_weights(jax_file)
    theirs = flatten_params(jax_load_params(jax_file)["loftr"])
    for k, v in flatten_params(to_jax_params(T2.net.state_dict())).items():
        assert np.array_equal(v, np.asarray(theirs[k])), k
    T3 = tl.LoFTR(T.cfg, device="cpu")
    T3.load_weights(port_file)
    im0, im1 = _pairs(4)
    a, b = (m.match_batch(torch.from_numpy(im0), torch.from_numpy(im1)) for m in (T2, T3))
    assert torch.equal(a.valid, b.valid) and torch.equal(a.kpts1, b.kpts1)


def test_full_dims_template_takes_the_lightning_layout():
    """The released configuration's template (d_model 256, depth 4, block
    dims 128/196/256) equals the JAX package's and loads a full-size
    ``LoFTRTorch()`` state dict in the raw lightning layout."""
    T = tl.LoFTR(tl.LoFTRConfig.official_full(max_matches=128), device="cpu")
    im = jnp.zeros((1, 64, 64, 1))
    want = _shape_template(jl.OfficialLoFTRMatcher(jl.LoFTRConfig.official_full()), im, im)
    mine = flatten_params(to_jax_params(T.net.state_dict()))
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in flatten_params(want).items()}
    sd = LoFTRTorch().state_dict()
    T.load_torch_state_dict({"state_dict": {f"matcher.{k}": v for k, v in sd.items()}})
    q = T.net.coarse.coarse_self3.q_proj.weight
    assert tuple(q.shape) == (256, 256)
    assert torch.equal(q, sd["loftr_coarse.layers.6.q_proj.weight"])
    with pytest.raises(ValueError, match="official=True"):
        tl.LoFTR(tl.LoFTRConfig.tiny_test(), device="cpu").load_torch_state_dict(sd)
