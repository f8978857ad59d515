"""The port's LightGlue against mlis_tpu's, float32, with
lightglue_homog_sp.npz loaded on both sides."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.models import lightglue as jlg  # noqa: E402
from mlis_tpu.models.superpoint import SuperPointConfig as JaxSPC  # noqa: E402
from mlis_tpu.models.weights import matcher_arch_from_npz  # noqa: E402

from mlis_tpu_torch.models import lightglue as tlg  # noqa: E402
from mlis_tpu_torch.models.superpoint import Keypoints, SuperPointConfig  # noqa: E402

CKPT = "checkpoints/lightglue_homog_sp.npz"
HW = (96, 128)


@pytest.fixture(scope="module")
def matchers():
    ref = jlg.LightGlue(sp_cfg=JaxSPC(max_keypoints=128, dtype=jnp.float32),
                       matcher_cfg=jlg.MatcherConfig(dtype=jnp.float32, **matcher_arch_from_npz(CKPT)))
    ref.load_weights(CKPT, image_hw=HW)
    port = tlg.LightGlue.from_checkpoint(
        CKPT, sp_cfg=SuperPointConfig(max_keypoints=128, dtype=torch.float32),
        dtype=torch.float32, device="cpu")
    return ref, port


def _keypoints(rng, n_img=4):
    base = np.kron(rng.integers(0, 255, (HW[0] // 8 + 1, HW[1] // 8 + 1)), np.ones((8, 8)))
    imgs = np.stack([np.roll(base[: HW[0], : HW[1]], 2 * i, 1) for i in range(n_img)])
    return imgs.astype(np.float32)[..., None] / 255.0


def test_rotary_and_attention_pieces():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    ang = rng.normal(size=(2, 5, 4)).astype(np.float32)
    want = np.asarray(jlg.apply_rotary(jnp.asarray(x), jnp.cos(ang), jnp.sin(ang)))
    got = tlg.apply_rotary(torch.from_numpy(x), torch.cos(torch.from_numpy(ang)),
                           torch.sin(torch.from_numpy(ang))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    coords = rng.uniform(0, 100, size=(2, 5, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tlg.normalize_keypoints(torch.from_numpy(coords), (60, 100)).numpy(),
        np.asarray(jlg.normalize_keypoints(jnp.asarray(coords), (60, 100))), atol=1e-7)
    # masked attention with kv lengths, including an empty key set
    q = rng.normal(size=(3, 6, 2, 8)).astype(np.float32)
    k = rng.normal(size=(3, 7, 2, 8)).astype(np.float32)
    v = rng.normal(size=(3, 7, 2, 8)).astype(np.float32)
    kv_len = np.array([7, 3, 0], np.int32)
    want = np.asarray(jax.nn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), key_value_seq_lengths=jnp.asarray(kv_len)))
    got = tlg.masked_attention(*(torch.from_numpy(a) for a in (q, k, v, kv_len))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)


def _stand_in(device="cuda", dtype=torch.bfloat16, shape=(8, 512, 4, 64), requires_grad=False):
    """What flash_kernel_route reads of a tensor, without a card."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype, shape=shape,
                           requires_grad=requires_grad)


@pytest.mark.parametrize("case,want", [
    ({}, True),
    ({"dtype": torch.float16}, True),
    ({"shape": (8, 1100, 4, 16)}, True),
    ({"device": "cpu"}, False),
    ({"dtype": torch.float32}, False),
    ({"requires_grad": True}, False),
    ({"shape": (8, 512, 4, 48)}, False),
    ({"shape": (20000, 512, 4, 64)}, False),
])
def test_flash_kernel_route_follows_the_input(case, want):
    """The kernel route needs a CUDA device, bf16 / f16 operands, no
    autograd need and a head width and batch of heads the kernel is built
    for; the CPU, float32 matchers and training keep the plain route."""
    q = _stand_in(**case)
    kv = _stand_in(**{**case, "shape": case.get("shape", (8, 512, 4, 64))})
    assert tlg.flash_kernel_route(q, kv, kv) is want


def test_flash_kernel_route_refuses_mixed_dtypes_and_no_keys_and_allows_no_grad():
    q = _stand_in()
    assert not tlg.flash_kernel_route(q, _stand_in(dtype=torch.float16), _stand_in())
    assert not tlg.flash_kernel_route(q, _stand_in(shape=(8, 0, 4, 64)),
                                      _stand_in(shape=(8, 0, 4, 64)))
    grad = _stand_in(requires_grad=True)
    assert not tlg.flash_kernel_route(grad, q, q)
    assert not tlg.flash_kernel_route(q, q, grad)
    with torch.no_grad():  # inference of a trainable matcher: nothing to differentiate
        assert tlg.flash_kernel_route(grad, q, q)
    with torch.inference_mode():
        assert tlg.flash_kernel_route(grad, grad, grad)


def test_cpu_tensors_take_the_plain_route(monkeypatch):
    """Real CPU tensors, bf16 under no_grad as the gate runs them: the
    route is plain and the kernel's launcher is never reached."""
    def refuse(*a, **kw):
        raise AssertionError("the flash kernel was launched on the CPU")

    monkeypatch.setattr(tlg, "_launch_flash", refuse)
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(4, 40, 2, 16, generator=g).to(torch.bfloat16) for _ in range(3))
    kv_len = torch.tensor([40, 17, 1, 0])
    with torch.no_grad():
        assert not tlg.flash_kernel_route(q, k, v)
        got = tlg.masked_attention(q, k, v, kv_len)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    # the empty row averages V over every key (uniform softmax)
    probs = torch.full((40,), 1.0 / 40).to(torch.bfloat16).float()
    want = (probs[:, None, None] * v[3].float()).sum(0)
    torch.testing.assert_close(got[3].float(), want.expand(40, -1, -1).to(torch.bfloat16).float())


@pytest.mark.parametrize("rot,Kx,Ks", [(True, 64, 64), (False, 64, 48), (True, 1100, 1100)])
def test_attn_layer_hands_the_kernel_its_views_in_place(monkeypatch, rot, Kx, Ks):
    """With the route taken (forced here, since there is no card), AttnLayer
    hands the launcher the rotated q and k and v as views that the kernel's
    checks accept without a copy, the key lengths it holds repeated over
    the heads as a contiguous int32 vector, and the mean-of-V rule for
    empty rows up to Kx*Ks = 1024^2 only."""
    from mlis_tpu_torch.ops.flash_attention import check_views, flash_mha

    seen = []

    def launch(q, k, v, lens, mean_empty=False):
        check_views(q, k, v, "flash_attention")
        seen.append((lens, mean_empty))
        return flash_mha(q, k, v)

    monkeypatch.setattr(tlg, "flash_kernel_route", lambda q, k, v: True)
    monkeypatch.setattr(tlg, "_launch_flash", launch)
    torch.manual_seed(6)
    layer = tlg.AttnLayer(32, 2, torch.bfloat16)
    B = 3
    x = torch.randn(B, Kx, 32).to(torch.bfloat16)
    src = x if rot else torch.randn(B, Ks, 32).to(torch.bfloat16)
    valid = torch.arange(Ks)[None] < torch.tensor([[Ks], [5], [0]])
    cos_sin = (torch.cos(torch.randn(B, Kx, 8)), torch.sin(torch.randn(B, Kx, 8)))
    with torch.no_grad():
        layer(x, src, valid, *((cos_sin, cos_sin) if rot else ()))
    (lens, mean_empty), = seen
    assert lens.dtype == torch.int32 and lens.is_contiguous() and lens.shape == (2 * B,)
    assert lens.tolist() == [Ks, Ks, 5, 5, 0, 0]
    assert mean_empty is (Kx * Ks <= tlg.FLASH_MIN_PRODUCT)


def test_matcher_scores_and_matches_with_shipped_weights(matchers):
    ref, port = matchers
    rng = np.random.default_rng(1)
    imgs = _keypoints(rng)
    kp = ref.sp.detect(jnp.asarray(imgs))
    j0 = jax.tree_util.tree_map(lambda a: a[:2], kp)
    j1 = jax.tree_util.tree_map(lambda a: a[2:], kp)
    want_scores = np.asarray(ref.net.apply(
        ref.params, j0.descriptors, j0.coords, j0.mask, j1.descriptors, j1.coords, j1.mask, HW))
    want = ref.match_keypoints(j0, j1, HW)

    t0, t1 = (Keypoints(*(torch.tensor(np.asarray(a)) for a in x)) for x in (j0, j1))
    got_scores = port.net(t0.descriptors, t0.coords, t0.mask, t1.descriptors, t1.coords,
                          t1.mask, HW).detach().numpy()
    # float32 through 9 layers of attention: summation order differs
    np.testing.assert_allclose(got_scores, want_scores, atol=2e-5)
    got = port.match_keypoints(t0, t1, HW)
    np.testing.assert_array_equal(got.idx0.numpy(), np.asarray(want.idx0))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=2e-5)
    assert got.valid.sum() > 10


def test_unequal_keypoint_counts_are_padded(matchers):
    ref, port = matchers
    rng = np.random.default_rng(2)
    d0, d1 = (rng.normal(size=(1, k, 256)).astype(np.float32) for k in (40, 64))
    c0, c1 = (rng.uniform(0, 90, size=(1, k, 2)).astype(np.float32) for k in (40, 64))
    m0, m1 = np.ones((1, 40), bool), np.arange(64)[None] < 50
    want = np.asarray(ref.net.apply(ref.params, *(jnp.asarray(a) for a in (d0, c0, m0, d1, c1, m1)), HW))
    got = port.net(*(torch.from_numpy(a) for a in (d0, c0, m0, d1, c1, m1)), HW).detach().numpy()
    assert got.shape == want.shape == (1, 40, 64)
    np.testing.assert_allclose(got, want, atol=2e-5)


def _second_view(coords, K, rng):
    """Where keypoints at random depths move under a rigid motion
    (x2 ~ R x1 + t): a real two-view geometry for RANSAC to find."""
    z = rng.uniform(3, 6, coords.shape[0])
    X = np.c_[(coords - K[:2, 2]) / K[0, 0], np.ones(len(z))] * z[:, None]
    a = 0.05
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    P = (X @ R.T + np.array([0.4, 0.05, 0.1])) @ K.T
    return (P[:, :2] / P[:, 2:]).astype(np.float32)


def test_fused_match_verify_with_fed_draws(matchers):
    """The fused match + RANSAC + pose step on pre-detected keypoints: real
    SuperPoint keypoints and descriptors, and a second view of each image
    whose keypoints moved under a rigid motion, fed the reference's RANSAC
    uniforms."""
    ref, port = matchers
    rng = np.random.default_rng(3)
    K = np.array([[200.0, 0, 64], [0, 200.0, 48], [0, 0, 1]])
    kp = jax.tree_util.tree_map(np.asarray, ref.sp.detect(jnp.asarray(_keypoints(rng, 2))))
    moved = [_second_view(c, K, rng) for c in kp.coords]
    kp = kp._replace(coords=np.stack([kp.coords[0], moved[0], kp.coords[1], moved[1]]),
                     **{f: np.repeat(getattr(kp, f), 2, axis=0)
                        for f in ("scores", "descriptors", "mask")})
    qi, mi = np.array([0, 2, 0]), np.array([1, 3, 3])
    key = jax.random.PRNGKey(7)
    want = ref.make_fused_match_verify(HW, K, num_hypotheses=128)(
        ref.params, jax.tree_util.tree_map(jnp.asarray, kp), jnp.asarray(qi), jnp.asarray(mi), key)
    u = jax.vmap(lambda kk: jax.random.uniform(kk, (128, 8)))(jax.random.split(key, 3))
    kp_t = Keypoints(*(torch.tensor(a) for a in kp))
    got = port.make_fused_match_verify(HW, K, num_hypotheses=128)(
        kp_t, torch.from_numpy(qi), torch.from_numpy(mi), uniforms=torch.tensor(np.asarray(u)))
    names = ["n_kp0", "n_kp1", "n_match", "n_inl", "ratio", "E", "T", "n_conf"]
    w, g = dict(zip(names, want)), dict(zip(names, got))
    for name in ("n_kp0", "n_kp1", "n_match", "n_conf"):
        np.testing.assert_array_equal(g[name].numpy(), np.asarray(w[name]))
    # pairs (0, 1) and (2, 3) are true two-view pairs: every match is an
    # inlier on both sides. Their correspondences are noise-free, so many
    # hypotheses explain them within 3 px and E itself is not pinned down
    # (E and the pose are held on noisy scenes in test_torch_epipolar.py).
    # Pair (0, 3) matches unrelated keypoints: no RANSAC parity is claimed.
    assert (g["n_match"].numpy()[:2] >= 60).all()
    np.testing.assert_array_equal(g["n_inl"].numpy()[:2], np.asarray(w["n_inl"])[:2])
    np.testing.assert_array_equal(g["n_inl"].numpy()[:2], g["n_match"].numpy()[:2])
    np.testing.assert_array_equal(g["ratio"].numpy()[:2], np.asarray(w["ratio"])[:2])
    for p in range(2):
        T = g["T"][p].numpy()
        np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3), atol=1e-5)
        assert abs(np.linalg.norm(T[:3, 3]) - 1.0) < 1e-5 and T[3, 3] == 1.0


def test_long_attention_goes_through_flash(monkeypatch):
    """A tiny matcher at 1100 x 1100 keypoints (above Kx*Ks = 1024^2): the
    port's attention goes through flash_mha (its plain version here), the
    reference's through XLA's dense attention on the CPU."""
    from mlis_tpu_torch.weights import from_jax_params

    ref = jlg.LightGlue(sp_cfg=JaxSPC.tiny_test(max_keypoints=64, dtype=jnp.float32),
                       matcher_cfg=jlg.MatcherConfig.tiny_test(dtype=jnp.float32))
    K, hw = 1100, (540, 720)
    ref._init(K, K, hw)  # the reference initialises its parameters lazily
    net = tlg.MatcherNet(tlg.MatcherConfig.tiny_test(dtype=torch.float32))
    net.load_state_dict(from_jax_params(jax.device_get(ref.params)), strict=True)
    rng = np.random.default_rng(4)
    d0, d1 = (rng.normal(size=(2, K, 32)).astype(np.float32) for _ in range(2))
    d1[:, :200] = d0[:, :200] + 0.05 * rng.normal(size=(2, 200, 32)).astype(np.float32)
    c0 = rng.uniform(0, 540, size=(2, K, 2)).astype(np.float32)
    c1 = c0 + rng.normal(size=c0.shape).astype(np.float32)
    m0 = np.ones((2, K), bool)
    m1 = np.arange(K)[None] < np.array([[K], [1030]])  # prefix-valid, as top-k gives
    calls = []
    real = tlg.flash_mha

    def spy(*a, **kw):
        calls.append(tuple(a[0].shape))
        return real(*a, **kw)

    monkeypatch.setattr(tlg, "flash_mha", spy)
    args = (d0, c0, m0, d1, c1, m1)
    want = np.asarray(ref.net.apply(ref.params, *(jnp.asarray(a) for a in args), hw))
    with torch.no_grad():
        got = net(*(torch.from_numpy(a) for a in args), hw)
    assert calls == [(4, K, 2, 16)] * 4  # self + cross attention in each of 2 blocks
    # float32; softmax sums over 1100 keys in another order than XLA's dense
    # attention, then two more softmaxes in the head: 6e-6 relative measured
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)
    wm = jlg.extract_matches(jnp.asarray(want), jnp.asarray(m0), jnp.asarray(m1), 0.1)
    gm = tlg.extract_matches(got, torch.from_numpy(m0), torch.from_numpy(m1), 0.1)
    np.testing.assert_array_equal(gm.idx0.numpy(), np.asarray(wm.idx0))
    np.testing.assert_array_equal(gm.valid.numpy(), np.asarray(wm.valid))
    np.testing.assert_allclose(gm.scores.numpy(), np.asarray(wm.scores), rtol=2e-5, atol=2e-6)
    assert gm.valid.sum() > 50


def test_fullres_checkpoint_at_540x720():
    """The fullres matcher (lightglue_homog_sp_fullres.npz) through
    from_checkpoint, against the reference loaded at image_hw=(540, 720)."""
    from mlis_tpu.models.weights import default_fullres_matcher_checkpoint as jax_default

    from mlis_tpu_torch.weights import default_fullres_matcher_checkpoint

    path = default_fullres_matcher_checkpoint()
    assert path is not None and path.endswith(jax_default().split("/")[-1])
    hw = (540, 720)
    ref = jlg.LightGlue(sp_cfg=JaxSPC(max_keypoints=96, dtype=jnp.float32),
                       matcher_cfg=jlg.MatcherConfig(dtype=jnp.float32, **matcher_arch_from_npz(path)))
    ref.load_weights(path, image_hw=hw)
    port = tlg.LightGlue.from_checkpoint(path, sp_cfg=SuperPointConfig(max_keypoints=96, dtype=torch.float32),
                                         dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(5)
    d = rng.normal(size=(1, 96, 256)).astype(np.float32)
    c = rng.uniform(0, 540, size=(1, 96, 2)).astype(np.float32)
    m = np.ones((1, 96), bool)
    args = (d, c, m, d + 0.1 * rng.normal(size=d.shape).astype(np.float32), c + 2.0, m)
    want = np.asarray(ref.net.apply(ref.params, *(jnp.asarray(a) for a in args), hw))
    with torch.no_grad():
        got = port.net(*(torch.from_numpy(a) for a in args), hw).numpy()
    # float32 through 9 layers of attention, as in the half-res test above;
    # these near-duplicate views give sharper softmaxes (1.1e-4 relative on
    # one of 9216 scores measured)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def _official_pair():
    """The JAX and the port LightGlue at tiny widths in float32, each with
    the same official cvg/LightGlue and magicleap SuperPoint state dicts
    (drawn from ``np.random.default_rng(5)``, Kaiming-scaled) loaded through
    ``load_torch_state_dict``; the JAX templates come from ``eval_shape``."""
    from test_torch_convert import _shape_template, fake_lightglue_sd, fake_superpoint_sd

    rng = np.random.default_rng(5)
    sp_sd = fake_superpoint_sd(rng, (8, 8, 16, 16), 32)
    m_sd = fake_lightglue_sd(rng, 32, 32, 2, 2)
    ref = jlg.LightGlue(sp_cfg=JaxSPC.tiny_test(max_keypoints=64, dtype=jnp.float32),
                       matcher_cfg=jlg.MatcherConfig.tiny_test(dtype=jnp.float32,
                                                                 match_threshold=1e-5))
    ref.sp.params = {"params": _shape_template(ref.sp.net, jnp.zeros((1, *HW, 1)))}
    d, c, m = jnp.zeros((1, 64, 32)), jnp.zeros((1, 64, 2)), jnp.ones((1, 64), bool)
    ref.params = {"params": _shape_template(ref.net, d, c, m, d, c, m, HW)}
    port = tlg.LightGlue(sp_cfg=SuperPointConfig.tiny_test(max_keypoints=64, dtype=torch.float32),
                         matcher_cfg=tlg.MatcherConfig.tiny_test(dtype=torch.float32,
                                                                  match_threshold=1e-5),
                         device="cpu")
    return ref, port, m_sd, sp_sd


def test_load_torch_state_dict_matches_jax():
    """Official matcher and SuperPoint dicts into both packages (a match
    threshold of 1e-5, at which random weights give matches): the same
    keypoints, match indices and validity, scores within 2e-5 (float32
    attention summed in another order); the cross block's shared to_qk is
    both q and k, Wqkv's thirds are q, k and v."""
    ref, port, m_sd, sp_sd = _official_pair()
    ref.load_torch_state_dict(m_sd, sp_sd, image_hw=HW)
    port.load_torch_state_dict(m_sd, sp_sd)
    blk = port.net.blocks[1]
    assert torch.equal(blk["cross"].q.weight, blk["cross"].k.weight)
    assert torch.equal(blk["cross"].q.weight,
                       torch.from_numpy(m_sd["transformers.1.cross_attn.to_qk.weight"]))
    assert torch.equal(blk["self"].v.weight,
                       torch.from_numpy(m_sd["transformers.1.self_attn.Wqkv.weight"][64:]))
    assert torch.equal(port.sp.net.conv2_1.weight, torch.from_numpy(sp_sd["conv2b.weight"]))
    imgs = _keypoints(np.random.default_rng(6))
    j0, j1, jm = ref.match_batch(jnp.asarray(imgs[:2]), jnp.asarray(imgs[2:]))
    t0, t1, tm = port.match_batch(torch.from_numpy(imgs[:2]), torch.from_numpy(imgs[2:]))
    for a, b in ((t0, j0), (t1, j1)):
        np.testing.assert_array_equal(a.coords.numpy(), np.asarray(b.coords))
        np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))
    np.testing.assert_array_equal(tm.idx0.numpy(), np.asarray(jm.idx0))
    np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))
    np.testing.assert_allclose(tm.scores.numpy(), np.asarray(jm.scores), atol=2e-5)
    assert tm.valid.sum() > 0


def test_save_weights_round_trip_across_packages(tmp_path):
    """Port save_weights -> JAX load_weights and JAX save_weights -> port
    load_weights: the matcher (blocks restacked along the depth axis) and
    SuperPoint trees equal, float16 as stored; ``from_checkpoint`` reads
    the structure back from the port's file."""
    from mlis_tpu.models.weights import load_params_npz as jax_load_params
    from mlis_tpu_torch.weights import flatten_params, load_params_npz, to_jax_params

    ref, port, m_sd, sp_sd = _official_pair()
    port.load_torch_state_dict(m_sd, sp_sd)
    mine = str(tmp_path / "port.npz")
    port.save_weights(mine)
    saved = load_params_npz(mine)
    assert saved["matcher"]["blocks"]["self"]["q"]["kernel"].shape == (2, 32, 32)
    ref.load_weights(mine, image_hw=HW)
    for name, tree in (("matcher", ref.params["params"]), ("superpoint", ref.sp.params["params"])):
        got, want = flatten_params(jax.device_get(tree)), flatten_params(saved[name])
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(np.asarray(got[k]), v), (name, k)
    theirs = str(tmp_path / "jax.npz")
    ref.save_weights(theirs)
    back = tlg.LightGlue.from_checkpoint(theirs, sp_cfg=SuperPointConfig.tiny_test(
        max_keypoints=64, dtype=torch.float32), dtype=torch.float32, device="cpu")
    want = jax_load_params(theirs)
    for name, state in (("matcher", to_jax_params(back.net.state_dict(), scan_prefixes=("blocks",))),
                        ("superpoint", to_jax_params(back.sp.net.state_dict()))):
        w = flatten_params(want[name])
        assert sorted(flatten_params(state)) == sorted(w)
        for k, v in flatten_params(state).items():
            assert np.array_equal(v, np.asarray(w[k])), (name, k)
    assert back.cfg.depth == 2 and back.cfg.dim == 32
