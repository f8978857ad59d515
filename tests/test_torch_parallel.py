"""The port's parallel package and VPR trainer in a 4-rank gloo world on the
CPU, held against mlis_tpu on 4 of its 8 virtual CPU devices: the mesh
and its errors, the placement table (trap: flax kernels are (in, out),
torch weights (out, in)), tensor parallelism of the ViT on a 2 x 2 mesh,
both sharded top-k paths, NT-Xent and its gradient, the trainer's AdamW
steps against optax.adamw's, the 2 x 2 trainer step against the one-rank
step on the global batch, and the npz checkpoint round trip.

One world serves the whole file (tests/test_torch_parallel_ranks.py). The
inputs are made from seeds with numpy; the ViT's parameters are the JAX
package's, carried across by ``weights.carry_jax_vit``. Bands:

* the TP forward: float32, the row-parallel layers sum their two partial
  products in another order, 1e-5 against the port's one-rank forward and
  2e-5 against the JAX package's (test_torch_vit.py's band);
* NT-Xent: 1e-6 relative; its gradient (entries up to 0.6) within 1e-6,
  float32 sums in another order (measured 1.7e-7);
* two trainer steps against optax.adamw's from the same weights: the
  losses within 1e-5 relative, the parameters within 1e-5 relative (norm
  over all of them; measured 6.6e-6 over 4 data ranks). Entry by entry only
  Adam's own bound of 2 lr a step holds: where a gradient is zero in
  exact arithmetic (the key third of every qkv bias: softmax ignores a
  shift of every key) or tiny, float32 leaves noise of ~1e-8 that Adam's
  normalisation turns into a step of either sign (measured 1.06 lr apart
  after two steps);
* the 2 x 2 step against the one-rank step: the same band.

The top-k checks are exact: the descriptors are {-1, 0, 1} vectors, whose
bf16-rounded cosine sums are exact in any order, so scores tie exactly
wherever they tie mathematically; masked rows tie at -inf.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from mlis_tpu.models.vit import ViT as JaxViT, ViTConfig as JaxViTConfig  # noqa: E402
from mlis_tpu.ops.pooling import gem_pool as jax_gem  # noqa: E402
from mlis_tpu.parallel import distributed_knn as jknn  # noqa: E402
from mlis_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from mlis_tpu.parallel.mesh import param_shardings as jax_param_shardings  # noqa: E402
from mlis_tpu.train.trainer import make_train_step as jax_train_step  # noqa: E402
from mlis_tpu.train.trainer import nt_xent_loss as jax_nt_xent  # noqa: E402
from test_torch_parallel_ranks import World  # noqa: E402
import test_torch_parallel_ranks as ranks  # noqa: E402

from mlis_tpu_torch.ops.knn import cosine_topk  # noqa: E402
from mlis_tpu_torch.train.trainer import GeMEncoder, make_train_step, nt_xent_loss  # noqa: E402
from mlis_tpu_torch.weights import carry_jax_vit, flatten_params, from_jax_params  # noqa: E402

VIT = dict(dim=64, depth=2, num_heads=2, pos_grid=8, layerscale_init=0.5)
LR, WD = 1e-4, 1e-4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, str(tmp_path_factory.mktemp("gloo")))
    yield w
    w.close()


@pytest.fixture(scope="module")
def vit_case():
    """The JAX ViT, its parameters (numpy), the port's state and 8 images."""
    rng = np.random.default_rng(0)
    images = rng.normal(size=(8, 28, 28, 3)).astype(np.float32)
    model = JaxViT(JaxViTConfig(dtype=jnp.float32, **VIT), use_pallas=False)
    params = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.asarray(images[:1])))
    state = {k: v.numpy() for k, v in from_jax_params(params, scan_prefixes=()).items()}
    return model, params, state, images


def _jax_apply(model):
    def apply_fn(p, x):
        d = jax_gem(model.apply(p, x)["patches"], p=3.0)
        return d / (jnp.linalg.norm(d, axis=-1, keepdims=True) + 1e-8)

    return apply_fn


def _port_encoder(params):
    from mlis_tpu_torch.models.vit import ViT, ViTConfig

    return carry_jax_vit(GeMEncoder(ViT(ViTConfig(dtype=torch.float32, **VIT), use_kernel=False)),
                         params)


def test_mesh_shapes_and_errors(world):
    shapes = [(4, 1), (2, 2), (-1, 1), (-1, 2), (3, 2), (1, 3)]
    batch = {"x": np.arange(16.0).reshape(8, 2), "ids": [np.arange(8), np.arange(8) * 2]}
    got = world.run(ranks.mesh_checks, shapes, batch)
    assert all(g[0] == got[0][0] for g in got)
    for meshes, placements, slab, d in got:
        # jax's batch_sharding is P("data"): the leading axis over data,
        # replicated over model; each rank holds its data rank's quarter
        assert placements == ("(Shard(dim=0), Replicate())", "(Replicate(), Replicate())")
        np.testing.assert_array_equal(slab["x"], batch["x"][4 * d:4 * d + 4])
        np.testing.assert_array_equal(slab["ids"][1], batch["ids"][1][4 * d:4 * d + 4])
    assert sorted(g[3] for g in got) == [0, 0, 1, 1]
    for (nd, nm), g in zip(shapes, got[0][0]):
        try:
            m = jax_mesh(nd, nm, devices=jax.devices()[:4])
            assert g == (m.shape["data"], m.shape["model"], ("data", "model"))
        except ValueError as e:
            assert g == f"ValueError: {e}"


def test_init_process_group_needs_a_store_for_many_ranks():
    from mlis_tpu_torch.parallel.mesh import init_process_group

    with pytest.raises(ValueError, match="4 ranks needs a store_dir"):
        init_process_group(None, 0, 4, "cpu")


@pytest.fixture(scope="module")
def tp_runs(world, vit_case):
    _, _, state, images = vit_case
    return {shape: world.run(ranks.tp_forward, {k: v for k, v in VIT.items()}, state, images,
                             shape) for shape in ((2, 2), (4, 1))}


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_placements_transpose_the_reference_specs(vit_case, tp_runs, shape):
    """Column-parallel P(None, "model") is Shard(0) of the torch weight,
    row-parallel P("model", None) Shard(1), the rest replicated; each rank
    holds its shard."""
    _, params, state, _ = vit_case
    specs = jax_param_shardings(jax_mesh(*shape, devices=jax.devices()[:4]), params)
    specs = flatten_params(jax.tree_util.tree_map(lambda s: repr(tuple(s.spec)), specs,
                                                  is_leaf=lambda x: hasattr(x, "spec")))
    _, table, shapes = tp_runs[shape][0]
    want_shards = {"(None, 'model')": "Shard(dim=0)", "('model', None)": "Shard(dim=1)"}
    seen = set()
    for flax_key, spec in specs.items():
        name = _port_name(flax_key)
        want = want_shards.get(str(spec), "Replicate()")
        assert table[name] == ("Replicate()", want), (name, spec)
        seen.add(want)
        n_model = shape[1]
        local = list(state[name].shape)
        if want != "Replicate()" and n_model > 1:
            local[int(want[-2])] //= n_model
        assert shapes[name] == tuple(local), name
    assert seen == {"Replicate()", "Shard(dim=0)", "Shard(dim=1)"}
    assert table["block0.attn.qkv.bias"] == ("Replicate()", "Replicate()")


def _port_name(flax_key: str) -> str:
    """The port's parameter name of a flax path ('params/block0/attn/qkv/kernel')."""
    parts = flax_key.split("/")[1:]
    leaf = {"kernel": "weight", "scale": "weight"}.get(parts[-1], parts[-1])
    return ".".join(parts[:-1] + [leaf])


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_sharded_forward_matches_single_device(vit_case, tp_runs, shape):
    model, params, _, images = vit_case
    want = np.asarray(model.apply(params, jnp.asarray(images))["cls"])
    port = _port_encoder(params).vit
    with torch.no_grad():
        single = port(torch.from_numpy(images))["cls"].numpy()
    for cls, _, _ in tp_runs[shape]:  # every rank returns the whole batch
        np.testing.assert_allclose(cls, single, rtol=0, atol=1e-5)
        np.testing.assert_allclose(cls, want, rtol=0, atol=2e-5)
    assert np.abs(single - want).max() < 2e-5


def _signs(rng, n, d):
    return rng.integers(-1, 2, size=(n, d)).astype(np.float32)


def test_topk_paths_match_jax_with_ties(world):
    rng = np.random.default_rng(1)
    db = _signs(rng, 64, 16)
    db[32:48] = db[:16]  # duplicated descriptors tie exactly
    db[db.sum(1) == 0] += 1.0  # no all-zero rows
    q = np.concatenate([db[:8], _signs(rng, 8, 16) + (rng.random((8, 16)) < 0.05)])
    qt = (np.arange(16) * 3.0).astype(np.float32)
    dbt = (np.arange(64) * 0.5).astype(np.float32)
    k, gap = 10, 28.0  # some queries keep fewer than k entries: -inf ties
    got = world.run(ranks.topk_runs, q, db, qt, dbt, k, gap)
    jm = jax_mesh(4, 1, devices=jax.devices()[:4])
    want = []
    for fn in (jknn.query_sharded_topk, jknn.db_sharded_topk):
        for times in ((qt, dbt), (None, None)):
            s, i = fn(jm, jnp.asarray(q), jnp.asarray(db),
                      *(None if t is None else jnp.asarray(t) for t in times), k=k,
                      min_time_gap=gap)
            want.append((np.asarray(s), np.asarray(i)))
    single = [tuple(x.numpy() for x in cosine_topk(torch.from_numpy(q), torch.from_numpy(db),
                                                      *t, k=k, min_time_gap=gap))
              for t in ((torch.from_numpy(qt), torch.from_numpy(dbt)), (None, None))]
    for r in got:
        for (s, i), (ws, wi), (ss, si) in zip(r, want, single + single):
            np.testing.assert_array_equal(i, wi)
            np.testing.assert_array_equal(s, ws)
            np.testing.assert_array_equal(i, si)
            np.testing.assert_array_equal(s, ss)
    s, i = want[0]
    assert np.isneginf(s).any() and np.isfinite(s).any()  # masked ties at -inf
    assert (np.diff(s, axis=1)[:, :3] == 0).any()  # finite ties


def test_nt_xent_loss_and_gradient_match_jax():
    rng = np.random.default_rng(2)
    d = rng.normal(size=(8, 16)).astype(np.float32)
    for ids in ([0, 0, 1, 1, 2, 2, 3, 3], [0, 1, 2, 3, 4, 5, 6, 7], [0, 0, 0, 1, 2, 2, 3, 4]):
        ids = np.asarray(ids)
        want, wgrad = jax.value_and_grad(jax_nt_xent)(jnp.asarray(d), jnp.asarray(ids))
        x = torch.from_numpy(d).requires_grad_(True)
        loss = nt_xent_loss(x, torch.from_numpy(ids))
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(wgrad), rtol=0, atol=1e-6)
    # identical positives -> lower loss than random positives
    ids = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3])
    base = float(nt_xent_loss(torch.from_numpy(d), ids))
    d2 = torch.from_numpy(np.concatenate([d[:4], d[:4]]))
    assert float(nt_xent_loss(d2, torch.tensor([0, 1, 2, 3, 0, 1, 2, 3]))) < base


def _hold_adam_band(got: dict, want: dict, steps: int) -> None:
    """AdamW's steps from the same weights (module docstring): all the
    parameters within 1e-5 relative (norm over their concatenation), and
    no entry further than Adam's own bound of 2 lr a step."""
    a = np.concatenate([got[k].ravel() for k in want])
    b = np.concatenate([want[k].ravel() for k in want])
    rel = np.linalg.norm(a - b) / np.linalg.norm(b)
    print(f"parameters {rel:.3g} relative, largest entry {np.abs(a - b).max() / LR:.3g} lr apart")
    assert rel < 1e-5
    assert np.abs(a - b).max() <= 2 * LR * steps


def test_trainer_steps_match_optax_adamw(world, vit_case):
    model, params, state, images = vit_case
    ids = np.arange(8) // 2
    opt = optax.adamw(LR, weight_decay=WD)
    step = jax.jit(jax_train_step(_jax_apply(model), opt))
    p, o, want_losses = params, opt.init(params), []
    for _ in range(2):
        p, o, loss = step(p, o, jnp.asarray(images), jnp.asarray(ids, jnp.int32))
        want_losses.append(float(loss))
    want = {f"vit.{k}": v.numpy() for k, v in from_jax_params(jax.device_get(p),
                                                              scan_prefixes=()).items()}
    for losses, after, unchanged, _ in world.run(ranks.trainer_run, VIT, state, images, ids,
                                                 (4, 1), 2, LR, WD):
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        _hold_adam_band(after, want, 2)
        assert unchanged


def test_tp_trainer_step_is_the_global_batch_step(world, vit_case, tmp_path):
    """A 2 x 2 (data x model) step equals the one-rank step on the whole
    batch (NT-Xent couples the batch: a per-rank loss would optimise another
    function); the npz checkpoint round trip is exact."""
    _, params, state, images = vit_case
    ids = np.arange(8) // 2
    enc = _port_encoder(params)
    opt = torch.optim.AdamW(enc.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=WD)
    loss = make_train_step(enc, opt)(torch.from_numpy(images), torch.from_numpy(ids))
    want = {k: v.detach().numpy() for k, v in enc.state_dict().items()}
    ckpt = str(tmp_path / "trainer.npz")
    for losses, after, unchanged, round_trip in world.run(
            ranks.trainer_run, VIT, state, images, ids, (2, 2), 1, LR, WD, ckpt):
        np.testing.assert_allclose(losses[0], float(loss), rtol=1e-5)
        _hold_adam_band(after, want, 1)
        assert unchanged and round_trip
    with np.load(ckpt) as z:
        assert int(z["step"]) == 1
        assert z["params:vit/block0/attn/qkv/kernel"].shape == (64, 192)
        assert z["params:vit/block0/attn/qkv/kernel"].dtype == np.float32
