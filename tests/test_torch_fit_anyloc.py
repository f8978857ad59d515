"""The port's fit_anyloc (mlis_tpu_torch/train/pretrain_vpr.py) against
mlis_tpu's on the CPU: the JAX package's feature batches (its draws from
PRNGKey(2,000,000)), its ``jax.random.choice(replace=False)`` initial
indices and its held-out views fed to the port, both sides' tiny ViT
built in float32 (the builders patched; the weights are vpr_tiny_v2.npz on
both): the held-out recall@1 equal, the vocabulary within 1e-3 (25 Lloyd
steps over float32 features a few ulps apart), the npz's keys, shapes and
dtypes equal.
"""

import argparse

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from mlis_tpu.train import pretrain_vpr as jpv  # noqa: E402
from test_torch_pretrain_vpr import (  # noqa: E402
    HW,
    P,
    V,
    jax_f32_build,
    jax_parallax_draws,
    port_f32_build,
)

from mlis_tpu_torch.train import pretrain_vpr as tpv  # noqa: E402


def test_fit_anyloc_on_jax_draws_and_choice(tmp_path, monkeypatch):
    monkeypatch.setattr(jpv, "_build_model", jax_f32_build)
    monkeypatch.setattr(tpv, "_build_model", port_f32_build)
    kw = dict(steps=8, places=P, views=V, height=HW[0], width=HW[1], corner_jitter=0.08,
              brightness=0.08, seed=0, clusters=16, init_from=None, arch="anyloc",
              parallax=True, tiny=False)
    want = jpv.fit_anyloc(argparse.Namespace(out=str(tmp_path / "j.npz"), **kw))
    key = jax.random.PRNGKey(2_000_000)
    draws = []
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws.append(jax_parallax_draws(sub, P, V, HW))
    n_feats = 2 * P * V * (jpv.ENC_HW[0] // 8) * (jpv.ENC_HW[1] // 8)
    idx = np.asarray(jax.random.choice(jax.random.PRNGKey(0), n_feats, (16,), replace=False))
    got = tpv.fit_anyloc(argparse.Namespace(out=str(tmp_path / "t.npz"), device="cpu", **kw),
                         sample_draws=draws, init_indices=idx,
                         heldout_draws=jax_parallax_draws(jax.random.PRNGKey(77_000), 32, 2, HW))
    assert got["best_recall_at_1"] == want["best_recall_at_1"]
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert set(j.files) == set(t.files)
        np.testing.assert_allclose(t["vlad:centers"].astype(np.float32),
                                   j["vlad:centers"].astype(np.float32), rtol=0, atol=1e-3)
        for k in j.files:
            assert j[k].shape == t[k].shape and j[k].dtype == t[k].dtype, k
