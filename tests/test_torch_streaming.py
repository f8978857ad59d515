"""The port's StreamingGate held against mlis_tpu's on the CPU, on the
``stream`` CLI's demo (256 frames, D 128, micro-batches of 16, planted
revisits and cross-floor traps) and on the cases of
tests/test_streaming_gate.py.

Decisions (accepted pairs, per-batch rejections, stats) are exactly
equal; scores within 1e-6 (float32 sums of exact bf16 products in
another order)."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mlis_tpu.gating.streaming import StreamingGate as JaxGate  # noqa: E402

from mlis_tpu_torch.gating.streaming import StreamingGate, measure_compute_rate  # noqa: E402


def stream_demo(n=256, D=128, seed=0):
    """The ``stream`` CLI's keyframes (mlis_tpu/cli.py, _cmd_stream): every
    8th frame from 24 on revisits the frame 20 back; every 16th of those
    lands on another floor (a trap)."""
    rng = np.random.default_rng(seed)
    desc = rng.normal(size=(n, D)).astype(np.float32)
    floors = rng.integers(1, 6, size=n).astype(np.int32)
    revisits, traps = [], []
    for q in range(24, n, 8):
        m = q - 20
        desc[q] = desc[m] + 0.01 * rng.normal(size=D).astype(np.float32)
        if q % 16 == 0:
            floors[q] = floors[m] % 5 + 1 if floors[m] != 5 else 2
            traps.append((q, m))
        else:
            floors[q] = floors[m]
            revisits.append((q, m))
    return desc, np.arange(n, dtype=np.float32) * 2.0, floors, revisits, traps


def _run(gate, x, times, floors, batch):
    outs = [gate.add_keyframes(x[s : s + batch], times[s : s + batch], floors[s : s + batch])
            for s in range(0, len(x), batch)]
    return outs


def _assert_same(outs, ref_outs):
    for a, b in zip(outs, ref_outs):
        np.testing.assert_array_equal(a.query_ids, b.query_ids)
        np.testing.assert_array_equal(a.match_ids, np.asarray(b.match_ids))
        np.testing.assert_allclose(a.scores, np.asarray(b.scores), atol=1e-6)
        assert a.cross_floor_rejected == b.cross_floor_rejected
        assert [p[:2] for p in a.pairs()] == [p[:2] for p in b.pairs()]


@pytest.mark.parametrize("capacity", [4096, 64])
def test_stream_demo_matches_jax(capacity):
    desc, times, floors, revisits, traps = stream_demo()
    kw = dict(capacity=capacity, top_k=5, similarity_threshold=0.9, min_time_gap=10.0)
    port, ref = StreamingGate(device="cpu", **kw), JaxGate(**kw)
    outs = _run(port, desc, times, floors, 16)
    _assert_same(outs, _run(ref, desc, times, floors, 16))
    assert port.stats == ref.stats
    pairs = {p[:2] for o in outs for p in o.pairs()}
    assert set(revisits) <= pairs and not set(traps) & pairs
    assert port.stats["rejected_cross_floor"] >= len(traps)
    assert port.stats["evicted"] == max(0, len(desc) - capacity)
    assert isinstance(port.state.desc, torch.Tensor) and int(port.state.count) == len(desc)


def test_eviction_forgets_the_oldest_frames():
    """With room for 16 frames a revisit 20 frames back is gone; with 32 it
    is found."""
    desc, times, floors, revisits, _ = stream_demo(n=64)
    for capacity, found in ((16, False), (32, True)):
        kw = dict(capacity=capacity, top_k=5, similarity_threshold=0.9, min_time_gap=10.0)
        port, ref = StreamingGate(device="cpu", **kw), JaxGate(**kw)
        outs = _run(port, desc, times, floors, 8)
        _assert_same(outs, _run(ref, desc, times, floors, 8))
        pairs = {p[:2] for o in outs for p in o.pairs()}
        assert (set(revisits) <= pairs) is found and bool(pairs) is found
        assert port.stats == ref.stats and port.stats["evicted"] == 64 - capacity


def test_gated_candidate_consumes_its_topk_slot():
    """top_k 1: a higher-scoring cross-floor candidate takes the one slot
    and is gated; it does not cede the slot to the same-floor one."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=8).astype(np.float32)
    q /= np.linalg.norm(q)
    perp = rng.normal(size=8).astype(np.float32)
    perp -= q * (perp @ q)
    perp /= np.linalg.norm(perp)
    a = 0.90 * q + np.sqrt(1 - 0.90**2) * perp  # same floor, sim 0.90
    b = 0.95 * q + np.sqrt(1 - 0.95**2) * perp  # cross floor, sim 0.95
    desc, floors = np.stack([a, b, q]), np.array([2, 3, 2])
    times = np.array([0.0, 20.0, 40.0], np.float32)
    kw = dict(capacity=8, top_k=1, similarity_threshold=0.5, min_time_gap=10.0)
    port, ref = StreamingGate(device="cpu", **kw), JaxGate(**kw)
    out, ref_out = port.add_keyframes(desc, times, floors), ref.add_keyframes(desc, times, floors)
    _assert_same([out], [ref_out])
    assert out.pairs() == [] and out.cross_floor_rejected == 2
    loose = StreamingGate(device="cpu", strict_floor=False, **kw)
    ref_loose = JaxGate(strict_floor=False, **kw)
    _assert_same([loose.add_keyframes(desc, times, floors)],
                 [ref_loose.add_keyframes(desc, times, floors)])


def test_within_batch_retrieval_and_dim_mismatch():
    d = np.eye(4, 8, dtype=np.float32) + 1.0
    d[3] = d[0]  # frame 3 repeats frame 0 of the same call, 18 s later
    kw = dict(capacity=16, top_k=4, similarity_threshold=0.9, min_time_gap=10.0)
    port, ref = StreamingGate(device="cpu", **kw), JaxGate(**kw)
    out = port.add_keyframes(d, np.arange(4) * 6.0, np.full(4, 2))
    _assert_same([out], [ref.add_keyframes(d, np.arange(4) * 6.0, np.full(4, 2))])
    assert (3, 0) in {p[:2] for p in out.pairs()}
    for gate in (port, ref):
        with pytest.raises(ValueError, match="dim mismatch"):
            gate.add_keyframes(np.ones((2, 16), np.float32), np.zeros(2), np.zeros(2))
    fixed = StreamingGate(descriptor_dim=12, device="cpu")
    with pytest.raises(ValueError, match="dim mismatch"):
        fixed.add_keyframes(np.ones((2, 8), np.float32), np.zeros(2), np.zeros(2))
    with pytest.raises(ValueError, match="no encoder"):
        StreamingGate(device="cpu").add_keyframes(np.ones((2, 8, 8), np.uint8),
                                                  np.zeros(2), np.zeros(2))


def test_attached_encoder_matches_jax():
    """An encoder on each side (8x8 mean pooling of the grey image), fed
    uint8 keyframes: the images of the stream demo's places."""
    rng = np.random.default_rng(1)
    places = rng.integers(0, 255, (12, 32, 48), dtype=np.uint8)
    order = np.concatenate([np.arange(12), np.arange(12)[::-1], np.arange(12)])
    images = places[order] + rng.integers(0, 3, (36, 32, 48)).astype(np.uint8)
    floors = np.where(order % 3 == 0, 2, 4).astype(np.int32)
    floors[30] = 1  # a trap
    times = np.arange(36, dtype=np.float32) * 5.0

    def torch_encoder(x):
        return x.to(torch.float32).reshape(x.shape[0], 4, 8, 6, 8).mean((2, 4)).reshape(
            x.shape[0], -1) - 128.0

    def jax_encoder(x):
        import jax.numpy as jnp

        return x.astype(jnp.float32).reshape(x.shape[0], 4, 8, 6, 8).mean((2, 4)).reshape(
            x.shape[0], -1) - 128.0

    kw = dict(capacity=64, top_k=3, similarity_threshold=0.95, min_time_gap=30.0)
    port = StreamingGate(encoder=torch_encoder, device="cpu", **kw)
    ref = JaxGate(encoder=jax_encoder, **kw)
    outs = _run(port, images, times, floors, 8)
    _assert_same(outs, _run(ref, images, times, floors, 8))
    assert port.stats == ref.stats and port.stats["accepted_candidates"] > 0
    assert port.stats["rejected_cross_floor"] > 0 and port.dim == 24


def test_measure_compute_rate_runs():
    r = measure_compute_rate(capacity=64, dim=32, n_frames=96, reps=1, device="cpu")
    assert set(r) == {"keyframes_per_s", "ms_per_keyframe", "elapsed_s"}
    assert r["keyframes_per_s"] > 0 and r["elapsed_s"] > 0
