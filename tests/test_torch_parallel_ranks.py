"""Rank functions and the gloo world for the port's multi-rank tests
(test_torch_parallel.py, test_torch_sharded_gate.py,
test_torch_vpr_finetune.py). No tests live here.

A :class:`World` spawns ``n`` CPU ranks (the ``spawn`` start method: the
test process holds JAX, which makes ``fork`` unsafe), starts one gloo
process group over a ``FileStore`` under a given directory (no TCP port
that parallel test workers could collide on) and runs functions of this
module on every rank, returning each rank's numpy results. This module
imports only torch, numpy and the port, so a spawned rank never imports
JAX or ``mlis_tpu``.
"""

from __future__ import annotations

import datetime
import queue
import traceback
from typing import Any, Callable, List

import numpy as np
import torch

COLLECTIVE_TIMEOUT_S = 120  # a rank stuck in a collective raises after this


def _rank_main(rank: int, world: int, store_dir: str, tasks, results) -> None:
    import torch.distributed as dist

    from mlis_tpu_torch.parallel.mesh import init_process_group

    torch.set_num_threads(1)
    init_process_group(store_dir, rank, world, "cpu",
                       timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args = task
        try:
            results.put((rank, True, fn(*args)))
        except Exception:  # noqa: BLE001 - the traceback goes to the test
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class World:
    """``n`` spawned gloo ranks that run functions on request."""

    def __init__(self, n: int, store_dir: str):
        ctx = torch.multiprocessing.get_context("spawn")
        self.n = n
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(n)]
        self.procs = [ctx.Process(target=_rank_main, args=(r, n, store_dir, self.tasks[r],
                                                          self.results), daemon=True)
                      for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, fn: Callable, *args: Any, timeout: float = 300.0) -> List[Any]:
        """fn(*args) on every rank; the list of results in rank order. A
        rank's exception is raised here with its traceback."""
        for q in self.tasks:
            q.put((fn, args))
        out: List[Any] = [None] * self.n
        errors = []
        for _ in range(self.n):
            try:
                rank, ok, value = self.results.get(timeout=timeout)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"{fn.__name__}: a rank gave no result in {timeout} s")
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError(f"{fn.__name__} failed\n" + "\n".join(errors))
        return out

    def close(self) -> None:
        for q, p in zip(self.tasks, self.procs):
            if p.is_alive():
                q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()


# -- rank functions: run on every rank, return numpy ------------------------------


def mesh_checks(shapes, batch):
    """make_mesh's axis sizes for each (n_data, n_model) in ``shapes``, or
    the ValueError's text; then, on a (2, 2) mesh, the batch placements and
    this rank's ``shard_batch`` slab of ``batch`` with its data rank."""
    from mlis_tpu_torch.parallel.mesh import (
        batch_sharding,
        make_mesh,
        replicated,
        shard_batch,
    )

    out = []
    for nd, nm in shapes:
        try:
            mesh = make_mesh(nd, nm, device_type="cpu")
            out.append((mesh.size(0), mesh.size(1), mesh.mesh_dim_names))
        except ValueError as e:
            out.append(f"ValueError: {e}")
    mesh = make_mesh(2, 2, device_type="cpu")
    placements = (repr(batch_sharding(mesh)), repr(replicated(mesh)))
    return out, placements, shard_batch(mesh, batch), mesh.get_local_rank("data")


def _gather_data(mesh, x: torch.Tensor) -> torch.Tensor:
    """Rows of every data rank, in rank order."""
    import torch.distributed as dist

    group = mesh.get_group("data")
    out = x.new_empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def topk_runs(q, db, qt, dbt, k, gap):
    """query_sharded_topk and db_sharded_topk on a (4, 1) mesh, with and
    without times: [(scores, indices), ...] in that order."""
    from mlis_tpu_torch.parallel.distributed_knn import db_sharded_topk, query_sharded_topk
    from mlis_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(-1, 1, device_type="cpu")
    q, db, qt, dbt = (torch.from_numpy(a) for a in (q, db, qt, dbt))
    out = []
    for fn in (query_sharded_topk, db_sharded_topk):
        for times in ((qt, dbt), (None, None)):
            s, i = fn(mesh, q, db, *times, k=k, min_time_gap=gap)
            out.append((s.numpy(), i.numpy()))
    return out


def vit_from_state(cfg_kw: dict, state: dict):
    from mlis_tpu_torch.models.vit import ViT, ViTConfig

    vit = ViT(ViTConfig(dtype=torch.float32, **cfg_kw), use_kernel=False)
    vit.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return vit


def tp_forward(cfg_kw, state, images, mesh_shape):
    """The ViT's cls tokens under tensor parallelism on a ``mesh_shape``
    mesh (each data rank encodes its slab; rows gathered), the placement
    table of the whole-size ViT, and each rank's local parameter shapes."""
    import copy

    from mlis_tpu_torch.parallel.mesh import (
        axis_slice,
        make_mesh,
        param_shardings,
        tensor_parallelize,
    )

    mesh = make_mesh(*mesh_shape, device_type="cpu")
    vit = vit_from_state(cfg_kw, state)
    table = {k: tuple(repr(p) for p in v) for k, v in param_shardings(mesh, vit).items()}
    tp = tensor_parallelize(copy.deepcopy(vit), mesh)
    x = torch.from_numpy(images)
    with torch.no_grad():
        cls = _gather_data(mesh, tp(x[axis_slice(mesh, len(x))])["cls"])
    shapes = {k: tuple(v.shape) for k, v in tp.state_dict().items()}
    return cls.numpy(), table, shapes


def trainer_run(cfg_kw, state, images, ids, mesh_shape, steps, lr, wd, ckpt=None):
    """``steps`` VPRTrainer steps on a ``mesh_shape`` mesh from a GeM ViT
    with ``state``: (losses, whole parameters after, the caller's module
    unchanged, checkpoint round trip exact or None)."""
    from mlis_tpu_torch.parallel.mesh import make_mesh
    from mlis_tpu_torch.train.trainer import GeMEncoder, VPRTrainer

    mesh = make_mesh(*mesh_shape, device_type="cpu")
    enc = GeMEncoder(vit_from_state(cfg_kw, state))
    tr = VPRTrainer(enc, learning_rate=lr, weight_decay=wd, mesh=mesh, device="cpu")
    losses = [tr.train_batch(images, ids) for _ in range(steps)]
    after = {k: v.numpy() for k, v in tr.state_dict().items()}
    unchanged = all(np.array_equal(v.numpy(), state[k[len("vit."):]])
                    for k, v in enc.state_dict().items())
    round_trip = None
    if ckpt is not None:
        tr.save_checkpoint(ckpt)
        tr2 = VPRTrainer(enc, learning_rate=lr, weight_decay=wd, mesh=mesh, device="cpu")
        tr2.load_checkpoint(ckpt)
        again = tr2.state_dict()
        round_trip = (tr2.step == tr.step
                      and all(np.array_equal(again[k].numpy(), v) for k, v in after.items()))
    return losses, after, unchanged, round_trip


def encode_pixels(imgs: torch.Tensor) -> torch.Tensor:
    """Deterministic cheap encoder: gray pixels on a 12-pixel lattice,
    L2-normalised (tests/test_sharded_gate.py's ``_encode_fn``)."""
    x = imgs.to(torch.float32)
    if x.dim() == 4:
        x = x.mean(-1)
    d = x[:, ::12, ::12].reshape(x.shape[0], -1)
    return d / (torch.linalg.vector_norm(d, dim=1, keepdim=True) + 1e-8)


def tiny_lightglue(sp_state, lg_state, max_keypoints=64, match_threshold=0.1):
    """The tiny float32 LightGlue on the CPU with the given state dicts."""
    from mlis_tpu_torch.models.lightglue import LightGlue, MatcherConfig
    from mlis_tpu_torch.models.superpoint import SuperPointConfig

    lg = LightGlue(sp_cfg=SuperPointConfig.tiny_test(max_keypoints=max_keypoints,
                                                     dtype=torch.float32),
                   matcher_cfg=MatcherConfig.tiny_test(dtype=torch.float32,
                                                       match_threshold=match_threshold),
                   device="cpu")
    lg.sp.load_state({k: torch.from_numpy(v) for k, v in sp_state.items()})
    lg.net.load_state_dict({k: torch.from_numpy(v) for k, v in lg_state.items()}, strict=True)
    return lg


def sharded_gate_runs(images, times, floors, K, sp_state, lg_state, runs, gate_kw,
                      match_threshold):
    """sharded_full_gate_step on a (4, 1) mesh for each keyword set in
    ``runs`` (``uniforms`` as numpy): (verdicts, stats), or the
    ValueError's text."""
    from mlis_tpu_torch.parallel.mesh import make_mesh
    from mlis_tpu_torch.parallel.sharded_gate import sharded_full_gate_step

    mesh = make_mesh(-1, 1, device_type="cpu")
    lg = tiny_lightglue(sp_state, lg_state, match_threshold=match_threshold)
    out = []
    for kw in runs:
        kw = dict(kw)
        n = kw.pop("n_frames", len(images))
        if kw.get("uniforms") is not None:
            kw["uniforms"] = torch.from_numpy(kw["uniforms"])
        try:
            out.append(sharded_full_gate_step(mesh, lg, encode_pixels, images[:n], times[:n],
                                              floors[:n], K, **gate_kw, **kw))
        except ValueError as e:
            out.append(f"ValueError: {e}")
    return out


def finetune_demo(steps):
    """run_demo at its defaults but ``steps``, data-parallel over the world."""
    from mlis_tpu_torch.train.vpr_finetune_demo import run_demo

    return run_demo(steps=steps, device="cpu")
