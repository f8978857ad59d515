"""Device mesh, placements and Megatron tensor parallelism on torch.distributed.

Counterpart of ``mlis_tpu/parallel/mesh.py``: a (data, model)
:class:`~torch.distributed.device_mesh.DeviceMesh`, batches split over
``data`` and Megatron-style sharding of the transformer's Dense layers over
``model``. The program runs SPMD: every rank runs the same code on its own
slab, and the collectives are explicit.

Placements. ``param_shardings`` gives each parameter one placement per mesh
axis. A flax kernel is ``(in, out)`` and a ``torch.nn.Linear`` weight is
``(out, in)``, so the reference's column-parallel ``P(None, "model")`` is
``Shard(0)`` of the torch weight and its row-parallel ``P("model", None)``
is ``Shard(1)``. Everything else replicates, biases included.

Tensor parallelism (Megatron). :func:`tensor_parallelize` swaps each
column-parallel Dense and the row-parallel Dense that reads it (an
attention's ``qkv`` and ``proj``, an MLP's ``fc1`` and ``fc2``) for
:class:`ShardedDense` layers that hold their rank's shard. The
column-parallel output stays local and feeds the row-parallel layer
directly, which sums its partial products over ``model``: one all-reduce
per pair in the forward pass, one in the backward. The packed qkv is split
by head: the rank's rows are the q, k and v rows of its own heads, so the
``(B, L, 3, H, Dh)`` view reads them with H the rank's head count (a
contiguous row shard would mix q, k and v). The forward is the
single-device function, up to the order of the row-parallel sums. A
column-parallel Dense with no row-parallel reader (SALAD's hidden layers)
stays whole on every rank, as does an attention whose heads do not split
over ``model``.
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from mlis_tpu_torch.models.layers import Dense

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_process_group(store_dir: Optional[str] = None, rank: int = 0, world_size: int = 1,
                       device_type: str = "cuda",
                       timeout: Optional[datetime.timedelta] = None) -> bool:
    """Start the default process group unless one is up: ``nccl`` for CUDA,
    ``gloo`` for the CPU, over a ``FileStore`` under ``store_dir`` (which
    every rank names alike), or over an in-memory store for a one-rank
    group when ``store_dir`` is None. ``timeout`` bounds each collective
    (torch's default when None). Returns True when it started one."""
    if store_dir is None and world_size != 1:
        raise ValueError(f"a group of {world_size} ranks needs a store_dir")
    if dist.is_initialized():
        return False
    if store_dir is None:
        store = dist.HashStore()
    else:
        store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", store=store, rank=rank,
                            world_size=world_size, **kw)
    return True


def make_mesh(n_data: int = -1, n_model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """Build a (data, model) mesh over the process group's ranks (starting a
    one-rank group when none is up). n_data=-1 uses all remaining ranks."""
    init_process_group(device_type=device_type)
    n = dist.get_world_size()
    if n_model < 1 or n % n_model:
        raise ValueError(f"model axis {n_model} does not divide {n} devices")
    if n_data == -1:
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} devices")
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: DeviceMesh) -> Tuple:
    """Placements of a batch: the leading axis split over ``data``."""
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> Tuple:
    return (Replicate(), Replicate())


def axis_slice(mesh: DeviceMesh, n: int, axis: str = DATA_AXIS) -> slice:
    """This rank's slab of a length-``n`` axis split over ``axis``."""
    size, r = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)
    if n % size:
        raise ValueError(f"{n} rows do not shard over {size} devices")
    return slice(r * (n // size), (r + 1) * (n // size))


def shard_batch(mesh: DeviceMesh, batch: Any) -> Any:
    """This rank's slab of every leaf of a host batch (tensors or arrays,
    in dicts, lists or tuples), the leading axis split over ``data``."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return batch[axis_slice(mesh, len(batch))]


# Megatron-style tensor-parallel rules for the transformer kernels:
# column-parallel (shard output features) for qkv / fc1, row-parallel
# (shard input features) for proj / fc2. Everything else replicates.
_COL_PARALLEL = re.compile(r"(qkv|fc1|feat_hidden|score_hidden|token_hidden)$")
_ROW_PARALLEL = re.compile(r"(proj|fc2)$")


def _model_shard_dim(name: str, param: torch.Tensor) -> Optional[int]:
    """The torch weight dim the reference's rule shards over ``model``."""
    path = name.split(".")
    if param.dim() != 2 or path[-1] != "weight":
        return None
    owner = path[-2] if len(path) >= 2 else ""
    if _COL_PARALLEL.search(owner):
        return 0
    if _ROW_PARALLEL.search(owner):
        return 1
    return None


def param_shardings(mesh: DeviceMesh, module: nn.Module) -> Dict[str, Tuple]:
    """{parameter name: (data placement, model placement)} of a module's
    full-size parameters: TP on the transformer Dense weights over
    ``model`` where the axis size divides the dim, replicated otherwise."""
    model_size = mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))
    out = {}
    for name, p in module.named_parameters():
        dim = _model_shard_dim(name, p)
        if dim is not None and p.shape[dim] % model_size:
            dim = None
        out[name] = (Replicate(), Replicate() if dim is None else Shard(dim))
    return out


# -- Megatron's f and g, and the shards of a packed weight -----------------------


def _own_slice(x: torch.Tensor, group, dim: int, pack: int = 1) -> torch.Tensor:
    """This rank's slice along ``dim`` of each of the ``pack`` equal blocks
    that ``dim`` holds (a packed qkv: pack 3), the blocks kept in order."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    d = dim % x.dim()
    blocks = x.unflatten(d, (pack, x.shape[d] // pack))
    size = blocks.shape[d + 1] // n
    return blocks.narrow(d + 1, r * size, size).flatten(d, d + 1).contiguous()


def _gather_shards(x: torch.Tensor, group, dim: int, pack: int = 1) -> torch.Tensor:
    """The whole tensor from every rank's :func:`_own_slice`."""
    n = dist.get_world_size(group)
    d = dim % x.dim()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    blocks = [p.unflatten(d, (pack, p.shape[d] // pack)) for p in parts]
    return torch.cat(blocks, d + 1).flatten(d, d + 1)


class _CopyToGroup(torch.autograd.Function):
    """f: identity forward, gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """g: sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """All-gather along dim 0 forward; backward keeps this rank's rows
    (every rank computes the same downstream function)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_shards(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.group, 0), None


def gather_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-gather of the rows of ``x`` for a downstream that
    every rank of ``group`` computes alike (the gradient of the rank's own
    rows comes back)."""
    return _GatherFromGroup.apply(x, group)


class ShardedDense(nn.Module):
    """A :class:`~mlis_tpu_torch.models.layers.Dense` holding its rank's
    shard of the weight over the ``model`` group. ``col`` (Shard(0), output
    features; ``pack`` equal blocks each split alike) returns its rank's
    output features; ``row`` (Shard(1), input features) takes its rank's
    input features and sums the partial products over the group in float32.
    The bias stays whole; a ``col`` layer adds its own slice of it."""

    def __init__(self, dense: Dense, style: str, group, pack: int = 1):
        super().__init__()
        self.style, self.group, self.dtype, self.pack = style, group, dense.dtype, pack
        self.dim = 0 if style == "col" else 1
        self.weight = nn.Parameter(_own_slice(dense.weight.detach(), group, self.dim, pack))
        self.bias = None if dense.bias is None else nn.Parameter(dense.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, g = self.dtype, self.group
        if self.style == "col":
            b = None
            if self.bias is not None:
                b = _own_slice(_CopyToGroup.apply(self.bias, g), g, 0, self.pack).to(dt)
            return F.linear(_CopyToGroup.apply(x.to(dt), g), self.weight.to(dt), b)
        y = _ReduceFromGroup.apply(F.linear(x.to(dt).float(), self.weight.to(dt).float()), g)
        if self.bias is not None:
            y = y + self.bias.to(dt).float()
        return y.to(dt)

    def full_weight(self) -> torch.Tensor:
        """The whole weight, gathered over the group."""
        return _gather_shards(self.weight.detach(), self.group, self.dim, self.pack)


# (column-parallel Dense, row-parallel Dense that reads it) in one module
_TP_PAIRS = (("qkv", "proj"), ("fc1", "fc2"))


def tensor_parallelize(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Swap, in place, each column/row pair of Dense layers whose weights
    ``param_shardings`` shards over ``model`` for :class:`ShardedDense`
    layers (module docstring); a model axis of size 1 leaves the module as
    it is. Returns ``module``."""
    n = mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))
    if n == 1:
        return module
    group = mesh.get_group(MODEL_AXIS)
    table = param_shardings(mesh, module)
    for name, m in list(module.named_modules()):
        prefix = f"{name}." if name else ""
        for col, row in _TP_PAIRS:
            if not (isinstance(getattr(m, col, None), Dense)
                    and isinstance(getattr(m, row, None), Dense)):
                continue
            if (table[f"{prefix}{col}.weight"][1] != Shard(0)
                    or table[f"{prefix}{row}.weight"][1] != Shard(1)):
                continue
            pack = 1
            if col == "qkv":
                if getattr(m, "num_heads", n) % n:
                    continue
                # the attention runs its rank's heads: q, k and v of each
                pack, m.num_heads, m.dim = 3, m.num_heads // n, m.dim // n
            setattr(m, col, ShardedDense(getattr(m, col), "col", group, pack))
            setattr(m, row, ShardedDense(getattr(m, row), "row", group))
    return module


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's state dict with every sharded weight gathered whole
    (a collective: every rank of the model group calls it)."""
    state = dict(module.state_dict())
    for name, m in module.named_modules():
        if isinstance(m, ShardedDense):
            state[f"{name}.weight"] = m.full_weight()
    return {k: v.detach() for k, v in state.items()}


def load_full_state_dict(module: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Load a whole-size state dict into a possibly tensor-parallel module:
    each sharded weight takes its rank's shard."""
    local = {}
    shards = {f"{n}.weight": m for n, m in module.named_modules() if isinstance(m, ShardedDense)}
    for k, v in state.items():
        m = shards.get(k)
        local[k] = v if m is None else _own_slice(v, m.group, m.dim, m.pack)
    module.load_state_dict(local, strict=True)
