"""VPR fine-tuning: contrastive training of descriptor encoders.

Counterpart of ``mlis_tpu/train/trainer.py``: a supervised-contrastive
(NT-Xent over place labels) objective for indoor-domain adaptation of the
VPR encoders, over a (data, model) mesh — the batch split over ``data``,
Megatron TP of the transformer Dense layers over ``model``
(parallel/mesh.py). The encoder is an ``nn.Module`` mapping images to
(B, D) descriptors; its attention must run the plain version
(``use_kernel=False``), since the kernels are forward-only.

NT-Xent couples the whole batch, so each rank encodes its slab, the
descriptors are all-gathered (differentiably) and every rank computes the
loss of the GLOBAL batch; the gradients are then summed over ``data``. The
step equals the single-device step on the global batch, up to rounding.

The optimiser is ``torch.optim.AdamW`` with ``optax.adamw``'s settings:
betas (0.9, 0.999), eps 1e-8 outside the square root, decoupled weight
decay (1e-4 by default, on every parameter).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from mlis_tpu_torch.ops.pooling import gem_pool
from mlis_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_slice,
    full_state_dict,
    gather_replicated,
    load_full_state_dict,
    make_mesh,
    tensor_parallelize,
)


def nt_xent_loss(
    descriptors: torch.Tensor,  # (B, D), assumed L2-normalizable
    place_ids: torch.Tensor,  # (B,) int — same id == same place
    temperature: float = 0.07,
) -> torch.Tensor:
    """Supervised NT-Xent: pull same-place descriptors together, push the
    rest apart. Mean over anchors with at least one positive."""
    d = descriptors.to(torch.float32)
    d = d / (torch.linalg.vector_norm(d, dim=1, keepdim=True) + 1e-8)
    sims = d @ d.T / temperature
    B = d.shape[0]
    eye = torch.eye(B, dtype=torch.bool, device=d.device)
    pos = (place_ids[:, None] == place_ids[None, :]) & ~eye

    sims = sims.masked_fill(eye, float("-inf"))
    log_prob = sims - torch.logsumexp(sims, dim=1, keepdim=True)
    pos_count = pos.sum(1)
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    per_anchor = -torch.where(pos, log_prob, zero).sum(1) / pos_count.clamp_min(1)
    has_pos = pos_count > 0
    return torch.where(has_pos, per_anchor, zero).sum() / has_pos.sum().clamp_min(1)


def make_train_step(
    encoder: nn.Module,
    optimizer: torch.optim.Optimizer,
    data_group=None,
) -> Callable:
    """(images, place_ids) -> loss: one optimiser step of ``encoder``.

    Without ``data_group`` the step is single-device. With it, ``images``
    is this rank's slab of the global batch and ``place_ids`` the GLOBAL
    labels: the descriptors are gathered over the group before the loss,
    and the gradients summed over it after the backward pass."""
    params = [p for p in encoder.parameters() if p.requires_grad]

    def train_step(images: torch.Tensor, place_ids: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        desc = encoder(images)
        if data_group is not None:
            desc = gather_replicated(desc, data_group)
        loss = nt_xent_loss(desc, place_ids)
        loss.backward()
        if data_group is not None and dist.get_world_size(data_group) > 1:
            # one all_reduce over the flattened gradients
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            dist.all_reduce(flat, group=data_group)
            for p, g in zip(params, flat.split([p.numel() for p in params])):
                p.grad.copy_(g.view_as(p))
        optimizer.step()
        return loss.detach()

    return train_step


class VPRTrainer:
    """Sharded trainer around an encoder module (images -> (B, D)).

    The trainer works on a copy of ``encoder``; the caller's module is
    never changed. Every rank of the mesh calls :meth:`train_batch` with the
    same global batch and takes its slab."""

    def __init__(
        self,
        encoder: nn.Module,
        learning_rate: float = 1e-4,
        weight_decay: float = 1e-4,
        n_data: int = -1,
        n_model: int = 1,
        mesh=None,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None else make_mesh(n_data, n_model, self.device.type)
        self.encoder = tensor_parallelize(copy.deepcopy(encoder).to(self.device).train(),
                                          self.mesh)
        self.optimizer = torch.optim.AdamW(self.encoder.parameters(), lr=learning_rate,
                                           betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=weight_decay)
        self.data_group = self.mesh.get_group(DATA_AXIS)
        self._step_fn = make_train_step(self.encoder, self.optimizer, self.data_group)
        self.step = 0

    def train_batch(self, images, place_ids) -> float:
        images = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        place_ids = torch.as_tensor(np.asarray(place_ids, np.int64), device=self.device)
        loss = self._step_fn(images[axis_slice(self.mesh, len(images))], place_ids)
        self.step += 1
        return float(loss)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The encoder's whole parameters (sharded weights gathered)."""
        return full_state_dict(self.encoder)

    # -- checkpointing (npz in the flax layout) ------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Write the encoder's parameters in the flax layout
        (:func:`mlis_tpu_torch.weights.to_jax_params`, float32 under
        ``params:`` keys, named after the encoder's modules) and the step
        into the npz file ``path``. The JAX package writes an orbax
        directory instead, which cannot be read without JAX. A collective:
        every rank calls it, rank 0 writes."""
        from mlis_tpu_torch.weights import flatten_params, to_jax_params

        flat = flatten_params(to_jax_params(self.state_dict()))
        if dist.get_rank() == 0:
            arrays = {f"params:{k}": v for k, v in flat.items()}
            with open(path, "wb") as f:
                np.savez(f, step=np.asarray(self.step, np.int64), **arrays)
        dist.barrier()

    def load_checkpoint(self, path: str) -> None:
        """Restore the parameters and the step written by
        :meth:`save_checkpoint` (the optimiser state starts afresh, as the
        JAX package's restore of params and step does)."""
        from mlis_tpu_torch.weights import from_jax_params, unflatten_params

        with np.load(path) as z:
            step = int(z["step"])
            tree = unflatten_params({k.split(":", 1)[1]: z[k] for k in z.files if k != "step"})
        state = {k: v.to(self.device) for k, v in from_jax_params(tree, scan_prefixes=()).items()}
        load_full_state_dict(self.encoder, state)
        self.step = step


class GeMEncoder(nn.Module):
    """A ViT's patch tokens through GeM (p = 3), L2-normalised: the encoder
    of the JAX package's fine-tuning demo and trainer tests."""

    def __init__(self, vit: nn.Module, p: float = 3.0):
        super().__init__()
        self.vit, self.p = vit, p

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        d = gem_pool(self.vit(images)["patches"], p=self.p)
        return d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)

