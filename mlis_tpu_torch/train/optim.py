"""The optimiser of the pretraining drivers, with optax's numerics.

Counterpart of what ``mlis_tpu/train/*`` builds from optax:
``optax.chain(optax.clip_by_global_norm(1.0), optax.adam(schedule))``
(``adamw`` for the VPR encoders), the learning rate a
``warmup_cosine_decay_schedule`` of the update count. Every chain there
clips at :data:`MAX_GRAD_NORM`; :data:`ADAM_SETTINGS` are optax's Adam
settings, which the unclipped VPR fine-tuner (``train/trainer.py``)
shares:

* :func:`clip_by_global_norm_` is optax's rule, not
  ``torch.nn.utils.clip_grad_norm_``'s: the gradients are left alone when
  their global norm is below ``max_norm``, and are otherwise replaced by
  (g / norm) * max_norm (torch's adds 1e-6 to the norm and always scales);
* :func:`warmup_cosine_decay_schedule` maps the count of updates already
  made to the learning rate, so the first update takes ``init_value``;
* :class:`ClippedAdam` holds ``torch.optim.Adam`` (or ``AdamW``) with
  optax's settings, betas (0.9, 0.999) and eps 1e-8 outside the square
  root, and sets each update's learning rate from the schedule. A
  parameter that got no gradient is given a zero one, as optax updates
  every leaf of the tree.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Union

import torch

Schedule = Callable[[int], float]

MAX_GRAD_NORM = 1.0  # optax.clip_by_global_norm(1.0) in every reference chain
ADAM_SETTINGS = {"betas": (0.9, 0.999), "eps": 1e-8}  # optax.adam / adamw defaults


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over transition_steps, then end."""

    def schedule(count: int) -> float:
        if transition_steps <= 0:
            return end_value
        c = min(max(count, 0), transition_steps)
        frac = 1.0 - c / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: a linear warm-up from init_value
    to peak_value over warmup_steps, then a cosine decay to end_value at
    decay_steps (the warm-up included), end_value after it."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(count: int) -> float:
        return warm(count) if count < warmup_steps else decay(count - warmup_steps)

    return schedule


@torch.no_grad()
def clip_by_global_norm_(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place on ``grads`` (float32 tensors);
    returns the global norm. Below ``max_norm`` each g is divided and
    multiplied by one, otherwise replaced by (g / norm) * max_norm, as optax
    computes it. No host synchronisation (the choice is made on the
    device) and a few multi-tensor launches for all of ``grads``: a loop
    per tensor costs a training step of LightGlue (258 tensors) about 1,300
    kernel launches."""
    grads = list(grads)
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return norm


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(1.0), adam(schedule))``, or
    ``adamw(schedule, weight_decay=...)`` when ``weight_decay`` is given,
    over ``params``. ``learning_rate`` is a float or a schedule of the
    update count. Call :meth:`step` after the backward pass."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: Union[float, Schedule] = 1e-4,
                 weight_decay: Optional[float] = None):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = learning_rate if callable(learning_rate) else (
            lambda count, lr=float(learning_rate): lr)
        kw = dict(lr=self.schedule(0), **ADAM_SETTINGS)
        if weight_decay is None:
            self.opt = torch.optim.Adam(self.params, **kw)
        else:
            self.opt = torch.optim.AdamW(self.params, weight_decay=weight_decay, **kw)
        self.count = 0  # updates made

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def learning_rate(self) -> float:
        """The learning rate of the next update."""
        return float(self.schedule(self.count))

    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_by_global_norm_([p.grad for p in self.params], MAX_GRAD_NORM)
        for group in self.opt.param_groups:
            group["lr"] = self.learning_rate()
        self.opt.step()
        self.count += 1
