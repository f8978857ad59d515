"""1-D signal filters on tensors.

Counterpart of ``mlis_tpu/ops/filters.py``. ``uniform_filter1d`` has
scipy.ndimage.uniform_filter1d's semantics (mode='reflect', origin=0) and
is a cumulative sum over a reflect-padded signal: O(N) whatever the window.
The sum runs in the input's dtype (float32 for float32), as in the JAX
version; its summation order differs from XLA's, so on long streams a
window mean can differ from the JAX package's in its last bits.
"""

from __future__ import annotations

import torch


def uniform_filter1d(x: torch.Tensor, size: int) -> torch.Tensor:
    """Mean filter, scipy 'reflect' boundary ((d c b a | a b c d)).

    For window ``size``, output[i] averages input[i - size//2 .. i + (size-1)//2]
    (left-biased window for even sizes, as scipy's origin=0)."""
    if size <= 1:
        return x
    n = x.shape[0]
    left = size // 2
    right = size - left - 1
    # scipy 'reflect' repeats the edge sample (a b c | c b a)
    xp = torch.cat([x[:left].flip(0), x, x[n - right :].flip(0)])
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    c = torch.cat([xp.new_zeros(1, dtype=dtype), torch.cumsum(xp, 0, dtype=dtype)])
    return (c[size:] - c[:-size]) / size


def cumtrapz(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cumulative trapezoidal integral, length N, T[0] = 0.

    trapz(y[s:e], x[s:e]) == cumtrapz(y, x)[e-1] - cumtrapz(y, x)[s]."""
    seg = 0.5 * (y[1:] + y[:-1]) * (x[1:] - x[:-1])
    return torch.cat([seg.new_zeros(1), torch.cumsum(seg, 0)])
