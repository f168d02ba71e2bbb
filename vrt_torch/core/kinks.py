"""|a|, max, min and clip with ``vrt``'s derivatives at their kinks.

``vrt`` differentiates with JAX, which takes d|a|/da as 1 where a >= 0 (at
0 and at -0 too) and -1 below, and splits the cotangent 0.5/0.5 between the
two arguments of ``maximum`` / ``minimum`` where they tie (``jnp.clip`` is a
maximum, then a minimum).  Torch's ``abs`` has derivative 0 at 0, and its
``clamp`` family passes the whole cotangent at the bound.  The ops here keep
torch's forward values and take JAX's derivatives: ``torch.where(a >= 0, a,
-a)`` for |a| (-0 stays -0, equal to 0), and ``torch.maximum`` /
``torch.minimum`` against a 0-dim tensor, whose autograd splits a tie.  The
kernels' backward passes follow the same rules (``csrc/resolve.cu``'s
``Weights``, ``csrc/shade.cu``'s ``dabs`` and ``pass_max``).
"""

from __future__ import annotations

import torch

# 0-dim bounds by (value, dtype, device), made once: no fill or copy a call
_SCALARS = {}


def _scalar(value: float, dtype: torch.dtype, device: torch.device):
    key = (value, dtype, device)
    if key not in _SCALARS:
        _SCALARS[key] = torch.full((), value, dtype=dtype, device=device)
    return _SCALARS[key]


def abs_(a):
    """|a|, derivative 1 where a >= 0, else -1."""
    return torch.where(a >= 0, a, -a)


def dabs(a):
    """d|a|/da as ``abs_`` takes it: 1 where a >= 0, else -1 (a closed
    form's factor)."""
    return torch.where(a >= 0, 1.0, -1.0).to(a.dtype)


def maximum(x, c: float):
    """max(x, c): x's cotangent whole above c, half at a tie."""
    return torch.maximum(x, _scalar(c, x.dtype, x.device))


def minimum(x, c: float):
    """min(x, c): x's cotangent whole below c, half at a tie."""
    return torch.minimum(x, _scalar(c, x.dtype, x.device))


def clip(x, lo: float, hi: float):
    """``jnp.clip``: max with lo, then min with hi."""
    return minimum(maximum(x, lo), hi)
