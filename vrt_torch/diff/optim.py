"""A functional Adam in optax's arithmetic (the optimizer of
``vrt.diff.fit``).

``adam(lr).update(grads, state)`` returns the update and the new state
without touching the parameters, so a fit step can filter the update
before applying it (``make_fit_step_view(sdf_smooth=...)`` smooths the SDF
update, not the field) — ``torch.optim.Adam`` applies its update in place
and never exposes it.  The state maps one to one onto optax's
``ScaleByAdamState(count, mu, nu)``: a checkpoint written by either package
resumes in the other (``vrt_torch.diff.checkpoint``).

The arithmetic is optax's ``scale_by_adam`` then ``scale(-lr)``, in its
order: mu = (1-b1) g + b1 mu, nu = (1-b2) g*g + b2 nu, count += 1,
u = -lr * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps).
``sgd(lr)`` is optax's ``sgd`` without momentum: u = -lr * g, no state.
Parameters are dicts of tensors, or one tensor (a slab's planes), as optax
takes any pytree; the state and the updates then hold a tensor where they
hold a dict.

``Adam.apply(params, grads, state) -> (params, state)`` is ``update`` then
``apply_updates`` in one: what a fit step calls wherever nothing stands
between the update and its application.  On CUDA tensors it launches the
Adam kernel (``vrt_torch.kernels.optim``: one launch over every leaf,
bit-equal to the eager arithmetic), and ``update`` launches its variant
that writes the update; on CPU tensors both run the eager arithmetic
(``kernels.optim.adam_step_reference``), and ``apply`` is exactly
``update`` followed by ``apply_updates``.  Adam takes f32 leaves only.  The
bias corrections 1 - b^count are computed on the count's device from a
Python scalar, so no step copies a value to the card and waits for it.
"""

from __future__ import annotations

import struct
from typing import Dict, NamedTuple

import torch

_COUNT_MAX = 2 ** 31 - 1


class AdamState(NamedTuple):
    count: torch.Tensor  # i32 [], steps taken
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def _as_dict(x):
    return x if isinstance(x, dict) else {"": x}


def _like(tree, d):
    """``d`` in the structure of ``tree``: the dict, or its one tensor."""
    return d if isinstance(tree, dict) else d[""]


class Adam:
    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> AdamState:
        leaves = _as_dict(params)
        dev = next(iter(leaves.values())).device

        def zeros():
            return _like(params, {k: torch.zeros_like(v)
                                  for k, v in leaves.items()})
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu=zeros(), nu=zeros())

    def corrections(self, count):
        """(count + 1, c1, c2) after a step from ``count`` (i32 []): the
        count saturates at 2^31 - 1 as optax's, c1 = 1 - b1^count and c2 =
        1 - b2^count in f32 on the count's device, each b rounded to f32
        first (``torch.pow`` of a Python scalar wraps it on the exponent's
        device without a copy from the host)."""
        count = count + (count < _COUNT_MAX).to(torch.int32)
        steps = count.to(torch.float32)
        c1 = 1 - torch.pow(_f32(self.b1), steps)
        c2 = 1 - torch.pow(_f32(self.b2), steps)
        return count, c1, c2

    def _step(self, params, grads, state: AdamState, apply: bool):
        tree = grads
        p, g, mu0, nu0 = (None if x is None else _as_dict(x)
                          for x in (params, grads, state.mu, state.nu))
        count, c1, c2 = self.corrections(state.count)
        if any(t.device.type == "cuda" for t in g.values()):
            from vrt_torch.kernels.optim import adam_step_cuda as step
        else:
            from vrt_torch.kernels.optim import adam_step_reference as step
        out, mu, nu = step(p, g, mu0, nu0, c1, c2, self.b1, self.b2,
                           self.learning_rate, self.eps, apply)
        return _like(tree, out), AdamState(
            count=count, mu=_like(tree, mu), nu=_like(tree, nu))

    def update(self, grads, state: AdamState, params=None):
        """-> (updates, new state); ``params`` is unused, as in optax.  On
        CUDA tensors one launch of the Adam kernel's update variant."""
        return self._step(None, grads, state, apply=False)

    def apply(self, params, grads, state: AdamState):
        """-> (new params, new state): ``update`` and ``apply_updates`` in
        one, on f32 leaves only (raises on any other).  On CUDA tensors one
        launch of the Adam kernel; on CPU tensors exactly ``update``
        followed by ``apply_updates``."""
        _check_f32(params, grads, state.mu, state.nu)
        if any(t.device.type == "cuda" for t in _as_dict(grads).values()):
            return self._step(params, grads, state, apply=True)
        updates, state = self.update(grads, state, params)
        return apply_updates(params, updates), state


def _f32(x: float) -> float:
    """``x`` rounded to f32, as ``torch.tensor(x)`` holds it."""
    return struct.unpack("f", struct.pack("f", x))[0]


def _check_f32(*trees):
    for tree in trees:
        for k, v in _as_dict(tree).items():
            if v.dtype != torch.float32:
                name = repr(k) if k else "the leaf"
                raise ValueError(f"Adam.apply takes f32 leaves, {name} has "
                                 f"dtype {v.dtype}")


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Adam:
    return Adam(learning_rate, b1, b2, eps)


class SGD:
    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def init(self, params):
        return ()

    def update(self, grads, state, params=None):
        """-> (updates, state): -lr * g, as ``optax.sgd(lr)``."""
        return _like(grads, {k: -self.learning_rate * g
                             for k, g in _as_dict(grads).items()}), state

    def apply(self, params, grads, state):
        """-> (new params, state): ``update`` then ``apply_updates``."""
        updates, state = self.update(grads, state, params)
        return apply_updates(params, updates), state


def sgd(learning_rate: float) -> SGD:
    return SGD(learning_rate)


def apply_updates(params, updates):
    """``optax.apply_updates``: p + u in the parameter's dtype."""
    u = _as_dict(updates)
    return _like(params, {k: (p + u[k]).to(p.dtype)
                          for k, p in _as_dict(params).items()})
