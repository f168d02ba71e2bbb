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
"""

from __future__ import annotations

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

    def update(self, grads, state: AdamState, params=None):
        """-> (updates, new state); ``params`` is unused, as in optax."""
        b1, b2 = self.b1, self.b2
        tree = grads
        grads, mu0, nu0 = (_as_dict(x) for x in (grads, state.mu, state.nu))
        mu = {k: (1 - b1) * g + b1 * mu0[k] for k, g in grads.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * nu0[k] for k, g in grads.items()}
        count = state.count + (state.count < _COUNT_MAX).to(torch.int32)
        steps = count.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(b1, device=steps.device), steps)
        c2 = 1 - torch.pow(torch.tensor(b2, device=steps.device), steps)
        updates = {k: -self.learning_rate
                   * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps))
                   for k in grads}
        return _like(tree, updates), AdamState(
            count=count, mu=_like(tree, mu), nu=_like(tree, nu))


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


def sgd(learning_rate: float) -> SGD:
    return SGD(learning_rate)


def apply_updates(params, updates):
    """``optax.apply_updates``: p + u in the parameter's dtype."""
    u = _as_dict(updates)
    return _like(params, {k: (p + u[k]).to(p.dtype)
                          for k, p in _as_dict(params).items()})
