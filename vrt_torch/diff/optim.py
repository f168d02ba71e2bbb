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
Parameters are dicts of tensors.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

_COUNT_MAX = 2 ** 31 - 1


class AdamState(NamedTuple):
    count: torch.Tensor  # i32 [], steps taken
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class Adam:
    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        dev = next(iter(params.values())).device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()})

    def update(self, grads: Dict[str, torch.Tensor], state: AdamState,
               params=None):
        """-> (updates, new state); ``params`` is unused, as in optax."""
        b1, b2 = self.b1, self.b2
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state.nu[k]
              for k, g in grads.items()}
        count = state.count + (state.count < _COUNT_MAX).to(torch.int32)
        steps = count.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(b1, device=steps.device), steps)
        c2 = 1 - torch.pow(torch.tensor(b2, device=steps.device), steps)
        updates = {k: -self.learning_rate
                   * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps))
                   for k in grads}
        return updates, AdamState(count=count, mu=mu, nu=nu)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Adam:
    return Adam(learning_rate, b1, b2, eps)


def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]):
    """``optax.apply_updates``: p + u in the parameter's dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
