"""Fit checkpoints in ``vrt``'s ``.npz`` layout (port of
``vrt.diff.checkpoint``).

One ``.npz`` holds the parameter leaves ``p0, p1, ...`` and the optimizer
state leaves ``o0, o1, ...`` in pytree order (dict keys sorted; the Adam
state as count, then mu, then nu, which is also the leaf order of optax's
``adam`` state), and ``meta``: the JSON of the step, the leaf counts and
the caller's extras, as bytes.  A checkpoint written by ``vrt`` resumes in
the port and the reverse, with ``vrt_torch.diff.optim.AdamState`` standing
for optax's ``ScaleByAdamState``.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from vrt_torch.render.gpuscene import _to_tensor


def _flatten(tree) -> list:
    """Tensor leaves in pytree order: dicts by sorted key, tuples (and
    named tuples) in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in _flatten(item)]
    raise TypeError(f"not a checkpoint tree node: {type(tree).__name__}")


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, torch.Tensor):
        return next(leaves)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    items = [_unflatten(item, leaves) for item in like]
    return type(like)(*items) if hasattr(like, "_fields") \
        else type(like)(items)


def _numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        import ml_dtypes

        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


def save_checkpoint(path: str, params, opt_state, step: int,
                    extra: Dict | None = None) -> None:
    """Write ``params``, ``opt_state`` and ``step`` to ``path``
    atomically (a temporary file, then a rename)."""
    p_leaves, o_leaves = _flatten(params), _flatten(opt_state)
    arrays = {f"p{i}": _numpy(x) for i, x in enumerate(p_leaves)}
    arrays.update({f"o{i}": _numpy(x) for i, x in enumerate(o_leaves)})
    meta = dict(step=int(step), n_params=len(p_leaves),
                n_opt=len(o_leaves), extra=extra or {})
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(),
                                   np.uint8).copy()
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load_checkpoint(path: str, params_like, opt_state_like):
    """-> (params, opt_state, step, extra), shaped like the ``*_like``
    trees, each leaf on its ``*_like`` leaf's device."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["meta"]).decode())
    p_like, o_like = _flatten(params_like), _flatten(opt_state_like)
    if meta["n_params"] != len(p_like):
        raise ValueError(f"{path}: {meta['n_params']} parameter leaves, "
                         f"expected {len(p_like)}")
    if meta["n_opt"] != len(o_like):
        raise ValueError(f"{path}: {meta['n_opt']} optimizer leaves, "
                         f"expected {len(o_like)}")
    p = [_to_tensor(data[f"p{i}"], x.device) for i, x in enumerate(p_like)]
    o = [_to_tensor(data[f"o{i}"], x.device) for i, x in enumerate(o_like)]
    return (_unflatten(params_like, iter(p)),
            _unflatten(opt_state_like, iter(o)), meta["step"],
            meta["extra"])


def params_from_numpy(arrays: Dict[str, np.ndarray],
                      device: torch.device | str = "cuda"):
    """``vrt``'s parameter arrays (numpy, bf16 as ml_dtypes) as the port's
    parameter dict on ``device``."""
    return {k: _to_tensor(v, device) for k, v in arrays.items()}
