"""The fit step's Adam update: build, bind and launch
``vrt_torch/csrc/optim.cu``.

    adam_step_cuda(params, grads, mu, nu, c1, c2, b1, b2, lr, eps,
                   apply=True) -> (out, mu', nu')
    adam_step_reference(the same arguments) -> (out, mu', nu')

Each argument but the scalars is a dict of f32 tensors with the same keys
and shapes (``params`` may be None where ``apply`` is False); ``c1`` and
``c2`` are 0-d f32 tensors, 1 - b1^count and 1 - b2^count, on the leaves'
device.  ``out`` is p + u (``apply``) or the update u itself, with optax's
arithmetic in optax's order (``diff.optim``'s docstring): the kernel rounds
each operation once, as the eager ops of the plain version do, so the two
agree bit for bit.  One launch takes every leaf (up to 16 a launch), reads
``c1`` and ``c2`` by pointer and writes new tensors: the caller's tensors
are not aliased, and nothing waits on the card.  The wrapper checks device,
dtype, shape and contiguity, raises on what the kernel does not take (a
non-f32 leaf, a CPU tensor), never falls back, and counts its launches in
``LAUNCHES`` ("apply" for p + u, "update" for u).
"""

from __future__ import annotations

import ctypes

import torch

from vrt_torch.kernels import _build
from vrt_torch.kernels.march import _stream

LAUNCHES = {"apply": 0, "update": 0}

_lib = None


def build() -> str:
    """Compile (when the library is missing) and load the kernel.  Returns
    the compiler's output, or "" when already built."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = _build.build("optim.cu")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vrt_adam_step.argtypes = [i32, ptr, ptr, ptr, ptr] + [f32] * 6 + [
        i32, ptr]
    lib.vrt_adam_step.restype = i32
    _lib = lib
    return log


# ---- the plain version --------------------------------------------------------

def adam_step_reference(params, grads, mu, nu, c1, c2, b1: float, b2: float,
                        lr: float, eps: float, apply: bool = True):
    """Adam in eager PyTorch on any device, optax's ``scale_by_adam`` then
    ``scale(-lr)`` (and ``apply_updates`` where ``apply``): (out, mu', nu'),
    dicts keyed as ``grads``."""
    mu1 = {k: (1 - b1) * g + b1 * mu[k] for k, g in grads.items()}
    nu1 = {k: (1 - b2) * (g * g) + b2 * nu[k] for k, g in grads.items()}
    out = {k: -lr * ((mu1[k] / c1) / (torch.sqrt(nu1[k] / c2) + eps))
           for k in grads}
    if apply:
        out = {k: (p + out[k]).to(p.dtype) for k, p in params.items()}
    return out, mu1, nu1


# ---- the wrapper --------------------------------------------------------------

def _check(x, name: str, shape, dev):
    if not isinstance(x, torch.Tensor):
        raise ValueError(f"the Adam kernel: {name} is no tensor")
    if x.device.type != "cuda" or x.device != dev:
        raise ValueError(f"the Adam kernel runs on one CUDA device, {name} "
                         f"is on {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"the Adam kernel takes f32 leaves, {name} has "
                         f"dtype {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"the Adam kernel: {name} has shape "
                         f"{tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"the Adam kernel: {name} is not contiguous")


def adam_step_cuda(params, grads, mu, nu, c1, c2, b1: float, b2: float,
                   lr: float, eps: float, apply: bool = True):
    """Launch the Adam update on ``torch.cuda.current_stream()``: (out, mu',
    nu') as ``adam_step_reference`` gives them, in new tensors.  Raises on
    any input the kernel does not take; never falls back."""
    keys = list(grads)
    if not keys:
        raise ValueError("the Adam kernel: no leaves")
    dev = grads[keys[0]].device
    if dev.type != "cuda":
        raise ValueError(f"the Adam kernel runs on CUDA tensors, got {dev}")
    for k in keys:
        shape = grads[k].shape
        for name, tree in (("grad", grads), ("mu", mu), ("nu", nu)) + (
                (("param", params),) if apply else ()):
            if k not in tree:
                raise ValueError(f"the Adam kernel: {name} has no leaf "
                                 f"{k!r}")
            _check(tree[k], f"{name} {k!r}", shape, dev)
    for name, x in (("c1", c1), ("c2", c2)):
        _check(x, name, (), dev)
    out = {k: torch.empty_like(grads[k]) for k in keys}
    mu1 = {k: torch.empty_like(grads[k]) for k in keys}
    nu1 = {k: torch.empty_like(grads[k]) for k in keys}
    ptrs = (ctypes.c_void_p * (7 * len(keys)))()
    sizes = (ctypes.c_longlong * len(keys))()
    for i, k in enumerate(keys):
        ptrs[7 * i:7 * i + 7] = [
            params[k].data_ptr() if apply else None, grads[k].data_ptr(),
            mu[k].data_ptr(), nu[k].data_ptr(), out[k].data_ptr(),
            mu1[k].data_ptr(), nu1[k].data_ptr()]
        sizes[i] = grads[k].numel()
    build()
    got = _lib.vrt_adam_step(len(keys), ptrs, sizes, c1.data_ptr(),
                             c2.data_ptr(), 1 - b1, b1, 1 - b2, b2, -lr, eps,
                             int(apply), _stream(dev))
    if got < 0:
        raise RuntimeError(f"Adam launch failed: cudaError {-got}")
    LAUNCHES["apply" if apply else "update"] += got
    return out, mu1, nu1
