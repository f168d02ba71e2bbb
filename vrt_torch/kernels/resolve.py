"""The fused resolve, forward: build, bind and launch
``vrt_torch/csrc/resolve.cu``.

    resolve_scene_cuda(scene, o_w, d_w, hit, inst)
        -> (t f32 [R], object-space normal f32 [R,3], unlit bool [R])

One thread per ray computes what
``vrt_torch.render.renderer.resolve_scene_reference`` (its plain version)
computes for a frame that records no autograd graph; the [R,7,8] corner
rows of the plain version never reach device memory.  It has no backward:
``renderer.resolve_scene`` sends a frame that records a graph through the
plain version, whose row gather is K3.  Built with ``--fmad=false`` like K1,
so every operation rounds as in eager PyTorch and the two agree bit for bit.

``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from vrt_torch.kernels import _build
from vrt_torch.kernels.march import _check as _check_tensor
from vrt_torch.kernels.march import _stream
from vrt_torch.march.types import MarchHit

LAUNCHES = 0

NVCC_FLAGS = ["--fmad=false"]

_lib = None


def build() -> str:
    """Compile (when the library is missing) and load the kernel.  Returns
    the compiler's output, or "" when already built."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = _build.build("resolve.cu", NVCC_FLAGS, headers=["scene.cuh"])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.vrt_resolve_scene.argtypes = ([ptr] * 11 + [i32] + [ptr] * 4
                                      + [i32] * 4 + [ctypes.c_longlong]
                                      + [ptr] * 3 + [ptr])
    lib.vrt_resolve_scene.restype = i32
    _lib = lib
    return log


def _check(x, name, dtype, shape, device):
    _check_tensor(x, name, dtype, shape, device, who="resolve")


def load_path(corners) -> str:
    """The kernel's load path for a corner table: "v16" (16-byte loads)
    where its rows and its base are 16-byte aligned, else "ldg" (one load
    per element)."""
    row_bytes = corners.shape[-1] * corners.element_size()
    aligned = row_bytes % 16 == 0 and corners.data_ptr() % 16 == 0
    return "v16" if aligned else "ldg"


def resolve_scene_cuda(scene, o_w, d_w, hit: MarchHit, inst):
    """Launch the fused resolve on ``torch.cuda.current_stream()`` for the
    hits ``(hit, inst)`` of ``march_scene`` on world rays ``o_w``, ``d_w``
    against ``scene`` (a GPUScene).  Records no autograd graph.  Raises on
    any input the kernel does not take; never falls back."""
    global LAUNCHES

    if o_w.device.type != "cuda":
        raise ValueError(f"the fused resolve runs on CUDA tensors, got "
                         f"{o_w.device}")
    dev = o_w.device
    rays = o_w.shape[0]
    _check(o_w, "o_w", torch.float32, (rays, 3), dev)
    _check(d_w, "d_w", torch.float32, (rays, 3), dev)
    _check(inst, "inst", torch.int32, (rays,), dev)
    _check(hit.kind, "hit.kind", torch.int32, (rays,), dev)
    _check(hit.t, "hit.t", torch.float32, (rays,), dev)
    _check(hit.cell, "hit.cell", torch.int32, (rays, 3), dev)
    _check(hit.face_normal, "hit.face_normal", torch.float32, (rays, 3), dev)
    vols = scene.volumes
    nv = vols.n.shape[0]
    cc = vols.corners.shape[1]
    ch = vols.corners.shape[-1]
    if ch not in (8, 9):
        raise ValueError(f"resolve takes 8 or 9 corner channels, got {ch}")
    if vols.corners.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"resolve takes f32 or bf16 corners, got "
                         f"{vols.corners.dtype}")
    _check(vols.n, "n", torch.int32, (nv,), dev)
    _check(vols.cell_size, "cell_size", torch.float32, (nv,), dev)
    _check(vols.extends, "extends", torch.float32, (nv,), dev)
    _check(vols.corners, "corners", vols.corners.dtype,
           (nv, cc, cc, cc, ch), dev)
    n_inst = scene.num_instances
    if n_inst == 0:
        # every ray is a miss: one identity instance of volume 0 stands in
        inst_volume = torch.zeros(1, dtype=torch.int32, device=dev)
        inst_pos = torch.zeros((1, 3), device=dev)
        inst_rot = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=dev)
        inst_scale = torch.ones((1, 3), device=dev)
        n_inst = 1
    else:
        inst_volume, inst_pos = scene.inst_volume, scene.inst_pos
        inst_rot, inst_scale = scene.inst_rot, scene.inst_scale
        _check(inst_volume, "inst_volume", torch.int32, (n_inst,), dev)
        _check(inst_pos, "inst_pos", torch.float32, (n_inst, 3), dev)
        _check(inst_rot, "inst_rot", torch.float32, (n_inst, 4), dev)
        _check(inst_scale, "inst_scale", torch.float32, (n_inst, 3), dev)

    t = torch.empty(rays, dtype=torch.float32, device=dev)
    normal = torch.empty((rays, 3), dtype=torch.float32, device=dev)
    unlit = torch.empty(rays, dtype=torch.bool, device=dev)
    if rays == 0:
        return t, normal, unlit
    build()
    err = _lib.vrt_resolve_scene(
        o_w.data_ptr(), d_w.data_ptr(), inst.data_ptr(),
        hit.kind.data_ptr(), hit.t.data_ptr(), hit.cell.data_ptr(),
        hit.face_normal.data_ptr(), inst_volume.data_ptr(),
        inst_pos.data_ptr(), inst_rot.data_ptr(), inst_scale.data_ptr(),
        n_inst, vols.n.data_ptr(), vols.cell_size.data_ptr(),
        vols.extends.data_ptr(), vols.corners.data_ptr(), cc, ch,
        int(vols.corners.dtype == torch.bfloat16),
        int(load_path(vols.corners) == "v16"), rays, t.data_ptr(),
        normal.data_ptr(), unlit.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"fused resolve launch failed: cudaError {err}")
    LAUNCHES += 1
    return t, normal, unlit
