"""K4, the frame's shading: build, bind and launch ``vrt_torch/csrc/shade.cu``.

    shade_surface_cuda(scene, o_w, d_w, t, n_obj, hit, inst, mode, bounce,
                       shadows) -> SurfaceRecord
    shade_combine_cuda(scene, rec, d_w, n_obj, hit_mask, unlit_attr, refl_rgb,
                       blocked, mode, final) -> rgb f32 [R,3] | rgba f32 [R,4]

The two stages of one radiance level, one thread a ray: the surface kernel
runs between the level's resolve and the traces the level spawns (its shadow
rays, its mirror bounce) and writes the rays those traces take; the combine
kernel runs after them and, for the primary rays (``final``), tonemaps into
an [R,4] frame with alpha 1.  Their plain versions are
``vrt_torch.render.renderer.shade_surface_reference`` and
``shade_combine_reference``, which take the same arguments;
``renderer.shade_stages`` picks between the pairs.  The kernels record no
autograd graph and have no backward.

On hit lanes a kernel agrees with its plain version to rounding (built with
``--fmad=false`` in the plain version's operation order, but torch's own
reductions and ``pow`` may round otherwise).  On miss lanes the surface
record holds only what the level's traces take: the shadow origin, a closed
gate, ``t_max = -inf`` and, as mirror and shadow directions, the lane's own
direction; its material (``albedo``, ``n_w``, ``roughness``, ``metallic``,
``k``) is left unwritten there, and at a level that spawns no trace so is
the shadow origin.  The plain version holds values of a sanitised lane;
every reader discards either.

``LAUNCHES`` counts the launches of each kernel.
"""

from __future__ import annotations

import ctypes

import torch

from vrt_torch.kernels import _build
from vrt_torch.kernels.march import _check as _check_tensor
from vrt_torch.kernels.march import _stream
from vrt_torch.kernels.resolve import instance_table
from vrt_torch.march.types import MarchHit, SurfaceRecord
from vrt_torch.render.gpuscene import (MAX_POINT_LIGHTS, MAX_SPOT_LIGHTS,
                                       RenderMode)

LAUNCHES = {"surface": 0, "combine": 0}

NVCC_FLAGS = ["--fmad=false"]

_lib = None


def build() -> str:
    """Compile (when the library is missing) and load the two kernels.
    Returns the compiler's output, or "" when already built."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = _build.build("shade.cu", NVCC_FLAGS, headers=["scene.cuh"])
    for fn in (lib.vrt_shade_surface, lib.vrt_shade_combine):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    _lib = lib
    return log


def _check(x, name, dtype, shape, device):
    _check_tensor(x, name, dtype, shape, device, who="shade")


def _launch(fn, name, ptrs, ints, rays, dev):
    build()
    ptr_array = (ctypes.c_void_p * len(ptrs))(*ptrs)
    int_array = (ctypes.c_int * len(ints))(*(int(v) for v in ints))
    err = getattr(_lib, fn)(ptr_array, int_array, rays, _stream(dev))
    if err != 0:
        raise RuntimeError(f"shade {name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _light_ptrs(scene, dev):
    """The 15 pointers of the light tables, in the order of ``Lights`` in
    shade.cu, each table checked."""
    f32 = torch.float32
    p, s = MAX_POINT_LIGHTS, MAX_SPOT_LIGHTS
    tables = (("dir_light_dir", (3,)), ("dir_light_strength", ()),
              ("point_pos", (p, 3)), ("point_intensity", (p,)),
              ("point_att_l", (p,)), ("point_att_e", (p,)),
              ("point_color", (p, 4)), ("spot_pos", (s, 3)),
              ("spot_fwd", (s, 3)), ("spot_intensity", (s,)),
              ("spot_att_l", (s,)), ("spot_att_e", (s,)),
              ("spot_cos_angle", (s,)), ("spot_cos_falloff", (s,)),
              ("spot_color", (s, 4)))
    if not (0 <= scene.num_point <= p and 0 <= scene.num_spot <= s):
        raise ValueError(f"shade takes up to {p} point and {s} spot lights, "
                         f"got {scene.num_point} and {scene.num_spot}")
    ptrs = []
    for name, shape in tables:
        x = getattr(scene, name)
        _check(x, name, f32, shape, dev)
        ptrs.append(x.data_ptr())
    return ptrs


def shade_surface_cuda(scene, o_w, d_w, t, n_obj, hit: MarchHit, inst,
                       mode: RenderMode, bounce: bool,
                       shadows: bool) -> SurfaceRecord:
    """Launch the surface kernel on ``torch.cuda.current_stream()`` for the
    hits ``(hit, inst)`` of a march and the ``(t, n_obj)`` of their resolve
    on world rays ``o_w``, ``d_w``; reads ``hit.hit`` and, with per-voxel
    colours, ``hit.cell``.  ``bounce`` adds the mirror ray and its gate,
    ``shadows`` the level's shadow rays (both lit mode only).  Raises on any
    input the kernel does not take; never falls back."""
    if o_w.device.type != "cuda":
        raise ValueError(f"the surface kernel runs on CUDA tensors, got "
                         f"{o_w.device}")
    dev = o_w.device
    rays = o_w.shape[0]
    f32, i32 = torch.float32, torch.int32
    lit = bool(mode.lit)
    bounce, shadows = bool(bounce) and lit, bool(shadows) and lit
    _check(o_w, "o_w", f32, (rays, 3), dev)
    _check(d_w, "d_w", f32, (rays, 3), dev)
    _check(t, "t", f32, (rays,), dev)
    _check(n_obj, "n_obj", f32, (rays, 3), dev)
    _check(hit.hit, "hit.hit", torch.bool, (rays,), dev)
    _check(inst, "inst", i32, (rays,), dev)
    table, n_inst = instance_table(scene, dev, _check)
    vols = scene.volumes
    nv = vols.n.shape[0]
    _check(vols.n, "n", i32, (nv,), dev)
    _check(vols.cell_size, "cell_size", f32, (nv,), dev)
    _check(vols.extends, "extends", f32, (nv,), dev)
    _check(scene.tint, "tint", f32, (nv, 4), dev)
    _check(scene.tex_scale, "tex_scale", f32, (nv, 2), dev)
    for name in ("roughness", "metallic", "k"):
        _check(getattr(scene, name), name, f32, (nv,), dev)
    for name in ("albedo_tex", "normal_tex", "rm_tex"):
        _check(getattr(scene, name), name, i32, (nv,), dev)
    tex = scene.textures
    if tex.ndim != 4 or tex.shape[-1] != 3:
        raise ValueError(f"shade: textures have shape {tuple(tex.shape)}, "
                         f"expected [T,TH,TW,3]")
    _check(tex, "textures", f32, tex.shape, dev)
    _check(scene.tex_sizes, "tex_sizes", i32, (tex.shape[0], 2), dev)
    colors = scene.voxel_color_corners if scene.use_voxel_colors else None
    color_side = 0
    if scene.use_voxel_colors:
        if colors is None or colors.dtype not in (f32, torch.bfloat16):
            raise ValueError("shade: a scene with per-voxel colours needs "
                             "its corner-packed view, f32 or bf16")
        color_side = colors.shape[1]
        _check(colors, "voxel_color_corners", colors.dtype,
               (nv,) + (color_side,) * 3 + (8, 3), dev)
        _check(hit.cell, "hit.cell", i32, (rays, 3), dev)
    lights = _light_ptrs(scene, dev)
    n_shadow = scene.num_point + scene.num_spot

    def empty(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    rec = SurfaceRecord(albedo=empty(rays, 3))
    tmax = sdir = None
    if lit:
        rec.shadow_origin, rec.n_w = empty(rays, 3), empty(rays, 3)
        rec.roughness, rec.metallic, rec.k = (empty(rays), empty(rays),
                                              empty(rays))
    if bounce:
        rec.refl_dir, rec.gate = empty(rays, 3), empty(rays,
                                                       dtype=torch.bool)
    if shadows:
        tmax, sdir = empty(1 + n_shadow, rays), empty(n_shadow, rays, 3)
        rec.shadow_tmax = tuple(tmax[j] for j in range(1 + n_shadow))
        rec.shadow_dir = tuple(sdir[j] for j in range(n_shadow))
    if rays == 0:
        return rec

    def ptr(x):
        return None if x is None else x.data_ptr()

    ptrs = [o_w.data_ptr(), d_w.data_ptr(), t.data_ptr(), n_obj.data_ptr(),
            hit.hit.data_ptr(),
            hit.cell.data_ptr() if scene.use_voxel_colors else None,
            inst.data_ptr(), *(x.data_ptr() for x in table),
            vols.n.data_ptr(), vols.cell_size.data_ptr(),
            vols.extends.data_ptr(), scene.tint.data_ptr(),
            scene.roughness.data_ptr(), scene.metallic.data_ptr(),
            scene.k.data_ptr(), scene.tex_scale.data_ptr(),
            scene.albedo_tex.data_ptr(), scene.normal_tex.data_ptr(),
            scene.rm_tex.data_ptr(), tex.data_ptr(),
            scene.tex_sizes.data_ptr(), ptr(colors), *lights,
            rec.albedo.data_ptr(), ptr(rec.shadow_origin), ptr(rec.n_w),
            ptr(rec.roughness), ptr(rec.metallic), ptr(rec.k),
            ptr(rec.refl_dir), ptr(rec.gate), ptr(tmax), ptr(sdir)]
    ints = [n_inst, nv, tex.shape[0], tex.shape[1], tex.shape[2], color_side,
            colors is not None and colors.dtype == torch.bfloat16, lit,
            mode.textured, scene.use_voxel_colors, bounce, shadows,
            scene.num_point, scene.num_spot]
    _launch("vrt_shade_surface", "surface", ptrs, ints, rays, dev)
    return rec


def shade_combine_cuda(scene, rec: SurfaceRecord, d_w, n_obj, hit_mask,
                       unlit_attr, refl_rgb, blocked, mode: RenderMode,
                       final: bool = False):
    """Launch the combine kernel on ``torch.cuda.current_stream()``: the
    level's radiance from its surface record ``rec``, the bounce's radiance
    ``refl_rgb`` [R,3] (None without a bounce) and ``blocked``, one bool
    [R] per light from the shadow traces (the directional light's first;
    None where no shadow is traced).  Returns linear rgb [R,3], or with
    ``final`` the tonemapped [R,4] frame with alpha 1.  Raises on any input
    the kernel does not take; never falls back."""
    if d_w.device.type != "cuda":
        raise ValueError(f"the combine kernel runs on CUDA tensors, got "
                         f"{d_w.device}")
    dev = d_w.device
    rays = d_w.shape[0]
    f32 = torch.float32
    lit = bool(mode.lit)
    _check(d_w, "d_w", f32, (rays, 3), dev)
    _check(n_obj, "n_obj", f32, (rays, 3), dev)
    _check(hit_mask, "hit.hit", torch.bool, (rays,), dev)
    _check(unlit_attr, "unlit_attr", torch.bool, (rays,), dev)
    _check(rec.albedo, "albedo", f32, (rays, 3), dev)
    n_shadow = scene.num_point + scene.num_spot
    if lit:
        _check(rec.shadow_origin, "shadow_origin", f32, (rays, 3), dev)
        _check(rec.n_w, "n_w", f32, (rays, 3), dev)
        for name in ("roughness", "metallic", "k"):
            _check(getattr(rec, name), name, f32, (rays,), dev)
        if refl_rgb is not None:
            _check(refl_rgb, "refl_rgb", f32, (rays, 3), dev)
            _check(rec.refl_dir, "refl_dir", f32, (rays, 3), dev)
        if blocked is not None:
            if len(blocked) != 1 + n_shadow:
                raise ValueError(f"shade: {len(blocked)} shadow traces for "
                                 f"{1 + n_shadow} lights")
            for j, b in enumerate(blocked):
                _check(b, f"blocked[{j}]", torch.bool, (rays,), dev)
    else:
        refl_rgb = blocked = None
    env = scene.env
    if env.ndim != 4 or env.shape[0] != 6 or env.shape[1] != env.shape[2] \
            or env.shape[3] != 3:
        raise ValueError(f"shade: env has shape {tuple(env.shape)}, expected "
                         f"[6,E,E,3]")
    _check(env, "env", f32, env.shape, dev)
    lights = _light_ptrs(scene, dev)
    out = torch.empty((rays, 4 if final else 3), dtype=f32, device=dev)
    if rays == 0:
        return out

    def ptr(x):
        return None if x is None else x.data_ptr()

    shadow_ptrs = [None] * (1 + MAX_POINT_LIGHTS + MAX_SPOT_LIGHTS)
    if blocked is not None:
        # the directional light's, then the point and the spot lights'
        shadow_ptrs[0] = blocked[0].data_ptr()
        for j in range(n_shadow):
            shadow_ptrs[1 + j] = blocked[1 + j].data_ptr()
    ptrs = [d_w.data_ptr(), n_obj.data_ptr(), hit_mask.data_ptr(),
            unlit_attr.data_ptr(), rec.albedo.data_ptr(),
            ptr(rec.shadow_origin), ptr(rec.n_w), ptr(rec.roughness),
            ptr(rec.metallic), ptr(rec.k),
            ptr(rec.refl_dir) if refl_rgb is not None else None,
            ptr(refl_rgb), *shadow_ptrs, *lights, env.data_ptr(),
            out.data_ptr()]
    ints = [lit, final, scene.num_point, scene.num_spot, env.shape[1]]
    _launch("vrt_shade_combine", "combine", ptrs, ints, rays, dev)
    return out
