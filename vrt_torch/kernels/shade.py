"""K4, the frame's shading: build, bind and launch ``vrt_torch/csrc/shade.cu``.

    shade_surface_cuda(scene, o_w, d_w, t, n_obj, hit, inst, mode, bounce,
                       shadows) -> SurfaceRecord
    shade_combine_cuda(scene, rec, d_w, n_obj, hit_mask, unlit_attr, refl_rgb,
                       blocked, mode, final) -> rgb f32 [R,3] | rgba f32 [R,4]
    shade_surface_backward_cuda(scene, o_w, d_w, t, n_obj, hit, inst, mode,
                                bounce, cotangents)
        -> (g_o_w, g_d_w, g_t, g_n_obj,
            g_colors f32 [V*C^3, 24] (packed) | [V*N^3, 3] (voxel grid))
        (material=True: and of tint, roughness, metallic, k;
         textures=True: and of tex_scale, textures;
         instances=True: and of inst_pos, inst_rot, inst_scale)
    shade_combine_backward_cuda(scene, rec, d_w, n_obj, hit_mask, unlit_attr,
                                refl_rgb, blocked, mode, g_rgb)
        -> cotangents of the record's floats, d_w, n_obj and refl_rgb
        (lights=True: and of the record's k and the 15 light tables;
         env=True: and of the env cube)
    ShadeSurface.apply / ShadeCombine.apply: the two stages, differentiable

The two stages of one radiance level: the surface kernel runs between the
level's resolve and the traces the level spawns (its shadow rays, its mirror
bounce) and writes the rays those traces take; the combine kernel runs after
them and, for the primary rays (``final``), tonemaps into an [R,4] frame
with alpha 1.  Both forward kernels are their redesign (resident blocks
striding over the rays, a warp's flags and [32,3] spans in 16-byte words,
the surface's fetched into shared memory a round ahead, a surface warp
without a hit writing only its traces' rays); each launch takes the vector
path or the scalar path of the same kernel as ``shade_path`` says from the
tensors' addresses.  On the unpacked colour grid the surface takes
``surface_voxels_kernel`` instead (``surface_path``: one thread a ray, a
lane's inputs loaded at once, its 8 voxel rows' 24 loads together).  The
private
``_old_design`` launches the first design (one thread a ray over the whole
grid), the comparator of the timing runs, and ``_resident`` the resident
redesign on the unpacked grid too; every lane either writes is bit-equal
to the default's.  Their plain versions are
``vrt_torch.render.renderer.shade_surface_reference`` and
``shade_combine_reference``, which take the same arguments;
``renderer.shade_stages`` picks among the pairs.  The forward kernels
record no autograd graph; ``ShadeSurface`` and ``ShadeCombine`` add it,
with the two backward kernels (each recomputing its stage's terms from the
stage's inputs; the surface backward's blocks stride over the rays) as their
backward on CUDA tensors and the plain versions
``renderer.shade_surface_backward_reference`` /
``shade_combine_backward_reference`` (autograd of the plain stages) on CPU
tensors.  They return the gradient in the rays, ``t``, ``n_obj``, the
record's floats, the bounce's radiance and the colour table and, through
each backward kernel's variants, in the material constants
(``MATERIAL_FIELDS``: the surface backward's material variant), in the
record's ``k`` and the light tables (``LIGHT_FIELDS``: the combine
backward's light variant), in the texture scale and the stacked textures
(the surface backward's texture variant), in the env cube (the combine
backward's env variant) and in the instance transforms (``INSTANCE_FIELDS``:
the surface backward's instance variant); the wrappers launch a variant
only where one of those tables needs a gradient, and every other launch is
the default instantiation.

The colour table is the one ``gpuscene.color_table`` names, in one of two
layouts (``color_layout``): the corner-packed view, f32 or bf16 [V,N,N,N,8,3]
(one 24-channel row a hit cell; its cotangents go into an f32 [V*N^3, 24]
accumulator by 16-byte reductions, cast once to the table's dtype), or, above
``COLOR_CORNER_BUDGET_BYTES``, the f32 voxel grid [V,N,N,N,3] with N the
corner table's voxels a side (8 voxel rows of 3 a hit; their cotangents go
into an f32 [V*N^3, 3] accumulator by one f32 atomic a nonzero component,
and are the grid's gradient as they are).  Any other layout or dtype raises.

On hit lanes a kernel agrees with its plain version to rounding (built with
``--fmad=false`` in the plain version's operation order, but torch's own
reductions and ``pow`` may round otherwise).  On miss lanes the surface
record holds only what the level's traces take: the shadow origin, a closed
gate, ``t_max = -inf`` and, as mirror and shadow directions, the lane's own
direction; its material (``albedo``, ``n_w``, ``roughness``, ``metallic``,
``k``) is left unwritten there, and at a level that spawns no trace so is
the shadow origin.  The plain version holds values of a sanitised lane;
every reader discards either.

The backward kernels agree with their plain versions to rounding: they sum
in their own order, and the colour table's cotangents are added with f32
atomics in an order that changes from run to run.  Both write exact zeros
into every cotangent of a miss lane, whatever its record holds.

The combine backward has two designs too: the redesign (resident blocks
striding over the rays, the lights staged once a block, a warp's flags and
[32,3] spans in 16-byte words on the vector path, a warp without a hit
running the env lookup's backward alone and writing zero spans), the
default, on the path ``shade_path`` names for ``combine_bwd_vectors``; and
the first design (one thread a ray over the whole grid) behind
``_old_design``, bit-equal to it on every cotangent.

The texture and env variants sum their table's cotangents on one of two
paths, by the table's size alone (``table_path``): where it fits
``TEXTURE_SHARED_BYTES`` / ``ENV_SHARED_BYTES``, each block keeps partial
sums in shared memory and adds its nonzero words once ("shared"); else
the lanes add into the table's f32 accumulator ("global").  Each has two
designs.  The redesign, the default (``surface_bwd_textures_warp_kernel``,
``combine_bwd_env_warp_kernel``; the instance variant's texture path too):
a bilinear sample's four taps summed over the whole warp under the
sample's footprint, by one butterfly where every lane that adds shares it,
the texture variant's taps staged by the hit lanes and summed after their
code.  The first design, behind the private ``_old_table_design``, the
comparator of the timing runs: each tap merged on its own over the lanes
of a warp that name its texel, inside the lanes' code.  Both give the
default launch's per-ray cotangents bit for bit; their tables differ in
the order of the sums.

``LAUNCHES`` counts the launches of each kernel, ``PATH_LAUNCHES`` the
default launches of the forward pair and the combine backward again by
path (the surface's "voxels" on the unpacked grid), ``VARIANT_LAUNCHES``
the backward launches of the material, light and instance variants again,
``TABLE_LAUNCHES`` those of the texture and env variants by path and
``TABLE_DESIGN_LAUNCHES`` by design ("warp" the redesign, "first" the first
design; the instance variant's texture path counted as "warp") and
``SUMS_DESIGN_LAUNCHES`` the launches of the material variant without the
texture variant and of the instance variant by the design of their sums
("warp" the redesign, "first" the first design).
"""

from __future__ import annotations

import ctypes

import torch

from vrt_torch.kernels import _build
from vrt_torch.kernels.march import MAX_INSTANCES
from vrt_torch.kernels.march import _check as _check_tensor
from vrt_torch.kernels.march import _stream
from vrt_torch.kernels.resolve import (INSTANCE_WORDS, instance_grads,
                                       instance_table)
from vrt_torch.march.types import (RECORD_FIELDS, RECORD_GRAD_FIELDS,
                                    MarchHit, SurfaceRecord)
from vrt_torch.render.gpuscene import (INSTANCE_FIELDS, LIGHT_FIELDS,
                                       MATERIAL_FIELDS, MAX_POINT_LIGHTS,
                                       MAX_SPOT_LIGHTS, TEXTURE_FIELDS,
                                       RenderMode, color_table)

LAUNCHES = {"surface": 0, "combine": 0, "surface_bwd": 0, "combine_bwd": 0}
# the default launches again, by the path ``shade_path`` (the surface's
# ``surface_path``) named
PATH_LAUNCHES = {"surface v4": 0, "surface scalar": 0, "surface voxels": 0,
                 "combine v4": 0, "combine scalar": 0, "combine_bwd v4": 0,
                 "combine_bwd scalar": 0}
# the backward launches of the material and instance variants (the
# surface's) and of the light variant (the combine's) again
VARIANT_LAUNCHES = {"surface_bwd material": 0, "combine_bwd lights": 0,
                    "surface_bwd instances": 0}
# the backward launches of the texture variant (the surface's) and of the
# env variant (the combine's) again, by the path of their table's sums
TABLE_LAUNCHES = {"surface_bwd textures shared": 0,
                  "surface_bwd textures global": 0,
                  "combine_bwd env shared": 0, "combine_bwd env global": 0}
# and again by design: the redesign ("warp") or the first design
TABLE_DESIGN_LAUNCHES = {"surface_bwd textures warp": 0,
                         "surface_bwd textures first": 0,
                         "combine_bwd env warp": 0,
                         "combine_bwd env first": 0}
# the surface backward's launches of the material variant without the
# texture variant and of the instance variant again by the design of their
# sums: the redesign ("warp") or the first design
SUMS_DESIGN_LAUNCHES = {"surface_bwd sums warp": 0,
                        "surface_bwd sums first": 0}
# the largest stacked texture table and env cube whose cotangents a block
# sums in shared memory (csrc/shade.cu kTexSharedBytes, kEnvSharedBytes)
TEXTURE_SHARED_BYTES = 32 * 1024
ENV_SHARED_BYTES = 16 * 1024
# the pointers and ints the backward entry points read (csrc/shade.cu
# kSurfaceBwdPtrs, kSurfaceBwdInts, kCombineBwdPtrs, kCombineBwdInts)
SLOTS = {"vrt_shade_surface_bwd": (41, 20), "vrt_shade_combine_bwd": (52, 9)}

NVCC_FLAGS = ["--fmad=false"]

_lib = None


def build() -> str:
    """Compile (when the library is missing) and load the four kernels.
    Returns the compiler's output, or "" when already built."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = _build.build("shade.cu", NVCC_FLAGS, headers=["scene.cuh"])
    for fn in (lib.vrt_shade_surface, lib.vrt_shade_combine,
               lib.vrt_shade_surface_bwd, lib.vrt_shade_combine_bwd):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.vrt_shade_tap_census.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.vrt_shade_tap_census.restype = ctypes.c_int
    _lib = lib
    return log


def tap_census(reset: bool = True) -> list:
    """The texture and env variants' merges counted since the last reset,
    by the number of distinct keys among the lanes that add (index k: k
    keys, 0..32): counted only by a library built with the probe's
    ``kTapCensus`` (``vrt_torch.apps.probe_caps tex_env``); ``reset`` zeroes
    the counts.  Synchronises with the card."""
    build()
    out = (ctypes.c_ulonglong * 33)()
    err = _lib.vrt_shade_tap_census(ctypes.addressof(out), int(reset))
    if err != 0:
        raise RuntimeError(f"shade tap census failed: cudaError {err}")
    return list(out)


def _check(x, name, dtype, shape, device):
    _check_tensor(x, name, dtype, shape, device, who="shade")


def _launch(fn, name, ptrs, ints, rays, dev, path=None, variants=(),
            table=None, design="warp", sums=None):
    if fn in SLOTS and (len(ptrs), len(ints)) != SLOTS[fn]:
        raise ValueError(f"shade {name}: {len(ptrs)} pointers and "
                         f"{len(ints)} ints for {fn}, which reads "
                         f"{SLOTS[fn]}")
    build()
    ptr_array = (ctypes.c_void_p * len(ptrs))(*ptrs)
    int_array = (ctypes.c_int * len(ints))(*(int(v) for v in ints))
    err = getattr(_lib, fn)(ptr_array, int_array, rays, _stream(dev))
    if err != 0:
        raise RuntimeError(f"shade {name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    if path is not None:
        PATH_LAUNCHES[f"{name} {path}"] += 1
    for variant in variants:
        VARIANT_LAUNCHES[f"{name} {variant}"] += 1
    if table is not None:
        TABLE_LAUNCHES[f"{name} {table}"] += 1
        TABLE_DESIGN_LAUNCHES[f"{name} {table.split()[0]} {design}"] += 1
    if sums is not None:
        SUMS_DESIGN_LAUNCHES[f"{name} sums {sums}"] += 1


def table_path(table, budget: int) -> str:
    """Where a texture or env variant sums the cotangents of ``table``
    (the stacked textures or the env cube): "shared" where its f32 words
    fit ``budget`` bytes (``TEXTURE_SHARED_BYTES``, ``ENV_SHARED_BYTES``),
    else "global"."""
    return "shared" if table.numel() * 4 <= budget else "global"


def shade_path(tensors) -> str:
    """A redesign's path for a launch that moves ``tensors`` (the
    arrays it reads or writes in 16-byte words; None for absent ones):
    "v4" where every one starts on a 16-byte boundary, else "scalar" (the
    same kernel, every lane on its own 4-byte words).  Row j of the
    stacked shadow directions starts 12 j R bytes in: off a boundary from
    j = 1 where R is not a multiple of 4."""
    aligned = all(x.data_ptr() % 16 == 0 for x in tensors if x is not None)
    return "v4" if aligned else "scalar"


def surface_path(layout, tensors) -> str:
    """The path of a surface launch: "voxels" (``surface_voxels_kernel``)
    on the unpacked colour grid (``layout`` "voxels f32"), the fastest
    design measured there at every size; on a packed view, or without
    colours, ``shade_path`` of ``tensors`` (the resident kernel's vector or
    scalar path)."""
    return "voxels" if layout == "voxels f32" else shade_path(tensors)


def _design(old_design: bool, path: str) -> int:
    """The design int of ``vrt_shade_surface``, ``vrt_shade_combine`` and
    ``vrt_shade_combine_bwd``."""
    return 0 if old_design else {"v4": 2, "scalar": 1, "voxels": 3}[path]


def _empty(shape, dtype, dev):
    """An output of the forward kernels (a seam for the tests that check
    which lanes a kernel leaves unwritten)."""
    return torch.empty(shape, dtype=dtype, device=dev)


def _surface_record(rays, dev, lit, bounce, shadows, n_shadow):
    """The surface kernel's outputs for ``rays`` rays: (the record, its
    stacked shadow t_max [1+L,R] and directions [L,R,3], or None without
    shadows).  The record's shadow tuples are the rows of the two, as
    ``SurfaceRecord.pack`` hands them on."""
    f32 = torch.float32

    def empty(*shape, dtype=f32):
        return _empty(shape, dtype, dev)

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
    return rec, tmax, sdir


def surface_vectors(o_w, d_w, n_obj, hit_mask, rec: SurfaceRecord):
    """What the surface kernel moves in 16-byte words on the vector path:
    ``shade_path``'s tensors of a surface launch."""
    return [o_w, d_w, n_obj, hit_mask, rec.albedo, rec.shadow_origin,
            rec.n_w, rec.refl_dir, *(rec.shadow_dir or ())]


def combine_vectors(d_w, hit_mask, unlit_attr, out):
    """What the combine kernel moves in 16-byte words on the vector path."""
    return [d_w, hit_mask, unlit_attr, out]


def combine_bwd_vectors(d_w, g_rgb, hit_mask, unlit_attr, rec: SurfaceRecord,
                        refl_rgb, outs):
    """What the combine backward's redesign moves in 16-byte words on the
    vector path: the direction, the radiance's cotangent, the two flags (as
    4-byte words), the record's [R,3] floats, the mirror ray and its
    radiance where a bounce is passed, and every [R,3] cotangent it writes
    (``outs``, None where not asked)."""
    return [d_w, g_rgb, hit_mask, unlit_attr, rec.albedo, rec.shadow_origin,
            rec.n_w, rec.refl_dir if refl_rgb is not None else None, refl_rgb,
            *(g for g in outs if g is not None and g.ndim == 2)]


def light_shapes():
    """The shapes of the 15 light tables, in ``LIGHT_FIELDS`` order (the
    order of ``Lights`` in shade.cu)."""
    p, s = MAX_POINT_LIGHTS, MAX_SPOT_LIGHTS
    return dict(zip(LIGHT_FIELDS, ((3,), (), (p, 3), (p,), (p,), (p,),
                                   (p, 4), (s, 3), (s, 3), (s,), (s,), (s,),
                                   (s,), (s,), (s, 4))))


def _light_ptrs(scene, dev):
    """The 15 pointers of the light tables, in the order of ``Lights`` in
    shade.cu, each table checked."""
    p, s = MAX_POINT_LIGHTS, MAX_SPOT_LIGHTS
    if not (0 <= scene.num_point <= p and 0 <= scene.num_spot <= s):
        raise ValueError(f"shade takes up to {p} point and {s} spot lights, "
                         f"got {scene.num_point} and {scene.num_spot}")
    ptrs = []
    for name, shape in light_shapes().items():
        x = getattr(scene, name)
        _check(x, name, torch.float32, shape, dev)
        ptrs.append(x.data_ptr())
    return ptrs


def light_grads(acc):
    """The light tables' cotangents, a tuple in ``LIGHT_FIELDS`` order of
    views of the light variant's accumulator ``acc`` (f32, the 15 tables
    flattened one after another at their shapes)."""
    shapes = light_shapes().values()
    sizes = [int(torch.Size(shape).numel()) for shape in shapes]
    return tuple(x.view(shape) for x, shape in zip(acc.split(sizes), shapes))


def _ptr(x):
    return None if x is None else x.data_ptr()


# the colour table's layouts, as the surface kernels' ints[6] names them
COLOR_LAYOUTS = {"packed f32": 0, "packed bf16": 1, "voxels f32": 2}


def color_layout(scene) -> str | None:
    """The layout of the colour table the surface kernels sample (a key of
    ``COLOR_LAYOUTS``), None without per-voxel colours.  Raises on a table
    that neither layout takes."""
    table = color_table(scene)
    if table is None:
        if scene.use_voxel_colors:
            raise ValueError("shade: a scene with per-voxel colours has no "
                             "colour table")
        return None
    if scene.voxel_color_corners is not None:
        if table.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"shade: the corner-packed colours must be f32 "
                             f"or bf16, got {table.dtype}")
        return ("packed bf16" if table.dtype == torch.bfloat16
                else "packed f32")
    if table.dtype != torch.float32:
        raise ValueError(f"shade: the unpacked colour grid must be f32, got "
                         f"{table.dtype}")
    return "voxels f32"


def _surface_args(scene, o_w, d_w, t, n_obj, hit: MarchHit, inst,
                  mode: RenderMode, bounce: bool, shadows: bool, who: str):
    """Check what both surface kernels read.  Returns (device, rays, the
    colour table or None, the 25 input pointers, the 14 ints)."""
    if o_w.device.type != "cuda":
        raise ValueError(f"the {who} runs on CUDA tensors, got {o_w.device}")
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
    layout = color_layout(scene)
    colors = color_table(scene)
    color_side = 0
    if layout == "voxels f32":
        # the grid of the corner table's voxels, so that every corner the
        # valid mask keeps lies inside it
        color_side = vols.sdf.shape[-1]
        _check(colors, "voxel_colors", f32,
               (nv,) + (color_side,) * 3 + (3,), dev)
    elif layout is not None:
        color_side = colors.shape[1]
        _check(colors, "voxel_color_corners", colors.dtype,
               (nv,) + (color_side,) * 3 + (8, 3), dev)
    if layout is not None:
        _check(hit.cell, "hit.cell", i32, (rays, 3), dev)
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
            scene.tex_sizes.data_ptr(), _ptr(colors)]
    ints = [n_inst, nv, tex.shape[0], tex.shape[1], tex.shape[2], color_side,
            COLOR_LAYOUTS.get(layout, 0), lit, mode.textured,
            scene.use_voxel_colors, bounce, shadows, scene.num_point,
            scene.num_spot]
    return dev, rays, colors, ptrs, ints


def shade_surface_cuda(scene, o_w, d_w, t, n_obj, hit: MarchHit, inst,
                       mode: RenderMode, bounce: bool, shadows: bool,
                       _old_design: bool = False,
                       _resident: bool = False) -> SurfaceRecord:
    """Launch the surface kernel on ``torch.cuda.current_stream()`` for the
    hits ``(hit, inst)`` of a march and the ``(t, n_obj)`` of their resolve
    on world rays ``o_w``, ``d_w``; reads ``hit.hit`` and, with per-voxel
    colours, ``hit.cell``.  ``bounce`` adds the mirror ray and its gate,
    ``shadows`` the level's shadow rays (both lit mode only).  Records no
    autograd graph (``ShadeSurface`` adds it).  The kernel is the one on
    the path ``surface_path`` names: on the unpacked voxel grid
    ``surface_voxels_kernel``, else the resident redesign on the path
    ``shade_path`` names.  The private ``_old_design`` launches the first
    design and ``_resident`` the resident redesign on the unpacked grid too,
    the comparators of the timing runs.  Raises on any input the kernel
    does not take; never falls back."""
    if _old_design and _resident:
        raise ValueError("shade surface: one design, not both")
    dev, rays, _, ptrs, ints = _surface_args(
        scene, o_w, d_w, t, n_obj, hit, inst, mode, bounce, shadows,
        "surface kernel")
    lit, bounce, shadows = ints[7], ints[10], ints[11]
    lights = _light_ptrs(scene, dev)
    rec, tmax, sdir = _surface_record(rays, dev, lit, bounce, shadows,
                                      scene.num_point + scene.num_spot)
    if rays == 0:
        return rec
    ptrs += [*lights, rec.albedo.data_ptr(), _ptr(rec.shadow_origin),
             _ptr(rec.n_w), _ptr(rec.roughness), _ptr(rec.metallic),
             _ptr(rec.k), _ptr(rec.refl_dir), _ptr(rec.gate), _ptr(tmax),
             _ptr(sdir)]
    vectors = surface_vectors(o_w, d_w, n_obj, hit.hit, rec)
    path = shade_path(vectors) if _resident else surface_path(
        color_layout(scene), vectors)
    _launch("vrt_shade_surface", "surface", ptrs,
            ints + [_design(_old_design, path)], rays, dev,
            None if _old_design or _resident else path)
    return rec


def shade_surface_backward_cuda(scene, o_w, d_w, t, n_obj, hit: MarchHit,
                                inst, mode: RenderMode, bounce: bool,
                                cotangents, rays_grad: bool = True,
                                table_grad: bool = True,
                                _old_design: bool = False, g_k=None,
                                material: bool = False,
                                textures: bool = False,
                                instances: bool = False,
                                _old_table_design: bool = False,
                                _old_sums_design: bool = False):
    """Launch the surface kernel's backward on
    ``torch.cuda.current_stream()``: the cotangents of the record's
    ``RECORD_GRAD_FIELDS`` (albedo, shadow origin, world normal, roughness,
    metallic, mirror direction; each None for zero) pulled back to the rays,
    ``t``, ``n_obj`` and the colour table, from the surface kernel's own
    inputs (it recomputes the stage).  Returns (g_o_w, g_d_w f32 [R,3] or
    None without ``rays_grad``, g_t f32 [R], g_n_obj f32 [R,3], g_colors: an
    f32 accumulator zeroed here, [V*C^3, 24] for the packed view (added
    into by 16-byte atomics; the caller casts it to the table's dtype) or
    [V*N^3, 3] for the voxel grid (one f32 atomic a nonzero component), or
    None without per-voxel colours or ``table_grad``).  A miss lane gets
    zeros.  ``material`` launches the material variant, which also pulls
    ``g_k`` (the cotangent of the record's ``k``, f32 [R] or None) back and
    returns four more: the cotangents of the material constants
    (``MATERIAL_FIELDS``: tint [V,4], roughness, metallic, k [V]), views of
    one f32 [V,8] accumulator that each block adds its partial sums into.
    ``textures`` launches the texture variant (with ``material`` too, one
    launch of both), which returns two more: the cotangents of
    ``tex_scale`` [V,2] (each block's partial sums by volume, as the
    material's) and of the stacked ``textures`` [T,TH,TW,3] (f32, on the
    path ``table_path`` names; the padding of the stack stays zero).  In a
    mode without textures they are zeros, and no texture variant runs.
    ``instances`` launches the instance variant (with the material and the
    texture variant too, one launch of all), which returns three more: the
    cotangents of the instance transforms (``INSTANCE_FIELDS``, views of
    one f32 accumulator that each block adds its partial sums into:
    ``kernels.resolve.instance_grads``); a scene without instances gets
    empty ones and no instance variant.  The kernel is the merged design
    (resident blocks striding over the rays, the colour cotangents of a
    warp's lanes that share a row summed before the row's reductions); the
    private ``_old_design`` launches the first design, the comparator of
    the timing runs, which has no texture or instance variant.  The texture
    variant is its redesign (``surface_bwd_textures_warp_kernel``: the taps
    staged by the hit lanes and summed over the warp after their code); the
    private ``_old_table_design`` launches its first design
    (``surface_bwd_textures_kernel``), the comparator of the timing runs,
    with ``textures`` alone (the instance variant's texture path is the
    redesign's).  The material variant without the texture variant and the
    instance variant are their sums' redesign (``surface_bwd_sums_kernel``:
    a hit lane stages what its table cotangents follow from, which are
    formed after its code and summed over the warp into a warp's partial
    sums in shared memory; the entry point refuses a scene whose sums
    outgrow its shared memory); the private
    ``_old_sums_design`` launches their first design (the merged kernel's
    kMat instantiation, ``surface_bwd_instances_kernel``: each lane's
    cotangents carried through its code, merged by key and added by shared
    atomics), the comparator of the timing runs.  Both give the per-ray
    cotangents bit for bit; their tables differ in the order of the sums.
    Raises on any input the kernel does not take; never falls back."""
    if textures and _old_design:
        raise ValueError("shade: the surface backward's first design has no "
                         "texture variant")
    if _old_table_design and (not textures or instances):
        raise ValueError("shade: the texture variant's first design runs "
                         "with textures=True alone")
    if instances and _old_design:
        raise ValueError("shade: the surface backward's first design has no "
                         "instance variant")
    if _old_sums_design and (_old_design or not (
            instances or (material and not textures))):
        raise ValueError("shade: the sums' first design runs with the "
                         "instance variant or the material variant without "
                         "the texture variant")
    dev, rays, colors, ptrs, ints = _surface_args(
        scene, o_w, d_w, t, n_obj, hit, inst, mode, bounce, False,
        "surface kernel's backward")
    f32 = torch.float32
    cots = list(cotangents)
    if len(cots) != len(RECORD_GRAD_FIELDS):
        raise ValueError(f"shade: {len(cots)} cotangents for "
                         f"{RECORD_GRAD_FIELDS}")
    for name, g in zip(RECORD_GRAD_FIELDS, cots):
        if g is not None:
            _check(g, f"g_{name}", f32,
                   (rays,) if name in ("roughness", "metallic") else (rays, 3),
                   dev)
    if g_k is not None:
        if not material:
            raise ValueError("shade: g_k is read by the material variant only")
        _check(g_k, "g_k", f32, (rays,), dev)
    g_o_w = g_d_w = acc = mat = g_scale = g_tex = None
    if rays_grad:
        g_o_w = torch.empty((rays, 3), dtype=f32, device=dev)
        g_d_w = torch.empty((rays, 3), dtype=f32, device=dev)
    g_t = torch.empty(rays, dtype=f32, device=dev)
    g_n = torch.empty((rays, 3), dtype=f32, device=dev)
    if colors is not None and table_grad:
        ch = colors[0, 0, 0, 0].numel()     # 24 a packed row, 3 a voxel
        acc = torch.zeros((colors.numel() // ch, ch), dtype=f32, device=dev)
    if material:
        # tint 4, roughness, metallic, k and a word of padding a volume
        mat = torch.zeros((scene.tint.shape[0], 8), dtype=f32, device=dev)
    out = (g_o_w, g_d_w, g_t, g_n, acc)
    if material:
        out += (mat[:, :4], mat[:, 4], mat[:, 5], mat[:, 6])
    if textures:
        g_scale = torch.zeros(scene.tex_scale.shape, dtype=f32, device=dev)
        g_tex = torch.zeros(scene.textures.shape, dtype=f32, device=dev)
        out += (g_scale, g_tex)
    g_inst = None
    if instances:
        if scene.num_instances > MAX_INSTANCES:
            raise ValueError(f"shade: the instance variant takes up to "
                             f"{MAX_INSTANCES} instances, got "
                             f"{scene.num_instances}")
        g_inst = torch.zeros((scene.num_instances, INSTANCE_WORDS),
                             dtype=f32, device=dev)
        out += instance_grads(g_inst)
        # a scene without instances: every lane a miss, nothing to add
        instances = scene.num_instances > 0
    if rays == 0:
        return out
    ptrs += [_ptr(g) for g in cots] + [_ptr(g_o_w), _ptr(g_d_w),
                                       g_t.data_ptr(), g_n.data_ptr(),
                                       _ptr(acc), _ptr(g_k), _ptr(mat),
                                       _ptr(g_scale), _ptr(g_tex),
                                       _ptr(g_inst) if instances else None]
    # the texture variant is compiled for textured modes alone
    textures = textures and bool(mode.textured)
    first = _old_table_design and textures
    sums = None
    if not _old_design and (instances or (material and not textures)):
        sums = "first" if _old_sums_design else "warp"
    ints += [not _old_design, material, textures, instances, first,
             sums == "first"]
    _launch("vrt_shade_surface_bwd", "surface_bwd", ptrs, ints, rays, dev,
            variants=tuple(v for v, on in (("material", material),
                                           ("instances", instances)) if on),
            table=f"textures {table_path(g_tex, TEXTURE_SHARED_BYTES)}"
            if textures else None, design="first" if first else "warp",
            sums=sums)
    return out


def _combine_args(scene, rec: SurfaceRecord, d_w, n_obj, hit_mask,
                  unlit_attr, refl_rgb, blocked, mode: RenderMode,
                  final: bool, who: str):
    """Check what both combine kernels read.  Returns (device, rays, the 39
    input pointers, the 5 ints)."""
    if d_w.device.type != "cuda":
        raise ValueError(f"the {who} runs on CUDA tensors, got {d_w.device}")
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
    shadow_ptrs = [None] * (1 + MAX_POINT_LIGHTS + MAX_SPOT_LIGHTS)
    if blocked is not None:
        # the directional light's, then the point and the spot lights'
        shadow_ptrs[0] = blocked[0].data_ptr()
        for j in range(n_shadow):
            shadow_ptrs[1 + j] = blocked[1 + j].data_ptr()
    ptrs = [d_w.data_ptr(), n_obj.data_ptr(), hit_mask.data_ptr(),
            unlit_attr.data_ptr(), rec.albedo.data_ptr(),
            _ptr(rec.shadow_origin), _ptr(rec.n_w), _ptr(rec.roughness),
            _ptr(rec.metallic), _ptr(rec.k),
            _ptr(rec.refl_dir) if refl_rgb is not None else None,
            _ptr(refl_rgb), *shadow_ptrs, *lights, env.data_ptr()]
    ints = [lit, final, scene.num_point, scene.num_spot, env.shape[1]]
    return dev, rays, ptrs, ints


def shade_combine_cuda(scene, rec: SurfaceRecord, d_w, n_obj, hit_mask,
                       unlit_attr, refl_rgb, blocked, mode: RenderMode,
                       final: bool = False, _old_design: bool = False):
    """Launch the combine kernel on ``torch.cuda.current_stream()``: the
    level's radiance from its surface record ``rec``, the bounce's radiance
    ``refl_rgb`` [R,3] (None without a bounce) and ``blocked``, one bool
    [R] per light from the shadow traces (the directional light's first;
    None where no shadow is traced).  Returns linear rgb [R,3], or with
    ``final`` the tonemapped [R,4] frame with alpha 1.  Records no autograd
    graph (``ShadeCombine`` adds it).  The kernel is the redesign on the
    path ``shade_path`` names; the private ``_old_design`` launches the first
    design.  Raises on any input the kernel does not take; never falls
    back."""
    dev, rays, ptrs, ints = _combine_args(
        scene, rec, d_w, n_obj, hit_mask, unlit_attr, refl_rgb, blocked,
        mode, final, "combine kernel")
    out = _empty((rays, 4 if final else 3), torch.float32, dev)
    if rays == 0:
        return out
    path = shade_path(combine_vectors(d_w, hit_mask, unlit_attr, out))
    _launch("vrt_shade_combine", "combine", ptrs + [out.data_ptr()],
            ints + [_design(_old_design, path)], rays, dev,
            None if _old_design else path)
    return out


def shade_combine_backward_cuda(scene, rec: SurfaceRecord, d_w, n_obj,
                                hit_mask, unlit_attr, refl_rgb, blocked,
                                mode: RenderMode, g_rgb, needs=None,
                                _old_design: bool = False,
                                lights: bool = False, env: bool = False,
                                _old_table_design: bool = False):
    """Launch the combine kernel's backward on
    ``torch.cuda.current_stream()`` for the cotangent ``g_rgb`` [R,3] of the
    linear radiance (``final`` has no backward): returns the cotangents of
    the record's ``RECORD_GRAD_FIELDS``, then of ``d_w``, ``n_obj`` and
    ``refl_rgb``, f32, each None where that input is None or ``needs`` (nine
    booleans) says nobody needs it.  ``lights`` launches the light variant,
    which returns two more: the cotangent of the record's ``k`` (f32 [R];
    None unlit) and the light tables' (``light_grads``: a tuple in
    ``LIGHT_FIELDS`` order, views of one f32 accumulator that each block
    adds its partial sums into).  ``env`` launches the env variant (with
    ``lights`` too, one launch of both), which returns one more: the
    cotangent of the env cube [6,E,E,3] (f32, the four taps of each miss
    lane, on the path ``table_path`` names).  Recomputes the stage from its
    inputs; reads the record on hit lanes only.  The kernel is the redesign
    (resident blocks striding over the rays; a warp without a hit runs the
    env lookup's backward alone) on the path ``shade_path`` names for
    ``combine_bwd_vectors``; the private ``_old_design`` launches the first
    design (one thread a ray over the whole grid), the comparator of the
    timing runs, bit-equal on every per-ray cotangent, which has no env
    variant.  The env variant is its redesign
    (``combine_bwd_env_warp_kernel``: a warp's miss lanes' taps summed over
    the warp at once); the private ``_old_table_design`` launches its first
    design (``combine_bwd_env_kernel``), the comparator of the timing runs,
    with ``env`` alone.  Raises on any input the kernel does not take; never
    falls back."""
    if env and _old_design:
        raise ValueError("shade: the combine backward's first design has no "
                         "env variant")
    if _old_table_design and not env:
        raise ValueError("shade: the env variant's first design runs with "
                         "env=True alone")
    dev, rays, ptrs, ints = _combine_args(
        scene, rec, d_w, n_obj, hit_mask, unlit_attr, refl_rgb, blocked,
        mode, False, "combine kernel's backward")
    _check(g_rgb, "g_rgb", torch.float32, (rays, 3), dev)
    if not mode.lit:
        refl_rgb = None
    inputs = [getattr(rec, f) for f in RECORD_GRAD_FIELDS] + [d_w, n_obj,
                                                            refl_rgb]
    if refl_rgb is None:
        inputs[RECORD_GRAD_FIELDS.index("refl_dir")] = None
    needs = [True] * len(inputs) if needs is None else list(needs)
    outs = [None if x is None or not need
            else _empty(x.shape, torch.float32, dev)
            for x, need in zip(inputs, needs)]
    extra, g_k, acc = (), None, None
    if lights:
        if mode.lit:
            g_k = _empty((rays,), torch.float32, dev)
        acc = torch.zeros(sum(int(torch.Size(x).numel())
                              for x in light_shapes().values()),
                          dtype=torch.float32, device=dev)
        extra = (g_k, light_grads(acc))
    g_env = None
    if env:
        g_env = torch.zeros(scene.env.shape, dtype=torch.float32,
                            device=dev)
        extra += (g_env,)
    if rays == 0:
        if g_k is not None:
            g_k.zero_()
        return tuple(outs) + extra
    path = shade_path(combine_bwd_vectors(d_w, g_rgb, hit_mask, unlit_attr,
                                          rec, refl_rgb, outs))
    _launch("vrt_shade_combine_bwd", "combine_bwd",
            ptrs + [g_rgb.data_ptr()] + [_ptr(g) for g in outs]
            + [_ptr(g_k), _ptr(acc), _ptr(g_env)],
            ints + [_design(_old_design, path), lights, env,
                    _old_table_design], rays, dev,
            None if _old_design else path,
            ("lights",) if lights else (),
            f"env {table_path(g_env, ENV_SHARED_BYTES)}" if env else None,
            "first" if _old_table_design else "warp")
    return tuple(outs) + extra


def _own_tables(scene, names, tables, who):
    for name, x in zip(names, tables):
        if x is not getattr(scene, name):
            raise ValueError(f"{who}: {name} must be the scene's own table")


class ShadeSurface(torch.autograd.Function):
    """The surface stage with its gradient in ``o_w``, ``d_w``, ``t``,
    ``n_obj``, ``colors`` (the colour table the scene samples,
    ``gpuscene.color_table``: its corner-packed view, or the f32 voxel grid
    where it has none; None without per-voxel colours), the material
    constants ``tint``, ``roughness``, ``metallic`` and ``k``, the texture
    scale and the stacked textures ``tex_scale``, ``textures`` and the
    instance transforms ``inst_pos``, ``inst_rot``, ``inst_scale`` (the
    scene's own tables, passed apart so that autograd sees them): on CUDA
    tensors the surface kernel and its backward kernel (its material
    variant where a material constant needs a gradient, its texture variant
    where the texture scale or the textures do, its instance variant where
    a transform does; one launch of all that are asked), on CPU tensors the
    plain stage and its plain backward.  Returns ``SurfaceRecord.pack``'s
    tuple; ``gate`` and the shadow rays carry no gradient, nor does ``k``
    unless the scene's ``k`` needs one.  Saves the inputs alone (the
    backward recomputes the stage)."""

    @staticmethod
    def forward(ctx, o_w, d_w, t, n_obj, colors, tint, roughness, metallic,
                k, tex_scale, textures, inst_pos, inst_rot, inst_scale, scene,
                hit, inst, mode, bounce, shadows):
        if colors is not color_table(scene):
            raise ValueError("ShadeSurface: colors must be the colour table "
                             "the scene samples (gpuscene.color_table)")
        _own_tables(scene, MATERIAL_FIELDS + TEXTURE_FIELDS[:2]
                    + INSTANCE_FIELDS,
                    (tint, roughness, metallic, k, tex_scale, textures,
                     inst_pos, inst_rot, inst_scale), "ShadeSurface")
        if o_w.device.type == "cuda":
            rec = shade_surface_cuda(scene, o_w, d_w, t, n_obj, hit, inst,
                                     mode, bounce, shadows)
        else:
            from vrt_torch.render.renderer import shade_surface_reference

            # no graph is recorded inside forward
            rec = shade_surface_reference(scene, o_w, d_w, t, n_obj, hit,
                                          inst, mode, bounce, shadows)
        out = rec.pack()
        # the record's k carries a gradient only towards the scene's k
        grad_fields = RECORD_GRAD_FIELDS + (("k",) if ctx.needs_input_grad[8]
                                            else ())
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*(
            x for f, x in zip(RECORD_FIELDS + ("shadow_tmax", "shadow_dir"),
                              out)
            if x is not None and f not in grad_fields))
        ctx.save_for_backward(o_w, d_w, t, n_obj, colors, inst, hit.hit,
                              hit.cell)
        ctx.scene, ctx.mode, ctx.bounce = scene, mode, bounce
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        o_w, d_w, t, n_obj, colors, inst, hit_mask, cell = ctx.saved_tensors
        need = ctx.needs_input_grad
        cots = [grads[RECORD_FIELDS.index(f)] for f in RECORD_GRAD_FIELDS]
        g_k = grads[RECORD_FIELDS.index("k")]
        if all(g is None for g in cots) and g_k is None:
            return (None,) * 20
        hit = MarchHit(hit=hit_mask, t=None, kind=None, cell=cell, t_in=None,
                       t_out=None, face_normal=None)
        table_grad = colors is not None and need[4]
        material = any(need[5:9])
        textures = any(need[9:11])
        instances = any(need[11:14])
        if o_w.device.type == "cuda":
            args = (ctx.scene, o_w, d_w, t, n_obj, hit, inst, ctx.mode,
                    ctx.bounce, [None if g is None else g.contiguous()
                                 for g in cots], need[0] or need[1],
                    table_grad)
            # the default launch as it was, the variants with their own
            # arguments
            kwargs = {}
            if material:
                kwargs.update(g_k=None if g_k is None else g_k.contiguous(),
                              material=True)
            if textures:
                kwargs.update(textures=True)
            if instances:
                kwargs.update(instances=True)
            got = shade_surface_backward_cuda(*args, **kwargs)
        else:
            from vrt_torch.render.renderer import \
                shade_surface_backward_reference

            got = shade_surface_backward_reference(
                ctx.scene, o_w, d_w, t, n_obj, hit, inst, ctx.mode,
                ctx.bounce, cots, g_k=g_k, material=material,
                textures=textures, instances=instances)
        plain = o_w.device.type != "cuda"
        g_o_w, g_d_w, g_t, g_n, acc = got[:5]
        rest = iter(got[5:])

        def variant(on, n):
            # a variant's n cotangents, and the plain version's |terms|
            out = [next(rest) for _ in range(n)] if on else [None] * n
            if on and plain:
                next(rest)
            return out

        g_mat = variant(material, 4)
        g_tables = variant(textures, 2)
        g_inst = variant(instances, 3)
        g_colors = None
        if table_grad:
            # the voxel grid's accumulator is its f32 gradient as it is
            g_colors = acc.to(colors.dtype).reshape(colors.shape)
            del acc
        return (g_o_w if need[0] else None, g_d_w if need[1] else None,
                g_t if need[2] else None, g_n if need[3] else None,
                g_colors) + tuple(g if n else None for g, n in zip(
                    g_mat + g_tables + g_inst, need[5:14])) + (None,) * 6


class ShadeCombine(torch.autograd.Function):
    """The combine stage (linear rgb: the tonemap has no backward) with its
    gradient in the record's floats (``RECORD_GRAD_FIELDS``), ``d_w``,
    ``n_obj``, ``refl_rgb``, the record's ``k``, the 15 light tables
    (``LIGHT_FIELDS``) and the env cube ``env`` (the scene's own tables,
    passed apart so that autograd sees them): on CUDA tensors the combine
    kernel and its backward kernel (its light variant where ``k`` or a
    light needs a gradient, its env variant where the env does), on CPU
    tensors the plain stage and its plain backward.  The masks and the
    shadow traces' booleans carry no gradient.  Saves the inputs alone."""

    @staticmethod
    def forward(ctx, albedo, shadow_origin, n_w, roughness, metallic,
                refl_dir, d_w, n_obj, refl_rgb, k, *rest):
        light_tables = rest[:len(LIGHT_FIELDS)]
        env, scene, hit_mask, unlit_attr, blocked, mode = \
            rest[len(LIGHT_FIELDS):]
        _own_tables(scene, LIGHT_FIELDS + ("env",), light_tables + (env,),
                    "ShadeCombine")
        rec = SurfaceRecord(albedo=albedo, shadow_origin=shadow_origin,
                            n_w=n_w, roughness=roughness, metallic=metallic,
                            k=k, refl_dir=refl_dir)
        if d_w.device.type == "cuda":
            rgb = shade_combine_cuda(scene, rec, d_w, n_obj, hit_mask,
                                     unlit_attr, refl_rgb, blocked, mode,
                                     False)
        else:
            from vrt_torch.render.renderer import shade_combine_reference

            rgb = shade_combine_reference(scene, rec, d_w, n_obj, hit_mask,
                                          unlit_attr, refl_rgb, blocked, mode,
                                          False)
        blocked = list(blocked or ())
        ctx.save_for_backward(albedo, shadow_origin, n_w, roughness, metallic,
                              refl_dir, d_w, n_obj, refl_rgb, k, hit_mask,
                              unlit_attr, *blocked)
        ctx.shadowed = bool(blocked)
        ctx.scene, ctx.mode = scene, mode
        return rgb

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_rgb):
        saved = ctx.saved_tensors
        (albedo, shadow_origin, n_w, roughness, metallic, refl_dir, d_w,
         n_obj, refl_rgb, k, hit_mask, unlit_attr) = saved[:12]
        blocked = list(saved[12:]) if ctx.shadowed else None
        rec = SurfaceRecord(albedo=albedo, shadow_origin=shadow_origin,
                            n_w=n_w, roughness=roughness, metallic=metallic,
                            k=k, refl_dir=refl_dir)
        need = ctx.needs_input_grad[:9]
        lit_need = ctx.needs_input_grad[9:10 + len(LIGHT_FIELDS)]
        lights = any(lit_need)
        env = ctx.needs_input_grad[10 + len(LIGHT_FIELDS)]
        if d_w.device.type == "cuda":
            args = (ctx.scene, rec, d_w, n_obj, hit_mask, unlit_attr,
                    refl_rgb, blocked, ctx.mode, g_rgb.contiguous(), need)
            # the default launch as it was, the variants with their flags
            kwargs = {}
            if lights:
                kwargs.update(lights=True)
            if env:
                kwargs.update(env=True)
            grads = shade_combine_backward_cuda(*args, **kwargs)
        else:
            from vrt_torch.render.renderer import \
                shade_combine_backward_reference

            grads = shade_combine_backward_reference(
                ctx.scene, rec, d_w, n_obj, hit_mask, unlit_attr, refl_rgb,
                blocked, ctx.mode, g_rgb, lights=lights, env=env)
        extra = (grads[9], *grads[10]) if lights \
            else (None,) * len(lit_need)
        g_env = grads[-2 if d_w.device.type != "cuda" else -1] if env \
            else None
        return tuple(g if n else None for g, n in zip(grads[:9], need)) \
            + tuple(g if n else None for g, n in zip(extra, lit_need)) \
            + (g_env,) + (None,) * 5
