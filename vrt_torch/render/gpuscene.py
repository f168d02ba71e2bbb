"""Device-side scene state (port of ``vrt.render.gpuscene``).

One dataclass of stacked tensors on one device:

- volumes stacked over a leading V axis, padded to a common resolution,
- per-volume material constants (tint, roughness, metallic, k, texture
  ids and tiling),
- instances: volume index + rotate-scale-translate transform
  (world = diag(scale) . R(v) + position),
- light banks fixed at 5 point + 5 spot lights with Python-level counts,
- a texture atlas and an environment cube map,
- the per-voxel colour field (the fit's albedo) and its corner-packed view.

``build_scene`` assembles it from host data and ``scene_from_numpy``
rebuilds a ``vrt`` scene's state from its leaves, both on ``device``, which
defaults to the card (``"cuda"``): pass ``device="cpu"`` for CPU work.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from vrt_torch.core import quat as vq
from vrt_torch.march.types import FUSE_BUDGET_BYTES, DeviceVolume

MAX_POINT_LIGHTS = 5
MAX_SPOT_LIGHTS = 5


@dataclasses.dataclass(frozen=True)
class RenderMode:
    """The 8 pipeline variants as orthogonal flags."""

    interp: bool = True
    textured: bool = True
    lit: bool = True
    # draw collapsed-octree node bounds unlit red
    debug_overlay: bool = False

    @classmethod
    def from_enum(cls, mode: int) -> "RenderMode":
        """The reference's ``EVRenderMode``: 0 Interp, 1 Interp_Unlit,
        2 Interp_NoTex, 3 Interp_NoTex_Unlit, 4 Cube, 5 Cube_Unlit,
        6 Cube_NoTex, 7 Cube_NoTex_Unlit."""
        return cls(interp=mode < 4, textured=(mode % 4) < 2,
                   lit=(mode % 2) == 0)


@dataclasses.dataclass
class GPUScene:
    """Device scene; ``num_point``/``num_spot``/``any_reflective``/
    ``use_voxel_colors`` are Python values that shape the pipeline."""

    volumes: DeviceVolume           # stacked, leading axis V

    # per-volume geometry constants
    tint: torch.Tensor              # f32 [V,4]
    roughness: torch.Tensor         # f32 [V]
    metallic: torch.Tensor          # f32 [V]
    k: torch.Tensor                 # f32 [V]
    tex_scale: torch.Tensor         # f32 [V,2]
    albedo_tex: torch.Tensor        # i32 [V]
    normal_tex: torch.Tensor        # i32 [V]
    rm_tex: torch.Tensor            # i32 [V]

    # instances (TLAS entries)
    inst_volume: torch.Tensor       # i32 [I]
    inst_pos: torch.Tensor          # f32 [I,3]
    inst_rot: torch.Tensor          # f32 [I,4] quaternion
    inst_scale: torch.Tensor        # f32 [I,3]
    inst_active: torch.Tensor       # bool [I]

    # camera
    cam_pos: torch.Tensor           # f32 [3]
    cam_rot: torch.Tensor           # f32 [4]
    cam_fov: torch.Tensor           # f32 [] vertical fov degrees

    # directional light
    dir_light_dir: torch.Tensor     # f32 [3]
    dir_light_strength: torch.Tensor  # f32 []

    # point lights
    point_color: torch.Tensor       # f32 [5,4]
    point_intensity: torch.Tensor   # f32 [5]
    point_att_l: torch.Tensor       # f32 [5]
    point_att_e: torch.Tensor       # f32 [5]
    point_pos: torch.Tensor         # f32 [5,3]

    # spot lights
    spot_color: torch.Tensor        # f32 [5,4]
    spot_intensity: torch.Tensor    # f32 [5]
    spot_att_l: torch.Tensor        # f32 [5]
    spot_att_e: torch.Tensor        # f32 [5]
    spot_cos_angle: torch.Tensor    # f32 [5]
    spot_cos_falloff: torch.Tensor  # f32 [5]
    spot_pos: torch.Tensor          # f32 [5,3]
    spot_fwd: torch.Tensor          # f32 [5,3]

    # textures
    textures: torch.Tensor          # f32 [T,TH,TW,3]
    tex_sizes: torch.Tensor         # i32 [T,2] (h,w)
    env: torch.Tensor               # f32 [6,E,E,3]

    # per-voxel colour field (the fit's albedo; dummy [V,1,1,1,3] when
    # unused) and its corner-packed view (``pack_voxel_color_corners``,
    # None when unused), kept in sync by ``vrt_torch.diff.fit``
    voxel_colors: torch.Tensor = None               # f32 [V,N,N,N,3]
    voxel_color_corners: torch.Tensor | None = None  # [V,N,N,N,8,3]

    num_point: int = 0
    num_spot: int = 0
    any_reflective: bool = False
    use_voxel_colors: bool = False

    @property
    def num_instances(self) -> int:
        return self.inst_volume.shape[0]


def pack_voxel_color_corners(colors, dtype=None):
    """[V,N,N,N,3] per-voxel colours -> [V,N,N,N,8,3] per-cell corner rows
    (``CORNERS`` order) over one zero pad plane, so the trilinear albedo
    sample reads one 24-channel row per hit cell and its backward scatters
    one.  Corners in the pad plane read zero, as the per-corner valid mask
    of an unpacked sample would give.  numpy in, CPU tensor out; a tensor
    in gives a tensor on its device, differentiable in ``colors``.
    ``dtype`` defaults to the colours' own."""
    from vrt_torch.march.isosurface import CORNERS

    if not isinstance(colors, torch.Tensor):
        colors = torch.from_numpy(np.asarray(colors))
    n = colors.shape[1]
    cp = torch.nn.functional.pad(colors, (0, 0, 0, 1, 0, 1, 0, 1))
    chans = [cp[:, dx:dx + n, dy:dy + n, dz:dz + n] for dx, dy, dz in CORNERS]
    return torch.stack(chans, dim=-2).to(dtype or colors.dtype)


def _default_textures():
    """Slot 0 = 1x1 white (albedo/RM default), slot 1 = flat normal."""
    tex = np.ones((2, 1, 1, 3), np.float32)
    tex[1, 0, 0] = (0.5, 0.5, 1.0)
    return tex, np.ones((2, 2), np.int32)


def build_scene(volumes: Sequence,  # VoxelVolume
                instances: Sequence[dict],
                camera: dict,
                dir_light: dict | None = None,
                point_lights: Sequence[dict] = (),
                spot_lights: Sequence[dict] = (),
                env: np.ndarray | None = None,
                textures: np.ndarray | None = None,
                tex_sizes: np.ndarray | None = None,
                texture_ids: Sequence[tuple] | None = None,
                voxel_colors: np.ndarray | None = None,
                accel_mode: str = "octree",
                march_dtype: torch.dtype | None = None,
                device: torch.device | str = "cuda") -> GPUScene:
    """Assemble a GPUScene from host data on ``device``.

    instances: dicts {volume: int, position, rotation(quat xyzw), scale}.
    camera: {position, rotation, fov} (fov degrees, default 60).
    dir_light: {rotation or direction, strength}.
    point/spot light dicts mirror the reference's light fields; spot angles
    become half-angle cosines cos(angle/2), cos(falloff/2).
    voxel_colors: [V,N,N,N,3] per-voxel albedo, which replaces tint *
    texture; always corner-packed, in ``march_dtype``.
    """
    if not volumes:
        raise ValueError("a scene needs at least one volume")
    n_max = max(v.n_voxels for v in volumes)
    # volumes stack into one table, so they share the fold budget
    budget = FUSE_BUDGET_BYTES // len(volumes)
    dvs = [DeviceVolume.from_volume(v, pad_to=n_max, accel_mode=accel_mode,
                                    march_dtype=march_dtype,
                                    fuse_budget_bytes=budget, device=device)
           for v in volumes]
    stacked = DeviceVolume(
        **{f.name: torch.stack([getattr(dv, f.name) for dv in dvs])
           for f in dataclasses.fields(DeviceVolume)
           if f.name != "accel_mode"},
        accel_mode=accel_mode)

    vcount = len(volumes)
    tint = np.zeros((vcount, 4), np.float32)
    rough = np.zeros(vcount, np.float32)
    metal = np.zeros(vcount, np.float32)
    kk = np.zeros(vcount, np.float32)
    tsc = np.ones((vcount, 2), np.float32)
    a_tex = np.zeros(vcount, np.int32)
    n_tex = np.ones(vcount, np.int32)
    rm_tex = np.zeros(vcount, np.int32)
    for i, v in enumerate(volumes):
        m = v.material
        tint[i] = m.albedo
        rough[i] = m.roughness
        metal[i] = m.metallic
        kk[i] = m.k
        tsc[i] = m.texture_scale
        if texture_ids is not None:
            a_tex[i], n_tex[i], rm_tex[i] = texture_ids[i]

    n_inst = len(instances)
    iv = np.zeros(n_inst, np.int32)
    ipos = np.zeros((n_inst, 3), np.float32)
    irot = np.tile(vq.IDENTITY, (n_inst, 1))
    iscl = np.ones((n_inst, 3), np.float32)
    for i, inst in enumerate(instances):
        iv[i] = inst["volume"]
        ipos[i] = inst.get("position", (0, 0, 0))
        irot[i] = inst.get("rotation", vq.IDENTITY)
        iscl[i] = inst.get("scale", (1, 1, 1))

    cam_rot = np.asarray(camera.get("rotation", vq.IDENTITY), np.float32)
    cam_pos = np.asarray(camera.get("position", (0, 0, 0)), np.float32)
    cam_fov = np.float32(camera.get("fov", 60.0))

    if dir_light is None:
        dl_dir = np.asarray(vq.FORWARD, np.float32)
        dl_strength = np.float32(0.0)
    else:
        if "direction" in dir_light:
            dl_dir = np.asarray(dir_light["direction"], np.float32)
        else:
            dl_dir = np.asarray(vq.forward_vector(
                np.asarray(dir_light["rotation"], np.float32)), np.float32)
        dl_strength = np.float32(dir_light.get("strength", 0.0))

    pc = np.zeros((MAX_POINT_LIGHTS, 4), np.float32)
    pi = np.zeros(MAX_POINT_LIGHTS, np.float32)
    pal = np.zeros(MAX_POINT_LIGHTS, np.float32)
    pae = np.zeros(MAX_POINT_LIGHTS, np.float32)
    pp = np.zeros((MAX_POINT_LIGHTS, 3), np.float32)
    for i, pl in enumerate(point_lights[:MAX_POINT_LIGHTS]):
        pc[i] = pl.get("color", (1, 1, 1, 1))
        pi[i] = pl.get("intensity", 1.0)
        pal[i] = pl.get("att_linear", 0.5)
        pae[i] = pl.get("att_exp", 0.005)
        pp[i] = pl.get("position", (0, 0, 0))

    sc = np.zeros((MAX_SPOT_LIGHTS, 4), np.float32)
    si = np.zeros(MAX_SPOT_LIGHTS, np.float32)
    sal = np.zeros(MAX_SPOT_LIGHTS, np.float32)
    sae = np.zeros(MAX_SPOT_LIGHTS, np.float32)
    sca = np.zeros(MAX_SPOT_LIGHTS, np.float32)
    scf = np.zeros(MAX_SPOT_LIGHTS, np.float32)
    sp = np.zeros((MAX_SPOT_LIGHTS, 3), np.float32)
    sf = np.zeros((MAX_SPOT_LIGHTS, 3), np.float32)
    for i, sl in enumerate(spot_lights[:MAX_SPOT_LIGHTS]):
        sc[i] = sl.get("color", (1, 1, 1, 1))
        si[i] = sl.get("intensity", 1.0)
        sal[i] = sl.get("att_linear", 0.5)
        sae[i] = sl.get("att_exp", 0.005)
        angle = np.deg2rad(sl.get("angle", 45.0))
        falloff = np.deg2rad(sl.get("falloff", 20.0))
        sca[i] = np.cos(angle / 2.0)
        scf[i] = np.cos(falloff / 2.0)
        sp[i] = sl.get("position", (0, 0, 0))
        if "forward" in sl:
            sf[i] = sl["forward"]
        else:
            sf[i] = np.asarray(vq.forward_vector(
                np.asarray(sl.get("rotation", vq.IDENTITY), np.float32)),
                np.float32)

    if textures is None:
        tex, sizes = _default_textures()
    else:
        tex = np.asarray(textures, np.float32)
        sizes = np.asarray(tex_sizes, np.int32)

    if env is None:
        env = np.zeros((6, 1, 1, 3), np.float32)

    def dev(x, dtype=None):
        x = np.asarray(x) if dtype is None else np.asarray(x, dtype)
        return torch.as_tensor(x).to(device)

    return GPUScene(
        volumes=stacked,
        tint=dev(tint), roughness=dev(rough), metallic=dev(metal), k=dev(kk),
        tex_scale=dev(tsc), albedo_tex=dev(a_tex), normal_tex=dev(n_tex),
        rm_tex=dev(rm_tex),
        inst_volume=dev(iv), inst_pos=dev(ipos),
        inst_rot=dev(irot, np.float32), inst_scale=dev(iscl),
        inst_active=dev(np.ones(n_inst, bool)),
        cam_pos=dev(cam_pos), cam_rot=dev(cam_rot), cam_fov=dev(cam_fov),
        dir_light_dir=dev(dl_dir), dir_light_strength=dev(dl_strength),
        point_color=dev(pc), point_intensity=dev(pi), point_att_l=dev(pal),
        point_att_e=dev(pae), point_pos=dev(pp),
        spot_color=dev(sc), spot_intensity=dev(si), spot_att_l=dev(sal),
        spot_att_e=dev(sae), spot_cos_angle=dev(sca),
        spot_cos_falloff=dev(scf), spot_pos=dev(sp), spot_fwd=dev(sf),
        textures=dev(tex, np.float32), tex_sizes=dev(sizes, np.int32),
        env=dev(env, np.float32),
        voxel_colors=(dev(voxel_colors, np.float32) if voxel_colors is not None
                      else torch.zeros((vcount, 1, 1, 1, 3), device=device)),
        voxel_color_corners=(
            pack_voxel_color_corners(np.asarray(voxel_colors, np.float32),
                                     march_dtype).to(device)
            if voxel_colors is not None else None),
        use_voxel_colors=voxel_colors is not None,
        num_point=min(len(point_lights), MAX_POINT_LIGHTS),
        num_spot=min(len(spot_lights), MAX_SPOT_LIGHTS),
        any_reflective=bool(any(v.material.roughness < 0.3
                                for v in volumes)))


def _to_tensor(x, device) -> torch.Tensor:
    """numpy -> tensor on ``device``; bf16 arrays (the ml_dtypes dtype,
    which ``torch.from_numpy`` refuses) go through their 16-bit words."""
    x = np.array(x)  # a writable, contiguous copy
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(x).to(device)


_STATIC = ("num_point", "num_spot", "any_reflective", "use_voxel_colors")


def scene_from_numpy(fields: dict, device: torch.device | str = "cuda"
                     ) -> GPUScene:
    """Build a GPUScene from the leaves of a ``vrt`` GPUScene.

    ``fields`` maps each field name of ``GPUScene`` to a numpy array, the
    static fields to Python values, and ``"volumes"`` to a dict of the
    ``DeviceVolume`` fields (``accel_mode`` a string).  A scene with
    per-voxel colours whose corner-packed view ``vrt`` left out (it packs
    under a size budget) gets one packed here, in the corner table's dtype:
    the port always samples the packed view."""
    vf = fields["volumes"]
    if vf.get("corners") is None:
        raise ValueError("the port marches the packed corner table; the "
                         "scene has none")
    vols = DeviceVolume(
        **{f.name: _to_tensor(vf[f.name], device)
           for f in dataclasses.fields(DeviceVolume)
           if f.name != "accel_mode"},
        accel_mode=vf["accel_mode"])
    kw = {}
    for f in dataclasses.fields(GPUScene):
        if f.name == "volumes":
            continue
        if f.name in _STATIC:
            kw[f.name] = type(f.default)(fields[f.name])
        elif fields[f.name] is not None:
            kw[f.name] = _to_tensor(fields[f.name], device)
    if kw["use_voxel_colors"] and "voxel_color_corners" not in kw:
        kw["voxel_color_corners"] = pack_voxel_color_corners(
            kw["voxel_colors"], vols.corners.dtype)
    return GPUScene(volumes=vols, **kw)
