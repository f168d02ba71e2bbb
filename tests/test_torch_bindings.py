"""The ctypes bindings of the port's CUDA libraries against their C
prototypes.

Each ``vrt_torch.kernels`` module loads its library with ``_build.build``
and sets the ``argtypes`` of every entry point.  An entry whose argtypes
miss a C parameter passes the parameters after it with ctypes' default
conversion (a pointer as a 4-byte int), which shows only on the card, and
there only where the value does not fit: a stream other than the default
one.  These tests build nothing: ``_build.build`` is replaced by a stub that
records what each module binds, and the binding is held against the
``extern "C"`` prototype in the module's source, parameter by parameter.
"""

from __future__ import annotations

import ctypes
import importlib
import re
import types

import pytest

from vrt_torch.kernels import _build

MODULES = ("accel", "gather", "march", "optim", "pack", "resolve", "rows",
           "shade")

# a C parameter's type (without its name) -> the ctypes type it takes
_SCALARS = {"int": ctypes.c_int, "int32_t": ctypes.c_int,
            "unsigned int": ctypes.c_uint, "long long": ctypes.c_longlong,
            "int64_t": ctypes.c_longlong, "float": ctypes.c_float}


def _ctype(param: str):
    """The ctypes type of one C parameter, written as in the source."""
    if "*" in param:
        return ctypes.c_void_p
    words = param.replace("const ", "").split()
    return _SCALARS[" ".join(words[:-1])]


def prototypes(source: str) -> dict:
    """The ``extern "C"`` functions of ``csrc/<source>``: name -> (return
    type, [ctypes type of each parameter])."""
    text = (_build.CSRC / source).read_text()
    out = {}
    for ret, name, params in re.findall(
            r'extern "C" (\w+) (\w+)\(([^)]*)\)', text):
        params = " ".join(params.split())
        out[name] = (ret, [_ctype(p.strip()) for p in params.split(",")])
    return out


class _Entry(types.SimpleNamespace):
    pass


class _Library:
    """What a module binds: each attribute it reads is an entry point whose
    ``argtypes`` and ``restype`` it may set."""

    def __init__(self):
        self.entries = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.entries.setdefault(name, _Entry(argtypes=None,
                                                    restype=ctypes.c_int))


def _bound(monkeypatch, name):
    """Run ``vrt_torch.kernels.<name>.build`` against the stub: (source,
    {entry: (argtypes, restype)})."""
    mod = importlib.import_module(f"vrt_torch.kernels.{name}")
    built = {}

    def stub(source, extra_flags=(), headers=()):
        built["source"] = source
        built["lib"] = _Library()
        return built["lib"], ""

    monkeypatch.setattr(_build, "build", stub)
    monkeypatch.setattr(mod, "_lib", None)
    mod.build()
    entries = built["lib"].entries
    return built["source"], {k: (e.argtypes, e.restype)
                             for k, e in entries.items()}


@pytest.mark.parametrize("name", MODULES)
def test_every_entry_point_is_bound_as_its_prototype(monkeypatch, name):
    """Every ``extern "C"`` function of the module's source is bound, with
    one ctypes type for each C parameter, of its kind (pointer, int, long
    long, float), and an int result."""
    source, bound = _bound(monkeypatch, name)
    protos = prototypes(source)
    assert protos, source
    assert sorted(bound) == sorted(protos)
    for fn, (ret, params) in protos.items():
        argtypes, restype = bound[fn]
        assert argtypes is not None, fn
        assert list(argtypes) == params, (
            f"{fn}: bound {len(argtypes)} argtypes, the prototype has "
            f"{len(params)} parameters")
        assert ret == "int" and restype is ctypes.c_int, fn


def test_prototype_parser_reads_each_kind():
    """``_ctype`` tells pointers, ints, 64-bit ints and floats apart."""
    assert _ctype("const void* const* ptrs") is ctypes.c_void_p
    assert _ctype("unsigned int* ticket") is ctypes.c_void_p
    assert _ctype("long long rays") is ctypes.c_longlong
    assert _ctype("int planes") is ctypes.c_int
    assert _ctype("float neg_lr") is ctypes.c_float


def _source_ints(source: str, names) -> dict:
    """The values of the ``constexpr int`` constants ``names`` of
    ``csrc/<source>`` (integer expressions)."""
    text = (_build.CSRC / source).read_text()
    out = {}
    for name in names:
        m = re.search(rf"\b{name} = ([0-9 *]+)[,;]", text)
        assert m is not None, name
        out[name] = eval(m.group(1))
    return out


def test_shade_backward_slots_are_the_sources():
    """The pointer and int slots each shade backward entry point reads
    (``kSurfaceBwdPtrs``, ``kSurfaceBwdInts``, ``kCombineBwdPtrs``,
    ``kCombineBwdInts`` in ``csrc/shade.cu``: the texture, env and instance
    variants' accumulators and flags last) are the ones
    ``kernels.shade.SLOTS`` holds every launch to, and the texture and env
    variants' shared-memory budgets are the wrapper's (``table_path``)."""
    from vrt_torch.kernels import shade as k4

    got = _source_ints("shade.cu", (
        "kSurfaceBwdPtrs", "kSurfaceBwdInts", "kCombineBwdPtrs",
        "kCombineBwdInts", "kTexSharedBytes", "kEnvSharedBytes"))
    assert k4.SLOTS == {
        "vrt_shade_surface_bwd": (got["kSurfaceBwdPtrs"],
                                  got["kSurfaceBwdInts"]),
        "vrt_shade_combine_bwd": (got["kCombineBwdPtrs"],
                                  got["kCombineBwdInts"])}
    assert k4.TEXTURE_SHARED_BYTES == got["kTexSharedBytes"]
    assert k4.ENV_SHARED_BYTES == got["kEnvSharedBytes"]


@pytest.mark.parametrize("fn", ["vrt_shade_surface_bwd",
                                "vrt_shade_combine_bwd"])
@pytest.mark.parametrize("short", ["ptrs", "ints"])
def test_shade_launch_refuses_short_slots(monkeypatch, fn, short):
    """A launch of a shade backward entry point with a pointer or an int
    too few raises before anything is built or launched."""
    from vrt_torch.kernels import shade as k4

    monkeypatch.setattr(k4, "build", lambda: pytest.fail("built"))
    ptrs, ints = k4.SLOTS[fn]
    if short == "ptrs":
        ptrs -= 1
    else:
        ints -= 1
    with pytest.raises(ValueError, match="reads"):
        k4._launch(fn, "surface_bwd", [None] * ptrs, [0] * ints, 1, None)


def test_shade_launch_counts_variants_and_table_paths(monkeypatch):
    """``_launch`` against a library that runs nothing: each launch counted
    once in ``LAUNCHES``, a material or light variant's again in
    ``VARIANT_LAUNCHES`` and a texture or env variant's in
    ``TABLE_LAUNCHES`` by its path and in ``TABLE_DESIGN_LAUNCHES`` by its
    design (the redesign unless the first is named), a launch of the sums'
    designs in ``SUMS_DESIGN_LAUNCHES`` by the one named; the pointers and
    ints reach the entry point as passed."""
    from vrt_torch.kernels import shade as k4

    seen = []

    class Library:
        def __getattr__(self, name):
            return lambda ptrs, ints, rays, stream: seen.append(
                (name, len(ptrs), list(ints), rays)) or 0

    monkeypatch.setattr(k4, "build", lambda: "")
    monkeypatch.setattr(k4, "_lib", Library())
    monkeypatch.setattr(k4, "_stream", lambda dev: None)
    for name in ("LAUNCHES", "PATH_LAUNCHES", "VARIANT_LAUNCHES",
                 "TABLE_LAUNCHES", "TABLE_DESIGN_LAUNCHES",
                 "SUMS_DESIGN_LAUNCHES"):
        monkeypatch.setattr(k4, name, dict.fromkeys(getattr(k4, name), 0))
    ptrs, ints = k4.SLOTS["vrt_shade_surface_bwd"]
    k4._launch("vrt_shade_surface_bwd", "surface_bwd", [None] * ptrs,
               [0] * ints, 7, None, variants=("material",),
               table="textures global")
    ptrs, ints = k4.SLOTS["vrt_shade_combine_bwd"]
    k4._launch("vrt_shade_combine_bwd", "combine_bwd", [None] * ptrs,
               list(range(ints)), 7, None, "v4", ("lights",), "env shared",
               "first")
    assert seen == [("vrt_shade_surface_bwd", 41, [0] * 20, 7),
                    ("vrt_shade_combine_bwd", 52, list(range(9)), 7)]
    assert k4.LAUNCHES == dict(surface=0, combine=0, surface_bwd=1,
                               combine_bwd=1)
    assert {k: v for k, v in k4.PATH_LAUNCHES.items() if v} == {
        "combine_bwd v4": 1}
    assert k4.VARIANT_LAUNCHES == {"surface_bwd material": 1,
                                   "combine_bwd lights": 1,
                                   "surface_bwd instances": 0}
    assert k4.TABLE_LAUNCHES == {"surface_bwd textures shared": 0,
                                 "surface_bwd textures global": 1,
                                 "combine_bwd env shared": 1,
                                 "combine_bwd env global": 0}
    assert k4.TABLE_DESIGN_LAUNCHES == {"surface_bwd textures warp": 1,
                                        "surface_bwd textures first": 0,
                                        "combine_bwd env warp": 0,
                                        "combine_bwd env first": 1}
    # a launch of the texture variant has no sums design of its own
    assert k4.SUMS_DESIGN_LAUNCHES == {"surface_bwd sums warp": 0,
                                       "surface_bwd sums first": 0}
    ptrs, ints = k4.SLOTS["vrt_shade_surface_bwd"]
    k4._launch("vrt_shade_surface_bwd", "surface_bwd", [None] * ptrs,
               [0] * ints, 7, None, variants=("instances",), sums="first")
    assert k4.SUMS_DESIGN_LAUNCHES == {"surface_bwd sums warp": 0,
                                       "surface_bwd sums first": 1}


def test_instance_variants_sizes_are_the_sources():
    """The instance variants' sizes in the wrappers: the words of one
    instance's cotangents (``kernels.resolve.INSTANCE_WORDS``, the
    ``kInstanceWords`` of ``csrc/scene.cuh``: pos 3, rot 4, scale 3 in
    ``gpuscene.INSTANCE_FIELDS`` order) and the instances a block of the
    resolve backward's variant sums (its ``kMaxInstanceGrads``: the scene
    march's ``MAX_INSTANCES``, which both wrappers check); the
    resolve backward takes the variant's accumulator as its last
    parameter, after the stream."""
    from vrt_torch.kernels import march as k1
    from vrt_torch.kernels import resolve as kr
    from vrt_torch.render.gpuscene import INSTANCE_FIELDS

    words = _source_ints("scene.cuh", ("kInstanceWords",))["kInstanceWords"]
    assert kr.INSTANCE_WORDS == words == 3 + 4 + 3
    got = _source_ints("resolve.cu", ("kMaxInstanceGrads",))
    assert got["kMaxInstanceGrads"] == k1.MAX_INSTANCES
    acc = __import__("torch").arange(2.0 * words).reshape(2, words)
    pos, rot, scale = kr.instance_grads(acc)
    assert [x.shape[-1] for x in (pos, rot, scale)] == [3, 4, 3]
    assert INSTANCE_FIELDS == ("inst_pos", "inst_rot", "inst_scale")
    assert float(rot[1, 0]) == words + 3.0
    params = [p.strip() for p in re.search(
        r'extern "C" int vrt_resolve_scene_bwd\(([^)]*)\)',
        (_build.CSRC / "resolve.cu").read_text()).group(1).split(",")]
    assert params[-2:] == ["void* stream", "float* g_inst"]


def _cpu_shade_module(seen):
    """``kernels/shade.py`` run with its device checks on the CPU against a
    library whose entry points record their ints and launch nothing (so
    that the wrapper's plumbing runs on CPU tensors)."""
    from pathlib import Path

    import vrt_torch.kernels.shade as k4

    src = Path(k4.__file__).read_text().replace('"cuda"', '"cpu"')
    mod = types.ModuleType("shade_on_cpu")
    exec(compile(src, k4.__file__, "exec"), mod.__dict__)

    class Library:
        def __getattr__(self, name):
            def entry(ptrs, ints, rays, stream):
                seen.append((name, list(ints)))
                return 0
            return entry

    mod._lib = Library()
    mod._stream = lambda dev: None
    return mod


_SUMS_CASES = {
    # flags -> (the sums design counted, the last int)
    "material": (dict(material=True), "warp"),
    "material-first": (dict(material=True, _old_sums_design=True), "first"),
    "instances": (dict(instances=True), "warp"),
    "instances-material-first": (dict(instances=True, material=True,
                                      _old_sums_design=True), "first"),
    "instances-textures": (dict(instances=True, textures=True), "warp"),
    "material-textures": (dict(material=True, textures=True), None),
    "textures": (dict(textures=True), None),
    "default": ({}, None),
    "material-old-design": (dict(material=True, _old_design=True), None),
    "material-past-the-volumes": (dict(material=True), "warp"),
}


@pytest.mark.parametrize("case", sorted(_SUMS_CASES))
def test_surface_backward_picks_the_sums_design(case):
    """The surface backward's wrapper on CPU tensors against a recording
    library: the material variant without the texture variant and the
    instance variant launch their sums' redesign (ints' last slot 0),
    ``_old_sums_design`` their first design (1); a scene of 100 volumes
    takes the redesign too (the choice reads no count: the entry point
    refuses a scene whose sums outgrow its shared memory); each such launch
    counted in ``SUMS_DESIGN_LAUNCHES`` by design, any other launch not."""
    import torch

    from vrt_torch.march.types import RECORD_GRAD_FIELDS
    from vrt_torch.render import renderer as tren
    from vrt_torch.render.camera import camera_rays
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.scenes import flagship_scene

    flags, want = _SUMS_CASES[case]
    seen = []
    k4 = _cpu_shade_module(seen)
    scene = flagship_scene(4, device="cpu")
    if case == "material-past-the-volumes":
        from tests.test_torch_kernels import _many_volumes
        scene = _many_volumes(scene, 100)
    mode = RenderMode()
    o, d = camera_rays(scene.cam_pos, scene.cam_rot, scene.cam_fov, 8, 8)
    o, d = o.contiguous(), d.contiguous()
    hit, inst = tren.march_scene(scene, o, d,
                                 torch.full((64,), tren.RADIANCE_TMAX))
    t, n_obj, _ = tren.resolve_scene(scene, o, d, hit, inst)
    cots = [torch.ones(64) if f in ("roughness", "metallic")
            else torch.ones(64, 3) for f in RECORD_GRAD_FIELDS]
    k4.shade_surface_backward_cuda(scene, o, d, t, n_obj, hit, inst, mode,
                                   True, cots, **flags)
    assert [name for name, _ in seen] == ["vrt_shade_surface_bwd"]
    assert seen[0][1][19] == (want == "first")
    assert k4.SUMS_DESIGN_LAUNCHES == {
        "surface_bwd sums warp": int(want == "warp"),
        "surface_bwd sums first": int(want == "first")}


@pytest.mark.parametrize("flags", [
    dict(_old_sums_design=True),
    dict(textures=True, _old_sums_design=True),
    dict(material=True, textures=True, _old_sums_design=True),
    dict(material=True, _old_design=True, _old_sums_design=True)])
def test_surface_backward_refuses_the_sums_first_design(flags):
    """``_old_sums_design`` runs where the sums' redesign would: with the
    instance variant, or the material variant without the texture variant,
    on the merged kernel; elsewhere the wrapper raises before a launch."""
    import torch

    from vrt_torch.march.types import MarchHit
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.scenes import flagship_scene

    seen = []
    k4 = _cpu_shade_module(seen)
    scene = flagship_scene(4, device="cpu")
    o = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="sums' first design"):
        k4.shade_surface_backward_cuda(
            scene, o, o, torch.zeros(4), o, MarchHit.none_like(o),
            torch.zeros(4, dtype=torch.int32), RenderMode(), True,
            [None] * 6, **flags)
    assert seen == []
