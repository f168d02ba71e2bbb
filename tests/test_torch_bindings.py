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
