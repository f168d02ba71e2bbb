"""The gather probe on one CUDA card: GP-A, GP-B and GP-C
(``vrt_torch/csrc/gather.cu``) at the shapes and index laws of the Pallas
gather probes ``scripts/probe_gather{,2,4,5}.py``, at the sizes their XLA
cases measured, and at the flagship's own tables.

    python3 -m vrt_torch.apps.probe_gather [case ...]

``CASES`` has one entry per Pallas probe function (its ``replaces``), one
per size where a function took several, and the system-size cases.  Each
case's data comes from its own ``numpy.random.default_rng(0)``: random
tables, and the script's index law.  For every case and load path the
kernel's output must equal its plain version's (``torch.equal``); both are
timed as device time (``device_ms``) and the probe prints M rows/s and
effective GB/s (gathered row bytes over time, as the scripts define it),
beside the card's name and power limit.  GP-C's cases also run its first
design (``_old_design``, the tensor cores), which must give the same bits,
and time the two in the order old, new, new, old.  There is no CPU path.

What the cases ask, on this card: random 16- and 32-byte rows from tables
above the 50 MB L2 (``flagship.bf16x8``, ``flagship.f32x8``), a u8 flat
read (``flagship.u8``), and ``__ldg`` against 16-byte vector loads (the
``ldg`` and ``v16`` paths of every GP-B case whose rows allow both).
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from typing import Callable

import numpy as np
import torch

from vrt_torch.kernels import gather as G
from vrt_torch.kernels._timing import device_ms

T3 = 128 ** 3                      # cells of one 129^3 volume
R20 = 1 << 20                      # rays of the scripts' XLA cases
FLAGSHIP_ROWS = 2 * T3             # the flagship's two stacked volumes
FLAGSHIP_LANES = 1920 * 1080       # one 1080p frame's primary lanes
HASH = 2654435761                  # probe_gather.py's multiplicative law
HBM_RATE = 3.35e12                 # bytes/s, the H100's published peak


@dataclasses.dataclass
class Case:
    """One probe case: ``make()`` -> a list of gathers, each a dict with
    ``src`` and ``idx`` (numpy) and the kernel's keyword arguments."""

    name: str
    kernel: str                    # "GP-A", "GP-B" or "GP-C"
    replaces: str                  # file:line of the probe function
    make: Callable[[], list]
    pallas: bool = True            # a Pallas kernel (else an XLA case)


def _rng():
    return np.random.default_rng(0)


def _f32(rng, shape):
    return rng.random(shape, dtype=np.float32)


def _i32(x):
    return np.asarray(x, np.int32)


def _taa(src_shape, idx_hi, idx_shape, axis, iters=0):
    def make():
        rng = _rng()
        src = _f32(rng, src_shape)
        idx = _i32(rng.integers(0, idx_hi, idx_shape))
        kw = dict(iters=iters, mask=idx_hi - 1) if iters else {}
        return [dict(src=src, idx=idx, axis=axis, **kw)]
    return make


def _rows(rows, width, n_idx, law="random", iters=0, reduce="last",
          flat=False):
    def make():
        rng = _rng()
        src = _f32(rng, (rows,) if flat else (rows, width))
        if law == "random":
            idx = rng.integers(0, rows, n_idx)
        else:
            idx = law(np.arange(int(np.prod(n_idx)), dtype=np.int64)
                      ).reshape(n_idx)
        kw = dict(iters=iters, mask=rows - 1, reduce=reduce) if iters else {}
        return [dict(src=src, idx=_i32(idx), **kw)]
    return make


def _fixed(src_fn, idx_fn, **kw):
    def make():
        rng = _rng()
        return [dict(src=src_fn(rng), idx=_i32(idx_fn(rng)), **kw)]
    return make


def _table(rng, shape, dtype):
    t = _f32(rng, shape)
    return torch.from_numpy(t).to(dtype)


def _xla_paired(dtype, accel_dtype):
    """A [T, 8] row plus a flat accel read at the same index."""
    def make():
        rng = _rng()
        idx = _i32(rng.integers(0, T3, R20))
        tbl = _table(rng, (T3, 8), dtype)
        acc = rng.integers(0, 17, T3).astype(accel_dtype)
        return [dict(src=tbl, idx=idx), dict(src=acc, idx=idx)]
    return make


def _xla_split():
    """Two [T, 4] rows: the cell's and the next one's."""
    def make():
        rng = _rng()
        idx = rng.integers(0, T3, R20)
        tbl = _f32(rng, (T3, 4))
        return [dict(src=tbl, idx=_i32(idx)),
                dict(src=tbl, idx=_i32(np.minimum(idx + 1, T3 - 1)))]
    return make


P1, P2, P4, P5 = ("scripts/probe_gather.py", "scripts/probe_gather2.py",
                  "scripts/probe_gather4.py", "scripts/probe_gather5.py")
C3 = 63 ** 3

CASES = [
    # probe_gather.py (the scripts' tables were arange / ones; random here)
    Case("probe_gather.case_a", "GP-A", f"{P1}:47", _fixed(
        lambda r: _f32(r, (8, 128)), lambda r: np.zeros((8, 128)), axis=0)),
    Case("probe_gather.case_b", "GP-A", f"{P1}:62", _fixed(
        lambda r: _f32(r, (4096, 128)), lambda r: np.full((8, 128), 77),
        axis=0)),
    Case("probe_gather.case_c", "GP-B", f"{P1}:79", _rows(
        65536, 1, 1024, law=lambda i: i * 7 % 65536, flat=True)),
    Case("probe_gather.case_d", "GP-B", f"{P1}:94", _rows(
        C3, 8, 1024, law=lambda i: i * 13 % C3)),
    Case("probe_gather.case_d2", "GP-B", f"{P1}:111", _rows(
        C3, 8, 1024, law=lambda i: i * 13 % C3)),
    Case("probe_gather.case_e", "GP-B", f"{P1}:128", _rows(
        C3, 8, 1024, law=lambda i: i * 13 % C3)),
    # probe_gather2.py
    *[Case(f"probe_gather2.axis0-{s}", "GP-A", f"{P2}:33",
           _taa((s, 128), s, (s, 128), 0)) for s in (8, 64, 512, 2048, 8192)],
    *[Case(f"probe_gather2.axis1-{c}", "GP-A", f"{P2}:53",
           _taa((8, c), c, (8, c), 1)) for c in (128, 512, 2048)],
    # probe_gather4.py::pallas_cases
    Case("probe_gather4.p1", "GP-A", f"{P4}:82",
         _taa((512, 128), 512, (512, 128), 0)),
    Case("probe_gather4.p2", "GP-A", f"{P4}:97",
         _taa((512, 128), 128, (512, 128), 1)),
    Case("probe_gather4.p3", "GP-B", f"{P4}:112", _rows(4096, 128, 2048)),
    Case("probe_gather4.p3b", "GP-B", f"{P4}:135", _rows(65536, 8, 2048)),
    Case("probe_gather4.p4", "GP-C", f"{P4}:158", _fixed(
        lambda r: _f32(r, (512, 8)), lambda r: r.integers(0, 512, 1024))),
    Case("probe_gather4.p5", "GP-B", f"{P4}:179", _fixed(
        lambda r: _f32(r, (8, 128)).reshape(-1),
        lambda r: r.integers(0, 1024, (64, 128)))),
    # probe_gather5.py: the same gathers looped in the kernel
    Case("probe_gather5.k1", "GP-A", f"{P5}:41",
         _taa((8, 128), 128, (8, 128), 1, iters=256)),
    Case("probe_gather5.k1b", "GP-A", f"{P5}:62",
         _taa((256, 128), 128, (256, 128), 1, iters=256)),
    Case("probe_gather5.k2", "GP-B", f"{P5}:83", _fixed(
        lambda r: _f32(r, (8, 128)).reshape(-1),
        lambda r: r.integers(0, 1024, (64, 128)), iters=256, mask=1023,
        reduce="sum")),
    Case("probe_gather5.k3", "GP-B", f"{P5}:111", _rows(
        65536, 8, 2048, iters=16, reduce="last")),
    Case("probe_gather5.k4", "GP-C", f"{P5}:140", _fixed(
        lambda r: _f32(r, (512, 8)), lambda r: r.integers(0, 512, 1024),
        iters=256, mask=511)),
    # the XLA cases' system sizes, through GP-B
    Case("probe_gather.case_x", "GP-B", f"{P1}:152", _rows(
        T3, 9, R20, law=lambda i: i * HASH % T3), pallas=False),
    Case("probe_gather.case_x2", "GP-B", f"{P1}:170", _rows(
        T3 * 9, 1, R20, law=lambda i: i * HASH % (T3 * 9), flat=True),
        pallas=False),
    *[Case(f"probe_gather4.rows-{n}x{w}", "GP-B", f"{P4}:44", _fixed(
        lambda r, w=w, dt=dt: _table(r, (T3, w), dt),
        lambda r: r.integers(0, T3, R20)), pallas=False)
      for n, w, dt in [("f32", 8, torch.float32), ("f32", 16, torch.float32),
                       ("bf16", 8, torch.bfloat16),
                       ("bf16", 16, torch.bfloat16),
                       ("bf16", 32, torch.bfloat16)]],
    Case("probe_gather4.f32x8+i32", "GP-B", f"{P4}:57",
         _xla_paired(torch.float32, np.int32), pallas=False),
    Case("probe_gather4.f32x8+i8", "GP-B", f"{P4}:59",
         _xla_paired(torch.float32, np.int8), pallas=False),
    Case("probe_gather4.bf16x8+i32", "GP-B", f"{P4}:63",
         _xla_paired(torch.bfloat16, np.int32), pallas=False),
    Case("probe_gather4.i32", "GP-B", f"{P4}:71", _fixed(
        lambda r: r.integers(0, 17, T3).astype(np.int32),
        lambda r: r.integers(0, T3, R20)), pallas=False),
    Case("probe_gather4.2xf32x4", "GP-B", f"{P4}:75", _xla_split(),
         pallas=False),
    Case("probe_gather5.k5", "GP-B", f"{P5}:166", _rows(T3, 8, R20),
         pallas=False),
    # the flagship's own tables: 2 x 128^3 rows, one random row per lane
    *[Case(f"flagship.{n}", "GP-B", "vrt_torch/csrc/march.cu", _fixed(
        src, lambda r: r.integers(0, FLAGSHIP_ROWS, FLAGSHIP_LANES)),
        pallas=False)
      for n, src in [
          ("bf16x8", lambda r: _table(r, (FLAGSHIP_ROWS, 8), torch.bfloat16)),
          ("f32x8", lambda r: _table(r, (FLAGSHIP_ROWS, 8), torch.float32)),
          ("u8", lambda r: r.integers(0, 256, FLAGSHIP_ROWS,
                                      dtype=np.uint8))]],
]
BY_NAME = {c.name: c for c in CASES}
KERNELS = {"GP-A": (G.take_along_axis_cuda, G.take_along_axis_reference),
           "GP-B": (G.row_gather_cuda, G.row_gather_reference),
           "GP-C": (G.onehot_gather_cuda, G.onehot_gather_reference)}


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _row_bytes(g):
    """Bytes of one gathered row: an element for GP-A, a bf16 row of 8 for
    GP-C, a table row for GP-B."""
    src = g["src"]
    if g["kernel"] == "GP-A":
        return src.element_size()
    if g["kernel"] == "GP-C":
        return 8 * 2
    return src.element_size() * (src.shape[1] if src.dim() == 2 else 1)


def paths(case, gathers):
    """The GP-B load paths a case takes: ldg always, v16 when some table's
    rows are a multiple of 16 bytes, smem when every table fits."""
    if case.kernel != "GP-B":
        return ["-"]
    out = ["ldg"]
    if any(_row_bytes(g) % 16 == 0 for g in gathers):
        out.append("v16")
    if all(g["src"].numel() * g["src"].element_size() <= G.SMEM_BYTES
           for g in gathers):
        out.append("smem")
    return out


def to_device(case, dev):
    """The case's gathers with tensors on ``dev``."""
    gathers = []
    for g in case.make():
        g = dict(g, kernel=case.kernel)
        g["src"] = torch.as_tensor(g["src"]).to(dev)
        g["idx"] = torch.as_tensor(g["idx"]).to(dev)
        gathers.append(g)
    return gathers


def _kwargs(g):
    return {k: v for k, v in g.items() if k not in ("src", "idx", "kernel")}


def run_kernel(case, gathers, path, old_design=False):
    """The case's gathers through its kernel; on the v16 path, tables whose
    rows are not a multiple of 16 bytes take the ldg path.  ``old_design``
    runs GP-C's first design (the tensor cores)."""
    fn = KERNELS[case.kernel][0]
    out = []
    for g in gathers:
        kw = _kwargs(g)
        if case.kernel == "GP-B":
            kw["path"] = "ldg" if path == "v16" and _row_bytes(g) % 16 \
                else path
        if old_design:
            kw["_old_design"] = True
        out.append(fn(g["src"], g["idx"], **kw))
    return out


def run_plain(case, gathers):
    fn = KERNELS[case.kernel][1]
    return [fn(g["src"], g["idx"], **_kwargs(g)) for g in gathers]


def launch_all(case, gathers):
    """The probe's main path for one case: its kernel once on every load
    path.  Returns {path: outputs}."""
    return {path: run_kernel(case, gathers, path)
            for path in paths(case, gathers)}


def _least_bytes(g, rounds):
    """The bytes one gather must move: every index read and every output
    element written once, and of the table one row per lookup, or the
    whole table where the lookups outnumber its rows."""
    src, idx = g["src"], g["idx"]
    # GP-C writes f32 rows of the bf16 rows it reads
    out_bytes = idx.numel() * (2 if g["kernel"] == "GP-C" else 1) \
        * _row_bytes(g)
    table = min(idx.numel() * rounds * _row_bytes(g),
                src.numel() * src.element_size())
    return idx.numel() * idx.element_size() + out_bytes + table


def _library(gathers):
    """The one PyTorch call per gather that computes the same function
    (``take_along_dim`` for GP-A, ``src[idx]`` for GP-B and, on the table
    rounded to bf16, for GP-C), with its int64 indices made beforehand; a
    yardstick that the port never calls."""
    calls = []
    for g in gathers:
        idx = g["idx"].long()
        if g["kernel"] == "GP-A":
            calls.append(lambda s=g["src"], i=idx, a=g["axis"]:
                         torch.take_along_dim(s, i, dim=a))
        else:
            src = g["src"].bfloat16().float() if g["kernel"] == "GP-C" \
                else g["src"]
            calls.append(lambda s=src, i=idx: s[i])
    return lambda: [c() for c in calls]


def check_and_time(case, gathers, outs, reps=20, log=print):
    """Hold the kernel's outputs ``outs`` ({path: outputs}) against the
    plain version's, raising on any difference, then time both, and the
    library call where the case has one (no rounds).  Returns one result
    dict per path, with the least time the card could take for the case's
    bytes (``bound_ms``)."""
    want = run_plain(case, gathers)
    torch.cuda.synchronize()
    looped = any(g.get("iters") for g in gathers)
    plain_ms = device_ms(lambda: run_plain(case, gathers),
                         3 if looped else reps)
    rounds = max(1, max(g.get("iters", 0) for g in gathers))
    rows = sum(g["idx"].numel() for g in gathers) * rounds
    nbytes = sum(g["idx"].numel() * _row_bytes(g) for g in gathers) * rounds
    bound_ms = 1e3 * sum(_least_bytes(g, rounds) for g in gathers) / HBM_RATE
    library_ms = None if looped else device_ms(_library(gathers), reps)
    results = []
    for path, got in outs.items():
        err = 0.0
        for a, b in zip(got, want):
            if a.shape != b.shape or a.dtype != b.dtype or \
                    not torch.equal(a, b):
                raise AssertionError(f"{case.name} [{path}]: the kernel "
                                     f"differs from its plain version")
            err = max(err, (a.float() - b.float()).abs().max().item())
        old_ms = None
        if case.kernel == "GP-C":
            # the first design on the same inputs: NaN where it is NaN, the
            # same bits elsewhere; the two timed old, new, new, old
            for a, b in zip(run_kernel(case, gathers, path, True), got):
                nan = torch.isnan(a)
                if not (torch.equal(nan, torch.isnan(b)) and torch.equal(
                        torch.where(nan, 0.0, a).view(torch.int32),
                        torch.where(nan, 0.0, b).view(torch.int32))):
                    raise AssertionError(f"{case.name}: GP-C differs from "
                                         f"its first design")
            t = [device_ms(lambda o=o: run_kernel(case, gathers, path, o),
                           reps) for o in (True, False, False, True)]
            ms, old_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            log(f"probe {case.name:26s} GP-C: first design equal bit for "
                f"bit; old, new, new, old "
                f"{', '.join(f'{x:.4f}' for x in t)} ms")
        else:
            ms = device_ms(lambda: run_kernel(case, gathers, path), reps)
        log(f"probe {case.name:26s} {case.kernel} {path:4s} equal "
            f"rows={rows} row_bytes={nbytes // rows} kernel {ms:.4f} ms "
            f"{rows / ms / 1e3:.1f} M rows/s {nbytes / ms / 1e6:.1f} GB/s; "
            f"plain {plain_ms:.4f} ms {rows / plain_ms / 1e3:.1f} M rows/s; "
            f"bound {bound_ms:.5f} ms; library "
            + ("none" if library_ms is None else f"{library_ms:.4f} ms"))
        results.append(dict(name=case.name, kernel=case.kernel, path=path,
                            replaces=case.replaces, pallas=case.pallas,
                            rows=rows, bytes=nbytes, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            library_ms=library_ms, max_abs_err=err,
                            old_ms=old_ms))
    return results


def main(argv=None) -> int:
    names = list(argv if argv is not None else sys.argv[1:]) or \
        [c.name for c in CASES]
    if not torch.cuda.is_available():
        raise RuntimeError("the gather probe needs a CUDA card; it has no "
                           "CPU path")
    unknown = [n for n in names if n not in BY_NAME]
    if unknown:
        raise SystemExit(f"unknown cases {unknown}; known: {list(BY_NAME)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card()}", flush=True)
    for line in G.build().strip().splitlines():
        print(f"  nvcc: {line}", flush=True)
    dev = torch.device("cuda", 0)
    for name in names:
        case = BY_NAME[name]
        gathers = to_device(case, dev)
        check_and_time(case, gathers, launch_all(case, gathers),
                       log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
