"""The one builder of the port's CUDA sources.

A source under ``vrt_torch/csrc/`` is compiled by hand with ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
library goes at first use into ``build/vrt_torch_kernels/`` under the
checkout, named by a hash of the source, the headers it includes and the
flags, so an edited source is rebuilt.  ``-Xptxas -v`` makes ptxas print
each kernel's registers, shared memory and spills; ``build`` returns that
log.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vrt_torch_kernels"
BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels build only where "
                       "the CUDA toolkit is installed")


def build(source: str, extra_flags=(), headers=()
          ) -> tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<source>`` (when its library is missing) and load it.
    ``headers`` names the files under ``csrc/`` that the source includes:
    they are hashed with it.  Returns the library and the compiler's output
    ("" when the library was already built)."""
    path = CSRC / source
    flags = BASE_FLAGS + list(extra_flags)
    src = path.read_bytes() + b"".join((CSRC / h).read_bytes()
                                       for h in headers)
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    so = BUILD_DIR / f"lib{path.stem}_{tag[:16]}.so"
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(path)],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {path}:\n{log}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so)), log



def ptxas_usage(log: str, kernel: str, last: bool | None = None):
    """What ptxas printed in a ``build`` log for the template variants of
    ``kernel`` (its name as written in the source; a kernel that is no
    template has one variant), or with ``last`` for those whose last
    template argument is that bool (the shade backward kernels' material
    and light variants): dict(variants,
    registers, stack_bytes, spill_bytes, each [smallest, largest] over the
    variants), or None where the log holds none (a library built before)."""
    import re

    funcs, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            funcs.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            funcs[cur].update(stack=int(m.group(1)),
                              spill=int(m.group(2)) + int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            funcs[cur]["regs"] = int(m.group(1))
    # the mangled name: its length, the name, then the template arguments
    # (I) or the end of the nested name (E)
    pat = re.compile(rf"\d+{kernel}[IE]")
    got = [f for name, f in funcs.items() if pat.search(name) and "regs" in f
           and (last is None
                or re.search(rf"Lb{int(last)}E+v", name) is not None)]
    if not got:
        return None

    def span(key):
        vals = [f.get(key, 0) for f in got]
        return [min(vals), max(vals)]
    return dict(variants=len(got), registers=span("regs"),
                stack_bytes=span("stack"), spill_bytes=span("spill"))


def warp_slots(regs: int, threads: int) -> float:
    """The share of an H100 SM's 64 warp slots that blocks of ``threads``
    threads of ``regs`` registers each can fill, from the registers alone
    (256-register allocation units a warp, 65,536 registers, 32 blocks an
    SM)."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(32, 64 // warps, 65536 // (per_warp * warps))
    return blocks * warps / 64
