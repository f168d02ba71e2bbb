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

