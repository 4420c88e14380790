"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled at first use by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, which is loaded
with ``ctypes``. The library lands in ``build/dla_tpu_torch/`` beside the
package, named by a hash of the sources and the flags, so an edited source
rebuilds and an unchanged one loads at once. It is written to a temporary
file and renamed into place, so that parallel processes never see half a
library. A missing ``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dla_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels of dla_tpu_torch cannot be built"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdla_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them already exists."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, sorted(CSRC.glob("*.cu")))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call of the process."""
    return ctypes.CDLL(str(build()))
