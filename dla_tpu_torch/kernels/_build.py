"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled at first use by ``nvcc`` for
``sm_90a``, one ``nvcc`` per ``.cu`` file, all started together, and linked
into one shared library with a plain C interface, which is loaded with
``ctypes``. The library lands in ``build/dla_tpu_torch/`` beside the
package, named by a hash of the sources and the flags, so an edited source
rebuilds and an unchanged one loads at once. It is built in a temporary
directory and renamed into place, so that parallel processes never see half
a library. A missing ``nvcc`` or a failed build raises: there is no fallback.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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


def _wait(cmd: list[str], proc: subprocess.Popen) -> None:
    out = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")


def _start(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


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
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [os.path.join(tmp, src.stem + ".o") for src in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)] for obj, src in zip(objs, srcs)]
        procs = [_start(cmd) for cmd in cmds]  # all sources compile at once
        try:
            for cmd, proc in zip(cmds, procs):
                _wait(cmd, proc)
        finally:  # a failed source stops the others' compilers
            for proc in procs:
                proc.kill()
                proc.wait()
        so = os.path.join(tmp, lib.name)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]
        _wait(link, _start(link))
        os.replace(so, lib)  # atomic: parallel processes never see half a library
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call of the process."""
    return ctypes.CDLL(str(build()))
