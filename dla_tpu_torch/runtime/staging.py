"""ctypes bindings to the native host runtime and the host stores of the
out-of-core factorization — a copy of ``dla_tpu/runtime/staging.py``; only
where the library is built differs.

The C++ source (``csrc/tilestore.cpp``) is compiled at first use by ``g++``
into ``build/dla_tpu_torch/`` beside the package, named by a hash of the
source, the flags and the host CPU's feature flags (``-march=native`` code
from one host may not run on another), built in a temporary directory and
renamed into place, so that parallel processes never load half a library. A
missing compiler or a failed build raises. All heavy host-memory operations
(seeded generation, strided panel gather/scatter, norms, Freivalds residual
probes) run in C++ at memory bandwidth; the Python layer only orchestrates.

The "measured" notes below are the JAX package's, taken on its single-core
host VM; they explain the design, not this port's speed.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
import weakref
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "tilestore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dla_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-fopenmp", "-Wall", "-shared")


def _cpu_flags() -> bytes:
    """The host CPU's feature flags (what ``-march=native`` compiles for)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    return line
    except OSError:
        pass
    return os.uname().machine.encode()


def library_path() -> Path:
    """Where the library for this source, these flags and this CPU lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    h.update(_cpu_flags())
    return BUILD_DIR / f"libdlats_{h.hexdigest()[:16]}.so"


def _compilers() -> list[str]:
    """``$CXX``, then every ``g++`` along ``PATH``: a compiler whose driver
    cannot link OpenMP (no ``libgomp.spec`` in its search path) is passed
    over for the next."""
    found = [os.environ.get("CXX", "")]
    found += [os.path.join(d, "g++") for d in os.environ.get("PATH", "").split(os.pathsep) if d]
    out, seen = [], set()
    for cxx in found:
        if cxx and os.access(cxx, os.X_OK) and os.path.realpath(cxx) not in seen:
            seen.add(os.path.realpath(cxx))
            out.append(cxx)
    return out


def build() -> Path:
    """Compile the runtime unless the library for it already exists."""
    so = library_path()
    if so.exists():
        return so
    compilers = _compilers()
    if not compilers:
        raise RuntimeError("g++ not found (nor $CXX): the native host runtime cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    errors = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, so.name)
        for cxx in compilers:
            cmd = [cxx, *CXX_FLAGS, str(_SRC), "-o", out]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode == 0:
                os.replace(out, so)  # atomic: parallel processes never see half a library
                return so
            errors.append(f"{' '.join(cmd)} ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    raise RuntimeError("g++ failed: " + "\n".join(errors))


@functools.cache
def lib() -> ctypes.CDLL:
    """The native runtime library, built on the first call of the process."""
    l = ctypes.CDLL(str(build()))
    i64, u32, f64 = ctypes.c_int64, ctypes.c_uint32, ctypes.c_double
    vp = ctypes.c_void_p
    l.dla_alloc.restype = vp
    l.dla_alloc.argtypes = [i64]
    l.dla_free.restype = None
    l.dla_free.argtypes = [vp]
    for suf in ("f32", "f64"):
        fn = getattr(l, f"dla_plgsy_{suf}")
        fn.restype = None
        fn.argtypes = [vp, i64, u32, i64, i64, i64, i64, f64]
        fn = getattr(l, f"dla_copy2d_{suf}")
        fn.restype = None
        fn.argtypes = [vp, i64, vp, i64, i64, i64]
        fn = getattr(l, f"dla_norm_inf_sym_lower_{suf}")
        fn.restype = f64
        fn.argtypes = [vp, i64, i64]
        fn = getattr(l, f"dla_freivalds_{suf}")
        fn.restype = f64
        fn.argtypes = [vp, vp, i64, i64, u32]
    l.dla_probe_x.restype = None
    l.dla_probe_x.argtypes = [vp, i64, u32]
    i32 = ctypes.c_int32
    l.dla_open_file.restype = i64
    l.dla_open_file.argtypes = [ctypes.c_char_p, i32, i32]
    l.dla_close_file.restype = None
    l.dla_close_file.argtypes = [i64]
    l.dla_fsync.restype = i64
    l.dla_fsync.argtypes = [i64]
    l.dla_truncate_file.restype = i64
    l.dla_truncate_file.argtypes = [i64, i64]
    l.dla_pread_full.restype = i64
    l.dla_pread_full.argtypes = [i64, vp, i64, i64]
    l.dla_pwrite_full.restype = i64
    l.dla_pwrite_full.argtypes = [i64, vp, i64, i64]
    return l


def probe_x(n: int, seed: int) -> np.ndarray:
    """The native Freivalds probe vector (``tilestore.cpp`` ``probe_x``)."""
    out = np.empty(n, np.float64)
    lib().dla_probe_x(out.ctypes.data, n, seed & 0xFFFFFFFF)
    return out


_DTYPES = {np.float32: "f32", np.float64: "f64"}


def _suf(dtype) -> str:
    key = np.dtype(dtype).type
    if key not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype}")
    return _DTYPES[key]


class HostTileStore:
    """A page-aligned host-resident n×n matrix with native tile ops.

    The out-of-core working set: the matrix lives here (host DRAM); panels
    are gathered into contiguous staging buffers and shipped to the device,
    factored panels scattered back.
    """

    def __init__(self, n: int, dtype=np.float32, *, path: str | None = None):
        """``path=None``: page-aligned RAM allocation. ``path=...``: a
        disk-backed ``np.memmap`` — the checkpointable variant (the matrix
        itself persists across process restarts; see
        ``algos.oocore.potrf_outofcore`` resume support)."""
        self.n = int(n)
        self.dtype = np.dtype(dtype)
        self._suf = _suf(dtype)
        self._lib = lib()
        self.path = path
        if path is not None:
            self._ptr = None
            self.array = np.memmap(path, dtype=self.dtype, mode="r+" if os.path.exists(path) else "w+", shape=(self.n, self.n))
        else:
            nbytes = self.n * self.n * self.dtype.itemsize
            self._ptr = self._lib.dla_alloc(nbytes)
            if not self._ptr:
                raise MemoryError(f"failed to allocate {nbytes} bytes")
            ctype = ctypes.c_float if self._suf == "f32" else ctypes.c_double
            buf = (ctype * (self.n * self.n)).from_address(self._ptr)
            self.array = np.frombuffer(buf, dtype=self.dtype).reshape(self.n, self.n)

    def close(self):
        if getattr(self, "_ptr", None):
            self.array = None
            self._lib.dla_free(self._ptr)
            self._ptr = None
        elif getattr(self, "array", None) is not None and self.path is not None:
            self.array.flush()
            self.array = None

    def __del__(self):  # pragma: no cover - finalizer
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _addr(self, i0: int = 0, j0: int = 0) -> int:
        return self.array.ctypes.data + (i0 * self.n + j0) * self.dtype.itemsize

    # -- native ops ----------------------------------------------------------

    def fill_plgsy(self, *, seed: int = 51, bump: float | None = None):
        """Generate the seeded symmetric matrix in place (bit-identical to
        the JAX ``plgsy`` generator)."""
        if bump is None:
            bump = float(self.n)
        getattr(self._lib, f"dla_plgsy_{self._suf}")(
            self._addr(), self.n, seed & 0xFFFFFFFF, 0, 0, self.n, self.n, bump
        )

    def pack(self, i0: int, j0: int, h: int, w: int, out: np.ndarray | None = None):
        """Gather the (h, w) submatrix at (i0, j0) into a contiguous buffer."""
        if out is None:
            out = np.empty((h, w), self.dtype)
        assert out.flags.c_contiguous and out.shape == (h, w)
        getattr(self._lib, f"dla_copy2d_{self._suf}")(
            self._addr(i0, j0), self.n, out.ctypes.data, w, h, w
        )
        return out

    def unpack(self, i0: int, j0: int, src: np.ndarray):
        """Scatter a contiguous (h, w) buffer back at (i0, j0)."""
        src = np.ascontiguousarray(src, self.dtype)
        h, w = src.shape
        getattr(self._lib, f"dla_copy2d_{self._suf}")(
            src.ctypes.data, w, self._addr(i0, j0), self.n, h, w
        )

    def norm_inf_sym_lower(self) -> float:
        return getattr(self._lib, f"dla_norm_inf_sym_lower_{self._suf}")(
            self._addr(), self.n, self.n
        )

    def freivalds_residual(self, factor: "HostTileStore", *, probes: int = 4) -> float:
        """Probabilistic relative residual of A ≈ L·L^T: max over random
        probe vectors x of ||(A − L·L^T)x||_inf / (||A||_inf ||x||_inf),
        O(N²) per probe. ``self`` holds A (lower), ``factor`` holds L."""
        assert factor.n == self.n and factor.dtype == self.dtype
        na = self.norm_inf_sym_lower()
        worst = 0.0
        for p in range(probes):
            # native probe returns ||(A − LL^T)x||_inf already normalized by
            # the probe's actual ||x||_inf (NaN on allocation failure)
            err = getattr(self._lib, f"dla_freivalds_{self._suf}")(
                self._addr(), factor._addr(), self.n, self.n, 0xC0FFEE ^ p
            )
            if not err / na <= worst:  # NaN wins: a NaN factor fails the gate
                worst = err / na
        return worst


# ---------------------------------------------------------------------------
# Panel-blocked direct-I/O disk store (the at-scale out-of-core backend)
# ---------------------------------------------------------------------------

_ALIGN = 4096


def _aligned_empty(nbytes: int) -> np.ndarray:
    """A 4096-aligned byte buffer (GC-safe: over-allocated numpy slice).

    Pages are pre-faulted (one byte written per 4 KiB page): O_DIRECT reads
    into *unfaulted* anon memory fall off ``gup_fast`` onto the kernel's
    slow long-term-pin path (measured ~40-110 MB/s of pure CPU on the JAX
    package's host VM), while pre-faulted pages pin at full disk speed.
    Anon faults ran at ~1.3 GB/s there (THP off), so the pre-fault cost
    ~0.8 ms/GiB of the buffer's lifetime."""
    raw = np.empty(nbytes + _ALIGN, np.uint8)
    off = (-raw.ctypes.data) % _ALIGN
    buf = raw[off : off + nbytes]
    buf[::_ALIGN] = 0  # pre-fault
    return buf


class DirectPanelStore:
    """Disk-backed lower-triangle matrix stored as contiguous column panels,
    read/written with O_DIRECT sequential I/O.

    Motivation (measured on the JAX package's host VM): page-cache page
    insertion cost ~0.2-0.5 ms each, so buffered writes / ``np.memmap``
    first-touch ran at ~18 MB/s — while O_DIRECT streamed at ~430-570
    MB/s. ``np.memmap`` (the
    :class:`HostTileStore` disk mode) is therefore unusable at the
    BASELINE config-5 scale; this store bypasses the page cache entirely.

    Layout: panel ``j`` holds rows ``j*panel .. n`` of columns
    ``j*panel .. (j+1)*panel`` (the lower-triangle part only — half the
    bytes of a square store), row-major with leading dimension ``panel``,
    stored contiguously. The left-looking out-of-core POTRF
    (:func:`dla_tpu_torch.algos.oocore.potrf_outofcore`) reads exactly
    row-suffixes of whole panels, so every disk access is one large
    sequential transfer. A scratch region (one max-size panel) at the end
    of the file backs transactional panel commits.

    Parity note: this is the TPU-native replacement for the reference's
    distributed blob store (the ArmoniK client holds the full matrix,
    workers hold O(B²) — SURVEY §5.7, ``client_distrib.cpp:280-309``): the
    "blobs" are column panels, content-addressed by panel index, and the
    pinned staging buffers (``starpu_malloc``,
    ``v6_script_cholesky_w_residu_malloc.c:41-58``) become the 4096-aligned
    pooled buffers below.
    """

    def __init__(self, n: int, dtype=np.float32, *, path: str, panel: int,
                 direct: bool = True, ram_cache: bool = False):
        """``ram_cache=True`` keeps a write-through copy of the whole store
        in anonymous host RAM: reads (the O(N³/panel) side of the panel
        stream) are served from memory, writes go to BOTH the cache and the
        O_DIRECT file, and a fresh process re-warms the cache from disk —
        so crash-consistency and resume are exactly the disk store's.
        Motivation (measured): each O_DIRECT read pins its destination
        pages via the kernel's slow GUP fallback (~40 MB/s of CPU at 4K
        pages on the JAX package's host VM) — ~2.5 h of pure page-pinning
        for the ~366 GB read stream at N=131072, vs ~2 min of memcpy from
        cache."""
        self.n = int(n)
        self.panel = int(panel)
        self.dtype = np.dtype(dtype)
        self._suf = _suf(dtype)
        self._lib = lib()
        self.path = path
        if self.n % self.panel:
            raise ValueError(f"n={n} must be a multiple of panel={panel}")
        item = self.dtype.itemsize
        if direct and (self.panel * item) % _ALIGN:
            raise ValueError(
                f"panel width {panel} x itemsize {item} must be a multiple "
                f"of {_ALIGN} bytes for O_DIRECT (use direct=False for "
                "tiny test panels)"
            )
        self.npan = self.n // self.panel
        self._offsets = []
        off = 0
        for j in range(self.npan):
            self._offsets.append(off)
            off += (self.n - j * self.panel) * self.panel * item
        self._scratch_off = off
        total = off + self.n * self.panel * item  # + scratch region
        existed = os.path.exists(path)
        fd = self._lib.dla_open_file(path.encode(), 1, 1 if direct else 0)
        if fd < 0 and direct:
            # filesystem rejects O_DIRECT (e.g. tmpfs) — buffered fallback
            fd = self._lib.dla_open_file(path.encode(), 1, 0)
            direct = False
        if fd < 0:
            raise OSError(-fd, os.strerror(-fd), path)
        self._fd = fd
        self.direct = bool(direct)
        if not existed or os.stat(path).st_size < total:
            rc = self._lib.dla_truncate_file(fd, total)
            if rc < 0:
                raise OSError(-rc, os.strerror(-rc), path)
        # pooled aligned buffers: one free list of raw byte arrays, best-fit
        # on size; steady state is a handful of max-panel-size buffers.
        self._free: list[np.ndarray] = []
        self._out: dict[int, tuple] = {}  # id(view) -> (raw, weakref)
        self.auto_reclaimed = 0  # buffers recovered from dropped views
        self._plock = threading.Lock()
        self._cache: np.ndarray | None = None
        if ram_cache:
            # same panel-blocked layout as the file, one flat byte array
            self._cache = _aligned_empty(self._scratch_off)
            if existed:
                # Re-warm from disk (resume in a fresh process). The cache
                # pages are pre-faulted by _aligned_empty — essential: an
                # O_DIRECT read into unfaulted anon memory falls off
                # gup_fast onto a ~2 MB/s per-page fault+pin path on the
                # JAX package's host VM (a 35 GiB warm took hours there).
                # Chunked so each syscall completes promptly.
                step = 256 << 20
                for off in range(0, self._cache.nbytes, step):
                    self._io(
                        self._lib.dla_pread_full,
                        self._cache[off : off + step], off, "pread",
                    )

    # -- buffer pool ---------------------------------------------------------

    def _acquire(self, h: int, w: int) -> np.ndarray:
        nbytes = h * w * self.dtype.itemsize
        with self._plock:
            best = None
            for i, raw in enumerate(self._free):
                if raw.nbytes >= nbytes and (
                    best is None or raw.nbytes < self._free[best].nbytes
                ):
                    best = i
            raw = self._free.pop(best) if best is not None else _aligned_empty(nbytes)
            view = raw[:nbytes].view(self.dtype).reshape(h, w)
            key = id(view)
            # A caller that drops the view without release() must not leak
            # the backing buffer (nor let a recycled id() collide with a
            # stale entry): a weakref finalizer returns the raw
            # buffer to the pool when the view dies unreleased.
            self._out[key] = (raw, weakref.ref(view, lambda _: self._reclaim(key)))
            return view

    def _reclaim(self, key: int) -> None:
        with self._plock:
            entry = self._out.pop(key, None)
            if entry is not None:
                self._free.append(entry[0])
                self.auto_reclaimed += 1

    def release(self, buf: np.ndarray) -> None:
        """Return a buffer obtained from :meth:`pack` to the pool. Only call
        once the device copy of the buffer is complete: after its copy's
        CUDA event, or at once where the copy was synchronous (a CPU
        tensor's ``copy_``)."""
        with self._plock:
            entry = self._out.pop(id(buf), None)
            if entry is not None:
                self._free.append(entry[0])

    # -- lifecycle -----------------------------------------------------------

    def close(self):
        if getattr(self, "_fd", None) is not None:
            self._lib.dla_close_file(self._fd)
            self._fd = None

    def __del__(self):  # pragma: no cover - finalizer
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- I/O (same pack/unpack surface the oocore algorithm uses) ------------

    def _panel_of(self, j0: int) -> int:
        if j0 % self.panel:
            raise ValueError(f"column {j0} is not panel-aligned")
        return j0 // self.panel

    def _io(self, op, buf: np.ndarray, file_off: int, what: str):
        rc = op(self._fd, buf.ctypes.data, buf.nbytes, file_off)
        if rc != buf.nbytes:
            err = os.strerror(-rc) if rc < 0 else f"short {what} ({rc} bytes)"
            raise OSError(f"{what} of {buf.nbytes} B at {file_off}: {err}")

    def _cache_panel(self, k: int) -> np.ndarray:
        """(h_k, panel) ndarray view of panel k inside the RAM cache."""
        item = self.dtype.itemsize
        h = self.n - k * self.panel
        off = self._offsets[k]
        return (
            self._cache[off : off + h * self.panel * item]
            .view(self.dtype)
            .reshape(h, self.panel)
        )

    def pack(self, i0: int, j0: int, h: int, w: int) -> np.ndarray:
        """Read rows ``i0 .. i0+h`` of panel ``j0/panel`` into a pooled
        aligned buffer (RAM-cache memcpy, or one sequential disk read).
        Requires ``w == panel``, ``i0 >= j0`` (lower triangle) and a
        row-suffix (``i0 + h == n``) — exactly the out-of-core algorithm's
        access pattern."""
        k = self._panel_of(j0)
        real = self.n - i0
        if w != self.panel or i0 < j0 or h < real:
            raise ValueError(
                f"unsupported pack (i0={i0}, j0={j0}, h={h}, w={w}): the "
                "panel store serves whole-panel row-suffixes only"
            )
        item = self.dtype.itemsize
        off = self._offsets[k] + (i0 - j0) * self.panel * item
        buf = self._acquire(h, w)
        if self._cache is not None:
            np.copyto(buf[:real], self._cache_panel(k)[i0 - j0 :], casting="no")
        else:
            self._io(self._lib.dla_pread_full, buf[:real], off, "pread")
        if h > real:
            buf[real:] = 0  # height-bucketed overhang (algos/oocore.py)
        return buf

    def unpack(self, i0: int, j0: int, src: np.ndarray):
        """Write a full factored panel back (write-through: RAM cache if
        enabled, always the disk file)."""
        k = self._panel_of(j0)
        if i0 != j0 or src.shape != (self.n - i0, self.panel):
            raise ValueError(
                f"unsupported unpack at ({i0},{j0}) shape {src.shape}"
            )
        if self._cache is not None:
            np.copyto(self._cache_panel(k), src, casting="no")
        buf = self._acquire(*src.shape)
        np.copyto(buf, src, casting="no")
        try:
            self._io(self._lib.dla_pwrite_full, buf, self._offsets[k], "pwrite")
        finally:
            self.release(buf)

    # -- transactional scratch region (used by the oocore sidecar) -----------

    def write_scratch(self, src: np.ndarray):
        """Durably stage a factored panel in the scratch region (O_DIRECT
        writes are durable at completion; the buffered fallback fsyncs so
        the transactional-commit ordering also holds across power loss)."""
        buf = self._acquire(*src.shape)
        np.copyto(buf, src, casting="no")
        try:
            self._io(self._lib.dla_pwrite_full, buf, self._scratch_off, "pwrite")
            if not self.direct:
                rc = self._lib.dla_fsync(self._fd)
                if rc < 0:
                    raise OSError(-rc, os.strerror(-rc), self.path)
        finally:
            self.release(buf)

    def commit_scratch(self, j: int):
        """Replay scratch → panel ``j`` (crash recovery: the scratch region
        is the durable copy; the panel itself may hold a torn write)."""
        h = self.n - j * self.panel
        buf = self._acquire(h, self.panel)
        try:
            self._io(self._lib.dla_pread_full, buf, self._scratch_off, "pread")
            self._io(self._lib.dla_pwrite_full, buf, self._offsets[j], "pwrite")
            if self._cache is not None:
                np.copyto(self._cache_panel(j), buf, casting="no")
        finally:
            self.release(buf)

    # -- generation ----------------------------------------------------------

    def fill_plgsy(self, *, seed: int = 51, bump: float | None = None,
                   on_panel=None):
        """Stream the seeded SPD matrix to disk panel by panel (native
        generator, bit-identical to the JAX/host generators)."""
        if bump is None:
            bump = float(self.n)
        gen = getattr(self._lib, f"dla_plgsy_{self._suf}")
        for k in range(self.npan):
            k0 = k * self.panel
            h = self.n - k0
            buf = self._acquire(h, self.panel)
            try:
                gen(buf.ctypes.data, self.panel, seed & 0xFFFFFFFF,
                    k0, k0, h, self.panel, bump)
                if self._cache is not None:
                    np.copyto(self._cache_panel(k), buf, casting="no")
                self._io(self._lib.dla_pwrite_full, buf, self._offsets[k],
                         "pwrite")
            finally:
                self.release(buf)
            if on_panel:
                on_panel(k, self.npan)


# ---------------------------------------------------------------------------
# Streaming Freivalds validation for the panel store
# ---------------------------------------------------------------------------


def _mix32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32, copy=True)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def _probe_vec(n: int, seed: int) -> np.ndarray:
    """The native runtime's Freivalds probe vector (tilestore.cpp probe_x),
    vectorized: uniform in [-0.5, 0.5) from a per-index hash."""
    i = np.arange(n, dtype=np.uint32)
    h = _mix32(i * np.uint32(0x9E3779B9) ^ np.uint32(seed & 0xFFFFFFFF))
    return (h >> np.uint32(8)).astype(np.float64) * (1.0 / 16777216.0) - 0.5


def freivalds_streaming(
    store: DirectPanelStore, *, seed: int = 51, bump: float | None = None,
    probes: int = 4, on_panel=None,
) -> float:
    """Freivalds residual for a factored :class:`DirectPanelStore`, fully
    streaming: one pass over the L panels on disk plus one regeneration pass
    of A from its seed (no second matrix is ever materialized).

    Per probe x:  ``||(A − L·Lᵀ)x||_inf / (||A||_inf · ||x||_inf)`` with all
    matvecs accumulated in fp64; A is regenerated in the *store dtype* so
    the comparison is against exactly the matrix that was factored.
    Returns the max over probes. O(N²) compute, ~1.5 passes of disk I/O.
    """
    n, w = store.n, store.panel
    if bump is None:
        bump = float(n)
    x = np.stack([_probe_vec(n, 0xC0FFEE ^ p) for p in range(probes)], axis=1)
    xinf = np.abs(x).max(axis=0)
    y = np.zeros((n, probes))   # A x
    z = np.zeros((n, probes))   # L (L^T x)
    rowsum = np.zeros(n)        # streaming ||A||_inf
    gen = getattr(store._lib, f"dla_plgsy_{store._suf}")
    # One preallocated fp64 work buffer, reused every panel: per-panel
    # astype() temporaries would malloc/free ~2 panel-sizes per iteration,
    # and on the JAX package's host VM freed pages were harvested by the
    # host balloon — every refault cost host-page-supply time (measured
    # down to ~6 MB/s).
    # Allocate once, never free (same policy as the store's buffer pool).
    work = _aligned_empty(n * w * 8).view(np.float64)
    for k in range(store.npan):
        k0 = k * w
        h = n - k0
        # --- L panel: u = B^T x[k0:], then z[k0:] += B u (B's diagonal
        # block is lower-triangular — the factor wrote tril only)
        lbuf = store.pack(k0, k0, h, w)
        b = work[: h * w].reshape(h, w)
        np.copyto(b, lbuf, casting="same_kind")
        store.release(lbuf)
        b[:w] = np.tril(b[:w])  # guard: ignore any stale upper bytes
        z[k0:] += b @ (b.T @ x[k0:])
        # --- A panel: regenerated in store dtype (exactly what was factored)
        abuf = store._acquire(h, w)
        gen(abuf.ctypes.data, w, seed & 0xFFFFFFFF, k0, k0, h, w, bump)
        a = b  # reuse the same fp64 work buffer
        np.copyto(a, abuf, casting="same_kind")
        store.release(abuf)
        # lower-panel contribution: rows k0..n get columns k0..k0+w
        y[k0:] += a @ x[k0 : k0 + w]
        # symmetric (upper) contribution: rows k0..k0+w get columns k0+w..n
        strict = a[w:]
        y[k0 : k0 + w] += strict.T @ x[k0 + w :]
        # ||A||_inf row sums last — |a| in place (no panel-size temporary)
        np.abs(a, out=a)
        rowsum[k0:] += a.sum(axis=1)
        rowsum[k0 : k0 + w] += a[w:].sum(axis=0)
        if on_panel:
            on_panel(k, store.npan)
    norm_a = rowsum.max()
    err = np.abs(y - z).max(axis=0)
    return float((err / xinf).max() / norm_a)
