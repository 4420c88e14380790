"""Out-of-core POTRF — counterpart of ``dla_tpu/algos/oocore.py``: the
matrix lives on the host, column panels stream through the card.

The capability target is BASELINE.json config 5 (N=262144 with host-DRAM
tile staging) — the scale regime the reference served with its distributed
blob store (the ArmoniK client holds the full matrix, workers hold O(B²) —
SURVEY §5.7). The design:

- the matrix lives in a :class:`~dla_tpu_torch.runtime.staging.HostTileStore`
  (page-aligned RAM or disk-backed memmap) or a
  :class:`~dla_tpu_torch.runtime.staging.DirectPanelStore` (lower panels on
  disk, O_DIRECT, optional write-through RAM cache); the native C++ runtime
  does the strided panel gather/scatter;
- a **left-looking** panel algorithm streams one column panel at a time to
  the device: panel j is updated against every previously factored panel k
  (one GEMM per k), then factored on the device (blocked right-looking within
  the panel), then scattered back. Device working set: three panels of N·w
  elements and the GEMMs' temporaries, independent of how many panels there
  are;
- the k-panel stream is **double-buffered**: a host thread packs panel k+1
  into a pinned buffer and starts its copy on a copy stream while the card
  runs the update GEMM against panel k (the reference's pinned-buffer DMA
  overlap, ``v6_script_cholesky_w_residu_malloc.c:41-58``); events order the
  copy before its GEMM, and the GEMM before the next copy into its slot;
- factored panels are committed **transactionally** when a progress
  sidecar is used: the factored panel is first written to a scratch file
  (atomic rename) or the panel store's scratch region, the sidecar records
  the in-flight commit, and only then is the store overwritten — a crash
  anywhere leaves either the pristine panel or a durable copy of the factored
  one, never a torn write (an interrupted run resumes at the first unfinished
  panel);
- validation at this scale is a Freivalds residual probe (O(N²) per probe,
  native or streamed) instead of a dense O(N³) reconstruction.

``host_blas=True`` runs the same panel algorithm in place on the host with
direct OpenBLAS calls, as the JAX package's host path does, with its bits.

``mesh=`` is the distributed configuration (the JAX package's BASELINE config
5 at multi-chip scale): each streamed panel is split by rows over the
``mesh.size`` members, and every update GEMM and every step of the panel
factor runs per member on its own rows. The rows a step needs from other
members (the top ``w`` rows of a k panel, the diagonal block and the solved
rows that the in-panel update reads) are gathered through
:mod:`~dla_tpu_torch.parallel.member_comm`, as JAX's partitioner all-gathers
them. The members share one device, so their rows are views of one slot; a
mesh whose members span cards raises ``NotImplementedError`` (ROADMAP A9d).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from dla_tpu_torch.algos.potrf import _cholesky
from dla_tpu_torch.ops import gemm, trsm
from dla_tpu_torch.parallel import member_comm as comm
from dla_tpu_torch.runtime.staging import HostTileStore


def _fsync_dir(path: str) -> None:
    """fsync a directory so a completed rename survives power loss."""
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:  # pragma: no cover - exotic fs
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _rows(slabs: list, h: int, r0: int, r1: int, cols: slice) -> torch.Tensor:
    """Rows [r0, r1), columns ``cols``, of a panel split by rows over members
    of h rows each: a view where one member holds them all, else the
    members' pieces gathered."""
    parts = [slabs[m][max(r0 - m * h, 0) : min(r1 - m * h, h), cols]
             for m in range(r0 // h, min(len(slabs), -(-r1 // h)))]
    return parts[0] if len(parts) == 1 else comm.all_gather_tiled(parts)


def _own_rows(slabs: list, h: int, r0: int):
    """(member, its first local row) of every member holding rows ≥ r0."""
    return [(m, max(r0 - m * h, 0)) for m in range(len(slabs)) if (m + 1) * h > r0]


def _update(slabs: list, lk: torch.Tensor, w: int) -> list:
    """Left-looking accumulation against the streamed panel ``lk`` (split by
    rows as ``slabs``): each member's rows −= its rows of Lk · Lk[:w]ᵀ."""
    h = slabs[0].shape[0]
    lks = list(lk.split(h))
    top = _rows(lks, h, 0, w, slice(None))
    return [gemm(-1.0, lm, top, 1.0, pm, transb=True) for lm, pm in zip(lks, slabs)]


def _factor_panel(slabs: list, nb: int) -> None:
    """Blocked right-looking factor of a tall panel (m, w), m ≥ w, split by
    rows over members (``slabs``, h rows each), in place (the JAX package's
    ``_jitted("factor")``). fp64 solves the blocks below each diagonal block
    by true substitution; the other dtypes by an nb×nb triangular inverse and
    one GEMM (its explicit inverse amplifies error by ~κ(L_kk), fine for the
    fp32 residual class). The strict upper triangle of the top w×w square
    outside the nb×nb diagonal blocks keeps what it held, as in the JAX
    package: only tril is meaningful. The device path needs no row chunking:
    the JAX package's ``_ROW_CHUNK`` works around its XLA CPU backend's TLB
    behaviour on multi-GiB GEMMs, which cuBLAS does not share."""
    h, w = slabs[0].shape
    m = h * len(slabs)
    for off in range(0, w, nb):
        bw = min(nb, w - off)
        cols = slice(off, off + bw)
        lkk = torch.tril(_cholesky(_rows(slabs, h, off, off + bw, cols)))
        for mm, lo in _own_rows(slabs, h, off):
            hi = min(off + bw - mm * h, h)
            if hi > lo:
                slabs[mm][lo:hi, cols] = lkk[mm * h + lo - off : mm * h + hi - off]
        if off + bw >= m:
            break
        inv = None
        if slabs[0].dtype != torch.float64:
            eye = torch.eye(bw, dtype=slabs[0].dtype, device=slabs[0].device)
            inv = trsm(1.0, lkk, eye, side="L", uplo="L", transa=False)
        mine = _own_rows(slabs, h, off + bw)
        for mm, lo in mine:
            bbelow = slabs[mm][lo:, cols]
            if inv is None:
                below = trsm(1.0, lkk, bbelow, side="R", uplo="L", transa=True)
            else:
                below = gemm(1.0, bbelow, inv, 0.0, torch.zeros_like(bbelow), transb=True)
            slabs[mm][lo:, cols] = below
        if off + bw < w:
            top = _rows(slabs, h, off + bw, w, cols)
            for mm, lo in mine:
                rest = slabs[mm][lo:, off + bw : w]
                slabs[mm][lo:, off + bw : w] = gemm(-1.0, slabs[mm][lo:, cols], top, 1.0, rest,
                                                    transb=True)


class _Sidecar:
    """Atomic progress sidecar with transactional panel commits.

    States per panel: absent (untouched in store) → committing (factored
    data durable in the scratch file, store possibly torn) → done (store
    holds the factored panel). All sidecar/scratch writes are
    write-tmp-then-rename, so every crash point recovers cleanly.
    """

    def __init__(self, path: str, n: int, panel: int, store=None):
        self.path = path
        self.scratch = path + ".commit.npy"
        self.n, self.panel = n, panel
        # A DirectPanelStore brings its own O_DIRECT scratch region (a .npy
        # staging copy would go through the page cache)
        self._store = store if hasattr(store, "write_scratch") else None
        self.done: set[int] = set()
        self.committing: int | None = None
        if os.path.exists(path):
            with open(path) as f:
                state = json.load(f)
            if state.get("n") == n and state.get("panel") == panel:
                self.done = set(state.get("done", []))
                self.committing = state.get("committing")

    def _write(self):
        tmp = self.path + ".tmp"
        state = {"n": self.n, "panel": self.panel, "done": sorted(self.done)}
        if self.committing is not None:
            state["committing"] = self.committing
        with open(tmp, "w") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())  # sidecar durable before the rename lands
        os.replace(tmp, self.path)
        _fsync_dir(os.path.dirname(self.path) or ".")

    def stage(self, j: int, data: np.ndarray):
        """Durably record panel j's factored data before the store is touched.

        Power-loss ordering: the scratch bytes are fsync'd (O_DIRECT writes
        are durable at completion; the .npy fallback fsyncs explicitly)
        BEFORE the sidecar's 'committing' record, so recovery never replays
        a torn scratch region."""
        if self._store is not None:
            self._store.write_scratch(data)
        else:
            tmp = self.scratch + ".tmp"
            with open(tmp, "wb") as f:
                np.save(f, data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.scratch)
            _fsync_dir(os.path.dirname(self.scratch) or ".")
        self.committing = j
        self._write()

    def commit(self, j: int):
        self.done.add(j)
        self.committing = None
        self._write()
        if self._store is None and os.path.exists(self.scratch):
            os.remove(self.scratch)

    def recover(self, store: HostTileStore):
        """Replay an interrupted commit: the scratch file is the source of
        truth for the in-flight panel (the store may hold a torn write)."""
        j = self.committing
        if j is None:
            return
        if self._store is not None:
            # the sidecar's `committing` is only written after the scratch
            # region write completed, so the scratch is whole
            self._store.commit_scratch(j)
            self.commit(j)
        elif os.path.exists(self.scratch):
            data = np.load(self.scratch)
            store.unpack(j * self.panel, j * self.panel, data)
            self.commit(j)
        else:
            # crashed between sidecar write and scratch rename is impossible
            # (scratch is written first); a missing scratch means the stage()
            # itself never completed — the store panel is still pristine.
            self.committing = None
            self._write()


def _potrf_outofcore_host(
    store: HostTileStore,
    *,
    panel: int,
    nb: int,
    progress_path: str | None,
    on_panel: Callable[[int, int], None] | None,
    prefetch: bool,
) -> dict:
    """Host-BLAS out-of-core POTRF: the same left-looking panel algorithm as
    the device path, executed fully **in place** with direct OpenBLAS calls
    (`runtime.hostblas`) — zero temporaries, no defensive copies. The
    reference's host side made exactly these direct BLAS calls under
    Chameleon (SURVEY §1 L0). A copy of the JAX package's host path: the
    same calls in the same order."""
    from dla_tpu_torch.runtime import hostblas as hb

    n = store.n
    if n % panel:
        raise ValueError(f"n={n} must be a multiple of panel={panel}")
    npan = n // panel
    side = _Sidecar(progress_path, n, panel, store=store) if progress_path else None
    if side:
        side.recover(store)
    releases = getattr(store, "release", None)

    stats = {
        "pack_s": 0.0, "h2d_wait_s": 0.0, "writeback_s": 0.0,
        "bytes_in": 0, "bytes_out": 0, "wall_s": 0.0, "panels": 0,
    }
    wall0 = time.perf_counter()
    item = store.dtype.itemsize
    pool = ThreadPoolExecutor(max_workers=1) if prefetch else None

    def fetch(j0: int, k0: int, ph: int) -> np.ndarray:
        t0 = time.perf_counter()
        buf = store.pack(j0, k0, ph, panel)
        stats["pack_s"] += time.perf_counter() - t0
        stats["bytes_in"] += ph * panel * item
        return buf

    try:
        for j in range(npan):
            if side and j in side.done:
                continue
            j0 = j * panel
            ph = n - j0
            pj = fetch(j0, j0, ph)
            nxt = pool.submit(fetch, j0, 0, ph) if pool and j > 0 else None
            for k in range(j):
                t0 = time.perf_counter()
                lk = nxt.result() if nxt is not None else fetch(j0, k * panel, ph)
                stats["h2d_wait_s"] += time.perf_counter() - t0
                if pool and k + 1 < j:
                    nxt = pool.submit(fetch, j0, (k + 1) * panel, ph)
                else:
                    nxt = None
                # pj -= Lk · Lk[:w]ᵀ, in place (BLAS releases the GIL, so
                # the prefetch memcpy/read overlaps even on one core)
                hb.gemm(-1.0, lk, lk[:panel], 1.0, pj, transb=True)
                if releases is not None:
                    releases(lk)
            hb.factor_panel(pj, nb)
            t0 = time.perf_counter()
            if side:
                side.stage(j, pj)
            store.unpack(j0, j0, pj)
            if side:
                side.commit(j)
            stats["writeback_s"] += time.perf_counter() - t0
            stats["bytes_out"] += pj.nbytes
            stats["panels"] += 1
            if releases is not None:
                releases(pj)
            if on_panel:
                on_panel(j, npan)
    finally:
        if pool:
            pool.shutdown(wait=False, cancel_futures=True)
    stats["wall_s"] = time.perf_counter() - wall0
    return stats


class _NoEvent:
    """A CPU copy is complete when ``copy_`` returns: nothing to wait for."""

    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


class _Slot:
    """One device buffer for a streamed panel, with the host buffer its copy
    reads from and two events: ``copied`` (the copy into ``dev`` finished, so
    the host buffer may be refilled and its reader may start) and ``free``
    (the last computation reading ``dev`` finished, so the next copy may
    overwrite it)."""

    def __init__(self, rows: int, w: int, dtype: torch.dtype, device: torch.device,
                 host: bool):
        cuda = device.type == "cuda"
        self.dev = torch.empty((rows, w), dtype=dtype, device=device)
        # a pinned host buffer to pack into, for stores that pack into one
        self.host = (torch.empty((rows, w), dtype=dtype, pin_memory=cuda).numpy()
                     if host else None)
        self.copied = torch.cuda.Event() if cuda else _NoEvent()
        self.free = torch.cuda.Event() if cuda else _NoEvent()
        self.pending = None  # a pool buffer to release once `copied` completes


class _Stager:
    """Host → device copies of streamed panels, and their buffers' lifetimes.

    Buffers are reused only once safe: a slot's pinned host buffer, or the
    store's pool buffer its last copy read, is refilled (or released to the
    pool) only after that copy's ``copied`` event; a slot's device buffer is
    overwritten only after the computation that read it recorded ``free``.
    A pooled store's (``DirectPanelStore``'s) buffers are pinned in place
    (``cudaHostRegister``) the first time a copy reads one, and unpinned by
    :meth:`close`."""

    def __init__(self, store, device: torch.device, rows: int, w: int, dtype: torch.dtype,
                 stats: dict):
        self.store, self.device, self.w, self.stats = store, device, w, stats
        self.cuda = device.type == "cuda"
        self.release = getattr(store, "release", None)
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None
        self.slots = [_Slot(rows, w, dtype, device, host=self.release is None)
                      for _ in range(3)]  # the panel j, and two for panels k
        self.item = store.dtype.itemsize
        self._pinned: dict[int, int] = {}  # address → bytes of registered pool buffers

    def _pin(self, buf: np.ndarray) -> None:
        """Register a pool buffer with CUDA so its copy runs asynchronously.
        Every view the pool hands out of one buffer starts at the buffer's
        address, and within one factorization the streamed heights never
        grow (panels shrink down the matrix; a bucket rounds each up, never
        past an earlier one), so the first view registered of a buffer is
        its largest."""
        ptr, nbytes = buf.ctypes.data, buf.nbytes
        have = self._pinned.get(ptr)
        if have is None:
            torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(ptr, nbytes, 0))
            self._pinned[ptr] = nbytes
        elif have < nbytes:
            raise RuntimeError(f"pool buffer at {ptr:#x} grew from {have} to {nbytes} bytes")

    def fetch(self, s: int, j0: int, k0: int, ph: int) -> torch.Tensor:
        """Pack rows j0.. of the panel at column k0 (ph rows) and start its
        copy into slot ``s``; the returned view of the slot's device buffer
        is ready once the compute stream waited for ``slot.copied``."""
        slot = self.slots[s]
        t0 = time.perf_counter()
        slot.copied.synchronize()  # the previous copy out of this slot's host side is done
        if slot.pending is not None:
            self.release(slot.pending)
            slot.pending = None
        if self.release is None:
            buf = self.store.pack(j0, k0, ph, self.w, out=slot.host[:ph])
        else:
            buf = self.store.pack(j0, k0, ph, self.w)
            if self.cuda:
                self._pin(buf)
        t1 = time.perf_counter()
        dst = slot.dev[:ph]
        src = torch.from_numpy(buf)
        if self.cuda:
            with torch.cuda.stream(self.copy_stream):
                self.copy_stream.wait_event(slot.free)
                dst.copy_(src, non_blocking=True)
                slot.copied.record(self.copy_stream)
            if self.release is not None:
                slot.pending = buf
        else:
            dst.copy_(src)
            if self.release is not None:
                self.release(buf)
        self.stats["pack_s"] += t1 - t0
        self.stats["bytes_in"] += ph * self.w * self.item
        return dst

    def ready(self, s: int) -> None:
        """Make the compute stream wait for slot ``s``'s copy."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(self.slots[s].copied)

    def done_reading(self, s: int) -> None:
        """Record that the computations enqueued so far are all that read slot ``s``."""
        if self.cuda:
            self.slots[s].free.record(torch.cuda.current_stream(self.device))

    def close(self) -> None:
        """Wait for every copy, release pending pool buffers, unpin them."""
        if self.cuda:
            self.copy_stream.synchronize()
        for slot in self.slots:
            if slot.pending is not None:
                self.release(slot.pending)
                slot.pending = None
        for ptr in self._pinned:
            torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(ptr))
        self._pinned.clear()


def potrf_outofcore(
    store: HostTileStore,
    *,
    panel: int = 4096,
    nb: int = 512,
    progress_path: str | None = None,
    on_panel: Callable[[int, int], None] | None = None,
    prefetch: bool = True,
    mesh=None,
    height_bucket: int | None = None,
    host_blas: bool = False,
    device=None,
) -> dict:
    """Factor the SPD matrix in ``store`` in place (lower triangle becomes L).

    Args:
      store: host-resident matrix (only the lower triangle is read/written):
        a :class:`~dla_tpu_torch.runtime.staging.HostTileStore` or a
        :class:`~dla_tpu_torch.runtime.staging.DirectPanelStore`.
      panel: column-panel width streamed to the device (device working set
        is ~3 · N · panel elements plus the GEMMs' temporaries).
      nb: blocking inside the on-device panel factorization.
      progress_path: optional JSON sidecar for checkpoint/resume — panels
        recorded there are skipped, and panel writebacks become
        transactional (scratch staged) so a crash mid-writeback cannot
        corrupt the store (use with a disk-backed store).
      on_panel: optional callback(panel_index, n_panels) after each panel.
      prefetch: overlap the host pack and copy of panel k+1 with the update
        GEMM against panel k (double buffering).
      height_bucket: round every streamed panel height up to a multiple of
        this (zero-padded rows below the matrix; requires a store whose
        ``pack`` supports overhang, i.e. ``DirectPanelStore``). The JAX
        package introduced it to bound its per-shape compiles; here it keeps
        its meaning: padded rows are inert (zero GEMM contributions,
        untouched by the diagonal factor) and are sliced off before
        writeback.
      host_blas: execute the panel algorithm fully in place with direct
        OpenBLAS calls on the host (no device) — the JAX package's host path,
        with its bits. Excludes ``mesh`` and ``height_bucket``.
      mesh: the distributed out-of-core configuration: a member mesh
        (``parallel.make_mesh`` or ``make_flat_mesh``) over whose
        ``mesh.size`` members every streamed panel is split by rows; the
        update GEMMs and the panel factor run per member. Requires ``panel``
        to be a multiple of ``mesh.size``; excludes ``host_blas`` and
        ``height_bucket``.
      device: where the panels are updated and factored: the card unless
        ``device="cpu"`` is given (with ``mesh``: the members' device). A
        missing card raises; nothing falls back.

    Returns:
      staging stats: bytes/seconds for pack (host gather), h2d wait, compute
      sync, d2h + scatter, and total wall — the measured staging bandwidth.
    """
    if host_blas:
        if mesh is not None or height_bucket is not None:
            raise ValueError(
                "host_blas is the single-host in-place path — no mesh, and "
                "height_bucket is a device-shape option it doesn't need"
            )
        return _potrf_outofcore_host(
            store, panel=panel, nb=nb, progress_path=progress_path,
            on_panel=on_panel, prefetch=prefetch,
        )
    if mesh is not None:
        if len(set(mesh.devices)) > 1:
            raise NotImplementedError(
                "potrf_outofcore: a mesh whose members span several cards is not supported yet "
                "(ROADMAP A9d: out of core on a mesh across cards); its members share one "
                "device, whose panel rows are views of one slot")
        if getattr(mesh, "spans_processes", False):
            raise NotImplementedError("potrf_outofcore: a mesh across processes is not "
                                      "supported; the streamed panels live on one host")
        if device is not None and torch.device(device) != mesh.devices[0]:
            raise ValueError(f"device={device} but the mesh's members lie on {mesh.devices[0]}")
        device = mesh.devices[0]
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("potrf_outofcore: no CUDA device is available; pass device='cpu' "
                           "to factor on the CPU")

    n = store.n
    if n % panel:
        raise ValueError(f"n={n} must be a multiple of panel={panel}")
    npan = n // panel
    members = 1
    if mesh is not None:
        members = mesh.size
        if panel % members:
            raise ValueError(f"panel={panel} must be a multiple of mesh.size={members}")
        if height_bucket is not None:
            raise ValueError("height_bucket is a single-device optimization")
    if height_bucket is not None and not hasattr(store, "commit_scratch"):
        raise ValueError(
            "height_bucket requires a panel store whose pack() supports "
            "zero-padded overhang (DirectPanelStore)"
        )
    side = _Sidecar(progress_path, n, panel, store=store) if progress_path else None
    if side:
        side.recover(store)

    stats = {
        "pack_s": 0.0, "h2d_wait_s": 0.0, "sync_s": 0.0, "writeback_s": 0.0,
        "bytes_in": 0, "bytes_out": 0, "wall_s": 0.0, "panels": 0,
    }
    wall0 = time.perf_counter()
    dtype = torch.from_numpy(np.empty(0, store.dtype)).dtype
    cuda = device.type == "cuda"
    pool = ThreadPoolExecutor(max_workers=1) if prefetch else None
    ctx = torch.cuda.device(device) if cuda else contextlib.nullcontext()
    with ctx:
        stager = _Stager(store, device, n, panel, dtype, stats)
        # the factored panel comes back through one pinned buffer
        wb = torch.empty((n, panel), dtype=dtype, pin_memory=cuda)

        def fetch(s, j0, k0, ph):
            with ctx:  # the prefetch thread's current device
                return stager.fetch(s, j0, k0, ph)

        try:
            for j in range(npan):
                if side and j in side.done:
                    continue
                j0 = j * panel
                ph = n - j0
                if height_bucket is not None:
                    ph = min(n, -(-ph // height_bucket) * height_bucket)
                slabs = list(fetch(0, j0, j0, ph).split(ph // members))
                stager.ready(0)
                nxt = pool.submit(fetch, 1, j0, 0, ph) if pool and j > 0 else None
                for k in range(j):
                    s = 1 + k % 2
                    t0 = time.perf_counter()
                    lk = nxt.result() if nxt is not None else fetch(s, j0, k * panel, ph)
                    stats["h2d_wait_s"] += time.perf_counter() - t0
                    if pool and k + 1 < j:
                        nxt = pool.submit(fetch, 1 + (k + 1) % 2, j0, (k + 1) * panel, ph)
                    else:
                        nxt = None
                    stager.ready(s)
                    # left-looking accumulation: panel -= Lk · Lk[:w]ᵀ
                    slabs = _update(slabs, lk, panel)
                    stager.done_reading(s)
                _factor_panel(slabs, nb)
                t0 = time.perf_counter()
                if cuda:
                    torch.cuda.current_stream(device).synchronize()
                stats["sync_s"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                if cuda:
                    h = ph // members
                    for m, sl in enumerate(slabs):  # d2h, returns when done
                        wb[m * h : (m + 1) * h].copy_(sl)
                    host_pj = wb.numpy()[: n - j0]  # drop bucketed pad rows
                else:
                    pj = slabs[0] if members == 1 else torch.cat(slabs)
                    host_pj = pj[: n - j0].numpy()
                stager.done_reading(0)
                if side:
                    side.stage(j, host_pj)
                store.unpack(j0, j0, host_pj)
                if side:
                    side.commit(j)
                stats["writeback_s"] += time.perf_counter() - t0
                stats["bytes_out"] += host_pj.nbytes
                stats["panels"] += 1
                del slabs, host_pj
                if on_panel:
                    on_panel(j, npan)
        finally:
            if pool:
                pool.shutdown(wait=True, cancel_futures=True)
            stager.close()
    stats["wall_s"] = time.perf_counter() - wall0
    return stats
