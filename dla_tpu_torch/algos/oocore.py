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
  elements (on a mesh over several cards, each card's share of them) and the
  GEMMs' temporaries, independent of how many panels there are;
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
``mesh.size`` members (member m holds rows [m·h, (m+1)·h), h = ph / size, in
the order of JAX's ``PartitionSpec(axis_names, None)``), and every update
GEMM and every step of the panel factor runs per member on its own rows, on
its own card. The store packs each panel once into one host buffer; each
member's rows are copied from it onto its card, on that card's copy stream,
so a card holds three slots of its members' rows. The rows a step needs from
other members (the top ``w`` rows of a k panel, the diagonal block and the
solved rows that the in-panel update reads) are gathered through
:mod:`~dla_tpu_torch.parallel.member_comm`, as JAX's partitioner all-gathers
them: each reaches every other card that reads it once, by peer copy, and the
diagonal block's factor (and inverse) is formed once, on the card of the
member holding its first row. The same products on the same shapes give a
mesh spread over the cards the bits of the same mesh on one card. A mesh
across processes raises ``NotImplementedError``, as the JAX package cannot
run one either (its store is one host's, and its writeback reads only this
process's shards and asserts they cover the panel,
``dla_tpu/algos/oocore.py:499-508``).
"""

from __future__ import annotations

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
from dla_tpu_torch.parallel.potrf_dist import _deliver
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


def _rows(slabs: list, h: int, r0: int, r1: int, cols: slice, devices, dst) -> torch.Tensor:
    """Rows [r0, r1), columns ``cols``, of a panel split by rows over members
    of h rows each (member m's rows on ``devices[m]``), on card ``dst``: each
    member's piece delivered there, then gathered; always a contiguous block,
    whichever card holds which piece."""
    parts = [_deliver(slabs[m][max(r0 - m * h, 0) : min(r1 - m * h, h), cols], devices[m], dst)
             for m in range(r0 // h, min(len(slabs), -(-r1 // h)))]
    return parts[0].contiguous() if len(parts) == 1 else comm.all_gather_tiled(parts)


def _own_rows(slabs: list, h: int, r0: int):
    """(member, its first local row) of every member holding rows ≥ r0."""
    return [(m, max(r0 - m * h, 0)) for m in range(len(slabs)) if (m + 1) * h > r0]


def _cards(devices, members) -> list:
    """The cards of ``members``, each once, in member order."""
    return comm.cards_of(devices[m] for m in members)


def _update(slabs: list, lks: list, w: int, devices) -> list:
    """Left-looking accumulation against the streamed panel Lk (split by rows
    as ``slabs``, member m's rows ``lks[m]``, on ``devices[m]``): each member's
    rows −= its rows of Lk · Lk[:w]ᵀ, Lk[:w] delivered once to each card."""
    h = slabs[0].shape[0]
    tops = {d: _rows(lks, h, 0, w, slice(None), devices, d) for d in comm.cards_of(devices)}
    out = []
    for lm, pm, d in zip(lks, slabs, devices):
        with comm.on(d):
            out.append(gemm(-1.0, lm, tops[d], 1.0, pm, transb=True))
    return out


def _factor_panel(slabs: list, nb: int, devices) -> None:
    """Blocked right-looking factor of a tall panel (m, w), m ≥ w, split by
    rows over members (``slabs``, h rows each, member m's on ``devices[m]``),
    in place (the JAX package's ``_jitted("factor")``). Each diagonal block is
    factored once, on the card of the member holding its first row, and its
    factor (fp64) or inverse reaches each other card whose members read it;
    the solved rows the in-panel update reads likewise. fp64 solves the
    blocks below each diagonal block by true substitution; the other dtypes
    by an nb×nb triangular inverse and one GEMM (its explicit inverse
    amplifies error by ~κ(L_kk), fine for the fp32 residual class). The
    strict upper triangle of the top w×w square outside the nb×nb diagonal
    blocks keeps what it held, as in the JAX package: only tril is
    meaningful. The device path needs no row chunking: the JAX package's
    ``_ROW_CHUNK`` works around its XLA CPU backend's TLB behaviour on
    multi-GiB GEMMs, which cuBLAS does not share."""
    h, w = slabs[0].shape
    m = h * len(slabs)
    fp64 = slabs[0].dtype == torch.float64
    for off in range(0, w, nb):
        bw = min(nb, w - off)
        cols = slice(off, off + bw)
        src = devices[off // h]
        with comm.on(src):
            lkk = torch.tril(_cholesky(_rows(slabs, h, off, off + bw, cols, devices, src)))
        diag = [(mm, lo, min(off + bw - mm * h, h)) for mm, lo in _own_rows(slabs, h, off)]
        diag = [(mm, lo, hi) for mm, lo, hi in diag if hi > lo]
        mine = _own_rows(slabs, h, off + bw) if off + bw < m else []
        readers = _cards(devices, [mm for mm, _ in mine])
        # the factor reaches the cards storing its rows and (fp64) those solving below it
        lkk_readers = [mm for mm, _, _ in diag] + ([mm for mm, _ in mine] if fp64 else [])
        lkks = {d: _deliver(lkk, src, d) for d in _cards(devices, lkk_readers)}
        for mm, lo, hi in diag:
            slabs[mm][lo:hi, cols] = lkks[devices[mm]][mm * h + lo - off : mm * h + hi - off]
        if not mine:
            break
        if not fp64:
            with comm.on(src):
                eye = torch.eye(bw, dtype=lkk.dtype, device=lkk.device)
                inv = trsm(1.0, lkk, eye, side="L", uplo="L", transa=False)
            invs = {d: _deliver(inv, src, d) for d in readers}
        for mm, lo in mine:
            with comm.on(devices[mm]):
                bbelow = slabs[mm][lo:, cols]
                if fp64:
                    below = trsm(1.0, lkks[devices[mm]], bbelow, side="R", uplo="L", transa=True)
                else:
                    below = gemm(1.0, bbelow, invs[devices[mm]], 0.0, torch.zeros_like(bbelow),
                                 transb=True)
                slabs[mm][lo:, cols] = below
        if off + bw < w:
            tops = {d: _rows(slabs, h, off + bw, w, cols, devices, d) for d in readers}
            for mm, lo in mine:
                with comm.on(devices[mm]):
                    rest = slabs[mm][lo:, off + bw : w]
                    slabs[mm][lo:, off + bw : w] = gemm(-1.0, slabs[mm][lo:, cols],
                                                        tops[devices[mm]], 1.0, rest, transb=True)


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
    """One streamed panel's buffers: the pinned host buffer its copies read
    (for stores that pack into one), and on each card a device buffer for the
    rows of that card's members, with two events a card: ``copied`` (the copy
    onto that card finished, so the host buffer may be refilled once every
    card's has, and the card's readers may start) and ``free`` (the last
    computation reading that card's buffer finished, so the next copy may
    overwrite it)."""

    def __init__(self, rows: int, w: int, dtype: torch.dtype, parts: dict, host: bool):
        cuda = next(iter(parts)).type == "cuda"
        self.dev = {d: torch.empty((r, w), dtype=dtype, device=d) for d, r in parts.items()}
        # a pinned host buffer to pack into, for stores that pack into one
        self.host = (torch.empty((rows, w), dtype=dtype, pin_memory=cuda).numpy()
                     if host else None)
        self.copied = {d: torch.cuda.Event() if cuda else _NoEvent() for d in parts}
        self.free = {d: torch.cuda.Event() if cuda else _NoEvent() for d in parts}
        self.pending = None  # a pool buffer to release once every `copied` completes


class _Stager:
    """Host → device copies of streamed panels, and their buffers' lifetimes.

    Each panel is packed once, into one host buffer; member m's rows of it
    (rows [m·h, (m+1)·h)) are copied onto ``devices[m]``, on that card's copy
    stream, into the card's buffer of the slot, its members' rows in member
    order. Buffers are reused only once safe: a slot's pinned host buffer, or
    the store's pool buffer its last copies read, is refilled (or released to
    the pool) only after every card's ``copied`` event; a card's buffer of a
    slot is overwritten only after the computation that read it recorded
    ``free`` there. A pooled store's (``DirectPanelStore``'s) buffers are
    pinned in place (``cudaHostRegister``, portable: pinned for every card)
    once each, the first time a copy reads one, and unpinned by
    :meth:`close`."""

    def __init__(self, store, devices, rows: int, w: int, dtype: torch.dtype, stats: dict):
        self.store, self.devices, self.w, self.stats = store, list(devices), w, stats
        self.cards = comm.cards_of(self.devices)
        self.cuda = self.cards[0].type == "cuda"
        self.release = getattr(store, "release", None)
        # each card's members, in member order: their rows' place in its buffers
        self.held = {d: [m for m, dm in enumerate(self.devices) if dm == d] for d in self.cards}
        self.copy_streams = {d: torch.cuda.Stream(d) for d in self.cards} if self.cuda else {}
        h = rows // len(self.devices)
        self.slots = [_Slot(rows, w, dtype, {d: len(ms) * h for d, ms in self.held.items()},
                            host=self.release is None)
                      for _ in range(3)]  # the panel j, and two for panels k
        self.item = store.dtype.itemsize
        self._pinned: dict[int, int] = {}  # address → bytes of registered pool buffers

    def _pin(self, buf: np.ndarray) -> None:
        """Register a pool buffer with CUDA, once for the host, so every
        card's copy of it runs asynchronously. Every view the pool hands out
        of one buffer starts at the buffer's address, and within one
        factorization the streamed heights never grow (panels shrink down
        the matrix; a bucket rounds each up, never past an earlier one), so
        the first view registered of a buffer is its largest."""
        ptr, nbytes = buf.ctypes.data, buf.nbytes
        have = self._pinned.get(ptr)
        if have is None:
            portable = 1  # cudaHostRegisterPortable
            with comm.on(self.cards[0]):
                torch.cuda.check_error(
                    torch.cuda.cudart().cudaHostRegister(ptr, nbytes, portable))
            self._pinned[ptr] = nbytes
        elif have < nbytes:
            raise RuntimeError(f"pool buffer at {ptr:#x} grew from {have} to {nbytes} bytes")

    def fetch(self, s: int, j0: int, k0: int, ph: int) -> list:
        """Pack rows j0.. of the panel at column k0 (ph rows) and start the
        copy of each member's rows onto its card into slot ``s``; returns the
        members' views of the slot's device buffers, each ready once its
        card's compute stream waited for ``slot.copied`` there."""
        slot = self.slots[s]
        t0 = time.perf_counter()
        for ev in slot.copied.values():  # the previous copies out of this slot's host side
            ev.synchronize()
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
        src = torch.from_numpy(buf)
        h = ph // len(self.devices)
        views = [None] * len(self.devices)
        for d, members in self.held.items():
            for i, m in enumerate(members):
                views[m] = slot.dev[d][i * h : (i + 1) * h]
            if self.cuda:
                stream = self.copy_streams[d]
                with comm.on(d), torch.cuda.stream(stream):
                    stream.wait_event(slot.free[d])
                    for m in members:
                        views[m].copy_(src[m * h : (m + 1) * h], non_blocking=True)
                    slot.copied[d].record(stream)
            else:
                for m in members:
                    views[m].copy_(src[m * h : (m + 1) * h])
        if self.release is not None:
            if self.cuda:
                slot.pending = buf
            else:
                self.release(buf)
        self.stats["pack_s"] += t1 - t0
        self.stats["bytes_in"] += ph * self.w * self.item
        return views

    def ready(self, s: int) -> None:
        """Make every card's compute stream wait for its copy of slot ``s``."""
        if self.cuda:
            for d in self.cards:
                torch.cuda.current_stream(d).wait_event(self.slots[s].copied[d])

    def done_reading(self, s: int) -> None:
        """Record that the computations enqueued so far, on every card, are
        all that read slot ``s``."""
        if self.cuda:
            for d in self.cards:
                self.slots[s].free[d].record(torch.cuda.current_stream(d))

    def close(self) -> None:
        """Wait for every copy, release pending pool buffers, unpin them."""
        for stream in self.copy_streams.values():
            stream.synchronize()
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
        update GEMMs and the panel factor run per member, each on its own
        card (a mesh made without ``device=`` spreads over the visible
        cards). Requires ``panel`` to be a multiple of ``mesh.size``;
        excludes ``host_blas`` and ``height_bucket``. A mesh across
        processes raises ``NotImplementedError``.
      device: where the panels are updated and factored: the card unless
        ``device="cpu"`` is given (with ``mesh``: the members' device, which
        must be theirs; a mesh over several cards takes none). A missing
        card raises; nothing falls back.

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
        if getattr(mesh, "spans_processes", False):
            raise NotImplementedError(
                "potrf_outofcore: a mesh across processes is not supported: the streamed "
                "panels live in one host's store, and the JAX package cannot run it either "
                "(its writeback reads only this process's shards and asserts that they cover "
                "the panel, dla_tpu/algos/oocore.py:499-508)")
        if device is not None:
            if len(mesh.cards) > 1:
                raise ValueError(f"device={device} but the mesh's members lie on several cards "
                                 f"({', '.join(map(str, mesh.cards))}); give no device")
            if torch.device(device) != mesh.devices[0]:
                raise ValueError(f"device={device} but the mesh's members lie on "
                                 f"{mesh.devices[0]}")
        devices = tuple(mesh.devices)
    else:
        devices = (torch.device("cuda" if device is None else device),)
    if devices[0].type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("potrf_outofcore: no CUDA device is available; pass device='cpu' "
                           "to factor on the CPU")
    devices = tuple(comm.member_device(d) for d in devices)

    n = store.n
    if n % panel:
        raise ValueError(f"n={n} must be a multiple of panel={panel}")
    npan = n // panel
    members = len(devices)
    if mesh is not None:
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
    cuda = devices[0].type == "cuda"
    pool = ThreadPoolExecutor(max_workers=1) if prefetch else None
    with comm.on(devices[0]):
        stager = _Stager(store, devices, n, panel, dtype, stats)
        # the factored panel comes back through one pinned buffer
        wb = torch.empty((n, panel), dtype=dtype, pin_memory=cuda)
    try:
        for j in range(npan):
            if side and j in side.done:
                continue
            j0 = j * panel
            ph = n - j0
            if height_bucket is not None:
                ph = min(n, -(-ph // height_bucket) * height_bucket)
            slabs = stager.fetch(0, j0, j0, ph)
            stager.ready(0)
            nxt = pool.submit(stager.fetch, 1, j0, 0, ph) if pool and j > 0 else None
            for k in range(j):
                s = 1 + k % 2
                t0 = time.perf_counter()
                lks = nxt.result() if nxt is not None else stager.fetch(s, j0, k * panel, ph)
                stats["h2d_wait_s"] += time.perf_counter() - t0
                if pool and k + 1 < j:
                    nxt = pool.submit(stager.fetch, 1 + (k + 1) % 2, j0, (k + 1) * panel, ph)
                else:
                    nxt = None
                stager.ready(s)
                # left-looking accumulation: panel -= Lk · Lk[:w]ᵀ
                slabs = _update(slabs, lks, panel, devices)
                stager.done_reading(s)
            _factor_panel(slabs, nb, devices)
            t0 = time.perf_counter()
            comm.synchronize(devices)
            stats["sync_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            if cuda:
                h = ph // members
                for m, sl in enumerate(slabs):  # d2h from each member's card, returns when done
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
