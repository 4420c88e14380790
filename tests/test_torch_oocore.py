"""dla_tpu_torch's out-of-core factorization (``algos/oocore.py``), its
streamed refinement (``algos/solve.py:posv_refined_streamed``) and its driver
(``cli/oocore_driver.py``), held against the JAX package on the CPU.

The same store contents (the native seeded generator, whose bits
``tests/test_torch_runtime.py`` checks) go through
``dla_tpu.algos.oocore.potrf_outofcore`` (JAX on the CPU, x64) and the
port's, on a flat ``HostTileStore`` and on a ``DirectPanelStore``, with and
without ``height_bucket``.

Tolerances:
- the device path (torch here, with ``device="cpu"``) against JAX's device
  path, max|ΔL| / max|L| over the lower triangle: ≤ 1e-12 in fp64 and
  ≤ 2e-5 in fp32 (the same algorithm through two BLAS libraries, which sum
  in other orders, on matrices with condition number ≈ 3);
- the host path (``host_blas=True``) against JAX's host path: the same bits
  (the same OpenBLAS calls in the same order, numpy's bundled library);
- a resumed factor (after a crash between panels, or a torn writeback)
  against an uninterrupted run of the same path: the same bits;
- ``posv_refined_streamed``: backward error under the reference's 1e-10
  in both packages, and x within 1e-9 of JAX's;
- the distributed path (``mesh=``, each panel split by rows over the
  members) against JAX's on the 8 virtual CPU devices of tests/conftest.py,
  and against the port's path without a mesh: the device path's tolerances;
- members on several cards (pretended here: the tensors stay on the CPU,
  ``member_comm.copy_to`` logs each block it is asked to move): the panel
  steps give the bits of the same mesh on one card, and each block crosses
  to exactly the cards whose members read it, once.

The Freivalds gates this path uses (``freivalds_streaming`` and
``HostTileStore.freivalds_residual``) must rise with a known relative
perturbation of tril(L) (1e-7 … 1e-3), in the port and in JAX.
"""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dla_tpu.algos as JA
import dla_tpu.parallel as JPAR
from dla_tpu.algos import oocore as J
from dla_tpu.algos import packed as JP
from dla_tpu.runtime import staging as JS
from dla_tpu_torch.algos import oocore as T
from dla_tpu_torch.algos import packed as TP
from dla_tpu_torch.algos import posv_refined_streamed, potrf_blocked
from dla_tpu_torch.cli import oocore_driver, potrf_driver
from dla_tpu_torch.ops import plgsy
from dla_tpu_torch.parallel import make_flat_mesh, make_mesh
from dla_tpu_torch.runtime import staging as TS
from test_torch_block_cyclic import _pretend_cards, _routes, _spread
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TOL = {np.float64: 1e-12, np.float32: 2e-5}
DTYPES = [np.float64, np.float32]


def _lower(store) -> np.ndarray:
    """tril of the factor held by either package's store, as a dense array."""
    if hasattr(store, "npan"):
        n, w = store.n, store.panel
        out = np.zeros((n, n), store.dtype)
        for j in range(store.npan):
            b = store.pack(j * w, j * w, n - j * w, w)
            out[j * w :, j * w : (j + 1) * w] = b
            store.release(b)
        return np.tril(out)
    return np.tril(store.array)


def _rel(got, ref):
    return float(np.abs(got.astype(np.float64) - ref).max() / np.abs(ref).max())


def _stores(kind, n, dtype, tmp_path, panel, ram_cache=False):
    """The same seeded matrix in a JAX store and a port store."""
    if kind == "flat":
        a, b = JS.HostTileStore(n, dtype), TS.HostTileStore(n, dtype)
    else:
        a = JS.DirectPanelStore(n, dtype, path=str(tmp_path / "jax.bin"), panel=panel,
                                direct=False, ram_cache=ram_cache)
        b = TS.DirectPanelStore(n, dtype, path=str(tmp_path / "port.bin"), panel=panel,
                                direct=False, ram_cache=ram_cache)
    a.fill_plgsy(seed=51)
    b.fill_plgsy(seed=51)
    return a, b


class TestDevicePath:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("kind,n,panel,nb,bucket,prefetch", [
        ("flat", 256, 64, 32, None, True),
        ("flat", 256, 64, 48, None, False),  # nb not dividing the panel
        ("panel", 384, 128, 32, None, True),
        ("panel", 384, 128, 64, 256, True),  # the last panel padded 128 → 256 rows
        ("panel", 384, 128, 64, 256, False),
    ])
    def test_matches_jax(self, tmp_path, dtype, kind, n, panel, nb, bucket, prefetch):
        a, b = _stores(kind, n, dtype, tmp_path, panel, ram_cache=bucket is not None)
        with a, b:
            J.potrf_outofcore(a, panel=panel, nb=nb, height_bucket=bucket, prefetch=prefetch)
            stats = T.potrf_outofcore(b, panel=panel, nb=nb, height_bucket=bucket,
                                      prefetch=prefetch, device="cpu")
            ref, got = _lower(a).astype(np.float64), _lower(b)
        assert got.dtype == dtype
        assert _rel(got, ref) <= TOL[dtype]
        assert stats["panels"] == n // panel
        assert set(stats) == {"pack_s", "h2d_wait_s", "sync_s", "writeback_s", "bytes_in",
                              "bytes_out", "wall_s", "panels"}
        item = np.dtype(dtype).itemsize
        heights = [n - j * panel for j in range(n // panel)]
        if bucket:
            heights = [min(n, -(-h // bucket) * bucket) for h in heights]
        assert stats["bytes_in"] == sum((j + 1) * h * panel * item for j, h in enumerate(heights))
        assert stats["bytes_out"] == n * (n + panel) // 2 * item

    def test_freivalds_gate_end_to_end(self):
        n = 256
        with TS.HostTileStore(n, np.float64) as st, TS.HostTileStore(n, np.float64) as orig:
            st.fill_plgsy(seed=51)
            orig.array[:] = np.tril(st.array)
            T.potrf_outofcore(st, panel=64, nb=32, device="cpu")
            assert orig.freivalds_residual(st) < 1e-10

    def test_non_spd_gives_nan_not_silence(self):
        n = 128
        with TS.HostTileStore(n, np.float64) as st:
            st.fill_plgsy(seed=51, bump=-1.0)
            T.potrf_outofcore(st, panel=32, nb=16, device="cpu")
            assert np.isnan(np.tril(st.array)).any()


class TestMesh:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("kind,n,panel,nb,p,q", [
        ("flat", 256, 64, 32, 2, 2),
        ("flat", 256, 64, 48, 2, 4),  # a diagonal block spans members (8 rows each at the end)
        ("panel", 384, 128, 32, 1, 4),
    ])
    def test_matches_jax_and_the_single_device_path(self, tmp_path, dtype, kind, n, panel, nb,
                                                    p, q):
        a, b = _stores(kind, n, dtype, tmp_path, panel)
        with a, b:
            J.potrf_outofcore(a, panel=panel, nb=nb, mesh=JPAR.make_mesh(p, q))
            stats = T.potrf_outofcore(b, panel=panel, nb=nb, mesh=make_mesh(p, q, device="cpu"))
            ref, got = _lower(a).astype(np.float64), _lower(b)
        assert got.dtype == dtype and stats["panels"] == n // panel
        assert _rel(got, ref) <= TOL[dtype]
        single = _uninterrupted(kind, tmp_path, n, panel, nb, dtype=dtype, device="cpu")
        assert _rel(got, single.astype(np.float64)) <= TOL[dtype]

    def test_flat_mesh_and_one_member(self):
        n, panel, nb = 128, 32, 16
        with TS.HostTileStore(n, np.float64) as st:
            st.fill_plgsy(seed=51)
            T.potrf_outofcore(st, panel=panel, nb=nb, mesh=make_flat_mesh(4, device="cpu"))
            four = _lower(st)
        with TS.HostTileStore(n, np.float64) as st:
            st.fill_plgsy(seed=51)
            T.potrf_outofcore(st, panel=panel, nb=nb, mesh=make_mesh(1, 1, device="cpu"))
            one = _lower(st)
        np.testing.assert_array_equal(
            one, _uninterrupted("flat", None, n, panel, nb, device="cpu"))
        assert _rel(four, one) <= TOL[np.float64]

    def test_kill_and_resume_same_bits(self, tmp_path):
        n, panel, nb = 128, 32, 16
        prog, mesh = str(tmp_path / "progress.json"), make_mesh(2, 2, device="cpu")

        def crash_after_two(j, npan):
            if j == 1:
                raise Crash

        with TS.HostTileStore(n, np.float64, path=str(tmp_path / "mat.bin")) as st:
            st.fill_plgsy(seed=51)
            with pytest.raises(Crash):
                T.potrf_outofcore(st, panel=panel, nb=nb, progress_path=prog, mesh=mesh,
                                  on_panel=crash_after_two)
        with TS.HostTileStore(n, np.float64, path=str(tmp_path / "mat.bin")) as st:
            stats = T.potrf_outofcore(st, panel=panel, nb=nb, progress_path=prog, mesh=mesh)
            got = _lower(st)
        assert stats["panels"] == n // panel - 2
        np.testing.assert_array_equal(got, _uninterrupted("flat", tmp_path, n, panel, nb,
                                                          mesh=mesh))

    def test_refusals(self, tmp_path):
        mesh = make_mesh(2, 2, device="cpu")
        with TS.HostTileStore(96, np.float64) as st:
            with pytest.raises(ValueError, match="multiple of mesh.size"):
                T.potrf_outofcore(st, panel=48, nb=16, mesh=make_mesh(1, 5, device="cpu"))
        with TS.DirectPanelStore(128, np.float64, path=str(tmp_path / "p.bin"), panel=32,
                                 direct=False) as st:
            with pytest.raises(ValueError, match="single-device"):
                T.potrf_outofcore(st, panel=32, nb=16, mesh=mesh, height_bucket=64)
            with pytest.raises(ValueError, match="members lie on"):
                T.potrf_outofcore(st, panel=32, nb=16, mesh=mesh, device="meta")


def _steps(a, panel, nb, devices):
    """The device loop's panel steps (``_update`` against every earlier panel,
    then ``_factor_panel``) on the dense matrix ``a``, each panel split by rows
    over the members on ``devices``; tril(L)."""
    n, members = a.shape[0], len(devices)
    l = a.clone()
    for j0 in range(0, n, panel):
        h = (n - j0) // members
        slabs = list(l[j0:, j0 : j0 + panel].clone().split(h))
        for k0 in range(0, j0, panel):
            slabs = T._update(slabs, list(l[j0:, k0 : k0 + panel].clone().split(h)), panel,
                              devices)
        T._factor_panel(slabs, nb, devices)
        l[j0:, j0 : j0 + panel] = torch.cat(slabs)
    return torch.tril(l)


def _seeded(n, dtype):
    with TS.HostTileStore(n, dtype) as st:
        st.fill_plgsy(seed=51)
        return torch.from_numpy(st.array.copy())


def _origin(block, base):
    """(row, column) of ``block`` within ``base`` where it is a view of it, else None."""
    if block.untyped_storage().data_ptr() != base.untyped_storage().data_ptr():
        return None
    return divmod(block.storage_offset() - base.storage_offset(), base.stride(0))


class TestAcrossCards:
    """Members on several cards (ROADMAP A9d), on pretended cards: mesh
    (p, q) over p·q/per_card cards, member m on card m // per_card."""

    BITS = [(2, 2, 1, 32), (2, 2, 2, 32), (2, 4, 1, 48), (2, 4, 2, 48), (4, 2, 1, 32),
            (4, 2, 2, 48)]  # (p, q, members per card, nb); nb=48: diagonal blocks span members

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("p,q,per_card,nb", BITS)
    def test_factor_same_bits_as_one_card(self, monkeypatch, dtype, p, q, per_card, nb):
        """The whole factorization's panel steps on the spread mesh give the
        bits of the same mesh on one card, which are the bits of
        ``potrf_outofcore`` on that mesh (the stager stays out: it needs
        cards)."""
        n, panel = 256, 64
        a = _seeded(n, dtype)
        one = make_mesh(p, q, device="cpu")
        want = _steps(a, panel, nb, one.devices)
        with TS.HostTileStore(n, dtype) as st:
            st.array[:] = a.numpy()
            T.potrf_outofcore(st, panel=panel, nb=nb, mesh=one)
            np.testing.assert_array_equal(np.tril(st.array), want.numpy())
        mesh, log = _spread(monkeypatch, p, q, per_card)
        assert len(mesh.cards) == p * q // per_card
        assert torch.equal(_steps(a, panel, nb, mesh.devices), want)
        assert log  # blocks did cross between the cards

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_spread_factor_within_the_tolerance_of_jax(self, monkeypatch, dtype):
        """The 2×4 mesh with two members a card and diagonal blocks spanning
        members, against JAX's mesh path on the 8 CPU devices."""
        n, panel, nb = 256, 64, 48
        a, b = _stores("flat", n, dtype, None, panel)
        with a, b:
            J.potrf_outofcore(a, panel=panel, nb=nb, mesh=JPAR.make_mesh(2, 4))
            ref = _lower(a).astype(np.float64)
            mesh, _ = _spread(monkeypatch, 2, 4, 2)
            got = _steps(torch.from_numpy(b.array.copy()), panel, nb, mesh.devices).numpy()
        assert got.dtype == dtype and _rel(got, ref) <= TOL[dtype]

    @pytest.mark.parametrize("p,q,per_card,height", [(2, 2, 1, 256), (2, 4, 2, 64),
                                                     (4, 2, 1, 64)])
    def test_update_sends_the_top_rows_once_to_each_other_card(self, monkeypatch, p, q,
                                                               per_card, height):
        """One update: Lk[:w]'s pieces (each member's rows of it) reach each
        card but their holder's, once; every member's product runs."""
        w = 64
        lk = torch.from_numpy(np.random.default_rng(1).standard_normal((height, w)))
        pj = torch.from_numpy(np.random.default_rng(2).standard_normal((height, w)))
        h = height // (p * q)
        want = torch.cat(T._update(list(pj.split(h)), list(lk.split(h)), w,
                                   make_mesh(p, q, device="cpu").devices))
        mesh, log = _spread(monkeypatch, p, q, per_card)
        got = torch.cat(T._update(list(pj.split(h)), list(lk.split(h)), w, mesh.devices))
        assert torch.equal(got, want)
        card = mesh.device_of
        sent = set()
        for block, dests in _routes(log):
            row, col = _origin(block, lk)
            assert col == 0 and row < w and block.shape == (min(h, w - row), w)
            sent |= {(row // h, d) for d in dests}
        assert sent == {(m, c) for m in range(-(-w // h)) for c in mesh.cards if c != card(m)}
        assert len(log) == len(sent)

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("p,q,per_card,nb,height", [(2, 2, 1, 32, 256), (2, 4, 2, 48, 64),
                                                        (4, 2, 1, 48, 64), (2, 4, 1, 32, 256)])
    def test_factor_sends_each_block_once_to_its_readers(self, monkeypatch, dtype, p, q,
                                                         per_card, nb, height):
        """One panel factor: each diagonal block's rows reach the card that
        factors it (its first row's member's); its factor reaches each other
        card holding its rows, and (fp64) rows below it; its inverse (fp32)
        each other card holding rows below; the solved rows the in-panel
        update reads each card holding rows below but their holder's; each
        once. Who reads what is derived from the rows each member holds."""
        w = 64
        base = _seeded(height, dtype)[:, :w].contiguous()
        h = height // (p * q)
        ref = base.clone()
        T._factor_panel(list(ref.split(h)), nb, make_mesh(p, q, device="cpu").devices)
        mesh, log = _spread(monkeypatch, p, q, per_card)
        panel = base.clone()
        T._factor_panel(list(panel.split(h)), nb, mesh.devices)
        assert torch.equal(panel, ref)
        card, fp64 = mesh.device_of, dtype == np.float64

        def holders(r0, r1):
            return [m for m in range(p * q) if m * h < r1 and (m + 1) * h > r0]

        want = set()
        for off in range(0, w, nb):
            bw, src = min(nb, w - off), card(off // h)
            diag, below = holders(off, off + bw), holders(off + bw, height)
            want |= {(("rows", off, m), src) for m in diag if card(m) != src}
            want |= {(("lkk", off), c) for c in {card(m) for m in diag + below * fp64}} - {
                (("lkk", off), src)}
            if not fp64:
                want |= {(("inv", off), c) for c in {card(m) for m in below}} - {
                    (("inv", off), src)}
            if off + bw < w:
                want |= {(("solved", off, m), c) for m in holders(off + bw, w)
                         for c in {card(x) for x in below} if c != card(m)}
            if not below:
                break
        lkks = {o: torch.tril(ref[o : o + min(nb, w - o), o : o + min(nb, w - o)])
                for o in range(0, w, nb)}

        def named(block):
            where = _origin(block, panel)
            if where is not None:  # a piece of a member's rows
                row, off = where
                return ("rows" if row < off + min(nb, w - off) else "solved", off, row // h)
            for off, lkk in lkks.items():
                if block.shape == lkk.shape:
                    if torch.equal(block, lkk):
                        return ("lkk", off)
                    if torch.allclose(block @ lkk, torch.eye(len(lkk), dtype=lkk.dtype),
                                      atol=1e-4):
                        return ("inv", off)
            raise AssertionError(f"an unknown block of shape {tuple(block.shape)} crossed")

        got = {(named(block), d) for block, dests in _routes(log) for d in dests}
        assert got == want
        assert len(log) == len(want)


class TestHostPath:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("kind,n,panel,nb,prefetch", [
        ("flat", 256, 64, 32, True), ("flat", 256, 64, 32, False),
        ("panel", 384, 128, 48, True),
    ])
    def test_bits_of_jax_host_path(self, tmp_path, dtype, kind, n, panel, nb, prefetch):
        a, b = _stores(kind, n, dtype, tmp_path, panel)
        with a, b:
            J.potrf_outofcore(a, panel=panel, nb=nb, host_blas=True, prefetch=prefetch)
            stats = T.potrf_outofcore(b, panel=panel, nb=nb, host_blas=True,
                                      prefetch=prefetch)
            np.testing.assert_array_equal(_lower(b), _lower(a))
            if kind == "flat":  # the upper triangle too: the same calls, in place
                np.testing.assert_array_equal(b.array, a.array)
        assert stats["panels"] == n // panel


class Crash(Exception):
    pass


def _uninterrupted(kind, tmp_path, n, panel, nb, dtype=np.float64, **kw):
    if kind == "flat":
        st = TS.HostTileStore(n, dtype)
    else:
        st = TS.DirectPanelStore(n, dtype, path=str(tmp_path / "whole.bin"), panel=panel,
                                 direct=False)
    with st:
        st.fill_plgsy(seed=51)
        T.potrf_outofcore(st, panel=panel, nb=nb, **kw)
        return _lower(st)


class TestResume:
    @pytest.mark.parametrize("host_blas", [False, True])
    @pytest.mark.parametrize("kind", ["flat", "panel"])
    def test_kill_and_resume_same_bits(self, tmp_path, kind, host_blas):
        """Factor two panels, crash, resume in a fresh store object (a fresh
        process's view) from the sidecar: the factor's bits are an
        uninterrupted run's."""
        n, panel, nb = 128, 32, 16
        kw = {"host_blas": True} if host_blas else {"device": "cpu"}
        mat, prog = str(tmp_path / "mat.bin"), str(tmp_path / "progress.json")

        def store():
            if kind == "flat":
                return TS.HostTileStore(n, np.float64, path=mat)
            return TS.DirectPanelStore(n, np.float64, path=mat, panel=panel, direct=False)

        def crash_after_two(j, npan):
            if j == 1:
                raise Crash

        with store() as st:
            st.fill_plgsy(seed=51)
            with pytest.raises(Crash):
                T.potrf_outofcore(st, panel=panel, nb=nb, progress_path=prog,
                                  on_panel=crash_after_two, **kw)
        with store() as st2:
            stats = T.potrf_outofcore(st2, panel=panel, nb=nb, progress_path=prog, **kw)
            got = _lower(st2)
        assert stats["panels"] == n // panel - 2
        np.testing.assert_array_equal(got, _uninterrupted(kind, tmp_path, n, panel, nb, **kw))

    @pytest.mark.parametrize("kind", ["flat", "panel"])
    def test_torn_writeback_recovers_same_bits(self, tmp_path, kind):
        """Crash DURING the store writeback of a factored panel (after the
        scratch stage, mid-unpack): the store holds a torn panel; resume
        replays the commit from the durable scratch copy."""
        n, panel, nb = 128, 32, 16
        mat, prog = str(tmp_path / "mat.bin"), str(tmp_path / "progress.json")

        def store():
            if kind == "flat":
                return TS.HostTileStore(n, np.float64, path=mat)
            return TS.DirectPanelStore(n, np.float64, path=mat, panel=panel, direct=False)

        with store() as st:
            st.fill_plgsy(seed=51)
            real_unpack, calls = st.unpack, []

            def torn_unpack(i0, j0, src):
                calls.append(i0)
                if len(calls) == 2:  # panel j=1: tear the write, then die
                    real_unpack(i0, j0, np.full_like(src, np.nan))
                    raise Crash
                return real_unpack(i0, j0, src)

            st.unpack = torn_unpack
            with pytest.raises(Crash):
                T.potrf_outofcore(st, panel=panel, nb=nb, progress_path=prog, device="cpu")
        with store() as st2:
            assert np.isnan(_lower(st2)[panel:, panel : 2 * panel]).any()  # the tear is there
            T.potrf_outofcore(st2, panel=panel, nb=nb, progress_path=prog, device="cpu")
            got = _lower(st2)
        np.testing.assert_array_equal(
            got, _uninterrupted(kind, tmp_path, n, panel, nb, device="cpu"))

    def test_sidecar_of_another_problem_is_ignored(self, tmp_path):
        n, panel = 128, 32
        prog = tmp_path / "progress.json"
        prog.write_text('{"n": 64, "panel": 32, "done": [0, 1]}')
        with TS.HostTileStore(n, np.float64) as st:
            st.fill_plgsy(seed=51)
            stats = T.potrf_outofcore(st, panel=panel, nb=16, progress_path=str(prog),
                                      device="cpu")
        assert stats["panels"] == n // panel


class TestRejections:
    def test_host_blas_rejects_mesh_and_bucket(self):
        with TS.HostTileStore(64, np.float64) as st:
            with pytest.raises(ValueError, match="host_blas"):
                T.potrf_outofcore(st, panel=32, nb=16, host_blas=True, height_bucket=64)
            with pytest.raises(ValueError, match="host_blas"):
                T.potrf_outofcore(st, panel=32, nb=16, host_blas=True, mesh=object())

    def test_mesh_names_a9(self, monkeypatch):
        """A mesh whose members span several cards (constructed here without
        allocating on them) gets past the refusal it met until ROADMAP A9d:
        without a card it stops at the missing card, and with ``device=`` it
        raises instead of quietly putting the panel on one card. A mesh
        across processes still raises, citing the JAX package's own limit."""
        from dla_tpu_torch.parallel import MemberMesh, member_comm

        monkeypatch.setattr(member_comm, "_peer_access", lambda a, b: True)
        spread = MemberMesh((torch.device("cuda", 0), torch.device("cuda", 1)), (1, 2))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with TS.HostTileStore(64, np.float64) as st:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                T.potrf_outofcore(st, panel=32, nb=16, mesh=spread)
            with pytest.raises(ValueError, match="several cards"):
                T.potrf_outofcore(st, panel=32, nb=16, mesh=spread, device="cuda:0")
        across = MemberMesh((torch.device("cpu"),) * 4, (2, 2), processes=2, process=0)
        with TS.HostTileStore(64, np.float64) as st:
            with pytest.raises(NotImplementedError,
                               match=r"JAX package cannot run it either .*"
                                     r"dla_tpu/algos/oocore\.py:499-508"):
                T.potrf_outofcore(st, panel=32, nb=16, mesh=across)

    def test_bucket_needs_a_panel_store(self):
        with TS.HostTileStore(64, np.float64) as st:
            with pytest.raises(ValueError, match="DirectPanelStore"):
                T.potrf_outofcore(st, panel=32, nb=16, height_bucket=64, device="cpu")

    def test_panel_must_divide_n(self):
        with TS.HostTileStore(96, np.float64) as st:
            with pytest.raises(ValueError, match="multiple of panel"):
                T.potrf_outofcore(st, panel=64, nb=16, device="cpu")

    def test_the_card_by_default_and_no_fallback(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with TS.HostTileStore(64, np.float64) as st:
            st.fill_plgsy(seed=51)
            before = st.array.copy()
            with pytest.raises(RuntimeError, match="no CUDA device"):
                T.potrf_outofcore(st, panel=32, nb=16)
            np.testing.assert_array_equal(st.array, before)  # nothing ran elsewhere


def _perturbed(l, delta, seed=0):
    r = np.random.default_rng(seed).uniform(-1.0, 1.0, l.shape)
    return np.tril(l * (1.0 + delta * r)).astype(l.dtype)


class TestFreivaldsSeesTheFactor:
    DELTAS = [1e-7, 1e-6, 1e-5, 1e-4, 1e-3]

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_gates_rise_with_the_perturbation(self, tmp_path, dtype):
        """A factor perturbed by a relative δ has residual ≈ 1.5·δ: each gate
        must grow with δ and read within [δ/2, 5δ] once δ is above its own
        floor (the unperturbed factor's residual), in the port and in JAX."""
        n, w = 512, 128
        with TS.DirectPanelStore(n, dtype, path=str(tmp_path / "p.bin"), panel=w,
                                 direct=False) as st:
            st.fill_plgsy(seed=51)
            T.potrf_outofcore(st, panel=w, nb=64, device="cpu")
            l = _lower(st)
        with TS.HostTileStore(n, dtype) as a:
            a.fill_plgsy(seed=51)
            orig = a.array.copy()
        gates = {
            "port streaming": (TS.DirectPanelStore, TS.freivalds_streaming, "port.bin"),
            "jax streaming": (JS.DirectPanelStore, JS.freivalds_streaming, "jax.bin"),
        }
        for name, (store_cls, gate, fname) in gates.items():
            with store_cls(n, dtype, path=str(tmp_path / fname), panel=w, direct=False) as ps:
                got = []
                for delta in [0.0] + self.DELTAS:
                    lp = _perturbed(l, delta)
                    for j in range(n // w):
                        ps.unpack(j * w, j * w, np.ascontiguousarray(lp[j * w :, j * w : (j + 1) * w]))
                    got.append(gate(ps, seed=51, probes=2))
            self._check(name, got)
        for name, cls in (("port dense", TS.HostTileStore), ("jax dense", JS.HostTileStore)):
            with cls(n, dtype) as sa, cls(n, dtype) as sl:
                sa.array[:] = orig
                got = []
                for delta in [0.0] + self.DELTAS:
                    sl.array[:] = _perturbed(l, delta)
                    got.append(sa.freivalds_residual(sl, probes=2))
            self._check(name, got)

    def _check(self, name, got):
        floor, rest = got[0], got[1:]
        assert all(b > a for a, b in zip(got, got[1:])), (name, got)
        for delta, r in zip(self.DELTAS, rest):
            if delta >= 10 * floor:
                assert delta / 2 <= r <= 5 * delta, (name, delta, r)


class TestNanFactorFails:
    def test_native_gate_fails_a_nan_factor(self):
        """The port's native Freivalds probe returns NaN for a NaN factor, so
        the driver prints FAIL. The JAX package's copy skips NaN rows in its
        max and reads 0 for an all-NaN factor: a defect of the reference,
        not ported."""
        n = 64
        vals = {}
        for name, cls in (("port", TS.HostTileStore), ("jax", JS.HostTileStore)):
            with cls(n, np.float64) as a, cls(n, np.float64) as l:
                a.fill_plgsy(seed=1)
                l.array[:] = np.linalg.cholesky(np.tril(a.array) + np.tril(a.array, -1).T)
                good = a.freivalds_residual(l)
                l.array[5:, :] = np.nan
                vals[name] = (good, a.freivalds_residual(l))
        assert vals["port"][0] < 1e-14 and np.isnan(vals["port"][1])
        assert vals["jax"][0] < 1e-14 and vals["jax"][1] < 1e-14

    def test_streaming_gate_fails_a_nan_factor(self, tmp_path):
        n, w = 128, 32
        with TS.DirectPanelStore(n, np.float64, path=str(tmp_path / "p.bin"), panel=w,
                                 direct=False) as st:
            st.fill_plgsy(seed=51)
            st.unpack(w, w, np.full((n - w, w), np.nan))
            assert np.isnan(TS.freivalds_streaming(st, seed=51, probes=2))


class TestPosvRefinedStreamed:
    @pytest.mark.parametrize("nrhs", [1, 3])
    def test_dense_factor_matches_jax(self, nrhs):
        n, panel = 512, 128
        b = np.random.default_rng(nrhs).standard_normal((n, nrhs) if nrhs > 1 else n)
        l = potrf_blocked(plgsy(n, seed=51, device="cpu"), nb=128)
        x, err, used = posv_refined_streamed(l, b, seed=51, panel=panel)
        lj = JA.potrf_blocked(jnp.asarray(np.asarray(_jax_native_plgsy(n))), nb=128)
        xj, errj, usedj = JA.posv_refined_streamed(lj, b, seed=51, panel=panel)
        assert err < 1e-10 and errj < 1e-10
        assert x.shape == b.shape and x.dtype == np.float64
        assert np.abs(x - xj).max() <= 1e-9 * np.abs(xj).max()
        assert abs(used - usedj) <= 1

    def test_packed_factor_matches_jax(self):
        n, nb = 512, 128
        lp = TP.potrf_packed(TP.plgsy_packed(n, nb, seed=51, device="cpu"), n, nb)
        b = np.ones((n, 2))
        its = []
        x, err, used = posv_refined_streamed(lp, b, seed=51, n=n, panel=nb, on_iter=lambda i, e:
                                             its.append(e),
                                             solver=lambda r: TP.potrs_packed(lp, r, n, nb))
        lpj = JP.potrf_packed(JP.plgsy_packed(n, nb, seed=51), n, nb)
        xj, errj, _ = JA.posv_refined_streamed(
            lpj, b, seed=51, n=n, panel=nb, solver=lambda r: JP.potrs_packed(lpj, r, n, nb))
        assert err < 1e-10 and errj < 1e-10
        assert len(its) == used and its[-1] == err
        assert np.abs(x - xj).max() <= 1e-9 * np.abs(xj).max()

    def test_rejects_panel_not_dividing_n(self):
        with pytest.raises(ValueError, match="multiple of panel"):
            posv_refined_streamed(torch.eye(96), np.ones(96), panel=64)


def _jax_native_plgsy(n):
    """plgsy(n, seed=51) in fp32 from the JAX package's native generator."""
    with JS.HostTileStore(n, np.float32) as st:
        st.fill_plgsy(seed=51)
        return st.array.copy()


FREIVALDS_LINE = r"^freivalds \|\|\(A - LL\^T\)x\|\| / \(\|\|A\|\| \|\|x\|\|\) = (\S+) "


def _drive(capsys, *argv):
    rc = oocore_driver.main([str(a) for a in argv])
    return rc, capsys.readouterr()


class TestDriver:
    # the panel store's O_DIRECT file needs rows of a multiple of 4096 bytes: 512 fp64
    @pytest.mark.parametrize("extra,n,panel,dtype,gate", [
        ([], 512, 128, "float32", "0.0001024"),
        (["--no-prefetch"], 512, 128, "float64", "1e-10"),
        (["--host-blas"], 512, 128, "float32", "0.0001024"),
        (["--store", "panel", "--ram-cache", "--bucket", "1536"], 2048, 512, "float64", "1e-10"),
        (["--store", "panel", "--probes", "0"], 2048, 512, "float64", None),
    ])
    def test_lines_and_exit_code(self, tmp_path, capsys, extra, n, panel, dtype, gate):
        if "panel" in extra:
            extra = extra + ["--matrix", tmp_path / "m.bin"]
        rc, cap = _drive(capsys, "--n", n, "--panel", panel, "--nb", 128, "--dtype", dtype,
                         "--device", "cpu", *extra)
        out = cap.out
        assert rc == 0, out + cap.err
        assert re.search(rf"^\[oocore\] N={n} panel={panel} NB=128 dtype={dtype}", out, re.M)
        assert re.search(r"^Elapsed: \S+ ms$", out, re.M)
        assert re.search(r"^Performance: \S+ Gflop/s$", out, re.M)
        assert "[oocore] staging: in " in out and "[oocore] panel 4/4 done" in out
        stats = json.loads(re.search(r"^\[oocore\] stats: (.*)$", out, re.M).group(1))
        assert stats["panels"] == 4 and stats["bytes_out"] > 0
        if gate is None:
            assert "freivalds" not in out and "PASS" not in out
        else:
            res = re.search(FREIVALDS_LINE, out, re.M)
            assert res and float(res.group(1)) < float(gate)
            assert f"PASS (gate {gate})" in out

    def test_resume_quotes_this_process_flops(self, tmp_path, capsys):
        n, panel = 2048, 512
        mat, prog = tmp_path / "m.bin", tmp_path / "p.json"

        def crash_after_two(j, npan):
            if j == 1:
                raise Crash

        with TS.DirectPanelStore(n, np.float64, path=str(mat), panel=panel) as st:
            st.fill_plgsy(seed=51)
            with pytest.raises(Crash):
                T.potrf_outofcore(st, panel=panel, nb=128, progress_path=str(prog),
                                  on_panel=crash_after_two, device="cpu")
        rc, cap = _drive(capsys, "--n", n, "--panel", panel, "--nb", 128, "--dtype", "float64",
                         "--device", "cpu", "--store", "panel", "--matrix", mat,
                         "--progress", prog)
        assert rc == 0, cap.out + cap.err
        assert "generating" not in cap.out  # a resume regenerates nothing
        assert "(resumed: 2/4 panels" in cap.out and "PASS (gate 1e-10)" in cap.out

    def test_mesh_exits_2_naming_a9(self, capsys):
        """``--p 2 --q 2``, once refused naming ROADMAP A9, runs the
        distributed path and passes its gate."""
        rc, cap = _drive(capsys, "--n", 256, "--panel", 64, "--nb", 32, "--p", 2, "--q", 2,
                         "--dtype", "float64", "--device", "cpu")
        assert rc == 0, cap.out + cap.err
        assert "[oocore] distributed: panels sharded over a 2x2 mesh" in cap.out
        assert "PASS (gate 1e-10)" in cap.out and "A9" not in cap.out + cap.err

    @pytest.mark.parametrize("device", ["cuda", "cuda:0"])
    def test_mesh_over_the_cards_or_on_one(self, capsys, monkeypatch, device):
        """With 4 cards, ``--p 2 --q 2 --device cuda`` builds the mesh over
        them, one member a card, as the JAX driver's mesh spans
        ``jax.devices()``; ``--device cuda:0`` keeps every member on card 0.
        The factorization is patched to record the mesh it is given (nothing
        lies on a card here)."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "card")
        monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
        _pretend_cards(monkeypatch, 4)
        seen = []

        class Reached(Exception):
            pass

        def factor(store, **kw):
            seen.append(kw)
            raise Reached

        monkeypatch.setattr(T, "potrf_outofcore", factor)
        with pytest.raises(Reached):
            oocore_driver.main(["--n", "256", "--panel", "64", "--nb", "32", "--p", "2", "--q",
                                "2", "--device", device])
        (kw,) = seen
        cards = [torch.device("cuda", i) for i in range(4)] if device == "cuda" else [
            torch.device("cuda", 0)]
        assert kw["device"] is None and kw["mesh"].shape == (2, 2)
        assert list(kw["mesh"].devices) == (cards if device == "cuda" else cards * 4)
        assert (f"[oocore] distributed: panels sharded over a 2x2 mesh on "
                f"{','.join(map(str, cards))}") in capsys.readouterr().out

    def test_host_blas_excludes_a_mesh(self, capsys):
        with pytest.raises(SystemExit) as e:
            oocore_driver.main(["--n", "256", "--panel", "64", "--host-blas", "--p", "2"])
        assert e.value.code == 2

    def test_no_card_exits_2(self, capsys, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        rc, cap = _drive(capsys, "--n", 256, "--panel", 64)
        assert rc == 2 and "no CUDA device" in cap.err

    @pytest.mark.parametrize("argv", [["--host-blas", "--bucket", "64"], ["--store", "panel"],
                                      ["--device", "cuda:x"], ["--device", "cpu:0"]])
    def test_usage_errors_exit_2(self, capsys, argv):
        with pytest.raises(SystemExit) as e:
            oocore_driver.main(["--n", "256", "--panel", "64", "--device", "cpu", *argv])
        assert e.value.code == 2

    def test_failed_gate_exits_1(self, capsys, monkeypatch):
        """A non-SPD input (negative diagonal bump): NaN factor, FAIL, exit 1."""
        real = TS.HostTileStore.fill_plgsy
        monkeypatch.setattr(TS.HostTileStore, "fill_plgsy",
                            lambda self, seed=51, bump=None: real(self, seed=seed, bump=-1.0))
        rc, cap = _drive(capsys, "--n", 256, "--panel", 64, "--nb", 32, "--dtype", "float64",
                         "--device", "cpu")
        assert rc == 1 and "FAIL (gate 1e-10)" in cap.out


SOLVE_LINE = r"^\|\|B - A X\|\|_inf / \(\|\|A\|\|_inf \|\|X\|\|_inf\) = (\S+)$"


class TestPotrfDriverRefined:
    @pytest.mark.parametrize("mode,dtype", [("packed", "s"), ("packed", "h"),
                                            ("inplace", "s")])
    def test_refined_solve_passes(self, capsys, mode, dtype):
        rc = potrf_driver.main(["--n", "256", "--nb", "64", "--dtype", dtype, "--device", "cpu",
                                "--mode", mode, "--solve", "refined", "--nrhs", "2"])
        out = capsys.readouterr().out
        assert rc == 0, out
        res = re.search(SOLVE_LINE, out, re.M)
        assert res and float(res.group(1)) < 1e-10
        assert "SOLVE PASS (residual < 1e-10)" in out
        assert re.search(r"refined solve: \d+ iterations", out)
        assert ("streamed on the host" in out) == (mode == "packed")

    def test_dense_refined_reads_the_host_generator(self, capsys, monkeypatch):
        """The dense refined solve takes A from the native host generator, not
        from the card's copy of A."""
        seen = []
        real = TS.HostTileStore.fill_plgsy

        def spy(self, **kw):
            seen.append((self.n, self.dtype, kw))
            return real(self, **kw)

        monkeypatch.setattr(TS.HostTileStore, "fill_plgsy", spy)
        rc = potrf_driver.main(["--n", "256", "--nb", "64", "--dtype", "s", "--device", "cpu",
                                "--solve", "refined", "--seed", "9"])
        out = capsys.readouterr().out
        assert rc == 0 and "SOLVE PASS" in out
        assert "A regenerated in fp64 by the native host generator" in out
        assert seen == [(256, np.float64, {"seed": 9, "bump": 256.0})]
