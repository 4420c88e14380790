"""dla_tpu_torch's block-cyclic plane — the layout and generation
(``parallel/block_cyclic.py``), ``potrf_block_cyclic``
(``parallel/potrf_dist.py``), ``potrs_block_cyclic``
(``parallel/solve_dist.py``), the serving apply (``parallel/serving.py``),
their accounting, the dry run's planes 1, 4 and 5, the ``session`` CLI and the
driver's ``--mode distributed`` — held against dla_tpu's on the same numpy
inputs.

The JAX side runs as tests/test_parallel.py runs it: ``shard_map`` on the 8
virtual CPU devices of tests/conftest.py. The port's p·q members all lie on
the CPU.

What is compared how:
- layouts and generation move or make elements: the same bits, shard by
  shard (generation also against ``plgsy``);
- the fp64 factors: within rtol = atol = 1e-11 of JAX's (JAX's own tolerance
  between its distributed and single-chip factors), lower triangle; fp32
  within 1e-5·max|L|; the super-stepped program within 1e-11 of the unrolled
  one, in both packages;
- the solves: within 1e-10 of JAX's (the backward psum adds several members'
  parts, perhaps in another order than XLA's), ``residual_posv`` under 1e-10;
- the accounting is a copy: equal values; the stacked panels the program
  gathers have the sizes ``step_comm_elems`` counts, the serving all-gather
  the size ``serving_comm_elems`` counts;
- the residual and Freivalds gates these entry points use rise with a
  known relative perturbation of tril(L), in both packages.
"""

import contextlib
import json
from collections import Counter
import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import dla_tpu.parallel as JP
import dla_tpu.validate as JV
from dla_tpu.ops import plgsy as jax_plgsy
from dla_tpu.parallel import model as JM
from dla_tpu_torch import parallel as TP
from dla_tpu_torch.cli import potrf_driver, session
from dla_tpu_torch.ops import plgsy
from dla_tpu_torch.parallel import dryrun, member_comm, potrf_dist
from dla_tpu_torch.parallel import model as TM
from dla_tpu_torch.validate import freivalds_device, residual_posv, residual_potrf
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MESHES = [(1, 1), (2, 2), (2, 4), (1, 8), (4, 2)]


def _pretend_cards(monkeypatch, count, peer=lambda a, b: True):
    """``count`` visible cards, pairs reaching each other as ``peer`` says;
    nothing is allocated on them."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(member_comm, "_peer_access", peer)


def _spd(n, seed):
    g = np.random.default_rng(seed).standard_normal((n, n))
    return (g + g.T) / 2 + n * np.eye(n)


def _pair(n, nb, p, q):
    return (JP.BlockCyclicLayout(n=n, nb=nb, p=p, q=q), JP.make_mesh(p, q),
            TP.BlockCyclicLayout(n=n, nb=nb, p=p, q=q), TP.make_mesh(p, q, device="cpu"))


def _stored(shards, lay):
    """The port's shards assembled in mesh order: JAX's stored array."""
    q = lay.q
    return np.concatenate([np.concatenate([shards[r * q + c].numpy() for c in range(q)], 1)
                           for r in range(lay.p)], 0)


def _jax_factor(a, jl, jm, **kw):
    return np.tril(JP.to_dense(JP.potrf_block_cyclic(JP.from_dense(a, jl, jm), jl, jm, **kw), jl))


def _port_factor(a, tl, tm, **kw):
    return np.tril(TP.to_dense(TP.potrf_block_cyclic(TP.from_dense(a, tl, tm), tl, tm, **kw),
                               tl).numpy())


# ---- the mesh ----------------------------------------------------------------------------

class TestMesh:
    def test_members_on_the_cpu_when_asked(self):
        mesh = TP.make_mesh(2, 4, device="cpu")
        assert mesh.size == 8 and mesh.shape == (2, 4) and mesh.axis_names == ("r", "c")
        assert mesh.devices == (torch.device("cpu"),) * 8 and mesh.device == torch.device("cpu")

    def test_defaults_to_the_card(self):
        if torch.cuda.is_available():
            assert TP.make_mesh(2, 2).device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                TP.make_mesh(2, 2)

    def test_members_across_devices_raise_naming_a9(self):
        """A CPU + meta mesh raises ``ValueError`` (members lie all on the CPU
        or all on CUDA cards); members on several cards are ROADMAP A9c's
        mesh, which constructs (``test_spread_over_the_cards``)."""
        with pytest.raises(ValueError, match="all on the CPU or all on CUDA cards"):
            TP.MemberMesh((torch.device("cpu"), torch.device("meta")), (1, 2))

    @pytest.mark.parametrize("count", [1, 2, 3, 4])
    @pytest.mark.parametrize("p,q", [(1, 4), (2, 2), (2, 4)])
    def test_spread_over_the_cards(self, monkeypatch, p, q, count):
        """make_mesh over cuda:0..3, constructed on the CPU (nothing
        allocated): k cards, k the largest divisor of p·q at most the card
        count, member m = r·q + c on card m // (p·q/k)."""
        _pretend_cards(monkeypatch, count)
        mesh = TP.make_mesh(p, q)
        k = max(d for d in range(1, count + 1) if (p * q) % d == 0)
        assert mesh.shape == (p, q) and mesh.device == torch.device("cuda", 0)
        assert [mesh.device_of(m) for m in range(p * q)] == [
            torch.device("cuda", m // (p * q // k)) for m in range(p * q)]
        assert mesh.cards == [torch.device("cuda", i) for i in range(k)]
        one = TP.make_mesh(p, q, device="cuda:1")  # an explicit device keeps them together
        assert one.devices == (torch.device("cuda", 1),) * (p * q) and one.cards == [one.device]

    @pytest.mark.parametrize("devices,shape", [((torch.device("cpu"),) * 3, (2, 2)),
                                               ((), (0, 1))])
    def test_member_count_must_match(self, devices, shape):
        with pytest.raises(ValueError):
            TP.MemberMesh(devices, shape)


# ---- the layout --------------------------------------------------------------------------

class TestLayout:
    def test_geometry(self):
        lay = TP.BlockCyclicLayout(n=256, nb=32, p=2, q=4)
        assert lay.ntiles == 8 and lay.ltr == 4 and lay.ltc == 2
        assert lay.local_shape == (128, 64)

    @pytest.mark.parametrize("n,nb,p,q", [(128, 16, 2, 2), (256, 32, 2, 4), (96, 8, 4, 3)])
    def test_perms_equal_jax(self, n, nb, p, q):
        jl, tl = JP.BlockCyclicLayout(n, nb, p, q), TP.BlockCyclicLayout(n, nb, p, q)
        np.testing.assert_array_equal(tl.row_perm, jl.row_perm)
        np.testing.assert_array_equal(tl.col_perm, jl.col_perm)
        assert sorted(tl.row_perm.tolist()) == list(range(n))

    @pytest.mark.parametrize("n,nb,p,q", [(100, 32, 2, 2), (96, 32, 2, 2), (128, 16, 3, 1)])
    def test_divisibility_checks(self, n, nb, p, q):
        with pytest.raises(ValueError):
            JP.BlockCyclicLayout(n=n, nb=nb, p=p, q=q)
        with pytest.raises(ValueError):
            TP.BlockCyclicLayout(n=n, nb=nb, p=p, q=q)

    @pytest.mark.parametrize("p,q", MESHES)
    def test_from_dense_same_bits_as_jax(self, p, q):
        n, nb = 128, 16
        jl, jm, tl, tm = _pair(n, nb, p, q)
        a = np.random.default_rng(p * 10 + q).standard_normal((n, n))
        shards = TP.from_dense(a, tl, tm)
        assert len(shards) == p * q and all(s.shape == tl.local_shape for s in shards)
        np.testing.assert_array_equal(_stored(shards, tl), np.asarray(JP.from_dense(a, jl, jm)))
        np.testing.assert_array_equal(TP.to_dense(shards, tl).numpy(), a)
        np.testing.assert_array_equal(TP.to_dense(TP.from_dense(torch.tensor(a), tl, tm), tl),
                                      JP.to_dense(JP.from_dense(a, jl, jm), jl))

    def test_from_dense_copies(self):
        lay, mesh = TP.BlockCyclicLayout(64, 16, 1, 1), TP.make_mesh(1, 1, device="cpu")
        a = torch.ones(64, 64)
        TP.from_dense(a, lay, mesh)[0].zero_()
        assert bool((a == 1).all())

    def test_shapes_are_checked(self):
        lay, mesh = TP.BlockCyclicLayout(64, 16, 2, 2), TP.make_mesh(2, 2, device="cpu")
        with pytest.raises(ValueError, match="matrix"):
            TP.from_dense(np.zeros((64, 32)), lay, mesh)
        with pytest.raises(ValueError, match="shards"):
            TP.to_dense([torch.zeros(32, 32)] * 3, lay)
        with pytest.raises(ValueError, match="mesh"):
            TP.potrf_block_cyclic([torch.zeros(32, 32)] * 4, lay, TP.make_mesh(1, 4, device="cpu"))


# ---- generation ---------------------------------------------------------------------------

class TestGeneration:
    @pytest.mark.parametrize("dtype", ["float64", "float32"])
    @pytest.mark.parametrize("p,q", [(2, 4), (4, 2), (1, 1)])
    def test_same_bits_as_jax_and_plgsy(self, p, q, dtype):
        n, nb = 128, 16
        jl, jm, tl, tm = _pair(n, nb, p, q)
        jx = JP.generate_spd_block_cyclic(jl, jm, seed=51, dtype=getattr(jnp, dtype))
        tx = TP.generate_spd_block_cyclic(tl, tm, seed=51, dtype=getattr(torch, dtype))
        np.testing.assert_array_equal(_stored(tx, tl), np.asarray(jx))
        dense = TP.to_dense(tx, tl).numpy()
        np.testing.assert_array_equal(dense, plgsy(n, seed=51, dtype=getattr(torch, dtype),
                                                   device="cpu").numpy())
        np.testing.assert_array_equal(dense, np.asarray(jax_plgsy(n, seed=51,
                                                                  dtype=getattr(jnp, dtype))))

    def test_seed_and_bump(self):
        lay, mesh = TP.BlockCyclicLayout(64, 8, 2, 2), TP.make_mesh(2, 2, device="cpu")
        got = TP.to_dense(TP.generate_spd_block_cyclic(lay, mesh, seed=7, bump=3.0,
                                                       dtype=torch.float64), lay)
        assert torch.equal(got, plgsy(64, seed=7, bump=3.0, dtype=torch.float64, device="cpu"))


# ---- the factorization ---------------------------------------------------------------------

class TestPotrfBlockCyclic:
    @pytest.mark.parametrize("p,q", MESHES)
    def test_fp64_against_jax(self, p, q):
        n, nb = 128, 16
        jl, jm, tl, tm = _pair(n, nb, p, q)
        a = np.tril(_spd(n, p * 10 + q))
        got = _port_factor(a, tl, tm)
        np.testing.assert_allclose(got, _jax_factor(a, jl, jm), rtol=1e-11, atol=1e-11)
        np.testing.assert_allclose(got, scipy.linalg.cholesky(_spd(n, p * 10 + q), lower=True),
                                   rtol=1e-9, atol=1e-9)

    def test_fp32_against_jax(self):
        n, nb = 256, 32
        jl, jm, tl, tm = _pair(n, nb, 2, 4)
        a = np.tril(_spd(n, 3)).astype(np.float32)
        got, want = _port_factor(a, tl, tm), _jax_factor(a, jl, jm)
        assert got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    def test_factors_in_place(self):
        lay, mesh = TP.BlockCyclicLayout(64, 16, 2, 2), TP.make_mesh(2, 2, device="cpu")
        x = TP.generate_spd_block_cyclic(lay, mesh, dtype=torch.float64)
        out = TP.potrf_block_cyclic(x, lay, mesh)
        assert all(o is s for o, s in zip(out, x))

    def test_residual_gate_end_to_end(self):
        lay, mesh = TP.BlockCyclicLayout(256, 32, 2, 4), TP.make_mesh(2, 4, device="cpu")
        x = TP.generate_spd_block_cyclic(lay, mesh, seed=51, dtype=torch.float64)
        a = TP.to_dense(x, lay)
        l = torch.tril(TP.to_dense(TP.potrf_block_cyclic(x, lay, mesh), lay))
        assert float(residual_potrf(a, l, assume_symmetric=True)) < 1e-10

    @pytest.mark.parametrize("p,q", [(2, 2), (2, 4), (1, 8)])
    def test_super_steps_match_unrolled(self, p, q):
        n, nb = 128, 16
        jl, jm, tl, tm = _pair(n, nb, p, q)
        a = np.tril(_spd(n, p + 5 * q))
        unrolled = _port_factor(a, tl, tm, unroll=True)
        ref = scipy.linalg.cholesky(_spd(n, p + 5 * q), lower=True)
        for ss in (tl.ntiles, 3, 1):  # one segment, ragged segments, per step
            got = _port_factor(a, tl, tm, unroll=False, super_steps=ss)
            np.testing.assert_allclose(got, unrolled, rtol=1e-11, atol=1e-11)
            np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)

    @pytest.mark.parametrize("ss", [8, 3, 1])
    def test_super_steps_against_jax(self, ss):
        n, nb = 128, 16
        jl, jm, tl, tm = _pair(n, nb, 2, 4)
        a = np.tril(_spd(n, 13))
        np.testing.assert_allclose(_port_factor(a, tl, tm, unroll=False, super_steps=ss),
                                   _jax_factor(a, jl, jm, unroll=False, super_steps=ss),
                                   rtol=1e-11, atol=1e-11)

    def test_auto_switch_past_64_steps(self, monkeypatch):
        n, nb = 160, 2  # 80 tile steps: auto picks the super-stepped program, 3 steps each
        lay, mesh = TP.BlockCyclicLayout(n, nb, 2, 2), TP.make_mesh(2, 2, device="cpu")
        a = _spd(n, 99)
        calls = []
        real = potrf_dist._potrf_super
        monkeypatch.setattr(potrf_dist, "_potrf_super",
                            lambda x, layout, ss: calls.append(ss) or real(x, layout, ss))
        got = _port_factor(np.tril(a), lay, mesh)
        assert calls == [3]
        np.testing.assert_array_equal(got, _port_factor(np.tril(a), lay, mesh, unroll=False,
                                                        super_steps=3))
        np.testing.assert_allclose(got, scipy.linalg.cholesky(a, lower=True), rtol=1e-8, atol=1e-8)
        small = TP.BlockCyclicLayout(128, 2, 2, 2)  # 64 steps: unrolled
        calls.clear()
        _port_factor(np.tril(_spd(128, 1)), small, mesh)
        assert calls == []

    def test_non_spd_input_gives_nan(self):
        lay, mesh = TP.BlockCyclicLayout(128, 16, 2, 2), TP.make_mesh(2, 2, device="cpu")
        a = _spd(128, 4) - 400 * np.eye(128)  # indefinite
        for unroll in (True, False):
            assert np.isnan(_port_factor(np.tril(a), lay, mesh, unroll=unroll)).any()

    @pytest.mark.parametrize("unroll", [True, False])
    def test_nan_above_the_diagonal_changes_no_bit(self, unroll):
        lay, mesh = TP.BlockCyclicLayout(128, 16, 2, 4), TP.make_mesh(2, 4, device="cpu")
        a = np.tril(_spd(128, 8))
        dirty = a + np.triu(np.full_like(a, np.nan), 1)
        np.testing.assert_array_equal(_port_factor(dirty, lay, mesh, unroll=unroll),
                                      _port_factor(a, lay, mesh, unroll=unroll))

    def test_gathered_panels_have_the_accounted_size(self, monkeypatch):
        """Each step's stacked panel is the window ``step_comm_elems`` counts:
        (ltr − w0)·nb² elements per mesh row, gathered over 'r' (p) after the
        psum over 'c' (q)."""
        lay, mesh = TP.BlockCyclicLayout(256, 16, 2, 4), TP.make_mesh(2, 4, device="cpu")
        sizes = []
        real = member_comm.all_gather
        monkeypatch.setattr(member_comm, "all_gather",
                            lambda blocks: sizes.append(blocks[0].numel()) or real(blocks))
        TP.potrf_block_cyclic(TP.generate_spd_block_cyclic(lay, mesh, dtype=torch.float64),
                              lay, mesh, unroll=True)
        assert [s * (lay.p + lay.q) for s in sizes] == [
            TM.step_comm_elems(lay, k) for k in range(lay.ntiles - 1)]


# ---- members on several cards: which blocks cross to which card (ROADMAP A9c) ---------------

ROUTES = [(2, 2, 1), (2, 4, 2), (4, 2, 2), (2, 4, 1)]  # (p, q, members per card)


def _spread(monkeypatch, p, q, per_card):
    """A p×q mesh over p·q/per_card pretended cards, and the copy log: every
    block ``member_comm.copy_to`` is asked to move and where to (the block
    stays on the CPU; nothing is allocated on a card)."""
    _pretend_cards(monkeypatch, p * q // per_card)
    mesh = TP.make_mesh(p, q)
    log = []

    def copy_to(block, device):
        if device is None:  # no move asked for
            return block
        log.append((block, device))
        return block.clone()

    monkeypatch.setattr(member_comm, "copy_to", copy_to)
    monkeypatch.setattr(member_comm, "on", lambda device: contextlib.nullcontext())
    return mesh, log


def _routes(log) -> list:
    """[(block, the cards it was sent to)], one entry per block, in order."""
    dests = {}
    for block, dev in log:
        dests.setdefault(id(block), (block, set()))[1].add(dev)
    return list(dests.values())


class TestCopyRouting:
    """With the members on cuda:i, one step sends each block to exactly the
    cards whose members use it: what a member reads is derived here from the
    tiles it owns, not from the program's staircase arithmetic."""

    @pytest.mark.parametrize("p,q,per_card", ROUTES)
    def test_one_step_of_potrf_block_cyclic(self, monkeypatch, p, q, per_card):
        n, nb, k = 256, 16, 0
        lay = TP.BlockCyclicLayout(n, nb, p, q)
        x = TP.generate_spd_block_cyclic(lay, TP.make_mesh(p, q, device="cpu"),
                                         dtype=torch.float64)
        l = torch.linalg.cholesky(TP.to_dense(x, lay))
        mesh, log = _spread(monkeypatch, p, q, per_card)
        with member_comm.over(mesh):
            potrf_dist._panel_phase(x, lay, k)
        card = mesh.device_of
        # the factor L_kk: to the cards of mesh column k mod q, the diagonal owner's aside
        want = {("lkk", card(r * q + k % q)) for r in range(p)} - {("lkk", card(0))}
        # strip r (mesh row r's solved rows of tile column k, from window row w0, zero at
        # or above tile row k): to each card of a member updating a tile of its own below
        # the diagonal whose tile row is ≡ r or whose tile column is ≡ r (mod p)
        w0, nt = (k + 1) // p, lay.ntiles
        strips = []
        for r in range(p):
            rows = [(li * p + r) for li in range(w0, lay.ltr)]
            strips.append(torch.cat([l[i * nb : (i + 1) * nb, k * nb : (k + 1) * nb] if i > k
                                     else torch.zeros(nb, nb, dtype=l.dtype) for i in rows]))
        for m in range(p * q):
            r, c = divmod(m, q)
            tiles = [(i, j) for i in range(r, nt, p) for j in range(c, nt, q) if i >= j > k]
            for used in ({r} | {j % p for _, j in tiles}) if tiles else ():
                if card(m) != card(used * q + k % q):
                    want.add((f"strip {used}", card(m)))
        got = set()
        for block, dests in _routes(log):
            names = ["lkk"] * (block.shape == (nb, nb) and torch.allclose(
                block, l[:nb, :nb], rtol=1e-12, atol=1e-14)) + [
                f"strip {r}" for r, s in enumerate(strips)
                if block.shape == s.shape and torch.allclose(block, s, rtol=1e-12, atol=1e-14)]
            assert len(names) == 1, f"an unknown block of shape {tuple(block.shape)} crossed"
            got |= {(names[0], d) for d in dests}
        assert got == want
        assert len(log) == len(want)  # each block crosses to each card once

    @pytest.mark.parametrize("p,q,per_card", ROUTES)
    def test_potrs_block_cyclic(self, monkeypatch, p, q, per_card):
        """Every block of the solve is read by every card (each holds the
        replicated right-hand side and applies every update): B goes to
        every card, each diagonal tile, forward update and backward part to
        every card but its owner's (the owners counted from the solve's
        steps); and the answer matches the one-card mesh's bits."""
        n, nb, nrhs = 64 * p * q // 2, 16, 3
        lay = TP.BlockCyclicLayout(n, nb, p, q)
        one = TP.make_mesh(p, q, device="cpu")
        lx = TP.potrf_block_cyclic(TP.generate_spd_block_cyclic(lay, one, dtype=torch.float64),
                                   lay, one)
        b = torch.from_numpy(np.random.default_rng(2).standard_normal((n, nrhs)))
        ref = TP.potrs_block_cyclic(lx, b, lay, one)
        mesh, log = _spread(monkeypatch, p, q, per_card)
        got = TP.potrs_block_cyclic(lx, b, lay, mesh)
        assert torch.equal(got, ref)
        cards = set(mesh.cards)
        nt, ltr = lay.ntiles, lay.ltr
        owners = []  # the owner of each block crossing
        for k in range(nt):
            owners.append((k % p) * q + k % q)
            owners += [r * q + k % q for r in range(p) if max(0, (k - r) // p + 1) < ltr]
        for k in reversed(range(nt)):
            owners += [r * q + k % q for r in range(p) if max(0, (k - r) // p + 1) < ltr]
            owners.append((k % p) * q + k % q)
        routes = _routes(log)
        assert routes[0][0].shape == (n, nrhs) and routes[0][1] == cards  # B, from the CPU
        assert Counter(frozenset(dests) for _, dests in routes[1:]) == Counter(
            frozenset(cards - {mesh.device_of(m)}) for m in owners)


# ---- the accounting -------------------------------------------------------------------------

class TestAccounting:
    LAYOUTS = [(256, 32, 2, 4), (512, 16, 2, 4), (512, 32, 4, 2), (384, 32, 1, 4), (256, 16, 8, 1)]

    @pytest.mark.parametrize("n,nb,p,q", LAYOUTS)
    def test_flop_accounting_equals_jax(self, n, nb, p, q):
        jl, tl = JP.BlockCyclicLayout(n, nb, p, q), TP.BlockCyclicLayout(n, nb, p, q)
        assert TP.flop_accounting(tl, per_step=True) == JP.flop_accounting(jl, per_step=True)
        for ss in (1, 3, tl.ntiles):
            assert (TP.flop_accounting_super(tl, ss, per_step=True)
                    == JP.flop_accounting_super(jl, ss, per_step=True))
        assert [TM.step_comm_elems(tl, k) for k in range(tl.ntiles)] == [
            JM.step_comm_elems(jl, k) for k in range(jl.ntiles)]
        assert sum(TM.step_comm_elems(tl, k) for k in range(tl.ntiles)) == \
            TP.flop_accounting(tl)["comm_elems"]

    @pytest.mark.parametrize("n,panel,item", [(163840, 4096, 4), (131072, 2048, 8), (1000, 256, 4)])
    def test_oocore_volumes_equal_jax(self, n, panel, item):
        assert TM.oocore_volumes(n, panel, item) == JM.oocore_volumes(n, panel, item)

    @pytest.mark.parametrize("n,nrhs,p", [(128, 8, 8), (16384, 64, 4), (100, 3, 1)])
    def test_serving_comm_elems_equal_jax(self, n, nrhs, p):
        from dla_tpu.parallel.serving import serving_comm_elems as jax_sce

        assert TP.serving_comm_elems(n, nrhs, p) == jax_sce(n, nrhs, p)


# ---- the solve and serving planes ------------------------------------------------------------

class TestSolve:
    @pytest.mark.parametrize("p,q", [(1, 1), (2, 2), (2, 4), (4, 2)])
    def test_potrs_against_jax(self, p, q):
        n, nb, nrhs = 128, 16, 3
        jl, jm, tl, tm = _pair(n, nb, p, q)
        a = _spd(n, 40 + p * q)
        b = np.random.default_rng(41).standard_normal((n, nrhs))
        lx = TP.potrf_block_cyclic(TP.from_dense(np.tril(a), tl, tm), tl, tm)
        got = TP.potrs_block_cyclic(lx, b, tl, tm)
        assert got.shape == (n, nrhs) and got.dtype == torch.float64
        jlx = JP.potrf_block_cyclic(JP.from_dense(np.tril(a), jl, jm), jl, jm)
        want = np.asarray(JP.potrs_block_cyclic(jlx, jnp.asarray(b), jl, jm))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(got.numpy(), np.linalg.solve(a, b), rtol=1e-8, atol=1e-8)
        assert float(residual_posv(torch.tensor(a), torch.tensor(b), got)) < 1e-10

    def test_full_distributed_posv(self):
        lay, mesh = TP.BlockCyclicLayout(256, 32, 2, 4), TP.make_mesh(2, 4, device="cpu")
        xa = TP.generate_spd_block_cyclic(lay, mesh, seed=51, dtype=torch.float64)
        a = TP.to_dense(xa, lay)
        lx = TP.potrf_block_cyclic(xa, lay, mesh)
        b = torch.from_numpy(np.random.default_rng(5).standard_normal((256, 2)))
        x = TP.potrs_block_cyclic(lx, b, lay, mesh)
        assert float(residual_posv(a, b, x, assume_symmetric=True)) < 1e-13

    def test_reads_only_the_factors_lower_triangle(self):
        lay, mesh = TP.BlockCyclicLayout(128, 16, 2, 2), TP.make_mesh(2, 2, device="cpu")
        l = torch.tensor(_port_factor(np.tril(_spd(128, 6)), lay, mesh))
        b = torch.ones(128, 2, dtype=torch.float64)
        dirty = l + torch.triu(torch.full_like(l, float("nan")), 1)
        assert torch.equal(TP.potrs_block_cyclic(TP.from_dense(dirty, lay, mesh), b, lay, mesh),
                           TP.potrs_block_cyclic(TP.from_dense(l, lay, mesh), b, lay, mesh))

    def test_rhs_shape_is_checked(self):
        lay, mesh = TP.BlockCyclicLayout(64, 16, 2, 2), TP.make_mesh(2, 2, device="cpu")
        x = TP.generate_spd_block_cyclic(lay, mesh, dtype=torch.float64)
        with pytest.raises(ValueError, match="b must be"):
            TP.potrs_block_cyclic(x, torch.ones(64), lay, mesh)


class TestServing:
    @pytest.mark.parametrize("p", [1, 4, 8])
    def test_solve_inverse_sharded_against_jax(self, p):
        from dla_tpu.algos import potrf_blocked as jax_potrf_blocked
        from dla_tpu.algos import potri as jax_potri
        from dla_tpu_torch.algos import potrf_blocked, potri

        rng = np.random.default_rng(71)
        n, nrhs = 64, 5
        a = _spd(n, 71)
        b = rng.standard_normal((n, nrhs))
        ainv = potri(potrf_blocked(torch.tensor(a), nb=16))
        mesh = TP.make_serving_mesh(p, device="cpu")
        assert mesh.size == p and mesh.axis_names == ("d",)
        got = TP.solve_inverse_sharded(ainv, b, mesh)
        want = np.asarray(JP.solve_inverse_sharded(jax_potri(jax_potrf_blocked(jnp.asarray(a),
                                                                               nb=16)),
                                                   jnp.asarray(b), JP.make_serving_mesh(p)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(a @ got.numpy(), b, rtol=1e-9, atol=1e-9)
        assert float(residual_posv(torch.tensor(a), torch.tensor(b), got)) < 1e-10

    def test_one_gather_of_the_accounted_volume(self, monkeypatch):
        n, nrhs, p = 128, 8, 8
        parts = []
        real = member_comm.all_gather_tiled
        monkeypatch.setattr(member_comm, "all_gather_tiled",
                            lambda blocks: parts.append([t.numel() for t in blocks])
                            or real(blocks))
        x = TP.solve_inverse_sharded(torch.eye(n, dtype=torch.float64),
                                     torch.zeros(n, nrhs, dtype=torch.float64),
                                     TP.make_serving_mesh(p, device="cpu"))
        assert x.shape == (n, nrhs) and len(parts) == 1 and len(parts[0]) == p
        assert parts[0][0] * (p - 1) == TP.serving_comm_elems(n, nrhs, p)

    def test_refusals(self):
        mesh = TP.make_serving_mesh(3, device="cpu")
        with pytest.raises(ValueError, match="not divisible"):
            TP.solve_inverse_sharded(torch.eye(64), torch.ones(64, 1), mesh)
        with pytest.raises(ValueError, match="row blocks"):
            TP.sharded_apply(mesh)([torch.eye(64)], torch.ones(64, 1))


# ---- the gates this slice's entry points use ---------------------------------------------------

class TestGatesSeeTheFactor:
    """Watch-list item 9: ``residual_potrf`` (session, driver) and
    ``freivalds_device`` (the driver where A and L do not fit) must rise with
    a known relative perturbation δ of tril(L), in the port and in JAX: each
    reads within [δ/2, 5δ] once δ is ten times its own floor (the
    unperturbed factor's value), and never below the floor. The fp32
    Freivalds gate's floor is ≈ 5e-7 in both packages, so δ runs to 1e-4."""

    DELTAS = [1e-12, 1e-11, 1e-10, 1e-9, 1e-8, 1e-7, 1e-6, 1e-5, 1e-4]

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_gates_rise_with_the_perturbation(self, dtype):
        n = 256
        lay, mesh = TP.BlockCyclicLayout(n, 32, 2, 2), TP.make_mesh(2, 2, device="cpu")
        x = TP.generate_spd_block_cyclic(lay, mesh, dtype=dtype)
        a = TP.to_dense(x, lay).double().numpy()
        l = torch.tril(TP.to_dense(TP.potrf_block_cyclic(x, lay, mesh), lay)).numpy()
        r = np.random.default_rng(0).uniform(-1.0, 1.0, l.shape)
        gates = {
            "port residual_potrf": lambda lp: residual_potrf(torch.tensor(a), torch.tensor(lp)),
            "jax residual_potrf": lambda lp: JV.residual_potrf(jnp.asarray(a), jnp.asarray(lp)),
            "port freivalds_device": lambda lp: freivalds_device(torch.tensor(lp), row_chunk=128),
            "jax freivalds_device": lambda lp: JV.freivalds_device(jnp.asarray(lp), row_chunk=128),
        }
        for name, gate in gates.items():
            got = [float(gate(np.tril(l * (1.0 + d * r)).astype(l.dtype)))
                   for d in [0.0] + self.DELTAS]
            floor, seen = got[0], []
            for delta, v in zip(self.DELTAS, got[1:]):
                assert v >= floor * (1 - 1e-3), (name, delta, v, floor)
                if delta >= 10 * floor:
                    assert delta / 2 <= v <= 5 * delta, (name, delta, v)
                    seen.append(v)
            assert len(seen) >= 2 and seen == sorted(seen), (name, got)


# ---- the entry points ---------------------------------------------------------------------------

def _session(capsys, *argv):
    rc = session.main([str(a) for a in argv])
    return rc, capsys.readouterr()


class TestSession:
    def test_end_to_end_on_the_cpu(self, capsys):
        rc, cap = _session(capsys, "--N", 256, "--B", 32, "--p", 2, "--q", 4, "--dtype", "d",
                           "--solve", 4, "--platform", "cpu")
        assert rc == 0, cap.out + cap.err
        out = cap.out
        assert "mesh=2x4 dtype=float64 backend=cpu" in out
        assert "[CLIENT] DAG: 8 POTRF + 28 TRSM + 28 SYRK + 56 GEMM = 120 tile tasks" in out
        assert out.count("[CLIENT] wave k=") == 8
        res = float(out.split("||A - LL^T||_inf / ||A||_inf = ")[1].split()[0])
        sres = float(out.split("||B - A X||_inf / (||A||_inf ||X||_inf) = ")[1].split()[0])
        assert res < 1e-10 and sres < 1e-10
        assert "Elapsed:" in out and "Performance:" in out
        assert out.rstrip().endswith("[CLIENT] session complete: PASS")

    def test_fp32_gate(self, capsys):
        rc, cap = _session(capsys, "--N", 256, "--B", 32, "--p", 2, "--q", 2, "--dtype", "s",
                           "--platform", "cpu")
        assert rc == 0 and "dtype=float32" in cap.out and "PASS" in cap.out

    def test_env_config_and_positional_layering(self, capsys, monkeypatch, tmp_path):
        cfg = tmp_path / "appsettings.json"
        cfg.write_text(json.dumps({"N": 512, "NB": 64, "dtype": "d", "p": 2, "q": 2}))
        monkeypatch.setenv("CHOLESKY_N", "128")
        rc, cap = _session(capsys, "--config", cfg, "--platform", "cpu")
        assert rc == 0 and "N=128 B=64 tiles=2x2 mesh=2x2 dtype=float64" in cap.out
        monkeypatch.delenv("CHOLESKY_N")
        rc, cap = _session(capsys, "--platform", "cpu", "--dtype", "d", "128", "16")
        assert rc == 0 and "N=128 B=16 tiles=8x8 mesh=1x1" in cap.out
        rc, cap = _session(capsys, "--platform", "cpu", "--dtype", "d", "--N", "64", "--B", "16",
                           "x")
        assert rc == 0 and "invalid positional args ignored" in cap.out

    def test_non_spd_prints_fail_and_exits_1(self, capsys, monkeypatch):
        real = TP.generate_spd_block_cyclic
        monkeypatch.setattr(TP, "generate_spd_block_cyclic",
                            lambda *a, **kw: real(*a, **dict(kw, bump=-1.0)))
        rc, cap = _session(capsys, "--N", 128, "--B", 16, "--p", 2, "--q", 2, "--dtype", "d",
                           "--solve", 2, "--platform", "cpu")
        assert rc == 1 and "= nan" in cap.out
        assert cap.out.rstrip().endswith("[CLIENT] session complete: FAIL")

    def test_no_card_fails_instead_of_running_on_the_cpu(self, capsys, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        rc, cap = _session(capsys, "--N", 64, "--B", 16)
        assert rc == 2 and "no CUDA device" in cap.err and "session:" not in cap.out

    def test_auto_grid_over_several_cards_names_a9(self, capsys, monkeypatch):
        """With 4 cards and no --p/--q the session builds the squarest grid
        over them, 2×2 with one member per card (ROADMAP A9c), and reaches
        the factorization instead of raising: the factorization is patched
        to record the mesh it is given (generation and the cards' waits
        too, nothing lies on a card here)."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "card")
        _pretend_cards(monkeypatch, 4)
        monkeypatch.setattr(member_comm, "synchronize", lambda devices: None)
        monkeypatch.setattr(TP, "generate_spd_block_cyclic", lambda layout, mesh, **kw: None)
        seen = []

        class Reached(Exception):
            pass

        def factor(x, layout, mesh):
            seen.append((layout, mesh))
            raise Reached

        monkeypatch.setattr(TP, "potrf_block_cyclic", factor)
        with pytest.raises(Reached):
            session.main(["--N", "64", "--B", "16"])
        out = capsys.readouterr().out
        assert "mesh=2x2" in out and "[CLIENT] members on cuda:0,cuda:1,cuda:2,cuda:3" in out
        (layout, mesh), = seen
        assert (layout.p, layout.q) == mesh.shape == (2, 2)
        assert mesh.devices == tuple(torch.device("cuda", i) for i in range(4))

    @pytest.mark.parametrize("dtype", ["z", "c"])
    def test_complex_dtype_names_a5(self, capsys, dtype):
        """The session at a complex dtype does what JAX's does at N=64 on a
        2×2 mesh: it computes, and both residuals pass (complex128 under
        1e-10 here and in JAX under x64; complex64 under N·2e-7). The residual
        lines agree within 1e-13 (z) and 1e-6 (c) absolute."""
        from dla_tpu.cli import session as jax_session

        argv = ["--N", 64, "--B", 16, "--p", 2, "--q", 2, "--dtype", dtype, "--solve", 2]
        rc, cap = _session(capsys, *argv, "--platform", "cpu")
        assert rc == 0 and cap.out.rstrip().endswith("[CLIENT] session complete: PASS")
        assert f"dtype={'complex128' if dtype == 'z' else 'complex64'}" in cap.out
        jrc = jax_session.main([str(a) for a in argv])
        jout = capsys.readouterr().out
        assert jrc == 0 and jout.rstrip().endswith("[CLIENT] session complete: PASS")
        for pat in (r"^\|\|A - LL\^T\|\|_inf / \|\|A\|\|_inf = (\S+)$",
                    r"^\|\|B - A X\|\|_inf / \(\|\|A\|\|_inf \|\|X\|\|_inf\) = (\S+)$"):
            mine, ref = (float(re.search(pat, o, re.M).group(1)) for o in (cap.out, jout))
            assert abs(mine - ref) <= (1e-13 if dtype == "z" else 1e-6), (pat, mine, ref)


class TestDriverDistributed:
    def _drive(self, capsys, *argv):
        rc = potrf_driver.main([str(a) for a in argv])
        return rc, capsys.readouterr()

    def test_exact_residual(self, capsys):
        rc, cap = self._drive(capsys, "--n", 256, "--nb", 32, "--dtype", "d", "--device", "cpu",
                              "--mode", "distributed", "--p", 2, "--q", 4, "--repeats", 2)
        assert rc == 0, cap.out + cap.err
        assert "mode=distributed" in cap.out and cap.out.count("Repeat ") == 3
        assert "||A - LL^T||_inf / ||A||_inf" in cap.out and "PASS (residual < 1e-10)" in cap.out

    def test_freivalds_where_a_and_l_do_not_fit_and_solve(self, capsys, monkeypatch):
        monkeypatch.setenv("DLA_TPU_VALIDATE_HBM_BUDGET", "1")
        rc, cap = self._drive(capsys, "--n", 512, "--nb", 64, "--dtype", "s", "--device", "cpu",
                              "--mode", "distributed", "--p", 2, "--q", 2, "--solve", "potrs",
                              "--nrhs", 3)
        assert rc == 0, cap.out + cap.err
        assert "freivalds ||(A - LL^T)x||" in cap.out and "SOLVE PASS" in cap.out

    def test_factor_equals_the_plane(self, capsys, monkeypatch):
        """The driver's factor is the plane's on tril(plgsy)."""
        import dla_tpu_torch.validate as V

        got, real = {}, V.residual_potrf

        def spy(a, l, **kw):
            got["l"] = l.clone()
            return real(a, l, **kw)

        monkeypatch.setattr(V, "residual_potrf", spy)
        rc, _ = self._drive(capsys, "--n", 128, "--nb", 16, "--dtype", "d", "--device", "cpu",
                            "--mode", "distributed", "--p", 2, "--q", 2)
        assert rc == 0
        lay, mesh = TP.BlockCyclicLayout(128, 16, 2, 2), TP.make_mesh(2, 2, device="cpu")
        x = TP.generate_spd_block_cyclic(lay, mesh, dtype=torch.float64)
        want = torch.tril(TP.to_dense(TP.potrf_block_cyclic(x, lay, mesh), lay))
        assert torch.equal(got["l"], want)


# ---- the dry run's planes 1, 4 and 5 -----------------------------------------------------------

def test_dryrun_block_cyclic_planes():
    lines = dryrun.block_cyclic_planes(64, 8, 8, "cpu")
    assert sorted(lines) == [1, 4, 5]
    assert lines[1].startswith("dryrun OK: mesh 2x4 on cpu (block-cyclic")
    assert lines[4].startswith("dryrun OK: mesh 2x4 on cpu (distributed POTRS")
    assert lines[5].startswith("dryrun OK: mesh 1x8 on cpu (row-sharded A^-1 serving apply), N=128")
    assert all("(fp64 gate 1e-10)" in x for x in lines.values())


def test_dryrun_planes_fail_loudly(monkeypatch):
    monkeypatch.setattr(dryrun, "GATE", 0.0)
    with pytest.raises(RuntimeError, match="block-cyclic plane: residual .* not below the fp64"):
        dryrun.block_cyclic_planes(64, 8, 4, "cpu")
    monkeypatch.setattr(dryrun, "gate", lambda kind, a, l: 0.0)
    with pytest.raises(RuntimeError, match="solve plane: residual .* not below the fp64"):
        dryrun.block_cyclic_planes(64, 8, 4, "cpu")


def test_squarest_grid_as_jax():
    assert [TP.block_cyclic.squarest(d) for d in (1, 2, 4, 6, 8, 9, 12)] == [
        (1, 1), (1, 2), (2, 2), (2, 3), (2, 4), (3, 3), (3, 4)]


def test_parallel_exports_the_reference_names():
    """``parallel``'s names are the JAX package's (its scaling model on H100
    figures included), plus the port's meshes, its packed accounting and
    ``sharded_apply`` (a function of the JAX package's serving module)."""
    import ast
    from pathlib import Path

    def names(init):
        tree = ast.parse(init.read_text())
        return {a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
                for a in node.names}

    repo = Path(__file__).resolve().parents[1]
    ref, port = names(repo / "dla_tpu/parallel/__init__.py"), names(
        repo / "dla_tpu_torch/parallel/__init__.py")
    assert ref - port == set()
    assert port - ref == {"FlatMesh", "MemberMesh", "packed_cyclic_accounting",
                          "packed_resident_bytes", "sharded_apply"}
    assert all(hasattr(TP, n) for n in port)
