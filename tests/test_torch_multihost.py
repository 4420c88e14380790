"""dla_tpu_torch's multi-process plane (``parallel/multihost.py`` over
``torch.distributed``): the demo's five planes run by 2 processes × 4
members over gloo on the CPU, as tests/test_multihost.py runs JAX's with
2 processes × 4 CPU devices.

Every child process starts with ``python -m dla_tpu_torch.parallel.multihost``
and imports only the port. The children of one run start together, each run
with a timeout of its own and its rendezvous held by this process until they
exit (``tests/torch_rendezvous.py``); process 0 saves each plane's
assembled result (``--save``), which this process holds:
- bit for bit to the same plane in one process on an 8-member CPU mesh here
  (and a run of one process, whose world of one takes that path);
- to JAX's single-process plane on the 8 CPU devices of tests/conftest.py,
  within the tolerances of the existing parity tests: 1e-11 for the block
  plane (tests/test_torch_block_cyclic.py), 1e-10 for the solve, 1e-12·max|L|
  for the fp64 ring planes and 1e-11 relative for df64
  (tests/test_torch_parallel.py);
- and the 1e-10 gate line of process 0.

The serving apply runs across processes too (2 processes × 2 members,
``tests/torch_serving_child.py``, n=256, nrhs=3, fp64): every process's X
must be the bits of the one-process mesh of 4 members here.

Sizes are JAX's test sizes (block N=64, the others N=128, NB=8, 2×4), but
packed df64 runs at N=64 (JAX's demo default): JAX's df64 plane compiles for
about a minute at N=128. The super-stepped block plane runs at N=160, NB=2
(80 steps, past the unrolled program's 64); JAX's super-stepped program is
held to the port's in tests/test_torch_block_cyclic.py, as it takes about a
minute to compile at 80 steps.
"""

import os
import re
import subprocess
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dla_tpu.parallel as JP
from dla_tpu.ops import plgsy as jax_plgsy
from dla_tpu.ops.df64 import to_df64 as jax_to_df64
from dla_tpu_torch import parallel as TP
from dla_tpu_torch.ops import plgsy
from dla_tpu_torch.ops.df64 import to_df64
from dla_tpu_torch.parallel import block_cyclic, member_comm, multihost
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from torch_rendezvous import HeldRendezvous

REPO = Path(__file__).resolve().parents[1]
RUN_TIMEOUT = 240  # seconds a run's children may take in all
COLLECTIVE_TIMEOUT = 60  # the demo's --timeout: rendezvous and each collective
KILLED_TIMEOUT = 5  # the same, in the run whose rank 1 is killed
GATE = 1e-10

#: run -> (planes, argv beyond the common flags, processes)
RUNS = {
    "block": ("block", ["--n", "64", "--nb", "8"], 2),
    "ring": ("potrs,column,packed", ["--n", "128", "--nb", "8"], 2),
    "df64": ("packed-df64", ["--n", "64", "--nb", "8"], 2),
    "super": ("block", ["--n", "160", "--nb", "2"], 2),
    "one": ("block", ["--n", "64", "--nb", "8", "--local-devices", "8"], 1),
}
#: plane case -> (run, plane, n, nb)
CASES = {
    "block": ("block", "block", 64, 8),
    "potrs": ("ring", "potrs", 128, 8),
    "column": ("ring", "column", 128, 8),
    "packed": ("ring", "packed", 128, 8),
    "packed-df64": ("df64", "packed-df64", 64, 8),
    "block-super": ("super", "block", 160, 2),
}


def _start(planes, argv, nproc, save, timeout=COLLECTIVE_TIMEOUT, pids=None):
    """The demo's children of one run on a rendezvous of their own, held here
    until they exit: (the rendezvous, the children)."""
    rdv = HeldRendezvous(nproc)
    common = ["--nproc", str(nproc), "--p", "2", "--q", "4", "--plane", planes, "--device",
              "cpu", "--backend", "gloo", "--timeout", str(timeout), "--compare"]
    common += ["--save", str(save)] if save else []
    return rdv, rdv.start(["-m", "dla_tpu_torch.parallel.multihost"] + common + argv,
                          range(nproc) if pids is None else pids, cwd=REPO,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))


SERVING = {"nproc": 2, "members": 2, "n": 256, "nrhs": 3}


def _start_serving(save, timeout=COLLECTIVE_TIMEOUT):
    """The serving child as SERVING's processes, as :func:`_start` starts the demo's."""
    rdv = HeldRendezvous(SERVING["nproc"])
    argv = ["--nproc", str(SERVING["nproc"]), "--members", str(SERVING["members"]), "--n",
            str(SERVING["n"]), "--nrhs", str(SERVING["nrhs"]), "--dtype", "float64", "--device",
            "cpu", "--backend", "gloo", "--timeout", str(timeout), "--queries", "2", "--compare",
            "--save", str(save)]
    return rdv, rdv.start([str(REPO / "tests" / "torch_serving_child.py")] + argv,
                          range(SERVING["nproc"]), cwd=REPO,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))


def _finish(procs, deadline):
    """(return codes, outputs); a child still running at the deadline is
    killed and counts as failed (None)."""
    outs, rcs = [], []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            rcs.append(p.returncode)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            rcs.append(None)
        outs.append(out)
    return rcs, outs


class _Runs:
    """Every run's children, started together, each run on a rendezvous held
    here; ``runs[name]`` waits for that run's children (rcs, outputs, save
    dir) and then closes its rendezvous, so JAX's planes compile here while
    the children run."""

    def __init__(self, tmp_path_factory):
        self.started, self.done = {}, {}
        for name, (planes, argv, nproc) in RUNS.items():
            save = tmp_path_factory.mktemp(f"mh_{name}")
            self.started[name] = (*_start(planes, argv, nproc, save), save)
        # rank 1 killed before it can join: rank 0 must give up at its 5 s timeout
        self.t_killed = time.monotonic()
        rdv, killed = _start("block", ["--n", "64", "--nb", "8"], 2, None, timeout=KILLED_TIMEOUT)
        killed[1].kill()
        self.started["killed"] = (rdv, killed, None)
        save = tmp_path_factory.mktemp("mh_serving")
        self.started["serving"] = (*_start_serving(save), save)
        self.deadline = time.monotonic() + RUN_TIMEOUT

    def __getitem__(self, name):
        if name not in self.done:
            rdv, procs, save = self.started[name]
            self.done[name] = (*_finish(procs, self.deadline), save)
            rdv.close()
        return self.done[name]

    def close(self):
        for name in self.started:
            self[name]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = _Runs(tmp_path_factory)
    yield r
    r.close()


def _saved(runs, case):
    run, plane, _, _ = CASES[case]
    rcs, outs, save = runs[run]
    assert rcs == [0] * len(rcs), outs
    return np.load(save / f"{plane}.npy")


# ---- the one-process planes and JAX's ----------------------------------------------------

def _rhs(n):
    return np.random.default_rng(5).standard_normal((n, 3))


def _port_one_process(case):
    """The case's plane in this process on a 2×4 / 8-member CPU mesh."""
    _, plane, n, nb = CASES[case]
    if plane in ("block", "potrs"):
        lay, mesh = TP.BlockCyclicLayout(n, nb, 2, 4), TP.make_mesh(2, 4, device="cpu")
        lx = TP.potrf_block_cyclic(TP.generate_spd_block_cyclic(lay, mesh, seed=51,
                                                                dtype=torch.float64), lay, mesh)
        if plane == "potrs":
            return TP.potrs_block_cyclic(lx, _rhs(n), lay, mesh).numpy()
        return TP.to_dense(lx, lay).tril_().numpy()
    mesh = TP.make_flat_mesh(8, device="cpu")
    seed = {"column": 7, "packed": 3, "packed-df64": 13}[plane]
    a = plgsy(n, seed=seed, dtype=torch.float64, device="cpu")
    if plane == "column":
        lx = TP.potrf_column_cyclic_ring(TP.from_dense_cols(a, nb, mesh), nb, mesh)
        return torch.tril(TP.to_dense_cols(lx, nb, mesh)).numpy()
    if plane == "packed":
        lx = TP.potrf_packed_cyclic(TP.pack_cols_packed(a, nb, mesh), n, nb, mesh)
        return TP.unpack_cols_packed(lx, n, nb, mesh).numpy()
    xh, xl = (TP.pack_cols_packed(h, nb, mesh) for h in to_df64(a))
    lh, ll = TP.potrf_packed_cyclic_df64(xh, xl, n, nb, mesh)
    return (TP.unpack_cols_packed(lh, n, nb, mesh).double()
            + TP.unpack_cols_packed(ll, n, nb, mesh).double()).numpy()


def _jax_plane(case):
    """JAX's plane in this process on conftest's 8 CPU devices (fp64; hi + lo
    for df64)."""
    _, plane, n, nb = CASES[case]
    if plane in ("block", "potrs"):
        lay, mesh = JP.BlockCyclicLayout(n=n, nb=nb, p=2, q=4), JP.make_mesh(2, 4)
        lx = JP.potrf_block_cyclic(JP.generate_spd_block_cyclic(lay, mesh, seed=51,
                                                                dtype=jnp.float64), lay, mesh)
        if plane == "potrs":
            return np.asarray(JP.potrs_block_cyclic(lx, jnp.asarray(_rhs(n)), lay, mesh))
        return np.tril(np.asarray(JP.to_dense(lx, lay)))
    mesh = JP.make_flat_mesh(8)
    seed = {"column": 7, "packed": 3, "packed-df64": 13}[plane]
    a = np.asarray(jax_plgsy(n, seed=seed, dtype=jnp.float64))
    if plane == "column":
        lx = JP.potrf_column_cyclic_ring(JP.from_dense_cols(jnp.asarray(a), nb, mesh), nb, mesh)
        return np.tril(np.asarray(JP.to_dense_cols(lx, nb, mesh)))
    if plane == "packed":
        lx = JP.potrf_packed_cyclic(JP.pack_cols_packed(a, nb, mesh), n, nb, mesh)
        return np.asarray(JP.unpack_cols_packed(lx, n, nb, mesh))
    ah, al = jax_to_df64(a)
    lh, ll = JP.potrf_packed_cyclic_df64(JP.pack_cols_packed(np.asarray(ah), nb, mesh),
                                         JP.pack_cols_packed(np.asarray(al), nb, mesh),
                                         n, nb, mesh)
    return (np.asarray(JP.unpack_cols_packed(lh, n, nb, mesh), np.float64)
            + np.asarray(JP.unpack_cols_packed(ll, n, nb, mesh), np.float64))


# ---- the demo: 2 processes × 4 members ---------------------------------------------------

@pytest.mark.parametrize("case", ["block", "potrs", "column", "packed", "packed-df64"])
def test_factor_within_the_parity_tolerance_of_jax(runs, case):
    want = _jax_plane(case)  # first: the children run meanwhile
    got = _saved(runs, case)
    if case == "block":
        np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)
    elif case == "potrs":
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    else:
        rel = 1e-11 if case == "packed-df64" else 1e-12
        assert np.abs(got - want).max() <= rel * np.abs(want).max()


GATE_LINE = re.compile(r"^\[mh 0\] .*(?:\|\|A - LL\^T\|\|_inf / \|\|A\|\|_inf|\|\|B - AX\|\| "
                       r"gate) = (\S+) PASS$", re.M)


@pytest.mark.parametrize("case", list(CASES))
def test_two_processes_pass_the_gate(runs, case):
    run, plane, n, nb = CASES[case]
    rcs, outs, _ = runs[run]
    assert rcs == [0, 0], outs
    assert "[mh 0] 2 processes, 8 global members (4 local) on cpu, backend gloo" in outs[0]
    assert "[mh 1] 2 processes, 8 global members" in outs[1]
    section = outs[0].split(f"[mh 0] plane {plane}: N={n} NB={nb} over 8 members")[1]
    m = GATE_LINE.search(section)
    assert m and float(m.group(1)) < GATE, outs[0]


@pytest.mark.parametrize("case", list(CASES))
def test_factor_equals_the_one_process_plane_bit_for_bit(runs, case):
    got = _saved(runs, case)
    want = _port_one_process(case)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_every_rank_reports_its_boundary_and_the_one_process_comparison(runs):
    rcs, outs, _ = runs["ring"]
    assert rcs == [0, 0], outs
    for pid, out in enumerate(outs):
        for plane in ("potrs", "column", "packed"):
            line = re.search(rf"^\[mh {pid}\] plane {plane}: .*$", out, re.M).group(0)
            calls = int(re.search(r"boundary (\d+) broadcasts", line).group(1))
            assert calls > 0 and "ring_broadcast launches 0" in line, line
            assert "peak device memory" in line
    for plane in ("potrs", "column", "packed"):
        assert re.search(rf"^\[mh 0\] plane {plane} in one process on 8 members: .*max "
                         r"\|difference\| 0\.000e\+00, the same bits: True$", outs[0], re.M)
    assert "in one process" not in outs[1]


def test_super_stepped_plane_across_processes(runs):
    """80 tile steps: the program super-steps, across the boundary too."""
    rcs, outs, _ = runs["super"]
    assert rcs == [0, 0], outs
    assert re.search(r"^\[mh 0\] plane block in one process on 8 members: .*the same bits: "
                     r"True$", outs[0], re.M)
    assert TP.BlockCyclicLayout(160, 2, 2, 4).ntiles > 64


def test_a_world_of_one_takes_the_one_process_path(runs):
    rcs, outs, save = runs["one"]
    assert rcs == [0], outs
    assert "[mh 0] 1 processes, 8 global members (8 local)" in outs[0]
    assert "boundary 0 broadcasts, 0.000 MB" in outs[0]
    np.testing.assert_array_equal(np.load(save / "block.npy"), _port_one_process("block"))


def test_a_killed_rank_fails_the_run_within_its_timeout(runs):
    """Rank 1 is killed before it joins: rank 0 gives up at the rendezvous
    timeout with an error, and nothing hangs. The held store is up, so rank 0
    waits in gloo's rendezvous for rank 1's key in that store, whose wait
    times out after the 5 s given."""
    rcs, outs, _ = runs["killed"]
    assert rcs[0] not in (0, None), outs[0]
    assert "wait timeout after 5000ms, keys: /default_pg/" in outs[0] and "PASS" not in outs[0]
    assert time.monotonic() - runs.t_killed < RUN_TIMEOUT


def test_unknown_plane_is_refused(capsys):
    with pytest.raises(SystemExit):
        multihost._demo(["--coordinator", "127.0.0.1:1", "--nproc", "1", "--pid", "0",
                         "--plane", "block,ring", "--device", "cpu"])
    assert "unknown plane(s) ['ring']" in capsys.readouterr().err


# ---- meshes across processes, in this process --------------------------------------------

def _spanning(kind, process, processes=2):
    cpu = torch.device("cpu")
    if kind == "block":
        return TP.MemberMesh((cpu,) * 8, (2, 4), processes=processes, process=process)
    return TP.FlatMesh((cpu,) * 8, processes=processes, process=process)


@pytest.mark.parametrize("kind", ["block", "flat"])
def test_members_map_to_processes_as_jax_devices(kind):
    mesh = _spanning(kind, 1)
    assert mesh.spans_processes and mesh.per_process == 4
    assert list(mesh.local_members()) == [4, 5, 6, 7]
    assert [mesh.process_of(m) for m in range(8)] == [0] * 4 + [1] * 4
    assert not mesh.is_local(3) and mesh.is_local(4)
    with pytest.raises(ValueError, match="split evenly"):
        _spanning(kind, 0, processes=3)
    with pytest.raises(ValueError, match="not one of"):
        _spanning(kind, 2)


def test_without_a_process_group_meshes_span_one_process():
    assert member_comm.process_span() == (1, 0)
    for mesh in (TP.make_mesh(2, 4, device="cpu"), TP.make_flat_mesh(8, device="cpu")):
        assert (mesh.processes, mesh.process) == (1, 0) and not mesh.spans_processes
        assert list(mesh.local_members()) == list(range(8))


def test_one_process_collectives_are_the_member_copies():
    block = torch.arange(6.0).reshape(2, 3)
    assert member_comm.share(block, 3, (2, 3), block.dtype) is block
    copy = member_comm.from_owner(block, 3, (2, 3), block.dtype)
    assert copy is not block and torch.equal(copy, block)
    with member_comm.over(TP.make_mesh(2, 4, device="cpu")):
        assert member_comm.active() is None
    with member_comm.over(_spanning("block", 0)):
        assert member_comm.active().spans_processes
    assert member_comm.active() is None


@pytest.mark.parametrize("process", [0, 1])
def test_a_process_makes_only_its_own_shards(process):
    """Generation, from_dense, from_dense_cols and pack_cols_packed on a mesh
    across processes: this process's members' shards, the one-process bits,
    None for the others."""
    lay = TP.BlockCyclicLayout(64, 8, 2, 4)
    local = range(4 * process, 4 * process + 4)
    one, mesh = TP.make_mesh(2, 4, device="cpu"), _spanning("block", process)
    a = plgsy(64, seed=7, dtype=torch.float64, device="cpu")
    for make in (lambda m: TP.generate_spd_block_cyclic(lay, m, dtype=torch.float64),
                 lambda m: TP.from_dense(a, lay, m)):
        want, got = make(one), make(mesh)
        assert [g is None for g in got] == [m not in local for m in range(8)]
        assert all(torch.equal(got[m], want[m]) for m in local)
    one, mesh = TP.make_flat_mesh(8, device="cpu"), _spanning("flat", process)
    for make in (lambda m: TP.from_dense_cols(a, 8, m), lambda m: TP.pack_cols_packed(a, 8, m)):
        want, got = make(one), make(mesh)
        assert [g is None for g in got] == [m not in local for m in range(8)]
        assert all(torch.equal(got[m], want[m]) for m in local)


def test_shards_are_checked_on_this_process_only():
    lay, mesh = TP.BlockCyclicLayout(64, 8, 2, 4), _spanning("block", 0)
    shards = TP.generate_spd_block_cyclic(lay, mesh, dtype=torch.float64)
    assert block_cyclic._check_shards(shards, lay, mesh) == shards
    shards[2] = None
    with pytest.raises(ValueError, match="need 8 shards of shape"):
        block_cyclic._check_shards(shards, lay, mesh)


def test_planes_without_a_multi_process_form_refuse_a_spanning_mesh():
    """Out of core has no multi-process form (nor in the JAX package)."""
    from dla_tpu_torch.algos.oocore import potrf_outofcore

    with pytest.raises(NotImplementedError, match="across processes"):
        potrf_outofcore(None, panel=8, nb=8, mesh=_spanning("block", 0))


# ---- the serving apply across processes ---------------------------------------------------

def _serving_one_process():
    """X on the one-process CPU mesh of all SERVING's members."""
    from dla_tpu_torch.algos import potrf_blocked, potri

    n = SERVING["n"]
    a = plgsy(n, seed=51, dtype=torch.float64, device="cpu")
    b = np.random.default_rng(5).standard_normal((n, SERVING["nrhs"]))
    mesh = TP.make_serving_mesh(SERVING["nproc"] * SERVING["members"], device="cpu")
    return TP.solve_inverse_sharded(potri(potrf_blocked(a, nb=min(512, n))), b, mesh).numpy()


def test_serving_across_processes_gives_every_process_the_one_process_bits(runs):
    """Each process computes its 2 members' slabs and receives the other
    process's by one broadcast a member: every process holds X, with the bits
    of one process on 4 members; process 0's residual passes 1e-10."""
    want = _serving_one_process()
    rcs, outs, save = runs["serving"]
    assert rcs == [0, 0], outs
    for pid, out in enumerate(outs):
        np.testing.assert_array_equal(np.load(save / f"x{pid}.npy"), want)
        line = re.search(rf"^\[serve {pid}\] 2 processes x 2 members on cpu, backend gloo: n=256 "
                         r"nrhs=3 float64: \S+ ms a query block over 2; boundary (\d+) "
                         r"broadcasts, (\S+) MB", out, re.M)
        assert line, out
        # one broadcast of each member's (n/4, nrhs) fp64 slab a query block
        assert int(line.group(1)) == 4 and float(line.group(2)) == pytest.approx(
            256 * 3 * 8 / 1e6, abs=5e-4)
    assert re.search(r"^\[serve 0\] \|\|B - AX\|\| / \(\|\|A\|\| \|\|X\|\|\) = (\S+) "
                     r"\(gate 1e-10\) PASS$", outs[0], re.M), outs[0]
    assert "in one process on 4 members" in outs[0] and outs[0].rstrip().endswith(
        "the same bits: True")


def test_multihost_names_stay_out_of_parallel():
    """As in the JAX package, ``initialize`` is reached through the module."""
    assert not hasattr(TP, "initialize") and not hasattr(TP, "PLANES")
    assert callable(multihost.initialize) and multihost.PLANES == (
        "block", "potrs", "column", "packed", "packed-df64")
