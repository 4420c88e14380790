"""dla_tpu_torch's flat-mesh ring planes held against dla_tpu's on the same
``plgsy`` matrices: the layouts, ``potrf_column_cyclic_ring``,
``potrf_packed_cyclic`` and ``potrf_packed_cyclic_df64``, the accounting of
``parallel/model.py``, and the dry run.

The JAX side runs as its own tests run it (tests/test_parallel.py,
tests/test_packed_cyclic.py): ``shard_map`` on the 8 virtual CPU devices of
tests/conftest.py, the Pallas ring in interpret mode. The port's members all
lie on the CPU, where the ring runs its plain version.

What is compared how:
- the layouts move elements: the same bits, shard by shard;
- the fp64 factors come from LAPACK Cholesky and solves and from products
  summed in another order: within 1e-12·max|L| of JAX's, lower triangle;
- the df64 factors (hi + lo in fp64) within 1e-11 relative: XLA's CPU backend
  contracts the error-free transforms' products into FMAs under ``jit``,
  the port never does; both values of ``slice_reuse`` give the port the same
  bits;
- every residual under the reference's 1e-10 gate;
- the accounting is a copy: equal dicts; the ring calls the planes make have
  the accounting's sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dla_tpu.parallel as JPAR
from dla_tpu.ops import plgsy as jax_plgsy
from dla_tpu.ops.df64 import to_df64 as jax_to_df64
from dla_tpu.parallel import model as JM
from dla_tpu_torch import parallel as TPAR
from dla_tpu_torch.kernels import collectives as TC
from dla_tpu_torch.parallel import column_cyclic as TCC
from dla_tpu_torch.parallel import dryrun
from dla_tpu_torch.parallel import model as TM
from dla_tpu_torch.validate import residual_potrf
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

GATE = 1e-10


def _a(n, seed):
    return np.asarray(jax_plgsy(n, seed=seed, dtype=jnp.float64))


def _mesh(ndev):
    return TPAR.make_flat_mesh(ndev, device="cpu")


def _res(a, l):
    return float(residual_potrf(torch.tensor(a), torch.tensor(np.asarray(l)),
                                assume_symmetric=True))


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


# ---- the mesh ---------------------------------------------------------------------------

def test_mesh_members_on_the_cpu_when_asked():
    mesh = _mesh(4)
    assert mesh.size == 4 and mesh.axis_names == ("d",)
    assert mesh.devices == (torch.device("cpu"),) * 4


def test_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in TPAR.make_flat_mesh(4).devices)
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            TPAR.make_flat_mesh(4)


def test_mesh_across_devices_raises():
    """Members lie all on the CPU or all on CUDA cards: a CPU + meta mesh
    raises (the device-type rule)."""
    with pytest.raises(ValueError, match="all on the CPU or all on CUDA cards"):
        TPAR.FlatMesh((torch.device("cpu"), torch.device("meta")))


def _pretend_cards(monkeypatch, count, peer=lambda a, b: True):
    """``count`` visible cards, pairs reaching each other as ``peer`` says;
    nothing is allocated on them."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(TPAR.member_comm, "_peer_access", peer)


@pytest.mark.parametrize("count", [1, 2, 3, 4])
@pytest.mark.parametrize("ndev", [4, 8])
def test_flat_mesh_spreads_over_the_cards(monkeypatch, ndev, count):
    """With neither devices= nor device=, k cards, k the largest divisor of
    the member count at most the card count, member m on card m // (D/k):
    contiguous in member order."""
    _pretend_cards(monkeypatch, count)
    mesh = TPAR.make_flat_mesh(ndev)
    k = {1: 1, 2: 2, 3: 2, 4: 4}[count]
    assert mesh.devices == tuple(torch.device("cuda", m // (ndev // k)) for m in range(ndev))
    assert mesh.device == torch.device("cuda", 0) and mesh.device_of(ndev - 1).index == k - 1
    assert mesh.cards == [torch.device("cuda", i) for i in range(k)]


def test_flat_mesh_devices_and_device(monkeypatch):
    """JAX's devices= (one per member, in member order), one device= for all,
    never both."""
    _pretend_cards(monkeypatch, 4)
    cards = [f"cuda:{i}" for i in (3, 1, 2, 0)]
    assert TPAR.make_flat_mesh(4, devices=cards).devices == tuple(map(torch.device, cards))
    assert TPAR.make_flat_mesh(4, device="cuda:2").devices == (torch.device("cuda", 2),) * 4
    with pytest.raises(ValueError, match="not both"):
        TPAR.make_flat_mesh(4, devices=cards, device="cpu")
    with pytest.raises(ValueError, match="4 members need 4 devices"):
        TPAR.make_flat_mesh(4, devices=cards[:3])
    with pytest.raises(ValueError, match="all on the CPU or all on CUDA cards"):
        TPAR.make_flat_mesh(2, devices=["cpu", "cuda:1"])


def test_mesh_without_peer_access_raises_naming_the_pair(monkeypatch):
    """A spread mesh whose cards 1 and 2 cannot reach each other raises; no
    staging through the host, no falling back to one card."""
    _pretend_cards(monkeypatch, 4, peer=lambda a, b: {a, b} != {1, 2})
    with pytest.raises(RuntimeError, match="cards 1 and 2"):
        TPAR.make_flat_mesh(4)
    assert TPAR.make_flat_mesh(2).devices == (torch.device("cuda", 0), torch.device("cuda", 1))


def test_planes_need_a_flat_mesh():
    mesh = TPAR.FlatMesh((torch.device("cpu"),) * 4, axis_names=("r", "c"))
    x = [torch.zeros(64, 16) for _ in range(4)]
    with pytest.raises(ValueError, match="flat 1-D mesh"):
        TPAR.potrf_column_cyclic_ring(x, 16, mesh)


# ---- layouts -----------------------------------------------------------------------------

@pytest.mark.parametrize("n,nb,ndev", [(64, 8, 4), (128, 16, 8)])
def test_dense_cols_layout_same_bits_as_jax(n, nb, ndev):
    a = np.random.default_rng(n).standard_normal((n, n))
    jx = JPAR.from_dense_cols(jnp.asarray(a), nb, JPAR.make_flat_mesh(ndev))
    shards = TPAR.from_dense_cols(a, nb, _mesh(ndev))
    assert len(shards) == ndev and all(s.shape == (n, n // ndev) for s in shards)
    np.testing.assert_array_equal(torch.cat(shards, dim=1).numpy(), np.asarray(jx))
    np.testing.assert_array_equal(TPAR.to_dense_cols(shards, nb, _mesh(ndev)).numpy(),
                                  JPAR.to_dense_cols(jx, nb, JPAR.make_flat_mesh(ndev)))


@pytest.mark.parametrize("n,nb,ndev", [(256, 16, 4), (256, 32, 8)])
def test_packed_layout_same_bits_as_jax(n, nb, ndev):
    a = np.tril(_a(n, 3))
    jx = JPAR.pack_cols_packed(a, nb, JPAR.make_flat_mesh(ndev))
    shards = TPAR.pack_cols_packed(a, nb, _mesh(ndev))
    assert len(shards) == ndev
    np.testing.assert_array_equal(torch.cat(shards, dim=0).numpy(), np.asarray(jx))
    back = TPAR.unpack_cols_packed(shards, n, nb, _mesh(ndev)).numpy()
    np.testing.assert_array_equal(back, JPAR.unpack_cols_packed(jx, n, nb,
                                                                 JPAR.make_flat_mesh(ndev)))
    np.testing.assert_array_equal(back, a)


# ---- the three planes against JAX ------------------------------------------------------

PLANES = [(256, 16, 4), (128, 16, 8)]


def _jax_column(n, nb, ndev, seed):
    mesh = JPAR.make_flat_mesh(ndev)
    lx = JPAR.potrf_column_cyclic_ring(JPAR.from_dense_cols(jnp.asarray(_a(n, seed)), nb, mesh),
                                       nb, mesh)
    return np.tril(JPAR.to_dense_cols(lx, nb, mesh))


def _jax_packed(n, nb, ndev, seed):
    mesh = JPAR.make_flat_mesh(ndev)
    lx = JPAR.potrf_packed_cyclic(JPAR.pack_cols_packed(_a(n, seed), nb, mesh), n, nb, mesh)
    return JPAR.unpack_cols_packed(lx, n, nb, mesh)


def _jax_df64(n, nb, ndev, seed):
    mesh = JPAR.make_flat_mesh(ndev)
    ah, al = jax_to_df64(_a(n, seed))
    lh, ll = JPAR.potrf_packed_cyclic_df64(JPAR.pack_cols_packed(np.asarray(ah), nb, mesh),
                                           JPAR.pack_cols_packed(np.asarray(al), nb, mesh),
                                           n, nb, mesh)
    return (np.asarray(JPAR.unpack_cols_packed(lh, n, nb, mesh), np.float64)
            + np.asarray(JPAR.unpack_cols_packed(ll, n, nb, mesh), np.float64))


def _counting(monkeypatch):
    calls = []
    real = TCC.ring_broadcast

    def count(xs, root, **kw):
        calls.append(xs[root].numel())
        return real(xs, root, **kw)

    monkeypatch.setattr(TCC, "ring_broadcast", count)
    return calls


@pytest.mark.parametrize("n,nb,ndev", PLANES)
def test_column_cyclic_matches_jax(monkeypatch, n, nb, ndev):
    calls = _counting(monkeypatch)
    a = _a(n, 7)
    mesh = _mesh(ndev)
    shards = TPAR.from_dense_cols(a, nb, mesh)
    lx = TPAR.potrf_column_cyclic_ring(shards, nb, mesh)
    assert all(s is t for s, t in zip(lx, shards))  # in place
    assert len(calls) == 2 * (n // nb) - 1
    l = torch.tril(TPAR.to_dense_cols(lx, nb, mesh)).numpy()
    want = _jax_column(n, nb, ndev, 7)
    _close(l, want, 1e-12)
    assert _res(a, l) < GATE and _res(a, want) < GATE


@pytest.mark.parametrize("n,nb,ndev", PLANES)
def test_packed_cyclic_matches_jax(monkeypatch, n, nb, ndev):
    calls = _counting(monkeypatch)
    a = _a(n, 3)
    mesh = _mesh(ndev)
    lx = TPAR.potrf_packed_cyclic(TPAR.pack_cols_packed(a, nb, mesh), n, nb, mesh)
    assert len(calls) == 2 * (n // nb) - 1
    l = TPAR.unpack_cols_packed(lx, n, nb, mesh).numpy()
    want = _jax_packed(n, nb, ndev, 3)
    _close(l, want, 1e-12)
    assert _res(a, l) < GATE and _res(a, want) < GATE


def test_packed_cyclic_df64_matches_jax_both_slice_modes():
    n, nb, ndev = 128, 16, 4
    a = _a(n, 17)
    mesh = _mesh(ndev)
    from dla_tpu_torch.ops.df64 import to_df64

    ah, al = to_df64(a, device="cpu")
    out = {}
    for reuse in (True, False):
        out[reuse] = TPAR.potrf_packed_cyclic_df64(
            TPAR.pack_cols_packed(ah, nb, mesh), TPAR.pack_cols_packed(al, nb, mesh), n, nb,
            mesh, slice_reuse=reuse)
    for p, q in zip(out[True][0] + out[True][1], out[False][0] + out[False][1]):
        assert torch.equal(p.view(torch.int32), q.view(torch.int32))
    lh, ll = out[True]
    l = (TPAR.unpack_cols_packed(lh, n, nb, mesh).double()
         + TPAR.unpack_cols_packed(ll, n, nb, mesh).double()).numpy()
    want = _jax_df64(n, nb, ndev, 17)
    _close(l, want, 1e-11)
    assert _res(a, l) < GATE and _res(a, want) < GATE


def test_planes_check_geometry():
    mesh = _mesh(8)
    with pytest.raises(ValueError, match="multiple of mesh"):
        TPAR.potrf_packed_cyclic([torch.zeros(8, 64)] * 8, 256, 64, mesh)  # nt=4
    with pytest.raises(ValueError, match="pack_cols_packed"):
        TPAR.potrf_packed_cyclic([torch.zeros(8, 16)] * 8, 256, 16, mesh)
    with pytest.raises(ValueError, match="pack_cols_packed"):
        z = [torch.zeros(8, 16)] * 8
        TPAR.potrf_packed_cyclic_df64(z, z, 256, 16, mesh)
    with pytest.raises(ValueError, match="multiple of nb"):
        TPAR.potrf_column_cyclic_ring([torch.zeros(100, 25)] * 4, 16, _mesh(4))


def test_one_slab_per_member_keeps_the_identity():
    """ltc = 1 (one slab per member), as tests/test_packed_cyclic.py checks."""
    mesh = _mesh(8)
    eye = np.eye(256)
    l = TPAR.unpack_cols_packed(
        TPAR.potrf_packed_cyclic(TPAR.pack_cols_packed(eye, 32, mesh), 256, 32, mesh),
        256, 32, mesh)
    np.testing.assert_array_equal(l.numpy(), eye)
    z = TPAR.pack_cols_packed(eye.astype(np.float32), 32, mesh)
    lh, ll = TPAR.potrf_packed_cyclic_df64(z, [torch.zeros_like(t) for t in z], 256, 32, mesh)
    np.testing.assert_allclose(TPAR.unpack_cols_packed(lh, 256, 32, mesh).double()
                               + TPAR.unpack_cols_packed(ll, 256, 32, mesh).double(), eye,
                               atol=1e-12)


# ---- accounting -------------------------------------------------------------------------

@pytest.mark.parametrize("n,nb,ndev", [(384, 16, 4), (4096, 64, 8), (16384, 1024, 4)])
def test_accounting_is_jax_copy(n, nb, ndev):
    assert TM.packed_cyclic_accounting(n, nb, ndev) == JM.packed_cyclic_accounting(n, nb, ndev)
    assert TM.packed_resident_bytes(n, nb, ndev) == JM.packed_resident_bytes(n, nb, ndev)
    assert TM.packed_resident_bytes(n, nb, ndev, 8) == JM.packed_resident_bytes(n, nb, ndev, 8)
    assert TPAR.resident_elems(n, nb, ndev) == JPAR.resident_elems(n, nb, ndev)


def test_accounting_rejects_bad_geometry():
    with pytest.raises(ValueError, match="ndev | nt"):
        TM.packed_cyclic_accounting(256, 64, 8)


def test_ring_broadcast_volumes_match_accounting(monkeypatch):
    """The accounting's comm term against the real program's ring_broadcast
    blocks, as tests/test_packed_cyclic.py pins JAX's."""
    n, nb, ndev = 384, 16, 4
    calls = []

    def recorder(xs, root, **kw):
        calls.append(int(xs[root].numel()))
        return [xs[root].clone() for _ in xs]

    monkeypatch.setattr(TCC, "ring_broadcast", recorder)
    mesh = _mesh(ndev)
    TPAR.potrf_packed_cyclic(TPAR.pack_cols_packed(_a(n, 11), nb, mesh), n, nb, mesh)
    expected = []
    for s in TM.packed_cyclic_accounting(n, nb, ndev)["steps"]:
        expected.append(nb * nb)
        if s["bcast_elems"] - nb * nb:
            expected.append(s["bcast_elems"] - nb * nb)
    assert calls == expected


# ---- the dry run ------------------------------------------------------------------------

def test_dryrun_on_the_cpu(capsys):
    """All six planes, in the JAX function's order: 1 and 4 on the 2x2
    member mesh, the ring planes 2, 3, 6 and the serving plane 5 on 1x4."""
    before = TC.ring_broadcast_launches
    assert dryrun.main(["--ndev", "4", "--device", "cpu", "--n", "128", "--nb", "16"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6
    assert [x.split(" (")[0] for x in lines] == [
        "dryrun OK: mesh 2x2 on cpu", "dryrun OK: mesh 1x4 on cpu", "dryrun OK: mesh 1x4 on cpu",
        "dryrun OK: mesh 2x2 on cpu", "dryrun OK: mesh 1x4 on cpu", "dryrun OK: mesh 1x4 on cpu"]
    assert "block-cyclic" in lines[0] and "POTRS" in lines[3] and "serving" in lines[4]
    assert all("(fp64 gate 1e-10)" in x for x in lines)
    assert TC.ring_broadcast_launches == before  # the plain ring on the CPU


def test_dryrun_gate_fails_loudly(monkeypatch):
    monkeypatch.setattr(dryrun, "GATE", 0.0)
    with pytest.raises(RuntimeError, match="not below the fp64 gate"):
        dryrun.run_plane("column", 64, 8, _mesh(4))
