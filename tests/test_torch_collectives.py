"""dla_tpu_torch's ring collectives held against dla_tpu's on the same numpy
inputs: ``ring_broadcast`` and ``ring_all_gather`` (and their chunk count,
``broadcast_chunks``).

The JAX side runs as its own tests run it (tests/test_parallel.py): the Pallas
ring in interpret mode under ``shard_map`` on the 8 virtual CPU devices of
tests/conftest.py, member d's block on device d. The port's wrappers run their
plain versions here, which simulate the same protocol step by step with
per-member comm slots. Both move bits, so they must agree **bit for bit**.
The CUDA kernel is held against the plain versions on the card in
tests/test_torch_gpu.py.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from dla_tpu.kernels import collectives as JC
from dla_tpu_torch.kernels import collectives as TC
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

DTYPES = {"f32": np.float32, "f64": np.float64}


def _blocks(ndev, m, n, dtype, seed):
    return np.random.default_rng(seed).standard_normal((ndev * m, n)).astype(DTYPES[dtype])


def _jax_ring(fn, x, ndev, out_rows):
    """``fn`` under shard_map on ``ndev`` virtual devices, one block each;
    returns the (ndev, out_rows, n) per-device outputs."""
    mesh = Mesh(np.asarray(jax.devices()[:ndev]), ("d",))
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P("d", None), out_specs=P("d", None),
                              check_vma=False))
    return np.asarray(f(x)).reshape(ndev, out_rows, x.shape[1])


def _members(x, ndev):
    return [torch.from_numpy(b.copy()) for b in np.split(x, ndev)]


BCAST = [  # (ndev, root, chunks, group, dtype)
    (8, 5, None, None, "f64"),
    (8, 5, 1, None, "f32"),
    (8, 5, 4, None, "f64"),
    (8, 5, 16, None, "f32"),
    (4, 3, None, None, "f32"),
    (4, 3, 16, None, "f64"),
    (8, 3, None, 4, "f64"),
    (8, 3, 4, 4, "f32"),
    (8, 1, None, 2, "f32"),
    (4, 1, 16, 2, "f64"),
    (8, 5, 4, 2, "f64"),  # root 5 of a 2-ring: distance taken modulo the group, as in JAX
]


@pytest.mark.parametrize("ndev,root,chunks,group,dtype", BCAST)
def test_ring_broadcast_plain_same_bits_as_jax(ndev, root, chunks, group, dtype):
    m, n = 256, 8
    x = _blocks(ndev, m, n, dtype, seed=ndev + 7 * root + (chunks or 0))
    want = _jax_ring(lambda xl: JC.ring_broadcast(xl, "d", root, group=group, chunks=chunks),
                     x, ndev, m)
    got = TC.ring_broadcast(_members(x, ndev), root, group=group, chunks=chunks)
    assert len(got) == ndev
    g = group or ndev
    blocks = x.reshape(ndev, m, n)
    for d in range(ndev):
        np.testing.assert_array_equal(got[d].numpy(), want[d])
        np.testing.assert_array_equal(want[d], blocks[(d // g) * g + root % g])


GATHER = [(8, None, "f64"), (4, None, "f32"), (8, 4, "f64"), (8, 2, "f32"), (4, 2, "f64")]


@pytest.mark.parametrize("ndev,group,dtype", GATHER)
def test_ring_all_gather_plain_same_bits_as_jax(ndev, group, dtype):
    m, n = 4, 6
    g = group or ndev
    x = _blocks(ndev, m, n, dtype, seed=3 * ndev + g)
    want = _jax_ring(lambda xl: JC.ring_all_gather(xl, "d", group=group), x, ndev, g * m)
    got = TC.ring_all_gather(_members(x, ndev), group=group)
    for d in range(ndev):
        np.testing.assert_array_equal(got[d].numpy(), want[d])
        r = d // g
        np.testing.assert_array_equal(want[d], x[r * g * m : (r + 1) * g * m])


def test_plain_is_the_wrapper_on_the_cpu():
    x = _members(_blocks(4, 32, 5, "f32", seed=1), 4)
    for a, b in zip(TC.ring_broadcast_plain(x, 2, chunks=2), TC.ring_broadcast(x, 2, chunks=2)):
        assert torch.equal(a, b)
    for a, b in zip(TC.ring_all_gather_plain(x, group=2), TC.ring_all_gather(x, group=2)):
        assert torch.equal(a, b)


def test_cpu_calls_launch_nothing():
    before = (TC.ring_broadcast_launches, TC.ring_all_gather_launches)
    x = _members(_blocks(4, 16, 3, "f64", seed=2), 4)
    TC.ring_broadcast(x, 0)
    TC.ring_all_gather(x)
    assert (TC.ring_broadcast_launches, TC.ring_all_gather_launches) == before


def test_outputs_are_new_tensors_and_inputs_unchanged():
    x = _members(_blocks(4, 32, 4, "f32", seed=4), 4)
    kept = [t.clone() for t in x]
    for out in (TC.ring_broadcast(x, 1), TC.ring_all_gather(x)):
        assert all(o.data_ptr() != t.data_ptr() for o in out for t in x)
    assert all(torch.equal(a, b) for a, b in zip(x, kept))


def test_bf16_and_ragged_widths_move_bits():
    rng = np.random.default_rng(9)
    x = [torch.from_numpy(rng.standard_normal((48, 3))).to(torch.bfloat16) for _ in range(4)]
    for out in TC.ring_broadcast(x, 3, chunks=3):
        assert torch.equal(out.view(torch.int16), x[3].view(torch.int16))
    for out in TC.ring_all_gather(x, group=4):
        assert torch.equal(out.view(torch.int16), torch.cat(x).view(torch.int16))


BAD = [
    ("ring_broadcast", dict(root=0), (8, 16, 4, 2), "2-D block"),
    ("ring_broadcast", dict(root=0, group=3), (8, 16, 4), "not a multiple of group"),
    ("ring_broadcast", dict(root=0, chunks=3), (8, 16, 4), "must divide the 16 buffer rows"),
    ("ring_all_gather", dict(), (8, 16, 4, 2), "2-D block"),
    ("ring_all_gather", dict(group=3), (8, 16, 4), "not a multiple of group"),
]


@pytest.mark.parametrize("name,kw,shape,match", BAD)
def test_same_value_errors_as_jax(name, kw, shape, match):
    ndev = shape[0]
    x = np.zeros((shape[0] * shape[1], *shape[2:]), np.float32)
    kw = dict(kw)
    root = kw.pop("root", None)
    jfn = getattr(JC, name)
    args = () if root is None else (root,)
    with pytest.raises(ValueError, match=match):
        _jax_ring(lambda xl: jfn(xl, "d", *args, **kw), x, ndev, shape[1])
    with pytest.raises(ValueError, match=match):
        getattr(TC, name)(_members(x, ndev), *args, **kw)
    with pytest.raises(ValueError, match=match):
        getattr(TC, f"{name}_plain")(_members(x, ndev), *args, **kw)


def test_members_must_agree_and_lie_on_one_device():
    x = [torch.zeros(16, 4), torch.zeros(16, 4), torch.zeros(16, 5), torch.zeros(16, 4)]
    with pytest.raises(ValueError, match="one shape and dtype"):
        TC.ring_broadcast(x, 0)
    x = [torch.zeros(16, 4), torch.zeros(16, 4, device="meta")]
    with pytest.raises(ValueError, match="all on the CPU or all on CUDA cards"):
        TC.ring_all_gather(x)


@pytest.mark.parametrize("group", [1, 2, 3, 4, 5, 8, 16, 17])
def test_broadcast_chunks_is_jax_copy(group):
    for m in list(range(0, 1024, 8)) + [15360, 14336, 12288, 4096, 12000, 736, 2 * 15360]:
        assert TC.broadcast_chunks(m, group) == JC.broadcast_chunks(m, group), (m, group)


def test_broadcast_chunks_at_the_planes_shapes():
    assert TC.broadcast_chunks(15360, 4) == 48  # the largest panel of N=16384, nb=1024
    assert TC.broadcast_chunks(1024, 4) == 32  # the factor tile
    assert TC.broadcast_chunks(2048, 4) == 32  # the df64 factor pair (hi over lo)
