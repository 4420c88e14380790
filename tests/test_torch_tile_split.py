"""The split scratch that the task kernels #6 ``trsm_tile`` and #8
``gemm_tile`` read on the tensor-core body, the table that picks their body,
and a torch model of that body's arithmetic, held against the JAX reference.

On a CUDA tensor trsm and gemm at fp32 ``high``/``default`` and bf16 storage
run the trailing kernels' tensor-core pipeline with two operands: a split
kernel writes A's bf16 planes and then B's into one scratch
(``csrc/trailing_wgmma.cuh``), whose bits ``tiles.split_pair_plain`` gives in
torch ops (the card tests hold the kernel to it). Here it is held to the
``ahi``/``alo`` of the reference's ``_dot_nt``
(``dla_tpu/kernels/pallas_tiles.py:68-88``), bit for bit, on seeded numpy
input with bf16 rounding ties and subnormals; XLA on the CPU flushes
subnormals, so those elements of lo may differ, and there the port's lo is
below the smallest normal fp32 (as in tests/test_torch_trailing_split.py).

The model sums what the body sums: fp32 products of the planes over chunks of
256 columns of k (one promotion of ``wgmma``'s accumulator), each chunk's
partial sum added into a running fp32 sum, plus (at ``high``) the cross terms
hi·loᵀ + lo·hiᵀ over all of k. It must agree with the plain versions and with
JAX's kernels (interpret mode) within the card tests' tolerance, 1e-5 of
max|aᵢ|·max|bⱼ| for fp32 (bf16 storage: 2^-6 of max|c| + that).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dla_tpu.kernels import pallas_tiles as JK
from dla_tpu.utils import precision as jprec
from dla_tpu_torch.kernels import tiles
from dla_tpu_torch.kernels.tiles import (
    split_pair_plain,
    split_plain,
    tile_op_body,
    tile_op_planes,
)
from dla_tpu_torch.utils import precision as tprec
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from test_torch_trailing_split import TINY, _bits, _jax_planes, _panel

PROMOTE = 256  # columns of k per promotion: kPromote (4) stages of kBK (64)


def _pad(x, mult):
    return -(-x // mult) * mult


def _planes_u16(s):
    return s.view(torch.int16).numpy().view(np.uint16)


def _check_lo(lo, ref_lo):
    """lo planes: the reference's bits, except where XLA flushed a subnormal."""
    differ = lo != _bits(ref_lo)
    assert not (differ & (_bits(ref_lo) & 0x7FFF != 0)).any()
    assert (np.abs(lo.view(ml_dtypes.bfloat16).astype(np.float32)[differ]) < TINY).all()
    return differ.any()


@pytest.mark.parametrize("m,n,k", [(200, 96, 72), (96, 200, 100), (128, 128, 64), (37, 5, 7)])
@pytest.mark.parametrize("special", [False, True])
def test_split_pair_bits_of_jax(m, n, k, special):
    a = _panel(m, k, seed=m * 1000 + k, special=special)
    b = _panel(n, k, seed=n * 1000 + k + 1, special=special)
    got = _planes_u16(split_pair_plain(torch.from_numpy(a), torch.from_numpy(b), 2))
    mpad, npad, kpad = _pad(m, 128), _pad(n, 128), max(64, _pad(k, 64))
    assert got.shape == (2 * (mpad + npad), kpad)
    flushed = False
    for x, rows, origin in ((a, mpad, 0), (b, npad, 2 * mpad)):  # B's planes after A's
        r = x.shape[0]
        hi, lo = _jax_planes(x)
        assert np.array_equal(got[origin : origin + r, :k], _bits(hi))
        flushed |= _check_lo(got[origin + rows : origin + rows + r, :k], lo)
        for pl in range(2):
            block = got[origin + pl * rows : origin + (pl + 1) * rows]
            assert not block[r:].any() and not block[:, k:].any(), "padding must be +0"
    assert flushed == special  # the special values do meet the flush


@pytest.mark.parametrize("planes", [1, 2])
def test_split_pair_layout(planes):
    # A's planes first (planes × mpad rows), then B's from row planes·mpad; each is split_plain
    a = torch.from_numpy(_panel(200, 72, seed=1, special=True))
    b = torch.from_numpy(_panel(96, 72, seed=2, special=True))
    got = split_pair_plain(a, b, planes)
    assert got.shape == (planes * (256 + 128), 128) and got.dtype == torch.bfloat16
    sa, sb = split_plain(a, planes), split_plain(b, planes)
    assert torch.equal(got[: planes * 256].view(torch.int16),
                       sa.reshape(-1, 128).view(torch.int16))
    assert torch.equal(got[planes * 256 :].view(torch.int16),
                       sb.reshape(-1, 128).view(torch.int16))


def test_split_pair_k_zero_is_one_stage_of_zeros():
    # k = 0: kpad is still one 64-column stage (a full TMA box), all +0
    a, b = torch.zeros(200, 0), torch.zeros(96, 0)
    for planes in (1, 2):
        got = split_pair_plain(a, b, planes)
        assert got.shape == (planes * 384, 64)
        assert not got.view(torch.int16).any()
    assert tiles._pair_shape(200, 96, 0, 2) == (768, 64)
    assert tiles._pair_shape(200, 96, 65, 1) == (384, 128)


def test_split_pair_of_strided_views():
    # the tile-task path's operands are views of a wide matrix
    big = torch.from_numpy(_panel(96, 512, seed=11, special=True))
    a, b = big[:, 8:80], big[:40, 300:372]
    assert a.stride(0) == 512 and b.stride(0) == 512
    for planes in (1, 2):
        assert torch.equal(split_pair_plain(a, b, planes).view(torch.int16),
                           split_pair_plain(a.contiguous(), b.contiguous(),
                                            planes).view(torch.int16))


def test_split_pair_of_bf16_storage_is_a_copy():
    a = torch.from_numpy(_panel(96, 40, seed=9, special=False)).to(torch.bfloat16)
    b = torch.from_numpy(_panel(64, 40, seed=10, special=False)).to(torch.bfloat16)
    got = split_pair_plain(a, b, 1)
    assert torch.equal(got[:96, :40].view(torch.int16), a.view(torch.int16))
    assert torch.equal(got[128:192, :40].view(torch.int16), b.view(torch.int16))


DISPATCH = [  # (dtype, tier, planes of trsm and gemm); syrk is always 0
    (torch.float32, "high", 2),
    (torch.float32, "default", 1),
    (torch.float32, "highest", 0),
    (torch.bfloat16, "high", 1),
    (torch.bfloat16, "default", 1),
    (torch.bfloat16, "highest", 1),
    (torch.float64, "high", 0),
    (torch.float64, "default", 0),
    (torch.float64, "highest", 0),
]


@pytest.mark.parametrize("dtype,tier_name,planes", DISPATCH)
@pytest.mark.parametrize("op", ["trsm", "syrk", "gemm"])
def test_tile_op_dispatch_table(op, dtype, tier_name, planes):
    want = 0 if op == "syrk" else planes
    assert tile_op_planes(op, dtype, tier_name) == want
    assert tile_op_body(op, dtype, tier_name) == ("wgmma" if want else "scalar")


def test_cpu_route_allocates_no_scratch(monkeypatch):
    # on the CPU the wrappers run the plain versions and never build the split scratch
    def boom(*a, **k):
        raise AssertionError("the CPU route built the split scratch")

    monkeypatch.setattr(tiles, "_pair_scratch", boom)
    monkeypatch.setattr(tiles, "split_pair_plain", boom)
    monkeypatch.setattr(tiles, "split_plain", boom)
    rng = np.random.default_rng(0)
    c, ai, aj = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((64, 48), (64, 32), (48, 32)))
    linv = torch.tril(torch.from_numpy(rng.standard_normal((48, 48)).astype(np.float32)))
    with tprec.override("high"):
        assert torch.equal(tiles.gemm_tile(c, ai, aj), tiles.gemm_tile_plain(c, ai, aj))
        assert torch.equal(tiles.trsm_tile(linv, c), tiles.trsm_tile_plain(linv, c))


def _body_model(a, b, planes):
    """A·Bᵀ as the tensor-core body sums it, from the split scratch: per
    256-column chunk of k an fp32 product of the hi planes, promoted into an
    fp32 sum; at two planes plus hi·loᵀ + lo·hiᵀ over all of k."""
    m, n = a.shape[0], b.shape[0]
    mpad, npad = _pad(m, 128), _pad(n, 128)
    s = split_pair_plain(a, b, planes).float()
    pa = [s[pl * mpad :][:m] for pl in range(planes)]
    pb = [s[planes * mpad + pl * npad :][:n] for pl in range(planes)]
    total = torch.zeros(m, n)
    for k0 in range(0, s.shape[1], PROMOTE):
        total = total + pa[0][:, k0 : k0 + PROMOTE] @ pb[0][:, k0 : k0 + PROMOTE].mT
    if planes == 2:
        total = total + (pa[0] @ pb[1].mT + pa[1] @ pb[0].mT)
    return total


def _tol(dtype, c, a, b):
    scale = (a.double().norm(dim=1).max() * b.double().norm(dim=1).max()).item()
    cmax = 0.0 if c is None else c.double().abs().max().item()
    return 1e-5 * scale if dtype == torch.float32 else 2**-6 * (cmax + scale)


MODEL_CASES = [(torch.float32, "high"), (torch.float32, "default"), (torch.bfloat16, "high")]


@pytest.mark.parametrize("dtype,prec", MODEL_CASES)
@pytest.mark.parametrize("op", ["trsm", "gemm"])
def test_body_model_matches_plain_and_jax(op, dtype, prec):
    # m=200, n=96, k=600: three promotions (the last one partial), ragged rows and k
    m, n, k = 200, 96, 600
    rng = np.random.default_rng(600 + (op == "gemm"))
    if op == "trsm":  # trsm_tile(linv (n, n), b (m, n)): a = b, b = linv, k = n
        n = k
        c = None
        a_np = rng.standard_normal((m, n)).astype(np.float32)
        b_np = np.tril(rng.standard_normal((n, n))).astype(np.float32)
    else:
        c_np, a_np = (rng.standard_normal(s).astype(np.float32) for s in ((m, n), (m, k)))
        b_np = rng.standard_normal((n, k)).astype(np.float32)
        c = torch.from_numpy(c_np).to(dtype)
    a, b = torch.from_numpy(a_np).to(dtype), torch.from_numpy(b_np).to(dtype)
    prod = _body_model(a, b, tile_op_planes(op, dtype, prec))
    got = prod.to(dtype) if op == "trsm" else tiles._minus(c, prod)
    with tprec.override(prec):
        plain = (tiles.trsm_tile_plain(b, a) if op == "trsm"
                 else tiles.gemm_tile_plain(c, a, b))
    tol = _tol(dtype, c, a, b)
    assert (got.double() - plain.double()).abs().max().item() <= tol
    if prec == "default" and dtype == torch.float32:
        return  # XLA on the CPU ignores default's bf16 operands (tests/test_torch_tiles.py)
    j = lambda t: jnp.asarray(t.float().numpy(), {torch.float32: jnp.float32,  # noqa: E731
                                                  torch.bfloat16: jnp.bfloat16}[dtype])
    with jprec.override(prec):
        ref = (JK.trsm_tile(j(b), j(a)) if op == "trsm" else JK.gemm_tile(j(c), j(a), j(b)))
    ref = np.asarray(ref.astype(jnp.float32), dtype=np.float64)
    assert np.abs(got.double().numpy() - ref).max() <= tol
