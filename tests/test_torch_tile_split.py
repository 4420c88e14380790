"""The split scratch that the task kernels #6 ``trsm_tile``, #7 ``syrk_tile``
and #8 ``gemm_tile`` read on the tensor-core body, the table that picks their
body, syrk's grid of lower tiles, and a torch model of that body's
arithmetic, held against the JAX reference.

On a CUDA tensor the three at fp32 ``high``/``default`` and bf16 storage run
the trailing kernels' tensor-core pipeline with two operands: a split kernel
writes A's bf16 planes and then B's into one scratch (syrk: A's alone, B = A;
``csrc/trailing_wgmma.cuh``), whose bits ``tiles.split_pair_plain`` gives in
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

syrk's grid (``tiles.syrk_tile_grid``, decoded as ``syrk_tile`` of
``csrc/tile_body.cuh`` decodes ``blockIdx.x`` on every body): each element
with r ≥ c is written by exactly one product block, each with r < c by
exactly one copy block or, inside a diagonal tile, by its product block's
mask (a copy of C), for ragged n and at every body's tile edge; and the
update assembled block by block through it agrees with JAX's ``syrk_tile``.
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
    CHAIN_GROUP,
    chain_owners,
    chain_tile_edge,
    chain_tile_grid,
    split_pair_plain,
    split_plain,
    syrk_tile_grid,
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


DISPATCH = [  # (dtype, tier, planes of each operand of trsm, syrk and gemm)
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
    # one table for the three ops; no planes: the chain bodies
    assert tile_op_planes(op, dtype, tier_name) == planes
    chain = "dmma" if dtype == torch.float64 else "simt"
    assert tile_op_body(op, dtype, tier_name) == ("wgmma" if planes else chain)
    assert tile_op_body(op, dtype, tier_name) == tiles.trailing_body(dtype, tier_name)


def test_tile_op_table_refuses_an_unknown_op():
    for fn in (tile_op_planes, tile_op_body):
        with pytest.raises(ValueError, match="potrf"):
            fn("potrf", torch.float32, "high")


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
        assert torch.equal(tiles.syrk_tile(c[:48], aj), tiles.syrk_tile_plain(c[:48], aj))


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
@pytest.mark.parametrize("op", ["trsm", "gemm", "syrk"])
def test_body_model_matches_plain_and_jax(op, dtype, prec):
    # m=200, n=96, k=600: three promotions (the last one partial), ragged rows and k
    m, n, k = 200, 96, 600
    rng = np.random.default_rng(600 + (op == "gemm"))
    if op == "trsm":  # trsm_tile(linv (n, n), b (m, n)): a = b, b = linv, k = n
        n = k
        c = None
        a_np = rng.standard_normal((m, n)).astype(np.float32)
        b_np = np.tril(rng.standard_normal((n, n))).astype(np.float32)
    elif op == "syrk":  # syrk_tile(c (n, n), a (n, k)): b = a, the lower triangle
        m = n = 200
        c_np, a_np = (rng.standard_normal(s).astype(np.float32) for s in ((n, n), (n, k)))
        b_np = a_np
        c = torch.from_numpy(c_np).to(dtype)
    else:
        c_np, a_np = (rng.standard_normal(s).astype(np.float32) for s in ((m, n), (m, k)))
        b_np = rng.standard_normal((n, k)).astype(np.float32)
        c = torch.from_numpy(c_np).to(dtype)
    a, b = torch.from_numpy(a_np).to(dtype), torch.from_numpy(b_np).to(dtype)
    prod = _body_model(a, b, tile_op_planes(op, dtype, prec))
    got = prod.to(dtype) if op == "trsm" else tiles._minus(c, prod)
    if op == "syrk":
        got = torch.where(torch.ones(n, n, dtype=torch.bool).tril(), got, c)
    with tprec.override(prec):
        plain = (tiles.trsm_tile_plain(b, a) if op == "trsm" else
                 tiles.syrk_tile_plain(c, a) if op == "syrk" else tiles.gemm_tile_plain(c, a, b))
    tol = _tol(dtype, c, a, b)
    assert (got.double() - plain.double()).abs().max().item() <= tol
    if prec == "default" and dtype == torch.float32:
        return  # XLA on the CPU ignores default's bf16 operands (tests/test_torch_tiles.py)
    j = lambda t: jnp.asarray(t.float().numpy(), {torch.float32: jnp.float32,  # noqa: E731
                                                  torch.bfloat16: jnp.bfloat16}[dtype])
    with jprec.override(prec):
        ref = (JK.trsm_tile(j(b), j(a)) if op == "trsm" else
               JK.syrk_tile(j(c), j(a)) if op == "syrk" else JK.gemm_tile(j(c), j(a), j(b)))
    ref = np.asarray(ref.astype(jnp.float32), dtype=np.float64)
    assert np.abs(got.double().numpy() - ref).max() <= tol


# ---- syrk's grid: products on the lower tiles, copies above (csrc/tile_body.cuh) -------

SYRK_SIZES = [1, 64, 96, 127, 128, 200, 512, 1000, 1100, 2048]
# (body, tile edge): the chain bodies' thread maps at both edges, and the tensor-core
# body's 128 tile, whose epilogue writes whole columns (modelled as every element)
SYRK_BODIES = [("simt", 128), ("simt", 64), ("dmma", 64), ("wgmma", 128)]


def _owners(body, tile):
    if body == "wgmma":
        r = torch.arange(tile * tile)
        return (r // tile)[None], (r % tile)[None]
    return chain_owners(body, tile)


def _syrk_writes(n, body, tile):
    """(rows, cols, product) of every write of syrk's grid on an (n, n) output:
    a product block writes c − P where r ≥ c and c elsewhere (its mask), a copy
    block writes c; both clip to n."""
    rows, cols = _owners(body, tile)
    grid = syrk_tile_grid(n, tile)
    r0 = torch.tensor([g[0] for g in grid])[:, None, None]
    c0 = torch.tensor([g[1] for g in grid])[:, None, None]
    copy = torch.tensor([g[2] for g in grid])[:, None, None]
    r, c = (r0 + rows[None]).reshape(-1), (c0 + cols[None]).reshape(-1)
    product = (~copy).expand(-1, *rows.shape).reshape(-1)
    keep = (r < n) & (c < n)
    return r[keep], c[keep], product[keep] & (r[keep] >= c[keep])


@pytest.mark.parametrize("body,tile", SYRK_BODIES)
@pytest.mark.parametrize("n", SYRK_SIZES)
def test_syrk_grid_writes_lower_by_products_and_upper_by_copies(n, body, tile):
    r, c, product = _syrk_writes(n, body, tile)
    writes = torch.bincount(r * n + c, minlength=n * n).reshape(n, n)
    products = torch.bincount((r * n + c)[product], minlength=n * n).reshape(n, n)
    lower = torch.ones(n, n, dtype=torch.bool).tril()
    assert torch.equal(writes, torch.ones(n, n, dtype=torch.long))  # every element once
    assert torch.equal(products, lower.long())  # r >= c: by a product, r < c: by a copy
    grid = syrk_tile_grid(n, tile)
    g = -(-n // tile)
    assert len(grid) == g * g  # as many blocks as an n x n gemm: the launch is unchanged
    assert sum(not cp for _, _, cp in grid) == g * (g + 1) // 2
    assert all((r0 >= c0) != cp for r0, c0, cp in grid)  # products on or below the diagonal


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("n", SYRK_SIZES)
def test_syrk_grid_orders_products_as_the_gemm_grid(n, tile):
    # the product blocks come first, in the rectangular grid's grouped column-by-column
    # order restricted to the lower tiles; then the copies, column by column
    grid = syrk_tile_grid(n, tile)
    g = -(-n // tile)
    lower = g * (g + 1) // 2
    want = [(r0, c0) for r0, c0 in chain_tile_grid(n, n, tile) if r0 >= c0]
    assert [(r0, c0) for r0, c0, _ in grid[:lower]] == want
    assert not any(cp for *_, cp in grid[:lower]) and all(cp for *_, cp in grid[lower:])
    upper = [(c0 // tile, r0 // tile) for r0, c0, _ in grid[lower:]]
    assert upper == sorted(upper)
    groups = [r0 // tile // CHAIN_GROUP for r0, _, _ in grid[:lower]]
    assert groups == sorted(groups)


@pytest.mark.parametrize("n,k,body,tile", [(200, 72, "simt", 64), (200, 72, "dmma", 64),
                                           (300, 40, "simt", 128), (96, 1, "wgmma", 128)])
def test_syrk_assembled_through_the_grid_matches_jax(n, k, body, tile):
    # syrk_tile's update written block by block through the grid and the thread map,
    # against the reference's syrk_tile (interpret mode) in fp64; above the diagonal, c's bits
    rng = np.random.default_rng(n + k)
    c, a = rng.standard_normal((n, n)), rng.standard_normal((n, k))
    with jprec.override("highest"):
        ref = np.asarray(JK.syrk_tile(jnp.asarray(c), jnp.asarray(a)))
    r, cc, product = _syrk_writes(n, body, tile)
    ta, tc = torch.from_numpy(a), torch.from_numpy(c)
    got = torch.full((n, n), float("nan"), dtype=torch.float64)
    got[r, cc] = tc[r, cc]
    pr, pc = r[product], cc[product]
    got[pr, pc] = tc[pr, pc] - (ta[pr] * ta[pc]).sum(1)
    scale = np.abs(a).sum(1).max() ** 2
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * scale
    assert np.array_equal(np.triu(got.numpy(), 1), np.triu(c, 1))


@pytest.mark.parametrize("n,aligned,want", [
    (512, True, 64), (2048, True, 64), (2048, False, 128), (4096, True, 128),
    (2816, True, 64), (2944, True, 128),  # 22·23/2 = 253 < 264 <= 276 = 23·24/2
])
def test_syrk_tile_edge_counts_the_lower_tiles(n, aligned, want):
    # simt: 128 where the 128 grid's product blocks (lower tiles only) fill 132 SMs at once
    assert chain_tile_edge(n, n, "simt", sms=132, aligned=aligned, op="syrk") == want
    assert chain_tile_edge(n, n, "dmma", sms=132, aligned=aligned, op="syrk") == 64


@pytest.mark.parametrize("n,k", [(200, 72), (96, 0), (130, 257)])
@pytest.mark.parametrize("planes", [1, 2])
def test_syrk_split_scratch_is_a_alone(n, k, planes):
    # syrk splits A once: A's planes, no B rows, k padded as for the pair
    a = torch.from_numpy(_panel(n, k, seed=n + k, special=False))
    got = split_pair_plain(a, None, planes)
    rows, kpad = tiles._pair_shape(n, 0, k, planes)
    assert got.shape == (rows, kpad) and rows == planes * _pad(n, 128)
    pair = split_pair_plain(a, a, planes)
    assert torch.equal(got.view(torch.int16), pair[:rows].view(torch.int16))
