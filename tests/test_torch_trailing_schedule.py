"""The schedule of the trailing kernels' FMA-chain bodies, modelled in torch.

On a CUDA tensor the trailing kernels (#1 ``trailing_update_lower``, #2
``trailing_update_packed``) run fp32 ``highest`` on the SIMT body and fp64 on
the DMMA body of ``csrc/trailing_chain.cuh``. Both launch one block per
128×128 output tile that holds an element of a lower tile pair, in groups of
8 block rows walked column by column (``tiles.chain_grid`` decodes the block
index as the kernel does), and keep one fma chain per output in ascending k.
Here, without the card:

- the grid launches every needed tile once and no tile that lies wholly above
  the tb-diagonal, in the grouped order, at tb 32, 96, 128 and 1024, dense
  windows from origin 0 and > 0, ragged windows and packed steps;
- every element of the lower tile pairs is written exactly once, through the
  dense and the packed address maps (``DenseWindow``, ``PackedWindow``), and
  no other element of the buffer is touched, by each body's thread map
  (``tiles.chain_owners``);
- the slabs' loads and the fragment reads, modelled index for index, give
  each output its k-steps in ascending order over 16-column slabs, each k
  once, with no split, the zero padding of nt_block included;
- the whole update assembled block by block from that schedule agrees with
  the reference's Pallas kernels (interpret mode) in fp64.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dla_tpu.kernels.pallas_tiles import trailing_update_lower as jax_trailing
from dla_tpu.kernels.pallas_tiles import trailing_update_packed as jax_trailing_packed
from dla_tpu_torch.algos.packed import packed_rows
from dla_tpu_torch.kernels import _build, tiles
from dla_tpu_torch.kernels.tiles import (
    CHAIN_GROUP, CHAIN_K, CHAIN_TILE, chain_grid, chain_owners, chain_row_blocks)
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BODIES = ["simt", "dmma"]


def _needed(w, tb):
    """(row tile, column tile) pairs of the 128-grid holding an element with
    r // tb >= c // tb, by brute force over the window's tile corners."""
    g = -(-w // CHAIN_TILE)
    bi = torch.arange(g)
    last_row = torch.clamp(bi * CHAIN_TILE + CHAIN_TILE - 1, max=w - 1)
    first_col = bi * CHAIN_TILE
    need = (last_row[:, None] // tb) >= (first_col[None, :] // tb)
    return {(int(r), int(c)) for r, c in need.nonzero().tolist()}


GRID_CASES = [  # (w, tb): dense windows m - origin*tb, packed windows n - (k+1)*w
    (96, 32), (320, 32), (288, 96), (960, 96), (384, 128), (1280, 128),
    (1024, 1024), (3072, 1024), (8192, 1024), (16384, 1024), (77824, 1024),
    (200, 40), (1000, 8), (130, 65),
]


@pytest.mark.parametrize("w,tb", GRID_CASES)
def test_grid_launches_each_needed_tile_once(w, tb):
    grid = chain_grid(w, tb)
    got = [(r // CHAIN_TILE, c // CHAIN_TILE) for r, c in grid]
    assert len(set(got)) == len(got)  # no tile twice
    assert set(got) == _needed(w, tb)  # every tile with a lower element, no other
    g = -(-w // CHAIN_TILE)
    assert len(got) == sum(chain_row_blocks(bi, w, tb) for bi in range(g))
    # a block row reaches at least its diagonal tile
    assert all(chain_row_blocks(bi, w, tb) >= bi + 1 for bi in range(g))


@pytest.mark.parametrize("w,tb", GRID_CASES)
def test_grid_is_grouped_and_walks_columns(w, tb):
    got = [(r // CHAIN_TILE, c // CHAIN_TILE) for r, c in chain_grid(w, tb)]
    groups = [bi // CHAIN_GROUP for bi, _ in got]
    assert groups == sorted(groups)  # group by group
    for G in set(groups):
        inside = [(bj, bi) for bi, bj in got if bi // CHAIN_GROUP == G]
        assert inside == sorted(inside)  # column by column, rows ascending
        # each column's rows are a suffix of the group's rows
        rows = sorted({bi for _, bi in inside})
        for bj in {bj for bj, _ in inside}:
            col = [bi for c, bi in inside if c == bj]
            assert col == rows[len(rows) - len(col):]


def test_grid_refuses_more_groups_than_the_kernel_takes():
    w = tiles.CHAIN_MAX_GROUPS * CHAIN_GROUP * CHAIN_TILE + 1
    with pytest.raises(ValueError, match="block groups"):
        chain_grid(w, w)


def test_header_constants_match():
    src = (_build.CSRC / "trailing_chain.cuh").read_text()
    const = {m[1]: int(m[2]) for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert (const["kTile"], const["kGroup"], const["kMaxGroups"], const["kK"]) == (
        CHAIN_TILE, CHAIN_GROUP, tiles.CHAIN_MAX_GROUPS, CHAIN_K)
    assert const["kSimtThreads"] == 256
    assert (const["kDWarpsM"], const["kDWarpsN"]) == tiles.CHAIN_DMMA_WARPS


@pytest.mark.parametrize("body", BODIES)
def test_owners_cover_the_tile_once(body):
    rows, cols = chain_owners(body)
    flat = (rows * CHAIN_TILE + cols).reshape(-1)
    assert torch.equal(torch.sort(flat).values, torch.arange(CHAIN_TILE * CHAIN_TILE))


def _writes(body, w, tb):
    """Window coordinates (r, c) of every store of every block and thread,
    after the epilogue's mask (r, c < w and r >= (c // tb) * tb)."""
    rows, cols = chain_owners(body)
    grid = torch.tensor(chain_grid(w, tb))
    r = (grid[:, 0, None, None] + rows[None]).reshape(-1)
    c = (grid[:, 1, None, None] + cols[None]).reshape(-1)
    keep = (r < w) & (c < w)
    r, c = r[keep], c[keep]
    keep = r >= c // tb * tb
    return r[keep], c[keep]


def _dense_offsets(r, c, off, ldc):
    """DenseWindow: (off + r) * ldc + (off + c)."""
    return (off + r) * ldc + (off + c)


def _packed_offsets(r, c, n, w, base):
    """PackedWindow.row(r) + PackedWindow.col(c) (csrc/packed_window.cuh)."""
    nt = n // w
    cc = base + c
    j = cc // w
    return (base + r) * w + (w * (j * nt - j * (j - 1) // 2) - j * w) * w + (cc - j * w)


def _lower_mask(m, tb, origin):
    ti = torch.arange(m) // tb
    return (ti[:, None] >= ti[None, :]) & (ti[:, None] >= origin) & (ti[None, :] >= origin)


def _packed_visited(n, w, ktb, k):
    """True on the packed elements the step-k update must touch."""
    nt, base = n // w, (k + 1) * w
    parts = []
    for j in range(nt):
        r = torch.arange(j * w, n) - base
        c = torch.arange(j * w, (j + 1) * w) - base
        parts.append((r[:, None] >= 0) & (c[None, :] >= 0)
                     & (r.clamp(min=0)[:, None] // ktb >= c.clamp(min=0)[None, :] // ktb))
    return torch.cat(parts)


DENSE_CASES = [  # (m, tb, origin, ldc pad)
    (96, 32, 0, 0), (96, 32, 1, 0), (320, 32, 2, 16), (288, 96, 0, 0), (480, 96, 2, 3),
    (384, 128, 1, 0), (1024, 1024, 0, 0), (2048, 1024, 1, 0), (200, 40, 1, 5),
]


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("m,tb,origin,pad", DENSE_CASES)
def test_dense_lower_tiles_written_exactly_once(body, m, tb, origin, pad):
    w, ldc = m - origin * tb, m + pad  # ldc > m: c a view of a wider matrix
    r, c = _writes(body, w, tb)
    count = torch.bincount(_dense_offsets(r, c, origin * tb, ldc), minlength=m * ldc)
    want = torch.zeros(m, ldc, dtype=torch.long)
    want[:, :m] = _lower_mask(m, tb, origin)
    assert torch.equal(count, want.reshape(-1))


PACKED_CASES = [  # (n, w, ktb, k): window n - (k+1)*w, slabs straddled by 128-row tiles
    (384, 96, 32, 0), (384, 96, 32, 1), (640, 160, 40, 1), (768, 256, 128, 0),
    (2048, 512, 256, 1), (600, 200, 40, 1), (576, 192, 96, 1), (4096, 1024, 1024, 0),
    (4096, 1024, 512, 2),
]


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("n,w,ktb,k", PACKED_CASES)
def test_packed_lower_tiles_written_exactly_once(body, n, w, ktb, k):
    base = (k + 1) * w
    r, c = _writes(body, n - base, ktb)
    count = torch.bincount(_packed_offsets(r, c, n, w, base), minlength=packed_rows(n, w) * w)
    assert count.numel() == packed_rows(n, w) * w  # nothing past the buffer
    assert torch.equal(count, _packed_visited(n, w, ktb, k).long().reshape(-1))


# ---- the k-loop: the slabs' loads and the fragment reads, index for index ------------

def _simt_slab(row0, col0, k0, w, nb):
    """The SIMT body's two [k][row] slabs after fetch + stash: each entry the
    (row, k) id of the P element it holds, -1 for a zero (past w or nb)."""
    sa = torch.full((CHAIN_K, CHAIN_TILE + 4), -2, dtype=torch.long)
    sb = sa.clone()
    for t in range(256):
        for e in range(2):
            c = t + 256 * e
            k = k0 + 4 * (c % 4)
            for x in range(4):
                for slab, r0 in ((sa, row0), (sb, col0)):
                    row = r0 + c // 4
                    ok = row < w and k + x < nb
                    slab[4 * (c % 4) + x, c // 4] = row * 10**6 + k + x if ok else -1
    return sa, sb


def _id(row, k, w, nb):
    return row * 10**6 + k if row < w and k < nb else -1


@pytest.mark.parametrize("w,nb", [(300, 40), (128, 16), (200, 7)])
def test_simt_reads_each_k_in_order_from_its_slab(w, nb):
    row0, col0 = 128, 0
    for ks in range(-(-nb // CHAIN_K)):
        sa, sb = _simt_slab(row0, col0, ks * CHAIN_K, w, nb)
        assert (sa[:, :CHAIN_TILE] != -2).all() and (sb[:, :CHAIN_TILE] != -2).all()
        for t in range(0, 256, 7):
            ty, tx = t // 16, t % 16
            for kk in range(CHAIN_K):  # the kk-th fma of thread t's chains in this slab
                k = ks * CHAIN_K + kk
                x = torch.cat([sa[kk, ty * 4:ty * 4 + 4], sa[kk, 64 + ty * 4:64 + ty * 4 + 4]])
                y = torch.cat([sb[kk, tx * 4:tx * 4 + 4], sb[kk, 64 + tx * 4:64 + tx * 4 + 4]])
                rows, cols = chain_owners("simt")
                want_r = [_id(row0 + int(rows[t, 8 * i]), k, w, nb) for i in range(8)]
                want_c = [_id(col0 + int(cols[t, j]), k, w, nb) for j in range(8)]
                assert x.tolist() == want_r and y.tolist() == want_c


WM, WN = tiles.CHAIN_DMMA_WARPS
DMMA_THREADS = 32 * WM * WN
MI, NI = CHAIN_TILE // 16 // WM, CHAIN_TILE // 8 // WN  # fragments a warp


def _dmma_slab(row0, col0, k0, w, nb, vec):
    """One slot of the DMMA body's ring after the cp.async copies of ``load``:
    256 rows (the row block, then the column block) of 16 + 4 doubles, each
    entry the (row, k) id it holds, -1 for a zero-filled one."""
    ld = CHAIN_K + 4
    slab = torch.full((2 * CHAIN_TILE, ld), -2, dtype=torch.long)
    per = 2 if vec else 1
    for t in range(DMMA_THREADS):
        for e in range(2 * CHAIN_TILE * CHAIN_K // per // DMMA_THREADS):
            c = t + DMMA_THREADS * e
            row = c // (CHAIN_K // per)
            kc = c % (CHAIN_K // per) * per
            src_row = (row0 if row < CHAIN_TILE else col0 - CHAIN_TILE) + row
            for x in range(per):  # bytes past the source's valid ones are zero-filled
                k = k0 + kc + x
                slab[row, kc + x] = src_row * 10**6 + k if src_row < w and k < nb else -1
    return slab


@pytest.mark.parametrize("mma_k", [4, 8, 16])
@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("w,nb", [(300, 40), (200, 7)])
def test_dmma_instructions_take_k_in_order(mma_k, vec, w, nb):
    row0, col0 = 128, 0
    seen = []  # the k range of each instruction applied to fragment (mi, ni) = (0, 0)
    for kt in range(-(-nb // CHAIN_K)):
        slab = _dmma_slab(row0, col0, kt * CHAIN_K, w, nb, vec)
        assert (slab[:, :CHAIN_K] != -2).all()
        ld = CHAIN_K + 4
        for warp in range(WM * WN):
            wm, wn = warp % WM, warp // WM
            sa = slab[wm * 16 * MI:].reshape(-1)
            sb = slab[CHAIN_TILE + wn * 8 * NI:].reshape(-1)
            for kk in range(0, CHAIN_K, mma_k):
                for lane in range(32):
                    g, q = lane // 4, lane % 4
                    for mi in range(MI):
                        for i in range(mma_k // 2):  # a[i] = A[g + 8 (i % 2)][q + 4 (i / 2)]
                            got = sa[(mi * 16 + g + 8 * (i % 2)) * ld + kk + q + 4 * (i // 2)]
                            row = row0 + wm * 16 * MI + mi * 16 + g + 8 * (i % 2)
                            k = kt * CHAIN_K + kk + q + 4 * (i // 2)
                            assert int(got) == _id(row, k, w, nb)
                    for ni in range(NI):
                        for i in range(mma_k // 4):  # b[i] = B[g][q + 4 i]
                            got = sb[(ni * 8 + g) * ld + kk + q + 4 * i]
                            k = kt * CHAIN_K + kk + q + 4 * i
                            assert int(got) == _id(col0 + wn * 8 * NI + ni * 8 + g, k, w, nb)
                if warp == 0:
                    seen.append(list(range(kt * CHAIN_K + kk, kt * CHAIN_K + kk + mma_k)))
    flat = [k for ks in seen for k in ks]
    assert flat == list(range(-(-nb // CHAIN_K) * CHAIN_K))  # ascending, each once, no split


# ---- the update assembled from the schedule, against the reference -------------------

def _assembled(buf, p, offsets_of, w, tb, body):
    """buf -= P·Pᵀ written block by block through the schedule: each block's
    tile product in fp64, each thread's sums through the epilogue's mask and
    the address map."""
    out = buf.clone().reshape(-1)
    rows, cols = chain_owners(body)
    for row0, col0 in chain_grid(w, tb):
        r = (row0 + rows).reshape(-1)
        c = (col0 + cols).reshape(-1)
        keep = (r < w) & (c < w)
        r, c = r[keep], c[keep]
        keep = r >= c // tb * tb
        r, c = r[keep], c[keep]
        prod = (p[r] * p[c]).sum(1)
        off = offsets_of(r, c)
        out[off] -= prod
    return out.reshape(buf.shape)


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("m,tb,nb,origin", [(192, 32, 24, 0), (288, 96, 40, 1),
                                            (256, 128, 16, 1)])
def test_assembled_dense_update_matches_jax(body, m, tb, nb, origin):
    rng = np.random.default_rng(m + nb + origin)
    c = rng.standard_normal((m, m))
    p = rng.standard_normal((m - origin * tb, nb))
    ref = np.asarray(jax_trailing(jnp.asarray(c), jnp.asarray(p), tb=tb, origin=origin))
    got = _assembled(torch.from_numpy(c), torch.from_numpy(p),
                     lambda r, cc: _dense_offsets(r, cc, origin * tb, m), m - origin * tb, tb,
                     body).numpy()
    scale = (p**2).sum(1).max()
    mask = _lower_mask(m, tb, origin).numpy()
    assert np.abs(got - ref)[mask].max() <= 1e-12 * scale
    np.testing.assert_array_equal(got[~mask], c[~mask])


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("n,w,ktb,k", [(384, 96, 32, 0), (384, 96, 32, 1), (512, 128, 64, 1)])
def test_assembled_packed_update_matches_jax(body, n, w, ktb, k):
    rng = np.random.default_rng(n + 7 * k + ktb)
    c = rng.standard_normal((packed_rows(n, w), w))
    p = rng.standard_normal((n - (k + 1) * w, w))
    ref = np.asarray(jax_trailing_packed(jnp.asarray(c), jnp.asarray(p), n=n, w=w, k=k, tb=ktb))
    base = (k + 1) * w
    got = _assembled(torch.from_numpy(c), torch.from_numpy(p),
                     lambda r, cc: _packed_offsets(r, cc, n, w, base), n - base, ktb,
                     body).numpy()
    scale = (p**2).sum(1).max()
    mask = _packed_visited(n, w, ktb, k).numpy()
    assert np.abs(got - ref)[mask].max() <= 1e-12 * scale
    np.testing.assert_array_equal(got[~mask], c[~mask])
