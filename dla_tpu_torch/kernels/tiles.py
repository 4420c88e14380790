"""Tile kernels — counterparts of ``dla_tpu/kernels/pallas_tiles.py``.

The trailing updates C ← C − P·Pᵀ over lower tile pairs:

- :func:`trailing_update_lower` (``:328``) on a dense matrix, CUDA kernel
  ``csrc/trailing_lower.cu``;
- :func:`trailing_update_packed` (``:557``) on the column-slab packed
  triangle of ``dla_tpu_torch.algos.packed``, CUDA kernel
  ``csrc/trailing_packed.cu``.

The four task kernels of the reference's tile DAG, one launch per task:

- :func:`potrf_tile` (``:171``): (tril(L), inv(L)) of one SPD tile, CUDA
  kernel ``csrc/potrf_tile.cu`` (the diagonal phase of ``panel_factor``,
  the tiled schedule of ``csrc/diag_block.cuh``);
- :func:`trsm_tile` (``:194``), :func:`syrk_tile` (``:218``) and
  :func:`gemm_tile` (``:238``): B·inv(L)ᵀ, C − A·Aᵀ on the lower triangle and
  C − Aᵢ·Aⱼᵀ, one CUDA kernel with three epilogues, ``csrc/tile_ops.cu``.
  They are not in place: each returns a new tensor and leaves its inputs
  alone, as the Pallas calls do. At fp32 ``high``/``default`` and bf16
  storage they run the trailing kernels' tensor-core pipeline with two
  operands (:func:`tile_op_planes`; the split scratch, A's planes then B's,
  or A's alone for syrk, is :func:`split_pair_plain` in torch ops), at fp32
  ``highest`` and fp64 the trailing kernels' two FMA-chain bodies on a
  rectangular grid (:func:`chain_tile_grid`, with the tile edge
  :func:`chain_tile_edge`). syrk forms products for the tiles on and below
  the diagonal only and copies C into the others in the same launch
  (:func:`syrk_tile_grid`). :func:`tile_op_body` names the body and
  :func:`tile_op_reference` runs any of the three through the scalar body,
  the chain bodies' bit reference in the card tests.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel; on a
CPU tensor it runs its ``*_plain`` version, the same function in torch ops.
Any other device, or a CUDA tensor the kernel does not take, raises. The two
trailing kernels share three block bodies and differ only in their address
maps: fp32 ``high`` and ``default`` and bf16 storage run on the bf16 tensor
cores (``csrc/trailing_wgmma.cuh``: ``wgmma`` on bf16 planes of P, which a
split kernel writes into scratch the wrapper allocates, :func:`split_planes`
planes of it), fp32 ``highest`` on a register-blocked fp32 FMA chain and fp64
on an fp64 chain through the fp64 tensor cores (``csrc/trailing_chain.cuh``;
both keep the bits of the scalar ``nt_block`` that the task kernels run).
:func:`trailing_body` names the body, :func:`split_plain` is the split in
torch ops, and :func:`chain_grid` and :func:`chain_owners` model the chain
bodies' grid and which thread holds which output.

The reference walks host tables of tile pairs (``_lower_pairs``, ``:322``;
``_packed_pairs``, ``:531``). Here no pair table is needed: each kernel block
computes its own tile indices (the tensor-core body returns when it lies
above the diagonal; the chain bodies launch no such block), and the plain
versions walk the window's tile columns, one product per column.

``launches``, ``packed_launches`` and ``potrf_tile_launches``,
``trsm_tile_launches``, ``syrk_tile_launches``, ``gemm_tile_launches`` count
each kernel's launches (and nothing else), so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from dla_tpu_torch.kernels import _build
from dla_tpu_torch.ops.lapack_like import _sqrt_rn
from dla_tpu_torch.utils.precision import tier

#: number of times each CUDA kernel was launched in this process
launches = 0  # trailing_lower.cu
packed_launches = 0  # trailing_packed.cu
potrf_tile_launches = 0  # potrf_tile.cu
trsm_tile_launches = 0  # tile_ops.cu, the trsm epilogue
syrk_tile_launches = 0  # tile_ops.cu, the syrk epilogue
gemm_tile_launches = 0  # tile_ops.cu, the gemm epilogue

_DTYPES = (torch.float32, torch.float64, torch.bfloat16)
_TIER_CODE = {"highest": 0, "high": 1, "default": 2}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
_OP_CODE = {"trsm": 0, "syrk": 1, "gemm": 2}  # the Epilogue of csrc/tile_body.cuh


def _check(c: torch.Tensor, p: torch.Tensor, tb: int, kb: int | None,
           alias: bool, origin: int) -> None:
    """The reference's argument checks (``pallas_tiles.py:362-380``)."""
    if c.ndim != 2 or c.shape[0] != c.shape[1]:
        raise ValueError("c must be square")
    m = c.shape[0]
    if m % tb:
        raise ValueError(f"trailing size {m} must be a multiple of tb={tb}")
    if origin and not alias:
        raise ValueError("origin needs alias=True (untouched tiles must "
                         "pass through the output)")
    if p.ndim != 2 or p.shape[0] != m - origin * tb:
        raise ValueError("panel rows must match the trailing window")
    nb = p.shape[1]
    if kb is None:
        kb = min(nb, 512)
    if nb % kb:
        raise ValueError(f"panel width {nb} must be a multiple of kb={kb}")
    _check_dtypes("trailing_update_lower", c, p)


def _check_dtypes(name: str, c: torch.Tensor, p: torch.Tensor) -> None:
    if c.dtype not in _DTYPES or p.dtype != c.dtype:
        raise TypeError(
            f"{name} takes real float32/float64/bfloat16 operands of one dtype "
            f"(the reference kernel is real-only); got {c.dtype} and {p.dtype}"
        )


#: the tensor-core body's output tile and k-step (``kBM``, ``kBK`` of
#: ``csrc/trailing_wgmma.cuh``): the split planes are padded to them
SPLIT_ROWS, SPLIT_K = 128, 64


def split_planes(dtype: torch.dtype, tier_name: str) -> int:
    """How many bf16 planes of P the trailing kernels' tensor-core body takes
    for this storage dtype and tier: fp32 ``high`` 2 (hi, lo), fp32
    ``default`` 1, bf16 storage 1 at any tier; 0 means a chain body (fp32
    ``highest``, fp64). ``launch_trailing`` of ``csrc/trailing_chain.cuh``
    dispatches on the same table."""
    if dtype == torch.bfloat16:
        return 1
    if dtype == torch.float32:
        return {"high": 2, "default": 1}.get(tier_name, 0)
    return 0


def trailing_body(dtype: torch.dtype, tier_name: str) -> str:
    """Which block body the trailing kernels run: ``"wgmma"`` (bf16 tensor
    cores), ``"simt"`` (fp32 ``highest``: the fp32 FMA chain) or ``"dmma"``
    (fp64: the fp64 chain on the fp64 tensor cores)."""
    if split_planes(dtype, tier_name):
        return "wgmma"
    return "dmma" if dtype == torch.float64 else "simt"


def body_launches() -> dict[str, int]:
    """Launches of both trailing kernels in this process through each block
    body, as the C launch counts them where it launches: ``{"simt": n,
    "wgmma": n, "dmma": n}``. Needs the kernel library (a CUDA device and
    ``nvcc``)."""
    fn = _build.load().dla_trailing_body_launches
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    return {"simt": fn(0), "wgmma": fn(1), "dmma": fn(2)}


#: the chain bodies' output tile, block rows per group and most groups
#: (``kTile``, ``kGroup``, ``kMaxGroups`` of ``csrc/trailing_chain.cuh``)
CHAIN_TILE, CHAIN_GROUP, CHAIN_MAX_GROUPS = 128, 8, 512
#: the chain bodies' k-step: nt_block's, so k is zero-padded alike
CHAIN_K = 16
#: a DMMA warp's outputs along each axis of the tile (``kDWarpTile``): 16
#: warps of 32 × 32 outputs in a 128 tile, 4 in a 64 tile
CHAIN_DMMA_WARP_TILE = 32
#: the task kernels' smaller chain tile edge
CHAIN_SMALL_TILE = 64
#: blocks an SM of the SIMT body at the 128 tile where the operands' rows
#: start on 16 bytes (``kSimtBlocks``); one otherwise, and for the DMMA body
CHAIN_SIMT_BLOCKS = 2


def chain_row_blocks(bi: int, w: int, tb: int) -> int:
    """Output tiles of block row ``bi`` that the chain bodies launch: the
    columns before the end of the tb-tile of the block's last row
    (``row_blocks`` of ``csrc/trailing_chain.cuh``)."""
    g = -(-w // CHAIN_TILE)
    last = min(bi * CHAIN_TILE + CHAIN_TILE - 1, w - 1)
    return min(g, -(-((last // tb + 1) * tb) // CHAIN_TILE))


def chain_grid(w: int, tb: int) -> list[tuple[int, int]]:
    """(row0, col0) of the output tile of each block of the chain bodies, in
    block order, decoded as ``lower_tile`` of ``csrc/trailing_chain.cuh``
    decodes ``blockIdx.x``: the group's first block (``lower_grid``'s table)
    by bisection, then the group's column-by-column walk, in which column
    ``bj`` holds the group's rows whose :func:`chain_row_blocks` exceeds it."""
    g = -(-w // CHAIN_TILE)
    groups = -(-g // CHAIN_GROUP)
    if groups > CHAIN_MAX_GROUPS:
        raise ValueError(f"window {w} needs {groups} block groups, more than {CHAIN_MAX_GROUPS}")
    counts = [chain_row_blocks(bi, w, tb) for bi in range(g)]
    start = [sum(counts[: G * CHAIN_GROUP]) for G in range(groups)] + [sum(counts)]
    tiles_ = []
    for b in range(start[-1]):
        lo, hi = 0, groups - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if start[mid] <= b else (lo, mid - 1)
        first = lo * CHAIN_GROUP
        rows = min(g - first, CHAIN_GROUP)
        left, prev = b - start[lo], 0
        for s in range(rows):
            span = (counts[first + s] - prev) * (rows - s)
            if left < span:
                tiles_.append(((first + s + left % (rows - s)) * CHAIN_TILE,
                               (prev + left // (rows - s)) * CHAIN_TILE))
                break
            left -= span
            prev = counts[first + s]
    return tiles_


def chain_owners(body: str, tile: int = CHAIN_TILE) -> tuple[torch.Tensor, torch.Tensor]:
    """Which outputs of a tile × tile block (128 or 64) each thread of a chain
    body holds: (rows, cols), each (threads, outputs a thread), entry [t, e]
    the tile row and column of thread t's e-th sum. ``"simt"``, 256 threads:
    thread (ty, tx) = (t // 16, t % 16) holds rows g·64 + ty·4 + i (g <
    tile/64, i < 4) by the columns of the same form from tx. ``"dmma"``,
    (tile/32)² warps: warp (wm, wn) = (warp % W, warp // W), W = tile/32,
    holds rows wm·32 … +31 by columns wn·32 … +31 as 2 × 4 m16n8 fragments;
    lane (g, q) = (lane // 4, lane % 4) holds rows g and g + 8 and columns 2q
    and 2q + 1 of each."""
    if tile not in (CHAIN_TILE, CHAIN_SMALL_TILE):
        raise ValueError(f"no chain tile edge {tile}")
    if body == "simt":
        per = tile // 16  # sums a thread along each axis
        t, e = torch.arange(256)[:, None], torch.arange(per * per)[None, :]
        i, j = e // per, e % per
        rows = (i // 4) * 64 + (t // 16) * 4 + i % 4
        cols = (j // 4) * 64 + (t % 16) * 4 + j % 4
    elif body == "dmma":
        warps = tile // CHAIN_DMMA_WARP_TILE
        mi_n, ni_n = CHAIN_DMMA_WARP_TILE // 16, CHAIN_DMMA_WARP_TILE // 8
        t = torch.arange(32 * warps * warps)[:, None]
        e = torch.arange(4 * mi_n * ni_n)[None, :]
        warp, lane = t // 32, t % 32
        mi, ni, x = e // (4 * ni_n), e // 4 % ni_n, e % 4
        rows = (warp % warps) * CHAIN_DMMA_WARP_TILE + mi * 16 + lane // 4 + 8 * (x // 2)
        cols = (warp // warps) * CHAIN_DMMA_WARP_TILE + ni * 8 + 2 * (lane % 4) + x % 2
    else:
        raise ValueError(f"no chain body {body!r}")
    return rows, cols


def chain_tile_grid(m: int, n: int, tile: int) -> list[tuple[int, int]]:
    """(row0, col0) of the output tile of each block of the task kernels'
    chain bodies on an (m, n) output, in block order, decoded as
    ``chain_tile`` of ``csrc/tile_body.cuh`` decodes ``blockIdx.x``: the
    ⌈m/tile⌉ × ⌈n/tile⌉ tiles in groups of :data:`CHAIN_GROUP` block rows,
    each group walked column by column (the order of the tensor-core body's
    ``block_tile``)."""
    gm, gn = -(-m // tile), -(-n // tile)
    out = []
    for b in range(gm * gn):
        first = b // (CHAIN_GROUP * gn) * CHAIN_GROUP
        in_group = b % (CHAIN_GROUP * gn)
        rows = min(gm - first, CHAIN_GROUP)
        out.append(((first + in_group % rows) * tile, in_group // rows * tile))
    return out


def syrk_tile_grid(n: int, tile: int) -> list[tuple[int, int, bool]]:
    """(row0, col0, copy) of the output tile of each block of syrk on an (n,
    n) output, in block order, decoded as ``syrk_tile`` of
    ``csrc/tile_body.cuh`` decodes ``blockIdx.x`` (every body, at its tile
    edge): g² blocks for a g × g grid of tiles, g = ⌈n/tile⌉. The first
    g(g+1)/2 take the tiles with row tile ≥ column tile and form a product,
    in :func:`chain_tile_grid`'s order restricted to them (groups of
    :data:`CHAIN_GROUP` row tiles, each walked column by column, where a
    column inside the group's diagonal block holds the group's rows from the
    diagonal down); the other g(g−1)/2 take the tiles above the diagonal,
    column by column, and only copy C (``copy`` True)."""
    g = -(-n // tile)
    lower = g * (g + 1) // 2

    def tri_root(b):  # the largest r with r(r + 1)/2 <= b
        return (math.isqrt(8 * b + 1) - 1) // 2

    out = []
    for b in range(g * g):
        if b >= lower:
            u = b - lower
            col = tri_root(u) + 1
            out.append(((u - col * (col - 1) // 2) * tile, col * tile, True))
            continue
        first = tri_root(b) // CHAIN_GROUP * CHAIN_GROUP
        rows = min(g - first, CHAIN_GROUP)
        left = b - first * (first + 1) // 2
        if left < first * rows:
            out.append(((first + left % rows) * tile, left // rows * tile, False))
            continue
        left -= first * rows
        s = 0
        while left >= rows - s:
            left -= rows - s
            s += 1
        out.append(((first + s + left) * tile, (first + s) * tile, False))
    return out


def chain_tile_edge(m: int, n: int, body: str, sms: int, aligned: bool = True,
                    op: str = "gemm") -> int:
    """The tile edge the task kernels' chain body takes on an (m, n) output
    (``launch_chain`` and ``chain_edge`` of ``csrc/tile_body.cuh``): ``"simt"``
    128 where the 128-tile grid has at least as many product blocks (syrk:
    its lower tiles, :func:`syrk_tile_grid`) as ``sms`` SMs run at once (two
    an SM on operands whose rows start on 16 bytes, else one), 64 otherwise;
    ``"dmma"`` always 64."""
    if body == "dmma":
        return CHAIN_SMALL_TILE
    per_sm = CHAIN_SIMT_BLOCKS if aligned else 1
    gm, gn = -(-m // CHAIN_TILE), -(-n // CHAIN_TILE)
    blocks = gm * (gm + 1) // 2 if op == "syrk" else gm * gn
    return CHAIN_TILE if blocks >= sms * per_sm else CHAIN_SMALL_TILE


def tile_op_planes(op: str, dtype: torch.dtype, tier_name: str) -> int:
    """How many bf16 planes of each operand the task kernel ``op`` (trsm,
    syrk, gemm) takes on the tensor-core body: :func:`split_planes`' table,
    for all three (0: a chain body). ``run`` of ``csrc/tile_ops.cu``
    dispatches on the same table."""
    if op not in _OP_CODE:
        raise ValueError(f"no task kernel {op!r}")
    return split_planes(dtype, tier_name)


def tile_op_body(op: str, dtype: torch.dtype, tier_name: str) -> str:
    """Which block body the task kernel ``op`` runs: ``"wgmma"`` where
    :func:`tile_op_planes` gives planes, else the chain body, ``"simt"``
    (fp32 ``highest``) or ``"dmma"`` (fp64), as :func:`trailing_body` names
    them; the same for all three ops. ``run`` of ``csrc/tile_ops.cu``
    dispatches on the same table."""
    if op not in _OP_CODE:
        raise ValueError(f"no task kernel {op!r}")
    return trailing_body(dtype, tier_name)


#: the block bodies of ``csrc/tile_body.cuh`` (``TileBody``), by the index
#: that the per-body launch counts of the task kernels and of the panel
#: kernels take (no launch of the library takes ``"scalar"``: its counts stay 0)
TILE_BODIES = ("scalar", "wgmma", "simt", "dmma")


def tile_body_launches() -> dict[str, int]:
    """Launches of the three task kernels of ``csrc/tile_ops.cu`` in this
    process through each block body, as the C side counts them where it
    launches: ``{"scalar": n, "wgmma": n, "simt": n, "dmma": n}``. Needs the
    kernel library."""
    fn = _build.load().dla_tile_body_launches
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    return {body: fn(i) for i, body in enumerate(TILE_BODIES)}


def tile_op_reference(op: str, c: torch.Tensor | None, a: torch.Tensor, b: torch.Tensor, *,
                      tile: int = 0) -> torch.Tensor:
    """out = P (``op`` "trsm", c None), c − P ("gemm") or c − P on the lower
    triangle and c above it ("syrk", b = a), P = a·bᵀ, at fp32 ``highest`` or
    fp64, through a body named by ``tile``: 0 the scalar body (``tile_kernel``
    on ``nt_block``, the bits #6, #7 and #8 had before their chain bodies), 64
    or 128 (fp32 only) the simt body at that tile edge; fp64's dmma body has
    one edge, the library's. For the card tests and measurements: no library
    path calls it, and it counts no launch. CUDA tensors only; returns a new
    (m, n) tensor."""
    if a.dtype not in (torch.float32, torch.float64) or op not in _OP_CODE:
        raise ValueError(f"tile_op_reference takes trsm, syrk or gemm on fp32 or fp64; got "
                         f"{op}, {a.dtype}")
    if op == "syrk" and (b.data_ptr(), b.shape, b.stride()) != (a.data_ptr(), a.shape,
                                                                 a.stride()):
        raise ValueError("tile_op_reference: syrk takes b = a")
    if tile and a.dtype != torch.float32:
        raise ValueError(f"tile_op_reference takes a tile edge on fp32 only; got {a.dtype}")
    _row_major("tile_op_reference", *(t for t in (c, a, b) if t is not None))
    m, n, k = a.shape[0], b.shape[0], a.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    lib = _build.load()
    kind = "chain" if tile else "scalar"
    fn = getattr(lib, f"dla_tile_op_{kind}_{_SUFFIX[a.dtype]}")
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6
                   + [ctypes.c_int] * bool(tile) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(_OP_CODE[op], None if c is None else c.data_ptr(), a.data_ptr(), b.data_ptr(),
                 out.data_ptr(), m, n, k, 0 if c is None else c.stride(0), a.stride(0),
                 b.stride(0), *((tile,) if tile else ()), stream)
    if err != 0:
        raise RuntimeError(f"tile_op_reference launch failed: CUDA error {err}")
    return out


def _split_shape(p: torch.Tensor, planes: int) -> tuple[int, int, int]:
    w, nb = p.shape
    return planes, -(-w // SPLIT_ROWS) * SPLIT_ROWS, -(-nb // SPLIT_K) * SPLIT_K


def split_plain(p: torch.Tensor, planes: int) -> torch.Tensor:
    """The split planes of P that the tensor-core body reads, in torch ops
    (the split kernel of ``csrc/trailing_wgmma.cuh`` writes the same bits):
    shape (planes, w rounded up to 128, nb rounded up to 64), bf16, zero past
    P. Plane 0 is bf16(P); at two planes plane 1 is bf16(P − plane 0), the
    ``ahi`` and ``alo`` of the reference's ``_dot_nt``."""
    out = torch.zeros(_split_shape(p, planes), dtype=torch.bfloat16, device=p.device)
    w, nb = p.shape
    hi = p.to(torch.bfloat16)
    out[0, :w, :nb] = hi
    if planes == 2:
        out[1, :w, :nb] = (p.float() - hi.float()).to(torch.bfloat16)
    return out


def _pair_shape(m: int, n: int, k: int, planes: int) -> tuple[int, int]:
    """(rows, kpad) of the task kernels' split scratch: A's planes × mpad
    rows, then B's planes × npad, rows padded to 128 (syrk: n = 0, A's planes
    alone); k padded to 64 and at least 64, so that k = 0 still gives a full
    TMA box (of zeros)."""
    pad = lambda x: -(-x // SPLIT_ROWS) * SPLIT_ROWS  # noqa: E731
    return planes * (pad(m) + pad(n)), max(SPLIT_K, -(-k // SPLIT_K) * SPLIT_K)


def split_pair_plain(a: torch.Tensor, b: torch.Tensor | None, planes: int) -> torch.Tensor:
    """The split scratch of the task kernels' tensor-core body, in torch ops
    (the split kernel of ``csrc/trailing_wgmma.cuh`` writes the same bits):
    shape :func:`_pair_shape`, bf16; rows 0 … planes·mpad − 1 are
    :func:`split_plain` of ``a``, the rest that of ``b``, each zero-padded
    along k to the common kpad. ``b`` None: syrk's scratch, ``a``'s planes
    alone."""
    kpad = _pair_shape(a.shape[0], 0, a.shape[1], planes)[1]
    parts = [split_plain(x, planes) for x in (a, b) if x is not None]
    return torch.cat([torch.nn.functional.pad(x, (0, kpad - x.shape[-1])).reshape(-1, kpad)
                      for x in parts])


def _pair_scratch(m: int, n: int, k: int, planes: int,
                  device: torch.device) -> torch.Tensor | None:
    """Uninitialised scratch for the task kernels' split planes (the split
    kernel writes all of it); None for the chain bodies."""
    if not planes:
        return None
    return torch.empty(_pair_shape(m, n, k, planes), dtype=torch.bfloat16, device=device)


def _split_scratch(p: torch.Tensor, planes: int) -> torch.Tensor | None:
    """Uninitialised scratch for the split planes (the split kernel writes all
    of it, padding included); None for the chain bodies."""
    if not planes:
        return None
    return torch.empty(_split_shape(p, planes), dtype=torch.bfloat16, device=p.device)


def _launch_trailing(name: str, fn, dest: torch.Tensor, p: torch.Tensor, ints: tuple) -> None:
    """One call of a trailing kernel's C entry on the current stream: the
    destination, P, the split scratch, the entry's six integers, the scratch's
    bytes, the tier. Raises on a non-zero CUDA error: a refused launch never
    falls back to the other body."""
    t = tier()
    scratch = _split_scratch(p, split_planes(p.dtype, t))
    nbytes = 0 if scratch is None else scratch.numel() * scratch.element_size()
    with torch.cuda.device(dest.device):
        stream = torch.cuda.current_stream(dest.device).cuda_stream
        err = fn(dest.data_ptr(), p.data_ptr(), None if scratch is None else scratch.data_ptr(),
                 *ints, nbytes, _TIER_CODE[t], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _dot_nt_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` as the reference's ``_dot_nt``: fp32 accumulation for
    bf16/fp32 operands, bf16x3 at ``high``, one bf16 pass at ``default``."""
    if a.dtype == torch.float64:
        return a @ b.mT
    if a.dtype == torch.bfloat16:
        return a.float() @ b.float().mT
    t = tier()
    if t == "high":
        ahi = a.to(torch.bfloat16)
        alo = (a - ahi.float()).to(torch.bfloat16)
        bhi = b.to(torch.bfloat16)
        blo = (b - bhi.float()).to(torch.bfloat16)

        def dot(x, y):
            return x.float() @ y.float().mT

        return dot(ahi, bhi) + (dot(ahi, blo) + dot(alo, bhi))
    if t == "default":
        return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float().mT
    return a @ b.mT


def trailing_update_lower_plain(
    c: torch.Tensor,
    p: torch.Tensor,
    *,
    tb: int = 256,
    kb: int | None = None,
    alias: bool = True,
    origin: int = 0,
) -> torch.Tensor:
    """The plain torch version of :func:`trailing_update_lower`: one product
    per tile column of the window, over its lower tiles (diagonal tile
    whole). ``kb`` is checked but the product runs over the whole panel
    width."""
    _check(c, p, tb, kb, alias, origin)
    out = c if alias else c.clone()
    o = origin * tb
    nt = c.shape[0] // tb - origin
    for j in range(nt):
        r0 = j * tb
        _subtract(out[o + r0 :, o + r0 : o + r0 + tb], _dot_nt_plain(p[r0:], p[r0 : r0 + tb]))
    return out


def _minus(c: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """``c − upd``; bf16 storage as the reference's epilogue, bf16(c − bf16(acc))."""
    if c.dtype == torch.bfloat16:
        return (c.float() - upd.to(torch.bfloat16).float()).to(torch.bfloat16)
    return c - upd


def _subtract(blk: torch.Tensor, upd: torch.Tensor) -> None:
    """``blk −= upd`` in place, with :func:`_minus`'s rounding."""
    if blk.dtype == torch.bfloat16:
        blk.copy_(_minus(blk, upd))
    else:
        blk.sub_(upd)


@functools.cache
def _kernel(kind: str, dtype: torch.dtype):
    """The C entry ``dla_trailing_<kind>_<dtype>``; both kinds take three
    pointers (destination, P, split scratch), six 64-bit integers, the
    scratch's bytes, the tier and the stream."""
    fn = getattr(_build.load(), f"dla_trailing_{kind}_{_SUFFIX[dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 7 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def trailing_update_lower(
    c: torch.Tensor,
    p: torch.Tensor,
    *,
    tb: int = 256,
    kb: int | None = None,
    alias: bool = True,
    origin: int = 0,
) -> torch.Tensor:
    """C[lower tiles] ← C − P·Pᵀ over the tile pairs (i ≥ j) of the tb×tb
    grid of the window that starts at tile (origin, origin) of ``c``. Whole
    diagonal tiles are updated; every other element passes through.

    ``alias=True`` updates ``c`` in place and returns it. ``alias=False``
    leaves ``c`` alone and returns an updated copy. ``p`` has the window's
    rows, shape ``(m − origin·tb, nb)``. ``kb`` must divide nb (checked as
    in the reference); the kernel picks its own k-step. The product follows
    the precision tier at call time. Real dtypes only.
    """
    global launches
    if c.device.type == "cpu" and p.device.type == "cpu":
        return trailing_update_lower_plain(c, p, tb=tb, kb=kb, alias=alias, origin=origin)
    if c.device.type != "cuda" or p.device != c.device:
        raise ValueError(
            f"trailing_update_lower needs c and p both on the CPU or both on "
            f"one CUDA device; got {c.device} and {p.device}"
        )
    _check(c, p, tb, kb, alias, origin)
    m, nb = c.shape[0], p.shape[1]
    w = p.shape[0]
    if c.stride(1) != 1 or c.stride(0) < m or p.stride(1) != 1 or p.stride(0) < nb:
        raise ValueError(
            "trailing_update_lower needs row-major c and p (unit column "
            f"stride); got strides {c.stride()} and {p.stride()}"
        )
    out = c if alias else c.clone(memory_format=torch.contiguous_format)
    if w == 0 or nb == 0:
        return out
    _launch_trailing("trailing_update_lower", _kernel("lower", c.dtype), out, p,
                     (w, nb, out.stride(0), p.stride(0), origin * tb, tb))
    launches += 1
    return out


def _slab_row0(j: int, nt: int, w: int) -> int:
    """First buffer row of slab j of the packed layout (``algos/packed.py``,
    ``_row_offset``; ``csrc/trailing_packed.cu`` computes the same); slab nt
    would start at the buffer's row count."""
    return w * (j * nt - j * (j - 1) // 2)


def _check_packed(packed: torch.Tensor, p: torch.Tensor, n: int, w: int, k: int,
                  tb: int, kb: int | None) -> None:
    """The reference's argument checks (``pallas_tiles.py:582-592``), plus the
    buffer's own shape, which the kernel's address map relies on."""
    if n % w or w % tb:
        raise ValueError(f"need n % w == 0 and w % tb == 0 (n={n}, w={w}, tb={tb})")
    if not 0 <= k < n // w:  # a step outside the triangle would address outside the buffer
        raise ValueError(f"step k={k} outside 0..{n // w - 1}")
    rows = _slab_row0(n // w, n // w, w)
    if packed.shape != (rows, w):
        raise ValueError(f"packed buffer shape {tuple(packed.shape)} != {(rows, w)}")
    if tuple(p.shape) != (n - (k + 1) * w, w):
        raise ValueError(f"panel shape {tuple(p.shape)} != {(n - (k + 1) * w, w)}")
    kb = min(w, 512) if kb is None else kb
    if w % kb:
        raise ValueError(f"panel width {w} must be a multiple of kb={kb}")
    _check_dtypes("trailing_update_packed", packed, p)


def trailing_update_packed_plain(
    packed: torch.Tensor,
    p: torch.Tensor,
    *,
    n: int,
    w: int,
    k: int,
    tb: int = 1024,
    kb: int | None = None,
) -> torch.Tensor:
    """The plain torch version of :func:`trailing_update_packed`: for each tb
    tile column of the trailing window, one product from that column's
    diagonal tile down, written into the owning slab. The diagonal tile is
    updated whole; the tiles above it inside a diagonal w-block are left
    alone. ``kb`` is checked but the product runs over the whole panel
    width.

    This is not ``potrf_packed(trailing="xla")``'s per-slab loop, which
    updates each whole w×w diagonal block: the two differ above the
    tb-diagonal."""
    _check_packed(packed, p, n, w, k, tb, kb)
    nt = n // w
    base = (k + 1) * w
    for c0 in range(0, n - base, tb):
        j, cs = divmod(base + c0, w)  # owning slab, column inside it
        r0 = _slab_row0(j, nt, w) + cs  # buffer row of global row base + c0
        upd = _dot_nt_plain(p[c0:], p[c0 : c0 + tb])
        _subtract(packed[r0 : r0 + upd.shape[0], cs : cs + tb], upd)
    return packed


def trailing_update_packed(
    packed: torch.Tensor,
    p: torch.Tensor,
    *,
    n: int,
    w: int,
    k: int,
    tb: int = 1024,
    kb: int | None = None,
) -> torch.Tensor:
    """packed[trailing tiles] ← packed − P·Pᵀ over the column-slab packed
    lower triangle (``dla_tpu_torch.algos.packed`` layout), **in place**:
    ``packed`` is updated and returned (the reference aliases input and
    output to the same effect).

    ``w`` is the slab width, ``k`` the panel step in slab units, ``p`` the
    solved panel of the trailing rows, shape ``(n − (k+1)·w, w)``, in the
    buffer's dtype. The trailing window is cut into tb×tb tiles; the lower
    tile pairs are updated (diagonal tiles whole), every other element
    passes through bit for bit. ``kb`` must divide w (checked as in the
    reference); the kernel picks its own k-step. The product follows the
    precision tier at call time. Real dtypes only.
    """
    global packed_launches
    if packed.device.type == "cpu" and p.device.type == "cpu":
        return trailing_update_packed_plain(packed, p, n=n, w=w, k=k, tb=tb, kb=kb)
    if packed.device.type != "cuda" or p.device != packed.device:
        raise ValueError(
            f"trailing_update_packed needs packed and p both on the CPU or both "
            f"on one CUDA device; got {packed.device} and {p.device}"
        )
    _check_packed(packed, p, n, w, k, tb, kb)
    if not packed.is_contiguous() or p.stride(1) != 1 or p.stride(0) < w:
        raise ValueError(
            "trailing_update_packed needs a contiguous row-major packed buffer and "
            f"a row-major panel; got strides {packed.stride()} and {p.stride()}"
        )
    m = p.shape[0]
    if m == 0:
        return packed
    _launch_trailing("trailing_update_packed", _kernel("packed", packed.dtype), packed, p,
                     (m, w, p.stride(0), (k + 1) * w, n // w, tb))
    packed_launches += 1
    return packed


# ---- the four task kernels -----------------------------------------------------------

#: the largest tile :func:`potrf_tile` takes (``kMaxNb`` of ``csrc/diag_block.cuh``)
POTRF_TILE_MAX = 512


def _same_device(name: str, *ts: torch.Tensor) -> bool:
    """True for CPU operands; raises unless they all lie on one CUDA device."""
    if all(t.device.type == "cpu" for t in ts):
        return True
    if ts[0].device.type != "cuda" or any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{name} needs its operands all on the CPU or all on one CUDA "
                         f"device; got {[str(t.device) for t in ts]}")
    return False


def _row_major(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.stride(1) != 1 or t.stride(0) < t.shape[1]:
            raise ValueError(f"{name} needs row-major operands (unit column stride); "
                             f"got strides {t.stride()} for shape {tuple(t.shape)}")


def _round_operand(x: torch.Tensor) -> torch.Tensor:
    """An operand of a rank-1 step at ``_kernel_precision``
    (``pallas_tiles.py:60-65``): bf16-rounded at ``default`` for fp32, else as
    it is (``high`` is promoted to ``highest``)."""
    if x.dtype == torch.float32 and tier() == "default":
        return x.to(torch.bfloat16).to(x.dtype)
    return x


def _factor_lower_plain(a: torch.Tensor) -> torch.Tensor:
    """tril(L) of one SPD block by n rank-1 steps, reading the lower
    triangle only (``_factor_lower``, ``pallas_tiles.py:97``)."""
    n = a.shape[0]
    l = torch.tril(a)
    for j in range(n):
        piv = _sqrt_rn(l[j, j])
        l[j, j] = piv
        col = l[j + 1 :, j] / piv
        l[j + 1 :, j] = col
        c = _round_operand(col)
        l[j + 1 :, j + 1 :] -= torch.outer(c, c)
    return torch.tril(l)


def _invert_lower_plain(l: torch.Tensor) -> torch.Tensor:
    """inv(L) by column-oriented forward substitution, n rank-1 steps
    (``_invert_lower``, ``pallas_tiles.py:129``)."""
    n = l.shape[0]
    x = torch.eye(n, dtype=l.dtype, device=l.device)
    for j in range(n):
        xrow = x[j, : j + 1] / l[j, j]
        x[j, : j + 1] = xrow
        x[j + 1 :, : j + 1] -= torch.outer(_round_operand(l[j + 1 :, j]), _round_operand(xrow))
    return x


def _check_tiles(name: str, dtypes, shapes: dict[str, tuple[torch.Tensor, tuple]]) -> None:
    """Each operand 2-D of the stated shape, all of one dtype among ``dtypes``."""
    first = next(iter(shapes.values()))[0]
    for arg, (t, want) in shapes.items():
        if t.ndim != 2 or (want is not None and tuple(t.shape) != want):
            raise ValueError(f"{name}: {arg} must be 2-D"
                             + (f" of shape {want}" if want is not None else "")
                             + f", got {tuple(t.shape)}")
        if t.dtype not in dtypes or t.dtype != first.dtype:
            raise TypeError(f"{name} takes real {'/'.join(str(d)[6:] for d in dtypes)} operands "
                            f"of one dtype (the reference kernel is real-only); {arg} is "
                            f"{t.dtype}")


def _check_potrf_tile(a: torch.Tensor) -> None:
    _check_tiles("potrf_tile", _DTYPES[:2], {"a": (a, None)})
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"potrf_tile: a must be square, got {tuple(a.shape)}")


def potrf_tile_plain(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain torch version of :func:`potrf_tile`."""
    _check_potrf_tile(a)
    l = _factor_lower_plain(a)
    return l, _invert_lower_plain(l)


def _check_trsm_tile(linv: torch.Tensor, b: torch.Tensor) -> None:
    _check_tiles("trsm_tile", _DTYPES, {"b": (b, None), "linv": (linv, (b.shape[-1],) * 2)})


def trsm_tile_plain(linv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain torch version of :func:`trsm_tile`."""
    _check_trsm_tile(linv, b)
    return _dot_nt_plain(b, linv).to(b.dtype)


def _check_syrk_tile(c: torch.Tensor, a: torch.Tensor) -> None:
    _check_tiles("syrk_tile", _DTYPES, {"c": (c, None), "a": (a, None)})
    if c.shape[0] != c.shape[1] or a.shape[0] != c.shape[0]:
        raise ValueError(f"syrk_tile: c must be (n, n) and a (n, k), got {tuple(c.shape)} and "
                         f"{tuple(a.shape)}")


def syrk_tile_plain(c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The plain torch version of :func:`syrk_tile`."""
    _check_syrk_tile(c, a)
    n = c.shape[0]
    lower = torch.ones(n, n, dtype=torch.bool, device=c.device).tril()
    return torch.where(lower, _minus(c, _dot_nt_plain(a, a)), c)


def _check_gemm_tile(c: torch.Tensor, ai: torch.Tensor, aj: torch.Tensor) -> None:
    _check_tiles("gemm_tile", _DTYPES, {"c": (c, None), "ai": (ai, None), "aj": (aj, None)})
    if ai.shape[0] != c.shape[0] or aj.shape[0] != c.shape[1] or ai.shape[1] != aj.shape[1]:
        raise ValueError(f"gemm_tile: c (m, n) needs ai (m, k) and aj (n, k), got "
                         f"{tuple(c.shape)}, {tuple(ai.shape)} and {tuple(aj.shape)}")


def gemm_tile_plain(c: torch.Tensor, ai: torch.Tensor, aj: torch.Tensor) -> torch.Tensor:
    """The plain torch version of :func:`gemm_tile`."""
    _check_gemm_tile(c, ai, aj)
    return _minus(c, _dot_nt_plain(ai, aj))


@functools.cache
def _task_entry(name: str, dtype: torch.dtype, npointers: int, nints: int):
    """The C entry ``dla_<name>_tile_<dtype>`` of ``csrc/potrf_tile.cu`` or
    ``csrc/tile_ops.cu``: pointers, 64-bit integers, the tier and the stream;
    it returns the CUDA error of its launch."""
    fn = getattr(_build.load(), f"dla_{name}_tile_{_SUFFIX[dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * npointers + [ctypes.c_longlong] * nints
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_tile_op(op: str, c: torch.Tensor | None, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """out (m, n) = epilogue(c, a·bᵀ) through ``csrc/tile_ops.cu``, with the
    split scratch of the tensor-core body where the tier takes it. Raises on
    a non-zero CUDA error: a refused launch never falls back to the other
    body."""
    _row_major(f"{op}_tile", *(t for t in (c, a, b) if t is not None))
    m, n, k = a.shape[0], b.shape[0], a.shape[1]
    if m == 0 or n == 0:
        raise ValueError(f"{op}_tile on a CUDA tensor takes no empty tile; got ({m}, {n})")
    t = tier()
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    # syrk's b is a: the scratch holds a's planes alone
    scratch = _pair_scratch(m, 0 if op == "syrk" else n, k, tile_op_planes(op, a.dtype, t),
                            a.device)
    nbytes = 0 if scratch is None else scratch.numel() * scratch.element_size()
    # c, a, b, out, scratch; m, n, k, three leading dimensions, the scratch's bytes
    fn = _task_entry(op, a.dtype, 5, 7)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(None if c is None else c.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), m, n, k,
                 0 if c is None else c.stride(0), a.stride(0), b.stride(0), nbytes,
                 _TIER_CODE[t], stream)
    if err != 0:
        raise RuntimeError(f"{op}_tile kernel launch failed: CUDA error {err}")
    return out


def potrf_tile(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Factor one SPD tile: returns (tril(L), inv(L)), two new (n, n)
    row-major tensors. Only the lower triangle of ``a`` is read. Real
    float32/float64. The rank-1 steps of the factor and of the inverse follow
    ``_kernel_precision``: ``high`` is ``highest``, and ``default`` rounds the
    steps' operands (not the stored L) to bf16.

    On a CUDA tensor n ≤ 512 (the cap of ``panel_factor``, whose diagonal
    phase this is): one C call launches ⌈n/64⌉ + 1 kernels on the current
    stream, the stages of a schedule over 64×64 tiles (up to 29 blocks at
    n = 512, :func:`potrf_tile_schedule`), which gives the plain version's
    bits. The reference states no cap, its tile only has to fit VMEM; a
    larger tile raises here rather than run another algorithm.
    """
    global potrf_tile_launches
    if _same_device("potrf_tile", a):
        return potrf_tile_plain(a)
    _check_potrf_tile(a)
    _row_major("potrf_tile", a)
    n = a.shape[0]
    if not 0 < n <= POTRF_TILE_MAX:
        raise ValueError(f"potrf_tile on a CUDA tensor takes 1 ≤ n ≤ {POTRF_TILE_MAX} (the "
                         f"cap of panel_factor, whose diagonal phase it is); got n={n}")
    l = torch.empty((n, n), dtype=a.dtype, device=a.device)
    linv = torch.empty((n, n), dtype=a.dtype, device=a.device)
    fn = _task_entry("potrf", a.dtype, 3, 2)  # a, l, linv; n and a's leading dimension
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), l.data_ptr(), linv.data_ptr(), n, a.stride(0),
                 _TIER_CODE[tier()], stream)
    if err != 0:
        raise RuntimeError(f"potrf_tile kernel launch failed: CUDA error {err}")
    potrf_tile_launches += 1
    return l, linv


def potrf_tile_schedule(n: int) -> tuple[int, int]:
    """The launches of :func:`potrf_tile`'s kernel at tile size n (also
    ``panel_factor``'s diagonal phase at nb = n) and the largest grid among
    them, from the kernel library (``dla_diag_schedule``)."""
    fn = _build.load().dla_diag_schedule
    fn.argtypes = [ctypes.c_longlong, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    launches, blocks = ctypes.c_int(), ctypes.c_int()
    if fn(n, ctypes.byref(launches), ctypes.byref(blocks)) != 0:
        raise ValueError(f"potrf_tile_schedule takes 1 ≤ n ≤ {POTRF_TILE_MAX}; got n={n}")
    return launches.value, blocks.value


def trsm_tile(linv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B·inv(L)ᵀ given the pre-inverted factor ``linv`` (n, n) and ``b``
    (m, n): the TRSM task as a product, at the precision tier. Returns a new
    (m, n) row-major tensor. Real float32/float64/bfloat16."""
    global trsm_tile_launches
    if _same_device("trsm_tile", linv, b):
        return trsm_tile_plain(linv, b)
    _check_trsm_tile(linv, b)
    out = _launch_tile_op("trsm", None, b, linv)
    trsm_tile_launches += 1
    return out


def syrk_tile(c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """C − A·Aᵀ on the lower triangle (row ≥ col) of ``c`` (n, n), with ``a``
    (n, k); above the diagonal ``c`` passes through bit for bit. Returns a new
    (n, n) row-major tensor; ``c`` is left alone. Real float32/float64/bfloat16
    (bf16: the product rounded to bf16, then subtracted in bf16)."""
    global syrk_tile_launches
    if _same_device("syrk_tile", c, a):
        return syrk_tile_plain(c, a)
    _check_syrk_tile(c, a)
    out = _launch_tile_op("syrk", c, a, a)
    syrk_tile_launches += 1
    return out


def gemm_tile(c: torch.Tensor, ai: torch.Tensor, aj: torch.Tensor) -> torch.Tensor:
    """C − Aᵢ·Aⱼᵀ with ``c`` (m, n), ``ai`` (m, k), ``aj`` (n, k). Returns a new
    (m, n) row-major tensor; ``c`` is left alone. Real float32/float64/bfloat16."""
    global gemm_tile_launches
    if _same_device("gemm_tile", c, ai, aj):
        return gemm_tile_plain(c, ai, aj)
    _check_gemm_tile(c, ai, aj)
    out = _launch_tile_op("gemm", c, ai, aj)
    gemm_tile_launches += 1
    return out
