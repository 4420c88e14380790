"""Packed (triangle-only) column-cyclic distributed POTRF on a flat mesh —
counterpart of ``dla_tpu/parallel/packed_cyclic.py``, in fp32/fp64
(:func:`potrf_packed_cyclic`) and in emulated fp64
(:func:`potrf_packed_cyclic_df64`).

Layout, as in JAX: member d owns global tile columns gcol = lj·D + d
(lj = 0..ltc−1). Its shard stacks one slab per lj, each padded to the
lj-envelope height ``hs(lj) = (nt − lj·D)·nb``, so slab offsets and sizes are
the same on every member. Real data sits at the top of each slab (slab row 0 =
global row gcol·nb); the bottom d·nb padding rows are zero and stay zero. A
sharded triangle is a list of D (R, nb) tensors, member d's the block JAX's
``NamedSharding(mesh, P("d", None))`` puts on device d, so
``torch.cat(shards, dim=0)`` is JAX's global array. Per-member resident memory
is ≈ n²/(2·D). On a mesh across processes a process holds its own members'
shards (None for the others), runs their programs only, and the broadcasts
cross the boundary as in
:func:`~dla_tpu_torch.parallel.column_cyclic.potrf_column_cyclic_ring`.

Per step k, the controller running each member's program in turn on its
card's current stream (one card, or one member per card over NVLink), never
waiting for a card:

1. the owner (kc = k mod D) factors its slab's top nb×nb block and solves the
   rows below;
2. the factor tile and the solved panel ride the ring
   (:func:`~dla_tpu_torch.kernels.collectives.ring_broadcast`, 2·nt − 1
   launches per factorization; the df64 plane stacks hi over lo in one block
   per broadcast);
3. every member updates each of its slabs right of k in full. JAX zero-pads
   the panel to ``(nt−k−1 + D−1)·nb`` rows so that every member's traced
   slice is in bounds and masks the columns ``gcol ≤ k`` to a zero update;
   here a member's product covers the slab's real rows only (its padding
   rows would subtract zero) and a masked column is skipped. Both leave the
   same bits.

The trailing products are ``torch.matmul`` (fp32/fp64) and
:func:`~dla_tpu_torch.ops.df64.df64_matmul_nt` (df64), as they are XLA
products in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from dla_tpu_torch.algos.potrf_df64 import _factor_diag_df64, _panel_solve_df64
from dla_tpu_torch.ops.df64 import df64_matmul_nt, df_sub, slice_rows
from dla_tpu_torch.parallel import member_comm as comm
from dla_tpu_torch.parallel.column_cyclic import (
    FlatMesh,
    _broadcast_from,
    _check,
    _dot_nt,
    _gathered,
    _local_shards,
    _solve_panel,
    _tensor,
)


def _geometry(n: int, nb: int, ndev: int):
    """(nt, ltc, static slab heights, static slab offsets, local rows)."""
    nt = n // nb
    ltc = nt // ndev
    hs = [(nt - lj * ndev) * nb for lj in range(ltc)]
    off = np.concatenate([[0], np.cumsum(hs)]).astype(int)
    return nt, ltc, hs, off


def pack_cols_packed(a, nb: int, mesh: FlatMesh) -> list[torch.Tensor]:
    """Shard a dense (n, n) SPD matrix's lower triangle (tensor or numpy)
    column-cyclically in packed form: one ``(R, nb)`` tensor per member,
    stacking its owned tile columns' below-diagonal rows, zero-padded to the
    lj-envelope heights (None for another process's member)."""
    a = _tensor(a)
    n = a.shape[0]
    ndev = mesh.size
    nt, ltc, hs, off = _geometry(n, nb, ndev)
    shards = []
    for d in range(ndev):
        if not mesh.is_local(d):
            shards.append(None)
            continue
        shard = torch.zeros((int(off[-1]), nb), dtype=a.dtype, device=mesh.devices[d])
        for lj in range(ltc):
            gcol = lj * ndev + d
            blk = a[gcol * nb :, gcol * nb : (gcol + 1) * nb]
            shard[off[lj] : off[lj] + blk.shape[0]] = blk.to(shard.device)
        shards.append(shard)
    return shards


def unpack_cols_packed(shards, n: int, nb: int, mesh: FlatMesh) -> torch.Tensor:
    """Inverse of :func:`pack_cols_packed` → the dense lower triangle, on
    member 0's device (the JAX function gathers it to the host); across
    processes, on every process."""
    ndev = mesh.size
    nt, ltc, hs, off = _geometry(n, nb, ndev)
    shards = _gathered(shards, mesh)
    out = torch.zeros((n, n), dtype=shards[0].dtype, device=shards[0].device)
    for d in range(ndev):
        for lj in range(ltc):
            gcol = lj * ndev + d
            h = (nt - gcol) * nb
            out[gcol * nb :, gcol * nb : (gcol + 1) * nb] = shards[d][off[lj] : off[lj] + h]
    return torch.tril(out)


def _check_packed(n: int, nb: int, mesh, name: str, *planes) -> tuple:
    """(nt, geometry, dtype) once this process's shards of every plane have
    the packed shape."""
    nt = _check(n, nb, mesh, name)
    geo = _geometry(n, nb, mesh.size)
    want = (int(geo[3][-1]), nb)
    firsts = [_local_shards(plane, mesh, want, "packed shards (pack_cols_packed)")
              for plane in planes]
    return nt, geo, firsts[0].dtype


def _live_slabs(k: int, c: int, nb: int, ndev: int, ltc: int):
    """(lj, panel row of the slab's diagonal block, rows of the slab's real
    data) for member c's slabs right of step k."""
    nt = ltc * ndev
    for lj in range(ltc):
        gcol = lj * ndev + c
        if gcol > k:
            yield lj, (gcol - k - 1) * nb, (nt - gcol) * nb


def potrf_packed_cyclic(shards, n: int, nb: int, mesh: FlatMesh) -> list[torch.Tensor]:
    """Distributed POTRF of a packed column-cyclic sharded triangle (see
    :func:`pack_cols_packed`) with ring panel broadcasts. Requires nt = n/nb
    to be a multiple of the mesh size. **Factors in place**: returns the input
    shards, updated, in the same packed layout."""
    x = list(shards)
    nt, (_, ltc, hs, off), dtype = _check_packed(n, nb, mesh, "potrf_packed_cyclic", x)
    ndev = mesh.size
    for k in range(nt):
        kc, ljk = k % ndev, k // ndev
        own, top = (x[kc] if mesh.is_local(kc) else None), int(off[ljk])
        lkk = solved = None
        if own is not None:
            with comm.on(own.device):
                lkk, solved = _solve_panel(own[top : top + nb], own[top + nb : top + hs[ljk]])
                own[top : top + nb] = lkk
        _broadcast_from(kc, lkk, mesh, (nb, nb), dtype)
        if k == nt - 1:
            break
        panel = _broadcast_from(kc, solved, mesh, (hs[ljk] - nb, nb), dtype)
        if own is not None:
            own[top + nb : top + hs[ljk]] = solved
        for c in mesh.local_members():
            with comm.on(x[c].device):
                for lj, op, h in _live_slabs(k, c, nb, ndev, ltc):
                    x[c][off[lj] : off[lj] + h] -= _dot_nt(panel[c][op : op + h],
                                                           panel[c][op : op + nb])
    return x


def potrf_packed_cyclic_df64(
    xh,
    xl,
    n: int,
    nb: int,
    mesh: FlatMesh,
    *,
    s: int = 7,
    w: int = 8,
    precise_deg: int = 3,
    refine: int = 2,
    slice_reuse: bool = True,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Distributed **emulated-fp64** POTRF of a packed column-cyclic sharded
    (hi, lo) fp32 pair, each plane laid out by :func:`pack_cols_packed`. The
    owner factors its diagonal block with the refined df64 Cholesky and
    df64-solves the rows below; the (hi, lo) planes ride the ring stacked into
    one block per broadcast (2·nt − 1 broadcasts at twice the bytes); each
    member slices the received panel once per step (``slice_reuse=True``;
    per-row scaled slices, so row sub-ranges are valid slice sets) or per slab
    from the planes (``False``), then updates its slabs with the compensated
    df64 product. Same shape and mesh constraints as
    :func:`potrf_packed_cyclic`. **Factors in place**: returns the input
    shard lists, updated. Meets the 1e-10 gate."""
    xh, xl = list(xh), list(xl)
    nt, (_, ltc, hs, off), dtype = _check_packed(n, nb, mesh, "potrf_packed_cyclic_df64",
                                                 xh, xl)
    ndev = mesh.size
    gemm_kw = dict(s=s, w=w, precise_deg=precise_deg)
    for k in range(nt):
        kc, ljk = k % ndev, k // ndev
        top, ph = int(off[ljk]), hs[ljk] - nb
        own = mesh.is_local(kc)
        dpair = ppair = None
        if own:
            oh, ol = xh[kc], xl[kc]
            with comm.on(oh.device):
                lkk_h, lkk_l = _factor_diag_df64(oh[top : top + nb], ol[top : top + nb],
                                                 refine=refine, gemm_kw=gemm_kw)
                oh[top : top + nb] = lkk_h
                ol[top : top + nb] = lkk_l
                dpair = torch.cat([lkk_h, lkk_l], dim=0)
        _broadcast_from(kc, dpair, mesh, (2 * nb, nb), dtype)
        if k == nt - 1:
            break
        if own:
            with comm.on(oh.device):
                sol_h, sol_l = _panel_solve_df64(lkk_h, lkk_l, oh[top + nb : top + hs[ljk]],
                                                 ol[top + nb : top + hs[ljk]], refine=refine,
                                                 gemm_kw=gemm_kw)
                ppair = torch.cat([sol_h, sol_l], dim=0)
        pairs = _broadcast_from(kc, ppair, mesh, (2 * ph, nb), dtype)
        if own:
            oh[top + nb : top + hs[ljk]] = sol_h
            ol[top + nb : top + hs[ljk]] = sol_l
        for c in mesh.local_members():
            with comm.on(xh[c].device):
                pan_h, pan_l = pairs[c][:ph], pairs[c][ph:]
                sx = slice_rows(pan_h, pan_l, s=s, w=w)[0] if slice_reuse else None
                for lj, op, h in _live_slabs(k, c, nb, ndev, ltc):
                    if slice_reuse:
                        uh, ul = df64_matmul_nt(None, None, None, None,
                                                slices_a=[sl[op : op + h] for sl in sx],
                                                slices_b=[sl[op : op + nb] for sl in sx],
                                                **gemm_kw)
                    else:
                        uh, ul = df64_matmul_nt(pan_h[op : op + h], pan_l[op : op + h],
                                                pan_h[op : op + nb], pan_l[op : op + nb],
                                                **gemm_kw)
                    rows = slice(int(off[lj]), int(off[lj]) + h)
                    xh[c][rows], xl[c][rows] = df_sub(xh[c][rows], xl[c][rows], uh, ul)
    return xh, xl


def resident_elems(n: int, nb: int, ndev: int) -> tuple[int, int]:
    """(packed-cyclic per-device elements, dense column-cyclic ditto) —
    the memory claim in the module docstring, used by tests and the
    scaling model."""
    _, _, _, off = _geometry(n, nb, ndev)
    return off[-1] * nb, (n // ndev) * n
