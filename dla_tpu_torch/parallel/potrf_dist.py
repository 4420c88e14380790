"""Block-cyclic right-looking POTRF on a p×q member mesh — counterpart of
``dla_tpu/parallel/potrf_dist.py``.

The reference's distributed Cholesky DAG (``client_distrib.cpp:506-565``:
POTRF(k,k) → TRSM(i,k) → SYRK/GEMM(i,j,k)). The JAX package runs it as one
``shard_map`` program per device. Here the members lie on one card or spread
over the cards of one host, and the controller runs each member's program in
turn on its card's current stream, in the JAX program's order (one step of
lookahead), without waiting for any card: the cards overlap. Per panel step
k:

1. **diag factor**: the owner's nb×nb tile reaches every member (a masked
   ``psum`` in JAX, a copy from the one owner here) and is factored once,
   on the owner's card; the factor reaches the cards of mesh column k mod q;
2. **panel solve**: the p members of mesh column k mod q solve their window
   rows of tile column k. In JAX every other member skips it under a
   ``lax.cond``; here it is not run, which leaves the same bits;
3. **panel broadcast**: each mesh row gets its owner's solved rows below
   tile row k (the A operand; a masked ``psum`` over 'c'), and the p row
   blocks are stacked (JAX's ``all_gather`` over 'r'; the B operand), once
   on each card that holds members, with the strips its members' products
   read delivered there by peer copy (:func:`_strips_used`);
4. **trailing update**: per member, per local tile column, one GEMM from
   the static staircase row start, plus the boundary tiles this member's
   staircase needs (``lax.cond`` in JAX, skipped here). A tile column that
   JAX updates with a B operand masked to zero (global column ≤ k) is
   skipped: x − 0 is x. Only a NaN in the panel could tell the two apart
   (0·NaN), and then both factors hold NaN.

The collectives go through :mod:`~dla_tpu_torch.parallel.member_comm`. On a
mesh across processes a process runs only its own members' programs and
holds None for the others' shards: the diagonal tile and each of the p
solved strips reach every process by a broadcast from its owner's process,
and every process factors the diagonal tile from the same bits. The helpers
keep the JAX local programs' (x, layout) arguments and reach the mesh
through ``member_comm.over`` (``placed()`` gives each member's card). On a
mesh across cards every product has the shape it has on one card, on a card
of the same model, so the factor has the one-card mesh's bits. The
products are ``torch.matmul``, accumulated
in fp32 for bf16/fp16 storage and cast once before the subtraction (JAX's
``preferred_element_type``); the factor and solves are ``torch.linalg``
calls. Lower triangle only: tiles
above the staircase hold garbage afterwards, as in JAX. The matrix is
factored **in place**.
"""

from __future__ import annotations

import torch

from dla_tpu_torch.algos.potrf import _cholesky
from dla_tpu_torch.parallel import member_comm as comm
from dla_tpu_torch.parallel.block_cyclic import (
    BlockCyclicLayout,
    MemberMesh,
    _check_shards,
    _members,
)
from dla_tpu_torch.parallel.column_cyclic import _dot_nt


def _below(k: int, r: int, p: int, w0: int) -> int:
    """Tile rows at the top of a window starting at local tile row ``w0``
    that mesh row ``r`` holds at or above global tile row k (masked to zero
    in the panel)."""
    return max(w0, (k - r) // p + 1) - w0


def _dtype(x) -> torch.dtype:
    return next(s for s in x if s is not None).dtype


def _card(m: int) -> torch.device:
    """Member m's card (on another process's member: this process's card)."""
    return comm.placed().device_of(m)


def _diag(x, m: int, rows: slice, cols: slice, nb: int, dtype) -> torch.Tensor:
    """tril(chol) of member m's diagonal tile, which every member receives:
    factored once, on m's card."""
    tile = None if x[m] is None else x[m][rows, cols]
    with comm.on(_card(m)):
        return torch.tril(_cholesky(comm.from_owner(tile, m, (nb, nb), dtype)))


def _deliver(block, src: torch.device, dst: torch.device):
    """``block``, which lies on card ``src``, on card ``dst``: a peer copy
    where the two differ."""
    return block if src == dst else comm.copy_to(block, dst)


def _stacked(strips, owners, uses: dict):
    """The step's stacked panel on each card of ``uses`` ({card: the strips
    its members read}, each card reading at least one): a strip it reads,
    by peer copy where its owner lies on another card; an unwritten block in
    the place of one it never reads."""
    panels = {}
    for card, used in uses.items():
        got = {r: _deliver(strips[r], _card(owners[r]), card) for r in sorted(used)}
        ref = next(iter(got.values()))
        panels[card] = comm.all_gather([got[r] if r in got else ref.new_empty(s.shape)
                                        for r, s in enumerate(strips)])
    return panels


def _panel(lkk: torch.Tensor, cols, owners, k: int, w0: int, nb: int, last: bool, shape,
           uses: dict):
    """Solve mesh column k mod q's window columns ``cols`` (one per mesh row
    r, each ``shape`` from local tile row ``w0``; None where member
    ``owners[r]`` is another process's) below tile row k, each on its owner's
    card with ``lkk`` (the factor, made on the card of the diagonal tile's
    owner ``owners[k mod p]``); return the stacked panel of step k
    (p, window rows, nb) on each card of ``uses`` (:func:`_stacked`): each
    mesh row's owner's solved rows, zero at or above tile row k. None at the
    last step."""
    p = len(cols)
    tops = [_below(k, r, p, w0) * nb for r in range(p)]
    diag_card = _card(owners[k % p])
    for col, top, m in zip(cols, tops, owners):
        if col is not None and col.shape[0]:
            with comm.on(_card(m)):
                solved = torch.linalg.solve_triangular(_deliver(lkk, diag_card, _card(m)).mT,
                                                       col, upper=True, left=False)
                col[top:] = solved[top:]
    if last:
        return None
    strips = []
    for col, top, m in zip(cols, tops, owners):
        blk = comm.from_owner(col, m, shape, lkk.dtype)
        blk[:top] = 0
        strips.append(blk)
    return _stacked(strips, owners, uses)


def _strips_used(layout: BlockCyclicLayout, k: int, columns) -> dict:
    """{card: the panel strips of step k that its members' products read},
    for the cards of this process's members that read any: strip r (the A
    operand) and strip gcol mod p (the B operand) of every product that
    ``columns(r, c)`` gives member (r, c) as (local tile column, products)
    pairs."""
    uses: dict = {}
    for m, r, c in _members(layout):
        for lj, products in columns(r, c):
            if products:
                uses.setdefault(_card(m), set()).update({r, (lj * layout.q + c) % layout.p})
    return uses


def _panel_phase(x, layout: BlockCyclicLayout, k: int):
    """Step k's diagonal factor, panel solve on mesh column k mod q and L_kk
    on its owner; returns the stacked panel (p, window rows, nb) on each card
    whose members update at step k, or None at the last step."""
    nb, p, q = layout.nb, layout.p, layout.q
    kr, kc, lik, ljk = k % p, k % q, k // p, k // q
    w0 = (k + 1) // p
    cols = slice(ljk * nb, (ljk + 1) * nb)
    rows = slice(lik * nb, (lik + 1) * nb)
    lkk = _diag(x, kr * q + kc, rows, cols, nb, _dtype(x))
    owners = [r * q + kc for r in range(p)]
    uses = _strips_used(layout, k, lambda r, c: (
        (lj, _trail_products(r, c, k, lj, layout)) for lj in range((k + 1) // q, layout.ltc)))
    panel = _panel(lkk, [None if x[m] is None else x[m][w0 * nb :, cols] for m in owners],
                   owners, k, w0, nb, k == layout.ntiles - 1, ((layout.ltr - w0) * nb, nb),
                   uses)
    # the diagonal tile row may sit above the window start: L_kk on its owner
    if x[kr * q + kc] is not None:
        x[kr * q + kc][rows, cols] = lkk
    return panel


def _trail_products(r: int, c: int, k: int, lj: int, layout: BlockCyclicLayout) -> list:
    """The products of step k's exact-staircase update of member (r, c)'s
    local tile column lj, as [first, last) local tile rows: one tall GEMM
    from the row every member needs, rs_sure = ceil((lj·q + q−1)/p), then the
    boundary tiles from rs_min = floor(lj·q/p) that this member's staircase
    li·p + r ≥ lj·q + c needs."""
    p, q, ltr = layout.p, layout.q, layout.ltr
    w0 = (k + 1) // p
    rs_min = max(w0, (lj * q) // p)
    rs_sure = max(w0, -(-(lj * q + q - 1) // p))
    gcol = lj * q + c
    if rs_min >= ltr or gcol <= k:
        return []
    products = [(rs_sure, ltr)] if rs_sure < ltr else []
    return products + [(li, li + 1) for li in range(rs_min, min(rs_sure, ltr))
                       if li * p + r >= gcol]


def _trail_column(xm: torch.Tensor, r: int, c: int, k: int, lj: int, panels: dict,
                  layout: BlockCyclicLayout) -> None:
    """Step k's update of member (r, c)'s local tile column lj
    (:func:`_trail_products`), with the step's panel on the member's card
    (``panels``: card -> panel), on that card."""
    products = _trail_products(r, c, k, lj, layout)
    if not products:
        return
    nb, p, q = layout.nb, layout.p, layout.q
    panel = panels[_card(r * q + c)]
    w0 = (k + 1) // p
    gcol = lj * q + c
    m0 = (gcol // p - w0) * nb
    b = panel[gcol % p, m0 : m0 + nb]  # B operand: the panel tile row of global tile gcol
    a_op = panel[r]
    cols = slice(lj * nb, (lj + 1) * nb)
    for l0, l1 in products:
        xm[l0 * nb : l1 * nb, cols] -= _dot_nt(a_op[(l0 - w0) * nb : (l1 - w0) * nb], b)


def _potrf_unrolled(x, layout: BlockCyclicLayout) -> None:
    """Every panel step with static shrinking windows (``_potrf_local``):
    the trailing update of step k touches the panel-(k+1) column first, then
    panel k+1 is factored, solved and broadcast, then the rest of step k."""
    q, ltc, nt = layout.q, layout.ltc, layout.ntiles
    panel = _panel_phase(x, layout, 0)
    for k in range(nt - 1):
        lj_next = (k + 1) // q  # local tile column holding global column k+1
        for m, r, c in _members(layout):
            with comm.on(_card(m)):
                _trail_column(x[m], r, c, k, lj_next, panel, layout)
        nxt = _panel_phase(x, layout, k + 1)  # lookahead
        for m, r, c in _members(layout):
            with comm.on(_card(m)):
                for lj in range(lj_next + 1, ltc):
                    _trail_column(x[m], r, c, k, lj, panel, layout)
        panel = nxt


def _window_columns(layout: BlockCyclicLayout, k: int, c: int, wr: int, wc: int, li0: int,
                    lj0: int):
    """(window tile column, first window row) of member column c's updates
    at step k of a window from local tile (li0, lj0) with wr rows and wc
    columns: one GEMM per column from the static staircase start
    ``max(li0, (gj·q)//p)``."""
    nb, p, q = layout.nb, layout.p, layout.q
    for lj in range(wc // nb):
        lj_abs = lj + lj0
        row0 = (max(li0, (lj_abs * q) // p) - li0) * nb
        if row0 < wr and lj_abs * q + c > k:
            yield lj, row0


def _fori_window(sub, layout: BlockCyclicLayout, k0: int, k1: int, li0: int, lj0: int) -> None:
    """Panel steps k ∈ [k0, k1) on the window of every member from local
    tile (li0, lj0) (``_fori_window``): the diagonal tile factored once (JAX
    factors it on every device, from the same bits), the full window column
    solved on mesh column k mod q, and per window tile column one GEMM from
    the static staircase start ``max(li0, (gj·q)//p)``, the rows at or above
    tile row k masked to zero in the A operand."""
    nb, p, q = layout.nb, layout.p, layout.q
    wr, wc = next(s for s in sub if s is not None).shape
    dtype = _dtype(sub)
    for k in range(k0, k1):
        kr, kc = k % p, k % q
        lik, ljk = k // p - li0, k // q - lj0  # window-local tile coordinates
        cols = slice(ljk * nb, (ljk + 1) * nb)
        rows = slice(lik * nb, (lik + 1) * nb)
        lkk = _diag(sub, kr * q + kc, rows, cols, nb, dtype)
        owners = [r * q + kc for r in range(p)]
        uses = _strips_used(layout, k, lambda r, c: (
            (lj + lj0, [row0]) for lj, row0 in _window_columns(layout, k, c, wr, wc, li0, lj0)))
        panel = _panel(lkk, [None if sub[m] is None else sub[m][:, cols] for m in owners],
                       owners, k, li0, nb, False, (wr, nb), uses)
        if sub[kr * q + kc] is not None:
            sub[kr * q + kc][rows, cols] = lkk
        for m, r, c in _members(layout):
            pm = panel.get(_card(m))
            with comm.on(_card(m)):
                for lj, row0 in _window_columns(layout, k, c, wr, wc, li0, lj0):
                    gcol = (lj + lj0) * q + c
                    m0 = (gcol // p - li0) * nb
                    sub[m][row0:, lj * nb : (lj + 1) * nb] -= _dot_nt(pm[r][row0:],
                                                                      pm[gcol % p, m0 : m0 + nb])


def _potrf_super(x, layout: BlockCyclicLayout, super_steps: int) -> None:
    """Segments of ``super_steps`` panel steps (``_potrf_local_super``); before
    each, the dead leading tile rows and columns are cut off (local tile row
    li is finished on every member once li·p + p − 1 < k)."""
    nb, p, q, nt = layout.nb, layout.p, layout.q, layout.ntiles
    for s0 in range(0, nt, super_steps):
        li0, lj0 = s0 // p, s0 // q
        sub = [None if xm is None else xm[li0 * nb :, lj0 * nb :] for xm in x]
        _fori_window(sub, layout, s0, min(nt, s0 + super_steps), li0, lj0)


def potrf_block_cyclic(
    shards,
    layout: BlockCyclicLayout,
    mesh: MemberMesh,
    *,
    unroll: bool | None = None,
    super_steps: int | None = None,
) -> list[torch.Tensor]:
    """Distributed POTRF of a block-cyclic sharded matrix (see
    :func:`~dla_tpu_torch.parallel.block_cyclic.from_dense`). **Factors in
    place**: the returned list holds the input shards, updated (JAX returns
    new arrays in the same layout). Only lower-triangle tiles are
    meaningful.

    ``unroll=None`` picks the unrolled program (the true flop count, static
    shrinking windows) for ≤ 64 tile steps and the super-stepped program
    beyond (windows cut every ``super_steps`` panels, by default sized so
    that there are ≤ 32 segments), as JAX does. On a mesh across processes
    each process factors its own members' shards (the list holds None for
    the others), with the bits of the one-process program."""
    x = _check_shards(shards, layout, mesh)
    if unroll is None:
        unroll = layout.ntiles <= 64
    if super_steps is None:
        super_steps = max(1, -(-layout.ntiles // 32))
    with comm.over(mesh):
        if unroll:
            _potrf_unrolled(x, layout)
        else:
            _potrf_super(x, layout, super_steps)
    return x


def flop_accounting(layout: BlockCyclicLayout, *, per_step: bool = False):
    """Executed-flop accounting of the unrolled program's static geometry —
    a copy of the JAX package's (``potrf_dist.py:203``): the diagonal factor
    and window-sliced panel solve on the p members of mesh column kc, the
    staircase trailing envelope ``rs = max(w0, (lj·q)//p)`` and the boundary
    tiles each member's staircase needs. Totals across all p·q members, in
    flops, with the ideal N³/3 and the ratio."""
    nt, nb, p, q = layout.ntiles, layout.nb, layout.p, layout.q
    ltr, ltc = layout.ltr, layout.ltc
    chol = solve = trail = 0
    comm_elems = 0
    steps = []
    for k in range(nt):
        w0 = (k + 1) // p
        lj0 = (k + 1) // q
        s_chol = p * nb**3 / 3  # cond: only column kc's p devices factor
        s_solve = p * (ltr - w0) * nb * nb**2
        s_trail = 0
        for lj in range(lj0, ltc):
            rs_min = max(w0, (lj * q) // p)
            rs_sure = max(w0, -(-(lj * q + q - 1) // p))
            if rs_min >= ltr:
                continue
            # interior GEMM: every device computes rows [rs_sure, ltr)
            s_trail += p * q * (ltr - min(rs_sure, ltr)) * 2 * nb**3
            # boundary tiles: executed only where the true staircase
            # predicate li·p + r ≥ lj·q + c holds
            for li in range(rs_min, min(rs_sure, ltr)):
                for r in range(p):
                    for cdev in range(q):
                        if li * p + r >= lj * q + cdev:
                            s_trail += 2 * nb**3
        chol += s_chol
        solve += s_solve
        trail += s_trail
        # psum of the window panel over 'c' + all_gather over 'r'
        comm_elems += (ltr - w0) * nb * nb * (q + p)
        if per_step:
            steps.append(
                {"k": k, "chol": s_chol, "solve": s_solve, "trail": s_trail}
            )
    n = layout.n
    ideal = n**3 / 3
    executed = chol + solve + trail
    out = {
        "chol": chol,
        "solve": solve,
        "trail": trail,
        "executed": executed,
        "ideal": ideal,
        "ratio": executed / ideal,
        "comm_elems": comm_elems,
    }
    if per_step:
        out["steps"] = steps
    return out


def flop_accounting_super(
    layout: BlockCyclicLayout, super_steps: int, *, per_step: bool = False
):
    """Executed-flop accounting of the super-stepped program's geometry — a
    copy of the JAX package's (``potrf_dist.py:263``): the diagonal factor on
    every device (the JAX program's count; the port factors it once), the
    full-window-column solve on mesh column kc, and per window tile column
    the staircase area from ``max(li0, (gj·q)//p)``, with the boundary band
    and the within-segment shrink slack."""
    nt, nb, p, q = layout.ntiles, layout.nb, layout.p, layout.q
    ltr, ltc = layout.ltr, layout.ltc
    chol = solve = trail = 0
    comm_elems = 0
    steps = []
    for s0 in range(0, nt, super_steps):
        s1 = min(nt, s0 + super_steps)
        li0, lj0 = s0 // p, s0 // q
        wr = (ltr - li0) * nb
        for k in range(s0, s1):
            s_chol = p * q * nb**3 / 3
            s_solve = p * wr * nb**2  # cond-gated to column kc's p devices
            s_trail = 0
            for lj in range(ltc - lj0):
                row0 = (max(li0, ((lj + lj0) * q) // p) - li0) * nb
                if row0 >= wr:
                    continue
                s_trail += p * q * 2 * (wr - row0) * nb * nb
            chol += s_chol
            solve += s_solve
            trail += s_trail
            comm_elems += wr * nb * (q + p)
            if per_step:
                steps.append(
                    {"k": k, "chol": s_chol, "solve": s_solve, "trail": s_trail}
                )
    n = layout.n
    ideal = n**3 / 3
    executed = chol + solve + trail
    out = {
        "chol": chol,
        "solve": solve,
        "trail": trail,
        "executed": executed,
        "ideal": ideal,
        "ratio": executed / ideal,
        "comm_elems": comm_elems,
    }
    if per_step:
        out["steps"] = steps
    return out
