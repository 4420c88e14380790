"""Distributed POTRS on the block-cyclic layout — counterpart of
``dla_tpu/parallel/solve_dist.py``: the full-solve path after
:func:`~dla_tpu_torch.parallel.potrf_dist.potrf_block_cyclic`.

Given the factor L as block-cyclic shards and a replicated right-hand-side
block B (n × nrhs), A·X = B is solved by forward then backward substitution
over tile rows:

- the diagonal tile comes from its one owner (a masked ``psum`` in JAX);
- forward, each off-diagonal update ``B_i −= L_ik · Y_k`` is computed by the
  single owner of tile (i, k) (mesh column k mod q). JAX sums them into the
  replicated right-hand side with one ``psum`` over the mesh; every row has
  one owner, so that sum adds zeros only and the owner's rows are
  subtracted here directly, with the same bits;
- backward, ``Σ_{i>k} L_ikᵀ · X_i`` adds the parts of the p members of mesh
  column k mod q: a ``psum`` of several nonzero parts, added here in member
  order (:func:`~dla_tpu_torch.parallel.member_comm.psum`), perhaps in
  another order than XLA's.

The right-hand side stays replicated on every member: one tensor on each card
that holds members, each card applying every update itself, in the same
order, so every copy has the same bits. A block computed on one card reaches
the others by peer copy. Only tril of the factor tiles is read.

On a mesh across processes (``member_comm.over``) each process holds the
whole right-hand side and only its own members' factor shards. The owner of
each product sends it to every process by broadcast
(:func:`~dla_tpu_torch.parallel.member_comm.share`) and every process applies
the same updates in the same order: the bits of one process.
"""

from __future__ import annotations

import torch

from dla_tpu_torch.parallel import member_comm as comm
from dla_tpu_torch.parallel.block_cyclic import BlockCyclicLayout, MemberMesh, _check_shards
from dla_tpu_torch.parallel.column_cyclic import _tensor
from dla_tpu_torch.parallel.potrf_dist import _deliver


def potrs_block_cyclic(lx, b, layout: BlockCyclicLayout, mesh: MemberMesh) -> torch.Tensor:
    """Solve A·X = B given the block-cyclic factor ``lx`` (a list of shards);
    ``b`` is an (n, nrhs) tensor or numpy array, replicated onto every card
    of this process's members. Returns the replicated solution X on member
    0's device (this process's first member's), in the factor's dtype."""
    lx = _check_shards(lx, layout, mesh)
    nb, p, q, ltr, nt = layout.nb, layout.p, layout.q, layout.ltr, layout.ntiles
    dtype = next(s for s in lx if s is not None).dtype
    b = _tensor(b)
    if b.ndim != 2 or b.shape[0] != layout.n:
        raise ValueError(f"b must be ({layout.n}, nrhs), got {tuple(b.shape)}")
    nrhs = b.shape[1]
    b = b.to(dtype=dtype, copy=True)
    cards = comm.cards_of(mesh.device_of(m) for m in mesh.local_members())
    ys = {card: _deliver(b, b.device, card) for card in cards}
    yts = {card: y.view(ltr, p, nb, nrhs) for card, y in ys.items()}  # tile li·p + r at [li, r]

    def diag(k):
        """(the diagonal tile of step k, its owner's card)."""
        lik, ljk = k // p, k // q
        m = (k % p) * q + k % q
        tile = None if lx[m] is None else lx[m][lik * nb : (lik + 1) * nb,
                                               ljk * nb : (ljk + 1) * nb]
        return comm.from_owner(tile, m, (nb, nb), dtype), mesh.device_of(m)

    def strips(k):
        """(r, first local tile row below k, owner, L rows below tile row k or
        None on another process) of mesh column k mod q's members, the owners
        of tile column k."""
        ljk = k // q
        for r in range(p):
            li0 = max(0, (k - r) // p + 1)
            m = r * q + k % q
            if li0 < ltr:
                yield r, li0, m, (None if lx[m] is None
                                  else lx[m][li0 * nb :, ljk * nb : (ljk + 1) * nb])

    def owned(m, strip, fn, shape):
        """``fn`` of the owner's strip on its card, on every process."""
        part = None
        if strip is not None:
            with comm.on(mesh.device_of(m)):
                part = fn(strip, ys[mesh.device_of(m)])
        return comm.share(part, m, shape, dtype), mesh.device_of(m)

    with comm.over(mesh):
        # ---- forward: L Y = B ----------------------------------------------
        for k in range(nt):
            rows = slice(k * nb, (k + 1) * nb)
            lkk, src = diag(k)
            for card, y in ys.items():  # every card solves its own copy, in the same order
                with comm.on(card):
                    y[rows] = torch.linalg.solve_triangular(_deliver(lkk, src, card), y[rows],
                                                            upper=False, left=True)
            for r, li0, m, strip in strips(k):
                upd, src = owned(m, strip, lambda s, y: s @ y[rows], ((ltr - li0) * nb, nrhs))
                for card, yt in yts.items():
                    with comm.on(card):
                        yt[li0:, r] -= _deliver(upd, src, card).view(-1, nb, nrhs)

        # ---- backward: Lᵀ X = Y --------------------------------------------
        for k in reversed(range(nt)):
            rows = slice(k * nb, (k + 1) * nb)
            parts = [owned(m, strip, lambda s, y: s.mT @ y.view(ltr, p, nb, nrhs)[li0:, r]
                           .reshape(-1, nrhs), (nb, nrhs))
                     for r, li0, m, strip in strips(k)]
            lkk, src = diag(k)
            for card, y in ys.items():
                with comm.on(card):
                    s = (comm.psum([_deliver(t, ts, card) for t, ts in parts]) if parts
                         else torch.zeros_like(y[rows]))
                    y[rows] = torch.linalg.solve_triangular(_deliver(lkk, src, card).mT,
                                                            y[rows] - s, upper=True, left=True)
    return ys[cards[0]]
