"""Accounting of the distributed planes — the framework-neutral half of
``dla_tpu/parallel/model.py`` (``:208``, ``:365``, ``:531-619``), copied.

The JAX module also projects rates onto TPU meshes (``ChipSpec``, ``CHIPS``,
``project``, ``crossover_n``, ``single_chip_rate``, every ``project_*``);
those are TPU figures and are not ported. What stays is the exact count of
the work and of the traffic: the packed column-cyclic plane's ring
broadcasts (which the tests pin to the real program's ``ring_broadcast``
calls), the block-cyclic plane's per-step panel broadcast
(:func:`step_comm_elems`) and the out-of-core loop's volumes
(:func:`oocore_volumes`).
"""

from __future__ import annotations


def packed_cyclic_accounting(n: int, nb: int, ndev: int) -> dict:
    """Exact per-step executed flops and ring-broadcast element volumes of
    ``packed_cyclic._potrf_local_packed`` (same geometry helpers)."""
    nt = n // nb
    if n % nb or nt % ndev:
        raise ValueError("need nb | n and ndev | nt")
    ltc = nt // ndev
    hs = [(nt - lj * ndev) * nb for lj in range(ltc)]
    steps = []
    exec_total = 0.0
    for k in range(nt):
        ljk = k // ndev
        chol = nb**3 / 3.0
        solve_rows = hs[ljk] - nb
        solve = float(solve_rows) * nb * nb
        # two broadcasts: the nb×nb factor tile always; the solved panel
        # except after the last step
        bcast = nb * nb + (solve_rows * nb if k < nt - 1 else 0)
        # trailing: every device executes 2·hs[lj]·nb² for each slab group
        # lj that has ANY live column (lj·D + D−1 > k); dead lanes are
        # where-masked but still executed (SPMD)
        trail_dev = 0.0
        if k < nt - 1:
            for lj in range(ltc):
                if lj * ndev + ndev - 1 <= k:
                    continue
                trail_dev += 2.0 * hs[lj] * nb * nb
        steps.append({
            "k": k, "chol": chol, "solve": solve,
            "bcast_elems": bcast, "trail_per_dev": trail_dev,
            # the two ring broadcasts' row counts — the time law needs the
            # buffer geometry, not just the volume (chunk count is a
            # function of rows)
            "bcast_rows": (nb, solve_rows if k < nt - 1 else 0),
        })
        # exec_total is the CRITICAL-PATH convention for the factor/solve
        # terms (charged once — under shard_map the lax.cond(own, ...)
        # non-owners wait on the broadcast regardless, so duplicated
        # execution would not change wall time) and the SPMD-executed
        # convention for the trailing term (masked lanes still execute
        # identical shapes — ×ndev is real work).
        exec_total += chol + solve + trail_dev * ndev
    ideal = n**3 / 3.0
    return {
        "n": n, "nb": nb, "ndev": ndev, "steps": steps,
        "executed": exec_total, "ideal": ideal,
        "ratio": exec_total / ideal,
        "bcast_elems_total": sum(s["bcast_elems"] for s in steps),
    }


def packed_resident_bytes(n: int, nb: int, ndev: int,
                          itemsize: int = 4) -> int:
    """Per-device resident bytes of the packed column-cyclic layout
    (envelope-padded slabs — the exact `resident_elems` sum)."""
    nt = n // nb
    ltc = nt // ndev
    return sum((nt - lj * ndev) * nb for lj in range(ltc)) * nb * itemsize


def step_comm_elems(layout, k: int) -> int:
    """Panel-broadcast volume of step k in elements — mirrors
    ``flop_accounting``'s aggregate ``(ltr-w0)·nb²·(q+p)`` term (a copy of
    ``dla_tpu/parallel/model.py:208``)."""
    w0 = (k + 1) // layout.p
    return (layout.ltr - w0) * layout.nb * layout.nb * (layout.q + layout.p)


def oocore_volumes(n: int, panel: int, itemsize: int = 4) -> dict:
    """Exact stream/compute/writeback volumes of the left-looking
    out-of-core loop (a copy of ``dla_tpu/parallel/model.py:365``).

    stream = the k-panel updates (h·jB per panel) **plus the panel's own
    one-time read** (h·B)."""
    nt = -(-n // panel)
    stream_elems = sum(
        (n - j * panel) * (j * panel + panel) for j in range(nt)
    )
    wb_elems = sum((n - j * panel) * panel for j in range(nt))
    return {
        "n": n, "panel": panel, "npanels": nt,
        "stream_bytes": stream_elems * itemsize,
        "writeback_bytes": wb_elems * itemsize,
        "flops": n**3 / 3,
    }
