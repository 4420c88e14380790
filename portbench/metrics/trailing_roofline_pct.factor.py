"""trailing_roofline_pct.factor: the trailing updates' least time over
their device time, in %. The work is what a factorization at (N, nb, tb)
needs (``roofline.trailing_steps``), counted from shapes, times the
factorizations traced; the time is that of the operations that
``layers/trailing/*.txt`` names."""

from portbench import roofline


def read(run):
    s = run.summary
    ns = s.op_ns(run.patterns("trailing"))
    if not ns or not s.units:
        return None
    c = run.config
    least = roofline.trailing_bound_s(c["n"], c["nb"], c["tb"], c["dtype"], c.get("precision"))
    return 100.0 * least * s.units / (ns / 1e9)
