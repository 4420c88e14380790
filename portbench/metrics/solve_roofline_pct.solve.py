"""solve_roofline_pct.solve: the traced queries' least time over all the
device's time in the traced window, in %. Each query's work is its two
triangular solves (``roofline.solve_work``), counted from its width."""

from portbench import roofline


def read(run):
    s = run.summary
    busy = s.busy_s() * len(s.devices)
    if not busy or not s.widths:
        return None
    c = run.config
    least = sum(roofline.solve_bound_s(c["n"], w, c["dtype"]) for w in s.widths)
    return 100.0 * least / busy
