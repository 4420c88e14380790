"""solve_rhs_per_s: the right-hand sides of every query completed in the
window, over the window's seconds."""


def read(run):
    w = run.window
    return sum(w["widths"]) / w["window_s"]
