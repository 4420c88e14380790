"""The share of the traced window in which no operation ran on the device,
in %: the mean over the cell's cards of each card's idle share."""


def read(run):
    idle = run.summary.idle_share()
    return None if idle is None else 100.0 * idle
