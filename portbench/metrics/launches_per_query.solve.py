"""launches_per_query.solve: the host's kernel-launch calls in the traced
window (``layers/host_enqueue/*.txt``) over the queries traced."""


def read(run):
    s = run.summary
    n = s.call_count(run.patterns("host_enqueue"))
    return n / s.units if n and s.units else None
