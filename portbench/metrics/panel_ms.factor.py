"""panel_ms.factor: device ms a factorization in the panel's operations
(the diagonal factor, the panel's triangular solves and products, their
copies), as ``layers/panel/*.txt`` names them."""


def read(run):
    s = run.summary
    ns = s.op_ns(run.patterns("panel"))
    if not ns or not s.units:
        return None
    return ns / 1e6 / s.units
