"""The yardstick's arithmetic: the operations and bytes that a layer's work
needs, counted from its shapes, and the card's published peaks.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit — bf16 tensor
cores 989 TFLOP/s, fp64 and IEEE fp32 outside the tensor cores 67 TFLOP/s,
HBM3 3.35 TB/s. fp32 ``high`` is three bf16 products (bf16x3, the
program's trailing kernel), so 989/3; ``default`` one. Copied from the
program's ``utils/profiling.py`` table, which a later change may delete.
A factorization counts (1/3)·N³ (the reference's ``v6_test.c:60``).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP64_FLOPS = 67e12
FP32_FLOPS = 67e12
ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2}


def peak_flops(dtype: str, precision: str | None = None) -> float:
    if dtype == "float64":
        return FP64_FLOPS
    if dtype == "bfloat16":
        return BF16_FLOPS
    return {"high": BF16_FLOPS / 3, "default": BF16_FLOPS}.get(precision or "highest", FP32_FLOPS)


def potrf_flops(n: int) -> float:
    return n**3 / 3.0


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """The least time of one call: the larger of its operations over the
    peak and its bytes over HBM's bandwidth."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def trailing_steps(n: int, nb: int, tb: int, itemsize: int):
    """(flops, bytes) of each trailing update of a right-looking factor with
    nb-wide panels, updating the trailing matrix's lower triangle over its
    tb-tiles (the tiles below the diagonal whole, the diagonal tiles' lower
    triangles): 2·nb flops an element updated; the panel (m × nb) read once
    and the updated elements read and written once."""
    for k in range(n // nb - 1):
        m = n - (k + 1) * nb
        t = m // tb
        elems = tb * tb * t * (t - 1) // 2 + t * tb * (tb + 1) // 2
        yield 2.0 * nb * elems, itemsize * (m * nb + 2 * elems)


def trailing_bound_s(n: int, nb: int, tb: int, dtype: str, precision: str | None) -> float:
    """The least time of one factorization's trailing updates."""
    peak = peak_flops(dtype, precision)
    return sum(bound_s(f, b, peak) for f, b in trailing_steps(n, nb, tb, ITEMSIZE[dtype]))


def solve_work(n: int, nrhs: int, itemsize: int) -> tuple:
    """(flops, bytes) of one query: two triangular solves, 2·n²·nrhs flops;
    L's lower triangle read once for each, B read and X written."""
    return 2.0 * n * n * nrhs, itemsize * (n * (n + 1) + 2 * n * nrhs)


def solve_bound_s(n: int, nrhs: int, dtype: str) -> float:
    f, b = solve_work(n, nrhs, ITEMSIZE[dtype])
    return bound_s(f, b, peak_flops(dtype))
