"""Double-word fp32 ("df64") arithmetic and an exact-sliced GEMM — counterpart
of ``dla_tpu/ops/df64.py``.

A df64 matrix is a pair ``(hi, lo)`` of fp32 tensors with ``|lo| ≤ ulp(hi)/2``,
about 49 significant bits (Dekker 1971). The error-free transforms below give
add, mul, div and sqrt correct to about 2⁻⁴⁸ relative. :func:`df64_matmul_nt`
is the Ozaki-style product: each df64 row is cut into ``s`` bf16 slices of
``w`` significant bits on a per-row power-of-2 grid, so every slice product is
exact in fp32, and so is every sum of up to ``max_exact_chunk(w)`` of them, in
any order. The high-significance pairs (i + j ≤ ``precise_deg``) are summed
chunk by chunk with compensated adds; the others in plain fp32.

Every function here runs as separate eager torch ops, and must stay so: a
fused kernel (``torch.compile``, a hand-written elementwise kernel compiled
with contraction on) may turn ``a*b + c`` into an FMA and break ``two_prod``,
``split32`` and the compensated sums. The products go through
:func:`_dot_nt_bf16`, an fp32 ``torch.matmul`` of the upcast slices: the
package pins TF32 off on import, and an fp32 product of these slices is exact.
Subnormal-range data loses the guarantee, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from dla_tpu_torch.ops.lapack_like import _sqrt_rn

_F32 = torch.float32


# ---------------------------------------------------------------------------
# Error-free transformations (elementwise)
# ---------------------------------------------------------------------------


def two_sum(a, b):
    """Knuth two-sum: s + e == a + b exactly, s = fl(a + b)."""
    s = a + b
    v = s - a  # the part of b that made it into s
    e = (a - (s - v)) + (b - v)
    return s, e


def quick_two_sum(a, b):
    """Fast two-sum valid when |a| >= |b| (renormalization step)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split32(a):
    """Dekker split of fp32 into two 12-bit halves (no FMA needed)."""
    c = a * 4097.0  # 2**12 + 1
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """p + e == a * b exactly, p = fl(a * b) (Dekker, fp32)."""
    p = a * b
    ah, al = split32(a)
    bh, bl = split32(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# ---------------------------------------------------------------------------
# df64 elementwise arithmetic on (hi, lo) pairs
# ---------------------------------------------------------------------------


def df_renorm(h, l):
    return quick_two_sum(h, l)


def df_add(xh, xl, yh, yl):
    """Accurate (IEEE-style) double-word add: stays relatively accurate under
    cancellation."""
    sh, se = two_sum(xh, yh)
    th, te = two_sum(xl, yl)
    se = se + th
    sh, se = quick_two_sum(sh, se)
    se = se + te
    return quick_two_sum(sh, se)


def df_neg(xh, xl):
    return -xh, -xl


def df_sub(xh, xl, yh, yl):
    return df_add(xh, xl, -yh, -yl)


def df_add_f32(xh, xl, y):
    s, e = two_sum(xh, y)
    e = e + xl
    return quick_two_sum(s, e)


def df_mul(xh, xl, yh, yl):
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return quick_two_sum(p, e)


def df_div(xh, xl, yh, yl):
    q1 = xh / yh
    # r = x - q1*y, in df64
    ph, pl = df_mul(q1, torch.zeros_like(q1), yh, yl)
    rh, rl = df_sub(xh, xl, ph, pl)
    q2 = rh / yh
    ph, pl = df_mul(q2, torch.zeros_like(q2), yh, yl)
    rh, rl = df_sub(rh, rl, ph, pl)
    q3 = rh / yh
    s, e = quick_two_sum(q1, q2)
    return quick_two_sum(s, e + q3)


def df_sqrt(xh, xl):
    """One df64 Newton step from the fp32 sqrt (doubles the precision)."""
    s = _sqrt_rn(xh)
    safe = torch.where(s > 0, s, 1.0)
    ph, pl = two_prod(safe, safe)
    rh, rl = df_sub(xh, xl, ph, pl)
    corr = rh / (2.0 * safe)
    h, l = quick_two_sum(safe, corr)
    zero = xh <= 0
    return torch.where(zero, 0.0, h), torch.where(zero, 0.0, l)


def to_df64(a64, *, device=None):
    """Split an fp64 matrix into its (hi, lo) fp32 pair. ``a64`` is a numpy
    array (or anything ``np.asarray`` takes), split on the host and copied to
    ``device``, the card unless the caller names another (``device="cpu"``);
    or an fp64 tensor, split where it lies (``device`` moves the pair). The
    split is exact either way."""
    if isinstance(a64, torch.Tensor):
        a = a64.to(torch.float64)
        hi = a.to(_F32)
        lo = (a - hi.to(torch.float64)).to(_F32)
        return hi.to(device or a.device), lo.to(device or a.device)
    device = device or "cuda"
    a = np.asarray(a64, np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device)


def from_df64(h, l, dtype=torch.float64):
    """Recombine to a wide dtype (exact for fp64)."""
    return h.to(dtype) + l.to(dtype)


# ---------------------------------------------------------------------------
# Ozaki-style slicing: df64 rows -> S exact bf16 slices on a 2^k grid
# ---------------------------------------------------------------------------


def _pow2_ceil(x):
    """Smallest power of two >= x (x > 0), elementwise, from the exponent
    bits (int32 shifts work in torch, unlike uint32 ones)."""
    bits = x.to(_F32).view(torch.int32)
    exp = (bits >> 23) & 0xFF
    frac = bits & 0x7FFFFF
    # x = f * 2^(exp-127), 1 <= f < 2; ceil to 2^(exp-127+1) unless f == 1
    exp = torch.where(frac == 0, exp, exp + 1)
    return (exp << 23).view(_F32)


def slice_rows(ah, al, *, s: int = 6, w: int = 8):
    """Slice a df64 matrix row-wise into ``s`` bf16 matrices of ``w``-bit
    mantissas on a shared per-row power-of-2 grid.

    Returns (slices, mu): ``slices`` is a list of s bf16 tensors whose fp32
    values are EXACT (each a multiple of its grid with ≤ w significant bits);
    ``mu`` the (rows, 1) fp32 per-row scale. Σ slices reproduces hi+lo to
    ≤ mu·2^(−s·w) per element.
    """
    amax = ah.abs().amax(dim=1, keepdim=True)
    mu = torch.where(amax > 0, _pow2_ceil(amax.clamp_min(1e-38)), 1.0)
    rh, rl = ah, al
    out = []
    for t in range(s):
        # grid g_t = mu * 2^(-(t+1)w + 1); sigma = 1.5 * 2^23 * g_t forces
        # round-to-nearest onto that grid for |r| < sigma/2
        g = mu * (2.0 ** (-(t + 1) * w + 1))
        sigma = (1.5 * 2.0**23) * g
        st = (rh + sigma) - sigma
        out.append(st.to(torch.bfloat16))
        # exact df64 subtraction of the captured slice
        rh, rl = df_add(rh, rl, -st, torch.zeros_like(st))
    return out, mu


def max_exact_chunk(w: int = 8) -> int:
    """Largest contraction-chunk length whose fp32 accumulation of slice
    products is EXACT: products are multiples of g_s·g_t with magnitude
    ≤ 2^(2w−2)·g_s·g_t, so c·2^(2w−2) ≤ 2^24 → c = 2^(26−2w)."""
    return 2 ** (26 - 2 * w)


def _dot_nt_bf16(a, b):
    """(m,k) · (n,k)ᵀ → (m,n) fp32 from bf16-valued operands: an fp32 matmul
    of the upcast slices (TF32 is off). A bf16 ``@`` would return bf16 and
    lose the exactness."""
    return a.to(_F32) @ b.to(_F32).mT


def df64_matmul_nt(
    ah, al, bh, bl, *,
    s: int = 6, w: int = 8, precise_deg: int = 3,
    chunk: int | None = None,
    slices_a=None, slices_b=None,
):
    """C = A · Bᵀ with ~2⁻⁴⁴-grade accuracy from fp32 products.

    ``a``: (m, k) df64 pair, ``b``: (n, k) df64 pair → (Ch, Cl) (m, n).

    Slice pairs (i, j) with i+j ≥ s are dropped (< 2^(−s·w) relative); pairs
    with i+j ≤ ``precise_deg`` accumulate chunk-exactly with compensated adds;
    the rest add their exact chunk products into the lo plane in plain fp32,
    so the result does not depend on the order of a library's sums: the CPU
    and the card give the same bits. ``slices_a/_b`` accept pre-sliced
    operands (a POTRF panel is sliced once and used on both sides of its
    trailing update); the operand pair may then be None.
    """
    if chunk is None:
        chunk = max_exact_chunk(w)
    sa = slice_rows(ah, al, s=s, w=w)[0] if slices_a is None else slices_a
    sb = slice_rows(bh, bl, s=s, w=w)[0] if slices_b is None else slices_b
    fa = [x.to(_F32) for x in sa]  # upcast once; every product below is fp32
    fb = [x.to(_F32) for x in sb]
    k = fa[0].shape[-1]
    ch = torch.zeros((fa[0].shape[0], fb[0].shape[0]), dtype=_F32, device=fa[0].device)
    cl = torch.zeros_like(ch)

    # precise pairs: chunked exact partials, compensated accumulation
    for lo in range(0, k, chunk):
        hi = min(lo + chunk, k)
        for i in range(s):
            for j in range(s - i):
                if i + j > precise_deg:
                    continue
                p = _dot_nt_bf16(fa[i][:, lo:hi], fb[j][:, lo:hi])
                ch, e = two_sum(ch, p)
                cl = cl + e

    # low-significance pairs: plain fp32 accumulation in cl, of one exact
    # product per chunk. (The reference takes one full-K product per pair and
    # leaves its rounding to the backend; on the H100, cuBLAS's fp32 chains
    # over K = n put the blocked gate at 2.05e-10 for an N=24576 factor whose
    # exact-chunk value is ~4e-11.) With k ≤ chunk this is the reference's
    # arithmetic exactly.
    for i in range(s):
        for j in range(s - i):
            if i + j <= precise_deg:
                continue
            for lo in range(0, k, chunk):
                cl = cl + _dot_nt_bf16(fa[i][:, lo : lo + chunk], fb[j][:, lo : lo + chunk])

    return quick_two_sum(ch, cl)


def df64_matmul_cost(k: int, *, s: int = 6, w: int = 8) -> dict:
    """Pass count / flop multiplier of the scheme (for roofline use)."""
    passes = s * (s + 1) // 2
    return {
        "passes": passes,
        "mxu_flops_multiplier": passes,
        "chunk": max_exact_chunk(w),
        "relative_error_bound": k * 2.0 ** (-s * w),
    }
