"""The df64 trailing kernels' tensor-core body (``csrc/trailing_df64.cuh``)
modelled in torch on the CPU, and held to the plain versions' and JAX's bits.

The kernel forms each slice pair's chunk product as a ``wgmma`` sum, whose
fp32 accumulation does not round to nearest. The model here makes that sum as
the worst case of it: per k16 step, the running sum and the 16 exact products
are aligned to the largest exponent among them, every bit more than 23 below
that leading bit is cut (truncated toward zero), and the exact sum of what
is left is cut to 24 bits again. The kernel runs no promotion, so neither
does the model: one fresh accumulator per pair and chunk. The pairs are
folded into (hi, lo) in the kernel's order, with its ``two_sum`` and
``quick_two_sum``, and the packed window is reached through the kernel's
offset map (``PackedWindow``, ``csrc/packed_window.cuh``).

The model takes a shortcut where it provably changes nothing: where every
product of a chunk is a multiple of 2^v (v the sum of the lowest set bits of
the two rows) and the sum of their magnitudes stays below 2^(v+24), every
input of every step is a multiple of 2^v below 2^(v+24), so no cut removes a
bit and the chunk product is the exact one, which an fp32 matrix product then
gives. Every other entry runs step by step; a test holds the shortcut to the
steps. The extreme slices (sums of exactly 2^24 units, or running sums past
2^23 units with odd products) run step by step at every entry: an accumulator
that kept 23 bits would fail there.

Inputs are made with numpy from a seed; the torch and JAX slices have the same
bits (tests/test_torch_df64.py). JAX's kernels run in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dla_tpu.kernels.df64_tiles import trailing_update_df64 as jax_dense
from dla_tpu.kernels.df64_tiles import trailing_update_packed_df64 as jax_packed
from dla_tpu.ops import df64 as JD
from dla_tpu_torch.kernels.df64_tiles import (
    K_STEP,
    trailing_update_df64_plain,
    trailing_update_packed_df64_plain,
)
from dla_tpu_torch.kernels.tiles import _slab_row0
from dla_tpu_torch.ops import df64 as TD
from dla_tpu_torch.ops.df64 import max_exact_chunk
from dla_tpu_torch.utils.interop import from_numpy, to_numpy
from test_torch_gpu import DF64_CASES, adversarial_slices
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

_F64 = torch.float64


# ---- the model of one wgmma accumulator ------------------------------------------
def _cut(x, e):
    """x truncated toward zero to a multiple of 2^(e−24): the 24 bits from
    the leading one of a number in [2^(e−1), 2^e) down."""
    unit = torch.ldexp(torch.ones_like(x), (e - 24).to(torch.int32))
    return torch.trunc(x / unit) * unit


def wgmma_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The accumulator of ``n`` outputs, step by step: ``a`` and ``b`` are
    (n, K) float64 holding bf16 values, the row of each output's left and
    right operand. From 0, per k16 step: the running sum and the 16 exact
    products cut to 24 bits below the largest exponent among them, summed
    exactly (17 multiples of one unit, each below 2^24 of it, fit float64),
    the sum cut to 24 bits. Returns (n,) float64 holding fp32 values."""
    k = a.shape[1]
    pad = -k % 16  # the k-step's zero-filled columns
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, pad))
    acc = torch.zeros(a.shape[0], dtype=_F64)
    for k0 in range(0, k + pad, 16):
        t = torch.cat([acc[:, None], a[:, k0:k0 + 16] * b[:, k0:k0 + 16]], 1)
        t = _cut(t, torch.frexp(t.abs().amax(1, keepdim=True)).exponent)
        s = t.sum(1)
        acc = _cut(s, torch.frexp(s).exponent)
    return acc


def _low_bit(x: torch.Tensor) -> torch.Tensor:
    """Exponent of the lowest set bit of each element of a float64 tensor,
    +inf at zero."""
    m, e = torch.frexp(x)
    mi = (m.abs() * 2.0**53).to(torch.int64)
    low = torch.frexp((mi & -mi).to(_F64)).exponent - 1
    return torch.where(x != 0, (low + e - 53).to(_F64), torch.inf)


def chunk_product(a: torch.Tensor, b: torch.Tensor, *, shortcut: bool = True) -> torch.Tensor:
    """The model's fp32 chunk product of (R, K) ``a`` and (C, K) ``b``
    (float64 holding bf16 values): (R, C), entry (r, c) one accumulator over
    a[r] and b[c]."""
    r_idx, c_idx = torch.meshgrid(torch.arange(a.shape[0]), torch.arange(b.shape[0]),
                                  indexing="ij")
    out = torch.empty(a.shape[0], b.shape[0], dtype=_F64)
    slow = torch.ones_like(out, dtype=torch.bool)
    if shortcut:
        v = _low_bit(a).amin(1)[:, None] + _low_bit(b).amin(1)[None, :]
        # fp32 products: the magnitudes' sum rounds up past 2^(v+24) exactly when
        # it lies there (monotone rounding of non-negative terms); below it, every
        # partial sum is a multiple of 2^v under 2^(v+24), exact in fp32
        tot = (a.abs().float() @ b.abs().float().mT).to(_F64)
        slow = (tot != 0) & ((torch.frexp(tot).exponent.to(_F64) > v + 24) | (v < -126))
        out = torch.where(slow, torch.nan, (a.float() @ b.float().mT).to(_F64))
    r, c = r_idx[slow], c_idx[slow]
    if r.numel():
        out[r, c] = wgmma_steps(a[r], b[c])
    return out.to(torch.float32)


def _two_sum(a, b):  # the kernel's two_sum, in IEEE fp32
    s = a + b
    v = s - a
    return s, (a - (s - v)) + (b - v)


def model_window(hi, lo, slices, *, tb: int, w: int, precise_deg: int = 3,
                 shortcut: bool = True):
    """The tensor-core body over a w×w window: ``hi``/``lo`` are fp32 copies
    of the window, updated on the visited elements (r/tb ≥ c/tb) only. Each
    tb tile column is one batch of outputs; per element the chunks, pairs and
    folds run in the kernel's order."""
    f = [x.to(_F64) for x in slices]
    s, (h, nb) = len(f), f[0].shape
    kb = min(nb, max_exact_chunk(w))
    assert kb == nb or kb % K_STEP == 0
    hi, lo = hi.clone(), lo.clone()
    for r0 in range(0, h, tb):
        rows, cols = slice(r0, None), slice(r0, r0 + tb)
        ah, al = hi[rows, cols], lo[rows, cols]
        for k0 in range(0, nb, kb):
            for i in range(s):
                for j in range(s - i):
                    p = chunk_product(f[i][rows, k0:k0 + kb], f[j][cols, k0:k0 + kb],
                                      shortcut=shortcut)
                    if i + j <= precise_deg:
                        ah, e = _two_sum(ah, -p)
                        al = al + e
                    else:
                        al = al - p
        sh = ah + al  # quick_two_sum
        hi[rows, cols], lo[rows, cols] = sh, al - (sh - ah)
    return hi, lo


def model_dense(ch, cl, slices, *, origin: int, tb: int, w: int, **kw):
    """The dense kernel (``DensePairWindow``): the window from (origin·tb,
    origin·tb) of the pair."""
    o = origin * tb
    ch, cl = ch.clone(), cl.clone()
    ch[o:, o:], cl[o:, o:] = model_window(ch[o:, o:], cl[o:, o:], slices, tb=tb, w=w, **kw)
    return ch, cl


def packed_offsets(n: int, nb: int, k: int) -> torch.Tensor:
    """``PackedWindow``'s offset of every element (r, c) of the step-k window
    (meaningful where c ≤ r's tile)."""
    base, nt = (k + 1) * nb, n // nb
    g = torch.arange(base, n)
    j = g // nb
    slab_row0 = nb * (j * nt - j * (j - 1) // 2)
    return (slab_row0[None, :] + g[:, None] - j[None, :] * nb) * nb + (g - j * nb)[None, :]


def model_packed(ph, pl, slices, *, n: int, nb: int, k: int, tb: int, w: int, **kw):
    """The packed kernel: the window gathered through the offset map, updated,
    and its visited elements scattered back."""
    off = packed_offsets(n, nb, k)
    t = torch.arange(off.shape[0]) // tb
    visit = t[:, None] >= t[None, :]
    off = torch.where(visit, off, 0)
    win = [x.reshape(-1)[off] for x in (ph, pl)]
    new = model_window(*win, slices, tb=tb, w=w, **kw)
    out = []
    for x, y in zip((ph, pl), new):
        x = x.clone()
        x.view(-1)[off[visit]] = y[visit]
        out.append(x)
    return tuple(out)


# ---- helpers -----------------------------------------------------------------------
def _bits(x) -> np.ndarray:
    a = to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def _same_bits(a, b) -> bool:
    return all(np.array_equal(_bits(x), _bits(y)) for x, y in zip(a, b, strict=True))


def _t(x):
    return from_numpy(np.asarray(x), device="cpu")


def _sliced(rng, rows, nb, s, w):
    """JAX's and torch's slices of one seeded fp64 panel; the same bits."""
    p = rng.standard_normal((rows, nb))
    jsx = JD.slice_rows(*JD.to_df64(p), s=s, w=w)[0]
    tsx = TD.slice_rows(*TD.to_df64(p, device="cpu"), s=s, w=w)[0]
    assert _same_bits(jsx, tsx)
    return list(jsx), tsx


# ---- the model of the sum ------------------------------------------------------------
def _wide_bf16(rng, shape, spread):
    x = rng.standard_normal(shape) * 2.0 ** rng.uniform(-spread, spread, shape)
    return torch.from_numpy(x).to(torch.bfloat16).to(_F64)


@pytest.mark.parametrize("kind", ["sliced", "max", "alternating", "unsliced"])
def test_shortcut_is_the_steps(kind):
    rng = np.random.default_rng(5)
    nb, w = 256, 9
    if kind == "sliced":
        sx = _sliced(rng, 48, nb, 4, w)[1]
    elif kind == "unsliced":
        sx = [_wide_bf16(rng, (48, nb), 12) for _ in range(2)]
    else:
        sx = adversarial_slices(48, nb, 4, w, kind, seed=6)
    a, b = sx[0].to(_F64), sx[-1].to(_F64)
    got = chunk_product(a, b)
    want = chunk_product(a, b, shortcut=False)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_model_is_not_vacuous_on_unsliced_operands():
    # bf16 operands off any common grid: the cut sums differ from the IEEE ones
    # (running fp32 sums rounded to nearest, and the exact sum rounded once)
    rng = np.random.default_rng(8)
    a, b = _wide_bf16(rng, (64, 1024), 20), _wide_bf16(rng, (64, 1024), 20)
    model = chunk_product(a, b)
    ieee = torch.zeros(64, 64)
    for k in range(1024):
        ieee = ieee + a[:, k, None].float() * b[None, :, k].float()
    exact = (a @ b.mT).float()
    assert (model != ieee).float().mean() > 0.5
    assert (model != exact).float().mean() > 0.5
    tot = a.abs() @ b.abs().mT  # and stay close to them: 64 steps, each cut below 2^-22 of it
    assert ((model.double() - a @ b.mT).abs() <= tot * 2**-14).all()


@pytest.mark.parametrize("w", [8, 9])
def test_sums_of_exactly_2_pow_24_units_stay_exact(w):
    # every product 2^(2w−2) units of one sign: each chunk is 2^24 units, and the
    # running sum reaches 2^24 − 16·2^(2w−2) before the last step
    kb = max_exact_chunk(w)
    sx = adversarial_slices(32, kb, 2, w, "max", seed=2)
    a, b = sx[0].to(_F64), sx[1].to(_F64)
    got = chunk_product(a, b).to(_F64)
    assert torch.equal(got, a @ b.mT)
    unit = (a[:, :1] * b[:, 0]) / 2.0 ** (2 * w - 2)
    assert torch.equal(got / unit, torch.full_like(got, 2.0**24))


# ---- the model of the kernels ----------------------------------------------------------
SCHEDULE_CASES = DF64_CASES  # the card tests' cases: (m, nb, tb, s, w, origin)


@pytest.mark.parametrize("m,nb,tb,s,w,origin", SCHEDULE_CASES)
def test_dense_model_bits_of_plain_and_jax(m, nb, tb, s, w, origin):
    rng = np.random.default_rng(m + nb + origin)
    ch, cl = JD.to_df64(rng.standard_normal((m, m)))
    jsx, tsx = _sliced(rng, m - origin * tb, nb, s, w)
    ref = jax_dense(ch, cl, jsx, tb=tb, origin=origin, w=w)
    plain = trailing_update_df64_plain(_t(ch), _t(cl), tsx, tb=tb, origin=origin, w=w)
    got = model_dense(_t(ch), _t(cl), tsx, origin=origin, tb=tb, w=w)
    assert _same_bits(got, plain)
    assert _same_bits(got, ref)


PACKED_CASES = [  # (n, nb, tb, s, w, k)
    (1024, 512, 256, 7, 8, 0),  # the path's s and w; kb = nb
    (1024, 512, 128, 6, 9, 0),  # two chunks of kb = 256
    (576, 192, 96, 7, 8, 0),  # tb = 96: 128-row blocks straddle tiles and slabs
    (576, 192, 96, 7, 8, 1),
    (384, 96, 32, 7, 8, 1),  # nb not a multiple of the k-step
]


@pytest.mark.parametrize("n,nb,tb,s,w,k", PACKED_CASES)
def test_packed_model_bits_of_plain_and_jax(n, nb, tb, s, w, k):
    rng = np.random.default_rng(n + nb + k)
    ch, cl = JD.to_df64(rng.standard_normal((_slab_row0(n // nb, n // nb, nb), nb)))
    jsx, tsx = _sliced(rng, n - (k + 1) * nb, nb, s, w)
    ref = jax_packed(ch, cl, jsx, n=n, nb=nb, k=k, tb=tb, w=w)
    plain = trailing_update_packed_df64_plain(_t(ch), _t(cl), tsx, n=n, nb=nb, k=k, tb=tb, w=w)
    got = model_packed(_t(ch), _t(cl), tsx, n=n, nb=nb, k=k, tb=tb, w=w)
    assert _same_bits(got, plain)
    assert _same_bits(got, ref)
    assert not torch.equal(got[0], _t(ch))


ADVERSARIAL = [  # (m, nb, tb, s, w, kind): every chunk at or near 2^24 units
    (64, 1024, 32, 7, 8, "max"),
    (64, 1024, 32, 7, 8, "alternating"),
    (96, 512, 32, 6, 9, "max"),  # two chunks of kb = 256
    (96, 512, 32, 6, 9, "alternating"),
]


@pytest.mark.parametrize("m,nb,tb,s,w,kind", ADVERSARIAL)
def test_adversarial_slices_dense(m, nb, tb, s, w, kind):
    rng = np.random.default_rng(m + w)
    ch, cl = JD.to_df64(rng.standard_normal((m, m)))
    tsx = adversarial_slices(m, nb, s, w, kind, seed=m + nb)
    ref = jax_dense(ch, cl, [jnp.asarray(to_numpy(x)) for x in tsx], tb=tb, w=w)
    plain = trailing_update_df64_plain(_t(ch), _t(cl), tsx, tb=tb, w=w)
    got = model_dense(_t(ch), _t(cl), tsx, origin=0, tb=tb, w=w, shortcut=False)
    assert _same_bits(got, plain)
    assert _same_bits(got, ref)


@pytest.mark.parametrize("kind", ["max", "alternating"])
def test_adversarial_slices_packed(kind):
    n, nb, tb, s, w, k = 512, 256, 32, 4, 9, 0  # one chunk of kb = 256
    rng = np.random.default_rng(n + w)
    ch, cl = JD.to_df64(rng.standard_normal((_slab_row0(n // nb, n // nb, nb), nb)))
    tsx = adversarial_slices(n - (k + 1) * nb, nb, s, w, kind, seed=n + nb)
    ref = jax_packed(ch, cl, [jnp.asarray(to_numpy(x)) for x in tsx], n=n, nb=nb, k=k, tb=tb,
                     w=w)
    plain = trailing_update_packed_df64_plain(_t(ch), _t(cl), tsx, n=n, nb=nb, k=k, tb=tb, w=w)
    got = model_packed(_t(ch), _t(cl), tsx, n=n, nb=nb, k=k, tb=tb, w=w, shortcut=False)
    assert _same_bits(got, plain)
    assert _same_bits(got, ref)
