"""dla_tpu_torch's emulated-fp64 (df64) path held against dla_tpu's on the
same numpy inputs: the error-free transforms, the slicing, the exact-sliced
GEMM, the df64 trailing update, ``potrf_df64`` and its df64 gates.

On the CPU the port's trailing wrapper runs its plain torch version and the
JAX kernel runs in interpret mode, as in tests/test_df64.py. The CUDA kernel
is held against the plain version on the card in tests/test_torch_gpu.py.

What is compared how:
- the elementwise transforms, the slicing and the trailing update are exact
  up to a fixed order of roundings, so both packages give the **same bits**;
- ``df64_matmul_nt`` gives the same bits while k ≤ max_exact_chunk(w) = 1024
  (every pass exact); above, the low-significance full-K products round in
  each library's own order, so both are held within 1e-13 of |A|·|B|ᵀ of the
  fp64 product;
- the factors start from LAPACK fp32 Cholesky factors that may differ in their
  last bits, and the refinement takes both to the df64 floor: max|ΔL| ≤
  1e-12·max|L|, forward error ≤ 1e-12 against scipy, residual < 1e-11;
- the gates sum fp32 block partials in another order: 1e-5 relative on the
  same factor.
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import scipy.linalg
import torch

from dla_tpu.kernels.df64_tiles import trailing_update_df64 as jax_trailing
from dla_tpu.ops import df64 as JD
from dla_tpu_torch.kernels import df64_tiles
from dla_tpu_torch.kernels.df64_tiles import trailing_update_df64, trailing_update_df64_plain
from dla_tpu_torch.ops import df64 as TD
from dla_tpu_torch.utils.interop import from_numpy, to_numpy
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

JP = importlib.import_module("dla_tpu.algos.potrf_df64")
TP = importlib.import_module("dla_tpu_torch.algos.potrf_df64")


def _bits(x) -> np.ndarray:
    a = to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def _same_bits(jax_out, torch_out) -> bool:
    return all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(jax_out, torch_out, strict=True))


def _wide(rng, n, spread):
    return rng.standard_normal(n) * np.exp(rng.uniform(-spread, spread, n))


def _spd(n, seed):
    g = np.random.default_rng(seed).standard_normal((n, n))
    return (g + g.T) / 2 + n * np.eye(n)


def _t(x):
    return from_numpy(np.asarray(x), device="cpu")


def _res64(a, lh, ll):
    l = np.asarray(lh, np.float64) + np.asarray(ll, np.float64)
    return np.abs(a - l @ l.T).sum(1).max() / np.abs(a).sum(1).max()


class TestElementwise:
    @pytest.mark.parametrize("name", ["two_sum", "quick_two_sum", "split32", "two_prod"])
    def test_eft_bits(self, name):
        rng = np.random.default_rng(1)
        x = _wide(rng, 4096, 15).astype(np.float32)
        y = _wide(rng, 4096, 15).astype(np.float32)
        args = (x,) if name == "split32" else (x, y)
        ref = jax.jit(getattr(JD, name))(*map(jnp.asarray, args))
        assert _same_bits(ref, getattr(TD, name)(*map(_t, args)))

    def test_two_prod_error_free(self):
        rng = np.random.default_rng(2)
        x = _wide(rng, 4096, 15).astype(np.float32)
        y = _wide(rng, 4096, 15).astype(np.float32)
        p, e = TD.two_prod(_t(x), _t(y))
        np.testing.assert_array_equal(p.double().numpy() + e.double().numpy(),
                                      x.astype(np.float64) * y.astype(np.float64))

    @pytest.mark.parametrize("name", ["df_add", "df_sub", "df_mul", "df_div"])
    def test_pair_ops_bits(self, name):
        # op by op: under jit, XLA's CPU backend contracts df_mul's
        # xh*yl + xl*yh into an FMA; the port's eager ops never do
        rng = np.random.default_rng(3)
        x, y = JD.to_df64(_wide(rng, 4096, 20)), JD.to_df64(_wide(rng, 4096, 20))
        with jax.disable_jit():
            ref = getattr(JD, name)(*x, *y)
        got = getattr(TD, name)(*map(_t, x), *map(_t, y))
        assert _same_bits(ref, got)
        jit = np.asarray(JD.from_df64(*jax.jit(getattr(JD, name))(*x, *y)))
        val = TD.from_df64(*got).numpy()
        assert np.all(np.abs(val - jit) <= 2.0**-46 * np.abs(jit))

    def test_add_f32_renorm_neg_bits(self):
        rng = np.random.default_rng(4)
        xh, xl = JD.to_df64(_wide(rng, 1024, 20))
        y = _wide(rng, 1024, 20).astype(np.float32)
        assert _same_bits(JD.df_add_f32(xh, xl, jnp.asarray(y)), TD.df_add_f32(_t(xh), _t(xl), _t(y)))
        assert _same_bits(JD.df_renorm(xh, xl), TD.df_renorm(_t(xh), _t(xl)))
        assert _same_bits(JD.df_neg(xh, xl), TD.df_neg(_t(xh), _t(xl)))

    def test_sqrt_bits_and_zero(self):
        rng = np.random.default_rng(5)
        x = np.abs(_wide(rng, 4096, 20))
        x[:3] = 0.0
        xh, xl = JD.to_df64(x)
        with jax.disable_jit():
            ref = JD.df_sqrt(xh, xl)
        got = TD.df_sqrt(_t(xh), _t(xl))
        assert _same_bits(ref, got)
        assert not torch.isnan(got[0]).any() and got[0][:3].abs().max() == 0

    def test_pow2_ceil_bits(self):
        rng = np.random.default_rng(6)
        x = np.abs(_wide(rng, 4096, 40)).astype(np.float32)
        x[:8] = 2.0 ** np.arange(-4, 4)  # exact powers stay put
        assert _same_bits([JD._pow2_ceil(jnp.asarray(x))], [TD._pow2_ceil(_t(x))])
        np.testing.assert_array_equal(TD._pow2_ceil(_t(x[:8])).numpy(), x[:8])

    def test_to_from_df64(self):
        rng = np.random.default_rng(7)
        a = _wide(rng, 512, 30).reshape(16, 32)
        assert _same_bits(JD.to_df64(a), TD.to_df64(a, device="cpu"))
        ht, lt = TD.to_df64(torch.from_numpy(a))
        assert _same_bits(TD.to_df64(a, device="cpu"), (ht, lt)) and ht.dtype == torch.float32
        back = TD.from_df64(ht, lt).numpy()
        assert np.array_equal(back, np.asarray(JD.from_df64(*JD.to_df64(a))))
        assert np.all(np.abs(back - a) <= 2.0**-48 * np.abs(a))  # ~49 bits survive


class TestSlicing:
    @pytest.mark.parametrize("s,w", [(6, 8), (7, 8), (6, 9), (7, 9)])
    def test_slices_bits(self, s, w):
        rng = np.random.default_rng(s * 10 + w)
        a = rng.standard_normal((64, 300)) * np.exp(rng.uniform(-12, 12, (64, 1)))
        a[5] = 0.0  # an all-zero row takes the scale 1
        js, jmu = jax.jit(lambda h, l: JD.slice_rows(h, l, s=s, w=w))(*JD.to_df64(a))
        ts, tmu = TD.slice_rows(*TD.to_df64(a, device="cpu"), s=s, w=w)
        assert len(ts) == s and all(x.dtype == torch.bfloat16 for x in ts)
        assert _same_bits(js, ts) and _same_bits([jmu], [tmu])

    def test_chunk_and_cost(self):
        assert TD.max_exact_chunk(8) == JD.max_exact_chunk(8) == 1024
        assert TD.max_exact_chunk(9) == 256
        for s, w in [(6, 8), (7, 8)]:
            assert TD.df64_matmul_cost(4096, s=s, w=w) == JD.df64_matmul_cost(4096, s=s, w=w)
        assert TD.df64_matmul_cost(4096, s=7)["passes"] == 28


class TestMatmul:
    @pytest.mark.parametrize("m,n,k,s", [(64, 48, 256, 6), (96, 64, 1024, 7), (40, 72, 520, 7)])
    def test_bits_within_one_chunk(self, m, n, k, s):
        rng = np.random.default_rng(m + k)
        a = rng.standard_normal((m, k)) * np.exp(rng.uniform(-6, 6, (m, 1)))
        b = rng.standard_normal((n, k)) * np.exp(rng.uniform(-6, 6, (n, 1)))
        ja, jb = JD.to_df64(a), JD.to_df64(b)
        ref = jax.jit(lambda *t: JD.df64_matmul_nt(*t, s=s))(*ja, *jb)
        got = TD.df64_matmul_nt(*map(_t, ja), *map(_t, jb), s=s)
        assert _same_bits(ref, got)

    @pytest.mark.parametrize("m,n,k", [(96, 64, 2048), (32, 40, 3000)])
    def test_past_one_chunk_vs_fp64(self, m, n, k):
        rng = np.random.default_rng(m + k)
        a = rng.standard_normal((m, k)) * np.exp(rng.uniform(-6, 6, (m, 1)))
        b = rng.standard_normal((n, k)) * np.exp(rng.uniform(-6, 6, (n, 1)))
        ja, jb = JD.to_df64(a), JD.to_df64(b)
        scale = np.abs(a) @ np.abs(b).T
        ref = np.asarray(JD.from_df64(*jax.jit(JD.df64_matmul_nt)(*ja, *jb)))
        got = TD.from_df64(*TD.df64_matmul_nt(*map(_t, ja), *map(_t, jb))).numpy()
        assert np.max(np.abs(got - a @ b.T) / scale) < 1e-13
        assert np.max(np.abs(got - ref) / scale) < 1e-13

    def test_every_product_exact_past_one_chunk(self, monkeypatch):
        # each product the GEMM takes spans one exact chunk, so summing it in
        # fp64 instead of the library's fp32 order changes no bit: the card's
        # cuBLAS and the CPU's BLAS give the same result
        rng = np.random.default_rng(10)
        a = rng.standard_normal((48, 4096)) * 3e-3  # rows like a Cholesky factor's:
        a[np.arange(48), np.arange(48)] = 150.0 + rng.random(48)  # long sums of small terms
        ta = TD.to_df64(a, device="cpu")
        ref = TD.df64_matmul_nt(*ta, *ta, s=7)
        monkeypatch.setattr(TD, "_dot_nt_bf16",
                            lambda x, y: (x.double() @ y.double().mT).float())
        assert _same_bits(ref, TD.df64_matmul_nt(*ta, *ta, s=7))

    def test_preslicing_matches(self):
        a = np.random.default_rng(8).standard_normal((64, 512))
        ah, al = TD.to_df64(a, device="cpu")
        sx = TD.slice_rows(ah, al)[0]
        c1 = TD.df64_matmul_nt(ah, al, ah, al)
        c2 = TD.df64_matmul_nt(None, None, None, None, slices_a=sx, slices_b=sx)
        assert _same_bits(c1, c2)


def _lower_mask(m, tb, origin):
    idx = np.arange(m) // tb
    inwin = idx >= origin
    return (idx[:, None] >= idx[None, :]) & inwin[:, None] & inwin[None, :]


TRAILING_CASES = [  # (m, nb, tb, s, w, origin)
    (384, 128, 128, 7, 8, 0),
    (512, 512, 128, 6, 9, 1),  # nk = 2 chunks (kb = 256 at w = 9), window from tile 1
    (384, 128, 96, 7, 8, 0),  # tb not a multiple of the kernel's 64-wide blocks
]


class TestTrailing:
    @pytest.mark.parametrize("m,nb,tb,s,w,origin", TRAILING_CASES)
    def test_plain_bits_match_jax(self, m, nb, tb, s, w, origin):
        rng = np.random.default_rng(m + nb + tb)
        c = rng.standard_normal((m, m))
        p = rng.standard_normal((m - origin * tb, nb))
        ch, cl = JD.to_df64(c)
        sx = JD.slice_rows(*JD.to_df64(p), s=s, w=w)[0]
        ref = jax_trailing(ch, cl, list(sx), tb=tb, origin=origin, w=w)
        tch, tcl = _t(ch), _t(cl)
        tsx = TD.slice_rows(*TD.to_df64(p, device="cpu"), s=s, w=w)[0]
        assert _same_bits(sx, tsx)
        before = df64_tiles.launches
        got = trailing_update_df64(tch, tcl, tsx, tb=tb, origin=origin, w=w)
        assert df64_tiles.launches == before  # the CPU runs the plain version
        assert got[0] is tch and got[1] is tcl  # in place
        assert _same_bits(ref, got)
        out = ~_lower_mask(m, tb, origin)
        assert np.array_equal(_bits(got[0])[out], _bits(ch)[out])
        assert np.array_equal(_bits(got[1])[out], _bits(cl)[out])
        upd = TD.from_df64(*got).numpy()
        o = origin * tb
        want = c[o:, o:] - p @ p.T
        assert np.abs(upd[o:, o:] - want)[_lower_mask(m - o, tb, 0)].max() < 1e-9

    def test_precise_deg_bits(self):
        rng = np.random.default_rng(9)
        c, p = rng.standard_normal((256, 256)), rng.standard_normal((256, 128))
        ch, cl = JD.to_df64(c)
        sx = JD.slice_rows(*JD.to_df64(p), s=5)[0]
        for deg in (0, 8):
            ref = jax_trailing(ch, cl, list(sx), tb=128, precise_deg=deg)
            got = trailing_update_df64_plain(_t(ch), _t(cl), [_t(x) for x in sx], tb=128,
                                             precise_deg=deg)
            assert _same_bits(ref, got)

    @pytest.mark.parametrize("fn", [trailing_update_df64, trailing_update_df64_plain])
    def test_checks(self, fn):
        z = torch.zeros
        sl = [z(256, 64, dtype=torch.bfloat16)] * 3
        with pytest.raises(ValueError, match="square"):
            fn(z(256, 128), z(256, 128), sl, tb=64)
        with pytest.raises(ValueError, match="multiple of tb"):
            fn(z(250, 250), z(250, 250), sl, tb=64)
        with pytest.raises(ValueError, match="window"):
            fn(z(256, 256), z(256, 256), sl, tb=64, origin=1)
        with pytest.raises(ValueError, match="chunk"):
            fn(z(256, 256), z(256, 256), [z(256, 1536, dtype=torch.bfloat16)], tb=64)
        with pytest.raises(TypeError, match="float32"):
            fn(z(256, 256, dtype=torch.float64), z(256, 256, dtype=torch.float64), sl, tb=64)
        with pytest.raises(TypeError, match="bfloat16"):
            fn(z(256, 256), z(256, 256), [z(256, 64)], tb=64)

    def test_other_devices_raise(self):
        sl = [torch.zeros(64, 32, dtype=torch.bfloat16, device="meta")]
        with pytest.raises(ValueError, match="CUDA"):
            trailing_update_df64(torch.zeros(64, 64, device="meta"),
                                 torch.zeros(64, 64, device="meta"), sl, tb=32)
        with pytest.raises(ValueError, match="CUDA"):
            trailing_update_df64(torch.zeros(64, 64), torch.zeros(64, 64), sl, tb=32)


_JAX_FACTORS = {}


def _jax_factor(n, nb, trailing, tb):
    """dla_tpu's df64 factor of ``_spd(n, n)``, computed once per case."""
    key = (n, nb, trailing, tb)
    if key not in _JAX_FACTORS:
        a = _spd(n, n)
        lh, ll = JP.potrf_df64(*JD.to_df64(a), nb=nb, trailing=trailing, tb=tb)
        _JAX_FACTORS[key] = (a, np.asarray(lh), np.asarray(ll))
    return _JAX_FACTORS[key]


POTRF_CASES = [(512, 128, 128), (768, 256, 128)]  # (n, nb, tb); the second has tb < nb


class TestPotrf:
    @pytest.mark.parametrize("trailing", ["xla", "pallas"])
    @pytest.mark.parametrize("n,nb,tb", POTRF_CASES)
    def test_matches_jax_and_scipy(self, n, nb, tb, trailing):
        a, jlh, jll = _jax_factor(n, nb, trailing, tb)
        ah, al = TD.to_df64(a, device="cpu")
        lh, ll = TP.potrf_df64(ah, al, nb=nb, trailing=trailing, tb=tb)
        assert lh is ah and ll is al  # factored in place
        l = TD.from_df64(lh, ll).numpy()
        lj = jlh.astype(np.float64) + jll.astype(np.float64)
        assert np.abs(l - lj).max() <= 1e-12 * np.abs(lj).max()
        ref = scipy.linalg.cholesky(a, lower=True)
        assert np.abs(l - ref).max() <= 1e-12 * np.abs(ref).max()
        assert np.array_equal(l, np.tril(l))
        assert _res64(a, lh, ll) < 1e-11

    @pytest.mark.parametrize("trailing", ["xla", "pallas"])
    def test_reads_lower_triangle_only(self, trailing):
        n, nb, tb = 768, 256, 128
        ah, al = TD.to_df64(_spd(n, 11), device="cpu")
        clean = TP.potrf_df64(ah.clone(), al.clone(), nb=nb, trailing=trailing, tb=tb)
        up = torch.triu(torch.ones(n, n, dtype=torch.bool), 1)
        dirty = TP.potrf_df64(torch.where(up, 123.0, ah), torch.where(up, -7.0, al), nb=nb,
                              trailing=trailing, tb=tb)
        assert _same_bits(clean, dirty)

    def test_fp64_and_noncontiguous_input_is_copied(self):
        a = _spd(256, 12).astype(np.float32).astype(np.float64)  # hi holds all of A
        a64 = torch.from_numpy(a)
        lo = torch.zeros(256, 256).mT
        lh, ll = TP.potrf_df64(a64, lo, nb=64)
        assert lh.dtype == torch.float32 and lh.data_ptr() != a64.data_ptr()
        assert _res64(a, lh, ll) < 1e-11

    def test_non_spd_gives_nan(self):
        a = _spd(256, 13)
        a[70, 70] = -1e3
        lh, _ = TP.potrf_df64(*TD.to_df64(a, device="cpu"), nb=64, trailing="pallas", tb=64)
        assert torch.isnan(lh[64:]).any() and not torch.isnan(lh[:64, :64]).any()

    def test_rejects_bad_shapes(self):
        z = torch.zeros
        with pytest.raises(ValueError, match="multiple"):
            TP.potrf_df64(z(100, 100), z(100, 100), nb=64)
        with pytest.raises(ValueError, match="square"):
            TP.potrf_df64(z(128, 128), z(128, 64), nb=64)
        with pytest.raises(ValueError, match="tb"):
            TP.potrf_df64(z(256, 256), z(256, 256), nb=128, trailing="pallas", tb=96)
        with pytest.raises(ValueError, match="trailing"):
            TP.potrf_df64(z(256, 256), z(256, 256), nb=128, trailing="cuda")


class TestGates:
    def test_strip_gate_matches_jax(self):
        a, lh, ll = _jax_factor(512, 128, "pallas", 128)
        ah, al = JD.to_df64(a)
        ref = float(JP.residual_potrf_df64(ah, al, lh, ll))
        got = float(TP.residual_potrf_df64(_t(ah), _t(al), _t(lh), _t(ll)))
        assert abs(got - ref) <= 1e-5 * ref
        res64 = _res64(a, lh, ll)
        assert res64 < got < 50 * res64 + 1e-13 and got < 1e-10

    @pytest.mark.parametrize("rc", [128, 160])  # 160: a ragged last strip (512 = 3*160 + 32)
    def test_blocked_gate_matches_jax(self, rc):
        a, lh, ll = _jax_factor(512, 128, "pallas", 128)
        ah, al = JD.to_df64(a)
        lh_st = lh.copy()
        lh_st[np.triu_indices(512, 1)] = 7.0  # the tril mask must neutralize it
        ref = JP.residual_potrf_df64_blocked(ah, al, jnp.asarray(lh_st), ll, rc=rc)
        got = TP.residual_potrf_df64_blocked(_t(ah), _t(al), _t(lh_st), _t(ll), rc=rc)
        assert abs(got - ref) <= 1e-5 * ref
        res64 = _res64(a, lh, ll)
        assert res64 < got < 50 * res64 + 1e-13 and got < 1e-10

    def test_blocked_al_none_and_gen_seed(self):
        import dla_tpu_torch as T

        n = 512
        a32 = T.plgsy(n, seed=51, device="cpu")
        lh, ll = TP.potrf_df64(a32.clone(), torch.zeros_like(a32), nb=128)
        r_none = TP.residual_potrf_df64_blocked(a32, None, lh, ll, rc=128)
        r_zero = TP.residual_potrf_df64_blocked(a32, torch.zeros_like(a32), lh, ll, rc=128)
        r_gen = TP.residual_potrf_df64_blocked(None, None, lh, ll, rc=128, gen_seed=51)
        assert r_none == r_zero == r_gen
        ref = JP.residual_potrf_df64_blocked(None, None, jnp.asarray(to_numpy(lh)),
                                             jnp.asarray(to_numpy(ll)), rc=128, gen_seed=51)
        assert abs(r_gen - ref) <= 1e-5 * ref
        res64 = _res64(a32.double().numpy(), lh, ll)
        assert res64 < r_gen < 50 * res64 + 1e-13 and r_gen < 1e-11
        with pytest.raises(ValueError, match="rc"):
            TP.residual_potrf_df64_blocked(None, None, lh, ll, rc=96, gen_seed=51)

    def test_corrupted_factor_fails(self):
        a, lh, ll = _jax_factor(512, 128, "pallas", 128)
        ah, al = map(_t, JD.to_df64(a))
        bad = _t(lh)
        bad[5, 3] += 1e-4
        assert float(TP.residual_potrf_df64(ah, al, bad, _t(ll))) > 1e-10
        assert TP.residual_potrf_df64_blocked(ah, al, bad, _t(ll), rc=128) > 1e-10


def test_bf16_slices_cross_as_bits():
    # slices move between the packages through ml_dtypes
    s = TD.slice_rows(*TD.to_df64(np.linspace(-3, 3, 64).reshape(4, 16), device="cpu"), s=2)[0]
    assert to_numpy(s[0]).dtype == ml_dtypes.bfloat16
