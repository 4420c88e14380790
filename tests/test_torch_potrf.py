"""dla_tpu_torch's POTRF main path and residual held against the JAX package.

The same seeded matrices go through ``dla_tpu`` (JAX on the CPU, x64, the
Pallas trailing kernel in interpret mode) and ``dla_tpu_torch`` (plain
versions on the CPU). Only tril(L) is compared: it is the only meaningful
part of an in-place factor.

Tolerances:
- fp64: tril(L) within 1e-10 of JAX, residual < 1e-10 (``v6_test.c:87``);
- fp32 ``high``: within 1e-5·max|L| of JAX — the same formulation in fp32,
  summed in another order;
- bf16 storage: the JAX tests' residual class (tests/test_potrf.py:438-451)
  and residuals within 5% of JAX's.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import scipy.linalg
import torch

import dla_tpu_torch as T
import dla_tpu_torch.algos as TA
from dla_tpu.algos import potrf as jax_potrf
from dla_tpu.algos import potrf_inplace as jax_potrf_inplace
from dla_tpu.ops import plgsy as jax_plgsy
from dla_tpu.validate import cholesky_invariants as jax_invariants
from dla_tpu.validate import residual_potrf as jax_residual
from dla_tpu_torch.utils.interop import from_numpy, to_numpy
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _a(n, seed, jdt=jnp.float64):
    return np.array(jax_plgsy(n, seed=seed, dtype=jdt))


def _t(x):
    return from_numpy(x, device="cpu")


class TestPotrfInplace:
    @pytest.mark.parametrize("diag", ["twolevel", "lax"])
    def test_fp64_matches_jax(self, diag):
        n, nb, tb, ib = 256, 64, 32, 32  # ib < nb: the two-level factor recurses
        a = _a(n, seed=n)
        kw = dict(nb=nb, tb=tb, ib=ib, kb=32, diag_factor=diag)
        ref = np.tril(np.asarray(jax_potrf_inplace(jnp.asarray(a), **kw)))
        ta = _t(a)
        out = TA.potrf_inplace(ta, **kw)
        assert out is ta  # mutates its argument
        got = np.tril(out.numpy())
        assert np.abs(got - ref).max() < 1e-10
        np.testing.assert_allclose(got, scipy.linalg.cholesky(a, lower=True),
                                   rtol=1e-9, atol=1e-9)
        assert float(T.residual_potrf(_t(a), out)) < T.validate.PASS_THRESHOLD
        # the upper triangle off the diagonal blocks passes through
        np.testing.assert_array_equal(out.numpy()[:nb, nb:], a[:nb, nb:])

    @pytest.mark.parametrize("diag", ["twolevel", "lax"])
    def test_fp32_high_matches_jax(self, diag):
        n = 256
        a = _a(n, seed=7, jdt=jnp.float32)
        kw = dict(nb=128, tb=64, ib=64, kb=128, diag_factor=diag, precision="high")
        ref = np.tril(np.asarray(jax_potrf_inplace(jnp.asarray(a), **kw)))
        got = np.tril(TA.potrf_inplace(_t(a), **kw).numpy())
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
        assert float(T.residual_potrf(_t(a), _t(got))) < n * 2e-7

    def test_bf16_storage_residual_class(self):
        n = 256
        a32 = _a(n, seed=11, jdt=jnp.float32)
        ab = a32.astype(ml_dtypes.bfloat16)
        ref = np.asarray(jax_potrf_inplace(jnp.asarray(ab), nb=64, tb=32))
        out = TA.potrf_inplace(_t(ab), nb=64, tb=32)
        assert out.dtype == torch.bfloat16
        aref = a32.astype(np.float64)
        res = []
        for lb in (to_numpy(out), ref):
            l = np.tril(lb.astype(np.float64))
            res.append(np.abs(aref - l @ l.T).max() / np.abs(aref).max())
        assert np.isfinite(res[0]) and 1e-5 < res[0] < n * 2 * 0.0039, res
        assert abs(res[0] - res[1]) <= 0.05 * res[1], res

    def test_garbage_above_diagonal_is_not_read(self):
        n = 128
        a = _a(n, seed=3)
        dirty = np.tril(a) + np.triu(np.full((n, n), 123.0), 1)
        kw = dict(nb=64, tb=32, ib=32)
        clean = np.tril(TA.potrf_inplace(_t(a), **kw).numpy())
        got = np.tril(TA.potrf_inplace(_t(dirty), **kw).numpy())
        np.testing.assert_array_equal(got, clean)

    def test_non_spd_gives_nans_like_jax(self):
        n = 128
        a = _a(n, seed=5)
        a[70, 70] = -5.0  # the second panel's diagonal block is not SPD
        kw = dict(nb=64, tb=32, ib=32)
        ref = np.tril(np.asarray(jax_potrf_inplace(jnp.asarray(a), **kw)))
        got = np.tril(TA.potrf_inplace(_t(a), **kw).numpy())
        assert np.isnan(ref).any() and np.isnan(got).any()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        inv = T.cholesky_invariants(_t(got))
        assert int(inv.nan_count) == int(jax_invariants(jnp.asarray(got)).nan_count) > 0

    def test_checks_and_later_options(self):
        a = torch.eye(64, dtype=torch.float64)
        with pytest.raises(ValueError):
            TA.potrf_inplace(a, nb=48, tb=16)
        with pytest.raises(ValueError):
            TA.potrf_inplace(a, nb=32, tb=24)
        with pytest.raises(ValueError, match="fp32"):  # the reference's gate
            TA.potrf_inplace(a, nb=32, tb=32, panel="pallas")
        with pytest.raises(ValueError, match="panel"):
            TA.potrf_inplace(a, nb=32, tb=32, panel="nope")
        n = 128
        spd = _a(n, seed=6)
        kw = dict(nb=64, tb=32, ib=32, diag_factor="unblocked")
        ref = np.tril(np.asarray(jax_potrf_inplace(jnp.asarray(spd), **kw)))
        got = np.tril(TA.potrf_inplace(_t(spd), **kw).numpy())
        assert np.abs(got - ref).max() < 1e-10


class TestPotrfPublic:
    @pytest.mark.parametrize("uplo", ["L", "U", "B"])
    def test_uplo_matches_jax(self, uplo):
        n, nb = 192, 64
        a = _a(n, seed=9)
        if uplo == "U":
            a = np.triu(a) + np.tril(np.full((n, n), -3.0), -1)  # lower half is junk
        ref = np.asarray(jax_potrf(jnp.asarray(a), nb=nb, mode="inplace", uplo=uplo))
        ta = _t(a)
        got = T.potrf(ta, nb=nb, mode="inplace", uplo=uplo)
        np.testing.assert_array_equal(ta.numpy(), a)  # input untouched
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)
        if uplo == "L":
            assert np.abs(np.triu(got.numpy(), 1)).max() == 0

    def test_other_modes_not_ported(self):
        """Every mode of the reference is ported now; unknown names raise."""
        a = torch.eye(64, dtype=torch.float64)
        for mode in ("blocked", "masked", "shrink", "inplace"):
            assert torch.equal(T.potrf(a, nb=32, mode=mode), a)
        with pytest.raises(ValueError):
            T.potrf(a, nb=32, mode="inplace", uplo="X")
        with pytest.raises(ValueError):
            T.potrf(a, nb=32, mode="nope")


class TestResidual:
    @pytest.mark.parametrize("norm", ["I", "M", "1", "F"])
    @pytest.mark.parametrize("assume_symmetric,assume_tril", [(False, False), (True, True)])
    def test_monolithic_matches_jax(self, norm, assume_symmetric, assume_tril):
        n = 128
        a = _a(n, seed=2)
        l = scipy.linalg.cholesky(a, lower=True)
        l[3, 1] += 1e-6  # a visible residual
        if not assume_tril:
            l = l + np.triu(np.full((n, n), 8.0), 1)
        kw = dict(norm=norm, assume_symmetric=assume_symmetric, assume_tril=assume_tril)
        ref = float(jax_residual(jnp.asarray(a), jnp.asarray(l), **kw))
        got = float(T.residual_potrf(_t(a), _t(l), **kw))
        assert got == pytest.approx(ref, rel=1e-9)

    @pytest.mark.parametrize("norm", ["I", "M"])
    def test_row_chunk_matches_jax(self, norm):
        n = 128
        a = _a(n, seed=4)
        l = scipy.linalg.cholesky(a, lower=True)
        l[100, 7] += 1e-5
        ref = float(jax_residual(jnp.asarray(a), jnp.asarray(l), norm=norm, row_chunk=32))
        got = float(T.residual_potrf(_t(a), _t(l), norm=norm, row_chunk=32))
        mono = float(T.residual_potrf(_t(a), _t(l), norm=norm))
        assert got == pytest.approx(ref, rel=1e-9)
        assert got == pytest.approx(mono, rel=1e-9)
        with pytest.raises(ValueError, match="norm"):
            T.residual_potrf(_t(a), _t(l), norm="F", row_chunk=32)
        with pytest.raises(ValueError):
            T.residual_potrf(_t(a), _t(l), row_chunk=48)

    def test_bf16_low_storage_matches_jax(self):
        n = 256
        ab = _a(n, seed=7, jdt=jnp.float32).astype(ml_dtypes.bfloat16)
        lb = np.asarray(jax_potrf_inplace(jnp.asarray(ab), nb=128, tb=64))
        kw = dict(assume_symmetric=True, row_chunk=64)
        ref = float(jax_residual(jnp.asarray(ab), jnp.asarray(lb), **kw))
        got = float(T.residual_potrf(_t(ab), _t(lb), **kw))
        mono = float(T.residual_potrf(_t(ab), _t(lb), assume_symmetric=True))
        assert got == pytest.approx(ref, rel=1e-6)
        assert abs(got - mono) <= 0.05 * mono

    def test_invariants_match_jax(self):
        a = _a(64, seed=1)
        l = scipy.linalg.cholesky(a, lower=True)
        l[0, 5] = 0.25
        ref = jax_invariants(jnp.asarray(l))
        got = T.cholesky_invariants(_t(l))
        for name in ref._fields:
            assert float(getattr(got, name)) == pytest.approx(float(getattr(ref, name)), rel=1e-12)
