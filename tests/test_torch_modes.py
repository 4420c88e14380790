"""dla_tpu_torch's potrf modes (blocked, masked, shrink and the public
``potrf()``) held against the JAX package.

The same seeded numpy matrices go through ``dla_tpu`` (JAX on the CPU with
x64, the Pallas kernels in interpret mode) and ``dla_tpu_torch`` (plain
versions on the CPU), on every panel × trailing route.

Tolerances:
- fp64 and complex128: 1e-10 of max|L| — the same formulation in fp64;
- fp32 ``highest`` and ``high``: 1e-5 of max|L| — the same formulation in
  fp32 summed in another order. At ``high`` both packages split the kernel
  products into bf16x3 (the reference writes the split out, so XLA on the
  CPU computes it too) and keep every other product IEEE fp32;
- fp32 ``default`` on the kernel routes: 2^-6 of max|L|. The port's plain
  versions take the TPU's one bf16 pass for the products and bf16-rounded
  operands for the rank-1 steps; XLA on the CPU ignores ``precision`` and
  gives the reference a pure fp32 factor, so the two differ by bf16
  roundings (2^-9 relative each) accumulated over the panel steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import dla_tpu_torch as T
import dla_tpu_torch.algos as TA
from dla_tpu.algos import potrf as jax_potrf
from dla_tpu.algos import potrf_blocked as jax_blocked
from dla_tpu.algos import potrf_masked as jax_masked
from dla_tpu.algos import potrf_shrink as jax_shrink
from dla_tpu.ops import plghe as jax_plghe
from dla_tpu.ops import plgsy as jax_plgsy
from dla_tpu.ops import potrf_unblocked as jax_unblocked
from dla_tpu.utils import precision as jprec
from dla_tpu_torch.utils import precision as tprec
from dla_tpu_torch.utils.interop import from_numpy
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

F64 = (np.float64, "high")
F32_HIGHEST = (np.float32, "highest")
F32_HIGH = (np.float32, "high")
F32_DEFAULT = (np.float32, "default")


def _a(n, seed=51, dtype=np.float64):
    return np.array(jax_plgsy(n, seed=seed, dtype=jnp.float64)).astype(dtype)


def _t(x):
    return from_numpy(x, device="cpu")


def _tol(dtype, prec, lref):
    scale = np.abs(lref).max()
    if dtype == np.float32:
        return (2**-6 if prec == "default" else 1e-5) * scale
    return 1e-10 * scale


def _both(jfn, tfn, a, prec, **kw):
    with jprec.override(prec):
        ref = np.asarray(jfn(jnp.asarray(a), **kw))
    ta = _t(a)
    with tprec.override(prec):
        got = tfn(ta, **kw)
    np.testing.assert_array_equal(ta.numpy(), a)  # the input is never written
    return ref, got.numpy()


BLOCKED = [  # (panel, trailing, diag, (dtype, precision))
    ("xla", "xla", "lax", F64),
    ("xla", "xla", "unblocked", F64),
    ("xla", "xla", "twolevel", F64),
    ("xla", "pallas", "lax", F64),
    ("pallas", "xla", "lax", F64),
    ("pallas", "pallas", "lax", F64),
    ("pallas", "pallas", "lax", F32_HIGHEST),
    ("pallas", "pallas", "lax", F32_HIGH),
    ("xla", "xla", "unblocked", F32_HIGH),
    ("pallas", "pallas", "lax", F32_DEFAULT),
]


class TestBlocked:
    @pytest.mark.parametrize("panel,trailing,diag,dt", BLOCKED)
    def test_matches_jax(self, panel, trailing, diag, dt):
        dtype, prec = dt
        a = _a(192, seed=3, dtype=dtype)
        kw = dict(nb=64, panel=panel, trailing=trailing, diag_factor=diag)
        ref, got = _both(jax_blocked, T.potrf_blocked, a, prec, **kw)
        assert np.abs(got - ref).max() <= _tol(dtype, prec, ref)
        assert np.array_equal(got, np.tril(got))

    @pytest.mark.parametrize("update_cols", [None, 64])
    def test_ragged_xla_route(self, update_cols):
        a = _a(200, seed=4)  # n % nb != 0: only the xla routes take it
        ref, got = _both(jax_blocked, T.potrf_blocked, a, "high", nb=64,
                         update_cols=update_cols)
        assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()
        np.testing.assert_allclose(got, scipy.linalg.cholesky(a, lower=True), atol=1e-9)


SHRINK = [  # (panel, trailing, extra kwargs, (dtype, precision))
    ("xla", "xla", {}, F64),
    ("invgemm", "xla", {}, F64),
    ("blocktrsm", "xla", dict(ib=32), F64),
    ("pallas", "xla", {}, F64),
    ("xla", "pallas", {}, F64),
    ("invgemm", "pallas", dict(trailing_alias=True), F64),
    ("blocktrsm", "pallas", dict(tb=32, kb=32, ib=32), F64),
    ("pallas", "pallas", {}, F64),
    ("pallas", "pallas", dict(trailing_alias=True, tb=32), F64),
    ("blocktrsm", "xla", dict(diag_factor="unblocked"), F64),
    ("invgemm", "xla", dict(diag_factor="twolevel", ib=32), F64),
    # the highest tier of the reference's bench, in miniature
    ("blocktrsm", "pallas", dict(tb=32, kb=32, ib=32), F32_HIGHEST),
    ("pallas", "pallas", {}, F32_HIGH),
    ("blocktrsm", "pallas", dict(tb=32, kb=32, ib=32), F32_HIGH),
    ("pallas", "pallas", {}, F32_DEFAULT),
]


class TestShrink:
    @pytest.mark.parametrize("panel,trailing,extra,dt", SHRINK)
    def test_matches_jax(self, panel, trailing, extra, dt):
        dtype, prec = dt
        a = _a(192, seed=5, dtype=dtype)
        kw = dict(nb=64, panel=panel, trailing=trailing, **extra)
        ref, got = _both(jax_shrink, TA.potrf_shrink, a, prec, **kw)
        assert np.abs(got - ref).max() <= _tol(dtype, prec, ref)
        assert np.array_equal(got, np.tril(got))

    def test_ragged_xla_routes(self):
        a = _a(200, seed=6)
        for panel in ("xla", "invgemm", "blocktrsm"):
            ref, got = _both(jax_shrink, TA.potrf_shrink, a, "high", nb=64, panel=panel)
            assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()


class TestMasked:
    @pytest.mark.parametrize("diag", ["lax", "unblocked"])
    def test_matches_jax(self, diag):
        a = _a(192, seed=7)
        ref, got = _both(jax_masked, T.potrf_masked, a, "high", nb=64, diag_factor=diag)
        assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()

    def test_padding_through_potrf(self):
        a = _a(200, seed=8)  # n % nb != 0: potrf pads with an identity block
        ref = np.asarray(jax_potrf(jnp.asarray(a), nb=64, mode="masked"))
        got = T.potrf(_t(a), nb=64, mode="masked").numpy()
        assert got.shape == (200, 200)
        assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()


class TestPublic:
    def test_default_mode_is_blocked(self):
        a = _a(300, seed=9)  # the default nb=256 leaves a ragged last panel
        ref = np.asarray(jax_potrf(jnp.asarray(a)))
        got = T.potrf(_t(a)).numpy()
        assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()
        np.testing.assert_array_equal(got, T.potrf_blocked(_t(a), nb=256).numpy())

    @pytest.mark.parametrize("mode", ["blocked", "masked", "shrink"])
    @pytest.mark.parametrize("uplo", ["U", "B"])
    def test_uplo(self, mode, uplo):
        n = 128
        a = _a(n, seed=10)
        if uplo == "U":
            a = np.triu(a) + np.tril(np.full((n, n), -3.0), -1)  # the lower half is junk
        ref = np.asarray(jax_potrf(jnp.asarray(a), nb=32, mode=mode, uplo=uplo))
        got = T.potrf(_t(a), nb=32, mode=mode, uplo=uplo).numpy()
        assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()

    def test_unblocked_diag_factor_matches_jax(self):
        a = _a(96, seed=11)
        ref = np.asarray(jax_unblocked(jnp.asarray(a)))
        got = T.potrf_unblocked(_t(a)).numpy()
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


class TestComplex:
    @pytest.mark.parametrize("mode,kw", [
        ("blocked", {}), ("masked", {}), ("shrink", {}),
        ("shrink", dict(panel="invgemm")), ("shrink", dict(panel="blocktrsm", ib=32)),
    ])
    def test_zpotrf_matches_jax(self, mode, kw):
        a = np.asarray(jax_plghe(128, seed=12, dtype=jnp.complex128))
        ref = np.asarray(jax_potrf(jnp.asarray(a), nb=32, mode=mode, **kw))
        got = T.potrf(_t(a), nb=32, mode=mode, **kw).numpy()
        assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()
        herm = np.tril(a) + np.tril(a, -1).conj().T
        np.testing.assert_allclose(got, scipy.linalg.cholesky(herm, lower=True), atol=1e-9)

    @pytest.mark.parametrize("kw", [dict(trailing="pallas"), dict(panel="pallas")])
    def test_kernel_routes_are_real_only(self, kw):
        a = torch.eye(64, dtype=torch.complex128)
        with pytest.raises(TypeError, match="real"):
            TA.potrf_shrink(a, nb=32, **kw)


ROUTES = [(p, t) for p in ("xla", "pallas") for t in ("xla", "pallas")] + [
    ("invgemm", "xla"), ("invgemm", "pallas"), ("blocktrsm", "xla"), ("blocktrsm", "pallas")]


class TestContracts:
    @pytest.mark.parametrize("panel,trailing", ROUTES)
    def test_nan_above_the_diagonal_is_not_read(self, panel, trailing):
        n = 128
        a = _a(n, seed=13)
        dirty = np.tril(a) + np.triu(np.full((n, n), np.nan), 1)
        fns = [TA.potrf_shrink]
        if panel in ("xla", "pallas"):
            fns.append(T.potrf_blocked)
        for fn in fns:
            kw = dict(nb=32, panel=panel, trailing=trailing)
            got = fn(_t(dirty), **kw).numpy()
            np.testing.assert_array_equal(got, fn(_t(a), **kw).numpy())

    @pytest.mark.parametrize("panel,trailing", ROUTES)
    @pytest.mark.parametrize("alias", [False, True])
    def test_input_unchanged(self, panel, trailing, alias):
        a = _t(_a(128, seed=14, dtype=np.float32))
        keep = a.clone()
        TA.potrf_shrink(a, nb=32, panel=panel, trailing=trailing, trailing_alias=alias)
        assert torch.equal(a, keep)
        if panel in ("xla", "pallas") and not alias:
            T.potrf_blocked(a, nb=32, panel=panel, trailing=trailing)
            assert torch.equal(a, keep)
        if not alias and (panel, trailing) == ("xla", "xla"):
            T.potrf_masked(a, nb=32)
            T.potrf(a, nb=48, mode="masked")  # padded
            assert torch.equal(a, keep)

    @pytest.mark.parametrize("fn,kw", [
        (T.potrf_blocked, dict(panel="pallas")), (T.potrf_blocked, dict(trailing="pallas")),
        (TA.potrf_shrink, dict(panel="pallas")), (TA.potrf_shrink, dict(trailing="pallas")),
        (T.potrf_masked, {}),
    ])
    def test_ragged_kernel_routes_raise_like_jax(self, fn, kw):
        a = _a(100, seed=15)
        jfn = {T.potrf_blocked: jax_blocked, TA.potrf_shrink: jax_shrink,
               T.potrf_masked: jax_masked}[fn]
        with pytest.raises(ValueError, match="n % nb") as want:
            jfn(jnp.asarray(a), nb=32, **kw)
        with pytest.raises(ValueError, match="n % nb") as got:
            fn(_t(a), nb=32, **kw)
        assert str(got.value) == str(want.value)
