"""dla_tpu_torch's panel kernels (``panel_factor``, ``panel_apply``) held
against the JAX Pallas kernels.

On the CPU each wrapper runs its plain torch version; the JAX kernels run in
interpret mode, as in tests/test_kernels.py, at the shapes of that file. The
CUDA kernels are held against the plain versions on the card in
tests/test_torch_gpu.py.

Tolerances:
- fp64: 1e-12 of max|out| — the same rank-1 steps and products in fp64;
- fp32 ``highest`` and ``high``: 1e-5 of max|out| (``panel_apply``: of
  max|X|) — the same steps in fp32, products summed in another order; at
  ``high`` both packages write the bf16x3 split out;
- fp32 ``default``: 2^-6 of max|out|. The port keeps the TPU's semantics
  (bf16-rounded operands in the rank-1 steps, one bf16 pass for the
  products); XLA on the CPU ignores ``precision``, so the reference's
  interpret-mode value is pure fp32, and the two differ by bf16 roundings
  (2^-9 relative each) accumulated over nb steps. There is no bit-level CPU
  twin of ``default``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import dla_tpu_torch as T
import dla_tpu_torch.algos as TA
from dla_tpu.algos import potrf_inplace as jax_potrf_inplace
from dla_tpu.kernels.pallas_tiles import panel_apply as jax_panel_apply
from dla_tpu.kernels.pallas_tiles import panel_factor as jax_panel_factor
from dla_tpu.ops import plgsy as jax_plgsy
from dla_tpu.utils import precision as jprec
from dla_tpu_torch.kernels import panel
from dla_tpu_torch.kernels.panel import (
    panel_apply,
    panel_apply_plain,
    panel_factor,
    panel_factor_plain,
)
from dla_tpu_torch.utils import precision as tprec
from dla_tpu_torch.utils.interop import from_numpy
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _t(x):
    return from_numpy(x, device="cpu")


def _spd(n, seed):
    g = np.random.default_rng(seed).standard_normal((n, n))
    return g @ g.T + n * np.eye(n)


def _tol(dtype, prec, ref):
    scale = np.abs(ref).max()
    if dtype == np.float64:
        return 1e-12 * scale
    return (2**-6 if prec == "default" else 1e-5) * scale


def _panel(m, nb, dtype):
    """The first column panel of an SPD matrix, lower part only."""
    return np.tril(_spd(m, seed=m + nb))[:, :nb].astype(dtype)


class TestPanelFactor:
    @pytest.mark.parametrize("m,nb,dtype,prec", [
        (32, 32, np.float64, "high"), (128, 32, np.float64, "high"),
        (256, 64, np.float64, "high"),  # tests/test_kernels.py:71
        (128, 32, np.float32, "highest"), (256, 64, np.float32, "high"),
        (256, 64, np.float32, "default"),
    ])
    def test_plain_matches_jax(self, m, nb, dtype, prec):
        p = _panel(m, nb, dtype)
        with jprec.override(prec):
            ref = np.asarray(jax_panel_factor(jnp.asarray(p)))
        with tprec.override(prec):
            got = panel_factor(_t(p)).numpy()
        assert np.abs(got - ref).max() <= _tol(dtype, prec, ref)
        assert np.array_equal(got[:nb], np.tril(got[:nb]))

    def test_matches_scipy(self):
        m, nb = 256, 64
        a = _spd(m, seed=1)
        got = panel_factor(_t(np.tril(a)[:, :nb])).numpy()
        ref = scipy.linalg.cholesky(a, lower=True)[:, :nb]
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)

    def test_reads_the_lower_triangle_only(self):
        p = _panel(128, 32, np.float64)
        dirty = p.copy()
        dirty[:32] += np.triu(np.full((32, 32), np.nan), 1)
        ref = np.asarray(jax_panel_factor(jnp.asarray(dirty)))
        got = panel_factor(_t(dirty)).numpy()
        assert np.isfinite(got).all() and np.isfinite(ref).all()
        np.testing.assert_array_equal(got, panel_factor(_t(p)).numpy())

    def test_checks_like_jax(self):
        for bad in (np.zeros((100, 32)), np.zeros((2048, 1024), np.float32)):
            with pytest.raises(ValueError) as want:
                jax_panel_factor(jnp.asarray(bad))
            with pytest.raises(ValueError) as got:
                panel_factor(_t(bad))
            assert str(got.value) == str(want.value)
        with pytest.raises(TypeError, match="real"):
            panel_factor(torch.zeros(64, 32, dtype=torch.complex64))

    def test_cpu_runs_plain_and_counts_no_launch(self):
        p = _t(_panel(96, 32, np.float64))
        before = panel.panel_factor_launches
        assert torch.equal(panel_factor(p), panel_factor_plain(p))
        assert panel.panel_factor_launches == before
        with pytest.raises(ValueError):
            panel_factor(torch.zeros(64, 32, device="meta"))


def _lkk_b(m, nb):
    rng = np.random.default_rng(m + nb)
    lkk = np.tril(rng.standard_normal((nb, nb))) + nb * np.eye(nb)
    return lkk.astype(np.float32), rng.standard_normal((m, nb)).astype(np.float32)


class TestPanelApply:
    @pytest.mark.parametrize("m,nb,ib,tb,prec", [
        (128, 32, 16, 64, "highest"),  # multi-block: correction products
        (96, 32, 32, 32, "highest"),  # nk=1: the inverse alone
        (64, 16, 8, 64, "highest"),  # tb > m: clamped to m
        (128, 32, 16, 64, "high"),
        (128, 32, 16, 64, "default"),
    ])
    def test_plain_matches_jax(self, m, nb, ib, tb, prec):
        lkk, b = _lkk_b(m, nb)
        with jprec.override(prec):
            ref = np.asarray(jax_panel_apply(jnp.asarray(lkk), jnp.asarray(b), ib=ib, tb=tb))
        with tprec.override(prec):
            got = panel_apply(_t(lkk), _t(b), ib=ib, tb=tb).numpy()
        assert np.abs(got - ref).max() <= _tol(np.float32, prec, ref)
        x = scipy.linalg.solve_triangular(lkk.astype(np.float64), b.T.astype(np.float64),
                                          lower=True).T
        if prec != "default":
            np.testing.assert_allclose(got, x, rtol=2e-4, atol=2e-4)

    def test_checks_like_jax(self):
        lkk = np.eye(32, dtype=np.float32)
        for b, kw in ((np.zeros((64, 32), np.float32), dict(ib=24)),
                      (np.zeros((72, 32), np.float32), dict(ib=16, tb=48)),
                      (np.zeros((64, 16), np.float32), dict(ib=16))):
            with pytest.raises(ValueError) as want:
                jax_panel_apply(jnp.asarray(lkk), jnp.asarray(b), **kw)
            with pytest.raises(ValueError) as got:
                panel_apply(_t(lkk), _t(b), **kw)
            assert str(got.value) == str(want.value)
        with pytest.raises(ValueError, match="real-only"):
            panel_apply(torch.eye(32, dtype=torch.complex64),
                        torch.zeros(64, 32, dtype=torch.complex64), ib=16)
        with pytest.raises(TypeError, match="float32"):  # the port takes fp32 only
            panel_apply(torch.eye(32, dtype=torch.float64), torch.zeros(64, 32,
                        dtype=torch.float64), ib=16)

    def test_cpu_runs_plain_and_counts_no_launch(self):
        lkk, b = map(_t, _lkk_b(64, 32))
        before = panel.panel_apply_launches
        assert torch.equal(panel_apply(lkk, b, ib=16), panel_apply_plain(lkk, b, ib=16))
        assert panel.panel_apply_launches == before


class TestInplacePallasPanel:
    @pytest.mark.parametrize("prec", ["highest", "high"])
    def test_matches_jax(self, prec):
        n = 256
        a = np.asarray(jax_plgsy(n, seed=3, dtype=jnp.float32))
        kw = dict(nb=128, tb=64, kb=64, ib=64, panel="pallas", panel_ib=64, precision=prec)
        ref = np.tril(np.asarray(jax_potrf_inplace(jnp.asarray(a), **kw)))
        got = np.tril(TA.potrf_inplace(_t(a.copy()), **kw).numpy())
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
        blk = np.tril(TA.potrf_inplace(_t(a.copy()), **dict(kw, panel="blocktrsm")).numpy())
        assert np.abs(got - blk).max() <= 1e-5 * np.abs(blk).max()

    @pytest.mark.parametrize("dtype,nb,panel_ib", [
        (torch.float64, 64, 32), (torch.float32, 96, 64), (torch.float32, 4096, 256)])
    def test_gate_like_jax(self, dtype, nb, panel_ib):
        a = torch.eye(nb, dtype=dtype)
        with pytest.raises(ValueError, match="panel='pallas' needs real fp32"):
            TA.potrf_inplace(a, nb=nb, tb=nb, panel="pallas", panel_ib=panel_ib)
