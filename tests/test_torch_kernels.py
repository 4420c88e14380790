"""dla_tpu_torch's trailing update held against the JAX Pallas kernel.

On the CPU the wrapper runs its plain torch version; the JAX kernel runs in
interpret mode, as in tests/test_kernels.py. The CUDA kernel is held against
the plain version on the card in tests/test_torch_gpu.py.

Tolerances, relative to ``scale = max_i ||p_i||²`` (= max |P·Pᵀ|):
- fp64: 1e-12;
- fp32 highest/high/default: 1e-5 — both sides form the same partial
  products (high: the bf16x3 split; default: bf16 operands, fed to both sides
  pre-rounded because XLA on the CPU ignores ``precision``); only the order
  of summation differs;
- bf16 storage: 2^-6 of (max|c| + scale) — two bf16 roundings (of the
  product and of the difference) may each land one ulp apart.
"""

import ml_dtypes
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dla_tpu.kernels.pallas_tiles import trailing_update_lower as jax_trailing
from dla_tpu.utils import precision as jprec
from dla_tpu_torch.kernels import _build, tiles
from dla_tpu_torch.kernels.tiles import trailing_update_lower, trailing_update_lower_plain
from dla_tpu_torch.utils import precision as tprec
from dla_tpu_torch.utils.interop import from_numpy, to_numpy
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SHAPES = [(64, 32, 32), (128, 32, 16), (96, 32, 32)]


def _inputs(m, tb, nb, origin, dtype, seed=0, bf16_operands=False):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((m, m))
    p = rng.standard_normal((m - origin * tb, nb))
    if bf16_operands:
        p = p.astype(ml_dtypes.bfloat16).astype(np.float64)
    return c.astype(dtype), p.astype(dtype)


def _scale(c, p):
    p64 = np.asarray(p, np.float64)
    return (p64**2).sum(1).max(), np.abs(np.asarray(c, np.float64)).max()


def _tol(dtype, c, p):
    scale, cmax = _scale(c, p)
    if dtype == np.float64:
        return 1e-12 * scale
    if dtype == np.float32:
        return 1e-5 * scale
    return 2**-6 * (cmax + scale)


def _lower_mask(m, tb, origin):
    """True on the elements the update must touch."""
    idx = np.arange(m) // tb
    inwin = idx >= origin
    return (idx[:, None] >= idx[None, :]) & inwin[:, None] & inwin[None, :]


def _run_both(m, tb, nb, origin, kb, alias, prec, dtype):
    c, p = _inputs(m, tb, nb, origin, dtype, seed=m + nb + origin,
                   bf16_operands=prec == "default")
    with jprec.override(prec):
        ref = np.asarray(jax_trailing(jnp.asarray(c), jnp.asarray(p), tb=tb, kb=kb,
                                      alias=alias, origin=origin))
    tc = from_numpy(c, device="cpu")
    with tprec.override(prec):
        out = trailing_update_lower(tc, from_numpy(p, device="cpu"), tb=tb, kb=kb,
                                    alias=alias, origin=origin)
    return c, p, ref, tc, out


class TestPlainAgainstJax:
    @pytest.mark.parametrize("prec", ["highest", "high", "default"])
    @pytest.mark.parametrize("m,tb,nb", SHAPES)
    def test_fp32_tiers(self, m, tb, nb, prec):
        c, p, ref, tc, out = _run_both(m, tb, nb, 0, None, True, prec, np.float32)
        assert out is tc  # alias=True updates in place
        got = out.numpy()
        mask = _lower_mask(m, tb, 0)
        assert np.abs(got - ref)[mask].max() <= _tol(np.float32, c, p)
        np.testing.assert_array_equal(got[~mask], c[~mask])

    @pytest.mark.parametrize("m,tb,nb,origin,kb", [
        s + o for s in SHAPES for o in [(0, 8), (1, None)]
    ] + [(128, 32, 16, 2, 8), (96, 32, 32, 2, 16)])
    def test_fp64_origin_and_kb(self, m, tb, nb, origin, kb):
        c, p, ref, _, out = _run_both(m, tb, nb, origin, kb, True, "high", np.float64)
        got = out.numpy()
        mask = _lower_mask(m, tb, origin)
        assert np.abs(got - ref)[mask].max() <= _tol(np.float64, c, p)
        np.testing.assert_array_equal(got[~mask], c[~mask])

    @pytest.mark.parametrize("m,tb,nb", SHAPES)
    def test_alias_false_leaves_input(self, m, tb, nb):
        c, p, ref, tc, out = _run_both(m, tb, nb, 0, 16, False, "high", np.float32)
        assert out is not tc
        np.testing.assert_array_equal(tc.numpy(), c)
        got = out.numpy()
        mask = _lower_mask(m, tb, 0)
        # the reference leaves unvisited tiles undefined here: compare lower only
        assert np.abs(got - ref)[mask].max() <= _tol(np.float32, c, p)
        np.testing.assert_array_equal(got[~mask], c[~mask])

    @pytest.mark.parametrize("m,tb,nb", SHAPES)
    @pytest.mark.parametrize("origin", [0, 1])
    def test_bf16_storage(self, m, tb, nb, origin):
        c, p = _inputs(m, tb, nb, origin, np.float32, seed=m * 3 + origin)
        c, p = c.astype(ml_dtypes.bfloat16), p.astype(ml_dtypes.bfloat16)
        ref = np.asarray(jax_trailing(jnp.asarray(c), jnp.asarray(p), tb=tb, origin=origin))
        out = trailing_update_lower(from_numpy(c, device="cpu"), from_numpy(p, device="cpu"),
                                    tb=tb, origin=origin)
        got = to_numpy(out)
        assert got.dtype == ref.dtype
        mask = _lower_mask(m, tb, origin)
        diff = np.abs(got.astype(np.float64) - ref.astype(np.float64))
        assert diff[mask].max() <= _tol(ml_dtypes.bfloat16, c, p)
        np.testing.assert_array_equal(got[~mask].view(np.uint16), c[~mask].view(np.uint16))


class TestWrapper:
    def test_cpu_runs_plain_and_counts_no_launch(self):
        c, p = _inputs(64, 32, 16, 0, np.float64)
        before = tiles.launches
        got = trailing_update_lower(torch.from_numpy(c.copy()), torch.from_numpy(p), tb=32)
        ref = trailing_update_lower_plain(torch.from_numpy(c.copy()), torch.from_numpy(p), tb=32)
        assert torch.equal(got, ref)
        assert tiles.launches == before

    @pytest.mark.parametrize("fn", [trailing_update_lower, trailing_update_lower_plain])
    def test_shape_checks(self, fn):
        with pytest.raises(ValueError):  # panel rows != window
            fn(torch.zeros(64, 64), torch.zeros(32, 16), tb=32)
        with pytest.raises(ValueError):  # m not a multiple of tb
            fn(torch.zeros(60, 60), torch.zeros(60, 16), tb=32)
        with pytest.raises(ValueError):  # origin without alias
            fn(torch.zeros(64, 64), torch.zeros(32, 16), tb=32, origin=1, alias=False)
        with pytest.raises(ValueError):  # kb must divide nb
            fn(torch.zeros(64, 64), torch.zeros(64, 16), tb=32, kb=6)
        with pytest.raises(ValueError):
            fn(torch.zeros(64, 32), torch.zeros(64, 16), tb=32)

    @pytest.mark.parametrize("cdt,pdt", [
        (torch.complex64, torch.complex64), (torch.float32, torch.float64),
        (torch.float16, torch.float16), (torch.int32, torch.int32),
    ])
    def test_dtype_checks(self, cdt, pdt):
        with pytest.raises(TypeError):
            trailing_update_lower(torch.zeros(64, 64, dtype=cdt), torch.zeros(64, 16, dtype=pdt),
                                  tb=32)

    def test_other_devices_raise(self):
        with pytest.raises(ValueError):
            trailing_update_lower(torch.zeros(64, 64, device="meta"),
                                  torch.zeros(64, 16, device="meta"), tb=32)

    def test_build_needs_nvcc(self, monkeypatch):
        monkeypatch.setenv("CUDA_HOME", "/nonexistent")
        monkeypatch.setenv("PATH", "")
        with pytest.raises(RuntimeError, match="nvcc"):
            _build._nvcc()

    def test_library_named_by_source_hash(self, monkeypatch):
        lib = _build.library_path()
        assert lib.parent == _build.BUILD_DIR and lib.parent.parts[-2:] == ("build", "dla_tpu_torch")
        assert lib == _build.library_path()
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
        assert _build.library_path() != lib
