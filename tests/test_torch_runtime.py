"""dla_tpu_torch's native host runtime (``dla_tpu_torch/runtime/``) held
against the port's torch generators and the JAX package.

- The native ``dla_plgsy`` (fp32 and fp64, the whole matrix and a panel
  region) gives, bit for bit, the port's torch ``plgsy``/``plgsy_tile`` and
  JAX's ``plgsy``: the property that lets host-generated and card-generated
  tiles agree.
- The native ``probe_x`` gives, bit for bit, the port's
  ``validate/residual.py:_probe_vec`` (fp32, exact in fp64), the numpy
  ``staging._probe_vec`` and JAX's ``_probe_vec_jnp``.
- Pack/unpack, ``norm_inf_sym_lower``, the native Freivalds probe, the memmap
  store and ``DirectPanelStore`` (direct and buffered I/O, the RAM cache's
  write-through, the scratch region, the pool, its refusals), as
  ``tests/test_runtime.py:14-79`` and the panel-store cases there.
- ``hostblas`` in place on sub-views, as ``tests/test_hostblas.py``, against
  numpy/scipy: fp64 1e-12 (1e-10 after a solve), fp32 1e-5 (1e-4 after a
  solve or a factor, 5e-4 for the blocked panel factor).
- The library's build: named by source, flags and CPU, built once.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from dla_tpu.ops import plgsy as jax_plgsy
from dla_tpu.runtime import staging as jax_staging
from dla_tpu.validate.residual import _probe_vec_jnp
from dla_tpu_torch.ops import plgsy, plgsy_tile
from dla_tpu_torch.runtime import hostblas as hb
from dla_tpu_torch.runtime import staging as S
from dla_tpu_torch.runtime.staging import DirectPanelStore, HostTileStore
from dla_tpu_torch.validate.residual import _probe_vec
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = Path(__file__).resolve().parents[1]
DTYPES = [np.float32, np.float64]
TORCH = {np.float32: torch.float32, np.float64: torch.float64}


class TestNativeGenerator:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("n,seed", [(96, 51), (200, 7)])
    def test_plgsy_bits_of_torch_and_jax(self, dtype, n, seed):
        with HostTileStore(n, dtype) as st:
            st.fill_plgsy(seed=seed)
            native = st.array.copy()
        port = plgsy(n, seed=seed, dtype=TORCH[dtype], device="cpu").numpy()
        ref = np.asarray(jax_plgsy(n, bump=float(n), seed=seed, dtype=jnp.dtype(dtype)))
        assert native.dtype == dtype
        np.testing.assert_array_equal(native, port)
        np.testing.assert_array_equal(native, ref)

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_panel_region_bits_of_plgsy_tile(self, dtype):
        """A DirectPanelStore panel (rows k0.., columns k0..k0+w) from the
        native generator is the port's plgsy_tile of that region."""
        n, w, k0, bump = 512, 128, 256, 3.5
        out = np.empty((n - k0, w), dtype)
        gen = getattr(S.lib(), f"dla_plgsy_{S._suf(dtype)}")
        gen(out.ctypes.data, w, 99, k0, k0, n - k0, w, bump)
        ref = plgsy_tile(99, k0, k0, n - k0, w, bump=bump, dtype=TORCH[dtype], device="cpu")
        np.testing.assert_array_equal(out, ref.numpy())

    def test_native_libraries_agree(self):
        """The port's copy of tilestore.cpp and the JAX package's build give
        the same bits."""
        n = 64
        with HostTileStore(n, np.float32) as a, jax_staging.HostTileStore(n, np.float32) as b:
            a.fill_plgsy(seed=3)
            b.fill_plgsy(seed=3)
            np.testing.assert_array_equal(a.array, b.array)


class TestProbe:
    @pytest.mark.parametrize("p", range(4))
    def test_probe_x_bits(self, p):
        n, seed = 4099, 0xC0FFEE ^ p
        native = S.probe_x(n, seed)
        torch_probe = _probe_vec(n, seed, "cpu")
        assert torch_probe.dtype == torch.float32
        np.testing.assert_array_equal(native, torch_probe.double().numpy())
        np.testing.assert_array_equal(native, S._probe_vec(n, seed))
        np.testing.assert_array_equal(native, np.asarray(_probe_vec_jnp(n, seed), np.float64))
        assert native.min() >= -0.5 and native.max() < 0.5


class TestHostTileStore:
    def test_pack_unpack_roundtrip(self):
        n = 64
        with HostTileStore(n, np.float32) as st:
            st.array[:] = np.arange(n * n, dtype=np.float32).reshape(n, n)
            t = st.pack(16, 32, 24, 16)
            np.testing.assert_array_equal(t, st.array[16:40, 32:48])
            out = np.empty((24, 16), np.float32)
            assert st.pack(16, 32, 24, 16, out=out) is out
            np.testing.assert_array_equal(out, t)
            st.unpack(0, 0, t * 2)
            np.testing.assert_array_equal(st.array[:24, :16], t * 2)

    def test_norm_inf_sym_lower(self):
        n = 48
        rng = np.random.default_rng(0)
        g = rng.standard_normal((n, n))
        a = (g + g.T) / 2 + n * np.eye(n)
        with HostTileStore(n, np.float64) as st:
            st.array[:] = np.tril(a)
            got = st.norm_inf_sym_lower()
        np.testing.assert_allclose(got, np.abs(a).sum(axis=1).max(), rtol=1e-12)

    def test_freivalds_detects_good_and_bad(self):
        n = 64
        rng = np.random.default_rng(1)
        g = rng.standard_normal((n, n))
        a = (g + g.T) / 2 + n * np.eye(n)
        l = scipy.linalg.cholesky(a, lower=True)
        with HostTileStore(n, np.float64) as sa, HostTileStore(n, np.float64) as sl:
            sa.array[:] = np.tril(a)
            sl.array[:] = l
            good = sa.freivalds_residual(sl)
            sl.array[3, 2] += 1.0  # corrupt the factor
            bad = sa.freivalds_residual(sl)
        assert good < 1e-12, good
        assert bad > 1e-6, bad

    def test_memmap_backed(self, tmp_path):
        n = 32
        p = str(tmp_path / "mat.bin")
        with HostTileStore(n, np.float32, path=p) as st:
            st.fill_plgsy(seed=3)
            first = st.array.copy()
        with HostTileStore(n, np.float32, path=p) as st2:
            np.testing.assert_array_equal(st2.array, first)

    def test_rejects_other_dtypes(self):
        with pytest.raises(ValueError, match="unsupported dtype"):
            HostTileStore(8, np.int32)


def _panel_of(n, panel, j, seed=51, dtype=np.float64):
    with HostTileStore(n, dtype) as st:
        st.fill_plgsy(seed=seed)
        return st.array[j * panel :, j * panel : (j + 1) * panel].copy()


class TestDirectPanelStore:
    @pytest.mark.parametrize("direct,n,panel", [(True, 1024, 512), (False, 128, 32)])
    def test_fill_pack_unpack(self, tmp_path, direct, n, panel):
        """Generation bits, row-suffix packs, whole-panel writes, and the
        file read back by a fresh store (a fresh process's view)."""
        p = str(tmp_path / "p.bin")
        with DirectPanelStore(n, np.float64, path=p, panel=panel, direct=direct) as st:
            assert st.direct <= direct  # a filesystem without O_DIRECT falls back
            st.fill_plgsy(seed=51)
            for j in range(st.npan):
                j0 = j * panel
                b = st.pack(j0, j0, n - j0, panel)
                np.testing.assert_array_equal(b, _panel_of(n, panel, j))
                st.release(b)
            j0 = panel
            b = st.pack(n - panel, j0, panel, panel)  # a row-suffix inside panel 1
            np.testing.assert_array_equal(b, _panel_of(n, panel, 1)[n - panel - j0 :])
            st.release(b)
            new = np.full((n - j0, panel), 2.5)
            st.unpack(j0, j0, new)
        with DirectPanelStore(n, np.float64, path=p, panel=panel, direct=direct) as st2:
            b = st2.pack(j0, j0, n - j0, panel)
            np.testing.assert_array_equal(b, new)
            st2.release(b)

    def test_height_bucket_overhang_is_zero(self, tmp_path):
        n, panel = 128, 32
        with DirectPanelStore(n, np.float64, path=str(tmp_path / "p.bin"), panel=panel,
                              direct=False) as st:
            st.fill_plgsy(seed=5)
            b = st.pack(64, 32, 96, panel)  # 64 real rows, 32 of overhang
            np.testing.assert_array_equal(b[:64], _panel_of(n, panel, 1, seed=5)[32:])
            assert not b[64:].any()
            st.release(b)

    @pytest.mark.parametrize("direct", [True, False])
    def test_ram_cache_writes_through(self, tmp_path, direct):
        n, panel = 1024, 512
        p = str(tmp_path / "p.bin")
        with DirectPanelStore(n, np.float64, path=p, panel=panel, direct=direct,
                              ram_cache=True) as st:
            st.fill_plgsy(seed=51)
            st.unpack(panel, panel, np.full((n - panel, panel), -1.0))
        with DirectPanelStore(n, np.float64, path=p, panel=panel, direct=direct) as cold:
            b = cold.pack(panel, panel, n - panel, panel)
            assert (b == -1.0).all()
            cold.release(b)
        with DirectPanelStore(n, np.float64, path=p, panel=panel, direct=direct,
                              ram_cache=True) as warm:  # re-warmed from the file
            np.testing.assert_array_equal(warm._cache_panel(0), _panel_of(n, panel, 0))

    def test_scratch_commit(self, tmp_path):
        n, panel = 128, 32
        with DirectPanelStore(n, np.float64, path=str(tmp_path / "p.bin"), panel=panel,
                              direct=False, ram_cache=True) as st:
            st.fill_plgsy(seed=51)
            data = np.arange((n - 2 * panel) * panel, dtype=np.float64).reshape(-1, panel)
            st.write_scratch(data)
            b = st.pack(2 * panel, 2 * panel, n - 2 * panel, panel)
            np.testing.assert_array_equal(b, _panel_of(n, panel, 2))  # untouched until commit
            st.release(b)
            st.commit_scratch(2)
            b = st.pack(2 * panel, 2 * panel, n - 2 * panel, panel)
            np.testing.assert_array_equal(b, data)
            np.testing.assert_array_equal(st._cache_panel(2), data)
            st.release(b)

    def test_pool_reuses_and_reclaims(self, tmp_path):
        n, panel = 128, 32
        with DirectPanelStore(n, np.float64, path=str(tmp_path / "p.bin"), panel=panel,
                              direct=False) as st:
            a = st.pack(0, 0, n, panel)
            addr = a.ctypes.data
            st.release(a)
            b = st.pack(panel, panel, n - panel, panel)  # smaller: best fit reuses a's buffer
            assert b.ctypes.data == addr
            del b  # dropped unreleased: the finalizer returns it to the pool
            assert st.auto_reclaimed == 1 and len(st._free) == 1

    def test_rejects_unaligned_direct(self, tmp_path):
        with pytest.raises(ValueError, match="multiple of 4096"):
            DirectPanelStore(128, np.float64, path=str(tmp_path / "x.bin"), panel=32)

    def test_rejects_n_not_multiple_of_panel(self, tmp_path):
        with pytest.raises(ValueError, match="multiple of panel"):
            DirectPanelStore(100, np.float64, path=str(tmp_path / "x.bin"), panel=32,
                             direct=False)

    def test_access_pattern_guard(self, tmp_path):
        with DirectPanelStore(1024, np.float64, path=str(tmp_path / "p.bin"),
                              panel=512) as st:
            with pytest.raises(ValueError, match="row-suffixes"):
                st.pack(0, 0, 512, 512)  # not a row-suffix (h != n - i0)
            with pytest.raises(ValueError, match="row-suffixes"):
                st.pack(0, 512, 1024, 512)  # above the diagonal
            with pytest.raises(ValueError, match="panel-aligned"):
                st.pack(0, 100, 1024, 512)
            with pytest.raises(ValueError, match="unsupported unpack"):
                st.unpack(512, 0, np.zeros((512, 512)))


@pytest.fixture(params=DTYPES, ids=["f32", "f64"])
def dtype(request):
    return request.param


def _tol(dtype):
    return 1e-5 if dtype == np.float32 else 1e-12


class TestHostBlas:
    def test_available(self):
        assert hb.available()

    def test_gemm_inplace_subview(self, dtype):
        rng = np.random.default_rng(0)
        c = np.asarray(rng.standard_normal((64, 48)), dtype)
        a = np.asarray(rng.standard_normal((32, 16)), dtype)
        b = np.asarray(rng.standard_normal((24, 16)), dtype)
        sub = c[10:42, 5:29]  # strided view, ld = 48
        ref = c.copy()
        ref[10:42, 5:29] = -1.5 * (a @ b.T) + 0.5 * sub
        hb.gemm(-1.5, a, b, 0.5, sub, transb=True)
        np.testing.assert_allclose(c, ref, rtol=_tol(dtype), atol=_tol(dtype))

    def test_gemm_transa(self, dtype):
        rng = np.random.default_rng(1)
        a = np.asarray(rng.standard_normal((16, 32)), dtype)
        b = np.asarray(rng.standard_normal((16, 24)), dtype)
        c = np.zeros((32, 24), dtype)
        hb.gemm(1.0, a, b, 0.0, c, transa=True)
        np.testing.assert_allclose(c, a.T @ b, rtol=_tol(dtype), atol=_tol(dtype))

    def test_gemm_shape_mismatch(self, dtype):
        with pytest.raises(ValueError, match="shape mismatch"):
            hb.gemm(1.0, np.zeros((4, 5), dtype), np.zeros((4, 5), dtype),
                    0.0, np.zeros((4, 4), dtype))

    def test_trsm_right_lower_trans(self, dtype):
        rng = np.random.default_rng(2)
        l = np.tril(np.asarray(rng.standard_normal((16, 16)), dtype))
        l[np.diag_indices(16)] = np.abs(l[np.diag_indices(16)]) + 4.0
        b = np.asarray(rng.standard_normal((40, 16)), dtype)
        ref = scipy.linalg.solve_triangular(
            np.asarray(l, np.float64), np.asarray(b, np.float64).T, lower=True).T
        hb.trsm(1.0, l, b, side="R", lower=True, transa=True)
        np.testing.assert_allclose(b, ref, rtol=1e-4 if dtype == np.float32 else 1e-10)

    def test_trsm_left_lower(self, dtype):
        rng = np.random.default_rng(6)
        l = np.tril(np.asarray(rng.standard_normal((16, 16)), dtype))
        l[np.diag_indices(16)] = np.abs(l[np.diag_indices(16)]) + 4.0
        b = np.asarray(rng.standard_normal((16, 8)), dtype)
        ref = scipy.linalg.solve_triangular(np.asarray(l, np.float64),
                                            np.asarray(b, np.float64), lower=True)
        hb.trsm(1.0, l, b, side="L", lower=True)
        np.testing.assert_allclose(b, ref, rtol=1e-4 if dtype == np.float32 else 1e-10)

    def test_syrk_lower(self, dtype):
        rng = np.random.default_rng(3)
        a = np.asarray(rng.standard_normal((24, 8)), dtype)
        c = np.asarray(rng.standard_normal((24, 24)), dtype)
        ref = c.copy()
        low = np.tril_indices(24)
        ref[low] = (-1.0 * (a @ a.T) + c)[low]  # syrk touches only the lower triangle
        hb.syrk(-1.0, a, 1.0, c, lower=True)
        np.testing.assert_allclose(c, ref, rtol=_tol(dtype), atol=_tol(dtype))

    def test_potrf_inplace(self, dtype):
        rng = np.random.default_rng(4)
        m = rng.standard_normal((32, 32))
        spd = (m @ m.T + 32 * np.eye(32)).astype(dtype)
        a = spd.copy()
        assert hb.potrf(a) == 0
        ref = scipy.linalg.cholesky(np.asarray(spd, np.float64), lower=True)
        np.testing.assert_allclose(np.tril(a), ref, rtol=1e-4 if dtype == np.float32 else 1e-10)

    def test_potrf_reports_non_spd(self):
        a = np.eye(8, dtype=np.float64)
        a[5, 5] = -1.0
        assert hb.potrf(a) == 6  # 1-based pivot index, LAPACK's info

    def test_factor_panel_matches_cholesky(self, dtype):
        rng = np.random.default_rng(5)
        n, w, nb = 96, 48, 16
        m = rng.standard_normal((n, n))
        spd = m @ m.T + n * np.eye(n)
        ref = scipy.linalg.cholesky(spd, lower=True)
        panel = np.ascontiguousarray(spd[:, :w]).astype(dtype)
        hb.factor_panel(panel, nb)
        tol = 5e-4 if dtype == np.float32 else 1e-10
        np.testing.assert_allclose(np.asarray(panel, np.float64), ref[:, :w], rtol=tol, atol=tol)
        assert np.abs(np.triu(panel[:w], 1)).max() == 0  # tril contract

    def test_factor_panel_rejects_wide_and_non_spd(self):
        with pytest.raises(ValueError, match="tall"):
            hb.factor_panel(np.zeros((8, 16), np.float64), 4)
        with pytest.raises(np.linalg.LinAlgError, match="not SPD"):
            hb.factor_panel(-np.eye(8), 4)

    def test_ld_rejects_non_rowmajor(self):
        a = np.zeros((8, 8), np.float64)
        with pytest.raises(ValueError, match="row-major"):
            hb.gemm(1.0, a.T[:4, :4], a[:4, :4], 0.0, np.zeros((4, 4)))

    def test_rejects_other_dtypes(self):
        with pytest.raises(TypeError, match="float32/float64"):
            hb.potrf(np.eye(4, dtype=np.int64))


class TestBuild:
    def test_library_named_by_source_flags_and_cpu(self, monkeypatch):
        path = S.library_path()
        assert path.parent == REPO / "build" / "dla_tpu_torch"
        assert path.name.startswith("libdlats_") and path.suffix == ".so"
        assert S.build() == path and path.exists()
        monkeypatch.setattr(S, "_cpu_flags", lambda: b"flags : another cpu")
        other_cpu = S.library_path()
        monkeypatch.setattr(S, "CXX_FLAGS", S.CXX_FLAGS + ("-DDLA_OTHER",))
        assert len({path, other_cpu, S.library_path()}) == 3

    def test_missing_compiler_raises(self, monkeypatch, tmp_path):
        monkeypatch.setattr(S, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(S, "library_path", lambda: tmp_path / "libdlats_x.so")
        monkeypatch.setenv("CXX", "")
        monkeypatch.setenv("PATH", str(tmp_path))
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            S.build()

    def test_a_compiler_that_cannot_link_openmp_is_passed_over(self, monkeypatch, tmp_path):
        """A $CXX whose driver fails (as one without libgomp.spec does on
        -fopenmp) gives way to the g++ on PATH."""
        bad = tmp_path / "bin" / "g++"
        bad.parent.mkdir()
        bad.write_text("#!/bin/sh\necho 'cannot read spec file libgomp.spec' >&2\nexit 1\n")
        bad.chmod(0o755)
        monkeypatch.setattr(S, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(S, "library_path", lambda: tmp_path / "libdlats_x.so")
        monkeypatch.setenv("CXX", str(bad))
        assert S._compilers()[0] == str(bad) and len(S._compilers()) >= 2
        assert S.build() == tmp_path / "libdlats_x.so"
        assert (tmp_path / "libdlats_x.so").exists()
        monkeypatch.setenv("PATH", str(bad.parent))
        (tmp_path / "libdlats_x.so").unlink()
        with pytest.raises(RuntimeError, match="libgomp.spec"):
            S.build()

    def test_failed_build_raises(self, monkeypatch, tmp_path):
        monkeypatch.setattr(S, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(S, "library_path", lambda: tmp_path / "libdlats_x.so")
        monkeypatch.setattr(S, "CXX_FLAGS", S.CXX_FLAGS + ("-DDLA_OTHER", "-fno-such-flag"))
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            S.build()
        assert not (tmp_path / "libdlats_x.so").exists()

    def test_modules_import_with_jax_blocked(self):
        code = ("import sys; sys.modules['jax'] = None; sys.modules['dla_tpu'] = None\n"
                "import dla_tpu_torch.runtime.staging, dla_tpu_torch.runtime.hostblas\n"
                "import dla_tpu_torch.algos.oocore, dla_tpu_torch.cli.oocore_driver\n"
                "import dla_tpu_torch.algos as A; print(A.posv_refined_streamed.__name__)")
        env = dict(os.environ, PYTHONPATH=str(REPO))
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert "posv_refined_streamed" in proc.stdout
