"""dla_tpu_torch's complex (c/z) dtypes, uplo U/B, the rest of ``ops``,
``potrf_checked`` and the driver's full flag surface, held against dla_tpu
on the same numpy inputs (JAX on the CPU under x64, as tests/conftest.py sets
it; its Pallas kernels in interpret mode).

What is compared how:
- ``plghe``/``plghe_tile``: the same bits, complex64 and complex128, also
  against JAX's complex64 without x64 (the mode JAX's driver runs ``c`` in);
- ``spd_gershgorin``: the same bits off the diagonal; on it within 2 ulp
  (row sums in another order than XLA's);
- ``lacpy``, ``geadd``: the same bits;
- the 3M complex product against the 4M one: within 1e-14 (complex128) and
  1e-5 (complex64) of the product's largest entry;
- factors and solves: complex128 within 1e-12, complex64 within 1e-5 of the
  largest entry of JAX's result;
- ``potrf_checked``: the message checkify gives, or None;
- the driver in this process: JAX's exit codes and contract lines, the
  residuals within the same tolerances.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dla_tpu.algos as JA
import dla_tpu.ops as JO
import dla_tpu_torch as T
import dla_tpu_torch.algos as TA
from dla_tpu.algos import packed as JP
from dla_tpu.cli import potrf_driver as jax_driver
from dla_tpu.ops import blas as jax_blas
from dla_tpu.validate.checked import potrf_checked as jax_checked
from dla_tpu_torch.algos import packed as TP
from dla_tpu_torch.cli import potrf_driver
from dla_tpu_torch.ops import blas
from dla_tpu_torch.validate.checked import potrf_checked
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = Path(__file__).resolve().parents[1]
CDTYPES = [(torch.complex64, jnp.complex64), (torch.complex128, jnp.complex128)]
RESIDUAL = r"^\|\|A - LL\^T\|\|_inf / \|\|A\|\|_inf = (\S+)$"
SOLVE = r"^\|\|B - A X\|\|_inf / \(\|\|A\|\|_inf \|\|X\|\|_inf\) = (\S+)$"


def _tol(dtype) -> float:
    return 1e-12 if dtype in (torch.complex128, torch.float64) else 1e-5


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.complex128), np.asarray(ref, np.complex128)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _same_bits(got: torch.Tensor, ref) -> bool:
    ref = np.asarray(ref)
    return got.numpy().dtype == ref.dtype and got.numpy().tobytes() == ref.tobytes()


def _hpd(n, seed, jd):
    """plghe(n, seed) of the JAX package: Hermitian, diagonal bump n."""
    return np.asarray(JO.plghe(n, seed=seed, dtype=jd))


# ---- generators and small ops -----------------------------------------------------------

class TestPlghe:
    @pytest.mark.parametrize("td,jd", CDTYPES)
    @pytest.mark.parametrize("seed", [51, 7, -3, 2**31 - 1])
    def test_bits(self, td, jd, seed):
        assert _same_bits(T.plghe(96, seed=seed, dtype=td, device="cpu"),
                          JO.plghe(96, seed=seed, dtype=jd))

    @pytest.mark.parametrize("td,jd", CDTYPES)
    @pytest.mark.parametrize("i0,j0,mb,nb", [(0, 0, 16, 16), (40, 8, 24, 48), (5, 77, 33, 7)])
    def test_tile_bits(self, td, jd, i0, j0, mb, nb):
        got = T.plghe_tile(9, i0, j0, mb, nb, bump=64.0, dtype=td, device="cpu")
        assert _same_bits(got, JO.plghe_tile(9, i0, j0, mb, nb, bump=64.0, dtype=jd))

    def test_hermitian_pd_and_tile_local(self):
        a = T.plghe(96, seed=7, dtype=torch.complex128, device="cpu")
        assert torch.equal(a, a.conj().mT) and torch.all(a.diagonal().imag == 0)
        assert torch.all(torch.linalg.eigvalsh(a) > 0)
        full = T.plghe(64, seed=9, bump=64.0, device="cpu")
        assert torch.equal(T.plghe_tile(9, 16, 32, 16, 16, bump=64.0, device="cpu"),
                           full[16:32, 32:48])

    def test_complex64_bits_without_x64(self, tmp_path):
        """JAX's driver runs ``c`` without x64, where ``seed ^ uint32`` promotes
        otherwise: the imaginary part's seed comes out the same, and so do
        the bits."""
        out = tmp_path / "c.npy"
        code = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
                "import jax.numpy as jnp, numpy as np; from dla_tpu.ops import plghe; "
                f"np.save({str(out)!r}, np.asarray(plghe(80, seed=-3, dtype=jnp.complex64)))")
        subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
                            "JAX_PLATFORMS": "cpu"})
        ref = np.load(out)
        assert ref.dtype == np.complex64
        assert _same_bits(T.plghe(80, seed=-3, device="cpu"), ref)


class TestGershgorin:
    @pytest.mark.parametrize("td,jd", [(torch.float32, jnp.float32), (torch.float64, jnp.float64)]
                             + CDTYPES)
    @pytest.mark.parametrize("n,seed", [(200, 12345), (64, 5)])
    def test_matches_jax(self, td, jd, n, seed):
        """The complex dtypes carry the real matrix (the JAX driver's
        ``--gen gershgorin --dtype c|z``)."""
        got = T.spd_gershgorin(n, seed=seed, dtype=td, device="cpu").numpy()
        ref = np.asarray(JO.spd_gershgorin(n, seed=seed, dtype=jd))
        off = ~np.eye(n, dtype=bool)
        assert got.dtype == ref.dtype and got[off].tobytes() == ref[off].tobytes()
        d, r = np.diagonal(got), np.diagonal(ref)
        assert np.all(np.abs(d - r) <= 2 * np.spacing(np.abs(r)))
        # strictly diagonally dominant, so SPD
        assert np.all(d.real > np.abs(got).sum(axis=1) - np.abs(d))


class TestLacpyGeadd:
    @pytest.mark.parametrize("uplo", ["A", "G", "L", "lower", "U", "upper"])
    def test_lacpy(self, uplo):
        a = np.random.default_rng(1).standard_normal((9, 7))
        assert _same_bits(T.lacpy(uplo, torch.tensor(a)), JO.lacpy(uplo, jnp.asarray(a)))

    def test_lacpy_bad_uplo(self):
        with pytest.raises(ValueError, match="uplo"):
            T.lacpy("X", torch.eye(3))

    @pytest.mark.parametrize("trans", [False, True])
    @pytest.mark.parametrize("dt", [np.float64, np.complex128])
    def test_geadd(self, trans, dt):
        rng = np.random.default_rng(2)
        a = rng.standard_normal((6, 6)).astype(dt)
        b = rng.standard_normal((6, 6)).astype(dt)
        assert _same_bits(T.geadd(-1.0, torch.tensor(a), 1.0, torch.tensor(b), trans=trans),
                          JO.geadd(-1.0, jnp.asarray(a), 1.0, jnp.asarray(b), trans=trans))


class TestGemm3m:
    @pytest.mark.parametrize("td", [torch.complex64, torch.complex128])
    @pytest.mark.parametrize("conjb", [False, True])
    def test_against_the_4m_product_and_jax(self, td, conjb, monkeypatch):
        g = torch.Generator().manual_seed(0)
        a, b, c = (torch.randn(s, dtype=td, generator=g) for s in ((96, 64), (80, 64), (96, 80)))
        monkeypatch.setenv("DLA_TPU_C3M", "0")
        four = blas.gemm(-1.0, a, b, 1.0, c, transb=True, conjb=conjb)
        monkeypatch.setenv("DLA_TPU_C3M", "1")
        three = blas.gemm(-1.0, a, b, 1.0, c, transb=True, conjb=conjb)
        tol = 1e-14 if td == torch.complex128 else 1e-5
        assert _rel(three, four) <= tol
        ref = jax_blas.gemm(-1.0, jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), 1.0,
                            jnp.asarray(c.numpy()), transb=True, conjb=conjb)
        assert _rel(three, ref) <= tol
        # only the trailing-update form takes it
        assert torch.equal(blas.gemm(1.0, a, b.mT, 0.0, c), a @ b.mT)

    def test_default_tier_keeps_complex_ieee(self):
        """Complex products are IEEE at every tier (JAX's on the CPU)."""
        g = torch.Generator().manual_seed(1)
        a, b = (torch.randn(64, 64, dtype=torch.complex64, generator=g) for _ in range(2))
        c = torch.zeros(64, 64, dtype=torch.complex64)
        with T.utils.precision.override("default"):
            assert torch.equal(blas.gemm(1.0, a, b, 0.0, c), a @ b)


# ---- factorizations and solves ----------------------------------------------------------

MODES = [("blocked", {}), ("masked", {}), ("shrink", {}), ("shrink", {"panel": "invgemm"}),
         ("shrink", {"panel": "blocktrsm"}), ("blocked", {"diag_factor": "twolevel"}),
         ("shrink", {"diag_factor": "unblocked"})]


class TestComplexPotrf:
    @pytest.mark.parametrize("td,jd", CDTYPES)
    @pytest.mark.parametrize("uplo", ["L", "U", "B"])
    @pytest.mark.parametrize("mode,kw", MODES)
    def test_matches_jax(self, td, jd, uplo, mode, kw):
        a = _hpd(128, 11, jd)
        if uplo == "U":  # the matrix through its upper triangle
            a = np.triu(a.conj().T)
        got = T.potrf(torch.tensor(a), nb=32, mode=mode, uplo=uplo, **kw)
        # JAX's unblocked diagonal factor is not Hermitian (below): its lax one is the yardstick
        jkw = {} if kw.get("diag_factor") == "unblocked" else kw
        ref = np.asarray(JA.potrf(jnp.asarray(a), nb=32, mode=mode, uplo=uplo, **jkw))
        assert got.dtype == td and _rel(got, ref) <= _tol(td)

    def test_reference_unblocked_omits_the_conjugate(self):
        """The JAX package's ``potrf_unblocked`` subtracts l·lᵀ, not l·lᴴ, so a
        complex diagonal block factors wrongly there (a defect of the
        reference, not ported); the port's is Hermitian."""
        a = _hpd(64, 13, jnp.complex128)
        herm = np.tril(a) + np.tril(a, -1).conj().T
        want = np.linalg.cholesky(herm)
        assert _rel(T.potrf_unblocked(torch.tensor(a)), want) <= 1e-13
        assert _rel(JO.potrf_unblocked(jnp.asarray(a)), want) > 1e-5

    @pytest.mark.parametrize("td,jd", CDTYPES)
    def test_c3m_factor(self, td, jd, monkeypatch):
        monkeypatch.setenv("DLA_TPU_C3M", "1")
        a = _hpd(128, 12, jd)
        got = T.potrf(torch.tensor(a), nb=32, mode="shrink")
        ref = np.asarray(JA.potrf(jnp.asarray(a), nb=32, mode="shrink"))
        assert _rel(got, ref) <= _tol(td)

    @pytest.mark.parametrize("mode,kw", [("blocked", {"trailing": "pallas"}),
                                         ("blocked", {"panel": "pallas"}),
                                         ("shrink", {"trailing": "pallas"}),
                                         ("inplace", {})])
    def test_kernel_routes_are_real_only(self, mode, kw):
        """The hand kernels are real-only and raise for complex input; the JAX
        package raises too where Pallas refuses complex, and elsewhere its
        interpret-mode kernel forms P·Pᵀ for P·Pᴴ and the factor fails its gate."""
        a = torch.tensor(_hpd(64, 1, jnp.complex128))
        with pytest.raises(TypeError, match="real"):
            T.potrf(a, nb=32, mode=mode, **kw)


class TestComplexSolves:
    @pytest.mark.parametrize("td,jd", CDTYPES)
    @pytest.mark.parametrize("name", ["potrs", "posv", "potri_solve_inverse"])
    def test_matches_jax(self, td, jd, name):
        n = 96
        a = _hpd(n, 14, jd)
        rng = np.random.default_rng(3)
        b = (rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))).astype(a.dtype)
        l = np.linalg.cholesky(a.astype(np.complex128)).astype(a.dtype)
        if name == "potrs":
            got = T.potrs(torch.tensor(l), torch.tensor(b))
            ref = JA.potrs(jnp.asarray(l), jnp.asarray(b))
        elif name == "posv":
            _, got = T.posv(torch.tensor(a), torch.tensor(b), nb=32)
            _, ref = JA.posv(jnp.asarray(a), jnp.asarray(b), nb=32)
        else:
            got = T.solve_inverse(T.potri(torch.tensor(l)), torch.tensor(b))
            ref = JA.solve_inverse(JA.potri(jnp.asarray(l)), jnp.asarray(b))
        assert got.dtype == td and _rel(got, np.asarray(ref)) <= _tol(td)


class TestComplexPacked:
    @pytest.mark.parametrize("td,jd", CDTYPES)
    @pytest.mark.parametrize("diag", ["twolevel", "lax"])
    def test_factor_matches_jax(self, td, jd, diag):
        n, tb = 128, 32
        ap = np.asarray(JP.pack_tri(jnp.asarray(_hpd(n, 21, jd)), tb))
        got = TP.potrf_packed(torch.tensor(ap), n, tb, diag_factor=diag)
        ref = np.asarray(JP.potrf_packed(jnp.asarray(ap), n, tb, diag_factor=diag))
        assert got.dtype == td and _rel(TP.unpack_tri(got, n, tb),
                                        JP.unpack_tri(jnp.asarray(ref), n, tb)) <= _tol(td)

    @pytest.mark.parametrize("td,jd", CDTYPES)
    @pytest.mark.parametrize("name", ["potrs_packed", "trmm_packed", "trmm_packed_t"])
    def test_serving_matches_jax(self, td, jd, name):
        n, tb = 128, 32
        lp = np.asarray(JP.pack_tri(jnp.asarray(np.linalg.cholesky(_hpd(n, 22, jd))), tb))
        rng = np.random.default_rng(5)
        b = (rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))).astype(lp.dtype)
        fn, kw = (name[:-2], {"trans": True}) if name.endswith("_t") else (name, {})
        got = getattr(TP, fn)(torch.tensor(lp), torch.tensor(b), n, tb, **kw)
        ref = getattr(JP, fn)(jnp.asarray(lp), jnp.asarray(b), n, tb, **kw)
        assert got.dtype == td and _rel(got, np.asarray(ref)) <= _tol(td)


class TestChecked:
    @pytest.mark.parametrize("bump", [0.0001, -1.0, None])
    def test_message_is_checkify_s(self, bump):
        a = np.asarray(JO.plgsy(64, bump=bump, dtype=jnp.float32))
        err, l = potrf_checked(torch.tensor(a), nb=16)
        jerr, jl = jax_checked(jnp.asarray(a), nb=16)
        assert err.get() == jerr.get()
        if bump is None:
            assert err.get() is None and _rel(l, np.asarray(jl)) <= 1e-5
            err.throw()  # nothing to raise
        else:
            assert err.get().startswith("POTRF produced NaNs")
            with pytest.raises(RuntimeError, match="NaNs"):
                err.throw()

    def test_checks_in_order_from_one_flag_vector(self, monkeypatch):
        """NaN, then Inf, then a non-positive diagonal: each message alone."""
        import dla_tpu_torch.validate.checked as C

        for l, first in ((torch.tensor([[float("inf"), 0.0], [1.0, float("nan")]]), 0),
                         (torch.tensor([[float("inf"), 0.0], [1.0, 2.0]]), 1),
                         (torch.tensor([[-1.0, 0.0], [1.0, 2.0]]), 2)):
            monkeypatch.setattr(C, "potrf_blocked", lambda a, nb, _l=l: _l)
            err, _ = C.potrf_checked(torch.eye(2), nb=2)
            assert err._flags.shape == (3,)
            assert err.get() == f"{C.MESSAGES[first]} (`check` failed)"


class TestFreivaldsPackedComplex:
    def test_sees_the_hermitian_factor(self):
        """The packed gate's conjugate transpose: a complex factor of the
        seed's matrix reads at complex128's floor."""
        n, tb = 128, 32
        a = T.plgsy(n, dtype=torch.complex128, device="cpu")
        lp = TP.pack_tri(torch.linalg.cholesky(a), tb)
        assert float(TP.freivalds_packed(lp, n, tb)) < 1e-14


# ---- the driver ------------------------------------------------------------------------------

def _port(capsys, *argv):
    rc = potrf_driver.main([str(a) for a in argv] + ["--device", "cpu"])
    cap = capsys.readouterr()
    return rc, cap.out


def _jax(capsys, monkeypatch, *argv):
    """The JAX driver in this process (no compile cache: it would write into
    the repository), its exit code: a ``sys.exit`` is caught."""
    monkeypatch.setenv("DLA_TPU_CACHE_DIR", "")
    try:
        rc = jax_driver.main([str(a) for a in argv])
    except SystemExit as e:
        rc = e.code
    return rc, capsys.readouterr().out


def _number(pattern, out):
    m = re.search(pattern, out, re.M)
    assert m, out
    return float(m.group(1))


class TestDriverAgainstJax:
    @pytest.mark.parametrize("argv", [
        ["--dtype", "z", "--uplo", "U", "--mode", "blocked"],
        ["--dtype", "z", "--uplo", "B", "--mode", "shrink", "--panel", "blocktrsm"],
        ["--dtype", "c", "--uplo", "U", "--mode", "shrink"],
        ["--dtype", "z", "--mode", "packed"],
        ["--dtype", "c", "--mode", "packed", "--diag", "lax"],
        ["--dtype", "d", "--gen", "gershgorin", "--mode", "blocked"],
        ["--dtype", "s", "--gen", "gershgorin", "--mode", "inplace", "--solve", "refined"],
        ["--dtype", "d", "--uplo", "U", "--mode", "inplace"],
        ["--dtype", "d", "--lm", 512, "--ioff", 128, "--joff", 128, "--m", 128,
         "--mode", "inplace"],
        ["--dtype", "z", "--lm", 384, "--ioff", 256, "--joff", 256, "--mode", "blocked"],
        ["--dtype", "s", "--checked", "--mode", "blocked"],
    ])
    def test_same_exit_code_and_lines(self, capsys, monkeypatch, argv):
        argv = ["--n", 128, "--nb", 32, *argv]
        rc, out = _port(capsys, *argv)
        jrc, jout = _jax(capsys, monkeypatch, *argv)
        assert rc == jrc == 0, out + jout
        tol = 1e-12 if any(d in argv for d in ("d", "z")) else 1e-5
        for pat in (RESIDUAL, SOLVE):
            if re.search(pat, jout, re.M):
                assert abs(_number(pat, out) - _number(pat, jout)) <= tol
        assert out.count("PASS") == jout.count("PASS")
        if "--lm" in argv:
            assert re.search(r"TileLayout 128x128 view of \d+x\d+ @\(\d+,\d+\)", out)

    @pytest.mark.parametrize("argv", [
        ["--dtype", "c", "--mode", "masked", "--solve", "potrs", "--nrhs", 2],
        ["--dtype", "z", "--mode", "blocked", "--solve", "inverse", "--nrhs", 2],
        ["--dtype", "z", "--mode", "packed", "--solve", "inverse", "--nrhs", 2],
        ["--dtype", "c", "--mode", "packed", "--solve", "potrs"],
    ])
    def test_complex_solves(self, capsys, monkeypatch, argv):
        """The same factor line as JAX's; the solve passes its gate here. The
        JAX package's ``residual_posv`` casts complex to float64, dropping the
        imaginary parts (a defect of the reference, not ported), so its
        driver reads ≈ 1e-3 for these solves and fails; the port's residual
        is the complex backward error numpy gives for the same X."""
        argv = ["--n", 128, "--nb", 32, *argv]
        rc, out = _port(capsys, *argv)
        jrc, jout = _jax(capsys, monkeypatch, *argv)
        tol = 1e-12 if "z" in argv else 1e-5
        assert rc == 0 and "SOLVE PASS" in out
        assert jrc == 1 and "SOLVE FAIL" in jout and _number(SOLVE, jout) > 1e-4
        assert abs(_number(RESIDUAL, out) - _number(RESIDUAL, jout)) <= tol
        assert _number(SOLVE, out) < (1e-10 if "z" in argv else 128 * 2e-6)

    @pytest.mark.parametrize("argv", [
        ["--dtype", "d", "--mode", "inplace", "--solve", "potrs"],
        ["--dtype", "d", "--mode", "blocked", "--solve", "inverse"],
        ["--dtype", "s", "--mode", "inplace", "--solve", "refined"],
        ["--dtype", "s", "--mode", "shrink", "--solve", "refined"],
        ["--dtype", "z", "--mode", "blocked", "--solve", "potrs"],
    ])
    def test_uplo_u_solves_the_true_matrix(self, capsys, monkeypatch, argv):
        """With uplo U the solves read A through its upper triangle and take
        L = Uᴴ: the X the driver computes solves the whole generated matrix,
        checked here with numpy. The JAX driver hands U and the upper-stored A
        to its lower-triangle solvers (a defect of the reference, not ported):
        at fp64 its potrs reads ≈ 7e-4 and fails."""
        import dla_tpu_torch.algos as A

        xs = []
        for name in ("potrs", "solve_inverse", "posv_refined_host"):
            orig = getattr(A, name)
            monkeypatch.setattr(A, name, lambda *a, _f=orig, **kw: xs.append(_f(*a, **kw))
                                or xs[-1])
        n, nrhs = 128, 3
        argv = ["--n", n, "--nb", 32, "--uplo", "U", "--nrhs", nrhs, *argv]
        rc, out = _port(capsys, *argv)
        assert rc == 0 and "SOLVE PASS" in out, out
        x = xs[-1][0] if isinstance(xs[-1], tuple) else xs[-1]
        gen = T.plghe if "z" in argv else T.plgsy
        dtype = {"d": torch.float64, "s": torch.float32, "z": torch.complex128}[argv[argv.index(
            "--dtype") + 1]]
        a = gen(n, dtype=dtype, device="cpu").to(torch.complex128 if "z" in argv
                                                  else torch.float64)
        a, x = a.numpy(), x.to(a.dtype).numpy()
        res = (np.abs(1 - a @ x).sum(1).max()
               / (np.abs(a).sum(1).max() * np.abs(x).sum(1).max()))
        gate = 1e-10 if "refined" in argv or "s" not in argv else n * 2e-6
        assert res < gate
        assert abs(res - _number(SOLVE, out)) <= 1e-12 + 1e-3 * res
        if argv[-2:] == ["--solve", "potrs"] and "d" in argv:
            jrc, jout = _jax(capsys, monkeypatch, *argv)
            assert jrc == 1 and _number(SOLVE, jout) > 1e-4

    @pytest.mark.parametrize("dtype,mode", [("c", "shrink"), ("z", "blocked"), ("c", "packed")])
    def test_complex_refined_exits_2(self, capsys, dtype, mode):
        """The refined solves are real (fp32 factor, fp64 residuals); the JAX
        driver casts complex A to float64 there and solves its real part."""
        rc, out = _port(capsys, "--n", 64, "--nb", 32, "--dtype", dtype, "--mode", mode,
                        "--solve", "refined")
        assert rc == 2 and "Repeat" not in out

    def test_view_is_the_matrix_s_principal_block(self, capsys, monkeypatch):
        """Only the view's tiles are generated: the factor is that of plgsy's
        block (the JAX driver's generator is checked in tests/test_complex_uplo.py)."""
        import dla_tpu_torch.algos as A

        seen = []
        orig = A.potrf
        monkeypatch.setattr(A, "potrf", lambda a, **kw: seen.append(a.clone()) or orig(a, **kw))
        rc, _ = _port(capsys, "--n", 64, "--nb", 32, "--dtype", "d", "--lm", 256, "--ioff", 64,
                      "--joff", 64, "--m", 64, "--mode", "blocked", "--no-check")
        assert rc == 0
        full = T.plgsy(256, bump=64.0, dtype=torch.float64, device="cpu")
        assert torch.equal(seen[0], full[64:128, 64:128])

    @pytest.mark.parametrize("ioff,joff,m", [(128, 64, 128), (448, 448, 128), (100, 100, 128)])
    def test_view_refusals(self, capsys, monkeypatch, ioff, joff, m):
        """Off the diagonal: "principal", exit 2. Past the matrix or not
        tile-aligned: the descriptor raises, in both packages."""
        argv = ["--n", 128, "--nb", 32, "--dtype", "d", "--lm", 512, "--ioff", ioff, "--joff",
                joff, "--m", m, "--mode", "blocked"]
        if ioff == joff:
            with pytest.raises(ValueError, match="exceeds|tile-aligned"):
                _port(capsys, *argv)
            with pytest.raises(ValueError, match="exceeds|tile-aligned"):
                _jax(capsys, monkeypatch, *argv)
            return
        rc, out = _port(capsys, *argv)
        jrc, jout = _jax(capsys, monkeypatch, *argv)
        assert rc == jrc == 2 and "principal" in out and "principal" in jout

    def test_checked_exit_3(self, capsys, monkeypatch):
        argv = ["--n", 64, "--nb", 16, "--dtype", "s", "--checked", "--bump", "0.0001",
                "--mode", "blocked"]
        rc, out = _port(capsys, *argv)
        jrc, jout = _jax(capsys, monkeypatch, *argv)
        assert rc == jrc == 3
        line = next(ln for ln in out.splitlines() if "CHECK FAILED" in ln)
        assert line in jout.splitlines() and "Repeat" not in out

    @pytest.mark.parametrize("argv,msg", [
        (["--mode", "packed", "--uplo", "U"], "uplo L only"),
        (["--mode", "df64", "--uplo", "B"], "uplo L only"),
        (["--mode", "df64", "--gen", "gershgorin"], "plgsy generator or --input"),
        (["--mode", "packed", "--gen", "gershgorin", "--solve", "refined"], "needs the plgsy"),
    ])
    def test_refusals_exit_2(self, capsys, monkeypatch, argv, msg):
        argv = ["--n", 128, "--nb", 32, "--dtype", "d", *argv]
        rc, out = _port(capsys, *argv)
        jrc, jout = _jax(capsys, monkeypatch, *argv)
        assert rc == jrc == 2 and msg in out and msg in jout

    def test_packed_pallas_complex_raises_as_jax(self, capsys, monkeypatch):
        argv = ["--n", 128, "--nb", 32, "--dtype", "c", "--mode", "packed", "--trailing",
                "pallas"]
        with pytest.raises(ValueError, match="real dtypes only"):
            _port(capsys, *argv)
        with pytest.raises(ValueError, match="real dtypes only"):
            _jax(capsys, monkeypatch, *argv)


@pytest.fixture
def user_files(tmp_path):
    rng = np.random.default_rng(3)
    n = 192
    g = rng.standard_normal((n, n))
    a = (g + g.T) / 2 + n * np.eye(n)
    np.save(tmp_path / "a.npy", a)
    np.savez(tmp_path / "a.npz", a=a)
    a.tofile(tmp_path / "a.bin")
    np.save(tmp_path / "rect.npy", np.ones((64, 72)))
    bad = np.eye(64)
    bad[3, 3] = np.nan
    np.save(tmp_path / "nan.npy", bad)
    np.save(tmp_path / "cplx.npy", np.eye(64, dtype=np.complex128) * 4)
    np.eye(64)[:32].tofile(tmp_path / "short.bin")
    return tmp_path


class TestDriverInput:
    @pytest.mark.parametrize("mode", ["inplace", "blocked", "masked", "shrink", "packed"])
    @pytest.mark.parametrize("name,extra", [("a.npy", []), ("a.npz", ["--n", 192]),
                                            ("a.bin", ["--n", 192])])
    def test_dense_modes_against_jax(self, capsys, monkeypatch, user_files, mode, name, extra):
        argv = ["--nb", 64, "--dtype", "d", "--mode", mode, "--input", user_files / name,
                *extra]
        rc, out = _port(capsys, *argv)
        jrc, jout = _jax(capsys, monkeypatch, *argv)
        assert rc == jrc == 0, out + jout
        assert "N=192 NB=64" in out or "N=192 adopted" in out
        assert ("adopted" in out) == ("adopted" in jout)
        assert abs(_number(RESIDUAL, out) - _number(RESIDUAL, jout)) <= 1e-14

    @pytest.mark.parametrize("solve", ["potrs", "inverse", "refined"])
    def test_solves_take_the_user_s_matrix(self, capsys, monkeypatch, user_files, solve):
        argv = ["--nb", 64, "--dtype", "s", "--mode", "shrink", "--input",
                user_files / "a.npy", "--solve", solve, "--nrhs", 2]
        rc, out = _port(capsys, *argv)
        jrc, jout = _jax(capsys, monkeypatch, *argv)
        assert rc == jrc == 0 and "SOLVE PASS" in out
        if solve == "refined":  # the file's tril(A), not the generator's matrix
            assert "tril(A) widened to fp64" in out and _number(SOLVE, out) < 1e-12
        else:
            assert abs(_number(SOLVE, out) - _number(SOLVE, jout)) <= 1e-6

    @pytest.mark.parametrize("name,extra,msg", [
        ("rect.npy", ["--n", 64], "expected square"),
        ("short.bin", ["--n", 64], "elements, expected"),
        ("a.npy", ["--n", 64], "elements, expected"),
        ("nan.npy", [], "non-finite"),
        ("cplx.npy", [], "complex→real"),
    ])
    def test_rejections_exit_2(self, capsys, monkeypatch, user_files, name, extra, msg):
        argv = ["--nb", 16, "--dtype", "d", "--mode", "blocked", "--input", user_files / name,
                *extra]
        rc, out = _port(capsys, *argv)
        jrc, jout = _jax(capsys, monkeypatch, *argv)
        assert rc == jrc == 2 and msg in out and msg in jout

    def test_complex_file_into_z(self, capsys, user_files):
        rc, out = _port(capsys, "--nb", 16, "--dtype", "z", "--mode", "blocked", "--input",
                        user_files / "cplx.npy")
        assert rc == 0 and "PASS (residual < 1e-10)" in out


class TestDriverConfig:
    def test_profile_under_the_flags(self, capsys, monkeypatch, tmp_path):
        prof = tmp_path / "p.json"
        prof.write_text('{"N": 96, "NB": 32, "dtype": "z", "mode": "blocked", "uplo": "U"}')
        rc, out = _port(capsys, "--config", prof)
        assert rc == 0 and "N=96 NB=32 dtype=complex128 mode=blocked uplo=U" in out
        monkeypatch.setenv("DLA_TPU_CONFIG", str(prof))
        monkeypatch.setenv("CHOLESKY_N", "64")  # the environment over the profile
        rc, out = _port(capsys, "--nb", 16, "--dtype", "c")  # the flags over both
        assert rc == 0 and "N=64 NB=16 dtype=complex64 mode=blocked uplo=U" in out

    def test_mode_defaults_to_inplace_without_a_profile_mode(self, capsys, tmp_path):
        prof = tmp_path / "p.json"
        prof.write_text('{"n": 64, "nb": 32, "gen": "gershgorin"}')
        rc, out = _port(capsys, "--config", prof, "--dtype", "d")
        assert rc == 0 and "mode=inplace" in out and "gen=gershgorin" in out
