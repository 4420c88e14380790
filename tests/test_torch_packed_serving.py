"""dla_tpu_torch's packed serving path held against the JAX package.

The same numpy inputs (seeded SPD matrices, their Cholesky factors and
right-hand sides) go through ``dla_tpu.algos.packed`` (JAX on the CPU, x64)
and ``dla_tpu_torch.algos.packed`` (torch on the CPU): ``trtri_packed``,
``lauum_packed``, ``potri_packed``, ``solve_inverse_packed`` for a matrix and
a vector right-hand side, and ``residual_posv_streamed``; then the driver's
``--mode packed --solve potrs|inverse`` lines. The packed buffer has one 2-D
layout in both packages, so the arrays cross unchanged.

Tolerances, relative to the largest entry of the JAX result:
- fp64: 1e-10 (two implementations of one algorithm on matrices with
  condition number ≈ 3, summed in another order);
- fp32: 1e-4 for the inverses (fp32's 6e-8 times the chained products' and
  the diagonal blocks' triangular solves' error growth), 1e-5 for
  ``solve_inverse_packed``, whose outputs are single sums of products.

The three inverse steps overwrite their input buffer, as the reference's do
when it donates the buffer: here they return the same tensor. The solve and
the inverse read only the lower triangle of the factor's diagonal blocks:
NaN above it changes no bit.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dla_tpu_torch as T
import dla_tpu_torch.algos as TA
from dla_tpu.algos import packed as J
from dla_tpu.ops import lapack_like as jax_lapack
from dla_tpu_torch.algos import packed as P
from dla_tpu_torch.cli import potrf_driver
from dla_tpu_torch.utils.interop import from_numpy
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TOL = {np.float64: 1e-10, np.float32: 1e-4}
DTYPES = [np.float64, np.float32]
SHAPES = [(256, 64), (384, 128), (512, 128)]  # (n, tb)


def _t(x):
    return from_numpy(np.ascontiguousarray(x), device="cpu")


def _spd(n, seed):
    """plgsy(n, seed) of the JAX package, fp64: symmetric, diagonal bump n."""
    return np.array(jax_lapack.plgsy(n, seed=seed, dtype=jnp.float64))


def _packed_factor(n, tb, seed, dtype):
    """pack_tri of the Cholesky factor of plgsy(n, seed), in dtype."""
    return np.asarray(J.pack_tri(jnp.asarray(np.linalg.cholesky(_spd(n, seed)).astype(dtype)),
                                 tb))


def _rel(got, ref):
    return np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)).max() / max(
        np.abs(np.asarray(ref, np.float64)).max(), 1e-300)


class TestInverse:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("n,tb", SHAPES)
    @pytest.mark.parametrize("name", ["trtri_packed", "lauum_packed", "potri_packed"])
    def test_matches_jax(self, name, n, tb, dtype):
        lp = _packed_factor(n, tb, seed=n + tb, dtype=dtype)
        if name == "lauum_packed":  # its input is the packed inverse factor K
            lp = np.asarray(J.trtri_packed(jnp.asarray(lp), n, tb))
        ref = np.asarray(getattr(J, name)(jnp.asarray(lp), n, tb))
        buf = _t(lp.copy())
        got = getattr(P, name)(buf, n, tb)
        assert got is buf  # in place, as the reference with its buffer donated
        assert got.dtype == buf.dtype and got.shape == lp.shape
        assert _rel(got.numpy(), ref) <= TOL[dtype]

    @pytest.mark.parametrize("n,tb", SHAPES[:2])
    def test_potri_packed_is_the_inverse(self, n, tb):
        # tril of the unpacked result is tril(A⁻¹), in fp64 to 1e-12 of its largest entry
        a = _spd(n, seed=5)
        lp = _t(_packed_factor(n, tb, seed=5, dtype=np.float64))
        sp = T.potri_packed(lp, n, tb)
        want = np.tril(np.linalg.inv(a))
        assert _rel(T.unpack_tri(sp, n, tb).numpy(), want) <= 1e-12

    @pytest.mark.parametrize("name", ["trtri_packed", "lauum_packed", "potri_packed",
                                      "solve_inverse_packed", "residual_posv_streamed"])
    def test_complex_raises(self, name):
        z = torch.zeros((P.packed_rows(64, 32), 32), dtype=torch.complex64)
        args = {"solve_inverse_packed": (z, torch.zeros(64, dtype=torch.complex64), 64, 32),
                "residual_posv_streamed": (torch.zeros(64, dtype=torch.complex64),
                                           torch.zeros(64, dtype=torch.complex64), 64)
                }.get(name, (z, 64, 32))
        with pytest.raises(NotImplementedError, match="A5"):
            getattr(P, name)(*args)


class TestSolveInverse:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("nrhs", [0, 1, 5])
    @pytest.mark.parametrize("n,tb", SHAPES)
    def test_matches_jax(self, n, tb, nrhs, dtype):
        # from the packed symmetric inverse of plgsy(n): a matrix or a vector right-hand side
        sp = np.asarray(J.pack_tri(jnp.asarray(np.linalg.inv(_spd(n, seed=n)).astype(dtype)), tb))
        rng = np.random.default_rng(n + nrhs)
        b = rng.standard_normal((n, nrhs) if nrhs else (n,)).astype(dtype)
        ref = np.asarray(J.solve_inverse_packed(jnp.asarray(sp), jnp.asarray(b), n, tb))
        got = T.solve_inverse_packed(_t(sp), _t(b), n, tb).numpy()
        assert got.shape == b.shape and got.dtype == dtype
        assert _rel(got, ref) <= (1e-12 if dtype == np.float64 else 1e-5)

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_potri_then_solve_inverse_solves(self, dtype):
        # the serving chain against numpy's fp64 solve of the same matrix
        n, tb = 384, 128
        a = _spd(n, seed=9)
        b = np.random.default_rng(9).standard_normal((n, 3))
        lp = _t(_packed_factor(n, tb, seed=9, dtype=dtype))
        x = T.solve_inverse_packed(T.potri_packed(lp, n, tb), _t(b.astype(dtype)), n, tb)
        assert _rel(x.numpy(), np.linalg.solve(a, b)) <= TOL[dtype]


class TestResidualPosvStreamed:
    @pytest.mark.parametrize("nrhs", [0, 3])
    @pytest.mark.parametrize("cb", [64, 1024])
    def test_matches_jax(self, nrhs, cb):
        n = 256
        rng = np.random.default_rng(nrhs + cb)
        x = rng.standard_normal((n, nrhs) if nrhs else (n,))
        b = rng.standard_normal(x.shape)
        ref = float(J.residual_posv_streamed(jnp.asarray(x), jnp.asarray(b), n, seed=11, cb=cb))
        got = TA.residual_posv_streamed(_t(x), _t(b), n, seed=11, cb=cb)
        assert got.dtype == torch.float64
        assert abs(float(got) - ref) <= 1e-12 * ref

    @pytest.mark.parametrize("eps", [1e-12, 1e-9, 1e-6])
    def test_rises_with_a_known_perturbation_of_x(self, eps):
        # X solved in fp64, then every entry scaled by (1 + eps·u), u uniform in [-1, 1):
        # the residual sits near eps·||A||·||X|| / (||A||·||X||), in both packages
        n = 256
        a = _spd(n, seed=51)  # the streamed generator's matrix at its default seed
        b = np.random.default_rng(7).standard_normal((n, 2))
        x = np.linalg.solve(a, b)
        u = np.random.default_rng(8).uniform(-1, 1, x.shape)
        xp = x * (1 + eps * u)
        base = float(P.residual_posv_streamed(_t(x), _t(b), n, cb=64))
        got = float(P.residual_posv_streamed(_t(xp), _t(b), n, cb=64))
        ref = float(J.residual_posv_streamed(jnp.asarray(xp), jnp.asarray(b), n, cb=64))
        assert base < 1e-14
        assert eps / 100 < got < eps
        # the two packages sum in another order: they agree to fp64's roundoff of the
        # residual, n·eps64 ≈ 3e-14 of ||A||·||X||
        assert abs(got - ref) <= 1e-6 * ref + 1e-14


class TestReadsLowerOnly:
    @pytest.mark.parametrize("name", ["potrs_packed", "trtri_packed", "potri_packed"])
    def test_nan_above_the_diagonal_changes_no_bit(self, name):
        # the packed factor's diagonal blocks carry whatever lay above the diagonal
        # (potrf_packed's trailing kernel leaves stale tiles there): NaN in them must change
        # no bit of the solve or the inverse
        n, tb = 384, 128
        lp = _packed_factor(n, tb, seed=21, dtype=np.float64)
        dirty = lp.copy()
        for j in range(n // tb):
            r0 = P._row_offset(j, n // tb, tb)
            blk = dirty[r0 : r0 + tb]
            blk[np.triu_indices(tb, 1)] = np.nan
        b = _t(np.random.default_rng(21).standard_normal((n, 2)))
        if name == "potrs_packed":
            clean, got = (P.potrs_packed(_t(x), b, n, tb) for x in (lp, dirty))
        else:
            clean, got = (getattr(P, name)(_t(x.copy()), n, tb) for x in (lp, dirty))
        assert torch.isfinite(got).all()
        assert torch.equal(got, clean)


SOLVE_LINE = r"^\|\|B - A X\|\|_inf / \(\|\|A\|\|_inf \|\|X\|\|_inf\) = (\S+)$"


class TestDriverPackedSolve:
    @pytest.mark.parametrize("solve,dtype,gate", [
        ("potrs", "s", "0.000512"), ("inverse", "s", "0.000512"),
        ("potrs", "d", "1e-10"), ("inverse", "d", "1e-10"),
    ])
    def test_solve_lines(self, capsys, solve, dtype, gate):
        rc = potrf_driver.main(["--n", "256", "--nb", "64", "--dtype", dtype, "--device", "cpu",
                                "--mode", "packed", "--solve", solve, "--nrhs", "3"])
        out = capsys.readouterr().out
        assert rc == 0, out
        res = re.search(SOLVE_LINE, out, re.M)
        assert res and float(res.group(1)) < float(gate)
        assert f"SOLVE PASS (residual < {gate})" in out
        assert "freivalds" in out  # the factor's own gate still runs first
        assert ("potri_packed" in out) == (solve == "inverse")

    def test_solve_fail_returns_nonzero(self, capsys):
        rc = potrf_driver.main(["--n", "128", "--nb", "32", "--dtype", "s", "--device", "cpu",
                                "--mode", "packed", "--solve", "inverse", "--gate", "1e-30"])
        assert rc == 1 and "SOLVE FAIL (residual >= 1e-30)" in capsys.readouterr().out

    def test_refined_exits_2_naming_a8(self, capsys):
        rc = potrf_driver.main(["--n", "128", "--nb", "32", "--dtype", "s", "--device", "cpu",
                                "--mode", "packed", "--solve", "refined"])
        err = capsys.readouterr().err
        assert rc == 2 and "posv_refined_streamed" in err and "A8" in err


def test_version_is_the_reference_s():
    import dla_tpu

    assert T.__version__ == dla_tpu.__version__
