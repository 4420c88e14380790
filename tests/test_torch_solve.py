"""dla_tpu_torch's dense solve and serving path held against the JAX package.

The same numpy inputs (seeded SPD matrices, ``plgsy`` of both packages, which
give the same bits) go through ``dla_tpu`` (JAX on the CPU, x64) and
``dla_tpu_torch`` (torch on the CPU): ``lauum``, ``trtri_lower``,
``residual_posv``, ``potrs`` (both routes), ``potrs_batched``, ``posv``,
``posv_refined``, ``posv_refined_host``, ``potri`` (both routes),
``solve_inverse``, ``potrf_batched``, and the driver's ``--solve`` lines.

Tolerances, relative to the largest entry of the JAX result:
- fp64: 1e-10 (two implementations of one algorithm on matrices with
  condition number ≈ 3, summed in another order);
- fp32: 1e-4 for solutions and inverses (fp32's 6e-8 times the solves'
  error growth), 1e-5 for the single products of ``lauum`` and
  ``solve_inverse``;
- the refined solves: both reach a backward error below 1e-10, in the same
  number of iterations, and their solutions agree within 1e-10.

The solves read only tril(L) (ROADMAP C #3): NaN above the diagonal leaves
``potrs``, ``potri`` and ``posv`` unchanged, bit for bit. ``residual_posv``
rises with a known relative perturbation of X in both packages (C #9).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dla_tpu_torch as T
import dla_tpu_torch.algos as TA
from dla_tpu.algos.potri import potrf_batched as jax_potrf_batched
from dla_tpu.algos.potri import potri as jax_potri
from dla_tpu.algos.potri import solve_inverse as jax_solve_inverse
from dla_tpu.algos import solve as jax_solve
from dla_tpu.ops import lapack_like as jax_lapack
from dla_tpu.validate import residual_posv as jax_residual_posv
from dla_tpu_torch.cli import potrf_driver
from dla_tpu_torch.ops import trtri_lower
from dla_tpu_torch.utils.interop import from_numpy
from dla_tpu_torch.validate import residual_posv
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _t(x):
    return from_numpy(np.ascontiguousarray(x), device="cpu")


def _spd(n, seed, dtype=np.float64):
    """plgsy(n, seed) of the JAX package: symmetric, diagonal bump n."""
    return np.array(jax_lapack.plgsy(n, seed=seed, dtype=jnp.float64)).astype(dtype)


def _factor(n, seed, dtype=np.float64):
    return np.linalg.cholesky(_spd(n, seed)).astype(dtype)


def _rhs(n, nrhs, seed, dtype=np.float64):
    b = np.random.default_rng(seed).standard_normal((n, nrhs) if nrhs else (n,))
    return b.astype(dtype)


def _rel(got, ref):
    return np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)).max() / max(
        np.abs(np.asarray(ref, np.float64)).max(), 1e-300)


TOL = {np.float64: 1e-10, np.float32: 1e-4}
DTYPES = [np.float64, np.float32]


class TestOps:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("uplo", ["L", "U", "lower", "upper"])
    @pytest.mark.parametrize("n", [96, 257])
    def test_lauum(self, n, uplo, dtype):
        a = np.random.default_rng(n).standard_normal((n, n)).astype(dtype)
        ref = np.asarray(jax_lapack.lauum(uplo, jnp.asarray(a)))
        got = T.lauum(uplo, _t(a)).numpy()
        assert got.dtype == dtype
        assert _rel(got, ref) <= (1e-12 if dtype == np.float64 else 1e-5)

    def test_lauum_rejects_unknown_uplo(self):
        with pytest.raises(ValueError, match="uplo"):
            T.lauum("X", torch.eye(4))

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("n", [1, 64, 200])
    def test_trtri_lower(self, n, dtype):
        l = _factor(n, seed=n, dtype=dtype)
        ref = np.asarray(jax_lapack.trtri_lower(jnp.asarray(l)))
        garbage = l + np.triu(np.full((n, n), np.nan, dtype), 1)  # the upper is never read
        got = trtri_lower(_t(garbage)).numpy()
        assert np.array_equal(got, np.tril(got))
        assert _rel(got, ref) <= TOL[dtype]
        assert np.abs(got @ l - np.eye(n)).max() <= (1e-12 if dtype == np.float64 else 1e-5)
        assert np.array_equal(got, trtri_lower(_t(l)).numpy())


class TestResidualPosv:
    @pytest.mark.parametrize("nrhs", [0, 3])
    @pytest.mark.parametrize("assume_symmetric", [False, True])
    def test_matches_jax(self, nrhs, assume_symmetric):
        n = 128
        a = _spd(n, seed=3)
        if not assume_symmetric:  # garbage above the diagonal is never read
            a = a + np.triu(np.full((n, n), 7.0), 1)
        x = _rhs(n, nrhs, seed=4)
        b = _rhs(n, nrhs, seed=5)
        ref = float(jax_residual_posv(jnp.asarray(a), jnp.asarray(b), jnp.asarray(x),
                                      assume_symmetric=assume_symmetric))
        got = residual_posv(_t(a), _t(b), _t(x), assume_symmetric=assume_symmetric)
        assert got.dtype == torch.float64
        assert abs(float(got) - ref) <= 1e-12 * ref

    @pytest.mark.parametrize("eps", [1e-12, 1e-9, 1e-6])
    def test_rises_with_a_known_perturbation_of_x(self, eps):
        # X solved in fp64, then every entry scaled by (1 + eps·u), u uniform in [-1, 1):
        # the residual sits near eps·||A||·||X|| / (||A||·||X||), in both packages
        n = 256
        a = _spd(n, seed=6)
        b = _rhs(n, 2, seed=7)
        x = np.linalg.solve(a, b)
        u = np.random.default_rng(8).uniform(-1, 1, x.shape)
        xp = x * (1 + eps * u)
        base = float(residual_posv(_t(a), _t(b), _t(x)))
        got = float(residual_posv(_t(a), _t(b), _t(xp)))
        ref = float(jax_residual_posv(jnp.asarray(a), jnp.asarray(b), jnp.asarray(xp)))
        assert base < 1e-14
        assert eps / 100 < got < eps
        # the two packages sum r in another order: they agree to fp64's roundoff of the
        # residual, n·eps64 ≈ 3e-14 of ||A||·||X||
        assert abs(got - ref) <= 1e-6 * ref + 1e-14


class TestPotrs:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("nrhs", [0, 1, 5])
    @pytest.mark.parametrize("n,blocked,ib", [(96, None, 512), (320, True, 128),
                                              (200, True, 64), (128, False, 512)])
    def test_matches_jax(self, n, blocked, ib, nrhs, dtype):
        l = _factor(n, seed=n, dtype=dtype)
        b = _rhs(n, nrhs, seed=n + 1, dtype=dtype)
        ref = np.asarray(jax_solve.potrs(jnp.asarray(l), jnp.asarray(b), blocked=blocked, ib=ib))
        got = T.potrs(_t(l), _t(b), blocked=blocked, ib=ib).numpy()
        assert got.shape == b.shape and got.dtype == dtype
        assert _rel(got, ref) <= TOL[dtype]
        a = _t(_spd(n, seed=n))
        gate = 1e-10 if dtype == np.float64 else n * 2e-6
        assert float(residual_posv(a, _t(b), torch.from_numpy(got))) < gate

    @pytest.mark.parametrize("blocked", [False, True])
    def test_bf16_factor_solves_in_fp32(self, blocked):
        n = 192
        l = torch.from_numpy(_factor(n, seed=9)).to(torch.bfloat16)
        b = _rhs(n, 3, seed=10, dtype=np.float32)
        lj = jnp.asarray(l.float().numpy()).astype(jnp.bfloat16)
        ref = np.asarray(jax_solve.potrs(lj, jnp.asarray(b), blocked=blocked, ib=64))
        got = T.potrs(l, _t(b), blocked=blocked, ib=64)
        assert got.dtype == torch.float32 and _rel(got.numpy(), ref) <= 1e-4

    def test_batched_matches_jax(self):
        n, nrhs = 64, 3
        l = np.stack([_factor(n, seed=s) for s in range(6)]).reshape(2, 3, n, n)
        b = np.random.default_rng(0).standard_normal((2, 3, n, nrhs))
        ref = np.asarray(jax_solve.potrs_batched(jnp.asarray(l), jnp.asarray(b)))
        got = TA.potrs_batched(_t(l), _t(b)).numpy()
        assert got.shape == (2, 3, n, nrhs) and _rel(got, ref) <= 1e-10
        with pytest.raises(ValueError, match="mismatch"):
            TA.potrs_batched(_t(l), _t(b[:1]))

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("nb", [32, 96])
    def test_posv_matches_jax(self, nb, dtype):
        n = 256
        a = _spd(n, seed=11).astype(dtype)
        b = _rhs(n, 4, seed=12, dtype=dtype)
        lref, xref = jax_solve.posv(jnp.asarray(a), jnp.asarray(b), nb=nb)
        l, x = T.posv(_t(a), _t(b), nb=nb)
        assert _rel(np.tril(l.numpy()), np.tril(np.asarray(lref))) <= TOL[dtype]
        assert _rel(x.numpy(), np.asarray(xref)) <= TOL[dtype]


class TestRefined:
    @pytest.mark.parametrize("nrhs", [0, 4])
    def test_posv_refined_matches_jax(self, nrhs):
        n = 256
        a = _spd(n, seed=13) + np.triu(np.full((n, n), 3.0), 1)  # the upper is ignored
        b = _rhs(n, nrhs, seed=14)
        lref, xref, rref = jax_solve.posv_refined(jnp.asarray(a), jnp.asarray(b), nb=64)
        l, x, r = TA.posv_refined(_t(a), _t(b), nb=64)
        assert l.dtype == torch.float32 and x.dtype == torch.float64
        assert _rel(np.tril(l.numpy()), np.tril(np.asarray(lref))) <= 1e-5
        assert _rel(x.numpy(), np.asarray(xref)) <= 1e-10
        assert float(residual_posv(_t(a), _t(b), x)) < 1e-10
        assert float(r) <= 1e-10 * np.abs(b).max() and float(rref) <= 1e-10 * np.abs(b).max()

    @pytest.mark.parametrize("n,nb,nrhs", [(512, 128, 3), (384, 2048, 0), (256, 64, 1)])
    def test_posv_refined_host_matches_jax(self, n, nb, nrhs):
        a = np.tril(_spd(n, seed=n + 15))  # symmetric data in the lower triangle only
        b = _rhs(n, nrhs, seed=16)
        xref, eref, uref = jax_solve.posv_refined_host(a, b, nb=nb)
        x, err, used = TA.posv_refined_host(a, b, nb=nb, device="cpu")
        assert isinstance(err, float) and err < 1e-10 and eref < 1e-10
        assert used == uref
        assert x.dtype == torch.float64 and x.shape == b.shape
        assert _rel(x.numpy(), xref) <= 1e-10
        assert float(residual_posv(_t(a), _t(b), x)) < 1e-10

    def test_posv_refined_host_takes_tensors_and_potrf_kwargs(self):
        n = 256
        a = torch.from_numpy(np.tril(_spd(n, seed=17)))
        b = torch.ones(n, 2, dtype=torch.float64)
        x, err, used = TA.posv_refined_host(a, b, nb=64, device="cpu",
                                            potrf_kwargs={"panel": "blocktrsm", "ib": 32})
        assert x.device.type == "cpu" and err < 1e-10 and 1 <= used <= 12
        x1, err1, used1 = TA.posv_refined_host(a, b, nb=64, device="cpu", iters=1, tol=0.0)
        assert used1 == 1 and err1 >= err  # no early stop at tol 0; one step refines less

    def test_posv_refined_host_defaults_to_the_card(self):
        a, b = np.eye(8), np.ones(8)
        if torch.cuda.is_available():
            assert TA.posv_refined_host(a, b, nb=8)[0].device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                TA.posv_refined_host(a, b, nb=8)


class TestPotri:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("n,blocked,ib", [(96, None, 1024), (256, True, 64),
                                              (200, True, 96)])
    def test_matches_jax(self, n, blocked, ib, dtype):
        l = _factor(n, seed=n + 20, dtype=dtype)
        ref = np.asarray(jax_potri(jnp.asarray(l), blocked=blocked, ib=ib))
        got = T.potri(_t(l), blocked=blocked, ib=ib).numpy()
        assert got.dtype == dtype and _rel(got, ref) <= TOL[dtype]
        a = _spd(n, seed=n + 20)
        assert np.abs(got @ a - np.eye(n)).max() <= (1e-12 if dtype == np.float64 else 1e-5)

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("nrhs", [0, 6])
    def test_solve_inverse_matches_jax(self, nrhs, dtype):
        n = 160
        ainv = np.linalg.inv(_spd(n, seed=21)).astype(dtype)
        b = _rhs(n, nrhs, seed=22, dtype=dtype)
        ref = np.asarray(jax_solve_inverse(jnp.asarray(ainv), jnp.asarray(b)))
        got = T.solve_inverse(_t(ainv), _t(b)).numpy()
        assert got.shape == b.shape and got.dtype == dtype
        assert _rel(got, ref) <= (1e-12 if dtype == np.float64 else 1e-5)

    def test_potrf_batched_matches_jax(self):
        n = 96
        a = np.stack([_spd(n, seed=s) for s in range(4)]).reshape(2, 2, n, n)
        ref = np.asarray(jax_potrf_batched(jnp.asarray(a), nb=32))
        got = TA.potrf_batched(_t(a), nb=32).numpy()
        assert got.shape == a.shape and _rel(got, ref) <= 1e-12
        assert np.array_equal(got, np.tril(got))


class TestReadsLowerOnly:
    """NaN above the diagonal of L (of A for posv) changes no bit of the
    result: every solve reads tril(L) only."""

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("blocked", [False, True])
    def test_potrs_potri(self, blocked, dtype):
        n = 256
        l = _factor(n, seed=30, dtype=dtype)
        dirty = _t(l + np.triu(np.full((n, n), np.nan, dtype), 1))
        b = _t(_rhs(n, 3, seed=31, dtype=dtype))
        clean = _t(l)
        kw = dict(blocked=blocked, ib=64)
        assert torch.equal(T.potrs(dirty, b, **kw), T.potrs(clean, b, **kw))
        assert torch.equal(T.potri(dirty, **kw), T.potri(clean, **kw))

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_posv(self, dtype):
        n = 192
        a = _spd(n, seed=32, dtype=dtype)
        b = _t(_rhs(n, 2, seed=33, dtype=dtype))
        l0, x0 = T.posv(_t(np.tril(a)), b, nb=64)
        l1, x1 = T.posv(_t(a + np.triu(np.full((n, n), np.nan, dtype), 1)), b, nb=64)
        assert torch.equal(l0, l1) and torch.equal(x0, x1)


SOLVE_LINE = r"^\|\|B - A X\|\|_inf / \(\|\|A\|\|_inf \|\|X\|\|_inf\) = (\S+)$"


def _drive(capsys, *argv):
    rc = potrf_driver.main(list(argv))
    return rc, capsys.readouterr().out


class TestDriverSolve:
    @pytest.mark.parametrize("solve,dtype,extra,gate", [
        ("potrs", "s", [], "0.000512"),
        ("inverse", "s", [], "0.000512"),
        ("potrs", "d", [], "1e-10"),
        ("inverse", "d", [], "1e-10"),
        ("refined", "s", [], "1e-10"),  # posv_refined_host
        ("refined", "s", ["--x64"], "1e-10"),  # posv_refined
        ("refined", "d", [], "1e-10"),  # posv_refined: an fp64 dtype picks it
        ("refined", "s", ["--mode", "shrink", "--panel", "blocktrsm"], "1e-10"),
        ("potrs", "s", ["--mode", "blocked", "--no-check"], "0.000512"),
    ])
    def test_solve_lines(self, capsys, solve, dtype, extra, gate):
        rc, out = _drive(capsys, "--n", "256", "--nb", "64", "--dtype", dtype, "--device", "cpu",
                         "--solve", solve, "--nrhs", "3", *extra)
        assert rc == 0, out
        res = re.search(SOLVE_LINE, out, re.M)
        assert res and float(res.group(1)) < float(gate)
        assert f"SOLVE PASS (residual < {gate})" in out
        assert ("iterations" in out) == (solve == "refined" and dtype == "s"
                                         and "--x64" not in extra)
        assert ("PASS (residual <" in out.replace("SOLVE PASS", "")) == ("--no-check" not in extra)

    def test_solve_fail_returns_nonzero(self, capsys):
        rc, out = _drive(capsys, "--n", "128", "--nb", "32", "--dtype", "s", "--device", "cpu",
                         "--solve", "potrs", "--gate", "1e-30")
        assert rc == 1 and "SOLVE FAIL (residual >= 1e-30)" in out

    @pytest.mark.parametrize("mode", ["packed", "df64", "df64-packed"])
    def test_unported_solve_modes_exit_2(self, capsys, mode):
        # the df64 modes take no --solve; the packed mode solves by potrs, inverse
        # (tests/test_torch_packed_serving.py) and, since the native host generator was
        # ported, refined, which exited 2 here before: it now passes the 1e-10 gate
        solve = "refined" if mode == "packed" else "potrs"
        rc = potrf_driver.main(["--n", "128", "--nb", "32", "--dtype", "s", "--device", "cpu",
                                "--mode", mode, "--solve", solve])
        cap = capsys.readouterr()
        if mode == "packed":
            assert rc == 0 and "SOLVE PASS (residual < 1e-10)" in cap.out, cap.out + cap.err
        else:
            assert rc == 2 and "--solve" in cap.err
