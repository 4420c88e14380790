"""dla_tpu_torch's four task kernels (``potrf_tile``, ``trsm_tile``,
``syrk_tile``, ``gemm_tile``), ``TileLayout``, ``dag_counts`` and the
tile-task factorization built from them, held against the JAX package.

On the CPU each wrapper runs its plain torch version; the JAX kernels run in
Pallas interpret mode, as in tests/test_kernels.py. The CUDA kernels are held
against the plain versions on the card in tests/test_torch_gpu.py.

Tolerances, of max|result|:
- fp64: 1e-12 — the same rank-1 steps and products in fp64;
- fp32 ``highest``: 1e-6 for the products, 1e-5 for ``potrf_tile`` (n
  dependent rank-1 steps, each rounded, then the inverse on top);
- fp32 ``high``: 1e-5 — both packages write the bf16x3 split out, the
  partial products are summed in another order;
- fp32 ``default``: 2e-2. The port keeps the TPU's semantics (operands
  rounded to bf16); XLA on the CPU ignores ``precision``, so the reference's
  interpret-mode value is pure fp32 and the two differ by bf16 roundings.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from dla_tpu.cli.session import dag_counts as jax_dag_counts
from dla_tpu.kernels import pallas_tiles as JK
from dla_tpu.tiles import TileLayout as JaxTileLayout
from dla_tpu.utils import precision as jprec
from dla_tpu_torch import TileLayout
from dla_tpu_torch.cli import session
from dla_tpu_torch.kernels import tiles
from dla_tpu_torch.kernels.tiles import (
    gemm_tile,
    gemm_tile_plain,
    potrf_tile,
    potrf_tile_plain,
    syrk_tile,
    syrk_tile_plain,
    trsm_tile,
    trsm_tile_plain,
)
from dla_tpu_torch.utils import precision as tprec
from dla_tpu_torch.utils.interop import from_numpy
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CASES = [(np.float64, "high", n) for n in (16, 64, 128)] + [
    (np.float32, prec, 64) for prec in ("highest", "high", "default")]
IDS = [f"{np.dtype(d).name}-{p}-{n}" for d, p, n in CASES]


def _t(x):
    return from_numpy(x, device="cpu")


def _spd(n, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, n))
    return np.asarray((g + g.T) / 2 + n * np.eye(n), dtype=dtype)


def _tol(dtype, prec, ref, factor=False):
    scale = np.abs(ref).max()
    if dtype == np.float64:
        return 1e-12 * scale
    rel = {"highest": 1e-5 if factor else 1e-6, "high": 1e-5, "default": 2e-2}[prec]
    return rel * scale


def _both(prec, jax_fn, torch_fn, *arrays):
    """The JAX kernel (interpret mode) and the port's wrapper on the same
    numpy inputs, at one tier; outputs as tuples of numpy arrays."""
    with jprec.override(prec):
        ref = jax_fn(*(jnp.asarray(x) for x in arrays))
    with tprec.override(prec):
        got = torch_fn(*(_t(x) for x in arrays))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


class TestAgainstJax:
    @pytest.mark.parametrize("dtype,prec,n", CASES, ids=IDS)
    def test_potrf_tile(self, dtype, prec, n):
        a = _spd(n, dtype, seed=n)
        ref, got = _both(prec, JK.potrf_tile, potrf_tile, a)
        for r, g in zip(ref, got):
            assert g.dtype == dtype and g.shape == (n, n)
            assert np.abs(g - r).max() <= _tol(dtype, prec, r, factor=True)
            assert np.array_equal(g, np.tril(g))

    @pytest.mark.parametrize("dtype,prec,n", CASES, ids=IDS)
    def test_trsm_tile(self, dtype, prec, n):
        rng = np.random.default_rng(n + 1)
        linv = np.tril(rng.standard_normal((n, n))).astype(dtype)
        b = rng.standard_normal((2 * n, n)).astype(dtype)
        (ref,), (got,) = _both(prec, JK.trsm_tile, trsm_tile, linv, b)
        assert got.dtype == dtype and got.shape == b.shape
        assert np.abs(got - ref).max() <= _tol(dtype, prec, ref)

    @pytest.mark.parametrize("dtype,prec,n", CASES, ids=IDS)
    def test_syrk_tile(self, dtype, prec, n):
        rng = np.random.default_rng(n + 2)
        c, a = rng.standard_normal((2, n, n)).astype(dtype)
        (ref,), (got,) = _both(prec, JK.syrk_tile, syrk_tile, c, a)
        assert np.abs(got - ref).max() <= _tol(dtype, prec, ref)
        assert np.array_equal(np.triu(got, 1), np.triu(c, 1))

    @pytest.mark.parametrize("dtype,prec,n", CASES, ids=IDS)
    def test_gemm_tile(self, dtype, prec, n):
        rng = np.random.default_rng(n + 3)
        c, ai, aj = rng.standard_normal((3, n, n)).astype(dtype)
        (ref,), (got,) = _both(prec, JK.gemm_tile, gemm_tile, c, ai, aj)
        assert np.abs(got - ref).max() <= _tol(dtype, prec, ref)

    @pytest.mark.parametrize("op", ["trsm", "syrk", "gemm"])
    def test_bf16_storage(self, op):
        """bf16 tiles: products exact in fp32 at every tier, the product
        rounded to bf16 and subtracted in bf16 in both packages. 2^-7 of
        max|out|: a bf16 rounding of a sum taken in another order may land on
        the neighbouring bf16 value."""
        rng = np.random.default_rng(9)
        c, a, b = (jnp.asarray(x, jnp.bfloat16) for x in rng.standard_normal((3, 64, 64)))
        ref = {"trsm": lambda: JK.trsm_tile(a, c), "syrk": lambda: JK.syrk_tile(c, a),
               "gemm": lambda: JK.gemm_tile(c, a, b)}[op]()
        tc, ta, tb = (_t(np.asarray(x)) for x in (c, a, b))
        got = {"trsm": lambda: trsm_tile(ta, tc), "syrk": lambda: syrk_tile(tc, ta),
               "gemm": lambda: gemm_tile(tc, ta, tb)}[op]()
        assert got.dtype == torch.bfloat16
        ref = np.asarray(ref.astype(jnp.float32))
        assert np.abs(got.float().numpy() - ref).max() <= 2**-7 * np.abs(ref).max()


class TestAgainstScipy:
    """Mirrors of tests/test_kernels.py:26-66."""

    @pytest.mark.parametrize("n", [16, 64, 128])
    def test_potrf_tile(self, n):
        a = _spd(n, seed=n)
        l, linv = potrf_tile(_t(a))
        ref = scipy.linalg.cholesky(a, lower=True)
        np.testing.assert_allclose(l.numpy(), ref, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(linv.numpy() @ ref, np.eye(n), atol=1e-8)

    @pytest.mark.parametrize("fill", [7.7, np.nan])
    def test_potrf_tile_reads_lower_only(self, fill):
        n = 32
        a = _spd(n, seed=5)
        dirty = np.tril(a) + np.triu(np.full((n, n), fill), 1)
        l, linv = potrf_tile(_t(dirty))
        ref = scipy.linalg.cholesky(a, lower=True)
        np.testing.assert_allclose(l.numpy(), ref, rtol=1e-9, atol=1e-9)
        assert np.isfinite(linv.numpy()).all()

    def test_trsm_tile(self):
        n, m = 32, 64
        a = _spd(n, seed=1)
        l = scipy.linalg.cholesky(a, lower=True)
        b = np.random.default_rng(2).standard_normal((m, n))
        _, linv = potrf_tile(_t(a))
        got = trsm_tile(linv, _t(b)).numpy()
        np.testing.assert_allclose(got, b @ np.linalg.inv(l).T, rtol=1e-8, atol=1e-8)

    def test_syrk_tile(self):
        n = 32
        c, a = np.random.default_rng(3).standard_normal((2, n, n))
        got = syrk_tile(_t(c), _t(a)).numpy()
        np.testing.assert_allclose(np.tril(got), np.tril(c - a @ a.T), rtol=1e-10, atol=1e-12)
        np.testing.assert_array_equal(np.triu(got, 1), np.triu(c, 1))

    def test_gemm_tile(self):
        n = 32
        c, ai, aj = np.random.default_rng(4).standard_normal((3, n, n))
        got = gemm_tile(_t(c), _t(ai), _t(aj)).numpy()
        np.testing.assert_allclose(got, c - ai @ aj.T, rtol=1e-10, atol=1e-12)


class TestShapesAndContract:
    @pytest.mark.parametrize("op,shapes", [
        ("trsm", [(24, 24), (40, 24)]),            # linv (n, n), b (m, n), m != n
        ("syrk", [(24, 24), (24, 56)]),            # c (n, n), a (n, k), k != n
        ("gemm", [(40, 24), (40, 56), (24, 56)]),  # c (m, n), ai (m, k), aj (n, k)
    ])
    @pytest.mark.parametrize("dtype", [np.float64, np.float32])
    def test_rectangular_and_inputs_unchanged(self, op, shapes, dtype):
        rng = np.random.default_rng(len(shapes))
        arrays = [rng.standard_normal(s).astype(dtype) for s in shapes]
        jax_fn = getattr(JK, f"{op}_tile")
        fn = getattr(tiles, f"{op}_tile")
        ts = [_t(x) for x in arrays]
        with tprec.override("highest"), jprec.override("highest"):
            got = fn(*ts)
            ref = np.asarray(jax_fn(*(jnp.asarray(x) for x in arrays)))
        assert got.shape == ref.shape and got.is_contiguous()
        assert np.abs(got.numpy() - ref).max() <= _tol(dtype, "highest", ref)
        for t, x in zip(ts, arrays):  # not in place: the inputs come back unchanged
            assert np.array_equal(t.numpy(), x)
        assert all(got.data_ptr() != t.data_ptr() for t in ts)

    def test_potrf_tile_leaves_its_input(self):
        a = _spd(32, seed=8)
        t = _t(a)
        l, linv = potrf_tile(t)
        assert np.array_equal(t.numpy(), a)
        assert l.data_ptr() != t.data_ptr() and linv.data_ptr() != t.data_ptr()

    def test_default_rounds_step_operands_not_the_stored_factor(self):
        """At ``default`` the rank-1 steps multiply bf16-rounded operands, but
        the stored L keeps its fp32 bits: column 0 is a / sqrt(a00) exactly."""
        a = _spd(32, np.float32, seed=3)
        with tprec.override("default"):
            l, _ = potrf_tile(_t(a))
        with tprec.override("highest"):
            lh, _ = potrf_tile(_t(a))
        assert torch.equal(l[:, 0], lh[:, 0])
        assert not torch.equal(l[:, 0], l[:, 0].to(torch.bfloat16).float())
        assert not torch.equal(l, lh)

    def test_cpu_runs_plain_and_counts_no_launch(self):
        before = (tiles.potrf_tile_launches, tiles.trsm_tile_launches,
                  tiles.syrk_tile_launches, tiles.gemm_tile_launches)
        a = _t(_spd(16, seed=1))
        l, linv = potrf_tile(a)
        lp, linvp = potrf_tile_plain(a)
        assert torch.equal(l, lp) and torch.equal(linv, linvp)
        assert torch.equal(trsm_tile(linv, a), trsm_tile_plain(linv, a))
        assert torch.equal(syrk_tile(a, l), syrk_tile_plain(a, l))
        assert torch.equal(gemm_tile(a, l, linv), gemm_tile_plain(a, l, linv))
        assert before == (tiles.potrf_tile_launches, tiles.trsm_tile_launches,
                          tiles.syrk_tile_launches, tiles.gemm_tile_launches)

    def test_argument_checks(self):
        z = torch.zeros
        with pytest.raises(ValueError, match="square"):
            potrf_tile(z(8, 4, dtype=torch.float64))
        with pytest.raises(TypeError, match="real"):
            potrf_tile(z(8, 8, dtype=torch.bfloat16))  # the factor is fp32/fp64 only
        with pytest.raises(TypeError, match="real"):
            gemm_tile(z(8, 8, dtype=torch.complex64), z(8, 8, dtype=torch.complex64),
                      z(8, 8, dtype=torch.complex64))
        with pytest.raises(TypeError, match="one dtype"):
            trsm_tile(z(8, 8), z(4, 8, dtype=torch.float64))
        with pytest.raises(ValueError, match="linv"):
            trsm_tile(z(4, 4), z(4, 8))
        with pytest.raises(ValueError, match="syrk_tile"):
            syrk_tile(z(8, 4), z(8, 4))
        with pytest.raises(ValueError, match="gemm_tile"):
            gemm_tile(z(8, 4), z(8, 6), z(4, 5))
        with pytest.raises(ValueError, match="device"):
            gemm_tile(z(4, 4, device="meta"), z(4, 4), z(4, 4))


# ---- TileLayout and dag_counts ----------------------------------------------------

LAYOUTS = [
    dict(mb=4, nb=4, lm=12, ln=12),
    dict(mb=4, nb=8, lm=18, ln=30, p=2, q=3),
    dict(mb=32, nb=32, lm=128, ln=128, ioff=32, joff=64, m=70, n=50, p=2, q=2),
    dict(mb=5, nb=3, lm=17, ln=11, ioff=5, joff=3, p=3, q=1),
]


class TestTileLayout:
    @pytest.mark.parametrize("kw", LAYOUTS, ids=[str(i) for i in range(len(LAYOUTS))])
    def test_matches_the_reference(self, kw):
        got, ref = TileLayout(**kw), JaxTileLayout(**kw)
        for prop in ("m", "n", "bsiz", "mt", "nt", "padded_m", "padded_n"):
            assert getattr(got, prop) == getattr(ref, prop), prop
        assert got.describe() == ref.describe()
        for i, j in itertools.product(range(ref.mt), range(ref.nt)):
            for method in ("tile_shape", "tile_origin", "owner", "local_index"):
                assert getattr(got, method)(i, j) == getattr(ref, method)(i, j), method
        for pr, qc in itertools.product(range(ref.p), range(ref.q)):
            assert got.local_tiles(pr, qc) == ref.local_tiles(pr, qc)
            assert got.local_grid_shape(pr, qc) == ref.local_grid_shape(pr, qc)
            for li, lj in itertools.product(range(2), range(2)):
                assert got.global_index(pr, qc, li, lj) == ref.global_index(pr, qc, li, lj)
        with pytest.raises(IndexError) as want:
            ref.tile_shape(ref.mt, 0)
        with pytest.raises(IndexError) as err:
            got.tile_shape(ref.mt, 0)
        assert str(err.value) == str(want.value)

    @pytest.mark.parametrize("kw", [
        dict(mb=0, nb=4, lm=8, ln=8), dict(mb=4, nb=4, lm=0, ln=8),
        dict(mb=4, nb=4, lm=8, ln=8, ioff=-4), dict(mb=4, nb=4, lm=8, ln=8, ioff=4, m=8),
        dict(mb=4, nb=4, lm=8, ln=8, joff=2), dict(mb=4, nb=4, lm=8, ln=8, p=0),
    ])
    def test_same_value_errors(self, kw):
        with pytest.raises(ValueError) as want:
            JaxTileLayout(**kw)
        with pytest.raises(ValueError) as err:
            TileLayout(**kw)
        assert str(err.value) == str(want.value)

    def test_frozen(self):
        import dataclasses

        with pytest.raises(dataclasses.FrozenInstanceError):
            TileLayout(mb=4, nb=4, lm=8, ln=8).mb = 2


class TestSession:
    @pytest.mark.parametrize("nt", range(1, 9))
    def test_dag_counts(self, nt):
        assert session.dag_counts(nt) == jax_dag_counts(nt)

    def test_parse_args_like_the_reference(self):
        from dla_tpu.cli.session import parse_args as jax_parse

        for argv in ([], ["--N", "64", "--B", "16", "--p", "2", "--q", "2", "--solve", "3"],
                     ["128", "32", "--x64", "--dtype", "float32"]):
            assert vars(session.parse_args(argv)) == vars(jax_parse(argv))

    def test_main_says_what_is_missing(self, capsys):
        """The session once said the block-cyclic factorization was not
        ported and returned 2; now it runs it (on the CPU when asked) and
        passes its gate."""
        assert session.main(["--N", "64", "--B", "16", "--p", "2", "--q", "2", "--dtype", "d",
                             "--platform", "cpu"]) == 0
        cap = capsys.readouterr()
        assert "not ported" not in cap.out + cap.err
        assert "[CLIENT] session complete: PASS" in cap.out


# ---- the slice as a whole: the tile-task factorization ------------------------------


def tile_task_potrf(a, nb, kernels, counts=None):
    """The reference's task DAG, one kernel call per task, in the order of
    ``client_distrib.cpp:506-565``: POTRF(k,k) → TRSM(i,k) → SYRK(i,i) →
    GEMM(i,j,k). ``a`` is any 2-D array type the four ``kernels`` take;
    returns the nt×nt grid of factor tiles (None above the diagonal)."""
    potrf_k, trsm_k, syrk_k, gemm_k = kernels
    lay = TileLayout(mb=nb, nb=nb, lm=a.shape[0], ln=a.shape[1])
    nt = lay.nt

    def tile(i, j):
        (r0, c0), (h, w) = lay.tile_origin(i, j), lay.tile_shape(i, j)
        return a[r0 : r0 + h, c0 : c0 + w]

    def count(name):
        if counts is not None:
            counts[name] = counts.get(name, 0) + 1

    t = {(i, j): tile(i, j) for i in range(nt) for j in range(i + 1)}
    for k in range(nt):
        t[k, k], linv = potrf_k(t[k, k])
        count("POTRF")
        for i in range(k + 1, nt):
            t[i, k] = trsm_k(linv, t[i, k])
            count("TRSM")
        for i in range(k + 1, nt):
            t[i, i] = syrk_k(t[i, i], t[i, k])
            count("SYRK")
        for i in range(k + 1, nt):
            for j in range(k + 1, i):
                t[i, j] = gemm_k(t[i, j], t[i, k], t[j, k])
                count("GEMM")
    return t, nt


def _assemble(t, nt, nb, to_np):
    out = np.zeros((nt * nb, nt * nb))
    for (i, j), x in t.items():
        out[i * nb : (i + 1) * nb, j * nb : (j + 1) * nb] = to_np(x)
    return out


class TestTileTaskPath:
    def test_against_the_jax_kernels(self):
        n, nb = 128, 32
        a = _spd(n, seed=11)
        counts = {}
        # torch slices of a row-major matrix are row-major views: the wrappers take them
        tt, nt = tile_task_potrf(_t(a), nb, (potrf_tile, trsm_tile, syrk_tile, gemm_tile), counts)
        tj, _ = tile_task_potrf(jnp.asarray(a), nb,
                                (JK.potrf_tile, JK.trsm_tile, JK.syrk_tile, JK.gemm_tile))
        lt = _assemble(tt, nt, nb, lambda x: x.numpy())
        lj = _assemble(tj, nt, nb, np.asarray)
        assert np.abs(lt - lj).max() <= 1e-12 * np.abs(lj).max()
        assert np.array_equal(lt, np.tril(lt))
        res = np.abs(a - lt @ lt.T).sum(1).max() / np.abs(a).sum(1).max()
        assert res < 1e-10
        want = session.dag_counts(nt)
        assert counts == {k: v for k, v in want.items() if k != "total"}
        assert sum(counts.values()) == want["total"] == 20

    def test_ragged_last_tile(self):
        """N not a multiple of NB: TileLayout's edge tiles are short, and the
        kernels take rectangular tiles."""
        n, nb = 100, 32
        a = _spd(n, seed=12)
        tt, nt = tile_task_potrf(_t(a), nb, (potrf_tile, trsm_tile, syrk_tile, gemm_tile))
        l = np.zeros((n, n))
        for (i, j), x in tt.items():
            l[i * nb : i * nb + x.shape[0], j * nb : j * nb + x.shape[1]] = x.numpy()
        np.testing.assert_allclose(l, scipy.linalg.cholesky(a, lower=True), rtol=1e-9, atol=1e-9)
