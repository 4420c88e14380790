"""dla_tpu_torch's packed-storage path held against the JAX package.

The same numpy inputs (made from a seed) go through ``dla_tpu`` (JAX on the
CPU with x64, the Pallas packed kernel in interpret mode, as in
tests/test_packed.py) and ``dla_tpu_torch`` (plain versions on the CPU). The
packed buffer has one 2-D layout in both packages, so arrays cross through
``utils/interop`` unchanged. The CUDA kernel is held against the plain
version on the card in tests/test_torch_gpu.py.

Tolerances:
- layout and generator: bit for bit;
- trailing update, relative to ``scale = max_i ||p_i||²`` (= max |P·Pᵀ|):
  fp64 1e-12; fp32 highest/high/default 1e-5 (the same partial products —
  high: the bf16x3 split; default: bf16 operands, fed to both sides
  pre-rounded because XLA on the CPU ignores ``precision`` — summed in
  another order); bf16 storage 2^-6 of (max|c| + scale) (two bf16 roundings,
  each possibly one ulp apart);
- factor: fp64 rtol 1e-12 of max|L|; fp32 ``high``/``highest`` 1e-5 of
  max|L| (the same formulation in fp32, summed in another order).
"""

import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import dla_tpu_torch as T
from dla_tpu.algos import packed as J
from dla_tpu.kernels.pallas_tiles import trailing_update_packed as jax_trailing_packed
from dla_tpu.utils import precision as jprec
from dla_tpu_torch.algos import packed as P
from dla_tpu_torch.cli import potrf_driver
from dla_tpu_torch.kernels import tiles
from dla_tpu_torch.kernels.tiles import trailing_update_packed, trailing_update_packed_plain
from dla_tpu_torch.utils import precision as tprec
from dla_tpu_torch.utils.interop import from_numpy, to_numpy
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

JDT = {np.float64: jnp.float64, np.float32: jnp.float32, ml_dtypes.bfloat16: jnp.bfloat16}
TDT = {np.float64: torch.float64, np.float32: torch.float32, ml_dtypes.bfloat16: torch.bfloat16}


def _t(x):
    return from_numpy(x, device="cpu")


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _sym(n, seed, dtype):
    g = np.random.default_rng(seed).standard_normal((n, n))
    return ((g + g.T) / 2 + n * np.eye(n)).astype(dtype)


class TestLayout:
    @pytest.mark.parametrize("dtype", [np.float64, np.float32, ml_dtypes.bfloat16])
    def test_pack_unpack_col_slab_bit_equal(self, dtype):
        n, tb = 256, 64
        a = _sym(n, 1, dtype)
        ref = np.asarray(J.pack_tri(jnp.asarray(a), tb))
        got = P.pack_tri(_t(a), tb)
        assert _bits_equal(to_numpy(got), ref)
        assert _bits_equal(to_numpy(P.unpack_tri(got, n, tb)),
                           np.asarray(J.unpack_tri(jnp.asarray(ref), n, tb)))
        for j in range(n // tb):
            assert _bits_equal(to_numpy(P.col_slab(got, j, n, tb)),
                               np.asarray(J.col_slab(jnp.asarray(ref), j, n, tb)))

    @pytest.mark.parametrize("n,tb", [(256, 64), (384, 96), (1024, 1024), (81920, 4096)])
    def test_lengths_match(self, n, tb):
        assert P.packed_len(n, tb) == J.packed_len(n, tb) == n * (n + tb) // 2
        assert P.packed_rows(n, tb) == J.packed_rows(n, tb)
        with pytest.raises(ValueError):
            P.packed_len(n + 1, tb)

    def test_col_slab_is_a_view_and_set_col_writes_in_place(self):
        n, tb = 192, 64
        p = P.pack_tri(torch.from_numpy(_sym(n, 2, np.float64)), tb)
        P.col_slab(p, 1, n, tb)[0, 0] = -7.0
        assert p[P._row_offset(1, n // tb, tb), 0] == -7.0
        slab = torch.full((tb, tb), 3.0, dtype=torch.float32)
        assert P._set_col(p, 2, slab, n, tb) is p
        assert torch.equal(p[-tb:], slab.double())

    @pytest.mark.parametrize("jdt", [jnp.float32, jnp.float64])
    @pytest.mark.parametrize("seed", [51, 2**31 + 5])
    def test_plgsy_packed_bit_identical(self, jdt, seed):
        n, tb = 384, 128
        ref = np.asarray(J.plgsy_packed(n, tb, seed=seed, dtype=jdt))
        got = P.plgsy_packed(n, tb, seed=seed, dtype=TDT[np.dtype(jdt).type],
                              device="cpu").numpy()
        assert _bits_equal(got, ref)

    def test_plgsy_packed_row_chunks(self, monkeypatch):
        monkeypatch.setattr(P, "_SLAB_ELEMS", 5 * 64)  # 5-row chunks
        got = P.plgsy_packed(256, 64, seed=3, dtype=torch.float64, device="cpu")
        assert torch.equal(P.unpack_tri(got, 256, 64), torch.tril(
            T.plgsy(256, seed=3, dtype=torch.float64, device="cpu")))

    @pytest.mark.parametrize("dtype", [np.float64, ml_dtypes.bfloat16])
    def test_jax_factor_unpacked_by_the_port(self, dtype):
        """The state crosses unchanged: a packed factor made by JAX, unpacked by
        the port, equals JAX's unpack_tri bit for bit."""
        n, tb = 256, 64
        lp = np.asarray(J.potrf_packed(J.plgsy_packed(n, tb, dtype=JDT[dtype]), n, tb))
        ref = np.asarray(J.unpack_tri(jnp.asarray(lp), n, tb))
        assert _bits_equal(to_numpy(P.unpack_tri(_t(lp), n, tb)), ref)


def _steps(n, w):
    nt = n // w
    return sorted({0, (nt - 1) // 2, nt - 2})


TRAILING_CASES = [(n, w, ktb, k) for n, w, ktb in [(768, 256, 128), (384, 96, 32)]
                  for k in _steps(n, w)]


def _visited(n, w, ktb, k):
    """True on the packed elements the step-k update must touch."""
    nt, base = n // w, (k + 1) * w
    rows, cols = [], []
    for j in range(nt):
        r = np.arange(j * w, n) - base
        c = np.arange(j * w, (j + 1) * w) - base
        rows.append(np.broadcast_to(r[:, None], (r.size, w)))
        cols.append(np.broadcast_to(c[None, :], (r.size, w)))
    r, c = np.concatenate(rows), np.concatenate(cols)
    return (r >= 0) & (c >= 0) & (np.maximum(r, 0) // ktb >= np.maximum(c, 0) // ktb)


class TestTrailingPackedPlain:
    @pytest.mark.parametrize("prec,dtype", [
        ("high", np.float64), ("highest", np.float32), ("high", np.float32),
        ("default", np.float32), ("high", ml_dtypes.bfloat16),
    ])
    @pytest.mark.parametrize("n,w,ktb,k", TRAILING_CASES)
    def test_matches_jax(self, n, w, ktb, k, prec, dtype):
        rng = np.random.default_rng(n + 7 * k + ktb)
        c = rng.standard_normal((P.packed_rows(n, w), w))
        p = rng.standard_normal((n - (k + 1) * w, w))
        if prec == "default":
            p = p.astype(ml_dtypes.bfloat16).astype(np.float64)
        c, p = c.astype(dtype), p.astype(dtype)
        with jprec.override(prec):
            ref = np.asarray(jax_trailing_packed(jnp.asarray(c), jnp.asarray(p), n=n, w=w, k=k,
                                                 tb=ktb))
        tc = _t(c)
        with tprec.override(prec):
            out = trailing_update_packed(tc, _t(p), n=n, w=w, k=k, tb=ktb)
        assert out is tc  # in place
        got = to_numpy(out)
        mask = _visited(n, w, ktb, k)
        p64 = p.astype(np.float64)
        scale = (p64**2).sum(1).max()
        tol = {np.float64: 1e-12 * scale, np.float32: 1e-5 * scale}.get(
            dtype, 2**-6 * (np.abs(c.astype(np.float64)).max() + scale))
        diff = np.abs(got.astype(np.float64) - ref.astype(np.float64))
        assert diff[mask].max() <= tol
        assert _bits_equal(got[~mask], c[~mask])
        assert _bits_equal(ref[~mask], c[~mask])  # the reference leaves the same elements


class TestWrapper:
    def _args(self, n=384, w=96, k=0, dtype=torch.float32, device="cpu"):
        packed = torch.zeros(P.packed_rows(n, w), w, dtype=dtype, device=device)
        return packed, torch.zeros(n - (k + 1) * w, w, dtype=dtype, device=device)

    def test_cpu_runs_plain_and_counts_no_launch(self):
        rng = np.random.default_rng(3)
        c = torch.from_numpy(rng.standard_normal((P.packed_rows(384, 96), 96)))
        p = torch.from_numpy(rng.standard_normal((288, 96)))
        before = tiles.packed_launches
        got = trailing_update_packed(c.clone(), p, n=384, w=96, k=0, tb=32)
        ref = trailing_update_packed_plain(c.clone(), p, n=384, w=96, k=0, tb=32)
        assert torch.equal(got, ref) and not torch.equal(got, c)
        assert tiles.packed_launches == before

    def test_other_devices_raise(self):
        packed, p = self._args(device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            trailing_update_packed(packed, p, n=384, w=96, k=0, tb=32)

    @pytest.mark.parametrize("fn", [trailing_update_packed, trailing_update_packed_plain])
    def test_shape_checks(self, fn):
        packed, p = self._args()
        with pytest.raises(ValueError, match="panel shape"):
            fn(packed, p[1:], n=384, w=96, k=0, tb=32)
        with pytest.raises(ValueError, match="w % tb"):
            fn(packed, p, n=384, w=96, k=0, tb=64)
        with pytest.raises(ValueError, match="n % w"):
            fn(packed, p, n=380, w=96, k=0, tb=32)
        with pytest.raises(ValueError, match="packed buffer shape"):
            fn(packed[1:], p, n=384, w=96, k=0, tb=32)
        with pytest.raises(ValueError, match="kb"):
            fn(packed, p, n=384, w=96, k=0, tb=32, kb=64)
        with pytest.raises(ValueError, match="step"):
            fn(packed, torch.zeros(480, 96), n=384, w=96, k=-2, tb=32)

    @pytest.mark.parametrize("cdt,pdt", [
        (torch.complex128, torch.complex128), (torch.float32, torch.float64),
        (torch.float16, torch.float16),
    ])
    def test_dtype_checks(self, cdt, pdt):
        packed, p = self._args()
        with pytest.raises(TypeError):
            trailing_update_packed(packed.to(cdt), p.to(pdt), n=384, w=96, k=0, tb=32)


def _factor_pair(dtype, trailing, prec, ap=None):
    n, w = 768, 256
    kw = dict(trailing=trailing, ktb=128, ib=128, precision=prec)
    if ap is None:
        ap = np.asarray(J.plgsy_packed(n, w, dtype=JDT[dtype]))
    ref = np.asarray(J.unpack_tri(J.potrf_packed(jnp.asarray(ap), n, w, **kw), n, w))
    tp = _t(ap)
    out = P.potrf_packed(tp, n, w, **kw)
    assert out is tp  # factored in place
    return ref, P.unpack_tri(out, n, w).numpy()


class TestPotrfPacked:
    @pytest.mark.parametrize("trailing", ["pallas", "xla"])
    @pytest.mark.parametrize("dtype,prec", [
        (np.float64, "high"), (np.float32, "high"), (np.float32, "highest"),
    ])
    def test_matches_jax(self, trailing, dtype, prec):
        ref, got = _factor_pair(dtype, trailing, prec)
        rtol = 1e-12 if dtype == np.float64 else 1e-5
        assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()
        if dtype == np.float64:
            a = np.asarray(J.unpack_tri(J.plgsy_packed(768, 256, dtype=jnp.float64), 768, 256))
            chol = np.linalg.cholesky(a + np.tril(a, -1).T)
            np.testing.assert_allclose(got, chol, rtol=1e-10, atol=1e-12)

    @pytest.mark.parametrize("trailing", ["pallas", "xla"])
    def test_garbage_above_the_diagonal_is_not_read(self, trailing):
        """Queue C #3: each diagonal w-block is stored whole; what its strict
        upper holds must not change the tril factor."""
        n, w = 768, 256
        clean = np.asarray(J.plgsy_packed(n, w, dtype=jnp.float64))
        dirty = clean.copy()
        for j in range(n // w):
            r0 = P._row_offset(j, n // w, w)
            dirty[r0 : r0 + w] += np.triu(np.full((w, w), 123.0), 1)
        kw = dict(trailing=trailing, ktb=128, ib=128)
        got = P.unpack_tri(P.potrf_packed(_t(dirty), n, w, **kw), n, w)
        ref = P.unpack_tri(P.potrf_packed(_t(clean), n, w, **kw), n, w)
        assert torch.equal(got, ref)

    def test_bf16_storage_freivalds_class(self):
        n, w = 512, 128
        lp = P.potrf_packed(P.plgsy_packed(n, w, dtype=torch.bfloat16, device="cpu"), n, w,
                            trailing="pallas", ktb=128)
        assert lp.dtype == torch.bfloat16
        assert float(P.freivalds_packed(lp, n, w)) < n**0.5 * 2e-4

    def test_complex_and_bad_options_raise(self):
        # complex factors on the torch route (the identity is its own factor);
        # the kernel's route raises for it, with the reference's message
        a = torch.eye(128, dtype=torch.complex128)
        assert torch.equal(P.unpack_tri(P.potrf_packed(P.pack_tri(a, 64), 128, 64), 128, 64), a)
        with pytest.raises(ValueError, match="real dtypes only"):
            P.potrf_packed(P.pack_tri(a, 64), 128, 64, trailing="pallas")
        with pytest.raises(ValueError, match="trailing"):
            P.potrf_packed(P.pack_tri(torch.eye(128), 64), 128, 64, trailing="cuda")
        with pytest.raises(ValueError):
            P.potrf_packed(P.pack_tri(torch.eye(128), 64), 128, 48)


class TestMatrixFree:
    @pytest.mark.parametrize("trans", [False, True])
    @pytest.mark.parametrize("vec", [False, True])
    def test_trmm_packed(self, trans, vec):
        n, tb = 192, 64
        rng = np.random.default_rng(40)
        l = np.tril(rng.standard_normal((n, n)))
        b = rng.standard_normal(n if vec else (n, 3))
        lp = np.asarray(J.pack_tri(jnp.asarray(l), tb))
        ref = np.asarray(J.trmm_packed(jnp.asarray(lp), jnp.asarray(b), n, tb, trans=trans))
        got = P.trmm_packed(_t(lp), _t(b), n, tb, trans=trans).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("vec", [False, True])
    def test_spd_matvec_streamed(self, vec):
        n = 512
        x = np.random.default_rng(41).standard_normal(n if vec else (n, 2))
        ref = np.asarray(J.spd_matvec_streamed(jnp.asarray(x), n, cb=128, dtype=jnp.float64))
        got = P.spd_matvec_streamed(_t(x), n, cb=128).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
        with pytest.raises(ValueError):
            P.spd_matvec_streamed(_t(x), n, cb=96)

    def test_freivalds_packed_gate(self):
        """The probe is drawn from a torch.Generator seeded with ``key``, not
        from jax.random: the values are compared in magnitude, not in bits."""
        n, tb = 512, 128
        lp = P.potrf_packed(P.plgsy_packed(n, tb, dtype=torch.float64, device="cpu"), n, tb)
        r = float(P.freivalds_packed(lp, n, tb))
        assert r < 1e-12, r
        assert float(P.freivalds_packed(lp, n, tb)) == r  # same key, same probe
        jr = float(J.freivalds_packed(J.potrf_packed(J.plgsy_packed(n, tb, dtype=jnp.float64),
                                                     n, tb), n, tb))
        assert jr < 1e-12
        bad = lp.clone()
        bad[100, 10] += 1.0  # as tests/test_packed.py corrupts the factor
        assert float(P.freivalds_packed(bad, n, tb)) > 1e-8
        assert float(P.freivalds_packed(bad, n, tb, key=1)) > 1e-8


class TestFreivaldsPackedSeesTheFactor:
    """Watch-list item 9 for the packed gate: ``freivalds_packed`` must rise
    with a known relative perturbation δ of the packed tril(L), in the port
    and in JAX. The probes differ (``torch.Generator`` against
    ``jax.random``), so each package is held to the same bounds on its own:
    never below its unperturbed value (the floor), and within [δ/10, 10δ]
    once δ is ten times the floor, rising with δ."""

    DELTAS = [1e-7, 1e-6, 1e-5, 1e-4, 1e-3]

    @pytest.mark.parametrize("dtype", [np.float64, np.float32])
    def test_rises_with_the_perturbation(self, dtype):
        n, tb = 256, 64
        a = np.asarray(J.plgsy_packed(n, tb, dtype=jnp.float64))
        l = np.asarray(J.unpack_tri(J.potrf_packed(jnp.asarray(a), n, tb), n, tb))
        r = np.random.default_rng(9).uniform(-1.0, 1.0, l.shape)
        gates = {
            "port": lambda lp: float(P.freivalds_packed(_t(lp), n, tb)),
            "jax": lambda lp: float(J.freivalds_packed(jnp.asarray(lp), n, tb)),
        }
        for name, gate in gates.items():
            got = [gate(np.asarray(J.pack_tri(jnp.asarray(np.tril(l * (1.0 + d * r))
                                                          .astype(dtype)), tb)))
                   for d in [0.0] + self.DELTAS]
            floor, seen = got[0], []
            for delta, v in zip(self.DELTAS, got[1:]):
                assert v >= floor * (1 - 1e-3), (name, delta, v, floor)
                if delta >= 10 * floor:
                    assert delta / 10 <= v <= 10 * delta, (name, delta, v)
                    seen.append(v)
            assert len(seen) >= 2 and seen == sorted(seen), (name, got)


@pytest.mark.parametrize("dtype,extra,gate", [
    ("d", ["--trailing", "pallas", "--kb", "64"], "1e-10"),
    ("s", ["--trailing", "pallas", "--precision", "high", "--diag", "twolevel"], "5.12e-05"),
    ("s", ["--trailing", "xla"], "5.12e-05"),
])
def test_driver_packed_mode(capsys, dtype, extra, gate):
    rc = potrf_driver.main(["--n", "256", "--nb", "64", "--dtype", dtype, "--mode", "packed",
                            "--device", "cpu", "--repeats", "2", *extra])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "mode=packed" in out
    assert re.search(r"^Repeat 0: [\d.]+ ms [\d.]+ Gflop/s \(warm-up\)$", out, re.M)
    assert len(re.findall(r"^Repeat [12]: [\d.]+ ms [\d.]+ Gflop/s$", out, re.M)) == 2
    assert re.search(r"^Elapsed: [\d.]+ ms$", out, re.M)
    assert re.search(r"^Performance: \d+\.\d\d Gflop/s$", out, re.M)
    res = re.search(r"^freivalds \|\|\(A - LL\^T\)x\|\| / \(\|\|A\|\| \|\|x\|\|\) = (\S+)$",
                    out, re.M)
    assert res and float(res.group(1)) < float(gate)
    assert f"PASS (residual < {gate})" in out


def test_driver_packed_fail_gate(capsys):
    rc = potrf_driver.main(["--n", "128", "--nb", "32", "--dtype", "s", "--mode", "packed",
                            "--device", "cpu", "--gate", "1e-30"])
    assert rc == 1 and "FAIL (residual >= 1e-30)" in capsys.readouterr().out
