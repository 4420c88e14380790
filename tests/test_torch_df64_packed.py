"""dla_tpu_torch's packed emulated-fp64 path held against dla_tpu's on the
same numpy inputs: the packed df64 trailing update, ``potrf_packed_df64`` and
its split, the packed and dense df64 solves, and the three streaming df64
Freivalds gates.

On the CPU the port's trailing wrapper runs its plain torch version and the
JAX kernel runs in interpret mode, as in tests/test_df64.py. The CUDA kernel
is held against the plain version on the card in tests/test_torch_gpu.py.

What is compared how:
- the packed trailing update is exact up to a fixed order of roundings, so
  both packages give the **same bits** on both planes;
- the factors start from LAPACK fp32 Cholesky factors that may differ in their
  last bits, and the refinement takes both to the df64 floor: max|ΔL| ≤
  1e-13·max|L| in fp64 of hi + lo, forward error ≤ 1e-12 against scipy;
- a ``k0``/``k1`` range or a split runs the same steps: the same bits;
- the gates draw numpy's probes in both packages, every product in them is an
  exact per-chunk sum, and on one factor they differ only in the order of the
  fp32 |A| row sums of the denominator: 1e-5 relative on a good factor (values
  near 5e-14) and on a corrupted one (values above 1e-9);
- the solves are held to the reference's posv gate against fp64 with a
  100-fold margin (1e-12), and to JAX's solution within 1e-12·max|x|.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from dla_tpu.algos import packed as JPK
from dla_tpu.algos import solve as JS
from dla_tpu.kernels.df64_tiles import trailing_update_packed_df64 as jax_trailing
from dla_tpu.ops import df64 as JD
from dla_tpu_torch.algos import packed as TPK
from dla_tpu_torch.algos import solve as TS
from dla_tpu_torch.kernels import df64_tiles
from dla_tpu_torch.kernels.df64_tiles import (
    trailing_update_packed_df64,
    trailing_update_packed_df64_plain,
)
from dla_tpu_torch.ops import df64 as TD
from dla_tpu_torch.utils import precision
from dla_tpu_torch.utils.interop import from_numpy, to_numpy
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

JP = importlib.import_module("dla_tpu.algos.potrf_df64")
TP = importlib.import_module("dla_tpu_torch.algos.potrf_df64")


def _bits(x) -> np.ndarray:
    a = to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _same_bits(jax_out, torch_out) -> bool:
    return all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(jax_out, torch_out, strict=True))


def _spd(n, seed):
    g = np.random.default_rng(seed).standard_normal((n, n))
    return (g + g.T) / 2 + n * np.eye(n)


def _t(x):
    return from_numpy(np.asarray(x), device="cpu")


def _packed_pair(a, nb):
    """The packed torch (hi, lo) pair of an fp64 numpy matrix."""
    ah, al = TD.to_df64(a, device="cpu")
    return TPK.pack_tri(ah, nb), TPK.pack_tri(al, nb)


def _dense64(lph, lpl, n, nb):
    """hi + lo of a packed torch pair, unpacked, in fp64 numpy."""
    return TD.from_df64(TPK.unpack_tri(lph, n, nb), TPK.unpack_tri(lpl, n, nb)).numpy()


def _visited(n, nb, tb, k):
    """Mask over the packed buffer of the elements step k's update visits."""
    nt, base = n // nb, (k + 1) * nb
    out = np.zeros((TPK.packed_rows(n, nb), nb), bool)
    for j in range(nt):
        r0 = TPK._row_offset(j, nt, nb)
        r = np.arange(j * nb, n) - base
        c = np.arange(j * nb, (j + 1) * nb) - base
        out[r0 : r0 + (nt - j) * nb] = ((r[:, None] >= 0) & (c[None, :] >= 0)
                                        & (r[:, None] // tb >= c[None, :] // tb))
    return out


TRAILING_CASES = [  # (n, nb, tb, s, w, k)
    (512, 128, 128, 7, 8, 0),
    (512, 128, 128, 7, 8, 1),
    (512, 128, 128, 7, 8, 2),  # nt − 2: the last step that has a trailing window
    (1024, 512, 128, 6, 9, 0),  # nk = 2 chunks (kb = 256 at w = 9), tb < nb
    (384, 128, 64, 7, 8, 0),  # tb < nb: tiles above the diagonal inside a diagonal block
    (576, 192, 96, 7, 8, 1),  # tb not a multiple of the kernel's 64-wide blocks
]


class TestTrailing:
    @pytest.mark.parametrize("n,nb,tb,s,w,k", TRAILING_CASES)
    def test_plain_bits_match_jax(self, n, nb, tb, s, w, k):
        rng = np.random.default_rng(n + nb + tb + k)
        c = rng.standard_normal((TPK.packed_rows(n, nb), nb))
        p = rng.standard_normal((n - (k + 1) * nb, nb))
        ch, cl = JD.to_df64(c)
        sx = JD.slice_rows(*JD.to_df64(p), s=s, w=w)[0]
        ref = jax_trailing(ch, cl, list(sx), n=n, nb=nb, k=k, tb=tb, w=w)
        tch, tcl = _t(ch), _t(cl)
        tsx = TD.slice_rows(*TD.to_df64(p, device="cpu"), s=s, w=w)[0]
        before = df64_tiles.packed_launches
        got = trailing_update_packed_df64(tch, tcl, tsx, n=n, nb=nb, k=k, tb=tb, w=w)
        assert df64_tiles.packed_launches == before  # the CPU runs the plain version
        assert got[0] is tch and got[1] is tcl  # in place
        assert _same_bits(ref, got)
        out = ~_visited(n, nb, tb, k)
        assert np.array_equal(_bits(got[0])[out], _bits(ch)[out])
        assert np.array_equal(_bits(got[1])[out], _bits(cl)[out])
        assert not np.array_equal(_bits(got[0])[~out], _bits(ch)[~out])
        # against fp64: the lower triangle of the trailing window
        o = (k + 1) * nb
        upd = _dense64(*got, n, nb)[o:, o:]
        want = np.tril(_dense64(_t(ch), _t(cl), n, nb)[o:, o:] - p @ p.T)
        assert np.abs(upd - want).max() < 1e-9

    def test_precise_deg_bits(self):
        n, nb = 384, 128
        rng = np.random.default_rng(9)
        c = rng.standard_normal((TPK.packed_rows(n, nb), nb))
        ch, cl = JD.to_df64(c)
        sx = JD.slice_rows(*JD.to_df64(rng.standard_normal((n - nb, nb))), s=5)[0]
        for deg in (0, 8):
            ref = jax_trailing(ch, cl, list(sx), n=n, nb=nb, k=0, tb=128, precise_deg=deg)
            got = trailing_update_packed_df64_plain(_t(ch), _t(cl), [_t(x) for x in sx], n=n,
                                                    nb=nb, k=0, tb=128, precise_deg=deg)
            assert _same_bits(ref, got)

    @pytest.mark.parametrize("fn", [trailing_update_packed_df64,
                                    trailing_update_packed_df64_plain])
    def test_checks(self, fn):
        z = torch.zeros
        bf = torch.bfloat16
        pair = (z(1280, 128), z(1280, 128))  # n=512, nb=128
        sl = [z(384, 128, dtype=bf)] * 3
        with pytest.raises(ValueError, match="planes must match"):
            fn(z(1280, 128), z(512, 128), sl, n=512, nb=128, k=0, tb=64)
        with pytest.raises(ValueError, match="tb . nb . n"):
            fn(*pair, sl, n=512, nb=128, k=0, tb=96)
        with pytest.raises(ValueError, match="tb . nb . n"):
            fn(*pair, sl, n=500, nb=128, k=0, tb=64)
        with pytest.raises(ValueError, match="slice shape"):
            fn(*pair, sl, n=512, nb=128, k=1, tb=64)
        with pytest.raises(ValueError, match="step k"):
            fn(*pair, sl, n=512, nb=128, k=4, tb=64)
        with pytest.raises(ValueError, match="plane shape"):
            fn(z(512, 128), z(512, 128), sl, n=512, nb=128, k=0, tb=64)
        with pytest.raises(ValueError, match="chunk"):  # nb = 1536 > kb = 1024
            fn(z(1536, 1536), z(1536, 1536), [z(0, 1536, dtype=bf)], n=1536, nb=1536, k=0,
               tb=512)
        with pytest.raises(TypeError, match="float32"):
            fn(pair[0].double(), pair[1].double(), sl, n=512, nb=128, k=0, tb=64)
        with pytest.raises(TypeError, match="bfloat16"):
            fn(*pair, [z(384, 128)], n=512, nb=128, k=0, tb=64)

    def test_other_devices_raise(self):
        sl = [torch.zeros(128, 128, dtype=torch.bfloat16, device="meta")]
        kw = dict(n=256, nb=128, k=0, tb=64)
        with pytest.raises(ValueError, match="CUDA"):
            trailing_update_packed_df64(torch.zeros(384, 128, device="meta"),
                                        torch.zeros(384, 128, device="meta"), sl, **kw)
        with pytest.raises(ValueError, match="CUDA"):
            trailing_update_packed_df64(torch.zeros(384, 128), torch.zeros(384, 128), sl, **kw)


_JAX_FACTORS = {}


def _jax_factor(n, nb, ktb):
    """dla_tpu's packed df64 factor of ``_spd(n, n)``, computed once per case."""
    key = (n, nb, ktb)
    if key not in _JAX_FACTORS:
        a = _spd(n, n)
        ah, al = JD.to_df64(a)
        lph, lpl = JP.potrf_packed_df64(JPK.pack_tri(ah, nb), JPK.pack_tri(al, nb), n, nb,
                                        ktb=ktb)
        _JAX_FACTORS[key] = (a, np.asarray(lph), np.asarray(lpl))
    return _JAX_FACTORS[key]


POTRF_CASES = [(512, 128, 128), (512, 256, 64)]  # (n, nb, ktb); the second has ktb < nb


class TestPotrfPacked:
    @pytest.mark.parametrize("n,nb,ktb", POTRF_CASES)
    def test_matches_jax_scipy_and_dense(self, n, nb, ktb):
        a, jlph, jlpl = _jax_factor(n, nb, ktb)
        aph, apl = _packed_pair(a, nb)
        lph, lpl = TP.potrf_packed_df64(aph, apl, n, nb, ktb=ktb)
        assert lph is aph and lpl is apl  # factored in place
        l = _dense64(lph, lpl, n, nb)
        lj = _dense64(_t(jlph), _t(jlpl), n, nb)
        assert np.abs(l - lj).max() <= 1e-13 * np.abs(lj).max()
        ref = scipy.linalg.cholesky(a, lower=True)
        assert np.abs(l - ref).max() <= 1e-12 * np.abs(ref).max()
        assert np.abs(a - l @ l.T).sum(1).max() / np.abs(a).sum(1).max() < 1e-11
        # the same pass loop in the same tile order as the dense pallas-trailing factor
        dh, dl = TP.potrf_df64(*TD.to_df64(a, device="cpu"), nb=nb, trailing="pallas", tb=ktb)
        assert np.abs(TD.from_df64(dh, dl).numpy() - l).max() <= 1e-13 * np.abs(l).max()

    def test_plgsy_packed_pair_input(self):
        n, nb = 512, 128
        aph = TPK.plgsy_packed(n, nb, seed=51, device="cpu")
        assert _same_bits([JPK.plgsy_packed(n, nb, seed=51)], [aph])
        l = _dense64(*TP.potrf_packed_df64(aph, torch.zeros_like(aph), n, nb, ktb=128), n, nb)
        a = TPK.unpack_tri(TPK.plgsy_packed(n, nb, seed=51, device="cpu"), n, nb).double().numpy()
        a = a + np.tril(a, -1).T  # the factor reproduces tril(A)
        assert np.abs(a - l @ l.T).sum(1).max() / np.abs(a).sum(1).max() < 1e-11

    @pytest.mark.parametrize("ktb", [128, 64])
    def test_garbage_above_the_diagonal_is_not_read(self, ktb):
        n, nb = 512, 128
        aph, apl = _packed_pair(_spd(n, 11), nb)
        clean = TP.potrf_packed_df64(aph.clone(), apl.clone(), n, nb, ktb=ktb)
        up = torch.triu(torch.ones(nb, nb, dtype=torch.bool), 1)
        for j in range(n // nb):  # every diagonal block, strictly above its diagonal
            TPK.col_slab(aph, j, n, nb)[:nb][up] = 123.0
            TPK.col_slab(apl, j, n, nb)[:nb][up] = -7.0
        dirty = TP.potrf_packed_df64(aph, apl, n, nb, ktb=ktb)
        assert _same_bits(clean, dirty)
        # a finished factor's diagonal blocks are tril: trmm may read slabs whole
        blocks = [TPK.col_slab(p, j, n, nb)[:nb] for p in dirty for j in range(n // nb)]
        assert all(torch.equal(b, b.tril()) for b in blocks)

    def test_step_ranges_give_the_monolith_bits(self):
        n, nb = 512, 128
        a = _spd(n, 12)
        mono = TP.potrf_packed_df64(*_packed_pair(a, nb), n, nb, ktb=64)
        pair = _packed_pair(a, nb)
        for k0, k1 in ((0, 1), (1, 1), (1, 3), (3, 4)):
            out = TP.potrf_packed_df64(*pair, n, nb, ktb=64, k0=k0, k1=k1)
            assert out[0] is pair[0] and out[1] is pair[1]
        assert _same_bits(mono, pair)
        with pytest.raises(ValueError, match="k0 <= k1"):
            TP.potrf_packed_df64(*pair, n, nb, ktb=64, k0=3, k1=2)
        with pytest.raises(ValueError, match="k0 <= k1"):
            TP.potrf_packed_df64(*pair, n, nb, ktb=64, k1=5)

    @pytest.mark.parametrize("split", [0, 1, 2, 3, 8])  # 0 auto-sizes; 8 > nt is clamped
    def test_split_gives_the_monolith_bits_in_place(self, split):
        n, nb = 512, 128
        a = _spd(n, 13)
        mono = TP.potrf_packed_df64(*_packed_pair(a, nb), n, nb, ktb=128)
        pair = _packed_pair(a, nb)
        out = TP.potrf_packed_df64_split(*pair, n, nb, split=split, ktb=128)
        # the caller's pair holds the factor afterwards and is what comes back
        assert out[0] is pair[0] and out[1] is pair[1]
        assert _same_bits(mono, out)

    def test_split_auto_sizes_to_40_steps(self, monkeypatch):
        calls = []
        monkeypatch.setattr(TP, "potrf_packed_df64",
                            lambda h, l, n, nb, **kw: calls.append((kw["k0"], kw["k1"])) or (h, l))
        z = torch.zeros(1, 1)
        TP.potrf_packed_df64_split(z, z, 82 * 8, 8, split=0)
        assert calls == [(0, 27), (27, 55), (55, 82)]  # 82 steps: three segments of ≤ 40
        calls.clear()
        TP.potrf_packed_df64_split(z, z, 40 * 8, 8, split=0)
        assert calls == [(0, 40)]
        with pytest.raises(ValueError, match="split"):
            TP.potrf_packed_df64_split(z, z, 64, 8, split=-1)

    def test_other_inputs_are_copied(self):
        n, nb = 256, 64
        a = _spd(n, 14).astype(np.float32).astype(np.float64)  # hi holds all of A
        ap64 = TPK.pack_tri(torch.from_numpy(a), nb)
        keep = ap64.clone()
        lph, lpl = TP.potrf_packed_df64(ap64, torch.zeros_like(ap64), n, nb, ktb=64)
        assert lph.dtype == torch.float32 and torch.equal(ap64, keep)
        l = _dense64(lph, lpl, n, nb)
        assert np.abs(a - l @ l.T).sum(1).max() / np.abs(a).sum(1).max() < 1e-11

    def test_rejects_bad_tiles(self):
        z = torch.zeros(640, 128)
        with pytest.raises(ValueError, match="ktb"):
            TP.potrf_packed_df64(z, z, 512, 128, ktb=96)
        with pytest.raises(ValueError, match="multiple"):
            TP.potrf_packed_df64(z, z, 500, 128)


class TestSolves:
    def _gate(self, a, b, xh, xl):
        x = TD.from_df64(xh, xl).numpy()
        return x, np.abs(b - a @ x).max() / (np.abs(a).max() * np.abs(x).max())

    @pytest.mark.parametrize("trans", [False, True])
    def test_trmm_packed_df64(self, trans):
        n, nb, p = 384, 128, 3
        rng = np.random.default_rng(5)
        lt = np.tril(rng.standard_normal((n, n)))
        x = rng.standard_normal((n, p))
        lh, ll = JD.to_df64(lt)
        xh, xl = JD.to_df64(x)
        ref = JP.trmm_packed_df64(JPK.pack_tri(lh, nb), JPK.pack_tri(ll, nb), xh, xl, n, nb,
                                  trans=trans)
        got = TP.trmm_packed_df64(TPK.pack_tri(_t(lh), nb), TPK.pack_tri(_t(ll), nb), _t(xh),
                                  _t(xl), n, nb, trans=trans)
        assert _same_bits(ref, got)  # k ≤ 1024: every pass exact, the same roundings
        want = (lt.T if trans else lt) @ x
        assert np.abs(TD.from_df64(*got).numpy() - want).max() < 1e-13 * np.abs(want).max()

    @pytest.mark.parametrize("engine", ["trmm", "matvec"])
    def test_potrs_packed_df64(self, engine):
        n, nb = 512, 128
        a, jlph, jlpl = _jax_factor(n, nb, 128)
        b = np.random.default_rng(6).standard_normal((n, 4))
        bh, bl = JD.to_df64(b)
        xj = JP.potrs_packed_df64(jnp.asarray(jlph), jnp.asarray(jlpl), bh, bl, n, nb,
                                  engine=engine)
        x, res = self._gate(a, b, *TP.potrs_packed_df64(_t(jlph), _t(jlpl), _t(bh), _t(bl), n, nb,
                                                        engine=engine))
        assert res < 1e-12  # the reference's 1e-10 posv gate, with margin
        xj64 = np.asarray(xj[0], np.float64) + np.asarray(xj[1], np.float64)
        assert np.abs(x - xj64).max() <= 1e-12 * np.abs(xj64).max()

    def test_potrs_df64(self):
        n, nb = 512, 128
        a, jlph, jlpl = _jax_factor(n, nb, 128)
        b = np.random.default_rng(7).standard_normal((n, 4))
        lh, ll = JPK.unpack_tri(jnp.asarray(jlph), n, nb), JPK.unpack_tri(jnp.asarray(jlpl), n, nb)
        bh, bl = JD.to_df64(b)
        xj = JP.potrs_df64(lh, ll, bh, bl)
        x, res = self._gate(a, b, *TP.potrs_df64(_t(lh), _t(ll), _t(bh), _t(bl)))
        assert res < 1e-12
        xj64 = np.asarray(xj[0], np.float64) + np.asarray(xj[1], np.float64)
        assert np.abs(x - xj64).max() <= 1e-12 * np.abs(xj64).max()

    @pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 2e-5)])
    @pytest.mark.parametrize("vec", [False, True])
    def test_potrs_packed(self, dtype, tol, vec):
        n, nb = 384, 128
        a = _spd(n, 8)
        l = scipy.linalg.cholesky(a, lower=True).astype(dtype)
        b = np.random.default_rng(8).standard_normal(n if vec else (n, 3)).astype(dtype)
        ref = np.asarray(JPK.potrs_packed(JPK.pack_tri(jnp.asarray(l), nb), jnp.asarray(b), n, nb))
        tb_ = _t(b)
        got = TPK.potrs_packed(TPK.pack_tri(_t(l), nb), tb_, n, nb)
        assert got.shape == b.shape and torch.equal(tb_, _t(b))  # b is left alone
        want = scipy.linalg.cho_solve((l.astype(np.float64), True), b.astype(np.float64))
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - ref).max() <= tol * scale
        assert np.abs(got.numpy() - want).max() <= tol * scale

    def test_diag_invs_are_ieee_fp32_and_read_the_lower_triangle(self):
        n, nb = 256, 64
        l = scipy.linalg.cholesky(_spd(n, 9), lower=True).astype(np.float32)
        lp = TPK.pack_tri(_t(l), nb)
        ref = JPK._diag_invs(JPK.pack_tri(jnp.asarray(l), nb), n, nb)
        got = TPK._diag_invs(lp, n, nb)
        for k, (r, g) in enumerate(zip(ref, got, strict=True)):
            blk = l[k * nb : (k + 1) * nb, k * nb : (k + 1) * nb].astype(np.float64)
            inv = np.linalg.inv(blk)
            # fp32-grade against fp64 (a bf16-pass inverse would sit near 4e-3) and against JAX
            assert np.abs(g.numpy() - inv).max() <= 1e-5 * np.abs(inv).max()
            assert np.abs(g.numpy() - np.asarray(r)).max() <= 1e-5 * np.abs(inv).max()
        with precision.override("default"):  # the one-bf16-pass tier does not reach them
            low = TPK._diag_invs(lp, n, nb)
        assert all(torch.equal(a, b) for a, b in zip(got, low, strict=True))
        up = torch.triu(torch.ones(nb, nb, dtype=torch.bool), 1)
        for k in range(n // nb):
            TPK.col_slab(lp, k, n, nb)[:nb][up] = float("nan")
        assert all(torch.equal(a, b) for a, b in zip(got, TPK._diag_invs(lp, n, nb), strict=True))

    @pytest.mark.parametrize("trans", [False, True])
    @pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 2e-5),
                                           (np.complex128, 1e-12)])
    def test_solve_lower_blocked(self, dtype, tol, trans):
        n = 320  # ib = 128: a ragged last block
        rng = np.random.default_rng(10)
        l = np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
        b = rng.standard_normal((n, 3))
        if dtype == np.complex128:
            l = l + 1j * np.tril(rng.standard_normal((n, n)), -1)
            b = b + 1j * rng.standard_normal((n, 3))
        l, b = l.astype(dtype), b.astype(dtype)
        ref = np.asarray(JS._solve_lower_blocked(jnp.asarray(l), jnp.asarray(b), trans=trans,
                                                 ib=128))
        dirty = l + np.triu(np.full((n, n), 7.0), 1).astype(dtype)  # above the diagonal: unread
        got = TS._solve_lower_blocked(_t(dirty), _t(b), trans=trans, ib=128).numpy()
        want = scipy.linalg.solve_triangular(l.astype(np.complex128 if dtype == np.complex128
                                                      else np.float64), b, lower=True,
                                             trans="C" if trans else "N")
        scale = np.abs(want).max()
        assert np.abs(got - ref).max() <= tol * scale
        assert np.abs(got - want).max() <= tol * scale


GATE_RTOL = 1e-5  # on one factor the packages differ in the order of the fp32 |A| row sums


class TestFreivaldsGates:
    """The three streaming gates on one factor of the seeded matrix, good and
    corrupted, against JAX's values (the same numpy probes)."""

    n, nb = 512, 128

    @pytest.fixture(scope="class")
    def factor(self):
        n, nb = self.n, self.nb
        aph = TPK.plgsy_packed(n, nb, seed=51, device="cpu")
        lph, lpl = TP.potrf_packed_df64(aph, torch.zeros_like(aph), n, nb, ktb=64)
        bad = lph.clone()
        bad[5, 3] += 1e-4
        return {"good": (lph, lpl), "bad": (bad, lpl)}

    @pytest.mark.parametrize("which", ["good", "bad"])
    def test_packed_gate_matches_jax(self, factor, which):
        n, nb = self.n, self.nb
        lph, lpl = factor[which]
        got = TP.freivalds_packed_df64(lph, lpl, n, nb, row_chunk=128)
        ref = float(JP.freivalds_packed_df64(jnp.asarray(to_numpy(lph)), jnp.asarray(to_numpy(lpl)),
                                             n, nb, row_chunk=128))
        assert abs(got - ref) <= GATE_RTOL * ref
        assert got < 1e-11 if which == "good" else got > 1e-9

    @pytest.mark.parametrize("which", ["good", "bad"])
    @pytest.mark.parametrize("lo", ["none", "zeros"])
    def test_dense_gate_matches_jax(self, factor, which, lo):
        import dla_tpu_torch as T

        n, nb = self.n, self.nb
        lh, ll = (TPK.unpack_tri(x, n, nb) for x in factor[which])
        a32 = T.plgsy(n, seed=51, device="cpu")
        al = None if lo == "none" else torch.zeros_like(a32)
        got = float(TP.freivalds_potrf_df64(lh, ll, a32, al, row_chunk=128))
        ja = jnp.asarray(to_numpy(a32))
        jl = (jnp.asarray(to_numpy(lh)), jnp.asarray(to_numpy(ll)))
        ref = float(JP.freivalds_potrf_df64(*jl, ja, None if al is None else jnp.zeros_like(ja),
                                            row_chunk=128))
        assert abs(got - ref) <= GATE_RTOL * ref
        assert got < 1e-11 if which == "good" else got > 1e-9

    @pytest.mark.parametrize("which", ["good", "bad"])
    def test_gen_gate_matches_jax_and_the_resident_gate(self, factor, which):
        import dla_tpu_torch as T

        n, nb = self.n, self.nb
        lh, ll = (TPK.unpack_tri(x, n, nb) for x in factor[which])
        got = TP.freivalds_potrf_df64_gen(lh, ll, row_chunk=128)
        jl = (jnp.asarray(to_numpy(lh)), jnp.asarray(to_numpy(ll)))
        ref = float(JP.freivalds_potrf_df64_gen(*jl, row_chunk=128))
        assert abs(got - ref) <= GATE_RTOL * ref
        res = float(TP.freivalds_potrf_df64(lh, ll, T.plgsy(n, seed=51, device="cpu"), None,
                                            row_chunk=128))
        assert abs(got - res) <= GATE_RTOL * res  # the same probes, A streamed or resident

    def test_packed_matvec_masks_garbage_above_the_diagonal(self, factor):
        n, nb = self.n, self.nb
        lph, lpl = (x.clone() for x in factor["good"])
        clean = TP.freivalds_packed_df64(lph, lpl, n, nb, row_chunk=128)
        up = torch.triu(torch.ones(nb, nb, dtype=torch.bool), 1)
        for j in range(n // nb):
            TPK.col_slab(lph, j, n, nb)[:nb][up] = 123.0
            TPK.col_slab(lpl, j, n, nb)[:nb][up] = -7.0
        assert TP.freivalds_packed_df64(lph, lpl, n, nb, row_chunk=128) == clean

    def test_tile_desc_matches_jax(self):
        assert np.array_equal(TP._packed_tile_desc(512, 128), JP._packed_tile_desc(512, 128))

    def test_argument_errors(self):
        z = torch.zeros(640, 128)
        with pytest.raises(ValueError, match="multiple of nb"):
            TP.freivalds_packed_df64(z, z, 500, 128)
        with pytest.raises(ValueError, match="row_chunk"):
            TP.freivalds_packed_df64(z, z, 512, 128, row_chunk=96)
        with pytest.raises(ValueError, match="row_chunk"):
            TP.freivalds_potrf_df64_gen(torch.zeros(512, 512), torch.zeros(512, 512), row_chunk=96)
