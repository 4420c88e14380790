"""dla_tpu_torch's CUDA kernels and the paths that run them on the card, held
against the plain torch versions. Every test needs a CUDA device and skips
without one.

This file imports no jax, so that it runs where JAX is not installed; run it
there past tests/conftest.py (which imports jax):

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances, relative to ``scale = max_i ||p_i||²`` (= max |P·Pᵀ|): fp64
1e-12; fp32 at every tier 1e-5 (the same partial products, summed in another
order); bf16 storage 2^-6 of (max|c| + scale) (two bf16 roundings, each
possibly one ulp apart).

The trailing kernels run fp32 ``high``/``default`` and bf16 storage through
the tensor-core body (``csrc/trailing_wgmma.cuh``), fp32 ``highest`` through
the SIMT body and fp64 through the DMMA body (``csrc/trailing_chain.cuh``);
the cases below meet the tensor-core body's edges (w not a multiple of its
128-row tile, tb below or not dividing 128, nb not a multiple of its
64-column k-step, a strided panel, many k-steps), and the kernels a profiler
sees show which body ran. The two chain bodies must give, bit for bit, what
the task kernels' scalar body (``tile_kernel`` on ``nt_block``, the same fma
chain per element, through the test-only entry ``tiles.tile_op_reference``)
gives on the same tiles, at tb 32 and 96, nb 7, windows off 128, P views
aligned or not, packed steps across slabs and 20 launches back to back; one
fp64 tensor-core instruction of each shape must round as an exact chain of
fmas; ptxas must show no spill. The task kernels #6 ``trsm_tile``, #7
``syrk_tile`` and #8 ``gemm_tile`` run the same tensor-core pipeline with two
operands (syrk: A's planes alone) at fp32 ``high``/``default`` and bf16
storage, and the same two chain bodies at fp32 ``highest`` and fp64 (syrk on
its lower tiles only, copy blocks above); their split scratch, body counts,
views, short k, refusals, syrk's upper triangle (C's bits) and, on the chain
bodies, the scalar body's bits at both tile edges are tested below.
The panel solve #3 ``panel_apply`` runs a chain of those products (the
tensor-core body at fp32 ``high``/``default``, the ``simt`` chain at
``highest``) and the panel factor #4 ``panel_factor`` one (the same table,
``dmma`` for fp64), each with its own count of calls per body; on the chain
bodies both give, product by product, the scalar body's bits.
"""

import numpy as np
import pytest
import torch

import dla_tpu_torch as T
import dla_tpu_torch.algos as TA
from dla_tpu_torch.kernels import tiles
from dla_tpu_torch.algos import packed as P
from dla_tpu_torch.kernels.tiles import (
    trailing_update_lower,
    trailing_update_lower_plain,
    trailing_update_packed,
    trailing_update_packed_plain,
)
from dla_tpu_torch.utils import precision

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _lower_mask(m, tb, origin):
    ti = torch.arange(m) // tb
    return (ti[:, None] >= ti[None, :]) & (ti[:, None] >= origin) & (ti[None, :] >= origin)


def _tol(dtype, c, p):
    scale = (p.double() ** 2).sum(1).max().item()
    if dtype == torch.float64:
        return 1e-12 * scale
    if dtype == torch.float32:
        return 1e-5 * scale
    return 2**-6 * (c.double().abs().max().item() + scale)


CASES = [  # (m, tb, nb, origin, dtype, precision)
    (96, 32, 32, 0, torch.float32, "high"),
    (96, 32, 32, 1, torch.float32, "highest"),
    (256, 64, 48, 2, torch.float32, "default"),
    (200, 40, 24, 1, torch.float64, "high"),
    (256, 128, 64, 1, torch.bfloat16, "high"),
    (1024, 256, 256, 1, torch.float32, "high"),
    (160, 32, 7, 1, torch.float32, "high"),  # k not a multiple of the kernel's k-step
    # the tensor-core body's edges: w off its 128-row tile, tb 32/40/96, nb off 64
    (200, 40, 100, 1, torch.float32, "high"),
    (288, 96, 7, 1, torch.float32, "default"),
    (320, 32, 130, 2, torch.float32, "high"),
    (480, 96, 72, 2, torch.bfloat16, "high"),
    (1120, 40, 200, 3, torch.float32, "default"),
    # many k-steps (16 stages, 4 promotions), and k = 4096 (16 promotions)
    (2048, 1024, 1024, 0, torch.float32, "high"),
    (2048, 1024, 1024, 0, torch.float32, "default"),
    (2048, 1024, 1024, 1, torch.float32, "high"),
    (2112, 1056, 4096, 0, torch.float32, "default"),
]


@pytest.mark.parametrize("m,tb,nb,origin,dtype,prec", CASES)
def test_kernel_matches_plain(cuda, m, tb, nb, origin, dtype, prec):
    g = torch.Generator().manual_seed(m + nb)
    c = torch.randn(m, m, generator=g, dtype=torch.float64).to(dtype)
    p = torch.randn(m - origin * tb, nb, generator=g, dtype=torch.float64).to(dtype)
    with precision.override(prec):
        ref = trailing_update_lower_plain(c.clone(), p, tb=tb, origin=origin)
        cd = c.to(cuda)
        before = tiles.launches
        out = trailing_update_lower(cd, p.to(cuda), tb=tb, origin=origin)
        torch.cuda.synchronize()
    assert out is cd and tiles.launches == before + 1
    got = out.cpu()
    mask = _lower_mask(m, tb, origin)
    assert (got.double() - ref.double()).abs()[mask].max().item() <= _tol(dtype, c, p)
    assert torch.equal(got[~mask], c[~mask])


def test_alias_false_leaves_input(cuda):
    c = torch.randn(128, 128, device=cuda)
    p = torch.randn(128, 32, device=cuda)
    keep = c.clone()
    out = trailing_update_lower(c, p, tb=32, alias=False)
    torch.cuda.synchronize()
    assert torch.equal(c, keep) and not torch.equal(out, keep)


def test_strided_panel_view(cuda):
    c = torch.randn(128, 128, device=cuda, dtype=torch.float64)
    big = torch.randn(128, 64, device=cuda, dtype=torch.float64)
    p = big[:, 16:48]  # leading dimension 64, not 32
    ref = trailing_update_lower_plain(c.cpu(), p.cpu(), tb=32)
    out = trailing_update_lower(c, p, tb=32)
    assert torch.allclose(out.cpu(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype,prec", [(torch.float32, "high"), (torch.float32, "default"),
                                        (torch.bfloat16, "high")])
def test_strided_panel_view_tensor_cores(cuda, dtype, prec):
    g = torch.Generator().manual_seed(17)
    c = torch.randn(200, 200, generator=g).to(dtype)
    big = torch.randn(160, 130, generator=g).to(dtype)
    p, pd = big[:, 9:109], big.to(cuda)[:, 9:109]  # ldp 130, nb 100
    assert pd.stride(0) == 130
    with precision.override(prec):
        ref = trailing_update_lower_plain(c.clone(), p, tb=40, origin=1)
        out = trailing_update_lower(c.to(cuda), pd, tb=40, origin=1).cpu()
    mask = _lower_mask(200, 40, 1)
    assert (out.double() - ref.double()).abs()[mask].max().item() <= _tol(dtype, c, p)
    assert torch.equal(out[~mask], c[~mask])


def _kernel_names(fn):
    """The CUDA kernels that ``fn`` launches, as the profiler names them; a
    trace with no trailing kernel at all (the profiler now and then drops a
    session's device records) is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()]
        if any(b in k for k in names for b in ("trailing_tc_kernel", "trailing_simt_kernel",
                                               "trailing_dmma_kernel")):
            break
    return names


@pytest.mark.parametrize("dtype,prec", [(torch.float32, "high"), (torch.float32, "default"),
                                        (torch.bfloat16, "high"), (torch.bfloat16, "highest"),
                                        (torch.float32, "highest"), (torch.float64, "high")])
@pytest.mark.parametrize("kind", ["lower", "packed"])
def test_body_that_ran(cuda, kind, dtype, prec):
    # fp32 high/default and bf16 run the tensor-core kernel, fp32 highest the
    # SIMT chain, fp64 the DMMA chain, each the one body its tier names
    n, w = 384, 128
    p = torch.randn(n - w, w, device=cuda).to(dtype)
    if kind == "lower":
        c = torch.randn(n - w, n - w, device=cuda).to(dtype)
        call = lambda: trailing_update_lower(c, p, tb=64)  # noqa: E731
    else:
        c = torch.randn(P.packed_rows(n, w), w, device=cuda).to(dtype)
        call = lambda: trailing_update_packed(c, p, n=n, w=w, k=0, tb=64)  # noqa: E731
    with precision.override(prec):
        want = tiles.trailing_body(dtype, prec)
        before = tiles.body_launches()
        names = _kernel_names(call)
        after = tiles.body_launches()
    assert [b for b in after if after[b] != before[b]] == [want]
    ran = {b for b, kernel in (("wgmma", "trailing_tc_kernel"), ("simt", "trailing_simt_kernel"),
                               ("dmma", "trailing_dmma_kernel")) if any(kernel in k for k in names)}
    assert ran == {want}, names
    assert not any("trailing_kernel<" in k for k in names), names  # the old scalar body is gone
    assert any("split_kernel" in k for k in names) == (want == "wgmma")


@pytest.mark.parametrize("dtype,prec,planes", [(torch.float32, "high", 2),
                                               (torch.float32, "default", 1),
                                               (torch.bfloat16, "high", 1)])
@pytest.mark.parametrize("w,nb,ld", [(200, 100, 100), (200, 100, 130), (96, 7, 7)])
def test_split_kernel_bits_of_split_plain(cuda, dtype, prec, planes, w, nb, ld):
    # the planes the split kernel writes (padding included) are split_plain's
    # bits, over magnitudes from subnormal to 1e3 and a leading dimension ld
    g = torch.Generator().manual_seed(w + nb + ld)
    big = (torch.randn(w, ld, generator=g) * torch.logspace(-40, 3, ld)).to(dtype)
    p = big[:, :nb]
    pd = big.to(cuda)[:, :nb]
    scratch = torch.full(tiles._split_shape(pd, planes), float("nan"), device=cuda,
                         dtype=torch.bfloat16)
    c = torch.zeros(w, w, device=cuda, dtype=dtype)
    with precision.override(prec):
        err = tiles._kernel("lower", dtype)(
            c.data_ptr(), pd.data_ptr(), scratch.data_ptr(), w, nb, w, ld, 0, w,
            scratch.numel() * 2, tiles._TIER_CODE[prec], torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(scratch.cpu().view(torch.int16),
                       tiles.split_plain(p, planes).view(torch.int16))


@pytest.mark.parametrize("dtype,prec", [(torch.float32, "high"), (torch.float32, "default"),
                                        (torch.bfloat16, "high"), (torch.float32, "highest")])
def test_two_launches_same_bits(cuda, dtype, prec):
    g = torch.Generator(device=cuda).manual_seed(5)
    c = torch.randn(1000, 1000, generator=g, device=cuda).to(dtype)
    p = torch.randn(1000, 300, generator=g, device=cuda).to(dtype)
    n, w = 1024, 256
    pk = torch.randn(P.packed_rows(n, w), w, generator=g, device=cuda).to(dtype)
    pp = torch.randn(n - w, w, generator=g, device=cuda).to(dtype)
    with precision.override(prec):
        a = trailing_update_lower(c.clone(), p, tb=200)
        b = trailing_update_lower(c.clone(), p, tb=200)
        pa = trailing_update_packed(pk.clone(), pp, n=n, w=w, k=0, tb=128)
        pb = trailing_update_packed(pk.clone(), pp, n=n, w=w, k=0, tb=128)
    torch.cuda.synchronize()
    assert torch.equal(a.view(-1).view(torch.int16), b.view(-1).view(torch.int16))
    assert torch.equal(pa.view(-1).view(torch.int16), pb.view(-1).view(torch.int16))


@pytest.mark.parametrize("kind", ["lower", "packed"])
def test_refused_launch_raises(cuda, monkeypatch, kind):
    # scratch too small for the split planes: the C entry refuses the launch
    # (cudaErrorInvalidValue) and the wrapper raises; nothing falls back to the scalar body
    real = tiles._split_scratch
    monkeypatch.setattr(tiles, "_split_scratch", lambda p, planes: real(p, planes)[:, :-1])
    n, w = 384, 128
    p = torch.randn(n - w, w, device=cuda)
    c = torch.randn(n - w, n - w, device=cuda) if kind == "lower" else torch.randn(
        P.packed_rows(n, w), w, device=cuda)
    keep = c.clone()
    before = (tiles.launches, tiles.packed_launches)
    with precision.override("high"), pytest.raises(RuntimeError, match="CUDA error 1"):
        if kind == "lower":
            trailing_update_lower(c, p, tb=64)
        else:
            trailing_update_packed(c, p, n=n, w=w, k=0, tb=64)
    torch.cuda.synchronize()
    assert (tiles.launches, tiles.packed_launches) == before
    assert torch.equal(c, keep)


# ---- the FMA-chain bodies: fp32 highest (SIMT) and fp64 (DMMA) ------------------------

CHAIN_TIERS = [(torch.float32, "highest"), (torch.float64, "high")]


def _chain_bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _chain_ref_lower(c, p, tb, origin):
    """The lower update built tile column by tile column from the task
    kernels' scalar body (tile_kernel on nt_block: the same fma chain per
    element), through the test-only reference entry."""
    out, o, w = c.clone(), origin * tb, p.shape[0]
    for j0 in range(0, w, tb):
        cols = slice(o + j0, o + j0 + tb)
        out[o + j0:, cols] = tiles.tile_op_reference("gemm", c[o + j0:, cols], p[j0:],
                                                     p[j0:j0 + tb])
    return out


def _chain_ref_packed(c, p, n, w, tb, k):
    """The packed update of step k built the same way, one tile column of the
    window (inside one slab) at a time."""
    out, base, m = c.clone(), (k + 1) * w, p.shape[0]
    for c0 in range(0, m, tb):
        j, cs = divmod(base + c0, w)
        r0 = P._row_offset(j, n // w, w) + cs
        blk = (slice(r0, r0 + m - c0), slice(cs, cs + tb))
        out[blk] = tiles.tile_op_reference("gemm", c[blk], p[c0:], p[c0:c0 + tb])
    return out


CHAIN_LOWER = [  # (m, tb, nb, origin, ld of P): tb 32/96, nb 7 (rows not 16-byte
    # aligned), w off 128, P views that are aligned (ld 132) or not (ld 131, offset 1)
    (96, 32, 7, 1, 7), (288, 96, 40, 1, 40), (480, 32, 50, 3, 131), (640, 128, 200, 1, 200),
    (384, 96, 64, 0, 132), (1000, 200, 33, 2, 33), (2048, 1024, 1024, 0, 1024),
    (2048, 1024, 1024, 1, 1024),
]


@pytest.mark.parametrize("dtype,prec", CHAIN_TIERS)
@pytest.mark.parametrize("m,tb,nb,origin,ld", CHAIN_LOWER)
def test_chain_lower_same_bits_as_gemm_tile(cuda, m, tb, nb, origin, ld, dtype, prec):
    g = torch.Generator(device=cuda).manual_seed(m + nb + ld)
    c = torch.randn(m, m, generator=g, device=cuda, dtype=dtype)
    big = torch.randn(m - origin * tb, ld, generator=g, device=cuda, dtype=dtype)
    p = big[:, 1:nb + 1] if ld != nb and ld % 4 else big[:, :nb]  # ld 131: off 16 bytes
    assert p.stride(0) == ld
    with precision.override(prec):
        ref = _chain_ref_lower(c, p, tb, origin)
        before = tiles.body_launches()
        out = trailing_update_lower(c.clone(), p, tb=tb, origin=origin)
        after = tiles.body_launches()
    torch.cuda.synchronize()
    assert after[tiles.trailing_body(dtype, prec)] == before[tiles.trailing_body(dtype, prec)] + 1
    assert torch.equal(_chain_bits(out), _chain_bits(ref))


CHAIN_PACKED = [  # (n, w, ktb, k): slabs of 96 and 160 straddled by 128-row tiles, k > 0
    (384, 96, 32, 0), (384, 96, 32, 1), (640, 160, 40, 1), (576, 192, 96, 1),
    (2048, 512, 256, 1), (4096, 1024, 512, 0), (4096, 1024, 1024, 2),
]


@pytest.mark.parametrize("dtype,prec", CHAIN_TIERS)
@pytest.mark.parametrize("n,w,ktb,k", CHAIN_PACKED)
def test_chain_packed_same_bits_as_gemm_tile(cuda, n, w, ktb, k, dtype, prec):
    g = torch.Generator(device=cuda).manual_seed(n + w + k)
    c = torch.randn(P.packed_rows(n, w), w, generator=g, device=cuda, dtype=dtype)
    p = torch.randn(n - (k + 1) * w, w, generator=g, device=cuda, dtype=dtype)
    with precision.override(prec):
        ref = _chain_ref_packed(c, p, n, w, ktb, k)
        out = trailing_update_packed(c.clone(), p, n=n, w=w, k=k, tb=ktb)
    torch.cuda.synchronize()
    assert torch.equal(_chain_bits(out), _chain_bits(ref))
    assert torch.equal(_chain_bits(out[~_packed_visited(n, w, ktb, k).to(cuda)]),
                       _chain_bits(c[~_packed_visited(n, w, ktb, k).to(cuda)]))


@pytest.mark.parametrize("dtype,prec", CHAIN_TIERS)
def test_chain_20_launches_back_to_back(cuda, dtype, prec):
    # 20 queued updates of one matrix (origins 0..3, four panels), as a
    # factorization queues them, against the same steps through gemm_tile
    m, tb, nb = 768, 128, 96
    g = torch.Generator(device=cuda).manual_seed(20)
    c = torch.randn(m, m, generator=g, device=cuda, dtype=dtype)
    panels = [torch.randn(m - (t % 4) * tb, nb, generator=g, device=cuda, dtype=dtype)
              for t in range(4)]
    with precision.override(prec):
        out = c.clone()
        before = tiles.launches
        for t in range(20):
            trailing_update_lower(out, panels[t % 4], tb=tb, origin=t % 4)
        torch.cuda.synchronize()
        assert tiles.launches == before + 20
        ref = c.clone()
        for t in range(20):
            ref = _chain_ref_lower(ref, panels[t % 4], tb, t % 4)
    assert torch.equal(_chain_bits(out), _chain_bits(ref))


def _fma(a, b, c):
    """fma(a, b, c) rounded once, to nearest even, from the exact value."""
    from fractions import Fraction

    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _probe_inputs(rows, k, seed):
    """Operands on which a chain of rounded fmas, the same chain in the other
    order and a once-rounded sum of the k terms give different doubles: wide
    exponents, and crafted rows (1 then half-ulp terms; the same reversed; a
    product that only an fma keeps whole)."""
    rng = np.random.default_rng(seed)

    def wide(shape):
        sign = rng.choice([-1.0, 1.0], shape)
        return sign * np.ldexp(1.0 + rng.random(shape), rng.integers(-26, 27, shape))

    a, b, c = wide((rows, k)), wide((8, k)), wide((rows, 8))
    half = 2.0**-53
    b[0] = 1.0
    a[0] = [1.0] + [half] * (k - 1)
    a[1] = [half] * (k - 1) + [1.0]
    c[0, 0] = c[1, 0] = half / 4
    b[1, 0], a[2] = 1 + 2.0**-30, [1 + 2.0**-30] + [0.0] * (k - 1)
    c[2, 1] = -1.0
    return a, b, c


def _chains(a, b, c):
    """Per output: the ascending chain, the descending chain, the once-rounded sum."""
    from fractions import Fraction

    rows, k = a.shape
    asc, desc, once = (np.empty((rows, 8)) for _ in range(3))
    for r in range(rows):
        for j in range(8):
            x = c[r, j]
            for t in range(k):
                x = _fma(a[r, t], b[j, t], x)
            asc[r, j] = x
            x = c[r, j]
            for t in reversed(range(k)):
                x = _fma(a[r, t], b[j, t], x)
            desc[r, j] = x
            once[r, j] = float(sum((Fraction(a[r, t]) * Fraction(b[j, t]) for t in range(k)),
                                   Fraction(c[r, j])))
    return asc, desc, once


@pytest.mark.parametrize("shape", [0, 4, 8, 16])
def test_dmma_rounds_as_an_fma_chain(cuda, shape):
    # one fp64 tensor-core instruction (m8n8k4, m16n8k4, k8, k16) on inputs
    # where the chain, the reversed chain and a once-rounded sum all differ:
    # it gives the ascending chain's doubles, the sum the DMMA body relies on
    # for nt_block's bits
    import ctypes

    from dla_tpu_torch.kernels import _build

    rows, k = (8, 4) if shape == 0 else (16, shape)
    a, b, c = _probe_inputs(rows, k, seed=shape)
    asc, desc, once = _chains(a, b, c)
    assert (asc != once).sum() >= 4 and (asc != desc).sum() >= 4  # the inputs tell them apart
    dev = [torch.from_numpy(x).to(cuda) for x in (a, b, c)]
    d = torch.full((rows, 8), float("nan"), dtype=torch.float64, device=cuda)
    fn = _build.load().dla_dmma_probe
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*(x.data_ptr() for x in dev), d.data_ptr(), shape,
             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    got = d.cpu().numpy()
    print(f"shape {shape}: chain {int((got == asc).sum())}/{asc.size}, once-rounded "
          f"{int((got == once).sum())}, reversed chain {int((got == desc).sum())}")
    np.testing.assert_array_equal(got, asc)


def test_chain_bodies_registers_no_spill(cuda):
    # ptxas's registers and spills for the SIMT and DMMA bodies of both trailing kernels
    # and of the task kernels (tile_simt_kernel, tile_dmma_kernel), and for the task
    # kernels' tensor-core body (tile_tc_kernel), syrk's instantiations included
    import re
    import subprocess
    import tempfile

    from dla_tpu_torch.kernels import _build

    for src in ("trailing_lower.cu", "trailing_packed.cu", "tile_ops.cu"):
        with tempfile.TemporaryDirectory() as tmp:
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                   f"{tmp}/k.o", str(_build.CSRC / src)]
            log = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
        kernel, seen = None, {}
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif kernel and any(f"{kind}_{b}_kernel" in kernel for kind in ("trailing", "tile")
                                for b in ("simt", "dmma", "tc")):
                body = ("simt" if "simt_kernel" in kernel else "dmma" if "dmma_kernel" in kernel
                        else "tc")
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                regs = re.search(r"Used (\d+) registers", line)
                if spill:
                    seen.setdefault(body, []).append(("spill", int(spill[1]) + int(spill[2])))
                if regs:
                    seen.setdefault(body, []).append(("registers", int(regs[1])))
        print(f"{src}: {seen}")
        for body in ("simt", "dmma") + (("tc",) if src == "tile_ops.cu" else ()):
            spills = [v for key, v in seen.get(body, []) if key == "spill"]
            regs = [v for key, v in seen.get(body, []) if key == "registers"]
            # per trailing source two instantiations each (aligned or not); tile_ops.cu
            # simt twelve (two tile edges x aligned or not x trsm, syrk and gemm), dmma six
            # (64-tiles, aligned or not, three ops), tc nine (three ops x fp32 high, fp32
            # default and bf16)
            assert spills and all(v == 0 for v in spills), (src, body, seen)
            assert regs and all(0 < v <= 255 for v in regs), (src, body, seen)


def test_column_major_input_raises(cuda):
    c = torch.randn(64, 64, device=cuda).mT
    with pytest.raises(ValueError, match="row-major"):
        trailing_update_lower(c, torch.randn(64, 16, device=cuda), tb=32)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_potrf_inplace_card_matches_cpu(cuda, dtype):
    n = 512
    kw = dict(nb=128, tb=64, kb=128, ib=64, precision="high")
    a = T.plgsy(n, seed=3, dtype=dtype, device="cpu")
    before = tiles.launches
    lg = torch.tril(TA.potrf_inplace(a.to(cuda), **kw)).cpu()
    assert tiles.launches == before + n // 128 - 1
    lc = torch.tril(TA.potrf_inplace(a.clone(), **kw))
    tol = 1e-10 if dtype == torch.float64 else 1e-5 * lc.abs().max().item()
    assert (lg - lc).abs().max().item() <= tol
    gate = 1e-10 if dtype == torch.float64 else n * 2e-7
    assert float(T.residual_potrf(a.to(cuda), lg.to(cuda))) < gate


def test_offsets_past_2_pow_31(cuda):
    # m² > 2³¹ from m = 46341: the window's last tile sits past 32-bit offsets
    m, tb, nb = 47104, 1024, 64
    origin = m // tb - 1
    c = torch.zeros(m, m, device=cuda)
    p = torch.randn(tb, nb, device=cuda)
    trailing_update_lower(c, p, tb=tb, origin=origin)
    torch.cuda.synchronize()
    o = origin * tb
    ref = trailing_update_lower_plain(torch.zeros(tb, tb), p.cpu(), tb=tb)
    assert (c[o:, o:].cpu() - ref).abs().max().item() <= _tol(torch.float32, c, p)
    assert c[:o].abs().max().item() == 0 and c[o:, :o].abs().max().item() == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plgsy_same_bits_on_card(cuda, dtype):
    for i0, j0 in [(0, 0), (131072, 17)]:
        got = T.plgsy_tile(51, i0, j0, 96, 80, bump=5.0, dtype=dtype, device=cuda).cpu()
        assert torch.equal(got, T.plgsy_tile(51, i0, j0, 96, 80, bump=5.0, dtype=dtype,
                                                 device="cpu"))
    assert torch.equal(T.plgsy(300, seed=7, device=cuda).cpu(), T.plgsy(300, seed=7, device="cpu"))


def test_card_factor_reads_lower_only_and_nans_non_spd(cuda):
    n, kw = 256, dict(nb=64, tb=32, ib=32)
    a = T.plgsy(n, seed=5, dtype=torch.float64, device=cuda)
    clean = torch.tril(TA.potrf_inplace(a.clone(), **kw))
    dirty = torch.tril(a) + torch.triu(torch.full_like(a, 123.0), 1)
    assert torch.equal(torch.tril(TA.potrf_inplace(dirty, **kw)), clean)
    bad = a.clone()
    bad[70, 70] = -5.0
    lb = torch.tril(TA.potrf_inplace(bad, **kw)).cpu()
    assert torch.isnan(lb[64:]).any() and not torch.isnan(lb[:64, :64]).any()


def _packed_visited(n, w, ktb, k):
    """True on the packed elements the step-k update must touch."""
    nt, base = n // w, (k + 1) * w
    parts = []
    for j in range(nt):
        r = torch.arange(j * w, n) - base
        c = torch.arange(j * w, (j + 1) * w) - base
        parts.append((r[:, None] >= 0) & (c[None, :] >= 0)
                     & (r.clamp(min=0)[:, None] // ktb >= c.clamp(min=0)[None, :] // ktb))
    return torch.cat(parts)


PACKED_CASES = [  # (n, w, ktb, k, dtype, precision)
    (384, 96, 32, 0, torch.float32, "high"),  # w not a multiple of 64: blocks straddle slabs
    (384, 96, 32, 1, torch.float32, "highest"),
    (640, 160, 40, 1, torch.float32, "default"),
    (768, 256, 128, 0, torch.float64, "high"),
    (512, 128, 64, 1, torch.bfloat16, "high"),
    (2048, 512, 256, 1, torch.float32, "high"),
    (200, 40, 8, 2, torch.float64, "high"),
    # the tensor-core body's edges: w off 128 and 64, tb 32/40/96, k > 0
    (600, 200, 40, 1, torch.float32, "high"),
    (640, 160, 32, 2, torch.float32, "default"),
    (576, 192, 96, 1, torch.bfloat16, "high"),
    # many k-steps (16 stages, 4 promotions)
    (4096, 1024, 512, 0, torch.float32, "high"),
    (4096, 1024, 512, 1, torch.float32, "default"),
]


@pytest.mark.parametrize("n,w,ktb,k,dtype,prec", PACKED_CASES)
def test_packed_kernel_matches_plain(cuda, n, w, ktb, k, dtype, prec):
    g = torch.Generator().manual_seed(n + w + k)
    c = torch.randn(P.packed_rows(n, w), w, generator=g, dtype=torch.float64).to(dtype)
    p = torch.randn(n - (k + 1) * w, w, generator=g, dtype=torch.float64).to(dtype)
    kw = dict(n=n, w=w, k=k, tb=ktb)
    with precision.override(prec):
        ref = trailing_update_packed_plain(c.clone(), p, **kw)
        cd = c.to(cuda)
        before = tiles.packed_launches
        out = trailing_update_packed(cd, p.to(cuda), **kw)
        torch.cuda.synchronize()
    assert out is cd and tiles.packed_launches == before + 1
    got = out.cpu()
    mask = _packed_visited(n, w, ktb, k)
    assert (got.double() - ref.double()).abs()[mask].max().item() <= _tol(dtype, c, p)
    assert torch.equal(got[~mask], c[~mask])


def test_packed_offsets_past_2_pow_31(cuda):
    # rows·w = 2.28e9 elements: the last slab's diagonal block sits past 2³¹
    n, w, ktb = 65536, 4096, 1024
    nt = n // w
    k = nt - 2  # the window is the last slab's diagonal block
    packed = torch.zeros(P.packed_rows(n, w), w, device=cuda)
    assert packed.numel() > 2**31
    p = torch.randn(w, w, device=cuda)
    trailing_update_packed(packed, p, n=n, w=w, k=k, tb=ktb)
    torch.cuda.synchronize()
    r0 = P._row_offset(nt - 1, nt, w)
    ref = trailing_update_lower_plain(torch.zeros(w, w), p.cpu(), tb=ktb)
    assert (packed[r0:].cpu() - ref).abs().max().item() <= _tol(torch.float32, packed, p)
    assert packed[:r0].abs().max().item() == 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("trailing", ["pallas", "xla"])
def test_potrf_packed_card_matches_cpu(cuda, dtype, trailing):
    n, w = 768, 256
    kw = dict(trailing=trailing, ktb=128, ib=128, precision="high")
    a = P.plgsy_packed(n, w, seed=3, dtype=dtype, device="cpu")
    before = tiles.packed_launches
    ad = a.to(cuda)
    lg = P.potrf_packed(ad, n, w, **kw)
    assert lg is ad
    assert tiles.packed_launches == before + (n // w - 1 if trailing == "pallas" else 0)
    lc = P.unpack_tri(P.potrf_packed(a.clone(), n, w, **kw), n, w)
    lg = P.unpack_tri(lg.cpu(), n, w)
    tol = 1e-10 if dtype == torch.float64 else 1e-5 * lc.abs().max().item()
    assert (lg - lc).abs().max().item() <= tol
    gate = 1e-10 if dtype == torch.float64 else n * 2e-7
    assert float(P.freivalds_packed(ad, n, w, seed=3)) < gate


def test_packed_layout_and_shape_checks_raise(cuda):
    n, w = 384, 96
    rows = P.packed_rows(n, w)
    packed = torch.zeros(rows, w, device=cuda)
    p = torch.zeros(n - w, w, device=cuda)
    with pytest.raises(ValueError, match="row-major"):
        trailing_update_packed(torch.zeros(w, rows, device=cuda).mT, p, n=n, w=w, k=0, tb=32)
    with pytest.raises(ValueError, match="row-major"):
        trailing_update_packed(packed, torch.zeros(w, n - w, device=cuda).mT, n=n, w=w, k=0,
                               tb=32)
    with pytest.raises(ValueError, match="panel shape"):
        trailing_update_packed(packed, p[1:], n=n, w=w, k=0, tb=32)
    with pytest.raises(ValueError, match="CUDA"):
        trailing_update_packed(packed, p.cpu(), n=n, w=w, k=0, tb=32)


def test_plgsy_packed_same_bits_on_card(cuda):
    got = P.plgsy_packed(384, 128, seed=7, dtype=torch.float64, device=cuda).cpu()
    assert torch.equal(got, P.plgsy_packed(384, 128, seed=7, dtype=torch.float64,
                                                 device="cpu"))


# ---- the df64 trailing kernel (csrc/trailing_df64.cu) --------------------------------
# Every slice product and every chunk sum is exact, so the kernel is held to the
# plain version's bits, not to a tolerance.

DF64_CASES = [  # (m, nb, tb, s, w, origin)
    (1024, 1024, 512, 7, 8, 0),  # the f64x path's tb and nb
    (1024, 1024, 512, 7, 8, 1),
    (512, 512, 128, 6, 9, 1),  # nk = 2 chunks of kb = 256
    (384, 128, 96, 7, 8, 0),  # tb not a multiple of the 64-wide blocks
    (200, 7, 40, 5, 8, 1),  # a chunk shorter than the kernel's k-step
]


def _df64_inputs(m, nb, tb, s, w, origin, seed):
    from dla_tpu_torch.ops.df64 import slice_rows, to_df64

    g = torch.Generator().manual_seed(seed)
    ch, cl = to_df64(torch.randn(m, m, generator=g, dtype=torch.float64))
    p = torch.randn(m - origin * tb, nb, generator=g, dtype=torch.float64)
    return ch, cl, slice_rows(*to_df64(p), s=s, w=w)[0]


def _bits32(t):
    return t.view(torch.int32)


def adversarial_slices(rows, nb, s, w, kind, seed):
    """``s`` bf16 slices of shape (rows, nb) on ``slice_rows``' grids (row r of
    slice t on g_t(r) = mu_r·2^(1−(t+1)w), mu_r a power of 2), at the edges of
    the df64 kernels' exactness argument (``csrc/trailing_df64.cuh``):
    ``"max"``: every element 2^(w−1) units, positive, so every product of a
    pair is 2^(2w−2) units of one sign and a chunk of kb = 2^(26−2w) of them
    sums to exactly 2^24 units; ``"alternating"``: magnitudes 2^(w−1) or one
    unit less, signs flipping every 1, 16 or 512 columns or never, by row:
    chunk sums that climb towards 2^24 units, or to 2^23 and cancel."""
    rng = np.random.default_rng(seed)
    mu = 2.0 ** rng.integers(-4, 5, size=(rows, 1))
    k = np.arange(nb)
    out = []
    for t in range(s):
        if kind == "max":
            units = np.full((rows, nb), 2.0 ** (w - 1))
        else:
            period = np.array([1, 16, 512, nb])[np.arange(rows) % 4][:, None]
            units = (-1.0) ** (k // period) * (2.0 ** (w - 1) - (rng.random((rows, nb)) < 0.25))
        out.append(torch.from_numpy(units * mu * 2.0 ** (1 - (t + 1) * w)).to(torch.bfloat16))
    return out


@pytest.mark.parametrize("m,nb,tb,s,w,origin", DF64_CASES)
def test_df64_kernel_same_bits_as_plain(cuda, m, nb, tb, s, w, origin):
    from dla_tpu_torch.kernels import df64_tiles

    ch, cl, sx = _df64_inputs(m, nb, tb, s, w, origin, seed=m + nb + origin)
    kw = dict(origin=origin, tb=tb, w=w)
    ref = df64_tiles.trailing_update_df64_plain(ch.clone(), cl.clone(), sx, **kw)
    dh, dl = ch.to(cuda), cl.to(cuda)
    before = df64_tiles.launches
    out = df64_tiles.trailing_update_df64(dh, dl, [x.to(cuda) for x in sx], **kw)
    torch.cuda.synchronize()
    assert out[0] is dh and out[1] is dl and df64_tiles.launches == before + 1
    mask = _lower_mask(m, tb, origin)
    for got, want, orig in zip(out, ref, (ch, cl)):
        got = got.cpu()
        assert torch.equal(_bits32(got), _bits32(want))
        assert torch.equal(_bits32(got[~mask]), _bits32(orig[~mask]))


ADVERSARIAL_CASES = [  # (m, nb, tb, s, w, kind)
    (512, 1024, 128, 7, 8, "max"),  # one chunk of kb = 1024: sums of exactly 2^24 units
    (512, 1024, 128, 7, 8, "alternating"),
    (384, 512, 96, 6, 9, "max"),  # two chunks of kb = 256
    (384, 512, 96, 6, 9, "alternating"),
]


@pytest.mark.parametrize("m,nb,tb,s,w,kind", ADVERSARIAL_CASES)
def test_df64_kernel_adversarial_slices_same_bits(cuda, m, nb, tb, s, w, kind):
    from dla_tpu_torch.kernels import df64_tiles
    from dla_tpu_torch.ops.df64 import to_df64

    g = torch.Generator().manual_seed(m + w)
    ch, cl = to_df64(torch.randn(m, m, generator=g, dtype=torch.float64))
    sx = adversarial_slices(m, nb, s, w, kind, seed=m + nb)
    kw = dict(tb=tb, w=w)
    ref = df64_tiles.trailing_update_df64_plain(ch.clone(), cl.clone(), sx, **kw)
    out = df64_tiles.trailing_update_df64(ch.to(cuda), cl.to(cuda), [x.to(cuda) for x in sx],
                                          **kw)
    torch.cuda.synchronize()
    for got, want in zip(out, ref):
        assert torch.equal(_bits32(got.cpu()), _bits32(want))


def test_df64_kernel_20_launches_back_to_back(cuda):
    # one pair through 20 queued launches, as a factorization queues them, against
    # the plain version's 20 steps on the card; four slice sets, origins 0 and 1
    from dla_tpu_torch.kernels import df64_tiles

    m, nb, tb, s, w = 1024, 1024, 256, 7, 8
    ch, cl, _ = _df64_inputs(m, 16, tb, 1, w, 0, seed=20)
    sets = [[x.to(cuda) for x in _df64_inputs(m, nb, tb, s, w, t // 2, seed=30 + t)[2]]
            for t in range(4)]
    out = (ch.to(cuda), cl.to(cuda))
    ref = (ch.to(cuda), cl.to(cuda))
    before = df64_tiles.launches
    for t in range(20):
        df64_tiles.trailing_update_df64(*out, sets[t % 4], origin=t % 4 // 2, tb=tb, w=w)
    torch.cuda.synchronize()
    assert df64_tiles.launches == before + 20
    for t in range(20):
        df64_tiles.trailing_update_df64_plain(*ref, sets[t % 4], origin=t % 4 // 2, tb=tb, w=w)
    for got, want in zip(out, ref):
        assert torch.equal(_bits32(got), _bits32(want))


def test_df64_body_registers_no_spill(cuda):
    # ptxas's registers and spills for the tensor-core body of both df64 kernels
    import re
    import subprocess
    import tempfile

    from dla_tpu_torch.kernels import _build

    for src in ("trailing_df64.cu", "trailing_packed_df64.cu"):
        with tempfile.TemporaryDirectory() as tmp:
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                   f"{tmp}/k.o", str(_build.CSRC / src)]
            log = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
        kernel = None
        seen = {}
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif kernel and "trailing_df64_tc_kernel" in kernel:
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                regs = re.search(r"Used (\d+) registers", line)
                if spill:
                    seen["spill"] = int(spill[1]) + int(spill[2])
                if regs:
                    seen["registers"] = int(regs[1])
        print(f"{src}: trailing_df64_tc_kernel {seen}")
        assert seen.get("spill") == 0 and 0 < seen.get("registers", 0) <= 255, (src, seen)


def test_df64_kernel_offsets_past_2_pow_31(cuda):
    # two 46592² planes (2.17e9 elements each): the one far-corner tile pair
    from dla_tpu_torch.kernels import df64_tiles

    m, tb, origin, nb = 46592, 512, 90, 1024
    assert m * m > 2**31 and m - origin * tb == tb
    _, _, sx = _df64_inputs(tb, nb, tb, 7, 8, 0, seed=3)
    ch = torch.zeros(m, m, device=cuda)
    cl = torch.zeros(m, m, device=cuda)
    df64_tiles.trailing_update_df64(ch, cl, [x.to(cuda) for x in sx], origin=origin, tb=tb)
    torch.cuda.synchronize()
    ref = df64_tiles.trailing_update_df64_plain(torch.zeros(tb, tb), torch.zeros(tb, tb), sx,
                                                tb=tb)
    o = origin * tb
    for got, want in zip((ch, cl), ref):
        assert torch.equal(_bits32(got[o:, o:].cpu()), _bits32(want))
        assert got[:o].abs().max().item() == 0 and got[o:, :o].abs().max().item() == 0


def test_df64_kernel_checks_raise(cuda):
    from dla_tpu_torch.kernels import df64_tiles

    ch = torch.zeros(256, 256, device=cuda)
    sx = [torch.zeros(256, 64, dtype=torch.bfloat16, device=cuda)] * 3
    with pytest.raises(ValueError, match="row-major"):
        df64_tiles.trailing_update_df64(ch.mT, ch, sx, tb=64)
    with pytest.raises(ValueError, match="row-major"):
        df64_tiles.trailing_update_df64(ch, ch.clone(), [x.mT.contiguous().mT for x in sx], tb=64)
    with pytest.raises(ValueError, match="at most"):
        df64_tiles.trailing_update_df64(ch, ch.clone(), sx * 3, tb=64)
    with pytest.raises(ValueError, match="CUDA"):
        df64_tiles.trailing_update_df64(ch, ch.clone(), [x.cpu() for x in sx], tb=64)
    with pytest.raises(ValueError, match="k-step"):  # w = 11: chunks of 16 columns
        df64_tiles.trailing_update_df64(ch, ch.clone(), sx, tb=64, w=11)


def test_df64_elementwise_same_bits_on_card(cuda):
    # torch's CUDA elementwise kernels neither contract nor reorder the EFTs
    from dla_tpu_torch.ops import df64 as D

    g = torch.Generator().manual_seed(4)
    x = torch.randn(4096, generator=g) * torch.exp(torch.empty(4096).uniform_(-15, 15, generator=g))
    y = torch.randn(4096, generator=g) * torch.exp(torch.empty(4096).uniform_(-15, 15, generator=g))
    p, e = D.two_prod(x.to(cuda), y.to(cuda))
    assert torch.equal(p.double() + e.double(), (x.double() * y.double()).to(cuda))
    for name in ("two_sum", "two_prod"):
        got = getattr(D, name)(x.to(cuda), y.to(cuda))
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, getattr(D, name)(x, y)))
    a = torch.randn(64, 300, generator=g, dtype=torch.float64)
    want, mu = D.slice_rows(*D.to_df64(a), s=7)
    got, mud = D.slice_rows(*D.to_df64(a.to(cuda)), s=7)
    assert torch.equal(mud.cpu(), mu)
    assert all(torch.equal(u.cpu().view(torch.int16), v.view(torch.int16)) for u, v in zip(got, want))
    sq = D.df_sqrt(*D.to_df64(a.abs().to(cuda)))
    assert all(torch.equal(u.cpu(), v) for u, v in zip(sq, D.df_sqrt(*D.to_df64(a.abs()))))


@pytest.mark.parametrize("trailing", ["pallas", "xla"])
def test_potrf_df64_card_matches_cpu(cuda, trailing):
    from dla_tpu_torch.algos import potrf_df64, residual_potrf_df64
    from dla_tpu_torch.kernels import df64_tiles
    from dla_tpu_torch.ops import from_df64

    n, kw = 512, dict(nb=128, tb=64, trailing=trailing)
    a = T.plgsy(n, seed=3, device="cpu")
    before = df64_tiles.launches
    lg = potrf_df64(a.to(cuda), torch.zeros(n, n, device=cuda), **kw)
    assert df64_tiles.launches == before + (n // 128 - 1 if trailing == "pallas" else 0)
    lc = potrf_df64(a.clone(), torch.zeros(n, n), **kw)
    dl = (from_df64(*lg).cpu() - from_df64(*lc)).abs().max().item()
    assert dl <= 1e-12 * from_df64(*lc).abs().max().item()
    ad = a.to(cuda)
    assert float(residual_potrf_df64(ad, torch.zeros_like(ad), *lg)) < 1e-11



# ---- the packed df64 trailing kernel (csrc/trailing_packed_df64.cu) -------------------
# The dense df64 kernel's block body at the packed offsets: held to the plain
# version's bits on both planes.

PACKED_DF64_CASES = [  # (n, nb, tb, s, w, k)
    (2048, 1024, 512, 7, 8, 0),  # the packed df64 path's nb and tb
    (1536, 512, 512, 7, 8, 1),
    (1024, 512, 128, 6, 9, 0),  # nk = 2 chunks of kb = 256
    (576, 192, 96, 7, 8, 0),  # tb not a multiple of the 64-wide blocks
    (384, 96, 32, 7, 8, 1),  # nb not a multiple of 64: blocks straddle slabs
    (200, 40, 8, 5, 8, 2),
]


def _packed_df64_inputs(n, nb, s, w, k, seed):
    from dla_tpu_torch.ops.df64 import slice_rows, to_df64

    g = torch.Generator().manual_seed(seed)
    ch, cl = to_df64(torch.randn(P.packed_rows(n, nb), nb, generator=g, dtype=torch.float64))
    p = torch.randn(n - (k + 1) * nb, nb, generator=g, dtype=torch.float64)
    return ch, cl, slice_rows(*to_df64(p), s=s, w=w)[0]


@pytest.mark.parametrize("n,nb,tb,s,w,k", PACKED_DF64_CASES)
def test_packed_df64_kernel_same_bits_as_plain(cuda, n, nb, tb, s, w, k):
    from dla_tpu_torch.kernels import df64_tiles

    ch, cl, sx = _packed_df64_inputs(n, nb, s, w, k, seed=n + nb + k)
    kw = dict(n=n, nb=nb, k=k, tb=tb, w=w)
    ref = df64_tiles.trailing_update_packed_df64_plain(ch.clone(), cl.clone(), sx, **kw)
    dh, dl = ch.to(cuda), cl.to(cuda)
    before = (df64_tiles.packed_launches, df64_tiles.launches)
    out = df64_tiles.trailing_update_packed_df64(dh, dl, [x.to(cuda) for x in sx], **kw)
    torch.cuda.synchronize()
    assert out[0] is dh and out[1] is dl
    assert (df64_tiles.packed_launches, df64_tiles.launches) == (before[0] + 1, before[1])
    mask = _packed_visited(n, nb, tb, k)
    for got, want, orig in zip(out, ref, (ch, cl)):
        got = got.cpu()
        assert torch.equal(_bits32(got), _bits32(want))
        assert torch.equal(_bits32(got[~mask]), _bits32(orig[~mask]))
    assert not torch.equal(out[0].cpu()[mask], ch[mask])


PACKED_ADVERSARIAL_CASES = [  # (n, nb, tb, s, w, k, kind)
    (2048, 1024, 512, 7, 8, 0, "max"),  # one chunk of kb = 1024: sums of exactly 2^24 units
    (2048, 1024, 512, 7, 8, 0, "alternating"),
    (1536, 768, 96, 6, 9, 0, "max"),  # three chunks of kb = 256, tb = 96
    (1536, 768, 96, 6, 9, 0, "alternating"),
]


@pytest.mark.parametrize("n,nb,tb,s,w,k,kind", PACKED_ADVERSARIAL_CASES)
def test_packed_df64_kernel_adversarial_slices_same_bits(cuda, n, nb, tb, s, w, k, kind):
    from dla_tpu_torch.kernels import df64_tiles

    ch, cl, _ = _packed_df64_inputs(n, nb, 1, w, k, seed=n + w)
    sx = adversarial_slices(n - (k + 1) * nb, nb, s, w, kind, seed=n + nb)
    kw = dict(n=n, nb=nb, k=k, tb=tb, w=w)
    ref = df64_tiles.trailing_update_packed_df64_plain(ch.clone(), cl.clone(), sx, **kw)
    out = df64_tiles.trailing_update_packed_df64(ch.to(cuda), cl.to(cuda),
                                                 [x.to(cuda) for x in sx], **kw)
    torch.cuda.synchronize()
    for got, want in zip(out, ref):
        assert torch.equal(_bits32(got.cpu()), _bits32(want))


def test_packed_df64_kernel_20_launches_back_to_back(cuda):
    # one packed pair through 20 queued launches at steps k = 0..6 in turn, as a
    # factorization's steps, against the plain version's 20 steps on the card
    from dla_tpu_torch.kernels import df64_tiles

    n, nb, tb, s, w = 2048, 256, 128, 7, 8
    nt = n // nb
    ch, cl, _ = _packed_df64_inputs(n, nb, 1, w, 0, seed=20)
    sets = [[x.to(cuda) for x in _packed_df64_inputs(n, nb, s, w, k, seed=40 + k)[2]]
            for k in range(nt - 1)]
    out = (ch.to(cuda), cl.to(cuda))
    ref = (ch.to(cuda), cl.to(cuda))
    before = df64_tiles.packed_launches
    for t in range(20):
        k = t % (nt - 1)
        df64_tiles.trailing_update_packed_df64(*out, sets[k], n=n, nb=nb, k=k, tb=tb, w=w)
    torch.cuda.synchronize()
    assert df64_tiles.packed_launches == before + 20
    for t in range(20):
        k = t % (nt - 1)
        df64_tiles.trailing_update_packed_df64_plain(*ref, sets[k], n=n, nb=nb, k=k, tb=tb, w=w)
    for got, want in zip(out, ref):
        assert torch.equal(_bits32(got), _bits32(want))


def test_packed_df64_kernel_offsets_past_2_pow_31(cuda):
    # two planes of 2.18e9 elements each: the last slab's diagonal block sits past 2³¹
    from dla_tpu_torch.kernels import df64_tiles

    n, nb, tb = 65536, 1024, 512
    nt = n // nb
    k = nt - 2  # the window is the last slab's diagonal block
    ph = torch.zeros(P.packed_rows(n, nb), nb, device=cuda)
    pl = torch.zeros_like(ph)
    assert ph.numel() > 2**31
    _, _, sx = _df64_inputs(nb, nb, tb, 7, 8, 0, seed=3)
    df64_tiles.trailing_update_packed_df64(ph, pl, [x.to(cuda) for x in sx], n=n, nb=nb, k=k,
                                           tb=tb)
    torch.cuda.synchronize()
    ref = df64_tiles.trailing_update_df64_plain(torch.zeros(nb, nb), torch.zeros(nb, nb), sx,
                                                tb=tb)
    r0 = P._row_offset(nt - 1, nt, nb)
    for got, want in zip((ph, pl), ref):
        assert torch.equal(_bits32(got[r0:].cpu()), _bits32(want))
        assert got[:r0].abs().max().item() == 0
    assert ph[r0:].abs().max().item() > 0


def test_packed_df64_kernel_checks_raise(cuda):
    from dla_tpu_torch.kernels import df64_tiles

    n, nb = 384, 128
    rows = P.packed_rows(n, nb)
    ph = torch.zeros(rows, nb, device=cuda)
    sx = [torch.zeros(n - nb, nb, dtype=torch.bfloat16, device=cuda)] * 3
    kw = dict(n=n, nb=nb, k=0, tb=64)
    fn = df64_tiles.trailing_update_packed_df64
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.zeros(nb, rows, device=cuda).mT, ph, sx, **kw)
    with pytest.raises(ValueError, match="row-major"):  # a CUDA triangular solve's layout
        fn(ph, ph.clone(), [x.mT.contiguous().mT for x in sx], **kw)
    with pytest.raises(ValueError, match="at most"):
        fn(ph, ph.clone(), sx * 3, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        fn(ph, ph.clone(), [x.cpu() for x in sx], **kw)
    with pytest.raises(ValueError, match="slice shape"):
        fn(ph, ph.clone(), [x[1:] for x in sx], **kw)


@pytest.mark.parametrize("ktb", [128, 64])
def test_potrf_packed_df64_card_matches_cpu(cuda, ktb):
    from dla_tpu_torch.algos import potrf_packed_df64, potrf_packed_df64_split
    from dla_tpu_torch.algos.potrf_df64 import freivalds_packed_df64
    from dla_tpu_torch.kernels import df64_tiles
    from dla_tpu_torch.ops import from_df64

    n, nb = 512, 128
    a = P.plgsy_packed(n, nb, seed=3, device="cpu")
    before = df64_tiles.packed_launches
    ad = a.to(cuda)
    lg = potrf_packed_df64(ad, torch.zeros_like(ad), n, nb, ktb=ktb)
    assert lg[0] is ad and df64_tiles.packed_launches == before + n // nb - 1
    lc = potrf_packed_df64(a.clone(), torch.zeros_like(a), n, nb, ktb=ktb)
    dg = from_df64(*(P.unpack_tri(x.cpu(), n, nb) for x in lg))
    dc = from_df64(*(P.unpack_tri(x, n, nb) for x in lc))
    assert (dg - dc).abs().max().item() <= 1e-12 * dc.abs().max().item()
    ls = potrf_packed_df64_split(a.to(cuda), torch.zeros_like(ad), n, nb, split=2, ktb=ktb)
    assert all(torch.equal(_bits32(x), _bits32(y)) for x, y in zip(ls, lg))
    fg = freivalds_packed_df64(*lg, n, nb, gen_seed=3, row_chunk=128)
    fc = freivalds_packed_df64(lg[0].cpu(), lg[1].cpu(), n, nb, gen_seed=3, row_chunk=128)
    # exact per-chunk products: the card and the CPU differ in the |A| row sums' order only
    assert fg < 1e-11 and abs(fg - fc) <= 1e-5 * fc

# ---- the panel kernels (csrc/panel_factor.cu, csrc/panel_apply.cu) -------------------
# Tolerances of max|out|: fp64 1e-12; fp32 1e-5 (panel_factor's diagonal
# phase rounds where the plain version does, the products sum the same
# partial products in another order); panel_apply 1e-4 at high and highest
# (the right-hand sides are summed in another order before their bf16x3
# split) and 2^-6 at default (one bf16 pass).

PANEL_FACTOR_CASES = [  # (m, nb, dtype, precision)
    (64, 64, torch.float32, "highest"),  # m = nb: the diagonal phase alone
    (192, 64, torch.float32, "high"),
    (256, 64, torch.float32, "default"),
    (320, 64, torch.float64, "high"),
    (150, 50, torch.float32, "high"),  # nb not a multiple of the 64-wide blocks
    (2048, 512, torch.float32, "highest"),
    (1024, 512, torch.float64, "high"),
]


@pytest.mark.parametrize("m,nb,dtype,prec", PANEL_FACTOR_CASES)
def test_panel_factor_matches_plain(cuda, m, nb, dtype, prec):
    from dla_tpu_torch.kernels import panel

    g = torch.Generator().manual_seed(m + nb)
    a = torch.randn(m, nb, generator=g, dtype=torch.float64)
    a[:nb] = a[:nb] @ a[:nb].mT + nb * torch.eye(nb, dtype=torch.float64)
    p = a.to(dtype)
    p[:nb] += torch.triu(torch.full((nb, nb), float("nan"), dtype=dtype), 1)  # never read
    with precision.override(prec):
        ref = panel.panel_factor_plain(p)
        before = panel.panel_factor_launches
        got = panel.panel_factor(p.to(cuda))
        torch.cuda.synchronize()
    assert panel.panel_factor_launches == before + 1
    got = got.cpu()
    assert torch.isfinite(got).all()
    tol = (1e-12 if dtype == torch.float64 else 1e-5) * ref.abs().max().item()
    assert (got.double() - ref.double()).abs().max().item() <= tol


PANEL_APPLY_CASES = [  # (m, nb, ib, tb, precision)
    (128, 32, 16, 64, "high"),
    (96, 32, 32, 32, "highest"),  # nk = 1
    (64, 16, 8, 128, "default"),  # tb > m: clamped
    (100, 40, 20, 100, "high"),  # a ragged last strip of 36 rows
    (2048, 1024, 256, 1024, "high"),
    (2048, 1024, 512, 1024, "highest"),
    (3000, 1024, 256, 1000, "high"),  # m not a multiple of the 128-row tile
    (2048, 1024, 512, 1024, "default"),
]


@pytest.mark.parametrize("m,nb,ib,tb,prec", PANEL_APPLY_CASES)
def test_panel_apply_matches_plain(cuda, m, nb, ib, tb, prec):
    from dla_tpu_torch.kernels import panel

    g = torch.Generator().manual_seed(m + nb + ib)
    lkk = torch.tril(torch.randn(nb, nb, generator=g)) + nb * torch.eye(nb)
    b = torch.randn(m, nb, generator=g)
    with precision.override(prec):
        ref = panel.panel_apply_plain(lkk, b, ib=ib, tb=tb)
        before = panel.panel_apply_launches
        got = panel.panel_apply(lkk.to(cuda), b.to(cuda), ib=ib, tb=tb)
        torch.cuda.synchronize()
    assert panel.panel_apply_launches == before + 1
    tol = (2**-6 if prec == "default" else 1e-4) * ref.abs().max().item()
    assert (got.cpu() - ref).abs().max().item() <= tol


@pytest.mark.parametrize("prec", ["high", "default", "highest"])
def test_panel_apply_of_a_view_leaves_it_unwritten(cuda, prec):
    # as potrf_inplace passes it: B is a view of the matrix being factored, leading
    # dimension N; the kernel reads it and writes only out and its scratches
    from dla_tpu_torch.kernels import panel

    n, off, nb, ib = 4096, 1024, 1024, 256
    g = torch.Generator(device=cuda).manual_seed(n + nb)
    a = torch.randn(n, n, generator=g, device=cuda)
    lkk = torch.tril(a[off : off + nb, off : off + nb]) + nb * torch.eye(nb, device=cuda)
    before = a.clone()
    b = a[off + nb :, off : off + nb]
    assert b.stride(0) == n
    with precision.override(prec):
        got = panel.panel_apply(lkk, b, ib=ib, tb=nb)
        ref = panel.panel_apply_plain(lkk.cpu(), b.cpu(), ib=ib, tb=nb)
        torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), before.view(torch.int32))
    tol = (2**-6 if prec == "default" else 1e-4) * ref.abs().max().item()
    assert (got.cpu() - ref).abs().max().item() <= tol


@pytest.mark.parametrize("prec,body", [("high", "wgmma"), ("default", "wgmma"),
                                       ("highest", "simt")])
def test_panel_apply_body_that_ran(cuda, prec, body):
    # one call counts once, through the tier's body; the task kernels' count stays put
    from dla_tpu_torch.kernels import panel

    g = torch.Generator(device=cuda).manual_seed(7)
    lkk = torch.tril(torch.randn(512, 512, generator=g, device=cuda)) + 512 * torch.eye(
        512, device=cuda)
    b = torch.randn(1000, 512, generator=g, device=cuda)
    with precision.override(prec):
        assert panel.panel_apply_body(prec) == body
        before, tile_before = panel.panel_apply_body_launches(), tiles.tile_body_launches()
        panel.panel_apply(lkk, b, ib=128, tb=1000)
        torch.cuda.synchronize()
        after, tile_after = panel.panel_apply_body_launches(), tiles.tile_body_launches()
    assert after[body] == before[body] + 1
    assert [x for x in after if after[x] != before[x]] == [body]
    assert tile_after == tile_before


def test_panel_apply_refused_launch_raises(cuda, monkeypatch):
    # split scratch one row short: the C call refuses before it launches anything, the
    # wrapper raises, and no count moves
    from dla_tpu_torch.kernels import panel

    real = panel._split_scratch
    monkeypatch.setattr(panel, "_split_scratch", lambda *args: real(*args)[:-1])
    lkk = torch.eye(512, device=cuda)
    b = torch.randn(1024, 512, device=cuda)
    before = (panel.panel_apply_launches, panel.panel_apply_body_launches())
    with precision.override("high"), pytest.raises(RuntimeError, match="CUDA error 1"):
        panel.panel_apply(lkk, b, ib=128)
    torch.cuda.synchronize()
    assert (panel.panel_apply_launches, panel.panel_apply_body_launches()) == before


def _panel_factor_input(cuda, m, nb, dtype, ld=None):
    """An (m, nb) panel, SPD diagonal block with NaN above its diagonal, as a
    view of the first nb columns of an (m, ld) matrix (ld None: contiguous)."""
    g = torch.Generator(device=cuda).manual_seed(m + nb)
    a = torch.randn(m, ld or nb, generator=g, device=cuda, dtype=torch.float64)
    x = a[:nb, :nb].clone()
    a[:nb, :nb] = x @ x.mT + nb * torch.eye(nb, device=cuda, dtype=torch.float64)
    a = a.to(dtype)
    a[:nb, :nb] += torch.triu(torch.full((nb, nb), float("nan"), device=cuda, dtype=dtype), 1)
    return a[:, :nb]


def _factor_counts():
    from dla_tpu_torch.kernels import panel

    return (panel.panel_factor_body_launches(), panel.panel_apply_body_launches(),
            tiles.tile_body_launches(), tiles.body_launches())


PANEL_FACTOR_TIERS = [(torch.float32, "highest"), (torch.float32, "high"),
                      (torch.float32, "default"), (torch.float64, "high")]
PANEL_FACTOR_CHAIN_CASES = [  # (m, nb, ld): the path's nb, nb off 64, a view of a wide matrix
    (2048, 512, None), (150, 50, None), (320, 64, None), (1536, 512, 4096), (288, 96, 97),
]


@pytest.mark.parametrize("dtype,prec", CHAIN_TIERS)
@pytest.mark.parametrize("m,nb,ld", PANEL_FACTOR_CHAIN_CASES)
def test_panel_factor_chain_same_bits_as_scalar_body(cuda, m, nb, ld, dtype, prec):
    """At fp32 highest and fp64 out[nb:] is, bit for bit, the scalar body's
    trsm of p[nb:] with potrf_tile's inverse of the same block (the plain
    version's bits, as the diagonal phase's), and out[:nb] potrf_tile's L."""
    from dla_tpu_torch.kernels import panel

    p = _panel_factor_input(cuda, m, nb, dtype, ld)
    with precision.override(prec):
        out = panel.panel_factor(p)
        l, linv = tiles.potrf_tile(p[:nb])
        ref = tiles.tile_op_reference("trsm", None, p[nb:], linv, tile=0)
        torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert torch.equal(_bits(out[:nb]), _bits(l))
    assert torch.equal(_bits(out[nb:]), _bits(ref))


@pytest.mark.parametrize("dtype,prec", PANEL_FACTOR_TIERS)
def test_panel_factor_body_that_ran(cuda, dtype, prec):
    # one call counts once, through the tier's body, also at m = nb (no product); the task
    # kernels', #3's and the trailing kernels' counts stay put
    from dla_tpu_torch.kernels import panel

    body = panel.panel_factor_body(dtype, prec)
    p = _panel_factor_input(cuda, 1024, 256, dtype)
    with precision.override(prec):
        before = _factor_counts()
        panel.panel_factor(p)
        torch.cuda.synchronize()
        after = _factor_counts()
        assert {x: after[0][x] - before[0][x] for x in after[0]} == {
            x: int(x == body) for x in tiles.TILE_BODIES}
        assert after[1:] == before[1:]
        panel.panel_factor(p[:256])
        torch.cuda.synchronize()
        again = _factor_counts()
        assert again[0][body] == after[0][body] + 1 and again[1:] == after[1:]
    assert panel.panel_factor_schedule(1024, 256, dtype, prec).body == body


@pytest.mark.parametrize("nb", [50, 64, 256, 512])
def test_panel_factor_schedule_diag_launches_as_the_library(cuda, nb):
    # the pure-Python schedule's diagonal phase against the C side's (dla_diag_schedule)
    from dla_tpu_torch.kernels import panel

    for dtype, prec in PANEL_FACTOR_TIERS:
        sched = panel.panel_factor_schedule(4 * nb, nb, dtype, prec)
        product = 2 if sched.scratch else 1
        assert sched.launches - product == tiles.potrf_tile_schedule(nb)[0]
        assert panel.panel_factor_schedule(nb, nb, dtype, prec).launches == (
            tiles.potrf_tile_schedule(nb)[0])


@pytest.mark.parametrize("prec", ["high", "default"])
def test_panel_factor_refused_launch_raises(cuda, monkeypatch, prec):
    # split scratch one row short: the C call refuses before it launches anything (the
    # diagonal phase included), the wrapper raises, and no count moves
    from dla_tpu_torch.kernels import panel

    real = panel._split_scratch
    monkeypatch.setattr(panel, "_split_scratch", lambda *args: real(*args)[:-1])
    p = _panel_factor_input(cuda, 1024, 256, torch.float32)
    before = (panel.panel_factor_launches, _factor_counts())
    with precision.override(prec), pytest.raises(RuntimeError, match="CUDA error 1"):
        panel.panel_factor(p)
    torch.cuda.synchronize()
    assert (panel.panel_factor_launches, _factor_counts()) == before


@pytest.mark.parametrize("m,nb,ib", [(2048, 1024, 256), (3000, 1024, 512), (100, 40, 20),
                                     (96, 32, 32)])
def test_panel_apply_highest_same_bits_as_scalar_body(cuda, m, nb, ib):
    """At highest every product of panel_apply_schedule, replayed through the
    scalar body (tile_op_reference, tile 0) on the same inverses, gives the
    kernel's bits: the simt chain keeps them product by product."""
    from dla_tpu_torch.kernels import panel

    g = torch.Generator(device=cuda).manual_seed(m + nb + ib)
    lkk = torch.tril(torch.randn(nb, nb, generator=g, device=cuda)) + nb * torch.eye(
        nb, device=cuda)
    b = torch.randn(m, nb, generator=g, device=cuda)
    with precision.override("highest"):
        out = panel.panel_apply(lkk, b, ib=ib, tb=m)
        sched = panel.panel_apply_schedule(m, nb, ib)
    dinv = panel._diag_inverses(lkk, ib)
    x = torch.full((m, nb), float("nan"), device=cuda)
    rhs = None
    for prod in sched.products:
        j = prod.col
        if prod.epilogue == "gemm":
            rhs = tiles.tile_op_reference("gemm", b[:, j : j + ib], x[:, :j], lkk[j : j + ib, :j])
        else:
            a = b[:, :ib] if j == 0 else rhs
            x[:, j : j + ib] = tiles.tile_op_reference("trsm", None, a, dinv[j : j + ib])
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(x))


def test_panel_kernels_raise_on_column_major(cuda):
    from dla_tpu_torch.kernels import panel

    p = torch.randn(128, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="row-major"):
        panel.panel_factor(p.mT.contiguous().mT)
    lkk = torch.eye(32, device=cuda)
    with pytest.raises(ValueError, match="row-major"):
        panel.panel_apply(lkk.mT.contiguous().mT, torch.zeros(64, 32, device=cuda), ib=16)
    with pytest.raises(ValueError, match="CUDA"):
        panel.panel_apply(lkk, torch.zeros(64, 32), ib=16)


def test_generators_default_to_the_card(cuda):
    from dla_tpu_torch.ops import to_df64

    assert T.plgsy(64).device.type == "cuda"
    assert T.plgsy_tile(51, 0, 0, 8, 8).device.type == "cuda"
    assert P.plgsy_packed(64, 32).device.type == "cuda"
    assert to_df64(torch.eye(8).double().numpy())[0].device.type == "cuda"


@pytest.mark.parametrize("kw", [
    dict(mode="blocked", panel="pallas", trailing="pallas"),
    dict(mode="shrink", panel="pallas", trailing="pallas"),
    dict(mode="shrink", panel="blocktrsm", trailing="pallas", tb=64, kb=64, ib=64),
    dict(mode="masked"),
    dict(mode="inplace", panel="pallas", panel_ib=64),
])
def test_potrf_modes_card_matches_cpu(cuda, kw):
    n = 512
    a = T.plgsy(n, seed=3, device="cpu")
    ad = a.to(cuda)
    lg = T.potrf(ad, nb=128, **kw).cpu()
    assert torch.equal(ad.cpu(), a)
    lc = T.potrf(a, nb=128, **kw)
    assert (lg - lc).abs().max().item() <= 1e-5 * lc.abs().max().item()
    assert float(T.residual_potrf(a, lg)) < n * 2e-7


# ---- the four task kernels (csrc/potrf_tile.cu, csrc/tile_ops.cu) ----------------------

TIERS = [(torch.float32, "highest"), (torch.float32, "high"), (torch.float32, "default"),
         (torch.float64, "high"), (torch.bfloat16, "high")]


def _tile_inputs(cuda, op, n, m, k, dtype, seed):
    """(c, a, b) for out = epilogue(c, a·bᵀ), made in fp32 from a seed."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype)

    if op == "trsm":  # linv (n, n) lower triangular, b (m, n)
        return None, rnd(m, n), torch.tril(rnd(n, n))
    if op == "syrk":  # c (n, n), a (n, k)
        a = rnd(n, k)
        return rnd(n, n), a, a
    return rnd(m, n), rnd(m, k), rnd(n, k)  # gemm: c (m, n), ai (m, k), aj (n, k)


def _tile_tol(dtype, c, a, b):
    """As for the trailing kernels: fp64 1e-12, fp32 1e-5 of scale =
    max|a_i|·max|b_j| (the same partial products, another order), bf16 2^-6
    of (max|c| + scale)."""
    scale = (a.double().norm(dim=1).max() * b.double().norm(dim=1).max()).item()
    cmax = 0.0 if c is None else c.double().abs().max().item()
    return {torch.float64: 1e-12 * scale, torch.float32: 1e-5 * scale,
            torch.bfloat16: 2**-6 * (cmax + scale)}[dtype]


def _call_tile(op, fn_of, c, a, b):
    if op == "trsm":
        return fn_of("trsm")(b, a)
    if op == "syrk":
        return fn_of("syrk")(c, a)
    return fn_of("gemm")(c, a, b)


@pytest.mark.parametrize("dtype,prec", TIERS)
@pytest.mark.parametrize("n,m,k", [(96, 96, 96), (512, 512, 512), (96, 200, 72),
                                   (200, 96, 72)])
@pytest.mark.parametrize("op", ["trsm", "syrk", "gemm"])
def test_tile_op_matches_plain(cuda, op, n, m, k, dtype, prec):
    """Within :func:`_tile_tol` (syrk: n × n, a (n, k); its upper triangle c's bits)."""
    if op == "trsm":
        k = n
    c, a, b = _tile_inputs(cuda, op, n, m, k, dtype, seed=n + m + k)
    kept = [None if t is None else t.clone() for t in (c, a, b)]
    counter = f"{op}_tile_launches"
    with precision.override(prec):
        ref = _call_tile(op, lambda o: getattr(tiles, f"{o}_tile_plain"), c, a, b)
        before = getattr(tiles, counter)
        out = _call_tile(op, lambda o: getattr(tiles, f"{o}_tile"), c, a, b)
        torch.cuda.synchronize()
    assert getattr(tiles, counter) == before + 1
    assert out.shape == ref.shape and out.dtype == dtype and out.is_contiguous()
    for t, t0 in zip((c, a, b), kept):  # not in place
        assert t is None or torch.equal(t, t0)
    assert (out.double() - ref.double()).abs().max().item() <= _tile_tol(dtype, c, a, b)
    if op == "syrk":  # above the diagonal c passes through bit for bit
        assert torch.equal(_bits(torch.triu(out, 1)), _bits(torch.triu(c, 1)))


def _spd_tile(cuda, n, dtype, seed, upper=float("nan")):
    """An SPD tile made in fp64 from a seed, ``upper`` above its diagonal."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, n, generator=g, device=cuda, dtype=torch.float64)
    a = (x @ x.mT + n * torch.eye(n, device=cuda, dtype=torch.float64)).to(dtype)
    return a + torch.triu(torch.full((n, n), upper, device=cuda, dtype=dtype), 1)


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("dtype,prec", TIERS[:4])
@pytest.mark.parametrize("n", [96, 512])
def test_potrf_tile_matches_plain(cuda, n, dtype, prec):
    """1e-5·max|out| for fp32 (fp64: 1e-12): the kernel rounds every product
    and difference where the plain version does."""
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, n, generator=g, device=cuda, dtype=torch.float64)
    a = (x @ x.mT + n * torch.eye(n, device=cuda, dtype=torch.float64)).to(dtype)
    a += torch.triu(torch.full((n, n), float("nan"), device=cuda, dtype=dtype), 1)
    a0 = a.clone()
    with precision.override(prec):
        lref, xref = tiles.potrf_tile_plain(a)
        before = tiles.potrf_tile_launches
        l, linv = tiles.potrf_tile(a)
        torch.cuda.synchronize()
    assert tiles.potrf_tile_launches == before + 1
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(a0))
    assert bool(torch.isfinite(l).all() and torch.isfinite(linv).all())  # lower triangle only
    rel = 1e-12 if dtype == torch.float64 else 1e-5
    for got, ref in ((l, lref), (linv, xref)):
        assert torch.equal(got, torch.tril(got))
        assert (got - ref).abs().max().item() <= rel * ref.abs().max().item()


@pytest.mark.parametrize("dtype,prec", TIERS[:4])
@pytest.mark.parametrize("nb", [50, 64, 256, 512])
def test_potrf_tile_same_bits_as_panel_factor(cuda, nb, dtype, prec):
    """Both run ``launch_diag`` of csrc/diag_block.cuh: the tile kernel's L is
    the first nb rows of ``panel_factor``'s output (m = 3·nb), bit for bit."""
    from dla_tpu_torch.kernels import panel

    g = torch.Generator(device=cuda).manual_seed(nb)
    p = torch.cat([_spd_tile(cuda, nb, dtype, seed=nb + 1),
                   torch.randn(2 * nb, nb, generator=g, device=cuda).to(dtype)])
    with precision.override(prec):
        l, _ = tiles.potrf_tile(p[:nb])
        out = panel.panel_factor(p)
        torch.cuda.synchronize()
    assert torch.equal(_bits(out[:nb]), _bits(l))


@pytest.mark.parametrize("dtype,prec", TIERS[:4])
@pytest.mark.parametrize("n", [1, 50, 96, 130, 512])
def test_potrf_tile_same_bits_as_plain(cuda, n, dtype, prec):
    """The tiled schedule rounds every element where the plain version does,
    in the same order: L and inv(L) are the plain version's bits."""
    a = _spd_tile(cuda, n, dtype, seed=n)
    with precision.override(prec):
        lref, xref = tiles.potrf_tile_plain(a)
        l, linv = tiles.potrf_tile(a)
        torch.cuda.synchronize()
    assert torch.equal(_bits(l), _bits(lref))
    assert torch.equal(_bits(linv), _bits(xref))


@pytest.mark.parametrize("dtype,prec", TIERS[:4])
def test_potrf_tile_two_launches_same_bits(cuda, dtype, prec):
    a = _spd_tile(cuda, 300, dtype, seed=3)
    with precision.override(prec):
        first = tiles.potrf_tile(a)
        second = tiles.potrf_tile(a)
        torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(_bits(x), _bits(y))


def test_potrf_tile_never_reads_above_the_diagonal(cuda):
    for dtype in (torch.float32, torch.float64):
        clean = tiles.potrf_tile(_spd_tile(cuda, 200, dtype, seed=4, upper=0.0))
        dirty = tiles.potrf_tile(_spd_tile(cuda, 200, dtype, seed=4, upper=float("nan")))
        torch.cuda.synchronize()
        for x, y in zip(clean, dirty):
            assert bool(torch.isfinite(y).all())
            assert torch.equal(_bits(x), _bits(y))


def test_diag_refused_launch_raises_and_launches_nothing(cuda, monkeypatch):
    # a tier code the C entry does not take: it returns cudaErrorInvalidValue
    # before its first launch, and the wrapper raises; nothing falls back
    from dla_tpu_torch.kernels import panel

    monkeypatch.setitem(tiles._TIER_CODE, "high", 7)
    a = _spd_tile(cuda, 128, torch.float32, seed=5, upper=0.0)
    before = (tiles.potrf_tile_launches, panel.panel_factor_launches)
    with precision.override("high"):
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            tiles.potrf_tile(a)
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            panel.panel_factor(a)
    torch.cuda.synchronize()
    assert (tiles.potrf_tile_launches, panel.panel_factor_launches) == before


def test_potrf_tile_schedule_runs_many_blocks(cuda):
    assert tiles.potrf_tile_schedule(512) == (9, 29)  # 8 tiles a side: launches 1 and 2 are widest
    assert tiles.potrf_tile_schedule(64) == (2, 1)
    with pytest.raises(ValueError, match="512"):
        tiles.potrf_tile_schedule(576)


def test_task_kernels_raise_on_what_they_do_not_take(cuda):
    z = lambda *s, **kw: torch.zeros(*s, device=cuda, **kw)  # noqa: E731
    with pytest.raises(ValueError, match="512"):
        tiles.potrf_tile(z(576, 576))
    with pytest.raises(ValueError, match="row-major"):
        tiles.potrf_tile(z(64, 64).mT)
    with pytest.raises(ValueError, match="row-major"):
        tiles.gemm_tile(z(64, 64), z(64, 64).mT, z(64, 64))
    eye = torch.eye(64, device=cuda)
    linv = torch.linalg.solve_triangular(2 * eye, eye, upper=False)  # column-major on CUDA
    if linv.stride(1) != 1:
        with pytest.raises(ValueError, match="row-major"):
            tiles.trsm_tile(linv, z(64, 64))
    with pytest.raises(ValueError, match="device"):
        tiles.syrk_tile(z(64, 64), torch.zeros(64, 64))
    with pytest.raises(TypeError, match="real"):
        tiles.potrf_tile(z(64, 64, dtype=torch.bfloat16))
    out = tiles.gemm_tile(z(64, 128)[:, :64], z(64, 32), z(64, 32))  # a row-major view is taken
    assert out.shape == (64, 64)


# ---- #6 and #8 on the tensor-core body (csrc/tile_ops.cu + csrc/trailing_wgmma.cuh) ---------

WGMMA_TIERS = [(torch.float32, "high"), (torch.float32, "default"), (torch.bfloat16, "high")]


def _tile_against_plain(op, c, a, b, prec):
    with precision.override(prec):
        ref = _call_tile(op, lambda o: getattr(tiles, f"{o}_tile_plain"), c, a, b)
        out = _call_tile(op, lambda o: getattr(tiles, f"{o}_tile"), c, a, b)
        torch.cuda.synchronize()
    assert out.shape == ref.shape and out.is_contiguous()
    return out, (out.double() - ref.double()).abs().max().item()


@pytest.mark.parametrize("dtype,prec", WGMMA_TIERS)
@pytest.mark.parametrize("m,n,k,ld", [(200, 96, 72, 72), (200, 96, 72, 130), (130, 257, 40, 40),
                                      (96, 100, 0, 8), (512, 512, 512, 16384)])
def test_tile_split_scratch_bits_of_split_pair_plain(cuda, m, n, k, ld, dtype, prec):
    # what the split kernel writes for gemm's two operands (padding included) is
    # split_pair_plain's bits, over magnitudes from subnormal to 1e3, from views of leading
    # dimension ld
    g = torch.Generator().manual_seed(m + n + k + ld)
    scale = torch.logspace(-40, 3, ld)
    big_a = (torch.randn(m, ld, generator=g) * scale).to(dtype)
    big_b = (torch.randn(n, ld, generator=g) * scale).to(dtype)
    a, b = big_a.to(cuda)[:, :k], big_b.to(cuda)[:, :k]
    c = torch.zeros(m, n, device=cuda, dtype=dtype)
    out = torch.empty(m, n, device=cuda, dtype=dtype)
    planes = tiles.tile_op_planes("gemm", dtype, prec)
    scratch = torch.full(tiles._pair_shape(m, n, k, planes), float("nan"), device=cuda,
                         dtype=torch.bfloat16)
    err = tiles._task_entry("gemm", dtype, 5, 7)(
        c.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), scratch.data_ptr(), m, n, k,
        n, ld, ld, scratch.numel() * 2, tiles._TIER_CODE[prec],
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    want = tiles.split_pair_plain(big_a[:, :k], big_b[:, :k], planes)
    assert torch.equal(scratch.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("dtype,prec", WGMMA_TIERS)
@pytest.mark.parametrize("n,k,ld", [(200, 72, 72), (200, 72, 130), (257, 40, 40), (100, 0, 8)])
def test_syrk_split_scratch_is_a_alone(cuda, n, k, ld, dtype, prec):
    # syrk's split writes A's planes once and nothing else: split_pair_plain(a, None)'s bits,
    # in a scratch of exactly that size
    g = torch.Generator().manual_seed(n + k + ld)
    big_a = (torch.randn(n, ld, generator=g) * torch.logspace(-40, 3, ld)).to(dtype)
    a = big_a.to(cuda)[:, :k]
    c = torch.zeros(n, n, device=cuda, dtype=dtype)
    out = torch.empty(n, n, device=cuda, dtype=dtype)
    planes = tiles.tile_op_planes("syrk", dtype, prec)
    scratch = torch.full(tiles._pair_shape(n, 0, k, planes), float("nan"), device=cuda,
                         dtype=torch.bfloat16)
    err = tiles._task_entry("syrk", dtype, 5, 7)(
        c.data_ptr(), a.data_ptr(), a.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, n, k,
        n, ld, ld, scratch.numel() * 2, tiles._TIER_CODE[prec],
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    want = tiles.split_pair_plain(big_a[:, :k], None, planes)
    assert torch.equal(scratch.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("dtype,prec", TIERS + [(torch.bfloat16, "highest")])
@pytest.mark.parametrize("op", ["trsm", "syrk", "gemm"])
def test_tile_body_that_ran(cuda, op, dtype, prec):
    # all three ops at fp32 high/default and bf16 run the tensor-core body, at fp32 highest
    # the simt chain and at fp64 the dmma chain; once a call, never the scalar body
    tc = dtype == torch.bfloat16 or (dtype == torch.float32 and prec != "highest")
    want = "wgmma" if tc else "dmma" if dtype == torch.float64 else "simt"
    c, a, b = _tile_inputs(cuda, op, 256, 256, 256, dtype, seed=11)
    with precision.override(prec):
        assert tiles.tile_op_body(op, dtype, prec) == want
        before = tiles.tile_body_launches()
        _call_tile(op, lambda o: getattr(tiles, f"{o}_tile"), c, a, b)
        torch.cuda.synchronize()
        after = tiles.tile_body_launches()
    assert after[want] == before[want] + 1
    assert [x for x in after if after[x] != before[x]] == [want]


@pytest.mark.parametrize("prec", ["high", "default"])
@pytest.mark.parametrize("op", ["trsm", "gemm", "syrk"])
def test_tile_op_big_shape(cuda, op, prec):
    # m=4096, n=k=2048: 32 x 16 output tiles, 32 k-steps (8 promotions); syrk n=k=2048:
    # 136 product tiles and 120 copies
    m, n, k = 4096, 2048, 2048
    if op == "syrk":
        m = n
    c, a, b = _tile_inputs(cuda, op, n, m, k, torch.float32, seed=4096 + n)
    out, err = _tile_against_plain(op, c, a, b, prec)
    assert out.shape == (m, n) and err <= _tile_tol(torch.float32, c, a, b)


@pytest.mark.parametrize("dtype,prec", WGMMA_TIERS)
@pytest.mark.parametrize("op", ["trsm", "gemm", "syrk"])
def test_tile_op_views_of_a_wide_matrix(cuda, op, dtype, prec):
    # as in the tile-task path: tiles of a 16384-wide matrix, leading dimension 16384
    g = torch.Generator(device=cuda).manual_seed(16384)
    big = torch.randn(1024, 16384, generator=g, device=cuda).to(dtype)
    if op == "trsm":  # trsm_tile(linv, b): a = the right-hand side, b = linv
        c, a, b = None, big[512:, 512:1024], torch.tril(big[:512, 1024:1536])
    elif op == "syrk":  # syrk_tile(c, a): b = a
        c, a = big[512:, 2048:2560], big[512:, :512]
        b = a
    else:
        c, a, b = big[512:, 2048:2560], big[512:, :512], big[:512, 4096:4608]
    assert a.stride(0) == 16384 and (op == "trsm" or c.stride(0) == 16384)
    _, err = _tile_against_plain(op, c, a, b, prec)
    assert err <= _tile_tol(dtype, c, a, b)


@pytest.mark.parametrize("dtype,prec", WGMMA_TIERS)
@pytest.mark.parametrize("op,m,n,k", [("gemm", 200, 300, 0), ("gemm", 200, 300, 40),
                                      ("trsm", 200, 40, 40), ("syrk", 300, 300, 0),
                                      ("syrk", 300, 300, 40)])
def test_tile_op_short_k(cuda, op, m, n, k, dtype, prec):
    # k below one 64-column stage: the split pads k to 64 with zeros; k = 0 gives c back
    c, a, b = _tile_inputs(cuda, op, n, m, k, dtype, seed=k + 1)
    out, err = _tile_against_plain(op, c, a, b, prec)
    assert err <= _tile_tol(dtype, c, a, b) if k else torch.equal(out, c)


@pytest.mark.parametrize("dtype,prec", WGMMA_TIERS)
@pytest.mark.parametrize("op", ["trsm", "gemm", "syrk"])
def test_tile_op_launches_same_bits(cuda, op, dtype, prec):
    c, a, b = _tile_inputs(cuda, op, 512, 512, 512, dtype, seed=20)
    with precision.override(prec):
        outs = [_call_tile(op, lambda o: getattr(tiles, f"{o}_tile"), c, a, b)
                for _ in range(20)]
        torch.cuda.synchronize()
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert all(torch.equal(x.view(view), outs[0].view(view)) for x in outs[1:])


@pytest.mark.parametrize("dtype,prec", WGMMA_TIERS + [(torch.float32, "highest")])
@pytest.mark.parametrize("op", ["trsm", "gemm", "syrk"])
def test_tile_op_allocates_out_and_scratch_only(cuda, op, dtype, prec):
    # one allocation for out and, on the tensor-core body, one for the split scratch, of
    # exactly their sizes (the caching allocator's own rounding aside: requested bytes);
    # syrk's scratch holds A's planes alone
    m, n, k = 512, 384, 384
    if op == "syrk":
        m = n
    c, a, b = _tile_inputs(cuda, op, n, m, k, dtype, seed=7)
    call = lambda: _call_tile(op, lambda o: getattr(tiles, f"{o}_tile"), c, a, b)  # noqa: E731
    planes = tiles.tile_op_planes(op, dtype, prec)
    rows, kpad = tiles._pair_shape(m, 0 if op == "syrk" else n, k, planes)
    nbytes = m * n * a.element_size() + rows * kpad * 2 * (planes > 0)
    keys = ("allocation.all.allocated", "requested_bytes.all.allocated")
    with precision.override(prec):
        call()
        torch.cuda.synchronize()
        before = [torch.cuda.memory_stats()[key] for key in keys]
        out = call()
        torch.cuda.synchronize()
        after = [torch.cuda.memory_stats()[key] for key in keys]
    assert [y - x for x, y in zip(before, after)] == [1 + (planes > 0), nbytes]
    del out


@pytest.mark.parametrize("op", ["trsm", "gemm", "syrk"])
def test_tile_op_refused_launch_raises(cuda, monkeypatch, op):
    # scratch one row short: the C entry refuses the launch (cudaErrorInvalidValue) and the
    # wrapper raises; nothing falls back to the scalar body or counts a launch
    real = tiles._pair_scratch
    monkeypatch.setattr(tiles, "_pair_scratch", lambda *args: real(*args)[:-1])
    c, a, b = _tile_inputs(cuda, op, 256, 256, 256, torch.float32, seed=8)
    counter = f"{op}_tile_launches"
    before = (getattr(tiles, counter), tiles.tile_body_launches())
    with precision.override("high"), pytest.raises(RuntimeError, match="CUDA error 1"):
        _call_tile(op, lambda o: getattr(tiles, f"{o}_tile"), c, a, b)
    torch.cuda.synchronize()
    assert (getattr(tiles, counter), tiles.tile_body_launches()) == before


# ---- #6 and #8 on the FMA-chain bodies (csrc/tile_ops.cu + csrc/trailing_chain.cuh) ------

CHAIN_TILE_TIERS = [(torch.float32, "highest"), (torch.float64, "high")]


def _chain_op(op, c, a, b, prec):
    """(the wrapper's output, the scalar reference's, the simt body at each
    tile edge (none for fp64: the dmma body has one)), the bodies' launch
    counts before and after the wrapper's call; trsm_tile(linv, b) takes a =
    the right-hand side, b = linv."""
    with precision.override(prec):
        before = tiles.tile_body_launches()
        out = _call_tile(op, lambda o: getattr(tiles, f"{o}_tile"), c, a, b)
        torch.cuda.synchronize()
        after = tiles.tile_body_launches()
    ref = tiles.tile_op_reference(op, c, a, b)
    edges = [tiles.tile_op_reference(op, c, a, b, tile=t)
             for t in ((64, 128) if a.dtype == torch.float32 else ())]
    torch.cuda.synchronize()
    assert tiles.tile_body_launches() == after  # the reference entries count nothing
    return out, ref, edges, before, after


CHAIN_TILE_CASES = [  # (m, n, k): the path's 512 and 256 tiles, the 96 tile, ragged, the big
    # shape, k short of one 16-column step, k = 0
    (512, 512, 512), (256, 256, 256), (96, 96, 96), (200, 96, 72), (4096, 2048, 2048),
    (130, 257, 7), (64, 300, 0),
]


@pytest.mark.parametrize("dtype,prec", CHAIN_TILE_TIERS)
@pytest.mark.parametrize("m,n,k", CHAIN_TILE_CASES)
@pytest.mark.parametrize("op", ["trsm", "gemm", "syrk"])
def test_chain_tile_op_same_bits_as_scalar_body(cuda, op, m, n, k, dtype, prec):
    if op == "trsm":  # trsm's k is n
        k = n
    if op == "syrk":  # syrk is square; its k stays
        m = n
    c, a, b = _tile_inputs(cuda, op, n, m, k, dtype, seed=m + n + k)
    out, ref, edges, before, after = _chain_op(op, c, a, b, prec)
    body = "dmma" if dtype == torch.float64 else "simt"
    assert {x: after[x] - before[x] for x in after} == {
        x: int(x == body) for x in tiles.TILE_BODIES}
    assert torch.equal(_bits(out), _bits(ref))
    for e in edges:  # the bits do not depend on the tile edge
        assert torch.equal(_bits(e), _bits(ref))
    if k == 0 and op != "trsm":  # gemm and syrk: c - (+0) = c, bit for bit
        assert torch.equal(_bits(out), _bits(c))
    if op == "syrk":  # the copy blocks and the diagonal tiles' mask: c's bits above
        assert torch.equal(_bits(torch.triu(out, 1)), _bits(torch.triu(c, 1)))


@pytest.mark.parametrize("dtype,prec", CHAIN_TILE_TIERS)
@pytest.mark.parametrize("op", ["trsm", "gemm", "syrk"])
def test_chain_tile_op_signed_zeros_and_specials(cuda, op, dtype, prec):
    # -0 in c, rows of zeros and of -0, a row whose products cancel to 0 exactly
    # (1.5 x - 1.5 x), inf and NaN: every output as the scalar body's; syrk's upper
    # triangle (-0 and NaN payloads of c among it) c's bits
    m, n, k = 130, 100, 24
    if op == "syrk":
        m = n = 130
    c, a, b = _tile_inputs(cuda, op, n, m, k if op != "trsm" else n, dtype, seed=5)
    a = a.clone()
    b = a if op == "syrk" else b.clone()
    a[0] = 0.0
    a[1] = -0.0
    a[2, 0], a[3, 1] = float("inf"), float("nan")
    a[4] = 0.0
    a[4, 0], a[4, 1] = 1.5, -1.5
    if op != "syrk":
        b[:, 1] = b[:, 0]
    if c is not None:
        c = c.clone()
        c[:, ::3] = -0.0
        if op == "syrk":
            c[0, 5:] = float("nan")
    out, ref, edges, _, _ = _chain_op(op, c, a, b, prec)
    assert torch.equal(_bits(out), _bits(ref))
    assert all(torch.equal(_bits(e), _bits(ref)) for e in edges)
    if op == "syrk":
        assert torch.equal(_bits(torch.triu(out, 1)), _bits(torch.triu(c, 1)))


@pytest.mark.parametrize("dtype,prec", CHAIN_TILE_TIERS)
@pytest.mark.parametrize("op", ["trsm", "gemm", "syrk"])
def test_chain_tile_op_unaligned_views(cuda, op, dtype, prec):
    # views into a wider matrix, as the tile-task path passes them: rows on 16 bytes (ld
    # 1028) and not (ld 1027, offset 1: the unaligned loads)
    for ld, off in ((1028, 0), (1027, 1)):
        g = torch.Generator(device=cuda).manual_seed(ld)
        big = torch.randn(1024, ld, generator=g, device=cuda, dtype=dtype)
        if op == "trsm":
            c, a, b = None, big[256:768, off:off + 256], torch.tril(big[:256, off + 300:off + 556])
        elif op == "syrk":
            c, a = big[256:556, off:off + 300], big[256:556, off + 300:off + 556]
            b = a
        else:
            c, a = big[256:768, off:off + 300], big[256:768, off + 300:off + 556]
            b = big[:300, off + 600:off + 856]
        out, ref, edges, _, _ = _chain_op(op, c, a, b, prec)
        assert torch.equal(_bits(out), _bits(ref)), (ld, off)
        assert all(torch.equal(_bits(e), _bits(ref)) for e in edges), (ld, off)


@pytest.mark.parametrize("dtype,prec", CHAIN_TILE_TIERS)
def test_chain_tile_op_20_launches_back_to_back(cuda, dtype, prec):
    # 20 queued trsm, syrk and gemm calls, each reading the last's output, as the tile-task
    # path queues them, against the same steps through the scalar body
    n = 256
    c, a, b = _tile_inputs(cuda, "gemm", n, n, n, dtype, seed=21)
    linv = torch.tril(b) / n
    steps = [lambda x: tiles.gemm_tile(c, x, b), lambda x: tiles.trsm_tile(linv, x),
             lambda x: tiles.syrk_tile(x, x / n)]
    ref_steps = [lambda y: tiles.tile_op_reference("gemm", c, y, b),
                 lambda y: tiles.tile_op_reference("trsm", None, y, linv),
                 lambda y: (lambda s: tiles.tile_op_reference("syrk", y, s, s))(y / n)]
    with precision.override(prec):
        before = tiles.tile_body_launches()
        x = a
        for t in range(20):
            x = steps[t % 3](x)
        torch.cuda.synchronize()
        after = tiles.tile_body_launches()
    body = "dmma" if dtype == torch.float64 else "simt"
    assert after[body] - before[body] == 20 and after["scalar"] == before["scalar"]
    y = a
    for t in range(20):
        y = ref_steps[t % 3](y)
    torch.cuda.synchronize()
    assert torch.equal(_bits(x), _bits(y))


def test_chain_tile_edge_on_this_card(cuda):
    # the launcher's rule against the torch model, through the bodies' counts and the grid:
    # the reference entry at the edge the model picks gives the wrapper's bits at fp32 highest,
    # and the scalar reference the dmma body's (one edge) at fp64
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype, prec in CHAIN_TILE_TIERS:
        body = "dmma" if dtype == torch.float64 else "simt"
        for m, n in ((512, 512), (4096, 2048)):
            c, a, b = _tile_inputs(cuda, "gemm", n, m, 64, dtype, seed=m)
            with precision.override(prec):
                out = tiles.gemm_tile(c, a, b)
            edge = tiles.chain_tile_edge(m, n, body, sms)
            assert edge == (128 if m == 4096 and body == "simt" else 64)
            assert torch.equal(_bits(out), _bits(tiles.tile_op_reference(
                "gemm", c, a, b, tile=edge if body == "simt" else 0)))
        for n in (2048, 4096):  # syrk counts its lower tiles: 136 < 264 <= 528 at 128
            c, a, _ = _tile_inputs(cuda, "syrk", n, n, 64, dtype, seed=n)
            with precision.override(prec):
                out = tiles.syrk_tile(c, a)
            edge = tiles.chain_tile_edge(n, n, body, sms, op="syrk")
            assert edge == (128 if n == 4096 and body == "simt" else 64)
            assert torch.equal(_bits(out), _bits(tiles.tile_op_reference(
                "syrk", c, a, a, tile=edge if body == "simt" else 0)))


def test_tile_op_reference_refuses_what_it_does_not_take(cuda):
    z = torch.zeros(64, 64, device=cuda)
    with pytest.raises(ValueError, match="trsm, syrk or gemm"):
        tiles.tile_op_reference("potrf", z, z, z)
    with pytest.raises(ValueError, match="b = a"):
        tiles.tile_op_reference("syrk", z, z, z.clone())
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        tiles.tile_op_reference("gemm", z, z, z, tile=96)
    z64 = z.double()
    with pytest.raises(ValueError, match="fp32 only"):
        tiles.tile_op_reference("gemm", z64, z64, z64, tile=64)


# ---- freivalds_device on the card ------------------------------------------------------


def test_freivalds_device_card_matches_cpu(cuda):
    """The same probe bits and the same fp32 slabs on both devices; the
    products are summed in another order, so the values agree to 1e-5
    relative above the fp32 rounding floor of one evaluation (3e-7 at
    N=1024, bump N)."""
    from dla_tpu_torch.validate import freivalds_device
    from dla_tpu_torch.validate.residual import _probe_vec

    assert torch.equal(_probe_vec(4096, 0xC0FFEE, cuda).cpu(), _probe_vec(4096, 0xC0FFEE, "cpu"))
    n = 1024
    l = torch.linalg.cholesky(T.plgsy(n, seed=51, dtype=torch.float64, device="cpu")).float()
    for factor in (l, l.to(torch.bfloat16)):
        got = float(freivalds_device(factor.to(cuda), row_chunk=256))
        ref = float(freivalds_device(factor, row_chunk=256))
        assert abs(got - ref) <= 1e-5 * ref + 3e-7
    assert float(freivalds_device(l.to(cuda), row_chunk=256)) < n * 2e-7
    bad = l.clone()
    bad[512:640, 512:640] *= 1.5
    got = float(freivalds_device(bad.to(cuda), row_chunk=256))
    assert got > 10 * n * 2e-7 and abs(got - float(freivalds_device(bad, row_chunk=256))) <= 1e-5 * got


# ---- the ring collectives and the flat-mesh planes on the card --------------------------

RING_BCAST = [  # (ndev, m, n, dtype, root, chunks, group)
    (4, 1024, 1024, torch.float64, 1, None, None),  # the factor tile: C = 32
    (4, 1536, 256, torch.float64, 2, None, None),  # C = 48, every stripe busy
    (8, 256, 8, torch.float32, 5, None, None),
    (8, 256, 8, torch.float32, 5, 16, 4),  # two sub-rings of one launch
    (8, 64, 40, torch.bfloat16, 1, 4, 2),  # four sub-rings
    (4, 96, 3, torch.float32, 3, 3, None),  # ragged: 12-byte rows, 384-byte chunks
    (4, 48, 5, torch.bfloat16, 0, 16, None),  # ragged: 10-byte rows, 30-byte chunks
    (3, 32, 7, torch.float64, 2, 1, None),  # store and forward, odd ring
    (1, 64, 16, torch.float32, 0, 4, None),  # a ring of one member: no capture
]


def _ring_members(cuda, ndev, m, n, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(m, n, generator=g, dtype=torch.float64).to(dtype).to(cuda)
            for _ in range(ndev)]


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("ndev,m,n,dtype,root,chunks,group", RING_BCAST)
def test_ring_broadcast_kernel_same_bits_as_plain(cuda, ndev, m, n, dtype, root, chunks, group):
    from dla_tpu_torch.kernels import collectives as C

    xs = _ring_members(cuda, ndev, m, n, dtype, seed=m + n + ndev)
    kept = [x.clone() for x in xs]
    before = C.ring_broadcast_launches
    out = C.ring_broadcast(xs, root, group=group, chunks=chunks)
    torch.cuda.synchronize()
    assert C.ring_broadcast_launches == before + 1
    ref = C.ring_broadcast_plain([x.cpu() for x in xs], root, group=group, chunks=chunks)
    g = group or ndev
    for d in range(ndev):
        assert _same_bits(out[d].cpu(), ref[d])
        assert _same_bits(out[d], kept[(d // g) * g + root % g])
    assert all(_same_bits(x, k) for x, k in zip(xs, kept))


RING_GATHER = [  # (ndev, m, n, dtype, group)
    (4, 1024, 1024, torch.float64, None),
    (4, 1024, 1024, torch.float64, 2),
    (8, 16, 6, torch.float32, 4),
    (8, 40, 8, torch.bfloat16, 2),
    (4, 7, 3, torch.float32, None),  # ragged
    (2, 5, 5, torch.bfloat16, 1),  # a sub-ring of one member: no step
]


@pytest.mark.parametrize("ndev,m,n,dtype,group", RING_GATHER)
def test_ring_all_gather_kernel_same_bits_as_plain(cuda, ndev, m, n, dtype, group):
    from dla_tpu_torch.kernels import collectives as C

    xs = _ring_members(cuda, ndev, m, n, dtype, seed=3 * m + n)
    before = C.ring_all_gather_launches
    out = C.ring_all_gather(xs, group=group)
    torch.cuda.synchronize()
    assert C.ring_all_gather_launches == before + 1
    ref = C.ring_all_gather_plain([x.cpu() for x in xs], group=group)
    g = group or ndev
    for d in range(ndev):
        assert out[d].shape == (g * m, n)
        assert _same_bits(out[d].cpu(), ref[d])
        r = d // g
        assert _same_bits(out[d], torch.cat(xs[r * g : (r + 1) * g]))


def test_ring_launches_back_to_back_read_no_stale_flag(cuda):
    """20 launches queued without a synchronize, the two broadcasts of a
    plane's step among them, with other roots, chunk counts and sizes each
    time: the flags are never cleared, so a stale one would hand a member an
    old slot."""
    from dla_tpu_torch.kernels import collectives as C

    outs, refs = [], []
    for i in range(20):
        ndev, m = (4, 64 * (1 + i % 3)) if i % 4 else (8, 32)
        xs = _ring_members(cuda, ndev, m, 16, torch.float32, seed=100 + i)
        cpu = [x.cpu() for x in xs]
        if i % 5 == 4:
            outs.append(C.ring_all_gather(xs, group=2))
            refs.append(C.ring_all_gather_plain(cpu, group=2))
        else:
            chunks = (None, 1, 2, 4)[i % 4]
            outs.append(C.ring_broadcast(xs, i % ndev, chunks=chunks))
            refs.append(C.ring_broadcast_plain(cpu, i % ndev, chunks=chunks))
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        assert all(_same_bits(o.cpu(), r) for o, r in zip(out, ref))


@pytest.mark.parametrize("root", [0, 1])
def test_ring_broadcast_nan_non_root_inputs_reach_no_output(cuda, root):
    """group 2 with the root at dist 0 of each sub-ring and at its last
    member, and group 4: a NaN-filled non-root block is never read."""
    from dla_tpu_torch.kernels import collectives as C

    for group in (2, 4):
        xs = _ring_members(cuda, 4, 1024, 1024, torch.float64, seed=11 + root)
        for d in range(4):
            if d % group != root:
                xs[d].fill_(float("nan"))
        out = C.ring_broadcast(xs, root, group=group)
        ref = C.ring_broadcast_plain([x.cpu() for x in xs], root, group=group)
        for d in range(4):
            assert _same_bits(out[d].cpu(), ref[d])
            assert _same_bits(out[d], xs[d // group * group + root])
            assert not out[d].isnan().any()


def test_ring_allocates_no_more_than_its_outputs(cuda):
    from dla_tpu_torch.kernels import collectives as C

    xs = _ring_members(cuda, 4, 1024, 1024, torch.float64, seed=12)
    C.ring_broadcast(xs, 1)
    C.ring_all_gather(xs)  # the flags exist before the measured calls
    torch.cuda.synchronize()
    for call, nbytes in ((lambda: C.ring_broadcast(xs, 1), 4 * 1024 * 1024 * 8),
                         (lambda: C.ring_all_gather(xs), 4 * 4 * 1024 * 1024 * 8)):
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = call()
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - before <= nbytes
        del out


def test_ring_broadcast_planes_panel_same_bits_as_plain(cuda):
    """The planes' largest panel, 15360 × 1024 fp64 on D=4 (C = 48)."""
    from dla_tpu_torch.kernels import collectives as C

    xs = _ring_members(cuda, 4, 15360, 1024, torch.float64, seed=13)
    out = C.ring_broadcast(xs, 1)
    ref = C.ring_broadcast_plain(xs, 1)  # the plain protocol, on the card
    torch.cuda.synchronize()
    assert all(_same_bits(o, r) and _same_bits(o, xs[1]) for o, r in zip(out, ref))


@pytest.mark.parametrize("min_segment,blocks", [(16, 1), (16, 2), (48, 3), (16, 40)])
def test_ring_small_units_and_ragged_stripes(cuda, monkeypatch, min_segment, blocks):
    """Pipelines of segments a few bytes long, ragged stripes and blocks with
    no bytes (the cuts of tests/test_torch_ring_schedule.py) through the
    kernel: the byte path and every flag."""
    from dla_tpu_torch.kernels import collectives as C

    cut = dict(C.CUT, min_segment=min_segment)
    xs = _ring_members(cuda, 4, 48, 5, torch.bfloat16, seed=14)
    cpu = [x.cpu() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    C._launch("ring_broadcast", xs, outs, gather=False, group=4, root=2, blocks=blocks, cut=cut)
    ys = _ring_members(cuda, 4, 7, 3, torch.float32, seed=15)
    gathered = [y.new_empty((28, 3)) for y in ys]
    C._launch("ring_all_gather", ys, gathered, gather=True, group=4, root=0, blocks=blocks,
              cut=cut)
    torch.cuda.synchronize()
    ref = C.ring_broadcast_plain(cpu, 2, chunks=16)
    assert all(_same_bits(o.cpu(), r) for o, r in zip(outs, ref))
    ref = C.ring_all_gather_plain([y.cpu() for y in ys])
    assert all(_same_bits(o.cpu(), r) for o, r in zip(gathered, ref))


def test_ring_raises_when_blocks_cannot_be_resident(cuda):
    from dla_tpu_torch.kernels import collectives as C

    xs = _ring_members(cuda, 4, 64, 16, torch.float32, seed=5)
    outs = [torch.empty_like(x) for x in xs]
    with pytest.raises(RuntimeError, match="cannot all be resident"):
        C._launch("ring_broadcast", xs, outs, gather=False, group=4, root=0, blocks=1 << 14)
    out = C.ring_broadcast(xs, 2)  # the context still works
    assert all(_same_bits(o, xs[2]) for o in out)


@pytest.mark.parametrize("gather,group", [(False, 4), (False, 2), (False, 1), (True, 4)])
def test_ring_launcher_takes_only_the_plans_sender_count(cuda, gather, group):
    """The launcher takes only the collective's own member table (the
    members that send, as ``card_launches`` lists them): a table one member
    short or one member long is refused (cudaErrorInvalidValue) without a
    launch, and the epoch stays; the record's own table then gives the plain
    version's bits."""
    import ctypes

    from dla_tpu_torch.kernels import collectives as C

    xs = _ring_members(cuda, 4, 64, 16, torch.float32, seed=6)
    outs = [x.new_empty((group * 64, 16)) if gather else torch.empty_like(x) for x in xs]
    rec = C._record(tuple(x.device for x in xs), 64 * 16 * 4, gather=gather, group=group,
                    root=0, flags={})
    epoch = C._epoch[0]
    cards, table, part_card, part_size, members = rec.args
    listed = list(members)
    missing = [d for d in range(4) if d not in listed]
    for wrong in (listed[:-1], listed + missing[:1] if missing else listed + listed[:1]):
        bad = rec._replace(args=(cards, table, part_card, (ctypes.c_int * 1)(len(wrong)),
                                 (ctypes.c_int * len(wrong))(*wrong)))
        assert C._call(C._entry(), bad, xs, outs) == 1 and C._epoch[0] == epoch
    assert C._call(C._entry(), rec, xs, outs) == 0
    torch.cuda.synchronize()
    cpu = [x.cpu() for x in xs]
    ref = (C.ring_all_gather_plain(cpu, group=group) if gather
           else C.ring_broadcast_plain(cpu, 0, group=group, chunks=4))
    assert all(_same_bits(o.cpu(), r) for o, r in zip(outs, ref))


def test_ring_raises_on_what_it_does_not_take(cuda):
    from dla_tpu_torch.kernels import collectives as C

    with pytest.raises(ValueError, match="at most 128 members"):
        C.ring_broadcast(_ring_members(cuda, 129, 16, 4, torch.float32, seed=1), 0)
    with pytest.raises(ValueError, match="contiguous"):
        C.ring_all_gather([torch.zeros(16, 8, device=cuda)[:, :4]] * 4)
    with pytest.raises(ValueError, match="all on the CPU or all on CUDA cards"):
        C.ring_broadcast([torch.zeros(16, 4, device=cuda), torch.zeros(16, 4)], 0)


@pytest.mark.parametrize("plane", ["column", "packed", "df64"])
def test_ring_planes_card_match_cpu(cuda, plane):
    """Each plane on a mesh of 4 members on the card against the same plane on
    the CPU, the plain ring there: fp64 within 1e-12·max|L| (cuSOLVER and
    cuBLAS against LAPACK), df64 within 1e-11; 2·nt − 1 ring launches."""
    from dla_tpu_torch.kernels import collectives as C
    from dla_tpu_torch.parallel import dryrun, make_flat_mesh

    n, nb = 256, 16
    before = C.ring_broadcast_launches
    res_gpu = dryrun.run_plane(plane, n, nb, make_flat_mesh(4))
    assert C.ring_broadcast_launches - before == 2 * (n // nb) - 1
    res_cpu = dryrun.run_plane(plane, n, nb, make_flat_mesh(4, device="cpu"))
    assert res_gpu < 1e-10 and res_cpu < 1e-10
    assert make_flat_mesh(4).devices[0].type == "cuda"


def test_ring_plane_factors_card_match_cpu(cuda):
    from dla_tpu_torch.parallel import (
        from_dense_cols,
        make_flat_mesh,
        potrf_column_cyclic_ring,
        to_dense_cols,
    )

    n, nb = 512, 32
    a = T.plgsy(n, seed=7, dtype=torch.float64, device="cpu")
    ls = []
    for mesh in (make_flat_mesh(4), make_flat_mesh(4, device="cpu")):
        lx = potrf_column_cyclic_ring(from_dense_cols(a, nb, mesh), nb, mesh)
        ls.append(torch.tril(to_dense_cols(lx, nb, mesh)).cpu())
    assert (ls[0] - ls[1]).abs().max().item() <= 1e-12 * ls[1].abs().max().item()


# ---- the out-of-core path (algos/oocore.py) and its native host runtime ----------------
def test_native_runtime_bits_on_this_host(cuda):
    """The native library is built with -march=native on the host that runs it: here,
    too, it must give the card generator's and the card probe's bits."""
    from dla_tpu_torch.runtime import staging as S
    from dla_tpu_torch.validate.residual import _probe_vec

    n = 300
    for dtype, tdt in ((np.float32, torch.float32), (np.float64, torch.float64)):
        with S.HostTileStore(n, dtype) as st:
            st.fill_plgsy(seed=51)
            card = T.plgsy(n, seed=51, dtype=tdt, device="cuda").cpu().numpy()
            np.testing.assert_array_equal(st.array, card)
    for p in range(2):
        seed = 0xC0FFEE ^ p
        np.testing.assert_array_equal(S.probe_x(4099, seed),
                                      _probe_vec(4099, seed, "cuda").double().cpu().numpy())


def _factor_of(store):
    n, w = store.n, store.panel
    out = np.zeros((n, n), store.dtype)
    for j in range(store.npan):
        b = store.pack(j * w, j * w, n - j * w, w)
        out[j * w :, j * w : (j + 1) * w] = b
        store.release(b)
    return np.tril(out)


def test_oocore_device_path_against_host_path(cuda):
    """N=8192 fp32 on a flat store: the card's factor and the host path's (OpenBLAS)
    both under the fp32 gate N·2e-7, and within it of each other."""
    from dla_tpu_torch.algos.oocore import potrf_outofcore
    from dla_tpu_torch.runtime.staging import HostTileStore

    n, panel, nb = 8192, 1024, 256
    gate = n * 2e-7
    with HostTileStore(n, np.float32) as a, HostTileStore(n, np.float32) as dev, \
            HostTileStore(n, np.float32) as host:
        a.fill_plgsy(seed=51)
        dev.array[:] = a.array
        host.array[:] = a.array
        stats = potrf_outofcore(dev, panel=panel, nb=nb)
        potrf_outofcore(host, panel=panel, nb=nb, host_blas=True)
        res_dev, res_host = a.freivalds_residual(dev), a.freivalds_residual(host)
        ld, lh = np.tril(dev.array), np.tril(host.array)
    assert stats["panels"] == n // panel
    assert res_dev < gate and res_host < gate, (res_dev, res_host)
    assert np.abs(ld.astype(np.float64) - lh).max() <= gate * np.abs(lh).max()


def test_oocore_20_panels_through_a_small_pool(cuda, tmp_path):
    """20 panels through a DirectPanelStore, whose pool of aligned buffers stays far
    smaller than the 210 streamed panels: a buffer refilled or released before its
    copy to the card finished would corrupt the factor. The prefetching run must give
    the bits of a run without prefetch, pass the fp64 gate and match cuSOLVER's factor
    of the dense matrix; no pool buffer stays pinned or out of the pool."""
    from dla_tpu_torch.algos.oocore import potrf_outofcore
    from dla_tpu_torch.runtime.staging import DirectPanelStore, freivalds_streaming

    n, panel = 20 * 512, 512
    ls = []
    for prefetch in (True, False):
        with DirectPanelStore(n, np.float64, path=str(tmp_path / f"p{prefetch}.bin"),
                              panel=panel, ram_cache=True) as st:
            st.fill_plgsy(seed=51)
            stats = potrf_outofcore(st, panel=panel, nb=128, prefetch=prefetch)
            assert stats["panels"] == 20 and not st._out
            assert len(st._free) < 8
            for raw in st._free:  # every buffer unpinned again
                cr = torch.cuda.cudart()
                torch.cuda.check_error(cr.cudaHostRegister(raw.ctypes.data, raw.nbytes, 0))
                torch.cuda.check_error(cr.cudaHostUnregister(raw.ctypes.data))
            assert freivalds_streaming(st, seed=51, probes=2) < 1e-10
            ls.append(_factor_of(st))
    np.testing.assert_array_equal(ls[0], ls[1])
    ref = torch.linalg.cholesky(T.plgsy(n, seed=51, dtype=torch.float64, device="cuda"))
    ref = ref.cpu().numpy()
    assert np.abs(ls[0] - ref).max() <= 1e-12 * np.abs(ref).max()


def test_oocore_panel_store_fp32_bucket_on_card(cuda, tmp_path):
    """fp32 through the panel store with height_bucket: padded rows inert, the fp32
    gate passes."""
    from dla_tpu_torch.algos.oocore import potrf_outofcore
    from dla_tpu_torch.runtime.staging import DirectPanelStore, freivalds_streaming

    n, panel = 8192, 1024
    with DirectPanelStore(n, np.float32, path=str(tmp_path / "p.bin"), panel=panel,
                          ram_cache=True) as st:
        st.fill_plgsy(seed=51)
        potrf_outofcore(st, panel=panel, nb=512, height_bucket=3072)
        assert freivalds_streaming(st, seed=51, probes=2) < n * 2e-7


def test_posv_refined_streamed_packed_on_card(cuda):
    n, nb = 4096, 1024
    lp = P.potrf_packed(P.plgsy_packed(n, nb, seed=51), n, nb)
    x, err, used = TA.posv_refined_streamed(lp, np.ones((n, 4)), seed=51, n=n, panel=nb,
                                            solver=lambda r: P.potrs_packed(lp, r, n, nb))
    assert err < 1e-10 and x.shape == (n, 4) and used <= 6


# ---- the block-cyclic plane on a member mesh on the card (parallel/potrf_dist.py) -------------
def _block_cyclic_factor(mesh, lay, **kw):
    from dla_tpu_torch import parallel as TP

    x = TP.generate_spd_block_cyclic(lay, mesh, seed=51, dtype=torch.float64)
    return torch.tril(TP.to_dense(TP.potrf_block_cyclic(x, lay, mesh, **kw), lay)).cpu()


def test_block_cyclic_generation_card_same_bits_as_cpu(cuda):
    from dla_tpu_torch import parallel as TP

    lay = TP.BlockCyclicLayout(1024, 64, 2, 4)
    for dtype in (torch.float64, torch.float32):
        card = TP.generate_spd_block_cyclic(lay, TP.make_mesh(2, 4), dtype=dtype)
        cpu = TP.generate_spd_block_cyclic(lay, TP.make_mesh(2, 4, device="cpu"), dtype=dtype)
        assert all(c.device.type == "cuda" for c in card)
        assert all(torch.equal(c.cpu(), h) for c, h in zip(card, cpu))
        assert torch.equal(TP.to_dense(card, lay).cpu(), T.plgsy(1024, dtype=dtype, device="cpu"))


@pytest.mark.parametrize("p,q", [(2, 4), (4, 2), (1, 1)])
def test_block_cyclic_factor_card_matches_cpu(cuda, p, q):
    """The member-mesh factor on the card against the same call on the CPU:
    fp64 within rtol = atol = 1e-11; the solve too, and under 1e-10."""
    from dla_tpu_torch import parallel as TP

    n, nb = 1024, 64
    lay = TP.BlockCyclicLayout(n, nb, p, q)
    card, cpu = TP.make_mesh(p, q), TP.make_mesh(p, q, device="cpu")
    lg, lc = _block_cyclic_factor(card, lay), _block_cyclic_factor(cpu, lay)
    torch.testing.assert_close(lg, lc, rtol=1e-11, atol=1e-11)
    b = torch.ones(n, 3, dtype=torch.float64)
    xs = [TP.potrs_block_cyclic(TP.from_dense(l, lay, m), b, lay, m).cpu()
          for l, m in ((lg, card), (lc, cpu))]
    torch.testing.assert_close(xs[0], xs[1], rtol=1e-10, atol=1e-12)
    a = T.plgsy(n, dtype=torch.float64, device="cpu")
    assert float(T.residual_potrf(a, lg)) < 1e-10
    from dla_tpu_torch.validate import residual_posv

    assert float(residual_posv(a, b, xs[0])) < 1e-10


def test_block_cyclic_super_steps_match_unrolled_on_card(cuda):
    from dla_tpu_torch import parallel as TP

    lay = TP.BlockCyclicLayout(2048, 32, 2, 4)  # 64 steps
    mesh = TP.make_mesh(2, 4)
    unrolled = _block_cyclic_factor(mesh, lay, unroll=True)
    for ss in (2, 7, 64):
        torch.testing.assert_close(_block_cyclic_factor(mesh, lay, unroll=False, super_steps=ss),
                                   unrolled, rtol=1e-11, atol=1e-11)


def test_session_and_distributed_driver_on_card(cuda, capsys):
    from dla_tpu_torch.cli import potrf_driver, session

    assert session.main(["--N", "2048", "--B", "128", "--p", "2", "--q", "4", "--dtype", "d",
                         "--solve", "8"]) == 0
    assert "backend=cuda" in capsys.readouterr().out
    assert potrf_driver.main(["--n", "4096", "--nb", "256", "--dtype", "s", "--mode",
                              "distributed", "--p", "2", "--q", "2"]) == 0


def test_oocore_mesh_on_card_matches_single_device(cuda):
    """The distributed out-of-core path (panels split over a 2x2 member mesh on
    the card) against the single-device path: fp64 within 1e-12·max|L|."""
    from dla_tpu_torch.algos.oocore import potrf_outofcore
    from dla_tpu_torch.parallel import make_mesh
    from dla_tpu_torch.runtime.staging import HostTileStore

    n, panel, nb = 4096, 512, 256
    ls = []
    for mesh in (make_mesh(2, 2, device=cuda), None):
        with HostTileStore(n, np.float64) as st:
            st.fill_plgsy(seed=51)
            potrf_outofcore(st, panel=panel, nb=nb, mesh=mesh)
            ls.append(np.tril(st.array))
    assert np.abs(ls[0] - ls[1]).max() <= 1e-12 * np.abs(ls[1]).max()


# ---- complex dtypes, the checked factor, the sweep harness ------------------------------------

@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_plghe_same_bits_on_card(cuda, dtype):
    for i0, j0 in [(0, 0), (131072, 17)]:
        got = T.plghe_tile(51, i0, j0, 96, 80, bump=5.0, dtype=dtype, device=cuda).cpu()
        assert torch.equal(got, T.plghe_tile(51, i0, j0, 96, 80, bump=5.0, dtype=dtype,
                                             device="cpu"))
        assert got.view(torch.float32 if dtype == torch.complex64 else torch.float64).equal(
            T.plghe_tile(51, i0, j0, 96, 80, bump=5.0, dtype=dtype, device="cpu").view(
                torch.float32 if dtype == torch.complex64 else torch.float64))  # signed zeros
    assert torch.equal(T.plghe(300, seed=7, dtype=dtype, device=cuda).cpu(),
                       T.plghe(300, seed=7, dtype=dtype, device="cpu"))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("mode,kw", [("blocked", {}), ("shrink", {"panel": "blocktrsm"}),
                                     ("masked", {}), ("blocked", {"diag_factor": "twolevel"})])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_complex_potrf_card_matches_cpu(cuda, dtype, mode, kw, uplo):
    """c/z factors on the card (cuSOLVER/cuBLAS routes) against the CPU's:
    complex128 within 1e-12, complex64 within 1e-5 of max|L|."""
    a = T.plghe(512, seed=3, dtype=dtype, device="cpu")
    if uplo == "U":
        a = torch.tril(a).conj().mT.contiguous()
    ref = T.potrf(a, nb=128, mode=mode, uplo=uplo, **kw)
    got = T.potrf(a.to(cuda), nb=128, mode=mode, uplo=uplo, **kw).cpu()
    tol = 1e-12 if dtype == torch.complex128 else 1e-5
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_complex_packed_serving_card_matches_cpu(cuda, dtype):
    n, tb = 512, 128
    tol = 1e-12 if dtype == torch.complex128 else 1e-5
    ap = P.pack_tri(T.plghe(n, seed=4, dtype=dtype, device="cpu"), tb)
    ref_l = P.potrf_packed(ap.clone(), n, tb)
    got_l = P.potrf_packed(ap.to(cuda), n, tb)
    assert (got_l.cpu() - ref_l).abs().max().item() <= tol * ref_l.abs().max().item()
    b = torch.ones((n, 3), dtype=dtype)
    for name in ("potrs_packed", "solve_inverse_packed"):
        if name == "potrs_packed":
            ref, got = P.potrs_packed(ref_l, b, n, tb), P.potrs_packed(got_l, b.to(cuda), n, tb)
        else:
            ref = P.solve_inverse_packed(P.potri_packed(ref_l.clone(), n, tb), b, n, tb)
            got = P.solve_inverse_packed(P.potri_packed(got_l.clone(), n, tb), b.to(cuda), n, tb)
        assert (got.cpu() - ref).abs().max().item() <= 10 * tol * ref.abs().max().item(), name
    with pytest.raises(ValueError, match="real dtypes only"):
        P.potrf_packed(ap.to(cuda), n, tb, trailing="pallas")


def test_complex_kernel_routes_raise_on_card(cuda):
    a = T.plghe(256, dtype=torch.complex64, device=cuda)
    with pytest.raises(TypeError, match="real"):
        T.potrf(a, nb=64, mode="blocked", trailing="pallas")
    with pytest.raises(TypeError, match="real"):
        T.potrf(a, nb=64, mode="inplace")


def test_potrf_checked_nan_input_on_card(cuda):
    from dla_tpu_torch.validate.checked import MESSAGES, potrf_checked

    a = T.plgsy(512, dtype=torch.float32, device=cuda)
    err, l = potrf_checked(a, nb=128)
    assert err.get() is None and l.device.type == "cuda"
    a[7, 3] = a[3, 7] = float("nan")
    err, _ = potrf_checked(a, nb=128)
    assert err.get() == f"{MESSAGES[0]} (`check` failed)"
    with pytest.raises(RuntimeError, match="NaNs"):
        err.throw()
    err, _ = potrf_checked(T.plgsy(512, bump=1e-4, device=cuda), nb=128)
    assert err.get() is not None


def test_driver_new_flags_on_card(cuda, capsys, tmp_path):
    from dla_tpu_torch.cli import potrf_driver

    a = np.asarray(T.plgsy(512, dtype=torch.float64, device="cpu"))
    np.save(tmp_path / "a.npy", a)
    for argv, rc in ((["--n", "512", "--nb", "128", "--dtype", "z", "--uplo", "U", "--mode",
                       "blocked"], 0),
                     (["--n", "512", "--nb", "128", "--lm", "2048", "--ioff", "512", "--joff",
                       "512", "--m", "512"], 0),
                     (["--nb", "128", "--input", str(tmp_path / "a.npy"), "--solve",
                       "refined"], 0),
                     (["--n", "512", "--nb", "128", "--checked", "--bump", "0.0001"], 3)):
        assert potrf_driver.main(argv) == rc, capsys.readouterr().out
    assert "CHECK FAILED" in capsys.readouterr().out


def test_harness_one_row_sweep_on_card(cuda, tmp_path):
    import csv

    from dla_tpu_torch.bench.harness import SweepConfig, run_sweep

    rows = run_sweep(SweepConfig(ns=(2048,), nbs=(512,), dtypes=("float32",),
                                 modes=("inplace",), repeats=1, timeout_s=600),
                     str(tmp_path / "s.csv"), echo=False)
    assert len(rows) == 1 and rows[0]["exit_code"] == 0 and rows[0]["device"] == "cuda"
    with open(tmp_path / "s.csv") as f:
        (row,) = list(csv.DictReader(f))
    assert float(row["rel_error"]) < 2048 * 2e-7 and float(row["gflops"]) > 0


def test_multihost_planes_across_two_processes_on_card(cuda, tmp_path):
    """The demo's five planes as 2 processes × 4 members sharing the card over
    gloo: every gate passes, each result equals the one-process plane's bits,
    and each process launches #11 2·nt − 1 times on each ring plane."""
    import re
    from pathlib import Path

    from torch_rendezvous import HeldRendezvous

    argv = ["-m", "dla_tpu_torch.parallel.multihost", "--nproc", "2", "--n", "256", "--nb",
            "16", "--plane", "block,potrs,column,packed,packed-df64", "--device", "cuda",
            "--backend", "gloo", "--timeout", "120", "--compare"]
    with HeldRendezvous(2) as rdv:
        procs = rdv.start(argv, (0, 1), cwd=Path(__file__).resolve().parents[1])
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert len(re.findall(r" = \S+ PASS$", outs[0], re.M)) == 5, outs[0]
    assert len(re.findall(r"the same bits: True$", outs[0], re.M)) == 5, outs[0]
    for pid, out in enumerate(outs):
        for plane in ("column", "packed", "packed-df64"):
            assert re.search(rf"^\[mh {pid}\] plane {plane}: .*ring_broadcast launches "
                             rf"{2 * (256 // 16) - 1};", out, re.M), out


# ---- members on several cards (ROADMAP A9c) ---------------------------------------------------
# Run on a host of two or more cards (four for the 2×2 and D=4 cases):
#     python -m pytest --noconftest tests/test_torch_gpu.py -q -k several_cards

@pytest.fixture
def several_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    return [torch.device("cuda", i) for i in range(min(4, torch.cuda.device_count()))]


RING_ACROSS = [  # (gather, m, n, dtype, root, group, members per card)
    (False, 1024, 1024, torch.float64, 1, None, 1),
    (False, 1024, 1024, torch.float64, 0, 2, 1),  # sub-rings across cards
    (False, 1024, 1024, torch.float64, 1, 2, 2),  # sub-rings within a card
    (False, 96, 3, torch.float32, 2, None, 2),  # ragged rows, two members a card
    (False, 48, 5, torch.bfloat16, 3, None, 1),
    (True, 1024, 1024, torch.float64, 0, None, 1),
    (True, 1024, 1024, torch.float64, 0, 2, 1),
    (True, 7, 3, torch.float32, 0, None, 2),
    (True, 40, 8, torch.bfloat16, 0, 4, 2),
]


def _spread_members(cards, per_card, m, n, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(m, n, generator=g, dtype=torch.float64).to(dtype).to(cards[d // per_card])
            for d in range(len(cards) * per_card)]


@pytest.mark.parametrize("gather,m,n,dtype,root,group,per_card", RING_ACROSS)
def test_ring_on_several_cards_same_bits_as_plain(several_cards, gather, m, n, dtype, root,
                                                  group, per_card):
    """#11/#12 over members spread over the cards (one launch per card,
    peer pointers over NVLink): each output on its member's card, with the
    plain version's bits, one launch counted."""
    from dla_tpu_torch.kernels import collectives as C

    xs = _spread_members(several_cards, per_card, m, n, dtype, seed=m + n + per_card)
    cpu = [x.cpu() for x in xs]
    if gather:
        before = C.ring_all_gather_launches
        out = C.ring_all_gather(xs, group=group)
        ref = C.ring_all_gather_plain(cpu, group=group)
        assert C.ring_all_gather_launches == before + 1
    else:
        before = C.ring_broadcast_launches
        out = C.ring_broadcast(xs, root, group=group)
        ref = C.ring_broadcast_plain(cpu, root, group=group)
        assert C.ring_broadcast_launches == before + 1
    for d, (o, r) in enumerate(zip(out, ref)):
        assert o.device == xs[d].device
        assert _same_bits(o.cpu(), r), f"member {d}"


def test_ring_on_several_cards_20_launches_back_to_back(several_cards):
    """Broadcasts and all-gathers of other cuts and groups, enqueued back to
    back without a wait across the cards, each held to its plain version:
    no flag that one launch left on any card satisfies a wait of the next."""
    from dla_tpu_torch.kernels import collectives as C

    outs, refs = [], []
    for i in range(20):
        per_card = 1 + i % 2
        xs = _spread_members(several_cards, per_card, 64 * (1 + i % 3), 16, torch.float32,
                             seed=200 + i)
        cpu = [x.cpu() for x in xs]
        group = (None, 2, len(xs))[i % 3]
        if i % 4 == 3:
            outs.append(C.ring_all_gather(xs, group=group))
            refs.append(C.ring_all_gather_plain(cpu, group=group))
        else:
            outs.append(C.ring_broadcast(xs, i % len(xs), group=group))
            refs.append(C.ring_broadcast_plain(cpu, i % len(xs), group=group))
    for out, ref in zip(outs, refs):
        assert all(_same_bits(o.cpu(), r) for o, r in zip(out, ref))


@pytest.mark.parametrize("gather", [False, True])
def test_ring_on_several_cards_while_a_receiver_runs_a_long_kernel(several_cards, gather):
    """Every card but the first is busy with a long kernel (about 50 ms) on
    its stream when the collective is enqueued: the senders wait on the
    device for each receiver's stream to reach the collective, and every
    output has the plain version's bits."""
    from dla_tpu_torch.kernels import collectives as C

    xs = _spread_members(several_cards, 1, 1024, 1024, torch.float64, seed=21)
    cpu = [x.cpu() for x in xs]
    for c in several_cards[1:]:
        with torch.cuda.device(c):
            torch.cuda._sleep(100_000_000)
    out = C.ring_all_gather(xs) if gather else C.ring_broadcast(xs, 0)
    ref = C.ring_all_gather_plain(cpu) if gather else C.ring_broadcast_plain(cpu, 0)
    assert all(_same_bits(o.cpu(), r) for o, r in zip(out, ref))


@pytest.mark.parametrize("gather", [False, True])
def test_ring_on_several_cards_output_reuses_memory_just_freed(several_cards, gather):
    """On every card a tensor of the output's size is filled by a kernel
    queued behind a long one, then freed at once: the collective's outputs
    take that memory from the caching allocator while the fill has not run
    yet. No hop writes into it before the receiver's stream has passed the
    fill, so every output has the plain version's bits."""
    from dla_tpu_torch.kernels import collectives as C

    m, n, d = 1024, 1024, len(several_cards)
    xs = _spread_members(several_cards, 1, m, n, torch.float64, seed=22)
    cpu = [x.cpu() for x in xs]
    torch.cuda.synchronize()
    freed = []
    for c in several_cards:
        with torch.cuda.device(c):
            junk = torch.empty(((d if gather else 1) * m, n), dtype=torch.float64, device=c)
            torch.cuda._sleep(100_000_000)
            junk.fill_(7.0)
            freed.append(junk.data_ptr())
            del junk
    out = C.ring_all_gather(xs) if gather else C.ring_broadcast(xs, 0)
    assert [o.data_ptr() for o in out] == freed, "the outputs did not reuse the freed memory"
    ref = C.ring_all_gather_plain(cpu) if gather else C.ring_broadcast_plain(cpu, 0)
    assert all(_same_bits(o.cpu(), r) for o, r in zip(out, ref))


def test_several_cards_without_peer_access_raise(several_cards, monkeypatch):
    """Two cards that cannot reach each other (the check patched to say no):
    the mesh and the ring raise naming them; nothing falls back to the host
    or to one card."""
    from dla_tpu_torch import parallel as TP
    from dla_tpu_torch.kernels import collectives as C

    no = lambda a, b: {a, b} != {0, 1}  # noqa: E731
    monkeypatch.setattr(TP.member_comm, "_peer_access", no)
    monkeypatch.setattr(C, "_peer_access", no)
    monkeypatch.setattr(C, "_peers", set())
    with pytest.raises(RuntimeError, match="cards 0 and 1"):
        TP.make_flat_mesh(len(several_cards))
    xs = _spread_members(several_cards, 1, 64, 8, torch.float32, seed=3)
    before = C.ring_broadcast_launches
    with pytest.raises(RuntimeError, match="card 0 to write card 1"):
        C.ring_broadcast(xs, 0)
    assert C.ring_broadcast_launches == before


def _block_factor(mesh, lay, **kw):
    from dla_tpu_torch import parallel as TP

    x = TP.generate_spd_block_cyclic(lay, mesh, seed=51, dtype=torch.float64)
    lx = TP.potrf_block_cyclic(x, lay, mesh, **kw)
    assert [s.device for s in lx] == list(mesh.devices)
    return lx, TP.to_dense(lx, lay).tril_().cpu()


@pytest.mark.parametrize("p,q", [(2, 2), (2, 4)])
def test_block_cyclic_on_several_cards_same_bits_as_one_card(several_cards, p, q):
    """potrf_block_cyclic (unrolled and super-stepped) and potrs_block_cyclic
    on a mesh spread over the cards against the same mesh on one card: the
    same bits (the same products on cards of one model)."""
    from dla_tpu_torch import parallel as TP

    if len(several_cards) < 4:
        pytest.skip("needs four cards")
    n, nb = 2048, 64
    lay = TP.BlockCyclicLayout(n, nb, p, q)
    spread, one = TP.make_mesh(p, q), TP.make_mesh(p, q, device="cuda:0")
    assert spread.cards == several_cards[:4]
    b = torch.from_numpy(np.random.default_rng(4).standard_normal((n, 5)))
    for kw in ({"unroll": True}, {"unroll": False, "super_steps": 3}):
        (lxs, ls), (lx1, l1) = _block_factor(spread, lay, **kw), _block_factor(one, lay, **kw)
        assert torch.equal(ls, l1), kw
        assert float(T.residual_potrf(T.plgsy(n, dtype=torch.float64, device="cpu"), ls)) < 1e-10
    xs_ = TP.potrs_block_cyclic(lxs, b, lay, spread)
    x1 = TP.potrs_block_cyclic(lx1, b, lay, one)
    assert xs_.device == torch.device("cuda", 0) and torch.equal(xs_, x1)


@pytest.mark.parametrize("kind", ["column", "packed", "df64"])
def test_ring_planes_on_several_cards_same_bits_as_one_card(several_cards, kind):
    """The three ring planes with one member per card (D = the cards, up to
    4) against the same plane on one card: the same bits."""
    from dla_tpu_torch.parallel import dryrun, make_flat_mesh

    d, nb = len(several_cards), 64
    n = 4 * nb * d
    got = []
    for mesh in (make_flat_mesh(d), make_flat_mesh(d, device="cuda:0")):
        pl = dryrun.plane(kind, n, nb, mesh)
        got.append(pl.dense(pl.factor(pl.shard(pl.matrix()))).cpu())
    assert len(set(make_flat_mesh(d).devices)) == d
    assert torch.equal(got[0], got[1])


def _cudart_register_log(monkeypatch):
    """Every cudaHostRegister / cudaHostUnregister call (address, flags), passed on."""
    real = torch.cuda.cudart()
    log = {"register": [], "unregister": []}

    class Logged:
        def cudaHostRegister(self, ptr, nbytes, flags):
            log["register"].append((ptr, flags))
            return real.cudaHostRegister(ptr, nbytes, flags)

        def cudaHostUnregister(self, ptr):
            log["unregister"].append(ptr)
            return real.cudaHostUnregister(ptr)

        def __getattr__(self, name):
            return getattr(real, name)

    monkeypatch.setattr(torch.cuda, "cudart", lambda: Logged())
    return log


@pytest.mark.parametrize("kind", ["flat", "panel"])
def test_oocore_on_several_cards_same_bits_as_card_0(several_cards, tmp_path, monkeypatch, kind):
    """potrf_outofcore on a 2×2 mesh spread over the cards against the same
    mesh on card 0, fp64 N=4096: the same bits, under 1e-10, also after a
    crash after panel 2 and a resume in a fresh store. On the panel store
    every pool buffer is registered once (portable, for every card) and
    unregistered once, and none stays out of the pool."""
    from dla_tpu_torch.algos.oocore import potrf_outofcore
    from dla_tpu_torch.parallel import make_mesh
    from dla_tpu_torch.runtime.staging import DirectPanelStore, HostTileStore

    if len(several_cards) < 4:
        pytest.skip("needs four cards")
    n, panel, nb = 4096, 512, 256
    spread, one = make_mesh(2, 2), make_mesh(2, 2, device="cuda:0")
    assert spread.cards == several_cards[:4]

    def store(name):
        if kind == "flat":
            return HostTileStore(n, np.float64, path=str(tmp_path / name))
        return DirectPanelStore(n, np.float64, path=str(tmp_path / name), panel=panel,
                                ram_cache=True)

    def lower(st):
        return np.tril(st.array) if kind == "flat" else _factor_of(st)

    def crash_after_two(j, npan):
        if j == 1:
            raise RuntimeError("crash")

    got = {}
    for name, mesh in (("spread", spread), ("one", one)):
        log = _cudart_register_log(monkeypatch)
        with store(f"{name}.bin") as st:
            st.fill_plgsy(seed=51)
            stats = potrf_outofcore(st, panel=panel, nb=nb, mesh=mesh)
            got[name] = lower(st)
            assert stats["panels"] == n // panel
            if kind == "panel":
                ptrs = [p for p, _ in log["register"]]
                assert ptrs and len(set(ptrs)) == len(ptrs), "a pool buffer registered twice"
                assert {f for _, f in log["register"]} == {1}  # cudaHostRegisterPortable
                assert sorted(log["unregister"]) == sorted(ptrs) and not st._out
        monkeypatch.undo()
    assert np.array_equal(got["spread"], got["one"])
    a = T.plgsy(n, seed=51, dtype=torch.float64, device="cpu")
    assert float(T.residual_potrf(a, torch.from_numpy(got["spread"]))) < 1e-10
    prog = str(tmp_path / "progress.json")
    with store("resumed.bin") as st:
        st.fill_plgsy(seed=51)
        with pytest.raises(RuntimeError, match="crash"):
            potrf_outofcore(st, panel=panel, nb=nb, mesh=spread, progress_path=prog,
                            on_panel=crash_after_two)
    with store("resumed.bin") as st:
        stats = potrf_outofcore(st, panel=panel, nb=nb, mesh=spread, progress_path=prog)
        assert stats["panels"] == n // panel - 2
        assert np.array_equal(lower(st), got["one"])


def test_serving_across_processes_over_nccl_on_several_cards(several_cards, tmp_path):
    """solve_inverse_sharded across one process per card over NCCL, one
    member each (``tests/torch_serving_child.py``, fp64 n=4096, nrhs=8):
    every process returns X, the bits of one process on as many members."""
    import re
    from pathlib import Path

    from torch_rendezvous import HeldRendezvous

    procs = len(several_cards)
    root = Path(__file__).resolve().parents[1]
    argv = [str(root / "tests" / "torch_serving_child.py"), "--nproc", str(procs), "--members",
            "1", "--n", "4096", "--nrhs", "8", "--dtype", "float64", "--device", "cuda",
            "--backend", "nccl", "--timeout", "120", "--queries", "3", "--compare",
            "--save", str(tmp_path)]
    with HeldRendezvous(procs) as rdv:
        children = rdv.start(argv, range(procs), cwd=root)
        try:
            outs = [p.communicate(timeout=300)[0] for p in children]
        finally:
            for p in children:
                if p.poll() is None:
                    p.kill()
    assert [p.returncode for p in children] == [0] * procs, outs
    assert re.search(r"^\[serve 0\] in one process on \d+ members: \S+ ms a query block; the "
                     r"same bits: True$", outs[0], re.M), outs[0]
    assert re.search(r" \(gate 1e-10\) PASS$", outs[0], re.M), outs[0]
    xs = [np.load(tmp_path / f"x{pid}.npy") for pid in range(procs)]
    assert all(np.array_equal(x, xs[0]) for x in xs)
    for pid, out in enumerate(outs):
        assert re.search(rf"^\[serve {pid}\] {procs} processes x 1 members on cuda:{pid}, backend "
                         rf"nccl: .* boundary {procs} broadcasts", out, re.M), out
