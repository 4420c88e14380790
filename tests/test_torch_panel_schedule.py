"""The schedule of kernel #3 ``panel_apply`` (``csrc/panel_apply.cu``) run in
torch ops, held against the plain version and against JAX's Pallas kernel;
and the schedule of kernel #4 ``panel_factor`` (``csrc/panel_factor.cu``):
its body table, launches and split scratch, and its product through the
same model of the bodies.

On the card one C call launches the products of
``panel.panel_apply_schedule``: for each ib-wide column block j a correction
rhs = B_j − X_{<j}·L_{j,<j}ᵀ over k = j·ib columns (j > 0), then X_j =
rhs·inv(L_jj)ᵀ, each product on the task kernels' block bodies
(``csrc/tile_body.cuh``). The model here runs those same products: at fp32
``high``/``default`` through ``tiles.split_pair_plain`` and the model of the
tensor-core body's sums (``_body_model`` of tests/test_torch_tile_split.py:
fresh fp32 partials every 256 columns of k, promoted into a running sum, the
cross terms at ``high``), at ``highest`` as IEEE fp32 products (the ``simt``
chain's FMAs, summed in another order). X starts as NaN, so a product that
read a block before it was written would show.

The results are not the plain version's bits: the correction sums over all
j·ib columns at once where the reference subtracts block by block. They
must agree with ``panel_apply_plain`` and with JAX's ``panel_apply``
(interpret mode) at the card tests' tolerances (tests/test_torch_gpu.py):
1e-4 of max|X| at ``high`` and ``highest``, 2^-6 at ``default``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dla_tpu.kernels.pallas_tiles import panel_apply as jax_panel_apply
from dla_tpu.kernels.pallas_tiles import panel_factor as jax_panel_factor
from dla_tpu.utils import precision as jprec
from dla_tpu_torch.kernels import panel, tiles
from dla_tpu_torch.kernels.panel import (
    PanelProduct,
    panel_apply_body,
    panel_apply_planes,
    panel_apply_plain,
    panel_apply_schedule,
)
from dla_tpu_torch.utils import precision as tprec
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from test_torch_tile_split import _body_model


def _product(a, b, planes):
    """A·Bᵀ as the body of the tier sums it."""
    if planes:
        return _body_model(a, b, planes)
    return a @ b.mT


def _run_schedule(lkk, b, ib, planes):
    """X from the schedule's products, one after the other, as the C call
    launches them; each split must fit the schedule's scratch."""
    m, nb = b.shape
    sched = panel_apply_schedule(m, nb, ib, planes=planes)
    dinv = panel._diag_inverses(lkk, ib)
    x = torch.full((m, nb), float("nan"))
    rhs = torch.full((m, ib), float("nan"))
    for p in sched.products:
        j = p.col
        if p.epilogue == "gemm":
            a, bt = x[:, :j], lkk[j : j + ib, :j]
        else:
            a, bt = (b[:, :ib] if j == 0 else rhs), dinv[j : j + ib]
        assert (a.shape, bt.shape) == ((p.m, p.k), (p.n, p.k))
        if planes:
            rows, kpad = tiles._pair_shape(p.m, p.n, p.k, planes)
            assert rows * kpad <= sched.scratch[0] * sched.scratch[1]
        prod = _product(a, bt, planes)
        if p.epilogue == "gemm":
            rhs = b[:, j : j + ib] - prod
        else:
            x[:, j : j + ib] = prod
    return x


def _inputs(m, nb):
    rng = np.random.default_rng(m + 7 * nb)
    lkk = np.tril(rng.standard_normal((nb, nb))) + nb * np.eye(nb)
    return lkk.astype(np.float32), rng.standard_normal((m, nb)).astype(np.float32)


CASES = [  # (m, nb, ib): nk = nb / ib
    (128, 32, 8),  # nk = 4, every k below one 64-column stage
    (100, 40, 20),  # nk = 2, m not a multiple of 128 (nor of 64)
    (256, 256, 256),  # nk = 1: the product with the inverse alone
    (256, 1024, 256),  # nk = 4, corrections over 256, 512, 768 columns (up to 3 promotions)
]


@pytest.mark.parametrize("prec", ["high", "default", "highest"])
@pytest.mark.parametrize("m,nb,ib", CASES)
def test_schedule_matches_plain_and_jax(m, nb, ib, prec):
    lkk_np, b_np = _inputs(m, nb)
    lkk, b = torch.from_numpy(lkk_np), torch.from_numpy(b_np)
    b_before = b.clone()
    with tprec.override(prec):
        got = _run_schedule(lkk, b, ib, panel_apply_planes(prec))
        plain = panel_apply_plain(lkk, b, ib=ib, tb=m)
    assert torch.equal(b, b_before)  # B is only read
    assert torch.isfinite(got).all()
    tol = (2**-6 if prec == "default" else 1e-4) * plain.abs().max().item()
    assert (got - plain).abs().max().item() <= tol
    with jprec.override(prec):
        ref = np.asarray(jax_panel_apply(jnp.asarray(lkk_np), jnp.asarray(b_np), ib=ib, tb=m))
    assert np.abs(got.numpy() - ref).max() <= tol


@pytest.mark.parametrize("m,nb,ib", CASES + [(15360, 1024, 256), (15360, 1024, 512),
                                             (1024, 1024, 1024), (3000, 1024, 256)])
@pytest.mark.parametrize("planes", [2, 1, 0])
def test_schedule_products_and_scratch(m, nb, ib, planes):
    sched = panel_apply_schedule(m, nb, ib, planes=planes)
    nk = nb // ib
    assert len(sched.products) == 2 * nk - 1
    want = [PanelProduct("trsm", 0, m, ib, ib)]
    for j in range(1, nk):
        want += [PanelProduct("gemm", j * ib, m, ib, j * ib), PanelProduct("trsm", j * ib, m,
                                                                          ib, ib)]
    assert list(sched.products) == want
    assert sched.launches == (2 if planes else 1) * (2 * nk - 1)
    if not planes:
        assert sched.scratch is None
        return
    # the largest product's planes: planes × (m and ib padded to 128) rows × k padded to 64
    pad = lambda x, q: -(-x // q) * q  # noqa: E731
    kmax = max(ib, nb - ib)
    assert sched.scratch == (planes * (pad(m, 128) + pad(ib, 128)), max(64, pad(kmax, 64)))


def test_scratch_at_the_paths_first_panel():
    # m=15360, nb=1024, ib=256 at high: 2 x (15360 + 256) rows of 768 bf16, ≈ 48 MB
    rows, kpad = panel_apply_schedule(15360, 1024, 256, planes=2).scratch
    assert (rows, kpad) == (31232, 768) and rows * kpad * 2 == 47_972_352


@pytest.mark.parametrize("prec,planes,body", [("high", 2, "wgmma"), ("default", 1, "wgmma"),
                                              ("highest", 0, "simt")])
def test_body_table(prec, planes, body):
    assert panel_apply_planes(prec) == planes == tiles.split_planes(torch.float32, prec)
    assert panel_apply_body(prec) == body
    with tprec.override(prec):  # the schedule takes the current tier's planes by default
        assert panel_apply_schedule(64, 32, 16) == panel_apply_schedule(64, 32, 16, planes=planes)


def test_cpu_route_builds_no_scratch(monkeypatch):
    # on the CPU the wrapper runs the plain version: no schedule, no split scratch
    def boom(*a, **k):
        raise AssertionError("the CPU route built the kernel's scratch")

    monkeypatch.setattr(panel, "_split_scratch", boom)
    monkeypatch.setattr(panel, "panel_apply_schedule", boom)
    lkk_np, b_np = _inputs(64, 32)
    lkk, b = torch.from_numpy(lkk_np), torch.from_numpy(b_np)
    with tprec.override("high"):
        assert torch.equal(panel.panel_apply(lkk, b, ib=16), panel_apply_plain(lkk, b, ib=16))


# ---- #4 panel_factor: the body table, the schedule, the product's model ------------

FACTOR_BODIES = [  # (dtype, tier, planes, body): the task kernels' table
    (torch.float32, "high", 2, "wgmma"), (torch.float32, "default", 1, "wgmma"),
    (torch.float32, "highest", 0, "simt"), (torch.float64, "high", 0, "dmma"),
    (torch.float64, "default", 0, "dmma"), (torch.float64, "highest", 0, "dmma"),
]


@pytest.mark.parametrize("dtype,prec,planes,body", FACTOR_BODIES)
def test_panel_factor_body_table(dtype, prec, planes, body):
    assert panel.panel_factor_body(dtype, prec) == body == tiles.tile_op_body("trsm", dtype, prec)
    assert tiles.split_planes(dtype, prec) == planes
    assert panel.panel_factor_schedule(256, 64, dtype, prec).body == body


def test_panel_factor_body_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32/float64"):
        panel.panel_factor_body(torch.bfloat16, "high")


@pytest.mark.parametrize("m,nb", [(32768, 512), (8192, 512), (150, 50), (192, 64), (1024, 512),
                                  (64, 64), (512, 512), (3 * 100, 100)])
@pytest.mark.parametrize("dtype,prec,planes,body", FACTOR_BODIES)
def test_panel_factor_schedule_launches_and_scratch(m, nb, dtype, prec, planes, body):
    sched = panel.panel_factor_schedule(m, nb, dtype, prec)
    diag = -(-nb // 64) + 1  # the diagonal phase: one stage a 64-wide tile column, and one more
    if m == nb:  # no rows below the block: the diagonal phase alone, counted through the body
        assert sched == (body, diag, None)
        return
    assert sched.body == body
    assert sched.launches == diag + (2 if planes else 1)
    if not planes:
        assert sched.scratch is None
        return
    # tc_scratch_bytes(planes, m - nb, nb, nb) of csrc/tile_body.cuh: both operands' planes,
    # rows padded to 128, k to 64 (at least 64), bf16
    pad = lambda x, q: -(-x // q) * q  # noqa: E731
    rows, kpad = sched.scratch
    assert rows == planes * (pad(m - nb, 128) + pad(nb, 128)) and kpad == max(64, pad(nb, 64))
    assert sched.scratch == tiles._pair_shape(m - nb, nb, nb, planes)


def test_panel_factor_scratch_at_the_paths_first_panel():
    # m=32768, nb=512 at high: 2 x (32256 + 512) rows of 512 bf16, ≈ 67 MB; default one plane
    sched = panel.panel_factor_schedule(32768, 512, torch.float32, "high")
    rows, kpad = sched.scratch
    assert (rows, kpad) == (65536, 512) and rows * kpad * 2 == 67_108_864
    assert sched.launches == 9 + 2
    rows, kpad = panel.panel_factor_schedule(32768, 512, torch.float32, "default").scratch
    assert rows * kpad * 2 == 33_554_432


def test_panel_factor_cpu_route_builds_no_scratch(monkeypatch):
    # on the CPU the wrapper runs the plain version: no schedule, no split scratch, no C call,
    # and no launch counted
    def boom(*a, **k):
        raise AssertionError("the CPU route reached the kernel's set-up")

    for name in ("_split_scratch", "panel_factor_schedule", "_kernel"):
        monkeypatch.setattr(panel, name, boom)
    rng = np.random.default_rng(5)
    g = rng.standard_normal((64, 64))
    p = torch.from_numpy(np.vstack([g @ g.T + 64 * np.eye(64), rng.standard_normal((128, 64))]))
    before = panel.panel_factor_launches
    for prec in ("high", "default", "highest"):
        with tprec.override(prec):
            for dtype in (torch.float32, torch.float64):
                x = p.to(dtype)
                assert torch.equal(panel.panel_factor(x), panel.panel_factor_plain(x))
    assert panel.panel_factor_launches == before


def _factor_product(p, nb, dtype, prec):
    """#4's output as the C call forms it: the diagonal block as the plain
    version (the diagonal phase's bits, held on the card), then out[nb:] =
    p[nb:]·inv(L_kk)ᵀ through the body of the tier (the tensor-core body's
    sums at ``high``/``default``, IEEE products on the chain bodies)."""
    l = tiles._factor_lower_plain(p[:nb])
    linv = tiles._invert_lower_plain(l)
    planes = tiles.split_planes(dtype, prec)
    below = _body_model(p[nb:], linv, planes) if planes else p[nb:] @ linv.mT
    return torch.cat([l, below.to(dtype)])


@pytest.mark.parametrize("m,nb,dtype,prec", [
    (384, 128, torch.float32, "high"), (640, 320, torch.float32, "high"),  # k=320: 2 promotions
    (384, 128, torch.float32, "default"), (640, 320, torch.float32, "default"),
    (150, 50, torch.float32, "high"),  # nb off the 64-column step, m - nb off 128
    (256, 64, torch.float32, "highest"), (256, 64, torch.float64, "high"),
])
def test_panel_factor_product_matches_plain_and_jax(m, nb, dtype, prec):
    # the card tests' tolerances: 1e-5·max|L| against the plain version (fp64 1e-12), whose
    # products take the same bf16 operands; against JAX's interpret-mode kernel 2^-6 at
    # default (XLA on the CPU multiplies in fp32 there)
    rng = np.random.default_rng(m + nb)
    g = rng.standard_normal((m, m))
    p_np = np.tril(g @ g.T + m * np.eye(m))[:, :nb]
    p_np[:nb] += np.triu(np.full((nb, nb), np.nan), 1)  # never read
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    p = torch.from_numpy(p_np.astype(np_dtype))
    with tprec.override(prec):
        got = _factor_product(p, nb, dtype, prec)
        plain = panel.panel_factor_plain(p)
    assert torch.isfinite(got).all()
    scale = plain.abs().max().item()
    assert (got.double() - plain.double()).abs().max().item() <= (
        1e-12 if dtype == torch.float64 else 1e-5) * scale
    with jprec.override(prec):
        ref = np.asarray(jax_panel_factor(jnp.asarray(p_np.astype(np_dtype))))
    tol = 1e-12 if dtype == torch.float64 else (2**-6 if prec == "default" else 1e-5)
    assert np.abs(got.double().numpy() - ref).max() <= tol * scale
