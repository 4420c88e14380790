"""The split planes of P that the trailing kernels' tensor-core body reads,
held against the JAX reference, and the table that picks a body.

On a CUDA tensor the trailing kernels (#1 ``trailing_update_lower``, #2
``trailing_update_packed``) run fp32 ``high`` and ``default`` and bf16
storage on the tensor cores: a split kernel first writes P as bf16 planes
(``csrc/trailing_wgmma.cuh``), whose bits ``tiles.split_plain`` gives in
torch ops (the card tests hold the kernel to it). Here ``split_plain`` is
held to the ``ahi``/``alo`` of the reference's ``_dot_nt``
(``dla_tpu/kernels/pallas_tiles.py:68-88``), bit for bit, on seeded numpy
input that includes bf16 rounding ties and subnormals.

XLA on the CPU flushes subnormals (``x − hi`` of a subnormal difference, and
subnormal inputs, become ±0); the port keeps them, as IEEE fp32 and the card
do. Those elements are the only ones allowed to differ, and there the
port's lo is below the smallest normal fp32 in magnitude.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dla_tpu.kernels.pallas_tiles import _dot_nt
from dla_tpu.utils import precision as jprec
from dla_tpu_torch.kernels import tiles
from dla_tpu_torch.kernels.tiles import split_plain, split_planes, trailing_body
from dla_tpu_torch.utils import precision as tprec
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TINY = np.finfo(np.float32).tiny  # the smallest normal fp32, 2^-126


def _ties(rng, n):
    """fp32 values exactly half a bf16 ulp off a bf16 value (rounding ties),
    and one fp32 ulp either side of such a tie."""
    v = rng.standard_normal(n).astype(ml_dtypes.bfloat16).astype(np.float32)
    half = np.ldexp(np.float32(1), np.frexp(v)[1] - 9).astype(np.float32)  # half a bf16 ulp
    tie = (v + half).astype(np.float32)
    return np.concatenate([tie, np.nextafter(tie, np.float32(np.inf)),
                           np.nextafter(tie, np.float32(-np.inf)), (v - half).astype(np.float32)])


def _panel(w, nb, seed, special):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((w, nb)).astype(np.float32)
    if special:
        extra = np.concatenate([
            _ties(rng, 64),
            (rng.standard_normal(32) * 1e-39).astype(np.float32),  # subnormal inputs
            (rng.standard_normal(32) * 2e-38).astype(np.float32),  # normal, lo subnormal
            np.float32([0.0, -0.0, 1.0, -1.0, 3e38, -3e38, TINY, -TINY]),
        ])
        flat = p.reshape(-1)
        k = min(extra.size, flat.size)
        flat[rng.choice(flat.size, k, replace=False)] = rng.permutation(extra)[:k]
    return p


def _jax_planes(p):
    """``ahi`` and ``alo`` exactly as the reference's ``_dot_nt`` forms them."""
    a = jnp.asarray(p)
    ahi = a.astype(jnp.bfloat16)
    alo = (a - ahi.astype(jnp.float32)).astype(jnp.bfloat16)
    return np.asarray(ahi), np.asarray(alo)


def _bits(x):
    return np.asarray(x).view(np.uint16)


def _port_planes(p, planes):
    return split_plain(torch.from_numpy(p), planes).view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("w,nb", [(96, 32), (200, 100), (128, 64), (37, 7)])
@pytest.mark.parametrize("special", [False, True])
def test_split_planes_bits_of_jax(w, nb, special):
    p = _panel(w, nb, seed=w * 1000 + nb, special=special)
    got = _port_planes(p, 2)
    wpad, kpad = -(-w // 128) * 128, -(-nb // 64) * 64
    assert got.shape == (2, wpad, kpad)
    pad = np.ones((wpad, kpad), bool)
    pad[:w, :nb] = False
    assert not got[:, pad].any(), "padding must be +0"
    ahi, alo = _jax_planes(p)
    assert np.array_equal(got[0, :w, :nb], _bits(ahi))
    lo = got[1, :w, :nb]
    differ = lo != _bits(alo)
    lo_f = lo.view(ml_dtypes.bfloat16).astype(np.float32)
    # only where XLA flushed a subnormal: the reference's lo is ±0, the port's tiny
    assert not (differ & (_bits(alo) & 0x7FFF != 0)).any()
    assert (np.abs(lo_f[differ]) < TINY).all()
    assert differ.any() == special  # the special values do meet the flush


def test_split_one_plane_is_bf16_of_p():
    p = _panel(200, 100, seed=5, special=True)
    got = _port_planes(p, 1)
    assert got.shape == (1, 256, 128)
    assert np.array_equal(got[0, :200, :100], _bits(p.astype(ml_dtypes.bfloat16)))
    assert not got[0, 200:].any() and not got[0, :, 100:].any()


def test_split_of_bf16_storage_is_a_copy():
    p = torch.from_numpy(_panel(96, 40, seed=9, special=False)).to(torch.bfloat16)
    got = split_plain(p, 1)
    assert torch.equal(got[0, :96, :40].view(torch.int16), p.view(torch.int16))


def test_split_of_strided_panel_view():
    big = torch.from_numpy(_panel(96, 64, seed=11, special=True))
    view = big[:, 8:40]
    assert view.stride(0) == 64
    assert torch.equal(split_plain(view, 2).view(torch.int16),
                       split_plain(view.contiguous(), 2).view(torch.int16))


@pytest.mark.parametrize("w,nb", [(96, 32), (64, 100)])
def test_split_planes_rebuild_jax_dot_nt_at_high(w, nb):
    # _dot_nt(a, I) at high is ahi + (0 + alo): the planes sum to it in fp32 exactly
    p = _panel(w, nb, seed=w + nb, special=False)
    with jprec.override("high"):
        ref = np.asarray(_dot_nt(jnp.asarray(p), jnp.eye(nb, dtype=jnp.float32)))
    planes = split_plain(torch.from_numpy(p), 2).float()
    got = (planes[0, :w, :nb] + planes[1, :w, :nb]).numpy()
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_split_planes_give_the_plain_product():
    # the tensor-core body's sums, hi·hiᵀ + (hi·loᵀ + lo·hiᵀ), are the plain
    # version's bf16x3 products: the same fp32 operations on the same planes
    p = torch.from_numpy(_panel(96, 48, seed=3, special=False))
    q = torch.from_numpy(_panel(64, 48, seed=4, special=False))
    sp, sq = split_plain(p, 2).float(), split_plain(q, 2).float()
    hp, lp = sp[0, :96, :48], sp[1, :96, :48]
    hq, lq = sq[0, :64, :48], sq[1, :64, :48]
    want = hp @ hq.mT + (hp @ lq.mT + lp @ hq.mT)
    with tprec.override("high"):
        got = tiles._dot_nt_plain(p, q)
    assert torch.equal(got, want)


BODY_TABLE = [  # (dtype, tier, planes)
    (torch.float32, "high", 2),
    (torch.float32, "default", 1),
    (torch.bfloat16, "high", 1),
    (torch.bfloat16, "default", 1),
    (torch.bfloat16, "highest", 1),
    (torch.float32, "highest", 0),
    (torch.float64, "high", 0),
    (torch.float64, "default", 0),
    (torch.float64, "highest", 0),
]


@pytest.mark.parametrize("dtype,tier_name,planes", BODY_TABLE)
def test_body_dispatch_table(dtype, tier_name, planes):
    assert split_planes(dtype, tier_name) == planes
    chain = "dmma" if dtype == torch.float64 else "simt"  # the FMA-chain bodies
    assert trailing_body(dtype, tier_name) == ("wgmma" if planes else chain)


def test_cpu_route_allocates_no_split(monkeypatch):
    # on the CPU the wrappers run the plain versions and never split P
    def boom(*a, **k):
        raise AssertionError("the CPU route split P")

    monkeypatch.setattr(tiles, "_split_scratch", boom)
    monkeypatch.setattr(tiles, "split_plain", boom)
    rng = np.random.default_rng(0)
    c = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    with tprec.override("high"):
        ref = tiles.trailing_update_lower_plain(c.clone(), p, tb=32)
        out = tiles.trailing_update_lower(c.clone(), p, tb=32)
    assert torch.equal(out, ref)
