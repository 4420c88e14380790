"""``_sqrt_rn``, the correctly rounded square root behind the plain
diagonal-block factors, held to ``numpy.sqrt`` bit for bit on the CPU.

Torch's CPU sqrt misses the correctly rounded root by an ulp on a few
inputs in a thousand, in fp64 as in fp32. The plain versions of #4 and #5
(``_factor_lower_plain``) and ``potrf_unblocked`` take every pivot from
``_sqrt_rn``, so they give the bits of the same rank-1 loop written in
numpy.
"""

import numpy as np
import pytest
import torch

from dla_tpu_torch.kernels import tiles
from dla_tpu_torch.ops.lapack_like import _sqrt_rn, potrf_unblocked
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}


def _draws(dtype: str, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(1.0, 100.0, n).astype(DTYPES[dtype][0])


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_sqrt_rn_is_numpy_sqrt_on_a_vector(dtype):
    x = _draws(dtype, 20_000, seed=11)
    got = _sqrt_rn(torch.from_numpy(x))
    assert got.dtype == DTYPES[dtype][1]
    assert _same_bits(got.numpy(), np.sqrt(x))


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_sqrt_rn_is_numpy_sqrt_on_0d_tensors(dtype):
    x = _draws(dtype, 5_000, seed=12)
    got = np.array([_sqrt_rn(torch.from_numpy(np.array(v))).numpy() for v in x])
    assert got.dtype == x.dtype
    assert _same_bits(got, np.sqrt(x))


def test_sqrt_rn_of_a_view_leaves_its_base_alone():
    a = torch.from_numpy(_draws("f64", 16, seed=13).reshape(4, 4))
    kept = a.clone()
    root = _sqrt_rn(a[2, 2])
    assert root.ndim == 0 and root.item() == np.sqrt(kept[2, 2].item())
    assert torch.equal(a, kept)


def _rank1_numpy(a: np.ndarray) -> np.ndarray:
    """tril(L) by the plain versions' rank-1 steps, in numpy."""
    l = np.tril(a)
    n = a.shape[0]
    for j in range(n):
        piv = np.sqrt(l[j, j])
        l[j, j] = piv
        col = l[j + 1 :, j] / piv
        l[j + 1 :, j] = col
        l[j + 1 :, j + 1 :] -= np.outer(col, col)
    return np.tril(l)


@pytest.mark.parametrize("factor", ["potrf_unblocked", "factor_lower_plain"])
def test_plain_factors_take_numpy_pivots_at_n50(factor):
    n = 50
    g = np.random.default_rng(50)
    b = g.standard_normal((n, n))
    a = b @ b.T + n * np.eye(n)
    fn = potrf_unblocked if factor == "potrf_unblocked" else tiles._factor_lower_plain
    got = fn(torch.from_numpy(a.copy())).numpy()
    want = _rank1_numpy(a)
    assert _same_bits(np.diag(got).copy(), np.diag(want).copy())
    assert _same_bits(got, want)
