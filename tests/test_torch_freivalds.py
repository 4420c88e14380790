"""dla_tpu_torch's ``freivalds_device`` held against the JAX function.

The probe vectors must carry the reference's bits: the native runtime draws
the same vector, so gates are comparable between the packages and with the
out-of-core runs.

Tolerance of the gate's value. Both packages evaluate (A·x − L·(Lᵀx)) in
fp32, with their products summed in different orders, so each evaluation
carries its own fp32 rounding noise of about N·eps·||A||·||x|| in the
numerator: an absolute floor of about 3e-7 on the value at N=512. The two
values agree to 1e-5 relative above that floor. For a good fp32 factor the
value *is* that noise (both read ~7e-7), so there only the floor and the
gate can be asserted; a bf16 factor (~9e-4) and a perturbed factor (≫ the
gate) sit far above it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dla_tpu.ops import plgsy as jax_plgsy
from dla_tpu.validate.residual import _probe_vec_jnp
from dla_tpu.validate.residual import freivalds_device as jax_freivalds_device
from dla_tpu_torch.utils.interop import from_numpy
from dla_tpu_torch.validate import freivalds_device
from dla_tpu_torch.validate.residual import _probe_vec
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N, RC = 512, 128
FLOOR = 3e-7  # fp32 rounding noise of one evaluation at N=512, see above
GATE = N * 2e-7  # the driver's fp32 gate


@pytest.fixture(scope="module")
def factor():
    """The fp64 Cholesky factor of the seeded matrix, rounded to fp32."""
    a = np.asarray(jax_plgsy(N, seed=51, dtype=jnp.float32)).astype(np.float64)
    return np.linalg.cholesky(a).astype(np.float32)


def _both(l_np, **kw):
    ref = float(jax_freivalds_device(jnp.asarray(l_np), row_chunk=RC, **kw))
    got = float(freivalds_device(from_numpy(l_np, device="cpu"), row_chunk=RC, **kw))
    return got, ref


@pytest.mark.parametrize("n", [1, 7, 4096])
@pytest.mark.parametrize("seed", [0, 51, 0xC0FFEE ^ 1])
def test_probe_vector_bits(n, seed):
    ref = np.asarray(_probe_vec_jnp(n, seed))
    got = _probe_vec(n, seed, "cpu").numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    assert (got >= -0.5).all() and (got < 0.5).all()


def test_good_fp32_factor(factor):
    got, ref = _both(factor)
    assert got < GATE and ref < GATE
    assert abs(got - ref) <= 1e-5 * ref + FLOOR


def test_bf16_factor_read_natively(factor):
    lb = jnp.asarray(factor).astype(jnp.bfloat16)
    ref = float(jax_freivalds_device(lb, row_chunk=RC))
    tb = from_numpy(np.asarray(lb), device="cpu")
    assert tb.dtype == torch.bfloat16
    got = float(freivalds_device(tb, row_chunk=RC))
    assert abs(got - ref) <= 1e-5 * ref + FLOOR
    assert 1e-4 < got < N**0.5 * 2e-4  # bf16 rounding of L, under the bf16 gate


def test_perturbed_factor_reads_large_in_both(factor):
    bad = factor.copy()
    bad[300:364, 300:364] *= 1.5  # one corrupted diagonal tile
    got, ref = _both(bad)
    assert got > 10 * GATE and ref > 10 * GATE
    assert abs(got - ref) <= 1e-5 * ref


def test_upper_triangle_is_ignored(factor):
    dirty = factor + np.triu(np.full((N, N), 1e30, np.float32), 1)
    clean = float(freivalds_device(from_numpy(factor, device="cpu"), row_chunk=RC))
    assert float(freivalds_device(from_numpy(dirty, device="cpu"), row_chunk=RC)) == clean


def test_seed_bump_and_probes(factor):
    """Another seed's matrix is not this factor's; more probes never read lower."""
    got, ref = _both(factor, seed=7)
    assert got > GATE and abs(got - ref) <= 1e-5 * ref
    one, _ = _both(factor, probes=1)
    four, ref4 = _both(factor, probes=4)
    assert four >= one and abs(four - ref4) <= 1e-5 * ref4 + FLOOR


def test_row_chunk_must_divide_n(factor):
    l = from_numpy(factor, device="cpu")
    with pytest.raises(ValueError) as want:
        jax_freivalds_device(jnp.asarray(factor), row_chunk=100)
    with pytest.raises(ValueError) as err:
        freivalds_device(l, row_chunk=100)
    assert str(err.value) == str(want.value)
    with pytest.raises(ValueError):
        freivalds_device(l)  # the default row_chunk=4096 does not divide 512


def test_input_untouched(factor):
    l = from_numpy(factor, device="cpu")
    freivalds_device(l, row_chunk=RC)
    assert np.array_equal(l.numpy(), factor)
