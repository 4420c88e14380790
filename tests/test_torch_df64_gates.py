"""The df64 gates see the factor (ROADMAP watch item 9): each of the five
df64 gates of ``algos/potrf_df64.py`` must rise with a known relative
perturbation δ of tril(L), in the port and in JAX, by the rule of
``tests/test_torch_block_cyclic.py::TestGatesSeeTheFactor``: never below the
unperturbed factor's value (its floor), and within [δ/2, 5δ] once δ is ten
times the floor. δ runs from 1e-14 to 1e-8 around the gates' 1e-10.

A is the seeded generator's matrix ``plgsy(256, seed=51)``, exactly fp32 (the
gates that stream A make it from that seed); L is its fp64 Cholesky factor,
perturbed and split into a df64 (hi, lo) pair. Both packages get the same
numpy pairs, and read the same values at every δ. The one exception to the
rule, the two residual gates at δ = 1e-14, is the reference's as well
(``BELOW_THE_FLOOR``).
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dla_tpu_torch.algos.packed import pack_tri
from dla_tpu_torch.ops import plgsy
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

JP = importlib.import_module("dla_tpu.algos.potrf_df64")
TP = importlib.import_module("dla_tpu_torch.algos.potrf_df64")

N, NB, CHUNK = 256, 64, 128
DELTAS = [1e-14, 1e-13, 1e-12, 1e-11, 1e-10, 1e-9, 1e-8]


def _a():
    return plgsy(N, seed=51, dtype=torch.float32, device="cpu").numpy()


def _pair(l64):
    hi = l64.astype(np.float32)
    return hi, (l64 - hi.astype(np.float64)).astype(np.float32)


def _packed(x):
    return pack_tri(torch.from_numpy(x), NB).numpy()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _port(gate, a, lh, ll):
    z = np.zeros_like(a)
    if gate == "residual_potrf_df64":
        return float(TP.residual_potrf_df64(_t(a), _t(z), _t(lh), _t(ll), row_chunk=CHUNK))
    if gate == "residual_potrf_df64_blocked":
        return TP.residual_potrf_df64_blocked(_t(a), _t(z), _t(lh), _t(ll), rc=CHUNK)
    if gate == "freivalds_potrf_df64":
        return float(TP.freivalds_potrf_df64(_t(lh), _t(ll), _t(a), None, row_chunk=CHUNK))
    if gate == "freivalds_packed_df64":
        return TP.freivalds_packed_df64(_t(_packed(lh)), _t(_packed(ll)), N, NB, row_chunk=CHUNK)
    return TP.freivalds_potrf_df64_gen(_t(lh), _t(ll), row_chunk=CHUNK)


def _jax(gate, a, lh, ll):
    a, z, jh, jl = jnp.asarray(a), jnp.zeros_like(jnp.asarray(a)), jnp.asarray(lh), jnp.asarray(ll)
    if gate == "residual_potrf_df64":
        return float(JP.residual_potrf_df64(a, z, jh, jl, row_chunk=CHUNK))
    if gate == "residual_potrf_df64_blocked":
        return float(JP.residual_potrf_df64_blocked(a, z, jh, jl, rc=CHUNK))
    if gate == "freivalds_potrf_df64":
        return float(JP.freivalds_potrf_df64(jh, jl, a, None, row_chunk=CHUNK))
    if gate == "freivalds_packed_df64":
        return float(JP.freivalds_packed_df64(jnp.asarray(_packed(lh)), jnp.asarray(_packed(ll)),
                                              N, NB, row_chunk=CHUNK))
    return float(JP.freivalds_potrf_df64_gen(jh, jl, row_chunk=CHUNK))


GATES = ["residual_potrf_df64", "residual_potrf_df64_blocked", "freivalds_potrf_df64",
         "freivalds_packed_df64", "freivalds_potrf_df64_gen"]

#: (gate, δ) where the reading falls below the unperturbed floor, in both
#: packages alike: the residual gates' floor is the df64 product's own error
#: (9.7e-14 here, 30x the pair's true fp64 residual of 3.2e-15), so a δ under
#: it moves only that error, which may fall (ROADMAP watch item 5).
BELOW_THE_FLOOR = {("residual_potrf_df64", 1e-14), ("residual_potrf_df64_blocked", 1e-14)}


@functools.lru_cache(maxsize=None)
def _readings(gate, package):
    """The gate at δ = 0 and each of DELTAS."""
    a = _a()
    l = np.linalg.cholesky(a.astype(np.float64))
    r = np.random.default_rng(0).uniform(-1.0, 1.0, l.shape)
    value = _port if package == "port" else _jax
    return [value(gate, a, *_pair(np.tril(l * (1.0 + d * r)))) for d in [0.0] + DELTAS]


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("gate", GATES)
def test_df64_gate_rises_with_the_perturbation(gate, package):
    got = _readings(gate, package)
    floor, seen = got[0], []
    for delta, v in zip(DELTAS, got[1:]):
        if (gate, delta) not in BELOW_THE_FLOOR:
            assert v >= floor * (1 - 1e-3), (delta, v, floor)
        if delta >= 10 * floor:
            assert delta / 2 <= v <= 5 * delta, (delta, v, got)
            seen.append(v)
    assert len(seen) >= 2 and seen == sorted(seen), got


@pytest.mark.parametrize("gate", GATES)
def test_the_port_reads_as_jax_at_every_delta(gate):
    for p, j in zip(_readings(gate, "port"), _readings(gate, "jax"), strict=True):
        assert abs(p - j) <= 1e-5 * j, (p, j)


@pytest.mark.parametrize("gate,delta", sorted(BELOW_THE_FLOOR))
def test_the_reference_reads_below_its_floor_there_too(gate, delta):
    """The exceptions above are JAX's as well: both packages fall below the
    floor at that δ, so the port carries the reference's behaviour."""
    k = 1 + DELTAS.index(delta)
    for package in ("port", "jax"):
        got = _readings(gate, package)
        assert got[k] < got[0] * (1 - 1e-3), (package, got)
