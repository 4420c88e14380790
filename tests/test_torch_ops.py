"""dla_tpu_torch ops, utils and packaging held against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; JAX runs on
the CPU with x64 (tests/conftest.py).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dla_tpu import ops as jops
from dla_tpu.utils import flops as jflops
from dla_tpu_torch import ops as tops
from dla_tpu_torch.ops import lapack_like as tlapack
from dla_tpu_torch.utils import flops as tflops
from dla_tpu_torch.utils.config import RunConfig
from dla_tpu_torch.utils import precision as tprec
from dla_tpu_torch.utils.interop import from_numpy, to_numpy
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = Path(__file__).resolve().parents[1]
PAIRS = {jnp.float32: torch.float32, jnp.float64: torch.float64}


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


class TestPlgsy:
    """The generator must match the JAX package bit for bit."""

    @pytest.mark.parametrize("jdt", [jnp.float32, jnp.float64])
    @pytest.mark.parametrize("seed", [0, 51, 2**31 + 5, 0xFFFFFFFF])
    @pytest.mark.parametrize("i0,j0,bump", [
        (0, 0, 0.0), (131072, 7, 3.5), (5, 131000, 64.0), (130000, 130010, 1e3),
    ])
    def test_tile_bit_identical(self, jdt, seed, i0, j0, bump):
        ref = np.asarray(jops.plgsy_tile(seed, i0, j0, 37, 41, bump=bump, dtype=jdt))
        got = tops.plgsy_tile(seed, i0, j0, 37, 41, bump=bump, dtype=PAIRS[jdt], device="cpu").numpy()
        assert _bits_equal(ref, got)

    @pytest.mark.parametrize("jdt", [jnp.float32, jnp.float64])
    @pytest.mark.parametrize("n,bump", [(1, None), (96, None), (200, 0.0), (128, 7.25)])
    def test_full_bit_identical(self, jdt, n, bump):
        ref = np.asarray(jops.plgsy(n, bump=bump, seed=9, dtype=jdt))
        got = tops.plgsy(n, bump=bump, seed=9, dtype=PAIRS[jdt], device="cpu").numpy()
        assert _bits_equal(ref, got)

    def test_slabs_match_one_tile(self, monkeypatch):
        monkeypatch.setattr(tlapack, "_SLAB_ELEMS", 5 * 64)  # 5-row slabs
        got = tops.plgsy(64, seed=3, device="cpu")
        ref = tops.plgsy_tile(3, 0, 0, 64, 64, bump=64.0, device="cpu")
        assert torch.equal(got, ref)

    def test_symmetric_and_spd(self):
        a = tops.plgsy(128, seed=1, dtype=torch.float64, device="cpu")
        assert torch.equal(a, a.mT)
        assert torch.linalg.eigvalsh(a).min() > 0


class TestBlas:
    @pytest.mark.parametrize("norm", ["M", "1", "O", "I", "F"])
    def test_lange(self, norm):
        a = np.random.default_rng(1).standard_normal((17, 23))
        ref = float(jops.lange(norm, jnp.asarray(a)))
        got = float(tops.lange(norm, torch.from_numpy(a)))
        assert got == pytest.approx(ref, rel=1e-14)

    def test_lange_rejects_unknown(self):
        with pytest.raises(ValueError):
            tops.lange("X", torch.zeros(2, 2))

    @pytest.mark.parametrize("transa", [False, True])
    @pytest.mark.parametrize("transb", [False, True])
    @pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (-1.0, 1.0), (0.5, -2.0)])
    def test_gemm(self, transa, transb, alpha, beta):
        rng = np.random.default_rng(2)
        a, b, c = rng.standard_normal((3, 24, 24))
        ref = np.asarray(jops.gemm(alpha, jnp.asarray(a), jnp.asarray(b), beta,
                                   jnp.asarray(c), transa=transa, transb=transb))
        got = tops.gemm(alpha, torch.from_numpy(a), torch.from_numpy(b), beta,
                        torch.from_numpy(c), transa=transa, transb=transb).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("conja,conjb", [(True, False), (False, True), (True, True)])
    def test_gemm_conj(self, conja, conjb):
        rng = np.random.default_rng(3)
        a, b, c = rng.standard_normal((3, 16, 16)) + 1j * rng.standard_normal((3, 16, 16))
        ref = np.asarray(jops.gemm(-1.0, jnp.asarray(a), jnp.asarray(b), 1.0, jnp.asarray(c),
                                   transb=True, conja=conja, conjb=conjb))
        got = tops.gemm(-1.0, torch.from_numpy(a), torch.from_numpy(b), 1.0, torch.from_numpy(c),
                        transb=True, conja=conja, conjb=conjb).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)

    def test_gemm_bf16_accumulates_fp32(self):
        rng = np.random.default_rng(4)
        a, b, c = (x.astype(ml_dtypes.bfloat16) for x in rng.standard_normal((3, 32, 32)))
        ref = np.asarray(jops.gemm(1.0, jnp.asarray(a), jnp.asarray(b), 1.0, jnp.asarray(c)))
        got = to_numpy(tops.gemm(1.0, from_numpy(a, device="cpu"), from_numpy(b, device="cpu"),
                                 1.0, from_numpy(c, device="cpu")))
        assert got.dtype == ref.dtype
        np.testing.assert_allclose(got.astype(np.float32), ref.astype(np.float32),
                                   rtol=2**-7, atol=2**-7)

    def test_gemm_default_tier_rounds_operands_to_bf16(self):
        rng = np.random.default_rng(5)
        a, b = (torch.from_numpy(x.astype(np.float32)) for x in rng.standard_normal((2, 32, 64)))
        c = torch.zeros(32, 32)
        with tprec.override("default"):
            got = tops.gemm(1.0, a, b, 0.0, c, transb=True)
        ref = a.bfloat16().double() @ b.bfloat16().double().mT
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-5)
        with tprec.override("highest"):
            exact = tops.gemm(1.0, a, b, 0.0, c, transb=True)
        assert not torch.allclose(got, exact, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("uplo", ["L", "U"])
    @pytest.mark.parametrize("trans", [False, True])
    def test_syrk(self, uplo, trans):
        rng = np.random.default_rng(6)
        a, c = rng.standard_normal((2, 20, 20))
        ref = np.asarray(jops.syrk(-1.0, jnp.asarray(a), 1.0, jnp.asarray(c), uplo=uplo, trans=trans))
        got = tops.syrk(-1.0, torch.from_numpy(a), 1.0, torch.from_numpy(c), uplo=uplo,
                        trans=trans).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("side", ["L", "R"])
    @pytest.mark.parametrize("uplo", ["L", "U"])
    @pytest.mark.parametrize("transa", [False, True])
    @pytest.mark.parametrize("unit_diag", [False, True])
    def test_trsm(self, side, uplo, transa, unit_diag):
        rng = np.random.default_rng(7)
        n = 24
        t = np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
        a = t if uplo == "L" else t.T
        # garbage in the unused triangle must not be read
        junk = np.triu(np.full((n, n), 9.5), 1)
        a = a + (junk if uplo == "L" else junk.T)
        b = rng.standard_normal((n, 16) if side == "L" else (16, n))
        kw = dict(side=side, uplo=uplo, transa=transa, unit_diag=unit_diag)
        ref = np.asarray(jops.trsm(2.0, jnp.asarray(a), jnp.asarray(b), **kw))
        got = tops.trsm(2.0, torch.from_numpy(a), torch.from_numpy(b), **kw).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("transa", [False, True])
    def test_trsm_conj(self, transa):
        rng = np.random.default_rng(8)
        n = 12
        a = np.tril(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))) + n * np.eye(n)
        b = rng.standard_normal((8, n)) + 1j * rng.standard_normal((8, n))
        ref = np.asarray(jops.trsm(1.0, jnp.asarray(a), jnp.asarray(b), transa=transa, conja=True))
        got = tops.trsm(1.0, torch.from_numpy(a), torch.from_numpy(b), transa=transa,
                        conja=True).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


class TestUtils:
    def test_precision_names_and_env(self, monkeypatch):
        monkeypatch.delenv("DLA_TPU_MATMUL_PRECISION", raising=False)
        assert tprec.DEFAULT == "high" and tprec.matmul_precision() == "high"
        monkeypatch.setenv("DLA_TPU_MATMUL_PRECISION", "float32")
        assert tprec.matmul_precision() == "float32" and tprec.tier() == "highest"
        with tprec.override("fastest"):
            assert tprec.tier() == "default"
            with tprec.override(None):
                assert tprec.matmul_precision() == "fastest"
        assert tprec.matmul_precision() == "float32"
        monkeypatch.setenv("DLA_TPU_MATMUL_PRECISION", "tf32")
        with pytest.raises(ValueError):
            tprec.matmul_precision()
        with pytest.raises(ValueError):
            with tprec.override("tf32"):
                pass

    def test_tf32_pinned_off(self):
        torch.backends.cuda.matmul.allow_tf32 = True
        tprec.pin_ieee_fp32()
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False

    @pytest.mark.parametrize("n", [1, 16000])
    def test_flops_copy(self, n):
        assert tflops.potrf_flops(n) == jflops.potrf_flops(n)
        assert tflops.gflops(2e9, 0.5) == jflops.gflops(2e9, 0.5)

    def test_config_copy_layers_env(self):
        cfg = RunConfig.layered(env={"CHOLESKY_N": "640", "CHOLESKY_B": "64"}, nb=128, dtype="s")
        assert (cfg.n, cfg.nb, cfg.dtype) == (640, 128, "float32")
        with pytest.raises(ValueError):
            RunConfig(dtype="q")

    @pytest.mark.parametrize("jdt", [jnp.float32, jnp.float64, jnp.bfloat16])
    def test_interop_round_trip(self, jdt):
        x = np.asarray(jnp.asarray(np.random.default_rng(9).standard_normal((5, 7)), jdt))
        t = from_numpy(x, device="cpu")
        back = to_numpy(t)
        assert back.dtype == x.dtype and _bits_equal(back, x)
        t.fill_(0)  # the tensor owns its memory
        assert np.abs(x.astype(np.float64)).max() > 0
        assert from_numpy(x, device="cpu", dtype=torch.float64).dtype == torch.float64


class TestGeneratorDevice:
    @pytest.mark.parametrize("gen", ["plgsy", "plgsy_tile", "plgsy_packed", "to_df64", "plghe",
                                     "plghe_tile", "spd_gershgorin"])
    def test_default_is_the_card(self, gen):
        """The generators build on the card unless the caller names another
        device: on a machine with no card the default call raises rather
        than quietly producing a CPU tensor."""
        import dla_tpu_torch as T
        import dla_tpu_torch.algos as TA
        from dla_tpu_torch.ops import to_df64

        call = {
            "plgsy": lambda **kw: T.plgsy(64, **kw),
            "plgsy_tile": lambda **kw: T.plgsy_tile(51, 0, 0, 8, 8, **kw),
            "plgsy_packed": lambda **kw: TA.plgsy_packed(64, 32, **kw),
            "to_df64": lambda **kw: to_df64(np.eye(8), **kw)[0],
            "plghe": lambda **kw: T.plghe(16, **kw),
            "plghe_tile": lambda **kw: T.plghe_tile(51, 0, 0, 8, 8, **kw),
            "spd_gershgorin": lambda **kw: T.spd_gershgorin(16, **kw),
        }[gen]
        assert call(device="cpu").device.type == "cpu"
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()


class TestNoJax:
    def test_imports_with_jax_blocked(self):
        code = ("import sys; sys.modules['jax'] = None; sys.modules['dla_tpu'] = None\n"
                "import dla_tpu_torch, dla_tpu_torch.cli.potrf_driver\n"
                "import dla_tpu_torch.cli.session, dla_tpu_torch.bench.bench\n"
                "import dla_tpu_torch.kernels._build, dla_tpu_torch.tiles\n"
                "import dla_tpu_torch.kernels.collectives, dla_tpu_torch.parallel\n"
                "import dla_tpu_torch.parallel.dryrun\n"
                "print(sorted(dla_tpu_torch.__all__))")
        env = dict(os.environ, PYTHONPATH=str(REPO))
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert "potrf_packed" in proc.stdout and "TileLayout" in proc.stdout

    @pytest.mark.parametrize("path", sorted(
        str(p.relative_to(REPO)) for p in (REPO / "dla_tpu_torch").rglob("*.py")
    ) + ["chip_smoke.py"])
    def test_no_jax_or_dla_tpu_import(self, path):
        tree = ast.parse((REPO / path).read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "dla_tpu", "flax", "optax"), (path, name)


def _top_level_names(init: Path) -> set[str]:
    """The public names an ``__init__.py`` imports at its top level, read
    through ``ast`` (the port may not import ``dla_tpu``)."""
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


class TestTopLevelExports:
    # names of dla_tpu's top level that the port does not have yet: none
    MISSING = set()

    def test_port_exports_only_reference_names(self):
        ref = _top_level_names(REPO / "dla_tpu" / "__init__.py")
        port = _top_level_names(REPO / "dla_tpu_torch" / "__init__.py") - {"pin_ieee_fp32"}
        assert port <= ref, f"not top-level names of dla_tpu: {sorted(port - ref)}"
        assert ref - port == self.MISSING

    def test_all_matches_the_imports(self):
        import dla_tpu_torch as T

        port = _top_level_names(REPO / "dla_tpu_torch" / "__init__.py") - {"pin_ieee_fp32"}
        assert set(T.__all__) == port
        assert all(hasattr(T, n) for n in T.__all__)

    @pytest.mark.parametrize("name", ["potrf_inplace", "potrf_shrink", "plgsy_packed",
                                      "freivalds_packed"])
    def test_algos_only_names(self, name):
        """The reference keeps these under ``algos`` only; so does the port."""
        import dla_tpu_torch as T
        import dla_tpu_torch.algos as TA

        assert name in TA.__all__ and name not in T.__all__
        defined = {node.name for f in (REPO / "dla_tpu" / "algos").glob("*.py")
                   for node in ast.parse(f.read_text()).body
                   if isinstance(node, ast.FunctionDef)}
        assert name in defined
