"""Layered run configuration: JSON file ⊕ environment ⊕ CLI flags.

A copy of ``dla_tpu/utils/config.py``: it is framework-neutral, but
importing anything under ``dla_tpu`` imports jax, which the port never does.

The reference layers four config mechanisms (SURVEY §5.6): env vars
(``CHOLESKY_N``/``CHOLESKY_B``, StarPU knobs), CLI flags (positional and
``getopt_long``), JSON ``appsettings.json`` merged with env
(``client_distrib.cpp:329``), and compiled-in sweep tables. Here the same
layering is one dataclass: JSON profile < environment < explicit flags,
and the sweep table is a JSON benchmark profile instead of recompiled C
arrays (``benchmark.c:76-101``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any


@dataclasses.dataclass
class RunConfig:
    """One factorization run's parameters (the descriptor + problem spec)."""

    n: int = 12
    nb: int = 4
    dtype: str = "float32"  # d/s aliases accepted (reference dtype map)
    uplo: str = "L"
    bump: float | None = None  # default: N (dplgsy-style)
    seed: int = 51
    p: int = 1
    q: int = 1
    mode: str = "blocked"  # blocked | masked | shrink | distributed
    check: bool = True  # residual validation
    gen: str = "plgsy"  # plgsy | gershgorin

    DTYPE_ALIASES = {
        "d": "float64",
        "s": "float32",
        "h": "bfloat16",
        "z": "complex128",  # reference dtype map d/s/z/c
        "c": "complex64",   # (v3_script_cholesky_x_arg_gpt.c:25-33)
        "float64": "float64",
        "float32": "float32",
        "bfloat16": "bfloat16",
        "complex128": "complex128",
        "complex64": "complex64",
    }

    def __post_init__(self):
        key = self.dtype.lower()
        if key not in self.DTYPE_ALIASES:
            raise ValueError(
                f"unknown dtype {self.dtype!r}; expected one of "
                f"{sorted(self.DTYPE_ALIASES)}"
            )
        self.dtype = self.DTYPE_ALIASES[key]
        self.uplo = self.uplo.upper()
        if self.uplo not in ("L", "U", "B"):
            raise ValueError(
                "uplo must be 'L', 'U', or 'B' (both triangles — the "
                "reference's uplo map, v3_script_cholesky_x_arg_gpt.c:35-42)"
            )
        if self.n <= 0 or self.nb <= 0:
            raise ValueError("n and nb must be positive")
        if self.p <= 0 or self.q <= 0:
            raise ValueError("p and q must be positive")

    @classmethod
    def layered(
        cls,
        json_path: str | None = None,
        env: dict[str, str] | None = None,
        **flags: Any,
    ) -> "RunConfig":
        """Build a config from (lowest to highest precedence): JSON profile,
        environment (``CHOLESKY_N`` / ``CHOLESKY_B`` — the reference client's
        env surface, ``client_distrib.cpp:61-62``), explicit flags."""
        data: dict[str, Any] = {}
        if json_path and os.path.exists(json_path):
            with open(json_path) as f:
                loaded = json.load(f)
            data.update({k.lower(): v for k, v in loaded.items()})
        env = dict(os.environ) if env is None else env
        if "CHOLESKY_N" in env:
            data["n"] = int(env["CHOLESKY_N"])
        if "CHOLESKY_B" in env:
            data["nb"] = int(env["CHOLESKY_B"])
        if "CHOLESKY_SEED" in env:
            data["seed"] = int(env["CHOLESKY_SEED"])
        data.update({k: v for k, v in flags.items() if v is not None})
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})
