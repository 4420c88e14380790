"""In-place host BLAS/LAPACK via the numpy-bundled OpenBLAS (ctypes) — a
copy of ``dla_tpu/runtime/hostblas.py``.

The reference's host compute path is vendor BLAS under Chameleon's tasks
(OpenBLAS sgemm/spotrf — SURVEY §1 L0; e.g. the hand-blocked driver calls
``cblas_dgemm``/``LAPACKE_dpotrf`` in
``Cholesky_chameleon_VM/.../code_c/v6_script_cholesky_w_residu_malloc.c``).
The out-of-core factorization's host path
(:func:`dla_tpu_torch.algos.oocore.potrf_outofcore` with ``host_blas=True``)
makes these calls directly, fully in place: no fresh output allocations, no
defensive copies, no per-shape compiles. On the JAX package's single-core
host VM that measured ~120 GF/s against ~72 GF/s for its XLA CPU path.

This module dlopens the OpenBLAS shared library that numpy itself bundles
(no new dependency) and exposes exactly the in-place primitives the
out-of-core panel algorithm needs, with full leading-dimension control so
panel *sub-views* are operated on in place:

- ``gemm``  : C := alpha·op(A)·op(B) + beta·C   (cblas_{s,d}gemm)
- ``trsm``  : B := alpha·op(A)⁻¹·B or B·op(A)⁻¹ (cblas_{s,d}trsm)
- ``syrk``  : C := alpha·A·Aᵀ + beta·C, triangle only (cblas_{s,d}syrk)
- ``potrf`` : in-place lower Cholesky            (LAPACKE_{s,d}potrf)

All take C-order numpy arrays (row-major CBLAS/LAPACKE layout) whose last
axis is contiguous; the row stride becomes the leading dimension.
"""

from __future__ import annotations

import ctypes
import glob
import os

import numpy as np

# CBLAS enums
_ROW_MAJOR = 101
_NO_TRANS, _TRANS = 111, 112
_UPPER, _LOWER = 121, 122
_NON_UNIT = 131
_LEFT, _RIGHT = 141, 142

_lib = None
_sym = None  # (prefix, suffix, int_t)


def _find_lib():
    """Locate the OpenBLAS .so bundled with numpy (or scipy)."""
    cands = []
    for mod in ("numpy", "scipy"):
        try:
            m = __import__(mod)
        except ImportError:  # pragma: no cover
            continue
        libs = os.path.join(os.path.dirname(os.path.dirname(m.__file__)),
                            f"{mod}.libs")
        cands += sorted(glob.glob(os.path.join(libs, "libscipy_openblas*.so*")))
        cands += sorted(glob.glob(os.path.join(libs, "libopenblas*.so*")))
    return cands


def _load():
    global _lib, _sym
    if _lib is not None:
        return
    last_err = None
    for path in _find_lib():
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:  # pragma: no cover
            last_err = e
            continue
        # probe symbol naming: scipy builds use a `scipy_` prefix and the
        # ILP64 builds a `64_` suffix (e.g. scipy_cblas_sgemm64_)
        for prefix, suffix in (("scipy_", "64_"), ("scipy_", ""),
                               ("", "64_"), ("", "")):
            if hasattr(lib, f"{prefix}cblas_sgemm{suffix}"):
                int_t = ctypes.c_int64 if suffix else ctypes.c_int32
                _lib, _sym = lib, (prefix, suffix, int_t)
                _bind()
                return
    raise RuntimeError(
        f"no usable OpenBLAS shared library found (tried {_find_lib()}): "
        f"{last_err}"
    )


def _fn(name: str):
    prefix, suffix, _ = _sym
    return getattr(_lib, f"{prefix}{name}{suffix}")


def _bind():
    _, _, int_t = _sym
    enum = ctypes.c_int32
    vp = ctypes.c_void_p
    for ch, scalar in (("s", ctypes.c_float), ("d", ctypes.c_double)):
        f = _fn(f"cblas_{ch}gemm")
        f.restype = None
        f.argtypes = [enum, enum, enum, int_t, int_t, int_t,
                      scalar, vp, int_t, vp, int_t, scalar, vp, int_t]
        f = _fn(f"cblas_{ch}trsm")
        f.restype = None
        f.argtypes = [enum, enum, enum, enum, enum, int_t, int_t,
                      scalar, vp, int_t, vp, int_t]
        f = _fn(f"cblas_{ch}syrk")
        f.restype = None
        f.argtypes = [enum, enum, enum, int_t, int_t,
                      scalar, vp, int_t, scalar, vp, int_t]
        f = _fn(f"LAPACKE_{ch}potrf")
        f.restype = int_t
        f.argtypes = [ctypes.c_int32, ctypes.c_char, int_t, vp, int_t]


def available() -> bool:
    """Whether a host BLAS library could be loaded."""
    try:
        _load()
        return True
    except RuntimeError:
        return False


def _ch(a: np.ndarray) -> str:
    if a.dtype == np.float32:
        return "s"
    if a.dtype == np.float64:
        return "d"
    raise TypeError(f"host BLAS supports float32/float64, got {a.dtype}")


def _ld(a: np.ndarray) -> int:
    """Leading dimension of a row-major view (last axis must be contiguous)."""
    item = a.dtype.itemsize
    if a.ndim != 2 or a.strides[1] != item or a.strides[0] % item:
        raise ValueError(f"need a row-major 2-D view, got strides {a.strides}")
    ld = a.strides[0] // item
    if ld < a.shape[1]:
        raise ValueError(f"ld {ld} < ncols {a.shape[1]}")
    return ld


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def gemm(alpha: float, a: np.ndarray, b: np.ndarray, beta: float,
         c: np.ndarray, *, transa: bool = False, transb: bool = False) -> None:
    """C := alpha·op(A)·op(B) + beta·C, fully in place on ``c``."""
    _load()
    ch = _ch(c)
    m, n = c.shape
    k = a.shape[0] if transa else a.shape[1]
    ka, kb = (a.shape[::-1] if transa else a.shape), (b.shape[::-1] if transb else b.shape)
    if ka != (m, k) or kb != (k, n):
        raise ValueError(f"gemm shape mismatch: {a.shape}{'^T' if transa else ''} "
                         f"@ {b.shape}{'^T' if transb else ''} -> {c.shape}")
    _fn(f"cblas_{ch}gemm")(
        _ROW_MAJOR, _TRANS if transa else _NO_TRANS,
        _TRANS if transb else _NO_TRANS, m, n, k,
        alpha, _ptr(a), _ld(a), _ptr(b), _ld(b), beta, _ptr(c), _ld(c),
    )


def syrk(alpha: float, a: np.ndarray, beta: float, c: np.ndarray, *,
         lower: bool = True, trans: bool = False) -> None:
    """C := alpha·A·Aᵀ + beta·C on one triangle of ``c``, in place."""
    _load()
    ch = _ch(c)
    n = c.shape[0]
    k = a.shape[0] if trans else a.shape[1]
    _fn(f"cblas_{ch}syrk")(
        _ROW_MAJOR, _LOWER if lower else _UPPER,
        _TRANS if trans else _NO_TRANS, n, k,
        alpha, _ptr(a), _ld(a), beta, _ptr(c), _ld(c),
    )


def trsm(alpha: float, a: np.ndarray, b: np.ndarray, *, side: str = "R",
         lower: bool = True, transa: bool = False) -> None:
    """B := alpha·B·op(A)⁻¹ (side R) or alpha·op(A)⁻¹·B (side L), in place
    on ``b``; only the ``lower`` triangle of ``a`` is referenced."""
    _load()
    ch = _ch(b)
    m, n = b.shape
    _fn(f"cblas_{ch}trsm")(
        _ROW_MAJOR, _RIGHT if side == "R" else _LEFT,
        _LOWER if lower else _UPPER, _TRANS if transa else _NO_TRANS,
        _NON_UNIT, m, n, alpha, _ptr(a), _ld(a), _ptr(b), _ld(b),
    )


def potrf(a: np.ndarray, *, lower: bool = True) -> int:
    """In-place Cholesky of ``a``'s ``lower`` triangle (LAPACKE). Returns
    LAPACK ``info`` (0 = ok, >0 = not SPD at that pivot)."""
    _load()
    ch = _ch(a)
    n = a.shape[0]
    return int(_fn(f"LAPACKE_{ch}potrf")(
        _ROW_MAJOR, b"L" if lower else b"U", n, _ptr(a), _ld(a)
    ))


def factor_panel(p: np.ndarray, nb: int) -> None:
    """In-place blocked right-looking Cholesky of a tall panel ``p``
    (m, w), m ≥ w: the out-of-core per-panel factor (``algos.oocore``'s
    device factor step) as three in-place BLAS calls per ``nb`` block — true
    TRSM substitution (no explicit inverse, so no conditioning
    amplification) and zero temporaries. The strict upper triangle of the
    top w×w square is zeroed (tril contract)."""
    m, w = p.shape
    if m < w:
        raise ValueError(f"panel must be tall: {p.shape}")
    for off in range(0, w, nb):
        bw = min(nb, w - off)
        diag = p[off:off + bw, off:off + bw]
        info = potrf(diag)
        if info:
            raise np.linalg.LinAlgError(
                f"panel not SPD at block offset {off}+{info - 1}"
            )
        if off + bw < m:
            below = p[off + bw:, off:off + bw]
            trsm(1.0, diag, below, side="R", lower=True, transa=True)
            if off + bw < w:
                rest = p[off + bw:, off + bw:w]
                gemm(-1.0, below, below[: w - off - bw], 1.0, rest,
                     transb=True)
    iu = np.triu_indices(w, 1)
    p[:w][iu] = 0
