"""Tile descriptor / block-cyclic layout — counterpart of
``dla_tpu/tiles/layout.py`` (a copy: the class is pure Python, and the port
imports nothing of the JAX package).

This realizes the Chameleon ``CHAMELEON_Desc_Create`` parameter surface the
reference programs against (``v6_test.c:44-45``; per-argument docs at
``v5_script_cholesky_proche_v2.c:22-37``):

    Desc_Create(&desc, mat, dtype, mb, nb, bsiz, lm, ln, ioff, joff, m, n, p, q)

as a layout object: tile sizes ``mb×nb``, global (allocated) matrix
``lm×ln``, a submatrix view at offset ``(ioff, joff)`` of size ``m×n``, and a
2D block-cyclic process grid ``p×q``: tile (i, j) lives on grid position
(i mod p, j mod q). The tile-task path uses it for tile origins and shapes;
the multi-device layouts that will use the grid are not ported yet.

Validation mirrors the strict checks of the reference's named-args driver
(``v3_script_cholesky_x_arg_gpt.c:177-196``).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class TileLayout:
    """Block(-cyclic) tile layout of an lm×ln matrix (view: m×n at ioff,joff).

    Tile indices (i, j) are *global* tile coordinates of the view; local
    coordinates address the tiles a given (p_r, q_c) grid position owns.
    """

    mb: int  # tile rows
    nb: int  # tile cols
    lm: int  # global matrix rows
    ln: int  # global matrix cols
    ioff: int = 0  # view row offset (elements)
    joff: int = 0  # view col offset (elements)
    m: int | None = None  # view rows (default: lm - ioff)
    n: int | None = None  # view cols (default: ln - joff)
    p: int = 1  # process-grid rows
    q: int = 1  # process-grid cols

    def __post_init__(self):
        m = self.lm - self.ioff if self.m is None else self.m
        n = self.ln - self.joff if self.n is None else self.n
        object.__setattr__(self, "m", m)
        object.__setattr__(self, "n", n)
        if self.mb <= 0 or self.nb <= 0:
            raise ValueError("tile sizes mb, nb must be positive")
        if self.lm <= 0 or self.ln <= 0:
            raise ValueError("matrix sizes lm, ln must be positive")
        if self.ioff < 0 or self.joff < 0:
            raise ValueError("offsets must be non-negative")
        if self.ioff + m > self.lm or self.joff + n > self.ln:
            raise ValueError("view (ioff+m, joff+n) exceeds matrix (lm, ln)")
        if self.ioff % self.mb or self.joff % self.nb:
            raise ValueError("view offsets must be tile-aligned")
        if self.p <= 0 or self.q <= 0:
            raise ValueError("process grid p, q must be positive")

    # -- tile geometry ------------------------------------------------------

    @property
    def bsiz(self) -> int:
        """Elements per tile (the descriptor's ``bsiz = mb*nb``)."""
        return self.mb * self.nb

    @property
    def mt(self) -> int:
        """Number of tile rows in the view."""
        return math.ceil(self.m / self.mb)

    @property
    def nt(self) -> int:
        """Number of tile cols in the view."""
        return math.ceil(self.n / self.nb)

    def tile_shape(self, i: int, j: int) -> tuple[int, int]:
        """Shape of tile (i, j) — edge tiles may be short."""
        h = min(self.mb, self.m - i * self.mb)
        w = min(self.nb, self.n - j * self.nb)
        if h <= 0 or w <= 0:
            raise IndexError(f"tile ({i}, {j}) outside {self.mt}x{self.nt} grid")
        return (h, w)

    def tile_origin(self, i: int, j: int) -> tuple[int, int]:
        """Global element coordinates of tile (i, j)'s top-left corner."""
        return (self.ioff + i * self.mb, self.joff + j * self.nb)

    # -- block-cyclic ownership --------------------------------------------

    def owner(self, i: int, j: int) -> tuple[int, int]:
        """Grid position owning tile (i, j): (i mod p, j mod q)."""
        return (i % self.p, j % self.q)

    def local_tiles(self, pr: int, qc: int) -> list[tuple[int, int]]:
        """Global tile coords owned by grid position (pr, qc), row-major."""
        return [
            (i, j)
            for i in range(pr, self.mt, self.p)
            for j in range(qc, self.nt, self.q)
        ]

    def local_grid_shape(self, pr: int, qc: int) -> tuple[int, int]:
        """Local tile-array shape at grid position (pr, qc)."""
        lt_r = (self.mt - pr + self.p - 1) // self.p
        lt_c = (self.nt - qc + self.q - 1) // self.q
        return (lt_r, lt_c)

    def local_index(self, i: int, j: int) -> tuple[int, int]:
        """Local tile-array index of global tile (i, j) on its owner."""
        return (i // self.p, j // self.q)

    def global_index(self, pr: int, qc: int, li: int, lj: int) -> tuple[int, int]:
        """Inverse of :meth:`local_index`."""
        return (li * self.p + pr, lj * self.q + qc)

    # -- convenience --------------------------------------------------------

    @property
    def padded_m(self) -> int:
        return self.mt * self.mb

    @property
    def padded_n(self) -> int:
        return self.nt * self.nb

    def describe(self) -> str:
        return (
            f"TileLayout {self.m}x{self.n} view of {self.lm}x{self.ln} "
            f"@({self.ioff},{self.joff}), tiles {self.mb}x{self.nb} "
            f"({self.mt}x{self.nt} grid), process grid {self.p}x{self.q}"
        )
