"""Tile descriptors."""

from dla_tpu_torch.tiles.layout import TileLayout

__all__ = ["TileLayout"]
