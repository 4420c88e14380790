"""Framework-neutral helpers (copied from ``dla_tpu.utils``), the torch-side
precision policy and numpy interop."""
