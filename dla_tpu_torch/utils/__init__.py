"""Framework-neutral helpers (copied from ``dla_tpu.utils``), the torch-side
precision policy, numpy interop and the profiling helpers (the card's
peaks, timing, roofline, traces)."""
