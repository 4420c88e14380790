"""Measurement scripts of the port (run on the card; each prints the card's
name and power limit beside its numbers), the sweep harness
(:mod:`~dla_tpu_torch.bench.harness`) and its plots
(:mod:`~dla_tpu_torch.bench.plots`)."""
