"""The reference's finance-ML side project, ported to PyTorch.

The port of ``dla_tpu/models/``. The reference carries a TensorFlow/Keras
LSTM cross-asset return-forecasting pipeline (``Cholesky_chameleon_VM/z/`` —
SURVEY §1 L6 / §2c): data download → TA-Lib feature engineering → windowing
→ LSTM train/eval. The numpy modules are copies of the JAX package's; the
model, its layers and the trainer are ``torch.nn`` and ``torch.optim`` code
that runs on the card unless ``device="cpu"`` (``--device cpu``) is given:

- :mod:`dla_tpu_torch.models.rawdata`    ↔ ``z/rawdata.py`` (OHLCV TSV reader)
- :mod:`dla_tpu_torch.models.synthetic`  ↔ ``z/generate_dataset.py`` (dataset
  producer; synthetic seeded GBM instead of yfinance, with a per-ticker seed
  that is the same in every process)
- :mod:`dla_tpu_torch.models.indicators` ↔ ``z/chart.py`` (ROCP/MACD/RSI/BOLL/
  MA/VMA/PRICE_VOLUME/CROSS_PRICE — numpy, no TA-Lib; plus the
  weighted-decay future-return label and panel align/merge)
- :mod:`dla_tpu_torch.models.features`   ↔ ``z/feature.py`` (union-of-dates
  alignment + ffill, sliding windows, train-only per-asset z-score,
  two-file feature dump; the JAX package's ``.npz``)
- :mod:`dla_tpu_torch.models.windpuller` ↔ ``z/windpuller.py`` (GaussianNoise →
  stacked LSTM → tanh head; risk_estimation loss; directional-accuracy and
  Pearson metrics; weights and checkpoints shared with the JAX package)
- :mod:`dla_tpu_torch.models.dataset`    ↔ ``z/dataset.py`` (epoch-shuffled
  batcher) and ``z/audit_overlaps.py`` (date-range overlap audit)
- :mod:`dla_tpu_torch.models.renorm`     ↔ ``z/renormalization.py`` (Batch
  Renormalization) and ``z/relu_activation.py`` (BiReLU)
- :mod:`dla_tpu_torch.models.cli`        ↔ ``z/gossip2.py`` (train/eval/predict
  subcommands, checkpoint-on-best-val, cumulative-return export)
"""

from dla_tpu_torch.models.windpuller import WindPuller  # noqa: F401
