"""WindPuller — the LSTM return-forecasting model (↔ ``z/windpuller.py``).

The port of ``dla_tpu/models/windpuller.py`` to ``torch.nn`` and
``torch.optim``. Reference architecture (``z/windpuller.py:65-116``):
GaussianNoise → stacked LSTM → Dense(tanh) multi-output, trained on the
profit objective ``risk_estimation = −100 · mean(y_true · y_pred)``
(``:18-23``), with directional-accuracy (``:26-30``) and Pearson (``:33-42``)
metrics.

The LSTM layer is written out (:class:`LSTMLayer`) rather than taken from
``torch.nn.LSTM``: flax's ``OptimizedLSTMCell`` has one bias per gate, on the
hidden kernels only, where ``nn.LSTM`` trains two (``bias_ih`` and
``bias_hh``), which Adam would move by two steps where flax moves one. The
layer holds flax's parameters concatenated along the output axis in flax's
gate order (i, f, g, o), so :func:`params_from_flax` and
:func:`params_to_flax` carry weights across both packages, and the
checkpoint pickle is the JAX package's own layout.

No kernel is written by hand here: the JAX package computes the cell and the
head with XLA ops outside any Pallas kernel, and the port with torch ops.
"""

from __future__ import annotations

import dataclasses
import math
import pickle
from typing import Sequence

import numpy as np
import torch
from torch import nn

_GATES = ("i", "f", "g", "o")
# flax's lecun_normal: a normal truncated at ±2, scaled so its standard deviation is
# sqrt(1 / fan_in) (jax.nn.initializers.variance_scaling, "truncated_normal")
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    w.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)


class LSTMLayer(nn.Module):
    """flax's ``nn.RNN(nn.OptimizedLSTMCell(hidden))`` over a batch-major
    (B, T, F) input from a zero carry; returns every step's h, (B, T, hidden).

    ``weight_ih`` (F, 4h) has no bias, ``weight_hh`` (h, 4h) has ``bias``
    (4h,); the gates i, f, g, o are sigmoid, sigmoid, tanh, sigmoid,
    ``c = f·c + i·g``, ``h = o·tanh(c)``. Initial weights as flax draws them:
    ``lecun_normal`` input kernels, ``orthogonal`` recurrent kernels (each
    gate's (h, h) block on its own), zero bias.
    """

    def __init__(self, in_features: int, hidden: int, *, generator: torch.Generator):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(in_features, 4 * hidden))
        self.weight_hh = nn.Parameter(torch.empty(hidden, 4 * hidden))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))
        with torch.no_grad():
            for g in range(4):
                cols = slice(g * hidden, (g + 1) * hidden)
                _lecun_normal_(self.weight_ih[:, cols], in_features, generator)
                block = torch.empty(hidden, hidden)
                nn.init.orthogonal_(block, generator=generator)
                self.weight_hh[:, cols] = block

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        # every step's input product and the bias at once, time-major, so that each step
        # reads a contiguous (B, 4h) slice and autograd stacks the slices' gradients once
        xi = torch.matmul(x.transpose(0, 1), self.weight_ih) + self.bias
        h = x.new_zeros(b, self.hidden)
        c = x.new_zeros(b, self.hidden)
        out = []
        for xs in xi.unbind(0):
            z = torch.addmm(xs, h, self.weight_hh)
            zi, zf, zg, zo = z.chunk(4, dim=-1)
            c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
            h = torch.sigmoid(zo) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)


class WindPullerNet(nn.Module):
    """Gaussian noise → one :class:`LSTMLayer` per entry of ``hidden``, each
    followed by dropout → the last time step → ``nn.Linear`` → tanh.

    Noise and dropout act in training mode only and draw from the
    ``generator`` given to :meth:`forward` (on the input's device). Dropout
    scales what it keeps by 1/(1 − rate), as flax's ``nn.Dropout``.
    """

    def __init__(self, in_features: int, hidden: Sequence[int] = (64, 32), outputs: int = 1,
                 noise_std: float = 0.05, dropout: float = 0.1, *,
                 generator: torch.Generator):
        super().__init__()
        self.noise_std, self.dropout = noise_std, dropout
        widths = [in_features, *hidden]
        self.lstms = nn.ModuleList(
            LSTMLayer(widths[i], widths[i + 1], generator=generator) for i in range(len(hidden)))
        self.dense = nn.Linear(widths[-1], outputs)
        with torch.no_grad():
            _lecun_normal_(self.dense.weight, widths[-1], generator)
            self.dense.bias.zero_()

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        # x: (B, T, F)
        if self.training and self.noise_std > 0:
            x = x + self.noise_std * torch.randn(x.shape, generator=generator,
                                                 device=x.device, dtype=x.dtype)
        for lstm in self.lstms:
            x = lstm(x)
            if self.training and self.dropout > 0:
                keep = 1.0 - self.dropout
                mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
                x = torch.where(mask, x / keep, torch.zeros_like(x))
        x = x[:, -1, :]  # last hidden state
        return torch.tanh(self.dense(x))


def risk_estimation(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Profit loss: −100 · mean(position · realized return)."""
    return -100.0 * torch.mean(y_true * y_pred)


def directional_accuracy(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.sign(y_true) == torch.sign(y_pred)).to(torch.float32))


def pearson(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    yt = y_true - torch.mean(y_true)
    yp = y_pred - torch.mean(y_pred)
    denom = torch.sqrt(torch.sum(yt**2) * torch.sum(yp**2)) + 1e-12
    return torch.sum(yt * yp) / denom


# -- weights across the two packages --------------------------------------------


def params_from_flax(tree) -> dict[str, torch.Tensor]:
    """A :class:`WindPullerNet` state dict (CPU float32 tensors) from the JAX
    package's parameter tree: ``OptimizedLSTMCell_{l}`` with ``i{g}: {kernel}``
    and ``h{g}: {kernel, bias}`` for g in i, f, g, o, and ``Dense_0: {kernel,
    bias}``. Leaves may be numpy or jax arrays."""

    def arr(x) -> torch.Tensor:
        return torch.tensor(np.asarray(x, dtype=np.float32))

    state = {}
    layers = sorted(int(k.rsplit("_", 1)[1]) for k in tree if k.startswith("OptimizedLSTMCell_"))
    if layers != list(range(len(layers))):
        raise ValueError(f"LSTM layers {layers} are not numbered 0 to {len(layers) - 1}")
    for l in layers:
        cell = tree[f"OptimizedLSTMCell_{l}"]
        state[f"lstms.{l}.weight_ih"] = torch.cat([arr(cell[f"i{g}"]["kernel"]) for g in _GATES], 1)
        state[f"lstms.{l}.weight_hh"] = torch.cat([arr(cell[f"h{g}"]["kernel"]) for g in _GATES], 1)
        state[f"lstms.{l}.bias"] = torch.cat([arr(cell[f"h{g}"]["bias"]) for g in _GATES])
    state["dense.weight"] = arr(tree["Dense_0"]["kernel"]).T.contiguous()
    state["dense.bias"] = arr(tree["Dense_0"]["bias"])
    return state


def params_to_flax(model) -> dict:
    """The JAX package's parameter tree (plain dicts of float32 numpy arrays)
    from a :class:`WindPullerNet` or its state dict."""
    state = model.state_dict() if isinstance(model, nn.Module) else model

    def arr(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy().astype(np.float32, copy=True)

    tree = {}
    nlayers = len({k.split(".")[1] for k in state if k.startswith("lstms.")})
    for l in range(nlayers):
        h = state[f"lstms.{l}.weight_hh"].shape[0]
        wi, wh, b = (state[f"lstms.{l}.{n}"] for n in ("weight_ih", "weight_hh", "bias"))
        cell = {}
        for gi, g in enumerate(_GATES):
            cols = slice(gi * h, (gi + 1) * h)
            cell[f"i{g}"] = {"kernel": arr(wi[:, cols])}
            cell[f"h{g}"] = {"kernel": arr(wh[:, cols]), "bias": arr(b[cols])}
        tree[f"OptimizedLSTMCell_{l}"] = cell
    tree["Dense_0"] = {"kernel": arr(state["dense.weight"].T), "bias": arr(state["dense.bias"])}
    return tree


# -- the train/eval wrapper ------------------------------------------------------


@dataclasses.dataclass
class WindPuller:
    """Train/eval wrapper with the reference's interface shape:
    fit / evaluate / predict / save / load.

    ``device`` is the card unless ``"cpu"`` is given; without a card the
    default raises. Initial weights come from a CPU generator seeded
    ``seed`` (so the card and the CPU start from the same weights); noise
    and dropout in :meth:`fit` from a generator on ``device`` seeded
    ``seed + 1``, as the JAX package seeds its key. The optimizer is
    ``torch.optim.Adam(lr)``, whose defaults are optax's ``adam``'s.
    """

    input_shape: tuple[int, int]  # (T, F)
    outputs: int = 1
    hidden: Sequence[int] = (64, 32)
    lr: float = 1e-3
    noise_std: float = 0.05
    dropout: float = 0.1
    seed: int = 0
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("WindPuller: no CUDA device is available "
                               "(torch.cuda.is_available() is False); pass device='cpu'")
        t, f = self.input_shape
        self.net = WindPullerNet(
            f,
            hidden=tuple(self.hidden),
            outputs=self.outputs,
            noise_std=self.noise_std,
            dropout=self.dropout,
            generator=torch.Generator().manual_seed(self.seed),
        ).to(self.device)
        self.opt = torch.optim.Adam(self.net.parameters(), lr=self.lr)

    def _tensor(self, a) -> torch.Tensor:
        # float32, as the JAX package computes without x64
        return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(self.device)

    def _step(self, x: torch.Tensor, y: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """One Adam step on the batch (x, y); returns the loss before it."""
        self.net.train()
        loss = risk_estimation(y, self.net(x, generator))
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def fit(
        self,
        x_train: np.ndarray,
        y_train: np.ndarray,
        *,
        epochs: int = 10,
        batch_size: int = 64,
        validation: tuple[np.ndarray, np.ndarray] | None = None,
        checkpoint_path: str | None = None,
        verbose: bool = True,
    ) -> dict:
        """Minibatch training with checkpoint-on-best-val
        (↔ Keras ModelCheckpoint(save_best_only) — ``z/gossip2.py:109-118``).
        The training set is moved to the device once; the batches are the
        JAX package's (``DataSet`` with the same seed)."""
        from dla_tpu_torch.models.dataset import DataSet

        ds = DataSet(self._tensor(x_train), self._tensor(y_train), seed=self.seed)
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        history = {"loss": [], "val_loss": []}
        best = np.inf
        for epoch in range(epochs):
            losses = [self._step(xb, yb, gen) for xb, yb in ds.epoch(batch_size)]
            history["loss"].append(float(np.mean(torch.stack(losses).tolist())))
            msg = f"epoch {epoch + 1}/{epochs} loss={history['loss'][-1]:.4f}"
            if validation is not None:
                val = self.evaluate(*validation)
                history["val_loss"].append(val["loss"])
                msg += f" val_loss={val['loss']:.4f} val_dacc={val['directional_accuracy']:.3f}"
                if checkpoint_path and val["loss"] < best:
                    best = val["loss"]
                    self.save(checkpoint_path)
                    msg += " *"
            if verbose:
                print(msg, flush=True)
        return history

    @torch.no_grad()
    def predict(self, x: np.ndarray, batch_size: int = 256) -> np.ndarray:
        self.net.eval()
        outs = []
        for i in range(0, len(x), batch_size):
            outs.append(self.net(self._tensor(x[i : i + batch_size])).cpu().numpy())
        return np.concatenate(outs, axis=0)

    def evaluate(self, x: np.ndarray, y: np.ndarray) -> dict:
        pred = self.predict(x)
        yt, pt = torch.from_numpy(np.asarray(y)), torch.from_numpy(pred)
        return {
            "loss": float(risk_estimation(yt, pt)),
            "directional_accuracy": float(directional_accuracy(yt, pt)),
            "pearson": float(pearson(yt, pt)),
        }

    # -- persistence (↔ z/windpuller.py:142-157 save/load) -------------------
    #
    # One format: a pickle in the JAX package's layout, {"params": <flax-named
    # tree of float32 numpy arrays>, "input_shape", "outputs", "hidden", "lr",
    # "noise_std", "dropout"}, so each package loads the other's file. The JAX
    # package's second format, an orbax directory (``*.orbax``), needs JAX.

    def _meta(self) -> dict:
        return {
            "input_shape": tuple(self.input_shape),
            "outputs": self.outputs,
            "hidden": tuple(self.hidden),
            "lr": self.lr,
            "noise_std": self.noise_std,
            "dropout": self.dropout,
        }

    @staticmethod
    def _refuse_orbax(path: str) -> None:
        if path.rstrip("/").endswith(".orbax"):
            raise ValueError(f"{path}: orbax checkpoints need JAX; the port reads and "
                             "writes the pickle format (any path not ending in .orbax)")

    def save(self, path: str) -> None:
        self._refuse_orbax(path)
        with open(path, "wb") as f:
            pickle.dump({"params": params_to_flax(self.net), **self._meta()}, f)

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cuda") -> "WindPuller":
        cls._refuse_orbax(path)
        with open(path, "rb") as f:
            d = pickle.load(f)
        wp = cls(
            input_shape=tuple(d["input_shape"]),
            outputs=d["outputs"],
            hidden=tuple(d["hidden"]),
            lr=d["lr"],
            noise_std=d["noise_std"],
            dropout=d["dropout"],
            device=device,
        )
        wp.net.load_state_dict(params_from_flax(d["params"]))
        return wp
