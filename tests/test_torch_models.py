"""dla_tpu_torch.models held against dla_tpu.models on the CPU.

What is compared how:
- the numpy pipeline (TSV IO, every indicator and the label, the panel, the
  feature build, the ``.npz`` in both directions, ``DataSet``'s batch
  order): bit for bit;
- the corpus: the port seeds each ticker from a CRC-32 where the JAX package
  uses ``hash()``, salted per process; with that ``hash`` patched to the
  port's value the two corpora are equal bit for bit, and two processes with
  different ``PYTHONHASHSEED`` write the same port corpus;
- the model, from the same weights (``params_from_flax``): the forward pass
  within 1e-5, the metrics within 1e-6, five Adam steps (noise and dropout
  off) with losses within 1e-5 relative and every parameter within
  1e-4·max|p|, checkpoints read by both packages within 1e-5;
- ``BatchRenorm`` and ``birelu`` against flax within 1e-5 of each quantity's
  largest magnitude (1 at least);
- what only the port has: its own seeded noise and dropout, flax's weight
  distributions, the learned signal, the CLI in-process on ``--device cpu``,
  imports with jax blocked, and no silent fall-back to the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dla_tpu.models import dataset as JD
from dla_tpu.models import features as JF
from dla_tpu.models import indicators as JI
from dla_tpu.models import rawdata as JR
from dla_tpu.models import renorm as JRN
from dla_tpu.models import synthetic as JS
from dla_tpu.models import windpuller as JW
from dla_tpu_torch.models import cli
from dla_tpu_torch.models import dataset as D
from dla_tpu_torch.models import features as F
from dla_tpu_torch.models import indicators as I
from dla_tpu_torch.models import rawdata as R
from dla_tpu_torch.models import renorm as RN
from dla_tpu_torch.models import synthetic as S
from dla_tpu_torch.models import windpuller as W
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = Path(__file__).resolve().parents[1]
# the forward pass's small width: (T, F), hidden, outputs, batch
T, NF, HIDDEN, OUT, BATCH = 8, 6, (16, 8), 3, 32


def stable_hash(key):
    """``hash((ticker, seed))`` as the port derives the ticker's seed."""
    return S.ticker_seed(*key)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    S.generate_dataset(str(d), ["indices", "sectors"], days=160, seed=1)
    return str(d)


def equal_tree(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            equal_tree(a[k], b[k]) for k in a)
    return np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)


# ---- the numpy pipeline, bit for bit ----------------------------------------------------------


class TestRawData:
    def test_write_and_read_as_jax(self, tmp_path):
        rd = S.synth_ohlcv("TST", days=60, seed=2)
        R.write_rawdata_tsv(str(tmp_path / "a.tsv"), rd)
        JR.write_rawdata_tsv(str(tmp_path / "b.tsv"), rd)
        assert (tmp_path / "a.tsv").read_bytes() == (tmp_path / "b.tsv").read_bytes()
        mine, ref = R.read_rawdata_tsv(str(tmp_path / "a.tsv")), JR.read_rawdata_tsv(
            str(tmp_path / "a.tsv"))
        assert mine.ticker == ref.ticker == "a" and mine.dates == ref.dates
        for col in ("open", "high", "low", "close", "volume"):
            assert np.array_equal(getattr(mine, col), getattr(ref, col))
        assert R.read_sample_data is R.read_rawdata_tsv

    def test_reader_skips_garbage_as_jax(self, tmp_path):
        p = tmp_path / "g.tsv"
        p.write_text("date\topen\thigh\tlow\tclose\tvolume\n2020-01-01\t1\t2\t0.5\t1.5\t100\n"
                     "not\ta\tvalid\trow\n\n2020-01-02\t1.5\t2.5\t1\t2\t200\nx\t1\t2\t3\tz\t5\n")
        mine, ref = R.read_rawdata_tsv(str(p), "G"), JR.read_rawdata_tsv(str(p), "G")
        assert len(mine) == len(ref) == 2 and mine.dates == ref.dates
        assert np.array_equal(mine.close, ref.close)


def _series(seed):
    return S.synth_ohlcv("IND", days=240, seed=seed)


class TestIndicators:
    @pytest.mark.parametrize("name,call", [
        ("rocp", lambda m, rd: m.rocp(rd.close)),
        ("rocp_3", lambda m, rd: m.rocp(rd.volume, 3)),
        ("macd", lambda m, rd: m.macd(rd.close)),
        ("rsi", lambda m, rd: m.rsi(rd.close)),
        ("bollinger", lambda m, rd: m.bollinger(rd.close)),
        ("moving_average_rocp", lambda m, rd: m.moving_average_rocp(rd.close)),
        ("extract_features", lambda m, rd: m.extract_features(rd)),
        ("extract_features_cross", lambda m, rd: m.extract_features(
            rd, m.DEFAULT_SELECTOR + ("CROSS_PRICE",))),
        ("make_label", lambda m, rd: m.make_label(rd.close)),
        ("make_label_h3", lambda m, rd: m.make_label(rd.close, horizon=3, decay=0.5)),
    ])
    def test_bits_as_jax(self, name, call):
        rd = _series(4)
        mine, ref = call(I, rd), call(JI, rd)
        if name.startswith("extract"):
            assert mine[0] == ref[0]
            mine, ref = mine[1], ref[1]
        mine = mine if isinstance(mine, (tuple, list)) else [mine]
        ref = ref if isinstance(ref, (tuple, list)) else [ref]
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b), name

    def test_selector_as_jax(self):
        assert I.DEFAULT_SELECTOR == JI.DEFAULT_SELECTOR

    def test_align_and_merge_as_jax(self):
        per_asset = {}
        for k, t in enumerate(("BBB", "AAA", "CCC")):
            rd = S.synth_ohlcv(t, days=120, seed=k)
            keep = np.ones(len(rd), bool)
            keep[np.random.default_rng(k).choice(len(rd), 15, replace=False)] = False
            names, mat = I.extract_features(rd)
            per_asset[t] = (names, mat[:, keep], [d for d, kk in zip(rd.dates, keep) if kk])
        mine, ref = I.align_and_merge(per_asset), JI.align_and_merge(per_asset)
        assert mine[0] == ref[0] and mine[1] == ref[1]
        assert np.array_equal(mine[2], ref[2])


class TestFeatures:
    def test_build_as_jax(self, corpus):
        mine = F.build_features(corpus, window=12, horizon=3, train_frac=0.75)
        ref = JF.build_features(corpus, window=12, horizon=3, train_frac=0.75)
        for k in ("x", "y", "mean", "std"):
            assert np.array_equal(getattr(mine, k), getattr(ref, k)), k
        for k in ("dates", "tickers", "feature_names", "train_frac", "n_train"):
            assert getattr(mine, k) == getattr(ref, k), k

    def test_npz_read_by_the_other_package(self, corpus, tmp_path):
        fs = F.build_features(corpus, window=10, horizon=2)
        F.FeatureSet.save(fs, str(tmp_path / "mine.npz"))
        JF.FeatureSet.save(fs, str(tmp_path / "ref.npz"))
        for path in ("mine.npz", "ref.npz"):
            a = F.FeatureSet.load(str(tmp_path / path))
            b = JF.FeatureSet.load(str(tmp_path / path))
            for k in ("x", "y", "mean", "std"):
                assert np.array_equal(getattr(a, k), getattr(b, k)), (path, k)
            for k in ("dates", "tickers", "feature_names", "train_frac"):
                assert getattr(a, k) == getattr(b, k), (path, k)
        a, b = F.FeatureSet.load(str(tmp_path / "mine.npz")), F.FeatureSet.load(
            str(tmp_path / "ref.npz"))
        assert np.array_equal(a.x, b.x) and a.x.dtype == np.float32

    def test_audit_as_jax(self, corpus):
        assert F.audit_overlaps(corpus) == JF.audit_overlaps(corpus)
        assert len(F.audit_overlaps(corpus)) == 8


class TestDataSet:
    def test_epoch_order_as_jax(self):
        rng = np.random.default_rng(0)
        x, y = rng.standard_normal((103, 4)), rng.standard_normal((103, 2))
        mine, ref = D.DataSet(x, y, seed=7), JD.DataSet(x, y, seed=7)
        for _ in range(3):  # the generator runs on across epochs
            for (xa, ya), (xb, yb) in zip(mine.epoch(16), ref.epoch(16), strict=True):
                assert np.array_equal(xa, xb) and np.array_equal(ya, yb)

    def test_epoch_on_tensors_keeps_the_order(self):
        x = np.arange(40, dtype=np.float32).reshape(20, 2)
        mine, ref = D.DataSet(torch.from_numpy(x), torch.from_numpy(x), seed=3), D.DataSet(
            x, x, seed=3)
        for (xa, _), (xb, _) in zip(mine.epoch(6), ref.epoch(6), strict=True):
            assert np.array_equal(xa.numpy(), xb)


# ---- the corpus -------------------------------------------------------------------------------


class TestSynthetic:
    def test_universes_as_jax(self):
        assert S.UNIVERSES == JS.UNIVERSES

    @pytest.mark.parametrize("ticker,seed,days", [("SPX", 0, 300), ("XLK", 5, 77),
                                                   ("EEM", -3, 10)])
    def test_series_as_jax_under_the_stable_hash(self, monkeypatch, ticker, seed, days):
        monkeypatch.setattr(JS, "hash", stable_hash, raising=False)
        mine, ref = S.synth_ohlcv(ticker, days, seed=seed), JS.synth_ohlcv(ticker, days,
                                                                            seed=seed)
        assert mine.dates == ref.dates
        for col in ("open", "high", "low", "close", "volume"):
            assert np.array_equal(getattr(mine, col), getattr(ref, col)), col

    def test_corpus_as_jax_under_the_stable_hash(self, monkeypatch, tmp_path):
        monkeypatch.setattr(JS, "hash", stable_hash, raising=False)
        assert S.generate_dataset(str(tmp_path / "a"), ["etf"], days=50, seed=9) == \
            JS.generate_dataset(str(tmp_path / "b"), ["etf"], days=50, seed=9)
        names = sorted(os.listdir(tmp_path / "a"))
        assert names == sorted(os.listdir(tmp_path / "b")) and "_meta_universe.tsv" in names
        for n in names:
            assert (tmp_path / "a" / n).read_bytes() == (tmp_path / "b" / n).read_bytes(), n

    def test_seed_in_range_and_distinct(self):
        seeds = {S.ticker_seed(t, s) for t in ("SPX", "NDX", "AAA") for s in range(4)}
        assert len(seeds) == 12 and all(0 <= v < 2**32 for v in seeds)

    def test_corpus_same_in_every_process(self, tmp_path):
        """The JAX package's corpus changes with PYTHONHASHSEED; the port's may not."""
        code = ("import sys; from dla_tpu_torch.models.synthetic import generate_dataset; "
                "generate_dataset(sys.argv[1], ['indices', 'bluechips'], days=40, seed=0)")
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(tmp_path / h)], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=str(REPO), PYTHONHASHSEED=h),
            stderr=subprocess.PIPE, text=True) for h in ("1", "2")]
        for p in procs:
            assert p.wait(timeout=120) == 0, p.stderr.read()
        names = sorted(os.listdir(tmp_path / "1"))
        assert len(names) == 10 and names == sorted(os.listdir(tmp_path / "2"))
        for n in names:
            assert (tmp_path / "1" / n).read_bytes() == (tmp_path / "2" / n).read_bytes(), n


# ---- the model --------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_wp():
    """The JAX model at the small width, noise and dropout off."""
    return JW.WindPuller(input_shape=(T, NF), outputs=OUT, hidden=HIDDEN, noise_std=0.0,
                         dropout=0.0, seed=2)


def port_from(jwp, **kw) -> W.WindPuller:
    wp = W.WindPuller(input_shape=jwp.input_shape, outputs=jwp.outputs, hidden=jwp.hidden,
                      lr=jwp.lr, noise_std=jwp.noise_std, dropout=jwp.dropout, seed=jwp.seed,
                      device="cpu", **kw)
    wp.net.load_state_dict(W.params_from_flax(jwp.params))
    return wp


def batch(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, T, NF)).astype(np.float32)
    y = (0.05 * rng.standard_normal((n, OUT))).astype(np.float32)
    return x, y


class TestWeights:
    def test_roundtrip_is_the_tree(self, jax_wp):
        tree = jax.tree_util.tree_map(np.asarray, jax_wp.params)
        assert equal_tree(W.params_to_flax(W.params_from_flax(tree)), tree)

    def test_module_and_state_dict_give_the_same_tree(self, jax_wp):
        wp = port_from(jax_wp)
        assert equal_tree(W.params_to_flax(wp.net), W.params_to_flax(wp.net.state_dict()))

    def test_names_are_flax_s(self, jax_wp):
        tree = W.params_to_flax(W.WindPuller((T, NF), OUT, HIDDEN, device="cpu").net)
        shapes = jax.tree_util.tree_map(lambda a: a.shape, tree)
        assert shapes == jax.tree_util.tree_map(lambda a: a.shape, dict(jax_wp.params))

    def test_initial_weights_as_flax_draws_them(self):
        f, h = 400, 64
        net = W.WindPuller((T, f), 19, (h,), seed=4, device="cpu").net
        again = W.WindPuller((T, f), 19, (h,), seed=4, device="cpu").net
        other = W.WindPuller((T, f), 19, (h,), seed=5, device="cpu").net
        for k, v in net.state_dict().items():
            assert torch.equal(v, again.state_dict()[k]), k
        assert not torch.equal(net.lstms[0].weight_ih, other.lstms[0].weight_ih)
        lstm = net.lstms[0]
        wi = lstm.weight_ih.detach()  # lecun_normal: std sqrt(1/fan_in), cut at 2/0.8796 of it
        assert abs(float(wi.std()) * f ** 0.5 - 1.0) < 0.03
        assert float(wi.abs().max()) <= 2.0 / 0.87962566103423978 / f ** 0.5 + 1e-6
        wh = lstm.weight_hh.detach()  # orthogonal, one (h, h) block per gate
        for g in range(4):
            q = wh[:, g * h:(g + 1) * h]
            assert torch.allclose(q.T @ q, torch.eye(h), atol=1e-5)
        assert not torch.any(lstm.bias) and not torch.any(net.dense.bias)
        wd = net.dense.weight.detach()
        assert abs(float(wd.std()) * h ** 0.5 - 1.0) < 0.15

    def test_from_flax_refuses_a_gap_in_the_layers(self, jax_wp):
        tree = dict(jax.tree_util.tree_map(np.asarray, jax_wp.params))
        tree["OptimizedLSTMCell_3"] = tree.pop("OptimizedLSTMCell_1")
        with pytest.raises(ValueError, match="not numbered"):
            W.params_from_flax(tree)


class TestForward:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_eval_forward_as_jax(self, jax_wp, seed):
        x, _ = batch(seed)
        wp = port_from(jax_wp)
        ref = np.asarray(jax_wp.net.apply({"params": jax_wp.params}, jnp.asarray(x),
                                          train=False))
        wp.net.eval()
        with torch.no_grad():
            mine = wp.net(torch.from_numpy(x)).numpy()
        assert mine.shape == ref.shape == (BATCH, OUT) and mine.dtype == np.float32
        assert np.abs(mine - ref).max() <= 1e-5
        assert np.abs(wp.predict(x, batch_size=7) - ref).max() <= 1e-5

    def test_metrics_as_jax(self, jax_wp):
        x, y = batch(3)
        mine, ref = port_from(jax_wp).evaluate(x, y), jax_wp.evaluate(x, y)
        assert mine.keys() == ref.keys()
        for k in ref:
            assert abs(mine[k] - ref[k]) <= 1e-6, (k, mine[k], ref[k])

    def test_metric_functions_as_jax(self):
        rng = np.random.default_rng(5)
        yt = rng.standard_normal((50, 4)).astype(np.float32)
        yp = np.tanh(yt + rng.standard_normal((50, 4))).astype(np.float32)
        yp[0, 0] = 0.0  # sign 0
        for mine, ref in ((W.risk_estimation, JW.risk_estimation),
                          (W.directional_accuracy, JW.directional_accuracy),
                          (W.pearson, JW.pearson)):
            a = float(mine(torch.from_numpy(yt), torch.from_numpy(yp)))
            b = float(ref(jnp.asarray(yt), jnp.asarray(yp)))
            assert abs(a - b) <= 1e-6 * max(1.0, abs(b)), (mine.__name__, a, b)  # -48: ulp 4e-6
        zero = np.zeros((4, 1), np.float32)  # the +1e-12 keeps a constant series finite
        assert float(W.pearson(torch.from_numpy(zero), torch.from_numpy(zero))) == 0.0


class TestTraining:
    def test_five_adam_steps_as_jax(self, jax_wp):
        wp = port_from(jax_wp)
        params, opt_state = jax_wp.params, jax_wp.tx.init(jax_wp.params)
        gen = torch.Generator().manual_seed(0)
        for s in range(5):
            x, y = batch(10 + s)
            params, opt_state, ref = jax_wp._step(params, opt_state, jnp.asarray(x),
                                                  jnp.asarray(y), jax.random.PRNGKey(s))
            mine = float(wp._step(torch.from_numpy(x), torch.from_numpy(y), gen))
            assert abs(mine - float(ref)) <= 1e-5 * abs(float(ref)), (s, mine, float(ref))
        want = W.params_from_flax(params)
        for k, v in wp.net.state_dict().items():
            scale = float(want[k].abs().max())
            assert float((v - want[k]).abs().max()) <= 1e-4 * scale, k
            assert not torch.equal(v, W.params_from_flax(jax_wp.params)[k]), k  # it moved

    def test_fit_as_jax(self, tmp_path):
        """The JAX fit's history and checkpoint from the same weights and batches."""
        ref = JW.WindPuller(input_shape=(T, NF), outputs=OUT, hidden=(8,), noise_std=0.0,
                            dropout=0.0, seed=3, lr=3e-3)
        wp = port_from(ref)
        x, y = batch(20, n=96)
        xv, yv = batch(21, n=40)
        kw = dict(epochs=3, batch_size=32, validation=(xv, yv), verbose=False)
        h_ref = ref.fit(x, y, checkpoint_path=str(tmp_path / "ref.pkl"), **kw)
        h_mine = wp.fit(x, y, checkpoint_path=str(tmp_path / "mine.pkl"), **kw)
        for k in ("loss", "val_loss"):
            assert len(h_mine[k]) == len(h_ref[k]) == 3
            for a, b in zip(h_mine[k], h_ref[k]):
                assert abs(a - b) <= 1e-5 * abs(b), (k, a, b)
        xt, _ = batch(22)
        best_ref = JW.WindPuller.load(str(tmp_path / "ref.pkl")).predict(xt)
        best_mine = W.WindPuller.load(str(tmp_path / "mine.pkl"), device="cpu").predict(xt)
        assert np.abs(best_mine - best_ref).max() <= 1e-5

    def test_fit_prints_jax_s_lines(self, tmp_path, capsys):
        wp = W.WindPuller((T, NF), OUT, (8,), seed=1, device="cpu")
        x, y = batch(30, n=64)
        wp.fit(x, y, epochs=2, batch_size=32, validation=batch(31, n=16),
               checkpoint_path=str(tmp_path / "c.pkl"))
        lines = capsys.readouterr().out.splitlines()
        assert len(lines) == 2
        assert lines[0].startswith("epoch 1/2 loss=") and " val_loss=" in lines[0]
        assert " val_dacc=" in lines[0] and lines[0].endswith(" *")
        assert (tmp_path / "c.pkl").exists()


class TestRandomness:
    def test_a_seed_reproduces_the_port_s_run(self):
        x, y = batch(40, n=64)
        runs = []
        for _ in range(2):
            wp = W.WindPuller((T, NF), OUT, HIDDEN, noise_std=0.3, dropout=0.4, seed=6,
                              device="cpu")
            hist = wp.fit(x, y, epochs=2, batch_size=16, verbose=False)
            runs.append((hist["loss"], wp.net.state_dict()))
        assert runs[0][0] == runs[1][0]
        for k, v in runs[0][1].items():
            assert torch.equal(v, runs[1][1][k]), k
        quiet = W.WindPuller((T, NF), OUT, HIDDEN, noise_std=0.0, dropout=0.0, seed=6,
                             device="cpu")
        assert quiet.fit(x, y, epochs=2, batch_size=16, verbose=False)["loss"] != runs[0][0]

    def test_dropout_scales_by_the_kept_share(self):
        wp = W.WindPuller((T, NF), 4, (256,), noise_std=0.0, dropout=0.25, seed=2, device="cpu")
        seen = []
        wp.net.dense.register_forward_hook(lambda m, inp, out: seen.append(inp[0].detach()))
        x = torch.from_numpy(batch(41, n=64)[0])
        wp.net.eval()
        wp.net(x)
        wp.net.train()
        wp.net(x, torch.Generator().manual_seed(0))
        full, dropped = seen
        kept = dropped != 0
        assert torch.equal(dropped[kept], full[kept] / 0.75)
        assert abs(float(kept.float().mean()) - 0.75) < 0.02

    def test_noise_only_in_training(self):
        wp = W.WindPuller((T, NF), OUT, HIDDEN, noise_std=0.5, dropout=0.0, seed=2, device="cpu")
        x = torch.from_numpy(batch(42)[0])
        wp.net.eval()
        a, b = wp.net(x), wp.net(x)
        wp.net.train()
        c = wp.net(x, torch.Generator().manual_seed(1))
        assert torch.equal(a, b) and not torch.allclose(a, c)


class TestCheckpoints:
    def test_jax_pickle_predicts_as_jax_in_the_port(self, tmp_path):
        ref = JW.WindPuller(input_shape=(5, 4), outputs=2, hidden=(8, 4), seed=3, lr=2e-3,
                            noise_std=0.07, dropout=0.2)
        path = str(tmp_path / "wp.pkl")
        ref.save(path)
        mine = W.WindPuller.load(path, device="cpu")
        assert (mine.input_shape, mine.outputs, tuple(mine.hidden), mine.lr, mine.noise_std,
                mine.dropout) == ((5, 4), 2, (8, 4), 2e-3, 0.07, 0.2)
        x = np.random.default_rng(1).standard_normal((300, 5, 4)).astype(np.float32)
        assert np.abs(mine.predict(x) - ref.predict(x)).max() <= 1e-5

    def test_port_pickle_predicts_as_the_port_in_jax(self, tmp_path):
        mine = W.WindPuller((5, 4), outputs=2, hidden=(8,), seed=4, device="cpu")
        path = str(tmp_path / "wp.pkl")
        mine.save(path)
        ref = JW.WindPuller.load(path)
        x = np.random.default_rng(2).standard_normal((9, 5, 4)).astype(np.float32)
        assert np.abs(ref.predict(x) - mine.predict(x)).max() <= 1e-5
        again = W.WindPuller.load(path, device="cpu")
        assert np.array_equal(again.predict(x), mine.predict(x))

    def test_orbax_paths_raise(self, tmp_path):
        wp = W.WindPuller((5, 4), device="cpu")
        for path in (str(tmp_path / "wp.orbax"), str(tmp_path / "wp.orbax") + "/"):
            with pytest.raises(ValueError, match="pickle"):
                wp.save(path)
            with pytest.raises(ValueError, match="pickle"):
                W.WindPuller.load(path, device="cpu")
        assert not (tmp_path / "wp.orbax").exists()


def close(mine: torch.Tensor, ref) -> None:
    """Within 1e-5 of the reference's largest magnitude (1 at least)."""
    ref = np.asarray(ref)
    assert np.abs(mine.detach().numpy() - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


class TestRenorm:
    @pytest.mark.parametrize("shape", [(32, 16), (6, 5, 12)])
    def test_as_flax(self, shape):
        rng = np.random.default_rng(len(shape))
        feat = shape[-1]
        # narrow and wide features, off-centre by 1.6 of their spread (either sign), so that
        # r clips at both ends and d beyond ±5; a larger offset against the spread would
        # leave fp32's cancellation in x − mean, not the layer, to the comparison
        scale = np.linspace(0.25, 5.0, feat).astype(np.float32)
        shift = (1.6 * scale * np.where(np.arange(feat) % 2, 1, -1)).astype(np.float32)
        xs = [(rng.standard_normal(shape) * scale + shift).astype(np.float32) for _ in range(3)]
        w = rng.standard_normal(shape).astype(np.float32)
        ref_m = JRN.BatchRenorm()
        variables = ref_m.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), train=True)
        variables = {"params": {"gamma": jnp.asarray(rng.uniform(0.5, 1.5, feat), jnp.float32),
                                "beta": jnp.asarray(rng.standard_normal(feat), jnp.float32)},
                     "batch_stats": variables["batch_stats"]}
        mine = RN.BatchRenorm(feat)
        with torch.no_grad():
            mine.gamma.copy_(torch.tensor(np.asarray(variables["params"]["gamma"])))
            mine.beta.copy_(torch.tensor(np.asarray(variables["params"]["beta"])))
        mine.train()
        for x in xs:  # three training steps: the running stats move, then r and d act
            def loss(params, xj):
                y, upd = ref_m.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                     xj, train=True, mutable=["batch_stats"])
                return jnp.sum(y * w), (y, upd)

            (_, (y_ref, upd)), (g_p, g_x) = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))
            xt = torch.from_numpy(x).requires_grad_(True)
            y = mine(xt)
            (y * torch.from_numpy(w)).sum().backward()
            close(y, y_ref)
            close(xt.grad, g_x)
            close(mine.gamma.grad, g_p["gamma"])  # sums of 32 products of size ≈ 5 (d clips)
            close(mine.beta.grad, g_p["beta"])
            mine.gamma.grad = mine.beta.grad = None
            variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
            close(mine.running_mean, upd["batch_stats"]["mean"])
            close(mine.running_var, upd["batch_stats"]["var"])
        mine.eval()
        before = mine.running_mean.clone()
        close(mine(torch.from_numpy(xs[0])), ref_m.apply(variables, jnp.asarray(xs[0]),
                                                         train=False))
        assert torch.equal(mine.running_mean, before)  # eval leaves the stats alone

    def test_defaults_as_flax(self):
        m, ref = RN.BatchRenorm(4), JRN.BatchRenorm()
        assert (m.rmax, m.dmax, m.momentum, m.epsilon) == (ref.rmax, ref.dmax, ref.momentum,
                                                          ref.epsilon)
        assert sorted(n for n, _ in m.named_buffers()) == ["running_mean", "running_var"]

    def test_birelu_as_jax(self):
        x = np.random.default_rng(0).standard_normal(64).astype(np.float32) * 3
        for leak in (0.01, 0.3):
            mine = RN.birelu(torch.from_numpy(x), leak).numpy()
            assert np.abs(mine - np.asarray(JRN.birelu(jnp.asarray(x), leak))).max() <= 1e-5
        assert RN.birelu(torch.tensor([-2.0, 0.0, 3.0])).tolist() == pytest.approx(
            [-0.02, 0.0, 3.0])


# ---- the port on its own ----------------------------------------------------------------------


class TestLearns:
    def test_learns_signal(self):
        """tests/test_models.py::TestWindPuller::test_learns_signal on the port."""
        rng = np.random.default_rng(0)
        n, t, f = 256, 8, 6
        x = rng.standard_normal((n, t, f)).astype(np.float32)
        y = np.tanh(x[:, -1, :1]).astype(np.float32)
        wp = W.WindPuller(input_shape=(t, f), outputs=1, hidden=(16,), lr=3e-3, seed=1,
                          device="cpu")
        hist = wp.fit(x, y, epochs=12, batch_size=64, verbose=False)
        assert hist["loss"][-1] < hist["loss"][0]
        m = wp.evaluate(x, y)
        assert m["directional_accuracy"] > 0.7
        assert m["pearson"] > 0.5


class TestCLI:
    def test_pipeline_in_process(self, tmp_path, capsys):
        def run(*args):
            assert cli.main(list(args)) == 0
            return capsys.readouterr().out

        d, feats, model = str(tmp_path / "data"), str(tmp_path / "f.npz"), str(tmp_path / "wp.pkl")
        assert run("gen-data", "--out", d, "--days", "300", "--universes", "indices") == \
            f"wrote 4 tickers to {d}\n"
        out = run("audit", "--data", d)
        assert out.splitlines()[-1].startswith("common overlap: ") and len(out.splitlines()) == 5
        out = run("features", "--data", d, "--out", feats, "--window", "16")
        fs = F.FeatureSet.load(feats)
        n_test = len(fs.x) - fs.n_train
        assert out == (f"features: X{fs.x.shape} y{fs.y.shape} train={fs.n_train} "
                       f"assets=4 -> {feats}\n")
        assert fs.x.shape == (300 - 16 + 1 - 5, 16, 4 * 24)
        out = run("train", "--features", feats, "--model", model, "--epochs", "2",
                  "--hidden", "8", "--device", "cpu")
        lines = out.splitlines()
        assert [ln.split(" loss=")[0] for ln in lines[:2]] == ["epoch 1/2", "epoch 2/2"]
        losses = [float(ln.split(" loss=")[1].split()[0]) for ln in lines[:2]]
        assert np.all(np.isfinite(losses))
        assert lines[2] == f"best-val checkpoint -> {model}" and os.path.exists(model)
        out = run("eval", "--features", feats, "--model", model, "--device", "cpu")
        assert out.startswith("loss=") and " directional_accuracy=" in out and " pearson=" in out
        pred, cum = str(tmp_path / "pred.tsv"), str(tmp_path / "cum.tsv")
        out = run("predict", "--features", feats, "--model", model, "--out", pred,
                  "--cumret", cum, "--device", "cpu")
        assert out == f"predictions -> {pred}\ncumulative returns -> {cum}\n"
        rows = Path(pred).read_text().splitlines()
        assert rows[0] == "date\t" + "\t".join(f"pred_{t}" for t in fs.tickers)
        assert len(rows) == 1 + n_test and rows[1].split("\t")[0] == fs.dates[fs.n_train]
        crow = Path(cum).read_text().splitlines()
        assert crow[0] == "date\tcumret" and len(crow) == 1 + n_test
        assert np.all(np.isfinite([float(r.split("\t")[1]) for r in crow[1:]]))

    @pytest.mark.parametrize("cmd", ["gen-data", "features", "train", "eval", "predict",
                                     "audit"])
    def test_flags_as_jax(self, cmd, capsys):
        import re

        from dla_tpu.models import cli as jax_cli

        def flags(main):
            with pytest.raises(SystemExit) as e:
                main([cmd, "--help"])
            assert e.value.code == 0
            return sorted(set(re.findall(r"(--[a-z-]+)", capsys.readouterr().out)))

        extra = ["--device"] if cmd in ("train", "eval", "predict") else []
        assert flags(cli.main) == sorted(flags(jax_cli.main) + extra)

    def test_cuda_without_a_card_exits_2(self, tmp_path, capsys):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        assert cli.main(["eval", "--features", str(tmp_path / "none.npz"), "--model",
                         str(tmp_path / "none.pkl")]) == 2
        assert "use --device cpu" in capsys.readouterr().err


class TestImports:
    def test_with_jax_blocked(self, tmp_path):
        """The port's modules import, and read a JAX-written checkpoint, with jax,
        flax, optax, orbax and dla_tpu unimportable."""
        ref = JW.WindPuller(input_shape=(5, 4), outputs=2, hidden=(8,), seed=3)
        path = tmp_path / "wp.pkl"
        ref.save(str(path))
        x = np.random.default_rng(1).standard_normal((7, 5, 4)).astype(np.float32)
        np.save(tmp_path / "x.npy", x)
        np.save(tmp_path / "want.npy", ref.predict(x))
        code = f"""
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "dla_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {{name}}")
sys.meta_path.insert(0, Block())
import pickle
import numpy as np
import dla_tpu_torch.models.cli, dla_tpu_torch.models.windpuller
import dla_tpu_torch.models.renorm, dla_tpu_torch.models.features, dla_tpu_torch.models
with open({str(path)!r}, "rb") as f:
    d = pickle.load(f)
def plain(t):
    return all(plain(v) for v in t.values()) if isinstance(t, dict) else type(t) is np.ndarray
assert type(d["params"]) is dict and plain(d["params"]), d["params"]
wp = dla_tpu_torch.models.WindPuller.load({str(path)!r}, device="cpu")
got = wp.predict(np.load({str(tmp_path / 'x.npy')!r}))
print(float(np.abs(got - np.load({str(tmp_path / 'want.npy')!r})).max()))
print(sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED))
"""
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                              text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
        assert proc.returncode == 0, proc.stderr
        diff, mods = proc.stdout.splitlines()
        assert float(diff) <= 1e-5 and mods == "[]"


class TestDevice:
    def test_default_device_raises_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            W.WindPuller((T, NF))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            W.WindPuller((T, NF), device="cuda")
