"""Train/eval/predict CLI for the finance model (↔ ``z/gossip2.py``).

The port of ``dla_tpu/models/cli.py``: the same subcommands, flags, defaults
and printed lines, plus ``--device`` (``cuda``, the default, or ``cpu``) on
``train``, ``eval`` and ``predict``. Without a card, ``--device cuda`` exits
2 with a message; it never carries on on the CPU.

Subcommands (``z/gossip2.py:189-216``): ``gen-data`` (dataset producer),
``features`` (panel pipeline → .npz), ``train`` (checkpoint on best val),
``eval``, ``predict`` (TSV exports incl. the cumulative-return series
``cumprod(1 + y·ŷ) − 1`` — ``z/gossip2.py:78-81,147-155``), ``audit``
(date-overlap audit).

Usage:
    python -m dla_tpu_torch.models.cli gen-data --out data/
    python -m dla_tpu_torch.models.cli features --data data/ --out feats.npz
    python -m dla_tpu_torch.models.cli train --features feats.npz --model wp.pkl
    python -m dla_tpu_torch.models.cli eval --features feats.npz --model wp.pkl
    python -m dla_tpu_torch.models.cli predict --features feats.npz --model wp.pkl \
        --out pred_test.tsv --cumret cumret_test.tsv
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dla-models-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen-data")
    g.add_argument("--out", required=True)
    g.add_argument("--days", type=int, default=1260)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--universes", nargs="*", default=None)

    f = sub.add_parser("features")
    f.add_argument("--data", required=True)
    f.add_argument("--out", required=True)
    f.add_argument("--window", type=int, default=30)
    f.add_argument("--horizon", type=int, default=5)
    f.add_argument("--train-frac", type=float, default=0.8)

    for name in ("train", "eval", "predict"):
        p = sub.add_parser(name)
        p.add_argument("--features", required=True)
        p.add_argument("--model", required=True)
        p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
        if name == "train":
            p.add_argument("--epochs", type=int, default=10)
            p.add_argument("--batch-size", type=int, default=64)
            p.add_argument("--hidden", type=int, nargs="*", default=[64, 32])
            p.add_argument("--lr", type=float, default=1e-3)
            p.add_argument("--seed", type=int, default=0)
        if name == "predict":
            p.add_argument("--out", default="pred_test.tsv")
            p.add_argument("--cumret", default=None)

    a = sub.add_parser("audit")
    a.add_argument("--data", required=True)

    args = ap.parse_args(argv)

    if args.cmd == "gen-data":
        from dla_tpu_torch.models.synthetic import generate_dataset

        tickers = generate_dataset(
            args.out, args.universes, days=args.days, seed=args.seed
        )
        print(f"wrote {len(tickers)} tickers to {args.out}")
        return 0

    if args.cmd == "features":
        from dla_tpu_torch.models.features import build_features

        fs = build_features(
            args.data,
            window=args.window,
            horizon=args.horizon,
            train_frac=args.train_frac,
        )
        fs.save(args.out)
        print(
            f"features: X{fs.x.shape} y{fs.y.shape} train={fs.n_train} "
            f"assets={len(fs.tickers)} -> {args.out}"
        )
        return 0

    if args.cmd == "audit":
        from dla_tpu_torch.models.features import audit_overlaps

        ranges = audit_overlaps(args.data)
        start = max(r[0] for r in ranges.values())
        end = min(r[1] for r in ranges.values())
        for t, (s, e, n) in sorted(ranges.items()):
            print(f"{t}\t{s}\t{e}\t{n}")
        print(f"common overlap: {start} .. {end}")
        return 0

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print(f"[dla-models-torch] {args.cmd} --device cuda: no CUDA device is available "
              "(torch.cuda.is_available() is False); use --device cpu", file=sys.stderr)
        return 2

    from dla_tpu_torch.models.features import FeatureSet
    from dla_tpu_torch.models.windpuller import WindPuller

    fs = FeatureSet.load(args.features)
    xtr, ytr = fs.train()
    xte, yte = fs.test()

    if args.cmd == "train":
        wp = WindPuller(
            input_shape=(fs.x.shape[1], fs.x.shape[2]),
            outputs=fs.y.shape[1],
            hidden=args.hidden,
            lr=args.lr,
            seed=args.seed,
            device=args.device,
        )
        wp.fit(
            xtr,
            ytr,
            epochs=args.epochs,
            batch_size=args.batch_size,
            validation=(xte, yte),
            checkpoint_path=args.model,
        )
        print(f"best-val checkpoint -> {args.model}")
        return 0

    wp = WindPuller.load(args.model, device=args.device)

    if args.cmd == "eval":
        m = wp.evaluate(xte, yte)
        print(
            f"loss={m['loss']:.4f} directional_accuracy="
            f"{m['directional_accuracy']:.4f} pearson={m['pearson']:.4f}"
        )
        return 0

    # predict
    pred = wp.predict(xte)
    dates = fs.dates[fs.n_train :]
    with open(args.out, "w") as fo:
        fo.write("date\t" + "\t".join(f"pred_{t}" for t in fs.tickers) + "\n")
        for d, row in zip(dates, pred):
            fo.write(d + "\t" + "\t".join(f"{v:.6f}" for v in row) + "\n")
    print(f"predictions -> {args.out}")
    if args.cumret:
        # portfolio daily return = mean over assets of position · realized
        port = (pred * yte).mean(axis=1)
        cum = np.cumprod(1.0 + port) - 1.0
        with open(args.cumret, "w") as fo:
            fo.write("date\tcumret\n")
            for d, v in zip(dates, cum):
                fo.write(f"{d}\t{v:.6f}\n")
        print(f"cumulative returns -> {args.cumret}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
