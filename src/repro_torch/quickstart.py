"""Quickstart: FL-DP³S vs FedAvg on synthetic non-IID image data.

Runs the paper's Algorithm 1 at reduced scale through ``FLTrainer`` — one
trainer per strategy on the same data, profiles and initial params — with
the eq.-(14) kernel built by the K1 + K2 CUDA kernels, and prints accuracy,
GEMD and loss per evaluation round.

    PYTHONPATH=src python -m repro_torch.quickstart [--rounds 40] [--xi 1.0] [--device cpu]

It runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.selection import make_strategy
from repro_torch.data import make_image_dataset, skewness_partition
from repro_torch.device import resolve_device
from repro_torch.fl.trainer import FLConfig, FLTrainer
from repro_torch.models import cnn

METHODS = ("fl-dp3s", "fedavg")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--clients", type=int, default=30)
    ap.add_argument("--per-round", type=int, default=5)
    ap.add_argument("--xi", default="1.0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    xi = args.xi if args.xi in ("H", "h") else float(args.xi)
    device = resolve_device(args.device)

    cfg = FLConfig(
        num_clients=args.clients,
        clients_per_round=args.per_round,
        rounds=args.rounds,
        local_epochs=2,
        lr=0.1,
        eval_every=5,
        seed=args.seed,
    )
    ds = make_image_dataset(n=cfg.num_clients * 200, seed=0)
    shards = skewness_partition(
        ds.ys, cfg.num_clients, xi, ds.num_classes, samples_per_client=200, seed=cfg.seed
    )
    client_xs = np.stack([ds.xs[s] for s in shards])
    client_ys = np.stack([ds.ys[s] for s in shards])
    params = cnn.init_cnn(torch.Generator(device=device).manual_seed(cfg.seed))

    for name in METHODS:
        trainer = FLTrainer(
            cfg, params, cnn.cnn_loss, cnn.apply_with_features, client_xs, client_ys,
            make_strategy(name), accuracy_fn=cnn.accuracy, device=device,
        )
        hist = trainer.run(progress=True)
        print(
            f"== {name}: final acc={hist['acc'][-1]:.4f}  "
            f"mean GEMD={float(np.mean(hist['gemd'])):.3f}\n"
        )


if __name__ == "__main__":
    main()
