"""Selection-strategy ablation on one non-IID federation, on the PyTorch
port's engine.

Every registry strategy with a pure draw (the paper's k-DPP, sampled and
greedy MAP, FedAvg's uniform draw, FedSAE's loss weighting, clustered
sampling, power-of-choice) runs on the same federation: one
multi-strategy ``round_fn``, every strategy × seed as one ``run_many``
grid, the host-side work (the cluster fit, the spectral caches) done once
at ``init_server_state``.  Prints final accuracy, mean GEMD and rounds to
a target accuracy per strategy.

    PYTHONPATH=src python examples/torch_selection_ablation.py [--rounds 30] [--device cpu]
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core.selection import make_strategy
from repro_torch.device import resolve_device
from repro_torch.fl import engine
from repro_torch.fl.engine import FLConfig
from repro_torch.models import cnn

from torch_quickstart import algorithm1_init, federation

METHODS = ("fl-dp3s", "fl-dp3s-map", "fedavg", "fedsae", "cluster", "power-of-choice")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--per-round", type=int, default=4)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--xi", type=float, default=1.0)
    ap.add_argument("--target-acc", type=float, default=0.6)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = FLConfig(
        num_clients=args.clients, clients_per_round=args.per_round,
        rounds=args.rounds, local_epochs=2, lr=0.1, eval_every=2, seed=0,
    )
    xs, ys = federation(args.clients, args.xi, 120, 0, 0, device)
    strategies = tuple(make_strategy(m) for m in METHODS)
    states = []
    for seed in range(args.seeds):
        params = cnn.init_cnn(torch.Generator(device=device).manual_seed(seed))
        prof, losses = algorithm1_init(params, xs, ys)
        shared = None
        for i, strat in enumerate(strategies):
            # each grid point draws from its own stream (JAX: key 100 * seed + i)
            state = engine.init_server_state(
                dataclasses.replace(cfg, seed=100 * seed + i), params, xs, ys, prof, losses, strat,
                device=device, loss_fn=cnn.cnn_loss, strategy_index=i,
                kernel=shared.kernel if shared else None,
            )
            shared = shared or state
            states.append(state)

    round_fn = engine.make_round_fn(cfg, cnn.cnn_loss, strategies, accuracy_fn=cnn.accuracy)
    _, outs = engine.run_many(round_fn, engine.stack_states(states), args.rounds)
    per_run = engine.unstack_outputs(outs)

    print(f"{'strategy':>16s}  {'final acc':>9s}  {'mean GEMD':>9s}  rounds to acc>={args.target_acc}")
    rows = {}
    for i, name in enumerate(METHODS):
        accs, gemds, rtts = [], [], []
        for seed in range(args.seeds):
            hist = engine.history_from_outputs(per_run[seed * len(METHODS) + i], cfg.eval_every)
            accs.append(hist["acc"][-1])
            gemds.append(float(np.mean(hist["gemd"])))
            hit = [t for t, a in zip(hist["round"], hist["acc"]) if a >= args.target_acc]
            rtts.append(hit[0] if hit else args.rounds)
        rows[name] = (float(np.mean(accs)), float(np.mean(gemds)), float(np.mean(rtts)))
        print(f"{name:>16s}  {rows[name][0]:9.4f}  {rows[name][1]:9.3f}  {rows[name][2]:6.1f}")
    return rows


if __name__ == "__main__":
    main()
