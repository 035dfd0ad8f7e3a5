"""Quickstart on the PyTorch port: FL-DP³S against FedAvg on synthetic
non-IID image data.

Runs the paper's Algorithm 1 at reduced scale through the port's
federation engine: both strategies share one multi-strategy ``round_fn``
(dispatched on ``ServerState.strategy_index``) and run as one ``run_many``
grid over states that share the data, profiles, initial losses and the
eq.-(14) kernel (K1 + K2 on the card).

    PYTHONPATH=src python examples/torch_quickstart.py [--rounds 40] [--xi 1.0] [--device cpu]

Local updates are pluggable: swap FedAvg's SGD for a drift-corrected
algorithm without touching the selection comparison, e.g.

    PYTHONPATH=src python examples/torch_quickstart.py --local-algo fedprox --prox-mu 0.01

It runs on ``cuda`` unless ``--device cpu`` is given.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import profiles as profiles_lib
from repro_torch.core.selection import make_strategy
from repro_torch.data import make_image_dataset, skewness_partition
from repro_torch.device import resolve_device
from repro_torch.fl import engine, local_algos
from repro_torch.fl.engine import FLConfig
from repro_torch.models import cnn

METHODS = ("fl-dp3s", "fedavg")


def federation(num_clients, xi, samples_per_client, data_seed, partition_seed, device):
    """Synthetic images split over ``num_clients`` with skewness ``xi`` ->
    (client images, client labels) on ``device``."""
    ds = make_image_dataset(n=num_clients * samples_per_client, seed=data_seed)
    shards = skewness_partition(
        ds.ys, num_clients, xi, ds.num_classes, samples_per_client=samples_per_client, seed=partition_seed
    )
    xs = torch.as_tensor(np.stack([ds.xs[s] for s in shards]), device=device)
    ys = torch.as_tensor(np.stack([ds.ys[s] for s in shards]), device=device)
    return xs, ys


def algorithm1_init(params, xs, ys):
    """Alg. 1 lines 2-5 with the fresh model: every client's FC-1 profile
    and initial loss."""
    prof = profiles_lib.profile_all_clients(cnn.apply_with_features, params, list(xs))
    with torch.no_grad():
        losses = torch.stack([cnn.cnn_loss(params, x, y) for x, y in zip(xs, ys)])
    return prof, losses


def build_states(cfg, strategies, params, xs, ys, device):
    """One state per strategy on one federation: shared profiles, losses
    and kernel; each strategy's own spectral cache and strategy_index."""
    prof, losses = algorithm1_init(params, xs, ys)
    states = []
    for i, strat in enumerate(strategies):
        states.append(engine.init_server_state(
            cfg, params, xs, ys, prof, losses, strat, device=device, loss_fn=cnn.cnn_loss,
            strategy_index=i, kernel=states[0].kernel if states else None,
        ))
    return states


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--clients", type=int, default=30)
    ap.add_argument("--per-round", type=int, default=5)
    ap.add_argument("--xi", default="1.0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--local-algo", default="fedavg", choices=sorted(local_algos.ALGO_NAMES))
    ap.add_argument("--prox-mu", type=float, default=None)
    ap.add_argument("--feddyn-alpha", type=float, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
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
        local_algo=args.local_algo,
        prox_mu=args.prox_mu,
        feddyn_alpha=args.feddyn_alpha,
    )
    xs, ys = federation(cfg.num_clients, xi, 200, 0, cfg.seed, device)
    params = cnn.init_cnn(torch.Generator(device=device).manual_seed(cfg.seed))
    strategies = tuple(make_strategy(m) for m in METHODS)
    states = build_states(cfg, strategies, params, xs, ys, device)

    # the whole strategy grid through one round_fn
    round_fn = engine.make_round_fn(cfg, cnn.cnn_loss, strategies, accuracy_fn=cnn.accuracy)
    finals, outs = engine.run_many(round_fn, engine.stack_states(states), args.rounds)
    per_run = engine.unstack_outputs(outs)

    results = {}
    for i, name in enumerate(METHODS):
        final_acc = None
        if args.rounds % cfg.eval_every != 0:
            final_acc = float(cnn.accuracy(finals[i].params, xs.reshape((-1,) + xs.shape[2:]), ys.reshape(-1)))
        hist = engine.history_from_outputs(per_run[i], cfg.eval_every, final_acc=final_acc)
        for t, a, g, l in zip(hist["round"], hist["acc"], hist["gemd"], hist["loss"]):
            print(f"[{name}] round {t:4d} acc={a:.4f} gemd={g:.3f} loss={l:.4f}")
        print(f"== {name}: final acc={hist['acc'][-1]:.4f}  mean GEMD={float(np.mean(hist['gemd'])):.3f}\n")
        results[name] = hist
    return results


if __name__ == "__main__":
    main()
