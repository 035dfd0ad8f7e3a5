"""Federated LM training with DPP selection on the PyTorch port.

Trains a reduced smollm-family decoder across topic-skewed clients,
comparing FL-DP³S with FedAvg selection on the same corpora through the
port's train launcher: the LLM-scale version of the paper's experiment
(profiles are each client's mean final hidden state).

    PYTHONPATH=src python examples/torch_train_fl_llm.py --rounds 300 [--device cpu]
"""

import argparse

from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--per-round", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = [] if args.device is None else ["--device", args.device]
    out = {}
    for selection in ("fl-dp3s", "fedavg"):
        print(f"=== selection: {selection} ===")
        out[selection] = train_mod.main([
            "--arch", args.arch, "--mode", "fl", "--selection", selection, "--rounds", str(args.rounds),
            "--clients", str(args.clients), "--per-round", str(args.per_round), "--local-steps", "2",
            "--local-batch", "4", "--seq", str(args.seq), "--log-every", str(args.log_every),
        ] + device)
    return out


if __name__ == "__main__":
    main()
