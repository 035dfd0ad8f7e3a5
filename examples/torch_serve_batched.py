"""Serving on the PyTorch port: batched prefill and decode for several
architectures, including the O(1)-state RWKV-6 and the hybrid
recurrentgemma, through the port's serve launcher.

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]
"""

import argparse

from repro_torch.launch import serve as serve_mod

ARCHS = ("smollm-360m", "rwkv6-7b", "recurrentgemma-9b")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = [] if args.device is None else ["--device", args.device]
    out = {}
    for arch in ARCHS:
        print(f"=== {arch} (reduced) ===")
        out[arch] = serve_mod.main(["--arch", arch, "--batch", str(args.batch), "--prompt-len",
                                    str(args.prompt_len), "--gen", str(args.gen)] + device)
    return out


if __name__ == "__main__":
    main()
