"""End-to-end training through the PyTorch port: the paper's GOOM-RNN
(§4.3) on Copy-Memory, the same run as ``examples/train_goom_rnn.py``.

The full 124M-parameter configuration (24 layers, d=768, GPT-2 vocab) on
the card, through the CUDA kernels:

  PYTHONPATH=src python examples/train_goom_rnn_torch.py --full --steps 300

The default is the reduced config (same family, 2 layers); on a machine
without a card add ``--device cpu`` (the kernels' plain versions).  A
non-diagonal recurrent model, computed in parallel by a prefix scan over
GOOMs, trains with no stabilization of any kind.
"""

import argparse

from repro_torch.launch.train import main as train_main


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="124M config (needs the card)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    argv = [
        "--arch", "goom-rnn-124m",
        "--task", "copy",
        "--steps", str(args.steps),
        "--seq-len", str(args.seq_len),
        "--batch", str(args.batch),
        "--lr", "3e-3",
        "--log-every", "20",
    ]
    if not args.full:
        argv.append("--smoke")
    if args.ckpt_dir:
        argv += ["--ckpt-dir", args.ckpt_dir]
    if args.device:
        argv += ["--device", args.device]
    train_main(argv)


if __name__ == "__main__":
    main()
