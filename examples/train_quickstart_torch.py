"""Train a reduced LM end to end with the port's production stack.

    PYTHONPATH=src python examples/train_quickstart_torch.py [--steps 30]
    PYTHONPATH=src python examples/train_quickstart_torch.py --device cpu

The PyTorch counterpart of ``examples/train_quickstart.py``: the same
config, model, optimizer and trainer path as ``repro_torch.launch.train``
(the fault-tolerant Trainer with a checkpoint every 10 steps, the NaN
fuse, the straggler log, over the deterministic token pipeline), on the
card by default.  Stop it mid-run and run it again on the same ``--ckpt``
directory: it resumes from the last checkpoint and replays the exact
interrupted batch.
"""

import argparse
import tempfile

from repro_torch.launch import train as train_mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="the torch device (default the card)")
    args = ap.parse_args()
    ckpt = args.ckpt or tempfile.mkdtemp(prefix="repro-ckpt-")
    print(f"checkpoints -> {ckpt}")
    argv = ["--arch", args.arch, "--steps", str(args.steps), "--batch", "4",
            "--seq", "64", "--ckpt-dir", ckpt]
    if args.device is not None:
        argv += ["--device", args.device]
    train_mod.main(argv)


if __name__ == "__main__":
    main()
