"""Train a small LM end to end with the paper's technique in the training
stack, on the PyTorch/CUDA port: bitplane gradient compression (error
feedback) + progressive QoI-bounded checkpoints, then a warm restart from a
*partial* checkpoint.  The counterpart of ``train_lm_progressive.py``.

    PYTHONPATH=src python examples/train_lm_progressive_torch.py
    PYTHONPATH=src python examples/train_lm_progressive_torch.py --device cpu

Runs on CUDA unless ``--device cpu`` is given.
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = ["--device", args.device] if args.device else []
    ckpt_dir = os.path.join(tempfile.mkdtemp(), "ckpt")
    print("== phase 1: train 120 steps with grad compression + progressive "
          "checkpoints ==")
    train_main(["--arch", "internlm2-1.8b", "--reduced",
                "--steps", "120", "--batch", "4", "--seq", "64",
                "--grad-compress", "8",
                "--progressive-ckpt", ckpt_dir, "--ckpt-every", "40",
                "--log-every", "20"] + dev)

    print("\n== phase 2: warm restart from a PARTIAL restore "
          "(tau=1e-3 — only the top bitplanes move) ==")
    train_main(["--arch", "internlm2-1.8b", "--reduced",
                "--steps", "160", "--batch", "4", "--seq", "64",
                "--progressive-ckpt", ckpt_dir, "--resume",
                "--restore-tau", "1e-3", "--log-every", "20"] + dev)


if __name__ == "__main__":
    main()
