"""Train a tiny LM end-to-end on the synthetic pipeline with checkpointing,
on the PyTorch port: ``cuda`` by default, ``--device cpu`` without a card.

    PYTHONPATH=src python examples/train_tiny_lm_torch.py [--arch mamba2_370m] \
        [--device cpu]

Uses the port's launcher (repro_torch.launch.train): reduced config, a few
hundred steps, loss printed every 25 steps, checkpoint every 50 (in the
temporary directory) — kill it anytime and rerun with --resume.
"""
import os
import sys
import tempfile

from repro_torch.launch.train import main

if __name__ == "__main__":
    argv = ["--arch", "mamba2_370m", "--reduced", "--steps", "200",
            "--batch", "8", "--seq", "64", "--ckpt-every", "50",
            "--log-every", "25",
            "--ckpt-dir", os.path.join(tempfile.gettempdir(), "repro_tiny_lm")]
    argv += sys.argv[1:]
    raise SystemExit(main(argv))
