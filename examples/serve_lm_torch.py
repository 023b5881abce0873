"""Serve a small model with batched requests (prefill + decode loop), on the
PyTorch port: ``cuda`` by default, ``--device cpu`` without a card.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch gemma3_12b] \
        [--device cpu]
"""
import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    argv = ["--arch", "gemma3_12b", "--reduced", "--batch", "4",
            "--prompt-len", "16", "--gen", "12"]
    argv += sys.argv[1:]
    raise SystemExit(main(argv))
