"""Training launcher with checkpoint/restart fault tolerance.  The port of
``repro.launch.train``, on ``cuda`` unless ``--device`` says otherwise.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_370m \
        --reduced --steps 200 --ckpt-dir DIR [--batch 8 --seq 128] \
        [--resume] [--device cpu]

Weights are random, from ``torch.Generator(device).manual_seed(seed)``.
Crash-and-resume is bit-exact: kill at any step, relaunch with
``--resume``, and training continues from the last checkpoint to the
uninterrupted run's final loss (the data pipeline is a pure function of
the step; on a card the trainer runs deterministic kernels, see
``deterministic``).  The checkpoints are the reference's format.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import Prefetcher, SyntheticLM
from repro_torch.train.optimizer import init_train_state


def deterministic(device: torch.device) -> None:
    """On a card, make every step reproducible bit for bit: PyTorch's
    deterministic algorithms (the index backward of the embedding gather
    sorts instead of adding with atomics) and a fixed cuBLAS workspace,
    which cuBLAS needs for reproducible GEMMs.  The workspace setting is
    read when cuBLAS starts, so call this before the first GEMM of the
    process."""
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)


def build(arch: str, reduced: bool):
    cfg = api.get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    return cfg, api.build_model(cfg)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_370m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--crash-at", type=int, default=-1,
                    help="simulate failure after N steps (tests)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    deterministic(device)
    cfg, model = build(args.arch, args.reduced)
    mesh = make_host_mesh(backend=device.type)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_train_state(model.init_params(gen))
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        sh = shd.state_shardings(state, mesh)
        state, start_step = ckpt.restore(state, shardings=sh)
        print(f"[train] resumed from step {start_step}", flush=True)

    step_fn = api.make_train_step(cfg)
    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=args.seed)
    pf = Prefetcher(data, start_step=start_step)

    losses = []
    t0 = time.time()
    try:
        for i in range(start_step, args.steps):
            s, batch = pf.next()
            if s != i:
                raise RuntimeError(f"prefetcher gave step {s} for step {i}")
            batch = {k: x.to(device) for k, x in batch.items()}
            if cfg.family == "encdec":
                batch["frames"] = torch.zeros(
                    (args.batch, 32, cfg.frame_dim), dtype=torch.bfloat16,
                    device=device)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            if i % args.log_every == 0 or i == args.steps - 1:
                print(f"[train] step={i} loss={loss:.4f} "
                      f"({(time.time()-t0):.1f}s)", flush=True)
            if (i + 1) % args.ckpt_every == 0 or i == args.steps - 1:
                ckpt.save(i + 1, state)
            if args.crash_at >= 0 and i + 1 >= args.crash_at:
                print("[train] simulated crash", flush=True)
                ckpt.wait()
                return 17
        ckpt.wait()
    finally:
        pf.close()
    print(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
