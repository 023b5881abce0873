"""Batched serving launcher: prefill + decode loop with a KV cache.  The port
of ``repro.launch.serve``, on ``cuda`` unless ``--device`` says otherwise.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_12b \
        --reduced --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Weights are random, from ``torch.Generator(device).manual_seed(seed)``,
drawn on the device and held as ``api.serving_params`` (bf16 matrices).
The prompt is the reference's: ``np.random.default_rng(seed)`` integers.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models import api


@dataclasses.dataclass
class ServeRun:
    """What one serving run produced (``run``)."""
    cfg: object
    model: object
    params: dict                 # the serving copy
    prompt: torch.Tensor         # (B, prompt_len) int32 on the device
    cache: dict                  # the KV cache after the last step
    tokens: np.ndarray           # (B, gen) greedy tokens
    prompt_logits: torch.Tensor  # (B, V): after the last prompt token
    logits: torch.Tensor         # (B, V): after the last step
    seconds: float               # the whole loop, ending in a copy to the host
    step_ms: list                # each decode step's ms (CUDA events on cuda)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3_12b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


class _StepTimer:
    """Each step's time: CUDA events on a card (read once, at the end),
    the host clock on the CPU (whose work is synchronous)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self) -> list:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def run(argv=None, params: Optional[dict] = None) -> ServeRun:
    """Serve one batch: the prompt fed through the decode step token by
    token, then ``gen`` greedy tokens.  ``params``: the model's f32 params
    (e.g. from ``api.load_reference_params``), left as they are; by
    default random ones from ``--seed``."""
    args = parse_args(argv)
    device = torch.device(args.device)
    cfg = api.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = api.build_model(cfg)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = api.serving_params(model.init_params(gen))
    else:
        params = api.serving_params(api.copy_tree(params))

    r = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(
        r.integers(1, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    ).to(device)

    cache = model.init_cache(args.batch, args.max_len, device=device)
    timer = _StepTimer(device)

    # prefill by stepping the decode path token by token; the cache is
    # written in place (the reference donates it to its jitted step)
    t0 = time.perf_counter()
    timer.mark()
    logits = None
    for t in range(args.prompt_len):
        logits, cache = model.decode_step(params, cache, prompt[:, t: t + 1], t)
        timer.mark()
    prompt_logits = logits
    toks = [torch.argmax(logits, -1).to(torch.int32)]
    for t in range(args.prompt_len, args.prompt_len + args.gen - 1):
        logits, cache = model.decode_step(params, cache, toks[-1][:, None], t)
        timer.mark()
        toks.append(torch.argmax(logits, -1).to(torch.int32))
    out = torch.stack(toks, dim=1).cpu().numpy()
    seconds = time.perf_counter() - t0
    return ServeRun(cfg, model, params, prompt, cache, out, prompt_logits,
                    logits, seconds, timer.ms())


def main(argv=None, params: Optional[dict] = None) -> int:
    args = parse_args(argv)
    res = run(argv, params)
    tps = args.batch * (args.prompt_len + args.gen) / res.seconds
    print(f"[serve] {args.arch} batch={args.batch} gen={args.gen} "
          f"tokens/s={tps:.1f}")
    print("[serve] sample:", res.tokens[0][:12].tolist())
    if not torch.isfinite(res.logits).all():
        raise AssertionError("[serve] non-finite logits")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
