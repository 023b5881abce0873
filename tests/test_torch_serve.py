"""The port's serving entry point (``repro_torch.launch.serve``) against the
JAX reference's serving loop, on the CPU.

For every arch at ``reduced()``, ``serve.main([... "--device", "cpu"])``
runs on the reference's own serving params (``PRNGKey(seed)``, carried
across) and the reference's prompt (numpy, the same seed), and its greedy
tokens equal those of the reference's prefill-by-decode loop
(``repro.launch.serve``'s, run here on its jitted ``decode_step``).  Where
a row's token differs, the first differing step must be a near tie in the
reference: its top two logits within ``TIE`` of the row's largest
magnitude (the whole-model bound on the mean difference, 0.01, once for
each logit of the pair); the row is not compared past it.  Any other
difference fails.  Then the port's example, ``examples/serve_lm_torch.py
--device cpu``, runs as a process.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from repro.models import api as rapi
from repro_torch.launch import serve
from repro_torch.models import api as tapi
from tests.test_torch_batch import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TIE = 0.02
ARGS = {"batch": 2, "prompt-len": 8, "gen": 8, "max-len": 32, "seed": 0}


def argv(arch):
    out = ["--arch", arch, "--reduced", "--device", "cpu"]
    for k, v in ARGS.items():
        out += [f"--{k}", str(v)]
    return out


def reference_serve(arch):
    """The reference's serving loop (repro/launch/serve.py), keeping each
    step's logits: (params, tokens (B, gen), logits (gen, B, V))."""
    cfg = rapi.get_config(arch).reduced()
    model = rapi.build_model(cfg)
    params = model.init_params(jax.random.PRNGKey(ARGS["seed"]))
    r = np.random.default_rng(ARGS["seed"])
    B, P, G = ARGS["batch"], ARGS["prompt-len"], ARGS["gen"]
    prompt = jnp.asarray(r.integers(1, cfg.vocab, (B, P)).astype(np.int32))
    cache = model.init_cache(B, ARGS["max-len"])
    decode = jax.jit(model.decode_step)
    for t in range(P):
        logits, cache = decode(params, cache, prompt[:, t: t + 1], jnp.int32(t))
    seen = [np.asarray(logits, np.float32)]
    toks = [jnp.argmax(logits, -1).astype(jnp.int32)]
    for t in range(P, P + G - 1):
        logits, cache = decode(params, cache, toks[-1][:, None], jnp.int32(t))
        seen.append(np.asarray(logits, np.float32))
        toks.append(jnp.argmax(logits, -1).astype(jnp.int32))
    return params, np.stack([np.asarray(t) for t in toks], 1), np.stack(seen)


@pytest.mark.parametrize("arch", rapi.ARCH_IDS)
def test_serve_main_gives_reference_tokens(arch, monkeypatch, capsys):
    rparams, want, ref_logits = reference_serve(arch)
    model = tapi.build_model(tapi.get_config(arch).reduced())
    params = tapi.load_reference_params(
        model, jax.tree.map(np.asarray, rparams), device="cpu")
    runs = []
    real = serve.run
    monkeypatch.setattr(serve, "run", lambda a, p=None: runs.append(real(a, p))
                        or runs[-1])
    assert serve.main(argv(arch), params) == 0
    out = capsys.readouterr().out
    got = runs[0].tokens
    assert f"[serve] {arch} batch={ARGS['batch']} gen={ARGS['gen']} " \
        "tokens/s=" in out
    assert f"[serve] sample: {got[0][:12].tolist()}" in out
    assert got.shape == want.shape
    for row in range(want.shape[0]):
        diff = np.flatnonzero(got[row] != want[row])
        if not diff.size:
            continue
        step = int(diff[0])
        lg = ref_logits[step, row]
        top2 = np.sort(lg)[-2:]
        gap, scale = float(top2[1] - top2[0]), float(np.abs(lg).max())
        print(f"{arch} row {row}: first differing step {step} (port "
              f"{got[row, step]}, reference {want[row, step]}); reference's "
              f"top two logits {top2[1]:.4f} and {top2[0]:.4f}, gap {gap:.4f} "
              f"of max |logit| {scale:.4f}")
        assert gap <= TIE * max(scale, 1.0), (arch, row, step, gap, scale)
    print(f"{arch}: tokens {got.tolist()} vs reference {want.tolist()}")


def test_example_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" /
                                               "serve_lm_torch.py"),
                           "--device", "cpu"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[serve]")]
    assert len(lines) == 2 and "gemma3_12b batch=4 gen=12" in lines[0], \
        proc.stdout


def test_no_card_raises_without_device_cpu():
    """The entry point's default device is cuda: without a card it raises
    rather than fall back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        serve.main(["--arch", "mamba2_370m", "--reduced", "--batch", "1",
                    "--prompt-len", "2", "--gen", "2"])
