"""The port's training plane (``repro_torch.train``: AdamW, the synthetic
data, checkpoints) and trainer (``repro_torch.launch.train``) against the
JAX reference's, on the CPU; mirrors of ``tests/test_train_infra.py``.

- AdamW: the same numpy params (one leaf bf16), grads, m, v and step
  through both packages' ``adamw_update`` at steps 0, 1 and 99, with the
  clip active and inactive: params, m and v within a relative 1e-6 of
  each leaf's largest magnitude (the largest ULP distance printed);
  ``cosine_lr`` within a relative 1e-6 at steps 0 to 10,000.
- Data: ``batch_at`` bit for bit the reference's.
- Checkpoints: the reference test's roundtrip and keep-K, and the format
  crossing the packages both ways bit for bit, manifests equal.
- Trainer: ``python -m repro_torch.launch.train --device cpu`` crashed at
  step 6 and resumed from step 4 ends at the uninterrupted run's loss.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

from repro.train import optimizer as ropt
from repro.train.checkpoint import CheckpointManager as RefCheckpoints
from repro.train.data import SyntheticLM as RefSyntheticLM
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import Prefetcher, SyntheticLM
from repro_torch.tree import leaves_with_path
from tests.test_torch_batch import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
STATE_REL = 1e-6


def opt_inputs(seed: int, grad_scale: float):
    """A nested tree (one bf16 leaf, one 0-d leaf): params, grads, m, v."""
    r = np.random.default_rng(seed)
    shapes = {"a": (37, 5), "b": {"c": (64,), "d": (3, 4, 5)}, "e": ()}

    def draw(f):
        return {"a": f(shapes["a"]), "b": {"c": f(shapes["b"]["c"]),
                                          "d": f(shapes["b"]["d"])},
                "e": f(shapes["e"])}

    p = draw(lambda s: r.standard_normal(s).astype(np.float32))
    p["b"]["c"] = p["b"]["c"].astype(ml_dtypes.bfloat16)
    g = draw(lambda s: (r.standard_normal(s) * grad_scale).astype(np.float32))
    g["b"]["c"] = g["b"]["c"].astype(ml_dtypes.bfloat16)
    m = draw(lambda s: (r.standard_normal(s) * 0.01).astype(np.float32))
    v = draw(lambda s: (r.random(s) * 1e-4).astype(np.float32))
    return p, g, m, v


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bits(x):
    """The raw bits of a tensor or array as int64, and its dtype name."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().astype(np.int64), "bfloat16"
        a = x.numpy()
    else:
        a = np.asarray(x)
        if a.dtype == ml_dtypes.bfloat16:
            return a.view(np.int16).astype(np.int64), "bfloat16"
    return a.view(np.int32 if a.itemsize == 4 else np.int16).astype(np.int64), \
        str(a.dtype)


@pytest.mark.parametrize("step", [0, 1, 99])
@pytest.mark.parametrize("grad_scale", [1.0, 1e-3], ids=["clipped", "unclipped"])
def test_adamw_matches_reference(step, grad_scale):
    p, g, m, v = opt_inputs(step, grad_scale)
    want = ropt.adamw_update(p, g, m, v, jnp.int32(step))
    got = topt.adamw_update(to_torch(p), to_torch(g), to_torch(m), to_torch(v),
                            torch.tensor(step, dtype=torch.int32))
    ulp = 0
    for name, w, t in zip("pmv", want, got):
        wl, tl = leaves_with_path(jax.tree.map(np.asarray, w)), leaves_with_path(t)
        assert [a for a, _ in wl] == [a for a, _ in tl]
        for (path, a), (_, b) in zip(wl, tl):
            ba, da = bits(a)
            bb, db = bits(b)
            assert da == db, (name, path, da, db)
            fa, fb = as_f32(a), as_f32(b)
            scale = max(float(np.abs(fa).max()), 1e-30)
            assert (np.abs(fa - fb) <= STATE_REL * scale).all(), (name, path)
            ulp = max(ulp, int(np.abs(ba - bb).max()))
    print(f"step {step}, grads x {grad_scale}: largest ulp distance {ulp}")


def test_cosine_lr_matches_reference():
    for s in (0, 50, 99, 100, 101, 5000, 9999, 10000, 12000):
        for arg_r, arg_t in ((s, s), (jnp.int32(s), torch.tensor(s, dtype=torch.int32))):
            want = float(ropt.cosine_lr(arg_r))
            got = float(topt.cosine_lr(arg_t))
            assert abs(got - want) <= STATE_REL * abs(want), (s, want, got)


def test_init_train_state():
    p = to_torch(opt_inputs(0, 1.0)[0])
    st = topt.init_train_state(p)
    assert st["step"].dtype == torch.int32 and st["step"].shape == ()
    assert st["m"]["b"]["c"].dtype == torch.bfloat16
    assert all(not x.any() for _, x in leaves_with_path(st["v"]))


@pytest.mark.parametrize("seed,host,hosts,step",
                         [(0, 0, 1, 0), (3, 0, 1, 17), (3, 1, 2, 17),
                          (7, 3, 4, 123456), (1, 0, 1, 5)])
def test_batch_at_bit_identical(seed, host, hosts, step):
    want = RefSyntheticLM(1000, 24, 8, seed=seed, host_id=host,
                          n_hosts=hosts).batch_at(step)
    got = SyntheticLM(1000, 24, 8, seed=seed, host_id=host,
                      n_hosts=hosts).batch_at(step)
    for k in ("tokens", "targets"):
        assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


def test_data_determinism():
    d1 = SyntheticLM(100, 16, 4, seed=3)
    d2 = SyntheticLM(100, 16, 4, seed=3)
    b1, b2 = d1.batch_at(17), d2.batch_at(17)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(d1.batch_at(18)["tokens"], b1["tokens"])
    with pytest.raises(ValueError, match="does not split"):
        SyntheticLM(100, 16, 5, n_hosts=2)


def test_prefetcher_order():
    d = SyntheticLM(50, 8, 2, seed=1)
    pf = Prefetcher(d, start_step=5)
    try:
        for want in (5, 6, 7):
            s, b = pf.next()
            assert s == want
            assert torch.equal(b["tokens"], d.batch_at(want)["tokens"])
    finally:
        pf.close()


# ------------------------------------------------------------ checkpoints --

def small_state():
    return {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16) * 1.5},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    state = small_state()
    ck.save(5, state)
    out, step = ck.restore(state)
    assert step == 5
    assert torch.equal(out["a"], torch.arange(10, dtype=torch.float32))
    assert out["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(out["b"]["c"], state["b"]["c"])
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 7


def test_checkpoint_keep_k(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    s = {"x": torch.zeros(3)}
    for i in (1, 2, 3, 4):
        ck.save(i, s)
    steps = sorted(x for x in os.listdir(tmp_path) if x.startswith("step_"))
    assert len(steps) == 2
    assert ck.latest_step() == 4


def test_checkpoint_async_writer_and_refusals(tmp_path):
    """The async writer publishes after ``wait``; a later in-place change
    of the state does not reach it; restore refuses a shape mismatch, an
    incomplete manifest and an empty directory, and places each leaf on
    the device its sharding names."""
    ck = CheckpointManager(str(tmp_path), keep=3)
    with pytest.raises(FileNotFoundError):
        ck.restore(small_state())
    state = small_state()
    ck.save(3, state)
    state["a"].add_(1.0)
    ck.wait()
    out, _ = ck.restore(small_state())
    assert torch.equal(out["a"], torch.arange(10, dtype=torch.float32))
    bad = small_state()
    bad["a"] = torch.zeros(11)
    with pytest.raises(ValueError, match="shape"):
        ck.restore(bad)
    mesh = tmesh.make_host_mesh(backend="cpu")
    sh = {"a": tshd.replicated(mesh), "b": {"c": tshd.replicated(mesh)},
          "step": tshd.replicated(mesh)}
    out, _ = ck.restore(small_state(), shardings=sh)
    assert all(x.device == torch.device("cpu") for _, x in leaves_with_path(out))
    d = tmp_path / "step_000000003" / "manifest.json"
    man = json.loads(d.read_text())
    man["complete"] = False
    d.write_text(json.dumps(man))
    with pytest.raises(ValueError, match="incomplete"):
        ck.restore(small_state())


def ref_state():
    """A reference TrainState: f32 params, bf16 leaf, 0-d int32 step."""
    r = np.random.default_rng(5)
    params = {"embed": jnp.asarray(r.standard_normal((16, 8)).astype(np.float32)),
              "blocks": {"w": jnp.asarray(r.standard_normal((2, 8, 8)),
                                          jnp.bfloat16),
                         "ln": jnp.zeros((2, 8), jnp.float32)}}
    st = ropt.init_train_state(params)
    st["m"] = jax.tree.map(lambda x: x + 0.25, st["m"])
    st["step"] = jnp.int32(42)
    return st


def manifest(d, step):
    return json.loads((Path(d) / f"step_{step:09d}" / "manifest.json").read_text())


def test_checkpoints_cross_packages(tmp_path):
    """A reference TrainState saved by the reference restores in the port
    bit for bit (bf16 and the 0-d int32 step included); the port's save of
    it restores in the reference bit for bit; the two manifests list the
    same paths, files, shapes and dtypes."""
    rs = ref_state()
    RefCheckpoints(str(tmp_path / "ref"), async_write=False).save(9, rs)
    template = to_torch(jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), rs))
    ported, step = CheckpointManager(str(tmp_path / "ref")).restore(template)
    assert step == 9
    for (p, a), (q, b) in zip(leaves_with_path(jax.tree.map(np.asarray, rs)),
                              leaves_with_path(ported)):
        assert p == q and bits(a)[1] == bits(b)[1]
        assert np.array_equal(bits(a)[0], bits(b)[0]), p
    assert ported["step"].shape == () and ported["step"].dtype == torch.int32
    CheckpointManager(str(tmp_path / "port"), async_write=False).save(9, ported)
    back, step = RefCheckpoints(str(tmp_path / "port")).restore(rs)
    assert step == 9
    for (p, a), (_, b) in zip(leaves_with_path(jax.tree.map(np.asarray, rs)),
                              leaves_with_path(jax.tree.map(np.asarray, back))):
        assert a.dtype == b.dtype and np.array_equal(bits(a)[0], bits(b)[0]), p
    assert manifest(tmp_path / "ref", 9) == manifest(tmp_path / "port", 9)
    assert sorted(os.listdir(tmp_path / "ref" / "step_000000009")) == \
        sorted(os.listdir(tmp_path / "port" / "step_000000009"))


# ---------------------------------------------------------------- trainer --

def start_trainer(args, ckpt):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
            "--arch", "mamba2_370m", "--reduced", "--steps", "12", "--batch",
            "2", "--seq", "32", "--ckpt-every", "4", "--log-every", "1"]
    return subprocess.Popen(base + ["--ckpt-dir", str(ckpt)] + args,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)


def finish(proc):
    """(exit code, stdout, stdout and stderr) of a started trainer."""
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    return proc.returncode, out, out + err


def test_crash_and_resume_matches_uninterrupted(tmp_path):
    """The reference test's runs on the port: crash after step 6, resume
    from the step-4 checkpoint, the final loss text equal to the
    uninterrupted run's; the 12 logged losses finite, the last below the
    first.  The uninterrupted run goes on beside the other two."""
    gold_proc = start_trainer([], tmp_path / "a")
    try:
        rc, _, log = finish(start_trainer(["--crash-at", "6"], tmp_path / "b"))
        assert rc == 17, log
        rc, resumed, log = finish(start_trainer(["--resume"], tmp_path / "b"))
        assert rc == 0 and "resumed from step 4" in resumed, log
    finally:
        rc, out, log = finish(gold_proc)
    assert rc == 0 and "done" in out, log
    gold = out.strip().splitlines()[-1]
    losses = [float(ln.split("loss=")[1].split()[0])
              for ln in out.splitlines() if "loss=" in ln]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    got = resumed.strip().splitlines()[-1]
    print(f"uninterrupted: {gold}\nresumed:       {got}")
    assert gold.split("->")[-1] == got.split("->")[-1], (gold, got)


def test_example_runs_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" /
                                               "train_tiny_lm_torch.py"),
                           "--device", "cpu", "--steps", "30", "--ckpt-dir",
                           str(tmp_path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[train] done: first loss" in proc.stdout, proc.stdout
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_000000030"]


def test_no_card_raises_without_device_cpu(tmp_path):
    """The trainer's default device is cuda: without a card it raises
    rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        ttrain.main(["--arch", "mamba2_370m", "--reduced", "--steps", "1",
                     "--ckpt-dir", str(tmp_path)])
