"""The port's training step (``repro_torch.models.api.make_train_step``)
against the JAX reference's, on the CPU, for all ten archs at
``reduced()``, on params carried across from the reference
(``api.load_reference_state``).

The reference runs one program per arch: its own
``make_train_step(cfg, microbatches=2)``, jitted, with the gradients it
hands to ``adamw_update`` recorded (``applied_grads``).  The port runs its
``make_train_step`` at microbatches 1 and 2, recorded the same way.

- (a) one step's loss (microbatches=1) is within 1 % of the reference
  step's (the bound tests/test_torch_models.py holds the loss value to);
  the two losses are one mean over the batch's tokens;
- (b) gradients: the port's, at microbatches 2 and 1, against the
  reference's: whole-tree corr >= 0.999 and, for every leaf whose
  reference gradient is not zero, the leaf's corr >= 0.999 (the lowest
  reading is 0.99991, gemma3's attn5/wk; a leaf left at zero or scrambled
  falls near 0); corr(port f32, port bf16) and the
  worst leaf are printed.  The params are the reference's PRNGKey(0) draw
  with its stacked matrices brought to unit fan-in variance
  (``unsaturated``): at the raw draw the attention softmaxes saturate and
  bf16 rounding decides the gradients (corr(port f32, port bf16) -0.008
  on gemma3), so no bound could tell a fault from rounding there;
- (c) AdamW applied to the reference's gradients gives the reference
  step's new state within a relative 1e-6 of each leaf's largest
  magnitude, v within 2e-6 (the global norm sums each leaf in XLA's order
  and in torch's, so the clip scale, and with it every element, moves by
  a few ulp, and v by twice as many);
- (d) 8 steps on a fixed batch lower the loss (tests/test_models.py's
  train test);
- (e) ``microbatches=2`` agrees with the reference's within 1 %, and with
  the port's own ``microbatches=1``.

Tracing and compiling the reference's ten steps takes nearly all of the
file's time (``references``); the port's steps take milliseconds.
"""
import contextlib
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.train.optimizer as ref_opt
import repro_torch.train.optimizer as port_opt
from repro.models import api as rapi
from repro.train.optimizer import init_train_state as ref_init_state
from repro_torch.models import api as tapi
from repro_torch.train.optimizer import adamw_update
from repro_torch.tree import leaves_with_path
from tests.test_torch_batch import one_torch_thread  # noqa: F401
from tests.test_torch_models import np_tree, port_in, ref_in

B, S = 2, 32
LOSS_REL = 0.01
GRAD_CORR = 0.999
LEAF_CORR = 0.999
STATE_REL = 1e-6
# v is quadratic in the clip scale 1 / ||g||, and XLA's f32 sums of the
# leaves' squares have run up to 2e-6 below the exact ones where torch's
# pairwise sums are within 1e-7 (the test prints the port's norm and
# float64's), which moves the scale by up to 7e-7 and v by up to twice that
V_REL = 2e-6


def batch_np(cfg, seed=0):
    """Random tokens and targets (numpy seed); vlm patch embeddings from
    the seed, encdec frames zero (the reference tests' batch)."""
    r = np.random.default_rng(seed)
    out = {"tokens": r.integers(1, cfg.vocab, (B, S)).astype(np.int32),
           "targets": r.integers(1, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = r.standard_normal(
            (B, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = np.zeros((B, 16, cfg.frame_dim), np.float32)
    return out


def unsaturated(params):
    """The reference's draw with each stacked matrix at unit fan-in
    variance.  ``dense_init`` takes a leaf's first axis as its fan-in,
    which for a stacked ``(layers, in, out)`` leaf is the layer count, so
    those leaves come out at std 1 (the explicit scales, 0.02 and 0.5, stay
    below 0.75); each such leaf is divided by the square root of its input
    width, its axis -2."""
    def fan(a):
        a = np.asarray(a)
        if a.ndim >= 3 and a.std() > 0.75:
            return jnp.asarray(a / np.float32(np.sqrt(a.shape[-2])))
        return jnp.asarray(a)
    return jax.tree.map(fan, params)


def flat_np(tree):
    """{path: f32 numpy} of a port tree (tensors) or a reference one."""
    return {p: v.detach().float().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v, np.float32) for p, v in leaves_with_path(tree)}


def corr(a: dict, b: dict) -> float:
    x = np.concatenate([a[k].ravel() for k in sorted(a)]).astype(np.float64)
    y = np.concatenate([b[k].ravel() for k in sorted(a)]).astype(np.float64)
    return float(np.corrcoef(x, y)[0, 1])


def leaf_corr(a: dict, b: dict) -> dict:
    """{path: corr} of the leaves whose ``a`` is not all zero; a leaf of
    ``b`` that is constant there counts as 0."""
    out = {}
    for k in a:
        x, y = a[k].ravel().astype(np.float64), b[k].ravel().astype(np.float64)
        if not x.any():
            continue
        if x.std() == 0 or y.std() == 0:
            out[k] = 1.0 if np.array_equal(x, y) else 0.0
        else:
            out[k] = float(np.corrcoef(x, y)[0, 1])
    return out


def state_distance(path, want, got):
    """(largest ULP distance, largest relative difference, path) of one
    leaf; raises unless every element is within ``STATE_REL`` (``V_REL``
    for v) of the leaf's largest magnitude (elementwise relative
    differences blow up where ``p - lr * update`` cancels to near
    zero)."""
    w = np.asarray(want, np.float32)
    d = np.abs(got - w)
    scale = max(float(np.abs(w).max()), 1e-30)
    rel = V_REL if path.startswith("v/") else STATE_REL
    assert (d <= rel * scale).all(), (path, float(d.max()), scale)
    ulp = int(np.abs(got.view(np.int32).astype(np.int64) - w.view(np.int32)).max())
    return ulp, float(d.max()) / scale, path


@contextlib.contextmanager
def applied_grads(module):
    """While open, ``module.adamw_update`` records the gradients each call
    is handed; a ``make_train_step`` built then (both packages import
    ``adamw_update`` when the step is built) keeps recording them."""
    seen, real = [], module.adamw_update

    def spy(params, grads, *args, **kw):
        seen.append(grads)
        return real(params, grads, *args, **kw)

    module.adamw_update = spy
    try:
        yield seen
    finally:
        module.adamw_update = real


def reference_program(arch):
    """The reference's ``make_train_step(cfg, microbatches=2)`` on its
    PRNGKey(0) draw (``unsaturated``) and batch, jitted with the gradients
    it applies as an output: (config, state, batch as numpy, the program)."""
    cfg = rapi.get_config(arch).reduced()
    model = rapi.build_model(cfg)
    state = ref_init_state(unsaturated(model.init_params(jax.random.PRNGKey(0))))
    with applied_grads(ref_opt) as seen:
        step = rapi.make_train_step(cfg, microbatches=2)

    def run(state, batch):
        new, m = step(state, batch)
        return new, m["loss"], seen[-1]

    return cfg, state, batch_np(cfg), jax.jit(run)


@functools.lru_cache(maxsize=None)
def references():
    """{arch: (config, the state as numpy, the batch as numpy, the loss,
    the gradients the step applied, the new state)} for all ten archs.
    The programs are built here, one after another (``applied_grads``
    swaps a module attribute), then traced and compiled on three threads:
    XLA's compile of one overlaps the tracing of the next (52 s -> 33 s
    for the ten)."""
    progs = {arch: reference_program(arch) for arch in rapi.ARCH_IDS}

    def run(arch):
        cfg, state, b, prog = progs[arch]
        new, loss, grads = prog(state, ref_in(b))
        return cfg, np_tree(state), b, float(loss), np_tree(grads), np_tree(new)

    with ThreadPoolExecutor(3) as pool:
        return dict(zip(rapi.ARCH_IDS, pool.map(run, rapi.ARCH_IDS)))


def reference(arch):
    return references()[arch]


def port_state(arch, dtype=torch.bfloat16):
    cfg, state, *_ = reference(arch)
    model = tapi.build_model(tapi.get_config(arch).reduced(), dtype)
    return model, tapi.load_reference_state(model, state, device="cpu")


@functools.lru_cache(maxsize=None)
def port(arch):
    """The port's steps at microbatches 1 and 2 from the reference's state
    and batch: {mb: (new state, loss, the gradients applied)}, and the
    port's f32 gradients (``loss_and_grads`` of the f32 model)."""
    _, _, b, *_ = reference(arch)
    model, state = port_state(arch)
    out = {}
    for mb in (1, 2):
        with applied_grads(port_opt) as seen:
            step = tapi.make_train_step(model.cfg, microbatches=mb)
        new, m = step(state, port_in(b))
        out[mb] = (new, float(m["loss"]), flat_np(seen[-1]))
    m32, s32 = port_state(arch, torch.float32)
    out["f32"] = flat_np(tapi.loss_and_grads(m32, s32["params"], port_in(b))[1])
    return out


@pytest.mark.parametrize("arch", rapi.ARCH_IDS)
def test_train_step_loss_matches_reference(arch):
    """(a) one step: the loss within 1 % of the reference step's; the new
    state is finite and its step is 1."""
    want = reference(arch)[3]
    new, got, _ = port(arch)[1]
    print(f"{arch} step loss: reference {want:.6f}, port {got:.6f}, rel "
          f"{abs(got - want) / abs(want):.3e}")
    assert abs(got - want) <= LOSS_REL * abs(want)
    assert int(new["step"]) == 1 and new["step"].dtype == torch.int32
    assert all(torch.isfinite(v).all() for _, v in leaves_with_path(new))


@pytest.mark.parametrize("arch", rapi.ARCH_IDS)
def test_gradients_match_reference(arch):
    """(b) the port's bf16 gradients at microbatches 2 and 1 against the
    reference's: whole-tree corr >= 0.999, every leaf with a reference
    gradient at corr >= 0.999, every leaf finite."""
    want = flat_np(reference(arch)[4])
    p = port(arch)
    own = corr(p["f32"], p[1][2])
    for mb in (2, 1):
        got = p[mb][2]
        assert sorted(got) == sorted(want)
        assert all(np.isfinite(v).all() for v in got.values())
        whole, per = corr(want, got), leaf_corr(want, got)
        worst = min(per, key=per.get)
        print(f"{arch} grads, microbatches {mb}: corr(reference, port) "
              f"{whole:.6f}, worst leaf {worst} {per[worst]:.6f} of {len(per)} "
              f"with a reference gradient; corr(port f32, port) {own:.6f}")
        assert whole >= GRAD_CORR, (mb, whole)
        assert per[worst] >= LEAF_CORR, (mb, worst, per[worst])


@pytest.mark.parametrize("arch", rapi.ARCH_IDS)
def test_adamw_on_reference_grads_gives_reference_state(arch):
    """(c) the port's AdamW on the gradients the reference's step applied:
    the step's new params and m within a relative 1e-6, v within 2e-6 (the
    largest ULP distance and relative difference printed, and the global
    norms)."""
    _, state, _, _, grads, new = reference(arch)
    _, tstate = port_state(arch)
    tg = tapi.load_reference_params(tapi.build_model(
        tapi.get_config(arch).reduced()), grads, device="cpu")
    got = dict(zip(("params", "m", "v"), adamw_update(
        tstate["params"], tg, tstate["m"], tstate["v"], tstate["step"],
        lr=3e-4, wd=0.01)))
    got = dict(leaves_with_path(got))
    seen = [state_distance(p, w, got[p].numpy())
            for p, w in leaves_with_path({k: new[k] for k in ("params", "m", "v")})]
    ulp, rel = max(seen), max(seen, key=lambda t: t[1])
    exact = float(np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                              for _, g in leaves_with_path(grads))))
    print(f"{arch} AdamW on the reference's grads: largest ulp distance "
          f"{ulp[0]} ({ulp[2]}), relative {rel[1]:.3e} ({rel[2]}); global norm "
          f"port {float(port_opt.global_norm(tg))!r}, float64 {exact!r}")


@pytest.mark.parametrize("arch", rapi.ARCH_IDS)
def test_train_steps_decrease_loss(arch):
    """(d) 8 steps on a fixed batch (tests/test_models.py's: ones) lower
    the loss."""
    cfg = tapi.get_config(arch).reduced()
    model = tapi.build_model(cfg)
    from repro_torch.train.optimizer import init_train_state
    state = init_train_state(model.init_params(torch.Generator().manual_seed(0)))
    b = {"tokens": torch.ones((2, 32), dtype=torch.int32),
         "targets": torch.ones((2, 32), dtype=torch.int32)}
    if cfg.family == "encdec":
        b["frames"] = torch.zeros((2, 16, cfg.frame_dim), dtype=torch.bfloat16)
    if cfg.family == "vlm":
        b["patch_embeds"] = torch.zeros((2, cfg.n_patches, cfg.patch_dim),
                                        dtype=torch.bfloat16)
    step = tapi.make_train_step(cfg)
    losses = []
    for _ in range(8):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    print(f"{arch} losses: {[round(x, 4) for x in losses]}")
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


@pytest.mark.parametrize("arch", rapi.ARCH_IDS)
def test_microbatched_step_matches(arch):
    """(e) microbatches=2: the loss within 1 % of the reference's
    microbatches=2 step and of the port's own microbatches=1 step."""
    want = reference(arch)[3]
    got, one = port(arch)[2][1], port(arch)[1][1]
    print(f"{arch} microbatches=2 loss: reference {want:.6f}, port "
          f"{got:.6f}; port microbatches=1 {one:.6f}")
    assert abs(got - want) <= LOSS_REL * abs(want)
    assert abs(got - one) <= LOSS_REL * abs(one)


@pytest.mark.parametrize("arch", ["gemma3_12b", "mamba2_370m",
                                  "recurrentgemma_9b", "seamless_m4t_medium"])
def test_remat_changes_nothing(arch):
    """``cfg.remat`` on (each family's scan step recomputed in the
    backward): the loss and every gradient bit for bit the un-rematerialized
    run's, and with grad disabled the forward is the plain one."""
    cfg = tapi.get_config(arch).reduced()
    on = dataclasses.replace(cfg, remat=True)
    _, state = port_state(arch)
    b = port_in(batch_np(cfg, seed=1))
    l0, g0 = tapi.loss_and_grads(tapi.build_model(cfg), state["params"], b)
    l1, g1 = tapi.loss_and_grads(tapi.build_model(on), state["params"], b)
    assert torch.equal(l0, l1)
    for (p, x), (_, y) in zip(leaves_with_path(g0), leaves_with_path(g1)):
        assert torch.equal(x, y), p
    with torch.no_grad():
        assert torch.equal(tapi.build_model(on).loss(state["params"], b), l0)
