"""The port's LM families (``repro_torch.models``) against the JAX
reference's, on the CPU, at ``reduced()`` widths and, without allocating,
at full width.

Parameters cross from the reference (``init_params``, as numpy) through
``api.load_reference_params``.  Whole-model outputs run the reference's
bf16 dtype policy in both packages, so they are held to the reference's
own decode-vs-forward bounds (``tests/test_models.py``): corr > 0.998 and
mean |diff| / max |ref| < 0.01, MLA corr > 0.99 and < 0.015; the tests
print the largest difference.  The encdec model is held on the reference
tests' batch (zero frames) end to end, and on random frames stage by
stage: ``encode``, then ``decode_stack`` on the reference's encoder
states: end to end on random frames, the reference's own logits move
past these bounds when its encoder states move by one bf16 ulp.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import api as rapi
from repro_torch.models import api as tapi
from tests.test_torch_batch import one_torch_thread  # noqa: F401

B, S, STEPS = 2, 32, 10


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def close(label, want, got, mla=False):
    """The whole-model bounds; prints corr, rel and the largest diff."""
    f, d = f32(want), f32(got)
    assert f.shape == d.shape, (label, f.shape, d.shape)
    corr = np.corrcoef(f.ravel(), d.ravel())[0, 1]
    rel = np.abs(f - d).mean() / max(np.abs(f).max(), 1.0)
    print(f"{label}: corr {corr:.6f} rel {rel:.3e} max |diff| "
          f"{np.abs(f - d).max():.4g}")
    assert np.isfinite(d).all(), label
    assert corr > (0.99 if mla else 0.998), (label, corr)
    assert rel < (0.015 if mla else 0.01), (label, rel)


def cfgs(arch, cap=None):
    r, t = rapi.get_config(arch).reduced(), tapi.get_config(arch).reduced()
    if cap is not None:
        r = dataclasses.replace(r, moe_cap_factor=cap)
        t = dataclasses.replace(t, moe_cap_factor=cap)
    return r, t


def pair(arch, seed, cap=None):
    """(reference model, its params, port model, the carried params)."""
    rc, tc = cfgs(arch, cap)
    rm, tm = rapi.build_model(rc), tapi.build_model(tc)
    rp = rm.init_params(jax.random.PRNGKey(seed))
    return rm, rp, tm, tapi.load_reference_params(tm, np_tree(rp), device="cpu")


CASES = [(a, None) for a in rapi.ARCH_IDS] + \
    [(a, 8.0) for a in rapi.ARCH_IDS if rapi.get_config(a).moe]


def case_id(c):
    return c[0] + ("" if c[1] is None else f"-cap{c[1]:g}")


def batch(cfg, seed):
    r = np.random.default_rng(seed)
    out = {"tokens": r.integers(1, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = r.standard_normal(
            (B, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = np.zeros((B, 16, cfg.frame_dim), np.float32)
    return out


def ref_in(b):
    return {k: jnp.asarray(v).astype(jnp.bfloat16) if v.dtype == np.float32
            else jnp.asarray(v) for k, v in b.items()}


def port_in(b):
    return {k: torch.from_numpy(v).bfloat16() if v.dtype == np.float32
            else torch.from_numpy(v) for k, v in b.items()}


def logits_of(model, params, b, family):
    if family == "encdec":
        return model.decode_stack(params, b["tokens"],
                                  model.encode(params, b["frames"]))
    if family == "vlm":
        return model.forward(params, b["tokens"], b["patch_embeds"])[0]
    out = model.forward(params, b["tokens"])
    return out[0] if family in ("dense", "moe") else out


def specs(tree):
    """{path: (shape, dtype name)} of a tree of arrays or tensors."""
    out = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                out["/".join(path + (k,))] = (tuple(v.shape),
                                              str(v.dtype).replace("torch.", ""))
    walk(tree, ())
    return out


def leaves(tree):
    return [x for v in tree.values()
            for x in (leaves(v) if isinstance(v, dict) else [v])]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_whole_model_matches_reference(case):
    """forward logits on a 2 x 32 batch, ten decode steps from
    init_cache(2, 32) and make_prefill_step, from carried-across params;
    the cache's keys, shapes and dtypes are the reference's."""
    arch, cap = case
    rm, rp, tm, tp = pair(arch, 0, cap)
    cfg = rm.cfg
    mla = cfg.mla
    b = batch(cfg, 1)
    rb, tb = ref_in(b), port_in(b)
    close(f"{arch} forward", jax.jit(lambda p, x: logits_of(rm, p, x, cfg.family))(
        rp, rb), logits_of(tm, tp, tb, cfg.family), mla)
    rc, tc = rm.init_cache(B, 32), tm.init_cache(B, 32, device="cpu")
    assert specs(tc) == specs(rc)
    step = jax.jit(rm.decode_step)
    ro, to = [], []
    for t in range(STEPS):
        lg, rc = step(rp, rc, rb["tokens"][:, t: t + 1], jnp.int32(t))
        ro.append(f32(lg))
        lt, tc = tm.decode_step(tp, tc, tb["tokens"][:, t: t + 1], t)
        to.append(f32(lt))
    assert specs(tc) == specs(rc)
    close(f"{arch} decode x{STEPS}", np.stack(ro, 1), np.stack(to, 1), mla)
    close(f"{arch} prefill", jax.jit(rapi.make_prefill_step(cfg))(rp, rb),
          tapi.make_prefill_step(tm.cfg)(tp, tb), mla)


def test_encdec_stages_on_random_frames():
    rm, rp, tm, tp = pair("seamless_m4t_medium", 0)
    r = np.random.default_rng(5)
    fr = r.standard_normal((B, 16, rm.cfg.frame_dim)).astype(np.float32)
    toks = r.integers(1, rm.cfg.vocab, (B, S)).astype(np.int32)
    enc_r = jax.jit(rm.encode)(rp, jnp.asarray(fr).astype(jnp.bfloat16))
    enc_t = tm.encode(tp, torch.from_numpy(fr).bfloat16())
    close("encode", enc_r, enc_t)
    enc = f32(enc_r).copy()
    close("decode_stack on the reference's encoder states",
          jax.jit(rm.decode_stack)(rp, jnp.asarray(toks),
                                   jnp.asarray(enc).astype(jnp.bfloat16)),
          tm.decode_stack(tp, torch.from_numpy(toks),
                          torch.from_numpy(enc).bfloat16()))
    ek_r, ev_r = rm.enc_kv(rp, enc_r)
    ek_t, ev_t = tm.enc_kv(tp, torch.from_numpy(enc).bfloat16())
    close("enc_kv k", ek_r, ek_t)
    close("enc_kv v", ev_r, ev_t)


@pytest.mark.parametrize("arch", ["gemma3_12b", "deepseek_v2_lite",
                                  "recurrentgemma_9b", "mamba2_370m",
                                  "seamless_m4t_medium"])
def test_serving_params_bit_for_bit(arch):
    """Decode logits from the serving copy (bf16 matrices, cast once) are
    bit for bit those of the f32 masters cast at each use, and the copy
    keeps the reference's f32 leaves f32."""
    cfg = tapi.get_config(arch).reduced()
    model = tapi.build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    serving = tapi.serving_params(tapi.copy_tree(params))
    assert set(specs(serving)) == set(specs(params))
    for path, (shape, dt) in specs(serving).items():
        leaf = path.rsplit("/", 1)[-1]
        assert dt == ("float32" if leaf in tapi.F32_LEAVES else "bfloat16"), path
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab, (2, 6)).astype(np.int32))
    caches = [model.init_cache(2, 8, device="cpu") for _ in range(2)]
    for t in range(6):
        a, caches[0] = model.decode_step(params, caches[0], toks[:, t: t + 1], t)
        b, caches[1] = model.decode_step(serving, caches[1], toks[:, t: t + 1], t)
        assert torch.equal(a, b), (arch, t)
    assert tapi.tree_bytes(serving) < tapi.tree_bytes(params)


def test_load_reference_params_refuses_mismatches():
    rm, rp, tm, _ = pair("deepseek_v2_lite", 0)
    tree = np_tree(rp)
    missing = dict(tree, head_attn={k: v for k, v in tree["head_attn"].items()
                                    if k != "w_uk"})
    with pytest.raises(KeyError, match="w_uk"):
        tapi.load_reference_params(tm, missing, device="cpu")
    with pytest.raises(KeyError, match="extra"):
        tapi.load_reference_params(tm, dict(tree, stray=np.zeros(3)), device="cpu")
    bad = dict(tree, final_ln=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="final_ln"):
        tapi.load_reference_params(tm, bad, device="cpu")


# ---------------------------------------------- mirrors of test_models.py --

def ref_batch(cfg):
    """tests/test_models.py's ``_batch`` as numpy."""
    out = {"tokens": np.ones((2, 32), np.int32),
           "targets": np.ones((2, 32), np.int32)}
    if cfg.family == "encdec":
        out["frames"] = np.zeros((2, 16, cfg.frame_dim), np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = np.zeros((2, cfg.n_patches, cfg.patch_dim),
                                       np.float32)
    return out


@pytest.mark.parametrize("arch", rapi.ARCH_IDS)
def test_reduced_smoke_loss_and_decode(arch):
    """The loss's value is finite and within 1 % of the
    reference's on carried params; one decode step at position 3 gives
    finite (2, vocab) logits and keeps the cache's structure."""
    rm, rp, tm, tp = pair(arch, 0)
    cfg = tm.cfg
    b = ref_batch(cfg)
    want = float(jax.jit(rm.loss)(rp, ref_in(b)))
    got = float(tm.loss(tp, port_in(b)))
    print(f"{arch} loss: reference {want:.6f}, port {got:.6f}")
    assert np.isfinite(got) and abs(got - want) <= 0.01 * abs(want)
    cache = tm.init_cache(2, 64, device="cpu")
    before = specs(cache)
    logits, cache2 = tm.decode_step(tp, cache, torch.ones((2, 1), dtype=torch.int32), 3)
    assert logits.shape == (2, cfg.vocab)
    assert torch.isfinite(logits).all()
    assert specs(cache2) == before


@pytest.mark.parametrize("arch", ["starcoder2_3b", "mamba2_370m",
                                  "recurrentgemma_9b", "deepseek_v2_lite"])
def test_decode_matches_forward(arch):
    """The reference test's check on the port, with the reference test's
    params (PRNGKey(1)) and tokens (PRNGKey(2)) carried across."""
    cap = 8.0 if rapi.get_config(arch).moe else None
    _, _, tm, tp = pair(arch, 1, cap)
    cfg = tm.cfg
    T_ = 10
    toks = torch.from_numpy(np.array(
        jax.random.randint(jax.random.PRNGKey(2), (2, T_), 1, cfg.vocab)))
    full = tm.forward(tp, toks)
    full = full[0] if cfg.family in ("dense", "moe") else full
    cache = tm.init_cache(2, 32, device="cpu")
    outs = []
    for t in range(T_):
        lg, cache = tm.decode_step(tp, cache, toks[:, t: t + 1], t)
        outs.append(lg)
    f, d = f32(full), f32(torch.stack(outs, 1))
    corr = np.corrcoef(f.ravel(), d.ravel())[0, 1]
    agree = (f.argmax(-1) == d.argmax(-1)).mean()
    rel = np.abs(f - d).mean() / max(np.abs(f).max(), 1.0)
    print(f"{arch}: corr {corr:.6f} agree {agree:.3f} rel {rel:.4f}")
    mla = cfg.mla
    assert corr > (0.99 if mla else 0.998), corr
    assert (agree >= 0.85) if mla else (agree > 0.85), agree
    assert rel < (0.015 if mla else 0.01), rel


def test_local_window_ring_cache_consistency():
    """gemma-style local attention: ring cache == recompute with window
    (the reference test's PRNGKey(3) params and PRNGKey(4) tokens)."""
    _, _, tm, tp = pair("gemma3_12b", 3)
    cfg = tm.cfg
    assert any(w for w in cfg.window_pattern)
    T_ = 12
    toks = torch.from_numpy(np.array(
        jax.random.randint(jax.random.PRNGKey(4), (1, T_), 1, cfg.vocab)))
    full, _ = tm.forward(tp, toks)
    cache = tm.init_cache(1, 16, device="cpu")
    for t in range(T_):
        lg, cache = tm.decode_step(tp, cache, toks[:, t: t + 1], t)
    f, d = f32(full)[:, -1], f32(lg)
    corr = np.corrcoef(f.ravel(), d.ravel())[0, 1]
    rel = np.abs(f - d).mean() / max(np.abs(f).max(), 1.0)
    print(f"ring cache: corr {corr:.6f} rel {rel:.4f}")
    assert corr > 0.999
    assert rel < 0.01


@pytest.mark.parametrize("arch", rapi.ARCH_IDS)
def test_decode_matches_forward_f32_past_the_window(arch):
    """The port computing in f32 (``build_model(cfg, torch.float32)``):
    80 decode steps, past the 64-slot rings of gemma3's and
    recurrentgemma's local layers, give the forward's logits to 1e-3 of
    their largest magnitude (bf16 noise, amplified through the layers, is
    what the bf16 bounds above allow for)."""
    cfg = tapi.get_config(arch).reduced()
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe_cap_factor=8.0)
    model = tapi.build_model(cfg, torch.float32)
    params = model.init_params(torch.Generator().manual_seed(0))
    T_ = 80
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, (2, T_)).astype(np.int32))
    if cfg.family == "encdec":
        full = model.decode_stack(params, toks, model.encode(
            params, torch.zeros((2, 16, cfg.frame_dim))))
    else:
        full = model.forward(params, toks)
        full = full[0] if cfg.family in ("dense", "vlm", "moe") else full
    cache = model.init_cache(2, 96, device="cpu")
    assert {dt for _, dt in specs(cache).values()} == {"float32"}
    outs = []
    for t in range(T_):
        lg, cache = model.decode_step(params, cache, toks[:, t: t + 1], t)
        outs.append(lg)
    f, d = f32(full), f32(torch.stack(outs, 1))
    worst = np.abs(f - d).max() / np.abs(f).max()
    print(f"{arch} f32: max |diff| / max |forward| {worst:.3e}")
    assert worst < 1e-3


def test_param_counts_sane():
    approx = {"gemma3_12b": 12e9, "starcoder2_3b": 3e9, "granite_3_8b": 8e9,
              "llava_next_34b": 34e9, "phi35_moe": 42e9,
              "deepseek_v2_lite": 16e9}
    for arch, target in approx.items():
        n = tapi.get_config(arch).param_count()
        assert 0.5 * target < n < 1.8 * target, (arch, n, target)


# -------------------------------------------------- full width, no memory --

@pytest.mark.parametrize("arch", rapi.ARCH_IDS)
def test_configs_equal_reference(arch):
    r, t = rapi.get_config(arch), tapi.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(r.reduced())
    assert [dataclasses.asdict(s) for s in t.shapes()] == \
        [dataclasses.asdict(s) for s in r.shapes()]
    for c_t, c_r in ((t, r), (t.reduced(), r.reduced())):
        assert c_t.param_count() == c_r.param_count()
        assert c_t.active_param_count() == c_r.active_param_count()
        assert tapi.scan_trips(c_t) == rapi.scan_trips(c_r)


@pytest.mark.parametrize("arch", rapi.ARCH_IDS)
def test_full_width_specs_equal_reference(arch):
    """param_specs, input_specs and cache_specs of the full config: meta
    tensors with the shapes and dtypes of the reference's ``eval_shape``
    and ``ShapeDtypeStruct`` trees, nothing allocated."""
    r, t = rapi.get_config(arch), tapi.get_config(arch)
    ps = tapi.param_specs(t)
    assert all(v.is_meta for v in leaves(ps))
    assert specs(ps) == specs(rapi.param_specs(r))
    for sh_t, sh_r in zip(t.shapes(), r.shapes()):
        assert specs(tapi.input_specs(t, sh_t)) == specs(rapi.input_specs(r, sh_r))
        cs = tapi.cache_specs(t, sh_t)
        assert all(v.is_meta for v in leaves(cs))
        assert specs(cs) == specs(rapi.cache_specs(r, sh_r)), sh_t.name
