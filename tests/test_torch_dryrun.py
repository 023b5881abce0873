"""The dry-run tooling of the port (``repro_torch.launch.roofline``,
``report``, ``dryrun`` and ``repro_torch.distributed.ctx``) against the
reference's: the HLO collective parser, the roofline terms at the H100's
peaks, ``model_flops``, the rendered table, the models' activation-hint
specs on the production meshes, FLOPs and argument bytes against XLA's
analyses, a hand count of the collective rules, and the command line.
"""
import io
import json
import os
import random
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import SHAPES as RSHAPES, ShapeSpec as RShape
from repro.distributed import ctx as rctx
from repro.launch import report as rreport
from repro.launch import roofline as rroof
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.models import api as rapi
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import ctx
from repro_torch.launch import dryrun as dr
from repro_torch.launch import report, roofline as rf
from repro_torch.launch.mesh import Mesh, dp_axes
from repro_torch.models import api
from tests.test_roofline import HLO
from tests.test_torch_batch import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SINGLE = ((16, 16), ("data", "model"))
MULTI = ((2, 16, 16), ("pod", "data", "model"))


def ref_dryrun():
    """The reference's dry-run module, imported with the device count
    already fixed: its import sets ``XLA_FLAGS`` for 512 host devices,
    which is put back as it was so no later process inherits it."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return dryrun


# ------------------------------------------------------------- roofline --

def hlo_lines(seed: int, n: int = 40) -> str:
    """Random HLO instruction lines: every collective kind, plain and
    ``-start``, single and tuple results, with and without layouts, mixed
    with instructions that are not collectives."""
    rng = random.Random(seed)
    dts = list(rf._DTYPE_BYTES)
    kinds = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute", "add", "dot", "fusion"]

    def shape():
        dims = ",".join(str(rng.randint(1, 300)) for _ in range(rng.randint(0, 4)))
        lay = "{" + ",".join(map(str, range(dims.count(",") + 1))) + "}" \
            if dims and rng.random() < 0.5 else ""
        return f"{rng.choice(dts)}[{dims}]{lay}"

    out = []
    for i in range(n):
        res = shape() if rng.random() < 0.7 else \
            "(" + ", ".join(shape() for _ in range(rng.randint(2, 3))) + ")"
        op = rng.choice(kinds) + ("-start" if rng.random() < 0.3 else "")
        out.append(f"  %x.{i} = {res} {op}({shape()} %p.{i}), "
                   f"replica_groups={{}}")
    return "\n".join(out)


@pytest.mark.parametrize("seed", [None, 0, 1, 2, 3])
def test_collective_parser_equals_reference(seed):
    text = HLO if seed is None else hlo_lines(seed)
    got = rf.collective_bytes(text)
    assert got == rroof.collective_bytes(text)
    if seed is None:                       # the reference test's own counts
        assert got["all-reduce"] == 256 * 1024 * 4 + 2 * 2 * 2
        assert got["all-gather"] == 8 * 128 * 2
        assert got["all-to-all"] == 2 * 16 * 16 * 4
        assert got["collective-permute"] == 64
        assert got["reduce-scatter"] == 4 * 4 * 4
        assert got["count"] == 6


def test_roofline_terms_at_h100_peaks():
    assert (rf.PEAK_FLOPS, rf.HBM_BW, rf.LINK_BW, rf.HBM_BYTES) == \
        (989.4e12, 3.35e12, 450e9, 80e9)
    t = rf.roofline_terms(989.4e12, 0.0, 450e9, chips=1)
    assert abs(t["compute_s"] - 1.0) < 1e-6
    assert abs(t["collective_s"] - 1.0) < 1e-6
    assert t["step_s_lower_bound"] >= 1.0
    t = rf.roofline_terms(1e12, 2 * 3.35e12, 0.0, chips=256)
    assert t["bottleneck"] == "memory_s"
    assert abs(t["memory_s"] - 2.0) < 1e-9 and t["step_s_lower_bound"] == t["memory_s"]


def test_model_flops_moe_uses_active():
    cfg = api.get_config("phi35_moe")
    mf = rf.model_flops(cfg, dr.SHAPES["train_4k"])
    dense_equiv = 6 * cfg.param_count() * 256 * 4096
    assert mf < dense_equiv * 0.6   # top-2 of 16 experts


@pytest.mark.parametrize("arch", api.ARCH_IDS)
def test_model_flops_equal_reference(arch):
    cfg, rcfg = api.get_config(arch), rapi.get_config(arch)
    for name in RSHAPES:
        assert rf.model_flops(cfg, dr.SHAPES[name]) == \
            rroof.model_flops(rcfg, RSHAPES[name]), name


def test_measure_on_the_host_mesh():
    """The reference's AOT-compile test, as the port has it: one reduced
    train step measured on meta tensors over ``Mesh((1, 1))``."""
    cfg = api.get_config("mamba2_370m").reduced()
    m = dr._measure(cfg, ShapeSpec("t", 32, 2, "train"),
                    Mesh((1, 1), ("data", "model")))
    assert np.isfinite(m["flops"]) and m["flops"] > 0
    assert np.isfinite(m["bytes_accessed"]) and m["bytes_accessed"] > 0
    assert set(m["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                "temp_size_in_bytes",
                                "generated_code_size_in_bytes"}
    assert m["memory"]["temp_size_in_bytes"] > 0
    assert m["collectives"]["total"] == 0 and m["ways"] == 1


# --------------------------------------------------------------- report --

def handmade_record(path):
    def ok(arch, shape, mesh, temp, ucr):
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
                "roofline": rf.roofline_terms(3e14, 2e12, 1e9, 256),
                "memory": {"temp_size_in_bytes": temp},
                "useful_compute_ratio": ucr, "compile_s": 12.4}
    data = {}
    for mesh in ("single", "multi"):
        data[f"gemma3_12b|train_4k|{mesh}"] = ok("gemma3_12b", "train_4k",
                                                 mesh, 20e9, 0.73)
        data[f"mamba2_370m|decode_32k|{mesh}"] = ok("mamba2_370m", "decode_32k",
                                                    mesh, 90e9, None)
        data[f"phi35_moe|long_500k|{mesh}"] = {
            "arch": "phi35_moe", "shape": "long_500k", "mesh": mesh,
            "status": "skipped"}
        data[f"granite_3_8b|prefill_32k|{mesh}"] = {
            "arch": "granite_3_8b", "shape": "prefill_32k", "mesh": mesh,
            "status": "error", "error": "RuntimeError: x"}
    data["mamba2_370m|decode_32k|multi"]["roofline"] = rf.roofline_terms(
        1e9, 1e6, 0.0, 512)
    with open(path, "w") as f:
        json.dump(data, f)


def rendered(fn, *args) -> str:
    fh = io.StringIO()
    fn(*args, fh=fh)
    return fh.getvalue()


def test_report_renders_as_the_reference(tmp_path):
    path = str(tmp_path / "dry.json")
    handmade_record(path)
    for mesh in ("single", "multi"):
        got = rendered(report.render, path, mesh)
        assert got == rendered(rreport.render, path, mesh)
        assert "skipped" in got and "ERROR" in got and "0.73" in got
    lines = rendered(report.summary, path).splitlines()
    assert lines[0] == "cells: ok=4 skipped=2 error=2"
    # over one H100's 80 GB: the 90 GB cells, not the 20 GB ones
    assert lines[1] == "over 80GB HBM (temp):"
    assert sorted(lines[2:]) == ["  mamba2_370m|decode_32k|multi: 90.0 GB",
                                 "  mamba2_370m|decode_32k|single: 90.0 GB"]


# ----------------------------------------------------------- hint specs --

def canonical(spec):
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


B_HINT, S_HINT, LEN_HINT = 32, 16, 64      # B divides both meshes' data axes


def ref_hints(arch, mesh_shape, axes, monkeypatch, loss=False):
    """The reference's hints of forward (or the loss) and one decode step at
    full width under ``jax.eval_shape``, ``with_sharding_constraint``
    replaced by a recorder: the set of ``(kind, shape, spec)``."""
    cfg = rapi.get_config(arch)
    model = rapi.build_model(cfg)
    pspec = rapi.param_specs(cfg)
    kinds, seen = [], []
    hint = rctx.hint

    def kind_hint(x, kind):
        kinds.append(kind)
        return hint(x, kind)

    def recorder(x, sharding):
        seen.append((tuple(x.shape), canonical(tuple(sharding.spec))))
        return x
    sds = jax.ShapeDtypeStruct
    B, S = B_HINT, S_HINT
    tok = sds((B, S), jnp.int32)
    mesh = AbstractMesh(mesh_shape, axes)
    with monkeypatch.context() as mp, rctx.use(mesh, dp_axes(mesh)):
        for mod in [m for name, m in sys.modules.items()
                    if name.startswith("repro.models.")] + [rctx]:
            if getattr(mod, "hint", None) is hint:
                mp.setattr(mod, "hint", kind_hint)
        mp.setattr(jax.lax, "with_sharding_constraint", recorder)
        if loss:
            jax.eval_shape(model.loss, pspec, {"tokens": tok, "targets": tok})
        elif cfg.family == "vlm":
            pe = sds((B, cfg.n_patches, cfg.patch_dim), jnp.bfloat16)
            jax.eval_shape(lambda p, t, e: model.forward(p, t, e), pspec, tok, pe)
        elif cfg.family == "encdec":
            fr = sds((B, S, cfg.frame_dim), jnp.bfloat16)
            jax.eval_shape(lambda p, t, f: model.decode_stack(
                p, t, model.encode(p, f)), pspec, tok, fr)
        else:
            jax.eval_shape(lambda p, t: model.forward(p, t), pspec, tok)
        if not loss:
            cache = jax.tree.map(lambda s: sds(s[0], s[1]),
                                 model.cache_spec(B, LEN_HINT),
                                 is_leaf=lambda s: isinstance(s, tuple)
                                 and isinstance(s[0], tuple))
            jax.eval_shape(model.decode_step, pspec, cache, sds((B, 1), jnp.int32),
                           sds((), jnp.int32))
    assert len(kinds) == len(seen)
    return {(k, s, sp) for k, (s, sp) in zip(kinds, seen)}


def port_hints(arch, mesh, loss=False):
    """The port's hint log of the same calls on meta tensors under
    ``ctx.use``: ``[(kind, shape, dtype, spec)]``."""
    cfg = api.get_config(arch)
    model = api.build_model(cfg)
    params = api.param_specs(cfg)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    B, S = B_HINT, S_HINT
    tok = meta((B, S), torch.int32)
    with torch.no_grad(), ctx.use(mesh, dp_axes(mesh)) as record:
        if loss:
            model.loss(params, {"tokens": tok, "targets": tok})
            return list(record)
        if cfg.family == "vlm":
            model.forward(params, tok, meta((B, cfg.n_patches, cfg.patch_dim),
                                            torch.bfloat16))
        elif cfg.family == "encdec":
            model.decode_stack(params, tok, model.encode(
                params, meta((B, S, cfg.frame_dim), torch.bfloat16)))
        else:
            model.forward(params, tok)
        cache = api.tree_map(lambda s: meta(*s), model.cache_spec(B, LEN_HINT))
        model.decode_step(params, cache, meta((B, 1), torch.int32), LEN_HINT - 1)
    return list(record)


@pytest.mark.parametrize("arch", api.ARCH_IDS)
def test_hint_specs_equal_reference(arch, monkeypatch):
    """Forward and one decode step at full width: the distinct (kind, shape,
    spec) the port's hints resolve under ``ctx.use`` equal the reference's
    on the single-pod and the multi-pod mesh."""
    for mesh in (SINGLE, MULTI):
        got = {(k, s, sp) for k, s, _, sp in port_hints(arch, Mesh(*mesh))}
        assert got == ref_hints(arch, *mesh, monkeypatch), mesh


def test_loss_hints_equal_reference(monkeypatch):
    """The transformer loss's ``lse`` / ``gold`` ``vec`` hints, with the
    forward's, on both meshes."""
    for mesh in (SINGLE, MULTI):
        got = {(k, s, sp) for k, s, _, sp in
               port_hints("starcoder2_3b", Mesh(*mesh), loss=True)}
        assert any(k == "vec" for k, _, _ in got)
        assert got == ref_hints("starcoder2_3b", *mesh, monkeypatch, loss=True)


def test_hint_without_a_mesh_is_the_identity():
    """With no mesh active ``hint`` returns its input object and records
    nothing; after ``use`` the state before it comes back."""
    x = torch.zeros(4, 3, 8)
    assert ctx.hint(x, "act") is x and ctx._STATE["mesh"] is None
    with ctx.use(Mesh(*SINGLE), ("data",)) as record:
        assert ctx.hint(x, "act") is x
    assert record == [("act", (4, 3, 8), torch.float32, (None, None, None))]
    assert ctx._STATE["mesh"] is None and ctx._STATE["record"] is None
    # granite's 49155-entry vocab falls back to sequence-parallel logits
    assert ctx.resolve((32, 16, 49155), "logits", Mesh(*MULTI),
                       ("pod", "data")) == (("pod", "data"), "model", None)


# ---------------------------------------------- FLOPs, bytes, arguments --

def real_args(args, seed: int):
    """CPU tensors of the meta arguments' shapes and dtypes, from a seed."""
    gen = torch.Generator().manual_seed(seed)

    def make(t):
        if t.dtype.is_floating_point:
            return (torch.randn(t.shape, generator=gen) * 0.02).to(t.dtype)
        return torch.randint(0, 64, t.shape, generator=gen).to(t.dtype)
    return tuple(a if isinstance(a, int) else api.tree_map(make, a) for a in args)


@pytest.mark.parametrize("arch,kind", [("mamba2_370m", "train"),
                                       ("deepseek_v2_lite", "train"),
                                       ("recurrentgemma_9b", "decode")])
def test_meta_counts_equal_a_cpu_run(arch, kind):
    """FLOPs, bytes accessed and the peak of live bytes, counted on meta
    tensors, equal those of the same step run on CPU tensors, exactly."""
    cfg = api.get_config(arch).reduced()
    cell = dr.lower_cell(cfg, ShapeSpec("t", 32, 4, kind),
                         Mesh((1, 1), ("data", "model")), kind)
    meta = dr.count(cell.fn, cell.args, "meta")
    cpu = dr.count(cell.fn, real_args(cell.args, 0), "cpu")
    for k in ("flops", "bytes_accessed", "peak_bytes"):
        assert meta[k] == cpu[k] > 0, k


def test_dense_flops_hand_count():
    """One dense layer's products: 2 M N K a matmul, forward and backward."""
    M, K, N = 48, 64, 80
    x = torch.empty(M, K, device="meta", requires_grad=True)
    w = torch.empty(K, N, device="meta", requires_grad=True)

    def layer(x, w):
        y = x @ w
        return torch.autograd.grad(y.sum(), (x, w))
    c = dr.count(layer, (x, w), "meta")
    assert c["flops"] == 3 * 2 * M * N * K       # y, dx = dy w^T, dw = x^T dy
    assert c["bytes_accessed"] > 0


@pytest.mark.parametrize("arch,kind", [("mamba2_370m", "train"),
                                       ("phi35_moe", "train"),
                                       ("gemma3_12b", "prefill"),
                                       ("seamless_m4t_medium", "decode")])
def test_flops_and_arguments_against_xla(arch, kind):
    """The reference's own ``_measure`` (XLA's ``cost_analysis`` with its
    two-point unroll extrapolation, ``dryrun.py:135``) on the 1-device host
    mesh against the port's on ``Mesh((1, 1))``.  The port's FLOPs are at
    most XLA's: FlopCounterMode counts products only, XLA also elementwise
    work.  Argument bytes are equal, except where XLA leaves out
    arguments the program never reads (seamless's encoder weights and
    cross-attention K/V projections in a decode step); the port counts
    every argument, as a caller holds them."""
    rdry = ref_dryrun()
    rcfg = rapi.get_config(arch).reduced()
    rshape = RShape("t", 32, 4, kind)
    mesh = ref_host_mesh((1, 1))
    f1 = rdry._measure(rcfg, rshape, mesh, unroll=1)
    f2 = rdry._measure(rcfg, rshape, mesh, unroll=2)
    G = rapi.scan_trips(rcfg)
    ref_flops = f1["flops"] + (G - 1) * max(f2["flops"] - f1["flops"], 0.0)
    cfg = api.get_config(arch).reduced()
    port = dr._measure(cfg, ShapeSpec("t", 32, 4, kind),
                       Mesh((1, 1), ("data", "model")))
    print(f"{arch} {kind}: port {port['flops']:.0f} FLOPs, XLA {ref_flops:.0f},"
          f" ratio {port['flops'] / ref_flops:.4f}")
    assert 0 < port["flops"] <= ref_flops
    ref_args = f1["memory"]["argument_size_in_bytes"]
    got = port["memory"]["argument_size_in_bytes"]
    if arch == "seamless_m4t_medium":
        pspec = api.param_specs(cfg)
        unread = sum(t.numel() * t.element_size() for p, t in
                     dr.leaves_with_path(pspec)
                     if p.startswith(("enc_", "frame_proj"))
                     or p in ("dec_xattn/wk", "dec_xattn/wv"))
        assert got - unread == ref_args
    else:
        assert got == ref_args


ARG_CELLS = [("gemma3_12b", "prefill"), ("mamba2_370m", "train"),
             ("phi35_moe", "decode")]


def test_argument_bytes_per_device_on_2x4():
    """On a (2, 4) mesh the per-device argument bytes equal XLA's
    ``memory_analysis`` of the reference's cell, compiled in a process of
    its own with 8 host devices."""
    code = textwrap.dedent(f"""
        import os, json
        import jax
        jax.devices()
        from repro.launch import dryrun
        from repro.launch.mesh import make_host_mesh
        from repro.models import api
        from repro.configs.base import ShapeSpec
        mesh = make_host_mesh((2, 4))
        out = {{}}
        for arch, kind in {ARG_CELLS!r}:
            cfg = api.get_config(arch).reduced()
            with mesh:
                low = dryrun.lower_cell(cfg, ShapeSpec("t", 32, 4, kind), mesh, kind)
                out[arch] = low.compile().memory_analysis().argument_size_in_bytes
        print(json.dumps(out))
        """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    mesh = Mesh((2, 4), ("data", "model"))
    for arch, kind in ARG_CELLS:
        got = dr._measure(api.get_config(arch).reduced(),
                          ShapeSpec("t", 32, 4, kind), mesh)
        assert got["ways"] == 8
        assert got["memory"]["argument_size_in_bytes"] == want[arch], arch


# ---------------------------------------------------------- collectives --

def test_collectives_hand_count():
    """starcoder2 at ``reduced()`` (d 64, 4 heads of 16, kv 2, non-GLU FFN
    128, vocab 512, one layer) on a (2, 2) mesh, B 4, S 16, counted by
    hand from the module docstring's rules."""
    cfg = api.get_config("starcoder2_3b").reduced()
    mesh = Mesh((2, 2), ("data", "model"))
    # FSDP leaves (spec shards data), gathered in bf16 over data, each the
    # leaf over model: embed (512, 64), wq (64, 64), wk, wv (64, 32),
    # wo (64, 64), ffn wi (64, 128), wo (128, 64)
    numel = [512 * 64, 64 * 64, 64 * 32, 64 * 32, 64 * 64, 64 * 128, 128 * 64]
    gather = sum(n * 2 // 2 for n in numel)
    act = 4 * 16 * 64 * 2 // 2     # (B, S, D) bf16 over data: embed, attn, ffn
    pre = dr._measure(cfg, ShapeSpec("p", 16, 4, "prefill"), mesh)["collectives"]
    assert pre == {"all-gather": gather, "all-reduce": 3 * act,
                   "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0,
                   "count": 7 + 3, "total": gather + 3 * act}
    # training, one microbatch, no remat: the same gathers; each FSDP
    # leaf's f32 gradient reduce-scattered to its (data, model) shard; the
    # three replicated norm scales' f32 gradients (64 each) all-reduced
    # over data; each act hint twice (forward, backward); lse and gold
    # (B, S) f32 over data once each
    scatter = sum(n * 4 // 4 for n in numel)
    norms = 3 * 64 * 4
    vec = 2 * (4 * 16 * 4 // 2)
    tr = dr._measure(cfg, ShapeSpec("t", 16, 4, "train"), mesh)["collectives"]
    assert tr == {"all-gather": gather, "reduce-scatter": scatter,
                  "all-reduce": norms + 2 * 3 * act + vec, "all-to-all": 0,
                  "collective-permute": 0, "count": 7 + 7 + 3 + 6 + 2,
                  "total": gather + scatter + norms + 6 * act + vec}


# ------------------------------------------------------------------ CLI --

def test_cli_writes_skips_and_renders(tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "dry.json")
    dr.main(["--arch", "mamba2_370m", "--shape", "decode_32k", "--mesh", "both",
             "--out", out])
    dr.main(["--arch", "starcoder2_3b", "--shape", "long_500k", "--mesh",
             "single", "--out", out])
    data = json.load(open(out))
    assert {k: v["status"] for k, v in data.items()} == {
        "mamba2_370m|decode_32k|single": "ok", "mamba2_370m|decode_32k|multi": "ok",
        "starcoder2_3b|long_500k|single": "skipped"}
    single, multi = (data[f"mamba2_370m|decode_32k|{m}"] for m in ("single", "multi"))
    assert single["chips"] == 256 and multi["chips"] == 512
    assert (single["ways"], multi["ways"]) == (256, 512)    # B 128 over the dp axes
    assert single["totals"] == multi["totals"]              # one counting run
    assert multi["flops"] * 2 == single["flops"]
    assert single["model_flops"] == rf.model_flops(api.get_config("mamba2_370m"),
                                                   dr.SHAPES["decode_32k"])
    capsys.readouterr()

    def refuse(*a, **k):
        raise AssertionError("a finished cell was run again")
    monkeypatch.setattr(dr, "run_cell", refuse)
    dr.main(["--arch", "mamba2_370m", "--shape", "decode_32k", "--out", out])
    dr.main(["--arch", "starcoder2_3b", "--shape", "long_500k", "--mesh",
             "single", "--out", out])
    assert "DONE ok=2 skipped=1 error=0" in capsys.readouterr().out
    table = rendered(report.render, out, "single")
    rows = [[c.strip() for c in line.split("|")] for line in table.splitlines()[2:]]
    assert [r[:3] for r in rows] == [["mamba2_370m", "decode_32k", "collective"],
                                     ["starcoder2_3b", "long_500k", "skipped"]]
