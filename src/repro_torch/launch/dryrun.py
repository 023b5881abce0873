"""Multi-pod dry-run: every (architecture x input-shape x mesh) cell of the
production matrix, measured on meta tensors: FLOPs, bytes accessed,
argument and peak memory, the collective schedule, and the roofline
lower bound at one H100's peaks.  The port of ``repro.launch.dryrun``:
the same functions, command line and record keys, so ``launch.report``
renders a file of either package.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID]
        [--shape NAME] [--mesh single|multi|both] [--out results/dryrun_torch.json]

Results are cached incrementally: finished cells are skipped on re-run.
Nothing here needs a card: the step of each cell runs once on tensors of
the ``meta`` device, which carry shapes and dtypes and allocate nothing.

How each quantity is measured (``_measure``):
  - FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the step (the
    matrix products and attention-like ops it registers; elementwise work
    counts no FLOPs there);
  - bytes accessed: ``TrafficMode``, which sums every aten op's input and
    output bytes (distinct elements of each view), leaving out views,
    ops that only allocate, ops that return no tensor, and copies from
    the host.  This is the eager port's own traffic, one kernel an op and
    no fusion, so it is larger than the reference's XLA count;
  - peak memory: in the same mode, each storage counts from the op that
    creates it until a weakref finalizer on it fires (autograd's saved
    tensors keep theirs alive until the backward frees them), the step's
    arguments from the start;
  - collectives: from the sharding rules and the activation hints the
    models record under ``distributed.ctx.use``, by the rules below.  The
    reference parses them from the compiled HLO; torch has no SPMD
    partitioner, so these are the collectives the same layout needs.

The mesh is abstract: ``Mesh((16, 16), ("data", "model"))`` or
``Mesh((2, 16, 16), ("pod", "data", "model"))``, no devices.  The step
runs once, unsplit; the reference's values are per device, so the work
is divided by the ways it is really split: the size of the data axes
the sanitized batch spec shards (dimension 0 of the inputs) times the
size of ``model``.  ``long_500k``'s batch of 1, for example, is split
over ``model`` only.  ``memory.argument_size_in_bytes`` and
``output_size_in_bytes`` are exact: each leaf's bytes over the product
of the axes its sanitized spec shards, summed.
``temp_size_in_bytes`` is the peak less the (unsplit) arguments, over
the same ways as the work.

Collective rules (each byte count is the per-device result shape, as
``roofline.collective_bytes`` counts HLO; a collective over axes of
total size 1 moves nothing and is not counted):
  1. a param leaf whose spec shards data axes (FSDP) is all-gathered over
     them before use, read as the models read it (bf16, or f32 for
     ``api.F32_LEAVES``): once a forward pass, i.e. once a microbatch,
     and once more in remat's recompute when training with
     ``cfg.remat``;
  2. training: each leaf's f32 gradient is reduce-scattered over the data
     axes that shard both it and the batch, once a microbatch, and
     all-reduced over the batch's other data axes (e.g. ``pod``, over
     which params are replicated), once a step;
  3. an ``act`` hint (the residual stream after a row-parallel product, a
     contraction over ``model``, or after the vocab-parallel embedding
     gather) implies an all-reduce over ``model`` of the hinted tensor;
     one more in the backward for each one recorded in the forward pass;
     a hint recorded during the backward is remat's recompute;
  4. a ``vec`` hint (the loss's logsumexp and gold logit over the
     vocab-parallel logits) implies an all-reduce over ``model``;
  5. an ``expert`` hint (MoE dispatch and return) implies an all-to-all
     over ``model``, and one more in the backward for each forward one;
  6. ``proj`` and ``logits`` hints imply none (column-parallel outputs).
Not modelled: attention over a sequence-sharded decode cache, and the
pipeline of collectives against compute.

``run_cell`` needs no two-point extrapolation: torch runs every layer, so
the counters see every trip of the layer loop (``scan_trips`` stays in
the record).  The reference's ``u1`` key (its unroll-1 measurement) has
no counterpart and is left out.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import threading
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..configs.base import SHAPES
from ..distributed import ctx
from ..distributed import sharding as shd
from ..launch import roofline as rf
from ..launch.mesh import Mesh, dp_axes
from ..models import api, layers
from ..tree import leaves, leaves_with_path, tree_map

DEFAULT_OUT = "results/dryrun_torch.json"
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
POS_BYTES = 4        # decode's position: the reference's 0-d int32 argument


def production_mesh(name: str) -> Mesh:
    """The abstract production mesh ``single`` or ``multi``."""
    return Mesh(*MESHES[name])


# ------------------------------------------------------------- counting --

def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a view covers (a broadcast dimension,
    stride 0, is read once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def _returns_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


_COPIES = {torch.ops.aten._to_copy.default, torch.ops.aten.copy_.default,
           torch.ops.aten._copy_from.default,
           torch.ops.aten._copy_from_and_resize.default}
_ALLOCATE_ONLY = {torch.ops.aten.empty.memory_format,
                  torch.ops.aten.empty_strided.default,
                  torch.ops.aten.empty_like.default,
                  torch.ops.aten.new_empty.default,
                  torch.ops.aten.new_empty_strided.default}


class TrafficMode(TorchDispatchMode):
    """Bytes accessed and peak live bytes of everything run under it, on
    ``device`` (see the module docstring).  ``track`` registers tensors
    that exist before the run (the step's arguments)."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._lock = threading.Lock()
        self._storages = {}

    def _on_device(self, t) -> bool:
        return isinstance(t, torch.Tensor) and t.device.type == self.device.type

    def _free(self, key):
        with self._lock:
            self.live -= self._storages.pop(key)

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        with self._lock:
            if key in self._storages:
                return
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = [t for t in tree_flatten((args, kwargs))[0]
                if isinstance(t, torch.Tensor)]
        ins = [t for t in flat if self._on_device(t)]
        in_keys = {t.untyped_storage()._cdata for t in ins}
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if self._on_device(t)]
        for t in outs:
            self.track(t)
        if (not outs or func in _ALLOCATE_ONLY or _returns_view(func)
                or (func in _COPIES and len(ins) < len(flat))):
            return out
        written = [t for t in outs if t.untyped_storage()._cdata not in in_keys]
        if len(written) < len(outs) and not any(
                r.alias_info is not None and r.alias_info.is_write
                for r in func._schema.returns):
            return out            # a fresh-looking result that aliases its input
        self.bytes += sum(_distinct_bytes(t) for t in ins + outs)
        return out


def count(fn, args, device) -> dict:
    """Run ``fn(*args)`` once under ``FlopCounterMode`` and ``TrafficMode``
    on ``device``: ``flops``, ``bytes_accessed``, ``peak_bytes``,
    ``seconds`` and the outputs (``out``).  The rope frequency cache is
    emptied first, so every run makes the same host-to-device copies."""
    layers._rope_freq.cache_clear()
    traffic = TrafficMode(device)
    for t in tree_flatten(args)[0]:
        if traffic._on_device(t):
            traffic.track(t)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, traffic:
        out = fn(*args)
    return {"flops": int(flops.get_total_flops()), "bytes_accessed": traffic.bytes,
            "peak_bytes": traffic.peak, "seconds": time.perf_counter() - t0,
            "out": out}


class HintLog(list):
    """The ctx record, each entry ``(kind, shape, dtype, spec, backward)``:
    ``backward`` is true for a hint made while autograd runs a backward
    pass (remat's recompute)."""

    def append(self, entry):
        super().append(tuple(entry) + (torch._C._current_graph_task_id() != -1,))


# ----------------------------------------------------------------- cells --

def _axes(spec) -> list:
    out = []
    for a in spec:
        if a is None:
            continue
        out += [a] if isinstance(a, str) else list(a)
    return out


def _ways(spec, mesh) -> int:
    return math.prod(mesh.shape[a] for a in _axes(spec))


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _flat(tree) -> list:
    """Leaves of nested dicts (sorted keys), tuples and lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _sharded_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of a tree of tensors under a tree of NamedSharding
    of the same structure."""
    ts, ss = _flat(tree), _flat(specs)
    if len(ts) != len(ss):
        raise ValueError(f"{len(ts)} leaves for {len(ss)} shardings")
    return sum(_nbytes(t) // _ways(s.spec, mesh) for t, s in zip(ts, ss))


def _meta_tree(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


class Cell:
    """One cell's step and its meta arguments: ``fn(*args)``; ``arg_specs``
    (NamedSharding trees matching ``args``, None for the decode position),
    ``out_specs(out)``, ``params`` (the params tree among the arguments),
    ``batch`` (its input tree) and ``microbatches``."""

    def __init__(self, fn, args, arg_specs, out_specs, params, batch,
                 microbatches=1):
        self.fn, self.args, self.arg_specs = fn, args, arg_specs
        self.out_specs, self.params, self.batch = out_specs, params, batch
        self.microbatches = microbatches


def lower_cell(cfg, shape, mesh, kind, microbatches=None, pos=None) -> Cell:
    """The step of one cell on meta tensors, with the sanitized shardings of
    its arguments and outputs.  ``microbatches`` overrides the reference's
    rule for training; ``pos``, the decode position, defaults to the last
    slot of the cache (its whole length attended, as the reference's
    masked decode attends it)."""
    params = api.param_specs(cfg)
    psh = shd.param_shardings(params, mesh)
    rep = shd.replicated(mesh)
    if kind == "train":
        state = {"params": params, "m": _meta_tree(params),
                 "v": _meta_tree(params),
                 "step": torch.empty((), dtype=torch.int32, device="meta")}
        batch = api.input_specs(cfg, shape)
        state_sh = shd.state_shardings(state, mesh)
        # the reference's rule: 8-way gradient accumulation where the batch
        # divides (it bounds the remat stack), 1 for unrolled cost variants
        mb = microbatches or (1 if cfg.scan_unroll else
                              (8 if shape.global_batch % 8 == 0 else 1))
        return Cell(api.make_train_step(cfg, microbatches=mb), (state, batch),
                    (state_sh, shd.batch_shardings(batch, mesh)),
                    lambda out: (state_sh, tree_map(lambda _: rep, out[1])),
                    params, batch, mb)
    logits_sh = shd.logits_sharding(mesh, cfg.vocab, shape.global_batch)
    if kind == "prefill":
        batch = api.input_specs(cfg, shape)
        return Cell(api.make_prefill_step(cfg), (params, batch),
                    (psh, shd.batch_shardings(batch, mesh)),
                    lambda out: logits_sh, params, batch)
    cache = api.cache_specs(cfg, shape)
    cache_sh = shd.cache_shardings(cache, mesh)
    token = api.input_specs(cfg, shape)["token"]
    pos = shape.seq_len - 1 if pos is None else pos
    return Cell(api.make_serve_step(cfg), (params, cache, token, pos),
                (psh, cache_sh, shd.batch_shardings({"t": token}, mesh)["t"],
                 None),
                lambda out: (logits_sh, cache_sh), params, {"token": token})


def work_ways(cell: Cell, mesh) -> tuple:
    """(ways the work is split, the data axes the batch is sharded over)."""
    first = _flat(cell.batch)[0]
    spec = shd.batch_shardings({"x": first}, mesh)["x"].spec
    batch_axes = _axes(spec[:1])
    return math.prod(mesh.shape[a] for a in batch_axes) * mesh.shape["model"], \
        batch_axes


def collectives(cfg, shape, cell: Cell, record, mesh, batch_axes) -> dict:
    """The collective schedule of the module docstring's rules, in
    ``roofline.collective_bytes``'s keys."""
    out = {k: 0 for k in rf.COLLECTIVES}
    out["count"] = 0

    def add(kind, nbytes, n=1):
        if nbytes and n:
            out[kind] += nbytes * n
            out["count"] += n

    train = shape.kind == "train"
    mb = cell.microbatches
    passes = mb * (2 if cfg.remat else 1) if train else 1
    dp = dp_axes(mesh)
    psh = leaves(shd.param_shardings(cell.params, mesh))
    for (path, leaf), sh in zip(leaves_with_path(cell.params), psh):
        axes = _axes(sh.spec)
        fsdp = [a for a in dp if a in axes]
        elt = 4 if path.rsplit("/", 1)[-1] in api.F32_LEAVES else 2
        rest = math.prod(mesh.shape[a] for a in axes if a not in fsdp)
        if math.prod(mesh.shape[a] for a in fsdp) > 1:
            add("all-gather", leaf.numel() * elt // rest, passes)
        if not train:
            continue
        shard = leaf.numel() * 4 // _ways(sh.spec, mesh)
        if math.prod(mesh.shape[a] for a in fsdp if a in batch_axes) > 1:
            add("reduce-scatter", shard, mb)
        if math.prod(mesh.shape[a] for a in batch_axes if a not in fsdp) > 1:
            add("all-reduce", shard)
    if mesh.shape["model"] > 1:
        for kind, hshape, dtype, spec, backward in record:
            b = math.prod(hshape) * dtype.itemsize // _ways(spec, mesh)
            again = 1 if train and not backward else 0
            if kind == "act":
                add("all-reduce", b, 1 + again)
            elif kind == "vec":
                add("all-reduce", b)
            elif kind == "expert":
                add("all-to-all", b, 1 + again)
    out["total"] = sum(out[k] for k in rf.COLLECTIVES)
    return out


def _count(cell: Cell, mesh) -> dict:
    """The counting run of ``cell`` (``count``'s dict) with the hint log of
    its models (``record``)."""
    with ctx.use(mesh, dp_axes(mesh), HintLog()) as record:
        c = count(cell.fn, cell.args, "meta")
    c["record"] = record
    return c


def _measure(cfg, shape, mesh, microbatches=None, pos=None, counted=None):
    """Build one cell's meta arguments and run its step once under the
    counters; return the metrics dict (per device).  ``counted``: the
    counting run (``_count``) of the same arch and shape on another mesh,
    reused: the step and its counts do not depend on the mesh, only the
    shardings and the hints' specs do (re-resolved here)."""
    t0 = time.perf_counter()
    cell = lower_cell(cfg, shape, mesh, shape.kind, microbatches, pos)
    lower_s = time.perf_counter() - t0
    c = counted if counted is not None else _count(cell, mesh)
    dp = dp_axes(mesh)
    record = [(kind, hshape, dtype, ctx.resolve(hshape, kind, mesh, dp),
               backward) for kind, hshape, dtype, _, backward in c["record"]]
    ways, batch_axes = work_ways(cell, mesh)
    arg_trees = [a for a in cell.args if not isinstance(a, int)]
    arg_specs = [s for s in cell.arg_specs if s is not None]
    pos_bytes = POS_BYTES if shape.kind == "decode" else 0
    args_total = sum(_nbytes(t) for t in _flat(arg_trees)) + pos_bytes
    memory = {
        "argument_size_in_bytes": _sharded_bytes(arg_trees, arg_specs, mesh)
        + pos_bytes,
        "output_size_in_bytes": _sharded_bytes(c["out"], cell.out_specs(c["out"]),
                                               mesh),
        "temp_size_in_bytes": (c["peak_bytes"] - args_total) // ways,
        # torch compiles nothing on this path: no generated code
        "generated_code_size_in_bytes": 0,
    }
    return {
        "flops": c["flops"] / ways,
        "bytes_accessed": c["bytes_accessed"] / ways,
        "collectives": collectives(cfg, shape, cell, record, mesh, batch_axes),
        "memory": memory,
        "ways": ways, "microbatches": cell.microbatches,
        "totals": {"flops": c["flops"], "bytes_accessed": c["bytes_accessed"],
                   "peak_bytes": c["peak_bytes"], "argument_bytes": args_total},
        "lower_s": round(lower_s, 1), "compile_s": round(c["seconds"], 1),
        "counted": c,
    }


def run_cell(arch_id: str, shape_name: str, mesh_name: str,
             counts: dict | None = None) -> dict:
    """One cell's record.  ``counts``: a dict the caller keeps across
    cells; an (arch, shape)'s counting run is made once and reused for its
    other mesh (``compile_s`` is that one run's seconds)."""
    cfg = api.get_config(arch_id)
    shape = SHAPES[shape_name]
    mesh = production_mesh(mesh_name)
    chips = mesh.size
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "chips": chips}
    if shape_name == "long_500k" and cfg.skip_long:
        rec["status"] = "skipped"
        rec["reason"] = ("pure full-attention arch; long_500k needs "
                         "sub-quadratic (DESIGN.md §Arch-applicability)")
        return rec
    key = (arch_id, shape_name)
    f = _measure(cfg, shape, mesh, counted=(counts or {}).get(key))
    if counts is not None:
        counts[key] = f["counted"]
    rec["scan_trips"] = api.scan_trips(cfg)
    for k in ("lower_s", "compile_s", "memory", "flops", "bytes_accessed",
              "collectives", "ways", "microbatches", "totals"):
        rec[k] = f[k]
    rec["roofline"] = rf.roofline_terms(f["flops"], f["bytes_accessed"],
                                        f["collectives"]["total"], chips)
    mf = rf.model_flops(cfg, shape)
    rec["model_flops"] = mf
    rec["useful_compute_ratio"] = (mf / chips / f["flops"]) if f["flops"] else None
    rec["status"] = "ok"
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)

    archs = [args.arch] if args.arch else api.ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    for arch in archs:
        for shape in shapes:
            counts = {}               # this (arch, shape)'s counting run
            for mesh_name in meshes:
                key = f"{arch}|{shape}|{mesh_name}"
                if key in results and results[key].get("status") in ("ok", "skipped") \
                        and not args.force:
                    continue
                print(f"=== {key} ===", flush=True)
                try:
                    rec = run_cell(arch, shape, mesh_name, counts)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error", "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    print(rec["error"], flush=True)
                results[key] = rec
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                if rec.get("status") == "ok":
                    r = rec["roofline"]
                    print(f"  ok lower={rec['lower_s']}s compile={rec['compile_s']}s "
                          f"flops={rec['flops']:.3g} coll={rec['collectives']['total']:.3g}B "
                          f"bottleneck={r['bottleneck']}", flush=True)

    ok = sum(1 for r in results.values() if r.get("status") == "ok")
    sk = sum(1 for r in results.values() if r.get("status") == "skipped")
    er = sum(1 for r in results.values() if r.get("status") == "error")
    print(f"DONE ok={ok} skipped={sk} error={er}")


if __name__ == "__main__":
    main()
