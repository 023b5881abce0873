"""Model registry + uniform step/spec builders for every assigned arch.  The
port of ``repro.models.api``.

``build_model(cfg)`` returns a module with init_params, loss, forward,
cache_spec/init_cache and decode_step.  ``input_specs``, ``cache_specs``
and ``param_specs`` give ``device="meta"`` tensors: the shapes and dtypes
of a full-width model with nothing allocated.  ``load_reference_params``
carries a reference ``init_params`` tree (numpy arrays) across,
``load_reference_state`` a reference TrainState, and ``serving_params``
makes the copy a server holds.  ``make_train_step`` is the training step:
autograd through the model (rematerialized under ``cfg.remat``), then
AdamW.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeSpec, SHAPES  # noqa: F401
from ..tree import leaves, tree_map, unflatten_like

ARCH_IDS = [
    "gemma3_12b", "starcoder2_3b", "granite_3_8b", "codeqwen15_7b",
    "llava_next_34b", "mamba2_370m", "recurrentgemma_9b",
    "seamless_m4t_medium", "deepseek_v2_lite", "phi35_moe",
]

# Leaves the reference reads in f32 (norm scales, the MoE router, MLA's
# absorbed decode weights, the SSM's and the LRU's per-channel constants);
# it reads every other leaf through ``.astype(bf16)``.
F32_LEAVES = frozenset({"ln", "final_ln", "enc_ln", "router", "w_uk", "w_uv",
                        "a_log", "d_skip", "dt_bias", "lam"})


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def scan_trips(cfg: ArchConfig) -> int:
    """Trip count of the reference's layer scan(s) (encdec: enc_layers ==
    dec_layers)."""
    if cfg.family == "ssm":
        return cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // len(cfg.block_pattern)
    if cfg.family == "encdec":
        if cfg.enc_layers != cfg.dec_layers:
            raise ValueError(f"{cfg.name}: enc_layers != dec_layers")
        return cfg.enc_layers
    return (cfg.n_layers - cfg.dense_head_layers) // len(cfg.window_pattern)


def build_model(cfg: ArchConfig, dtype=torch.bfloat16):
    """The family's model; ``dtype`` is its compute dtype (bf16, the
    reference's policy; f32 for consistency checks at full width)."""
    if cfg.family in ("dense", "vlm", "moe"):
        from .transformer import TransformerLM
        return TransformerLM(cfg, dtype)
    if cfg.family == "ssm":
        from .ssm import Mamba2LM
        return Mamba2LM(cfg, dtype)
    if cfg.family == "hybrid":
        from .griffin import GriffinLM
        return GriffinLM(cfg, dtype)
    if cfg.family == "encdec":
        from .encdec import EncDecLM
        return EncDecLM(cfg, dtype)
    raise ValueError(cfg.family)


# -------------------------------------------------------------- input specs --

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Meta tensors for every model input of (arch, shape)."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "decode":
        # one new token against a cache of length S
        return {"token": _meta((B, 1), i32)}
    if cfg.family == "encdec":
        out = {"frames": _meta((B, min(S, cfg.src_frames), cfg.frame_dim), bf16),
               "tokens": _meta((B, S), i32)}
    elif cfg.family == "vlm":
        S = S - cfg.n_patches
        out = {"patch_embeds": _meta((B, cfg.n_patches, cfg.patch_dim), bf16),
               "tokens": _meta((B, S), i32)}
    else:
        out = {"tokens": _meta((B, S), i32)}
    if shape.kind == "train":
        out["targets"] = _meta((B, S), i32)
    return out


def cache_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    spec = build_model(cfg).cache_spec(shape.global_batch, shape.seq_len)
    return tree_map(lambda s: _meta(*s), spec)


def param_specs(cfg: ArchConfig) -> dict:
    return build_model(cfg).init_params(device="meta")


# ------------------------------------------------------- parameter carrying --

def load_reference_params(model, tree, device="cuda") -> dict:
    """The port's params from a reference ``init_params`` tree given as
    nested dicts of numpy arrays.  The port keeps the reference's layout
    (stacked ``(n, ...)`` group arrays, indexed per layer), so each leaf
    maps onto the leaf of the same path.  Raises ``KeyError`` on a missing
    or an extra key and ``ValueError`` on a shape mismatch."""
    spec = model.init_params(device="meta")

    def carry(want, got, path):
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        if missing or extra:
            raise KeyError(f"{path or 'params'}: missing {missing}, extra {extra}")
        out = {}
        for k, w in want.items():
            where = f"{path}/{k}" if path else k
            if isinstance(w, dict):
                if not isinstance(got[k], dict):
                    raise KeyError(f"{where}: a leaf where a dict belongs")
                out[k] = carry(w, got[k], where)
                continue
            a = np.asarray(got[k])
            if tuple(a.shape) != tuple(w.shape):
                raise ValueError(f"{where}: shape {tuple(a.shape)}, the port's "
                                 f"{tuple(w.shape)}")
            out[k] = torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
        return out

    return carry(spec, tree, "")


def load_reference_state(model, state, device="cuda") -> dict:
    """The port's TrainState from a reference one given as nested dicts of
    numpy arrays (``params``, ``m``, ``v``, ``step``): each tree carried by
    ``load_reference_params``, the step a 0-d int32 tensor."""
    out = {k: load_reference_params(model, state[k], device)
           for k in ("params", "m", "v")}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=device)
    return out


def serving_params(params: dict) -> dict:
    """The copy a server holds: bf16 for every leaf the reference reads only
    through ``.astype(bf16)``, f32 for ``F32_LEAVES``.  A bf16 leaf has the
    values of the per-use cast, so results do not change, and gemma3_12b
    holds 23.5 GB on the card where its f32 masters take 47.1 GB.  The
    leaves of ``params`` are popped as they are converted, so a model's two
    copies never coexist; pass a copy of the dicts to keep the masters."""
    out = {}
    for k in list(params):
        v = params.pop(k)
        if isinstance(v, dict):
            out[k] = serving_params(v)
        else:
            out[k] = v if k in F32_LEAVES else v.to(torch.bfloat16)
            del v
    return out


def copy_tree(params: dict) -> dict:
    """A copy of the dicts of a params tree, sharing its tensors."""
    return tree_map(lambda v: v, params)


def tree_bytes(tree: dict) -> int:
    return sum(v.numel() * v.element_size() if not isinstance(v, dict)
               else tree_bytes(v) for v in tree.values())


# ----------------------------------------------------------------- steps ----

def make_loss_fn(cfg: ArchConfig):
    model = build_model(cfg)

    def loss_fn(params, batch):
        return model.loss(params, batch)

    return loss_fn


def loss_and_grads(model, params, batch):
    """(loss, grads): ``model.loss`` and its gradient with respect to every
    leaf of ``params`` (the reference's value_and_grad), by
    ``torch.autograd.grad``; ``params`` is left as it is."""
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss = model.loss(unflatten_like(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    # a leaf the loss does not read gets a zero gradient, as in JAX
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), unflatten_like(params, grads)


def make_train_step(cfg: ArchConfig, microbatches: int = 1,
                    mb_scan: bool = True):
    """(state, batch) -> (state, metrics); state = TrainState (``params``
    f32 masters, ``m``, ``v``, ``step``), batch on the params' device;
    metrics: ``loss`` and, beyond the reference's, ``grad_norm`` (the
    global norm before the clip).

    The loss's gradient by ``torch.autograd.grad`` with respect to every
    params leaf, then ``adamw_update(lr=3e-4, wd=0.01)``.  microbatches >
    1: gradient accumulation over the batch reshaped to ``(microbatches,
    -1, ...)``, bounding the remat checkpoint stack to batch/microbatches:
    the losses and the f32 grads summed from zero in microbatch order,
    then multiplied by ``1 / microbatches``, as the reference's scan does.
    ``mb_scan`` is accepted for the reference's signature: both of its
    forms are this one Python loop (the reference unrolls it only for
    XLA's cost analysis).  The state passed in is left as it is.
    """
    del mb_scan
    from ..train.optimizer import adamw_update, global_norm

    model = build_model(cfg)

    def value_and_grad(params, batch):
        return loss_and_grads(model, params, batch)

    def train_step(state, batch):
        params, m, v, step = state["params"], state["m"], state["v"], state["step"]
        if microbatches == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            mbs = {k: x.reshape((microbatches, -1) + tuple(x.shape[1:]))
                   for k, x in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=step.device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            for i in range(microbatches):
                li, gi = value_and_grad(params, {k: x[i] for k, x in mbs.items()})
                loss = loss + li
                grads = tree_map(torch.add, grads, gi)
            inv = 1.0 / microbatches
            loss = loss * inv
            grads = tree_map(lambda g: g * inv, grads)
        gnorm = global_norm(grads)
        params, m, v = adamw_update(params, grads, m, v, step, lr=3e-4, wd=0.01,
                                    gnorm=gnorm)
        new_state = {"params": params, "m": m, "v": v, "step": step + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ArchConfig):
    model = build_model(cfg)

    def prefill(params, batch):
        if cfg.family == "encdec":
            enc = model.encode(params, batch["frames"])
            return model.decode_stack(params, batch["tokens"], enc,
                                      last_only=True)[:, -1]
        if cfg.family == "vlm":
            logits, _ = model.forward(params, batch["tokens"],
                                      batch.get("patch_embeds"),
                                      last_only=True)
            return logits[:, -1]
        if cfg.family in ("dense", "moe"):
            logits, _ = model.forward(params, batch["tokens"], last_only=True)
            return logits[:, -1]
        return model.forward(params, batch["tokens"], last_only=True)[:, -1]

    return prefill


def make_serve_step(cfg: ArchConfig):
    model = build_model(cfg)

    def serve_step(params, cache, token, pos: int):
        return model.decode_step(params, cache, token, pos)

    return serve_step
