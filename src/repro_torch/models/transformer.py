"""Decoder-only transformer LM covering the dense, VLM-backbone and MoE
(incl. DeepSeek MLA) assigned architectures.  The port of
``repro.models.transformer``.

Params keep the reference's layout: layer stacks grouped by the repeating
layer *pattern* (e.g. gemma3's 5 local + 1 global), each group's weights
stacked ``(n, ...)`` and indexed per layer (a view, no copy), so a
reference ``init_params`` tree carries across unchanged
(``api.load_reference_params``).  KV caches are ring-buffered for local
layers (window-sized) and full-length for global layers, and
``decode_step`` writes them in place.
"""
from __future__ import annotations

import numpy as np
import torch

from . import layers as L
from ..distributed.ctx import hint


def _zeros(shape, device):
    return torch.zeros(shape, dtype=torch.float32, device=device)


# ----------------------------------------------------------------- params --

def _attn_params(gen, cfg, n: int, device):
    D, H, KV, Hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    if cfg.mla:
        r, qn, qr, vh = cfg.kv_lora, cfg.q_nope, cfg.q_rope, cfg.v_head
        return {
            "wq": L.dense_init(gen, (n, D, H * (qn + qr)), device=device),
            "w_dkv": L.dense_init(gen, (n, D, r + qr), device=device),
            "w_uk": L.dense_init(gen, (n, r, H * qn), device=device),
            "w_uv": L.dense_init(gen, (n, r, H * vh), device=device),
            "wo": L.dense_init(gen, (n, H * vh, D), device=device),
            "ln": _zeros((n, D), device),
        }
    return {
        "wq": L.dense_init(gen, (n, D, H * Hd), device=device),
        "wk": L.dense_init(gen, (n, D, KV * Hd), device=device),
        "wv": L.dense_init(gen, (n, D, KV * Hd), device=device),
        "wo": L.dense_init(gen, (n, H * Hd, D), device=device),
        "ln": _zeros((n, D), device),
    }


def _ffn_params(gen, cfg, n: int, moe: bool, device):
    D = cfg.d_model
    if moe:
        E, F = cfg.n_experts, cfg.d_ff_expert
        p = {
            "router": L.dense_init(gen, (n, D, E), scale=0.02, device=device),
            "wi": L.dense_init(gen, (n, E, D, 2 * F), device=device),
            "wo": L.dense_init(gen, (n, E, F, D), device=device),
            "ln": _zeros((n, D), device),
        }
        if cfg.n_shared:
            Fs = cfg.d_ff_expert * cfg.n_shared
            p["shared_wi"] = L.dense_init(gen, (n, D, 2 * Fs), device=device)
            p["shared_wo"] = L.dense_init(gen, (n, Fs, D), device=device)
        return p
    F = cfg.d_ff
    width = 2 * F if cfg.glu else F
    return {
        "wi": L.dense_init(gen, (n, D, width), device=device),
        "wo": L.dense_init(gen, (n, F, D), device=device),
        "ln": _zeros((n, D), device),
    }


def embed_tokens(params, tokens, d_model: int, dtype=torch.bfloat16):
    """``embed.astype(bf16)[tokens] * sqrt(d_model)``, gathered before the
    cast (the same values; a bf16 copy of the whole table per call is
    2 GB at gemma3's width)."""
    x = params["embed"][tokens].to(dtype)
    return x * L._scalar(float(np.sqrt(d_model)), dtype)


def tied_logits(params, x):
    return x @ params["embed"].to(x.dtype).T


def positions(B: int, S: int, device, pos0: int = 0):
    return (pos0 + torch.arange(S, dtype=torch.int32, device=device))[None, :] \
        .repeat(B, 1)


# ---------------------------------------------------------------- forward --

def _attn_apply(p, x, li, cfg, positions, window, cache=None, cache_len=None):
    """One attention sub-block.  li indexes the stacked layer params.
    cache: this layer's k/v (ring or full) for decode, written in place at
    position ``cache_len``; returns (out, cache)."""
    B, S, D = x.shape
    H, KV, Hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    h = L.rms_norm(x, p["ln"][li])
    dt = h.dtype
    if cfg.mla:
        return _mla_apply(p, h, x, li, cfg, positions, cache, cache_len)
    q = hint(h @ p["wq"][li].to(dt), "proj").reshape(B, S, H, Hd)
    k = (h @ p["wk"][li].to(dt)).reshape(B, S, KV, Hd)
    v = (h @ p["wv"][li].to(dt)).reshape(B, S, KV, Hd)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    if cache is None:
        o = L.causal_attention(q, k, v, window=window)
    else:
        # decode: S == 1; write k/v into the (ring) cache — local layers keep
        # only `window` slots, slot = pos % size
        Smax = cache["k"].shape[1]
        slot = cache_len % Smax
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        o = L.decode_attention(q, cache["k"], cache["v"],
                               min(cache_len + 1, Smax))
    o = o.reshape(B, S, H * Hd) @ p["wo"][li].to(dt)
    return hint(x + o, "act"), cache


def _mla_apply(p, h, x, li, cfg, positions, cache, cache_len):
    """DeepSeek-V2 MLA: latent KV cache (kv_lora + shared rope key)."""
    B, S, D = h.shape
    H = cfg.n_heads
    r, qn, qr, vh = cfg.kv_lora, cfg.q_nope, cfg.q_rope, cfg.v_head
    dt = h.dtype
    q = (h @ p["wq"][li].to(dt)).reshape(B, S, H, qn + qr)
    q_nope, q_rope = q[..., :qn], q[..., qn:]
    q_rope = L.rope(q_rope, positions, cfg.rope_theta)
    ckr = h @ p["w_dkv"][li].to(dt)                          # (B,S,r+qr)
    c_kv, k_rope = ckr[..., :r], ckr[..., r:]
    k_rope = L.rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    if cache is None:
        # prefill/train: expand per head in bf16 (standard formulation)
        k_nope = (c_kv @ p["w_uk"][li].to(dt)).reshape(B, S, H, qn)
        v = (c_kv @ p["w_uv"][li].to(dt)).reshape(B, S, H, vh)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, qr)],
                      dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        o = L.causal_attention(qq, k, v, window=None)
        o = o.reshape(B, S, H * vh) @ p["wo"][li].to(dt)
        return hint(x + o, "act"), None
    # decode: absorbed formulation against the latent cache, contracted in
    # f32 against the f32 masters of w_uk / w_uv
    cc, cr = cache["c_kv"], cache["k_rope"]
    slot = min(cache_len, cc.shape[1] - 1)        # a clamped update index
    cc[:, slot] = c_kv[:, 0]
    cr[:, slot] = k_rope[:, 0]
    eff = cache_len + 1
    w_uk = p["w_uk"][li].reshape(r, H, qn)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_uk)
    s = (torch.einsum("bhr,btr->bht", q_abs, cc.float())
         + torch.einsum("bhd,btd->bht", q_rope[:, 0].float(), cr.float()))
    s = s * (1.0 / np.sqrt(qn + qr))
    tpos = torch.arange(cc.shape[1], device=h.device)
    s = torch.where(tpos < eff, s, L.NEG_INF)
    pr = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bht,btr->bhr", pr, cc.float())
    w_uv = p["w_uv"][li].reshape(r, H, vh)
    o = torch.einsum("bhr,rhv->bhv", ctx, w_uv).reshape(B, 1, H * vh).to(dt)
    return x + o @ p["wo"][li].to(dt), cache


def _ffn_apply(p, x, li, cfg, moe: bool):
    h = L.rms_norm(x, p["ln"][li])
    dt = h.dtype
    aux = 0.0
    if moe:
        y, aux = L.moe_ffn(h, {"router": p["router"][li], "wi": p["wi"][li],
                               "wo": p["wo"][li]},
                           cfg.n_experts, cfg.top_k, cfg.act,
                           capacity_factor=cfg.moe_cap_factor)
        if cfg.n_shared:
            gu = h @ p["shared_wi"][li].to(dt)
            f = p["shared_wo"].shape[1]
            y = y + (L.ACT[cfg.act](gu[..., :f]) * gu[..., f:]) \
                @ p["shared_wo"][li].to(dt)
    else:
        gu = hint(h @ p["wi"][li].to(dt), "proj")
        if cfg.glu:
            f = p["wo"].shape[1]
            y = (L.ACT[cfg.act](gu[..., :f]) * gu[..., f:]) @ p["wo"][li].to(dt)
        else:
            y = L.ACT[cfg.act](gu) @ p["wo"][li].to(dt)
    return hint(x + y, "act"), aux


def layer_cache(cache: dict, li: int) -> dict:
    """Layer ``li``'s views of a stacked cache group."""
    return {k: v[li] for k, v in cache.items()}


def nll(logits, tgt, hinted: bool = False):
    """Per-token ``logsumexp - gold`` in f32; a negative target reads the
    last class, as numpy's (and the reference's) negative index does.
    ``hinted``: both terms pass through ``hint(.., "vec")``, as in the
    reference's transformer loss (its other families hint neither)."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    idx = torch.where(tgt < 0, tgt + lg.shape[-1], tgt).long()
    gold = torch.gather(lg, -1, idx[..., None])[..., 0]
    if hinted:
        lse, gold = hint(lse, "vec"), hint(gold, "vec")
    return lse - gold


class TransformerLM(torch.nn.Module):
    """Decoder-only LM; cfg: configs.base.ArchConfig.  Holds no weights:
    every method takes the params dict, as the reference's does.
    ``dtype``: the residual stream's and the KV caches' dtype — bf16, the
    reference's policy, or f32, where rounding noise stays far below the
    bf16 noise that 48 random layers amplify (a full-width consistency
    check of decode against prefill)."""

    def __init__(self, cfg, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        pat = cfg.window_pattern
        # split stack into [head layers][groups of |pat|]
        self.group = len(pat)
        self.head_layers = cfg.dense_head_layers       # e.g. deepseek layer 0
        body = cfg.n_layers - self.head_layers
        if body % self.group:
            raise ValueError(f"{cfg.name}: {body} body layers not divisible "
                             f"by pattern {pat}")
        self.n_groups = body // self.group

    # -------------------------------------------------------------- init --
    def init_params(self, generator=None, device=None):
        """f32 params in the reference's layout, drawn from ``generator`` on
        its device (or on ``device``, e.g. ``"meta"``, without one)."""
        cfg = self.cfg
        g, dev = generator, device
        params = {
            "embed": L.dense_init(g, (cfg.vocab, cfg.d_model), scale=1.0,
                                  device=dev),
        }
        dev = params["embed"].device
        params["final_ln"] = _zeros((cfg.d_model,), dev)
        if self.head_layers:
            params["head_attn"] = _attn_params(g, cfg, self.head_layers, dev)
            params["head_ffn"] = _ffn_params(g, cfg, self.head_layers, False, dev)
        for gi in range(self.group):
            params[f"attn{gi}"] = _attn_params(g, cfg, self.n_groups, dev)
            params[f"ffn{gi}"] = _ffn_params(g, cfg, self.n_groups, cfg.moe, dev)
        if cfg.n_patches:
            params["patch_proj"] = L.dense_init(
                g, (cfg.patch_dim, cfg.d_model), device=dev)
        return params

    # ----------------------------------------------------------- forward --
    def _embed(self, params, tokens, patch_embeds=None):
        x = hint(embed_tokens(params, tokens, self.cfg.d_model, self.dtype),
                 "act")
        if patch_embeds is not None:
            pe = patch_embeds.to(self.dtype) @ params["patch_proj"].to(self.dtype)
            x = torch.cat([pe, x], dim=1)
        return x

    def forward(self, params, tokens, patch_embeds=None, last_only=False):
        cfg = self.cfg
        x = self._embed(params, tokens, patch_embeds)
        B, S, _ = x.shape
        pos = positions(B, S, x.device)
        for li in range(self.head_layers):
            x, _ = _attn_apply(params["head_attn"], x, li, cfg, pos, None)
            x, _ = _ffn_apply(params["head_ffn"], x, li, cfg, moe=False)

        def group_step(x, aux, li):
            for gi in range(self.group):
                w = cfg.window_pattern[gi]
                x, _ = _attn_apply(params[f"attn{gi}"], x, li, cfg, pos, w)
                x, a = _ffn_apply(params[f"ffn{gi}"], x, li, cfg, moe=cfg.moe)
                aux = aux + a
            return x, aux

        # each layer group recomputed in the backward, nothing saved inside
        # it (the reference's nothing_saveable policy)
        step = L.remat(group_step, cfg.remat)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for li in range(self.n_groups):
            x, aux_total = step(x, aux_total, li)
        x = L.rms_norm(x, params["final_ln"])
        if last_only:
            x = x[:, -1:]
        return hint(tied_logits(params, x), "logits"), aux_total

    def loss(self, params, batch):
        """The training loss: masked mean NLL in f32 plus 0.01 x the MoE
        load-balance loss."""
        cfg = self.cfg
        logits, aux = self.forward(params, batch["tokens"],
                                   batch.get("patch_embeds"))
        tgt = batch["targets"]
        if cfg.n_patches:
            logits = logits[:, -tgt.shape[1]:]
        mask = (tgt >= 0).float()
        total = (nll(logits, tgt, hinted=True) * mask).sum() \
            / torch.clamp_min(mask.sum(), 1.0)
        return total + 0.01 * aux

    # ------------------------------------------------------------ decode --
    def cache_spec(self, B: int, max_len: int):
        """Cache shapes: ring (window) for local layers, full for global."""
        cfg = self.cfg
        KV, Hd = cfg.n_kv, cfg.head_dim
        dt = self.dtype
        spec = {}

        def attn_cache(n, w):
            size = min(w, max_len) if w else max_len
            if cfg.mla:
                return {"c_kv": ((n, B, size, cfg.kv_lora), dt),
                        "k_rope": ((n, B, size, cfg.q_rope), dt)}
            return {"k": ((n, B, size, KV, Hd), dt),
                    "v": ((n, B, size, KV, Hd), dt)}

        if self.head_layers:
            spec["head"] = attn_cache(self.head_layers, None)
        for gi in range(self.group):
            spec[f"g{gi}"] = attn_cache(self.n_groups, cfg.window_pattern[gi])
        return spec

    def init_cache(self, B: int, max_len: int, device="cuda"):
        return alloc_cache(self.cache_spec(B, max_len), device)

    def decode_step(self, params, cache, token, pos: int):
        """token: (B, 1) int; pos: the position (a Python int).  Returns
        (logits (B, V), cache), the cache written in place."""
        cfg = self.cfg
        x = embed_tokens(params, token, cfg.d_model, self.dtype)
        B = token.shape[0]
        posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        for li in range(self.head_layers):
            x, _ = _attn_apply(params["head_attn"], x, li, cfg, posb, None,
                               cache=layer_cache(cache["head"], li),
                               cache_len=pos)
            x, _ = _ffn_apply(params["head_ffn"], x, li, cfg, moe=False)
        for li in range(self.n_groups):
            for gi in range(self.group):
                x, _ = _attn_apply(params[f"attn{gi}"], x, li, cfg, posb,
                                   cfg.window_pattern[gi],
                                   cache=layer_cache(cache[f"g{gi}"], li),
                                   cache_len=pos)
                x, _ = _ffn_apply(params[f"ffn{gi}"], x, li, cfg, moe=cfg.moe)
        x = L.rms_norm(x, params["final_ln"])
        return hint(tied_logits(params, x), "logits")[:, 0], cache

    def prefill(self, params, tokens):
        """Returns final logits after processing the prompt (cache omitted:
        decode initializes its caches directly)."""
        logits, _ = self.forward(params, tokens)
        return logits[:, -1]


def alloc_cache(spec: dict, device):
    """Zero tensors for a ``cache_spec`` tree of ((shape), dtype) leaves."""
    return {k: alloc_cache(v, device) if isinstance(v, dict)
            else torch.zeros(v[0], dtype=v[1], device=device)
            for k, v in spec.items()}
