"""RecurrentGemma / Griffin (arXiv:2402.19427): RG-LRU recurrent blocks mixed
with local MQA attention (pattern rec,rec,attn).  The port of
``repro.models.griffin``: the linear recurrence runs as a loop over the
sequence in prefill (the reference's associative scan, in f32) and as an
O(1) state update in decode.
"""
from __future__ import annotations

import torch

from . import layers as L
from ..distributed.ctx import hint
from .transformer import (_attn_apply, _attn_params, _ffn_apply, _ffn_params,
                          alloc_cache, embed_tokens, layer_cache, nll,
                          positions, tied_logits)

_C = 8.0  # RG-LRU exponent scale


def _gates(r, i, x, lam):
    """(a, gated input) of h_t = a_t h_{t-1} + sqrt(1-a_t^2) (i_t * x_t),
    a = exp(-c*softplus(lam)*r), all in f32."""
    log_a = -_C * L.softplus(lam)[None, None, :] * r.float()
    a = torch.exp(log_a)
    gated = (i.float() * x.float()
             * torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)))
    return a, gated


def _rglru_scan(x, r, i, lam):
    """x/r/i: (B,S,W); lam: (W,) -> h (B,S,W) in x's dtype.  The scan is a
    loop over S (torch has no associative scan); the reference's parallel
    prefix sums in another order, within f32 rounding."""
    a, b = _gates(r, i, x, lam)
    h = torch.empty_like(b)
    acc = torch.zeros_like(b[:, 0])
    for t in range(b.shape[1]):
        acc = a[:, t] * acc + b[:, t]
        h[:, t] = acc
    return h.to(x.dtype)


def _rec_params(gen, cfg, n: int, device):
    D = cfg.d_model
    W = cfg.lru_width or D
    return {
        "ln": torch.zeros((n, D), dtype=torch.float32, device=device),
        "w_x": L.dense_init(gen, (n, D, W), device=device),
        "w_gate": L.dense_init(gen, (n, D, 2 * W), scale=0.02, device=device),
        "conv_w": L.dense_init(gen, (n, cfg.d_conv, W), scale=0.5, device=device),
        "lam": torch.full((n, W), 0.5, dtype=torch.float32, device=device),
        "w_out": L.dense_init(gen, (n, W, D), device=device),
    }


def _rec_apply(p, x, li, cfg, state=None):
    """Recurrent block. state: {conv (B,K-1,W), h (B,W)} for decode, written
    in place."""
    B, S, D = x.shape
    W = cfg.lru_width or D
    hx = L.rms_norm(x, p["ln"][li])
    u = hint(hx @ p["w_x"][li].to(hx.dtype), "proj")      # (B,S,W)
    gates = L._sigmoid((hx @ p["w_gate"][li].to(hx.dtype)).float())
    r, i = gates[..., :W], gates[..., W:]
    w = p["conv_w"][li].to(u.dtype)
    K = w.shape[0]
    if state is None:
        pad = torch.nn.functional.pad(u, (0, 0, K - 1, 0))
        conv = sum(pad[:, k: k + S, :] * w[k] for k in range(K))
        h = _rglru_scan(conv, r, i, p["lam"][li])
        return hint(x + (h * L.gelu(u)) @ p["w_out"][li].to(x.dtype),
                    "act"), None
    hist = torch.cat([state["conv"], u], dim=1)
    conv = torch.einsum("bkc,kc->bc", hist, w)[:, None, :]
    a, gated = _gates(r, i, conv, p["lam"][li])
    h_new = a[:, 0] * state["h"] + gated[:, 0]
    h = h_new[:, None, :].to(x.dtype)
    out = x + (h * L.gelu(u)) @ p["w_out"][li].to(x.dtype)
    state["conv"].copy_(hist[:, 1:])
    state["h"].copy_(h_new)
    return out, state


class GriffinLM(torch.nn.Module):
    """Holds no weights: every method takes the params dict.  ``dtype``:
    as ``TransformerLM``'s."""

    def __init__(self, cfg, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        pat = cfg.block_pattern
        if cfg.n_layers % len(pat):
            raise ValueError("n_layers must fit pattern")
        self.n_groups = cfg.n_layers // len(pat)
        self.pat = pat

    def init_params(self, generator=None, device=None):
        cfg = self.cfg
        g = generator
        embed = L.dense_init(g, (cfg.vocab, cfg.d_model), scale=1.0, device=device)
        dev = embed.device
        params = {
            "embed": embed,
            "final_ln": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
        }
        for gi, kind in enumerate(self.pat):
            if kind == "attn":
                params[f"mix{gi}"] = _attn_params(g, cfg, self.n_groups, dev)
            else:
                params[f"mix{gi}"] = _rec_params(g, cfg, self.n_groups, dev)
            params[f"ffn{gi}"] = _ffn_params(g, cfg, self.n_groups, False, dev)
        return params

    def forward(self, params, tokens, last_only=False):
        cfg = self.cfg
        x = embed_tokens(params, tokens, cfg.d_model, self.dtype)
        B, S, _ = x.shape
        pos = positions(B, S, x.device)

        def group_step(x, li):
            for gi, kind in enumerate(self.pat):
                if kind == "attn":
                    x, _ = _attn_apply(params[f"mix{gi}"], x, li, cfg, pos,
                                       cfg.window_pattern[0])
                else:
                    x, _ = _rec_apply(params[f"mix{gi}"], x, li, cfg)
                x, _ = _ffn_apply(params[f"ffn{gi}"], x, li, cfg, moe=False)
            return x

        step = L.remat(group_step, cfg.remat)            # each group
        for li in range(self.n_groups):
            x = step(x, li)
        x = L.rms_norm(x, params["final_ln"])
        if last_only:
            x = x[:, -1:]
        return hint(tied_logits(params, x), "logits")

    def loss(self, params, batch):
        """The training loss: mean next-token NLL in f32."""
        return nll(self.forward(params, batch["tokens"]), batch["targets"]).mean()

    def cache_spec(self, B: int, max_len: int):
        cfg = self.cfg
        W = cfg.lru_width or cfg.d_model
        win = cfg.window_pattern[0] or max_len
        spec = {}
        for gi, kind in enumerate(self.pat):
            n = self.n_groups
            if kind == "attn":
                sz = min(win, max_len)
                spec[f"g{gi}"] = {
                    "k": ((n, B, sz, cfg.n_kv, cfg.head_dim), self.dtype),
                    "v": ((n, B, sz, cfg.n_kv, cfg.head_dim), self.dtype)}
            else:
                spec[f"g{gi}"] = {"conv": ((n, B, cfg.d_conv - 1, W), self.dtype),
                                  "h": ((n, B, W), torch.float32)}
        return spec

    def init_cache(self, B: int, max_len: int, device="cuda"):
        return alloc_cache(self.cache_spec(B, max_len), device)

    def decode_step(self, params, cache, token, pos: int):
        """Returns (logits (B, V), cache), the cache written in place."""
        cfg = self.cfg
        x = embed_tokens(params, token, cfg.d_model, self.dtype)
        B = token.shape[0]
        posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        for li in range(self.n_groups):
            for gi, kind in enumerate(self.pat):
                lc = layer_cache(cache[f"g{gi}"], li)
                if kind == "attn":
                    x, _ = _attn_apply(params[f"mix{gi}"], x, li, cfg, posb,
                                       cfg.window_pattern[0], cache=lc,
                                       cache_len=pos)
                else:
                    x, _ = _rec_apply(params[f"mix{gi}"], x, li, cfg, state=lc)
                x, _ = _ffn_apply(params[f"ffn{gi}"], x, li, cfg, moe=False)
        x = L.rms_norm(x, params["final_ln"])
        return tied_logits(params, x)[:, 0], cache
