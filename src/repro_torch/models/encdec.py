"""Encoder-decoder transformer (SeamlessM4T-medium backbone).  The port of
``repro.models.encdec``.

Audio frontend is a STUB: ``input_specs`` provides precomputed frame
embeddings (B, src_frames, frame_dim); a linear projection lifts them to
d_model.  Decoder: causal self-attn + cross-attn over encoder states;
``decode_step`` attends to the encoder K/V held in the cache (``ek``,
``ev``) and writes its own self-attention K/V in place.
"""
from __future__ import annotations

import torch

from . import layers as L
from ..distributed.ctx import hint
from .transformer import (_attn_params, _ffn_apply, _ffn_params, alloc_cache,
                          embed_tokens, nll, positions, tied_logits)


def _self_attn(p, x, li, cfg, causal, positions, cache=None, cache_len=None):
    B, S, D = x.shape
    H, KV, Hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    h = L.rms_norm(x, p["ln"][li])
    dt = h.dtype
    q = (h @ p["wq"][li].to(dt)).reshape(B, S, H, Hd)
    k = (h @ p["wk"][li].to(dt)).reshape(B, S, KV, Hd)
    v = (h @ p["wv"][li].to(dt)).reshape(B, S, KV, Hd)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    if cache is None:
        o = L.causal_attention(q, k, v, causal=causal)
    else:
        slot = min(cache_len, cache["k"].shape[1] - 1)  # a clamped update index
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        o = L.decode_attention(q, cache["k"], cache["v"], cache_len + 1)
    return x + o.reshape(B, S, H * Hd) @ p["wo"][li].to(dt), cache


def _cross_attn(p, x, li, cfg, enc_kv):
    """enc_kv: precomputed (k, v) from encoder states: (B, Ssrc, KV, Hd)."""
    B, S, D = x.shape
    H, Hd = cfg.n_heads, cfg.head_dim
    h = L.rms_norm(x, p["ln"][li])
    q = (h @ p["wq"][li].to(h.dtype)).reshape(B, S, H, Hd)
    k, v = enc_kv
    o = L.causal_attention(q, k, v, causal=False)
    return x + o.reshape(B, S, H * Hd) @ p["wo"][li].to(h.dtype)


class EncDecLM(torch.nn.Module):
    """Holds no weights: every method takes the params dict.  ``dtype``:
    as ``TransformerLM``'s."""

    def __init__(self, cfg, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype

    def init_params(self, generator=None, device=None):
        cfg = self.cfg
        g = generator
        frame_proj = L.dense_init(g, (cfg.frame_dim, cfg.d_model), device=device)
        dev = frame_proj.device
        zeros = (lambda: torch.zeros((cfg.d_model,), dtype=torch.float32,
                                     device=dev))
        return {
            "frame_proj": frame_proj,
            "embed": L.dense_init(g, (cfg.vocab, cfg.d_model), scale=1.0,
                                  device=dev),
            "enc_attn": _attn_params(g, cfg, cfg.enc_layers, dev),
            "enc_ffn": _ffn_params(g, cfg, cfg.enc_layers, False, dev),
            "dec_attn": _attn_params(g, cfg, cfg.dec_layers, dev),
            # the cross-attention's params have the self-attention's keys
            "dec_xattn": _attn_params(g, cfg, cfg.dec_layers, dev),
            "dec_ffn": _ffn_params(g, cfg, cfg.dec_layers, False, dev),
            "enc_ln": zeros(),
            "final_ln": zeros(),
        }

    def encode(self, params, frames):
        cfg = self.cfg
        x = frames.to(self.dtype) @ params["frame_proj"].to(self.dtype)
        B, S, _ = x.shape
        pos = positions(B, S, x.device)

        def layer(x, li):
            x, _ = _self_attn(params["enc_attn"], x, li, cfg, causal=False,
                              positions=pos)
            x, _ = _ffn_apply(params["enc_ffn"], x, li, cfg, moe=False)
            return x

        step = L.remat(layer, cfg.remat)                 # each layer
        for li in range(cfg.enc_layers):
            x = step(x, li)
        return L.rms_norm(x, params["enc_ln"])

    def enc_kv(self, params, enc_out):
        """Per-decoder-layer cross K/V from encoder output."""
        cfg = self.cfg
        B, S, D = enc_out.shape
        KV, Hd = cfg.n_kv, cfg.head_dim
        px = params["dec_xattn"]
        h = torch.stack([L.rms_norm(enc_out, ln) for ln in px["ln"]])  # (L,B,S,D)
        k = torch.einsum("lbsd,ldk->lbsk", h, px["wk"].to(h.dtype))
        v = torch.einsum("lbsd,ldk->lbsk", h, px["wv"].to(h.dtype))
        return (k.reshape(cfg.dec_layers, B, S, KV, Hd),
                v.reshape(cfg.dec_layers, B, S, KV, Hd))

    def decode_stack(self, params, tokens, enc_out, cache=None, pos0=0,
                     last_only=False):
        cfg = self.cfg
        x = embed_tokens(params, tokens, cfg.d_model, self.dtype)
        B, S, _ = x.shape
        pos = positions(B, S, x.device, pos0)
        ek, ev = self.enc_kv(params, enc_out)

        def layer(x, li):
            x, _ = _self_attn(params["dec_attn"], x, li, cfg, causal=True,
                              positions=pos)
            x = _cross_attn(params["dec_xattn"], x, li, cfg, (ek[li], ev[li]))
            x, _ = _ffn_apply(params["dec_ffn"], x, li, cfg, moe=False)
            return x

        step = L.remat(layer, cfg.remat)                 # each layer
        for li in range(cfg.dec_layers):
            x = step(x, li)
        x = L.rms_norm(x, params["final_ln"])
        if last_only:
            x = x[:, -1:]
        return hint(tied_logits(params, x), "logits")

    def loss(self, params, batch):
        """The training loss: mean next-token NLL in f32."""
        enc = self.encode(params, batch["frames"])
        logits = self.decode_stack(params, batch["tokens"], enc)
        return nll(logits, batch["targets"]).mean()

    # ------------------------------------------------------------ decode --
    def cache_spec(self, B: int, max_len: int):
        cfg = self.cfg
        KV, Hd = cfg.n_kv, cfg.head_dim
        Ld = cfg.dec_layers
        S = cfg.src_frames
        dt = self.dtype
        return {
            "k": ((Ld, B, max_len, KV, Hd), dt),
            "v": ((Ld, B, max_len, KV, Hd), dt),
            "ek": ((Ld, B, S, KV, Hd), dt),
            "ev": ((Ld, B, S, KV, Hd), dt),
        }

    def init_cache(self, B: int, max_len: int, device="cuda"):
        return alloc_cache(self.cache_spec(B, max_len), device)

    def decode_step(self, params, cache, token, pos: int):
        """Returns (logits (B, V), cache), the self-attention K/V written in
        place; the encoder K/V (``ek``, ``ev``) are read as they are."""
        cfg = self.cfg
        x = embed_tokens(params, token, cfg.d_model, self.dtype)
        B = token.shape[0]
        posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        px = params["dec_xattn"]
        for li in range(cfg.dec_layers):
            x, _ = _self_attn(params["dec_attn"], x, li, cfg, causal=True,
                              positions=posb,
                              cache={"k": cache["k"][li], "v": cache["v"][li]},
                              cache_len=pos)
            # cross attention against cached encoder K/V (full source)
            ek, ev = cache["ek"][li], cache["ev"][li]
            h = L.rms_norm(x, px["ln"][li])
            q = (h @ px["wq"][li].to(h.dtype)).reshape(B, 1, cfg.n_heads,
                                                       cfg.head_dim)
            o = L.decode_attention(q, ek, ev, ek.shape[1])
            x = x + (o.reshape(B, 1, cfg.n_heads * cfg.head_dim)
                     @ px["wo"][li].to(h.dtype))
            x, _ = _ffn_apply(params["dec_ffn"], x, li, cfg, moe=False)
        x = L.rms_norm(x, params["final_ln"])
        return tied_logits(params, x)[:, 0], cache
