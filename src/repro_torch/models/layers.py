"""Shared neural layers: RMSNorm, RoPE, GQA attention (blocked, local-window,
decode), SwiGLU/GeGLU activations, MoE dispatch.  The port of
``repro.models.layers``: plain functions on tensors, params as dicts.

Dtype policy (the reference's): params f32 masters, compute bf16 unless
noted.  Every cast point of the reference is kept where it is: an einsum
on bf16 operands rounds its result to bf16 before ``.float()`` widens it,
a product of bf16 and f32 tensors is f32, and a Python scalar applied to
a bf16 tensor is first rounded to bf16 (``_scalar``), as JAX converts a
weakly typed scalar to the array's dtype.  The activations are written
op by op as JAX writes them (its silu is ``x * (1 / (1 + exp(-x)))``
in the input's dtype), so bf16 results round where the reference's do.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint

from ..distributed.ctx import hint

NEG_INF = -1e30


def _scalar(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded through ``dtype``: the value JAX multiplies by when a
    Python scalar meets an array of that dtype."""
    return float(torch.tensor(v, dtype=dtype))


def _sigmoid(x):
    return 1 / (1 + torch.exp(-x))


def silu(x):
    return x * _sigmoid(x)


def gelu(x):
    """The tanh form, JAX's default gelu (``F.gelu(approximate="tanh")``
    rounds once where JAX rounds after each op)."""
    c = _scalar(np.sqrt(2 / np.pi), x.dtype)
    k = _scalar(0.044715, x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * x ** 3)))
    return x * cdf


def softplus(x):
    """JAX's softplus: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


ACT = {"silu": silu, "gelu": gelu, "relu": torch.relu}


def rms_norm(x, scale, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


@functools.lru_cache(maxsize=64)
def _rope_freq(half: int, theta: float, device: torch.device):
    # numpy f32, as the reference computes it from a Python float theta
    freq = theta ** (-np.arange(0, half, dtype=np.float32) / half)
    return torch.from_numpy(np.asarray(freq, np.float32)).to(device)


def rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, Hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = _rope_freq(half, theta, x.device)
    ang = positions[..., None].float() * freq                   # (..., S, half)
    ang = ang[..., None, :]                                     # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    # bf16 x times f32 cos/sin is f32: the rotation rounds once, at the end
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention --

def _pad_seq(t, n: int):
    return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n)) if n else t


def causal_attention(q, k, v, q_offset: int = 0, window: Optional[int] = None,
                     block: int = 1024, causal: bool = True,
                     static_unroll: bool = False):
    """Memory-efficient blocked attention with running logsumexp.

    q: (B, Sq, H, D), k: (B, Sk, KV, D), v: (B, Sk, KV, Dv) — Dv may differ
    from D (MLA).  q positions are q_offset..q_offset+Sq-1 against kv
    positions 0..Sk-1.  ``window``: local attention span (None = global).
    The reference's block loop, block for block: for a causal window the
    kv blocks ``k_lo .. k_lo + n_need - 1``, those past the end masked
    (never clamped onto a live block, which would count it twice).

    ``static_unroll`` is accepted for the reference's signature and
    ignored: it only reshapes XLA's loops for the dry-run's cost analysis.
    """
    del static_unroll
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    KV = k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    dev = q.device
    qb = min(block, Sq)
    kb = min(block, Sk)
    nq = -(-Sq // qb)
    nk = -(-Sk // kb)
    Sqp, Skp = nq * qb, nk * kb
    qp = _pad_seq(q, Sqp - Sq)
    kp = _pad_seq(k, Skp - Sk)
    vp = _pad_seq(v, Skp - Sk)
    qpos = q_offset + torch.arange(Sqp, device=dev)
    kpos = torch.arange(Skp, device=dev)
    inv = 1.0 / np.sqrt(D)
    outs = []
    for qi in range(nq):
        qg = qp[:, qi * qb: (qi + 1) * qb].reshape(B, qb, KV, G, D)
        qpb = qpos[qi * qb: (qi + 1) * qb]
        m = torch.full((B, KV, G, qb), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KV, G, qb), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, qb, Dv), dtype=torch.float32, device=dev)
        if window is not None and causal:
            k_lo = max((qi * qb + q_offset - (window - 1) - (kb - 1)) // kb, 0)
            n_need = (qb + window - 1 + kb - 1) // kb + 1
            kis = [k_lo + j for j in range(min(n_need, nk))]
        else:
            kis = list(range(nk))
        for ki in kis:
            ke = min(ki, nk - 1)
            kblk = kp[:, ke * kb: (ke + 1) * kb]
            vblk = vp[:, ke * kb: (ke + 1) * kb]
            kpb = kpos[ke * kb: (ke + 1) * kb]
            bias = torch.full((qb, kb), 0.0 if ki < nk else NEG_INF,
                              dtype=torch.float32, device=dev)
            dpos = qpb[:, None] - kpb[None, :]
            if causal:
                bias = torch.where(dpos >= 0, bias, NEG_INF)
            if window is not None:
                bias = torch.where(dpos < window, bias, NEG_INF)
            bias = torch.where(kpb[None, :] < Sk, bias, NEG_INF)
            s = torch.einsum("btkgd,bskd->bkgts", qg, kblk).float()
            s = s * inv + bias[None, None, None]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            scale = torch.exp(m - m_new)
            l = l * scale + p.sum(dim=-1)
            acc = acc * scale[..., None] + torch.einsum(
                "bkgts,bskd->bkgtd", p.to(vblk.dtype), vblk).float()
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, qb, H, Dv))
    return torch.cat(outs, dim=1)[:, :Sq].to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-step decode: q (B,1,H,D) against caches (B,Smax,KV,D[v])."""
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    Dv = v_cache.shape[-1]
    G = H // KV
    qg = q.reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float()
    s = s * (1.0 / np.sqrt(D))
    pos = torch.arange(k_cache.shape[1], device=q.device)
    s = torch.where(pos < cache_len, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, H, Dv).to(q.dtype)


# --------------------------------------------------------------------- MoE --

def _one_hot(idx, n: int):
    """JAX's one_hot: f32, an all-zero row for an index outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _top_k(x, k: int):
    """JAX's top_k over the last axis: ties go to the lower index (a stable
    descending sort keeps equal values in index order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_dispatch(x, router_w, n_experts: int, top_k: int,
                 capacity_factor=1.25):
    """GShard-style token-choice top-k dispatch.

    x: (T, D) -> (dispatch (T, E, C) 0/1 f32, combine (T, E, C) f32, aux
    loss, capacity C)
    """
    T = x.shape[0]
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    # floor at 2*top_k so tiny decode batches are effectively dropless
    # (Python's round: half to even, as the reference's)
    cap = int(max(2 * top_k, round(T * top_k * capacity_factor / n_experts)))
    gates, idx = _top_k(probs, top_k)                   # (T, k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    onehot = _one_hot(idx, n_experts)                    # (T,k,E)
    # position of each (token, slot) within its expert queue — counted over
    # the flattened (T*k) stream so slots of different ranks never collide
    T_, K_ = idx.shape
    oh_flat = onehot.reshape(T_ * K_, n_experts)
    pos = torch.cumsum(oh_flat, dim=0) - oh_flat
    pos = (pos * oh_flat).sum(-1).reshape(T_, K_)
    keep = pos < cap
    gates = gates * keep
    pos_oh = _one_hot(pos.to(torch.int32), cap)
    dispatch = torch.einsum("tke,tkc->tec", onehot * keep[..., None], pos_oh)
    combine = torch.einsum("tk,tke,tkc->tec", gates, onehot, pos_oh)
    # load-balance auxiliary loss (Switch)
    me = probs.mean(0)
    ce = onehot[:, 0].mean(0)
    aux = n_experts * torch.sum(me * ce)
    return dispatch, combine, aux, cap


def _moe_ffn_tokens(xt, params, n_experts, top_k, act, capacity_factor):
    dispatch, combine, aux, cap = moe_dispatch(xt, params["router"],
                                               n_experts, top_k,
                                               capacity_factor)
    dt = xt.dtype
    xe = hint(torch.einsum("tec,td->ecd", dispatch.to(dt), xt), "expert")
    gate_up = torch.einsum("ecd,edf->ecf", xe, params["wi"].to(dt))
    f = params["wo"].shape[1]
    g, u = gate_up[..., :f], gate_up[..., f:]
    h = ACT[act](g) * u
    ye = hint(torch.einsum("ecf,efd->ecd", h, params["wo"].to(dt)), "expert")
    y = torch.einsum("tec,ecd->td", combine.to(dt), ye)
    return y, aux


def moe_ffn(x, params, n_experts: int, top_k: int, act="silu",
            capacity_factor: float = 1.25, token_chunk: int = 4096,
            static_chunks: bool = False):
    """x: (B,S,D); params: router (D,E), wi (E,D,2F), wo (E,F,D).

    Long sequences are dispatched in ``token_chunk`` groups (zero-padded to
    whole chunks, the pad tokens routed like the reference's) — the (T, E,
    C) dispatch one-hots are O(T^2/E).  ``static_chunks`` is accepted for
    the reference's signature and ignored: it only coarsens the chunks of
    the dry-run's unrolled cost analysis.
    """
    del static_chunks
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    T = B * S
    if T <= token_chunk:
        y, aux = _moe_ffn_tokens(xt, params, n_experts, top_k, act,
                                 capacity_factor)
        return y.reshape(B, S, D), aux
    nchunk = -(-T // token_chunk)
    Tp = nchunk * token_chunk
    xp = torch.nn.functional.pad(xt, (0, 0, 0, Tp - T))
    ys, aux = [], 0.0
    for i in range(nchunk):
        yi, ai = _moe_ffn_tokens(xp[i * token_chunk: (i + 1) * token_chunk],
                                 params, n_experts, top_k, act,
                                 capacity_factor)
        ys.append(yi)
        aux = aux + ai
    y = torch.cat(ys, dim=0)
    return y[:T].reshape(B, S, D), aux / nchunk


# ------------------------------------------------------------------- remat --

def remat(fn, on: bool):
    """``fn`` under activation checkpointing when ``on`` (``cfg.remat``) and
    autograd is recording, else ``fn`` itself: the reference's
    checkpoint around a scan step, which saves the step's inputs
    and recomputes the rest in the backward.  Serving, with grad disabled
    or nothing requiring it, computes exactly what ``fn`` computes."""
    def step(*args):
        if on and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args,
                                                     use_reentrant=False)
        return fn(*args)
    return step


# -------------------------------------------------------------------- init --

def dense_init(generator, shape, scale=None, device=None):
    """N(0, 1) * scale, f32, drawn on ``generator``'s device (or on
    ``device`` without a generator: ``"meta"`` for shapes only).  The
    reference's scale: ``1 / sqrt(shape[0])`` unless given — for a stacked
    ``(n, ...)`` group array that is the stack depth, kept as it is."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    if generator is not None:
        device = generator.device
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device) * s
