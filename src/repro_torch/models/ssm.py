"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) backbone.  The port
of ``repro.models.ssm``.

Prefill and training use the chunked SSD algorithm (within-chunk quadratic
form + the cross-chunk recurrent state carry, a loop over chunks), each
layer rematerialized in the backward under ``cfg.remat``; decode is the
O(1) recurrent update, with the depthwise conv's last ``d_conv - 1``
inputs kept in the cache.
"""
from __future__ import annotations

import functools

import torch

from . import layers as L
from ..distributed.ctx import hint
from .transformer import alloc_cache, embed_tokens, nll, tied_logits


def _einsum(eq, *ops):
    """``jnp.einsum``: the operands promoted to one dtype first (bf16 with
    f32 is f32)."""
    dt = functools.reduce(torch.promote_types, [o.dtype for o in ops])
    return torch.einsum(eq, *[o.to(dt) for o in ops])


def _segsum(x):
    """log-space segment sums: out[..., i, j] = sum_{j<k<=i} x[..., k]."""
    T = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    out = c[..., :, None] - c[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -torch.inf)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """SSD forward.
    x: (b, l, h, p); dt: (b, l, h); A: (h,) (<0); Bm/Cm: (b, l, n).
    Returns y: (b, l, h, p) and final state (b, h, p, n)."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    chunk = min(chunk, l)
    if l % chunk:
        # pad tail: dt=0 => decay exp(0)=1, zero input => state/y unaffected
        pad = chunk - l % chunk
        F = torch.nn.functional
        y, fin = ssd_chunked(F.pad(x, (0, 0, 0, 0, 0, pad)),
                             F.pad(dt, (0, 0, 0, pad)), A,
                             F.pad(Bm, (0, 0, 0, pad)),
                             F.pad(Cm, (0, 0, 0, pad)), chunk)
        return y[:, :l], fin
    nc = l // chunk
    xr = x.reshape(b, nc, chunk, h, p)
    dtr = dt.reshape(b, nc, chunk, h)
    Br = Bm.reshape(b, nc, chunk, n)
    Cr = Cm.reshape(b, nc, chunk, n)
    dA = dtr * A[None, None, None, :]                   # (b,nc,c,h)  (<0)
    dAc = torch.cumsum(dA, dim=2)

    # 1. intra-chunk (quadratic) term
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))   # (b,nc,h,c,c)
    scores = _einsum("bzin,bzjn->bzij", Cr, Br)    # (b,nc,c,c)
    y_diag = _einsum("bzhij,bzij,bzjh,bzjhp->bzihp", Lmat, scores, dtr, xr)

    # 2. chunk states: state_z = sum_j exp(dAc_end - dAc_j) * dt_j * B_j x_j
    decay_tail = torch.exp(dAc[:, :, -1:, :] - dAc)     # (b,nc,c,h)
    states = _einsum("bzch,bzch,bzcn,bzchp->bzhpn",
                     decay_tail, dtr, Br, xr)      # (b,nc,h,p,n)

    # 3. inter-chunk recurrence over z: prev[z] is the state entering chunk z
    chunk_decay = torch.exp(dAc[:, :, -1, :])           # (b,nc,h)
    s = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for z in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, z][..., None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)              # (b,nc,h,p,n)

    # 4. inter-chunk output: y_off = C_i . (decay_in * prev_state)
    decay_in = torch.exp(dAc)                           # (b,nc,c,h)
    y_off = _einsum("bzcn,bzch,bzhpn->bzchp", Cr, decay_in, prev_states)
    y = y_diag.reshape(b, l, h, p) + y_off.reshape(b, l, h, p)
    return y, s


def ssd_decode_step(state, x, dt, A, Bm, Cm):
    """state: (b,h,p,n); x: (b,h,p); dt: (b,h); Bm/Cm: (b,n)."""
    dA = torch.exp(dt * A[None, :])                     # (b,h)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, Bm, x)
    state = state * dA[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm, state)
    return y, state


class Mamba2LM(torch.nn.Module):
    """Holds no weights: every method takes the params dict.  ``dtype``:
    as ``TransformerLM``'s."""

    def __init__(self, cfg, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.d_inner = cfg.expand * cfg.d_model
        self.n_heads_ssm = self.d_inner // cfg.ssm_headdim

    def init_params(self, generator=None, device=None):
        cfg = self.cfg
        D = cfg.d_model
        di = self.d_inner
        n = cfg.ssm_state
        h = self.n_heads_ssm
        Lr = cfg.n_layers
        g = generator
        embed = L.dense_init(g, (cfg.vocab, D), scale=1.0, device=device)
        dev = embed.device

        def full(shape, v):
            return torch.full(shape, v, dtype=torch.float32, device=dev)

        return {
            "embed": embed,
            "final_ln": full((D,), 0.0),
            "blocks": {
                "ln": full((Lr, D), 0.0),
                "in_proj": L.dense_init(g, (Lr, D, 2 * di + 2 * n + h), device=dev),
                "conv_w": L.dense_init(g, (Lr, cfg.d_conv, di + 2 * n), scale=0.5,
                                       device=dev),
                "a_log": full((Lr, h), 0.0),
                "d_skip": full((Lr, h), 1.0),
                "dt_bias": full((Lr, h), 0.0),
                "out_proj": L.dense_init(g, (Lr, di, D), device=dev),
            },
        }

    def _mix(self, p, li, x):
        """in_proj split -> (z, xBC, dt)."""
        cfg = self.cfg
        di, n = self.d_inner, cfg.ssm_state
        zxbcdt = hint(x @ p["in_proj"][li].to(x.dtype), "proj")
        z = zxbcdt[..., :di]
        xBC = zxbcdt[..., di: 2 * di + 2 * n]
        dt = L.softplus(zxbcdt[..., 2 * di + 2 * n:].float() + p["dt_bias"][li])
        return z, xBC, dt

    def _block_train(self, p, li, x):
        cfg = self.cfg
        di, n, h = self.d_inner, cfg.ssm_state, self.n_heads_ssm
        hd = cfg.ssm_headdim
        B, S, D = x.shape
        hx = L.rms_norm(x, p["ln"][li])
        z, xBC, dt = self._mix(p, li, hx)
        # causal depthwise conv over (di + 2n) channels
        w = p["conv_w"][li].to(xBC.dtype)               # (K, C)
        K = w.shape[0]
        pad = torch.nn.functional.pad(xBC, (0, 0, K - 1, 0))
        conv = sum(pad[:, k: k + S, :] * w[k] for k in range(K))
        conv = L.silu(conv)
        xs = conv[..., :di].reshape(B, S, h, hd)
        Bm = conv[..., di: di + n]
        Cm = conv[..., di + n:]
        A = -torch.exp(p["a_log"][li])
        y, _ = ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk)
        y = y + xs.float() * p["d_skip"][li][None, None, :, None]
        y = (y.reshape(B, S, di) * L.silu(z.float())).to(x.dtype)
        return x + y @ p["out_proj"][li].to(x.dtype)

    def forward(self, params, tokens, last_only=False):
        cfg = self.cfg
        x = embed_tokens(params, tokens, cfg.d_model, self.dtype)
        step = L.remat(self._block_train, cfg.remat)     # each layer
        for li in range(cfg.n_layers):
            x = step(params["blocks"], li, x)
        x = L.rms_norm(x, params["final_ln"])
        if last_only:
            x = x[:, -1:]
        return hint(tied_logits(params, x), "logits")

    def loss(self, params, batch):
        """The training loss: mean next-token NLL in f32."""
        return nll(self.forward(params, batch["tokens"]), batch["targets"]).mean()

    # ------------------------------------------------------------ decode --
    def cache_spec(self, Bt: int, max_len: int):
        cfg = self.cfg
        di, n, h = self.d_inner, cfg.ssm_state, self.n_heads_ssm
        return {
            "state": ((cfg.n_layers, Bt, h, cfg.ssm_headdim, n), torch.float32),
            "conv": ((cfg.n_layers, Bt, cfg.d_conv - 1, di + 2 * n),
                     self.dtype),
        }

    def init_cache(self, Bt: int, max_len: int, device="cuda"):
        return alloc_cache(self.cache_spec(Bt, max_len), device)

    def decode_step(self, params, cache, token, pos: int):
        """Returns (logits (B, V), cache), the cache written in place."""
        cfg = self.cfg
        di, n, h = self.d_inner, cfg.ssm_state, self.n_heads_ssm
        hd = cfg.ssm_headdim
        x = embed_tokens(params, token, cfg.d_model, self.dtype)
        p = params["blocks"]
        for li in range(cfg.n_layers):
            st, cv = cache["state"][li], cache["conv"][li]
            hx = L.rms_norm(x, p["ln"][li])
            z, xBC, dt = self._mix(p, li, hx)
            hist = torch.cat([cv, xBC], dim=1)            # (B, K, C)
            w = p["conv_w"][li].to(xBC.dtype)
            conv = L.silu(torch.einsum("bkc,kc->bc", hist, w))[:, None, :]
            xs = conv[..., :di].reshape(-1, h, hd)
            Bm = conv[:, 0, di: di + n]
            Cm = conv[:, 0, di + n:]
            A = -torch.exp(p["a_log"][li])
            y, st_new = ssd_decode_step(st.float(), xs.float(), dt[:, 0], A,
                                        Bm.float(), Cm.float())
            y = y + xs.float() * p["d_skip"][li][None, :, None]
            y = (y.reshape(x.shape[0], 1, di) * L.silu(z.float())).to(x.dtype)
            x = x + y @ p["out_proj"][li].to(x.dtype)
            st.copy_(st_new)
            cv.copy_(hist[:, 1:, :])
        x = L.rms_norm(x, params["final_ln"])
        return tied_logits(params, x)[:, 0], cache
