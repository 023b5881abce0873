"""Architecture config schema + the 4 assigned input shapes.

Every assigned arch is a module ``configs/<id>.py`` exporting ``CONFIG``.
``reduced()`` derives the CPU smoke-test configuration (same family/shape
semantics, tiny dims).  The port's copy of ``repro.configs.base``: every
field and method is the reference's, so ``dataclasses.asdict`` of a port
config equals the reference's.  A full config is allocated only on the
card (``launch/serve.py``); elsewhere its shapes are ``device="meta"``
tensors (``models.api.param_specs``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | vlm | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"
    glu: bool = True
    rope_theta: float = 1e4
    window_pattern: Tuple[Optional[int], ...] = (None,)
    dense_head_layers: int = 0
    remat: bool = True
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_ff_expert: int = 0
    moe_cap_factor: float = 1.25
    # --- MLA ---
    mla: bool = False
    kv_lora: int = 512
    q_nope: int = 128
    q_rope: int = 64
    v_head: int = 128
    # --- SSM (mamba2) ---
    ssm_state: int = 128
    ssm_headdim: int = 64
    expand: int = 2
    d_conv: int = 4
    ssm_chunk: int = 256
    # --- hybrid (griffin) ---
    block_pattern: Tuple[str, ...] = ()          # e.g. ("rec","rec","attn")
    lru_width: int = 0
    # --- encdec ---
    enc_layers: int = 0
    dec_layers: int = 0
    src_frames: int = 0                          # audio frontend stub length
    frame_dim: int = 0
    # --- vlm ---
    n_patches: int = 0
    patch_dim: int = 0
    scan_unroll: int = 0                         # dry-run: scan unroll factor (cost_analysis ignores trip counts)
    # --- applicability ---
    skip_long: bool = True                       # long_500k needs sub-quadratic
    note: str = ""

    def shapes(self):
        out = []
        for s in SHAPES.values():
            if s.name == "long_500k" and self.skip_long:
                continue
            out.append(s)
        return out

    def reduced(self) -> "ArchConfig":
        """Smoke-test config: same family semantics, tiny dims."""
        pat = tuple((min(w, 64) if w else None) for w in self.window_pattern)
        n_body = max(1, len(self.block_pattern) if self.block_pattern else len(pat))
        return dataclasses.replace(
            self,
            n_layers=self.dense_head_layers + n_body,
            d_model=64,
            n_heads=4, n_kv=min(max(1, self.n_kv), 4) if self.n_kv else 0,
            head_dim=16, d_ff=128, vocab=512,
            window_pattern=pat,
            n_experts=min(self.n_experts, 4) if self.moe else 0,
            top_k=min(self.top_k, 2) if self.moe else 0,
            n_shared=min(self.n_shared, 1),
            d_ff_expert=32 if self.moe else 0,
            kv_lora=32, q_nope=16, q_rope=8, v_head=16,
            ssm_state=16, ssm_headdim=8, expand=2, ssm_chunk=16,
            block_pattern=self.block_pattern,
            lru_width=64 if self.lru_width else 0,
            enc_layers=min(self.enc_layers, 2),
            dec_layers=min(self.dec_layers, 2),
            src_frames=32 if self.src_frames else 0,
            frame_dim=16 if self.frame_dim else 0,
            n_patches=8 if self.n_patches else 0,
            patch_dim=16 if self.n_patches else 0,
            remat=False,
        )

    def param_count(self) -> float:
        """Approximate parameter count (for 6ND roofline math)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        H, KV, Hd = self.n_heads, self.n_kv, self.head_dim
        emb = V * D
        if self.family == "ssm":
            di = self.expand * D
            per = D * 2 * di + di * D + di * (2 * self.ssm_state) + di
            return emb + L * per
        if self.family == "encdec":
            attn = D * (H * Hd) * 2 + D * (KV * Hd) * 2
            ffn = D * F * (3 if self.glu else 2)
            return emb + (self.enc_layers + self.dec_layers) * (attn + ffn) \
                + self.dec_layers * attn
        attn = D * (H * Hd) + 2 * D * (KV * Hd) + (H * Hd) * D
        if self.mla:
            attn = (D * H * (self.q_nope + self.q_rope)
                    + D * (self.kv_lora + self.q_rope)
                    + self.kv_lora * H * (self.q_nope + self.v_head)
                    + H * self.v_head * D)
        if self.moe:
            fe = self.d_ff_expert
            ffn = (D * self.n_experts
                   + self.n_experts * (D * 2 * fe + fe * D)
                   + (self.n_shared * (D * 2 * fe + fe * D) if self.n_shared else 0))
        else:
            ffn = D * F * (3 if self.glu else 2)
        if self.family == "hybrid":
            n_attn = sum(1 for b in self.block_pattern if b == "attn")
            n_rec = len(self.block_pattern) - n_attn
            cyc = len(self.block_pattern)
            la = self.n_layers * n_attn // cyc
            lr = self.n_layers * n_rec // cyc
            W = self.lru_width or D
            rec = D * W * 2 + W * D + 2 * W * W // 16 + 4 * W  # gates are diagonal-ish
            return emb + la * (attn + ffn) + lr * (rec + ffn)
        return emb + L * (attn + ffn)

    def active_param_count(self) -> float:
        if not self.moe:
            return self.param_count()
        D, L = self.d_model, self.n_layers
        fe = self.d_ff_expert
        act_ffn = (self.top_k + self.n_shared) * (D * 2 * fe + fe * D) + D * self.n_experts
        attn = (D * self.n_heads * self.head_dim
                + 2 * D * self.n_kv * self.head_dim
                + self.n_heads * self.head_dim * D)
        if self.mla:
            attn = (D * self.n_heads * (self.q_nope + self.q_rope)
                    + D * (self.kv_lora + self.q_rope)
                    + self.kv_lora * self.n_heads * (self.q_nope + self.v_head)
                    + self.n_heads * self.v_head * D)
        return self.vocab * D + L * (attn + act_ffn)
