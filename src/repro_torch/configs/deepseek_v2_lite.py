"""deepseek-v2-lite-16b [moe]: 27L d=2048 16H MLA kv_lora=512, 64 routed
top-6 + 2 shared experts, d_ff_expert=1408, V=102400; layer 0 dense FFN
(d_ff=10944).  Assignment line says both '64e top-6' and '160 routed'; we
follow the published DeepSeek-V2-Lite (64 routed + 2 shared).
long_500k SKIPPED: MLA is still full attention (latent cache noted)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek_v2_lite", family="moe", n_layers=27, d_model=2048,
    n_heads=16, n_kv=16, head_dim=192, d_ff=10944, vocab=102400,
    act="silu", glu=True, rope_theta=1e4, window_pattern=(None,),
    dense_head_layers=1,
    moe=True, n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
    mla=True, kv_lora=512, q_nope=128, q_rope=64, v_head=128,
    skip_long=True)
