"""phi3.5-moe-42b-a6.6b [moe]: 32L d=4096 32H GQA kv=8 d_ff=6400,
16 experts top-2, V=32064.  long_500k SKIPPED: full attention."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi35_moe", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv=8, head_dim=128, d_ff=6400, vocab=32064,
    act="silu", glu=True, rope_theta=1e4, window_pattern=(None,),
    moe=True, n_experts=16, top_k=2, n_shared=0, d_ff_expert=6400,
    skip_long=True)
