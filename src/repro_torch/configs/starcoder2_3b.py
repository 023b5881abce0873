"""starcoder2-3b [dense]: 30L d=3072 24H GQA kv=2 d_ff=12288 V=49152 (RoPE).
long_500k SKIPPED: pure full attention."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2_3b", family="dense", n_layers=30, d_model=3072,
    n_heads=24, n_kv=2, head_dim=128, d_ff=12288, vocab=49152,
    act="gelu", glu=False, rope_theta=1e5, window_pattern=(None,),
    skip_long=True, note="GQA kv=2; non-GLU gelu FFN")
