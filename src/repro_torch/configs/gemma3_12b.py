"""gemma3-12b [dense]: 48L d=3840 16H GQA kv=8 d_ff=15360 V=262144,
5:1 local:global (window 1024), 128k rope.  long_500k RUNS: 40/48 layers are
window-1024 local; 8 global layers decode O(seq)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3_12b", family="dense", n_layers=48, d_model=3840,
    n_heads=16, n_kv=8, head_dim=256, d_ff=15360, vocab=262144,
    act="gelu", glu=True, rope_theta=1e6,
    window_pattern=(1024, 1024, 1024, 1024, 1024, None),
    skip_long=False,
    note="5 local : 1 global; ring KV caches for local layers")
