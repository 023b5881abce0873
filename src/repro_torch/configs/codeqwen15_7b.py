"""codeqwen1.5-7b [dense]: 32L d=4096 32H GQA kv=32 (=MHA) d_ff=13440
V=92416. long_500k SKIPPED: pure full attention."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen15_7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv=32, head_dim=128, d_ff=13440, vocab=92416,
    act="silu", glu=True, rope_theta=1e6, window_pattern=(None,),
    skip_long=True)
