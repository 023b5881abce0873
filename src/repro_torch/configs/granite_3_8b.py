"""granite-3-8b [dense]: 40L d=4096 32H GQA kv=8 d_ff=12800 V=49155.
long_500k SKIPPED: pure full attention."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite_3_8b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv=8, head_dim=128, d_ff=12800, vocab=49155,
    act="silu", glu=True, rope_theta=1e4, window_pattern=(None,),
    skip_long=True)
