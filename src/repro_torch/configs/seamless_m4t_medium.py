"""seamless-m4t-medium [audio]: 12L enc + 12L dec, d=1024 16H kv=16
d_ff=4096 V=256206; audio frontend STUB (precomputed frame embeddings,
dim 160).  long_500k SKIPPED (full attention)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless_m4t_medium", family="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv=16, head_dim=64, d_ff=4096, vocab=256206,
    act="relu", glu=False, rope_theta=1e4, window_pattern=(None,),
    enc_layers=12, dec_layers=12, src_frames=4096, frame_dim=160,
    skip_long=True)
