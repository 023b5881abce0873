"""mamba2-370m [ssm]: 48L d=1024 attn-free, ssm_state=128 (SSD).
long_500k RUNS: O(1) recurrent decode state."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2_370m", family="ssm", n_layers=48, d_model=1024,
    n_heads=0, n_kv=0, head_dim=0, d_ff=0, vocab=50280,
    ssm_state=128, ssm_headdim=64, expand=2, d_conv=4, ssm_chunk=256,
    skip_long=False)
