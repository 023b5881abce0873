"""recurrentgemma-9b [hybrid]: 38L->36L d=4096 16H MQA kv=1 d_ff=12288
V=256000, RG-LRU + local attn 1:2 (pattern rec,rec,attn; window 2048).
NOTE: 38 layers do not tile the (rec,rec,attn) pattern; we use 36 (12 groups)
and record the deviation.  long_500k RUNS: recurrent state is O(1); attn
layers are window-2048 local."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma_9b", family="hybrid", n_layers=36, d_model=4096,
    n_heads=16, n_kv=1, head_dim=256, d_ff=12288, vocab=256000,
    act="gelu", glu=True, rope_theta=1e4,
    window_pattern=(2048,), block_pattern=("rec", "rec", "attn"),
    lru_width=4096, d_conv=4, skip_long=False)
