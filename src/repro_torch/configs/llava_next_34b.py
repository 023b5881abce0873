"""llava-next-34b [vlm]: 60L d=7168 56H GQA kv=8 d_ff=20480 V=64000 backbone;
anyres tiling STUB: input_specs provides 2880 precomputed patch embeddings
(5 tiles x 576, CLIP-ViT-L grid) of dim 1024.  long_500k SKIPPED."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava_next_34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv=8, head_dim=128, d_ff=20480, vocab=64000,
    act="silu", glu=True, rope_theta=5e6, window_pattern=(None,),
    n_patches=2880, patch_dim=1024, skip_long=True,
    note="modality frontend stubbed per assignment")
