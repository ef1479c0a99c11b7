"""gemma2-27b [dense] -- local/global alternating attention, logit softcaps.
[arXiv:2408.00118; hf].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000; sliding window 4096
on local (even) layers, attn softcap 50, final-logit softcap 30, sandwich
norms, sqrt(d) embedding scale, tied embeddings.
"""

import dataclasses

from repro_torch.models.registry import Arch, register
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=36864,
    vocab=256000,
    act="swiglu",  # gemma2 uses GeGLU; gate structure is identical
    rope_theta=10_000.0,
    window=4096,
    local_global_period=2,
    attn_softcap=50.0,
    logit_softcap=30.0,
    sandwich_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    remat="block",
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,
    d_ff=256,
    vocab=512,
    window=64,
    remat="none",
)

register(
    Arch(
        name="gemma2-27b",
        family="dense",
        config=CONFIG,
        reduced_config=REDUCED,
        skip_shapes=("long_500k",),
        skip_reason="global (full-attention) layers every other block; 524k dense decode excluded per assignment",
    )
)
