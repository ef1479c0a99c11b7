"""stablelm-1.6b [dense] -- partial rotary (25%), MHA.
[hf:stabilityai/stablelm-2-1_6b; unverified].

24L d_model=2048 32H (GQA kv=32 = MHA) d_ff=5632 vocab=100352.
"""

import dataclasses

from repro_torch.models.registry import Arch, register
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=5632,
    vocab=100352,
    act="swiglu",
    rope_theta=10_000.0,
    rope_frac=0.25,
    tie_embeddings=False,
    remat="block",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_head=32, d_ff=256, vocab=512, remat="none"
)

register(
    Arch(
        name="stablelm-1.6b",
        family="dense",
        config=CONFIG,
        reduced_config=REDUCED,
        skip_shapes=("long_500k",),
        skip_reason="pure full-attention arch; 524k dense decode excluded per assignment",
    )
)
