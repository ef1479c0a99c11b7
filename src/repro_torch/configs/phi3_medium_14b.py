"""phi3-medium-14b [dense] -- RoPE SwiGLU GQA. [arXiv:2404.14219; unverified].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
"""

import dataclasses

from repro_torch.models.registry import Arch, register
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_head=128,
    d_ff=17920,
    vocab=100352,
    act="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    remat="block",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32, d_ff=256, vocab=512, remat="none"
)

register(
    Arch(
        name="phi3-medium-14b",
        family="dense",
        config=CONFIG,
        reduced_config=REDUCED,
        skip_shapes=("long_500k",),
        skip_reason="pure full-attention arch; 524k dense decode excluded per assignment",
    )
)
