"""qwen2-vl-2b [vlm] -- M-RoPE, dynamic resolution. [arXiv:2409.12191; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
The vision frontend is a STUB: ``input_specs`` provides precomputed patch
embeddings [B, n_vis, d_model]; the backbone applies M-RoPE with 3-component
(t, h, w) position ids.
"""

import dataclasses

from repro_torch.models.registry import Arch, register
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_head=128,
    d_ff=8960,
    vocab=151936,
    act="swiglu",
    rope_theta=1_000_000.0,
    mrope=True,
    mrope_sections=(16, 24, 24),
    qkv_bias=True,
    tie_embeddings=True,
    remat="block",
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,
    d_ff=256,
    vocab=512,
    mrope_sections=(4, 6, 6),
    remat="none",
)

register(
    Arch(
        name="qwen2-vl-2b",
        family="vlm",
        config=CONFIG,
        reduced_config=REDUCED,
        n_vision_tokens=256,  # frontend stub: 256 patch embeddings per sample
        skip_shapes=("long_500k",),
        skip_reason="pure full-attention arch; 524k dense decode excluded per assignment",
    )
)
