"""granite-moe-1b-a400m [moe] -- 32 experts, top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

24L d_model=1024 16H (GQA kv=8) d_ff=512 (per expert) vocab=49155, MoE 32e
top-8.  Vocab padded 49155 -> 49408 (multiple of 256) for clean TP sharding;
documented here and in DESIGN.md.
"""

import dataclasses

from repro_torch.models.mlp import MoEConfig
from repro_torch.models.registry import Arch, register
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,  # informational; all FF layers are MoE
    vocab=49408,  # 49155 padded to a multiple of 256
    act="swiglu",
    moe=MoEConfig(d_model=1024, d_ff_expert=512, n_experts=32, top_k=8),
    moe_period=1,
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
    d_ff=64,
    vocab=512,
    moe=MoEConfig(d_model=128, d_ff_expert=64, n_experts=8, top_k=4, seq_chunk=64),
    remat="none",
)

register(
    Arch(
        name="granite-moe-1b-a400m",
        family="moe",
        config=CONFIG,
        reduced_config=REDUCED,
        skip_shapes=("long_500k",),
        skip_reason="pure full-attention arch; 524k dense decode excluded per assignment",
    )
)
