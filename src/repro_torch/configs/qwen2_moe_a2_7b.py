"""qwen2-moe-a2.7b [moe] -- 4 shared + 60 routed experts, top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (GQA kv=16 = MHA) d_ff=1408 (per expert) vocab=151936,
MoE 60e top-4 with 4 always-on shared experts.
"""

import dataclasses

from repro_torch.models.mlp import MoEConfig
from repro_torch.models.registry import Arch, register
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab=151936,
    act="swiglu",
    qkv_bias=True,
    moe=MoEConfig(d_model=2048, d_ff_expert=1408, n_experts=60, top_k=4, n_shared=4),
    moe_period=1,
    tie_embeddings=False,
    remat="block",
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_head=32,
    d_ff=64,
    vocab=512,
    moe=MoEConfig(d_model=128, d_ff_expert=64, n_experts=8, top_k=2, n_shared=2, seq_chunk=64),
    remat="none",
)

register(
    Arch(
        name="qwen2-moe-a2.7b",
        family="moe",
        config=CONFIG,
        reduced_config=REDUCED,
        skip_shapes=("long_500k",),
        skip_reason="pure full-attention arch; 524k dense decode excluded per assignment",
    )
)
