"""jamba-v0.1-52b [hybrid] -- Mamba+attention 1:7 interleave with MoE.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
[arXiv:2403.19887; hf].  Attention every 8th layer, MoE every 2nd layer
(the published Jamba layout); the SSM mixer here is our SSD (Mamba-2 style)
block -- a documented adaptation (DESIGN.md: the paper's Mamba-1 scan and the
SSD formulation share the leaky-integrator decay that Flexi-NeurA's CG
quantizes).
"""

import dataclasses

from repro_torch.models.mamba2 import SSMConfig
from repro_torch.models.mlp import MoEConfig
from repro_torch.models.registry import Arch, register
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=65536,
    act="swiglu",
    attn_period=8,
    moe=MoEConfig(d_model=4096, d_ff_expert=14336, n_experts=16, top_k=2),
    moe_period=2,
    ssm=SSMConfig(d_model=4096, d_state=128, d_conv=4, expand=2, head_dim=64),
    tie_embeddings=False,
    remat="block",
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=8,  # one full pattern group (1 attn + 7 mamba, MoE on evens)
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,
    d_ff=256,
    vocab=512,
    moe=MoEConfig(d_model=128, d_ff_expert=256, n_experts=4, top_k=2, seq_chunk=64),
    ssm=SSMConfig(d_model=128, d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32),
    remat="none",
)

register(
    Arch(
        name="jamba-v0.1-52b",
        family="hybrid",
        config=CONFIG,
        reduced_config=REDUCED,
        # hybrid: long_500k RUNS (SSM layers O(1); the 4 attention layers use
        # the sequence-sharded KV decode path).
    )
)
