"""mamba2-780m [ssm] -- SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified].

48L d_model=1536 (attn-free) d_ff=0 vocab=50280, ssm_state=128.
Vocab padded 50280 -> 50432 (multiple of 256) for clean TP sharding.
The SSD per-step decay ``exp(dt*A)`` is where Flexi-NeurA's CG leak-precision
knob applies at LM scale (``SSMConfig.decay_quant_bits``); long_500k runs
here -- decode state is O(1) in context length.
"""

import dataclasses

from repro_torch.models.mamba2 import SSMConfig
from repro_torch.models.registry import Arch, register
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_head=1,
    d_ff=0,  # no MLP: the SSD mixer is the whole block
    vocab=50432,  # 50280 padded to a multiple of 256
    attn_period=-1,
    ssm=SSMConfig(d_model=1536, d_state=128, d_conv=4, expand=2, head_dim=64),
    tie_embeddings=True,
    remat="block",
)

REDUCED = dataclasses.replace(
    CONFIG,
    n_layers=4,
    d_model=128,
    vocab=512,
    ssm=SSMConfig(d_model=128, d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32),
    remat="none",
)

register(
    Arch(
        name="mamba2-780m",
        family="ssm",
        config=CONFIG,
        reduced_config=REDUCED,
        # all four shapes run, including long_500k (O(1) decode state)
    )
)
