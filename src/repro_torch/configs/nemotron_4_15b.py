"""nemotron-4-15b [dense] -- GQA, squared-ReLU MLP. [arXiv:2402.16819; unverified].

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
Squared-ReLU produces >=50% activation zeros -- noted in DESIGN.md as the
dense-transformer analogue of event sparsity (not exploited on the MXU).
"""

import dataclasses

from repro_torch.models.registry import Arch, register
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab=256000,
    act="sqrelu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    remat="block",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32, d_ff=256, vocab=512, remat="none"
)

register(
    Arch(
        name="nemotron-4-15b",
        family="dense",
        config=CONFIG,
        reduced_config=REDUCED,
        skip_shapes=("long_500k",),
        skip_reason="pure full-attention arch; 524k dense decode excluded per assignment",
    )
)
