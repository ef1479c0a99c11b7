"""whisper-medium [audio] -- encoder-decoder, conv frontend stubbed.
[arXiv:2212.04356; unverified].

24L (24 enc + 24 dec) d_model=1024 16H (MHA) d_ff=4096 vocab=51865.
Vocab padded 51865 -> 51968 (multiple of 256).  Decoder context is the
family-native 448; decode_32k applies the 32k to the *encoder* context
(audio frames); long_500k skipped (full-attention encoder).
"""

import dataclasses

from repro_torch.models.registry import Arch, register
from repro_torch.models.whisper import WhisperConfig

CONFIG = WhisperConfig(
    name="whisper-medium",
    n_enc_layers=24,
    n_dec_layers=24,
    d_model=1024,
    n_heads=16,
    d_ff=4096,
    vocab=51968,  # 51865 padded to a multiple of 256
    dec_max_len=448,
)

REDUCED = dataclasses.replace(
    CONFIG, n_enc_layers=2, n_dec_layers=2, d_model=128, n_heads=4, d_ff=256, vocab=512, dec_max_len=32
)

register(
    Arch(
        name="whisper-medium",
        family="audio",
        config=CONFIG,
        reduced_config=REDUCED,
        skip_shapes=("long_500k",),
        skip_reason="full-attention encoder; decoder context capped at 448 by the family",
    )
)
