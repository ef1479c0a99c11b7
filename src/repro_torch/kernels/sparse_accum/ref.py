"""Plain PyTorch version of the fixed-capacity sparse accumulate.

The contract the ``sparse_accum`` CUDA kernel is held to: given a
fixed-capacity AER event list -- per output row, ``K`` (value, source
channel) slots, zero-valued slots being padding -- accumulate the selected
quantized weight rows into an exact int32 current vector:

    out[e] = sum_j vals[e, j] * w_q[idx[e, j]]

int32 addition is associative mod 2**32, so any accumulation order gives
bit-identical results, including on wraparound.
"""

from __future__ import annotations

import torch


def sparse_accum_ref(vals: torch.Tensor, idx: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 event-list accumulation: a gather, a multiply and a sum.

    ``vals`` int [E, K] per-slot spike values (0 = padding); ``idx`` int
    [E, K] per-slot source channel; ``w_q`` int [n_in, N].  Returns int32
    [E, N].
    """
    rows = w_q.to(torch.int32)[idx.long()]  # [E, K, N]
    return (vals.to(torch.int32)[..., None] * rows).sum(dim=1, dtype=torch.int32)
