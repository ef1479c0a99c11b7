"""Public entry points for the fixed-capacity sparse event path.

``fixed_capacity_events`` is the AER encoder: it compacts a spike raster into
the static-budget event list the kernel consumes.  ``sparse_accum_currents``
is the window-level integration op the event backend and the serving lane
window call.  It treats the CUDA kernel as the card's path (as the JAX
version treats the Pallas kernel as the TPU's) and, on the CPU, carries the
identical int32 numerics through the budget-certified f32 GEMM (or the exact
int32 product when the certificate fails).

Budget semantics: the budget is a capacity contract -- callers size it at or
above the measured max per-row active-channel count.  For a sufficient
budget every lowering is bit-identical to the dense product.  For an
insufficient budget the event-list path deterministically keeps each row's
``budget`` largest values (ties to the lower channel, ``jax.lax.top_k``
order) and drops the rest.
"""

from __future__ import annotations

import torch

from repro_torch.core.fixed_point import exact_f32_matmul
from repro_torch.kernels.quant_matmul.spike_matmul import spike_matmul
from repro_torch.kernels.sparse_accum.sparse_accum import sparse_accum

__all__ = ["fixed_capacity_events", "sparse_accum_currents"]


def fixed_capacity_events(raster: torch.Tensor, budget: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact a spike raster into a fixed-capacity AER event list.

    ``raster`` int [..., n_in] with nonnegative values.  Returns ``(vals,
    idx)`` int32 [..., budget]: per row the ``budget`` largest values in
    descending order, ties broken toward the lower channel, padding slots
    holding value 0.  ``torch.topk`` orders ties differently from
    ``jax.lax.top_k``, so this is a stable descending sort cut to the budget,
    which keeps the same events as the JAX encoder in over-budget rows.
    """
    vals, idx = torch.sort(raster.to(torch.int32), dim=-1, descending=True, stable=True)
    return vals[..., :budget].contiguous(), idx[..., :budget].to(torch.int32).contiguous()


def sparse_accum_currents(
    raster: torch.Tensor,  # int [T, B, n_in] spike raster (nonnegative values)
    w_q: torch.Tensor,  # int32 [n_in, N] quantized weight table
    budget: int,
    *,
    f32_exact: bool = True,
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """Window FF currents [T, B, N] via the fixed-capacity event formulation.

    ``use_pallas`` (name kept from the JAX API) selects the event-list route
    through the ``sparse_accum`` kernel wrapper; ``None`` means "when the
    raster lies on the card".  Otherwise the certified f32 GEMM
    (``f32_exact=True`` asserts ``budget * max_value * int_max(w_bits) <
    2**24``) or the exact int32 product computes the identical result.
    """
    T, B, n_in = raster.shape
    N = w_q.shape[1]
    budget = min(budget, n_in)
    flat = raster.to(torch.int32).reshape(T * B, n_in).contiguous()
    if use_pallas is None:
        use_pallas = flat.device.type == "cuda"
    if use_pallas:
        vals, idx = fixed_capacity_events(flat, budget)
        out = sparse_accum(vals, idx, w_q.to(torch.int32).contiguous())
    elif f32_exact:
        out = exact_f32_matmul(flat, w_q)
    else:
        out = spike_matmul(flat, w_q.to(torch.int32).contiguous())
    return out.reshape(T, B, N)
