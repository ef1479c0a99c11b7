"""PyTorch/CUDA port of the Flexi-NeurA simulator and serving stack.

Mirrors the module layout and public names of the JAX package ``repro``:
``core/`` (fixed-point numerics, the bit-exact layer datapath, backends,
network), ``kernels/`` (hand-written Hopper CUDA kernels, each beside its
plain PyTorch version), ``data/``, ``snn/`` and ``serve/``.  It imports
``torch``, ``numpy`` and ``scipy`` only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
functions that take tensors follow their inputs' device.  Rasters are
``[T, batch, n_in]``, weights ``[n_in, n_out]``, and the integer datapath is
int32 throughout, exactly as in ``repro``.
"""

from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
