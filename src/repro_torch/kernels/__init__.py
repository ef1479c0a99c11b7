"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel (built from ``../csrc`` by :mod:`.build`) or
raises.  Each wrapper counts its kernel launches in a plain integer
attribute, ``<wrapper>.launches``; :func:`launch_counts` reads them all and
:func:`reset_launch_counts` sets them to 0.
"""

from __future__ import annotations

__all__ = ["wrappers", "launch_counts", "reset_launch_counts"]


def wrappers() -> dict:
    """Kernel name -> wrapper function, for every kernel of the port."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.lif_scan.lif_scan import ataf_scan, lif_scan
    from repro_torch.kernels.quant_matmul.quant_matmul import quant_matmul
    from repro_torch.kernels.quant_matmul.spike_matmul import spike_matmul
    from repro_torch.kernels.sparse_accum.sparse_accum import sparse_accum

    return {
        "spike_matmul": spike_matmul,
        "lif_scan": lif_scan,
        "ataf_scan": ataf_scan,
        "sparse_accum": sparse_accum,
        "quant_matmul": quant_matmul,
        "flash_attention": flash_attention,
    }


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0
