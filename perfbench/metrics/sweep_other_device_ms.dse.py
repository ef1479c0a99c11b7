"""Device milliseconds a sweep outside the port's own kernels: PyTorch's
elementwise kernels, reductions and copies (the ATA-F phase-B step loop)."""

OWN = ("spike_matmul_kernel", "lif_scan_kernel", "sparse_accum_kernel")


def read(ctx):
    tr = ctx.trace
    own = sum(tr.time_of(k)[0] for k in OWN)
    return 1e3 * (tr.busy_s - own) / tr.window.calls
