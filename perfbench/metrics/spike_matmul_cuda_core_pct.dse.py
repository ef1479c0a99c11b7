"""Share of ``spike_matmul``'s multiply-adds that ran on the CUDA cores, of
all its multiply-adds in the span window, as the kernel counts them on the
device by the route each tile took."""

from perfbench import spans

ROUTES = ("tensor", "planes", "cuda_cores")


def read(ctx):
    sw = spans.of(ctx)
    if sw is None:
        return None
    macs = {r: sw.counts.get(f"spike_matmul.macs.{r}") for r in ROUTES}
    if None in macs.values() or not sum(macs.values()):
        return None
    return 100.0 * macs["cuda_cores"] / sum(macs.values())
