"""Share of the ATA-T recurrence's ``spike_matmul`` multiply-adds that ran on
the CUDA cores (recurrent weights beyond int8), of all of them in the span
window, as the kernel counts them on the device by the route each tile took
(``spike_matmul.rec_macs``)."""

from perfbench import spans

ROUTES = ("tensor", "planes", "cuda_cores")


def read(ctx):
    sw = spans.of(ctx)
    if sw is None:
        return None
    macs = {r: sw.counts.get(f"spike_matmul.rec_macs.{r}") for r in ROUTES}
    if None in macs.values() or not sum(macs.values()):
        return None
    return 100.0 * macs["cuda_cores"] / sum(macs.values())
