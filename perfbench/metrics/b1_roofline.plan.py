"""b1_roofline.plan: kernel B1's bytes, S N (8 + 5 m) + 16 S m a check of S
seeds of N reads on m nodes, at the card's peak HBM rate, over the device
time of the kernels named `fcfs_scan_kernel`, in percent."""
from perfbench.harness import roofline


def read(ctx):
    seconds, launches = ctx.trace.kernel_s("fcfs_scan_kernel")
    return roofline.share(ctx.counters.get("b1_bytes"), seconds, ctx.device_kind) \
        if launches else None
