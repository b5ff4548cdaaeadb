"""b3_roofline.read: kernel B3's bytes, B (k k + 2 k L) a launch from the
(B, k, k) x (B, k, L) products the harness's reads hand over, at the card's
peak HBM rate, over the device time of the kernels named
`gf256_matmul_kernel` (no other GF(256) product runs in a read window), in
percent."""
from perfbench.harness import roofline


def read(ctx):
    seconds, launches = ctx.trace.kernel_s("gf256_matmul_kernel")
    return roofline.share(ctx.counters.get("b3_bytes"), seconds, ctx.device_kind) \
        if launches else None
