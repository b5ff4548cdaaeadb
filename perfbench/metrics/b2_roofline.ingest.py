"""b2_roofline.ingest: kernel B2's bytes, (n - k) k + k B L + (n - k) B L a
step from the (n - k, k) x (k, B L) parity product of the B block groups the
harness hands over, at the card's peak HBM rate, over the device time of the
kernels named `gf256_matmul_kernel` (no other GF(256) product runs in a
write window), in percent."""
from perfbench.harness import roofline


def read(ctx):
    seconds, launches = ctx.trace.kernel_s("gf256_matmul_kernel")
    return roofline.share(ctx.counters.get("b2_bytes"), seconds, ctx.device_kind) \
        if launches else None
