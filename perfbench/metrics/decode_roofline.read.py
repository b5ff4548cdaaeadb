"""decode_roofline.read: the bytes the reads' decodes need (k chunk rows
read and k data rows written a read) at the card's peak HBM rate, over the
device time of the work launched under the harness's `decode_requests`
spans, in percent."""
from perfbench.harness import roofline


def read(ctx):
    return roofline.share(ctx.counters.get("decode_bytes"),
                          ctx.trace.device_s_under("decode_requests"), ctx.device_kind)
