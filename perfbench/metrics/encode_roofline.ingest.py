"""encode_roofline.ingest: the bytes the writes' encodes need (k data rows
read and n coded rows written a block group) at the card's peak HBM rate,
over the device time of the work launched under the harness's
`encode_batch` spans, in percent."""
from perfbench.harness import roofline


def read(ctx):
    return roofline.share(ctx.counters.get("encode_bytes"),
                          ctx.trace.device_s_under("encode_batch"), ctx.device_kind)
