"""dispatch_ms.read: host milliseconds a batch spends in dispatch, from the
call to `dispatch_masks` to its read sets being on the host (the harness's
`dispatch` spans, host clock), averaged over the window's batches."""


def read(ctx):
    spans = ctx.spans.durations.get("dispatch", [])
    return 1e3 * sum(spans) / len(spans) if spans else None
