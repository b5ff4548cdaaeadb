"""The harness: cell resolution, the three general drivers (`reads`,
`writes`, `checks`), spans, the trace reduction, the roofline arithmetic and
the result line."""
