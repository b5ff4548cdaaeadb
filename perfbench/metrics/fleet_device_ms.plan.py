"""fleet_device_ms.plan: device milliseconds a check, the work launched
under the harness's `simulate_fleet` spans over the checks in the window."""


def read(ctx):
    checks = ctx.counters.get("checks")
    seconds = ctx.trace.device_s_under("simulate_fleet")
    return 1e3 * seconds / checks if checks and seconds else None
