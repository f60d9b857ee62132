"""The median latency of the window's calls, call to result in host memory."""

import statistics


def read(ctx):
    lat = ctx["latencies_s"]
    return 1e3 * statistics.median(lat) if lat else None
