"""95th percentile of the latencies of every solve in the window."""

from benchmark.harness.window import percentile


def read(run):
    lat = run.window.latencies()
    return 1e3 * percentile(lat, 95) if lat else None
