"""The device's idle share of the profiled problem, in %: 1 - (the union of
its kernels' and copies' intervals) / (the host's span around the
`solver()` call). A session that recorded no device event is dropped
before this reads it, never read as idle."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "device", "solve_s"


def read(rec):
    prof = rec["profile"]
    if prof is None or prof["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
