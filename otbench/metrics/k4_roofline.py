"""Kernel K4's share of its roofline over the profiled problem, in %: the
least time the card could take for the inner CG iterations the solve
needed (the live ones, `CG_COUNTERS.iterations`), each moving
`reference.bounds.cg_update_work`'s bytes at the peak rate, over K4's device
time (`kernels/k4.json`, its five launches per iteration). The no-op
iterations of the latched blocks count as time, not as work. Bound by
bytes, at 3.35 TB/s (H100 SXM, 700 W)."""

from otbench.reference import bounds

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernel K4", "solve_s"


def read(rec):
    prof = rec["profile"]
    if prof is None or prof["layers"]["k4"]["seconds"] <= 0:
        return None
    needed = prof["record"]["cg.iterations"]
    if needed <= 0:
        return None
    least, _ = bounds.least_seconds(bounds.cg_update_work(**rec["work"]["cg_update"]))
    return 100.0 * needed * least / prof["layers"]["k4"]["seconds"]
