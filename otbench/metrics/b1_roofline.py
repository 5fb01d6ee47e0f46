"""Kernel B1's share of its roofline over the profiled problem, in %: the
least time the card could take for the matvecs the solve needed (one per
live inner CG iteration and one per CG pass's start, from
`CG_COUNTERS`), each moving `reference.bounds.matvec_work`'s bytes at the
peak rate, over B1's device time (`kernels/b1.json`). The latched blocks'
no-op iterations launch B1 too; they are work the solve did not need and
lower the share. Bound by bytes, at 3.35 TB/s (H100 SXM, 700 W)."""

from otbench.reference import bounds

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernel B1", "solve_s"


def read(rec):
    prof = rec["profile"]
    if prof is None or prof["layers"]["b1"]["seconds"] <= 0:
        return None
    r = prof["record"]
    starts = r["cg.window_matvecs"] - r["cg.fused_steps"]
    needed = r["cg.iterations"] + starts
    if needed <= 0:
        return None
    least, _ = bounds.least_seconds(bounds.matvec_work(**rec["work"]["matvec"]))
    return 100.0 * needed * least / prof["layers"]["b1"]["seconds"]
