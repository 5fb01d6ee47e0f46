"""The replays' occupancy of the stream over the profiled problem's iALM
loop, in %: the seconds of every CUDA graph replay on the device's stream
(the program's `run` spans, each from a CUDA event recorded before the
graph's launch to one recorded after it, `dots_socp_torch.utils.trace`)
over the host seconds of its `loop` span. It is not the device's busy
time: a replay's interval holds its launch latency where the stream was
empty, and the gaps between the graph's own kernels, so a gap inside a
graph does not show here (the profiler's `idle_share` sees it). The
replays of one stream run one after another, so the share stays at or
below 100. None where no replay was timed (no graphs)."""

from otbench.program_spans import profiled_problem, replays

UNIT, BETTER, SOURCE = "%", "higher", "program_span"
LAYER, MOVES = "CUDA graphs", "solve_s"


def read(rec):
    problem = profiled_problem(rec)
    if problem is None or "loop" not in problem["totals"]:
        return None
    timed, loop = replays(problem), problem["totals"]["loop"]["host_s"]
    return 100.0 * sum(timed) / loop if timed and loop > 0 else None
