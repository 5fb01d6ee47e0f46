"""Host reads of device values per iALM iteration of the profiled problem:
its change in `ops.graphs.HOST_READS` (the adaptive segment's flags and
records) plus `CG_COUNTERS.flag_reads` (the CG loops' flags), as the
program's tracer took them over the problem (`dots_socp_torch.utils.trace`),
over its iterations. Each read waits for the device."""

from otbench.program_spans import profiled_problem

UNIT, BETTER, SOURCE = "reads/it", "lower", "program_counter"
LAYER, MOVES = "iALM loop", "solve_s"


def read(rec):
    problem = profiled_problem(rec)
    if problem is None:
        return None
    counters = problem["counters"]
    if "graphs.host_reads" not in counters:
        return None
    reads = counters["graphs.host_reads"] + counters.get("cg.flag_reads", 0)
    return reads / problem["spans"][0]["attrs"]["iterations"]
