"""Share of the profiled problem's live inner CG iterations that ran through
kernel K4-f64, in %: its change in the program's counter
`cg.f64_fused_steps` over `cg.iterations`, as the program's tracer took them
over the problem (`dots_socp_torch/ops/laplacian.py::CG_COUNTERS`). Under
100, some inner iterations of a float64 solve fell back to the torch route.
None where the program keeps no such counter, or ran no inner CG iteration
(the spectral path)."""

from otbench.program_spans import profiled_problem

UNIT, BETTER, SOURCE = "%", "higher", "program_counter"
LAYER, MOVES = "phi solve, CG", "solve_s"


def read(rec):
    problem = profiled_problem(rec)
    if problem is None:
        return None
    counters = problem["counters"]
    if "cg.f64_fused_steps" not in counters or not counters.get("cg.iterations"):
        return None
    return 100.0 * counters["cg.f64_fused_steps"] / counters["cg.iterations"]
