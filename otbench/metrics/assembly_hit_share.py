"""Share of the profiled problem's assembly lookups that found the mesh's
operators kept from an earlier call: its change in the program's counters
`assembly.hits` over `assembly.hits + assembly.misses`
(`dots_socp_torch/solver/problem.py::build_problem`), as the program's
tracer took them over the problem. A hit builds and moves nothing; a miss
pays the whole assembly. None where the program keeps no such counters."""

from otbench.program_spans import profiled_problem

UNIT, BETTER, SOURCE = "%", "higher", "program_counter"
LAYER, MOVES = "problem assembly and recovery", "solve_s"


def read(rec):
    problem = profiled_problem(rec)
    if problem is None:
        return None
    counters = problem["counters"]
    if "assembly.hits" not in counters:
        return None
    lookups = counters["assembly.hits"] + counters["assembly.misses"]
    if lookups == 0:
        return None
    return 100.0 * counters["assembly.hits"] / lookups
