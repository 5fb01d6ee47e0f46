"""Share of the profiled problem's iALM iterations whose step after the phi
solve ran kernel K6, in %: its change in the program's counter
`step.fused_steps` over the problem's iterations, as the program's tracer
took them over the problem (`dots_socp_torch/solver/step.py::FUSED_STEPS`).
Under 100, some iterations took the torch route. None where the program
keeps no such counter."""

from otbench.program_spans import profiled_problem

UNIT, BETTER, SOURCE = "%", "higher", "program_counter"
LAYER, MOVES = "kernel K6", "solve_s"


def read(rec):
    problem = profiled_problem(rec)
    if problem is None:
        return None
    steps = problem["counters"].get("step.fused_steps")
    iterations = problem["spans"][0]["attrs"].get("iterations")
    if steps is None or not iterations:
        return None
    return 100.0 * steps / iterations
