"""iALM iterations per second of the loop: every iteration of the window's
problems over the sum of their `history.running_time` (the loop from its
first segment to the final KKT read, CUDA graph captures included)."""

UNIT, BETTER, SOURCE = "it/s", "higher", "program_span"
LAYER, MOVES = "iALM loop", "solve_s"


def read(rec):
    probs = rec["problems"]
    loop = sum(p["running_time"] for p in probs)
    return sum(p["iterations"] for p in probs) / loop if loop > 0 else None
