"""The program's own spans of the profiled problem: the last problem that
`dots_socp_torch.utils.trace` kept, which is the one the harness solved
under torch.profiler (the program traces any call that begins while a
profiler records). Readers of `metrics/` that read spans find it here."""

from __future__ import annotations


def profiled_problem(rec):
    """The traced problem of the record's profiled one, or None: no
    profile, a program without the tracer, or a traced problem of another
    iteration count (then not the one profiled)."""
    prof = rec.get("profile")
    if prof is None:
        return None
    try:
        from dots_socp_torch.utils import trace
    except ImportError:
        return None
    problem = trace.last_problem()
    if problem is None:
        return None
    if problem["spans"][0]["attrs"].get("iterations") != prof["record"]["iterations"]:
        return None
    return problem


def replays(problem, segment=None):
    """The device seconds of every `run` span that measured some (the CUDA
    graph replays), of one `segment` or all."""
    return [s["device_s"] for s in problem["spans"]
            if s["name"] == "run" and s["device_s"] is not None
            and (segment is None or s["attrs"].get("segment") == segment)]
