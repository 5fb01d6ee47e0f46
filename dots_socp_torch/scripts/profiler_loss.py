"""How often torch.profiler records none, or only some, of a session's
kernels on the card, and what in the process brings it on.

    python -m dots_socp_torch.scripts.profiler_loss [--sessions 300] [--graphs 40]

Each session profiles CALLS launches of one small elementwise kernel and
counts the device events it recorded, in alternation with the CUDA activity
alone (as the card tests profile) and with CPU and CUDA (as
`kernel_timing.device_ms` does). `--graphs N` first captures and replays N
small CUDA graphs and keeps them, as the solver's graphed loops do, and
replays one of them before every session. Kineto reads its switches from
the environment (TEARDOWN_CUPTI: tear CUPTI down after every session,
Kineto's default where it is unset or "1"; DISABLE_CUPTI_LAZY_REINIT); the
port sets TEARDOWN_CUPTI to "0" where the caller left it unset, so Kineto's
default is read with `TEARDOWN_CUPTI=1`. The line names what this process
ran with. One JSON line: per activity set the sessions, the empty ones (no
device event) and the partial ones (fewer than CALLS).
"""

from __future__ import annotations

import argparse
import json
import os

import torch

CALLS = 5
KNOBS = ("TEARDOWN_CUPTI", "DISABLE_CUPTI_LAZY_REINIT")


def _graphs(n, x):
    """`n` captured and replayed graphs of a small elementwise chain on `x`."""
    kept = []
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        (x * 2 + 1).sum()  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(n):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = (x * 2 + 1).sum()
        graph.replay()
        kept.append((graph, y))
    torch.cuda.synchronize()
    return kept


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=300)
    ap.add_argument("--graphs", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_loss needs an NVIDIA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    kept = _graphs(args.graphs, x) if args.graphs else []
    sets = {"cuda": [ProfilerActivity.CUDA],
            "cpu_cuda": [ProfilerActivity.CPU, ProfilerActivity.CUDA]}
    tally = {name: {"sessions": 0, "empty": 0, "partial": 0, "first_empty": None} for name in sets}
    for i in range(args.sessions):
        name = list(sets)[i % 2]
        if kept:
            kept[i % len(kept)][0].replay()
        torch.cuda.synchronize()
        with profile(activities=sets[name]) as prof:
            for _ in range(CALLS):
                x.add_(1.0)
            torch.cuda.synchronize()
        seen = sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CUDA and "elementwise" in e.name.lower())
        t = tally[name]
        t["sessions"] += 1
        if seen == 0:
            t["empty"] += 1
            t["first_empty"] = i if t["first_empty"] is None else t["first_empty"]
        elif seen < CALLS:
            t["partial"] += 1
    out = {"metric": f"torch.profiler sessions of {CALLS} kernel launches that recorded none "
                     f"or some of them", "graphs": args.graphs, "torch": torch.__version__,
           "cuda": torch.version.cuda, "env": {k: os.environ.get(k) for k in KNOBS},
           "by_activities": tally}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
