"""Reading one profiled problem from torch.profiler's events: the device's
busy time, kernel time by layer, the host's launch calls, and the longest
idle gaps with what the host was doing in them.

The events are read raw (`kineto_results.events()`): one n200 problem is
some 900,000 kernels, too many to build the profiler's event tree from.
"""

from __future__ import annotations

import re

import numpy as np

#: The harness's span around the profiled solver() call.
SPAN = "otbench.problem"
#: Host calls that launch device work (one per eager kernel, one per graph replay).
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cudaGraphLaunch")
TOP = 10


def _union(starts, ends):
    """Merged intervals (block starts, block ends) of [start, end) pairs."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.concatenate([[True], s[1:] > reach[:-1]])
    first = np.flatnonzero(new)
    last = np.concatenate([first[1:] - 1, [len(s) - 1]])
    return s[first], reach[last]


def read(prof, layers: dict) -> dict | None:
    """The numbers of one profiled problem, or None when the session
    recorded no device event (a lost session: dropped, never read as idle).
    `layers` maps a layer's name to the regular expression of its kernels."""
    from torch.autograd import DeviceType

    span = None
    dev_s, dev_e, dev_names = [], [], []
    host = []
    launch_calls = 0
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if name == SPAN or ev.is_user_annotation():
                continue
            dev_s.append(ev.start_ns())
            dev_e.append(ev.end_ns())
            dev_names.append(name)
        elif name == SPAN:
            span = (ev.start_ns(), ev.end_ns())
        else:
            if name in LAUNCH_CALLS:
                launch_calls += 1
            host.append((ev.start_ns(), ev.end_ns(), name))
    if not dev_s or span is None:
        return None
    lo, hi = span
    starts = np.clip(np.asarray(dev_s, dtype=np.int64), lo, hi)
    ends = np.clip(np.asarray(dev_e, dtype=np.int64), lo, hi)
    b_start, b_end = _union(starts, ends)
    busy_ns = int((b_end - b_start).sum())

    by_name = {}
    for name, s, e in zip(dev_names, starts, ends):
        tot = by_name.setdefault(name, [0, 0])
        tot[0] += int(e - s)
        tot[1] += 1
    layer_time = {}
    for layer, pattern in layers.items():
        rx = re.compile(pattern)
        hits = [v for n, v in by_name.items() if rx.search(n)]
        layer_time[layer] = {"seconds": sum(v[0] for v in hits) / 1e9,
                             "events": sum(v[1] for v in hits)}
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]

    gap_lo = np.concatenate([[lo], b_end])
    gap_hi = np.concatenate([b_start, [hi]])
    widest = np.argsort(gap_lo - gap_hi, kind="stable")[:TOP]
    replays = [s for s, _, n in host if n == "cudaGraphLaunch"]
    gaps = []
    for i in widest:
        g0, g1 = int(gap_lo[i]), int(gap_hi[i])
        if g1 <= g0:
            continue
        gaps.append([_label(g0, g1, host, replays), (g1 - g0) / 1e9])
    return {"wall_s": (hi - lo) / 1e9, "busy_s": busy_ns / 1e9, "launch_calls": launch_calls,
            "device_events": len(dev_s), "layers": layer_time,
            "device_ops": [[n[:120], v[0] / 1e9] for n, v in ops], "idle_gaps": gaps}


def _label(g0, g1, host, replays):
    """What the host was doing while the device idled in [g0, g1): where the
    gap lies in the solve (before the first graph replay, after the last, or
    between), and the host call that overlaps it most."""
    if not replays or g1 <= min(replays):
        phase = "before the first graph replay (assembly)"
    elif g0 >= max(replays):
        phase = "after the last graph replay (final KKT, recovery)"
    else:
        phase = "between graph replays"
    best, best_ns = None, 0
    for s, e, name in host:
        ns = min(e, g1) - max(s, g0)
        if ns > best_ns:
            best, best_ns = name, ns
    return f"{phase}: {best[:80] if best else 'untraced host code'}"
