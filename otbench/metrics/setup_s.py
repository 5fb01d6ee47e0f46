"""Seconds from the start of the process to the window's opening: imports,
the CUDA context, the kernel library, the mesh, the factor caches and the
warm-up solve."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(rec):
    return rec["setup_s"]
