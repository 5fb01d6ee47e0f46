"""Host calls that launch device work (cudaLaunchKernel, cudaLaunchKernelExC,
cuLaunchKernel: one per eager kernel; cudaGraphLaunch: one per replay) per
iALM iteration of the profiled problem, assembly and recovery included."""

UNIT, BETTER, SOURCE = "calls/it", "lower", "device_trace"
LAYER, MOVES = "CUDA graphs", "solve_s"


def read(rec):
    prof = rec["profile"]
    if prof is None:
        return None
    return prof["launch_calls"] / prof["record"]["iterations"]
