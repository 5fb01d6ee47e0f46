"""Smoke run of the PyTorch port (dots_socp_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

The checks that need a whole process or several, and every kernel against
its plain version at the main path's shapes (phase 23, through
`dots_socp_torch.kernel_checks`, whose checks tests/test_torch_cuda.py runs
case by case). A kernel's time is `python -m dots_socp_torch.bench_kernels`.
The numbers 3, 6, 19, 21 and 22 are not reused, so that earlier records
still name the phases they mean.
Phases, in order; each prints one JSON line, and a failing phase raises
(exit code != 0, no result line):

1. device   -- CUDA must be present; the card's name and power limit.
2. build    -- nvcc builds the kernels from the sources (B1 / B2, K4, K6,
               one nvcc per source, all started together).
4. slice    -- the main path: the port's CLI (`dots_socp_torch.cli.main`,
               which runs the port's `interface.run_dot_surface` with the
               port's solver) on plane n200, ntime 31, tol 1e-4, 100
               iterations, float32, on the card. Checks: the CG phi-solve
               with f64 refinement ran, every inner matvec launched the
               kernel, every inner iteration after it was K4's STAGES
               launches (`count_k4`: so in phases 8, 10, 12's unsharded
               run, 14, 15, 17 and 18 too; on a mesh, none), the KKT
               values are finite, the stop-set error at the
               last validation is at most half the first, the mass
               conservation error (RMS over time layers of total mass
               minus 1) is finite, and every iteration was K6's LAUNCHES
               launches (one more call at the capture's warm-up). Then the
               same 100 iterations in float64 (the CG without refinement):
               B1-f64's launches equal the window matvecs, K4-f64's are
               STAGES for each fused inner iteration, every inner iteration
               went through K4-f64, no float32 kernel launched, and K6 as
               in float32.
5. spectral -- the flagship problem (plane n64, V=4,810, ntime 31, float32,
               200 iterations) on the dense spectral path: finite KKT, and
               no TF32 on its GEMMs (the pins are set, and an f32 spectral
               solve on the card agrees with its f64 counterpart to 1e-4;
               TF32 would be ~1e-3 off).
7. sharded_slice -- the sharded main path: 2 ranks (spawned processes,
               torchrun's environment) run the port's CLI on plane n200,
               ntime 31, float32, --mesh_shape 1x2, 100 iterations; backend
               nccl with 2 or more cards, else gloo on the one card. Checks
               per rank: B2's launches equal its window matvecs and are > 0,
               finite KKT, the stop-set error at the last validation at most
               half the first, finite mass conservation error; and the KKT
               table at the end agrees with phase 4's within SLICE_KKT_RTOL.
               A rank that fails or outlives RANK_TIMEOUT fails the script.
8. resume   -- snapshot and resume on the main path's problem (plane n200,
               ntime 31, float32, CG + f64 refinement): the port's
               `scripts.solve_large` runs to nit=50 and writes its forced
               snapshot (and its cold CG histogram); the CLI, run as in
               phase 4 plus --snapshot with the same path, resumes to
               nit=100. Checks: the log's "Resuming
               from snapshot" line names iteration 49, the history goes on
               from 50 to 99, the 7 KKT values and the solution (density mu,
               momentum E and potential phi) agree with phase 4's
               uninterrupted 100 iterations within RESUME_RTOL, and
               B1's launches equal the window matvecs in both legs.
9. replication -- `replication.sweep` on ring (V=3,072) and hills (V=11,716,
               the largest surrogate) x congestions 0.00 and 0.01, ntime 31,
               tol 1e-3, a short --time_limit: two info.log, two pairs of
               tables, one row per run, the Converged column filled; then
               `replication.main_versus_exact` on plane n50, float64, tol
               1e-3: one error row per decade crossed, KKT decreasing across
               them, the final l2 error below 0.5.
10. profile -- the CLI with --profile_dir on plane n200, 12 iterations: the
               trace file exists, stays under PROFILE_MAX_BYTES (it stops
               after the interface's PROFILE_ITERATIONS), and names
               window_spmv_kernel among its CUDA kernel events.
11. sharded_spectral -- 2 ranks as in phase 7 on the flagship (plane n64,
               200 iterations, --mesh_shape 1x2, no --laplacian_mode): every
               rank took the spectral path (no CG solve), TF32 is pinned off
               in every rank, and the final KKT table agrees with phase 5's
               within SPECTRAL_KKT_RTOL.

12. time_sharded_slice -- the mesh's time axis on the main path's problem at
               ntime 32 (the nearest to 31 that a 2-way time axis divides):
               100 iterations of the CLI unsharded in this process, then on
               4 ranks with --mesh_shape 2x2 (2 time blocks of 16 slices x 2
               space shards; nccl with 4 or more cards, else gloo on the one
               card), then on 2 ranks with --mesh_shape 2x1 (B1 in each
               time-rank). Checks per rank: the window kernel's launches (B2
               on 2x2, B1 on 2x1) equal its window matvecs and are > 0,
               finite KKT, the stop-set error at the last validation at most
               half the first, the final KKT table within SLICE_KKT_RTOL of
               the unsharded run's, time collectives were made, and phi, which
               every time-rank holds whole and computes redundantly, is
               bit-equal on every rank (else the difference is printed and
               must stay within PHI_DRIFT_RTOL).
13. dryrun   -- `dots_socp_torch.dryrun.dryrun_multichip(4)`: a 2x2 mesh of
               4 spawned gloo ranks on the card runs the whole sharded step
               (z-scaling, iterations, KKT, sigma update, adaptive segment,
               50 iterations that halve the stop-set error, the refined CG
               path with B2) and makes its own asserts.
14. bench    -- the port's measurement drivers, each through its `main` in
               this process: the bench lane (`dots_socp_torch.bench`,
               --repeats 2 of 2000 flagship and 150 n200 iterations),
               `scripts.bench_large` (n200, 50 iterations),
               `scripts.profile_large` (n200, chains of 5, --cg_slope),
               `scripts.refine_cost_bench` (n200, chains of 10),
               `scripts.bench_matvec` (n200, 20 calls) and
               `scripts.steady_state_configs --configs smoke`. Checks: each
               driver's last line parses and is what it returned; every time
               in it is finite and > 0; the lane's B1 line carries its
               device time, bound and library call; bench_matvec's variants
               agree within KERNEL_TOL * max|y|; B1's launches in the phase
               equal the window matvecs of the CG solves plus the matvecs the
               drivers chained themselves; and neither jax nor the JAX
               package was imported.
15. wide_slice -- the JAX package's widest configuration (plane n200,
               ntime 127, float32, CG + f64 refinement: 128 modes, four mode
               groups per tile, B1's limit): 100 iterations of the CLI
               checked as in phase 4 (B1's launches equal the window
               matvecs); then
               `scripts.records` runs ring at congestion 0.00 to tol 1e-4
               (a row of the `make main` sweep) and its own comparison must
               find the row in agreement with the JAX package's record.
16. spectral_records -- the float32 dense spectral phi solve at the sweep's
               size: `scripts.spectral_floor` on knots_3, padded to 4,096
               vertices as the sweep pads it, where the card's error against
               the float64 solve, in the energy norm, must stay within
               SPECTRAL_ENERGY_RATIO of the host's on both kinds of
               right-hand side; then `scripts.records` runs the `make main`
               rows of SPECTRAL_ROWS to tol 1e-4 (the spectral path, from a
               fresh factor cache), and each must converge and be found in
               agreement with the JAX package's record.

17. graphs -- the device-resident loops: plane n200 (the CG path) and n64
               (the spectral flagship), ntime 31, 100 iterations each of the
               CLI with CUDA graphs (the default; phases 4 and 15 ran so
               too) and inside `graphs.eager()` (every op launched from the
               host, the CG's flag read every inner iteration), in this
               process: phi bit-equal between the two (else within
               GRAPH_PHI_RTOL), B1's launches counted through the replays
               equal to the CG's window matvecs; then, through
               `profile_slice` (n200, inner rtol 5e-4, a 10- against a
               50-iteration solve in each mode), the host's synchronisations
               per iteration at most GRAPH_SYNC_RATIO of the eager run's and
               its launch calls (cudaLaunchKernel and kin, cudaGraphLaunch)
               at most GRAPH_LAUNCH_CALL_RATIO.

18. adaptive -- the adaptive segment on the device (KKT validations, the
               cadence and sigma decisions in the `validate` segment, the
               state in the graph workspace for the whole segment): plane
               n64 (spectral) and n200 (CG) to tol 1e-4 as the bench lane's
               --converge runs them (fresh factor cache), with CUDA graphs
               and inside `graphs.eager()`: the same iteration counts and
               validation points in both, the counts ADAPTIVE_ITERATIONS
               (the bench lane's before the segment moved to the device),
               phi bit-equal (else within GRAPH_PHI_RTOL); then, through
               `profile_slice`, n64's last NEAR_ITERS iterations before
               convergence (validations at or near every iteration), where
               the host may make at most one synchronisation per validation
               (besides one per segment for its records) and at most
               ADAPTIVE_LAUNCH_CALLS launch calls per validation beyond the
               iterations' own replays, however many kernels the KKT table
               launches.

20. mesh_loops -- the JAX package's device-resident loops on a mesh (the
               CG's latched blocks, the iteration, table and adaptive
               segments over each rank's graph workspace): on a 1x2 mesh of
               spawned ranks every leg of MESH_LOOP_LEGS is solved through
               the port's `solver` inside `graphs.eager()` (the host loops)
               and then through the mesh loops. Over nccl (2 or more cards)
               every segment must be a capture's replay (`captured`, and
               the captures and their seconds per rank), over gloo (the one
               card) none (`captured: false`, every segment op by op; the
               phase within MESH_LOOPS_GLOO_SECONDS). Per rank and leg: phi
               bit-equal to eager's (else within GRAPH_PHI_RTOL) and to rank
               0's, the same iterations and validation points, B2's
               launches (counted through the replays) equal to the window
               matvecs on the n200 legs and none on n64's, no B1 or K4
               launch; host reads and collectives per iteration and it/s
               of both legs. Over nccl also, through one turn of
               `scripts.bench_sharded_cg --loops` in each mode (n200, inner
               rtol 5e-4, a 10- against a 50-iteration solve), host
               synchronisations per iteration at most
               MESH_SYNCS_MAX and launch calls at most MESH_LAUNCH_CALLS_MAX
               through the mesh loops, beside eager's, and B2's device µs
               per shard-call inside the solve. With four cards, the same
               legs' checks on 2x2 at ntime 32.

23. kernels -- every kernel wrapper against its plain version or torch
               route at the main path's shapes (`kernel_checks`): B1 and
               B1-f64 on plane n200's window (B1_CASES), B2 on its
               blocked shards (B2_CASES), K4 stage by stage on n200's
               settled inner state, K4-f64 latched against the float64 torch
               route over a solve, K6 on IALM_SETUPS x IALM_CASES; each
               B1 / B2 call one launch and nothing else (one kernel node in
               a captured graph). One line with each check's errors,
               launches and bound.

The sharded phases (7, 11, 12, 13) run through the same mesh loops, and
phases 7, 11 and 12 report per rank the backend, the card count and
whether the rank's segments were captured (over nccl they must be, over
gloo they must not).

Then the `nvidia-smi` name and power-limit line, and the result line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Only the port (`dots_socp_torch`) is imported here. The port keeps its own
copies of the host modules (geometry, data loading, interface), so neither
`jax` nor the JAX package `dots_socp_tpu` is imported, here or in the ranks
of phases 7, 11, 12, 13 and 20, or by the drivers of phase 14: the script checks
`sys.modules` and fails otherwise.

    python3 chip_smoke.py --phase time_sharded_slice

runs phases 1 and 2 and then the one phase named (12, 15, 16, 17, 18, 20 or 23; 7 and 11 after
phases 4 and 5, whose results they are held to) with its checks, and prints no result line:
phase 12 alone on a machine with four cards is the check of a `TxS` mesh over nccl, phases 7,
11 and 20 alone on two or more the check of the captured mesh loops.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import multiprocessing
import os
import re
import socket
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import dots_socp_torch.ops.cg_step as cg_step
import dots_socp_torch.ops.sharded_window as sharded_window
import dots_socp_torch.ops.window_spmv as window_spmv
import dots_socp_torch.ops.ialm_step as ialm_step
from dots_socp_torch import bench, cli, dryrun, interface, kernel_checks, profile_slice
from dots_socp_torch.kernel_timing import f64_launches, nvidia_smi_line, reset_counts
from dots_socp_torch.ops import _build, graphs
from dots_socp_torch.ops.collectives import COUNTS
from dots_socp_torch.ops.laplacian import CG_COUNTERS, SpectralFactor, spectral_solve
from dots_socp_torch.replication import log2table, main_versus_exact, sweep
from dots_socp_torch.scripts import (
    bench_large,
    bench_sharded_cg,
    bench_matvec,
    profile_large,
    records,
    refine_cost_bench,
    solve_large,
    spectral_floor,
    steady_state_configs,
)
from dots_socp_torch.solver import step
from dots_socp_torch.solver.problem import build_problem

N_TIME = 31
KERNEL_TOL = 1e-5  # max |diff| / max |y|: float32 sums in another order
TF32_TOL = 1e-4  # f32 vs f64 spectral solve; TF32 GEMMs give ~6e-4
STOP_SET = [0, 2, 4, 5]
SHARDS_SLICE = 2  # ranks of the sharded_slice phase (the main path)
RANK_TIMEOUT = 600  # seconds a rank of the sharded slice may take
# Largest relative difference allowed between the sharded slice's final KKT
# entries and phase 4's: the two f32 solves reduce in other orders (B1 vs
# B2 windows, per-shard partial sums), which moves their inexact CG solves.
# Measured 0.0119 on an H100 (gloo, one card); the bound leaves 4x room.
SLICE_KKT_RTOL = 0.05
# The resumed run against the uninterrupted one, largest relative difference
# of the KKT entries, mu, E and phi: the snapshot holds the state exactly and the
# host schedules and the inner CG tolerance are restored. Measured 0.0 (bit
# for bit) on an H100; the bound is float32 round-off, no more.
RESUME_RTOL = 1e-6
# The sharded spectral run against the single-device one (phase 5), final
# KKT entries: the shards' partial eigen-coefficients sum in another order
# than one GEMM, and 200 float32 iterations carry the difference. Measured
# 0.0032 on an H100 (gloo, one card); the bound leaves 4x room.
SPECTRAL_KKT_RTOL = 0.013
N_TIME_MESH = 32  # ntime of the time-sharded slice: 2 blocks of 16 slices
N_TIME_WIDE = 127  # ntime of phase 15: 128 modes, B1's limit
# (--mesh_shape, ranks, the count of the window kernel its ranks launch: B2 on
# space shards, B1 on one) of phase 12
TIME_MESHES = (("2x2", 4, "launches"), ("2x1", 2, "b1_launches"))
# phi is whole on every time-rank and each space group solves for it on its
# own: the largest relative difference between two ranks' phi that the phase
# accepts where they are not bit-equal (float32 round-off of one iteration).
PHI_DRIFT_RTOL = 1e-6
# Phase 16: the largest ratio of the card's float32 spectral solve error to
# the host BLAS's (one product over all of K), in the energy norm (the
# chained products on the card: 0.7-1.1x; one library GEMM over all of K on
# the card: 2.5-3.7x), and the sweep's rows (example, congestions) held to
# their records.
SPECTRAL_ENERGY_RATIO = 1.25
SPECTRAL_ROWS = (("knots_3", ("0.00", "0.01")), ("hills", ("0.00",)))
# Phase 17: phi of the graphed run against the eager one where they are not
# bit-equal (the same kernels on the same inputs, measured bit-equal on an
# H100), and the n200 host synchronisations and launch calls per iteration,
# graphed over eager, at most (eager: ~34 and ~1,670).
GRAPH_PHI_RTOL = 0.0
GRAPH_SYNC_RATIO = 0.25
GRAPH_LAUNCH_CALL_RATIO = 0.1
# Phase 18: the bench lane's iteration counts to tol 1e-4 (plane n64, n200)
# before the adaptive segment moved to the device, and the host launch calls
# per validation beyond the iterations' replays, at most (one `validate`
# replay, and room for a segment boundary in the window).
ADAPTIVE_ITERATIONS = {64: 1272, 200: 1131}
ADAPTIVE_LAUNCH_CALLS = 3
# Phase 20: the legs (name, plane n, ntime, iterations at most, tol) that every
# rank of the 1x2 mesh solves inside `graphs.eager()` and then through the
# mesh loops: over nccl (a card per rank) 100 iterations of n200, n200 to tol
# 1e-4 and 200 of n64; over gloo (both ranks on the one card) the same paths
# cut to stay within MESH_LOOPS_GLOO_SECONDS. With four cards also 2x2 at
# ntime 32. Over nccl, n200's host synchronisations and launch calls per
# iteration through the mesh loops, at most (eager: ~40 and thousands).
MESH_LOOP_LEGS = {
    "nccl": (("n200_100", 200, N_TIME, 100, 1e-4), ("n200_to_tol", 200, N_TIME, 4000, 1e-4),
             ("n64_200", 64, N_TIME, 200, 1e-4)),
    "gloo": (("n200_20", 200, N_TIME, 20, 1e-4), ("n64_100", 64, N_TIME, 100, 1e-4)),
}
MESH_LOOP_2X2 = ("n200_ntime32_100", 200, N_TIME_MESH, 100, 1e-4)
MESH_LOOPS_GLOO_SECONDS = 90
MESH_SYNCS_MAX, MESH_LAUNCH_CALLS_MAX = 8, 25
SWEEP_TIME_LIMIT = 20  # seconds per run of the replication sweep
PROFILE_MAX_BYTES = 200e6
# Phase 14: (name, the driver's main, its arguments), in the order they run.
BENCH_DRIVERS = (
    # The lane at half its default depth: the whole script stays near half
    # its time limit on a slow host.
    ("bench", bench.main, ["--repeats", "2", "--flagship_iters", "2000", "--large_iters", "150"]),
    ("bench_large", bench_large.main, ["--n_space", "200", "--iters", "50"]),
    ("profile_large", profile_large.main, ["--n_space", "200", "--iters", "5", "--cg_slope"]),
    ("refine_cost_bench", refine_cost_bench.main, ["--n_space", "200", "--chain", "10"]),
    ("bench_matvec", bench_matvec.main, ["--n_space", "200", "--iters", "20"]),
    ("steady_state_configs", steady_state_configs.main, ["--configs", "smoke"]),
)
# Keys of a driver's line that hold a time (s, ms, µs or a rate); a
# difference of two times (`cg_fixed_overhead_ms`, `unattributed_ms`) may
# be negative and is not one of them, nor is a build that was reused (0 s).
TIME_KEY = re.compile(r"(_ms|_us|_sec|^value|iters_per_sec|^repeats|^variants|^chain_us)$")
NOT_TIMES = ("cg_fixed_overhead_ms", "unattributed_ms", "kernel_build_sec")


def count_k4(path, expected=True):
    """K4's launches since `reset_counts`; on a single-device CG path
    (`expected`) there must be some, STAGES for each fused inner iteration,
    elsewhere none."""
    n = cg_step.KERNEL_LAUNCHES
    if expected and not (n > 0 and n == cg_step.STAGES * CG_COUNTERS.fused_steps):
        raise AssertionError(f"{path}: K4 launches {n} against {CG_COUNTERS.fused_steps} fused "
                             f"inner iterations")
    if not expected and n:
        raise AssertionError(f"{path}: K4 launched {n} times off the single-device CG path")
    return n


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def mass_conservation_error(mu):
    """RMS over time layers of each layer's total mass minus 1."""
    mass = np.asarray(mu, dtype=np.float64).sum(axis=1)
    return float(np.sqrt(np.mean((mass - 1.0) ** 2)))


def forbidden_imports():
    """Modules of jax or of the JAX package that this process has imported."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "dots_socp_tpu"))


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs an NVIDIA GPU")
    card = nvidia_smi_line()
    emit("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return card


def phase_build():
    path, seconds = _build.build()
    _build.load()
    ptxas = [ln.strip() for ln in _build.build_log().splitlines() if "registers" in ln or "smem" in ln]
    emit("build", library=str(path.name), compile_seconds=round(seconds, 3), ptxas=ptxas)


def run_cli(n_space, nit, extra=(), n_time=N_TIME, precision="float32"):
    argv = ["--example", "plane", "--n_space", str(n_space), "--ntime", str(n_time),
            "--tol", "1e-4", "--nit", str(nit), "--precision", precision, "--device", "cuda",
            *extra]
    t0 = time.perf_counter()
    solution, geometry, history = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kkt = history.kkt_errors
    if kkt.size == 0 or not np.isfinite(kkt).all():
        raise AssertionError(f"non-finite KKT values at n{n_space}")
    iterations = int(history.kkt_iteration[-1]) + 1
    return solution, history, {
        "vertices": int(geometry["vertices"].shape[0]),
        "iterations": iterations,
        "it_per_s": iterations / history.running_time,
        "solve_seconds": history.running_time,
        "wall_seconds": wall,
        "last_kkt": [float(e) for e in kkt[-1]],
    }


def k6_counted(path, steps, launches, iterations):
    """K6's route took every iteration of a single-device solve:
    `step.fused_steps` and K6's launches since `steps` and `launches` were
    read are one and LAUNCHES per iteration, and one more call at the
    capture's warm-up. Returns K6's launches."""
    steps, launches = step.FUSED_STEPS - steps, ialm_step.KERNEL_LAUNCHES - launches
    if not (steps == iterations and launches == ialm_step.LAUNCHES * (iterations + 1)):
        raise AssertionError(f"{path}: K6 launches {launches}, fused steps {steps} over "
                             f"{iterations} iterations")
    return launches


def phase_slice(card, n_time=N_TIME, phase="slice"):
    reset_counts()  # count the main path's launches only
    k6_steps, k6_launches = step.FUSED_STEPS, ialm_step.KERNEL_LAUNCHES
    solution, history, stats = run_cli(200, 100, n_time=n_time)
    launches = window_spmv.KERNEL_LAUNCHES
    k4 = count_k4(phase)
    counters = dict(vars(CG_COUNTERS))
    stop = np.nanmax(history.kkt_errors[:, STOP_SET], axis=1)
    mass_err = mass_conservation_error(solution["mu"])
    emit(phase, **stats, n_time=n_time, launches=launches, k4_launches=k4, cg=counters,
         inner_cg_per_outer=CG_COUNTERS.iterations / max(CG_COUNTERS.solves, 1),
         stop_error_first=float(stop[0]), stop_error_last=float(stop[-1]),
         mass_conservation_error=mass_err, card=card)
    if not (CG_COUNTERS.solves > 0 and CG_COUNTERS.refined_solves == CG_COUNTERS.solves):
        raise AssertionError("the n200 solve did not run the refined CG phi-solve")
    if not (launches > 0 and launches == CG_COUNTERS.window_matvecs):
        raise AssertionError(
            f"kernel launches {launches} != window matvecs {CG_COUNTERS.window_matvecs}"
        )
    if not stop[-1] <= 0.5 * stop[0]:
        raise AssertionError(f"stop-set error {stop[0]} -> {stop[-1]}: not halved")
    if not np.isfinite(mass_err):
        raise AssertionError("mass conservation error is not finite")
    if phase == "slice":
        k6_counted(phase, k6_steps, k6_launches, stats["iterations"])
        slice_f64(card)
    return history.kkt_errors[-1], solution


def slice_f64(card):
    """Phase 4's float64 leg: the CG path without refinement, on B1-f64,
    K4-f64 and K6 alone."""
    reset_counts()
    k6_steps, k6_launches = step.FUSED_STEPS, ialm_step.KERNEL_LAUNCHES
    _, _, stats = run_cli(200, 100, precision="float64")
    b1_f64, k4_f64, b1, k4 = f64_launches()
    counters = dict(vars(CG_COUNTERS))
    k6 = k6_counted("slice float64", k6_steps, k6_launches, stats["iterations"])
    emit("slice", precision="float64", **stats, b1_f64_launches=b1_f64, k4_f64_launches=k4_f64,
         k6_launches=k6, cg=counters, card=card)
    if not (CG_COUNTERS.solves > 0 and CG_COUNTERS.refined_solves == 0):
        raise AssertionError("the float64 n200 solve did not run the CG phi-solve unrefined")
    if not (b1_f64 > 0 and b1_f64 == CG_COUNTERS.window_matvecs):
        raise AssertionError(f"B1-f64 launches {b1_f64} != window matvecs "
                             f"{CG_COUNTERS.window_matvecs}")
    if not (k4_f64 > 0 and k4_f64 == cg_step.STAGES * CG_COUNTERS.fused_steps
            and CG_COUNTERS.f64_fused_steps == CG_COUNTERS.iterations):
        raise AssertionError(f"K4-f64 launches {k4_f64}: {counters}")
    if b1 or k4:
        raise AssertionError(f"the float64 solve launched B1 {b1} and K4 {k4} times")


def tf32_pins():
    return {
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }


def tf32_is_off(pins):
    return not (pins["matmul_allow_tf32"] or pins["cudnn_allow_tf32"]
                or pins["float32_matmul_precision"] != "highest")


def phase_spectral(card):
    pins = tf32_pins()
    reset_counts()
    _, history, stats = run_cli(64, 200)
    count_k4("spectral", expected=False)
    if CG_COUNTERS.solves:
        raise AssertionError("the n64 flagship solve took the CG path")
    # The same GEMM chain in f32 and in f64 on the card.
    _, data, _ = build_problem(N_TIME, cli.load_geometry("plane", 64), dtype="float32", device="cuda")
    f32 = data.spectral
    f64 = SpectralFactor(*(t.double() for t in f32))
    rhs = torch.from_numpy(
        np.random.default_rng(1).standard_normal((N_TIME + 1, f32.s.shape[0])).astype(np.float32)
    ).cuda()
    z32 = spectral_solve(f32, rhs).double()
    z64 = spectral_solve(f64, rhs.double())
    rel = float((z32 - z64).abs().max() / z64.abs().max())
    emit("spectral", **stats, tf32_pins=pins, f32_vs_f64_solve=rel, card=card)
    if not tf32_is_off(pins):
        raise AssertionError(f"TF32 is not pinned off: {pins}")
    if not rel <= TF32_TOL:
        raise AssertionError(f"f32 spectral solve off by {rel} (> {TF32_TOL}): TF32 on the GEMMs?")
    return history.kkt_errors[-1]


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _mesh_rank(rank, world, port, backend, n_space, nit, mesh_shape, n_time, results):
    """One rank of a sharded phase (a spawned process): torchrun's
    environment, then the port's CLI on plane `n_space` for `nit` iterations;
    its counts, its history and the phi of its solution (gathered from every
    shard on every rank) go back on `results`."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    try:
        # Count the main path's launches and collectives only.
        sharded_window.KERNEL_LAUNCHES = 0
        reset_counts()
        COUNTS.reset()
        before = graphs.STATS.snapshot()
        solution, history, stats = run_cli(
            n_space, nit, ["--mesh_shape", mesh_shape, "--dist_backend", backend], n_time)
        results.put((rank, {
            **stats, **_capture_stats(graphs.STATS.since(before)),
            "launches": sharded_window.KERNEL_LAUNCHES,
            "b1_launches": window_spmv.KERNEL_LAUNCHES, "k4_launches": cg_step.KERNEL_LAUNCHES,
            "cg": dict(vars(CG_COUNTERS)),
            "collectives": COUNTS.snapshot(),
            "kkt": history.kkt_errors, "mass_err": mass_conservation_error(solution["mu"]),
            "phi": solution["phi"],
            "tf32_pins": tf32_pins(), "forbidden_imports": forbidden_imports(),
        }))
    except BaseException as err:  # reported to the parent, which fails
        results.put((rank, {"error": repr(err)}))
        raise


def _capture_stats(stats):
    """A rank's graph work in a phase (`graphs.STATS.since`): whether its
    segments were captured (over nccl), its captures and their seconds, and
    its segment runs made op by op (over gloo)."""
    return {"captured": stats["captures"] > 0 and stats["uncaptured_runs"] == 0,
            "captures": stats["captures"], "capture_seconds": stats["capture_seconds"],
            "uncaptured_runs": stats["uncaptured_runs"]}


def mesh_backend(world):
    """nccl with a card per rank, else gloo (every rank on the one card)."""
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def spawn_ranks(phase, world, target, args):
    """`target(rank, world, port, *args, results)` in `world` spawned
    processes; their outputs in rank order. A rank that fails, hangs or
    exits with an error fails the phase, and no rank is left running."""
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, *args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    ranks = {}
    try:
        deadline = time.monotonic() + RANK_TIMEOUT
        while len(ranks) < world:
            rank, out = results.get(timeout=max(deadline - time.monotonic(), 1))
            if "error" in out:
                raise AssertionError(f"{phase} rank {rank} failed: {out['error']}")
            ranks[rank] = out
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:  # a hung or failed rank is stopped, never left behind
            if p.is_alive():
                p.kill()
                p.join()
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"{phase} ranks exited {[p.exitcode for p in procs]}")
    return [ranks[r] for r in range(world)]


def run_ranks(phase, n_space, nit, kkt_unsharded, mesh_shape=f"1x{SHARDS_SLICE}",
              world=SHARDS_SLICE, n_time=N_TIME):
    """The port's CLI on `world` spawned ranks with --mesh_shape `mesh_shape`;
    (backend, per-rank outputs in rank order), each with its KKT history, its
    stop-set errors, the largest relative difference of its final KKT table
    from `kkt_unsharded` and of its phi from rank 0's (0.0: bit-equal), and
    whether its segments were captured. A rank that fails, hangs or imports
    jax fails the phase, a rank over nccl that did not capture or over gloo
    that did fails it too, and no rank is left running."""
    backend = mesh_backend(world)
    ranks = spawn_ranks(phase, world, _mesh_rank,
                        (backend, n_space, nit, mesh_shape, n_time))
    outs = []
    phi0 = ranks[0]["phi"]
    for rank in range(world):
        out = ranks[rank]
        kkt = out["kkt"]
        stop = np.nanmax(kkt[:, STOP_SET], axis=1)
        ref = np.where(kkt_unsharded != 0, kkt_unsharded, np.nan)  # 0 and NaN: no check
        rel = np.abs(kkt[-1] - ref) / np.abs(ref)
        phi = out.pop("phi")
        out.update(stop_error_first=float(stop[0]), stop_error_last=float(stop[-1]),
                   kkt_rel_vs_unsharded=float(np.nanmax(rel)),
                   phi_bit_equal_rank0=bool(np.array_equal(phi, phi0)),
                   phi_rel_vs_rank0=float(np.abs(phi - phi0).max() / np.abs(phi0).max()))
        if out["forbidden_imports"]:
            raise AssertionError(f"{phase} rank {rank} imported {out['forbidden_imports']}")
        if out["k4_launches"]:  # a mesh keeps the torch route
            raise AssertionError(f"{phase} rank {rank} launched K4 {out['k4_launches']} times")
        check_captured(phase, rank, backend, out)
        outs.append(out)
    return backend, outs


def check_captured(phase, rank, backend, stats):
    """Over nccl every segment is a capture's replay; over gloo none is
    captured, every segment runs op by op. Nothing falls back."""
    if backend == "nccl" and not stats["captured"]:
        raise AssertionError(f"{phase} rank {rank}: nccl mesh not captured: {stats}")
    if backend == "gloo" and (stats["captures"] or not stats["uncaptured_runs"]):
        raise AssertionError(f"{phase} rank {rank}: gloo mesh captured or ran no segment: {stats}")


def _printable(outs):
    return [{k: v for k, v in out.items() if k != "kkt"} for out in outs]


def phase_sharded_slice(card, kkt_unsharded):
    backend, outs = run_ranks("sharded_slice", 200, 100, kkt_unsharded)
    emit("sharded_slice", backend=backend, ranks=SHARDS_SLICE, cards=torch.cuda.device_count(),
         per_rank=_printable(outs), card=card)
    for rank, out in enumerate(outs):
        if not (out["launches"] > 0 and out["launches"] == out["cg"]["window_matvecs"]):
            raise AssertionError(f"rank {rank}: B2 launches {out['launches']} != window "
                                 f"matvecs {out['cg']['window_matvecs']}")
        if not out["stop_error_last"] <= 0.5 * out["stop_error_first"]:
            raise AssertionError(f"rank {rank}: stop-set error {out['stop_error_first']} -> "
                                 f"{out['stop_error_last']}: not halved")
        if not np.isfinite(out["mass_err"]):
            raise AssertionError(f"rank {rank}: mass conservation error is not finite")
        if not out["kkt_rel_vs_unsharded"] <= SLICE_KKT_RTOL:
            raise AssertionError(f"rank {rank}: KKT {out['kkt'][-1]} vs unsharded {kkt_unsharded}")


def phase_time_sharded_slice(card):
    """Phase 12."""
    reset_counts()
    _, history, stats = run_cli(200, 100, n_time=N_TIME_MESH)
    b1_unsharded = window_spmv.KERNEL_LAUNCHES
    count_k4("time_slice_unsharded")
    kkt_unsharded = history.kkt_errors[-1]
    emit("time_sharded_slice", mesh="1x1", **stats, launches=b1_unsharded,
         cg=dict(vars(CG_COUNTERS)), card=card)
    if not (b1_unsharded > 0 and b1_unsharded == CG_COUNTERS.window_matvecs):
        raise AssertionError(f"B1 launches {b1_unsharded} != window matvecs at ntime {N_TIME_MESH}")
    for mesh_shape, world, kernel in TIME_MESHES:
        other = "b1_launches" if kernel == "launches" else "launches"
        t0 = time.perf_counter()
        backend, outs = run_ranks("time_sharded_slice", 200, 100, kkt_unsharded,
                                  mesh_shape=mesh_shape, world=world, n_time=N_TIME_MESH)
        for out in outs:
            its = out["iterations"]
            calls, nbytes = out["collectives"]["calls"], out["collectives"]["bytes"]
            out["time_collectives_per_iteration"] = sum(
                n for k, n in calls.items() if k.startswith("time_")) / its
            out["time_collective_bytes_per_iteration"] = sum(
                n for k, n in nbytes.items() if k.startswith("time_")) / its
            out["collectives_per_iteration"] = sum(calls.values()) / its
        emit("time_sharded_slice", mesh=mesh_shape, backend=backend, ranks=world,
             cards=torch.cuda.device_count(), phase_seconds=time.perf_counter() - t0,
             per_rank=_printable(outs), card=card)
        for rank, out in enumerate(outs):
            if not (out[kernel] > 0 and out[kernel] == out["cg"]["window_matvecs"]
                    and out[other] == 0):
                raise AssertionError(f"{mesh_shape} rank {rank}: kernel launches B2 "
                                     f"{out['launches']} / B1 {out['b1_launches']} against "
                                     f"{out['cg']['window_matvecs']} window matvecs")
            if not out["stop_error_last"] <= 0.5 * out["stop_error_first"]:
                raise AssertionError(f"{mesh_shape} rank {rank}: stop-set error "
                                     f"{out['stop_error_first']} -> {out['stop_error_last']}")
            if not np.isfinite(out["mass_err"]):
                raise AssertionError(f"{mesh_shape} rank {rank}: mass conservation error")
            if not out["kkt_rel_vs_unsharded"] <= SLICE_KKT_RTOL:
                raise AssertionError(f"{mesh_shape} rank {rank}: KKT {out['kkt'][-1]} vs "
                                     f"unsharded {kkt_unsharded}")
            if not out["time_collectives_per_iteration"] > 0:
                raise AssertionError(f"{mesh_shape} rank {rank} made no time collective")
            if not (out["phi_bit_equal_rank0"] or out["phi_rel_vs_rank0"] <= PHI_DRIFT_RTOL):
                raise AssertionError(f"{mesh_shape} rank {rank}: phi is {out['phi_rel_vs_rank0']} "
                                     f"off rank 0's (> {PHI_DRIFT_RTOL})")


def phase_dryrun(card):
    out = dryrun.dryrun_multichip(4)
    emit("dryrun", **out, card=card)
    if not all(r.get("b2_launches", 0) > 0 and r["b1_launches"] == 0 for r in out["ranks"]):
        raise AssertionError(f"the dry run's refined CG path did not launch B2 alone: {out}")
    for rank, r in enumerate(out["ranks"]):  # gloo: every segment op by op
        check_captured("dryrun", rank, r["backend"], {**r, "captured": r["captures"] > 0})


def phase_sharded_spectral(card, kkt_single):
    backend, outs = run_ranks("sharded_spectral", 64, 200, kkt_single)
    emit("sharded_spectral", backend=backend, ranks=SHARDS_SLICE, cards=torch.cuda.device_count(),
         per_rank=_printable(outs), card=card)
    for rank, out in enumerate(outs):
        if out["cg"]["solves"] or out["launches"] or out["b1_launches"]:
            raise AssertionError(f"rank {rank}: the sharded n64 solve took the CG path: {out['cg']}")
        if not tf32_is_off(out["tf32_pins"]):
            raise AssertionError(f"rank {rank}: TF32 is not pinned off: {out['tf32_pins']}")
        if not np.isfinite(out["mass_err"]):
            raise AssertionError(f"rank {rank}: mass conservation error is not finite")
        if not out["kkt_rel_vs_unsharded"] <= SPECTRAL_KKT_RTOL:
            raise AssertionError(f"rank {rank}: KKT {out['kkt'][-1]} vs single device {kkt_single}")


def _rel_diff(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def phase_resume(card, kkt_full, solution_full):
    legs = []

    def leg(history, **fields):
        its = history.kkt_iteration[np.isfinite(history.kkt_iteration)]
        legs.append({**fields, "launches": window_spmv.KERNEL_LAUNCHES,
                     "k4_launches": count_k4("resume"),
                     "cg": dict(vars(CG_COUNTERS)), "first_validation": int(its.min()),
                     "last_validation": int(its.max()), "snapshot_bytes": os.path.getsize(snap)})

    with tempfile.TemporaryDirectory() as tmp:
        snap, log = str(Path(tmp) / "state.npz"), Path(tmp) / "leg2.log"
        # First leg: solve_large to nit=50, with its forced snapshot on exit
        # and its cold CG histogram.
        reset_counts()
        _, history, result = solve_large.main(
            ["--n_space", "200", "--ntime", str(N_TIME), "--tol", "1e-4", "--nit", "50",
             "--snapshot", snap, "--device", "cuda"])
        torch.cuda.synchronize()
        leg(history, **result)
        # Second leg: the CLI, as phase 4 ran it, resumes the same file.
        reset_counts()
        solution, history, stats = run_cli(200, 100, ["--snapshot", snap, "--log_file", str(log)])
        leg(history, **stats)
        interface.set_logging_level("info")  # release the log file
        resumed_line = re.search(r"Resuming from snapshot \S+ \(iteration (\d+),", log.read_text())
    kkt = history.kkt_errors[-1]
    ref = np.where(kkt_full != 0, kkt_full, np.nan)
    kkt_rel = float(np.nanmax(np.abs(kkt - ref) / np.abs(ref)))
    mu_rel = _rel_diff(solution["mu"], solution_full["mu"])
    e_rel = _rel_diff(solution["E"], solution_full["E"])
    phi_rel = _rel_diff(solution["phi"], solution_full["phi"])
    emit("resume", legs=legs, resumed_from=resumed_line and int(resumed_line.group(1)),
         kkt_rel_vs_uninterrupted=kkt_rel, mu_rel_vs_uninterrupted=mu_rel,
         E_rel_vs_uninterrupted=e_rel, phi_rel_vs_uninterrupted=phi_rel, last_kkt=[float(e) for e in kkt], card=card)
    if resumed_line is None or int(resumed_line.group(1)) != 49:
        raise AssertionError("the second leg's log has no 'Resuming from snapshot' line at 49")
    if not (legs[0]["last_validation"] == 49 and legs[1]["first_validation"] >= 50
            and legs[1]["last_validation"] == 99):
        raise AssertionError(f"the iteration counter did not continue: {legs}")
    for leg in legs:
        if not (leg["launches"] > 0 and leg["launches"] == leg["cg"]["window_matvecs"]):
            raise AssertionError(f"B1 launches {leg['launches']} != window matvecs {leg['cg']}")
    if not max(kkt_rel, mu_rel, e_rel, phi_rel) <= RESUME_RTOL:
        raise AssertionError(f"the resumed run left the uninterrupted one: KKT {kkt_rel}, "
                             f"mu {mu_rel}, E {e_rel}, phi {phi_rel} > {RESUME_RTOL}")


def phase_replication(card):
    examples, congestions = ["ring", "hills"], [0.0, 0.01]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sweep.main(["--examples", *examples, "--congestions", *map(str, congestions),
                    "--ntime", str(N_TIME), "--tol", "1e-3",
                    "--time_limit", str(SWEEP_TIME_LIMIT), "--outdir", tmp, "--device", "cuda"])
        sweep_seconds = time.perf_counter() - t0
        tables = {}
        for congestion in congestions:
            c_dir = Path(tmp) / f"congestion_{congestion:.2f}".replace(".", "_")
            rows = log2table.parse_log(str(c_dir / "info.log"))
            for ext in ("tex", "html"):
                text = (c_dir / f"comparison_table.{ext}").read_text()
                if "Converged" not in text or not all(e.title() in text for e in examples):
                    raise AssertionError(f"{c_dir.name}/comparison_table.{ext} lacks a row or column")
            if [r["Example"] for r in rows] != examples:
                raise AssertionError(f"{c_dir.name}/info.log holds {[r['Example'] for r in rows]}")
            if not all(r.get("Converged") in ("yes", "time-capped") for r in rows):
                raise AssertionError(f"{c_dir.name}: the Converged column is not filled: {rows}")
            tables[c_dir.name] = rows
        t0 = time.perf_counter()
        _, _, history, error, rows = main_versus_exact.main(
            ["--example=plane", "--n_space=50", f"--ntime={N_TIME}", "--tol=1e-3", "--nit=3000",
             "--precision=float64", "--device=cuda", f"--outdir={tmp}"])
        versus_seconds = time.perf_counter() - t0
        table_written = (Path(tmp) / "error_versus_exact_socp.html").exists()
    interface.set_logging_level("info")
    kkts = [row["kkt_error"] for row in rows]
    emit("replication", sweep=tables, sweep_seconds=sweep_seconds,
         versus_exact={"error": error, "checkpoints": rows, "seconds": versus_seconds,
                       "iterations": int(np.nanmax(history.kkt_iteration)) + 1}, card=card)
    if not (len(rows) == 3 and all(b < a for a, b in zip(kkts, kkts[1:])) and kkts[0] <= 1e-1):
        raise AssertionError(f"versus-exact: not one decreasing row per decade: {kkts}")
    if not (0 < error["l2"] < 0.5 and table_written):
        raise AssertionError(f"versus-exact: l2 error {error['l2']}, table written {table_written}")


def phase_profile(card):
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        _, _, stats = run_cli(200, 12, ["--profile_dir", tmp])
        launches = window_spmv.KERNEL_LAUNCHES
        k4 = count_k4("profile")
        trace = Path(tmp) / "solve_trace.json"
        if not trace.is_file():
            raise AssertionError("--profile_dir left no trace file")
        size = trace.stat().st_size
        events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    b1 = [e for e in kernels if "window_spmv_kernel" in e.get("name", "")]
    emit("profile", **stats, trace_bytes=size, events=len(events), kernel_events=len(kernels),
         window_spmv_kernel_events=len(b1), traced_iterations=interface.PROFILE_ITERATIONS,
         launches=launches, k4_launches=k4, card=card)
    if not b1:
        raise AssertionError("the trace names no window_spmv_kernel among its CUDA kernel events")
    if not size <= PROFILE_MAX_BYTES:
        raise AssertionError(f"the trace is {size} bytes (> {PROFILE_MAX_BYTES}): not bounded")
    if not (launches == CG_COUNTERS.window_matvecs and len(b1) < launches):
        raise AssertionError(f"{len(b1)} traced of {launches} launches, "
                             f"{CG_COUNTERS.window_matvecs} window matvecs: the trace did not stop")


def times_in(result, path=""):
    """(path, value) of every time in a driver's result, nested dicts and
    lists included."""
    for key, value in result.items():
        where = f"{path}.{key}" if path else key
        if key in NOT_TIMES:
            continue
        if isinstance(value, dict):
            if TIME_KEY.search(key):
                yield from ((f"{where}.{k}", v) for k, v in value.items())
            else:
                yield from times_in(value, where)
        elif TIME_KEY.search(key):
            for v in value if isinstance(value, list) else [value]:
                yield where, v


def phase_bench(card):
    """Phase 14."""
    reset_counts()
    t0 = time.perf_counter()
    results = {}
    for name, driver, argv in BENCH_DRIVERS:
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            returned = driver([*argv, "--device", "cuda"])
        last = json.loads(printed.getvalue().strip().splitlines()[-1])
        if last != json.loads(json.dumps(returned)):
            raise AssertionError(f"{name}: the last line is not the result it returned")
        emit("bench", driver=name, argv=argv, result=last, card=card)
        results[name] = last
    launches = window_spmv.KERNEL_LAUNCHES
    count_k4("bench")
    chained = (results["bench"]["large_mesh"]["chained_matvecs"]
               + results["refine_cost_bench"]["chained_matvecs"]
               + results["bench_matvec"]["chained_matvecs"])
    emit("bench", phase_seconds=time.perf_counter() - t0, launches=launches,
         cg_window_matvecs=CG_COUNTERS.window_matvecs, chained_matvecs=chained, card=card)
    for name, result in results.items():
        bad = [(k, v) for k, v in times_in(result)
               if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0)]
        if bad:
            raise AssertionError(f"{name}: times that are not finite and > 0: {bad}")
        if result["device"] != "cuda" or result["card"] != card:
            raise AssertionError(f"{name} did not run on the card: {result['device']}")
    lane = results["bench"]["large_mesh"]
    if not all(lane[k] > 0 for k in ("window_matvec_us", "window_bound_us", "library_us")):
        raise AssertionError(f"the lane's B1 line lacks its time, bound or library call: {lane}")
    matvec = results["bench_matvec"]
    if not matvec["max_disagreement"] <= KERNEL_TOL * matvec["max_abs_y"]:
        raise AssertionError(f"bench_matvec's variants disagree: {matvec['max_disagreement']}")
    if not (launches > 0 and launches == CG_COUNTERS.window_matvecs + chained):
        raise AssertionError(f"B1 launches {launches} != window matvecs "
                             f"{CG_COUNTERS.window_matvecs} + chained {chained}")
    if forbidden_imports():
        raise AssertionError(f"the drivers imported {forbidden_imports()}")


def phase_wide_slice(card):
    """Phase 15."""
    phase_slice(card, N_TIME_WIDE, phase="wide_slice")
    with tempfile.TemporaryDirectory() as tmp:
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            summary = records.main(["--only", "R1", "--examples", "ring", "--congestions", "0.00",
                                    "--outdir", tmp, "--device", "cuda"])
    interface.set_logging_level("info")
    emit("wide_slice", record=summary["lines"], card=card)
    if not (summary["rows"] == 1 and summary["agrees"]):
        raise AssertionError(f"ring at congestion 0.00 disagrees with its record: {summary}")


def phase_spectral_records(card):
    """Phase 16."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            floor = spectral_floor.main(["--examples", "knots_3", "--variants", "long",
                                         "--device", "cuda"])
            summaries = [records.main(["--only", "R1", "--examples", example,
                                       "--congestions", *congestions, "--outdir", tmp,
                                       "--device", "cuda"])
                         for example, congestions in SPECTRAL_ROWS]
    interface.set_logging_level("info")
    ratios = floor["energy_device_over_host_blas"]["knots_3"]
    lines = [line for summary in summaries for line in summary["lines"]]
    emit("spectral_records", energy_device_over_host_blas=ratios,
         energy_device_over_cpu=floor["energy_device_over_cpu_f32"]["knots_3"],
         long_energy_device_over_cpu=floor["variants_energy_device_over_cpu"]["knots_3"]["long"],
         solve_us=floor["solve_us"]["knots_3"],
         rows={ln["row"]: {"port": ln["port"], "jax": ln["jax"], "agrees": ln["agrees"]}
               for ln in lines},
         phase_seconds=time.perf_counter() - t0, card=card)
    if not all(r <= SPECTRAL_ENERGY_RATIO for r in ratios.values()):
        raise AssertionError(f"the card's float32 spectral solve is {ratios} times the host's "
                             f"error in the energy norm (> {SPECTRAL_ENERGY_RATIO})")
    rows = sum(len(congestions) for _, congestions in SPECTRAL_ROWS)
    if not (len(lines) == rows and all(ln["agrees"] for ln in lines)):
        raise AssertionError(f"sweep rows disagree with their records: "
                             f"{[s['disagree'] for s in summaries]}")


def host_calls_per_iteration(n_space, eager):
    """profile_slice's host synchronisations and launch calls per iteration
    of plane `n_space`: a BASE- against a (BASE + ITERS)-iteration solve."""
    geometry = cli.load_geometry("plane", n_space)
    with graphs.eager() if eager else contextlib.nullcontext():
        (c0, _), (c1, _) = (profile_slice.profiled_counts(geometry, n)
                            for n in (profile_slice.BASE, profile_slice.BASE + profile_slice.ITERS))
    return {k: (c1[k] - c0[k]) / profile_slice.ITERS
            for k in ("host_syncs", "host_launch_calls", "launches", "device_ms")}


def phase_graphs(card):
    """Phase 17."""
    for n_space in (200, 64):
        legs, phis = {}, {}
        for mode in ("graphed", "eager"):
            reset_counts()
            with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                solution, _, stats = run_cli(n_space, 100)
            legs[mode] = {**stats, "launches": window_spmv.KERNEL_LAUNCHES,
                          "k4_launches": count_k4("graphs", expected=n_space == 200),
                          "cg": dict(vars(CG_COUNTERS))}
            phis[mode] = solution["phi"]
        bit_equal = bool(np.array_equal(phis["graphed"], phis["eager"]))
        rel = _rel_diff(phis["graphed"], phis["eager"])
        emit("graphs", n_space=n_space, **legs, phi_bit_equal=bit_equal, phi_rel=rel, card=card)
        if not (bit_equal or rel <= GRAPH_PHI_RTOL):
            raise AssertionError(f"n{n_space}: graphed phi is {rel} off the eager one")
        for mode, leg in legs.items():
            if leg["launches"] != leg["cg"]["window_matvecs"] or (n_space == 200) != (leg["launches"] > 0):
                raise AssertionError(f"n{n_space} {mode}: B1 launches {leg['launches']} against "
                                     f"{leg['cg']['window_matvecs']} window matvecs")
    calls = {mode: host_calls_per_iteration(200, mode == "eager") for mode in ("graphed", "eager")}
    ratios = {k: calls["graphed"][k] / calls["eager"][k] for k in ("host_syncs", "host_launch_calls")}
    emit("graphs", n_space=200, per_iteration=calls, graphed_over_eager=ratios, card=card)
    if not (ratios["host_syncs"] <= GRAPH_SYNC_RATIO
            and ratios["host_launch_calls"] <= GRAPH_LAUNCH_CALL_RATIO):
        raise AssertionError(f"graphed n200 iteration: host calls over eager {ratios}")


def converge(n_space):
    """Plane `n_space` to the bench lane's tolerance as its --converge runs
    it; (solution, run history, the segment's host reads)."""
    from dots_socp_torch.solver import solver

    geometry = cli.load_geometry("plane", n_space)
    kw = {"laplacian_mode": "cg"} if n_space == 200 else {}
    reads = graphs.HOST_READS
    solution, history = solver(N_TIME, geometry, nit=bench.CONVERGE_NIT, tol=bench.CONVERGE_TOL,
                               time_limit=3000, precision="float32", device="cuda", **kw)
    torch.cuda.synchronize()
    return solution, history, graphs.HOST_READS - reads


def phase_adaptive(card):
    """Phase 18."""
    t0 = time.perf_counter()
    with bench.fresh_cache_dir():
        for n_space, expect in ADAPTIVE_ITERATIONS.items():
            legs, runs = {}, {}
            for mode in ("graphed", "eager"):
                reset_counts()
                with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                    solution, history, reads = converge(n_space)
                k4 = count_k4("adaptive", expected=n_space == 200)
                runs[mode] = (solution["phi"], np.asarray(history.kkt_iteration))
                legs[mode] = {"iterations": int(history.kkt_iteration[-1]),
                              "validations": len(history.kkt_iteration),
                              "converged": bool(np.all(history.get_current_kkt_errors()
                                                       < bench.CONVERGE_TOL)),
                              "solve_sec": history.running_time, "host_reads": reads,
                              "b1_launches": window_spmv.KERNEL_LAUNCHES, "k4_launches": k4}
            bit_equal = bool(np.array_equal(runs["graphed"][0], runs["eager"][0]))
            rel = _rel_diff(runs["graphed"][0], runs["eager"][0])
            emit("adaptive", n_space=n_space, **legs, phi_bit_equal=bit_equal, phi_rel=rel,
                 expected_iterations=expect, card=card)
            if not np.array_equal(runs["graphed"][1], runs["eager"][1]):
                raise AssertionError(f"n{n_space}: graphed and eager validate at other iterations")
            for mode, leg in legs.items():
                if not (leg["converged"] and leg["iterations"] == expect):
                    raise AssertionError(f"n{n_space} {mode}: {leg['iterations']} iterations "
                                         f"(converged {leg['converged']}), expected {expect}")
            if not (bit_equal or rel <= GRAPH_PHI_RTOL):
                raise AssertionError(f"n{n_space}: graphed phi is {rel} off the eager one")

        # The validations' host cost where the cadence interval is 1 or near it.
        geometry = cli.load_geometry("plane", 64)
        last = ADAPTIVE_ITERATIONS[64] + 1
        (c0, _), (c1, _) = (profile_slice.profiled_counts(geometry, n, profile_slice.NEAR_TOL)
                            for n in (last - profile_slice.NEAR_ITERS, last))
    d = {k: c1[k] - c0[k] for k in c0}
    segments = d["host_reads"] - d["validations"]
    per_validation = {
        "host_syncs": (d["host_syncs"] - segments) / d["validations"],
        "host_launch_calls": (d["host_launch_calls"] - profile_slice.NEAR_ITERS) / d["validations"],
        "launches": d["launches"] / d["validations"],
    }
    emit("adaptive", n_space=64, window=[last - profile_slice.NEAR_ITERS, last], deltas=d,
         segments=segments, per_validation=per_validation,
         phase_seconds=time.perf_counter() - t0, card=card)
    if not (d["validations"] > 0 and per_validation["host_syncs"] <= 1
            and per_validation["host_launch_calls"] <= ADAPTIVE_LAUNCH_CALLS):
        raise AssertionError(f"n64 near tolerance: host calls per validation {per_validation}")


def _loops_rank(rank, world, port, backend, mesh_shape, legs, profile, results):
    """One rank of phase 20 (a spawned process): the mesh brought up once,
    then every leg solved through the port's `solver` inside `graphs.eager()`
    and then through the mesh loops; per leg and mode its counts, its
    validation points, its phi; with `profile`, n200's host calls per
    iteration in both modes (`bench_sharded_cg.loop_turn`: a BASE- against
    a (BASE + ITERS)-iteration solve, inner rtol 5e-4)."""
    from dots_socp_torch.parallel import distributed as pd
    from dots_socp_torch.solver import solver

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    try:
        pd.initialize_distributed(backend)
        mesh = pd.make_solver_mesh(mesh_shape, device="cuda")
        out = {"legs": {}}
        for name, n_space, n_time, nit, tol in legs:
            geometry = cli.load_geometry("plane", n_space)
            for mode in ("eager", "loops"):
                sharded_window.KERNEL_LAUNCHES = 0
                reset_counts()
                COUNTS.reset()
                before, reads = graphs.STATS.snapshot(), graphs.HOST_READS
                with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                    solution, history = solver(n_time, geometry, nit=nit, tol=tol,
                                               time_limit=3000, precision="float32", mesh=mesh)
                torch.cuda.synchronize()
                its = int(history.kkt_iteration[-1]) + 1
                out["legs"].setdefault(name, {})[mode] = {
                    "iterations": its, "validation_points": np.asarray(history.kkt_iteration),
                    "converged": bool(np.all(history.get_current_kkt_errors() < tol)),
                    "it_per_s": its / history.running_time, "solve_seconds": history.running_time,
                    "b2_launches": sharded_window.KERNEL_LAUNCHES,
                    "window_matvecs": CG_COUNTERS.window_matvecs,
                    "b1_launches": window_spmv.KERNEL_LAUNCHES,
                    "k4_launches": cg_step.KERNEL_LAUNCHES,
                    "inner_cg_per_outer": CG_COUNTERS.iterations / max(CG_COUNTERS.solves, 1),
                    "host_reads_per_iteration":
                        (graphs.HOST_READS - reads + CG_COUNTERS.flag_reads) / its,
                    "collectives_per_iteration": sum(COUNTS.calls.values()) / its,
                    **_capture_stats(graphs.STATS.since(before)),
                    "phi": solution["phi"],
                }
        if profile:
            geometry = cli.load_geometry("plane", 200)
            kw = dict(n_time=profile_slice.N_TIME, mesh=mesh, device="cuda")
            out["per_iteration"] = {}
            for mode in ("eager", "loops"):
                with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                    out["per_iteration"][mode] = bench_sharded_cg.loop_turn(
                        geometry, kw, profile_slice.BASE, profile_slice.BASE + profile_slice.ITERS,
                        on_card=True)["per_iteration"]
        out["forbidden_imports"] = forbidden_imports()
        results.put((rank, out))
    except BaseException as err:  # reported to the parent, which fails
        results.put((rank, {"error": repr(err)}))
        raise


def phase_mesh_loops(card):
    """Phase 20."""
    t0, b2 = time.perf_counter(), 0
    backend = mesh_backend(SHARDS_SLICE)
    meshes = [(f"1x{SHARDS_SLICE}", SHARDS_SLICE, MESH_LOOP_LEGS[backend], backend == "nccl")]
    if torch.cuda.device_count() >= 4:
        meshes.append(("2x2", 4, (MESH_LOOP_2X2,), False))
    for shape, world, legs, profile in meshes:
        outs = spawn_ranks("mesh_loops", world, _loops_rank,
                           (mesh_backend(world), shape, legs, profile))
        phi0 = {name: outs[0]["legs"][name]["loops"]["phi"] for name, *_ in legs}
        for rank, out in enumerate(outs):
            if out["forbidden_imports"]:
                raise AssertionError(f"mesh_loops rank {rank} imported {out['forbidden_imports']}")
            for name, n_space, *_ in legs:
                leg = out["legs"][name]
                eager, loops = leg["eager"], leg["loops"]
                phi_e, phi_l = eager.pop("phi"), loops.pop("phi")
                points = [run.pop("validation_points") for run in (eager, loops)]
                leg.update(phi_bit_equal=bool(np.array_equal(phi_l, phi_e)),
                           phi_rel=_rel_diff(phi_l, phi_e),
                           same_validation_points=bool(np.array_equal(*points)),
                           validations=len(points[1]),
                           phi_bit_equal_rank0=bool(np.array_equal(phi_l, phi0[name])))
                check_captured("mesh_loops", rank, mesh_backend(world), loops)
                where = f"mesh_loops {shape} {name} rank {rank}"
                if eager["captures"]:
                    raise AssertionError(f"{where}: the eager leg captured {eager['captures']}")
                if not (leg["phi_bit_equal"] or leg["phi_rel"] <= GRAPH_PHI_RTOL):
                    raise AssertionError(f"{where}: phi is {leg['phi_rel']} off the eager one")
                if not (leg["same_validation_points"]
                        and loops["iterations"] == eager["iterations"]):
                    raise AssertionError(f"{where}: {loops['iterations']} iterations against "
                                         f"{eager['iterations']}, or other validation points")
                if not leg["phi_bit_equal_rank0"]:
                    raise AssertionError(f"{where}: phi differs from rank 0's")
                for mode, run in (("eager", eager), ("loops", loops)):
                    if not (run["b2_launches"] == run["window_matvecs"]
                            and (run["b2_launches"] > 0) == (n_space == 200)
                            and run["b1_launches"] == run["k4_launches"] == 0):
                        raise AssertionError(f"{where} {mode}: B2 {run['b2_launches']} against "
                                             f"{run['window_matvecs']} window matvecs, B1 "
                                             f"{run['b1_launches']}, K4 {run['k4_launches']}")
                    b2 += run["b2_launches"]
            calls = out.get("per_iteration", {}).get("loops")
            if calls and not (calls["host_syncs"] <= MESH_SYNCS_MAX
                              and calls["host_launch_calls"] <= MESH_LAUNCH_CALLS_MAX):
                raise AssertionError(f"mesh_loops {shape} rank {rank}: per n200 iteration {calls}")
        emit("mesh_loops", mesh=shape, backend=mesh_backend(world), ranks=world,
             cards=torch.cuda.device_count(), per_rank=outs, card=card)
    seconds = time.perf_counter() - t0
    emit("mesh_loops", backend=backend, phase_seconds=seconds, b2_launches=b2, card=card)
    if backend == "gloo" and seconds > MESH_LOOPS_GLOO_SECONDS:
        raise AssertionError(f"mesh_loops over gloo took {seconds} s, more than "
                             f"{MESH_LOOPS_GLOO_SECONDS}")


def phase_kernels(card):
    """Phase 23: `kernel_checks` at the main path's shapes."""
    t0 = time.perf_counter()
    checks = {}
    for dtype, lanes in kernel_checks.B1_CASES:
        checks[f"b1.{dtype}.{lanes}"] = kernel_checks.b1(dtype, lanes)
    for shards, lanes in kernel_checks.B2_CASES:
        checks[f"b2.{shards}_shards.{lanes}"] = kernel_checks.b2(shards, lanes)
    checks["k4.float32.n200"] = kernel_checks.k4(200)
    checks["k4.float64.n200"] = kernel_checks.k4_f64_latched()
    for n, precision in kernel_checks.IALM_SETUPS:
        for congestion, scale_z in kernel_checks.IALM_CASES:
            checks[f"k6.n{n}.{precision}.congestion{congestion}"] = kernel_checks.k6(
                n, precision, congestion, scale_z)
    emit("kernels", checks=checks, launches=sum(c["launches"] for c in checks.values()),
         phase_seconds=time.perf_counter() - t0, card=card)


def main(argv=None):
    alone = {"time_sharded_slice": phase_time_sharded_slice, "wide_slice": phase_wide_slice,
             "spectral_records": phase_spectral_records, "graphs": phase_graphs,
             "adaptive": phase_adaptive, "mesh_loops": phase_mesh_loops,
             "kernels": phase_kernels,
             # The sharded phases 7 and 11 after the unsharded runs they are held to.
             "sharded_slice": lambda card: phase_sharded_slice(card, phase_slice(card)[0]),
             "sharded_spectral": lambda card: phase_sharded_spectral(card, phase_spectral(card))}
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", choices=sorted(alone),
                    help="run the device and build phases and then this phase alone")
    args = ap.parse_args(argv)
    card = phase_device()
    phase_build()
    if args.phase:
        alone[args.phase](card)
        return 0
    kkt_unsharded, solution_unsharded = phase_slice(card)
    kkt_spectral = phase_spectral(card)
    phase_sharded_slice(card, kkt_unsharded)
    phase_resume(card, kkt_unsharded, solution_unsharded)
    phase_replication(card)
    phase_profile(card)
    phase_sharded_spectral(card, kkt_spectral)
    phase_time_sharded_slice(card)
    phase_dryrun(card)
    phase_bench(card)
    phase_wide_slice(card)
    phase_spectral_records(card)
    phase_graphs(card)
    phase_adaptive(card)
    phase_mesh_loops(card)
    phase_kernels(card)
    if forbidden_imports():
        raise AssertionError(f"jax or the JAX package was imported: {forbidden_imports()}")
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
