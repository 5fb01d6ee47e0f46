#!/bin/bash
# The baseline measurement protocol on the port (counterpart of the
# repository's scripts/measure_{protocol,phase2,phase3,phase4}.sh): five
# steps, one process at a time, each under `timeout`, on one NVIDIA GPU.
#
#   bash dots_socp_torch/scripts/measure_protocol.sh
#
# OUTDIR (default output/torch_protocol) takes the logs; DEVICE (default
# cuda) is passed to every step as --device. The JAX package split its
# protocol into phases to reuse XLA compile caches; the port compiles
# nothing per shape, so one script runs it all. It takes hours.
set -u
cd "$(dirname "$0")/../.."
export PYTHONPATH=./${PYTHONPATH:+:$PYTHONPATH}
export PYTHONIOENCODING=utf-8
OUT=${OUTDIR:-output/torch_protocol}
DEVICE=${DEVICE:-cuda}
mkdir -p "$OUT"
STAMP() { date -u +%H:%M:%S; }

echo "[$(STAMP)] === 1. ntime=127 mid-size mesh (plane n_space=50) ==="
timeout 2400 python -m dots_socp_torch.replication.main \
  --example=plane --n_space=50 --ntime=127 --nit=10000 --time_limit=1800 \
  --tol=1e-4 --device="$DEVICE" --log_file="$OUT/ntime127.log" \
  > "$OUT/ntime127.stdout" 2>&1
echo "[$(STAMP)] ntime127 exit=$?"

echo "[$(STAMP)] === 2. congestion=0.05 perf point (plane n_space=64) ==="
timeout 2400 python -m dots_socp_torch.replication.main \
  --example=plane --n_space=64 --ntime=31 --nit=10000 --time_limit=1800 \
  --tol=1e-4 --congestion=0.05 --device="$DEVICE" --log_file="$OUT/congestion005.log" \
  > "$OUT/congestion005.stdout" 2>&1
echo "[$(STAMP)] congestion exit=$?"

echo "[$(STAMP)] === 3. large-mesh CG path benches ==="
timeout 3600 python -m dots_socp_torch.scripts.bench_large --n_space 200 --iters 200 \
  --device "$DEVICE" > "$OUT/bench_large_v46k.json" 2> "$OUT/bench_large_v46k.stderr"
echo "[$(STAMP)] bench_large 46k exit=$?"
timeout 3600 python -m dots_socp_torch.scripts.bench_large --n_space 290 --iters 100 \
  --device "$DEVICE" > "$OUT/bench_large_v97k.json" 2> "$OUT/bench_large_v97k.stderr"
echo "[$(STAMP)] bench_large 97k exit=$?"

echo "[$(STAMP)] === 4. true_error: f64, tol=1e-5, versus exact ==="
timeout 5400 python -m dots_socp_torch.replication.main_versus_exact \
  --example=plane --n_space=50 --tol=0.00001 --nit=20000 --precision=float64 \
  --device="$DEVICE" --outdir="$OUT/true_error" --log_file="$OUT/true_error.log" \
  > "$OUT/true_error.stdout" 2>&1
echo "[$(STAMP)] true_error exit=$?"

echo "[$(STAMP)] === 5. full replication sweep (14 examples x 3 congestions, tol=1e-4) ==="
timeout 14400 python -m dots_socp_torch.replication.sweep \
  --ntime=31 --nit=10000 --time_limit=5000 --tol=1e-4 --device="$DEVICE" \
  --outdir="$OUT/main" --congestions 0.00 0.01 0.05 \
  --examples airplane refined_airplane armadillo refined_armadillo hand refined_hand \
  punctured_ball refined_punctured_ball bunny refined_bunny ring knots_3 knots_5 hills \
  > "$OUT/make_main.stdout" 2>&1
echo "[$(STAMP)] sweep exit=$?"

echo "[$(STAMP)] === protocol complete ==="
