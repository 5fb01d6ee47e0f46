// One inner iteration of the single-device CG phi-solve for Hopper (sm_90a):
// kernel family K4, cg_step_walk_kernel, cg_step_wide_kernel and
// cg_step_null_kernel, and K4-f64, the same bodies in float64 for the
// float64 CG (cg_step_f64_walk_kernel, cg_step_f64_wide_kernel,
// cg_step_f64_null_kernel; dots_cg_step_f64).
//
// It replaces what XLA fuses around the Pallas SpMV in the JAX package's
// inner CG loop: `body` of the lax.while_loop in
// dots_socp_tpu/ops/laplacian.py:928-955 (with `dfl` :918-921 and `precond`
// :867-872), i.e. an XLA fusion, not a Pallas call; in the port the torch
// route of the same iteration is ops/laplacian.py::_CGSystem.gated_step.
// Given lap = L p (kernel B1), it computes, per time mode (row) m of the
// modes-major (rows, n) state, with the latch `live` folded in:
//
//   active = (rr > thresh) & live
//   ap     = -(lap + shift * av * p)
//   den    = sum_v p * ap;   step = active & (den > 0)
//   alpha  = step ? rz / max(den, 1e-30) : 0
//   x     += alpha * p;      r = dfl(r - alpha * ap)
//   z      = jacobi * r + s * G,  G = ((s * r) @ Q * winv) @ Q^T
//   rr, rz_new = sum_v r * r, sum_v r * z
//   beta   = step ? rz_new / max(rz, 1e-30) : 0
//   p      = step ? z + beta * p : p;  rz = step ? rz_new : rz
//   it    += 1;  live = (it < max_iters) & any(rr > thresh)
//
// dfl subtracts the real-vertex mean from the singular (null) row and zeroes
// its padding slots; on every other row it is the identity. The two
// deflation products are library GEMMs between the launches (the JAX
// package leaves them to XLA's matmul), made by the wrapper
// (ops/cg_step.py).
//
// What bounds it on an H100: bytes. Every flop is a handful per 4-byte
// value, far below the ~20 flops per byte at which FP32 would bind. One
// iteration must read lap, x, r, p and jacobi and write x, r and p once:
// 8 (rows, n) float32 arrays, 47.5 MB at plane n200 (32 x 46,431), 14 us at
// 3.35 TB/s, plus the Ritz vectors Q for the GEMMs. The torch route makes
// ~30 array passes in ~45 kernels. At n200 each launch is short (4-20 us),
// so the chain of dependent memory round trips inside a launch (the latch,
// the loads, a handshake, the row scalars) weighs as much as the bytes.
//
// Design:
// * The chain waits on four row reductions (den, the null row's mean,
//   rr / rz, and the latch's any()), so it runs as five launches of three
//   bodies. cg_step_walk_kernel sums rows: (1) den from p and lap; (5) z, rr
//   and rz. cg_step_wide_kernel takes 1,024 elements of a row per block: (2)
//   x and r - alpha ap, s * r for the GEMM, on the null row the mean's terms
//   (r * real, kept in z until stage 5 writes it); (6) p, it, live. ap is recomputed in
//   (2) from lap and p (the same arithmetic, the same bits) rather than
//   written and read back. cg_step_null_kernel, one cluster: (3) the null
//   rows' means and their deflation; -- the GEMMs --.
// * The row sums are PyTorch's, bit for bit. A float32 CG is chaotic in
//   its rounding: summed in any other order, n200's solve to tol 1e-4 took
//   1129 outer iterations at other validation points against the torch
//   route's 1131 (H100, this kernel's first version). PyTorch's reduce_kernel
//   (ATen/native/cuda/Reduce.cuh, the same in torch 2.11 and 2.13) sums a
//   contiguous row in a fixed tree on the launch geometry `setReduceConfig`
//   picks (computed by the wrapper, ops/cg_step.py::row_sum_config): a
//   virtual block of bw x bh threads; each thread adds its strided vectors
//   of 4 (after an unaligned head) into 4 accumulators and then adds those;
//   block_x_reduce takes a tree over the bw lanes of each lane row (a warp
//   row when bw = 32), block_y_reduce a tree over the bh lane rows; on long
//   rows `ctas` such blocks split a row and the last to finish sums their
//   values in a third tree (global_reduce). Every product and sum is
//   rounded as PyTorch rounds it (__fmul_rn / __fadd_rn, no contraction into
//   FMAs), and every element a walk visits is also updated there. So the
//   kernel route gives the torch route's bits, and two runs give the same
//   bits: no float atomics, only integer ones for the last-block
//   handshakes, and every handshake counter is back at 0 after each launch
//   (CUDA graphs replay the launches).
// * The split walk. A lane row's value after block_x_reduce depends on its
//   own elements only, so the bh lane rows of one virtual block need not
//   share an SM. The wrapper's plan (ops/cg_step.py::split_plan) gives each
//   physical block `lanes` lane rows of one virtual block, bh / lanes
//   blocks per virtual block. A block runs thread_sums and block_x_reduce
//   for its lane rows exactly as PyTorch's block does (the same indices,
//   stride, head and tail) and hands one value per lane row and sum to the
//   virtual block's block 0, which runs block_y_reduce's tree over the bh
//   values in its order; the global pass follows as PyTorch's. The same
//   additions in the same order, so the same bits; but at n200, where the
//   geometry is one 512-thread virtual block per row (32 blocks on 132
//   SMs), the rows' walks spread over up to 16x as many SMs. The hand-over
//   goes one of two ways (the plan's `cluster`): through distributed shared
//   memory, the virtual block's blocks launched as one thread block
//   cluster; or through a staging slot in device memory, the last block to
//   arrive (integer atomicAdd between fences) doing block 0's part.
// * Bytes in flight. With a few small blocks per SM each thread must keep
//   many loads in flight: it loads `depth` (4 or 8) vectors of every (rows,
//   n) input, 16 bytes each, before it adds any (PyTorch's vectors are
//   16-byte aligned there; the wrapper checks that every such array is).
//   The row scalars the last step needs are loaded before the walk.
// * The null rows in one launch (stages 3 and 4 before): a cluster of 16
//   256-thread blocks finds them, shares out the lane rows of a null row's
//   virtual blocks, meets in block 0 through distributed shared memory for
//   block_y_reduce's tree (and the global pass), and deflates the row
//   across its blocks with the mean block 0 publishes; each thread loads
//   its first elements of r, real and s before the walk.
// * The latch: every block of every launch reads `live` first and returns
//   at once when it is false, so an iteration after convergence launches
//   and does nothing (B1 and the GEMMs between the launches still run).
//   With live false every output keeps its bits.
// * K4-f64. Every body is a template on the element type F: in float64 each
//   product and sum is rounded as PyTorch's double ops round them
//   (__dmul_rn / __dadd_rn ...), a vector is 4 doubles (two 16-byte loads;
//   PyTorch's aligned_vector<double, 4> is 32-byte aligned, so a row's head
//   is the same row_off % 4 elements), and the row sums take PyTorch's
//   reduce geometry for double on the same (rows, n), which the wrapper
//   computes as for float (Reduce.cuh: sum_functor's vt0 = input_vec_size =
//   4 for both, 512 threads a block). The doubles take twice the registers:
//   a walk block holds half the threads of a float one at the same depth
//   (walk_threads), and the wrapper's plan loads 4 vectors deep (as many
//   bytes in flight as 8 floats).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

// Each product and sum rounded alone, as PyTorch's elementwise and reduce
// kernels round them (no contraction into FMAs).
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

constexpr int kThreads = 256;  // the wide body
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;
constexpr int kMaxReduceThreads = 512;
constexpr int kMaxCluster = 16;  // blocks of a cluster (above 8: non-portable, as Hopper allows)
constexpr int kNullBlocks = 16;  // the cluster of stage 3
constexpr int kMaxNullItems = 2048;  // lane rows of a null row's virtual blocks, ctas x bh

// Row scalars in `scal`, each an array of `rows` floats.
enum Scalar { kDenS = 0, kAlpha = 1, kStep = 2, kMeanS = 3, kBeta = 4 };
enum Stage { kDen = 1, kUpdate = 2, kNull = 3, kPrecond = 5, kDirection = 6 };

// PyTorch's ReduceConfig for a float32 or float64 sum over the last axis of a
// contiguous (rows, n) tensor (ops/cg_step.py::row_sum_config), and the
// split plan of the walks (ops/cg_step.py::split_plan).
struct Red {
  int bw, bh;       // block (x, y)
  int vec;          // vectorized input (4 floats per load)
  int im0, im1, im2;  // input_mult: lanes, warps, blocks
  int om1;          // output_mult of the warps (0: the warps share a row)
  int step_in, step_out, ctas;
  int lanes;        // lane rows of a virtual block per physical block
  int depth;        // vectors of each input loaded before any is added
};

// F: float (K4) or double (K4-f64), every array of the state and the leaves.
template <typename F>
struct Args {
  const F* lap;
  F* x;
  F* r;
  F* p;
  F* rz;
  F* rr;
  long long* it;
  unsigned char* live;
  const F* thresh;
  const F* shifts;
  const F* av;
  const F* jacobi;
  const F* s;
  const F* real;
  const F* null_w;
  const F* n_real;
  const F* g;  // G, the deflation product, or nullptr (no deflation)
  F* sr;  // s * r
  F* z;   // z, and the null rows' mean terms from stage 2 to stage 3
  F* staging;  // 2 x V virtual blocks' sums, then 2 x V x bh lane rows' sums
  F* scal;     // (5, rows) row scalars
  unsigned int* counter;  // the last-block handshakes, 0 between launches
  int rows, n, max_iters;
  Red red;
};

// The counters: [0] stage 6's last block; [1, 1 + G) the global pass of
// each output group; [1 + G, 1 + G + V) the lane rows of each virtual block
// (G output groups of `ctas` virtual blocks, V = G ctas).
// ops/cg_step.py::split_plan counts them.
__host__ __device__ __forceinline__ int groups_of(const Red& c, int rows) {
  return (rows + c.step_out - 1) / c.step_out;
}

template <typename F, int N>
struct Vals {
  F v[N];
};

template <typename F, int N>
__device__ __forceinline__ void add_to(Vals<F, N>& acc, const Vals<F, N>& b) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc.v[j] = add_rn(acc.v[j], b.v[j]);
}

template <typename F>
__device__ __forceinline__ F ap_of(F lap, F shift, F av, F p) {
  return -add_rn(lap, mul_rn(mul_rn(shift, av), p));
}

// torch.clamp(v, min=1e-30): NaN stays NaN.
__device__ __forceinline__ float clamp_tiny(float v) { return v < 1e-30f ? 1e-30f : v; }
__device__ __forceinline__ double clamp_tiny(double v) { return v < 1e-30 ? 1e-30 : v; }

// Four consecutive elements, the first 4-element aligned: one 16-byte load
// of floats, two of doubles.
template <typename F>
struct Quad {
  F v[4];
};

__device__ __forceinline__ Quad<float> ld4(const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  return {{q.x, q.y, q.z, q.w}};
}

__device__ __forceinline__ Quad<double> ld4(const double* p) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  return {{a.x, a.y, b.x, b.y}};
}

template <typename F>
__device__ __forceinline__ F at4(const Quad<F>& q, int i) {
  return q.v[i];
}

// ---- PyTorch's row-sum order (Reduce.cuh: ReduceOp::run) ------------------

// Where a thread sits in PyTorch's reduce geometry: lane x and lane row y
// of its virtual block (threadIdx.x = x + y * bw, as a (bw, bh) block
// numbers its threads), the block's output group and its block within a
// split row.
struct Pos {
  int x, y, group, cta;
};

// One thread's partial sums of its row in the order of
// input_vectorized_thread_reduce_impl (n >= 128) or thread_reduce_impl.
// `op.load(e)` reads element e's inputs, `op.load4(e0, in)` those of four
// elements from e0 (16-byte aligned in the (rows, n) arrays), `op.apply(e,
// in)` updates element e and returns its terms of the N sums. The 4-wide
// walk loads D vectors of every input before it adds any.
template <typename F, int N, int D, class Op>
__device__ Vals<F, N> thread_sums(const Red& c, const Pos& t, const Op& op, size_t row_off,
                                  int n, bool tail_ok) {
  using In = typename Op::In;
  Vals<F, N> acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i].v[j] = F(0);
  const int stride = c.step_in;
  int idx = t.x * c.im0 + t.y * c.im1 + t.cta * c.im2;
  if (c.vec) {
    // The row starts where a 16-byte aligned tensor puts element row_off.
    const int shift = static_cast<int>(row_off % 4);
    int end = n, base = 0;
    if (shift > 0) {
      if (t.x >= shift && t.x < 4 && tail_ok) {
        const int e = t.x - shift;
        add_to(acc[0], op.apply(e, op.load(e)));
      }
      end = n + shift - 4;
      base = 4 - shift;
    }
    while (idx * 4 + 3 < end) {
      In a[D][4];
      bool ok[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        ok[d] = (idx + d * stride) * 4 + 3 < end;
        if (ok[d]) op.load4(base + (idx + d * stride) * 4, a[d]);
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (!ok[d]) break;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          add_to(acc[i], op.apply(base + (idx + d * stride) * 4 + i, a[d][i]));
      }
#pragma unroll
      for (int d = 0; d < D; ++d) idx += ok[d] ? stride : 0;
    }
    const int tail_start = end - end % 4;
    if (tail_ok) {
      const int e = tail_start + t.x;
      if (e < end) add_to(acc[0], op.apply(base + e, op.load(base + e)));
    }
  } else {
    while (idx + 3 * stride < n) {
      In a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = op.load(idx + i * stride);
#pragma unroll
      for (int i = 0; i < 4; ++i) add_to(acc[i], op.apply(idx + i * stride, a[i]));
      idx += 4 * stride;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (idx >= n) break;
      add_to(acc[i], op.apply(idx, op.load(idx)));
      idx += stride;
    }
  }
#pragma unroll
  for (int i = 1; i < 4; ++i) add_to(acc[0], acc[i]);
  return acc[0];
}

// The partial sums of virtual thread `t` of row `row` (0 where the thread
// starts past the row's end, as ReduceOp::run leaves them).
template <typename F, int N, int D, class Op>
__device__ Vals<F, N> virtual_thread_sums(const Args<F>& a, const Pos& t, const Op& op, int row) {
  const Red& c = a.red;
  const bool block_y = c.im1 != 0, global = c.im2 != 0;
  const bool tail_ok = (!block_y || t.y == 0) && (!global || t.cta == 0);
  const int idx = t.x * c.im0 + t.y * c.im1 + t.cta * c.im2;
  Vals<F, N> value;
#pragma unroll
  for (int j = 0; j < N; ++j) value.v[j] = F(0);
  if (row < a.rows && idx < a.n)
    value = thread_sums<F, N, D>(c, t, op, static_cast<size_t>(row) * a.n, a.n, tail_ok);
  return value;
}

// block_x_reduce on this block's lane rows: a shared-memory tree down to a
// warp, then a shuffle tree. `x` is the lane, `a` the thread's own slot.
template <typename F>
__device__ F block_x_sum(F value, F* sh, int bw, int x) {
  int dim_x = bw;
  if (dim_x > 32) {
    const int a = threadIdx.x;
    sh[a] = value;
    for (int off = dim_x / 2; off >= 32; off >>= 1) {
      __syncthreads();
      if (x < off && x + off < bw) {
        value = add_rn(value, sh[a + off]);
        sh[a] = value;
      }
    }
    dim_x = 32;
  }
  __syncthreads();
  for (int off = dim_x >> 1; off > 0; off >>= 1)
    value = add_rn(value, __shfl_down_sync(0xffffffffu, value, off));
  return value;
}

// block_y_reduce's tree, on values laid out as its threads' (sh[x + y bw]):
// sh[x + y bw] += sh[x + (y + off) bw] for y < off, off = bh / 2, ..., 1.
// Every thread of the block calls it; sh is complete on return.
template <typename F>
__device__ void tree_y(F* sh, int bw, int bh) {
  for (int off = bh / 2; off > 0; off >>= 1) {
    __syncthreads();
    for (int k = threadIdx.x; k < off * bw; k += blockDim.x)
      sh[k] = add_rn(sh[k], sh[k + off * bw]);
  }
  __syncthreads();
}

// block_x_reduce's tree on `lane_rows` lane rows of sh (the same additions
// as its shared-memory steps and its shuffles): sh[x + y bw] += sh[x + off
// + y bw] for x < off, off = bw / 2, ..., 1.
template <typename F>
__device__ void tree_x(F* sh, int bw, int lane_rows) {
  for (int off = bw / 2; off > 0; off >>= 1) {
    __syncthreads();
    for (int k = threadIdx.x; k < off * lane_rows; k += blockDim.x) {
      const int y = k / off, a = k - y * off + y * bw;
      sh[a] = add_rn(sh[a], sh[a + off]);
    }
  }
  __syncthreads();
}

// global_reduce: the last block of a split row sums the ctas blocks' values
// get(k): virtual thread k of a bw x bh block adds k, k + bw bh, ... from
// 0, then block_y_reduce, then block_x_reduce. The sum is sh[0].
template <typename F, class Get>
__device__ F global_pass(const Red& c, F* sh, const Get& get) {
  const int threads = c.bw * c.bh;
  __syncthreads();
  for (int k = threadIdx.x; k < threads; k += blockDim.x) {
    F v = F(0);
    for (int kk = k; kk < c.ctas; kk += threads) v = add_rn(v, get(kk));
    sh[k] = v;
  }
  tree_y(sh, c.bw, c.bh);
  tree_x(sh, c.bw, 1);
  return sh[0];
}

// Arrive on / wait at the cluster's barrier: split, so that what lies
// between overlaps the other blocks' arrival (every thread of every block
// of the cluster arrives once and waits once per phase).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The N sums of `op` over row `row` of this thread, in PyTorch's order, in
// a walk block of the split plan: this block holds lane rows t.y - (t.y %
// lanes) ... of virtual block (t.group, t.cta). Every thread of the block
// calls it. Returns true in the one thread that holds the row's final sums
// (lane 0 of its lane row when the lane rows own rows; else thread 0 of
// block 0 of the virtual block, or of the last block to finish). The lane
// rows' values meet in the virtual block's block 0, which sums them: with
// kCluster the virtual block is a thread block cluster and they go there
// through distributed shared memory (the caller arrived on the cluster's
// barrier when it started); else through `staging`, the last block to
// arrive (an integer atomicAdd between fences) taking block 0's place.
template <typename F, int N, int D, bool kCluster, class Op>
__device__ bool row_sums(const Args<F>& a, const Pos& t, const Op& op, int row, Vals<F, N>& out) {
  __shared__ F sh[kMaxReduceThreads];
  __shared__ F slots[2 * kMaxReduceThreads];
  __shared__ bool last;
  const Red& c = a.red;
  Vals<F, N> value = virtual_thread_sums<F, N, D>(a, t, op, row);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    __syncthreads();
    value.v[j] = block_x_sum(value.v[j], sh, c.bw, t.x);
  }
  if (c.im1 == 0) {  // the lane rows own rows: no block_y_reduce
    out = value;
    return row < a.rows && t.x == 0;
  }
  const int groups = groups_of(c, a.rows), V = groups * c.ctas;
  const int v = t.group * c.ctas + t.cta, parts = c.bh / c.lanes;
  if (parts == 1) {  // the whole virtual block: its tree in shared memory
#pragma unroll
    for (int j = 0; j < N; ++j) {
      __syncthreads();
      if (t.x == 0) sh[t.y] = value.v[j];
      tree_y(sh, 1, c.bh);
      value.v[j] = sh[0];
    }
  } else if (kCluster) {
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    F* slots0 = cluster.map_shared_rank(slots, 0);
    cluster_wait();  // block 0 has started
    if (t.x == 0) {
#pragma unroll
      for (int j = 0; j < N; ++j) slots0[j * c.bh + t.y] = value.v[j];
    }
    cluster.sync();
    if (cluster.block_rank() != 0) return false;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      for (int k = threadIdx.x; k < c.bh; k += blockDim.x) sh[k] = slots[j * c.bh + k];
      tree_y(sh, 1, c.bh);
      value.v[j] = sh[0];
      __syncthreads();
    }
  } else {
    F* lane_st = a.staging + 2 * V;
    if (t.x == 0) {
#pragma unroll
      for (int j = 0; j < N; ++j) lane_st[(j * V + v) * c.bh + t.y] = value.v[j];
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(a.counter + 1 + groups + v, 1u) == static_cast<unsigned int>(parts - 1);
    __syncthreads();
    if (!last) return false;
    __threadfence();
#pragma unroll
    for (int j = 0; j < N; ++j) {
      __syncthreads();
      for (int k = threadIdx.x; k < c.bh; k += blockDim.x)
        sh[k] = __ldcg(lane_st + (j * V + v) * c.bh + k);
      tree_y(sh, 1, c.bh);
      value.v[j] = sh[0];
    }
    if (threadIdx.x == 0) a.counter[1 + groups + v] = 0;
  }
  if (c.im2 == 0) {
    out = value;
    return row < a.rows && threadIdx.x == 0;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) a.staging[j * V + v] = value.v[j];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(a.counter + 1 + t.group, 1u) == static_cast<unsigned int>(c.ctas - 1);
  __syncthreads();
  if (!last) return false;
  __threadfence();
  const F* cta_st = a.staging + t.group * c.ctas;
#pragma unroll
  for (int j = 0; j < N; ++j)
    value.v[j] = global_pass(c, sh, [&](int k) { return __ldcg(cta_st + j * V + k); });
  if (threadIdx.x == 0) a.counter[1 + t.group] = 0;
  out = value;
  return row < a.rows && threadIdx.x == 0;
}

// ---- the stages' elementwise work -----------------------------------------

template <typename F>
struct DenOp {  // stage 1: the terms p * ap of den
  const Args<F>& a;
  size_t row;
  F shift;
  struct In {
    F p, lap, av;
  };
  __device__ In load(int e) const { return {a.p[row + e], a.lap[row + e], a.av[e]}; }
  __device__ void load4(int e, In* in) const {
    const Quad<F> p = ld4(a.p + row + e), l = ld4(a.lap + row + e);
#pragma unroll
    for (int i = 0; i < 4; ++i) in[i] = {at4(p, i), at4(l, i), a.av[e + i]};
  }
  __device__ Vals<F, 1> apply(int, const In& in) const {
    return {{mul_rn(in.p, ap_of(in.lap, shift, in.av, in.p))}};
  }
};

template <typename F>
struct MeanOp {  // stage 3: the null row's mean terms r * real, left in z by stage 2
  const Args<F>& a;
  size_t row;
  struct In {
    F t;
  };
  __device__ In load(int e) const { return {a.z[row + e]}; }
  __device__ void load4(int e, In* in) const {
    const Quad<F> t = ld4(a.z + row + e);
#pragma unroll
    for (int i = 0; i < 4; ++i) in[i] = {at4(t, i)};
  }
  __device__ Vals<F, 1> apply(int, const In& in) const { return {{in.t}}; }
};

template <typename F>
struct PrecondOp {  // stage 5: z, and the terms of rr and rz
  const Args<F>& a;
  size_t row;
  struct In {
    F r, j, g, s;
  };
  __device__ In load(int e) const {
    return {a.r[row + e], a.jacobi[row + e], a.g ? a.g[row + e] : F(0), a.g ? a.s[e] : F(0)};
  }
  __device__ void load4(int e, In* in) const {
    const Quad<F> r = ld4(a.r + row + e), j = ld4(a.jacobi + row + e);
    const Quad<F> g = a.g ? ld4(a.g + row + e) : Quad<F>{{F(0), F(0), F(0), F(0)}};
#pragma unroll
    for (int i = 0; i < 4; ++i) in[i] = {at4(r, i), at4(j, i), at4(g, i), a.g ? a.s[e + i] : F(0)};
  }
  __device__ Vals<F, 2> apply(int e, const In& in) const {
    F z = mul_rn(in.j, in.r);
    if (a.g) z = add_rn(z, mul_rn(in.s, in.g));
    a.z[row + e] = z;
    return {{mul_rn(in.r, in.r), mul_rn(in.r, z)}};
  }
};

// True in every thread of the last block of the launch to get here.
__device__ bool last_to_arrive(unsigned int* counter) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  return last;
}

// At most 128 registers a thread at 512 threads: 8 vectors deep takes
// blocks of at most 256; doubles, twice the registers, half the threads
// (ops/cg_step.py::WALK_THREADS).
template <typename F, int D>
constexpr int walk_threads() {
  return (D <= 4 ? kMaxReduceThreads : kMaxReduceThreads / 2) / (sizeof(F) == 8 ? 2 : 1);
}

// Stages 1 and 5: one block per `lanes` lane rows of a virtual block of
// PyTorch's reduce geometry (`Red`), the blocks of a virtual block adjacent
// (with kCluster, a cluster). The row scalars the last step reads are
// loaded before the walk.
template <typename F, int D, bool kCluster>
__device__ __forceinline__ void walk(const Args<F>& a, int stage) {
  if (!*a.live) return;
  const Red& c = a.red;
  const int rows = a.rows, parts = c.bh / c.lanes;
  if (kCluster && c.im1 != 0 && parts > 1) cluster_arrive();
  const int v = blockIdx.x / parts, part = blockIdx.x - v * parts;
  const Pos t{static_cast<int>(threadIdx.x) % c.bw,
              part * c.lanes + static_cast<int>(threadIdx.x) / c.bw, v / c.ctas, v % c.ctas};
  const int row = t.y * c.om1 + t.group * c.step_out, rm = row < rows ? row : 0;
  const size_t off = static_cast<size_t>(rm) * a.n;
  F* step_s = a.scal + kStep * rows;
  const F rz_old = a.rz[rm];
  if (stage == kDen) {
    const bool active = a.rr[rm] > a.thresh[rm];  // live holds here
    Vals<F, 1> den;
    if (row_sums<F, 1, D, kCluster>(a, t, DenOp<F>{a, off, a.shifts[rm]}, row, den)) {
      const bool step = active && den.v[0] > F(0);
      a.scal[kDenS * rows + row] = den.v[0];
      a.scal[kAlpha * rows + row] = step ? div_rn(rz_old, clamp_tiny(den.v[0])) : F(0);
      step_s[row] = step ? F(1) : F(0);
    }
  } else if (stage == kPrecond) {
    const bool step = step_s[rm] > F(0.5);
    Vals<F, 2> sums;
    if (row_sums<F, 2, D, kCluster>(a, t, PrecondOp<F>{a, off}, row, sums)) {
      a.scal[kBeta * rows + row] = step ? div_rn(sums.v[1], clamp_tiny(rz_old)) : F(0);
      a.rz[row] = step ? sums.v[1] : rz_old;
      a.rr[row] = sums.v[0];
    }
  }
}

template <int D, bool kCluster>
__global__ void __launch_bounds__(walk_threads<float, D>())
    cg_step_walk_kernel(Args<float> a, int stage) {
  walk<float, D, kCluster>(a, stage);
}

template <int D, bool kCluster>
__global__ void __launch_bounds__(walk_threads<double, D>())
    cg_step_f64_walk_kernel(Args<double> a, int stage) {
  walk<double, D, kCluster>(a, stage);
}

// Stage 3, the null rows: one cluster of kNullBlocks blocks of T threads
// finds them (`null` > 0, in row order) and, for each, sums its mean terms
// r * real (left in z by stage 2) in PyTorch's order and deflates it. Its
// blocks share out the lane rows of the row's virtual blocks (each lane
// row's thread sums and block_x_reduce as in PyTorch's block, D vectors
// deep); the values meet in block 0's shared memory through distributed
// shared memory, block 0 runs block_y_reduce's tree for each virtual block
// (and the global pass over a split row's) and publishes the mean; then
// every block deflates its share of the row: r - null * mean, padding
// slots zeroed, and s * r. The latch, the first rows' flags and n_real are
// read together, a thread's first E elements of the share before the walk.
// Doubles hold half as many of each in the same registers.
template <typename F, int T>
struct NullShape {
  static constexpr int kScale = sizeof(F) / sizeof(float);
  static constexpr int D = (T <= 256 ? 16 : 8) / kScale;  // vectors of the walk in flight
  static constexpr int E = (T <= 256 ? 12 : 6) / kScale;  // elements of the deflation held
};

template <typename F, int T>
__device__ void null_row(const Args<F>& a, F* vals, F* sh, F* mean_sh, F n_real, int m) {
  constexpr int kD = NullShape<F, T>::D, kE = NullShape<F, T>::E;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const Red& c = a.red;
  const int rank = static_cast<int>(cluster.block_rank()), blocks = kNullBlocks;
  const int step = blocks * T;
  const int first = rank * T + static_cast<int>(threadIdx.x);
  const size_t base = static_cast<size_t>(m) * a.n;
  cluster_arrive();  // this block has started (wait: before writing into block 0)
  F rv[kE], realv[kE], sv[kE];
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    const int e = first + k * step;
    rv[k] = e < a.n ? a.r[base + e] : F(0);
    realv[k] = e < a.n ? a.real[e] : F(0);
    sv[k] = e < a.n ? a.s[e] : F(0);
  }
  const F nl = a.null_w[m];
  // The lane rows: item i = (cta, lane row) of the row's virtual blocks
  // (the row's own lane row alone where the lane rows own rows), item i in
  // lane-row slot i mod (blocks x slots) of the cluster.
  const bool block_y = c.im1 != 0;
  const int group = m / c.step_out, items = block_y ? c.ctas * c.bh : 1;
  const int x = static_cast<int>(threadIdx.x) % c.bw, ly = static_cast<int>(threadIdx.x) / c.bw;
  const int slots = blocks * (T / c.bw);
  const MeanOp<F> op{a, base};
  F* vals0 = cluster.map_shared_rank(vals, 0);
  for (int i0 = 0; i0 < items; i0 += slots) {
    const int i = i0 + ly * blocks + rank;
    const Pos t = block_y ? Pos{x, i % c.bh, group, i / c.bh}
                          : Pos{x, m - group * c.step_out, group, 0};
    const F value = i < items ? virtual_thread_sums<F, 1, kD>(a, t, op, m).v[0] : F(0);
    __syncthreads();
    const F lane_sum = block_x_sum(value, sh, c.bw, x);
    if (i0 == 0) cluster_wait();
    if (i < items && x == 0) vals0[block_y ? t.y * c.ctas + t.cta : 0] = lane_sum;
  }
  cluster.sync();  // every lane row's value is in block 0
  if (rank == 0) {
    F sum = vals[0];
    if (block_y) {
      tree_y(vals, c.ctas, c.bh);  // block_y_reduce of each virtual block, side by side
      sum = c.ctas == 1 ? vals[0] : global_pass(c, sh, [&](int k) { return vals[k]; });
    }
    if (threadIdx.x == 0) {
      *mean_sh = div_rn(sum, n_real);
      a.scal[kMeanS * a.rows + m] = *mean_sh;
    }
  }
  cluster.sync();
  const F shift_mean = mul_rn(nl, *cluster.map_shared_rank(mean_sh, 0));
  cluster_arrive();  // done with block 0's shared memory
  for (int e0 = first; e0 < a.n; e0 += kE * step) {
    if (e0 != first) {
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        const int e = e0 + k * step;
        rv[k] = e < a.n ? a.r[base + e] : F(0);
        realv[k] = e < a.n ? a.real[e] : F(0);
        sv[k] = e < a.n ? a.s[e] : F(0);
      }
    }
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      const int e = e0 + k * step;
      if (e >= a.n) break;
      const F r2 = mul_rn(sub_rn(rv[k], shift_mean), realv[k]);
      a.r[base + e] = r2;
      a.sr[base + e] = mul_rn(sv[k], r2);
    }
  }
  cluster_wait();
}

// T threads a block: 256, or 512 where a lane row is that wide (one row).
template <typename F, int T>
__device__ __forceinline__ void null_rows(const Args<F>& a) {
  __shared__ F vals[kMaxNullItems];
  __shared__ F sh[kMaxReduceThreads];
  __shared__ int flags[T];
  __shared__ F mean_sh;
  const bool live = *a.live;
  const int rows = a.rows, lane = static_cast<int>(threadIdx.x) & 31;
  bool null_flag = static_cast<int>(threadIdx.x) < rows && a.null_w[threadIdx.x] > F(0);
  const F n_real = *a.n_real;
  if (!live) return;
  for (int first = 0; first < rows; first += T) {
    __syncthreads();
    if (first > 0) {
      const int mm = first + static_cast<int>(threadIdx.x);
      null_flag = mm < rows && a.null_w[mm] > F(0);
    }
    flags[threadIdx.x] = null_flag;
    __syncthreads();
    for (int w = 0; w < T && first + w < rows; w += 32) {
      unsigned int mask = __ballot_sync(0xffffffffu, flags[w + lane] != 0);
      while (mask) {  // the same rows in the same order in every block
        const int m = first + w + __ffs(mask) - 1;
        mask &= mask - 1;
        null_row<F, T>(a, vals, sh, &mean_sh, n_real, m);
      }
    }
  }
}

template <int T>
__global__ void __launch_bounds__(T) cg_step_null_kernel(Args<float> a) {
  null_rows<float, T>(a);
}

template <int T>
__global__ void __launch_bounds__(T) cg_step_f64_null_kernel(Args<double> a) {
  null_rows<double, T>(a);
}

// Stages 2 and 6: 256 threads, 4 elements each, on 1,024 elements of the
// row blockIdx.y.
template <typename F>
__device__ __forceinline__ void wide(const Args<F>& a, int stage) {
  if (!*a.live) return;
  const int rows = a.rows;
  const int v0 = blockIdx.x * kChunk + threadIdx.x;
  const F* step_s = a.scal + kStep * rows;
  if (stage == kUpdate) {
    const int m = blockIdx.y;
    const size_t base = static_cast<size_t>(m) * a.n;
    const F shift = a.shifts[m], alpha = a.scal[kAlpha * rows + m];
    const bool null_row = a.null_w[m] > F(0);
    const F* w = null_row ? a.real : a.s;
    F* out = null_row ? a.z : a.sr;
    F pv[kPerThread], lv[kPerThread], avv[kPerThread], xv[kPerThread], rv[kPerThread],
        wv[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int v = v0 + i * kThreads;
      const bool in = v < a.n;
      pv[i] = in ? a.p[base + v] : F(0);
      lv[i] = in ? a.lap[base + v] : F(0);
      avv[i] = in ? a.av[v] : F(0);
      xv[i] = in ? a.x[base + v] : F(0);
      rv[i] = in ? a.r[base + v] : F(0);
      wv[i] = in ? w[v] : F(0);
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int v = v0 + i * kThreads;
      if (v >= a.n) break;
      const F ap = ap_of(lv[i], shift, avv[i], pv[i]);
      a.x[base + v] = add_rn(xv[i], mul_rn(alpha, pv[i]));
      const F r1 = sub_rn(rv[i], mul_rn(alpha, ap));
      a.r[base + v] = r1;
      // s * r (dfl is the identity off the null row); on the null row the
      // terms r * real of its mean, which stage 3 sums, in z (free until
      // stage 5): stage 3 writes the row's s * r while its blocks read them.
      out[base + v] = mul_rn(wv[i], r1);
    }
    return;
  }
  if (stage != kDirection) return;
  const int m = blockIdx.y;
  const size_t base = static_cast<size_t>(m) * a.n;
  if (step_s[m] > F(0.5)) {
    const F beta = a.scal[kBeta * rows + m];
    F zv[kPerThread], pv[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int v = v0 + i * kThreads;
      zv[i] = v < a.n ? a.z[base + v] : F(0);
      pv[i] = v < a.n ? a.p[base + v] : F(0);
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int v = v0 + i * kThreads;
      if (v < a.n) a.p[base + v] = add_rn(zv[i], mul_rn(beta, pv[i]));
    }
  }
  if (!last_to_arrive(a.counter)) return;
  if (threadIdx.x == 0) {
    // Every block has read `live` before it arrived: the latch moves now.
    const long long it = *a.it + 1;
    bool any = false;
    for (int mm = 0; mm < rows; ++mm) any = any || a.rr[mm] > a.thresh[mm];
    *a.it = it;
    *a.live = (it < a.max_iters && any) ? 1 : 0;
    *a.counter = 0;
  }
}

__global__ void __launch_bounds__(kThreads) cg_step_wide_kernel(Args<float> a, int stage) {
  wide<float>(a, stage);
}

__global__ void __launch_bounds__(kThreads) cg_step_f64_wide_kernel(Args<double> a, int stage) {
  wide<double>(a, stage);
}

// A launch of `kernel` on `st` in clusters of `cluster` blocks.
template <class... Params>
cudaError_t launch_clusters(void (*kernel)(Params...), int blocks, int threads, int cluster,
                            cudaStream_t st, Params... params) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cluster > 8) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  return cudaLaunchKernelEx(&cfg, kernel, params...);
}

template <typename F, int D>
cudaError_t launch_walk(const Args<F>& a, int stage, bool cluster, cudaStream_t st) {
  const Red& c = a.red;
  const int threads = c.lanes * c.bw, parts = c.bh / c.lanes;
  cluster = cluster && c.im1 != 0 && parts > 1;  // lane rows to combine across blocks
  if (threads > walk_threads<F, D>() || (cluster && parts > kMaxCluster))
    return cudaErrorInvalidValue;
  const int blocks = groups_of(c, a.rows) * c.ctas * parts;
  if constexpr (std::is_same<F, double>::value) {
    if (cluster)
      return launch_clusters(cg_step_f64_walk_kernel<D, true>, blocks, threads, parts, st, a,
                             stage);
    cg_step_f64_walk_kernel<D, false><<<blocks, threads, 0, st>>>(a, stage);
  } else {
    if (cluster)
      return launch_clusters(cg_step_walk_kernel<D, true>, blocks, threads, parts, st, a, stage);
    cg_step_walk_kernel<D, false><<<blocks, threads, 0, st>>>(a, stage);
  }
  return cudaSuccess;
}

bool is_pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// One launch of `stage` (the C entry points below).
template <typename F>
int run_stage(int stage, const Args<F>& a, const int* red, cudaStream_t st) {
  const Red& c = a.red;
  const bool cluster = red[12] != 0;
  const bool stage_ok = stage == kDen || stage == kUpdate || stage == kNull ||
                        stage == kPrecond || stage == kDirection;
  if (!stage_ok || a.rows < 1 || a.rows > 65535 || a.n < 1 || !is_pow2(c.bw) ||
      !is_pow2(c.bh) || c.bw * c.bh > kMaxReduceThreads || c.step_out < 1 || c.ctas < 1 ||
      !is_pow2(c.lanes) || c.lanes > c.bh || (c.depth != 4 && c.depth != 8) ||
      (c.im1 != 0 && c.ctas * c.bh > kMaxNullItems)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSuccess;
  if (stage == kDen || stage == kPrecond) {
    err = c.depth == 4 ? launch_walk<F, 4>(a, stage, cluster, st)
                       : launch_walk<F, 8>(a, stage, cluster, st);
  } else if (stage == kNull) {
    if constexpr (std::is_same<F, double>::value) {
      err = c.bw <= 256 ? launch_clusters(cg_step_f64_null_kernel<256>, kNullBlocks, 256,
                                          kNullBlocks, st, a)
                        : launch_clusters(cg_step_f64_null_kernel<512>, kNullBlocks, 512,
                                          kNullBlocks, st, a);
    } else {
      err = c.bw <= 256
                ? launch_clusters(cg_step_null_kernel<256>, kNullBlocks, 256, kNullBlocks, st, a)
                : launch_clusters(cg_step_null_kernel<512>, kNullBlocks, 512, kNullBlocks, st, a);
    }
  } else {
    const dim3 grid((a.n + kChunk - 1) / kChunk, a.rows);
    if constexpr (std::is_same<F, double>::value) {
      cg_step_f64_wide_kernel<<<grid, kThreads, 0, st>>>(a, stage);
    } else {
      cg_step_wide_kernel<<<grid, kThreads, 0, st>>>(a, stage);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

Red red_of(const int* red) {
  return Red{red[0], red[1], red[2], red[3],  red[4], red[5],
             red[6], red[7], red[8], red[9], red[10], red[11]};
}

}  // namespace

// C entry points, bound with ctypes (ops/_build.py, ops/cg_step.py). All
// arrays are contiguous float32 (dots_cg_step_f64: float64) except it (one
// int64), live (one byte) and counter (uint32, 0 between launches, at least
// ops/cg_step.py::split_plan's `counters`); g is nullptr without deflation;
// staging holds at least 2 V (1 + bh) elements; red holds the row-sum
// geometry and the split plan (bw, bh, vec, im0, im1, im2, om1, step_in,
// step_out, ctas, lanes, depth, cluster). One launch of stage 1, 2, 3, 5 or 6 on
// `stream` of the current device; returns cudaGetLastError() (0 on
// success); does not synchronise.
extern "C" int dots_cg_step_f32(int stage, const float* lap, float* x, float* r, float* p,
                                float* rz, float* rr, long long* it, unsigned char* live,
                                const float* thresh, const float* shifts, const float* av,
                                const float* jacobi, const float* s, const float* real,
                                const float* null_w, const float* n_real, const float* g,
                                float* sr, float* z, float* staging, float* scal,
                                unsigned int* counter, const int* red, int rows, int n,
                                int max_iters, void* stream) {
  const Args<float> a{lap, x, r, p, rz, rr, it, live, thresh, shifts, av, jacobi, s, real,
                      null_w, n_real, g, sr, z, staging, scal, counter, rows, n, max_iters,
                      red_of(red)};
  return run_stage(stage, a, red, static_cast<cudaStream_t>(stream));
}

extern "C" int dots_cg_step_f64(int stage, const double* lap, double* x, double* r, double* p,
                                double* rz, double* rr, long long* it, unsigned char* live,
                                const double* thresh, const double* shifts, const double* av,
                                const double* jacobi, const double* s, const double* real,
                                const double* null_w, const double* n_real, const double* g,
                                double* sr, double* z, double* staging, double* scal,
                                unsigned int* counter, const int* red, int rows, int n,
                                int max_iters, void* stream) {
  const Args<double> a{lap, x, r, p, rz, rr, it, live, thresh, shifts, av, jacobi, s, real,
                       null_w, n_real, g, sr, z, staging, scal, counter, rows, n, max_iters,
                       red_of(red)};
  return run_stage(stage, a, red, static_cast<cudaStream_t>(stream));
}
