// One inner iteration of the single-device CG phi-solve for Hopper (sm_90a):
// kernel family K4, cg_step_walk_kernel and cg_step_wide_kernel.
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
// ~30 array passes in ~45 kernels.
//
// Design:
// * The chain waits on four row reductions (den, the null row's mean,
//   rr / rz, and the latch's any()), so it runs as six launches of two
//   bodies, `stage` picking the step. cg_step_walk_kernel sums rows:
//   (1) den from p and lap; (3) the null row's mean; (5) z, rr and rz.
//   cg_step_wide_kernel takes 1,024 elements of a row per block: (2) x and
//   r - alpha ap, s * r for the GEMM, on the null row the mean's terms
//   (r * real, kept where s * r goes); (4) the null row deflated and its
//   s * r; -- the GEMMs --; (6) p, it, live. ap is recomputed in (2) from
//   lap and p (the same arithmetic, the same bits) rather than written and
//   read back.
// * The row sums are PyTorch's, bit for bit. A float32 CG is chaotic in
//   its rounding: summed in any other order, n200's solve to tol 1e-4 took
//   1129 outer iterations at other validation points against the torch
//   route's 1131 (H100, this kernel's first version). So the walk kernel
//   visits each row as PyTorch's reduce_kernel visits a contiguous row sum
//   (ATen/native/cuda/Reduce.cuh, the same in torch 2.11 and 2.13: vectors
//   of 4 after an unaligned head, 4 accumulators per thread, a shuffle tree
//   per warp, a shared-memory tree across warps, and, on long rows, several
//   blocks per row summed by the last to finish): the launch geometry is
//   the one `setReduceConfig` picks (computed by the wrapper,
//   ops/cg_step.py::row_sum_config), and every element the walk visits is
//   also updated there. Every product and sum is rounded as PyTorch rounds
//   it (__fmul_rn / __fadd_rn, no contraction into FMAs). So the kernel
//   route gives the torch route's bits, and two runs give the same bits:
//   no float atomics, only integer ones for the last-block handshakes.
// * That geometry puts one block on a row at n200 (32 blocks of 512
//   threads), too few to stream at the card's full rate. So each thread of
//   a walk loads its (rows, n) inputs 16 bytes at a time (PyTorch's vectors
//   are aligned there; the wrapper checks that every such array is) and
//   loads D = 4 vectors of each before it adds any; and the walk of stage 3
//   reads one array of one row. The wide body has the registers of plain
//   elementwise work, so its blocks fill the SMs.
// * The latch: every block of every launch reads `live` first and returns
//   at once when it is false, so an iteration after convergence launches
//   and does nothing (B1 and the GEMMs between the launches still run).
//   With live false every output keeps its bits.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // the wide body
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;
constexpr int kMaxReduceThreads = 512;

// Row scalars in `scal`, each an array of `rows` floats.
enum Scalar { kDenS = 0, kAlpha = 1, kStep = 2, kMeanS = 3, kBeta = 4 };
enum Stage { kDen = 1, kUpdate = 2, kMean = 3, kDeflate = 4, kPrecond = 5, kDirection = 6 };

// PyTorch's ReduceConfig for a float32 sum over the last axis of a
// contiguous (rows, n) tensor (ops/cg_step.py::row_sum_config).
struct Red {
  int bw, bh;       // block (x, y)
  int vec;          // vectorized input (4 floats per load)
  int im0, im1, im2;  // input_mult: lanes, warps, blocks
  int om1;          // output_mult of the warps (0: the warps share a row)
  int step_in, step_out, ctas;
};

struct Args {
  const float* lap;
  float* x;
  float* r;
  float* p;
  float* rz;
  float* rr;
  long long* it;
  unsigned char* live;
  const float* thresh;
  const float* shifts;
  const float* av;
  const float* jacobi;
  const float* s;
  const float* real;
  const float* null_w;
  const float* n_real;
  const float* g;  // G, the deflation product, or nullptr (no deflation)
  float* sr;  // s * r, and the null rows' mean terms between stages 2 and 4
  float* z;
  float* staging;  // (2, gridDim.x * ctas) per-block sums of a row split over blocks
  float* scal;     // (5, rows) row scalars
  unsigned int* counter;  // the last-block handshakes, 0 between launches
  int rows, n, max_iters;
  Red red;
};

template <int N>
struct Vals {
  float v[N];
};

template <int N>
__device__ __forceinline__ void add_to(Vals<N>& acc, const Vals<N>& b) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc.v[j] = __fadd_rn(acc.v[j], b.v[j]);
}

__device__ __forceinline__ float ap_of(float lap, float shift, float av, float p) {
  return -__fadd_rn(lap, __fmul_rn(__fmul_rn(shift, av), p));
}

__device__ __forceinline__ float clamp_tiny(float v) {
  return v < 1e-30f ? 1e-30f : v;  // torch.clamp(v, min=1e-30): NaN stays NaN
}

__device__ __forceinline__ float4 ld4(const float* p) {  // p 16-byte aligned
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at4(const float4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// ---- PyTorch's row-sum order (Reduce.cuh: ReduceOp::run) ------------------

// Where a thread sits in PyTorch's reduce geometry: lane x and warp row y
// of its block (threadIdx.x = x + y * bw, as a (bw, bh) block numbers its
// threads), the block's output group and its block within a split row.
struct Pos {
  int x, y, group, cta;
};

__device__ __forceinline__ Pos pos_of(const Red& c, int group, int cta) {
  return {static_cast<int>(threadIdx.x) % c.bw, static_cast<int>(threadIdx.x) / c.bw, group, cta};
}

// One thread's partial sums of its row in the order of
// input_vectorized_thread_reduce_impl (n >= 128) or thread_reduce_impl.
// `op.load(e)` reads element e's inputs, `op.load4(e0, in)` those of four
// elements from e0 (16-byte aligned in the (rows, n) arrays), `op.apply(e,
// in)` updates element e and returns its terms of the N sums. The 4-wide
// walk loads D vectors of every input before it adds any.
template <int N, int D, class Op>
__device__ Vals<N> thread_sums(const Red& c, const Pos& t, const Op& op, size_t row_off, int n,
                               bool tail_ok) {
  using In = typename Op::In;
  Vals<N> acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i].v[j] = 0.0f;
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

// block_x_reduce: a shared-memory tree down to a warp, then a shuffle tree.
__device__ float block_x_sum(float value, float* sh, const Red& c, const Pos& t) {
  int dim_x = c.bw;
  if (dim_x > 32) {
    const int a = t.x + t.y * c.bw;
    sh[a] = value;
    for (int off = dim_x / 2; off >= 32; off >>= 1) {
      __syncthreads();
      if (t.x < off && t.x + off < c.bw) {
        value = __fadd_rn(value, sh[a + off]);
        sh[a] = value;
      }
    }
    dim_x = 32;
  }
  __syncthreads();
  for (int off = dim_x >> 1; off > 0; off >>= 1)
    value = __fadd_rn(value, __shfl_down_sync(0xffffffffu, value, off));
  return value;
}

// block_y_reduce: a shared-memory tree over the warp rows of a block.
__device__ float block_y_sum(float value, float* sh, const Red& c, const Pos& t) {
  const int a = t.x + t.y * c.bw;
  sh[a] = value;
  for (int off = c.bh / 2; off > 0; off >>= 1) {
    __syncthreads();
    if (t.y < off && t.y + off < c.bh) {
      value = __fadd_rn(value, sh[t.x + (t.y + off) * c.bw]);
      sh[a] = value;
    }
  }
  return value;
}

// The N sums of `op` over row `row` of this thread, in PyTorch's order
// (ReduceOp::run, and global_reduce over the c.ctas blocks of a split row).
// Every thread of the block calls it. Returns true in the one thread that
// holds the row's final sums (x = 0 of the row's warps, in the last block
// of a split row to finish). `summed` false: the walk's updates only
// (`walk` false: none, the op has no updates).
template <int N, int D, class Op>
__device__ bool row_sums(const Args& a, const Pos& t, const Op& op, int row, bool summed,
                         Vals<N>& out, bool walk = true) {
  __shared__ float sh[kMaxReduceThreads];
  __shared__ bool last;
  const Red& c = a.red;
  const bool block_y = c.im1 != 0, global = c.im2 != 0;
  const bool tail_ok = (!block_y || t.y == 0) && (!global || t.cta == 0);
  const int idx = t.x * c.im0 + t.y * c.im1 + t.cta * c.im2;
  Vals<N> value;
#pragma unroll
  for (int j = 0; j < N; ++j) value.v[j] = 0.0f;
  if (walk && row < a.rows && idx < a.n) {
    const Vals<N> s = thread_sums<N, D>(c, t, op, static_cast<size_t>(row) * a.n, a.n, tail_ok);
    if (summed) value = s;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    __syncthreads();
    value.v[j] = block_x_sum(value.v[j], sh, c, t);
    if (block_y) value.v[j] = block_y_sum(value.v[j], sh, c, t);
  }
  const bool store = row < a.rows && t.x == 0 && (!block_y || t.y == 0);
  if (!global) {
    out = value;
    return store;
  }
  const int groups = (a.rows + c.step_out - 1) / c.step_out;
  const int slots = groups * c.ctas;
  if (store) {
#pragma unroll
    for (int j = 0; j < N; ++j) a.staging[j * slots + t.cta + t.group * c.ctas] = value.v[j];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.counter + 1 + t.group, 1u) == c.ctas - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float v = 0.0f;
    for (int k = t.x + t.y * c.bw; k < c.ctas; k += c.bw * c.bh)
      v = __fadd_rn(v, __ldcg(a.staging + j * slots + k + t.group * c.ctas));
    __syncthreads();
    v = block_y_sum(v, sh, c, t);
    value.v[j] = block_x_sum(v, sh, c, t);
  }
  if (threadIdx.x == 0) a.counter[1 + t.group] = 0;
  out = value;
  return store;
}

// ---- the stages' elementwise work -----------------------------------------

struct DenOp {  // stage 1: the terms p * ap of den
  const Args& a;
  size_t row;
  float shift;
  struct In {
    float p, lap, av;
  };
  __device__ In load(int e) const { return {a.p[row + e], a.lap[row + e], a.av[e]}; }
  __device__ void load4(int e, In* in) const {
    const float4 p = ld4(a.p + row + e), l = ld4(a.lap + row + e);
#pragma unroll
    for (int i = 0; i < 4; ++i) in[i] = {at4(p, i), at4(l, i), a.av[e + i]};
  }
  __device__ Vals<1> apply(int, const In& in) const {
    return {{__fmul_rn(in.p, ap_of(in.lap, shift, in.av, in.p))}};
  }
};

struct MeanOp {  // stage 3: the null row's mean terms r * real, as stage 2 left them
  const Args& a;
  size_t row;
  struct In {
    float t;
  };
  __device__ In load(int e) const { return {a.sr[row + e]}; }
  __device__ void load4(int e, In* in) const {
    const float4 t = ld4(a.sr + row + e);
#pragma unroll
    for (int i = 0; i < 4; ++i) in[i] = {at4(t, i)};
  }
  __device__ Vals<1> apply(int, const In& in) const { return {{in.t}}; }
};

struct PrecondOp {  // stage 5: z, and the terms of rr and rz
  const Args& a;
  size_t row;
  struct In {
    float r, j, g, s;
  };
  __device__ In load(int e) const {
    return {a.r[row + e], a.jacobi[row + e], a.g ? a.g[row + e] : 0.0f, a.g ? a.s[e] : 0.0f};
  }
  __device__ void load4(int e, In* in) const {
    const float4 r = ld4(a.r + row + e), j = ld4(a.jacobi + row + e);
    const float4 g = a.g ? ld4(a.g + row + e) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < 4; ++i) in[i] = {at4(r, i), at4(j, i), at4(g, i), a.g ? a.s[e + i] : 0.0f};
  }
  __device__ Vals<2> apply(int e, const In& in) const {
    float z = __fmul_rn(in.j, in.r);
    if (a.g) z = __fadd_rn(z, __fmul_rn(in.s, in.g));
    a.z[row + e] = z;
    return {{__fmul_rn(in.r, in.r), __fmul_rn(in.r, z)}};
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

// Stages 1, 3 and 5: grid (output groups, blocks per row), PyTorch's
// reduce geometry (`Red`).
__global__ void __launch_bounds__(kMaxReduceThreads) cg_step_walk_kernel(Args a, int stage) {
  if (!*a.live) return;
  const Red& c = a.red;
  const int rows = a.rows;
  const Pos t = pos_of(c, blockIdx.x, blockIdx.y);
  const int row = t.y * c.om1 + t.group * c.step_out, rm = row < rows ? row : 0;
  const size_t off = static_cast<size_t>(rm) * a.n;
  float* step_s = a.scal + kStep * rows;
  if (stage == kDen) {
    Vals<1> den;
    if (row_sums<1, 4>(a, t, DenOp{a, off, a.shifts[rm]}, row, true, den)) {
      const bool step = a.rr[row] > a.thresh[row] && den.v[0] > 0.0f;  // live holds here
      a.scal[kDenS * rows + row] = den.v[0];
      a.scal[kAlpha * rows + row] = step ? __fdiv_rn(a.rz[row], clamp_tiny(den.v[0])) : 0.0f;
      step_s[row] = step ? 1.0f : 0.0f;
    }
  } else if (stage == kMean) {
    const bool null_row = a.null_w[rm] > 0.0f;
    Vals<1> sum;
    if (row_sums<1, 4>(a, t, MeanOp{a, off}, row, null_row, sum, null_row) && null_row) {
      a.scal[kMeanS * rows + row] = __fdiv_rn(sum.v[0], *a.n_real);
    }
  } else if (stage == kPrecond) {
    Vals<2> sums;
    if (row_sums<2, 4>(a, t, PrecondOp{a, off}, row, true, sums)) {
      const bool step = step_s[row] > 0.5f;
      const float rz_old = a.rz[row];
      a.scal[kBeta * rows + row] = step ? __fdiv_rn(sums.v[1], clamp_tiny(rz_old)) : 0.0f;
      a.rz[row] = step ? sums.v[1] : rz_old;
      a.rr[row] = sums.v[0];
    }
  }
}

// Stages 2, 4 and 6: 256 threads, 4 elements each, on 1,024 elements of
// the row blockIdx.y (of every null row in stage 4).
__global__ void __launch_bounds__(kThreads) cg_step_wide_kernel(Args a, int stage) {
  if (!*a.live) return;
  const int rows = a.rows;
  const int v0 = blockIdx.x * kChunk + threadIdx.x;
  const float* step_s = a.scal + kStep * rows;
  if (stage == kUpdate) {
    const int m = blockIdx.y;
    const size_t base = static_cast<size_t>(m) * a.n;
    const float shift = a.shifts[m], alpha = a.scal[kAlpha * rows + m];
    const bool null_row = a.null_w[m] > 0.0f;
    const float* w = null_row ? a.real : a.s;
    float pv[kPerThread], lv[kPerThread], avv[kPerThread], xv[kPerThread], rv[kPerThread],
        wv[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int v = v0 + i * kThreads;
      const bool in = v < a.n;
      pv[i] = in ? a.p[base + v] : 0.0f;
      lv[i] = in ? a.lap[base + v] : 0.0f;
      avv[i] = in ? a.av[v] : 0.0f;
      xv[i] = in ? a.x[base + v] : 0.0f;
      rv[i] = in ? a.r[base + v] : 0.0f;
      wv[i] = in ? w[v] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int v = v0 + i * kThreads;
      if (v >= a.n) break;
      const float ap = ap_of(lv[i], shift, avv[i], pv[i]);
      a.x[base + v] = __fadd_rn(xv[i], __fmul_rn(alpha, pv[i]));
      const float r1 = __fsub_rn(rv[i], __fmul_rn(alpha, ap));
      a.r[base + v] = r1;
      // s * r (dfl is the identity off the null row); on the null row the
      // terms r * real of its mean, which stage 3 sums.
      a.sr[base + v] = __fmul_rn(wv[i], r1);
    }
    return;
  }
  if (stage == kDeflate) {  // the null rows: r - null * mean, padding slots zeroed
    for (int mm = 0; mm < rows; ++mm) {
      const float nl = a.null_w[mm];
      if (!(nl > 0.0f)) continue;
      const size_t base = static_cast<size_t>(mm) * a.n;
      const float shift_mean = __fmul_rn(nl, a.scal[kMeanS * rows + mm]);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int v = v0 + i * kThreads;
        if (v >= a.n) break;
        const float r2 = __fmul_rn(__fsub_rn(a.r[base + v], shift_mean), a.real[v]);
        a.r[base + v] = r2;
        a.sr[base + v] = __fmul_rn(a.s[v], r2);
      }
    }
    return;
  }
  if (stage != kDirection) return;
  const int m = blockIdx.y;
  const size_t base = static_cast<size_t>(m) * a.n;
  if (step_s[m] > 0.5f) {
    const float beta = a.scal[kBeta * rows + m];
    float zv[kPerThread], pv[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int v = v0 + i * kThreads;
      zv[i] = v < a.n ? a.z[base + v] : 0.0f;
      pv[i] = v < a.n ? a.p[base + v] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int v = v0 + i * kThreads;
      if (v < a.n) a.p[base + v] = __fadd_rn(zv[i], __fmul_rn(beta, pv[i]));
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

}  // namespace

// C entry point, bound with ctypes (ops/_build.py, ops/cg_step.py). All
// arrays are contiguous float32 except it (one int64), live (one byte) and
// counter (uint32: 1 + the reduce grid's blocks along x, 0 between
// launches); g is nullptr without deflation; red holds the row-sum geometry
// (bw, bh, vec, im0, im1, im2, om1, step_in, step_out, ctas). One launch of
// stage 1-6 on `stream` of the current device; returns cudaGetLastError()
// (0 on success); does not synchronise.
extern "C" int dots_cg_step_f32(int stage, const float* lap, float* x, float* r, float* p,
                                float* rz, float* rr, long long* it, unsigned char* live,
                                const float* thresh, const float* shifts, const float* av,
                                const float* jacobi, const float* s, const float* real,
                                const float* null_w, const float* n_real, const float* g,
                                float* sr, float* z, float* staging, float* scal,
                                unsigned int* counter, const int* red, int rows, int n,
                                int max_iters, void* stream) {
  const Red c{red[0], red[1], red[2], red[3], red[4], red[5], red[6], red[7], red[8], red[9]};
  if (stage < kDen || stage > kDirection || rows < 1 || rows > 65535 || n < 1 || c.bw < 1 ||
      c.bh < 1 || c.bw * c.bh > kMaxReduceThreads || c.step_out < 1 || c.ctas < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{lap, x, r, p, rz, rr, it, live, thresh, shifts, av, jacobi, s, real, null_w, n_real,
         g, sr, z, staging, scal, counter, rows, n, max_iters, c};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stage == kDen || stage == kMean || stage == kPrecond) {
    const dim3 grid((rows + c.step_out - 1) / c.step_out, c.ctas);
    cg_step_walk_kernel<<<grid, c.bw * c.bh, 0, st>>>(a, stage);
  } else {
    const dim3 grid((n + kChunk - 1) / kChunk, stage == kDeflate ? 1 : rows);
    cg_step_wide_kernel<<<grid, kThreads, 0, st>>>(a, stage);
  }
  return static_cast<int>(cudaGetLastError());
}
