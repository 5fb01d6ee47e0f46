// The iALM step after the phi solve for Hopper (sm_90a): kernel K6,
// ialm_cone_kernel, ialm_vertex_kernel and ialm_face_kernel, one template
// for float32 work with float32 or float64 phi and for float64 work
// (dots_ialm_step).
//
// It replaces what XLA fuses in steps 1b, 2 and 3 of the JAX package's
// iteration (dots_socp_tpu/solver/step.py: the SOC projection, the
// closed-form q/lambda solve and the multiplier ascent), i.e. XLA fusions,
// not a Pallas call; in the port the torch route of the same step is
// solver/step.py::_after_phi. Given the state and the new phi, it computes
// per interval slice t (T of them), vertex v, triangle f, corner k,
// endpoint e and coordinate j, with c = scale_z / sqrt(3):
//
//   to_mid[t,e,f,k,j] = diag[f,k] (c B[t+e,f,j] - beta_mid[t,e,f,k,j])
//   to_fst, to_end    = d -/+ scale_z A - beta_fst / beta_end
//   norm[t,v]  = sqrt(sum over the slots (f,k) of v of sum_{e,j} to_mid^2 + to_end^2)
//   lam        = clip(0.5 (1 + to_fst / max(norm, tiny)), 0, 1)
//   z_fst = lam >= 1 ? to_fst : lam norm;  z_end = lam to_end
//   z_mid = lam[t, tri[f,k]] / diag[f,k] * to_mid
//   dt_phi = (phi[t+1] - phi[t]) / dt;  dx_phi = sum_k phi[t, tri[f,k]] grad_basis[f,k]
//   A, lambda_c from dt_phi + mu and the z's; B from dx_phi + E + c (sums of
//   z_mid + beta_mid over corners, slice t endpoint 0 and slice t-1 endpoint 1)
//   mu, E, beta_* += tau (their residuals, with the new A, B, z)
//
// and writes every output once, in place, into the array that holds it
// (the graph workspace's buffers): z_fst, z_mid, z_end, dt_phi, dx_phi, A,
// B, lambda_c, mu, E, beta_fst, beta_mid, beta_end.
//
// What bounds it on an H100: bytes. At plane n200 (T = 31, F = 91,885) the
// two (T, 2, F, 3, 3) blocks hold 205 MB each in float32; the step must read
// beta_mid and write z_mid and beta_mid (the old z_mid is never read), and
// read and write the (T+1, F, 3) and (T, V) arrays: ~1.1 GB with beta_mid
// read twice, ~0.33 ms at 3.35 TB/s. The torch route passes over the blocks
// about seven times more.
//
// Design:
// * Two grid-wide joins: the cone norms sum triangle slots into vertices,
//   and lam goes back from vertices to slots. So three launches:
//   (1) ialm_cone_kernel, per (t, f, k): to_mid in registers, and only its
//       squares summed over (e, j) written, sq (T, F, 3);
//   (2) ialm_vertex_kernel, per (t, v): the incidence-table sum of sq, the
//       cone (norm, lam, z_fst, z_end), dt_phi, A, lambda_c, mu, beta_fst,
//       beta_end, and lam for (3);
//   (3) ialm_face_kernel, per (t, f, j), t = 0 .. T: dx_phi, and the mid
//       elements (t, 0, f, k, j) and (t - 1, 1, f, k, j). Both read the old
//       B[t] only (c B[t+e] with t+e = t), and after the new B[t] is made
//       both take their ascent from it alone: so every mid element belongs
//       to one thread, which reads beta_mid once and writes z_mid and
//       beta_mid once, and B[t], E[t] and dx_phi[t] are that thread's too.
//       No slice waits for another.
//   Every thread writes only what it alone reads, so the update in place
//   needs no second buffer.
// * Bit-equal to the torch route. Every product, sum, quotient and square
//   root is rounded alone as PyTorch's elementwise kernels round it
//   (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn, no contraction into
//   FMAs; the double forms for float64), in the torch code's order of
//   operations; the scalar factors (scale_z / sqrt(3), 1 / a2, a1 / a2, the
//   diagonal of the B system, cr / (1 + cr)) come computed by the same torch
//   ops (the wrapper, solver/step.py); 1 / dt as PyTorch's division by a
//   Python number takes it (the reciprocal in double, rounded to phi's
//   precision, then a product in that precision: ops/ialm_step.py::inv_dt). The
//   small sums follow PyTorch's reduce_kernel (ATen/native/cuda/Reduce.cuh)
//   on the launch geometry it takes for them:
//   - sum(dim=(1, 4)) of to_mid^2, 6 terms with j fastest: 4 lanes of 1 or
//     2 terms, then the warp's tree: ((x00 + x11) + x02) + ((x01 + x12) + x10);
//   - the vertex sum, D terms along the table's contiguous axis: lanes of
//     bw = last_pow2(D) (D < 64), lane x adds terms x and x + bw, then the
//     tree from bw / 2 down (torch_short_sum, one instance per bw);
//   - sum(dim=3) of z_mid + beta_mid and grad_space's sum over corners, 3
//     terms on a strided axis: one thread adds them in order, then its
//     empty accumulator: ((v0 + v1) + v2) + 0.
//   PyTorch's accumulators start at 0 (0 + x turns -0 into +0); where that
//   can change a bit it is done here too.
// * Coalescing: (1) and (3) take consecutive (f, k) or (f, j) per lane, so
//   a warp's loads of a (T, 2, F, 3, 3) block fall in one contiguous run of
//   ~100 elements per slice and endpoint, which the three loads of a
//   thread's corners or coordinates fill through L1. The gathers (sq by the
//   table, lam and phi by tri) read arrays of a few MB that stay in L2. On
//   an H100 (plane n200) (1) and (2) move their bytes at ~85% of the
//   card's rate and (3) at ~65%; staging (3)'s runs through shared memory
//   for contiguous warp stores made it slower (444 against 351 us): its two
//   barriers a block stop the loads of one block overlapping its own
//   gathers and stores.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Each product, sum, quotient and root rounded alone, as PyTorch's kernels
// round them (no contraction into FMAs).
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float tiny(float) { return 1.17549435e-38f; }  // finfo.tiny
__device__ __forceinline__ double tiny(double) { return 2.2250738585072014e-308; }

// `.to(work dtype)`: rounded to nearest.
template <typename W, typename P>
__device__ __forceinline__ W to_work(P x) { return static_cast<W>(x); }

// torch.clamp(x, lo, hi) and clamp(x, min=lo): NaN passes through.
template <typename W>
__device__ __forceinline__ W clamp_rn(W x, W lo, W hi) {
  return isnan(x) ? x : fmin(fmax(x, lo), hi);
}
template <typename W>
__device__ __forceinline__ W clamp_min_rn(W x, W lo) {
  return isnan(x) ? x : fmax(x, lo);
}

// The scalars the wrapper computes with torch ops, in this order.
enum Scalar { kSz = 0, kC, kTau, kCd, kInvA2, kA1A2, kInterior, kEndpoint, kCl, kScalars };

constexpr int kThreads = 256;
constexpr int kMaxLanes = 32;  // the vertex sum's lanes: D < 2 * 32

template <typename W, typename P>
struct Args {
  W* A;
  W* B;
  W* lambda_c;
  W* z_fst;
  W* z_mid;
  W* z_end;
  W* mu;
  W* E;
  W* beta_fst;
  W* beta_mid;
  W* beta_end;
  W* dt_phi;
  W* dx_phi;
  const P* phi;
  const long long* tri;        // (F, 3)
  const W* grad_basis;         // (F, 3, 3)
  const long long* inc_table;  // (V, D)
  const W* inc_mask;           // (V, D)
  const W* diag_soc;           // (F, 3)
  const W* scal;               // kScalars
  W* sq;                       // (T, F, 3) scratch
  W* lam;                      // (T, V) scratch
  P inv_dt;
  int T, V, F, D;
};

// PyTorch's sum over a contiguous axis of n terms, BW <= n < 2 BW, term(d)
// the d-th (reduce_kernel without vectorized loads: BW = last_pow2(n)
// lanes, lane x holds terms x and x + BW in two of its four accumulators,
// which it then adds in order; the warp's tree from BW / 2 down). BW is a
// template parameter so that the lanes stay in registers.
template <typename W, int BW, typename Term>
__device__ __forceinline__ W torch_short_sum(int n, Term term) {
  W lane[BW];
#pragma unroll
  for (int x = 0; x < BW; ++x) {
    const W a0 = add_rn(W(0), term(x));
    const W a1 = x + BW < n ? add_rn(W(0), term(x + BW)) : W(0);
    lane[x] = add_rn(add_rn(add_rn(a0, a1), W(0)), W(0));
  }
#pragma unroll
  for (int off = BW / 2; off > 0; off /= 2) {
#pragma unroll
    for (int x = 0; x < off; ++x) lane[x] = add_rn(lane[x], lane[x + off]);
  }
  return lane[0];
}

// (1) Per (t, f, k): sq = sum over (e, j) of to_mid^2.
template <typename W, typename P>
__global__ void __launch_bounds__(kThreads) ialm_cone_kernel(const Args<W, P> a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n = 3LL * a.T * a.F;
  if (i >= n) return;
  const long long tf = i / 3;
  const int k = static_cast<int>(i - 3 * tf);
  const int t = static_cast<int>(tf / a.F);
  const long long f = tf - static_cast<long long>(t) * a.F;
  const W c = a.scal[kC];
  const W dg = a.diag_soc[3 * f + k];
  W x[2][3];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const W* b = a.B + 3 * ((t + e) * static_cast<long long>(a.F) + f);
    const W* bm = a.beta_mid + 3 * (3 * ((2LL * t + e) * a.F + f) + k);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const W tm = mul_rn(dg, sub_rn(mul_rn(c, b[j]), bm[j]));
      x[e][j] = mul_rn(tm, tm);
    }
  }
  a.sq[i] = add_rn(add_rn(add_rn(x[0][0], x[1][1]), x[0][2]),
                   add_rn(add_rn(x[0][1], x[1][2]), x[1][0]));
}

// (2) Per (t, v): the cone, step 2's A and lambda_c, step 3's vertex duals;
// BW = last_pow2(D).
template <typename W, typename P, int BW>
__global__ void __launch_bounds__(kThreads) ialm_vertex_kernel(const Args<W, P> a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n = static_cast<long long>(a.T) * a.V;
  if (i >= n) return;
  const int t = static_cast<int>(i / a.V);
  const long long v = i - static_cast<long long>(t) * a.V;
  const W* sq = a.sq + 3LL * a.F * t;
  const long long* row = a.inc_table + v * a.D;
  const W* mask = a.inc_mask + v * a.D;
  const W vr = torch_short_sum<W, BW>(a.D, [&](int d) { return mul_rn(sq[row[d]], mask[d]); });

  const W sz = a.scal[kSz], cd = a.scal[kCd], tau = a.scal[kTau];
  const W a_old = a.A[i], bf_old = a.beta_fst[i], be_old = a.beta_end[i], mu_old = a.mu[i];
  const W sa = mul_rn(sz, a_old);
  const W to_fst = sub_rn(sub_rn(cd, sa), bf_old);
  const W to_end = sub_rn(add_rn(cd, sa), be_old);
  const W norm = sqrt_rn(add_rn(vr, mul_rn(to_end, to_end)));
  const W safe = clamp_min_rn(norm, tiny(W(0)));
  const W lam = clamp_rn(mul_rn(W(0.5), add_rn(div_rn(to_fst, safe), W(1))), W(0), W(1));
  const W zf = lam >= W(1) ? to_fst : mul_rn(lam, norm);
  const W ze = mul_rn(lam, to_end);

  const P* phi = a.phi + static_cast<long long>(t) * a.V + v;
  const W dt = to_work<W>(mul_rn(sub_rn(phi[a.V], phi[0]), a.inv_dt));
  const W memo_a = add_rn(dt, mu_old);
  const W w = sub_rn(sub_rn(add_rn(ze, be_old), zf), bf_old);
  const W a_new = add_rn(mul_rn(a.scal[kInvA2], memo_a), mul_rn(a.scal[kA1A2], w));
  const W lc = mul_rn(a.scal[kCl], sub_rn(memo_a, a_new));
  const W sa_new = mul_rn(sz, a_new);

  a.lam[i] = lam;
  a.z_fst[i] = zf;
  a.z_end[i] = ze;
  a.dt_phi[i] = dt;
  a.A[i] = a_new;
  a.lambda_c[i] = lc;
  a.mu[i] = add_rn(mu_old, mul_rn(tau, sub_rn(sub_rn(dt, a_new), lc)));
  a.beta_fst[i] = add_rn(bf_old, mul_rn(tau, sub_rn(add_rn(zf, sa_new), cd)));
  a.beta_end[i] = add_rn(be_old, mul_rn(tau, sub_rn(sub_rn(ze, sa_new), cd)));
}

// One endpoint's three corners of coordinate j at slice s (e = 0: s = t,
// e = 1: s = t - 1): z_mid, the old beta_mid, and the scaled corner sum
// c * (((z + beta)_0 + (z + beta)_1) + (z + beta)_2 + 0).
template <typename W, typename P>
__device__ __forceinline__ W mid_corners(const Args<W, P>& a, long long off, const long long* v,
                                         const W* dg, int s, W cb, W c, W* z, W* bm) {
  const W* lam = a.lam + static_cast<long long>(s) * a.V;
  W x[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    bm[k] = a.beta_mid[off + 3 * k];
    const W to_mid = mul_rn(dg[k], sub_rn(cb, bm[k]));
    z[k] = mul_rn(div_rn(lam[v[k]], dg[k]), to_mid);
    x[k] = add_rn(z[k], bm[k]);
  }
  return mul_rn(c, add_rn(add_rn(add_rn(x[0], x[1]), x[2]), W(0)));
}

// (3) Per (t, f, j), t = 0 .. T: dx_phi, B, E and the mid elements of
// (t, 0) and (t - 1, 1).
template <typename W, typename P>
__global__ void __launch_bounds__(kThreads) ialm_face_kernel(const Args<W, P> a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n = 3LL * (a.T + 1) * a.F;
  if (i >= n) return;
  const long long tf = i / 3;
  const int j = static_cast<int>(i - 3 * tf);
  const int t = static_cast<int>(tf / a.F);
  const long long f = tf - static_cast<long long>(t) * a.F;
  long long v[3];
  W dg[3];
  P g[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v[k] = a.tri[3 * f + k];
    dg[k] = a.diag_soc[3 * f + k];
    g[k] = static_cast<P>(a.grad_basis[3 * (3 * f + k) + j]);
  }
  const P* phi = a.phi + static_cast<long long>(t) * a.V;
  const W dx = to_work<W>(add_rn(
      add_rn(add_rn(mul_rn(phi[v[0]], g[0]), mul_rn(phi[v[1]], g[1])), mul_rn(phi[v[2]], g[2])),
      P(0)));

  const W c = a.scal[kC], tau = a.scal[kTau];
  const W b_old = a.B[i], e_old = a.E[i];
  const W cb = mul_rn(c, b_old);
  // Element (s, e, f, k, j) of a (T, 2, F, 3, 3) block lies at
  // 9 ((2 s + e) F + f) + 3 k + j.
  const long long off0 = 9 * (2LL * t * a.F + f) + j;
  const long long off1 = 9 * ((2LL * t - 1) * a.F + f) + j;
  W z0[3], b0[3], z1[3], b1[3];
  W m0 = W(0), m1 = W(0);  // the torch route's zero slices at t = T and t = 0
  if (t < a.T) m0 = mid_corners(a, off0, v, dg, t, cb, c, z0, b0);
  if (t > 0) m1 = mid_corners(a, off1, v, dg, t - 1, cb, c, z1, b1);
  const W diag_b = (t == 0 || t == a.T) ? a.scal[kEndpoint] : a.scal[kInterior];
  const W b_new = div_rn(add_rn(add_rn(dx, e_old), add_rn(m0, m1)), diag_b);
  const W cb_new = mul_rn(c, b_new);

  a.dx_phi[i] = dx;
  a.B[i] = b_new;
  a.E[i] = add_rn(e_old, mul_rn(tau, sub_rn(dx, b_new)));
  if (t < a.T) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.z_mid[off0 + 3 * k] = z0[k];
      a.beta_mid[off0 + 3 * k] = add_rn(b0[k], mul_rn(tau, sub_rn(z0[k], cb_new)));
    }
  }
  if (t > 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.z_mid[off1 + 3 * k] = z1[k];
      a.beta_mid[off1 + 3 * k] = add_rn(b1[k], mul_rn(tau, sub_rn(z1[k], cb_new)));
    }
  }
}

unsigned int blocks(long long n) { return static_cast<unsigned int>((n + kThreads - 1) / kThreads); }

int last_pow2(int n) {
  int p = 1;
  while (2 * p <= n) p *= 2;
  return p;
}

// The three launches, in order, on `stream`.
template <typename W, typename P>
int run(const Args<W, P>& a, cudaStream_t stream) {
  if (a.T < 1 || a.V < 1 || a.F < 1 || a.D < 1 || a.D >= 2 * kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ialm_cone_kernel<W, P><<<blocks(3LL * a.T * a.F), kThreads, 0, stream>>>(a);
  const unsigned int grid = blocks(static_cast<long long>(a.T) * a.V);
  switch (last_pow2(a.D)) {
    case 1: ialm_vertex_kernel<W, P, 1><<<grid, kThreads, 0, stream>>>(a); break;
    case 2: ialm_vertex_kernel<W, P, 2><<<grid, kThreads, 0, stream>>>(a); break;
    case 4: ialm_vertex_kernel<W, P, 4><<<grid, kThreads, 0, stream>>>(a); break;
    case 8: ialm_vertex_kernel<W, P, 8><<<grid, kThreads, 0, stream>>>(a); break;
    case 16: ialm_vertex_kernel<W, P, 16><<<grid, kThreads, 0, stream>>>(a); break;
    default: ialm_vertex_kernel<W, P, 32><<<grid, kThreads, 0, stream>>>(a); break;
  }
  ialm_face_kernel<W, P><<<blocks(3LL * (a.T + 1) * a.F), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename W, typename P>
int dispatch(void* const* p, double inv_dt, const int* sizes, cudaStream_t stream) {
  const Args<W, P> a{
      static_cast<W*>(p[0]), static_cast<W*>(p[1]), static_cast<W*>(p[2]),
      static_cast<W*>(p[3]), static_cast<W*>(p[4]), static_cast<W*>(p[5]),
      static_cast<W*>(p[6]), static_cast<W*>(p[7]), static_cast<W*>(p[8]),
      static_cast<W*>(p[9]), static_cast<W*>(p[10]), static_cast<W*>(p[11]),
      static_cast<W*>(p[12]), static_cast<const P*>(p[13]),
      static_cast<const long long*>(p[14]), static_cast<const W*>(p[15]),
      static_cast<const long long*>(p[16]), static_cast<const W*>(p[17]),
      static_cast<const W*>(p[18]), static_cast<const W*>(p[19]), static_cast<W*>(p[20]),
      static_cast<W*>(p[21]), static_cast<P>(inv_dt), sizes[0], sizes[1], sizes[2], sizes[3]};
  return run(a, stream);
}

}  // namespace

// ptrs: the 13 outputs in SolverState's order (A, B, lambda_c, z_fst, z_mid,
// z_end, mu, E, beta_fst, beta_mid, beta_end, dt_phi, dx_phi), phi, tri,
// grad_basis, inc_table, inc_mask, diag_soc, scal, sq, lam; sizes: T, V, F,
// D; work_bytes 4 or 8, phi_bytes 4 or 8 (not 4 with 8-byte work).
extern "C" int dots_ialm_step(void* const* ptrs, int work_bytes, int phi_bytes, double inv_dt,
                              const int* sizes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (work_bytes == 4 && phi_bytes == 4) return dispatch<float, float>(ptrs, inv_dt, sizes, s);
  if (work_bytes == 4 && phi_bytes == 8) return dispatch<float, double>(ptrs, inv_dt, sizes, s);
  if (work_bytes == 8 && phi_bytes == 8) return dispatch<double, double>(ptrs, inv_dt, sizes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
