// Windowed cotan-Laplacian SpMV for Hopper (sm_90a): kernels B1 and B2, and
// B1-f64, B1's body in float64 (dots_window_spmv_f64).
//
// B1 (dots_window_spmv_f32) replaces the TPU kernel
// dots_socp_tpu/ops/pallas_spmv.py::_window_kernel: y = P L P^T x, the
// matvec of every inner iteration of the matrix-free CG phi-solve on one
// device. B2 (dots_sharded_window_spmv_f32) replaces the same body under
// shard_map in dots_socp_tpu/ops/sharded_window.py::sharded_window_matvec:
// on one space shard, y = L_s x_w, the shard's rows of the Laplacian times
// its window vector x_w = [own state ++ all-gathered exports ++ 0][codes].
// One body serves both; B2 differs in where a window element comes from.
//
// What is kept of the TPU kernel: the window. Rows are cut into tiles of TV
// rows, and every column a tile touches lies inside one window of W
// consecutive positions of the window vector starting at tile_start[t].
// What is dropped: the dense (TV, W) tiles (the TPU has no gather). Each row
// keeps only its nonzeros, as (window-local column, value) pairs padded with
// (0, 0.0) to a row width DP that is a multiple of 4.
//
// What bounds it on an H100: bytes, not operations (2 flops per 4-byte
// value). x and y must move once (rows * lanes * 4 B each) and L once
// (rows * DP * 8 B); on top, the windows of consecutive tiles overlap, so
// the staged bytes (tiles * W * lanes * 4 B, mostly from L2) are 2-3x the
// size of x. TV is picked so that the tiles fill the 132 SMs in as few
// waves as shared memory allows (ops/window_spmv.py::tile_candidates).
//
// Design, one block per (tile, group of 32 modes), phases staging ->
// arithmetic -> output:
//
// * Modes-major in and out. x is (lanes, n_cols) as the CG holds it and y is
//   (lanes, n_rows): no transpose before or after, one launch per matvec.
//   A tile's window is 32 strips of W contiguous floats; its output leaves
//   as 32 strips of TV contiguous floats.
// * Staging. The tile's (lcol, vals) block is contiguous and 16-byte
//   aligned: thread 0 fetches it with two bulk asynchronous copies
//   (cp.async.bulk) that complete on an mbarrier, while every warp stages
//   the window. The window strips start at x + m * n_cols + tile_start, and
//   n_cols (46,431 at plane n200) is not a multiple of 4, so no strip but
//   the first is 16-byte aligned: neither the bulk form nor 16-byte cp.async
//   can take them, and per-strip offsets that restore the alignment put the
//   modes of a warp's read into 8 banks instead of 32. So the strips come in
//   through registers: a warp takes 32 consecutive floats of a strip (one
//   coalesced 128-byte request) for 16 modes, all 16 loads in flight before
//   the first store. The same path gathers B2's window through its codes,
//   which removes the cat + gather launches from the wrapper. Measured per
//   block on an H100 (clock64 around each phase, plane n200, TV = 352;
//   PERF.md): the staging takes 8.0k clocks with 16 loads in flight, 7.4k
//   with 8 and 7.7k with 4,
//   while B2's gather, which has a dependent load first, takes 6.5k / 7.9k /
//   11.2k at 4 shards. Variants tried and dropped staged the same tile no
//   faster: 4-byte cp.async (a warp got one copy through per ~230 clocks),
//   and 16-byte loads of aligned chunks with rotated stores; taking the
//   loads or the stores out of the loop did not shorten it either. The phase
//   is bound by the instruction stream of the block's few warps, not by L2
//   or shared memory.
// * Shared-memory layout win[mode][P], P = W | 1 odd. Staging writes 32
//   consecutive words; the arithmetic reads win[lane][col], word
//   lane * P + col, which is a different bank for every lane because P is
//   odd. The output tile ytile[mode][TV + 1] reuses the window's memory.
// * Lanes are modes (the 32 lanes of a warp hold the 32 modes of one row),
//   not rows: a row's column is then one broadcast value and the window
//   read has no bank conflict whatever the mesh ordering; lanes-as-rows
//   would gather 32 unrelated columns from one strip and collide. A warp
//   owns 16 consecutive rows (8 in a tile of up to 192 rows, whose block
//   then has twice the warps to hide the staging's latency and still
//   leaves room for a second block on the SM) and works on 4 at a time:
//   their (column, value) pairs come from shared memory as 16-byte vector
//   loads, the loop over the row width is unrolled (template on D; D = 7
//   reads DP = 8), and 4 independent FMA chains are in flight. Each row is
//   summed in slot order by one thread per mode: no atomics, no tensor
//   cores, no TF32, so the result does not depend on scheduling or on TV.
// * More than 32 modes: blockIdx.y walks the mode groups; the groups of one
//   tile read the same (lcol, vals) block.
// * B1-f64 (window_spmv_f64_kernel) is the same body over doubles: values,
//   window, sums and output in float64 (fma, no float32 step), for the
//   float64 CG. Its block's shared memory holds 12 bytes per (lcol, vals)
//   slot and 8 per window element, so its tiles are cut for that
//   (ops/window_spmv.py::build_window_tiles, value_bytes = 8); a warp's
//   64-bit window reads take two half-warp passes, each conflict-free as P
//   is odd.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kModes = 32;        // time modes per block: one per warp lane
constexpr int kRowsPerWarp = 16;  // rows one warp owns: 16, or 8 in a small tile
constexpr int kSmallTile = 192;   // up to here a block runs TV / 8 warps, else TV / 16
constexpr int kRowBatch = 4;      // rows a warp accumulates at a time
constexpr int kStageModes = 16;   // window loads a thread keeps in flight
constexpr int kStageSplit = kModes / kStageModes;
constexpr int kMaxDevices = 64;

// T: float (B1, B2) or double (B1-f64).
template <typename T>
struct Args {
  const T* x;              // (lanes, n_own) own values (B1: the whole vector)
  const T* buf;            // (lanes, n_buf) gathered exports (B2), else null
  const int* codes;        // (n_window) window position -> source (B2), else null
  const int* tile_start;   // (n_tiles)
  const int* lcol;         // (n_tiles * tile_rows, dp)
  const T* vals;           // (n_tiles * tile_rows, dp)
  T* y;                    // (lanes, n_rows)
  int n_rows, n_own, n_buf, n_window, lanes, tile_rows, width, pitch, dp;
};

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// Four consecutive values of a row, 16-byte aligned (float: one vector
// load; double: two).
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One row's dot product with the staged window of this lane's mode, summed
// in slot order. D > 0: D slots unrolled, read as (D + 3) / 4 vector loads.
// D == 0: all dp slots (padding slots hold (0, 0.0) and add nothing).
template <typename T, int D>
__device__ __forceinline__ T row_dot(const int* __restrict__ rc, const T* __restrict__ rv,
                                     const T* __restrict__ wl, int dp) {
  T acc = T(0);
  if constexpr (D > 0) {
    constexpr int kVec = (D + 3) / 4;
    int c[4 * kVec];
    T v[4 * kVec];
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const int4 cc = reinterpret_cast<const int4*>(rc)[q];
      c[4 * q] = cc.x, c[4 * q + 1] = cc.y, c[4 * q + 2] = cc.z, c[4 * q + 3] = cc.w;
      load4(rv + 4 * q, v + 4 * q);
    }
#pragma unroll
    for (int k = 0; k < D; ++k) acc = fma_t(v[k], wl[c[k]], acc);
  } else {
    for (int q = 0; q < dp / 4; ++q) {
      const int4 cc = reinterpret_cast<const int4*>(rc)[q];
      T vv[4];
      load4(rv + 4 * q, vv);
      acc = fma_t(vv[0], wl[cc.x], acc);
      acc = fma_t(vv[1], wl[cc.y], acc);
      acc = fma_t(vv[2], wl[cc.z], acc);
      acc = fma_t(vv[3], wl[cc.w], acc);
    }
  }
  return acc;
}

// One block's tile. kFused: window elements are gathered through `codes`
// from x and buf (B2); else the window is x[:, tile_start : tile_start + W]
// (B1).
template <typename T, int D, bool kFused>
__device__ __forceinline__ void window_tile(const Args<T>& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [mbarrier, 16 B][lcol TV*dp][vals TV*dp][window 32*P, reused as ytile 32*(TV+1)]
  uint64_t* bar_ptr = reinterpret_cast<uint64_t*>(smem);
  int* s_lcol = reinterpret_cast<int*>(smem + 16);
  T* s_vals = reinterpret_cast<T*>(s_lcol + a.tile_rows * a.dp);
  T* win = s_vals + a.tile_rows * a.dp;

  const int tile = blockIdx.x;
  const int mode0 = blockIdx.y * kModes;
  const int n_modes = min(kModes, a.lanes - mode0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int row0 = tile * a.tile_rows;
  const int start = a.tile_start[tile];
  const uint32_t bar = smem_addr(bar_ptr);

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // The tile's (lcol, vals): two contiguous, 16-byte aligned blocks.
    const uint32_t bytes = static_cast<uint32_t>(a.tile_rows * a.dp * 4);
    const uint32_t val_bytes = static_cast<uint32_t>(a.tile_rows * a.dp * sizeof(T));
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes + val_bytes)
                 : "memory");
    bulk_copy(s_lcol, a.lcol + static_cast<size_t>(row0) * a.dp, bytes, bar);
    bulk_copy(s_vals, a.vals + static_cast<size_t>(row0) * a.dp, val_bytes, bar);
  }

  // The window. A unit is 32 consecutive window positions (one per lane)
  // times 16 modes; the warps share the units round-robin. A thread has its
  // unit's 16 loads in flight before it stores the first.
  const int n_units = ((a.width + 31) >> 5) * kStageSplit;
  for (int u = warp; u < n_units; u += n_warps) {
    const int j = (u / kStageSplit) * 32 + lane;
    if (j >= a.width) continue;
    const int pos = start + j;
    const T* src = nullptr;  // stays null: the element is 0
    size_t stride = a.n_own;
    if constexpr (kFused) {
      if (pos < a.n_window) {
        const int code = __ldg(a.codes + pos);
        if (code < a.n_own) {
          src = a.x + code;
        } else if (code < a.n_own + a.n_buf) {
          src = a.buf + (code - a.n_own);
          stride = a.n_buf;
        }
      }
    } else {
      if (pos < a.n_own) src = a.x + pos;
    }
    const int m_lo = (u % kStageSplit) * kStageModes;
    T v[kStageModes];
#pragma unroll
    for (int i = 0; i < kStageModes; ++i) {
      const bool live = src != nullptr && m_lo + i < n_modes;
      v[i] = live ? __ldg(src + (mode0 + m_lo + i) * stride) : T(0);
    }
#pragma unroll
    for (int i = 0; i < kStageModes; ++i) {
      if (m_lo + i < n_modes) win[(m_lo + i) * a.pitch + j] = v[i];
    }
  }
  mbarrier_wait(bar, 0);
  __syncthreads();

  // Arithmetic: this warp's 16 rows, 4 at a time, lane = mode.
  T acc[kRowsPerWarp];
  const T* wl = win + lane * a.pitch;
  const int rows_per_warp = a.tile_rows / n_warps;  // 8 or 16
  const int r_lo = warp * rows_per_warp;
#pragma unroll
  for (int b = 0; b < kRowsPerWarp; b += kRowBatch) {
    if (b < rows_per_warp) {  // block-uniform
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        const int r = r_lo + b + i;
        acc[b + i] = row_dot<T, D>(s_lcol + r * a.dp, s_vals + r * a.dp, wl, a.dp);
      }
    }
  }

  // Output through shared memory: ytile[mode][TV + 1] over the window.
  __syncthreads();
  T* ytile = win;
  const int y_pitch = a.tile_rows + 1;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (i < rows_per_warp) ytile[lane * y_pitch + r_lo + i] = acc[i];
  }
  __syncthreads();
  const int rows_here = min(a.tile_rows, a.n_rows - row0);
  const int n_out = ((a.tile_rows + 31) >> 5) * 4;
  for (int u = warp; u < n_out; u += n_warps) {
    const int j = (u >> 2) * 32 + lane;
    if (j >= rows_here) continue;
    const int m_lo = (u & 3) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m_lo + i;
      if (m < n_modes) {
        a.y[static_cast<size_t>(mode0 + m) * a.n_rows + row0 + j] = ytile[m * y_pitch + j];
      }
    }
  }
}

// B1, B2 and B1-f64 under the names the profiler shows.
template <int D, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) window_spmv_kernel(const Args<float> a) {
  window_tile<float, D, false>(a);
}

template <int D, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) sharded_window_spmv_kernel(const Args<float> a) {
  window_tile<float, D, true>(a);
}

template <int D, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) window_spmv_f64_kernel(const Args<double> a) {
  window_tile<double, D, false>(a);
}

// Raises the kernel's dynamic shared-memory limit once per device, to the
// widest request yet; returns the CUDA error (0 on success).
template <typename Kernel>
cudaError_t grant_smem(Kernel kernel, int* granted, int smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > granted[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    granted[device] = smem;
  }
  return cudaSuccess;
}

int threads_of(int tile_rows) {
  return tile_rows / (tile_rows <= kSmallTile ? 8 : kRowsPerWarp) * 32;
}

template <typename T, int D, bool kFused, int kMaxThreads>
int launch_variant(const Args<T>& a, int n_tiles, cudaStream_t stream) {
  static int granted[kMaxDevices] = {};  // bytes granted so far, per device
  const int tile_floats = kModes * max(a.pitch, a.tile_rows + 1);
  const int smem = 16 + a.tile_rows * a.dp * static_cast<int>(4 + sizeof(T)) +
                   tile_floats * static_cast<int>(sizeof(T));
  void (*kernel)(const Args<T>);
  if constexpr (std::is_same<T, double>::value) {
    kernel = window_spmv_f64_kernel<D, kMaxThreads>;
  } else {
    kernel = kFused ? sharded_window_spmv_kernel<D, kMaxThreads>
                    : window_spmv_kernel<D, kMaxThreads>;
  }
  cudaError_t err = grant_smem(kernel, granted, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_tiles, (a.lanes + kModes - 1) / kModes);
  // More warps hide more of the staging's latency, but a block of over 768
  // threads leaves its SM no room for a second one: small tiles run a warp
  // per 8 rows, large ones per 16.
  const int threads = threads_of(a.tile_rows);
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// tile_rows must be a multiple of 16 in [16, 512] and dp a multiple of 4 (so
// that the block has whole warps of 8 or 16 rows and the vector loads are
// aligned);
// nnz is the widest row's nonzero count. The unrolled body serves the usual
// mesh (nnz <= 7, dp = 8); any other width takes the run-time loop.
// B1-f64's doubles take twice the registers: a block of up to 768 threads
// (plane n200's 352-row tiles run 704) is bound to 85 registers a thread
// rather than 1024 threads' 64.
template <typename T, bool kFused>
int launch(Args<T> a, int n_tiles, int nnz, void* stream) {
  if (a.tile_rows < kRowsPerWarp || a.tile_rows > 512 || a.tile_rows % kRowsPerWarp != 0 ||
      a.dp < 4 || a.dp % 4 != 0 || nnz > a.dp || a.width < 1 || n_tiles < 1 || a.lanes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.pitch = a.width | 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = threads_of(a.tile_rows);
  const bool small = threads <= 512;  // up to 128 registers each
  const bool unrolled = a.dp == 8 && nnz <= 7;
  if constexpr (std::is_same<T, double>::value) {
    if (!small && threads <= 768) {
      return unrolled ? launch_variant<T, 7, kFused, 768>(a, n_tiles, s)
                      : launch_variant<T, 0, kFused, 768>(a, n_tiles, s);
    }
  }
  if (unrolled) {
    return small ? launch_variant<T, 7, kFused, 512>(a, n_tiles, s)
                 : launch_variant<T, 7, kFused, 1024>(a, n_tiles, s);
  }
  return small ? launch_variant<T, 0, kFused, 512>(a, n_tiles, s)
               : launch_variant<T, 0, kFused, 1024>(a, n_tiles, s);
}

}  // namespace

// C entry points, bound with ctypes. All arrays are contiguous; x, buf and y
// are modes-major float32 (B1-f64: float64); tile_start (n_tiles,) and codes
// (n_window,) int32;
// lcol / vals (n_tiles * tile_rows, dp). Each launches on `stream` of the
// current device and returns cudaGetLastError() (0 on success); neither
// synchronises.

// B1: y (lanes, n_rows) = rows of L times x (lanes, n_cols).
extern "C" int dots_window_spmv_f32(const float* x, const int* tile_start, const int* lcol,
                                    const float* vals, float* y, int n_rows, int n_cols,
                                    int lanes, int n_tiles, int tile_rows, int width, int dp,
                                    int nnz, void* stream) {
  Args<float> a{x, nullptr, nullptr, tile_start, lcol, vals, y,
                n_rows, n_cols, 0, n_cols, lanes, tile_rows, width, 0, dp};
  return launch<float, false>(a, n_tiles, nnz, stream);
}

// B1-f64: the same in float64 (x, vals and y double).
extern "C" int dots_window_spmv_f64(const double* x, const int* tile_start, const int* lcol,
                                    const double* vals, double* y, int n_rows, int n_cols,
                                    int lanes, int n_tiles, int tile_rows, int width, int dp,
                                    int nnz, void* stream) {
  Args<double> a{x, nullptr, nullptr, tile_start, lcol, vals, y,
                 n_rows, n_cols, 0, n_cols, lanes, tile_rows, width, 0, dp};
  return launch<double, false>(a, n_tiles, nnz, stream);
}

// B2: y (lanes, n_rows) = the shard's rows of L times its window vector,
// gathered in the staging: window position p holds x[:, c] for c = codes[p]
// < n_rows, buf[:, c - n_rows] for c < n_rows + n_buf, else 0.
extern "C" int dots_sharded_window_spmv_f32(const float* x, const float* buf, const int* codes,
                                            const int* tile_start, const int* lcol,
                                            const float* vals, float* y, int n_rows, int n_buf,
                                            int n_window, int lanes, int n_tiles, int tile_rows,
                                            int width, int dp, int nnz, void* stream) {
  Args<float> a{x, buf, codes, tile_start, lcol, vals, y,
                n_rows, n_rows, n_buf, n_window, lanes, tile_rows, width, 0, dp};
  return launch<float, true>(a, n_tiles, nnz, stream);
}
