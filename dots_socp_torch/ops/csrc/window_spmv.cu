// Windowed cotan-Laplacian SpMV for Hopper (sm_90a): y = P L P^T x.
//
// Replaces the TPU kernel dots_socp_tpu/ops/pallas_spmv.py::_window_kernel,
// the matvec of every inner iteration of the matrix-free CG phi-solve.
//
// What is kept: the window. Rows of the vertex-permuted Laplacian are cut
// into tiles of TV rows, and every column a tile touches lies inside one
// window of W consecutive permuted vertices starting at tile_start[t]. A
// block streams its tile's x window into shared memory once; every read of x
// for the tile's rows then hits shared memory.
//
// What is dropped: the dense zeros. The TPU kernel multiplied dense (TV, W)
// tiles on its matrix unit, because Mosaic has no global gather. At plane
// n200 (V=46,431, TV=256, W=664) a row has ~7 nonzeros among 664 columns:
// the dense tiles are ~125 MB per matvec, the nonzeros ~2.6 MB. Here each row
// keeps only its nonzeros, as (window-local column, value) pairs padded to a
// fixed width D with (0, 0.0).
//
// What bounds it on an H100: bytes, not operations (2 flops per 4-byte
// value read). Per matvec at n200: ~2.6 MB of L, ~15 MB of x windows (the
// windows of consecutive tiles overlap, so most of it comes from L2), and
// 5.9 MB of y. The design reads each x element of a window from device
// memory once per tile (coalesced 128-byte rows of the vertex-major x), keeps
// the gather inside shared memory, and writes y as coalesced 128-byte rows.
//
// Layout: one block per (tile t, group of 32 time modes), 256 threads. The
// block stages x[tile_start[t] : +W, 32 modes] (vertex-major x of shape
// (V, lanes)) into shared memory as win[W][32], zero past V or past the last
// mode. Warp w then takes rows r = w, w+8, ... of the tile; lane l owns mode
// l and accumulates sum_k vals[r,k] * win[lcol[r,k]][l] in FP32 on the CUDA
// cores. Lanes read consecutive shared-memory words (no bank conflicts) and
// write consecutive words of y. No tensor cores, no TF32.

#include <cuda_runtime.h>

namespace {

constexpr int kModes = 32;      // time modes per block: one per warp lane
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
window_spmv_kernel(const float* __restrict__ x,
                   const int* __restrict__ tile_start,
                   const int* __restrict__ lcol,
                   const float* __restrict__ vals,
                   float* __restrict__ y,
                   int n_vertices, int lanes, int tile_rows, int width,
                   int nnz_width) {
  extern __shared__ float win[];  // [width][kModes]
  const int tile = blockIdx.x;
  const int mode0 = blockIdx.y * kModes;
  const int start = tile_start[tile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Stage the window. Element i is (row i / 32, mode i % 32): a warp loads
  // one contiguous vertex row of up to 32 modes.
  for (int i = threadIdx.x; i < width * kModes; i += kThreads) {
    const int v = start + i / kModes;
    const int m = mode0 + i % kModes;
    win[i] = (v < n_vertices && m < lanes) ? x[(size_t)v * lanes + m] : 0.0f;
  }
  __syncthreads();

  const int mode = mode0 + lane;
  const int row0 = tile * tile_rows;
  for (int r = warp; r < tile_rows; r += kWarps) {
    const int row = row0 + r;
    if (row >= n_vertices) break;
    const int* rc = lcol + (size_t)row * nnz_width;
    const float* rv = vals + (size_t)row * nnz_width;
    float acc = 0.0f;
    for (int k = 0; k < nnz_width; ++k) {
      // Every lane reads the same (column, value): one broadcast load.
      acc = fmaf(__ldg(rv + k), win[__ldg(rc + k) * kModes + lane], acc);
    }
    if (mode < lanes) y[(size_t)row * lanes + mode] = acc;
  }
}

}  // namespace

// C entry point, bound with ctypes. x and y are vertex-major (V, lanes)
// float32; tile_start (n_tiles,) int32; lcol / vals (n_tiles*tile_rows,
// nnz_width). Launches on `stream` of the current device and returns
// cudaGetLastError() (0 on success); it does not synchronise. The kernel's
// shared-memory limit is raised once per device, to the widest window yet.
extern "C" int dots_window_spmv_f32(const float* x, const int* tile_start,
                                    const int* lcol, const float* vals,
                                    float* y, int n_vertices, int lanes,
                                    int n_tiles, int tile_rows, int width,
                                    int nnz_width, void* stream) {
  constexpr int kMaxDevices = 64;
  static int smem_set[kMaxDevices] = {};  // bytes granted so far, per device
  const int smem = width * kModes * (int)sizeof(float);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > smem_set[device]) {
    err = cudaFuncSetAttribute(window_spmv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[device] = smem;
  }
  const dim3 grid(n_tiles, (lanes + kModes - 1) / kModes);
  window_spmv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, tile_start, lcol, vals, y, n_vertices, lanes, tile_rows, width,
      nnz_width);
  return (int)cudaGetLastError();
}
