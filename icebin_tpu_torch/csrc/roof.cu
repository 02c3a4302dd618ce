// Stream-reduce: out[w] = c[w] + sum_r x[r, w] over a row-major (R, W) f32
// array -- the kernel that gives the card's practical memory-read rate.
//
// Replaces the Pallas TPU kernels of the JAX package's roof instruments:
//   tools/bench_roof.py:58 (body `kern`): column sums (R, 128) -> (1, 128);
//   tools/probe_stream_scale.py:52 (body `_sum_kernel` at :40): the same
//     function with a carry, c + sum_r x[r] over (R, 32, 128) -> (32, 128),
//     which is W = 4096 here.
// Both accumulate a VMEM block across the TPU's sequential grid.
//
// What bounds it on the H100: bytes.  Each element is read once and added
// once (R * W f32 adds, about 1/16 of a flop per byte read), so at 256 MB
// the bound is 256 MB / 3.35 TB/s = 80 us, and an array under the 50 MB L2
// (34 MB) reads at L2's rate once warm.
//
// What the design does about it: blocks run in parallel and in no order,
// so the TPU's carried accumulator becomes two passes.  Pass 1: block
// (tile, chunk) sums a row range of a 128-column tile; its 256 threads are
// 8 row groups x 32 lanes, each lane reading float4s (16 bytes, a warp
// reads 512 contiguous bytes of a row) with four rows' loads in flight at
// once, and keeping four f64 sums; the 8 groups then add in a fixed order
// through shared memory into one f64 partial per column and chunk.  Pass 2
// sums each column's partials over 32 warps (strided chunks) and adds the
// warps' sums and c[w] in a fixed order, rounding to f32 once.  No float
// atomics: the summation order depends on the shapes only, so reruns are
// bit-identical.  Pass 1 runs as one wave of 8 blocks per SM (2048
// threads, 64 bytes in flight each), far more bytes in flight than HBM's
// latency needs.

#include <cuda_runtime.h>

namespace {

constexpr int kTileCols = 128;          // columns per block: 32 lanes x 4
constexpr int kGroups = 8;              // row groups per block
constexpr int kUnroll = 4;              // rows a thread loads at once
constexpr int kRoofThreads = kGroups * 32;
constexpr int kFinishWarps = 32;        // pass-2 warps per 32 columns
constexpr int kFinishThreads = kFinishWarps * 32;

__global__ void __launch_bounds__(kRoofThreads)
stream_partial_kernel(const float* __restrict__ x,
                      double* __restrict__ partial, int nrows, int ncols,
                      int rows_per_chunk) {
  const int lane = threadIdx.x & 31;
  const int group = threadIdx.x >> 5;
  const int col = blockIdx.x * kTileCols + lane * 4;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  const long long r1 = min(r0 + rows_per_chunk,
                           static_cast<long long>(nrows));
  double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
  if (col < ncols) {                    // ncols % 4 == 0: a float4 is whole
    const long long stride = static_cast<long long>(kGroups) * ncols;
    const float* p = x + (r0 + group) * ncols + col;
    long long r = r0 + group;
    // kUnroll independent 16-byte loads in flight before their adds
    for (; r + (kUnroll - 1) * kGroups < r1;
         r += kUnroll * kGroups, p += kUnroll * stride) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = __ldcs(reinterpret_cast<const float4*>(p + u * stride));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        a0 += v[u].x;
        a1 += v[u].y;
        a2 += v[u].z;
        a3 += v[u].w;
      }
    }
    for (; r < r1; r += kGroups, p += stride) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
      a0 += v.x;
      a1 += v.y;
      a2 += v.z;
      a3 += v.w;
    }
  }
  __shared__ double sums[kGroups][kTileCols];
  sums[group][lane * 4 + 0] = a0;
  sums[group][lane * 4 + 1] = a1;
  sums[group][lane * 4 + 2] = a2;
  sums[group][lane * 4 + 3] = a3;
  __syncthreads();
  if (threadIdx.x < kTileCols) {
    const int w = blockIdx.x * kTileCols + threadIdx.x;
    double s = 0.0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) s += sums[g][threadIdx.x];
    if (w < ncols) {
      partial[static_cast<long long>(blockIdx.y) * ncols + w] = s;
    }
  }
}

// Pass 2: block b owns columns [32 b, 32 b + 32); warp g sums the chunks
// k = g, g + 32, ... of its lane's column (a warp reads 32 neighbouring
// partials), then warp 0 adds c and the 32 warps' sums in warp order.
__global__ void __launch_bounds__(kFinishThreads)
stream_finish_kernel(const double* __restrict__ partial,
                     const float* __restrict__ c, float* __restrict__ out,
                     int ncols, int nchunks) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * 32 + lane;
  double s = 0.0;
  if (w < ncols) {
#pragma unroll 4
    for (int k = warp; k < nchunks; k += kFinishWarps) {
      s += partial[static_cast<long long>(k) * ncols + w];
    }
  }
  __shared__ double sums[kFinishWarps][32];
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && w < ncols) {
    double t = static_cast<double>(c[w]);
#pragma unroll
    for (int g = 0; g < kFinishWarps; ++g) t += sums[g][lane];
    out[w] = static_cast<float>(t);
  }
}

}  // namespace

extern "C" {

// x (nrows, ncols) f32 contiguous and 16-byte aligned with ncols % 4 == 0;
// c, out (ncols,) f32; partial (nchunks, ncols) f64 scratch, where
// nchunks = ceil(nrows / rows_per_chunk).  Launches both passes on the
// caller's stream, does not synchronise, and returns cudaGetLastError().
int stream_reduce(const float* x, const float* c, double* partial,
                  float* out, int nrows, int ncols, int rows_per_chunk,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunks = (nrows + rows_per_chunk - 1) / rows_per_chunk;
  const dim3 grid((ncols + kTileCols - 1) / kTileCols, nchunks);
  stream_partial_kernel<<<grid, kRoofThreads, 0, s>>>(x, partial, nrows,
                                                      ncols, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_finish_kernel<<<(ncols + 31) / 32, kFinishThreads, 0, s>>>(
      partial, c, out, ncols, nchunks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
