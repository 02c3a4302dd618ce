// Stream-only floors of the regrid SpMM kernels (csrc/spmm.cu): the same
// thread mapping and the same loads, almost no arithmetic, so that
// (stock time - floor time) is the compute the stock kernel does NOT hide
// behind its memory traffic.
//
// Replaces the Pallas TPU instruments
//   spmm_floor_small <- tools/probe_floor.py:59 (body `sk` :49, Greenland)
//                       and tools/probe_ant_nv.py:144 (body `sk` :133,
//                       Antarctica): the dest-small stream floor;
//   spmm_floor_ice   <- tools/probe_floor.py:84 (body `ik` :74): the
//                       dest-ice stream floor.
// The TPU floors fetch every tile of the TPU pack and consume one element
// of each; their output is a checksum of the TPU's tile layout, which the
// port does not have.  These floors ask the same question of the port's own
// kernels.
//
// Result, exactly (both kernels, f32):
//   out[r, v] = winv[r] + sum_{k in row r} (vals[k] + x[cols[k], v])
// each (vals[k] + x) rounded to f32, summed in f32 in the stock kernel's
// fixed order: spmm_floor_small lane-strided over the row's nonzeros in
// 16-field chunks, then the same shuffle tree as dest_small_kernel, winv
// added last; spmm_floor_ice sequentially over the row, winv added last.
// The plain versions in ops/floor.py follow the same order, so kernel and
// plain version agree bit for bit.  Every value the stock kernel reads -- rowptr, cols, vals, each gathered
// source value and winv -- is read and consumed by an f32 add, so the
// compiler elides no load.  Dropped against the stock kernels: the f64
// conversion, the multiply, clean() (non-finite sources propagate) and
// the scale.
//
// What bounds them on the H100: the stock kernels' bytes (the same
// loads), and for spmm_floor_small the few long E rows it maps one warp
// each, as in the stock kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kFieldChunk = 16;   // as dest_small_kernel
constexpr int kThreads = 256;

__global__ void floor_small_kernel(const int* __restrict__ rowptr,
                                   const int* __restrict__ cols,
                                   const float* __restrict__ vals,
                                   const float* __restrict__ winv,
                                   const float* __restrict__ x,
                                   float* __restrict__ out,
                                   int nrows, int nv) {
  const int row = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= nrows) return;                 // whole warp leaves together
  const int k0 = rowptr[row];
  const int k1 = rowptr[row + 1];
  const float w_row = winv[row];
  for (int v0 = 0; v0 < nv; v0 += kFieldChunk) {
    const int nf = min(kFieldChunk, nv - v0);
    float acc[kFieldChunk];
#pragma unroll
    for (int j = 0; j < kFieldChunk; ++j) acc[j] = 0.0f;
    for (int k = k0 + lane; k < k1; k += kWarp) {
      const float w = vals[k];
      const float* xr = x + static_cast<size_t>(cols[k]) * nv + v0;
#pragma unroll
      for (int j = 0; j < kFieldChunk; ++j)
        if (j < nf) acc[j] += __fadd_rn(w, xr[j]);
    }
    float mine = 0.0f;
#pragma unroll
    for (int j = 0; j < kFieldChunk; ++j) {
#pragma unroll
      for (int off = kWarp / 2; off > 0; off /= 2)
        acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
      const float total = __shfl_sync(0xffffffffu, acc[j], 0);
      if (lane == j) mine = total + w_row;
    }
    if (lane < nf) out[static_cast<size_t>(row) * nv + v0 + lane] = mine;
  }
}

__global__ void floor_ice_kernel(const int* __restrict__ rowptr,
                                 const int* __restrict__ cols,
                                 const float* __restrict__ vals,
                                 const float* __restrict__ winv,
                                 const float* __restrict__ x,
                                 float* __restrict__ out,
                                 int nrows, int nv) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (t >= static_cast<long long>(nrows) * nv) return;
  const int row = static_cast<int>(t / nv);
  const int v = static_cast<int>(t - static_cast<long long>(row) * nv);
  float acc = 0.0f;
  const int k1 = rowptr[row + 1];
  for (int k = rowptr[row]; k < k1; ++k)
    acc += __fadd_rn(vals[k], x[static_cast<size_t>(cols[k]) * nv + v]);
  out[t] = acc + winv[row];
}

}  // namespace

extern "C" {

// Launch on the caller's stream, no synchronisation; return
// cudaGetLastError() so a refused launch is reported.

int spmm_floor_small(const void* rowptr, const void* cols, const void* vals,
                     const void* winv, const void* x, void* out, int nrows,
                     int nv, void* stream) {
  if (nrows > 0 && nv > 0) {
    const int rows_per_block = kThreads / kWarp;
    const int blocks = (nrows + rows_per_block - 1) / rows_per_block;
    floor_small_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rowptr), static_cast<const int*>(cols),
        static_cast<const float*>(vals), static_cast<const float*>(winv),
        static_cast<const float*>(x), static_cast<float*>(out), nrows, nv);
  }
  return static_cast<int>(cudaGetLastError());
}

int spmm_floor_ice(const void* rowptr, const void* cols, const void* vals,
                   const void* winv, const void* x, void* out, int nrows,
                   int nv, void* stream) {
  const long long n = static_cast<long long>(nrows) * nv;
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    floor_ice_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rowptr), static_cast<const int*>(cols),
        static_cast<const float*>(vals), static_cast<const float*>(winv),
        static_cast<const float*>(x), static_cast<float*>(out), nrows, nv);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
