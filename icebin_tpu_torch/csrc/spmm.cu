// Regrid SpMM over a destination-sorted CSR: the port's dest-small and
// dest-ice applies.
//
// Replaces the Pallas TPU kernels of icebin_tpu/ops/pallas_bdt.py:
//   spmm_dest_small <- _fused_small_kernel (built by _mk_fused_small,
//                      driven by apply_small_blocked): EvI / AvI;
//   spmm_dest_ice   <- _fused_ice_kernel (built by _mk_fused_ice, driven by
//                      apply_ice_blocked): IvE / IvA.
// Both compute   out[r, v] = winv[r] * sum_{k in row r} val[k] * clean(x[col[k], v])
// where clean() maps non-finite sources to 0 (masked cells contribute
// nothing).  Fields lie [n, nv] (field index innermost), so one source row
// is one contiguous read of nv floats.
//
// What bounds them on the H100: at the Greenland 5 km x ModelE 2x2.5 main
// path (initial dome) EvI holds 140,336 nonzeros (8 bytes each with the
// column index); a call reads them plus the source field and writes the
// destination field at nv = 16: 10-20 MB, and matrices plus fields of a
// whole coupling round trip fit in the 50 MB L2.  The calls are therefore
// bound by launch latency and, for dest-small, by the few long rows (342
// live E rows of up to 1,123 nonzeros) that leave most SMs idle -- not by
// HBM bandwidth.
//
// What the design does about it: each call is ONE launch with no scratch
// and no second pass (the TPU kernels' tile padding, one-hot band matmuls
// and COO overflow epilogue existed only because the TPU cannot gather;
// Hopper gathers natively).  dest-small gives each row a warp, lanes
// striding over its nonzeros, so long rows spread over 32 lanes and finish
// with a fixed shuffle tree.  dest-ice rows are many and short (<= 8
// nonzeros), so one thread owns one (row, field) output and neighbouring
// threads read neighbouring fields of the same source row.  Sums are kept
// in f64 registers and rounded to f32 once, and no float atomics are used:
// the summation order is fixed, so results are bit-identical from run to
// run (resumable checkpoints depend on that).

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kFieldChunk = 16;   // fields a dest-small warp accumulates per pass
constexpr int kThreads = 256;

// |v| <= FLT_MAX is false for NaN and +-inf (no fast-math: the comparison
// keeps IEEE semantics)
__device__ __forceinline__ double clean(float v) {
  return fabsf(v) <= 3.402823466e+38f ? static_cast<double>(v) : 0.0;
}

__global__ void dest_small_kernel(const int* __restrict__ rowptr,
                                  const int* __restrict__ cols,
                                  const float* __restrict__ vals,
                                  const float* __restrict__ winv,
                                  const float* __restrict__ x,
                                  float* __restrict__ out,
                                  int nrows, int nv, int scale) {
  const int row = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= nrows) return;                 // whole warp leaves together
  const int k0 = rowptr[row];
  const int k1 = rowptr[row + 1];
  const double s = scale ? static_cast<double>(winv[row]) : 1.0;
  for (int v0 = 0; v0 < nv; v0 += kFieldChunk) {
    const int nf = min(kFieldChunk, nv - v0);
    double acc[kFieldChunk];
#pragma unroll
    for (int j = 0; j < kFieldChunk; ++j) acc[j] = 0.0;
    for (int k = k0 + lane; k < k1; k += kWarp) {
      const double w = static_cast<double>(vals[k]);
      const float* xr = x + static_cast<size_t>(cols[k]) * nv + v0;
#pragma unroll
      for (int j = 0; j < kFieldChunk; ++j)
        if (j < nf) acc[j] += w * clean(xr[j]);
    }
    // fixed tree: lane 0 ends with every field's sum, then lane j takes
    // field j from lane 0 and writes it
    float mine = 0.0f;
#pragma unroll
    for (int j = 0; j < kFieldChunk; ++j) {
#pragma unroll
      for (int off = kWarp / 2; off > 0; off /= 2)
        acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
      const double total = __shfl_sync(0xffffffffu, acc[j], 0);
      if (lane == j) mine = static_cast<float>(total * s);
    }
    if (lane < nf) out[static_cast<size_t>(row) * nv + v0 + lane] = mine;
  }
}

__global__ void dest_ice_kernel(const int* __restrict__ rowptr,
                                const int* __restrict__ cols,
                                const float* __restrict__ vals,
                                const float* __restrict__ winv,
                                const float* __restrict__ x,
                                float* __restrict__ out,
                                int nrows, int nv, int scale) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (t >= static_cast<long long>(nrows) * nv) return;
  const int row = static_cast<int>(t / nv);
  const int v = static_cast<int>(t - static_cast<long long>(row) * nv);
  double acc = 0.0;
  const int k1 = rowptr[row + 1];
  for (int k = rowptr[row]; k < k1; ++k)
    acc += static_cast<double>(vals[k])
           * clean(x[static_cast<size_t>(cols[k]) * nv + v]);
  if (scale) acc *= static_cast<double>(winv[row]);
  out[t] = static_cast<float>(acc);
}

}  // namespace

extern "C" {

// Each entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() so a refused launch is reported.

int spmm_dest_small(const void* rowptr, const void* cols, const void* vals,
                    const void* winv, const void* x, void* out, int nrows,
                    int nv, int scale, void* stream) {
  if (nrows > 0 && nv > 0) {
    const int rows_per_block = kThreads / kWarp;
    const int blocks = (nrows + rows_per_block - 1) / rows_per_block;
    dest_small_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rowptr), static_cast<const int*>(cols),
        static_cast<const float*>(vals), static_cast<const float*>(winv),
        static_cast<const float*>(x), static_cast<float*>(out), nrows, nv,
        scale);
  }
  return static_cast<int>(cudaGetLastError());
}

int spmm_dest_ice(const void* rowptr, const void* cols, const void* vals,
                  const void* winv, const void* x, void* out, int nrows,
                  int nv, int scale, void* stream) {
  const long long n = static_cast<long long>(nrows) * nv;
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    dest_ice_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rowptr), static_cast<const int*>(cols),
        static_cast<const float*>(vals), static_cast<const float*>(winv),
        static_cast<const float*>(x), static_cast<float*>(out), nrows, nv,
        scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for a status code returned by any entry point of this library.
const char* icebin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
