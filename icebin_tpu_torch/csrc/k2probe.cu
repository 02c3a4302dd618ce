// Variants of the dest-small regrid kernel (spmm_dest_small, csrc/spmm.cu):
// instruments that each change one mechanism of it, timed beside it on the
// same matrix and field.  None is on the coupler's path.
//
// Replaces the Pallas TPU instruments that asked the TPU's fused dest-small
// kernel the same questions:
//   spmm_small_slots  <- tools/probe_slots.py:106 (body `kernel` :59):
//                        NSLOT scratch slots to break a serial chain;
//   spmm_small_group  <- tools/probe_group.py:111 (body `kernel` :62):
//                        G chunks of work per grid step;
//   spmm_small_batch  <- tools/probe_batch.py:136 (body `kernel` :68) and
//                        tools/probe_batch2.py:118 (body `small_kernel` :47):
//                        gather a chunk's field rows first, then contract;
//   spmm_small_ablate <- tools/probe_ablate.py:261 (body `kernel` :202):
//                        the product's precision and the fold, ablated.
//
// Every variant computes, for the live rows and with scale,
//   out[r, v] = winv[r] * sum_{k in row r} vals[k] * clean(x[cols[k], v])
// (K2's function), except where an ablation mode says otherwise.  Products
// of two f32 values are exact in f64, so contracting `acc += w * c` into an
// FMA changes no bit.  Sums are f64 (the ablation f32 mode excepted),
// rounded to f32 once; no float atomics, so every result is bit-identical
// from run to run.  Term p of a row is its p-th nonzero (p = k - rowptr[r]).
//
//   slots(NSLOT)  term p -> lane p % 32, slot (p / 32) % NSLOT; each lane
//                 keeps NSLOT f64 accumulator chains and has NSLOT source
//                 rows' loads in flight per step; its slots are added in
//                 slot order, then K2's shuffle tree.  NSLOT = 1 is K2's
//                 order.  Measures K2's one dependent chain per lane
//                 (spmm.cu:67).  At NSLOT = 8 a pass holds 8 fields, not 16
//                 (NSLOT * fields <= 64 accumulators: the register file),
//                 so a row is walked twice per 16 fields.
//   group(G)      G warps share one row, a block of 8 warps covering 8 / G
//                 rows: term p -> warp (p / 32) % G, lane p % 32.  Each warp
//                 folds with K2's tree; the G warp totals are added in warp
//                 order through shared memory (a fixed second pass).  G = 1
//                 is K2's order.  Measures the share of the card in use: a
//                 few hundred long rows are K2's only busy warps.
//   batch(FB)     a warp takes its row 32 nonzeros at a time; its lanes first
//                 copy those 32 source rows' fields [v0, v0 + FB) into shared
//                 memory, neighbouring lanes on neighbouring fields of one
//                 row (coalesced, unlike spmm.cu:69); then lane j sums field
//                 v0 + j (and v0 + j + 32 at FB = 64) over the staged rows
//                 in k order.  The order is serial in k per field.  With
//                 FB = nv a row is walked once for all fields, not once per
//                 16 (spmm.cu:62).  Shared memory 8 warps x 32 rows x FB x 4
//                 bytes: 64 KB at FB = 64, above the 48 KB default.
//   ablate(f32)   K2 with its products, lane sums, shuffle tree and scale in
//                 f32 (__fmul_rn / __fadd_rn: nothing contracted).
//   ablate(smem)  K2's f64 lane sums combined without the shuffle tree: each
//                 lane writes its partials to shared memory, then lane j adds
//                 field j's 32 partials in lane order.
// Both ablations consume every load K2 makes (rowptr, cols, vals, every
// gathered source value, winv), so the compiler drops none.  The plain
// versions in ops/k2probe.py follow the same orders bit for bit.
//
// What bounds them on the H100: the same bytes as K2 (spmm_bound in
// icebin_tpu_torch/tools/probe_k2.py: 3.0 us at Greenland EvI, nv = 16),
// far below K2's 82 us, which is set by how K2 walks its rows: these
// variants take that walk apart, one mechanism each (PERF.md has the
// split: half is warps on empty rows, a quarter the f64 shuffle trees).

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kFieldChunk = 16;   // as dest_small_kernel
constexpr unsigned kAll = 0xffffffffu;

// |v| <= FLT_MAX is false for NaN and +-inf, as spmm.cu's clean()
__device__ __forceinline__ float cleanf(float v) {
  return fabsf(v) <= 3.402823466e+38f ? v : 0.0f;
}

__device__ __forceinline__ double clean(float v) {
  return static_cast<double>(cleanf(v));
}

// K2's fixed tree: lanes [0, off) add lanes [off, 2 off) for off = 16 .. 1;
// every lane gets lane 0's total
__device__ __forceinline__ double warp_total(double a) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    a += __shfl_down_sync(kAll, a, off);
  return __shfl_sync(kAll, a, 0);
}

template <int NSLOT>
__global__ void __launch_bounds__(kThreads)
slots_kernel(const int* __restrict__ rowptr, const int* __restrict__ cols,
             const float* __restrict__ vals, const float* __restrict__ winv,
             const float* __restrict__ x, float* __restrict__ out,
             int nrows, int nv) {
  constexpr int kFc = NSLOT * kFieldChunk <= 64 ? kFieldChunk : 64 / NSLOT;
  const int row = blockIdx.x * kWarps + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= nrows) return;                 // whole warp leaves together
  const int k0 = rowptr[row];
  const int k1 = rowptr[row + 1];
  const double s = static_cast<double>(winv[row]);
  for (int v0 = 0; v0 < nv; v0 += kFc) {
    const int nf = min(kFc, nv - v0);
    double acc[NSLOT][kFc];
#pragma unroll
    for (int q = 0; q < NSLOT; ++q)
#pragma unroll
      for (int j = 0; j < kFc; ++j) acc[q][j] = 0.0;
    for (int k = k0 + lane; k < k1; k += kWarp * NSLOT) {
      // all NSLOT source rows' loads first, then the NSLOT chains
      double w[NSLOT];
      float xv[NSLOT][kFc];
#pragma unroll
      for (int q = 0; q < NSLOT; ++q) {
        const int kq = k + q * kWarp;
        w[q] = 0.0;
#pragma unroll
        for (int j = 0; j < kFc; ++j) xv[q][j] = 0.0f;
        if (kq < k1) {
          w[q] = static_cast<double>(vals[kq]);
          const float* xr = x + static_cast<size_t>(cols[kq]) * nv + v0;
#pragma unroll
          for (int j = 0; j < kFc; ++j)
            if (j < nf) xv[q][j] = xr[j];
        }
      }
#pragma unroll
      for (int q = 0; q < NSLOT; ++q) {
        if (k + q * kWarp < k1) {
#pragma unroll
          for (int j = 0; j < kFc; ++j)
            if (j < nf) acc[q][j] += w[q] * clean(xv[q][j]);
        }
      }
    }
    float mine = 0.0f;
#pragma unroll
    for (int j = 0; j < kFc; ++j) {
      double t = acc[0][j];
#pragma unroll
      for (int q = 1; q < NSLOT; ++q) t += acc[q][j];
      const double total = warp_total(t);
      if (lane == j) mine = static_cast<float>(total * s);
    }
    if (lane < nf) out[static_cast<size_t>(row) * nv + v0 + lane] = mine;
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
group_kernel(const int* __restrict__ rowptr, const int* __restrict__ cols,
             const float* __restrict__ vals, const float* __restrict__ winv,
             const float* __restrict__ x, float* __restrict__ out,
             int nrows, int nv) {
  __shared__ double part[kWarps][kFieldChunk];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int g = warp % G;                   // this warp's share of its row
  const int row = blockIdx.x * (kWarps / G) + warp / G;
  const bool live = row < nrows;            // no early return: blocks sync
  const int k0 = live ? rowptr[row] : 0;
  const int k1 = live ? rowptr[row + 1] : 0;
  const double s = live ? static_cast<double>(winv[row]) : 0.0;
  for (int v0 = 0; v0 < nv; v0 += kFieldChunk) {
    const int nf = min(kFieldChunk, nv - v0);
    double acc[kFieldChunk];
#pragma unroll
    for (int j = 0; j < kFieldChunk; ++j) acc[j] = 0.0;
    for (int k = k0 + g * kWarp + lane; k < k1; k += G * kWarp) {
      const double w = static_cast<double>(vals[k]);
      const float* xr = x + static_cast<size_t>(cols[k]) * nv + v0;
#pragma unroll
      for (int j = 0; j < kFieldChunk; ++j)
        if (j < nf) acc[j] += w * clean(xr[j]);
    }
#pragma unroll
    for (int j = 0; j < kFieldChunk; ++j) {
      const double total = warp_total(acc[j]);
      if (lane == j) part[warp][j] = total;
    }
    __syncthreads();
    if (g == 0 && live && lane < nf) {      // warps of the row, in order
      double t = part[warp][lane];
      for (int h = 1; h < G; ++h) t += part[warp + h][lane];
      out[static_cast<size_t>(row) * nv + v0 + lane] =
          static_cast<float>(t * s);
    }
    __syncthreads();
  }
}

template <int FB>
__global__ void __launch_bounds__(kThreads)
batch_kernel(const int* __restrict__ rowptr, const int* __restrict__ cols,
             const float* __restrict__ vals, const float* __restrict__ winv,
             const float* __restrict__ x, float* __restrict__ out,
             int nrows, int nv) {
  constexpr int kPer = FB > kWarp ? FB / kWarp : 1;   // fields per lane
  extern __shared__ float stage[];                    // [kWarps][32][FB]
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= nrows) return;                 // warps sync only themselves
  float* sm = stage + warp * kWarp * FB;
  const int k0 = rowptr[row];
  const int k1 = rowptr[row + 1];
  const double s = static_cast<double>(winv[row]);
  for (int v0 = 0; v0 < nv; v0 += FB) {
    const int nf = min(FB, nv - v0);
    double acc[kPer];
#pragma unroll
    for (int h = 0; h < kPer; ++h) acc[h] = 0.0;
    for (int kb = k0; kb < k1; kb += kWarp) {
      const int n = min(kWarp, k1 - kb);
      const int my_col = lane < n ? cols[kb + lane] : 0;
      const float my_val = lane < n ? vals[kb + lane] : 0.0f;
      // staged element e = lane + 32 m: source row i = e / FB, field e % FB
#pragma unroll
      for (int m = 0; m < FB; ++m) {
        const int e = lane + kWarp * m;
        const int i = e / FB;
        const int f = e % FB;
        const int c = __shfl_sync(kAll, my_col, i);
        if (i < n && f < nf)
          sm[i * FB + f] = x[static_cast<size_t>(c) * nv + v0 + f];
      }
      __syncwarp();
      for (int i = 0; i < n; ++i) {
        const double w = static_cast<double>(__shfl_sync(kAll, my_val, i));
#pragma unroll
        for (int h = 0; h < kPer; ++h) {
          const int f = lane + h * kWarp;
          if (f < nf) acc[h] += w * clean(sm[i * FB + f]);
        }
      }
      __syncwarp();                         // before the next 32 overwrite
    }
#pragma unroll
    for (int h = 0; h < kPer; ++h) {
      const int f = lane + h * kWarp;
      if (f < nf)
        out[static_cast<size_t>(row) * nv + v0 + f] =
            static_cast<float>(acc[h] * s);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ablate_f32_kernel(const int* __restrict__ rowptr, const int* __restrict__ cols,
                  const float* __restrict__ vals,
                  const float* __restrict__ winv, const float* __restrict__ x,
                  float* __restrict__ out, int nrows, int nv) {
  const int row = blockIdx.x * kWarps + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= nrows) return;
  const int k0 = rowptr[row];
  const int k1 = rowptr[row + 1];
  const float s = winv[row];
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
        if (j < nf) acc[j] = __fadd_rn(acc[j], __fmul_rn(w, cleanf(xr[j])));
    }
    float mine = 0.0f;
#pragma unroll
    for (int j = 0; j < kFieldChunk; ++j) {
#pragma unroll
      for (int off = kWarp / 2; off > 0; off /= 2)
        acc[j] = __fadd_rn(acc[j], __shfl_down_sync(kAll, acc[j], off));
      const float total = __shfl_sync(kAll, acc[j], 0);
      if (lane == j) mine = __fmul_rn(total, s);
    }
    if (lane < nf) out[static_cast<size_t>(row) * nv + v0 + lane] = mine;
  }
}

__global__ void __launch_bounds__(kThreads)
ablate_smem_kernel(const int* __restrict__ rowptr,
                   const int* __restrict__ cols,
                   const float* __restrict__ vals,
                   const float* __restrict__ winv,
                   const float* __restrict__ x, float* __restrict__ out,
                   int nrows, int nv) {
  // one f64 partial per (lane, field); the odd row length keeps the 32
  // lanes' writes of one field off a single bank
  __shared__ double part[kWarps][kWarp][kFieldChunk + 1];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= nrows) return;                 // warps sync only themselves
  const int k0 = rowptr[row];
  const int k1 = rowptr[row + 1];
  const double s = static_cast<double>(winv[row]);
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
#pragma unroll
    for (int j = 0; j < kFieldChunk; ++j) part[warp][lane][j] = acc[j];
    __syncwarp();
    if (lane < nf) {
      double t = part[warp][0][lane];
      for (int l = 1; l < kWarp; ++l) t += part[warp][l][lane];
      out[static_cast<size_t>(row) * nv + v0 + lane] =
          static_cast<float>(t * s);
    }
    __syncwarp();                           // before the next chunk's writes
  }
}

using Kernel = void (*)(const int*, const int*, const float*, const float*,
                        const float*, float*, int, int);

int launch(Kernel kern, int rows_per_block, size_t smem, const void* rowptr,
           const void* cols, const void* vals, const void* winv,
           const void* x, void* out, int nrows, int nv, void* stream) {
  if (nrows > 0 && nv > 0) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int blocks = (nrows + rows_per_block - 1) / rows_per_block;
    kern<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rowptr), static_cast<const int*>(cols),
        static_cast<const float*>(vals), static_cast<const float*>(winv),
        static_cast<const float*>(x), static_cast<float*>(out), nrows, nv);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() (cudaErrorInvalidValue for a parameter it
// has no instance for) so a refused launch is reported.

#define K2PROBE_ARGS rowptr, cols, vals, winv, x, out, nrows, nv, stream

int spmm_small_slots(const void* rowptr, const void* cols, const void* vals,
                     const void* winv, const void* x, void* out, int nrows,
                     int nv, int nslot, void* stream) {
  switch (nslot) {
    case 1: return launch(slots_kernel<1>, kWarps, 0, K2PROBE_ARGS);
    case 2: return launch(slots_kernel<2>, kWarps, 0, K2PROBE_ARGS);
    case 4: return launch(slots_kernel<4>, kWarps, 0, K2PROBE_ARGS);
    case 8: return launch(slots_kernel<8>, kWarps, 0, K2PROBE_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int spmm_small_group(const void* rowptr, const void* cols, const void* vals,
                     const void* winv, const void* x, void* out, int nrows,
                     int nv, int g, void* stream) {
  switch (g) {
    case 1: return launch(group_kernel<1>, kWarps, 0, K2PROBE_ARGS);
    case 2: return launch(group_kernel<2>, kWarps / 2, 0, K2PROBE_ARGS);
    case 4: return launch(group_kernel<4>, kWarps / 4, 0, K2PROBE_ARGS);
    case 8: return launch(group_kernel<8>, kWarps / 8, 0, K2PROBE_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int spmm_small_batch(const void* rowptr, const void* cols, const void* vals,
                     const void* winv, const void* x, void* out, int nrows,
                     int nv, int fb, void* stream) {
  const size_t smem = static_cast<size_t>(kThreads) * fb * sizeof(float);
  switch (fb) {
    case 16: return launch(batch_kernel<16>, kWarps, smem, K2PROBE_ARGS);
    case 32: return launch(batch_kernel<32>, kWarps, smem, K2PROBE_ARGS);
    case 64: return launch(batch_kernel<64>, kWarps, smem, K2PROBE_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// mode 0: f32, mode 1: smem
int spmm_small_ablate(const void* rowptr, const void* cols, const void* vals,
                      const void* winv, const void* x, void* out, int nrows,
                      int nv, int mode, void* stream) {
  switch (mode) {
    case 0: return launch(ablate_f32_kernel, kWarps, 0, K2PROBE_ARGS);
    case 1: return launch(ablate_smem_kernel, kWarps, 0, K2PROBE_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef K2PROBE_ARGS

}  // extern "C"
