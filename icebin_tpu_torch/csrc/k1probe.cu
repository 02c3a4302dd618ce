// Variants of the dest-ice regrid kernel (spmm_dest_ice, K1, csrc/spmm.cu):
// instruments that each change one mechanism of it, timed beside it on the
// same matrix and field.  None is on the coupler's path.
//
// Replaces the Pallas TPU instruments that asked the TPU's fused dest-ice
// kernel the same questions:
//   spmm_ice_slots  <- tools/probe_slots.py:161 (body `mk_ice.kernel` :115):
//                      NSLOT scratch slots to break a serial chain;
//   spmm_ice_batch  <- tools/probe_batch.py:207 (body `mk_ice.kernel` :146)
//                      and tools/probe_batch2.py:184 (body `ice_kernel` :125,
//                      the geometry round): gather first, then contract;
//   spmm_ice_ablate <- tools/probe_ablate.py:182 (body `mk_ice_kernel.kernel`
//                      :115) and tools/probe_manual6.py:149 (body
//                      `mk_ice.kernel` :60): the product's precision (ablate's
//                      dot3, manual6's 6-pass split) and the layout (ablate's
//                      nounfold);
//   spmm_ice_stage  <- tools/probe_ice_bisect.py:119 (body `mk_ice.kernel`
//                      :59): K1 built up stage by stage (its `stream` level is
//                      floor.cu's spmm_floor_ice, its top level K1 itself);
//   spmm_ice_store  <- tools/probe_donate.py:71 (body `kernel2` :38) and
//                      tools/probe_rmw.py:105 (body `mk_ice.kernel` :50): the
//                      output store (donate's question, K1 writing into a
//                      buffer the caller holds, is asked of spmm.cu's K1
//                      itself: ops/k1probe.py launches it with that buffer).
//
// K1 computes, one thread per (row, field) output,
//   out[r, v] = winv[r] * sum_{k in row r} vals[k] * clean(x[cols[k], v])
// with the f64 sum started at 0.0, the terms added in k order, the scale in
// f64 and one rounding to f32.  Products of two f32 values are exact in f64,
// so contracting `acc += w * c` into an FMA changes no bit.  No float
// atomics: one thread owns each output, so every result is bit-identical from
// run to run.  Term p of a row is its p-th nonzero (p = k - rowptr[r]).
//
//   slots(NSLOT)  term p -> f64 accumulator p % NSLOT; NSLOT loads in flight
//                 per step; the accumulators added in slot order, then the
//                 scale.  NSLOT = 1 is K1.
//   batch(RB)     a block of 256 threads owns RB rows.  It copies the rows'
//                 nonzeros (cols, vals) into shared memory, up to kCap at a
//                 time (a longer range, or a longer row, is taken in chunks),
//                 then those nonzeros' source rows, up to 64 fields of each,
//                 neighbouring threads on neighbouring fields (coalesced);
//                 then each thread adds its outputs' terms from shared memory
//                 in k order, carrying its sums across chunks.  K1's order,
//                 so K1's bits, for every RB.
//   ablate(f32)   K1 with its products, sum and scale in f32 (__fmul_rn /
//                 __fadd_rn: nothing contracted), in K1's order.
//   ablate(row)   one thread per row, walking it once per 16 fields (not once
//                 per field): 16 f64 accumulators, float4 loads and stores
//                 where nv % 4 == 0 and the pointers are 16-byte aligned; K1's
//                 order, so K1's bits.
//   stage(L)      gather: sum_k x[cols[k], v] (non-finite sources propagate);
//                 clean: sum_k clean(x); weights: sum_k vals * clean(x).  Each
//                 in f64, in k order, rounded once.  The next level, winv *
//                 sum_k vals * clean(x), is K1.
//   store(rmw)    K1 reading its output first: the value read starts the f64
//                 sum where K1 starts it at 0.0, so
//                 out = winv * (out + sum_k ...); on a zeroed output every
//                 operation is K1's and so are the bits, signed zero included
//                 (an f32 add of K1's result to the +0.0 read would turn K1's
//                 -0.0 into +0.0).
//   store(fields) x read as (nv, n_src) and out written as (nv, n_dst), the
//                 layout apply_ice's callers hold; thread t owns field
//                 t / n_dst of row t % n_dst.  K1's order, so K1's bits,
//                 transposed.
// Every variant reads every value its function names (rowptr, cols, and per
// level vals, each gathered source value, winv), so the compiler drops no
// load.  The plain versions in ops/k1probe.py follow the same orders bit for
// bit.
//
// What bounds them on the H100: the bytes of K1 (spmm_bound in
// icebin_tpu_torch/tools/common.py: 3.9 us at Greenland IvE, nv = 16, where
// K1 takes 13 us on a stream floor of 12 us; 101.8 us at Antarctica IvE,
// nv = 64, where K1 takes 466 us and cuSPARSE 412 us).  Each variant takes
// one mechanism of K1's walk apart: its f64 arithmetic, its nv re-reads of
// cols/vals, its dependent gather chain, its uncoalesced gathers, its store.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowChunk = 16;   // fields a row-walking thread holds per pass
constexpr int kStageFields = 64;   // fields a batch block stages per pass

// |v| <= FLT_MAX is false for NaN and +-inf, as spmm.cu's clean()
__device__ __forceinline__ float cleanf(float v) {
  return fabsf(v) <= 3.402823466e+38f ? v : 0.0f;
}

__device__ __forceinline__ double clean(float v) {
  return static_cast<double>(cleanf(v));
}

// the (row, field) of output t of a [nrows, nv] result; false past the end
__device__ __forceinline__ bool output(int nrows, int nv, long long& t,
                                       int& row, int& v) {
  t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(nrows) * nv) return false;
  row = static_cast<int>(t / nv);
  v = static_cast<int>(t - static_cast<long long>(row) * nv);
  return true;
}

template <int NSLOT>
__global__ void __launch_bounds__(kThreads)
slots_kernel(const int* __restrict__ rowptr, const int* __restrict__ cols,
             const float* __restrict__ vals, const float* __restrict__ winv,
             const float* __restrict__ x, float* __restrict__ out,
             int nrows, int nv) {
  long long t;
  int row, v;
  if (!output(nrows, nv, t, row, v)) return;
  double acc[NSLOT];
#pragma unroll
  for (int q = 0; q < NSLOT; ++q) acc[q] = 0.0;
  const int k1 = rowptr[row + 1];
  for (int k = rowptr[row]; k < k1; k += NSLOT) {
    // the NSLOT loads first, then the NSLOT independent adds
    double w[NSLOT];
    float xv[NSLOT];
#pragma unroll
    for (int q = 0; q < NSLOT; ++q) {
      w[q] = 0.0;
      xv[q] = 0.0f;
      if (k + q < k1) {
        w[q] = static_cast<double>(vals[k + q]);
        xv[q] = x[static_cast<size_t>(cols[k + q]) * nv + v];
      }
    }
#pragma unroll
    for (int q = 0; q < NSLOT; ++q)
      if (k + q < k1) acc[q] += w[q] * clean(xv[q]);
  }
  double total = acc[0];
#pragma unroll
  for (int q = 1; q < NSLOT; ++q) total += acc[q];
  out[t] = static_cast<float>(total * static_cast<double>(winv[row]));
}

template <int RB>
__global__ void __launch_bounds__(kThreads)
batch_kernel(const int* __restrict__ rowptr, const int* __restrict__ cols,
             const float* __restrict__ vals, const float* __restrict__ winv,
             const float* __restrict__ x, float* __restrict__ out,
             int nrows, int nv) {
  constexpr int kCap = 2 * RB < 32 ? 32 : 2 * RB;    // staged nonzeros
  constexpr int kOut = RB * kStageFields / kThreads;  // outputs per thread
  // [RB + 1] row starts, [kCap] cols, [kCap] vals, [kCap][fw] source values
  extern __shared__ int smem[];
  int* sptr = smem;
  int* scol = sptr + RB + 1;
  float* sval = reinterpret_cast<float*>(scol + kCap);
  float* sx = sval + kCap;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * RB;
  const int nr = min(RB, nrows - r0);
  for (int i = tid; i <= nr; i += kThreads) sptr[i] = rowptr[r0 + i];
  __syncthreads();
  const int kb0 = sptr[0];
  const int kb1 = sptr[nr];
  for (int v0 = 0; v0 < nv; v0 += kStageFields) {
    const int nf = min(kStageFields, nv - v0);
    double acc[kOut];
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[j] = 0.0;
    for (int c0 = kb0; c0 < kb1; c0 += kCap) {   // the same for every thread
      const int n = min(kCap, kb1 - c0);
      for (int i = tid; i < n; i += kThreads) {
        scol[i] = cols[c0 + i];
        sval[i] = vals[c0 + i];
      }
      __syncthreads();
      for (int e = tid; e < n * nf; e += kThreads) {
        const int i = e / nf;
        const int f = e - i * nf;
        sx[e] = x[static_cast<size_t>(scol[i]) * nv + v0 + f];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const int o = tid + j * kThreads;
        if (o < nr * nf) {
          const int r = o / nf;
          const int f = o - r * nf;
          const int kz = min(sptr[r + 1], c0 + n) - c0;
          for (int i = max(sptr[r], c0) - c0; i < kz; ++i)
            acc[j] += static_cast<double>(sval[i]) * clean(sx[i * nf + f]);
        }
      }
      __syncthreads();                      // before the next chunk's copies
    }
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int o = tid + j * kThreads;
      if (o < nr * nf) {
        const int r = o / nf;
        const int f = o - r * nf;
        out[static_cast<size_t>(r0 + r) * nv + v0 + f] = static_cast<float>(
            acc[j] * static_cast<double>(winv[r0 + r]));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ablate_f32_kernel(const int* __restrict__ rowptr,
                  const int* __restrict__ cols,
                  const float* __restrict__ vals,
                  const float* __restrict__ winv,
                  const float* __restrict__ x, float* __restrict__ out,
                  int nrows, int nv) {
  long long t;
  int row, v;
  if (!output(nrows, nv, t, row, v)) return;
  float acc = 0.0f;
  const int k1 = rowptr[row + 1];
  for (int k = rowptr[row]; k < k1; ++k)
    acc = __fadd_rn(acc, __fmul_rn(
        vals[k], cleanf(x[static_cast<size_t>(cols[k]) * nv + v])));
  out[t] = __fmul_rn(acc, winv[row]);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
ablate_row_kernel(const int* __restrict__ rowptr,
                  const int* __restrict__ cols,
                  const float* __restrict__ vals,
                  const float* __restrict__ winv,
                  const float* __restrict__ x, float* __restrict__ out,
                  int nrows, int nv) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= nrows) return;
  const int k0 = rowptr[row];
  const int k1 = rowptr[row + 1];
  const double s = static_cast<double>(winv[row]);
  for (int v0 = 0; v0 < nv; v0 += kRowChunk) {
    const int nf = min(kRowChunk, nv - v0);
    const bool vec = VEC && nf == kRowChunk;
    double acc[kRowChunk];
#pragma unroll
    for (int j = 0; j < kRowChunk; ++j) acc[j] = 0.0;
    for (int k = k0; k < k1; ++k) {
      const double w = static_cast<double>(vals[k]);
      const float* xr = x + static_cast<size_t>(cols[k]) * nv + v0;
      float xv[kRowChunk];
      if (vec) {
#pragma unroll
        for (int j = 0; j < kRowChunk; j += 4) {
          const float4 q = *reinterpret_cast<const float4*>(xr + j);
          xv[j] = q.x;
          xv[j + 1] = q.y;
          xv[j + 2] = q.z;
          xv[j + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kRowChunk; ++j) xv[j] = j < nf ? xr[j] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kRowChunk; ++j)
        if (j < nf) acc[j] += w * clean(xv[j]);
    }
    float* orow = out + static_cast<size_t>(row) * nv + v0;
    if (vec) {
#pragma unroll
      for (int j = 0; j < kRowChunk; j += 4)
        *reinterpret_cast<float4*>(orow + j) = make_float4(
            static_cast<float>(acc[j] * s), static_cast<float>(acc[j + 1] * s),
            static_cast<float>(acc[j + 2] * s),
            static_cast<float>(acc[j + 3] * s));
    } else {
#pragma unroll
      for (int j = 0; j < kRowChunk; ++j)
        if (j < nf) orow[j] = static_cast<float>(acc[j] * s);
    }
  }
}

// stage(LEVEL) for the first three; kRmw is store "rmw": the weights'
// sum started from the value read, then the scale
enum Level { kGather = 0, kClean = 1, kWeights = 2, kRmw = 3 };

template <int LEVEL>
__global__ void __launch_bounds__(kThreads)
ice_kernel(const int* __restrict__ rowptr, const int* __restrict__ cols,
           const float* __restrict__ vals, const float* __restrict__ winv,
           const float* __restrict__ x, float* __restrict__ out,
           int nrows, int nv) {
  long long t;
  int row, v;
  if (!output(nrows, nv, t, row, v)) return;
  double acc = LEVEL == kRmw ? static_cast<double>(out[t]) : 0.0;
  const int k1 = rowptr[row + 1];
  for (int k = rowptr[row]; k < k1; ++k) {
    const float xv = x[static_cast<size_t>(cols[k]) * nv + v];
    const double c = LEVEL == kGather ? static_cast<double>(xv) : clean(xv);
    acc += LEVEL >= kWeights ? static_cast<double>(vals[k]) * c : c;
  }
  if (LEVEL == kRmw) acc *= static_cast<double>(winv[row]);
  out[t] = static_cast<float>(acc);
}

__global__ void __launch_bounds__(kThreads)
fields_kernel(const int* __restrict__ rowptr, const int* __restrict__ cols,
              const float* __restrict__ vals, const float* __restrict__ winv,
              const float* __restrict__ x, float* __restrict__ out,
              int nrows, int nv, int nsrc) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (t >= static_cast<long long>(nrows) * nv) return;
  const int v = static_cast<int>(t / nrows);
  const int row = static_cast<int>(t - static_cast<long long>(v) * nrows);
  const float* xv = x + static_cast<size_t>(v) * nsrc;
  double acc = 0.0;
  const int k1 = rowptr[row + 1];
  for (int k = rowptr[row]; k < k1; ++k)
    acc += static_cast<double>(vals[k]) * clean(xv[cols[k]]);
  acc *= static_cast<double>(winv[row]);
  out[t] = static_cast<float>(acc);
}

using Kernel = void (*)(const int*, const int*, const float*, const float*,
                        const float*, float*, int, int);

// the operands of one call, as the C entry points receive them
struct Call {
  const void* rowptr;
  const void* cols;
  const void* vals;
  const void* winv;
  const void* x;
  void* out;
  int nrows;
  int nv;
  void* stream;
};

long long per_output(const Call& c) {
  return (static_cast<long long>(c.nrows) * c.nv + kThreads - 1) / kThreads;
}

int launch(Kernel kern, long long blocks, size_t smem, const Call& c) {
  if (c.nrows > 0 && c.nv > 0) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kern<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(c.stream)>>>(
        static_cast<const int*>(c.rowptr), static_cast<const int*>(c.cols),
        static_cast<const float*>(c.vals), static_cast<const float*>(c.winv),
        static_cast<const float*>(c.x), static_cast<float*>(c.out), c.nrows,
        c.nv);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int RB>
int launch_batch(const Call& c) {
  constexpr int kCap = 2 * RB < 32 ? 32 : 2 * RB;
  const int fw = c.nv < kStageFields ? c.nv : kStageFields;
  const size_t smem = sizeof(int) * (RB + 1 + 2 * kCap)
                      + sizeof(float) * kCap * fw;
  return launch(batch_kernel<RB>, (c.nrows + RB - 1) / RB, smem, c);
}

}  // namespace

extern "C" {

// Each entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() (cudaErrorInvalidValue for a parameter it
// has no instance for) so a refused launch is reported.

#define K1PROBE_CALL {rowptr, cols, vals, winv, x, out, nrows, nv, stream}

int spmm_ice_slots(const void* rowptr, const void* cols, const void* vals,
                   const void* winv, const void* x, void* out, int nrows,
                   int nv, int nslot, void* stream) {
  const Call c K1PROBE_CALL;
  switch (nslot) {
    case 1: return launch(slots_kernel<1>, per_output(c), 0, c);
    case 2: return launch(slots_kernel<2>, per_output(c), 0, c);
    case 4: return launch(slots_kernel<4>, per_output(c), 0, c);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int spmm_ice_batch(const void* rowptr, const void* cols, const void* vals,
                   const void* winv, const void* x, void* out, int nrows,
                   int nv, int rb, void* stream) {
  const Call c K1PROBE_CALL;
  switch (rb) {
    case 8: return launch_batch<8>(c);
    case 32: return launch_batch<32>(c);
    case 128: return launch_batch<128>(c);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// mode 0: f32, mode 1: row
int spmm_ice_ablate(const void* rowptr, const void* cols, const void* vals,
                    const void* winv, const void* x, void* out, int nrows,
                    int nv, int mode, void* stream) {
  const Call c K1PROBE_CALL;
  const bool vec = nv % 4 == 0 && (reinterpret_cast<uintptr_t>(x)
                                   | reinterpret_cast<uintptr_t>(out)) % 16
                                      == 0;
  switch (mode) {
    case 0: return launch(ablate_f32_kernel, per_output(c), 0, c);
    case 1: return launch(vec ? ablate_row_kernel<true>
                              : ablate_row_kernel<false>,
                          (nrows + kThreads - 1) / kThreads, 0, c);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// level 0: gather, 1: clean, 2: weights
int spmm_ice_stage(const void* rowptr, const void* cols, const void* vals,
                   const void* winv, const void* x, void* out, int nrows,
                   int nv, int level, void* stream) {
  const Call c K1PROBE_CALL;
  switch (level) {
    case kGather: return launch(ice_kernel<kGather>, per_output(c), 0, c);
    case kClean: return launch(ice_kernel<kClean>, per_output(c), 0, c);
    case kWeights: return launch(ice_kernel<kWeights>, per_output(c), 0, c);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// mode 1: rmw (out holds the values read), 2: fields (x is [nv, nsrc], out
// [nv, nrows]); out is the caller's buffer in both.  Mode 0, into, is
// spmm.cu's spmm_dest_ice launched into the caller's buffer.
int spmm_ice_store(const void* rowptr, const void* cols, const void* vals,
                   const void* winv, const void* x, void* out, int nrows,
                   int nv, int mode, int nsrc, void* stream) {
  const Call c K1PROBE_CALL;
  switch (mode) {
    case 1: return launch(ice_kernel<kRmw>, per_output(c), 0, c);
    case 2:
      if (nrows > 0 && nv > 0)
        fields_kernel<<<static_cast<unsigned>(per_output(c)), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int*>(rowptr), static_cast<const int*>(cols),
            static_cast<const float*>(vals), static_cast<const float*>(winv),
            static_cast<const float*>(x), static_cast<float*>(out), nrows, nv,
            nsrc);
      return static_cast<int>(cudaGetLastError());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef K1PROBE_CALL

}  // extern "C"
