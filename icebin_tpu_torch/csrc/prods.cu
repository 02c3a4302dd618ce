// Batched tile product, the depth-scaling instrument:
//   out[b, i, j] = sum_{c < 128} T[b, i, c] * F[b, j, c]
// for f32 T (B, 32, 128) and F (B, 8, 128) -> out (B, 32, 8) f32: 256 dot
// products of length 128 per b, each an f32 fused multiply-add chain over
// c = 0..127 in order (fixed order, no atomics: reruns are bit-identical).
//
// Replaces the Pallas TPU instrument tools/probe_prods_scale.py:69 (body
// `kernel` :46): the dest-ice kernel's tile contraction (3-pass split-bf16
// on the TPU's matrix unit, about f32 accuracy) on synthetic data at
// Greenland depth (B = 2048, 42 MB) and Antarctica depth (B = 15360,
// 315 MB), same block shapes, to see how the rate scales with the array's
// size.  Here the second depth leaves the 50 MB L2.
//
// What bounds it on the H100: bytes.  Each b moves 20 KB in and 1 KB out
// for 65,536 flops (3 flops a byte), far under the f32 rate's 20 flops a
// byte at 3.35 TB/s.  Design: one block of 256 threads per b; T[b] and
// F[b] come into shared memory with 16-byte coalesced loads, rows padded
// to 132 floats so that the float4 reads of four T rows (or eight F rows)
// by one warp fall in distinct banks; thread (i, j) = (t / 8, t % 8) runs
// its dot product from shared memory and writes out[b, i, j] -- 256
// consecutive floats per block, one coalesced store.  No cuBLAS.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;        // T rows per b
constexpr int kFields = 8;       // F rows per b
constexpr int kDepth = 128;      // contraction length
constexpr int kPad = kDepth + 4; // shared row stride, floats
constexpr int kThreads = kRows * kFields;

__global__ void __launch_bounds__(kThreads)
tile_prods_kernel(const float* __restrict__ T, const float* __restrict__ F,
                  float* __restrict__ out) {
  __shared__ __align__(16) float ts[kRows * kPad];
  __shared__ __align__(16) float fs[kFields * kPad];
  const size_t b = blockIdx.x;
  const int t = threadIdx.x;
  const float4* tg = reinterpret_cast<const float4*>(T + b * kRows * kDepth);
  const float4* fg = reinterpret_cast<const float4*>(F + b * kFields * kDepth);
  constexpr int kQ = kDepth / 4;           // float4 per row
#pragma unroll
  for (int q = t; q < kRows * kQ; q += kThreads) {
    const float4 v = tg[q];
    *reinterpret_cast<float4*>(&ts[(q / kQ) * kPad + (q % kQ) * 4]) = v;
  }
  if (t < kFields * kQ) {
    const float4 v = fg[t];
    *reinterpret_cast<float4*>(&fs[(t / kQ) * kPad + (t % kQ) * 4]) = v;
  }
  __syncthreads();
  const int i = t / kFields;
  const int j = t % kFields;
  const float* tr = ts + i * kPad;
  const float* fr = fs + j * kPad;
  float acc = 0.0f;
#pragma unroll 8
  for (int c = 0; c < kDepth; c += 4) {
    const float4 a = *reinterpret_cast<const float4*>(tr + c);
    const float4 f = *reinterpret_cast<const float4*>(fr + c);
    acc = fmaf(a.x, f.x, acc);
    acc = fmaf(a.y, f.y, acc);
    acc = fmaf(a.z, f.z, acc);
    acc = fmaf(a.w, f.w, acc);
  }
  out[b * kThreads + t] = acc;
}

}  // namespace

extern "C" {

// T, F and out 16-byte aligned and contiguous (the wrapper checks).  Launch
// on the caller's stream, no synchronisation; return cudaGetLastError().
int tile_prods(const void* T, const void* F, void* out, int batch,
               void* stream) {
  if (batch > 0) {
    tile_prods_kernel<<<batch, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(T), static_cast<const float*>(F),
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
