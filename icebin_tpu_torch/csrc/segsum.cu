// Ordered f64 segment sum: out[s] = sum of v[off[s] .. off[s+1]), added
// left to right from 0.0, one segment a thread.
//
// Replaces no TPU kernel: the JAX package builds its regrid matrices,
// E1vE0 and the elevation-class measures on the host in numpy (stable
// sort, np.unique, np.add.at, np.bincount), and so did the port until
// regeneration moved to the card.  It was added for the Regeneration
// layer: every one of those sums is a run of equal keys after a stable
// sort, and this kernel adds each run's terms in the order numpy adds
// them, so the device's matrices are the host's bit for bit.
//
// What bounds it on the H100: bytes, or the longest segment.  Each value
// and offset (8 bytes each) is read once and each sum written once: at
// Antarctica's EvI column sums (1.14 M values, 1.25 M segments) 29.2 MB,
// 8.7 us at 3.35 TB/s.  The order of the adds is fixed (left to right, no
// atomics, no tree), so a segment is a serial chain of dependent f64 adds
// on one thread: for the same matrix's row sums (64,800 segments, the
// longest 769 values) the bytes need 3 us but the longest chain, not the
// bytes, sets the time.
//
// What the design does about it: a thread loads four values of its run
// before it adds them, so four loads are in flight per thread while the
// chain of adds waits only on the adder; neighbouring threads read
// neighbouring segments, whose runs lie next to each other in memory.
// The adds are __dadd_rn: no contraction, no reassociation.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const double* __restrict__ v,
                   const long long* __restrict__ off,
                   double* __restrict__ out, int nseg) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= nseg) return;
  long long j = off[s];
  const long long end = off[s + 1];
  double acc = 0.0;
  for (; j + 4 <= end; j += 4) {
    const double a = v[j], b = v[j + 1], c = v[j + 2], d = v[j + 3];
    acc = __dadd_rn(acc, a);
    acc = __dadd_rn(acc, b);
    acc = __dadd_rn(acc, c);
    acc = __dadd_rn(acc, d);
  }
  for (; j < end; ++j) acc = __dadd_rn(acc, v[j]);
  out[s] = acc;
}

}  // namespace

extern "C" {

// v (n,) f64; off (nseg + 1,) int64, non-decreasing, off[nseg] <= n;
// out (nseg,) f64.  Launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError().
int segment_sum(const double* v, const long long* off, double* out,
                int nseg, void* stream) {
  if (nseg > 0) {
    const int blocks = (nseg + kThreads - 1) / kThreads;
    segment_sum_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(v, off, out,
                                                              nseg);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
