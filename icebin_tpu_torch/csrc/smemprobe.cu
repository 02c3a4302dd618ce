// On-chip capacity probe: o = x * 2 for an (n, 128) f32 array held whole
// in shared memory, in and out buffers both, so that bisecting n finds the
// largest pair of 512-byte rows one kernel can keep on chip.
//   smem_copy_block    one block; its dynamic shared memory holds all n
//                      rows of x and of o (2 n 512 bytes, allowed by
//                      cudaFuncSetAttribute(MaxDynamicSharedMemorySize)).
//   smem_copy_cluster  one thread-block cluster of C = 2, 4, 8 or 16 blocks
//                      (16 is non-portable); block b holds row slice b of x,
//                      the cluster synchronises, and block b reads slice
//                      (b + 1) mod C from its neighbour's shared memory
//                      (distributed shared memory, map_shared_rank), doubles
//                      it into its own out buffer and stores that to slice
//                      (b + 1) mod C of o.  So the whole array and its
//                      result are held across the cluster's shared memory,
//                      2 ceil(n / C) 512 bytes a block.
//
// Replaces the Pallas TPU instrument tools/probe_vmem.py:32 (the
// pallas_call in `try_mb`, body `k` :27: o = x * 2 with the (n, 128) array
// whole in VMEM, vmem_limit_bytes raised to 256 MB, bisecting n).  The
// Hopper question is the staging budget of the redesigned regrid kernels:
// per block, the dynamic shared memory an opt-in allows (227 KB, 232,448
// bytes, by the card's data sheet: n = 227), and per cluster, what
// distributed shared memory adds (about C * 227 if the kernels use no static
// shared memory).
//
// A size that does not fit is refused at launch (cudaFuncSetAttribute or the
// launch returns cudaErrorInvalidValue or another configuration error, which
// is not sticky) or, for a cluster, reported by cudaOccupancyMaxActiveClusters
// as 0 clusters, in which case nothing is launched; the wrapper
// (ops/smemprobe.py) tells these from a fault, which it never provokes.
//
// What bounds it on the H100: nothing of interest.  It moves 2 n 512 bytes
// (at most a few MB) in one or C blocks, so its time is the launch and one
// SM's (or C SMs') load and store latency; the probe's answer is the size.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 128;               // f32 per row: 512 bytes
constexpr int kQuads = kCols / 4;        // float4 per row
constexpr int kThreads = 1024;

__device__ __forceinline__ float4 twice(float4 a) {
  return make_float4(a.x * 2.0f, a.y * 2.0f, a.z * 2.0f, a.w * 2.0f);
}

__global__ void __launch_bounds__(kThreads)
smem_copy_block_kernel(const float4* __restrict__ x, float4* __restrict__ o,
                       int rows) {
  extern __shared__ float4 buf[];
  const int n = rows * kQuads;
  float4* in = buf;
  float4* out = buf + n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) in[i] = x[i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = twice(in[i]);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) o[i] = out[i];
}

__global__ void __launch_bounds__(kThreads)
smem_copy_cluster_kernel(const float4* __restrict__ x, float4* __restrict__ o,
                         int rows, int per_block) {
  extern __shared__ float4 buf[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int b = static_cast<int>(cluster.block_rank());
  const int nb = (b + 1) % c;
  const int n = per_block * kQuads;      // one slice's buffer, float4
  float4* in = buf;
  float4* out = buf + n;
  // slice s covers rows [s per_block, min((s + 1) per_block, rows))
  const int mine = max(0, min(per_block, rows - b * per_block)) * kQuads;
  const int theirs = max(0, min(per_block, rows - nb * per_block)) * kQuads;
  const float4* xs = x + static_cast<size_t>(b) * n;
  for (int i = threadIdx.x; i < mine; i += blockDim.x) in[i] = xs[i];
  cluster.sync();                        // every slice is in its block
  const float4* remote = cluster.map_shared_rank(in, nb);
  for (int i = threadIdx.x; i < theirs; i += blockDim.x)
    out[i] = twice(remote[i]);
  // no block leaves (its shared memory with it) while another reads it
  cluster.sync();
  float4* os = o + static_cast<size_t>(nb) * n;
  for (int i = threadIdx.x; i < theirs; i += blockDim.x) os[i] = out[i];
}

// Allow `bytes` of dynamic shared memory; a refusal is returned and
// cleared (it is not sticky).
template <typename Kernel>
cudaError_t allow(Kernel kernel, size_t bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

}  // namespace

extern "C" {

// x and o (rows, 128) f32, contiguous and 16-byte aligned (the wrapper
// checks).  Each entry point launches on the caller's stream, does not
// synchronise, and returns the first refusal or cudaGetLastError().

int smem_copy_block(const void* x, void* o, int rows, void* stream) {
  const size_t bytes = 2 * static_cast<size_t>(rows) * kCols * sizeof(float);
  const cudaError_t e = allow(smem_copy_block_kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  smem_copy_block_kernel<<<1, kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(o), rows);
  return static_cast<int>(cudaGetLastError());
}

// *occupancy: cudaOccupancyMaxActiveClusters for this cluster size and
// shared memory, -1 if a refusal came before the query; 0 means no cluster
// of this size fits, and then nothing is launched (the status is
// cudaSuccess).
int smem_copy_cluster(const void* x, void* o, int rows, int cluster,
                      int* occupancy, void* stream) {
  *occupancy = -1;
  const int per_block = (rows + cluster - 1) / cluster;
  const size_t bytes =
      2 * static_cast<size_t>(per_block) * kCols * sizeof(float);
  cudaError_t e = allow(smem_copy_cluster_kernel, bytes);
  if (e == cudaSuccess && cluster > 8) {
    e = cudaFuncSetAttribute(smem_copy_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) cudaGetLastError();
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(occupancy, smem_copy_cluster_kernel,
                                     &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  if (*occupancy == 0) return static_cast<int>(cudaSuccess);
  e = cudaLaunchKernelEx(&cfg, smem_copy_cluster_kernel,
                         static_cast<const float4*>(x),
                         static_cast<float4*>(o), rows, per_block);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// The enumerator's name of a status code ("cudaErrorInvalidValue"), which
// the wrapper matches against the launch-configuration refusals.
const char* icebin_cuda_error_name(int code) {
  return cudaGetErrorName(static_cast<cudaError_t>(code));
}

}  // extern "C"
