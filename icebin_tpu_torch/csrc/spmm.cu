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
// nothing).  Sums are kept in f64 and rounded to f32 once, and no float
// atomics are used: each output's summation order is fixed, so results are
// bit-identical from run to run (resumable checkpoints and the C ABI's
// bit-identity gate depend on that).  Each call is ONE launch with no
// scratch and no memset.
//
// dest-small (K2).  What bounds it on the H100: few live destination rows
// with long rows (Greenland EvI: 342 live of 64,800 E rows, up to 1,123
// nonzeros; Antarctica EvI: 3,312, up to 769) and a gather of whole source
// rows.  At nv = 16 a call moves ~10 MB (bound 3.0 us), so it is bound by
// how many independent loads are in flight, not by HBM.  The design:
//   * blocks run only over the live rows, from a list the pack builds once
//     (ops/csr.py, longest row first, so long rows start first); the empty
//     rows' zeros come from extra blocks of the same launch, in coalesced
//     vector stores;
//   * a live row's block of W warps splits its nonzeros into W fixed,
//     contiguous slices (slice s = [k0 + len*s/W, k0 + len*(s+1)/W)); W is
//     as large as keeps every live row's block resident at once and an
//     average slice one round of loads long (ops/apply.py);
//   * in a warp, G lanes cover one nonzero's fields with VW-wide loads
//     (float4 when nv % 4 == 0), so 32/G nonzeros are read per step,
//     coalesced, each row walked once for up to 32*VW fields; a lane keeps
//     U source loads in flight;
//   * lane partials are combined through shared memory in a fixed order:
//     a slice's lane groups in group order, then the slices in slice order.
// Summation order of output (r, v): each lane group g of slice s sums its
// nonzeros k = a_s + g + j*(32/G), j = 0, 1, ... in order from 0.0; the
// slice total adds the groups' partials in order g = 0, 1, ...; the row
// total adds the slice totals in order s = 0, 1, ...; then times winv[r]
// (f64) and one rounding (spmm_dest_small_f64 keeps the f64 total: a mesh
// rank's partial, rounded only after the cross-rank sum).
// ops/apply.py:spmm_dest_small_ref follows it.
//
// dest-ice (K1).  Rows are many and short (IvE: <= 8 nonzeros at
// Greenland, <= 74 at Antarctica, 61% of Antarctica's 1,254,400 rows
// empty); at nv = 64 the 321 MB output is most of the bytes (bound 101.8
// us).  A thread's work is a chain of dependent loads (rowptr, then cols
// and vals, then x) ending in its stores, so the time is set by how many
// chains the card holds at once: registers, not bytes.  One thread owns a
// row and a chunk of CH fields in f64 registers (in the (nv, n) layout
// CH = 4, for more resident chains, and above 16 fields the compiler is
// held to 32 registers; CH = 8 in the (n, nv) layout), loads
// rowptr[r], rowptr[r+1] and winv[r] before the walk, and an empty row
// (k0 == k1) stores its zeros without reading cols, vals or x.  The
// field layout is a flag: (n, nv) rows, or (nv, n) fields, where
// neighbouring threads own neighbouring rows and every store is coalesced
// (apply_ice runs that layout with no transposes).  The arithmetic is
// the stage-1 kernel's: per (row, field) an f64 sum from 0.0 over k in CSR
// order, times winv in f64, one rounding -- so results are bit for bit the
// stage-1 thread-per-output kernel's, signed zeros included.

#include <cuda_runtime.h>

#include <type_traits>
#include <vector>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 32;    // warps a dest-small row block may hold
constexpr int kThreads = 256;    // dest-ice rows a block owns

// |v| <= FLT_MAX is false for NaN and +-inf (no fast-math: the comparison
// keeps IEEE semantics)
__device__ __forceinline__ double clean(float v) {
  return fabsf(v) <= 3.402823466e+38f ? static_cast<double>(v) : 0.0;
}

// VW consecutive floats at p: one vector load when ``aligned``
template <int VW>
__device__ __forceinline__ void load(const float* p, bool aligned,
                                     float (&v)[VW]) {
  if constexpr (VW == 4) {
    if (aligned) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      return;
    }
  } else if constexpr (VW == 2) {
    if (aligned) {
      const float2 q = *reinterpret_cast<const float2*>(p);
      v[0] = q.x; v[1] = q.y;
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < VW; ++i) v[i] = p[i];
}

// width of a lane group covering n vectors: the next power of two
__device__ __forceinline__ int group_width(int n) {
  int g = 1;
  while (g < n) g *= 2;
  return g;
}

// The empty rows' zeros: block b >= nlive stores the VW-element vectors
// (b - nlive) * blockDim.x + threadIdx.x of the (nrows, nv) output that lie
// in empty rows (nv % VW == 0, so a vector lies in one row).
template <int VW, typename OutT>
__device__ __forceinline__ void zero_empty(const int* __restrict__ rowptr,
                                           OutT* __restrict__ out,
                                           int nrows, int nv, int nlive) {
  const unsigned i = (blockIdx.x - nlive) * blockDim.x + threadIdx.x;
  const unsigned e = i * VW;
  if (e >= static_cast<unsigned>(nrows) * nv) return;
  const unsigned row = e / nv;
  if (rowptr[row] != rowptr[row + 1]) return;
  if constexpr (!std::is_same_v<OutT, float>) {
#pragma unroll
    for (int k = 0; k < VW; ++k) out[e + k] = OutT(0);
  } else if constexpr (VW == 4)
    *reinterpret_cast<float4*>(out + e) = make_float4(0.f, 0.f, 0.f, 0.f);
  else if constexpr (VW == 2)
    *reinterpret_cast<float2*>(out + e) = make_float2(0.f, 0.f);
  else
    out[e] = 0.0f;
}

template <int VW, int U, typename OutT>
__global__ void dest_small_kernel(const int* __restrict__ rowptr,
                                  const int* __restrict__ cols,
                                  const float* __restrict__ vals,
                                  const float* __restrict__ winv,
                                  const float* __restrict__ x,
                                  OutT* __restrict__ out,
                                  int nrows, int nv, int scale,
                                  const int* __restrict__ live, int nlive,
                                  int aligned) {
  extern __shared__ double part[];    // [warps][32 * VW] lane partials
  if (static_cast<int>(blockIdx.x) >= nlive) {
    zero_empty<VW, OutT>(rowptr, out, nrows, nv, nlive);
    return;
  }
  const int nw = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = live[blockIdx.x];
  const int k0 = rowptr[row];
  const int k1 = rowptr[row + 1];
  const double s = scale ? static_cast<double>(winv[row]) : 1.0;
  const long long len = k1 - k0;
  const int a = k0 + static_cast<int>(len * warp / nw);   // this slice
  const int b = k0 + static_cast<int>(len * (warp + 1) / nw);
  double* mine = part + warp * (kWarp * VW);
  for (int f0 = 0; f0 < nv; f0 += kWarp * VW) {
    const int pw = min(kWarp * VW, nv - f0);     // fields of this pass
    const int fv = pw / VW;                      // vectors of a nonzero
    const int G = group_width(fv);
    const int ng = kWarp / G;                    // nonzeros a warp step reads
    const int g = lane / G;
    const int q = lane % G;
    double acc[VW];
#pragma unroll
    for (int i = 0; i < VW; ++i) acc[i] = 0.0;
    if (q < fv) {
      const float* xq = x + f0 + q * VW;
      for (int k = a + g; k < b; k += ng * U) {
        int c[U];
        double w[U];
        float xv[U][VW];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kk = k + u * ng;
          c[u] = kk < b ? cols[kk] : 0;
          w[u] = kk < b ? static_cast<double>(vals[kk]) : 0.0;
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (k + u * ng < b)
            load<VW>(xq + static_cast<size_t>(c[u]) * nv, aligned, xv[u]);
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (k + u * ng < b) {
#pragma unroll
            for (int i = 0; i < VW; ++i) acc[i] += w[u] * clean(xv[u][i]);
          }
      }
#pragma unroll
      for (int i = 0; i < VW; ++i) mine[g * pw + q * VW + i] = acc[i];
    }
    __syncwarp();
    // the slice total of field v: its lane groups' partials in group order
    double tot[VW];
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      const int v = lane + j * kWarp;
      if (v < pw) {
        double t = mine[v];
        for (int gg = 1; gg < ng; ++gg) t += mine[gg * pw + v];
        tot[j] = t;
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < VW; ++j)
      if (lane + j * kWarp < pw) mine[lane + j * kWarp] = tot[j];
    __syncthreads();
    // the row total: the slice totals in slice order, then the scale
    for (int v = threadIdx.x; v < pw; v += blockDim.x) {
      double t = part[v];
      for (int w = 1; w < nw; ++w) t += part[w * (kWarp * VW) + v];
      out[static_cast<size_t>(row) * nv + f0 + v] = static_cast<OutT>(t * s);
    }
    __syncthreads();                 // the next pass reuses the partials
  }
}

template <int CH, int MINB, bool FIELDS>
__global__ void __launch_bounds__(kThreads, MINB)
dest_ice_kernel(const int* __restrict__ rowptr, const int* __restrict__ cols,
                const float* __restrict__ vals, const float* __restrict__ winv,
                const float* __restrict__ x, float* __restrict__ out,
                int nrows, int nv, int scale, int nsrc, int nchunks,
                int aligned) {
  // chunks of one row block run in neighbouring blocks, so the row block's
  // rowptr, cols and vals are read from the L2 after the first
  const int chunk = blockIdx.x % nchunks;
  const int row = (blockIdx.x / nchunks) * blockDim.x + threadIdx.x;
  if (row >= nrows) return;
  const int v0 = chunk * CH;
  const int nf = min(CH, nv - v0);
  const int k0 = rowptr[row];
  const int k1 = rowptr[row + 1];
  const double s = scale ? static_cast<double>(winv[row]) : 1.0;
  double acc[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) acc[j] = 0.0;
  const bool vec = !FIELDS && CH % 4 == 0 && aligned && nf == CH;
  for (int k = k0; k < k1; ++k) {
    const int c = cols[k];
    const double w = static_cast<double>(vals[k]);
    if (FIELDS) {
      const float* xc = x + static_cast<size_t>(v0) * nsrc + c;
#pragma unroll
      for (int j = 0; j < CH; ++j)
        if (j < nf) acc[j] += w * clean(xc[static_cast<size_t>(j) * nsrc]);
    } else if (vec) {
      const float* xr = x + static_cast<size_t>(c) * nv + v0;
#pragma unroll
      for (int j = 0; j < CH; j += 4) {
        float q[4];
        load<4>(xr + j, true, q);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j + i] += w * clean(q[i]);
      }
    } else {
      const float* xr = x + static_cast<size_t>(c) * nv + v0;
#pragma unroll
      for (int j = 0; j < CH; ++j)
        if (j < nf) acc[j] += w * clean(xr[j]);
    }
  }
  if (FIELDS) {
    float* o = out + static_cast<size_t>(v0) * nrows + row;
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (j < nf) o[static_cast<size_t>(j) * nrows] =
          static_cast<float>(acc[j] * s);
  } else if (vec) {
    float* o = out + static_cast<size_t>(row) * nv + v0;
#pragma unroll
    for (int j = 0; j < CH; j += 4)
      *reinterpret_cast<float4*>(o + j) = make_float4(
          static_cast<float>(acc[j] * s), static_cast<float>(acc[j + 1] * s),
          static_cast<float>(acc[j + 2] * s),
          static_cast<float>(acc[j + 3] * s));
  } else {
    float* o = out + static_cast<size_t>(row) * nv + v0;
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (j < nf) o[j] = static_cast<float>(acc[j] * s);
  }
}

template <int VW, typename OutT>
cudaError_t launch_small(int unroll, dim3 grid, dim3 block, size_t smem,
                         cudaStream_t st, const int* rowptr, const int* cols,
                         const float* vals, const float* winv, const float* x,
                         OutT* out, int nrows, int nv, int scale,
                         const int* live, int nlive, int aligned) {
  switch (unroll) {
#define ICEBIN_SMALL(U)                                                      \
    case U:                                                                  \
      dest_small_kernel<VW, U, OutT><<<grid, block, smem, st>>>(             \
          rowptr, cols, vals, winv, x, out, nrows, nv, scale, live, nlive,   \
          aligned);                                                          \
      return cudaSuccess;
    ICEBIN_SMALL(1)
    ICEBIN_SMALL(2)
    ICEBIN_SMALL(4)
#undef ICEBIN_SMALL
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool FIELDS, int MINB>
cudaError_t launch_ice_chunk(int chunk, dim3 grid, cudaStream_t st,
                             const int* rowptr, const int* cols,
                             const float* vals, const float* winv,
                             const float* x, float* out, int nrows, int nv,
                             int scale, int nsrc, int nchunks, int aligned) {
  switch (chunk) {
#define ICEBIN_ICE(CH)                                                       \
    case CH:                                                                 \
      dest_ice_kernel<CH, MINB, FIELDS><<<grid, kThreads, 0, st>>>(          \
          rowptr, cols, vals, winv, x, out, nrows, nv, scale, nsrc, nchunks, \
          aligned);                                                          \
      return cudaSuccess;
    ICEBIN_ICE(4)
    ICEBIN_ICE(8)
    ICEBIN_ICE(16)
    ICEBIN_ICE(32)
    ICEBIN_ICE(64)
#undef ICEBIN_ICE
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool FIELDS>
cudaError_t launch_ice(int chunk, int minb, dim3 grid, cudaStream_t st,
                       const int* rowptr, const int* cols, const float* vals,
                       const float* winv, const float* x, float* out,
                       int nrows, int nv, int scale, int nsrc, int nchunks,
                       int aligned) {
  if (minb == 1)
    return launch_ice_chunk<FIELDS, 1>(chunk, grid, st, rowptr, cols, vals,
                                       winv, x, out, nrows, nv, scale, nsrc,
                                       nchunks, aligned);
  if (minb == 8)
    return launch_ice_chunk<FIELDS, 8>(chunk, grid, st, rowptr, cols, vals,
                                       winv, x, out, nrows, nv, scale, nsrc,
                                       nchunks, aligned);
  return cudaErrorInvalidValue;
}

bool aligned_to(const void* p, size_t bytes) {
  return reinterpret_cast<size_t>(p) % bytes == 0;
}

// dest-small with OutT outputs (float: rounded once; double: the f64 sums
// themselves, as a mesh rank's partials are kept for the cross-rank sum)
template <typename OutT>
int dest_small(const void* rowptr, const void* cols, const void* vals,
               const void* winv, const void* x, void* out, int nrows, int nv,
               int scale, const void* live, int nlive, int warps, int unroll,
               void* stream) {
  if (warps < 1 || warps > kMaxWarps || nlive < 0 || nlive > nrows
      || static_cast<long long>(nrows) * nv >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nrows > 0 && nv > 0) {
    const int vw = nv % 4 == 0 ? 4 : (nv % 2 == 0 ? 2 : 1);
    const int threads = warps * kWarp;
    const long long vecs = static_cast<long long>(nrows) * nv / vw;
    const dim3 grid(static_cast<unsigned>(nlive + (vecs + threads - 1)
                                          / threads));
    const size_t smem = static_cast<size_t>(warps) * kWarp * vw
                        * sizeof(double);
    const int al = aligned_to(x, sizeof(float) * vw);
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* rp = static_cast<const int*>(rowptr);
    const auto* cl = static_cast<const int*>(cols);
    const auto* vl = static_cast<const float*>(vals);
    const auto* wi = static_cast<const float*>(winv);
    const auto* xs = static_cast<const float*>(x);
    auto* o = static_cast<OutT*>(out);
    const auto* lv = static_cast<const int*>(live);
    cudaError_t e;
    if (vw == 4)
      e = launch_small<4, OutT>(unroll, grid, threads, smem, st, rp, cl, vl,
                                wi, xs, o, nrows, nv, scale, lv, nlive, al);
    else if (vw == 2)
      e = launch_small<2, OutT>(unroll, grid, threads, smem, st, rp, cl, vl,
                                wi, xs, o, nrows, nv, scale, lv, nlive, al);
    else
      e = launch_small<1, OutT>(unroll, grid, threads, smem, st, rp, cl, vl,
                                wi, xs, o, nrows, nv, scale, lv, nlive, al);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() so a refused launch is reported (or
// cudaErrorInvalidValue, before any launch, for a geometry it has no
// instance for).

// dest-small: ``live`` holds the ``nlive`` non-empty rows (longest first);
// ``warps`` (1..32) a row block holds, ``unroll`` (1, 2, 4) source loads a
// lane keeps in flight.  nrows * nv must be below 2**31.  ``out`` is f32
// (nrows, nv); spmm_dest_small_f64 writes the same sums to f64 ``out``
// without the rounding.
int spmm_dest_small(const void* rowptr, const void* cols, const void* vals,
                    const void* winv, const void* x, void* out, int nrows,
                    int nv, int scale, const void* live, int nlive,
                    int warps, int unroll, void* stream) {
  return dest_small<float>(rowptr, cols, vals, winv, x, out, nrows, nv, scale,
                           live, nlive, warps, unroll, stream);
}

int spmm_dest_small_f64(const void* rowptr, const void* cols,
                        const void* vals, const void* winv, const void* x,
                        void* out, int nrows, int nv, int scale,
                        const void* live, int nlive, int warps, int unroll,
                        void* stream) {
  return dest_small<double>(rowptr, cols, vals, winv, x, out, nrows, nv,
                            scale, live, nlive, warps, unroll, stream);
}

// dest-ice: ``fields`` 0 takes x as (nsrc, nv) and writes (nrows, nv); 1
// takes x as (nv, nsrc) and writes (nv, nrows).  ``chunk`` (4, 8, 16, 32,
// 64) fields a thread holds; ``minb`` (1, 8) blocks of 256 threads the
// compiler must fit on an SM (8: at most 32 registers a thread).
int spmm_dest_ice(const void* rowptr, const void* cols, const void* vals,
                  const void* winv, const void* x, void* out, int nrows,
                  int nv, int scale, int nsrc, int fields, int chunk,
                  int minb, void* stream) {
  if (nrows > 0 && nv > 0) {
    if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int nchunks = (nv + chunk - 1) / chunk;
    const long long blocks = static_cast<long long>(
        (nrows + kThreads - 1) / kThreads) * nchunks;
    const dim3 grid(static_cast<unsigned>(blocks));
    const int al = nv % 4 == 0 && aligned_to(x, 16) && aligned_to(out, 16);
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* rp = static_cast<const int*>(rowptr);
    const auto* cl = static_cast<const int*>(cols);
    const auto* vl = static_cast<const float*>(vals);
    const auto* wi = static_cast<const float*>(winv);
    const auto* xs = static_cast<const float*>(x);
    auto* o = static_cast<float*>(out);
    const cudaError_t e =
        fields ? launch_ice<true>(chunk, minb, grid, st, rp, cl, vl, wi, xs,
                                  o, nrows, nv, scale, nsrc, nchunks, al)
               : launch_ice<false>(chunk, minb, grid, st, rp, cl, vl, wi, xs,
                                   o, nrows, nv, scale, nsrc, nchunks, al);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// Rebind the dest-small launches of a captured CUDA graph to a new matrix
// generation loaded into the same buffers: each kernel node of ``graph``
// that runs a dest_small_kernel instance over ``rowptr`` gets the launch
// dest_small would make now -- the grid (``nlive`` row blocks and the
// zero-fill blocks), the block (warps[nv] warps, ``nv`` the node's own
// field count), the shared memory and the ``nlive`` argument -- in the
// graph and in its instantiation ``exec``, which must have been made from
// ``graph``.  The kernel, its other arguments and so its summation order
// are the node's.  ``warps`` holds ``nwarps`` entries, by field count.
// ``nodes`` (room for ``cap``) holds the ``*count`` nodes to set; with
// ``*count`` < 0 they are found first, by walking the graph (nodes of other
// kernels, whose parameters this runtime may not read, are skipped), and
// ``*count`` is set, so a caller that keeps ``nodes`` walks a graph once.
int spmm_dest_small_rebind(void* graph, void* exec, const void* rowptr,
                           int nlive, const int* warps, int nwarps,
                           void** nodes, int cap, int* count) {
  const void* small[] = {
      reinterpret_cast<const void*>(dest_small_kernel<1, 1, float>),
      reinterpret_cast<const void*>(dest_small_kernel<1, 2, float>),
      reinterpret_cast<const void*>(dest_small_kernel<1, 4, float>),
      reinterpret_cast<const void*>(dest_small_kernel<2, 1, float>),
      reinterpret_cast<const void*>(dest_small_kernel<2, 2, float>),
      reinterpret_cast<const void*>(dest_small_kernel<2, 4, float>),
      reinterpret_cast<const void*>(dest_small_kernel<4, 1, float>),
      reinterpret_cast<const void*>(dest_small_kernel<4, 2, float>),
      reinterpret_cast<const void*>(dest_small_kernel<4, 4, float>),
      reinterpret_cast<const void*>(dest_small_kernel<1, 1, double>),
      reinterpret_cast<const void*>(dest_small_kernel<1, 2, double>),
      reinterpret_cast<const void*>(dest_small_kernel<1, 4, double>),
      reinterpret_cast<const void*>(dest_small_kernel<2, 1, double>),
      reinterpret_cast<const void*>(dest_small_kernel<2, 2, double>),
      reinterpret_cast<const void*>(dest_small_kernel<2, 4, double>),
      reinterpret_cast<const void*>(dest_small_kernel<4, 1, double>),
      reinterpret_cast<const void*>(dest_small_kernel<4, 2, double>),
      reinterpret_cast<const void*>(dest_small_kernel<4, 4, double>)};
  // p: a node's parameters, true if it is a dest-small launch over rowptr
  const auto ours = [&](cudaGraphNode_t node, cudaKernelNodeParams* p) {
    if (cudaGraphKernelNodeGetParams(node, p) != cudaSuccess) {
      cudaGetLastError();
      return false;
    }
    bool f = false;
    for (const void* k : small) f = f || p->func == k;
    return f && p->kernelParams != nullptr
           && *static_cast<const void* const*>(p->kernelParams[0]) == rowptr;
  };
  cudaError_t e;
  cudaKernelNodeParams p;
  if (*count < 0) {
    size_t n = 0;
    if ((e = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr,
                               &n)) != cudaSuccess)
      return static_cast<int>(e);
    std::vector<cudaGraphNode_t> all(n);
    if (n > 0 && (e = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph),
                                        all.data(), &n)) != cudaSuccess)
      return static_cast<int>(e);
    int found = 0;
    for (cudaGraphNode_t node : all) {
      cudaGraphNodeType type;
      if (cudaGraphNodeGetType(node, &type) != cudaSuccess
          || type != cudaGraphNodeTypeKernel) {
        cudaGetLastError();
        continue;
      }
      if (!ours(node, &p)) continue;
      if (found == cap) return static_cast<int>(cudaErrorInvalidValue);
      nodes[found++] = node;
    }
    *count = found;
  }
  for (int i = 0; i < *count; ++i) {
    const auto node = static_cast<cudaGraphNode_t>(nodes[i]);
    if (!ours(node, &p)) return static_cast<int>(cudaErrorInvalidValue);
    // dest_small_kernel's arguments, in its order
    void** a = p.kernelParams;
    const void* rp = *static_cast<const void* const*>(a[0]);
    const void* cl = *static_cast<const void* const*>(a[1]);
    const void* vl = *static_cast<const void* const*>(a[2]);
    const void* wi = *static_cast<const void* const*>(a[3]);
    const void* xs = *static_cast<const void* const*>(a[4]);
    void* o = *static_cast<void* const*>(a[5]);
    int nrows = *static_cast<const int*>(a[6]);
    int nv = *static_cast<const int*>(a[7]);
    int scale = *static_cast<const int*>(a[8]);
    const void* lv = *static_cast<const void* const*>(a[9]);
    int nl = nlive;
    int al = *static_cast<const int*>(a[11]);
    if (nv < 0 || nv >= nwarps || warps[nv] < 1 || warps[nv] > kMaxWarps
        || nlive < 1 || nlive > nrows)
      return static_cast<int>(cudaErrorInvalidValue);
    // dest_small's geometry for these operands
    const int vw = nv % 4 == 0 ? 4 : (nv % 2 == 0 ? 2 : 1);
    const int threads = warps[nv] * kWarp;
    const long long vecs = static_cast<long long>(nrows) * nv / vw;
    void* args[] = {&rp, &cl, &vl, &wi, &xs, &o, &nrows, &nv, &scale, &lv,
                    &nl, &al};
    cudaKernelNodeParams q = p;
    q.gridDim = dim3(static_cast<unsigned>(nlive + (vecs + threads - 1)
                                           / threads));
    q.blockDim = dim3(threads);
    q.sharedMemBytes = static_cast<unsigned>(warps[nv] * kWarp * vw
                                             * sizeof(double));
    q.kernelParams = args;
    q.extra = nullptr;
    if ((e = cudaGraphKernelNodeSetParams(node, &q)) != cudaSuccess
        || (e = cudaGraphExecKernelNodeSetParams(
                static_cast<cudaGraphExec_t>(exec), node, &q))
               != cudaSuccess)
      return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for a status code returned by any entry point of this library.
const char* icebin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
