// The books of a coupling step: ordered f64 sums over many rows and the
// f64 mass repair's write, in one kernel (books_reduce_kernel); the
// 15-entry ledger row from the sums in another (books_stats_kernel).
//
// Replaces no TPU kernel: the JAX package's books are jnp sums and
// elementwise selects that XLA fuses into the step it compiles.  The port
// ran them as a chain of ATen launches a sum (isfinite, where, casts, a
// multiply, the reduction) and a one-thread launch for every scalar of the
// ledger arithmetic: ~270 launches a step.  This family takes each stage of
// the step's data flow (the repair's sums, its write, the step's sums, the
// ledger row) in one launch.
//
// What bounds it on the H100: bytes.  Each row of values (f32 or f64), of
// weights (f64) and of pad-row mask read once, each repaired value written
// once: ~30 MB a step for Greenland 5 km, 9 us at 3.35 TB/s.  The rows are
// short (168,000 to 1.25 M values), so a stage is latency bound unless
// many rows are in flight at once: at Greenland's widths a launch takes
// 5 to 16 us for 1 to 10 MB.
//
// What the design does about it: one launch covers every row of a stage.
// The launch parameter is a table of row groups passed by value (no copy
// to the device; a CUDA graph keeps it in the node), a group a tensor with
// its weight, mask and flags.  A block sums a fixed slice of 2,048 values
// of one row: each thread 8 values, 256 apart (neighbouring threads read
// neighbouring values), added in order, then a fixed tree over the warp
// (shuffles) and over the 8 warps.  A group's blocks take its rows side by
// side, slice by slice (the rows of a slice read the same weights).  The
// kernel is held to 32 registers, so 8 blocks (2,048 threads) fit an SM:
// the many warps in flight keep HBM busy (versions that held more values
// a thread in registers, at 69 to 208 registers, or read a group's
// weights once for all its rows, ran 1.3 to 2.5 times slower on the H100).
// The block partials of a row are added by the row's last block, found by
// an integer ticket (atomicAdd on an unsigned counter, reset by that
// block), in the same way: a thread takes the partials 256 apart in order,
// then the tree.  So each sum's order depends only on its row's length: two
// launches give the same bits, and no float atomics.  Adds, multiplies and the repair's divide are
// __dadd_rn / __dmul_rn / __ddiv_rn (and __fadd_rn / __fmul_rn in f32), as
// in segsum.cu: no contraction.
//
// The ledger row (books_stats_kernel, one thread) repeats the coupler's
// torch arithmetic operation by operation, so from the same sums it is the
// torch epilogue's row bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kSlice = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 20;
constexpr int kMaxRows = 16;

// Group flags.
constexpr int kXf64 = 1;      // x (and y, z, scale, dst) f64, else f32
constexpr int kWf64 = 2;      // w f64, else f32
constexpr int kRwf64 = 4;     // rw f64, else f32
constexpr int kFinite = 8;    // non-finite values count as 0

// A group of rows of one length.  Row r of the group is row row[r] of x,
// its element i at x + row[r] * stride + i * cstride (y, z and dst alike);
// its sum lands in out[sum[r]] (-1: none).  The value of element i: x,
// times scale[row[r]] where given, plus y then z where given (in x's
// type), 0 where not finite (kFinite) or masked out, as f64; with rw (the
// repair), the repaired value v + corr where rw > 0 (corr = (msrc[r] -
// mdst[r]) / (wtot > 0 ? wtot : 1)), written to out64[r * n + i] and, where
// x was finite, in x's type to dst; then times w where given.
struct Group {
  const void* x;
  const void* y;
  const void* z;
  const void* scale;
  const void* w;
  const void* rw;
  const unsigned char* mask;
  const double* msrc;
  const double* mdst;
  const double* wtot;
  double* out64;
  void* dst;
  long long stride;
  int n;
  int nrows;
  int flags;
  int nslices;
  int cstride;
  signed char sum[kMaxRows];
  unsigned char row[kMaxRows];
};

struct Books {
  Group g[kMaxGroups];
  int first[kMaxGroups + 1];  // first block of each group, then the total
  int ngroups;
  double* partial;            // a partial a block
  unsigned int* ticket;       // a ticket a sum, 0 between launches
  double* out;                // the sums
};

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

__device__ __forceinline__ double load_f64(const void* p, bool f64,
                                           int i) {
  return f64 ? static_cast<const double*>(p)[i]
             : static_cast<double>(static_cast<const float*>(p)[i]);
}

// A thread's sum over its values of row r in the slice at ``base``, added
// in order from 0.0.  The group's fields are read into registers once and
// its pointers marked __restrict__ (a repair's outputs never alias its
// inputs), so no load has to wait on the repair's stores.
template <typename T, bool kWrite>
__device__ __forceinline__ double slice_sum(const Group& g, int r, int base,
                                            double corr) {
  const long long o0 = static_cast<long long>(g.row[r]) * g.stride;
  const T* __restrict__ x = static_cast<const T*>(g.x) + o0;
  const T* __restrict__ y = g.y ? static_cast<const T*>(g.y) + o0 : nullptr;
  const T* __restrict__ z = g.z ? static_cast<const T*>(g.z) + o0 : nullptr;
  const unsigned char* __restrict__ mask = g.mask;
  const void* w = g.w;
  const void* rw = g.rw;
  const bool wf64 = g.flags & kWf64, rwf64 = g.flags & kRwf64;
  const bool fin = g.flags & kFinite;
  const int n = g.n;
  const long long cs = g.cstride;
  const bool scaled = g.scale != nullptr;
  const T sc = scaled ? static_cast<const T*>(g.scale)[g.row[r]] : T(1);
  double* __restrict__ out64 = g.out64 + static_cast<long long>(r) * n;
  T* __restrict__ dst = g.dst ? static_cast<T*>(g.dst) + o0 : nullptr;
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = base + k * kThreads;
    if (i >= n) break;
    const long long o = static_cast<long long>(i) * cs;
    T v = x[o];
    double d;
    if (!kWrite) {
      if (scaled) v = mul_rn(v, sc);
      if (y) v = add_rn(v, y[o]);
      if (z) v = add_rn(v, z[o]);
      if (fin && !isfinite(v)) v = T(0);
      if (mask && !mask[i]) v = T(0);
      d = static_cast<double>(v);
      if (w) d = __dmul_rn(d, load_f64(w, wf64, i));
    } else {
      const T x0 = v;
      if (fin && !isfinite(v)) v = T(0);
      d = static_cast<double>(v);
      const double wr = load_f64(rw, rwf64, i);
      const double fixed = (wr > 0.0 && isfinite(d)) ? __dadd_rn(d, corr) : d;
      out64[i] = fixed;
      if (dst && isfinite(x0)) dst[o] = static_cast<T>(fixed);
      d = (fin && !isfinite(fixed)) ? 0.0 : fixed;
      if (w) d = __dmul_rn(d, wr);
    }
    acc = __dadd_rn(acc, d);
  }
  return acc;
}

// The block's values added in a fixed tree: each warp by shuffles (16, 8,
// 4, 2, 1 lanes apart), then the warps' sums by warp 0 (4, 2, 1).  The
// total is valid in thread 0.
__device__ __forceinline__ double block_sum(double v, double* sh) {
  for (int o = 16; o > 0; o >>= 1)
    v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                  // sh may still be read by warp 0
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sh[lane] : 0.0;
    for (int o = kWarps / 2; o > 0; o >>= 1)
      v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  return v;
}

template <typename Acc>
__global__ void __launch_bounds__(kThreads, 8)
books_reduce_kernel(const __grid_constant__ Books b) {
  __shared__ double sh[kWarps];
  __shared__ bool last;
  int gi = 0;
  const int blk = blockIdx.x;
  while (gi + 1 < b.ngroups && blk >= b.first[gi + 1]) ++gi;
  const Group& g = b.g[gi];
  // a group's blocks run slice by slice, its rows side by side
  const int local = blockIdx.x - b.first[gi];
  const int s = local / g.nrows, r = local % g.nrows;
  double corr = 0.0;
  if (g.rw) {
    const double wt = *g.wtot;
    corr = __ddiv_rn(__dsub_rn(g.msrc[r], g.mdst[r]), wt > 0.0 ? wt : 1.0);
  }
  const bool f64 = g.flags & kXf64;
  const int base = s * kSlice + threadIdx.x;
  Acc acc = g.rw ? (f64 ? slice_sum<double, true>(g, r, base, corr)
                        : slice_sum<float, true>(g, r, base, corr))
                 : (f64 ? slice_sum<double, false>(g, r, base, corr)
                        : slice_sum<float, false>(g, r, base, corr));
  const int sid = g.sum[r];
  if (sid < 0) return;              // a write alone: the same for the block
  acc = block_sum(acc, sh);
  if (g.nslices == 1) {
    if (threadIdx.x == 0) b.out[sid] = acc;
    return;
  }
  if (threadIdx.x == 0) {
    b.partial[blockIdx.x] = acc;
    __threadfence();
    last = atomicAdd(&b.ticket[sid], 1u) ==
           static_cast<unsigned int>(g.nslices - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the row's partials, slice by slice
  const double* p = b.partial + b.first[gi] + r;
  Acc tot = 0.0;
  for (int j = threadIdx.x; j < g.nslices; j += kThreads)
    tot = __dadd_rn(tot, __ldcg(p + static_cast<long long>(j) * g.nrows));
  tot = block_sum(tot, sh);
  if (threadIdx.x == 0) {
    b.out[sid] = tot;
    b.ticket[sid] = 0u;
  }
}

// The ledger row of IceSheetCoupler.STAT_KEYS from the step's sums, in the
// order of the coupler's torch arithmetic.  pre: the lattice sums before
// the step (H, enth, smb, rain, enth input); dl: the delivered weighted
// sums and es: the E-side source sums, both in the order smb_mass,
// rain_mass, rain_enth, smb_enth, deltah, heat_flux, geothermal_flux;
// post: H, enth, shed, mass clamp, enthalpy shed, enthalpy clamp, latent.
__global__ void books_stats_kernel(const double* pre, const double* dl,
                                   const double* post, const double* es,
                                   double* st, double cell_area, double rho,
                                   double dt, double ad) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  double e[7], d[7];
  for (int k = 0; k < 7; ++k) {
    e[k] = __dmul_rn(es[k], dt);
    d[k] = __dmul_rn(dl[k], dt);
  }
  const double m_in = __dadd_rn(e[0], e[1]);
  double e_in = __dadd_rn(e[3], 0.0);           // sum() starts from 0
  for (int k = 4; k < 7; ++k) e_in = __dadd_rn(e_in, e[k]);
  e_in = __dadd_rn(e_in, e[2]);
  const double mass0 = __dmul_rn(__dmul_rn(pre[0], cell_area), rho);
  const double e_store0 = __dmul_rn(pre[1], cell_area);
  const double m_delivered = __dadd_rn(d[0], d[1]);
  const double m_rain = d[1], e_rain = d[2];
  double e_delivered = __dadd_rn(d[3], 0.0);
  for (int k = 4; k < 7; ++k) e_delivered = __dadd_rn(e_delivered, d[k]);
  e_delivered = __dadd_rn(e_delivered, e_rain);
  const double mass1 = __dmul_rn(__dmul_rn(post[0], cell_area), rho);
  const double e_store1 = __dmul_rn(post[1], cell_area);
  const double m_returned = __dadd_rn(__dmul_rn(post[2], ad), m_rain);
  const double m_clamp = __dmul_rn(post[3], ad);
  const double e_returned = __dadd_rn(__dmul_rn(post[4], ad), e_rain);
  const double e_clamp = __dmul_rn(post[5], ad);
  const double e_pdd = __dmul_rn(post[6], ad);
  const double m_del_f32 = __dmul_rn(__dadd_rn(pre[2], pre[3]), ad);
  const double e_del_f32 = __dmul_rn(pre[4], ad);
  double m_res = __dsub_rn(mass1, mass0);
  m_res = __dsub_rn(m_res, m_del_f32);
  m_res = __dadd_rn(m_res, m_returned);
  m_res = __dsub_rn(m_res, m_clamp);
  m_res = __dadd_rn(m_res, __dsub_rn(m_del_f32, m_delivered));
  double e_res = __dsub_rn(e_store1, e_store0);
  e_res = __dsub_rn(e_res, e_del_f32);
  e_res = __dadd_rn(e_res, __dsub_rn(e_returned, e_rain));
  e_res = __dadd_rn(e_res, e_clamp);
  e_res = __dadd_rn(e_res, __dsub_rn(__dadd_rn(e_del_f32, e_rain),
                                     e_delivered));
  const double row[15] = {m_in,     m_delivered, mass1,   m_returned,
                          m_clamp,  m_res,       e_in,    e_delivered,
                          e_pdd,    e_store1,    e_returned, e_clamp,
                          e_res,    m_rain,      e_rain};
  for (int k = 0; k < 15; ++k) st[k] = row[k];
}

}  // namespace

extern "C" {

// The size of the launch parameter, for the caller's check of its layout.
int books_struct_size(void) { return static_cast<int>(sizeof(Books)); }

// One launch of books_reduce_kernel<double> over the table at ``books`` (a
// host Books, copied into the launch by value), on ``nblocks`` blocks.
// Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError().
int books_reduce(const void* books, int nblocks, void* stream) {
  if (nblocks > 0)
    books_reduce_kernel<double><<<nblocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        *static_cast<const Books*>(books));
  return static_cast<int>(cudaGetLastError());
}

// The ledger row (15 f64) at st from the sums (see books_stats_kernel).
int books_stats(const double* pre, const double* dl, const double* post,
                const double* es, double* st, double cell_area, double rho,
                double dt, double ad, void* stream) {
  books_stats_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      pre, dl, post, es, st, cell_area, rho, dt, ad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
