// Batched Sutherland--Hodgman clip of subject rings against centred
// rectangles (clip_rect) and against convex clip rings (clip_poly), with the
// shoelace area and centroid of each clipped ring.
//
// Replaces the Pallas TPU kernels of icebin_tpu/ops/pallas_clip.py:
// _clip_kernel (driven by clip_areas_centroids_pallas), which builds the
// exchange grid against lattice (XY) ice grids, and _polyclip_kernel
// (driven by clip_areas_centroids_poly_pallas), which builds it against
// generic-polygon grids (unstructured meshes; concave cells arrive
// ear-clipped into convex pieces).  Inputs are recentred per pair by the
// caller, so coordinates are O(cell size); f32 then carries ~1e-7 relative
// accuracy and the host's f64 repair makes column sums exact.
//
// What bounds it on the H100: bytes.  A pair reads its subject ring and its
// rectangle or clip ring once and writes an area and a centroid: 92 bytes a
// pair for clip_rect at V0 = 8 (64 + 16 + 12), 140 for clip_poly at V0 = 8,
// Vc = 8 (64 + 64 + 12); the Greenland build's 305,970 pairs are 28 MB, 8.4
// us at 3.35 TB/s.  The arithmetic is a few hundred flops a pair.
//
// Stage 2, the main path (clip_rect, clip_poly): a register-pipelined
// Sutherland--Hodgman, one thread a pair, with no ring stored anywhere.
// Each clip half-plane is a stage that keeps its first and previous vertex
// in registers (their signed distances d are recomputed, which costs fewer
// registers than holding them; the stages' seen flags share one register).
// A vertex pushed into stage k emits into stage k + 1 the crossing point of
// the edge from the previous vertex, if the side changed, and then the
// vertex itself, if it is inside.  The last stage sums the f64 shoelace as
// the vertices stream in.  After the subject's last vertex a close token
// runs down the stages: each clips the edge from its previous vertex to its
// first, emits into the next, and passes the token on.  The stages are
// nested templates, so their state is named registers and never an array
// indexed at run time, which would live in local memory as the stage-1
// kernels' rings do (1.5-6.5 KB a thread).  A stage hands its 0, 1 or 2
// emissions (and the close token) to the next through one loop that is not
// unrolled, the point taken by a select and only the count live across the
// next stage's code, so each stage's code holds one copy of the next
// stage's and the code grows linearly with the stages.  The subject ring
// arrives as 16-byte loads: into registers (route kVector) or, through
// cp.async, into a block's shared memory with rows padded by 16 bytes
// against bank conflicts (kStaged); the rectangle is one float4, the clip
// ring two or four.  The rule (clip_rect, clip_poly) is the geometry
// tools/sweep_clip.py measured (PERF.md).
//
// What the pipeline costs instead: the emission loops diverge.  Threads of
// a warp emit different counts at each stage, and the warp runs each
// stage's loop to the largest, so the deeper stages run more steps than
// any one thread needs (tools/sweep_clip.py counts both from the bit model
// on the builds' pairs).  Stage 1's passes diverge only by ring length.
//
// The rotation.  Stage 1 emits the group of the edge last -> first (its
// crossing, then vertex 0) first; a stage that streams can emit it only
// when the ring closes, so it comes last.  Each stage's output is the
// stage-1 pass's output rotated by one group, with the same arithmetic on
// the same edges, so the final ring is stage 1's compacted ring rotated:
// the same vertices and polygon, the shoelace terms summed in another
// order.  All f32 and f64 arithmetic is written with _rn intrinsics, so
// nvcc contracts nothing it was not told to and ops/clip.py:
// clip_stream_model reproduces the kernel bit for bit.  The crossing point
// t (x - xp) + xp is one __fmaf_rn, as nvcc contracts stage 1's
// xp + t * (x - xp), so the vertices are stage 1's bit for bit.

// Ring bound (stage 1; both kernels are total for every ring they accept,
// non-convex subjects included).  A pass over an n-slot ring with I slots
// inside emits the I inside vertices plus one crossing point per change of
// side along the ring.  Each maximal run of inside slots is entered and
// left once, so the changes number 2 * (number of inside runs) <=
// 2 * min(I, n - I), and the output has at most I + 2 * min(I, n - I) <=
// floor(3n / 2) vertices (the maximum, at I = n / 2).  Iterating
// floor(3n / 2) over the passes:
//   rect, 4 passes:  V0 = 8 -> 40;  V0 = 16 -> 81   (buffers: 16 * V0, the
//                                                    reference's own bound)
//   poly, Vc = 4:    V0 = 8 -> 40;  V0 = 16 -> 81
//   poly, Vc = 8:    V0 = 8 -> 12, 18, 27, 40, 60, 90, 135, 202;
//                    V0 = 16 -> 406
// The stage-1 clip_poly sizes its buffers to ring_bound(V0, Vc), the last
// entry; the reference's doubling buffers end at V0 * 2^Vc (2048 and 4096
// slots).  Stage 2 holds no ring, so the bound sizes nothing there: a
// stage keeps two vertices whatever the ring's length, and a ring at the
// bound only makes its loops run longer.
//
// A zero-length clip edge (duplicate-padded clip ring) gives d == 0 for
// every vertex, which keeps the ring as it is: stage 1 skips that pass,
// stage 2 passes the vertices through that stage unchanged, so a hexagon
// padded to 8 slots pays 6 clipping stages.
//
// Degenerate rings: a clipped ring of zero area gets as centroid the first
// vertex the last stage received (stage 1: its ring's first vertex), (0, 0)
// if none (the reference takes slot 0 of its forward-filled buffer).  The
// exchange assembly drops such pairs (min_area_frac), so the convention is
// never read.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

// ---- stage 2: the register pipeline -------------------------------------

constexpr int kMaxThreads = 256;   // __launch_bounds__ of every instance
constexpr int kVector = 0;         // subject rings: 16-byte loads to registers
constexpr int kStaged = 1;         // cp.async into padded shared-memory rows
// The rule, from tools/sweep_clip.py on the H100 (PERF.md).
constexpr int kRuleThreads = 128;
constexpr int kRuleMinBlocks = 1;
constexpr int kRuleRoute = kVector;

// The last stage: the shoelace of the ring as it streams in, terms (0, 1),
// (1, 2), ..., (n - 1, 0) summed in f64 in that order.
struct Shoelace {
  float fx = 0.0f, fy = 0.0f, px = 0.0f, py = 0.0f;
  bool seen = false;
  double a2 = 0.0, sx = 0.0, sy = 0.0;

  __device__ __forceinline__ void term(float x0, float y0, float x1,
                                       float y1) {
    const double cr = __dsub_rn(__dmul_rn(x0, y1), __dmul_rn(x1, y0));
    a2 = __dadd_rn(a2, cr);
    sx = __dadd_rn(sx, __dmul_rn(__dadd_rn(x0, x1), cr));
    sy = __dadd_rn(sy, __dmul_rn(__dadd_rn(y0, y1), cr));
  }

  __device__ __forceinline__ void step(float x, float y, bool close) {
    if (close) {
      if (seen) term(px, py, fx, fy);
      return;
    }
    if (seen) {
      term(px, py, x, y);
    } else {
      seen = true;
      fx = x;
      fy = y;
    }
    px = x;
    py = y;
  }

  __device__ __forceinline__ Shoelace& last() { return *this; }

  __device__ __forceinline__ void write(float* area, float* cent,
                                        int b) const {
    const double a = __dmul_rn(0.5, a2);
    float cx = 0.0f, cy = 0.0f;
    if (a != 0.0) {
      const double s = __dmul_rn(6.0, a);
      cx = __double2float_rn(__ddiv_rn(sx, s));
      cy = __double2float_rn(__ddiv_rn(sy, s));
    } else if (seen) {           // degenerate ring: its first vertex
      cx = fx;
      cy = fy;
    }
    area[b] = __double2float_rn(a);
    reinterpret_cast<float2*>(cent)[b] = make_float2(cx, cy);
  }
};

// What the stages clip against.  Stage K of a rectangle keeps d >= 0 for
// 0: x >= -hx, 1: x <= hx, 2: y >= -hy, 3: y <= hy.
struct Rect {
  float hx, hy;
  template <int K>
  __device__ __forceinline__ bool pass() const { return false; }
  template <int K>
  __device__ __forceinline__ float dist(float x, float y) const {
    if (K == 0) return __fadd_rn(x, hx);
    if (K == 1) return __fsub_rn(hx, x);
    if (K == 2) return __fadd_rn(y, hy);
    return __fsub_rn(hy, y);
  }
};

// Stage K of a convex clip ring (VC vertices) keeps d = ex (y - y0) -
// ey (x - x0) >= 0 for its edge from vertex K (x0, y0) along (ex, ey) to
// vertex K + 1, rounded as the reference rounds it; a zero-length edge
// passes the ring through.  Each stage derives its edge from the ring's
// registers, so the ring is held once, not as VC edges.
template <int VC>
struct Ring {
  float q[2 * VC];
  template <int K>
  __device__ __forceinline__ float ex() const {
    return __fsub_rn(q[2 * ((K + 1) % VC)], q[2 * K]);
  }
  template <int K>
  __device__ __forceinline__ float ey() const {
    return __fsub_rn(q[2 * ((K + 1) % VC) + 1], q[2 * K + 1]);
  }
  template <int K>
  __device__ __forceinline__ bool pass() const {
    return ex<K>() == 0.0f && ey<K>() == 0.0f;
  }
  template <int K>
  __device__ __forceinline__ float dist(float x, float y) const {
    return __fsub_rn(__fmul_rn(ex<K>(), __fsub_rn(y, q[2 * K + 1])),
                     __fmul_rn(ey<K>(), __fsub_rn(x, q[2 * K])));
  }
};

// Clipping stage K of N against clip C, in front of the stages after it.
// step(c, seen, x, y, false) pushes a vertex; step(c, seen, ., ., true) is
// the close token.  Bit K of `seen` says whether stage K has had a vertex
// (one register for all the stages).
template <int K, int N, class C>
struct Stage {
  using Next = std::conditional_t<K + 1 == N, Shoelace, Stage<K + 1, N, C>>;
  Next next;
  float fx = 0.0f, fy = 0.0f, px = 0.0f, py = 0.0f;

  __device__ __forceinline__ void step(const C& c, unsigned& seen, float x,
                                       float y, bool close) {
    bool cross = false;
    bool keep = !close;          // emit the vertex after the crossing
    if (!c.template pass<K>()) {
      if (close) {               // the edge (px, py) -> first vertex
        x = fx;
        y = fy;
      }
      const float d = c.template dist<K>(x, y);
      keep = false;
      if (seen >> K & 1u) {      // the edge (px, py) -> (x, y)
        const float pd = c.template dist<K>(px, py);
        keep = d >= 0.0f;
        cross = keep != (pd >= 0.0f);
        if (cross) {             // the crossing point replaces (x, y) as
          const float den = __fsub_rn(pd, d);   // the first emission
          const float t = __fdiv_rn(pd, fabsf(den) > 0.0f ? den : 1.0f);
          // t (x - px) + px in one rounding, as nvcc contracts stage 1's
          const float ix = __fmaf_rn(t, __fsub_rn(x, px), px);
          const float iy = __fmaf_rn(t, __fsub_rn(y, py), py);
          if (!close) {
            px = x;
            py = y;
          }
          x = ix;
          y = iy;
        }
      } else if (!close) {       // its group is emitted at the close
        seen |= 1u << K;
        fx = x;
        fy = y;
      }
      if (!close) {
        px = cross ? px : x;
        py = cross ? py : y;
      }
    }
    // Emissions: (x, y), then the vertex again from this stage's state
    // (after a crossing); at the close, counted negative, then the close
    // token.  Only the count stays live across the next stage's code.
#pragma unroll 1
    for (int n = close ? -(int(cross) + int(keep) + 1)
                       : int(cross) + int(keep);
         n != 0; n += n < 0 ? 1 : -1) {
      if constexpr (K + 1 == N) {
        next.step(x, y, n == -1);
      } else {
        next.step(c, seen, x, y, n == -1);
      }
      x = n < 0 ? fx : px;
      y = n < 0 ? fy : py;
    }
  }

  __device__ __forceinline__ Shoelace& last() { return next.last(); }
};

// Copy the block's subject rings (V0 / 2 float4s each) into shared memory
// rows of V0 / 2 + 1 float4s: a quarter-warp's 16-byte reads at that
// stride fall in distinct banks.
template <int V0>
__device__ __forceinline__ void stage_rings(float4* rows,
                                            const float4* __restrict__ p4,
                                            int B) {
  constexpr int Q = V0 / 2;
  const int b0 = blockIdx.x * blockDim.x;
  const int n = min(static_cast<int>(blockDim.x), B - b0) * Q;
  const float4* src = p4 + static_cast<size_t>(b0) * Q;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const unsigned dst = static_cast<unsigned>(
        __cvta_generic_to_shared(rows + (c / Q) * (Q + 1) + c % Q));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src + c));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// Push the subject ring, two vertices a float4, then the close token.  The
// float4s sit in registers (kVector: a queue shifted by one every two
// vertices, so every index is a constant) or in this thread's shared-memory
// row (kStaged).
template <int V0, int ROUTE, class C, class P>
__device__ __forceinline__ void feed(P& pipe, const C& c,
                                     const float4* __restrict__ p4,
                                     const float4* row) {
  constexpr int Q = V0 / 2;
  unsigned seen = 0;
  if constexpr (ROUTE == kVector) {
    float4 w[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) w[i] = __ldg(p4 + i);
#pragma unroll 1
    for (int i = 0; i <= V0; ++i) {
      const bool odd = i & 1;
      pipe.step(c, seen, odd ? w[0].z : w[0].x, odd ? w[0].w : w[0].y,
                i == V0);
      if (odd) {
#pragma unroll
        for (int k = 0; k + 1 < Q; ++k) w[k] = w[k + 1];
      }
    }
  } else {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 1
    for (int i = 0; i <= V0; ++i) {
      const bool odd = i & 1;
      if (!odd && i < V0) v = row[i / 2];
      pipe.step(c, seen, odd ? v.z : v.x, odd ? v.w : v.y, i == V0);
    }
  }
}

// One pair a thread: subject ring (V0, 2) of polys against the rectangle
// (x0, y0, x1, y1) of `other` (VC == 0) or the convex clip ring (VC, 2).
template <int V0, int VC, int MINB, int ROUTE>
__global__ void __launch_bounds__(kMaxThreads, MINB)
clip_stream_kernel(const float* __restrict__ polys,
                   const float* __restrict__ other, float* __restrict__ area,
                   float* __restrict__ cent, int B) {
  extern __shared__ float4 rows[];
  const float4* p4 = reinterpret_cast<const float4*>(polys);
  if constexpr (ROUTE == kStaged) stage_rings<V0>(rows, p4, B);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float4* ring = p4 + static_cast<size_t>(b) * (V0 / 2);
  const float4* row = rows + threadIdx.x * (V0 / 2 + 1);
  if constexpr (VC == 0) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(other) + b);
    const Rect c{__fmul_rn(0.5f, __fsub_rn(r.z, r.x)),
                 __fmul_rn(0.5f, __fsub_rn(r.w, r.y))};
    Stage<0, 4, Rect> pipe;
    feed<V0, ROUTE>(pipe, c, ring, row);
    pipe.last().write(area, cent, b);
  } else {
    Ring<VC> c;
    const float4* c4 = reinterpret_cast<const float4*>(other) +
                       static_cast<size_t>(b) * (VC / 2);
#pragma unroll
    for (int i = 0; i < VC / 2; ++i) {
      const float4 v = __ldg(c4 + i);
      c.q[4 * i] = v.x;
      c.q[4 * i + 1] = v.y;
      c.q[4 * i + 2] = v.z;
      c.q[4 * i + 3] = v.w;
    }
    Stage<0, VC, Ring<VC>> pipe;
    feed<V0, ROUTE>(pipe, c, ring, row);
    pipe.last().write(area, cent, b);
  }
}

template <int V0, int VC, int MINB, int ROUTE>
int launch_stream(const void* polys, const void* other, void* area,
                  void* cent, int B, int threads, cudaStream_t s) {
  const int blocks = (B + threads - 1) / threads;
  const size_t smem =
      ROUTE == kStaged ? sizeof(float4) * threads * (V0 / 2 + 1) : 0;
  clip_stream_kernel<V0, VC, MINB, ROUTE><<<blocks, threads, smem, s>>>(
      static_cast<const float*>(polys), static_cast<const float*>(other),
      static_cast<float*>(area), static_cast<float*>(cent), B);
  return static_cast<int>(cudaGetLastError());
}

// Min blocks 2 (128 registers a thread) only for the shapes
// tools/sweep_clip.py sweeps; clip_poly at V0 = 16, Vc = 8 needs 141.
template <int V0, int VC>
int stream_shape(const void* polys, const void* other, void* area,
                 void* cent, int B, int threads, int min_blocks, int route,
                 cudaStream_t s) {
  constexpr bool kSwept = VC == 0 || (V0 == 8 && VC == 8);
#define ICEBIN_CLIP_AT(M, R)                                               \
  if (min_blocks == M && route == R)                                       \
    return launch_stream<V0, VC, M, R>(polys, other, area, cent, B,        \
                                       threads, s);
  ICEBIN_CLIP_AT(1, kVector)
  ICEBIN_CLIP_AT(1, kStaged)
  if constexpr (kSwept) {
    ICEBIN_CLIP_AT(2, kVector)
    ICEBIN_CLIP_AT(2, kStaged)
  }
#undef ICEBIN_CLIP_AT
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---- stage 1: the compacting kernels, kept as the yardstick -------------

constexpr int kThreads = 128;

// floor(3n / 2) applied `passes` times: the longest ring after the passes.
__host__ __device__ constexpr int ring_bound(int n, int passes) {
  return passes == 0 ? n : ring_bound(n + n / 2, passes - 1);
}
static_assert(ring_bound(8, 8) == 202 && ring_bound(16, 8) == 406,
              "ring bound of the header");

// Signed distance to the clip line of rectangle pass `side` (positive =
// inside): 0: x >= -h, 1: x <= h, 2: y >= -h, 3: y <= h.
__device__ __forceinline__ float dist(float x, float y, int side, float h) {
  switch (side) {
    case 0: return x + h;
    case 1: return h - x;
    case 2: return y + h;
    default: return h - y;
  }
}

// One pass: ring (px, py)[0, n) -> (qx, qy), keeping dist(x, y) >= 0.  Edge
// k (from vertex k-1 to vertex k) emits its crossing point, then vertex k if
// inside -- the reference's slot order with the invalid slots dropped.
// Returns the output length (at most floor(3n / 2), see the header).
template <class Dist>
__device__ __forceinline__ int halfplane(const float* px, const float* py,
                                         int n, float* qx, float* qy,
                                         Dist dist) {
  if (n == 0) return 0;
  int m = 0;
  float xp = px[n - 1];
  float yp = py[n - 1];
  float dp = dist(xp, yp);
  for (int k = 0; k < n; ++k) {
    const float x = px[k];
    const float y = py[k];
    const float d = dist(x, y);
    const bool in = d >= 0.0f;
    if (in != (dp >= 0.0f)) {
      const float den = dp - d;
      const float t = dp / (fabsf(den) > 0.0f ? den : 1.0f);
      qx[m] = xp + t * (x - xp);
      qy[m] = yp + t * (y - yp);
      ++m;
    }
    if (in) {
      qx[m] = x;
      qy[m] = y;
      ++m;
    }
    xp = x;
    yp = y;
    dp = d;
  }
  return m;
}

// Shoelace area and centroid of ring (x, y)[0, n), summed in f64, written
// to pair b.
__device__ __forceinline__ void finish(const float* x, const float* y, int n,
                                       float* area, float* cent, int b) {
  double a2 = 0.0, sx = 0.0, sy = 0.0;
  for (int k = 0; k < n; ++k) {
    const int j = (k + 1 == n) ? 0 : k + 1;
    const double cr = static_cast<double>(x[k]) * y[j]
                      - static_cast<double>(x[j]) * y[k];
    a2 += cr;
    sx += (static_cast<double>(x[k]) + x[j]) * cr;
    sy += (static_cast<double>(y[k]) + y[j]) * cr;
  }
  const double a = 0.5 * a2;
  area[b] = static_cast<float>(a);
  float cx = 0.0f, cy = 0.0f;
  if (a != 0.0) {
    cx = static_cast<float>(sx / (6.0 * a));
    cy = static_cast<float>(sy / (6.0 * a));
  } else if (n > 0) {          // degenerate ring: its first vertex
    cx = x[0];
    cy = y[0];
  }
  cent[2 * b] = cx;
  cent[2 * b + 1] = cy;
}

template <int V0>
__global__ void clip_rect_kernel(const float* __restrict__ polys,
                                 const float* __restrict__ rects,
                                 float* __restrict__ area,
                                 float* __restrict__ cent, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  // pass outputs: 2, 4, 8, 16 x V0 slots, alternating between the buffers
  float ax[16 * V0], ay[16 * V0];
  float bx[8 * V0], by[8 * V0];
  const float* p = polys + static_cast<size_t>(b) * V0 * 2;
#pragma unroll
  for (int i = 0; i < V0; ++i) {
    ax[i] = p[2 * i];
    ay[i] = p[2 * i + 1];
  }
  const float* r = rects + static_cast<size_t>(b) * 4;
  const float hx = 0.5f * (r[2] - r[0]);
  const float hy = 0.5f * (r[3] - r[1]);
  auto side = [](int s, float h) {
    return [=](float x, float y) { return dist(x, y, s, h); };
  };
  int n = halfplane(ax, ay, V0, bx, by, side(0, hx));
  n = halfplane(bx, by, n, ax, ay, side(1, hx));
  n = halfplane(ax, ay, n, bx, by, side(2, hy));
  n = halfplane(bx, by, n, ax, ay, side(3, hy));
  finish(ax, ay, n, area, cent, b);
}

template <int V0, int VC>
__global__ void clip_poly_kernel(const float* __restrict__ polys,
                                 const float* __restrict__ clips,
                                 float* __restrict__ area,
                                 float* __restrict__ cent, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  constexpr int kCap = ring_bound(V0, VC);
  float ax[kCap], ay[kCap], bx[kCap], by[kCap];
  const float* p = polys + static_cast<size_t>(b) * V0 * 2;
#pragma unroll
  for (int i = 0; i < V0; ++i) {
    ax[i] = p[2 * i];
    ay[i] = p[2 * i + 1];
  }
  float qx[VC], qy[VC];
  const float* q = clips + static_cast<size_t>(b) * VC * 2;
#pragma unroll
  for (int i = 0; i < VC; ++i) {
    qx[i] = q[2 * i];
    qy[i] = q[2 * i + 1];
  }
  // skipped passes leave the ring where it is, so the buffers swap by
  // pointer rather than by pass parity
  float *sx = ax, *sy = ay, *dx = bx, *dy = by;
  int n = V0;
#pragma unroll
  for (int k = 0; k < VC; ++k) {
    const int k1 = (k + 1 == VC) ? 0 : k + 1;
    const float x0 = qx[k], y0 = qy[k];
    const float ex = __fsub_rn(qx[k1], x0);
    const float ey = __fsub_rn(qy[k1], y0);
    if (ex == 0.0f && ey == 0.0f) continue;    // zero-length edge: no-op
    // d = (bx - ax)(y - ay) - (by - ay)(x - ax), rounded as the reference
    // rounds it (no contraction into FMAs), so that in/out decisions on
    // near-degenerate vertices are the reference's
    n = halfplane(sx, sy, n, dx, dy, [=](float x, float y) {
      return __fsub_rn(__fmul_rn(ex, __fsub_rn(y, y0)),
                       __fmul_rn(ey, __fsub_rn(x, x0)));
    });
    float* t = sx; sx = dx; dx = t;
    t = sy; sy = dy; dy = t;
  }
  finish(sx, sy, n, area, cent, b);
}

}  // namespace

extern "C" {

// Stage 2 at an explicit geometry (tools/sweep_clip.py, the card tests):
// vc = 0 clips against rectangles as clip_rect does, vc = 4 or 8 against
// clip rings as clip_poly does; threads a block a multiple of 32 up to
// 256, min_blocks 1 or, for the swept shapes (v0 8 or 16 with vc 0, v0 8
// with vc 8), 2 (__launch_bounds__(256, min_blocks)), route 0 (registers)
// or 1 (cp.async into shared memory).
int clip_stream_at(const void* polys, const void* other, void* area,
                   void* cent, int B, int v0, int vc, int threads,
                   int min_blocks, int route, void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ICEBIN_CLIP_SHAPE(V, C)                                            \
  if (v0 == V && vc == C)                                                  \
    return stream_shape<V, C>(polys, other, area, cent, B, threads,        \
                              min_blocks, route, s);
  ICEBIN_CLIP_SHAPE(8, 0)
  ICEBIN_CLIP_SHAPE(16, 0)
  ICEBIN_CLIP_SHAPE(8, 4)
  ICEBIN_CLIP_SHAPE(8, 8)
  ICEBIN_CLIP_SHAPE(16, 4)
  ICEBIN_CLIP_SHAPE(16, 8)
#undef ICEBIN_CLIP_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}

// polys (B, v0, 2), rects (B, 4) as (x0, y0, x1, y1) centred on the origin,
// area (B,), cent (B, 2); all f32, contiguous and 16-byte aligned.  v0 must
// be 8 or 16.  Stage 2 at the rule's geometry.  Launches on the caller's
// stream and returns cudaGetLastError().
int clip_rect(const void* polys, const void* rects, void* area, void* cent,
              int B, int v0, void* stream) {
  return clip_stream_at(polys, rects, area, cent, B, v0, 0, kRuleThreads,
                        kRuleMinBlocks, kRuleRoute, stream);
}

// polys (B, v0, 2) subject rings, clips (B, vc, 2) convex CCW clip rings
// (duplicate-padded), both recentred on the clip ring; area (B,), cent
// (B, 2); all f32, contiguous and 16-byte aligned.  v0 must be 8 or 16, vc
// 4 or 8.  Stage 2 at the rule's geometry.  Launches on the caller's
// stream and returns cudaGetLastError().
int clip_poly(const void* polys, const void* clips, void* area, void* cent,
              int B, int v0, int vc, void* stream) {
  return clip_stream_at(polys, clips, area, cent, B, v0, vc, kRuleThreads,
                        kRuleMinBlocks, kRuleRoute, stream);
}

// Stage 1 (the compacting kernels, rings in per-thread buffers), with
// clip_rect's and clip_poly's arguments.
int clip_rect_compact(const void* polys, const void* rects, void* area,
                      void* cent, int B, int v0, void* stream) {
  if (B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* P = static_cast<const float*>(polys);
    const float* R = static_cast<const float*>(rects);
    float* A = static_cast<float*>(area);
    float* C = static_cast<float*>(cent);
    if (v0 == 8) {
      clip_rect_kernel<8><<<blocks, kThreads, 0, s>>>(P, R, A, C, B);
    } else if (v0 == 16) {
      clip_rect_kernel<16><<<blocks, kThreads, 0, s>>>(P, R, A, C, B);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int clip_poly_compact(const void* polys, const void* clips, void* area,
                      void* cent, int B, int v0, int vc, void* stream) {
  if (B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* P = static_cast<const float*>(polys);
    const float* Q = static_cast<const float*>(clips);
    float* A = static_cast<float*>(area);
    float* C = static_cast<float*>(cent);
    if (v0 == 8 && vc == 4) {
      clip_poly_kernel<8, 4><<<blocks, kThreads, 0, s>>>(P, Q, A, C, B);
    } else if (v0 == 8 && vc == 8) {
      clip_poly_kernel<8, 8><<<blocks, kThreads, 0, s>>>(P, Q, A, C, B);
    } else if (v0 == 16 && vc == 4) {
      clip_poly_kernel<16, 4><<<blocks, kThreads, 0, s>>>(P, Q, A, C, B);
    } else if (v0 == 16 && vc == 8) {
      clip_poly_kernel<16, 8><<<blocks, kThreads, 0, s>>>(P, Q, A, C, B);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
