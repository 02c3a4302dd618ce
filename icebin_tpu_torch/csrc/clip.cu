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
// What bounds it on the H100: at the Greenland 5 km x ModelE 2x2.5 build,
// 305,970 pairs of 8-vertex rings are 20 MB in and 3.7 MB out, a few
// microseconds of HBM time; the work is ~100 dependent f32 operations per
// vertex per pass on one thread, so the kernel is bound by per-thread
// latency and by local-memory traffic for the ring buffers.
//
// What the design does about it: one thread owns one pair.  The TPU kernels
// kept every slot of a ring that doubles per pass and forward-filled the
// invalid ones (a TPU cannot gather); here each pass compacts, writing only
// the vertices it emits, so the later passes loop over the real ring
// instead of V0 * 2^passes slots (duplicate vertices add nothing to the
// shoelace sum, so the area is the same polygon's).  The shoelace sums run
// in f64.
//
// Ring bound (both kernels are total for every ring they accept, non-convex
// subjects included).  A pass over an n-slot ring with I slots inside emits
// the I inside vertices plus one crossing point per change of side along
// the ring.  Each maximal run of inside slots is entered and left once, so
// the changes number 2 * (number of inside runs) <= 2 * min(I, n - I), and
// the output has at most I + 2 * min(I, n - I) <= floor(3n / 2) vertices
// (the maximum, at I = n / 2).  Iterating floor(3n / 2) over the passes:
//   rect, 4 passes:  V0 = 8 -> 40;  V0 = 16 -> 81   (buffers: 16 * V0, the
//                                                    reference's own bound)
//   poly, Vc = 4:    V0 = 8 -> 40;  V0 = 16 -> 81
//   poly, Vc = 8:    V0 = 8 -> 12, 18, 27, 40, 60, 90, 135, 202;
//                    V0 = 16 -> 406
// clip_poly sizes its buffers to ring_bound(V0, Vc), the last entry; the
// reference's doubling buffers end at V0 * 2^Vc (2048 and 4096 slots).  A
// zero-length clip edge (duplicate-padded clip ring) gives d == 0 for every
// vertex, which keeps the ring as it is: clip_poly skips that pass, with
// the same result, so a hexagon padded to 8 slots pays 6 passes.
//
// Degenerate rings: a clipped ring of zero area gets its first remaining
// vertex as centroid, (0, 0) if none remains (the reference takes slot 0
// of its forward-filled buffer).  The exchange assembly drops such pairs
// (min_area_frac), so the convention is never read.

#include <cuda_runtime.h>

namespace {

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

// polys (B, v0, 2), rects (B, 4) as (x0, y0, x1, y1) centred on the origin,
// area (B,), cent (B, 2); all f32 and contiguous.  v0 must be 8 or 16.
// Launches on the caller's stream and returns cudaGetLastError().
int clip_rect(const void* polys, const void* rects, void* area, void* cent,
              int B, int v0, void* stream) {
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

// polys (B, v0, 2) subject rings, clips (B, vc, 2) convex CCW clip rings
// (duplicate-padded), both recentred on the clip ring; area (B,), cent
// (B, 2); all f32 and contiguous.  v0 must be 8 or 16, vc 4 or 8.
// Launches on the caller's stream and returns cudaGetLastError().
int clip_poly(const void* polys, const void* clips, void* area, void* cent,
              int B, int v0, int vc, void* stream) {
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
