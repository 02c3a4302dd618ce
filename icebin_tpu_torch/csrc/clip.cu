// Batched Sutherland--Hodgman clip of subject rings against centred
// rectangles, with the shoelace area and centroid of each clipped ring.
//
// Replaces the Pallas TPU kernel icebin_tpu/ops/pallas_clip.py:_clip_kernel
// (driven by clip_areas_centroids_pallas), which builds the exchange grid.
// Inputs are recentred per pair by the caller, so each rectangle is
// [-hx, hx] x [-hy, hy] and coordinates are O(cell size); f32 then carries
// ~1e-7 relative accuracy and the host's f64 repair makes column sums exact.
//
// What bounds it on the H100: at the Greenland 5 km x ModelE 2x2.5 build,
// 305,970 pairs of 8-vertex rings are 20 MB in and 3.7 MB out, a few
// microseconds of HBM time; the work is ~100 dependent f32 operations per
// vertex per pass on one thread, so the kernel is bound by per-thread
// latency and by local-memory traffic for the ring buffers.
//
// What the design does about it: one thread owns one pair.  The TPU kernel
// kept every slot of a ring that doubles per pass and forward-filled the
// invalid ones (a TPU cannot gather); here each pass compacts, writing only
// the vertices it emits, so the later passes loop over the real ring
// instead of 16 * V0 slots (duplicate vertices add nothing to the shoelace
// sum, so the area is the same polygon's).  The buffers are sized to the
// reference's bound, 16 * V0 slots after four passes (pallas_clip.py V0_MAX
// note), so the kernel is total for every ring it accepts, non-convex
// subjects included.  The shoelace sums run in f64.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// Signed distance to the clip line of pass `side` (positive = inside):
// 0: x >= -h, 1: x <= h, 2: y >= -h, 3: y <= h.
__device__ __forceinline__ float dist(float x, float y, int side, float h) {
  switch (side) {
    case 0: return x + h;
    case 1: return h - x;
    case 2: return y + h;
    default: return h - y;
  }
}

// One pass: ring (px, py)[0, n) -> (qx, qy), keeping dist >= 0.  Edge k
// (from vertex k-1 to vertex k) emits its crossing point, then vertex k if
// inside -- the reference's slot order with the invalid slots dropped.
// Returns the output length (at most 2n).
__device__ int halfplane(const float* px, const float* py, int n, float* qx,
                         float* qy, int side, float h) {
  if (n == 0) return 0;
  int m = 0;
  float xp = px[n - 1];
  float yp = py[n - 1];
  float dp = dist(xp, yp, side, h);
  for (int k = 0; k < n; ++k) {
    const float x = px[k];
    const float y = py[k];
    const float d = dist(x, y, side, h);
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
  int n = halfplane(ax, ay, V0, bx, by, 0, hx);
  n = halfplane(bx, by, n, ax, ay, 1, hx);
  n = halfplane(ax, ay, n, bx, by, 2, hy);
  n = halfplane(bx, by, n, ax, ay, 3, hy);

  double a2 = 0.0, sx = 0.0, sy = 0.0;
  for (int k = 0; k < n; ++k) {
    const int j = (k + 1 == n) ? 0 : k + 1;
    const double cr = static_cast<double>(ax[k]) * ay[j]
                      - static_cast<double>(ax[j]) * ay[k];
    a2 += cr;
    sx += (static_cast<double>(ax[k]) + ax[j]) * cr;
    sy += (static_cast<double>(ay[k]) + ay[j]) * cr;
  }
  const double a = 0.5 * a2;
  area[b] = static_cast<float>(a);
  float cx = 0.0f, cy = 0.0f;
  if (a != 0.0) {
    cx = static_cast<float>(sx / (6.0 * a));
    cy = static_cast<float>(sy / (6.0 * a));
  } else if (n > 0) {          // degenerate ring: its first vertex
    cx = ax[0];
    cy = ay[0];
  }
  cent[2 * b] = cx;
  cent[2 * b + 1] = cy;
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

}  // extern "C"
