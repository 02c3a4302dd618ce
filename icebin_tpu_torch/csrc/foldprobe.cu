// Sublane<->lane folds of a warp's tile, the fold probe:
//   reshape_down  (32, 8) -> (4, 64), row-major:   out.flat = x.flat
//   reshape_up    (4, 64) -> (32, 8), row-major:   out.flat = x.flat
//   v1_fold       (32, 8) -> (4, 64):  out[t, 8 r + v] = x[4 r + t, v]
//   v1_unfold     (4, 64) -> (32, 8):  out[4 r + t, v] = x[t, 8 r + v]
// on B tiles of f32 or f64, tile b at x + 256 b.  Every fold is a
// permutation, so the result is bit for bit torch.reshape / torch.cat of
// the input (ops/foldprobe.py's plain versions).
//
// Replaces the Pallas TPU instrument tools/probe_fold_ops.py:16 (the
// pallas_call in `run`) over its six bodies: k_reshape_down :35,
// k_reshape_up :38, k_subslice_concat :41 (the V1 fold), k_laneslice_concat
// :46 (its inverse), and k_block_fold :71 / k_block_reshape :78 (the same
// folds over 64 tiles).  The TPU probe asked whether Mosaic compiles these
// folds at all; on Hopper every one compiles, and the question that carries
// over is which route moves a warp's tile between the two layouts, and at
// what cost:
//   smem  the warp writes its tile to shared memory, __syncwarp(), and
//         reads it back in the new order (rows padded one bank every 128
//         bytes, so the layout-A write and the layout-B write are free of
//         bank conflicts);
//   shfl  the tile stays in registers; elements move between lanes only
//         through __shfl_sync, eight rounds of one shuffle per lane, each
//         round a permutation of the lanes (an f64 shuffle is two 32-bit
//         shuffles, so the f64 instance moves twice the registers).
// That is the stage-2 dest-small kernel's choice: spmm.cu's dest_small
// kernel combines its 32 lanes' f64 partials of 16 fields with 16 shuffle
// trees (spmm.cu:74-84), about a quarter of its time, and the alternative
// is to combine them through shared memory.
//
// The two layouts in registers, eight elements a lane (one warp, one tile):
//   A, the (32, 8) view: lane l holds row l, v[k] = x[8 l + k];
//   B, the (4, 64) view: lane l holds columns 2l, 2l + 1 of every row,
//      v[2 t + j] = x[64 t + 2 l + j].
// Layout A loads and stores as 16-byte vectors, layout B as 8-byte (f32)
// or 16-byte (f64) pairs; each warp instruction stays within its 1 or 2 KB
// tile.
//
// What bounds it on the H100: bytes.  A call reads B tiles and writes B
// tiles, 2 * 256 * B * sizeof(T) bytes (132.7 MB in f32 and 265.4 MB in f64
// at B = 64,800, one tile per E row of Greenland's EvI) and does no
// arithmetic; the routes' own cost shows where the data stays in the 50 MB
// L2 (B = 16,384: 33.5 MB in f32) or at small B, where the launch dominates.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRegs = 8;                 // elements of a tile per lane
constexpr int kTile = kWarp * kRegs;     // 256
constexpr int kWarps = 8;                // tiles (warps) per block
constexpr unsigned kFull = 0xffffffffu;

enum Fold { kReshapeDown = 0, kReshapeUp = 1, kV1Fold = 2, kV1Unfold = 3 };
enum Route { kSmem = 0, kShfl = 1 };

// one padding element every 128 bytes of the shared tile
template <typename T>
constexpr int kPadEvery = 128 / static_cast<int>(sizeof(T));
template <typename T>
constexpr int kPadded = kTile + kTile / kPadEvery<T>;

template <typename T>
__device__ __forceinline__ int pad(int i) {
  return i + i / kPadEvery<T>;
}

// -- global loads and stores of the two layouts ----------------------------

__device__ __forceinline__ void load_a(const float* t, int lane,
                                       float (&v)[kRegs]) {
  const float4* p = reinterpret_cast<const float4*>(t + kRegs * lane);
  const float4 a = p[0], b = p[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load_a(const double* t, int lane,
                                       double (&v)[kRegs]) {
  const double2* p = reinterpret_cast<const double2*>(t + kRegs * lane);
#pragma unroll
  for (int i = 0; i < kRegs / 2; ++i) {
    const double2 e = p[i];
    v[2 * i] = e.x;
    v[2 * i + 1] = e.y;
  }
}

__device__ __forceinline__ void store_a(float* t, int lane,
                                        const float (&v)[kRegs]) {
  float4* p = reinterpret_cast<float4*>(t + kRegs * lane);
  p[0] = make_float4(v[0], v[1], v[2], v[3]);
  p[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store_a(double* t, int lane,
                                        const double (&v)[kRegs]) {
  double2* p = reinterpret_cast<double2*>(t + kRegs * lane);
#pragma unroll
  for (int i = 0; i < kRegs / 2; ++i)
    p[i] = make_double2(v[2 * i], v[2 * i + 1]);
}

template <typename T> struct Pair;
template <> struct Pair<float> {
  using type = float2;
  static __device__ __forceinline__ float2 make(float a, float b) {
    return make_float2(a, b);
  }
};
template <> struct Pair<double> {
  using type = double2;
  static __device__ __forceinline__ double2 make(double a, double b) {
    return make_double2(a, b);
  }
};

template <typename T>
__device__ __forceinline__ void load_b(const T* t, int lane, T (&v)[kRegs]) {
  using P = typename Pair<T>::type;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const P e = *reinterpret_cast<const P*>(t + 64 * r + 2 * lane);
    v[2 * r] = e.x;
    v[2 * r + 1] = e.y;
  }
}

template <typename T>
__device__ __forceinline__ void store_b(T* t, int lane, const T (&v)[kRegs]) {
  using P = typename Pair<T>::type;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<P*>(t + 64 * r + 2 * lane) =
        Pair<T>::make(v[2 * r], v[2 * r + 1]);
}

// flat index in the tile of register k of `lane` in layout A or B
__device__ __forceinline__ int flat(bool layout_a, int lane, int k) {
  return layout_a ? kRegs * lane + k : 64 * (k >> 1) + 2 * lane + (k & 1);
}

// flat input index of output element o under fold F
template <int F>
__device__ __forceinline__ int source(int o) {
  if (F == kV1Fold) {              // o = 64 t + 8 r + v  <-  (4 r + t, v)
    const int t = o >> 6, c = o & 63;
    return ((c >> 3) * 4 + t) * 8 + (c & 7);
  }
  if (F == kV1Unfold) {            // o = 8 (4 r + t) + v  <-  (t, 8 r + v)
    const int row = o >> 3;
    return (row & 3) * 64 + (row >> 2) * 8 + (o & 7);
  }
  return o;                        // the reshapes keep the flat order
}

// -- the shuffle route ------------------------------------------------------

// v[m] for a lane-dependent m, by selects (no local memory)
template <typename T>
__device__ __forceinline__ T pick(const T (&v)[kRegs], int m) {
  T r = v[0];
#pragma unroll
  for (int q = 1; q < kRegs; ++q) r = (m == q) ? v[q] : r;
  return r;
}

template <typename T>
__device__ __forceinline__ void place(T (&o)[kRegs], int k, T val) {
#pragma unroll
  for (int q = 0; q < kRegs; ++q)
    if (k == q) o[q] = val;
}

// Round rho = 2 h + j pairs each A-side lane (row 8 t + q for a reshape,
// 4 q + t for a V1 fold) with the B-side lane 4 q + p, p = (t - h) mod 4:
// the A lane's register 2 p + j is the B lane's register 2 t + j.  For a
// fixed rho the pairing is a permutation of the lanes, so one shuffle moves
// one element of every lane, in either direction.
template <int F, typename T>
__device__ __forceinline__ void fold_shfl(const T (&v)[kRegs], T (&o)[kRegs],
                                          int lane) {
  constexpr bool reshape = F == kReshapeDown || F == kReshapeUp;
  constexpr bool down = F == kReshapeDown || F == kV1Fold;
  const int ta = reshape ? lane >> 3 : lane & 3;   // this lane as A side
  const int qa = reshape ? lane & 7 : lane >> 2;
  const int qb = lane >> 2, pb = lane & 3;         // this lane as B side
#pragma unroll
  for (int rho = 0; rho < kRegs; ++rho) {
    const int j = rho & 1, h = rho >> 1;
    const int pa = (ta - h) & 3;                   // A lane's partner's p
    const int tb = (h + pb) & 3;                   // B lane's partner's t
    if (down) {                  // A (input) -> B (output)
      const int src = reshape ? 8 * tb + qb : 4 * qb + tb;
      place(o, 2 * tb + j, __shfl_sync(kFull, pick(v, 2 * pa + j), src));
    } else {                     // B (input) -> A (output)
      place(o, 2 * pa + j,
            __shfl_sync(kFull, pick(v, 2 * tb + j), 4 * qa + pa));
    }
  }
}

// -- the kernel -------------------------------------------------------------

template <int F, int R, typename T>
__global__ void __launch_bounds__(kWarps * kWarp)
fold_tiles_kernel(const T* __restrict__ x, T* __restrict__ out, int tiles) {
  constexpr bool down = F == kReshapeDown || F == kV1Fold;
  __shared__ __align__(16) T s[R == kSmem ? kWarps * kPadded<T> : 1];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long tile = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (tile >= tiles) return;                // whole warp leaves together
  const T* xt = x + tile * kTile;
  T* ot = out + tile * kTile;
  T v[kRegs], o[kRegs];
  if constexpr (down) load_a(xt, lane, v); else load_b(xt, lane, v);
  if constexpr (R == kSmem) {
    T* st = s + warp * kPadded<T>;          // this warp's tile, input order
#pragma unroll
    for (int k = 0; k < kRegs; ++k) st[pad<T>(flat(down, lane, k))] = v[k];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kRegs; ++k)
      o[k] = st[pad<T>(source<F>(flat(!down, lane, k)))];
  } else {
    fold_shfl<F>(v, o, lane);
  }
  if constexpr (down) store_b(ot, lane, o); else store_a(ot, lane, o);
}

template <typename T>
int launch(const void* x, void* out, int tiles, int fold, int route,
           cudaStream_t stream) {
  using Kernel = void (*)(const T*, T*, int);
  const Kernel table[4][2] = {
      {fold_tiles_kernel<kReshapeDown, kSmem, T>,
       fold_tiles_kernel<kReshapeDown, kShfl, T>},
      {fold_tiles_kernel<kReshapeUp, kSmem, T>,
       fold_tiles_kernel<kReshapeUp, kShfl, T>},
      {fold_tiles_kernel<kV1Fold, kSmem, T>,
       fold_tiles_kernel<kV1Fold, kShfl, T>},
      {fold_tiles_kernel<kV1Unfold, kSmem, T>,
       fold_tiles_kernel<kV1Unfold, kShfl, T>}};
  if (fold < 0 || fold > 3 || route < 0 || route > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles > 0) {
    const int blocks = (tiles + kWarps - 1) / kWarps;
    table[fold][route]<<<blocks, kWarps * kWarp, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (tiles, 32, 8) or (tiles, 4, 64) as the fold takes it, out the other
// shape, both contiguous and 16-byte aligned (the wrapper checks); fold 0-3
// as enum Fold, route 0 smem, 1 shfl; f64 0 for f32, 1 for f64.  Launch on
// the caller's stream, no synchronisation; return cudaGetLastError().
int fold_tiles(const void* x, void* out, int tiles, int fold, int route,
               int f64, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(x, out, tiles, fold, route, s)
             : launch<float>(x, out, tiles, fold, route, s);
}

}  // extern "C"
