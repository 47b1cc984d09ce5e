// K7 lane_threshold: thresholded reductions and downloads of lane seeds,
// replacing HopEngine.lane_verdicts (ffn_tpu/inference/hop_engine.py:1209),
// FloodFillEngine.lane_mask_region (engine.py:446) and lane_mask_regions
// (:489): per-lane counts of unclaimed voxels >= the segment threshold and
// the origin's move verdict; one box's uint8 mask; N boxes packed into one
// buffer with their verdicts, one copy a round. NaN thresholds to False.
// Seeds float32 or bfloat16 (one body; the wrapper rounds the thresholds to
// bfloat16 first, as `thr.astype(seed.dtype)`: ops/lane.py).
//
// Bound on the H100: bandwidth (a verdict call reads every lane's seeds
// once: 589 MB at 64 lanes of 132^3). Design: one CTA per (chunk, lane),
// coalesced grid-stride loads, a warp-shuffle block sum and one int32
// atomicAdd per CTA (exact in any order); masks are elementwise grids.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr uint8_t kClaimed = 1;

template <typename T>
__global__ void __launch_bounds__(kThreads)
lane_count_kernel(const T* __restrict__ seeds, const int* __restrict__ sv,
                  const int* __restrict__ start,
                  const uint8_t* __restrict__ blocked, int* counts,
                  uint8_t* origin_ok, int Y, int X, long long vol,
                  float seg_t, float move_t) {
  __shared__ int warp_counts[kThreads / 32];
  const int b = blockIdx.y;
  const T* seed = seeds + (size_t)b * vol;
  const uint8_t* blk = blocked + (size_t)sv[b] * vol;
  const long long chunk = (long long)kThreads * kPerThread;
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < vol ? lo + chunk : vol;
  int count = 0;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
    count += (seed_load(seed + i) >= seg_t) && (blk[i] & kClaimed) == 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_counts[w];
    if (total) atomicAdd(counts + b, total);
    if (blockIdx.x == 0) {
      const int* s = start + 3 * b;
      origin_ok[b] =
          seed_load(seed + ((size_t)s[0] * Y + s[1]) * X + s[2]) >= move_t;
    }
  }
}

template <typename T>
__global__ void lane_mask_kernel(const T* __restrict__ seed,
                                 uint8_t* __restrict__ mask,
                                 uint8_t* origin_ok, int Y, int X, int z0,
                                 int y0, int x0, int bz, int by, int bx,
                                 long long origin, float thr, float move_t) {
  const int n = bz * by * bx;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const int c = i % bx, b = (i / bx) % by, a = i / (bx * by);
    mask[i] = seed_load(seed + ((size_t)(z0 + a) * Y + y0 + b) * X + x0 + c) >=
              thr;
  }
  if (i == 0) origin_ok[0] = seed_load(seed + origin) >= move_t;
}

// One box per blockIdx.y: table row [lane, z0, y0, x0, bz, by, bx, oz, oy,
// ox] (box corner and size in bounds, origin), offsets[j] its first byte.
template <typename T>
__global__ void lane_masks_kernel(const T* __restrict__ seeds,
                                  const int* __restrict__ table,
                                  const long long* __restrict__ offsets,
                                  uint8_t* __restrict__ out, int Y, int X,
                                  long long vol, long long total, float thr,
                                  float move_t) {
  const int j = blockIdx.y;
  const int* t = table + 10 * j;
  const T* seed = seeds + (size_t)t[0] * vol;
  const int bz = t[4], by = t[5], bx = t[6];
  const long long n = (long long)bz * by * bx;
  uint8_t* mask = out + offsets[j];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = i % bx, b = (i / bx) % by, a = i / ((long long)bx * by);
    mask[i] =
        seed_load(seed + ((size_t)(t[1] + a) * Y + t[2] + b) * X + t[3] + c) >=
        thr;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    out[total + j] =
        seed_load(seed + ((size_t)t[7] * Y + t[8]) * X + t[9]) >= move_t;
}

}  // namespace

// seeds (B,Z,Y,X) f32 (bf16 where bf16 != 0, with the thresholds already
// rounded to it), sv (B,), start (B,3), blocked (K,Z,Y,X) u8; counts (B,)
// int32 must be zeroed by the caller; origin_ok (B,) u8.
extern "C" int ffn_lane_verdicts(const void* seeds, const void* sv,
                                 const void* start, const void* blocked,
                                 void* counts, void* origin_ok, int B, int Z,
                                 int Y, int X, float seg_t, float move_t,
                                 int bf16, void* stream) {
  const long long vol = (long long)Z * Y * X;
  const long long chunk = (long long)kThreads * kPerThread;
  const dim3 grid((unsigned)((vol + chunk - 1) / chunk), B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* svp = static_cast<const int*>(sv);
  const int* sp = static_cast<const int*>(start);
  const uint8_t* bp = static_cast<const uint8_t*>(blocked);
  int* cp = static_cast<int*>(counts);
  uint8_t* op = static_cast<uint8_t*>(origin_ok);
  if (bf16)
    lane_count_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(seeds), svp, sp, bp, cp, op, Y, X,
        vol, seg_t, move_t);
  else
    lane_count_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(seeds), svp, sp, bp, cp, op, Y, X, vol,
        seg_t, move_t);
  return static_cast<int>(cudaGetLastError());
}

// The (bz,by,bx) box at (z0,y0,x0) of lane `lane` of seeds (B,Z,Y,X), in
// bounds; origin (oz,oy,ox) is the lane's segment origin.
extern "C" int ffn_lane_mask(const void* seeds, void* mask, void* origin_ok,
                             int lane, int Z, int Y, int X, int z0, int y0,
                             int x0, int bz, int by, int bx, int oz, int oy,
                             int ox, float thr, float move_t, int bf16,
                             void* stream) {
  const size_t at = (size_t)lane * Z * Y * X;
  const int n = bz * by * bx;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long origin = ((long long)oz * Y + oy) * X + ox;
  uint8_t* mp = static_cast<uint8_t*>(mask);
  uint8_t* op = static_cast<uint8_t*>(origin_ok);
  if (bf16)
    lane_mask_kernel<<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(seeds) + at, mp, op, Y, X, z0, y0,
        x0, bz, by, bx, origin, thr, move_t);
  else
    lane_mask_kernel<<<blocks, threads, 0, st>>>(
        static_cast<const float*>(seeds) + at, mp, op, Y, X, z0, y0, x0, bz,
        by, bx, origin, thr, move_t);
  return static_cast<int>(cudaGetLastError());
}

// N boxes (table (N,10) int32, offsets (N,) int64, as lane_masks_kernel
// reads them); out holds `total` mask bytes, then N verdict bytes.
extern "C" int ffn_lane_masks(const void* seeds, const void* table,
                              const void* offsets, void* out, int N, int Z,
                              int Y, int X, long long max_box,
                              long long total, float thr, float move_t,
                              int bf16, void* stream) {
  const int threads = 256;
  long long chunks = (max_box + threads - 1) / threads;
  if (chunks > 1024) chunks = 1024;  // grid-stride beyond
  const dim3 grid((unsigned)(chunks > 0 ? chunks : 1), N);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tp = static_cast<const int*>(table);
  const long long* offp = static_cast<const long long*>(offsets);
  uint8_t* outp = static_cast<uint8_t*>(out);
  const long long vol = (long long)Z * Y * X;
  if (bf16)
    lane_masks_kernel<<<grid, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(seeds), tp, offp, outp, Y, X, vol,
        total, thr, move_t);
  else
    lane_masks_kernel<<<grid, threads, 0, st>>>(
        static_cast<const float*>(seeds), tp, offp, outp, Y, X, vol, total,
        thr, move_t);
  return static_cast<int>(cudaGetLastError());
}
