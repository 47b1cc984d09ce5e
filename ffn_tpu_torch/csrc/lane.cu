// K7 lane_threshold: thresholded reductions and downloads of lane seeds.
//
// Replace: HopEngine.lane_verdicts (ffn_tpu/inference/hop_engine.py:1209)
// and FloodFillEngine.lane_mask_region (ffn_tpu/inference/engine.py:446),
// the host-finalize path's two reads of a lane's POM:
//   verdicts  per lane, the count of unclaimed voxels >= the segment
//             threshold over its whole (Z,Y,X) buffer, and whether its
//             origin is >= the move threshold;
//   mask      the uint8 (seed >= threshold) mask of one lane's bucketed
//             box, and the origin's verdict.
// NaN (unvisited) thresholds to False in both, as the comparisons do.
//
// Bound on the H100: device-memory bandwidth. A verdict call reads every
// lane's seed buffer once (64 lanes of 132^3 f32: 589 MB), plus the shared
// blocked volume, which stays in L2. Design: one CTA per (chunk, lane),
// coalesced grid-stride loads, a warp-shuffle block sum and one int32
// atomicAdd per CTA; an integer sum is exact in any order, so the count
// equals the plain version's. The mask is one elementwise grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr uint8_t kClaimed = 1;

__global__ void __launch_bounds__(kThreads)
lane_count_kernel(const float* __restrict__ seeds, const int* __restrict__ sv,
                  const int* __restrict__ start,
                  const uint8_t* __restrict__ blocked, int* counts,
                  uint8_t* origin_ok, int Y, int X, long long vol,
                  float seg_t, float move_t) {
  __shared__ int warp_counts[kThreads / 32];
  const int b = blockIdx.y;
  const float* seed = seeds + (size_t)b * vol;
  const uint8_t* blk = blocked + (size_t)sv[b] * vol;
  const long long chunk = (long long)kThreads * kPerThread;
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < vol ? lo + chunk : vol;
  int count = 0;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
    count += (seed[i] >= seg_t) && (blk[i] & kClaimed) == 0;
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
      origin_ok[b] = seed[((size_t)s[0] * Y + s[1]) * X + s[2]] >= move_t;
    }
  }
}

__global__ void lane_mask_kernel(const float* __restrict__ seed,
                                 uint8_t* __restrict__ mask,
                                 uint8_t* origin_ok, int Y, int X, int z0,
                                 int y0, int x0, int bz, int by, int bx,
                                 long long origin, float thr, float move_t) {
  const int n = bz * by * bx;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const int c = i % bx, b = (i / bx) % by, a = i / (bx * by);
    mask[i] = seed[((size_t)(z0 + a) * Y + y0 + b) * X + x0 + c] >= thr;
  }
  if (i == 0) origin_ok[0] = seed[origin] >= move_t;
}

}  // namespace

// seeds (B,Z,Y,X) f32, sv (B,), start (B,3), blocked (K,Z,Y,X) u8;
// counts (B,) int32 must be zeroed by the caller; origin_ok (B,) u8.
extern "C" int ffn_lane_verdicts(const void* seeds, const void* sv,
                                 const void* start, const void* blocked,
                                 void* counts, void* origin_ok, int B, int Z,
                                 int Y, int X, float seg_t, float move_t,
                                 void* stream) {
  const long long vol = (long long)Z * Y * X;
  const long long chunk = (long long)kThreads * kPerThread;
  const dim3 grid((unsigned)((vol + chunk - 1) / chunk), B);
  lane_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(seeds), static_cast<const int*>(sv),
      static_cast<const int*>(start), static_cast<const uint8_t*>(blocked),
      static_cast<int*>(counts), static_cast<uint8_t*>(origin_ok), Y, X, vol,
      seg_t, move_t);
  return static_cast<int>(cudaGetLastError());
}

// The (bz,by,bx) box at (z0,y0,x0) of lane `lane` of seeds (B,Z,Y,X), in
// bounds; origin (oz,oy,ox) is the lane's segment origin.
extern "C" int ffn_lane_mask(const void* seeds, void* mask, void* origin_ok,
                             int lane, int Z, int Y, int X, int z0, int y0,
                             int x0, int bz, int by, int bx, int oz, int oy,
                             int ox, float thr, float move_t, void* stream) {
  const float* seed =
      static_cast<const float*>(seeds) + (size_t)lane * Z * Y * X;
  const int n = bz * by * bx;
  const int threads = 256;
  lane_mask_kernel<<<(n + threads - 1) / threads, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      seed, static_cast<uint8_t*>(mask), static_cast<uint8_t*>(origin_ok), Y,
      X, z0, y0, x0, bz, by, bx, ((long long)oz * Y + oy) * X + ox, thr,
      move_t);
  return static_cast<int>(cudaGetLastError());
}
