// Device helpers of the flood-fill kernels (step.cu, hop.cu, lane.cu,
// finalize.cu, select.cu). Lane seeds (POM logits, NaN = unvisited) are
// float32 or bfloat16 (FFN_TPU_SEED_DTYPE=bf16, engine.py:63-67), read
// through seed_load (exact) and written through seed_store (round to
// nearest even, NaN stays NaN); seed_round is what a store keeps. Starts
// follow lax.dynamic_(update_)slice (wrap once, then clamp); face maxima
// follow _face_scores (engine.py:177-209) with jnp.argmax's order; the
// disco-seed test is _apply_model's (engine.py:115-117).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ inline float seed_load(const float* p) { return *p; }
__device__ inline float seed_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ inline void seed_store(float* p, float v) { *p = v; }
__device__ inline void seed_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <typename T>
__device__ inline float seed_round(float v) { return v; }
template <>
__device__ inline float seed_round<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ inline float f32_nan() { return __int_as_float(0x7fc00000); }
__device__ inline float f32_neg_inf() { return __int_as_float(0xff800000); }

__host__ __device__ inline int clamp_start(int start, int shape, int size) {
  if (start < 0) start += shape;
  return start < 0 ? 0 : (start > shape - size ? shape - size : start);
}

__device__ inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// jnp.argmax's order: NaN above everything (the first NaN wins), then the
// larger value, then the smaller index.
__device__ inline bool better(float v, int i, float w, int j) {
  const bool nv = isnan(v), nw = isnan(w);
  if (nv || nw) return nv && (!nw || i < j);
  return v > w || (v == w && i < j);
}

// Counts the pred crop (qz, qy, qx) of the model output `lg` (fz, fy, fx)
// at or above move_t, block-wide, and returns whether the disco-seed mask
// applies. warp_counts holds blockDim.x / 32 ints of shared memory.
__device__ inline bool disco_applies(const float* lg, int fz, int fy, int fx,
                                     int qz, int qy, int qx, float move_t,
                                     float disco_t, int* warp_counts) {
  __shared__ int apply_s;
  const int dz = (fz - qz) / 2, dy = (fy - qy) / 2, dx = (fx - qx) / 2;
  const int n = qz * qy * qx;
  int count = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i % qx, b = (i / qx) % qy, a = i / (qx * qy);
    count += lg[((size_t)(a + dz) * fy + b + dy) * fx + c + dx] >= move_t;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += warp_counts[w];
    // jnp.mean of a 0/1 f32 vector: an exact count, one IEEE division.
    const float frac = __fdiv_rn((float)total, (float)n);
    apply_s = (disco_t >= 0.f) && (frac > disco_t);
  }
  __syncthreads();
  return apply_s != 0;
}

// One warp's face maximum: face f = 2 * axis + (sign > 0) of the pred-size
// patch whose voxel (a, b, c) is patch[a * sa + b * sb + c], for raw deltas
// r (0 disables an axis: its faces score -inf at offset 0). Lane 0 writes
// the score and the offset from the patch center. `patch` (float32, or a
// box of bfloat16 seeds) may be written earlier in the same kernel, so it is
// read through the coherent path.
template <typename T>
__device__ inline void face_max_warp(const T* patch, size_t sa,
                                     size_t sb, int qz, int qy, int qx,
                                     int r0, int r1, int r2, int f,
                                     float* score, int* off) {
  const int wl = threadIdx.x & 31;
  const int axis = f >> 1, sign = (f & 1) ? 1 : -1;
  const int raw[3] = {r0, r1, r2};
  const int cen[3] = {qz / 2, qy / 2, qx / 2};
  const int d = raw[axis];
  const int a0 = axis == 0 ? 1 : 0, a1 = axis == 2 ? 1 : 2;  // other axes
  float best = f32_neg_inf();
  int best_i = 0x7fffffff;
  const int n0 = 2 * raw[a0] + 1, n1 = 2 * raw[a1] + 1;
  if (d > 0) {
    for (int j = wl; j < n0 * n1; j += 32) {
      int q[3];
      q[axis] = cen[axis] + sign * d;
      q[a0] = cen[a0] - raw[a0] + j / n1;
      q[a1] = cen[a1] - raw[a1] + j % n1;
      const float v = seed_load(patch + q[0] * sa + q[1] * sb + q[2]);
      if (better(v, j, best, best_i)) {
        best = v;
        best_i = j;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, best, o);
    const int j = __shfl_down_sync(0xffffffffu, best_i, o);
    if (better(v, j, best, best_i)) {
      best = v;
      best_i = j;
    }
  }
  if (wl == 0) {
    if (d > 0) {
      *score = best;
      off[axis] = sign * d;
      off[a0] = best_i / n1 - raw[a0];
      off[a1] = best_i % n1 - raw[a1];
    } else {
      *score = f32_neg_inf();
      off[0] = off[1] = off[2] = 0;
    }
  }
}

}  // namespace
