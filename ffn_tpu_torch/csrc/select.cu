// K13 select_gather and K14 select_update: one round of the round-based
// batched flood fill around the conv stack, replacing
// FloodFillEngine._select_step_impl and its packed jit (ffn_tpu/inference/
// engine.py:211-293, :387-403) and _step_batch_impl (:138-175, the same two
// kernels with K = 1 and `ignore` everywhere); ops/select.py gives the
// semantics and where bfloat16 seeds round (one body per kernel, templated
// on the seed type).
//   K13 per lane: start and candidate values against the move threshold,
//       the first ok candidate, executed, pos; the image and seed patches
//       (NaN -> pad) at pos; a record [executed, chosen, start_ok, pz, py,
//       px] left on the device for K14.
//   K14 per lane: the crop and disco mask, the write-back where executed,
//       the six face maxima of the written box (-inf where not executed),
//       the packed (B, 30) row; every lane's masked crop in `masked`.
// Bound on the H100: bytes (4 and 3 x 143,748 B a lane; a compare a voxel).
// Design: K13 one elementwise grid, a y-row of blocks per lane, each block
// recomputing its lane's choice in thread 0 (no second launch or host
// read); K14 one CTA per lane, as K6 (scratch, a barrier, then the copy;
// six warps for the face maxima). K1 runs on all B lanes, as JAX's vmap.

#include "common.cuh"

namespace {

struct SelectGatherParams {
  int B, K, Z, Y, X;
  int iz, iy, ix;  // image patch size
  int sz, sy, sx;  // seed patch size
  float move_t, pad;
};

// seed[z, y, x] of one lane with jnp's indexing of a traced index: a
// negative index wraps once, then it clamps into the volume.
template <typename T>
__device__ inline float seed_at(const T* seed, const SelectGatherParams& p,
                                const int* zyx) {
  const int z = clamp_start(zyx[0], p.Z, 1), y = clamp_start(zyx[1], p.Y, 1),
            x = clamp_start(zyx[2], p.X, 1);
  return seed_load(seed + ((size_t)z * p.Y + y) * p.X + x);
}

template <typename T>
__global__ void select_gather_kernel(const float* __restrict__ image,
                                     const T* __restrict__ seeds,
                                     const int* __restrict__ packed,
                                     float* __restrict__ img_out,
                                     float* __restrict__ seed_out,
                                     int* __restrict__ rec,
                                     SelectGatherParams p) {
  __shared__ int pos_s[3];
  const int b = blockIdx.y;
  const size_t vol = (size_t)p.Z * p.Y * p.X;
  const T* seed = seeds + (size_t)b * vol;
  if (threadIdx.x == 0) {
    const int* row = packed + (size_t)b * (3 * p.K + 5);
    const int* start = row + 3 * p.K;
    const bool active = start[3] > 0, ignore = start[4] > 0;
    const bool start_ok = seed_at(seed, p, start) >= p.move_t || ignore;
    int chosen = -1;
    for (int k = 0; k < p.K && chosen < 0; ++k) {
      if (seed_at(seed, p, row + 3 * k) >= p.move_t || (k == 0 && ignore))
        chosen = k;
    }
    const int* pos = row + 3 * (chosen > 0 ? chosen : 0);
    pos_s[0] = pos[0];
    pos_s[1] = pos[1];
    pos_s[2] = pos[2];
    if (blockIdx.x == 0) {
      int* r = rec + 6 * b;
      r[0] = active && start_ok && chosen >= 0;
      r[1] = chosen;
      r[2] = start_ok;
      r[3] = pos[0];
      r[4] = pos[1];
      r[5] = pos[2];
    }
  }
  __syncthreads();
  const int pz = pos_s[0], py = pos_s[1], px = pos_s[2];
  const int n_img = p.iz * p.iy * p.ix, n_seed = p.sz * p.sy * p.sx;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_img) {
    const int z0 = clamp_start(pz - p.iz / 2, p.Z, p.iz);
    const int y0 = clamp_start(py - p.iy / 2, p.Y, p.iy);
    const int x0 = clamp_start(px - p.ix / 2, p.X, p.ix);
    const int c = i % p.ix, bb = (i / p.ix) % p.iy, a = i / (p.ix * p.iy);
    img_out[(size_t)b * n_img + i] =
        image[((size_t)(z0 + a) * p.Y + y0 + bb) * p.X + x0 + c];
  }
  if (i < n_seed) {
    const int z0 = clamp_start(pz - p.sz / 2, p.Z, p.sz);
    const int y0 = clamp_start(py - p.sy / 2, p.Y, p.sy);
    const int x0 = clamp_start(px - p.sx / 2, p.X, p.sx);
    const int c = i % p.sx, bb = (i / p.sx) % p.sy, a = i / (p.sx * p.sy);
    const float v =
        seed_load(seed + ((size_t)(z0 + a) * p.Y + y0 + bb) * p.X + x0 + c);
    seed_out[(size_t)b * n_seed + i] = isnan(v) ? p.pad : v;
  }
}

constexpr int kUpdateThreads = 1024;
constexpr int kPackedColumns = 30;

struct SelectUpdateParams {
  int Z, Y, X;
  int fz, fy, fx;  // seed patch (= model output) size
  int qz, qy, qx;  // pred size
  int r0, r1, r2;  // raw deltas (0 disables an axis's faces)
  float move_t, disco_t;
};

template <typename T>
__global__ void __launch_bounds__(kUpdateThreads)
select_update_kernel(const float* __restrict__ logits, T* seeds,
                     const int* __restrict__ rec, float* masked,
                     float* __restrict__ packed, SelectUpdateParams p) {
  __shared__ int warp_counts[kUpdateThreads / 32];
  __shared__ float face_score[6];
  __shared__ int face_off[6][3];
  const int b = blockIdx.x;
  const int* r = rec + 6 * b;
  const bool executed = r[0] != 0;
  const int pz = r[3], py = r[4], px = r[5];
  T* seed = seeds + (size_t)b * p.Z * p.Y * p.X;
  const float* lg = logits + (size_t)b * p.fz * p.fy * p.fx;
  const int n = p.qz * p.qy * p.qx;
  float* out = masked + (size_t)b * n;
  const int dz = (p.fz - p.qz) / 2, dy = (p.fy - p.qy) / 2,
            dx = (p.fx - p.qx) / 2;
  const int sz0 = pz - p.fz / 2, sy0 = py - p.fy / 2, sx0 = px - p.fx / 2;
  const int oz = clamp_start(sz0, p.Z, p.fz) + dz,
            oy = clamp_start(sy0, p.Y, p.fy) + dy,
            ox = clamp_start(sx0, p.X, p.fx) + dx;
  const int wz = clamp_start(sz0 + dz, p.Z, p.qz),
            wy = clamp_start(sy0 + dy, p.Y, p.qy),
            wx = clamp_start(sx0 + dx, p.X, p.qx);

  const bool apply = disco_applies(lg, p.fz, p.fy, p.fx, p.qz, p.qy, p.qx,
                                   p.move_t, p.disco_t, warp_counts);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i % p.qx, bb = (i / p.qx) % p.qy, a = i / (p.qx * p.qy);
    const float v = lg[((size_t)(a + dz) * p.fy + bb + dy) * p.fx + c + dx];
    const float old =
        seed_load(seed + ((size_t)(oz + a) * p.Y + oy + bb) * p.X + ox + c);
    // (old < 0) is false for NaN: unvisited voxels always take the update.
    out[i] = (apply && old < 0.f && v > old) ? old : v;
  }
  __syncthreads();  // every `old` is read before any seed voxel is written
  T* box = seed + ((size_t)wz * p.Y + wy) * p.X + wx;
  const size_t sa = (size_t)p.Y * p.X, sb = p.X;
  if (executed) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int c = i % p.qx, bb = (i / p.qx) % p.qy, a = i / (p.qx * p.qy);
      seed_store(box + a * sa + bb * sb + c, out[i]);
    }
  }
  __syncthreads();

  // Face maxima of the written (rounded) box (the old values where the
  // lane did not execute): warp f takes face f.
  const int warp = threadIdx.x >> 5;
  if (warp < 6)
    face_max_warp(box, sa, sb, p.qz, p.qy, p.qx, p.r0, p.r1, p.r2, warp,
                  &face_score[warp], face_off[warp]);
  __syncthreads();

  if (threadIdx.x == 0) {
    float* row = packed + (size_t)b * kPackedColumns;
    row[0] = executed ? 1.f : 0.f;
    row[1] = (float)r[1];
    row[2] = r[2] ? 1.f : 0.f;
    for (int f = 0; f < 6; ++f) {
      row[3 + f] = executed ? face_score[f] : f32_neg_inf();
      for (int a = 0; a < 3; ++a) row[9 + 3 * f + a] = (float)face_off[f][a];
    }
    row[27] = (float)pz;
    row[28] = (float)py;
    row[29] = (float)px;
  }
}

template <typename T>
void launch_gather(const void* image, const void* seeds, const void* packed,
                   void* img_out, void* seed_out, void* rec, dim3 grid,
                   const SelectGatherParams& p, void* stream) {
  select_gather_kernel<T><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(image), static_cast<const T*>(seeds),
      static_cast<const int*>(packed), static_cast<float*>(img_out),
      static_cast<float*>(seed_out), static_cast<int*>(rec), p);
}

template <typename T>
void launch_update(const void* logits, void* seeds, const void* rec,
                   void* masked, void* packed, int B,
                   const SelectUpdateParams& p, void* stream) {
  select_update_kernel<T><<<B, kUpdateThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<T*>(seeds),
      static_cast<const int*>(rec), static_cast<float*>(masked),
      static_cast<float*>(packed), p);
}

}  // namespace

// image (Z,Y,X); seeds (B,Z,Y,X), bfloat16 where bf16 != 0, else float32;
// packed (B, 3K+5) int32: K candidates, start, active, ignore per lane.
extern "C" int ffn_select_gather(const void* image, const void* seeds,
                                 const void* packed, void* img_out,
                                 void* seed_out, void* rec, int B, int K,
                                 int Z, int Y, int X, int iz, int iy, int ix,
                                 int sz, int sy, int sx, float move_t,
                                 float pad, int bf16, void* stream) {
  if (B < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  SelectGatherParams p{B, K, Z, Y, X, iz, iy, ix, sz, sy, sx, move_t, pad};
  const int n_img = iz * iy * ix, n_seed = sz * sy * sx;
  const int n = n_img > n_seed ? n_img : n_seed;
  const dim3 grid((n + 255) / 256, B);
  (bf16 ? launch_gather<__nv_bfloat16> : launch_gather<float>)(
      image, seeds, packed, img_out, seed_out, rec, grid, p, stream);
  return static_cast<int>(cudaGetLastError());
}

// logits (B, fz,fy,fx): lane b's model output; rec (B, 6) from K13; seeds
// bfloat16 where bf16 != 0.
extern "C" int ffn_select_update(const void* logits, void* seeds,
                                 const void* rec, void* masked, void* packed,
                                 int B, int Z, int Y, int X, int fz, int fy,
                                 int fx, int qz, int qy, int qx, int r0,
                                 int r1, int r2, float move_t, float disco_t,
                                 int bf16, void* stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  SelectUpdateParams p{Z, Y, X, fz, fy, fx, qz, qy, qx, r0, r1, r2,
                       move_t, disco_t};
  (bf16 ? launch_update<__nv_bfloat16> : launch_update<float>)(
      logits, seeds, rec, masked, packed, B, p, stream);
  return static_cast<int>(cudaGetLastError());
}
