// K2 step_gather and K3 step_update: the two ends of one serial FFN step,
// replacing FloodFillEngine._step_impl (ffn_tpu/inference/engine.py:121-136)
// and _apply_model's non-model part (:88-119) around K1. K2: the image and
// seed patches at pos - size/2, NaN -> pad. K3: the crop, the disco-seed
// fraction mean(logits >= move_t), the keep-old mask, the write-back.
// ops/step.py gives where bfloat16 seeds round (one body per kernel).
//
// Bound on the H100: latency (a 144 KB patch beside K1's milliseconds).
// Design: K2 one elementwise grid; K3 one CTA, because its reduction decides
// every output and the region it writes may overlap the one it reads `old`
// from: it counts, writes the returned patch, and after a barrier copies it
// into the seed buffer. Starts follow lax.dynamic_(update_)slice.

#include "common.cuh"

namespace {

struct Box {
  int z, y, x;     // start in the volume
  int sz, sy, sx;  // size
};

template <typename T>
__global__ void step_gather_kernel(const float* __restrict__ image,
                                   const T* __restrict__ seed,
                                   float* __restrict__ image_patch,
                                   float* __restrict__ seed_in, int Y, int X,
                                   Box ib, Box sb, float pad) {
  const int n_img = ib.sz * ib.sy * ib.sx;
  const int n_seed = sb.sz * sb.sy * sb.sx;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_img) {
    const int c = i % ib.sx, b = (i / ib.sx) % ib.sy, a = i / (ib.sx * ib.sy);
    image_patch[i] = image[((size_t)(ib.z + a) * Y + ib.y + b) * X + ib.x + c];
  }
  if (i < n_seed) {
    const int c = i % sb.sx, b = (i / sb.sx) % sb.sy, a = i / (sb.sx * sb.sy);
    const float v =
        seed_load(seed + ((size_t)(sb.z + a) * Y + sb.y + b) * X + sb.x + c);
    seed_in[i] = isnan(v) ? pad : v;
  }
}

constexpr int kUpdateThreads = 1024;

template <typename T>
__global__ void __launch_bounds__(kUpdateThreads)
step_update_kernel(const float* __restrict__ logits, T* seed,
                   float* __restrict__ patch, int Y, int X, int fy, int fx,
                   int dz, int dy, int dx, Box old_box, Box write_box,
                   float move_t, float disco_t) {
  __shared__ int warp_counts[kUpdateThreads / 32];
  __shared__ int apply_mask;
  const int py = old_box.sy, px = old_box.sx;
  const int n = old_box.sz * py * px;
  const int tid = threadIdx.x;

  int count = 0;
  for (int i = tid; i < n; i += kUpdateThreads) {
    const int c = i % px, b = (i / px) % py, a = i / (px * py);
    count += logits[((size_t)(a + dz) * fy + b + dy) * fx + c + dx] >= move_t;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if ((tid & 31) == 0) warp_counts[tid >> 5] = count;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kUpdateThreads / 32; ++w) total += warp_counts[w];
    // jnp.mean of a 0/1 float32 vector: exact f32 sum, then one IEEE
    // division (no reciprocal), so `frac > disco_t` decides as XLA does.
    const float frac = __fdiv_rn((float)total, (float)n);
    apply_mask = (disco_t >= 0.f) && (frac > disco_t);
  }
  __syncthreads();
  const bool apply = apply_mask != 0;

  for (int i = tid; i < n; i += kUpdateThreads) {
    const int c = i % px, b = (i / px) % py, a = i / (px * py);
    const float v = logits[((size_t)(a + dz) * fy + b + dy) * fx + c + dx];
    const float old = seed_load(
        seed + ((size_t)(old_box.z + a) * Y + old_box.y + b) * X + old_box.x +
        c);
    // (old < 0) is false for NaN: unvisited voxels always take the update.
    patch[i] = (apply && old < 0.f && v > old) ? old : v;
  }
  __syncthreads();  // every `old` is read before any seed voxel is written
  for (int i = tid; i < n; i += kUpdateThreads) {
    const int c = i % px, b = (i / px) % py, a = i / (px * py);
    seed_store(seed + ((size_t)(write_box.z + a) * Y + write_box.y + b) * X +
                   write_box.x + c,
               patch[i]);
  }
}

template <typename T>
void launch_gather(const float* image, const void* seed, float* image_patch,
                   float* seed_in, int n, int Y, int X, const Box& ib,
                   const Box& sb, float pad, void* stream) {
  const int threads = 256;
  step_gather_kernel<T><<<(n + threads - 1) / threads, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      image, static_cast<const T*>(seed), image_patch, seed_in, Y, X, ib, sb,
      pad);
}

template <typename T>
void launch_update(const float* logits, void* seed, float* patch, int Y,
                   int X, int fy, int fx, int dz, int dy, int dx,
                   const Box& old_box, const Box& write_box, float move_t,
                   float disco_t, void* stream) {
  step_update_kernel<T><<<1, kUpdateThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      logits, static_cast<T*>(seed), patch, Y, X, fy, fx, dz, dy, dx,
      old_box, write_box, move_t, disco_t);
}

}  // namespace

// image (Z,Y,X); seed (Z,Y,X), bfloat16 where bf16 != 0, else float32;
// image_patch (iz,iy,ix); seed_in (sz,sy,sx).
extern "C" int ffn_step_gather(const float* image, const void* seed,
                               float* image_patch, float* seed_in, int Z,
                               int Y, int X, int pz, int py, int px, int iz,
                               int iy, int ix, int sz, int sy, int sx,
                               float pad, int bf16, void* stream) {
  const Box ib{clamp_start(pz - iz / 2, Z, iz), clamp_start(py - iy / 2, Y, iy),
               clamp_start(px - ix / 2, X, ix), iz, iy, ix};
  const Box sb{clamp_start(pz - sz / 2, Z, sz), clamp_start(py - sy / 2, Y, sy),
               clamp_start(px - sx / 2, X, sx), sz, sy, sx};
  const int n_img = iz * iy * ix, n_seed = sz * sy * sx;
  const int n = n_img > n_seed ? n_img : n_seed;
  (bf16 ? launch_gather<__nv_bfloat16> : launch_gather<float>)(
      image, seed, image_patch, seed_in, n, Y, X, ib, sb, pad, stream);
  return static_cast<int>(cudaGetLastError());
}

// logits (fz,fy,fx): the model output at the seed patch; seed (Z,Y,X),
// bfloat16 where bf16 != 0, is updated in place; patch (qz,qy,qx) receives
// the values before the write-back's rounding.
extern "C" int ffn_step_update(const float* logits, void* seed, float* patch,
                               int Z, int Y, int X, int pz, int py, int px,
                               int fz, int fy, int fx, int qz, int qy, int qx,
                               float move_t, float disco_t, int bf16,
                               void* stream) {
  const int dz = (fz - qz) / 2, dy = (fy - qy) / 2, dx = (fx - qx) / 2;
  // `old` comes from the clamped seed patch; the write start is the
  // unclamped seed start plus the pred delta, clamped on its own
  // (engine.py:129-134).
  const Box old_box{clamp_start(pz - fz / 2, Z, fz) + dz,
                    clamp_start(py - fy / 2, Y, fy) + dy,
                    clamp_start(px - fx / 2, X, fx) + dx, qz, qy, qx};
  const Box write_box{clamp_start(pz - fz / 2 + dz, Z, qz),
                      clamp_start(py - fy / 2 + dy, Y, qy),
                      clamp_start(px - fx / 2 + dx, X, qx), qz, qy, qx};
  (bf16 ? launch_update<__nv_bfloat16> : launch_update<float>)(
      logits, seed, patch, Y, X, fy, fx, dz, dy, dx, old_box, write_box,
      move_t, disco_t, stream);
  return static_cast<int>(cudaGetLastError());
}
