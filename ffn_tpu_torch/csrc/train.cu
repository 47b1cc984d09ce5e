// K11 train_step_ops (the scan step's passes around the conv stack and the
// optimizer) and K16 fov_loss, replacing parts of ffn_tpu/training/
// train_lib.py; ops/train.py gives the semantics:
//   train_prep    the packed prelude (:239-248);
//   train_gather  one offset's gate and crops (:341-355, fixed_window
//                 :326-335), the model input's concatenation fused;
//   train_loss    the masked CE max(x,0) - x z + log1p(exp(-|x|)), the loss
//                 sum_b valid_b mean(ce w)_b / max(sum valid, 1), dlogits
//                 valid w (sigmoid(x) - z) / (V max(sum valid, 1)), the
//                 logits' write-back for valid lanes, the counts (:357-401);
//   train_eval    the eval crop's CE and exact tp/fp/fn/tn (:255-266);
//   fov_loss      make_fov_train_step's ungated mean(ce w) and w (sigmoid(x)
//                 - z) / N (:425-505); at x = 0 exactly -w z / N, as jax.grad.
// train_loss and fov_loss multiply dlogits by the loss scale (a device float
// or 1): the gradient of `scale_loss(loss)` (:364, :469), exact for the
// power of two the scale is. Crop starts come from the host.
//
// Bound on the H100: bytes (49^3 canvases, 33^3 patches); each pass is one
// launch, so latency dominates. Reductions are deterministic: blocks write
// partial sums, the last block (an integer ticket) adds them in order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Dims {
  int z, y, x;
};

__device__ __forceinline__ size_t at3(const Dims& d, int z, int y, int x) {
  return ((size_t)z * d.y + y) * d.x + x;
}

// Deterministic block sum (fixed shuffle tree, then warps in order).
__device__ float block_sum(float v, float* s_warp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += s_warp[w];
  __syncthreads();
  return s;  // valid in thread 0
}

__device__ int block_sum_int(int v, int* s_warp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += s_warp[w];
  __syncthreads();
  return s;
}

// Thread 0: true in the last block to arrive (after its partials are out).
__device__ bool last_block(unsigned* ticket) {
  __threadfence();
  const unsigned total = gridDim.x * gridDim.y;
  return atomicAdd(ticket, 1u) == total - 1;
}

__global__ void train_prep_kernel(const uint8_t* __restrict__ img_u8,
                                  const uint8_t* __restrict__ lom_u8,
                                  float* __restrict__ images,
                                  float* __restrict__ labels,
                                  float* __restrict__ seeds, size_t n_img,
                                  size_t n_lab, int B, Dims s, float mean,
                                  float stddev, float lab_hi, float lab_lo,
                                  float pad_logit, float init_logit) {
  const size_t svol = (size_t)s.z * s.y * s.x;
  const size_t center = at3(s, s.z / 2, s.y / 2, s.x / 2);
  const size_t n = max(max(n_img, n_lab), (size_t)B * svol);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    if (i < n_img) images[i] = (static_cast<float>(img_u8[i]) - mean) / stddev;
    if (i < n_lab) labels[i] = lom_u8[i] > 0 ? lab_hi : lab_lo;
    if (i < (size_t)B * svol) seeds[i] = (i % svol) == center ? init_logit
                                                              : pad_logit;
  }
}

struct GatherArgs {
  Dims s, im, lab, fov;
  Dims s0, i0;        // crop starts in the seed and image canvases
  Dims sv, lv;        // centre-value positions in the seed and label canvases
  Dims sc, lc;        // canvas centres (window test)
  Dims off, delta;    // the offset (zyx) and max(deltas, 0) (zyx)
  int window, radius;
  float move_t, label_t;
};

// `any` over the delta shell within +-radius of the offset (fixed_window).
__device__ bool window_any(const float* vol, Dims d, Dims c, const GatherArgs& a,
                           float level, int* s_flag) {
  if (threadIdx.x == 0) *s_flag = 0;
  __syncthreads();
  const int nz = 2 * a.delta.z + 1, ny = 2 * a.delta.y + 1,
            nx = 2 * a.delta.x + 1;
  int hit = 0;
  for (int i = threadIdx.x; i < nz * ny * nx; i += blockDim.x) {
    const int hz = i / (ny * nx) - a.delta.z, hy = (i / nx) % ny - a.delta.y,
              hx = i % nx - a.delta.x;
    const bool shell = abs(hz) == a.delta.z || abs(hy) == a.delta.y ||
                       abs(hx) == a.delta.x;
    const bool in_window = abs(hz - a.off.z) <= a.radius &&
                           abs(hy - a.off.y) <= a.radius &&
                           abs(hx - a.off.x) <= a.radius;
    if (shell && in_window && vol[at3(d, c.z + hz, c.y + hy, c.x + hx)] >= level)
      hit = 1;
  }
  if (hit) atomicOr(s_flag, 1);
  __syncthreads();
  const bool any = *s_flag != 0;
  __syncthreads();  // all have read it before the next call resets it
  return any;
}

__global__ void train_gather_kernel(const float* __restrict__ seeds,
                                    const float* __restrict__ images,
                                    const float* __restrict__ labels,
                                    float* __restrict__ x_in,
                                    float* __restrict__ seed_patch,
                                    uint8_t* __restrict__ valid,
                                    uint8_t* __restrict__ wanted, int B,
                                    int crop_blocks, GatherArgs a) {
  const size_t svol = (size_t)a.s.z * a.s.y * a.s.x;
  if ((int)blockIdx.x >= crop_blocks) {  // the gate of lane b
    __shared__ int s_flag;
    const int b = blockIdx.x - crop_blocks;
    const float* sb = seeds + b * svol;
    const float* lb = labels + b * (size_t)a.lab.z * a.lab.y * a.lab.x;
    const bool centre = a.off.z == 0 && a.off.y == 0 && a.off.x == 0;
    bool v, w;
    if (a.window && !centre) {
      v = window_any(sb, a.s, a.sc, a, a.move_t, &s_flag);
      w = window_any(lb, a.lab, a.lc, a, a.label_t, &s_flag);
    } else {
      v = sb[at3(a.s, a.sv.z, a.sv.y, a.sv.x)] >= a.move_t;
      w = lb[at3(a.lab, a.lv.z, a.lv.y, a.lv.x)] >= a.label_t;
    }
    if (threadIdx.x == 0) {
      valid[b] = v;
      wanted[b] = w;
    }
    return;
  }
  const size_t fvol = (size_t)a.fov.z * a.fov.y * a.fov.x;
  const size_t ivol = (size_t)a.im.z * a.im.y * a.im.x;
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= (size_t)B * fvol) return;
  const int b = i / fvol;
  const int v = i % fvol;
  const int z = v / (a.fov.y * a.fov.x), y = (v / a.fov.x) % a.fov.y,
            x = v % a.fov.x;
  const float sv = seeds[b * svol + at3(a.s, a.s0.z + z, a.s0.y + y, a.s0.x + x)];
  const float iv = images[b * ivol + at3(a.im, a.i0.z + z, a.i0.y + y, a.i0.x + x)];
  reinterpret_cast<float2*>(x_in)[i] = make_float2(iv, sv);
  seed_patch[i] = sv;
}

struct LossArgs {
  Dims fov, s, lab;
  Dims w0, l0;  // write-back start in the seed canvas, crop start in labels
  int chunk;    // voxels of one lane per block
};

__global__ void train_loss_kernel(const float* __restrict__ logits,
                                  float* __restrict__ seeds,
                                  const float* __restrict__ labels,
                                  const float* __restrict__ weights,
                                  const uint8_t* __restrict__ valid,
                                  const uint8_t* __restrict__ wanted,
                                  float* __restrict__ dlogits,
                                  float* __restrict__ partial,
                                  unsigned* __restrict__ ticket,
                                  float* __restrict__ metrics,
                                  const float* __restrict__ scale, int B,
                                  LossArgs a) {
  __shared__ float s_warp[kThreads / 32];
  __shared__ bool s_last;
  const int b = blockIdx.y;
  const int V = a.fov.z * a.fov.y * a.fov.x;
  const size_t svol = (size_t)a.s.z * a.s.y * a.s.x;
  const size_t lvol = (size_t)a.lab.z * a.lab.y * a.lab.x;
  int nvalid = 0;
  for (int j = 0; j < B; ++j) nvalid += valid[j] != 0;
  const float denom = fmaxf(static_cast<float>(nvalid), 1.f);
  const float valid_f = valid[b] ? 1.f : 0.f;
  // d loss / d per_lane_b = valid_b / denom; the mean divides by V.
  const float coef = __fdiv_rn(__fdiv_rn(valid_f, denom), static_cast<float>(V));
  const float sc = scale != nullptr ? *scale : 1.f;

  float sum = 0.f;
  const int v0 = blockIdx.x * a.chunk, v1 = min(v0 + a.chunk, V);
  for (int v = v0 + threadIdx.x; v < v1; v += blockDim.x) {
    const int z = v / (a.fov.y * a.fov.x), y = (v / a.fov.x) % a.fov.y,
              x = v % a.fov.x;
    const size_t li = b * lvol + at3(a.lab, a.l0.z + z, a.l0.y + y, a.l0.x + x);
    const float lx = logits[(size_t)b * V + v];
    const float lz = labels[li];
    const float w = weights != nullptr ? weights[li] : 1.f;
    const float ce = __fadd_rn(__fsub_rn(fmaxf(lx, 0.f), __fmul_rn(lx, lz)),
                               log1pf(expf(-fabsf(lx))));
    sum += __fmul_rn(ce, w);
    const float e = expf(-fabsf(lx));
    // jax.grad of sigmoid_ce at lx = 0 exactly is -lz (as fov_loss); a NaN
    // fails both tests and stays NaN.
    const float sig =
        lx == 0.f ? 0.f : lx > 0.f ? 1.f / (1.f + e) : e / (1.f + e);
    dlogits[(size_t)b * V + v] =
        __fmul_rn(__fmul_rn(__fmul_rn(coef, w), __fsub_rn(sig, lz)), sc);
    if (valid[b])
      seeds[b * svol + at3(a.s, a.w0.z + z, a.w0.y + y, a.w0.x + x)] = lx;
  }
  const float s = block_sum(sum, s_warp);
  if (threadIdx.x == 0) {
    partial[(size_t)b * gridDim.x + blockIdx.x] = s;
    s_last = last_block(ticket);
  }
  __syncthreads();
  if (!s_last || threadIdx.x != 0) return;
  __threadfence();
  float loss = 0.f;
  int correct = 0, missed = 0, spurious = 0;
  for (int j = 0; j < B; ++j) {
    float lane = 0.f;
    for (unsigned c = 0; c < gridDim.x; ++c)
      lane += __ldcg(partial + (size_t)j * gridDim.x + c);
    // An invalid lane adds nothing, even a NaN (as the JAX step reports
    // its loss; its gradient still carries the NaN, 0 * NaN).
    if (valid[j]) loss += __fdiv_rn(lane, static_cast<float>(V));
    correct += valid[j] && wanted[j];
    missed += wanted[j] && !valid[j];
    spurious += valid[j] && !wanted[j];
  }
  metrics[0] = __fdiv_rn(loss, denom);
  metrics[1] = static_cast<float>(nvalid);
  metrics[2] = static_cast<float>(correct);
  metrics[3] = static_cast<float>(missed);
  metrics[4] = static_cast<float>(spurious);
  *ticket = 0u;
}

struct EvalArgs {
  Dims s, lab, ev;
  Dims s0, l0;  // centre-crop starts in the seed and label canvases
  int chunk;
};

__global__ void train_eval_kernel(const float* __restrict__ seeds,
                                  const float* __restrict__ labels,
                                  float* __restrict__ partial,
                                  int* __restrict__ ipartial,
                                  unsigned* __restrict__ ticket,
                                  float* __restrict__ patch_loss,
                                  int* __restrict__ counts, int B, EvalArgs a) {
  __shared__ float s_warp[kThreads / 32];
  __shared__ int s_iwarp[kThreads / 32];
  __shared__ bool s_last;
  const size_t evol = (size_t)a.ev.z * a.ev.y * a.ev.x;
  const size_t svol = (size_t)a.s.z * a.s.y * a.s.x;
  const size_t lvol = (size_t)a.lab.z * a.lab.y * a.lab.x;
  const size_t n = (size_t)B * evol;
  const size_t i0 = (size_t)blockIdx.x * a.chunk;
  const size_t i1 = min(i0 + a.chunk, n);
  float sum = 0.f;
  int c[4] = {0, 0, 0, 0};  // tp, fp, fn, tn
  for (size_t i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    const int b = i / evol;
    const int v = i % evol;
    const int z = v / (a.ev.y * a.ev.x), y = (v / a.ev.x) % a.ev.y,
              x = v % a.ev.x;
    const float lx = seeds[b * svol + at3(a.s, a.s0.z + z, a.s0.y + y, a.s0.x + x)];
    const float lz = labels[b * lvol + at3(a.lab, a.l0.z + z, a.l0.y + y, a.l0.x + x)];
    sum += __fadd_rn(__fsub_rn(fmaxf(lx, 0.f), __fmul_rn(lx, lz)),
                     log1pf(expf(-fabsf(lx))));
    const bool pred = lx > 0.f, truth = lz > 0.5f;
    c[pred ? (truth ? 0 : 1) : (truth ? 2 : 3)] += 1;
  }
  const float s = block_sum(sum, s_warp);
  int t[4];
  for (int k = 0; k < 4; ++k) t[k] = block_sum_int(c[k], s_iwarp);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = s;
    for (int k = 0; k < 4; ++k) ipartial[4 * blockIdx.x + k] = t[k];
    s_last = last_block(ticket);
  }
  __syncthreads();
  if (!s_last || threadIdx.x != 0) return;
  __threadfence();
  float total = 0.f;
  int tc[4] = {0, 0, 0, 0};
  for (unsigned j = 0; j < gridDim.x; ++j) {
    total += __ldcg(partial + j);
    for (int k = 0; k < 4; ++k) tc[k] += __ldcg(ipartial + 4 * j + k);
  }
  *patch_loss = __fdiv_rn(total, static_cast<float>(n));
  for (int k = 0; k < 4; ++k) counts[k] = tc[k];
  *ticket = 0u;
}

inline int blocks_for(size_t n) {
  const size_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

// K16: each block its chunk of the flat (B * V) batch; the last block adds
// the partial sums in block order and divides by N.
__global__ void fov_loss_kernel(const float* __restrict__ logits,
                                const float* __restrict__ labels,
                                const float* __restrict__ weights,
                                float* __restrict__ dlogits,
                                float* __restrict__ partial,
                                unsigned* __restrict__ ticket,
                                float* __restrict__ loss,
                                const float* __restrict__ scale, long long n,
                                int chunk) {
  __shared__ float s_warp[kThreads / 32];
  __shared__ bool s_last;
  const float nf = static_cast<float>(n);
  const float sc = scale != nullptr ? *scale : 1.f;
  const long long v0 = (long long)blockIdx.x * chunk;
  const long long v1 = min(v0 + (long long)chunk, n);
  float sum = 0.f;
  for (long long v = v0 + threadIdx.x; v < v1; v += blockDim.x) {
    const float lx = logits[v], lz = labels[v], w = weights[v];
    const float e = expf(-fabsf(lx));
    const float ce = __fadd_rn(__fsub_rn(fmaxf(lx, 0.f), __fmul_rn(lx, lz)),
                               log1pf(e));
    sum += __fmul_rn(ce, w);
    // A NaN fails both tests and stays NaN.
    const float sig =
        lx == 0.f ? 0.f : lx > 0.f ? 1.f / (1.f + e) : e / (1.f + e);
    dlogits[v] = __fmul_rn(__fmul_rn(__fdiv_rn(w, nf), __fsub_rn(sig, lz)), sc);
  }
  const float s = block_sum(sum, s_warp);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = s;
    s_last = last_block(ticket);
  }
  __syncthreads();
  if (!s_last || threadIdx.x != 0) return;
  __threadfence();
  float total = 0.f;
  for (unsigned c = 0; c < gridDim.x; ++c) total += __ldcg(partial + c);
  *loss = __fdiv_rn(total, nf);
  *ticket = 0u;
}

}  // namespace

// image_u8 (B, i^3) and lom_u8 (B, l^3) -> images, labels (float32, same
// sizes); seeds (B, sz, sy, sx) float32.
extern "C" int ffn_train_prep(const void* img_u8, const void* lom_u8,
                              float* images, float* labels, float* seeds,
                              long long n_img, long long n_lab, int B, int sz,
                              int sy, int sx, float mean, float stddev,
                              float lab_hi, float lab_lo, float pad_logit,
                              float init_logit, void* stream) {
  const size_t n = max(max((size_t)n_img, (size_t)n_lab), (size_t)B * sz * sy * sx);
  train_prep_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img_u8), static_cast<const uint8_t*>(lom_u8),
      images, labels, seeds, n_img, n_lab, B, Dims{sz, sy, sx}, mean, stddev,
      lab_hi, lab_lo, pad_logit, init_logit);
  return static_cast<int>(cudaGetLastError());
}

// dims: 3 ints each, in order: seed canvas, image canvas, label canvas, fov,
// seed crop start, image crop start, seed centre value, label centre value,
// seed canvas centre, label canvas centre, offset, max(deltas, 0).
extern "C" int ffn_train_gather(const float* seeds, const float* images,
                                const float* labels, float* x_in,
                                float* seed_patch, void* valid, void* wanted,
                                int B, const int* dims, int window, int radius,
                                float move_t, float label_t, void* stream) {
  GatherArgs a;
  Dims* d[] = {&a.s,  &a.im, &a.lab, &a.fov, &a.s0,  &a.i0,
               &a.sv, &a.lv, &a.sc,  &a.lc,  &a.off, &a.delta};
  for (int k = 0; k < 12; ++k) *d[k] = Dims{dims[3 * k], dims[3 * k + 1], dims[3 * k + 2]};
  a.window = window;
  a.radius = radius;
  a.move_t = move_t;
  a.label_t = label_t;
  const size_t n = (size_t)B * a.fov.z * a.fov.y * a.fov.x;
  const int crop_blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  train_gather_kernel<<<crop_blocks + B, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      seeds, images, labels, x_in, seed_patch, static_cast<uint8_t*>(valid),
      static_cast<uint8_t*>(wanted), B, crop_blocks, a);
  return static_cast<int>(cudaGetLastError());
}

// dims: fov, seed canvas, label canvas, write-back start, label crop start.
// partial: B * ceil(V / chunk) floats; ticket: one zeroed unsigned;
// metrics: 5 floats (loss, active, correct, missed, spurious).
extern "C" int ffn_train_loss(const float* logits, float* seeds,
                              const float* labels, const float* weights,
                              const void* valid, const void* wanted,
                              float* dlogits, float* partial, void* ticket,
                              float* metrics, const float* scale, int B,
                              const int* dims, int chunk, void* stream) {
  LossArgs a;
  Dims* d[] = {&a.fov, &a.s, &a.lab, &a.w0, &a.l0};
  for (int k = 0; k < 5; ++k) *d[k] = Dims{dims[3 * k], dims[3 * k + 1], dims[3 * k + 2]};
  a.chunk = chunk;
  const int V = a.fov.z * a.fov.y * a.fov.x;
  const dim3 grid((V + chunk - 1) / chunk, B);
  train_loss_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, seeds, labels, weights, static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(wanted), dlogits, partial,
      static_cast<unsigned*>(ticket), metrics, scale, B, a);
  return static_cast<int>(cudaGetLastError());
}

// dims: seed canvas, label canvas, eval size, seed crop start, label crop
// start. partial: ceil(B*E / chunk) floats, ipartial 4x that ints.
extern "C" int ffn_train_eval(const float* seeds, const float* labels,
                              float* partial, int* ipartial, void* ticket,
                              float* patch_loss, int* counts, int B,
                              const int* dims, int chunk, void* stream) {
  EvalArgs a;
  Dims* d[] = {&a.s, &a.lab, &a.ev, &a.s0, &a.l0};
  for (int k = 0; k < 5; ++k) *d[k] = Dims{dims[3 * k], dims[3 * k + 1], dims[3 * k + 2]};
  a.chunk = chunk;
  const size_t n = (size_t)B * a.ev.z * a.ev.y * a.ev.x;
  const int grid = static_cast<int>((n + chunk - 1) / chunk);
  train_eval_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seeds, labels, partial, ipartial, static_cast<unsigned*>(ticket),
      patch_loss, counts, B, a);
  return static_cast<int>(cudaGetLastError());
}

// n: the number of voxels (B * V); partial: ceil(n / chunk) floats; ticket:
// one zeroed unsigned; loss: one float.
extern "C" int ffn_fov_loss(const float* logits, const float* labels,
                            const float* weights, float* dlogits,
                            float* partial, void* ticket, float* loss,
                            const float* scale, long long n, int chunk,
                            void* stream) {
  const int grid = static_cast<int>((n + chunk - 1) / chunk);
  fov_loss_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, labels, weights, dlogits, partial,
      static_cast<unsigned*>(ticket), loss, scale, n, chunk);
  return static_cast<int>(cudaGetLastError());
}
