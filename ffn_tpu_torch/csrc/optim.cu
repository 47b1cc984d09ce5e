// K12 optim_update: the clipped optimizer update of every parameter tensor,
// with the loss scale, the finite gate and the EMA, in one launch, replacing
// the optax chain (ffn_tpu/training/optimizer.py:45-69, optax 0.2.6's
// arithmetic), DynamicLossScale (training/precision.py:74-114), all_finite /
// select_tree (:155-167) and the scan body's update (train_lib.py:368-388).
// In the JAX order: (0) with a loss scale, every gradient entry unscaled,
// g * (1 / scale), exact for a power of two; (1) finite = every entry
// finite (per-block flags, a grid barrier); (2) do_update = (active > 0) &
// finite (`active` from K11), or always with the gate off (the legacy
// host-loop step, train_lib.py:445-458: a NaN reaches the parameters, as in
// JAX); per entry g = clip(g, +-c) (NaN stays NaN), the optimizer's step,
// p += u; without do_update nothing changes; the EMA e = d e + (1 - d) p
// whenever ema_decay > 0; (3) the scale's adjust(finite) in place. Counts
// and the scale are read before the barrier and written after it by one
// thread.
//
// Bound on the H100: bytes (params, grads, EMA and up to two state tensors
// of ~638k floats). One cooperative launch, a block per SM, over a table of
// tensor pointers by value; each product and sum rounds on its own
// (__fmul_rn, __fadd_rn), as the plain version's torch ops.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 64;  // 5 pointer tables of 64: 3 KB of the 4 KB of kernel arguments
constexpr int kBarCount = 0, kBarGen = 1, kFlags = 2;  // ctrl layout

enum Opt { kSgd = 0, kMomentum = 1, kAdagrad = 2, kAdam = 3, kRmsprop = 4 };

struct Table {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* s1[kMaxTensors];
  float* s2[kMaxTensors];
  float* e[kMaxTensors];
  long long n[kMaxTensors];
  int count;
};

struct Hyper {
  int opt, use_sched, decay_steps, use_ema, gate;
  float clip, lr, decay_rate;
  float b1, omb1, b2, omb2, eps, momentum, rho, omrho, ema_d, ema_omd;
};

struct State {
  int* adam_count;         // adam's count or null
  int* sched_count;        // the schedule's count or null
  const float* active;     // sum of valid lanes at this offset
  uint8_t* finite_out;     // the offset's grads_finite metric
  int* ctrl;               // barrier counters and per-block flags
  float* scale;            // the DynamicLossScale's scale or null
  int* scale_counter;      // its counter (with scale)
  int growth_interval;
};

__device__ void grid_sync(int* ctrl) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* count = reinterpret_cast<unsigned*>(ctrl + kBarCount);
    volatile unsigned* gen = reinterpret_cast<unsigned*>(ctrl + kBarGen);
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(count, 1u) == gridDim.x - 1) {
      atomicExch(count, 0u);
      __threadfence();
      atomicAdd(reinterpret_cast<unsigned*>(ctrl + kBarGen), 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ inline int safe_increment(int c) {
  return c < 2147483647 ? c + 1 : c;
}

__global__ void __launch_bounds__(kThreads)
optim_update_kernel(Table t, Hyper h, State st) {
  __shared__ int s_ok;
  const size_t tid = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;

  // Phase 1: the finite flag of this block's share; the counts.
  const float scale = st.scale ? *st.scale : 1.f;
  const int scale_counter = st.scale ? *st.scale_counter : 0;
  const float inv_scale = __fdiv_rn(1.f, scale);
  int ok = 1;
  for (int j = 0; j < t.count; ++j)
    for (size_t i = tid; i < (size_t)t.n[j]; i += stride) {
      const float g = st.scale ? __fmul_rn(t.g[j][i], inv_scale) : t.g[j][i];
      ok &= isfinite(g) ? 1 : 0;
    }
  ok = __syncthreads_and(ok);
  if (threadIdx.x == 0) st.ctrl[kFlags + blockIdx.x] = ok;
  const int adam_count = st.adam_count ? *st.adam_count : 0;
  const int sched_count = st.sched_count ? *st.sched_count : 0;
  grid_sync(st.ctrl);

  if (threadIdx.x == 0) {
    int all = 1;
    for (unsigned b = 0; b < gridDim.x; ++b)
      all &= __ldcg(st.ctrl + kFlags + b);
    s_ok = all;
  }
  __syncthreads();
  const bool finite = s_ok != 0;
  const bool do_update = !h.gate || (finite && *st.active > 0.f);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *st.finite_out = finite;
    if (do_update) {
      if (st.adam_count) *st.adam_count = safe_increment(adam_count);
      if (st.sched_count) *st.sched_count = safe_increment(sched_count);
    }
    if (st.scale) {
      const bool grow = scale_counter + 1 >= st.growth_interval;
      *st.scale = finite ? (grow ? __fmul_rn(scale, 2.f) : scale)
                         : fmaxf(__fmul_rn(scale, 0.5f), 1.f);
      *st.scale_counter = finite && !grow ? scale_counter + 1 : 0;
    }
  }

  // The learning rate: optax.exponential_decay(staircase) at the count.
  float lr = h.lr;
  if (h.use_sched && sched_count > 0)
    lr = __fmul_rn(h.lr, powf(h.decay_rate,
                              floorf(__fdiv_rn(static_cast<float>(sched_count),
                                               static_cast<float>(h.decay_steps)))));
  const float step = -lr;
  float bc1 = 1.f, bc2 = 1.f;
  if (h.opt == kAdam) {
    const float c1 = static_cast<float>(safe_increment(adam_count));
    bc1 = __fsub_rn(1.f, powf(h.b1, c1));
    bc2 = __fsub_rn(1.f, powf(h.b2, c1));
  }

  for (int j = 0; j < t.count; ++j) {
    float* p = t.p[j];
    const float* gp = t.g[j];
    float* s1 = t.s1[j];
    float* s2 = t.s2[j];
    for (size_t i = tid; i < (size_t)t.n[j]; i += stride) {
      float pv = p[i];
      if (do_update) {
        float g = st.scale ? __fmul_rn(gp[i], inv_scale) : gp[i];
        if (h.clip > 0.f && !isnan(g)) g = fminf(fmaxf(g, -h.clip), h.clip);
        float u;
        switch (h.opt) {
          case kMomentum: {
            const float tr = __fadd_rn(g, __fmul_rn(h.momentum, s1[i]));
            s1[i] = tr;
            u = __fmul_rn(step, tr);
            break;
          }
          case kAdagrad: {
            const float ss = __fadd_rn(__fmul_rn(g, g), s1[i]);
            s1[i] = ss;
            const float inv = ss > 0.f ? __fdiv_rn(1.f, sqrtf(__fadd_rn(ss, h.eps))) : 0.f;
            u = __fmul_rn(step, __fmul_rn(inv, g));
            break;
          }
          case kAdam: {
            const float mu = __fadd_rn(__fmul_rn(h.omb1, g), __fmul_rn(h.b1, s1[i]));
            const float nu = __fadd_rn(__fmul_rn(h.omb2, __fmul_rn(g, g)),
                                       __fmul_rn(h.b2, s2[i]));
            s1[i] = mu;
            s2[i] = nu;
            const float m_hat = __fdiv_rn(mu, bc1);
            const float n_hat = __fdiv_rn(nu, bc2);
            u = __fmul_rn(step, __fdiv_rn(m_hat, __fadd_rn(sqrtf(n_hat), h.eps)));
            break;
          }
          case kRmsprop: {
            const float nu = __fadd_rn(__fmul_rn(h.omrho, __fmul_rn(g, g)),
                                       __fmul_rn(h.rho, s1[i]));
            s1[i] = nu;
            const float scaled = __fmul_rn(
                step, __fmul_rn(__fdiv_rn(1.f, sqrtf(__fadd_rn(nu, h.eps))), g));
            const float tr = __fadd_rn(scaled, __fmul_rn(h.momentum, s2[i]));
            s2[i] = tr;
            u = tr;
            break;
          }
          default:
            u = __fmul_rn(step, g);
        }
        pv = __fadd_rn(pv, u);
        p[i] = pv;
      }
      if (h.use_ema)
        t.e[j][i] = __fadd_rn(__fmul_rn(h.ema_d, t.e[j][i]), __fmul_rn(h.ema_omd, pv));
    }
  }
}

}  // namespace

// p, g, s1, s2, e: host arrays of `count` device pointers (s1, s2, e may hold
// nulls where the optimizer or the EMA has no such tensor); n: the tensors'
// sizes. hyper_i = {opt, use_sched, decay_steps, use_ema, gate}; hyper_f =
// {clip, lr, decay_rate, b1, 1-b1, b2, 1-b2, eps, momentum, rho, 1-rho,
// ema_d, 1-ema_d}. ctrl: 2 + (number of SMs) zeroed ints, kept across calls.
// scale (float32) and scale_counter (int32): a DynamicLossScale, or null.
extern "C" int ffn_optim_update(void* const* p, void* const* g,
                                void* const* s1, void* const* s2,
                                void* const* e, const long long* n, int count,
                                const int* hyper_i, const float* hyper_f,
                                void* adam_count, void* sched_count,
                                const float* active, void* finite_out,
                                void* ctrl, int ctrl_len, void* scale,
                                void* scale_counter, int growth_interval,
                                void* stream) {
  if (count > kMaxTensors) return static_cast<int>(cudaErrorInvalidValue);
  Table t;
  for (int j = 0; j < count; ++j) {
    t.p[j] = static_cast<float*>(p[j]);
    t.g[j] = static_cast<const float*>(g[j]);
    t.s1[j] = static_cast<float*>(s1[j]);
    t.s2[j] = static_cast<float*>(s2[j]);
    t.e[j] = static_cast<float*>(e[j]);
    t.n[j] = n[j];
  }
  t.count = count;
  const Hyper h{hyper_i[0], hyper_i[1], hyper_i[2], hyper_i[3], hyper_i[4],
                hyper_f[0], hyper_f[1], hyper_f[2], hyper_f[3], hyper_f[4],
                hyper_f[5], hyper_f[6], hyper_f[7], hyper_f[8], hyper_f[9],
                hyper_f[10], hyper_f[11], hyper_f[12]};
  State st{static_cast<int*>(adam_count), static_cast<int*>(sched_count),
           active, static_cast<uint8_t*>(finite_out), static_cast<int*>(ctrl),
           static_cast<float*>(scale), static_cast<int*>(scale_counter),
           growth_interval};
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, optim_update_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (ctrl_len < kFlags + sms) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(sms), block(kThreads);
  void* args[] = {&t, const_cast<Hyper*>(&h), &st};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(optim_update_kernel),
                                    grid, block, args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
