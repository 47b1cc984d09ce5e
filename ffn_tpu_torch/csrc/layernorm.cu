// K21 layernorm_channels: LayerNorm over the last (channel) axis of an
// NDHWC tensor, replacing flax's nn.LayerNorm(dtype=...) inside
// ResConvStack.__call__ (ffn_tpu/models/convstack_3d.py:103, flax 0.12's
// _compute_stats and _normalize). Storage float32, bfloat16 or float16;
// scale, bias and the statistics float32, eps 1e-6. flax's formula, in
// one fixed order: the channels summed one by one in channel order (x and
// x * x), mean = s / C and E[x^2] = q / C, the fast variance
// max(0, E[x^2] - mean^2), mul = rsqrt(var + eps) * scale,
// y = (x - mean) * mul + bias, rounded once to the storage type. Every
// product and sum rounds on its own (__fmul_rn, __fadd_rn: no FMA
// contraction) and the rsqrt is correctly rounded (__frsqrt_rn), as the
// plain version's float32 torch ops and float64 rsqrt.
//
// Bound on the H100: bytes (each voxel's C channels read once and written
// once, ~9 operations a channel). A block stages kVoxels voxels' channels
// in shared memory with coalesced loads, one thread then owns a voxel's
// channels (rows of C + 1 floats: an odd stride, so a warp's 32 rows fall
// in 32 banks), and the block stores the rows back coalesced.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVoxels = 128;   // voxels per block and iteration, a thread each
constexpr int kMaxC = 64;      // 128 rows of 65 floats: 33 KB of shared memory
constexpr float kEps = 1e-6f;  // flax's nn.LayerNorm default

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ inline T from_f32(float v);
template <>
__device__ inline float from_f32<float>(float v) { return v; }
template <>
__device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ inline __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kVoxels)
    layernorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ y,
                     long long voxels, int C) {
  extern __shared__ float smem[];
  float* sc = smem;
  float* bi = smem + C;
  float* tile = smem + 2 * C;
  const int stride = C + 1;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    sc[c] = scale[c];
    bi[c] = bias[c];
  }
  const float cf = static_cast<float>(C);
  for (long long v0 = (long long)blockIdx.x * kVoxels; v0 < voxels;
       v0 += (long long)gridDim.x * kVoxels) {
    const long long left = voxels - v0;
    const int nv = left < kVoxels ? static_cast<int>(left) : kVoxels;
    const int n = nv * C;
    const T* src = x + v0 * C;
    T* dst = y + v0 * C;
    __syncthreads();   // the scale and bias, or the last iteration's stores
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      tile[(e / C) * stride + e % C] = to_f32(src[e]);
    __syncthreads();
    if (threadIdx.x < nv) {
      float* row = tile + threadIdx.x * stride;
      float s = row[0];
      float q = __fmul_rn(row[0], row[0]);
      for (int c = 1; c < C; ++c) {
        s = __fadd_rn(s, row[c]);
        q = __fadd_rn(q, __fmul_rn(row[c], row[c]));
      }
      const float mean = __fdiv_rn(s, cf);
      const float d = __fsub_rn(__fdiv_rn(q, cf), __fmul_rn(mean, mean));
      const float var = d < 0.f ? 0.f : d;   // NaN stays NaN, as jnp.maximum
      const float r = __frsqrt_rn(__fadd_rn(var, kEps));
      for (int c = 0; c < C; ++c)
        row[c] = __fadd_rn(__fmul_rn(__fsub_rn(row[c], mean),
                                     __fmul_rn(r, sc[c])),
                           bi[c]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      dst[e] = from_f32<T>(tile[(e / C) * stride + e % C]);
  }
}

template <typename T>
int launch(const void* x, const float* scale, const float* bias, void* y,
           long long voxels, int C, cudaStream_t s) {
  const long long tiles = (voxels + kVoxels - 1) / kVoxels;
  const unsigned blocks =
      static_cast<unsigned>(tiles < (1 << 20) ? (tiles > 0 ? tiles : 1)
                                              : (1 << 20));
  const size_t bytes = sizeof(float) * (2 * C + kVoxels * (C + 1));
  layernorm_kernel<T><<<blocks, kVoxels, bytes, s>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), voxels, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y (voxels, C) contiguous in the storage type `dtype` (0 float32,
// 1 bfloat16, 2 float16); scale, bias (C) float32; 1 <= C <= kMaxC.
extern "C" int ffn_layernorm_channels(const void* x, int dtype,
                                      const float* scale, const float* bias,
                                      void* y, long long voxels, int C,
                                      void* stream) {
  if (C < 1 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, scale, bias, y, voxels, C, s);
    case 1:
      return launch<__nv_bfloat16>(x, scale, bias, y, voxels, C, s);
    case 2: return launch<__half>(x, scale, bias, y, voxels, C, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
