// K15: conv3d_ndhwc_bf16 and conv3d_ndhwc_f16 -- SAME-padded 3D convolution,
// channels-last, 16-bit inputs and weights (one body templated on the type
// r, bfloat16 or float16) on the tensor cores, float32 sums rounded as the
// exact sum would round. Replaces the nn.Conv layers of ffn_tpu/models/
// convstack_3d.py (:48-75) with dtype=bfloat16 (the benches' default) or
// float16 (--precision f16), copying flax: acc = sum r(x) r(w) in float32,
// y = r(r(acc) + bias), then relu (post_relu) and a residual: 16-bit,
// y = r(y + res); float32 (conv_lom's seed), out = float32(y) + res. r
// rounds to nearest even (float16 overflows to inf, as XLA's convert);
// float32 inputs (conv0_a) round as staged, pre_relu applies as staged.
//
// Which float32 sum: flax leaves the order to XLA, and two orders round
// ~2e-5 of a layer's sums to neighbouring bfloat16 values, which through 12
// layers decide moves (K15's own orders split a round-slice cell). So K15 gives
// r(f32(S)) for the exact S: a second MMA on the fragments with signs
// cleared sums |x||w| (mag), and |acc - S| <= 2^-ERR_BITS mag with
// ERR_BITS = 20, measured, not proven (largest of 5.0e8 bfloat16 outputs
// 2^-20.7, tools_torch/k15_variants.py; the products are exact
// in both types, and float16 layers equal the float64 sums bit for bit on
// the card, chip_smoke.py phase 3). Where r(acc - e) and r(acc + e) agree
// (e the bound plus two float32 ulps) r(acc) is exact; elsewhere (0.3-1% of
// model-r2's bfloat16 outputs, ~8x more in float16's finer ulp) the warp
// sums that output in float64 from shared memory (lanes split K, a fixed
// butterfly) and rounds it: exact when the products' magnitudes span at
// most 2^28 (bfloat16) or 2^22 (float16, 22-bit products), else off by
// less than 2^-43 mag.
//
// Bound on the H100: a 3^3 32->32 layer is 1.99 GFLOP a 33^3 sample and
// 4.6-6.9 MB: 2.0 us at 989 TFLOP/s against 1.4-2.1 us at 3.35 TB/s.
// Design: implicit GEMM on mma.sync m16n8k16 (M voxels, N output channels,
// K = 27 Cin in (tap, channel) order; conv16.cuh's tile: 4 warps, 4x4x8
// voxels, the halo tile and all weights staged once, rows padded against
// bank conflicts, ldmatrix.trans for B); Cin = 2 packs taps along K; 1^3
// layers (conv_lom) are a float64 dot product per output on the CUDA cores.
// A CTA never mixes samples and an output depends on its inputs only, so a
// sample's result does not depend on N, and repeats bit for bit. Left for
// later: wgmma, TMA, pipelining, weights shared across tiles.
//
// Measurement variants (never defined by the library;
// tools_torch/k15_variants.py): FFN_K15_RAW_SUM outputs the unrounded
// float32 sum in K15's order, FFN_K15_IN_MMA accumulates it in the tensor
// core, FFN_K15_ERR_BITS sets the bound.

#include "conv16.cuh"

#ifndef FFN_K15_ERR_BITS
#define FFN_K15_ERR_BITS 20
#endif
#if defined(FFN_K15_RAW_SUM) && !defined(FFN_K15_UNCORRECTED)
#define FFN_K15_UNCORRECTED
#endif

namespace {

// The conv's float32 sum to its 16-bit output before the residual:
// r(r(acc) + bias), then relu (post_relu).
template <typename T>
__device__ __forceinline__ float finish(float acc, T b, int post_relu) {
#if defined(FFN_K15_RAW_SUM)
  return acc;
#else
  float v = round16<T>(round16<T>(acc) + to_f<T>(b));
  if (post_relu && v < 0.f) v = 0.f;
  return v;
#endif
}

template <typename T>
__device__ __forceinline__ float load_x(const void* x, int x_f32, size_t i) {
  return x_f32 ? round16<T>(static_cast<const float*>(x)[i])
               : to_f<T>(static_cast<const T*>(x)[i]);
}

// Stores y (a value of T as a float) and the residual's sum at index i.
template <typename T>
__device__ __forceinline__ void store_y(void* y, const void* res, int out_f32,
                                        size_t i, float v) {
  if (out_f32) {
    if (res != nullptr) v += static_cast<const float*>(res)[i];
    static_cast<float*>(y)[i] = v;
    return;
  }
  if (res != nullptr) v += to_f<T>(static_cast<const T*>(res)[i]);
  static_cast<T*>(y)[i] = from_f<T>(v);
}

// Loads CH consecutive input channels (16 or 8 bytes) as floats.
template <typename T, int CH>
__device__ __forceinline__ void load_chunk(const void* x, int x_f32,
                                           size_t off, float (&f)[CH]) {
  if (x_f32) {
    const float* p = static_cast<const float*>(x) + off;
    if constexpr (CH == 8) {
      const float4 a = *reinterpret_cast<const float4*>(p);
      const float4 b = *reinterpret_cast<const float4*>(p + 4);
      f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
      f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
    } else {
      const float2 a = *reinterpret_cast<const float2*>(p);
      f[0] = a.x; f[1] = a.y;
    }
  } else {
    const T* p = static_cast<const T*>(x) + off;
    if constexpr (CH == 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      unpack16<T>(u.x, f[0], f[1]);
      unpack16<T>(u.y, f[2], f[3]);
      unpack16<T>(u.z, f[4], f[5]);
      unpack16<T>(u.w, f[6], f[7]);
    } else {
      unpack16<T>(*reinterpret_cast<const uint32_t*>(p), f[0], f[1]);
    }
  }
}

#ifndef FFN_K15_UNCORRECTED
// The exact sum of output channel `co` at staged voxel `vox` (tap 0), in
// float64 from the staged tile and weights: the warp's lanes split K (at
// Cin = 32 lane = channel, over the 27 taps) and a butterfly adds their
// parts in one fixed order; every lane returns it.
template <typename T, int CIN, int COUT>
__device__ __forceinline__ double exact_sum(const T* s_x, const T* s_w,
                                            int vox, int co, int lane) {
  using G = Geo<CIN, COUT>;
  double sum = 0.0;
  if constexpr (CIN == 32) {
#pragma unroll
    for (int tap = 0; tap < 27; ++tap)
      sum = fma((double)to_f<T>(s_x[(vox + tap_offset(tap)) * G::CS + lane]),
                (double)to_f<T>(s_w[(tap * 32 + lane) * G::WS + co]), sum);
  } else {
    for (int k = lane; k < G::K; k += 32) {
      const int tap = k / CIN, ci = k % CIN;
      sum = fma((double)to_f<T>(s_x[(vox + tap_offset(tap)) * G::CS + ci]),
                (double)to_f<T>(s_w[k * G::WS + co]), sum);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  return sum;
}
#endif

template <typename T, int CIN, int COUT>
__global__ void __launch_bounds__(kTcThreads)
conv3d_16_tc_kernel(const void* __restrict__ x, int x_f32,
                    const T* __restrict__ wt, const T* __restrict__ bias,
                    const void* __restrict__ res, void* __restrict__ y,
                    int D, int H, int W, int pre_relu, int post_relu,
                    int out_f32, int tiles_x) {
  using G = Geo<CIN, COUT>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_w = reinterpret_cast<T*>(smem);  // [KPAD][WS]
  T* s_x = s_w + G::KPAD * G::WS;       // [SVOX][CS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = (blockIdx.x % tiles_x) * TX;
  const int y0 = (blockIdx.x / tiles_x) * TY;
  const int z0 = blockIdx.y * TZ;
  const size_t vox0 = (size_t)blockIdx.z * D * H * W;  // the CTA's sample

  // Weights: row k = tap * Cin + ci of the DHWIO tensor, rows past K zero.
  constexpr int WCH = COUT / 8;
  for (int i = tid; i < G::KPAD * WCH; i += kTcThreads) {
    const int r = i / WCH, c = (i % WCH) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < G::K) v = *reinterpret_cast<const uint4*>(wt + (size_t)r * COUT + c);
    *reinterpret_cast<uint4*>(s_w + r * G::WS + c) = v;
  }
  // Input tile with its halo; SAME padding reads as zero.
  constexpr int CH = CIN < 8 ? CIN : 8;
  constexpr int XCH = CIN / CH;
  for (int i = tid; i < SVOX * XCH; i += kTcThreads) {
    const int v = i / XCH, c = (i % XCH) * CH;
    const int sx = v % SX, sy = (v / SX) % SY, sz = v / (SX * SY);
    const int gz = z0 + sz - 1, gy = y0 + sy - 1, gx = x0 + sx - 1;
    float f[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) f[j] = 0.f;
    if (gz >= 0 && gz < D && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      load_chunk<T, CH>(x, x_f32,
                        (vox0 + ((size_t)gz * H + gy) * W + gx) * CIN + c, f);
      if (pre_relu) {
#pragma unroll
        for (int j = 0; j < CH; ++j) f[j] = f[j] < 0.f ? 0.f : f[j];
      }
    }
    T* dst = s_x + v * G::CS + c;
    if constexpr (CH == 8) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(pack16<T>(f[0], f[1]), pack16<T>(f[2], f[3]),
                     pack16<T>(f[4], f[5]), pack16<T>(f[6], f[7]));
    } else {
      *reinterpret_cast<uint32_t*>(dst) = pack16<T>(f[0], f[1]);
    }
  }
  __syncthreads();

  float acc[2][G::NT][4], mag[2][G::NT][4];  // mag: sum of |x| * |w|
#ifdef FFN_K15_UNCORRECTED
  tc_sums<T, CIN, COUT, false>(s_x, s_w, warp, lane, acc, mag);
#else
  tc_sums<T, CIN, COUT, true>(s_x, s_w, warp, lane, acc, mag);
#endif
  const int g = lane >> 2, t = lane & 3;

  // Where acc's error bound straddles a point at which r(f32(.)) changes,
  // the warp sums that output exactly (exact_sum) and its owner stores it;
  // bit (mt * NT + nt) * 4 + q of `exact` marks those outputs.
  uint32_t exact = 0;
#ifndef FFN_K15_UNCORRECTED
  constexpr float kErr = 1.0f / (float)(1u << FFN_K15_ERR_BITS);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = acc[mt][nt][q];
        const float e = fmaf(mag[mt][nt][q], kErr, fabsf(v) * 0x1p-22f);
        if (bits16<T>(v - e) != bits16<T>(v + e))
          exact |= 1u << ((mt * G::NT + nt) * 4 + q);
      }
  for (uint32_t todo = exact;;) {
    const unsigned lanes = __ballot_sync(0xffffffffu, todo != 0);
    if (lanes == 0) break;
    const int owner = __ffs(lanes) - 1;
    const int i = __ffs(__shfl_sync(0xffffffffu, todo, owner)) - 1;
    if (lane == owner) todo &= todo - 1;
    const int mt = i / (4 * G::NT), nt = (i / 4) % G::NT, q = i % 4;
    const int row = 2 * mt + (q >> 1), co = nt * 8 + 2 * (owner & 3) + (q & 1);
    const double sum = exact_sum<T, CIN, COUT>(
        s_x, s_w, (warp * SY + row) * SX + (owner >> 2), co, lane);
    const int gz = z0 + warp, gy = y0 + row, gx = x0 + (owner >> 2);
    if (lane == owner && gz < D && gy < H && gx < W)
      store_y<T>(y, res, out_f32,
                 (vox0 + ((size_t)gz * H + gy) * W + gx) * COUT + co,
                 finish<T>((float)sum, bias[co], post_relu));
  }
#endif

  const int gz = z0 + warp, gx = x0 + g;
  if (gz >= D || gx >= W) return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gy = y0 + 2 * mt + h;
      if (gy >= H) continue;
      const size_t o = (vox0 + ((size_t)gz * H + gy) * W + gx) * COUT;
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (exact >> ((mt * G::NT + nt) * 4 + 2 * h + j) & 1) continue;
          const int co = nt * 8 + 2 * t + j;
          store_y<T>(y, res, out_f32, o + co,
                     finish<T>(acc[mt][nt][2 * h + j], bias[co], post_relu));
        }
    }
}

// 1^3 layers: one thread per output, its input channels summed in order.
template <typename T>
__global__ void conv1_16_kernel(const void* __restrict__ x, int x_f32,
                                const T* __restrict__ wt,
                                const T* __restrict__ bias,
                                const void* __restrict__ res,
                                void* __restrict__ y, long long outputs,
                                int Cin, int Cout, int pre_relu,
                                int post_relu, int out_f32) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= outputs) return;
  const long long v = i / Cout;
  const int co = (int)(i % Cout);
#ifdef FFN_K15_UNCORRECTED
  float acc = 0.f;
#else
  double acc = 0.0;  // exact: products of 8- or 11-bit significands
#endif
  for (int ci = 0; ci < Cin; ++ci) {
    float xv = load_x<T>(x, x_f32, (size_t)v * Cin + ci);
    if (pre_relu && xv < 0.f) xv = 0.f;
#ifdef FFN_K15_UNCORRECTED
    acc = fmaf(xv, to_f<T>(wt[ci * Cout + co]), acc);
#else
    acc = fma((double)xv, (double)to_f<T>(wt[ci * Cout + co]), acc);
#endif
  }
  store_y<T>(y, res, out_f32, (size_t)i,
             finish<T>((float)acc, bias[co], post_relu));
}

template <typename T, int CIN, int COUT>
cudaError_t launch_tc(const void* x, int x_f32, const T* w, const T* bias,
                      const void* res, void* y, int N, int D, int H, int W,
                      int pre_relu, int post_relu, int out_f32,
                      cudaStream_t s) {
  constexpr size_t smem = Geo<CIN, COUT>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      conv3d_16_tc_kernel<T, CIN, COUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + TX - 1) / TX, tiles_y = (H + TY - 1) / TY;
  const dim3 grid(tiles_x * tiles_y, (D + TZ - 1) / TZ, N);
  conv3d_16_tc_kernel<T, CIN, COUT><<<grid, kTcThreads, smem, s>>>(
      x, x_f32, w, bias, res, y, D, H, W, pre_relu, post_relu, out_f32,
      tiles_x);
  return cudaGetLastError();
}

template <typename T>
int conv3d_16(const void* x, int x_f32, const void* w, const void* bias,
              const void* res, void* y, int N, int D, int H, int W, int Cin,
              int Cout, int k, int pre_relu, int post_relu, int out_f32,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* wb = static_cast<const T*>(w);
  const auto* bb = static_cast<const T*>(bias);
  if (k == 1) {
    const long long outputs = (long long)N * D * H * W * Cout;
    const int threads = 256;
    conv1_16_kernel<T><<<(unsigned)((outputs + threads - 1) / threads),
                         threads, 0, s>>>(x, x_f32, wb, bb, res, y, outputs,
                                          Cin, Cout, pre_relu, post_relu,
                                          out_f32);
    return static_cast<int>(cudaGetLastError());
  }
  if (k != 3) return static_cast<int>(cudaErrorInvalidValue);
#define FFN_K15_CASE(CI, CO)                                            \
  if (Cin == CI && Cout == CO)                                          \
    return static_cast<int>(launch_tc<T, CI, CO>(                       \
        x, x_f32, wb, bb, res, y, N, D, H, W, pre_relu, post_relu,      \
        out_f32, s));
  FFN_K15_CASE(2, 32)
  FFN_K15_CASE(32, 32)
  FFN_K15_CASE(2, 16)
  FFN_K15_CASE(16, 16)
#undef FFN_K15_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (N,D,H,W,Cin) of the layer's type, or float32 when x_f32; w
// (k,k,k,Cin,Cout) and bias (Cout) of its type; res (N,D,H,W,Cout) or null,
// float32 when out_f32 else of its type; y (N,D,H,W,Cout), float32 when
// out_f32 else of its type. All contiguous; k = 3 takes (Cin, Cout) in
// {(2,32), (32,32), (2,16), (16,16)} with x and w 16-byte aligned, k = 1
// any widths. The _bf16 entry runs bfloat16 layers, the _f16 one float16.
#define FFN_K15_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* x, int x_f32, const void* w,               \
                      const void* bias, const void* res, void* y, int N,     \
                      int D, int H, int W, int Cin, int Cout, int k,         \
                      int pre_relu, int post_relu, int out_f32,              \
                      void* stream) {                                        \
    return conv3d_16<T>(x, x_f32, w, bias, res, y, N, D, H, W, Cin, Cout, k, \
                        pre_relu, post_relu, out_f32, stream);               \
  }
FFN_K15_ENTRY(ffn_conv3d_ndhwc_bf16, __nv_bfloat16)
FFN_K15_ENTRY(ffn_conv3d_ndhwc_f16, __half)
#undef FFN_K15_ENTRY
