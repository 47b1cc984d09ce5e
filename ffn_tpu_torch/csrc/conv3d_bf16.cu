// K15: conv3d_ndhwc_bf16 -- SAME-padded 3D convolution, channels-last,
// bfloat16 inputs and weights on the tensor cores, float32 sums rounded as
// the exact sum would round.
//
// Replaces: the nn.Conv layers of ffn_tpu/models/convstack_3d.py
// (ConvStack3D.__call__, :49-75) with dtype=bfloat16, the precision that
// bench.py and tools/e2e_fused_bench.py run by default. flax's arithmetic,
// copied exactly:
//   acc = sum over taps and input channels of bf16(x) * bf16(w), in float32
//   y   = bf16(bf16(acc) + bias)        the conv rounds, then its bias add
//   post_relu: y = relu(y); a bfloat16 residual: y = bf16(y + residual);
//   a float32 residual (conv_lom's seed, `seed + update` at
//   convstack_3d.py:161): out = float32(y) + residual, a float32 output.
// Input channels are bfloat16, or float32 (conv0_a: the image and the seed)
// rounded to nearest even as they are staged (`x.astype(bfloat16)`,
// convstack_3d.py:60); pre_relu applies as they are staged.
//
// Which float32 sum: flax leaves the order to XLA, and the bfloat16
// rounding after it makes the order show: any two float32 orders round
// ~2e-5 of a layer's sums to neighbouring bfloat16 values, and through the
// depth-12 stack those steps decide moves (PERF.md: two orders of K15's
// own split a cell of the seed-0 phantom's round slice that cuDNN's and
// the exact sum do not). So K15 rounds as the exact sum would: its result
// is bf16(f32(S)) for the exact S, the best any float32 order can give,
// and the same in every order. It gets there cheaply:
//   - the tensor cores sum bf16(x) * bf16(w) in float32 (acc), and a second
//     MMA on the same fragments with their signs cleared sums |x| * |w|
//     (mag), which scales the sum's error: |acc - S| <= 2^-ERR_BITS * mag
//     with ERR_BITS = 20, a bound measured, not proven: on the H100 the
//     largest of 5.0e8 outputs (random layers, model-r2's on phantom
//     patches) was 2^-20.7 (tools_torch/k15_variants.py --calibrate);
//   - where bf16 of acc - e and of acc + e agree (e that bound plus two
//     float32 ulps), bf16(acc) is bf16(f32(S)), the rounding being
//     monotone; elsewhere (0.3-1% of model-r2's outputs, 2.4% of a random
//     layer's) the warp recomputes that one sum in float64 from shared
//     memory, its lanes splitting K and adding their parts in a fixed
//     butterfly, and rounds it to float32: exact, for products of 8-bit
//     significands. An output beyond the bound would keep K15's float32
//     order, as good as any other order but not exact.
//
// Bound on the H100: a 3^3 32->32 layer does 1.99 GFLOP per 33^3 sample
// and moves 4.6 MB (6.9 with a residual): 2.0 us at 989 TFLOP/s of bf16
// tensor-core work against 1.4-2.1 us at 3.35 TB/s, so the tensor cores
// bound it, just. The first design is simple and right:
//   - implicit GEMM on mma.sync m16n8k16 (bf16 x bf16 -> f32): M = output
//     voxels, N = the output channels, K = 27 * Cin in (tap, channel)
//     order; each k16 step's products are summed by the tensor core from
//     zero and added to the running sum by a float32 add;
//   - a CTA of 4 warps owns a 4(z) x 4(y) x 8(x) voxel tile (405 CTAs per
//     33^3 sample); warp w owns z = w, as two m16 tiles (two y rows of 8 x)
//     by all output channels;
//   - the tile's input with its halo (6 x 6 x 10 voxels) and the layer's
//     whole (27 * Cin) x Cout weight matrix are staged once into shared
//     memory, each row padded by 8 bf16 so that the fragment loads hit 32
//     distinct banks; A fragments are 32-bit loads, B fragments
//     ldmatrix.trans;
//   - Cin = 2 (conv0_a) packs the taps along K (54 -> 64, 4 k-steps)
//     instead of padding each tap to 16 channels;
//   - 1^3 layers (conv_lom: 32 -> 1) are a dot product per output on the
//     CUDA cores, summed in float64 (exact) and rounded to float32.
// Two properties the callers rely on: a CTA never mixes samples, and an
// output depends on its own inputs only, so a sample's result does not
// depend on N or on the batch's other samples (the hop engine's conv
// compaction, hop_engine.py:183-190), and it repeats bit for bit from run to
// run. Left for later (ROADMAP): wgmma, TMA, a pipelined K loop, weights
// shared across tiles.
//
// Measurement variants, which the library never defines and
// tools_torch/k15_variants.py builds from this file: FFN_K15_UNCORRECTED
// keeps the float32 sum in K15's order (no bound, no recompute),
// FFN_K15_RAW_SUM also outputs that sum unrounded (called with a float32
// residual of zeros), FFN_K15_IN_MMA accumulates inside the tensor core,
// FFN_K15_REVERSE_K sums K from its far end, FFN_K15_ROUND_ONCE rounds
// bf16(acc + bias) once where flax rounds twice, FFN_K15_ERR_BITS sets the
// bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef FFN_K15_ERR_BITS
#define FFN_K15_ERR_BITS 20
#endif
#if defined(FFN_K15_RAW_SUM) && !defined(FFN_K15_UNCORRECTED)
#define FFN_K15_UNCORRECTED
#endif

namespace {

constexpr int kThreads = 128;                 // 4 warps
constexpr int TZ = 4, TY = 4, TX = 8;         // output tile of one CTA
constexpr int SZ = TZ + 2, SY = TY + 2, SX = TX + 2;  // with the 3^3 halo
constexpr int SVOX = SZ * SY * SX;

template <int CIN, int COUT>
struct Geo {
  static constexpr int K = 27 * CIN;          // GEMM depth
  static constexpr int KPAD = (K + 15) / 16 * 16;
  // Shared-memory row strides in bf16: +8 puts the 8 rows a fragment load
  // touches on distinct banks (Cin = 2 packs taps, and needs none).
  static constexpr int CS = CIN % 16 == 0 ? CIN + 8 : CIN;
  static constexpr int WS = COUT + 8;
  static constexpr int NT = COUT / 8;         // n8 tiles
  static constexpr size_t SMEM =
      (size_t)KPAD * WS * 2 + (size_t)SVOX * CS * 2;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The conv's float32 sum to its bfloat16 output before the residual:
// bf16(bf16(acc) + bias), then relu (post_relu).
__device__ __forceinline__ float finish(float acc, __nv_bfloat16 b,
                                        int post_relu) {
#if defined(FFN_K15_RAW_SUM)
  return acc;
#else
#if defined(FFN_K15_ROUND_ONCE)
  float v = bf16_round(acc + __bfloat162float(b));
#else
  float v = bf16_round(bf16_round(acc) + __bfloat162float(b));
#endif
  if (post_relu && v < 0.f) v = 0.f;
  return v;
#endif
}

__device__ __forceinline__ float load_x(const void* x, int x_f32, size_t i) {
  return x_f32 ? bf16_round(static_cast<const float*>(x)[i])
               : __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
}

// Stores y (a bf16-valued float) and the residual's sum at output index i.
__device__ __forceinline__ void store_y(void* y, const void* res, int out_f32,
                                        size_t i, float v) {
  if (out_f32) {
    if (res != nullptr) v += static_cast<const float*>(res)[i];
    static_cast<float*>(y)[i] = v;
    return;
  }
  if (res != nullptr)
    v += __bfloat162float(static_cast<const __nv_bfloat16*>(res)[i]);
  static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(v);
}

// Loads CH consecutive input channels (16 or 8 bytes) as floats.
template <int CH>
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
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(x) + off;
    if constexpr (CH == 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[j]);
        f[2 * j] = __low2float(h);
        f[2 * j + 1] = __high2float(h);
      }
    } else {
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(p);
      f[0] = __low2float(h);
      f[1] = __high2float(h);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d = a * b over one k16 step, from a zero accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// d += a * b over one k16 step, accumulated inside the tensor core.
__device__ __forceinline__ void mma_bf16_acc(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// |v| of both bf16 halves.
__device__ __forceinline__ uint32_t abs2(uint32_t v) {
  return v & 0x7fff7fffu;
}

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Offset, in staged voxels, of tap t = (dz * 3 + dy) * 3 + dx.
__device__ __forceinline__ int tap_offset(int t) {
  return ((t / 9) * SY + (t / 3) % 3) * SX + t % 3;
}

#ifndef FFN_K15_UNCORRECTED
// The exact sum of output channel `co` at staged voxel `vox` (tap 0), in
// float64 from the staged tile and weights: the warp's lanes split K (at
// Cin = 32 lane = channel, over the 27 taps) and a butterfly adds their
// parts in one fixed order; every lane returns it.
template <int CIN, int COUT>
__device__ __forceinline__ double exact_sum(const __nv_bfloat16* s_x,
                                            const __nv_bfloat16* s_w,
                                            int vox, int co, int lane) {
  using G = Geo<CIN, COUT>;
  double sum = 0.0;
  if constexpr (CIN == 32) {
#pragma unroll
    for (int tap = 0; tap < 27; ++tap)
      sum = fma((double)__bfloat162float(
                    s_x[(vox + tap_offset(tap)) * G::CS + lane]),
                (double)__bfloat162float(s_w[(tap * 32 + lane) * G::WS + co]),
                sum);
  } else {
    for (int k = lane; k < G::K; k += 32) {
      const int tap = k / CIN, ci = k % CIN;
      sum = fma((double)__bfloat162float(
                    s_x[(vox + tap_offset(tap)) * G::CS + ci]),
                (double)__bfloat162float(s_w[k * G::WS + co]), sum);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  return sum;
}
#endif

template <int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
conv3d_bf16_tc_kernel(const void* __restrict__ x, int x_f32,
                      const __nv_bfloat16* __restrict__ wt,
                      const __nv_bfloat16* __restrict__ bias,
                      const void* __restrict__ res, void* __restrict__ y,
                      int D, int H, int W, int pre_relu, int post_relu,
                      int out_f32, int tiles_x) {
  using G = Geo<CIN, COUT>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);  // [KPAD][WS]
  __nv_bfloat16* s_x = s_w + G::KPAD * G::WS;                   // [SVOX][CS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = (blockIdx.x % tiles_x) * TX;
  const int y0 = (blockIdx.x / tiles_x) * TY;
  const int z0 = blockIdx.y * TZ;
  const size_t vox0 = (size_t)blockIdx.z * D * H * W;  // the CTA's sample

  // Weights: row k = tap * Cin + ci of the DHWIO tensor, rows past K zero.
  constexpr int WCH = COUT / 8;
  for (int i = tid; i < G::KPAD * WCH; i += kThreads) {
    const int r = i / WCH, c = (i % WCH) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < G::K) v = *reinterpret_cast<const uint4*>(wt + (size_t)r * COUT + c);
    *reinterpret_cast<uint4*>(s_w + r * G::WS + c) = v;
  }
  // Input tile with its halo; SAME padding reads as zero.
  constexpr int CH = CIN < 8 ? CIN : 8;
  constexpr int XCH = CIN / CH;
  for (int i = tid; i < SVOX * XCH; i += kThreads) {
    const int v = i / XCH, c = (i % XCH) * CH;
    const int sx = v % SX, sy = (v / SX) % SY, sz = v / (SX * SY);
    const int gz = z0 + sz - 1, gy = y0 + sy - 1, gx = x0 + sx - 1;
    float f[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) f[j] = 0.f;
    if (gz >= 0 && gz < D && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      load_chunk<CH>(x, x_f32,
                     (vox0 + ((size_t)gz * H + gy) * W + gx) * CIN + c, f);
      if (pre_relu) {
#pragma unroll
        for (int j = 0; j < CH; ++j) f[j] = f[j] < 0.f ? 0.f : f[j];
      }
    }
    __nv_bfloat16* dst = s_x + v * G::CS + c;
    if constexpr (CH == 8) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                     pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
    } else {
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(f[0], f[1]);
    }
  }
  __syncthreads();

  // Fragment coordinates (PTX ISA, mma.m16n8k16): lane = 4 * g + t; A rows
  // g and g + 8, K pairs 2t and 2t + 8; C rows g and g + 8, columns 2t.
  const int g = lane >> 2, t = lane & 3;
  int row_vox[2][2];  // staged voxel of A row (g, g + 8) of m-tile mt, tap 0
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      row_vox[mt][h] = (warp * SY + 2 * mt + h) * SX + g;
  // ldmatrix: lane supplies row (lane & 7) of matrix lane / 8: matrices 0-1
  // are K rows 0-7 and 8-15 of n-tile 2p, matrices 2-3 those of 2p + 1.
  const uint32_t w_lane = static_cast<uint32_t>(__cvta_generic_to_shared(
      s_w + ((lane & 7) + ((lane >> 3) & 1) * 8) * G::WS + (lane >> 4) * 8));
  const uint32_t* s_x32 = reinterpret_cast<const uint32_t*>(s_x);

  float acc[2][G::NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
#ifndef FFN_K15_UNCORRECTED
  float mag[2][G::NT][4];  // sum of |x| * |w|: the scale of acc's error
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) mag[mt][nt][j] = 0.f;
#endif

#ifdef FFN_K15_REVERSE_K
#pragma unroll 2
  for (int k0 = G::KPAD - 16; k0 >= 0; k0 -= 16) {
#else
#pragma unroll 2
  for (int k0 = 0; k0 < G::KPAD; k0 += 16) {
#endif
    // A: the channel pairs k0 + 2t and k0 + 2t + 8, each of one tap (Cin is
    // even); a pair past K reads zero.
    uint32_t a[2][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kk = k0 + 2 * t + 8 * half;
      const int tap = kk / CIN, ci = kk % CIN;
      const bool live = tap < 27;
      const int off = live ? tap_offset(tap) : 0;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[mt][2 * half + h] =
              live ? s_x32[((row_vox[mt][h] + off) * G::CS + ci) >> 1] : 0u;
    }
    uint32_t b[G::NT][2];
#pragma unroll
    for (int p = 0; p < G::NT / 2; ++p) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, w_lane + (k0 * G::WS + p * 16) * 2);
      b[2 * p][0] = r[0];
      b[2 * p][1] = r[1];
      b[2 * p + 1][0] = r[2];
      b[2 * p + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
#ifdef FFN_K15_IN_MMA
        mma_bf16_acc(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
#else
        float d[4];
        mma_bf16(d, a[mt], b[nt][0], b[nt][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] += d[j];
#endif
#ifndef FFN_K15_UNCORRECTED
        const uint32_t am[4] = {abs2(a[mt][0]), abs2(a[mt][1]),
                                abs2(a[mt][2]), abs2(a[mt][3])};
        mma_bf16_acc(mag[mt][nt], am, abs2(b[nt][0]), abs2(b[nt][1]));
#endif
      }
  }

  // Where acc's error bound straddles a point at which bf16(f32(.))
  // changes, the warp sums that output exactly (exact_sum) and its owner
  // stores it; bit (mt * NT + nt) * 4 + q of `exact` marks those outputs.
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
        if (bf16_bits(v - e) != bf16_bits(v + e))
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
    const double sum = exact_sum<CIN, COUT>(
        s_x, s_w, (warp * SY + row) * SX + (owner >> 2), co, lane);
    const int gz = z0 + warp, gy = y0 + row, gx = x0 + (owner >> 2);
    if (lane == owner && gz < D && gy < H && gx < W)
      store_y(y, res, out_f32,
              (vox0 + ((size_t)gz * H + gy) * W + gx) * COUT + co,
              finish((float)sum, bias[co], post_relu));
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
          store_y(y, res, out_f32, o + co,
                  finish(acc[mt][nt][2 * h + j], bias[co], post_relu));
        }
    }
}

// 1^3 layers: one thread per output, its input channels summed in order.
__global__ void conv1_bf16_kernel(const void* __restrict__ x, int x_f32,
                                  const __nv_bfloat16* __restrict__ wt,
                                  const __nv_bfloat16* __restrict__ bias,
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
  double acc = 0.0;  // exact: products of 8-bit significands
#endif
  for (int j = 0; j < Cin; ++j) {
#ifdef FFN_K15_REVERSE_K
    const int ci = Cin - 1 - j;
#else
    const int ci = j;
#endif
    float xv = load_x(x, x_f32, (size_t)v * Cin + ci);
    if (pre_relu && xv < 0.f) xv = 0.f;
#ifdef FFN_K15_UNCORRECTED
    acc = fmaf(xv, __bfloat162float(wt[ci * Cout + co]), acc);
#else
    acc = fma((double)xv, (double)__bfloat162float(wt[ci * Cout + co]), acc);
#endif
  }
  store_y(y, res, out_f32, (size_t)i,
          finish((float)acc, bias[co], post_relu));
}

template <int CIN, int COUT>
cudaError_t launch_tc(const void* x, int x_f32, const __nv_bfloat16* w,
                      const __nv_bfloat16* bias, const void* res, void* y,
                      int N, int D, int H, int W, int pre_relu, int post_relu,
                      int out_f32, cudaStream_t s) {
  constexpr size_t smem = Geo<CIN, COUT>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      conv3d_bf16_tc_kernel<CIN, COUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + TX - 1) / TX, tiles_y = (H + TY - 1) / TY;
  const dim3 grid(tiles_x * tiles_y, (D + TZ - 1) / TZ, N);
  conv3d_bf16_tc_kernel<CIN, COUT><<<grid, kThreads, smem, s>>>(
      x, x_f32, w, bias, res, y, D, H, W, pre_relu, post_relu, out_f32,
      tiles_x);
  return cudaGetLastError();
}

}  // namespace

// x (N,D,H,W,Cin) bfloat16, or float32 when x_f32; w (k,k,k,Cin,Cout) and
// bias (Cout) bfloat16; res (N,D,H,W,Cout) or null, float32 when out_f32
// else bfloat16; y (N,D,H,W,Cout), float32 when out_f32 else bfloat16. All
// contiguous; k = 3 takes (Cin, Cout) in {(2,32), (32,32), (2,16), (16,16)}
// with x and w 16-byte aligned, k = 1 any widths.
extern "C" int ffn_conv3d_ndhwc_bf16(const void* x, int x_f32, const void* w,
                                     const void* bias, const void* res,
                                     void* y, int N, int D, int H, int W,
                                     int Cin, int Cout, int k, int pre_relu,
                                     int post_relu, int out_f32,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* bb = static_cast<const __nv_bfloat16*>(bias);
  if (k == 1) {
    const long long outputs = (long long)N * D * H * W * Cout;
    const int threads = 256;
    conv1_bf16_kernel<<<(unsigned)((outputs + threads - 1) / threads),
                        threads, 0, s>>>(x, x_f32, wb, bb, res, y, outputs,
                                         Cin, Cout, pre_relu, post_relu,
                                         out_f32);
    return static_cast<int>(cudaGetLastError());
  }
  if (k != 3) return static_cast<int>(cudaErrorInvalidValue);
#define FFN_K15_CASE(CI, CO)                                                \
  if (Cin == CI && Cout == CO)                                              \
    return static_cast<int>(launch_tc<CI, CO>(x, x_f32, wb, bb, res, y, N, \
                                              D, H, W, pre_relu,            \
                                              post_relu, out_f32, s));
  FFN_K15_CASE(2, 32)
  FFN_K15_CASE(32, 32)
  FFN_K15_CASE(2, 16)
  FFN_K15_CASE(16, 16)
#undef FFN_K15_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
