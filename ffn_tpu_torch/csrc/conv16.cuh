// The 16-bit types of K15 (conv3d_bf16.cu), K17 and K18 (conv3d_bwd16.cu):
// bfloat16 (8 significant bits) and float16 (11), each rounded to nearest
// even from float32, a float16 beyond 65504 to inf as XLA's convert does;
// their mma.sync m16n8k16 with float32 sums; the shared-memory tile
// geometry of the tensor-core kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

// (float too, as the identity: K10 shares K18's body, wgrad.cuh.)
template <typename T>
__device__ __forceinline__ float to_f(T v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else if constexpr (kIsHalf<T>) return __half2float(v);
  else return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else if constexpr (kIsHalf<T>) return __float2half_rn(v);
  else return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float round16(float v) { return to_f<T>(from_f<T>(v)); }

template <typename T>
__device__ __forceinline__ unsigned short bits16(float v) {
  const T h = from_f<T>(v);
  return *reinterpret_cast<const unsigned short*>(&h);
}

// Two values, lo in the low half, as one 32-bit word; and back.
template <typename T>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  const uint32_t a = bits16<T>(lo), b = bits16<T>(hi);
  return a | (b << 16);
}

template <typename T>
__device__ __forceinline__ void unpack16(uint32_t w, float& lo, float& hi) {
  const unsigned short a = w & 0xffffu, b = w >> 16;
  lo = to_f<T>(*reinterpret_cast<const T*>(&a));
  hi = to_f<T>(*reinterpret_cast<const T*>(&b));
}

// |v| of both halves (the sign bit is bit 15 in either type).
__device__ __forceinline__ uint32_t abs2(uint32_t v) { return v & 0x7fff7fffu; }

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d = a * b over one k16 step from a zero accumulator (acc = false), or
// d += a * b inside the tensor core (acc = true).
template <typename T, bool ACC>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
#define FFN_MMA(TY)                                                          \
  if constexpr (ACC)                                                         \
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 " \
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"   \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])            \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),      \
                   "r"(b1));                                                 \
  else                                                                       \
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 " \
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "                   \
                 "{%10,%10,%10,%10};\n"                                      \
                 : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])            \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),      \
                   "r"(b1), "f"(0.f));
  if constexpr (kIsHalf<T>) {
    FFN_MMA("f16")
  } else {
    FFN_MMA("bf16")
  }
#undef FFN_MMA
}

// A CTA of 4 warps owns a 4(z) x 4(y) x 8(x) voxel tile; warp w owns z = w
// as two m16 tiles (two y rows of 8 x). Staged: the tile with its 3^3 halo.
constexpr int kTcThreads = 128;
constexpr int TZ = 4, TY = 4, TX = 8;
constexpr int SZ = TZ + 2, SY = TY + 2, SX = TX + 2;
constexpr int SVOX = SZ * SY * SX;

// The implicit GEMM of a 3^3 layer with CIN input and COUT output channels:
// K = 27 * CIN in (tap, channel) order, padded to k16 steps; shared-memory
// row strides in 16-bit values, +8 so that the 8 rows a fragment load
// touches hit distinct banks (CIN = 2 packs taps along K and needs none).
template <int CIN, int COUT>
struct Geo {
  static constexpr int K = 27 * CIN;
  static constexpr int KPAD = (K + 15) / 16 * 16;
  static constexpr int CS = CIN % 16 == 0 ? CIN + 8 : CIN;
  static constexpr int WS = COUT + 8;
  static constexpr int NT = COUT / 8;
  static constexpr size_t SMEM =
      (size_t)KPAD * WS * 2 + (size_t)SVOX * CS * 2;
};

// Offset, in staged voxels, of tap t = (dz * 3 + dy) * 3 + dx.
__device__ __forceinline__ int tap_offset(int t) {
  return ((t / 9) * SY + (t / 3) % 3) * SX + t % 3;
}

// The implicit GEMM's sums of a CTA's tile (staged input s_x, weights s_w):
// acc[mt][nt] the float32 sums of m-tile mt (the warp's y rows 2mt, 2mt+1),
// n-tile nt, in C fragment order; with MAG also the sums of |x| * |w|. Each
// k16 step's products are summed by the tensor core from zero and added by
// a float32 add (FFN_K15_IN_MMA: inside the tensor core).
template <typename T, int CIN, int COUT, bool MAG>
__device__ __forceinline__ void tc_sums(const T* s_x, const T* s_w, int warp,
                                        int lane, float (&acc)[2][COUT / 8][4],
                                        float (&mag)[2][COUT / 8][4]) {
  using G = Geo<CIN, COUT>;
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

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = mag[mt][nt][j] = 0.f;

#pragma unroll 2
  for (int k0 = 0; k0 < G::KPAD; k0 += 16) {
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
        mma16<T, true>(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
#else
        float d[4];
        mma16<T, false>(d, a[mt], b[nt][0], b[nt][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] += d[j];
#endif
        if constexpr (MAG) {
          const uint32_t am[4] = {abs2(a[mt][0]), abs2(a[mt][1]),
                                  abs2(a[mt][2]), abs2(a[mt][3])};
          mma16<T, true>(mag[mt][nt], am, abs2(b[nt][0]), abs2(b[nt][1]));
        }
      }
  }
}

}  // namespace
