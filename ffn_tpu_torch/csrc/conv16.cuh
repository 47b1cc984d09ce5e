// The 16-bit types of K15 (conv3d_bf16.cu), K17 and K18 (conv3d_bwd16.cu):
// bfloat16 (8 significant bits) and float16 (11), each rounded to nearest
// even from float32, a float16 beyond 65504 to inf as XLA's convert does;
// their mma.sync m16n8k16 with float32 sums; and the plane-position tiles
// that K15 and K17 share (their staging by cp.async, the tap-row sums of a
// tile on the tensor cores). K9 (conv3d_bwd.cu) uses the cp.async helpers.

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

// -- Plane-position tiles (K15, conv3d_bf16.cu; K17, conv3d_bwd16.cu) ------
//
// A tile is kTileRows voxels at consecutive positions q = y * P + x of one
// z-plane of one sample, P = W + 1: a zero column after each row stands for
// SAME padding on both sides, so each tap of a 3^3 layer is one fixed row
// offset dz R + dy P + dx into the tile's halo of three planes of R =
// kTileRows + 2P + 2 rows (ops/conv3d.py's k15_geometry mirrors it). A CTA
// of kTileWarps warps, warp w owning tile rows [16 w, 16 w + 16) and every
// output channel, sums the implicit GEMM on the tensor cores.

constexpr int kTileRows = 128;
constexpr int kTileWarps = kTileRows / 16;  // one m16 tile a warp
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kSmemLimit = 232448;  // a CTA's shared memory on an H100

// The implicit GEMM of a 3^3 layer with CIN input and COUT output channels:
// K = 27 CIN in (tap, channel) order, padded to k16 steps. Strides in 16-bit
// values: weights [co][WK], halo rows CS (+8: the 8 rows an ldmatrix reads
// hit distinct banks; CIN = 2 reads 32-bit words and needs none).
template <int CIN, int COUT>
struct K15Geo {
  static constexpr int K = 27 * CIN;
  static constexpr int KPAD = (K + 15) / 16 * 16;
  static constexpr int WK = KPAD + 8;
  static constexpr int CS = CIN % 16 == 0 ? CIN + 8 : CIN;
  static constexpr int NT = COUT / 8;
  static constexpr int W_BYTES = COUT * WK * 2;
  static constexpr int QUEUE_BYTES = kTileRows * COUT * 2;
};

// A stage's bytes (three planes of R rows), in 128s.
template <int CIN, int COUT>
__host__ __device__ inline int stage_bytes(int R) {
  return (3 * R * K15Geo<CIN, COUT>::CS * 2 + 127) / 128 * 128;
}

// relu of both 16-bit halves of T.
template <typename T>
__device__ __forceinline__ uint32_t relu2(uint32_t v) {
  uint32_t r;
  if constexpr (kIsHalf<T>)
    asm("max.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(v), "r"(0u));
  else
    asm("max.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(v), "r"(0u));
  return r;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// cp.async of BYTES (16 or 4) from src to shared dst, zero-filled (and src
// not read) unless `valid`.
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(BYTES), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The tile's place: sample n, plane z, first position q0.
struct Tile {
  int n, z, q0;
};

__device__ __forceinline__ Tile tile_at(long long t, int D, int per_plane) {
  const long long plane = t / per_plane;
  return Tile{(int)(plane / D), (int)(plane % D),
              (int)(t - plane * per_plane) * kTileRows};
}

// Stages tile `tl`'s halo: plane dz (z + dz - 1) rows h = 0..R-1 hold the
// voxel at q = q0 - P - 1 + h, zero outside the volume and in the zero
// column. 16-bit x by cp.async (the caller commits), float32 x rounded
// through registers.
template <typename T, int CIN, int COUT>
__device__ __forceinline__ void stage_tile(T* st, const void* x, int x_f32,
                                           Tile tl, int D, int H, int W,
                                           int P, int R) {
  using G = K15Geo<CIN, COUT>;
  constexpr int CH = CIN < 8 ? CIN : 8;  // values a copy
  constexpr int CPR = CIN / CH;           // copies a row
  const int hp = H * P;
  for (int i = threadIdx.x; i < R * CPR; i += kTileThreads) {
    const int h = i / CPR, c = (i - h * CPR) * CH;
    const int q = tl.q0 - P - 1 + h;
    const bool in_plane = q >= 0 && q < hp;
    const int gy = in_plane ? q / P : 0, gx = q - gy * P;
    const bool in_row = in_plane && gx < W;
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
      const int zz = tl.z + dz - 1;
      const bool valid = in_row && zz >= 0 && zz < D;
      const size_t src =
          valid ? ((((size_t)tl.n * D + zz) * H + gy) * W + gx) * CIN + c
                : 0;
      T* dst = st + (dz * R + h) * G::CS + c;
      if (!x_f32) {
        cp_async<CH * 2>(
            static_cast<uint32_t>(__cvta_generic_to_shared(dst)),
            static_cast<const T*>(x) + src, valid);
        continue;
      }
      const float* p = static_cast<const float*>(x) + src;
      if constexpr (CH == 8) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
        if (valid) {
          a = *reinterpret_cast<const float4*>(p);
          b = *reinterpret_cast<const float4*>(p + 4);
        }
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(pack16<T>(a.x, a.y), pack16<T>(a.z, a.w),
                       pack16<T>(b.x, b.y), pack16<T>(b.z, b.w));
      } else {
        float2 a = make_float2(0.f, 0.f);
        if (valid) a = *reinterpret_cast<const float2*>(p);
        *reinterpret_cast<uint32_t*>(dst) = pack16<T>(a.x, a.y);
      }
    }
  }
}

// The implicit GEMM's sums of warp `warp`'s 16 rows of the staged tile st:
// acc[nt] the float32 sums of n-tile nt in C fragment order; with MAG also
// the sums of |x| * |w| (in the tensor core).
template <typename T, int CIN, int COUT, bool MAG>
__device__ __forceinline__ void tile_sums(const T* st, const T* s_w,
                                          int warp, int lane, int P, int R,
                                          int pre_relu,
                                          float (&acc)[COUT / 8][4],
                                          float (&mag)[COUT / 8][4]) {
  using G = K15Geo<CIN, COUT>;
#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = mag[nt][j] = 0.f;
  // ldmatrix B: lane supplies row (co) (lane & 7) + 8 (lane >> 4), k half
  // (lane >> 3) & 1: matrices 0-1 are n-tile 2p's k 0-7 and 8-15, 2-3 those
  // of 2p + 1.
  const uint32_t b_lane = static_cast<uint32_t>(__cvta_generic_to_shared(
      s_w + ((lane & 7) + (lane >> 4) * 8) * G::WK + ((lane >> 3) & 1) * 8));

  // One k16 step: its sums from zero added to `into` (a tap row's partial
  // sum, or acc at Cin = 2).
  auto step = [&](const uint32_t (&a)[4], int k0, float (&into)[G::NT][4]) {
    uint32_t b[G::NT][2], bm[G::NT][2], am[4];
#pragma unroll
    for (int p = 0; p < G::NT / 2; ++p) {
      uint32_t r[4];
      ldmatrix_x4(r, b_lane + (p * 16 * G::WK + k0) * 2);
      b[2 * p][0] = r[0];
      b[2 * p][1] = r[1];
      b[2 * p + 1][0] = r[2];
      b[2 * p + 1][1] = r[3];
    }
    if constexpr (MAG) {
#pragma unroll
      for (int j = 0; j < 4; ++j) am[j] = abs2(a[j]);
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        bm[nt][0] = abs2(b[nt][0]);
        bm[nt][1] = abs2(b[nt][1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
#ifdef FFN_K15_IN_MMA
      mma16<T, true>(into[nt], a, b[nt][0], b[nt][1]);
#else
      float d[4];
      mma16<T, false>(d, a, b[nt][0], b[nt][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) into[nt][j] += d[j];
#endif
      if constexpr (MAG) mma16<T, true>(mag[nt], am, bm[nt][0], bm[nt][1]);
    }
  };

  if constexpr (CIN % 16 == 0) {
    // A by ldmatrix: lane supplies row lane & 15, k half lane >> 4
    // (matrices: rows 0-7 and 8-15 of k 0-7, then of k 8-15).
    // Each tap row (dz, dy): its 3 CIN / 16 steps summed from zero, then
    // added to acc.
    const uint32_t a_lane = static_cast<uint32_t>(__cvta_generic_to_shared(
        st + (warp * 16 + (lane & 15)) * G::CS + (lane >> 4) * 8));
#pragma unroll 1
    for (int zy = 0; zy < 9; ++zy) {
      const int dz = zy / 3, dy = zy - dz * 3;
      const int base = (dz * R + dy * P) * G::CS;
      float row[G::NT][4] = {};
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int s = 0; s < CIN / 16; ++s) {
          uint32_t a[4];
          ldmatrix_x4(a, a_lane + (base + dx * G::CS + s * 16) * 2);
          if (pre_relu) {
#pragma unroll
            for (int j = 0; j < 4; ++j) a[j] = relu2<T>(a[j]);
          }
          step(a, (zy * 3 + dx) * CIN + s * 16, row);
        }
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][j] += row[nt][j];
    }
  } else {
    // CIN = 2: the pairs k0 + 2t and k0 + 2t + 8 are taps (k0 + 2t) / 2 and
    // that + 4, both channels one 32-bit word; a tap past 26 reads zero.
    static_assert(CIN == 2, "K15's 3^3 kernel takes Cin 2, 16 or 32");
    const int g = lane >> 2, t = lane & 3;
    const uint32_t* st32 = reinterpret_cast<const uint32_t*>(st);
#pragma unroll
    for (int k0 = 0; k0 < G::KPAD; k0 += 16) {
      uint32_t a[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int tap = (k0 + 2 * t + 8 * half) / 2;
        const bool live = tap < 27;
        const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
        const int off = live ? dz * R + dy * P + dx : 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t v = live ? st32[warp * 16 + g + 8 * h + off] : 0u;
          a[2 * half + h] = pre_relu ? relu2<T>(v) : v;
        }
      }
      step(a, k0, acc);
    }
  }
}

// The grid of a persistent kernel: the SMs times the CTAs an SM holds at
// `smem` bytes of dynamic shared memory (set for the kernel here) and its
// registers, at most `tiles`.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                            long long tiles, unsigned* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  const long long ctas = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (unsigned)(tiles < ctas ? tiles : ctas);
  return cudaSuccess;
}

}  // namespace
