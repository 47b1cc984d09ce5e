// K19: qconv3d_s8 -- the int8 SAME 3D convolution of the quantized stack,
// channels-last, as an implicit GEMM on the int8 tensor cores; K20:
// act_absmax -- each lane's floored abs-max of a layer's input. Together
// they replace qconv3d and _dyn_quantize_activation (ffn_tpu/ops/
// quantized.py:73-114) under the engines' jax.vmap: one scale per lane.
//
// The arithmetic is the JAX program's as XLA's CPU backend compiles it
// (the plain versions, ffn_tpu_torch/ops/quantized.py, equal it bit for
// bit): m = max(absmax, 1e-12); scale = m * f32(1/127) (XLA turns `/ 127`
// into a product); q = clip(rint(relu?(x) / scale), +-127) with an IEEE
// division, half to even; acc = sum q * w_q in int32 (|acc| < 2^24: exact
// in any order, and exact as a float); y = fma(acc, s, bias), one rounding,
// with s = scale * w_scale[c], or for Cout = 1 (conv_lom, where XLA folds
// the two constants first) s = m * f32(f32(1/127) * w_scale); then relu
// (relu_out) and the residual, each rounded on its own. The build has no
// --use_fast_math; the intrinsics pin each rounding anyway. Any order of
// the int32 sums and any tiling give the same bits.
//
// Bound on the H100: a 3^3 32->32 layer on N 33^3 samples reads 4.6 MB of
// float32 a sample and writes as much (0.176 ms at N = 64 over 3.35 TB/s)
// against 2 GOP of int8 (0.064 ms at 1979 TOP/s): bytes. Design of the 3^3
// layers (ops/quantized.py's k19_geometry mirrors the plan):
// - Rows are K15's plane positions q = y P + x, P = W + 1 rounded up to
//   even: the zero column(s) after each row stand for SAME padding, so a
//   tap (dz, dy, dx) is plane dz's row offset dy P + dx (5.5% padded slots
//   at 33^3, the zero column and the last pair of m16 tiles; a 4x4x8 box
//   of voxels wastes 44%).
// - A work item is (sample, band of M positions of a plane, segment of L
//   z-planes). A persistent CTA of kQWarps warps walks its items; per item
//   it keeps a ring of four quantized planes (int8, R = M + 2P + 2 halo
//   rows each): three are read (z - 1, z, z + 1), the fourth is filled
//   with plane z + 2 while plane z's MMAs run. Each input element is
//   loaded by float4 (__ldg), quantized in registers once per item (the
//   reciprocal's product, the IEEE quotient only near a half-integer:
//   quantize) and stored as int8 x 4 words; a segment stages two planes beyond its own,
//   a band 2P + 2 rows beyond its own (PERF.md gives the share a shape).
//   The plan picks (M, L) by a cost in bytes that counts the rounds of
//   items over the CTAs, so N = 1 still gives every SM work, among bands
//   that let two CTAs share an SM (one CTA of the bigger bands lost 1.5x,
//   tools_torch/k19_variants.py).
// - The layer's weights, packed once when the layer is folded (QuantizedConv
//   .w_k: [Cout][KPAD + 16], K = 27 Cin in (tap, channel) order, zero past
//   K; the +16 puts an ldmatrix's 8 rows on distinct banks), stay resident:
//   a CTA stages them once by 16-byte cp.async.
// - Warp w takes pairs of m16 tiles (32 positions) w, w + kQWarps, ... of
//   the band: mma.sync m16n8k32 s8 with s32 sums; A and B by ldmatrix from
//   fixed tap offsets (Cin 32: ring rows of 32 bytes, 16-byte halves
//   swizzled by bit 2 of the row against bank conflicts; Cin 16: a k32 step
//   is two taps, one a half-warp; Cin 2: two taps of 2 channels a 32-bit
//   word, 16-bit loads at offsets found once a kernel). No division or
//   bounds check in the MMA loop. Before a pair's MMAs each thread issues
//   its next batch of kQLoads float4 loads of plane z + 2; after them it
//   quantizes and stores that batch.
// - Epilogue: dequantize, relu_out, the residual; float2 loads and stores
//   (each thread holds channel pairs 2t, 2t + 1).
// Measured (tools_torch/k19_variants.py --split, 32->32 at N=64, NVIDIA
// H100 80GB HBM3, 700 W): 381 device us (torch._int_mm on the im2col
// 3304); the MMAs cost ~98 of it, the input loads ~51, the quantize ~26,
// the epilogue's stores ~22, each cut alone; the rest is latency the
// pipeline leaves exposed (the first three planes of an item, the last
// batch of a plane, a barrier a plane).
// A CTA never mixes samples in a tile, so a lane's result does not depend
// on N. 1^3 layers (conv_lom) are an int32 dot product per output on the
// CUDA cores, the input channels read by float4. K20 reads each lane's
// slice once by float4 (bound by bytes: 294 MB
// at N = 64 and 32 channels, 0.088 ms): blocks of 256 threads, 4 loads in
// flight a thread, a grid of about two waves over (lane, slice); the
// floats before the lane's first 16-byte boundary and after its last
// float4 go to its first block (the 2-channel input layer's lanes, 33^3 * 2
// floats, start 16-byte aligned every other lane). Each block
// folds its maximum into the lane's by atomicMax on the bits of non-negative
// floats (exact, order-free); the lane's last block writes m and zeroes the
// lane's two counters, so the wrapper's buffer needs no memset per call.
// Left for later: TMA, wgmma, K20 fused into K19's epilogue.

#include <mutex>

#include "conv16.cuh"

namespace {

constexpr float kC127 = 1.0f / 127.0f;  // f32(1/127), as XLA folds it
constexpr float kFloor = 1e-12f;

// K19's CTA: kQWarps warps (33^3's 36 pairs a plane split evenly in bands
// of 6, 12, 18 or 36 pairs), at most kQPerSM CTAs an SM, kQLoads float4
// loads in flight a thread.
constexpr int kQWarps = 6;
constexpr int kQThreads = 32 * kQWarps;
constexpr int kQPair = 32;   // positions a warp's step: two m16 tiles
constexpr int kQPerSM = 2;
constexpr int kQLoads = 8;
constexpr int kQSmemSM = 233472;  // an H100 SM's; each CTA reserves 1 KB

// The implicit GEMM of a 3^3 layer: K = 27 CIN in (tap, channel) order,
// padded to k32 steps; weights [COUT][WK] bytes. Ring rows hold CIN bytes
// (CIN 32: two swizzled 16-byte halves), loaded in kCpr units a row
// (float4s, or one float2 at CIN 2).
template <int CIN, int COUT>
struct QGeo {
  static_assert(CIN == 2 || CIN == 16 || CIN == 32, "K19: Cin 2, 16, 32");
  static_assert(COUT == 16 || COUT == 32, "K19: Cout 16 or 32");
  static constexpr int K = 27 * CIN;
  static constexpr int KPAD = (K + 31) / 32 * 32;
  static constexpr int WK = KPAD + 16;
  static constexpr int NT = COUT / 8;
  static constexpr int W_BYTES = COUT * WK;  // a multiple of 128
};

template <int CIN>
constexpr int kCpr = CIN == 2 ? 1 : CIN / 4;

__host__ __device__ inline int round128(int v) { return (v + 127) / 128 * 128; }

// A CTA's shared memory: weights, the halo table (R ints), four ring slots.
__host__ __device__ inline int q_slot_bytes(int R, int cin) {
  return round128(R * cin);
}
__host__ __device__ inline int q_smem(int R, int cin, int cout) {
  const int kpad = (27 * cin + 31) / 32 * 32;
  return cout * (kpad + 16) + round128(4 * R) + 4 * q_slot_bytes(R, cin);
}

// The plan of a 3^3 layer on x (N, D, H, W, Cin): pitch P; bands of M
// positions (nb a plane), halo rows R; segments of L planes (nseg a
// sample); items N nb nseg; CTAs an SM and shared bytes.
struct QPlan {
  int P, M, R, nb, L, nseg, per_sm, smem;
  long long items, ctas;
};

// The plan of least cost among bands that let kQPerSM CTAs share an SM
// (any band where none does): rounds of items over sms * per_sm CTAs,
// times per_sm (CTAs of an SM share it), times an item's bytes: (L + 2)
// planes of R rows in, L planes of M positions out, M counted in whole
// rounds of the warps' pairs. Ties go to fewer items. False if no band
// fits.
inline bool q_plan(int N, int D, int H, int W, int cin, int cout, int sms,
                   QPlan* out) {
  const int P = (W + 2) & ~1;
  const long long plane = (long long)H * P - 1;  // up to the last voxel
  const int pairs = (int)((plane + kQPair - 1) / kQPair);
  bool found = false;
  double best = 0.0;
  for (int min_per_sm = kQPerSM; min_per_sm >= 1 && !found; --min_per_sm)
  for (int nb = 1; nb <= pairs; ++nb) {
    const int pp = (pairs + nb - 1) / nb;
    if ((pairs + pp - 1) / pp != nb) continue;  // a smaller nb's bands
    const int M = kQPair * pp, R = M + 2 * P + 2;
    const int smem = q_smem(R, cin, cout);
    const int per_sm_fit = kQSmemSM / (smem + 1024);
    const int per_sm = per_sm_fit < kQPerSM ? per_sm_fit : kQPerSM;
    if (per_sm < min_per_sm) continue;
    const long long ctas = (long long)sms * per_sm;
    const double m_eff = (double)kQPair * kQWarps * ((pp + kQWarps - 1) / kQWarps);
    for (int nseg = 1; nseg <= D; ++nseg) {
      const int L = (D + nseg - 1) / nseg;
      if ((D + L - 1) / L != nseg) continue;  // a smaller nseg's segments
      const long long items = (long long)N * nb * nseg;
      const long long rounds = (items + ctas - 1) / ctas;
      const double cost = (double)rounds * per_sm *
                          ((double)(L + 2) * R * cin + (double)L * m_eff * cout);
      if (!found || cost < best ||
          (cost == best && items < out->items)) {
        found = true;
        best = cost;
        *out = QPlan{P, M, R, nb, L, nseg, per_sm, smem, items, ctas};
      }
    }
  }
  return found;
}

struct QArgs {
  int D, H, W, P, M, R, L, nb, nseg, slot, relu_in, relu_out;
  long long items;
};

// q = clip(rint(relu?(v) / scale), +-127), the IEEE quotient rounded half to
// even, with rcp = __frcp_rn(scale): y = v * rcp differs from the quotient
// t by less than |y| 2^-21 (two roundings, of 1/scale and of the product,
// against t's one: |y - t| < |v / scale| (3 2^-24 + 2^-47)), so where y lies
// more than |y| 2^-20 from the nearest half-integer (that distance is exact
// there, by Sterbenz), rint(y) = rint(t); elsewhere (and for inf or NaN)
// the IEEE division decides. Bit for bit the division's result, without
// its cost on nearly every element.
__device__ __forceinline__ int quantize(float v, float scale, float rcp,
                                        int relu) {
  if (relu && v < 0.f) v = 0.f;
  const float y = __fmul_rn(v, rcp);
  const float d = fabsf(__fsub_rn(y, __fadd_rn(floorf(y), 0.5f)));
  const int q = d > __fmul_rn(fabsf(y), 0x1p-20f)
                    ? __float2int_rn(y)
                    : __float2int_rn(__fdiv_rn(v, scale));
  return q < -127 ? -127 : (q > 127 ? 127 : q);
}

__device__ __forceinline__ uint32_t quantize4(float4 v, float scale,
                                              float rcp, int relu) {
  return (uint32_t)(quantize(v.x, scale, rcp, relu) & 0xff) |
         (uint32_t)(quantize(v.y, scale, rcp, relu) & 0xff) << 8 |
         (uint32_t)(quantize(v.z, scale, rcp, relu) & 0xff) << 16 |
         (uint32_t)(quantize(v.w, scale, rcp, relu) & 0xff) << 24;
}

// The dequantize of output channel c: fma(acc, s, bias), relu, residual.
__device__ __forceinline__ float dequantize(int acc, float m, float scale,
                                            const float* w_scale,
                                            const float* bias, int c,
                                            int cout, int relu_out,
                                            const float* res, size_t i) {
  const float s = cout == 1 ? __fmul_rn(m, __fmul_rn(kC127, w_scale[0]))
                            : __fmul_rn(scale, w_scale[c]);
  float v = __fmaf_rn(__int2float_rn(acc), s, bias[c]);
  if (relu_out && v < 0.f) v = 0.f;
  if (res != nullptr) v = __fadd_rn(v, res[i]);
  return v;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int ring_slot(int z) { return (z + 4) & 3; }

// The byte of ring row h, channel c (c % 4 == 0 below 32 channels' halves).
template <int CIN>
__device__ __forceinline__ int ring_byte(int h, int c) {
  if constexpr (CIN == 32)
    return h * 32 + ((((c >> 4) ^ (h >> 2)) & 1) << 4) + (c & 15);
  else
    return h * CIN + c;
}

// One batch of a plane's staging: load units u0, u0 + nt, ... (kQLoads of
// them, those below `units`) of plane zz of the sample at xn, zero outside
// the volume and where the halo table says -1 (off the plane, zero column).
template <int CIN>
__device__ __forceinline__ void load_batch(float4 (&v)[kQLoads],
                                           const float* xn, int zz, int u0,
                                           int nt, int units, const int* tab,
                                           const QArgs& a) {
  constexpr int CPR = kCpr<CIN>;
  const bool live = zz >= 0 && zz < a.D;
  const float* xp = xn + (size_t)(live ? zz : 0) * a.H * a.W * CIN;
#pragma unroll
  for (int j = 0; j < kQLoads; ++j) {
    const int u = u0 + j * nt;
    v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!live || u >= units) continue;
    const int h = u / CPR, c = (u - h * CPR) * 4;
    const int off = tab[h];
    if (off < 0) continue;
    if constexpr (CIN == 2) {
      const float2 f = __ldg(reinterpret_cast<const float2*>(
          xp + (size_t)off * CIN));
      v[j] = make_float4(f.x, f.y, 0.f, 0.f);
    } else {
      v[j] = __ldg(reinterpret_cast<const float4*>(xp + (size_t)off * CIN + c));
    }
  }
}

// Quantizes a loaded batch and stores it into ring slot `dst`.
template <int CIN>
__device__ __forceinline__ void store_batch(const float4 (&v)[kQLoads],
                                            unsigned char* dst, int u0,
                                            int nt, int units, float scale,
                                            float rcp, int relu) {
  constexpr int CPR = kCpr<CIN>;
#pragma unroll
  for (int j = 0; j < kQLoads; ++j) {
    const int u = u0 + j * nt;
    if (u >= units) continue;
    const int h = u / CPR, c = (u - h * CPR) * 4;
    const uint32_t w = quantize4(v[j], scale, rcp, relu);
    if constexpr (CIN == 2)
      *reinterpret_cast<uint16_t*>(dst + h * 2) = (uint16_t)w;
    else
      *reinterpret_cast<uint32_t*>(dst + ring_byte<CIN>(h, c)) = w;
  }
}

// The implicit GEMM of one pair of m16 tiles at band rows m0.. of output
// plane z: acc[mt][nt] in C fragment order. sb[dz]: the shared address of
// plane z + dz - 1's ring slot; b_lane: this lane's ldmatrix row of the
// weights; off2: (CIN 2) this lane's eight word halves' (slot, row offset).
template <int CIN, int COUT>
__device__ __forceinline__ void pair_sums(int (&acc)[2][COUT / 8][4],
                                          const uint32_t (&sb)[3],
                                          uint32_t b_lane, int m0, int lane,
                                          int P, const int (&dz2)[8],
                                          const int (&off2)[8]) {
  using G = QGeo<CIN, COUT>;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;
  // B by ldmatrix: lane supplies weight row (co) (lane & 7) + 8 (lane >> 4)
  // of n-tile pair p, k half (lane >> 3) & 1: matrices b0, b1 of n-tile
  // 2p, then of 2p + 1.
  auto mma_step = [&](const uint32_t (&a)[2][4], int k0) {
#pragma unroll
    for (int p = 0; p < G::NT / 2; ++p) {
      uint32_t r[4];
      ldmatrix_x4(r, b_lane + p * 16 * G::WK + k0);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_s8(acc[mt][2 * p], a[mt], r[0], r[1]);
        mma_s8(acc[mt][2 * p + 1], a[mt], r[2], r[3]);
      }
    }
  };
  const int P2 = 2 * P;
  if constexpr (CIN == 32) {
    // A by ldmatrix: lane supplies row m0 + (lane & 15) (+16 for mt 1: the
    // same swizzle bit), k half lane >> 4. One tap a k32 step.
    const int rl = m0 + (lane & 15), kh = lane >> 4;
#pragma unroll
    for (int t = 0; t < 27; ++t) {
      const int dz = t / 9, dy = t / 3 % 3, dx = t % 3;
      const int r = rl + (dy == 0 ? 0 : dy == 1 ? P : P2) + dx;
      const uint32_t at = sb[dz] + r * 32 + (((kh ^ (r >> 2)) & 1) << 4);
      uint32_t a[2][4];
      ldmatrix_x4(a[0], at);
      ldmatrix_x4(a[1], at + 16 * 32);
      mma_step(a, 32 * t);
    }
  } else if constexpr (CIN == 16) {
    // Two taps a k32 step: the lower half-warp's rows at tap 2s, the upper
    // half's at 2s + 1 (a tap past 26 reads tap 26: its weights are zero).
    const int rl = m0 + (lane & 15);
    const bool hi = lane >= 16;
#pragma unroll
    for (int s = 0; s < G::KPAD / 32; ++s) {
      constexpr int kLast = 26;
      const int t0 = 2 * s, t1 = 2 * s + 1 > kLast ? kLast : 2 * s + 1;
      const int dz = hi ? t1 / 9 : t0 / 9;
      const int dy = hi ? t1 / 3 % 3 : t0 / 3 % 3;
      const int dx = hi ? t1 % 3 : t0 % 3;
      const int r = rl + (dy == 0 ? 0 : dy == 1 ? P : P2) + dx;
      const uint32_t base = dz == 0 ? sb[0] : dz == 1 ? sb[1] : sb[2];
      uint32_t a[2][4];
      ldmatrix_x4(a[0], base + r * 16);
      ldmatrix_x4(a[1], base + (r + 16) * 16);
      mma_step(a, 32 * s);
    }
  } else {
    // Cin 2: A word (row g or g + 8, k half kh) = taps 16 s + 8 kh + 2 t and
    // the next, 2 channels each, two 16-bit loads at (slot, row offset)
    // pairs found once (dz2, off2; a tap past 26 reads tap 26: zero
    // weights).
    const int g = lane >> 2;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = m0 + 16 * mt + g + 8 * hh;
            uint32_t w = 0;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = (s * 2 + kh) * 2 + e;
              const uint32_t base =
                  dz2[i] == 0 ? sb[0] : dz2[i] == 1 ? sb[1] : sb[2];
              uint16_t h16;
              asm volatile("ld.shared.u16 %0, [%1];\n"
                           : "=h"(h16)
                           : "r"(base + (row + off2[i]) * 2));
              w |= (uint32_t)h16 << (16 * e);
            }
            a[mt][2 * kh + hh] = w;
          }
      mma_step(a, 32 * s);
    }
  }
}

template <int CIN, int COUT>
__global__ void __launch_bounds__(kQThreads, kQPerSM)
qconv3d_s8_kernel(const float* __restrict__ x, const int8_t* __restrict__ wk,
                  const float* __restrict__ w_scale,
                  const float* __restrict__ bias,
                  const float* __restrict__ absmax,
                  const float* __restrict__ res, float* __restrict__ y,
                  QArgs a) {
  using G = QGeo<CIN, COUT>;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* s_w = reinterpret_cast<int8_t*>(smem);              // [COUT][WK]
  int* s_tab = reinterpret_cast<int*>(smem + G::W_BYTES);      // [R]
  unsigned char* ring = smem + G::W_BYTES + round128(4 * a.R);  // [4][slot]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // The weights once, by 16-byte copies.
  const uint32_t w_s = static_cast<uint32_t>(__cvta_generic_to_shared(s_w));
  for (int i = tid; i < G::W_BYTES / 16; i += kQThreads)
    cp_async<16>(w_s + 16 * i, wk + 16 * i, true);
  cp_async_commit();
  const uint32_t b_lane =
      w_s + ((lane & 7) + 8 * (lane >> 4)) * G::WK + 16 * ((lane >> 3) & 1);
  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  // Cin 2: the (slot, row offset) of each of the lane's eight word halves.
  int dz2[8] = {}, off2[8] = {};
  if constexpr (CIN == 2) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = i >> 2, kh = (i >> 1) & 1, e = i & 1;
      int tap = 16 * s + 8 * kh + 2 * t + e;
      if (tap > 26) tap = 26;
      dz2[i] = tap / 9;
      off2[i] = (tap / 3 % 3) * a.P + tap % 3;
    }
  }

  const int pairs = a.M / kQPair;
  const int plane_pos = a.H * a.P - 1;  // positions up to the last voxel
  const int units = a.R * kCpr<CIN>;    // load units a plane
  const size_t hw = (size_t)a.H * a.W;
  int band = -1;
  for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int b = (int)(item % a.nb);
    const long long ns = item / a.nb;
    const int n = (int)(ns / a.nseg), seg = (int)(ns % a.nseg);
    const int q0 = b * a.M, z0 = seg * a.L;
    const int z1 = z0 + a.L < a.D ? z0 + a.L : a.D;
    __syncthreads();  // the last item's ring and table are read
    if (b != band) {  // halo row h: the voxel of plane position q0-P-1+h
      band = b;
      for (int h = tid; h < a.R; h += kQThreads) {
        const int q = q0 - a.P - 1 + h;
        int off = -1;
        if (q >= 0 && q < a.H * a.P) {
          const int gy = q / a.P, gx = q - gy * a.P;
          if (gx < a.W) off = gy * a.W + gx;
        }
        s_tab[h] = off;
      }
      __syncthreads();
    }
    const float m = absmax[n], scale = __fmul_rn(m, kC127);
    const float rcp = __frcp_rn(scale);
    const float* xn = x + (size_t)n * a.D * hw * CIN;
    // The dequantize's constants of the thread's channels 8 nt + 2 t + c.
    float sc[G::NT][2], bc[G::NT][2];
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        sc[nt][c] = __fmul_rn(scale, __ldg(w_scale + nt * 8 + 2 * t + c));
        bc[nt][c] = __ldg(bias + nt * 8 + 2 * t + c);
      }
    // Planes z0 - 1 .. z0 + 1, every thread.
    for (int dz = 0; dz < 3; ++dz) {
      unsigned char* dst = ring + ring_slot(z0 - 1 + dz) * a.slot;
      for (int u0 = tid; u0 < units; u0 += kQThreads * kQLoads) {
        float4 v[kQLoads];
        load_batch<CIN>(v, xn, z0 - 1 + dz, u0, kQThreads, units, s_tab, a);
        store_batch<CIN>(v, dst, u0, kQThreads, units, scale, rcp,
                         a.relu_in);
      }
    }
    cp_async_wait<0>();  // the weights (first item)
    __syncthreads();

    for (int z = z0; z < z1; ++z) {
      uint32_t sb[3];
#pragma unroll
      for (int dz = 0; dz < 3; ++dz)
        sb[dz] = ring_s + ring_slot(z - 1 + dz) * a.slot;
      // Plane z + 2 while plane z's pairs run: batch i of the thread's
      // units before the warp's i-th pair, stored after it.
      const bool next = z + 1 < z1;
      unsigned char* nxt = ring + ring_slot(z + 2) * a.slot;
      const size_t plane0 = ((size_t)n * a.D + z) * hw;
      for (int i = 0;; ++i) {
        const int pr = warp + i * kQWarps;
        const int m0 = pr * kQPair;
        const bool pair = pr < pairs && q0 + m0 < plane_pos;
        const int u0 = tid + i * kQThreads * kQLoads;
        const bool batch = next && u0 < units;
        if (!pair && !batch) break;
        float4 v[kQLoads];
        if (batch)
          load_batch<CIN>(v, xn, z + 2, u0, kQThreads, units, s_tab, a);
        if (pair) {
          int acc[2][G::NT][4];
          pair_sums<CIN, COUT>(acc, sb, b_lane, m0, lane, a.P, dz2, off2);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int q = q0 + m0 + 16 * mt + g + 8 * hh;
              const int gy = q / a.P, gx = q - gy * a.P;
              if (gy >= a.H || gx >= a.W) continue;
              const size_t o = (plane0 + (size_t)gy * a.W + gx) * COUT;
#pragma unroll
              for (int nt = 0; nt < G::NT; ++nt) {
                const size_t oc = o + nt * 8 + 2 * t;
                float v0 = __fmaf_rn(__int2float_rn(acc[mt][nt][2 * hh]),
                                     sc[nt][0], bc[nt][0]);
                float v1 = __fmaf_rn(__int2float_rn(acc[mt][nt][2 * hh + 1]),
                                     sc[nt][1], bc[nt][1]);
                if (a.relu_out) {
                  v0 = v0 < 0.f ? 0.f : v0;
                  v1 = v1 < 0.f ? 0.f : v1;
                }
                if (res != nullptr) {
                  const float2 r2 =
                      __ldg(reinterpret_cast<const float2*>(res + oc));
                  v0 = __fadd_rn(v0, r2.x);
                  v1 = __fadd_rn(v1, r2.y);
                }
                *reinterpret_cast<float2*>(y + oc) = make_float2(v0, v1);
              }
            }
        }
        if (batch)
          store_batch<CIN>(v, nxt, u0, kQThreads, units, scale, rcp,
                           a.relu_in);
      }
      __syncthreads();  // plane z + 2 is in; plane z - 1's slot is free
    }
  }
}

// 1^3 layers: one thread per output, its input channels quantized (read by
// float4 with VEC: Cin % 4 == 0, x 16-byte aligned) and summed in int32.
template <bool VEC>
__global__ void qconv1_s8_kernel(const float* __restrict__ x,
                                 const int8_t* __restrict__ wq,
                                 const float* __restrict__ w_scale,
                                 const float* __restrict__ bias,
                                 const float* __restrict__ absmax,
                                 const float* __restrict__ res,
                                 float* __restrict__ y, long long outputs,
                                 long long lane_voxels, int Cin, int Cout,
                                 int relu_in, int relu_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= outputs) return;
  const long long v = i / Cout;
  const int c = (int)(i % Cout);
  const float m = absmax[v / lane_voxels];
  const float scale = __fmul_rn(m, kC127), rcp = __frcp_rn(scale);
  const float* xv = x + v * Cin;
  int acc = 0;
  if constexpr (VEC) {
    for (int ci = 0; ci < Cin; ci += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(xv + ci));
      acc += quantize(f.x, scale, rcp, relu_in) * (int)wq[ci * Cout + c] +
             quantize(f.y, scale, rcp, relu_in) * (int)wq[(ci + 1) * Cout + c] +
             quantize(f.z, scale, rcp, relu_in) * (int)wq[(ci + 2) * Cout + c] +
             quantize(f.w, scale, rcp, relu_in) * (int)wq[(ci + 3) * Cout + c];
    }
  } else {
    for (int ci = 0; ci < Cin; ++ci)
      acc += quantize(xv[ci], scale, rcp, relu_in) * (int)wq[ci * Cout + c];
  }
  y[i] = dequantize(acc, m, scale, w_scale, bias, c, Cout, relu_out, res, i);
}

// The plans of each shape on each device, found once, not each call (the
// serial int8 path launches K19 ~55,000 times a run).
struct QPlanKey {
  int dev, N, D, H, W, cin, cout;
};
constexpr int kQPlans = 64;
std::mutex q_mutex;
QPlanKey q_keys[kQPlans];
QPlan q_plans[kQPlans];
int q_n = 0, q_next = 0;
int q_sms[16];
bool q_attr[16][4];  // each kernel's shared-memory limit set, by device

inline cudaError_t q_plan_of(int N, int D, int H, int W, int cin, int cout,
                             QPlan* p) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(q_mutex);
  for (int i = 0; i < q_n; ++i) {
    const QPlanKey& k = q_keys[i];
    if (k.dev == dev && k.N == N && k.D == D && k.H == H && k.W == W &&
        k.cin == cin && k.cout == cout) {
      *p = q_plans[i];
      return cudaSuccess;
    }
  }
  int sms = dev < 16 ? q_sms[dev] : 0;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < 16) q_sms[dev] = sms;
  }
  if (!q_plan(N, D, H, W, cin, cout, sms, p)) return cudaErrorInvalidValue;
  const int at = q_n < kQPlans ? q_n++ : (q_next++ % kQPlans);
  q_keys[at] = QPlanKey{dev, N, D, H, W, cin, cout};
  q_plans[at] = *p;
  return cudaSuccess;
}

template <int CIN, int COUT>
cudaError_t launch_tc(const float* x, const int8_t* w, const float* w_scale,
                      const float* bias, const float* absmax,
                      const float* res, float* y, int N, int D, int H, int W,
                      int relu_in, int relu_out, int which, cudaStream_t s) {
  auto kernel = qconv3d_s8_kernel<CIN, COUT>;
  QPlan p;
  cudaError_t err = q_plan_of(N, D, H, W, CIN, COUT, &p);
  if (err != cudaSuccess) return err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(q_mutex);
    if (dev >= 16 || !q_attr[dev][which]) {
      // Every plan fits a CTA's whole share.
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (err != cudaSuccess) return err;
      if (dev < 16) q_attr[dev][which] = true;
    }
  }
  const QArgs a{D, H, W, p.P, p.M, p.R, p.L, p.nb, p.nseg,
                q_slot_bytes(p.R, CIN), relu_in, relu_out, p.items};
  kernel<<<(unsigned)(p.items < p.ctas ? p.items : p.ctas), kQThreads,
           p.smem, s>>>(x, w, w_scale, bias, absmax, res, y, a);
  return cudaGetLastError();
}

// K20: blocks of 256 threads, 4 float4 loads in flight a thread.
constexpr int kAbsThreads = 256;
constexpr int kAbsLoads = 4;

// Blocks a lane: one pass of 4 float4s a thread covers the lane, at most
// about two waves of 8 blocks an SM over all N lanes (ops/quantized.py's
// k20_blocks mirrors it).
inline int absmax_blocks(long long per_lane, int N, int sms) {
  const long long pass = 4LL * kAbsThreads * kAbsLoads;
  const long long want = (per_lane + pass - 1) / pass;
  const long long cap = (2LL * sms * (2048 / kAbsThreads) + N - 1) / N;
  const long long b = want < cap ? want : cap;
  return (int)(b < 1 ? 1 : b);
}

__device__ __forceinline__ float magnitude(float v, int relu) {
  return relu ? (v > 0.f ? v : 0.f) : fabsf(v);  // never -0
}

__device__ __forceinline__ float magnitude4(float4 v, int relu) {
  return fmaxf(fmaxf(magnitude(v.x, relu), magnitude(v.y, relu)),
               fmaxf(magnitude(v.z, relu), magnitude(v.w, relu)));
}

// Block b of lane n = blockIdx.x / blocks; work[n] the lane's running
// max's bits, work[N + n] its finished blocks, both zero between calls.
__global__ void __launch_bounds__(kAbsThreads)
act_absmax_kernel(const float* __restrict__ x, int relu,
                  unsigned* __restrict__ work, float* __restrict__ absmax,
                  int N, long long per_lane, int blocks) {
  __shared__ float warp_max[kAbsThreads / 32];
  const int n = blockIdx.x / blocks, blk = blockIdx.x % blocks;
  const float* p = x + (size_t)n * per_lane;
  // head floats before the lane's first 16-byte boundary, nb float4s, then
  // tail floats.
  const long long to16 = ((16 - (reinterpret_cast<size_t>(p) & 15)) & 15) / 4;
  const int head = (int)(to16 < per_lane ? to16 : per_lane);
  const long long nb = (per_lane - head) / 4;
  const int tail = (int)(per_lane - head - 4 * nb);
  const float4* body = reinterpret_cast<const float4*>(p + head);
  const long long stride = (long long)blocks * kAbsThreads;
  long long i = (long long)blk * kAbsThreads + threadIdx.x;
  float mx = 0.f;  // +0: every magnitude is >= +0, never -0
  for (; i + (kAbsLoads - 1) * stride < nb; i += kAbsLoads * stride) {
    float4 v[kAbsLoads];
#pragma unroll
    for (int u = 0; u < kAbsLoads; ++u) v[u] = __ldg(body + i + u * stride);
#pragma unroll
    for (int u = 0; u < kAbsLoads; ++u) mx = fmaxf(mx, magnitude4(v[u], relu));
  }
  for (; i < nb; i += stride) mx = fmaxf(mx, magnitude4(__ldg(body + i), relu));
  if (blk == 0 && (int)threadIdx.x < head)
    mx = fmaxf(mx, magnitude(__ldg(p + threadIdx.x), relu));
  if (blk == 0 && (int)threadIdx.x < tail)
    mx = fmaxf(mx, magnitude(__ldg(p + head + 4 * nb + threadIdx.x), relu));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kAbsThreads / 32; ++w) mx = fmaxf(mx, warp_max[w]);
  atomicMax(&work[n], __float_as_uint(mx));
  __threadfence();
  if (atomicAdd(&work[N + n], 1u) == (unsigned)blocks - 1) {
    // Every block of the lane has folded its maximum in: read it, then
    // leave both counters zero for the next call.
    __threadfence();
    const float a = __uint_as_float(atomicExch(&work[n], 0u));
    atomicExch(&work[N + n], 0u);
    absmax[n] = fmaxf(a, kFloor);
  }
}

}  // namespace

// x (N,D,H,W,Cin) float32; w: k = 3, the layer's packed weights
// (QuantizedConv.w_k: [Cout][KPAD + 16] int8, row co holding w_q[:, co] in
// (tap, channel) order, zero past 27 Cin), k = 1, w_q (Cin, Cout) int8;
// w_scale, bias (Cout) and absmax (N) float32; res (N,D,H,W,Cout) float32 or
// null; y (N,D,H,W,Cout) float32. All contiguous, x 16-byte aligned (8 at
// Cin 2), res and y 8-byte; k = 3 takes (Cin, Cout) in {(2,32), (32,32),
// (2,16), (16,16)}, k = 1 any widths.
extern "C" int ffn_qconv3d_s8(const float* x, const int8_t* w,
                              const float* w_scale, const float* bias,
                              const float* absmax, const float* res, float* y,
                              int N, int D, int H, int W, int Cin, int Cout,
                              int k, int relu_in, int relu_out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1) {
    const long long outputs = (long long)N * D * H * W * Cout;
    if (outputs == 0) return static_cast<int>(cudaSuccess);
    const int threads = 256;
    const unsigned blocks = (unsigned)((outputs + threads - 1) / threads);
    const bool vec = Cin % 4 == 0 && (reinterpret_cast<size_t>(x) & 15) == 0;
    if (vec)
      qconv1_s8_kernel<true><<<blocks, threads, 0, s>>>(
          x, w, w_scale, bias, absmax, res, y, outputs, (long long)D * H * W,
          Cin, Cout, relu_in, relu_out);
    else
      qconv1_s8_kernel<false><<<blocks, threads, 0, s>>>(
          x, w, w_scale, bias, absmax, res, y, outputs, (long long)D * H * W,
          Cin, Cout, relu_in, relu_out);
    return static_cast<int>(cudaGetLastError());
  }
  if (k != 3) return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)N * D * H * W == 0) return static_cast<int>(cudaSuccess);
#define FFN_K19_CASE(CI, CO, WHICH)                                          \
  if (Cin == CI && Cout == CO)                                               \
    return static_cast<int>(launch_tc<CI, CO>(x, w, w_scale, bias, absmax,   \
                                              res, y, N, D, H, W, relu_in,   \
                                              relu_out, WHICH, s));
  FFN_K19_CASE(2, 32, 0)
  FFN_K19_CASE(32, 32, 1)
  FFN_K19_CASE(2, 16, 2)
  FFN_K19_CASE(16, 16, 3)
#undef FFN_K19_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// x (N, per_lane) float32, contiguous; work (2N) int32, zero before the
// first call and left zero by each; absmax (N) float32: max(max|relu?(x[n])|,
// 1e-12). Calls that share `work` must not overlap: one stream.
extern "C" int ffn_act_absmax(const float* x, int relu, unsigned* work,
                              float* absmax, int N, long long per_lane,
                              void* stream) {
  if (N == 0) return static_cast<int>(cudaSuccess);
  static int sms_of[16];  // each device's SMs, found once
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 16 && sms_of[dev] > 0) {
    sms = sms_of[dev];
  } else {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 16) sms_of[dev] = sms;
  }
  const int blocks = absmax_blocks(per_lane, N, sms);
  act_absmax_kernel<<<(unsigned)((long long)blocks * N), kAbsThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, relu, work, absmax, N, per_lane, blocks);
  return static_cast<int>(cudaGetLastError());
}
