// K15: conv3d_ndhwc_bf16 and conv3d_ndhwc_f16 -- SAME-padded 3D convolution,
// channels-last, 16-bit inputs and weights (one body templated on the type
// r, bfloat16 or float16) on the tensor cores, float32 sums rounded as the
// exact sum would round. Replaces the nn.Conv layers of ffn_tpu/models/
// convstack_3d.py (:48-75) with dtype=bfloat16 (the benches' default) or
// float16 (--precision f16), copying flax: acc = sum r(x) r(w) in float32,
// y = r(r(acc) + bias), then relu (post_relu) and a residual: 16-bit,
// y = r(y + res); float32 (conv_lom's seed), out = float32(y) + res. r
// rounds to nearest even (float16 overflows to inf, as XLA's convert);
// float32 inputs (conv0_a) round as staged, pre_relu applies as read.
//
// Which float32 sum: flax leaves the order to XLA, and two orders round
// ~2e-5 of a layer's sums to neighbouring bfloat16 values, which through 12
// layers decide moves. So K15 gives r(f32(S)) for the exact S: each k16
// step of the implicit GEMM is summed by the tensor core from zero, a tap
// row's (dz, dy) 3 Cin / 16 steps are added in float32 and the nine row
// sums are added to acc in order (Cin = 2: its four steps in order); a
// second MMA on the fragments with signs cleared sums |x||w| (mag), and
// |acc - S| <= 2^-ERR_BITS mag with ERR_BITS = 21, measured, not proven
// (largest of 5.0e8 outputs 2^-21.59 in bfloat16, 2^-21.62 in float16:
// tools_torch/k15_variants.py; the products are exact in both types).
// Where r(acc - e) and r(acc + e) agree (e the bound plus two float32 ulps)
// r(acc) is exact; the other outputs are flagged (0.37% of the
// calibration's bfloat16 outputs, 1.7% of its float16 ones; more in random
// layers: PERF.md) and summed in float64 from float32 products (exact in
// float16; in bfloat16 while mag is in [2^-74, 2^110], else multiplied in
// float64): exact when the products' magnitudes span at most 2^28
// (bfloat16) or 2^22 (float16), else off by less than 2^-43 mag.
//
// Bound on the H100: a 3^3 32->32 layer is 1.99 GFLOP a 33^3 sample and
// 4.6-6.9 MB: 2.0 us at 989 TFLOP/s against 1.4-2.1 us at 3.35 TB/s. The
// mag MMAs double the tensor-core work; a flagged output's 864 float32 to
// float64 conversions take 54 clocks of an SM's 16 a clock.
//
// Design (tools_torch/k15_variants.py times the options):
// - A tile is kTileRows voxels at consecutive positions q = y * P + x of one
//   z-plane of one sample, P = W + 1: a zero column after each row stands
//   for SAME padding on both sides, so a tap is one fixed row offset and a
//   33^3 sample is 33 * 9 tiles of 128 (5.8% padded slots; an 8x4x4 box
//   wasted 44%). The tile's halo is three planes of R = kTileRows + 2P + 2
//   rows, zero outside the volume, staged by cp.async (zero-filled). The
//   tiles, their staging and the tap-row sums are conv16.cuh's, shared
//   with K17.
// - Persistent CTAs of 8 warps, two an SM at 33^3 (one stage each: the
//   other CTA's MMAs run while one loads its next tile or sums in float64;
//   one CTA with a ring of two stages, or 4 warps of two m16 tiles, lost),
//   stage the weights once as [co][k] (k = tap * Cin + ci, rows padded
//   against bank conflicts: ldmatrix B fragments and contiguous float64
//   reads) and walk tiles b, b + grid, ...
// - Warp w owns tile rows [16 w, 16 w + 16) and every output channel:
//   mma.sync m16n8k16, A and B by ldmatrix (Cin = 2 packs 8 taps in a k16
//   step and reads A as 32-bit words).
// - Flagged outputs queue in shared memory in the order warp, lane, bit;
//   after the tile's MMAs the CTA sums them in rounds, each output on L
//   lanes (L = 1, 2, 4 or 8: the most that leaves no output of the queue's
//   rest for a later round; lanes split the nine (dz, dy) rows of taps,
//   then a butterfly), an order the tile's own inputs decide.
// An output depends on its tile's inputs only (the tile list and the grid
// never enter a sum), so a sample's result does not depend on N, and
// repeats bit for bit. ops/conv3d.py's k15_geometry mirrors the host-side
// geometry. 1^3 layers (conv_lom) are a float64 dot product per output on
// the CUDA cores.
//
// Measurement variants (never defined by the library;
// tools_torch/k15_variants.py): FFN_K15_RAW_SUM outputs the unrounded
// float32 sum in K15's order, FFN_K15_IN_MMA accumulates each tap row in
// the tensor core, FFN_K15_ERR_BITS sets the bound, FFN_K15_NO_EXACT
// stores flagged outputs from acc (the flags, no float64 sums),
// FFN_K15_UNCORRECTED also drops the flags and the |x||w| MMAs.

#include "conv16.cuh"

#ifndef FFN_K15_ERR_BITS
#define FFN_K15_ERR_BITS 21
#endif
#if defined(FFN_K15_RAW_SUM) && !defined(FFN_K15_UNCORRECTED)
#define FFN_K15_UNCORRECTED
#endif

namespace {

// A CTA's shared memory: weights, the stage, the queue, the warps' counts
// of it and the bias in float32.
template <int CIN, int COUT>
inline size_t k15_smem(int R) {
  using G = K15Geo<CIN, COUT>;
  return (size_t)G::W_BYTES + stage_bytes<CIN, COUT>(R) + G::QUEUE_BYTES +
         kTileWarps * 4 + COUT * 4;
}

// The conv's float32 sum to its 16-bit output before the residual:
// r(r(acc) + bias), then relu (post_relu).
template <typename T>
__device__ __forceinline__ float finish(float acc, float b, int post_relu) {
#if defined(FFN_K15_RAW_SUM)
  return acc;
#else
  float v = round16<T>(round16<T>(acc) + b);
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

// Stores channels co, co + 1 (co even) of y at index i (of co) with the
// residual's sums, as store_y does each.
template <typename T>
__device__ __forceinline__ void store_y2(void* y, const void* res,
                                         int out_f32, size_t i, float v0,
                                         float v1) {
  if (out_f32) {
    if (res != nullptr) {
      const float2 r = *reinterpret_cast<const float2*>(
          static_cast<const float*>(res) + i);
      v0 += r.x;
      v1 += r.y;
    }
    *reinterpret_cast<float2*>(static_cast<float*>(y) + i) =
        make_float2(v0, v1);
    return;
  }
  if (res != nullptr) {
    float r0, r1;
    unpack16<T>(*reinterpret_cast<const uint32_t*>(
                    static_cast<const T*>(res) + i), r0, r1);
    v0 += r0;
    v1 += r1;
  }
  *reinterpret_cast<uint32_t*>(static_cast<T*>(y) + i) = pack16<T>(v0, v1);
}

#if !defined(FFN_K15_UNCORRECTED) && !defined(FFN_K15_NO_EXACT)
template <typename T, int V>
__device__ __forceinline__ void load_v(const T* p, float (&f)[V]) {
  if constexpr (V == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    unpack16<T>(u.x, f[0], f[1]);
    unpack16<T>(u.y, f[2], f[3]);
    unpack16<T>(u.z, f[4], f[5]);
    unpack16<T>(u.w, f[6], f[7]);
  } else {
    unpack16<T>(*reinterpret_cast<const uint32_t*>(p), f[0], f[1]);
  }
}

// Lane sub's part of the exact sum of output channel `co` at tile row r
// (exact_sum): tap rows zy = sub, sub + L, ... of nine (dz, dy), K in
// order into four partial sums (k mod 4). Products in float32 (exact)
// added in float64, or with F64 multiplied in float64.
template <typename T, int CIN, int COUT, bool F64>
__device__ __forceinline__ void add_products(const T* st, const T* s_w,
                                             int r, int co, int P, int R,
                                             int pre_relu, int sub, int L,
                                             double (&part)[4]) {
  using G = K15Geo<CIN, COUT>;
  constexpr int V = CIN < 8 ? CIN : 8;  // channels a load
  const T* xr = st + r * G::CS;
  const T* wr = s_w + co * G::WK;
#pragma unroll 1
  for (int zy = sub; zy < 9; zy += L) {
    const int dz = zy / 3, dy = zy - 3 * dz;
    const T* xz = xr + (dz * R + dy * P) * G::CS;
    const T* wz = wr + zy * 3 * CIN;
#pragma unroll
    for (int c = 0; c < 3 * CIN; c += V) {  // c = dx CIN + ci
      float xv[V], wv[V];
      load_v<T, V>(xz + (c / CIN) * G::CS + c % CIN, xv);
      load_v<T, V>(wz + c, wv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xj = pre_relu ? fmaxf(xv[j], 0.f) : xv[j];
        double& acc = part[(c + j) % 4];
        if constexpr (F64)
          acc = fma((double)xj, (double)wv[j], acc);
        else
          acc += (double)(xj * wv[j]);
      }
    }
  }
}

// The exact sum of output channel `co` at tile row r in float64 from the
// staged tile and weights, by the L lanes sub = 0..L-1 of an aligned group
// (every lane of the warp calls it; lanes not `live` add nothing): each
// lane's add_products, its partial sums added in one fixed order, then a
// butterfly. With f64 (bfloat16 products that may leave float32's exact
// range) the products are taken in float64.
template <typename T, int CIN, int COUT>
__device__ __forceinline__ double exact_sum(const T* st, const T* s_w, int r,
                                            int co, int P, int R,
                                            int pre_relu, int sub, int L,
                                            bool live, bool f64) {
  double part[4] = {0.0, 0.0, 0.0, 0.0};
  if (live) {
    if (!kIsHalf<T> && f64)
      add_products<T, CIN, COUT, true>(st, s_w, r, co, P, R, pre_relu, sub,
                                       L, part);
    else
      add_products<T, CIN, COUT, false>(st, s_w, r, co, P, R, pre_relu, sub,
                                        L, part);
  }
  double sum = (part[0] + part[1]) + (part[2] + part[3]);
  for (int o = 1; o < L; o <<= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  return sum;
}
#endif

template <typename T, int CIN, int COUT>
__global__ void __launch_bounds__(kTileThreads, 2)
conv3d_16_tc_kernel(const void* __restrict__ x, int x_f32,
                    const T* __restrict__ wt, const T* __restrict__ bias,
                    const void* __restrict__ res, void* __restrict__ y,
                    int D, int H, int W, int P, int R, int per_plane,
                    long long tiles, int pre_relu, int post_relu,
                    int out_f32) {
  using G = K15Geo<CIN, COUT>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* s_w = reinterpret_cast<T*>(smem);             // [COUT][WK]
  T* st = reinterpret_cast<T*>(smem + G::W_BYTES);  // [3][R][CS]
  unsigned short* queue = reinterpret_cast<unsigned short*>(
      smem + G::W_BYTES + stage_bytes<CIN, COUT>(R));
  int* w_count = reinterpret_cast<int*>(  // flagged outputs a warp
      reinterpret_cast<unsigned char*>(queue) + G::QUEUE_BYTES);
  float* s_bias = reinterpret_cast<float*>(w_count + kTileWarps);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // Weights: row co holds k = tap * Cin + ci of the DHWIO tensor, k past K
  // zero.
  for (int i = tid; i < G::KPAD * (COUT / 8); i += kTileThreads) {
    const int k = i / (COUT / 8), c = (i - k * (COUT / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k < G::K)
      v = *reinterpret_cast<const uint4*>(wt + (size_t)k * COUT + c);
    const T* h = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) s_w[(c + j) * G::WK + k] = h[j];
  }
  if (tid < COUT) s_bias[tid] = to_f<T>(bias[tid]);
  float bias2[G::NT][2];  // the bias of the thread's channels nt 8 + 2t + c
#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      bias2[nt][c] = to_f<T>(bias[nt * 8 + 2 * t + c]);
  long long tile = blockIdx.x;
  stage_tile<T, CIN, COUT>(st, x, x_f32, tile_at(tile, D, per_plane), D, H,
                           W, P, R);
  cp_async_commit();

  for (; tile < tiles; tile += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();
    const Tile tl = tile_at(tile, D, per_plane);
    const size_t plane0 = ((size_t)tl.n * D + tl.z) * H * W;

    float acc[G::NT][4], mag[G::NT][4];  // mag: sum of |x| |w|
#ifdef FFN_K15_UNCORRECTED
    tile_sums<T, CIN, COUT, false>(st, s_w, warp, lane, P, R, pre_relu, acc,
                                   mag);
#else
    tile_sums<T, CIN, COUT, true>(st, s_w, warp, lane, P, R, pre_relu, acc,
                                  mag);
#endif

    // Where acc's error bound straddles a point at which r(f32(.)) changes,
    // the output goes to the queue (bit nt 4 + j of `exact`; of `wide`
    // where its products are summed in float64); the others are stored
    // now, channel pairs together. Rows past the plane or in the zero
    // column compute nothing.
    uint32_t exact = 0, wide = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tl.q0 + warp * 16 + g + 8 * h;
      const int gy = q / P, gx = q - gy * P;
      if (gy >= H || gx >= W) continue;
      const size_t v0 = plane0 + (size_t)gy * W + gx;
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        float v[2];
        uint32_t flag = 0;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float a = acc[nt][2 * h + c];
          v[c] = finish<T>(a, bias2[nt][c], post_relu);
#ifndef FFN_K15_UNCORRECTED
          constexpr float kErr = 1.0f / (float)(1u << FFN_K15_ERR_BITS);
          const float e = fmaf(mag[nt][2 * h + c], kErr, fabsf(a) * 0x1p-22f);
          if (bits16<T>(a - e) != bits16<T>(a + e)) {
            flag |= 1u << c;
            // A bfloat16 product is exact in float32 while in [2^-126,
            // 2^127]: so while mag is in [2^-74, 2^110] and the products
            // span at most 2^28 (and otherwise it loses less than 2^-149).
            if (!kIsHalf<T> && !(mag[nt][2 * h + c] >= 0x1p-74f &&
                                 mag[nt][2 * h + c] <= 0x1p110f))
              wide |= 1u << (nt * 4 + 2 * h + c);
          }
#endif
        }
        const size_t o = v0 * COUT + nt * 8 + 2 * t;
        if (flag == 0) {
          store_y2<T>(y, res, out_f32, o, v[0], v[1]);
          continue;
        }
        exact |= flag << (nt * 4 + 2 * h);
#ifdef FFN_K15_NO_EXACT
        flag = 0;  // flagged outputs stored as they are, one by one
#endif
        if (!(flag & 1)) store_y<T>(y, res, out_f32, o, v[0]);
        if (!(flag & 2)) store_y<T>(y, res, out_f32, o + 1, v[1]);
      }
    }

#if !defined(FFN_K15_UNCORRECTED) && !defined(FFN_K15_NO_EXACT)
    // Queue the flagged outputs as row * COUT + co, bit 15 set where
    // `wide`: warp w's from w * 16 COUT on, in the order lane, bit (a
    // prefix of the lanes' counts); the queue runs warp by warp.
    const int cnt = __popc(exact);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) w_count[warp] = incl;
    int at = warp * 16 * COUT + incl - cnt;
    for (uint32_t m = exact; m; m &= m - 1) {
      const int b = __ffs(m) - 1, nt = b / 4, j = b % 4;
      const int row = warp * 16 + g + 8 * (j >> 1);
      queue[at++] = (unsigned short)(row * COUT + nt * 8 + 2 * t + (j & 1) +
                                     (((wide >> b) & 1) << 15));
    }
    __syncthreads();
    int nq = 0;
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) nq += w_count[w];
    // The CTA sums the queue in rounds, each output on L lanes: a round
    // takes the most lanes, up to 8, that leave no output of the rest for
    // a later round (the queue's order, so L, is the tile's own).
    for (int e0 = 0; e0 < nq;) {
      int L = 1;
      while (L < 8 && (nq - e0) * 2 * L <= kTileThreads) L *= 2;
      const int e = e0 + tid / L, sub = tid % L;
      const bool live = e < nq;
      int ent = 0;
      if (live) {  // the e-th entry, warp by warp
        int w = 0, i = e;
        while (i >= w_count[w]) i -= w_count[w++];
        ent = queue[w * 16 * COUT + i];
      }
      const int row = (ent & 0x7fff) / COUT, co = (ent & 0x7fff) - row * COUT;
      const double sum = exact_sum<T, CIN, COUT>(
          st, s_w, row, co, P, R, pre_relu, sub, L, live, ent >> 15);
      if (live && sub == 0) {
        const int q = tl.q0 + row, gy = q / P, gx = q - gy * P;
        store_y<T>(y, res, out_f32,
                   (plane0 + (size_t)gy * W + gx) * COUT + co,
                   finish<T>((float)sum, s_bias[co], post_relu));
      }
      e0 += kTileThreads / L;
    }
#endif
    __syncthreads();  // the stage, the queue and the counts are free
    if (tile + gridDim.x < tiles) {
      stage_tile<T, CIN, COUT>(st, x, x_f32,
                               tile_at(tile + gridDim.x, D, per_plane), D, H,
                               W, P, R);
      cp_async_commit();
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
             finish<T>((float)acc, to_f<T>(bias[co]), post_relu));
}

// The host side of the geometry (ops/conv3d.py's k15_geometry mirrors it):
// pitch P, halo rows R, tiles a plane; the grid is the SMs times the CTAs
// an SM that shared memory and registers allow.
template <typename T, int CIN, int COUT>
cudaError_t launch_tc(const void* x, int x_f32, const T* w, const T* bias,
                      const void* res, void* y, int N, int D, int H, int W,
                      int pre_relu, int post_relu, int out_f32,
                      cudaStream_t s) {
  auto kernel = conv3d_16_tc_kernel<T, CIN, COUT>;
  const int P = W + 1, R = kTileRows + 2 * P + 2;
  const int per_plane = (H * P - 1 + kTileRows - 1) / kTileRows;
  const long long tiles = (long long)N * D * per_plane;
  const size_t smem = k15_smem<CIN, COUT>(R);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  if (tiles == 0) return cudaSuccess;
  unsigned grid = 0;
  const cudaError_t err =
      persistent_grid(kernel, kTileThreads, smem, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTileThreads, smem, s>>>(x, x_f32, w, bias, res, y, D, H,
                                          W, P, R, per_plane, tiles,
                                          pre_relu, post_relu, out_f32);
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
// {(2,32), (32,32), (2,16), (16,16)} with x 16-byte aligned and rows whose
// halo fits in shared memory (k15_geometry), k = 1 any widths. The _bf16
// entry runs bfloat16 layers, the _f16 one float16.
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
