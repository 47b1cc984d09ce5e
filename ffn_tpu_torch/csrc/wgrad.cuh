// K10 conv3d_wgrad_f32 (conv3d_bwd.cu) and K18's 1^3 layers,
// conv3d_wgrad1_16 (conv3d_bwd16.cu; its 3^3 layers run on the tensor
// cores there): the weight and bias gradients of a layer, one body
// templated on its type T (float, bfloat16 or float16; 3^3 in float only),
// deterministic with no float atomics. Stage 1: a CTA takes one tap (or
// the bias) and a chunk of rows (n, z, y) of the output; each thread owns
// a 4 (ci) x 4 (co) register tile and a strided share of the chunk's x
// positions (a position costs two 4-channel loads for 16 FMAs), the CTA's
// thread groups summed in shared memory in a fixed order; stage 2 sums the
// chunks' partials in chunk order and rounds to T. Inputs of type T, or
// float32 ones rounded to T as they load (the f32 flags).

#pragma once

#include "conv16.cuh"

namespace {

template <typename T>
constexpr int kF32 = std::is_same<T, float>::value;

// A 16-bit value, or a float32 one rounded to T (dy of conv_lom, x of
// conv0_a).
template <typename T>
__device__ __forceinline__ float load16(const void* p, int f32, size_t i) {
  return f32 ? round16<T>(static_cast<const float*>(p)[i])
             : to_f<T>(static_cast<const T*>(p)[i]);
}

constexpr int kWThreads = 256;
constexpr int kTile = 4;  // a thread's ci x co register tile is 4 x 4

// Four consecutive channels c.. of the row at element `row` (zero past C);
// `vec`: one 16- or 8-byte load (C % 4 == 0, the tensor aligned).
template <typename T>
__device__ __forceinline__ void load4(const void* p, int f32, size_t row,
                                      int c, int C, bool vec,
                                      float out[kTile]) {
  if (vec && f32) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        static_cast<const float*>(p) + row + c));
    out[0] = round16<T>(v.x); out[1] = round16<T>(v.y);
    out[2] = round16<T>(v.z); out[3] = round16<T>(v.w);
  } else if (vec) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const T*>(p) + row + c));
    unpack16<T>(v.x, out[0], out[1]);
    unpack16<T>(v.y, out[2], out[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kTile; ++i)
      out[i] = c + i < C ? load16<T>(p, f32, row + c + i) : 0.f;
  }
}

__device__ __forceinline__ bool vec4(const void* p, int f32, int C) {
  return p != nullptr && C % kTile == 0 &&
         (reinterpret_cast<size_t>(p) & (f32 ? 15 : 7)) == 0;
}

// Stage 1. blockIdx.x: chunk of `rows` output rows (n, z, y); blockIdx.y:
// tap in [0, KK) or KK for the bias. partial[chunk][KK*Cin*Cout + Cout].
// XF, GF: x, dy are float32 (rounded to T as they load).
template <typename T, int K, int XF, int GF>
__global__ void __launch_bounds__(kWThreads)
wgrad_partial_kernel(const void* __restrict__ x, const void* __restrict__ dy,
                     const T* __restrict__ ym, float* __restrict__ partial,
                     int N, int D, int H, int W, int Cin, int Cout,
                     int pre_relu, int rows) {
  constexpr int x_f32 = XF, dy_f32 = GF;
  constexpr int P = K / 2;
  constexpr int KK = K * K * K;
  __shared__ float s_red[kWThreads][kTile * kTile];
  const int tid = threadIdx.x, chunk = blockIdx.x, tap = blockIdx.y;
  const int r0 = chunk * rows, r1 = min(r0 + rows, N * D * H);
  float* out = partial + (size_t)chunk * ((size_t)KK * Cin * Cout + Cout);

  if (tap == KK) {  // the bias: db[co] = sum g
    const int groups = kWThreads / Cout;
    const int co = tid % Cout, grp = tid / Cout;
    float acc = 0.f;
    if (grp < groups) {
      for (int r = r0; r < r1; ++r)
        for (int xx = grp; xx < W; xx += groups) {
          const size_t at = ((size_t)r * W + xx) * Cout + co;
          float g = load16<T>(dy, dy_f32, at);
          if (ym != nullptr && !(to_f<T>(ym[at]) > 0.f)) g = 0.f;
          acc += g;
        }
    }
    s_red[tid][0] = acc;
    __syncthreads();
    if (grp == 0) {
      float s = 0.f;
      for (int j = 0; j < groups; ++j) s += s_red[j * Cout + co][0];
      out[(size_t)KK * Cin * Cout + co] = s;
    }
    return;
  }

  const int dz = tap / (K * K) - P, dyy = (tap / K) % K - P, dxx = tap % K - P;
  const int tco = (Cout + kTile - 1) / kTile;
  const int tiles = ((Cin + kTile - 1) / kTile) * tco;
  const int groups = kWThreads / tiles;
  const int tile = tid % tiles, grp = tid / tiles;
  const int c_in = (tile / tco) * kTile, c_out = (tile % tco) * kTile;
  const bool vx = vec4(x, x_f32, Cin), vg = vec4(dy, dy_f32, Cout),
             vy = vec4(ym, kF32<T>, Cout);
  float acc[kTile][kTile] = {};
  if (grp < groups) {
    for (int r = r0; r < r1; ++r) {
      const int yy = r % H, z = (r / H) % D, n = r / (H * D);
      const int sz = z + dz, sy = yy + dyy;
      if (sz < 0 || sz >= D || sy < 0 || sy >= H) continue;
      const size_t xrow = (((size_t)n * D + sz) * H + sy) * W;
      const size_t grow = (size_t)r * W;
      for (int xx = grp; xx < W; xx += groups) {
        const int sx = xx + dxx;
        if (sx < 0 || sx >= W) continue;
        float xv[kTile], gv[kTile];
        load4<T>(x, x_f32, (xrow + sx) * Cin, c_in, Cin, vx, xv);
        load4<T>(dy, dy_f32, (grow + xx) * Cout, c_out, Cout, vg, gv);
        if (ym != nullptr) {
          float yv[kTile];
          load4<T>(ym, kF32<T>, (grow + xx) * Cout, c_out, Cout, vy, yv);
#pragma unroll
          for (int j = 0; j < kTile; ++j)
            if (!(yv[j] > 0.f)) gv[j] = 0.f;
        }
        if (pre_relu) {
#pragma unroll
          for (int i = 0; i < kTile; ++i) xv[i] = fmaxf(xv[i], 0.f);
        }
#pragma unroll
        for (int i = 0; i < kTile; ++i)
#pragma unroll
          for (int j = 0; j < kTile; ++j) acc[i][j] = fmaf(xv[i], gv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) s_red[tid][i * kTile + j] = acc[i][j];
  __syncthreads();
  if (grp != 0) return;
  for (int i = 0; i < kTile && c_in + i < Cin; ++i)
    for (int j = 0; j < kTile && c_out + j < Cout; ++j) {
      float s = 0.f;
      for (int q = 0; q < groups; ++q) s += s_red[q * tiles + tile][i * kTile + j];
      out[((size_t)tap * Cin + c_in + i) * Cout + c_out + j] = s;
    }
}

// Stage 2: out[j] = f32(r(sum over chunks of partial[chunk][j])), in chunk
// order (r the identity for float).
template <typename T>
__global__ void wgrad_sum_kernel(const float* __restrict__ partial,
                                   float* __restrict__ dw,
                                   float* __restrict__ db, int chunks, int nw,
                                   int nb) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int per_chunk = nw + nb;
  if (j >= per_chunk) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[(size_t)c * per_chunk + j];
  s = round16<T>(s);
  if (j < nw) dw[j] = s;
  else db[j - nw] = s;
}

template <typename T>
int wgrad_launch(const void* x, int x_f32, const void* dy, int dy_f32,
                 const void* ym, float* partial, float* dw, float* db, int N,
                 int D, int H, int W, int Cin, int Cout, int k, int pre_relu,
                 int rows, cudaStream_t s) {
  const int tiles = ((Cin + kTile - 1) / kTile) * ((Cout + kTile - 1) / kTile);
  if (tiles > kWThreads || Cout > kWThreads || rows < 1 || (k != 1 && k != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (N * D * H + rows - 1) / rows, kk = k * k * k;
  const dim3 grid(chunks, kk + 1);
  const T* yt = static_cast<const T*>(ym);
#define FFN_WGRAD(KS, XF, GF)                                            \
  wgrad_partial_kernel<T, KS, XF, GF><<<grid, kWThreads, 0, s>>>(        \
      x, dy, yt, partial, N, D, H, W, Cin, Cout, pre_relu, rows)
#define FFN_WGRAD_K(KS)                                                   \
  if constexpr (kF32<T>) FFN_WGRAD(KS, 1, 1);                             \
  else if (x_f32 && dy_f32) FFN_WGRAD(KS, 1, 1);                          \
  else if (x_f32) FFN_WGRAD(KS, 1, 0);                                    \
  else if (dy_f32) FFN_WGRAD(KS, 0, 1);                                   \
  else FFN_WGRAD(KS, 0, 0);
  if (k == 3) {
    if constexpr (kF32<T>) FFN_WGRAD(3, 1, 1);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else {
    FFN_WGRAD_K(1)
  }
#undef FFN_WGRAD_K
#undef FFN_WGRAD
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nw = kk * Cin * Cout, total = nw + Cout;
  wgrad_sum_kernel<T><<<(total + 255) / 256, 256, 0, s>>>(
      partial, dw, db, chunks, nw, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
