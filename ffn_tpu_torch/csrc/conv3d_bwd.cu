// K9 conv3d_dgrad_f32 and K10 conv3d_wgrad_f32: the input and the weight
// (and bias) gradients of one K1 layer, float32, channels-last.
//
// Replaces: XLA's backward of the nn.Conv layers of
// ffn_tpu/models/convstack_3d.py:48-75 inside `jax.value_and_grad` of the
// scan train step (ffn_tpu/training/train_lib.py:368). The forward layer is
//   y = [relu]( conv(relu?(x), W) + b ) [+ residual]
// and, with g = dy * [y > 0 if post_relu] (the model never combines
// post_relu with a residual, so y > 0 is read from the saved output),
//   K9:  dx[u, ci] = [x > 0 if pre_relu] * sum_tap sum_co W[tap, ci, co]
//                    * g[u - (tap - P), co]
//   K10: dW[tap, ci, co] = sum_{n, v} relu?(x)[n, v + tap - P, ci] * g[n, v, co]
//        db[co] = sum_{n, v} g[n, v, co]
// The relu gradient at 0 is 0, as in JAX and torch. A residual block's
// input takes two gradients, the block's dy (through the residual add) and
// its first conv's dx: K9 adds the first to the second in its epilogue
// (`accum`), so no separate pass sums them.
//
// Bound on the H100: float32 arithmetic, 2 * 27 * Cin * Cout operations a
// voxel, as K1's (no tensor cores: the JAX model runs Precision.HIGHEST).
//
// K9 design: K1's tile (4 warps, a 3x8x4 voxel tile, 32 output channels a
// CTA, input chunks of 8 channels staged with their halo in shared memory)
// run on g with the taps flipped and W transposed while staging, so dx is
// a SAME convolution of g; the post_relu mask is applied as g is staged and
// the pre_relu mask in the epilogue.
//
// K10 design: a reduction over B * 33^3 positions for each of 27 * Cin *
// Cout outputs, deterministic with no float atomics. Stage 1: a CTA takes
// one tap (or the bias) and one chunk of rows (n, z, y) of the output;
// each thread owns a 4 (ci) x 4 (co) register tile and a strided share of
// the chunk's x positions, so a position costs two float4 loads for 16
// FMAs; the CTA's thread groups are summed in shared memory in a fixed
// order and the CTA writes its partial sums. Stage 2 sums the partials of
// all chunks for each output in chunk order. Two runs on the same inputs
// give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int TZ = 3, TY = 8, TX = 4;  // K9 output voxel tile of one CTA
constexpr int CI = 8;                  // K9 g channels per staged chunk
constexpr int CO = 32;                 // K9 dx channels per CTA

template <int K>
__global__ void __launch_bounds__(kThreads)
conv3d_dgrad_kernel(const float* __restrict__ dy, const float* __restrict__ y,
                    const float* __restrict__ x, const float* __restrict__ wt,
                    const float* __restrict__ accum, float* __restrict__ dx,
                    int D, int H, int W, int Cin, int Cout, int tiles_x) {
  // Here the "input" is g (Cout channels) and the output dx (Cin channels).
  constexpr int P = K / 2;
  constexpr int SZ = TZ + K - 1, SY = TY + K - 1, SX = TX + K - 1;
  constexpr int KK = K * K * K;
  __shared__ float s_in[CI][SZ][SY][SX];
  __shared__ __align__(16) float s_w[KK][CI][CO];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = lane % TX, ty = lane / TX;
  const int x0 = (blockIdx.x % tiles_x) * TX;
  const int y0 = (blockIdx.x / tiles_x) * TY;
  const int z0 = blockIdx.y * TZ;
  const int ci_blocks = (Cin + CO - 1) / CO;
  const int n = blockIdx.z / ci_blocks;
  const int ci0 = (blockIdx.z % ci_blocks) * CO;
  const bool active = ci0 + warp * 8 < Cin;  // warp-uniform

  const size_t vol = (size_t)D * H * W;
  const float* dyn = dy + (size_t)n * vol * Cout;
  const float* yn = y ? y + (size_t)n * vol * Cout : nullptr;

  float acc[TZ][8];
#pragma unroll
  for (int z = 0; z < TZ; ++z)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[z][c] = 0.f;

  for (int c0 = 0; c0 < Cout; c0 += CI) {
    __syncthreads();
    for (int i = tid; i < SZ * SY * SX * CI; i += kThreads) {
      const int c = i % CI;
      const int v = i / CI;
      const int sx = v % SX, sy = (v / SX) % SY, sz = v / (SX * SY);
      const int gz = z0 + sz - P, gy = y0 + sy - P, gx = x0 + sx - P;
      float val = 0.f;
      if (c0 + c < Cout && gz >= 0 && gz < D && gy >= 0 && gy < H &&
          gx >= 0 && gx < W) {
        const size_t at = (((size_t)gz * H + gy) * W + gx) * Cout + c0 + c;
        val = dyn[at];
        if (yn != nullptr && !(yn[at] > 0.f)) val = 0.f;
      }
      s_in[c][sz][sy][sx] = val;
    }
    // Flipped taps, transposed channels: s_w[t][c][o] = W[KK-1-t][o][c].
    for (int i = tid; i < KK * CI * CO; i += kThreads) {
      const int o = i % CO, c = (i / CO) % CI, t = i / (CO * CI);
      float val = 0.f;
      if (c0 + c < Cout && ci0 + o < Cin)
        val = wt[((size_t)(KK - 1 - t) * Cin + ci0 + o) * Cout + c0 + c];
      s_w[t][c][o] = val;
    }
    __syncthreads();
    if (!active) continue;

#pragma unroll 1
    for (int c = 0; c < CI; ++c) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          float col[SZ];
#pragma unroll
          for (int j = 0; j < SZ; ++j) col[j] = s_in[c][j][ty + ky][tx + kx];
#pragma unroll
          for (int kz = 0; kz < K; ++kz) {
            const float* wp = &s_w[(kz * K + ky) * K + kx][c][warp * 8];
            const float4 wa = *reinterpret_cast<const float4*>(wp);
            const float4 wb = *reinterpret_cast<const float4*>(wp + 4);
            const float w8[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int z = 0; z < TZ; ++z)
#pragma unroll
              for (int o = 0; o < 8; ++o)
                acc[z][o] = fmaf(col[z + kz], w8[o], acc[z][o]);
          }
        }
      }
    }
  }

  const int gy = y0 + ty, gx = x0 + tx;
  if (!active || gy >= H || gx >= W) return;
#pragma unroll
  for (int z = 0; z < TZ; ++z) {
    const int gz = z0 + z;
    if (gz >= D) break;
    const size_t base = ((((size_t)n * D + gz) * H + gy) * W + gx) * Cin;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int ci = ci0 + warp * 8 + o;
      if (ci >= Cin) break;
      float v = acc[z][o];
      if (x != nullptr && !(x[base + ci] > 0.f)) v = 0.f;
      if (accum != nullptr) v += accum[base + ci];
      dx[base + ci] = v;
    }
  }
}

constexpr int kWThreads = 256;
constexpr int kTile = 4;  // K10: a thread's ci x co register tile is 4 x 4

__device__ __forceinline__ void load4(const float* p, int c, int C, bool vec,
                                      float out[kTile]) {
  if (vec) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + c));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < kTile; ++i) out[i] = c + i < C ? __ldg(p + c + i) : 0.f;
  }
}

// Stage 1. blockIdx.x: chunk of `rows` output rows (n, z, y); blockIdx.y:
// tap in [0, KK) or KK for the bias. partial[chunk][KK*Cin*Cout + Cout].
template <int K>
__global__ void __launch_bounds__(kWThreads)
conv3d_wgrad_partial_kernel(const float* __restrict__ x,
                            const float* __restrict__ dy,
                            const float* __restrict__ y,
                            float* __restrict__ partial, int N, int D, int H,
                            int W, int Cin, int Cout, int pre_relu,
                            int rows) {
  constexpr int P = K / 2;
  constexpr int KK = K * K * K;
  __shared__ float s_red[kWThreads][kTile * kTile];
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const int tap = blockIdx.y;
  const int total_rows = N * D * H;
  const int r0 = chunk * rows;
  const int r1 = min(r0 + rows, total_rows);
  const size_t per_chunk = (size_t)KK * Cin * Cout + Cout;
  float* out = partial + (size_t)chunk * per_chunk;

  if (tap == KK) {  // the bias: db[co] = sum g
    const int groups = kWThreads / Cout;
    const int co = tid % Cout, grp = tid / Cout;
    float acc = 0.f;
    if (grp < groups) {
      for (int r = r0; r < r1; ++r)
        for (int xx = grp; xx < W; xx += groups) {
          const size_t at = ((size_t)r * W + xx) * Cout + co;
          float g = dy[at];
          if (y != nullptr && !(y[at] > 0.f)) g = 0.f;
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
  const int tci = (Cin + kTile - 1) / kTile, tco = (Cout + kTile - 1) / kTile;
  const int tiles = tci * tco;
  const int groups = kWThreads / tiles;
  const int tile = tid % tiles, grp = tid / tiles;
  const int c_in = (tile / tco) * kTile, c_out = (tile % tco) * kTile;
  // float4 loads where every row start is 16-byte aligned.
  const bool vin = (Cin % kTile) == 0 &&
                   (reinterpret_cast<size_t>(x) & 15) == 0;
  const bool vout = (Cout % kTile) == 0 &&
                    (reinterpret_cast<size_t>(dy) & 15) == 0 &&
                    (reinterpret_cast<size_t>(y) & 15) == 0;
  float acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = 0.f;

  if (grp < groups) {
    for (int r = r0; r < r1; ++r) {
      const int yy = r % H, z = (r / H) % D, n = r / (H * D);
      const int sz = z + dz, sy = yy + dyy;
      if (sz < 0 || sz >= D || sy < 0 || sy >= H) continue;
      const float* xrow = x + (((size_t)n * D + sz) * H + sy) * W * Cin;
      const size_t grow = (size_t)r * W * Cout;
      for (int xx = grp; xx < W; xx += groups) {
        const int sx = xx + dxx;
        if (sx < 0 || sx >= W) continue;
        float xv[kTile], gv[kTile];
        load4(xrow + (size_t)sx * Cin, c_in, Cin, vin, xv);
        load4(dy + grow + (size_t)xx * Cout, c_out, Cout, vout, gv);
        if (y != nullptr) {
          float yv[kTile];
          load4(y + grow + (size_t)xx * Cout, c_out, Cout, vout, yv);
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
  for (int i = 0; i < kTile; ++i) {
    if (c_in + i >= Cin) break;
    for (int j = 0; j < kTile; ++j) {
      if (c_out + j >= Cout) break;
      float s = 0.f;
      for (int q = 0; q < groups; ++q) s += s_red[q * tiles + tile][i * kTile + j];
      out[((size_t)tap * Cin + c_in + i) * Cout + c_out + j] = s;
    }
  }
}

// Stage 2: out[j] = sum over chunks of partial[chunk][j], in chunk order.
__global__ void conv3d_wgrad_sum_kernel(const float* __restrict__ partial,
                                        float* __restrict__ dw,
                                        float* __restrict__ db, int chunks,
                                        int nw, int nb) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int per_chunk = nw + nb;
  if (j >= per_chunk) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[(size_t)c * per_chunk + j];
  if (j < nw) dw[j] = s;
  else db[j - nw] = s;
}

}  // namespace

// dy (N,D,H,W,Cout); y (same, the forward output) or null when the layer has
// no post_relu; x (N,D,H,W,Cin), the forward input, or null when it has no
// pre_relu; w (k,k,k,Cin,Cout); accum (N,D,H,W,Cin), added to dx, or null;
// dx (N,D,H,W,Cin). All float32, contiguous.
extern "C" int ffn_conv3d_dgrad_f32(const float* dy, const float* y,
                                    const float* x, const float* w,
                                    const float* accum, float* dx, int N,
                                    int D, int H, int W, int Cin, int Cout,
                                    int k, void* stream) {
  const int tiles_x = (W + TX - 1) / TX;
  const int tiles_y = (H + TY - 1) / TY;
  const dim3 grid(tiles_x * tiles_y, (D + TZ - 1) / TZ,
                  N * ((Cin + CO - 1) / CO));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 3) {
    conv3d_dgrad_kernel<3><<<grid, kThreads, 0, s>>>(dy, y, x, w, accum, dx, D,
                                                     H, W, Cin, Cout, tiles_x);
  } else if (k == 1) {
    conv3d_dgrad_kernel<1><<<grid, kThreads, 0, s>>>(dy, y, x, w, accum, dx, D,
                                                     H, W, Cin, Cout, tiles_x);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (N,D,H,W,Cin), the forward input (relu applied here when pre_relu);
// dy (N,D,H,W,Cout); y, the forward output, or null without post_relu;
// partial (chunks, k^3*Cin*Cout + Cout) scratch; dw (k,k,k,Cin,Cout); db
// (Cout). `rows` output rows (n, z, y) per chunk; chunks = ceil(N*D*H/rows).
// Needs ceil(Cin/4)*ceil(Cout/4) <= 256 and Cout <= 256.
extern "C" int ffn_conv3d_wgrad_f32(const float* x, const float* dy,
                                    const float* y, float* partial, float* dw,
                                    float* db, int N, int D, int H, int W,
                                    int Cin, int Cout, int k, int pre_relu,
                                    int rows, void* stream) {
  const int tiles = ((Cin + kTile - 1) / kTile) * ((Cout + kTile - 1) / kTile);
  if (tiles > kWThreads || Cout > kWThreads || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (N * D * H + rows - 1) / rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kk = k * k * k;
  const dim3 grid(chunks, kk + 1);
  if (k == 3) {
    conv3d_wgrad_partial_kernel<3><<<grid, kWThreads, 0, s>>>(
        x, dy, y, partial, N, D, H, W, Cin, Cout, pre_relu, rows);
  } else if (k == 1) {
    conv3d_wgrad_partial_kernel<1><<<grid, kWThreads, 0, s>>>(
        x, dy, y, partial, N, D, H, W, Cin, Cout, pre_relu, rows);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nw = kk * Cin * Cout;
  const int total = nw + Cout;
  conv3d_wgrad_sum_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      partial, dw, db, chunks, nw, Cout);
  return static_cast<int>(cudaGetLastError());
}
