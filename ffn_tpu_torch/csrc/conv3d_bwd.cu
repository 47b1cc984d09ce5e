// K9 conv3d_dgrad_f32 and K10 conv3d_wgrad_f32: the input and the weight
// (and bias) gradients of one K1 layer, float32, channels-last, replacing
// XLA's backward of the stack's nn.Conv layers in the scan step
// (ffn_tpu/training/train_lib.py:368). With g = dy * [y > 0 if post_relu]
// (y the saved output: the model never combines post_relu and a residual):
//   K9:  dx[u, ci] = [x > 0 if pre_relu] * sum_tap sum_co W[tap, ci, co]
//                    * g[u - (tap - P), co]  (+ accum: a residual block's
//                    input takes its dy too, added in the epilogue)
//   K10: dW[tap, ci, co] = sum relu?(x)[n, v + tap - P, ci] g[n, v, co],
//        db[co] = sum g[n, v, co]
// The relu gradient at 0 is 0. Bound on the H100: float32 arithmetic, as
// K1's. K9: K1's tile on g with the taps flipped and W transposed while
// staging (a SAME convolution of g); the post_relu mask as g is staged, the
// pre_relu mask in the epilogue. K10: K18's two-stage deterministic body
// (wgrad.cuh) on float inputs.

#include "wgrad.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int KZ = 3, KY = 8, KX = 4;  // K9 output voxel tile of one CTA
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
  constexpr int SZ = KZ + K - 1, SY = KY + K - 1, SX = KX + K - 1;
  constexpr int KK = K * K * K;
  __shared__ float s_in[CI][SZ][SY][SX];
  __shared__ __align__(16) float s_w[KK][CI][CO];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = lane % KX, ty = lane / KX;
  const int x0 = (blockIdx.x % tiles_x) * KX;
  const int y0 = (blockIdx.x / tiles_x) * KY;
  const int z0 = blockIdx.y * KZ;
  const int ci_blocks = (Cin + CO - 1) / CO;
  const int n = blockIdx.z / ci_blocks;
  const int ci0 = (blockIdx.z % ci_blocks) * CO;
  const bool active = ci0 + warp * 8 < Cin;  // warp-uniform

  const size_t vol = (size_t)D * H * W;
  const float* dyn = dy + (size_t)n * vol * Cout;
  const float* yn = y ? y + (size_t)n * vol * Cout : nullptr;

  float acc[KZ][8];
#pragma unroll
  for (int z = 0; z < KZ; ++z)
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
            for (int z = 0; z < KZ; ++z)
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
  for (int z = 0; z < KZ; ++z) {
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
  const int tiles_x = (W + KX - 1) / KX;
  const int tiles_y = (H + KY - 1) / KY;
  const dim3 grid(tiles_x * tiles_y, (D + KZ - 1) / KZ,
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
  return wgrad_launch<float>(x, 1, dy, 1, y, partial, dw, db, N, D, H, W, Cin,
                             Cout, k, pre_relu, rows,
                             static_cast<cudaStream_t>(stream));
}
