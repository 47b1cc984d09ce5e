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
// The relu gradient at 0 is 0. K10: the stack's 3^3 layers on the chunk
// tiles of wgrad32.cuh (each chunk staged once for all 27 taps); the 1^3
// layers and other widths on K18's two-stage deterministic body
// (wgrad.cuh) on float inputs.
//
// K9 on the H100: float32 FMAs on the CUDA cores (TF32 would not keep its
// 1e-4 check), so its bound is arithmetic: a 3^3 32->32 layer at B=4 is
// 7.95 GFLOP, 0.119 ms at 67 TFLOP/s, against 18-46 MB (5-14 us) of bytes.
// dx is the SAME convolution of g with W'[tap'][co][ci] = W[26 - tap'][ci]
// [co], on the plane-position tiles of conv32.cuh (shared with K1; tools_
// torch/dgrad_variants.py times the options): persistent CTAs of 24 warps
// at 32 channels stage W' once as rows [co][tap'][ci] of the CTA's dx
// channels (8 consecutive co, one 32-byte read, of 4 ci a warp; the row pad
// puts them on distinct banks); with post_relu, y is staged beside g and
// each thread zeroes its own copies of g where y is not > 0 once they land;
// the epilogue applies the pre_relu mask from x and adds `accum`, by float4
// where the channels allow.
// Measured on an H100 (dgrad_variants.py --split, 32->32 at B=4): the FMA
// loop alone ~60% of the float32 rate (its shared loads and the FMAs'
// operand traffic); staging and the epilogue add ~40 us, ~40 more with
// post_relu (y staged and applied) and pre_relu (x and accum read).
// ops/conv3d.py's k9_geometry mirrors k9_plan. 1^3 layers (conv_lom): one
// thread per dx entry, the Cout products summed in order.

#include "conv32.cuh"
#include "wgrad.cuh"
#include "wgrad32.cuh"

namespace {

// K9's plan: cig by the dx width, half an SM a CTA when cig < 8 (two share
// it), else the whole; g (Cout channels) staged, y beside it when masked.
inline TilePlan k9_plan(int N, int D, int H, int W, int Cin, int Cout,
                        bool masked) {
  const int cig = tile_cig(Cin);
  return tile_plan(N, D, H, W, Cin, Cout, masked, cig,
                   cig < 8 ? kSmemTwo : kSmemLimit);
}

// K9's prologue and epilogue around conv32.cuh's tile walk (TileArgs: Cy
// the dx channels, Cx the g channels).
struct DgradOp {
  static constexpr bool kDzInner = false;  // g channels, tap rows, dx
  const float* in;  // dy
  const float* ym;  // y, or null
  const float* xm;  // x, or null
  const float* wt;
  const float* accum;
  float* dx;

  // W'[c][tap'][ci] = W[26 - tap'][ci][c], zero past Cin and Cout: 8
  // consecutive c (one 32-byte read) of 4 ci a warp; the row pad puts them
  // on distinct banks.
  __device__ __forceinline__ void load_weights(float* s_w, int ob, int g0,
                                               int tid, int threads, int cip,
                                               const TileArgs& a) const {
    const int ci0 = ob * cip;
    const uint32_t sw = static_cast<uint32_t>(__cvta_generic_to_shared(s_w));
    for (int i = tid; i < (a.gb + 7) / 8 * 8 * 27 * cip; i += threads) {
      const int c8 = i % 8, ci = (i / 8) % cip, rest = i / (8 * cip);
      const int tap = rest % 27, c = (rest / 27) * 8 + c8;
      if (c >= a.gb) continue;
      const bool valid = ci0 + ci < a.Cy && g0 + c < a.Cx;
      const size_t src =
          valid ? ((size_t)(26 - tap) * a.Cy + ci0 + ci) * a.Cx + g0 + c : 0;
      cp_async<4>(sw + 4 * (c * a.w_row + tap * cip + ci), wt + src, valid);
    }
  }

  __device__ __forceinline__ bool fixes() const { return ym != nullptr; }

  // g = 0 where y is not > 0 (y's copy sits stage / 2 floats on).
  __device__ __forceinline__ void fix(float* st, int j, int stage) const {
    if (!(st[stage / 2 + j] > 0.f)) st[j] = 0.f;
  }

  // dx = acc [x > 0] + accum at the thread's positions and channels.
  __device__ __forceinline__ void store(const float (&acc)[kRun][kCiT],
                                        TilePos t, int run, int cig, int ob,
                                        int cip, const TileArgs& a) const {
    const int ci = ob * cip + cig * kCiT;
    const int q = t.q0 + run * kRun;
    int gy = q / a.P, gx = q - gy * a.P;
    const size_t plane0 = ((size_t)t.n * a.D + t.z) * a.H * a.W;
#pragma unroll
    for (int p = 0; p < kRun; ++p) {
      if (gy < a.H && gx < a.W && ci < a.Cy) {
        const size_t o = (plane0 + (size_t)gy * a.W + gx) * a.Cy + ci;
        float v[kCiT] = {acc[p][0], acc[p][1], acc[p][2], acc[p][3]};
        if (a.vec) {
          if (xm != nullptr) {
            const float4 m = __ldg(reinterpret_cast<const float4*>(xm + o));
            const float mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
            for (int j = 0; j < kCiT; ++j)
              if (!(mv[j] > 0.f)) v[j] = 0.f;
          }
          if (accum != nullptr) {
            const float4 e =
                __ldg(reinterpret_cast<const float4*>(accum + o));
            v[0] += e.x;
            v[1] += e.y;
            v[2] += e.z;
            v[3] += e.w;
          }
          *reinterpret_cast<float4*>(dx + o) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < kCiT; ++j) {
            if (ci + j >= a.Cy) break;
            if (xm != nullptr && !(__ldg(xm + o + j) > 0.f)) v[j] = 0.f;
            if (accum != nullptr) v[j] += __ldg(accum + o + j);
            dx[o + j] = v[j];
          }
        }
      }
      if (++gx == a.P) {
        gx = 0;
        ++gy;
      }
    }
  }
};

template <int CIG>
__global__ void __launch_bounds__(kRuns * CIG, 1)
conv3d_dgrad_kernel(DgradOp op, TileArgs a) {
  tile_walk<CIG, false>(op, a);
}

// 1^3 layers: one thread per dx entry, the Cout products summed in order.
__global__ void dgrad1_kernel(const float* __restrict__ dy,
                              const float* __restrict__ ym,
                              const float* __restrict__ xm,
                              const float* __restrict__ wt,
                              const float* __restrict__ accum,
                              float* __restrict__ dx, long long n, int Cin,
                              int Cout) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long v = i / Cin;
  const int ci = (int)(i % Cin);
  float acc = 0.f;
  for (int co = 0; co < Cout; ++co) {
    const size_t at = (size_t)v * Cout + co;
    const float g = ym != nullptr && !(ym[at] > 0.f) ? 0.f : dy[at];
    acc = fmaf(g, wt[(size_t)ci * Cout + co], acc);
  }
  if (xm != nullptr && !(xm[i] > 0.f)) acc = 0.f;
  if (accum != nullptr) acc += accum[i];
  dx[i] = acc;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1) {
    const long long n = (long long)N * D * H * W * Cin;
    if (n == 0) return static_cast<int>(cudaSuccess);
    dgrad1_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        dy, y, x, w, accum, dx, n, Cin, Cout);
    return static_cast<int>(cudaGetLastError());
  }
  if (k != 3) return static_cast<int>(cudaErrorInvalidValue);
  const TilePlan p = k9_plan(N, D, H, W, Cin, Cout, y != nullptr);
  if (p.tiles == 0) return static_cast<int>(cudaSuccess);
  int dev = 0, sms = 0;
  cudaError_t err = device_sms(&dev, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto aligned = [](const float* q) {
    return q == nullptr || (reinterpret_cast<size_t>(q) & 15) == 0;
  };
  // Whole float4s of x, accum and dx in the epilogue.
  const int vec = Cin % 4 == 0 && aligned(x) && aligned(accum) && aligned(dx);
  const TileArgs a = tile_args(p, N, D, H, W, Cin, Cout, vec);
  const DgradOp op{dy, y, x, w, accum, dx};
  switch (p.cig) {
    case 8:
      err = launch_tiles(conv3d_dgrad_kernel<8>, p, dev, sms, s, op, a);
      break;
    case 4:
      err = launch_tiles(conv3d_dgrad_kernel<4>, p, dev, sms, s, op, a);
      break;
    case 2:
      err = launch_tiles(conv3d_dgrad_kernel<2>, p, dev, sms, s, op, a);
      break;
    default:
      err = launch_tiles(conv3d_dgrad_kernel<1>, p, dev, sms, s, op, a);
  }
  return static_cast<int>(err);
}

// K10's 3^3 layers on wgrad32.cuh's chunk tiles: stage 1 writes one row of
// partials a CTA, stage 2 sums them in row order.
template <int CIN, int COUT>
cudaError_t wgrad_tiles(const float* x, const float* dy, const float* y,
                        float* partial, float* dw, float* db,
                        const W10Plan& p, int D, int H, int W, int pre_relu,
                        cudaStream_t s) {
  auto kernel = wgrad_tile_kernel<CIN, COUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  const int xf = w10_x_floats(p.cy, p.cx, CIN);
  const int gf = p.cy * (p.cx + 2) * COUT;
  const W10Args a{D, H, W, p.cy, p.cx, p.ny, p.nx,
                  w10_stage_floats(p.cy, p.cx, CIN, COUT, y != nullptr), xf,
                  xf + gf, pre_relu, p.chunks};
  kernel<<<p.ctas, kW10Threads, p.smem, s>>>(x, dy, y, partial, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int nw = 27 * CIN * COUT, total = nw + COUT;
  wgrad_sum_kernel<float><<<(total + 255) / 256, 256, 0, s>>>(
      partial, dw, db, p.ctas, nw, COUT);
  return cudaGetLastError();
}

// x (N,D,H,W,Cin), the forward input (relu applied here when pre_relu);
// dy (N,D,H,W,Cout); y, the forward output, or null without post_relu;
// partial (partial_rows, k^3*Cin*Cout + Cout) scratch; dw (k,k,k,Cin,Cout);
// db (Cout). 3^3 layers with (Cin, Cout) in {(2,32), (32,32), (2,16),
// (16,16)} run on the chunk tiles (w10_plan: ctas rows of partials; the
// `rows` argument unused); the others on wgrad.cuh's rows: `rows` output
// rows (n, z, y) a chunk, ceil(N*D*H/rows) rows of partials, needing
// ceil(Cin/4)*ceil(Cout/4) <= 256 and Cout <= 256. cudaErrorInvalidValue
// when partial_rows is fewer than the body needs.
extern "C" int ffn_conv3d_wgrad_f32(const float* x, const float* dy,
                                    const float* y, float* partial, float* dw,
                                    float* db, int N, int D, int H, int W,
                                    int Cin, int Cout, int k, int pre_relu,
                                    int rows, int partial_rows,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  W10Plan p;
  const bool tiles = k == 3 && (Cin == 2 || Cin == Cout) &&
                     (Cout == 16 || Cout == 32) &&
                     w10_plan(N, D, H, W, Cin, Cout, y != nullptr, &p);
  if (tiles) {
    if (p.ctas > partial_rows) return static_cast<int>(cudaErrorInvalidValue);
#define FFN_K10_CASE(CI, CO)                                                 \
  if (Cin == CI && Cout == CO)                                               \
    return static_cast<int>(wgrad_tiles<CI, CO>(x, dy, y, partial, dw, db, p, \
                                                D, H, W, pre_relu, s));
    FFN_K10_CASE(2, 32)
    FFN_K10_CASE(32, 32)
    FFN_K10_CASE(2, 16)
    FFN_K10_CASE(16, 16)
#undef FFN_K10_CASE
  }
  if (rows < 1 || (N * D * H + rows - 1) / rows > partial_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  return wgrad_launch<float>(x, 1, dy, 1, y, partial, dw, db, N, D, H, W, Cin,
                             Cout, k, pre_relu, rows, s);
}
