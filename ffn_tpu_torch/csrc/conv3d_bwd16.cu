// K17 conv3d_dgrad_16 and K18 conv3d_wgrad_16: the input and the weight
// (and bias) gradients of one K15 layer in bfloat16 or float16 (one body
// templated on the type r), replacing XLA's backward of the 16-bit nn.Conv
// layers in `jax.value_and_grad` of the train steps (ffn_tpu/training/
// train_lib.py:368, :471). Its jaxpr, copied: the float32 cotangent of the
// logits is cast to r before conv_lom's backward; each conv transpose
// outputs r; a relu's gradient selects (0 at 0); a residual's two
// cotangents meet in one add of type r. With g = r(dy) [y > 0 if post_relu]:
//   K17: dx = r( r(sum W g) [x > 0 if pre_relu] + accum ), one rounding
//        without `accum` (the block input's other cotangent);
//   K18: dW = f32(r(sum r(relu?(x)) g)), db = f32(r(sum g)) over (N, z, y,
//        x), each summed in float32 and rounded once (ROADMAP Queue 3: XLA's
//        CPU backend sums a 16-bit bias gradient in 16 bits).
// The products are exact in float32, so only the sums' order and rounding
// can differ from XLA's; both kernels are deterministic and N-independent.
//
// Bound on the H100: a 3^3 32->32 layer at B=4 is 7.95 GFLOP (8.0 us at
// 989 TFLOP/s) and 18-46 MB for K17 (5.5-13.7 us at 3.35 TB/s: a block's
// first layer reads dy, both masks and the residual's cotangent), 18-28 MB
// for K18. K17: K15's tensor-core tile and MMA loop (conv16.cuh) on g, the
// taps flipped and the weights transposed while staged (dx is the SAME
// convolution of g with W'[tap][co][ci] = W[26 - tap][ci][co]); the
// post_relu mask as g is staged, pre_relu, rounding and `accum` in the
// epilogue; no exact-sum correction. 1^3 layers (conv_lom: dx = r(r(dy) w))
// on the CUDA cores, dy read as float32. K18: K10's two-stage body
// (wgrad.cuh) on the CUDA cores. Left for later: K18 on the tensor cores,
// wgmma and TMA.

#include "wgrad.cuh"

namespace {

// The CI x CO dx channel pairs of K17's tensor-core kernel: the stack's 3^3
// layers whose input gradient training needs, at 32 and 16 features.
template <typename T, int CI, int CO>
__global__ void __launch_bounds__(kTcThreads)
dgrad16_tc_kernel(const T* __restrict__ dy, const T* __restrict__ ym,
                  const T* __restrict__ wt, const T* __restrict__ xm,
                  const T* __restrict__ accum, T* __restrict__ dx, int D,
                  int H, int W, int tiles_x) {
  using G = Geo<CO, CI>;  // the GEMM's input channels are g's (CO)
  static_assert(G::K == G::KPAD && CO % 8 == 0, "K17 shape");
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_w = reinterpret_cast<T*>(smem);  // [27 * CO][WS]: W' rows
  T* s_x = s_w + G::KPAD * G::WS;       // [SVOX][CS]: g with its halo

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = (blockIdx.x % tiles_x) * TX;
  const int y0 = (blockIdx.x / tiles_x) * TY;
  const int z0 = blockIdx.y * TZ;
  const size_t vox0 = (size_t)blockIdx.z * D * H * W;

  // W'[tap'][co][ci] = W[26 - tap'][ci][co]: 8 consecutive co of the DHWIO
  // tensor per load, scattered into 8 rows of column ci.
  unsigned short* s_w16 = reinterpret_cast<unsigned short*>(s_w);
  for (int i = tid; i < 27 * CI * (CO / 8); i += kTcThreads) {
    const int c8 = (i % (CO / 8)) * 8, ci = (i / (CO / 8)) % CI;
    const int tap = i / (CO / 8 * CI);
    const uint4 v = *reinterpret_cast<const uint4*>(
        wt + ((size_t)tap * CI + ci) * CO + c8);
    const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
    const int r0 = (26 - tap) * CO + c8;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      s_w16[(r0 + j) * G::WS + ci] =
          (unsigned short)(w4[j >> 1] >> (16 * (j & 1)));
  }
  // g with its halo: dy masked where the forward output was not > 0.
  for (int i = tid; i < SVOX * (CO / 8); i += kTcThreads) {
    const int v = i / (CO / 8), c = (i % (CO / 8)) * 8;
    const int sx = v % SX, sy = (v / SX) % SY, sz = v / (SX * SY);
    const int gz = z0 + sz - 1, gy = y0 + sy - 1, gx = x0 + sx - 1;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (gz >= 0 && gz < D && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t at = (vox0 + ((size_t)gz * H + gy) * W + gx) * CO + c;
      u = *reinterpret_cast<const uint4*>(dy + at);
      if (ym != nullptr) {
        const uint4 m = *reinterpret_cast<const uint4*>(ym + at);
        uint32_t* uw = reinterpret_cast<uint32_t*>(&u);
        const uint32_t mw[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float lo, hi;
          unpack16<T>(mw[j], lo, hi);
          if (!(lo > 0.f)) uw[j] &= 0xffff0000u;
          if (!(hi > 0.f)) uw[j] &= 0x0000ffffu;
        }
      }
    }
    *reinterpret_cast<uint4*>(s_x + v * G::CS + c) = u;
  }
  __syncthreads();

  float acc[2][G::NT][4], unused[2][G::NT][4];
  tc_sums<T, CO, CI, false>(s_x, s_w, warp, lane, acc, unused);
  const int g = lane >> 2, t = lane & 3;
  const int gz = z0 + warp, gx = x0 + g;
  if (gz >= D || gx >= W) return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gy = y0 + 2 * mt + h;
      if (gy >= H) continue;
      const size_t o = (vox0 + ((size_t)gz * H + gy) * W + gx) * CI;
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const size_t i = o + nt * 8 + 2 * t + j;
          float v = round16<T>(acc[mt][nt][2 * h + j]);
          if (xm != nullptr && !(to_f<T>(xm[i]) > 0.f)) v = 0.f;
          if (accum != nullptr) v += to_f<T>(accum[i]);
          dx[i] = from_f<T>(v);
        }
    }
}

// 1^3 layers: one thread per dx entry, the Cout products summed in order.
template <typename T>
__global__ void dgrad16_k1_kernel(const void* __restrict__ dy, int dy_f32,
                                  const T* __restrict__ ym,
                                  const T* __restrict__ wt,
                                  const T* __restrict__ xm,
                                  const T* __restrict__ accum,
                                  T* __restrict__ dx, long long n, int Cin,
                                  int Cout) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long v = i / Cin;
  const int ci = (int)(i % Cin);
  float acc = 0.f;
  for (int co = 0; co < Cout; ++co) {
    const size_t at = (size_t)v * Cout + co;
    float gv = load16<T>(dy, dy_f32, at);
    if (ym != nullptr && !(to_f<T>(ym[at]) > 0.f)) gv = 0.f;
    acc = fmaf(gv, to_f<T>(wt[ci * Cout + co]), acc);
  }
  float r = round16<T>(acc);
  if (xm != nullptr && !(to_f<T>(xm[i]) > 0.f)) r = 0.f;
  if (accum != nullptr) r += to_f<T>(accum[i]);
  dx[i] = from_f<T>(r);
}

template <typename T, int CI, int CO>
cudaError_t launch_dgrad_tc(const T* dy, const T* ym, const T* w,
                            const T* xm, const T* accum, T* dx, int N, int D,
                            int H, int W, cudaStream_t s) {
  constexpr size_t smem = Geo<CO, CI>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      dgrad16_tc_kernel<T, CI, CO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + TX - 1) / TX, tiles_y = (H + TY - 1) / TY;
  const dim3 grid(tiles_x * tiles_y, (D + TZ - 1) / TZ, N);
  dgrad16_tc_kernel<T, CI, CO><<<grid, kTcThreads, smem, s>>>(
      dy, ym, w, xm, accum, dx, D, H, W, tiles_x);
  return cudaGetLastError();
}

template <typename T>
int dgrad16(const void* dy, int dy_f32, const void* ym, const void* w,
            const void* xm, const void* accum, void* dx, int N, int D, int H,
            int W, int Cin, int Cout, int k, cudaStream_t s) {
  const T *yt = static_cast<const T*>(ym), *wt = static_cast<const T*>(w),
          *xt = static_cast<const T*>(xm), *at = static_cast<const T*>(accum);
  T* out = static_cast<T*>(dx);
  if (k == 1) {
    const long long n = (long long)N * D * H * W * Cin;
    dgrad16_k1_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        dy, dy_f32, yt, wt, xt, at, out, n, Cin, Cout);
    return static_cast<int>(cudaGetLastError());
  }
  if (k != 3 || dy_f32) return static_cast<int>(cudaErrorInvalidValue);
  const T* g = static_cast<const T*>(dy);
  if (Cin == 32 && Cout == 32)
    return static_cast<int>(launch_dgrad_tc<T, 32, 32>(g, yt, wt, xt, at, out,
                                                       N, D, H, W, s));
  if (Cin == 16 && Cout == 16)
    return static_cast<int>(launch_dgrad_tc<T, 16, 16>(g, yt, wt, xt, at, out,
                                                       N, D, H, W, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K17. dy (N,D,H,W,Cout) of the type (float32 when dy_f32, 1^3 only); ym
// (the forward output, for post_relu) or null; w (k,k,k,Cin,Cout); xm (the
// forward input, for pre_relu) or null; accum (N,D,H,W,Cin) or null; dx
// (N,D,H,W,Cin). 16-bit tensors of one type (f16: float16, else bfloat16),
// contiguous, 16-byte aligned; k = 3 takes Cin = Cout in {16, 32}.
extern "C" int ffn_conv3d_dgrad_16(const void* dy, int dy_f32, const void* ym,
                                   const void* w, const void* xm,
                                   const void* accum, void* dx, int N, int D,
                                   int H, int W, int Cin, int Cout, int k,
                                   int f16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f16 ? dgrad16<__half>(dy, dy_f32, ym, w, xm, accum, dx, N, D, H, W,
                               Cin, Cout, k, s)
             : dgrad16<__nv_bfloat16>(dy, dy_f32, ym, w, xm, accum, dx, N, D,
                                      H, W, Cin, Cout, k, s);
}

// K18. x (N,D,H,W,Cin), the forward input, of the type or float32 (x_f32,
// rounded here; relu here when pre_relu); dy (N,D,H,W,Cout) of the type or
// float32 (dy_f32); ym, the forward output, or null without post_relu;
// partial (chunks, k^3*Cin*Cout + Cout) float32 scratch; dw (k,k,k,Cin,Cout)
// and db (Cout) float32. `rows` output rows (n, z, y) per chunk; chunks =
// ceil(N*D*H/rows). Needs ceil(Cin/4)*ceil(Cout/4) <= 256, Cout <= 256.
extern "C" int ffn_conv3d_wgrad_16(const void* x, int x_f32, const void* dy,
                                   int dy_f32, const void* ym, float* partial,
                                   float* dw, float* db, int N, int D, int H,
                                   int W, int Cin, int Cout, int k,
                                   int pre_relu, int rows, int f16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f16 ? wgrad_launch<__half>(x, x_f32, dy, dy_f32, ym, partial, dw,
                                    db, N, D, H, W, Cin, Cout, k, pre_relu,
                                    rows, s)
             : wgrad_launch<__nv_bfloat16>(x, x_f32, dy, dy_f32, ym, partial,
                                           dw, db, N, D, H, W, Cin, Cout, k,
                                           pre_relu, rows, s);
}
