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
// --use_fast_math; the intrinsics pin each rounding anyway.
//
// Bound on the H100: a 3^3 32->32 layer on N 33^3 samples reads 4.6 MB of
// float32 a sample and writes as much (0.176 ms at N = 64 over 3.35 TB/s)
// against 2 GOP of int8 (0.064 ms at 1979 TOP/s): bytes. Design (K15's
// tile, conv16.cuh): a CTA of 4 warps owns 4(z) x 4(y) x 8(x) voxels and
// every output channel; it stages its halo tile quantized on load (int8,
// rows padded against bank conflicts) and the weights transposed to
// [Cout][K] (K = 27 Cin in (tap, channel) order, zero-padded to k32 steps),
// then runs mma.sync m16n8k32 s8 with s32 sums; warp w owns z = w as two
// m16 tiles (two y rows of 8 x). Cin = 2 packs two taps in each 4-byte A
// word. 1^3 layers (conv_lom) are an int32 dot product per output on the
// CUDA cores. A CTA never mixes samples, so a lane's result does not depend
// on N. K20 reads each lane's slice once by float4 (bound by bytes: 294 MB
// at N = 64 and 32 channels, 0.088 ms): blocks of 256 threads, 4 loads in
// flight a thread, a grid of about two waves over (lane, slice); the
// floats before the lane's first 16-byte boundary and after its last
// float4 go to its first block (the 2-channel input layer's lanes, 33^3 * 2
// floats, start 16-byte aligned every other lane). Each block
// folds its maximum into the lane's by atomicMax on the bits of non-negative
// floats (exact, order-free); the lane's last block writes m and zeroes the
// lane's two counters, so the wrapper's buffer needs no memset per call.
// Left for later: TMA, wgmma, K20 fused into K19's epilogue, the
// quantized tile shared across output tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int TZ = 4, TY = 4, TX = 8;
constexpr int SZ = TZ + 2, SY = TY + 2, SX = TX + 2;
constexpr int SVOX = SZ * SY * SX;
constexpr float kC127 = 1.0f / 127.0f;  // f32(1/127), as XLA folds it
constexpr float kFloor = 1e-12f;

template <int CIN, int COUT>
struct QGeo {
  static_assert(CIN % 4 == 0 || CIN == 2, "Cin: 2 or a multiple of 4");
  static constexpr int K = 27 * CIN;
  static constexpr int KPAD = (K + 31) / 32 * 32;
  // Bytes per staged voxel and per weight column: +16 so that the 8 rows
  // (or columns) of a fragment load fall in distinct banks.
  static constexpr int CS = CIN % 32 == 0 ? CIN + 16 : CIN;
  static constexpr int WK = KPAD + 16;
  static constexpr int NT = COUT / 8;
  static constexpr size_t SMEM = (size_t)COUT * WK + (size_t)SVOX * CS;
};

__device__ __forceinline__ int tap_offset(int t) {
  return ((t / 9) * SY + (t / 3) % 3) * SX + t % 3;
}

__device__ __forceinline__ int quantize(float v, float scale, int relu) {
  if (relu && v < 0.f) v = 0.f;
  const int q = __float2int_rn(__fdiv_rn(v, scale));
  return q < -127 ? -127 : (q > 127 ? 127 : q);
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

// The 4 int8 values of K indices k..k+3 (k % 4 == 0) at staged voxel vox
// (tap 0's), as one A word; indices past K read zero.
template <int CIN, int COUT>
__device__ __forceinline__ uint32_t a_word(const int8_t* s_x, int vox,
                                           int k) {
  using G = QGeo<CIN, COUT>;
  if constexpr (CIN % 4 == 0) {
    const int tap = k / CIN;
    if (tap >= 27) return 0u;
    return *reinterpret_cast<const uint32_t*>(
        s_x + (vox + tap_offset(tap)) * G::CS + k % CIN);
  } else {  // Cin = 2: taps k/2 and k/2 + 1, two channels each
    const int tap = k / 2;
    const uint32_t lo = tap < 27 ? *reinterpret_cast<const uint16_t*>(
        s_x + (vox + tap_offset(tap)) * 2) : 0u;
    const uint32_t hi = tap + 1 < 27 ? *reinterpret_cast<const uint16_t*>(
        s_x + (vox + tap_offset(tap + 1)) * 2) : 0u;
    return lo | (hi << 16);
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
qconv3d_s8_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq,
                  const float* __restrict__ w_scale,
                  const float* __restrict__ bias,
                  const float* __restrict__ absmax,
                  const float* __restrict__ res, float* __restrict__ y,
                  int D, int H, int W, int relu_in, int relu_out,
                  int tiles_x) {
  using G = QGeo<CIN, COUT>;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* s_w = reinterpret_cast<int8_t*>(smem);  // [COUT][WK]
  int8_t* s_x = s_w + COUT * G::WK;               // [SVOX][CS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = (blockIdx.x % tiles_x) * TX;
  const int y0 = (blockIdx.x / tiles_x) * TY;
  const int z0 = blockIdx.y * TZ;
  const int n = blockIdx.z;
  const size_t vox0 = (size_t)n * D * H * W;
  const float m = absmax[n];
  const float scale = __fmul_rn(m, kC127);

  // Weights: w_q row k = tap * Cin + ci, column c -> s_w[c][k], 4 rows a
  // word; rows past K zero.
  for (int i = tid; i < G::KPAD / 4 * COUT; i += kThreads) {
    const int k = (i / COUT) * 4, c = i % COUT;
    uint32_t v = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k + j < G::K)
        v |= (uint32_t)(uint8_t)wq[(size_t)(k + j) * COUT + c] << (8 * j);
    *reinterpret_cast<uint32_t*>(s_w + c * G::WK + k) = v;
  }
  // The input tile with its halo, quantized; SAME padding reads as zero.
  for (int i = tid; i < SVOX * CIN; i += kThreads) {
    const int v = i / CIN, c = i % CIN;
    const int sx = v % SX, sy = (v / SX) % SY, sz = v / (SX * SY);
    const int gz = z0 + sz - 1, gy = y0 + sy - 1, gx = x0 + sx - 1;
    int q = 0;
    if (gz >= 0 && gz < D && gy >= 0 && gy < H && gx >= 0 && gx < W)
      q = quantize(x[(vox0 + ((size_t)gz * H + gy) * W + gx) * CIN + c],
                   scale, relu_in);
    s_x[v * G::CS + c] = (int8_t)q;
  }
  __syncthreads();

  // Fragments (PTX ISA, mma.m16n8k32 .s8): lane = 4 g + t; A rows g, g + 8,
  // K bytes 4t..4t+3 and 16+4t..; B column g, the same K bytes; C rows g,
  // g + 8, columns 2t, 2t + 1.
  const int g = lane >> 2, t = lane & 3;
  int row_vox[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      row_vox[mt][h] = (warp * SY + 2 * mt + h) * SX + g;
  int acc[2][G::NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;

#pragma unroll 3
  for (int k0 = 0; k0 < G::KPAD; k0 += 32) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[mt][r] = a_word<CIN, COUT>(s_x, row_vox[mt][r & 1],
                                     k0 + 16 * (r >> 1) + 4 * t);
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
      const int8_t* p = s_w + (nt * 8 + g) * G::WK + k0 + 4 * t;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
    }
  }

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
          const int c = nt * 8 + 2 * t + j;
          y[o + c] = dequantize(acc[mt][nt][2 * h + j], m, scale, w_scale,
                                bias, c, COUT, relu_out, res, o + c);
        }
    }
}

// 1^3 layers: one thread per output, its input channels quantized and
// summed in int32.
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
  const float scale = __fmul_rn(m, kC127);
  int acc = 0;
  for (int ci = 0; ci < Cin; ++ci)
    acc += quantize(x[v * Cin + ci], scale, relu_in) * (int)wq[ci * Cout + c];
  y[i] = dequantize(acc, m, scale, w_scale, bias, c, Cout, relu_out, res, i);
}

template <int CIN, int COUT>
cudaError_t launch_tc(const float* x, const int8_t* w, const float* w_scale,
                      const float* bias, const float* absmax,
                      const float* res, float* y, int N, int D, int H, int W,
                      int relu_in, int relu_out, cudaStream_t s) {
  constexpr size_t smem = QGeo<CIN, COUT>::SMEM;
  static_assert(smem <= 48 * 1024, "K19's tile fits the default limit");
  const int tiles_x = (W + TX - 1) / TX, tiles_y = (H + TY - 1) / TY;
  const dim3 grid(tiles_x * tiles_y, (D + TZ - 1) / TZ, N);
  qconv3d_s8_kernel<CIN, COUT><<<grid, kThreads, smem, s>>>(
      x, w, w_scale, bias, absmax, res, y, D, H, W, relu_in, relu_out,
      tiles_x);
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

// x (N,D,H,W,Cin) float32; w (k^3 Cin, Cout) int8 in (tap, channel) rows;
// w_scale, bias (Cout) and absmax (N) float32; res (N,D,H,W,Cout) float32 or
// null; y (N,D,H,W,Cout) float32. All contiguous; k = 3 takes (Cin, Cout) in
// {(2,32), (32,32), (2,16), (16,16)}, k = 1 any widths.
extern "C" int ffn_qconv3d_s8(const float* x, const int8_t* w,
                              const float* w_scale, const float* bias,
                              const float* absmax, const float* res, float* y,
                              int N, int D, int H, int W, int Cin, int Cout,
                              int k, int relu_in, int relu_out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1) {
    const long long outputs = (long long)N * D * H * W * Cout;
    const int threads = 256;
    qconv1_s8_kernel<<<(unsigned)((outputs + threads - 1) / threads),
                       threads, 0, s>>>(x, w, w_scale, bias, absmax, res, y,
                                        outputs, (long long)D * H * W, Cin,
                                        Cout, relu_in, relu_out);
    return static_cast<int>(cudaGetLastError());
  }
  if (k != 3) return static_cast<int>(cudaErrorInvalidValue);
#define FFN_K19_CASE(CI, CO)                                                 \
  if (Cin == CI && Cout == CO)                                               \
    return static_cast<int>(launch_tc<CI, CO>(x, w, w_scale, bias, absmax,   \
                                              res, y, N, D, H, W, relu_in,   \
                                              relu_out, s));
  FFN_K19_CASE(2, 32)
  FFN_K19_CASE(32, 32)
  FFN_K19_CASE(2, 16)
  FFN_K19_CASE(16, 16)
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
