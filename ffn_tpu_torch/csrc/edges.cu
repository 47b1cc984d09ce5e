// K22 edges_sobel and K23 edges_blur: the device edge mask of
// ffn_tpu/ops/image.py:71-98 (edges_jax), the Sobel gradient magnitude of
// a 3-d float32 image, its Gaussian blur (67 taps at sigma 49/6) and the
// mask edges > blur. Every pass is _conv1d's (image.py:57-68): numpy's
// whole-sample reflect padding (period 2(n - 1), repeated for pads longer
// than the axis; n = 1 maps every index to 0), then
// out = 0 + k0 x[j - r] + k1 x[j - r + 1] + ... in tap order, each product
// and sum rounded on its own (__fmul_rn, __fadd_rn), so both kernels equal
// the plain version (ops/image.py, edges_plain) bit for bit.
//
// K22: for each gradient axis a = 0, 1, 2, three 3-tap passes along axes
// 0, 1, 2 ([-1, 0, 1] along a, [1, 2, 1] along the others, the middle 0
// tap kept), grad_sq = 0 + g0^2 + g1^2 + g2^2, edges = sqrt(grad_sq)
// (__fsqrt_rn). Reflect padding commutes with passes along the other
// axes, so one tile loaded with reflected indices and a one-voxel halo
// runs all nine passes in shared memory. Bound on the H100: operations
// (61 a voxel against 8 bytes).
//
// K23: one pass of the 67 host-computed taps along one axis, the volume
// seen as (outer, n, inner); on the last axis it writes the bool mask
// edges > blur instead of the blur. A block stages its line segments and
// their reflected halo in shared memory; each output sums its taps there.
// Bound: operations (134 a voxel and pass against 8-9 bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// numpy's mode="reflect" index for i in [-pad, n + pad).
__device__ inline int reflect_index(int i, int n) {
  if (n == 1) return 0;
  const int p = 2 * (n - 1);
  i %= p;
  if (i < 0) i += p;
  return i < n ? i : p - i;
}

__device__ inline float tap3(float t0, float t1, float t2, float a, float b,
                             float c) {
  return __fadd_rn(__fadd_rn(__fadd_rn(0.f, __fmul_rn(t0, a)),
                             __fmul_rn(t1, b)),
                   __fmul_rn(t2, c));
}

// K22's tile: SZ x SY x SX outputs, 256 threads, kPer outputs a thread.
constexpr int SZ = 8, SY = 8, SX = 32, kSobelThreads = 256;
constexpr int IY = SY + 2, IX = SX + 2;
constexpr int kPer = SZ * SY * SX / kSobelThreads;

__global__ void __launch_bounds__(kSobelThreads)
    sobel_kernel(const float* __restrict__ x, float* __restrict__ edges,
                 int D, int H, int W) {
  __shared__ float in[(SZ + 2) * IY * IX];   // the tile and its halo
  __shared__ float pz[SZ * IY * IX];         // after the pass along axis 0
  __shared__ float py[SZ * SY * IX];         // after the pass along axis 1
  const int z0 = blockIdx.z * SZ, y0 = blockIdx.y * SY, x0 = blockIdx.x * SX;
  for (int e = threadIdx.x; e < (SZ + 2) * IY * IX; e += kSobelThreads) {
    const int i = e % IX, j = (e / IX) % IY, k = e / (IX * IY);
    const int gz = reflect_index(z0 + k - 1, D);
    const int gy = reflect_index(y0 + j - 1, H);
    const int gx = reflect_index(x0 + i - 1, W);
    in[e] = x[((size_t)gz * H + gy) * W + gx];
  }
  float grad_sq[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) grad_sq[q] = 0.f;
  for (int axis = 0; axis < 3; ++axis) {
    __syncthreads();   // `in` loaded; the last axis's reads of pz done
    float t0 = axis == 0 ? -1.f : 1.f, t1 = axis == 0 ? 0.f : 2.f;
    for (int e = threadIdx.x; e < SZ * IY * IX; e += kSobelThreads) {
      const int r = e % (IY * IX), k = e / (IY * IX);
      pz[e] = tap3(t0, t1, 1.f, in[k * IY * IX + r],
                   in[(k + 1) * IY * IX + r], in[(k + 2) * IY * IX + r]);
    }
    __syncthreads();
    t0 = axis == 1 ? -1.f : 1.f;
    t1 = axis == 1 ? 0.f : 2.f;
    for (int e = threadIdx.x; e < SZ * SY * IX; e += kSobelThreads) {
      const int i = e % IX, j = (e / IX) % SY, k = e / (IX * SY);
      const float* p = pz + (k * IY + j) * IX + i;
      py[e] = tap3(t0, t1, 1.f, p[0], p[IX], p[2 * IX]);
    }
    __syncthreads();
    t0 = axis == 2 ? -1.f : 1.f;
    t1 = axis == 2 ? 0.f : 2.f;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = threadIdx.x + q * kSobelThreads;
      const int i = e % SX, row = e / SX;   // row = k * SY + j
      const float* p = py + row * IX + i;
      const float g = tap3(t0, t1, 1.f, p[0], p[1], p[2]);
      grad_sq[q] = __fadd_rn(grad_sq[q], __fmul_rn(g, g));
    }
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = threadIdx.x + q * kSobelThreads;
    const int i = e % SX, j = (e / SX) % SY, k = e / (SX * SY);
    const int gz = z0 + k, gy = y0 + j, gx = x0 + i;
    if (gz < D && gy < H && gx < W)
      edges[((size_t)gz * H + gy) * W + gx] = __fsqrt_rn(grad_sq[q]);
  }
}

constexpr int kBlurThreads = 256;

// Tiles of ta positions along the axis by ti inner positions (ti = 1 on
// the last axis, else 32), flattened over (outer, axis tiles, inner tiles).
__global__ void __launch_bounds__(kBlurThreads)
    blur_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                int ntaps, const float* __restrict__ edges,
                float* __restrict__ out, uint8_t* __restrict__ mask, int n,
                long long inner, int ta, int ti, long long inner_tiles,
                long long axis_tiles) {
  extern __shared__ float smem[];
  float* tp = smem;
  float* tile = smem + ntaps;
  const int r = ntaps / 2;
  const long long b = blockIdx.x;
  const long long i0 = (b % inner_tiles) * ti;
  const int a0 = static_cast<int>((b / inner_tiles) % axis_tiles) * ta;
  const long long o = b / (inner_tiles * axis_tiles);
  for (int t = threadIdx.x; t < ntaps; t += kBlurThreads) tp[t] = taps[t];
  const int rows = ta + ntaps - 1;
  for (int e = threadIdx.x; e < rows * ti; e += kBlurThreads) {
    const int a = e / ti, i = e % ti;
    const long long gi = i0 + i;
    const int ga = reflect_index(a0 + a - r, n);
    tile[e] = gi < inner ? x[((size_t)o * n + ga) * inner + gi] : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ta * ti; e += kBlurThreads) {
    const int a = e / ti, i = e % ti;
    const long long gi = i0 + i;
    if (a0 + a >= n || gi >= inner) continue;
    const float* p = tile + a * ti + i;
    float acc = 0.f;
    for (int t = 0; t < ntaps; ++t)
      acc = __fadd_rn(acc, __fmul_rn(tp[t], p[t * ti]));
    const size_t idx = ((size_t)o * n + a0 + a) * inner + gi;
    if (mask)
      mask[idx] = edges[idx] > acc;
    else
      out[idx] = acc;
  }
}

}  // namespace

// x, edges (D, H, W) float32, contiguous.
extern "C" int ffn_edges_sobel(const float* x, float* edges, int D, int H,
                               int W, void* stream) {
  const dim3 grid((W + SX - 1) / SX, (H + SY - 1) / SY, (D + SZ - 1) / SZ);
  sobel_kernel<<<grid, kSobelThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, edges, D, H, W);
  return static_cast<int>(cudaGetLastError());
}

// x (outer, n, inner) float32, contiguous; taps (ntaps, odd) float32 on
// the device. Writes out (the blur), or with `mask` non-null the bytes
// edges > blur (edges shaped as x) and not `out`.
extern "C" int ffn_edges_blur(const float* x, const float* taps, int ntaps,
                              const float* edges, float* out, uint8_t* mask,
                              long long outer, int n, long long inner,
                              void* stream) {
  const int ti = inner == 1 ? 1 : 32;
  const int ta = inner == 1 ? kBlurThreads : 64;
  const long long inner_tiles = (inner + ti - 1) / ti;
  const long long axis_tiles = (n + ta - 1) / ta;
  const long long blocks = outer * axis_tiles * inner_tiles;
  const size_t bytes = sizeof(float) * (ntaps + (ta + ntaps - 1) * ti);
  if (ntaps < 1 || !(ntaps & 1) || bytes > 48 * 1024 || blocks < 1 ||
      blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  blur_kernel<<<static_cast<unsigned>(blocks), kBlurThreads, bytes,
                static_cast<cudaStream_t>(stream)>>>(
      x, taps, ntaps, edges, out, mask, n, inner, ta, ti, inner_tiles,
      axis_tiles);
  return static_cast<int>(cudaGetLastError());
}
