// K10 conv3d_wgrad_f32's body for the stack's 3^3 layers (conv3d_bwd.cu):
// dW[tap][ci][co] = sum_p relu?(x)[p + tap - 1][ci] g[p][co] and db[co] =
// sum_p g[p][co], g = dy [y > 0 if post_relu], a GEMM of (27 Cin) x Cout
// over the B 33^3 positions on float32 FMAs (Precision.HIGHEST). (Cin, Cout)
// in {(2,32), (32,32), (2,16), (16,16)}; other widths and the 1^3 layers
// stay on wgrad.cuh's body.
//
// Bound on the H100: a 32->32 layer at B=4 is 7.95 GFLOP (0.119 ms at 67
// TFLOP/s) against 18-28 MB (5-8 us at 3.35 TB/s): operations.
// Design (ops/conv3d.py's k10_geometry mirrors the plan):
// - A chunk is cy rows (y) of cx columns (x) of one z-plane of one sample.
//   Persistent CTAs (kW10Ctas at most, fixed: the chunk -> CTA assignment,
//   chunk c to CTA c mod ctas, depends on the shape alone) stage each chunk
//   once, by cp.async, in one of two stages (the next chunk lands while one
//   is summed): x's halo, three planes of cy + 2 rows of hx = cx + 2
//   voxels, zero outside the volume; g (and the mask y beside it) at the
//   chunk's positions v = ry hx + rx, zero in the two columns past cx. Each
//   thread then applies pre_relu (fmaxf) and the mask on its own landed
//   copies: the mask is read once a chunk, not once a tap.
// - Position v's x at tap (dz, dy, dx) sits at halo voxel v + (dz (cy + 2)
//   + dy) hx + dx: one fixed offset a tap, no bounds branch (the padding
//   columns read x times a zero g).
// - All 27 taps from one stage: a thread owns one tap x CB input channels x
//   8 output channels (CB = 4, or 2 at Cin 2): 32 (16) sums in registers
//   across the CTA's chunks; a position costs one float4 (float2) of x and
//   two float4 of g, shared loads, for 32 (16) FMAs. At 32->32 the 864
//   threads (27 warps, one tap a warp) cover the layer once; narrower
//   layers run kW10Threads / T0 groups of threads, group j taking
//   positions j, j + G, ..., summed at the end in group order. (8 x 8
//   tiles on 432 threads, and 3xTF32 mma.sync, were slower:
//   tools_torch/k10_variants.py, PERF.md.)
// - The bias: after each chunk's products, thread co < Cout of the first
//   warp adds g[v][co] over the chunk's positions in order.
// - Each CTA writes one row of float32 partials; stage 2 (wgrad.cuh's
//   wgrad_sum_kernel) sums the rows in row order. Every output's order of
//   sums is fixed by the shape: deterministic, no atomics.
// Measured (tools_torch/k10_variants.py --split, 32->32 pre+post relu at
// B=4, NVIDIA H100 80GB HBM3, 700 W): 304 device us (cuDNN's
// conv3d_weight 1467, wgrad.cuh's row body 1246); without the FMA loop 104,
// without the staging copies 304 (hidden): the FMA loop bounds it, at ~40%
// of the float32 rate over the whole call.

#pragma once

#include "conv16.cuh"

namespace {

constexpr int kW10Threads = 864;
constexpr int kW10Ctas = 132;  // one an H100 SM; fixed, not the card's

template <int CIN, int COUT>
struct W10Geo {
  static constexpr int CB = CIN == 2 ? 2 : 4;  // input channels a thread
  static constexpr int NCB = CIN / CB, NCO = COUT / 8;
  static constexpr int T0 = 27 * NCB * NCO;  // threads a group
  static constexpr int G = kW10Threads / T0;
  static_assert(G * T0 == kW10Threads, "K10: groups fill the CTA");
};

// Floats of a stage: x's halo (3 (cy + 2) hx voxels and two of slack, read
// only at the padding columns' positions) rounded to 4; g and, masked, y.
__host__ __device__ inline int w10_x_floats(int cy, int cx, int cin) {
  return ((3 * (cy + 2) * (cx + 2) + 2) * cin + 3) / 4 * 4;
}
__host__ __device__ inline int w10_stage_floats(int cy, int cx, int cin,
                                                int cout, bool masked) {
  return w10_x_floats(cy, cx, cin) + cy * (cx + 2) * cout * (masked ? 2 : 1);
}

// Shared bytes: two stages, or the groups' sums when that is more.
__host__ __device__ inline int w10_smem(int cy, int cx, int cin, int cout,
                                        bool masked) {
  const int stages = 2 * 4 * w10_stage_floats(cy, cx, cin, cout, masked);
  const int cb = cin == 2 ? 2 : 4;
  const int reduce = 4 * kW10Threads * cb * 8;
  return stages > reduce ? stages : reduce;
}

struct W10Plan {
  int cy, cx, ny, nx, ctas, smem;
  long long chunks;
};

// The chunk shape of least cost, rounds of chunks over the CTAs times a
// chunk's positions (cy (cx + 2)), ties to the larger chunk: full rows
// (cx = W) while one row fits, else the widest columns that fit one row.
// False if no chunk fits or the input is empty.
inline bool w10_plan(int N, int D, int H, int W, int cin, int cout,
                     bool masked, W10Plan* out) {
  bool found = false;
  long long best = 0;
  if ((long long)N * D * H * W == 0) return false;
  auto consider = [&](int cy, int cx) {
    const int smem = w10_smem(cy, cx, cin, cout, masked);
    if (smem > kSmemLimit) return;
    const int ny = (H + cy - 1) / cy, nx = (W + cx - 1) / cx;
    const long long chunks = (long long)N * D * ny * nx;
    const int ctas = (int)(chunks < kW10Ctas ? chunks : kW10Ctas);
    const long long cost = (chunks + ctas - 1) / ctas * cy * (cx + 2);
    if (!found || cost < best ||
        (cost == best && (long long)cy * cx > (long long)out->cy * out->cx)) {
      found = true;
      best = cost;
      *out = W10Plan{cy, cx, ny, nx, ctas, smem, chunks};
    }
  };
  for (int cy = 1; cy <= H; ++cy) consider(cy, W);
  if (!found)
    for (int cx = W - 1; cx >= 1 && !found; --cx) consider(1, cx);
  return found;
}

struct W10Args {
  int D, H, W, cy, cx, ny, nx, stage, gofs, mofs, pre_relu;
  long long chunks;
};

template <int CIN, int COUT>
__global__ void __launch_bounds__(kW10Threads, 1)
wgrad_tile_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  const float* __restrict__ ym, float* __restrict__ partial,
                  W10Args a) {
  using G = W10Geo<CIN, COUT>;
  constexpr int CB = G::CB;
  extern __shared__ __align__(16) float smem_f[];
  const int tid = threadIdx.x;
  const int grp = tid / G::T0, r = tid - grp * G::T0;
  const int tap = r / (G::NCB * G::NCO);
  const int cib = r / G::NCO % G::NCB, cob = r % G::NCO;
  const int hx = a.cx + 2, hy = a.cy + 2;
  const int tap_off = ((tap / 9) * hy + tap / 3 % 3) * hx + tap % 3;
  const bool masked = ym != nullptr;

  // Zero both stages once: a short chunk's rows past its own, and the
  // slack, then hold finite values only.
  for (int i = tid; i < 2 * a.stage; i += kW10Threads) smem_f[i] = 0.f;
  __syncthreads();

  // The copies of chunk c into stage st (the caller commits), and the fix
  // of this thread's own landed copies: the same index walk.
  constexpr int XC = CIN == 2 ? 1 : CIN / 4;   // copies a voxel
  constexpr int XB = CIN == 2 ? 8 : 16;        // bytes a copy
  constexpr int GC = COUT / 4;
  auto walk = [&](long long c, float* st, bool fix) {
    const int n = (int)(c / ((long long)a.D * a.ny * a.nx));
    const int rest = (int)(c % ((long long)a.D * a.ny * a.nx));
    const int z = rest / (a.ny * a.nx);
    const int y0 = rest / a.nx % a.ny * a.cy, x0 = rest % a.nx * a.cx;
    const int cyc = min(a.cy, a.H - y0), cxc = min(a.cx, a.W - x0);
    const int hyc = cyc + 2;
    const uint32_t st_s = static_cast<uint32_t>(__cvta_generic_to_shared(st));
    // x's halo: voxel (dz, ry, rx) = x at (z + dz - 1, y0 - 1 + ry,
    // x0 - 1 + rx).
    for (int i = tid; i < 3 * hyc * hx * XC; i += kW10Threads) {
      const int vox = i / XC, c4 = (i - vox * XC) * 4;
      const int dz = vox / (hyc * hx), ry = vox / hx % hyc, rx = vox % hx;
      const int gz = z + dz - 1, gy = y0 - 1 + ry, gx = x0 - 1 + rx;
      const bool valid = gz >= 0 && gz < a.D && gy >= 0 && gy < a.H &&
                         gx >= 0 && gx < a.W;
      const int at = ((dz * hy + ry) * hx + rx) * CIN + c4;
      if (fix) {
        if (valid && a.pre_relu)
#pragma unroll
          for (int j = 0; j < (CIN == 2 ? 2 : 4); ++j)
            st[at + j] = fmaxf(st[at + j], 0.f);
        continue;
      }
      const size_t src =
          valid ? ((((size_t)n * a.D + gz) * a.H + gy) * a.W + gx) * CIN + c4
                : 0;
      cp_async<XB>(st_s + 4 * at, x + src, valid);
    }
    // g and the mask at positions v = ry hx + rx, zero past the chunk.
    for (int i = tid; i < cyc * hx * GC; i += kW10Threads) {
      const int v = i / GC, c4 = (i - v * GC) * 4;
      const int ry = v / hx, rx = v - ry * hx;
      const bool valid = rx < cxc;
      const int at = a.gofs + v * COUT + c4;
      if (fix) {
        if (valid && masked)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (!(st[a.mofs - a.gofs + at + j] > 0.f)) st[at + j] = 0.f;
        continue;
      }
      const size_t src =
          valid ? ((((size_t)n * a.D + z) * a.H + y0 + ry) * a.W + x0 + rx) *
                          COUT + c4
                : 0;
      cp_async<16>(st_s + 4 * at, dy + src, valid);
      if (masked)
        cp_async<16>(st_s + 4 * (a.mofs - a.gofs + at), ym + src, valid);
    }
    return cyc * hx;  // positions
  };

  float acc[CB][8], bacc = 0.f;
#pragma unroll
  for (int i = 0; i < CB; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  long long c = blockIdx.x;
  if (c < a.chunks) walk(c, smem_f, false);
  cp_async_commit();
  for (int k = 0; c < a.chunks; c += gridDim.x, ++k) {
    float* st = smem_f + (k & 1) * a.stage;
    cp_async_wait<0>();
    const int nv = walk(c, st, true);
    __syncthreads();  // landed and fixed; the other stage is free
    if (c + gridDim.x < a.chunks) walk(c + gridDim.x, smem_f + ((k + 1) & 1) *
                                                             a.stage, false);
    cp_async_commit();
    const float* xs = st + tap_off * CIN + cib * CB;
    const float* gs = st + a.gofs + cob * 8;
#pragma unroll 2
    for (int v = grp; v < nv; v += G::G) {
      float xv[CB];
      if constexpr (CB == 4) {
        const float4 f = *reinterpret_cast<const float4*>(xs + v * CIN);
        xv[0] = f.x; xv[1] = f.y; xv[2] = f.z; xv[3] = f.w;
      } else {
        const float2 f = *reinterpret_cast<const float2*>(xs + v * CIN);
        xv[0] = f.x; xv[1] = f.y;
      }
      const float4 g0 = *reinterpret_cast<const float4*>(gs + v * COUT);
      const float4 g1 = *reinterpret_cast<const float4*>(gs + v * COUT + 4);
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int i = 0; i < CB; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], gv[j], acc[i][j]);
    }
    if (tid < COUT)
      for (int v = 0; v < nv; ++v) bacc += st[a.gofs + v * COUT + tid];
  }
  __syncthreads();  // every stage read: shared memory holds the sums now

  float* out = partial + (size_t)blockIdx.x * (27 * CIN * COUT + COUT);
  const int ci0 = cib * CB, co0 = cob * 8;
  if constexpr (G::G == 1) {
#pragma unroll
    for (int i = 0; i < CB; ++i) {
      float* o = out + ((size_t)tap * CIN + ci0 + i) * COUT + co0;
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(o + 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  } else {
    // The groups' sums through shared memory, added in group order.
    float* red = smem_f;  // [group][T0][CB * 8]
#pragma unroll
    for (int i = 0; i < CB; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[tid * CB * 8 + i * 8 + j] = acc[i][j];
    __syncthreads();
    if (grp == 0) {
      for (int e = 0; e < CB * 8; ++e) {
        float s = 0.f;
        for (int q = 0; q < G::G; ++q) s += red[(q * G::T0 + r) * CB * 8 + e];
        out[((size_t)tap * CIN + ci0 + e / 8) * COUT + co0 + e % 8] = s;
      }
    }
  }
  if (tid < COUT) out[27 * CIN * COUT + tid] = bacc;
}

}  // namespace
