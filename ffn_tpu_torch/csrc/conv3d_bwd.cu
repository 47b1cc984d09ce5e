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
// The relu gradient at 0 is 0. K10: K18's two-stage deterministic body
// (wgrad.cuh) on float inputs.
//
// K9 on the H100: float32 FMAs on the CUDA cores (TF32 would not keep its
// 1e-4 check), so its bound is arithmetic: a 3^3 32->32 layer at B=4 is
// 7.95 GFLOP, 0.119 ms at 67 TFLOP/s, against 18-46 MB (5-14 us) of bytes.
// dx is the SAME convolution of g with W'[tap'][co][ci] = W[26 - tap'][ci]
// [co]. What holds an FMA-bound kernel back is all that is not an FMA:
// padded work, staging, shared-memory traffic per FMA, barriers. The
// design (tools_torch/dgrad_variants.py times the options):
// - Tiles of kTilePos positions q = yP+x of one z-plane of one sample
//   (K15's geometry, conv16.cuh, longer: zero columns after each row, P =
//   W + 1 rounded up to even, make each tap one fixed row offset; 5.5%
//   padded slots at 33^3, the old 3x8x4 box 24%) and kCiT x CIG dx
//   channels, a block of them (the slowest index of the tile list) when Cin
//   is wider. A tile's halo is three planes of three row bands (dy = 0, 1,
//   2) of kTilePos + 2 rows, S = min(P, kTilePos + 2) apart: one run of 2P
//   + kTilePos + 2 rows while they overlap, three bands when rows are wider
//   than a tile, so any W fits.
// - Persistent CTAs of kRuns x CIG threads, one an SM at 32 channels, stage
//   W' once, as rows [co][tap'][ci] of the CTA's dx channels, where a block
//   of 32 g channels fits (27 * 32 * 32 * 4 = 110.6 KB at 32->32); wider
//   layers restage it for each block of g channels of a tile.
// - g's halo comes in chunks of g channels, channel-major ([c][dz][row]),
//   by 4-byte cp.async, consecutive threads on consecutive channels of a
//   voxel; with post_relu, y is staged beside g and each thread zeroes its
//   own copies of g where y is not > 0 once they land.
// - Thread (run, cig) owns kRun = 4 consecutive positions x kCiT channels:
//   for each g channel and tap row (dz, dy) it loads the kRun + 2 rows of
//   its window once, as float2s (every offset is even), and reuses them
//   over the three dx taps, a float4 of W' a tap: 6 shared loads per 48
//   FMAs (the old loop 11 per 72), 24 warps an SM to hide their latency
//   (runs of 8, 12 warps, lost on the masked layers); a warp's 4 runs read
//   distinct banks, its 8 channel groups one 128-byte row of W'.
// - Epilogue: the pre_relu mask from x and `accum`, by float4 where the
//   channels allow.
// Measured on an H100 (dgrad_variants.py --split, 32->32 at B=4): the FMA
// loop alone ~60% of the float32 rate (its shared loads and the FMAs'
// operand traffic); staging and the epilogue add ~40 us, ~40 more with
// post_relu (y staged and applied) and pre_relu (x and accum read).
// Each output is summed in one order (g channels, tap rows, dx taps)
// whatever the tile list, grid or chunk size:
// deterministic, and a sample's result does not depend on N.
// ops/conv3d.py's k9_geometry mirrors K9Plan. 1^3 layers (conv_lom): one
// thread per dx entry, the Cout products summed in order.

#include "wgrad.cuh"

namespace {

constexpr int kRun = 4;                 // consecutive positions a thread
constexpr int kRuns = 96;               // runs a tile
constexpr int kTilePos = kRun * kRuns;  // positions a tile
constexpr int kCiT = 4;                 // dx channels a thread
constexpr int kGBlock = 32;             // g channels of W' at most
constexpr int kChunkMax = 16;           // g channels a stage at most
constexpr int kSmemTwo = 115712;        // each of two CTAs on an H100 SM

// The host geometry of a 3^3 layer (ops/conv3d.py's k9_geometry): cig
// groups of kCiT dx channels a tile (threads = kRuns * cig); pitch P, band
// stride S, halo rows R a plane, tiles a plane; dx channel blocks (the
// slowest tile index); g channels of W' at a time (gb) and a stage (cc, a
// power of two); floats of a W' row (g channel) and of the stage; shared
// bytes. The first (gb, cc), largest gb first, whose W' and stage fit a
// CTA: half an SM when cig < 8, so two share it, else the whole. Every
// shape fits: gb = cc = 1 takes at most 4 (27 * 32 + 4 + 6 * 1158) bytes,
// 31.3 KB (cip <= 32, R <= 3 (kTilePos + 2)), so the search ends there.
struct K9Plan {
  int cig, threads, P, S, R, per_plane, ci_blocks, gb, cc, w_row, stage;
  long long tiles;
  size_t smem;
};

// The largest power of two below v >= 2.
inline int below_pow2(int v) {
  int p = 1;
  while (2 * p < v) p *= 2;
  return p;
}

inline K9Plan k9_plan(int N, int D, int H, int W, int Cin, int Cout,
                      bool masked) {
  K9Plan p{};
  p.cig = Cin > 16 ? 8 : Cin > 8 ? 4 : Cin > 4 ? 2 : 1;
  const int cip = kCiT * p.cig;
  p.threads = kRuns * p.cig;
  p.P = (W + 2) & ~1;  // even, as kTilePos: every window 8-byte aligned
  p.S = p.P < kTilePos + 2 ? p.P : kTilePos + 2;
  p.R = 2 * p.S + kTilePos + 2;
  p.per_plane = (H * p.P - 1 + kTilePos - 1) / kTilePos;
  p.ci_blocks = (Cin + cip - 1) / cip;
  p.tiles = (long long)p.ci_blocks * N * D * p.per_plane;
  p.w_row = 27 * cip + 4;
  const size_t budget = p.cig < 8 ? kSmemTwo : kSmemLimit;
  for (int gb = Cout < kGBlock ? Cout : kGBlock;; gb = below_pow2(gb))
    for (int cc = kChunkMax; cc >= 1; cc /= 2) {
      if (cc > gb) continue;
      const int stage = (cc * 3 * p.R * (masked ? 2 : 1) + 3) / 4 * 4;
      const size_t smem = 4 * ((size_t)gb * p.w_row + stage);
      if (smem <= budget || gb == 1) {
        p.gb = gb;
        p.cc = cc;
        p.stage = stage;
        p.smem = smem;
        return p;
      }
    }
}

// A unit of a CTA's work: chunk k (g channels k cc ..) of tile `tile`.
struct Item {
  long long tile;
  int k;
};

struct K9Args {
  int D, H, W, Cin, Cout, P, S, R, per_plane, gb, cc, lcc, nk, w_row, stage,
      vec;  // lcc: log2(cc)
  long long tiles, per_block;  // per_block: tiles of one dx channel block
};

// Issues the copies of chunk it.k of tile it.tile: st[(c * 3 + dz) * R +
// h] = g at channel k cc + c of plane z + dz - 1, position q0 + (b - 1) P -
// 1 + h - b S (band b = min(h / S, 2)), zero outside the volume and in the
// zero columns; with y, y's beside it (st + stage / 2). Consecutive threads
// take consecutive channels of a voxel (cc a power of two), so a warp reads
// 32 / cc voxels' 4 cc bytes each. The caller commits.
template <int THREADS>
__device__ __forceinline__ void stage_chunk(float* st, const float* dy,
                                            const float* ym, Item it,
                                            const K9Args& a) {
  const long long r = it.tile % a.per_block;
  const int n = (int)(r / ((long long)a.D * a.per_plane));
  const int z = (int)(r / a.per_plane % a.D);
  const int q0 = (int)(r % a.per_plane) * kTilePos;
  const int c0 = it.k * a.cc;
  const int cn = min(a.cc, a.Cout - c0);
  const int hp = a.H * a.P, plane = 3 * a.R;
  const uint32_t st_s = static_cast<uint32_t>(__cvta_generic_to_shared(st));
  for (int i = threadIdx.x; i < a.R * a.cc; i += THREADS) {
    const int h = i >> a.lcc, c = i & (a.cc - 1);
    if (c >= cn) continue;
    const int b = min(h / a.S, 2);
    const int q = q0 + (b - 1) * a.P - 1 + h - b * a.S;
    const bool in_plane = q >= 0 && q < hp;
    const int gy = in_plane ? q / a.P : 0, gx = q - gy * a.P;
    const bool in_row = in_plane && gx < a.W;
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
      const int zz = z + dz - 1;
      const bool valid = in_row && zz >= 0 && zz < a.D;
      const size_t src =
          valid ? ((((size_t)n * a.D + zz) * a.H + gy) * a.W + gx) * a.Cout +
                      c0 + c
                : 0;
      const uint32_t dst = st_s + 4 * (c * plane + dz * a.R + h);
      cp_async<4>(dst, dy + src, valid);
      if (ym != nullptr) cp_async<4>(dst + 2 * a.stage, ym + src, valid);
    }
  }
}

template <int CIG>
__global__ void __launch_bounds__(kRuns * CIG, 1)
conv3d_dgrad_kernel(const float* __restrict__ dy, const float* __restrict__ ym,
                    const float* __restrict__ xm,
                    const float* __restrict__ wt,
                    const float* __restrict__ accum, float* __restrict__ dx,
                    K9Args a) {
  constexpr int THREADS = kRuns * CIG, CIP = kCiT * CIG;
  extern __shared__ __align__(16) float smem_f[];
  float* s_w = smem_f;                     // W' [gb][w_row]: [tap'][ci]
  float* st = smem_f + a.gb * a.w_row;     // the stage: a.stage floats
  const int tid = threadIdx.x, run = tid / CIG, cig = tid % CIG;
  const int R = a.R;
  int zy_off[9];  // tap row (dz, dy)'s first row in a channel's stage
#pragma unroll
  for (int zy = 0; zy < 9; ++zy) zy_off[zy] = (zy / 3) * R + (zy % 3) * a.S;

  auto next = [&](Item& it) {
    if (++it.k == a.nk) {
      it.k = 0;
      it.tile += gridDim.x;
    }
  };
  float acc[kRun][kCiT];
  long long w_key = -1;  // the W' block staged: dx block * nk + g block
  for (Item it{blockIdx.x, 0}; it.tile < a.tiles; next(it)) {
    stage_chunk<THREADS>(st, dy, ym, it, a);
    cp_async_commit();
    const long long cib = it.tile / a.per_block;
    const int gbi = it.k * a.cc / a.gb;
    if (cib * a.nk + gbi != w_key) {
      // W'[c][tap'][ci] = W[26 - tap'][ci][c], zero past Cin and Cout: 8
      // consecutive c (one 32-byte read) of 4 ci a warp; the row pad puts
      // them on distinct banks.
      w_key = cib * a.nk + gbi;
      const int ci0 = (int)cib * CIP, g0 = gbi * a.gb;
      for (int i = tid; i < (a.gb + 7) / 8 * 8 * 27 * CIP; i += THREADS) {
        const int c8 = i % 8, ci = (i / 8) % CIP, rest = i / (8 * CIP);
        const int tap = rest % 27, c = (rest / 27) * 8 + c8;
        if (c >= a.gb) continue;
        float v = 0.f;
        if (ci0 + ci < a.Cin && g0 + c < a.Cout)
          v = wt[((size_t)(26 - tap) * a.Cin + ci0 + ci) * a.Cout + g0 + c];
        s_w[c * a.w_row + tap * CIP + ci] = v;
      }
    }
    cp_async_wait<0>();
    const int c0 = it.k * a.cc, cn = min(a.cc, a.Cout - c0), plane = 3 * R;
    if (ym != nullptr) {  // this thread's own copies (stage_chunk's)
      const float* sy = st + a.stage / 2;
      for (int i = tid; i < R * a.cc; i += THREADS) {
        const int h = i >> a.lcc, c = i & (a.cc - 1);
        if (c >= cn) continue;
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
          const int j = c * plane + dz * R + h;
          if (!(sy[j] > 0.f)) st[j] = 0.f;
        }
      }
    }
    __syncthreads();
    if (it.k == 0) {
#pragma unroll
      for (int p = 0; p < kRun; ++p)
#pragma unroll
        for (int j = 0; j < kCiT; ++j) acc[p][j] = 0.f;
    }
    const float* sg = st + run * kRun;
    const float* sw = s_w + (c0 - gbi * a.gb) * a.w_row + cig * kCiT;
#pragma unroll 1
    for (int c = 0; c < cn; ++c) {
      const float* gc = sg + c * plane;
      const float* wc = sw + c * a.w_row;
#pragma unroll
      for (int zy = 0; zy < 9; ++zy) {
        const float* gw = gc + zy_off[zy];
        float win[kRun + 2];
#pragma unroll
        for (int i = 0; i < kRun + 2; i += 2) {
          const float2 v = *reinterpret_cast<const float2*>(gw + i);
          win[i] = v.x;
          win[i + 1] = v.y;
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(wc + (zy * 3 + dx) * CIP);
#pragma unroll
          for (int p = 0; p < kRun; ++p) {
            acc[p][0] = fmaf(win[p + dx], w4.x, acc[p][0]);
            acc[p][1] = fmaf(win[p + dx], w4.y, acc[p][1]);
            acc[p][2] = fmaf(win[p + dx], w4.z, acc[p][2]);
            acc[p][3] = fmaf(win[p + dx], w4.w, acc[p][3]);
          }
        }
      }
    }
    __syncthreads();  // the stage is free
    if (it.k == a.nk - 1) {
      // dx = acc [x > 0] + accum at the thread's positions and channels.
      const long long r = it.tile % a.per_block;
      const int n = (int)(r / ((long long)a.D * a.per_plane));
      const int z = (int)(r / a.per_plane % a.D);
      const int ci = (int)cib * CIP + cig * kCiT;
      const int q = (int)(r % a.per_plane) * kTilePos + run * kRun;
      int gy = q / a.P, gx = q - gy * a.P;
      const size_t plane0 = ((size_t)n * a.D + z) * a.H * a.W;
#pragma unroll
      for (int p = 0; p < kRun; ++p) {
        if (gy < a.H && gx < a.W && ci < a.Cin) {
          const size_t o = (plane0 + (size_t)gy * a.W + gx) * a.Cin + ci;
          float v[kCiT] = {acc[p][0], acc[p][1], acc[p][2], acc[p][3]};
          if (a.vec) {
            if (xm != nullptr) {
              const float4 m = *reinterpret_cast<const float4*>(xm + o);
              const float mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
              for (int j = 0; j < kCiT; ++j)
                if (!(mv[j] > 0.f)) v[j] = 0.f;
            }
            if (accum != nullptr) {
              const float4 e = *reinterpret_cast<const float4*>(accum + o);
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
              if (ci + j >= a.Cin) break;
              if (xm != nullptr && !(xm[o + j] > 0.f)) v[j] = 0.f;
              if (accum != nullptr) v[j] += accum[o + j];
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
  }
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

template <int CIG>
cudaError_t launch_dgrad(const float* dy, const float* y, const float* x,
                         const float* w, const float* accum, float* dx,
                         const K9Plan& p, K9Args a, cudaStream_t s) {
  auto kernel = conv3d_dgrad_kernel<CIG>;
  unsigned grid = 0;
  const cudaError_t err =
      persistent_grid(kernel, p.threads, p.smem, p.tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, p.threads, p.smem, s>>>(dy, y, x, w, accum, dx, a);
  return cudaGetLastError();
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
  const K9Plan p = k9_plan(N, D, H, W, Cin, Cout, y != nullptr);
  if (p.tiles == 0) return static_cast<int>(cudaSuccess);
  auto aligned = [](const float* q) {
    return q == nullptr || (reinterpret_cast<size_t>(q) & 15) == 0;
  };
  // Whole float4s of x, accum and dx in the epilogue.
  const int vec = Cin % 4 == 0 && aligned(x) && aligned(accum) && aligned(dx);
  const K9Args a{D, H, W, Cin, Cout, p.P, p.S, p.R, p.per_plane, p.gb, p.cc,
                 __builtin_ctz(p.cc), (Cout + p.cc - 1) / p.cc, p.w_row,
                 p.stage, vec, p.tiles, (long long)N * D * p.per_plane};
  cudaError_t err;
  switch (p.cig) {
    case 8: err = launch_dgrad<8>(dy, y, x, w, accum, dx, p, a, s); break;
    case 4: err = launch_dgrad<4>(dy, y, x, w, accum, dx, p, a, s); break;
    case 2: err = launch_dgrad<2>(dy, y, x, w, accum, dx, p, a, s); break;
    default: err = launch_dgrad<1>(dy, y, x, w, accum, dx, p, a, s);
  }
  return static_cast<int>(err);
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
