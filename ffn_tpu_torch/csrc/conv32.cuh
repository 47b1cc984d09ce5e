// The float32 plane-position tiles that K1 conv3d_ndhwc_f32 (conv3d.cu) and
// K9 conv3d_dgrad_f32 (conv3d_bwd.cu) share: both are a SAME 3^3
// convolution on float32 FMAs (Precision.HIGHEST: no tensor cores), K1 of
// x with W, K9 of g with W flipped. Here "in" is the tensor the tile stages
// (K1 x, Cx channels; K9 g, the layer's Cout) and "out" the one it writes
// (K1 y, Cy channels; K9 dx, the layer's Cin). Each kernel brings an Op: its
// weight rows, the fix of each thread's landed copies (K1 pre_relu, K9 the
// y mask) and its epilogue.
//
// - Tiles of kTilePos positions q = yP+x of one z-plane of one sample (K15's
//   geometry, conv16.cuh, longer: zero columns after each row, P = W + 1
//   rounded up to even, make each tap one fixed row offset; 5.5% padded
//   slots at 33^3) and kCiT x CIG out channels, a block of them (the
//   slowest index of the tile list) when the out channels are wider. A
//   tile's halo is three planes of three row bands (dy = 0, 1, 2) of
//   kTilePos + 2 rows, S = min(P, kTilePos + 2) apart: one run of 2P +
//   kTilePos + 2 rows while they overlap, three bands when rows are wider
//   than a tile, so any W fits.
// - Persistent CTAs of kRuns x CIG threads stage the weights once, as rows
//   [in channel][tap][out channel] of the CTA's out channels, where a block
//   of kGBlock in channels fits (27 * 32 * 32 * 4 = 110.6 KB at 32->32);
//   wider layers restage them for each block of in channels of a tile.
// - The in tensor's halo comes in chunks of in channels, channel-major
//   ([c][dz][row]), by 4-byte cp.async, consecutive threads on consecutive
//   channels of a voxel; a mask tensor (K9's y) may be staged beside it.
//   What the copies cost is their address arithmetic's instructions, not
//   their latency (K1 on two stages, the next chunk landing while one is
//   summed, was slower), so K1 finds each halo row's voxel once a tile, in
//   a table of R ints beside the stage (K9 on the table: faster unmasked,
//   slower masked; it finds the voxel for each copy).
// - Thread (run, cig) owns kRun = 4 consecutive positions x kCiT out
//   channels: for each in channel and tap row it loads the kRun + 2 rows
//   of its window once, as float2s (every offset is even), and reuses them
//   over the three dx taps, a float4 of weights a tap: 6 shared loads per
//   48 FMAs; a warp's 4 runs read distinct banks, its 8 channel groups one
//   128-byte row of weights.
// Each output is summed in one order (in channels, then the taps in the
// kernel's order, tile_fma) whatever the tile list, grid, channel blocks or
// chunk size: deterministic, and a sample's result does not depend on N.
// ops/conv3d.py's k9_geometry and k1_geometry mirror the plans.

#pragma once

#include <mutex>

#include "conv16.cuh"

namespace {

constexpr int kRun = 4;                 // consecutive positions a thread
constexpr int kRuns = 96;               // runs a tile
constexpr int kTilePos = kRun * kRuns;  // positions a tile
constexpr int kCiT = 4;                 // out channels a thread
constexpr int kGBlock = 32;             // in channels of weights at most
constexpr int kChunkMax = 16;           // in channels a stage at most
constexpr int kSmemTwo = 115712;        // each of two CTAs on an H100 SM
constexpr int kSmemSM = 233472;         // an SM's; each CTA reserves 1 KB

// A plan of a 3^3 layer: cig groups of kCiT out channels a tile (threads =
// kRuns * cig); pitch P, band stride S, halo rows R a plane, tiles a plane;
// out channel blocks (the slowest tile index); in channels of weights at a
// time (gb) and a stage (cc, a power of two); floats of a weight row (in
// channel) and of the stage; shared bytes.
struct TilePlan {
  int cig, threads, P, S, R, per_plane, out_blocks, gb, cc, w_row, stage;
  long long tiles;
  size_t smem;
};

// The largest power of two below v >= 2.
inline int below_pow2(int v) {
  int p = 1;
  while (2 * p < v) p *= 2;
  return p;
}

// cig by the out width: 8 groups (24 warps) from 17 channels on.
inline int tile_cig(int Cy) {
  return Cy > 16 ? 8 : Cy > 8 ? 4 : Cy > 4 ? 2 : 1;
}

// The plan with cig groups: the first (gb, cc), largest gb first, whose
// weights and stage (twice the stage with a mask tensor; the R ints of the
// halo table with `table`) fit `budget`. Every shape fits 31.3 KB: gb = cc
// = 1 takes at most 4 (27 * 32 + 4 + 6 * 1158) bytes (cip <= 32, R <= 3
// (kTilePos + 2); the table instead of the mask), so the search ends there.
inline TilePlan tile_plan(int N, int D, int H, int W, int Cy, int Cx,
                          bool masked, int cig, size_t budget,
                          bool table = false) {
  TilePlan p{};
  p.cig = cig;
  const int cip = kCiT * p.cig;
  p.threads = kRuns * p.cig;
  p.P = (W + 2) & ~1;  // even, as kTilePos: every window 8-byte aligned
  p.S = p.P < kTilePos + 2 ? p.P : kTilePos + 2;
  p.R = 2 * p.S + kTilePos + 2;
  p.per_plane = (H * p.P - 1 + kTilePos - 1) / kTilePos;
  p.out_blocks = (Cy + cip - 1) / cip;
  p.tiles = (long long)p.out_blocks * N * D * p.per_plane;
  p.w_row = 27 * cip + 4;
  for (int gb = Cx < kGBlock ? Cx : kGBlock;; gb = below_pow2(gb))
    for (int cc = kChunkMax; cc >= 1; cc /= 2) {
      if (cc > gb) continue;
      const int stage = (cc * 3 * p.R * (masked ? 2 : 1) + 3) / 4 * 4;
      const size_t smem =
          4 * ((size_t)gb * p.w_row + stage + (table ? p.R : 0));
      if (smem <= budget || gb == 1) {
        p.gb = gb;
        p.cc = cc;
        p.stage = stage;
        p.smem = smem;
        return p;
      }
    }
}

// A unit of a CTA's work: chunk k (in channels k cc ..) of tile `tile`.
struct Item {
  long long tile;
  int k;
};

struct TileArgs {
  int D, H, W, Cy, Cx, P, S, R, per_plane, gb, cc, lcc, nk, w_row, stage,
      vec;  // lcc: log2(cc)
  long long tiles, per_block;  // per_block: tiles of one out channel block
};

inline TileArgs tile_args(const TilePlan& p, int N, int D, int H, int W,
                          int Cy, int Cx, int vec) {
  return TileArgs{D, H, W, Cy, Cx, p.P, p.S, p.R, p.per_plane, p.gb, p.cc,
                  __builtin_ctz(p.cc), (Cx + p.cc - 1) / p.cc, p.w_row,
                  p.stage, vec, p.tiles, (long long)N * D * p.per_plane};
}

// The tile's sample, plane and first position.
struct TilePos {
  int n, z, q0;
};

__device__ __forceinline__ TilePos tile_pos(long long tile,
                                            const TileArgs& a) {
  const long long r = tile % a.per_block;
  return TilePos{(int)(r / ((long long)a.D * a.per_plane)),
                 (int)(r / a.per_plane % a.D),
                 (int)(r % a.per_plane) * kTilePos};
}

// The plane position of halo row h of a tile at q0: q0 + (b - 1) P - 1 + h
// - b S, band b = min(h / S, 2); its voxel's offset y W + x in the plane,
// or -1 outside the plane and in the zero columns.
__device__ __forceinline__ int halo_offset(int q0, int h, const TileArgs& a) {
  const int b = min(h / a.S, 2);
  const int q = q0 + (b - 1) * a.P - 1 + h - b * a.S;
  if (q < 0 || q >= a.H * a.P) return -1;
  const int gy = q / a.P, gx = q - gy * a.P;
  return gx < a.W ? gy * a.W + gx : -1;
}

// Starts the copies of chunk it.k of tile it.tile: st[(c * 3 + dz) * R +
// h] = in at channel k cc + c of plane z + dz - 1 at halo row h's voxel,
// zero outside the volume and in the zero columns; with a mask tensor, its
// copy beside it (st + stage / 2). Consecutive threads take consecutive
// channels of a voxel (cc a power of two), so a warp reads 32 / cc voxels'
// 4 cc bytes each. Each row's voxel comes from the tile's table `hoff`
// (halo_offset of every row, found once a tile) or, without one, is found
// for each copy. The caller commits.
template <int THREADS>
__device__ __forceinline__ void stage_chunk(float* st, const int* hoff,
                                            const float* in, const float* ym,
                                            Item it, const TileArgs& a) {
  const TilePos t = tile_pos(it.tile, a);
  const int c0 = it.k * a.cc;
  const int cn = min(a.cc, a.Cx - c0);
  const int plane = 3 * a.R;
  const size_t hw = (size_t)a.H * a.W;
  size_t base[3];  // plane z + dz - 1's first voxel, or ~0 outside
#pragma unroll
  for (int dz = 0; dz < 3; ++dz) {
    const int zz = t.z + dz - 1;
    base[dz] = zz >= 0 && zz < a.D ? ((size_t)t.n * a.D + zz) * hw : ~(size_t)0;
  }
  const uint32_t st_s = static_cast<uint32_t>(__cvta_generic_to_shared(st));
  for (int i = threadIdx.x; i < a.R * a.cc; i += THREADS) {
    const int h = i >> a.lcc, c = i & (a.cc - 1);
    if (c >= cn) continue;
    const int off = hoff != nullptr ? hoff[h] : halo_offset(t.q0, h, a);
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
      const bool valid = off >= 0 && base[dz] != ~(size_t)0;
      const size_t src = valid ? (base[dz] + off) * a.Cx + c0 + c : 0;
      const uint32_t dst = st_s + 4 * (c * plane + dz * a.R + h);
      cp_async<4>(dst, in + src, valid);
      if (ym != nullptr) cp_async<4>(dst + 2 * a.stage, ym + src, valid);
    }
  }
}

// The FMA loop of one chunk: cn in channels from the stage `sg` (the
// thread's first window row) and their weight rows `sw` (the thread's
// first out channel), into acc, in channel order; within a channel by tap
// rows (dz, dy), then dx (K9), or with DZ_INNER by dy, then dx, then dz
// (K1: its first kernel's order, so its results did not change), the
// three windows of a dy held.
template <bool DZ_INNER>
__device__ __forceinline__ void tile_fma(const float* sg, const float* sw,
                                         int cn, int plane, int w_row,
                                         int cip, const int (&zy_off)[9],
                                         float (&acc)[kRun][kCiT]) {
  auto fma4 = [&](const float (&win)[kRun + 2], int dx, float4 w4) {
#pragma unroll
    for (int p = 0; p < kRun; ++p) {
      acc[p][0] = fmaf(win[p + dx], w4.x, acc[p][0]);
      acc[p][1] = fmaf(win[p + dx], w4.y, acc[p][1]);
      acc[p][2] = fmaf(win[p + dx], w4.z, acc[p][2]);
      acc[p][3] = fmaf(win[p + dx], w4.w, acc[p][3]);
    }
  };
  auto window = [&](const float* gw, float (&win)[kRun + 2]) {
#pragma unroll
    for (int i = 0; i < kRun + 2; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(gw + i);
      win[i] = v.x;
      win[i + 1] = v.y;
    }
  };
#pragma unroll 1
  for (int c = 0; c < cn; ++c) {
    const float* gc = sg + c * plane;
    const float* wc = sw + c * w_row;
    if constexpr (DZ_INNER) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float win[3][kRun + 2];
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) window(gc + zy_off[dz * 3 + dy], win[dz]);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int dz = 0; dz < 3; ++dz)
            fma4(win[dz], dx, *reinterpret_cast<const float4*>(
                                  wc + ((dz * 3 + dy) * 3 + dx) * cip));
      }
    } else {
#pragma unroll
      for (int zy = 0; zy < 9; ++zy) {
        float win[kRun + 2];
        window(gc + zy_off[zy], win);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          fma4(win, dx,
               *reinterpret_cast<const float4*>(wc + (zy * 3 + dx) * cip));
      }
    }
  }
}

// The persistent tile walk. Op supplies:
//   kDzInner: tile_fma's order;
//   in, ym: the staged tensor and the mask staged beside it (or null);
//   load_weights(s_w, ob, g0, tid, THREADS, CIP, a): the copies of the
//     weight rows [c][tap][co] of in channels g0.. (gb rows of a.w_row
//     floats) and out block ob's CIP channels, zero past the layer, by
//     4-byte cp.async in the chunk's group (a CTA's first weights then load
//     in one batch, not a round trip a float);
//   fixes(): whether each thread fixes its landed copies, and
//     fix(st, j, stage): that fix of stage float j;
//   store(acc, t, run, cig, ob, a): the epilogue of the thread's outputs.
template <int CIG, bool TABLE, class Op>
__device__ __forceinline__ void tile_walk(const Op& op, const TileArgs& a) {
  constexpr int THREADS = kRuns * CIG, CIP = kCiT * CIG;
  extern __shared__ __align__(16) float smem_f[];
  float* s_w = smem_f;                  // weights [gb][w_row]: [tap][co]
  float* st = smem_f + a.gb * a.w_row;  // the stage: a.stage floats
  // With TABLE, the tile's halo_offset of each of its R rows.
  int* hoff = TABLE ? reinterpret_cast<int*>(st + a.stage) : nullptr;
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
  long long w_key = -1;  // the weight block staged: out block * nk + in block
  for (Item it{blockIdx.x, 0}; it.tile < a.tiles; next(it)) {
    if (TABLE && it.k == 0) {  // the last tile's copies have all started
      const int q0 = tile_pos(it.tile, a).q0;
      for (int h = tid; h < R; h += THREADS) hoff[h] = halo_offset(q0, h, a);
      __syncthreads();
    }
    stage_chunk<THREADS>(st, hoff, op.in, op.ym, it, a);
    const long long ob = it.tile / a.per_block;
    const int gbi = it.k * a.cc / a.gb;
    if (ob * a.nk + gbi != w_key) {
      w_key = ob * a.nk + gbi;
      op.load_weights(s_w, (int)ob, gbi * a.gb, tid, THREADS, CIP, a);
    }
    cp_async_commit();
    cp_async_wait<0>();
    const int c0 = it.k * a.cc, cn = min(a.cc, a.Cx - c0), plane = 3 * R;
    if (op.fixes()) {  // this thread's own copies (stage_chunk's)
      for (int i = tid; i < R * a.cc; i += THREADS) {
        const int h = i >> a.lcc, c = i & (a.cc - 1);
        if (c >= cn) continue;
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) op.fix(st, c * plane + dz * R + h,
                                              a.stage);
      }
    }
    __syncthreads();
    if (it.k == 0) {
#pragma unroll
      for (int p = 0; p < kRun; ++p)
#pragma unroll
        for (int j = 0; j < kCiT; ++j) acc[p][j] = 0.f;
    }
    tile_fma<Op::kDzInner>(st + run * kRun,
                           s_w + (c0 - gbi * a.gb) * a.w_row + cig * kCiT,
                           cn, plane, a.w_row, CIP, zy_off, acc);
    __syncthreads();  // the stage is free
    if (it.k == a.nk - 1)
      op.store(acc, tile_pos(it.tile, a), run, cig, (int)ob, CIP, a);
  }
}

// The SMs of each device, and the CTAs an SM holds of each tile kernel at
// each (threads, shared bytes), found once, not each call: the serial path
// launches K1 ~46,000 times a run. Each source that includes this header
// keeps its own.
struct Fit {
  const void* kernel;
  int dev, threads;
  size_t smem;
  int per_sm;
};
constexpr int kMaxDevices = 16, kMaxFits = 64;
std::mutex fit_mutex;
int sms_of[kMaxDevices];
Fit fits[kMaxFits];
int n_fits = 0;

inline cudaError_t device_sms(int* dev, int* sms) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(fit_mutex);
  if (*dev < kMaxDevices && sms_of[*dev] > 0) {
    *sms = sms_of[*dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err == cudaSuccess && *dev < kMaxDevices) sms_of[*dev] = *sms;
  return err;
}

// Runs a tile_walk kernel persistently on device `dev` of `sms` SMs: the
// SMs times the CTAs an SM holds at the plan's shared memory, at most the
// tiles.
template <typename Kernel, typename... Args>
cudaError_t launch_tiles(Kernel kernel, const TilePlan& p, int dev, int sms,
                         cudaStream_t s, Args... args) {
  const void* key = reinterpret_cast<const void*>(kernel);
  int per_sm = 0;
  {
    std::lock_guard<std::mutex> lock(fit_mutex);
    for (int i = 0; i < n_fits && per_sm == 0; ++i)
      if (fits[i].kernel == key && fits[i].dev == dev &&
          fits[i].threads == p.threads && fits[i].smem == p.smem)
        per_sm = fits[i].per_sm;
    if (per_sm == 0) {
      // The kernel's limit is a CTA's whole share: every plan fits under it.
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, p.threads, p.smem);
      if (err != cudaSuccess) return err;
      if (per_sm < 1) per_sm = 1;
      if (n_fits < kMaxFits)
        fits[n_fits++] = Fit{key, dev, p.threads, p.smem, per_sm};
    }
  }
  const long long ctas = (long long)sms * per_sm;
  kernel<<<(unsigned)(p.tiles < ctas ? p.tiles : ctas), p.threads, p.smem,
           s>>>(args...);
  return cudaGetLastError();
}

}  // namespace
