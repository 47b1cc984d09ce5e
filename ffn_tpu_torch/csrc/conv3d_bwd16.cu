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
// for K18. dx is the SAME convolution of g with W'[tap'][co][ci] =
// W[26 - tap'][ci][co], so K17 runs on K15's plane-position tiles
// (conv16.cuh): persistent CTAs of 8 warps, two an SM at 33^3, stage W' once
// as rows [ci][k'], k' = tap' * Cout + co (for a fixed tap and ci the co lie
// contiguous in the DHWIO tensor: 16-byte copies, no scatter), and walk
// tiles of 128 positions y(W+1)+x of a z-plane (5.8% padded slots at 33^3,
// the old 4x4x8 box 44%); g's three-plane halo comes in by cp.async and
// each thread zeroes its own copies where the forward output ym was not > 0
// (ym by 16-byte loads, not staged); A and B by ldmatrix, mma.sync, each
// tap row (dz, dy) summed from zero and then added to acc in order (K15's
// order); the next tile's halo is in flight during the epilogue (pre_relu
// mask, rounding, `accum`). What bounds it (tools_torch/dgrad_variants.py
// --split on an H100): mma.sync's issue, ~28 of 43 us at 32->32 B=4 (29%
// of the tensor cores' peak), the staging ~6 us, which the second CTA of
// an SM mostly hides; a block's first layer adds the masks' and the
// cotangent's bytes and ym's latency (59 us). 1^3 layers (conv_lom: dx =
// r(r(dy) w)) on the CUDA cores, dy read as float32.
//
// K18's 3^3 layers (Cout 16 or 32, Cin <= 32, dy of the type) on the tensor
// cores, two stages. Stage 1: a CTA owns a fixed set of chunks (chunk c, c +
// ctas, ...; a chunk is a box of cz x cy rows (n, z, y) with all of x) and
// all 27 taps, 3 a warp, plus a warp for the bias. Per chunk it stages once,
// in shared memory, by cp.async where the source is 16-bit: x's halo (zero
// outside the volume, channels zero-padded to CIP; a float32 x rounded to r
// in registers), g = dy and the mask ym at the chunk's positions in order;
// then, on the thread's own copies, relu on x (fmaxf: NaN to 0) and the mask
// on g. Tap t's dW is a (CIP x positions) by (positions x Cout) product: A
// from the halo at the tap's fixed offset, B from g, both by ldmatrix.trans
// on NDHWC rows (a table gives each position's voxel, so the tap loop has no
// bounds branch), mma.sync m16n8k16 with float32 sums kept in registers
// across the CTA's chunks; a warp's 3 taps (dx = 0..2) share g's fragments.
// The bias warp sums g's columns in a fixed order. Each CTA writes one row
// of float32 partials; stage 2 (wgrad.cuh) sums the rows in order and rounds
// once. Deterministic, no atomics. The 1^3 layer (conv_lom: 9 MFLOP, a
// float32 dy) stays on K10's CUDA-core body (wgrad.cuh), counted as
// conv3d_wgrad1_*. Bytes and operations nearly tie at B=4 (8.2 us for x, dy
// and the mask, 8.0 us of operations); the staging, not overlapped with the
// MMAs, and mma.sync's rate bound this design (tools_torch/k18_variants.py
// --split). Left for later: overlapping a chunk's staging with the last
// one's MMAs, wgmma with A in registers, TMA.

#include "wgrad.cuh"

namespace {

// -- K17's 3^3 layers on K15's plane-position tiles -------------------------

// Shared memory of a K17 CTA (CI dx and CO g channels): W' and one stage.
template <int CI, int CO>
inline size_t dgrad16_smem(int R) {
  return (size_t)K15Geo<CO, CI>::W_BYTES + stage_bytes<CO, CI>(R);
}

// Zeroes g where the forward output ym was not > 0, on the copies that
// stage_tile had this thread make of tile `tl` (they have landed): its
// indices, ym by 16-byte loads, CPR iterations' loads in flight at once
// (a 33^3 tile's rows in one round; more cost the 16->16 kernel registers
// and occupancy). The planes outside the volume hold zeros, which stay.
template <typename T, int CO>
__device__ __forceinline__ void mask_tile(T* st, const T* ym, Tile tl, int D,
                                          int H, int W, int P, int R) {
  constexpr int CS = K15Geo<CO, 8>::CS, CPR = CO / 8;
  const int hp = H * P;
  for (int i0 = threadIdx.x; i0 < R * CPR; i0 += CPR * kTileThreads) {
    uint4 m[CPR][3];
    int at[CPR];  // the slot of iteration b in plane 0, or -1
#pragma unroll
    for (int b = 0; b < CPR; ++b) {
      const int i = i0 + b * kTileThreads;
      const int h = i / CPR, c = (i - h * CPR) * 8;
      const int q = tl.q0 - P - 1 + h;
      const bool in_plane = i < R * CPR && q >= 0 && q < hp;
      const int gy = in_plane ? q / P : 0, gx = q - gy * P;
      at[b] = in_plane && gx < W ? h * CS + c : -1;
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const int zz = tl.z + dz - 1;
        m[b][dz] = make_uint4(0u, 0u, 0u, 0u);
        if (at[b] >= 0 && zz >= 0 && zz < D)
          m[b][dz] = *reinterpret_cast<const uint4*>(
              ym + ((((size_t)tl.n * D + zz) * H + gy) * W + gx) * CO + c);
      }
    }
#pragma unroll
    for (int b = 0; b < CPR; ++b) {
      if (at[b] < 0) continue;
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        uint4* dst = reinterpret_cast<uint4*>(st + dz * R * CS + at[b]);
        uint4 u = *dst;
        uint32_t* uw = reinterpret_cast<uint32_t*>(&u);
        const uint32_t mw[4] = {m[b][dz].x, m[b][dz].y, m[b][dz].z,
                                m[b][dz].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float lo, hi;
          unpack16<T>(mw[j], lo, hi);
          if (!(lo > 0.f)) uw[j] &= 0xffff0000u;
          if (!(hi > 0.f)) uw[j] &= 0x0000ffffu;
        }
        *dst = u;
      }
    }
  }
}

// The CI x CO dx channel pairs of K17's tensor-core kernel: the stack's 3^3
// layers whose input gradient training needs, at 32 and 16 features. dy,
// ym (N,D,H,W,CO), xm, accum, dx (N,D,H,W,CI); the GEMM's K runs over
// (tap', co), its N over ci.
template <typename T, int CI, int CO>
__global__ void __launch_bounds__(kTileThreads, 2)
dgrad16_tc_kernel(const T* __restrict__ dy, const T* __restrict__ ym,
                  const T* __restrict__ wt, const T* __restrict__ xm,
                  const T* __restrict__ accum, T* __restrict__ dx, int D,
                  int H, int W, int P, int R, int per_plane,
                  long long tiles) {
  using G = K15Geo<CO, CI>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_w = reinterpret_cast<T*>(smem);             // [CI][WK]
  T* st = reinterpret_cast<T*>(smem + G::W_BYTES);  // [3][R][CS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // Row ci of W' holds k' = tap' * CO + co: W[26 - tap'][ci][co], 8 co a
  // copy.
  for (int i = tid; i < 27 * CI * (CO / 8); i += kTileThreads) {
    const int c8 = (i % (CO / 8)) * 8, ci = (i / (CO / 8)) % CI;
    const int tap = i / (CO / 8 * CI);
    *reinterpret_cast<uint4*>(s_w + ci * G::WK + tap * CO + c8) =
        *reinterpret_cast<const uint4*>(
            wt + ((size_t)(26 - tap) * CI + ci) * CO + c8);
  }
  long long tile = blockIdx.x;
  stage_tile<T, CO, CI>(st, dy, 0, tile_at(tile, D, per_plane), D, H, W, P,
                        R);
  cp_async_commit();

  for (; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_at(tile, D, per_plane);
    cp_async_wait<0>();
    if (ym != nullptr) mask_tile<T, CO>(st, ym, tl, D, H, W, P, R);
    __syncthreads();
    float acc[G::NT][4], unused[G::NT][4];
    tile_sums<T, CO, CI, false>(st, s_w, warp, lane, P, R, 0, acc, unused);
    __syncthreads();  // the stage is free: the next tile lands meanwhile
    if (tile + gridDim.x < tiles) {
      stage_tile<T, CO, CI>(st, dy, 0, tile_at(tile + gridDim.x, D,
                                               per_plane), D, H, W, P, R);
      cp_async_commit();
    }
    // dx = r(r(acc) [xm > 0] + accum), channel pairs 2t, 2t + 1 of each
    // n-tile; rows past the plane or in the zero column store nothing.
    const size_t plane0 = ((size_t)tl.n * D + tl.z) * H * W;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tl.q0 + warp * 16 + g + 8 * h;
      const int gy = q / P, gx = q - gy * P;
      if (gy >= H || gx >= W) continue;
      const size_t o0 = (plane0 + (size_t)gy * W + gx) * CI + 2 * t;
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        const size_t o = o0 + nt * 8;
        float v0 = round16<T>(acc[nt][2 * h]);
        float v1 = round16<T>(acc[nt][2 * h + 1]);
        float a0, a1;
        if (xm != nullptr) {
          unpack16<T>(*reinterpret_cast<const uint32_t*>(xm + o), a0, a1);
          if (!(a0 > 0.f)) v0 = 0.f;
          if (!(a1 > 0.f)) v1 = 0.f;
        }
        if (accum != nullptr) {
          unpack16<T>(*reinterpret_cast<const uint32_t*>(accum + o), a0, a1);
          v0 += a0;
          v1 += a1;
        }
        *reinterpret_cast<uint32_t*>(dx + o) = pack16<T>(v0, v1);
      }
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

// K15's host geometry (ops/conv3d.py's k15_geometry): pitch P, halo rows
// R, tiles a plane; a persistent grid.
template <typename T, int CI, int CO>
cudaError_t launch_dgrad_tc(const T* dy, const T* ym, const T* w,
                            const T* xm, const T* accum, T* dx, int N, int D,
                            int H, int W, cudaStream_t s) {
  auto kernel = dgrad16_tc_kernel<T, CI, CO>;
  const int P = W + 1, R = kTileRows + 2 * P + 2;
  const int per_plane = (H * P - 1 + kTileRows - 1) / kTileRows;
  const long long tiles = (long long)N * D * per_plane;
  const size_t smem = dgrad16_smem<CI, CO>(R);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  if (tiles == 0) return cudaSuccess;
  unsigned grid = 0;
  const cudaError_t err =
      persistent_grid(kernel, kTileThreads, smem, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTileThreads, smem, s>>>(dy, ym, w, xm, accum, dx, D, H, W,
                                          P, R, per_plane, tiles);
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

// -- K18's 3^3 layers on the tensor cores -----------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Eight channels as four words of r, relu'd when asked (fmaxf: NaN to 0, as
// K10's body does).
template <typename T>
__device__ __forceinline__ uint4 pack8(const float (&f)[8], int relu) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = relu ? fmaxf(f[j], 0.f) : f[j];
  return make_uint4(pack16<T>(v[0], v[1]), pack16<T>(v[2], v[3]),
                    pack16<T>(v[4], v[5]), pack16<T>(v[6], v[7]));
}

template <typename T>
__device__ __forceinline__ uint4 relu8(uint4 u) {
  float f[8];
  unpack16<T>(u.x, f[0], f[1]);
  unpack16<T>(u.y, f[2], f[3]);
  unpack16<T>(u.z, f[4], f[5]);
  unpack16<T>(u.w, f[6], f[7]);
  return pack8<T>(f, 1);
}

// A stage-1 CTA: 9 tap warps of kW16Tpw taps (dx = 0..2, sharing g's
// fragments) and the bias warp.
constexpr int kW16Tpw = 3;
constexpr int kW16Threads = (27 / kW16Tpw + 1) * 32;

// Shared memory of a stage-1 CTA: x's halo and a zero voxel, CIP + 8
// values a voxel; g and the mask (ym), Cout + 8 values a position; the
// position table. The +8 puts the 8 rows of an ldmatrix on distinct banks.
__host__ __device__ inline size_t wgrad16_smem(int cz, int cy, int W,
                                               int cip, int co) {
  const size_t hvox = (size_t)(cz + 2) * (cy + 2) * (W + 2) + 1;
  const size_t ppad = ((size_t)cz * cy * W + 15) / 16 * 16;
  return hvox * (cip + 8) * 2 + 2 * ppad * (co + 8) * 2 + ppad * 4;
}

// Stage 1. x (N,D,H,W,Cin) of type T or float32 (XF); dy, ym (N,D,H,W,CO);
// partial[blockIdx.x][27 * Cin * CO + CO].
template <typename T, int CIP, int CO, int XF>
__global__ void __launch_bounds__(kW16Threads, 1)
wgrad16_tc_kernel(const void* __restrict__ x, const T* __restrict__ dy,
                  const T* __restrict__ ym, float* __restrict__ partial,
                  int D, int H, int W, int Cin, int pre_relu, int cz, int cy,
                  int nzc, int nyc, int chunks) {
  constexpr int CS = CIP + 8, GS = CO + 8, MT = CIP / 16, NT = CO / 8;
  constexpr int XC = CIP / 8, GC = CO / 8;
  constexpr int TPW = kW16Tpw;
  static_assert(CIP % 16 == 0 && CO % 16 == 0, "K18");
  extern __shared__ __align__(16) unsigned char smem[];
  const int hvox = (cz + 2) * (cy + 2) * (W + 2);  // the zero voxel
  const int ppad = (cz * cy * W + 15) / 16 * 16;
  T* s_x = reinterpret_cast<T*>(smem);
  T* s_g = s_x + (size_t)(hvox + 1) * CS;
  T* s_m = s_g + (size_t)ppad * GS;
  int* s_tab = reinterpret_cast<int*>(s_m + (size_t)ppad * GS);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nthr = blockDim.x, nwarp = nthr / 32;
  const bool tap_warp = warp < 27 / TPW, bias_warp = warp == 27 / TPW;
  const int t0 = warp * TPW;  // the warp's first tap (dx = 0)
  const int tz = t0 / 9, ty = t0 / 3 % 3;
  const bool copy_x = !XF && Cin == CIP;  // x rows go by cp.async
  for (int i = threadIdx.x; i < XC; i += nthr)
    *reinterpret_cast<uint4*>(s_x + (size_t)hvox * CS + 8 * i) =
        make_uint4(0u, 0u, 0u, 0u);

  float acc[TPW][MT][NT][4];
#pragma unroll
  for (int u = 0; u < TPW; ++u)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[u][mt][nt][j] = 0.f;
  float bsum[2] = {0.f, 0.f};

  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int n = c / (nzc * nyc);
    const int z0 = c / nyc % nzc * cz, y0 = c % nyc * cy;
    const int czc = min(cz, D - z0), cyc = min(cy, H - y0);
    const int hz = czc + 2, hy = cyc + 2, hx = W + 2;
    const int zb = z0 - 1, P = czc * cyc * W, pp = (P + 15) / 16 * 16;
    __syncthreads();  // the last chunk's tiles are read

    // A warp a row: x's halo rows (sz, sy) (voxel (sz, sy, sx) is x at
    // (zb + sz, y0 - 1 + sy, sx - 1)), then g's rows (rz, ry) (position k =
    // (rz * cyc + ry) * W + rx), lanes along the row's 16-byte pieces. The
    // second pass, after the copies land, touches the thread's own copies:
    // relu on x where pre_relu, the mask on g.
    for (int pass = 0; pass < 2; ++pass) {
      if (pass == 1) {
        cp_async_wait_all();
        if (!(copy_x && pre_relu) && ym == nullptr) break;
      }
      for (int r = warp; r < hz * hy + czc * cyc; r += nwarp) {
        if (r < hz * hy) {
          const int gz = zb + r / hy, gy = y0 - 1 + r % hy;
          const bool live = gz >= 0 && gz < D && gy >= 0 && gy < H;
          if (pass == 1 && !(live && copy_x && pre_relu)) continue;
          const size_t at0 =
              ((((size_t)n * D + gz) * H + gy) * W - 1) * Cin;
          for (int j = lane; j < hx * XC; j += 32) {
            const int sx = j / XC, c8 = j % XC * 8;
            T* dst = s_x + ((size_t)r * hx + sx) * CS + c8;
            const bool in = live && sx > 0 && sx <= W;
            if (pass == 1) {
              if (in)
                *reinterpret_cast<uint4*>(dst) =
                    relu8<T>(*reinterpret_cast<const uint4*>(dst));
            } else if (!in) {
              *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
            } else if (copy_x) {
              cp_async16(dst, static_cast<const T*>(x) + at0 +
                                  (size_t)sx * Cin + c8);
            } else {
              float f[8];
#pragma unroll
              for (int i = 0; i < 8; ++i)
                f[i] = c8 + i < Cin ? load16<T>(x, XF, at0 + (size_t)sx * Cin
                                                           + c8 + i)
                                    : 0.f;
              *reinterpret_cast<uint4*>(dst) = pack8<T>(f, pre_relu);
            }
          }
          continue;
        }
        if (pass == 1 && ym == nullptr) continue;
        const int q = r - hz * hy;
        const size_t at0 =
            (((size_t)n * D + z0 + q / cyc) * H + y0 + q % cyc) * W * CO;
        for (int j = lane; j < W * GC; j += 32) {
          const int rx = j / GC, c8 = j % GC * 8;
          const size_t o = ((size_t)q * W + rx) * GS + c8;
          if (pass == 0) {
            cp_async16(s_g + o, dy + at0 + (size_t)rx * CO + c8);
            if (ym != nullptr)
              cp_async16(s_m + o, ym + at0 + (size_t)rx * CO + c8);
            continue;
          }
          uint4* gp = reinterpret_cast<uint4*>(s_g + o);
          const uint4 m = *reinterpret_cast<const uint4*>(s_m + o);
          uint4 u = *gp;
          uint32_t* uw = reinterpret_cast<uint32_t*>(&u);
          const uint32_t mw[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float lo, hi;
            unpack16<T>(mw[i], lo, hi);
            if (!(lo > 0.f)) uw[i] &= 0xffff0000u;
            if (!(hi > 0.f)) uw[i] &= 0x0000ffffu;
          }
          *gp = u;
        }
      }
      if (pass == 1) continue;
      for (int i = threadIdx.x; i < (pp - P) * GC; i += nthr)  // 0 past P
        *reinterpret_cast<uint4*>(s_g + (size_t)(P + i / GC) * GS +
                                  i % GC * 8) = make_uint4(0u, 0u, 0u, 0u);
      // Each position's halo voxel at tap (0, 0, 0); -1 past P.
      for (int k = threadIdx.x; k < pp; k += nthr) {
        const int rx = k % W, ry = k / W % cyc, rz = k / (W * cyc);
        s_tab[k] = k < P ? (rz * hy + ry) * hx + rx : -1;
      }
    }
    __syncthreads();

    if (tap_warp) {
      // ldmatrix.x4.trans: lane supplies row (lane & 7) of matrix lane / 8.
      // A (ci x positions): matrices (ci 0-7, 8-15) x (positions 0-7, 8-15);
      // B (positions x co): (positions 0-7, 8-15) x (co 0-7, 8-15). Tap
      // t0 + u reads the halo u voxels on.
      const int ra = (lane & 7) + 8 * (lane >> 4), ca = 8 * (lane >> 3 & 1);
      const int rb = (lane & 7) + 8 * (lane >> 3 & 1), cb = 8 * (lane >> 4);
      const int off = (tz * hy + ty) * hx;
      const uint32_t xs = static_cast<uint32_t>(__cvta_generic_to_shared(s_x));
      const uint32_t zero = xs + (uint32_t)(hvox * CS + ca) * 2;
      const uint32_t gs = static_cast<uint32_t>(__cvta_generic_to_shared(
          s_g + (size_t)rb * GS + cb));
#pragma unroll 2
      for (int k0 = 0; k0 < pp; k0 += 16) {
        const int v = s_tab[k0 + ra];
        const uint32_t xa =
            v >= 0 ? xs + (uint32_t)((v + off) * CS + ca) * 2 : zero;
        const uint32_t step = v >= 0 ? CS * 2 : 0;
        uint32_t b[NT][2];
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, gs + (uint32_t)(k0 * GS + 16 * p) * 2);
          b[2 * p][0] = r[0];
          b[2 * p][1] = r[1];
          b[2 * p + 1][0] = r[2];
          b[2 * p + 1][1] = r[3];
        }
#pragma unroll
        for (int u = 0; u < TPW; ++u) {
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldmatrix_x4_trans(a[mt], xa + u * step + mt * 32);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma16<T, true>(acc[u][mt][nt], a[mt], b[nt][0], b[nt][1]);
        }
      }
    } else if (bias_warp) {
      // Lane: columns 2p, 2p + 1 and positions k = f (mod 2 KP), f + KP
      // (mod 2 KP); the KP phases added by shuffles in a fixed order.
      constexpr int NP = CO / 2, KP = 32 / NP;
      const int p = lane % NP, f = lane / NP;
      float s4[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      for (int k = f; k < pp; k += 2 * KP)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float lo, hi;
          unpack16<T>(*reinterpret_cast<const uint32_t*>(
                          s_g + (size_t)(k + h * KP) * GS + 2 * p),
                      lo, hi);
          s4[h][0] += lo;
          s4[h][1] += hi;
        }
      float b0 = s4[0][0] + s4[1][0], b1 = s4[0][1] + s4[1][1];
#pragma unroll
      for (int o = NP; o < 32; o <<= 1) {
        b0 += __shfl_xor_sync(0xffffffffu, b0, o);
        b1 += __shfl_xor_sync(0xffffffffu, b1, o);
      }
      bsum[0] += b0;
      bsum[1] += b1;
    }
  }

  // C fragment: rows (ci) g and g + 8, columns (co) 2t and 2t + 1.
  float* out = partial + (size_t)blockIdx.x * (27 * Cin * CO + CO);
  if (tap_warp) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int u = 0; u < TPW; ++u) {
      const int tap = t0 + u;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ci = mt * 16 + g + 8 * h;
          if (ci >= Cin) continue;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            *reinterpret_cast<float2*>(
                out + ((size_t)tap * Cin + ci) * CO + nt * 8 + 2 * t) =
                make_float2(acc[u][mt][nt][2 * h], acc[u][mt][nt][2 * h + 1]);
        }
    }
  } else if (bias_warp && lane < CO / 2) {
    *reinterpret_cast<float2*>(out + 27 * Cin * CO + 2 * lane) =
        make_float2(bsum[0], bsum[1]);
  }
}

template <typename T, int CIP, int CO, int XF>
cudaError_t launch_wgrad_tc(const void* x, const T* dy, const T* ym,
                            float* partial, float* dw, float* db, int N,
                            int D, int H, int W, int Cin, int pre_relu,
                            int cz, int cy, int ctas, cudaStream_t s) {
  static const cudaError_t err = cudaFuncSetAttribute(
      wgrad16_tc_kernel<T, CIP, CO, XF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return err;
  const size_t smem = wgrad16_smem(cz, cy, W, CIP, CO);
  const int nzc = (D + cz - 1) / cz, nyc = (H + cy - 1) / cy;
  wgrad16_tc_kernel<T, CIP, CO, XF><<<ctas, kW16Threads, smem, s>>>(
      x, dy, ym, partial, D, H, W, Cin, pre_relu, cz, cy, nzc, nyc,
      N * nzc * nyc);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return e1;
  const int nw = 27 * Cin * CO, total = nw + CO;
  wgrad_sum_kernel<T><<<(total + 255) / 256, 256, 0, s>>>(partial, dw, db,
                                                           ctas, nw, CO);
  return cudaGetLastError();
}

template <typename T, int CIP, int CO>
cudaError_t wgrad_tc_xf(const void* x, int x_f32, const T* dy, const T* ym,
                        float* partial, float* dw, float* db, int N, int D,
                        int H, int W, int Cin, int pre_relu, int cz, int cy,
                        int ctas, cudaStream_t s) {
  return x_f32 ? launch_wgrad_tc<T, CIP, CO, 1>(x, dy, ym, partial, dw, db,
                                                N, D, H, W, Cin, pre_relu,
                                                cz, cy, ctas, s)
               : launch_wgrad_tc<T, CIP, CO, 0>(x, dy, ym, partial, dw, db,
                                                N, D, H, W, Cin, pre_relu,
                                                cz, cy, ctas, s);
}

template <typename T>
int wgrad16_tc(const void* x, int x_f32, const void* dy, const void* ym,
               float* partial, float* dw, float* db, int N, int D, int H,
               int W, int Cin, int Cout, int pre_relu, int cz, int cy,
               int ctas, cudaStream_t s) {
  const int cip = Cin <= 16 ? 16 : 32;
  if (Cin < 1 || Cin > 32 || (Cout != 16 && Cout != 32) || cz < 1 ||
      cy < 1 || ctas < 1 || wgrad16_smem(cz, cy, W, cip, Cout) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const T *g = static_cast<const T*>(dy), *m = static_cast<const T*>(ym);
#define FFN_WGRAD_TC_W(CIP, CO)                                            \
  return static_cast<int>(wgrad_tc_xf<T, CIP, CO>(                         \
      x, x_f32, g, m, partial, dw, db, N, D, H, W, Cin, pre_relu, cz, cy,  \
      ctas, s))
  if (cip == 16 && Cout == 16) FFN_WGRAD_TC_W(16, 16);
  if (cip == 16) FFN_WGRAD_TC_W(16, 32);
  if (Cout == 16) FFN_WGRAD_TC_W(32, 16);
  FFN_WGRAD_TC_W(32, 32);
#undef FFN_WGRAD_TC_W
}

}  // namespace

// K17. dy (N,D,H,W,Cout) of the type (float32 when dy_f32, 1^3 only); ym
// (the forward output, for post_relu) or null; w (k,k,k,Cin,Cout); xm (the
// forward input, for pre_relu) or null; accum (N,D,H,W,Cin) or null; dx
// (N,D,H,W,Cin). 16-bit tensors of one type (f16: float16, else bfloat16),
// contiguous, 16-byte aligned; k = 3 takes Cin = Cout in {16, 32} and rows
// whose halo fits in shared memory (ops/conv3d.py's k15_geometry).
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

// K18 on K10's CUDA-core body, 1^3 layers only (k must be 1). x
// (N,D,H,W,Cin), the forward input, of the type or float32 (x_f32, rounded
// here; relu here when pre_relu); dy (N,D,H,W,Cout) of the type or float32
// (dy_f32); ym, the forward output, or null without post_relu; partial
// (chunks, k^3*Cin*Cout + Cout) float32 scratch; dw (k,k,k,Cin,Cout) and db
// (Cout) float32. `rows` output rows (n, z, y) per chunk; chunks =
// ceil(N*D*H/rows). Needs ceil(Cin/4)*ceil(Cout/4) <= 256, Cout <= 256.
extern "C" int ffn_conv3d_wgrad_16(const void* x, int x_f32, const void* dy,
                                   int dy_f32, const void* ym, float* partial,
                                   float* dw, float* db, int N, int D, int H,
                                   int W, int Cin, int Cout, int k,
                                   int pre_relu, int rows, int f16,
                                   void* stream) {
  if (k != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f16 ? wgrad_launch<__half>(x, x_f32, dy, dy_f32, ym, partial, dw,
                                    db, N, D, H, W, Cin, Cout, k, pre_relu,
                                    rows, s)
             : wgrad_launch<__nv_bfloat16>(x, x_f32, dy, dy_f32, ym, partial,
                                           dw, db, N, D, H, W, Cin, Cout, k,
                                           pre_relu, rows, s);
}

// K18 on the tensor cores, 3^3 layers. x, ym, dw, db as above, dy of the
// type; Cin <= 32, Cout 16 or 32; chunks of cz x cy rows (z, y) with all
// of x, ceil(D/cz) * ceil(H/cy) a sample, chunk c = (n, z-chunk, y-chunk)
// in that order; `ctas` stage-1 CTAs, CTA b summing chunks b, b + ctas,
// ...; partial (ctas, 27*Cin*Cout + Cout) float32 scratch.
extern "C" int ffn_conv3d_wgrad16_tc(const void* x, int x_f32, const void* dy,
                                     const void* ym, float* partial,
                                     float* dw, float* db, int N, int D,
                                     int H, int W, int Cin, int Cout,
                                     int pre_relu, int cz, int cy, int ctas,
                                     int f16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f16 ? wgrad16_tc<__half>(x, x_f32, dy, ym, partial, dw, db, N, D,
                                  H, W, Cin, Cout, pre_relu, cz, cy, ctas, s)
             : wgrad16_tc<__nv_bfloat16>(x, x_f32, dy, ym, partial, dw, db,
                                         N, D, H, W, Cin, Cout, pre_relu, cz,
                                         cy, ctas, s);
}
