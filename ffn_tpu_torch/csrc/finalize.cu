// K8 finalize_pass: device finalization of finished lanes, one pass,
// replacing finalize_pass + finalize_one of HopEngine._run_hops_impl
// (ffn_tpu/inference/hop_engine.py:624-864); ops/finalize.py gives the
// semantics (dud kill, the sequential loop, verdicts, log row, FIFO pops,
// reseed) and where bfloat16 seeds round (one body templated on the seed
// type; the wrapper rounds the thresholds once).
//
// Bound on the H100: bandwidth and latency. A counting finalization reads
// the lane's seeds, the slot's segmentation and blocked volume once (9
// bytes a voxel: 4.9 MB at 82^3) and writes the claims; the loop is
// sequential by design, so most of the time is dependent scalar work and
// grid barriers. Design: one cooperative persistent launch per pass (a grid
// barrier of two counters in scratch). Thread 0 of block 0 runs the scalar
// logic and broadcasts through scratch; all blocks share the voxel work:
// the masked count, an exact int32 reduction (one atomicAdd a block),
// the id write, the blank and the dedup clear. Reads of data the launch
// wrote bypass L1.

#include "common.cuh"

namespace {

constexpr int kIdle = 0, kRunning = 1, kDoneEmpty = 2, kDoneWeak = 3,
              kDoneCap = 4, kDoneFinalized = 6;
constexpr int kFinSegmented = 1, kFinWeak = 2, kFinTooSmall = 3,
              kFinClaimed = 4, kFinInvalid = 5;
constexpr uint8_t kClaimed = 1;
constexpr int kThreads = 512;
constexpr int kMaxLanes = 1024;
constexpr int kLogColumns = 10;

// Scratch layout (int32, zeroed by the caller).
enum {
  kBarCount = 0,
  kBarGen = 1,
  kLane = 2,  // the lane of this turn, -1 to stop
  kCand = 3,  // the lane may segment: count its mask
  kSlot = 4,
  kSid = 5,
  kNvox = 6,
  kGot = 7,  // a FIFO seed was popped: blank and reseed
  kSmall = 8,
  kCorner = 9,  // 3 entries
};

struct FinPtrs {
  void* seeds;  // T (B,Z,Y,X)
  int* sv;
  int* qpos;
  float* qscore;
  int* head;
  int* tail;
  uint8_t* done;
  int* start;
  int* minp;
  int* maxp;
  int* iters;
  int* status;
  uint8_t* fresh;
  int* seg;
  int* next_sid;
  const int* fifo_pos;
  const int* fifo_sv;
  const int* fifo_n;
  int* fifo_head;
  int* log;
  int* log_n;
  const uint8_t* hold;
  int* claimed;
  const uint8_t* blocked;
  int* alive;  // null: not asked
  int* ctrl;
};

struct FinParams {
  int B, Q, K, Z, Y, X;
  long long G;  // dedup-grid cells per lane
  int L;        // log rows
  int pz, py, px;  // pred size
  int bz, by, bx;  // small blank block
  int oz, oy, ox;  // its corner's offset from the visited minimum
  int max_iters, min_size;
  float move_t, verdict_t, seg_t, init_act;
};

__device__ inline int ld(const int* p) { return __ldcg(p); }

// Grid-wide barrier of co-resident blocks (a cooperative launch guarantees
// residency): an arrival count and a generation, in global scratch.
__device__ void grid_sync(int* ctrl) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* count = reinterpret_cast<unsigned*>(ctrl + kBarCount);
    volatile unsigned* gen = reinterpret_cast<unsigned*>(ctrl + kBarGen);
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(count, 1u) == gridDim.x - 1) {
      atomicExch(count, 0u);
      __threadfence();
      atomicAdd(reinterpret_cast<unsigned*>(ctrl + kBarGen), 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ inline size_t vox(const FinParams& p, int z, int y, int x) {
  return ((size_t)z * p.Y + y) * p.X + x;
}

__device__ inline bool in_mask(float seed, int seg, uint8_t blk, float t) {
  return seed >= t && seg == 0 && (blk & kClaimed) == 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
finalize_pass_kernel(FinPtrs P, FinParams p) {
  T* const seeds = static_cast<T*>(P.seeds);
  __shared__ uint8_t nmask[kMaxLanes], rmask[kMaxLanes];
  __shared__ int warp_counts[kThreads / 32];
  const bool leader = blockIdx.x == 0 && threadIdx.x == 0;
  const size_t vol = (size_t)p.Z * p.Y * p.X;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  int* ctrl = P.ctrl;

  // Leader-only state carried across the barriers of one turn.
  int li = -1, sv = 0, status = 0, iters = 0, sid = 0, s[3] = {0, 0, 0};
  bool do_fin = false, weak = false, invalid = false, claimed_at = false;

  if (leader) {
    // 1. The same-hop dud kill, and the loop's cond on the entry state.
    bool any_running = false, any_n = false, any_r = false;
    for (int b = 0; b < p.B; ++b) {
      int st = P.status[b];
      const bool running = st == kRunning;
      any_running |= running;
      const bool capped =
          running && p.max_iters > 0 && P.iters[b] >= p.max_iters;
      const int* o = P.start + 3 * b;
      const float origin =
          seed_load(seeds + b * vol + vox(p, o[0], o[1], o[2]));
      const bool weak_now =
          running && !capped && !P.fresh[b] && !(origin >= p.move_t);
      if (capped) st = kDoneCap;
      else if (weak_now) st = kDoneWeak;
      P.status[b] = st;
      nmask[b] = (st == kDoneEmpty && !P.hold[b]) || st == kDoneWeak ||
                 st == kDoneCap;
      rmask[b] = st == kIdle || st == kDoneFinalized;
      any_n |= nmask[b] != 0;
      any_r |= rmask[b] != 0;
    }
    if (P.alive)
      *P.alive = any_running || any_n || (any_r && *P.fifo_head < *P.fifo_n);
  }

  for (;;) {
    if (leader) {
      // 2. The lane of this turn.
      li = -1;
      for (int b = 0; b < p.B && li < 0; ++b)
        if (nmask[b]) li = b;
      if (li < 0 && *P.fifo_head < *P.fifo_n)
        for (int b = 0; b < p.B && li < 0; ++b)
          if (rmask[b]) li = b;
      bool cand = false;
      if (li >= 0) {
        // 3. Its verdicts (hop_engine.py:634-657).
        sv = P.sv[li];
        for (int a = 0; a < 3; ++a) s[a] = P.start[3 * li + a];
        status = P.status[li];
        iters = P.iters[li];
        do_fin = status == kDoneEmpty || status == kDoneWeak ||
                 status == kDoneCap;
        const size_t at = vox(p, s[0], s[1], s[2]);
        const bool start_ok =
            seed_load(seeds + li * vol + at) >= p.verdict_t;
        claimed_at = ld(P.seg + sv * vol + at) > 0 ||
                     (P.blocked[sv * vol + at] & kClaimed) != 0;
        weak = status == kDoneWeak || !start_ok;
        invalid = iters <= 0;
        cand = do_fin && !invalid && !weak && !claimed_at;
        sid = P.next_sid[sv];
        ctrl[kSlot] = sv;
        ctrl[kSid] = sid;
      }
      ctrl[kLane] = li;
      ctrl[kCand] = cand;
      ctrl[kNvox] = 0;
    }
    grid_sync(ctrl);
    const int lane = ld(ctrl + kLane);
    if (lane < 0) break;
    const int slot = ld(ctrl + kSlot);
    const bool cand = ld(ctrl + kCand) != 0;
    const T* seed = seeds + lane * vol;
    int* seg = P.seg + slot * vol;
    const uint8_t* blk = P.blocked + slot * vol;

    // The masked count: an exact int32 sum over the grid.
    if (cand) {
      int count = 0;
      for (size_t i = tid; i < vol; i += stride)
        count += in_mask(seed_load(seed + i), ld(seg + i), blk[i], p.seg_t);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        count += __shfl_down_sync(0xffffffffu, count, off);
      if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = count;
      __syncthreads();
      if (threadIdx.x == 0) {
        int total = 0;
        for (int w = 0; w < kThreads / 32; ++w) total += warp_counts[w];
        if (total) atomicAdd(ctrl + kNvox, total);
      }
    }
    grid_sync(ctrl);
    const int nvox = ld(ctrl + kNvox);
    const bool ok = cand && nvox >= p.min_size;
    if (ok) {
      const int id = ld(ctrl + kSid);
      // Each voxel is read and written by one thread: the mask is the
      // count's.
      for (size_t i = tid; i < vol; i += stride)
        if (in_mask(seed_load(seed + i), ld(seg + i), blk[i], p.seg_t))
          seg[i] = id;
    }
    grid_sync(ctrl);

    if (leader) {
      // 4. The log row.
      if (ok) P.next_sid[sv] += 1;
      const int outcome = invalid ? kFinInvalid
                          : ok    ? kFinSegmented
                          : weak  ? kFinWeak
                          : claimed_at ? kFinClaimed
                                       : kFinTooSmall;
      if (do_fin) {
        const int ln = min(*P.log_n, p.L - 1);
        int* row = P.log + (size_t)ln * kLogColumns;
        const int vals[kLogColumns] = {sv,    ok ? sid : 0, s[0],    s[1],
                                       s[2],  iters,        nvox,    status,
                                       outcome, li};
        for (int c = 0; c < kLogColumns; ++c) row[c] = vals[c];
        *P.log_n += 1;
      }
      // 5. FIFO pops against the just-written segmentation.
      const int n = *P.fifo_n;
      const int head0 = *P.fifo_head;
      int h = head0;
      bool got = false;
      int pos2[3] = {s[0], s[1], s[2]}, sv2 = sv;
      while (h < n && !got) {
        const int* c = P.fifo_pos + 3 * h;
        const int csv = P.fifo_sv[h];
        const int k = clampi(csv, 0, p.K - 1);
        const size_t at = k * vol + vox(p, clampi(c[0], 0, p.Z - 1),
                                        clampi(c[1], 0, p.Y - 1),
                                        clampi(c[2], 0, p.X - 1));
        got = ld(P.seg + at) == 0 && (P.blocked[at] & kClaimed) == 0;
        ++h;
        if (got) {
          for (int a = 0; a < 3; ++a) pos2[a] = c[a];
          sv2 = csv;
        }
      }
      for (int i = head0; i < h - (got ? 1 : 0); ++i) {
        const int k = P.fifo_sv[i];
        if (k >= 0 && k < p.K) P.claimed[k] += 1;
      }
      *P.fifo_head = h;
      const int* lo = P.minp + 3 * li;
      const int* hi = P.maxp + 3 * li;
      const bool small = hi[0] - lo[0] <= p.bz - p.pz &&
                         hi[1] - lo[1] <= p.by - p.py &&
                         hi[2] - lo[2] <= p.bx - p.px;
      ctrl[kGot] = got;
      ctrl[kSmall] = small;
      ctrl[kCorner] = clamp_start(lo[0] + p.oz, p.Z, p.bz);
      ctrl[kCorner + 1] = clamp_start(lo[1] + p.oy, p.Y, p.by);
      ctrl[kCorner + 2] = clamp_start(lo[2] + p.ox, p.X, p.bx);
      for (int a = 0; a < 3; ++a) s[a] = pos2[a];
      sv = sv2;
      do_fin = got;  // reused below: whether the lane reseeds
    }
    grid_sync(ctrl);

    // The reseed's blank and dedup-grid clear.
    if (ld(ctrl + kGot)) {
      T* lane_seed = seeds + lane * vol;
      const float nan = f32_nan();
      if (ld(ctrl + kSmall)) {
        const int z0 = ld(ctrl + kCorner), y0 = ld(ctrl + kCorner + 1),
                  x0 = ld(ctrl + kCorner + 2);
        const size_t n = (size_t)p.bz * p.by * p.bx;
        for (size_t i = tid; i < n; i += stride) {
          const int c = i % p.bx, b = (i / p.bx) % p.by,
                    a = i / ((size_t)p.bx * p.by);
          seed_store(lane_seed + vox(p, z0 + a, y0 + b, x0 + c), nan);
        }
      } else {
        for (size_t i = tid; i < vol; i += stride)
          seed_store(lane_seed + i, nan);
      }
      uint8_t* dn = P.done + lane * (size_t)p.G;
      for (size_t i = tid; i < (size_t)p.G; i += stride) dn[i] = 0;
    }
    grid_sync(ctrl);

    if (leader) {
      const bool got = do_fin;
      if (got) {
        if (s[0] >= 0 && s[0] < p.Z && s[1] >= 0 && s[1] < p.Y &&
            s[2] >= 0 && s[2] < p.X)
          seed_store(seeds + li * vol + vox(p, s[0], s[1], s[2]),
                     p.init_act);
        int* q = P.qpos + (size_t)li * p.Q * 3;
        for (int a = 0; a < 3; ++a) {
          q[a] = s[a];
          P.start[3 * li + a] = s[a];
          P.minp[3 * li + a] = s[a];
          P.maxp[3 * li + a] = s[a];
        }
        P.qscore[(size_t)li * p.Q] = 2.0f * fabsf(p.move_t) + 1.0f;
        P.sv[li] = sv;
        P.head[li] = 0;
        P.tail[li] = 1;
      }
      P.iters[li] = 0;
      P.status[li] = got ? kRunning : kDoneFinalized;
      P.fresh[li] = got;
      nmask[li] = rmask[li] = 0;
    }
  }
}

template <typename T>
int launch_pass(FinPtrs P, FinParams p, void* stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, finalize_pass_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // One block per SM: every block resident, one barrier arrival per SM.
  const dim3 grid(sms), block(kThreads);
  void* args[] = {&P, &p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(finalize_pass_kernel<T>), grid, block, args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Lane state, finalize state and blocked as in ops/finalize.py; seeds
// bfloat16 where bf16 != 0, else float32; alive (1,) int32 or null; ctrl
// (16,) int32 zeroed scratch. move_t is the float32 move threshold (the dud
// kill, the reseed's queue score); verdict_t and seg_t are the thresholds
// the verdict and the claim mask compare seeds with (rounded to bfloat16
// for bfloat16 seeds).
extern "C" int ffn_finalize_pass(
    void* seeds, void* sv, void* qpos, void* qscore, void* head, void* tail,
    void* done, void* start, void* minp, void* maxp, void* iters,
    void* status, void* fresh, void* seg, void* next_sid,
    const void* fifo_pos, const void* fifo_sv, const void* fifo_n,
    void* fifo_head, void* log, void* log_n, const void* hold, void* claimed,
    const void* blocked, void* alive, void* ctrl, int B, int Q, int K, int Z,
    int Y, int X, long long G, int L, int pz, int py, int px, int bz, int by,
    int bx, int oz, int oy, int ox, int max_iters, int min_size,
    float move_t, float verdict_t, float seg_t, float init_act, int bf16,
    void* stream) {
  if (B < 1 || B > kMaxLanes) return static_cast<int>(cudaErrorInvalidValue);
  FinPtrs P{seeds,                            static_cast<int*>(sv),
            static_cast<int*>(qpos),          static_cast<float*>(qscore),
            static_cast<int*>(head),          static_cast<int*>(tail),
            static_cast<uint8_t*>(done),      static_cast<int*>(start),
            static_cast<int*>(minp),          static_cast<int*>(maxp),
            static_cast<int*>(iters),         static_cast<int*>(status),
            static_cast<uint8_t*>(fresh),     static_cast<int*>(seg),
            static_cast<int*>(next_sid),      static_cast<const int*>(fifo_pos),
            static_cast<const int*>(fifo_sv), static_cast<const int*>(fifo_n),
            static_cast<int*>(fifo_head),     static_cast<int*>(log),
            static_cast<int*>(log_n),         static_cast<const uint8_t*>(hold),
            static_cast<int*>(claimed),       static_cast<const uint8_t*>(blocked),
            static_cast<int*>(alive),         static_cast<int*>(ctrl)};
  FinParams p{B,  Q,  K,  Z,  Y,  X,  G,         L,        pz,     py,
              px, bz, by, bx, oz, oy, ox, max_iters, min_size, move_t,
              verdict_t, seg_t, init_act};
  return (bf16 ? launch_pass<__nv_bfloat16> : launch_pass<float>)(P, p,
                                                                   stream);
}
