// K8 finalize_pass: device finalization of finished lanes, one pass,
// replacing finalize_pass + finalize_one of HopEngine._run_hops_impl
// (ffn_tpu/inference/hop_engine.py:624-864); ops/finalize.py gives the
// semantics (dud kill, the sequential loop, verdicts, log row, FIFO pops,
// reseed) and where bfloat16 seeds round (one body templated on the seed
// type; the wrapper rounds the thresholds once).
//
// Bound on the H100: bandwidth and latency. A counting finalization reads
// the lane's seeds, the slot's segmentation and blocked volume once (9
// bytes a voxel in float32: 4.9 MB at 82^3) and writes the claims; the loop
// is sequential by design (each claim decides the next verdicts), so the
// time is the chain of dependent scalar steps and grid barriers between
// short scans. Design, one cooperative persistent launch a call (a block
// an SM):
// - The dud kill and the loop's cond: a thread a lane in every block (B <=
//   1024), the lane masks as bit words in shared memory. Block 0 writes the
//   statuses and `alive`; every block decides alone whether any turn runs,
//   so a pass that finalizes nothing has no barrier.
// - Two grid barriers a turn. Block 0's warp 0 (the leader) publishes the
//   turn (lane, slot, id, and the previous turn's blank) in scratch,
//   double-buffered by the turn's parity; barrier; blocks 1.. blank the
//   previous lane (each lane is taken at most once a pass, so its seeds are
//   not read again) and count the turn's mask (an exact int32 sum, one
//   atomicAdd a block) while the leader loads the FIFO's next 32 entries
//   and the next lane's fields; barrier; blocks 1.. write the ids while the
//   leader writes the log row, pops (a warp ballot over the 32 entries)
//   and decides the next turn. The pop and the next verdict test each
//   voxel against the segmentation as the write leaves it (`after_write`),
//   so they give the same answer whether they read it before or after a
//   block wrote it.
// - Scans 16 voxels a thread step: seeds by 16-byte loads (4 float32 or 8
//   bfloat16), seg by int4, blocked by 16 bytes; scalar heads and tails
//   where the lane's and the slot's offsets do not align together. Blanks
//   and the dedup clear store 16 bytes where aligned; the blank writes the
//   init activation where it covers the new origin.
// - The barrier's arrival count and generation lie on 128-byte lines of
//   their own and return to their start at every barrier, so the scratch
//   is zeroed once (the wrapper keeps one a device and stream).
// Reads of data the launch writes go through L2 (ld.cg).

#include "common.cuh"

namespace {

constexpr int kIdle = 0, kRunning = 1, kDoneEmpty = 2, kDoneWeak = 3,
              kDoneCap = 4, kDoneFinalized = 6;
constexpr int kFinSegmented = 1, kFinWeak = 2, kFinTooSmall = 3,
              kFinClaimed = 4, kFinInvalid = 5;
constexpr uint8_t kClaimed = 1;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 1024;
constexpr int kMaskWords = kMaxLanes / 32;
constexpr int kLogColumns = 10;

// Scratch layout (int32, kScratchInts, zeroed before the first call): the
// barrier's count and generation a 128-byte line each, then two turn
// buffers.
enum {
  kBarCount = 0,
  kBarGen = 32,
  kTurns = 64,
  kTurnInts = 16,
  kScratchInts = kTurns + 2 * kTurnInts,
};
// A turn buffer: this turn's lane (-1: the pass ends after the blank), its
// count's candidacy, slot and id, the voxel count's sum; the lane to blank
// (the previous turn's, if it reseeded; -1 none), small block or whole
// buffer, the block's corner, and the voxel of the lane's buffer that takes
// the init activation (-1: none).
enum {
  tLane = 0, tCand, tSlot, tSid, tNvox, tPrev, tSmall, tCz, tCy, tCx, tHit,
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
// residency): an arrival count and a generation on lines of their own; the
// last block to arrive resets the count and advances the generation.
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
      *gen = g + 1;
    } else {
      while (*gen == g) {
      }
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

// The bits a seed is stored as, and 16 seeds from a 16-byte-aligned p.
__device__ inline uint32_t seed_bits(float*, float v) {
  return __float_as_uint(v);
}
__device__ inline uint16_t seed_bits(__nv_bfloat16*, float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ inline void load16(const float* p, float (&f)[16]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p) + q);
    f[4 * q] = v.x;
    f[4 * q + 1] = v.y;
    f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
  }
}
__device__ inline void load16(const __nv_bfloat16* p, float (&f)[16]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint4 v = __ldcg(reinterpret_cast<const uint4*>(p) + q);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[8 * q + 2 * j] = __uint_as_float(w[j] << 16);
      f[8 * q + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

// One turn's voxels: the lane's seeds, the slot's segmentation and blocked
// volume. Voxel i starts a 16-voxel chunk where blocked + i is 16-byte
// aligned; when seg and the seeds align there too, the chunks between a
// scalar head and tail load 16 bytes at a time, else every voxel is scalar.
template <typename T>
struct Scan {
  const T* seed;
  int* seg;
  const uint8_t* blk;
  size_t vol, head, chunks, tail;

  __device__ Scan(const T* seed_, int* seg_, const uint8_t* blk_, size_t v)
      : seed(seed_), seg(seg_), blk(blk_), vol(v) {
    head = (16 - (reinterpret_cast<uintptr_t>(blk) & 15)) & 15;
    if (head > vol ||
        (reinterpret_cast<uintptr_t>(seg + head) & 15) != 0 ||
        (reinterpret_cast<uintptr_t>(seed + head) & 15) != 0)
      head = vol;
    chunks = (vol - head) / 16;
    tail = head + 16 * chunks;
  }
  __device__ size_t scalars() const { return head + vol - tail; }
  __device__ size_t scalar_at(size_t j) const {
    return j < head ? j : tail + (j - head);
  }
  __device__ bool mask(size_t i, float t) const {
    return in_mask(seed_load(seed + i), ld(seg + i), blk[i], t);
  }
  // Bit v set where voxel head + 16 c + v is in the mask; s: its seg.
  __device__ unsigned mask16(size_t c, float t, int4 (&s)[4]) const {
    const size_t i = head + 16 * c;
    const uint4 b4 = __ldg(reinterpret_cast<const uint4*>(blk + i));
#pragma unroll
    for (int q = 0; q < 4; ++q)
      s[q] = __ldcg(reinterpret_cast<const int4*>(seg + i) + q);
    float f[16];
    load16(seed + i, f);
    const uint32_t bw[4] = {b4.x, b4.y, b4.z, b4.w};
    unsigned m = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int sq[4] = {s[q].x, s[q].y, s[q].z, s[q].w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        m |= (unsigned)in_mask(f[4 * q + j], sq[j],
                               (uint8_t)(bw[q] >> (8 * j)), t)
             << (4 * q + j);
    }
    return m;
  }
};

// Stores v over the n elements at p (hv at element `hit`, if < n): scalar
// head and tail, 16 bytes a store between; thread t of nt.
template <typename E>
__device__ void fill_span(E* p, size_t n, E v, size_t hit, E hv, size_t t,
                          size_t nt) {
  constexpr int V = 16 / sizeof(E);
  size_t head = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) /
                sizeof(E);
  if (head > n) head = n;
  const size_t chunks = (n - head) / V, tail = head + V * chunks;
  for (size_t j = t; j < head + n - tail; j += nt) {
    const size_t i = j < head ? j : tail + (j - head);
    p[i] = i == hit ? hv : v;
  }
  for (size_t c = t; c < chunks; c += nt) {
    union {
      uint4 u;
      E e[V];
    } w;
#pragma unroll
    for (int k = 0; k < V; ++k) w.e[k] = v;
    const size_t i = head + V * c;
    if (hit >= i && hit < i + V) w.e[hit - i] = hv;
    *reinterpret_cast<uint4*>(p + i) = w.u;
  }
}

// The segmentation value at a voxel once this turn's id write is done,
// from its value now (before or after the write, both give the same): the
// write puts `sid` where the mask of the turn's lane holds.
__device__ inline int after_write(int seg, uint8_t blk, bool pending,
                                  float seed, float seg_t, int sid) {
  return pending && in_mask(seed, seg, blk, seg_t) ? sid : seg;
}

// The leader's state: a turn's lane, what it loaded for the lane's
// verdicts (before the running turn's write is known), and the verdicts.
struct Lane {
  int li, sv, s[3], status, iters, lo[3], hi[3], sid, seg0;
  float origin, pv;  // the lane's seed at its start; the running turn's
  uint8_t blk;
  bool do_fin, weak, invalid, claimed_at, cand;
};

// FIFO entry `e` as the pop tests it: its slot (raw and clamped), position,
// and the voxel's seg, blocked byte and, in the running turn's slot, that
// turn's seed there.
struct Entry {
  int csv, k, c[3], seg0;
  uint8_t blk;
  float pv;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
finalize_pass_kernel(FinPtrs P, FinParams p) {
  T* const seeds = static_cast<T*>(P.seeds);
  using Bits = decltype(seed_bits(seeds, 0.f));
  __shared__ unsigned nmask[kMaskWords], rmask[kMaskWords];
  __shared__ uint8_t status_s[kMaxLanes];
  __shared__ int warp_counts[kWarps];
  __shared__ int turn_s[kTurnInts];
  const size_t vol = (size_t)p.Z * p.Y * p.X;
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const bool lead_block = blockIdx.x == 0;
  const bool leader = lead_block && warp == 0;
  volatile int* const turns =
      reinterpret_cast<volatile int*>(P.ctrl + kTurns);

  // 1. The same-hop dud kill and the loop's cond on the entry state, a
  // thread a lane. Every block decides whether a turn runs; block 0 writes
  // the killed lanes' statuses (another block may read either status of a
  // killed lane: both give the same masks).
  if (threadIdx.x < kMaskWords) nmask[threadIdx.x] = rmask[threadIdx.x] = 0;
  __syncthreads();
  bool any_running = false, any_n = false, any_r = false;
  for (int b0 = 0; b0 < p.B; b0 += kThreads) {
    const int b = b0 + threadIdx.x;
    bool n = false, r = false;
    if (b < p.B) {
      int st = ld(P.status + b);
      const bool running = st == kRunning;
      const bool capped =
          running && p.max_iters > 0 && P.iters[b] >= p.max_iters;
      bool weak_now = false;
      if (running && !capped && !P.fresh[b]) {
        const int* o = P.start + 3 * b;
        weak_now = !(seed_load(seeds + b * vol + vox(p, o[0], o[1], o[2])) >=
                     p.move_t);
      }
      if (capped) st = kDoneCap;
      else if (weak_now) st = kDoneWeak;
      if (lead_block) {
        status_s[b] = st;
        if (capped || weak_now) P.status[b] = st;
      }
      any_running |= running;
      n = (st == kDoneEmpty && !P.hold[b]) || st == kDoneWeak ||
          st == kDoneCap;
      r = st == kIdle || st == kDoneFinalized;
    }
    const unsigned nb = __ballot_sync(0xffffffffu, n);
    const unsigned rb = __ballot_sync(0xffffffffu, r);
    if (wl == 0) {
      nmask[(b0 >> 5) + warp] = nb;
      rmask[(b0 >> 5) + warp] = rb;
    }
    any_n |= n;
    any_r |= r;
  }
  any_running = __syncthreads_or(any_running);
  any_n = __syncthreads_or(any_n);
  any_r = __syncthreads_or(any_r);
  const int fifo_n = ld(P.fifo_n);
  int fifo_head = ld(P.fifo_head);
  const bool work = any_n || (any_r && fifo_head < fifo_n);
  if (lead_block && threadIdx.x == 0 && P.alive)
    *P.alive = any_running || work;
  if (!work) return;

  // The leader's state (warp 0 of block 0; lane 0 holds the scalars).
  Lane cur{};
  int log_n = 0;

  // The first set bit of a mask's words, -1 if none (warp 0).
  auto first_of = [&](const unsigned* mask) {
    const unsigned w = __ballot_sync(0xffffffffu, mask[wl] != 0);
    return w ? 32 * (__ffs(w) - 1) + __ffs(mask[__ffs(w) - 1]) - 1 : -1;
  };
  // Lane li's loads on lane 0 (hop_engine.py:634-657): its fields and, for
  // a finisher, the voxel at its start in its slot, with `pseed` (the
  // running turn's lane, writing slot `pslot`; null: none) there.
  auto fetch = [&](int li, const T* pseed, int pslot) {
    Lane c{};
    c.li = li;
    if (li < 0 || wl != 0) return c;
    c.sv = P.sv[li];
    for (int a = 0; a < 3; ++a) {
      c.s[a] = P.start[3 * li + a];
      c.lo[a] = P.minp[3 * li + a];
      c.hi[a] = P.maxp[3 * li + a];
    }
    c.status = status_s[li];
    c.iters = P.iters[li];
    c.sid = ld(P.next_sid + c.sv);
    c.do_fin = c.status == kDoneEmpty || c.status == kDoneWeak ||
               c.status == kDoneCap;
    if (c.do_fin) {
      const size_t at = vox(p, c.s[0], c.s[1], c.s[2]);
      const size_t kat = (size_t)c.sv * vol + at;
      c.origin = seed_load(seeds + li * vol + at);
      c.seg0 = ld(P.seg + kat);
      c.blk = P.blocked[kat];
      c.pv = pseed && c.sv == pslot ? seed_load(pseed + at) : 0.f;
    }
    return c;
  };
  // Lane c's verdicts once the running turn's count is known: `ok`, it
  // writes `pid` in slot `pslot` and takes next_sid[pslot].
  auto resolve = [&](Lane& c, bool ok, int pslot, int pid) {
    if (c.li < 0 || wl != 0) return;
    const bool pending = ok && c.sv == pslot;
    c.sid += pending;
    c.invalid = c.iters <= 0;
    if (c.do_fin) {
      const int seg = after_write(c.seg0, c.blk, pending, c.pv, p.seg_t, pid);
      c.weak = c.status == kDoneWeak || !(c.origin >= p.verdict_t);
      c.claimed_at = seg > 0 || (c.blk & kClaimed) != 0;
      c.cand = !c.invalid && !c.weak && !c.claimed_at;
    }
  };
  auto fetch_entry = [&](int e, const T* lseed, int slot) {
    Entry en{};
    en.csv = -1;
    if (e >= fifo_n) return en;
    en.csv = P.fifo_sv[e];
    for (int a = 0; a < 3; ++a) en.c[a] = P.fifo_pos[3 * e + a];
    en.k = clampi(en.csv, 0, p.K - 1);
    const size_t at = vox(p, clampi(en.c[0], 0, p.Z - 1),
                          clampi(en.c[1], 0, p.Y - 1),
                          clampi(en.c[2], 0, p.X - 1));
    const size_t kat = en.k * vol + at;
    en.seg0 = ld(P.seg + kat);
    en.blk = P.blocked[kat];
    en.pv = en.k == slot ? seed_load(lseed + at) : 0.f;
    return en;
  };
  auto publish = [&](int par, const Lane& c, int prev, int small, int cz,
                     int cy, int cx, int hit) {
    if (wl != 0) return;
    volatile int* t = turns + par * kTurnInts;
    t[tLane] = c.li;
    t[tCand] = c.cand;
    t[tSlot] = c.sv;
    t[tSid] = c.sid;
    t[tNvox] = 0;
    t[tPrev] = prev;
    t[tSmall] = small;
    t[tCz] = cz;
    t[tCy] = cy;
    t[tCx] = cx;
    t[tHit] = hit;
  };

  if (leader) {
    log_n = ld(P.log_n);
    const int nl = first_of(nmask);
    cur = fetch(nl >= 0 ? nl : first_of(rmask), nullptr, -1);
    resolve(cur, false, -1, 0);
    publish(0, cur, -1, 0, 0, 0, 0, -1);
  }

  // Blocks 1.. scan, blank and write (block 0 too when it is alone); block
  // 0's warp 0 leads.
  const bool worker = gridDim.x == 1 || !lead_block;
  const size_t wblock = lead_block ? 0 : blockIdx.x - 1;
  const size_t nworkers = gridDim.x == 1 ? 1 : gridDim.x - 1;
  const size_t nthreads = nworkers * kThreads;
  const size_t tid = wblock * kThreads + threadIdx.x;
  const Bits nan_bits = seed_bits(seeds, f32_nan());
  const Bits init_bits = seed_bits(seeds, p.init_act);
  for (int par = 0;; par ^= 1) {
    grid_sync(P.ctrl);
    if (threadIdx.x < kTurnInts)
      turn_s[threadIdx.x] = turns[par * kTurnInts + threadIdx.x];
    __syncthreads();
    const int lane = turn_s[tLane], prev = turn_s[tPrev];

    // The previous turn's reseed: the blank (small block or the whole
    // buffer, the init activation where it covers the new origin) and the
    // cleared dedup grid.
    if (prev >= 0 && worker) {
      Bits* lb = reinterpret_cast<Bits*>(seeds + prev * vol);
      const int hit = turn_s[tHit];
      if (turn_s[tSmall]) {
        const int z0 = turn_s[tCz], y0 = turn_s[tCy], x0 = turn_s[tCx];
        const int hz = hit / (p.Y * p.X), hy = hit / p.X % p.Y,
                  hx = hit % p.X;
        const bool covered = hit >= 0 && hz >= z0 && hz < z0 + p.bz &&
                             hy >= y0 && hy < y0 + p.by && hx >= x0 &&
                             hx < x0 + p.bx;
        for (size_t r = wblock * kWarps + warp; r < (size_t)p.bz * p.by;
             r += nworkers * kWarps) {
          const int z = z0 + r / p.by, y = y0 + r % p.by;
          fill_span(lb + vox(p, z, y, x0), p.bx, nan_bits,
                    covered && z == hz && y == hy ? (size_t)(hx - x0)
                                                  : (size_t)-1,
                    init_bits, wl, 32);
        }
        if (hit >= 0 && !covered && tid == 0) lb[hit] = init_bits;
      } else {
        fill_span(lb, vol, nan_bits, hit < 0 ? (size_t)-1 : (size_t)hit,
                  init_bits, tid, nthreads);
      }
      fill_span(P.done + prev * (size_t)p.G, (size_t)p.G, (uint8_t)0,
                (size_t)-1, (uint8_t)0, tid, nthreads);
    }
    if (lane < 0) break;

    const int slot = turn_s[tSlot], id = turn_s[tSid];
    const T* const lseed = seeds + lane * vol;
    const Scan<T> scan(lseed, P.seg + slot * vol, P.blocked + slot * vol,
                       vol);
    // The masked count: an exact int32 sum over the workers.
    if (turn_s[tCand] && worker) {
      int count = 0;
      for (size_t j = tid; j < scan.scalars(); j += nthreads)
        count += scan.mask(scan.scalar_at(j), p.seg_t);
      for (size_t c = tid; c < scan.chunks; c += nthreads) {
        int4 s[4];
        count += __popc(scan.mask16(c, p.seg_t, s));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        count += __shfl_down_sync(0xffffffffu, count, off);
      if (wl == 0) warp_counts[warp] = count;
      __syncthreads();
      if (threadIdx.x == 0) {
        int total = 0;
        for (int w = 0; w < kWarps; ++w) total += warp_counts[w];
        if (total) atomicAdd((int*)(turns + par * kTurnInts + tNvox), total);
      }
    }
    // Meanwhile the leader loads what its part of the turn reads: the
    // FIFO's next 32 entries and the next lane (the lowest finisher left,
    // else the lowest idle or finalized lane); none of it is written before
    // the write, which the tests below allow for.
    const int li = cur.li;
    Entry en{};
    Lane next{};
    int spec_r = -1;
    if (leader) {
      if (wl == 0) {
        nmask[li >> 5] &= ~(1u << (li & 31));
        rmask[li >> 5] &= ~(1u << (li & 31));
      }
      __syncwarp();
      en = fetch_entry(fifo_head + wl, lseed, slot);
      const int nl = first_of(nmask);
      spec_r = nl >= 0 ? -1 : first_of(rmask);
      next = fetch(nl >= 0 ? nl : spec_r, lseed, slot);
    }
    grid_sync(P.ctrl);
    const int nvox = turns[par * kTurnInts + tNvox];
    const bool ok = turn_s[tCand] && nvox >= p.min_size;

    // The id write; each voxel is read and written by one thread, the mask
    // the count's.
    if (ok && worker) {
      for (size_t j = tid; j < scan.scalars(); j += nthreads) {
        const size_t i = scan.scalar_at(j);
        if (scan.mask(i, p.seg_t)) scan.seg[i] = id;
      }
      for (size_t c = tid; c < scan.chunks; c += nthreads) {
        int4 s[4];
        const unsigned m = scan.mask16(c, p.seg_t, s);
        if (!m) continue;
        int4* out = reinterpret_cast<int4*>(scan.seg + scan.head + 16 * c);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const unsigned mq = m >> (4 * q) & 15;
          if (!mq) continue;
          int4 v = s[q];
          if (mq & 1) v.x = id;
          if (mq & 2) v.y = id;
          if (mq & 4) v.z = id;
          if (mq & 8) v.w = id;
          out[q] = v;
        }
      }
    }
    if (!leader) continue;

    // The leader, beside the write: the log row, the FIFO pops, the next
    // turn.
    if (wl == 0) {
      if (ok) P.next_sid[cur.sv] = cur.sid + 1;
      if (cur.do_fin) {
        const int outcome = cur.invalid      ? kFinInvalid
                            : ok             ? kFinSegmented
                            : cur.weak       ? kFinWeak
                            : cur.claimed_at ? kFinClaimed
                                             : kFinTooSmall;
        int* row = P.log + (size_t)min(log_n, p.L - 1) * kLogColumns;
        const int vals[kLogColumns] = {cur.sv,   ok ? cur.sid : 0,
                                       cur.s[0], cur.s[1],
                                       cur.s[2], cur.iters,
                                       nvox,     cur.status,
                                       outcome,  li};
        for (int c = 0; c < kLogColumns; ++c) row[c] = vals[c];
        P.log_n[0] = ++log_n;
      }
    }
    // FIFO pops, 32 entries a step: an entry is free where the
    // segmentation as the write leaves it and the claimed bit leave it
    // free; the entries before the first free one are skipped, counted per
    // slot.
    bool got = false;
    int pos2[3] = {0, 0, 0}, sv2 = 0;
    while (fifo_head < fifo_n) {
      const int e = fifo_head + wl;
      const bool free =
          e < fifo_n &&
          after_write(en.seg0, en.blk, ok && en.k == slot, en.pv, p.seg_t,
                      id) == 0 &&
          (en.blk & kClaimed) == 0;
      const unsigned freem = __ballot_sync(0xffffffffu, free);
      const int first = freem ? __ffs(freem) - 1 : 32;
      const bool skip = wl < first && en.csv >= 0 && en.csv < p.K;
      const unsigned same = __match_any_sync(0xffffffffu,
                                             skip ? en.csv : -1);
      if (skip && wl == __ffs(same) - 1)
        atomicAdd(P.claimed + en.csv, __popc(same));
      if (freem) {
        got = true;
        for (int a = 0; a < 3; ++a)
          pos2[a] = __shfl_sync(0xffffffffu, en.c[a], first);
        sv2 = __shfl_sync(0xffffffffu, en.csv, first);
        fifo_head += first + 1;
        break;
      }
      fifo_head = min(fifo_head + 32, fifo_n);
      en = fetch_entry(fifo_head + wl, lseed, slot);
    }
    // The next lane's verdicts; an idle lane only while the FIFO holds
    // entries.
    if (spec_r >= 0 && fifo_head >= fifo_n) next = fetch(-1, nullptr, -1);
    resolve(next, ok, slot, id);

    // Lane li's reseed (hop_engine.py:729-802): its fields now; the blank,
    // the init activation and the cleared dedup grid with the next turn,
    // after this turn's write has read the seeds.
    int small = 0, corner[3] = {0, 0, 0}, hit = -1;
    if (wl == 0) {
      P.fifo_head[0] = fifo_head;
      if (got) {
        small = cur.hi[0] - cur.lo[0] <= p.bz - p.pz &&
                cur.hi[1] - cur.lo[1] <= p.by - p.py &&
                cur.hi[2] - cur.lo[2] <= p.bx - p.px;
        corner[0] = clamp_start(cur.lo[0] + p.oz, p.Z, p.bz);
        corner[1] = clamp_start(cur.lo[1] + p.oy, p.Y, p.by);
        corner[2] = clamp_start(cur.lo[2] + p.ox, p.X, p.bx);
        if (pos2[0] >= 0 && pos2[0] < p.Z && pos2[1] >= 0 && pos2[1] < p.Y &&
            pos2[2] >= 0 && pos2[2] < p.X)
          hit = (int)vox(p, pos2[0], pos2[1], pos2[2]);
        int* q = P.qpos + (size_t)li * p.Q * 3;
        for (int a = 0; a < 3; ++a) {
          q[a] = pos2[a];
          P.start[3 * li + a] = pos2[a];
          P.minp[3 * li + a] = pos2[a];
          P.maxp[3 * li + a] = pos2[a];
        }
        P.qscore[(size_t)li * p.Q] = 2.0f * fabsf(p.move_t) + 1.0f;
        P.sv[li] = sv2;
        P.head[li] = 0;
        P.tail[li] = 1;
      }
      P.iters[li] = 0;
      P.status[li] = got ? kRunning : kDoneFinalized;
      P.fresh[li] = got;
    }
    publish(par ^ 1, next, got ? li : -1, small, corner[0], corner[1],
            corner[2], hit);
    cur = next;
  }
}

// The grid (a block an SM) by device, found at the device's first call.
constexpr int kMaxDevices = 64;
int grid_blocks[2][kMaxDevices];

template <typename T>
int launch_pass(FinPtrs P, FinParams p, void* stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int& sms = grid_blocks[sizeof(T) == 2][device];
  if (sms == 0) {
    int n = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, finalize_pass_kernel<T>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    sms = n;
  }
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
// (kScratchInts = 96,) int32 scratch, zeroed before its first call and left
// ready for the next (one a stream: calls on it run one after another).
// move_t is the float32 move threshold (the dud kill, the reseed's queue
// score); verdict_t and seg_t are the thresholds the verdict and the claim
// mask compare seeds with (rounded to bfloat16 for bfloat16 seeds).
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
