// K4 hop_pop, K5 hop_gather and K6 hop_update: one hop of the batched
// flood fill around the conv stack, replacing the non-model parts of
// HopEngine._run_hops_impl (ffn_tpu/inference/hop_engine.py:535-1046);
// ops/hop.py gives the semantics, line by line, and where bfloat16 seeds
// round (one body per kernel, templated on the seed type, common.cuh).
//
// Bound on the H100: latency. A hop moves a few MB (144 KB patches each
// way) beside the conv's ~46 GFLOP a lane, and K4's work is a dependent
// chain of small gathers per lane. Design: K4 is one CTA with a thread per
// lane, so a block-wide scan of the execute flags gives the exec-first
// order and n_exec in the same launch; a lane's drain is sequential, as
// the FIFO is. K5 is one elementwise grid, a y-row of blocks per bucket
// slot. K6 is one CTA per executing lane: it counts the disco fraction,
// writes the patch to scratch and copies it into the seed buffer only after
// a barrier (the box it reads `old` from and the box it writes may differ
// near a face); six warps take the face maxima (first index among equal
// maxima, NaN above all, as jnp.argmax) and one thread sorts and pushes the
// six moves. Starts follow lax.dynamic_slice (wrap once, then clamp).

#include "common.cuh"

namespace {

constexpr int kRunning = 1, kDoneEmpty = 2, kDoneWeak = 3, kDoneCap = 4,
              kStalledFull = 5;
constexpr uint8_t kClaimed = 1, kRestricted = 2;

// Python's floor division (the dedup-grid cells of a position below the
// segment origin are negative before the offset).
__device__ inline int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

struct Geom {
  int Z, Y, X;     // volume (stack slot) shape
  int G0, G1, G2;  // dedup grid shape
  int d0, d1, d2;  // deltas, at least 1
  int o0, o1, o2;  // dedup grid offset
};

__device__ inline size_t grid_index(const Geom& g, int z, int y, int x,
                                    int sz, int sy, int sx) {
  const int c0 = clampi(floordiv(z - sz + g.d0 / 2, g.d0) + g.o0, 0, g.G0 - 1);
  const int c1 = clampi(floordiv(y - sy + g.d1 / 2, g.d1) + g.o1, 0, g.G1 - 1);
  const int c2 = clampi(floordiv(x - sx + g.d2 / 2, g.d2) + g.o2, 0, g.G2 - 1);
  return ((size_t)c0 * g.G1 + c1) * g.G2 + c2;
}

// -- K4 -----------------------------------------------------------------------

struct PopParams {
  Geom g;
  int B, Q;
  int m0, m1, m2;  // margin: image_size // 2
  int max_iters;
  float move_t;
};

template <typename T>
__global__ void hop_pop_kernel(
    const uint8_t* __restrict__ blocked, const int* __restrict__ seg,
    const int* __restrict__ shapes,
    const T* __restrict__ seeds, const int* __restrict__ sv,
    const int* __restrict__ qpos, int* head, const int* __restrict__ tail,
    const uint8_t* __restrict__ done, const int* __restrict__ start,
    const int* __restrict__ iters, int* status,
    const uint8_t* __restrict__ fresh, int* skip_t, int* skip_i, int* skip_r,
    int* executed, int* pops, int* pos_out, uint8_t* exec_out, int* order,
    int* summary, PopParams p) {
  __shared__ int warp_exec[32], warp_run[32];
  __shared__ int n_exec_s;
  const Geom& g = p.g;
  const int b = threadIdx.x;
  bool ex = false, still_running = false;
  if (b < p.B) {
    const size_t vol = (size_t)g.Z * g.Y * g.X;
    const T* seed = seeds + (size_t)b * vol;
    int st = status[b];
    bool running = st == kRunning;
    if (running && p.max_iters > 0 && iters[b] >= p.max_iters) {
      st = kDoneCap;
      running = false;
    }
    const int sz = start[3 * b], sy = start[3 * b + 1], sx = start[3 * b + 2];
    const bool fr = fresh[b] != 0;
    const float origin = seed_load(seed + ((size_t)sz * g.Y + sy) * g.X + sx);
    if (running && !fr && !(origin >= p.move_t)) {  // NaN counts as weak
      st = kDoneWeak;
      running = false;
    }
    int h = head[b];
    const int t = tail[b];
    if (running && t - h > p.Q - 6) {
      st = kStalledFull;
      running = false;
    }
    const int k = sv[b];
    const int ez = shapes[3 * k], ey = shapes[3 * k + 1],
              ex_ = shapes[3 * k + 2];
    const uint8_t* blk = blocked + (size_t)k * vol;
    const int* sg = seg ? seg + (size_t)k * vol : nullptr;
    const uint8_t* dn = done + (size_t)b * g.G0 * g.G1 * g.G2;
    int cst = 0, csi = 0, csr = 0;
    int pz = sz, py = sy, px = sx;
    bool found = false;
    const int h0 = h;
    if (running) {
      for (; h < t; ++h) {
        const int* c = qpos + ((size_t)b * p.Q + (h % p.Q)) * 3;
        const int cz = c[0], cy = c[1], cx = c[2];
        if (fr) {
          found = true;
        } else {
          const bool in_bounds = cz - p.m0 >= 0 && cy - p.m1 >= 0 &&
                                 cx - p.m2 >= 0 && cz + p.m0 < ez &&
                                 cy + p.m1 < ey && cx + p.m2 < ex_;
          const size_t safe = ((size_t)clampi(cz, 0, g.Z - 1) * g.Y +
                               clampi(cy, 0, g.Y - 1)) * g.X +
                              clampi(cx, 0, g.X - 1);
          const uint8_t code = blk[safe];
          const bool is_blocked =
              (code & kClaimed) != 0 || (sg && sg[safe] > 0);
          const bool is_restricted = (code & kRestricted) != 0;
          const bool is_done = dn[grid_index(g, cz, cy, cx, sz, sy, sx)] != 0;
          const bool weak = !(seed_load(seed + safe) >= p.move_t);
          found = in_bounds && !is_blocked && !is_restricted && !is_done &&
                  !weak;
          if (!found && !is_done) {  // dedup discards are uncounted
            if (!in_bounds || is_blocked) ++csi;
            else if (is_restricted) ++csr;
            else ++cst;
          }
        }
        if (found) {
          pz = cz;
          py = cy;
          px = cx;
          break;
        }
      }
    }
    const int n_pop = h - h0 + (found ? 1 : 0);
    if (found) ++h;
    if (running && !found) st = kDoneEmpty;
    ex = running && found;
    still_running = st == kRunning;
    head[b] = h;
    status[b] = st;
    skip_t[b] += cst;
    skip_i[b] += csi;
    skip_r[b] += csr;
    executed[b] += ex ? 1 : 0;
    pops[b] += n_pop;
    // Clip so the patch of an idle lane stays in bounds (:906).
    pos_out[3 * b] = min(max(pz, p.m0), ez - 1 - p.m0);
    pos_out[3 * b + 1] = min(max(py, p.m1), ey - 1 - p.m1);
    pos_out[3 * b + 2] = min(max(px, p.m2), ex_ - 1 - p.m2);
    exec_out[b] = ex ? 1 : 0;
  }

  // Exec-first order: executing lanes at their rank among executing lanes,
  // the others after them at their rank among the others.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned exec_bits = __ballot_sync(0xffffffffu, ex);
  const unsigned run_bits = __ballot_sync(0xffffffffu, still_running);
  if (lane == 0) {
    warp_exec[warp] = __popc(exec_bits);
    warp_run[warp] = __popc(run_bits);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0, running_total = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      const int c = warp_exec[w];
      warp_exec[w] = acc;
      acc += c;
      running_total += warp_run[w];
    }
    n_exec_s = acc;
    summary[0] = acc;
    summary[1] = running_total;
  }
  __syncthreads();
  if (b < p.B) {
    const int rank =
        warp_exec[warp] + __popc(exec_bits & ((1u << lane) - 1u));
    order[ex ? rank : n_exec_s + (b - rank)] = b;
  }
}

// -- K5 -----------------------------------------------------------------------

struct GatherParams {
  int S, K, Z, Y, X;
  int iz, iy, ix;  // image patch size
  int sz, sy, sx;  // seed patch size
  float pad, init;
};

template <typename T>
__global__ void hop_gather_kernel(const float* __restrict__ image,
                                  const T* __restrict__ seeds,
                                  const int* __restrict__ sv,
                                  const int* __restrict__ pos,
                                  const int* __restrict__ lanes,
                                  float* __restrict__ img_out,
                                  float* __restrict__ seed_out,
                                  GatherParams p) {
  const int s = blockIdx.y;
  const int lane = lanes ? lanes[s] : s;
  const int pz = pos[3 * lane], py = pos[3 * lane + 1], px = pos[3 * lane + 2];
  const size_t vol = (size_t)p.Z * p.Y * p.X;
  const int n_img = p.iz * p.iy * p.ix, n_seed = p.sz * p.sy * p.sx;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_img) {
    const int k = clamp_start(sv[lane], p.K, 1);
    const int z0 = clamp_start(pz - p.iz / 2, p.Z, p.iz);
    const int y0 = clamp_start(py - p.iy / 2, p.Y, p.iy);
    const int x0 = clamp_start(px - p.ix / 2, p.X, p.ix);
    const int c = i % p.ix, b = (i / p.ix) % p.iy, a = i / (p.ix * p.iy);
    img_out[(size_t)s * n_img + i] =
        image[k * vol + ((size_t)(z0 + a) * p.Y + y0 + b) * p.X + x0 + c];
  }
  if (i < n_seed) {
    const int c = i % p.sx, b = (i / p.sx) % p.sy, a = i / (p.sx * p.sy);
    float v;
    if (seeds) {
      const int z0 = clamp_start(pz - p.sz / 2, p.Z, p.sz);
      const int y0 = clamp_start(py - p.sy / 2, p.Y, p.sy);
      const int x0 = clamp_start(px - p.sx / 2, p.X, p.sx);
      v = seed_load(seeds + lane * vol +
                    ((size_t)(z0 + a) * p.Y + y0 + b) * p.X + x0 + c);
    } else {  // screening: NaN but for init at the center
      v = (a == p.sz / 2 && b == p.sy / 2 && c == p.sx / 2) ? p.init : f32_nan();
    }
    seed_out[(size_t)s * n_seed + i] = isnan(v) ? p.pad : v;
  }
}

// -- K6 -----------------------------------------------------------------------

constexpr int kUpdateThreads = 1024;

struct UpdateParams {
  Geom g;
  int Q;
  int fz, fy, fx;  // seed patch (= model output) size
  int qz, qy, qx;  // pred size
  int r0, r1, r2;  // raw deltas (0 disables an axis's faces)
  float move_t, disco_t;
};

// Strict order of jnp.lexsort((-off2, -off1, -off0, -scores)): score
// descending with NaN last, then the offsets descending.
__device__ inline bool sorts_before(float sa, const int* oa, float sb,
                                    const int* ob) {
  const float ka = -sa, kb = -sb;
  const bool na = isnan(ka), nb = isnan(kb);
  if (na != nb) return nb;
  if (!na) {
    if (ka < kb) return true;
    if (kb < ka) return false;
  }
  for (int a = 0; a < 3; ++a) {
    if (oa[a] != ob[a]) return oa[a] > ob[a];
  }
  return false;
}

template <typename T>
__global__ void __launch_bounds__(kUpdateThreads)
hop_update_kernel(const float* __restrict__ logits, T* seeds,
                  const int* __restrict__ pos,
                  const uint8_t* __restrict__ execute,
                  const int* __restrict__ lanes, const int* __restrict__ start,
                  uint8_t* done, int* minp, int* maxp, int* iters,
                  uint8_t* fresh, int* qpos, float* qscore,
                  const int* __restrict__ head, int* tail, int* overflow,
                  float* __restrict__ patch_out, UpdateParams p) {
  __shared__ int warp_counts[kUpdateThreads / 32];
  __shared__ float face_score[6];
  __shared__ int face_off[6][3];
  const Geom& g = p.g;
  const int s = blockIdx.x;
  const int lane = lanes[s];
  if (!execute[lane]) return;  // uniform over the block: an idle lane
  const int pz = pos[3 * lane], py = pos[3 * lane + 1], pxx = pos[3 * lane + 2];
  const size_t vol = (size_t)g.Z * g.Y * g.X;
  T* seed = seeds + (size_t)lane * vol;
  const float* lg = logits + (size_t)s * p.fz * p.fy * p.fx;
  float* patch = patch_out + (size_t)s * p.qz * p.qy * p.qx;
  const int dz = (p.fz - p.qz) / 2, dy = (p.fy - p.qy) / 2,
            dx = (p.fx - p.qx) / 2;
  const int sz0 = pz - p.fz / 2, sy0 = py - p.fy / 2, sx0 = pxx - p.fx / 2;
  // `old` of the disco mask: the crop of the clamped seed patch
  // (engine.py:105). The write box: seed start + pred delta, clamped on its
  // own (hop_engine.py:979-985).
  const int oz = clamp_start(sz0, g.Z, p.fz) + dz,
            oy = clamp_start(sy0, g.Y, p.fy) + dy,
            ox = clamp_start(sx0, g.X, p.fx) + dx;
  const int wz = clamp_start(sz0 + dz, g.Z, p.qz),
            wy = clamp_start(sy0 + dy, g.Y, p.qy),
            wx = clamp_start(sx0 + dx, g.X, p.qx);
  const int n = p.qz * p.qy * p.qx;

  const bool apply = disco_applies(lg, p.fz, p.fy, p.fx, p.qz, p.qy, p.qx,
                                   p.move_t, p.disco_t, warp_counts);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i % p.qx, b = (i / p.qx) % p.qy, a = i / (p.qx * p.qy);
    const float v = lg[((size_t)(a + dz) * p.fy + b + dy) * p.fx + c + dx];
    const float old =
        seed_load(seed + ((size_t)(oz + a) * g.Y + oy + b) * g.X + ox + c);
    // (old < 0) is false for NaN: unvisited voxels always take the update.
    patch[i] = seed_round<T>((apply && old < 0.f && v > old) ? old : v);
  }
  __syncthreads();  // every `old` is read before any seed voxel is written
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i % p.qx, b = (i / p.qx) % p.qy, a = i / (p.qx * p.qy);
    seed_store(seed + ((size_t)(wz + a) * g.Y + wy + b) * g.X + wx + c,
               patch[i]);
  }

  // Face maxima: warp f takes face f = 2 * axis + (sign > 0).
  const int warp = threadIdx.x >> 5;
  if (warp < 6)
    face_max_warp(patch, (size_t)p.qy * p.qx, p.qx, p.qz, p.qy, p.qx, p.r0,
                  p.r1, p.r2, warp, &face_score[warp], face_off[warp]);
  __syncthreads();

  if (threadIdx.x == 0) {
    const int sz = start[3 * lane], sy = start[3 * lane + 1],
              sx = start[3 * lane + 2];
    done[(size_t)lane * g.G0 * g.G1 * g.G2 +
         grid_index(g, pz, py, pxx, sz, sy, sx)] = 1;
    minp[3 * lane] = min(minp[3 * lane], pz);
    minp[3 * lane + 1] = min(minp[3 * lane + 1], py);
    minp[3 * lane + 2] = min(minp[3 * lane + 2], pxx);
    maxp[3 * lane] = max(maxp[3 * lane], pz);
    maxp[3 * lane + 1] = max(maxp[3 * lane + 1], py);
    maxp[3 * lane + 2] = max(maxp[3 * lane + 2], pxx);
    iters[lane] += 1;
    fresh[lane] = 0;

    // Stable insertion sort of the six moves, then the push loop.
    int idx[6] = {0, 1, 2, 3, 4, 5};
    for (int i = 1; i < 6; ++i) {
      const int x = idx[i];
      int j = i - 1;
      while (j >= 0 && sorts_before(face_score[x], face_off[x],
                                    face_score[idx[j]], face_off[idx[j]])) {
        idx[j + 1] = idx[j];
        --j;
      }
      idx[j + 1] = x;
    }
    const int h = head[lane];
    int t = tail[lane], ov = overflow[lane];
    for (int k = 0; k < 6; ++k) {
      const int f = idx[k];
      const float sc = face_score[f];
      bool keep = sc >= p.move_t;
      if (k > 0) {
        const int e = idx[k - 1];
        if (sc == face_score[e] && face_off[f][0] == face_off[e][0] &&
            face_off[f][1] == face_off[e][1] &&
            face_off[f][2] == face_off[e][2])
          keep = false;  // adjacent duplicate
      }
      if (!keep) continue;
      if (t - h >= p.Q) {
        ++ov;
        continue;
      }
      const size_t slot = (size_t)lane * p.Q + (t % p.Q);
      qpos[3 * slot] = pz + face_off[f][0];
      qpos[3 * slot + 1] = py + face_off[f][1];
      qpos[3 * slot + 2] = pxx + face_off[f][2];
      qscore[slot] = sc;
      ++t;
    }
    tail[lane] = t;
    overflow[lane] = ov;
  }
}

__global__ void __launch_bounds__(kUpdateThreads)
hop_screen_kernel(const float* __restrict__ logits, uint8_t* strong,
                  UpdateParams p, float init) {
  __shared__ int warp_counts[kUpdateThreads / 32];
  const int s = blockIdx.x;
  const float* lg = logits + (size_t)s * p.fz * p.fy * p.fx;
  const bool apply = disco_applies(lg, p.fz, p.fy, p.fx, p.qz, p.qy, p.qx,
                                   p.move_t, p.disco_t, warp_counts);
  if (threadIdx.x == 0) {
    const int dz = (p.fz - p.qz) / 2, dy = (p.fy - p.qy) / 2,
              dx = (p.fx - p.qx) / 2;
    const int cz = p.qz / 2, cy = p.qy / 2, cx = p.qx / 2;
    const float v =
        lg[((size_t)(cz + dz) * p.fy + cy + dy) * p.fx + cx + dx];
    // The fresh seed patch is NaN but for init at the seed center.
    const bool at_center =
        cz + dz == p.fz / 2 && cy + dy == p.fy / 2 && cx + dx == p.fx / 2;
    const float old = at_center ? init : f32_nan();
    const float out = (apply && old < 0.f && v > old) ? old : v;
    strong[s] = out >= p.move_t;
  }
}

Geom make_geom(int Z, int Y, int X, int G0, int G1, int G2, int d0, int d1,
               int d2, int o0, int o1, int o2) {
  return Geom{Z, Y, X, G0, G1, G2, d0 > 1 ? d0 : 1, d1 > 1 ? d1 : 1,
              d2 > 1 ? d2 : 1, o0, o1, o2};
}

template <typename T>
int launch_pop(const void* blocked, const void* seg, const void* shapes,
               const void* seeds, const void* sv, const void* qpos,
               void* head, const void* tail, const void* done,
               const void* start, const void* iters, void* status,
               const void* fresh, void* skip_t, void* skip_i, void* skip_r,
               void* executed, void* pops, void* pos, void* execute,
               void* order, void* summary, const PopParams& p,
               void* stream) {
  const int threads = (p.B + 31) / 32 * 32;
  hop_pop_kernel<T><<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocked), static_cast<const int*>(seg),
      static_cast<const int*>(shapes), static_cast<const T*>(seeds),
      static_cast<const int*>(sv), static_cast<const int*>(qpos),
      static_cast<int*>(head),
      static_cast<const int*>(tail), static_cast<const uint8_t*>(done),
      static_cast<const int*>(start), static_cast<const int*>(iters),
      static_cast<int*>(status), static_cast<const uint8_t*>(fresh),
      static_cast<int*>(skip_t), static_cast<int*>(skip_i),
      static_cast<int*>(skip_r), static_cast<int*>(executed),
      static_cast<int*>(pops), static_cast<int*>(pos),
      static_cast<uint8_t*>(execute), static_cast<int*>(order),
      static_cast<int*>(summary), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gather(const void* image, const void* seeds, const void* sv,
                  const void* pos, const void* lanes, void* img_out,
                  void* seed_out, const GatherParams& p, void* stream) {
  const int n_img = p.iz * p.iy * p.ix, n_seed = p.sz * p.sy * p.sx;
  const int n = n_img > n_seed ? n_img : n_seed;
  const int threads = 256;
  const dim3 grid((n + threads - 1) / threads, p.S);
  hop_gather_kernel<T>
      <<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(image), static_cast<const T*>(seeds),
          static_cast<const int*>(sv), static_cast<const int*>(pos),
          static_cast<const int*>(lanes), static_cast<float*>(img_out),
          static_cast<float*>(seed_out), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_update(const void* logits, void* seeds, const void* pos,
                  const void* execute, const void* lanes, const void* start,
                  void* done, void* minp, void* maxp, void* iters,
                  void* fresh, void* qpos, void* qscore, const void* head,
                  void* tail, void* overflow, void* patch, int n,
                  const UpdateParams& p, void* stream) {
  hop_update_kernel<T><<<n, kUpdateThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<T*>(seeds),
      static_cast<const int*>(pos), static_cast<const uint8_t*>(execute),
      static_cast<const int*>(lanes), static_cast<const int*>(start),
      static_cast<uint8_t*>(done), static_cast<int*>(minp),
      static_cast<int*>(maxp), static_cast<int*>(iters),
      static_cast<uint8_t*>(fresh), static_cast<int*>(qpos),
      static_cast<float*>(qscore), static_cast<const int*>(head),
      static_cast<int*>(tail), static_cast<int*>(overflow),
      static_cast<float*>(patch), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// seg (K,Z,Y,X) int32 is null in host-finalize mode; seeds (B,Z,Y,X) are
// bfloat16 where bf16 != 0, else float32.
extern "C" int ffn_hop_pop(const void* blocked, const void* seg,
                           const void* shapes,
                           const void* seeds, const void* sv,
                           const void* qpos, void* head, const void* tail,
                           const void* done, const void* start,
                           const void* iters, void* status, const void* fresh,
                           void* skip_t, void* skip_i, void* skip_r,
                           void* executed, void* pops, void* pos,
                           void* execute, void* order, void* summary, int B,
                           int Q, int Z, int Y, int X, int G0, int G1, int G2,
                           int m0, int m1, int m2, int d0, int d1, int d2,
                           int o0, int o1, int o2, int max_iters,
                           float move_t, int bf16, void* stream) {
  if (B < 1 || B > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const PopParams p{make_geom(Z, Y, X, G0, G1, G2, d0, d1, d2, o0, o1, o2),
                    B, Q, m0, m1, m2, max_iters, move_t};
  return (bf16 ? launch_pop<__nv_bfloat16> : launch_pop<float>)(
      blocked, seg, shapes, seeds, sv, qpos, head, tail, done, start, iters,
      status, fresh, skip_t, skip_i, skip_r, executed, pops, pos, execute,
      order, summary, p, stream);
}

// image (K,Z,Y,X); seeds (B,Z,Y,X), bfloat16 where bf16 != 0, or null
// (screening); lanes (S,) or null (slot s takes row s of pos and sv).
extern "C" int ffn_hop_gather(const void* image, const void* seeds,
                              const void* sv, const void* pos,
                              const void* lanes, void* img_out,
                              void* seed_out, int S, int K, int Z, int Y,
                              int X, int iz, int iy, int ix, int sz, int sy,
                              int sx, float pad, float init, int bf16,
                              void* stream) {
  const GatherParams p{S, K, Z, Y, X, iz, iy, ix, sz, sy, sx, pad, init};
  return (bf16 ? launch_gather<__nv_bfloat16> : launch_gather<float>)(
      image, seeds, sv, pos, lanes, img_out, seed_out, p, stream);
}

// logits (n, fz,fy,fx): slot s's model output, for lane lanes[s]; seeds
// bfloat16 where bf16 != 0.
extern "C" int ffn_hop_update(
    const void* logits, void* seeds, const void* pos, const void* execute,
    const void* lanes, const void* start, void* done, void* minp, void* maxp,
    void* iters, void* fresh, void* qpos, void* qscore, const void* head,
    void* tail, void* overflow, void* patch, int n, int Q, int Z, int Y,
    int X, int fz, int fy, int fx, int qz, int qy, int qx, int G0, int G1,
    int G2, int r0, int r1, int r2, int o0, int o1, int o2, float move_t,
    float disco_t, int bf16, void* stream) {
  const UpdateParams p{
      make_geom(Z, Y, X, G0, G1, G2, r0, r1, r2, o0, o1, o2),
      Q, fz, fy, fx, qz, qy, qx, r0, r1, r2, move_t, disco_t};
  return (bf16 ? launch_update<__nv_bfloat16> : launch_update<float>)(
      logits, seeds, pos, execute, lanes, start, done, minp, maxp, iters,
      fresh, qpos, qscore, head, tail, overflow, patch, n, p, stream);
}

extern "C" int ffn_hop_screen(const void* logits, void* strong, int n, int fz,
                              int fy, int fx, int qz, int qy, int qx,
                              float move_t, float disco_t, float init,
                              void* stream) {
  UpdateParams p{Geom{}, 0, fz, fy, fx, qz, qy, qx, 0, 0, 0, move_t, disco_t};
  hop_screen_kernel<<<n, kUpdateThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<uint8_t*>(strong), p,
      init);
  return static_cast<int>(cudaGetLastError());
}
