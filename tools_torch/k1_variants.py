#!/usr/bin/env python3
"""Measures K1 (`conv3d_ndhwc_f32`, csrc/conv3d.cu on the tiles of
csrc/conv32.cuh) on the card: the four layer kinds of the depth-12 stack
(2->32 post_relu, 32->32 pre+post_relu, 32->32 +residual, the 1^3 32->1
conv_lom) at N = 1, 4 and 64 on 33^3 samples, against cuDNN's `conv3d`
(TF32 off) on the same inputs.

K1 is first held to its plain version (within 1e-4 of max|plain|, a repeat
bit for bit, sample N // 2 alone bit for bit as in the batch); then
torch.profiler gives each call's device time (the sum of its kernels) and
CUDA events the time per call through the wrapper, medians of samples taken
in turns. --split also times libraries built from the source with a part
cut out (their results are wrong, only their times count; variant_libs.py
builds them, one nvcc each, in parallel): no FMA loop, no staging copies;
and K1 without its halo table (each copy finds its voxel, as K9's do).
--tf32x3 times the 3xTF32 variant: the same tiles, each chunk's products
as
mma.sync m16n8k8 on TF32 halves (a = a_hi + a_lo for both operands; a_hi
b_hi + a_hi b_lo + a_lo b_hi, float32 sums, one fixed order: 8-channel
groups, then taps), on the 3^3 layers whose input channels come in 8s; it
is held to the same checks and its largest error printed. Each result is
one JSON line on stdout and in --out, with the card's name and power limit.

  python tools_torch/k1_variants.py [--split] [--tf32x3] [--ptxas]
                                    [--ns 1,4,64] [--out FILE]

~1 min on an H100 with both options (~15 s of it the builds).
"""

import argparse
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ffn_tpu_torch import _build  # noqa: E402
from ffn_tpu_torch.ops import conv3d  # noqa: E402
from tools_torch import variant_libs  # noqa: E402

SRC = os.path.join(variant_libs.CSRC, "conv3d.cu")
ENTRY = "ffn_conv3d_ndhwc_f32"

# Parts cut out of the tiles (conv32.cuh), for --split; and K1 without
# its halo table (each copy finds its voxel, as K9's do).
SPLIT = {
    "no halo table": [("constexpr bool kHaloTable = true;",
                       "constexpr bool kHaloTable = false;")],
    "no FMA loop": [("conv32.cuh", "c < cn; ++c) {\n    const float* gc",
                     "c < 0 * cn; ++c) {\n    const float* gc")],
    "no staging copies": [("conv32.cuh",
                           "  const TilePos t = tile_pos(it.tile, a);\n"
                           "  const int c0 = it.k * a.cc;",
                           "  return;\n  const TilePos t = tile_pos("
                           "it.tile, a);\n  const int c0 = it.k * a.cc;")]}

# The 3xTF32 variant, as cuts of conv32.cuh. Warp w of a
# tile's 3 cig warps owns 128 / cig positions (8 / cig m16 tiles) x all
# 4 cig output channels (cig / 2 n8 tiles): the thread's 16 sums, as the
# FMA loop's. A chunk of 8c input channels runs as c groups of 8, each over
# the 27 taps: per tap and m16 tile, A's four values and B's two a n8 tile
# load from the stage and the weight rows and split into TF32 halves, then
# three MMAs, the small terms first. The last chunk's sums go through the
# stage to the FMA layout, so the epilogue is K1's. K1's plans give the
# 32-channel layers chunks of 8 or more at every N.
TF32X3_CODE = r'''
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float r = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int CIG>
__device__ __forceinline__ void tile_mma3(const float* st, const float* sw,
                                          int cn, int plane, int w_row,
                                          const int (&zy_off)[9],
                                          float (&acc)[kRun][kCiT]) {
  constexpr int CIP = kCiT * CIG, MT = 8 / CIG, NT = CIG / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* d = &acc[0][0];  // [MT][NT][4]
  const int m0 = warp * 16 * MT;
#pragma unroll 1
  for (int c8 = 0; c8 < cn; c8 += 8) {
    const float* ab = st + (c8 + t) * plane + m0 + g;
    const float* bb = sw + (c8 + t) * w_row + g;
#pragma unroll 1
    for (int zy = 0; zy < 9; ++zy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int tap = zy * 3 + dx, off = zy_off[zy] + dx;
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          split_tf32(bb[tap * CIP + nt * 8], bh[nt][0], bl[nt][0]);
          split_tf32(bb[4 * w_row + tap * CIP + nt * 8], bh[nt][1],
                     bl[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* ap = ab + off + mt * 16;
          uint32_t ah[4], al[4];
          split_tf32(ap[0], ah[0], al[0]);
          split_tf32(ap[8], ah[1], al[1]);
          split_tf32(ap[4 * plane], ah[2], al[2]);
          split_tf32(ap[4 * plane + 8], ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            float* dd = d + (mt * NT + nt) * 4;
            mma_tf32(dd, al, bh[nt]);
            mma_tf32(dd, ah, bl[nt]);
            mma_tf32(dd, ah, bh[nt]);
          }
        }
      }
    }
  }
}

// The MMA layout's sums into the FMA layout's, through the free stage.
template <int CIG>
__device__ __forceinline__ void mma_to_fma(float* st,
                                           float (&acc)[kRun][kCiT]) {
  constexpr int CIP = kCiT * CIG, MT = 8 / CIG, NT = CIG / 2, RS = CIP + 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = warp * 16 * MT;
  const float* d = &acc[0][0];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* dd = d + (mt * NT + nt) * 4;
      const int row = m0 + mt * 16 + g, col = nt * 8 + 2 * t;
      st[row * RS + col] = dd[0];
      st[row * RS + col + 1] = dd[1];
      st[(row + 8) * RS + col] = dd[2];
      st[(row + 8) * RS + col + 1] = dd[3];
    }
  __syncthreads();
  const int run = threadIdx.x / CIG, cig = threadIdx.x % CIG;
#pragma unroll
  for (int p = 0; p < kRun; ++p)
#pragma unroll
    for (int j = 0; j < kCiT; ++j)
      acc[p][j] = st[(run * kRun + p) * RS + cig * kCiT + j];
  __syncthreads();
}

'''
TF32X3 = [
    ("conv32.cuh", "// The persistent tile walk. Op supplies:",
     TF32X3_CODE + "// The persistent tile walk. Op supplies:"),
    ("conv32.cuh",
     "    tile_fma<Op::kDzInner>(st + run * kRun,\n"
     "                           s_w + (c0 - gbi * a.gb) * a.w_row + cig * kCiT,\n"
     "                           cn, plane, a.w_row, CIP, zy_off, acc);\n"
     "    __syncthreads();  // the stage is free\n",
     "    bool mma = false;\n"
     "    if constexpr (CIG >= 2)\n"
     "      mma = a.Cx % 8 == 0 && a.cc % 8 == 0 &&\n"
     "            a.stage >= kTilePos * (CIP + 4);\n"
     "    if (mma) {\n"
     "      if constexpr (CIG >= 2)\n"
     "        tile_mma3<CIG>(st, s_w + (c0 - gbi * a.gb) * a.w_row, cn,\n"
     "                       plane, a.w_row, zy_off, acc);\n"
     "    } else {\n"
     "      tile_fma<Op::kDzInner>(\n"
     "          st + run * kRun, s_w + (c0 - gbi * a.gb) * a.w_row + cig * kCiT,\n"
     "          cn, plane, a.w_row, CIP, zy_off, acc);\n"
     "    }\n"
     "    __syncthreads();  // the stage is free\n"
     "    if constexpr (CIG >= 2)\n"
     "      if (mma && it.k == a.nk - 1) mma_to_fma<CIG>(st, acc);\n")]

# (Cin, Cout, pre_relu, post_relu, residual, k) of the stack's layer kinds.
LAYERS = {name: (cin, cout, pre, post, res, k)
          for name, (k, cin, cout, pre, post, res) in cs.K1_LAYERS.items()}


def layer_inputs(gen, dev, n, cin, cout, res, k):
    fov = (33, 33, 33)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale
    x = randn(n, *fov, cin)
    w = randn(k, k, k, cin, cout, scale=(2.0 / (k ** 3 * cin)) ** 0.5)
    b = randn(cout, scale=0.1)
    r = randn(n, *fov, cout) if res else None
    return x, w, b, r


def caller(fn, x, w, b, r, pre, post):
    """A call of the C entry `fn` on the layer; returns y."""
    n, d, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    y = torch.empty((n, d, h, wd, cout), device=x.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                 r.data_ptr() if r is not None else None, y.data_ptr(), n,
                 d, h, wd, cin, cout, k, int(pre), int(post), stream)
        _build.check(err, "K1")
        return y
    return run


def checks(fn, x, w, b, r, pre, post, want):
    """(largest error in units of 1e-4 max|plain|, repeat bit for bit,
    sample N // 2 alone bit for bit as in the batch) of the C entry fn."""
    got = caller(fn, x, w, b, r, pre, post)().clone()
    again = caller(fn, x, w, b, r, pre, post)()
    i = x.shape[0] // 2
    one = caller(fn, x[i:i + 1].clone(), w, b,
                 None if r is None else r[i:i + 1].clone(), pre, post)()
    worst = float((got - want).abs().max()) / (1e-4 * float(
        want.abs().max()))
    return worst, torch.equal(got, again), torch.equal(one[0], got[i])


def measure(emit, dev, gen, ns, libs):
    for n in ns:
        for layer, (cin, cout, pre, post, res, k) in LAYERS.items():
            x, w, b, r = layer_inputs(gen, dev, n, cin, cout, res, k)
            kw = dict(pre_relu=pre, post_relu=post, residual=r)
            want = conv3d.conv3d_ndhwc_plain(x, w, b, **kw)
            base = dict(kernel="K1", layer=layer, n=n)
            if k == 3:
                geo = conv3d.k1_geometry(n, 33, 33, 33, cin, cout)
                base.update(cig=geo.cig, tiles=geo.tiles, chunk=geo.chunk)
            runs = {}
            for name, lib in libs.items():
                fn = getattr(lib, ENTRY)
                if name in ("K1", "3xTF32") and (k == 3 or name == "K1"):
                    worst, again, alone = checks(fn, x, w, b, r, pre, post,
                                                 want)
                    emit(dict(base, option=name, worst=worst,
                              repeat_equal=again, alone_equal=alone))
                    if name == "K1":
                        cs.require(worst <= 1.0 and again and alone,
                                   f"K1 {layer} N={n} against plain")
                if k == 3 or name == "K1":
                    runs[name] = caller(fn, x, w, b, r, pre, post)
            xc = x.permute(0, 4, 1, 2, 3).contiguous()
            wc = w.permute(4, 3, 0, 1, 2).contiguous()
            runs["cuDNN conv3d"] = lambda: torch.nn.functional.conv3d(
                xc, wc, b, padding=k // 2)
            for name, fn in runs.items():
                t = variant_libs.device_split(fn)
                emit(dict(base, option=name, host_us=t["host_us"],
                          device_us=sum(t["device_us"].values()),
                          device_by_kernel=t["device_us"]))
            ms = cs.time_many(
                lambda: conv3d.conv3d_ndhwc_f32(x, w, b, **kw),
                runs["cuDNN conv3d"], reps=10)
            flops = 2 * n * 33 ** 3 * k ** 3 * cin * cout
            emit(dict(base, option="per call: the wrapper, cuDNN",
                      ms=list(ms), bound_ms=cs.bound_of(
                          *cs.k1_work(n, k, cin, cout))[0],
                      wrapper_share_of_peak=1e3 * flops / cs.F32_FLOPS
                      / ms[0]))
            del x, w, b, r, want, xc, wc, runs
            torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--tf32x3", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--ns", default="1,4,64")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    t0 = time.perf_counter()
    variants = {"K1": ([], [])}
    if args.split:
        variants.update({name: ([], cut) for name, cut in SPLIT.items()})
    if args.tf32x3:
        variants["3xTF32"] = ([], TF32X3)
    with variant_libs.emitter(args.out) as emit, \
            tempfile.TemporaryDirectory() as tmp:
        if args.ptxas:
            print("\n".join(variant_libs.ptxas_report([SRC], "conv")))
        libs = variant_libs.build(tmp, SRC, variants, [ENTRY])
        emit(dict(kernel="K1", built=sorted(libs),
                  seconds=time.perf_counter() - t0))
        measure(emit, dev, gen, [int(v) for v in args.ns.split(",")], libs)
        emit(dict(kernel="K1", seconds=time.perf_counter() - t0))


if __name__ == "__main__":
    main()
