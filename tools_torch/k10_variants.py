#!/usr/bin/env python3
"""Measures K10 (`conv3d_wgrad_f32`, csrc/conv3d_bwd.cu; its 3^3 layers on
the chunk tiles of csrc/wgrad32.cuh) on the card: the layer kinds of the
depth-12 stack's training step (2->32 post_relu, 32->32 pre+post_relu,
32->32 +residual, the 1^3 32->1 conv_lom, and the CI checkpoint's 16->16
block_a) at B = 1 (the host-loop trainer) and 4 (the scan trainer) on 33^3,
against cuDNN's `conv3d_weight` (TF32 off) on the same inputs.

K10 is first held to its plain version (dW and db within 1e-4 of
max|plain|, a repeat bit for bit); then torch.profiler gives each call's
device time (the sum of its kernels: stage 1 and the row sum) and CUDA
events the time per call through the wrapper, medians of samples taken in
turns. Libraries built from the source (variant_libs.py, one nvcc each, in
parallel) with a part cut out, or in another design, are timed beside it,
each its C entry called on the same inputs:
  --split: no FMA loop, no staging copies, no fix of the landed copies
    (pre_relu and the mask);
  --options: the row body (wgrad.cuh: a CTA a tap and 32 rows, x and dy
    read from L2 by every tap) on every layer; 3xTF32: the 32->32 layers' products
    as mma.sync m16n8k8 on TF32 halves (a = a_hi + a_lo for both operands;
    a_hi b_hi + a_hi b_lo + a_lo b_hi, float32 sums), a warp a tap, 8
    positions a k-step; 8x8 tiles: a thread one tap x 8 input x 8 output
    channels, 432 threads. Each is held to the same checks, its largest
    error printed.
Their results are wrong where a part is cut. Each result is one JSON line
on stdout and in --out, with the card's name and power limit.

  python tools_torch/k10_variants.py [--split] [--options] [--ptxas]
                                     [--bs 1,4] [--out FILE]

~1 min on an H100 with both options (~20 s of it the builds).
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

SRC = os.path.join(variant_libs.CSRC, "conv3d_bwd.cu")
ENTRY = "ffn_conv3d_wgrad_f32"
LOOP = "#pragma unroll 2\n    for (int v = grp; v < nv; v += G::G) {"
FMA = ("        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], gv[j], "
       "acc[i][j]);\n")

SPLIT = {
    "no FMA loop": [("wgrad32.cuh", LOOP,
                     LOOP.replace("v < nv", "v < 0 * nv"))],
    "no staging copies": [
        ("wgrad32.cuh", "      cp_async<XB>(st_s + 4 * at, x + src, valid);",
         "      if (at < 0) cp_async<XB>(st_s + 4 * at, x + src, valid);"),
        ("wgrad32.cuh", "      cp_async<16>(st_s + 4 * at, dy + src, valid);",
         "      if (at < 0) cp_async<16>(st_s + 4 * at, dy + src, valid);"),
        ("wgrad32.cuh", "      if (masked)\n        cp_async<16>(",
         "      if (masked && at < 0)\n        cp_async<16>(")],
    "no fix of the copies": [
        ("wgrad32.cuh", "        if (valid && a.pre_relu)",
         "        if (valid && a.pre_relu && at < 0)"),
        ("wgrad32.cuh", "        if (valid && masked)",
         "        if (valid && masked && at < 0)")],
}

ROWS = [("  const bool tiles = k == 3 &&",
         "  const bool tiles = false && k == 3 &&")]

# 8 x 8 tiles: a thread one tap x 8 input x 8 output channels (64 sums,
# two float4s of x and two of g a position), 432 threads (two taps a warp).
X4 = ("      if constexpr (CB == 4) {\n"
      "        const float4 f = *reinterpret_cast<const float4*>(xs + v * "
      "CIN);\n"
      "        xv[0] = f.x; xv[1] = f.y; xv[2] = f.z; xv[3] = f.w;\n")
TILE8 = [
    ("wgrad32.cuh", "constexpr int kW10Threads = 864;",
     "constexpr int kW10Threads = 432;"),
    ("wgrad32.cuh", "  static constexpr int CB = CIN == 2 ? 2 : 4;",
     "  static constexpr int CB = CIN == 2 ? 2 : 8;"),
    ("wgrad32.cuh", "  const int cb = cin == 2 ? 2 : 4;",
     "  const int cb = cin == 2 ? 2 : 8;"),
    ("wgrad32.cuh", X4,
     "      if constexpr (CB == 8) {\n"
     "        const float4 f = *reinterpret_cast<const float4*>(xs + v * "
     "CIN);\n"
     "        const float4 e = *reinterpret_cast<const float4*>(xs + v * "
     "CIN + 4);\n"
     "        xv[0] = f.x; xv[1] = f.y; xv[2] = f.z; xv[3] = f.w;\n"
     "        xv[4] = e.x; xv[5] = e.y; xv[6] = e.z; xv[7] = e.w;\n"
     "      } else " + X4.lstrip())]

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

// A warp's tap of a 32->32 chunk: A (ci x positions) from x's halo at the
// tap's offset, B (positions x co) from g, 8 positions a k-step.
__device__ __forceinline__ void tf32x3_tap(const float* st, int tap_off,
                                           int gofs, int nv,
                                           float (&d)[2][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* xs = st + tap_off * 32;
  const float* gs = st + gofs;
#pragma unroll 1
  for (int v0 = 0; v0 < nv; v0 += 8) {
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = v0 + t + 4 * h;
        split_tf32(v < nv ? gs[v * 32 + 8 * nt + g] : 0.f, bh[nt][h],
                   bl[nt][h]);
      }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* xp = xs + (v0 + t) * 32 + 16 * mt + g;
      uint32_t ah[4], al[4];
      split_tf32(xp[0], ah[0], al[0]);
      split_tf32(xp[8], ah[1], al[1]);
      split_tf32(xp[4 * 32], ah[2], al[2]);
      split_tf32(xp[4 * 32 + 8], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_tf32(d[mt][nt], al, bh[nt]);
        mma_tf32(d[mt][nt], ah, bl[nt]);
        mma_tf32(d[mt][nt], ah, bh[nt]);
      }
    }
  }
}

'''
KERNEL_HEAD = ("template <int CIN, int COUT>\n__global__ void "
               "__launch_bounds__(kW10Threads, 1)")
TF32X3 = [
    ("wgrad32.cuh", KERNEL_HEAD, TF32X3_CODE + KERNEL_HEAD),
    ("wgrad32.cuh", "  long long c = blockIdx.x;\n",
     "  float dacc[2][4][4] = {};\n  long long c = blockIdx.x;\n"),
    ("wgrad32.cuh", LOOP,
     "    if constexpr (CIN == 32 && COUT == 32) {\n"
     "      tf32x3_tap(st, tap_off, a.gofs, nv, dacc);\n"
     "    } else {\n" + LOOP),
    ("wgrad32.cuh", FMA + "    }\n", FMA + "    }\n    }\n"),
    ("wgrad32.cuh", "  if constexpr (G::G == 1) {\n",
     "  if constexpr (CIN == 32 && COUT == 32) {\n"
     "    const int lane = tid & 31, g = lane >> 2, t = lane & 3;\n"
     "    for (int mt = 0; mt < 2; ++mt)\n"
     "      for (int nt = 0; nt < 4; ++nt)\n"
     "        for (int j = 0; j < 4; ++j)\n"
     "          out[((size_t)tap * 32 + 16 * mt + g + 8 * (j >> 1)) * 32 +\n"
     "              8 * nt + 2 * t + (j & 1)] = dacc[mt][nt][j];\n"
     "  } else if constexpr (G::G == 1) {\n")]

LAYERS = dict(
    {name: v for name, v in cs.K1_LAYERS.items()},
    **{"16->16 pre+post_relu": (3, 16, 16, True, True, False)})


def caller(fn, x, dy, y, k, pre):
    n, d, h, w, cin = x.shape
    cout = dy.shape[-1]
    rows = max(-(-(n * d * h) // conv3d.WGRAD_ROWS), conv3d.K10_CTAS)
    partial = torch.empty((rows, k ** 3 * cin * cout + cout), device=x.device)
    dw = torch.empty((k, k, k, cin, cout), device=x.device)
    db = torch.empty((cout,), device=x.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(x.data_ptr(), dy.data_ptr(),
                 y.data_ptr() if y is not None else None, partial.data_ptr(),
                 dw.data_ptr(), db.data_ptr(), n, d, h, w, cin, cout, k,
                 int(pre), conv3d.WGRAD_ROWS, rows, stream)
        _build.check(err, "K10")
        return dw, db
    return run


def worst(got, want):
    """The larger error of dW and db in units of 1e-4 max|plain|."""
    return max(float((g - w).abs().max()) / (1e-4 * float(w.abs().max()))
               for g, w in zip(got, want))


def measure(emit, dev, bs, libs):
    gen = torch.Generator(device=dev).manual_seed(10)
    for b in bs:
        for name, (k, cin, cout, pre, post, _) in LAYERS.items():
            shape = (b, 33, 33, 33)
            x = torch.randn(*shape, cin, generator=gen, device=dev)
            dy = torch.randn(*shape, cout, generator=gen, device=dev)
            y = torch.randn(*shape, cout, generator=gen, device=dev) \
                if post else None
            want = conv3d.conv3d_wgrad_plain(x, dy, k, pre_relu=pre, y=y)
            base = dict(kernel="K10", layer=name, b=b)
            geo = conv3d.k10_geometry(b, 33, 33, 33, cin, cout, post) \
                if k == 3 else None
            if geo is not None:
                base.update(cy=geo.cy, chunks=geo.chunks, ctas=geo.ctas,
                            groups=geo.groups, smem=geo.smem)
            runs = {}
            for opt, lib in libs.items():
                if k != 3 and opt != "K10":
                    continue
                runs[opt] = caller(getattr(lib, ENTRY), x, dy, y, k, pre)
                if opt not in SPLIT:
                    got = tuple(t.clone() for t in runs[opt]())
                    again = runs[opt]()
                    rec = dict(base, option=opt, worst=worst(got, want),
                               repeat_equal=all(torch.equal(g, a) for g, a
                                                in zip(got, again)))
                    emit(rec)
                    if opt == "K10":
                        cs.require(rec["worst"] <= 1.0 and
                                   rec["repeat_equal"],
                                   f"K10 {name} B={b} against plain")
            xc = x.permute(0, 4, 1, 2, 3).contiguous()
            gc = dy.permute(0, 4, 1, 2, 3).contiguous()
            runs["cuDNN conv3d_weight"] = lambda: torch.nn.grad.conv3d_weight(
                xc, (cout, cin, k, k, k), gc, padding=k // 2)
            for opt, fn in runs.items():
                t = variant_libs.device_split(fn)
                emit(dict(base, option=opt, host_us=t["host_us"],
                          device_us=sum(t["device_us"].values()),
                          device_by_kernel=t["device_us"]))
            ms = cs.time_many(
                lambda: conv3d.conv3d_wgrad_f32(x, dy, k, pre_relu=pre, y=y),
                runs["cuDNN conv3d_weight"], reps=10)
            vox = b * 33 ** 3
            flops = 2 * vox * k ** 3 * cin * cout
            emit(dict(base, option="per call: the wrapper, cuDNN",
                      ms=list(ms), bound_ms=cs.bound_of(
                          4 * (vox * (cin + cout * (2 if post else 1))
                               + k ** 3 * cin * cout + cout), flops)[0],
                      wrapper_share_of_peak=1e3 * flops / cs.F32_FLOPS
                      / ms[0]))
            del x, dy, y, want, xc, gc, runs
            torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--options", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--bs", default="1,4")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    variants = {"K10": ([], [])}
    if args.split:
        variants.update({name: ([], cut) for name, cut in SPLIT.items()})
    if args.options:
        variants["row body"] = ([], ROWS)
        variants["3xTF32"] = ([], TF32X3)
        variants["8x8 tiles"] = ([], TILE8)
    with variant_libs.emitter(args.out) as emit, \
            tempfile.TemporaryDirectory() as tmp:
        if args.ptxas:
            print("\n".join(variant_libs.ptxas_report([SRC], "wgrad")))
        libs = variant_libs.build(tmp, SRC, variants, [ENTRY])
        emit(dict(kernel="K10", built=sorted(libs),
                  seconds=time.perf_counter() - t0))
        measure(emit, dev, [int(v) for v in args.bs.split(",")], libs)
        emit(dict(kernel="K10", seconds=time.perf_counter() - t0))


if __name__ == "__main__":
    main()
