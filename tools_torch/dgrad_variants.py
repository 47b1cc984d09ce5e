#!/usr/bin/env python3
"""Measures K9 and K17 on the card, whole and with parts cut out: the
input gradient of a 3^3 layer in float32 (K9, `conv3d_dgrad_f32`,
csrc/conv3d_bwd.cu) and in bfloat16 and float16 (K17, `conv3d_dgrad_16`,
csrc/conv3d_bwd16.cu), against cuDNN's `conv3d_input` (TF32 off; 16-bit) on the same inputs.

Each kernel is a library built from its source as it is and, with
--split, with a part cut out (K9's in the tiles it shares with K1,
csrc/conv32.cuh) (the results are then wrong, only their times
count; variant_libs.py builds them, one nvcc each, in parallel), its C
entry called directly. Layer kinds of the training step at the train
CLI's batch (4; the host-loop trainer's is 4 too), 33^3: conv0_b and
block_b (no masks, no cotangent: one call kind), block_a (both relu masks
and the residual's cotangent) and the CI checkpoint's 16->16 block_a. The
kernel is first held to its plain version (K9 within 1e-4 of max|plain|,
K17 within conv3d_bf16_check.k17_tolerance; a repeat bit for bit); then
torch.profiler gives each call's device time (the sum of its kernels), and
CUDA events the time per call through the wrapper, medians of samples
taken in turns. Each result is one JSON line on stdout and in --out.

  python tools_torch/dgrad_variants.py [--k9] [--k17] [--split] [--ptxas]
                                       [--out FILE]

(both kernels when neither is named.) --ptxas prints nvcc's register and
spill report of the input-gradient kernels.
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
from ffn_tpu_torch.ops.conv3d_bf16_check import k17_tolerance  # noqa: E402
from tools_torch import variant_libs  # noqa: E402

K9_SRC = os.path.join(variant_libs.CSRC, "conv3d_bwd.cu")
K17_SRC = os.path.join(variant_libs.CSRC, "conv3d_bwd16.cu")
# PERF.md holds the times of the design options measured before
# each kernel's design was chosen.

# Parts cut out of each source (anchor -> replacement), for --split.
K9_SPLIT = {
    "no FMA loop": [("conv32.cuh", "c < cn; ++c) {\n    const float* gc",
                     "c < 0 * cn; ++c) {\n    const float* gc")],
    "no staging copies": [("conv32.cuh",
                           "  const TilePos t = tile_pos(it.tile, a);\n"
                           "  const int c0 = it.k * a.cc;",
                           "  return;\n  const TilePos t = tile_pos("
                           "it.tile, a);\n  const int c0 = it.k * a.cc;")]}
K17_SPLIT = {
    "no MMAs": [("    tile_sums<T, CO, CI, false>(st, s_w, warp, lane, P, "
                 "R, 0, acc, unused);\n",
                 "    for (auto& r : acc) for (float& v : r) v = 0.f;\n")],
    "no staging copies": [
        (f"stage_tile<T, CO, CI>(st, dy, 0, tile_at({t}",
         f"if (false) stage_tile<T, CO, CI>(st, dy, 0, tile_at({t}")
        for t in ("tile, D", "tile + gridDim.x")]}
# (Cin, Cout, pre_relu x, post_relu y, the residual's cotangent)
LAYERS = {"conv0_b, block_b": (32, 32, False, False, False),
          "block_a": (32, 32, True, True, True),
          "ci 16->16 block_a": (16, 16, True, True, True)}
ENTRY = {"K9": "ffn_conv3d_dgrad_f32", "K17": "ffn_conv3d_dgrad_16"}


def layer_inputs(gen, dev, dt, n, cin, cout, pre, post, res):
    fov = (33, 33, 33)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dt)
    dy = randn(n, *fov, cout, scale=1.0 if dt == torch.float32 else 0.01)
    w = randn(3, 3, 3, cin, cout, scale=(2 / (27 * cin)) ** 0.5)
    x = randn(n, *fov, cin) if pre else None
    y = randn(n, *fov, cout) if post else None
    acc = randn(n, *fov, cin, scale=0.01) if res else None
    return dy, w, dict(x=x, y=y, accum=acc)


def caller(fn, kernel, dy, w, kw, dt):
    """A call of the C entry `fn` on the layer; returns dx."""
    n, d, h, wd, cout = dy.shape
    cin = w.shape[3]
    dx = torch.empty((n, d, h, wd, cin), device=dy.device, dtype=dt)

    def ptr(t):
        return t.data_ptr() if t is not None else None
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        if kernel == "K9":
            err = fn(ptr(dy), ptr(kw["y"]), ptr(kw["x"]), ptr(w),
                     ptr(kw["accum"]), ptr(dx), n, d, h, wd, cin, cout, 3,
                     stream)
        else:
            err = fn(ptr(dy), 0, ptr(kw["y"]), ptr(w), ptr(kw["x"]),
                     ptr(kw["accum"]), ptr(dx), n, d, h, wd, cin, cout, 3,
                     int(dt == torch.float16), stream)
        _build.check(err, kernel)
        return dx
    return run


def within(kernel, got, want, dy, w, kw):
    """The kernel's largest error in units of its check."""
    err = (got.float() - want.float()).abs()
    if kernel == "K9":
        return float(err.max()) / (1e-4 * float(want.abs().max()))
    return float((err / k17_tolerance(dy, w, want, **kw)).max())


def measure(emit, dev, gen, kernel, lib, split_libs):
    dts = [torch.float32] if kernel == "K9" else [torch.bfloat16,
                                                  torch.float16]
    wrapper = conv3d.conv3d_dgrad_f32 if kernel == "K9" \
        else conv3d.conv3d_dgrad_16
    plain = conv3d.conv3d_dgrad_plain if kernel == "K9" \
        else conv3d.conv3d_dgrad_16_plain
    for dt in dts:
        for layer, (cin, cout, pre, post, res) in LAYERS.items():
            n = cs.TRAIN_B
            dy, w, kw = layer_inputs(gen, dev, dt, n, cin, cout, pre, post,
                                     res)
            want = plain(dy, w, **kw)
            base = dict(kernel=kernel, dtype=str(dt), layer=layer, n=n)
            run = caller(getattr(lib, ENTRY[kernel]), kernel, dy, w, kw, dt)
            got = run().clone()
            worst = within(kernel, got, want, dy, w, kw)
            same = torch.equal(got, run())
            emit(dict(base, option=kernel, worst=worst, repeat_equal=same))
            cs.require(worst <= 1.0 and same,
                       f"{kernel} {layer} {dt} against plain")
            runs = {kernel: run}
            for name, cut in split_libs.items():
                runs[f"cut: {name}"] = caller(getattr(cut, ENTRY[kernel]),
                                              kernel, dy, w, kw, dt)
            gc = dy.permute(0, 4, 1, 2, 3).contiguous()
            wc = w.permute(4, 3, 0, 1, 2).contiguous()
            shape = (n, cin) + tuple(dy.shape[1:4])
            runs["cuDNN conv3d_input"] = lambda: torch.nn.grad.conv3d_input(
                shape, wc, gc, padding=1)
            for name, fn in runs.items():
                t = variant_libs.device_split(fn)
                emit(dict(base, option=name, host_us=t["host_us"],
                          device_us=sum(t["device_us"].values()),
                          device_by_kernel=t["device_us"]))
            ms = cs.time_many(lambda: wrapper(dy, w, **kw),
                              runs["cuDNN conv3d_input"], reps=10)
            emit(dict(base, option="per call: the wrapper, cuDNN",
                      ms=list(ms)))
            del dy, w, kw, want, gc, wc, runs
            torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k9", action="store_true")
    ap.add_argument("--k17", action="store_true")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    kernels = [k for k, on in (("K9", args.k9), ("K17", args.k17)) if on] \
        or ["K9", "K17"]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _build.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    t0 = time.perf_counter()
    with variant_libs.emitter(args.out) as emit, \
            tempfile.TemporaryDirectory() as tmp:
        if args.ptxas:
            print("\n".join(variant_libs.ptxas_report((K9_SRC, K17_SRC),
                                                      "dgrad")))
        for kernel in kernels:
            src, split = ((K9_SRC, K9_SPLIT) if kernel == "K9" else
                          (K17_SRC, K17_SPLIT))
            cuts = {n: ([], c) for n, c in split.items()} if args.split \
                else {}
            os.makedirs(os.path.join(tmp, kernel))
            split_libs = variant_libs.build(os.path.join(tmp, kernel), src,
                                            cuts, [ENTRY[kernel]])
            measure(emit, dev, gen, kernel, lib, split_libs)
            emit(dict(kernel=kernel, seconds=time.perf_counter() - t0))


if __name__ == "__main__":
    main()
