#!/usr/bin/env python3
"""Measures K18's design options on the card: the tensor-core body of the
3^3 layers (`conv3d_wgrad_16`) through its wrapper and, called directly,
with other stage-1 geometries (chunk rows (z, y), CTAs), and cuDNN's
`conv3d_weight`, in bfloat16 and float16, at the 16-bit trainers' shapes
(B=4, 33^3: 32->32 with pre_relu and the mask, conv0_a's 2->32 with a
float32 x). Each option is first held to its plain version (one ulp of the
type plus 2^-16 of the sum of |x||g|, a repeat bit for bit); times are
medians of CUDA events, taken in turns. Each result is one JSON line on
stdout and in --out.

  python tools_torch/k18_variants.py [--ptxas] [--split] [--out FILE]

--ptxas also prints nvcc's register and spill report for the kernels of
csrc/conv3d_bwd16.cu. --split times stage 1 of the default geometry
(device time, torch.profiler) built from csrc/conv3d_bwd16.cu as it is
and with parts cut out: the MMA loop, the staging copies, both (the
results are then wrong; only their times count).
"""

import argparse
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ffn_tpu_torch import _build  # noqa: E402
from ffn_tpu_torch.ops import conv3d  # noqa: E402
from ffn_tpu_torch.ops.conv3d_bf16_check import bf16_ulp  # noqa: E402
from tools_torch import variant_libs  # noqa: E402

SRC = os.path.join(variant_libs.CSRC, "conv3d_bwd16.cu")

# Stage 1's geometry: (chunk rows (z, y), CTAs); the first is the
# wrapper's (conv3d.WGRAD16_CHUNK, WGRAD16_CTAS).
OPTIONS = [((3, 3), 132), ((4, 4), 132), ((2, 3), 132), ((3, 3), 66)]
CASES = {"32->32 pre_relu, mask": (32, True, True),
         "2->32 float32 x, mask": (2, False, True)}


# Stage 1's parts, cut out of the source by replacing an anchor line.
ROWS = "      for (int r = warp; r < hz * hy + czc * cyc; r += nwarp) {"
MMA = "    if (tap_warp) {\n"
SPLIT = {"as is": [],
         "no MMA loop": [(MMA, "    if (false) {\n")],
         "no staging copies": [(ROWS, ROWS.replace("r < hz", "r < 0 * hz"))],
         "neither": [(MMA, "    if (false) {\n"),
                     (ROWS, ROWS.replace("r < hz", "r < 0 * hz"))]}


def split(emit, dev, gen):
    """Stage 1's device time with each part cut, 32->32 (pre_relu, mask)
    and 2->32 (float32 x, mask), bfloat16, B=4."""
    n, fov = cs.TRAIN_B, (33, 33, 33)
    with tempfile.TemporaryDirectory() as tmp:
        libs = variant_libs.build(tmp, SRC, {
            name: ([], cuts) for name, cuts in SPLIT.items()},
            ["ffn_conv3d_wgrad16_tc"])
        for cin, xdt in ((32, torch.bfloat16), (2, torch.float32)):
            x = torch.randn(n, *fov, cin, generator=gen, device=dev).to(xdt)
            dy, ym = (torch.randn(n, *fov, 32, generator=gen, device=dev)
                      .to(torch.bfloat16) for _ in "dm")
            geo = conv3d.wgrad16_chunks(n, *fov, cin, 32)
            out = torch.empty((geo.ctas, 27 * cin * 32 + 32), device=dev)
            dw, db = torch.empty(27 * cin * 32, device=dev), \
                torch.empty(32, device=dev)
            for name, lib in libs.items():
                def run(lib=lib):
                    _build.check(lib.ffn_conv3d_wgrad16_tc(
                        x.data_ptr(), int(xdt == torch.float32),
                        dy.data_ptr(), ym.data_ptr(), out.data_ptr(),
                        dw.data_ptr(), db.data_ptr(), n, *fov, cin, 32,
                        int(cin == 32), geo.cz, geo.cy, geo.ctas, 0,
                        torch.cuda.current_stream().cuda_stream),
                        name)
                emit(dict(dtype="torch.bfloat16", case=f"{cin}->32 split",
                          option=name, **variant_libs.device_split(run)))


def tc_body(x, dy, y, pre_relu, chunk, ctas):
    """The tensor-core K18 on a 3^3 layer with chunks of `chunk` rows (z,
    y) and `ctas` stage-1 CTAs, called past the wrapper."""
    n, d, h, w, cin = x.shape
    cout = dy.shape[-1]
    cz, cy = min(chunk[0], d), min(chunk[1], h)
    ctas = min(ctas, n * -(-d // cz) * -(-h // cy))
    partial = torch.empty((ctas, 27 * cin * cout + cout), device=x.device)
    dw = torch.empty((3, 3, 3, cin, cout), device=x.device)
    db = torch.empty((cout,), device=x.device)
    err = _build.lib().ffn_conv3d_wgrad16_tc(
        x.data_ptr(), int(x.dtype == torch.float32), dy.data_ptr(),
        y.data_ptr() if y is not None else None, partial.data_ptr(),
        dw.data_ptr(), db.data_ptr(), n, d, h, w, cin, cout, int(pre_relu),
        cz, cy, ctas, int(dy.dtype == torch.float16),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"K18 chunk {chunk} ctas {ctas}")
    return dw, db


def worst_of(got, want, mag, dt):
    return max(float(((g - p).abs() / (bf16_ulp(p, dt) + m * 2.0 ** -16))
                     .max()) for g, p, m in zip(got, want, mag))


def measure(emit, with_split):
    """Each option held to plain, then timed beside cuDNN's
    conv3d_weight; with_split, stage 1's parts first (split)."""
    _build.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    if with_split:
        split(emit, dev, gen)
    n, fov = cs.TRAIN_B, (33, 33, 33)
    for dt in (torch.bfloat16, torch.float16):
        a = torch.randn(n, *fov, 32, generator=gen, device=dev).to(dt)
        dy = (torch.randn(n, *fov, 32, generator=gen, device=dev)
              * 0.01).to(dt)
        for case, (cin, relu, mask) in CASES.items():
            x = torch.randn(n, *fov, cin, generator=gen, device=dev)
            x = x.to(dt) if cin == 32 else x
            y = a if mask else None
            want = conv3d.conv3d_wgrad_16_plain(x, dy, 3, pre_relu=relu,
                                                y=y)
            mag = conv3d.conv3d_wgrad_plain(
                x.to(dt).float().abs(), dy.float().abs(), 3,
                y=y.float() if y is not None else None)
            fns = [lambda: conv3d.conv3d_wgrad_16(x, dy, 3, pre_relu=relu,
                                                  y=y)]
            names = ["the wrapper"]
            fns += [lambda o=o: tc_body(x, dy, y, relu, *o) for o in OPTIONS]
            names += [f"tc chunk={c[0]}x{c[1]} ctas={k}" for c, k in OPTIONS]
            for name, run in zip(names, fns):
                got = run()
                worst = worst_of(got, want, mag, dt)
                same = all(torch.equal(g, h) for g, h in zip(got, run()))
                emit(dict(dtype=str(dt), case=case, option=name,
                          worst=worst, repeat_equal=same))
                cs.require(worst <= 1.0 and same, f"{name} against plain")
            xc = x.to(dt).permute(0, 4, 1, 2, 3).contiguous()
            gc = dy.permute(0, 4, 1, 2, 3).contiguous()
            fns.append(lambda: torch.nn.grad.conv3d_weight(
                xc, (32, cin, 3, 3, 3), gc, padding=1))
            names.append("cuDNN conv3d_weight")
            times = cs.time_many(*fns, reps=10)
            for name, ms in zip(names, times):
                emit(dict(dtype=str(dt), case=case, option=name, ms=ms))
            for name, fn in zip(names, fns):
                emit(dict(dtype=str(dt), case=case, option=name,
                          **variant_libs.device_split(fn)))
            del x, xc, gc
        del a, dy
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    with variant_libs.emitter(args.out) as emit:
        if args.ptxas:
            print("\n".join(variant_libs.ptxas_report([SRC], "wgrad")))
        measure(emit, args.split)


if __name__ == "__main__":
    main()
