#!/usr/bin/env python3
"""K15's design options and error bound on the card.

--calibrate: K15's float32 sum against the exact one, in units of the sum
of |x| * |w| (the scale of the bound that decides which outputs K15
recomputes in float64), on random layers of each kind and on every 3^3
layer of the model-r2 stack over two FOVs of the seed-0 phantom, in K15's
order (FFN_K15_RAW_SUM) and accumulating in the tensor core (with
FFN_K15_IN_MMA): the largest ratio and, for several bounds 2^-B, the share
of outputs sent to the recompute and the outputs beyond the bound.

--time: device time of the 32->32 block_a layer (pre_relu, post_relu) at
N = 64, 4 and 1 in bfloat16 and float16, K15 as built, with a tighter
bound (fewer float64 sums; not exact) and with parts cut (no float64 sums:
flagged outputs stored from the float32 sum; no |x||w| MMA and no flags
either), K15 held to the float64 sums, beside cuDNN's bfloat16/float16
conv3d; back-to-back launches of
the C entry (no host gaps) timed by CUDA events, medians of samples taken
in turns; with the share of outputs flagged for the float64 sums, also per
3^3 layer kind at N = 64.

  python tools_torch/k15_variants.py [--calibrate] [--time] [--f16]
                                     [--out FILE]

(--calibrate alone in bfloat16, or float16 with --f16, when neither is
given.) Each result is one JSON line on stdout and in --out. The variants
are built from ffn_tpu_torch/csrc/conv3d_bf16.cu with their macros
defined, one nvcc each, in parallel.
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ffn_tpu_torch import _build  # noqa: E402
from ffn_tpu_torch.models import convstack_3d, params_io  # noqa: E402
from ffn_tpu_torch.ops import conv3d  # noqa: E402
from ffn_tpu_torch.ops import conv3d_bf16_check as check  # noqa: E402
from tools_torch import variant_libs  # noqa: E402

SOURCE = os.path.join(variant_libs.CSRC, "conv3d_bf16.cu")
VARIANTS = {"raw_sum": ["FFN_K15_RAW_SUM"],
            "raw_sum_in_mma": ["FFN_K15_RAW_SUM", "FFN_K15_IN_MMA"]}
# Timed options: name -> (macros, whether its outputs are K15's function).
TIMED = {"K15": ([], True),
         "bound 2^-22 (FFN_K15_ERR_BITS=22)": (["FFN_K15_ERR_BITS=22"],
                                               False),
         "no float64 sums": (["FFN_K15_NO_EXACT"], False),
         "no |x||w| MMA, no flags": (["FFN_K15_UNCORRECTED"], False)}
TIMED_NS = (64, 4, 1)
ERR_BITS = 21   # K15's bound, 2^-ERR_BITS mag (conv3d_bf16.cu)
SHARE_KINDS = ("conv0_a", "block_a", "block_b", "ci_conv0_a", "ci_block_b")
R2 = os.path.join(REPO, "models", "phantom", "model-r2.npz")
CAL_BITS = (18, 19, 20, 21, 22, 23, 24)


def phantom_inputs(n, dev):
    """`n` 33^3 patches of the seed-0 phantom, normalized as the request
    does, with a first FOV's seed (the pad logit, the init activation at
    the centre)."""
    from tools import synthetic_em
    image, _ = synthetic_em.make_volume(size=cs.PHANTOM_SIZE, seed=0,
                                        num_cells=cs.PHANTOM_CELLS)
    img = torch.from_numpy(image).float()
    gen = torch.Generator().manual_seed(0)
    starts = torch.randint(0, image.shape[0] - 33, (n, 3), generator=gen)
    patches = torch.stack([img[z:z + 33, y:y + 33, x:x + 33]
                           for z, y, x in starts.tolist()])
    patches = ((patches - 128.0) / 33.0)[..., None]
    seed = torch.full_like(patches, -cs.INIT_ACT)   # logit(0.05)
    seed[:, 16, 16, 16] = cs.INIT_ACT
    return patches.to(dev), seed.to(dev)


def calibrate(libs, dt, dev, emit):
    layers_in = []
    gen = torch.Generator(device=dev).manual_seed(17)
    for case in ("conv0_a", "block_a", "block_b"):
        pre = check.K15_CASES[case][3]
        x, w, _, _ = check.k15_inputs(gen, 16, (33, 33, 33), case, dt)
        layers_in.append((f"random {case}", x, w, pre))
    model = convstack_3d.ConvStack3DFFNModel(
        fov_size=[33] * 3, deltas=[8] * 3, depth=12, dtype=dt)
    model.load_params(params_io.load_params_npz(R2))
    model.to(dev)
    img, sd = phantom_inputs(8, dev)
    for fov in ("first FOV", "second FOV"):
        seen = []

        def record(x, w, b, *, pre_relu=False, **kw):
            if w.shape[0] == 3:
                seen.append((x, w, pre_relu))
            return check.conv3d_ndhwc_bf16_exact(x, w, b, pre_relu=pre_relu,
                                                 **kw)

        with mock.patch.object(convstack_3d, "conv3d_ndhwc_bf16", record):
            out = model.apply(img, sd)
        layers_in += [(f"model-r2 {fov} layer {i}", x, w, pre)
                      for i, (x, w, pre) in enumerate(seen)]
        sd = out   # the next FOV sees the updated logits
    worst = dict.fromkeys(libs, -1e9)
    count = 0
    unsure = {impl: dict.fromkeys(CAL_BITS, 0) for impl in libs}
    broken = {impl: dict.fromkeys(CAL_BITS, 0) for impl in libs}
    for name, x, w, pre in layers_in:
        exact = check.conv_sums_f64(x, w, pre_relu=pre)
        mag = check.conv_sums_f64(x, w, pre_relu=pre, absolute=True)
        zeros = torch.zeros(*x.shape[:4], w.shape[-1], device=dev)
        bias = torch.zeros(w.shape[-1], dtype=dt, device=dev)
        count += exact.numel()
        for impl, lib in libs.items():
            with mock.patch.object(_build, "lib", lambda: lib):
                raw = conv3d.conv3d_ndhwc_bf16(x, w, bias, pre_relu=pre,
                                               residual=zeros)
            err = (raw.double() - exact).abs()
            log2_max = float(torch.log2((err / mag.clamp_min(1e-300)).max()
                                        .clamp_min(1e-300)))
            worst[impl] = max(worst[impl], log2_max)
            row = dict(what="calibrate", dtype=str(dt), impl=impl,
                       layer=name, outputs=raw.numel(),
                       log2_max_err_over_mag=log2_max,
                       nonzero_err_without_mag=int(((mag == 0) &
                                                    (err > 0)).sum()))
            for bits in CAL_BITS:
                e = (mag * 2.0 ** -bits).float() + raw.abs() * 2.0 ** -22
                u = int(((raw - e).to(dt).view(torch.int16) !=
                         (raw + e).to(dt).view(torch.int16)).sum())
                b = int((err > e.double()).sum())
                unsure[impl][bits] += u
                broken[impl][bits] += b
                row[f"unsure_share_{bits}"] = u / raw.numel()
                row[f"beyond_bound_{bits}"] = b
            emit(row)
            del raw, err
        del exact, mag, zeros
    for impl in libs:
        emit(dict(what="calibrate_total", dtype=str(dt), impl=impl,
                  outputs=count, log2_max_err_over_mag=worst[impl],
                  unsure_share={b: unsure[impl][b] / count
                                for b in CAL_BITS},
                  beyond_bound=broken[impl]))


def flagged_share(raw, x, w, pre, bits=ERR_BITS):
    """Share of outputs whose bound 2^-bits mag (plus two float32 ulps)
    straddles a rounding point, from the raw float32 sums `raw`."""
    mag = check.conv_sums_f64(x, w, pre_relu=pre, absolute=True)
    e = (mag * 2.0 ** -bits).float() + raw.abs() * 2.0 ** -22
    return float(((raw - e).to(w.dtype).view(torch.int16) !=
                  (raw + e).to(w.dtype).view(torch.int16)).float().mean())


def time_options(libs, raw_lib, dev, emit, reps=7, inner=10):
    """The TIMED options and cuDNN on block_a (32->32, pre_relu,
    post_relu) at TIMED_NS, bfloat16 and float16."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(14)
    for dt in (torch.bfloat16, torch.float16):
        entry = "ffn_conv3d_ndhwc_" + conv3d.SUFFIX[dt]
        for n in TIMED_NS:
            x, w, b, _ = check.k15_inputs(gen, n, (33, 33, 33), "block_a",
                                          dt)
            y = torch.empty(n, 33, 33, 33, 32, dtype=dt, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream

            def launch(lib, out=y, res=None):
                _build.check(getattr(lib, entry)(
                    x.data_ptr(), 0, w.data_ptr(), b.data_ptr(),
                    None if res is None else res.data_ptr(), out.data_ptr(),
                    n, 33, 33, 33, 32, 32, 3, 1, 1, int(res is not None),
                    stream), entry)

            exact = check.conv3d_ndhwc_bf16_exact(x, w, b, pre_relu=True,
                                                  post_relu=True)
            raw = torch.empty(n, 33, 33, 33, 32, device=dev)
            zeros = torch.zeros_like(raw)
            launch(raw_lib, raw, zeros)
            share = flagged_share(raw, x, w, True)
            del raw, zeros
            fns, names = [], []
            for name, lib in libs.items():
                launch(lib)
                torch.cuda.synchronize()
                if TIMED[name][1]:
                    cs.require(torch.equal(y, exact),
                               f"{name} {dt} N={n} is not the float64 "
                               f"sums' rounding")
                fns.append(lambda lib=lib: launch(lib))
                names.append(name)
            xc = x.permute(0, 4, 1, 2, 3)
            wc = w.permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            fns.append(lambda: F.conv3d(xc, wc, b, padding=1))
            names.append("cuDNN conv3d")
            times = [[] for _ in fns]
            for fn in fns:
                fn()
            for _ in range(reps):
                for fn, out in zip(fns, times):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(inner):
                        fn()
                    end.record()
                    end.synchronize()
                    out.append(start.elapsed_time(end) / inner)
            med = {nm: statistics.median(t) for nm, t in zip(names, times)}
            emit(dict(what="time", dtype=str(dt), n=n, layer="block_a",
                      flagged_share=share, ms=med,
                      over_cudnn={nm: v / med["cuDNN conv3d"]
                                  for nm, v in med.items()}))
            del x, w, b, y, exact, xc, wc
            torch.cuda.empty_cache()


def shares(raw_lib, dev, emit, n=64):
    """The share of outputs K15 sums in float64, per 3^3 layer kind of
    K15_CASES on random inputs at N = n, in bfloat16 and float16."""
    gen = torch.Generator(device=dev).manual_seed(64)
    for dt in (torch.bfloat16, torch.float16):
        row = dict(what="flagged_share", dtype=str(dt), n=n)
        for kind in SHARE_KINDS:
            pre = check.K15_CASES[kind][3]
            x, w, _, _ = check.k15_inputs(gen, n, (33, 33, 33), kind, dt)
            zeros = torch.zeros(*x.shape[:4], w.shape[-1], device=dev)
            bias = torch.zeros(w.shape[-1], dtype=dt, device=dev)
            with mock.patch.object(_build, "lib", lambda: raw_lib):
                raw = conv3d.conv3d_ndhwc_bf16(x, w, bias, pre_relu=pre,
                                               residual=zeros)
            row[kind] = flagged_share(raw, x, w, pre)
            del x, w, zeros, raw
            torch.cuda.empty_cache()
        emit(row)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calibrate", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--f16", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not (args.calibrate or args.time):
        args.calibrate = True
    cs.phase_device()
    cs.phase_build()
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    tmp = tempfile.mkdtemp()
    libs = variant_libs.build(tmp, SOURCE, {
        name: (macros, []) for name, macros in dict(VARIANTS, **{
            name: macros for name, (macros, _) in TIMED.items()}).items()},
        ["ffn_conv3d_ndhwc_bf16", "ffn_conv3d_ndhwc_f16"])
    dev = torch.device("cuda")
    if args.calibrate:
        calibrate({k: libs[k] for k in VARIANTS},
                  torch.float16 if args.f16 else torch.bfloat16, dev, emit)
    if args.time:
        shares(libs["raw_sum"], dev, emit)
        time_options({k: libs[k] for k in TIMED}, libs["raw_sum"], dev, emit)


if __name__ == "__main__":
    main()
