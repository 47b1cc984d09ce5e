#!/usr/bin/env python3
"""Calibrates K15's error bound on the card: K15's float32 sum against the
exact one, in units of the sum of |x| * |w| (the scale of the bound that
decides which outputs K15 recomputes in float64), on random layers of
each kind and on every 3^3 layer of the model-r2 stack over two FOVs of
the seed-0 phantom, in K15's order (FFN_K15_RAW_SUM) and accumulating in
the tensor core (with FFN_K15_IN_MMA): the largest ratio and, for several
bounds 2^-B, the share of outputs sent to the recompute and the outputs
beyond the bound. Each result is one JSON line on stdout and in --out.

  python tools_torch/k15_variants.py [--f16] [--out FILE]

The variants are built from ffn_tpu_torch/csrc/conv3d_bf16.cu with their
macros defined, one nvcc each.
"""

import argparse
import ctypes
import json
import os
import subprocess
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

SOURCE = os.path.join(REPO, "ffn_tpu_torch", "csrc", "conv3d_bf16.cu")
VARIANTS = {"raw_sum": ["FFN_K15_RAW_SUM"],
            "raw_sum_in_mma": ["FFN_K15_RAW_SUM", "FFN_K15_IN_MMA"]}
R2 = os.path.join(REPO, "models", "phantom", "model-r2.npz")
CAL_BITS = (16, 18, 20, 22, 24, 26)


def build_variants(tmp):
    """{name: the variant's library}, compiled in parallel."""
    procs = {name: (os.path.join(tmp, f"{name}.so"), None)
             for name in VARIANTS}
    for name, (lib, _) in procs.items():
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc()] + _build.NVCC_FLAGS
            + [f"-D{m}" for m in VARIANTS[name]] + ["-shared", "-o", lib,
                                                    SOURCE]))
    libs = {}
    for name, (lib, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant")
        libs[name] = ctypes.CDLL(lib)
        for entry in ("ffn_conv3d_ndhwc_bf16", "ffn_conv3d_ndhwc_f16"):
            fn = getattr(libs[name], entry)
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
    return libs


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
    for impl, lib in libs.items():
        worst, count = -1e9, 0
        unsure, broken = dict.fromkeys(CAL_BITS, 0), dict.fromkeys(CAL_BITS,
                                                                   0)
        for name, x, w, pre in layers_in:
            zeros = torch.zeros(*x.shape[:4], w.shape[-1], device=dev)
            bias = torch.zeros(w.shape[-1], dtype=dt, device=dev)
            with mock.patch.object(_build, "lib", lambda: lib):
                raw = conv3d.conv3d_ndhwc_bf16(x, w, bias, pre_relu=pre,
                                               residual=zeros)
            exact = check.conv_sums_f64(x, w, pre_relu=pre)
            mag = check.conv_sums_f64(x, w, pre_relu=pre, absolute=True)
            err = (raw.double() - exact).abs()
            log2_max = float(torch.log2((err / mag.clamp_min(1e-300)).max()
                                        .clamp_min(1e-300)))
            worst = max(worst, log2_max)
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
                unsure[bits] += u
                broken[bits] += b
                row[f"unsure_share_{bits}"] = u / raw.numel()
                row[f"beyond_bound_{bits}"] = b
            count += raw.numel()
            emit(row)
            del raw, exact, mag, err
        emit(dict(what="calibrate_total", dtype=str(dt), impl=impl,
                  outputs=count, log2_max_err_over_mag=worst,
                  unsure_share={b: unsure[b] / count for b in CAL_BITS},
                  beyond_bound=broken))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--f16", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cs.phase_device()
    cs.phase_build()
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    calibrate(build_variants(tempfile.mkdtemp()),
              torch.float16 if args.f16 else torch.bfloat16,
              torch.device("cuda"), emit)


if __name__ == "__main__":
    main()
