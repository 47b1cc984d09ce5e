#!/usr/bin/env python3
"""K15 (conv3d_ndhwc_bf16) beside other summation orders, on the card.

Implementations of the bfloat16 layer, all with flax's roundings unless
named otherwise:
  k15            the library's K15 (ffn_tpu_torch/csrc/conv3d_bf16.cu):
                 rounds as the exact sum would;
  f32_order      K15's float32 sum in its own order, rounded as it falls
                 (FFN_K15_UNCORRECTED: K15 before it rounded exactly);
  f32_reverse_k  the same summing K from its far end;
  f32_in_mma     the same accumulating inside the tensor core;
  reverse_k, in_mma  K15 (exact rounding) with those orders;
  round_once     K15 rounding bf16(acc + bias) once (FFN_K15_ROUND_ONCE):
                 a wrong rounding, the control for the checks' limits;
  err_bits_B     K15 with its error bound at 2^-B (FFN_K15_ERR_BITS=B);
  plain          K15's plain version: cuDNN's float32 conv3d on the card;
  exact          conv3d_bf16_check.conv3d_ndhwc_bf16_exact: the sums in
                 float64, rounded to float32;
  f32            the model in float32 (K1), for the slices only.
The variants are built here from the library's source with their macros
defined, one nvcc each, all started together.

  python tools_torch/k15_variants.py [--calibrate] [--layers] [--stack]
      [--slices round,serial] [--seeds 0,1,2] [--impls k15,plain,...]
      [--out FILE]

--calibrate measures K15's float32 sum against the exact one, in units of
the sum of |x| * |w| (the scale of K15's error bound), for each layer kind
on random inputs and for every layer of the model-r2 stack on patches of
the seed-0 phantom, in K15's order and accumulating in the tensor core:
the largest ratio, and how many outputs the bound would send to the exact
recompute at 2^-B for several B. --layers prints, per layer kind at N=64
and per implementation, the share of outputs that differ from plain and
from exact, how many lie above and below exact, and the largest distance
from plain in units of conv3d_bf16_check.k15_tolerance, and times the
K15 builds against each other; --stack the depth-12 model-r2 stack at
N=64 against the exact stack; --slices runs chip_smoke.py's bfloat16
8-lane round slice (hops 0) and serial slice on the padded 100^3 phantom
of each seed: ground-truth agreement, moves, objects, and whether the
segmentation equals the exact run's. Each result is one JSON line on
stdout and in --out.
"""

import argparse
import contextlib
import ctypes
import dataclasses
import itertools
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
VARIANTS = {
    "f32_order": ["FFN_K15_UNCORRECTED"],
    "f32_reverse_k": ["FFN_K15_UNCORRECTED", "FFN_K15_REVERSE_K"],
    "f32_in_mma": ["FFN_K15_UNCORRECTED", "FFN_K15_IN_MMA"],
    "reverse_k": ["FFN_K15_REVERSE_K"], "in_mma": ["FFN_K15_IN_MMA"],
    "round_once": ["FFN_K15_ROUND_ONCE"],
    "raw_sum": ["FFN_K15_RAW_SUM"],
    "raw_sum_in_mma": ["FFN_K15_RAW_SUM", "FFN_K15_IN_MMA"]}
BF16_IMPLS = ("k15", "f32_order", "f32_reverse_k", "f32_in_mma",
              "reverse_k", "in_mma", "round_once", "plain", "exact")
R2 = os.path.join(REPO, "models", "phantom", "model-r2.npz")


def macros(name):
    if name.startswith("err_bits_"):
        return [f"FFN_K15_ERR_BITS={int(name[len('err_bits_'):])}"]
    return VARIANTS[name]


def is_variant(name):
    return name in VARIANTS or name.startswith("err_bits_")


def build_variants(names, tmp):
    """{name: K15 entry point} of each variant, compiled in parallel."""
    procs = {}
    for name in names:
        lib = os.path.join(tmp, f"{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc()] + _build.NVCC_FLAGS
            + [f"-D{m}" for m in macros(name)]
            + ["-shared", "-o", lib, SOURCE]))
    fns = {}
    for name, (lib, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant")
        fn = ctypes.CDLL(lib).ffn_conv3d_ndhwc_bf16
        fn.argtypes = _build._SIGNATURES["ffn_conv3d_ndhwc_bf16"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def using(impl, variant_fns):
    """A context in which the model's bfloat16 layers and
    conv3d.conv3d_ndhwc_bf16 compute as `impl`."""
    if impl in ("k15", "f32"):
        return contextlib.nullcontext()
    if is_variant(impl):
        real, fn = _build.lib(), variant_fns[impl]

        class Lib:
            def __getattr__(self, name):
                return (fn if name == "ffn_conv3d_ndhwc_bf16"
                        else getattr(real, name))

        return mock.patch.object(_build, "lib", lambda: Lib())
    layer = {"plain": conv3d.conv3d_ndhwc_bf16_plain,
             "exact": check.conv3d_ndhwc_bf16_exact}[impl]
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(convstack_3d, "conv3d_ndhwc_bf16",
                                          layer))
    stack.enter_context(mock.patch.object(conv3d, "conv3d_ndhwc_bf16",
                                          layer))
    return stack


def layers(impls, variant_fns, dev, emit):
    gen = torch.Generator(device=dev).manual_seed(15)
    for case in ("conv0_a", "block_a", "block_b", "conv_lom"):
        _, _, _, pre, post, _, _ = check.K15_CASES[case]
        x, w, b, r = check.k15_inputs(gen, 64, (33, 33, 33), case)
        kw = dict(pre_relu=pre, post_relu=post, residual=r)
        plain = conv3d.conv3d_ndhwc_bf16_plain(x, w, b, **kw)
        exact = check.conv3d_ndhwc_bf16_exact(x, w, b, **kw)
        tol = check.k15_tolerance(x, w, b, **kw)
        for impl in impls:
            with using(impl, variant_fns):
                got = conv3d.conv3d_ndhwc_bf16(x, w, b, **kw)
            signed = got.float() - exact.float()
            emit(dict(
                what="layer", case=case, n=64, impl=impl,
                differ_from_plain=check.differ_share(got, plain),
                differ_from_exact=check.differ_share(got, exact),
                above_exact=int((signed > 0).sum()),
                below_exact=int((signed < 0).sum()),
                max_tolerance_units=float(
                    ((got.float() - plain.float()).abs() / tol).max()),
                differ_share_limit=check.DIFFER_SHARE))
        if case == "block_a":
            calls = []
            names = [i for i in impls if i == "k15" or is_variant(i)]
            for impl in names:
                def call(impl=impl):
                    with using(impl, variant_fns):
                        conv3d.conv3d_ndhwc_bf16(x, w, b, **kw)
                calls.append(call)
            emit(dict(what="layer_ms", case=case, n=64,
                      order=names + names[::-1],
                      ms=cs.time_many(*calls, *calls[::-1])))
        del x, w, b, r, plain, exact, tol
        torch.cuda.empty_cache()


def stack(impls, variant_fns, dev, emit):
    gen = torch.Generator(device=dev).manual_seed(16)
    model = convstack_3d.ConvStack3DFFNModel(
        fov_size=[33] * 3, deltas=[8] * 3, depth=12, dtype="bfloat16")
    model.load_params(params_io.load_params_npz(R2))
    model.to(dev)
    img = torch.randn(64, 33, 33, 33, 1, generator=gen, device=dev)
    sd = torch.randn(64, 33, 33, 33, 1, generator=gen, device=dev) * 3
    with using("exact", variant_fns):
        exact = model.apply(img, sd)
    for impl in impls:
        with using(impl, variant_fns):
            got = model.apply(img, sd)
        d = got - exact
        emit(dict(what="stack", n=64, impl=impl,
                  max_abs_from_exact=float(d.abs().max()),
                  differ_from_exact=float((d != 0).float().mean()),
                  mean_signed_of_differing=float(d[d != 0].mean())
                  if bool((d != 0).any()) else 0.0,
                  bound=cs.K15_STACK_TOL * float(exact.abs().max())))


CAL_BITS = (16, 18, 20, 22, 24, 26)


def phantom_inputs(n, dev):
    """`n` 33^3 patches of the seed-0 phantom, normalized as the request
    normalizes them, with a first FOV's seed (the pad logit, the centre at
    the init activation)."""
    sys.path.insert(0, REPO)
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


def calibrate(variant_fns, dev, emit):
    """K15's float32 sum against the exact one, in units of the sum of
    |x| * |w|, on random layers and on the model-r2 stack's layers."""
    layers_in = []
    gen = torch.Generator(device=dev).manual_seed(17)
    for case in ("conv0_a", "block_a", "block_b"):
        _, _, _, pre, _, _, _ = check.K15_CASES[case]
        x, w, _, _ = check.k15_inputs(gen, 16, (33, 33, 33), case)
        layers_in.append((f"random {case}", x, w, pre))
    model = convstack_3d.ConvStack3DFFNModel(
        fov_size=[33] * 3, deltas=[8] * 3, depth=12, dtype="bfloat16")
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
    for impl in ("raw_sum", "raw_sum_in_mma"):
        worst, unsure, broken, count = -1e9, dict.fromkeys(CAL_BITS, 0), \
            dict.fromkeys(CAL_BITS, 0), 0
        for name, x, w, pre in layers_in:
            zeros = torch.zeros(*x.shape[:4], w.shape[-1], device=dev)
            bias = torch.zeros(w.shape[-1], dtype=torch.bfloat16, device=dev)
            with using(impl, variant_fns):
                raw = conv3d.conv3d_ndhwc_bf16(x, w, bias, pre_relu=pre,
                                               residual=zeros)
            exact = check.conv_sums_f64(x, w, pre_relu=pre)
            mag = check.conv_sums_f64(x, w, pre_relu=pre, absolute=True)
            err = (raw.double() - exact).abs()
            ratio = err / mag.clamp_min(1e-300)
            log2_max = float(torch.log2(ratio.max().clamp_min(1e-300)))
            worst = max(worst, log2_max)
            row = dict(what="calibrate", impl=impl, layer=name,
                       outputs=raw.numel(), log2_max_err_over_mag=log2_max,
                       nonzero_err_without_mag=int(((mag == 0) &
                                                    (err > 0)).sum()))
            for bits in CAL_BITS:
                e = (mag * 2.0 ** -bits).float() + raw.abs() * 2.0 ** -22
                u = int(((raw - e).to(torch.bfloat16).view(torch.int16) !=
                         (raw + e).to(torch.bfloat16).view(torch.int16)
                         ).sum())
                b = int((err > e.double()).sum())
                unsure[bits] += u
                broken[bits] += b
                row[f"unsure_share_{bits}"] = u / raw.numel()
                row[f"beyond_bound_{bits}"] = b
            count += raw.numel()
            emit(row)
            del raw, exact, mag, err, ratio
        emit(dict(what="calibrate_total", impl=impl, outputs=count,
                  log2_max_err_over_mag=worst,
                  unsure_share={b: unsure[b] / count for b in CAL_BITS},
                  beyond_bound=broken))


def slices(kinds, seeds, impls, variant_fns, have, dev, emit):
    with tempfile.TemporaryDirectory() as tmp:
        for seed in seeds:
            path, phantom = cs._phantom(tmp, seed=seed)
            r2 = dataclasses.replace(cs._settings(have, path, tmp),
                                     model_checkpoint_path=R2)
            args = json.loads(r2.model_args)
            args["dtype"] = "bfloat16"
            bf16 = dataclasses.replace(r2, model_args=json.dumps(args))
            segs = {}
            for kind, impl in itertools.product(kinds, impls):
                settings = r2 if impl == "f32" else bf16
                out = os.path.join(tmp, f"{seed}_{impl}_{kind}")
                label = f"seed {seed}, {impl}"
                with using(impl, variant_fns):
                    if kind == "round":
                        run = cs._run_round_slice(
                            label, dataclasses.replace(
                                settings, concurrent_requests=cs.ROUND_LANES,
                                segmentation_output_dir=out),
                            dev, **phantom)
                        seg, moves, agree = (run["seg"][phantom["inner"]],
                                             run["moves"], run["agree"])
                    else:
                        seg, moves, agree = cs._run_slice(
                            label, dataclasses.replace(
                                settings, segmentation_output_dir=out),
                            dev, **phantom)
                segs[kind, impl] = seg
                exact = segs.get((kind, "exact"))
                emit(dict(what="slice", kind=kind, seed=seed, impl=impl,
                          agreement=agree, moves=moves,
                          objects=len(set(seg[seg > 0].tolist())),
                          equal_to_exact=None if exact is None
                          else bool((seg == exact).all())))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calibrate", action="store_true")
    ap.add_argument("--layers", action="store_true")
    ap.add_argument("--stack", action="store_true")
    ap.add_argument("--slices", default="",
                    help="comma-separated: round, serial")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--impls", default=",".join(BF16_IMPLS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    impls = args.impls.split(",")
    have = cs.phase_device()
    cs.phase_build()
    dev = torch.device("cuda")
    wanted = [i for i in impls if is_variant(i)]
    if args.calibrate:
        wanted += ["raw_sum", "raw_sum_in_mma"]
    variant_fns = build_variants(sorted(set(wanted)), tempfile.mkdtemp())
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    bf16_impls = [i for i in impls if i != "f32"]
    if args.calibrate:
        calibrate(variant_fns, dev, emit)
    if args.layers:
        layers(bf16_impls, variant_fns, dev, emit)
    if args.stack:
        stack(bf16_impls, variant_fns, dev, emit)
    if args.slices:
        slices(args.slices.split(","),
               [int(s) for s in args.seeds.split(",")], impls, variant_fns,
               have, dev, emit)


if __name__ == "__main__":
    main()
