#!/usr/bin/env python3
"""Measures K8 (`finalize_pass`, csrc/finalize.cu) on the card, with float32
and bfloat16 seeds, beside the design options of its grid barrier and,
given one, another tree's K8.

Passes (chip_smoke's crafted states, every branch of the pass): "fused",
64 lanes and 4 slots of 82^3 (the fused slice's shapes); "devfin", 24
lanes and 2 slots of 132^3 (the devfin slice's volume); "empty", the fused
state with every lane running, fresh: a pass that finalizes nothing. Each
library's K8 is first held to finalize_pass_plain bit for bit from the same
state (one that differs is reported, left out of the timing, and fails the
run at its end); then each pass is timed, the libraries in turns: by CUDA events
around one call through the wrapper from a restored state (chip_smoke's
time_restored: the host's time in the wrapper included), and on the
device alone (torch.profiler, K8's kernel alone).

Libraries (variant_libs.py, one nvcc each, in parallel), each called
through the wrapper (`_build.lib` patched):
  K8: the source as it is: option (a), the grid on all SMs, the barrier's
    count and generation on lines of their own, the spin without sleep;
  --options: (a) with the count and the generation on one line and
    __nanosleep(64) in the spin (the barrier before this design); (b) one
    cluster of 8 or of 16 CTAs: barrier.cluster in place of the grid
    barrier, the turn's values in CTA 0's shared memory (distributed shared
    memory), the scans on the cluster's SMs;
  --split: the scans (count and id write) or the blanks cut out, or two
    more grid barriers a turn (exact): where a turn's time goes;
  --baseline [NAME=]DIR (repeatable): DIR's ffn_tpu_torch/csrc/finalize.cu
    (another checkout, such as the parent commit's), called through DIR's
    ops/finalize.py wrapper.
--slices: the fused slice (float32 seeds), the bf16-seed fused slice and
the bf16-seed devfin slice (8 lanes, FFN_TPU_DEVFIN=1) on the phantom, as
chip_smoke drives them, with K8 from K8 and the first baseline (baseline,
K8, K8, baseline): K8's device ms a launch by CUDA events, finalizations a
launch, the slice's moves/s.
Each result is one JSON line on stdout and in --out, with the card's name
and power limit.

  python tools_torch/k8_variants.py [--options] [--split]
                                    [--baseline [NAME=]DIR] [--slices]
                                    [--ptxas] [--out FILE]

~2 min on an H100 with --options, ~8 more with --slices and a baseline.
"""

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ffn_tpu_torch import _build  # noqa: E402
from ffn_tpu_torch.ops import finalize as fin_ops  # noqa: E402
from tools_torch import variant_libs  # noqa: E402

SRC = os.path.join(variant_libs.CSRC, "finalize.cu")
ENTRY = "ffn_finalize_pass"
FAILED = []   # the variants that differed from plain: not timed

# (a) with the barrier before this design: one line, a sleeping spin.
OPT_SLEEP = [("  kBarGen = 32,", "  kBarGen = 1,"),
             ("      while (*gen == g) {\n      }",
              "      while (*gen == g) __nanosleep(64);")]

# (b) one cluster of FFN_K8_CLUSTER CTAs.
GRID_SYNC = """  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* count = reinterpret_cast<unsigned*>(ctrl + kBarCount);"""
CLUSTER_SYNC = """  asm volatile(
      "barrier.cluster.arrive.release.aligned;\\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (false) {
    unsigned* count = reinterpret_cast<unsigned*>(ctrl + kBarCount);"""
LAUNCH = """  const dim3 grid(sms), block(kThreads);
  void* args[] = {&P, &p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(finalize_pass_kernel<T>), grid, block, args, 0,
      static_cast<cudaStream_t>(stream));"""
CLUSTER_LAUNCH = """  if (FFN_K8_CLUSTER > 8) {
    err = cudaFuncSetAttribute(
        finalize_pass_kernel<T>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(FFN_K8_CLUSTER);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = FFN_K8_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, finalize_pass_kernel<T>, P, p);"""
OPT_CLUSTER = [
    ('#include "common.cuh"',
     '#include "common.cuh"\n#include <cooperative_groups.h>'),
    (GRID_SYNC, CLUSTER_SYNC),
    ("""  volatile int* const turns =
      reinterpret_cast<volatile int*>(P.ctrl + kTurns);""",
     """  __shared__ int turn_buf[2 * kTurnInts];
  volatile int* const turns = reinterpret_cast<volatile int*>(
      cooperative_groups::this_cluster().map_shared_rank(turn_buf, 0));"""),
    # CTA 0 holds the turns: no CTA leaves before the last one read it.
    ("    if (lane < 0) break;",
     "    if (lane < 0) {\n      grid_sync(P.ctrl);\n      break;\n    }"),
    (LAUNCH, CLUSTER_LAUNCH),
]

# --split: parts cut out (their results differ where a part is cut, and
# are timed all the same), and two more barriers a turn (exact).
SPLIT = {
    "no scans (count, write)": [
        ("    if (turn_s[tCand] && worker) {",
         "    if (false && turn_s[tCand] && worker) {"),
        ("    if (ok && worker) {", "    if (false && ok && worker) {")],
    "no blank": [("    if (prev >= 0 && worker) {",
                  "    if (false && prev >= 0 && worker) {")],
    "+2 barriers a turn": [
        ("    grid_sync(P.ctrl);\n    const int nvox",
         "    grid_sync(P.ctrl);\n    grid_sync(P.ctrl);\n"
         "    grid_sync(P.ctrl);\n    const int nvox")],
}

OPTIONS = {
    "(a) one line, __nanosleep(64)": ([], OPT_SLEEP),
    "(b) cluster of 8": (["FFN_K8_CLUSTER=8"], OPT_CLUSTER),
    "(b) cluster of 16": (["FFN_K8_CLUSTER=16"], OPT_CLUSTER),
}


class _Lib:
    """The kernel library with another ffn_finalize_pass."""

    def __init__(self, real, fn):
        self._real, self.ffn_finalize_pass = real, fn

    def __getattr__(self, name):
        return getattr(self._real, name)


def _wrapper_of(path, i):
    """ops/finalize.py of another checkout, as a module of its own (it
    imports this tree's _build and ops.hop)."""
    spec = importlib.util.spec_from_file_location(
        f"k8_baseline_finalize{i}",
        os.path.join(path, "ffn_tpu_torch", "ops", "finalize.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def using(variant):
    """K8 from variant (fn, wrapper module or None) while inside. The
    variants share the wrapper's scratch: each leaves the barrier's count
    at zero, and none reads another's words."""
    fn, wrapper = variant
    lib = _Lib(_build.lib(), fn)
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(_build, "lib", lambda: lib))
        if wrapper is not None:
            stack.enter_context(mock.patch.object(
                fin_ops, "finalize_pass", wrapper.finalize_pass))
        yield


def crafted(tk, dev, case, seed_dtype):
    """chip_smoke's crafted K8 state for `case`: (a factory of its lane
    and finalize states, blocked, fin_opts, the passes' keywords)."""
    bf16 = seed_dtype == torch.bfloat16
    rng = np.random.RandomState(1)
    B, K, edge = {"fused": (cs.LANES, cs.FUSED_SLOTS, cs.FUSED_SUB),
                  "devfin": (24, 2, 132)}[case]
    fov, deltas = 33, (8, 8, 8)
    lanes, fin, blocked, opts = tk.crafted_finalize(
        rng, B, K, (edge,) * 3, 32768, max(8 * B, 512), fov, deltas,
        cs.MAX_ITERS, 1000)
    move_t = tk.MOVE_T
    if bf16:
        move_t = tk.MOVE_T_LO
        tk.bf16_finalize_edges(rng, lanes, fin, opts, move_t)
    blk = torch.from_numpy(blocked).to(dev)

    def state():
        ls = tk.to_torch(lanes, dev)
        ls["seeds"] = ls["seeds"].to(seed_dtype)
        return ls, tk.to_torch(fin, dev)
    kw = dict(fov=fov, deltas=deltas, max_iters=cs.MAX_ITERS,
              move_threshold=move_t)
    return state, blk, opts, kw


def device_ms(fn, restore, calls=10):
    """K8's device ms a call (its kernel alone under torch.profiler), each
    call from the restored state."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            restore()
            fn()
        torch.cuda.synchronize()
    us = [e.device_time_total if hasattr(e, "device_time_total") else
          e.cuda_time_total for e in prof.key_averages()
          if "finalize_pass" in e.key]
    return sum(us) / calls / 1e3


def measure(emit, dev, variants):
    tk = cs._tests()
    for seed_dtype in (torch.float32, torch.bfloat16):
        dname = "bf16" if seed_dtype == torch.bfloat16 else "f32"
        for case in ("fused", "devfin", "empty"):
            state, blk, opts, kw = crafted(
                tk, dev, "fused" if case == "empty" else case, seed_dtype)
            work, snap, plain = state(), state(), state()
            if case == "empty":
                for st in (work, snap, plain):
                    st[0]["status"].fill_(1)
                    st[0]["fresh"].fill_(True)
                    st[0]["iters"].fill_(1)

            def restore():
                for w, s in zip(work, snap):
                    for name in w:
                        w[name].copy_(s[name])

            def call():
                return tk.finalize_step(fin_ops.finalize_pass, *work, blk,
                                        opts, **kw)
            want = tk.finalize_step(fin_ops.finalize_pass_plain, *plain, blk,
                                    opts, **kw)
            fins = int(plain[1]["log_n"])
            # The turns: lanes the pass took (iters 0 and RUNNING or
            # DONE_FINALIZED after it, but for those already so before).
            after, before = plain[0], snap[0]
            done = (after["iters"] == 0) & ((after["status"] == 1)
                                            | (after["status"] == 6))
            was = (before["iters"] == 0) & ((before["status"] == 1)
                                            | (before["status"] == 6))
            turns = int((done & ~was).sum())
            timed = {}
            for name, v in variants.items():
                with using(v):
                    restore()
                    got = call()
                    torch.cuda.synchronize()
                same = torch.equal(got, want) and all(
                    tk.nan_equal(w[k], p[k])
                    for w, p in zip(work, plain) for k in p)
                emit(dict(kernel="K8", seeds=dname, case=case, variant=name,
                          equal_plain=same, finalizations=fins))
                if same or name in SPLIT:
                    timed[name] = v
                else:
                    FAILED.append(f"{name} {case} {dname}")
            times = {name: [] for name in timed}
            for _ in range(cs.REPS):
                for name, v in timed.items():
                    with using(v):
                        times[name].append(cs.time_restored([call], restore,
                                                            reps=1)[0])
            for name, v in timed.items():
                with using(v):
                    dev_ms = device_ms(call, restore)
                    host_us = None
                    if case == "empty":   # the state stays as it is
                        n = 100
                        t0 = time.perf_counter()
                        for _ in range(n):
                            call()
                        host_us = 1e6 * (time.perf_counter() - t0) / n
                        torch.cuda.synchronize()
                emit(dict(kernel="K8", seeds=dname, case=case, variant=name,
                          ms=statistics.median(times[name]),
                          device_ms=dev_ms, host_us_a_call=host_us,
                          finalizations=fins, turns=turns))
            del work, snap, plain, blk
            torch.cuda.empty_cache()


def slices(emit, dev, variants, tmp):
    """The three slices with K8 from each variant, in the order given."""
    image, phantom = cs._phantom(tmp, seed=0)
    settings = cs._settings(image, os.path.join(tmp, "kernels"))
    r2 = dataclasses.replace(
        settings, model_checkpoint_path=os.path.join(
            REPO, "models", "phantom", "model-r2.npz"))
    f32_args = {"depth": 12, "fov_size": [33] * 3, "deltas": [8] * 3}
    bf16_args = dict(json.loads(r2.model_args), dtype="bfloat16")
    bf16_settings = dataclasses.replace(r2, model_args=json.dumps(bf16_args))
    for i, (name, v) in enumerate(variants):
        for path in ("fused", "bf16-seed fused", "bf16-seed devfin"):
            probe = cs._K8Probe()
            env = {} if path == "fused" else {"FFN_TPU_SEED_DTYPE": "bf16"}
            with using(v), mock.patch.dict(os.environ, env):
                if path == "bf16-seed devfin":
                    with mock.patch.dict(os.environ, {"FFN_TPU_DEVFIN": "1"}):
                        with probe.patch():
                            run = cs._run_slice(
                                f"{path} with K8 {name}",
                                dataclasses.replace(
                                    bf16_settings,
                                    concurrent_requests=cs.GATE_LANES,
                                    segmentation_output_dir=os.path.join(
                                        tmp, f"devfin{i}")),
                                dev, **phantom, hops=cs.HOPS)
                else:
                    run = cs._fused(
                        f"{path} slice with K8 {name}", f"fused{i}{path[0]}",
                        tmp, f32_args if path == "fused" else bf16_args,
                        patches=[probe.patch()])
            k8 = probe.report(f"the {path} slice with K8 {name}")
            emit(dict(kernel="K8", slice=path, variant=name,
                      launches=k8["launches"],
                      ms_a_launch=k8["ms"] / k8["launches"],
                      finalizations_a_launch=k8["fins"] / k8["launches"],
                      moves=run["moves"], wall_s=run["wall"],
                      moves_per_s=run["moves"] / run["wall"]))
            torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--options", action="store_true")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--baseline", action="append", default=[])
    ap.add_argument("--slices", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    cs.require(torch.cuda.is_available(), "k8_variants needs a CUDA card")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.lib()
    builds = {"K8": ([], [])}
    if args.options:
        builds.update(OPTIONS)
    if args.split:
        builds.update({name: ([], cuts) for name, cuts in SPLIT.items()})
    bases = dict(b.split("=", 1) if "=" in b else ("baseline", b)
                 for b in args.baseline)
    with tempfile.TemporaryDirectory() as tmp:
        libs = variant_libs.build(tmp, SRC, builds, [ENTRY])
        variants = {name: (getattr(lib, ENTRY), None)
                    for name, lib in libs.items()}
        for i, (name, path) in enumerate(bases.items()):
            lib = variant_libs.build(
                os.path.join(tmp, f"base{i}"),
                os.path.join(path, "ffn_tpu_torch", "csrc", "finalize.cu"),
                {name: ([], [])}, [ENTRY])[name]
            variants[name] = (getattr(lib, ENTRY), _wrapper_of(path, i))
        print(f"built in {time.perf_counter() - t0:.1f} s")
        with variant_libs.emitter(args.out) as emit:
            if args.ptxas:
                for line in variant_libs.ptxas_report([SRC], "finalize"):
                    print(line)
            measure(emit, dev, variants)
            if args.slices:
                order = [("K8", variants["K8"])]
                if bases:   # the first baseline, K8, K8, the first baseline
                    first = next(iter(bases))
                    order = [(first, variants[first])] + order * 2 + [
                        (first, variants[first])]
                slices(emit, dev, order, tmp)
    print(f"done in {time.perf_counter() - t0:.1f} s")
    cs.require(not FAILED, f"differ from plain: {FAILED}")


if __name__ == "__main__":
    main()
