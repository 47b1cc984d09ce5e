"""What the kernel-variant tools share (k15_variants.py, k18_variants.py,
dgrad_variants.py, k1_variants.py): a kernel's source built as libraries with measurement
macros defined or parts cut out, nvcc's register and spill report, a
call's host and device time, and JSON lines stamped with the card's name
and power limit. Needs nvcc and, for the times, a CUDA card."""

import contextlib
import ctypes
import json
import os
import subprocess
import tempfile
import time

import torch

from ffn_tpu_torch import _build

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ffn_tpu_torch", "csrc")


def build(tmp, src, variants, entries):
    """{name: the library built from `src` with variants[name] = (macros,
    cuts)}: macros defined, each cut an (anchor, replacement) pair whose
    anchor the source holds once, or a (header, anchor, replacement) triple
    cutting a copy of one of csrc's headers, which the variant's source then
    includes in its place. One nvcc each, all in parallel; the C functions
    `entries` typed as the library's own."""
    sources = {name: cut_sources(src, cuts)
               for name, (_, cuts) in variants.items()}
    procs = {}
    for i, (name, (macros, _)) in enumerate(variants.items()):
        vdir = os.path.join(tmp, f"v{i}")
        os.makedirs(vdir)
        for path, text in sources[name].items():
            with open(os.path.join(vdir, path), "w") as f:
                f.write(text)
        cu = os.path.join(vdir, os.path.basename(src))
        lib = os.path.join(vdir, "variant.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc()] + _build.NVCC_FLAGS
            + [f"-D{m}" for m in macros]
            + ["-I", CSRC, "-shared", "-o", lib, cu]))
    libs = {}
    for name, (lib, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name}")
        libs[name] = ctypes.CDLL(lib)
        for entry in entries:
            fn = getattr(libs[name], entry)
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
    return libs


def cut_sources(src, cuts):
    """{file name: text} of `src` and of the headers that `cuts` cut (see
    build), each cut applied; raises if an anchor is not found once."""
    texts = {os.path.basename(src): open(src).read()}
    for cut in cuts:
        path, a, b = cut if len(cut) == 3 else (os.path.basename(src),) \
            + tuple(cut)
        if path not in texts:
            texts[path] = open(os.path.join(CSRC, path)).read()
        if texts[path].count(a) != 1:
            raise RuntimeError(f"anchor {a!r} not once in {path}")
        texts[path] = texts[path].replace(a, b)
    return texts


def ptxas_report(srcs, match):
    """nvcc's register and spill lines for the kernels of `srcs` whose
    names hold `match`."""
    keep = []
    with tempfile.TemporaryDirectory() as tmp:
        for src in srcs:
            proc = subprocess.run(
                [_build._nvcc()] + _build.NVCC_FLAGS
                + ["-Xptxas", "-v", "-c", "-o", os.path.join(tmp, "k.o"),
                   src], capture_output=True, text=True, check=True)
            lines = proc.stderr.splitlines()
            for i, line in enumerate(lines):
                if "Compiling entry function" in line and match in line:
                    keep += lines[i:i + 4]
    return keep


def device_split(fn, calls=20):
    """Host microseconds a call (launches only, no sync), and device
    microseconds a call by kernel name (torch.profiler): each kernel's mean
    over the events the profiler kept, times its launches a call (it may
    drop events of a long run)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    device = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            device[ev.key[:60]] = us / ev.count * max(
                1, round(ev.count / calls))
    return dict(host_us=host_us, device_us=device)


@contextlib.contextmanager
def emitter(path=None):
    """emit(record): prints it as one JSON line, with the card's name and
    power limit (nvidia-smi, also printed first) under "card", and writes
    it to `path` too when one is given."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    out = open(path, "w") if path else None

    def emit(rec):
        rec["card"] = smi
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    try:
        yield emit
    finally:
        if out:
            out.close()
