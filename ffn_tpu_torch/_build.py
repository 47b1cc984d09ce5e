"""Builds and loads the port's hand-written CUDA kernels.

Each `csrc/*.cu` compiles in its own `nvcc` process, all started together
(shared headers: `csrc/*.cuh`); one more links them into a shared library
with a plain C interface, loaded through ctypes, under
`build/ffn_tpu_torch_kernels/<hash of sources and headers>/`. The first
launch builds, not the import; a missing `nvcc` or a failed build raises.
`launches` counts launches by kernel name: each wrapper adds one where it
launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
_SOURCES = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu")))
_HEADERS = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cuh")))
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build",
                          "ffn_tpu_torch_kernels")
LIB_NAME = "libffn_tpu_torch_kernels.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points: each returns the cudaError_t of its launch.
_SIGNATURES = {
    "ffn_conv3d_ndhwc_f32": [_P, _P, _P, _P, _P] + [_I] * 9 + [_P],
    "ffn_conv3d_ndhwc_bf16": [_P, _I, _P, _P, _P, _P] + [_I] * 10 + [_P],
    "ffn_conv3d_ndhwc_f16": [_P, _I, _P, _P, _P, _P] + [_I] * 10 + [_P],
    "ffn_conv3d_dgrad_16": [_P, _I] + [_P] * 5 + [_I] * 8 + [_P],
    "ffn_conv3d_wgrad_16": [_P, _I, _P, _I] + [_P] * 4 + [_I] * 10 + [_P],
    "ffn_conv3d_wgrad16_tc": [_P, _I] + [_P] * 5 + [_I] * 11 + [_P],
    "ffn_step_gather": [_P, _P, _P, _P] + [_I] * 12 + [_F, _I, _P],
    "ffn_step_update": [_P, _P, _P] + [_I] * 12 + [_F, _F, _I, _P],
    "ffn_hop_pop": [_P] * 22 + [_I] * 18 + [_F, _I, _P],
    "ffn_hop_gather": [_P] * 7 + [_I] * 11 + [_F, _F, _I, _P],
    "ffn_hop_update": [_P] * 17 + [_I] * 20 + [_F, _F, _I, _P],
    "ffn_hop_screen": [_P] * 2 + [_I] * 7 + [_F] * 3 + [_P],
    "ffn_lane_verdicts": [_P] * 6 + [_I] * 4 + [_F, _F, _I, _P],
    "ffn_lane_mask": [_P] * 3 + [_I] * 13 + [_F, _F, _I, _P],
    "ffn_lane_masks": [_P] * 4 + [_I] * 4 + [_L, _L, _F, _F, _I, _P],
    "ffn_finalize_pass": [_P] * 26 + [_I] * 6 + [_L] + [_I] * 12
                         + [_F] * 4 + [_I, _P],
    "ffn_conv3d_dgrad_f32": [_P] * 6 + [_I] * 7 + [_P],
    "ffn_conv3d_wgrad_f32": [_P] * 6 + [_I] * 10 + [_P],
    "ffn_train_prep": [_P] * 5 + [_L, _L] + [_I] * 4 + [_F] * 6 + [_P],
    "ffn_train_gather": [_P] * 7 + [_I, _P, _I, _I, _F, _F, _P],
    "ffn_train_loss": [_P] * 11 + [_I, _P, _I, _P],
    "ffn_train_eval": [_P] * 7 + [_I, _P, _I, _P],
    "ffn_fov_loss": [_P] * 8 + [_L, _I, _P],
    "ffn_optim_update": [_P] * 6 + [_I] + [_P] * 7 + [_I, _P, _P, _I, _P],
    "ffn_select_gather": [_P] * 6 + [_I] * 11 + [_F, _F, _I, _P],
    "ffn_select_update": [_P] * 5 + [_I] * 13 + [_F, _F, _I, _P],
    "ffn_qconv3d_s8": [_P] * 7 + [_I] * 9 + [_P],
    "ffn_act_absmax": [_P, _I, _P, _P, _I, _L, _P],
    "ffn_layernorm_channels": [_P, _I, _P, _P, _P, _L, _I, _P],
    "ffn_edges_sobel": [_P, _P, _I, _I, _I, _P],
    "ffn_edges_blur": [_P, _P, _I, _P, _P, _P, _L, _I, _L, _P],
}

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME \
        else []
    candidates.append(shutil.which("nvcc"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels of ffn_tpu_torch "
                       "need the CUDA toolkit (set CUDA_HOME)")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _SOURCES + _HEADERS:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compiles the kernels if needed; returns the shared library's path."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for src in _SOURCES:
        fd, obj = tempfile.mkstemp(suffix=".o", dir=out_dir)
        os.close(fd)
        cmd = [nvcc] + NVCC_FLAGS + ["-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    if not failed:
        cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
               "-o", tmp] + objs
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    for obj in objs:
        os.unlink(obj)
    if failed:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib_path)  # atomic: concurrent builders race safely
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def host_array(ctype, values):
    """A ctypes array of `values` and its address, for a C entry point that
    reads a host table (the array must outlive the call)."""
    arr = (ctype * len(values))(*values)
    return arr, ctypes.addressof(arr)


def check(err: int, name: str):
    """Raises if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
