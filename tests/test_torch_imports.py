"""The port stands alone: no ffn_tpu_torch module, and nothing in
chip_smoke.py, imports jax, flax or ffn_tpu, and no port module brings in
optax or h5py (the card's machine has neither). Each module is imported
in a fresh interpreter; the sources are searched for ffn_tpu imports.
"""

import glob
import os
import pkgutil
import re
import subprocess
import sys

import ffn_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = sorted(
    m.name for m in pkgutil.walk_packages(ffn_tpu_torch.__path__,
                                          "ffn_tpu_torch."))
IMPORT_OF_FFN_TPU = re.compile(
    r"^\s*(from\s+ffn_tpu(\.\S+)?\s+import|import\s+ffn_tpu(\.|\s|$))",
    re.MULTILINE)


def assert_imports_alone(modules):
    """Imports `modules` in a fresh interpreter; fails if jax, flax, optax,
    h5py, or ffn_tpu or any ffn_tpu.* module, came with them."""
    code = ("import sys, importlib\n"
            f"for m in {list(modules)!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'flax',\n"
            "             'optax', 'h5py') or\n"
            "             m == 'ffn_tpu' or m.startswith('ffn_tpu.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)


def test_the_package_lists_the_slice_modules():
    for name in ("ffn_tpu_torch.parallel.multi_canvas",
                 "ffn_tpu_torch.parallel.stitching",
                 "ffn_tpu_torch.parallel.sharded_inference",
                 "ffn_tpu_torch.cli.run_sharded_inference",
                 "ffn_tpu_torch.ops.finalize",
                 "ffn_tpu_torch.proto.inference_pb2",
                 "ffn_tpu_torch.utils.bounding_box",
                 "ffn_tpu_torch.proto.example_pb2",
                 "ffn_tpu_torch.utils.tfrecord",
                 "ffn_tpu_torch.ops.train",
                 "ffn_tpu_torch.ops.optim",
                 "ffn_tpu_torch.training.inputs",
                 "ffn_tpu_torch.training.train_lib",
                 "ffn_tpu_torch.training.train_loop",
                 "ffn_tpu_torch.cli.train",
                 "ffn_tpu_torch.ops.select",
                 # bfloat16 inference (K15) and the saved-segmentation
                 # format
                 "ffn_tpu_torch.ops.conv3d",
                 "ffn_tpu_torch.ops.conv3d_bf16_check",
                 "ffn_tpu_torch.models.convstack_3d",
                 "ffn_tpu_torch.inference.storage",
                 "ffn_tpu_torch.inference.counters",
                 "ffn_tpu_torch.inference.settings",
                 # the host-loop trainer
                 "ffn_tpu_torch.training.examples",
                 # int8 inference (K19, K20)
                 "ffn_tpu_torch.ops.quantized"):
        assert name in PORT_MODULES


def test_port_modules_import_without_jax_or_ffn_tpu():
    assert_imports_alone(PORT_MODULES)


def test_no_source_imports_ffn_tpu():
    paths = glob.glob(os.path.join(REPO, "ffn_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    offenders = []
    for path in paths:
        with open(path) as f:
            text = f.read()
        offenders += [f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}"
                      for m in IMPORT_OF_FFN_TPU.finditer(text)]
        if re.search(r"^\s*(import|from)\s+(jax|flax)\b", text, re.MULTILINE):
            offenders.append(f"{os.path.relpath(path, REPO)}: jax/flax")
    assert len(paths) > 40 and not offenders, offenders


def test_card_tools_import_without_jax_or_ffn_tpu():
    # The kernel tools run on the card's machine, which has no jax: each
    # imports alone (the ones that time the port's kernels; not
    # jax_bf16_round.py or round_vs_serial.py, which run the JAX package).
    tools = ["tools_torch.variant_libs", "tools_torch.k1_variants",
             "tools_torch.dgrad_variants", "tools_torch.k15_variants",
             "tools_torch.k18_variants", "tools_torch.k19_variants",
             "tools_torch.k10_variants", "tools_torch.k8_variants",
             "chip_smoke"]
    assert_imports_alone(tools)
