"""Model weights from the JAX package's flat npz checkpoints.

The JAX package saves flax variable trees as flat npz archives with keys
like `params/conv0_a/kernel` (ffn_tpu/models/params_io.py). This module
reads them with numpy alone and maps them onto the port's modules.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_LEAVES = {"kernel": "weight", "bias": "bias"}


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def load_params_npz(path: str) -> dict:
    """The flat {`params/<layer>/<leaf>`: ndarray} content of an npz."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def convert_params(flat_or_tree: Mapping) -> dict:
    """JAX parameters (flat npz dict or nested flax tree) -> state_dict.

    `params/conv0_a/kernel` becomes `conv0_a.weight` and
    `params/conv0_a/bias` becomes `conv0_a.bias`. Kernels stay in the DHWIO
    layout (k, k, k, Cin, Cout), which is the layout the port's conv kernel
    reads, so the conversion transposes nothing.
    """
    state = {}
    for path, value in _flatten(flat_or_tree).items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        if len(parts) != 2 or parts[1] not in _LEAVES:
            raise ValueError(f"unexpected parameter {path!r}")
        state[f"{parts[0]}.{_LEAVES[parts[1]]}"] = torch.tensor(
            np.asarray(value, dtype=np.float32))
    return state
