"""Model weights in the JAX package's flat npz checkpoints (`params/conv0_a/
kernel` keys; a LayerNorm's `params/ln1/scale` and `bias`), read with numpy
and mapped onto the port's modules, and written back under the same names
(`save_params_npz`). `jax_leaf_order` is JAX's leaf order (sorted keys:
`conv10_a` before `conv1_a`, `bias` before `kernel`), in which the
optimizer and EMA files store leaves.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "scale"}
_JAX_LEAF = {v: k for k, v in _LEAVES.items()}


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

    `params/conv0_a/kernel` becomes `conv0_a.weight`,
    `params/conv0_a/bias` becomes `conv0_a.bias` and a LayerNorm's
    `params/ln1/scale` becomes `ln1.scale`. Kernels stay in the DHWIO
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


def jax_name(name: str) -> str:
    """`conv0_a.weight` -> `params/conv0_a/kernel`, `ln1.scale` ->
    `params/ln1/scale` (the inverse of convert_params' naming)."""
    layer, leaf = name.split(".")
    return f"params/{layer}/{_JAX_LEAF[leaf]}"


def jax_leaf_order(names) -> list:
    """The port's parameter names in JAX's leaf order of the same tree."""
    return sorted(names, key=lambda n: jax_name(n).split("/"))


def save_params_npz(module: torch.nn.Module, path: str):
    """Writes `module`'s parameters as the JAX package's flat npz: keys
    `params/<layer>/kernel|bias|scale`, DHWIO kernels, float32. Loads with
    `load_params_npz` here and `ffn_tpu.models.params_io.load_params_npz`."""
    from ffn_tpu_torch.inference import storage
    flat = {jax_name(name): p.detach().cpu().numpy()
            for name, p in module.state_dict().items()}
    with storage.atomic_file(path) as fd:
        np.savez_compressed(fd, **flat)
