"""Model lookup by dotted name.

Counterpart of ffn_tpu/models/registry.py: 'convstack_3d.ConvStack3DFFNModel'
resolves inside ffn_tpu_torch.models by default; fully qualified dotted
paths import from anywhere.
"""

from __future__ import annotations

import importlib

_DEFAULT_PACKAGE = "ffn_tpu_torch.models"


def import_symbol(specifier: str, default_packages: str = _DEFAULT_PACKAGE):
    """Imports a symbol given 'module.path.Symbol' or 'module.Symbol'."""
    module_path, _, symbol_name = specifier.rpartition(".")
    if not module_path:
        raise ValueError(f"invalid specifier: {specifier!r}")
    try:
        module = importlib.import_module(module_path)
    except ImportError:
        module = importlib.import_module(
            f"{default_packages}.{module_path}")
    return getattr(module, symbol_name)
