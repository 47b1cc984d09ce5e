"""K21 layernorm_channels: LayerNorm over the channel (last) axis of an
NDHWC tensor, flax's `nn.LayerNorm(dtype=...)` as ResConvStack calls it
(ffn_tpu/models/convstack_3d.py:103; `csrc/layernorm.cu`).

Storage float32, bfloat16 or float16; scale, bias and the statistics
float32, eps 1e-6. flax's formula in one fixed order: the channels summed
one by one in channel order, the fast variance max(0, E[x^2] - mean^2),
mul = rsqrt(var + eps) * scale, y = (x - mean) * mul + bias, rounded once
to the storage type. On a CUDA tensor the wrapper launches the kernel; on
a CPU tensor it runs `layernorm_channels_plain`, which rounds every step
as the kernel does (its rsqrt in float64, then rounded to float32) and is
the kernel's oracle on the card. XLA sums in another order, so the CPU
tests hold the plain version to flax's layer within a tolerance.
"""

from __future__ import annotations

import torch

from ffn_tpu_torch import _build

NAME = "layernorm_channels"
EPS = 1e-6                 # flax's nn.LayerNorm default (kEps in the .cu)
MAX_CHANNELS = 64          # csrc/layernorm.cu kMaxC
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def layernorm_channels_plain(x: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor) -> torch.Tensor:
    """(..., C) in x's type: LayerNorm over the last axis, K21's order."""
    xf = x.float()
    c = xf.shape[-1]
    s, q = xf[..., 0], xf[..., 0] * xf[..., 0]
    for i in range(1, c):
        s = s + xf[..., i]
        q = q + xf[..., i] * xf[..., i]
    mean = s / c
    d = q / c - mean * mean
    var = torch.where(d < 0, torch.zeros_like(d), d)
    r = torch.rsqrt((var + EPS).double()).float()
    y = (xf - mean[..., None]) * (r[..., None] * scale) + bias
    return y.to(x.dtype).contiguous()


def _check(x, scale, bias):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{NAME} takes float32, bfloat16 or float16, got "
                        f"{x.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"{NAME}: scale and bias must be float32, got "
                        f"{scale.dtype} and {bias.dtype}")
    c = x.shape[-1] if x.dim() else 0
    if (x.dim() < 1 or tuple(scale.shape) != (c,)
            or tuple(bias.shape) != (c,)):
        raise ValueError(f"{NAME}: scale and bias must be ({c},), got "
                         f"{tuple(scale.shape)} and {tuple(bias.shape)}")
    for t in (scale, bias):
        if t.device != x.device:
            raise ValueError(f"{NAME}: tensors on {t.device} and {x.device}")
    if not all(t.is_contiguous() for t in (x, scale, bias)):
        raise ValueError(f"{NAME} takes contiguous tensors")


def layernorm_channels(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """K21. CPU tensors take the plain version; CUDA tensors the kernel."""
    _check(x, scale, bias)
    if x.device.type == "cpu":
        return layernorm_channels_plain(x, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {x.device}")
    c = x.shape[-1]
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"{NAME}: the kernel takes 1 to {MAX_CHANNELS} "
                         f"channels, got {c}")
    y = torch.empty_like(x)
    err = _build.lib().ffn_layernorm_channels(
        x.data_ptr(), _DTYPE_CODES[x.dtype], scale.data_ptr(),
        bias.data_ptr(), y.data_ptr(), x.numel() // c, c,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, NAME)
    _build.launches[NAME] += 1
    return y
