"""K1: SAME-padded 3D convolution, channels-last (NDHWC), float32.

`conv3d_ndhwc_f32` is the one convolution of the port's ConvStack3D. On a
CUDA tensor it launches the hand-written kernel in `csrc/conv3d.cu`; on a
CPU tensor it runs `conv3d_ndhwc_plain`, the same function in plain
PyTorch, which also serves as the kernel's oracle on the card.

Weights keep the JAX package's DHWIO layout (k, k, k, Cin, Cout): the
kernel reads it as [tap][ci][co], so no transpose is needed to load a JAX
checkpoint. The plain version permutes to PyTorch's OIDHW per call.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ffn_tpu_torch import _build

NAME = "conv3d_ndhwc_f32"


def conv3d_ndhwc_plain(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, *, pre_relu: bool = False,
                       post_relu: bool = False,
                       residual: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """relu?(x) (*) weight + bias, relu?, + residual; all NDHWC."""
    if pre_relu:
        x = torch.relu(x)
    k = weight.shape[0]
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), weight.permute(4, 3, 0, 1, 2),
                 bias, padding=k // 2)
    y = y.permute(0, 2, 3, 4, 1)
    if post_relu:
        y = torch.relu(y)
    if residual is not None:
        y = y + residual
    return y.contiguous()


def _check(x, weight, bias, residual):
    if x.dim() != 5 or weight.dim() != 5:
        raise ValueError(f"want x (N,D,H,W,Cin) and weight (k,k,k,Cin,Cout), "
                         f"got {tuple(x.shape)} and {tuple(weight.shape)}")
    k, k1, k2, cin, cout = weight.shape
    if not (k == k1 == k2 and k in (1, 3)):
        raise ValueError(f"kernel must be 1^3 or 3^3, got {weight.shape[:3]}")
    if x.shape[-1] != cin or tuple(bias.shape) != (cout,):
        raise ValueError(f"channel mismatch: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}, bias {tuple(bias.shape)}")
    tensors = [x, weight, bias]
    if residual is not None:
        if tuple(residual.shape) != tuple(x.shape[:4]) + (cout,):
            raise ValueError(f"residual {tuple(residual.shape)} does not "
                             f"match the output {tuple(x.shape[:4])}+{cout}")
        tensors.append(residual)
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{NAME} takes float32, got {t.dtype}")


def conv3d_ndhwc_f32(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, *, pre_relu: bool = False,
                     post_relu: bool = False,
                     residual: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """K1. CPU tensors take the plain version; CUDA tensors the kernel."""
    _check(x, weight, bias, residual)
    if x.device.type == "cpu":
        return conv3d_ndhwc_plain(x, weight, bias, pre_relu=pre_relu,
                                  post_relu=post_relu, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {x.device}")
    tensors = [x, weight, bias] + ([residual] if residual is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{NAME} takes contiguous tensors")
    n, d, h, w, cin = x.shape
    k, cout = weight.shape[0], weight.shape[-1]
    y = torch.empty((n, d, h, w, cout), device=x.device, dtype=torch.float32)
    err = _build.lib().ffn_conv3d_ndhwc_f32(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        residual.data_ptr() if residual is not None else None, y.data_ptr(),
        n, d, h, w, cin, cout, k, int(pre_relu), int(post_relu),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, NAME)
    _build.launches[NAME] += 1
    return y
