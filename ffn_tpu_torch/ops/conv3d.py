"""K1: SAME-padded 3D convolution, channels-last (NDHWC), float32; K15 the
same in bfloat16; K9 and K10 K1's backward.

`conv3d_ndhwc_f32` is the one convolution of the port's float32
ConvStack3D, `conv3d_ndhwc_bf16` of its bfloat16 one. On a CUDA tensor each
launches its hand-written kernel (`csrc/conv3d.cu`, `csrc/conv3d_bf16.cu`);
on a CPU tensor it runs its plain version (`conv3d_ndhwc_plain`,
`conv3d_ndhwc_bf16_plain`), the same function in plain PyTorch, which also
serves as the kernel's oracle on the card.

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


# -- K15: the layer in bfloat16 ---------------------------------------------

BF16 = "conv3d_ndhwc_bf16"
# (Cin, Cout) pairs of K15's tensor-core kernel (3^3 layers): the stack's
# input layer and its inner layers at 32 features (model-r2, the benches)
# and at 16 (the CI checkpoint). 1^3 layers take any widths.
BF16_SHAPES = ((2, 32), (32, 32), (2, 16), (16, 16))


def conv3d_ndhwc_bf16_plain(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, *, pre_relu: bool = False,
                            post_relu: bool = False,
                            residual: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """flax's `nn.Conv(dtype=bfloat16)` with the stack's relus and residual:
    `x` (float32 or bfloat16) rounds to bfloat16 (nearest even), the
    products of bfloat16 `x` and `weight` are summed in float32, the sum
    rounds to bfloat16, the bfloat16 `bias` is added and the result rounds
    again; then relu (post_relu) and the residual: a bfloat16 residual is
    added and rounded, giving a bfloat16 output; a float32 residual (the
    seed, under conv_lom) gives `float32(y) + residual`. Without a residual
    the output is bfloat16.

    The sums run in float32 through F.conv3d on bfloat16-valued float32
    tensors: the products are exact (in TF32 too), the sums are added in
    an order of the convolution library's choosing, so the kernel's
    results may round differently (tests/test_torch_kernels.py
    k15_tolerance).
    """
    xf = x.to(torch.bfloat16).float()
    if pre_relu:
        xf = torch.relu(xf)
    k = weight.shape[0]
    acc = F.conv3d(xf.permute(0, 4, 1, 2, 3),
                   weight.float().permute(4, 3, 0, 1, 2), padding=k // 2)
    y = acc.permute(0, 2, 3, 4, 1).to(torch.bfloat16)
    y = (y.float() + bias.float()).to(torch.bfloat16)
    if post_relu:
        y = torch.relu(y)
    if residual is not None:
        if residual.dtype == torch.float32:
            return (y.float() + residual).contiguous()
        y = (y.float() + residual.float()).to(torch.bfloat16)
    return y.contiguous()


def _check_bf16(x, weight, bias, residual):
    if x.dim() != 5 or weight.dim() != 5:
        raise ValueError(f"{BF16}: want x (N,D,H,W,Cin) and weight "
                         f"(k,k,k,Cin,Cout), got {tuple(x.shape)} and "
                         f"{tuple(weight.shape)}")
    k, k1, k2, cin, cout = weight.shape
    if not (k == k1 == k2 and k in (1, 3)):
        raise ValueError(f"{BF16}: kernel must be 1^3 or 3^3, got "
                         f"{tuple(weight.shape[:3])}")
    if x.shape[-1] != cin or tuple(bias.shape) != (cout,):
        raise ValueError(f"{BF16}: channel mismatch: x {tuple(x.shape)}, "
                         f"weight {tuple(weight.shape)}, bias "
                         f"{tuple(bias.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{BF16}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if weight.dtype != torch.bfloat16 or bias.dtype != torch.bfloat16:
        raise TypeError(f"{BF16}: weight and bias must be bfloat16, got "
                        f"{weight.dtype} and {bias.dtype}")
    tensors = [x, weight, bias]
    if residual is not None:
        if tuple(residual.shape) != tuple(x.shape[:4]) + (cout,):
            raise ValueError(f"{BF16}: residual {tuple(residual.shape)} "
                             f"does not match the output "
                             f"{tuple(x.shape[:4])}+{cout}")
        if residual.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{BF16}: residual must be float32 or "
                            f"bfloat16, got {residual.dtype}")
        tensors.append(residual)
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{BF16}: tensors on {t.device} and {x.device}")
    return tensors


def conv3d_ndhwc_bf16(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, *, pre_relu: bool = False,
                      post_relu: bool = False,
                      residual: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """K15. CPU tensors take the plain version; CUDA tensors the kernel.
    Arguments and result as conv3d_ndhwc_bf16_plain's."""
    tensors = _check_bf16(x, weight, bias, residual)
    if x.device.type == "cpu":
        return conv3d_ndhwc_bf16_plain(x, weight, bias, pre_relu=pre_relu,
                                       post_relu=post_relu,
                                       residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"{BF16}: unsupported device {x.device}")
    n, d, h, w, cin = x.shape
    k, cout = weight.shape[0], weight.shape[-1]
    if k == 3 and (cin, cout) not in BF16_SHAPES:
        raise ValueError(f"{BF16}: the 3^3 kernel takes (Cin, Cout) in "
                         f"{BF16_SHAPES}, got ({cin}, {cout})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{BF16} takes contiguous tensors")
    if k == 3 and (x.data_ptr() % 16 or weight.data_ptr() % 16):
        raise ValueError(f"{BF16}: the 3^3 kernel stages x and weight in "
                         f"16-byte vectors; they must be 16-byte aligned")
    out_f32 = residual is not None and residual.dtype == torch.float32
    y = torch.empty((n, d, h, w, cout), device=x.device,
                    dtype=torch.float32 if out_f32 else torch.bfloat16)
    err = _build.lib().ffn_conv3d_ndhwc_bf16(
        x.data_ptr(), int(x.dtype == torch.float32), weight.data_ptr(),
        bias.data_ptr(), residual.data_ptr() if residual is not None
        else None, y.data_ptr(), n, d, h, w, cin, cout, k, int(pre_relu),
        int(post_relu), int(out_f32),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, BF16)
    _build.launches[BF16] += 1
    return y


# -- K9 and K10: the layer's backward --------------------------------------

DGRAD = "conv3d_dgrad_f32"
WGRAD = "conv3d_wgrad_f32"
WGRAD_ROWS = 32   # K10: output rows (n, z, y) per chunk of its first stage


def _masked(dy: torch.Tensor, y: Optional[torch.Tensor]) -> torch.Tensor:
    """g = dy * [y > 0] (post_relu's gradient; 0 at 0), or dy."""
    if y is None:
        return dy
    return torch.where(y > 0, dy, torch.zeros((), dtype=dy.dtype,
                                              device=dy.device))


def conv3d_dgrad_plain(dy: torch.Tensor, weight: torch.Tensor, *,
                       x: Optional[torch.Tensor] = None,
                       y: Optional[torch.Tensor] = None,
                       accum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The input gradient of a K1 layer, NDHWC: `x` (the forward input)
    masks it where the layer had pre_relu, `y` (its output) masks dy where
    it had post_relu; `accum`, the input's other gradient, is added."""
    g = _masked(dy, y).permute(0, 4, 1, 2, 3)
    k, cin = weight.shape[0], weight.shape[3]
    shape = (dy.shape[0], cin) + tuple(dy.shape[1:4])
    dx = torch.nn.grad.conv3d_input(shape, weight.permute(4, 3, 0, 1, 2), g,
                                    padding=k // 2).permute(0, 2, 3, 4, 1)
    if x is not None:
        dx = torch.where(x > 0, dx, torch.zeros((), dtype=dx.dtype,
                                                device=dx.device))
    if accum is not None:
        dx = dx + accum
    return dx.contiguous()


def conv3d_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, k: int, *,
                       pre_relu: bool = False,
                       y: Optional[torch.Tensor] = None):
    """(dW (k,k,k,Cin,Cout), db (Cout,)) of a K1 layer; arguments as
    conv3d_dgrad_plain's."""
    g = _masked(dy, y)
    xr = torch.relu(x) if pre_relu else x
    cin, cout = x.shape[-1], dy.shape[-1]
    dw = torch.nn.grad.conv3d_weight(
        xr.permute(0, 4, 1, 2, 3), (cout, cin, k, k, k),
        g.permute(0, 4, 1, 2, 3), padding=k // 2)
    return (dw.permute(2, 3, 4, 1, 0).contiguous(),
            g.sum(dim=(0, 1, 2, 3)))


def _check_dgrad(name, dy, weight, x, y, accum):
    if dy.dim() != 5 or weight.dim() != 5 or dy.shape[-1] != weight.shape[-1]:
        raise ValueError(f"{name}: want dy (N,D,H,W,Cout) and weight "
                         f"(k,k,k,Cin,Cout), got {tuple(dy.shape)} and "
                         f"{tuple(weight.shape)}")
    k = weight.shape[0]
    if tuple(weight.shape[:3]) != (k, k, k) or k not in (1, 3):
        raise ValueError(f"{name}: kernel must be 1^3 or 3^3")
    tensors = [dy, weight]
    if x is not None:
        if tuple(x.shape) != tuple(dy.shape[:4]) + (weight.shape[3],):
            raise ValueError(f"{name}: x {tuple(x.shape)} does not match")
        tensors.append(x)
    if y is not None:
        if y.shape != dy.shape:
            raise ValueError(f"{name}: y {tuple(y.shape)} is not dy's shape")
        tensors.append(y)
    if accum is not None:
        if tuple(accum.shape) != tuple(dy.shape[:4]) + (weight.shape[3],):
            raise ValueError(f"{name}: accum {tuple(accum.shape)} is not "
                             f"dx's shape")
        tensors.append(accum)
    for t in tensors:
        if t.device != dy.device:
            raise ValueError(f"{name}: tensors on {t.device} and {dy.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {t.dtype}")
    if dy.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dy.device}")
    if dy.device.type == "cuda" and not all(t.is_contiguous()
                                            for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def conv3d_dgrad_f32(dy: torch.Tensor, weight: torch.Tensor, *,
                     x: Optional[torch.Tensor] = None,
                     y: Optional[torch.Tensor] = None,
                     accum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K9. CPU tensors take the plain version; CUDA tensors the kernel."""
    _check_dgrad(DGRAD, dy, weight, x, y, accum)
    if dy.device.type == "cpu":
        return conv3d_dgrad_plain(dy, weight, x=x, y=y, accum=accum)
    n, d, h, w, cout = dy.shape
    k, cin = weight.shape[0], weight.shape[3]
    dx = torch.empty((n, d, h, w, cin), device=dy.device,
                     dtype=torch.float32)
    err = _build.lib().ffn_conv3d_dgrad_f32(
        dy.data_ptr(), y.data_ptr() if y is not None else None,
        x.data_ptr() if x is not None else None, weight.data_ptr(),
        accum.data_ptr() if accum is not None else None, dx.data_ptr(), n,
        d, h, w, cin, cout, k,
        torch.cuda.current_stream(dy.device).cuda_stream)
    _build.check(err, DGRAD)
    _build.launches[DGRAD] += 1
    return dx


def conv3d_wgrad_f32(x: torch.Tensor, dy: torch.Tensor, k: int, *,
                     pre_relu: bool = False,
                     y: Optional[torch.Tensor] = None):
    """K10: (dW, db). Deterministic on the card (no float atomics)."""
    if x.dim() != 5 or dy.dim() != 5 or tuple(x.shape[:4]) != tuple(
            dy.shape[:4]) or k not in (1, 3):
        raise ValueError(f"{WGRAD}: want x (N,D,H,W,Cin), dy (N,D,H,W,Cout) "
                         f"and k 1 or 3, got {tuple(x.shape)}, "
                         f"{tuple(dy.shape)}, {k}")
    cin, cout = x.shape[-1], dy.shape[-1]
    if ((cin + 3) // 4) * ((cout + 3) // 4) > 256 or cout > 256:
        raise ValueError(f"{WGRAD}: at most 64x64 channels, got "
                         f"{cin}x{cout}")
    tensors = (x, dy) + ((y,) if y is not None else ())
    if y is not None and y.shape != dy.shape:
        raise ValueError(f"{WGRAD}: y {tuple(y.shape)} is not dy's shape")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{WGRAD}: tensors on {t.device} and {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{WGRAD} takes float32, got {t.dtype}")
    if x.device.type == "cpu":
        return conv3d_wgrad_plain(x, dy, k, pre_relu=pre_relu, y=y)
    if x.device.type != "cuda":
        raise ValueError(f"{WGRAD}: unsupported device {x.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{WGRAD} takes contiguous tensors")
    n, d, h, w, _ = x.shape
    chunks = -(-(n * d * h) // WGRAD_ROWS)
    partial = torch.empty((chunks, k ** 3 * cin * cout + cout),
                          device=x.device, dtype=torch.float32)
    dw = torch.empty((k, k, k, cin, cout), device=x.device,
                     dtype=torch.float32)
    db = torch.empty((cout,), device=x.device, dtype=torch.float32)
    err = _build.lib().ffn_conv3d_wgrad_f32(
        x.data_ptr(), dy.data_ptr(), y.data_ptr() if y is not None else None,
        partial.data_ptr(), dw.data_ptr(), db.data_ptr(), n, d, h, w, cin,
        cout, k, int(pre_relu), WGRAD_ROWS,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, WGRAD)
    _build.launches[WGRAD] += 1
    return dw, db


class Conv3dFunction(torch.autograd.Function):
    """One K1 layer with its backward on K9 (input) and K10 (weight, bias).

    forward(x, weight, bias, residual, pre_relu, post_relu) is K1 with the
    same flags. The residual's gradient is dy itself. The input gradient is
    computed only where autograd asks for it (conv0_a's input, the image and
    the stop-gradient seed, asks for none). post_relu with a residual is
    refused: the relu mask is read from the saved output, which a residual
    would change (the model never combines them).
    """

    @staticmethod
    def forward(ctx, x, weight, bias, residual, pre_relu, post_relu):
        if post_relu and residual is not None:
            raise ValueError("Conv3dFunction: post_relu with a residual has "
                             "no gradient here")
        y = conv3d_ndhwc_f32(x, weight, bias, pre_relu=pre_relu,
                             post_relu=post_relu, residual=residual)
        ctx.pre_relu, ctx.post_relu = pre_relu, post_relu
        ctx.save_for_backward(x, weight, y if post_relu else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, y = ctx.saved_tensors
        dy = dy.contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_dgrad_f32(dy, weight,
                                  x=x if ctx.pre_relu else None, y=y)
        dw, db = conv3d_wgrad_f32(x, dy, weight.shape[0],
                                  pre_relu=ctx.pre_relu, y=y)
        dres = dy if ctx.needs_input_grad[3] else None
        return dx, dw, db, dres, None, None


def conv3d_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 *, pre_relu: bool = False, post_relu: bool = False,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1 under autograd, its backward on K9 and K10 (Conv3dFunction)."""
    return Conv3dFunction.apply(x, weight, bias, residual, pre_relu,
                                post_relu)


class ResidualBlockFunction(torch.autograd.Function):
    """A pre-activation residual block of the stack, `x + conv_b(relu(
    conv_a(relu(x))))`, as two K1 launches, with its backward on K9 and K10.

    The block's input takes two gradients, dy through the residual add and
    conv_a's input gradient; K9 adds the first in its epilogue, so autograd
    sums nothing.
    """

    @staticmethod
    def forward(ctx, x, wa, ba, wb, bb):
        a = conv3d_ndhwc_f32(x, wa, ba, pre_relu=True, post_relu=True)
        ctx.save_for_backward(x, a, wa, wb)
        return conv3d_ndhwc_f32(a, wb, bb, residual=x)

    @staticmethod
    def backward(ctx, dy):
        x, a, wa, wb = ctx.saved_tensors
        dy = dy.contiguous()
        dwb, dbb = conv3d_wgrad_f32(a, dy, wb.shape[0])
        da = conv3d_dgrad_f32(dy, wb)
        dwa, dba = conv3d_wgrad_f32(x, da, wa.shape[0], pre_relu=True, y=a)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_dgrad_f32(da, wa, x=x, y=a, accum=dy)
        return dx, dwa, dba, dwb, dbb


def residual_block_train(x, wa, ba, wb, bb):
    """A residual block under autograd (ResidualBlockFunction)."""
    return ResidualBlockFunction.apply(x, wa, ba, wb, bb)


def residual_block_plain(x, wa, ba, wb, bb):
    """The same block as plain K1 layers (autograd of torch ops)."""
    a = conv3d_ndhwc_plain(x, wa, ba, pre_relu=True, post_relu=True)
    return conv3d_ndhwc_plain(a, wb, bb, residual=x)
