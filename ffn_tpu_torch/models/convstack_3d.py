"""The residual 3D conv-stack FFN models in PyTorch.

Counterpart of ffn_tpu/models/convstack_3d.py. ConvStack3D: conv0_a (+relu)
-> conv0_b -> depth-1 pre-activation residual blocks -> relu -> 1x1x1
conv_lom, added to the input seed. Each layer is one conv kernel call with
its relus and residual fused (ops/conv3d.py): K1 in float32, K15 in
bfloat16/float16. With grad enabled (`train_apply`) float32 layers and
blocks run `Conv3dFunction`/`ResidualBlockFunction` (K1; K9, K10 backward),
16-bit ones `Conv16Function`/`ResidualBlock16Function` (K15; K17, K18),
which round the float32 parameters at every call as flax does. Layout is
JAX's (NDHWC activations, DHWIO weights). float32 runs at the JAX model's
Precision.HIGHEST (no TF32); 16 bits are flax's `dtype`: 16-bit
activations, weights and biases, float32 sums and logits. The Runner
refuses float16 models (ROADMAP.md); --precision f16 trains them. int8
inference (Runner precision "int8") wraps this model in ops/quantized.py's
QuantizedConvStack3DModel (K19, K20).

ResConvStack: the deeper pre-activation stack (depth 20) with a LayerNorm
over channels (K21, ops/layernorm.py) before each block's relu, on the
same layers. Forward only; as in the JAX package no FFN wrapper, Runner
or CLI builds it.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import torch
from torch import nn

from ffn_tpu_torch.models import model_info as model_info_lib
from ffn_tpu_torch.models import params_io
from ffn_tpu_torch.ops.conv3d import (conv16_train, conv3d_ndhwc_bf16,
                                      conv3d_ndhwc_f32, conv3d_train,
                                      residual_block16_train,
                                      residual_block_train)
from ffn_tpu_torch.ops.layernorm import layernorm_channels

_DTYPES = {"float32": torch.float32, torch.float32: torch.float32,
           "bfloat16": torch.bfloat16, torch.bfloat16: torch.bfloat16,
           "float16": torch.float16, torch.float16: torch.float16}


class Conv3d(nn.Module):
    """SAME 3D convolution; weight (k, k, k, Cin, Cout), NDHWC activations.

    The parameters are float32. In bfloat16 or float16 (`compute_dtype`)
    the layer's inference computes with 16-bit copies of them, which are
    not in the state_dict and are rounded anew by `round_params` after a
    load; training rounds them at every call.
    """

    def __init__(self, in_features: int, out_features: int, kernel: int = 3,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            kernel, kernel, kernel, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        # The JAX package's init: TruncatedNormal(stddev=0.01) at 2 sigma.
        nn.init.trunc_normal_(self.weight, std=0.01, a=-0.02, b=0.02)
        self.compute_dtype = compute_dtype
        if compute_dtype != torch.float32:
            self.register_buffer("weight16", torch.empty(
                self.weight.shape, dtype=compute_dtype), persistent=False)
            self.register_buffer("bias16", torch.empty(
                self.bias.shape, dtype=compute_dtype), persistent=False)
            self.round_params()

    @torch.no_grad()
    def round_params(self):
        """The 16-bit copies, rounded to nearest even: what flax's 16-bit
        Conv computes with, rounding its float32 parameters at every call."""
        self.weight16.copy_(self.weight)
        self.bias16.copy_(self.bias)

    def forward(self, x, *, pre_relu=False, post_relu=False, residual=None):
        kw = dict(pre_relu=pre_relu, post_relu=post_relu, residual=residual)
        if self.compute_dtype != torch.float32:
            if torch.is_grad_enabled():
                return conv16_train(x, self.weight, self.bias,
                                    self.compute_dtype, **kw)
            return conv3d_ndhwc_bf16(x, self.weight16, self.bias16, **kw)
        conv = conv3d_train if torch.is_grad_enabled() else conv3d_ndhwc_f32
        return conv(x, self.weight, self.bias, pre_relu=pre_relu,
                    post_relu=post_relu, residual=residual)


class ConvStack3D(nn.Module):
    """The conv stack computing the seed (POM) logit update.

    Input (N, z, y, x, 2): image and seed channels. Output (N, z, y, x, 1):
    the update, plus `residual` when one is given.
    """

    def __init__(self, depth: int = 9,
                 features: Union[int, Sequence[int]] = 32,
                 in_features: int = 2,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        feats = [features] * (2 * depth) if isinstance(features, int) \
            else list(features)
        self.depth = depth
        self.compute_dtype = compute_dtype
        conv = functools.partial(Conv3d, compute_dtype=compute_dtype)
        self.conv0_a = conv(in_features, feats[0])
        self.conv0_b = conv(feats[0], feats[1])
        for i in range(1, depth):
            self.add_module(f"conv{i}_a", conv(feats[2 * i - 1],
                                               feats[2 * i]))
            self.add_module(f"conv{i}_b", conv(feats[2 * i],
                                               feats[2 * i + 1]))
        self.conv_lom = conv(feats[2 * depth - 1], 1, kernel=1)

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        net = self.conv0_a(x, post_relu=True)
        net = self.conv0_b(net)
        for i in range(1, self.depth):
            conv_a, conv_b = (getattr(self, f"conv{i}_a"),
                              getattr(self, f"conv{i}_b"))
            if torch.is_grad_enabled():
                params = (net, conv_a.weight, conv_a.bias, conv_b.weight,
                          conv_b.bias)
                net = (residual_block_train(*params)
                       if self.compute_dtype == torch.float32 else
                       residual_block16_train(*params, self.compute_dtype))
                continue
            block_in = net
            net = conv_a(net, pre_relu=True, post_relu=True)
            net = conv_b(net, residual=block_in)
        return self.conv_lom(net, pre_relu=True, residual=residual)


class LayerNorm(nn.Module):
    """flax's nn.LayerNorm over the channel axis (eps 1e-6): float32
    `scale` and `bias`, output in the input's type (K21)."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm_channels(x, self.scale, self.bias)


class ResConvStack(nn.Module):
    """The JAX package's ResConvStack: conv0_a (+relu) -> conv0_b ->
    depth-1 blocks [ln{i} (with use_layernorm) -> relu -> conv{i}_a ->
    relu -> conv{i}_b -> + block input] -> relu -> 1x1x1 conv_lom; float32
    logits. Input (N, z, y, x, in_features), output (N, z, y, x, 1)."""

    def __init__(self, depth: int = 20, features: int = 32,
                 use_layernorm: bool = True, in_features: int = 2,
                 compute_dtype="float32"):
        super().__init__()
        if compute_dtype not in _DTYPES:
            raise NotImplementedError(
                f"dtype {compute_dtype!r}: ResConvStack runs in float32, "
                f"bfloat16 or float16")
        self.depth = depth
        self.use_layernorm = use_layernorm
        self.compute_dtype = _DTYPES[compute_dtype]
        conv = functools.partial(Conv3d, compute_dtype=self.compute_dtype)
        self.conv0_a = conv(in_features, features)
        self.conv0_b = conv(features, features)
        for i in range(1, depth):
            if use_layernorm:
                self.add_module(f"ln{i}", LayerNorm(features))
            self.add_module(f"conv{i}_a", conv(features, features))
            self.add_module(f"conv{i}_b", conv(features, features))
        self.conv_lom = conv(features, 1, kernel=1)

    def load_params(self, params):
        """Loads JAX parameters (flat npz dict or flax tree) and rounds the
        16-bit layers' copies."""
        self.load_state_dict(params_io.convert_params(params))
        self.round_params()

    def round_params(self):
        if self.compute_dtype != torch.float32:
            for layer in self.children():
                if isinstance(layer, Conv3d):
                    layer.round_params()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "ResConvStack is forward only: no trainer of either package "
                "builds it (run it under torch.no_grad())")
        net = self.conv0_a(x.float(), post_relu=True)
        net = self.conv0_b(net)
        for i in range(1, self.depth):
            block_in = net
            if self.use_layernorm:
                net = getattr(self, f"ln{i}")(net)
            net = getattr(self, f"conv{i}_a")(net, pre_relu=True,
                                              post_relu=True)
            net = getattr(self, f"conv{i}_b")(net, residual=block_in)
        return self.conv_lom(net, pre_relu=True).float()


class ConvStack3DFFNModel(nn.Module):
    """FFN model: geometry plus `apply(image, seed) -> updated seed`.

    Takes the same `model_args` JSON as the JAX package's
    ConvStack3DFFNModel: `dtype` "float32", "bfloat16" or "float16" (or
    the torch dtype). `precision` is accepted and ignored: float32 always runs at
    Precision.HIGHEST, and the products of bfloat16 values are exact in
    float32 at any precision.
    """

    dim = 3

    def __init__(self, fov_size=None, deltas=None, batch_size=None,
                 depth: int = 9, features=32, dtype="float32", precision=None,
                 **kwargs):
        super().__init__()
        del precision, kwargs
        if dtype not in _DTYPES:
            raise NotImplementedError(
                f"dtype {dtype!r}: ffn_tpu_torch runs the conv stack in "
                f"float32, bfloat16 or float16 (ROADMAP.md)")
        self.dtype = _DTYPES[dtype]
        self.info = model_info_lib.ModelInfo(
            deltas=deltas, pred_mask_size=fov_size, input_seed_size=fov_size,
            input_image_size=fov_size, additive=True)
        self.batch_size = batch_size
        self.depth = depth
        self.features = features
        self.module = ConvStack3D(depth=depth, features=features,
                                  compute_dtype=self.dtype)

    def load_params(self, params):
        """Loads JAX parameters (flat npz dict or flax tree); in 16 bits
        also rounds the layers' copies."""
        self.module.load_state_dict(params_io.convert_params(params))
        self.round_params()

    def round_params(self):
        """Rounds the 16-bit layers' copies of the parameters anew: `apply`
        calls it after `train_apply` has run (the parameters may have moved
        since the copies were made)."""
        self._rounded = True
        if self.dtype != torch.float32:
            for layer in self.module.children():
                layer.round_params()

    @torch.no_grad()
    def apply(self, image: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
        """One FFN step on (B, z, y, x, 1) patches: seed + predicted update.

        The addition is fused into conv_lom as its residual.
        """
        if not getattr(self, "_rounded", True):
            self.round_params()
        net = torch.cat([image, seed.to(image.dtype)], dim=-1)
        return self.module(net, residual=seed)

    def train_apply(self, net: torch.Tensor,
                    seed: torch.Tensor) -> torch.Tensor:
        """The differentiable step of training: `net` (B, z, y, x, 2) is the
        image and seed channels, already joined (K11's train_gather fuses
        the concatenation), `seed` (B, z, y, x, 1) the seed patch added to
        the update. Gradients reach the parameters only: the seed is
        stop-gradient-ed, as in the JAX scan body. In 16 bits the float32
        parameters are rounded at every call, as flax casts them."""
        self._rounded = False
        with torch.enable_grad():
            return self.module(net, residual=seed)

    def save_params(self, path: str):
        """Writes the weights as the JAX package's flat npz (params_io)."""
        params_io.save_params_npz(self.module, path)
