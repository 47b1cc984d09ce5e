"""The residual 3D conv-stack FFN model in PyTorch.

Counterpart of ffn_tpu/models/convstack_3d.py (ConvStack3D and
ConvStack3DFFNModel): conv0_a (+relu) -> conv0_b -> depth-1 pre-activation
residual blocks -> relu -> 1x1x1 conv_lom, whose output is added to the
input seed. Every layer is one call of the K1 conv kernel
(ffn_tpu_torch.ops.conv3d) with its relus and residual add fused. With
grad enabled (training, `train_apply`) a layer goes through
`Conv3dFunction` and a residual block through `ResidualBlockFunction`:
K1 forward, K9 and K10 backward.

Layout is the JAX package's: activations channels-last (N, z, y, x, C) and
weights DHWIO, so JAX checkpoints load without a transpose (params_io).
Arithmetic is float32 throughout, the precision of the JAX model's default
Precision.HIGHEST; the kernel uses no TF32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ffn_tpu_torch.models import model_info as model_info_lib
from ffn_tpu_torch.models import params_io
from ffn_tpu_torch.ops.conv3d import (conv3d_ndhwc_f32, conv3d_train,
                                      residual_block_train)


class Conv3d(nn.Module):
    """SAME 3D convolution; weight (k, k, k, Cin, Cout), NDHWC activations."""

    def __init__(self, in_features: int, out_features: int, kernel: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            kernel, kernel, kernel, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        # The JAX package's init: TruncatedNormal(stddev=0.01) at 2 sigma.
        nn.init.trunc_normal_(self.weight, std=0.01, a=-0.02, b=0.02)

    def forward(self, x, *, pre_relu=False, post_relu=False, residual=None):
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
                 in_features: int = 2):
        super().__init__()
        feats = [features] * (2 * depth) if isinstance(features, int) \
            else list(features)
        self.depth = depth
        self.conv0_a = Conv3d(in_features, feats[0])
        self.conv0_b = Conv3d(feats[0], feats[1])
        for i in range(1, depth):
            self.add_module(f"conv{i}_a", Conv3d(feats[2 * i - 1],
                                                 feats[2 * i]))
            self.add_module(f"conv{i}_b", Conv3d(feats[2 * i],
                                                 feats[2 * i + 1]))
        self.conv_lom = Conv3d(feats[2 * depth - 1], 1, kernel=1)

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        net = self.conv0_a(x, post_relu=True)
        net = self.conv0_b(net)
        for i in range(1, self.depth):
            conv_a, conv_b = (getattr(self, f"conv{i}_a"),
                              getattr(self, f"conv{i}_b"))
            if torch.is_grad_enabled():
                net = residual_block_train(net, conv_a.weight, conv_a.bias,
                                           conv_b.weight, conv_b.bias)
                continue
            block_in = net
            net = conv_a(net, pre_relu=True, post_relu=True)
            net = conv_b(net, residual=block_in)
        return self.conv_lom(net, pre_relu=True, residual=residual)


class ConvStack3DFFNModel(nn.Module):
    """FFN model: geometry plus `apply(image, seed) -> updated seed`.

    Takes the same `model_args` JSON as the JAX package's
    ConvStack3DFFNModel. Only float32 is ported.
    """

    dim = 3

    def __init__(self, fov_size=None, deltas=None, batch_size=None,
                 depth: int = 9, features=32, dtype="float32", **kwargs):
        super().__init__()
        del kwargs
        if dtype not in ("float32", torch.float32):
            raise NotImplementedError(
                f"dtype {dtype!r}: ffn_tpu_torch runs the conv stack in "
                f"float32 only (ROADMAP.md, reduced-precision inference)")
        self.info = model_info_lib.ModelInfo(
            deltas=deltas, pred_mask_size=fov_size, input_seed_size=fov_size,
            input_image_size=fov_size, additive=True)
        self.batch_size = batch_size
        self.depth = depth
        self.features = features
        self.module = ConvStack3D(depth=depth, features=features)

    def load_params(self, params):
        """Loads JAX parameters (flat npz dict or flax tree)."""
        self.module.load_state_dict(params_io.convert_params(params))

    @torch.no_grad()
    def apply(self, image: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
        """One FFN step on (B, z, y, x, 1) patches: seed + predicted update.

        The addition is fused into conv_lom as its residual.
        """
        net = torch.cat([image, seed.to(image.dtype)], dim=-1)
        return self.module(net, residual=seed)

    def train_apply(self, net: torch.Tensor,
                    seed: torch.Tensor) -> torch.Tensor:
        """The differentiable step of training: `net` (B, z, y, x, 2) is the
        image and seed channels, already joined (K11's train_gather fuses
        the concatenation), `seed` (B, z, y, x, 1) the seed patch added to
        the update. Gradients reach the parameters only: the seed is
        stop-gradient-ed, as in the JAX scan body."""
        with torch.enable_grad():
            return self.module(net, residual=seed)

    def save_params(self, path: str):
        """Writes the weights as the JAX package's flat npz (params_io)."""
        params_io.save_params_npz(self.module, path)
