"""How K15 (conv3d_ndhwc_bf16, also in float16) is held to its plain version
and to the exact sum, and K17 (conv3d_dgrad_16) to its plain version;
shared by the tests, chip_smoke.py and tools_torch/.

A sum taken in another float32 order can round to the neighbouring 16-bit
value, so a layer is held to one ulp per rounding it makes
(`k15_tolerance`) and its differing outputs to `DIFFER_SHARE`; the second
limit catches a kernel that rounds once, r(acc + b), instead of flax's
r(r(acc) + b) (0.12-0.34 of outputs differ). K15 rounds as the exact sum
would, so on the card it is also held to `conv3d_ndhwc_bf16_exact` (the
layer with float64 sums) bit for bit.
"""

import itertools

import torch
import torch.nn.functional as F

from ffn_tpu_torch.ops.conv3d import (conv3d_dgrad_16_plain,
                                      conv3d_dgrad_plain,
                                      conv3d_ndhwc_bf16_plain)

# The layer kinds of the bfloat16 stack at 32 features (model-r2) and 16
# (the CI checkpoint): (k, Cin, Cout, pre_relu, post_relu, residual dtype or
# None, input dtype).
K15_CASES = {
    "conv0_a": (3, 2, 32, False, True, None, torch.float32),
    "conv0_b": (3, 32, 32, False, False, None, torch.bfloat16),
    "block_a": (3, 32, 32, True, True, None, torch.bfloat16),
    "block_b": (3, 32, 32, False, False, torch.bfloat16, torch.bfloat16),
    "conv_lom": (1, 32, 1, True, False, torch.float32, torch.bfloat16),
    "ci_conv0_a": (3, 2, 16, False, True, None, torch.float32),
    "ci_block_b": (3, 16, 16, False, False, torch.bfloat16, torch.bfloat16),
    "ci_conv_lom": (1, 16, 1, True, False, torch.float32, torch.bfloat16),
}

# Largest share of a layer's outputs that may differ from the plain version
# computed on the same device: 2-3e-5 measured on the H100 for every layer
# kind, about 0.24 for a kernel that rounds once (PERF.md).
DIFFER_SHARE = 1e-3


def bf16_ulp(t, dtype=torch.bfloat16):
    """The spacing of bfloat16 values (8 significant bits; float16: 11) at
    |t|, at least that of its smallest normal."""
    bits, tiny = (11, 2.0 ** -14) if dtype == torch.float16 else (8,
                                                                 2.0 ** -126)
    m = t.abs().float().clamp_min(tiny)
    return torch.ldexp(torch.ones_like(m), torch.frexp(m)[1] - bits)


def k15_inputs(gen, n, shape, case, dtype=torch.bfloat16):
    """Random inputs of a K15_CASES layer on `gen`'s device, 16-bit values
    of `dtype`."""
    k, cin, cout, _, _, rdt, xdt = K15_CASES[case]
    rdt = dtype if rdt == torch.bfloat16 else rdt
    xdt = dtype if xdt == torch.bfloat16 else xdt

    def randn(*size, scale=1.0):
        return torch.randn(*size, generator=gen, device=gen.device) * scale

    x = randn(n, *shape, cin).to(xdt)
    w = randn(k, k, k, cin, cout,
              scale=(2.0 / (k ** 3 * cin)) ** 0.5).to(dtype)
    b = randn(cout, scale=0.1).to(dtype)
    r = None if rdt is None else randn(n, *shape, cout).to(rdt)
    return x, w, b, r


def k15_tolerance(x, w, b, *, pre_relu=False, post_relu=False,
                  residual=None):
    """Per output, how far a bfloat16 layer may lie from its plain version
    when only its float32 sums run in another order: one bfloat16 ulp for
    each rounding the layer makes, at the scale of the value it rounds. The
    sum can round to the neighbouring bfloat16 value; the bias add then
    rounds again, and a step the sum took can meet a tie there and become
    two; a bfloat16 residual rounds a third time; a float32 residual
    (conv_lom plus the seed) adds one float32 rounding. In float16 a
    float32 order's own error (up to ~2^-20 of the sum of |x||w|, as
    tools_torch/k15_variants.py measures tensor-core orders) can exceed
    an ulp of a sum that cancels: that much is added."""
    plain, dt = conv3d_ndhwc_bf16_plain, w.dtype
    a = plain(x, w, torch.zeros_like(b), pre_relu=pre_relu).float().abs()
    t = torch.maximum(a, plain(x, w, b, pre_relu=pre_relu).float().abs())
    tol = bf16_ulp(a, dt) + bf16_ulp(t, dt)
    if dt == torch.float16:
        tol += conv_sums_f64(x, w, pre_relu=pre_relu,
                             absolute=True).float() * 2.0 ** -20
    del a
    if residual is not None:
        y = plain(x, w, b, pre_relu=pre_relu, post_relu=post_relu,
                  residual=residual).float().abs()
        tol += (bf16_ulp(torch.maximum(t, y), dt)
                if residual.dtype == dt else y * 2.0 ** -23)
    return tol


def k17_tolerance(dy, w, want, *, x=None, y=None, accum=None):
    """Per output, how far K17's input gradient may lie from `want`, its
    plain version on the same inputs: one ulp of the type per rounding (at
    the masked sum s; with `accum` also at the larger of s and the result)
    plus 2^-20 of the sum of |w||g| where the float32 sum cancels."""
    dt = want.dtype
    s = conv3d_dgrad_16_plain(dy, w, x=x, y=y).float().abs()
    mag = conv3d_dgrad_plain(dy.float().abs(), w.float().abs(),
                             y=y.float() if y is not None else None)
    tol = bf16_ulp(s, dt) + mag * 2.0 ** -20
    if accum is not None:
        tol = tol + bf16_ulp(torch.maximum(s, want.float().abs()), dt)
    return tol


def differ_share(got, want):
    """Share of the outputs of `got` that differ from `want`."""
    return float((got.float() != want.float()).float().mean())


def conv_sums_f64(x, w, *, pre_relu=False, absolute=False, chunk=16):
    """The layer's sums over taps and input channels of r(x) * w (r: w's
    type) in float64, by im2col and a float64 matmul, `chunk` samples at a
    time: exact but in rare cases, the products having 16 (bfloat16) or 22
    (float16) significant bits. With `absolute`, the sums of |x| * |w|.
    (N, D, H, W, Cout) float64."""
    k, cout = w.shape[0], w.shape[-1]
    wd = w.double().reshape(-1, cout)
    if absolute:
        wd = wd.abs()
    out = []
    for xs in x.split(chunk):
        xd = xs.to(w.dtype).double()
        if pre_relu:
            xd = torch.relu(xd)
        if absolute:
            xd = xd.abs()
        n, d, h, wi, cin = xs.shape
        if k == 3:
            xp = F.pad(xd, (0, 0, 1, 1, 1, 1, 1, 1))
            xd = torch.stack([xp[:, a:a + d, b:b + h, c:c + wi]
                              for a, b, c in itertools.product(range(3),
                                                               repeat=3)],
                             dim=4)
        out.append((xd.reshape(-1, k ** 3 * cin) @ wd).reshape(
            n, d, h, wi, cout))
        del xd
    return torch.cat(out)


def conv3d_ndhwc_bf16_exact(x, weight, bias, *, pre_relu=False,
                            post_relu=False, residual=None):
    """conv3d_ndhwc_bf16_plain with its sums in float64, rounded to
    float32: the float32 sum nearest the exact one, which K15 gives."""
    dt = weight.dtype
    acc = conv_sums_f64(x, weight, pre_relu=pre_relu).float()
    y = acc.to(dt)
    del acc
    y = (y.float() + bias.float()).to(dt)
    if post_relu:
        y = torch.relu(y)
    if residual is not None:
        if residual.dtype == torch.float32:
            return (y.float() + residual).contiguous()
        y = (y.float() + residual.float()).to(dt)
    return y.contiguous()
