"""int8 quantized inference of the ConvStack3D FFN: K19 `qconv3d_s8` and K20
`act_absmax`, counterparts of ffn_tpu/ops/quantized.py (same names).

Weights: symmetric per-output-channel int8, folded once in numpy as the JAX
package folds them (`fold_convstack_params`), layout (kz·ky·kx·Cin, Cout)
in (kz, ky, kx, cin) order. Activations: symmetric dynamic int8 with ONE
scale PER LANE from the lane's floored abs-max (K20): every JAX engine
applies the model to one patch under `jax.vmap`, so a lane's logits never
depend on the lanes batched beside it. A layer (K19) quantizes `x / scale`
(IEEE division, round half to even, clip ±127), sums int8 × int8 in int32
(exact), and dequantizes in one rounding, `fma(float(acc), s, bias)`; relus
and the residual add stay float32 and round on their own. The scales are
those of XLA's CPU program for the engines' jitted step, which holds the
layers as constants (`lane_scales`). So the plain versions here equal the
JAX package bit for bit, and the kernels equal the plain versions.

On a CUDA tensor each wrapper launches its kernel (`csrc/qconv3d.cu`) or
raises; on a CPU tensor it runs its plain version (`*_plain`), which never
builds the im2col: 27 shifted (M, Cin) @ (Cin, Cout) products, exact on
these integers (`_int_conv`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ffn_tpu_torch import _build
from ffn_tpu_torch.models import params_io

QCONV = "qconv3d_s8"
ABSMAX = "act_absmax"
# (Cin, Cout) pairs of K19's tensor-core kernel (3^3 layers), as K15's: the
# stack's input and inner layers at 32 features (model-r2) and at 16 (the
# CI checkpoint). 1^3 layers take any widths.
QCONV_SHAPES = ((2, 32), (32, 32), (2, 16), (16, 16))
_FLOOR = np.float32(1e-12)   # the JAX package's absmax floor, in float32
C127 = float(np.float32(1) / np.float32(127))   # f32(1/127)


def _quantize_symmetric(w: np.ndarray, axis) -> tuple:
    """Symmetric int8 quantization with per-`axis`-kept scales."""
    reduce_axes = tuple(i for i in range(w.ndim) if i not in axis)
    absmax = np.maximum(np.abs(w).max(axis=reduce_axes, keepdims=True),
                        1e-12)
    scale = (absmax / 127.0).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, scale


def kernel_layout(w_q: torch.Tensor) -> torch.Tensor:
    """K19's resident weights of a 3^3 layer: (Cout, KPAD + 16) int8, row co
    holding w_q[:, co] (K = 27 Cin in (tap, channel) order), zero from K to
    KPAD (K rounded up to k32 steps) and in the 16 bytes that put an
    ldmatrix's 8 rows on distinct banks."""
    k, cout = w_q.shape
    kpad = -(-k // 32) * 32
    w_k = torch.zeros((cout, kpad + 16), dtype=torch.int8,
                      device=w_q.device)
    w_k[:, :k] = w_q.t()
    return w_k


@dataclasses.dataclass(frozen=True)
class QuantizedConv:
    """One conv layer's folded int8 weights, as tensors.

    w_q: (27*Cin, Cout) int8 for 3x3x3 layers / (Cin, Cout) for 1x1x1.
    w_scale: (Cout,) float32 per-output-channel scales.
    bias: (Cout,) float32.
    kernel_zyx: spatial kernel shape.
    w_k: 3x3x3 layers, K19's packing of w_q (kernel_layout), made once when
      the layer is built and moved with it; the plain version reads w_q.
    """
    w_q: torch.Tensor
    w_scale: torch.Tensor
    bias: torch.Tensor
    kernel_zyx: tuple
    w_k: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.w_k is None and tuple(self.kernel_zyx) == (3, 3, 3):
            object.__setattr__(self, "w_k", kernel_layout(self.w_q))

    def to(self, device) -> "QuantizedConv":
        return dataclasses.replace(
            self, w_q=self.w_q.to(device), w_scale=self.w_scale.to(device),
            bias=self.bias.to(device),
            w_k=None if self.w_k is None else self.w_k.to(device))


def fold_convstack_params(params) -> dict:
    """Folds a ConvStack3D flax params tree into int8 layers, as
    ffn_tpu.ops.quantized.fold_convstack_params does."""
    layers = {}
    tree = params["params"] if "params" in params else params
    for name, leaf in tree.items():
        kernel = np.asarray(leaf["kernel"])       # (kz, ky, kx, Cin, Cout)
        bias = np.asarray(leaf["bias"]).astype(np.float32)
        kz, ky, kx, cin, cout = kernel.shape
        w2d = kernel.reshape(kz * ky * kx * cin, cout)
        w_q, w_scale = _quantize_symmetric(w2d, axis=(1,))
        layers[name] = QuantizedConv(
            w_q=torch.from_numpy(w_q), w_scale=torch.from_numpy(w_scale[0]),
            bias=torch.from_numpy(bias), kernel_zyx=(kz, ky, kx))
    return layers


# -- K20: the per-lane activation abs-max -------------------------------------

def act_absmax_plain(x: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """(N,) float32: max(max|relu?(x[n])|, 1e-12) per lane."""
    flat = x.reshape(x.shape[0], -1)
    mag = torch.relu(flat) if relu else flat.abs()
    return torch.amax(mag, dim=1).clamp_min(float(_FLOOR))


# K20's grid (qconv3d.cu): blocks of K20_THREADS threads, K20_LOADS float4
# loads in flight a thread; a lane's blocks read its float4s at a stride of
# blocks * K20_THREADS, its first block also the floats before its first
# 16-byte boundary (head) and after its last float4 (tail).
K20_THREADS, K20_LOADS = 256, 4
H100_SMS = 132


def k20_blocks(per_lane, n, sms=H100_SMS):
    """Blocks a lane (qconv3d.cu's absmax_blocks): one pass of K20_LOADS
    float4s a thread covers the lane, at most about two waves of 8 blocks an
    SM over all n lanes."""
    want = -(-per_lane // (4 * K20_THREADS * K20_LOADS))
    cap = -(-2 * sms * (2048 // K20_THREADS) // n)
    return max(1, min(want, cap))


def k20_reads(per_lane, n, lane, start, sms=H100_SMS):
    """[(block, element indices)] of the reads of lane `lane`, whose first
    float lies `start` floats past a 16-byte boundary: each block's float4s
    in the kernel's loop order (K20_LOADS strides a pass, then one at a
    time), the head and tail floats in the first block's."""
    blocks = k20_blocks(per_lane, n, sms)
    head = min((4 - start % 4) % 4, per_lane)
    nb = (per_lane - head) // 4
    tail = per_lane - head - 4 * nb
    stride = blocks * K20_THREADS
    out = []
    for blk in range(blocks):
        i = blk * K20_THREADS + np.arange(K20_THREADS)
        quads = []
        while True:
            full = i + (K20_LOADS - 1) * stride < nb
            if not full.any():
                break
            quads += [i[full] + u * stride for u in range(K20_LOADS)]
            i = np.where(full, i + K20_LOADS * stride, i)
        while (i < nb).any():
            quads.append(i[i < nb])
            i = i + stride
        q = np.concatenate(quads + [np.zeros(0, np.int64)]).astype(np.int64)
        idx = (head + 4 * q[:, None] + np.arange(4)).ravel()
        if blk == 0:
            idx = np.concatenate([np.arange(head), idx,
                                  head + 4 * nb + np.arange(tail)])
        out.append((blk, idx))
    return out


def act_absmax_model(x: np.ndarray, relu: bool, start: int = 0,
                     sms=H100_SMS) -> np.ndarray:
    """K20's arithmetic in numpy on x (N, per_lane) float32 whose first
    float lies `start` floats past a 16-byte boundary: each block's maximum
    magnitude (relu: v if v > 0 else +0; else |v|) over its reads, the
    lane's the largest of its blocks', floored at 1e-12."""
    n, per_lane = x.shape
    out = np.empty(n, np.float32)
    for lane in range(n):
        mags = np.where(x[lane] > 0, x[lane], np.float32(0)) if relu \
            else np.abs(x[lane])
        best = np.float32(0)
        for _, idx in k20_reads(per_lane, n, lane, start + lane * per_lane,
                                sms):
            if idx.size:
                best = max(best, mags[idx].max())
        out[lane] = max(best, _FLOOR)
    return out


# K20's counters, zeroed once a (device, stream, lane count): the lane's
# last block leaves them zero again, so a call is one launch and no memset.
# Calls on one stream run one after another and never share a buffer at
# once; the port launches K20 on the current stream only.
_ABSMAX_WORK: dict = {}


def _absmax_work(x: torch.Tensor, n: int, stream: int) -> torch.Tensor:
    key = (x.device.index, stream, n)
    work = _ABSMAX_WORK.get(key)
    if work is None:
        work = torch.zeros(2 * n, device=x.device, dtype=torch.int32)
        _ABSMAX_WORK[key] = work
    return work


def act_absmax(x: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """K20. CPU tensors take the plain version; CUDA tensors the kernel,
    one launch a call."""
    if x.dtype != torch.float32 or x.dim() < 2:
        raise TypeError(f"{ABSMAX} takes float32 (N, ...), got {x.dtype} "
                        f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return act_absmax_plain(x, relu)
    if x.device.type != "cuda":
        raise ValueError(f"{ABSMAX}: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{ABSMAX} takes a contiguous tensor")
    n = x.shape[0]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    work = _absmax_work(x, n, stream)
    absmax = torch.empty(n, device=x.device, dtype=torch.float32)
    err = _build.lib().ffn_act_absmax(
        x.data_ptr(), int(relu), work.data_ptr(), absmax.data_ptr(), n,
        x.numel() // n, stream)
    _build.check(err, ABSMAX)
    _build.launches[ABSMAX] += 1
    return absmax


# -- K19: the int8 SAME convolution ------------------------------------------

# K19's 3^3 plan (qconv3d.cu's q_plan): CTAs of K19_WARPS warps, each warp
# taking pairs of m16 tiles (K19_PAIR positions); at most K19_PER_SM CTAs an
# SM, as shared memory allows (K19_SMEM_SM an SM's, 1 KB reserved a CTA).
K19_WARPS, K19_PAIR, K19_PER_SM = 6, 32, 2
K19_SMEM_SM = 233472


def k19_smem(halo_rows, cin, cout):
    """Bytes of a K19 CTA: the packed weights, the halo table (halo_rows
    ints) and four ring slots of halo_rows rows of cin bytes, each rounded
    to 128 bytes."""
    kpad = -(-27 * cin // 32) * 32

    def r128(v):
        return -(-v // 128) * 128
    return cout * (kpad + 16) + r128(4 * halo_rows) + 4 * r128(
        halo_rows * cin)


@dataclasses.dataclass(frozen=True)
class K19Geometry:
    """K19's work items on x (n, d, h, w, cin): item i = ((lane * nseg +
    segment) * bands + band); a band is `band_pos` plane positions q = y
    pitch + x from band * band_pos, its halo `halo_rows` rows from q0 -
    pitch - 1; a segment `seg` planes from segment * seg. CTA b takes items
    b, b + ctas, ..."""
    n: int
    d: int
    h: int
    w: int
    pitch: int
    band_pos: int
    halo_rows: int
    bands: int
    seg: int
    nseg: int
    per_sm: int
    smem: int
    items: int
    ctas: int

    def item(self, i):
        """(lane, q0, z0, z1) of item i: plane positions q0 .. q0 +
        band_pos - 1 of planes z0 .. z1 - 1."""
        b, rest = i % self.bands, i // self.bands
        s, lane = rest % self.nseg, rest // self.nseg
        z0 = s * self.seg
        return lane, b * self.band_pos, z0, min(z0 + self.seg, self.d)

    def voxels(self, i):
        """(lane, zs, ys, xs) of item i's output voxels: its positions that
        lie on the plane (not in the zero columns), on each of its planes;
        as the kernel's epilogue stores them."""
        lane, q0, z0, z1 = self.item(i)
        q = q0 + np.arange(self.band_pos)
        ys, xs = q // self.pitch, q % self.pitch
        keep = (ys < self.h) & (xs < self.w)
        zs = np.repeat(np.arange(z0, z1), keep.sum())
        return (lane, zs, np.tile(ys[keep], z1 - z0),
                np.tile(xs[keep], z1 - z0))

    def halo_voxels(self, q0):
        """The halo rows' voxels (y * w + x, or -1 off the plane and in the
        zero columns) of the band at q0: qconv3d.cu's halo table."""
        q = q0 - self.pitch - 1 + np.arange(self.halo_rows)
        ys, xs = q // self.pitch, q % self.pitch
        ok = (q >= 0) & (q < self.h * self.pitch) & (xs < self.w)
        return np.where(ok, ys * self.w + xs, -1)

    def planes_per_output(self):
        """Planes staged (in the volume or not) per output plane."""
        return (self.d + 2 * self.nseg) / self.d

    def quantized_per_element(self):
        """Quantizations per input element: each item quantizes its halo
        rows' voxels on each of its planes z0 - 1 .. z1 inside the
        volume."""
        total = 0
        for b in range(self.bands):
            rows = int((self.halo_voxels(b * self.band_pos) >= 0).sum())
            for s in range(self.nseg):
                z0 = s * self.seg
                z1 = min(z0 + self.seg, self.d)
                total += rows * (min(z1 + 1, self.d) - max(z0 - 1, 0))
        return total / (self.d * self.h * self.w)


@functools.lru_cache(maxsize=256)
def k19_geometry(n, d, h, w, cin, cout, sms=H100_SMS):
    """K19's plan for x (n, d, h, w, cin) on a card of `sms` SMs (q_plan,
    which the C entry computes once a shape): pitch P = w + 1 rounded up to
    even; bands of K19_PAIR pp positions; for each band count and segment
    count, the cost is the rounds of items over sms * per_sm CTAs, times
    per_sm, times an item's bytes ((L + 2) planes of R rows in, L planes of
    the band's pairs in whole rounds of the warps out); the least cost wins,
    ties to fewer items, among the bands that let K19_PER_SM CTAs share an
    SM (any band where none does). ValueError if no band fits."""
    pitch = (w + 2) // 2 * 2
    pairs = -(-(h * pitch - 1) // K19_PAIR)
    best = None
    for min_per_sm in range(K19_PER_SM, 0, -1):
        if best is None:
            best = _k19_best(n, d, h, w, cin, cout, sms, pitch, pairs,
                             min_per_sm)
    if best is None:
        raise ValueError(f"{QCONV}: rows of {w} voxels do not fit K19's "
                         f"shared memory")
    return best[1]


def _k19_best(n, d, h, w, cin, cout, sms, pitch, pairs, min_per_sm):
    best = None
    for nb in range(1, pairs + 1):
        pp = -(-pairs // nb)
        if -(-pairs // pp) != nb:
            continue
        m = K19_PAIR * pp
        r = m + 2 * pitch + 2
        smem = k19_smem(r, cin, cout)
        per_sm = min(K19_PER_SM, K19_SMEM_SM // (smem + 1024))
        if per_sm < min_per_sm:
            continue
        ctas = sms * per_sm
        m_eff = K19_PAIR * K19_WARPS * -(-pp // K19_WARPS)
        for nseg in range(1, d + 1):
            seg = -(-d // nseg)
            if -(-d // seg) != nseg:
                continue
            items = n * nb * nseg
            cost = float(-(-items // ctas) * per_sm) * (
                float(seg + 2) * r * cin + float(seg) * m_eff * cout)
            if best is None or cost < best[0] or (
                    cost == best[0] and items < best[1].items):
                best = (cost, K19Geometry(n, d, h, w, pitch, m, r, nb, seg,
                                          nseg, per_sm, smem, items, ctas))
    return best


def _int_conv(q: torch.Tensor, w_q: torch.Tensor, k: int) -> torch.Tensor:
    """The exact int32 sums of a SAME conv of integer-valued q (N,D,H,W,Cin)
    with w_q (k^3 Cin, Cout), no im2col: on the zero-padded input's rows,
    one (M, Cin) @ (Cin, Cout) product per tap, each added to the rows it
    shifts to. Every partial sum is an integer of at most k^3 Cin 127^2 in
    magnitude, so float32 is exact below 2^24 (any order); float64 above."""
    n, d, h, w, cin = q.shape
    dt = torch.float32 if k ** 3 * cin * 127 * 127 < 2 ** 24 \
        else torch.float64
    wt = w_q.to(dt).reshape(k ** 3, cin, -1)
    if k == 1:
        return (q.to(dt).reshape(-1, cin) @ wt[0]).reshape(n, d, h, w, -1)
    rows = F.pad(q.to(dt), (0, 0, 1, 1, 1, 1, 1, 1)).reshape(-1, cin)
    sy, sz = w + 2, (h + 2) * (w + 2)
    m0 = sz + sy + 1   # the largest shift: rows past it are padding
    acc = torch.empty(rows.shape[0], wt.shape[-1], dtype=dt,
                      device=q.device)
    inner = acc[m0:rows.shape[0] - m0]
    for t in range(27):
        off = m0 + (t // 9 - 1) * sz + (t // 3 % 3 - 1) * sy + t % 3 - 1
        if t == 0:
            torch.mm(rows[off:off + inner.shape[0]], wt[t], out=inner)
        else:
            inner.addmm_(rows[off:off + inner.shape[0]], wt[t])
    return acc.reshape(n, d + 2, h + 2, w + 2, -1)[:, 1:-1, 1:-1, 1:-1]


def fma_f32(a: torch.Tensor, s: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """float32(a * s + b) with one rounding, as a fused multiply-add, for
    integer-valued `a` (|a| < 2^24) and float32 s, b: a * s is exact in
    float64 and a * s + b rounds there once, to t; where t lies on a float32
    tie (its 29 low mantissa bits 1 then 28 zeros) and was rounded, it
    moves one float64 step towards the exact sum (TwoSum's error term).
    Ties are rare, so they are fixed where they lie."""
    p = a.double() * s.double()
    t = p + b.double()
    ties = torch.nonzero(
        (t.view(torch.int64) & 0x1FFFFFFF).view(-1) == 0x10000000)[:, 0]
    if len(ties):
        pt, tt = p.view(-1)[ties], t.view(-1)[ties]
        bt = b.double()[ties % b.numel()]
        bv = tt - pt
        err = (pt - (tt - bv)) + (bt - bv)
        towards = torch.copysign(torch.full_like(tt, float("inf")), err)
        t.view(-1)[ties] = torch.where(err != 0, torch.nextafter(tt, towards),
                                       tt)
    return t.float()


def lane_scales(layer: QuantizedConv, absmax: torch.Tensor):
    """(activation scale (N,), dequantize scale (N, Cout)) from each lane's
    floored abs-max, as XLA's CPU program folds the constants: `/ 127`
    becomes `* f32(1/127)`, and for Cout = 1 (conv_lom) the two constant
    factors fold first, `absmax * f32(f32(1/127) * w_scale)`."""
    scale = absmax * C127
    if layer.w_scale.numel() == 1:
        return scale, absmax[:, None] * (C127 * layer.w_scale)
    return scale, scale[:, None] * layer.w_scale


def qconv3d_plain(x: torch.Tensor, layer: QuantizedConv,
                  absmax: torch.Tensor, *, relu_in: bool = False,
                  relu_out: bool = False,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ffn_tpu.ops.quantized.qconv3d of each lane with its own abs-max:
    q = clip(round(relu?(x) / scale), ±127), acc = q (*) w_q exactly,
    y = fma(acc, s, bias) (lane_scales), relu?(y), + residual."""
    if relu_in:
        x = torch.relu(x)
    lanes = (-1,) + (1,) * (x.dim() - 1)
    scale, s = lane_scales(layer, absmax)
    q = torch.clamp(torch.round(x / scale.view(lanes)), -127, 127)
    acc = _int_conv(q, layer.w_q, layer.kernel_zyx[0])
    y = fma_f32(acc, s.reshape(s.shape[:1] + lanes[1:-1] + (-1,)),
                layer.bias)
    if relu_out:
        y = torch.relu(y)
    if residual is not None:
        y = y + residual
    return y.contiguous()


def _check(x, layer, absmax, residual):
    k = layer.kernel_zyx
    cout = layer.w_q.shape[1]
    if x.dim() != 5 or k not in ((3, 3, 3), (1, 1, 1)):
        raise ValueError(f"{QCONV}: want x (N,D,H,W,Cin) and a 1^3 or 3^3 "
                         f"layer, got {tuple(x.shape)} and {k}")
    if layer.w_q.shape[0] != k[0] ** 3 * x.shape[-1]:
        raise ValueError(f"{QCONV}: x {tuple(x.shape)} does not match w_q "
                         f"{tuple(layer.w_q.shape)}")
    if tuple(absmax.shape) != (x.shape[0],):
        raise ValueError(f"{QCONV}: want one abs-max per lane, got "
                         f"{tuple(absmax.shape)}")
    dtypes = (x.dtype, layer.w_q.dtype, layer.w_scale.dtype,
              layer.bias.dtype, absmax.dtype)
    if dtypes != (torch.float32, torch.int8) + (torch.float32,) * 3:
        raise TypeError(f"{QCONV} takes float32 x, abs-maxima and bias and "
                        f"int8 weights")
    tensors = [x, layer.w_q, layer.w_scale, layer.bias, absmax]
    if residual is not None:
        if tuple(residual.shape) != tuple(x.shape[:4]) + (cout,) or \
                residual.dtype != torch.float32:
            raise ValueError(f"{QCONV}: residual {tuple(residual.shape)} "
                             f"{residual.dtype} does not match the output")
        tensors.append(residual)
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{QCONV}: tensors on {t.device} and {x.device}")
    return tensors


def qconv3d(x: torch.Tensor, layer: QuantizedConv, absmax: torch.Tensor, *,
            relu_in: bool = False, relu_out: bool = False,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K19. CPU tensors take the plain version; CUDA tensors the kernel.
    Arguments and result as qconv3d_plain's."""
    tensors = _check(x, layer, absmax, residual)
    if x.device.type == "cpu":
        return qconv3d_plain(x, layer, absmax, relu_in=relu_in,
                             relu_out=relu_out, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"{QCONV}: unsupported device {x.device}")
    n, d, h, w, cin = x.shape
    k, cout = layer.kernel_zyx[0], layer.w_q.shape[1]
    if k == 3 and (cin, cout) not in QCONV_SHAPES:
        raise ValueError(f"{QCONV}: the 3^3 kernel takes (Cin, Cout) in "
                         f"{QCONV_SHAPES}, got ({cin}, {cout})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{QCONV} takes contiguous tensors")
    if k == 3:
        if layer.w_k is None or layer.w_k.device != x.device:
            raise ValueError(f"{QCONV}: the layer has no packed weights on "
                             f"{x.device} (QuantizedConv.w_k)")
        if x.data_ptr() % (8 if cin == 2 else 16) or (
                residual is not None and residual.data_ptr() % 8):
            raise ValueError(f"{QCONV} takes x 16-byte aligned (8 at Cin "
                             f"2) and the residual 8-byte")
        k19_geometry(n, d, h, w, cin, cout)   # raises where no band fits
    y = torch.empty((n, d, h, w, cout), device=x.device, dtype=torch.float32)
    err = _build.lib().ffn_qconv3d_s8(
        x.data_ptr(), (layer.w_k if k == 3 else layer.w_q).data_ptr(),
        layer.w_scale.data_ptr(),
        layer.bias.data_ptr(), absmax.data_ptr(),
        residual.data_ptr() if residual is not None else None, y.data_ptr(),
        n, d, h, w, cin, cout, k, int(relu_in), int(relu_out),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, QCONV)
    _build.launches[QCONV] += 1
    return y


# -- the model ---------------------------------------------------------------

class QuantizedConvStack3DModel:
    """The int8 ConvStack3D forward around the port's ConvStack3DFFNModel
    (ffn_tpu/ops/quantized.py:117-148): `prepare` folds the base model's
    float32 parameters (or `params`, a flax tree) into int8
    layers, `to` moves them, `apply(image, seed)` runs the quantized stack
    with the seed-additive output. Each layer's input scale is its lane's
    (K20), then K19."""

    def __init__(self, base_model):
        self.base = base_model
        self.info = base_model.info
        self.depth = base_model.depth
        self.layers = None

    def prepare(self, params=None) -> dict:
        if params is None:   # the base model's own, as a flax tree
            params = {}
            for name, p in self.base.module.state_dict().items():
                _, layer, leaf = params_io.jax_name(name).split("/")
                params.setdefault(layer, {})[leaf] = p.detach().cpu().numpy()
        self.layers = fold_convstack_params(params)
        return self.layers

    def to(self, device):
        self.layers = {k: v.to(device) for k, v in self.layers.items()}
        return self

    def _conv(self, net, name, relu_in=False, **kw):
        return qconv3d(net, self.layers[name], act_absmax(net, relu_in),
                       relu_in=relu_in, **kw)

    @torch.no_grad()
    def apply(self, image: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
        """(B, z, y, x, 1) image and seed (float32 or bfloat16) -> float32
        seed + update. The relu after each residual add is conv_a's (and
        conv_lom's) relu_in; the last add, seed + logits, is conv_lom's
        residual: both round after the dequantize, as in the JAX stack."""
        seed = seed.float()
        net = torch.cat([image.float(), seed], dim=-1)
        net = self._conv(net, "conv0_a", relu_out=True)
        net = self._conv(net, "conv0_b")
        for i in range(1, self.depth):
            block_in = net
            net = self._conv(net, f"conv{i}_a", relu_in=True, relu_out=True)
            net = self._conv(net, f"conv{i}_b", residual=block_in)
        return self._conv(net, "conv_lom", relu_in=True, residual=seed)
