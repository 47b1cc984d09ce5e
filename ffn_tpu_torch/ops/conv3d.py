"""K1: SAME 3D convolution, channels-last (NDHWC), float32; K15 the same in
bfloat16 or float16 (the weights' type); K9/K10 K1's backward, K17/K18
K15's; and the autograd Functions of the stack's training layers.

On a CUDA tensor each wrapper launches its kernel (`csrc/conv3d.cu`,
`conv3d_bf16.cu`, `conv3d_bwd{,16}.cu`); on a CPU tensor it runs its
plain version (`*_plain`), which is also the kernel's oracle on the card.
Weights keep the JAX package's DHWIO layout (k, k, k, Cin, Cout), read as
[tap][ci][co]; the plain versions permute to OIDHW per call.
"""

from __future__ import annotations

import dataclasses
import functools
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
    if cin < 1:
        raise ValueError(f"{NAME} needs at least one input channel")
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
HALF = (torch.bfloat16, torch.float16)
# Launch names of the 16-bit kernels by type: K15, K17, K18.
SUFFIX = {torch.bfloat16: "bf16", torch.float16: "f16"}
# (Cin, Cout) pairs of K15's tensor-core kernel (3^3 layers): the stack's
# input layer and its inner layers at 32 features (model-r2, the benches)
# and at 16 (the CI checkpoint). 1^3 layers take any widths.
BF16_SHAPES = ((2, 32), (32, 32), (2, 16), (16, 16))


def conv3d_ndhwc_bf16_plain(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, *, pre_relu: bool = False,
                            post_relu: bool = False,
                            residual: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """flax's `nn.Conv(dtype=r)` (r = weight.dtype, bfloat16 or float16) with
    the stack's relus and residual: r(x) * weight summed in float32, rounded
    to r, the bias added and rounded again, relu (post_relu), then a 16-bit
    residual added and rounded, or a float32 one (the seed) giving
    `float32(y) + residual`. The sums run through F.conv3d on float32 copies
    (exact products, the library's order), so the kernel may round
    differently (conv3d_bf16_check.k15_tolerance)."""
    dt = weight.dtype
    xf = x.to(dt).float()
    if pre_relu:
        xf = torch.relu(xf)
    k = weight.shape[0]
    acc = F.conv3d(xf.permute(0, 4, 1, 2, 3),
                   weight.float().permute(4, 3, 0, 1, 2), padding=k // 2)
    y = acc.permute(0, 2, 3, 4, 1).to(dt)
    y = (y.float() + bias.float()).to(dt)
    if post_relu:
        y = torch.relu(y)
    if residual is not None:
        if residual.dtype == torch.float32:
            return (y.float() + residual).contiguous()
        y = (y.float() + residual.float()).to(dt)
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
    dt = weight.dtype
    if dt not in HALF or bias.dtype != dt:
        raise TypeError(f"{BF16}: weight and bias must be bfloat16 or "
                        f"float16, got {weight.dtype} and {bias.dtype}")
    if x.dtype not in (torch.float32, dt):
        raise TypeError(f"{BF16}: x must be float32 or {dt}, got {x.dtype}")
    tensors = [x, weight, bias]
    if residual is not None:
        if tuple(residual.shape) != tuple(x.shape[:4]) + (cout,):
            raise ValueError(f"{BF16}: residual {tuple(residual.shape)} "
                             f"does not match the output "
                             f"{tuple(x.shape[:4])}+{cout}")
        if residual.dtype not in (torch.float32, dt):
            raise TypeError(f"{BF16}: residual must be float32 or {dt}, "
                            f"got {residual.dtype}")
        tensors.append(residual)
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{BF16}: tensors on {t.device} and {x.device}")
    return tensors


# The 3^3 kernel's geometry (conv3d_bf16.cu's launch_tc; conv16.cuh): tiles
# of K15_TILE_ROWS voxels at positions q = y * P + x of one z-plane, P = W +
# 1 (a zero column after each row), each staged with a halo of three planes
# of R = K15_TILE_ROWS + 2P + 2 rows; a CTA holds the weights as
# [Cout][k], one stage and a queue of flagged outputs. Two CTAs share an
# SM while each fits K15_SMEM_TWO bytes (the 33^3 FOV does). K17 runs on
# the same tiles of its g (k15_geometry with Cin and Cout swapped).
K15_TILE_ROWS = 128
K15_SMEM = 232448        # shared memory a CTA may use on an H100
K15_SMEM_TWO = 115712    # ... and each of two on one SM (228 KB, 1 KB a CTA)


@dataclasses.dataclass(frozen=True)
class K15Geometry:
    """Tile t of a layer on x (n, d, h, w, cin): sample t // (d per_plane),
    plane t // per_plane % d, positions q0 = t % per_plane * rows onward;
    `smem` bytes a CTA."""
    d: int
    h: int
    w: int
    pitch: int
    halo_rows: int
    per_plane: int
    tiles: int
    smem: int

    def voxels(self, t):
        """(n, z, ys, xs): tile t's voxels in the volume (its other rows,
        past the plane or in the zero column, compute nothing)."""
        n, z = t // (self.d * self.per_plane), t // self.per_plane % self.d
        q = t % self.per_plane * K15_TILE_ROWS + torch.arange(K15_TILE_ROWS)
        ys, xs = q // self.pitch, q % self.pitch
        keep = (ys < self.h) & (xs < self.w)
        return n, z, ys[keep], xs[keep]


def k15_smem(halo_rows, cin, cout):
    """Bytes of shared memory of a 3^3 K15 CTA (conv3d_bf16.cu's
    k15_smem): weights [cout][kpad + 8], a stage of three planes of rows
    of cin + 8 values (cin = 2 unpadded; in 128-byte multiples), the queue
    (a 16-bit entry per output of a tile), its 8 warps' counts and the
    bias in float32."""
    kpad = -(-27 * cin // 16) * 16
    cs = cin + 8 if cin % 16 == 0 else cin
    stage = -(-3 * halo_rows * cs * 2 // 128) * 128
    return (cout * (kpad + 8) * 2 + stage + K15_TILE_ROWS * cout * 2
            + K15_TILE_ROWS // 16 * 4 + cout * 4)


@functools.lru_cache(maxsize=256)
def k15_geometry(n, d, h, w, cin, cout):
    """The 3^3 K15 kernel's tiles for x (n, d, h, w, cin); ValueError when
    the halo of rows of w voxels overflows a CTA's shared memory."""
    pitch = w + 1
    halo_rows = K15_TILE_ROWS + 2 * pitch + 2
    smem = k15_smem(halo_rows, cin, cout)
    if smem > K15_SMEM:
        raise ValueError(f"{BF16}: rows of {w} voxels do not fit the 3^3 "
                         f"kernel's shared memory")
    per_plane = -(-(h * pitch - 1) // K15_TILE_ROWS)
    return K15Geometry(d, h, w, pitch, halo_rows, per_plane,
                       n * d * per_plane, smem)


def conv3d_ndhwc_bf16(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, *, pre_relu: bool = False,
                      post_relu: bool = False,
                      residual: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """K15 (launches counted as conv3d_ndhwc_bf16 or _f16 by the weights'
    type). CPU tensors take the plain version; CUDA tensors the kernel.
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
    if k == 3:
        k15_geometry(n, d, h, w, cin, cout)   # raises where it cannot run
    out_f32 = residual is not None and residual.dtype == torch.float32
    y = torch.empty((n, d, h, w, cout), device=x.device,
                    dtype=torch.float32 if out_f32 else weight.dtype)
    name = "conv3d_ndhwc_" + SUFFIX[weight.dtype]
    err = getattr(_build.lib(), "ffn_" + name)(
        x.data_ptr(), int(x.dtype == torch.float32), weight.data_ptr(),
        bias.data_ptr(), residual.data_ptr() if residual is not None
        else None, y.data_ptr(), n, d, h, w, cin, cout, k, int(pre_relu),
        int(post_relu), int(out_f32),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    _build.launches[name] += 1
    return y


# -- K9 and K10: the layer's backward --------------------------------------

DGRAD = "conv3d_dgrad_f32"
WGRAD = "conv3d_wgrad_f32"
# K10's row body (wgrad.cuh: 1^3 layers and widths the chunk tiles do not
# take): output rows (n, z, y) per chunk of its first stage.
WGRAD_ROWS = 32


def _masked(dy: torch.Tensor, y: Optional[torch.Tensor]) -> torch.Tensor:
    """g = dy * [y > 0] (post_relu's gradient; 0 at 0), or dy."""
    if y is None:
        return dy
    return torch.where(y > 0, dy, torch.zeros((), dtype=dy.dtype,
                                              device=dy.device))


# The float32 plane-position tiles K1 and K9 share (conv32.cuh's TilePlan):
# tiles of K9_TILE_POS positions q = y * P + x of one z-plane (K15's,
# longer, P = W + 1 rounded up to even) and 4 * cig output channels, the
# output's channel block the slowest index; a tile's halo three planes of
# three row bands K9_TILE_POS + 2 rows long, band_stride = min(P,
# K9_TILE_POS + 2) apart (one run of rows while they overlap); threads of
# K9_RUN positions x 4 channels, K9_RUNS x cig a CTA; the weights staged
# for g_block input channels at a time and the input's halo (and a mask's
# beside it) in chunks of `chunk` input channels, one stage; K1 keeps a
# table of each halo row's voxel beside it (`table` ints, halo_rows). K9's
# input is g (the layer's Cout channels) and its output dx (Cin); K1's are
# x and y.
K9_RUN, K9_RUNS = 4, 96
K9_TILE_POS = K9_RUN * K9_RUNS
K9_GBLOCK, K9_CHUNK_MAX = 32, 16
SMEM_SM = 233472     # an H100 SM's shared memory; each CTA reserves 1 KB
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """Tile t of K1 or K9 on an input (n, d, h, w, channels): output
    channel block t // (n d per_plane) (`ci_blocks` of them: K9's dx
    channels are the layer's Cin), then sample, plane and positions as
    K15Geometry's; `smem` bytes a CTA."""
    n: int
    d: int
    h: int
    w: int
    cig: int
    threads: int
    pitch: int
    band_stride: int
    halo_rows: int
    per_plane: int
    ci_blocks: int
    tiles: int
    g_block: int
    chunk: int
    w_row: int
    stage: int
    smem: int
    table: int = 0

    def voxels(self, t):
        """(channel block, n, z, ys, xs): tile t's output channel block and
        voxels (its other positions, past the plane or in the zero column,
        store nothing)."""
        per_block = self.n * self.d * self.per_plane
        b, r = t // per_block, t % per_block
        n, z = r // (self.d * self.per_plane), r // self.per_plane % self.d
        q = r % self.per_plane * K9_TILE_POS + torch.arange(K9_TILE_POS)
        ys, xs = q // self.pitch, q % self.pitch
        keep = (ys < self.h) & (xs < self.w)
        return b, n, z, ys[keep], xs[keep]

    def halo_positions(self, t):
        """Plane positions of tile t's staged rows h = 0..halo_rows-1:
        q0 + (b - 1) P - 1 + h - b S, b = min(h // S, 2)."""
        q0 = t % self.per_plane * K9_TILE_POS
        h = torch.arange(self.halo_rows)
        b = torch.clamp(h // self.band_stride, max=2)
        return q0 + (b - 1) * self.pitch - 1 + h - b * self.band_stride


def _below_pow2(v):
    p = 1
    while 2 * p < v:
        p *= 2
    return p


def _tile_cig(cy):
    return 8 if cy > 16 else 4 if cy > 8 else 2 if cy > 4 else 1


def _pitch_and_per_plane(h, w):
    pitch = (w + 2) // 2 * 2     # even: 8-byte aligned windows
    return pitch, -(-(h * pitch - 1) // K9_TILE_POS)


def _tile_geometry(n, d, h, w, cy, cx, masked, cig, budget, table=False):
    """conv32.cuh's tile_plan: cy output and cx input channels; the first
    (g_block, chunk), largest g_block first, whose weight rows and stage
    (twice the stage when `masked`; the halo table's ints with `table`) fit
    `budget`. Every shape fits: g_block = chunk = 1 takes at most 31.3 KB
    (4 * cig <= 32 output channels, halo_rows <= 3 * (K9_TILE_POS + 2)),
    where the search ends."""
    cip = 4 * cig
    pitch, per_plane = _pitch_and_per_plane(h, w)
    band = min(pitch, K9_TILE_POS + 2)
    halo_rows = 2 * band + K9_TILE_POS + 2
    ci_blocks = -(-cy // cip)
    w_row = 27 * cip + 4
    gb = min(cx, K9_GBLOCK)
    while True:
        cc = K9_CHUNK_MAX
        while cc >= 1:
            stage = -(-cc * 3 * halo_rows * (2 if masked else 1) // 4) * 4
            extra = halo_rows if table else 0
            smem = 4 * (gb * w_row + stage + extra)
            if cc <= gb and (smem <= budget or gb == 1):
                return TileGeometry(n, d, h, w, cig, K9_RUNS * cig, pitch,
                                    band, halo_rows, per_plane, ci_blocks,
                                    ci_blocks * n * d * per_plane, gb, cc,
                                    w_row, stage, smem, extra)
            cc //= 2
        gb = _below_pow2(gb)


@functools.lru_cache(maxsize=256)
def k9_geometry(n, d, h, w, cin, cout, masked):
    """K9's 3^3 tiles for dy (n, d, h, w, cout), dx with cin channels,
    `masked` when y (post_relu) is staged beside g: a CTA has half an SM
    when cig < 8 (two share it), else the whole (conv3d_bwd.cu's
    k9_plan)."""
    cig = _tile_cig(cin)
    return _tile_geometry(n, d, h, w, cin, cout, masked, cig,
                          K15_SMEM_TWO if cig < 8 else K15_SMEM)


@functools.lru_cache(maxsize=256)
def k1_geometry(n, d, h, w, cin, cout, sms=H100_SMS):
    """K1's 3^3 tiles for x (n, d, h, w, cin) and cout output channels on a
    card of `sms` SMs (conv3d.cu's k1_plan, which the C entry computes):
    cig by the output width, halved while the tiles are fewer than two an
    SM (a 33^3 sample at N = 1: 99 tiles of 384 positions, 396 in four
    blocks of 8 channels at 32->32); a CTA's share of the SM is that of as
    many CTAs as an SM has tiles, at most 8 / cig; the halo table beside
    the stage."""
    _, per_plane = _pitch_and_per_plane(h, w)
    cig = _tile_cig(cout)

    def tiles():
        return n * d * per_plane * -(-cout // (4 * cig))
    while cig > 1 and tiles() < 2 * sms:
        cig //= 2
    share = max(1, min(8 // cig, -(-tiles() // sms)))
    return _tile_geometry(n, d, h, w, cout, cin, False, cig,
                          SMEM_SM // share - 1024, table=True)


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


# K10's chunk tiles (wgrad32.cuh) for the stack's 3^3 layers: (Cin, Cout)
# pairs; threads a CTA; CTAs at most (fixed: the chunk -> CTA assignment
# depends on the shape alone).
K10_SHAPES = ((2, 32), (32, 32), (2, 16), (16, 16))
K10_THREADS, K10_CTAS = 864, 132


def k10_smem(cy, cx, cin, cout, masked):
    """Bytes of a K10 CTA (wgrad32.cuh's w10_smem): two stages of x's halo
    (3 (cy + 2) (cx + 2) voxels, two of slack, rounded to 4 floats), g and,
    masked, y at cy (cx + 2) positions; or the thread groups' sums."""
    xf = -(-(3 * (cy + 2) * (cx + 2) + 2) * cin // 4) * 4
    stage = xf + cy * (cx + 2) * cout * (2 if masked else 1)
    cb = 2 if cin == 2 else 4
    return max(2 * 4 * stage, 4 * K10_THREADS * cb * 8)


@dataclasses.dataclass(frozen=True)
class K10Geometry:
    """K10's chunks on x (n, d, h, w, cin): cy rows of cx columns of one
    z-plane of one sample, chunk c = ((n * d + z) * ny + iy) * nx + ix;
    CTA b sums chunks b, b + ctas, ... and writes partial row b; threads of
    one tap x cb input channels x 8 output channels, `groups` groups of
    them a CTA (group j takes a chunk's positions j, j + groups, ...);
    `smem` bytes a CTA."""
    n: int
    d: int
    h: int
    w: int
    cy: int
    cx: int
    ny: int
    nx: int
    chunks: int
    ctas: int
    cb: int
    groups: int
    smem: int

    def chunk(self, c):
        """(n, z, y0, y1, x0, x1): chunk c's voxels."""
        ix, rest = c % self.nx, c // self.nx
        iy, rest = rest % self.ny, rest // self.ny
        z, n = rest % self.d, rest // self.d
        y0, x0 = iy * self.cy, ix * self.cx
        return (n, z, y0, min(y0 + self.cy, self.h), x0,
                min(x0 + self.cx, self.w))

    def cta_chunks(self, b):
        """CTA b's chunks, in the order it sums them."""
        return list(range(b, self.chunks, self.ctas))


@functools.lru_cache(maxsize=256)
def k10_geometry(n, d, h, w, cin, cout, masked):
    """K10's chunk plan (wgrad32.cuh's w10_plan) for a 3^3 layer on x (n, d,
    h, w, cin), or None where the chunk tiles do not take the layer (other
    widths; no chunk fits): the least rounds of chunks over the CTAs times
    a chunk's positions cy (cx + 2), ties to the larger chunk; full rows
    (cx = w) while one row fits, else the widest columns that fit one
    row. None for an empty input too."""
    if (cin, cout) not in K10_SHAPES or n * d * h * w == 0:
        return None
    best = None

    def consider(cy, cx):
        nonlocal best
        smem = k10_smem(cy, cx, cin, cout, masked)
        if smem > K15_SMEM:
            return
        ny, nx = -(-h // cy), -(-w // cx)
        chunks = n * d * ny * nx
        ctas = min(K10_CTAS, chunks)
        cost = -(-chunks // ctas) * cy * (cx + 2)
        if best is None or cost < best[0] or (
                cost == best[0] and cy * cx > best[1].cy * best[1].cx):
            cb = 2 if cin == 2 else 4
            groups = K10_THREADS // (27 * (cin // cb) * (cout // 8))
            best = (cost, K10Geometry(n, d, h, w, cy, cx, ny, nx, chunks,
                                      ctas, cb, groups, smem))
    for cy in range(1, h + 1):
        consider(cy, w)
    if best is None:
        for cx in range(w - 1, 0, -1):
            consider(1, cx)
            if best is not None:
                break
    return None if best is None else best[1]


def conv3d_wgrad_f32(x: torch.Tensor, dy: torch.Tensor, k: int, *,
                     pre_relu: bool = False,
                     y: Optional[torch.Tensor] = None):
    """K10: (dW, db). Deterministic on the card (no float atomics): the
    stack's 3^3 layers on the chunk tiles (k10_geometry), the others on the
    row body (WGRAD_ROWS)."""
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
    geo = k10_geometry(n, d, h, w, cin, cout, y is not None) if k == 3 \
        else None
    rows = geo.ctas if geo is not None else -(-(n * d * h) // WGRAD_ROWS)
    if geo is not None and (x.data_ptr() % (16 if cin % 4 == 0 else 8) or
                            any(t.data_ptr() % 16 for t in tensors[1:])):
        raise ValueError(f"{WGRAD}: the chunk tiles take x 16-byte aligned "
                         f"(8 at Cin 2), dy and y 16-byte")
    partial = torch.empty((max(rows, 1), k ** 3 * cin * cout + cout),
                          device=x.device, dtype=torch.float32)
    dw = torch.empty((k, k, k, cin, cout), device=x.device,
                     dtype=torch.float32)
    db = torch.empty((cout,), device=x.device, dtype=torch.float32)
    err = _build.lib().ffn_conv3d_wgrad_f32(
        x.data_ptr(), dy.data_ptr(), y.data_ptr() if y is not None else None,
        partial.data_ptr(), dw.data_ptr(), db.data_ptr(), n, d, h, w, cin,
        cout, k, int(pre_relu), WGRAD_ROWS, partial.shape[0],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, WGRAD)
    _build.launches[WGRAD] += 1
    return dw, db


class Conv3dFunction(torch.autograd.Function):
    """One K1 layer with its backward on K9 (input) and K10 (weight, bias).
    forward(x, weight, bias, residual, pre_relu, post_relu) is K1; the
    residual's gradient is dy; the input gradient only where autograd asks.
    post_relu with a residual is refused (the relu mask is read from the
    saved output; the model never combines them)."""

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
    """A residual block, `x + conv_b(relu(conv_a(relu(x))))`, as two K1
    launches, its backward on K9 and K10; K9 adds the residual's gradient in
    its epilogue."""

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


# -- K17 and K18: K15's backward, and the 16-bit training layers ------------
#
# XLA's backward of flax's 16-bit Conv (ffn_tpu/training/train_lib.py:368,
# :471), type r (bfloat16 or float16): the float32 cotangent of the logits
# is cast to r before conv_lom's backward; each conv transpose outputs r
# (dx = r(sum), dW = f32(r(sum)), db = f32(r(sum over N, z, y, x))); a relu
# selects; a residual's two cotangents meet in one add of type r.

DGRAD16_SHAPES = ((32, 32), (16, 16))   # K17's 3^3 (Cin, Cout) pairs


def conv3d_dgrad_16_plain(dy, weight, *, x=None, y=None, accum=None):
    """The input gradient of a K15 layer of type r = weight.dtype: dy (r, or
    float32 rounded to r), masked where the forward output `y` was not > 0
    (post_relu); r(sum) masked where the forward input `x` was not > 0
    (pre_relu); `accum`, the input's other cotangent, added and rounded."""
    dt = weight.dtype
    g = _masked(dy.to(dt), y).float()
    k, cin = weight.shape[0], weight.shape[3]
    shape = (dy.shape[0], cin) + tuple(dy.shape[1:4])
    dx = torch.nn.grad.conv3d_input(
        shape, weight.float().permute(4, 3, 0, 1, 2), g.permute(0, 4, 1, 2, 3),
        padding=k // 2).permute(0, 2, 3, 4, 1).to(dt)
    if x is not None:
        dx = torch.where(x > 0, dx, torch.zeros((), dtype=dt,
                                                device=dx.device))
    if accum is not None:
        dx = (dx.float() + accum.float()).to(dt)
    return dx.contiguous()


def conv3d_wgrad_16_plain(x, dy, k, *, pre_relu=False, y=None):
    """(dW, db) of a K15 layer, float32 values of type r: x and dy (each of
    type r, or float32 rounded to r; r from the one that is 16-bit) as
    conv3d_wgrad_plain's; each sum rounded to r once."""
    dt = _dtype16(x, dy)
    dw, db = conv3d_wgrad_plain(x.to(dt).float(), dy.to(dt).float(), k,
                                pre_relu=pre_relu,
                                y=y.float() if y is not None else None)
    return dw.to(dt).float(), db.to(dt).float()


def _dtype16(*tensors):
    dts = {t.dtype for t in tensors} - {torch.float32}
    if len(dts) != 1 or not dts <= set(HALF):
        raise TypeError(f"want one 16-bit type (and float32), got "
                        f"{[t.dtype for t in tensors]}")
    return dts.pop()


def _check16(name, tensors, dev):
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.type == "cuda" and not all(
            t.is_contiguous() and t.data_ptr() % 16 == 0
            for t in tensors if t is not None):
        raise ValueError(f"{name} takes contiguous, 16-byte aligned tensors")
    return dev.type == "cpu"


def conv3d_dgrad_16(dy, weight, *, x=None, y=None, accum=None):
    """K17 (launches conv3d_dgrad_bf16 or _f16). Arguments and result as
    conv3d_dgrad_16_plain's; on the card a 3^3 layer takes (Cin, Cout) in
    DGRAD16_SHAPES, a 16-bit dy and rows k15_geometry takes, a 1^3 layer
    any widths."""
    dt = weight.dtype
    if dt not in HALF or dy.dtype not in (dt, torch.float32) or any(
            t is not None and t.dtype != dt for t in (x, y, accum)):
        raise TypeError(f"conv3d_dgrad_16: want 16-bit tensors of one type "
                        f"(dy may be float32), got weight {dt}, dy "
                        f"{dy.dtype}")
    n, d, h, w, cout = dy.shape
    k, cin = weight.shape[0], weight.shape[3]
    for t, c in ((x, cin), (y, cout), (accum, cin)):
        if t is not None and tuple(t.shape) != (n, d, h, w, c):
            raise ValueError(f"conv3d_dgrad_16: {tuple(t.shape)} does not "
                             f"match dy {tuple(dy.shape)}")
    if _check16("conv3d_dgrad_16", (dy, weight, x, y, accum), dy.device):
        return conv3d_dgrad_16_plain(dy, weight, x=x, y=y, accum=accum)
    if weight.shape[-1] != cout or (k == 3 and (
            (cin, cout) not in DGRAD16_SHAPES or dy.dtype != dt)):
        raise ValueError(f"conv3d_dgrad_16: the 3^3 kernel takes a 16-bit "
                         f"dy and (Cin, Cout) in {DGRAD16_SHAPES}, got "
                         f"{tuple(weight.shape)} {dy.dtype}")
    if k == 3:   # K15's tiles of g: raises where K15's forward would
        k15_geometry(n, d, h, w, cout, cin)
    dx = torch.empty((n, d, h, w, cin), device=dy.device, dtype=dt)
    name = "conv3d_dgrad_" + SUFFIX[dt]
    err = _build.lib().ffn_conv3d_dgrad_16(
        dy.data_ptr(), int(dy.dtype == torch.float32),
        *(t.data_ptr() if t is not None else None
          for t in (y, weight, x, accum, dx)),
        n, d, h, w, cin, cout, k, int(dt == torch.float16),
        torch.cuda.current_stream(dy.device).cuda_stream)
    _build.check(err, name)
    _build.launches[name] += 1
    return dx


# K18's bodies: 3^3 layers with Cout 16 or 32, Cin <= 32 and a 16-bit dy on
# the tensor cores (conv3d_wgrad_*), 1^3 layers on K10's CUDA-core body
# (conv3d_wgrad1_*). Stage 1 of the tensor-core body: chunks of WGRAD16_CHUNK
# rows (z, y) with all of x, summed by WGRAD16_CTAS CTAs (one per H100 SM)
# in a fixed order, each CTA owning all 27 taps
# (tools_torch/k18_variants.py times other chunks and CTA counts).
WGRAD16_CHUNK = (3, 3)
WGRAD16_CTAS = 132
WGRAD16_SMEM = 232448   # shared memory a CTA may use on an H100


def wgrad16_route(k, cin, cout, dy_dtype):
    """The K18 body that takes a layer: "conv3d_wgrad" (3^3, the tensor
    cores) or "conv3d_wgrad1" (1^3, the CUDA cores); ValueError for any other
    layer. By shape and type alone."""
    if k == 3 and cout in (16, 32) and 1 <= cin <= 32 and dy_dtype in HALF:
        return "conv3d_wgrad"
    if k == 1 and cin >= 1 and 1 <= cout <= 256 and (
            (cin + 3) // 4) * ((cout + 3) // 4) <= 256:
        return "conv3d_wgrad1"
    raise ValueError(f"conv3d_wgrad_16: no kernel takes k={k} {cin}->{cout} "
                     f"with dy {dy_dtype} (3^3: Cin <= 32, Cout 16 or 32, a "
                     f"16-bit dy; 1^3: at most 64x64 channels)")


def wgrad16_smem(cz, cy, w, cin, cout):
    """Bytes of shared memory of a stage-1 CTA (conv3d_bwd16.cu's
    wgrad16_smem): x's halo and a zero voxel, g and the mask, the position
    table."""
    cip = 16 if cin <= 16 else 32
    hvox = (cz + 2) * (cy + 2) * (w + 2) + 1
    ppad = -(-(cz * cy * w) // 16) * 16
    return hvox * (cip + 8) * 2 + 2 * ppad * (cout + 8) * 2 + ppad * 4


@dataclasses.dataclass(frozen=True)
class Wgrad16Chunks:
    """Stage 1's geometry: chunks of cz x cy rows (z, y), ny a z-chunk and
    nz a sample, chunk c = (c // (nz ny), c // ny % nz, c % ny); CTA b sums
    chunks b, b + ctas, ...; `smem` bytes a CTA."""
    d: int
    h: int
    cz: int
    cy: int
    nz: int
    ny: int
    chunks: int
    ctas: int
    smem: int

    def box(self, c):
        """(n, z0, z1, y0, y1): chunk c's rows."""
        n, iz, iy = c // (self.nz * self.ny), c // self.ny % self.nz, \
            c % self.ny
        z0, y0 = iz * self.cz, iy * self.cy
        return (n, z0, min(z0 + self.cz, self.d), y0,
                min(y0 + self.cy, self.h))


@functools.lru_cache(maxsize=256)
def wgrad16_chunks(n, d, h, w, cin, cout):
    """The tensor-core K18's chunks for x (n, d, h, w, cin): WGRAD16_CHUNK
    rows cut to the volume, fewer while a CTA's tiles overflow shared
    memory (ValueError if one row does); at most WGRAD16_CTAS CTAs."""
    cz, cy = min(WGRAD16_CHUNK[0], d), min(WGRAD16_CHUNK[1], h)
    while wgrad16_smem(cz, cy, w, cin, cout) > WGRAD16_SMEM and (
            cz > 1 or cy > 1):
        if cy >= cz:
            cy -= 1
        else:
            cz -= 1
    smem = wgrad16_smem(cz, cy, w, cin, cout)
    if smem > WGRAD16_SMEM:
        raise ValueError(f"conv3d_wgrad_16: rows of {w} voxels do not fit "
                         f"in shared memory")
    nz, ny = -(-d // cz), -(-h // cy)
    chunks = n * nz * ny
    return Wgrad16Chunks(d, h, cz, cy, nz, ny, chunks,
                         min(WGRAD16_CTAS, chunks), smem)


def conv3d_wgrad_16(x, dy, k, *, pre_relu=False, y=None):
    """K18 (launches conv3d_wgrad_bf16 or _f16 for a 3^3 layer,
    conv3d_wgrad1_bf16 or _f16 for a 1^3 one; wgrad16_route): (dW, db)
    float32, as conv3d_wgrad_16_plain's. Deterministic on the card (no
    atomics)."""
    dt = _dtype16(x, dy, *(() if y is None else (y,)))
    if y is not None and y.dtype != dt:
        raise TypeError(f"conv3d_wgrad_16: y must be {dt}")
    if x.dim() != 5 or dy.dim() != 5 or x.shape[:4] != dy.shape[:4] or (
            y is not None and y.shape != dy.shape) or k not in (1, 3):
        raise ValueError(f"conv3d_wgrad_16: want x (N,D,H,W,Cin), dy and y "
                         f"(N,D,H,W,Cout), k 1 or 3, got {tuple(x.shape)}, "
                         f"{tuple(dy.shape)}, {k}")
    if _check16("conv3d_wgrad_16", (x, dy, y), x.device):
        return conv3d_wgrad_16_plain(x, dy, k, pre_relu=pre_relu, y=y)
    n, d, h, w, cin = x.shape
    cout = dy.shape[-1]
    route = wgrad16_route(k, cin, cout, dy.dtype)
    dw = torch.empty((k, k, k, cin, cout), device=x.device,
                     dtype=torch.float32)
    db = torch.empty((cout,), device=x.device, dtype=torch.float32)
    ptrs = (x.data_ptr(), int(x.dtype == torch.float32), dy.data_ptr())
    ym = y.data_ptr() if y is not None else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    f16 = int(dt == torch.float16)
    if route == "conv3d_wgrad":
        geo = wgrad16_chunks(n, d, h, w, cin, cout)
        partial = torch.empty((geo.ctas, 27 * cin * cout + cout),
                              device=x.device, dtype=torch.float32)
        err = _build.lib().ffn_conv3d_wgrad16_tc(
            *ptrs, ym, partial.data_ptr(), dw.data_ptr(), db.data_ptr(), n,
            d, h, w, cin, cout, int(pre_relu), geo.cz, geo.cy, geo.ctas,
            f16, stream)
    else:
        partial = torch.empty((-(-(n * d * h) // WGRAD_ROWS), cin * cout
                               + cout), device=x.device, dtype=torch.float32)
        err = _build.lib().ffn_conv3d_wgrad_16(
            *ptrs, int(dy.dtype == torch.float32), ym, partial.data_ptr(),
            dw.data_ptr(), db.data_ptr(), n, d, h, w, cin, cout, k,
            int(pre_relu), WGRAD_ROWS, f16, stream)
    name = f"{route}_{SUFFIX[dt]}"
    _build.check(err, name)
    _build.launches[name] += 1
    return dw, db


class Conv16Function(torch.autograd.Function):
    """One K15 layer of type `dtype` on float32 parameters (rounded at every
    call, as flax casts them), its backward on K17 and K18; arguments as
    Conv3dFunction's (conv_lom: a float32 output and cotangent)."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, pre_relu, post_relu, dtype):
        if post_relu and residual is not None:
            raise ValueError("Conv16Function: post_relu with a residual has "
                             "no gradient here")
        w = weight.to(dtype)
        y = conv3d_ndhwc_bf16(x, w, bias.to(dtype), pre_relu=pre_relu,
                              post_relu=post_relu, residual=residual)
        ctx.pre_relu = pre_relu
        ctx.save_for_backward(x, w, y if post_relu else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        dy = dy.contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_dgrad_16(dy, w, x=x if ctx.pre_relu else None, y=y)
        dw, db = conv3d_wgrad_16(x, dy, w.shape[0], pre_relu=ctx.pre_relu,
                                 y=y)
        dres = dy if ctx.needs_input_grad[3] else None
        return dx, dw, db, dres, None, None, None


def conv16_train(x, weight, bias, dtype, *, pre_relu=False, post_relu=False,
                 residual=None):
    """K15 under autograd, its backward on K17 and K18 (Conv16Function)."""
    return Conv16Function.apply(x, weight, bias, residual, pre_relu,
                                post_relu, dtype)


class ResidualBlock16Function(torch.autograd.Function):
    """A residual block of type `dtype`, `x + conv_b(relu(conv_a(relu(x))))`
    as two K15 launches, with its backward on K17 and K18: the block input's
    cotangent is r(dy + r(conv_a's transpose) [x > 0]), K17 adding dy in its
    epilogue."""

    @staticmethod
    def forward(ctx, x, wa, ba, wb, bb, dtype):
        wa, wb = wa.to(dtype), wb.to(dtype)
        a = conv3d_ndhwc_bf16(x, wa, ba.to(dtype), pre_relu=True,
                              post_relu=True)
        ctx.save_for_backward(x, a, wa, wb)
        return conv3d_ndhwc_bf16(a, wb, bb.to(dtype), residual=x)

    @staticmethod
    def backward(ctx, dy):
        x, a, wa, wb = ctx.saved_tensors
        dy = dy.contiguous()
        dwb, dbb = conv3d_wgrad_16(a, dy, 3)
        da = conv3d_dgrad_16(dy, wb)
        dwa, dba = conv3d_wgrad_16(x, da, 3, pre_relu=True, y=a)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_dgrad_16(da, wa, x=x, y=a, accum=dy)
        return dx, dwa, dba, dwb, dbb, None


def residual_block16_train(x, wa, ba, wb, bb, dtype):
    """A 16-bit residual block under autograd (ResidualBlock16Function)."""
    return ResidualBlock16Function.apply(x, wa, ba, wb, bb, dtype)
