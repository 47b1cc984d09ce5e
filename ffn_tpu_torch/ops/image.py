"""Image filters used by seed policies.

The scipy functions are copies of ffn_tpu/ops/image.py's host filters
(Sobel gradient magnitude and Gaussian adaptive threshold), which run once
per subvolume during seeding, not in the hot loop.

`edges` ports the JAX package's jitted `edges_jax` (ops/image.py:71-98),
which no path of either package calls: K22 `edges_sobel` and K23
`edges_blur` (`csrc/edges.cu`) on a CUDA tensor, their plain versions on a
CPU tensor (`edges_plain` runs every stage plain). Its passes pad with
numpy's whole-sample reflection, as `jnp.pad(mode="reflect")` does
(`d c b | a b c d`, repeated when the pad is longer than the axis), where
scipy's `mode="reflect"` reflects half a sample (`d c b a | a b c d`), so
`edges` is not `adaptive_edge_mask`: their masks differ on a few percent
of voxels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy import ndimage

from ffn_tpu_torch import _build

# The reference's adaptive-threshold smoothing width (seed.py:161).
ADAPTIVE_THRESHOLD_SIGMA = 49.0 / 6.0
SOBEL = "edges_sobel"
BLUR = "edges_blur"
_DERIV = (-1.0, 0.0, 1.0)
_SMOOTH = (1.0, 2.0, 1.0)
_MAX_TAPS = 311      # csrc/edges.cu: K23's taps and tile within 48 KB


def sobel_magnitude(image: np.ndarray) -> np.ndarray:
    """N-d Sobel gradient magnitude (generic_gradient_magnitude(sobel))."""
    return ndimage.generic_gradient_magnitude(
        image.astype(np.float32), ndimage.sobel)


def gaussian(image: np.ndarray, sigma: float,
             mode: str = "reflect") -> np.ndarray:
    out = np.zeros(image.shape, dtype=np.float32)
    ndimage.gaussian_filter(image, sigma, output=out, mode=mode)
    return out


def adaptive_edge_mask(image: np.ndarray) -> np.ndarray:
    """Boolean mask of edges: sobel magnitude above its local Gaussian mean.

    Matches seed.py:156-164 (PolicyPeaks edge detection).
    """
    edges = sobel_magnitude(image)
    thresh = gaussian(edges, ADAPTIVE_THRESHOLD_SIGMA, mode="reflect")
    return edges > thresh


# -- edges_jax on the card: K22, K23 ------------------------------------------

def gaussian_taps(sigma_truncate: float = 4.0,
                  device=None) -> torch.Tensor:
    """edges_jax's normalised Gaussian taps, float32 as it computes them:
    radius int(truncate * sigma + 0.5), exp(-0.5 (x / sigma)^2) / sum."""
    sigma = ADAPTIVE_THRESHOLD_SIGMA
    radius = int(sigma_truncate * sigma + 0.5)
    xs = torch.arange(-radius, radius + 1, dtype=torch.float32)
    taps = torch.exp(-0.5 * (xs / np.float32(sigma)) ** 2)
    return (taps / taps.sum()).to(device)


def reflect_indices(n: int, pad: int, device=None) -> torch.Tensor:
    """The source index of each of n + 2 pad positions under numpy's
    mode="reflect": period 2(n - 1), every index 0 when n = 1."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    p = 2 * (n - 1)
    i = torch.remainder(i, p)
    return torch.where(i >= n, p - i, i)


def _conv1d_plain(x: torch.Tensor, taps: torch.Tensor,
                  axis: int) -> torch.Tensor:
    """_conv1d (image.py:57-68): reflect-padded, taps summed in order."""
    n, k = x.shape[axis], taps.shape[0]
    xp = x.index_select(axis, reflect_indices(n, k // 2, x.device))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + taps[i] * xp.narrow(axis, i, n)
    return out


def edges_sobel_plain(image: torch.Tensor) -> torch.Tensor:
    """The Sobel magnitude: per gradient axis three passes along axes 0, 1,
    2, their squares summed in axis order, the square root."""
    taps = {t: torch.tensor(t, dtype=torch.float32, device=image.device)
            for t in (_DERIV, _SMOOTH)}
    grad_sq = torch.zeros_like(image)
    for axis in range(3):
        g = image
        for other in range(3):
            g = _conv1d_plain(g, taps[_DERIV if other == axis else _SMOOTH],
                              other)
        grad_sq = grad_sq + g * g
    return torch.sqrt(grad_sq)


def edges_blur_plain(x: torch.Tensor, taps: torch.Tensor, axis: int,
                     edges: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Gaussian pass along `axis`; with `edges`, the mask edges > it."""
    out = _conv1d_plain(x, taps, axis)
    return out if edges is None else edges > out


def _check_volume(name, x):
    if x.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {x.dtype}")
    if x.dim() != 3 or x.numel() == 0:
        raise ValueError(f"{name} takes a non-empty 3-d volume, got "
                         f"{tuple(x.shape)}")


def _launch_ready(name, *tensors):
    """Whether the tensors go to the kernel (CUDA) or the plain version;
    raises on what the kernel does not take, on either device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def edges_sobel(image: torch.Tensor) -> torch.Tensor:
    """K22. CPU tensors take the plain version; CUDA tensors the kernel."""
    _check_volume(SOBEL, image)
    if not _launch_ready(SOBEL, image):
        return edges_sobel_plain(image)
    d, h, w = image.shape
    out = torch.empty_like(image)
    err = _build.lib().ffn_edges_sobel(
        image.data_ptr(), out.data_ptr(), d, h, w,
        torch.cuda.current_stream(image.device).cuda_stream)
    _build.check(err, SOBEL)
    _build.launches[SOBEL] += 1
    return out


def edges_blur(x: torch.Tensor, taps: torch.Tensor, axis: int,
               edges: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K23: one pass of `taps` (float32, odd length) along `axis` of x;
    with `edges` (x's shape) the bool mask edges > the pass instead. CPU
    tensors take the plain version; CUDA tensors the kernel."""
    _check_volume(BLUR, x)
    if taps.dtype != torch.float32:
        raise TypeError(f"{BLUR}: taps must be float32, got {taps.dtype}")
    if taps.dim() != 1 or taps.shape[0] % 2 == 0 or \
            taps.shape[0] > _MAX_TAPS:
        raise ValueError(f"{BLUR}: taps must be 1-d of odd length at most "
                         f"{_MAX_TAPS}, got {tuple(taps.shape)}")
    if axis not in (0, 1, 2):
        raise ValueError(f"{BLUR}: axis must be 0, 1 or 2, got {axis}")
    tensors = [x, taps]
    if edges is not None:
        _check_volume(BLUR, edges)
        if edges.shape != x.shape:
            raise ValueError(f"{BLUR}: edges {tuple(edges.shape)} is not "
                             f"shaped as x {tuple(x.shape)}")
        tensors.append(edges)
    if not _launch_ready(BLUR, *tensors):
        return edges_blur_plain(x, taps, axis, edges)
    shape = x.shape
    outer = int(np.prod(shape[:axis], dtype=np.int64))
    inner = int(np.prod(shape[axis + 1:], dtype=np.int64))
    if edges is None:
        out, mask = torch.empty_like(x), None
    else:
        out, mask = None, torch.empty(shape, dtype=torch.bool,
                                      device=x.device)
    err = _build.lib().ffn_edges_blur(
        x.data_ptr(), taps.data_ptr(), taps.shape[0],
        None if edges is None else edges.data_ptr(),
        None if out is None else out.data_ptr(),
        None if mask is None else mask.data_ptr(), outer, shape[axis],
        inner, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, BLUR)
    _build.launches[BLUR] += 1
    return out if mask is None else mask


def edges(image, sigma_truncate: float = 4.0,
          device=None) -> torch.Tensor:
    """edges_jax: the bool mask Sobel magnitude > its Gaussian blur, of a
    3-d image (cast to float32): K22, then K23 along axes 0 and 1, then
    K23's mask pass along axis 2. It runs on `device`; by default a torch
    tensor stays on its device and any other array goes to the card."""
    if device is None:
        device = image.device if torch.is_tensor(image) else "cuda"
    image = torch.as_tensor(image, device=device).to(
        torch.float32).contiguous()
    mag = edges_sobel(image)
    taps = gaussian_taps(sigma_truncate, image.device)
    thresh = edges_blur(edges_blur(mag, taps, 0), taps, 1)
    return edges_blur(thresh, taps, 2, edges=mag)


def edges_plain(image: torch.Tensor,
                sigma_truncate: float = 4.0) -> torch.Tensor:
    """`edges` on the plain versions, on any device."""
    image = torch.as_tensor(image).to(torch.float32)
    mag = edges_sobel_plain(image)
    taps = gaussian_taps(sigma_truncate, image.device)
    thresh = edges_blur_plain(edges_blur_plain(mag, taps, 0), taps, 1)
    return edges_blur_plain(thresh, taps, 2, edges=mag)
