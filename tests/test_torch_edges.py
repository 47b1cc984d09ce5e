"""ffn_tpu_torch's `edges` (K22 `edges_sobel` and K23 `edges_blur`'s plain
versions) against the JAX package's jitted `edges_jax`
(ffn_tpu/ops/image.py:71-98), on the CPU.

The JAX intermediates (the Sobel magnitude and its Gaussian blur) come
from edges_jax's own jnp steps, run here; the port's from its K22 and K23
wrappers. XLA's exp and sum round the 67 Gaussian taps a few ulps apart
from float32 torch's, so the magnitude and the blur are held within 1e-5
relative and the masks equal except where |edges - blur| is within that
tolerance. A 20 x 40 x 70 volume has an axis shorter than the 33-voxel
pad, so its blur reflects more than once (numpy's rule, which jnp.pad
follows and torch's reflect padding refuses).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffn_tpu.ops import image as jax_image
from ffn_tpu_torch.ops import image

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)

RTOL = 1e-5
CASES = {"20x40x70_uint8": ((20, 40, 70), np.uint8),
         "48_float32": ((48, 48, 48), np.float32)}


def _volume(shape, dtype, seed=1):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.randn(*shape).astype(np.float32)


@jax.jit
def _jax_parts(img):
    """edges_jax's body (sigma_truncate 4), returning its intermediates."""
    image_f = img.astype(jnp.float32)
    deriv, smooth = jax_image._sobel_kernel_1d()
    grad_sq = jnp.zeros_like(image_f)
    for axis in range(3):
        g = image_f
        for other in range(3):
            g = jax_image._conv1d(g, deriv if other == axis else smooth,
                                  other)
        grad_sq = grad_sq + g * g
    edges = jnp.sqrt(grad_sq)
    sigma = jax_image.ADAPTIVE_THRESHOLD_SIGMA
    radius = int(4.0 * sigma + 0.5)
    xs = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    kernel = jnp.exp(-0.5 * (xs / sigma) ** 2)
    kernel = kernel / kernel.sum()
    thresh = edges
    for axis in range(3):
        thresh = jax_image._conv1d(thresh, kernel, axis)
    return edges, thresh, kernel


@pytest.mark.parametrize("case", list(CASES))
def test_edges_match_edges_jax(case):
    img = _volume(*CASES[case])
    je, jt, jk = (np.asarray(v) for v in _jax_parts(jnp.asarray(img)))
    want = np.asarray(jax_image.edges_jax(jnp.asarray(img)))
    assert np.array_equal(want, je > jt)   # the steps are edges_jax's

    taps = image.gaussian_taps()
    assert taps.dtype == torch.float32 and taps.shape == (67,)
    np.testing.assert_allclose(taps.numpy(), jk, rtol=RTOL, atol=0)
    x = torch.from_numpy(img).float()
    mag = image.edges_sobel(x)
    blur = image.edges_blur(image.edges_blur(mag, taps, 0), taps, 1)
    thresh = image.edges_blur(blur, taps, 2)
    np.testing.assert_allclose(mag.numpy(), je, rtol=RTOL, atol=0)
    np.testing.assert_allclose(thresh.numpy(), jt, rtol=RTOL, atol=0)

    got = image.edges(torch.from_numpy(img))
    assert got.dtype == torch.bool and got.shape == img.shape
    assert torch.equal(got, image.edges_blur(blur, taps, 2, edges=mag))
    assert torch.equal(got, image.edges_plain(torch.from_numpy(img)))
    near = np.abs(je - jt) <= RTOL * np.abs(jt)
    assert np.array_equal(got.numpy()[~near], want[~near])
    assert 0.1 < want.mean() < 0.9


@pytest.mark.parametrize("n,pad", [(1, 3), (2, 5), (5, 7), (20, 33),
                                   (40, 33), (70, 1)])
def test_reflect_indices_follow_numpy(n, pad):
    src = np.arange(n)
    np.testing.assert_array_equal(
        image.reflect_indices(n, pad).numpy(),
        np.pad(src, pad, mode="reflect"))
    np.testing.assert_array_equal(
        image.reflect_indices(n, pad).numpy(),
        np.asarray(jnp.pad(jnp.asarray(src), pad, mode="reflect")))


def test_edges_on_a_single_voxel_axis():
    # n = 1: every padded index reads voxel 0 (numpy and jnp.pad alike).
    img = _volume((1, 9, 11), np.float32, seed=2)
    _, jt, _ = (np.asarray(v) for v in _jax_parts(jnp.asarray(img)))
    thresh = image.edges_blur(image.edges_blur(image.edges_blur(
        image.edges_sobel(torch.from_numpy(img)), image.gaussian_taps(), 0),
        image.gaussian_taps(), 1), image.gaussian_taps(), 2)
    np.testing.assert_allclose(thresh.numpy(), jt, rtol=RTOL, atol=0)


def test_edges_is_not_the_scipy_mask():
    # edges_jax pads with numpy's whole-sample reflection, scipy's filters
    # with half-sample reflection: the masks differ on a few percent of
    # voxels (6429 of 107,520 here, 6.0%). The port copies edges_jax.
    img = _volume((40, 48, 56), np.float32, seed=0)
    scipy_mask = image.adaptive_edge_mask(img)
    want = np.asarray(jax_image.edges_jax(jnp.asarray(img)))
    got = image.edges(torch.from_numpy(img)).numpy()
    assert (got != want).mean() < 1e-3
    assert (got != scipy_mask).mean() > 0.03
    assert (want != scipy_mask).mean() > 0.03


def test_edges_sends_arrays_to_the_card():
    # A tensor stays on its device; any other array goes to the card unless
    # the caller names a device, so without a card it raises.
    img = _volume((9, 10, 11), np.float32, seed=3)
    want = image.edges(torch.from_numpy(img))
    assert torch.equal(image.edges(img, device="cpu"), want)
    if torch.cuda.is_available():
        assert image.edges(img).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            image.edges(img)
