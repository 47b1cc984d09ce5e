"""Host-side image filters used by seed policies.

A copy of ffn_tpu/ops/image.py without JAX (its unused jitted `edges_jax`
is left out): Sobel gradient magnitude and Gaussian adaptive threshold on
scipy. These run once per subvolume during seeding, not in the hot loop.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

# The reference's adaptive-threshold smoothing width (seed.py:161).
ADAPTIVE_THRESHOLD_SIGMA = 49.0 / 6.0


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
