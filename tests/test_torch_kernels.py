"""ffn_tpu_torch's CUDA kernels against their plain PyTorch versions.

The `cuda` tests need an NVIDIA card (a CUDA kernel has no CPU mode) and
skip without one; on the card, run

  python -m pytest tests/test_torch_kernels.py -q

This file imports torch and the port only, so it runs where JAX's model
libraries are not installed. K1 is held to 1e-4 of max|plain| (float32
sums in another order than cuDNN's, TF32 off on both sides); K2 and K3
move and compare values without arithmetic and must match bit for bit.
"""

import numpy as np
import pytest
import torch

from ffn_tpu_torch.ops import conv3d
from ffn_tpu_torch.ops import step as step_ops

FOV = 9
PAD = float(np.log(0.05 / 0.95))
MOVE_T = float(np.log(0.9 / 0.1))
SHAPE = (20, 22, 24)
# Interior steps and two near faces, where the start wraps and clamps.
POSITIONS = [(10, 11, 12), (12, 13, 10), (2, 3, 21), (18, 20, 1)]

# Every flag combination of the stack: conv0_a, conv0_b, a block's _a and
# _b, and conv_lom, at the full width (32 features).
K1_CASES = {
    "conv0_a": (3, 2, 32, False, True, False),
    "conv0_b": (3, 32, 32, False, False, False),
    "block_a": (3, 32, 32, True, True, False),
    "block_b": (3, 32, 32, False, False, True),
    "conv_lom": (1, 32, 1, True, False, True),
    "odd_widths": (3, 13, 40, True, True, True),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_k1_rejects_bad_inputs():
    x = torch.zeros(1, 4, 4, 4, 2)
    with pytest.raises(ValueError):
        conv3d.conv3d_ndhwc_f32(x, torch.zeros(3, 3, 3, 3, 8),
                                torch.zeros(8))
    with pytest.raises(ValueError):
        conv3d.conv3d_ndhwc_f32(x, torch.zeros(2, 2, 2, 2, 8),
                                torch.zeros(8))
    with pytest.raises(TypeError):
        conv3d.conv3d_ndhwc_f32(x.double(), torch.zeros(3, 3, 3, 2, 8),
                                torch.zeros(8))


def test_step_kernels_reject_bad_inputs():
    vol = torch.zeros(SHAPE)
    with pytest.raises(ValueError):
        step_ops.step_gather(vol, torch.zeros(5, 5, 5), (3, 3, 3),
                             (3, 3, 3), (3, 3, 3), PAD)
    with pytest.raises(ValueError):
        step_ops.step_update(torch.zeros(40, 3, 3), vol, (3, 3, 3),
                             (3, 3, 3), MOVE_T, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_kernel_matches_plain(card, case):
    k, cin, cout, pre, post, res = K1_CASES[case]
    gen = torch.Generator().manual_seed(0)
    shape = (2, 9, 10, 11)
    x = torch.randn(*shape, cin, generator=gen).to(card)
    w = (torch.randn(k, k, k, cin, cout, generator=gen) * 0.2).to(card)
    b = torch.randn(cout, generator=gen).to(card)
    r = torch.randn(*shape, cout, generator=gen).to(card) if res else None
    got = conv3d.conv3d_ndhwc_f32(x, w, b, pre_relu=pre, post_relu=post,
                                  residual=r)
    want = conv3d.conv3d_ndhwc_plain(x, w, b, pre_relu=pre, post_relu=post,
                                     residual=r)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4 * float(want.abs().max()), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("disco", [-1.0, 0.0, 0.5, 0.99])
def test_step_kernels_match_plain(card, disco):
    rng = np.random.RandomState(6)
    image = torch.from_numpy(rng.randn(*SHAPE).astype(np.float32)).to(card)
    seed_np = (rng.randn(*SHAPE) * 3).astype(np.float32)
    seed_np[rng.rand(*SHAPE) < 0.3] = np.nan
    for pos in POSITIONS:
        seed = torch.from_numpy(seed_np).to(card)
        got = step_ops.step_gather(image, seed, pos, (FOV,) * 3, (7, 7, 7),
                                   PAD)
        want = step_ops.step_gather_plain(image, seed, pos, (FOV,) * 3,
                                          (7, 7, 7), PAD)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())

        logits = torch.from_numpy(
            (rng.randn(FOV, FOV, FOV) * 3).astype(np.float32)).to(card)
        pseed = seed.clone()
        kpatch = step_ops.step_update(logits, seed, pos, (7, 7, 7), MOVE_T,
                                      disco)
        ppatch = step_ops.step_update_plain(logits, pseed, pos, (7, 7, 7),
                                            MOVE_T, disco)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(kpatch.cpu().numpy(),
                                      ppatch.cpu().numpy())
        np.testing.assert_array_equal(seed.cpu().numpy(),
                                      pseed.cpu().numpy())
