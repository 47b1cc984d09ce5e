"""ffn_tpu_torch's serial Canvas against the JAX package's Canvas.

Both canvases segment test_canvas_e2e.py's synthetic volume with the
rule-based oracle model and the same grid seeds. The oracle makes every
step exact, so the segmentations must be identical, ids included.
"""

import numpy as np
from scipy.special import logit
import torch

from ffn_tpu.inference import canvas as jax_canvas
from ffn_tpu.inference import engine as jax_engine
from ffn_tpu.inference import seed as jax_seed
from ffn_tpu.models import oracle as jax_oracle
from ffn_tpu_torch.inference import canvas, engine
from ffn_tpu_torch.inference import seed as seed_lib
from ffn_tpu_torch.inference.settings import InferenceOptions
from ffn_tpu_torch.models import oracle
from test_canvas_e2e import DELTAS, FOV, make_image, make_options

# Six test workers share the CPU: one torch thread each, or every small
# CPU op waits on threads the other workers' ops have descheduled.
torch.set_num_threads(1)


def _grid(shape):
    return np.array([(z, y, x)
                     for z in range(4, shape[0] - 4, 4)
                     for y in range(4, shape[1] - 4, 4)
                     for x in range(4, shape[2] - 4, 4)])


class JaxGridSeeds(jax_seed.BaseSeedPolicy):
    def init_coords(self):
        self.coords = _grid(self.canvas.shape)


class GridSeeds(seed_lib.BaseSeedPolicy):
    def init_coords(self):
        self.coords = _grid(self.canvas.shape)


def _port_canvas(image):
    opts = make_options()
    options = InferenceOptions(
        init_activation=opts.init_activation, pad_value=opts.pad_value,
        move_threshold=opts.move_threshold,
        segment_threshold=opts.segment_threshold,
        min_segment_size=opts.min_segment_size,
        disco_seed_threshold=opts.disco_seed_threshold,
        min_boundary_dist=(1, 1, 1))
    model = oracle.ThresholdOracleModel(fov_size=[FOV] * 3,
                                        deltas=list(DELTAS))
    eng = engine.FloodFillEngine(
        model, pad_value=float(logit(options.pad_value)),
        move_threshold=float(logit(options.move_threshold)),
        disco_seed_threshold=options.disco_seed_threshold, device="cpu")
    return canvas.Canvas(model.info, eng, image, options)


def test_canvas_matches_jax_canvas():
    image = make_image()
    opts = make_options()
    model = jax_oracle.ThresholdOracleModel(fov_size=[FOV] * 3,
                                            deltas=list(DELTAS))
    eng = jax_engine.FloodFillEngine(
        model, {}, pad_value=float(logit(opts.pad_value)),
        move_threshold=float(logit(opts.move_threshold)),
        disco_seed_threshold=opts.disco_seed_threshold)
    want = jax_canvas.Canvas(model.info, eng, image, opts)
    want.segment_all(seed_policy=JaxGridSeeds)

    got = _port_canvas(image)
    got.segment_all(seed_policy=GridSeeds)

    np.testing.assert_array_equal(got.segmentation, want.segmentation)
    np.testing.assert_array_equal(got.seed, want.seed)
    assert {k: tuple(v.start_zyx) for k, v in got.origins.items()} == \
        {k: tuple(v.start_zyx) for k, v in want.origins.items()}
    assert [o.iters for o in got.origins.values()] == \
        [o.iters for o in want.origins.values()]
    assert len(np.unique(got.segmentation[got.segmentation > 0])) == 2
    # The device buffer and the host mirror hold the same values.
    np.testing.assert_array_equal(got._seed_dev.numpy(), got.seed)


def test_canvas_checkpoint_roundtrip(tmp_path):
    image = make_image()
    cv = _port_canvas(image)
    cv.segment_all(seed_policy=GridSeeds)
    ckpt = str(tmp_path / "canvas.cpoint")
    cv.save_checkpoint(ckpt, partial_segment_iters=3)

    cv2 = _port_canvas(image)
    assert cv2.restore_checkpoint(ckpt) == 3
    np.testing.assert_array_equal(cv2.segmentation, cv.segmentation)
    np.testing.assert_array_equal(cv2.seed, cv.seed)
    np.testing.assert_array_equal(cv2._seed_dev.numpy(), cv.seed)
    assert cv2._max_id == cv._max_id
    assert set(cv2.origins) == set(cv.origins)
    assert cv2.counters["update_at-calls"].value == \
        cv.counters["update_at-calls"].value
    # The restored device buffer is a copy, not a view of the mirror.
    cv2.seed[...] = 0
    assert np.isnan(cv2._seed_dev.numpy()).any()
