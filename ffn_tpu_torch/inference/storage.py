"""Volume I/O and the FFN subvolume storage layout, without protobuf.

Counterpart of the parts of ffn_tpu/inference/storage.py that the serial
path uses. The layout is the same: `<dir>/<x>/<y>/seg-X_Y_Z.npz` with keys
`segmentation` and `origins`, so the port's output loads with
ffn_tpu.inference.storage.load_segmentation.
"""

from __future__ import annotations

import os
import tempfile
from collections import namedtuple
from contextlib import contextmanager

import numpy as np

from ffn_tpu.inference import segmentation

OriginInfo = namedtuple("OriginInfo", ["start_zyx", "iters", "walltime_sec"])


def decorated_volume(spec: str):
    """Opens a volume: "<file.h5>:<dataset>" (hdf5) or "<file>.npy".

    Returns an object supporting __getitem__, .shape and .ndim (3d or 4d).
    """
    if spec.endswith(".npy"):
        volume = np.load(spec, mmap_mode="r")
    else:
        path = spec.split(":")
        if len(path) != 2:
            raise ValueError("volume should be file_path:dataset_path (hdf5) "
                             "or a .npy file, got: " + spec)
        import h5py  # deferred: the .npy route needs no h5py
        volume = h5py.File(path[0], "r")[path[1]]
    if volume.ndim not in (3, 4):
        raise ValueError("Volume must be 3d or 4d.")
    return volume


@contextmanager
def atomic_file(path: str, mode: str = "w+b"):
    """Atomically writes a file: temp file + rename-into-place."""
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    tmp = tempfile.NamedTemporaryFile(mode=mode, dir=directory or None,
                                      delete=False)
    try:
        yield tmp
        tmp.flush()
        os.fsync(tmp.fileno())
        tmp.close()
        os.replace(tmp.name, path)
    except BaseException:
        tmp.close()
        try:
            os.unlink(tmp.name)
        except OSError:
            pass
        raise


def quantize_probability(prob: np.ndarray) -> np.ndarray:
    """Quantizes probabilities in [0, 1] to uint8; NaN maps to 0."""
    ret = np.digitize(prob, np.linspace(0.0, 1.0, 255))
    ret[np.isnan(prob)] = 0
    return ret.astype(np.uint8)


def save_subvolume(labels, origins, output_path, **misc_items):
    """Saves a segmented subvolume as seg-X_Y_Z.npz (keys: segmentation,
    origins, plus any misc items)."""
    seg = segmentation.reduce_id_bits(np.asarray(labels))
    with atomic_file(output_path) as fd:
        np.savez_compressed(fd, segmentation=seg, origins=origins,
                            **misc_items)


# Subvolume path scheme: <dir>/<x>/<y>/seg-X_Y_Z.{npz,prob,cpoint}
# (corner args are ZYX; filenames are XYZ).

def legacy_subvolume_path(output_dir, corner, suffix):
    return os.path.join(output_dir, "seg-%s.%s" % (
        "_".join(str(int(x)) for x in corner[::-1]), suffix))


def subvolume_path(output_dir, corner, suffix):
    return os.path.join(
        output_dir, str(int(corner[2])), str(int(corner[1])),
        "seg-%s.%s" % ("_".join(str(int(x)) for x in corner[::-1]), suffix))


def checkpoint_path(output_dir, corner):
    return subvolume_path(output_dir, corner, "cpoint")


def segmentation_path(output_dir, corner):
    return subvolume_path(output_dir, corner, "npz")


def object_prob_path(output_dir, corner):
    return subvolume_path(output_dir, corner, "prob")


def load_origins(segmentation_dir, corner):
    """{id: OriginInfo} of an existing subvolume segmentation."""
    for target in (segmentation_path(segmentation_dir, corner),
                   legacy_subvolume_path(segmentation_dir, corner, "npz")):
        if os.path.exists(target):
            with np.load(target, allow_pickle=True) as data:
                return data["origins"].item()
    raise ValueError(f"Segmentation not found: {segmentation_dir}, {corner}")


def clip_subvolume_to_bounds(corner, size, volume):
    """Clips (corner, size) (ZYX) to the volume bounds."""
    volume_size = np.asarray(volume.shape[-3:])
    start = np.clip(np.asarray(corner), 0, volume_size)
    end = np.clip(np.asarray(corner) + np.asarray(size), 0, volume_size)
    return start, np.maximum(end - start, 0)
