"""Volume I/O and the FFN subvolume storage layout, without protobuf: the
parts of ffn_tpu/inference/storage.py the inference paths and stitcher
use. `<dir>/<x>/<y>/seg-X_Y_Z.npz` with `segmentation` and `origins`, so
either package loads the other's output; the pickled `origins` read only
through `_CompatUnpickler`, which maps any OriginInfo class (JAX's,
google/ffn's, the port's) to the port's, importing nothing of its writer.
"""

from __future__ import annotations

import logging
import os
import pickle
import tempfile
import zipfile
from collections import namedtuple
from contextlib import contextmanager
from typing import Optional

import numpy as np
from numpy.lib import format as npformat

from ffn_tpu_torch.inference import segmentation

OriginInfo = namedtuple("OriginInfo", ["start_zyx", "iters", "walltime_sec"])


class _CompatUnpickler(pickle.Unpickler):
    """Unpickler that maps foreign OriginInfo classes onto ours.

    Segmentations written by the JAX package or by google/ffn pickle
    OriginInfo under their own module paths. The field layout is identical,
    so any class named OriginInfo resolves to this module's namedtuple.
    """

    def find_class(self, module, name):
        if name == "OriginInfo":
            return OriginInfo
        return super().find_class(module, name)


# numpy's public readers of the .npy header versions that np.savez writes
# for an object array.
_HEADER_READERS = {(1, 0): npformat.read_array_header_1_0,
                   (2, 0): npformat.read_array_header_2_0}


def _read_origins_entry(npz_path):
    """The {id: OriginInfo} dict of a segmentation npz's 'origins' entry,
    or {} if the file has none.

    np.load's own pickle.load cannot be given a custom unpickler, so this
    opens the zip member directly.
    """
    with zipfile.ZipFile(npz_path) as z:
        if "origins.npy" not in z.namelist():
            return {}
        with z.open("origins.npy") as f:
            version = npformat.read_magic(f)
            if version not in _HEADER_READERS:
                raise ValueError(f"{npz_path}: origins.npy has .npy format "
                                 f"version {version}")
            _HEADER_READERS[version](f)
            # latin1: google/ffn's files were pickled by Python 2.
            arr = _CompatUnpickler(f, encoding="latin1").load()
    return arr.item() if isinstance(arr, np.ndarray) else arr


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


def legacy_segmentation_path(output_dir, corner):
    return legacy_subvolume_path(output_dir, corner, "npz")


def get_existing_subvolume_path(segmentation_dir, corner,
                                allow_cpoint=False) -> Optional[str]:
    """Path to an existing subvolume (current or legacy layout), or None."""
    candidates = [segmentation_path(segmentation_dir, corner),
                  legacy_segmentation_path(segmentation_dir, corner)]
    if allow_cpoint:
        candidates.append(checkpoint_path(segmentation_dir, corner))
    return next((t for t in candidates if os.path.exists(t)), None)


def load_origins(segmentation_dir, corner):
    """{id: OriginInfo} of an existing subvolume segmentation."""
    target = get_existing_subvolume_path(segmentation_dir, corner)
    if target is None:
        raise ValueError(
            f"Segmentation not found: {segmentation_dir}, {corner}")
    return _read_origins_entry(target)


def load_segmentation(segmentation_dir, corner, allow_cpoint=False,
                      split_cc=True, min_size=0):
    """Loads an FFN subvolume segmentation (storage.py:429-471, without its
    threshold and mask options). Returns (uint64 segmentation, {id:
    OriginInfo}); split_cc and min_size clean it up as the JAX package
    does, renumbering the origins with it."""
    target = get_existing_subvolume_path(segmentation_dir, corner,
                                         allow_cpoint)
    if target is None:
        raise ValueError(
            f"Segmentation not found, {segmentation_dir}, {corner!r}.")
    with np.load(target) as data:
        if "segmentation" not in data:
            raise ValueError(
                f"FFN NPZ file {target} does not contain a segmentation.")
        output = data["segmentation"].astype(np.uint64)
    origins = _read_origins_entry(target)
    logging.info("loading segmentation from: %s", target)
    if split_cc or min_size:
        new_to_old = segmentation.clean_up(output, split_cc, min_size,
                                           return_id_map=True)
        origins = {new_id: origins[old_id]
                   for new_id, old_id in new_to_old.items()
                   if old_id in origins}
    return output, origins


def clip_subvolume_to_bounds(corner, size, volume):
    """Clips (corner, size) (ZYX) to the volume bounds."""
    volume_size = np.asarray(volume.shape[-3:])
    start = np.clip(np.asarray(corner), 0, volume_size)
    end = np.clip(np.asarray(corner) + np.asarray(size), 0, volume_size)
    return start, np.maximum(end - start, 0)
