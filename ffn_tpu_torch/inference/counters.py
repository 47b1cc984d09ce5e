"""Thread-safe counters and timers (ffn_tpu/inference/counters.py:
StatCounter, Counters, timer_counter, TimedIter). Saved segmentations
(`dumps`) and checkpoints (`dumps_np`) carry them as a serialized
TaskCounters proto, as JAX's do; protobuf is imported only there.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterable, Iterator, Optional

import numpy as np

MSEC_IN_SEC = 1000


class StatCounter:
    """A thread-safe integer counter that also propagates to a parent."""

    def __init__(self, parent: Optional["StatCounter"] = None):
        self._value = 0
        self._lock = threading.Lock()
        self._parent = parent

    def IncrementBy(self, x):
        with self._lock:
            self._value += int(x)
        if self._parent is not None:
            self._parent.IncrementBy(x)

    def Increment(self):
        self.IncrementBy(1)

    def Set(self, x):
        with self._lock:
            self._value = int(x)

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def Get(self) -> int:
        return self.value

    def Reset(self):
        self.Set(0)


class Counters:
    """A registry of named StatCounters with optional parent propagation."""

    def __init__(self, parent: Optional["Counters"] = None):
        self._lock = threading.Lock()
        self._parent = parent
        self._counters: dict[str, StatCounter] = {}

    def __getitem__(self, name: str) -> StatCounter:
        with self._lock:
            counter = self._counters.get(name)
            if counter is None:
                parent_counter = None
                if self._parent is not None:
                    parent_counter = self._parent[name]
                counter = StatCounter(parent=parent_counter)
                self._counters[name] = counter
            return counter

    def get_sub_counters(self) -> "Counters":
        return Counters(parent=self)

    def reset(self):
        with self._lock:
            for counter in self._counters.values():
                counter.Reset()

    def __iter__(self):
        with self._lock:
            return iter(sorted(self._counters.items()))

    def dump(self, path: str):
        with open(path, "w") as f:
            for name, counter in self:
                f.write(f"{name}: {counter.value}\n")

    def dumps(self) -> bytes:
        """All counters as a serialized TaskCounters proto: a saved
        segmentation's `counters` entry, the JAX package's bytes."""
        from ffn_tpu_torch.proto import inference_pb2   # needs protobuf
        proto = inference_pb2.TaskCounters()
        for name, counter in self:
            proto.counters.add(name=name, value=counter.value)
        return proto.SerializeToString()

    def loads(self, encoded):
        """Sets the counters of a serialized TaskCounters proto.

        np.savez stores `dumps()`'s bytes as an S-dtype scalar, which drops
        trailing NUL bytes, i.e. a final varint 0: up to two are put back,
        as the JAX package's reader does.
        """
        from ffn_tpu_torch.proto import inference_pb2
        from google.protobuf.message import DecodeError
        encoded = bytes(encoded)
        proto = inference_pb2.TaskCounters()
        for pad in (b"", b"\x00", b"\x00\x00"):
            try:
                proto.ParseFromString(encoded + pad)
                break
            except DecodeError:
                if pad == b"\x00\x00":
                    raise
        for entry in proto.counters:
            self[entry.name].Set(entry.value)

    def dumps_np(self) -> np.ndarray:
        """`dumps()` in a uint8 array (which round-trips through npz with
        every byte): the checkpoint entry, so either package restores the
        other's checkpoints."""
        return np.frombuffer(self.dumps(), dtype=np.uint8)

    def loads_np(self, obj):
        self.loads(np.asarray(obj, dtype=np.uint8).tobytes())


@contextlib.contextmanager
def timer_counter(counters: Counters, name: str):
    """Counts calls ('<name>-calls') and wall time ('<name>-time-ms')."""
    t0 = time.time()
    try:
        yield
    finally:
        dt = time.time() - t0
        counters[name + "-calls"].Increment()
        counters[name + "-time-ms"].IncrementBy(dt * MSEC_IN_SEC)


class TimedIter:
    """Wraps an iterator, charging the time of each next() to a counter."""

    def __init__(self, it: Iterable, counters: Counters, name: str):
        self.it = iter(it)
        self.counters = counters
        self.name = name

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        with timer_counter(self.counters, self.name):
            return next(self.it)
