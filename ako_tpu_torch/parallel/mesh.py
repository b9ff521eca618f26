"""Device meshes: the port's counterpart of jax.sharding.Mesh
(ako_tpu/parallel/mesh.py).

A Mesh is a numpy object array of torch.devices with a name per axis,
and a device may repeat: eight shards on `cuda:0` run every line of the
sharded code on one card, and `[torch.device("cpu")] * 8` runs it in the
CPU tests. A sharded function uses the devices along its named axis, in
the first line of the other axes. Each position of the mesh is a Shard
with its own CUDA stream, made once per mesh and position, also when
shards share a device, so that the event ordering that several cards need
is exercised on one.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import numpy as np
import torch


class Shard:
    """One mesh position: its device and, on a CUDA device, its own
    stream. Work for the shard is enqueued inside `use()`; `record()`
    marks what has been enqueued so far, for other shards to wait on."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def use(self):
        """The shard's stream as the current stream of its device."""
        return contextlib.nullcontext() if self.stream is None else torch.cuda.stream(self.stream)

    def record(self):
        """An event after the work enqueued on the shard's stream so far
        (None on the CPU, where work is done when it returns)."""
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def wait(self, event) -> None:
        """Later work on the shard's stream waits for `event`."""
        if event is not None:
            self.stream.wait_event(event)

    def synchronize(self) -> None:
        """Block the host until the shard's stream is done."""
        if self.stream is not None:
            self.stream.synchronize()


class Caller(Shard):
    """The caller's current stream on `device`, as a Shard: where a
    sharded function's inputs were made and its outputs are returned."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.current_stream(device) if device.type == "cuda" else None


class Mesh:
    """An N-D grid of torch.devices with named axes; `shape` is a dict
    {axis name: size}, as JAX's."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} with axis names {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self._shards = np.empty(devices.shape, dtype=object)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def _line(self, axis_name: str) -> tuple:
        if axis_name not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis_name!r}: {self.axis_names}")
        idx = [0] * self.devices.ndim
        idx[self.axis_names.index(axis_name)] = slice(None)
        return tuple(idx)

    def axis_devices(self, axis_name: str) -> list:
        """The devices along `axis_name`, in the first line of the other
        axes."""
        return list(self.devices[self._line(axis_name)])

    def shards(self, axis_name: str) -> list:
        """The Shards along `axis_name` (first line of the other axes),
        each made once per mesh position."""
        line = self._line(axis_name)
        out = []
        for pos in np.ndindex(self.devices.shape):
            if all(isinstance(i, slice) or i == p for i, p in zip(line, pos)):
                if self._shards[pos] is None:
                    self._shards[pos] = Shard(self.devices[pos])
                out.append(self._shards[pos])
        return out


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("tiles",),
    devices=None,
) -> Mesh:
    """1-D (default) or N-D mesh over `devices`: None means every CUDA
    device, and raises when there is none (never the CPU). A device may
    repeat; the CPU tests pass [torch.device("cpu")] * 8.

    The codec's primary axis is "tiles" (independent-tile data
    parallelism); halo-sharded single-tile mode uses a "rows" axis."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[torch.device('cpu')] * n "
                               "to run the plain torch path")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devices),)
    n = math.prod(shape)
    if n > len(devices) or n < 1:
        raise ValueError(f"make_mesh: shape {tuple(shape)} needs {n} devices, got {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(tuple(shape)), axis_names)
