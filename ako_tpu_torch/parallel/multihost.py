"""Multi-process batch pipeline (the port of ako_tpu/parallel/multihost.py).

The scaling tiers: tiles of one image batched in one launch; the tile
grid sharded over a process's devices (a "tiles" mesh axis, parallel/
tiles.py); and *images* sharded over processes: each process encodes its
images end to end (tiles stay process-local, so no bitstream byte crosses
processes), and only the finished blobs are the caller's.

Images are fully independent, so the process tier needs no
communication beyond work distribution. `initialize()` joins a
torch.distributed group over gloo (which also serves several processes
sharing one card, and the CPU tests), `global_mesh()` names every
process's devices, and `HostShardedPipeline` runs the port's streaming
executor (runtime/executor.py) over this process's shard of the image
stream. With no group (process_count == 1) everything runs locally.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from ako_tpu_torch.core.settings import Settings
from ako_tpu_torch.parallel.mesh import Mesh, make_mesh
from ako_tpu_torch.runtime.executor import PipelineDecoder, PipelineEncoder


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the process group at `coordinator_address` ("host:port", the
    rank 0 process's) as rank `process_id` of `num_processes`, over gloo.
    A no-op when the arguments are absent (one process)."""
    if coordinator_address is None and num_processes is None:
        return
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )


def process_info() -> Tuple[int, int]:
    """(process_index, process_count)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(axis_names: Sequence[str] = ("hosts", "tiles"), devices=None) -> Mesh:
    """Process-wide mesh of shape {"hosts": process_count, "tiles": local
    devices}: row p names process p's devices by their local index (each
    process addresses only its own row). `devices`: this process's, None
    meaning every CUDA device (raising without one)."""
    local = make_mesh(devices=devices).axis_devices("tiles")
    _, n_proc = process_info()
    grid = np.empty((n_proc, len(local)), dtype=object)
    for row in range(n_proc):
        grid[row, :] = local
    return Mesh(grid, axis_names)


def shard_stream(items: List, process_id: int, process_count: int) -> List:
    """Round-robin assignment of a work list to this process."""
    return items[process_id::process_count]


class HostShardedPipeline:
    """Encode/decode a globally-indexed image stream across processes:
    every process runs the streaming pipeline on its round-robin shard;
    results carry their global index so the caller can re-order (or
    write to per-index destinations, avoiding any gather). `device` as
    the executor's: None means the CUDA card."""

    def __init__(self, settings: Optional[Settings] = None, workers: int = 4, device=None):
        self.settings = settings
        self.workers = workers
        self.device = device

    def encode_shard(
        self, images: List[np.ndarray]
    ) -> Iterator[Tuple[int, bytes]]:
        pid, pcount = process_info()
        mine = shard_stream(list(enumerate(images)), pid, pcount)
        enc = PipelineEncoder(self.settings, workers=self.workers, device=self.device)
        for (gidx, _), blob in zip(mine, enc.encode_iter(img for _, img in mine)):
            yield gidx, blob

    def decode_shard(self, blobs: List[bytes]) -> Iterator[Tuple[int, np.ndarray]]:
        pid, pcount = process_info()
        mine = shard_stream(list(enumerate(blobs)), pid, pcount)
        dec = PipelineDecoder(workers=self.workers, device=self.device)
        for (gidx, _), img in zip(mine, dec.decode_iter(b for _, b in mine)):
            yield gidx, img
