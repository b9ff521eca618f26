"""Multi-device parallelism for the codec pipeline (the port of
ako_tpu/parallel/):

- `tiles`: tile-data-parallelism — the independent-tile grid of each
  shape group cut over a mesh axis, each shard running the one-device
  encode / decode on its tiles on its own stream.
- `halo`: sharded-single-tile lifting — one huge tile's rows sharded
  over the mesh, each sharded level lifted by one K7 launch per device
  (csrc/lift_level.cu's shard-table instances) that reads its shards'
  rows and halos in place, only rows held on another device copied.
- `multihost`: images sharded over processes (gloo), no codec byte
  crossing them.
"""

from ako_tpu_torch.parallel.mesh import make_mesh
from ako_tpu_torch.parallel.halo import forward_tile_sharded, inverse_tile_sharded

__all__ = ["make_mesh", "forward_tile_sharded", "inverse_tile_sharded"]
