"""Mesh layer of the port (mirrors repro.distributed): the row-shard layout
and the collectives of distributed serving."""
from repro_torch.distributed.collectives import all_gather, psum, take_rows
from repro_torch.distributed.sharding import (RowSharding, current_mesh,
                                              row_sharding, shard_act, use_mesh)

__all__ = ["RowSharding", "all_gather", "current_mesh", "psum",
           "row_sharding", "shard_act", "take_rows", "use_mesh"]
