"""Mesh layer of the port (mirrors repro.distributed): the row-shard layout
of distributed serving, the model-sharding rules (``sharding``), their
explicit tensor / sequence / data parallelism (``tensor_parallel``), the
collectives and elastic reshards (``elastic``)."""
from repro_torch.distributed.collectives import all_gather, psum, take_rows
from repro_torch.distributed.sharding import (RowSharding, current_mesh,
                                              row_sharding, shard_act, use_mesh)

__all__ = ["RowSharding", "all_gather", "current_mesh", "psum",
           "row_sharding", "shard_act", "take_rows", "use_mesh"]
