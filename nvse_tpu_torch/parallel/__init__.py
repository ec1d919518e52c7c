"""Data and sequence parallelism over torch.distributed (counterpart of
nvse_tpu/parallel)."""
from .collectives import (all_gather_dim, all_reduce_mean_, all_to_all_dims, local_slice,
                          mesh_barrier, replicated, split_sizes)
from .mesh import (DATA_AXIS, SEQ_AXIS, axis_rank, axis_size, get_mesh, init_distributed,
                   local_devices, node_shape, seq_group, shard_batch, spawn)
