"""Distribution layer of the port (counterpart of ``repro.dist``).

Modules:
  sharding     -- spec trees and DTensor placements for params/batch/cache
                  of every model on a ``DeviceMesh``
  pipeline     -- microbatched pipeline parallelism over a mesh axis
  compression  -- int8 error-feedback gradient compression + Elias-Fano
                  encoding of sorted posting lists / filter-state snapshots
  filter_bank  -- the range-partitioned filter bank (and its
                  ``torch.distributed`` variant)
  tenant_bank  -- the multi-tenant bank with its meta rows and read
                  replicas over a replica group
"""
from .compression import (ef_compress, ef_init, elias_fano_decode,
                          elias_fano_encode, elias_fano_size_bits,
                          pack_filter_state, unpack_filter_state)
from .filter_bank import FilterBank, ShardedFilterBank
from .pipeline import pipeline_apply
from .sharding import Shardings, batch_axes_for, make_shardings, mesh_axis_sizes
from .tenant_bank import (AgingTenantBank, ShardedTenantFilterBank,
                          TenantFilterBank, replica_groups)

__all__ = ["Shardings", "batch_axes_for", "make_shardings", "mesh_axis_sizes",
           "pipeline_apply",
           "ef_init", "ef_compress", "elias_fano_encode", "elias_fano_decode", "elias_fano_size_bits",
           "pack_filter_state", "unpack_filter_state",
           "FilterBank", "ShardedFilterBank",
           "TenantFilterBank", "ShardedTenantFilterBank", "AgingTenantBank",
           "replica_groups"]
