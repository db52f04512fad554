"""Distribution layer of the port: the range-partitioned filter bank, the
multi-tenant bank with its meta rows (each with a ``torch.distributed``
variant), and the Elias-Fano codec of ``repro.dist.compression`` that run
snapshots use.  The training strata of ``repro.dist`` (sharding specs,
pipeline parallelism, int8 gradient compression) are ROADMAP A.11."""
from .compression import (elias_fano_decode, elias_fano_encode,
                          elias_fano_size_bits, pack_filter_state,
                          unpack_filter_state)
from .filter_bank import FilterBank, ShardedFilterBank
from .tenant_bank import (AgingTenantBank, ShardedTenantFilterBank,
                          TenantFilterBank, replica_groups)

__all__ = ["elias_fano_encode", "elias_fano_decode", "elias_fano_size_bits",
           "pack_filter_state", "unpack_filter_state",
           "FilterBank", "ShardedFilterBank",
           "TenantFilterBank", "ShardedTenantFilterBank", "AgingTenantBank",
           "replica_groups"]
