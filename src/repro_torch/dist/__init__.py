"""Distribution layer of the port: the range-partitioned filter bank, the
multi-tenant bank with its meta rows (each with a ``torch.distributed``
variant), and ``repro.dist.compression``'s two codecs: the int8 error
feedback of the train step and the Elias-Fano codec that run snapshots
use.  The sharding specs and pipeline parallelism of ``repro.dist`` are
ROADMAP A.11.5."""
from .compression import (ef_compress, ef_init, elias_fano_decode,
                          elias_fano_encode, elias_fano_size_bits,
                          pack_filter_state, unpack_filter_state)
from .filter_bank import FilterBank, ShardedFilterBank
from .tenant_bank import (AgingTenantBank, ShardedTenantFilterBank,
                          TenantFilterBank, replica_groups)

__all__ = ["ef_init", "ef_compress", "elias_fano_encode", "elias_fano_decode", "elias_fano_size_bits",
           "pack_filter_state", "unpack_filter_state",
           "FilterBank", "ShardedFilterBank",
           "TenantFilterBank", "ShardedTenantFilterBank", "AgingTenantBank",
           "replica_groups"]
