"""Distribution layer of the port: so far the Elias-Fano codec of
``repro.dist.compression`` that run snapshots use (the filter banks are
ROADMAP A.9, the training strata A.11)."""
from .compression import (elias_fano_decode, elias_fano_encode,
                          elias_fano_size_bits, pack_filter_state,
                          unpack_filter_state)

__all__ = ["elias_fano_encode", "elias_fano_decode", "elias_fano_size_bits",
           "pack_filter_state", "unpack_filter_state"]
