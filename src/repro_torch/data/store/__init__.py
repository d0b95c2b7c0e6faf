"""The port's out-of-core chunked data plane (`repro.data.store`).

A dataset too large for host RAM lives on disk as fixed-size row chunks
plus a JSON index (`writer.StoreWriter`), in the JAX package's format
(``repro.chunkstore/1``) byte for byte; `reader.ChunkStore` reads it
back chunk by chunk with an LRU cache, an optional background
prefetcher and read metrics; `source.store_permutation` orders the rows
so that the nested prefix reads each chunk about once per pass, and
`source.StoredShardSource` deals them onto the mesh engines' shards.
"""
from repro_torch.data.store.reader import ChunkStore, StoreMetrics
from repro_torch.data.store.source import (StoredShardSource,
                                           dataset_fingerprint,
                                           store_permutation)
from repro_torch.data.store.writer import StoreWriter, write_store

__all__ = ["ChunkStore", "StoreMetrics", "StoreWriter", "StoredShardSource",
           "dataset_fingerprint", "store_permutation", "write_store"]
