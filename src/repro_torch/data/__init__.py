"""Synthetic generators shaped like the paper's datasets, libsvm text IO,
the host-to-device chunk path of the stream driver, and the LM trainer's
token batcher."""
from .libsvm import (iter_libsvm, load_libsvm, parse_libsvm_line,  # noqa: F401
                     save_libsvm)
from .pipeline import (ChunkPrefetcher, DevicePlacer, PageLock,  # noqa: F401
                       RetryStats, ShardedBatcher, pad_features_to,
                       reservoir_rows, retrying_chunks, rows_to_device)
from .synthetic import (make_alpha_like, make_blobs,  # noqa: F401
                        make_circles, make_dna_like, make_lm_tokens,
                        make_mnist8m_like, make_year_like)
