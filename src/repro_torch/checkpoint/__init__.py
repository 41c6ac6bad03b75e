"""Fault-tolerant checkpointing (async, atomic, keep-K, elastic restore,
epoch-fenced multi-writer safety), on the reference's on-disk layout."""
from .checkpointer import (Checkpointer, CheckpointWriteError,  # noqa: F401
                           FencedCommitError, FencedWriterError,
                           advance_fence, read_fence)
