"""Chunked streaming ingest (``runner``): T filter steps per device loop,
one transfer each way per chunk."""
from repro_torch.stream.runner import (ChunkSummary, FleetChunkSummary,
                                       StreamRunner)

__all__ = ["ChunkSummary", "FleetChunkSummary", "StreamRunner"]
