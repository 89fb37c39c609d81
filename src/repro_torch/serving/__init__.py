"""Serving: the online embedding engine and train->serve publication.

`OnlineEmbeddingEngine` (with the publisher's `TablePublisher` /
`OnlineTrainer` / delta helpers) is the paper's continuous-online-storage
read path.  The reference's LM decode engine (``ServingEngine``) waits for
the LM stack.
"""

from repro_torch.serving.embedding_engine import (  # noqa: F401
    EmbeddingRequest,
    EngineMetrics,
    OnlineEmbeddingEngine,
    WaveReport,
)
from repro_torch.serving.publisher import (  # noqa: F401
    OnlineTrainer,
    StaticSource,
    TableDelta,
    TablePublisher,
    TableSource,
    export_delta,
    ingest_delta,
)
