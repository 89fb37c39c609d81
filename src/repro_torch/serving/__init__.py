"""Serving layer: the LM wave engine and the online embedding engine.

`OnlineEmbeddingEngine` (with the publisher's `TablePublisher` /
`OnlineTrainer` / delta helpers) is the paper's continuous-online-storage
read path; `ServingEngine` is the LM decode wave engine.
"""

from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
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
