"""Seeded synthetic data (Zipfian key streams, request arrival sizes, LM
token batches) and the host-side input pipeline."""

from repro_torch.data.pipeline import DataCursor, HostPrefetcher  # noqa: F401
from repro_torch.data.synthetic import (ARRIVAL_KINDS, TokenStream, arrival_sizes,  # noqa: F401
                                        poisson_burst_sizes, sinusoidal_sizes, steady_sizes,
                                        zipf_keys, zipf_ranks)
