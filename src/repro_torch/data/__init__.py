"""Seeded synthetic data: Zipfian key streams and request arrival sizes."""

from repro_torch.data.synthetic import (ARRIVAL_KINDS, arrival_sizes,  # noqa: F401
                                        poisson_burst_sizes, sinusoidal_sizes, steady_sizes,
                                        zipf_keys, zipf_ranks)
