"""Seeded synthetic data."""

from repro_torch.data.synthetic import zipf_keys, zipf_ranks  # noqa: F401
