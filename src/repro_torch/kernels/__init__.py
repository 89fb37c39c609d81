"""Hand-written CUDA kernels (sources in ``repro_torch/csrc``) with their
plain PyTorch versions, and the wrappers that bind them."""
