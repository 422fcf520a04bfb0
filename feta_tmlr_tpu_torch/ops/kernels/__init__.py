"""Hand-written CUDA kernels (sources in `csrc/`) with their wrappers,
plain PyTorch versions and launch counters."""
