"""Hand-written CUDA kernels (sources in csrc/), their plain twins and wrappers."""
