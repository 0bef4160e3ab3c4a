"""Benchmark of the PyTorch and CUDA port (`icepy4d_tpu_torch`) on
NVIDIA H100 cards; `python3 -m h100_bench --help`. Nothing here imports
JAX or the JAX package."""
