"""Hand-written CUDA kernels of the tick and their plain PyTorch versions.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors (or raises); there is no fallback in between.
"""
