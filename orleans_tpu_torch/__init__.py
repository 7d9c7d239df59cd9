"""PyTorch/CUDA port of the orleans_tpu data plane.

A second package beside ``orleans_tpu``: the same virtual-actor model
(grains as rows of columnar state, the batched tick that resolves,
applies and routes), written in PyTorch and run on an NVIDIA Hopper card.
The hot programs of the tick are CUDA C++ kernels in ``csrc/``, built at
first use (``kernels/_build.py``).

The port imports ``torch`` and ``numpy`` only — never ``jax`` and nothing
of ``orleans_tpu``; it keeps its own copy of the host helpers it needs.
Layout mirrors ``orleans_tpu`` module for module (``tensor/engine.py`` ↔
``orleans_tpu/tensor/engine.py``, ...), with the same class and function
names.
"""
