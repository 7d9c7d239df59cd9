"""The batched data plane of the port: vector grains, arenas, the tick."""

from orleans_tpu_torch.tensor.vector_grain import (
    Batch,
    Emit,
    VectorGrain,
    field,
    scatter_add_rows,
    scatter_rows,
    seg_max,
    seg_mean,
    seg_sum,
    vector_grain,
)
from orleans_tpu_torch.tensor.engine import TensorEngine
from orleans_tpu_torch.tensor.streams_plane import DeviceSubscriptions

__all__ = [
    "Batch",
    "DeviceSubscriptions",
    "Emit",
    "TensorEngine",
    "VectorGrain",
    "field",
    "scatter_add_rows",
    "scatter_rows",
    "seg_max",
    "seg_mean",
    "seg_sum",
    "vector_grain",
]
