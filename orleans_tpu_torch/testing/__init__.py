"""In-process clusters of port silos."""

from orleans_tpu_torch.testing.cluster import TestingCluster

__all__ = ["TestingCluster"]
