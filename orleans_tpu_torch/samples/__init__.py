"""Sample workloads of the port."""
