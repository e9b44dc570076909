"""Data-parallel and spatially partitioned execution over torch.distributed
(the JAX package's parallel/)."""
