"""Parallelism: FSDP2 sharding of the model over the mesh."""
