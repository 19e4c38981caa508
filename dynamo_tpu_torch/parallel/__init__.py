"""Tensor, data and sequence parallelism of the port: the mesh, its
groups and sharding rules (mesh.py), one process per rank driven by the
leader's step stream (multihost.py), and the pipeline primitive
(pipeline.py).  The counterpart of dynamo_tpu/parallel/."""

from .mesh import MeshConfig, make_mesh, param_sharding_rules

__all__ = ["MeshConfig", "make_mesh", "param_sharding_rules"]
