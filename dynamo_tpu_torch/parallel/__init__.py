"""Tensor and data parallelism of the port: the mesh and its sharding
rules (mesh.py), and one process per rank driven by the leader's step
stream (multihost.py).  The counterpart of dynamo_tpu/parallel/."""

from .mesh import MeshConfig, make_mesh, param_sharding_rules

__all__ = ["MeshConfig", "make_mesh", "param_sharding_rules"]
