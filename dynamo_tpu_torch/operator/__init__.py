"""Deployment operator: declarative graph spec -> reconciled Deployments.

A copy of dynamo_tpu/operator/ for the port.  The graph spec lives in a
ConfigMap (`dynamo.dev/graph: "1"`-labeled), so any cluster works
without CRD install rights, and a Python reconcile loop (`python -m
dynamo_tpu_torch.operator`) renders the spec into plain apps/v1
Deployments — the same objects deploy/torch/*.yaml hand-write — and
keeps them converged: create on add, merge-patch on drift
(image/replicas/args/env roll pods via the Deployment's own
rolling-update machinery), delete on removal.  Scale-subresource writes
from the planner's KubernetesConnector are preserved on spec-unrelated
reconciles (replicas drift is only corrected when the spec's own
replica count changed).

Where it differs from the JAX operator, by design: components run the
port's modules (`dynamo_tpu_torch.*`); a component's accelerator field
is `gpu`, rendered as the `nvidia.com/gpu` limit (JAX's `tpu` renders
`google.com/tpu`); a model-running component (worker, multimodal) with
no GPU is asked for the CPU with `--device cpu`, the port's switch, in
place of JAX's `JAX_PLATFORMS=cpu` environment; and the reconciler
speaks HTTP through the port's standard-library client
(runtime/http.py) instead of aiohttp.
"""

from .reconciler import GraphOperator
from .spec import GraphSpec, render_deployments

__all__ = ["GraphSpec", "render_deployments", "GraphOperator"]
