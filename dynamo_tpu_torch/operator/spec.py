"""Graph spec model + Deployment rendering.

A copy of dynamo_tpu/operator/spec.py: a plain JSON document in a
ConfigMap (component name -> replicas/image/resources/envs), rendered
into the manifest shapes deploy/torch/*.yaml document by hand.  The
port's divergences (module names, the `gpu` field rendered as
`nvidia.com/gpu`, `--device cpu` for a model-running component without
a GPU in place of `JAX_PLATFORMS=cpu`) are listed in operator/__init__.py.
Manifests hash what the spec controls, so a spec rendered through both
packages gives different spec hashes by construction.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

GRAPH_LABEL = "dynamo.dev/graph"          # marks spec ConfigMaps
GRAPH_NAME_LABEL = "dynamo.dev/graph-name"
COMPONENT_LABEL = "dynamo.dev/component"
HASH_ANN = "dynamo.dev/spec-hash"
REPLICAS_ANN = "dynamo.dev/spec-replicas"

# component kind -> (module, default args); the worker kinds add
# role/model flags in render
_KIND_MODULE = {
    "frontend": "dynamo_tpu_torch.frontend",
    "worker": "dynamo_tpu_torch.engine",
    "mocker": "dynamo_tpu_torch.mocker",
    "planner": "dynamo_tpu_torch.planner",
    "router": "dynamo_tpu_torch.router",
    "multimodal": "dynamo_tpu_torch.multimodal",
}
# kinds whose CLI runs a model and takes `--device` (CUDA by default)
_DEVICE_KINDS = ("worker", "multimodal")
GPU_RESOURCE = "nvidia.com/gpu"


@dataclass
class ComponentSpec:
    name: str
    kind: str                      # frontend | worker | mocker | planner...
    replicas: int = 1
    role: str = ""                 # worker kinds: decode | prefill | both
    args: List[str] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)
    gpu: int = 0                   # nvidia.com/gpu resource limit
    port: Optional[int] = None


@dataclass
class GraphSpec:
    name: str
    image: str
    components: Dict[str, ComponentSpec]
    model_name: str = ""
    model_path: str = ""
    cluster_id: str = "default"
    service_account: str = "dynamo-tpu"
    namespace: str = ""

    @classmethod
    def parse(cls, doc: Dict[str, Any]) -> "GraphSpec":
        """Validate + normalize a spec document (the ConfigMap's
        data["spec"] JSON)."""
        if not isinstance(doc, dict):
            raise ValueError("graph spec must be a JSON object")
        name = doc.get("name")
        image = doc.get("image")
        comps = doc.get("components")
        if not name or not isinstance(name, str):
            raise ValueError("graph spec needs a string 'name'")
        if not image or not isinstance(image, str):
            raise ValueError(f"graph {name!r}: spec needs 'image'")
        if not isinstance(comps, dict) or not comps:
            raise ValueError(f"graph {name!r}: spec needs 'components'")
        model = doc.get("model") or {}
        out: Dict[str, ComponentSpec] = {}
        for cname, c in comps.items():
            if not isinstance(c, dict):
                raise ValueError(
                    f"graph {name!r}: component {cname!r} must be an "
                    "object")
            kind = c.get("kind", cname)
            if kind not in _KIND_MODULE:
                raise ValueError(
                    f"graph {name!r}: component {cname!r} has unknown kind "
                    f"{kind!r} (expected one of {sorted(_KIND_MODULE)})")
            out[cname] = ComponentSpec(
                name=cname, kind=kind,
                replicas=int(c.get("replicas", 1)),
                role=c.get("role", ""),
                args=[str(a) for a in c.get("args", [])],
                env={str(k): str(v) for k, v in (c.get("env") or {}).items()},
                gpu=int(c.get("gpu", 0)),
                port=c.get("port"),
            )
        return cls(
            name=name, image=image, components=out,
            model_name=model.get("name", ""),
            model_path=model.get("path", ""),
            cluster_id=doc.get("cluster_id", "default"),
            service_account=doc.get("service_account", "dynamo-tpu"),
            namespace=doc.get("namespace", ""),
        )


def _command(spec: GraphSpec, c: ComponentSpec) -> List[str]:
    cmd = ["python", "-m", _KIND_MODULE[c.kind]]
    if c.kind == "worker":
        if spec.model_path:
            cmd += ["--model-path", spec.model_path]
        if c.role:
            cmd += ["--role", c.role]
    if c.kind == "frontend" and c.port:
        cmd += ["--port", str(c.port)]
    if c.kind in _DEVICE_KINDS and c.gpu == 0:
        # the port's entry points run on the card unless asked for the
        # CPU, and a pod without a GPU has none
        cmd += ["--device", "cpu"]
    return cmd + c.args


def deployment_name(spec: GraphSpec, cname: str) -> str:
    return f"{spec.name}-{cname}"


def render_deployments(spec: GraphSpec) -> Dict[str, Dict[str, Any]]:
    """spec -> {deployment name: apps/v1 Deployment manifest}.

    The manifest carries HASH_ANN (hash of everything the spec controls
    EXCEPT replicas) and REPLICAS_ANN (the spec's replica count) so the
    reconciler can tell spec drift from planner-driven scaling."""
    out: Dict[str, Dict[str, Any]] = {}
    for cname, c in spec.components.items():
        dname = deployment_name(spec, cname)
        labels = {
            "app": dname,
            GRAPH_NAME_LABEL: spec.name,
            COMPONENT_LABEL: cname,
        }
        env = {
            "DYN_DISCOVERY_BACKEND": "kubernetes",
            "DYN_CLUSTER_ID": spec.cluster_id,
            **c.env,
        }
        container: Dict[str, Any] = {
            "name": c.kind,
            "image": spec.image,
            "command": _command(spec, c),
            "env": [{"name": k, "value": v} for k, v in sorted(env.items())],
        }
        if c.port:
            container["ports"] = [{"containerPort": int(c.port)}]
        if c.gpu > 0:
            container["resources"] = {
                "limits": {GPU_RESOURCE: str(c.gpu)}}
        template = {
            "metadata": {"labels": dict(labels)},
            "spec": {
                "serviceAccountName": spec.service_account,
                "containers": [container],
            },
        }
        spec_hash = hashlib.sha256(json.dumps(
            {"template": template, "image": spec.image},
            sort_keys=True).encode()).hexdigest()[:16]
        out[dname] = {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {
                "name": dname,
                "labels": dict(labels),
                "annotations": {
                    HASH_ANN: spec_hash,
                    REPLICAS_ANN: str(c.replicas),
                },
            },
            "spec": {
                "replicas": c.replicas,
                "selector": {"matchLabels": {"app": dname}},
                # surge-style rolling update: new pods come up before old
                # ones drain, so a worker fleet never drops to zero on an
                # image/args change
                "strategy": {
                    "type": "RollingUpdate",
                    "rollingUpdate": {"maxUnavailable": 0, "maxSurge": 1},
                },
                "template": template,
            },
        }
    return out
