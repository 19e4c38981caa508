"""ModelDeploymentCard: everything a frontend needs to serve a model.

A copy of dynamo_tpu/protocols/model_card.py: workers publish it under
`v1/mdc/{namespace}/{model_slug}/{instance_id}` and the frontend's
ModelWatcher consumes it.  It carries the tokenizer's identity, the chat
template, KV block size, context length and the runtime config (capacity
hints for routing and planning).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..runtime.discovery import MDC_PREFIX


def model_slug(name: str) -> str:
    return name.replace("/", "--")


@dataclass
class ModelDeploymentCard:
    name: str
    namespace: str = "dynamo"
    component: str = "backend"
    endpoint: str = "generate"
    model_type: str = "chat"  # chat | completions | embedding | encoder
    # tokenizer: {"type": "byte"} or {"type": "hf", "path"/"json": ...}
    tokenizer: Dict[str, Any] = field(default_factory=lambda: {"type": "byte"})
    chat_template: Optional[str] = None
    context_length: int = 8192
    kv_cache_block_size: int = 64
    migration_limit: int = 0
    runtime_config: Dict[str, Any] = field(default_factory=dict)

    def key(self, instance_id: Optional[int] = None) -> str:
        """MDC discovery key.  Per-worker keys (with instance_id) let many
        workers serve one model: the frontend drops the model only when the
        LAST worker's card disappears."""
        base = f"{MDC_PREFIX}/{self.namespace}/{model_slug(self.name)}"
        return f"{base}/{instance_id}" if instance_id is not None else base

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "namespace": self.namespace,
            "component": self.component,
            "endpoint": self.endpoint,
            "model_type": self.model_type,
            "tokenizer": self.tokenizer,
            "chat_template": self.chat_template,
            "context_length": self.context_length,
            "kv_cache_block_size": self.kv_cache_block_size,
            "migration_limit": self.migration_limit,
            "runtime_config": self.runtime_config,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ModelDeploymentCard":
        return ModelDeploymentCard(
            name=d["name"],
            namespace=d.get("namespace", "dynamo"),
            component=d.get("component", "backend"),
            endpoint=d.get("endpoint", "generate"),
            model_type=d.get("model_type", "chat"),
            tokenizer=d.get("tokenizer", {"type": "byte"}),
            chat_template=d.get("chat_template"),
            context_length=d.get("context_length", 8192),
            kv_cache_block_size=d.get("kv_cache_block_size", 64),
            migration_limit=d.get("migration_limit", 0),
            runtime_config=d.get("runtime_config", {}),
        )


async def register_model(runtime, card: ModelDeploymentCard,
                         instance_id: Optional[int] = None) -> None:
    """Publish the MDC."""
    await runtime.discovery.put(card.key(instance_id), card.to_dict())


async def deregister_model(runtime, card: ModelDeploymentCard,
                           instance_id: Optional[int] = None) -> None:
    await runtime.discovery.delete(card.key(instance_id))
