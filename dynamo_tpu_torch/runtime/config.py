"""Runtime configuration from the environment.

A copy of dynamo_tpu/runtime/config.py: the same `DYN_*` names and
defaults, so one deployment's environment configures a JAX worker and a
torch worker alike.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

_TRUTHY = {"1", "true", "yes", "on", "y", "t"}
_FALSY = {"0", "false", "no", "off", "n", "f", ""}


def parse_truthy(value: str | bool | None, default: bool = False) -> bool:
    """Canonical boolean env parsing."""
    if value is None:
        return default
    if isinstance(value, bool):
        return value
    v = value.strip().lower()
    if v in _TRUTHY:
        return True
    if v in _FALSY:
        return False
    raise ValueError(f"unrecognized boolean value: {value!r}")


def env_truthy(name: str, default: bool = False) -> bool:
    return parse_truthy(os.environ.get(name), default)


@dataclass
class RuntimeConfig:
    # discovery plane: mem | file | etcd | kubernetes
    discovery_backend: str = "mem"
    discovery_path: str = ""  # root dir for the file backend
    etcd_endpoint: str = ""   # etcd v3 JSON-gateway URL (etcd backend)
    lease_ttl_s: float = 5.0

    # request plane (TCP)
    tcp_host: str = "127.0.0.1"
    tcp_port: int = 0  # 0 = ephemeral

    # event plane
    event_plane: str = "auto"  # auto: zmq for file/etcd discovery
    zmq_host: str = ""  # advertised ZMQ PUB bind host

    namespace: str = "dynamo"
    # /health /live /metrics server (system_status.py); 0 = disabled,
    # negative = an ephemeral port, advertised in discovery metadata
    system_port: int = 0
    # admin surface (system_status.py /debug/*): shared secret required
    # for state dumps and profiler captures; empty = admin routes return
    # 403 (fail closed).  /health /live /metrics stay unauthenticated.
    admin_token: str = ""

    @classmethod
    def from_env(cls, **overrides) -> "RuntimeConfig":
        cfg = cls(
            discovery_backend=os.environ.get("DYN_DISCOVERY_BACKEND", "mem"),
            discovery_path=os.environ.get("DYN_DISCOVERY_PATH", ""),
            etcd_endpoint=os.environ.get("DYN_ETCD_ENDPOINT", ""),
            lease_ttl_s=float(os.environ.get("DYN_LEASE_TTL", "5.0")),
            tcp_host=os.environ.get("DYN_TCP_HOST", "127.0.0.1"),
            tcp_port=int(os.environ.get("DYN_TCP_PORT", "0")),
            event_plane=os.environ.get("DYN_EVENT_PLANE", "auto"),
            zmq_host=os.environ.get("DYN_ZMQ_HOST", ""),
            namespace=os.environ.get("DYN_NAMESPACE", "dynamo"),
            system_port=int(os.environ.get("DYN_SYSTEM_PORT", "0")),
            admin_token=os.environ.get("DYN_ADMIN_TOKEN", ""),
        )
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg
