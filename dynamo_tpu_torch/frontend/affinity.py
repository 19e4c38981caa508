"""Agent session identity from HTTP headers.

A copy of `session_affinity_from_headers` and its header vocabulary from
dynamo_tpu/frontend/affinity.py: the port's frontend stamps every
request's `session_id` / `session_final` from its headers, as the JAX
frontend does.  Sticky routing itself (the `AffinityCoordinator` and
`SessionAffinityRouter`) is not ported yet (ROADMAP, Queue 1): the port's
`ModelWatcher` refuses a session-affinity TTL.
"""

from __future__ import annotations

from typing import Optional, Tuple

# ref session_affinity/mod.rs limits
MAX_SESSION_AFFINITY_TTL_S = 31_536_000.0
MAX_SESSION_AFFINITY_ENTRIES = 65_536
MAX_SESSION_AFFINITY_ID_BYTES = 256

# ref protocols/agents.rs header vocabulary, in priority order.  The
# dynamo-native header wins; agent-specific mappings prefer the child
# (subagent) id over the root session so sibling subagents don't all pin
# to one worker.
HEADER_DYNAMO_SESSION_ID = "x-dynamo-session-id"
HEADER_DYNAMO_SESSION_FINAL = "x-dynamo-session-final"
_AGENT_MAPPINGS: Tuple[Tuple[str, Optional[str]], ...] = (
    # (root session header, child/agent header)
    ("x-claude-code-session-id", "x-claude-code-agent-id"),
    ("session-id", None),
    ("x-session-id", None),
)


def session_affinity_from_headers(headers) -> Tuple[Optional[str], bool]:
    """Extract (session_id, session_final) from HTTP headers.

    `headers` is any case-insensitive mapping (runtime/http_server.py
    Headers in the port's frontend).
    """

    def get(name: str) -> Optional[str]:
        v = headers.get(name)
        if v is None:
            return None
        v = v.strip()
        return v or None

    final = (get(HEADER_DYNAMO_SESSION_FINAL) or "").lower() in (
        "1", "true", "yes", "on")
    sid = get(HEADER_DYNAMO_SESSION_ID)
    if sid is not None:
        return sid, final
    for root, child in _AGENT_MAPPINGS:
        root_id = get(root)
        if root_id is None:
            continue
        child_id = get(child) if child else None
        return child_id or root_id, final
    return None, final
