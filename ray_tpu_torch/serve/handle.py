"""The prefix-routing block size that the LLM engine shares with the router
(counterpart of ray_tpu/serve/handle.py:58-73), so routed prefix hits land
where the warm KV rows are.

Only what the engine reads is here: the deployment handle, the router and
prefix-key derivation arrive with the Serve slice (ROADMAP item 8)."""

from __future__ import annotations

import os

PREFIX_BLOCK_ENV = "RAYT_SERVE_PREFIX_BLOCK"


def prefix_block_tokens(default: int = 16) -> int:
    """Prefix-routing block size in tokens (0 disables prefix keys)."""
    try:
        return int(os.environ.get(PREFIX_BLOCK_ENV, default))
    except (TypeError, ValueError):
        return default
