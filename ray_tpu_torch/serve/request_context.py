"""The contextvar bridge through which the LLM engine stamps its phase
timings (queue, prefill, TTFT, TPOT, occupancy) into the request being
handled (counterpart of ray_tpu/serve/request_context.py:144-166).

Only what the engine reads is here: the request ids, the batched record
publisher and ``engine_section`` arrive with the Serve slice (ROADMAP
item 8)."""

from __future__ import annotations

import contextvars
from typing import Optional

# the replica sets this around the user-callable invocation; the engine
# picks it up in generate() and writes plain floats/ints into it from its
# executor threads (single stores are atomic under the GIL, and the replica
# reads only after the handler returns)
_request_obs: contextvars.ContextVar[Optional[dict]] = \
    contextvars.ContextVar("rayt_serve_request_obs", default=None)


def current_request_obs() -> Optional[dict]:
    """Inside a replica handler: the mutable observation dict for the
    request being handled (None when recording is off or the call didn't
    come through an instrumented ingress)."""
    return _request_obs.get()


def _set_request_obs(obs: Optional[dict]):
    return _request_obs.set(obs)


def _reset_request_obs(token):
    _request_obs.reset(token)
