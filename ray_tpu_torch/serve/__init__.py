"""Serving (counterpart of ray_tpu/serve). This slice carries the LLM
engine (``serve.llm``) and the two pieces of the serve plane it reads
(``request_context``, ``handle``); the controller, replicas, router, proxies
and the LLM apps arrive with the Serve slice (ROADMAP item 8)."""
