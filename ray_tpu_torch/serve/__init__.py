"""Serving (counterpart of ray_tpu/serve). This slice carries the LLM
engine and the multi-LoRA service (``serve.llm``), the multiplex LRU
(``multiplex``) and the two pieces of the serve plane the engine reads
(``request_context``, ``handle``); the controller, replicas, router, proxies
and the LLM apps arrive with the Serve slice (ROADMAP item 8)."""
