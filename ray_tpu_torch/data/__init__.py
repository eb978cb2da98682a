"""ray_tpu_torch.data: the tokenized-corpus reader the train ingest needs
(``llm_corpus``: ``TokenCorpus``, ``CorpusCursor``, ``read_token_corpus``).
The rest of the JAX package's ``data/`` (datasets, datasources and sinks,
the streaming executor, the exchange; ``build_corpus`` raises) is
ROADMAP.md item 8."""

from ray_tpu_torch.data.llm_corpus import (CorpusCursor,  # noqa: F401
                                          TokenCorpus, build_corpus,
                                          read_token_corpus)
