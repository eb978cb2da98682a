"""The reference's data-plane tests, re-pointed at ray_tpu_torch (part
two): the exchange and the LLM corpus pipeline.

``tests/test_exchange.py`` (the pipelined shuffle: repartition, sort,
groupby and dedup over hash and range exchanges, streaming folds, the
store's pressure gate, code shipping, the exchange counters) and
``tests/test_llm_corpus.py`` (token shards in every format, packing, the
resumable cursor, shard tasks through the streaming executor,
``build_corpus``) run through ``torch_repoint`` in a pytest subprocess
each. test_exchange's load-sensitive overlap test runs as an entry of its
own (SPLIT). Every selected test passes with no import of jax or ray_tpu
in that process. The reference files stay untouched.
"""

import pytest

from torch_repoint import run_repointed

# reference file -> the number of its tests that run in the file's entry
# (all but SPLIT's)
FILES = {"test_exchange": 25, "test_llm_corpus": 14}
# load-sensitive tests (ROADMAP.md §3), each run as an entry of its own
SPLIT = {"test_exchange": ("test_reduce_starts_before_all_maps_finish",)}


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_exchange_file_passes_on_the_port(name, tmp_path):
    run_repointed(name, FILES[name], tmp_path, timeout=170,
                  split=SPLIT.get(name, ()))


@pytest.mark.parametrize("name,test", [(name, test)
                                       for name, tests in SPLIT.items()
                                       for test in tests])
def test_reference_exchange_test_passes_on_the_port(name, test, tmp_path):
    run_repointed(name, 1, tmp_path, timeout=120, only=test)
