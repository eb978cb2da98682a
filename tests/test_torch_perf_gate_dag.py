"""The reference's DAG observability-overhead gate (``tests/
test_perf_gate.py::test_dag_observability_overhead``: channel ticks/s with
per-channel stats, dag_state reports and per-tick tracing on, against 90%
of the reference's channel floor) on the port's runtime. Load-sensitive
(ROADMAP.md §3), so it runs as an entry of its own, in a file of its
own."""

from torch_repoint import run_repointed


def test_reference_dag_observability_overhead_passes_on_the_port(tmp_path):
    run_repointed("test_perf_gate", 1, tmp_path, timeout=230,
                  only="test_dag_observability_overhead")
