"""The reference's microbenchmark and observability-overhead gates
(``tests/test_perf_gate.py``), re-pointed at ray_tpu_torch with the
reference's floors unchanged.

The copy runs through ``torch_repoint`` in a pytest subprocess: the
port's ``run_microbenchmarks`` is asked for the CPU (its device legs
default to the card), and the DAG-overhead child finds the port at the
repo's root. The file's load-sensitive tests (ROADMAP.md §3) run as
entries of their own (SPLIT), each in a file of its own so that under
``--dist loadfile`` they land on different workers:
``test_microbenchmark_floors`` in ``test_torch_perf_gate_floors.py``,
``test_dag_observability_overhead`` in ``test_torch_perf_gate_dag.py``,
and ``test_object_state_reporting_overhead`` here. Every selected test
passes with no import of jax or ray_tpu in that process. The reference
file stays untouched.
"""

from torch_repoint import run_repointed

# load-sensitive tests of test_perf_gate, each an entry of its own
SPLIT = ("test_microbenchmark_floors", "test_dag_observability_overhead",
         "test_object_state_reporting_overhead")


def test_reference_perf_gate_file_passes_on_the_port(tmp_path):
    run_repointed("test_perf_gate", 5, tmp_path, timeout=170, split=SPLIT)


def test_reference_object_state_overhead_passes_on_the_port(tmp_path):
    run_repointed("test_perf_gate", 1, tmp_path, timeout=120,
                  only="test_object_state_reporting_overhead")
