"""The reference's microbenchmark floors (``tests/test_perf_gate.py::
test_microbenchmark_floors``) on the port's runtime: tasks/s, actor
calls/s, put/get GB/s, DAG ticks/s and device-edge ticks/s, with the
reference's floors unchanged. Load-sensitive (ROADMAP.md §3), so it runs
as an entry of its own, in a file of its own (``--dist loadfile`` puts a
file on one worker). The port's microbenchmark is asked for the CPU
(``torch_repoint.PERF_GATE_REWRITES``)."""

from torch_repoint import run_repointed


def test_reference_microbenchmark_floors_pass_on_the_port(tmp_path):
    run_repointed("test_perf_gate", 1, tmp_path, timeout=170,
                  only="test_microbenchmark_floors")
