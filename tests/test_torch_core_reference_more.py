"""The reference's tests of the runtime's core, re-pointed at
ray_tpu_torch (part two).

Each reference file runs through ``torch_repoint`` in a pytest subprocess
of its own: the scheduling policy, streaming generators, spilling, the
GCS's fault tolerance and external store, resource sync between nodes,
OpenTelemetry tracing, the metrics store and the native store's
multi-process crash storm. test_scheduling_policy names the "TPU"
resource as a key of its node views (its rewrite makes it "GPU"), and
test_native_store_stress finds the repo from its own path (its rewrite
names the repo's root). Every test of each file passes with no import of
jax or ray_tpu in that process. The reference files stay untouched.
"""

import pytest

from torch_repoint import run_repointed

# reference file -> the number of its tests
FILES = {"test_scheduling_policy": 13, "test_streaming": 6,
         "test_spilling": 3, "test_gcs_fault_tolerance": 3,
         "test_gcs_external_store": 3, "test_resource_sync": 4,
         "test_otel_tracing": 3, "test_metrics_store": 17,
         "test_native_store_stress": 2}


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_core_file_passes_on_the_port(name, tmp_path):
    run_repointed(name, FILES[name], tmp_path, timeout=170)
