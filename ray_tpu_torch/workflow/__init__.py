"""ray_tpu_torch.workflow — durable workflows (ref analog:
python/ray/workflow/workflow_executor.py:32 + workflow_state_from_dag.py +
storage/).

A workflow is a DAG of @workflow.step functions. `run` executes each
step as a cluster task and checkpoints every step result to storage;
`resume` replays a crashed/interrupted workflow, re-running only steps
without a checkpoint. Step ids are content-derived (name + upstream
ids), so an edited workflow invalidates exactly the downstream steps.
"""

from ray_tpu_torch.workflow.api import (  # noqa: F401
    Continuation, StepNode, continuation, get_output, list_workflows, resume,
    run, send_event, step, wait_for_event)
