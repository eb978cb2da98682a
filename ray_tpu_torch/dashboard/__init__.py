"""Dashboard head: HTTP observability + job submission (ref analogs:
python/ray/dashboard/head.py:65, dashboard/modules/job/job_manager.py:59,
_private/metrics_agent.py:483 Prometheus export)."""

from ray_tpu_torch.dashboard.head import DashboardHead, JobManager  # noqa: F401
