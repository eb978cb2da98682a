"""joblib parallel backend over cluster tasks (ref analog:
python/ray/util/joblib/ — `register_ray()` +
ray_backend.py's RayBackend). Lets scikit-learn-style
`with joblib.parallel_backend("rayt"): ...` fan grid searches out over
the cluster unchanged.
"""

from __future__ import annotations


def register_rayt() -> None:
    """Register the "rayt" joblib backend (call once per process)."""
    from joblib import register_parallel_backend

    register_parallel_backend("rayt", _make_backend())


def _make_backend():
    from joblib._parallel_backends import ThreadingBackend

    class RaytBackend(ThreadingBackend):
        """Batches of joblib work items run as cluster tasks.

        Subclasses ThreadingBackend so joblib's bookkeeping (callbacks,
        batching, nesting) stays local; only apply_async's batch payload
        crosses the cluster. The same shape the reference uses (its
        backend rides the multiprocessing-Pool shim)."""

        supports_timeout = True

        def configure(self, n_jobs=1, parallel=None, **kwargs):
            import ray_tpu_torch as rt

            if not rt.is_initialized():
                rt.init()
            if n_jobs == -1:
                n_jobs = max(1, int(rt.cluster_resources().get("CPU", 1)))
            return super().configure(n_jobs=n_jobs, parallel=parallel,
                                     **kwargs)

        def apply_async(self, func, callback=None):
            import ray_tpu_torch as rt
            from ray_tpu_torch._internal.serialization import \
                ship_code_by_value

            ship_code_by_value(func)
            task = rt.remote(num_cpus=1)(_run_joblib_batch)
            ref = task.remote(func)

            class _FutureLike:
                def get(self, timeout=None):
                    return rt.get(ref, timeout=timeout)

            out = _FutureLike()
            if callback is not None:
                import threading

                def _wait():
                    try:
                        result = rt.get(ref)
                    except Exception:
                        return
                    callback(result)

                threading.Thread(target=_wait, daemon=True).start()
            return out

    return RaytBackend


def _run_joblib_batch(batch):
    """Executes one joblib BatchedCalls payload inside a worker."""
    return batch()
