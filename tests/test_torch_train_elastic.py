"""Twin of test_train.py::test_elastic_scaling_remesh_on_node_death on the
port: a node of a two-node cluster dies mid-fit, and the
ElasticScalingPolicy restarts the group at the surviving capacity from the
latest checkpoint. Each group builds its mesh with ``get_mesh()`` (a gloo
group over its workers, rebuilt after the shrink) and logs its world size
and its mesh's size, as the reference logs its mesh's device count
(tests/test_train.py:306); the loop waits on its log file rather than on
fixed sleeps. In a file of its own: it runs
its own multi-node cluster."""

import threading
import time

from ray_tpu_torch import train


# ------------------------------------------------------------- elasticity
def _elastic_loop(config):
    """Twin body of test_train.py::_elastic_loop: each group builds its
    mesh, runs one computation over it an epoch, and each rank logs
    (epoch, world size, rank, mesh size) once its epoch is reported; a
    group of two waits, once epoch 1 is logged, for the test to take a
    node down and for the controller to tear the group down."""
    import os
    import tempfile
    import time

    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.train.checkpoint import (Checkpoint, load_pytree,
                                                save_pytree)

    ctx = train.get_context()
    mesh = ctx.get_mesh()   # rebuilt per group: proves re-mesh works
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        start = int(load_pytree(ckpt.subdir(
            f"rank_{ctx.get_world_rank()}").path)["epoch"]) + 1
    killed = os.path.join(config["log_dir"], "killed")
    for epoch in range(start, 6):
        # one real computation over the mesh an epoch
        x = torch.ones(8, device=ctx.get_device()) * (epoch + 1)
        dist.all_reduce(x, group=mesh.get_group())
        assert float(x.sum()) == 8.0 * (epoch + 1) * mesh.size()
        with tempfile.TemporaryDirectory() as d:
            save_pytree({"epoch": epoch}, d)
            train.report({"epoch": epoch,
                          "world_size": ctx.get_world_size()},
                         checkpoint=Checkpoint(d))
        with open(os.path.join(config["log_dir"], "epochs.log"), "a") as f:
            f.write(f"{epoch},{ctx.get_world_size()},"
                    f"{ctx.get_world_rank()},{mesh.size()}\n")
        if ctx.get_world_size() > 1 and epoch >= 1:
            deadline = time.monotonic() + 60
            while not os.path.exists(killed):
                if time.monotonic() > deadline:
                    raise TimeoutError("the node was never taken down")
                time.sleep(0.05)
            # the group lost a member: the controller kills this one
            time.sleep(60)
            raise TimeoutError("the group outlived its lost member")


def test_elastic_scaling_on_node_death_torch(tmp_path):
    """Twin of test_train.py::test_elastic_scaling_remesh_on_node_death:
    a node dies mid-fit; the ElasticScalingPolicy restarts the group at
    the surviving capacity (2 -> 1 workers) from the checkpoint, with
    epochs continuing (no reset to 0), and each group's mesh has its
    group's size (2, then 1)."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(head_resources={"CPU": 1.0})
    node_b = cluster.add_node(num_cpus=1)
    cluster.connect()
    log_file = tmp_path / "epochs.log"
    try:
        def killer():
            # once both ranks of the group of two reported epoch 1
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                if log_file.exists() and {"1,2,0,2", "1,2,1,2"} <= set(
                        log_file.read_text().splitlines()):
                    node_b.proc.kill()
                    (tmp_path / "killed").touch()
                    return
                time.sleep(0.05)

        t = threading.Thread(target=killer)
        t.start()
        result = train.TorchTrainer(
            _elastic_loop, train_loop_config={"log_dir": str(tmp_path)},
            scaling_config=train.ScalingConfig(num_workers=2,
                                               use_gpu=False),
            run_config=train.RunConfig(
                name="elastic", storage_path=str(tmp_path / "exp"),
                failure_config=train.FailureConfig(max_failures=3)),
            scaling_policy=train.ElasticScalingPolicy(
                min_workers=1, max_workers=2)).fit()
        t.join(timeout=10)
        assert result.error is None
        assert result.metrics["epoch"] == 5
        assert result.metrics["world_size"] == 1
        # rank 0's rows: after the shrink it is the group's one worker
        rows = [r[:2] + r[3:] for r in (
            tuple(map(int, line.split(",")))
            for line in log_file.read_text().splitlines()) if r[2] == 0]
        epochs = [r[0] for r in rows]
        worlds = [r[1] for r in rows]
        meshes = [r[2] for r in rows]
        assert meshes == worlds, rows
        assert meshes[0] == 2 and meshes[-1] == 1, rows
        assert 2 in worlds and worlds[-1] == 1, rows
        first_shrunk = worlds.index(1)
        assert first_shrunk > 0
        assert epochs[first_shrunk] >= epochs[first_shrunk - 1], rows
        assert epochs == sorted(epochs), rows
        assert set(range(6)) <= set(epochs), rows
    finally:
        cluster.shutdown()
