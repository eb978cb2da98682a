"""Channel-compiled DAG execution — the accelerator-loop fast path.

Ref analog: python/ray/dag/compiled_dag_node.py:757 (CompiledDAG),
dag_node_operation.py:14 (static per-actor READ/COMPUTE/WRITE schedules),
experimental/channel/shared_memory_channel.py (pre-allocated mutable
channels). The point: after compile, a tick involves ZERO task
submissions — the driver writes the input into pre-created channels, the
actors run frozen schedules in long-lived loops, values move
producer→consumer through SPSC channels, and the driver reads outputs
from channels. Per-tick cost is a few serialize+memcpy+seq-bump
operations instead of task specs, leases, and object-store round trips.

Channel selection is PER EDGE at compile time:
  * both endpoints on the driver's node  -> shm ring (dag/channel.py,
    zero-copy ticks under the slot-pin rule),
  * any endpoint off the driver's node   -> DCN ring channel over the
    existing RPC plane (dag/dcn_channel.py: persistent peer connection,
    scatter-gather frames, credit window == n_slots) — multi-node actor
    graphs stay on the fast path instead of falling back to the
    4x-slower per-call executor,
  * edges whose payloads are tensors (the producer node is marked
    ``.with_tensor_transport()``, or the compile sets
    ``device_input=True`` for the driver's weight-broadcast edges)
    -> DEVICE kind (dag/device_channel.py): the same shm/DCN transport
    underneath, but tensor leaves ride as raw host bytes +
    dtype/shape metadata (never a host pickle of the device buffer)
    and rebuild on the consumer's devices during the read.

Eligibility (else ``compile_channels`` raises ``Ineligible`` and the
caller falls back to the per-call executor in dag/compiled.py):
  * every compute node is a ClassMethodNode (actors only).

Per-tick error semantics mirror the reference: an exception in one actor
is wrapped and FLOWS along the graph edges (consumers skip compute and
forward it), so the driver's ``get()`` raises while the DAG stays alive
for the next tick; the captured remote traceback is chained onto the
re-raised exception.
"""

from __future__ import annotations

import pickle
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any

from ray_tpu_torch._internal.logging_utils import setup_logger
from ray_tpu_torch.dag.channel import ChannelClosed, ShmChannel
from ray_tpu_torch.dag.dcn_channel import (DcnProducerChannel, _dcn_create_endpoints,
                                           attach_channel, create_endpoint)
from ray_tpu_torch.dag.device_channel import (DeviceChannelSpec,
                                              DeviceTransportChannel,
                                              pack_device_tree)
from ray_tpu_torch.dag.node import (ClassMethodNode, DAGNode, InputAttributeNode,
                                    InputNode, MultiOutputNode)

logger = setup_logger("dag")

# pubsub channel the DAG-plane state reports ride (the owning side —
# core/gcs_dag_manager.py, next to its consumer — defines it, same
# convention as CH_OBJECTS/CH_METRICS)
from ray_tpu_torch.core.gcs_dag_manager import CH_DAGS  # noqa: E402


class Ineligible(Exception):
    """This DAG can't use the channel fast path; use the per-call one."""


class DagRemoteTraceback(Exception):
    """Carrier for the traceback captured inside an actor's tick; chained
    as the __cause__ of the re-raised remote exception so the driver's
    stack trace shows where the tick actually failed."""

    def __str__(self):
        return "\n--- remote tick traceback ---\n" + (self.args[0] or "")


class _TickError:
    """An exception captured inside one tick, flowing along DAG edges."""

    __slots__ = ("err", "tb")

    def __init__(self, err: Exception, tb: str):
        self.err = err
        self.tb = tb


class _TraceTick:
    """Envelope that threads the driver tick's span context through
    channel writes when distributed tracing is on (RAYT_TRACING_DIR):
    every process's per-tick span parents off the driver's execute
    span, so one tick stitches into ONE trace across producer/consumer
    processes. Consumers unwrap unconditionally, so mixed-enablement
    clusters stay correct."""

    __slots__ = ("carrier", "tick", "value")

    def __init__(self, carrier, tick, value):
        self.carrier = carrier
        self.tick = tick
        self.value = value

    def __reduce__(self):
        return (_TraceTick, (self.carrier, self.tick, self.value))


class _EpochTick:
    """Recovery-epoch envelope (outermost, wrapping any _TraceTick).
    After a recompile-and-resume (dag/recovery.py) the driver and every
    actor schedule carry the new DAG's epoch; frames stamped with an
    older epoch are pre-failure leftovers from a surviving peer and are
    DISCARDED at read instead of double-consumed. Epoch-0 DAGs (never
    recovered) skip the envelope entirely, so the steady-state wire
    format is unchanged."""

    __slots__ = ("epoch", "value")

    def __init__(self, epoch, value):
        self.epoch = epoch
        self.value = value

    def __reduce__(self):
        return (_EpochTick, (self.epoch, self.value))


# reusable no-op context for the untraced compute path
import contextlib as _contextlib

_NULL_SPAN = _contextlib.nullcontext({"ok": True})


def _chan_key(spec) -> str:
    """The channel's stable wire identity: shm segment name or DCN
    token — the key dag registrations map to edge ids."""
    return getattr(spec, "name", None) or getattr(spec, "token", "")


class _DagReporter:
    """Per-process DAG-plane state publisher: a daemon thread snapshots
    this process's channel stats every report interval and publishes
    them on the ``dag_state`` channel (fire-and-forget onto the core
    worker's IO loop — observability must never block a tick). Runs in
    the driver AND in every actor loop; it keeps publishing while the
    loop thread is PARKED on a full/empty ring, which is exactly what
    lets the GCS watchdog see a stall that never returns."""

    def __init__(self, dag_id: str, channels: list, cw=None):
        # channels: [(role, channel)] — role is this process's side
        self._dag_id = dag_id
        self._channels = channels
        self._cw = cw
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self):
        from ray_tpu_torch._internal.config import get_config

        cfg = get_config()
        if not cfg.dag_state_enabled or not self._dag_id:
            return
        self._interval = cfg.dag_state_report_interval_s
        self._thread = threading.Thread(
            target=self._run, name="rayt-dag-report", daemon=True)
        self._thread.start()

    def stop(self, join: bool = False):
        """Signal the thread to exit (it fires one final publish).
        ``join=True`` waits for it — REQUIRED before closing the
        channels it snapshots: a snapshot racing a close would hit the
        shm ring's native-atomics load on an unmapped address (SIGSEGV,
        not a catchable exception)."""
        self._stop.set()
        if join and self._thread is not None:
            self._thread.join(timeout=3.0)

    def _core_worker(self):
        if self._cw is not None:
            return self._cw
        try:
            from ray_tpu_torch.core.object_ref import get_core_worker

            return get_core_worker()
        except Exception:
            return None

    def _run(self):
        while not self._stop.wait(self._interval):
            self.publish_once()
        self.publish_once()  # final snapshot before the loop exits

    def publish_once(self):
        chans: dict[str, dict] = {}
        for role, ch in self._channels:
            try:
                snap = ch.snapshot()
                snap["role"] = role
                chans[_chan_key(ch.spec)] = snap
            except Exception:
                pass  # channel closed mid-snapshot
        cw = self._core_worker()
        if not chans or cw is None or cw.gcs is None:
            return
        report = {"kind": "report", "dag_id": self._dag_id,
                  "ts": time.time(), "channels": chans}
        try:
            cw._spawn_from_thread(cw.gcs.publish(CH_DAGS, report))
        except Exception:
            pass  # best-effort: dropped on GCS hiccup / shutdown


@dataclass
class _Op:
    method: str
    # arg sources: ("const", v) | ("input",) | ("input_key", key, by_attr)
    #            | ("local", node_pos) | ("read", in_ch_idx)
    arg_src: tuple
    kwarg_src: dict
    writes: tuple            # out-channel indices for this op's result
    pos: int                 # node position (key for "local" references)
    collective: str | None = None   # "allreduce:<op>" for collective ops


@dataclass
class _ActorSchedule:
    in_channels: list = field(default_factory=list)    # channel specs (reads)
    out_channels: list = field(default_factory=list)   # channel specs (writes)
    ops: list = field(default_factory=list)
    input_ch: int | None = None       # index into in_channels for driver input
    collective_group: str | None = None
    collective_world: int = 0
    collective_rank: int = 0
    dag_id: str = ""                  # dag_state reporting key ("" = off)
    epoch: int = 0                    # recovery epoch (0 = never recovered)


def _dag_actor_loop(self, sched_blob: bytes):
    """Submitted to the actor via __rayt_apply__: starts a DAEMON THREAD
    running the DAG schedule for the DAG's lifetime, then returns — the
    actor's ordered queue stays free for normal method calls, which
    interleave with DAG ticks exactly like the reference's compiled
    graphs. The thread attaches channels once and ticks until the driver
    closes the input channels (teardown) — no per-tick control plane."""
    import threading

    sched: _ActorSchedule = pickle.loads(sched_blob)
    thread = threading.Thread(
        target=_dag_loop_body, args=(self, sched),
        name="rayt-dag-loop", daemon=True)
    thread.start()
    return True


def _dag_loop_body(self, sched: _ActorSchedule):
    from ray_tpu_torch._internal import otel

    ins: list = []
    outs: list = []
    group = None
    reporter = None
    try:
        # attach incrementally so a startup failure still closes whatever
        # came up (peers then see ChannelClosed instead of a timeout)
        for s in sched.in_channels:
            ins.append(attach_channel(s))
        for s in sched.out_channels:
            outs.append(attach_channel(s))
        if sched.dag_id:
            reporter = _DagReporter(
                sched.dag_id,
                [("consumer", ch) for ch in ins]
                + [("producer", ch) for ch in outs])
            reporter.start()
        in_mesh = False
        # per-collective-op AGREED lowering decision, settled on the
        # op's first tick (op.pos -> bool | "broken"): the in-mesh path
        # requires EVERY rank to run the same collective, so a rank
        # must never pick it from its local value type (or its local
        # view of the mesh) alone — a split would leave ranks parked
        # between the in-mesh collective and the out-of-band group,
        # deadlocked. EVERY rank joins the settle gather and posts its
        # own (value_is_device, in_mesh) pair, so a rank whose
        # fingerprint rendezvous failed converges the whole group to
        # the out-of-band path instead of silently diverging from it.
        mesh_lowering: dict[int, Any] = {}
        if sched.collective_group:
            from ray_tpu_torch.dag import collective as dag_collective
            from ray_tpu_torch.util.collective import init_collective_group

            group = init_collective_group(
                sched.collective_world, sched.collective_rank,
                group_name=sched.collective_group)
            # one-time rendezvous: do the participants share ONE mesh?
            # If so, reductions lower to the in-mesh collective
            # (in-mesh) and the out-of-band group stays as the
            # cross-mesh fallback for host values.
            try:
                fps = group.gather_obj(
                    dag_collective.client_fingerprint())
                in_mesh = dag_collective.mesh_shared(fps)
            except Exception:
                in_mesh = False
        tick_no = 0
        while True:
            reads: dict[int, Any] = {}
            # the driver's per-tick span context, captured from the
            # first _TraceTick envelope read this tick (tracing off ->
            # stays None and no spans open)
            trace_ctx: list = [None, tick_no]

            def read_ch(i):
                if i not in reads:
                    while True:
                        v = ins[i].read()
                        if type(v) is _EpochTick:
                            if v.epoch != sched.epoch:
                                # stale pre-failure frame from a
                                # surviving peer: discard, re-read
                                continue
                            v = v.value
                        elif sched.epoch:
                            # unstamped frame in a recovered DAG
                            # predates the recompile: discard it
                            continue
                        break
                    if type(v) is _TraceTick:
                        trace_ctx[0] = v.carrier
                        trace_ctx[1] = v.tick
                        v = v.value
                    reads[i] = v
                return reads[i]

            locals_: dict[int, Any] = {}
            try:
                input_val = (read_ch(sched.input_ch)
                             if sched.input_ch is not None else None)
            except ChannelClosed:
                break
            stop = False
            for op in sched.ops:
                err = None

                def resolve(src):
                    nonlocal err
                    kind = src[0]
                    if kind == "const":
                        return src[1]
                    if kind == "input":
                        return input_val
                    if kind == "input_key":
                        if isinstance(input_val, _TickError):
                            return input_val
                        _, key, by_attr = src
                        if isinstance(input_val, tuple) \
                                and len(input_val) == 2 \
                                and isinstance(input_val[1], dict):
                            a, kw = input_val
                            return kw[key] if by_attr else a[key]
                        return (getattr(input_val, key) if by_attr
                                else input_val[key])
                    if kind == "local":
                        return locals_[src[1]]
                    try:
                        return read_ch(src[1])   # ("read", ch)
                    except ChannelClosed:
                        err = ChannelClosed()
                        return None

                args = [resolve(s) for s in op.arg_src]
                kwargs = {k: resolve(s) for k, s in op.kwarg_src.items()}
                if err is not None:
                    stop = True
                    break
                flowed = next((a for a in list(args) + list(kwargs.values())
                               if isinstance(a, _TickError)), None)
                if flowed is not None:
                    result = flowed          # error flows along edges
                elif op.collective:
                    kind, red_op = op.collective.split(":")
                    assert kind in ("allreduce", "allgather"), kind
                    try:
                        from ray_tpu_torch.dag import collective as dagc

                        use_mesh = mesh_lowering.get(op.pos)
                        if use_mesh is None:
                            # first tick of this op: AGREE on the
                            # lowering — in-mesh only when every rank
                            # sees the shared mesh AND contributes a
                            # device value (one flag gather EVERY rank
                            # joins, then cached for the DAG's
                            # lifetime; the compiled schedule feeds
                            # each op the same method's output every
                            # tick, so the flavor is stable)
                            try:
                                flags = group.gather_obj(
                                    (dagc.value_on_device(args[0]),
                                     in_mesh))
                                use_mesh = all(dev and mesh
                                               for dev, mesh in flags)
                            except Exception:
                                # a half-completed settle must never be
                                # retried: the ranks that DID settle
                                # will not join a re-issued gather, so
                                # retrying would park this rank against
                                # nobody every tick. Mark the op broken
                                # (sticky) — each tick errors fast and
                                # visibly instead.
                                mesh_lowering[op.pos] = "broken"
                                raise
                            mesh_lowering[op.pos] = use_mesh
                        elif use_mesh == "broken":
                            raise RuntimeError(
                                "collective lowering rendezvous failed "
                                "on an earlier tick; recompile the DAG "
                                "to re-settle this op")
                        if use_mesh is True:
                            # shared mesh + device values: the in-mesh
                            # collective, no out-of-band hop
                            result = (dagc.in_mesh_allreduce(
                                args[0], red_op)
                                if kind == "allreduce"
                                else dagc.in_mesh_allgather(args[0]))
                        elif kind == "allreduce":
                            result = group.allreduce(args[0], op=red_op)
                        else:
                            result = group.allgather(args[0])
                    except Exception as e:
                        import traceback

                        result = _TickError(e, traceback.format_exc())
                else:
                    # per-tick span, remote-parented by the driver's
                    # execute span via the carrier that rode the edge
                    # (nullcontext when tracing is off)
                    span = (otel.execute_span(
                        f"dag.{op.method}", trace_ctx[0],
                        dag_id=sched.dag_id, tick=trace_ctx[1])
                        if trace_ctx[0] is not None
                        else _NULL_SPAN)
                    try:
                        with span:
                            result = getattr(self, op.method)(
                                *args, **kwargs)
                    except Exception as e:
                        import traceback

                        result = _TickError(e, traceback.format_exc())
                locals_[op.pos] = result
                out_val = result
                if trace_ctx[0] is not None:
                    # forward the SAME tick carrier along every edge so
                    # downstream spans join the driver's trace
                    out_val = _TraceTick(trace_ctx[0], trace_ctx[1],
                                         result)
                if sched.epoch:
                    # stamp the recovery epoch OUTERMOST so peers (and
                    # the driver) can discard frames from a pre-failure
                    # epoch; device channels pack inside the envelope
                    out_val = _EpochTick(sched.epoch, out_val)
                try:
                    for w in op.writes:
                        outs[w].write(out_val)
                except ChannelClosed:
                    stop = True   # a downstream peer tore down mid-tick
                    break
            if stop:
                break
            tick_no += 1
    finally:
        if reporter is not None:
            # join BEFORE closing: a snapshot racing close() would load
            # ring seqs through an unmapped native-atomics pointer
            reporter.stop(join=True)
        for ch in outs:   # propagate shutdown downstream
            try:
                ch.close()
            except Exception:
                pass
        for ch in ins:
            try:
                ch.close()
            except Exception:
                pass
        if group is not None:
            try:
                group.destroy()
            except Exception:
                pass
    return True


class ChannelDagRef:
    """Future for one tick; resolves from the output channels in order."""

    def __init__(self, dag: "ChannelCompiledDAG", tick: int):
        self._dag = dag
        self._tick = tick

    def get(self, timeout: float | None = None):
        return self._dag._get_tick(self._tick, timeout)


@dataclass
class _ChanPlan:
    """One channel to materialize. ``owner`` is the CONSUMER process:
    None = the driver (creates shm rings and driver-side DCN endpoints
    locally), else the id()-key of the consuming actor handle (its
    worker creates the DCN endpoint via one compile-time RPC).
    ``device`` layers the raw-bytes tensor framing
    (dag/device_channel.py) over the transport — the edge's reported
    kind is then "device" and ``kind`` names the transport beneath."""
    kind: str                 # transport: "shm" | "dcn"
    owner: int | None         # None = driver
    n_slots: int
    slot_size: int
    device: bool = False      # device edge (tensor payload framing)
    spec: Any = None          # filled at materialization
    handle: Any = None        # driver-held handle, when the driver is a peer


class ChannelCompiledDAG:
    def __init__(self, output_node: DAGNode, topo: list[DAGNode],
                 buffer_size_bytes: int = 1 << 20, max_inflight: int = 8,
                 device_input: bool = False, epoch: int = 0,
                 recovered_from: str = ""):
        self.output_node = output_node
        self._closed = False
        self._tick = 0
        # recovery epoch: >0 when this compile replaces a torn-down ring
        # (dag/recovery.py). Every frame both ways is then stamped with
        # an _EpochTick envelope and mismatches are discarded.
        self.epoch = epoch
        # dag_id of the ring this compile replaces (recovery lineage in
        # the GCS record), "" on a first compile
        self.recovered_from = recovered_from
        self._next_read = 0
        self._buffered: dict[int, Any] = {}
        # outputs already consumed for the in-progress wave (a get()
        # deadline can fire mid-wave; the next get() resumes here)
        self._partial: list = []

        compute = [n for n in topo if isinstance(n, ClassMethodNode)]
        if not compute:
            raise Ineligible("no actor compute nodes")
        for n in topo:
            if isinstance(n, (InputNode, InputAttributeNode,
                              MultiOutputNode, ClassMethodNode)):
                continue
            raise Ineligible(f"unsupported node type {type(n).__name__}")

        from ray_tpu_torch._internal.config import get_config
        from ray_tpu_torch.api import _core_worker

        self._cw = _core_worker()
        self._cfg = get_config()
        # identity for the GCS dag-state record (`rayt dag <id>`)
        self.dag_id = uuid.uuid4().hex[:16]
        my_node = self._cw.node_id
        placement = self._actor_placement(compute)   # id(actor) -> node_id
        # kept for the register report: per-edge endpoint nodes + the
        # compile-time placement-plane consult (core/placement.py)
        self._node_of = placement
        self._my_node = my_node

        # ---- plan per-actor schedules + channels -------------------------
        # Channels are PLANNED first (schedules hold plan indices) and
        # materialized after the graph walk: DCN endpoints live in consumer
        # processes, so they take one compile-time RPC per consumer actor.
        slots = max(2, max_inflight)
        plans: list[_ChanPlan] = []
        plan_ends: list[tuple] = []   # (producer_key, consumer_key) per plan

        def plan_channel(consumer_key: int | None,
                         producer_key: int | None,
                         device: bool = False) -> int:
            """consumer/producer: id(actor handle), or None = driver.
            ``device`` layers the tensor raw-bytes framing
            over whichever transport the endpoints select."""
            plan_ends.append((producer_key, consumer_key))
            c_node = my_node if consumer_key is None else \
                placement[consumer_key]
            p_node = my_node if producer_key is None else \
                placement[producer_key]
            if c_node == my_node and p_node == my_node:
                # same node as the driver: driver-created shm ring
                # reaches both peers (driver, or actors on this node)
                plans.append(_ChanPlan("shm", None, slots,
                                       buffer_size_bytes, device=device))
            else:
                # DCN endpoint lives in the CONSUMER'S process — always
                # the consuming actor's worker (even when that actor
                # shares the driver's node: the registry that resolves
                # the consumer side at attach is per-process, not
                # per-node); None = the driver itself consumes (outputs)
                plans.append(_ChanPlan("dcn", consumer_key, slots,
                                       buffer_size_bytes, device=device))
            return len(plans) - 1

        scheds: dict[int, _ActorSchedule] = {}     # id(actor) -> schedule
        actors: dict[int, Any] = {}
        pos_of = {id(n): i for i, n in enumerate(topo)}

        def sched_for(actor) -> _ActorSchedule:
            if id(actor) not in scheds:
                scheds[id(actor)] = _ActorSchedule()
                actors[id(actor)] = actor
            return scheds[id(actor)]

        # edge channels: (producer node, consumer actor) -> in_ch index
        edge_in: dict[tuple[int, int], int] = {}
        for n in compute:
            sched = sched_for(n.actor)
            for up in self._data_upstream(n):
                if isinstance(up, ClassMethodNode) and \
                        up.actor is not n.actor:
                    key = (id(up), id(n.actor))
                    if key not in edge_in:
                        # the producer node's annotation decides the
                        # edge kind: with_tensor_transport() payloads
                        # are tensors and ride the device framing
                        plan_idx = plan_channel(
                            id(n.actor), id(up.actor),
                            device=bool(getattr(up, "tensor_transport",
                                                False)))
                        sched.in_channels.append(plan_idx)
                        edge_in[key] = len(sched.in_channels) - 1
                        # producer writes the same channel
                        psched = sched_for(up.actor)
                        psched.out_channels.append(plan_idx)
                        psched._edge_out = getattr(psched, "_edge_out", {})
                        psched._edge_out[key] = \
                            len(psched.out_channels) - 1

        # input channels: one per actor that consumes the driver input
        self._input_plan_idx: list[int] = []
        for aid, sched in scheds.items():
            needs_input = any(
                isinstance(up, (InputNode, InputAttributeNode))
                for n in compute if n.actor is actors[aid]
                for up in n._upstream())
            has_reads = bool(sched.in_channels)
            if needs_input or not has_reads:
                plan_idx = plan_channel(aid, None, device=device_input)
                sched.in_channels.append(plan_idx)
                sched.input_ch = len(sched.in_channels) - 1
                self._input_plan_idx.append(plan_idx)

        # output channels: one per DAG output node, in output order
        if isinstance(output_node, MultiOutputNode):
            out_nodes = list(output_node.outputs)
            self._multi = True
        else:
            out_nodes = [output_node]
            self._multi = False
        self._output_plan_idx: list[int] = []
        for on in out_nodes:
            if not isinstance(on, ClassMethodNode):
                raise Ineligible("outputs must be actor method results")
            sched = sched_for(on.actor)
            plan_idx = plan_channel(
                None, id(on.actor),
                device=bool(getattr(on, "tensor_transport", False)))
            sched.out_channels.append(plan_idx)
            sched._out_idx = getattr(sched, "_out_idx", {})
            sched._out_idx.setdefault(id(on), []).append(
                len(sched.out_channels) - 1)
            self._output_plan_idx.append(plan_idx)

        # ops, in topo order per actor
        for n in compute:
            sched = scheds[id(n.actor)]

            def src_for(a):
                if isinstance(a, InputNode):
                    return ("input",)
                if isinstance(a, InputAttributeNode):
                    return ("input_key", a.key, a.by_attr)
                if isinstance(a, ClassMethodNode):
                    if a.actor is n.actor:
                        return ("local", pos_of[id(a)])
                    return ("read", edge_in[(id(a), id(n.actor))])
                if isinstance(a, DAGNode):
                    raise Ineligible(
                        f"unsupported upstream {type(a).__name__}")
                return ("const", a)

            writes = []
            writes += getattr(sched, "_out_idx", {}).get(id(n), [])
            eo = getattr(sched, "_edge_out", {})
            for (pid, _aid), w in eo.items():
                if pid == id(n):
                    writes.append(w)
            sched.ops.append(_Op(
                method=n.method_name,
                arg_src=tuple(src_for(a) for a in n.args),
                kwarg_src={k: src_for(v) for k, v in n.kwargs.items()},
                writes=tuple(writes), pos=pos_of[id(n)],
                collective=getattr(n, "collective", None)))

        # collective groups: nodes marked by dag.collective.allreduce
        self._wire_collectives(compute, scheds, actors)

        # actor handles by id() key — dag/recovery.py probes these for
        # DEAD/RESTARTING peers when a tick read times out
        self._actors = dict(actors)
        # restart baseline: an actor that RESTARTED since this compile
        # is back to ALIVE but is NOT running this ring's loop — its
        # num_restarts moving past this baseline marks it failed even
        # when a liveness probe never catches the DEAD window
        self._restart_baseline = {
            hexid: info[1] for hexid, info in self._peer_info().items()}

        # ---- materialize channels ---------------------------------------
        # every Ineligible check has passed by here: a failure below is a
        # hard error (e.g. a consumer actor died before its endpoint
        # RPC), and the already-created rings were opened UNTRACKED
        # (resource_tracker disabled by design) — close them on the way
        # out or each failed compile leaks its /dev/shm segments
        try:
            self._init_channels(plans, plan_ends, actors, scheds)
        except Exception:
            for p in plans:
                if p.handle is not None:
                    try:
                        p.handle.close()
                    except Exception:
                        pass
            raise

    def _init_channels(self, plans, plan_ends, actors, scheds):
        self._materialize_channels(plans, actors)
        # device plans: wrap the transport spec/handle in the tensor
        # raw-bytes framing (actors attach the wrapped flavor via
        # the spec; the driver's handles wrap here)
        for p in plans:
            if p.device:
                p.spec = DeviceChannelSpec(name=_chan_key(p.spec),
                                           inner=p.spec)
                if p.handle is not None:
                    p.handle = DeviceTransportChannel(p.handle, p.spec)
        self.channel_kinds = {
            "shm": sum(p.kind == "shm" and not p.device for p in plans),
            "dcn": sum(p.kind == "dcn" and not p.device for p in plans),
            "device": sum(p.device for p in plans),
        }
        # placement-quality metric (core/placement.py): fraction of
        # edges whose compiled transport avoided the DCN fallback
        from ray_tpu_torch.core.placement import preferred_kind_summary
        _pk = preferred_kind_summary(
            [{"transport": p.kind, "device": p.device} for p in plans])
        self.preferred_kind_ratio = _pk["ratio"]
        self._preferred_kinds = _pk["preferred"]

        # schedules now carry real specs instead of plan indices
        for sched in scheds.values():
            sched.in_channels = [plans[i].spec for i in sched.in_channels]
            sched.out_channels = [plans[i].spec for i in sched.out_channels]

        # driver-held handles. Input channels need a PRODUCER handle on
        # the driver (dial actor-owned DCN endpoints); outputs and
        # driver-created rings use the materialized handle directly.
        self._input_channels = []
        for i in self._input_plan_idx:
            p = plans[i]
            if p.handle is None:          # actor-owned DCN endpoint
                inner_spec = (p.spec.inner
                              if isinstance(p.spec, DeviceChannelSpec)
                              else p.spec)
                h = DcnProducerChannel(inner_spec, self._cw)
                p.handle = (DeviceTransportChannel(h, p.spec)
                            if p.device else h)
            self._input_channels.append(p.handle)
        # the broadcast in execute() serializes once per framing flavor
        # (today device_input marks ALL input edges at once, so exactly
        # one of these lists is non-empty; the split keeps execute()
        # correct if per-actor device inputs ever land)
        self._host_input_channels = [
            ch for ch in self._input_channels
            if not getattr(ch, "is_device", False)]
        self._device_input_channels = [
            ch for ch in self._input_channels
            if getattr(ch, "is_device", False)]
        self._output_channels = [plans[i].handle
                                 for i in self._output_plan_idx]
        # every driver-held handle, each closed exactly once at teardown
        self._driver_channels = [p.handle for p in plans
                                 if p.handle is not None]
        # map driver-held channels back to their wire identity for
        # teardown logging + timeout diagnostics
        self._chan_kind = {_chan_key(p.spec):
                           ("device" if p.device else p.kind)
                           for p in plans}

        # ---- register the DAG with the GCS ------------------------------
        # synchronous: the record (edge topology + channel kinds) must
        # exist before the first report/stall can reference an edge
        report_state = bool(self._cfg.dag_state_enabled)
        self._register_dag(plans, plan_ends, actors, report_state)

        # best-effort compile-time consult of the GCS placement plane:
        # records where the plane would have packed this gang and how
        # many edges the CURRENT placement co-locates (`rayt dag <id>`
        # and the envelope bench read it; compile never blocks on it)
        self.plane_advice = None
        try:
            n_actors = len({k for pair in plan_ends for k in pair
                            if k is not None})
            edge_nodes = [
                (self._my_node if prod is None
                 else self._node_of.get(prod, ""),
                 self._my_node if cons is None
                 else self._node_of.get(cons, ""))
                for prod, cons in plan_ends]
            self.plane_advice = self._cw.io.run(
                self._cw.gcs.call("placement_advise_dag", {
                    "demands": [{"CPU": 1.0}] * n_actors,
                    "edge_nodes": edge_nodes,
                    "dag_id": self.dag_id}),
                timeout=5.0)
        except Exception:
            logger.debug("dag %s placement-plane consult failed",
                         self.dag_id, exc_info=True)

        # ---- launch the actor loops ------------------------------------
        self._loop_refs = []
        for aid, sched in scheds.items():
            blob = pickle.dumps(_ActorSchedule(
                in_channels=sched.in_channels,
                out_channels=sched.out_channels,
                ops=sched.ops, input_ch=sched.input_ch,
                collective_group=sched.collective_group,
                collective_world=sched.collective_world,
                collective_rank=sched.collective_rank,
                dag_id=self.dag_id if report_state else "",
                epoch=self.epoch))
            handle = actors[aid]
            from ray_tpu_torch.api import ActorMethod

            m = ActorMethod(handle, "__rayt_apply__")
            self._loop_refs.append(m.remote(_dag_actor_loop, blob))

        # driver-side reporter: covers the edges the DRIVER is a peer of
        # (producer on input channels, consumer on outputs)
        self._reporter = None
        if report_state:
            self._reporter = _DagReporter(
                self.dag_id,
                [("producer", ch) for ch in self._input_channels]
                + [("consumer", ch) for ch in self._output_channels],
                cw=self._cw)
            self._reporter.start()

    # ------------------------------------------------------------ helpers
    @staticmethod
    def _data_upstream(n: ClassMethodNode):
        out = [a for a in n.args if isinstance(a, DAGNode)]
        out += [v for v in n.kwargs.values() if isinstance(v, DAGNode)]
        return out

    def _actor_placement(self, compute) -> dict[int, str]:
        """Resolve each actor's node so compile can pick shm vs DCN per
        edge. Waits briefly for still-constructing actors to get placed."""
        import time as _time

        cw = self._cw
        placement: dict[int, str] = {}
        for n in compute:
            key = id(n.actor)
            if key in placement:
                continue
            aid = n.actor._actor_id
            deadline = _time.monotonic() + 60.0
            while True:
                node_id = None
                try:
                    res = cw.io.run(cw.gcs.actor_handle_state(aid))
                    node_id = res[4] if res else None
                except Exception:
                    pass  # transient GCS hiccup: retry within the deadline
                if node_id is not None:
                    break
                if _time.monotonic() > deadline:
                    raise Ineligible("actor placement unknown")
                _time.sleep(0.05)
            placement[key] = node_id
        return placement

    def _materialize_channels(self, plans: list[_ChanPlan], actors: dict):
        """Create driver-owned channels locally, then actor-owned DCN
        endpoints via one __rayt_apply__ per consumer actor."""
        import ray_tpu_torch as rt

        by_owner: dict[int, list[int]] = {}
        for i, p in enumerate(plans):
            if p.owner is None:
                if p.kind == "shm":
                    ch = ShmChannel.create(p.slot_size, p.n_slots)
                else:
                    ch = create_endpoint(f"dag-{uuid.uuid4().hex[:16]}",
                                         p.n_slots, p.slot_size, self._cw)
                p.spec, p.handle = ch.spec, ch
            else:
                by_owner.setdefault(p.owner, []).append(i)
        if not by_owner:
            return
        from ray_tpu_torch.api import ActorMethod

        pending = []
        for owner, idxs in by_owner.items():
            reqs = [(f"dag-{uuid.uuid4().hex[:16]}", plans[i].n_slots,
                     plans[i].slot_size) for i in idxs]
            m = ActorMethod(actors[owner], "__rayt_apply__")
            pending.append((idxs, m.remote(_dcn_create_endpoints, reqs)))
        for idxs, ref in pending:
            specs = rt.get(ref, timeout=120.0)
            for i, spec in zip(idxs, specs):
                plans[i].spec = spec

    def _register_dag(self, plans, plan_ends, actors, enabled: bool):
        """Publish the DAG's edge topology to the GCS dag manager."""
        if not enabled:
            return

        def node_of(key):
            return self._my_node if key is None else \
                self._node_of.get(key, "")

        def endpoint(key):
            if key is None:
                return {"actor": "", "label": "driver",
                        "node": self._my_node}
            h = actors[key]
            hexid = h._actor_id.hex()
            cls = getattr(h, "_class_name", "") or "actor"
            return {"actor": hexid, "label": f"{cls}:{hexid[:8]}",
                    "node": node_of(key)}

        edges = []
        for i, (p, (prod, cons)) in enumerate(zip(plans, plan_ends)):
            role = ("input" if prod is None
                    else "output" if cons is None else "edge")
            edges.append({
                "edge": f"e{i}", "channel": _chan_key(p.spec),
                "kind": "device" if p.device else p.kind,
                "transport": p.kind,   # shm|dcn beneath a device edge
                "preferred": self._preferred_kinds[i],
                "n_slots": p.n_slots,
                "slot_size": p.slot_size, "role": role,
                "producer": endpoint(prod), "consumer": endpoint(cons),
            })
        reg = {"kind": "register", "dag_id": self.dag_id,
               "job_id": self._cw.job_id.hex(),
               "driver": self._cw.worker_info.worker_id.hex(),
               "ts": time.time(), "edges": edges,
               "channel_kinds": dict(self.channel_kinds),
               "preferred_kind_ratio": self.preferred_kind_ratio,
               "epoch": self.epoch,
               "recovered_from": self.recovered_from}
        try:
            self._cw.io.run(self._cw.gcs.publish(CH_DAGS, reg),
                            timeout=10.0)
        except Exception:
            logger.debug("dag %s registration publish failed",
                         self.dag_id, exc_info=True)

    def _publish_teardown(self):
        if self._reporter is None:
            return
        if getattr(self._cw, "_closing", False):
            return  # __del__-driven teardown after rt.shutdown()
        msg = {"kind": "teardown", "dag_id": self.dag_id,
               "ts": time.time()}
        try:
            # synchronous: `rayt list dags` right after teardown() must
            # see TORN_DOWN with every stall flag cleared
            self._cw.io.run(self._cw.gcs.publish(CH_DAGS, msg),
                            timeout=5.0)
        except Exception:
            pass

    def _stall_diagnosis(self) -> str:
        """Ask the GCS dag manager whether the watchdog has attributed a
        stall on this DAG's edges; one line per flagged edge, naming the
        culprit and — when the peer actor is DEAD — the dead peer."""
        try:
            out = self._cw.io.run(
                self._cw.gcs.call("list_dags",
                                  {"dag_id": self.dag_id, "limit": 1}),
                timeout=5.0)
            recs = (out or {}).get("dags") or []
            if not recs:
                return ""
            lines = []
            for e in recs[0]["edges"]:
                s = e.get("stall")
                if not s:
                    continue
                line = (f"stalled edge {e['edge']} "
                        f"{e['producer']['label']}->"
                        f"{e['consumer']['label']} "
                        f"({s['blocked']}-blocked {s['blocked_s']:.1f}s")
                if s.get("dead_peer"):
                    line += (f"; peer {s['culprit']} is DEAD — actor "
                             f"{s['dead_peer']} died and stalled the "
                             "ring")
                elif s.get("culprit_state"):
                    line += (f"; culprit {s['culprit']} "
                             f"state={s['culprit_state']}")
                line += ")"
                lines.append(line)
            return "; ".join(lines)
        except Exception:
            return ""

    def _peer_info(self) -> dict[str, tuple]:
        """actor_id hex -> (state, num_restarts) for every DAG actor
        (one lightweight RPC each; unknown actors report DEAD)."""
        info: dict[str, tuple] = {}
        for handle in self._actors.values():
            aid = handle._actor_id
            try:
                res = self._cw.io.run(
                    self._cw.gcs.actor_handle_state(aid), timeout=5.0)
                if res:
                    info[aid.hex()] = (res[0], int(res[3] or 0))
                else:
                    info[aid.hex()] = ("DEAD", 0)
            except Exception:
                info[aid.hex()] = ("UNKNOWN", 0)
        return info

    def actor_states(self) -> dict[str, str]:
        """actor_id hex -> GCS lifecycle state for every DAG actor."""
        return {hexid: st for hexid, (st, _) in self._peer_info().items()}

    def failed_peers(self) -> dict[str, str]:
        """The DAG actors the control plane considers gone from THIS
        ring: GCS state DEAD/RESTARTING, actors whose num_restarts moved
        past the compile-time baseline (restarted fast enough that no
        probe caught the DEAD window — the fresh incarnation is not
        running this ring's loop), unioned with the stall watchdog's
        dead-peer attribution on this DAG's record. Empty dict = every
        peer looks alive (a tick timeout is then a stall, not a
        death)."""
        failed: dict[str, str] = {}
        for hexid, (st, restarts) in self._peer_info().items():
            if st in ("DEAD", "RESTARTING"):
                failed[hexid] = st
            elif restarts > self._restart_baseline.get(hexid, 0):
                failed[hexid] = "RESTARTED"
        try:
            out = self._cw.io.run(
                self._cw.gcs.call("list_dags",
                                  {"dag_id": self.dag_id, "limit": 1}),
                timeout=5.0)
            recs = (out or {}).get("dags") or []
            for e in (recs[0]["edges"] if recs else []):
                s = e.get("stall") or {}
                if s.get("dead_peer"):
                    failed.setdefault(s["dead_peer"], "DEAD")
        except Exception:
            pass
        return failed

    def _timeout_message(self, timeout_s: float, consumed: int) -> str:
        """The enriched _get_tick timeout: per-output-channel cursor
        positions (mid-wave desync is diagnosable from the exception
        alone) plus the watchdog's stall attribution when one exists."""
        cursors = []
        for i, ch in enumerate(self._output_channels):
            try:
                r, w = ch.cursor_state()
                cursors.append(f"out{i}=read:{r}/written:{w}")
            except Exception:
                cursors.append(f"out{i}=?")
        msg = (f"tick {self._next_read} output read timed out after "
               f"{timeout_s:.1f}s ({consumed}/"
               f"{len(self._output_channels)} outputs consumed this "
               f"wave; cursors: {', '.join(cursors)}) "
               f"[dag {self.dag_id}]")
        stall = self._stall_diagnosis()
        if stall:
            msg += "; " + stall
        return msg

    def _wire_collectives(self, compute, scheds, actors):
        for n in compute:
            gname = getattr(n, "collective_group", None)
            if not gname:
                continue
            sched = scheds[id(n.actor)]
            if sched.collective_group not in (None, gname):
                raise Ineligible("one collective group per actor")
            sched.collective_group = gname
            sched.collective_world = n.collective_world
            sched.collective_rank = n.collective_rank

    # ---------------------------------------------------------- execution
    def execute(self, *args, **kwargs) -> ChannelDagRef:
        if self._closed:
            raise RuntimeError("DAG is torn down")
        if len(args) == 1 and not kwargs:
            value = args[0]
        else:
            value = (args, kwargs)
        from ray_tpu_torch._internal import otel
        from ray_tpu_torch._internal.serialization import (serialize,
                                                           serialized_size)

        timeout = self._cfg.dag_tick_timeout_s
        span = _NULL_SPAN
        if otel.tracing_enabled():
            # the tick's root span: its carrier rides the input edges
            # inside a _TraceTick envelope, so every downstream compute
            # span (and the driver's read) joins ONE distributed trace
            span = otel.submit_span("dag.execute", dag_id=self.dag_id,
                                    tick=self._tick)
        with span:
            carrier = otel.current_context_carrier()

            def _wrap(v):
                v = (_TraceTick(carrier, self._tick, v)
                     if carrier is not None else v)
                # epoch stamp OUTERMOST (recovered DAGs only): actor
                # loops discard frames whose epoch predates the resume
                return _EpochTick(self.epoch, v) if self.epoch else v

            # serialize ONCE PER FRAMING FLAVOR, scatter the same chunk
            # list into every input channel of that flavor (N-runner
            # broadcasts pay one serialize; a mixed host+device input
            # set pays two)
            if self._host_input_channels:
                chunks = serialize(_wrap(value))
                total = serialized_size(chunks)
                for ch in self._host_input_channels:
                    ch.write_chunks(chunks, total, timeout=timeout)
            if self._device_input_channels:
                packed, n_arrays = pack_device_tree(value)
                chunks = serialize(_wrap(packed))
                total = serialized_size(chunks)
                for ch in self._device_input_channels:
                    ch.write_chunks(chunks, total, timeout=timeout)
                    ch.add_device_arrays(n_arrays)
        ref = ChannelDagRef(self, self._tick)
        self._tick += 1
        return ref

    # pipelined submission is the default: execute() never waits for
    # results, so successive calls overlap through the channels
    execute_async = execute

    def _get_tick(self, tick: int, timeout: float | None):
        """Resolve one tick's outputs under ONE overall deadline (the
        per-channel reads share it, so the total wait is `timeout`, not
        timeout × n_outputs; the default comes from
        RAYT_DAG_TICK_TIMEOUT_S). A deadline firing MID-WAVE keeps the
        already-consumed outputs in ``self._partial``: the next get()
        resumes at the first unread channel, so the per-channel cursors
        never desynchronize across ticks. A timeout raises with the
        per-output-channel cursor positions and — when the GCS watchdog
        has attributed a stall — the culprit edge and dead peer."""
        import time as _time

        timeout_s = (self._cfg.dag_tick_timeout_s if timeout is None
                     else timeout)
        deadline = _time.monotonic() + timeout_s
        while tick not in self._buffered:
            vals = self._partial
            while len(vals) < len(self._output_channels):
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        self._timeout_message(timeout_s, len(vals)))
                try:
                    v = self._output_channels[len(vals)].read(
                        timeout=remaining)
                except TimeoutError:
                    raise TimeoutError(self._timeout_message(
                        timeout_s, len(vals))) from None
                if type(v) is _EpochTick:
                    if v.epoch != self.epoch:
                        continue   # stale pre-failure frame: discard
                    v = v.value
                elif self.epoch:
                    continue       # unstamped frame predates recovery
                if type(v) is _TraceTick:
                    v = v.value
                vals.append(v)
            self._buffered[self._next_read] = vals
            self._partial = []
            self._next_read += 1
        vals = self._buffered.pop(tick)
        err = next((v for v in vals if isinstance(v, _TickError)), None)
        if err is not None:
            raise err.err from DagRemoteTraceback(err.tb)
        return vals if self._multi else vals[0]

    def teardown(self):
        if self._closed:
            return
        self._closed = True
        # stop + JOIN the driver reporter before any channel closes: a
        # snapshot racing a close would hit the ring's native-atomics
        # load on an unmapped address (SIGSEGV, not an exception)
        if self._reporter is not None:
            self._reporter.stop(join=True)
        # close inputs FIRST: actor loops drain and exit, closing their
        # own edge/output ends (shutdown cascades along graph edges)
        for ch in self._input_channels:
            logger.debug("dag %s teardown: closing input channel %s",
                         self.dag_id, _chan_key(ch.spec))
            try:
                ch.close()
            except Exception:
                pass
        import ray_tpu_torch as rt

        done = []
        try:
            # short first wait: loops exit in ms when nothing is blocked
            done, _ = rt.wait(self._loop_refs,
                              num_returns=len(self._loop_refs),
                              timeout=2.0)
        except Exception:
            pass
        if len(done) < len(self._loop_refs):
            logger.debug(
                "dag %s teardown: %d/%d actor loops still parked — "
                "closing every driver-held channel to unblock them",
                self.dag_id, len(self._loop_refs) - len(done),
                len(self._loop_refs))
        # then every driver-held handle exactly once (close() is
        # idempotent, so handles shared with _input_channels are safe).
        # This also unblocks actor loops still parked on a FULL
        # driver-held ring (write sees the closed flag) or an un-drained
        # output channel, letting them exit cleanly below.
        for ch in self._driver_channels:
            key = _chan_key(ch.spec)
            logger.debug("dag %s teardown: closing %s channel %s",
                         self.dag_id, self._chan_kind.get(key, "?"), key)
            try:
                ch.close()
            except Exception:
                pass
        try:
            rt.wait(self._loop_refs, num_returns=len(self._loop_refs),
                    timeout=25.0)
        except Exception:
            pass
        # mark the GCS record TORN_DOWN (clears every stall flag)
        self._publish_teardown()

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            pass
