"""Process topology and lifecycle on ``torch.distributed``.

One process drives one GPU, as in Horovod: ``rank``/``size`` count
processes and each process owns ``cuda:{local_rank}``. This differs from
the JAX package (``horovod_tpu/common/basics.py``), where one process drives
every chip of its host and ``size`` counts chips.

``init`` reads the identity env that the ``hvtrun`` launcher gives each slot
(``HVT_PROCESS_ID``, ``HVT_NUM_PROCESSES``, ``HVT_LOCAL_PROCESS_ID``,
``HVT_LOCAL_SIZE``, ``HVT_CROSS_RANK``, ``HVT_CROSS_SIZE``, and
``HVT_COORDINATOR_ADDR`` as ``host:port``); a process that ``mpirun`` or
``jsrun`` started takes what is missing from their environment
(``runner/mpi_run.py``). With more than one process it
joins them on a TCP store at the coordinator's address; without that env it
starts a world of one process on an in-memory store. The backend is NCCL
on the GPU, or gloo when the caller passes ``device="cpu"``.

Elastic training (``horovod_tpu_torch.elastic``) ends a world and starts the
next: :func:`reinit` starts it with the device and timeout of the last
:func:`init`, and :func:`abort`, callable from any thread, marks a world
whose peer died (on NCCL it aborts the communicators, so a collective
blocked on that peer returns), and every later collective raises
``HorovodInternalError``.

Observability (the JAX package's ``basics.py:113-160``): with
``HVT_METRICS_PORT`` (``launch --metrics-port``) ``init`` serves ``GET
/metrics`` at that base port + rank (0: an ephemeral port), and with
``HVT_TIMELINE_SHARD`` (``launch --timeline``) it records this rank's
timeline shard ``<base>.rank<r>``, its clock aligned to the launcher's
``GET /clock`` (``HVT_DIAG_ADDR``, or the elastic ``HVT_RENDEZVOUS_ADDR``)
and uploaded there by ``shutdown``. A port that cannot be bound or a shard
that cannot be opened raises. :func:`reinit` brings both back on the same
port and the same shard. :func:`diagnostics` names this rank's collectives
in flight. When that KV server is known, ``init`` also starts the telemetry
push loop (:func:`_debugz_push_loop`, ``metrics/telemetry.py``) that feeds
its ``GET /debugz`` and ``GET /statusz``; ``shutdown`` stops it.
"""

from __future__ import annotations

import atexit
import os
import threading
from datetime import timedelta

import torch
import torch.distributed as dist

_lock = threading.Lock()
_state = None  # the running world's _World, or None
# the device and timeout of the last init(), which reinit() takes again
_last_init = {"device": None, "timeout_s": 300}
# the metrics port bound and the timeline shard (path, pid) the first init
# started, which reinit() starts again
_observe = {"metrics_port": None, "shard": None}


class _World:
    def __init__(self, rank, size, local_rank, local_size, cross_rank,
                 cross_size, device):
        self.rank, self.size = rank, size
        self.local_rank, self.local_size = local_rank, local_size
        self.cross_rank, self.cross_size = cross_rank, cross_size
        self.device = device
        # registered process sets by id (common/process_sets.py) and the
        # groups derived from the topology (ops/hierarchical.py)
        self.process_sets = {}
        self.next_process_set_id = 1
        self.groups = {}
        # the elastic rendezvous round this world belongs to, and why it
        # was aborted (None while it is healthy)
        self.elastic_round = os.environ.get("HVT_ELASTIC_ROUND")
        self.aborted = None
        # the telemetry pusher of this world (_start_push_loop)
        self.push_stop = None
        self.push_thread = None


def _env_int(name, default):
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when CUDA is asked for and missing; it never falls
    back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run on the CPU")
    return device


def init(comm=None, process_sets=None, device=None, timeout_s=300):
    """Start the process group (idempotent).

    ``device`` is ``None``/``"cuda"`` (NCCL on ``cuda:{local_rank}``) or
    ``"cpu"`` (gloo). ``comm`` is accepted for API parity and must be
    ``None``: process placement belongs to the launcher. ``process_sets``
    (lists of ranks or ``ProcessSet`` objects) are registered in order
    after the global set, as ``add_process_set`` does; every process
    passes the same.
    """
    if comm not in (None, 0):
        raise ValueError("horovod_tpu_torch.init(comm=...) is not "
                         "supported: process placement is owned by the "
                         "launcher (hvtrun)")
    _start(device, timeout_s)
    _last_init.update(device=device, timeout_s=timeout_s)
    _start_observers()
    _start_push_loop()
    from horovod_tpu_torch.common import process_sets as _ps

    for ps in process_sets or ():
        _ps.add_process_set(ps)


def _start(device, timeout_s):
    global _state
    with _lock:
        if _state is not None:
            return
        _identity_from_mpi()
        size = _env_int("HVT_NUM_PROCESSES", 1)
        rank = _env_int("HVT_PROCESS_ID", 0)
        local_rank = _env_int("HVT_LOCAL_PROCESS_ID", 0)
        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", local_rank)
            torch.cuda.set_device(dev)
            backend = "nccl"
        else:
            backend = "gloo"
        timeout = timedelta(seconds=timeout_s)
        coordinator = os.environ.get("HVT_COORDINATOR_ADDR")
        if size > 1:
            if not coordinator:
                raise ValueError("HVT_NUM_PROCESSES > 1 needs "
                                 "HVT_COORDINATOR_ADDR (host:port)")
            dist.init_process_group(backend,
                                    init_method=f"tcp://{coordinator}",
                                    world_size=size, rank=rank,
                                    timeout=timeout)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0, timeout=timeout)
        _state = _World(rank, size, local_rank,
                        _env_int("HVT_LOCAL_SIZE", 1),
                        _env_int("HVT_CROSS_RANK", 0),
                        _env_int("HVT_CROSS_SIZE", 1), dev)
        from horovod_tpu_torch.common.process_sets import \
            global_process_set

        global_process_set.process_set_id = 0
        _state.process_sets[0] = global_process_set
        from horovod_tpu_torch import compression
        from horovod_tpu_torch.ops import collective_ops, negotiation

        collective_ops._reset_world()
        negotiation.start(rank, size, timeout_s)
        compression.configure()


def _identity_from_mpi():
    """A process that ``mpirun`` or ``jsrun`` started (``launch --use-mpi``
    / ``--use-jsrun``) has no ``HVT_*`` slot identity: take it from MPI's
    environment or jsrun's, and derive the cross rank and size from the
    local size. Variables already set are kept."""
    from horovod_tpu_torch.runner.js_run import env_from_jsm
    from horovod_tpu_torch.runner.mpi_run import env_from_mpi

    derived = env_from_mpi() or env_from_jsm()
    os.environ.update(derived)
    if derived and "HVT_CROSS_RANK" not in os.environ:
        local = _env_int("HVT_LOCAL_SIZE", 1)
        os.environ["HVT_CROSS_RANK"] = str(
            _env_int("HVT_PROCESS_ID", 0) // local)
        os.environ["HVT_CROSS_SIZE"] = str(
            max(1, _env_int("HVT_NUM_PROCESSES", 1) // local))


def _env_on(name) -> bool:
    return os.environ.get(name, "0") not in ("", "0")


def _start_observers():
    """The launcher's metrics endpoint and timeline shard for this rank
    (see the module docstring); each is started once per world."""
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.utils import timeline

    r = rank()
    port = os.environ.get("HVT_METRICS_PORT")
    if port is not None and metrics.server_port() is None:
        if _observe["metrics_port"] is None:
            base = int(port)
            _observe["metrics_port"] = base + r if base else 0
        _observe["metrics_port"] = metrics.serve(_observe["metrics_port"])
        if _env_on("HVT_VERBOSE"):
            print(f"[hvt] metrics endpoint on "
                  f":{_observe['metrics_port']}/metrics")
    shard_base = os.environ.get("HVT_TIMELINE_SHARD")
    if shard_base and not timeline.active():
        first = _observe["shard"] is None
        if first:
            _observe["shard"] = (f"{shard_base}.rank{r}", r)
            atexit.register(timeline.stop)
        path, pid = _observe["shard"]
        addr = _rendezvous_addr()
        meta = {}
        if addr:
            # an unaligned shard still merges, only skewed: the failure is
            # written into the shard rather than raised
            try:
                offset = timeline.measure_clock_offset_us(addr)
                timeline.set_clock_offset_us(offset)
                meta["clock_sync"] = {"server": addr, "offset_us": offset}
            except Exception as e:
                meta["clock_sync"] = {"server": addr,
                                      "error": f"{type(e).__name__}: {e}"}
        # torch.profiler off by default: a session in every worker costs
        # memory and time; HVT_TIMELINE_TORCH_PROFILER=1 opts back in
        timeline.start(path, profiler=_env_on("HVT_TIMELINE_TORCH_PROFILER"),
                       pid=pid, upload_addr=addr, append=not first,
                       meta=meta)


def _rendezvous_addr():
    """The launcher's KV server: the static job's (``--timeline``) or the
    elastic rendezvous."""
    return (os.environ.get("HVT_DIAG_ADDR")
            or os.environ.get("HVT_RENDEZVOUS_ADDR"))


def _start_push_loop():
    """This world's telemetry pusher (the JAX package's
    ``basics.py:156-163``), when the launcher's KV server is known."""
    world = _state
    addr = _rendezvous_addr()
    if world is None or not addr or world.push_stop is not None:
        return
    world.push_stop = threading.Event()
    world.push_thread = threading.Thread(
        target=_debugz_push_loop, args=(addr, world.rank, world.push_stop),
        daemon=True, name="hvt-telemetry-push")
    world.push_thread.start()


def _stop_push_loop(world):
    if world.push_stop is not None:
        world.push_stop.set()
        # the leader's last relay flush: bounded by the HTTP timeout
        world.push_thread.join(timeout=5)


def _telemetry_stats() -> dict:
    """The port's stats for a telemetry snapshot, from the metrics
    registry: collective bytes and counts per op, encoded wire bytes per op
    and per (codec, op), and the error-feedback residual bytes."""
    from horovod_tpu_torch import metrics

    reg = metrics.registry()

    def per(name, key=lambda labels: labels["op"], value=None):
        out = {}
        metric = reg.get(name)
        for labels, child in (metric.samples() if metric else ()):
            v = value(child) if value else child.value
            out[key(labels)] = out.get(key(labels), 0) + int(v)
        return out

    codec_tx = {}
    for (codec, op), v in per("hvt_wire_tx_bytes_total",
                              key=lambda l: (l["codec"], l["op"])).items():
        codec_tx.setdefault(codec, {})[op] = v
    ef = reg.get("hvt_ef_residual_bytes")
    return {"collective_bytes": per("hvt_collective_bytes_total"),
            "collective_count": per(
                "hvt_collective_latency_seconds",
                value=lambda child: child.snapshot()[2]),
            "wire_tx_bytes": per("hvt_wire_tx_bytes_total"),
            "wire_tx_comp_bytes": per("hvt_wire_tx_compressed_bytes_total"),
            "codec_tx_bytes": codec_tx,
            "ef_residual_bytes": int(ef.value) if ef else 0}


def _telemetry_snapshot(rank: int) -> dict:
    """This worker's push payload (``metrics/telemetry.py``):
    :func:`diagnostics`, whose ``engine`` carries the number of collectives
    pending as its queue depth and the wire-codec pair, plus the compact
    record and the counter frame of :func:`_telemetry_stats`."""
    from horovod_tpu_torch import compression
    from horovod_tpu_torch.metrics import telemetry

    diag = diagnostics()
    intra, inter = compression.wire_pair()
    diag["engine"] = dict(diag["engine"], queue_depth=len(diag["pending"]),
                          wire={"intra": intra, "inter": inter,
                                "auto": compression.auto_active()})
    return telemetry.build_snapshot(rank, telemetry.host_name(), diag,
                                    _telemetry_stats())


def _debugz_push_loop(addr: str, rank: int, stop: "threading.Event"):
    """Push this worker's telemetry until ``stop`` is set: every
    ``HVT_DEBUGZ_INTERVAL_MS`` (default 5000, ±25 % jitter), directly to
    ``/kv/debugz/<rank>``, or through the host leader under
    ``HVT_TELEMETRY_AGG=1``. A dead server never disturbs training."""
    from horovod_tpu_torch.metrics import telemetry

    telemetry.TelemetryPusher(addr, rank, lambda: _telemetry_snapshot(rank),
                              stop).run()


def reinit():
    """Start a new world after :func:`shutdown` on the device and with the
    timeout of the last :func:`init` (elastic training's reset). A CUDA
    device that is gone raises; it never falls back to the CPU."""
    init(**_last_init)


def shutdown():
    """Destroy the process group and every process set's group; a later
    ``init`` starts a new world with only the global set. A world that
    :func:`abort` tore down is only forgotten: destroying a communicator
    whose peer died can hang."""
    global _state
    with _lock:
        if _state is None:
            return
        from horovod_tpu_torch import metrics
        from horovod_tpu_torch.ops import negotiation
        from horovod_tpu_torch.utils import timeline

        negotiation.stop()
        _stop_push_loop(_state)
        # the timeline resolves the last collectives' device spans first,
        # then closes and uploads its shard
        timeline.stop()
        metrics.stop_server()
        for ps in _state.process_sets.values():
            ps.process_set_id, ps._group = None, None
        if _state.aborted is None:
            dist.destroy_process_group()
        elif dist.is_initialized():
            _abort_groups()
        _state = None


def _abort_quietly(group):
    try:
        group.abort()
    except Exception:
        pass    # gone already: the group is torn down either way


def _abort_groups():
    """Abort every group of this process (the world and each ``new_group``)
    and forget them. NCCL's abort ends the kernels still waiting on a peer,
    so the host call blocked on them returns. The groups are aborted at
    once, each from a thread of its own: one communicator's abort can wait
    on the card until a kernel of another, still blocked on the dead peer,
    ends (on four H100s, aborting the replication groups before the world
    waited out the world's 300 s timeout)."""
    c10d = dist.distributed_c10d
    groups = list(c10d._world.pg_names)
    threads = [threading.Thread(target=_abort_quietly, args=(g,), daemon=True)
               for g in groups]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    # forget them: their communicators are gone
    c10d._abort_process_group()


def abort(reason, elastic_round=None) -> bool:
    """Mark the running world failed because a peer died; safe from any
    thread (the elastic driver's notification calls it). Every later
    collective and ``State.commit()`` raises ``HorovodInternalError`` with
    ``reason``, until ``shutdown`` and a new ``init``. With
    ``elastic_round``, only a world of that rendezvous round is aborted.
    Returns whether this call aborted the world.

    On NCCL it also aborts the communicators at once: a kernel waiting on
    the dead peer never ends otherwise, and the host call waiting on the
    kernel returns once it does. A gloo collective in flight is not
    released by an abort from another thread, and the abort would keep
    its sockets open; gloo fails on its own when a peer's socket closes,
    so its groups are aborted by ``shutdown`` in the thread that ran them,
    which closes this process's sockets and fails the peers still waiting
    on it."""
    world = _state
    if world is None or world.aborted is not None:
        return False
    if elastic_round is not None and world.elastic_round is not None \
            and str(elastic_round) != world.elastic_round:
        return False
    world.aborted = str(reason)
    from horovod_tpu_torch.ops import negotiation

    negotiation.release(world.aborted)
    if world.device.type == "cuda" and dist.is_initialized():
        try:
            _abort_groups()
        except Exception:
            pass    # already gone: the world is torn down either way
    return True


def aborted():
    """Why the running world was aborted, or None while it is healthy (or
    when no world runs)."""
    world = _state
    return None if world is None else world.aborted


def is_initialized() -> bool:
    return _state is not None


def _world() -> _World:
    if _state is None:
        raise ValueError("horovod_tpu_torch has not been initialized; run "
                         "hvt.init() first.")
    return _state


def rank() -> int:
    return _world().rank


def size() -> int:
    return _world().size


def local_rank() -> int:
    return _world().local_rank


def local_size() -> int:
    return _world().local_size


def cross_rank() -> int:
    return _world().cross_rank


def cross_size() -> int:
    return _world().cross_size


def device() -> torch.device:
    """The device this process's collectives run on."""
    return _world().device


def process_rank() -> int:
    """This process's index: :func:`rank`, since one process drives one
    GPU (in the JAX package a process drives a host's chips)."""
    return rank()


def process_size() -> int:
    """The number of processes: :func:`size`."""
    return size()


def start_timeline(file_path: str, mark_cycles: bool = False,
                   profiler: bool = True):
    """Begin recording a Chrome-trace timeline of this rank (Horovod's
    ``horovod_start_timeline``; ``utils/timeline.py``). ``profiler=True``
    (default) also arms a ``torch.profiler`` session whose Chrome trace of
    host and device activity ``stop_timeline`` writes to
    ``<file_path>.profiler.json``; pass False when you manage your own
    profiler session. ``mark_cycles`` is accepted for Horovod's signature
    and ignored: the port has no engine cycle to mark."""
    from horovod_tpu_torch.utils import timeline

    del mark_cycles
    timeline.start(file_path, profiler=profiler, pid=rank())


def stop_timeline():
    """Stop the timeline: the device spans of the collectives waited for
    are resolved first, and the profiler's trace is written."""
    _world()
    from horovod_tpu_torch.utils import timeline

    timeline.stop()


def diagnostics() -> dict:
    """This rank's stall-diagnostics snapshot (the JAX package's
    ``diagnostics()``), JSON-serializable:

    - ``process_rank`` and ``timeline_active``;
    - ``pending``: this rank's collectives not yet complete (handles not
      yet waited for, and collectives waited for that the card has not
      finished), each with its name, op, process set and age in seconds;
    - ``joined``: whether this rank is inside ``join()``;
    - ``negotiations``: the negotiations the coordinator
      (``ops/negotiation.py``) sees waiting on the sets this rank is the
      lowest member of, each with its tensor, op, ``waiting_sec``,
      ``arrived_ranks`` and ``missing_ranks``, as the engine lays them out
      (``engine.cc:2652-2675``); ``stalls``: those waiting past
      ``HVT_STALL_WARN_SEC`` with ranks missing; ``stall_warn_sec``;
    - ``engine``: ``{"running": False}``, as the JAX package reports
      without its engine: the port has no C++ engine, so the JAX dict's
      engine counters are not filled."""
    from horovod_tpu_torch.ops import collective_ops, negotiation
    from horovod_tpu_torch.utils import timeline

    world = _state
    return {"process_rank": world.rank if world is not None
            else _env_int("HVT_PROCESS_ID", 0),
            "timeline_active": timeline.active(),
            "pending": collective_ops.pending(),
            "joined": collective_ops.joined(),
            **negotiation.diagnostics(),
            "engine": {"running": False}}


def is_homogeneous() -> bool:
    """True when every host runs the same number of processes: an
    allgather of each process's ``local_size``, so every process calls
    it."""
    from horovod_tpu_torch.ops.collective_ops import allgather

    sizes = allgather(torch.tensor([local_size()], device=device()))
    return len(set(sizes.tolist())) == 1


# What this build can do (Horovod's ``basics.py:216-258``): the data plane is
# torch.distributed, NCCL on the GPU and gloo on the CPU.

def nccl_built() -> bool:
    return dist.is_nccl_available()


def gloo_built() -> bool:
    return dist.is_gloo_available()


def gloo_enabled() -> bool:
    return gloo_built()


def mpi_built() -> bool:
    return dist.is_mpi_available()


def mpi_enabled() -> bool:
    """MPI is never the port's controller: processes join on a TCP store."""
    return False


def mpi_threads_supported() -> bool:
    return False


def cuda_built() -> bool:
    return torch.version.cuda is not None


def rocm_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def ddl_built() -> bool:
    return False


def xla_built() -> bool:
    return False
