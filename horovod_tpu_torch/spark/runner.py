"""Horovod on Spark for the port (the JAX package's ``spark/runner.py``;
Horovod's ``horovod/spark/runner.py:195`` ``run(fn, args...)``: run fn in
``num_proc`` Spark tasks, return the per-rank results).

A **barrier-mode RDD** schedules all ``num_proc`` tasks at once;
``BarrierTaskContext.getTaskInfos()`` gives every task the full address
list, and task 0's host runs the process group's TCP store. Rank =
partition id.

Each task joins the process group on the card of its local rank (NCCL)
unless ``device`` names another: ``device="cpu"`` runs on gloo. (The JAX
package's tasks pin JAX to the CPU by default.)

``slot_envs_from_task_infos`` is pure logic, testable without pyspark;
``run`` and ``run_elastic`` are import-gated.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional


def slot_envs_from_task_infos(addresses: List[str], master_port: int,
                              ) -> List[Dict[str, str]]:
    """Per-rank HVT_* env from the barrier task address list (``host:port``
    strings, rank-ordered). Local ranks count occurrences of the same host
    before each rank; cross ranks index the hosts having that local slot
    (the semantics of ``hosts.get_host_assignments``). The master's address
    is given as ``HVT_MASTER_ADDR``/``HVT_MASTER_PORT`` (the JAX package's
    keys) and as ``HVT_COORDINATOR_ADDR``, which the port's ``init``
    reads."""
    from horovod_tpu_torch.runner.hosts import SlotInfo, slot_env_vars

    hosts = [a.rsplit(":", 1)[0] for a in addresses]
    size = len(hosts)
    envs = []
    for rank, host in enumerate(hosts):
        # rank must equal the Spark partition id, so hosts may interleave:
        # local and cross ranks are computed positionally, not regrouped
        local_rank = hosts[:rank].count(host)
        hosts_with_slot = [h for h in dict.fromkeys(hosts)
                           if hosts.count(h) > local_rank]
        slot = SlotInfo(hostname=host, rank=rank, local_rank=local_rank,
                        cross_rank=hosts_with_slot.index(host), size=size,
                        local_size=hosts.count(host),
                        cross_size=len(hosts_with_slot))
        env = slot_env_vars(slot)
        env.update({"HVT_MASTER_ADDR": hosts[0],
                    "HVT_MASTER_PORT": str(master_port),
                    "HVT_COORDINATOR_ADDR": f"{hosts[0]}:{master_port}"})
        envs.append(env)
    return envs


def _require_pyspark():
    try:
        import pyspark  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.spark requires pyspark; machine-local "
            "equivalents are python -m horovod_tpu_torch.runner.launch and "
            "horovod_tpu_torch.runner.run") from e


def run(fn: Callable, args=(), kwargs=None, num_proc: Optional[int] = None,
        master_port: int = 29570, device: Optional[str] = None,
        extra_env: Optional[dict] = None, verbose: bool = False
        ) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` in ``num_proc`` Spark barrier tasks with
    the port's process group started in each, on the card unless ``device``
    names another; returns the per-rank results ordered by rank (Horovod's
    ``spark/runner.py:195``)."""
    _require_pyspark()
    from pyspark import BarrierTaskContext
    from pyspark.sql import SparkSession

    spark = SparkSession.builder.getOrCreate()
    sc = spark.sparkContext
    if num_proc is None:
        num_proc = int(sc.defaultParallelism)
    kwargs = kwargs or {}
    captured_env = dict(extra_env or {})

    def task(_it):
        ctx = BarrierTaskContext.get()
        infos = ctx.getTaskInfos()
        addresses = [t.address for t in infos]
        rank = ctx.partitionId()
        env = slot_envs_from_task_infos(addresses, master_port)[rank]
        env.update(captured_env)
        os.environ.update(env)
        ctx.barrier()      # everyone has its env before anyone inits
        import horovod_tpu_torch as hvt

        hvt.init(device=device)
        try:
            result = fn(*args, **kwargs)
        finally:
            hvt.shutdown()
        yield rank, result

    pairs = (sc.parallelize(range(num_proc), num_proc)
             .barrier()
             .mapPartitions(task)
             .collect())
    return [r for _, r in sorted(pairs, key=lambda p: p[0])]


def _elastic_attempt_loop(attempt, available_slots, num_proc=None,
                          min_np=None, max_np=None, reset_limit=3,
                          elastic_timeout=600.0, _sleep=None,
                          _monotonic=None):
    """Driver-side elastic retry loop, pure and unit-testable.

    ``attempt(world_size, attempt_idx)`` runs one gang; on failure the
    world is RE-SIZED from ``available_slots()`` (scale up and down
    between attempts, clamped to [min_np, max_np]) and retried, up to
    ``reset_limit`` resets (reference spark/runner.py:303 semantics).
    ``max_np`` defaults to ``num_proc`` when given — a reset must not
    silently outgrow the requested world (the convention of the port's
    launcher). A slot pool momentarily below ``min_np`` is waited out up
    to ``elastic_timeout`` seconds (the launcher's --elastic-timeout)
    before the job is declared dead.
    """
    import time as _time

    _sleep = _sleep or _time.sleep
    _monotonic = _monotonic or _time.monotonic
    if num_proc is not None and max_np is None:
        max_np = num_proc
    if (min_np is not None and max_np is not None and min_np > max_np):
        raise ValueError(f"min_np ({min_np}) > max_np ({max_np})")
    if (min_np is not None and num_proc is not None
            and num_proc < min_np):
        raise ValueError(f"num_proc ({num_proc}) < min_np ({min_np})")
    last_err = None
    for i in range(reset_limit + 1):
        world = available_slots()
        if min_np is not None and world < min_np:
            # a transient dip (executor replacement in flight) is the
            # exact event elasticity exists to survive — wait it out
            deadline = _monotonic() + elastic_timeout
            while world < min_np and _monotonic() < deadline:
                _sleep(min(5.0, max(elastic_timeout / 10.0, 0.1)))
                world = available_slots()
            if world < min_np:
                raise RuntimeError(
                    f"elastic job needs min_np={min_np} slots but only "
                    f"{world} were available after waiting "
                    f"{elastic_timeout:.0f}s") from last_err
        if i == 0 and num_proc is not None:
            world = num_proc
        if max_np is not None:
            world = min(world, max_np)
        if world < 1:
            raise RuntimeError("no slots available") from last_err
        try:
            return attempt(world, i)
        except Exception as e:  # gang failed — reset and re-size
            last_err = e
    raise RuntimeError(
        f"elastic job failed after {reset_limit + 1} attempts "
        f"(reset_limit={reset_limit})") from last_err


def run_elastic(fn: Callable, args=(), kwargs=None,
                num_proc: Optional[int] = None,
                min_np: Optional[int] = None,
                max_np: Optional[int] = None, reset_limit: int = 3,
                elastic_timeout: float = 600.0,
                master_port: int = 29571, device: Optional[str] = None,
                extra_env: Optional[dict] = None) -> List[Any]:
    """Elastic Horovod on Spark (Horovod's ``spark/runner.py:303``
    ``run_elastic``).

    Spark's barrier mode gang-schedules every task of a stage, so
    elasticity maps to stage boundaries: a task failure tears the whole
    attempt down, the world is re-sized to the slots available at the retry
    (down after an executor is lost, up after new ones join, clamped to
    ``[min_np, max_np]``), and ``fn`` runs again with ``HVT_ELASTIC_ATTEMPT``
    advanced in its environment. ``fn`` should restore from its last commit
    or checkpoint on a non-zero attempt. ``reset_limit`` bounds the number
    of resets.
    """
    _require_pyspark()
    from pyspark.sql import SparkSession

    spark = SparkSession.builder.getOrCreate()
    sc = spark.sparkContext

    def available_slots() -> int:
        return int(sc.defaultParallelism)

    def attempt(world: int, attempt_idx: int):
        env = dict(extra_env or {})
        env["HVT_ELASTIC_ATTEMPT"] = str(attempt_idx)
        # a fresh port per attempt: a dying gang can leave the previous
        # TCP store's port in TIME_WAIT on the master host
        return run(fn, args=args, kwargs=kwargs, num_proc=world,
                   master_port=master_port + attempt_idx, device=device,
                   extra_env=env)

    return _elastic_attempt_loop(attempt, available_slots,
                                 num_proc=num_proc, min_np=min_np,
                                 max_np=max_np, reset_limit=reset_limit,
                                 elastic_timeout=elastic_timeout)
