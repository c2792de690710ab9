"""A worker of horovod_tpu_torch jobs started by the port's launcher
(``python -m horovod_tpu_torch.runner.launch``), shared by
tests/test_torch_port_launch.py, test_torch_port_fsdp.py,
test_torch_port_checkpoint.py, test_torch_port_api.py,
tests/test_torch_port_cuda.py and chip_smoke.py's ``launch`` phase. Imports
no JAX.

    python tests/torch_port_launch_worker.py MODE OUT [JSON ARGS]

runs ``mode_<MODE>(args)`` after ``hvt.init``, and saves what it returns
with ``torch.save`` to ``OUT.<rank>.pt``. :class:`Launch` starts such a job
through the launcher without waiting; ``Launch.results()`` waits and
returns each rank's results.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDENTITY = ("HVT_PROCESS_ID", "HVT_NUM_PROCESSES", "HVT_LOCAL_PROCESS_ID",
            "HVT_LOCAL_SIZE", "HVT_CROSS_RANK", "HVT_CROSS_SIZE",
            "HVT_HOSTNAME", "HVT_COORDINATOR_ADDR")
# the small MLP of tests/test_fsdp.py, trained by FSDP on these layouts
MLP_D, MLP_BATCH, MLP_STEPS, MLP_LR, MLP_WD = 16, 32, 5, 1e-2, 1e-4
MLP_MIN_SHARD = 256
FSDP_LAYOUTS = [dict(fsdp=4), dict(dp=2, fsdp=2)]
# the small GPT checkpointed by the checkpoint gang
CKPT_GPT = dict(vocab_size=64, n_layers=2, d_model=32, n_heads=2, d_ff=128,
                max_seq_len=16)
CKPT_BATCH, CKPT_STEPS, CKPT_AT = 2, 6, 3


def mlp_params(d=MLP_D, seed=1):
    """tests/test_fsdp.py's ``_params`` as numpy, in the port's names."""
    rs = np.random.RandomState(seed)
    return {"dense.kernel": rs.randn(d, 4 * d).astype(np.float32),
            "dense.bias": rs.randn(4 * d).astype(np.float32),
            "head.kernel": rs.randn(4 * d, d).astype(np.float32),
            "head.scale": np.float32(1.0) * np.ones((), np.float32)}


def mlp_data(d=MLP_D):
    rs = np.random.RandomState(2)
    return (rs.randn(MLP_BATCH, d).astype(np.float32),
            rs.randn(MLP_BATCH, d).astype(np.float32))


def _mlp(params):
    import torch

    class Dense(torch.nn.Module):
        def __init__(self, kernel, **extra):
            super().__init__()
            self.kernel = torch.nn.Parameter(torch.as_tensor(kernel))
            for k, v in extra.items():
                setattr(self, k, torch.nn.Parameter(torch.as_tensor(v)))

    class MLP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.dense = Dense(params["dense.kernel"],
                               bias=params["dense.bias"])
            self.head = Dense(params["head.kernel"],
                              scale=params["head.scale"])

        def forward(self, x):
            h = torch.tanh(x @ self.dense.kernel + self.dense.bias)
            return h @ self.head.kernel * self.head.scale

    return MLP()


def _local_shape(t):
    return tuple((t.to_local() if hasattr(t, "to_local") else t).shape)


def _full(module):
    """Every parameter of ``module`` whole, as a plain tensor."""
    return {n: (p.full_tensor() if hasattr(p, "full_tensor") else p)
            .detach().clone() for n, p in module.named_parameters()}


def _identity():
    import horovod_tpu_torch as hvt

    return {"env": {k: os.environ.get(k) for k in IDENTITY},
            "rank": hvt.rank(), "size": hvt.size(),
            "local_rank": hvt.local_rank(), "local_size": hvt.local_size(),
            "cross_rank": hvt.cross_rank(), "cross_size": hvt.cross_size(),
            "device": str(hvt.device())}


def mode_gpt(args):
    """``args["steps"]`` steps of ``train.train`` on the named GPT, with the
    kernels' launch counts."""
    from horovod_tpu_torch.ops import _kernels as K
    from horovod_tpu_torch.train import gpt_config, train

    cfg = gpt_config(args["config"], use_flash=True)
    K.reset_launches()
    res = train(cfg, args["steps"], args["batch"], args["seq"],
                device=args["device"], seed=0)
    return {**_identity(), "losses": res["loss"],
            "launches": dict(K.LAUNCHES)}


def mode_fail(args):
    """Rank 1 fails at once; the others would run for ``args["sleep"]``
    seconds."""
    import horovod_tpu_torch as hvt

    if hvt.rank() == 1:
        sys.exit(3)
    time.sleep(args["sleep"])
    return {}


def mode_fsdp_mlp(args):
    """The MLP of tests/test_fsdp.py under shard_module on each layout of
    FSDP_LAYOUTS: MLP_STEPS AdamW steps, each rank on its own rows of the
    batch. Returns the spec maps, each step's loss over the whole batch,
    the final parameters gathered, and the local shapes of the parameters
    and of their moments after init_sharded_state."""
    import torch

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.parallel.fsdp import (fsdp_partition_spec,
                                                 init_sharded_state,
                                                 shard_module)
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh

    x, y = (torch.from_numpy(a) for a in mlp_data())
    rows = MLP_BATCH // hvt.size()
    mine = slice(hvt.rank() * rows, (hvt.rank() + 1) * rows)
    out = {}
    for layout in FSDP_LAYOUTS:
        tag = "-".join(f"{k}{v}" for k, v in layout.items())
        mesh = make_parallel_mesh(**layout)
        model = _mlp(mlp_params())
        spec = fsdp_partition_spec(model, mesh,
                                   min_shard_elements=MLP_MIN_SHARD)
        shard_module(model, mesh, min_shard_elements=MLP_MIN_SHARD)
        opt = torch.optim.AdamW(model.parameters(), lr=MLP_LR,
                                weight_decay=MLP_WD)
        state = init_sharded_state(opt)
        shapes = {n: (_local_shape(p), _local_shape(state[p]["exp_avg"]),
                      _local_shape(state[p]["exp_avg_sq"]), tuple(p.shape))
                  for n, p in model.named_parameters()}
        losses = []
        for _ in range(MLP_STEPS):
            opt.zero_grad(set_to_none=True)
            loss = ((model(x[mine]) - y[mine]) ** 2).mean()
            loss.backward()
            opt.step()
            losses.append(float(hvt.allreduce(loss.detach())))
        out[tag] = {"spec": spec, "losses": losses, "params": _full(model),
                    "shapes": shapes, "coords": mesh.coords()}
    try:
        hvt.DistributedOptimizer(torch.optim.AdamW(model.parameters()))
        out["double_reduction"] = "no error"
    except ValueError as e:
        out["double_reduction"] = f"ValueError: {e}"
    return out


def _ckpt_model(seed):
    import torch

    from horovod_tpu_torch.models import GPT, GPTConfig
    from horovod_tpu_torch.parallel.fsdp import shard_module
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh

    import horovod_tpu_torch as hvt

    cfg = GPTConfig(**CKPT_GPT, dtype=torch.float32)
    model = GPT(cfg, device=hvt.device(), seed=seed)
    shard_module(model, make_parallel_mesh(fsdp=hvt.size()),
                 min_shard_elements=512)
    return model, torch.optim.AdamW(model.parameters(), lr=1e-2,
                                    weight_decay=1e-4)


def mode_checkpoint(args):
    """The small GPT sharded over every rank: CKPT_STEPS AdamW steps with an
    async save at step CKPT_AT; then a fresh model restored from it steps
    to CKPT_STEPS again. Then the three restores of one checkpoint: with
    broadcast from rank 1 after each rank's read was perturbed by its rank,
    without broadcast, and without a template."""
    import torch
    import torch.distributed.checkpoint as dcp

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.checkpoint import CheckpointManager
    from horovod_tpu_torch.train import loss_fn, seeded_tokens
    from horovod_tpu_torch.models import GPTConfig

    tokens = seeded_tokens(GPTConfig(**CKPT_GPT), CKPT_BATCH,
                           CKPT_GPT["max_seq_len"], seed=0)

    def run(model, opt, steps):
        losses = []
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(model, tokens)
            loss.backward()
            opt.step()
            losses.append(float(hvt.allreduce(loss.detach())))
        return losses

    mgr = CheckpointManager(os.path.join(args["dir"], "run"), max_to_keep=2)
    model, opt = _ckpt_model(seed=0)
    unbroken = run(model, opt, CKPT_AT)
    saved = mgr.save(CKPT_AT, {"model": model, "optim": opt,
                               "step": CKPT_AT,
                               "extra": torch.full((3,), 1.5)})
    unbroken += run(model, opt, CKPT_STEPS - CKPT_AT)
    mgr.wait()
    fresh, fresh_opt = _ckpt_model(seed=1)
    template = {"model": fresh, "optim": fresh_opt, "step": 0,
                "extra": torch.zeros(3)}
    state = mgr.restore_latest(template)
    restored_full = _full(fresh)
    resumed = run(fresh, fresh_opt, CKPT_STEPS - CKPT_AT)

    # each rank's read differs by its rank; the broadcast makes rank 1's win
    load = dcp.load

    def perturbed(sd, **kw):
        load(sd, **kw)
        sd["extra"] += hvt.rank()
        sd["step"] += 10 * hvt.rank()

    dcp.load = perturbed
    try:
        again, _ = _ckpt_model(seed=2)
        t = {"model": again, "step": 0, "extra": torch.zeros(3)}
        bcast = mgr.restore(CKPT_AT, {**t}, root_rank=1)
        local = mgr.restore(CKPT_AT, {**t}, broadcast=False)
    finally:
        dcp.load = load
    sharded = {n: p.to_local().clone() for n, p in again.named_parameters()
               if hasattr(p, "to_local")}
    raw = mgr.restore(CKPT_AT)
    mgr.close()
    return {"saved": saved, "unbroken": unbroken, "resumed": resumed,
            "restored_step": state["step"], "restored_extra": state["extra"],
            "steps": mgr.all_steps(),
            "bcast": {"step": bcast["step"], "extra": bcast["extra"]},
            "local": {"step": local["step"], "extra": local["extra"]},
            "sharded_local": sharded,
            "raw": {"step": raw["step"], "extra": raw["extra"],
                    "model": raw["model"],
                    "optim_keys": sorted(raw["optim"])},
            "restored_full": restored_full}


def mode_api(args):
    """The async and in-place collectives against their synchronous forms,
    DistributedOptimizer(num_groups=) against one group, the topology
    queries and the callbacks, on this rank's inputs."""
    import torch

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch import callbacks as cb

    r = hvt.rank()
    gen = torch.Generator().manual_seed(10 + r)
    x, y = torch.randn(4, 3, generator=gen), torch.randn(2, 5, generator=gen)
    out = {"identity": _identity(), "process_rank": hvt.process_rank(),
           "process_size": hvt.process_size(),
           "is_homogeneous": hvt.is_homogeneous(), "x": x, "y": y}
    got, want = {}, {}
    a = x.clone()
    got["allreduce_async_"] = [hvt.synchronize(hvt.allreduce_async_(a)), a]
    want["allreduce_async_"] = [hvt.allreduce(x)] * 2
    pair = [x.clone(), y.clone()]
    got["grouped_allreduce_"] = hvt.grouped_allreduce_(pair, op=hvt.Sum)
    want["grouped_allreduce_"] = hvt.grouped_allreduce([x, y], op=hvt.Sum)
    got["grouped_allreduce_same_objects"] = [
        torch.tensor(float(got["grouped_allreduce_"][i] is pair[i]))
        for i in range(2)]
    want["grouped_allreduce_same_objects"] = [torch.tensor(1.0)] * 2
    pair = [x.clone(), y.clone()]
    got["grouped_allreduce_async_"] = hvt.synchronize(
        hvt.grouped_allreduce_async_(pair, prescale_factor=2.0))
    want["grouped_allreduce_async_"] = hvt.grouped_allreduce(
        [x, y], prescale_factor=2.0)
    got["grouped_allgather_async"] = hvt.synchronize(
        hvt.grouped_allgather_async([x[:r + 1], y]))
    want["grouped_allgather_async"] = hvt.grouped_allgather([x[:r + 1], y])
    h = hvt.reducescatter_async(x, op=hvt.Sum, postscale_factor=0.5)
    got["reducescatter_async"] = [hvt.synchronize(h),
                                  torch.tensor(float(hvt.poll(h)))]
    want["reducescatter_async"] = [hvt.reducescatter(
        x, op=hvt.Sum, postscale_factor=0.5), torch.tensor(1.0)]
    got["alltoall"] = [hvt.alltoall(x),
                       hvt.synchronize(hvt.alltoall_async(x))]
    want["alltoall"] = [hvt.alltoall(x, splits=[2, 2])[0]] * 2
    ints = torch.arange(4, dtype=torch.int32)
    try:
        hvt.allreduce_async_(ints)
        out["int_average_in_place"] = "no error"
    except TypeError as e:
        out["int_average_in_place"] = f"TypeError: {e}"
    out["got"], out["want"] = got, want

    # num_groups: the same update in 3 grouped collectives as in one
    params = {}
    for groups in (0, 3):
        model = torch.nn.Sequential(torch.nn.Linear(5, 4),
                                    torch.nn.Linear(4, 3))
        torch.manual_seed(0)
        for p in model.parameters():
            torch.nn.init.normal_(p)
        opt = hvt.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1), num_groups=groups)
        inp = torch.randn(6, 5, generator=torch.Generator().manual_seed(r))
        model(inp).pow(2).sum().backward()
        opt.step()
        params[groups] = [p.detach().clone() for p in model.parameters()]
    out["num_groups"] = params

    # callbacks
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float(r))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    lst = cb.CallbackList([cb.BroadcastGlobalVariablesCallback(1),
                           cb.MetricAverageCallback()])
    lst.on_train_begin({"model": model, "optimizer": opt})
    out["broadcast_model"] = {k: v.clone()
                              for k, v in model.state_dict().items()}
    out["broadcast_momentum"] = [opt.state[p]["momentum_buffer"].clone()
                                 for p in model.parameters()]
    out["metrics"] = lst.on_epoch_end(0, {"loss": 1.0 + r, "acc": 0.5 * r,
                                          "n": torch.tensor(2.0 * r)})
    out["warmup_default_size"] = cb.LearningRateWarmupCallback(
        0.1, warmup_epochs=2, steps_per_epoch=4).size
    return out


def _fsdp_gpt_setup(args):
    import torch

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.parallel.fsdp import shard_module
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh
    from horovod_tpu_torch.train import gpt_config

    mesh = make_parallel_mesh(**args["layout"])
    cfg = gpt_config(args["config"], use_flash=True)
    model = GPT(cfg, device=hvt.device(), seed=0)
    shard_module(model, mesh)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    return cfg, mesh, model, opt


def mode_fsdp_gpt(args):
    """The GPT sharded on ``args["layout"]``, rank r on its own
    ``args["batch"]`` rows: rows r·batch onwards of a global batch of
    batch · size() rows drawn from seed 0 (``train.seeded_tokens``), so the
    averaged gradient is that of the global batch on one card.
    ``args["steps"]`` steps with an async save at ``args["save_at"]`` (0:
    none) into ``args["dir"]``; or, with ``args["resume"]``, restore the
    latest checkpoint there and take ``args["steps"]`` steps. This rank's
    losses, step times, peak memory, the kernels' launches and the
    checkpoint's timings."""
    import torch

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.checkpoint import CheckpointManager
    from horovod_tpu_torch.ops import _kernels as K
    from horovod_tpu_torch.train import make_train_step, seeded_tokens

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, mesh, model, opt = _fsdp_gpt_setup(args)
    n_params = sum(p.numel() for p in model.parameters())
    local_bytes = sum(p.to_local().numel() * p.element_size()
                      if hasattr(p, "to_local") else p.numel() * 4
                      for p in model.parameters())
    tokens = seeded_tokens(cfg, args["batch"], cfg.max_seq_len, seed=0)
    step = make_train_step(model, opt)
    mgr = CheckpointManager(args["dir"], max_to_keep=2)
    out = {"coords": mesh.coords(), "n_params": n_params,
           "local_param_bytes": local_bytes,
           "device": torch.cuda.get_device_name()
           if hvt.device().type == "cuda" else "cpu"}
    if args.get("resume"):
        t0 = time.perf_counter()
        state = mgr.restore_latest({"model": model, "optim": opt, "step": 0})
        out["restore_ms"] = (time.perf_counter() - t0) * 1e3
        out["restored_step"] = state["step"]
    sync = torch.cuda.synchronize if hvt.device().type == "cuda" \
        else (lambda: None)
    sync()
    if hvt.device().type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    losses, times = [], []
    for i in range(args["steps"]):
        t0 = time.perf_counter()
        losses.append(float(step(tokens)))          # waits for the card
        times.append(time.perf_counter() - t0)
        if i + 1 == args.get("save_at"):
            t0 = time.perf_counter()
            mgr.save(i + 1, {"model": model, "optim": opt, "step": i + 1})
            out["save_blocking_ms"] = (time.perf_counter() - t0) * 1e3
    out["launches"] = dict(K.LAUNCHES)
    t0 = time.perf_counter()
    mgr.wait()
    out["wait_ms"] = (time.perf_counter() - t0) * 1e3
    out.update(losses=losses, step_s=times)
    if hvt.device().type == "cuda":
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        # where a step's device time goes: chip_smoke.py's profile of two
        # more steps (busy and idle time, kernel time by category)
        import statistics

        import chip_smoke

        prof = chip_smoke.device_time(lambda: float(step(tokens)), 2,
                                      statistics.median(times[1:]))
        out["profile"] = ("not measured" if prof is None else
                          {k: v for k, v in prof.items() if k != "by_name"})
    return out


def join_tokens(cfg, step, rank, size, batch):
    """Rank ``rank``'s rows at ``step`` (0-based) of the JOIN4 job: rows
    rank·batch onwards of a global batch of batch · size rows drawn from
    seed 1000 + step."""
    import torch

    rows = np.random.RandomState(1000 + step).randint(
        0, cfg.vocab_size, (batch * size, cfg.max_seq_len))
    return torch.from_numpy(rows[rank * batch:(rank + 1) * batch])


def _latency_sum(op):
    """(sum in seconds, count) of hvt_collective_latency_seconds{op}, its
    CUDA events resolved first."""
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.utils import timeline

    timeline.drainer.flush()
    _, s, c = metrics.registry().get("hvt_collective_latency_seconds") \
        .labels(op=op, process_set="global").snapshot()
    return s, c


def _nccl_kernels(prof):
    """The NCCL kernels a torch.profiler session saw, in order of start:
    (name, start µs, ms). The device timeline also holds an ``nccl:<op>``
    range over each kernel; those are left out."""
    import torch

    ks = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.name.startswith(("ncclDevKernel", "ncclKernel"))]
    return [(e.name, e.time_range.start, e.time_range.elapsed_us() / 1e3)
            for e in sorted(ks, key=lambda e: e.time_range.start)]


def _profiled_collectives(op, call, calls):
    """``calls`` calls of ``call`` (one collective on the global set, a
    header and its data each) under torch.profiler, behind a barrier that
    lines the ranks up: the latency the histogram ``op`` holds for them
    beside their NCCL kernels (the last 2·calls kernels; the barrier's two
    come first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import horovod_tpu_torch as hvt

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        hvt.barrier()
        before = _latency_sum(op)
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        after = _latency_sum(op)
    kernels = _nccl_kernels(prof)
    mine = kernels[-2 * calls:]
    return {"calls": calls, "event_ms": (after[0] - before[0]) * 1e3,
            "observations": after[1] - before[1],
            "nccl_kernel_ms": sum(k[2] for k in mine),
            "nccl_kernels": len(kernels),
            "kernels": [[n[:60], round(ms, 4)] for n, _, ms in kernels]}


def _header_cost(calls=100):
    """Device and host time per call of an in-place 1 KiB allreduce: through
    torch.distributed alone; through torch.distributed preceded by a
    header-sized int64 allreduce; through hvt on a process set of every
    rank (timed, no header); and through hvt on the global set (timed, a
    header); the last two again once the timeline is stopped. And the host
    µs of timing alone (``collective_ops._begin`` and ``_end``)."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops import collective_ops as C
    from horovod_tpu_torch.utils import timeline

    x = torch.zeros(256, device=hvt.device())
    h = torch.zeros(C._HEADER_LEN, dtype=torch.int64, device=hvt.device())
    every = hvt.add_process_set(list(range(hvt.size())))

    def two():
        dist.all_reduce(h)
        dist.all_reduce(x)

    def timing_only():
        C._end(C._begin("allreduce", every, x))

    out = {}
    for name, call in (
            ("torch_distributed", lambda: dist.all_reduce(x)),
            ("torch_distributed_two", two),
            ("hvt_no_header", lambda: hvt.allreduce_(x, op=hvt.Sum,
                                                     process_set=every)),
            ("hvt", lambda: hvt.allreduce_(x, op=hvt.Sum)),
            ("stop_timeline", None),
            ("hvt_no_header_no_timeline",
             lambda: hvt.allreduce_(x, op=hvt.Sum, process_set=every)),
            ("hvt_no_timeline", lambda: hvt.allreduce_(x, op=hvt.Sum)),
            ("timing_only", timing_only)):
        if call is None:
            timeline.stop()
            continue
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        hvt.barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        host = (time.perf_counter() - t0) / calls
        end.record()
        torch.cuda.synchronize()
        out[name] = {"device_ms_per_call": start.elapsed_time(end) / calls,
                     "host_us_per_call": host * 1e6}
    out["header_host_us"] = (out["hvt"]["host_us_per_call"]
                             - out["hvt_no_header"]["host_us_per_call"])
    out["header_device_ms"] = (out["hvt"]["device_ms_per_call"]
                               - out["hvt_no_header"]["device_ms_per_call"])
    return out


def mode_join_gpt(args):
    """The JOIN4 job: the named GPT under DistributedOptimizer(AdamW), rank
    r on its own rows (:func:`join_tokens`); the last rank holds
    ``args["short"]`` batches, the others ``args["batches"]``, and each
    calls ``hvt.join()`` when its data runs out, then takes the last
    joiner's parameters. Rank 0 saves the training state after step
    ``short`` (the one-process reference's start) and scrapes every rank's
    ``GET /metrics`` after step ``scrape_at``; a barrier after each keeps
    them out of the next step's time. Then, with every rank active again,
    the step's gradient allreduce three times under torch.profiler (the
    histogram's time beside the NCCL kernels') and the header's cost per
    collective (:func:`_header_cost`)."""
    import hashlib
    import urllib.request

    import torch

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.ops import _kernels as K
    from horovod_tpu_torch.train import gpt_config, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    r, n, dev = hvt.rank(), hvt.size(), hvt.device()
    cfg = gpt_config(args["config"], use_flash=True)
    model = GPT(cfg, device=dev, seed=0)
    opt = hvt.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4))
    step = make_train_step(model, opt)
    batches = args["short"] if r == n - 1 else args["batches"]
    out = {"losses": [], "step_s": [], "device": str(dev)}
    K.reset_launches()
    for i in range(batches):
        tokens = join_tokens(cfg, i, r, n, args["batch"]).to(dev)
        t0 = time.perf_counter()
        out["losses"].append(float(step(tokens)))   # waits for the card
        out["step_s"].append(time.perf_counter() - t0)
        if r == 0 and i + 1 == args["short"]:
            torch.save({"model": model.state_dict(),
                        "optim": opt.state_dict()},
                       args["out"] + ".state.pt")
        if r == 0 and i + 1 == args["scrape_at"]:
            base = int(os.environ["HVT_METRICS_PORT"])
            out["scraped"] = []
            for peer in range(n):
                t0 = time.perf_counter()
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{base + peer}/metrics",
                        timeout=30) as resp:
                    text = resp.read().decode()
                out["scraped"].append({"text": text, "ms": (
                    time.perf_counter() - t0) * 1e3})
        if i + 1 in (args["short"], args["scrape_at"]):
            hvt.barrier()
    out["launches"] = dict(K.LAUNCHES)
    out["param_sums"] = [float(p.detach().double().sum())
                         for p in model.parameters()]
    t0 = time.perf_counter()
    out["last"] = hvt.join()
    out["join_s"] = time.perf_counter() - t0
    hvt.broadcast_parameters(model.state_dict(), root_rank=out["last"])
    digest = hashlib.sha256()
    for p in model.parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    out["param_sha256"] = digest.hexdigest()
    if dev.type == "cuda":
        grads = [p.grad for p in model.parameters()]
        out["window"] = _profiled_collectives(
            "grouped_allreduce", lambda: hvt.grouped_allreduce_(grads), 3)
        out["header_cost"] = _header_cost()
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    out["diagnostics"] = hvt.diagnostics()
    return out


def mode_allreduce_latency(args):
    """In-place NCCL allreduces of ``args["mib"]`` MiB under torch.profiler
    (:func:`_profiled_collectives`): their latency from the histogram (CUDA
    events) beside their NCCL kernels' time."""
    import torch

    import horovod_tpu_torch as hvt

    x = torch.ones(args["mib"] << 18, device=hvt.device())
    for _ in range(3):
        hvt.allreduce_(x, op=hvt.Sum)
    torch.cuda.synchronize()
    return dict(_profiled_collectives(
        "allreduce", lambda: hvt.allreduce_(x, op=hvt.Sum), args["calls"]),
        bytes=x.numel() * 4)


def _get_json_ms(addr, path):
    from horovod_tpu_torch.runner.http_client import get_json

    t0 = time.perf_counter()
    doc = get_json(addr, path, timeout=30, retries=0)
    return doc, (time.perf_counter() - t0) * 1e3


def mode_fleet(args):
    """``args["steps"]`` steps of ``train.train`` on the named GPT while the
    telemetry push loop runs; from step ``args["poll_from"]`` on, each step
    reads ``GET /statusz`` and ``GET /debugz`` from the launcher's server
    (``HVT_DIAG_ADDR``). Returns the last reads, each read's ms, the
    snapshot's bytes, and the host ms of building a snapshot and of PUTting
    it to a scratch scope (one push's work)."""
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import _kernels as K
    from horovod_tpu_torch.runner.http_client import put_bytes
    from horovod_tpu_torch.train import gpt_config, train

    addr = os.environ["HVT_DIAG_ADDR"]
    reads = {"statusz_ms": [], "debugz_ms": [], "snapshot_ms": [],
             "put_ms": []}

    class Poll:
        def on_epoch_end(self, step, logs):
            if step + 1 < args["poll_from"]:
                return
            deadline = time.monotonic() + 30
            while "statusz" not in reads and time.monotonic() < deadline:
                # the first read waits for this rank's first push
                doc, _ = _get_json_ms(addr, "/statusz")
                if str(hvt.rank()) in doc.get("ranks", {}):
                    break
                time.sleep(0.05)
            reads["statusz"], ms = _get_json_ms(addr, "/statusz")
            reads["statusz_ms"].append(ms)
            reads["debugz"], ms = _get_json_ms(addr, "/debugz")
            reads["debugz_ms"].append(ms)
            t0 = time.perf_counter()
            body = json.dumps(basics._telemetry_snapshot(hvt.rank()))
            t1 = time.perf_counter()
            put_bytes(addr, f"/kv/fleet_probe/{hvt.rank()}", body.encode(),
                      timeout=30, retries=0)
            reads["snapshot_ms"].append((t1 - t0) * 1e3)
            reads["put_ms"].append((time.perf_counter() - t1) * 1e3)
            reads["snapshot_bytes"] = len(body)

    cfg = gpt_config(args["config"], use_flash=True)
    K.reset_launches()
    res = train(cfg, args["steps"], args["batch"], args["seq"],
                device=args["device"], seed=0, callbacks=Poll())
    return {**_identity(), "losses": res["loss"], "step_s": res["step_s"],
            "launches": dict(K.LAUNCHES), **reads}


WORKER_MODES = {"gpt", "fail", "fsdp_mlp", "checkpoint", "api", "fsdp_gpt",
                "join_gpt", "allreduce_latency", "fleet"}


def main():
    import faulthandler

    import torch

    import horovod_tpu_torch as hvt

    mode, out = sys.argv[1], sys.argv[2]
    args = json.loads(sys.argv[3]) if len(sys.argv) > 3 else {}
    # a rank that crashes, or still runs near its job's limit, prints where
    faulthandler.enable()
    faulthandler.dump_traceback_later(args.get("stack_after", 600),
                                      exit=True)
    device = args.get("device", "cpu")
    hvt.init(device=device, timeout_s=args.get("timeout_s", 180))
    if device == "cpu":
        torch.set_num_threads(1)
    res = globals()["mode_" + mode](args)
    torch.save(res, f"{out}.{hvt.rank()}.pt")
    print(json.dumps({"rank": hvt.rank(), "mode": mode, "done": True}),
          flush=True)
    hvt.shutdown()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Launch:
    """``python -m horovod_tpu_torch.runner.launch -np n python <this file>
    mode out args``, started at construction; the launcher's output goes to
    ``out.log``."""

    def __init__(self, n, mode, out, args=None, timeout=240, env=None,
                 launcher_args=()):
        self.n, self.out, self.timeout = n, out, timeout
        args = dict(args or {}, stack_after=max(timeout - 30, 1), out=out)
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
               "-np", str(n), "--master-port", str(free_port()),
               *launcher_args, sys.executable, os.path.abspath(__file__),
               mode, out, json.dumps(args)]
        env = dict(os.environ if env is None else env, PYTHONPATH=REPO,
                   OMP_NUM_THREADS="1")
        self.log = out + ".log"
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=log,
                                         stderr=subprocess.STDOUT)
        self._results = None

    def wait(self):
        """The launcher's exit code and output."""
        try:
            self.proc.wait(timeout=self.timeout)
        finally:
            self.kill()
        with open(self.log) as f:
            return self.proc.returncode, f.read()

    def results(self):
        """Each rank's results; raises with the output's end if the job
        failed."""
        import torch

        if self._results is None:
            rc, log = self.wait()
            assert rc == 0, log[-20000:]
            self._results = [torch.load(f"{self.out}.{r}.pt",
                                        weights_only=False)
                             for r in range(self.n)]
        return self._results

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


if __name__ == "__main__":
    main()
