"""A gang of horovod_tpu_torch processes that drives the port's parallel
modules (mesh, differentiable collectives, ring and Ulysses attention,
the sharded GPT step through ``dryrun_multichip``, MoE on dp × ep and the
GPipe pipeline), shared by tests/test_torch_port_parallel.py,
tests/test_torch_port_moe_pipeline.py and the NCCL test in
tests/test_torch_port_cuda.py. Imports no JAX.

``Gang(suite, n, out, device, inputs)`` starts ``n`` processes through the
hvtrun identity env (ranks host-major, two ranks a fake host) without
waiting; ``Gang.results()`` waits and returns each rank's results (a dict
saved with ``torch.save``). ``inputs`` is a dict of tensors (for example
weights made by the JAX package) that every rank reads. The numpy inputs
of each case come from the functions below, which the tests call too.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
LOCAL = 2
# meshes whose layout is held against jax's make_parallel_mesh
MESHES = [dict(dp=2, tp=2), dict(tp=2, dp=-1), dict(pp=4),
          dict(dp=1, sp=2, tp=2), dict(ep=2, dp=2), dict(foo=2, dp=2)]
# (B, S, H, H_kv, D) of the ring and Ulysses cases
RING = (2, 32, 4, 4, 16)
RING_GQA = (2, 32, 4, 2, 16)
# a wide head with one K/V head (the wide_head GPT's attention, cut down),
# flash blocks only
RING_WIDE = (1, 32, 4, 1, 256)
ULYSSES = (2, 32, 8, 8, 8)
ULYSSES_GQA = (2, 32, 8, 4, 8)
# the sharded GPT steps held against the JAX package's replicated step
STEP_AXES = [(1, 2, 2), (2, 2, 1)]
# sharded steps of the entry GPT held against one process of the port:
# {name: (GPTConfig overrides, mesh axes)}; MQA's one K/V head stays whole
# over tp, and the flash cases run the kernels' route in every ring block
STEPS = {"mqa": (dict(n_kv_heads=1), dict(dp=2, tp=2)),
         "flash": (dict(use_flash=True), dict(dp=1, sp=2, tp=2)),
         "gqa-flash-sp4": (dict(n_kv_heads=2, use_flash=True), dict(sp=4)),
         "sgd-dp2-sp2": (dict(), dict(dp=2, sp=2))}
STEP_TOKENS = (4, 32)


def step_optimizer(name, params):
    """AdamW as the dryrun's, or SGD, whose update shows the gradient's
    scale (AdamW's hides it)."""
    import torch

    if name.startswith("sgd"):
        return torch.optim.SGD(params, lr=0.5)
    return torch.optim.AdamW(params, lr=1e-3, weight_decay=1e-4)
# MoE on dp × ep
MOE = dict(d_model=16, n_experts=4, d_ff=32, capacity_factor=1.25)
MOE_X = (4, 8, 16)
# pipeline cases: (n_stages, n_micro); 2 stages run as two pipelines on
# a dp 2 × pp 2 mesh
PIPELINES = [(4, 4), (2, 6)]
PIPE_D = 6


def qkv(shape, seed=0):
    """Global fp32 q [B, S, H, D] and k, v [B, S, H_kv, D]."""
    b, s, h, h_kv, d = shape
    rng = np.random.RandomState(seed)
    return tuple(rng.normal(size=(b, s, n, d)).astype(np.float32)
                 for n in (h, h_kv, h_kv))


def step_tokens():
    return np.random.RandomState(6).randint(0, 512, STEP_TOKENS)


def moe_x():
    return np.random.RandomState(4).randn(*MOE_X).astype(np.float32)


def pipe_inputs(n_stages, n_micro):
    """Stacked stage parameters and the input batch, as numpy."""
    rs = np.random.RandomState(2)
    params = {"w": (rs.randn(n_stages, PIPE_D, PIPE_D) * 0.5)
              .astype(np.float32),
              "b": (rs.randn(n_stages, PIPE_D) * 0.1).astype(np.float32)}
    x = np.random.RandomState(3).randn(n_micro * 2, PIPE_D).astype(
        np.float32)
    return params, x


def prim_inputs(n):
    """Per-rank inputs of the primitive checks, indexed [rank]."""
    rs = np.random.RandomState(5)
    f = lambda *s: rs.normal(size=(n,) + s).astype(np.float32)  # noqa
    return {"x": f(3, 4), "y": f(3, 4), "wx": f(3, 4), "wy": f(3, 4),
            "a2a": f(2, 2, 8, 3), "a2a_w": f(2, 8, 2, 3),
            "red": f(5), "red_w": f(5)}


WORKER = r"""
import faulthandler, json, os, sys
import torch
sys.path.insert(0, os.path.join(os.environ["PYTHONPATH"], "tests"))
import torch_port_parallel_gang as G
import horovod_tpu_torch as hvt

suite, device, out, inputs_path, stack_after = json.loads(sys.argv[1])
# a rank still running near the gang's timeout prints where it waits
faulthandler.dump_traceback_later(stack_after, exit=True)
# a rank whose peers died stops at the first collective after 3 minutes
hvt.init(device=device, timeout_s=180)
if device == "cpu":
    torch.set_num_threads(1)
INPUTS = torch.load(inputs_path) if inputs_path else {}
res = {}
getattr(G, "suite_" + suite)(res, INPUTS)
torch.save(res, f"{out}.{hvt.rank()}.pt")
hvt.shutdown()
"""


def _t(a):
    import torch

    from horovod_tpu_torch.common import basics

    return torch.as_tensor(a).to(basics.device())


def _error(fn):
    try:
        fn()
    except Exception as e:      # noqa: BLE001 - the type is the result
        return f"{type(e).__name__}: {e}"
    return "no error"


def _shards(arrays, mesh, axis, dim=1):
    """This rank's shards (along ``dim``) of global numpy arrays, as
    leaf tensors that require grad."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    out = []
    for a in arrays:
        size = a.shape[dim] // n
        piece = np.take(a, range(i * size, (i + 1) * size), axis=dim)
        out.append(_t(piece).requires_grad_())
    return out


def suite_parallel(res, inputs):
    """Mesh, primitives, ring and Ulysses attention, and the sharded GPT
    step (dryrun_multichip at each of STEP_AXES)."""
    import torch

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.dryrun import dryrun_multichip
    from horovod_tpu_torch.parallel.mesh import (global_mesh,
                                                 hierarchical_mesh,
                                                 make_parallel_mesh)
    from horovod_tpu_torch.parallel.primitives import (all_to_all, copy_to,
                                                       reduce_from,
                                                       ring_pass, ring_shift)
    from horovod_tpu_torch.parallel.sequence import (ring_attention,
                                                     ulysses_attention)

    r, n = hvt.rank(), hvt.size()
    meshes = []
    for axes in MESHES:
        mesh = make_parallel_mesh(**axes)
        meshes.append({"devices": mesh.devices.tolist(),
                       "axis_names": list(mesh.axis_names),
                       "coords": mesh.coords(),
                       "sets": {a: mesh.process_set(a).global_ranks()
                                for a in mesh.axis_names}})
    res["meshes"] = meshes
    for name, mesh in (("global", global_mesh()),
                       ("hierarchical", hierarchical_mesh())):
        res[name + "_mesh"] = {
            "devices": mesh.devices.tolist(),
            "axis_names": list(mesh.axis_names),
            "sets": {a: mesh.process_set(a).global_ranks()
                     for a in mesh.axis_names}}

    # primitives, over the world and over a 2-rank tp line
    P = {k: _t(v[r]) for k, v in prim_inputs(n).items()}
    world = make_parallel_mesh(sp=n)
    ring = world.process_set("sp")
    x, y = (P[k].clone().requires_grad_() for k in ("x", "y"))
    # two shifts of same-shaped tensors: a swapped pairing would show
    sx, sy = ring_shift(x, ring), ring_shift(y, ring)
    ((sx * P["wx"]).sum() + (sy * P["wy"]).sum()).backward()
    res["ring_shift"] = [sx.detach(), sy.detach(), x.grad, y.grad]
    res["ring_shift_back"] = ring_shift(P["x"], ring, shift=-1)
    # the trip around the ring, of which rank r uses steps 0..r only, as
    # a causal ring uses its blocks
    x = P["x"].clone().requires_grad_()
    steps = ring_pass(x, ring)
    sum((s * P["wx"] * (t + 1)).sum() for t, s in enumerate(steps)
        if t <= r).backward()
    res["ring_pass"] = [torch.stack([s.detach() for s in steps]), x.grad]
    a = P["a2a"].clone().requires_grad_()           # [B, S/n, H, D]
    got = all_to_all(a, ring, 2, 1)                 # [B, S, H/n, D]
    (got * P["a2a_w"]).sum().backward()
    res["all_to_all"] = [got.detach(), a.grad]
    tp = make_parallel_mesh(dp=2, tp=2).process_set("tp")
    v = P["red"].clone().requires_grad_()
    summed = reduce_from(v, tp)
    (summed * P["red_w"]).sum().backward()
    res["reduce_from"] = [summed.detach(), v.grad]
    v = P["red"].clone().requires_grad_()
    (copy_to(v, tp) * P["red_w"]).sum().backward()
    res["copy_to"] = v.grad
    res["tp_members"] = tp.global_ranks()

    # ring attention: einsum and flash blocks, causal and not, GQA
    for shape in (RING, RING_GQA, RING_WIDE):
        arrays = qkv(shape)
        for flash in ((True,) if shape == RING_WIDE else (False, True)):
            for causal in (True, False):
                q, k, v = _shards(arrays, world, "sp")
                o = ring_attention(q, k, v, mesh=world, causal=causal,
                                   use_flash=flash)
                # this rank's share of the mean of o**2 over the whole
                # sequence
                share = (o ** 2).sum() / (o.numel() * n)
                share.backward()
                res[("ring", shape, flash, causal)] = [
                    o.detach(), q.grad, k.grad, v.grad]
    for shape in (ULYSSES, ULYSSES_GQA):
        for flash in (False, True):
            q, k, v = _shards(qkv(shape), world, "sp")
            o = ulysses_attention(q, k, v, mesh=world, causal=True,
                                  use_flash=flash)
            (o ** 2).sum().backward()
            res[("ulysses", shape, flash)] = [o.detach(), q.grad, k.grad,
                                              v.grad]
    b, s, h, _, d = ULYSSES
    res["ulysses_errors"] = [
        _error(lambda: ulysses_attention(
            _t(np.zeros((b, s // n, 6, d), np.float32)),
            *[_t(np.zeros((b, s // n, 6, d), np.float32))] * 2,
            mesh=world)),
        _error(lambda: ulysses_attention(
            _t(np.zeros((b, s // n, h, d), np.float32)),
            *[_t(np.zeros((b, s // n, 2, d), np.float32))] * 2,
            mesh=world))]

    # sharded steps against one process of the port
    import dataclasses

    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.train import gpt_config, make_parallel_train_step

    for name, (overrides, axes) in STEPS.items():
        mesh = make_parallel_mesh(**axes)
        cfg = gpt_config("entry", dtype=torch.float32, **overrides)
        if mesh.axis_size("sp") > 1:
            cfg = dataclasses.replace(cfg, ring_mesh=mesh)
        model = GPT(cfg, device=hvt.device(), mesh=mesh)
        step = make_parallel_train_step(
            model, step_optimizer(name, model.parameters()), mesh)
        tokens = _t(step_tokens())
        res[("step", name)] = {
            "losses": [float(step(tokens)) for _ in range(2)],
            "params": {k: v.detach() for k, v in model.state_dict().items()},
            "coords": mesh.coords()}

    # the sharded GPT step, from the weights the test made with the JAX
    # package
    for axes in STEP_AXES:
        got = dryrun_multichip("entry", device=hvt.device().type, axes=axes,
                               state_dict=inputs.get("gpt"))
        res[("dryrun", axes)] = got


def suite_moe_pipeline(res, inputs):
    """MoEMlp on dp 2 × ep 2 from the test's weights, and the pipeline at
    each of PIPELINES."""
    import torch

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.models.convert import shard_state_dict
    from horovod_tpu_torch.models.moe import MoEMlp
    from horovod_tpu_torch.ops import collective_ops as C
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh
    from horovod_tpu_torch.parallel.pipeline import (pipeline,
                                                     stage_partition_spec)

    dev = hvt.device()
    mesh = make_parallel_mesh(dp=2, ep=2)
    moe = MoEMlp(**MOE, dtype=torch.float32, mesh=mesh, device=dev)
    full = inputs["moe"]
    moe.load_state_dict(shard_state_dict(full, {"wi": ("ep",),
                                                "wo": ("ep",)},
                                         mesh.shape, mesh.coords()))
    x = _t(moe_x())
    rows = x.shape[0] // 2
    i = mesh.axis_index("dp") * rows
    out, aux = moe(x[i:i + rows])
    (out.sum() + 0.01 * aux / 2).backward()
    grads = C.grouped_allreduce([p.grad for _, p in moe.named_parameters()],
                                op=C.Sum, process_set=mesh.process_set("dp"))
    res["moe"] = {"out": out.detach(), "aux": aux.detach(),
                  "grads": dict(zip([k for k, _ in moe.named_parameters()],
                                    grads)),
                  "coords": mesh.coords()}

    for n_stages, n_micro in PIPELINES:
        mesh = make_parallel_mesh(dp=N // n_stages, pp=n_stages)
        params, xs = pipe_inputs(n_stages, n_micro)
        stacked = {k: _t(v) for k, v in params.items()}
        mine = {k: v.requires_grad_() for k, v in shard_state_dict(
            stacked, stage_partition_spec(stacked), {"pp": n_stages},
            mesh.coords()).items()}
        xt = _t(xs).requires_grad_()
        y = pipeline(_stage, mine, xt, n_micro, mesh)
        (y ** 2).mean().backward()
        res[("pipeline", n_stages, n_micro)] = {
            "out": y.detach(), "x_grad": xt.grad,
            "grads": {k: v.grad for k, v in mine.items()},
            "coords": mesh.coords()}


# the card test's full-width step: bench.py --model gpt --flash at dp 1 ×
# sp 2 × tp 2, and Ulysses at sp 4 on the full-width attention shape
FULL_AXES = dict(dp=1, sp=2, tp=2)
FULL_STEPS, FULL_BATCH = 7, 8
ULYSSES_FULL = (8, 1024, 12, 12, 64)


def suite_cuda(res, inputs):
    """On four cards: the dryrun at the entry and bench configs, seven
    steps of the full-width GPT at dp 1 × sp 2 × tp 2 with ring flash
    attention (losses, step times, peak memory, kernel launches), and
    Ulysses with the flash kernels at sp 4 against flash attention of the
    whole sequence."""
    import time

    import torch

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.dryrun import dryrun_multichip
    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.ops import _kernels as K
    from horovod_tpu_torch.ops.flash_attention import flash_attention
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh
    from horovod_tpu_torch.parallel.sequence import ulysses_attention
    from horovod_tpu_torch.train import gpt_config, make_parallel_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    for config in ("entry", "bench"):
        t0 = time.perf_counter()
        print(f"dryrun {config}", flush=True)
        got = dryrun_multichip(config)
        got.pop("params")
        res["dryrun_" + config] = {**got, "seconds": time.perf_counter() - t0}
        torch.cuda.empty_cache()

    print("full-width step", flush=True)
    mesh = make_parallel_mesh(**FULL_AXES)
    cfg = gpt_config("bench", use_flash=True, ring_mesh=mesh)
    model = GPT(cfg, device=hvt.device(), mesh=mesh, seed=0)
    step = make_parallel_train_step(model, torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4), mesh)
    # the one-card main path's batch (train.seeded_tokens in a world of one)
    tokens = _t(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (FULL_BATCH, cfg.max_seq_len)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    losses, times = [], []
    for _ in range(FULL_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(tokens)))         # waits for the card
        times.append(time.perf_counter() - t0)
    res["full"] = {"losses": losses, "step_s": times,
                   "max_memory_allocated_bytes":
                       torch.cuda.max_memory_allocated(),
                   "launches": dict(K.LAUNCHES), "coords": mesh.coords(),
                   "device": torch.cuda.get_device_name()}
    # where a step's device time goes: chip_smoke.py's profile of two
    # more steps (busy and idle time, kernel time by category)
    import statistics

    import chip_smoke

    prof = chip_smoke.device_time(lambda: float(step(tokens)), 2,
                                  statistics.median(times[2:]))
    res["full"]["profile"] = ("not measured" if prof is None else
                              {k: v for k, v in prof.items()
                               if k != "by_name"})
    del model, step
    torch.cuda.empty_cache()

    print("ulysses", flush=True)
    b, s, h, _, d = ULYSSES_FULL
    gen = torch.Generator(device=hvt.device()).manual_seed(7)
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device=hvt.device())
               .to(torch.bfloat16) for _ in range(3))
    world = make_parallel_mesh(sp=hvt.size())
    n, i = world.axis_size("sp"), world.axis_index("sp")
    mine = slice(i * s // n, (i + 1) * s // n)
    outs = {}
    for name in ("ulysses", "whole"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        if name == "ulysses":
            parts = [t[:, mine].detach().requires_grad_() for t in leaves]
            o = ulysses_attention(*parts, mesh=world, use_flash=True)
            (o.float() ** 2).sum().backward()
            outs[name] = [o.detach()] + [t.grad for t in parts]
        else:
            o = flash_attention(*leaves)
            (o.float() ** 2).sum().backward()
            outs[name] = [o.detach()[:, mine]] + [t.grad[:, mine]
                                                  for t in leaves]
    # the least tolerance that holds, |got - want| <= tol (1 + |want|),
    # for o, dq, dk, dv
    res["ulysses_least_tol"] = [
        ((a.float() - w.float()).abs() / (1 + w.float().abs())).max().item()
        for a, w in zip(outs["ulysses"], outs["whole"])]


# the four-card ring at the wide heads: the wide_head GPT of chip_smoke.py
# (Gemma-2B's attention widths) at sp 4, RINGWIDE_STEPS steps on a seeded
# batch of RINGWIDE_BATCH rows of the whole sequence
RINGWIDE_STEPS, RINGWIDE_BATCH = 7, 8


def suite_ringwide(res, inputs):
    """On four cards: the wide_head GPT at sp 4 with use_flash="auto" (each
    ring block through the fp32-o instances of the sm90 kernels at padded
    width 256) and with the einsum ring blocks, from the same weights and
    batch: losses, step times, peak memory and launches of each.
    ``inputs`` may shrink the run for a rehearsal on the CPU: ``config``
    (GPTConfig overrides), ``batch``, ``steps``."""
    import dataclasses
    import time

    import torch

    import chip_smoke
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.models.transformer import GPTConfig
    from horovod_tpu_torch.ops import _kernels as K
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh
    from horovod_tpu_torch.train import make_parallel_train_step

    on_cuda = hvt.device().type == "cuda"
    mesh = make_parallel_mesh(sp=hvt.size())
    cfg = GPTConfig(**{**chip_smoke.WIDE_HEAD_CONFIG,
                       **inputs.get("config", {})},
                    dtype=torch.bfloat16, use_flash="auto", ring_mesh=mesh)
    batch = inputs.get("batch", RINGWIDE_BATCH)
    steps = inputs.get("steps", RINGWIDE_STEPS)
    tokens = _t(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, cfg.max_seq_len)))
    for name, use_flash in (("flash", "auto"), ("einsum", False)):
        print(f"ring {name}", flush=True)
        model = GPT(dataclasses.replace(cfg, use_flash=use_flash),
                    device=hvt.device(), mesh=mesh, seed=0)
        step = make_parallel_train_step(model, torch.optim.AdamW(
            model.parameters(), lr=1e-4, weight_decay=1e-4), mesh)
        if on_cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        losses, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(step(tokens)))     # waits for the device
            times.append(time.perf_counter() - t0)
        res["ringwide_" + name] = {
            "losses": losses, "step_s": times,
            "launches": dict(K.LAUNCHES), "coords": mesh.coords(),
            "max_memory_allocated_bytes":
                torch.cuda.max_memory_allocated() if on_cuda else None,
            "device": torch.cuda.get_device_name() if on_cuda else "cpu"}
        del model, step
        if on_cuda:
            torch.cuda.empty_cache()


def _stage(params, x):
    import torch

    return torch.tanh(x @ params["w"] + params["b"])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Gang:
    """``n`` processes running ``suite_<suite>``; started at construction,
    collected by :meth:`results`."""

    def __init__(self, suite, out, n=N, local_size=LOCAL, device="cpu",
                 inputs=None, timeout=240):
        import torch

        self.out, self.n, self.timeout = out, n, timeout
        inputs_path = ""
        if inputs is not None:
            inputs_path = out + ".inputs.pt"
            torch.save(inputs, inputs_path)
        port = _free_port()
        cards = os.environ.get("CUDA_VISIBLE_DEVICES",
                               ",".join(map(str, range(n)))).split(",")
        self.procs, self.logs = [], []
        for r in range(n):
            env = dict(os.environ, PYTHONPATH=REPO, HVT_PROCESS_ID=str(r),
                       HVT_NUM_PROCESSES=str(n),
                       HVT_LOCAL_PROCESS_ID=str(r % local_size),
                       HVT_LOCAL_SIZE=str(local_size),
                       HVT_CROSS_RANK=str(r // local_size),
                       HVT_CROSS_SIZE=str(n // local_size),
                       HVT_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                       OMP_NUM_THREADS="1")
            if device == "cuda":    # each fake host sees its own cards
                host = r // local_size
                env["CUDA_VISIBLE_DEVICES"] = ",".join(
                    cards[host * local_size:(host + 1) * local_size])
            # each rank's output goes to a file beside its results
            self.logs.append(f"{out}.{r}.log")
            with open(self.logs[-1], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", WORKER,
                     json.dumps([suite, device, out, inputs_path,
                                 max(timeout - 30, 1)])],
                    env=env, cwd=REPO, stdout=log,
                    stderr=subprocess.STDOUT))
        self._results = None

    def results(self):
        """Wait for every process and return the per-rank results; raise
        with the ends of the logs if one failed."""
        import torch

        if self._results is None:
            try:
                for p in self.procs:
                    p.wait(timeout=self.timeout)
            finally:
                self.kill()
            for r, p in enumerate(self.procs):
                with open(self.logs[r]) as f:
                    log = f.read()[-20000:]
                assert p.returncode == 0, f"rank {r}:\n{log}"
            self._results = [torch.load(f"{self.out}.{r}.pt",
                                        weights_only=False)
                             for r in range(self.n)]
        return self._results

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
