"""A gloo gang of horovod_tpu_torch processes on two faked hosts that drives
the compressed allreduce (``horovod_tpu_torch.compression``) through every
case ``tests/test_torch_port_wire.py`` holds: each codec alone and as the
inter half of a pair, the spec unset, non-fp32 dtypes and Adasum under a
codec, Average, error feedback on and off, the residual budget, ``auto``,
process sets on one host and across hosts (also under ``auto``), a joined
rank's stand-in, and the DistributedOptimizer's grouped reduction. Imports
no JAX.

``run_gang(n, local_size, out)`` starts ``n`` processes through the hvtrun
identity env (ranks host-major) and returns each rank's results (a dict,
``torch.save``-d by the worker). Each case sets the wire spec with
``compression.configure``, which every rank calls at the same point, as
``hvt.init`` would read it. ``run_wire4(out, spec)`` starts the four-card
WIRE4 job (:func:`wire4_worker`) under one spec, given through the env.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CODECS = ("bf16", "int8", "fp8")
# sizes across block and chunk bounds (tests/test_data_plane.py:246)
SIZES = (1, 255, 256, 257, 1023, 1024, 1025, 4103, 16384, 1 << 16)
EF_STEPS = 120
AUTO_CALLS = 20
AUTO_NUMEL = 1 << 14
AUTO_SET_CALLS = 3          # fewer than a candidate's trials
BUDGET_NUMEL = 512          # elements of each budget-case tensor
SETS = ([0, 1], [0, 2])     # one host, two hosts (of local size 2)
OPS, OP_NUMEL = ("Max", "Min"), 4103    # the Min and Max cases


def base(numel, r):
    """Rank r's input of the codec cases (tests/test_data_plane.py:213)."""
    return ((np.arange(numel, dtype=np.float32) % 997) * np.float32(0.123)
            + np.float32(r)).astype(np.float32)


def op_input(numel, r):
    """Rank r's input of the Min and Max cases: seeded, of both signs."""
    return (np.random.RandomState(50 + r).randn(numel) * 3).astype(
        np.float32)


def exact_ints(numel, r):
    """Rank r's integer-valued fp32 input: its sum is exact in fp32."""
    return (np.arange(numel) % 1001 + r).astype(np.float32)


def _spec(**env):
    from horovod_tpu_torch import compression

    environ = {k: v for k, v in os.environ.items()
               if k not in ("HVT_WIRE_COMPRESSION", "HVT_ERROR_FEEDBACK",
                            "HVT_EF_MAX_BYTES")}
    environ.update(env)
    compression.configure(environ)


def _tx():
    from horovod_tpu_torch import compression

    return compression.tx_bytes("allreduce")


def _delta(before, after):
    return {c: after.get(c, 0) - before.get(c, 0)
            for c in set(before) | set(after)
            if after.get(c, 0) - before.get(c, 0)}


def worker(out):
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch import compression

    torch.manual_seed(0)
    hvt.init(device="cpu")
    r, n = hvt.rank(), hvt.size()
    res = {"rank": r, "size": n}
    T = torch.from_numpy

    # the spec unset: raw and exact, no encoded byte
    _spec()
    before = _tx()
    res["off_pair"] = hvt.wire_compression()
    res["off"] = hvt.allreduce(T(exact_ints(1 << 16, r)), op=hvt.Sum,
                               name="exact")
    res["off_tx"] = _delta(before, _tx())

    # each codec, on both link classes and as the inter half of a pair
    for spec in CODECS + tuple(f"none,{c}" for c in CODECS):
        _spec(HVT_WIRE_COMPRESSION=spec)
        res[f"pair/{spec}"] = hvt.wire_compression()
        for numel in SIZES:
            before = _tx()
            res[f"sum/{spec}/{numel}"] = hvt.allreduce(
                T(base(numel, r)), op=hvt.Sum, name=f"c.{numel}")
            res[f"tx/{spec}/{numel}"] = _delta(before, _tx())

    # under a codec: other dtypes move raw and stay exact, Adasum too
    _spec(HVT_WIRE_COMPRESSION="int8")
    for dt in (torch.int32, torch.float64, torch.float16):
        x = (torch.arange(1025) % 5 + 1 + r).to(dt)
        res[f"dtype/{dt}"] = hvt.allreduce(x, op=hvt.Sum,
                                           name=f"ex.{dt}")
    ada = T(base(300, r)) * (r + 1)
    before = _tx()
    res["adasum/int8"] = hvt.allreduce(ada, op=hvt.Adasum, name="ada")
    res["adasum_tx"] = _delta(before, _tx())
    res["average/int8"] = hvt.allreduce(torch.full((4103,), float(r + 1)),
                                        op=hvt.Average, name="avg")
    _spec()
    res["adasum/off"] = hvt.allreduce(ada, op=hvt.Adasum, name="ada")

    # fp32 Max and Min under none,int8 take the compressed route (the
    # engine's WireEligible takes every fp32 op but Adasum): quantized as
    # the reference's are; an integer Max moves raw and stays exact
    _spec(HVT_WIRE_COMPRESSION="none,int8")
    for op in OPS:
        before = _tx()
        res[f"op/{op}"] = hvt.allreduce(T(op_input(OP_NUMEL, r)),
                                        op=getattr(hvt, op), name=f"op.{op}")
        res[f"op_tx/{op}"] = _delta(before, _tx())
    before = _tx()
    res["op/int_max"] = hvt.allreduce(
        (torch.arange(1025, dtype=torch.int32) * (r + 3)) % 11, op=hvt.Max,
        name="op.int")
    res["op_tx/int_max"] = _delta(before, _tx())

    # error feedback (tests/test_data_plane.py:284-321)
    for ef in ("1", "0"):
        _spec(HVT_WIRE_COMPRESSION="int8", HVT_ERROR_FEEDBACK=ef)
        x = torch.full((256,), 0.01)
        x[0] = 100.0
        acc = torch.zeros(256, dtype=torch.float64)
        for _ in range(EF_STEPS):
            acc += hvt.allreduce(x, op=hvt.Average, name="ef").double()
        res[f"ef/{ef}/mean"] = acc / EF_STEPS
        res[f"ef/{ef}/bytes"] = compression.state().ef.bytes

    # the residual budget: two tensors fit, the third evicts the least
    # recently used, one larger than the budget is refused
    budget = 2 * BUDGET_NUMEL * 4
    _spec(HVT_WIRE_COMPRESSION="int8", HVT_EF_MAX_BYTES=str(budget))
    drops = []
    for name, numel in (("a", BUDGET_NUMEL), ("b", BUDGET_NUMEL),
                        ("a", BUDGET_NUMEL), ("c", BUDGET_NUMEL),
                        ("big", 4 * BUDGET_NUMEL)):
        hvt.allreduce(T(base(numel, r)), op=hvt.Sum, name=name)
        st = compression.state().ef
        drops.append((name, st.dropped, st.bytes))
    res["budget"] = drops
    res["budget_metric"] = compression._metric_handles()[3].labels().value

    # auto: the tuner explores, every rank locks the same codec
    _spec(HVT_WIRE_COMPRESSION="auto")
    res["auto_active"] = compression.auto_active()
    picks = []
    for i in range(AUTO_CALLS):
        y = hvt.allreduce(T(base(AUTO_NUMEL, r)), op=hvt.Sum, name="auto")
        picks.append(hvt.wire_compression()[1])
    res["auto_picks"] = picks
    res["auto_last"] = y
    res["auto_locked"] = compression.state().tuner("global").locked(
        4 * AUTO_NUMEL // 2, 1)

    # process sets: one host takes the intra codec, two hosts the inter
    _spec(HVT_WIRE_COMPRESSION="none,int8")
    sets = [hvt.add_process_set(s) for s in SETS]
    for ranks, ps in zip(SETS, sets):
        if r in ranks:
            before = _tx()
            res[f"set/{ranks}"] = hvt.allreduce(
                T(base(4103, r)), op=hvt.Sum, name="set", process_set=ps)
            res[f"set_tx/{ranks}"] = _delta(before, _tx())

    # auto with a set across hosts first: its calls (in the bucket of the
    # global calls' cross stage) feed its own tuner only, so the global
    # calls after them still pick alike on every rank
    _spec(HVT_WIRE_COMPRESSION="auto")
    if r in SETS[1]:
        set_picks = []
        for _ in range(AUTO_SET_CALLS):
            hvt.allreduce(T(base(AUTO_NUMEL // 2, r)), op=hvt.Sum,
                          name="auto_set", process_set=sets[1])
            set_picks.append(hvt.wire_compression()[1])
        res["auto_set_picks"] = set_picks
    picks = []
    for _ in range(AUTO_CALLS):
        y = hvt.allreduce(T(base(AUTO_NUMEL, r)), op=hvt.Sum,
                          name="auto_global")
        picks.append(hvt.wire_compression()[1])
    res["auto_after_set_picks"] = picks
    res["auto_after_set_last"] = y

    # a joined rank stands in with zeros through the same compressed route
    _spec(HVT_WIRE_COMPRESSION="none,int8")
    if r != n - 1:
        res["join_sum"] = hvt.allreduce(T(base(4103, r)), op=hvt.Sum,
                                        name="join")
    res["join_last"] = hvt.join()

    # the DistributedOptimizer's grouped reduction under int8
    _spec(HVT_WIRE_COMPRESSION="int8")
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.Tanh(),
                                torch.nn.Linear(32, 4))
    opt = hvt.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    g = torch.Generator().manual_seed(100 + r)
    losses = []
    for _ in range(4):
        xb = torch.randn(8, 16, generator=g)
        loss = model(xb).pow(2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss))
    res["opt_params"] = [p.detach().clone() for p in model.parameters()]
    res["opt_losses"] = losses
    res["opt_ef_bytes"] = compression.state().ef.bytes
    hvt.shutdown()
    torch.save(res, f"{out}.{r}.pt")


# WIRE4: the bench GPT at full width on four cards as two faked hosts of
# two, each spec in turn (tests/test_torch_port_cuda.py)
WIRE4_SPECS = ({}, {"HVT_WIRE_COMPRESSION": "none,bf16"},
               {"HVT_WIRE_COMPRESSION": "none,int8"},
               {"HVT_WIRE_COMPRESSION": "none,fp8"},
               {"HVT_WIRE_COMPRESSION": "auto"},
               {"HVT_WIRE_COMPRESSION": "none,int8",
                "HVT_EF_MAX_BYTES": str(1 << 30)})
WIRE4_STEPS, WIRE4_BATCH, WIRE4_SEQ = 8, 8, 1024
WIRE4_TIMED_CALLS = 5


def _codec_kernel(name):
    return any(k in name for k in ("encode_kernel", "decode_kernel",
                                   "ef_kernel"))


def wire4_worker(out, args):
    """The ``args["config"]`` GPT (the bench GPT on the cards; ``device``,
    ``batch`` and ``seq`` in ``args`` too) under DistributedOptimizer(AdamW)
    on this rank's own
    rows of a seeded batch, WIRE4_STEPS steps, the last one profiled: the
    losses, step times, each step's wire bytes and inter codec, a hash of
    the parameters' bits, the launches, the codec kernels' and NCCL's
    device ms in the profiled step, and the cross stage alone (a compressed
    or raw allreduce of one piece over the cross group) timed by CUDA
    events."""
    import hashlib
    import time

    import horovod_tpu_torch as hvt
    from horovod_tpu_torch import compression
    from horovod_tpu_torch.compression import codecs as W
    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.ops import _kernels as K
    from horovod_tpu_torch.ops import hierarchical as H
    from horovod_tpu_torch.train import (gpt_config, make_train_step,
                                         seeded_tokens)

    cuda = args["device"] == "cuda"
    hvt.init(device=args["device"])
    if not cuda:
        torch.set_num_threads(1)
    r, n = hvt.rank(), hvt.size()
    cfg = gpt_config(args["config"], use_flash=cuda)
    model = GPT(cfg, device=hvt.device(), seed=0)
    opt = hvt.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    step = make_train_step(model, opt)
    batch = args["batch"]
    tokens = seeded_tokens(cfg, batch * n, args["seq"], seed=0)[
        r * batch:(r + 1) * batch]
    res = {"rank": r, "losses": [], "step_s": [], "tx": [], "picks": []}
    K.reset_launches()
    for i in range(WIRE4_STEPS):
        prof = None
        if i == WIRE4_STEPS - 1 and cuda:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res["losses"].append(float(step(tokens)))
        res["step_s"].append(time.perf_counter() - t0)
        if prof is not None:
            prof.__exit__(None, None, None)
        res["tx"].append(compression.tx_bytes("allreduce"))
        res["picks"].append(hvt.wire_compression()[1])
    res["launches"] = dict(K.LAUNCHES)
    times = {}
    for e in (prof.key_averages() if prof is not None else ()):
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = getattr(e, "cuda_time_total", 0)
        if dev and (_codec_kernel(e.key) or "nccl" in e.key.lower()):
            times[e.key] = dev / 1e3
    res["profiled_step_device_ms"] = times
    res["codec_ms_per_step"] = sum(v for k, v in times.items()
                                   if _codec_kernel(k))
    res["nccl_ms_per_step"] = sum(v for k, v in times.items()
                                  if "nccl" in k.lower())
    digest = hashlib.sha256()
    for p in model.parameters():
        digest.update(p.detach().float().cpu().numpy().tobytes())
    res["param_sha256"] = digest.hexdigest()
    res["n_params"] = sum(p.numel() for p in model.parameters())
    res["n_tensors"] = len(list(model.parameters()))
    st = compression.state()
    res["ef_residual_bytes"], res["ef_dropped"] = st.ef.bytes, st.ef.dropped
    # the cross stage alone, at the step's piece size, with this spec's
    # inter codec (the last pick under auto)
    _, cross, L, Cs = H._groups()
    piece = W.BLOCK * -(-res["n_params"] // (L * W.BLOCK))
    x = torch.randn(piece, device=hvt.device())
    codec = compression.codec_id(hvt.wire_compression()[1])
    ms = []
    for _ in range(WIRE4_TIMED_CALLS if cuda else 1):
        buf = x.clone()
        if not cuda:
            H._group_allreduce(buf, cross, Cs, hvt.cross_rank(), codec)
            break
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        H._group_allreduce(buf, cross, Cs, hvt.cross_rank(), codec)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    res["cross_stage_ms"] = ms
    res["cross_stage_elements"] = piece
    hvt.shutdown()
    torch.save(res, f"{out}.{r}.pt")


def run_wire4(out, spec, n=4, local_size=2, timeout=600, device="cuda",
              config="bench", batch=WIRE4_BATCH, seq=WIRE4_SEQ):
    """:func:`wire4_worker` on ``n`` cards as fake hosts of
    ``local_size``, each host's processes seeing only its own cards, under
    the env ``spec``; returns each rank's results. ``device="cpu"`` with a
    small ``config`` rehearses it on a gloo gang."""
    import json

    port = _free_port()
    cards = os.environ.get("CUDA_VISIBLE_DEVICES",
                           ",".join(map(str, range(n)))).split(",")
    procs = []
    for r in range(n):
        host = r // local_size
        env = dict(os.environ, PYTHONPATH=REPO, HVT_PROCESS_ID=str(r),
                   HVT_NUM_PROCESSES=str(n),
                   HVT_LOCAL_PROCESS_ID=str(r % local_size),
                   HVT_LOCAL_SIZE=str(local_size),
                   HVT_CROSS_RANK=str(host),
                   HVT_CROSS_SIZE=str(n // local_size),
                   HVT_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   CUDA_VISIBLE_DEVICES=",".join(
                       cards[host * local_size:(host + 1) * local_size]))
        for k in ("HVT_WIRE_COMPRESSION", "HVT_ERROR_FEEDBACK",
                  "HVT_EF_MAX_BYTES"):
            env.pop(k, None)
        env.update(spec)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "wire4", out,
             json.dumps({"device": device, "config": config,
                         "batch": batch, "seq": seq})],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(f"{out}.{r}.pt", weights_only=False)
            for r in range(n)]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_gang(n, local_size, out, timeout=300):
    """Run :func:`worker` on ``n`` processes; return each rank's results."""
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=REPO, HVT_PROCESS_ID=str(r),
                   HVT_NUM_PROCESSES=str(n),
                   HVT_LOCAL_PROCESS_ID=str(r % local_size),
                   HVT_LOCAL_SIZE=str(local_size),
                   HVT_CROSS_RANK=str(r // local_size),
                   HVT_CROSS_SIZE=str(n // local_size),
                   HVT_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   OMP_NUM_THREADS="1")
        for k in ("HVT_WIRE_COMPRESSION", "HVT_ERROR_FEEDBACK",
                  "HVT_EF_MAX_BYTES"):
            env.pop(k, None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), out], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(f"{out}.{r}.pt", weights_only=False)
            for r in range(n)]


if __name__ == "__main__":
    if sys.argv[1] == "wire4":
        import json

        wire4_worker(sys.argv[2], json.loads(sys.argv[3]))
    else:
        torch.set_num_threads(1)
        worker(sys.argv[1])
