"""A ragged two-rank program for ``hvt.join`` that runs on either package:
``ragged(hvt, T, N)`` takes the package, a numpy-to-tensor function and a
tensor-to-numpy one, and returns what each collective gave this rank. It
imports neither JAX nor torch, so the JAX engine's gang
(``tests/test_engine_integration.py:run_workers``) and the port's gloo gang
run the same calls.

As a script it is the port's worker (``python -m
horovod_tpu_torch.runner.launch -np 2 python
tests/torch_port_join_program.py OUT``): it runs ``ragged`` on gloo, then
one ``DistributedOptimizer`` step of a small model with rank 1 joined, and
writes ``OUT.<rank>.json``.
"""

import json
import sys
import time

import numpy as np

OPT_SEED = 5


def ragged(hvt, T, N):
    """Phase 1: both ranks reduce once, then rank 1 joins and rank 0 runs
    Sum, Average and integer allreduces, an allgather and an alltoall with
    splits against its stand-ins, and repeats the first collective (the
    JAX engine's cached-hit liveness pin). Phase 2: rank 1 submits an
    async allreduce and joins; rank 0 reduces the same name half a second
    later (the submitted-then-joined pin). Then a barrier."""
    r = hvt.rank()
    res = {}
    res["sum_both"] = N(hvt.allreduce(T(np.full(3, r + 1.0, np.float32)),
                                      op=hvt.Sum, name="s"))
    res["avg_both"] = N(hvt.allreduce(T(np.full(3, 2.0 * (r + 1),
                                                np.float32)),
                                      op=hvt.Average, name="a"))
    if r == 0:
        res["sum_joined"] = N(hvt.allreduce(
            T(np.arange(1, 5, dtype=np.float32)), op=hvt.Sum, name="s2"))
        res["avg_joined"] = N(hvt.allreduce(
            T(np.full(4, 6.0, np.float32)), op=hvt.Average, name="a2"))
        res["int_sum_joined"] = N(hvt.allreduce(
            T(np.arange(4, dtype=np.int32) + 7), op=hvt.Sum, name="i2"))
        res["allgather_joined"] = N(hvt.allgather(
            T(np.full((2, 3), 5.0, np.float32)), name="ag"))
        out, splits = hvt.alltoall(
            T(np.arange(6, dtype=np.float32).reshape(3, 2)),
            splits=[1, 2], name="aa")
        res["alltoall_joined"], res["alltoall_splits"] = N(out), N(splits)
        res["sum_repeat"] = N(hvt.allreduce(T(np.ones(3, np.float32)),
                                            op=hvt.Sum, name="s"))
    res["last_join"] = int(hvt.join())
    if r == 1:
        h = hvt.allreduce_async(T(np.full(4, 5.0, np.float32)), op=hvt.Sum,
                                name="g")
        res["last_join_async"] = int(hvt.join())
        res["async_then_join"] = N(hvt.synchronize(h))
    else:
        time.sleep(0.5)   # let rank 1's submit and join land first
        res["async_then_join"] = N(hvt.allreduce(
            T(np.full(4, 3.0, np.float32)), op=hvt.Sum, name="g"))
        res["last_join_async"] = int(hvt.join())
    hvt.barrier()
    return {k: v.tolist() if isinstance(v, np.ndarray) else v
            for k, v in res.items()}


def opt_model():
    import torch

    torch.manual_seed(OPT_SEED)
    return torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(),
                               torch.nn.Linear(5, 2))


def opt_batch():
    rng = np.random.RandomState(OPT_SEED)
    return (rng.randn(4, 6).astype(np.float32),
            rng.randn(4, 2).astype(np.float32))


def optimizer_step(hvt):
    """One AdamW step of ``opt_model`` through ``DistributedOptimizer``
    with rank 1 joined: rank 0's gradient averages with zeros. Returns rank
    0's parameters after it and join's value on every rank."""
    import torch

    model = opt_model()
    opt = hvt.DistributedOptimizer(torch.optim.AdamW(model.parameters(),
                                                     lr=1e-2))
    out = {}
    if hvt.rank() == 0:
        x, y = (torch.from_numpy(a) for a in opt_batch())
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        out["params"] = [p.detach().numpy().tolist()
                         for p in model.parameters()]
    out["last_join_opt"] = int(hvt.join())
    return out


def main(out_path):
    import torch

    import horovod_tpu_torch as hvt

    hvt.init(device="cpu")
    res = ragged(hvt, torch.from_numpy, lambda t: np.asarray(t))
    res.update(optimizer_step(hvt))
    res["diagnostics"] = hvt.diagnostics()
    with open(f"{out_path}.{hvt.rank()}.json", "w") as f:
        json.dump(res, f)
    hvt.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
