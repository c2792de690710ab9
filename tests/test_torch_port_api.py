"""The rest of Horovod's API surface in horovod_tpu_torch, held against the
JAX package: the callbacks against ``horovod_tpu.jax.callbacks`` on the
same schedule steps and metrics, the topology and build queries,
``alltoall``'s return rule against the torch binding, and on a 2-process
gloo job started by the port's launcher (tests/torch_port_launch_worker.py,
no JAX) the in-place and async collectives against their synchronous
forms, ``DistributedOptimizer(num_groups=)`` against one group, and the
broadcast and metric-average callbacks.

Schedules are the same float64 arithmetic: rtol 1e-12 (the JAX schedules
run in float32 under jnp: rtol 1e-6). Collectives against their own
synchronous forms: exact.
"""

import math

import numpy as np
import pytest
import torch

import horovod_tpu.torch as jtorch
import horovod_tpu_torch as hvt
import torch_port_launch_worker as W
from horovod_tpu.jax import callbacks as jcb
from horovod_tpu.metrics.registry import MetricRegistry as JaxRegistry
from horovod_tpu_torch import callbacks as cb


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    j = W.Launch(2, "api", str(tmp_path_factory.mktemp("api") / "res"))
    yield j
    j.kill()


@pytest.fixture()
def world():
    """A world of one process on the CPU, shut down after the test if the
    test started it."""
    started = not hvt.is_initialized()
    hvt.init(device="cpu")
    yield hvt
    if started:
        hvt.shutdown()


def _lrs(callback, epochs, steps_per_epoch):
    out = []
    for epoch in range(epochs):
        callback.on_epoch_begin(epoch)
        for i in range(steps_per_epoch):
            out.append(callback.learning_rate(epoch * steps_per_epoch + i))
    return out


SCHEDULES = {
    "staircase": lambda m: m.LearningRateScheduleCallback(
        0.4, multiplier=lambda e: 0.5 ** e, start_epoch=1, end_epoch=4),
    "smooth": lambda m: m.LearningRateScheduleCallback(
        0.4, multiplier=lambda e: 0.5 ** e, staircase=False,
        steps_per_epoch=3),
    "constant": lambda m: m.LearningRateScheduleCallback(0.1, 0.25),
    "warmup": lambda m: m.LearningRateWarmupCallback(
        0.8, warmup_epochs=3, steps_per_epoch=3, size=4),
    "warmup_one": lambda m: m.LearningRateWarmupCallback(
        0.8, warmup_epochs=3, steps_per_epoch=3, size=1),
    "list": lambda m: m.CallbackList([
        m.LearningRateWarmupCallback(0.8, warmup_epochs=2,
                                     steps_per_epoch=3, size=8),
        m.LearningRateScheduleCallback(0.2, 0.5, start_epoch=3)]),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_callbacks_equal_the_jax_callbacks(name):
    got = _lrs(SCHEDULES[name](cb), 5, 3)
    want = _lrs(SCHEDULES[name](jcb), 5, 3)
    assert [g is None for g in got] == [w is None for w in want]
    np.testing.assert_allclose([g for g in got if g is not None],
                               [w for w in want if w is not None],
                               rtol=1e-12)


def test_lr_callbacks_write_the_param_groups():
    p = torch.nn.Parameter(torch.zeros(2))
    opt = torch.optim.SGD([p, ], lr=1.0)
    opt.add_param_group({"params": [torch.nn.Parameter(torch.zeros(1))]})
    warm = cb.LearningRateWarmupCallback(0.8, warmup_epochs=2,
                                         steps_per_epoch=2, size=4,
                                         optimizer=opt)
    jwarm = jcb.LearningRateWarmupCallback(0.8, warmup_epochs=2,
                                           steps_per_epoch=2, size=4)
    for step in range(6):
        lr = warm.learning_rate(step)
        assert lr == pytest.approx(jwarm.learning_rate(step), rel=1e-12)
        assert [g["lr"] for g in opt.param_groups] == [lr, lr]
    sched = cb.LearningRateScheduleCallback(0.5, 0.1, start_epoch=2,
                                            optimizer=opt)
    assert sched.learning_rate(0) is None       # outside: left alone
    assert opt.param_groups[0]["lr"] == lr


@pytest.mark.parametrize("staircase", [True, False])
def test_plain_schedules_equal_the_jax_schedules(staircase):
    steps = range(0, 25)
    for got_fn, want_fn in (
            (cb.warmup_schedule(0.8, 10, size=4),
             jcb.warmup_schedule(0.8, 10, size=4)),
            (cb.exponential_schedule(0.3, 0.7, 4, staircase=staircase),
             jcb.exponential_schedule(0.3, 0.7, 4, staircase=staircase))):
        np.testing.assert_allclose([got_fn(s) for s in steps],
                                   [float(want_fn(s)) for s in steps],
                                   rtol=1e-6)
    assert cb.exponential_schedule(1.0, 0.5, 2)(5) == 0.25
    assert cb.warmup_schedule(1.0, 4, size=2)(2) == 0.75


def test_metrics_callback_records_as_the_jax_callback():
    metrics = [{"loss": 2.5, "acc": 0.25, "note": "x"},
               {"loss": 1.5, "acc": np.float32(0.5)}]
    for mod in (cb, jcb):
        reg = JaxRegistry()
        callback = mod.MetricsCallback(registry=reg, prefix="t")
        for epoch, m in enumerate(metrics):
            assert callback.on_epoch_end(epoch, m) is m
        gauge = reg.get("t_metric")
        assert reg.get("t_epochs_total").value == 2
        assert gauge.labels(metric="loss").value == 1.5
        assert gauge.labels(metric="acc").value == 0.5


def test_metrics_callback_needs_a_registry():
    """The port has no process-wide registry to default to."""
    with pytest.raises(TypeError):
        cb.MetricsCallback()


def test_callbacks_in_a_world_of_one(world):
    model = torch.nn.Linear(2, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    lst = cb.CallbackList([cb.BroadcastGlobalVariablesCallback(0),
                           cb.MetricAverageCallback()])
    assert lst.on_train_begin(model) is model
    assert all(torch.equal(before[k], v)
               for k, v in model.state_dict().items())
    assert lst.on_epoch_end(0, {"a": 1.25, "b": torch.tensor(2.0)}) == \
        {"a": 1.25, "b": 2.0}
    assert lst.on_epoch_end(1, None) is None
    assert cb.LearningRateWarmupCallback(0.1).size == 1
    with pytest.raises(TypeError):
        cb.broadcast_state(object())


def test_topology_and_build_queries(world):
    assert (hvt.process_rank(), hvt.process_size()) == (hvt.rank(),
                                                        hvt.size())
    assert hvt.is_homogeneous() is True
    assert hvt.nccl_built() == torch.distributed.is_nccl_available()
    assert hvt.gloo_built() is True and hvt.gloo_enabled() is True
    assert hvt.mpi_built() == torch.distributed.is_mpi_available()
    assert hvt.cuda_built() == (torch.version.cuda is not None)
    assert not any(f() for f in (hvt.mpi_enabled, hvt.mpi_threads_supported,
                                 hvt.rocm_built, hvt.ccl_built,
                                 hvt.ddl_built, hvt.xla_built))
    err = hvt.HostsUpdatedInterrupt(skip_sync=True)
    assert isinstance(err, RuntimeError) and err.skip_sync
    import horovod_tpu as jhvt

    assert str(err) == str(jhvt.HostsUpdatedInterrupt(True))


def test_exports_cover_the_torch_binding_and_jax_names():
    names = ["allreduce_async_", "grouped_allreduce_",
             "grouped_allreduce_async_", "grouped_allgather_async",
             "reducescatter_async", "SyncBatchNorm", "broadcast_variables",
             "HostsUpdatedInterrupt", "process_rank", "process_size",
             "is_homogeneous", "gloo_enabled", "mpi_enabled",
             "mpi_threads_supported", "nccl_built", "gloo_built",
             "mpi_built", "cuda_built", "rocm_built", "ccl_built",
             "ddl_built", "xla_built", "callbacks", "checkpoint"]
    assert all(n in hvt.__all__ and hasattr(hvt, n) for n in names)
    assert hvt.SyncBatchNorm.__name__ == jtorch.SyncBatchNorm.__name__


def test_alltoall_return_rule_matches_the_torch_binding(world):
    """Without splits the output alone, with splits (output, splits), as
    ``horovod_tpu/torch/mpi_ops.py:366-372``; the async form follows the
    same rule."""
    x = torch.arange(12.0).reshape(4, 3)
    for splits in (None, [4]):
        got, want = hvt.alltoall(x, splits=splits), \
            jtorch.alltoall(x, splits=splits)
        assert type(got) is type(want)
        if splits is None:
            assert torch.equal(got, want)
        else:
            assert torch.equal(got[0], want[0])
            assert got[1].tolist() == want[1].tolist() == [4]
    assert torch.equal(hvt.synchronize(hvt.alltoall_async(x)), x)
    out, recv = hvt.synchronize(hvt.alltoall_async(x, splits=[4]))
    assert torch.equal(out, x) and recv.tolist() == [4]


def test_broadcast_variables_is_broadcast_parameters(world):
    sd = {"w": torch.ones(3)}
    assert hvt.broadcast_variables(sd, root_rank=0) is sd


def test_in_place_and_async_collectives_equal_the_sync_forms(job):
    for r, res in enumerate(job.results()):
        for key, want in res["want"].items():
            got = res["got"][key]
            assert len(got) == len(want), key
            for g, w in zip(got, want):
                assert torch.equal(g, w), (r, key)
        assert res["int_average_in_place"].startswith("TypeError")


def test_in_place_forms_against_numpy(job):
    results = job.results()
    xs = [res["x"].numpy() for res in results]
    np.testing.assert_allclose(results[0]["got"]["allreduce_async_"][1],
                               np.mean(xs, axis=0), rtol=1e-6)
    ys = [res["y"].numpy() for res in results]
    np.testing.assert_allclose(
        results[1]["got"]["grouped_allreduce_async_"][1],
        np.mean([2 * y for y in ys], axis=0), rtol=1e-6)
    np.testing.assert_allclose(results[1]["got"]["reducescatter_async"][0],
                               0.5 * np.sum(xs, axis=0)[2:], rtol=1e-6)


def test_num_groups_gives_the_one_group_update(job):
    for res in job.results():
        one, three = res["num_groups"][0], res["num_groups"][3]
        assert all(torch.equal(a, b) for a, b in zip(one, three))
    a, b = (res["num_groups"][3] for res in job.results())
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_split_list_equals_the_torch_bindings():
    from horovod_tpu.common.util import split_list
    from horovod_tpu_torch.optimizer import _split_list

    for n in range(0, 9):
        for parts in range(1, 6):
            xs = list(range(n))
            assert _split_list(xs, parts) == split_list(xs, parts)


def test_callbacks_and_queries_on_the_job(job):
    results = job.results()
    for r, res in enumerate(results):
        assert (res["process_rank"], res["process_size"]) == (r, 2)
        assert res["is_homogeneous"] is True
        # rank 1's model (filled with 1, one SGD step of lr 0.1 on a unit
        # gradient) and momentum everywhere
        for k, v in res["broadcast_model"].items():
            assert torch.allclose(v, torch.full_like(v, 0.9)), k
        for a, b in zip(res["broadcast_momentum"],
                        results[1]["broadcast_momentum"]):
            assert torch.equal(a, b)
        assert res["metrics"] == {"loss": 1.5, "acc": 0.25, "n": 1.0}
        assert res["warmup_default_size"] == 2
    assert not torch.equal(results[0]["x"], results[1]["x"])
    assert math.isclose(results[0]["metrics"]["loss"], 1.5)
