"""horovod_tpu_torch's programmatic ``run()`` (``runner/api.py``,
``runner/task_runner.py``, ``runner/codec.py``) held against the JAX
package's ``horovod_tpu/runner``.

- ``run()`` on gloo (``device="cpu"``, np 2), as
  ``tests/test_runner_util.py:197`` runs the JAX package's: results
  ordered by rank, ``(30.0, r, 2)``.
- ``HVT_FAULT_INJECT=kill:rank=1:after_sec=1`` kills rank 1 and ``run()``
  raises ``RuntimeError``.
- Both jobs run through the port's launcher, one after the other in a
  thread started when this module loads, before the JAX side computes.
- The codec round-trips a closure, and each package decodes the other's
  encoding; the fault-timer spec parses alike in both packages.
"""

import os
import threading
import time

import pytest

from horovod_tpu.runner import codec as jcodec
from horovod_tpu.runner import task_runner as jtask
from horovod_tpu_torch.runner import codec as tcodec
from horovod_tpu_torch.runner import task_runner as ttask


def _functions(marker):
    """The jobs' functions, made here so that cloudpickle ships them by
    value (the workers cannot import this test module)."""

    def train(scale):
        import torch

        import horovod_tpu_torch as hvt

        val = hvt.allreduce(torch.tensor([float(hvt.rank() + 1)]),
                            op=hvt.Sum, name="r")
        return float(val[0]) * scale, hvt.rank(), hvt.size()

    def linger():
        import time

        import horovod_tpu_torch as hvt

        with open(f"{marker}.{hvt.rank()}", "w"):
            pass
        time.sleep(60)          # rank 1 is killed after 1 s
        return hvt.rank()

    return train, linger


class _Jobs(threading.Thread):
    """``run()`` calls made one after another in a thread of their own
    (``run()`` sets its ``env`` in this process's environment while it
    launches, so two calls must not overlap)."""

    def __init__(self, calls):
        super().__init__(daemon=True)
        self.calls = calls
        self.outcomes = {}
        self.ended = {}
        self.start()

    def run(self):
        from horovod_tpu_torch.runner import run

        for name, (args, kwargs) in self.calls.items():
            t0 = time.monotonic()
            try:
                self.outcomes[name] = (run(*args, **kwargs), None)
            except Exception as e:      # noqa: BLE001 — held by the tests
                self.outcomes[name] = (None, e)
            self.ended[name] = time.monotonic() - t0

    def outcome(self, name, timeout=240):
        self.join(timeout)
        assert not self.is_alive(), "run() did not return"
        return self.outcomes[name]


@pytest.fixture(scope="module", autouse=True)
def jobs(tmp_path_factory):
    marker = str(tmp_path_factory.mktemp("run") / "linger")
    train, linger = _functions(marker)
    job = _Jobs({
        "ok": ((train,), dict(args=(10,), np=2, device="cpu",
                              env={"OMP_NUM_THREADS": "1"})),
        "killed": ((linger,), dict(
            np=2, device="cpu",
            env={"HVT_FAULT_INJECT": "kill:rank=1:after_sec=1",
                 "OMP_NUM_THREADS": "1"}))})
    job.marker = marker
    return job


def test_run_on_gloo_orders_results_by_rank(jobs):
    result, error = jobs.outcome("ok")
    assert error is None, error
    # ranks ordered; the allreduce sums 1 + 2 = 3, scaled to 30
    assert result == [(30.0, 0, 2), (30.0, 1, 2)]


def test_run_raises_when_a_rank_is_killed(jobs):
    result, error = jobs.outcome("killed")
    assert result is None
    assert isinstance(error, RuntimeError)
    assert "exit code" in str(error)
    # both ranks ran the function, and the job ended long before its 60 s
    # sleep: the timer's SIGKILL ended it
    for r in range(2):
        assert os.path.exists(f"{jobs.marker}.{r}")
    assert jobs.ended["killed"] < 45


def test_codec_round_trips_a_closure_across_packages():
    base = 7

    def add(x, y=1):
        return x + y + base

    for dumps, loads in ((tcodec.dumps_base64, tcodec.loads_base64),
                         (tcodec.dumps_base64, jcodec.loads_base64),
                         (jcodec.dumps_base64, tcodec.loads_base64)):
        fn, args, kwargs = loads(dumps((add, (2,), {"y": 3})))
        assert fn(*args, **kwargs) == 12
        assert loads(dumps(lambda v: v * base))(3) == 21
    assert tcodec.dumps_base64({"a": [1, 2]}) == \
        jcodec.dumps_base64({"a": [1, 2]})


@pytest.mark.parametrize("spec,rank", [
    ("kill:rank=1:after_sec=30", 1), ("kill:rank=1:after_sec=30", 0),
    ("kill:rank=0:after_ops=5", 0), ("delay:rank=0:after_sec=1", 0),
    ("kill:rank=x:after_sec=1", 0), ("kill:rank=0:after_sec=oops", 0),
    ("", 0), (None, 0)])
def test_fault_timer_spec_parses_as_the_jax_runner(monkeypatch, spec, rank):
    monkeypatch.delenv("HVT_FAULT_INJECT", raising=False)
    got = ttask.maybe_arm_fault_timer(rank, spec)
    want = jtask.maybe_arm_fault_timer(rank, spec)
    for t in (got, want):
        if t is not None:
            t.cancel()
    assert (got is None) == (want is None)
    assert (got is not None) == (spec == "kill:rank=1:after_sec=30"
                                 and rank == 1)


def test_run_refuses_remote_hosts_without_a_shared_run_dir():
    from horovod_tpu_torch.runner import run

    with pytest.raises(ValueError, match="run_dir"):
        run(print, np=2, hosts="far-away-host:2", device="cpu")


def test_runner_package_exports_run_lazily():
    import horovod_tpu_torch.runner as R
    from horovod_tpu_torch.runner.api import run

    assert R.run is run
    with pytest.raises(AttributeError):
        R.not_there   # noqa: B018
