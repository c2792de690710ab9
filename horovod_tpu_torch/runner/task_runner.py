"""Worker entry of the programmatic ``run()`` (the JAX package's
``runner/task_runner.py``; Horovod's ``runner/run_task.py``): loads the
pickled function, starts the process group, runs the function and writes
this rank's result.

The worker runs on the card of its local rank unless ``HVT_RUN_DEVICE``
names another device (``run(device="cpu")`` sets ``cpu``: gloo).

Fault injection: ``HVT_FAULT_INJECT=kill:rank=R:after_sec=S`` arms a timer
that SIGKILLs rank R S seconds after ``init``, a host lost at an arbitrary
point (between collectives included). Specs with ``after_ops`` belong to
the JAX package's C++ engine, which the port does not have, and are
ignored here.
"""

from __future__ import annotations

import os
import sys

import cloudpickle


def maybe_arm_fault_timer(rank: int, spec: str = None):
    """Arm the ``kill:rank=R:after_sec=S`` trigger of HVT_FAULT_INJECT for
    this process, if the spec names it. Returns the armed timer (a daemon
    Timer) or None."""
    spec = spec if spec is not None else os.environ.get("HVT_FAULT_INJECT")
    if not spec or not spec.startswith("kill:"):
        return None
    fields = dict(
        f.split("=", 1) for f in spec.split(":")[1:] if "=" in f)
    if "after_sec" not in fields:
        return None  # an op-count trigger: not the port's
    try:
        if int(fields.get("rank", -1)) != rank:
            return None
        delay = float(fields["after_sec"])
    except ValueError:
        return None
    import signal
    import threading

    def _die():
        print(f"[hvt rank {rank}] HVT_FAULT_INJECT: raising SIGKILL "
              f"after {delay} s", flush=True)
        os.kill(os.getpid(), signal.SIGKILL)

    t = threading.Timer(delay, _die)
    t.daemon = True
    t.start()
    return t


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    fn_path, out_dir = argv[0], argv[1]
    from horovod_tpu_torch.runner.codec import loads_base64

    with open(fn_path) as f:
        fn, args, kwargs = loads_base64(f.read())

    import horovod_tpu_torch as hvt

    hvt.init(device=os.environ.get("HVT_RUN_DEVICE") or None)
    maybe_arm_fault_timer(hvt.rank())
    result = fn(*args, **kwargs)
    with open(os.path.join(out_dir, f"result_{hvt.rank()}.pkl"),
              "wb") as f:
        cloudpickle.dump(result, f)
    hvt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
