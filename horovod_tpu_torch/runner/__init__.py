"""The port's launcher package. ``run()`` is the programmatic API
(``runner/api.py``; Horovod's ``horovod/runner/__init__.py:91``); the CLI
is ``python -m horovod_tpu_torch.runner.launch``."""


def __getattr__(name):
    # lazy: keeps cloudpickle (used only by run()) out of the import path
    # of the CLI and of launched workers
    if name == "run":
        from horovod_tpu_torch.runner.api import run

        return run
    raise AttributeError(name)
