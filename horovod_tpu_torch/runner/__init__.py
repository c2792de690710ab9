"""The port's launcher: ``python -m horovod_tpu_torch.runner.launch``."""
