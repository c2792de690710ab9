"""Horovod's import path ``horovod.spark.torch`` (``spark/torch/
estimator.py:91``) for the port; the implementation is
:mod:`horovod_tpu_torch.spark.estimator`."""

from horovod_tpu_torch.spark.estimator import (TorchEstimator,  # noqa: F401
                                               TorchModel)
