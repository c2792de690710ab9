"""Spark integration of the port (the JAX package's ``spark/``; Horovod's
``horovod/spark/__init__.py`` and ``spark/runner.py:195`` ``run()``: Spark
tasks become job slots; the torch estimator and the store ecosystem of
``spark/common/store.py`` and ``spark/torch/estimator.py``)."""

from horovod_tpu_torch.spark.estimator import (TorchEstimator,  # noqa: F401
                                               TorchModel)
from horovod_tpu_torch.spark.runner import (run, run_elastic,  # noqa: F401
                                            slot_envs_from_task_infos)  # noqa: F401,E501
from horovod_tpu_torch.spark.store import (DBFSLocalStore,  # noqa: F401
                                           FilesystemStore, GCSStore,
                                           HDFSStore, HTTPStore, LocalStore,
                                           RemoteStore, Store)
