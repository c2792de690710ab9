"""Ray integration (the JAX package's ``ray/``; Horovod's
``horovod/ray/runner.py:250`` RayExecutor and ``ray/elastic.py:300``
ElasticRayExecutor)."""

from horovod_tpu_torch.ray.runner import Coordinator, RayExecutor  # noqa: F401,E501
from horovod_tpu_torch.ray.elastic import (ElasticRayExecutor,  # noqa: F401
                                           RayHostDiscovery)
