"""base64 <-> pickled-object codec for passing callables and config
through files, environment variables and command lines (the JAX package's
``runner/codec.py``; Horovod's ``runner/common/util/codec.py``). Uses
cloudpickle so closures and lambdas survive the trip."""

from __future__ import annotations

import base64

import cloudpickle


def dumps_base64(obj) -> str:
    return base64.b64encode(cloudpickle.dumps(obj)).decode("ascii")


def loads_base64(encoded: str):
    return cloudpickle.loads(base64.b64decode(encoded.encode("ascii")))
