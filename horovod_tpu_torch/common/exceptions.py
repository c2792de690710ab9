"""The exceptions the port raises; its own copies of the types in
``horovod_tpu/common/exceptions.py`` (Horovod's ``common/exceptions.py``)."""


class HorovodInternalError(RuntimeError):
    """A collective failed mid-flight (a peer was lost, or the backend
    reported an error). Elastic training would catch it and restore from the
    last committed state."""


class HorovodTimeoutError(TimeoutError):
    """``synchronize(handle, timeout=...)`` reached its deadline with the
    collective still pending. The collective keeps running and the handle
    stays waitable: a timeout does not mean the gang failed."""
