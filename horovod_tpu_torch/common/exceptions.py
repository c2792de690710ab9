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


class HostsUpdatedInterrupt(RuntimeError):
    """Raised at a commit point when elastic training has told this
    worker that the set of hosts changed (Horovod's
    ``common/exceptions.py:26``). With ``skip_sync`` the worker that saw the
    update needs no re-sync of its state: it is current."""

    def __init__(self, skip_sync=False):
        super().__init__("Hosts updated; re-initialization required")
        self.skip_sync = skip_sync


class HorovodVersionMismatchError(ImportError):
    """An extension was built against another version of the core (the
    JAX package's ``common/exceptions.py:40``)."""


class TensorShapeMismatchError(ValueError):
    """A cross-rank shape mismatch of the coordinator's checks
    (``ops/negotiation.py``). Like the JAX engine, the checks raise a plain
    ``ValueError``; this subclass is kept for code that names it."""


class TensorDtypeMismatchError(ValueError):
    """A cross-rank dtype mismatch (see :class:`TensorShapeMismatchError`)."""
