"""Elastic state of a PyTorch training loop: the port's copies of the JAX
package's ``horovod_tpu/torch/elastic/state.py`` (Horovod's
``torch/elastic/state.py:27-140``) and of ``ReplicatedJaxState``.

- :class:`TorchState` snapshots each tracked module, optimizer and
  :class:`~horovod_tpu_torch.elastic.sampler.ElasticSampler` by deep-copying
  its ``state_dict()`` where it lives, as the torch binding does: a model
  on the card keeps its snapshot on the card, so a survivor restores
  without a transfer, and a fresh worker gets the state from ``sync()``.
- :class:`ReplicatedTorchState` snapshots to host memory instead, since its
  commits pickle the snapshot into replica shards on peer ranks
  (``elastic/state.py`` ``ReplicatedState``).
"""

from __future__ import annotations

import copy

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.elastic.sampler import ElasticSampler
from horovod_tpu_torch.elastic.state import (HvtCollectives, ObjectState,
                                             ReplicatedState,
                                             raise_if_aborted)
from horovod_tpu_torch.ops.functions import (_map_tensors, allgather_object,
                                             broadcast_object,
                                             broadcast_optimizer_state,
                                             broadcast_parameters)


def _host_copy(tree):
    """``tree`` with every tensor copied to host memory."""
    return _map_tensors(tree, lambda t: t.detach().to("cpu", copy=True))


def _wait_for_copies():
    """Block until the snapshot copies queued on this process's card ran."""
    if basics.is_initialized() and basics.device().type == "cuda":
        torch.cuda.current_stream(basics.device()).synchronize()


class StateHandler:
    """Save/restore/sync for one tracked value (Horovod's
    ``torch/elastic/state.py:71``). ``snapshot()`` copies the value's state
    where it lives; ``host_snapshot()`` and ``load()`` are the host-memory
    form that :class:`ReplicatedTorchState` pickles."""

    def __init__(self, value):
        self.value = value
        self._saved_state = None

    def snapshot(self):
        return copy.deepcopy(self.value.state_dict())

    def save(self):
        self._saved_state = self.snapshot()

    def restore(self):
        self.load(self._saved_state)

    def host_snapshot(self):
        return _host_copy(self.value.state_dict())

    def load(self, state):
        self.value.load_state_dict(copy.deepcopy(state))

    def broadcast(self):
        """Take rank 0's state (the state's ``sync`` snapshots after)."""
        raise NotImplementedError

    def set_value(self, value):
        self.value = value
        self.save()


class ModelStateHandler(StateHandler):
    def load(self, state):
        # load_state_dict copies into the parameters: no alias to keep
        self.value.load_state_dict(state)

    def broadcast(self):
        broadcast_parameters(self.value.state_dict(), root_rank=0)


class OptimizerStateHandler(StateHandler):
    def load(self, state):
        # a copy: the optimizer keeps tensors of a state_dict on its
        # parameters' device as they are, and updates them in place (a
        # DistributedOptimizer also drops the passes it held)
        self.value.load_state_dict(copy.deepcopy(state))

    def broadcast(self):
        broadcast_optimizer_state(self.value, root_rank=0)


class SamplerStateHandler(StateHandler):
    def host_snapshot(self):
        return self.snapshot()

    def broadcast(self):
        # merge the processed indices over the (possibly changed) world,
        # then reshard the rest (Horovod's torch/elastic/state.py:116-140).
        # Each surviving rank consumed a disjoint set; the union, not rank
        # 0's view, is what must not be repeated this epoch.
        state = self.value.state_dict()
        all_states = allgather_object(state, name="elastic.sampler.state")
        processed = set()
        for s in all_states:
            processed.update(s["processed_indices"])
        epoch = broadcast_object(state["epoch"], root_rank=0,
                                 name="elastic.sampler.epoch")
        self.value.load_state_dict({
            "epoch": epoch,
            "processed_indices": sorted(processed),
        })


def _make_handler(v):
    if isinstance(v, torch.nn.Module):
        return ModelStateHandler(v)
    if isinstance(v, torch.optim.Optimizer):
        return OptimizerStateHandler(v)
    if isinstance(v, ElasticSampler):
        return SamplerStateHandler(v)
    return None


class _Handled:
    """A state whose modules, optimizers and samplers sit behind handlers;
    its plain attributes are the ``ObjectState``'s."""

    def _take_handlers(self, model, optimizer, kwargs):
        """Give each torch value of ``kwargs`` (and ``model``,
        ``optimizer``) a handler; returns the plain attributes."""
        self._handlers = {}
        if model is not None:
            kwargs["model"] = model
        if optimizer is not None:
            kwargs["optimizer"] = optimizer
        plain = {}
        for k, v in kwargs.items():
            h = _make_handler(v)
            if h is not None:
                self._handlers[k] = h
                object.__setattr__(self, k, v)
            else:
                plain[k] = v
        return plain

    def _tracked(self):
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_") and k not in self._handlers}

    def __setattr__(self, name, value):
        if not name.startswith("_") and name in getattr(self, "_handlers",
                                                        ()):
            self._track(name, value)
        object.__setattr__(self, name, value)


class TorchState(_Handled, ObjectState):
    """Elastic state wrapping torch objects and plain attributes (Horovod's
    ``torch/elastic/state.py:27``)::

        state = TorchState(model=model, optimizer=optimizer, epoch=0)
        state.sync()       # broadcast from the new rank 0
        state.commit()     # snapshot + host-update check
        state.restore()    # roll back after HorovodInternalError

    Assigning a new module, optimizer or sampler to a tracked name
    (``state.model = other``) tracks the new object and snapshots it.
    """

    def __init__(self, model=None, optimizer=None, **kwargs):
        super().__init__(**self._take_handlers(model, optimizer, kwargs))

    def save(self):
        # the new snapshot replaces the last one only once its copies ran
        # and the world was not aborted meanwhile: a step that a peer's
        # death cut short must not become the committed state
        snaps = {k: h.snapshot() for k, h in self._handlers.items()}
        tracked = copy.deepcopy(self._tracked())
        _wait_for_copies()
        raise_if_aborted()
        for k, h in self._handlers.items():
            h._saved_state = snaps[k]
        self._saved_state = tracked

    def restore(self):
        for h in self._handlers.values():
            h.restore()
        super().restore()

    def sync(self):
        for h in self._handlers.values():
            h.broadcast()
        super().sync()

    def _track(self, name, value):
        self._handlers[name].set_value(value)


class ReplicatedTorchState(_Handled, ReplicatedState):
    """:class:`TorchState`'s semantics with peer replication (the JAX
    package's ``ReplicatedJaxState``): the snapshot of each module,
    optimizer and sampler is copied to host memory on save, so the shard
    payloads pickle and CRC like plain objects, and the bootstrap before the
    first commit broadcasts them from rank 0."""

    def __init__(self, model=None, optimizer=None, replicas=None,
                 collectives=None, fallback=None, **kwargs):
        plain = self._take_handlers(model, optimizer, kwargs)
        super().__init__(replicas=replicas, collectives=collectives,
                         fallback=fallback, **plain)

    def save(self):
        snap = {k: h.host_snapshot() for k, h in self._handlers.items()}
        snap.update(copy.deepcopy(self._tracked()))
        raise_if_aborted()
        self._saved_state = snap

    def restore(self):
        for k, v in self._saved_state.items():
            if k in self._handlers:
                self._handlers[k].load(v)
            else:
                setattr(self, k, copy.deepcopy(v))

    def _bootstrap_sync(self):
        if not isinstance(self._coll(), HvtCollectives):
            super()._bootstrap_sync()
            return
        for h in self._handlers.values():
            h.broadcast()
        ObjectState.sync(self)

    def _track(self, name, value):
        self._handlers[name].value = value     # snapshot at the next save
