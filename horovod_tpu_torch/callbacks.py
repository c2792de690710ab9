"""Training-loop callbacks (the JAX package's ``jax/callbacks.py``; Horovod's
``_keras/callbacks.py``) over ``nn.Module`` and ``torch.optim`` state.

A loop drives a :class:`CallbackList` at the standard hook points::

    cbs = hvt.callbacks.CallbackList([
        hvt.callbacks.BroadcastGlobalVariablesCallback(0),
        hvt.callbacks.MetricAverageCallback(),
        hvt.callbacks.LearningRateWarmupCallback(
            initial_lr=0.1 * hvt.size(), warmup_epochs=5,
            steps_per_epoch=100, optimizer=opt),
    ])
    cbs.on_train_begin({"model": model, "optimizer": opt})
    for epoch ...:
        cbs.on_epoch_begin(epoch)
        for batch ...:
            cbs.learning_rate(step)      # written into opt's param groups
            ...
        metrics = cbs.on_epoch_end(epoch, metrics)

The schedules' arithmetic is the JAX package's, step for step;
:func:`warmup_schedule` and :func:`exponential_schedule` are the same
schedules as plain functions of the step.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Dict, List, Optional

import torch

from horovod_tpu_torch.common import basics


class Callback:
    def on_train_begin(self, state):
        return state

    def on_epoch_begin(self, epoch: int):
        pass

    def on_epoch_end(self, epoch: int, metrics: Optional[Dict] = None):
        return metrics

    def learning_rate(self, step: int) -> Optional[float]:
        return None


class CallbackList(Callback):
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = list(callbacks)

    def on_train_begin(self, state):
        for cb in self.callbacks:
            state = cb.on_train_begin(state)
        return state

    def on_epoch_begin(self, epoch):
        for cb in self.callbacks:
            cb.on_epoch_begin(epoch)

    def on_epoch_end(self, epoch, metrics=None):
        for cb in self.callbacks:
            metrics = cb.on_epoch_end(epoch, metrics)
        return metrics

    def learning_rate(self, step):
        lr = None
        for cb in self.callbacks:
            v = cb.learning_rate(step)
            lr = v if v is not None else lr
        return lr


def broadcast_state(state, root_rank=0):
    """Overwrite ``state`` in place with ``root_rank``'s and return it:
    a module (its ``state_dict()``), an optimizer (its state and
    hyperparameters), a state dict of tensors, or a dict or list of
    these."""
    from horovod_tpu_torch.ops.functions import (broadcast_optimizer_state,
                                                 broadcast_parameters)

    if isinstance(state, torch.nn.Module):
        broadcast_parameters(state.state_dict(), root_rank=root_rank)
    elif isinstance(state, torch.optim.Optimizer):
        broadcast_optimizer_state(state, root_rank=root_rank)
    elif isinstance(state, Mapping) and all(torch.is_tensor(v)
                                            for v in state.values()):
        broadcast_parameters(state, root_rank=root_rank)
    elif isinstance(state, Mapping):
        for key in sorted(state):
            broadcast_state(state[key], root_rank)
    elif isinstance(state, (list, tuple)):
        for item in state:
            broadcast_state(item, root_rank)
    else:
        raise TypeError(f"cannot broadcast a {type(state).__name__}")
    return state


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast the initial state from ``root_rank`` at train start so all
    workers begin identical (Horovod's
    ``BroadcastGlobalVariablesCallbackImpl:22``); the state is that of
    :func:`broadcast_state`."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self, state):
        return broadcast_state(state, self.root_rank)


class MetricAverageCallback(Callback):
    """Average epoch metrics across workers (Horovod's
    ``MetricAverageCallbackImpl:48``): one float64 allreduce of the values
    in sorted key order. Values may be floats or 0-d tensors."""

    def on_epoch_end(self, epoch, metrics=None):
        if not metrics:
            return metrics
        from horovod_tpu_torch.ops.collective_ops import allreduce

        keys = sorted(metrics)
        vals = torch.tensor([float(metrics[k]) for k in keys],
                            dtype=torch.float64, device=basics.device())
        avg = allreduce(vals, average=True).tolist()
        out = dict(metrics)
        out.update(zip(keys, avg))
        return out


class MetricsCallback(Callback):
    """Fold epoch-end metrics into a registry (the JAX package's
    ``MetricsCallback``): each numeric value becomes a sample of the
    ``<prefix>_metric`` gauge labelled by its name, and epochs are counted
    in ``<prefix>_epochs_total``. ``registry`` defaults to the process's
    (``horovod_tpu_torch.metrics.registry()``), which ``GET /metrics``
    serves. Order it after :class:`MetricAverageCallback` to record the
    average."""

    def __init__(self, registry=None, prefix: str = "hvt_train"):
        if registry is None:
            from horovod_tpu_torch import metrics

            registry = metrics.registry()
        self._gauge = registry.gauge(
            f"{prefix}_metric", "training metrics by name (last epoch)",
            ("metric",))
        self._epochs = registry.counter(f"{prefix}_epochs_total",
                                        "training epochs completed")

    def on_epoch_end(self, epoch, metrics=None):
        self._epochs.inc()
        for k, v in (metrics or {}).items():
            try:
                self._gauge.labels(metric=str(k)).set(float(v))
            except (TypeError, ValueError):
                continue    # a non-numeric entry is skipped
        return metrics


def _set_lr(optimizer, lr):
    if optimizer is not None and lr is not None:
        for group in optimizer.param_groups:
            group["lr"] = lr
    return lr


class LearningRateScheduleCallback(Callback):
    """lr = initial_lr · multiplier(epoch) from ``start_epoch`` until
    ``end_epoch`` (Horovod's ``LearningRateScheduleCallbackImpl:89``);
    ``staircase`` holds the multiplier for a whole epoch, otherwise the epoch
    is fractional by the step. ``learning_rate(step)`` returns the value
    (None outside the range) and, with ``optimizer``, writes it into every
    param group's ``"lr"``."""

    def __init__(self, initial_lr: float, multiplier, start_epoch: int = 0,
                 end_epoch: Optional[int] = None, staircase: bool = True,
                 steps_per_epoch: Optional[int] = None, optimizer=None):
        self.initial_lr = initial_lr
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.steps_per_epoch = steps_per_epoch
        self.optimizer = optimizer
        self.current_epoch = 0
        if callable(multiplier):
            self.multiplier = multiplier
        else:
            self.multiplier = lambda epoch: multiplier

    def on_epoch_begin(self, epoch):
        self.current_epoch = epoch

    def _in_range(self, epoch) -> bool:
        if epoch < self.start_epoch:
            return False
        return self.end_epoch is None or epoch < self.end_epoch

    def _lr(self, step):
        if self.staircase or not self.steps_per_epoch:
            epoch = self.current_epoch
        else:
            epoch = step / self.steps_per_epoch
        if not self._in_range(epoch):
            return None
        return self.initial_lr * self.multiplier(epoch)

    def learning_rate(self, step):
        return _set_lr(self.optimizer, self._lr(step))


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Warm-up from lr/size to lr over the first ``warmup_epochs``
    ("Accurate Large Minibatch SGD"; Horovod's
    ``LearningRateWarmupCallbackImpl:172``): multiplier = 1/size ·
    (epoch · (size - 1) / warmup_epochs + 1); lr after the warm-up."""

    def __init__(self, initial_lr: float, warmup_epochs: int = 5,
                 steps_per_epoch: Optional[int] = None, verbose: bool = False,
                 size: Optional[int] = None, optimizer=None):
        self.size = size if size is not None else basics.size()
        self.warmup_epochs = warmup_epochs
        self.verbose = verbose

        def multiplier(epoch):
            if self.size <= 1 or self.warmup_epochs == 0:
                return 1.0
            return 1.0 / self.size * (
                epoch * (self.size - 1) / self.warmup_epochs + 1)

        super().__init__(initial_lr=initial_lr, multiplier=multiplier,
                         start_epoch=0, end_epoch=warmup_epochs,
                         staircase=False, steps_per_epoch=steps_per_epoch,
                         optimizer=optimizer)

    def learning_rate(self, step):
        lr = self._lr(step)
        return _set_lr(self.optimizer,
                       lr if lr is not None else self.initial_lr)

    def on_epoch_end(self, epoch, metrics=None):
        if self.verbose and epoch == self.end_epoch - 1:
            print(f"LearningRateWarmup: reached target lr "
                  f"{self.initial_lr:.6g} after {self.warmup_epochs} "
                  f"epochs")
        return metrics


def warmup_schedule(initial_lr: float, warmup_steps: int,
                    size: Optional[int] = None):
    """``schedule(step)``: linear warm-up from initial_lr/size to initial_lr
    over ``warmup_steps``, then constant."""
    n = size if size is not None else basics.size()

    def schedule(step):
        frac = min(step / max(warmup_steps, 1), 1.0)
        start = initial_lr / n
        return start + (initial_lr - start) * frac

    return schedule


def exponential_schedule(initial_lr: float, decay: float,
                         steps_per_epoch: int, staircase: bool = True):
    """``schedule(step)`` = initial_lr · decay^epoch, the epoch whole with
    ``staircase``: :class:`LearningRateScheduleCallback` with multiplier
    decay**epoch."""

    def schedule(step):
        epoch = step / steps_per_epoch
        if staircase:
            epoch = math.floor(epoch)
        return initial_lr * decay ** epoch

    return schedule
