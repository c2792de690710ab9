"""DistributedOptimizer: combine gradients across processes before each
update (Horovod's ``torch/optimizer.py``; the JAX package's
``horovod_tpu/jax/__init__.py:DistributedGradientTransformation``).

Under pjit the JAX step runs with ``axis_name=None`` because XLA's autodiff
of a batch-sharded loss inserts the gradient psum itself. PyTorch inserts
nothing, so ``step()`` reduces every gradient explicitly, even in a world of
one process (where the reduction sends nothing: ``collective_ops``).
"""

from __future__ import annotations

import contextlib
import warnings

import torch

from horovod_tpu_torch.common.process_sets import global_process_set
from horovod_tpu_torch.models.convert import flax_path
from horovod_tpu_torch.ops import collective_ops as C
from horovod_tpu_torch.ops.compression import Compression


class _DistributedOptimizer(torch.optim.Optimizer):
    """Methods grafted onto a subclass of the wrapped optimizer's class, so
    the result is still that optimizer (``isinstance``, schedulers,
    ``state_dict``) with the gradient reduction in front of ``step``."""

    def __init__(self, params, reduce_kwargs, names, reduce_filter,
                 backward_passes_per_step, average_aggregated_gradients,
                 num_groups):
        super(self.__class__, self).__init__(params)
        self._hvt_reduce_kwargs = reduce_kwargs
        self._hvt_names = names
        self._hvt_filter = reduce_filter
        self._hvt_passes_per_step = backward_passes_per_step
        self._hvt_average_aggregated = average_aggregated_gradients
        self._hvt_num_groups = num_groups
        self._hvt_passes = 0
        self._hvt_acc = {}      # param -> gradient sum of the held passes
        self._hvt_should_sync = True    # False inside skip_synchronize()
        self._hvt_synchronized = False  # synchronize() ran since step()

    def _hvt_reduced(self, p):
        if self._hvt_filter is None:
            return True
        if p not in self._hvt_names:
            raise ValueError("reduce_filter needs the name of every "
                             "parameter: pass named_parameters=")
        return self._hvt_filter(self._hvt_names[p])

    def synchronize(self):
        """Reduce every ``.grad`` that the filter selects, in place: one
        fused collective per (device, wire dtype) through
        ``grouped_allreduce``, or with ``num_groups`` N one such call for
        each of N near-equal runs of the parameters in order (the torch
        binding's ``split_list``). Over more than one process a selected
        parameter without a gradient (unused by this rank's pass) takes part
        with zeros, as the torch binding's does
        (``horovod_tpu/torch/optimizer.py:175-181``), so every rank fuses
        buffers of one size and the ranks step alike."""
        params = [p for group in self.param_groups for p in group["params"]
                  if self._hvt_reduced(p)]
        if self._hvt_reduce_kwargs["process_set"].size() > 1:
            for p in params:
                if p.grad is None and p.requires_grad:
                    p.grad = torch.zeros_like(p)
        params = [p for p in params if p.grad is not None]
        for k, group in enumerate(_split_list(params,
                                              self._hvt_num_groups or 1)):
            # the group's name keys its tensors' error-feedback residuals
            # (compression), as the torch binding names it group.<param>
            first = self._hvt_names.get(group[0], f"noname.{k}")
            C.grouped_allreduce_([p.grad for p in group],
                                 name=f"group.{first}",
                                 **self._hvt_reduce_kwargs)
        self._hvt_synchronized = True

    def load_state_dict(self, state_dict):
        """Load the inner optimizer's state. The passes an unfinished
        ``backward_passes_per_step`` update holds belong to the state being
        replaced (an elastic restore rolls back to a commit), so they go."""
        self._hvt_acc, self._hvt_passes = {}, 0
        self._hvt_synchronized = False
        super(self.__class__, self).load_state_dict(state_dict)

    @contextlib.contextmanager
    def skip_synchronize(self):
        """``step()`` inside this block does not reduce: for Horovod's
        recipe of ``synchronize()``, then gradient clipping, then
        ``with opt.skip_synchronize(): opt.step()``."""
        self._hvt_should_sync = False
        try:
            yield
        finally:
            self._hvt_should_sync = True

    def step(self, closure=None):
        """With ``backward_passes_per_step`` N, call this after every
        backward pass: calls 1..N-1 add the gradients to an accumulator and
        leave the parameters and the inner state untouched; call N reduces
        the sum (divided by N with ``average_aggregated_gradients``), runs
        the inner update and empties the accumulator. Each pass's
        gradient is added to the accumulator and ``.grad`` is set to None,
        so a pass is counted once whether or not the caller clears the
        gradients between the passes of an update. The adds are foreach ops: a few launches a
        pass, not one per parameter."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if self._hvt_passes_per_step > 1:
            self._hvt_passes += 1
            acc = self._hvt_acc
            params = [p for group in self.param_groups
                      for p in group["params"] if p.grad is not None]
            held = [p for p in params if p in acc]
            if held:
                torch._foreach_add_([acc[p] for p in held],
                                    [p.grad for p in held])
            fresh = [p for p in params if p not in acc]
            if fresh:   # copies: the caller may still hold these tensors
                copies = [torch.empty_like(p.grad) for p in fresh]
                torch._foreach_copy_(copies, [p.grad for p in fresh])
                acc.update(zip(fresh, copies))
            for p in params:    # the accumulator holds each pass once
                p.grad = None
            if self._hvt_passes < self._hvt_passes_per_step:
                return loss
            if self._hvt_average_aggregated and acc:
                torch._foreach_div_(list(acc.values()),
                                    self._hvt_passes_per_step)
            for p, g in acc.items():
                p.grad = g
            self._hvt_acc, self._hvt_passes = {}, 0
        if self._hvt_should_sync:
            if self._hvt_synchronized:
                warnings.warn("optimizer.step() after synchronize() reduces "
                              "the gradients a second time; call step() "
                              "inside skip_synchronize()")
            self.synchronize()
        self._hvt_synchronized = False
        super(self.__class__, self).step()
        return loss


def _split_list(xs, num_parts):
    """At most ``num_parts`` near-equal contiguous non-empty runs of ``xs``,
    the longer first (``horovod_tpu/common/util.py:6``)."""
    num_parts = min(num_parts, len(xs))
    if not num_parts:
        return []
    base, extra = divmod(len(xs), num_parts)
    bounds = [0]
    for i in range(num_parts):
        bounds.append(bounds[-1] + base + (i < extra))
    return [xs[a:b] for a, b in zip(bounds, bounds[1:])]


def DistributedOptimizer(optimizer, named_parameters=None, *, op=C.Average,
                         compression=Compression.none,
                         prescale_factor=1.0, postscale_factor=1.0,
                         gradient_predivide_factor=1.0,
                         backward_passes_per_step=1,
                         average_aggregated_gradients=False,
                         process_set=global_process_set,
                         reduce_filter=None, num_groups=0):
    """Wrap a ``torch.optim.Optimizer`` so that ``step()`` first reduces
    every gradient over ``process_set`` with ``op`` (Average by default;
    Adasum with per-tensor coefficients), ``compression`` and the
    pre/postscale factors, then runs the inner update.

    - ``gradient_predivide_factor`` f splits Average's 1/size into a
      prescale f/size and a postscale 1/f around a Sum (size of the set),
      and requires op=Average.
    - ``backward_passes_per_step`` and ``average_aggregated_gradients``: see
      ``step``. The accumulator belongs to the optimizer, so it survives
      ``zero_grad(set_to_none=True)``.
    - ``reduce_filter(name) -> bool`` on the parameter's dotted name (from
      ``named_parameters``): a parameter for which it returns False keeps
      its local gradient.
    - A process that is not a member of ``process_set`` gets
      ``ValueError`` from ``step``.
    - ``num_groups`` N > 0 reduces the gradients in N grouped
      collectives over near-equal runs of the parameters in order, as the
      torch binding groups them; 0 fuses them all into one.
    - ``synchronize()`` reduces now; ``step()`` inside
      ``skip_synchronize()`` then updates without reducing again.
    - A module sharded by ``parallel.fsdp.shard_module`` reduces its own
      gradients: its parameters raise ``ValueError`` here, since a second
      reduction over the same ranks would be wrong. Take a plain
      optimizer for it.
    """
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be at least 1")
    if gradient_predivide_factor != 1.0:
        if op is not C.Average:
            raise ValueError("gradient_predivide_factor requires "
                             "op=Average")
        op = C.Sum
        prescale_factor *= gradient_predivide_factor / process_set.size()
        postscale_factor /= gradient_predivide_factor
    if num_groups < 0:
        raise ValueError("num_groups must be at least 0")
    if any(getattr(p, "_hvt_fsdp", False) for group in optimizer.param_groups
           for p in group["params"]):
        raise ValueError(
            "these parameters belong to a module sharded by shard_module, "
            "which already reduces their gradients; use the plain "
            "optimizer")
    names = {p: name for name, p in (named_parameters or ())}
    if reduce_filter is not None and not names:
        raise ValueError("reduce_filter needs named_parameters=")
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups,
               dict(op=op, compression=compression,
                    prescale_factor=prescale_factor,
                    postscale_factor=postscale_factor,
                    process_set=process_set),
               names, reduce_filter, backward_passes_per_step,
               average_aggregated_gradients, num_groups)


def PartialDistributedOptimizer(optimizer, named_parameters, local_layers=(),
                                **kwargs):
    """:func:`DistributedOptimizer` that leaves local every parameter whose
    name contains one of ``local_layers`` (the JAX package's
    ``PartialDistributedGradientTransformation``). Names are matched in the
    JAX package's form, the flax path that ``models/convert.py`` maps
    (``blocks.0.attn.q`` is ``block_0/attn/q/kernel``), so the same
    ``local_layers`` select the same tensors in both packages."""
    layers = tuple(local_layers)

    def reduce_filter(name):
        path = "/".join(flax_path(name))
        return not any(layer in path for layer in layers)

    return DistributedOptimizer(optimizer, named_parameters,
                                reduce_filter=reduce_filter, **kwargs)
