"""Pipeline parallelism: GPipe microbatch pipelining over a ``pp`` mesh
axis (the JAX package's ``parallel/pipeline.py``).

Stage s of S is the s-th member of this rank's ``pp`` line and holds its
slice of the stacked stage parameters. Microbatch m reaches stage s at
tick m + s: stage s receives it from stage s - 1, applies ``stage_fn`` and
sends the activation to stage s + 1 (``send``/``recv`` on the pp set).
The backward runs the GPipe backward explicitly, microbatches in reverse,
with one ``torch.autograd.grad`` per microbatch and stage and the
activation gradients sent back the same way. Every stage posts its
point-to-point operations in one fixed order, microbatch by microbatch,
so a receiver never takes one microbatch's tensor for another's.

``stage_fn(params, x) -> y`` maps activations of one shape to the same
shape (standard for transformer blocks). The last stage's output reaches
every stage (the JAX ``psum`` of the output): every member computes the
loss from it and backpropagates, and the last stage's gradient drives the
backward, as for a ``reduce_from`` result.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops.collective_ops import _collective

PIPELINE_AXIS = "pp"


def split_microbatches(x, n_micro: int):
    """[batch, ...] → [n_micro, batch / n_micro, ...]."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))


def merge_microbatches(x):
    """Inverse of :func:`split_microbatches`."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def stage_partition_spec(stacked_params, axis_name: str = PIPELINE_AXIS):
    """``{name: spec}`` placing each tensor's leading stage dim on the pipe
    axis (for ``models.convert.shard_state_dict``)."""
    return {name: (axis_name,) + (None,) * (t.dim() - 1)
            for name, t in stacked_params.items()}


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, process_set, n_micro, names, x, *params):
        members = process_set.global_ranks()
        last = len(members) - 1
        s = process_set.rank_in_set(basics.rank())
        group = process_set.group()
        leaves = [p.detach().requires_grad_() for p in params]
        with torch.enable_grad():   # forward runs under no_grad
            local = {n: leaf[0] for n, leaf in zip(names, leaves)}
        inputs, outputs = [], []
        for m, mb in enumerate(split_microbatches(x.detach(), n_micro)):
            if s == 0:
                inp = mb.clone().requires_grad_(ctx.needs_input_grad[4])
            else:
                inp = torch.empty_like(mb)
                _collective(dist.recv, inp, members[s - 1], group=group)
                inp.requires_grad_()
            with torch.enable_grad():
                out = stage_fn(local, inp)
            if s < last:
                _collective(dist.send, out.detach().contiguous(),
                            members[s + 1], group=group)
            inputs.append(inp)
            outputs.append(out)
        result = (torch.stack([o.detach() for o in outputs]) if s == last
                  else x.new_empty((n_micro, x.shape[0] // n_micro)
                                   + tuple(x.shape[1:])))
        _collective(dist.broadcast, result, members[last], group=group)
        ctx.state = (process_set, n_micro, inputs, outputs, leaves)
        return merge_microbatches(result)

    @staticmethod
    def backward(ctx, grad):
        process_set, n_micro, inputs, outputs, leaves = ctx.state
        del ctx.state
        members = process_set.global_ranks()
        last = len(members) - 1
        s = process_set.rank_in_set(basics.rank())
        group = process_set.group()
        grads = split_microbatches(grad, n_micro)
        param_grads = [torch.zeros_like(leaf) for leaf in leaves]
        x_grads = [None] * n_micro
        for m in reversed(range(n_micro)):
            if s == last:
                g = grads[m].contiguous()
            else:
                g = torch.empty_like(outputs[m])
                _collective(dist.recv, g, members[s + 1], group=group)
            wrt = ([inputs[m]] if inputs[m].requires_grad else []) + leaves
            got = torch.autograd.grad(outputs[m], wrt, g, allow_unused=True)
            if inputs[m].requires_grad:
                g_in, got = got[0], got[1:]
                if s > 0:
                    _collective(dist.send, g_in.contiguous(), members[s - 1],
                                group=group)
                else:
                    x_grads[m] = g_in
            for acc, g_p in zip(param_grads, got):
                if g_p is not None:
                    acc += g_p
        grad_x = None
        if ctx.needs_input_grad[4]:
            # the input is replicated over the stages; stage 0 read it
            grad_x = (torch.stack(x_grads) if s == 0 else
                      torch.empty_like(split_microbatches(grad, n_micro)))
            _collective(dist.broadcast, grad_x, members[0], group=group)
            grad_x = merge_microbatches(grad_x)
        return (None, None, None, None, grad_x, *param_grads)


def pipeline(stage_fn, stacked_params, x, n_micro: int, mesh,
             axis_name: str = PIPELINE_AXIS):
    """Run the GPipe schedule over this rank's ``axis_name`` line of
    ``mesh`` and return ``[batch, ...]`` outputs on every stage.

    ``stacked_params`` is this stage's shard of the stacked parameters: a
    dict whose tensors keep a leading stage dim of 1 (what
    ``shard_state_dict(stacked, stage_partition_spec(stacked), ...)``
    gives); ``stage_fn`` sees them with that dim dropped. ``x`` is the
    whole batch, the same on every stage (stage 0 reads it). Gradients
    reach the parameters and ``x``."""
    process_set = mesh.process_set(axis_name)
    names = sorted(stacked_params)
    return _GPipe.apply(stage_fn, process_set, n_micro, tuple(names), x,
                        *[stacked_params[n] for n in names])
