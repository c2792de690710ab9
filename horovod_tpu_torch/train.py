"""The port's GPT training step: the counterpart of ``bench.py``'s
``measure_gpt`` and ``__graft_entry__.py``'s ``dryrun_multichip``.

A step is: GPT logits → shifted-target cross-entropy → backward →
``DistributedOptimizer(AdamW)`` (gradient allreduce, then the update).
On a dp × sp × tp mesh, :func:`make_parallel_train_step` runs the same step
with the batch split over dp, the sequence over sp (ring attention) and the
model over tp (Megatron), and :func:`parallel_loss_fn` is its loss.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models.transformer import GPT, GPTConfig
from horovod_tpu_torch.ops import collective_ops as C
from horovod_tpu_torch.ops.losses import softmax_cross_entropy_fused
from horovod_tpu_torch.optimizer import DistributedOptimizer
from horovod_tpu_torch.parallel.primitives import reduce_from

GPT_CONFIGS = {
    # __graft_entry__.py:_flagship — the entry() model
    "entry": dict(vocab_size=512, n_layers=2, d_model=128, n_heads=4,
                  d_ff=512, max_seq_len=128),
    # bench.py --model gpt (bench.py:200-202): the widest GPT the repo runs
    "bench": dict(vocab_size=32768, n_layers=12, d_model=768, n_heads=12,
                  d_ff=3072, max_seq_len=1024),
}


def gpt_config(name, **overrides) -> GPTConfig:
    """A named configuration, with any ``GPTConfig`` field overridden."""
    return dataclasses.replace(GPTConfig(**GPT_CONFIGS[name]), **overrides)


def loss_fn(model, tokens, chunked_ce=False):
    """Mean next-token cross-entropy over positions 0..S-2 (the last
    position has no target), from fp32 logits; with ``chunked_ce`` from the
    hidden states through ``softmax_cross_entropy_fused``, which never
    holds the whole logits (``bench.py --chunked-ce``)."""
    targets = torch.roll(tokens, -1, dims=-1)
    if chunked_ce:
        hidden = model(tokens, return_hidden=True)
        return softmax_cross_entropy_fused(hidden[:, :-1], model.embedding,
                                           targets[:, :-1])
    logits = model(tokens)
    targets[..., -1] = -100                      # ignored by cross_entropy
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1), ignore_index=-100)


def vocab_parallel_cross_entropy(logits, targets, process_set, first):
    """Per-position cross-entropy from logits whose vocab is split over
    ``process_set``: this rank's ``[..., V / n]`` slice holds vocab ids
    ``first`` onwards. The max, the sum of exponentials and the target's
    logit are each combined over the set, so no rank holds the whole
    vocab. Positions whose target is -100 give 0."""
    m = logits.detach().amax(dim=-1)
    if process_set.size() > 1:
        m = C.allreduce(m, op=C.Max, process_set=process_set)
    sum_exp = reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1),
                          process_set)
    local = targets - first
    inside = (local >= 0) & (local < logits.shape[-1])
    picked = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)
                           [..., None])[..., 0] * inside
    target_logit = reduce_from(picked, process_set)
    return (torch.log(sum_exp) + m - target_logit) * (targets != -100)


def parallel_loss_fn(model, tokens, mesh):
    """This rank's share of the mean next-token cross-entropy of the
    global batch ``tokens`` ``[B, S]`` (the same on every rank): rows split
    over ``dp``, columns over ``sp``, vocab over ``tp``. Targets are made
    from the whole rows, so the last token of a sequence shard is scored
    against the first of the next. The shares sum to the loss over the dp ×
    sp ranks: each is this rank's summed loss over B·(S-1)."""
    b, s = tokens.shape
    dp, sp = mesh.axis_size("dp"), mesh.axis_size("sp")
    if b % dp or s % sp:
        raise ValueError(f"tokens {tuple(tokens.shape)} do not split over "
                         f"dp {dp} and sp {sp}")
    targets = torch.roll(tokens, -1, dims=-1)
    targets[..., -1] = -100
    i, j = mesh.axis_index("dp") * (b // dp), mesh.axis_index("sp") * (s // sp)
    rows, cols = slice(i, i + b // dp), slice(j, j + s // sp)
    logits = model(tokens[rows, cols])
    losses = vocab_parallel_cross_entropy(
        logits, targets[rows, cols], mesh.process_set("tp"),
        mesh.axis_index("tp") * logits.shape[-1])
    return losses.sum() / (b * (s - 1))


def make_parallel_train_step(model, optimizer, mesh):
    """``step(tokens) -> loss`` on a dp × sp × tp mesh, for ``model`` built
    on it (``GPT(cfg, mesh=mesh)``, ``cfg.ring_mesh=mesh`` when sp > 1)
    and a plain torch ``optimizer`` over its parameters. ``tokens`` is the
    global ``[B, S]`` batch, the same on every rank; the loss returned is
    the global mean, on every rank.

    Every parameter (or tp shard) is replicated over dp × sp, so the
    optimizer is wrapped in ``DistributedOptimizer(op=Sum)`` over this
    rank's dp × sp line: the sum of the ranks' gradients of their loss
    shares is the gradient of the loss (a sum over sp of partial gradients
    and a mean over dp). The wrapped optimizer is ``step.optimizer``."""
    data = mesh.process_set(("dp", "sp"))
    optimizer = DistributedOptimizer(optimizer, op=C.Sum, process_set=data)

    def step(tokens):
        optimizer.zero_grad(set_to_none=True)
        share = parallel_loss_fn(model, tokens, mesh)
        share.backward()
        optimizer.step()
        return C.allreduce(share.detach(), op=C.Sum, process_set=data)

    step.optimizer = optimizer
    return step


def make_train_step(model, optimizer, chunked_ce=False):
    """``step(tokens) -> loss`` (a 0-d tensor on the model's device)."""

    def step(tokens):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens, chunked_ce)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def seeded_tokens(cfg, batch, seq, seed=0):
    """This process's ``[batch, seq]`` slice of a global batch of
    ``batch · size()`` rows drawn from ``seed``."""
    rows = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (batch * basics.size(), seq))
    mine = rows[basics.rank() * batch:(basics.rank() + 1) * batch]
    return torch.from_numpy(mine).to(basics.device())


def train(cfg, steps, batch, seq, *, device=None, seed=0, lr=1e-4,
          weight_decay=1e-4):
    """Data-parallel training on one repeated seeded batch (as
    ``measure_gpt`` does). ``batch`` is per process. Returns the per-step
    ``loss`` and ``step_s`` (host seconds, ending in a device sync), the
    ``model`` and the ``optimizer``."""
    basics.init(device=device)
    model = GPT(cfg, device=basics.device(), seed=seed)
    optimizer = DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=lr, weight_decay=weight_decay))
    step = make_train_step(model, optimizer)
    tokens = seeded_tokens(cfg, batch, seq, seed)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = float(step(tokens))                # waits for the device
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    return {"loss": losses, "step_s": times, "model": model,
            "optimizer": optimizer}
