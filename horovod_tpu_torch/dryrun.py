"""The multi-process entry point: the port's counterpart of
``__graft_entry__.dryrun_multichip``.

Every process of a launched gang (``hvtrun``, or the ``HVT_*`` identity env)
calls :func:`dryrun_multichip`. It runs, on its own device:

1. the replicated baseline: two AdamW steps of the GPT on the whole batch,
   no communication;
2. the same two steps from the same weights on a dp × sp × tp mesh (batch
   over dp, sequence over sp by ring attention, Megatron tensor parallelism
   over tp), held to the baseline: for ``"entry"`` at the JAX function's
   tolerances, loss rtol 1e-4 / atol 1e-5 and parameters rtol 1e-3 / atol
   1e-4 (fp32; AdamW's 1/sqrt(v) turns ~1e-7 gradient differences from
   summation order into ~1e-4, while a wrong sharding is off by O(lr));
3. ``_dryrun_ep`` (MoE on dp × ep), ``_dryrun_pp`` (the GPipe pipeline),
   ``_dryrun_sp_ring`` (ring attention with the flash kernels per block,
   GQA, against the dense computation) and ``_dryrun_hier`` (hierarchical
   allreduce in a training step), each against its one-process value.

It returns the numbers it checked. ``config`` picks the GPT and its
checks (:data:`CONFIGS`): ``"entry"`` (the JAX function's ``_flagship`` in
fp32, as the JAX function runs it) or ``"bench"`` (the main path:
``bench.py --model gpt --flash`` at full width, bf16, the flash kernels in
every ring block).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models.convert import shard_state_dict
from horovod_tpu_torch.models.moe import MoEMlp
from horovod_tpu_torch.models.transformer import GPT, param_partition_spec
from horovod_tpu_torch.ops import collective_ops as C
from horovod_tpu_torch.ops.hierarchical import hierarchical_allreduce
from horovod_tpu_torch.parallel.mesh import make_parallel_mesh, mesh_factors
from horovod_tpu_torch.parallel.pipeline import (pipeline,
                                                 stage_partition_spec)
from horovod_tpu_torch.parallel.sequence import ring_attention
from horovod_tpu_torch.train import gpt_config, loss_fn, \
    make_parallel_train_step

STEPS = 2
# per config: the GPT's overrides, (batch, seq) from dp, AdamW's lr and
# weight decay, and the tolerances of the losses and (when not None) of
# every parameter after STEPS steps
CONFIGS = {
    # the JAX function's _flagship in fp32, its batch, optax.adamw(1e-3)
    # (weight decay 1e-4) and its tolerances
    "entry": dict(overrides=dict(dtype=torch.float32),
                  batch=lambda dp: (max(2, dp) * 2, 32), lr=1e-3,
                  loss_tol=dict(rtol=1e-4, atol=1e-5),
                  param_tol=dict(rtol=1e-3, atol=1e-4)),
    # the main path (bench.py --model gpt --flash: bf16, the flash kernels,
    # AdamW(1e-4)) held to its own tolerance, chip_smoke.py's 1e-2 on the
    # losses (about 2.5 bf16 epsilons). Parameters are not compared: in
    # bf16, and at this width even in fp32 (one element of 1,179,648 in
    # blocks.0.mlp.down missed atol 1e-4 by 5e-5 after two fp32 steps on
    # four H100s), AdamW's normalised update turns the rounding of a
    # near-zero gradient into a step of up to lr.
    "bench": dict(overrides=dict(use_flash=True),
                  batch=lambda dp: (8, 1024), lr=1e-4,
                  loss_tol=dict(rtol=1e-2, atol=0), param_tol=None),
}
WEIGHT_DECAY = 1e-4


def _close(tag, got, want, rtol, atol):
    """Raise unless |got - want| <= atol + rtol |want| everywhere; return
    the max abs difference."""
    got, want = (torch.as_tensor(t).detach().cpu().double()
                 for t in (got, want))
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"dryrun {tag}: {m}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"dryrun {tag}: non-finite values")
    return float((got - want).abs().max())


def dryrun_multichip(config="entry", *, device=None, axes=None,
                     state_dict=None) -> dict:
    """Run the dryrun on this process's device (CUDA unless ``device``
    says otherwise) and return what it checked. ``axes`` = (dp, sp, tp)
    overrides the split of the ranks (default ``mesh_factors``);
    ``state_dict`` (whole fp32 weights, e.g. from
    ``models.convert.params_from_flax``) overrides the weights drawn from
    seed 0. Raises ``AssertionError`` where a check fails."""
    basics.init(device=device)
    dev = basics.device()
    dp, sp, tp = axes or mesh_factors(basics.size())
    mesh = make_parallel_mesh(dp=dp, sp=sp, tp=tp)
    run = CONFIGS[config]
    cfg = gpt_config(config, **run["overrides"])
    batch, seq = run["batch"](dp)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).to(dev)
    full = state_dict or GPT(cfg, device="cpu").state_dict()

    def adamw(params):
        return torch.optim.AdamW(params, lr=run["lr"],
                                 weight_decay=WEIGHT_DECAY)

    # replicated baseline: the whole batch on this device, no collectives
    ref = GPT(cfg, device=dev)
    ref.load_state_dict(full)
    opt = adamw(ref.parameters())
    ref_losses = []
    for _ in range(STEPS):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(ref, tokens)
        loss.backward()
        opt.step()
        ref_losses.append(float(loss.detach()))

    # the same steps, sharded dp × sp × tp
    model = GPT(dataclasses.replace(cfg, ring_mesh=mesh), device=dev)
    specs = param_partition_spec(full, tp_size=tp)
    coords = mesh.coords()
    model.load_state_dict(shard_state_dict(full, specs, {"tp": tp}, coords))
    step = make_parallel_train_step(model, adamw(model.parameters()), mesh)
    losses = [float(step(tokens)) for _ in range(STEPS)]
    got = {"config": config, "world_size": basics.size(),
           "mesh": mesh.shape, "coords": coords, "batch": [batch, seq],
           "losses": losses, "ref_losses": ref_losses,
           "loss_max_abs_diff": _close("loss", losses, ref_losses,
                                       **run["loss_tol"]),
           "params": {k: v.detach().cpu()
                      for k, v in model.state_dict().items()}}
    if run["param_tol"] is not None:
        want = shard_state_dict(ref.state_dict(), specs, {"tp": tp}, coords)
        got["param_max_abs_diff"] = max(
            _close(f"param {name}", got["params"][name], want[name],
                   **run["param_tol"]) for name in want)
    del ref, opt, model, step
    return {**got, "ep": _dryrun_ep(dev), "pp": _dryrun_pp(dev),
            "sp_ring": _dryrun_sp_ring(dev), "hier": _dryrun_hier(dev)}


def _dryrun_ep(dev):
    """MoE on dp × ep: the experts split over ep, tokens over dp. The
    value of ``out.sum() + 0.01 · aux`` over the whole batch and its
    gradients, against the same layer without a mesh on the whole batch."""
    n = basics.size()
    ep = 2 if n % 2 == 0 else 1
    dp = n // ep
    mesh = make_parallel_mesh(dp=dp, ep=ep)
    kw = dict(d_model=16, n_experts=max(ep, 2), d_ff=32,
              dtype=torch.float32, device=dev)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2 * dp, 8, 16).astype(np.float32)).to(dev)
    i = mesh.axis_index("dp") * 2
    moe = MoEMlp(**kw, mesh=mesh)
    out, aux = moe(x[i:i + 2])
    # aux is the mean over this rank's rows: the batch's is their dp mean
    share = out.sum() + 0.01 * aux / dp
    share.backward()
    rows = mesh.process_set("dp")
    value = float(C.allreduce(share.detach(), op=C.Sum, process_set=rows))
    grads = C.grouped_allreduce([p.grad for p in moe.parameters()],
                                op=C.Sum, process_set=rows)

    whole = MoEMlp(**kw)
    out_ref, aux_ref = whole(x)
    ref = out_ref.sum() + 0.01 * aux_ref
    ref.backward()
    mine = slice(moe.first_expert, moe.first_expert + moe.wi.shape[0])
    diffs = [_close("ep value", value, ref, rtol=1e-5, atol=1e-5)]
    for (name, _), g in zip(moe.named_parameters(), grads):
        want = dict(whole.named_parameters())[name].grad
        if name in ("wi", "wo"):
            want = want[mine]
        diffs.append(_close(f"ep grad {name}", g, want, rtol=1e-4,
                            atol=1e-5))
    return {"mesh": mesh.shape, "value": value,
            "ref": float(ref.detach()),
            "max_abs_diff": max(diffs)}


def _stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _dryrun_pp(dev):
    """The GPipe pipeline over every rank, two microbatches, against the
    sequential composition of the stages: value and this stage's
    gradients."""
    n = basics.size()
    mesh = make_parallel_mesh(pp=n)
    d = 8
    rs = np.random.RandomState(1)
    stacked = {"w": torch.from_numpy(rs.randn(n, d, d).astype(np.float32)
                                     * .3).to(dev),
               "b": torch.zeros(n, d, device=dev)}
    x = torch.from_numpy(rs.randn(2 * n, d).astype(np.float32)).to(dev)
    mine = {k: v.requires_grad_() for k, v in shard_state_dict(
        stacked, stage_partition_spec(stacked), {"pp": n},
        mesh.coords()).items()}
    value = (pipeline(_stage, mine, x, 2, mesh) ** 2).mean()
    value.backward()
    whole = {k: v.clone().requires_grad_() for k, v in stacked.items()}
    h = x
    for i in range(n):
        h = _stage({k: v[i] for k, v in whole.items()}, h)
    ref = (h ** 2).mean()
    ref.backward()
    s = mesh.axis_index("pp")
    diffs = [_close("pp value", value, ref, rtol=1e-5, atol=1e-6)]
    diffs += [_close(f"pp grad {k}", mine[k].grad[0], whole[k].grad[s],
                     rtol=1e-4, atol=1e-5) for k in mine]
    return {"stages": n, "value": float(value.detach()),
            "ref": float(ref.detach()),
            "max_abs_diff": max(diffs)}


def _dryrun_sp_ring(dev):
    """Ring attention with the flash kernels per block over every rank
    (GQA: K/V carry half the query heads), forward and backward, against
    dense attention of the whole sequence on this device."""
    n = basics.size()
    mesh = make_parallel_mesh(sp=n)
    b, s, h, h_kv, d = 1, 8 * n, 2, 1, 8
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, heads, d)).astype(
        np.float32)).to(dev) for heads in (h, h_kv, h_kv))
    j, shard = mesh.axis_index("sp") * (s // n), s // n
    leaves = [t[:, j:j + shard].clone().requires_grad_() for t in (q, k, v)]
    o = ring_attention(*leaves, mesh=mesh, causal=True, use_flash=True)
    share = (o.float() ** 2).sum() / o.numel() / n
    share.backward()
    value = float(C.allreduce(share.detach(), op=C.Sum,
                              process_set=mesh.process_set("sp")))

    whole = [t.clone().requires_grad_() for t in (q, k, v)]
    kr, vr = (t.repeat_interleave(h // h_kv, dim=2) for t in whole[1:])
    scores = torch.einsum("bqhd,bkhd->bhqk", whole[0], kr) * d ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    p = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)
    ref = (torch.einsum("bhqk,bkhd->bqhd", p, vr) ** 2).mean()
    ref.backward()
    diffs = [_close("sp-ring value", value, ref, rtol=1e-5, atol=0)]
    diffs += [_close(f"sp-ring grad {name}", leaf.grad,
                     w.grad[:, j:j + shard], rtol=1e-4, atol=1e-5)
              for name, leaf, w in zip("qkv", leaves, whole)]
    return {"shape": [b, s, h, h_kv, d], "value": value,
            "ref": float(ref.detach()),
            "max_abs_diff": max(diffs)}


def _dryrun_hier(dev):
    """A training step whose gradient is averaged by the hierarchical
    allreduce (reduce-scatter over the host, allreduce across hosts,
    allgather over the host) equals the full-batch step."""
    n = basics.size()
    dim = 16
    rs = np.random.RandomState(3)
    w, x, y = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rs.randn(dim, dim), rs.randn(n * 2, dim), rs.randn(n * 2, dim)))

    def grad_of(xb, yb):
        leaf = w.clone().requires_grad_()
        ((xb @ leaf - yb) ** 2).mean().backward()
        return leaf.grad

    r = basics.rank()
    g = grad_of(x[2 * r:2 * r + 2], y[2 * r:2 * r + 2])
    w1 = w - 0.1 * hierarchical_allreduce(g, average=True)
    ref = w - 0.1 * grad_of(x, y)
    return {"local_size": basics.local_size(),
            "cross_size": basics.cross_size(),
            "max_abs_diff": _close("hier", w1, ref, rtol=1e-5, atol=1e-6)}
