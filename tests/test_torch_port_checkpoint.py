"""horovod_tpu_torch.checkpoint (on torch.distributed.checkpoint) held
against the JAX package's ``checkpoint.py`` (on orbax).

- Bookkeeping: the cases of tests/test_checkpoint.py (retention, interval,
  empty latest, async then wait) and a few more, each driven through both
  managers with the same calls: the same return values, ``all_steps()``
  and ``latest_step()``, and restored values equal to what was saved.
- Resume: a small GPT with AdamW saved at step 3, restored into a fresh
  model and optimizer and stepped to 6 gives the unbroken run's losses and
  parameters bit for bit; ``template=None`` gives the saved values back.
- A 2-process gloo job started by the port's launcher
  (tests/torch_port_launch_worker.py, no JAX): the same resume with the GPT
  sharded by ``shard_module`` and an async save, and broadcast on restore
  (each rank's read perturbed by its rank; with ``root_rank=1`` every rank
  ends with rank 1's values, without broadcast each keeps its own, and the
  sharded parameters load their own shards).
"""

import numpy as np
import pytest
import torch

import torch_port_launch_worker as W
from horovod_tpu_torch import checkpoint as tck
from horovod_tpu_torch.models import GPT, GPTConfig
from horovod_tpu_torch.train import loss_fn

pytest.importorskip("orbax.checkpoint")

import jax.numpy as jnp  # noqa: E402

from horovod_tpu import checkpoint as jck  # noqa: E402


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckgang")
    g = W.Launch(2, "checkpoint", str(root / "res"), {"dir": str(root)})
    yield g
    g.kill()


def _arrays(seed):
    rs = np.random.RandomState(seed)
    return {"w": rs.randn(4, 3).astype(np.float32),
            "b": rs.randn(3).astype(np.float32)}


def _jax_state(seed):
    a = _arrays(seed)
    return {"params": {k: jnp.asarray(v) for k, v in a.items()},
            "step": jnp.asarray(7)}


def _torch_state(seed):
    a = _arrays(seed)
    return {"params": {k: torch.from_numpy(v) for k, v in a.items()},
            "step": 7}


def _values(state):
    return {k: np.asarray(v) for k, v in state["params"].items()}


def _drive(mod, state_fn, root, script, **kw):
    """Run ``script`` (a list of ("save", step, force) / ("wait",) /
    ("restore", step) / ("restore_latest",) / ("reopen",)) against a
    manager of ``mod``; the log of return values and bookkeeping."""
    mgr = mod.CheckpointManager(str(root), **kw)
    log = []
    try:
        for op, *args in script:
            if op == "save":
                step, force = args
                try:
                    out = mgr.save(step, state_fn(step), force=force)
                except ValueError:
                    out = "raises"
            elif op == "wait":
                out = mgr.wait()
            elif op == "reopen":
                mgr.close()
                mgr = mod.CheckpointManager(str(root), **kw)
                out = None
            else:
                step = args[0] if args else mgr.latest_step()
                fn = (mgr.restore_latest if op == "restore_latest"
                      else lambda template: mgr.restore(step, template))
                got = fn(template=state_fn(0))
                out = None if got is None else \
                    all(np.array_equal(_values(got)[k], v)
                        for k, v in _arrays(step).items())
            log.append((op, out, mgr.all_steps(), mgr.latest_step()))
    finally:
        mgr.close()
    return log


SCRIPTS = {
    # tests/test_checkpoint.py's cases
    "retention": (dict(max_to_keep=2, async_save=False),
                  [("save", 1, False), ("save", 2, False), ("save", 3, False),
                   ("wait",), ("restore_latest",)]),
    "interval": (dict(max_to_keep=5, save_interval_steps=2,
                      async_save=False),
                 [("save", 0, False), ("save", 1, False), ("save", 2, False),
                  ("save", 3, True)]),
    "empty_latest": (dict(async_save=False), [("restore_latest",)]),
    "async_then_wait": (dict(async_save=True),
                        [("save", 5, False), ("wait",), ("restore", 5)]),
    # more of the rules: the first save passes any interval, an older step
    # is skipped, a forced save of an existing step raises, and a manager
    # reopened on the directory finds its steps
    "first_and_older": (dict(save_interval_steps=4, async_save=False),
                        [("save", 3, False), ("save", 2, False),
                         ("save", 3, True), ("save", 4, False),
                         ("save", 6, False), ("save", 8, False)]),
    "async_retention_reopen": (dict(max_to_keep=2, async_save=True),
                               [("save", 1, False), ("save", 2, False),
                                ("save", 3, False), ("wait",), ("reopen",),
                                ("restore", 2), ("save", 4, False),
                                ("wait",)]),
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_bookkeeping_matches_the_jax_manager(tmp_path, case):
    kw, script = SCRIPTS[case]
    want = _drive(jck, _jax_state, tmp_path / "jax", script, **kw)
    got = _drive(tck, _torch_state, tmp_path / "torch", script, **kw)
    assert got == want


def test_one_shot_save_and_restore_round_trip(tmp_path):
    state = {**_torch_state(1), "arr": np.arange(5.0), "name": "run"}
    tck.save(str(tmp_path / "ckpt"), state)
    tck.save(str(tmp_path / "ckpt"), state)     # replaces what is there
    got = tck.restore(str(tmp_path / "ckpt"),
                      template={**_torch_state(0), "arr": np.zeros(5),
                                "name": ""})
    jck.save(str(tmp_path / "jax"), _jax_state(1))
    want = jck.restore(str(tmp_path / "jax"), template=_jax_state(0))
    for k in ("w", "b"):
        assert np.array_equal(got["params"][k].numpy(),
                              np.asarray(want["params"][k]))
    assert got["step"] == int(want["step"]) == 7
    assert isinstance(got["arr"], np.ndarray)
    assert np.array_equal(got["arr"], np.arange(5.0))
    assert got["name"] == "run"


def test_checkpoint_group_is_made_once_per_world(tmp_path):
    """``torch.distributed`` started without ``hvt.init``: every save and
    restore of one world shares one gloo group, and a new world makes its
    own."""
    import torch.distributed as dist

    groups = []
    for world in range(2):
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp_path}/store{world}", rank=0,
            world_size=1)
        try:
            mgr = tck.CheckpointManager(str(tmp_path / f"ckpt{world}"))
            mgr.save(1, _torch_state(1))
            mgr.wait()
            got = tck.restore(str(tmp_path / f"ckpt{world}" / "1"),
                              template=_torch_state(0))
            assert np.array_equal(got["params"]["w"].numpy(),
                                  _arrays(1)["w"])
            groups.append(tck._group())
            assert tck._group() is groups[-1]
        finally:
            dist.destroy_process_group()
    assert groups[0] is not groups[1]


CFG = dict(vocab_size=64, n_layers=2, d_model=32, n_heads=2, d_ff=64,
           max_seq_len=16)


def _gpt(seed):
    model = GPT(GPTConfig(**CFG, dtype=torch.float32), device="cpu",
                seed=seed)
    return model, torch.optim.AdamW(model.parameters(), lr=1e-2,
                                    weight_decay=1e-4)


def _steps(model, opt, tokens, n):
    losses = []
    for _ in range(n):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses


def test_resumed_gpt_is_bit_identical_to_the_unbroken_run(tmp_path):
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 64,
                                                               (2, 16)))
    model, opt = _gpt(0)
    mgr = tck.CheckpointManager(str(tmp_path), max_to_keep=2)
    unbroken = _steps(model, opt, tokens, 3)
    assert mgr.save(3, {"model": model, "optim": opt, "step": 3})
    unbroken += _steps(model, opt, tokens, 3)
    mgr.wait()
    fresh, fresh_opt = _gpt(1)
    state = mgr.restore_latest({"model": fresh, "optim": fresh_opt,
                                "step": 0})
    assert state["model"] is fresh and state["step"] == 3
    resumed = _steps(fresh, fresh_opt, tokens, 3)
    assert resumed == unbroken[3:]
    for (name, a), b in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), name

    # without a template: the saved tensors and values, on the CPU
    raw = mgr.restore(3)
    assert raw["step"] == 3 and sorted(raw["optim"]) == ["param_groups",
                                                         "state"]
    first, _ = _gpt(0)
    _steps(first, torch.optim.AdamW(first.parameters(), lr=1e-2,
                                    weight_decay=1e-4), tokens, 3)
    for name, p in first.named_parameters():
        assert torch.equal(raw["model"][name], p.detach()), name
    mgr.close()


def test_an_optimizer_needs_its_module(tmp_path):
    model, opt = _gpt(0)
    with pytest.raises(ValueError, match="module"):
        tck.save(str(tmp_path / "x"), {"optim": opt})


def test_sharded_resume_is_bit_identical_on_the_gang(gang):
    for res in gang.results():
        assert res["saved"] and res["steps"] == [W.CKPT_AT]
        assert res["resumed"] == res["unbroken"][W.CKPT_AT:]
        assert res["restored_step"] == W.CKPT_AT
        assert torch.equal(res["restored_extra"], torch.full((3,), 1.5))


def test_broadcast_on_restore_on_the_gang(gang):
    results = gang.results()
    for r, res in enumerate(results):
        # rank 1 read step + 10 and extra + 1; the broadcast spreads it
        assert res["bcast"]["step"] == W.CKPT_AT + 10
        assert torch.equal(res["bcast"]["extra"], torch.full((3,), 2.5))
        assert res["local"]["step"] == W.CKPT_AT + 10 * r
        assert torch.equal(res["local"]["extra"],
                           torch.full((3,), 1.5 + r))
    # the sharded parameters were not broadcast: each rank holds its own
    # shard of the saved model, which together are the whole
    for name, whole in results[0]["restored_full"].items():
        if name in results[0]["sharded_local"]:
            parts = torch.cat([res["sharded_local"][name]
                               for res in results],
                              dim=_shard_dim(whole, results, name))
            assert torch.equal(parts, whole), name


def _shard_dim(whole, results, name):
    local = results[0]["sharded_local"][name].shape
    return next(i for i, (a, b) in enumerate(zip(local, whole.shape))
                if a != b)


def test_restore_without_template_on_the_gang(gang):
    for res in gang.results():
        raw = res["raw"]
        assert raw["step"] == W.CKPT_AT and raw["optim_keys"] == [
            "param_groups", "state"]
        assert torch.equal(raw["extra"], torch.full((3,), 1.5))
        for name, p in res["restored_full"].items():
            assert torch.equal(raw["model"][name], p), name
