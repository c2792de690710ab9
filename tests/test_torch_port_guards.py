"""Guards on horovod_tpu_torch's boundaries: it imports nothing of JAX or of
the JAX package, imports without jax or triton installed, runs on CUDA by
default and raises without it, and chip_smoke.py refuses to run without a
GPU or without the package beside it."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

import horovod_tpu_torch as hvt
from horovod_tpu_torch.models import GPT, GPTConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "horovod_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "horovod_tpu"}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PACKAGE):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_nothing_of_jax_or_the_jax_package():
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            offenders += [f"{os.path.relpath(path, REPO)}: {m}" for m in mods
                          if m.split(".")[0] in FORBIDDEN]
    assert len(_port_files()) > 10
    assert not offenders, offenders


def test_imports_with_jax_and_triton_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'triton', "
            "'horovod_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import horovod_tpu_torch, horovod_tpu_torch.train, "
            "horovod_tpu_torch.models.convert, horovod_tpu_torch.ops._kernels, "
            "horovod_tpu_torch.models.moe, horovod_tpu_torch.dryrun, "
            "horovod_tpu_torch.parallel.mesh, "
            "horovod_tpu_torch.parallel.primitives, "
            "horovod_tpu_torch.parallel.sequence, "
            "horovod_tpu_torch.parallel.pipeline, "
            "horovod_tpu_torch.parallel.fsdp, horovod_tpu_torch.checkpoint, "
            "horovod_tpu_torch.callbacks, horovod_tpu_torch.runner.launch, "
            "horovod_tpu_torch.runner.config_parser, "
            "horovod_tpu_torch.elastic, horovod_tpu_torch.elastic.run, "
            "horovod_tpu_torch.elastic.preemption, "
            "horovod_tpu_torch.runner.http_server, "
            "horovod_tpu_torch.runner.http_client, "
            "horovod_tpu_torch.runner.elastic.driver, "
            "horovod_tpu_torch.runner.elastic.notification, "
            "horovod_tpu_torch.metrics, "
            "horovod_tpu_torch.metrics.exposition, "
            "horovod_tpu_torch.metrics.merge, "
            "horovod_tpu_torch.metrics.registry, "
            "horovod_tpu_torch.utils.timeline\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig(vocab_size=64, n_layers=1, d_model=32, n_heads=2,
                    d_ff=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPT(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        hvt.init()
    assert not hvt.is_initialized()
    assert GPT(cfg, device="cpu").embedding.device.type == "cpu"


@pytest.mark.parametrize("alone", [False, True], ids=["no-gpu", "alone"])
def test_chip_smoke_fails_without_gpu_or_package(tmp_path, alone):
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
