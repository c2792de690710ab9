"""Every example of ``examples/torch_port/`` at smoke scale on the CPU,
through the port's launcher (``tests/test_examples.py:93-128`` for the JAX
package's): the jobs start together in one module fixture and each test
reads its job's output. The Ray and Spark examples are skipped where their
packages are absent, as the JAX package's tests skip them."""

import ast
import glob
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "torch_port")

JOBS = {
    "synthetic": (["-np", "2"], "pytorch_synthetic_benchmark.py",
                  ["--batch-size", "4", "--num-iters", "1",
                   "--num-batches-per-iter", "2"]),
    "resnet50": (["-np", "2"], "pytorch_imagenet_resnet50.py",
                 ["--width", "8", "--image-size", "32", "--batch-size", "4",
                  "--epochs", "1", "--steps-per-epoch", "2",
                  "--batches-per-allreduce", "2"]),
    "elastic": (["-np", "2", "--min-np", "2", "--max-np", "3"],
                "pytorch_elastic_train.py",
                ["--epochs", "3", "--batches-per-epoch", "2"]),
    "gpt": (["-np", "4"], "gpt_train.py",
            ["--tp", "2", "--sp", "2", "--steps", "2", "--batch", "2",
             "--seq", "16", "--layers", "1", "--d-model", "32", "--heads",
             "4", "--vocab", "64"]),
    "long_context": (["-np", "2"], "long_context_train.py",
                     ["--seq", "64", "--heads", "4", "--kv-heads", "2",
                      "--head-dim", "16", "--steps", "3"]),
    "long_context_plain": (["-np", "2"], "long_context_train.py",
                           ["--seq", "64", "--heads", "4", "--kv-heads", "2",
                            "--head-dim", "16", "--steps", "3",
                            "--no-flash"]),
    "adasum": (["-np", "2"], "adasum_train.py", []),
}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """Each job's (log, exit code); under "attention" the attention reports
    of the long_context jobs."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    reports = tmp_path_factory.mktemp("attention")
    procs, attention = {}, {}
    for key, (launch, script, args) in JOBS.items():
        if key.startswith("long_context"):
            attention[key] = str(reports / f"{key}.pt")
            args = args + ["--attention-report", attention[key]]
        procs[key] = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
             *launch, "--master-port", str(_free_port()), sys.executable,
             os.path.join(EXAMPLES, script), *args, "--device", "cpu"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    out = {"attention": attention}
    try:
        for key, p in procs.items():
            out[key] = (p.communicate(timeout=300)[0], p.returncode)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _ok(outputs, key):
    log, rc = outputs[key]
    assert rc == 0, log[-3000:]
    return log


def test_synthetic_benchmark(outputs):
    assert "Total img/sec on 2 proc(s)" in _ok(outputs, "synthetic")


def test_imagenet_resnet50_fp16_grouped_accumulated(outputs):
    assert "img/sec total" in _ok(outputs, "resnet50")


def test_elastic_train(outputs):
    assert "done: epochs=3" in _ok(outputs, "elastic")


def test_gpt_on_a_tp_sp_mesh(outputs):
    log = _ok(outputs, "gpt")
    assert "step 0: loss" in log and "step 1: loss" in log


def test_long_context_ring_with_gqa(outputs):
    assert "heads=4/2 kv" in _ok(outputs, "long_context")


def test_long_context_flash_blocks_match_einsum_blocks(outputs):
    """The flash blocks (their plain versions on the CPU) and the einsum
    blocks give the same attention output and Q/K/V gradients on the
    first batch, in fp32."""
    import torch

    assert "flash=off" in _ok(outputs, "long_context_plain")
    _ok(outputs, "long_context")
    flash, plain = (torch.load(outputs["attention"][key]) for key in
                    ("long_context", "long_context_plain"))
    assert sorted(flash) == ["dk", "dq", "dv", "o"]
    for name in flash:
        torch.testing.assert_close(flash[name], plain[name], rtol=1e-4,
                                   atol=1e-5)


def test_adasum_converges(outputs):
    assert "step  199" in _ok(outputs, "adasum")


def test_ray_example():
    pytest.importorskip("ray")
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "ray_train.py"), "--device",
         "cpu"], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("script", ["spark_train.py", "spark_estimator.py"])
def test_spark_examples(script):
    pytest.importorskip("pyspark")
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, script), "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_examples_import_only_the_port():
    scripts = sorted(glob.glob(os.path.join(EXAMPLES, "*.py")))
    assert len(scripts) == 9
    for path in scripts:
        with open(path) as f:
            tree = ast.parse(f.read())
        names = [a.name for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "flax", "optax", "horovod_tpu"), \
                (path, name)
        assert any(n.split(".")[0] == "horovod_tpu_torch" for n in names) \
            or "horovod_tpu_torch" in open(path).read(), path
