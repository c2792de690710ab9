"""The port's benchmark harness (horovod_tpu_torch/bench.py) on the CPU, at
a tiny size: what it computes and what it prints. It measures nothing here
(times of CPU kernels are not the card's); graph capture is a CUDA feature,
so only the eager steps run.

- measure_gpt's steps are train.train's: the same model, optimizer and
  tokens from the same seed give the same losses (exactly), with and
  without the chunked cross-entropy (rtol 1e-5 between the two: fp32 sums
  in another order).
- measure's first loss is the cross-entropy of the seeded model on the
  seeded images (exact), and the JSON record has bench.py's keys.
- _sane_rates gives bench.py's answers; the peak is looked up from the
  card's name; without a card the harness raises unless asked for the
  CPU.
"""

import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu_torch import bench
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models import GPTConfig
from horovod_tpu_torch.models.resnet import ResNet50
from horovod_tpu_torch.train import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = GPTConfig(vocab_size=64, n_layers=2, d_model=32, n_heads=2, d_ff=64,
                 max_seq_len=16, dtype=torch.float32)
RECORD_KEYS = {"metric", "value", "unit", "config", "vs_baseline", "mfu",
               "mfu_vs_peak", "peak_tflops", "suspect", "calib_tflops",
               "calib_spread", "achieved_tflops", "n_params", "card",
               "eager"}


@pytest.fixture()
def world():
    yield
    basics.shutdown()


def test_measure_gpt_steps_are_train_steps(world):
    got = bench.measure_gpt(2, 1, 2, "fp32", 16, device="cpu", cfg=TINY)
    assert got["replayed"] is None
    assert got["run"]().shape == ()     # one more eager step
    eager = got["eager"]
    assert len(eager["losses"]) == 4 and len(eager["rates"]) == 1
    basics.shutdown()
    want = train(TINY, 4, 2, 16, device="cpu")["loss"]
    assert eager["losses"] == want
    n = got["n_params"]
    assert got["flops_per_item"] == 6 * n + 12 * 2 * 32 * 16
    assert got["items_per_step"] == 2 * 16
    basics.shutdown()
    chunked = bench.measure_gpt(2, 1, 2, "fp32", 16, chunked_ce=True,
                                device="cpu", cfg=TINY)
    np.testing.assert_allclose(chunked["eager"]["losses"], want, rtol=1e-5)


def test_gpt_record_has_bench_keys(world):
    result = bench.measure_gpt(2, 2, 1, "fp32", 16, device="cpu", cfg=TINY)
    args = types.SimpleNamespace(model="gpt", fp32=True, batch_size=2,
                                 num_batches_per_iter=1, seq_len=16,
                                 flash=False, chunked_ce=False,
                                 n_kv_heads=None)
    record = bench.make_record(args, result, [], None)
    assert RECORD_KEYS <= set(record) and "replayed" not in record
    assert record["metric"] == "gpt_synthetic_tok_sec_per_chip"
    assert record["unit"] == "tok/sec/chip"
    assert record["config"]["platform"] == "cpu"
    assert record["config"]["graph"] is False
    assert record["value"] == round(record["eager"]["tok_sec_per_chip"], 2)
    assert record["mfu"] is None and record["mfu_vs_peak"] is None
    assert record["flops_per_tok"] == round(result["flops_per_item"] / 1e9,
                                            3)
    json.dumps(record)


def test_vision_harness_prints_one_record(world, capsys):
    argv = ["--model", "resnet50", "--device", "cpu", "--image-size", "32",
            "--batch-size", "2", "--num-iters", "1",
            "--num-batches-per-iter", "1"]
    record = bench.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(record))
    assert lines[0].startswith("# eager:")
    assert RECORD_KEYS <= set(record)
    assert record["metric"] == "resnet50_synthetic_img_sec_per_chip"
    assert record["config"] == {
        "harness": bench.HARNESS_VERSION, "model": "resnet50",
        "dtype": "bf16", "batch_per_chip": 2, "steps_per_iter": 1,
        "chips": 1, "platform": "cpu", "graph": False, "image_size": 32,
        "bn_impl": "tpu", "conv0_s2d": False}
    assert record["n_params"] == 25557032
    # the first step's loss is the seeded model's on the seeded images
    images, labels = bench.synthetic_images(2, 32)
    model = ResNet50(device="cpu", seed=0)
    x = torch.from_numpy(images).permute(0, 3, 1, 2).to(torch.bfloat16)
    want = float(F.cross_entropy(model(x), torch.from_numpy(labels)).detach())
    assert record["eager"]["losses"][0] == want
    assert all(np.isfinite(record["eager"]["losses"]))


def test_measure_defaults_to_cuda_and_raises_without_it(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.measure_gpt(2, 1, 1, cfg=TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--model", "vgg16"])


def test_capture_needs_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        bench.capture_step(lambda t: t, torch.zeros(2), torch.nn.Linear(2, 2),
                           None)


@pytest.mark.parametrize("rates,flops,n", [
    ([100.0, 110.0, 1e9], None, 1), ([2e6, 3e6], 1e9, 1),
    ([10.0, 2e6], 1e9, 1), ([10.0, 2e6], 1e9, 4), ([5.0, 6.0], 1e12, 1)])
def test_sane_rates_as_bench_py(rates, flops, n):
    """The port's copy of the guard gives bench.py's answers."""
    spec = importlib.util.spec_from_file_location(
        "repo_bench", os.path.join(REPO, "bench.py"))
    reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reference)
    assert bench._sane_rates(list(rates), flops, n) == \
        reference._sane_rates(list(rates), flops, n)


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989.0), ("NVIDIA H100 PCIe", 756.0),
    ("NVIDIA H100 NVL", 835.0), ("NVIDIA A100-SXM4-80GB", None)])
def test_peak_from_the_card_name(name, peak):
    assert bench.peak_bf16_tflops(name) == peak
