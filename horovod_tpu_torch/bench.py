"""The port's benchmark harness: ``bench.py``'s ``measure_gpt`` and
``measure`` (synthetic data, data-parallel training throughput) on PyTorch
and CUDA, with the same flags and the same one-line JSON record.

    python -m horovod_tpu_torch.bench --model gpt --flash [--chunked-ce]
    python -m horovod_tpu_torch.bench --model resnet50 [--bn-impl flax]

It runs on CUDA, one process per card (start n processes through the
``HVT_*`` identity env for n cards; rank 0 prints), or on the CPU with
``--device cpu`` (a check of the harness, not a measurement).

- ``--model gpt``: the bench GPT (vocab 32768, 12 × 768, 12 heads, d_ff
  3072, seq 1024, batch 8 a card) under ``DistributedOptimizer(AdamW(1e-4,
  weight decay 1e-4))`` on seeded tokens. A timed block is
  ``--num-batches-per-iter`` steps ending in a readback of the loss. The
  JAX bench compiles a block into one program so that its host issues once
  a block; the counterpart here is the whole step (forward, loss, backward,
  the optimizer's reduction and update) captured once in a CUDA graph and
  replayed, in a world of one process on CUDA (:func:`capture_step`). The
  record gives both: the eager steps' rate and the replayed steps' rate,
  which is ``value``. A capture that fails raises. Over several processes
  the reduction is NCCL's, which is not captured, and only the eager rate
  is measured. ``bench.py --unroll`` unrolls XLA's loop of a block; nothing
  here corresponds to it, so it is not a flag.
- ``--model resnet50|resnet101|resnet152|vgg16|inception_v3``: the vision
  models on seeded images and labels under
  ``DistributedOptimizer(SGD(0.01, momentum 0.9))``, eager, channels-last on
  the card; with more than one process the batch norm statistics are those
  of the global batch (``TpuBatchNorm`` over the world for ``--bn-impl
  tpu``, ``SyncBatchNorm`` for ``flax``), as under the JAX bench's pjit.

MFU: ``mfu`` divides the achieved FLOP/s by the card's measured bf16
``torch.matmul`` rate (:func:`calibrate_matmul_tflops`, before and after
the measurement), ``mfu_vs_peak`` by the card's published dense bf16 peak,
looked up from its name (:func:`peak_bf16_tflops`).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from horovod_tpu_torch import metrics
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.process_sets import global_process_set
from horovod_tpu_torch.models.resnet import ResNet50, ResNet101, ResNet152
from horovod_tpu_torch.models.transformer import GPT, GPTConfig
from horovod_tpu_torch.models.vision import VGG16, InceptionV3
from horovod_tpu_torch.optimizer import DistributedOptimizer
from horovod_tpu_torch.train import make_train_step, seeded_tokens

HARNESS_VERSION = "torch-r1"
# the reference Horovod's only published absolute rate: ResNet-101 at
# 1656.82 img/s on 16 GPUs (bench.py's BASELINE_IMG_SEC_PER_DEVICE)
BASELINE_IMG_SEC_PER_DEVICE = 1656.82 / 16.0
# training FLOPs per image (3 × the forward's 2 × MACs) at the native
# resolution, scaled by (size / native)² (bench.py:80-85)
FLOPS_PER_IMG = {"resnet50": 12.3e9, "resnet101": 23.4e9,
                 "resnet152": 34.5e9, "vgg16": 46.5e9,
                 "inception_v3": 17.1e9}
NATIVE_IMG_SIZE = {"resnet50": 224, "resnet101": 224, "resnet152": 224,
                   "vgg16": 224, "inception_v3": 299}
VISION_MODELS = {"resnet50": ResNet50, "resnet101": ResNet101,
                 "resnet152": ResNet152, "vgg16": VGG16,
                 "inception_v3": InceptionV3}
# per-card batch defaults (bench.py:588-593)
DEFAULT_BATCH = {"gpt": 8, "vgg16": 64, "inception_v3": 128}
# the bench GPT (bench.py:200-202); seq and K/V heads are flags
GPT_BENCH = dict(vocab_size=32768, n_layers=12, d_model=768, n_heads=12,
                 d_ff=3072)
# The H100's dense bf16 tensor-core peaks in TFLOP/s (NVIDIA's data sheet,
# without sparsity), by the words of the card's name that tell the part
# apart; the first match counts. nvidia-smi names the SXM part "NVIDIA H100
# 80GB HBM3".
PEAK_BF16_TFLOPS = ((("H100", "PCIe"), 756.0), (("H100", "NVL"), 835.0),
                    (("H100",), 989.0))
CAPTURE_WARMUP_STEPS = 3
NUM_CLASSES = 1000


def peak_bf16_tflops(card_name):
    """The published dense bf16 peak of the card ``card_name`` names, or
    None for a card not in :data:`PEAK_BF16_TFLOPS`."""
    for words, tflops in PEAK_BF16_TFLOPS:
        if all(w in card_name for w in words):
            return tflops
    return None


def card_info():
    """The card's torch name and the first card's line of ``nvidia-smi
    --query-gpu=name,power.limit`` (name and power limit)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"kind": torch.cuda.get_device_name(), "nvidia_smi": smi,
            "count": torch.cuda.device_count()}


def _sane_rates(rates, flops_per_item=None, n_chips=1):
    """Drop timing iters that are physically implausible (bench.py:100-138):
    an absolute bound (more than 1000 TFLOP/s a card when
    ``flops_per_item`` is known; rates are job-wide, so the bound scales by
    ``n_chips``), then a cut at 50 × the median. Returns ``(rates,
    suspect)``; ``suspect`` is True when every iter broke the absolute
    bound, and the record built from them is then not a measurement."""
    n0 = len(rates)
    if flops_per_item:
        cap = 1000e12 * max(1, n_chips)
        plausible = [r for r in rates if r * flops_per_item <= cap]
        if not plausible:
            print("# WARNING: every timing iter implies >1000 TFLOP/s/"
                  "chip; this record is NOT a measurement", file=sys.stderr)
            return rates, True
        rates = plausible
    med = float(np.median(rates))
    sane = [r for r in rates if r <= 50 * med]
    if len(sane) != n0:
        print(f"# dropped {n0 - len(sane)} implausible timing iter(s) "
              f"(absolute 1000-TFLOP/s/chip bound / >50x median "
              f"{med:.1f})", file=sys.stderr)
    return sane or rates, False


def calibrate_matmul_tflops(device, m=8192, k_steps=8, reps=3):
    """The card's bf16 matmul rate through this harness
    (``calibrate_matmul_tflops``, bench.py:141-177): a chain of
    ``k_steps`` dependent ``[m, m]`` products timed on the host clock up to
    a readback, median of ``reps``."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(m, m, generator=gen).to(device, torch.bfloat16)
    w = (torch.randn(m, m, generator=gen) / m ** 0.5).to(device,
                                                         torch.bfloat16)

    def chain():
        h = x
        for _ in range(k_steps):
            h = h @ w
        return float(h.float().sum())

    chain()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        chain()
        samples.append(k_steps * 2 * m ** 3 / (time.perf_counter() - t0)
                       / 1e12)
    return float(np.median(samples))


def capture_step(step, tokens, model, optimizer,
                 warmup=CAPTURE_WARMUP_STEPS):
    """Capture ``step(tokens)`` (zero_grad, forward, loss, backward,
    ``optimizer.step()``) in a CUDA graph, as PyTorch's whole-network
    recipe does: ``warmup`` steps on a side stream make the gradients and
    the optimizer state, then the model's parameters and buffers and the
    optimizer's state are put back as they were before them (state a fresh
    optimizer had not made yet is zeroed, which is what it starts from),
    and the step is captured with its gradients in the graph's pool. The
    optimizer must be capturable (AdamW's ``capturable=True``). Returns
    ``replay()``, which runs one step and returns a copy of its loss; the
    first replay is the step from the weights ``model`` had. Raises if the
    capture fails."""
    if tokens.device.type != "cuda":
        raise ValueError("a CUDA graph needs CUDA tensors")
    held = [*model.parameters(), *model.buffers()]
    saved = [t.detach().clone() for t in held]
    state = {(p, k): v.clone() for p, s in optimizer.state.items()
             for k, v in s.items() if torch.is_tensor(v)}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            step(tokens)
    torch.cuda.current_stream().wait_stream(side)
    with torch.no_grad():
        for t, s in zip(held, saved):
            t.copy_(s)
        for p, s in optimizer.state.items():
            for k, v in s.items():
                if torch.is_tensor(v):
                    v.copy_(state[p, k]) if (p, k) in state else v.zero_()
    optimizer.zero_grad(set_to_none=True)
    graph = torch.cuda.CUDAGraph()
    # thread-local: the drainer thread may still query the CUDA events of
    # the warm-up steps' collectives, which a global-mode capture forbids
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        loss = step(tokens)

    def replay():
        graph.replay()
        return loss.clone()

    # the graph reads and writes these tensors' memory at every replay: they
    # must live as long as it does
    replay.graph, replay.held = graph, (step, tokens, model, optimizer)
    return replay


def _timed_blocks(run, num_iters, steps_per_iter, items_per_step):
    """One warm-up block, then ``num_iters`` timed blocks of
    ``steps_per_iter`` calls of ``run()``, each block ending in a readback
    of its last loss (the JAX bench's forced readback). Returns (items/s
    of each timed block, every step's loss, step seconds of each block)."""
    losses, rates, step_s = [], [], []
    for i in range(num_iters + 1):
        t0 = time.perf_counter()
        block = [run() for _ in range(steps_per_iter)]
        float(block[-1])
        dt = time.perf_counter() - t0
        if i:
            rates.append(items_per_step * steps_per_iter / dt)
            step_s.append(dt / steps_per_iter)
        losses += [float(x) for x in block]
    return rates, losses, step_s


def _reset_peak(device):
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _phase(run, num_iters, steps_per_iter, items_per_step, device):
    """The timed blocks of ``run`` and the peak memory since the last
    :func:`_reset_peak`."""
    rates, losses, step_s = _timed_blocks(run, num_iters, steps_per_iter,
                                          items_per_step)
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else None)
    return {"rates": rates, "losses": losses, "step_s": step_s,
            "step_ms_median": float(np.median(step_s)) * 1e3,
            "max_memory_allocated_bytes": peak}


def measure_gpt(per_chip_batch, num_iters, num_batches_per_iter,
                dtype_name="bf16", seq_len=1024, use_flash=False,
                chunked_ce=False, n_kv_heads=None, *, device=None, cfg=None):
    """GPT training throughput (tokens/s), eager and, in a world of one
    process on CUDA, replayed from a CUDA graph. Each run builds the model
    from seed 0, so both start from the same weights: step i of one is
    step i of the other. ``cfg`` replaces the bench GPT (a small model
    for tests). FLOPs a token: 6 N + 12 · L · d_model · seq.

    Returns a dict: ``eager`` and ``replayed`` (None when not captured),
    each with the items/s of every timed block (``rates``), every step's
    loss, step times and peak memory (of building the model, the capture
    with its warm-up steps and the steps); ``run``, which runs one more
    step the last way measured (the graph's replay when there is one);
    ``flops_per_item``, ``items_per_step`` and ``n_params``."""
    basics.init(device=device)
    dev = basics.device()
    dtype = torch.float32 if dtype_name == "fp32" else torch.bfloat16
    cfg = cfg or GPTConfig(**GPT_BENCH, n_kv_heads=n_kv_heads,
                           max_seq_len=seq_len, dtype=dtype,
                           use_flash=use_flash)
    graph = dev.type == "cuda" and basics.size() == 1
    tokens = seeded_tokens(cfg, per_chip_batch, seq_len, seed=0)

    def build():
        model = GPT(cfg, device=dev, seed=0)
        opt = DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=1e-4, weight_decay=1e-4,
            capturable=graph))
        return model, opt, make_train_step(model, opt, chunked_ce)

    items = per_chip_batch * seq_len * basics.size()
    _reset_peak(dev)
    model, _, step = build()
    n_params = sum(p.numel() for p in model.parameters())

    def run():
        return step(tokens)

    eager = _phase(run, num_iters, num_batches_per_iter, items, dev)
    replayed = None
    if graph:
        del model, step, run
        torch.cuda.empty_cache()
        _reset_peak(dev)     # the peak covers the capture's warm-up steps
        model, opt, step = build()
        run = capture_step(step, tokens, model, opt)
        replayed = _phase(run, num_iters, num_batches_per_iter, items, dev)
    return {"eager": eager, "replayed": replayed, "run": run,
            "items_per_step": items, "n_params": n_params,
            "flops_per_item": 6 * n_params
            + 12 * cfg.n_layers * cfg.d_model * seq_len}


def synthetic_images(global_batch, image_size, seed=0):
    """The JAX bench's images (NHWC normal draws) and labels of
    NUM_CLASSES classes from ``RandomState(seed)``, as numpy."""
    rng = np.random.RandomState(seed)
    images = rng.randn(global_batch, image_size, image_size, 3)
    return images, rng.randint(0, NUM_CLASSES, (global_batch,))


def measure(model_name, per_chip_batch, num_iters, num_batches_per_iter,
            dtype_name="bf16", image_size=None, norm_impl="tpu",
            conv0_s2d=False, *, device=None):
    """Vision training throughput (images/s), eager, on this process's
    rows of a global batch of seeded images. Returns a dict like
    :func:`measure_gpt`'s (``replayed`` None, ``run`` an eager step)."""
    basics.init(device=device)
    dev = basics.device()
    n = basics.size()
    dtype = torch.float32 if dtype_name == "fp32" else torch.bfloat16
    image_size = image_size or NATIVE_IMG_SIZE[model_name]
    extra = {}
    if model_name.startswith("resnet"):
        extra["conv0_space_to_depth"] = conv0_s2d
    elif model_name == "vgg16":
        extra["image_size"] = image_size
    synced = global_process_set if n > 1 else None
    model = VISION_MODELS[model_name](
        num_classes=NUM_CLASSES, dtype=dtype, norm_impl=norm_impl,
        process_set=synced, device=dev, seed=0, **extra)
    fmt = (torch.channels_last if dev.type == "cuda"
           else torch.contiguous_format)
    model.to(memory_format=fmt)
    images, labels = synthetic_images(per_chip_batch * n, image_size)
    rows = slice(basics.rank() * per_chip_batch,
                 (basics.rank() + 1) * per_chip_batch)
    images = torch.from_numpy(images[rows]).permute(0, 3, 1, 2).to(
        dev, dtype).contiguous(memory_format=fmt)
    labels = torch.from_numpy(labels[rows]).to(dev)
    optimizer = DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=0.01, momentum=0.9))

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(images), labels)
        loss.backward()
        optimizer.step()
        return loss.detach()

    _reset_peak(dev)
    result = _phase(step, num_iters, num_batches_per_iter,
                    per_chip_batch * n, dev)
    flops = FLOPS_PER_IMG[model_name] * (
        image_size / NATIVE_IMG_SIZE[model_name]) ** 2
    return {"eager": result, "replayed": None, "run": step,
            "items_per_step": per_chip_batch * n, "flops_per_item": flops,
            "n_params": sum(p.numel() for p in model.parameters()),
            "image_size": image_size}


def _rate(phase, flops_per_item, n):
    rates, suspect = _sane_rates(phase["rates"], flops_per_item, n)
    return float(np.mean(rates)), float(np.std(rates)), suspect


def make_record(args, result, calib_samples, card):
    """The one-line JSON record (bench.py's fields), from ``result`` of
    :func:`measure_gpt` or :func:`measure`. ``value`` is the replayed
    rate where there is one, else the eager rate, per card."""
    gpt = args.model == "gpt"
    unit = "tok" if gpt else "img"
    n = basics.size()
    flops = result["flops_per_item"]
    rates = {}
    for name in ("eager", "replayed"):
        if result[name] is not None:
            mean, std, suspect = _rate(result[name], flops, n)
            rates[name] = {f"{unit}_sec_per_chip": mean / n,
                           f"{unit}_sec": mean, f"{unit}_sec_std": std,
                           "suspect": suspect,
                           "step_ms_median": result[name]["step_ms_median"],
                           "max_memory_allocated_bytes":
                               result[name]["max_memory_allocated_bytes"],
                           "losses": result[name]["losses"]}
    headline = rates.get("replayed") or rates["eager"]
    per_chip = headline[f"{unit}_sec_per_chip"]
    calib = float(np.median(calib_samples)) if calib_samples else None
    achieved = per_chip * flops / 1e12
    peak = peak_bf16_tflops(card["kind"]) if card else None
    config = {"harness": HARNESS_VERSION, "model": args.model,
              "dtype": "fp32" if args.fp32 else "bf16",
              "batch_per_chip": args.batch_size,
              "steps_per_iter": args.num_batches_per_iter, "chips": n,
              "platform": "gpu" if card else "cpu",
              "graph": "replayed" in rates}
    if gpt:
        config.update(seq_len=args.seq_len, flash=bool(args.flash),
                      chunked_ce=bool(args.chunked_ce),
                      n_kv_heads=args.n_kv_heads)
    else:
        config.update(image_size=result["image_size"], bn_impl=args.bn_impl,
                      conv0_s2d=bool(args.conv0_s2d))
    return {
        "metric": f"{args.model}_synthetic_{unit}_sec_per_chip",
        "value": round(per_chip, 2), "unit": f"{unit}/sec/chip",
        "config": config,
        "vs_baseline": (None if gpt else
                        round(per_chip / BASELINE_IMG_SEC_PER_DEVICE, 3)),
        "mfu": round(achieved / calib, 4) if calib else None,
        "mfu_vs_peak": round(achieved / peak, 4) if peak else None,
        "peak_tflops": peak,
        "suspect": headline["suspect"],
        "calib_tflops": round(calib, 2) if calib else None,
        "calib_spread": ((max(calib_samples) - min(calib_samples)) / calib
                         if calib else None),
        "achieved_tflops": round(achieved, 3),
        f"flops_per_{unit}": round(flops / 1e9, 3),
        "n_params": result["n_params"],
        "card": card,
        **rates,
    }


def final_metrics(record):
    """The registry's JSON snapshot for the record's ``engine_metrics``
    (the JAX bench's): the allreduce of the last loss is a real dispatch,
    so the snapshot always holds an allreduce latency series; its CUDA
    events are resolved before the snapshot is taken."""
    from horovod_tpu_torch.ops.collective_ops import allreduce
    from horovod_tpu_torch.utils import timeline

    last = (record.get("replayed") or record["eager"])["losses"][-1]
    allreduce(torch.tensor(last, device=basics.device()),
              name="bench_final_loss")
    if not timeline.drainer.flush():
        raise RuntimeError("the CUDA events of collectives stayed "
                           "unresolved: no engine_metrics snapshot")
    return metrics.json_snapshot()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="resnet50",
                   choices=sorted(VISION_MODELS) + ["gpt"])
    p.add_argument("--n-kv-heads", type=int, default=None,
                   help="gpt: K/V head count (GQA; default 12, MHA)")
    p.add_argument("--seq-len", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=None,
                   help="per-card batch (default 8 for gpt, 64 for vgg16, "
                        "128 for inception_v3, 256 for resnet)")
    p.add_argument("--num-iters", type=int, default=5)
    p.add_argument("--num-batches-per-iter", type=int, default=32,
                   help="steps per timed block")
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--image-size", type=int, default=None,
                   help="square input size (default the model's native: "
                        "224, 299 for inception_v3)")
    p.add_argument("--flash", action="store_true",
                   help="gpt: the flash-attention kernels")
    p.add_argument("--chunked-ce", action="store_true",
                   help="gpt: sequence-chunked cross-entropy from the "
                        "hidden states (ops/losses.py)")
    p.add_argument("--conv0-s2d", action="store_true",
                   help="resnet: the space-to-depth stem")
    p.add_argument("--bn-impl", default="tpu", choices=["tpu", "flax"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu checks the harness; it measures nothing")
    args = p.parse_args(argv)
    if args.batch_size is None:
        args.batch_size = DEFAULT_BATCH.get(args.model, 256)
    dtype_name = "fp32" if args.fp32 else "bf16"
    basics.init(device=args.device)
    dev = basics.device()
    card = card_info() if dev.type == "cuda" else None
    calib = []
    if card:
        calib.append(calibrate_matmul_tflops(dev))
    if args.model == "gpt":
        result = measure_gpt(args.batch_size, args.num_iters,
                             args.num_batches_per_iter, dtype_name,
                             args.seq_len, use_flash=args.flash,
                             chunked_ce=args.chunked_ce,
                             n_kv_heads=args.n_kv_heads)
    else:
        result = measure(args.model, args.batch_size, args.num_iters,
                         args.num_batches_per_iter, dtype_name,
                         args.image_size, norm_impl=args.bn_impl,
                         conv0_s2d=args.conv0_s2d)
    if card:
        calib.append(calibrate_matmul_tflops(dev))
    record = make_record(args, result, calib, card)
    record["engine_metrics"] = final_metrics(record)
    if basics.rank() == 0:
        unit = "tok" if args.model == "gpt" else "img"
        for name in ("eager", "replayed"):
            if name in record:
                r = record[name]
                print(f"# {name}: {r[f'{unit}_sec_per_chip']:.1f} "
                      f"{unit}/sec/chip, step {r['step_ms_median']:.2f} ms, "
                      f"peak {r['max_memory_allocated_bytes']} B")
        print(json.dumps(record), flush=True)
    basics.shutdown()
    return record


if __name__ == "__main__":
    main()
