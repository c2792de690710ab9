#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (horovod_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on a failure:

1. device: require CUDA; print the card's name and power limit.
2. build: compile the six flash-attention kernels and the wire codecs
   from csrc/ with nvcc, one process per source, in parallel.
3. kernels: hold every kernel against its plain PyTorch version, and the
   autograd Function built on them (cotangents on o and on lse) against
   autograd of flash_attention_reference, at sixty-three shapes: the main
   path's (B 8, H 12, S 1024, D 64, bf16, causal), the accumulation
   phase's micro-batch (the same with B 4), non-causal, GQA (H 12,
   H_kv 4), ragged (S 1000, D 32, fp32), bf16 ragged (S 1000, D 64), bf16
   GQA at D 128 (B 2, S 2048, H 8, H_kv 2), bf16 D 32, bf16 GQA ragged at
   D 96 (S 1000, H 8, H_kv 2), fp32 GQA at S 4096 (D 64, H 4, H_kv 2), the
   ring's blocks at sp 2 (S 512, causal and not, o in fp32) and a causal
   ring block at head_dim 128 (H 6), Ulysses' local attention at sp 2
   (H 6), and the timed shapes below. Each kernel has its own route
   (_kernels._variant): all three take the tensor-core (sm90) kernels at
   bf16 and fp32 with every head_dim (fp32 as 3xTF32; head_dims off the
   128-byte panels padded), so no route reaches a SIMT kernel. Each shape
   runs its route and the SIMT design (variant="simt") too; the route's
   launches must be exactly its three kernels once each. The bf16 sm90 dq
   and dkv are also held against the plain versions that keep their
   operands in fp32, as the TPU kernels do (at the ring's blocks, whose
   fp32 dO both take as two bf16 terms, tighter, and nearer the two-term
   plain version than the one-term one), and a second launch of dq on the
   same inputs must give the same bits. At the timed shapes (the main
   path's; the ring's causal blocks at head_dim 64 and 128; d_model 768 at
   B 8, S 1024, causal: fp32 at D 32, 64, 96, 128 and 48, bf16 at D 32,
   96, 48 and 80; bf16 D 48 is where each SIMT kernel's line is taken)
   time each kernel that runs there, its plain version and the PyTorch
   library call that computes the same attention in the same dtype
   (scaled_dot_product_attention, timed only as a yardstick), beside the
   kernel's bound on an H100. The wide heads (bf16 q, o and dO at head_dim
   136..256, which only the sm90 kernels take) are timed shapes too: d_model
   768 at D 256 (H 3), D 192 (H 4) and D 200 (H 3, padded to 256), and the
   wide_head phase's attention (H 8, H_kv 1, D 256); SDPA gets K/V repeated
   to H heads. So are the ring's blocks at the wide heads (bf16 q with an
   fp32 o and dO: the wide_head attention at sp 2, S 512, causal and not,
   and a causal D 192 block at H 4), held to the ring's two-term checks
   like the D 64 blocks, and bf16 D 100 at H 8, off the kernels' grid of
   8: the wrappers pad it to 104 with zero columns, and the kernel is timed
   on inputs padded once, the wrappers' copies apart. The other head_dims
   off the grid (fp32 D 36, bf16 D 4, and the ring's fp32 o at bf16 D 250
   with one K/V head) are held to their plain versions. fp32 at the wide
   heads (3xTF32 at padded widths 192 and 256) is timed at the wide heads'
   d_model 768 shapes and the wide_head attention, each in fp32, and at
   D 136 (H 4, padded to 192), and held to its plain versions at fp32 D
   250 off the grid (B 2, S 1000, H 8, H_kv 1), at a D 256 block not causal
   at S 512 (H 8, H_kv 1), and at the longest sums dq and dk/dv see (B 1,
   S 4096, H 4, H_kv 1, D 256). fp16 q (the bf16 designs with .f16
   operands; dq and dk/dv take dO times a power of two from its largest
   magnitude, whose reduction is timed apart) at FP16_CASES: the main shape
   in fp16, GQA at D 128 not causal, D 32, D 100 off the grid, d_model 768
   at D 192 (H 4), the wide_head attention, and the ring's blocks with an
   fp32 o/dO (S 512 causal and not at D 64, causal at D 256 with one K/V
   head), each held to its fp16-operand plain version (TOL_PLAIN) and to
   the fp32-operand one (TOL_FP16_FP32_OPERANDS, the ring's blocks also by
   the two-term checks), the ring's blocks also at dO times 2^-20 and
   2^12 (fp16_magnitude_checks); the main shape, D 192, the wide_head
   attention and the causal ring blocks timed beside SDPA in fp16. The
   widest heads (bf16 and fp16 q with o and dO in q's dtype at head_dim
   264..512, padded widths 384 and 512: each warpgroup or block owns one
   column half of the head) at XWIDE_SHAPES, timed: d_model 1536 at D 512
   (H 3) in bf16 and fp16, D 384 (H 4), D 400 (H 3, to 512) and D 264 (H
   4, to 384) in bf16, and the head512 phases' attention (H 4, H_kv 1, D
   512) in bf16 and fp16; and at XWIDE_CHECKED, held only: D 300 off the
   grid, D 512 not causal at S 1000, GQA at D 392 (H 8, H_kv 1), S 4096 at
   D 512, and fp16 at D 512 also at dO times 2^-20 and 2^12. Every timed
   row names the SDPA backend PyTorch's dispatch picks there (its flash
   backend stops at head_dim 256). The build line carries every instance's
   ptxas line, and the wide and the widest instances' lines are printed
   again on their own.
4. main path: hvt.init() (a one-process NCCL world), then
   horovod_tpu_torch.train.train on the bench.py GPT (vocab 32768, 12
   layers, d_model 768, 12 heads, d_ff 3072, seq 1024, bf16, flash
   attention) under DistributedOptimizer(AdamW(lr 1e-4, weight decay
   1e-4)): 2 warm-up and 5 timed steps on one seeded batch of 8 x 1024
   tokens. Losses must be finite and fall; flash_fwd_sm90, flash_dq_sm90
   and flash_dkv_sm90 must launch exactly 12 times a step and the SIMT
   flash_fwd, flash_dq and flash_dkv never. The einsum-attention model from
   the same seed, trained the same 7 steps, must give the same first and
   last loss within 1e-2 (relative; about 2.5 bf16 epsilons): the last one
   catches a wrong dq, dk or dv.
5. profile: two more steps under torch.profiler; device time per step by
   kernel category, each flash kernel's time per launch inside the step,
   and the share of the window in which no kernel ran; then, for three
   more steps, the host's time to issue a step and the card's time to
   drain what is left after it.
6. accumulation: the same GPT from the same seed, built through the entry
   points (GPT, hvt.DistributedOptimizer(AdamW, backward_passes_per_step=2,
   average_aggregated_gradients=True), train.make_train_step), takes rows
   0-3 and 4-7 of the main path's batch as two micro-batches per update,
   for 7 updates. The mean of the two micro-batch losses must equal the
   main path's loss at updates 1 and 7 within 1e-2 (relative), and the
   three sm90 kernels must launch 24 times an update, the SIMT ones never.
   Update time (median of 5 after 2 warm-up updates), tokens/s, peak
   memory, a profile of two updates, and the host's issue and the card's
   drain time for three more.
7. collectives: every collective of the port on CUDA tensors, fp32 and
   bf16, in this one-process NCCL world (grouped allreduce, ragged
   allgather, alltoall with splits, reducescatter, each *_async with poll
   and synchronize, a process set, Adasum, hierarchical allreduce and
   allgather, broadcast of the trained parameters and optimizer state,
   allgather_object, sparse_allreduce_apply). Each result must equal its
   world-of-one value exactly and stay on cuda:0 in the input's dtype.
8. sequence: ring attention's block function (flash_ring_block of
   horovod_tpu_torch/parallel/sequence.py), the arithmetic of each ring
   step, on one card for every shard of an sp 2 and an sp 4 split of the
   main shape, K/V blocks in ring order: o within 2e-2 and the gradients
   of mean(o**2) within 5e-2 (relative to each gradient's largest
   magnitude) of flash attention over the whole sequence and of the dense
   reference; each sm90 kernel launches n(n+1)/2 times
   for one forward and backward of n shards, the SIMT ones never.
9. bench: the port's benchmark harness (horovod_tpu_torch/bench.py, the
   counterpart of bench.py --model gpt --flash) at full width: eager
   steps, then the whole step captured once in a CUDA graph
   (bench.capture_step) and replayed in blocks of BENCH_STEPS, each block
   ending in a readback. Tokens/s and step time both ways, peak memory, the
   card's bf16 matmul rate (bench.calibrate_matmul_tflops) and MFU. The
   replayed losses must be finite, fall, and equal the eager ones from the
   same weights within 1e-2 at steps 1 and 7; a profile of replayed steps
   must show 12 kernels a step of each sm90 kernel and none of the SIMT
   ones (a replay runs no Python, so the launch counters stay flat; they
   must count 12 a step for the eager steps, the capture's warm-up steps
   and the capture). Then
   the same with --chunked-ce: peak memory, tokens/s, and losses within
   1e-2 of the unchunked run's at steps 1 and 7.
10. vision: bench.measure for ResNet-50 (batch 256, 224x224, bf16,
   --bn-impl tpu, channels-last): img/s per card, peak memory, the loss
   finite and falling, and a profile of two more steps; VGG16 (batch 64)
   and InceptionV3 (batch 128, 299x299) two steps each, losses finite; and
   the space-to-depth stem against the standard 7x7/2 stem from the same
   weights on a ResNet-50 batch (fp32 within 1e-4, bf16 within 2e-2).
11. checkpoint: the main path's GPT and optimizer, built through the entry
   points (GPT, hvt.DistributedOptimizer(AdamW), train.make_train_step),
   take 3 eager steps; hvt.checkpoint.CheckpointManager(max_to_keep=2)
   saves model, optimizer and step asynchronously at step 3 while 3 more
   steps run, then waits. A fresh model and optimizer from another seed
   restore_latest and take 3 steps: their losses must equal the unbroken
   steps 4-6 bit for bit. The host ms that save blocks, the ms of wait and
   of restore, the bytes on disk, the peak device memory during the save;
   each sm90 kernel must launch 12 times a step (36 over the restored
   steps) and the SIMT ones never.
12. fsdp: the same GPT under parallel.fsdp.shard_module on a mesh of one
   rank (fsdp 1: an FSDP2 unit per block, and the root with the tied
   embedding) and a plain AdamW, 7 steps:
   losses within 1e-2 of the main path's at steps 1 and 7, 12 launches a
   step of each sm90 kernel, none SIMT; step time and peak memory.
13. launch: python -m horovod_tpu_torch.runner.launch -np 1 runs
   tests/torch_port_launch_worker.py, which takes 2 steps of the main
   path's GPT on cuda:0 through train.train; it must exit 0, see the
   launcher's HVT_* identity, report losses within 1e-2 of the main path's
   first two and 24 launches of each sm90 kernel, none SIMT.
14. elastic: the main path's GPT, built through the entry points, trains
   under @hvt.elastic.run with hvt.elastic.TorchState(model=...,
   optimizer=DistributedOptimizer(AdamW), batch=0), committing after every
   step: 7 steps unbroken, then 7 from the same seed with
   HorovodInternalError raised once after step 5's backward, before its
   commit. The loop must restore commit 4, reset (shutdown, then init on
   cuda:0), sync and resume; steps 5-7 must give the unbroken run's losses
   bit for bit, and all seven must be within 1e-2 of the main path's. Commit
   ms, the device bytes the snapshot holds and a commit adds at its peak,
   restore ms, the recovery's phases (restore, rendezvous, reinit,
   rebuild), and 12 launches a step of each sm90 kernel, none SIMT.
15. elastic launch: python -m horovod_tpu_torch.runner.launch -np 1
   --min-np 1 --host-discovery-script ... runs
   tests/torch_port_elastic_worker.py (the same GPT on cuda:0, rows from an
   ElasticSampler), which sends itself one SIGTERM after commit 2: it must
   raise HostsUpdatedInterrupt at commit 3, re-rendezvous into round 2 on
   cuda:0 and finish every row of the epoch exactly once; the rounds and
   the seconds to the worker's result.
16. observe: the main path's 7 steps through train.train with
   hvt.start_timeline, metrics.serve(0) and callbacks.MetricsCallback, in
   turns with plain runs (plain, observed, observed, plain), then once with
   the timeline's torch.profiler session: losses bit for bit the main
   path's, 12 launches a step of each sm90 kernel (and 12 of each in the
   profiler's trace), every grouped allreduce timed by CUDA events (a
   histogram observation and a NCCL_ span on the timeline each), a scrape
   of /metrics holding hvt_train_* and the latency, join() = 0 and nothing
   pending after the last step; the host µs that timing one collective
   adds; then the step captured in a CUDA graph with and without the
   timeline: the same replayed losses bit for bit, the capture counted once
   in hvt_traced_collectives_total and not timed.
17. fleet: python -m horovod_tpu_torch.runner.launch -np 1 --timeline ...
   (the launcher's KV server) runs tests/torch_port_launch_worker.py fleet:
   the main path's GPT through train.train for FLEET_STEPS steps with
   HVT_TELEMETRY_AGG=1 (the rank leads its host and pushes host frames)
   and HVT_DEBUGZ_INTERVAL_MS=200; from step FLEET_POLL_FROM the worker
   reads GET /statusz and GET /debugz each step. The rank's record must be
   fresh, the schema hvt-statusz-r1, the mode leader, no alert, and
   hvt_collective_bytes_total{op="grouped_allreduce"} in the host frame;
   losses within 1e-2 of the main path's, 12 launches a step of each sm90
   kernel. Prints the snapshot's bytes, a snapshot's build and a PUT's host
   ms, and each read's ms.
18. wire: the bench GPT's full gradient (one backward of the main path's
   batch) as one flat fp32 buffer, and buffers with the codecs' edge cases
   (NaN of both signs, ±Inf, zero, -0 and subnormal blocks) with tails of 1
   and 255 elements: each codec kernel (bf16, int8, fp8 × encode,
   decode_accumulate, ef_roundtrip) bit for bit against its plain version,
   the stream's length against the wire formula; each kernel timed by CUDA
   events over 20 calls at the gradient's size beside its bound and its
   plain version (and for bf16 encode and decode the PyTorch cast). Then
   the compressed route's code (ops/hierarchical.py compressed_allreduce)
   over the one-process world's group, one call a codec on the gradient
   with each parameter's error feedback: the result the roundtrip of the
   error-fed gradient bit for bit, 2 encodes, 1 decode and one ef_roundtrip
   a parameter. A one-card world sends no byte, so hvt.allreduce takes the
   route only across hosts (tests/test_torch_port_cuda.py WIRE4 drives it
   there); these are the codec kernels' launches in the kernels line.
19. serving: horovod_tpu_torch.serving.loadgen.run_loadtest in this
   process on a gang of one (one-process NCCL world), r07's traffic (800
   requests of 8,192 bytes, burst 2, window 4, sync every 50, admission
   250 ms) with a contended phase at burst 8 that sheds, unbatched and with
   HVT_SERVING_BATCH=4: artifacts valid, every result exact, p50, p99,
   requests/s and host µs a request. A replica of one rank sends nothing;
   four cards' lanes are SERVE4's (tests/test_torch_port_cuda.py).
20. run: horovod_tpu_torch.runner.run(fn, np=1): the launcher's worker on
   cuda:0 takes 2 steps of the main path's GPT; losses within 1e-2 of the
   main path's, 12 launches a step of each sm90 kernel; the seconds run()
   took.
21. estimator: horovod_tpu_torch.spark.TorchEstimator._fit_arrays through
   the in-process _local_run, a 16-64-1 MLP on 4,096 seeded rows, 2
   epochs, a FilesystemStore in a temporary directory, on the card and
   then on the CPU: per-epoch losses within 1e-4, every epoch's checkpoint
   published, TorchModel.load predicting on the card as the fitted model.
22. examples: every example of examples/torch_port/ at a small size on
   the card through python -m horovod_tpu_torch.runner.launch -np 1 (the
   elastic one through the elastic launcher), all started together; each
   must exit 0 and print its result line. long_context_train runs twice
   on a 2,048-token sequence (4 heads, 2 K/V heads, head_dim 64, bf16):
   through the sm90 flash kernels, which must launch at least once a step
   each and the SIMT ones never, and through the plain einsum blocks
   (--no-flash). On the first batch the attention output must agree
   within 2e-2 and the gradients of Q, K and V, each relative to its
   largest magnitude, within 5e-2; every step's loss within 2e-2. The
   Ray and Spark examples are skipped where their packages are absent.
23. tools: python -m horovod_tpu_torch.tools.hvt_analyze over the fleet
   phase's merged timeline (its coordinator lanes must give the exec phase
   of every gradient allreduce), and what the fleet worker's python -m
   horovod_tpu_torch.tools.hvt_top --once --json printed against the
   launcher's server (exit 0, one /statusz document).
24. entry (run after the profile phase): the repo's entry model
   (gpt_config("entry", use_flash=True): d_model 128, 4 heads of
   head_dim 32, 2 layers) through train.train, fp32 and bf16, ENTRY_STEPS
   steps on a seeded batch of 8 x 128: losses finite and falling,
   flash_fwd_sm90, flash_dq_sm90 and flash_dkv_sm90 launching once a
   layer a step and no SIMT kernel, and the einsum-attention model from the
   same seed within ENTRY_RTOL of each loss (fp32: dryrun.py's entry
   tolerance; bf16: LOSS_RTOL).
25. wide_head (after the tools phase): a GPT with Gemma-2B's attention widths
   (vocab 32768, 4 layers, d_model 2048, 8 heads of head_dim 256, one K/V
   head, d_ff 8192, seq 1024, bf16 compute with fp32 parameters,
   use_flash="auto") through train.train, WIDE_HEAD_STEPS steps on a
   seeded batch of 8 x 1024: flash_fwd_sm90, flash_dq_sm90 and
   flash_dkv_sm90 at head_dim 256 (their padded-width-256 instances) once a
   layer a step and no other kernel, the einsum attention never; the
   einsum-attention model from the same seed within LOSS_RTOL at steps 1
   and WIDE_HEAD_STEPS; step ms and peak memory of both.
26. ring_wide_head (after wide_head): ring attention at the wide heads.
   The sequence phase's block function over the wide_head attention (B 8,
   S 1024, H 8, H_kv 1, D 256, bf16, causal) at sp 2 and sp 4: each sm90
   kernel n(n+1)/2 times through its fp32-o instance at padded width 256,
   no SIMT kernel, o and the gradients against flash attention over the
   whole sequence and the dense reference. Then the wide_head GPT with a
   ring mesh of this one process (dp 1 x sp 1 x tp 1, so every layer's
   attention is one diagonal ring block) and use_flash="auto", through
   GPT(cfg, mesh=...) and train.make_parallel_train_step, WIDE_HEAD_STEPS
   steps on train.train's seeded batch: each sm90 kernel once a layer a
   step, no einsum ring block; its einsum ring run from the same seed
   within LOSS_RTOL at steps 1 and WIDE_HEAD_STEPS; step ms of both.
27. wide_head_fp32 (after wide_head): the wide_head GPT in fp32
   (GPTConfig(dtype=torch.float32), use_flash="auto") through train.train,
   WIDE_HEAD_STEPS steps on a seeded batch of 8 x 1024: the three sm90
   kernels' fp32 instances at padded width 256 (3xTF32) once a layer a
   step and no other kernel, the einsum attention never; the einsum model
   from the same seed within ENTRY_RTOL's fp32 tolerance (1e-4) at steps 1
   and WIDE_HEAD_STEPS; step ms and peak memory of both.
28. gpt_fp16: the main path's GPT (bench.py --model gpt --flash at
   full width) with fp16 compute and fp32 parameters, no loss scaler (as
   the JAX package's GPT runs fp16), use_flash=True, through train.train
   for 7 steps on the main path's seeded batch: the fp16 instances of
   flash_fwd_sm90, flash_dq_sm90 and flash_dkv_sm90 12 times a step (every
   launch with fp16 q and o), no SIMT kernel, the einsum attention never;
   the einsum fp16 model from the same seed within LOSS_RTOL at steps 1 and
   7; step ms and peak memory of both.
29. head512 (after gpt_fp16): the wide_head GPT with four heads of 512
   instead of eight of 256 (vocab 32768, 4 layers, d_model 2048, one K/V
   head, d_ff 8192, seq 1024, bf16 compute with fp32 parameters,
   use_flash="auto") through train.train, WIDE_HEAD_STEPS steps on a
   seeded batch of 8 x 1024: flash_fwd_sm90, flash_dq_sm90 and
   flash_dkv_sm90 at head_dim 512 (their padded-width-512 instances) once a
   layer a step and no other kernel, the einsum attention never; the
   einsum-attention model from the same seed within LOSS_RTOL at steps 1
   and WIDE_HEAD_STEPS; step ms and peak memory of both.
30. head512_fp16 (last): the same GPT in fp16 compute (fp32 parameters, no
   loss scaler), the fp16 instances at padded width 512, the same checks.
31. summary: one JSON line listing the kernels (launches on the main path,
   or the wire phase's route for the codec kernels; the observe,
   accumulation, sequence, checkpoint, fsdp, launch, elastic, fleet,
   serving, run, estimator, examples, entry, wide_head, wide_head_fp32,
   ring_wide_head, gpt_fp16, head512 and head512_fp16 phases; the
   timings at the kernel's own route's shape, and at every timed shape in
   by_shape), the nvidia-smi line, and last the {"ok": true, ...} line.
"""

import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet, dense): the least time the card could
# take for a kernel's work is max(bytes / HBM rate, FLOPs / peak rate).
HBM_BYTES_PER_S = 3.35e12
# fp32 inputs: the tensor cores' TF32 rate (the sm90 kernels' 3xTF32 split
# does three times the work: bound_3xtf32_ms); fp16 runs at bf16's rate
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12}

CSRC = "horovod_tpu_torch/csrc/"
SOURCE = {"flash_fwd_sm90": CSRC + "flash_fwd_sm90.cu",
          "flash_dq_sm90": CSRC + "flash_dq_sm90.cu",
          "flash_dkv_sm90": CSRC + "flash_dkv_sm90.cu",
          "flash_fwd": CSRC + "flash_fwd.cu",
          "flash_dq": CSRC + "flash_dq.cu",
          "flash_dkv": CSRC + "flash_dkv.cu"}
REPLACES = {"flash_fwd_sm90": "horovod_tpu/ops/flash_attention.py:94",
            "flash_dq_sm90": "horovod_tpu/ops/flash_attention.py:156",
            "flash_dkv_sm90": "horovod_tpu/ops/flash_attention.py:210",
            "flash_fwd": "horovod_tpu/ops/flash_attention.py:94",
            "flash_dq": "horovod_tpu/ops/flash_attention.py:156",
            "flash_dkv": "horovod_tpu/ops/flash_attention.py:210"}
# the wire codec kernels replace the C++ codecs (no Pallas kernel): bf16's
# Compress/Decompress, the block codecs' Compress/Decompress, and the
# engine's error-feedback pass around Roundtrip
for _codec in ("bf16", "int8", "fp8"):
    SOURCE.update({f"wire_{op}_{_codec}": CSRC + "wire_codec.cu"
                   for op in ("encode", "decode_accumulate", "ef_roundtrip")})
    REPLACES.update({
        f"wire_encode_{_codec}": "horovod_tpu/csrc/codecs.cc:"
        + ("38" if _codec == "bf16" else "93"),
        f"wire_decode_accumulate_{_codec}": "horovod_tpu/csrc/codecs.cc:"
        + ("45" if _codec == "bf16" else "117"),
        f"wire_ef_roundtrip_{_codec}": "horovod_tpu/csrc/engine.cc:3273"})
# (B, S, H, H_kv, D, dtype name, causal, o's dtype name); the first is the
# main path's, the second the accumulation phase's (each update takes the
# main path's batch as MICRO_BATCHES micro-batches)
MAIN_SHAPE = (8, 1024, 12, 12, 64, "bfloat16", True, "bfloat16")
MICRO_BATCHES = 2
MICRO_SHAPE = (MAIN_SHAPE[0] // MICRO_BATCHES, *MAIN_SHAPE[1:])
# the sequence-parallel paths at sp 2: a ring block of the main shape
# (S / 2, causal on the diagonal, not causal below it; o in fp32 for the
# logaddexp merge), and Ulysses' local attention (H / 2 heads)
SP = 2
RING_CASES = [(8, 1024 // SP, 12, 12, 64, "bfloat16", causal, "float32")
              for causal in (True, False)]
# a causal ring block of d_model 768 at head_dim 128 (H 6): the two-term
# dkv and dq at padded width 128
RING_WIDE_CASE = (8, 1024 // SP, 6, 6, 128, "bfloat16", True, "float32")
ULYSSES_CASE = (8, 1024, 12 // SP, 12 // SP, 64, "bfloat16", True,
                "bfloat16")
# timed besides the main shape: d_model 768 at B 8, S 1024, causal, on the
# routes the tensor-core kernels took over from the SIMT ones (fp32 at
# D 32, 64, 96 and 128, bf16 at D 32 and 96), and at head_dims off the
# 32-grid, where all three run padded (fp32 D 48, bf16 D 48 and 80)
ROUTE_SHAPES = [(8, 1024, 768 // d, 768 // d, d, dtype, True, dtype)
                for d, dtype in ((32, "float32"), (64, "float32"),
                                 (96, "float32"), (128, "float32"),
                                 (32, "bfloat16"), (96, "bfloat16"),
                                 (48, "bfloat16"), (48, "float32"),
                                 (80, "bfloat16"))]
# the wide heads (bf16 q, o and dO at head_dim 136..256): d_model 768 at
# B 8, S 1024, causal with D 256 (H 3), D 192 (H 4) and D 200 (H 3, padded to
# 256, D at run time), and the wide_head phase's own attention (H 8, H_kv 1,
# D 256)
WIDE_HEAD_CONFIG = dict(vocab_size=32768, n_layers=4, d_model=2048, n_heads=8,
                        n_kv_heads=1, d_ff=8192, max_seq_len=1024)
WIDE_HEAD_BATCH, WIDE_HEAD_STEPS = 8, 7
WIDE_HEAD_SHAPE = (WIDE_HEAD_BATCH, WIDE_HEAD_CONFIG["max_seq_len"],
                   WIDE_HEAD_CONFIG["n_heads"], WIDE_HEAD_CONFIG["n_kv_heads"],
                   WIDE_HEAD_CONFIG["d_model"] // WIDE_HEAD_CONFIG["n_heads"],
                   "bfloat16", True, "bfloat16")
WIDE_SHAPES = [(8, 1024, h, h, d, "bfloat16", True, "bfloat16")
               for d, h in ((256, 3), (192, 4), (200, 3))] + [WIDE_HEAD_SHAPE]
# the ring's blocks at the wide heads (bf16 q with an fp32 o and dO at
# padded widths 256 and 192): the wide_head attention's blocks at sp 2
# (S 512, H 8, H_kv 1, D 256), causal on the diagonal and not below it,
# and a causal block of d_model 768 at D 192 (H 4)
RING_WIDE_HEAD_CASES = [(8, WIDE_HEAD_SHAPE[1] // SP, *WIDE_HEAD_SHAPE[2:5],
                         "bfloat16", causal, "float32")
                        for causal in (True, False)] + [
    (8, 1024 // SP, 4, 4, 192, "bfloat16", True, "float32")]
# the ring blocks held to the two-term checks (dq_ring_checks,
# dkv_ring_checks); the fp16 ones are defined below
RING_CHECKED = RING_CASES + RING_WIDE_HEAD_CASES
# head_dims off the kernels' grid of 8, which the wrappers pad to it with
# zero columns: bf16 D 100 (H 8, timed, the pad copies apart), fp32 D 36,
# bf16 D 4, and the ring's fp32 o at D 250 with one K/V head
OFF_GRID_SHAPES = [(8, 1024, 8, 8, 100, "bfloat16", True, "bfloat16"),
                   (2, 1000, 4, 2, 36, "float32", True, "float32"),
                   (2, 1000, 4, 4, 4, "bfloat16", True, "bfloat16"),
                   (2, 1000, 8, 1, 250, "bfloat16", True, "float32")]
# fp32 at the wide heads (3xTF32 at padded widths 192 and 256), timed:
# d_model 768 at B 8, S 1024, causal with D 256 (H 3), D 192 (H 4) and D 200
# (H 3, padded to 256, D at run time), the wide_head attention in fp32, and
# D 136 (H 4, padded to 192, D at run time: the fourth new instance)
WIDE_FP32_SHAPES = [(8, 1024, h, h, d, "float32", True, "float32")
                    for d, h in ((256, 3), (192, 4), (200, 3))] + [
    (*WIDE_HEAD_SHAPE[:5], "float32", True, "float32"),
    (8, 1024, 4, 4, 136, "float32", True, "float32")]
# and checked only: fp32 D 250 off the grid with one K/V head, a D 256 block
# not causal at S 512 (what the sequence ring runs below the diagonal), and
# the longest sums dq and dk/dv see (S 4096)
WIDE_FP32_CHECKED = [(2, 1000, 8, 1, 250, "float32", True, "float32"),
                     (8, 512, 8, 1, 256, "float32", False, "float32"),
                     (1, 4096, 4, 1, 256, "float32", True, "float32")]
# fp16 q (the bf16 designs with .f16 operands and dO's scale): the main
# shape in fp16, timed; GQA at D 128 not causal; D 32 (padded to 64); D 100
# off the grid (padded to 104, then 128); d_model 768 at D 192 (H 4) and
# the wide_head attention in fp16, both timed; and the ring's blocks with
# fp16 q and an fp32 o/dO (split into two fp16 terms after the scale): S
# 512 causal and not at D 64, and causal at D 256 with one K/V head, the
# causal ones timed and all three held at dO times FP16_DOUT_MAGNITUDES
FP16_MAIN_SHAPE = (*MAIN_SHAPE[:5], "float16", True, "float16")
FP16_RING_CASES = [(*RING_CASES[0][:5], "float16", causal, "float32")
                   for causal in (True, False)] + [
    (*RING_WIDE_HEAD_CASES[0][:5], "float16", True, "float32")]
FP16_TIMED = [FP16_MAIN_SHAPE,
              (8, 1024, 4, 4, 192, "float16", True, "float16"),
              (*WIDE_HEAD_SHAPE[:5], "float16", True, "float16"),
              FP16_RING_CASES[0], FP16_RING_CASES[2]]
FP16_CASES = FP16_TIMED[:1] + [
    (2, 2048, 8, 2, 128, "float16", False, "float16"),
    (4, 1024, 8, 8, 32, "float16", True, "float16"),
    (8, 1024, 8, 8, 100, "float16", True, "float16")] + FP16_TIMED[1:3] + \
    FP16_RING_CASES
# the widest heads (bf16 and fp16 q with o and dO in q's dtype at head_dim
# 264..512, padded widths 384 and 512; only the sm90 kernels take them):
# the head512 phases' GPT (WIDE_HEAD_CONFIG with four heads of 512) and its
# attention (B 8, S 1024, H 4, H_kv 1, D 512) in bf16 and fp16, and d_model
# 1536 at B 8, S 1024, causal with D 512 (H 3) in bf16 and fp16, D 384
# (H 4), D 400 (H 3, padded to 512, D at run time) and D 264 (H 4, padded
# to 384, D at run time), all timed
HEAD512_CONFIG = dict(WIDE_HEAD_CONFIG, n_heads=4)
HEAD512_SHAPES = [(WIDE_HEAD_BATCH, HEAD512_CONFIG["max_seq_len"],
                   HEAD512_CONFIG["n_heads"], HEAD512_CONFIG["n_kv_heads"],
                   HEAD512_CONFIG["d_model"] // HEAD512_CONFIG["n_heads"],
                   dtype, True, dtype) for dtype in ("bfloat16", "float16")]
XWIDE_SHAPES = [(8, 1024, h, h, d, dtype, True, dtype)
                for d, h, dtype in ((512, 3, "bfloat16"), (512, 3, "float16"),
                                    (384, 4, "bfloat16"), (400, 3, "bfloat16"),
                                    (264, 4, "bfloat16"))] + HEAD512_SHAPES
# and checked only: D 300 off the grid of 8 (zero-padded to 304), D 512 not
# causal at a ragged S, GQA at D 392 (H 8, H_kv 1), the longest sums dq and
# dk/dv see (S 4096), and fp16 at D 512, also at dO times each of
# FP16_DOUT_MAGNITUDES (fp16_magnitude_checks)
XWIDE_FP16_MAGNITUDE_CASE = (2, 1000, 4, 1, 512, "float16", True, "float16")
XWIDE_CHECKED = [(2, 1000, 4, 2, 300, "bfloat16", True, "bfloat16"),
                 (2, 1000, 4, 1, 512, "bfloat16", False, "bfloat16"),
                 (2, 1024, 8, 1, 392, "bfloat16", True, "bfloat16"),
                 (1, 4096, 2, 1, 512, "bfloat16", True, "bfloat16"),
                 XWIDE_FP16_MAGNITUDE_CASE]
# and the ring's causal blocks: bf16 q with an fp32 dO, which flash_dq_sm90
# and flash_dkv_sm90 split into two bf16 terms in shared memory
TIMED = [MAIN_SHAPE, RING_CASES[0], RING_WIDE_CASE, *ROUTE_SHAPES,
         *WIDE_SHAPES, *RING_WIDE_HEAD_CASES, OFF_GRID_SHAPES[0],
         *WIDE_FP32_SHAPES, *FP16_TIMED, *XWIDE_SHAPES]
CASES = [MAIN_SHAPE,
         MICRO_SHAPE,
         (8, 1024, 12, 12, 64, "bfloat16", False, "bfloat16"),
         (8, 1024, 12, 4, 64, "bfloat16", True, "bfloat16"),
         (2, 1000, 4, 4, 32, "float32", True, "float32"),
         (2, 1000, 4, 4, 64, "bfloat16", True, "bfloat16"),
         (2, 2048, 8, 2, 128, "bfloat16", True, "bfloat16"),
         (4, 1024, 8, 8, 32, "bfloat16", True, "bfloat16"),
         (2, 1000, 8, 2, 96, "bfloat16", True, "bfloat16"),
         (1, 4096, 4, 2, 64, "float32", True, "float32"),
         *RING_CASES, RING_WIDE_CASE, ULYSSES_CASE, *ROUTE_SHAPES,
         *WIDE_SHAPES, *RING_WIDE_HEAD_CASES, *OFF_GRID_SHAPES,
         *WIDE_FP32_SHAPES, *WIDE_FP32_CHECKED, *FP16_CASES, *XWIDE_SHAPES,
         *XWIDE_CHECKED]
# the shape whose timing stands in the kernels line for each SIMT kernel:
# bf16 D 48 at d_model 768, where, since no route sends any kernel to the
# SIMT design, they are timed as variant="simt" beside the padded sm90 ones
SIMT_LINE_SHAPE = dict.fromkeys(("flash_fwd", "flash_dq", "flash_dkv"),
                                (8, 1024, 16, 16, 48, "bfloat16", True,
                                 "bfloat16"))
BASES = ("flash_fwd", "flash_dq", "flash_dkv")
# the sequence phase: ring blocks of the main shape at these sp layouts
SEQUENCE_LAYOUTS = (2, 4)
# kernel vs its plain version: the same arithmetic, summed in another
# order; bf16 outputs may differ by about one bf16 ulp (2^-8 relative),
# fp16 ones by one fp16 ulp (2^-11): 5e-3 is about five.
TOL_PLAIN = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 5e-3}
# flash_dkv_sm90 rounds p and ds to bf16 before p^T dO and ds^T q (bf16
# inputs; fp32 ones keep them fp32, as 3xTF32), where
# flash_dkv and the TPU kernel keep them fp32 (an fp32 dO it carries as two
# bf16 terms). Against that fp32-operand plain version it is held to the
# same 2e-2: on the card the least tolerance that holds was at most 0.010
# over the bf16 cases (about one bf16 ulp of dk and dv; PERF.md), so 2e-2
# keeps a factor of two.
TOL_DKV_FP32_OPERANDS = 2e-2
# flash_dq_sm90 on bf16 rounds ds to bf16 before ds k, where flash_dq and
# the TPU kernel keep ds fp32 (an fp32 dO it carries as two bf16 terms). On
# the card the least tolerance that holds against that fp32-operand plain
# version was at most 0.0069 over the bf16 cases; at the ring's causal
# block (fp32 dO) 0.0061, 0.0136 while that dO was rounded to one bf16 term
# (PERF.md). 1.4e-2 keeps a factor of two.
TOL_DQ_FP32_OPERANDS = 1.4e-2
# The same for fp16 q, dq and dkv alike: ds (and p) rounded to fp16 keep 11
# bits where bf16 keeps 8, so the least tolerance against the fp32-operand
# plain version should be about an eighth of bf16's (at most about 1.3e-3),
# plus the fp16 outputs' own rounding (2^-11 relative); 5e-3 keeps a
# factor of about three over both.
TOL_FP16_FP32_OPERANDS = 5e-3
# The ring's blocks (bf16 q, fp32 dO) are held tighter: a kernel that drops
# dO's lo term reads 0.0136 there, within TOL_DQ_FP32_OPERANDS, so their
# least tolerance must stay under this limit, between that reading and the
# two terms' 0.0061, and no larger than the main shape's (bf16 dO); and the
# kernel's dq must lie nearer the two-term plain version than the one-term
# one, by RING_NEARER in the Frobenius norm.
TOL_DQ_RING = 9.5e-3
RING_NEARER = 0.5
# The same for flash_dkv_sm90 at the ring's blocks: while it rounded the
# fp32 dO to one bf16 term its dk and dv read 0.0105 there (PERF.md), within
# TOL_DKV_FP32_OPERANDS; with two terms they must stay under this limit,
# between that reading and the two terms', and no larger than the main
# shape's, and lie nearer the two-term plain version by RING_NEARER.
TOL_DKV_RING = 9e-3
# Both limits were placed between the two-term and one-term plain versions'
# readings at the D 64 block. Where a block's own arithmetic (its two-term
# plain version, whose rounding of p and ds the kernel shares) already reads
# above a limit or the main shape's, as dk and dv do at the causal wide_head
# block (H 8 summed into one K/V head: 0.0132 on the card, PERF.md), the
# block is held instead under the midpoint of those two readings at that
# block, and by RING_NEARER as everywhere.
# The fp16 ring blocks are held the same way, against TOL_FP16_FP32_OPERANDS
# and the fp16 main shape's least tolerance. Each is also run with dO times
# each of FP16_DOUT_MAGNITUDES (fp16_magnitude_checks): the kernels scale dO
# by a power of two from its largest magnitude, so the error of dq, dk and
# dv against the fp32-operand plain version, relative to each output's
# largest magnitude, must stay within FP16_MAGNITUDE_FACTOR times its error
# at magnitude 1, plus one step of fp16's subnormal grid (2^-24) relative to
# that magnitude: the fp16 output's own resolution, which the plain
# version's fp16 output has too (at 2^-20 a gradient of these inputs is a
# few such steps). Nothing may be inf or NaN where the plain version's
# output is finite.
FP16_DOUT_MAGNITUDES = (2.0 ** -20, 2.0 ** 12)
FP16_MAGNITUDE_FACTOR = 2
RING_CHECKED = RING_CHECKED + FP16_RING_CASES
# what the sm90 kernels round to q's dtype (bf16 or fp16 inputs), where the
# TPU kernels keep fp32; both carry an fp32 dO as two terms of q's dtype
ROUNDED = {"flash_dq_sm90": "ds", "flash_dkv_sm90": "p and ds"}
# the autograd Function vs autograd of the dense reference: in bf16 the
# reference's autograd also rounds dp through the p cast, so allow more;
# fp16 rounds there with 3 bits more.
TOL_AUTOGRAD = {"float32": 1e-4, "bfloat16": 5e-2, "float16": 1e-2}
# the entry phase: steps, and each dtype's tolerance between the flash and
# einsum losses (fp32: dryrun.py's entry loss rtol; bf16: LOSS_RTOL's 1e-2)
ENTRY_STEPS, ENTRY_BATCH = 5, 8
ENTRY_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
STEPS_WARMUP, STEPS_TIMED = 2, 5
# the bench phase: timed blocks of BENCH_STEPS steps after one warm-up
# block; the losses compared are those of steps 1 and LOSS_STEPS
BENCH_ITERS, BENCH_STEPS, LOSS_STEPS = 3, 8, 7
# the vision phase: ResNet-50 blocks; VGG16 and InceptionV3 take one step a
# block, one block after the warm-up one
VISION_ITERS, VISION_STEPS = 2, 4
TOL_STEM = {"float32": 1e-4, "bfloat16": 2e-2}
PROFILE_STEPS, PROFILE_TOP = 2, 12
LOSS_RTOL = 1e-2
SLEEP_CYCLES = 100_000_000   # about 50 ms of the card's clock
MARK_CYCLES = 1_000          # a marker kernel in a profile
# torch.profiler on the GPU machine can lose a run of device records at a
# session's start (PERF.md §7): a session whose marker kernels are not all
# in its records is discarded and run again, at most PROFILE_SESSIONS times
# in all
PROFILE_SESSIONS = 3
# bench.py's GPT has 12 layers: a step launches each flash kernel 12 times
MAIN_LAYERS = 12
# the checkpoint phase: save at this step, then as many more
CKPT_AT = 3
# the elastic phase: steps of each run, and the step whose commit fails
ELASTIC_STEPS, ELASTIC_FAIL_AT = 7, 5
# the elastic launch: rows of the epoch (ELASTIC_LAUNCH_STEPS batches of
# MAIN_SHAPE[0] rows) and the commit after which the worker is preempted
ELASTIC_LAUNCH_STEPS, ELASTIC_SIGTERM_AFTER = 6, 2
# the wire phase: the codec kernels timed over WIRE_ITERS calls; the ragged
# buffers hold WIRE_BLOCKS whole blocks and a tail of each WIRE_TAILS
WIRE_CODECS = ("bf16", "int8", "fp8")
WIRE_ITERS, WIRE_BLOCKS, WIRE_TAILS = 20, 4096, (1, 255)
WIRE_OPS = ("encode", "decode_accumulate", "ef_roundtrip")
# where the kernels line's codec launches come from: hvt.allreduce and the
# DistributedOptimizer reach the codec kernels only across hosts, which the
# four-card WIRE4 test (tests/test_torch_port_cuda.py) drives
WIRE_LAUNCHES_FROM = ("wire phase: ops/hierarchical.py compressed_allreduce "
                      "called directly, plan flat, a group of one")
# the fleet phase: the launched job's steps, the step from which it reads
# /statusz and /debugz, and its push period
FLEET_STEPS, FLEET_POLL_FROM, FLEET_INTERVAL_MS = 12, 6, 200
# the serving phase: r07's traffic (benchmarks/r07_serving_loadtest.json's
# config) on a gang of one, its contended phase at burst 2 x 4 = 8 against a
# window of 4 so that it sheds; once unbatched, once batched by 4
SERVING_ARGV = ["--replicas", "1", "--requests", "800", "--bytes", "8192",
                "--burst", "2", "--window", "4", "--admission-ms", "250",
                "--gap-ms", "0", "--sync-every", "50",
                "--saturate-replica", "0", "--saturate-factor", "4",
                "--phases", "contended,baseline"]
SERVING_BATCHES = (1, 4)
# the run phase: steps of the main path's GPT in runner.run's worker
RUN_STEPS = 2
# the estimator phase: a 16-64-1 MLP fitted by TorchEstimator on the card
# and on the CPU; the card's per-epoch losses within ESTIMATOR_RTOL of the
# CPU's (fp32 both, TF32 off)
ESTIMATOR_ROWS, ESTIMATOR_FEATURES, ESTIMATOR_EPOCHS = 4096, 16, 2
ESTIMATOR_BATCH, ESTIMATOR_RTOL = 64, 1e-4
# the examples phase: each example of examples/torch_port/ through the
# launcher at -np 1 (the launcher's extra flags, the script, its flags, a
# line its output must hold); long_context_train's steps and the relative
# tolerance between its flash and einsum losses (bf16, TOL_PLAIN's); its
# attention output and Q/K/V gradients on the first batch are held to the
# einsum blocks' at TOL_PLAIN and TOL_AUTOGRAD, as the sequence phase
# holds the ring's
LONG_CONTEXT_ARGV = ["--seq", "2048", "--heads", "4", "--kv-heads", "2",
                     "--head-dim", "64", "--steps", "5"]
LONG_CONTEXT_STEPS, LONG_CONTEXT_RTOL = 5, 2e-2
EXAMPLES = [
    ("synthetic", [], "pytorch_synthetic_benchmark.py",
     ["--batch-size", "32", "--num-iters", "2", "--num-batches-per-iter",
      "3"], "Total img/sec on 1 proc(s)"),
    ("resnet50", [], "pytorch_imagenet_resnet50.py",
     ["--width", "16", "--image-size", "64", "--batch-size", "8",
      "--epochs", "1", "--steps-per-epoch", "2", "--batches-per-allreduce",
      "2"], "img/sec total"),
    ("elastic", ["--min-np", "1", "--max-np", "1"],
     "pytorch_elastic_train.py", ["--epochs", "2", "--batches-per-epoch",
                                  "2"], "done: epochs=2"),
    ("gpt", [], "gpt_train.py", ["--steps", "3", "--batch", "4", "--seq",
                                 "256"], "step 2: loss"),
    ("long_context", [], "long_context_train.py", LONG_CONTEXT_ARGV,
     "flash=on"),
    ("long_context_plain", [], "long_context_train.py",
     LONG_CONTEXT_ARGV + ["--no-flash"], "flash=off"),
    ("adasum", [], "adasum_train.py", ["--steps", "600"], "step  599"),
]
OPTIONAL_EXAMPLES = [("ray", "ray", "ray_train.py"),
                     ("spark", "pyspark", "spark_train.py"),
                     ("spark_estimator", "pyspark", "spark_estimator.py")]
REPO = os.path.dirname(os.path.abspath(__file__))


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters, warmup=2):
    """(device ms, host ms) per call of ``fn()`` over ``iters`` back-to-back
    calls. Device time by CUDA events; a sleep kernel queued first keeps
    the card busy while the host queues the calls, so a call whose Python
    wrapper takes longer than its kernel is still timed on the device.
    Host time is the queueing alone, without a sync."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_s * 1e3 / iters


def host_issue(run, calls=3):
    """How the host and the card share ``calls`` calls of ``run()``, each
    of which issues one step or update and ends in no sync of its own:
    the host ms until ``run()`` returns, the ms the card still needs after
    that, and the synchronizing calls that torch.cuda's sync debug mode
    saw inside. Were the card behind the host, the queued kernels would
    show as a long drain; a short one means the card kept pace, so the
    call's time is the host's."""
    import warnings

    import torch

    issue, drain, syncs = [], [], 0
    for _ in range(calls):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                run()
                t1 = time.perf_counter()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        issue.append((t1 - t0) * 1e3)
        drain.append((t2 - t1) * 1e3)
        syncs += len(caught)
    return {"host_issue_ms": issue, "drain_ms": drain,
            "host_issue_ms_median": statistics.median(issue),
            "drain_ms_median": statistics.median(drain),
            "syncs_inside": syncs / calls}


def work(name, b, s, h, h_kv, d, dtype, causal, out_dtype):
    """(FLOPs, bytes) of one kernel's work at this shape: each input read
    once, each output written once (o and dO in ``out_dtype``); FLOPs of
    the visible (q, k) pairs."""
    size = {"bfloat16": 2, "float16": 2, "float32": 4}
    item = size[dtype]
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    q_bytes, kv_bytes, vec = b * s * h * d * item, b * s * h_kv * d * item, \
        b * h * s * 4
    o_bytes = q_bytes // item * size[out_dtype]
    name = name.replace("_sm90", "")   # both designs do the same work
    flops = {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8}[name] * d * pairs
    nbytes = {"flash_fwd": q_bytes + o_bytes + 2 * kv_bytes + vec,
              "flash_dq": 2 * q_bytes + o_bytes + 2 * kv_bytes + 2 * vec,
              "flash_dkv": q_bytes + o_bytes + 4 * kv_bytes + 2 * vec}[name]
    return flops, nbytes


def bound(name, b, s, h, h_kv, d, dtype, causal, out_dtype, passes=1):
    """(bound_ms, bound_by) for one kernel's work at this shape (``work``)
    with ``passes`` times its products (3 for the 3xTF32 split)."""
    flops, nbytes = work(name, b, s, h, h_kv, d, dtype, causal, out_dtype)
    t_ops = passes * flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def route_launches(K, q):
    """{kernel: 1} for the kernel of each base that q's route takes."""
    return {K._kernel(base, q, None): 1 for base in BASES}


def ptxas_summary(log):
    """One line per compiled kernel from nvcc's -Xptxas -v output:
    'mangled name: registers; stack and spills', plus any ptxas warning
    that a wgmma product was serialised."""
    lines, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "bytes stack frame" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            used = line.split("Used", 1)[1].split(",")[0].strip()
            lines.append(f"{name}: {used}; {spills}")
        elif "C7520" in line or "serialized" in line:
            lines.append(line.strip())
    return lines


def _least(got, want):
    """The least tol for which |got - want| <= tol (1 + |want|) holds."""
    diff = (got.float() - want.float()).abs()
    return float((diff / (1 + want.float().abs())).max())


def check(tag, got, want, tol):
    """Fail unless |got - want| <= tol (1 + |want|) everywhere. Returns
    (max abs err, max abs err / max |want|, the least tol that holds)."""
    import torch

    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        fail(f"{tag}: shape {tuple(got.shape)} vs {tuple(want.shape)} or "
             f"non-finite values")
    err = float((got.float() - want.float()).abs().max())
    rel = err / max(float(want.float().abs().max()), 1e-30)
    need = _least(got, want)
    try:
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    except AssertionError as e:
        fail(f"{tag}: max abs err {err:.3g} > tol {tol}: {e}")
    return err, rel, need


# flash_dq_sm90's and flash_dkv_sm90's least tolerance against the
# fp32-operand plain version at MAIN_SHAPE (bf16) and FP16_MAIN_SHAPE, once
# their kernels phase has run: {(kernel, dtype name): least}
MAIN_LEAST = {}
# a ring block's fixed limit by q's dtype (bf16: TOL_DQ_RING, TOL_DKV_RING)
MAIN_SHAPES = {"bfloat16": MAIN_SHAPE, "float16": FP16_MAIN_SHAPE}


def _fixed_ring_limit(name, dtype_name):
    if dtype_name == "float16":
        return TOL_FP16_FP32_OPERANDS
    return TOL_DQ_RING if name == "flash_dq_sm90" else TOL_DKV_RING


def _ring_limit(fixed, main, floor, one):
    """The least tolerance a ring block's kernel must keep against the
    fp32-operand plain version: under ``fixed`` and the main shape's where
    the block's two-term plain version reads ``floor`` under both; else
    under the midpoint of ``floor`` and the one-term plain version's reading
    ``one`` (TOL_DKV_RING's comment)."""
    bound = fixed if main is None else min(fixed, main)
    return bound if floor <= bound else (floor + one) / 2


def dq_ring_checks(case, K, args, got, two_term, least, fp32_operands):
    """At MAIN_SHAPE (FP16_MAIN_SHAPE) record flash_dq_sm90's least
    tolerance against the fp32-operand plain version; at a ring block (bf16
    or fp16 q, fp32 dO) hold it to TOL_DQ_RING (TOL_FP16_FP32_OPERANDS) and
    to the main shape's of its dtype (_ring_limit), and hold the kernel's
    dq nearer the plain version that takes dO as two terms of q's dtype
    than the one that rounds it to one: a kernel that dropped dO's lo term
    passes TOL_PLAIN and TOL_DQ_FP32_OPERANDS alike."""
    name, dtype_name = "flash_dq_sm90", case[5]
    if case == MAIN_SHAPES.get(dtype_name):
        MAIN_LEAST[name, dtype_name] = least
    if case not in RING_CHECKED:
        return
    q, k, v, do, *rest = args
    one_term = K.flash_dq_plain(q, k, v, do.to(q.dtype), *rest,
                                round_ds=True)
    near = float((got.float() - two_term.float()).norm())
    far = float((got.float() - one_term.float()).norm())
    main = MAIN_LEAST.get((name, dtype_name))
    floor = _least(two_term, fp32_operands)
    one = _least(one_term, fp32_operands)
    fixed = _fixed_ring_limit(name, dtype_name)
    limit = _ring_limit(fixed, main, floor, one)
    emit({"phase": "kernel", "kernel": name, "ring": case,
          "least_tol_vs_fp32_operands": least, "limit": limit,
          "fixed_limit": fixed, "main_shape_least_tol": main,
          "two_term_plain_least_tol": floor,
          "one_term_plain_least_tol": one, "norm_to_two_terms": near,
          "norm_to_one_term": far})
    if least > limit:
        fail(f"flash_dq_sm90 at the ring block {case}: least tolerance "
             f"{least:.4g} against the fp32-operand plain version, over "
             f"{limit:.4g} (fixed {fixed}, the main shape's "
             f"{main}, the two-term plain version's {floor:.4g})")
    if not near < RING_NEARER * far:
        fail(f"flash_dq_sm90 at the ring block {case}: dq is {near:.4g} "
             f"from the two-term plain version and {far:.4g} from the "
             f"one-term one (dO's lo term dropped?)")


def dkv_ring_checks(case, K, args, got, two_term, least, fp32_operands):
    """dq_ring_checks for flash_dkv_sm90: at MAIN_SHAPE (FP16_MAIN_SHAPE)
    record its least tolerance against the fp32-operand plain version; at a
    ring block hold it to TOL_DKV_RING (TOL_FP16_FP32_OPERANDS) and to the
    main shape's of its dtype (_ring_limit), and hold dk and dv each nearer
    the plain version that takes dO as two terms of q's dtype than the one
    that rounds it to one, by RING_NEARER in the Frobenius norm."""
    name, dtype_name = "flash_dkv_sm90", case[5]
    if case == MAIN_SHAPES.get(dtype_name):
        MAIN_LEAST[name, dtype_name] = least
    if case not in RING_CHECKED:
        return
    q, k, v, do, *rest = args
    one_term = dict(zip(("dk", "dv"), K.flash_dkv_plain(
        q, k, v, do.to(q.dtype), *rest, round_operands=True)))
    norms = {n: (float((got[n].float() - two_term[n].float()).norm()),
                 float((got[n].float() - one_term[n].float()).norm()))
             for n in ("dk", "dv")}
    main = MAIN_LEAST.get((name, dtype_name))
    floor = max(_least(two_term[n], fp32_operands[n]) for n in ("dk", "dv"))
    one = max(_least(one_term[n], fp32_operands[n]) for n in ("dk", "dv"))
    fixed = _fixed_ring_limit(name, dtype_name)
    limit = _ring_limit(fixed, main, floor, one)
    emit({"phase": "kernel", "kernel": name, "ring": case,
          "least_tol_vs_fp32_operands": least, "limit": limit,
          "fixed_limit": fixed, "main_shape_least_tol": main,
          "two_term_plain_least_tol": floor,
          "one_term_plain_least_tol": one,
          "norm_to_two_terms": {n: nf[0] for n, nf in norms.items()},
          "norm_to_one_term": {n: nf[1] for n, nf in norms.items()}})
    if least > limit:
        fail(f"{name} at the ring block {case}: least tolerance "
             f"{least:.4g} against the fp32-operand plain version, over "
             f"{limit:.4g} (fixed {fixed}, the main shape's "
             f"{main}, the two-term plain version's {floor:.4g})")
    for n, (near, far) in norms.items():
        if not near < RING_NEARER * far:
            fail(f"{name} at the ring block {case}: {n} is {near:.4g} from "
                 f"the two-term plain version and {far:.4g} from the "
                 f"one-term one (dO's lo term dropped?)")


def fp16_magnitude_checks(case, K, inputs, ro, rlse, scale):
    """At an fp16 ring block (fp16 q, fp32 dO), or an fp16 case at the
    widest heads (XWIDE_FP16_MAGNITUDE_CASE, dO in fp16), run flash_dq_sm90 and
    flash_dkv_sm90 with dO times 1 and each of FP16_DOUT_MAGNITUDES and hold
    each output's error against the fp32-operand plain version, relative to
    its largest magnitude, to FP16_MAGNITUDE_FACTOR times its error at
    magnitude 1 plus fp16's subnormal step at that magnitude (the comment at
    FP16_DOUT_MAGNITUDES); nothing inf or NaN where the plain version's
    output is finite."""
    import torch

    q, k, v, do = inputs
    causal = case[6]
    errs = {}
    for m in (1.0, *FP16_DOUT_MAGNITUDES):
        dom = do * m
        delta = (dom * ro.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, dom, rlse, delta, scale, causal)
        got = dict(zip(("dq", "dk", "dv"),
                       (K.flash_dq(*args), *K.flash_dkv(*args))))
        want = dict(zip(("dq", "dk", "dv"),
                        (K.flash_dq_plain(*args), *K.flash_dkv_plain(*args))))
        for n in got:
            g, w = got[n].float(), want[n].float()
            fin = torch.isfinite(w)
            if not bool(torch.isfinite(g[fin]).all()):
                fail(f"fp16 ring block {case}: {n} at dO x {m:g} has inf or "
                     f"NaN where the fp32-operand plain version is finite")
            top = float(w[fin].abs().max())
            errs[m, n] = {"rel_err": float((g - w)[fin].abs().max()) / top,
                          "largest": top, "floor": 2.0 ** -24 / top,
                          "plain_nonfinite": int((~fin).sum())}
    limits = {(m, n): FP16_MAGNITUDE_FACTOR * errs[1.0, n]["rel_err"]
              + e["floor"] for (m, n), e in errs.items()}
    emit({"phase": "kernel", "fp16_ring_magnitudes": case,
          "vs": "plain version with fp32 operands",
          "errors": {f"{n}@{m:g}": {**e, "limit": limits[m, n]}
                     for (m, n), e in errs.items()}})
    for key, e in errs.items():
        if e["rel_err"] > limits[key]:
            fail(f"fp16 ring block {case}: {key[1]} at dO x {key[0]:g} is "
                 f"{e['rel_err']:.4g} of its largest magnitude from the "
                 f"fp32-operand plain version, over {limits[key]:.4g}")


def kernel_phase(case, K, ref_fn, timings):
    """Hold the kernels that take this shape against their plain versions
    and autograd of the reference: each kernel's route and, where that
    reaches a tensor-core kernel, the SIMT design too. At a TIMED shape,
    time every kernel that ran, into timings[name][shape]."""
    import torch
    import torch.nn.functional as F

    b, s, h, h_kv, d, dtype_name, causal, out_name = case
    dtype, out_dtype = getattr(torch, dtype_name), getattr(torch, out_name)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    q, k, v = (torch.randn(b, s, n, d, generator=gen, device="cuda")
               .to(dtype) for n in (h, h_kv, h_kv))
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(out_dtype)
    dlse = torch.randn(b, s, h, generator=gen, device="cuda")
    scale = d ** -0.5
    tol = TOL_PLAIN[dtype_name]
    two_byte = dtype in (torch.bfloat16, torch.float16)
    shape = {"B": b, "S": s, "H": h, "H_kv": h_kv, "D": d,
             "dtype": dtype_name, "causal": causal, "o": out_name}
    route = route_launches(K, q)
    # None: each kernel's own route; every route reaches an sm90 kernel. The
    # SIMT design takes fp32 and bf16 with head_dim up to 128
    variants = ((None, "simt") if d <= K.SIMT_MAX_HEAD_DIM
                and dtype != torch.float16 else (None,))

    # both designs get the same inputs: the backward starts from the plain
    # forward's o and lse
    ro, rlse = K.flash_fwd_plain(q, k, v, scale, causal, out_dtype)
    delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, rlse, delta, scale, causal)
    fp32_operands = {"dq": K.flash_dq_plain(*args),
                     **dict(zip(("dk", "dv"), K.flash_dkv_plain(*args)))}
    errs, rounds = {}, {}
    for variant in variants:
        fwd, dqn, dkv = (K._kernel(base, q, variant) for base in BASES)
        # the kernels that round operands to q's dtype where the TPU
        # kernels keep fp32: sm90 dq and dkv on bf16 and fp16 inputs
        rounds[dqn] = dqn.endswith("_sm90") and two_byte
        rounds[dkv] = dkv.endswith("_sm90") and two_byte
        before = dict(K.LAUNCHES)
        o, lse = K.flash_fwd(q, k, v, scale, causal, out_dtype,
                             variant=variant)
        got = {"dq": K.flash_dq(*args, variant=variant),
               **dict(zip(("dk", "dv"), K.flash_dkv(*args, variant=variant)))}
        torch.cuda.synchronize()
        ran = {n: K.LAUNCHES[n] - before[n] for n in before
               if K.LAUNCHES[n] != before[n]}
        want_ran = {fwd: 1, dqn: 1, dkv: 1}
        if variant is None and ran != route:
            fail(f"kernels at {shape}: the route launched {ran}, expected "
                 f"{route}")
        if ran != want_ran:
            fail(f"kernels at {shape}: variant {variant} launched {ran}, "
                 f"expected {want_ran}")
        errs[fwd] = [check(f"{fwd} o", o, ro, tol),
                     check(f"{fwd} lse", lse, rlse, 1e-4)]
        if not torch.equal(K.flash_dq(*args, variant=variant), got["dq"]):
            fail(f"{dqn}: a second launch on the same inputs gave other bits")
        want = {"dq": K.flash_dq_plain(*args, split_dout=rounds[dqn],
                                       round_ds=rounds[dqn]),
                **dict(zip(("dk", "dv"), K.flash_dkv_plain(
                    *args, split_dout=rounds[dkv],
                    round_operands=rounds[dkv])))}
        for name, outs in ((dqn, ("dq",)), (dkv, ("dk", "dv"))):
            errs[name] = [check(f"{name} {n}", got[n], want[n], tol)
                          for n in outs]
            if not rounds[name]:
                continue
            tol32 = (TOL_FP16_FP32_OPERANDS if dtype == torch.float16
                     else TOL_DQ_FP32_OPERANDS if name == dqn
                     else TOL_DKV_FP32_OPERANDS)
            vs32 = [check(f"{name} {n} vs fp32 operands", got[n],
                          fp32_operands[n], tol32) for n in outs]
            least = max(e[2] for e in vs32)
            emit({"phase": "kernel", "kernel": name, "shape": shape,
                  "vs": f"plain version with fp32 {ROUNDED[name]} operands",
                  "max_abs_err": max(e[0] for e in vs32),
                  "max_rel_err": max(e[1] for e in vs32),
                  "least_tol": least, "tol": tol32})
            if name == dqn:
                dq_ring_checks(case, K, args, got["dq"], want["dq"], least,
                               fp32_operands["dq"])
            else:
                dkv_ring_checks(case, K, args, got, want, least,
                                fp32_operands)
        del o, lse, got, want
    if case in FP16_RING_CASES or case == XWIDE_FP16_MAGNITUDE_CASE:
        fp16_magnitude_checks(case, K, (q, k, v, do), ro, rlse, scale)
    for name, found in errs.items():
        emit({"phase": "kernel", "kernel": name, "shape": shape,
              "on_route": name in route,
              "vs": "plain version" + (f" with {dtype_name} {ROUNDED[name]} "
                                       "operands" if rounds.get(name) else ""),
              "max_abs_err": max(e[0] for e in found),
              "max_rel_err": max(e[1] for e in found),
              "least_tol": max(e[2] for e in found), "tol": tol})

    # end to end through autograd, with cotangents on o and on lse (the
    # ring's logaddexp merge differentiates through lse, so delta =
    # rowsum(dO∘O) - dlse): kernels vs autograd of the reference
    from horovod_tpu_torch.ops.flash_attention import \
        flash_attention_with_lse
    tol_ag = TOL_AUTOGRAD[dtype_name]
    grads = {}
    for label, fn in (("kernels", flash_attention_with_lse),
                      ("reference", ref_fn)):
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        out, lse = fn(*leaves, causal=causal, scale=scale,
                      out_dtype=out_dtype)
        ((out.float() * do.float()).sum() + (lse * dlse).sum()).backward()
        grads[label] = [out.detach(), lse.detach()] + [x.grad for x in leaves]
    ag = [check(f"autograd {n}", a, r, 1e-4 if n == "lse" else tol_ag)
          for n, a, r in zip(("o", "lse", "dq", "dk", "dv"),
                             grads["kernels"], grads["reference"])]
    emit({"phase": "autograd", "shape": shape, "route": sorted(route),
          "vs": "autograd of flash_attention_reference, cotangents on o "
                "and lse",
          "max_abs_err": max(e[0] for e in ag),
          "max_rel_err": max(e[1] for e in ag),
          "least_tol": max(e[2] for e in ag), "tol": tol_ag})
    del grads

    if case not in TIMED:
        return
    # SDPA takes [B, H, S, D]; its K/V carry the full head count
    qh = q.transpose(1, 2).contiguous()
    kh = k.repeat_interleave(h // h_kv, 2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(h // h_kv, 2).transpose(1, 2).contiguous()
    doh = do.transpose(1, 2).contiguous()
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=causal, scale=scale), 20)[0]
    leaves = [x.detach().requires_grad_() for x in (qh, kh, vh)]
    # the backend PyTorch's dispatch picks for these inputs (its flash
    # backend stops at head_dim 256)
    sdpa_backend = torch.nn.attention.SDPBackend(torch._fused_sdp_choice(
        *leaves, is_causal=causal, scale=scale)).name

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                             scale=scale)
        torch.autograd.grad(out, leaves, doh)

    sdpa_pair = cuda_ms(sdpa_fwd_bwd, 20)[0]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                         scale=scale)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, doh,
                                                   retain_graph=True), 20)[0]
    del out
    # a head_dim off the grid: the kernels timed on inputs padded once (the
    # wrappers then copy nothing), the wrappers' copies (the padded inputs
    # and the outputs cut back) timed apart
    dp = K.padded_head_dim(d)
    kq, kk, kv, kdo = (K.pad_head_dim(t, dp) for t in (q, k, v, do))
    kargs = (kq, kk, kv, kdo, *args[4:])
    # fp16: dO's largest magnitude, taken once for dq and dkv as the
    # autograd Function takes it, and timed apart
    amax = K.dout_amax(do) if dtype == torch.float16 else None
    amax_ms = (cuda_ms(lambda: K.dout_amax(do), 20)[0]
               if amax is not None else None)
    pad_ms = {}
    if dp != d:
        def copies(ins, outs):
            wide = [K.pad_head_dim(t, dp) for t in outs]
            return cuda_ms(lambda: ([K.pad_head_dim(t, dp) for t in ins],
                                    [t[..., :d].contiguous() for t in wide]),
                           20)[0]

        pad_ms = {"flash_fwd": copies((q, k, v), (do,)),
                  "flash_dq": copies((q, k, v, do), (q,)),
                  "flash_dkv": copies((q, k, v, do), (k, v))}
    timed = {}
    for variant in variants:
        timed[K._kernel("flash_fwd", q, variant)] = (
            lambda vr=variant: K.flash_fwd(kq, kk, kv, scale, causal,
                                           out_dtype, variant=vr),
            lambda: K.flash_fwd_plain(q, k, v, scale, causal, out_dtype),
            sdpa_fwd)
        # dq and dkv: SDPA's backward alone (on a retained graph), the one
        # call that computes them
        dqn, dkv = (K._kernel(base, q, variant) for base in BASES[1:])
        timed[dqn] = (
            lambda vr=variant: K.flash_dq(*kargs, variant=vr,
                                          dout_amax=amax),
            lambda r=rounds[dqn]: K.flash_dq_plain(*args, split_dout=r,
                                                   round_ds=r),
            sdpa_bwd)
        timed[dkv] = (
            lambda vr=variant: K.flash_dkv(*kargs, variant=vr,
                                           dout_amax=amax),
            lambda r=rounds[dkv]: K.flash_dkv_plain(*args, split_dout=r,
                                                    round_operands=r),
            sdpa_bwd)
    for name, (kern, plain, lib) in timed.items():
        bound_ms, bound_by = bound(name, b, s, h, h_kv, d, dtype_name,
                                   causal, out_name)
        ms, host_ms = cuda_ms(kern, 20)
        # the instance that ran: its registers and shared memory a block
        regs, smem = K.launch_attributes(name)
        record = {"shape": shape, "on_route": name in route,
                  "registers": regs, "smem_bytes": smem,
                  "max_abs_err": max(e[0] for e in errs[name]),
                  "ms": ms, "plain_ms": cuda_ms(plain, 5)[0],
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "library_ms": lib, "library_backend": sdpa_backend}
        if pad_ms:   # the kernel at the padded head_dim; its copies apart
            record["padded_head_dim"] = dp
            record["pad_copies_ms"] = pad_ms[name.replace("_sm90", "")]
        if amax is not None and not name.startswith("flash_fwd"):
            # dO's largest magnitude, one reduction shared by dq and dkv
            record["dout_amax_ms"] = amax_ms
        if dtype == torch.float32:   # the split's three TF32 products
            record["bound_3xtf32_ms"] = bound(name, b, s, h, h_kv, d,
                                              dtype_name, causal, out_name,
                                              passes=3)[0]
            record["x_bound_3xtf32"] = ms / record["bound_3xtf32_ms"]
        timings.setdefault(name, {})[case] = record
        emit({"phase": "timing", "kernel": name, **record,
              "wrapper_host_ms": host_ms,
              "library": "scaled_dot_product_attention "
                         + ("forward" if name.startswith("flash_fwd")
                            else "backward on a retained graph")
                         + f" in {dtype_name}",
              "library_forward_backward_ms": sdpa_pair})


def main_path(hvt, K):
    """The port's GPT training step at full width, through the entry point
    a user calls (``horovod_tpu_torch.train.train``). Returns the launch
    count of each kernel and the trained model and optimizer."""
    import dataclasses

    import torch

    from horovod_tpu_torch.train import gpt_config, train

    hvt.init()                  # a one-process NCCL world on cuda:0
    cfg = gpt_config("bench", use_flash=True, dtype=torch.bfloat16)
    batch, seq, steps = (MAIN_SHAPE[0], cfg.max_seq_len,
                         STEPS_WARMUP + STEPS_TIMED)
    dtype_name = str(cfg.dtype).split(".")[1]
    attn = (batch, seq, cfg.n_heads, cfg.n_kv_heads or cfg.n_heads,
            cfg.d_model // cfg.n_heads, dtype_name, True, dtype_name)
    if attn != MAIN_SHAPE or cfg.n_layers != MAIN_LAYERS:
        fail(f"main path: attention shape {attn} is not {MAIN_SHAPE} or "
             f"{cfg.n_layers} layers are not {MAIN_LAYERS}")

    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    res = train(cfg, steps, batch, seq, seed=0)
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    losses = res["loss"]
    per_step = cfg.n_layers
    on_path = {base + ("_sm90" if K._variant(
        base, cfg.dtype, cfg.d_model // cfg.n_heads) == "sm90" else "")
        for base in BASES}
    for name, n in launches.items():
        want = per_step * steps if name in on_path else 0
        if n != want:
            fail(f"{name} launched {n} times in {steps} steps, expected "
                 f"{want // steps} a step")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall on the repeated batch: {losses}")
    step_s = statistics.median(res["step_s"][STEPS_WARMUP:])
    emit({"phase": "main_path", "config": "bench.py --model gpt --flash",
          "batch": batch, "seq": seq, "world_size": hvt.size(),
          "losses": losses, "step_s": res["step_s"][STEPS_WARMUP:],
          "step_ms_median": step_s * 1e3,
          "tokens_per_s": batch * seq / step_s,
          "max_memory_allocated_bytes": peak,
          "launches": launches, "launches_per_step": per_step})

    # the einsum-attention model from the same seed starts from the same
    # weights and sees the same tokens: its losses follow the flash ones.
    # The first loss checks the forward; the last, after 6 AdamW steps on
    # each path's own gradients, checks dq, dk and dv as well.
    before = dict(K.LAUNCHES)
    einsum = train(dataclasses.replace(cfg, use_flash=False), steps, batch,
                   seq, seed=0)
    if dict(K.LAUNCHES) != before:
        fail("the einsum-attention step launched flash kernels")
    rels = [abs(einsum["loss"][i] - losses[i]) / abs(losses[i])
            for i in range(steps)]
    emit({"phase": "einsum_vs_flash", "flash_losses": losses,
          "einsum_losses": einsum["loss"], "rel_diff": rels,
          "rtol": LOSS_RTOL, "einsum_step_ms_median":
          statistics.median(einsum["step_s"][STEPS_WARMUP:]) * 1e3})
    for i in (0, steps - 1):
        if rels[i] > LOSS_RTOL:
            fail(f"step {i + 1}: einsum loss {einsum['loss'][i]} vs flash "
                 f"loss {losses[i]}: rel diff {rels[i]:.3g} > {LOSS_RTOL}")
    del einsum
    return (launches, res["model"], res["optimizer"], cfg, batch, seq, step_s,
            losses)


def entry_phase(K):
    """The repo's entry model with flash attention at fp32 and bf16
    (module docstring, phase 24). Returns the launches of both runs."""
    import dataclasses

    import torch

    from horovod_tpu_torch.train import gpt_config, train

    launches = {}
    for dtype in (torch.float32, torch.bfloat16):
        dtype_name = str(dtype).split(".")[1]
        cfg = gpt_config("entry", use_flash=True, dtype=dtype)
        d = cfg.d_model // cfg.n_heads
        seq, steps = cfg.max_seq_len, ENTRY_STEPS
        K.reset_launches()
        res = train(cfg, steps, ENTRY_BATCH, seq, seed=0, lr=1e-3)
        ran = dict(K.LAUNCHES)
        launches.update({f"{n}@{dtype_name}": c for n, c in ran.items()})
        q = torch.empty(1, 1, cfg.n_heads, d, dtype=dtype, device="meta")
        want = {n: cfg.n_layers * steps
                for n in route_launches(K, q)}
        if not all(n.endswith("_sm90") for n in want) or \
                {n: c for n, c in ran.items() if c} != want:
            fail(f"entry {dtype_name}: launched {ran}, expected {want}")
        losses = res["loss"]
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            fail(f"entry {dtype_name}: losses {losses} are not finite and "
                 f"falling")
        before = dict(K.LAUNCHES)
        einsum = train(dataclasses.replace(cfg, use_flash=False), steps,
                       ENTRY_BATCH, seq, seed=0, lr=1e-3)
        if dict(K.LAUNCHES) != before:
            fail("entry: the einsum-attention step launched flash kernels")
        rels = [abs(a - e) / abs(e) for a, e in zip(losses, einsum["loss"])]
        emit({"phase": "entry", "dtype": dtype_name, "head_dim": d,
              "batch": ENTRY_BATCH, "seq": seq, "losses": losses,
              "einsum_losses": einsum["loss"], "rel_diff": rels,
              "rtol": ENTRY_RTOL[dtype_name], "launches": ran,
              "step_ms_median": statistics.median(res["step_s"][1:]) * 1e3,
              "einsum_step_ms_median":
              statistics.median(einsum["step_s"][1:]) * 1e3})
        if max(rels) > ENTRY_RTOL[dtype_name]:
            fail(f"entry {dtype_name}: flash losses {losses} are not within "
                 f"{ENTRY_RTOL[dtype_name]} of the einsum model's "
                 f"{einsum['loss']}")
        del res, einsum
    return launches


def flash_model_phase(K, phase, cfg, batch, steps, rtol, instances):
    """``cfg``'s GPT (flash attention) through train.train, ``steps`` steps
    on a seeded batch of ``batch`` x cfg.max_seq_len, and its einsum model
    from the same seed: each kernel of q's route once a layer a step and no
    other (every launch with q and o in cfg.dtype), the einsum attention
    never in the flash run, and the einsum model's losses within ``rtol``
    at steps 1 and ``steps``; step ms and peak memory of both. Returns the
    launches."""
    import dataclasses

    import torch

    from horovod_tpu_torch.models import transformer
    from horovod_tpu_torch.train import train

    d = cfg.d_model // cfg.n_heads
    seq = cfg.max_seq_len
    dtype_name = str(cfg.dtype).split(".")[1]
    # the einsum path's one call of its own, counted for both runs; and the
    # dtypes of q and o (dO) at each launch
    einsum_calls, instance_launches = [], {}
    repeat_kv, run = transformer._repeat_kv, K._run

    def counted(*args):
        einsum_calls.append(1)
        return repeat_kv(*args)

    def typed_run(name, tensors, q, k, scale, causal, second_dtype):
        key = "{}@{}/{}".format(name, *(str(t).split(".")[1]
                                        for t in (q.dtype, second_dtype)))
        instance_launches[key] = instance_launches.get(key, 0) + 1
        return run(name, tensors, q, k, scale, causal, second_dtype)

    transformer._repeat_kv, K._run = counted, typed_run
    try:
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        res = train(cfg, steps, batch, seq, seed=0)
        launches = dict(K.LAUNCHES)
        flash_einsum = len(einsum_calls)
        peak = torch.cuda.max_memory_allocated()
        del res["model"], res["optimizer"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        einsum = train(dataclasses.replace(cfg, use_flash=False), steps,
                       batch, seq, seed=0)
        einsum_launches = {n: c for n, c in K.LAUNCHES.items() if c}
        einsum_peak = torch.cuda.max_memory_allocated()
        del einsum["model"], einsum["optimizer"]
        torch.cuda.empty_cache()
    finally:
        transformer._repeat_kv, K._run = repeat_kv, run
    route = route_launches(K, torch.empty(1, 1, cfg.n_heads, d,
                                          dtype=cfg.dtype, device="meta"))
    want = {n: cfg.n_layers * steps if n in route else 0 for n in launches}
    want_instances = {f"{n}@{dtype_name}/{dtype_name}": cfg.n_layers * steps
                      for n in route}
    losses = res["loss"]
    rels = [abs(a - e) / abs(e) for a, e in zip(losses, einsum["loss"])]
    emit({"phase": phase, "config": {
              **{f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg)
                 if f.name not in ("dtype", "ring_mesh")},
              "dtype": dtype_name},
          "batch": batch, "seq": seq, "head_dim": d,
          "instances": instances, "losses": losses,
          "einsum_losses": einsum["loss"], "rel_diff": rels, "rtol": rtol,
          "launches": launches, "launches_by_dtype": instance_launches,
          "einsum_attention_calls": flash_einsum,
          "step_ms_median":
          statistics.median(res["step_s"][STEPS_WARMUP:]) * 1e3,
          "einsum_step_ms_median":
          statistics.median(einsum["step_s"][STEPS_WARMUP:]) * 1e3,
          "max_memory_allocated_bytes": peak,
          "einsum_max_memory_allocated_bytes": einsum_peak})
    if launches != want or instance_launches != want_instances:
        fail(f"{phase}: launched {launches} ({instance_launches}), expected "
             f"{want} ({want_instances})")
    if not all(n.endswith("_sm90") for n in route):
        fail(f"{phase}: the route {route} reaches a SIMT kernel")
    if flash_einsum:
        fail(f"{phase}: the flash model ran the einsum attention "
             f"{flash_einsum} times")
    if einsum_launches or len(einsum_calls) != cfg.n_layers * steps:
        fail(f"{phase}: the einsum model launched {einsum_launches} or "
             f"ran its attention {len(einsum_calls)} times")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"{phase}: losses {losses} are not finite and falling")
    for i in (0, steps - 1):
        if rels[i] > rtol:
            fail(f"{phase} step {i + 1}: einsum loss {einsum['loss'][i]} "
                 f"vs flash loss {losses[i]}: rel diff {rels[i]:.3g} > "
                 f"{rtol}")
    return launches


def wide_head_phase(K, dtype_name="bfloat16"):
    """A GPT with Gemma-2B's attention widths (module docstring, phases 25
    and 27) in ``dtype_name`` through train.train with use_flash="auto":
    the head_dim-256 instances of the three sm90 kernels once a layer a
    step, no einsum attention, and the einsum model's losses from the same
    seed within LOSS_RTOL (bf16) or ENTRY_RTOL's fp32 tolerance at steps 1
    and WIDE_HEAD_STEPS. Returns the launches."""
    import torch

    from horovod_tpu_torch.models.transformer import GPTConfig

    bf16 = dtype_name == "bfloat16"
    cfg = GPTConfig(**WIDE_HEAD_CONFIG, dtype=getattr(torch, dtype_name),
                    use_flash="auto")
    return flash_model_phase(
        K, {"bfloat16": "wide_head", "float32": "wide_head_fp32"}[dtype_name],
        cfg, WIDE_HEAD_BATCH, WIDE_HEAD_STEPS,
        LOSS_RTOL if bf16 else ENTRY_RTOL[dtype_name],
        "flash_{fwd,dq,dkv}_sm90 at padded width 256, D 256"
        + ("" if bf16 else ", 3xTF32"))


def head512_phase(K, dtype_name="bfloat16"):
    """WIDE_HEAD_CONFIG's GPT with four heads of 512 (module docstring,
    phases 29 and 30) in ``dtype_name`` (bf16 or fp16 compute, fp32
    parameters) through train.train with use_flash="auto": the
    padded-width-512 instances of the three sm90 kernels once a layer a
    step, no einsum attention, and the einsum model's losses from the same
    seed within LOSS_RTOL at steps 1 and WIDE_HEAD_STEPS. Returns the
    launches."""
    import torch

    from horovod_tpu_torch.models.transformer import GPTConfig

    cfg = GPTConfig(**HEAD512_CONFIG, dtype=getattr(torch, dtype_name),
                    use_flash="auto")
    return flash_model_phase(
        K, {"bfloat16": "head512", "float16": "head512_fp16"}[dtype_name],
        cfg, WIDE_HEAD_BATCH, WIDE_HEAD_STEPS, LOSS_RTOL,
        "flash_{fwd,dq,dkv}_sm90 at padded width 512, D 512 (column halves)"
        + (", dO scaled by a power of two" if dtype_name == "float16"
           else ""))


def gpt_fp16_phase(K):
    """The main path's GPT (bench.py --model gpt --flash: vocab 32768, 12
    layers, d_model 768, 12 heads of 64, d_ff 3072, seq 1024, batch 8) in
    fp16 compute with fp32 parameters and no loss scaler, as the JAX
    package's GPT runs fp16, through train.train (module docstring, phase
    28). Returns the launches."""
    import torch

    from horovod_tpu_torch.train import gpt_config

    cfg = gpt_config("bench", use_flash=True, dtype=torch.float16)
    if (MAIN_SHAPE[0], cfg.max_seq_len, cfg.n_heads, cfg.d_model // cfg.n_heads,
            cfg.n_layers) != (8, 1024, 12, 64, MAIN_LAYERS):
        fail(f"gpt_fp16: the bench GPT is not the main path's: {cfg}")
    return flash_model_phase(
        K, "gpt_fp16", cfg, MAIN_SHAPE[0], STEPS_WARMUP + STEPS_TIMED,
        LOSS_RTOL, "flash_{fwd,dq,dkv}_sm90 in fp16 at D 64 (.f16 wgmma, "
        "dO scaled by a power of two)")


def ring_model(cfg, steps, batch, seq):
    """``cfg``'s GPT under a ring mesh of this one process (sp 1: each
    layer's attention is one diagonal ring block) through the entry points
    a user calls (GPT(cfg, mesh=...), train.make_parallel_train_step, AdamW
    as train.train's), ``steps`` steps on train.train's seeded batch.
    Returns (losses, step seconds, the ring blocks run by each route)."""
    import dataclasses

    import torch

    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.parallel import sequence
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh
    from horovod_tpu_torch.train import make_parallel_train_step, \
        seeded_tokens

    mesh = make_parallel_mesh(dp=1, sp=1, tp=1)
    cfg = dataclasses.replace(cfg, ring_mesh=mesh)
    model = GPT(cfg, device=basics.device(), mesh=mesh, seed=0)
    step = make_parallel_train_step(model, torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4), mesh)
    tokens = seeded_tokens(cfg, batch, seq, seed=0)
    blocks = {"flash": 0, "einsum": 0}
    real = {n: getattr(sequence, f"{n}_ring_block") for n in blocks}

    def counted(n):
        def block(*args):
            blocks[n] += 1
            return real[n](*args)
        return block

    for n in blocks:
        setattr(sequence, f"{n}_ring_block", counted(n))
    losses, times = [], []
    try:
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(step(tokens)))     # waits for the device
            times.append(time.perf_counter() - t0)
    finally:
        for n in blocks:
            setattr(sequence, f"{n}_ring_block", real[n])
    return losses, times, blocks


def ring_wide_head_phase(hvt, K, ref_fn):
    """Ring attention at the wide heads (module docstring, phase 26): the
    ring's block function over the wide_head attention at sp 2 and sp 4
    (sequence_phase), then the wide_head GPT with a ring mesh of the one
    process and use_flash="auto": its blocks through the fp32-o instances
    of the sm90 kernels once a layer a step and no einsum block, held
    against its einsum ring run within LOSS_RTOL at steps 1 and
    WIDE_HEAD_STEPS. Returns the model's launches and the blocks'."""
    import dataclasses

    import torch

    from horovod_tpu_torch.models.transformer import GPTConfig

    block_launches = sequence_phase(K, ref_fn, WIDE_HEAD_SHAPE,
                                    "ring_wide_head")
    torch.cuda.empty_cache()
    hvt.init()                  # a one-process NCCL world on cuda:0
    cfg = GPTConfig(**WIDE_HEAD_CONFIG, dtype=torch.bfloat16, use_flash="auto")
    d = cfg.d_model // cfg.n_heads
    batch, seq, steps = WIDE_HEAD_BATCH, cfg.max_seq_len, WIDE_HEAD_STEPS
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    losses, times, blocks = ring_model(cfg, steps, batch, seq)
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    K.reset_launches()
    e_losses, e_times, e_blocks = ring_model(
        dataclasses.replace(cfg, use_flash=False), steps, batch, seq)
    einsum_launches = {n: c for n, c in K.LAUNCHES.items() if c}
    per_run = cfg.n_layers * steps
    q = torch.empty(1, 1, cfg.n_heads, d, dtype=cfg.dtype, device="meta")
    want = {n: per_run if n in route_launches(K, q) else 0 for n in launches}
    rels = [abs(a - e) / abs(e) for a, e in zip(losses, e_losses)]
    emit({"phase": "ring_wide_head", "config": {
              **WIDE_HEAD_CONFIG, "dtype": "bfloat16", "use_flash": "auto",
              "ring_mesh": "dp 1 x sp 1 x tp 1"},
          "batch": batch, "seq": seq, "head_dim": d,
          "instances": "flash_{fwd,dq,dkv}_sm90 at padded width 256, "
                       "o and dO fp32",
          "losses": losses, "einsum_losses": e_losses, "rel_diff": rels,
          "rtol": LOSS_RTOL, "launches": launches, "ring_blocks": blocks,
          "einsum_ring_blocks": e_blocks,
          "step_ms_median": statistics.median(times[STEPS_WARMUP:]) * 1e3,
          "einsum_step_ms_median":
          statistics.median(e_times[STEPS_WARMUP:]) * 1e3,
          "step_s": times, "einsum_step_s": e_times,
          "max_memory_allocated_bytes": peak})
    if launches != want:
        fail(f"ring_wide_head: launched {launches}, expected {want}")
    if blocks != {"flash": per_run, "einsum": 0}:
        fail(f"ring_wide_head: use_flash='auto' ran the ring blocks "
             f"{blocks}, expected {per_run} flash blocks and no einsum one")
    if einsum_launches or e_blocks != {"flash": 0, "einsum": per_run}:
        fail(f"ring_wide_head: the einsum ring launched {einsum_launches} "
             f"or ran the blocks {e_blocks}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"ring_wide_head: losses {losses} are not finite and falling")
    for i in (0, steps - 1):
        if rels[i] > LOSS_RTOL:
            fail(f"ring_wide_head step {i + 1}: einsum ring loss "
                 f"{e_losses[i]} vs flash ring loss {losses[i]}: rel diff "
                 f"{rels[i]:.3g} > {LOSS_RTOL}")
    return launches, block_launches


def line_timing(K, name, timings):
    """The timing that stands in the kernels line for kernel ``name``: an
    sm90 kernel's at the main shape, a SIMT kernel's at SIMT_LINE_SHAPE,
    with the ring's causal block in ``ring_block`` and every timed shape in
    ``by_shape``; a codec kernel's as the wire phase recorded it."""
    if name in K.CODEC_KERNELS:
        return timings[name]
    by_case = timings[name]
    case = MAIN_SHAPE if name.endswith("_sm90") else SIMT_LINE_SHAPE[name]
    return {**by_case[case], "ring_block": by_case[RING_CASES[0]],
            "by_shape": list(by_case.values())}


# the sm90 names first: _category matches by substring
FLASH_KERNELS = ("flash_fwd_sm90", "flash_dq_sm90", "flash_dkv_sm90",
                 "flash_fwd", "flash_dq", "flash_dkv")


def _category(kernel_name):
    name = kernel_name.lower()
    for flash in FLASH_KERNELS:
        if flash in name:
            return flash
    if "nccl" in name:
        return "nccl"
    # cuDNN's convolutions, before matmul: their implicit-GEMM kernels' names
    # also say gemm or xmma
    if any(t in name for t in ("conv", "fprop", "dgrad", "wgrad")):
        return "conv"
    if any(t in name for t in ("gemm", "xmma", "cutlass", "cublas",
                               "nvjet")):
        return "matmul"
    return "other"


def _markers(names):
    """Positions of the marker kernels in a profile's device records."""
    return [i for i, n in enumerate(names) if "spin_kernel" in n]


def _discarded(what, session, seen, want, records):
    """Reports a profiler session discarded for a lost marker, or fails
    when it was the last one allowed."""
    msg = (f"{what}: {seen} of the {want} marker kernels in the profile's "
           f"{records} device records (session {session} of "
           f"{PROFILE_SESSIONS}); the records lost at its start reach past "
           f"the first marker")
    if session == PROFILE_SESSIONS:
        fail(msg)
    emit({"phase": "profile_session_discarded", "what": what,
          "session": session, "markers_seen": seen, "markers": want,
          "device_records": records})


def device_time(run, count, unit_s):
    """Device time of ``count`` calls of ``run`` (each ends in a device
    sync) under torch.profiler: busy ms per call, ms per call by kernel
    category and by kernel name, and the idle share twice (of the
    profiled window, and of the unprofiled median call ``unit_s``, since
    profiling slows the host). None when the profiler saw no device
    events. The profiler on that machine can lose the records at the
    start of a session (tools/observe_probe.py; PERF.md §7), so one call
    runs first, and only the records between two marker kernels, which
    enclose the ``count`` calls, are read; a session that lost a marker is
    run again."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for session in range(1, PROFILE_SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda._sleep(MARK_CYCLES)
            for _ in range(count):
                run()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        records = sorted(
            (e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)),
            key=lambda e: e.time_range.start)
        if not records:
            return None
        marks = _markers([e.name for e in records])
        if len(marks) == 2:
            break
        _discarded(f"profile of {count} calls", session, len(marks), 2,
                   len(records))
    # device activity: kernels, copies and sets, but not the annotation
    # ranges (e.g. "Optimizer.step#AdamW.step") that overlap them
    kernels = records[marks[0] + 1:marks[1]]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:                       # union of kernel intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    window = spans[-1][1] - spans[0][0]
    by_cat, by_name, n_cat = {}, {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        cat = _category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + us / 1e3 / count
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3 / count
        n_cat[cat] = n_cat.get(cat, 0) + 1
    return {"busy_ms": busy / 1e3 / count, "window_ms": window / 1e3 / count,
            "device_events_per_call": len(kernels) / count,
            "events_per_call_by_category": {k: v / count
                                            for k, v in sorted(n_cat.items())},
            "idle_share_of_profiled_window": 1.0 - busy / window,
            "idle_share_unprofiled": 1.0 - busy / 1e6 / count / unit_s,
            "by_category": dict(sorted(by_cat.items())), "by_name": by_name}


def profile_phase(model, optimizer, cfg, batch, seq, step_s, launches):
    """Where a main-path step's device time goes: kernel time by category
    over PROFILE_STEPS steps, and each flash kernel's time per launch."""
    import torch

    from horovod_tpu_torch.train import make_train_step, seeded_tokens

    step = make_train_step(model, optimizer)
    tokens = seeded_tokens(cfg, batch, seq, seed=0)
    step(tokens)
    torch.cuda.synchronize()
    # each step waits for the device, as train() does
    prof = device_time(lambda: float(step(tokens)), PROFILE_STEPS, step_s)
    issue = host_issue(lambda: step(tokens))
    if prof is None:
        emit({"phase": "profile", "device_time": "not measured",
              "why": "torch.profiler recorded no device events"})
        return
    by_cat = prof["by_category"]
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:PROFILE_TOP]
    per_step = {n: launches[n] // (STEPS_WARMUP + STEPS_TIMED)
                for n in FLASH_KERNELS}
    emit({"phase": "profile", "steps": PROFILE_STEPS,
          "in_step_ms_per_launch": {
              n: by_cat[n] / per_step[n]
              for n in FLASH_KERNELS if per_step[n] and n in by_cat},
          "device_ms_per_step": by_cat,
          "busy_ms_per_step": prof["busy_ms"],
          "host_per_step": issue,
          "device_events_per_step": prof["device_events_per_call"],
          "window_ms_per_step": prof["window_ms"],
          "idle_share_of_profiled_window":
              prof["idle_share_of_profiled_window"],
          "idle_share_of_step": prof["idle_share_unprofiled"],
          "top_kernels_ms_per_step": [[n[:90], t] for n, t in top]})


def _latency(op):
    """(sum in seconds, count) of hvt_collective_latency_seconds{op} on the
    global set, after the drainer resolved every CUDA event pair."""
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.utils import timeline

    if not timeline.drainer.flush():
        fail("observe: the drainer left CUDA event pairs unresolved")
    fam = metrics.registry().get("hvt_collective_latency_seconds")
    if fam is None:
        return 0.0, 0
    _, total, count = fam.labels(op=op, process_set="global").snapshot()
    return total, count


def _traced(op):
    from horovod_tpu_torch import metrics

    fam = metrics.registry().get("hvt_traced_collectives_total")
    return 0 if fam is None else fam.labels(op=op).value


def _profiler_kernel_names(path):
    """Names of the kernels in a torch.profiler Chrome trace, in order of
    start."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e.get("ts", 0))
    return [e.get("name", "") for e in kernels]


def _profiler_kernels(names):
    """Kernel launches by flash category."""
    counts = {}
    for name in names:
        cat = _category(name)
        counts[cat] = counts.get(cat, 0) + 1
    return counts


def _instrumentation_us(hvt, calls=1000):
    """Host µs that counting and timing one collective adds on CUDA
    (``collective_ops._begin`` and ``_end``: a histogram child, two CUDA
    event records, the pair handed to the drainer), per call."""
    import torch

    from horovod_tpu_torch.ops import collective_ops as C

    x = torch.zeros(1, device=hvt.device())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        C._end(C._begin("allreduce", hvt.global_process_set, x))
    return (time.perf_counter() - t0) / calls * 1e6


def observe_phase(hvt, K, main_losses, main_step_s):
    """The main path's steps with the observability plane on: the GPT
    through train.train with a timeline recording, /metrics served and
    MetricsCallback, in turns with plain runs (plain, observed, observed,
    plain), then once with the timeline's torch.profiler session; then the
    step captured in a CUDA graph with and without the timeline. Returns
    the launch counts of the profiled run."""
    import urllib.request

    import torch

    from horovod_tpu_torch import bench, metrics
    from horovod_tpu_torch.callbacks import MetricsCallback
    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.train import (gpt_config, make_train_step,
                                         seeded_tokens, train)
    from horovod_tpu_torch.utils import timeline

    hvt.init()                  # a one-process NCCL world on cuda:0
    cfg = gpt_config("bench", use_flash=True, dtype=torch.bfloat16)
    batch, seq = MAIN_SHAPE[0], cfg.max_seq_len
    steps = STEPS_WARMUP + STEPS_TIMED
    op = "grouped_allreduce"     # DistributedOptimizer's one collective
    out_dir = tempfile.mkdtemp(prefix="hvt_observe_")
    port = metrics.serve(0)
    out = {"main_path_step_ms_median": main_step_s * 1e3,
           "instrumentation_host_us_per_collective":
               _instrumentation_us(hvt), "plain_step_ms_median": []}
    try:
        for name, profiler in (("plain", None),
                               ("timeline_metrics", False),
                               ("timeline_metrics_2", False),
                               ("plain", None),
                               ("timeline_metrics_profiler", True)):
            if profiler is None:    # the same steps, no timeline or scrape
                res = train(cfg, steps, batch, seq, seed=0)
                out["plain_step_ms_median"].append(statistics.median(
                    res["step_s"][STEPS_WARMUP:]) * 1e3)
                del res
                torch.cuda.empty_cache()
                continue
            path = os.path.join(out_dir, name + ".json")
            for session in range(1, PROFILE_SESSIONS + 1):
                before = _latency(op)
                hvt.start_timeline(path, profiler=profiler)
                if profiler:
                    # a session can lose its first device record: a fill
                    # kernel takes that place, and a lost marker then means
                    # a lost prefix (device_time runs one call first too)
                    torch.zeros(1, device=hvt.device())
                    torch.cuda._sleep(MARK_CYCLES)
                K.reset_launches()
                res = train(cfg, steps, batch, seq, seed=0,
                            callbacks=MetricsCallback())
                launches = dict(K.LAUNCHES)
                pending = hvt.diagnostics()["pending"]
                t0 = time.perf_counter()
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics",
                        timeout=30) as resp:
                    text = resp.read().decode()
                scrape_ms = (time.perf_counter() - t0) * 1e3
                last = hvt.join()
                hvt.stop_timeline()
                after = _latency(op)
                if not profiler:
                    break
                ppath = timeline.profiler_trace_path(path)
                names = _profiler_kernel_names(ppath)
                if len(_markers(names)) == 1:
                    break
                _discarded(f"observe {name}", session, len(_markers(names)),
                           1, len(names))
            events = timeline.load_trace(path)
            spans = [e for e in events
                     if e.get("name") == "NCCL_GROUPED_ALLREDUCE"]
            row = {"losses": res["loss"],
                   "step_ms_median": statistics.median(
                       res["step_s"][STEPS_WARMUP:]) * 1e3,
                   "launches": launches, "scrape_ms": scrape_ms,
                   "scrape_bytes": len(text), "join": last,
                   "pending_after_last_step": pending,
                   "trace_bytes": os.path.getsize(path),
                   "trace_events": len(events),
                   "device_spans": len(spans),
                   "device_span_ms": [e["dur"] / 1e3 for e in spans],
                   "histogram_count": after[1] - before[1],
                   "histogram_ms": (after[0] - before[0]) * 1e3}
            if res["loss"] != main_losses:
                fail(f"observe {name}: losses {res['loss']} are not the "
                     f"main path's {main_losses} bit for bit")
            _sm90_only(f"observe {name}", launches, steps, MAIN_LAYERS)
            if last != 0 or pending:
                fail(f"observe {name}: join() gave {last}, pending after "
                     f"the last step {pending}")
            if row["histogram_count"] != steps or len(spans) != steps \
                    or any(e["args"]["clock"] != "cuda_event"
                           or e["dur"] < 0 for e in spans):
                fail(f"observe {name}: {row['histogram_count']} latencies "
                     f"and {len(spans)} device spans of {op} in {steps} "
                     f"steps: {spans[:2]}")
            want = f'hvt_train_metric{{metric="loss"}} '
            if want + repr(res["loss"][-1]) not in text \
                    or "hvt_train_epochs_total" not in text \
                    or f'hvt_collective_latency_seconds_count{{op="{op}",' \
                    not in text:
                fail(f"observe {name}: /metrics lacks the train metrics or "
                     f"the {op} latency:\n{text[:2000]}")
            if profiler:
                row["profiler_sessions"] = session
                row["profiler_trace_bytes"] = os.path.getsize(ppath)
                row["profiler_kernels"] = kernels = \
                    _profiler_kernels(names)
                for kern in FLASH_KERNELS:
                    n = kernels.get(kern, 0)
                    if n != (MAIN_LAYERS * steps if kern.endswith("_sm90")
                             else 0):
                        fail(f"observe: the profiler's trace has {n} "
                             f"{kern} kernels in {steps} steps")
            out[name] = row
            del res
            torch.cuda.empty_cache()
        observed = [out[k]["step_ms_median"] for k in ("timeline_metrics",
                                                       "timeline_metrics_2")]
        out["observed_minus_plain_ms"] = (statistics.mean(observed)
                                          - statistics.mean(
                                              out["plain_step_ms_median"]))
        # the step captured in a CUDA graph, with and without the timeline:
        # the capture counts its collective once and times none, and the
        # replayed losses are the same bit for bit
        captured = {}
        for name in ("plain", "timeline"):
            model = GPT(cfg, device=hvt.device(), seed=0)
            opt = hvt.DistributedOptimizer(torch.optim.AdamW(
                model.parameters(), lr=1e-4, weight_decay=1e-4,
                capturable=True))
            step = make_train_step(model, opt)
            tokens = seeded_tokens(cfg, batch, seq, seed=0)
            if name == "timeline":
                hvt.start_timeline(os.path.join(out_dir, "capture.json"),
                                   profiler=False)
            traced, timed = _traced(op), _latency(op)[1]
            replay = bench.capture_step(step, tokens, model, opt)
            losses = [float(replay()) for _ in range(steps)]
            captured[name] = {
                "losses": losses, "traced": _traced(op) - traced,
                "timed": _latency(op)[1] - timed}
            if name == "timeline":
                hvt.stop_timeline()
            del model, opt, step, replay
            torch.cuda.empty_cache()
        out["captured"] = captured
        if captured["plain"]["losses"] != captured["timeline"]["losses"]:
            fail(f"observe: the replayed losses changed with the timeline "
                 f"on: {captured}")
        for name, c in captured.items():
            # the warm-up steps run eagerly and are timed; the capture is
            # counted once and not timed
            if c["traced"] != 1 \
                    or c["timed"] != bench.CAPTURE_WARMUP_STEPS:
                fail(f"observe: capture {name} counted {c['traced']} "
                     f"traced and {c['timed']} timed {op}")
    finally:
        hvt.stop_timeline()
        metrics.stop_server()
        shutil.rmtree(out_dir, ignore_errors=True)
    emit({"phase": "observe", "config": "bench.py --model gpt --flash",
          "batch": batch, "seq": seq, "steps": steps,
          "nvidia_smi": bench.card_info()["nvidia_smi"], **out})
    return out["timeline_metrics_profiler"]["launches"]


def accumulation_phase(hvt, K, main_losses):
    """The main path's updates as two micro-batches each, through
    backward_passes_per_step=2: the same gradients (the mean over two
    halves of equal token counts), so the same losses. Returns the launch
    counts and the trained model and optimizer."""
    import torch

    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.train import (gpt_config, make_train_step,
                                         seeded_tokens)

    cfg = gpt_config("bench", use_flash=True, dtype=torch.bfloat16)
    batch, seq, rows = MAIN_SHAPE[0], cfg.max_seq_len, MICRO_SHAPE[0]
    updates = STEPS_WARMUP + STEPS_TIMED
    model = GPT(cfg, device=hvt.device(), seed=0)
    optimizer = hvt.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        backward_passes_per_step=MICRO_BATCHES,
        average_aggregated_gradients=True)
    step = make_train_step(model, optimizer)
    tokens = seeded_tokens(cfg, batch, seq, seed=0)
    micro = [tokens[i:i + rows] for i in range(0, batch, rows)]

    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    losses, times = [], []
    for _ in range(updates):
        t0 = time.perf_counter()
        pair = [float(step(m)) for m in micro]     # each waits for the card
        times.append(time.perf_counter() - t0)
        losses.append(sum(pair) / len(pair))
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    per_update = MICRO_BATCHES * cfg.n_layers
    on_path = {base + "_sm90" for base in ("flash_fwd", "flash_dq",
                                           "flash_dkv")}
    for name, n in launches.items():
        want = per_update * updates if name in on_path else 0
        if n != want:
            fail(f"accumulation: {name} launched {n} times in {updates} "
                 f"updates, expected {want // updates} an update")
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, main_losses)]
    update_s = statistics.median(times[STEPS_WARMUP:])
    prof = device_time(lambda: [float(step(m)) for m in micro],
                       PROFILE_STEPS, update_s) or {"busy_ms": "not measured"}
    issue = host_issue(lambda: [step(m) for m in micro])
    emit({"phase": "accumulation", "config": "bench.py --model gpt --flash",
          "micro_batches": [rows] * MICRO_BATCHES, "seq": seq,
          "backward_passes_per_step": MICRO_BATCHES, "losses": losses,
          "main_path_losses": main_losses, "rel_diff": rels,
          "rtol": LOSS_RTOL, "update_s": times[STEPS_WARMUP:],
          "update_ms_median": update_s * 1e3,
          "tokens_per_s": batch * seq / update_s,
          "max_memory_allocated_bytes": peak, "launches": launches,
          "launches_per_update": per_update,
          "profiled_updates": PROFILE_STEPS,
          "host_per_update": issue,
          **{k: v for k, v in prof.items() if k != "by_name"}})
    if not all(math.isfinite(x) for x in losses):
        fail(f"accumulation: non-finite loss: {losses}")
    for i in (0, updates - 1):
        if rels[i] > LOSS_RTOL:
            fail(f"accumulation: update {i + 1}: loss {losses[i]} vs main "
                 f"path {main_losses[i]}: rel diff {rels[i]:.3g} > "
                 f"{LOSS_RTOL}")
    return launches, model, optimizer


def collectives_phase(hvt, model, optimizer):
    """Every collective on CUDA tensors in the one-process NCCL world, each
    held exactly to its world-of-one value. Inputs hold small integers, so
    fp32 and bf16 sums are exact."""
    import torch

    dev = hvt.device()
    checked = []

    def same(tag, got, want):
        if not isinstance(want, (list, tuple)):
            got, want = [got], [want]
        if len(got) != len(want):
            fail(f"collectives: {tag}: {len(got)} outputs, want {len(want)}")
        for g, w in zip(got, want):
            if g.device != w.device or g.dtype != w.dtype \
                    or not torch.equal(g, w):
                fail(f"collectives: {tag}: {g.dtype} on {g.device} "
                     f"differs from the world-of-one value ({w.dtype})")
        checked.append(tag)

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(7)
    for dtype in (torch.float32, torch.bfloat16):
        x, y = (torch.randint(-64, 64, shape, generator=gen, device=dev)
                .to(dtype) for shape in ((8, 96), (5, 3)))
        tag = str(dtype).split(".")[1]
        same(f"grouped_allreduce {tag}", hvt.grouped_allreduce([x, y]),
             [x, y])
        same(f"allgather ragged {tag}", hvt.allgather(x[:3]), x[:3])
        out, splits = hvt.alltoall(x, splits=[x.shape[0]])
        same(f"alltoall splits {tag}", out, x)
        if splits.tolist() != [x.shape[0]]:
            fail(f"collectives: alltoall received splits {splits}")
        same(f"reducescatter {tag}", hvt.reducescatter(x), x)
        handles = {"allreduce_async": (hvt.allreduce_async(x), x),
                   "grouped_allreduce_async": (
                       hvt.grouped_allreduce_async([x, y]), [x, y]),
                   "allgather_async": (hvt.allgather_async(x), x),
                   "broadcast_async": (hvt.broadcast_async(x, 0), x),
                   "alltoall_async": (hvt.alltoall_async(x), x)}
        for name, (h, want) in handles.items():
            if not isinstance(hvt.poll(h), bool):
                fail(f"collectives: poll({name}) is not a bool")
            got = hvt.synchronize(h)
            same(f"{name} {tag}", got, want)
            if not hvt.poll(h):
                fail(f"collectives: {name} not done after synchronize")
        ps = hvt.add_process_set([0])
        same(f"allreduce over set [0] {tag}",
             hvt.allreduce(x, process_set=ps), x)
        hvt.remove_process_set(ps)
        same(f"allreduce Adasum {tag}", hvt.allreduce(x, op=hvt.Adasum), x)
        same(f"hierarchical_allreduce {tag}",
             hvt.hierarchical_allreduce(x, average=True), x)
        same(f"hierarchical_allgather {tag}", hvt.hierarchical_allgather(x),
             x)
        idx = torch.tensor([1, 1, 5], device=dev)
        same(f"sparse_allreduce_apply {tag}",
             hvt.sparse_allreduce_apply(x, idx, x[:3]),
             x.clone().index_add_(0, idx, x[:3]))

    params = {k: v.clone() for k, v in model.state_dict().items()}
    hvt.broadcast_parameters(model.state_dict(), root_rank=0)
    same("broadcast_parameters", list(model.state_dict().values()),
         list(params.values()))
    state = optimizer.state_dict()["state"]
    before = [t.clone() for s in state.values() for t in s.values()]
    hvt.broadcast_optimizer_state(optimizer, root_rank=0)
    state = optimizer.state_dict()["state"]
    same("broadcast_optimizer_state",
         [t for s in state.values() for t in s.values()], before)
    obj = {"rank": hvt.rank(), "losses": [1.5, 2.5]}
    if hvt.allgather_object(obj) != [obj]:
        fail("collectives: allgather_object")
    checked.append("allgather_object")
    torch.cuda.synchronize()
    emit({"phase": "collectives", "world_size": hvt.size(),
          "checked": checked, "seconds": time.perf_counter() - t0})


def sequence_phase(K, ref_fn, shape=MAIN_SHAPE, phase="sequence"):
    """Ring attention's block function (parallel/sequence.flash_ring_block)
    on one card: every shard of an sp-way split of ``shape`` (the main
    shape's unless given) takes the K/V blocks in ring order, and the
    shards' o and the gradients of mean(o**2) are held against flash
    attention over the whole sequence and against the dense reference. A
    causal ring of n shards launches each sm90 kernel n(n+1)/2 times (the
    masked blocks launch nothing) and no SIMT kernel. Returns the launches
    summed over the layouts."""
    import torch

    from horovod_tpu_torch.ops.flash_attention import flash_attention
    from horovod_tpu_torch.parallel.sequence import (block_kind,
                                                     flash_ring_block,
                                                     flash_ring_start)

    b, s, h, h_kv, d, dtype_name, causal, _ = shape
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(99)
    q, k, v = (torch.randn(b, s, n, d, generator=gen, device="cuda")
               .to(dtype) for n in (h, h_kv, h_kv))
    scale = d ** -0.5

    def run(attend):
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        o = attend(*leaves)
        (o.float() ** 2).mean().backward()
        return [o.detach()] + [x.grad for x in leaves]

    want = {"flash_attention": run(lambda *t: flash_attention(
                *t, causal=causal, scale=scale)),
            "reference": run(lambda *t: ref_fn(*t, causal=causal,
                                               scale=scale)[0])}
    total = {name: 0 for name in K.LAUNCHES}
    for n in SEQUENCE_LAYOUTS:
        shard = s // n

        def ring(qf, kf, vf):
            outs = []
            for i in range(n):
                qi = qf[:, i * shard:(i + 1) * shard]
                o, lse = flash_ring_start(qi)
                for step in range(n):
                    j = (i - step) % n
                    o, lse = flash_ring_block(
                        qi, kf[:, j * shard:(j + 1) * shard],
                        vf[:, j * shard:(j + 1) * shard], o, lse,
                        block_kind(i, j, causal), scale)
                outs.append(o.to(qf.dtype))
            return torch.cat(outs, dim=1)

        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        got = run(ring)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        blocks = n * (n + 1) // 2
        for name, count in launches.items():
            expect = blocks if name.endswith("_sm90") else 0
            if count != expect:
                fail(f"{phase} sp {n}: {name} launched {count} times, "
                     f"expected {expect}")
            total[name] += count
        # mean() makes the gradients about 1e-7: each is held relative to
        # its largest magnitude
        errs = {}
        for label, ref in want.items():
            found = {}
            for t, g, r in zip(("o", "dq", "dk", "dv"), got, ref):
                unit = 1.0 if t == "o" else float(r.float().abs().max())
                e = check(f"{phase} sp {n} {t} vs {label}", g / unit,
                          r / unit, TOL_PLAIN[dtype_name] if t == "o"
                          else TOL_AUTOGRAD[dtype_name])
                found[t] = {"max_abs_err": e[0] * unit, "least_tol": e[2],
                            "unit": unit}
            errs[label] = found
        emit({"phase": phase, "sp": n, "shard": [b, shard, h, d],
              "H_kv": h_kv, "dtype": dtype_name, "causal": causal,
              "launches": launches,
              "blocks": blocks, "seconds_fwd_bwd": seconds,
              "tol": {"o": TOL_PLAIN[dtype_name],
                      "grads": TOL_AUTOGRAD[dtype_name]}, "vs": errs})
    return total


def _losses_close(tag, got, want):
    """Relative differences of the first LOSS_STEPS losses; fail unless
    steps 1 and LOSS_STEPS are within LOSS_RTOL."""
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)][:LOSS_STEPS]
    for i in (0, LOSS_STEPS - 1):
        if rel[i] > LOSS_RTOL:
            fail(f"{tag}: loss at step {i + 1} is {rel[i]:.3g} from the "
                 f"reference's (rtol {LOSS_RTOL})")
    return rel


def bench_phase(K):
    """The benchmark harness's GPT at full width (bench.py --model gpt
    --flash), eager and replayed from a CUDA graph, then with the chunked
    cross-entropy. Returns the launch counts outside the replays."""
    import torch

    from horovod_tpu_torch import bench

    card = bench.card_info()
    calib = bench.calibrate_matmul_tflops(torch.device("cuda"))
    peak = bench.peak_bf16_tflops(card["kind"])
    layers = bench.GPT_BENCH["n_layers"]
    out, eager_losses = {"calib_tflops": calib, "peak_tflops": peak}, {}
    K.reset_launches()
    for chunked in (False, True):
        name = "chunked_ce" if chunked else "gpt"
        t0 = time.perf_counter()
        res = bench.measure_gpt(MAIN_SHAPE[0], BENCH_ITERS, BENCH_STEPS,
                                "bf16", MAIN_SHAPE[1], use_flash=True,
                                chunked_ce=chunked)
        row = {"seconds": time.perf_counter() - t0,
               "flops_per_token": res["flops_per_item"]}
        for way in ("eager", "replayed"):
            r = res[way]
            if r is None:
                fail(f"bench {name}: no {way} run on one card")
            losses = r["losses"]
            if not all(math.isfinite(x) for x in losses) \
                    or not losses[-1] < losses[0]:
                fail(f"bench {name} {way}: losses not finite and falling: "
                     f"{losses}")
            tok_s = statistics.mean(r["rates"])
            tflops = tok_s * res["flops_per_item"] / 1e12
            row[way] = {"tokens_per_s": tok_s, "rates": r["rates"],
                        "step_ms_median": r["step_ms_median"],
                        "max_memory_allocated_bytes":
                            r["max_memory_allocated_bytes"],
                        "achieved_tflops": tflops,
                        "mfu_vs_calib": tflops / calib,
                        "mfu_vs_peak": tflops / peak if peak else None,
                        "losses": losses[:LOSS_STEPS]}
        eager_losses[chunked] = res["eager"]["losses"]
        # both runs start from the seed-0 weights: the same steps
        row["replayed_vs_eager_rel_diff"] = _losses_close(
            f"bench {name} replayed", res["replayed"]["losses"],
            res["eager"]["losses"])
        # a replay runs no Python: count its kernels in a profile
        replay = res["run"]
        prof = device_time(lambda: float(replay()), PROFILE_STEPS,
                           res["replayed"]["step_ms_median"] / 1e3)
        if prof is None:
            fail(f"bench {name}: the profiler saw no kernel of the replay")
        per_step = prof["events_per_call_by_category"]
        for kern in FLASH_KERNELS:
            want = layers if kern.endswith("_sm90") else 0
            if per_step.get(kern, 0) != want:
                fail(f"bench {name}: {kern} ran {per_step.get(kern, 0)} "
                     f"times a replayed step, expected {want}")
        row["replayed_profile"] = {k: v for k, v in prof.items()
                                   if k != "by_name"}
        row["replayed_host"] = host_issue(replay)
        out[name] = row
        del res, replay
        torch.cuda.empty_cache()
    out["chunked_vs_unchunked_rel_diff"] = _losses_close(
        "bench chunked cross-entropy", eager_losses[True],
        eager_losses[False])
    # outside the replays the wrappers ran for each run's eager steps, the
    # capture's warm-up steps and the capture itself
    launches = dict(K.LAUNCHES)
    steps = 2 * ((BENCH_ITERS + 1) * BENCH_STEPS
                 + bench.CAPTURE_WARMUP_STEPS + 1)
    for kern, n in launches.items():
        if n != (layers * steps if kern.endswith("_sm90") else 0):
            fail(f"bench: {kern} launched {n} times outside the replays")
    emit({"phase": "bench", "config": "bench.py --model gpt --flash "
          "[--chunked-ce]", "batch": MAIN_SHAPE[0], "seq": MAIN_SHAPE[1],
          "iters": BENCH_ITERS, "steps_per_iter": BENCH_STEPS,
          "capture_warmup_steps": bench.CAPTURE_WARMUP_STEPS,
          "nvidia_smi": card["nvidia_smi"], "rtol": LOSS_RTOL,
          "launches_outside_replays": launches, **out})
    return launches


def vision_phase():
    """The benchmark harness's vision path on one card: ResNet-50 timed,
    VGG16 and InceptionV3 two steps each, and the space-to-depth stem held
    to the standard stem."""
    import torch

    from horovod_tpu_torch import bench
    from horovod_tpu_torch.models.layers import Conv
    from horovod_tpu_torch.models.resnet import SpaceToDepthStem

    out = {}
    for name, batch, iters, steps in (
            ("resnet50", 256, VISION_ITERS, VISION_STEPS),
            ("vgg16", 64, 1, 1), ("inception_v3", 128, 1, 1)):
        t0 = time.perf_counter()
        res = bench.measure(name, batch, iters, steps, "bf16",
                            norm_impl="tpu")
        r = res["eager"]
        losses = r["losses"]
        if not all(math.isfinite(x) for x in losses):
            fail(f"vision {name}: non-finite loss {losses}")
        if name == "resnet50" and not losses[-1] < losses[0]:
            fail(f"vision {name}: loss did not fall: {losses}")
        img_s = statistics.mean(r["rates"])
        if name == "resnet50":      # where a step's device time goes
            step = res["run"]
            prof = device_time(lambda: float(step()), PROFILE_STEPS,
                               r["step_ms_median"] / 1e3)
            out["resnet50_profile"] = "not measured" if prof is None else {
                **{k: v for k, v in prof.items() if k != "by_name"},
                "top_kernels_ms_per_step": [
                    [n[:90], t] for n, t in sorted(
                        prof["by_name"].items(),
                        key=lambda kv: -kv[1])[:PROFILE_TOP]]}
            del step
        out[name] = {"batch": batch, "image_size": res["image_size"],
                     "seconds": time.perf_counter() - t0,
                     "img_per_s": img_s, "rates": r["rates"],
                     "step_ms_median": r["step_ms_median"],
                     "max_memory_allocated_bytes":
                         r["max_memory_allocated_bytes"],
                     "achieved_tflops": img_s * res["flops_per_item"] / 1e12,
                     "losses": losses, "n_params": res["n_params"]}
        del res
        torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(256, 3, 224, 224, generator=gen).cuda()
    stems = {}
    for dtype in (torch.float32, torch.bfloat16):
        s2d = SpaceToDepthStem(3, 64, dtype=dtype, generator=gen).cuda()
        plain = Conv(3, 64, (7, 7), (2, 2), ((3, 3), (3, 3)),
                     dtype=dtype).cuda()
        with torch.no_grad():
            plain.weight.copy_(s2d.weight)
            got, want = s2d(x), plain(x)
        torch.cuda.synchronize()
        dtype_name = str(dtype).split(".")[1]
        err = check(f"space-to-depth stem {dtype_name}", got, want,
                    TOL_STEM[dtype_name])
        with torch.no_grad():
            stems[dtype_name] = {
                "max_abs_err": err[0], "least_tol": err[2],
                "tol": TOL_STEM[dtype_name],
                "s2d_ms": cuda_ms(lambda: s2d(x), 10)[0],
                "standard_ms": cuda_ms(lambda: plain(x), 10)[0]}
    emit({"phase": "vision", "bn_impl": "tpu", "dtype": "bf16",
          "iters": VISION_ITERS, "steps_per_iter": VISION_STEPS,
          **out, "space_to_depth_stem": stems})


def _sm90_only(tag, launches, steps, per_step):
    """Fail unless each sm90 kernel launched ``per_step`` times a step and
    no SIMT or codec kernel ran."""
    for name, n in launches.items():
        want = per_step * steps if name.endswith("_sm90") else 0
        if n != want:
            fail(f"{tag}: {name} launched {n} times in {steps} steps, "
                 f"expected {want}")


def _du(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def checkpoint_phase(hvt, K):
    """Save the training state asynchronously at step CKPT_AT, train on,
    restore it into a fresh model and optimizer and take the same steps
    again: the same losses bit for bit. Eager steps: the async save's copy
    must not overlap a graph replaying into the parameters. Returns the
    launch counts of the phase and of the restored steps."""
    import torch

    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.train import (gpt_config, make_train_step,
                                         seeded_tokens)

    cfg = gpt_config("bench", use_flash=True, dtype=torch.bfloat16)
    tokens = seeded_tokens(cfg, MAIN_SHAPE[0], cfg.max_seq_len, seed=0)

    def fresh(seed):
        model = GPT(cfg, device=hvt.device(), seed=seed)
        opt = hvt.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=1e-4, weight_decay=1e-4))
        return model, opt, make_train_step(model, opt)

    workdir = tempfile.mkdtemp(prefix="hvt_ckpt_")
    try:
        torch.cuda.synchronize()
        K.reset_launches()
        model, opt, step = fresh(0)
        unbroken = [float(step(tokens)) for _ in range(CKPT_AT)]
        mgr = hvt.checkpoint.CheckpointManager(workdir, max_to_keep=2)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        saved = mgr.save(CKPT_AT, {"model": model, "optim": opt,
                                   "step": CKPT_AT})
        save_ms = (time.perf_counter() - t0) * 1e3
        peak_save = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        unbroken += [float(step(tokens)) for _ in range(CKPT_AT)]
        steps_during_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        mgr.wait()
        wait_ms = (time.perf_counter() - t0) * 1e3
        on_disk = _du(os.path.join(workdir, str(CKPT_AT)))
        n_params = sum(p.numel() for p in model.parameters())
        del model, opt, step
        torch.cuda.empty_cache()

        model, opt, step = fresh(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = mgr.restore_latest({"model": model, "optim": opt,
                                    "step": 0})
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        # the phase's count so far, then the restored steps' own window
        before_restored = dict(K.LAUNCHES)
        K.reset_launches()
        resumed = [float(step(tokens)) for _ in range(CKPT_AT)]
        restored = dict(K.LAUNCHES)
        launches = {n: before_restored[n] + restored[n] for n in restored}
        mgr.close()
        del model, opt, step
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit({"phase": "checkpoint", "config": "bench.py --model gpt --flash",
          "saved": saved, "restored_step": state["step"],
          "unbroken_losses": unbroken, "resumed_losses": resumed,
          "save_blocking_ms": save_ms, "wait_ms": wait_ms,
          "steps_while_saving_ms": steps_during_ms,
          "restore_ms": restore_ms, "bytes_on_disk": on_disk,
          "n_params": n_params,
          "memory_allocated_before_save_bytes": before,
          "max_memory_allocated_during_save_bytes": peak_save,
          "launches": launches, "launches_restored_steps": restored})
    if not saved or state["step"] != CKPT_AT:
        fail(f"checkpoint: saved {saved}, restored step {state['step']}")
    if resumed != unbroken[CKPT_AT:]:
        fail(f"checkpoint: resumed losses {resumed} are not the unbroken "
             f"run's {unbroken[CKPT_AT:]}")
    _sm90_only("checkpoint", launches, 3 * CKPT_AT, MAIN_LAYERS)
    _sm90_only("checkpoint restored steps", restored, CKPT_AT, MAIN_LAYERS)
    return launches, restored


def fsdp_phase(hvt, K, main_losses):
    """The main path's GPT sharded by shard_module on a mesh of one rank,
    with a plain AdamW (its gradients are FSDP's to reduce)."""
    import torch

    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.parallel.fsdp import shard_module
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh
    from horovod_tpu_torch.train import (gpt_config, make_train_step,
                                         seeded_tokens)

    cfg = gpt_config("bench", use_flash=True, dtype=torch.bfloat16)
    steps = STEPS_WARMUP + STEPS_TIMED
    tokens = seeded_tokens(cfg, MAIN_SHAPE[0], cfg.max_seq_len, seed=0)
    model = shard_module(GPT(cfg, device=hvt.device(), seed=0),
                         make_parallel_mesh(fsdp=1))
    sharded = sum(hasattr(p, "to_local") for p in model.parameters())
    step = make_train_step(model, torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(tokens)))         # waits for the card
        times.append(time.perf_counter() - t0)
    launches = dict(K.LAUNCHES)
    step_s = statistics.median(times[STEPS_WARMUP:])
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, main_losses)]
    emit({"phase": "fsdp", "config": "bench.py --model gpt --flash",
          "mesh": {"fsdp": 1}, "sharded_params": sharded,
          "params": sum(1 for _ in model.parameters()), "losses": losses,
          "main_path_losses": main_losses, "rel_diff": rels,
          "rtol": LOSS_RTOL, "step_s": times[STEPS_WARMUP:],
          "step_ms_median": step_s * 1e3,
          "tokens_per_s": MAIN_SHAPE[0] * cfg.max_seq_len / step_s,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches})
    if not all(math.isfinite(x) for x in losses):
        fail(f"fsdp: non-finite loss {losses}")
    for i in (0, steps - 1):
        if rels[i] > LOSS_RTOL:
            fail(f"fsdp: step {i + 1}: loss {losses[i]} vs main path "
                 f"{main_losses[i]}: rel diff {rels[i]:.3g} > {LOSS_RTOL}")
    _sm90_only("fsdp", launches, steps, MAIN_LAYERS)
    del model, step
    torch.cuda.empty_cache()
    return launches


def launch_phase(main_losses):
    """The port's launcher starts one worker on cuda:0 that takes 2 steps
    of the main path; it must see the launcher's identity and give the main
    path's first two losses. Returns the worker's launch counts."""
    import torch

    out_dir = tempfile.mkdtemp(prefix="hvt_launch_")
    out = os.path.join(out_dir, "res")
    steps = 2
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
           "1", "--master-port", str(port), sys.executable,
           os.path.join(REPO, "tests", "torch_port_launch_worker.py"), "gpt",
           out, json.dumps({"device": "cuda", "config": "bench",
                            "steps": steps, "batch": MAIN_SHAPE[0],
                            "seq": MAIN_SHAPE[1]})]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=600, env=dict(os.environ,
                                                    PYTHONPATH=REPO))
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"launch: the launcher exited {proc.returncode}:\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        res = torch.load(out + ".0.pt", weights_only=False)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    env = res["env"]
    emit({"phase": "launch", "command": "python -m "
          "horovod_tpu_torch.runner.launch -np 1 python "
          "tests/torch_port_launch_worker.py gpt ...", "seconds": seconds,
          "identity": env, "device": res["device"], "losses": res["losses"],
          "main_path_losses": main_losses[:steps],
          "launches": res["launches"]})
    want = {"HVT_PROCESS_ID": "0", "HVT_NUM_PROCESSES": "1",
            "HVT_LOCAL_PROCESS_ID": "0", "HVT_LOCAL_SIZE": "1",
            "HVT_CROSS_RANK": "0", "HVT_CROSS_SIZE": "1"}
    if any(env.get(k) != v for k, v in want.items()) \
            or env.get("HVT_COORDINATOR_ADDR") != f"127.0.0.1:{port}" \
            or res["device"] != "cuda:0":
        fail(f"launch: the worker saw identity {env} on {res['device']}")
    rels = [abs(a - b) / abs(b) for a, b in zip(res["losses"], main_losses)]
    if len(rels) != steps or max(rels) > LOSS_RTOL:
        fail(f"launch: losses {res['losses']} are not within {LOSS_RTOL} "
             f"of the main path's {main_losses[:steps]}")
    _sm90_only("launch", res["launches"], steps, MAIN_LAYERS)
    return res["launches"]


def _cuda_bytes(tree):
    """Bytes of the CUDA tensors in a nest of dicts, lists and tuples."""
    import torch

    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size() if tree.is_cuda else 0
    if isinstance(tree, dict):
        return sum(_cuda_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_cuda_bytes(v) for v in tree)
    return 0


def elastic_phase(hvt, K, main_losses):
    """The main path's GPT under @hvt.elastic.run with TorchState, a commit
    after every step: an unbroken run, then one whose step ELASTIC_FAIL_AT
    raises HorovodInternalError after its backward, before its commit. The
    loop restores the last commit, resets (shutdown and init on cuda:0),
    syncs and resumes; the resumed steps repeat the unbroken run's losses
    bit for bit. Returns the launch counts of both runs."""
    import importlib

    import torch

    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.train import (gpt_config, make_train_step,
                                         seeded_tokens)

    erun = importlib.import_module("horovod_tpu_torch.elastic.run")
    hvt.init()                  # a one-process NCCL world on cuda:0
    cfg = gpt_config("bench", use_flash=True, dtype=torch.bfloat16)
    tokens = seeded_tokens(cfg, MAIN_SHAPE[0], cfg.max_seq_len, seed=0)

    def run(fail_at):
        model = GPT(cfg, device=hvt.device(), seed=0)
        opt = hvt.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=1e-4, weight_decay=1e-4))
        step = make_train_step(model, opt)
        rec = {"losses": {}, "commit_ms": [], "restore_ms": [],
               "devices": [], "failed_loss": None}

        class TimedState(hvt.elastic.TorchState):
            def restore(self):
                t0 = time.perf_counter()
                super().restore()
                torch.cuda.synchronize()
                rec["restore_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["restored_batch"] = self.batch

        state = TimedState(model=model, optimizer=opt, batch=0)

        @hvt.elastic.run
        def train(state):
            rec["devices"].append(str(hvt.device()))
            while state.batch < ELASTIC_STEPS:
                loss = float(step(tokens))          # waits for the card
                if state.batch + 1 == fail_at and \
                        rec["failed_loss"] is None:
                    rec["failed_loss"] = loss
                    raise hvt.HorovodInternalError(
                        f"injected after step {fail_at}'s backward")
                state.batch += 1
                rec["losses"][state.batch] = loss
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                state.commit()
                rec["commit_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["commit_peak_adds_bytes"] = \
                    torch.cuda.max_memory_allocated() - base
            return state.batch

        t0 = time.perf_counter()
        n_recoveries = len(erun.recoveries)
        train(state)
        rec["seconds"] = time.perf_counter() - t0
        rec["recoveries"] = erun.recoveries[n_recoveries:]
        rec["snapshot_bytes"] = sum(_cuda_bytes(h._saved_state)
                                    for h in state._handlers.values())
        rec["losses"] = [rec["losses"][i + 1] for i in range(ELASTIC_STEPS)]
        del model, opt, step, state
        torch.cuda.empty_cache()
        return rec

    torch.cuda.synchronize()
    K.reset_launches()
    unbroken = run(fail_at=None)
    broken = run(fail_at=ELASTIC_FAIL_AT)
    launches = dict(K.LAUNCHES)
    rec = broken["recoveries"]
    phases = rec[0]["phases"] if rec else {}
    rels = [abs(a - b) / abs(b) for a, b in zip(broken["losses"],
                                                 main_losses)]
    emit({"phase": "elastic", "config": "bench.py --model gpt --flash",
          "state": "TorchState(model, DistributedOptimizer(AdamW), batch)",
          "fail_at": ELASTIC_FAIL_AT, "unbroken_losses": unbroken["losses"],
          "resumed_losses": broken["losses"],
          "failed_attempt_loss": broken["failed_loss"],
          "main_path_losses": main_losses[:ELASTIC_STEPS],
          "rel_diff_vs_main_path": rels, "rtol": LOSS_RTOL,
          "commit_ms": unbroken["commit_ms"],
          "commit_ms_median": statistics.median(unbroken["commit_ms"]),
          "snapshot_device_bytes": unbroken["snapshot_bytes"],
          "commit_peak_adds_bytes": unbroken["commit_peak_adds_bytes"],
          "restore_ms": broken["restore_ms"],
          "restored_batch": broken.get("restored_batch"),
          "recovery": rec, "reset_ms": 1e3 * sum(
              phases.get(p, 0) for p in ("shutdown", "rendezvous",
                                         "reinit")),
          "sync_ms": 1e3 * phases.get("rebuild", 0),
          "devices": broken["devices"],
          "seconds": {"unbroken": unbroken["seconds"],
                      "broken": broken["seconds"]},
          "launches": launches})
    if broken["losses"][ELASTIC_FAIL_AT - 1:] != \
            unbroken["losses"][ELASTIC_FAIL_AT - 1:]:
        fail(f"elastic: resumed losses {broken['losses']} are not the "
             f"unbroken run's {unbroken['losses']} from step "
             f"{ELASTIC_FAIL_AT}")
    if max(rels) > LOSS_RTOL or not all(math.isfinite(x)
                                        for x in broken["losses"]):
        fail(f"elastic: losses {broken['losses']} are not within "
             f"{LOSS_RTOL} of the main path's")
    if len(rec) != 1 or rec[0]["trigger"] != "failure" or set(phases) != {
            "abort", "restore", "shutdown", "rendezvous", "reinit",
            "rebuild"} \
            or broken.get("restored_batch") != ELASTIC_FAIL_AT - 1:
        fail(f"elastic: the recovery {rec} did not restore commit "
             f"{ELASTIC_FAIL_AT - 1}, reset and sync")
    if set(broken["devices"]) != {"cuda:0"} or len(broken["devices"]) != 2:
        fail(f"elastic: the loop ran on {broken['devices']}")
    # 7 unbroken steps, then 4 + the failed one + 3 resumed
    _sm90_only("elastic", launches, 2 * ELASTIC_STEPS + 1, MAIN_LAYERS)
    return launches


def _gradient_buffer(hvt):
    """The bench GPT's full gradient (one backward of the main path's
    batch, built as the bench phase builds the model) as one flat fp32
    buffer, with the parameters' names and sizes."""
    import torch

    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.train import gpt_config, loss_fn, seeded_tokens

    cfg = gpt_config("bench", use_flash=True, dtype=torch.bfloat16)
    model = GPT(cfg, device=hvt.device(), seed=0)
    loss_fn(model, seeded_tokens(cfg, MAIN_SHAPE[0], cfg.max_seq_len,
                                 seed=0)).backward()
    named = [(n, p) for n, p in model.named_parameters()
             if p.grad is not None]
    flat = torch.cat([p.grad.float().reshape(-1) for _, p in named])
    names, sizes = [n for n, _ in named], [p.numel() for _, p in named]
    del model, named
    torch.cuda.empty_cache()
    return flat, names, sizes


def _edge_buffer(n, seed):
    """n seeded values over 16 decades with the codecs' edge cases: NaN of
    both signs, ±Inf, a zero block, a -0 block, subnormal blocks."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * np.logspace(-8, 8, n)).astype(np.float32)
    x[5], x[300], x[301], x[700] = np.nan, np.inf, -np.inf, -np.nan
    x[512:768], x[1280:1536] = 0.0, -0.0
    x[768:1024] = np.float32(1e-42)
    x[1024:1280] = (np.float32(1e-39) * rng.randn(256)).astype(np.float32)
    return torch.from_numpy(x).cuda()


def _same_bits(a, b):
    import torch

    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _wire_check(tag, W, codec, x):
    """Every codec kernel against its plain version on ``x``, bit for bit,
    and the stream's length against the formula. Returns the kernels'
    calls and their plain versions, for timing."""
    import torch

    n = x.numel()
    stream = W.encode(x, codec)
    want_len = (n // 256) * 260 + (4 + n % 256 if n % 256 else 0) \
        if codec != "bf16" else 2 * n
    if stream.numel() != want_len or W.wire_bytes(codec, n) != want_len:
        fail(f"wire {tag}: {codec} stream of {n} elements holds "
             f"{stream.numel()} bytes, the formula {want_len}")
    if not _same_bits(stream, W.encode_plain(x, codec)):
        fail(f"wire {tag}: encode_{codec} differs from its plain version")
    dec = W.decode_accumulate(stream, codec, n)
    ref = W.decode_accumulate_plain(stream, codec, n, torch.empty_like(x))
    if not _same_bits(dec, ref):
        fail(f"wire {tag}: decode_{codec} differs from its plain version")
    base = torch.randn(n, device=x.device, generator=torch.Generator(
        device=x.device).manual_seed(1))
    acc = W.decode_accumulate(stream, codec, n, out=base.clone(),
                              accumulate=True)
    if not _same_bits(acc, base + ref):
        fail(f"wire {tag}: decode_accumulate_{codec} differs from its plain "
             f"version")
    res = torch.randn(n, device=x.device, generator=torch.Generator(
        device=x.device).manual_seed(2)) * 1e-3
    s1, r1, s2, r2 = x.clone(), res.clone(), x.clone(), res.clone()
    W.ef_roundtrip(s1, codec, r1)
    W.ef_roundtrip_plain(s2, codec, r2)
    if not (_same_bits(s1, s2) and _same_bits(r1, r2)):
        fail(f"wire {tag}: ef_roundtrip_{codec} differs from its plain "
             f"version")
    p1, p2 = x.clone(), x.clone()
    if not _same_bits(W.ef_roundtrip(p1, codec),
                      W.ef_roundtrip_plain(p2, codec)):
        fail(f"wire {tag}: the roundtrip of {codec} differs from its plain "
             f"version")
    acc_buf = base.clone()
    return {"encode": (lambda: W.encode(x, codec),
                       lambda: W.encode_plain(x, codec)),
            "decode_accumulate": (
                lambda: W.decode_accumulate(stream, codec, n, out=acc_buf,
                                            accumulate=True),
                lambda: W.decode_accumulate_plain(stream, codec, n, acc_buf,
                                                  accumulate=True)),
            "ef_roundtrip": (lambda: W.ef_roundtrip(s1, codec, r1),
                             lambda: W.ef_roundtrip_plain(s2, codec, r2))}


def _wire_bound(op, codec, n):
    """(bound_ms, bound_by) of one codec kernel on n elements: each input
    read once and each output written once over the HBM rate (the
    arithmetic is a few operations an element, far under the card's)."""
    wire = 2 * n if codec == "bf16" else \
        (n // 256) * 260 + (4 + n % 256 if n % 256 else 0)
    nbytes = {"encode": 4 * n + wire,
              "decode_accumulate": wire + 8 * n,     # read acc, write acc
              "ef_roundtrip": 16 * n}[op]            # seg and r, each way
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def wire_phase(hvt, K, timings):
    """The wire codec kernels: each held bit for bit against its plain
    version on the bench GPT's full gradient as one flat fp32 buffer and
    on edge-case buffers with tails of 1 and 255 elements, timed at the
    gradient's size; then the compressed route's code
    (``ops/hierarchical.py``) over the one-process world's group, one call
    a codec on that buffer with each parameter's error feedback, the
    kernels' launches counted. Returns those counts."""
    import torch

    from horovod_tpu_torch import compression
    from horovod_tpu_torch.compression import codecs as W
    from horovod_tpu_torch.ops import hierarchical

    hvt.init()
    grad, names, sizes = _gradient_buffer(hvt)
    n = grad.numel()
    if not torch.isfinite(grad).all():
        fail("wire: the gradient buffer is not finite")
    out = {"phase": "wire", "elements": n, "parameters": len(sizes),
           "bytes_fp32": 4 * n, "codecs": {}}
    for codec in WIRE_CODECS:
        row = {}
        for i, tail in enumerate(WIRE_TAILS):
            _wire_check(f"edge tail {tail}", W, codec,
                        _edge_buffer(256 * WIRE_BLOCKS + tail, seed=i))
        calls = _wire_check("gradient", W, codec, grad)
        for op in WIRE_OPS:
            name = f"wire_{op}_{codec}"
            kern, plain = calls[op]
            ms, host_ms = cuda_ms(kern, WIRE_ITERS)
            bound_ms, bound_by = _wire_bound(op, codec, n)
            lib = None
            if codec == "bf16" and op == "encode":
                lib = cuda_ms(lambda: grad.to(torch.bfloat16), WIRE_ITERS)[0]
            elif codec == "bf16" and op == "decode_accumulate":
                st, acc = W.encode(grad, codec), grad.clone()
                lib = cuda_ms(lambda: acc.add_(st.view(torch.bfloat16)),
                              WIRE_ITERS)[0]
            timings[name] = {"max_abs_err": 0.0, "ms": ms,
                             "plain_ms": cuda_ms(plain, 5)[0],
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "library_ms": lib}
            row[op] = dict(timings[name], wrapper_host_ms=host_ms,
                           x_bound=ms / bound_ms)
        out["codecs"][codec] = row
        torch.cuda.empty_cache()
    # the route's code on the gradient: a group of one member, so the own
    # chunk is summed raw and the gathered stream decoded, after error
    # feedback quantized each parameter's segment with its residual
    ps = hvt.global_process_set
    route = {}
    K.reset_launches()
    for codec in WIRE_CODECS:
        compression.configure({"HVT_WIRE_COMPRESSION": f"none,{codec}",
                               "HVT_EF_MAX_BYTES": str(8 * n)})
        buf = grad.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hierarchical.compressed_allreduce(buf, ps, ("flat", 1), names=names,
                                          segments=sizes)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want, off = grad.clone(), 0
        for k in sizes:     # a first residual is zeros: -0 + 0 is +0
            W.ef_roundtrip_plain(want[off:off + k], codec,
                                 torch.zeros(k, device=want.device))
            off += k
        want = W.roundtrip_plain(want, codec)
        if not _same_bits(buf, want):
            fail(f"wire route {codec}: the result is not the roundtrip of "
                 f"the error-fed gradient")
        route[codec] = {"ms": ms, "tx": compression.tx_bytes(),
                        "ef_residual_bytes": compression.state().ef.bytes}
    launches = dict(K.LAUNCHES)
    compression.configure()
    out["route"] = route
    out["launches"] = {k: v for k, v in launches.items() if v}
    emit(out)
    for codec in WIRE_CODECS:
        want = {f"wire_encode_{codec}": 2,
                f"wire_decode_accumulate_{codec}": 1,
                f"wire_ef_roundtrip_{codec}": len(sizes)}
        for name, count in want.items():
            if launches[name] != count:
                fail(f"wire route: {name} launched {launches[name]} times, "
                     f"expected {count}")
    if any(launches[k] for k in K.FLASH_KERNELS):
        fail(f"wire route: flash kernels launched: {launches}")
    del grad
    torch.cuda.empty_cache()
    return launches


def fleet_phase(main_losses):
    """The launcher's -np 1 job of the main path (tests/
    torch_port_launch_worker.py fleet: the bench GPT through train.train)
    with --timeline (the launcher's KV server), HVT_TELEMETRY_AGG=1 and
    HVT_DEBUGZ_INTERVAL_MS=FLEET_INTERVAL_MS; from step FLEET_POLL_FROM the
    worker reads /statusz and /debugz each step. Returns the worker's
    launch counts."""
    import torch

    out_dir = tempfile.mkdtemp(prefix="hvt_fleet_")
    out = os.path.join(out_dir, "res")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
           "1", "--master-port", str(port), "--timeline",
           os.path.join(out_dir, "timeline.json"), sys.executable,
           os.path.join(REPO, "tests", "torch_port_launch_worker.py"),
           "fleet", out, json.dumps({
               "device": "cuda", "config": "bench", "steps": FLEET_STEPS,
               "poll_from": FLEET_POLL_FROM, "batch": MAIN_SHAPE[0],
               "seq": MAIN_SHAPE[1]})]
    env = dict(os.environ, PYTHONPATH=REPO, HVT_TELEMETRY_AGG="1",
               HVT_DEBUGZ_INTERVAL_MS=str(FLEET_INTERVAL_MS))
    t0 = time.perf_counter()
    kept = tempfile.mkdtemp(prefix="hvt_fleet_timeline_")
    try:
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=600, env=env)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"fleet: the launcher exited {proc.returncode}:\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        res = torch.load(out + ".0.pt", weights_only=False)
        # the merged timeline, for the tools phase
        timeline_path = shutil.copy(os.path.join(out_dir, "timeline.json"),
                                    kept)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    st, dz = res["statusz"], res["debugz"]
    rec = st.get("ranks", {}).get("0", {})
    host = next(iter(st.get("hosts", {}).values()), {})
    families = (host.get("metrics") or {}).get("metrics") or {}
    coll = {s["labels"].get("op"): s["value"] for s in families.get(
        "hvt_collective_bytes_total", {}).get("samples", ())}
    emit({"phase": "fleet", "command": "python -m "
          "horovod_tpu_torch.runner.launch -np 1 --timeline ... python "
          "tests/torch_port_launch_worker.py fleet ...",
          "env": {"HVT_TELEMETRY_AGG": "1",
                  "HVT_DEBUGZ_INTERVAL_MS": FLEET_INTERVAL_MS},
          "seconds": seconds, "losses": res["losses"],
          "step_ms_median": statistics.median(res["step_s"][2:]) * 1e3,
          "statusz": {k: st.get(k) for k in (
              "schema", "mode", "ranks_expected", "ranks_covered",
              "missing_ranks", "alerts", "codecs", "totals", "rates",
              "health_windows", "ingest")},
          "rank_record": rec, "hvt_collective_bytes_total": coll,
          "debugz_telemetry_hosts": dz.get("telemetry_hosts"),
          "snapshot_bytes": res["snapshot_bytes"],
          "snapshot_build_host_ms": res["snapshot_ms"],
          "push_put_host_ms": res["put_ms"],
          "statusz_get_ms": res["statusz_ms"],
          "debugz_get_ms": res["debugz_ms"], "launches": res["launches"]})
    if st.get("schema") != "hvt-statusz-r1" or st.get("alerts") \
            or st.get("mode") != "leader" or not rec or rec.get("stale") \
            or st.get("ranks_covered") != 1:
        fail(f"fleet: /statusz {st.get('schema')}, mode {st.get('mode')}, "
             f"alerts {st.get('alerts')}, rank 0's record {rec}")
    if not coll.get("grouped_allreduce"):
        fail(f"fleet: no hvt_collective_bytes_total{{op=grouped_allreduce}} "
             f"in the host frame: {sorted(families)}")
    if not dz.get("telemetry_hosts") or dz.get("world", {}).get("size") != 1:
        fail(f"fleet: /debugz {dz}")
    rels = [abs(a - b) / abs(b) for a, b in zip(res["losses"], main_losses)]
    if max(rels) > LOSS_RTOL or not all(math.isfinite(x)
                                        for x in res["losses"]):
        fail(f"fleet: losses {res['losses']} are not within {LOSS_RTOL} of "
             f"the main path's {main_losses}")
    _sm90_only("fleet", res["launches"], FLEET_STEPS, MAIN_LAYERS)
    return res["launches"], timeline_path, res["hvt_top"]


def elastic_launch_phase():
    """The elastic launcher's one-card job: a SIGTERM after commit
    ELASTIC_SIGTERM_AFTER becomes HostsUpdatedInterrupt at the next commit,
    the worker re-rendezvouses into round 2 and finishes the epoch. Returns
    the worker's launch counts."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_port_elastic_worker as EW

    out_dir = tempfile.mkdtemp(prefix="hvt_elastic_")
    rows = ELASTIC_LAUNCH_STEPS * MAIN_SHAPE[0]
    try:
        job = EW.ElasticLaunch(1, os.path.join(out_dir, "res"), {
            "device": "cuda", "config": "bench", "rows": rows,
            "batch": MAIN_SHAPE[0], "timeout_s": 300,
            "sigterm_after_commit": ELASTIC_SIGTERM_AFTER},
            min_np=1, timeout=300)
        try:
            lives, rounds, seconds = job.results()
        except AssertionError as e:
            fail(f"elastic launch: the job failed: {str(e)[-4000:]}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    a = EW.analyze(lives, rounds)
    life = lives[0]
    kinds = [e["kind"] for e in life["events"]]
    updated = [e for e in life["events"] if e["kind"] == "hosts_updated"]
    emit({"phase": "elastic_launch", "command": "python -m "
          "horovod_tpu_torch.runner.launch -np 1 --min-np 1 "
          "--host-discovery-script ... python "
          "tests/torch_port_elastic_worker.py ...",
          "seconds": seconds, "rounds": rounds,
          "worker_start_to_first_entry_s": [
              e["t"] for e in life["events"] if e["kind"] == "enter"][0]
          - life["t_start"], "events": kinds,
          "recoveries": life["recoveries"], "devices": a["devices"],
          "losses": life["losses"], "launches": life["launches"],
          "max_memory_allocated_bytes":
              life.get("max_memory_allocated_bytes")})
    counts = a["committed_counts"]
    if len(lives) != 1 or [r["size"] for r in rounds] != [1, 1] \
            or not updated \
            or updated[0]["commit"] != ELASTIC_SIGTERM_AFTER + 1:
        fail(f"elastic launch: expected one worker, rounds of one and a "
             f"host update at commit {ELASTIC_SIGTERM_AFTER + 1}; got "
             f"{len(lives)} lives, rounds {rounds}, events {kinds}")
    if sorted(counts) != list(range(rows)) or set(counts.values()) != {1} \
            or a["devices"] != ["cuda:0"] or not a["losses_finite"]:
        fail(f"elastic launch: rows {counts}, devices {a['devices']}")
    _sm90_only("elastic launch", life["launches"], ELASTIC_LAUNCH_STEPS,
               MAIN_LAYERS)
    return life["launches"]


def serving_phase(hvt, K):
    """The port's serving gang on one card (a gang of one): the load
    generator's run_loadtest in this process with r07's traffic at
    --replicas 1 (SERVING_ARGV; its contended phase bursts 8 requests into a
    window of 4, so it sheds), once per HVT_SERVING_BATCH of
    SERVING_BATCHES. Every artifact must be valid, every result exact
    (members x (payload + k), checked after each phase outside the timed
    reaps), the contended phase must shed and the baseline not, on cuda:0.
    A replica of one rank sends nothing (the allreduce over a set of one
    returns at once): this drives admission, shedding, batching and latency
    accounting; four cards' NCCL lanes are SERVE4's
    (tests/test_torch_port_cuda.py). Returns the launch counts (none
    expected)."""
    from horovod_tpu_torch.serving import loadgen

    old = os.environ.get("HVT_SERVING_BATCH")
    runs = {}
    K.reset_launches()
    try:
        for batch in SERVING_BATCHES:
            os.environ["HVT_SERVING_BATCH"] = str(batch)
            args = loadgen._parser().parse_args(SERVING_ARGV)
            t0 = time.perf_counter()
            doc = loadgen.run_loadtest(args)
            runs[batch] = (doc, time.perf_counter() - t0)
            hvt.shutdown()
    finally:
        if old is None:
            os.environ.pop("HVT_SERVING_BATCH", None)
        else:
            os.environ["HVT_SERVING_BATCH"] = old
    launches = dict(K.LAUNCHES)
    for batch, (doc, seconds) in runs.items():
        phases = {p: ph["ranks"][0] for p, ph in doc["phases"].items()}
        emit({"phase": "serving", "command": "loadgen.run_loadtest "
              + " ".join(SERVING_ARGV), "HVT_SERVING_BATCH": batch,
              "seconds": seconds, "device": doc["config"]["device"],
              "phases": {p: {k: s[k] for k in (
                  "admitted", "shed", "completed", "deadline_miss",
                  "batches", "p50_ms", "p99_ms", "throughput_rps",
                  "checked", "wrong", "max_abs_err")} | {
                  "host_us_per_completed_request":
                      1e6 / s["throughput_rps"]}
                  for p, s in phases.items()}})
        errs = loadgen.validate_artifact(doc)
        if errs or doc["config"]["device"] != "cuda:0":
            fail(f"serving: batch {batch}: artifact {errs} on "
                 f"{doc['config']['device']}")
        for p, s in phases.items():
            if s["wrong"] or s["checked"] != s["admitted"] \
                    or not s["admitted"]:
                fail(f"serving: batch {batch} {p}: {s['wrong']} wrong of "
                     f"{s['checked']} checked, {s['admitted']} admitted")
        if not phases["contended"]["shed"] or phases["baseline"]["shed"]:
            fail(f"serving: batch {batch}: shed {phases['contended']['shed']}"
                 f" contended, {phases['baseline']['shed']} baseline")
    if any(launches.values()):
        fail(f"serving: kernels launched: {launches}")
    return launches


def run_api_phase(main_losses):
    """horovod_tpu_torch.runner.run(fn, np=1) on the card: the launcher's
    one worker (the task runner) takes RUN_STEPS steps of the main path's
    GPT on cuda:0; the losses within 1e-2 of the main path's, 12 launches
    a step of each sm90 kernel, none SIMT. Returns the worker's launch
    counts."""
    from horovod_tpu_torch.runner import run

    def fn(steps, batch, seq):
        # made here, so that cloudpickle ships it by value
        import torch

        from horovod_tpu_torch.ops import _kernels
        from horovod_tpu_torch.train import gpt_config, train

        cfg = gpt_config("bench", use_flash=True, dtype=torch.bfloat16)
        _kernels.reset_launches()
        res = train(cfg, steps, batch, seq, seed=0)
        return {"losses": res["loss"], "launches": dict(_kernels.LAUNCHES),
                "device": str(next(res["model"].parameters()).device),
                "step_s": res["step_s"]}

    t0 = time.perf_counter()
    try:
        (res,) = run(fn, args=(RUN_STEPS, MAIN_SHAPE[0], MAIN_SHAPE[1]),
                     np=1)
    except RuntimeError as e:
        fail(f"run: {e}")
    seconds = time.perf_counter() - t0
    emit({"phase": "run", "call": "horovod_tpu_torch.runner.run(fn, np=1)",
          "seconds": seconds, "device": res["device"],
          "losses": res["losses"], "main_path_losses":
          main_losses[:RUN_STEPS], "step_s": res["step_s"],
          "launches": res["launches"]})
    if res["device"] != "cuda:0":
        fail(f"run: the worker trained on {res['device']}")
    rels = [abs(a - b) / abs(b) for a, b in zip(res["losses"], main_losses)]
    if len(rels) != RUN_STEPS or max(rels) > LOSS_RTOL:
        fail(f"run: losses {res['losses']} are not within {LOSS_RTOL} of "
             f"the main path's {main_losses[:RUN_STEPS]}")
    _sm90_only("run", res["launches"], RUN_STEPS, MAIN_LAYERS)
    return res["launches"]


def estimator_phase(hvt, K):
    """TorchEstimator._fit_arrays through the in-process _local_run: a small
    MLP on ESTIMATOR_ROWS seeded rows, ESTIMATOR_EPOCHS epochs, a
    FilesystemStore under a temporary directory, first on the card (the
    estimator's default device), then the same fit on the CPU (gloo);
    TorchModel.load from each store and predict on the card. The card's
    per-epoch losses within ESTIMATOR_RTOL of the CPU's, every epoch's
    checkpoint published, the predictions of the loaded model equal the
    fitted one's. Returns the card fit's launch counts (none expected)."""
    import numpy as np
    import torch

    from horovod_tpu_torch.spark import Store, TorchEstimator, TorchModel

    rng = np.random.RandomState(0)
    X = rng.randn(ESTIMATOR_ROWS, ESTIMATOR_FEATURES).astype(np.float32)
    y = np.tanh(X @ rng.randn(ESTIMATOR_FEATURES).astype(np.float32))
    cols = [f"f{i}" for i in range(ESTIMATOR_FEATURES)]

    def mlp():
        torch.manual_seed(0)
        return torch.nn.Sequential(
            torch.nn.Linear(ESTIMATOR_FEATURES, 64), torch.nn.Tanh(),
            torch.nn.Linear(64, 1))

    class Losses:               # the estimator's callback
        def __init__(self):
            self.losses = []

        def on_epoch_end(self, epoch, logs):
            self.losses.append(logs["loss"])

    hvt.shutdown()
    fits = {}
    for device in ("cuda", "cpu"):
        tmp = tempfile.mkdtemp(prefix="hvt_est_")
        seen = Losses()
        try:
            store = Store.create(os.path.join(tmp, "st"))
            est = TorchEstimator(
                model=mlp(), optimizer_fn=lambda p: torch.optim.SGD(
                    p, lr=0.05), feature_cols=cols, label_col="y",
                epochs=ESTIMATOR_EPOCHS, batch_size=ESTIMATOR_BATCH,
                store=store, run_id="smoke", callbacks=[seen],
                device=None if device == "cuda" else "cpu")
            K.reset_launches()
            t0 = time.perf_counter()
            model = est._fit_arrays(X, y)
            seconds = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
            trained_on = str(hvt.device())
            hvt.shutdown()
            published = [store.exists(store.get_run_path("smoke")
                                      + f"/checkpoint-{e}.pt")
                         for e in range(ESTIMATOR_EPOCHS)]
            loaded = TorchModel.load(store, "smoke", mlp())
            loaded.model.cuda()
            pred = loaded._predict_arrays(X)
            want = model._predict_arrays(X)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        fits[device] = {"losses": seen.losses,
                        "seconds": seconds, "trained_on": trained_on,
                        "published": published, "launches": launches,
                        "pred_max_abs_diff": float(np.abs(pred - want).max()),
                        "mse": float(np.mean((pred - y) ** 2))}
    rels = [abs(a - b) / abs(b) for a, b in zip(fits["cuda"]["losses"],
                                                 fits["cpu"]["losses"])]
    emit({"phase": "estimator", "rows": ESTIMATOR_ROWS,
          "epochs": ESTIMATOR_EPOCHS, "batch": ESTIMATOR_BATCH,
          "fits": fits, "rel_diff": rels, "rtol": ESTIMATOR_RTOL})
    if fits["cuda"]["trained_on"] != "cuda:0" \
            or fits["cpu"]["trained_on"] != "cpu":
        fail(f"estimator: fits ran on {fits['cuda']['trained_on']} and "
             f"{fits['cpu']['trained_on']}")
    if max(rels) > ESTIMATOR_RTOL or len(rels) != ESTIMATOR_EPOCHS:
        fail(f"estimator: card losses {fits['cuda']['losses']} vs CPU "
             f"{fits['cpu']['losses']}: rel diff {rels} > {ESTIMATOR_RTOL}")
    for device, f in fits.items():
        if not all(f["published"]) or f["pred_max_abs_diff"] > 1e-5 \
                or not f["losses"][-1] < f["losses"][0]:
            fail(f"estimator: {device} fit {f}")
    if any(fits["cuda"]["launches"].values()):
        fail(f"estimator: kernels launched: {fits['cuda']['launches']}")
    return fits["cuda"]["launches"]


def _start_example(launcher, script, argv, report=None):
    """One example through the port's launcher at -np 1 on the card,
    started: its process and start time."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
           "1", *launcher, "--master-port", str(port), sys.executable,
           os.path.join(REPO, "examples", "torch_port", script), *argv]
    if report:
        cmd += ["--report", report]
    return subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, PYTHONPATH=REPO)), \
        time.perf_counter()


def examples_phase():
    """Every example of examples/torch_port/ on the card (module docstring,
    phase 22), the launches started together (one card holds them all).
    Returns long_context_train's launch counts."""
    import importlib.util

    import torch

    out_dir = tempfile.mkdtemp(prefix="hvt_examples_")
    started, runs, reports, attention = {}, {}, {}, {}
    try:
        for tag, launcher, script, argv, want in EXAMPLES:
            if tag.startswith("long_context"):
                reports[tag] = os.path.join(out_dir, tag + ".json")
                attention[tag] = os.path.join(out_dir, tag + ".pt")
                argv = argv + ["--attention-report", attention[tag]]
            started[tag] = (*_start_example(launcher, script, argv,
                                            reports.get(tag)), script, want)
        for tag, (proc, t0, script, want) in started.items():
            log = proc.communicate(timeout=600)[0]
            runs[tag] = {"seconds": time.perf_counter() - t0,
                         "tail": log.strip().splitlines()[-3:]}
            if proc.returncode != 0 or want not in log:
                fail(f"examples: {script} exited {proc.returncode} without "
                     f"{want!r}:\n{log[-3000:]}")
        for tag, path in list(reports.items()):
            with open(path) as f:
                reports[tag] = json.load(f)
            attention[tag] = torch.load(attention[tag])
    finally:
        for proc, *_ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    skipped = {}
    for tag, module, script in OPTIONAL_EXAMPLES:
        if importlib.util.find_spec(module) is None:
            skipped[tag] = f"{script}: no {module} here"
        else:
            runs[tag] = _run_optional_example(script)
    flash, plain = reports["long_context"], reports["long_context_plain"]
    rels = [abs(a - b) / abs(b) for a, b in zip(flash["losses"],
                                                plain["losses"])]
    # the first batch's attention and gradients, each gradient relative to
    # its largest magnitude
    vs_einsum = {}
    for t, got in attention["long_context"].items():
        ref = attention["long_context_plain"][t]
        unit = 1.0 if t == "o" else float(ref.abs().max())
        e = check(f"examples: long_context_train's flash {t} vs einsum",
                  got / unit, ref / unit,
                  TOL_PLAIN["bfloat16"] if t == "o"
                  else TOL_AUTOGRAD["bfloat16"])
        vs_einsum[t] = {"shape": list(got.shape),
                        "max_abs_err": e[0] * unit, "least_tol": e[2],
                        "unit": unit}
    emit({"phase": "examples", "runs": runs, "skipped": skipped,
          "long_context": {"argv": LONG_CONTEXT_ARGV,
                           "losses_flash": flash["losses"],
                           "losses_einsum": plain["losses"],
                           "max_rel_diff": max(rels),
                           "attention_vs_einsum": vs_einsum,
                           "tol": {"o": TOL_PLAIN["bfloat16"],
                                   "grads": TOL_AUTOGRAD["bfloat16"]},
                           "launches": flash["launches"]}})
    if len(rels) != LONG_CONTEXT_STEPS or max(rels) > LONG_CONTEXT_RTOL:
        fail(f"examples: long_context_train's flash losses "
             f"{flash['losses']} are not within {LONG_CONTEXT_RTOL} of the "
             f"einsum blocks' {plain['losses']}")
    for name, n in flash["launches"].items():
        if (n < LONG_CONTEXT_STEPS) if name.endswith("_sm90") else n:
            fail(f"examples: long_context_train launched {name} {n} times "
                 f"in {LONG_CONTEXT_STEPS} steps")
    if any(plain["launches"].values()):
        fail(f"examples: the einsum run launched {plain['launches']}")
    return flash["launches"]


def _run_optional_example(script):
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch_port",
                                      script)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO))
    if proc.returncode != 0:
        fail(f"examples: {script} exited {proc.returncode}:\n"
             f"{(proc.stdout + proc.stderr)[-3000:]}")
    return {"seconds": time.perf_counter() - t0}


def tools_phase(timeline_path, hvt_top):
    """hvt_analyze over the fleet phase's timeline, and the fleet worker's
    hvt_top --once --json (module docstring, phase 23)."""
    report = timeline_path + ".report.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tools.hvt_analyze",
         timeline_path, "-o", report, "--quiet"], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"tools: hvt_analyze exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    with open(report) as f:
        rep = json.load(f)
    shutil.rmtree(os.path.dirname(timeline_path), ignore_errors=True)
    try:
        statusz = json.loads(hvt_top["stdout"])
    except ValueError:
        statusz = {}
    emit({"phase": "tools", "hvt_analyze_seconds": seconds,
          "ranks": rep["ranks"], "instances": rep["instances"],
          "phases": rep["phases"], "lanes": rep["lanes"],
          "overlap_efficiency": rep["overlap_efficiency"],
          "metrics": rep["metrics"], "hvt_top_rc": hvt_top["rc"],
          "hvt_top_ms": hvt_top["ms"],
          "hvt_top_statusz": {k: statusz.get(k) for k in (
              "schema", "mode", "ranks_expected", "ranks_covered",
              "alerts")}})
    exec_n = (rep["phases"].get("exec") or {}).get("count", 0)
    if rep["ranks"] != [0] or exec_n < FLEET_STEPS:
        fail(f"tools: hvt_analyze found ranks {rep['ranks']} and {exec_n} "
             f"exec spans in the fleet timeline; expected rank 0 and at "
             f"least {FLEET_STEPS}")
    if hvt_top["rc"] != 0 or statusz.get("schema") != "hvt-statusz-r1" \
            or statusz.get("ranks_covered") != 1:
        fail(f"tools: hvt_top --once --json exited {hvt_top['rc']} with "
             f"{hvt_top['stdout'][:500]!r} {hvt_top['stderr']!r}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script drives the "
             "port on a GPU")
    import horovod_tpu_torch as hvt
    from horovod_tpu_torch.ops import _kernels as K
    from horovod_tpu_torch.ops.flash_attention import \
        flash_attention_reference

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0)})
    # plain versions and references in true fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = K.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: p.name for n, p in libs.items()},
          "ptxas": {n: ptxas_summary(log)
                    for n, log in K.build_log().items()}})
    # the wide-head instances (padded width 192 and 256) on their own
    emit({"phase": "build", "wide_head_instances": {
        n: [line for line in ptxas_summary(log)
            if "wide_kernel" in line or "ILi192E" in line or "ILi256E" in line]
        for n, log in K.build_log().items() if n.endswith("_sm90")}})
    # the widest heads' instances (padded width 384 and 512)
    emit({"phase": "build", "widest_head_instances": {
        n: [line for line in ptxas_summary(log)
            if "ILi384E" in line or "ILi512E" in line]
        for n, log in K.build_log().items() if n.endswith("_sm90")}})
    timings = {}
    for case in CASES:
        kernel_phase(case, K, flash_attention_reference, timings)
        torch.cuda.empty_cache()

    launches, *trained, main_losses = main_path(hvt, K)
    profile_phase(*trained, launches)
    main_step_s = trained[-1]
    del trained
    t0 = time.perf_counter()
    entry_launches = entry_phase(K)
    emit({"phase": "slice13_seconds", "entry": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    observe_launches = observe_phase(hvt, K, main_losses, main_step_s)
    acc_launches, model, optimizer = accumulation_phase(hvt, K, main_losses)
    collectives_phase(hvt, model, optimizer)
    del model, optimizer
    torch.cuda.empty_cache()
    ckpt_launches, restored_launches = checkpoint_phase(hvt, K)
    fsdp_launches = fsdp_phase(hvt, K, main_losses)
    hvt.shutdown()
    torch.cuda.empty_cache()
    seq_launches = sequence_phase(K, flash_attention_reference)
    torch.cuda.empty_cache()
    bench_launches = bench_phase(K)
    hvt.shutdown()
    torch.cuda.empty_cache()
    vision_phase()
    hvt.shutdown()
    torch.cuda.empty_cache()
    launch_launches = launch_phase(main_losses)
    elastic_launches = elastic_phase(hvt, K, main_losses)
    hvt.shutdown()
    torch.cuda.empty_cache()
    elastic_launch_launches = elastic_launch_phase()
    fleet_launches, fleet_timeline, hvt_top = fleet_phase(main_losses)
    wire_launches = wire_phase(hvt, K, timings)
    hvt.shutdown()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serving_launches = serving_phase(hvt, K)
    t1 = time.perf_counter()
    run_launches = run_api_phase(main_losses)
    t2 = time.perf_counter()
    estimator_launches = estimator_phase(hvt, K)
    emit({"phase": "slice11_seconds", "serving": t1 - t0, "run": t2 - t1,
          "estimator": time.perf_counter() - t2})
    hvt.shutdown()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    examples_launches = examples_phase()
    t1 = time.perf_counter()
    tools_phase(fleet_timeline, hvt_top)
    emit({"phase": "slice12_seconds", "examples": t1 - t0,
          "tools": time.perf_counter() - t1})
    # last: run before the observe phase on the card, it was followed by
    # three of three profiler sessions there that lost their first records
    t0 = time.perf_counter()
    wide_launches = wide_head_phase(K)
    hvt.shutdown()
    emit({"phase": "wide_head_seconds", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    wide_fp32_launches = wide_head_phase(K, "float32")
    hvt.shutdown()
    emit({"phase": "wide_head_fp32_seconds",
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    ring_wide_launches, ring_wide_block_launches = ring_wide_head_phase(
        hvt, K, flash_attention_reference)
    hvt.shutdown()
    emit({"phase": "ring_wide_head_seconds",
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    gpt_fp16_launches = gpt_fp16_phase(K)
    hvt.shutdown()
    emit({"phase": "gpt_fp16_seconds", "seconds": time.perf_counter() - t0})
    head512_launches = {}
    for dtype_name in ("bfloat16", "float16"):
        t0 = time.perf_counter()
        head512_launches[dtype_name] = head512_phase(K, dtype_name)
        hvt.shutdown()
        torch.cuda.empty_cache()
        emit({"phase": f"head512_{dtype_name}_seconds",
              "seconds": time.perf_counter() - t0})

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE[name],
         "replaces": REPLACES[name],
         # a codec kernel's path is the compressed route (wire phase)
         "launches": wire_launches[name] if name in K.CODEC_KERNELS
         else launches[name],
         "launches_from": WIRE_LAUNCHES_FROM if name in K.CODEC_KERNELS
         else "main_path",
         "launches_main_path": launches[name],
         "launches_fleet": fleet_launches[name],
         "launches_observe": observe_launches[name],
         "launches_accumulation": acc_launches[name],
         "launches_sequence": seq_launches[name],
         "launches_bench_outside_replays": bench_launches[name],
         "launches_checkpoint": ckpt_launches[name],
         "launches_checkpoint_restored_steps": restored_launches[name],
         "launches_fsdp": fsdp_launches[name],
         "launches_launch": launch_launches[name],
         "launches_elastic": elastic_launches[name],
         "launches_elastic_launch": elastic_launch_launches[name],
         "launches_serving": serving_launches[name],
         "launches_run": run_launches[name],
         "launches_estimator": estimator_launches[name],
         "launches_examples_long_context": examples_launches[name],
         "launches_entry_fp32": entry_launches[f"{name}@float32"],
         "launches_entry_bf16": entry_launches[f"{name}@bfloat16"],
         "launches_wide_head": wide_launches[name],
         "launches_wide_head_fp32": wide_fp32_launches[name],
         "launches_ring_wide_head": ring_wide_launches[name],
         "launches_ring_wide_head_blocks": ring_wide_block_launches[name],
         "launches_gpt_fp16": gpt_fp16_launches[name],
         "launches_head512": head512_launches["bfloat16"][name],
         "launches_head512_fp16": head512_launches["float16"][name],
         **line_timing(K, name, timings)} for name in K.LAUNCHES]})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
