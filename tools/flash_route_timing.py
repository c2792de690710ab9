#!/usr/bin/env python3
"""Run chip_smoke.py's kernels phase (checks and timings) for the flash
kernels of this checkout, or of another whole checkout, so that two
versions of the kernels (sources and wrappers) can be compared on one card
in one call:

    python tools/flash_route_timing.py                 # this checkout
    python tools/flash_route_timing.py --repo DIR      # the checkout in DIR
    python tools/flash_route_timing.py --shapes main ring routes

Unpack the other checkout into an ignored directory of this one (for
example ``git archive <commit> | tar -x -C _archive/parent``) and run the
two in turns (A, B, B, A). Each run imports that checkout's
``horovod_tpu_torch`` and ``chip_smoke.py``, builds its kernel sources into
its own ``horovod_tpu_torch/csrc/build``, prints ptxas's summary of every
tensor-core kernel it built (``PTXAS`` lines), then one JSON line per
kernel check and timing, as chip_smoke.py does, at the shapes of each
name given to ``--shapes``, in that order: ``routes``
(chip_smoke.ROUTE_SHAPES, the default), ``main`` (chip_smoke.MAIN_SHAPE),
``ring`` (chip_smoke.RING_CASES, the sequence ring's blocks, whose checks
include each bf16 kernel's distance to the plain version with fp32
operands; after ``main``, also held to the main shape's), ``ring_wide``
(chip_smoke.RING_WIDE_CASE, a ring block at head_dim 128), ``wide``
(chip_smoke.WIDE_SHAPES, bf16 at head_dim 192 and 256),
``ring_wide_head`` (chip_smoke.RING_WIDE_HEAD_CASES, the ring's blocks at
head_dim 256 and 192), ``off_grid`` (chip_smoke.OFF_GRID_SHAPES,
head_dims off the kernels' grid of 8), ``wide_fp32``
(chip_smoke.WIDE_FP32_SHAPES and WIDE_FP32_CHECKED, fp32 at head_dim 136
to 256), ``fp16`` (chip_smoke.FP16_CASES, fp16 q with an fp16 or the
ring's fp32 o) and ``xwide`` (chip_smoke.XWIDE_SHAPES and XWIDE_CHECKED,
bf16 and fp16 at head_dim 264 to 512), each in checkouts that have it.
Every shape it runs is timed. Needs a CUDA card.
"""

import argparse
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", help="a checkout whose kernels to run "
                    "(default: this one)")
    ap.add_argument("--shapes", nargs="+",
                    choices=("routes", "main", "ring", "ring_wide", "wide",
                             "ring_wide_head", "off_grid", "wide_fp32",
                             "fp16", "xwide"),
                    default=["routes"])
    args = ap.parse_args()
    root = Path(args.repo).resolve() if args.repo else REPO
    os.chdir(root)
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("flash_route_timing: needs a CUDA card")
    import chip_smoke as C
    from horovod_tpu_torch.ops import _kernels as K
    from horovod_tpu_torch.ops.flash_attention import \
        flash_attention_reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"REPO {root}", flush=True)
    K.build()
    for name, log in K.build_log().items():
        if name.endswith("_sm90"):
            for line in C.ptxas_summary(log):
                print("PTXAS", line, flush=True)
    shapes = {"routes": lambda: C.ROUTE_SHAPES, "main": lambda: [C.MAIN_SHAPE],
              "ring": lambda: C.RING_CASES,
              "ring_wide": lambda: [C.RING_WIDE_CASE],
              "wide": lambda: C.WIDE_SHAPES,
              "ring_wide_head": lambda: C.RING_WIDE_HEAD_CASES,
              "off_grid": lambda: C.OFF_GRID_SHAPES,
              "wide_fp32": lambda: C.WIDE_FP32_SHAPES + C.WIDE_FP32_CHECKED,
              "fp16": lambda: C.FP16_CASES,
              "xwide": lambda: C.XWIDE_SHAPES + C.XWIDE_CHECKED}
    cases = [c for name in args.shapes for c in shapes[name]()]
    # kernel_phase times only the shapes in TIMED
    C.TIMED.extend(c for c in cases if c not in C.TIMED)
    for case in cases:
        C.kernel_phase(case, K, flash_attention_reference, {})
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
