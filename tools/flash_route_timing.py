#!/usr/bin/env python3
"""Run chip_smoke.py's kernels phase (checks and timings) at its route
shapes for the flash kernels of this checkout, or of another copy of
``horovod_tpu_torch/csrc``, so that two versions of the kernel sources can
be compared on one card in one call:

    python tools/flash_route_timing.py                  # this checkout
    python tools/flash_route_timing.py --csrc DIR       # sources in DIR

Put the other copy in an ignored directory of the checkout (for example
``horovod_tpu_torch/csrc/build/parent``, made by ``git archive``) and run
the two in turns (A, B, B, A). Each run builds its sources into
``DIR/build``, prints ptxas's summary of every tensor-core kernel it built
(``PTXAS`` lines), then one JSON line per kernel check and timing, as
chip_smoke.py does. Needs a CUDA card.
"""

import argparse
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", help="a directory holding the kernel sources "
                    "(default: this checkout's horovod_tpu_torch/csrc)")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        sys.exit("flash_route_timing: needs a CUDA card")
    from horovod_tpu_torch.ops import _kernels as K
    if args.csrc:
        K.CSRC = Path(args.csrc).resolve()
        K.BUILD_DIR = K.CSRC / "build"
    import chip_smoke as C
    from horovod_tpu_torch.ops.flash_attention import \
        flash_attention_reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K.build()
    for name, log in K.build_log().items():
        if name.endswith("_sm90"):
            for line in C.ptxas_summary(log):
                print("PTXAS", line, flush=True)
    for case in C.ROUTE_SHAPES:
        C.kernel_phase(case, K, flash_attention_reference, {})
        torch.cuda.empty_cache()


if __name__ == "__main__":
    os.chdir(REPO)
    main()
