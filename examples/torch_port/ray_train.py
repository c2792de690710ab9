"""The port's Ray executor (the JAX package's ``examples/ray/ray_train.py``;
Horovod's ``examples/ray/``). Needs a Ray installation:

    python examples/torch_port/ray_train.py [--device cpu]

Each Ray worker gets one card unless ``--device cpu``.
"""

import argparse


def train_fn():
    import torch

    import horovod_tpu_torch as hvt

    val = hvt.allreduce(torch.tensor([float(hvt.rank())],
                                     device=hvt.device()),
                        name="x", average=True)
    return float(val[0]), hvt.rank(), hvt.size()


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args()

    import ray

    from horovod_tpu_torch.ray import RayExecutor

    ray.init()
    executor = RayExecutor(num_workers=2, cpus_per_worker=1,
                           use_gpu=args.device != "cpu")
    executor.start()
    print(executor.run(train_fn))
    executor.shutdown()
