"""Horovod on Spark with the port (the JAX package's
``examples/spark/spark_train.py``; Horovod's ``examples/spark/pytorch/``).
Needs pyspark:

    spark-submit examples/torch_port/spark_train.py [--device cpu]
"""

import argparse


def train_fn():
    import torch

    import horovod_tpu_torch as hvt

    val = hvt.allreduce(torch.tensor([float(hvt.rank() + 1)],
                                     device=hvt.device()),
                        name="s", average=False)
    return float(val[0]), hvt.rank(), hvt.size()


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args()

    import horovod_tpu_torch.spark as hvt_spark

    print(hvt_spark.run(train_fn, num_proc=2, device=args.device))
