"""The port's Spark estimator (the JAX package's
``examples/spark/spark_estimator.py``; Horovod's ``examples/spark/``):
DataFrame → distributed fit → Transformer, with checkpoints in a Store.
Needs pyspark:

    spark-submit examples/torch_port/spark_estimator.py [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np
import torch


class PrintLoss:
    def on_epoch_end(self, epoch, logs):
        print(f"epoch {epoch}: loss {logs['loss']:.4f}")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--store", default=os.path.join(tempfile.gettempdir(),
                                                   "hvt_torch_spark_store"))
    args = p.parse_args()

    from pyspark.sql import SparkSession

    from horovod_tpu_torch.spark import Store, TorchEstimator, TorchModel

    spark = SparkSession.builder.master("local[2]").getOrCreate()
    rs = np.random.RandomState(0)
    X = rs.randn(512, 3).astype(np.float32)
    y = X @ np.asarray([0.5, -1.0, 2.0], np.float32)
    df = spark.createDataFrame(
        [(float(a), float(b), float(c), float(t))
         for (a, b, c), t in zip(X, y)],
        ["a", "b", "c", "y"])
    store = Store.create(args.store)
    est = TorchEstimator(
        model=torch.nn.Linear(3, 1),
        optimizer_fn=lambda params: torch.optim.SGD(params, lr=0.1),
        feature_cols=["a", "b", "c"], label_col="y",
        num_proc=2, epochs=5, batch_size=32, store=store,
        run_id="example-run", callbacks=[PrintLoss()], device=args.device)
    model = est.fit(df)
    model.transform(df).select("y", "prediction").show(5)
    # restore from the store anywhere
    restored = TorchModel.load(store, "example-run", torch.nn.Linear(3, 1))
    print("restored prediction[0]:",
          float(restored._predict_arrays(X[:1])[0]))


if __name__ == "__main__":
    main()
