"""The Spark ML estimator of the port (the JAX package's
``spark/estimator.py``, its torch flavor; Horovod's
``spark/torch/estimator.py:91`` TorchEstimator with the executor loop of
``spark/torch/remote.py``): DataFrame -> distributed fit -> a Spark
Transformer, with ``Store``-backed checkpoints and callbacks in the
executor's training loop.

:class:`TorchEstimator` owns an epoch-structured training loop (a module,
an optimizer factory and a loss). Each worker trains through
``horovod_tpu_torch``: ``DistributedOptimizer`` combines the gradients and
``broadcast_parameters`` starts every rank from rank 0's weights; the model
and its batches live on ``hvt.device()``, the card unless the estimator is
given ``device="cpu"``. Rank 0 publishes a checkpoint each epoch through the
store's local-scratch-dir and ``sync_fn`` contract and calls ``callbacks``
(``on_epoch_end(epoch, logs)``); checkpoints and results are CPU tensors.

By default the (feature, label) columns are collected and broadcast once,
and each barrier task trains on its strided shard. ``out_of_core=True``
materializes per-partition ``.npz`` shard files into the store on the
executors and streams them file at a time (``spark/data.py``, the
counterpart of Horovod's Petastorm store).

``fit(df)`` splits into a Spark-facing half and a pure
``_fit_arrays(X, y, run_fn=...)``, so a fit, its checkpoints, ``load`` and
predict run without pyspark through ``_local_run`` (one process, in
process).

The JAX package's ``JaxEstimator`` and ``KerasEstimator`` serve other
frameworks and are not ported.
"""

from __future__ import annotations

import io
import json
import pickle
import uuid
from typing import Callable, List, Optional


def _pickle_dumps(obj) -> bytes:
    """cloudpickle when available (ships with pyspark; needed for closures
    and lambdas), stdlib pickle otherwise."""
    try:
        import cloudpickle

        return cloudpickle.dumps(obj)
    except ImportError:
        return pickle.dumps(obj)


def _local_run(worker, num_proc=None, **_kw):
    """The in-process run_fn: world size 1, this process."""
    return [worker()]


def _steps_per_epoch(global_rows: int, n_procs: int, batch_size: int
                     ) -> int:
    """Identical step count on every rank (largest shard, rounded up): the
    per-step gradient collectives must stay in lockstep even when shard
    sizes differ by one."""
    shard_max = (global_rows + n_procs - 1) // max(n_procs, 1)
    return max(1, (shard_max + batch_size - 1) // batch_size)


def _train_val_split(total: int, validation):
    """Deterministic global train/validation split, identical on every rank
    (a seeded permutation; no coordination). ``validation`` is None or a
    fraction in (0, 1). Each rank evaluates the whole hold-out, which keeps
    ranks trivially in lockstep."""
    import numpy as np

    if not validation:
        return np.arange(total), np.asarray([], np.int64)
    if not 0.0 < float(validation) < 1.0:
        raise ValueError(
            f"validation={validation} must be a fraction in (0, 1)")
    n_val = max(1, int(total * float(validation)))
    if n_val >= total:
        raise ValueError(
            f"validation={validation} leaves no training rows")
    perm = np.random.RandomState(9172).permutation(total)
    return np.sort(perm[n_val:]), np.sort(perm[:n_val])


def _shard_rows(global_rows: int, r: int, n: int):
    """Row indices of rank ``r``'s shard (strided, like Petastorm's
    row-group sharding). Every rank must come back non-empty (a rank with no
    rows could not run the lockstep per-step collectives), so with fewer
    rows than ranks the tail ranks wrap around."""
    import numpy as np

    rows = np.arange(global_rows)[r::n]
    if rows.size == 0 and global_rows > 0:
        rows = np.asarray([r % global_rows])
    return rows


def _spark_transform(df, predict, feature_cols, output_col):
    """The Transformer's body: batched inference by mapPartitions,
    appending ``output_col``."""
    from horovod_tpu_torch.spark.runner import _require_pyspark

    _require_pyspark()
    import numpy as np
    from pyspark.sql import Row
    from pyspark.sql.types import DoubleType, StructField, StructType

    def infer(rows_iter):
        rows = list(rows_iter)
        if not rows:
            return
        Xp = np.asarray([[rw[c] for c in feature_cols] for rw in rows],
                        dtype=np.float32)
        for rw, pv in zip(rows, np.asarray(predict(Xp)).reshape(-1)
                          .tolist()):
            d = rw.asDict()
            d[output_col] = float(pv)
            yield Row(**d)

    # an explicit schema: inference from an empty RDD fails, and the
    # empty-input case must still yield the prediction column
    schema = StructType(df.schema.fields
                        + [StructField(output_col, DoubleType())])
    return df.sparkSession.createDataFrame(
        df.rdd.mapPartitions(infer), schema)


def _collect_xy(df, feature_cols, label_col):
    import numpy as np

    rows = df.select(*feature_cols, label_col).collect()
    X = np.asarray([[r[c] for c in feature_cols] for r in rows],
                   dtype=np.float32)
    y = np.asarray([r[label_col] for r in rows], dtype=np.float32)
    return X, y


class _EstimatorBase:
    """Spark-facing plumbing (collect or materialize -> _fit_arrays ->
    model)."""

    def _set_out_of_core(self, out_of_core, validation):
        """The streaming flag, exclusive of ``validation`` (the hold-out
        split needs the dataset in memory)."""
        self.out_of_core = bool(out_of_core)
        if self.out_of_core and validation:
            raise ValueError("out_of_core=True does not support "
                             "validation= (stream the hold-out from a "
                             "separate materialized DataFrame instead)")

    def fit(self, df):
        from horovod_tpu_torch.spark.runner import _require_pyspark, run

        _require_pyspark()

        def run_fn(worker, num_proc=None, master_port=29575):
            return run(worker, num_proc=num_proc, master_port=master_port,
                       device=self.device)

        return self._fit_dataframe(df, run_fn=run_fn)

    def _fit_dataframe(self, df, run_fn=None):
        """The DataFrame half of ``fit`` (everything between the Spark
        session and ``_fit_arrays``)."""
        if getattr(self, "out_of_core", False):
            # materialize per-partition shard files into the store on the
            # executors; workers stream them (spark/data.py)
            if self.store is None:
                raise ValueError("out_of_core=True requires store=")
            from horovod_tpu_torch.spark.data import write_dataframe_shards

            write_dataframe_shards(df, self.store, self.feature_cols,
                                   self.label_col, idx=self.run_id)
            return self._fit_arrays(None, None, run_fn=run_fn,
                                    sharded=True)
        X, y = _collect_xy(df, self.feature_cols, self.label_col)
        # ship the dataset once per executor (a broadcast), not once per
        # task in the worker's closure (cloudpickle would serialize the
        # captured arrays per task)
        sc = df.sparkSession.sparkContext
        bc = sc.broadcast((X, y))
        return self._fit_arrays(None, None, run_fn=run_fn, broadcast=bc)


def _cpu_state(module):
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


class TorchEstimator(_EstimatorBase):
    """Torch estimator owning the training loop (Horovod's
    ``spark/torch/estimator.py:91`` and the executor loop of
    ``spark/torch/remote.py``).

    Parameters
    - ``model``: a ``torch.nn.Module`` (its initial weights are every
      rank's starting point, broadcast from rank 0).
    - ``optimizer_fn(params) -> torch.optim.Optimizer``.
    - ``loss_fn(pred, target) -> scalar tensor`` (default MSE).
    - ``epochs`` / ``batch_size``: the loop's shape.
    - ``store`` / ``run_id``: per-epoch checkpoints are written to a local
      scratch dir and published with ``store.sync_fn``; the final weights
      land at ``store.get_checkpoint_path(run_id)``.
    - ``callbacks``: objects with ``on_epoch_end(epoch, logs)``, called on
      rank 0 with ``logs={"loss": float}`` (and ``val_loss``).
    - ``validation``: a fraction in (0, 1) held out deterministically.
    - ``out_of_core``: stream shard files from the store.
    - ``device``: where the workers train; ``None`` is the card of each
      worker's local rank, ``"cpu"`` gloo.
    """

    def __init__(self, model, optimizer_fn: Callable,
                 feature_cols: List[str], label_col: str,
                 loss_fn: Optional[Callable] = None,
                 num_proc: Optional[int] = None, epochs: int = 1,
                 batch_size: int = 32, master_port: int = 29576,
                 store=None, run_id: Optional[str] = None,
                 callbacks: Optional[list] = None,
                 validation: Optional[float] = None,
                 out_of_core: bool = False, device: Optional[str] = None):
        self.model = model
        self.optimizer_fn = optimizer_fn
        self.loss_fn = loss_fn
        self.feature_cols = list(feature_cols)
        self.label_col = label_col
        self.num_proc = num_proc
        self.epochs = epochs
        self.batch_size = batch_size
        self.master_port = master_port
        self.store = store
        self.run_id = run_id or f"torch-{uuid.uuid4().hex[:8]}"
        self.callbacks = list(callbacks or [])
        self.validation = validation
        self.device = device
        self._set_out_of_core(out_of_core, validation)

    def _fit_arrays(self, X, y, run_fn=None, broadcast=None,
                    sharded=False) -> "TorchModel":
        import torch

        run_fn = run_fn or _local_run
        model_blob = _pickle_dumps(self.model)
        optimizer_fn, loss_fn = self.optimizer_fn, self.loss_fn
        epochs, batch_size = self.epochs, self.batch_size
        store, run_id = self.store, self.run_id
        callbacks = self.callbacks
        validation = self.validation
        device = self.device
        bc = broadcast

        def worker():
            import numpy as np
            import torch

            import horovod_tpu_torch as hvt

            hvt.init(device=device)     # a no-op where run() started it
            dev = hvt.device()
            n, r = hvt.process_size(), hvt.process_rank()

            def on_dev(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            if sharded:
                # the streaming path: batches come one shard file at a
                # time from the store (spark/data.py)
                from horovod_tpu_torch.spark.data import ShardedDataset

                ds = ShardedDataset(store, idx=run_id)
                vx = vy = None
                steps = ds.lockstep_steps(n, batch_size)

                def epoch_batches(epoch):
                    for bx_, by_ in ds.iter_batches(
                            r, n, batch_size, steps, seed=1000 + epoch):
                        yield on_dev(bx_), on_dev(by_)
            else:
                bx, by = bc.value if bc is not None else (X, y)
                train_ids, val_ids = _train_val_split(len(bx), validation)
                rows = train_ids[_shard_rows(len(train_ids), r, n)]
                sx, sy = on_dev(bx[rows]), on_dev(by[rows])
                vx = on_dev(bx[val_ids]) if len(val_ids) else None
                vy = on_dev(by[val_ids]) if len(val_ids) else None
                # an equal step count on every rank (_steps_per_epoch)
                steps = _steps_per_epoch(len(train_ids), n, batch_size)

                def epoch_batches(epoch):
                    # the permutation is drawn on the CPU, as the JAX
                    # package's loop draws it, whatever the device
                    perm = torch.from_numpy(np.resize(
                        torch.randperm(
                            len(sx),
                            generator=torch.Generator().manual_seed(
                                1000 + epoch)).numpy(),
                        steps * batch_size)).to(dev)
                    for s in range(steps):
                        idx = perm[s * batch_size:(s + 1) * batch_size]
                        yield sx[idx], sy[idx]

            model = pickle.loads(model_blob).to(dev)
            opt = hvt.DistributedOptimizer(
                optimizer_fn(model.parameters()),
                named_parameters=model.named_parameters())
            hvt.broadcast_parameters(model.state_dict(), root_rank=0)
            lf = loss_fn or torch.nn.functional.mse_loss

            def val_loss():
                total, seen = 0.0, 0
                model.eval()  # dropout off; BN must not absorb hold-out
                try:
                    with torch.no_grad():
                        for i in range(0, len(vx), batch_size):
                            xb = vx[i:i + batch_size]
                            yb = vy[i:i + batch_size]
                            lv = lf(model(xb).reshape(-1), yb.reshape(-1))
                            total += float(lv) * len(xb)
                            seen += len(xb)
                finally:
                    model.train()
                return total / max(seen, 1)

            def train_epochs(ckpt_dir=None, on_epoch=None):
                history = []
                for epoch in range(epochs):
                    total, batches = 0.0, 0
                    for xb, yb in epoch_batches(epoch):
                        opt.zero_grad()
                        pred = model(xb)
                        loss = lf(pred.reshape(-1), yb.reshape(-1))
                        loss.backward()
                        opt.step()
                        total += float(loss.detach())
                        batches += 1
                    logs = {"loss": total / max(batches, 1)}
                    if vx is not None and r == 0:
                        # rank 0 only: no collectives inside, and only rank
                        # 0's history and callbacks are consumed
                        logs["val_loss"] = val_loss()
                    history.append(logs)
                    if r == 0:
                        for cb in callbacks:
                            cb.on_epoch_end(epoch, dict(logs))
                        if ckpt_dir is not None:
                            torch.save(_cpu_state(model),
                                       f"{ckpt_dir}/checkpoint-{epoch}.pt")
                            if on_epoch is not None:
                                # publish now: a failure at epoch k must not
                                # lose checkpoints 0..k-1
                                on_epoch()
                return history

            if store is not None and r == 0:
                sync = store.sync_fn(run_id)
                with store.get_local_output_dir_fn(run_id)() as d:
                    history = train_epochs(ckpt_dir=d, on_epoch=lambda:
                                           sync(d))
            else:
                history = train_epochs()
            return _cpu_state(model), history

        results = run_fn(worker, num_proc=self.num_proc,
                         master_port=self.master_port)
        state_dict, history = results[0]
        model = pickle.loads(model_blob)
        model.load_state_dict(state_dict)
        if store is not None:
            buf = io.BytesIO()
            torch.save(model.state_dict(), buf)
            store.write(store.get_checkpoint_path(run_id), buf.getvalue())
            store.write(
                store.get_run_path(run_id) + "/meta.json",
                json.dumps({"feature_cols": self.feature_cols,
                            "label_col": self.label_col}).encode())
            store.write(
                store.get_logs_path(run_id) + "/history.json",
                json.dumps(history).encode())
        return TorchModel(model, self.feature_cols)


class TorchModel:
    """The Transformer that ``TorchEstimator.fit`` produces. It predicts on
    the device its model's parameters are on."""

    def __init__(self, model, feature_cols: List[str],
                 output_col: str = "prediction"):
        self.model = model
        self.feature_cols = list(feature_cols)
        self.output_col = output_col

    @classmethod
    def load(cls, store, run_id: str, model, feature_cols=None,
             output_col: str = "prediction") -> "TorchModel":
        """Restore weights from the store into ``model`` (an instance of the
        architecture that was fitted); ``feature_cols`` default to the ones
        persisted at fit time."""
        import torch

        blob = store.read(store.get_checkpoint_path(run_id))
        model.load_state_dict(torch.load(io.BytesIO(blob)))
        if feature_cols is None:
            meta = json.loads(store.read(
                store.get_run_path(run_id) + "/meta.json"))
            feature_cols = meta["feature_cols"]
        return cls(model, feature_cols=list(feature_cols),
                   output_col=output_col)

    def _predict_arrays(self, X):
        import numpy as np
        import torch

        self.model.eval()
        dev = next(self.model.parameters()).device
        with torch.no_grad():
            out = self.model(torch.from_numpy(
                np.ascontiguousarray(np.asarray(X, np.float32))).to(dev))
        return out.reshape(len(X), -1).squeeze(-1).cpu().numpy()

    def transform(self, df):
        return _spark_transform(df, self._predict_arrays,
                                self.feature_cols,
                                self.output_col)
