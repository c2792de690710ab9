"""Out-of-core data path of the Spark estimator: the port's copy of the
JAX package's ``spark/data.py`` (the counterpart of Horovod's Petastorm
materialization: ``horovod/spark/common/store.py`` disk-backed stores and
``spark/torch/remote.py`` reading row groups from the train-data path).

``write_dataframe_shards`` writes each DataFrame partition on the executor
to one compressed ``.npz`` shard under the store's train-data path: the
driver never holds the dataset. ``ShardedDataset`` assigns shard files to
ranks (strided, like Petastorm's row-group sharding) and streams batches
one file at a time: peak memory is O(largest shard + batch), not
O(dataset).
"""

from __future__ import annotations

import io
import json
from typing import List, Optional


def write_dataframe_shards(df, store, feature_cols: List[str],
                           label_col: str, idx=None):
    """Materialize ``df`` into per-partition shard files + a manifest.

    Runs one ``mapPartitionsWithIndex`` pass; each partition writes
    ``part-<pid>.npz`` (float32 X/y) into ``store.get_train_data_path(idx)``
    from the executor. Returns the parsed manifest dict. The ``store``
    object must be picklable (FilesystemStore and friends are).
    """
    data_path = store.get_train_data_path(idx)
    cols = list(feature_cols)
    label = label_col

    def write_part(pid, rows_iter):
        import numpy as np

        rows = list(rows_iter)
        if not rows:
            return iter([])
        X = np.asarray([[rw[c] for c in cols] for rw in rows], np.float32)
        y = np.asarray([rw[label] for rw in rows], np.float32)
        buf = io.BytesIO()
        np.savez_compressed(buf, X=X, y=y)
        name = f"part-{pid:05d}.npz"
        store.write(f"{data_path}/{name}", buf.getvalue())
        return iter([(name, len(rows))])

    parts = (df.select(*cols, label).rdd
             .mapPartitionsWithIndex(write_part).collect())
    if not parts:
        # fail on the DRIVER, loudly — an empty manifest would leave
        # every training worker with zero batches to stream
        raise ValueError("cannot materialize an empty DataFrame "
                         "(no rows in any partition)")
    manifest = {"files": [{"name": n, "rows": int(r)}
                          for n, r in sorted(parts)],
                "feature_cols": cols, "label_col": label}
    store.write(f"{data_path}/manifest.json",
                json.dumps(manifest).encode())
    return manifest


class ShardedDataset:
    """Streaming reader over materialized shards.

    File-granular strided rank assignment; every rank derives the SAME
    lockstep step count from the manifest, so per-step gradient
    collectives stay synchronized even with uneven shards (ranks with
    fewer rows wrap around their files).
    """

    def __init__(self, store, idx=None, data_path: Optional[str] = None):
        self._store = store
        self._path = data_path or store.get_train_data_path(idx)
        self.manifest = json.loads(
            store.read(f"{self._path}/manifest.json"))
        self.files = self.manifest["files"]
        if not self.files:
            # a zero-file manifest would make iter_batches spin forever
            # chasing a step count no file can feed
            raise ValueError(f"empty shard manifest at {self._path}")
        self.feature_cols = self.manifest["feature_cols"]
        self.label_col = self.manifest["label_col"]

    @property
    def global_rows(self) -> int:
        return sum(f["rows"] for f in self.files)

    def rank_files(self, rank: int, size: int):
        """This rank's shard files. When there are fewer files than
        ranks, tail ranks wrap (every rank MUST have data to keep the
        lockstep loop alive — same contract as estimator._shard_rows)."""
        mine = self.files[rank::size]
        if not mine and self.files:
            mine = [self.files[rank % len(self.files)]]
        return mine

    def rank_rows(self, rank: int, size: int) -> int:
        return sum(f["rows"] for f in self.rank_files(rank, size))

    def lockstep_steps(self, size: int, batch_size: int) -> int:
        """ceil(largest rank's rows / batch) — identical on every rank."""
        mx = max((self.rank_rows(r, size) for r in range(size)),
                 default=0)
        return max(1, (mx + batch_size - 1) // batch_size)

    def _load(self, name: str):
        import numpy as np

        with io.BytesIO(self._store.read(f"{self._path}/{name}")) as b:
            z = np.load(b)
            return z["X"], z["y"]

    def iter_batches(self, rank: int, size: int, batch_size: int,
                     steps: int, seed: int = 0):
        """Yield exactly ``steps`` (X, y) batches of ``batch_size``,
        loading one shard file at a time. Shuffles file order and
        within-file rows by ``seed``; wraps around when this rank's rows
        run out before ``steps`` (lockstep padding)."""
        import numpy as np

        files = self.rank_files(rank, size)
        rng = np.random.RandomState(seed + 7919 * rank)
        produced = 0
        buf_x, buf_y = [], []
        buffered = 0
        while produced < steps:
            for fi in rng.permutation(len(files)):
                X, y = self._load(files[fi]["name"])
                perm = rng.permutation(len(X))
                buf_x.append(X[perm])
                buf_y.append(y[perm])
                buffered += len(X)
                while buffered >= batch_size and produced < steps:
                    bx = np.concatenate(buf_x) if len(buf_x) > 1 \
                        else buf_x[0]
                    by = np.concatenate(buf_y) if len(buf_y) > 1 \
                        else buf_y[0]
                    yield bx[:batch_size], by[:batch_size]
                    buf_x = [bx[batch_size:]]
                    buf_y = [by[batch_size:]]
                    buffered -= batch_size
                    produced += 1
                if produced >= steps:
                    return
