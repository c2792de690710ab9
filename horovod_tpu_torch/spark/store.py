"""Storage abstraction for the Spark estimators: the port's copy of the
JAX package's ``spark/store.py`` (Horovod's ``horovod/spark/common/
store.py``: ``Store`` / ``FilesystemStore`` / ``LocalStore`` /
``HDFSStore`` / ``DBFSLocalStore``).

A Store owns the layout under a prefix path:

    <prefix>/intermediate_train_data[.<idx>]   training data
    <prefix>/intermediate_val_data[.<idx>]     validation data
    <prefix>/runs/<run_id>/checkpoint.<ext>    per-run checkpoints
    <prefix>/runs/<run_id>/logs                per-run logs

plus the executor-side contract the estimator uses: a local scratch dir per
run (``get_local_output_dir_fn``) and a ``sync_fn`` that publishes it into
the store (a copy on a shared or local filesystem; remote flavors override
``exists/read/write/sync_fn``).

The reference materializes DataFrames into Petastorm parquet under the data
paths; the port's estimator keeps datasets in memory, or streams ``.npz``
shards written under the train-data path (``spark/data.py``).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile


class Store:
    """Interface (reference ``store.py:32``)."""

    @staticmethod
    def create(prefix_path: str, *args, **kwargs) -> "Store":
        """Factory by path scheme (reference ``store.py:144``):
        ``hdfs://`` → HDFSStore, ``dbfs:/`` → DBFSLocalStore,
        ``gs://`` → GCSStore, ``http(s)://`` → HTTPStore,
        anything else (incl. ``file://``) → FilesystemStore."""
        if prefix_path.startswith("hdfs://"):
            return HDFSStore(prefix_path, *args, **kwargs)
        if prefix_path.startswith("dbfs:/"):
            return DBFSLocalStore(prefix_path, *args, **kwargs)
        if prefix_path.startswith("gs://"):
            return GCSStore(prefix_path, *args, **kwargs)
        if prefix_path.startswith(("http://", "https://")):
            return HTTPStore(prefix_path, *args, **kwargs)
        return FilesystemStore(prefix_path, *args, **kwargs)

    # -- layout ------------------------------------------------------------

    def get_train_data_path(self, idx=None) -> str:
        raise NotImplementedError

    def get_val_data_path(self, idx=None) -> str:
        raise NotImplementedError

    def get_test_data_path(self, idx=None) -> str:
        raise NotImplementedError

    def get_runs_path(self) -> str:
        raise NotImplementedError

    def get_run_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_checkpoint_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_logs_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_checkpoint_filename(self) -> str:
        return "checkpoint.bin"

    # -- io ----------------------------------------------------------------

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def write(self, path: str, data: bytes):
        raise NotImplementedError

    # -- executor-side contract -------------------------------------------

    def get_local_output_dir_fn(self, run_id: str):
        """Context manager yielding a scratch dir on the executor; used
        with ``sync_fn`` (reference ``store.py:109``)."""

        @contextlib.contextmanager
        def local_dir():
            d = tempfile.mkdtemp(prefix=f"hvt_run_{run_id}_")
            try:
                yield d
            finally:
                shutil.rmtree(d, ignore_errors=True)

        return local_dir

    def sync_fn(self, run_id: str):
        """Returns ``sync(local_dir)`` publishing the scratch dir into the
        run path (reference ``store.py:112``)."""
        raise NotImplementedError


class FilesystemStore(Store):
    """Store over a locally-mounted filesystem path — local disk, NFS, or
    any fuse mount (reference ``FilesystemStore:153`` / ``LocalStore``)."""

    def __init__(self, prefix_path: str, train_path=None, val_path=None,
                 test_path=None, runs_path=None):
        self.prefix_path = self._localize(prefix_path)
        self._train = train_path or os.path.join(self.prefix_path,
                                                 "intermediate_train_data")
        self._val = val_path or os.path.join(self.prefix_path,
                                             "intermediate_val_data")
        self._test = test_path or os.path.join(self.prefix_path,
                                               "intermediate_test_data")
        self._runs = runs_path or os.path.join(self.prefix_path, "runs")

    @staticmethod
    def _localize(path: str) -> str:
        if path.startswith("file://"):
            return path[len("file://"):]
        return path

    @staticmethod
    def _with_idx(path: str, idx) -> str:
        return path if idx is None else f"{path}.{idx}"

    def get_train_data_path(self, idx=None) -> str:
        return self._with_idx(self._train, idx)

    def get_val_data_path(self, idx=None) -> str:
        return self._with_idx(self._val, idx)

    def get_test_data_path(self, idx=None) -> str:
        return self._with_idx(self._test, idx)

    def get_runs_path(self) -> str:
        return self._runs

    def get_run_path(self, run_id: str) -> str:
        return os.path.join(self._runs, run_id)

    def get_checkpoint_path(self, run_id: str) -> str:
        return os.path.join(self.get_run_path(run_id),
                            self.get_checkpoint_filename())

    def get_logs_path(self, run_id: str) -> str:
        return os.path.join(self.get_run_path(run_id), "logs")

    def exists(self, path: str) -> bool:
        return os.path.exists(self._localize(path))

    def read(self, path: str) -> bytes:
        with open(self._localize(path), "rb") as f:
            return f.read()

    def write(self, path: str, data: bytes):
        path = self._localize(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic publish

    def sync_fn(self, run_id: str):
        run_path = self.get_run_path(run_id)

        def sync(local_dir: str):
            os.makedirs(run_path, exist_ok=True)
            for root, _dirs, files in os.walk(local_dir):
                rel = os.path.relpath(root, local_dir)
                dst_dir = (run_path if rel == "."
                           else os.path.join(run_path, rel))
                os.makedirs(dst_dir, exist_ok=True)
                for fn in files:
                    shutil.copy2(os.path.join(root, fn),
                                 os.path.join(dst_dir, fn))

        return sync


class DBFSLocalStore(FilesystemStore):
    """Databricks DBFS through its local fuse mount (reference
    ``DBFSLocalStore``): ``dbfs:/path`` ↔ ``/dbfs/path``."""

    @staticmethod
    def _localize(path: str) -> str:
        if path.startswith("dbfs:/"):
            return "/dbfs/" + path[len("dbfs:/"):].lstrip("/")
        return FilesystemStore._localize(path)


class HDFSStore(Store):
    """HDFS-backed store via pyarrow (reference ``HDFSStore``). Gated:
    raises a clear ImportError when pyarrow's HDFS support is absent."""

    def __init__(self, prefix_path: str, **hdfs_kwargs):
        try:
            from pyarrow import fs as pafs
        except ImportError as e:  # pragma: no cover - env without pyarrow
            raise ImportError(
                "HDFSStore requires pyarrow; use FilesystemStore over an "
                "NFS/fuse mount instead") from e
        # hdfs://[host[:port]]/path — the URL authority names the
        # namenode (reference HDFSStore parses it the same way);
        # hdfs:///path falls back to the ambient Hadoop config
        rest = prefix_path[len("hdfs://"):]
        authority, _, path = rest.partition("/")
        host = hdfs_kwargs.pop("host", None)
        port = hdfs_kwargs.pop("port", None)
        if authority:
            if ":" in authority:
                ahost, aport = authority.rsplit(":", 1)
                host = host or ahost
                port = port if port is not None else int(aport)
            else:
                host = host or authority
        kw = dict(hdfs_kwargs)
        if port is not None:
            kw["port"] = port
        self._fs = pafs.HadoopFileSystem(host or "default", **kw)
        self.prefix_path = "/" + path
        self._runs = self.prefix_path.rstrip("/") + "/runs"

    def get_train_data_path(self, idx=None) -> str:
        p = self.prefix_path.rstrip("/") + "/intermediate_train_data"
        return p if idx is None else f"{p}.{idx}"

    def get_val_data_path(self, idx=None) -> str:
        p = self.prefix_path.rstrip("/") + "/intermediate_val_data"
        return p if idx is None else f"{p}.{idx}"

    def get_test_data_path(self, idx=None) -> str:
        p = self.prefix_path.rstrip("/") + "/intermediate_test_data"
        return p if idx is None else f"{p}.{idx}"

    def get_runs_path(self) -> str:
        return self._runs

    def get_run_path(self, run_id: str) -> str:
        return f"{self._runs}/{run_id}"

    def get_checkpoint_path(self, run_id: str) -> str:
        return f"{self.get_run_path(run_id)}/{self.get_checkpoint_filename()}"

    def get_logs_path(self, run_id: str) -> str:
        return f"{self.get_run_path(run_id)}/logs"

    def exists(self, path: str) -> bool:
        from pyarrow import fs as pafs

        info = self._fs.get_file_info([path])[0]
        return info.type != pafs.FileType.NotFound

    def read(self, path: str) -> bytes:
        with self._fs.open_input_stream(path) as f:
            return f.read()

    def write(self, path: str, data: bytes):
        self._fs.create_dir(os.path.dirname(path), recursive=True)
        with self._fs.open_output_stream(path) as f:
            f.write(data)

    def sync_fn(self, run_id: str):
        run_path = self.get_run_path(run_id)

        def sync(local_dir: str):
            for root, _dirs, files in os.walk(local_dir):
                rel = os.path.relpath(root, local_dir)
                dst_dir = (run_path if rel == "."
                           else f"{run_path}/{rel}")
                for fn in files:
                    with open(os.path.join(root, fn), "rb") as f:
                        self.write(f"{dst_dir}/{fn}", f.read())

        return sync


class RemoteStore(Store):
    """Base for stores whose backing filesystem is NOT locally mounted
    (reference ``store.py`` splits the same way: path-layout logic shared,
    ``exists/read/write/sync_fn`` remote). Subclasses implement the four
    IO primitives against their service; the POSIX-style layout methods
    live here."""

    def __init__(self, prefix_path: str):
        self.prefix_path = prefix_path.rstrip("/")
        self._runs = self.prefix_path + "/runs"

    def _data(self, name, idx):
        p = f"{self.prefix_path}/{name}"
        return p if idx is None else f"{p}.{idx}"

    def get_train_data_path(self, idx=None) -> str:
        return self._data("intermediate_train_data", idx)

    def get_val_data_path(self, idx=None) -> str:
        return self._data("intermediate_val_data", idx)

    def get_test_data_path(self, idx=None) -> str:
        return self._data("intermediate_test_data", idx)

    def get_runs_path(self) -> str:
        return self._runs

    def get_run_path(self, run_id: str) -> str:
        return f"{self._runs}/{run_id}"

    def get_checkpoint_path(self, run_id: str) -> str:
        return f"{self.get_run_path(run_id)}/" \
               f"{self.get_checkpoint_filename()}"

    def get_logs_path(self, run_id: str) -> str:
        return f"{self.get_run_path(run_id)}/logs"

    def sync_fn(self, run_id: str):
        run_path = self.get_run_path(run_id)

        def sync(local_dir: str):
            for root, _dirs, files in os.walk(local_dir):
                rel = os.path.relpath(root, local_dir)
                dst = (run_path if rel == "."
                       else f"{run_path}/{rel.replace(os.sep, '/')}")
                for fn in files:
                    with open(os.path.join(root, fn), "rb") as f:
                        self.write(f"{dst}/{fn}", f.read())

        return sync


class HTTPStore(RemoteStore):
    """Remote store over the port's own rendezvous HTTP KV server
    (``runner/http_server.py``: PUT/GET/HEAD ``/kv/<scope>/<key>``). The
    in-repo stand-in for an object store: every byte of the estimator's
    round trip (checkpoints, logs, synced run dirs) travels over the wire,
    so the remote-store code paths run without cloud object storage.

    ``prefix_path``: ``http://host:port[/subpath]`` — objects land under
    KV scope ``store`` with key ``<subpath>/...``.
    """

    SCOPE = "store"

    def __init__(self, prefix_path: str, timeout: float = 30.0):
        super().__init__(prefix_path)
        from urllib.parse import urlparse

        u = urlparse(self.prefix_path)
        self._base = f"{u.scheme}://{u.netloc}"
        self._timeout = timeout

    def _key(self, path: str) -> str:
        # strip the server authority; keys keep the subpath so multiple
        # stores can share one server
        if path.startswith(self._base):
            path = path[len(self._base):]
        return path.lstrip("/")

    def _url(self, path: str) -> str:
        from urllib.parse import quote

        return (f"{self._base}/kv/{self.SCOPE}/"
                f"{quote(self._key(path))}")

    def exists(self, path: str) -> bool:
        import urllib.error
        import urllib.request

        # HEAD: headers only — a GET would ship the whole object (a
        # multi-MB checkpoint) just to learn it exists
        req = urllib.request.Request(self._url(path), method="HEAD")
        try:
            with urllib.request.urlopen(req, timeout=self._timeout):
                return True
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return False
            raise

    def read(self, path: str) -> bytes:
        import urllib.request

        with urllib.request.urlopen(self._url(path),
                                    timeout=self._timeout) as r:
            return r.read()

    def write(self, path: str, data: bytes):
        import urllib.request

        req = urllib.request.Request(self._url(path), data=data,
                                     method="PUT")
        with urllib.request.urlopen(req, timeout=self._timeout):
            pass


class GCSStore(RemoteStore):
    """Google Cloud Storage store (``gs://bucket/path``) for checkpoints
    and logs. Gated on the ``google-cloud-storage`` client: constructing
    without it (and without a ``client=``) raises a clear ImportError, like
    :class:`HDFSStore` without pyarrow. The IO surface mirrors
    HTTPStore's."""

    def __init__(self, prefix_path: str, client=None):
        super().__init__(prefix_path)
        rest = prefix_path[len("gs://"):]
        self._bucket_name = rest.partition("/")[0]
        if client is None:
            try:
                from google.cloud import storage  # type: ignore
            except ImportError as e:  # pragma: no cover - env w/o gcs
                raise ImportError(
                    "GCSStore requires the google-cloud-storage client; "
                    "use HTTPStore or FilesystemStore instead") from e
            client = storage.Client()
        self._bucket = client.bucket(self._bucket_name)

    def _key(self, path: str) -> str:
        if path.startswith("gs://"):
            path = path[len("gs://"):].partition("/")[2]
        return path.lstrip("/")

    def exists(self, path: str) -> bool:
        return self._bucket.blob(self._key(path)).exists()

    def read(self, path: str) -> bytes:
        return self._bucket.blob(self._key(path)).download_as_bytes()

    def write(self, path: str, data: bytes):
        self._bucket.blob(self._key(path)).upload_from_string(data)


# reference exposes LocalStore as an alias of the filesystem flavor
LocalStore = FilesystemStore
