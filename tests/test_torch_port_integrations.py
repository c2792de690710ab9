"""The port's Ray and Spark integrations (``horovod_tpu_torch.ray``,
``horovod_tpu_torch.spark``) held against the JAX package's, through fakes:
neither ray nor pyspark is installed.

The Ray and Spark cases of ``tests/test_integrations.py:17-371`` (and its
fake-pyspark, DataFrame and elastic-loop cases) run on both packages
(``pkg``). Across the packages: the Coordinator's rank assignment, the
Spark slot envs and the stores' layouts are equal (the port's envs add
``HVT_COORDINATOR_ADDR``); the port's ``TorchEstimator`` gives the JAX
package's per-epoch losses within rtol 1e-6 on the same weights, data and
seed (``_local_run`` on the CPU). The port's rendezvous server answers
``HEAD /kv/...`` (200 or 404), which ``HTTPStore.exists`` sends, and the
estimator runs through an ``HTTPStore`` over it.
"""

import json
import os
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import horovod_tpu.ray.elastic as j_ray_elastic
import horovod_tpu.ray.runner as j_ray_runner
import horovod_tpu.runner.elastic.discovery as j_discovery
import horovod_tpu.runner.http_server as j_http
import horovod_tpu.spark as j_spark
import horovod_tpu.spark.data as j_data
import horovod_tpu.spark.estimator as j_est
import horovod_tpu.spark.runner as j_runner
import horovod_tpu_torch as hvt
import horovod_tpu_torch.ray.elastic as t_ray_elastic
import horovod_tpu_torch.ray.runner as t_ray_runner
import horovod_tpu_torch.runner.elastic.discovery as t_discovery
import horovod_tpu_torch.runner.http_server as t_http
import horovod_tpu_torch.spark as t_spark
import horovod_tpu_torch.spark.data as t_data
import horovod_tpu_torch.spark.estimator as t_est
import horovod_tpu_torch.spark.runner as t_runner
from test_integrations import (FakeDataFrame, _df_from_xy,
                               _install_fake_pyspark)

PKGS = {
    "jax": SimpleNamespace(
        ray_runner=j_ray_runner, ray_elastic=j_ray_elastic,
        discovery=j_discovery, spark=j_spark, data=j_data, est=j_est,
        runner=j_runner, server=lambda: j_http.RendezvousServer(),
        est_kw={}),
    "torch": SimpleNamespace(
        ray_runner=t_ray_runner, ray_elastic=t_ray_elastic,
        discovery=t_discovery, spark=t_spark, data=t_data, est=t_est,
        runner=t_runner,
        server=lambda: t_http.RendezvousServer(lambda slots, rnd: 0),
        est_kw={"device": "cpu"}),
}
both = pytest.mark.parametrize("pkg", list(PKGS))


@pytest.fixture(autouse=True)
def _no_world_left():
    """A test's in-process fit leaves a world of one; none outlives it."""
    yield
    hvt.shutdown()


class _EpochRecorder:
    def __init__(self):
        self.logs = []

    def on_epoch_end(self, epoch, logs):
        self.logs.append((epoch, dict(logs)))


# -------------------------------------------------------------- Coordinator

@both
def test_coordinator_single_node(pkg):
    c = PKGS[pkg].ray_runner.Coordinator("10.0.0.1", 29560)
    for _ in range(4):
        c.register("nodeA")
    envs = c.slot_envs()
    assert [e["HVT_PROCESS_ID"] for e in envs] == ["0", "1", "2", "3"]
    assert all(e["HVT_LOCAL_SIZE"] == "4" for e in envs)
    assert [e["HVT_LOCAL_PROCESS_ID"] for e in envs] == \
        ["0", "1", "2", "3"]
    assert all(e["HVT_CROSS_SIZE"] == "1" for e in envs)
    assert all(e["HVT_MASTER_ADDR"] == "10.0.0.1" for e in envs)


@both
def test_coordinator_multi_node_grouping(pkg):
    c = PKGS[pkg].ray_runner.Coordinator("m", 1)
    order = ["A", "B", "A", "B"]
    for h in order:
        c.register(h)
    byhost = {}
    for reg_idx, env in enumerate(c.slot_envs()):
        byhost.setdefault(order[reg_idx], []).append(
            (int(env["HVT_PROCESS_ID"]), int(env["HVT_LOCAL_PROCESS_ID"]),
             int(env["HVT_CROSS_RANK"])))
    assert byhost["A"] == [(0, 0, 0), (1, 1, 0)]
    assert byhost["B"] == [(2, 0, 1), (3, 1, 1)]


@pytest.mark.parametrize("order", [["A"] * 3, ["A", "B", "A", "B"],
                                   ["B", "A", "A", "C", "B", "A"]])
def test_coordinator_envs_equal_across_packages(order):
    j = j_ray_runner.Coordinator("10.1.1.1", 29560)
    t = t_ray_runner.Coordinator("10.1.1.1", 29560)
    for h in order:
        j.register(h)
        t.register(h)
    for je, te in zip(j.slot_envs(), t.slot_envs(), strict=True):
        assert te.pop("HVT_COORDINATOR_ADDR") == "10.1.1.1:29560"
        assert te == je


def test_coordinator_visible_devices_follow_local_rank():
    c = t_ray_runner.Coordinator("m", 1)
    for h in ["A", "B", "A", "B"]:
        c.register(h)
    # worker i holds GPU gpu_ids[i]; A's local ranks 0, 1 are workers 0, 2
    assert c.visible_devices([[3], [5], [1], [7]]) == \
        ["3,1", "5,7", "3,1", "5,7"]


# ---------------------------------------------------- RayHostDiscovery

def _node(host, cpu=0, gpu=0, alive=True):
    return {"Alive": alive, "NodeManagerHostname": host,
            "Resources": {"CPU": cpu, "GPU": gpu}}


@both
def test_ray_discovery_cpu_slots(pkg):
    d = PKGS[pkg].ray_elastic.RayHostDiscovery(cpus_per_slot=2,
                                               nodes_fn=lambda: [
        _node("a", cpu=8), _node("b", cpu=3),
        _node("dead", cpu=8, alive=False)])
    assert d.find_available_hosts_and_slots() == {"a": 4, "b": 1}


@both
def test_ray_discovery_gpu_slots(pkg):
    d = PKGS[pkg].ray_elastic.RayHostDiscovery(use_gpu=True, nodes_fn=lambda: [
        _node("a", cpu=8, gpu=2), _node("b", cpu=8, gpu=0)])
    assert d.find_available_hosts_and_slots() == {"a": 2}


@both
def test_elastic_ray_executor_with_fake_cluster(pkg):
    p = PKGS[pkg]
    ex = p.ray_elastic.ElasticRayExecutor(
        min_np=2, max_np=2,
        override_discovery=p.discovery.FixedHostDiscovery({"localhost": 2}))
    ex.start()
    try:
        results = ex.run(lambda slot: 0, np=2)
        assert set(results.values()) == {0}
    finally:
        ex.shutdown()


@both
def test_elastic_ray_executor_propagates_failure(pkg):
    p = PKGS[pkg]
    ex = p.ray_elastic.ElasticRayExecutor(
        min_np=2, max_np=2, reset_limit=0,
        override_discovery=p.discovery.FixedHostDiscovery({"localhost": 2}))
    ex.start()
    try:
        with pytest.raises(RuntimeError, match="reset count|min_np"):
            ex.run(lambda slot: 1 if slot.rank == 1 else 0, np=2)
    finally:
        ex.shutdown()


def test_ray_executors_default_to_the_card():
    assert t_ray_runner.RayExecutor(num_workers=2).use_gpu
    ex = t_ray_elastic.ElasticRayExecutor(min_np=1)
    assert ex.discovery.use_gpu


# -------------------------------------------------------------- Spark envs

@both
def test_spark_slot_envs_multi_host(pkg):
    envs = PKGS[pkg].runner.slot_envs_from_task_infos(
        ["hostA:123", "hostA:124", "hostB:125"], master_port=29570)
    assert [e["HVT_PROCESS_ID"] for e in envs] == ["0", "1", "2"]
    assert [e["HVT_LOCAL_PROCESS_ID"] for e in envs] == ["0", "1", "0"]
    assert [e["HVT_LOCAL_SIZE"] for e in envs] == ["2", "2", "1"]
    assert [e["HVT_CROSS_RANK"] for e in envs] == ["0", "0", "1"]
    assert envs[0]["HVT_CROSS_SIZE"] == "2"
    assert envs[1]["HVT_CROSS_SIZE"] == "1"
    assert all(e["HVT_MASTER_ADDR"] == "hostA" for e in envs)


@pytest.mark.parametrize("addresses", [
    ["h:1"], ["a:1", "a:2", "b:3"], ["a:1", "b:2", "a:3", "c:4", "b:5"]])
def test_spark_slot_envs_equal_across_packages(addresses):
    for je, te in zip(j_runner.slot_envs_from_task_infos(addresses, 7),
                      t_runner.slot_envs_from_task_infos(addresses, 7),
                      strict=True):
        assert te.pop("HVT_COORDINATOR_ADDR") == \
            f"{addresses[0].rsplit(':', 1)[0]}:7"
        assert te == je


# -------------------------------------------------------------- gating

@both
def test_ray_executor_gated(pkg):
    try:
        import ray  # noqa: F401

        pytest.skip("ray installed; gating not applicable")
    except ImportError:
        pass
    ex = PKGS[pkg].ray_runner.RayExecutor(num_workers=2)
    with pytest.raises(ImportError, match="runner.run"):
        ex.start()


@both
@pytest.mark.parametrize("entry", ["run", "run_elastic"])
def test_spark_run_gated(pkg, entry):
    try:
        import pyspark  # noqa: F401

        pytest.skip("pyspark installed; gating not applicable")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="pyspark"):
        getattr(PKGS[pkg].spark, entry)(lambda: None, num_proc=2)


# ------------------------------------------------------------------ stores

@both
def test_filesystem_store_layout_and_roundtrip(pkg, tmp_path):
    store = PKGS[pkg].spark.Store.create(str(tmp_path / "st"))
    assert store.get_train_data_path(2).endswith("intermediate_train_data.2")
    assert store.get_checkpoint_path("r1").endswith("runs/r1/checkpoint.bin")
    ck = store.get_checkpoint_path("r1")
    assert not store.exists(ck)
    store.write(ck, b"abc")
    assert store.exists(ck) and store.read(ck) == b"abc"
    with store.get_local_output_dir_fn("r1")() as d:
        with open(f"{d}/epoch-0.pt", "wb") as f:
            f.write(b"ck0")
        store.sync_fn("r1")(d)
    assert store.read(store.get_run_path("r1") + "/epoch-0.pt") == b"ck0"


@both
def test_store_create_dispatch(pkg, tmp_path):
    sp = PKGS[pkg].spark
    assert isinstance(sp.Store.create(str(tmp_path)), sp.FilesystemStore)
    assert isinstance(sp.Store.create("dbfs:/x"), sp.DBFSLocalStore)
    assert sp.DBFSLocalStore._localize("dbfs:/a/b") == "/dbfs/a/b"
    assert sp.FilesystemStore._localize("file:///a/b") == "/a/b"
    s = sp.Store.create("http://127.0.0.1:1/base")
    assert isinstance(s, sp.HTTPStore) and isinstance(s, sp.RemoteStore)
    try:
        s = sp.Store.create("gs://bucket/prefix")
    except Exception as e:
        assert ("google-cloud-storage" in str(e)
                or "credential" in str(e).lower()
                or type(e).__name__ == "DefaultCredentialsError"), e
    else:
        assert isinstance(s, sp.GCSStore)


def _fake_gcs_client(blobs):
    class FakeBlob:
        def __init__(self, key):
            self.key = key

        def exists(self):
            return self.key in blobs

        def download_as_bytes(self):
            return blobs[self.key]

        def upload_from_string(self, data):
            blobs[self.key] = (data.encode()
                               if isinstance(data, str) else data)

    class FakeBucket:
        def blob(self, key):
            return FakeBlob(key)

    class FakeClient:
        def bucket(self, name):
            assert name == "my-bucket"
            return FakeBucket()

    return FakeClient()


def _layout(store):
    return [store.get_train_data_path(), store.get_train_data_path(3),
            store.get_val_data_path("v"), store.get_test_data_path(),
            store.get_runs_path(), store.get_run_path("r"),
            store.get_checkpoint_path("r"), store.get_logs_path("r"),
            store.get_checkpoint_filename()]


@pytest.mark.parametrize("prefix", ["/tmp/st", "file:///tmp/st",
                                    "dbfs:/st/x", "http://h:1/teamA",
                                    "https://h:2/", "gs://my-bucket/ckpts"])
def test_store_layouts_equal_across_packages(prefix):
    kw = ({"client": _fake_gcs_client({})} if prefix.startswith("gs://")
          else {})
    j = j_spark.Store.create(prefix, **kw)
    t = t_spark.Store.create(prefix, **kw)
    assert type(t).__name__ == type(j).__name__
    assert _layout(t) == _layout(j)


@both
def test_gcs_store_io_with_fake_client(pkg):
    blobs = {}
    store = PKGS[pkg].spark.GCSStore("gs://my-bucket/ckpts",
                                     client=_fake_gcs_client(blobs))
    ck = store.get_checkpoint_path("r9")
    assert ck == "gs://my-bucket/ckpts/runs/r9/checkpoint.bin"
    assert not store.exists(ck)
    store.write(ck, b"gcs-bytes")
    assert store.exists(ck) and store.read(ck) == b"gcs-bytes"
    assert "ckpts/runs/r9/checkpoint.bin" in blobs


def _head(url):
    req = urllib.request.Request(url, method="HEAD")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers.get("Content-Length"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Length"), b""


def test_rendezvous_server_answers_head_on_kv_keys():
    """``HEAD /kv/<scope>/<key>``: 200 with the value's length and no body
    for a key that is set, 404 for one that is not, as the JAX server."""
    for srv in (PKGS["torch"].server(), PKGS["jax"].server()):
        port = srv.start()
        try:
            base = f"http://127.0.0.1:{port}"
            req = urllib.request.Request(f"{base}/kv/store/a/b.bin",
                                         data=b"12345", method="PUT")
            urllib.request.urlopen(req, timeout=10).close()
            assert _head(f"{base}/kv/store/a/b.bin") == (200, "5", b"")
            assert _head(f"{base}/kv/store/a/missing")[0] == 404
            assert _head(f"{base}/kv/other/a/b.bin")[0] == 404
            assert _head(f"{base}/world")[0] == 404
        finally:
            srv.stop()


@both
@pytest.mark.parametrize("server", list(PKGS))
def test_http_store_roundtrip_over_real_kv_server(pkg, server):
    srv = PKGS[server].server()
    port = srv.start()
    try:
        store = PKGS[pkg].spark.Store.create(f"http://127.0.0.1:{port}/teamA")
        assert store.get_checkpoint_path("r1") \
            == f"http://127.0.0.1:{port}/teamA/runs/r1/checkpoint.bin"
        ck = store.get_checkpoint_path("r1")
        assert not store.exists(ck)
        store.write(ck, b"remote-bytes")
        assert store.exists(ck) and store.read(ck) == b"remote-bytes"
        with store.get_local_output_dir_fn("r1")() as d:
            os.makedirs(f"{d}/sub", exist_ok=True)
            with open(f"{d}/epoch-0.pt", "wb") as f:
                f.write(b"ck0")
            with open(f"{d}/sub/log.txt", "wb") as f:
                f.write(b"line")
            store.sync_fn("r1")(d)
        assert store.read(store.get_run_path("r1") + "/epoch-0.pt") == b"ck0"
        assert store.read(store.get_run_path("r1") + "/sub/log.txt") \
            == b"line"
    finally:
        srv.stop()


@both
def test_sharded_dataset_streams_through_http_store(pkg):
    p = PKGS[pkg]
    srv = p.server()
    port = srv.start()
    try:
        store = p.spark.Store.create(f"http://127.0.0.1:{port}/ooc")
        rng = np.random.RandomState(5)
        X = rng.randn(30, 2).astype(np.float32)
        y = rng.randn(30).astype(np.float32)
        manifest = p.data.write_dataframe_shards(
            _df_from_xy(X, y, n_parts=3), store, ["a", "b"], "y", idx="mh")
        assert len(manifest["files"]) == 3
        ds = p.data.ShardedDataset(store, idx="mh")
        assert ds.global_rows == 30
        steps = ds.lockstep_steps(1, 10)
        got = np.sort(np.concatenate(
            [yb for _, yb in ds.iter_batches(0, 1, 10, steps)]))
        np.testing.assert_allclose(got, np.sort(y), rtol=1e-6)
    finally:
        srv.stop()


@both
def test_write_dataframe_shards_and_streaming_reader(pkg, tmp_path):
    p = PKGS[pkg]
    rng = np.random.RandomState(7)
    X = rng.randn(50, 2).astype(np.float32)
    y = rng.randn(50).astype(np.float32)
    store = p.spark.Store.create(str(tmp_path / "st"))
    manifest = p.data.write_dataframe_shards(
        _df_from_xy(X, y, n_parts=4), store, ["a", "b"], "y", idx="m1")
    assert len(manifest["files"]) == 4
    assert sum(f["rows"] for f in manifest["files"]) == 50
    ds = p.data.ShardedDataset(store, idx="m1")
    names = [f["name"] for r in range(2) for f in ds.rank_files(r, 2)]
    assert sorted(names) == sorted(f["name"] for f in ds.files)
    for r in range(6):
        assert ds.rank_files(r, 6)
    steps = ds.lockstep_steps(1, 10)
    seen_x = np.concatenate([bx for bx, _ in
                             ds.iter_batches(0, 1, 10, steps, seed=3)])
    assert seen_x.shape == (50, 2)
    np.testing.assert_allclose(
        np.sort(seen_x.sum(axis=1)), np.sort(X.sum(axis=1)), rtol=1e-5)
    steps2 = ds.lockstep_steps(2, 8)
    got = list(ds.iter_batches(1, 2, 8, steps2, seed=0))
    assert len(got) == steps2 and all(bx.shape == (8, 2) for bx, _ in got)
    # the same shards and batches as the other package reads them
    other = PKGS["jax" if pkg == "torch" else "torch"].data.ShardedDataset(
        store, idx="m1")
    for (a, b), (c, d) in zip(ds.iter_batches(1, 2, 8, steps2, seed=4),
                              other.iter_batches(1, 2, 8, steps2, seed=4)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


# --------------------------------------------------------------- estimator

def _linear(d, seed):
    torch.manual_seed(seed)
    return torch.nn.Linear(d, 1)


def _fit(pkg, X, y, model, **kw):
    p = PKGS[pkg]
    rec = _EpochRecorder()
    est = p.spark.TorchEstimator(
        model=model, optimizer_fn=lambda ps: torch.optim.SGD(ps, lr=0.1),
        callbacks=[rec], **dict(p.est_kw, **kw))
    return est, est._fit_arrays(X, y), rec


@both
def test_torch_estimator_fit_checkpoints_callbacks_load(pkg, tmp_path):
    rng = np.random.RandomState(5)
    X = rng.randn(96, 3).astype(np.float32)
    y = X @ np.asarray([0.5, -1.0, 2.0], np.float32)
    store = PKGS[pkg].spark.Store.create(str(tmp_path / "st"))
    _, model, rec = _fit(pkg, X, y, torch.nn.Linear(3, 1),
                         feature_cols=["a", "b", "c"], label_col="y",
                         epochs=6, batch_size=8, store=store, run_id="trun")
    assert [e for e, _ in rec.logs] == list(range(6))
    assert rec.logs[-1][1]["loss"] < rec.logs[0][1]["loss"]
    preds = model._predict_arrays(X)
    assert np.mean((preds - y) ** 2) < 0.1
    for ep in range(6):
        assert store.exists(store.get_run_path("trun")
                            + f"/checkpoint-{ep}.pt")
    assert store.exists(store.get_logs_path("trun") + "/history.json")
    loaded = PKGS[pkg].spark.TorchModel.load(store, "trun",
                                             torch.nn.Linear(3, 1))
    assert loaded.feature_cols == ["a", "b", "c"]
    np.testing.assert_allclose(loaded._predict_arrays(X), preds, rtol=1e-6)


@pytest.mark.parametrize("validation", [None, 0.25])
@pytest.mark.parametrize("batch_size", [8, 13])
def test_torch_estimator_losses_equal_the_jax_packages(validation,
                                                       batch_size):
    """The same weights, data and seed through ``_local_run`` on the CPU:
    the port's per-epoch losses (and hold-out losses) within rtol 1e-6 of
    the JAX package's TorchEstimator's."""
    rng = np.random.RandomState(11)
    X = rng.randn(90, 4).astype(np.float32)
    y = np.tanh(X @ np.asarray([0.5, -1.0, 2.0, 0.3], np.float32))
    kw = dict(feature_cols=list("abcd"), label_col="y", epochs=4,
              batch_size=batch_size, validation=validation)
    _, jm, jrec = _fit("jax", X, y, _linear(4, 3), **kw)
    _, tm, trec = _fit("torch", X, y, _linear(4, 3), **kw)
    assert [e for e, _ in trec.logs] == [e for e, _ in jrec.logs]
    for (_, t), (_, j) in zip(trec.logs, jrec.logs):
        assert sorted(t) == sorted(j)
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-6)
    np.testing.assert_allclose(tm._predict_arrays(X), jm._predict_arrays(X),
                               rtol=1e-6, atol=1e-7)


def test_torch_estimator_through_http_store_over_the_ports_server():
    """The port's estimator with its store served by the port's KV server:
    every checkpoint published through ``store.sync_fn`` travels over the
    wire, ``exists`` asks HEAD, and the model loads back from it."""
    srv = PKGS["torch"].server()
    port = srv.start()
    try:
        store = t_spark.Store.create(f"http://127.0.0.1:{port}/est")
        rng = np.random.RandomState(3)
        X = rng.randn(64, 2).astype(np.float32)
        y = X @ np.asarray([1.5, -2.0], np.float32)
        _, model, rec = _fit("torch", X, y, torch.nn.Linear(2, 1),
                             feature_cols=["a", "b"], label_col="y",
                             epochs=3, batch_size=8, store=store,
                             run_id="runH")
        for ep in range(3):
            assert store.exists(store.get_run_path("runH")
                                + f"/checkpoint-{ep}.pt")
        assert not store.exists(store.get_run_path("runH")
                                + "/checkpoint-3.pt")
        assert json.loads(store.read(store.get_logs_path("runH")
                                     + "/history.json"))[-1]["loss"] == \
            pytest.approx(rec.logs[-1][1]["loss"])
        loaded = t_spark.TorchModel.load(store, "runH",
                                         torch.nn.Linear(2, 1))
        np.testing.assert_allclose(loaded._predict_arrays(X),
                                   model._predict_arrays(X), rtol=1e-6)
        assert "est/runs/runH/checkpoint.bin" in srv.store.keys("store")
    finally:
        srv.stop()


def test_estimator_helpers_equal_across_packages():
    for args in [(33, 2, 16), (32, 2, 16), (5, 8, 4), (100, 1, 10),
                 (7, 3, 1)]:
        assert t_est._steps_per_epoch(*args) == j_est._steps_per_epoch(*args)
    for total, n in [(5, 8), (1, 4), (8, 8), (33, 2), (3, 3)]:
        for r in range(n):
            np.testing.assert_array_equal(t_est._shard_rows(total, r, n),
                                          j_est._shard_rows(total, r, n))
    for total, v in [(80, 0.25), (10, 0.5), (7, None), (100, 0.01)]:
        for a, b in zip(t_est._train_val_split(total, v),
                        j_est._train_val_split(total, v)):
            np.testing.assert_array_equal(a, b)
    for bad in (1.5, -0.25):
        with pytest.raises(ValueError, match="validation"):
            t_est._train_val_split(10, bad)


@both
def test_estimator_validation_split_val_loss(pkg):
    rng = np.random.RandomState(6)
    X = rng.randn(80, 2).astype(np.float32)
    y = X @ np.asarray([1.0, -2.0], np.float32)
    _, model, rec = _fit(pkg, X, y, torch.nn.Linear(2, 1),
                         feature_cols=["a", "b"], label_col="y", epochs=5,
                         batch_size=8, validation=0.25)
    assert all("val_loss" in logs for _, logs in rec.logs)
    assert rec.logs[-1][1]["val_loss"] < rec.logs[0][1]["val_loss"]
    assert np.mean((model._predict_arrays(X) - y) ** 2) < 0.2


@both
def test_fit_dataframe_collect_broadcast_path(pkg):
    rng = np.random.RandomState(11)
    X = rng.randn(48, 2).astype(np.float32)
    y = X @ np.asarray([2.0, -1.0], np.float32)
    p = PKGS[pkg]
    est = p.spark.TorchEstimator(
        model=torch.nn.Linear(2, 1),
        optimizer_fn=lambda ps: torch.optim.SGD(ps, lr=0.1),
        feature_cols=["a", "b"], label_col="y", epochs=8, batch_size=8,
        **p.est_kw)
    model = est._fit_dataframe(_df_from_xy(X, y))
    np.testing.assert_allclose(model._predict_arrays(X), y, atol=0.05)


@both
def test_torch_estimator_out_of_core_fit(pkg, tmp_path):
    rng = np.random.RandomState(13)
    X = rng.randn(120, 2).astype(np.float32)
    y = X @ np.asarray([1.0, -0.5], np.float32)
    p = PKGS[pkg]
    store = p.spark.Store.create(str(tmp_path / "st"))
    rec = _EpochRecorder()
    est = p.spark.TorchEstimator(
        model=torch.nn.Linear(2, 1),
        optimizer_fn=lambda ps: torch.optim.SGD(ps, lr=0.1),
        feature_cols=["a", "b"], label_col="y", epochs=6, batch_size=16,
        store=store, run_id="ooc1", callbacks=[rec], out_of_core=True,
        **p.est_kw)
    model = est._fit_dataframe(_df_from_xy(X, y, n_parts=5))
    assert rec.logs[-1][1]["loss"] < rec.logs[0][1]["loss"]
    np.testing.assert_allclose(model._predict_arrays(X), y, atol=0.15)
    assert store.exists(store.get_train_data_path("ooc1") + "/manifest.json")
    assert store.exists(store.get_checkpoint_path("ooc1"))


@both
def test_torch_out_of_core_rejects_validation(pkg):
    with pytest.raises(ValueError, match="out_of_core"):
        PKGS[pkg].spark.TorchEstimator(
            model=torch.nn.Linear(2, 1),
            optimizer_fn=lambda p: torch.optim.SGD(p, lr=0.1),
            feature_cols=["a", "b"], label_col="y", validation=0.2,
            out_of_core=True)


def test_port_spark_run_through_the_documented_barrier_api(monkeypatch):
    """The port's spark.run end to end through the fake barrier gang of
    ``tests/test_integrations.py`` (one task): the env derived from the task
    addresses, a barrier before init, the port's process group up inside the
    task (gloo), results ordered by rank."""
    _install_fake_pyspark(monkeypatch, 1)

    def train_fn(a, b=0):
        assert os.environ["HVT_NUM_PROCESSES"] == "1"
        assert os.environ["HVT_COORDINATOR_ADDR"] == "127.0.0.1:29570"
        assert hvt.is_initialized() and hvt.device().type == "cpu"
        got = hvt.allreduce(torch.tensor([float(a + b)]), op=hvt.Sum)
        return float(got[0]) + hvt.rank()

    env_before = dict(os.environ)
    try:
        out = t_runner.run(train_fn, args=(40,), kwargs={"b": 2},
                           num_proc=1, device="cpu")
    finally:
        for k in set(os.environ) - set(env_before):
            del os.environ[k]
        os.environ.update(env_before)
    assert out == [42.0]
    assert not hvt.is_initialized()


def test_port_fit_through_fake_spark_dataframe_and_run(monkeypatch):
    """``fit(df)`` itself: the fake pyspark's barrier gang runs the port's
    worker through ``spark.run`` on gloo."""
    _install_fake_pyspark(monkeypatch, 1)
    rng = np.random.RandomState(2)
    X = rng.randn(40, 2).astype(np.float32)
    y = X @ np.asarray([0.5, 1.0], np.float32)
    est = t_spark.TorchEstimator(
        model=torch.nn.Linear(2, 1),
        optimizer_fn=lambda ps: torch.optim.SGD(ps, lr=0.1),
        feature_cols=["a", "b"], label_col="y", epochs=10, batch_size=8,
        device="cpu")
    env_before = dict(os.environ)
    try:
        model = est.fit(FakeDataFrame([
            [{"a": float(a), "b": float(b), "y": float(t)}
             for (a, b), t in zip(X, y)]]))
    finally:
        for k in set(os.environ) - set(env_before):
            del os.environ[k]
        os.environ.update(env_before)
    np.testing.assert_allclose(model._predict_arrays(X), y, atol=0.05)


# ------------------------------------------------------ spark run_elastic

@both
def test_elastic_attempt_loop_resizes_and_recovers(pkg):
    calls = []
    pool = [4, 2]

    def attempt(world, idx):
        calls.append((world, idx))
        if idx == 0:
            raise RuntimeError("executor lost")
        return [f"r{i}" for i in range(world)]

    out = PKGS[pkg].runner._elastic_attempt_loop(
        attempt, lambda: pool.pop(0), min_np=2, max_np=4, reset_limit=2)
    assert calls == [(4, 0), (2, 1)] and out == ["r0", "r1"]


@both
def test_elastic_attempt_loop_limits(pkg):
    loop = PKGS[pkg].runner._elastic_attempt_loop

    def boom(world, idx):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="min_np=3"):
        loop(boom, lambda: 2, min_np=3, reset_limit=2, elastic_timeout=0.0)
    with pytest.raises(ValueError, match="min_np"):
        loop(lambda w, i: [], lambda: 16, min_np=4, max_np=2)
    with pytest.raises(ValueError, match="num_proc"):
        loop(lambda w, i: [], lambda: 16, num_proc=2, min_np=4, max_np=8)
    with pytest.raises(RuntimeError, match="after 3 attempts"):
        loop(boom, lambda: 2, reset_limit=2)
    seen = []

    def lost_once(world, idx):
        seen.append(world)
        if idx == 0:
            raise RuntimeError("lost")
        return ["ok"] * world

    loop(lost_once, lambda: 64, num_proc=2, reset_limit=1)
    assert seen == [2, 2]
    seen.clear()
    loop(lambda w, i: seen.append(w) or ["ok"] * w, lambda: 8, num_proc=3,
         max_np=6)
    assert seen == [3]


@both
def test_elastic_attempt_loop_waits_out_transient_min_np_dip(pkg):
    pool = [1, 1, 3]
    clock = [0.0]
    out = PKGS[pkg].runner._elastic_attempt_loop(
        lambda world, idx: ["ok"] * world,
        lambda: pool.pop(0) if pool else 3, min_np=2, elastic_timeout=60.0,
        _sleep=lambda s: clock.__setitem__(0, clock[0] + s),
        _monotonic=lambda: clock[0])
    assert out == ["ok"] * 3
