"""The port's vision path held against the JAX package on the CPU: the same
numpy inputs and the same weights (flax params and batch_stats carried over
by models/convert.py) through horovod_tpu's flax modules and
horovod_tpu_torch's.

- TpuBatchNorm: forward, batch_stats and gradients (fp32), and eval mode.
- The space-to-depth stem: equal to the standard 7x7/2 stem from the same
  weights, in the port and against JAX's.
- A small ResNet (stage_sizes [1, 1, 1, 1], width 8, 32x32, batch 4, fp32):
  logits, loss, every gradient and the updated batch_stats, then a second
  SGD-momentum step, for norm_impl "tpu" (with and without the stem) and
  "flax" (SyncBatchNorm: torch keeps the unbiased running variance).
- VGG16 (32x32) and InceptionV3 (299x299), batch 2, in fp64:
  logits, loss and every gradient; their parameter counts at native size
  from shapes alone.
- Synchronized statistics: SyncBatchNorm and TpuBatchNorm over the world
  on a 2-process gloo gang equal the full batch on one process, gradients
  included.

Tolerances: a single layer in fp32 rtol 1e-5 / atol 1e-5, its gradients
rtol 1e-4 / atol 1e-5 (as tests/test_models.py holds TpuBatchNorm to flax's
BatchNorm). The small ResNet in fp32: logits and loss rtol 1e-4 / atol
1e-4 (at step 2 the weights differ by the fp32 rounding of the first update,
about 1.5e-6, which the last stage's batch norm over 4 elements a channel
amplifies to about 5e-5 in the logits), gradients, statistics and
parameters rtol 2e-3 / atol 2e-5 (many layers of batch-norm backward, each
summing over the batch in another order). VGG16 and InceptionV3 in fp64
with fp32 heads: rtol 1e-5 / atol 1e-5 (of each gradient tensor's largest
magnitude).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import flatten_dict

from horovod_tpu.models import InceptionV3 as JaxInceptionV3
from horovod_tpu.models import ResNet as JaxResNet
from horovod_tpu.models import VGG16 as JaxVGG16
from horovod_tpu.models.normalization import TpuBatchNorm as JaxTpuBatchNorm
from horovod_tpu.models.resnet import _SpaceToDepthStem
from horovod_tpu_torch.models.convert import (vision_state_from_flax,
                                              vision_state_to_flax)
from horovod_tpu_torch.models.layers import Conv, same_padding
from horovod_tpu_torch.models.normalization import TpuBatchNorm
from horovod_tpu_torch.models.resnet import ResNet, SpaceToDepthStem
from horovod_tpu_torch.models.vision import VGG16, InceptionV3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYER = dict(rtol=1e-5, atol=1e-5)
LAYER_GRAD = dict(rtol=1e-4, atol=1e-5)
MODEL_OUT = dict(rtol=1e-4, atol=1e-4)
MODEL_GRAD = dict(rtol=2e-3, atol=2e-5)
# the heads compute in fp32 on both sides, as the JAX models fix them
FP64 = dict(rtol=1e-5, atol=1e-5)

# the gang: rank r of 2 takes rows 2r, 2r + 1 of X through SyncBatchNorm
# and TpuBatchNorm over the world, and backpropagates sum(y * W[rows])
GANG_SHAPE = (4, 3, 5, 5)
GANG_WORKER = r"""
import json, sys
import numpy as np
import torch
import horovod_tpu_torch as hvt
from horovod_tpu_torch.models.normalization import TpuBatchNorm
from horovod_tpu_torch.sync_batch_norm import SyncBatchNorm

shape, out = json.loads(sys.argv[1])
hvt.init(device="cpu")
r = hvt.rank()
rs = np.random.RandomState(9)
x_all = rs.normal(size=shape).astype(np.float32) * 2 + 1
w_all = rs.normal(size=shape).astype(np.float32)
rows = slice(2 * r, 2 * r + 2)
res = {}
for name, bn in (("sync", SyncBatchNorm(shape[1])),
                 ("tpu", TpuBatchNorm(shape[1],
                                      process_set=hvt.global_process_set))):
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([0.5, 1.5, -1.0]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    x = torch.from_numpy(x_all[rows]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(w_all[rows])).sum().backward()
    res[name] = {"y": y.tolist(), "dx": x.grad.tolist(),
                 "dweight": bn.weight.grad.tolist(),
                 "dbias": bn.bias.grad.tolist(),
                 "running_mean": bn.running_mean.tolist(),
                 "running_var": bn.running_var.tolist()}
with open(f"{out}.{r}.json", "w") as f:
    json.dump(res, f)
hvt.shutdown()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Gang:
    """The 2-process gloo gang of GANG_WORKER, started when made."""

    def __init__(self, out):
        self.out = out
        port = _free_port()
        self.procs = []
        for r in range(2):
            env = dict(os.environ, PYTHONPATH=REPO, HVT_PROCESS_ID=str(r),
                       HVT_NUM_PROCESSES="2", HVT_LOCAL_PROCESS_ID=str(r),
                       HVT_LOCAL_SIZE="2", HVT_CROSS_RANK="0",
                       HVT_CROSS_SIZE="1",
                       HVT_COORDINATOR_ADDR=f"127.0.0.1:{port}")
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", GANG_WORKER,
                 json.dumps([GANG_SHAPE, out])], env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        self._results = None

    def results(self):
        if self._results is None:
            try:
                logs = [p.communicate(timeout=120)[0] for p in self.procs]
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, log
            self._results = []
            for r in range(2):
                with open(f"{self.out}.{r}.json") as f:
                    self._results.append(json.load(f))
        return self._results


@pytest.fixture(scope="module", autouse=True)
def gang(tmp_path_factory):
    """Started before the module's first test, so it runs while the JAX
    side compiles."""
    g = _Gang(str(tmp_path_factory.mktemp("syncbn") / "res"))
    yield g
    g.results()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# --------------------------------------------------------------------------
# TpuBatchNorm
# --------------------------------------------------------------------------

def _bn_pair(seed, train=True):
    rs = np.random.RandomState(seed)
    x = (rs.normal(size=(4, 5, 5, 7)) * 3 + 1).astype(np.float32)
    scale = rs.normal(size=7).astype(np.float32)
    bias = rs.normal(size=7).astype(np.float32)
    jbn = JaxTpuBatchNorm(use_running_average=not train, momentum=0.9,
                          epsilon=1e-5, dtype=jnp.float32)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": {"mean": jnp.asarray(rs.normal(size=7), jnp.float32),
                         "var": jnp.asarray(rs.uniform(0.5, 2, 7),
                                            jnp.float32)}}
    bn = TpuBatchNorm(7, momentum=0.9, eps=1e-5)
    bn.load_state_dict(vision_state_from_flax(v["params"], v["batch_stats"]))
    bn.train(train)
    return x, jbn, v, bn


def test_tpu_batch_norm_forward_and_stats_match_jax():
    x, jbn, v, bn = _bn_pair(0)
    y, mutated = jbn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    got = bn(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(y), **LAYER)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               mutated["batch_stats"]["mean"], **LAYER)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               mutated["batch_stats"]["var"], **LAYER)


def test_tpu_batch_norm_gradients_match_jax():
    x, jbn, v, bn = _bn_pair(1)
    w = np.random.RandomState(2).normal(size=x.shape).astype(np.float32)

    def loss(params, xx):
        y, _ = jbn.apply({"params": params,
                          "batch_stats": v["batch_stats"]}, xx,
                         mutable=["batch_stats"])
        return (y * jnp.asarray(w)).sum()

    gp, gx = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    (bn(xt) * _nchw(w)).sum().backward()
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), **LAYER_GRAD)
    np.testing.assert_allclose(bn.weight.grad.numpy(), gp["scale"],
                               **LAYER_GRAD)
    np.testing.assert_allclose(bn.bias.grad.numpy(), gp["bias"],
                               **LAYER_GRAD)


def test_tpu_batch_norm_eval_mode_matches_jax():
    x, jbn, v, bn = _bn_pair(3, train=False)
    before = bn.running_mean.clone()
    np.testing.assert_allclose(_nhwc(bn(_nchw(x))),
                               np.asarray(jbn.apply(v, jnp.asarray(x))),
                               **LAYER)
    assert torch.equal(bn.running_mean, before)


# --------------------------------------------------------------------------
# the space-to-depth stem
# --------------------------------------------------------------------------

def test_space_to_depth_stem_equals_the_standard_stem_and_jax():
    rs = np.random.RandomState(4)
    x = rs.normal(size=(2, 16, 16, 3)).astype(np.float32)
    stem = _SpaceToDepthStem(8, dtype=jnp.float32)
    params = stem.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(stem.apply(params, jnp.asarray(x)))
    weight = torch.from_numpy(np.ascontiguousarray(
        np.asarray(params["params"]["kernel"]).transpose(3, 2, 0, 1)))
    s2d = SpaceToDepthStem(3, 8, dtype=torch.float32)
    plain = Conv(3, 8, (7, 7), (2, 2), ((3, 3), (3, 3)), dtype=torch.float32)
    with torch.no_grad():
        s2d.weight.copy_(weight)
        plain.weight.copy_(weight)
    got = s2d(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, **LAYER)
    torch.testing.assert_close(got, plain(_nchw(x)), **LAYER)
    with pytest.raises(ValueError, match="even"):
        s2d(torch.zeros(1, 3, 15, 16))


def test_same_padding_is_flax_not_symmetric():
    """A stride-2 3x3 conv on an even input pads (0, 1), as flax does."""
    assert same_padding(32, 3, 2) == (0, 1)
    assert same_padding(33, 3, 2) == (1, 1)
    assert same_padding(17, 7, 1) == (3, 3)
    assert same_padding(8, 1, 2) == (0, 0)


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------

def _jax_step(model, params, batch_stats, x, y):
    def loss_fn(p):
        logits, mutated = model.apply(
            {"params": p, "batch_stats": batch_stats}, x, train=True,
            mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        return loss, (logits, mutated["batch_stats"])

    (loss, (logits, new_bs)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    return loss, logits, grads, new_bs


def _port_step(model, x, y):
    model.zero_grad(set_to_none=True)
    logits = model(x)
    loss = F.cross_entropy(logits, y)
    loss.backward()
    return loss, logits


def _grads_close(model, grads, tol, scaled=False):
    """Every parameter's gradient against the flax gradient tree; with
    ``scaled`` the atol is relative to the tensor's largest gradient."""
    got, _ = vision_state_to_flax(
        {n: p.grad for n, p in model.named_parameters()})
    want = {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(grads).items()}
    got = {"/".join(k): v for k, v in flatten_dict(got).items()}
    assert got.keys() == want.keys()
    for name, g in got.items():
        w = want[name]
        atol = tol["atol"] * (np.abs(w).max() if scaled else 1.0)
        np.testing.assert_allclose(g, w, rtol=tol["rtol"], atol=atol,
                                   err_msg=name)


def _load(model, params, batch_stats):
    missing, unexpected = model.load_state_dict(
        vision_state_from_flax(params, batch_stats), strict=False)
    assert not unexpected
    assert all(n.endswith("num_batches_tracked") for n in missing)


def _stats_close(model, want_stats, flax_old, old, counts, flax_norm):
    """The port's running statistics against flax's updated batch_stats.
    SyncBatchNorm (norm_impl "flax") keeps torch's unbiased running
    variance: 0.9 old + 0.1 · var · n / (n - 1) where flax keeps 0.9 old +
    0.1 · var, n the elements a channel's statistics cover."""
    _, got = vision_state_to_flax(dict(model.named_buffers()))
    before = flatten_dict(flax_old)
    for key, want in flatten_dict(want_stats).items():
        node = got
        for k in key:
            node = node[k]
        want = np.asarray(want)
        if flax_norm and key[-1] == "var":
            name = ".".join(key[:-1])
            n = counts[name]
            var = (want - 0.9 * np.asarray(before[key])) / 0.1
            want = (0.9 * old[name + ".running_var"].numpy()
                    + 0.1 * var * n / (n - 1))
        np.testing.assert_allclose(node, want, err_msg=str(key),
                                   **MODEL_GRAD)


@pytest.mark.parametrize("norm_impl,s2d", [("tpu", False), ("tpu", True),
                                           ("flax", False)],
                         ids=["tpu", "tpu-s2d", "flax"])
def test_small_resnet_matches_jax_over_two_sgd_steps(norm_impl, s2d):
    """Step 1: logits, loss, every gradient, the updated batch_stats and
    the parameters after SGD with momentum. Step 2 (from the updated
    weights, the momentum buffers made): logits, loss and batch_stats. The
    second step's gradients are not held to JAX's: there a near-tie in the
    stem's max pool (two values of one window within fp32 rounding of each
    other) may route a gradient to the other element on each side; the
    port's routing agrees with its own fp64 computation."""
    rs = np.random.RandomState(5)
    x = rs.normal(size=(4, 32, 32, 3)).astype(np.float32)
    y = rs.randint(0, 10, (4,))
    jmodel = JaxResNet(stage_sizes=[1, 1, 1, 1], num_classes=10, width=8,
                       dtype=jnp.float32, norm_impl=norm_impl,
                       conv0_space_to_depth=s2d)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                            train=True)
    params, bstats = variables["params"], variables["batch_stats"]
    model = ResNet([1, 1, 1, 1], num_classes=10, width=8,
                   dtype=torch.float32, norm_impl=norm_impl,
                   conv0_space_to_depth=s2d, device="cpu")
    _load(model, params, bstats)
    counts = {}     # per norm: elements a channel's statistics cover

    def count(name, inp):
        counts[name] = inp.numel() // inp.shape[1]

    for name, mod in model.named_modules():
        if name.endswith(("_norm", "bn_init")) or "BatchNorm" in name:
            mod.register_forward_hook(
                lambda m, inp, out, name=name: count(name, inp[0]))
    tx = optax.sgd(0.05, momentum=0.9)
    opt_state = tx.init(params)
    sgd = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    xt, yt = _nchw(x), torch.from_numpy(y)
    for step in range(2):
        old = {n: b.clone() for n, b in model.named_buffers()}
        flax_old = bstats
        loss, logits, grads, bstats = _jax_step(
            jmodel, params, bstats, jnp.asarray(x), jnp.asarray(y))
        tloss, tlogits = _port_step(model, xt, yt)
        np.testing.assert_allclose(float(tloss.detach()), float(loss),
                                   **MODEL_OUT)
        np.testing.assert_allclose(tlogits.detach().numpy(),
                                   np.asarray(logits), **MODEL_OUT)
        _stats_close(model, bstats, flax_old, old, counts,
                     norm_impl == "flax")
        if step:
            break
        _grads_close(model, grads, MODEL_GRAD)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        sgd.step()
        got, _ = vision_state_to_flax(dict(model.named_parameters()))
        for key, want in flatten_dict(params).items():
            node = got
            for k in key:
                node = node[k]
            np.testing.assert_allclose(node, np.asarray(want),
                                       err_msg=str(key), **MODEL_GRAD)


@pytest.mark.parametrize("name", ["vgg16", "inception_v3"])
def test_vgg16_and_inception_v3_match_jax_in_fp64(name):
    """Forward and backward at the resolutions tests/test_models.py uses
    (VGG16 at 32x32, InceptionV3 at 299x299, batch 2) in float64 on both
    sides, with norm_impl "flax" (TpuBatchNorm takes its moments in fp32
    whatever the dtype). In fp32 these gradients are ill-conditioned at
    batch 2 (the port's fp32 InceptionV3 gradients are a median 8 % from
    its own fp64 ones, in relative L2), so fp32 would hold nothing. Both
    models fix their heads to fp32, so logits and loss agree to rtol 1e-5 /
    atol 1e-5, and every gradient to rtol 1e-5 / atol 1e-5 of its tensor's
    largest magnitude. What the models' TpuBatchNorm adds is held in fp32
    above."""
    size, batch = {"vgg16": 32, "inception_v3": 299}[name], 2
    rs = np.random.RandomState(6)
    x = rs.normal(size=(batch, size, size, 3))
    y = rs.randint(0, 10, (batch,))
    kw = dict(num_classes=10, norm_impl="flax")
    if name == "vgg16":
        jmodel = JaxVGG16(dtype=jnp.float64, **kw)
        model = VGG16(dtype=torch.float64, image_size=size, device="cpu",
                      **kw)
    else:
        jmodel = JaxInceptionV3(dtype=jnp.float64, **kw)
        model = InceptionV3(dtype=torch.float64, device="cpu", **kw)
    with jax.enable_x64(True):
        xj = jnp.asarray(x, jnp.float64)
        variables = jmodel.init(jax.random.PRNGKey(0), xj, train=True)
        loss, logits, grads, _ = _jax_step(
            jmodel, variables["params"], variables["batch_stats"], xj,
            jnp.asarray(y))
        loss, logits = float(loss), np.asarray(logits)
        grads = jax.tree.map(np.asarray, grads)
    _load(model, variables["params"], variables["batch_stats"])
    model.double()
    tloss, tlogits = _port_step(model, torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 3, 1, 2))), torch.from_numpy(y))
    np.testing.assert_allclose(float(tloss.detach()), loss, **FP64)
    np.testing.assert_allclose(tlogits.detach().numpy(), logits, **FP64)
    _grads_close(model, grads, FP64, scaled=True)


def test_vision_parameter_counts_from_shapes():
    """VGG16-BN 138.36 M parameters at 224, InceptionV3 23.83 M at 299:
    the port's (built on the meta device, nothing allocated) equal
    flax's (from eval_shape)."""
    def flax_count(model, size):
        var = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)),
            train=True))
        return sum(int(np.prod(a.shape))
                   for a in jax.tree.leaves(var["params"]))

    with torch.device("meta"):
        vgg = VGG16(device="meta")
        inception = InceptionV3(device="meta")
    counts = [sum(p.numel() for p in m.parameters())
              for m in (vgg, inception)]
    assert counts[0] == flax_count(JaxVGG16(), 224)
    assert counts[1] == flax_count(JaxInceptionV3(), 299)
    assert abs(counts[0] - 138.36e6) < 0.3e6
    assert abs(counts[1] - 23.83e6) < 0.1e6


def test_vision_state_round_trips_through_flax():
    model = ResNet([1, 1, 1, 1], num_classes=10, width=8, norm_impl="flax",
                   device="cpu")
    state = model.state_dict()
    back = vision_state_from_flax(*vision_state_to_flax(state))
    assert set(back) == {n for n in state
                         if not n.endswith("num_batches_tracked")}
    for name, t in back.items():
        assert torch.equal(t, state[name]), name


# --------------------------------------------------------------------------
# synchronized statistics
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["sync", "tpu"])
def test_synced_batch_norm_over_two_processes_equals_the_full_batch(gang,
                                                                    impl):
    """Each rank's output and input gradient equal the full batch's rows on
    one process; the ranks' weight and bias gradients sum to the full
    batch's; the running statistics equal it on both ranks."""
    from horovod_tpu_torch.sync_batch_norm import SyncBatchNorm

    results = gang.results()
    rs = np.random.RandomState(9)
    x_all = rs.normal(size=GANG_SHAPE).astype(np.float32) * 2 + 1
    w_all = rs.normal(size=GANG_SHAPE).astype(np.float32)
    bn = SyncBatchNorm(3) if impl == "sync" else TpuBatchNorm(3)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([0.5, 1.5, -1.0]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    x = torch.from_numpy(x_all).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(w_all)).sum().backward()
    for r in range(2):
        got = results[r][impl]
        rows = slice(2 * r, 2 * r + 2)
        np.testing.assert_allclose(got["y"], y.detach()[rows].numpy(),
                                   **LAYER)
        np.testing.assert_allclose(got["dx"], x.grad[rows].numpy(),
                                   **LAYER_GRAD)
        for stat in ("running_mean", "running_var"):
            np.testing.assert_allclose(got[stat],
                                       getattr(bn, stat).numpy(), **LAYER)
    for g in ("dweight", "dbias"):
        total = np.sum([results[r][impl][g] for r in range(2)], axis=0)
        want = (bn.weight if g == "dweight" else bn.bias).grad.numpy()
        np.testing.assert_allclose(total, want, **LAYER_GRAD)
