"""horovod_tpu_torch's wire compression held against the JAX package.

- The codec table against ``horovod_tpu.compression``; the spec parse
  against the engine's rules (``horovod_tpu/csrc/engine.cc:180-222``).
- The plain codecs bit for bit against ``hvt_codec_roundtrip`` and
  ``hvt_codec_wire_bytes`` of the JAX package's C++ engine
  (``libhvt_core.so``, loaded as ``tests/test_ring_kernels.py`` does), on
  seeded inputs with NaN, ±Inf, zero blocks, subnormals and ragged tails;
  encode then decode equal to the roundtrip; error feedback's residual.
- The ``CodecTuner`` copy on a scripted sequence, by the C++ rules
  (``csrc/autotune.cc:275-340``).
- One 4-process gloo gang on two faked hosts
  (``tests/torch_port_wire_gang.py``) under each spec: the tolerances of ``tests/test_data_plane.py:226``
  (bf16 rtol 1e-2; int8 rtol 0.02, fp8 0.2, each with atol 2 % of the
  largest sum), results bit-identical across ranks, encoded bytes equal to
  the wire formula of ``tests/test_data_plane.py:205`` stream by stream,
  other dtypes and Adasum exact, the spec unset bit-exact, the error
  feedback scenario of ``tests/test_data_plane.py:284-321``, the residual
  budget, ``auto`` locking one codec on every rank, process sets, a joined
  rank's stand-in and the DistributedOptimizer.
"""

import ctypes
import math
import os

import numpy as np
import pytest
import torch

import horovod_tpu.compression as jcomp
import torch_port_wire_gang as G
from horovod_tpu_torch import compression as comp
from horovod_tpu_torch.compression import codecs as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB = os.path.join(REPO, "horovod_tpu", "csrc", "build", "libhvt_core.so")
N, LOCAL = 4, 2


def _lib():
    if not os.path.exists(LIB):
        pytest.skip("C++ engine not built (make -C horovod_tpu/csrc)")
    lib = ctypes.CDLL(LIB)
    lib.hvt_codec_roundtrip.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                        ctypes.c_int]
    lib.hvt_codec_wire_bytes.argtypes = [ctypes.c_longlong, ctypes.c_int]
    lib.hvt_codec_wire_bytes.restype = ctypes.c_longlong
    return lib


def _cxx_roundtrip(arr, codec):
    out = np.ascontiguousarray(arr, dtype=np.float32).copy()
    assert _lib().hvt_codec_roundtrip(out.ctypes.data_as(ctypes.c_void_p),
                                      len(out), comp.CODEC_IDS[codec]) == 0
    return out


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def edge_input(n, seed):
    """Seeded values spanning 16 decades, with NaN of both signs, ±Inf, a
    zero block, a -0 block, subnormal blocks, a NaN-and-zero block and a
    ragged tail."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * np.logspace(-8, 8, n)).astype(np.float32)
    x[5], x[300], x[301] = np.nan, np.inf, -np.inf
    x[700] = np.float32(-np.nan)
    x[512:768] = 0.0
    x[768:1024] = np.float32(1e-42)
    x[1024:1280] = (np.float32(1e-39) * rng.randn(256)).astype(np.float32)
    x[1280:1536] = -0.0
    x[1536:1792] = np.where(rng.rand(256) < 0.5, np.nan, 0.0)
    return x


EDGE_SIZES = (256 * 40 + 1, 256 * 40 + 255, 256 * 41)


# ------------------------------------------------------------------ tables

def test_codec_table_matches_the_jax_package():
    assert comp.CODEC_IDS == jcomp.CODEC_IDS
    assert comp.CODEC_NAMES == jcomp.CODEC_NAMES
    for name in ("", "raw", *jcomp.CODEC_IDS):
        assert comp.codec_id(name) == jcomp.codec_id(name)
    for wid in (0, 1, 2, 3, 4, 9):
        assert comp.codec_name(wid) == jcomp.codec_name(wid)
    with pytest.raises(ValueError):
        comp.codec_id("int4")


# (spec, intra, inter, auto, warns): engine.cc:180-222
SPECS = [("", 0, 0, False, False), ("none", 0, 0, False, False),
         ("raw", 0, 0, False, False), ("bf16", 1, 1, False, False),
         ("int8", 2, 2, False, False), ("fp8", 3, 3, False, False),
         ("auto", 0, 0, True, False), ("none,int8", 0, 2, False, False),
         ("int8,none", 2, 0, False, False), ("bf16,auto", 1, 0, True, False),
         ("none,auto", 0, 0, True, False), ("bogus", 0, 0, False, True),
         ("auto,int8", 0, 2, False, True), ("none,bogus", 0, 0, False, True),
         ("int8,fp8,bf16", 2, 0, False, True)]


@pytest.mark.parametrize("spec,intra,inter,auto,warns", SPECS)
def test_parse_wire_spec_follows_the_engine(spec, intra, inter, auto, warns):
    said = []
    assert comp.parse_wire_spec(spec, warn=said.append) == (intra, inter,
                                                            auto)
    assert bool(said) == warns


def test_wire_state_reads_the_env_knobs():
    st = comp.configure({"HVT_WIRE_COMPRESSION": "bf16,auto",
                         "HVT_ERROR_FEEDBACK": "0",
                         "HVT_EF_MAX_BYTES": "4096"})
    try:
        assert (st.intra, st.inter, st.auto) == (1, 0, True)
        assert not st.ef_enabled and st.ef.max_bytes == 4096
        assert comp.wire_pair() == ("bf16", "none") and comp.auto_active()
    finally:
        comp.configure({})
    st = comp.state()
    assert st.ef_enabled and st.ef.max_bytes == 64 << 20 and not st.lossy()


# ------------------------------------------------------------------ codecs

@pytest.mark.parametrize("codec", W.LOSSY)
@pytest.mark.parametrize("n", EDGE_SIZES)
def test_plain_codecs_match_the_cxx_codecs_bit_for_bit(codec, n):
    x = edge_input(n, seed=n)
    want = _cxx_roundtrip(x, codec)
    got = W.roundtrip_plain(torch.from_numpy(x.copy()), codec).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the CPU wrappers run the plain versions
    got2 = W.ef_roundtrip(torch.from_numpy(x.copy()), codec).numpy()
    np.testing.assert_array_equal(_bits(got2), _bits(want))


@pytest.mark.parametrize("codec", ("none",) + W.LOSSY)
def test_wire_bytes_match_the_cxx_formula(codec):
    lib = _lib()
    for n in (0, 1, 255, 256, 257, 300, 1000, 4103, 1 << 18, 123457):
        assert W.wire_bytes(codec, n) == lib.hvt_codec_wire_bytes(
            n, comp.CODEC_IDS[codec])
        if codec != "none":
            assert W.encode_plain(torch.zeros(n), codec).numel() == \
                W.wire_bytes(codec, n)
        if codec in ("int8", "fp8"):    # tests/test_data_plane.py:205
            assert W.wire_bytes(codec, n) == (n // 256) * 260 + (
                4 + n % 256 if n % 256 else 0)


@pytest.mark.parametrize("codec", W.LOSSY)
def test_encode_then_decode_is_the_roundtrip(codec):
    x = torch.from_numpy(edge_input(256 * 9 + 77, seed=3))
    stream = W.encode(x, codec)
    assert stream.dtype == torch.uint8
    assert stream.numel() == W.wire_bytes(codec, x.numel())
    dec = W.decode_accumulate(stream, codec, x.numel())
    np.testing.assert_array_equal(_bits(dec), _bits(W.roundtrip_plain(
        x, codec)))
    # accumulate adds the decoded values into out, in fp32
    base = torch.from_numpy(np.random.RandomState(4).randn(
        x.numel()).astype(np.float32))
    acc = W.decode_accumulate(stream, codec, x.numel(), out=base.clone(),
                              accumulate=True)
    np.testing.assert_array_equal(_bits(acc), _bits(base + dec))
    # a block-aligned chunk's stream is a slice of the whole stream
    off = W.wire_bytes(codec, 256 * 4)
    tail = W.decode_accumulate(stream[off:], codec, x.numel() - 256 * 4)
    np.testing.assert_array_equal(_bits(tail), _bits(dec[256 * 4:]))


@pytest.mark.parametrize("codec", W.LOSSY)
def test_ef_roundtrip_keeps_the_quantization_error(codec):
    rng = np.random.RandomState(7)
    seg = (rng.randn(256 * 5 + 13) * 3).astype(np.float32)
    r = (rng.randn(seg.size) * 0.01).astype(np.float32)
    comp_in = seg + r
    want = _cxx_roundtrip(comp_in, codec)
    t_seg, t_r = torch.from_numpy(seg.copy()), torch.from_numpy(r.copy())
    W.ef_roundtrip(t_seg, codec, t_r)
    np.testing.assert_array_equal(_bits(t_seg), _bits(want))
    np.testing.assert_array_equal(_bits(t_r), _bits(comp_in - want))
    # without a residual: a plain roundtrip
    t = torch.from_numpy(seg.copy())
    np.testing.assert_array_equal(_bits(W.ef_roundtrip(t, codec)),
                                  _bits(_cxx_roundtrip(seg, codec)))


def test_ef_store_evicts_least_recently_used_and_refuses_oversize():
    st = comp.EfStore(max_bytes=8 * 4)
    a = st.residual("a", "global", torch.zeros(4))
    assert st.residual("b", "global", torch.zeros(4)) is not None
    assert st.residual("a", "global", torch.zeros(4)) is a     # a is recent
    st.residual("c", "global", torch.zeros(4))                 # evicts b
    assert (st.dropped, st.bytes) == (1, 32)
    assert st.residual("a", "global", torch.zeros(4)) is a
    assert st.residual("big", "global", torch.zeros(9)) is None
    assert st.dropped == 2
    # a new shape under the same name starts clean
    assert st.residual("a", "global", torch.zeros(2)) is not a
    assert st.residual("a", "0,1", torch.zeros(4)) is not None


# ------------------------------------------------------------------- tuner

def test_codec_tuner_rotation_and_lock_follow_the_cxx_rules():
    t = comp.CodecTuner()
    assert [t.bucket(b) for b in (1, 2048, 2049, 4096, 4097, 1 << 40)] == \
        [0, 0, 1, 1, 2, 17]
    nbytes = 1 << 20
    # rotation: none x5, bf16 x5, int8 x5; throughputs 1, 3, 2 bytes/ns
    tp = {0: 1.0, 1: 3.0, 2: 2.0}
    seen = []
    for _ in range(15):
        c = t.pick(nbytes, 1)
        seen.append(c)
        assert not t.locked(nbytes, 1)
        t.observe(nbytes, 1, c, int(nbytes / tp[c]))
    assert seen == [0] * 5 + [1] * 5 + [2] * 5
    assert t.pick(nbytes, 1) == 1 and t.locked(nbytes, 1)
    t.observe(nbytes, 1, 2, 1)          # a locked cell stays locked
    assert t.pick(nbytes, 1) == 1
    # cells are per link class and size bucket; fp8 and ns <= 0 ignored
    assert t.pick(nbytes, 0) == 0 and t.pick(nbytes * 4, 1) == 0
    t.observe(nbytes, 0, 3, 5)
    t.observe(nbytes, 0, 0, 0)
    assert t._at(nbytes, 0)["n"] == [0, 0, 0]
    # a tie keeps the first candidate (strict >)
    t2 = comp.CodecTuner()
    for _ in range(15):
        c = t2.pick(4096, 1)
        t2.observe(4096, 1, c, 100)
    assert t2.pick(4096, 1) == 0


# -------------------------------------------------------------------- gang

@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return G.run_gang(N, LOCAL, str(tmp_path_factory.mktemp("wire") / "res"))


def _identical(results, key):
    first = results[0][key]
    for res in results[1:]:
        assert torch.equal(res[key].view(torch.int32),
                           first.view(torch.int32)), key


def _chunk_bytes(codec, m, g, me):
    """Encoded bytes member ``me`` of a group of ``g`` sends for a
    compressed reduce-scatter and allgather of ``m`` elements: every other
    member's chunk, then its own chunk's sum to each other member."""
    c = math.ceil(m / (256 * g)) * 256
    lens = [max(0, min(c, m - j * c)) for j in range(g)]
    wb = (lambda k: 2 * k) if codec == "bf16" else \
        (lambda k: (k // 256) * 260 + (4 + k % 256 if k % 256 else 0))
    return sum(wb(k) for j, k in enumerate(lens) if j != me) + \
        (g - 1) * wb(lens[me])


def _expected_tx(spec, numel, rank):
    intra, inter = (spec.split(",") if "," in spec else (spec, spec))
    piece = math.ceil(numel / (LOCAL * 256)) * 256
    lr, cr = rank % LOCAL, rank // LOCAL
    out = {}
    if intra != "none":
        out[intra] = _chunk_bytes(intra, piece * LOCAL, LOCAL, lr)
    if inter != "none":
        out[inter] = out.get(inter, 0) + _chunk_bytes(inter, piece,
                                                      N // LOCAL, cr)
    return out


def test_gang_default_off_is_bit_exact_and_uncompressed(gang):
    want = sum(G.exact_ints(1 << 16, r) for r in range(N))
    for res in gang:
        assert res["off_pair"] == ("none", "none")
        np.testing.assert_array_equal(res["off"].numpy(), want)
        assert res["off_tx"] == {}


@pytest.mark.parametrize("spec", G.CODECS + tuple(f"none,{c}"
                                                  for c in G.CODECS))
def test_gang_codec_within_tolerance_identical_and_exact_bytes(gang, spec):
    codec = spec.split(",")[-1]
    rtol = {"bf16": 1e-2, "int8": 0.02, "fp8": 0.2}[codec]
    for res in gang:
        assert res[f"pair/{spec}"] == (tuple(spec.split(","))
                                       if "," in spec else (spec, spec))
    for numel in G.SIZES:
        key = f"sum/{spec}/{numel}"
        want = sum(G.base(numel, r).astype(np.float64) for r in range(N))
        _identical(gang, key)
        np.testing.assert_allclose(
            gang[0][key].numpy(), want, rtol=rtol,
            atol=0 if codec == "bf16" else np.abs(want).max() * 0.02,
            err_msg=key)
        for r, res in enumerate(gang):
            assert res[f"tx/{spec}/{numel}"] == _expected_tx(spec, numel, r)
    if codec == "int8":     # at least 3.5x under the raw cross stage
        raw = 2 * 16384 * 4
        assert raw / gang[0][f"tx/none,int8/{1 << 16}"]["int8"] >= 3.5


def test_gang_other_dtypes_and_adasum_move_raw_and_exact(gang):
    for res in gang:
        for dt in (torch.int32, torch.float64, torch.float16):
            x = sum((torch.arange(1025) % 5 + 1 + r).to(torch.float64)
                    for r in range(N))
            got = res[f"dtype/{dt}"]
            assert got.dtype == dt
            np.testing.assert_array_equal(got.double().numpy(), x.numpy())
        assert torch.equal(res["adasum/int8"], res["adasum/off"])
        assert res["adasum_tx"] == {}


def test_gang_average_under_int8(gang):
    _identical(gang, "average/int8")
    np.testing.assert_allclose(gang[0]["average/int8"].numpy(),
                               (1 + N) / 2.0, rtol=0.01)


def test_gang_error_feedback_removes_the_bias(gang):
    for res in gang:
        ef, no_ef = res["ef/1/mean"], res["ef/0/mean"]
        assert abs(float(ef[0]) - 100.0) < 0.5
        assert abs(float(no_ef[0]) - 100.0) < 0.5
        assert abs(float(ef[1:].mean()) - 0.01) < 0.005, ef[1:5]
        assert float(no_ef[1:].abs().max()) == 0.0
        assert res["ef/1/bytes"] >= 256 * 4 and res["ef/0/bytes"] == 0


def test_gang_residual_budget_evicts_and_refuses(gang):
    b = G.BUDGET_NUMEL * 4
    for res in gang:
        assert res["budget"] == [("a", 0, b), ("b", 0, 2 * b),
                                 ("a", 0, 2 * b), ("c", 1, 2 * b),
                                 ("big", 2, 2 * b)]
        assert res["budget_metric"] == 2


def test_gang_auto_locks_one_codec_on_every_rank(gang):
    picks = gang[0]["auto_picks"]
    assert picks[:15] == ["none"] * 5 + ["bf16"] * 5 + ["int8"] * 5
    assert len(set(picks[15:])) == 1
    for res in gang:
        assert res["auto_active"] and res["auto_locked"]
        assert res["auto_picks"] == picks
    _identical(gang, "auto_last")
    want = sum(G.base(G.AUTO_NUMEL, r).astype(np.float64) for r in range(N))
    np.testing.assert_allclose(gang[0]["auto_last"].numpy(), want,
                               rtol=0.02, atol=np.abs(want).max() * 0.02)


def test_gang_auto_set_across_hosts_keeps_global_picks_alike(gang):
    """A set across hosts explores its own tuner cells under ``auto``: the
    global calls that follow, in the same size bucket, start their own
    rotation and pick alike on every rank."""
    members = G.SETS[1]
    for r in members:
        assert gang[r]["auto_set_picks"] == ["none"] * G.AUTO_SET_CALLS
    picks = gang[0]["auto_after_set_picks"]
    assert picks[:15] == ["none"] * 5 + ["bf16"] * 5 + ["int8"] * 5
    assert len(set(picks[15:])) == 1
    for res in gang:
        assert res["auto_after_set_picks"] == picks
    _identical(gang, "auto_after_set_last")
    want = sum(G.base(G.AUTO_NUMEL, r).astype(np.float64) for r in range(N))
    np.testing.assert_allclose(gang[0]["auto_after_set_last"].numpy(), want,
                               rtol=0.02, atol=np.abs(want).max() * 0.02)


def test_gang_process_sets_take_their_link_class(gang):
    one_host, two_hosts = G.SETS
    want1 = G.base(4103, 0) + G.base(4103, 1)
    for r in one_host:      # intra raw under none,int8: exact, no bytes
        np.testing.assert_array_equal(gang[r][f"set/{one_host}"].numpy(),
                                      want1)
        assert gang[r][f"set_tx/{one_host}"] == {}
    want2 = G.base(4103, 0).astype(np.float64) + G.base(4103, 2)
    key = f"set/{two_hosts}"
    for i, r in enumerate(two_hosts):
        assert torch.equal(gang[r][key], gang[two_hosts[0]][key])
        np.testing.assert_allclose(gang[r][key].numpy(), want2, rtol=0.02,
                                   atol=np.abs(want2).max() * 0.02)
        assert gang[r][f"set_tx/{two_hosts}"] == {
            "int8": _chunk_bytes("int8", 4103, 2, i)}


def test_gang_joined_rank_stands_in_through_the_compressed_route(gang):
    """Rank 3 joins at once; ranks 0-2's allreduce under none,int8 goes
    through the compressed route with rank 3's zeros (no residual of its
    own), identical on the three and within int8's tolerance of their
    exact sum."""
    want = sum(G.base(4103, r).astype(np.float64) for r in range(N - 1))
    active = gang[:N - 1]
    _identical(active, "join_sum")
    np.testing.assert_allclose(active[0]["join_sum"].numpy(), want,
                               rtol=0.02, atol=np.abs(want).max() * 0.02)
    lasts = {res["join_last"] for res in gang}   # the same on every rank
    assert len(lasts) == 1 and lasts < set(range(N - 1))


def test_gang_distributed_optimizer_steps_alike_under_int8(gang):
    for res in gang[1:]:
        for a, b in zip(res["opt_params"], gang[0]["opt_params"]):
            assert torch.equal(a, b)
    assert all(math.isfinite(v) for v in gang[0]["opt_losses"])
    # one residual per gradient of the fused group
    n_params = sum(p.numel() for p in gang[0]["opt_params"])
    assert gang[0]["opt_ef_bytes"] == 4 * n_params
