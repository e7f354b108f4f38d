"""The port's edge→core transport codecs and dequant-fused loss against
the JAX package, on the CPU.

Codecs on the same numpy float32 logits give the same payloads (int8/int4
codes and packed bytes byte-identical, scale/zero bit-equal, top-k values
and indices equal), the same byte accounting and the same decodes; the
dequant-fused loss ``ops.kd_loss_quant`` (its plain versions here) agrees
with the JAX package's Pallas kernels in interpret mode.  Phase 2 and whole
runs under transport are in ``tests/test_torch_transport_fl.py``; the CUDA
kernels are held against the same plain versions on the card in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro import transport as jtransport  # noqa: E402
from repro.transport import codecs as jcodecs  # noqa: E402
from repro_torch.kernels import kd_loss as kd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch import transport  # noqa: E402
from repro_torch.transport import codecs  # noqa: E402

# f32 sums and exponentials in another order than XLA's: ~1e-7 relative on
# logits of unit scale x 3; 1e-5 relative to the largest reference value.
TOL = 1e-5

#: Every spec ``tests/test_transport.py`` parses, valid and not.
SPECS = ("identity", "topk:8", "topk:16", "int8", "int4", "entropy:0.5",
         "entropy:1.0", "entropy:0.5+int8", "int8+entropy:0.5",
         "entropy:0.5+identity")
BAD_SPECS = ("gzip", "int8+int4", "entropy:0.5+entropy:1.0", "identity:4",
             "")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's and torch's CPU thread pools contend in one process, and these
    small tensors gain nothing from more than one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], tol)
        return
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max()


def _logits(rows, v, seed):
    """Continuous logits of unit scale x 3 (no ties, so top-k order is
    pinned by value alone)."""
    return (3 * np.random.default_rng(seed).standard_normal((rows, v))
            ).astype(np.float32)


# -- registry and spec parsing ------------------------------------------------


def test_registry_equals_the_reference():
    assert transport.codec_names() == jtransport.codec_names()
    assert set(codecs.CODECS) == set(jcodecs.CODECS)
    with pytest.raises(ValueError, match="already registered"):
        @codecs.register_codec
        class Dup(codecs.Codec):    # noqa: F811 — intentionally clashing
            head = "int8"
    assert codecs.CODECS["int8"] is codecs.Int8


@pytest.mark.parametrize("spec", SPECS)
def test_parsed_spec_equals_the_reference(spec):
    got, want = codecs.parse_codec(spec), jcodecs.parse_codec(spec)
    for attr in ("spec", "lossy", "cacheable", "needs_logits"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert type(got.transform).__name__ == type(want.transform).__name__
    assert codecs.parse_codec(got) is got


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_spec_raises_as_the_reference(spec):
    with pytest.raises(ValueError) as want:
        jcodecs.parse_codec(spec)
    with pytest.raises(ValueError) as got:
        codecs.parse_codec(spec)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        codecs.TopK(0)
    with pytest.raises(ValueError):
        codecs.EntropyFilter(-0.5)


# -- encodes on equal inputs --------------------------------------------------


def _assert_codes_equal(got, want, logits, scale, zero):
    """Codes equal, element for element.  Both packages compute
    round((x - zero) / scale) with the same IEEE operations and round half
    to even, so a difference could only come from a quotient on a .5
    boundary; any differing element must show that it lies on one."""
    got, want = np.asarray(got), np.asarray(want)
    bad = np.argwhere(got != want)
    for r, c in bad:
        q = (np.float32(logits[r, c]) - zero[r]) / scale[r]
        assert abs(abs(q - np.floor(q)) - 0.5) < 1e-6, (r, c, q)
        assert abs(int(got[r, c]) - int(want[r, c])) == 1
    assert len(bad) == 0, f"{len(bad)} codes on a .5 boundary differ"


@pytest.mark.parametrize("v", [10, 9, 128, 127])
@pytest.mark.parametrize("head", ["int8", "int4"])
def test_quant_payloads_byte_identical(head, v):
    x = _logits(64, v, seed=v)
    got = codecs.CODECS[head]().encode(_t(x))
    want = _np(jcodecs.CODECS[head]().encode(jnp.asarray(x)))
    assert set(got) == set(want) == {"codes", "scale", "zero"}
    for k in ("scale", "zero"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                      want[k].view(np.int32))
    assert got["codes"].dtype == (torch.int8 if head == "int8"
                                  else torch.uint8)
    assert str(want["codes"].dtype) == str(got["codes"].dtype).split(".")[1]
    if head == "int4":
        # The packed container is the wire: equal bytes, equal unpacking.
        assert got["codes"].shape == (64, (v + 1) // 2)
        np.testing.assert_array_equal(got["codes"].numpy(), want["codes"])
        unpacked = codecs.unpack_nibbles(got["codes"], v)
        assert unpacked.dtype == torch.int8
        np.testing.assert_array_equal(
            unpacked.numpy(),
            np.asarray(jcodecs.unpack_nibbles(jnp.asarray(want["codes"]), v)))
    else:
        _assert_codes_equal(got["codes"].numpy(), want["codes"], x,
                            want["scale"], want["zero"])
    dec = codecs.CODECS[head]().decode(got, vocab=v)
    _close(dec, np.asarray(jcodecs.CODECS[head]().decode(
        jax.tree.map(jnp.asarray, want), vocab=v)), 1e-6)


@pytest.mark.parametrize("v", [10, 9])
def test_nibble_packing_equals_the_reference(v):
    c = np.random.default_rng(3).integers(-8, 8, size=(5, v)).astype(np.int8)
    got = codecs.pack_nibbles(_t(c))
    want = np.asarray(jcodecs.pack_nibbles(jnp.asarray(c)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(codecs.unpack_nibbles(got, v).numpy(), c)


@pytest.mark.parametrize("k,v", [(8, 128), (16, 127), (16, 10)])
def test_topk_payload_equals_the_reference(k, v):
    x = _logits(32, v, seed=k + v)
    got = codecs.TopK(k).encode(_t(x))
    want = _np(jcodecs.TopK(k).encode(jnp.asarray(x)))
    np.testing.assert_array_equal(got["top_vals"].numpy(), want["top_vals"])
    assert got["top_idx"].dtype == torch.int32
    np.testing.assert_array_equal(got["top_idx"].numpy(), want["top_idx"])
    # tail = full_lse + log(1 - exp(top_lse - full_lse)) (ROADMAP queue 3):
    # the subtraction amplifies the ~1e-7 differences of the two lse's by
    # exp(full_lse - tail), 1 to 1e2 at these V but up to ~1e4 where k
    # clamps to V - 1 and the tail is one entry (V = 10).  Within 1e-4
    # times that factor.
    amp = np.exp(np.logaddexp.reduce(x.astype(np.float64), axis=-1)
                 - want["tail_lse"])
    err = np.abs(got["tail_lse"].numpy().astype(np.float64)
                 - want["tail_lse"])
    assert (err <= 1e-4 * np.maximum(amp, 1.0)).all(), (err / amp).max()
    if v > 16:
        _close(got["tail_lse"], want["tail_lse"], 1e-4)
    # Decode the reference's payload in both packages: equal logits.
    _close(codecs.TopK(k).decode({n: _t(a) for n, a in want.items()},
                                 vocab=v),
           np.asarray(jcodecs.TopK(k).decode(jax.tree.map(jnp.asarray, want),
                                             vocab=v)), 1e-6)


def test_entropy_masks_and_filtered_roundtrip_equal_the_reference():
    x = _logits(64, 10, seed=5)
    x[:20] *= 6.0                     # sharp rows: low entropy, dropped
    student = _logits(64, 10, seed=6)
    thresholds = (0.0, 0.5, 1.0, 2.0)
    want = jax.device_get([jcodecs.EntropyFilter(t).kept_mask(jnp.asarray(x))
                           for t in thresholds])
    for t, w in zip(thresholds, want):
        np.testing.assert_array_equal(
            codecs.EntropyFilter(t).kept_mask(_t(x)).numpy(), w)
    c, jc = (codecs.parse_codec("entropy:0.5+int8"),
             jcodecs.parse_codec("entropy:0.5+int8"))
    assert 0 < int(c.filter.kept_mask(_t(x)).sum()) < 64
    _close(c.roundtrip(_t(x), student=_t(student)),
           np.asarray(jc.roundtrip(jnp.asarray(x),
                                   student=jnp.asarray(student))), 1e-6)
    with pytest.raises(ValueError, match="student"):
        c.roundtrip(_t(x))
    tx = _t(x)
    assert codecs.parse_codec("identity").roundtrip(tx) is tx


@pytest.mark.parametrize("head", ["int8", "int4"])
def test_decode_stacked_equals_the_reference(head):
    x0, x1 = _logits(16, 11, seed=7), _logits(16, 11, seed=8)
    c, jc = codecs.parse_codec(head), jcodecs.parse_codec(head)
    got = c.decode_stacked(
        {k: torch.stack([a, b], dim=1) for (k, a), b in zip(
            c.encode(_t(x0)).items(), c.encode(_t(x1)).values())}, vocab=11)
    want = jc.decode_stacked(jax.tree.map(
        lambda a, b: jnp.stack([a, b], axis=1), jc.encode(jnp.asarray(x0)),
        jc.encode(jnp.asarray(x1))), vocab=11)
    assert got.shape == (2, 16, 11)
    _close(got, np.asarray(want), 1e-6)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("v", [10, 9, 1000])
def test_byte_accounting_equals_the_reference(spec, v):
    c, jc = codecs.parse_codec(spec), jcodecs.parse_codec(spec)
    assert c.transform.row_bytes(v) == jc.transform.row_bytes(v)
    assert c.payload_bytes(37, v) == jc.payload_bytes(37, v)
    x = _logits(37, v, seed=v)
    x[:9] *= 8.0
    assert c.payload_bytes(37, v, logits=_t(x)) == jc.payload_bytes(
        37, v, logits=jnp.asarray(x))


# -- the dequant-fused loss ---------------------------------------------------


@pytest.mark.parametrize("buffer", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("v", [100, 128, 129])
def test_kd_loss_quant_matches_jax_kernel(v, bits, buffer):
    """The port's kd_loss_quant on the CPU (the kernels' plain versions)
    against the JAX package's Pallas kernels in interpret mode; the JAX
    wrapper pads to its 128-lane tile, the port reads V columns."""
    rows, tau = 16, 2.0
    rng = np.random.default_rng(v + bits)
    s, t, b = (3 * rng.standard_normal((rows, v)).astype(np.float32)
               for _ in range(3))
    y = rng.integers(0, v, size=rows).astype(np.int64)
    jc = jcodecs.parse_codec(f"int{bits}").transform
    p = _np(jc.encode(jnp.asarray(t)))
    codes = np.asarray(jc.unpack_codes(jnp.asarray(p["codes"]), v))
    jb = jnp.asarray(b) if buffer else None

    def jloss(ss):
        return jops.kd_loss_quant(
            jnp.asarray(y, jnp.int32), ss, jnp.asarray(codes),
            jnp.asarray(p["scale"]), jnp.asarray(p["zero"]), jb, tau,
            use_pallas=True, interpret=True)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(s))
    st = _t(s).requires_grad_()
    bt = _t(b).requires_grad_() if buffer else None
    scale = _t(p["scale"]).requires_grad_()
    before = kd.kd_quant_stats_fwd.launches
    loss = ops.kd_loss_quant(_t(y), st, _t(codes), scale, _t(p["zero"]), bt,
                             tau)
    loss.backward()
    assert kd.kd_quant_stats_fwd.launches == before  # the CPU: plain path
    _close(loss.item(), float(want), TOL)
    _close(st.grad.numpy(), np.asarray(want_g), TOL)
    # The payload and the buffer are frozen: no gradient reaches them.
    assert scale.grad is None and (bt is None or bt.grad is None)
    _close(loss.item(), ref.kd_loss_mean_ref(
        _t(y), _t(s), ref.dequantize(_t(codes), _t(p["scale"]),
                                     _t(p["zero"])),
        _t(b) if buffer else None, tau).item(), TOL)
