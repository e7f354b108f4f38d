"""Dense / ring / windowed decode attention in the PyTorch port.

On the CPU: the port's plain version ``swa_decode_ref`` against the JAX
kernel ``swa_decode`` in interpret mode and its jnp oracle; the port's
dense ``attention.prefill``/``decode_step`` (which attend through
``ops.swa_decode_attn``) against the JAX package's; and the one deliberate
deviation, pinned: the port keeps f32 from QK through PV (the kernel's
arithmetic), where the JAX ``decode_step`` computes the attention inline
with bf16 scores and probabilities in bf16.  The CUDA kernel itself is held
against the plain version on the card in ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dataclasses  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.swa_decode import swa_decode as jax_swa_decode  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.swa_decode import swa_decode  # noqa: E402
from repro_torch.nn import attention  # noqa: E402

# f32 sums in another order than XLA's: ~1e-7 apart on unit-scale inputs.
ATOL_F32 = 1e-5
# bf16: the output's rounding (8 bits of mantissa) on values below 4, plus
# bf16 inputs rounded once on each side.
ATOL_BF16 = 2e-2

_jkernel = jax.jit(jax_swa_decode,
                   static_argnames=("window", "ring", "tile", "interpret"))
_joracle = jax.jit(jref.swa_decode_ref, static_argnames=("window", "ring"))
_jprefill = jax.jit(jattn.prefill, static_argnums=(1, 4))
_jdecode = jax.jit(jattn.decode_step, static_argnums=(1,))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's and torch's CPU thread pools contend in one process, and these
    small tensors gain nothing from more than one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, *, b=3, w=40, n=2, g=2, d=32, pos=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, n, g, d)).astype(np.float32)
    kc = rng.standard_normal((b, w, n, d)).astype(np.float32)
    vc = rng.standard_normal((b, w, n, d)).astype(np.float32)
    if pos is None:
        pos = rng.integers(0, w, size=b).astype(np.int32)
    return q, kc, vc, pos


def _close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


# (W, pos, window, ring): full caches at pos from 0 to W-1; a window on a
# full cache; ring caches at a wrapped pos (several times around), before
# the first wrap, and with a window shorter than the ring; W = 300, not a
# multiple of the TPU kernel's 256-row tile; a scalar pos.
CASES = [
    (40, [0, 17, 39], None, False),
    (40, [5, 30, 39], 8, False),
    (16, [100, 47, 16], None, True),
    (16, [3, 15, 0], None, True),
    (16, [100, 47, 16], 6, True),
    (300, [299, 123, 0], None, False),
    (300, [1000, 301, 77], 120, True),
    (40, 21, None, False),
    (16, 53, 16, True),
]


@pytest.mark.parametrize("w,pos,window,ring", CASES)
def test_ref_matches_jax_kernel_and_oracle(w, pos, window, ring):
    q, kc, vc, _ = _case(w, w=w)
    pos_np = np.asarray(pos, np.int32)
    got = ref.swa_decode_ref(torch.from_numpy(q), torch.from_numpy(kc),
                             torch.from_numpy(vc), torch.from_numpy(pos_np),
                             window=window, ring=ring)
    args = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(pos_np))
    _close(got, _jkernel(*args, window=window, ring=ring, interpret=True),
           ATOL_F32)
    _close(got, _joracle(*args, window=window, ring=ring), ATOL_F32)


@pytest.mark.parametrize("w,pos,window,ring", [CASES[1], CASES[4], CASES[6]])
def test_ref_bf16_matches_jax_oracle(w, pos, window, ring):
    q, kc, vc, _ = _case(w + 1, w=w)
    pos_np = np.asarray(pos, np.int32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, kc, vc))
    got = ref.swa_decode_ref(tq, tk, tv, torch.from_numpy(pos_np),
                             window=window, ring=ring)
    assert got.dtype == torch.bfloat16
    want = _joracle(*(jnp.asarray(a, jnp.bfloat16) for a in (q, kc, vc)),
                    jnp.asarray(pos_np), window=window, ring=ring)
    _close(got, want, ATOL_BF16)


def test_all_masked_row_is_the_mean_of_v():
    """A row with no valid slot (pos < 0) softmaxes uniformly over -1e30
    scores in both packages: the output is the mean of V."""
    q, kc, vc, _ = _case(5, b=2, w=12)
    pos = np.array([-1, 4], np.int32)
    got = ref.swa_decode_ref(torch.from_numpy(q), torch.from_numpy(kc),
                             torch.from_numpy(vc), torch.from_numpy(pos),
                             ring=True)
    want = _joracle(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                    jnp.asarray(pos), ring=True)
    _close(got, want, ATOL_F32)
    mean_v = vc[0].mean(axis=0)[:, None, :]                  # (N, 1, D)
    np.testing.assert_allclose(got[0].numpy(),
                               np.broadcast_to(mean_v, got[0].shape),
                               rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("pos", [7, np.array([7, 0, 11], np.int32)])
def test_ops_takes_plain_version_for_cpu_tensors(pos):
    """A CPU tensor goes to the plain version (a scalar pos broadcast to
    (B,)); the kernel is not launched."""
    q, kc, vc, _ = _case(6, w=12)
    t = [torch.from_numpy(a) for a in (q, kc, vc)]
    before = swa_decode.launches
    got = ops.swa_decode_attn(*t, torch.as_tensor(pos), window=5, ring=True)
    want = ref.swa_decode_ref(*t, torch.as_tensor(pos).expand(3), window=5,
                              ring=True)
    assert torch.equal(got, want)
    assert swa_decode.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    q, kc, vc, pos = (torch.from_numpy(a) for a in _case(7))
    with pytest.raises(ValueError, match="CUDA"):
        swa_decode(q, kc, vc, pos)


# -- the long-context configuration -------------------------------------------


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_for_shape_matches_jax_registry(shape):
    """Granite-3-2B at each input shape: the same skip verdict and the same
    configuration as the JAX registry (at ``long_500k`` the window-8192
    variant ``swa_decode`` serves)."""
    assert registry.skip_reason("granite-3-2b", shape) == \
        jregistry.skip_reason("granite-3-2b", shape)
    got = dataclasses.asdict(registry.for_shape("granite-3-2b", shape))
    want = dataclasses.asdict(jregistry.for_shape("granite-3-2b", shape))
    assert got == {k: want[k] for k in got}
    assert dataclasses.asdict(SHAPES[shape]) == dataclasses.asdict(
        jregistry.SHAPES[shape])
    if shape == "long_500k":
        assert (got["sliding_window"], got["name"]) == (8192,
                                                       "granite-3-2b+swa8k")


def test_long_context_ring_matches_jax_oracle():
    """The card's long-context case at its full shape: Granite-3-2B's heads
    at ``long_500k`` with the window ``for_shape`` sets and a ring cache (an
    added choice: the cache holds the window), decoding the shape's last
    position, several hundred times around the ring."""
    shape = SHAPES["long_500k"]
    cfg = dataclasses.replace(registry.for_shape("granite-3-2b", "long_500k"),
                              ring_cache=True).attn_cfg(local=False)
    w = attention.cache_len(cfg, shape.seq_len)
    assert w == cfg.window == 8192
    q, kc, vc, _ = _case(8, b=shape.global_batch, w=w, n=cfg.kv_heads,
                         g=cfg.num_heads // cfg.kv_heads, d=cfg.head_dim)
    pos = np.full((shape.global_batch,), shape.seq_len - 1, np.int32)
    got = ref.swa_decode_ref(*(torch.from_numpy(a) for a in (q, kc, vc, pos)),
                             window=cfg.window, ring=True)
    want = _joracle(*(jnp.asarray(a) for a in (q, kc, vc, pos)),
                    window=cfg.window, ring=True)
    _close(got, want, ATOL_F32)


# -- the dense attention layer -----------------------------------------------


def _attn_cfg(**kw):
    return jattn.AttnConfig(d_model=64, num_heads=4, kv_heads=2, head_dim=16,
                            q_chunk=4, **kw)


def _port_cfg(jcfg):
    return attention.AttnConfig(
        d_model=jcfg.d_model, num_heads=jcfg.num_heads,
        kv_heads=jcfg.kv_heads, head_dim=jcfg.head_dim, window=jcfg.window,
        q_chunk=jcfg.q_chunk, ring_cache=jcfg.ring_cache)


def _attn_params(rng, cfg):
    d, h, n, k = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.head_dim
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(d)).astype(np.float32)  # noqa: E731
    return {"wq": w(d, h, k), "wk": w(d, n, k), "wv": w(d, n, k),
            "wo": w(h, k, d)}


# (window, ring_cache, prompt length, lengths): a full cache; ring caches
# longer and shorter than the prompt; a ring packed length-aware from
# right-padded prompts (one shorter than the ring, one exactly filling it).
PREFILL = [
    (None, False, 12, None),
    (8, True, 12, None),
    (8, True, 5, None),
    (8, True, 12, [12, 3, 8]),
    (6, False, 12, [12, 3, 8]),
]


@pytest.mark.parametrize("window,ring_cache,length,lengths", PREFILL)
def test_prefill_matches_jax(window, ring_cache, length, lengths):
    jcfg = _attn_cfg(window=window, ring_cache=ring_cache)
    rng = np.random.default_rng(length + (window or 0))
    p = _attn_params(rng, jcfg)
    b, max_len = 3, 20
    x = rng.standard_normal((b, length, 64)).astype(np.float32)
    positions = np.tile(np.arange(length, dtype=np.int32), (b, 1))
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    got, cache = attention.prefill(
        params_from_numpy(p, "cpu"), _port_cfg(jcfg), torch.from_numpy(x),
        torch.from_numpy(positions), max_len,
        lengths=None if lens is None else torch.from_numpy(lens))
    want, jcache = _jprefill(p, jcfg, jnp.asarray(x), jnp.asarray(positions),
                             max_len, None if lens is None else jnp.asarray(lens))
    _close(got, want, ATOL_F32)
    assert cache["k"].shape == jcache["k"].shape
    for key in ("k", "v"):
        _close(cache[key], jcache[key], ATOL_F32)


# (window, ring_cache, cache length, pos): a full cache at per-slot and
# scalar positions; a windowed full cache; ring caches wrapped (per slot and
# scalar).
DECODE = [
    (None, False, 20, [0, 13, 19]),
    (None, False, 20, 9),
    (6, False, 20, [3, 13, 19]),
    (8, True, 8, [40, 7, 9]),
    (8, True, 8, 21),
]


@pytest.mark.parametrize("window,ring_cache,t,pos", DECODE)
def test_decode_step_matches_jax(window, ring_cache, t, pos):
    jcfg = _attn_cfg(window=window, ring_cache=ring_cache)
    rng = np.random.default_rng(t + (window or 0))
    p = _attn_params(rng, jcfg)
    b = 3
    cache = {k: rng.standard_normal((b, t, 2, 16)).astype(np.float32)
             for k in ("k", "v")}
    x = rng.standard_normal((b, 1, 64)).astype(np.float32)
    pos_np = np.asarray(pos, np.int32)
    tcache = params_from_numpy(cache, "cpu")
    got, tcache = attention.decode_step(
        params_from_numpy(p, "cpu"), _port_cfg(jcfg), tcache,
        torch.from_numpy(x), torch.from_numpy(pos_np))
    want, jcache = _jdecode(p, jcfg, jax.tree.map(jnp.asarray, cache),
                            jnp.asarray(x), jnp.asarray(pos_np))
    _close(got, want, ATOL_F32)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key], ATOL_F32)


def test_bf16_attention_deviation_is_pinned():
    """The port's decode attention is the kernel's arithmetic (f32 from QK
    through PV).  In bf16 it equals the JAX package's
    ``ops.swa_decode_attn(use_pallas=False)`` to bf16 rounding, while the
    JAX ``decode_step``'s inline attention (bf16 scores, probabilities cast
    to bf16) is a different number, apart by bf16 rounding only.  In f32
    all three agree to float error."""
    jcfg = _attn_cfg(window=8, ring_cache=True)
    rng = np.random.default_rng(21)
    p = _attn_params(rng, jcfg)
    b, t = 3, 8
    cache = {k: rng.standard_normal((b, t, 2, 16)).astype(np.float32)
             for k in ("k", "v")}
    x = rng.standard_normal((b, 1, 64)).astype(np.float32)
    pos = np.array([40, 7, 9], np.int32)

    def jax_kernel_path(p, cache, x):
        """The JAX package's layers around its kernel's attention: the
        port's composition, in JAX."""
        q, k, v = jattn._project_qkv(p, jcfg, x, jnp.asarray(pos)[:, None])
        slot = jnp.asarray(pos) % t
        rows = jnp.arange(b)
        ck = cache["k"].at[rows, slot].set(k[:, 0].astype(cache["k"].dtype))
        cv = cache["v"].at[rows, slot].set(v[:, 0].astype(cache["v"].dtype))
        qg = q[:, 0].reshape(b, 2, 2, 16)
        out = jops.swa_decode_attn(qg, ck, cv, jnp.asarray(pos), window=8,
                                   ring=True, use_pallas=False)
        out = out.reshape(b, 1, 4, 16).astype(x.dtype)
        return jnp.einsum("bshk,hkd->bsd", out, p["wo"].astype(x.dtype))

    kernel_path = jax.jit(jax_kernel_path)
    ports, jax_outs = {}, {}
    for name, dt, tdt in (("f32", jnp.float32, torch.float32),
                          ("bf16", jnp.bfloat16, torch.bfloat16)):
        jp = jax.tree.map(lambda a: jnp.asarray(a, dt), p)
        jc = jax.tree.map(lambda a: jnp.asarray(a, dt), cache)
        jx = jnp.asarray(x, dt)
        port, _ = attention.decode_step(
            params_from_numpy(p, "cpu", tdt), _port_cfg(jcfg),
            params_from_numpy(cache, "cpu", tdt),
            torch.from_numpy(x).to(tdt), torch.from_numpy(pos))
        inline, _ = _jdecode(jp, jcfg, jc, jx, jnp.asarray(pos))
        ports[name] = port.float().numpy()
        jax_outs[name] = (kernel_path(jp, jc, jx).astype(jnp.float32),
                          inline.astype(jnp.float32))
    jax_outs = jax.device_get(jax_outs)
    outs = {name: [ports[name], *jax_outs[name]] for name in ports}
    port, kernel, inline = outs["f32"]
    np.testing.assert_allclose(port, kernel, rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(port, inline, rtol=0, atol=ATOL_F32)
    port, kernel, inline = outs["bf16"]
    scale = np.abs(outs["f32"][0]).max()
    assert np.abs(port - kernel).max() <= ATOL_BF16 * scale
    assert np.abs(port - inline).max() <= ATOL_BF16 * scale
    # the reference's own two bf16 paths differ: the deviation is real
    assert np.abs(kernel - inline).max() > 0
