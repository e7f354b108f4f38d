"""The flash attention pair's algorithm, on the CPU.

``kernels/flash_attn.py`` runs full-sequence attention as one program a
block of query rows (forward, dQ) or of key rows (dK/dV) that visits only
the blocks the mask keeps, masking only those on the mask's edges.  Here:
the block ranges (``key_segments``, ``query_segments``) visit every kept
(query, key) pair exactly once, skip every block that keeps none, and leave
unmasked only blocks kept whole; the plan's tiles fit the H100 and the
kernels' fragments at every head dim the port's archs use; a plain-PyTorch emulation of the tiling
(``ref.flash_fwd_tiled``, ``ref.flash_bwd_tiled``: online softmax, block
skipping, the lse/delta backward) equals the plain version and its autograd
gradients in f32; the autograd function around the pair works under
autograd, ``torch.utils.checkpoint`` and ``torch.func`` (the pair swapped
for the emulation); CPU and ``meta`` tensors take the plain path.  The
CUDA kernels themselves are held against the plain version and against
this emulation on the card in ``tests/test_torch_gpu.py``.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attn as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.nn import attention  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small tensors gain nothing from more than one torch thread,
    and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The emulation sums in another order than the plain version: ~1e-6 apart
# on unit-scale f32 inputs (gradients summed over more terms: ~1e-5).
ATOL, GRAD_ATOL = 2e-6, 2e-5

# (S, T, q_offset, causal, window): square causal, a sliding window,
# bidirectional (the encoder), bidirectional with a window, a query block
# after a prefix of keys (the paged prefill, T > S), with a window, and a
# ragged S.
MASKS = {
    "causal": (70, 70, 0, True, None),
    "window": (70, 70, 0, True, 19),
    "bidirectional": (45, 70, 0, False, None),
    "bidirectional-window": (45, 45, 0, False, 13),
    "prefix": (37, 101, 64, True, None),
    "prefix-window": (37, 101, 64, True, 40),
    "ragged": (53, 53, 0, True, None),
}


def _kept(s, t, q_offset, causal, window):
    """(S, T) bool: row i keeps key j."""
    i = torch.arange(s)[:, None] + q_offset
    j = torch.arange(t)[None, :]
    keep = torch.ones(s, t, dtype=torch.bool)
    if causal:
        keep &= j <= i
    if window is not None:
        keep &= j > i - window
    return keep


# -- the block ranges ----------------------------------------------------------

GEOMETRIES = [m for m in MASKS.values()] + [
    (128, 128, 0, True, None), (1, 1, 0, True, None), (5, 300, 295, True, 3),
    (200, 200, 0, True, 1), (64, 64, 0, False, 64), (9, 40, 31, True, 200)]


@pytest.mark.parametrize("geom", GEOMETRIES, ids=str)
@pytest.mark.parametrize("blocks", [(16, 16), (32, 8), (8, 32), (128, 64)],
                         ids=str)
def test_key_segments_visit_each_kept_pair_once(geom, blocks):
    s, t, q_offset, causal, window = geom
    bm, bn = blocks
    kept = _kept(s, t, q_offset, causal, window)
    for m0 in range(0, s, bm):
        rows = slice(m0, min(m0 + bm, s))
        seen = torch.zeros(t, dtype=torch.int64)
        segs = fa.key_segments(m0, s, t, q_offset, causal, window, bm, bn)
        assert [x[2] for x in segs] == [True, False, True]
        assert segs[0][1] == segs[1][0] and segs[1][1] == segs[2][0]
        for start, end, masked in segs:
            for n0 in range(start, end, bn):
                cols = slice(n0, min(n0 + bn, t))
                seen[cols] += 1
                block = kept[rows, cols]
                assert block.any(), "a visited block keeps no pair"
                if not masked:
                    assert n0 + bn <= t and block.all()
        assert (seen <= 1).all()
        assert (seen[kept[rows].any(0)] == 1).all(), "a kept pair is missed"


@pytest.mark.parametrize("geom", GEOMETRIES, ids=str)
@pytest.mark.parametrize("blocks", [(16, 16), (8, 32), (32, 128)], ids=str)
def test_query_segments_visit_each_kept_pair_once(geom, blocks):
    s, t, q_offset, causal, window = geom
    bm, bn = blocks
    kept = _kept(s, t, q_offset, causal, window)
    for n0 in range(0, t, bn):
        cols = slice(n0, min(n0 + bn, t))
        seen = torch.zeros(s, dtype=torch.int64)
        segs = fa.query_segments(n0, s, t, q_offset, causal, window, bm, bn)
        assert segs[0][1] == segs[1][0] and segs[1][1] == segs[2][0]
        for start, end, masked in segs:
            for m0 in range(start, end, bm):
                rows = slice(m0, min(m0 + bm, s))
                seen[rows] += 1
                block = kept[rows, cols]
                assert block.any(), "a visited block keeps no pair"
                if not masked:
                    assert m0 + bm <= s and n0 + bn <= t and block.all()
        assert (seen <= 1).all()
        assert (seen[kept[:, cols].any(1)] == 1).all(), "a kept pair is missed"


# -- the plan ------------------------------------------------------------------

# The head dims of the port's attention archs: Granite 64, HuBERT 80,
# Qwen3/Qwen1.5/Qwen2-VL/Phi-3.5-MoE/Kimi-K2 128, Nemotron 192,
# RecurrentGemma's local layers 256.
HEAD_DIMS = (64, 80, 128, 192, 256)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plan_fits_the_card(d, dtype):
    """The padded head dim is the next multiple of 32 (one library each);
    bf16 tiles are whole 16-row ``mma.sync`` tiles of 4 warps (the
    forward's and dQ's query rows, one or two tiles a warp; the dK/dV
    block's key rows, 16 a warp or a pair of warps) and whole
    ``ldmatrix`` pairs of 16 on the streamed side; f32 blocks are 16 rows
    of 8 lanes.  Every block's shared memory fits an H100 block's."""
    p = fa.plan(d, dtype)
    assert p.d_pad % 32 == 0 and d <= p.d_pad < d + 32
    if dtype == torch.bfloat16:
        assert p.fwd.block_m in (64, 128) and p.dq.block_m in (64, 128)
        assert p.dkdv.block_n in (64, 32) and p.dkdv.block_n * (
            1 if p.d_pad <= 128 else 2) == 64
        for x in (p.fwd.block_n, p.dkdv.block_m, p.dq.block_n):
            assert x in (32, 64)
        ld = 2 * (p.d_pad + 8)   # a staged row, padded by 16 bytes
        assert p.fwd.smem == (p.fwd.block_m + 4 * p.fwd.block_n) * ld
        assert p.dq.smem == (2 * p.dq.block_m + 4 * p.dq.block_n) * ld
    else:
        assert (p.fwd.block_m, p.dq.block_m, p.dkdv.block_n) == (16, 16, 16)
    for tiles in (p.fwd, p.dkdv, p.dq):
        assert tiles.smem <= fa.SMEM_LIMIT


def test_plan_at_the_main_path_shapes():
    """Granite-3-2B (D 64) and Qwen3-14B (D 128) in bf16: 128 query rows a
    forward block (two tiles a warp), key blocks of 64 at D 64 and 32 at
    D 128; dQ 128 rows against 32 keys at D 64, 64 against 64 at D 128;
    the dK/dV block owns 64 key rows and streams 64 query rows at D 64, 32
    at D 128; each within the H100's shared memory, two blocks an SM."""
    g, q = fa.plan(64, torch.bfloat16), fa.plan(128, torch.bfloat16)
    assert (g.d_pad, q.d_pad) == (64, 128)
    assert (g.fwd[:2], q.fwd[:2]) == ((128, 64), (128, 32))
    assert (g.dq[:2], q.dq[:2]) == ((128, 32), (64, 64))
    assert (g.dkdv[:2], q.dkdv[:2]) == ((64, 64), (32, 64))
    assert (g.fwd.smem, g.dkdv.smem, g.dq.smem) == (55_296, 56_320, 55_296)
    assert (q.fwd.smem, q.dkdv.smem, q.dq.smem) == (69_632, 70_144, 104_448)
    assert 2 * max(q.fwd.smem, q.dkdv.smem, q.dq.smem) <= 227 * 1024


# -- the tiling against the plain version --------------------------------------


def _inputs(seed, s, t, g, d, n=2, b=2, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, s, n * g, d))).to(dtype)
    k = torch.from_numpy(rng.standard_normal((b, t, n, d))).to(dtype)
    v = torch.from_numpy(rng.standard_normal((b, t, n, d))).to(dtype)
    w = torch.from_numpy(rng.standard_normal((b, s, n * g, d))).to(dtype)
    return q, k, v, w


def _blocks(d):
    """The plan's bf16 tiles and small ones, so that even short test
    sequences cross many blocks."""
    p = fa.plan(d, torch.bfloat16)
    return [((p.fwd.block_m, p.fwd.block_n), (p.dkdv.block_m, p.dkdv.block_n),
             (p.dq.block_m, p.dq.block_n)), ((16, 32), (32, 16), (16, 16))]


CASES = list(itertools.product(HEAD_DIMS, (1, 4, 5), MASKS))


@pytest.mark.parametrize("d,g,mask", CASES)
def test_tiled_forward_matches_plain(d, g, mask):
    s, t, q_offset, causal, window = MASKS[mask]
    q, k, v, _ = _inputs(d + g, s, t, g, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = ref.attend_full_ref(q, k, v, q_chunk=16, **kw)
    kept = _kept(s, t, q_offset, causal, window)
    sc = torch.einsum("bshd,bthd->bhst", q,
                      k.repeat_interleave(g, dim=2)) / d ** 0.5
    want_lse = torch.logsumexp(sc.masked_fill(~kept, -torch.inf), dim=-1)
    for fwd, _, _ in _blocks(d):
        got, lse = ref.flash_fwd_tiled(q, k, v, block_m=fwd[0],
                                       block_n=fwd[1], **kw)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
        torch.testing.assert_close(lse, want_lse, atol=ATOL * 4, rtol=0)


@pytest.mark.parametrize("d,g,mask", CASES)
def test_tiled_backward_matches_autograd(d, g, mask):
    s, t, q_offset, causal, window = MASKS[mask]
    q, k, v, w = _inputs(d * g, s, t, g, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    (ref.attend_full_ref(*leaves, q_chunk=16, **kw) * w).sum().backward()
    for fwd, dkdv, dq in _blocks(d):
        o, lse = ref.flash_fwd_tiled(q, k, v, block_m=fwd[0], block_n=fwd[1],
                                     **kw)
        grads = ref.flash_bwd_tiled(w, q, k, v, o, lse, dkdv_blocks=dkdv,
                                    dq_blocks=dq, **kw)
        for got, leaf in zip(grads, leaves):
            torch.testing.assert_close(got, leaf.grad, atol=GRAD_ATOL,
                                       rtol=0)


# -- the autograd function, with the pair swapped for the emulation ------------


@pytest.fixture
def emulated(monkeypatch):
    """``ops``' kernel pair replaced by the tiled emulation on CPU tensors,
    counting calls as the wrappers count launches."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v, *, causal, window, q_offset):
        calls["fwd"] += 1
        return ref.flash_fwd_tiled(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, block_m=16, block_n=16)

    def bwd(do, q, k, v, o, lse, *, causal, window, q_offset):
        calls["bwd"] += 1
        return ref.flash_bwd_tiled(do, q, k, v, o, lse, causal=causal,
                                   window=window, q_offset=q_offset,
                                   dkdv_blocks=(16, 16), dq_blocks=(16, 16))

    monkeypatch.setattr(ops._fa, "flash_fwd", fwd)
    monkeypatch.setattr(ops._fa, "flash_bwd", bwd)
    return calls


KW = dict(causal=True, window=11, q_offset=5)


def _flash(q, k, v):
    return ops._FlashAttention.apply(q, k, v, KW["causal"], KW["window"],
                                     KW["q_offset"])[0]


def _plain(q, k, v):
    return ref.attend_full_ref(q, k, v, q_chunk=8, **KW)


def test_function_under_autograd_and_checkpoint(emulated):
    q, k, v, w = _inputs(3, 24, 29, 2, 16)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    (_plain(*leaves) * w).sum().backward()
    mine = [x.clone().requires_grad_() for x in (q, k, v)]
    out = torch.utils.checkpoint.checkpoint(_flash, *mine,
                                            use_reentrant=False)
    (out * w).sum().backward()
    # the forward, its recompute in the backward, and one backward
    assert emulated == {"fwd": 2, "bwd": 1}
    for a, b in zip(mine, leaves):
        torch.testing.assert_close(a.grad, b.grad, atol=GRAD_ATOL, rtol=0)
    # the loss's gradient arrives broadcast (stride 0): the pair takes it
    q1 = q.clone().requires_grad_()
    _flash(q1, k, v).sum().backward()
    q2 = q.clone().requires_grad_()
    _plain(q2, k, v).sum().backward()
    torch.testing.assert_close(q1.grad, q2.grad, atol=GRAD_ATOL, rtol=0)


def test_function_under_torch_func(emulated):
    """Phases 0 and 1 train under ``torch.func.grad`` and ``vmap(grad)``:
    the vmapped dimension folds into the batch at both kernels."""
    q, k, v, w = _inputs(4, 20, 25, 2, 16, b=1)
    wq = torch.from_numpy(
        np.random.default_rng(5).standard_normal((3, 16, 16))).float()

    def loss(attend, wqi):
        return (attend(q @ wqi, k, v) * w).sum()

    want = torch.stack([torch.func.grad(lambda x: loss(_plain, x))(wq[i])
                        for i in range(3)])
    got = torch.func.vmap(torch.func.grad(lambda x: loss(_flash, x)))(wq)
    assert emulated["fwd"] >= 1 and emulated["bwd"] >= 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    one = torch.func.grad(lambda x: loss(_flash, x))(wq[0])
    torch.testing.assert_close(one, want[0], atol=1e-4, rtol=1e-5)


# -- dispatch ------------------------------------------------------------------


def test_cpu_and_meta_take_the_plain_path(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel path ran on a plain device")

    monkeypatch.setattr(ops._FlashAttention, "apply", refuse)
    q, k, v, _ = _inputs(6, 40, 40, 4, 16)
    kw = dict(causal=True, window=None, q_offset=0, q_chunk=16)
    torch.testing.assert_close(ops.flash_attention(q, k, v, **kw),
                               ref.attend_full_ref(q, k, v, **kw),
                               atol=0, rtol=0)
    meta = ops.flash_attention(*(x.to("meta") for x in (q, k, v)), **kw)
    assert meta.device.type == "meta" and meta.shape == q.shape


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, _ = _inputs(7, 8, 8, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q, k, v)
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1])
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd(q, q, k, v, q, lse)


def test_attention_layer_runs_the_dispatch(monkeypatch):
    """``nn/attention.py``'s full-sequence forward goes through
    ``ops.flash_attention`` with the config's mask."""
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append(kw)
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    cfg = attention.AttnConfig(d_model=32, num_heads=4, kv_heads=2,
                               head_dim=8, window=6, q_chunk=4)
    q, k, v, _ = _inputs(8, 12, 12, 2, 8)
    attention.attend_full(q, k, v, cfg, q_offset=0)
    assert seen == [dict(causal=True, window=6, q_offset=0, q_chunk=4)]


# -- the deliberate deviation: f32 scores on the card, bf16 in JAX -------------


def test_f32_scores_deviation_is_pinned():
    """The CPU path is the JAX function's arithmetic (scores from a bf16
    product, probabilities cast to bf16): equal to ``repro``'s
    ``attend_full`` in f32 to float error and in bf16 to bf16 rounding.
    The kernel keeps its scores in f32 (its tiling, emulated): a different
    number in bf16, no farther from the f32 version than the bf16 plain
    path is."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.nn import attention as jattn
    jcfg = jattn.AttnConfig(d_model=64, num_heads=8, kv_heads=2,
                            head_dim=32, window=24, q_chunk=16)
    cfg = attention.AttnConfig(d_model=64, num_heads=8, kv_heads=2,
                               head_dim=32, window=24, q_chunk=16)
    q, k, v, _ = _inputs(9, 48, 48, 4, 32)
    f32 = attention.attend_full(q, k, v, cfg)
    j32 = jattn.attend_full(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                            jcfg)
    np.testing.assert_allclose(f32.numpy(), np.asarray(j32), atol=1e-5)
    bf = [x.bfloat16() for x in (q, k, v)]
    port = attention.attend_full(*bf, cfg).float()
    jbf = jattn.attend_full(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                              for x in bf), jcfg)
    jbf = torch.from_numpy(np.array(jbf.astype(jnp.float32)))
    torch.testing.assert_close(port, jbf, atol=2e-2, rtol=0)
    kernel, _ = ref.flash_fwd_tiled(*bf, causal=True, window=24,
                                    block_m=16, block_n=16)
    kernel = kernel.float()
    exact = attention.attend_full(*(x.float() for x in bf), cfg)
    assert not torch.equal(kernel, port)
    kernel_err = (kernel - exact).abs().max()
    plain_err = (port - exact).abs().max()
    assert kernel_err <= plain_err and kernel_err < 2e-2
    assert jax is not None
