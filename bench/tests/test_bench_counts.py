"""The benchmark's operation and byte counts against hand counts and
against PyTorch's own FLOP counter over the program's forward at the SMOKE
widths."""

import copy

import bench_tiny  # noqa: F401  (puts bench/ and src/ on the path)
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchlib import flops, spec, weights


def smoke_dims(name="granite-3-2b"):
    conf = bench_tiny.tiny_config(spec.read_json(
        spec.BENCH / "configs" / f"{name}.json"))
    return conf, weights.dims(conf)


def test_matmul_flops_per_token_by_hand():
    _, k = smoke_dims()
    # d 256, 4 heads and 2 kv heads of 64, ff 512, 2 layers, vocab 500:
    # q 256*256, k and v 256*128 each, o 256*256, mlp 3*256*512
    layer = 2 * (65536 + 2 * 32768 + 65536 + 393216)
    assert flops.matmul_flops_per_token(k) == 2 * layer + 2 * 256 * 500
    assert flops.matmul_flops_per_token(k, unembed=False) == 2 * layer


def test_attention_and_step_flops_by_hand():
    _, k = smoke_dims()
    # causal pairs of 32 tokens: 528; QK and PV, 2 FLOPs a MAC, 4 heads x 64
    assert flops.causal_attention_flops(k, 32) == 2 * 2 * 2 * 256 * 528
    fwd = 3 * (32 * flops.matmul_flops_per_token(k)
               + flops.causal_attention_flops(k, 32))
    assert flops.forward_flops(k, 3, 32) == fwd
    assert flops.phase2_step_flops(k, 3, 32, buffer=True) == 5 * fwd
    assert flops.phase2_step_flops(k, 3, 32, buffer=False) == 4 * fwd
    assert flops.decode_token_flops(k, 100) == (
        flops.matmul_flops_per_token(k) + 2 * 2 * 2 * 256 * 100)
    assert flops.prefill_flops(k, 32) == (
        32 * flops.matmul_flops_per_token(k, unembed=False)
        + flops.causal_attention_flops(k, 32) + 2 * 256 * 500)


@pytest.mark.parametrize("name", ["granite-3-2b", "qwen3-14b"])
def test_forward_flops_against_torch_counter(name):
    """The program's forward computes every attention pair (the mask is
    applied after the product) and the head over the padded vocabulary:
    the counter's total is the benchmark's useful count plus exactly
    those."""
    from repro_torch.models.transformer import LMConfig, Transformer
    conf, k = smoke_dims(name)
    conf["program"].update(dtype="float32", param_dtype="float32")
    cfg = LMConfig(**weights.program_kwargs(conf))
    params = weights.draw_params(conf, 0, "w", "cpu")
    b, s = 2, 32
    tokens = torch.zeros((b, s), dtype=torch.long)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        Transformer.apply(cfg, params, {"tokens": tokens})
    useful = flops.forward_flops(k, b, s)
    masked = s * s - s * (s + 1) / 2
    masked_pairs = k["layers"] * 2 * 2 * k["h"] * k["hd"] * masked
    padded_head = 2 * k["d"] * (k["vocab_padded"] - k["vocab"])
    assert counter.get_total_flops() == useful + b * (masked_pairs
                                                      + s * padded_head)


def test_kd_bounds_by_hand():
    rows, v = 2048, 49408
    fwd, bwd = flops.kd_bounds(rows, v, 4, buffer=True)
    assert fwd == pytest.approx((rows * v * 4 * 3 + rows * 52) / 3.35e12)
    assert bwd == pytest.approx((rows * v * 4 * 4 + rows * 56) / 3.35e12)
    fwd, bwd = flops.kd_bounds(rows, v, 4, buffer=False)
    assert fwd == pytest.approx((rows * v * 4 * 2 + rows * 52) / 3.35e12)
    # a small vocabulary is still bound by bytes: 11 operations a logit
    # at 67 TFLOP/s take less than its 8 bytes at 3.35 TB/s
    fwd, _ = flops.kd_bounds(rows, 100, 4, buffer=False)
    assert fwd == pytest.approx((rows * 100 * 8 + rows * 52) / 3.35e12)


def test_swa_decode_bound_by_hand():
    # 8 slots of Qwen3-14B (8 kv heads, 5 groups, 128) over 12,000 rows
    got = flops.swa_decode_bound(12000, 8, 8, 5, 128, 2)
    want = (12000 * 8 * 128 * 2 * 2 + 2 * 8 * 8 * 5 * 128 * 2 + 32) / 3.35e12
    assert got == pytest.approx(want)


def test_tree_matches_program_init():
    """The benchmark draws the program's parameter tree: same paths,
    shapes and types as ``Transformer.init`` (qk-norm scales included)."""
    from repro_torch.models.transformer import LMConfig, Transformer

    def walk(tree, path=()):
        for key, value in tree.items():
            if isinstance(value, dict):
                yield from walk(value, path + (key,))
            else:
                yield ".".join(path + (key,)), value

    for name in ("granite-3-2b", "qwen3-14b"):
        conf, _ = smoke_dims(name)
        cfg = LMConfig(**weights.program_kwargs(conf))
        ours = {".".join(p): (s, weights.DTYPES["bfloat16"])
                for p, s, _ in weights.leaf_specs(conf)}
        theirs = {path: (tuple(t.shape), t.dtype) for path, t in
                  walk(Transformer.init(cfg, 0, device="cpu"))}
        assert ours == theirs


def test_leaves_redraw_alone():
    conf, _ = smoke_dims()
    tree = weights.draw_params(conf, 2**31 + 5, "student", "cpu")
    for i, (path, _, _) in enumerate(weights.leaf_specs(conf)):
        again = weights.draw_leaf(copy.deepcopy(conf), 2**31 + 5, "student",
                                  i, "cpu")
        assert torch.equal(weights.leaf(tree, path), again)
