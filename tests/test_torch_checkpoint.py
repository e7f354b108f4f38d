"""The PyTorch port's checkpoint format (``repro_torch.checkpoint``) against
the JAX package's.

The JAX package's own four cases run against the port, then checkpoints
cross the packages both ways: a tree of bf16, integer, bool and nested
list leaves, and an FL state with and without ``edge_sync``, written by one
package must load in the other, bit for bit (bf16 travels widened to
f32, which is exact).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro_torch.checkpoint import io  # noqa: E402
from repro_torch.checkpoint import (load_fl_state, load_tree,  # noqa: E402
                                    save_fl_state, save_tree)


def _f32(a):
    if isinstance(a, torch.Tensor):
        a = a.float() if a.dtype == torch.bfloat16 else a
        return a.numpy()
    return np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 \
        else np.asarray(a)


def _assert_leaves_equal(a, b):
    """Same paths and values (either package's tree; paths as the
    checkpoint keys them)."""
    la, lb = io._flatten_with_path(a), io._flatten_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(_f32(x), _f32(y), err_msg=str(path))


# -- the JAX package's four cases, on the port ------------------------------


def test_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16),
                  "d": torch.tensor(7, dtype=torch.int32)}}
    path = str(tmp_path / "ckpt")
    save_tree(path, tree, meta={"step": 3})
    out = load_tree(path, tree)
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.bfloat16
    assert out["b"]["d"].dtype == torch.int32 and int(out["b"]["d"]) == 7
    assert io.load_meta(path) == {"step": 3}


def test_fl_state_roundtrip(tmp_path):
    core = {"w": torch.ones((3, 3))}
    opt = {"mu": {"w": torch.zeros((3, 3))}}
    buf = {"w": torch.full((3, 3), 2.0)}
    p = str(tmp_path / "fl")
    save_fl_state(p, core_params=core, opt_state=opt, buffer_params=buf,
                  round_idx=5, extra_meta={"method": "bkd"})
    c2, o2, b2, es2, meta = load_fl_state(p, core, opt, buf)
    assert meta["round"] == 5 and meta["method"] == "bkd"
    assert es2 is None
    assert torch.equal(b2["w"], buf["w"])
    # Asking for edge_sync from a checkpoint saved without it gives None.
    *_, es3, _ = load_fl_state(
        p, core, opt, buf,
        like_edge_sync={"v": torch.zeros(3, dtype=torch.int32)})
    assert es3 is None


def test_fl_state_persists_all_promised_fields(tmp_path):
    core = {"w": torch.ones((2, 2))}
    opt = {"mu": {"w": torch.zeros((2, 2))}}
    buf = {"w": torch.full((2, 2), 2.0)}
    edge_sync = {"version": torch.tensor([3, 0, 2], dtype=torch.int32),
                 "weights": torch.arange(6, dtype=torch.bfloat16).reshape(3, 2)}
    p = str(tmp_path / "fl_full")
    save_fl_state(p, core_params=core, opt_state=opt, buffer_params=buf,
                  round_idx=7, rng_seed=123, clock=4.5, edge_sync=edge_sync,
                  extra_meta={"method": "bkd"})
    c2, o2, b2, es2, meta = load_fl_state(p, core, opt, buf,
                                          like_edge_sync=edge_sync)
    assert (meta["round"], meta["rng_seed"], meta["clock"],
            meta["method"]) == (7, 123, 4.5, "bkd")
    assert torch.equal(es2["version"], edge_sync["version"])
    assert es2["version"].dtype == torch.int32
    assert es2["weights"].dtype == torch.bfloat16
    assert torch.equal(es2["weights"], edge_sync["weights"])


def test_save_tree_dtype_roundtrip(tmp_path):
    """bf16 / integer / bool leaves survive exactly (bf16 widened to f32
    inside the npz and cast back)."""
    tree = {
        "bf16": (torch.arange(7, dtype=torch.bfloat16) / 3),
        "i32": torch.tensor([-5, 0, 2**30], dtype=torch.int32),
        "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
        "u8": torch.tensor([0, 255], dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "np_i64": np.asarray([1, 2], np.int64),
    }
    path = str(tmp_path / "dtypes")
    save_tree(path, tree)
    out = load_tree(path, tree)
    for key, leaf in tree.items():
        assert out[key].dtype == leaf.dtype, key
        np.testing.assert_array_equal(_f32(out[key]), _f32(leaf),
                                      err_msg=key)


# -- across the packages ----------------------------------------------------


def _mixed_trees():
    """The same values as a port tree and a JAX tree: bf16, int, bool and
    nested list/tuple leaves (keys ``#i``), and a ``None`` subtree."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    bf = rng.standard_normal(5).astype(np.float32)
    ids = np.asarray([3, -1, 7], np.int32)
    mask = np.asarray([True, False])
    layers = [rng.standard_normal(2).astype(np.float32) for _ in range(3)]
    port = {"w": torch.from_numpy(w.copy()),
            "bf": torch.from_numpy(bf.copy()).to(torch.bfloat16),
            "meta": {"ids": torch.from_numpy(ids.copy()),
                     "mask": torch.from_numpy(mask.copy())},
            "layers": [torch.from_numpy(x.copy()) for x in layers],
            "pair": (torch.from_numpy(ids.copy()),
                     [torch.from_numpy(w[0].copy())]),
            "gone": None}
    jax_tree = {"w": jnp.asarray(w), "bf": jnp.asarray(bf, jnp.bfloat16),
                "meta": {"ids": jnp.asarray(ids), "mask": jnp.asarray(mask)},
                "layers": [jnp.asarray(x) for x in layers],
                "pair": (jnp.asarray(ids), [jnp.asarray(w[0])]),
                "gone": None}
    return port, jax_tree


def test_port_writes_the_jax_keys(tmp_path):
    port, jtree = _mixed_trees()
    save_tree(str(tmp_path / "p"), port)
    jio.save_tree(str(tmp_path / "j"), jtree)
    with np.load(tmp_path / "p.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "layers/#2" in a.files and "pair/#1/#0" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_tree_loads_across_packages(tmp_path, writer):
    port, jtree = _mixed_trees()
    path = str(tmp_path / "tree")
    if writer == "port":
        save_tree(path, port, meta={"by": "port"})
        out = jio.load_tree(path, jtree)
        assert out["bf"].dtype == jnp.bfloat16
        assert out["meta"]["ids"].dtype == jnp.int32
        assert out["meta"]["mask"].dtype == jnp.bool_
        _assert_leaves_equal(port, out)
        assert jio.load_meta(path) == {"by": "port"}
    else:
        jio.save_tree(path, jtree, meta={"by": "jax"})
        out = load_tree(path, port)
        assert out["bf"].dtype == torch.bfloat16
        assert out["meta"]["ids"].dtype == torch.int32
        assert out["meta"]["mask"].dtype == torch.bool
        assert isinstance(out["pair"], tuple) and out["gone"] is None
        _assert_leaves_equal(out, port)
        assert io.load_meta(path) == {"by": "jax"}


def _fl_trees(lib):
    rng = np.random.default_rng(1)
    w, b = (rng.standard_normal((4, 3)).astype(np.float32),
            rng.standard_normal(3).astype(np.float32))
    version = np.asarray([2, 0, 1], np.int32)
    if lib == "port":
        t = lambda a: torch.from_numpy(a.copy())  # noqa: E731
        core = {"w": t(w), "b": t(b).to(torch.bfloat16)}
        opt = {"mu": {"w": t(2 * w), "b": t(2 * b)}}
        return core, opt, {"w": t(w + 1), "b": t(b)}, {"version": t(version)}
    core = {"w": jnp.asarray(w), "b": jnp.asarray(b, jnp.bfloat16)}
    opt = {"mu": {"w": jnp.asarray(2 * w), "b": jnp.asarray(2 * b)}}
    return (core, opt, {"w": jnp.asarray(w + 1), "b": jnp.asarray(b)},
            {"version": jnp.asarray(version)})


@pytest.mark.parametrize("with_sync", [False, True])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fl_state_loads_across_packages(tmp_path, writer, with_sync):
    reader = "jax" if writer == "port" else "port"
    core, opt, buf, sync = _fl_trees(writer)
    path = str(tmp_path / "fl")
    save = save_fl_state if writer == "port" else jio.save_fl_state
    load = load_fl_state if reader == "port" else jio.load_fl_state
    save(path, core_params=core, opt_state=opt, buffer_params=buf,
         round_idx=4, rng_seed=9, clock=1.25,
         edge_sync=sync if with_sync else None, extra_meta={"method": "bkd"})
    like = _fl_trees(reader)
    c2, o2, b2, es2, meta = load(path, *like[:3], like_edge_sync=like[3])
    assert (meta["round"], meta["rng_seed"], meta["clock"],
            meta["method"]) == (4, 9, 1.25, "bkd")
    _assert_leaves_equal(c2, core)
    _assert_leaves_equal(o2["mu"], opt["mu"])
    _assert_leaves_equal(b2, buf)
    if with_sync:
        _assert_leaves_equal(es2, sync)
    else:
        assert es2 is None   # the tolerance for a missing edge_sync
