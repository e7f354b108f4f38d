"""The port's logical-axis sharding against the JAX package's.

``repro_torch.sharding.rules.logical_to_spec`` must resolve every tensor
as ``repro.sharding.rules.logical_to_spec`` does on the production meshes
(16 x 16 and 2 x 16 x 16, abstract on both sides); ``Transformer.specs``,
``cache_specs`` and ``paged_cache_specs`` must equal the JAX trees for
every registered arch; and the resolved shardings of parameters, batches
and caches, the per-device parameter bytes and ``param_count`` must equal
the JAX package's.  Nothing here needs a process group.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.launch.mesh import make_abstract_mesh as jabstract  # noqa: E402
from repro.models.transformer import Transformer as JT  # noqa: E402
from repro.sharding.rules import logical_to_spec as jlogical  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import (make_abstract_mesh,  # noqa: E402
                                     production_shape)
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402
from repro_torch.sharding.rules import _COMMON, logical_to_spec  # noqa: E402

ARCHS = registry.list_archs()
MESHES = {"16x16": False, "2x16x16": True}


def _meshes(multi_pod):
    shape, axes = production_shape(multi_pod)
    return make_abstract_mesh(shape, axes), jabstract(shape, axes)


def _tuple_tree(t):
    if isinstance(t, dict):
        return {k: _tuple_tree(v) for k, v in t.items()}
    return tuple(t)


def _leaves(tree, keys=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], keys + (k,))
    else:
        yield keys, tree


def _jax_abstract_params(cfg):
    box = {}

    def f(k):
        p, s = JT.init(cfg, k)
        box["s"] = s
        return p

    return jax.eval_shape(f, jax.random.key(0)), box["s"]


# -- logical_to_spec, case for case with tests/test_sharding.py -------------

CASES = [
    (("vocab", "embed"), (152064, 8192), False, ("model", "data")),
    (("embed", "heads", "head_dim"), (5120, 40, 128), False,
     ("data", None, None)),
    (("embed", "heads", "head_dim"), (8192, 64, 128), False,
     ("data", "model", None)),
    (("batch", "kv_seq", "kv_heads", None), (128, 32768, 8, 128), False,
     ("data", "model", None, None)),
    (("batch", None), (256, 4096), False, ("data", None)),
    (("batch", None), (256, 4096), True, (("pod", "data"), None)),
    (("batch", "kv_seq", "kv_heads", None), (1, 524288, 8, 128), False,
     (None, "model", None, None)),
    (("experts", "mlp", None), (384, 2048, 4), False, ("model", None, None)),
]


@pytest.mark.parametrize("axes,shape,multi_pod,want", CASES)
def test_logical_to_spec_cases_match_jax(axes, shape, multi_pod, want):
    mesh, jmesh = _meshes(multi_pod)
    got = logical_to_spec(axes, shape, mesh)
    assert tuple(got) == want
    assert tuple(got) == tuple(jlogical(axes, shape, jmesh))


def test_logical_to_spec_rank_check():
    mesh, _ = _meshes(False)
    with pytest.raises(ValueError):
        logical_to_spec(("batch",), (8, 8), mesh)


_NAMES = sorted(_COMMON) + [None, "unknown"]


@settings(max_examples=300, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(_NAMES),
                          st.sampled_from([1, 2, 3, 8, 16, 24, 32, 40, 48,
                                           256, 512, 4096, 1000])),
                min_size=1, max_size=5),
       st.booleans())
def test_logical_to_spec_sweep_matches_jax(dims, multi_pod):
    axes = tuple(a for a, _ in dims)
    shape = tuple(n for _, n in dims)
    mesh, jmesh = _meshes(multi_pod)
    assert tuple(logical_to_spec(axes, shape, mesh)) == tuple(
        jlogical(axes, shape, jmesh))


def test_placements_shard_a_two_axis_dimension_on_both():
    from torch.distributed.tensor import Replicate, Shard
    mesh, _ = _meshes(True)
    spec = logical_to_spec(("batch", None, "vocab"), (256, 4096, 1024), mesh)
    assert spec == R.Spec(("pod", "data"), None, "model")
    assert R.placements(spec, mesh) == (Shard(0), Shard(0), Shard(2))
    single, _ = _meshes(False)
    assert R.placements(logical_to_spec(("heads",), (40,), single),
                        single) == (Replicate(), Replicate())


def test_constrain_is_a_no_op_without_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert R.get_active_mesh_or_none() is None
    assert R.constrain(x, ("batch", None)) is x


def test_mesh_context_refuses_an_abstract_mesh():
    from repro_torch.launch.mesh import mesh_context
    mesh, _ = _meshes(False)
    with pytest.raises(TypeError, match="DeviceMesh"):
        with mesh_context(mesh):
            pass


# -- the spec trees ----------------------------------------------------------

@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_match_jax(arch, size):
    get = "get_config" if size == "full" else "get_smoke_config"
    cfg, jcfg = getattr(registry, get)(arch), getattr(jregistry, get)(arch)
    jshapes, jspecs = _jax_abstract_params(jcfg)
    assert Transformer.specs(cfg) == _tuple_tree(jspecs)
    assert Transformer.cache_specs(cfg) == _tuple_tree(JT.cache_specs(jcfg))
    assert Transformer.paged_cache_specs(cfg) == _tuple_tree(
        JT.paged_cache_specs(jcfg))
    # the meta parameters have the JAX shapes and dtypes, leaf for leaf
    params = Transformer.init(cfg, device="meta")
    got = [(k, tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in _leaves(params)]
    want = [(k, tuple(v.shape), str(v.dtype)) for k, v in _leaves(
        jax.tree.map(lambda x: x, jshapes))]
    assert got == want


# -- resolved production shardings -------------------------------------------

def _jspec_tree(specs, shapes, jmesh):
    is_axes = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(e, (str, type(None))) for e in x)
    return jax.tree.map(lambda ax, leaf: tuple(jlogical(ax, leaf.shape, jmesh)),
                        specs, shapes, is_leaf=is_axes)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_bytes_and_counts_match_jax(arch, mesh_name):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    mesh, jmesh = _meshes(MESHES[mesh_name])
    params, specs = S.abstract_params(cfg)
    jshapes, jspecs = JS.abstract_params(jcfg)
    got = R.tree_specs(specs, params, mesh)
    want = _jspec_tree(jspecs, jshapes, jmesh)
    assert [(k, tuple(v)) for k, v in _leaves(got)] == list(_leaves(
        _tuple_tree(want)))
    # per-device parameter bytes: the JAX NamedSharding shard shapes
    jbytes = sum(
        math.prod(NamedSharding(jmesh, jax.sharding.PartitionSpec(*sp))
                  .shard_shape(leaf.shape)) * leaf.dtype.itemsize
        for (_, sp), (_, leaf) in zip(_leaves(_tuple_tree(want)),
                                      _leaves(jshapes)))
    pbytes = sum(math.prod(R.shard_shape(leaf.shape, sp, mesh))
                 * leaf.element_size()
                 for (_, sp), (_, leaf) in zip(_leaves(got), _leaves(params)))
    assert pbytes == jbytes
    assert S.param_count(cfg) == JS.param_count(jcfg)
    assert S.param_count(cfg, active_only=True) == JS.param_count(
        jcfg, active_only=True)


def test_production_parameter_bytes_of_granite_and_kimi():
    for multi_pod in (False, True):
        mesh, _ = _meshes(multi_pod)
        for arch, want in (("granite-3-2b", 30_748_672),
                           ("kimi-k2-1t-a32b", 8_270_983_168)):
            params, specs = S.abstract_params(registry.get_config(arch))
            got = R.tree_specs(specs, params, mesh)
            assert sum(math.prod(R.shard_shape(leaf.shape, sp, mesh))
                       * leaf.element_size() for (_, sp), (_, leaf) in
                       zip(_leaves(got), _leaves(params))) == want
    assert S.param_count(registry.get_config("granite-3-2b")) == 2_432_862_208
    kimi = registry.get_config("kimi-k2-1t-a32b")
    assert (S.param_count(kimi), S.param_count(kimi, active_only=True)) == (
        1_042_512_049_152, 32_406_205_440)


COMBOS = [(a, s) for a in ARCHS for s in SHAPES
          if registry.skip_reason(a, s) is None]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", COMBOS)
def test_batch_and_cache_shardings_match_jax(arch, shape, mesh_name):
    cfg, jcfg = registry.for_shape(arch, shape), jregistry.for_shape(arch,
                                                                     shape)
    mesh, jmesh = _meshes(MESHES[mesh_name])
    batch, jbatch = S.input_specs(cfg, SHAPES[shape]), JS.input_specs(
        jcfg, JSHAPES[shape])
    axes = S.batch_logical_axes(batch)
    assert axes == JS.batch_logical_axes(jbatch)
    for k in batch:
        assert tuple(batch[k].shape) == tuple(jbatch[k].shape)
        assert tuple(logical_to_spec(axes[k], batch[k].shape, mesh)) == tuple(
            jlogical(axes[k], jbatch[k].shape, jmesh))
    sh = SHAPES[shape]
    if sh.kind != "decode":
        return
    cache, cspecs = S.abstract_cache(cfg, sh.global_batch, sh.seq_len)
    jcache, jcspecs = JS.abstract_cache(jcfg, sh.global_batch, sh.seq_len)
    got = R.tree_specs(cspecs, cache, mesh)
    want = _jspec_tree(jcspecs, jcache, jmesh)
    assert [(k, tuple(v)) for k, v in _leaves(got)] == list(_leaves(
        _tuple_tree(want)))
    assert [tuple(v.shape) for _, v in _leaves(cache)] == [
        tuple(v.shape) for _, v in _leaves(jcache)]


def test_named_sharding_gives_mesh_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh, _ = _meshes(False)
    m, pl = R.named_sharding(("vocab", "embed"), (152064, 8192), mesh)
    assert m is mesh and pl == (Shard(1), Shard(0))
    tree = R.tree_shardings({"w": ("embed", "mlp")},
                            {"w": torch.empty((32, 48), device="meta")}, mesh)
    assert tree["w"][1] == (Shard(0), Shard(1))
    assert R.named_sharding(("heads",), (40,), mesh)[1] == (Replicate(),) * 2
    assert np.prod(mesh.shape) == mesh.size() == 256
