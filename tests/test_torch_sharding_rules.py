"""The port's production sharding rules (``repro_torch.launch.sharding``)
against the JAX package's, and its mesh helpers.

The rules read only each leaf's shape, its path and the mesh's axis sizes,
so both packages are called with one stub mesh whose ``shape`` is the 16x16
production geometry (and the two-pod 2x16x16), on the ``jax.eval_shape``
trees of every configuration in ``src/repro/configs/``: the parameters,
the AdamW state (its paths embed the parameters'), the decode caches and
the batches of each input kind. A JAX ``PartitionSpec`` and the port's
tuple must hold the same entries, leaf for leaf.
"""

import types

import pytest

jax = pytest.importorskip("jax")  # the JAX reference these tests compare with

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs.base import SHAPES  # noqa: E402
from repro.launch import sharding as jax_sharding  # noqa: E402
from repro.models.api import get_model, make_batch_specs  # noqa: E402
from repro.optim import adamw  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch.mesh import data_axes  # noqa: E402

ARCHS = list_archs() + ["har-mlp"]
PROD = types.SimpleNamespace(shape={"data": 16, "model": 16})
PODS = types.SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16})
MESHES = {"prod": (PROD, ("data",)), "pods": (PODS, ("pod", "data"))}


def _jax_specs(tree, rule, mesh, dp):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax_sharding._path_str(p): tuple(rule(jax_sharding._path_str(p), l.shape, mesh, dp))
            for p, l in flat}


def _port_specs(tree, rule, mesh, dp):
    out = {}
    sharding._map_with_path(lambda p, l: out.__setitem__(p, rule(p, tuple(l.shape), mesh, dp)),
                            tree)
    return out


def _at(tree, path):
    for part in path.split("/"):
        if isinstance(tree, dict):
            tree = tree[part]
        elif hasattr(tree, "_fields"):
            tree = getattr(tree, part)
        else:
            tree = tree[int(part)]
    return tree


@pytest.fixture(scope="module")
def trees():
    """Abstract parameter, AdamW-state and decode-cache trees of every
    configuration (shapes only: nothing is allocated)."""
    out = {}
    for arch in ARCHS:
        cfg = jax_get_config(arch)
        bundle = get_model(cfg)
        params = jax.eval_shape(bundle.init, jax.random.key(0))
        opt = jax.eval_shape(adamw(3e-4).init, params)
        cache = (None if arch == "har-mlp"
                 else jax.eval_shape(lambda b=bundle: b.init_cache(2, 64, 0)))
        out[arch] = (cfg, params, opt, cache)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_optimizer_specs_match_jax(trees, arch, mesh):
    m, dp = MESHES[mesh]
    _, params, opt, _ = trees[arch]
    for tree in (params, opt):
        want = _jax_specs(tree, jax_sharding.param_spec, m, dp)
        got = _port_specs(tree, sharding.param_spec, m, dp)
        assert got == want
    assert len(want) > 0
    # the tree form mirrors the input tree, a spec where each leaf was
    specs = sharding.tree_pspecs(params, m, dp)
    for path, spec in _jax_specs(params, jax_sharding.param_spec, m, dp).items():
        assert _at(specs, path) == spec, path


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "har-mlp"])
def test_cache_specs_match_jax(trees, arch):
    _, _, _, cache = trees[arch]
    for m, dp in MESHES.values():
        want = _jax_specs(cache, jax_sharding.cache_spec, m, dp)
        assert _port_specs(cache, sharding.cache_spec, m, dp) == want


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "har-mlp"])
def test_batch_specs_match_jax(trees, arch):
    cfg = trees[arch][0]
    for kind in ("train", "prefill", "decode"):
        for batch in (1, 16, 256, 48):
            for name, (shape, _) in make_batch_specs(cfg, kind, batch, 128).items():
                for m, dp in MESHES.values():
                    want = tuple(jax_sharding.batch_spec(name, shape, m, dp))
                    assert sharding.batch_spec(name, shape, m, dp) == want, (kind, name, shape)


def test_rules_on_hand_made_paths():
    """The rule cases the JAX package's own tests spell out."""
    dp = ("data",)
    assert sharding.param_spec("dense/w", (512, 512), PROD, dp) == ("data", "model")
    assert sharding.param_spec("dense/b", (512,), PROD, dp) == ("model",)
    assert sharding.param_spec("scale", (), PROD, dp) == ()
    assert sharding.param_spec("tiny/w", (20, 20), PROD, dp) == (None, None)
    assert sharding.param_spec("stack/dense/w", (8, 512, 512), PROD, dp) == (None, "data", "model")
    assert sharding.param_spec("mixer/x_proj", (1024, 96), PROD, dp) == ("model", None)
    assert sharding.param_spec("dense/w", (64, 512), PODS, ("pod", "data")) == (
        ("pod", "data"), "model")
    assert data_axes() == ("data",) and data_axes(multi_pod=True) == ("pod", "data")
    assert set(SHAPES)  # the input-shape registry the batches come from


@pytest.mark.parametrize("k,world", [(8, 1), (8, 2), (8, 4), (30, 3), (64, 8)])
def test_lane_blocks_tile_the_cohort(k, world):
    blocks = [sharding.lane_block(k, world, r) for r in range(world)]
    assert [i for b in blocks for i in range(k)[b]] == list(range(k))
    mesh = types.SimpleNamespace(shape={"cohort": world}, rank=world - 1)
    assert sharding.lane_spec((k, 3), mesh) == blocks[-1]
    tree = [{"w": types.SimpleNamespace(shape=(k, 2, 2))}, {"b": types.SimpleNamespace(shape=(k,))}]
    assert sharding.tree_lane_pspecs(tree, mesh) == [{"w": blocks[-1]}, {"b": blocks[-1]}]


def test_lane_blocks_raise_on_a_remainder():
    with pytest.raises(ValueError, match="must divide"):
        sharding.lane_block(8, 3, 0)
    with pytest.raises(ValueError, match="must divide"):
        sharding.lane_spec((10, 2), types.SimpleNamespace(shape={"cohort": 4}, rank=0))
