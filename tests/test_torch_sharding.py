"""``repro_torch.launch.sharding`` against ``repro.launch.sharding``.

In process, no ranks: the rules read only a mesh's axis names and
extents, so the port's ``AbstractMesh`` and JAX's ``AbstractMesh`` stand
for the meshes.  ``param_specs`` for all ten archs (meta specs, read on
the reference's tree through ``convert``'s layout) x the meshes (16,16),
(2,16,16), (4,2), (2,2,2) x four policies; ``batch_specs``,
``cache_specs`` (k/v, MLA c/kr, conv/ssm, x_prev/wkv, ``long_500k``'s
sequence split), ``activation_rules`` and ``opt_state_specs`` (adamw,
adafactor) entry for entry against the reference's ``PartitionSpec``s;
``to_placements`` and ``shard()`` as the identity without rules.
"""

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import INPUT_SHAPES as JSHAPES, get_config as jget
from repro.configs.shapes import ShapeSkip as JShapeSkip
from repro.configs.shapes import input_specs as jinput_specs
from repro.launch import sharding as jsh
from repro.models import transformer as jtf
from repro.optim import get_optimizer as jget_optimizer
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.configs.shapes import input_specs
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.optim import get_optimizer

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}
POLICIES = {
    "default": dict(),
    "fsdp_over_pod": dict(fsdp_over_pod=True),
    "no_tp": dict(tp=False),
    "attn_batch_over_model": dict(attn_batch_over_model=True),
}


def _meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), JaxAbstractMesh(shape, names)


def _policies(name):
    kw = POLICIES[name]
    return sh.ShardingPolicy(**kw), jsh.ShardingPolicy(**kw)


def _by_path(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _assert_same(ours, ref_shardings):
    """Every reference leaf's spec equals the port's leaf at its path."""
    leaves = jax.tree_util.tree_leaves_with_path(ref_shardings)
    assert leaves
    for path, ns in leaves:
        assert _by_path(ours, path) == tuple(ns.spec), \
            jax.tree_util.keystr(path)


@pytest.fixture(scope="module")
def trees():
    """Each arch's port meta params and the reference's shape tree."""
    out = {}
    for arch in ARCHITECTURES:
        out[arch] = (tf.param_specs(get_config(arch)),
                     jax.eval_shape(lambda a=arch: jtf.init(
                         jget(a), jax.random.key(0))))
    return out


@pytest.mark.parametrize("arch", list(ARCHITECTURES))
def test_param_specs_are_the_references(trees, arch):
    params, ref_params = trees[arch]
    for mesh_name in MESHES:
        mesh, jmesh = _meshes(mesh_name)
        for pol in POLICIES:
            policy, jpolicy = _policies(pol)
            ours = sh.reference_tree(sh.param_specs(params, mesh, policy))
            _assert_same(ours, jsh.param_specs(ref_params, jmesh, jpolicy))


def test_smollm_specs_read_as_the_issue_states(trees):
    params, _ = trees["smollm-360m"]
    mesh, _ = _meshes("2x16x16")
    specs = sh.reference_tree(sh.param_specs(params, mesh,
                                             sh.ShardingPolicy()))
    assert specs["embed|vocab,embed"] == ("model", "data")
    assert specs["group0"]["e0"]["ffn"]["w_down|mlp,embed"] == \
        (None, "model", "data")
    assert len(sh.spec_leaves(specs)) == 11


@pytest.mark.parametrize("arch", list(ARCHITECTURES))
def test_batch_and_cache_specs_are_the_references(arch):
    for shape_name, shape in JSHAPES.items():
        try:
            jcfg, jspecs, kind = jinput_specs(jget(arch), shape_name)
        except JShapeSkip:
            continue
        cfg, specs, _ = input_specs(get_config(arch), shape_name)
        for mesh_name in MESHES:
            mesh, jmesh = _meshes(mesh_name)
            for pol in POLICIES:
                policy, jpolicy = _policies(pol)
                if kind != "decode":
                    _assert_same(sh.batch_specs(specs, mesh, policy),
                                 jsh.batch_specs(jspecs, jmesh, jpolicy))
                    continue
                b = shape["global_batch"]
                ours = tf.cache_tree(cfg, sh.cache_specs(
                    specs["cache"], mesh, policy, global_batch=b))
                _assert_same(ours, jsh.cache_specs(
                    jspecs["cache"], jmesh, jpolicy, global_batch=b))
                tok = sh.batch_specs({"tokens": specs["tokens"]}, mesh,
                                     policy)
                _assert_same(tok, jsh.batch_specs(
                    {"tokens": jspecs["tokens"]}, jmesh, jpolicy))


def test_cache_specs_cover_every_state_kind():
    """k/v, MLA's c/kr, Mamba's conv/ssm and RWKV's x_prev/wkv all meet a
    rule, and long_500k (batch 1) splits the KV sequence over data."""
    mesh, _ = _meshes("4x2")
    seen = {}
    for arch in ("smollm-360m", "deepseek-v3-671b", "jamba-v0.1-52b",
                 "rwkv6-3b"):
        cfg, specs, _ = input_specs(get_config(arch), "decode_32k")
        tree = sh.cache_specs(specs["cache"], mesh, sh.ShardingPolicy(),
                              global_batch=128)
        _collect(tree, seen)
    assert {"k", "v", "c", "kr", "conv", "ssm", "x_prev", "wkv"} <= set(seen)
    assert seen["ssm"] == (None, "data", "model", None)
    cfg, specs, _ = input_specs(get_config("gemma-7b"), "long_500k")
    tree = sh.cache_specs(specs["cache"], mesh, sh.ShardingPolicy(),
                          global_batch=1)
    assert tree["k"][:3] == (None, None, "data")


def _collect(tree, seen):
    for k, v in tree.items():
        if isinstance(v, dict):
            _collect(v, seen)
        else:
            seen.setdefault(k, v)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_activation_rules_are_the_references(mesh_name):
    mesh, jmesh = _meshes(mesh_name)
    for pol in POLICIES:
        policy, jpolicy = _policies(pol)
        for gb, kv, per_ex in ((256, False, False), (1, True, False),
                               (32, False, True), (128, True, False),
                               (6, False, False)):
            ours = sh.activation_rules(mesh, policy, global_batch=gb,
                                       shard_kv_seq=kv, per_example=per_ex)
            ref = jsh.activation_rules(jmesh, jpolicy, global_batch=gb,
                                       shard_kv_seq=kv, per_example=per_ex)
            assert ours.pop("__mesh__") is mesh
            ref.pop("__mesh__")
            assert ours == ref


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-30b-a3b",
                                  "rwkv6-3b"])
def test_opt_state_specs_are_the_references(trees, arch, opt_name):
    params, ref_params = trees[arch]
    state = get_optimizer(opt_name, 1e-3).init(params)
    ref_state = jax.eval_shape(jget_optimizer(opt_name, 1e-3).init,
                               ref_params)
    for mesh_name in ("16x16", "2x2x2"):
        mesh, jmesh = _meshes(mesh_name)
        policy, jpolicy = _policies("default")
        pspecs = sh.param_specs(params, mesh, policy)
        ours = sh.opt_state_specs(opt_name, params, pspecs, state, mesh)
        ref = jsh.opt_state_specs(
            opt_name, ref_params, jsh.param_specs(ref_params, jmesh, jpolicy),
            ref_state, jmesh)
        assert type(ours).__name__ == type(ref).__name__
        for field in ref._fields:
            got, want = getattr(ours, field), getattr(ref, field)
            if isinstance(got, dict):
                _assert_same(sh.reference_tree(got), want)
            else:
                assert got == tuple(want.spec)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh, _ = _meshes("2x2x2")
    assert sh.to_placements((None, ("pod", "data"), "model"), mesh) == \
        [Shard(1), Shard(1), Shard(2)]
    assert sh.to_placements(("model", "data"), mesh) == \
        [Replicate(), Shard(1), Shard(0)]
    assert sh.to_placements((), mesh) == [Replicate()] * 3


def test_shard_is_the_identity_without_rules_or_dtensors():
    x = torch.randn(2, 3, 4)
    assert layers.shard(x, "batch", None, "mlp") is x
    mesh, _ = _meshes("4x2")
    rules = sh.activation_rules(mesh, sh.ShardingPolicy(), global_batch=4)
    with layers.activation_sharding(rules):
        # a plain tensor is never redistributed: one-card paths keep theirs
        assert layers.shard(x, "batch", None, "mlp") is x
        assert layers.activation_spec((4, 3, 8), ("batch", None, "mlp"),
                                      rules) == (("data",), None, "model")
        # first axis wins, non-divisible dims replicate
        assert layers.activation_spec((6, 3, 8), ("batch", None, "mlp"),
                                      rules) == (None, None, "model")
    assert layers.split_last(x, 2, 2).shape == (2, 3, 2, 2)


def test_logical_axes_are_the_references():
    from repro.models.layers import logical_axes as jlogical_axes

    for key, nd in (("wq|embed,qheads", 3), ("scale|embed", 1), ("w", 2),
                    ("conv_w|conv,inner", 4), ("b|", 1)):
        assert layers.logical_axes(key, nd) == jlogical_axes(key, nd)
