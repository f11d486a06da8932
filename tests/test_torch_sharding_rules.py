"""The port's sharding plan (`repro_torch.launch.sharding`) against the
reference's (`repro.launch.sharding`): every case of
tests/test_sharding_rules.py on the port, then the full-width plans of all
ten architectures on both production meshes, leaf for leaf, and the bytes
one device holds.  Both sides only trace shapes (`jax.eval_shape`, the meta
device)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.models.model as RM
from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.launch import sharding as RS
from repro.launch.steps import input_specs as ref_input_specs
from repro.launch.steps import train_state_specs as ref_train_state_specs
from repro.models.config import SHAPES as REF_SHAPES
from repro_torch.configs import get_config, shape_applicable
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (
    AbstractDevice,
    Mesh,
    make_local_mesh,
    make_production_mesh,
    mesh_axis_sizes,
)
from repro_torch.launch.sharding import P, Sharding, ShardingRules, rules_for_cell, spec_leaves
from repro_torch.launch.steps import input_specs, train_state_specs
from repro_torch.models.config import SHAPES
from repro_torch.models.model import init_params
from repro_torch.tree import tree_leaves


def _mk(multi_pod=False):
    return ShardingRules(make_production_mesh(multi_pod=multi_pod))


def _one(rules, tree, **kw):
    return spec_leaves(rules.param_pspecs(tree, **kw))[0]


def z(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the reference's cases, on the port
# ---------------------------------------------------------------------------

class TestParamSpecs:
    def test_column_parallel(self):
        tree = {"seg0": {"sub0": {"attn": {"wq": {"w": z(2, 4096, 8192)}}}}}
        assert _one(_mk(), tree) == P(None, "data", "model")

    def test_row_parallel(self):
        tree = {"seg0": {"sub0": {"attn": {"wo": {"w": z(2, 8192, 4096)}}}}}
        assert _one(_mk(), tree) == P(None, "model", "data")

    def test_vocab_divisibility_guard(self):
        # 50280 % 16 != 0 -> vocab axis dropped, FSDP picks d_model
        assert _one(_mk(), {"embed": {"table": z(50280, 1024)}}) == P(None, "data")

    def test_vocab_sharded_when_divisible(self):
        assert _one(_mk(), {"embed": {"table": z(152064, 5120)}}) == P("model", "data")

    def test_moe_expert_banks(self):
        spec = _one(_mk(), {"seg0": {"sub0": {"moe": {"w_up": z(2, 16, 6144, 10752)}}}})
        assert spec[3] == "model" and "data" in spec

    def test_moe_expert_banks_ep_serving(self):
        r = _mk()
        r.moe_ep = True
        spec = _one(r, {"seg0": {"sub0": {"moe": {"w_up": z(2, 16, 6144, 10752)}}}},
                    fsdp=False)
        assert spec[1] == "data" and spec[3] == "model"

    def test_replicated_kv_gets_fsdp_only(self):
        spec = _one(_mk(), {"seg0": {"sub0": {"attn": {"wk": {"w": z(2, 5120, 1024)}}}}})
        assert "model" not in spec and "data" in spec

    def test_norm_scales_small_no_fsdp(self):
        assert _one(_mk(), {"final_norm": {"g": z(15)}}) == P()

    def test_packed_ternary_like_dense(self):
        tree = {"seg0": {"sub0": {"mlp": {"w_up": {
            "packed": z(2, 1024, 4096, dtype=torch.uint8), "scale": z(2, 4096)}}}}}
        specs = spec_leaves(_mk().param_pspecs(tree))
        assert P(None, "data", "model") in specs and P(None, "model") in specs


class TestCellRules:
    def test_train_batch_divisible(self):
        r = rules_for_cell(make_production_mesh(), get_config("gemma-2b"), SHAPES["train_4k"])
        assert r.logical["batch"] == ("data",) and r.logical["cache_seq"] == "model"

    def test_long500k_batch1_falls_back_to_seq(self):
        r = rules_for_cell(make_production_mesh(), get_config("mamba2-370m"),
                           SHAPES["long_500k"])
        assert r.logical["batch"] is None
        assert tuple(r.logical["cache_seq"]) == ("data", "model")

    def test_multipod_axes(self):
        r = rules_for_cell(make_production_mesh(multi_pod=True), get_config("qwen2.5-32b"),
                           SHAPES["train_4k"])
        assert r.logical["batch"] == ("pod", "data")


class TestLogicalAxes:
    def test_activation_specs_and_axis_sizes(self):
        r = rules_for_cell(make_production_mesh(multi_pod=True), get_config("gemma-2b"),
                           SHAPES["decode_32k"])
        assert r.spec("batch", None, "heads") == P(("pod", "data"), None, "model")
        assert r.spec("res_seq", "kv_heads") == P("model", None)
        assert (r._axes_size("batch"), r._axes_size("heads"), r._axes_size("seq")) == (
            32, 16, 1)


class TestShardFnGuard:
    def test_skips_non_divisible(self):
        shard = _mk().make_shard_fn()
        x = torch.zeros((2, 10, 8))  # heads=8 % 16 != 0
        assert shard(x, "batch", None, "heads") is x

    def test_identity_on_one_real_device(self):
        shard = ShardingRules(make_local_mesh("cpu")).make_shard_fn()
        x = torch.zeros((4, 16, 32))
        assert shard(x, "batch", "res_seq", "heads") is x

    def test_raises_on_several_real_devices(self):
        devices = np.empty((2, 1), dtype=object)
        devices[:, 0] = [torch.device("cpu"), torch.device("cpu")]
        with pytest.raises(NotImplementedError, match="tensor-parallel execution"):
            ShardingRules(Mesh(devices, ("data", "model"))).make_shard_fn()


class TestMesh:
    @pytest.mark.parametrize("multi_pod,shape,axes", [
        (False, (16, 16), ("data", "model")),
        (True, (2, 16, 16), ("pod", "data", "model")),
    ])
    def test_production_mesh_is_the_references_and_abstract(self, multi_pod, shape, axes):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert mesh.devices.shape == shape and mesh.axis_names == axes
        assert mesh.abstract and mesh.size == int(np.prod(shape))
        assert isinstance(mesh.devices.flat[0], AbstractDevice)
        assert mesh_axis_sizes(mesh) == dict(zip(axes, shape))

    def test_local_mesh(self, monkeypatch):
        mesh = make_local_mesh("cpu")
        assert mesh.devices.shape == (1, 1) and not mesh.abstract
        assert mesh.axis_names == ("data", "model")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        cards = make_local_mesh()  # "cuda": every card
        assert cards.devices.shape == (2, 1) and list(cards.devices.flat) == [
            torch.device("cuda", 0), torch.device("cuda", 1)]
        with pytest.raises(NotImplementedError, match="tensor-parallel"):
            ShardingRules(cards).make_shard_fn()
        one = make_local_mesh("cuda:1")
        assert list(one.devices.flat) == [torch.device("cuda", 1)]
        assert ShardingRules(one).make_shard_fn()(x := torch.zeros(2)) is x
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make_local_mesh()

    def test_partition_spec_reads_as_the_references(self):
        assert repr(P(None, "data")) == "PartitionSpec(None, 'data')"
        assert tuple(P(("data",), (), ("pod", "data"))) == tuple(
            JP(("data",), (), ("pod", "data")))

    def test_sharding_block_and_bytes(self):
        mesh = make_production_mesh(multi_pod=True)
        s = Sharding(mesh, P(None, ("pod", "data"), "model"))
        x = z(3, 64, 32, 5, dtype=torch.bfloat16)
        assert s.shard_shape(x.shape) == (3, 2, 2, 5)
        assert s.bytes_per_device(x) == 3 * 2 * 2 * 5 * 2


# ---------------------------------------------------------------------------
# full-width plans: the port's == the reference's, leaf for leaf
# ---------------------------------------------------------------------------

def _ref_mesh(multi_pod):
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else (
        (16, 16), ("data", "model"))
    return types.SimpleNamespace(axis_names=names, devices=np.zeros(shape))


def _ref_leaves(specs):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, JP))]


def _port_leaves(specs):
    return [tuple(s) for s in spec_leaves(specs)]


_REF_TREES = {}


def _ref_trees(arch):
    """The reference's abstract train state and bf16 params (cached: both
    trace the full-width init)."""
    if arch not in _REF_TREES:
        cfg = ref_config(arch)
        _REF_TREES[arch] = (
            ref_train_state_specs(cfg),
            jax.eval_shape(lambda k: RM.init_params(cfg, k, dtype=jnp.bfloat16),
                           jax.random.PRNGKey(0)),
        )
    return _REF_TREES[arch]


def _cells(arch):
    cfg = get_config(arch)
    return [s for s in SHAPES if shape_applicable(cfg, SHAPES[s])]


MESHES = [False, True]


@pytest.mark.parametrize("multi_pod", MESHES, ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, multi_pod):
    """Per applicable shape: the train state's specs (train) and the bf16
    params' specs (prefill / decode), equal to the reference's."""
    ref_state, ref_params = _ref_trees(arch)
    port_state = train_state_specs(get_config(arch))
    port_params = init_params(get_config(arch), None, dtype=torch.bfloat16, device="meta")
    for shape in _cells(arch):
        ref = RS.rules_for_cell(_ref_mesh(multi_pod), ref_config(arch), REF_SHAPES[shape])
        port = rules_for_cell(make_production_mesh(multi_pod=multi_pod), get_config(arch),
                              SHAPES[shape])
        if SHAPES[shape].kind == "train":
            want, got = ref.param_pspecs(ref_state), port.param_pspecs(port_state)
        else:
            want, got = ref.param_pspecs(ref_params), port.param_pspecs(port_params)
        want, got = _ref_leaves(want), _port_leaves(got)
        assert len(got) == len(want) and got == want, (shape, [
            (i, w, g) for i, (w, g) in enumerate(zip(want, got)) if w != g][:4])


@pytest.mark.parametrize("multi_pod", MESHES, ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, multi_pod):
    decode = [s for s in _cells(arch) if SHAPES[s].kind == "decode"]
    assert decode
    for shape in decode:
        rcfg, cfg = ref_config(arch), get_config(arch)
        ref = RS.rules_for_cell(_ref_mesh(multi_pod), rcfg, REF_SHAPES[shape])
        port = rules_for_cell(make_production_mesh(multi_pod=multi_pod), cfg, SHAPES[shape])
        want = _ref_leaves(ref.cache_pspecs(ref_input_specs(rcfg, REF_SHAPES[shape])["cache"],
                                            rcfg))
        got = _port_leaves(port.cache_pspecs(input_specs(cfg, SHAPES[shape])["cache"], cfg))
        assert got == want, shape


def _ref_plan_bytes(arch, shape, multi_pod) -> int:
    """The reference plan's bytes per device of a cell's arguments, as its
    build_cell lays them: sum(nbytes / prod(axis sizes of the leaf's spec))."""
    rcfg, rshape = ref_config(arch), REF_SHAPES[shape]
    mesh = _ref_mesh(multi_pod)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    rules = RS.rules_for_cell(mesh, rcfg, rshape)
    ba = rules.logical["batch"]
    specs = ref_input_specs(rcfg, rshape)
    state, params = _ref_trees(arch)

    def batch_specs(batch):
        return {k: JP(ba, None) if k in ("tokens", "targets") else JP(ba, None, None)
                for k in batch}

    if rshape.kind == "train":
        pairs = [(state, rules.param_pspecs(state)), (specs["batch"], batch_specs(specs["batch"]))]
    elif rshape.kind == "prefill":
        pairs = [(params, rules.param_pspecs(params)),
                 (specs["batch"], batch_specs(specs["batch"]))]
    else:
        pairs = [(params, rules.param_pspecs(params)), (specs["tokens"], JP(ba, None)),
                 (specs["cache"], rules.cache_pspecs(specs["cache"], rcfg))]
    total = 0
    for tree, spec_tree in pairs:
        for leaf, spec in zip(jax.tree_util.tree_leaves(tree), _ref_leaves(spec_tree)):
            n = 1
            for e in spec:
                for a in ((e,) if isinstance(e, str) else (e or ())):
                    n *= sizes[a]
            nbytes = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
            assert nbytes % n == 0
            total += nbytes // n
    return total


@pytest.mark.parametrize("multi_pod", MESHES, ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_per_device_equal_the_reference_plan(arch, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    for shape in _cells(arch):
        _step, args, shardings, _donate, _rules = dryrun.build_cell(
            get_config(arch), SHAPES[shape], mesh)
        assert len(tree_leaves(args)) == len(tree_leaves(shardings))
        assert dryrun.tree_bytes(args, shardings) == _ref_plan_bytes(arch, shape, multi_pod), shape
