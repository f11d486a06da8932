"""`repro_torch.configs` and the LM param/cache trees held against the
reference's on the CPU.

Configs are compared field for field (``dataclasses.asdict``) with their
parameter counts.  At full published width the port's trees are built on
the meta device (no storage) and compared path by path, in the reference's
flatten order, with the reference's ``jax.eval_shape`` of the same
function: shapes and dtypes exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.configs import cutie_nets as RCN
from repro.models import model as RM
from repro.models.config import SHAPES as SHAPES_J
from repro_torch import configs as TC
from repro_torch.configs import cutie_nets as TCN
from repro_torch.models import model as TM
from repro_torch.models.config import SHAPES as SHAPES_T
from repro_torch.tree import tree_leaves

ARCHS = RC.ARCH_IDS


def _np_dtype(dt) -> str:
    return str(jnp.dtype(dt))


def _torch_dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(k.key for k in path), tuple(leaf.shape), _np_dtype(leaf.dtype))
            for path, leaf in flat]


def _torch_paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _torch_paths(tree[k], prefix + (k,))
        return out
    return [(prefix, tuple(tree.shape), _torch_dtype_name(tree.dtype))]


def test_arch_ids_in_reference_order():
    assert TC.ARCH_IDS == RC.ARCH_IDS
    assert len(TC.ARCH_IDS) == 10


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
def test_configs_equal_field_for_field(arch, smoke):
    cj = RC.get_config(arch, smoke=smoke)
    ct = TC.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert ct.n_params() == cj.n_params()
    assert ct.n_active_params() == cj.n_active_params()
    for prop in ("is_moe", "is_ssm", "is_hybrid", "is_encdec", "d_inner", "ssm_heads",
                 "sub_quadratic"):
        assert getattr(ct, prop) == getattr(cj, prop), prop


@pytest.mark.parametrize("quant", ["none", "ternary", "ternary_packed"])
def test_get_config_applies_quant_and_overrides(quant):
    kw = dict(quant=quant, smoke=True, capacity_factor=3.0, dtype="bfloat16")
    for arch in ARCHS:
        assert dataclasses.asdict(TC.get_config(arch, **kw)) == \
            dataclasses.asdict(RC.get_config(arch, **kw))


def test_shapes_cells_and_cutie_configs():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES_T.items()} == \
        {k: dataclasses.asdict(v) for k, v in SHAPES_J.items()}
    cells_t = [(c.name, s.name, ok) for c, s, ok in TC.all_cells()]
    cells_j = [(c.name, s.name, ok) for c, s, ok in RC.all_cells()]
    assert cells_t == cells_j
    assert sorted(TCN.CUTIE_CONFIGS) == sorted(RCN.CUTIE_CONFIGS)
    for name, cfg in TCN.CUTIE_CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(RCN.CUTIE_CONFIGS[name])
        gt, gj = TCN.cutie_graph(name), RCN.cutie_graph(name)
        assert gt.name == gj.name and len(gt.layers) == len(gj.layers)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_tree_matches_reference(arch):
    """Paths, leaf order, shapes and dtypes of the full-width param tree."""
    cfg_j = RC.get_config(arch)
    want = _jax_paths(jax.eval_shape(lambda k: RM.init_params(cfg_j, k),
                                     jax.random.PRNGKey(0)))
    got = _torch_paths(TM.init_params(TC.get_config(arch), device=torch.device("meta")))
    assert got == want
    assert sum(int(np.prod(s)) for _, s, _ in got) > 0


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v2-lite-16b", "mamba2-370m"])
def test_full_width_packed_param_tree_matches_reference(arch):
    """``quant='ternary_packed'``: uint8 packed leaves padded along d_in."""
    cfg_j = RC.get_config(arch, quant="ternary_packed")
    want = _jax_paths(jax.eval_shape(lambda k: RM.init_params(cfg_j, k),
                                     jax.random.PRNGKey(0)))
    got = _torch_paths(TM.init_params(TC.get_config(arch, quant="ternary_packed"),
                                      device=torch.device("meta")))
    assert got == want
    assert any(d == "uint8" for _, _, d in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_cache_spec_matches_reference(arch):
    """The cache tree at full width for a decode_32k-like cell, in both
    cache dtypes the launchers use."""
    for dt_j, dt_t in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        want = _jax_paths(RM.cache_spec(RC.get_config(arch), 4, 4096, dt_j))
        spec = TM.cache_spec(TC.get_config(arch), 4, 4096, dt_t)
        assert all(t.device.type == "meta" for t in tree_leaves(spec))
        assert _torch_paths(spec) == want
