"""`repro_torch.ckpt` held against `repro.ckpt` on the CPU: one on-disk
layout, so a checkpoint written by either package restores in the other.

Arrays round-trip through ``.npz`` bit for bit, so every comparison here is
equality.  The leaf order is the reference's `tree_flatten` order (dict keys
sorted, `AdamWState` as (step, m, v)), which is what makes a
``{"params", "opt"}`` train state readable across packages.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.registry import get_net as get_net_j
from repro.ckpt import checkpoint as JC
from repro.train import init_train_state as init_train_state_j
from repro_torch import convert
from repro_torch.api.registry import get_net
from repro_torch.artifact import __main__ as artifact_cli
from repro_torch.artifact import load as load_artifact
from repro_torch.ckpt import (
    committed_steps,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.optim.adamw import AdamWState, adamw_init
from repro_torch.train import init_train_state, train
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _reference_state(learn=True):
    prog = get_net_j("cifar10_tnn_smoke")
    state = init_train_state_j(prog, jax.random.PRNGKey(0), learn_thresholds=learn)
    # give the moments and the step values a zero state would hide
    opt = state["opt"]._replace(
        step=jnp.asarray(7, jnp.int32),
        m=jax.tree_util.tree_map(lambda a: a + 0.25, state["opt"].m),
        v=jax.tree_util.tree_map(lambda a: a + 0.5, state["opt"].v))
    return {"params": state["params"], "opt": opt}


def _port_like(learn=True):
    prog = get_net("cifar10_tnn_smoke")
    return init_train_state(prog, torch.Generator().manual_seed(9),
                            learn_thresholds=learn, device="cpu")


def test_leaf_order_is_the_reference_flatten_order():
    """The port's flatten of a train state lists the same leaves, in the
    same order and shapes, as `jax.tree_util.tree_leaves` — `opt` (step,
    m, v) before `params`, dict keys sorted."""
    ref = _reference_state()
    port = convert.train_state_from_reference(jax.tree_util.tree_map(np.asarray, ref),
                                              device="cpu")
    got, want = tree_leaves(port), jax.tree_util.tree_leaves(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert isinstance(port["opt"], AdamWState)
    rebuilt = tree_unflatten(port, got)
    assert list(rebuilt) == ["opt", "params"] and isinstance(rebuilt["opt"], AdamWState)
    with pytest.raises(ValueError):
        tree_unflatten(port, got[:-1])


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A train state saved by `repro.ckpt` restores in the port with equal
    arrays, the int32 step, and the pipeline cursor kept."""
    ref = _reference_state()
    JC.save_checkpoint(tmp_path, 12, ref, pipeline_cursor={"seed": 3, "step": 12})
    like = _port_like()
    got, meta = restore_checkpoint(tmp_path, like)
    assert meta["pipeline_cursor"] == {"seed": 3, "step": 12} and meta["step"] == 12
    assert got["opt"].step.dtype == torch.int32 and got["opt"].step.ndim == 0
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """A train state saved by the port restores in `repro.ckpt` with equal
    arrays and the cursor kept."""
    port = convert.train_state_from_reference(
        jax.tree_util.tree_map(np.asarray, _reference_state()), device="cpu")
    save_checkpoint(tmp_path, 5, port, pipeline_cursor={"seed": 0, "step": 5})
    like = init_train_state_j(get_net_j("cifar10_tnn_smoke"), jax.random.PRNGKey(1),
                              learn_thresholds=True)
    got, meta = JC.restore_checkpoint(tmp_path, like)
    assert meta["pipeline_cursor"]["step"] == 5
    assert got["opt"].step.dtype == jnp.int32 and int(got["opt"].step) == 7
    for g, w in zip(jax.tree_util.tree_leaves(got), tree_leaves(port)):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())


def test_bf16_leaf_round_trips_across_packages(tmp_path):
    """bfloat16 leaves are stored as their uint16 bits under the dtype name
    ``bfloat16``, in both directions."""
    rng = np.random.RandomState(0)
    w = rng.randn(4, 3).astype(np.float32)
    port = {"u": torch.arange(6, dtype=torch.uint8), "w": torch.from_numpy(w).bfloat16()}
    save_checkpoint(tmp_path / "p", 1, port)
    meta = json.loads((tmp_path / "p" / "step_000000001" / "meta.json").read_text())
    assert meta["dtypes"] == {"leaf_00000": "uint8", "leaf_00001": "bfloat16"}
    got_j, _ = JC.restore_checkpoint(
        tmp_path / "p", {"u": jnp.zeros(6, jnp.uint8), "w": jnp.zeros((4, 3), jnp.bfloat16)})
    assert got_j["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got_j["w"]).view(np.uint16),
                                  port["w"].view(torch.int16).numpy().view(np.uint16))
    JC.save_checkpoint(tmp_path / "j", 1, got_j)
    got, _ = restore_checkpoint(tmp_path / "j", port)
    assert got["w"].dtype == torch.bfloat16 and got["u"].dtype == torch.uint8
    assert torch.equal(got["w"], port["w"]) and torch.equal(got["u"], port["u"])


def test_uncommitted_dir_is_ignored_and_collected(tmp_path):
    state = {"w": torch.ones(3)}
    save_checkpoint(tmp_path, 1, state)
    crash = tmp_path / "step_000000099"
    crash.mkdir()
    (crash / "meta.json").write_text("{}")
    assert latest_step(tmp_path) == 1
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path, state, step=99)
    save_checkpoint(tmp_path, 2, state)
    assert not crash.exists()


def test_keep_gc_and_latest(tmp_path):
    state = {"w": torch.ones(3)}
    for step in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, step, state, keep=3)
    assert latest_step(tmp_path) == 5 and committed_steps(tmp_path) == [3, 4, 5]
    assert (tmp_path / "latest").read_text() == "5"


def test_restore_checks_leaf_count_and_shapes(tmp_path):
    save_checkpoint(tmp_path, 1, {"a": torch.zeros(2, 3), "b": torch.zeros(4)})
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(tmp_path, {"a": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, {"a": torch.zeros(3, 2), "b": torch.zeros(4)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "empty", {"a": torch.zeros(1)})


def test_restore_places_leaves_on_the_target_dtype_and_device(tmp_path):
    params = get_net("cifar10_tnn_smoke").init(torch.Generator().manual_seed(0), device="cpu")
    state = {"params": params, "opt": adamw_init(params)}
    save_checkpoint(tmp_path, 3, state)
    like = tree_map(lambda t: torch.zeros_like(t, dtype=torch.float64), state)
    got, _ = restore_checkpoint(tmp_path, like)
    for g, w in zip(tree_leaves(got), tree_leaves(state)):
        assert g.dtype == torch.float64 and g.device == w.device
        assert torch.equal(g, w.to(torch.float64))


def test_trained_checkpoint_builds_an_artifact_equal_to_the_trained_program(tmp_path):
    """``python -m repro_torch.artifact build --ckpt DIR`` packs the params
    of a `train()` checkpoint: calibrated on the per-OCU QAT grid and the
    batch `train()` calibrated on, the loaded `.cutie` gives the trained
    `DeployedProgram`'s ``ref`` logits exactly."""
    net, batch = "cifar10_tnn_smoke", 8
    report = train(net, steps=4, batch=batch, lr=3e-3, seed=0, ckpt_dir=tmp_path / "ck",
                   ckpt_every=4, eval_batches=1, thresholds="learned", device="cpu",
                   log=lambda *_: None)
    out = tmp_path / "net.cutie"
    rc = artifact_cli.main(["build", net, "-o", str(out), "--ckpt", str(tmp_path / "ck"),
                            "--calib-batch", str(batch), "--per-channel", "--seed", "0",
                            "--device", "cpu"])
    assert rc == 0
    loaded = load_artifact(str(out), device="cpu")
    x = torch.from_numpy(np.sign(np.random.RandomState(1).randn(3, 16, 16, 3)).astype(np.float32))
    assert torch.equal(loaded.forward(x, backend="ref"), report.deployed.forward(x, backend="ref"))
    params, _ = artifact_cli.restore_params(tmp_path / "ck", get_net(net), "cpu")
    for g, w in zip(tree_leaves(params), tree_leaves(report.params)):
        assert torch.equal(g, w)


def test_artifact_ckpt_reads_a_reference_params_checkpoint(tmp_path):
    """A params-only checkpoint written by `repro.ckpt` (what the
    reference's artifact CLI restores) also restores through the port's."""
    params_j = get_net_j("cifar10_tnn_smoke").init(jax.random.PRNGKey(5))
    JC.save_checkpoint(tmp_path, 1, params_j)
    params, meta = artifact_cli.restore_params(tmp_path, get_net("cifar10_tnn_smoke"), "cpu")
    assert meta["step"] == 1 and "thresh" not in params
    for g, w in zip(tree_leaves(params), jax.tree_util.tree_leaves(params_j)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
