"""The port's LM on a ``(2, 2)`` (data, model) mesh of four gloo CPU ranks,
its launchers inside a process group, and the reference's own train step
on four forced host devices.

* ``(2, 2)``, SMOKE ``gemma-2b``: one train step with ``quant="ternary"``
  and ``--compress-grads`` (the ternary STE over sharded weights, the
  compression of reduced gradients), and prefill + greedy decode with
  ``ternary_packed`` weights, held against the port's one-device step at
  the tolerances of `test_torch_spmd_steps.py`.
* ``train_lm.main`` and ``serve_lm`` inside a 2-rank group (the launchers'
  ``(world, 1)`` mesh), with a fault injected after a checkpoint: every rank
  resumes at the same step, the losses and the sampled tokens are the
  one-device run's, and only rank 0 prints.
* The reference's SMOKE ``gemma-2b`` train step jitted on a ``(2, 2)`` mesh
  of 4 forced host devices (a subprocess: XLA's device count is fixed at
  start), its state laid out by its ``param_shardings``; the port's ``(2,
  2)`` gloo step from the same state (`convert.lm_train_state_from_reference`)
  and batch gives its loss (rel 1e-5), grad norm (rel 1e-4), first moment
  and new params (rtol 1e-3, atol 1e-5).  (After AdamW's first step an
  update is about ``lr * sign(g)``, so a gradient of opposite sign in the
  two packages would move a param 2 lr apart; on this state and batch none
  does.)
"""
import contextlib
import io
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_ranks
from test_torch_spmd_steps import OPT, RANKS_TIMEOUT_S, check_serve, check_train, run_world

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# (2, 2): ternary train with compressed gradients, packed-ternary decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_world():
    return run_world((2, 2), ["gemma-2b"], quant="ternary", compress=True,
                     serve_quant="ternary_packed")


def test_ternary_train_step_with_compression_on_2x2_equals_one_device(mesh_world):
    check_train(mesh_world, "gemma-2b")


def test_packed_ternary_prefill_and_decode_on_2x2_equal_one_device(mesh_world):
    check_serve(mesh_world, "gemma-2b")


# ---------------------------------------------------------------------------
# the launchers inside a 2-rank group
# ---------------------------------------------------------------------------

TRAIN_ARGV = ["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--steps", "6",
              "--ckpt-every", "3", "--batch", "4", "--seq", "16"]
SERVE_ARGV = ["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--batch", "2",
              "--prompt-len", "8", "--tokens", "4"]


def _launch(ckpt_dir):
    """train_lm (a fault at step 4, once: a restart from the step-3
    checkpoint) then serve --arch; returns the history, the exit code and
    what was printed."""
    from repro_torch.launch import serve, train_lm

    torch.set_num_threads(1)
    fired = []

    def fault(step):
        if step == 4 and not fired:
            fired.append(step)
            raise RuntimeError("injected fault")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state, hist = train_lm.main([*TRAIN_ARGV, "--ckpt-dir", str(ckpt_dir)],
                                    fault_injector=fault)
        rc = serve.main(SERVE_ARGV)
    kinds = sorted({type(x).__name__ for x in state.params["embed"].values()})
    return {"hist": hist, "rc": rc, "out": out.getvalue(), "kinds": kinds}


def _tokens(out: str) -> str:
    return next(line for line in out.splitlines() if "sample tokens" in line)


def test_launchers_in_a_2_rank_group_resume_and_equal_one_device(tmp_path):
    """Losses within rel 1e-5 of the one-device run at every step, the
    restart at step 3 on both ranks, the sampled tokens equal."""
    ranks = run_ranks(_launch, 2, "cpu", args=(tmp_path / "mesh",), timeout=RANKS_TIMEOUT_S)
    plain = _launch(tmp_path / "plain")
    assert plain["kinds"] == ["Tensor"]
    for r in ranks:
        assert r["kinds"] == ["DTensor"] and r["rc"] == 0
        assert r["hist"]["resumed_from"] == plain["hist"]["resumed_from"] == [3]
        assert r["hist"]["restarts"] == 1
        np.testing.assert_allclose(r["hist"]["losses"], plain["hist"]["losses"],
                                   rtol=1e-5, atol=0)
    assert ranks[0]["hist"]["losses"] == ranks[1]["hist"]["losses"]
    assert "[train]" in ranks[0]["out"] and "[serve]" in ranks[0]["out"]
    assert ranks[1]["out"] == ""
    assert _tokens(ranks[0]["out"]) == _tokens(plain["out"])


# ---------------------------------------------------------------------------
# the reference's step on 4 forced host devices
# ---------------------------------------------------------------------------

_REF_SCRIPT = r"""
import pickle, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import configs as RC
from repro.data.pipeline import LMTokenPipeline
from repro.launch import steps as RS
from repro.launch.sharding import ShardingRules
from repro.optim.adamw import AdamWConfig

opt = pickle.loads(bytes.fromhex(sys.argv[2]))
cfg = RC.get_config("gemma-2b", smoke=True)
# a Mesh of auto axes, as the reference's own dry-run comparison builds it
# (`jax.make_mesh` gives explicit axes, which its gathers refuse)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
rules = ShardingRules(mesh)
state = RS.make_train_state(cfg, jax.random.PRNGKey(7))
batch = LMTokenPipeline(cfg.vocab_size, 16, 4, seed=8).next_batch()
state_np = jax.tree_util.tree_map(np.asarray, state)
with mesh:
    placed = jax.device_put(state, rules.param_shardings(state))
    shards = [len(x.sharding.device_set) for x in jax.tree_util.tree_leaves(placed)]
    b = jax.device_put(batch, NamedSharding(mesh, P("data", None)))
    step = jax.jit(RS.make_train_step(cfg, AdamWConfig(**opt), shard=rules.make_shard_fn()))
    new, m = step(placed, b)
out = {"state": state_np, "batch": {k: np.asarray(v) for k, v in batch.items()},
       "devices": len(jax.devices()), "shards": max(shards),
       "metrics": {k: float(v) for k, v in m.items()},
       "m": [np.asarray(x) for x in jax.tree_util.tree_leaves(new.opt.m)],
       "params": [np.asarray(x) for x in jax.tree_util.tree_leaves(new.params)]}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _port_step(state, batch):
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as TS
    from repro_torch.launch.mesh import world_mesh
    from repro_torch.launch.sharding import ShardingRules, distribute
    from repro_torch.models.spmd import replicate, to_local
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import tree_leaves

    torch.set_num_threads(1)
    cfg = get_config("gemma-2b", smoke=True)
    rules = ShardingRules(world_mesh((2, 2)))
    step = TS.make_train_step(cfg, AdamWConfig(**OPT), shard=rules.make_shard_fn())
    new, m = step(distribute(state, rules.param_shardings(state)), batch)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "m": [to_local(replicate(x)).numpy() for x in tree_leaves(new.opt.m)],
            "params": [to_local(replicate(x)).numpy() for x in tree_leaves(new.params)]}


def test_2x2_train_step_equals_the_references_on_forced_devices(tmp_path):
    from repro_torch import convert

    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}"}
    path = tmp_path / "ref.pkl"
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(path),
                           pickle.dumps(OPT).hex()], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = pickle.loads(path.read_bytes())
    assert ref["devices"] == 4 and ref["shards"] == 4  # laid out over the mesh
    state = convert.lm_train_state_from_reference(ref["state"], device="cpu")
    port = run_ranks(_port_step, 4, "cpu", args=(state, ref["batch"]), timeout=RANKS_TIMEOUT_S)
    for r in port:
        np.testing.assert_allclose(r["metrics"]["loss"], ref["metrics"]["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["metrics"]["grad_norm"], ref["metrics"]["grad_norm"],
                                   rtol=1e-4)
        for key in ("m", "params"):
            assert len(r[key]) == len(ref[key])
            for a, b in zip(r[key], ref[key]):
                np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)
