"""The port's LM steps on a real device mesh: DTensors on a gloo process
group of spawned CPU ranks (`repro_torch.launch.mesh.run_ranks`,
`world_mesh`), held against the port's one-device step on the same seeds.

One spawned world per mesh shape runs every check of its arch list and
hands the results back to the parent as numpy (`steps_world`); the tests
read them.  Here the launchers' ``(2, 1)`` (data, model) mesh: the batch
split over two ranks, the plan's FSDP shards of the params, the gradients
all-reduced or reduce-scattered onto them.  `test_torch_spmd_model.py`
holds the ``(1, 2)`` mesh (vocabulary, heads and the cache sequence split),
`test_torch_spmd_mesh.py` the ``(2, 2)`` one, the launchers and the
reference's own step on forced host devices.

Tolerances (each test states its own): the loss within rel 1e-5; params
and AdamW's first moment after one step at rtol 1e-3, atol 1e-5 (the
moment's tolerance of `test_torch_lm_train.py`); prefill and decode logits
within atol 1e-4; greedy tokens equal, and every output the same on every
rank.
"""
import logging

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import LMTokenPipeline
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import run_ranks, world_mesh
from repro_torch.launch.sharding import ShardingRules, distribute
from repro_torch.models.model import init_params
from repro_torch.models.spmd import replicate, to_local
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import tree_leaves

ARCHS = ["gemma-2b", "deepseek-v2-lite-16b", "mamba2-370m", "seamless-m4t-medium"]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
TRAIN_BATCH, TRAIN_SEQ = 4, 16
SERVE_BATCH, PROMPT, TOKENS = 4, 8, 4
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-5
LOGITS_ATOL = 1e-4
RANKS_TIMEOUT_S = 300  # a hung world fails its tests, well inside the suite's limit


def _np(x) -> np.ndarray:
    return to_local(replicate(x)).detach().float().numpy()


def _batch(cfg, seed):
    return LMTokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed,
                           frontend_seq=cfg.frontend_seq if cfg.frontend == "vision" else 0,
                           d_model=cfg.d_model,
                           enc_seq=cfg.enc_seq_len if cfg.is_encdec else 0).next_batch()


def _train(cfg, rules, *, compress=False, accum=1, seed=7):
    """One train step of the plain state and of the same state laid out on
    the mesh (donated, as the launcher steps): loss, grad norm, params and
    the first moment, plain beside mesh."""
    state = TS.make_train_state(cfg, torch.Generator().manual_seed(seed), compress=compress,
                                device="cpu")
    batch = _batch(cfg, seed + 1)
    kw = dict(compress_grads=compress, accum_steps=accum)
    plain, pm = TS.make_train_step(cfg, AdamWConfig(**OPT), **kw)(state, batch)
    dstate = distribute(state, rules.param_shardings(state))
    step = TS.make_train_step(cfg, AdamWConfig(**OPT), shard=rules.make_shard_fn(),
                              donate=True, **kw)
    mesh_state, mm = step(dstate, batch)
    out = {"loss": (float(pm["loss"]), float(mm["loss"])),
           "grad_norm": (float(pm["grad_norm"]), float(mm["grad_norm"])),
           "params": [(to_local(a).numpy(), _np(b)) for a, b in
                      zip(tree_leaves(plain.params), tree_leaves(mesh_state.params))
                      if a.is_floating_point()],
           "m": [(to_local(a).numpy(), _np(b)) for a, b in
                 zip(tree_leaves(plain.opt.m), tree_leaves(mesh_state.opt.m))],
           "metric_types": sorted({type(v).__name__ for v in mm.values()})}
    if compress:
        out["residuals"] = [(a.numpy(), _np(b)) for a, b in
                            zip(tree_leaves(plain.residuals), tree_leaves(mesh_state.residuals))]
    return out


def _serve(cfg, rules, *, seed=3):
    """Prefill then greedy decode, plain and on the mesh (a donated cache,
    laid out by the plan): each step's logits and tokens, plain beside
    mesh."""
    params = init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PROMPT), generator=gen)}
    if cfg.is_encdec:
        batch["enc_embeds"] = torch.randn((SERVE_BATCH, cfg.enc_seq_len, cfg.d_model),
                                          generator=gen)
    shard = rules.make_shard_fn()
    dparams = distribute(params, rules.param_shardings(params))
    runs = {}
    for name, p, kw in (("plain", params, {}),
                        ("mesh", dparams, dict(shard=shard, cache_init=rules.cache_init))):
        prefill = TS.make_prefill_step(cfg, PROMPT + TOKENS, cache_dtype=torch.float32, **kw)
        decode = TS.make_decode_step(cfg, shard=kw.get("shard"), donate=True)
        logits, cache = prefill(p, batch)
        steps = [logits.numpy()]
        tok = torch.argmax(logits, dim=-1)[:, None]
        toks = [tok.numpy()]
        for _ in range(TOKENS - 1):
            logits, cache = decode(p, tok, cache)
            steps.append(logits.numpy())
            tok = torch.argmax(logits, dim=-1)[:, None]
            toks.append(tok.numpy())
        runs[name] = {"logits": steps, "tokens": np.concatenate(toks, axis=1),
                      "plain_out": all(not hasattr(x, "placements") for x in (logits, tok))}
    return runs


def steps_world(shape, archs, cases=("train", "serve"), quant="none", compress=False,
                serve_quant=None, accum_archs=()):
    """Run in each rank of a world of ``prod(shape)`` ranks: every arch of
    ``archs`` (SMOKE) through ``cases`` on a ``shape`` mesh, and a train
    step of two microbatches of each of ``accum_archs``."""
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    rules = ShardingRules(world_mesh(shape))
    out = {}
    for arch in archs:
        r = out[arch] = {}
        if "train" in cases:
            r["train"] = _train(get_config(arch, smoke=True, quant=quant), rules,
                                compress=compress)
        if "serve" in cases:
            r["serve"] = _serve(get_config(arch, smoke=True, quant=serve_quant or quant),
                                rules)
    for arch in accum_archs:
        out.setdefault(arch, {})["train_accum"] = _train(get_config(arch, smoke=True), rules,
                                                         accum=2)
    return out


def run_world(shape, archs, **kw):
    """``steps_world`` on every rank of a fresh gloo world; rank by rank."""
    return run_ranks(steps_world, int(np.prod(shape)), "cpu", args=(shape, archs),
                     kwargs=kw, timeout=RANKS_TIMEOUT_S)


# ---------------------------------------------------------------------------
# checks shared by the mesh shapes
# ---------------------------------------------------------------------------

def check_train(results, arch, key="train"):
    for r in results:
        t = r[arch][key]
        plain, mesh = t["loss"]
        np.testing.assert_allclose(mesh, plain, rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose(t["grad_norm"][1], t["grad_norm"][0], rtol=1e-4)
        assert t["metric_types"] == ["Tensor"]  # plain full scalars
        for a, b in t["params"]:
            np.testing.assert_allclose(b, a, rtol=PARAM_RTOL, atol=PARAM_ATOL)
        for a, b in t["m"]:
            np.testing.assert_allclose(b, a, rtol=PARAM_RTOL, atol=PARAM_ATOL)
        for a, b in t.get("residuals", ()):
            np.testing.assert_allclose(b, a, rtol=PARAM_RTOL, atol=1e-4)
    first = results[0][arch][key]
    for r in results[1:]:
        assert r[arch][key]["loss"] == first["loss"]


def check_serve(results, arch):
    for r in results:
        s = r[arch]["serve"]
        assert s["mesh"]["plain_out"]
        for a, b in zip(s["plain"]["logits"], s["mesh"]["logits"]):
            np.testing.assert_allclose(b, a, rtol=0, atol=LOGITS_ATOL)
        np.testing.assert_array_equal(s["mesh"]["tokens"], s["plain"]["tokens"])
    first = results[0][arch]["serve"]["mesh"]
    for r in results[1:]:
        for a, b in zip(first["logits"], r[arch]["serve"]["mesh"]["logits"]):
            np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------------------
# (2, 1): the launchers' mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_world():
    return run_world((2, 1), ARCHS, accum_archs=("gemma-2b",))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_2x1_equals_one_device(data_world, arch):
    check_train(data_world, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_on_2x1_equal_one_device(data_world, arch):
    check_serve(data_world, arch)


def test_microbatched_train_step_on_2x1_equals_one_device(data_world):
    """``accum_steps=2``: each microbatch cut from the gathered batch and
    split again (`spmd.microbatch`)."""
    check_train(data_world, "gemma-2b", key="train_accum")
