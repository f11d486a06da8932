"""The reference's 21 activation-constraint sites in the port's LM.

The list is read from the reference's source by `ast` (every call
``shard(x, <logical names>)`` in `repro.models`), so a site the port misses
fails here: the port's files hold the same calls with the same logical
names, and SMOKE steps on a (2, 4) mesh backed by a fake process group
reach every one of them.  `_seq_sharded_softmax` is the reference's explicit
formula on plain tensors (within 1e-6 of it), and a forward with an identity shard function equals
the forward without one bit for bit (so every LM parity test keeps its
tolerance)."""
import ast
import collections
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractDevice, Mesh, fake_device_mesh
from repro_torch.launch.sharding import distribute_meta
from repro_torch.models import model as M
from repro_torch.models.attention import _seq_sharded_softmax
from repro_torch.models.config import ShapeConfig

ROOT = Path(__file__).resolve().parents[1] / "src"
FILES = ("model.py", "attention.py", "mlp.py", "mamba2.py", "moe.py")


def _sites(package: str) -> collections.Counter:
    """(file, logical names) of every ``shard(x, ...)`` call in a package's
    model files, counted."""
    out = collections.Counter()
    for name in FILES:
        tree = ast.parse((ROOT / package / "models" / name).read_text())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "shard" and len(node.args) >= 2):
                out[name, tuple(ast.literal_eval(a) for a in node.args[1:])] += 1
    return out


REF_SITES = _sites("repro")


def test_the_reference_has_21_sites():
    assert sum(REF_SITES.values()) == 21
    assert {f: sum(n for (g, _), n in REF_SITES.items() if g == f) for f in FILES} == {
        "model.py": 5, "attention.py": 11, "mlp.py": 1, "mamba2.py": 1, "moe.py": 3}


def test_the_port_has_the_references_sites():
    assert _sites("repro_torch") == REF_SITES


def _mesh(shape):
    n = int(np.prod(shape))
    devices = np.empty(n, dtype=object)
    devices[:] = [AbstractDevice(i) for i in range(n)]
    return Mesh(devices.reshape(shape), ("data", "model"))


# the SMOKE steps that between them run every site
STEPS = [
    ("gemma-2b", ShapeConfig("decode_32k", 16, 2, "decode")),
    ("deepseek-v2-lite-16b", ShapeConfig("prefill_32k", 16, 2, "prefill")),
    ("deepseek-v2-lite-16b", ShapeConfig("decode_32k", 16, 2, "decode")),
    ("mamba2-370m", ShapeConfig("prefill_32k", 16, 2, "prefill")),
]


def test_smoke_steps_on_a_fake_mesh_reach_every_site(monkeypatch):
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    reached = collections.Counter()
    make = dryrun.rules_for_cell

    def recording_rules(*a, **k):
        rules = make(*a, **k)
        inner = rules.make_shard_fn()

        def shard(x, *names):
            caller = Path(sys._getframe(1).f_code.co_filename).name
            reached[caller, names] += 1
            return inner(x, *names)

        rules.make_shard_fn = lambda: shard
        return rules

    monkeypatch.setattr(dryrun, "rules_for_cell", recording_rules)
    mesh = _mesh((2, 4))
    for arch, shape in STEPS:
        cfg = get_config(arch, smoke=True)
        with fake_device_mesh(mesh):
            step, args, shardings, *_ = dryrun.build_cell(cfg, shape, mesh)
            with implicit_replication():
                step(*distribute_meta(args, shardings))
        assert not dist.is_initialized()
    missed = set(REF_SITES) - set(reached)
    assert not missed, f"sites no SMOKE step reached: {sorted(missed)}"


@pytest.mark.parametrize("shape", [(2, 4, 37), (3, 8, 1024), (1, 16, 4096)])
def test_seq_sharded_softmax_matches_the_reference(shape):
    """On plain tensors: bit-equal to the max-subtracted softmax the port's
    MLA decode used before the constraint sites (the same formula), and
    within 1e-6 absolute of the reference's `_seq_sharded_softmax` and of
    `torch.softmax` (float32 rounding of exp and the division)."""
    import jax.numpy as jnp

    from repro.models.attention import _seq_sharded_softmax as ref_softmax

    x_np = np.random.RandomState(0).randn(*shape).astype(np.float32) * 5
    x = torch.from_numpy(x_np)
    got = _seq_sharded_softmax(x, None)
    m = x.amax(dim=-1, keepdim=True)
    e = torch.exp(x - m)
    assert torch.equal(got, e / e.sum(dim=-1, keepdim=True))
    assert torch.equal(_seq_sharded_softmax(x, M._noshard), got)
    want = np.asarray(ref_softmax(jnp.asarray(x_np), None))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    torch.testing.assert_close(got, torch.softmax(x, dim=-1), rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v2-lite-16b", "mamba2-370m",
                                  "jamba-v0.1-52b", "seamless-m4t-medium"])
def test_an_identity_shard_changes_no_forward(arch):
    """Every site applied as the identity: train logits, prefill and decode
    bit-equal to the forward with ``shard=None``."""
    cfg = get_config(arch, smoke=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 8))
                              .astype(np.int64))
    extra = {}
    if cfg.is_encdec:
        extra["enc_embeds"] = torch.from_numpy(
            np.random.RandomState(2).randn(2, cfg.enc_seq_len, cfg.d_model).astype(np.float32))
    calls = []

    def identity(x, *names):
        calls.append(names)
        return x

    for mode in ("train", "prefill"):
        cache = None if mode == "train" else M.init_cache(cfg, 2, 9, torch.float32,
                                                          device="cpu")
        with torch.no_grad():
            a = M.forward(params, cfg, tokens, mode=mode, cache=cache, **extra)
            b = M.forward(params, cfg, tokens, mode=mode, cache=cache, shard=identity,
                          **extra)
        assert torch.equal(a.logits, b.logits)
    assert calls
