"""The LM decode step as the port captures it, on the CPU:
`make_decode_step(..., donate=True)` (the counterpart of the reference's
``jax.jit(decode, donate_argnums=(2,))``) for the ten architectures at their
SMOKE size, and `serve_lm`, which runs it through a
`repro_torch.capture.CapturedStep`.

Params and stub frontend/encoder inputs are the reference's, handed across
as numpy; tokens come from numpy with a seed.  Within the port everything is
compared bit for bit; against the reference at `test_torch_lm_model.py`'s
whole-model tolerance, 1e-3 (exact for the cache's integer ``len``).  The
``gpu``-marked test at the end repeats captured == eager on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as RC
from repro.launch import steps as RS
from repro.models import model as RM
from repro_torch import configs as TC
from repro_torch.capture import CapturedStep
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import steps as TS
from repro_torch.models.model import init_params
from repro_torch.tree import tree_leaves, tree_map

ARCHS = RC.ARCH_IDS
B, S, TOKENS = 2, 7, 4
TOL_MODEL = 1e-3


class Setup:
    """One architecture's reference params, prompts and decode tokens."""

    def __init__(self, arch):
        self.cfg_j = RC.get_config(arch, smoke=True)
        self.cfg = TC.get_config(arch, smoke=True)
        self.params_j = RM.init_params(self.cfg_j, jax.random.PRNGKey(sum(map(ord, arch))))
        self.params = lm_params_from_reference(
            jax.tree_util.tree_map(np.asarray, self.params_j), device="cpu")
        r = np.random.default_rng(len(arch) + 1)
        self.prompt = r.integers(0, self.cfg.vocab_size, (B, S)).astype(np.int32)
        self.tokens = r.integers(0, self.cfg.vocab_size, (TOKENS, B, 1)).astype(np.int32)
        self.extras = {}
        if self.cfg.frontend == "vision":
            self.extras["frontend_embeds"] = r.standard_normal(
                (B, self.cfg.frontend_seq, self.cfg.d_model)).astype(np.float32)
        if self.cfg.is_encdec:
            self.extras["enc_embeds"] = r.standard_normal(
                (B, self.cfg.enc_seq_len, self.cfg.d_model)).astype(np.float32)

    def prefill(self):
        batch = {"tokens": torch.from_numpy(self.prompt).long(),
                 **{k: torch.from_numpy(v) for k, v in self.extras.items()}}
        return TS.make_prefill_step(self.cfg, S + TOKENS, cache_dtype=torch.float32)(
            self.params, batch)[1]

    def token(self, i):
        return torch.from_numpy(self.tokens[i]).long()


@pytest.fixture(scope="module")
def setups():
    return {}


def _setup(setups, arch):
    if arch not in setups:
        setups[arch] = Setup(arch)
    return setups[arch]


class HostSyncs(TorchDispatchMode):
    """Records every op that reads a tensor on the host
    (``aten._local_scalar_dense``) or makes one from Python data
    (``aten.lift_fresh``: a host-to-device copy on the card)."""

    BAD = ("_local_scalar_dense", "lift_fresh")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0].startswith(self.BAD):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_donated_decode_equals_undonated_bit_for_bit(setups, arch):
    """Four tokens: logits and every cache leaf; the undonated step leaves
    the cache it was given as it was."""
    su = _setup(setups, arch)
    plain = TS.make_decode_step(su.cfg)
    donated = TS.make_decode_step(su.cfg, donate=True)
    a = su.prefill()
    b = tree_map(torch.clone, a)
    for i in range(TOKENS):
        before = [x.clone() for x in tree_leaves(a)]
        la, a_new = plain(su.params, su.token(i), a)
        assert all(torch.equal(x, y) for x, y in zip(before, tree_leaves(a)))
        a = a_new
        lb, b = donated(su.params, su.token(i), b)
        assert torch.equal(la, lb), i
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y), i
    assert int(b["len"]) == S + TOKENS + (su.cfg.frontend_seq if su.cfg.frontend == "vision"
                                          else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_donated_decode_keeps_every_cache_address(setups, arch):
    """The capture's precondition: the returned cache is the given one and
    no leaf, ``len`` included, moves."""
    su = _setup(setups, arch)
    donated = TS.make_decode_step(su.cfg, donate=True)
    cache = su.prefill()
    leaves = tree_leaves(cache)
    ptrs = [x.data_ptr() for x in leaves]
    for i in range(TOKENS):
        out, new = donated(su.params, su.token(i), cache)
        assert new is cache
        assert all(x is y for x, y in zip(tree_leaves(new), leaves))
        assert [x.data_ptr() for x in tree_leaves(new)] == ptrs
        assert out.data_ptr() not in ptrs


@pytest.mark.parametrize("arch", ARCHS)
def test_donated_decode_matches_reference_jitted_donated_decode(setups, arch):
    """The port's donated decode against ``jax.jit(decode,
    donate_argnums=(2,))`` from the reference's params, after each
    package's own prefill: logits and caches within 1e-3, ``len`` exact."""
    su = _setup(setups, arch)
    batch_j = {"tokens": jnp.asarray(su.prompt),
               **{k: jnp.asarray(v) for k, v in su.extras.items()}}
    _, cj = jax.jit(RS.make_prefill_step(su.cfg_j, S + TOKENS, cache_dtype=jnp.float32))(
        su.params_j, batch_j)
    dec_j = jax.jit(RS.make_decode_step(su.cfg_j), donate_argnums=(2,))
    dec_t = TS.make_decode_step(su.cfg, donate=True)
    ct = su.prefill()
    for i in range(TOKENS):
        lj, cj = dec_j(su.params_j, jnp.asarray(su.tokens[i]), cj)
        lt, ct = dec_t(su.params, su.token(i), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL_MODEL, atol=TOL_MODEL)
    for a, b in zip(tree_leaves(ct), jax.tree_util.tree_leaves(cj)):
        if a.dtype == torch.int32:
            assert int(a) == int(b)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32), rtol=TOL_MODEL,
                                       atol=TOL_MODEL)


@pytest.mark.parametrize("arch", ARCHS)
def test_warm_donated_decode_makes_no_host_sync(setups, arch):
    """The second call of the donated decode (the one the card captures,
    after an eager warm-up) reads nothing on the host and makes no tensor
    from Python data."""
    su = _setup(setups, arch)
    donated = TS.make_decode_step(su.cfg, donate=True)
    cache = su.prefill()
    donated(su.params, su.token(0), cache)
    tok = su.token(1)
    with HostSyncs() as mode:
        donated(su.params, tok, cache)
    assert mode.seen == []


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-370m", "seamless-m4t-medium"])
def test_captured_decode_on_the_cpu_equals_the_plain_loop(setups, arch):
    """`serve_lm`'s wrapping — the donated step in a `CapturedStep` whose
    token column is a static input — gives the plain loop's logits, and a
    second prefill handed to it is copied into its cache."""
    su = _setup(setups, arch)
    plain = TS.make_decode_step(su.cfg)
    step = CapturedStep(TS.make_decode_step(su.cfg, donate=True), "cpu", inputs=(1,))
    for _ in range(2):
        a, b = su.prefill(), su.prefill()
        for i in range(TOKENS):
            tok = su.token(i)
            la, a = plain(su.params, tok, a)
            lb, b = step(su.params, tok, b)
            assert torch.equal(la, lb)
    assert step.builds == 1


@pytest.mark.parametrize("argv", [["--arch", "gemma-2b"], ["--arch", "mamba2-370m"],
                                  ["--arch", "gemma-2b", "--quant", "ternary_packed"]],
                         ids=["gemma", "mamba2", "gemma_packed"])
def test_serve_cli_tokens_equal_the_undonated_loop(argv, capsys):
    """``serve --arch ... --smoke --device cpu`` (the captured, donated
    decode) prints the tokens the plain prefill + undonated decode loop
    samples from the same seed."""
    assert launch_serve.main([*argv, "--smoke", "--device", "cpu", "--batch", "2",
                              "--prompt-len", "6", "--tokens", "5"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if "sample tokens" in ln][0]
    quant = argv[argv.index("--quant") + 1] if "--quant" in argv else "none"
    cfg = TC.get_config(argv[1], quant=quant, smoke=True)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, dtype=torch.float32, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 6), generator=gen)
    logits, cache = TS.make_prefill_step(cfg, 11, cache_dtype=torch.float32)(
        params, {"tokens": prompts})
    decode = TS.make_decode_step(cfg)
    tok = torch.argmax(logits, dim=-1)[:, None]
    seq = [tok]
    for _ in range(4):
        logits, cache = decode(params, tok, cache)
        tok = torch.argmax(logits, dim=-1)[:, None]
        seq.append(tok)
    assert line == f"[serve] sample tokens: {torch.cat(seq, dim=1).numpy()[0, :8]}"


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-370m", "deepseek-v2-lite-16b"])
def test_captured_decode_equals_eager_decode_on_the_card(setups, arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured step is a CUDA graph")
    su = _setup(setups, arch)
    params = tree_map(lambda x: x.cuda(), su.params)
    cache = tree_map(lambda x: x.cuda(), su.prefill())
    plain = TS.make_decode_step(su.cfg)
    step = CapturedStep(TS.make_decode_step(su.cfg, donate=True), "cuda", inputs=(1,))
    a, b = cache, tree_map(torch.clone, cache)
    for i in range(TOKENS):
        tok = su.token(i).cuda()
        la, a = plain(params, tok, a)
        lb, b = step(params, tok, b)
        assert torch.equal(la, lb)
    assert step.captured and step.builds == 1
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
