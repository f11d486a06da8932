"""The captured LM train step on the card: `launch/train_lm.py`'s
`CapturedStep` over ``make_train_step(..., donate=True)`` — one eager
warm-up, one capture, then replays — against the same donating step run
eagerly from the same state, bit for bit, for the ten architectures at their
SMOKE size and ``gemma-2b`` accumulating and compressing; and `train_lm`
on every card of a host with several (one NCCL rank per card, each capturing
its step with the collectives inside) against one card.  ``gpu``-marked:
skips on a host without a CUDA device (the last test without two).  The
CPU's counterpart (and the comparison with the reference) is
`test_torch_capture_lm_train.py`.
"""
import numpy as np
import pytest
import torch

from repro_torch.capture import CapturedStep
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import LMTokenPipeline
from repro_torch.launch import train_lm
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.steps import make_train_state, make_train_step
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import tree_leaves, tree_map

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
CASES = ([(arch, 1, False) for arch in ARCH_IDS]
         + [("gemma-2b", 2, False), ("gemma-2b", 1, True)])


@pytest.mark.gpu
@pytest.mark.parametrize("arch,accum,compress", CASES)
def test_captured_lm_step_equals_eager_step_on_the_card(arch, accum, compress):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured step is a CUDA graph")
    cfg = get_config(arch, smoke=True)
    a = make_train_state(cfg, torch.Generator(device="cuda").manual_seed(0),
                         compress=compress, device="cuda")
    b = tree_map(torch.clone, a)
    kw = dict(compress_grads=compress, accum_steps=accum, donate=True)
    eager = make_train_step(cfg, AdamWConfig(**OPT), **kw)
    step = CapturedStep(make_train_step(cfg, AdamWConfig(**OPT), **kw), "cuda", inputs=(1,))
    pipe = LMTokenPipeline(
        cfg.vocab_size, 16, 4, seed=1,
        frontend_seq=cfg.frontend_seq if cfg.frontend == "vision" else 0,
        d_model=cfg.d_model, enc_seq=cfg.enc_seq_len if cfg.is_encdec else 0)
    ptrs = None
    for i in range(4):
        batch = pipe.next_batch()
        a, ma = eager(a, {k: torch.from_numpy(v).cuda() for k, v in batch.items()})
        b, mb = step(b, batch)
        for key in ma:
            assert torch.equal(ma[key], mb[key]), (i, key)
        if ptrs is None:
            ptrs = [x.data_ptr() for x in tree_leaves(b)]
    assert step.captured and step.builds == 1
    assert [x.data_ptr() for x in tree_leaves(b)] == ptrs
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


TRAIN_ARGV = ["--arch", "gemma-2b", "--smoke", "--steps", "8", "--ckpt-every", "3",
              "--batch", "8", "--seq", "32"]


def _launch(ckpt_dir, device, extra):
    """`train_lm.main` with a fault at step 4, once (a restart from the
    step-3 checkpoint); its history."""
    fired = []

    def fault(step):
        if step == 4 and not fired:
            fired.append(step)
            raise RuntimeError("injected fault")

    return train_lm.main([*TRAIN_ARGV, *extra, "--device", device, "--ckpt-dir", str(ckpt_dir)],
                         fault_injector=fault)[1]


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [[], ["--compress-grads"]], ids=["plain", "compress"])
def test_launcher_on_every_card_captures_and_equals_one_card(tmp_path, extra):
    """One NCCL rank per card, each capturing its step once (restart
    included) with the collectives inside: every rank's losses equal, and
    within rel 1e-5 of one card's (as the CPU's gloo ranks are held)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two or more CUDA devices: one NCCL rank per card")
    ranks = run_ranks(_launch, n, "cuda", args=(tmp_path / "cards", "cuda", extra),
                      timeout=300)
    one = _launch(tmp_path / "one", "cuda:0", extra)
    assert one["step_builds"] == 1 and one["resumed_from"] == [3]
    for hist in ranks:
        assert hist["step_builds"] == 1 and hist["restarts"] == 1
        assert hist["resumed_from"] == [3] and hist["losses"] == ranks[0]["losses"]
        np.testing.assert_allclose(hist["losses"], one["losses"], rtol=1e-5, atol=0)
