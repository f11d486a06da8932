"""The port's LM steps on a ``(1, 2)`` (data, model) mesh of two gloo CPU
ranks: the model axis splits the vocabulary (the embedding's masked lookup,
the vocab-parallel cross-entropy), the attention heads, the MLP and the
experts' d_ff, the SSM heads and the decode cache's sequence — held against
the port's one-device step on the same seeds, at the tolerances of
`test_torch_spmd_steps.py` (the loss rel 1e-5; params and first moments
rtol 1e-3, atol 1e-5; logits atol 1e-4; greedy tokens equal)."""
import numpy as np
import pytest

from test_torch_spmd_steps import ARCHS, RANKS_TIMEOUT_S, check_serve, check_train, run_world


@pytest.fixture(scope="module")
def model_world():
    return run_world((1, 2), ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_1x2_equals_one_device(model_world, arch):
    check_train(model_world, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_on_1x2_equal_one_device(model_world, arch):
    check_serve(model_world, arch)


# ---------------------------------------------------------------------------
# The faults of the per-device blocks, one check each, in one 2-rank world
# ---------------------------------------------------------------------------

def _dt(x, mesh, placements):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, mesh.device_mesh, placements)


def faults_world():
    """Each block against its plain counterpart on the same inputs, on the
    ``(1, 2)`` mesh (or ``(2, 1)`` for the batch): a dict of (mesh result
    as numpy, plain result as numpy) pairs, or this rank's rows.  A check
    that raises leaves its traceback instead, and the others still run."""
    import traceback

    import torch
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs import get_config
    from repro_torch.launch import steps as TS
    from repro_torch.launch.mesh import world_mesh
    from repro_torch.launch.sharding import ShardingRules, distribute
    from repro_torch.models import attention, layers, spmd
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_leaves

    torch.set_num_threads(1)
    model, data = world_mesh((1, 2)), world_mesh((2, 1))
    g = torch.Generator().manual_seed(0)
    rep, col, row = (Replicate(), Replicate()), (Replicate(), Shard(1)), (Replicate(), Shard(0))
    out = {}

    def pair(mesh_out, plain_out):
        return (spmd.to_local(spmd.replicate(mesh_out)).detach().numpy(),
                plain_out.detach().numpy())

    def embed():
        # every id, on either rank's vocabulary rows
        table = torch.randn(16, 8, generator=g)
        ids = torch.arange(16).reshape(2, 8)
        with spmd.replicated_context():
            got = layers.embed_lookup({"table": _dt(table, model, row)}, _dt(ids, model, rep))
        out["embed"] = pair(got, F.embedding(ids, table))

    def batch_rows():
        # this rank's rows of a [4, 3] table over a batch-split x
        t = torch.arange(12).reshape(4, 3)
        x = _dt(torch.zeros(4, 5), data, (Shard(0), Replicate()))
        out["batch_rows"] = spmd.batch_like(t, x).to_local().numpy()

    def ste():
        # a column-parallel ternary weight: the whole weight's threshold and
        # scale, and its gradient
        w = torch.randn(8, 12, generator=g)
        xin = torch.randn(3, 8, generator=g)
        dw = _dt(w, model, col).requires_grad_()
        with spmd.replicated_context():
            y = layers.linear({"w": dw}, _dt(xin, model, rep), quant="ternary")
            y.sum().backward()
        wp = w.clone().requires_grad_()
        yp = layers.linear({"w": wp}, xin, quant="ternary")
        yp.sum().backward()
        out["ste"] = pair(y, yp)
        out["ste_grad"] = pair(dw.grad, wp.grad)

    def row_bias():
        # a row-parallel bias: added once to the partial sums
        w2, b2 = torch.randn(12, 8, generator=g), torch.randn(8, generator=g)
        x2 = torch.randn(3, 12, generator=g)
        with spmd.replicated_context():
            y = layers.linear({"w": _dt(w2, model, row), "b": _dt(b2, model, rep)},
                              _dt(x2, model, col))
        out["row_bias"] = pair(y, x2 @ w2 + b2)

    def packed_rows():
        # a packed row-parallel weight whose rows carry padding (d_in 14 -> 16)
        wpk = layers.linear_from_weight(torch.randn(14, 8, generator=g), quant="ternary_packed")
        x3 = torch.randn(3, 14, generator=g)
        with spmd.replicated_context():
            y = layers.linear({"packed": _dt(wpk["packed"], model, row),
                               "scale": _dt(wpk["scale"], model, rep)},
                              _dt(x3, model, col), quant="ternary_packed")
        out["packed_rows"] = pair(y, layers.linear(wpk, x3, quant="ternary_packed"))

    def cache_write():
        # a sequence-sharded cache written at a position of the second block
        cache = torch.randn(2, 8, 2, 4, generator=g)
        new = torch.randn(2, 1, 2, 4, generator=g)
        idx = torch.tensor(6)
        dc = _dt(cache.clone(), model, (Replicate(), Shard(1)))
        with spmd.replicated_context():
            attention._cache_write_(dc, _dt(new, model, rep), _dt(idx, model, rep))
        plain = cache.clone()
        attention._cache_write_(plain, new, idx)
        out["cache_write"] = pair(dc, plain)

    def cache_fill():
        # a sequence-sharded cache filled by a prefill shorter than it
        kv = torch.randn(2, 5, 2, 4, generator=g)
        with spmd.replicated_context():
            filled = attention._cache_fill(_dt(torch.zeros(2, 8, 2, 4), model,
                                               (Replicate(), Shard(1))), _dt(kv, model, rep))
        out["cache_fill"] = pair(filled, attention._cache_fill(torch.zeros(2, 8, 2, 4), kv))

    def flash():
        # the flash forward and its backward on heads split over the model
        # axis (chunks of 8 over 32 positions: the online softmax's loop)
        q0 = torch.randn(2, 32, 4, 8, generator=g)
        k0, v0 = torch.randn(2, 32, 2, 8, generator=g), torch.randn(2, 32, 2, 8, generator=g)
        heads = (Replicate(), Shard(2))
        dq, dk, dv = (_dt(t, model, heads).requires_grad_() for t in (q0, k0, v0))
        with spmd.replicated_context():
            o = attention._grouped_flash(dq, dk, dv, 0.35, 8, 8, causal=True)
            (o * o).sum().backward()
        pq, pk, pv = (t.clone().requires_grad_() for t in (q0, k0, v0))
        po = attention._grouped_flash(pq, pk, pv, 0.35, 8, 8, causal=True)
        (po * po).sum().backward()
        out["flash"] = pair(o, po)
        out["flash_grads"] = [pair(a.grad, b.grad) for a, b in ((dq, pq), (dk, pk), (dv, pv))]

    def grads():
        # a replicated param's gradient (a partial sum over the batch
        # shards) comes back laid out as its param, all-reduced
        cfg = get_config("gemma-2b", smoke=True)
        params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
        rules = ShardingRules(data)
        tokens = torch.randint(0, cfg.vocab_size, (4, 8), generator=g)
        batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
        dp = distribute(params, rules.param_shardings(params))
        shard = rules.make_shard_fn()
        (_, _), got = TS.value_and_grad(cfg, dp, TS.place_batch(batch, data.device_mesh, shard),
                                        shard=shard)
        (_, _), want = TS.value_and_grad(cfg, params, batch)
        out["grad_placements"] = [
            (str(gr.placements), str(p.placements))
            for gr, p in zip(tree_leaves(got), tree_leaves(dp)) if isinstance(gr, DTensor)]
        out["grads"] = [pair(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want))]

    for check in (embed, batch_rows, ste, row_bias, packed_rows, cache_write, cache_fill,
                  flash, grads):
        try:
            check()
        except Exception:  # the test that reads the check reports it
            out[f"error {check.__name__}"] = traceback.format_exc()
    return out


def _result(r, check):
    assert f"error {check}" not in r, r[f"error {check}"]
    return r[check]


@pytest.fixture(scope="module")
def faults():
    from repro_torch.launch.mesh import run_ranks

    return run_ranks(faults_world, 2, "cpu", timeout=RANKS_TIMEOUT_S)


@pytest.mark.parametrize("check", ["embed", "ste", "ste_grad", "row_bias", "packed_rows",
                                   "cache_write", "cache_fill"])
def test_block_on_a_model_shard_equals_plain(faults, check):
    """On each rank, tolerance 1e-6 (float32 sums in another order)."""
    name = "ste" if check == "ste_grad" else check
    for r in faults:
        assert f"error {name}" not in r, r[f"error {name}"]
        got, want = r[check]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_flash_forward_and_backward_on_split_heads_equal_plain(faults):
    """Tolerance 1e-5 (float32 online softmax, the same chunks)."""
    for r in faults:
        got, want = _result(r, "flash")
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        for got, want in r["flash_grads"]:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_batch_like_keeps_each_ranks_own_rows(faults):
    rows = np.arange(12).reshape(4, 3)
    np.testing.assert_array_equal(_result(faults[0], "batch_rows"), rows[:2])
    np.testing.assert_array_equal(_result(faults[1], "batch_rows"), rows[2:])


def test_partial_gradient_is_reduced_onto_its_param(faults):
    """Every gradient placed as its param (none left a partial sum), and
    equal to the one-device gradient (rtol 1e-4, atol 1e-6)."""
    for r in faults:
        _result(r, "grads")
        assert r["grad_placements"] and all(g == p for g, p in r["grad_placements"])
        for got, want in r["grads"]:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
