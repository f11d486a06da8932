"""The dry-run per device on meta DTensors (`repro_torch.launch.dryrun`) on
the CPU, on planned meshes backed by a fake process group.

Closed forms (exact, tolerance 0: byte counts of meta tensors): a column-
then row-parallel MLP on a (2, 4) mesh all-reduces its [B/2, S, D] output
once in the forward, and its backward adds the input gradient's all-reduce;
`_seq_sharded_softmax` over a cache_seq-sharded decode all-reduces [B, H, 1]
twice and gathers no scores.  Per SMOKE step kind: the per-device FLOPs on a
(1, 1) mesh equal the plain meta count, the argument bytes equal the plan's,
temp bytes on a (1, 4) model mesh are at most those on (1, 1), which equal
the plain step's; no process group outlives a cell.  A move between two
sharded dims is one all-to-all of the local block; the vocabulary-parallel
CE all-reduces its max, sum and target logit per chunk and its two sums
once; the MoE aux all-reduces its two [E] means.  Against the reference's
gemma-2b SMOKE cells compiled under GSPMD on forced (1, 1), (1, 4) and
(2, 4) meshes in a subprocess (`scripts/dryrun_torch_vs_reference.py`):
argument bytes equal; FLOPs equal or off by a stated closed form; temp
bytes' model split and collective bytes within bands that a port with no
model split fails."""
import dataclasses
import importlib.util
import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractDevice, Mesh, fake_device_mesh, make_local_mesh
from repro_torch.launch.sharding import ShardingRules, distribute_meta
from repro_torch.models.attention import _seq_sharded_softmax
from repro_torch.models.config import ShapeConfig
from repro_torch.models.mlp import mlp_forward

ROOT = Path(__file__).resolve().parents[1]
SMOKE_SHAPES = {
    "train": ShapeConfig("train_4k", 16, 4, "train"),
    "prefill": ShapeConfig("prefill_32k", 16, 2, "prefill"),
    "decode": ShapeConfig("decode_32k", 16, 2, "decode"),
}
logging.getLogger("torch.distributed").setLevel(logging.ERROR)


def _mesh(shape, axes=("data", "model")):
    n = int(np.prod(shape))
    devices = np.empty(n, dtype=object)
    devices[:] = [AbstractDevice(i) for i in range(n)]
    return Mesh(devices.reshape(shape), axes)


def _dt(mesh, shape, placements, dtype=torch.float32, grad=False):
    """A meta DTensor of global ``shape`` laid out by ``placements``."""
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.devices.shape[i]
    x = DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"), mesh.device_mesh,
                           placements, run_check=False, shape=torch.Size(shape),
                           stride=torch.empty(shape, device="meta").stride())
    return x.requires_grad_() if grad else x


B, S, D, F = 8, 16, 32, 64


def _mlp(mesh, grad=False):
    """A GELU MLP: w_up column-parallel, w_down row-parallel over "model"."""
    cfg = dataclasses.replace(get_config("gemma-2b", smoke=True), d_model=D, d_ff=F,
                              mlp_type="gelu")
    p = {"w_up": {"w": _dt(mesh, (D, F), (Replicate(), Shard(1)), grad=grad)},
         "w_down": {"w": _dt(mesh, (F, D), (Replicate(), Shard(0)), grad=grad)}}
    x = _dt(mesh, (B, S, D), (Shard(0), Replicate()), grad=grad)
    return cfg, p, x


def test_column_then_row_parallel_mlp_all_reduces_its_output_once():
    mesh = _mesh((2, 4))
    with fake_device_mesh(mesh):
        cfg, p, x = _mlp(mesh)
        with implicit_replication(), dryrun.DeviceBook() as book:
            y = mlp_forward(p, cfg, x)
            assert y.placements == (Shard(0), Partial())
            y.redistribute(mesh.device_mesh, (Shard(0), Replicate()))
    assert book.calls == [("all-reduce", B // 2 * S * D * 4)]
    assert not dist.is_initialized()


def test_the_train_step_adds_the_input_gradient_all_reduce():
    mesh = _mesh((2, 4))
    with fake_device_mesh(mesh):
        cfg, p, x = _mlp(mesh, grad=True)
        with implicit_replication(), dryrun.DeviceBook() as book:
            y = mlp_forward(p, cfg, x).redistribute(mesh.device_mesh, (Shard(0), Replicate()))
            (gx,) = torch.autograd.grad(y, [x], grad_outputs=torch.ones_like(y))
            # each model shard's partial input gradient, summed where it lands
            assert gx.placements == (Shard(0), Partial())
            gx.redistribute(mesh.device_mesh, x.placements)
    big = [c for c in book.calls if c[1] == B // 2 * S * D * 4]
    assert big == [("all-reduce", B // 2 * S * D * 4)] * 2, book.calls


def test_seq_sharded_softmax_all_reduces_max_and_sum_not_the_scores():
    b, h, s = 4, 8, 64
    mesh = _mesh((1, 4))
    with fake_device_mesh(mesh):
        shard = ShardingRules(mesh).make_shard_fn()
        scores = _dt(mesh, (b, h, s), (Replicate(), Shard(2)))
        with implicit_replication(), dryrun.DeviceBook() as book:
            p = _seq_sharded_softmax(scores, shard)
        assert p.placements == (Replicate(), Shard(2))
    assert book.calls == [("all-reduce", b * h * 1 * 4)] * 2
    assert book.counts["all-gather"] == 0


def test_a_move_between_sharded_dims_is_one_all_to_all():
    """Shard(1) -> Shard(0) over the model axis: one all-to-all of the
    local block, where DTensor on a CPU mesh would all-gather and cut."""
    mesh = _mesh((2, 4))
    with fake_device_mesh(mesh):
        x = _dt(mesh, (B, S), (Shard(0), Shard(1)))
        with implicit_replication(), dryrun.DeviceBook() as book:
            y = x.redistribute(mesh.device_mesh, (Shard(0), Shard(0)))
        assert y._local_tensor.shape == (B // 8, S)
    assert book.calls == [("all-to-all", B // 2 * S // 4 * 4)]


def test_vocab_parallel_ce_all_reduces_per_chunk():
    """[B, S, D] hidden on the data axis against a [D, V] head sharded D
    over data (FSDP) and V over model, in chunks of c: the head gathered
    over data once; per chunk the max, the sum of exponentials and the
    target's logit, each [B/2, c], all-reduced over model; then the count
    all-reduced over data where the mean divides by it.  The backward
    recomputes the chunks (three all-reduces each) and reduce-scatters the
    head's gradient."""
    from repro_torch.models.model import chunked_ce_loss

    v, c = 64, 8
    mesh = _mesh((2, 4))
    with fake_device_mesh(mesh):
        h = _dt(mesh, (B, S, D), (Shard(0), Replicate()), grad=True)
        t = _dt(mesh, (B, S), (Shard(0), Replicate()), dtype=torch.int64)
        w = _dt(mesh, (D, v), (Shard(0), Shard(1)), grad=True)
        with implicit_replication(), dryrun.DeviceBook() as fwd:
            loss, _ = chunked_ce_loss(h, t, w, chunk=c)
        assert loss.placements == (Partial(), Replicate())
        with implicit_replication(), dryrun.DeviceBook() as bwd:
            torch.autograd.grad(loss, [h, w])
    row = B // 2 * c * 4
    assert fwd.calls == ([("all-gather", D * v // 4 * 4)] + [("all-reduce", row)] * 3 * (S // c)
                         + [("all-reduce", 4)])
    assert bwd.calls == ([("all-reduce", row)] * 3 * (S // c)
                         + [("reduce-scatter", D // 2 * v // 4 * 4)])


def test_moe_aux_all_reduces_its_two_means():
    """The Switch aux loss of a MoE layer on a (2, 4) mesh: each device's
    [E] mean router probability and routed fraction, all-reduced over the
    data axis once each."""
    from repro_torch.launch.sharding import P, Sharding
    from repro_torch.models.moe import moe_forward, moe_init

    cfg = get_config("deepseek-v2-lite-16b", smoke=True)
    mesh = _mesh((2, 4))
    with fake_device_mesh(mesh):
        tree = {"moe": moe_init(None, cfg, device="meta")}
        p = distribute_meta(tree, ShardingRules(mesh).param_shardings(tree))["moe"]
        x = distribute_meta(torch.empty(B, S, cfg.d_model, device="meta"),
                            Sharding(mesh, P("data")))
        with implicit_replication(), dryrun.DeviceBook() as book:
            _, aux = moe_forward(p, cfg, x)
        assert aux.placements == (Replicate(), Replicate())
    assert [c for c in book.calls if c[0] == "all-reduce"] == [
        ("all-reduce", cfg.n_experts * 4)] * 2


# FLOPs of the plain SMOKE train step at 2048 tokens a row (the MoE in two
# checkpointed sequence chunks, the CE in four), as the port counted them
# before the dry-run's constraint sites: the DTensor branches leave the
# plain step's work, and what its backward recomputes, as it was
PLAIN_TRAIN_FLOPS = {"deepseek-v2-lite-16b": 28861005824, "dbrx-132b": 16592666624,
                     "jamba-v0.1-52b": 29197467648, "gemma-2b": 29058138112}


@pytest.mark.parametrize("arch", list(PLAIN_TRAIN_FLOPS))
def test_the_plain_train_steps_work_is_unmoved(arch):
    cfg, shape = get_config(arch, smoke=True), ShapeConfig("train_4k", 2048, 2, "train")
    step, args, *_ = dryrun.build_cell(cfg, shape, make_local_mesh("cpu"))
    assert dryrun.count_flops(step, args) == PLAIN_TRAIN_FLOPS[arch]


@pytest.mark.parametrize("kv_heads", [1, 4, 8])
def test_attention_splits_heads_within_their_kv_groups(kv_heads):
    """8 query heads sharded 4 ways: each device attends its 2 heads with
    its KV group(s), a quarter of the FLOPs and no collective."""
    from repro_torch.models.attention import chunked_causal_attention

    b, s, h, hd = 2, 256, 8, 16
    mesh = _mesh((1, 4))
    with fake_device_mesh(mesh):
        q = _dt(mesh, (b, s, h, hd), (Replicate(), Shard(2)))
        k = _dt(mesh, (b, s, kv_heads, hd), (Replicate(), Replicate()))
        with implicit_replication(), dryrun.DeviceBook() as book:
            o = chunked_causal_attention(q, k, k, 0.25, q_chunk=64, kv_chunk=64)
        assert o.placements == (Replicate(), Shard(2)) and o.shape == (b, s, h, hd)
    plain = torch.empty(b, s, h, hd, device="meta"), torch.empty(b, s, kv_heads, hd,
                                                                  device="meta")
    whole = dryrun.count_flops(
        lambda q, k: chunked_causal_attention(q, k, k, 0.25, q_chunk=64, kv_chunk=64), plain)
    assert book.flops * 4 == whole
    assert book.calls == []


@pytest.mark.parametrize("kind", list(SMOKE_SHAPES))
@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v2-lite-16b", "mamba2-370m"])
def test_smoke_cells_per_device(arch, kind):
    cfg, shape = get_config(arch, smoke=True), SMOKE_SHAPES[kind]
    one = dryrun.analyze_cell(cfg, shape, _mesh((1, 1)))
    assert not dist.is_initialized()
    four = dryrun.analyze_cell(cfg, shape, _mesh((1, 4)))
    assert not dist.is_initialized()
    step, args, shardings, *_ = dryrun.build_cell(cfg, shape, make_local_mesh("cpu"))
    # no work added or dropped: one device of a (1, 1) mesh does the plain step
    assert one["flops"] == one["flops_global"] == dryrun.count_flops(step, args)
    assert four["flops_global"] == one["flops_global"]
    assert four["flops"] < one["flops"]
    # (1, 1) is the plain step's figure; the model axis splits temp bytes
    assert one["memory_analysis"]["temp_bytes"] == dryrun.peak_temp_bytes(step, args)
    assert four["memory_analysis"]["temp_bytes"] <= one["memory_analysis"]["temp_bytes"]
    assert one["collectives"]["total_bytes"] == 0 < four["collectives"]["total_bytes"]
    assert one["temp_bytes_kind"] == "per_device"


@pytest.mark.parametrize("kind", list(SMOKE_SHAPES))
def test_argument_bytes_are_the_plans(kind):
    """The local blocks of the distributed arguments sum to the plan's
    bytes per device."""
    cfg, shape, mesh = get_config("gemma-2b", smoke=True), SMOKE_SHAPES[kind], _mesh((2, 4))
    with fake_device_mesh(mesh):
        _step, args, shardings, *_ = dryrun.build_cell(cfg, shape, mesh)
        local = sum(x._local_tensor.nbytes for x in
                    dryrun.tree_leaves(distribute_meta(args, shardings)))
    assert local == dryrun.tree_bytes(args, shardings)
    assert dryrun.analyze_cell(cfg, shape, mesh)["memory_analysis"]["argument_bytes"] == local


def test_a_group_that_exists_already_is_an_error():
    mesh = _mesh((1, 2))
    with fake_device_mesh(mesh):
        with pytest.raises(RuntimeError, match="default process group exists"):
            with fake_device_mesh(_mesh((2, 1))):
                pass
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="real devices"):
        with fake_device_mesh(make_local_mesh("cpu")):
            pass


def _comparison():
    spec = importlib.util.spec_from_file_location(
        "dryrun_torch_vs_reference", ROOT / "scripts" / "dryrun_torch_vs_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def versus():
    """The reference's gemma-2b SMOKE cells compiled under GSPMD on (1, 1),
    (1, 4) and (2, 4) meshes of forced host devices, in a process of its
    own (its ``XLA_FLAGS`` never reach this one), and the port's on the same
    meshes and on (2, 1), the (2, 4) mesh with its model axis dropped."""
    cmp = _comparison()
    ref = cmp.reference_cells("gemma-2b")
    port = cmp.port_cells("gemma-2b", meshes=cmp.MESHES + ((2, 1),))
    return cmp, port, ref


CELLS = [(m, k) for m in ("1x1", "1x4", "2x4") for k in ("train", "prefill", "decode")]
# gemma-2b SMOKE: D 64, one KV head of 32, 2 layers, vocabulary 512; the
# tokens one device of a (2, 4) mesh holds, per step kind
SMOKE_D, KV_HD, LAYERS, VOCAB = 64, 32, 2, 512
TOKENS_2X4 = {"train": 2 * 16, "prefill": 1 * 16, "decode": 1 * 1}


def _msg(port, ref, key):
    return (f"{key}: port {json.dumps(port[key])}\nreference {json.dumps(ref[key])}")


@pytest.mark.parametrize("mesh,kind", CELLS)
def test_reference_arguments_and_flops(versus, mesh, kind):
    """Argument bytes equal the reference's.  FLOPs per device (the port's
    count against the reference's dot FLOPs) are equal, except where the
    two partitioners choose differently, by an exact amount:

    - on (1, 1) the reference's compiler drops the checkpointed recompute
      of the CE logits (nothing is sharded, so the forward's logits are
      reused); the port recomputes them: one [B*S, D] x [D, V] product more;
    - on (2, 4) GSPMD splits the contraction of the replicated K/V
      projections (``wk``, ``wv``) over the model axis (each device a slice
      of D, the partial sums all-reduced), where the port runs them whole:
      3/4 of their forward FLOPs more in prefill and decode, and in the
      train step at most 3/4 of their forward and backward FLOPs (GSPMD
      splits 8 of the 12 products there)."""
    _cmp, port, ref = versus
    key = f"{mesh} {kind}"
    p, r = port[key], ref[key]
    assert p["argument_bytes"] == r["argument_bytes"], _msg(port, ref, key)
    excess = p["flops"] - r["flops"]
    kv_fwd = 2 * TOKENS_2X4[kind] * SMOKE_D * KV_HD * 2 * LAYERS
    if mesh == "1x1" and kind == "train":
        assert excess == 2 * (4 * 16) * SMOKE_D * VOCAB, _msg(port, ref, key)
    elif mesh == "2x4" and kind == "train":
        assert 0 < excess <= 3 * kv_fwd * 3 // 4, _msg(port, ref, key)
    elif mesh == "2x4":
        assert excess == kv_fwd * 3 // 4, _msg(port, ref, key)
    else:
        assert excess == 0, _msg(port, ref, key)


# Bands of port / reference, from the ratios measured on these cells: the
# model axis's split of temp bytes (temp on (1, 1) over temp on the mesh)
# 0.74-1.51, collective bytes 0.76-1.76.  With the model axis dropped (the
# port on (1, 1) for (1, 4), on (2, 1) for (2, 4)) they read 0.19-0.45
# and 0 or 1.92-2.45: outside both bands.
TEMP_SPLIT_BAND = (0.6, 1.7)
COLLECTIVES_BAND = (0.5, 1.85)


@pytest.mark.parametrize("mesh,kind", [c for c in CELLS if c[0] != "1x1"])
def test_reference_temp_and_collectives_within_bands(versus, mesh, kind):
    cmp, port, ref = versus
    key = f"{mesh} {kind}"
    got = cmp.ratios(port, ref, mesh, kind)
    msg = f"{got}\n" + _msg(port, ref, key)
    assert TEMP_SPLIT_BAND[0] <= got["temp_split"] <= TEMP_SPLIT_BAND[1], msg
    assert COLLECTIVES_BAND[0] <= got["collectives"] <= COLLECTIVES_BAND[1], msg
    # the bands would fail a port whose model axis split nothing
    dropped = {"1x4": "1x1", "2x4": "2x1"}[mesh]
    flat = dict(port, **{key: port[f"{dropped} {kind}"]})
    bad = cmp.ratios(flat, ref, mesh, kind)
    assert not TEMP_SPLIT_BAND[0] <= bad["temp_split"] <= TEMP_SPLIT_BAND[1], bad
    assert not COLLECTIVES_BAND[0] <= bad["collectives"] <= COLLECTIVES_BAND[1], bad
