"""The port's dry-run (`repro_torch.launch.dryrun`) on the CPU: its
microbatching and probe configs are the reference's, its FLOP count on meta
tensors equals the count on real tensors of the same step and the probes'
extrapolation, and a cell's artifact carries the reference's keys."""
import dataclasses
import json
import os

import jax
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.models.config import SHAPES as REF_SHAPES
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh, planned_mesh
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.tree import tree_map

# smoke-sized cells: one of each step kind
SMOKE_SHAPES = {
    "train": ShapeConfig("train_4k", 16, 4, "train"),
    "prefill": ShapeConfig("prefill_32k", 16, 2, "prefill"),
    "decode": ShapeConfig("decode_32k", 16, 2, "decode"),
}
DENSE = [a for a in ARCH_IDS if not get_config(a).is_moe]


@pytest.fixture(scope="module")
def ref_dryrun():
    """`repro.launch.dryrun`, imported after JAX's CPU backend is up and with
    the ``XLA_FLAGS`` it sets at import restored, so no later test of this
    process and no subprocess sees 512 forced devices."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_accum_and_probe_configs_are_the_references(arch, ref_dryrun):
    for shape in SHAPES:
        assert dryrun.accum_for(get_config(arch), SHAPES[shape]) == ref_dryrun.accum_for(
            ref_config(arch), REF_SHAPES[shape])
    got, want = dryrun.probe_configs(get_config(arch)), ref_dryrun.probe_configs(
        ref_config(arch))
    assert got[2:] == want[2:]
    for p, q in zip(got[:2], want[:2]):
        assert dataclasses.asdict(p) == dataclasses.asdict(q)


def _real(args):
    """CPU tensors of the meta arguments' shapes and dtypes (zeros: the
    count depends on shapes only)."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype), args)


@pytest.mark.parametrize("kind", list(SMOKE_SHAPES))
@pytest.mark.parametrize("arch", DENSE)
def test_meta_flops_equal_real_and_probe(arch, kind):
    """One call's FLOPs on meta tensors == on CPU tensors of the same step,
    and the probes' extrapolation == the full count (every layer counted)."""
    cfg, shape = get_config(arch, smoke=True), SMOKE_SHAPES[kind]
    step, args, *_ = dryrun.build_cell(cfg, shape, make_local_mesh("cpu"))
    meta = dryrun.count_flops(step, args)
    assert meta > 0
    step, args, *_ = dryrun.build_cell(cfg, shape, make_local_mesh("cpu"))
    assert dryrun.count_flops(step, _real(args)) == meta
    probe = dryrun.probe_extrapolate(cfg, shape, make_local_mesh("cpu"))
    assert probe["flops"] == meta


def test_flops_per_device_divide_by_the_mesh():
    """Where the mesh splits every product (a (4, 1) data mesh over a batch
    of 4), one device's FLOPs are the global count over the mesh size,
    exactly.  On the production mesh, where replicated work counts on every
    device (as the reference's ``cost_analysis`` counts it), the devices
    together do at least the global count; ``flops_global`` is the plain
    step's count at the global shapes."""
    cfg, shape = get_config("gemma-2b", smoke=True), SMOKE_SHAPES["train"]
    out = dryrun.analyze_cell(cfg, shape, planned_mesh((4, 1), ("data", "model")))
    assert out["flops"] * 4 == out["flops_global"]
    mesh = make_production_mesh()
    out = dryrun.analyze_cell(cfg, shape, mesh)
    assert out["flops"] * 256 >= out["flops_global"]
    step, args, *_ = dryrun.build_cell(cfg, shape, mesh)
    assert out["flops_global"] == dryrun.count_flops(step, args)


def test_live_bytes_follow_storages():
    """A view keeps its base's bytes alive; a freed tensor gives them back;
    each allocation counts in 512-byte blocks."""
    with dryrun.LiveBytes() as live:
        x = torch.empty(1000, device="meta")         # 4000 -> 4096
        v = (x + 1).view(10, 100)                     # base dies, view lives
        assert live.live == 2 * 4096
        del v
        assert live.live == 4096
        y = torch.empty(3, device="meta")             # 12 -> 512
        assert live.live == 4096 + 512 and live.peak == 2 * 4096
        del x, y
    assert live.live == 0


def test_booked_bytes_bound_the_caching_allocator():
    """512-byte blocks; above 1 MiB a block may stay unsplit with up to
    1 MiB more."""
    mib = 1 << 20
    assert [dryrun.booked_bytes(n) for n in (0, 1, 512, 513, mib)] == [
        0, 512, 512, 1024, mib]
    assert dryrun.booked_bytes(mib + 1) == mib + 512 + mib


@pytest.mark.parametrize("kind", list(SMOKE_SHAPES))
def test_run_cell_writes_the_artifact(kind, tmp_path):
    shape = SMOKE_SHAPES[kind]
    r = dryrun.run_cell("gemma-2b", shape.name, overrides={"smoke": True}, variant="smoke",
                        shape=shape, device="cpu", out_dir=tmp_path, verbose=False)
    assert r["status"] == "ok", r.get("traceback")
    path = tmp_path / f"gemma-2b__{shape.name}__pod16x16__smoke.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(r))
    for key in ("applicable", "n_params", "n_active_params", "flops", "flops_global",
                "bytes_accessed", "bytes_accessed_kind", "probe", "memory_analysis",
                "temp_bytes_kind", "collectives", "device", "fits", "trace_s"):
        assert key in r, key
    assert "collectives_reason" not in r
    mem = r["memory_analysis"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
    assert all(v >= 0 for v in mem.values()) and mem["temp_bytes"] > 0
    assert r["temp_bytes_kind"] == "per_device" and r["bytes_accessed_kind"] == "unfused"
    coll = r["collectives"]
    assert set(coll) == {"bytes_by_kind", "counts", "total_bytes"}
    assert set(coll["bytes_by_kind"]) == set(dryrun.COLLECTIVES) == set(coll["counts"])
    assert coll["total_bytes"] == sum(coll["bytes_by_kind"].values()) > 0
    assert r["device"] is None and r["fits"] is None
    assert r["probe"]["flops"] == r["flops"]
    assert r["probe"]["collective_total"] > 0 and r["probe"]["bytes"] > 0
    # the donated argument: the train state, the decode cache, nothing in prefill
    assert (mem["alias_bytes"] > 0) == (kind != "prefill")
    again = dryrun.run_cell("gemma-2b", shape.name, overrides={"smoke": True},
                            variant="smoke", shape=shape, device="cpu", out_dir=tmp_path)
    assert again == json.loads(path.read_text())  # read back, not rerun


def test_inapplicable_cell_is_skipped_with_the_references_reason(tmp_path):
    r = dryrun.run_cell("gemma-2b", "long_500k", device="cpu", out_dir=tmp_path,
                        verbose=False)
    assert r["status"] == "skipped_inapplicable" and not r["applicable"]
    assert r["reason"] == ("long_500k needs sub-quadratic sequence mixing "
                           "(full attention arch)")


def test_a_step_that_cannot_trace_is_an_error_cell(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no meta kernel")

    monkeypatch.setattr(dryrun, "make_decode_step", lambda cfg, shard=None: broken)
    r = dryrun.run_cell("gemma-2b", "decode_32k", device="cpu", out_dir=tmp_path,
                        verbose=False)
    assert r["status"] == "error" and "no meta kernel" in r["error"]
    assert "Traceback" in r["traceback"]


def test_main_exits_0_and_writes_the_cell(tmp_path, capsys):
    rc = dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k", "--device", "cpu",
                      "--out-dir", str(tmp_path)])
    assert rc == 0
    r = json.loads((tmp_path / "gemma-2b__decode_32k__pod16x16.json").read_text())
    assert r["status"] == "ok" and r["flops"] > 0
    assert "[dryrun] gemma-2b x decode_32k x pod16x16: OK" in capsys.readouterr().out
    cfg = get_config("gemma-2b")
    cache = 2 * cfg.n_layers * 8 * 32768 * cfg.n_kv_heads * cfg.head_dim * 2 // 16
    assert r["memory_analysis"]["alias_bytes"] == cache + 4  # k, v; `len`


def test_main_runs_cells_in_processes(tmp_path):
    """``--jobs 2``: the cells in spawned processes, the same artifacts."""
    rc = dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k", "--both-meshes",
                      "--device", "cpu", "--out-dir", str(tmp_path), "--jobs", "2"])
    assert rc == 0
    for mesh in ("pod16x16", "pod2x16x16"):
        r = json.loads((tmp_path / f"mamba2-370m__decode_32k__{mesh}.json").read_text())
        assert r["status"] == "ok" and r["mesh"] == mesh
    # the probe runs on the single-pod mesh only, as the reference's
    assert r["probe"] is None


def test_main_without_a_card_raises(monkeypatch, tmp_path):
    """``--device`` defaults to the card, whose memory ``fits`` is held to."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k", "--out-dir",
                     str(tmp_path)])
    assert not list(tmp_path.iterdir())
