"""`repro_torch.artifact` held against `repro.artifact` on the CPU.

The ``.cutie`` container is the second bridge between the packages:

  * the port assembles the reference's hand-built program (no PRNG, exact
    float32 scales) to the pinned sha256;
  * on the same deploy tables, handed as numpy to the reference's
    `DeployedProgram` and to the port's through `repro_torch.convert`, the
    port's bytes equal the reference's (sha256), each package loads the
    other's bytes and re-assembles them losslessly, and the listings are the
    same text;
  * the port's `LoadedProgram` on ``ref``, ``fused`` (the kernel's plain
    version on the CPU) and ``bitsim`` gives the reference `LoadedProgram`'s
    ``bitsim`` logits, bit for bit;
  * every typed load error fires, a v1 payload loads, and the
    ``python -m repro_torch.artifact`` CLI works end to end on the CPU.
"""
import hashlib
import json
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import artifact as jart
from repro.api.program import DeployedProgram as DeployedJ
from repro.sim.memory import LayerImage as LayerImageJ
from repro.sim.memory import WeightMemory as WeightMemoryJ
from repro.sim.plan import lower as lower_j
from repro.core.ternary import pack_ternary as pack_ternary_j
from repro_torch import api as tapi
from repro_torch import artifact
from repro_torch import convert
from repro_torch.artifact import (
    ArtifactError,
    BadMagicError,
    CRCMismatchError,
    ProgramInfo,
    TruncatedArtifactError,
    UnsupportedVersionError,
)
from repro_torch.artifact import __main__ as cli
from repro_torch.artifact.format import HEADER, MAGIC, VERSION, assemble_parts, canonical_json
from repro_torch.core.ternary import pack_ternary
from repro_torch.sim.memory import LayerImage, WeightMemory
from repro_torch.sim.plan import lower

HAND_BUILT_SHA256 = "d0116d48965da975b6acbb5a35608390d8281c876bf459c7ca54b3a46a917199"
NETS = ("cifar10_tnn_smoke", "dvs_cnn_tcn_smoke")
PORT_BACKENDS = ("ref", "fused", "bitsim", "kernel")


def _tables_np(x):
    """Deploy tables as numpy arrays (tensors) and Python scalars."""
    if isinstance(x, dict):
        return {k: _tables_np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tables_np(v) for v in x]
    return x.numpy() if isinstance(x, torch.Tensor) else x


def _tables_jnp(x):
    if isinstance(x, dict):
        return {k: _tables_jnp(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_tables_jnp(v) for v in x]
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _pair(name, seed=0, learn_thresholds=False):
    """Calibrated deploy tables (quantized by the port, whose calibration
    forward is fast here) handed as numpy to BOTH packages: the reference's
    `DeployedProgram`, and the port's through `convert`."""
    prog = tapi.get_net(name)
    params = prog.init(torch.Generator().manual_seed(seed),
                       learn_thresholds=learn_thresholds, device="cpu")
    if learn_thresholds == "per_channel":
        # non-uniform vectors, so a scalar path cannot fake it
        params["thresh"]["conv"] = [
            t + torch.linspace(-0.2, 0.4, t.shape[0]) for t in params["thresh"]["conv"]]
    g = prog.graph
    shape = ((2, 3, *g.input_hw, g.input_ch) if g.is_temporal
             else (2, *g.input_hw, g.input_ch))
    calib = torch.sign(torch.randn(shape, generator=torch.Generator().manual_seed(seed + 7)))
    tables = _tables_np(prog.quantize(params, calib=calib).tables)
    return (DeployedJ(japi.get_graph(name), _tables_jnp(tables)),
            convert.deployed_from_reference_tables(name, tables, device="cpu"))


@pytest.fixture(scope="module")
def pairs():
    """{net: (reference DeployedProgram, port DeployedProgram over the same
    tables)}, plus a per-channel-threshold variant of the temporal net."""
    out = {name: _pair(name) for name in NETS}
    out["per_channel"] = _pair("dvs_cnn_tcn_smoke", seed=3, learn_thresholds="per_channel")
    return out


def _inputs(info, seed=4, batch=1, frames=2):
    shape = ((batch, frames, *info.input_hw, info.input_ch)
             if info.is_temporal else (batch, *info.input_hw, info.input_ch))
    return np.sign(np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# the hand-built pin
# ---------------------------------------------------------------------------

def _hand_built(lower_fn, graph, layer_image, weight_memory, pack):
    plan = lower_fn(graph)
    images = []
    for lp in plan.weight_layers():
        scale = ((np.arange(lp.c_out) + 1) / 8.0).astype(np.float32)
        if lp.kind == "fc":
            k = lp.c_in
            t = ((np.arange(k * lp.c_out, dtype=np.int64) % 3) - 1).reshape(k, lp.c_out)
            t_pad = np.pad(t.astype(np.int8), ((0, (-k) % 4), (0, 0)))
            images.append(layer_image(kind="fc", index=lp.index, packed=pack(t_pad, 0),
                                      eff_scale=scale, threshold=0.0))
        else:
            shape = (lp.kh, lp.kw, lp.c_pad, lp.c_out)
            trits = ((np.arange(int(np.prod(shape)), dtype=np.int64) % 3) - 1
                     ).reshape(shape).astype(np.int8)
            images.append(layer_image(kind=lp.kind, index=lp.index, packed=pack(trits, 2),
                                      eff_scale=scale, threshold=0.5, dilation=1))
    fc = next((i.eff_scale for i in images if i.kind == "fc"), None)
    return plan, weight_memory(images=images, fc_scale=fc)


def _port_hand_built():
    g = tapi.get_graph("cifar10_tnn_smoke")
    plan, memory = _hand_built(
        lower, g, LayerImage, WeightMemory,
        lambda a, axis: pack_ternary(torch.from_numpy(a), axis=axis).numpy())
    return ProgramInfo.from_graph(g), plan, memory


class TestHandBuiltPin:
    def test_port_assembles_the_reference_pin(self):
        data = assemble_parts(*_port_hand_built())
        assert hashlib.sha256(data).hexdigest() == HAND_BUILT_SHA256

    def test_reference_and_port_hand_built_bytes_are_equal(self):
        g = japi.get_graph("cifar10_tnn_smoke")
        plan, memory = _hand_built(
            lower_j, g, LayerImageJ, WeightMemoryJ,
            lambda a, axis: np.asarray(pack_ternary_j(a, axis=axis), np.uint8))
        want = jart.assemble_parts(jart.ProgramInfo.from_graph(g), plan, memory)
        assert assemble_parts(*_port_hand_built()) == want

    def test_hand_built_artifact_executes_on_every_backend(self):
        loaded = artifact.loads(assemble_parts(*_port_hand_built()), device="cpu")
        x = torch.from_numpy(_inputs(loaded.info))
        outs = {b: loaded.forward(x, backend=b) for b in PORT_BACKENDS}
        for b in PORT_BACKENDS:
            assert torch.equal(outs[b], outs["bitsim"]), b


# ---------------------------------------------------------------------------
# bytes across packages
# ---------------------------------------------------------------------------

class TestCrossPackageBytes:
    @pytest.mark.parametrize("net", NETS + ("per_channel",))
    def test_port_bytes_equal_reference_bytes(self, pairs, net):
        ref, port = pairs[net]
        want = jart.assemble(ref)
        got = port.to_artifact_bytes()
        assert hashlib.sha256(got).hexdigest() == hashlib.sha256(want).hexdigest()

    @pytest.mark.parametrize("net", NETS + ("per_channel",))
    def test_each_package_loads_the_others_bytes(self, pairs, net):
        ref, port = pairs[net]
        from_ref = jart.assemble(ref)
        from_port = artifact.assemble(port)
        loaded = artifact.loads(from_ref, device="cpu")
        assert loaded.to_bytes() == from_ref
        assert jart.loads(from_port).to_bytes() == from_port
        assert artifact.assemble(loaded) == from_ref

    @pytest.mark.parametrize("net", NETS)
    def test_disassembly_text_is_identical(self, pairs, net):
        data = jart.assemble(pairs[net][0])
        text = artifact.disassemble(data)
        assert text == jart.disassemble(data)
        assert artifact.reassemble(text) == data
        assert jart.reassemble(text) == data

    @pytest.mark.parametrize("net", NETS + ("per_channel",))
    def test_loaded_logits_equal_reference_loaded_bitsim(self, pairs, net):
        ref, _ = pairs[net]
        data = jart.assemble(ref)
        jl = jart.loads(data)
        loaded = artifact.loads(data, device="cpu")
        x = _inputs(loaded.info)
        want = np.asarray(jl.forward(jnp.asarray(x), backend="bitsim"))
        for b in ("ref", "fused", "bitsim"):
            got = loaded.forward(torch.from_numpy(x), backend=b)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=b)

    def test_per_channel_thresholds_survive_as_vectors(self, pairs):
        loaded = artifact.loads(pairs["per_channel"][1].to_artifact_bytes(), device="cpu")
        assert any(np.ndim(i.threshold) == 1 for i in loaded.memory.images)

    def test_silicon_report_equals_reference(self, pairs):
        data = jart.assemble(pairs["dvs_cnn_tcn_smoke"][0])
        want = jart.loads(data).silicon_report(v=0.5)
        got = artifact.loads(data, device="cpu").silicon_report(v=0.5)
        assert (got.energy_uj, got.inf_per_s, got.ideal.cycles) == \
            (want.energy_uj, want.inf_per_s, want.ideal.cycles)

    def test_program_info_json_is_the_references(self, pairs):
        g_t, g_j = tapi.get_graph("dvs_cnn_tcn_smoke"), japi.get_graph("dvs_cnn_tcn_smoke")
        assert canonical_json(ProgramInfo.from_graph(g_t).to_dict()) == \
            jart.canonical_json(jart.ProgramInfo.from_graph(g_j).to_dict())


# ---------------------------------------------------------------------------
# the loaded program as a serving target
# ---------------------------------------------------------------------------

class TestLoadedProgram:
    def test_stream_and_pool_equal_the_deployed_program(self, pairs):
        _, port = pairs["dvs_cnn_tcn_smoke"]
        loaded = artifact.loads(port.to_artifact_bytes(), device="cpu")
        clip = torch.from_numpy(_inputs(loaded.info, batch=1, frames=4))
        lone = loaded.stream(batch=1, backend="fused")
        dep = port.stream(batch=1, backend="fused")
        pool = loaded.serve(2, backend="fused")
        pool.admit("a")
        for t in range(4):
            want = dep.step(clip[:, t])
            assert torch.equal(lone.step(clip[:, t]), want)
            assert torch.equal(pool.step({"a": clip[0, t]})["a"], want[0])
        assert pool.trace_count == 1

    def test_one_executor_per_backend_shared_by_every_pool(self, pairs):
        """The weights reach the device once: every pool of the program
        goes through the same executor and its one cache of operands."""
        loaded = artifact.loads(pairs["dvs_cnn_tcn_smoke"][1].to_artifact_bytes(),
                                device="cpu")
        frame = torch.from_numpy(_inputs(loaded.info, batch=1, frames=1)[0, 0])
        for size in (1, 2, 4):
            pool = loaded.serve(size, backend="fused")
            pool.admit("s")
            pool.step({"s": frame})
        assert list(loaded._executors) == ["fused"]
        ex = loaded._executors["fused"]
        assert len(ex._on_device) == len(loaded.memory.images)
        # what a step would otherwise rebuild is made once: the FC image
        # decoded to trits, and the kernel's [C_out] threshold vectors
        for (index, _), (img, weights, eff, thr) in ex._on_device.items():
            if img.kind == "fc":
                assert weights.dtype == torch.float32
                c_in = next(lp.c_in for lp in loaded.plan.layers if lp.index == index)
                assert weights.shape == (c_in, loaded.info.n_classes)
            else:
                assert weights.dtype == torch.uint8
                assert isinstance(thr, torch.Tensor) and thr.shape == eff.shape

    def test_device_defaults_to_cuda_and_raises_without_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        data = assemble_parts(*_port_hand_built())
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            artifact.loads(data)
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            artifact.loads(data, device="cuda")
        assert artifact.loads(data, device="cpu").device == torch.device("cpu")

    def test_save_and_load_round_trip(self, pairs, tmp_path):
        port = pairs["cifar10_tnn_smoke"][1]
        path = tmp_path / "net.cutie"
        n = port.save_artifact(path)
        assert n == path.stat().st_size
        loaded = artifact.load(path, device="cpu")
        assert loaded.to_bytes() == port.to_artifact_bytes()
        assert artifact.save(loaded, tmp_path / "again.cutie") == n


# ---------------------------------------------------------------------------
# typed load errors and version compatibility
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_bytes(pairs):
    return pairs["cifar10_tnn_smoke"][1].to_artifact_bytes()


class TestErrors:
    def test_truncated_header(self):
        with pytest.raises(TruncatedArtifactError, match="header alone"):
            artifact.loads(MAGIC[:4], device="cpu")

    def test_truncated_payload(self, smoke_bytes):
        with pytest.raises(TruncatedArtifactError, match="payload truncated"):
            artifact.loads(smoke_bytes[:-3], device="cpu")

    def test_bad_magic(self, smoke_bytes):
        with pytest.raises(BadMagicError, match="bad magic"):
            artifact.loads(b"NOTCUTIE" + smoke_bytes[8:], device="cpu")

    def test_unsupported_version(self, smoke_bytes):
        data = smoke_bytes[:8] + struct.pack("<H", VERSION + 1) + smoke_bytes[10:]
        with pytest.raises(UnsupportedVersionError, match="this reader understands"):
            artifact.loads(data, device="cpu")

    def test_crc_mismatch(self, smoke_bytes):
        flipped = smoke_bytes[-1] ^ 0xFF
        with pytest.raises(CRCMismatchError, match="CRC-32"):
            artifact.loads(smoke_bytes[:-1] + bytes([flipped]), device="cpu")

    def test_missing_sections(self):
        empty = HEADER.pack(MAGIC, VERSION, 0, 0, zlib.crc32(b"") & 0xFFFFFFFF)
        with pytest.raises(ArtifactError, match="missing its META or PLAN"):
            artifact.loads(empty, device="cpu")

    def test_truncated_weight_image(self, smoke_bytes):
        listing = artifact.disassemble(smoke_bytes)
        cut = listing.replace("  blob threshold 4\n", "  blob threshold 0\n", 1)
        cut = cut.split("  blob threshold 0\n")
        # drop the hex line the shrunken blob no longer declares
        cut = cut[0] + "  blob threshold 0\n" + cut[1].split("\n", 1)[1]
        with pytest.raises(TruncatedArtifactError, match="WIMG body"):
            artifact.loads(artifact.reassemble(cut), device="cpu")

    def test_error_classes_are_artifact_and_value_errors(self):
        for cls in (TruncatedArtifactError, BadMagicError,
                    UnsupportedVersionError, CRCMismatchError):
            assert issubclass(cls, ArtifactError)
            assert issubclass(cls, ValueError)

    def test_v1_payload_still_loads(self, smoke_bytes):
        lines = []
        for ln in artifact.disassemble(smoke_bytes).splitlines():
            if ln.strip().startswith("version"):
                lines.append("version 1")
            elif ln.strip().startswith("json") and '"stride"' in ln:
                pad, body = ln.split("json ", 1)
                obj = json.loads(body)
                for lp in obj.get("layers", ()):
                    lp.pop("stride", None)
                lines.append(pad + "json " + canonical_json(obj).decode())
            else:
                lines.append(ln)
        v1 = artifact.reassemble("\n".join(lines))
        assert v1 != smoke_bytes
        loaded = artifact.loads(v1, device="cpu")
        assert all(lp.stride == 1 for lp in loaded.plan.layers)
        assert jart.loads(v1).to_bytes() == loaded.to_bytes()

    def test_program_info_ignores_unknown_keys(self, smoke_bytes):
        info = artifact.loads(smoke_bytes, device="cpu").info
        assert ProgramInfo.from_dict(dict(info.to_dict(), future_field=1)) == info


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

class TestCLI:
    def test_build_dis_asm_info_verify(self, tmp_path, capsys):
        art = tmp_path / "net.cutie"
        lst = tmp_path / "net.lst"
        again = tmp_path / "again.cutie"
        assert cli.main(["build", "dvs_cnn_tcn_smoke", "-o", str(art),
                         "--device", "cpu"]) == 0
        assert cli.main(["dis", str(art), "-o", str(lst)]) == 0
        assert cli.main(["asm", str(lst), "-o", str(again), "--expect", str(art)]) == 0
        assert again.read_bytes() == art.read_bytes()
        assert cli.main(["info", str(art), "--device", "cpu"]) == 0
        assert cli.main(["verify", str(art), "--device", "cpu",
                         "--backends", "bitsim", "ref", "fused", "kernel"]) == 0
        out = capsys.readouterr().out
        assert "dvs_cnn_tcn_smoke" in out and "OK: round trip lossless" in out
        # the reference toolchain reads the port's artifact
        assert jart.loads(art.read_bytes()).to_bytes() == art.read_bytes()

    def test_build_spatial_net_and_asm_gate_fails_on_a_difference(self, tmp_path):
        art = tmp_path / "c.cutie"
        assert cli.main(["build", "cifar10_tnn_smoke", "-o", str(art),
                         "--device", "cpu", "--no-calib"]) == 0
        lst = tmp_path / "c.lst"
        assert cli.main(["dis", str(art), "-o", str(lst)]) == 0
        edited = lst.read_text().replace("flags 0", "flags 1")
        lst.write_text(edited)
        assert cli.main(["asm", str(lst), "-o", str(tmp_path / "x.cutie"),
                         "--expect", str(art)]) == 1

    def test_verify_fails_on_a_corrupt_artifact(self, tmp_path, smoke_bytes):
        bad = tmp_path / "bad.cutie"
        bad.write_bytes(smoke_bytes[:-1] + bytes([smoke_bytes[-1] ^ 0xFF]))
        with pytest.raises(CRCMismatchError):
            cli.main(["verify", str(bad), "--device", "cpu"])
