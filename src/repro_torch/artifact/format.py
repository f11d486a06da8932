"""The ``.cutie`` binary container — CUTIE's deployable program artifact.
Counterpart of `repro.artifact.format`: the same bytes, byte for byte, so a
``.cutie`` written by either package loads in the other.

The paper's deployment story is a RISC-V SoC that receives a compiled
weight/program image and runs it with no host framework in the loop.  This
module is that image: a single self-contained byte string holding the
compiled `ExecutionPlan`, the trit-packed weight-memory images, and the
folded threshold/scale tables — everything a device (or a later Python
process that has never seen the `CutieGraph`) needs to execute the network.

On-disk layout (all integers little-endian; spec in docs/artifact.md):

    offset  size  field
    0       8     magic            b"CUTIEPRG"
    8       2     version (u16)    container format version, currently 2
    10      2     flags (u16)      reserved, 0
    12      4     payload_len (u32)
    16      4     crc32 (u32)      zlib CRC-32 over the payload bytes
    20      ...   payload          sequence of sections

Each payload section is ``tag (4 bytes ascii) + length (u32) + body``:

    META  canonical-JSON program metadata (`ProgramInfo.to_dict`)
    PLAN  canonical-JSON `ExecutionPlan.to_dict`
    WIMG  one weight-layer memory image (repeated, in plan order):
          ``u32 jlen + canonical-JSON image header + packed bytes +
          eff_scale f32[] + threshold f32[]`` — raw arrays ride as
          little-endian bytes, never JSON floats, so the artifact is
          byte-stable across platforms and Python versions.

Canonical JSON = ``sort_keys=True, separators=(",", ":"), allow_nan=False``
— the determinism contract: assembling the same program twice, in
different processes or packages, yields identical bytes; tests pin a sha256.
Every number that reaches a JSON section is a Python ``int``/``float``/
``bool`` (never a tensor or a numpy scalar, whose ``repr`` differs), and
every raw array is host numpy: `sim.memory.WeightMemory` brings the deploy
tables to the host before they reach this module.

Versioning policy: the header version bumps on ANY payload layout change;
readers reject versions they do not understand (`UnsupportedVersionError`)
instead of guessing.  Additive metadata goes into META/image-header JSON
keys (old readers must ignore unknown keys); structural changes bump.
Version history: v1 original; v2 adds the per-layer ``stride`` key to the
PLAN section (strided convs) — v2 readers still accept v1 payloads
(missing ``stride`` deserializes to 1), so `MIN_VERSION` stays 1.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

MAGIC = b"CUTIEPRG"
VERSION = 2      # written; bumped when the payload layout changes
MIN_VERSION = 1  # oldest payload this reader still understands
HEADER = struct.Struct("<8sHHII")  # magic, version, flags, payload_len, crc32
_U32 = struct.Struct("<I")
SECTION_META = b"META"
SECTION_PLAN = b"PLAN"
SECTION_WIMG = b"WIMG"


# ---------------------------------------------------------------------------
# Load-path errors — each malformation is a DISTINCT, catchable class
# ---------------------------------------------------------------------------

class ArtifactError(ValueError):
    """Base class for every malformed-``.cutie`` condition."""


class TruncatedArtifactError(ArtifactError):
    """File shorter than its header or declared payload promises."""


class BadMagicError(ArtifactError):
    """The first 8 bytes are not ``CUTIEPRG`` — not a CUTIE artifact."""


class UnsupportedVersionError(ArtifactError):
    """Container version this reader does not understand."""


class CRCMismatchError(ArtifactError):
    """Payload bytes do not match the header CRC-32 — corrupt artifact."""


def canonical_json(obj) -> bytes:
    """THE byte-stable JSON encoding (sorted keys, no whitespace, no NaN)."""
    return json.dumps(
        obj, sort_keys=True, separators=(",", ":"), allow_nan=False
    ).encode("utf-8")


# ---------------------------------------------------------------------------
# Program metadata — the artifact's graph-free serving descriptor
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProgramInfo:
    """Everything serving needs to know about a program WITHOUT the graph.

    This is the META section, and — via `LoadedProgram.graph` — the
    duck-typed metadata object `StreamSession`/`SessionPool` read instead
    of a `CutieGraph`: same attribute names, no layer specs, no Python
    graph object on the load path."""

    name: str
    input_hw: Tuple[int, int]
    input_ch: int
    n_classes: int
    act_threshold: float
    is_temporal: bool
    tcn_steps: int
    feature_channels: int
    passes_per_inference: int
    paper_energy_uj: Optional[float] = None
    paper_inf_per_s: Optional[float] = None

    @staticmethod
    def from_graph(g) -> "ProgramInfo":
        return ProgramInfo(
            name=g.name,
            input_hw=tuple(g.input_hw),
            input_ch=g.input_ch,
            n_classes=g.n_classes,
            act_threshold=float(g.act_threshold),
            is_temporal=g.is_temporal,
            tcn_steps=g.tcn_steps if g.is_temporal else 0,
            feature_channels=g.feature_channels if g.is_temporal else 0,
            passes_per_inference=g.passes_per_inference if g.is_temporal else 1,
            paper_energy_uj=g.paper_energy_uj,
            paper_inf_per_s=g.paper_inf_per_s,
        )

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["input_hw"] = list(self.input_hw)
        return d

    @staticmethod
    def from_dict(d: dict) -> "ProgramInfo":
        known = {f.name for f in dataclasses.fields(ProgramInfo)}
        # additive-versioning: unknown keys from newer writers are ignored
        kw = {k: v for k, v in d.items() if k in known}
        kw["input_hw"] = tuple(kw["input_hw"])
        return ProgramInfo(**kw)


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------

def _f32_bytes(a) -> bytes:
    return np.asarray(a, dtype="<f4").reshape(-1).tobytes()


def _image_section(img) -> bytes:
    """One `sim.memory.LayerImage` -> WIMG section body.  The packed bytes
    are the quantizer's verbatim (`api.quantize` stays the single pack
    path); scales/thresholds ride as raw little-endian float32."""
    thr = img.threshold
    thr_vec = np.asarray(thr, dtype="<f4").reshape(-1)
    header = {
        "kind": img.kind,
        "index": img.index,
        "dilation": img.dilation,
        "packed_shape": [int(s) for s in img.packed.shape],
        "scale_len": int(np.asarray(img.eff_scale).size),
        "thr_len": int(thr_vec.size),
        "thr_scalar": not bool(np.ndim(thr)),
    }
    jb = canonical_json(header)
    return b"".join([
        _U32.pack(len(jb)), jb,
        np.ascontiguousarray(img.packed, dtype=np.uint8).tobytes(),
        _f32_bytes(img.eff_scale),
        thr_vec.tobytes(),
    ])


def _parse_image_section(body: bytes):
    from repro_torch.sim.memory import LayerImage

    if len(body) < _U32.size:
        raise TruncatedArtifactError("WIMG section too short for its header")
    (jlen,) = _U32.unpack_from(body, 0)
    off = _U32.size
    if len(body) < off + jlen:
        raise TruncatedArtifactError("WIMG header overruns its section")
    header = json.loads(body[off : off + jlen].decode("utf-8"))
    off += jlen
    shape = tuple(header["packed_shape"])
    n_packed = int(np.prod(shape)) if shape else 1
    n_scale = header["scale_len"]
    n_thr = header["thr_len"]
    need = n_packed + 4 * (n_scale + n_thr)
    if len(body) - off != need:
        raise TruncatedArtifactError(
            f"WIMG body is {len(body) - off} bytes, expected {need}"
        )
    packed = np.frombuffer(body, np.uint8, n_packed, off).reshape(shape).copy()
    off += n_packed
    eff_scale = np.frombuffer(body, "<f4", n_scale, off).astype(np.float32)
    off += 4 * n_scale
    thr_vec = np.frombuffer(body, "<f4", n_thr, off).astype(np.float32)
    threshold = float(thr_vec[0]) if header["thr_scalar"] else thr_vec
    return LayerImage(
        kind=header["kind"],
        index=header["index"],
        packed=packed,
        eff_scale=eff_scale,
        threshold=threshold,
        dilation=header["dilation"],
    )


def _section(tag: bytes, body: bytes) -> bytes:
    return tag + _U32.pack(len(body)) + body


def assemble_parts(info: ProgramInfo, plan, memory) -> bytes:
    """(info, `ExecutionPlan`, `WeightMemory`) -> ``.cutie`` bytes."""
    payload = b"".join(
        [
            _section(SECTION_META, canonical_json(info.to_dict())),
            _section(SECTION_PLAN, canonical_json(plan.to_dict())),
        ]
        + [_section(SECTION_WIMG, _image_section(img)) for img in memory.images]
    )
    return HEADER.pack(
        MAGIC, VERSION, 0, len(payload), zlib.crc32(payload) & 0xFFFFFFFF
    ) + payload


def assemble(program) -> bytes:
    """Assemble any executable program object into ``.cutie`` bytes.

    Accepts a `api.program.DeployedProgram` (lowers its graph, binds its
    packed tables — the same `WeightMemory.from_tables` path the bitsim
    backend uses, so the images are the quantizer's bytes verbatim, on the
    host) or an
    `artifact.loader.LoadedProgram` (re-assembles what was loaded; the
    result is byte-identical to the original artifact — the loader is
    lossless)."""
    if hasattr(program, "info") and hasattr(program, "memory"):
        return assemble_parts(program.info, program.plan, program.memory)
    # DeployedProgram path
    from repro_torch.sim.memory import WeightMemory
    from repro_torch.sim.plan import lower

    g = program.graph
    plan = lower(g)
    memory = WeightMemory.from_tables(plan, program.tables, g.act_threshold)
    return assemble_parts(ProgramInfo.from_graph(g), plan, memory)


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------

def split_container(data: bytes) -> Tuple[int, int, List[Tuple[bytes, bytes]]]:
    """Validate the header/CRC and walk the payload.

    Returns ``(version, flags, [(tag, body), ...])``; raises the distinct
    `ArtifactError` subclasses on every malformation (the load-path
    robustness contract — no garbage decode)."""
    if len(data) < HEADER.size:
        raise TruncatedArtifactError(
            f"artifact is {len(data)} bytes; the header alone is {HEADER.size}"
        )
    magic, version, flags, payload_len, crc = HEADER.unpack_from(data, 0)
    if magic != MAGIC:
        raise BadMagicError(f"bad magic {magic!r}; expected {MAGIC!r}")
    if not MIN_VERSION <= version <= VERSION:
        raise UnsupportedVersionError(
            f"container version {version}; this reader understands "
            f"{MIN_VERSION}..{VERSION}"
        )
    payload = data[HEADER.size : HEADER.size + payload_len]
    if len(payload) < payload_len:
        raise TruncatedArtifactError(
            f"payload truncated: header declares {payload_len} bytes, "
            f"{len(payload)} present"
        )
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise CRCMismatchError(
            f"payload CRC-32 {zlib.crc32(payload) & 0xFFFFFFFF:#010x} != "
            f"header {crc:#010x}"
        )
    sections: List[Tuple[bytes, bytes]] = []
    off = 0
    while off < len(payload):
        if off + 4 + _U32.size > len(payload):
            raise TruncatedArtifactError("section header overruns the payload")
        tag = payload[off : off + 4]
        (n,) = _U32.unpack_from(payload, off + 4)
        off += 4 + _U32.size
        if off + n > len(payload):
            raise TruncatedArtifactError(
                f"section {tag!r} body overruns the payload"
            )
        sections.append((tag, payload[off : off + n]))
        off += n
    return version, flags, sections


def parse(data: bytes):
    """``.cutie`` bytes -> ``(ProgramInfo, ExecutionPlan, WeightMemory)``."""
    from repro_torch.sim.memory import WeightMemory
    from repro_torch.sim.plan import ExecutionPlan

    _, _, sections = split_container(data)
    info = plan = None
    images = []
    for tag, body in sections:
        if tag == SECTION_META:
            info = ProgramInfo.from_dict(json.loads(body.decode("utf-8")))
        elif tag == SECTION_PLAN:
            plan = ExecutionPlan.from_dict(json.loads(body.decode("utf-8")))
        elif tag == SECTION_WIMG:
            images.append(_parse_image_section(body))
        # unknown tags from newer (same-version-compatible) writers: ignored
    if info is None or plan is None:
        raise ArtifactError("artifact is missing its META or PLAN section")
    fc = next((i.eff_scale for i in images if i.kind == "fc"), None)
    memory = WeightMemory(images=images, fc_scale=fc)
    return info, plan, memory
