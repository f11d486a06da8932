"""`repro_torch.artifact` — self-contained binary program artifacts (``.cutie``).
Counterpart of `repro.artifact`; the container bytes are the same in both
packages, so an artifact written by either loads and runs in the other.

The deployment container the paper's SoC story implies: compiled
`ExecutionPlan` + trit-packed weight-memory images + folded scale/threshold
tables in one versioned, CRC-checked byte string.

    from repro_torch.artifact import assemble, loads, disassemble, reassemble

    data   = assemble(deployed)              # DeployedProgram -> .cutie bytes
    prog   = loads(data)                     # -> LoadedProgram on the card
    logits = prog.forward(x, backend="fused")    # | "ref" | "bitsim" | "kernel"
    router = prog.serve_fleet(backend="fused")   # fleet serving from the artifact
    text   = disassemble(data)               # readable listing
    assert reassemble(text) == data          # lossless round trip

CLI: ``python -m repro_torch.artifact {build,dis,asm,info,verify}``.
Format spec and versioning policy: docs/artifact.md.
"""
from repro_torch.artifact.format import (
    ArtifactError,
    BadMagicError,
    CRCMismatchError,
    ProgramInfo,
    TruncatedArtifactError,
    UnsupportedVersionError,
    VERSION,
    assemble,
    assemble_parts,
    canonical_json,
    parse,
)
from repro_torch.artifact.listing import disassemble, reassemble
from repro_torch.artifact.loader import LoadedProgram, load, loads, save

__all__ = [
    "ArtifactError",
    "BadMagicError",
    "CRCMismatchError",
    "ProgramInfo",
    "TruncatedArtifactError",
    "UnsupportedVersionError",
    "VERSION",
    "assemble",
    "assemble_parts",
    "canonical_json",
    "parse",
    "disassemble",
    "reassemble",
    "LoadedProgram",
    "load",
    "loads",
    "save",
]
