"""Disassembler: ``.cutie`` bytes <-> a readable text listing.
Counterpart of `repro.artifact.listing`: the same text, byte for byte.

`disassemble` renders a validated artifact as a line-oriented listing —
human-auditable (per-image geometry comments, decoded scales) yet lossless:
`reassemble(disassemble(data)) == data` byte-for-byte (``python -m
repro_torch.artifact verify`` gates it).  The raw arrays are emitted as little-endian hex, NOT
decimal floats, so the round trip never re-quantizes anything.

Listing grammar (full-line ``;`` comments and blank lines are ignored):

    version 2
    flags 0
    section META
      json {...canonical JSON...}
    section PLAN
      json {...}
    section WIMG
      json {...image header...}
      blob packed <nbytes>
        <hex bytes, any line split>
      blob scale <nbytes>
        ...
      blob threshold <nbytes>
        ...

JSON lines are re-canonicalized on reassembly (`format.canonical_json`),
so hand-edits with different key order or whitespace still produce a valid
canonical artifact; an UNEDITED listing reassembles byte-identically.
"""
from __future__ import annotations

import json
from typing import List

import numpy as np

from repro_torch.artifact import format as fmt


def _hex_lines(body: bytes, indent: str = "    ", per_line: int = 32) -> List[str]:
    return [
        indent + body[i : i + per_line].hex()
        for i in range(0, len(body), per_line)
    ]


def _image_comment(header: dict) -> str:
    shape = "x".join(str(s) for s in header["packed_shape"])
    thr = "scalar" if header["thr_scalar"] else f"[{header['thr_len']}]"
    return (f"; {header['kind']} layer {header['index']}: packed {shape} "
            f"({int(np.prod(header['packed_shape']))} B), "
            f"{header['scale_len']} scales, threshold {thr}, "
            f"dilation {header['dilation']}")


def disassemble(data: bytes) -> str:
    """Validated artifact bytes -> text listing (raises `ArtifactError` on
    any malformation first — the disassembler never renders garbage)."""
    version, flags, sections = fmt.split_container(data)
    crc = int.from_bytes(data[16:20], "little")
    # the header comment is the reference's own, so a listing is the same
    # text whichever package renders it
    out: List[str] = [
        "; repro.artifact disassembly — .cutie container",
        f"; payload {len(data) - fmt.HEADER.size} bytes, "
        f"crc32 {crc:#010x} (recomputed on reassembly)",
        f"version {version}",
        f"flags {flags}",
    ]
    for tag, body in sections:
        name = tag.decode("ascii")
        out.append(f"section {name}")
        if tag in (fmt.SECTION_META, fmt.SECTION_PLAN):
            out.append("  json " + body.decode("utf-8"))
        elif tag == fmt.SECTION_WIMG:
            (jlen,) = fmt._U32.unpack_from(body, 0)
            jb = body[4 : 4 + jlen]
            header = json.loads(jb.decode("utf-8"))
            off = 4 + jlen
            n_packed = int(np.prod(header["packed_shape"]))
            n_scale = 4 * header["scale_len"]
            n_thr = 4 * header["thr_len"]
            out.append(_image_comment(header))
            out.append("  json " + jb.decode("utf-8"))
            for blob_name, n in (("packed", n_packed), ("scale", n_scale),
                                 ("threshold", n_thr)):
                out.append(f"  blob {blob_name} {n}")
                out.extend(_hex_lines(body[off : off + n]))
                off += n
        else:  # unknown tag: preserve losslessly as one blob
            out.append(f"  blob raw {len(body)}")
            out.extend(_hex_lines(body))
    out.append("")
    return "\n".join(out)


def reassemble(listing: str) -> bytes:
    """Text listing -> ``.cutie`` bytes.  Inverse of `disassemble` for
    unedited listings; re-canonicalizes JSON and recomputes length/CRC, so
    consistent hand-edits also produce a valid artifact."""
    version = fmt.VERSION
    flags = 0
    sections: List[tuple] = []  # (tag, [parts])
    blob_hex: List[str] = []
    blob_declared = -1

    def _close_blob():
        nonlocal blob_hex, blob_declared
        if blob_declared < 0:
            return
        body = bytes.fromhex("".join(blob_hex))
        if len(body) != blob_declared:
            raise fmt.ArtifactError(
                f"blob declares {blob_declared} bytes, hex gives {len(body)}"
            )
        sections[-1][1].append(("blob", body))
        blob_hex, blob_declared = [], -1

    for raw in listing.splitlines():
        line = raw.strip()
        if not line or line.startswith(";"):
            continue
        word = line.split()
        if word[0] == "version":
            _close_blob()
            version = int(word[1])
        elif word[0] == "flags":
            _close_blob()
            flags = int(word[1])
        elif word[0] == "section":
            _close_blob()
            sections.append((word[1].encode("ascii"), []))
        elif word[0] == "json":
            _close_blob()
            obj = json.loads(line[len("json"):].strip())
            sections[-1][1].append(("json", fmt.canonical_json(obj)))
        elif word[0] == "blob":
            _close_blob()
            blob_declared = int(word[2])
            if blob_declared == 0:
                sections[-1][1].append(("blob", b""))
                blob_declared = -1
        else:  # hex continuation line
            blob_hex.append(line)
    _close_blob()

    payload_parts: List[bytes] = []
    for tag, parts in sections:
        if tag == fmt.SECTION_WIMG:
            jb = next(b for k, b in parts if k == "json")
            blobs = [b for k, b in parts if k == "blob"]
            body = fmt._U32.pack(len(jb)) + jb + b"".join(blobs)
        else:
            body = b"".join(b for _, b in parts)
        payload_parts.append(tag + fmt._U32.pack(len(body)) + body)
    payload = b"".join(payload_parts)
    import zlib

    return fmt.HEADER.pack(
        fmt.MAGIC, version, flags, len(payload), zlib.crc32(payload) & 0xFFFFFFFF
    ) + payload
