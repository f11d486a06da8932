"""`BENCHMARK.json` and the files it names, resolved by name.

A cell names a configuration and a traffic mix.  The configuration's file is
the ``file`` of its ``configs`` entry; the mix is ``traffic/<mix>.json``; the
mix's ``loop`` is ``loops/<loop>.py``; the configuration's ``frames`` is
``sources/<frames>.py`` and its ``system`` (the system under test, which
brings its own comparison with a plain reference of ``reference/``)
``systems/<system>.py``; a metric is ``metrics/<name>.py``.
Modules are loaded from their files, so a name needs only to be a file name.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def check_name(name: str) -> str:
    """A name of the contract: letters, digits, ``_``, ``.``, ``-``; at most 64."""
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def load_module(kind: str, name: str):
    """``cellbench/<kind>/<name>.py`` as a module (loaded once)."""
    check_name(name)
    key = f"cellbench.{kind}.{name}"
    mod = sys.modules.get(key)
    if mod is not None:
        return mod
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload with everything it names, loaded."""

    name: str
    config: Dict
    traffic: Dict
    chips: int
    end_to_end: List[Dict]   # the end-to-end metrics this cell reports
    per_layer: List[Dict]    # the per-layer metrics this cell reports

    def metrics(self, trace: bool) -> List[Dict]:
        return self.per_layer if trace else self.end_to_end


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Spec:
    """A parsed ``BENCHMARK.json`` (``bench``) beside the harness at ``root``."""

    def __init__(self, bench: Dict, root: Path = ROOT):
        self.bench = bench
        self.root = Path(root)

    @staticmethod
    def load(root: Path = ROOT) -> "Spec":
        path = Path(root) / "BENCHMARK.json"
        if not path.is_file():
            raise FileNotFoundError(f"no BENCHMARK.json at {root}")
        return Spec(load_json(path), root)

    def workload(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {[w['name'] for w in self.bench['workloads']]}")

    def config_entry(self, name: str) -> Dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        entry = self.config_entry(name)
        cfg = load_json(self.root / entry["file"])
        if cfg.get("name") != name:
            raise ValueError(f"{entry['file']}: name {cfg.get('name')!r} != {name!r}")
        return cfg

    def traffic(self, name: str) -> Dict:
        return load_json(HERE / "traffic" / f"{check_name(name)}.json")

    def cell(self, name: str) -> Cell:
        w = self.workload(name)
        e2e = [m for m in self.bench["end_to_end"] if _reports(m, name)]
        layer = [m for m in self.bench["per_layer"] if _reports(m, name)]
        return Cell(name=name, config=self.config(w["config"]),
                    traffic=self.traffic(w["traffic"]), chips=int(w["chips"]),
                    end_to_end=e2e, per_layer=layer)

    def resolve_all(self) -> Dict[str, Optional[str]]:
        """Every file the spec names, each loaded once: ``{what: error or None}``."""
        out: Dict[str, Optional[str]] = {}

        def attempt(what, fn):
            try:
                fn()
                out[what] = None
            except Exception as e:  # noqa: BLE001 - reported per entry
                out[what] = f"{type(e).__name__}: {e}"

        for w in self.bench["workloads"]:
            attempt(f"workload {w['name']}", lambda w=w: self._resolve_cell(w["name"]))
        for m in self.bench["end_to_end"] + self.bench["per_layer"]:
            attempt(f"metric {m['name']}", lambda m=m: load_module("metrics", m["name"]).read)
        return out

    def _resolve_cell(self, name: str) -> None:
        cell = self.cell(name)
        loop = load_module("loops", cell.traffic["loop"])
        loop.prepare, loop.drive
        load_module("sources", cell.config["frames"]).make_bank
        system = load_module("systems", cell.config["system"])
        system.build, system.compare, system.control
