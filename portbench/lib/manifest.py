"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``, data), the driver the mix names
(``drivers/<driver>.py``), its limits (``limits/<cell>.json``) and each
per-layer metric's reader (``metrics/<metric>.py``)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List


def _load(path: Path, prefix: str):
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """``root`` is a checkout's root; the benchmark's files are under
    ``root/portbench``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, cell: Dict) -> Dict:
        for c in self.data["configs"]:
            if c["name"] == cell["config"]:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config named {cell['config']!r}")

    def traffic(self, cell: Dict) -> Dict:
        return json.loads((self.dir / "traffic" / f"{cell['traffic']}.json")
                          .read_text())

    def limits(self, cell: Dict) -> Dict:
        return json.loads((self.dir / "limits" / f"{cell['name']}.json")
                          .read_text())

    @staticmethod
    def _applies(metric: Dict, cell: Dict) -> bool:
        return "workloads" not in metric or cell["name"] in metric["workloads"]

    def end_to_end(self, cell: Dict) -> List[Dict]:
        return [m for m in self.data["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: Dict) -> List[Dict]:
        return [m for m in self.data["per_layer"] if self._applies(m, cell)]

    def driver(self, mix: Dict):
        """The module ``drivers/<driver>.py`` that the mix names."""
        return _load(self.dir / "drivers" / f"{mix['driver']}.py",
                     "portbench_driver_")

    def reader(self, name: str):
        """The ``read(ctx)`` function of ``metrics/<name>.py``."""
        return _load(self.dir / "metrics" / f"{name}.py",
                     "portbench_metric_").read
