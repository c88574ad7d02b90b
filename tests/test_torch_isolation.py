"""The PyTorch port stands alone: no module of ``zipkin_tpu_torch`` and
not ``chip_smoke.py`` imports JAX or the JAX package."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "zipkin_tpu")


def _sources():
    files = sorted((ROOT / "zipkin_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_imports(path):
    assert path.exists(), path
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imported(tree) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_without_jax():
    import subprocess
    import sys

    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['zipkin_tpu'] = None; "
            "import zipkin_tpu_torch.store.torch_store, "
            "zipkin_tpu_torch.store.convert, zipkin_tpu_torch.tracegen, "
            "zipkin_tpu_torch.store.pipeline, zipkin_tpu_torch.store.mirror, "
            "zipkin_tpu_torch.store.analytics, "
            "zipkin_tpu_torch.aggregate.windows, zipkin_tpu_torch.obs")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
