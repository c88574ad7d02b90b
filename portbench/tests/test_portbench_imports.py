"""Nothing the benchmark runs imports JAX or the JAX package, and the
yardstick (traffic, reference, byte counts) imports nothing of the port.
Module names are compared by their whole top-level name, so the port's
``zipkin_tpu_torch`` is not taken for ``zipkin_tpu``."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "zipkin_tpu"}
YARDSTICK = ("lib/gen.py", "lib/reference.py", "lib/roofline.py",
             "lib/stepbytes.py")


def top_level_imports(path: Path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("rel", YARDSTICK)
def test_yardstick_imports_nothing_of_the_port(rel):
    assert "zipkin_tpu_torch" not in top_level_imports(HERE / rel)
    assert not top_level_imports(HERE / rel) & FORBIDDEN


def test_the_check_compares_whole_top_level_names():
    names = {"zipkin_tpu_torch", "zipkin_tpu_torch.store", "jaxtyping"}
    assert not {n.split(".")[0] for n in names} & FORBIDDEN


def test_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types

    from portbench import run

    monkeypatch.setitem(sys.modules, "zipkin_tpu.store", types.ModuleType("x"))
    assert run.loaded_forbidden() == ["zipkin_tpu.store"]
