"""Nothing the benchmark runs imports JAX, the JAX package, or the repo's
older benches and scripts; the reference imports nothing of the program.
Module names are compared by their whole top-level name: the port's
`mod_extraction_tpu_torch` begins with the JAX package's name."""

import ast
import subprocess
import sys

import pytest

from benchmark.harness.common import BENCH, ROOT, forbidden_modules

BANNED = {"jax", "jaxlib", "flax", "mod_extraction_tpu", "bench", "bench_torch", "chip_smoke", "scripts"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_banned_import(path):
    assert not (top_level_imports(path) & BANNED)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "mod_extraction_tpu_torch" not in top_level_imports(path)


def test_whole_names_compared():
    code = ("import sys; sys.path.insert(0, %r); import mod_extraction_tpu_torch.train.lfo_task; "
            "from benchmark.harness.common import forbidden_modules; print(forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    sys.modules.setdefault("jaxlib_stand_in", None)
    assert "jaxlib" not in forbidden_modules()


def test_a_run_holds_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.harness.train, benchmark.harness.stream, "
            "benchmark.control; import mod_extraction_tpu_torch.export.streaming, "
            "mod_extraction_tpu_torch.train.tbptt_task, mod_extraction_tpu_torch.models.convert; "
            "from benchmark.harness.common import forbidden_modules; print(forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
