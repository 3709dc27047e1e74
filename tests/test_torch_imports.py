"""Import discipline of the port: nothing under ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro`` (the port keeps
its own copies), the planning loop (``repro_torch.core``) imports no
``torch``, and no kernel wrapper catches a failed launch to fall back to
the plain version."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "repro")


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


CORE_FILES = sorted((ROOT / "src" / "repro_torch" / "core").glob("*.py"))


@pytest.mark.parametrize("path", CORE_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_planning_loop_is_pure_python(path):
    """The planner (``repro_torch.core``) imports no ``torch``, as the
    reference's imports no ``jax``."""
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] == "torch" or m.startswith("repro_torch.")
           and not m.startswith(("repro_torch.core", "repro_torch.models."
                                 "config"))]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_planning_loop_has_its_modules():
    assert [p.stem for p in CORE_FILES] == [
        "__init__", "assistants", "cost_model", "graph", "graphgen",
        "multilevel", "partitioner", "plan", "plan_cache", "planner",
        "topology"]


def test_import_check_catches_offenders(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom repro.models import lm\n"
                     "from repro_torch.models import lm as tlm\n"
                     "from . import sibling\n")
    assert [m for m in _imported_modules(probe)
            if m.split(".")[0] in FORBIDDEN] == ["jax.numpy", "repro.models"]


def test_kernel_wrappers_have_no_fallback_around_the_launch():
    """Every kernel the build compiles has an ``ops.py`` beside its source,
    and none wraps code in ``try``."""
    from repro_torch.kernels import _build
    kernels_dir = ROOT / "src" / "repro_torch" / "kernels"
    ops_files = sorted(kernels_dir.rglob("ops.py"))
    assert ops_files == sorted(src.parent / "ops.py"
                               for src in _build.SOURCES.values())
    assert set(_build.SOURCES) >= {"paged_attention", "flash_attention",
                                   "ssd_scan"}
    for path in ops_files:
        tree = ast.parse(path.read_text())
        tries = [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
        assert not tries, f"{path.relative_to(ROOT)} wraps code in try:"
