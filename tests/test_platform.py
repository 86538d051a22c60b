"""Implementation choice by platform (``vaq_tpu.ops.platform``), and the
absence of any TPU-only kernel route from the package."""

import ast
import os

import pytest

from vaq_tpu.ops import platform

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("op,plat,want", [
    ("codes_window_scan", "gpu", "triton"),
    ("codes_window_scan", "cpu", "xla"),
    ("lut_scan", "gpu", "codes"),
    ("lut_scan", "cpu", "gather"),
])
def test_choose_by_platform(op, plat, want):
    assert platform.choose(op, plat) == want


def test_choose_defaults_to_jax_backend(monkeypatch):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert platform.choose("codes_window_scan") == "triton"
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert platform.choose("codes_window_scan") == "xla"


def test_unknown_op_is_an_error():
    with pytest.raises(KeyError):
        platform.choose("no_such_op", "gpu")


def _python_files():
    for sub in ("vaq_tpu", "scripts"):
        for dirpath, _, files in os.walk(os.path.join(ROOT, sub)):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(dirpath, f)
    for f in ("bench.py", "chip_smoke.py"):
        yield os.path.join(ROOT, f)


def test_no_pallas_tpu_imports():
    """Nothing the program runs imports the Mosaic-TPU Pallas module."""
    bad = []
    for path in _python_files():
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module + "." + a.name for a in node.names]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            if any(n.startswith("jax.experimental.pallas.tpu")
                   for n in names):
                bad.append(f"{os.path.relpath(path, ROOT)}:{node.lineno}")
    assert not bad, bad


def test_interpret_mode_only_in_tests():
    """No library code passes interpret=True to a kernel: interpret mode is
    for tests on the CPU."""
    bad = []
    for path in _python_files():
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == "interpret" and not (
                            isinstance(kw.value, ast.Name)
                            and kw.value.id == "interpret"):
                        bad.append(
                            f"{os.path.relpath(path, ROOT)}:{node.lineno}")
    assert not bad, bad
