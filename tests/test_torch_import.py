"""The port stands alone: importing every module of
``multiverso_tpu_torch`` pulls in neither JAX nor any module of the
reference package, and ``mv.init`` with no device asks for the card and
raises where there is none (no silent CPU fallback).

The import check runs in a subprocess: this test process already
imported JAX (tests/conftest.py).
"""

import ast
import pathlib
import subprocess
import sys
import time

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "multiverso_tpu_torch"


@pytest.fixture(autouse=True)
def _port_teardown_guard():
    """Every test returns the PORT's role-thread count to its baseline
    (tests/conftest.py guards only the reference's thread registry) and
    leaves the port's flag registry at its defaults."""
    from multiverso_tpu_torch.runtime import thread_roles
    from multiverso_tpu_torch.util import configure
    before = sum(thread_roles.roles_alive().values())
    yield
    configure.reset_flags()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if sum(thread_roles.roles_alive().values()) <= before:
            break
        time.sleep(0.05)
    alive = thread_roles.roles_alive()
    assert sum(alive.values()) <= before, f"port threads leaked: {alive}"


_PROBE = r"""
import importlib, pkgutil, sys
import multiverso_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "jaxlib" or m.startswith("jaxlib.")
             or m == "multiverso_tpu" or m.startswith("multiverso_tpu."))
print(len(names))
print(",".join(bad))
"""


def test_importing_every_port_module_pulls_in_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert int(lines[0]) >= 30, out.stdout
    assert lines[1] == "", f"port imports pulled in: {lines[1]}"


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_port_file_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    for path in files:
        for name in _imported_roots(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "multiverso_tpu"), (
                f"{path.relative_to(REPO)} imports {name}")


def test_init_without_device_needs_a_card():
    import multiverso_tpu_torch as mv
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        mv.init([])
    with pytest.raises(RuntimeError, match="CUDA"):
        mv.init([], device="cuda:0")
