"""The port stands alone: no JAX and nothing of the JAX package.

The card's machine has no JAX, so gpmpc_tpu_torch, chip_smoke.py and the
examples' torch runners (examples/*/*_torch.py) must import neither ``jax``
nor ``gpmpc_tpu`` (numpy-only modules included): checked statically over the
sources, and dynamically in a subprocess where both are blocked.
chip_smoke.py must refuse to run without a CUDA card.
"""

import ast
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE_RUNNERS = sorted(ROOT.glob("examples/*/*_torch.py"))
PORT_SOURCES = sorted((ROOT / "gpmpc_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLE_RUNNERS
BLOCKED = ("jax", "jaxlib", "gpmpc_tpu")


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(BLOCKED))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _run(code, timeout=120):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_smoke_imports_and_cpu_planning_step_with_jax_blocked():
    code = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None  # any import of these now raises
        import importlib.util
        spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        import torch
        cpu = torch.device("cpu")
        from gpmpc_tpu_torch.flagship import flagship_problem, run_steps
        prob = flagship_problem(cpu, torch.float64, n_points=12, bucket=16, nh=3)
        planner, plans, _ = run_steps(prob, cpu, torch.float64, 2)
        smoke.check_plans(plans, prob.spec, finite_info=True)
        loaded = [m for m in sys.modules if m.split(".")[0] in {BLOCKED!r} and sys.modules[m] is not None]
        assert not loaded, loaded
        print("PLANNED", plans[-1][0].tolist())
    """)
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert "PLANNED" in out.stdout


def test_example_runners_import_with_jax_blocked():
    """Each torch example runner loads (not as __main__) with jax and
    gpmpc_tpu blocked, and none of them is loaded by it."""
    assert len(EXAMPLE_RUNNERS) == 6  # every JAX example runner has its torch twin
    code = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        import importlib.util
        for path in {[str(p.relative_to(ROOT)) for p in EXAMPLE_RUNNERS]!r}:
            spec = importlib.util.spec_from_file_location("example", path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        loaded = [m for m in sys.modules if m.split(".")[0] in {BLOCKED!r} and sys.modules[m] is not None]
        assert not loaded, loaded
        print("LOADED")
    """)
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert "LOADED" in out.stdout


def test_chip_smoke_refuses_without_cuda():
    """Without a card the smoke exits non-zero at once, before any build,
    and prints no result."""
    code = textwrap.dedent("""
        import runpy, sys, torch
        assert not torch.cuda.is_available()
        from gpmpc_tpu_torch.ops import _build
        sys.argv = ["chip_smoke.py"]
        try:
            runpy.run_path("chip_smoke.py", run_name="__main__")
        except SystemExit as e:
            print("EXIT", e.code, "BUILT", _build.info.path is not None)
    """)
    out = _run(code, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "EXIT 1 BUILT False" in out.stdout
    assert '"ok": true' not in out.stdout
    assert "is_available() is False" in out.stderr

    t0 = time.perf_counter()
    direct = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True,
                            timeout=60)
    assert direct.returncode != 0
    assert '"ok": true' not in direct.stdout
    assert time.perf_counter() - t0 < 60
