"""The port imports neither ``jax`` nor the reference package ``repro``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=SRC,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    for mod in ("repro_torch.serving.engine", "repro_torch.kernels.build",
                "repro_torch.kernels.qmatmul", "repro_torch.interop",
                "repro_torch.kernels.flash_attention",
                "repro_torch.kernels.neureka_conv",
                "repro_torch.models.mobilenet_v2", "repro_torch.models.moe",
                "repro_torch.models.vlm", "repro_torch.models.encdec",
                "repro_torch.core.memsys",
                "repro_torch.core.perf_model", "repro_torch.models.ssm",
                "repro_torch.kernels.ssm_scan", "repro_torch.core.paging",
                "repro_torch.core.faults", "repro_torch.core.weight_store",
                "repro_torch.optim", "repro_torch.optim.optimizers",
                "repro_torch.launch.steps", "repro_torch.launch.train",
                "repro_torch.data.pipeline", "repro_torch.checkpoint.manager",
                "repro_torch.runtime.trainer", "repro_torch.runtime.monitor",
                "repro_torch.core.tree", "repro_torch.launch.serve"):
        assert mod in report["modules"]


_EXAMPLE_PROBE = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("example", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"bad": bad, "torch": "torch" in sys.modules}))
"""


@pytest.mark.parametrize("example", sorted(
    p.name for p in (ROOT / "examples").glob("*_torch.py")))
def test_port_examples_import_no_jax_and_no_reference(example):
    """Each of the port's examples (``examples/*_torch.py``) runs on the
    port alone."""
    out = subprocess.run([sys.executable, "-c", _EXAMPLE_PROBE,
                          str(ROOT / "examples" / example)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report == {"bad": [], "torch": True}


def test_port_examples_listed():
    names = {p.name for p in (ROOT / "examples").glob("*_torch.py")}
    assert {"quickstart_torch.py", "train_lm_torch.py",
            "serve_paged_torch.py", "xr_pipeline_torch.py"} <= names
