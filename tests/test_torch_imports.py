"""The port imports neither ``jax`` nor the reference package ``repro``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

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
                "repro_torch.core.memsys",
                "repro_torch.core.perf_model", "repro_torch.models.ssm",
                "repro_torch.kernels.ssm_scan", "repro_torch.core.paging",
                "repro_torch.core.faults", "repro_torch.core.weight_store"):
        assert mod in report["modules"]
