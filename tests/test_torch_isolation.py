"""The port stands alone: no module of ``orleans_tpu_torch`` imports JAX or
anything of ``orleans_tpu``, and its engine never carries on silently on
the CPU.  Checked in a fresh interpreter, since this test process has both
packages loaded."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import orleans_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    orleans_tpu_torch.__path__, "orleans_tpu_torch."))
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "orleans_tpu" or m.startswith("orleans_tpu."))
import torch
from orleans_tpu_torch.tensor.engine import TensorEngine
try:
    TensorEngine()
    default = "constructed"
except RuntimeError:
    default = "raised"
print(json.dumps({"modules": names, "leaked": leaked, "default": default,
                  "cuda": torch.cuda.is_available()}))
"""


def _probe():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_neither_jax_nor_orleans_tpu():
    report = _probe()
    expected = {
        "orleans_tpu_torch.hashing", "orleans_tpu_torch.ids",
        "orleans_tpu_torch.core.grain", "orleans_tpu_torch.config",
        "orleans_tpu_torch.device", "orleans_tpu_torch.kernels._build",
        "orleans_tpu_torch.kernels.resolve",
        "orleans_tpu_torch.kernels.scatter",
        "orleans_tpu_torch.kernels.segment",
        "orleans_tpu_torch.kernels.hist", "orleans_tpu_torch.kernels.miss",
        "orleans_tpu_torch.kernels.attr",
        "orleans_tpu_torch.tensor.attribution",
        "orleans_tpu_torch.tensor.ledger", "orleans_tpu_torch.tensor.fused",
        "orleans_tpu_torch.tensor.autofuse",
        "orleans_tpu_torch.tensor.vector_grain",
        "orleans_tpu_torch.tensor.arena", "orleans_tpu_torch.tensor.engine",
        "orleans_tpu_torch.samples.presence", "orleans_tpu_torch.convert",
        "orleans_tpu_torch.kernels.fanout", "orleans_tpu_torch.tensor.fanout",
        "orleans_tpu_torch.samples.presence_wide",
        "orleans_tpu_torch.samples.chirper",
        "orleans_tpu_torch.tensor.persistence",
        "orleans_tpu_torch.tensor.timers_plane",
        "orleans_tpu_torch.kernels.lifecycle",
        "orleans_tpu_torch.kernels.timers",
        "orleans_tpu_torch.samples.auction",
        "orleans_tpu_torch.samples.watchdog",
        "orleans_tpu_torch.kernels.pull",
        "orleans_tpu_torch.tensor.streams_plane",
        "orleans_tpu_torch.samples.streams",
        "orleans_tpu_torch.kernels.replicas",
        "orleans_tpu_torch.samples.routing",
        "orleans_tpu_torch.samples.gpstracker",
        "orleans_tpu_torch.samples.twitter_sentiment",
        "orleans_tpu_torch.kernels.checkpoint",
        "orleans_tpu_torch.tensor.checkpoint",
        "orleans_tpu_torch.samples.banking",
        "orleans_tpu_torch.kernels.exchange",
        "orleans_tpu_torch.tensor.exchange",
        "orleans_tpu_torch.tensor.mesh"}
    assert expected <= set(report["modules"])
    assert report["leaked"] == []
    # no card here: the default device must refuse, not fall back
    if not report["cuda"]:
        assert report["default"] == "raised"
    else:
        assert report["default"] == "constructed"


def test_chip_smoke_imports_nothing_of_jax():
    src = (REPO / "chip_smoke.py").read_text()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "orleans_tpu",
                                                  "samples"), line


def test_trace_script_imports_nothing_of_jax():
    """``trace_hot_grain.py`` runs on the card beside the smoke: torch,
    numpy, the port and the smoke's helpers only."""
    src = (REPO / "trace_hot_grain.py").read_text()
    imported = set()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            imported.add(words[1].split(".")[0])
    assert imported <= {"__future__", "gc", "json", "sys", "types",
                        "collections", "numpy", "torch", "chip_smoke",
                        "orleans_tpu_torch"}, imported
    assert "orleans_tpu_torch" in imported


@pytest.mark.parametrize("script", ["probe_k9_k22.py", "probe_k2_k7.py",
                                    "probe_k4_k8.py", "probe_k1_k3.py",
                                    "probe_k5_k24.py", "probe_k6_k11.py",
                                    "probe_k10_k8.py"])
def test_probe_scripts_import_nothing_of_jax(script):
    """The kernel probes run on the card beside the smoke, on the parent
    tree too: the standard library, torch, numpy, the port and the
    smoke's helpers only."""
    imported = set()
    for line in (REPO / script).read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            imported.add(words[1].split(".")[0])
    assert imported <= {"__future__", "asyncio", "json", "sys", "numpy",
                        "torch", "chip_smoke", "trace_hot_grain",
                        "orleans_tpu_torch"}, imported
