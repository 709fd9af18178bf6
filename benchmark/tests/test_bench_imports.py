"""What the harness and the reference load, checked in fresh processes."""

import json
import os
import subprocess
import sys

from benchmark import harness

PROBE = """
import json, sys
import benchmark.harness, benchmark.drivers, benchmark.trace, benchmark.yardstick
import benchmark.reference.crowd, benchmark.reference.compare, benchmark.reference.routes
import importlib, pkgutil
for role in ("drivers", "placements", "layouts", "generators", "planners"):
    pkg = importlib.import_module("benchmark." + role)
    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(f"benchmark.{role}.{m.name}")
for m in json.load(open("BENCHMARK.json"))["per_layer"]:
    importlib.import_module("benchmark.metrics." + m["name"])
import rmf_crowdsim_tpu_torch
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REF_PROBE = """
import json, sys
import benchmark.reference.crowd, benchmark.reference.compare, benchmark.reference.routes
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code):
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = _top_level(PROBE)
    assert "rmf_crowdsim_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "rmf_crowdsim_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = _top_level(REF_PROBE)
    assert not mods & {"jax", "jaxlib", "flax", "rmf_crowdsim_tpu",
                       "rmf_crowdsim_tpu_torch"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rmf_crowdsim_tpu_torch_x", sys)
    assert "rmf_crowdsim_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()
