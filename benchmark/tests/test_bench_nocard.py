"""The harness refuses to measure without a card, and prints no result;
on the card, it fails in a directory that holds only the benchmark."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness

ARGS = ["--workload", harness.manifest()["workloads"][0]["name"],
        "--seed", "3000000001",
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=env)


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(harness.ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_require_card_counts_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    harness.require_card(1)
    with pytest.raises(harness.NoCard):
        harness.require_card(4)


@pytest.mark.card
def test_fails_without_the_program(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
