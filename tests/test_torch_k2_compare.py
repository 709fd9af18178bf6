"""``probes/k2_compare.py`` on the CPU: another checkout's port loads as
a package of its own beside this one, each side makes the same K2
inputs, and ``check_equal`` holds the two sides' K2 outputs bitwise (and
raises where one differs).  Here the other checkout is this repo itself,
loaded a second time under another name.  The timings need the card:
``main`` raises without one."""

import sys
from pathlib import Path

import pytest
import torch

import rmf_crowdsim_tpu_torch as this
from rmf_crowdsim_tpu_torch.probes import k2_compare
from rmf_crowdsim_tpu_torch.utils import cuda_build

ROOT = Path(__file__).resolve().parent.parent
N = 1024


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def other():
    name = "k2_compare_other_port"
    mods = [m for m in sys.modules if m.split(".")[0] == name]
    assert not mods
    yield k2_compare.load_port(ROOT, name)
    for m in [m for m in sys.modules if m.split(".")[0] == name]:
        del sys.modules[m]


def test_other_port_is_a_package_of_its_own(other):
    import importlib

    ocb = importlib.import_module(f"{other.__name__}.utils.cuda_build")
    assert ocb is not cuda_build
    assert ocb.PKG_DIR == cuda_build.PKG_DIR   # the same checkout here
    assert ocb._LAUNCHERS is not cuda_build._LAUNCHERS
    assert k2_compare.load_port(ROOT, other.__name__) is other


def test_load_port_refuses_a_directory_without_the_port(tmp_path):
    with pytest.raises(FileNotFoundError):
        k2_compare.load_port(tmp_path, "k2_compare_missing_port")
    assert "k2_compare_missing_port" not in sys.modules


def test_both_sides_make_the_same_k2(other):
    cpu = torch.device("cpu")
    a = k2_compare.k2_case(this, cpu, N)
    b = k2_compare.k2_case(other, cpu, N)
    k2_compare.check_equal(a, b)
    b["rec"][0, 0] += 1.0      # the other side's scratch starts elsewhere
    with pytest.raises(AssertionError, match="outputs differ"):
        k2_compare.check_equal(a, b)


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["k2_compare", "--other", str(ROOT)])
    with pytest.raises(RuntimeError, match="is_available"):
        k2_compare.main()
