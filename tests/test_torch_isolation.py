"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and an entry point called without
``device=`` on a machine without a GPU raises instead of carrying on on the
CPU."""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert, device, rotations, search
from repro_torch.data import synthetic
from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)\b(?!_))",
    re.MULTILINE)


def test_port_files_exist():
    assert len(PORT_FILES) > 20
    assert all(p.is_file() for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_forbidden_pattern_is_word_bounded():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from repro.index import ivf")
    assert FORBIDDEN.search("    from repro import quant")
    assert not FORBIDDEN.search("from repro_torch.index import ivf")
    assert not FORBIDDEN.search("import repro_torch")


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.generator(0)
    g = device.generator(0, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic.sift_like(g, 10, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rotations.make("gcd_greedy").init(8)
    X = synthetic.sift_like(g, 300, 8, device="cpu")
    cfg = search.SearchConfig(num_lists=2, subspaces=2, codewords=4,
                              block_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        search.make("ivf").build(g, X, torch.eye(8), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.gcd_state_from_numpy({"R": np.eye(4)})


def test_generator_must_match_device():
    g = device.generator(0, "cpu")
    with pytest.raises(ValueError):
        device.check_generator(g, torch.device("cuda"))
    with pytest.raises(ValueError):
        device.resolve("meta")


def test_kernel_build_needs_nvcc(monkeypatch):
    """Without the CUDA toolkit the build raises; nothing falls back."""
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "CUDA_ROOTS", ())
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
