"""The port stands alone: no module of omnia_tpu_torch (nor chip_smoke.py)
imports jax or omnia_tpu, nor a package the card's machine lacks
(safetensors, transformers, ml_dtypes), and its kernel builder raises
where it cannot build rather than handing back a plain version."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from omnia_tpu_torch import kernels

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "omnia_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


FORBIDDEN = ("jax", "jaxlib", "omnia_tpu", "safetensors", "transformers", "ml_dtypes")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("module", [
    "omnia_tpu_torch.engine.prefix_cache", "omnia_tpu_torch.engine.tokenizer",
    "omnia_tpu_torch.engine.grammar", "omnia_tpu_torch.engine.grammar.cache",
    "omnia_tpu_torch.engine.grammar.fsm", "omnia_tpu_torch.engine.grammar.jsonfsm",
    "omnia_tpu_torch.engine.grammar.regex", "omnia_tpu_torch.engine.faults",
    "omnia_tpu_torch.engine.flight", "omnia_tpu_torch.engine.coldstart",
    "omnia_tpu_torch.engine.devloop", "omnia_tpu_torch.utils.metrics",
])
def test_port_keeps_its_own_copies(module):
    """The modules the port copies from jax-free parts of the JAX package
    are its own, and the two checks above cover them."""
    assert module in MODULES


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(MODULES) >= 22


def test_builder_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "find_nvcc", lambda: None)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    with pytest.raises(kernels.KernelBuildError, match="nvcc not found"):
        kernels.build("decode_attention")


def test_kernel_route_raises_without_nvcc(monkeypatch, tmp_path):
    """The wrapper's kernel route loads the library first; with no nvcc
    that raises, and a tensor on neither the CPU nor a card is refused."""
    import torch

    from omnia_tpu_torch.ops import decode_attention as tda

    monkeypatch.setattr(kernels, "find_nvcc", lambda: None)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_loaded", {})
    with pytest.raises(kernels.KernelBuildError):
        tda._lib()
    q = torch.zeros(1, 2, 16, device="meta")
    kv = torch.zeros(1, 8, 1, 16, device="meta")
    pos = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no decode-attention kernel"):
        tda.decode_gqa_attention(q, kv, kv, pos)
