"""The PyTorch port stands alone: no JAX, Flax, Optax or `bsarec_tpu`
import anywhere in `bsarec_tpu_torch/` or in `chip_smoke.py`."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "bsarec_tpu")
PORT_FILES = sorted((ROOT / "bsarec_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_import_port_loads_no_jax():
    code = (
        "import sys, bsarec_tpu_torch, bsarec_tpu_torch.main, bsarec_tpu_torch.ops.rank, "
        "bsarec_tpu_torch.ops.dropout, bsarec_tpu_torch.models.sasrec, "
        "bsarec_tpu_torch.serving, bsarec_tpu_torch.serve, bsarec_tpu_torch.ops.serving_topk, "
        "bsarec_tpu_torch.preprec.main, bsarec_tpu_torch.preprec.jax_import, "
        "bsarec_tpu_torch.preprec.preprocess, bsarec_tpu_torch.preprec.serving, "
        "bsarec_tpu_torch.preprec.sampler, bsarec_tpu_torch.preprec.evaluate; "
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}); "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
