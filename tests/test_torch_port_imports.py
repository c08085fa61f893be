"""The PyTorch port stands alone: no JAX, Flax, Optax or `bsarec_tpu`
import anywhere in `bsarec_tpu_torch/` or in `chip_smoke.py`, and no
file of the JAX package named in their code or loaded by them (its
`native/_seqrec.so` included: the port builds its own library)."""

import ast
import re
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
        "bsarec_tpu_torch.preprec.sampler, bsarec_tpu_torch.preprec.evaluate, "
        "bsarec_tpu_torch.core.mesh, bsarec_tpu_torch.parallel.logits, "
        "bsarec_tpu_torch.parallel.embedding, bsarec_tpu_torch.data.multihost; "
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}); "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_mesh_worker_loads_no_jax():
    """The spawned ranks of `tests/test_torch_port_mesh.py` run
    `tests/test_torch_port_mesh_worker.py`, which imports the port alone:
    no module of JAX or of the JAX package, once its cases' modules are in."""
    code = (
        "import sys; sys.path.insert(0, 'tests'); import test_torch_port_mesh_worker; "
        "import bsarec_tpu_torch.train.trainer, bsarec_tpu_torch.parallel.logits; "
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}); "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


# a path component `bsarec_tpu`, or the JAX package's native library
JAX_PATH = re.compile(r"(?<![\w.])bsarec_tpu(?!\w)|_seqrec\.so")
# `file:line` citations of a JAX kernel (chip_smoke.py's "replaces" fields)
CITATION = re.compile(r"^bsarec_tpu/[\w/]+\.py:\d+$")


def _code_strings(path: Path):
    """The string constants of `path` that are not docstrings."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            first = node.body[0] if node.body else None
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    return [(node.lineno, node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_names_no_jax_package_path(path):
    named = [(line, text) for line, text in _code_strings(path)
             if JAX_PATH.search(text) and not CITATION.match(text)]
    assert not named, named


def test_native_paths_load_nothing_of_the_jax_package(tmp_path):
    """The host paths that reach the native library, run in a fresh
    process: no module of the JAX package is imported and no file under
    `bsarec_tpu/` is mapped into the process."""
    (tmp_path / "toy.txt").write_text("1 3 4 5\n2 4 5 6 7\n3 1 2\n")
    (tmp_path / "toy_intwtime.csv").write_text("0,2,1,3,100\n0,1,1,3,200\n0,3,1,3,300\n1,0,2,4,50\n1,2,2,4,90\n")
    code = (
        "import sys; import numpy as np; "
        "from bsarec_tpu_torch import native; "
        "from bsarec_tpu_torch.data.corpus import load_corpus; "
        "from bsarec_tpu_torch.data.pipeline import SeqRecData; "
        "from bsarec_tpu_torch.ops.rank import build_seen_bitmask; "
        "from bsarec_tpu_torch.preprec.data import load_intwtime; "
        "assert native.lib() is not None; "
        f"data = SeqRecData(load_corpus({str(tmp_path / 'toy.txt')!r}), 4); "
        "build_seen_bitmask(data.test.seen_items, 8); "
        "data.sample_same_target(np.random.default_rng(0)); "
        f"load_intwtime({str(tmp_path / 'toy_intwtime.csv')!r}, 3); "
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}); "
        "assert not bad, bad; "
        f"jax_pkg = {str(ROOT / 'bsarec_tpu')!r} + '/'; "
        "maps = [l for l in open('/proc/self/maps') if jax_pkg in l]; "
        "assert not maps, maps"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
