"""The port stands alone: no file of ``cmlpl_tpu_torch/``, nor
``chip_smoke.py``, nor the data-parallel tests' rank worker imports JAX,
flax, optax or the JAX package."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cmlpl_tpu")
FILES = sorted((ROOT / "cmlpl_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist_worker.py"]


def imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_the_scan_sees_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"chip_smoke.py", "cmlpl_tpu_torch/ops/patch_gather.py",
            "cmlpl_tpu_torch/cli/serve.py",
            "cmlpl_tpu_torch/train/cct.py",
            "cmlpl_tpu_torch/cli/train_backbone.py",
            "cmlpl_tpu_torch/train/supervised.py",
            "cmlpl_tpu_torch/models/zoo.py",
            "cmlpl_tpu_torch/models/msvit.py",
            "cmlpl_tpu_torch/core/mesh.py",
            "tests/torch_dist_worker.py"} <= names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"
