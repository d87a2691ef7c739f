"""What the benchmark's files import, by whole top-level name: nothing of
JAX or the JAX package anywhere, and nothing of the program or the
harness in the plain references."""

import ast
import os
import sys

import pytest

from portbench import harness, registry

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cmlpl_tpu"}


def _files(sub=""):
    root = os.path.join(registry.PKG, sub)
    for d, _, fs in os.walk(root):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(_files()))
def test_no_jax_anywhere(path):
    tops = {m.split(".")[0] for m in _tops(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


@pytest.mark.parametrize("path", sorted(_files("reference")))
def test_references_stand_alone(path):
    for m in _tops(path):
        top = m.split(".")[0]
        assert top not in FORBIDDEN | {"cmlpl_tpu_torch"}, (path, m)
        if top == "portbench":
            assert m.startswith("portbench.reference"), (path, m)


def test_the_runtime_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cmlpl_tpu_torch_fake", object())
    assert "cmlpl_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cmlpl_tpu.train", object())
    assert "cmlpl_tpu" in harness.forbidden_modules()
