"""Nothing under bench/ imports JAX or the JAX package, compared by whole
top-level names (``repro_torch`` is the port, ``repro`` is not), and the
reference imports nothing of the port either."""

import ast

from _bench_util import ROOT

JAX_SIDE = {"jax", "jaxlib", "flax", "repro", "hydra"}
PORT = {"repro_torch", "hydra_torch"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _files(sub=""):
    return sorted((ROOT / "bench" / sub).rglob("*.py"))


def test_top_level_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.api\nfrom hydra_torch import x\n"
                 "import jaxtyping\n")
    assert not top_level_imports(f) & JAX_SIDE
    f.write_text("from repro.models import api\n")
    assert top_level_imports(f) & JAX_SIDE == {"repro"}
    f.write_text("import jax.numpy as jnp\n")
    assert top_level_imports(f) & JAX_SIDE == {"jax"}


def test_bench_imports_no_jax_side():
    assert _files()
    for f in _files():
        assert not top_level_imports(f) & JAX_SIDE, f


def test_reference_imports_nothing_of_the_port():
    files = _files("reference")
    assert files
    for f in files:
        assert not top_level_imports(f) & (JAX_SIDE | PORT), f
        assert top_level_imports(f) <= {"__future__", "contextlib", "math",
                                        "torch"}, f
