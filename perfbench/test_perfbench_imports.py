"""No module under ``perfbench/`` imports JAX or the JAX package
(``repro``), and the reference imports nothing of the program: each
import's top-level name, the part before the first dot, compared whole."""
import ast

from perfbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(spec.HERE.rglob("*.py"))
    assert files
    for f in files:
        bad = set(_imports(f)) & FORBIDDEN
        assert not bad, (f, bad)


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((spec.HERE / "reference").rglob("*.py")):
        assert "repro_torch" not in set(_imports(f)), f


def test_the_program_name_is_not_taken_for_the_jax_package():
    # the port's name begins with the JAX package's: compared whole
    assert "repro_torch".split(".")[0] not in FORBIDDEN
