"""What the benchmark's modules import: nothing of JAX or of the JAX package
anywhere under ``benchmark/``, and nothing of the program in the reference. The
top-level name of each import is compared whole: the program's package name
begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'acquisition_focus_tpu'}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
        elif isinstance(node, ast.Call) and getattr(node.func, 'attr', '') == 'import_module':
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split('.')[0])
            elif isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                names.add(arg.values[0].value.split('.')[0])
    return names


@pytest.mark.parametrize('path', sorted(BENCH.rglob('*.py')), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize('path', sorted((BENCH / 'reference').rglob('*.py')),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert 'acquisition_focus_tpu_torch' not in top_level_imports(path)


def test_the_check_compares_whole_top_level_names():
    from benchmark import harness
    assert set(harness.FORBIDDEN) == FORBIDDEN
    assert 'acquisition_focus_tpu_torch'.split('.')[0] not in FORBIDDEN
