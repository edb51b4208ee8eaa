"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` begins with ``repro``), and the
reference, the counts and what they import take nothing of the program."""
import ast

import pytest

from pbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PROGRAM = "repro_torch"
FILES = sorted(spec.BENCH_DIR.rglob("*.py"))


def _imports(path):
    """(top-level name, full name) of every import in the file, relative
    imports resolved within ``pbench``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                raise AssertionError(f"{path}: relative import")
            mod = node.module or ""
            out += [(mod.split(".")[0], f"{mod}.{a.name}") for a in
                    node.names]
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(spec.BENCH_DIR)))
def test_no_jax_nor_the_jax_package(path):
    bad = [full for top, full in _imports(path) if top in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def _module_file(name):
    """The file of a ``pbench`` module or package, or None."""
    parts = name.split(".")
    base = spec.BENCH_DIR.joinpath(*parts)
    for p in (base.with_suffix(".py"), base / "__init__.py"):
        if p.exists():
            return p
    return None


def _closure(path):
    """Every ``pbench`` file that ``path`` imports, transitively, with its
    own imports."""
    seen, todo, out = set(), [path], []
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        imps = _imports(p)
        out.append((p, imps))
        for top, full in imps:
            if top != "pbench":
                continue
            for name in (full, full.rsplit(".", 1)[0]):
                f = _module_file(name)
                if f is not None:
                    todo.append(f)
    return out


KEEP_APART = sorted(
    list((spec.BENCH_DIR / "pbench" / "reference").glob("*.py"))
    + list((spec.BENCH_DIR / "pbench" / "counts").glob("*.py"))
    + [spec.BENCH_DIR / "pbench" / n for n in
       ("check.py", "weights.py", "traffic.py", "peaks.py")])


@pytest.mark.parametrize("path", KEEP_APART, ids=lambda p: str(
    p.relative_to(spec.BENCH_DIR)))
def test_reference_and_yardstick_import_nothing_of_the_program(path):
    for p, imps in _closure(path):
        bad = [full for top, full in imps if top == PROGRAM]
        assert not bad, f"{path} reaches {p}, which imports {bad}"
