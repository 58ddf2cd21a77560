"""Nothing under rtbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program either: top-level module names
compared whole (``raytpu_torch`` is the program, ``raytpu`` the JAX
package)."""

import ast
from pathlib import Path

from rtbench.run import BANNED, banned_modules

HERE = Path(__file__).resolve().parents[1]


def _roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 15
    bad = {f"{p.relative_to(HERE)}: {m}" for p in files for m in _roots(p)
           if m in BANNED}
    assert not bad, sorted(bad)


def test_the_reference_imports_nothing_of_the_program():
    roots = set()
    for f in ("reference.py", "reference_textured.py", "scene.py"):
        roots |= set(_roots(HERE / f))
    assert "raytpu_torch" not in roots
    assert roots <= {"__future__", "dataclasses", "math", "typing", "numpy",
                     "torch", "rtbench"}
    # Of the harness, the textured reference takes the plain one alone.
    tree = ast.parse((HERE / "reference_textured.py").read_text())
    own = {(n.module, a.name) for n in ast.walk(tree)
           if isinstance(n, ast.ImportFrom) and n.module.startswith("rtbench")
           for a in n.names}
    assert {m if m != "rtbench" else f"rtbench.{a}" for m, a in own} == {
        "rtbench.reference"}


def test_loaded_modules_are_compared_by_whole_top_level_name():
    assert banned_modules(["raytpu_torch", "raytpu_torch.kernels.fused",
                           "numpy", "jaxtyping", "raytpux"]) == []
    assert banned_modules(["raytpu.render", "jax._src", "flax"]) == [
        "flax", "jax", "raytpu"]
