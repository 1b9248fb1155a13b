"""Nothing of the benchmark imports JAX or the JAX package ``basd_tpu``,
compared by whole top-level module name (the port ``basd_tpu_torch``
begins with ``basd_tpu``), and the reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "basd_tpu"}


def imported_top_names(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_whole_names_not_prefixes():
    assert imported_top_names(BENCH / "bench.py") & {"basd_tpu_torch"}
    assert not {"basd_tpu_torch"} & FORBIDDEN


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(BENCH)): imported_top_names(p) & FORBIDDEN
             for p in BENCH.rglob("*.py")}
    assert not {k: v for k, v in found.items() if v}


def test_reference_imports_nothing_of_the_port():
    found = {str(p.relative_to(BENCH)): imported_top_names(p)
             & {"basd_tpu_torch", "basd_tpu"}
             for p in (BENCH / "reference").rglob("*.py")}
    assert not {k: v for k, v in found.items() if v}
    imported = {str(p.relative_to(BENCH)): imported_top_names(p)
                for p in (BENCH / "reference").rglob("*.py")}
    assert all(n in {"__future__", "math", "numpy", "torch", "portbench"}
               for names in imported.values() for n in names), imported


def test_loading_the_reference_loads_no_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.step, portbench.reference.loss; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'basd_tpu_torch', 'basd_tpu', 'jax', 'jaxlib', 'flax'}))"
            % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
