"""No source of the benchmark imports JAX or the JAX package, and the plain
references import nothing of the port.  Module names are compared by their
top-level name (the part before the first dot) whole: the port's name,
``machisplin_tpu_torch``, begins with the JAX package's."""
import ast
import os
import subprocess
import sys

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "machisplin_tpu"}
PORT = "machisplin_tpu_torch"


def _sources():
    for dirpath, dirnames, files in os.walk(PB):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_top_level_names_compare_whole():
    assert PORT.split(".")[0] not in FORBIDDEN and PORT.startswith("machisplin_tpu")


def test_no_source_imports_jax_or_the_jax_package():
    found = {p: sorted(set(_top_level_imports(p)) & FORBIDDEN) for p in _sources()}
    assert not {p: f for p, f in found.items() if f}
    assert len(found) > 10


def test_references_import_nothing_of_the_port():
    refs = [p for p in _sources() if os.sep + "reference" + os.sep in p]
    assert refs
    for p in refs:
        names = set(_top_level_imports(p))
        assert PORT not in names and not names & FORBIDDEN, p
        assert names <= {"__future__", "dataclasses", "math", "torch", "numpy"}, (p, names)


def test_importing_a_reference_loads_no_port_module():
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.tps_nystrom; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))" % (os.path.dirname(PB), FORBIDDEN | {PORT}))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr
