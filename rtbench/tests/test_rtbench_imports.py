"""Nothing that rtbench runs loads JAX or the JAX package, and the
reference imports nothing of the port.  Top-level module names (before
the first dot) are compared whole: the port's name begins with the JAX
package's."""

import ast
import os
import subprocess
import sys

from rtbench.run import FORBIDDEN

RTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(RTBENCH)
PORT = "raytracinginoneweekendincuda_torch"


def loaded_after(code: str) -> set:
    """Top-level names in sys.modules after ``code`` runs in a fresh
    interpreter (this test process may hold JAX through pytest plugins)."""
    probe = code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] " \
                   "for m in sys.modules})))\n"
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert res.returncode == 0, res.stderr[-3000:]
    return set(res.stdout.split("\n")[-2].split())


def test_a_dry_run_loads_no_jax(tiny_root):
    code = ("import io\nfrom rtbench.run import main\n"
            f"assert main(['--workload', 'bouncing_spheres.preview', "
            f"'--seed', '3', '--seconds', '0.1', '--trace', '1'], "
            f"root={tiny_root!r}, device='cpu', out=io.StringIO()) == 0\n"
            "from rtbench import control\n")
    names = loaded_after(code)
    assert PORT in names            # the run did drive the port
    assert not names & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_either_package():
    code = ("import rtbench.reference.tracer, rtbench.reference.world\n"
            "import rtbench.reference.bvh\n"
            "import rtbench.reference.scenes.book1_final\n"
            "import rtbench.reference.scenes.bouncing_spheres\n"
            "import rtbench.roofline.k1\n")
    names = loaded_after(code)
    assert not names & {PORT, *FORBIDDEN}


def test_no_reference_source_names_either_package():
    for folder in ("reference", "roofline"):
        for dirpath, _, files in os.walk(os.path.join(RTBENCH, folder)):
            for f in files:
                if not f.endswith(".py"):
                    continue
                tree = ast.parse(open(os.path.join(dirpath, f)).read())
                for node in ast.walk(tree):
                    mods = []
                    if isinstance(node, ast.Import):
                        mods = [a.name for a in node.names]
                    elif isinstance(node, ast.ImportFrom) and node.module:
                        mods = [node.module] if node.level == 0 else []
                    for m in mods:
                        assert m.split(".")[0] not in {PORT, *FORBIDDEN}, \
                            (f, m)
