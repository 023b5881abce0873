"""No run of the benchmark loads JAX or the JAX package, and the
reference imports nothing of the program."""
import ast
import subprocess
import sys

from tinycell import REPO

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.', 1)[0] for m in sys.modules}))"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{REPO}:{REPO}/src",
             "HOME": str(REPO)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys; sys.path.insert(0, 'portbench/tests')\n"
        "from pathlib import Path\n"
        "import tinycell\n"
        f"base = tinycell.make(Path({str(tmp_path)!r}))\n"
        "rc, res = tinycell.run(base, 'musicbrainz.tiny', 3, trace=1)\n"
        "assert rc == 0 and res['correct'], res\n"
        "rc, res = tinycell.run(base, 'snowflake.tiny_heuristic', 4)\n"
        "assert rc == 0 and res['correct'], res\n"
        "import portbench.control, portbench.manifest as m, json\n"
        "bench = json.loads(Path('BENCHMARK.json').read_text())\n"
        "m.validate(bench)\n"
        "for c in bench['workloads']:\n"
        "    cell = m.Cell(bench, c['name'])\n"
        "    cell.driver(); cell.generator()\n"
        "    cell.readers(True); cell.readers(False)\n")
    top = _loaded(code)
    assert "repro_torch" in top and "torch" in top
    assert not top & set(FORBIDDEN), sorted(top & set(FORBIDDEN))


def test_the_reference_imports_nothing_of_the_program():
    top = _loaded("import portbench.reference.exact, "
                  "portbench.reference.plans, portbench.reference.greedy, "
                  "portbench.reference.costmodel, portbench.check")
    assert "repro_torch" not in top and not top & set(FORBIDDEN)
    for path in (REPO / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] in ("numpy", "__future__"), \
                    f"{path.name} imports {n}"


def test_the_check_names_forbidden_modules_whole():
    from portbench.run import forbidden_modules
    before = set(sys.modules)
    sys.modules["repro_torch_lookalike"] = sys
    try:
        assert "repro_torch_lookalike" not in forbidden_modules()
        sys.modules["repro.core"] = sys
        assert "repro.core" in forbidden_modules()
    finally:
        for k in set(sys.modules) - before:
            del sys.modules[k]
