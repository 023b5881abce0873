"""The port stands alone: importing it loads neither JAX nor the reference.

Checked in a fresh interpreter (``sys.modules``) and in the text of every
source file of ``src/repro_torch``, of the port's examples
(``examples/*_torch.py``) and of ``chip_smoke.py``.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PKG.rglob("*.py"))
DRYRUN = {"repro_torch.launch.dryrun", "repro_torch.launch.roofline",
          "repro_torch.launch.report", "repro_torch.distributed.ctx"}


def test_module_list_covers_the_port():
    assert "repro_torch.core.batch" in MODULES
    assert "repro_torch.kernels.ops" in MODULES
    heuristics = {f"repro_torch.heuristics.{m}" for m in
                  ("common", "goo", "idp", "ikkbz", "geqo", "lindp", "uniondp")}
    assert heuristics <= set(MODULES), heuristics - set(MODULES)
    service = {f"repro_torch.core.{m}" for m in
               ("telemetry", "plancache", "service", "faults", "policy")}
    assert service <= set(MODULES), service - set(MODULES)
    daemon = {"repro_torch.daemon"} | {f"repro_torch.daemon.{m}" for m in
                                       ("protocol", "client", "server",
                                        "__main__")}
    assert daemon <= set(MODULES), daemon - set(MODULES)
    sharding = {"repro_torch.hostdev", "repro_torch.distributed",
                "repro_torch.distributed.sharding",
                "repro_torch.distributed.collectives",
                "repro_torch.core.shard", "repro_torch.core.lattice"}
    assert sharding <= set(MODULES), sharding - set(MODULES)
    execution = {"repro_torch.execution", "repro_torch.execution.executor"}
    assert execution <= set(MODULES), execution - set(MODULES)
    lm = {f"repro_torch.models.{m}" for m in
          ("api", "layers", "transformer", "ssm", "griffin", "encdec")} | \
        {f"repro_torch.configs.{m}" for m in ("base", "gemma3_12b")} | \
        {"repro_torch.launch.serve"}
    assert lm <= set(MODULES), lm - set(MODULES)
    train = {f"repro_torch.train.{m}" for m in
             ("optimizer", "data", "checkpoint")} | \
        {"repro_torch.train", "repro_torch.tree", "repro_torch.launch.train",
         "repro_torch.launch.mesh"}
    assert train <= set(MODULES), train - set(MODULES)
    assert DRYRUN <= set(MODULES), DRYRUN - set(MODULES)
    assert len(MODULES) >= 76


def test_import_leaves_jax_and_reference_unloaded():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(len(sys.modules), bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sharding_modules_load_alone():
    """The sharding slice's modules, imported on their own in a fresh
    interpreter, load neither JAX nor the reference, and
    ``repro_torch.hostdev`` needs only the standard library."""
    code = ("import sys\n"
            "import repro_torch.hostdev\n"
            "assert 'torch' not in sys.modules and 'numpy' not in sys.modules\n"
            "import repro_torch.core.shard, repro_torch.core.lattice\n"
            "import repro_torch.distributed.collectives\n"
            "import repro_torch.distributed.sharding\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_executor_loads_alone():
    """``repro_torch.execution.executor``, imported on its own in a fresh
    interpreter, loads neither JAX nor the reference."""
    code = ("import sys\n"
            "import repro_torch.execution.executor\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_serving_modules_load_alone():
    """The LM serving path (``repro_torch.models.api``, every family, every
    config and ``repro_torch.launch.serve``), imported on its own in a
    fresh interpreter, loads neither JAX nor the reference."""
    code = ("import sys\n"
            "import repro_torch.models.api as api, repro_torch.launch.serve\n"
            "import repro_torch.models.transformer, repro_torch.models.ssm\n"
            "import repro_torch.models.griffin, repro_torch.models.encdec\n"
            "for a in api.ARCH_IDS:\n"
            "    api.build_model(api.get_config(a))\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_training_modules_load_alone():
    """The training path (``repro_torch.train.*``, ``repro_torch.launch.
    train`` and ``repro_torch.launch.mesh``), imported on its own in a
    fresh interpreter, loads neither JAX, ``ml_dtypes`` nor the
    reference."""
    code = ("import sys\n"
            "import repro_torch.launch.train, repro_torch.launch.mesh\n"
            "import repro_torch.train.optimizer, repro_torch.train.data\n"
            "import repro_torch.train.checkpoint\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
            "or m.startswith('ml_dtypes'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_dryrun_modules_load_alone():
    """The dry-run tooling (``repro_torch.launch.dryrun``, ``roofline``,
    ``report`` and ``repro_torch.distributed.ctx``), imported on its own
    in a fresh interpreter, loads neither JAX, ``ml_dtypes`` nor the
    reference."""
    code = ("import sys\n"
            f"for m in {sorted(DRYRUN)!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
            "or m.startswith('ml_dtypes'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_name_no_jax_and_import_no_reference():
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert {f.name for f in examples} >= {"quickstart_torch.py",
                                          "query_service_torch.py",
                                          "serve_lm_torch.py",
                                          "train_tiny_lm_torch.py"}
    files = sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu")) + \
        examples + [ROOT / "chip_smoke.py"]
    names = {f.relative_to(PKG).as_posix() for f in files if PKG in f.parents}
    assert {"hostdev.py", "distributed/sharding.py",
            "distributed/collectives.py", "core/shard.py",
            "core/lattice.py", "execution/executor.py", "models/api.py",
            "models/layers.py", "models/transformer.py", "models/ssm.py",
            "models/griffin.py", "models/encdec.py", "configs/base.py",
            "launch/serve.py", "launch/train.py", "launch/mesh.py",
            "train/optimizer.py", "train/data.py", "train/checkpoint.py",
            "tree.py", "launch/dryrun.py", "launch/roofline.py",
            "launch/report.py", "distributed/ctx.py"} <= names
    for f in files:
        text = f.read_text()
        assert not re.search(r"\bjax\b", text), f"{f} names jax"
        assert not re.search(r"^\s*(from|import)\s+repro(\.|\s|$)", text,
                             re.MULTILINE), f"{f} imports the reference"
