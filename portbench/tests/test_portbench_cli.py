"""The command as the driver runs it: no result without a card, or
without the program beside the benchmark; on a card, a result line."""
import json
import shutil
import subprocess
import sys

import pytest

from tinycell import REPO

ARGS = ["--workload", "snowflake.q12_16", "--seed", "4294967311",
        "--seconds", "3", "--trace", "0"]


def _run(cwd, timeout=600):
    return subprocess.run([sys.executable, "-m", "portbench.run", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env={"PATH": "/usr/bin:/bin",
                                                "HOME": str(cwd)})


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = _run(REPO)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(REPO, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"queries_per_s", "latency_p95_ms",
                                   "setup_s"}
    assert list(res)[-1] == "checks"
