"""The port's examples, ``examples/quickstart_torch.py`` and
``examples/query_service_torch.py``, run with ``--device cpu`` in
subprocesses beside the reference's ``examples/quickstart.py`` and
``examples/query_service.py``: every printed cost, ``algo`` string and
row count equals the reference's line for line (the explain payload
too), and a second service run on the port's saved plan cache answers
every exact-tier query from the cache with the same lines.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
QUERY = re.compile(r"^Q(\d+): n=\s*(\d+) algo=(\S+)\s+cost=\s*(\S+) "
                   r"exec=\s*\S+ms rows=(\d+)")


def start(script, *args):
    # one torch thread and one BLAS thread a process: the suite runs in
    # several workers at once
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, str(ROOT / "examples" / script),
                             *args], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def finish(proc) -> str:
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        proc.kill()
    assert proc.returncode == 0, out + err
    return out


def queries(out: str) -> list:
    """(index, n, algo, cost as printed, rows) of each query line."""
    return [m.groups() for m in map(QUERY.match, out.splitlines()) if m]


def test_quickstart_matches_reference():
    procs = [start("quickstart.py"), start("quickstart_torch.py",
                                           "--device", "cpu")]
    want, got = (finish(p) for p in procs)
    # every line but the 14-relation query's host wall
    mask = (lambda s: re.sub(r"wall=\S+", "wall=", s))
    assert mask(got).splitlines() == mask(want).splitlines()
    assert "algo=mpdp_tree" in got and "DPCCP oracle agrees" in got


def test_query_service_matches_reference_and_cache_serves_hits(tmp_path):
    cache = str(tmp_path / "plans.plancache")
    procs = [start("query_service.py", "--queries", "3", "--explain"),
             start("query_service_torch.py", "--queries", "3", "--explain",
                   "--device", "cpu", "--pipeline", "--cache-file", cache)]
    want, got = (finish(p) for p in procs)
    assert len(queries(want)) == 3 and queries(got) == queries(want)
    assert [q[2] for q in queries(got)] == \
        ["batch_mpdp_tree", "batch_mpdp_tree", "uniondp_mpdp+reopt"]
    explain = (lambda s: [ln for ln in s.splitlines()
                          if ln.startswith(("explain", "  round",
                                            "  re-optimization"))])
    assert explain(got) and explain(got) == explain(want)
    assert "plan cache 0 hits / 2 misses" in got
    assert "flights (pipelined engines" in got
    again = finish(start("query_service_torch.py", "--queries", "3",
                         "--device", "cpu", "--pipeline", "--cache-file",
                         cache))
    assert "(2 entries)" in again and "plan cache 2 hits / 0 misses" in again
    hits = [(i, n, f"cache[{algo}]" if int(n) <= 14 else algo, cost, rows)
            for i, n, algo, cost, rows in queries(want)]
    assert queries(again) == hits


def test_query_service_devices_matches_reference():
    """``--devices 2``: the exact limit rises to 18, so the 16-relation
    query runs exact on a 2-shard mesh in both packages."""
    procs = [start("query_service.py", "--queries", "3", "--devices", "2"),
             start("query_service_torch.py", "--queries", "3", "--devices",
                   "2", "--device", "cpu")]
    want, got = (finish(p) for p in procs)
    assert len(queries(want)) == 3 and queries(got) == queries(want)
    assert not any("uniondp" in q[2] for q in queries(got))


def test_examples_without_a_card_raise():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    procs = [start(s) for s in ("quickstart_torch.py", "query_service_torch.py")]
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=TIMEOUT_S)
            assert proc.returncode != 0 and "device='cpu'" in err, out + err
    finally:
        for proc in procs:
            proc.kill()
