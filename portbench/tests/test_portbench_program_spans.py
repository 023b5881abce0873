"""The per-layer readers of the program's own spans (``daemon.queue_ms``,
``engine.phase_a_share``, ``engine.fetch_share``, ``uniondp.host_share``)
on the ``tinycell`` copy, driven on the CPU: each agrees with the
benchmark's outside metric it shadows, the program's spans share the
benchmark's clock, a ``--trace 0`` run records no program span, and a
reader reads nothing once the program's buffer has dropped a span."""
import collections
import subprocess
import sys
from types import SimpleNamespace

import pytest

import tinycell
from tinycell import REPO

READERS = ("daemon.queue_ms", "engine.phase_a_share", "engine.fetch_share",
           "uniondp.host_share")


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tinycell.make(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def recorders(monkeypatch):
    """The benchmark ``Recorder`` of each run, kept; the program's
    recorder left off and empty after."""
    from portbench import run as harness
    from repro_torch.core import telemetry
    kept = []

    class Kept(harness.Recorder):
        def __init__(self):
            super().__init__()
            kept.append(self)

    monkeypatch.setattr(harness, "Recorder", Kept)
    yield kept
    telemetry.disable()
    telemetry.clear()


def metrics(res):
    return {k: v["value"] for k, v in res["metrics"].items()}


def test_daemon_cell_readers_agree_and_share_the_clock(base, recorders):
    from repro_torch.core import telemetry
    rc, res = tinycell.run(base, "musicbrainz.tiny", 2**31 + 11, trace=1)
    assert rc == 0 and res["correct"], res
    m = metrics(res)
    assert 0 < m["daemon.queue_ms"] <= m["daemon.wait_ms"]
    assert m["driver.phase_a_share"] > 0
    assert abs(m["engine.phase_a_share"] - m["driver.phase_a_share"]) <= 0.05
    assert 0 <= m["engine.fetch_share"] <= 1
    # each program span of a stream lies inside the benchmark's wrapper
    # span of the same call: one clock for both
    (rec,) = recorders
    outer = rec.spans_named("service.stream")
    inner = [s for s in telemetry.spans() if s.name == "service.stream"]
    assert len(inner) == len(outer) > 0
    for s in inner:
        assert any(a <= s.t0 * 1e-9 <= s.t1 * 1e-9 <= b and tid == s.thread
                   for _, a, b, tid, _ in outer), s


def test_heuristic_cell_host_share_agrees(base, recorders):
    rc, res = tinycell.run(base, "snowflake.tiny_heuristic", 2**31 + 12,
                           trace=1)
    assert rc == 0 and res["correct"], res
    m = metrics(res)
    assert 0 < m["uniondp.host_share"] < 1
    assert abs(m["uniondp.host_share"] - m["heuristics.host_share"]) <= 0.05
    assert 0 <= m["engine.fetch_share"] <= 1


def test_untraced_run_records_no_program_span(base):
    code = (
        "import sys; sys.path.insert(0, 'portbench/tests')\n"
        "from pathlib import Path\n"
        "import tinycell\n"
        "from repro_torch.core import telemetry\n"
        f"rc, res = tinycell.run(Path({str(base)!r}), 'musicbrainz.tiny', 5,"
        " trace=0)\n"
        "assert rc == 0 and res['correct'], res\n"
        "print(len(telemetry.spans()), telemetry.new_request())\n")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{REPO}:{REPO}/src",
             "HOME": str(REPO)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-2:] == ["0", "0"]   # nothing; still off


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_after_drops(name, monkeypatch, recorders):
    from portbench import manifest
    from repro_torch.core import telemetry
    reader = manifest.load_reader(name)
    monkeypatch.setattr(telemetry, "_buf", collections.deque(maxlen=3))
    telemetry.enable()
    for n in ("daemon.queue", "engine.filter", "uniondp.solve"):
        with telemetry.span(n):
            pass
    run = SimpleNamespace(window=(0.0, 1e12))
    assert telemetry.dropped() == 0 and reader.read(run) is not None
    with telemetry.span("engine.phase_a"):
        pass
    assert telemetry.dropped() == 1 and reader.read(run) is None
