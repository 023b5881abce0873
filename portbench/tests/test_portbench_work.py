"""The frozen work arithmetic gives PERF.md's kernel-table bounds on the
launches of stream (a), recorded through the port's kernel wrappers (on
the CPU they run the plain versions, bit for bit the kernels)."""
import pytest

from portbench.tracing import Recorder
from portbench.yardstick.devtrace import kernel_of
from portbench.yardstick.work import KERNELS, bound_s


@pytest.fixture(scope="module")
def stream_a_launches():
    import torch
    from repro_torch.core import batch
    from repro_torch.workloads import generators as gen
    torch.set_num_threads(1)
    rec = Recorder()
    for k, (_, names) in KERNELS.items():
        rec.capture(k, names)
    rec.capturing = True
    try:
        batch.optimize_many(gen.mixed_stream(32, seed=0,
                                             sizes=(12, 13, 14, 15, 16)),
                            "auto", device="cpu")
    finally:
        rec.restore()
    by = {}
    for name, args, outs in rec.launches:
        by.setdefault(name, []).append((args, outs))
    return by


def test_launch_counts_match_the_kernel_table(stream_a_launches):
    got = {k: len(v) for k, v in stream_a_launches.items()}
    assert got == {"bconnectivity_span": 30, "btree_eval_decode": 20,
                   "bgeneral_eval_decode": 42}


@pytest.mark.parametrize("name,pick,bound_us,by", [
    ("bconnectivity_span", lambda a: a["count"], 0.4689, "operations"),
    ("btree_eval_decode", lambda a: min(int(a["eoff"][-1]), a["chunk"]),
     0.1995, "bytes"),
    ("bgeneral_eval_decode", lambda a: a["lane_count"], 0.2745, "bytes"),
])
def test_busiest_launch_bound(stream_a_launches, name, pick, bound_us, by):
    args, outs = max(stream_a_launches[name], key=lambda x: pick(x[0]))
    b, what = bound_s(name, args, outs)
    assert what == by
    assert round(b * 1e6, 4) == bound_us


def test_trace_names_map_to_kernels():
    assert kernel_of("void (anonymous namespace)::connectivity_kernel<true>"
                     "(int const*, int)") == "connectivity_span"
    assert kernel_of("(anonymous namespace)::connectivity_kernel<false>"
                     "(int const*)") is None
    assert kernel_of("_ZN3bconnectivity_span_kernel") is None
    assert kernel_of("bconnectivity_span_kernel(int, int const*)") == \
        "bconnectivity_span"
    assert kernel_of("void at::native::vectorized_elementwise_kernel<4>") \
        is None

