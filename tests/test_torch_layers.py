"""The port's LM layers (``repro_torch.models.layers``, ``ssm``, ``griffin``)
against the JAX reference's, on the CPU, component by component.

Inputs are f32, made with numpy from a seed, so both packages compute in
f32: every output is held to a relative 1e-5 of its largest magnitude, and
the test prints the largest difference.  ``moe_dispatch``'s integer outputs
(the dispatch mask, the capacity, the kept slots) are equal, on random
router weights and on weights whose duplicate columns tie the router
probabilities exactly (``jax.lax.top_k`` takes the lower index first).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.models import griffin as rgr, layers as RL, ssm as rssm
from repro_torch.models import griffin as tgr, layers as TL, ssm as tssm
from tests.test_torch_batch import one_torch_thread  # noqa: F401

REL = 1e-5


def rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


def held(label, want, got, rel=REL):
    """Raise unless max |got - want| <= rel * max |want|; print it."""
    w = np.asarray(want, np.float64)
    g = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    assert w.shape == g.shape, (label, w.shape, g.shape)
    worst = float(np.abs(w - g).max()) if w.size else 0.0
    scale = float(np.abs(w).max()) if w.size else 0.0
    print(f"{label}: max |diff| {worst:.3e} of max |ref| {scale:.3e}")
    assert worst <= rel * max(scale, 1e-30), (label, worst, scale)


def test_rms_norm():
    x, s = rnd(0, 3, 5, 64, scale=3.0), rnd(1, 64, scale=0.1)
    held("rms_norm", RL.rms_norm(J(x), J(s)), TL.rms_norm(T(x), T(s)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    x = rnd(2, 2, 7, 3, 16)
    pos = np.arange(5, 12, dtype=np.int32)[None].repeat(2, 0)
    held(f"rope theta {theta}", RL.rope(J(x), J(pos), theta),
         TL.rope(T(x), T(pos), theta))


ATTN = {
    # name: (Sq, Sk, H, KV, D, Dv, q_offset, window, causal, block)
    "causal": (32, 32, 4, 2, 16, 16, 0, None, True, 8),
    "window_q_offset": (11, 40, 4, 1, 16, 16, 29, 7, True, 8),
    "window_wide": (24, 24, 2, 2, 8, 8, 0, 20, True, 8),
    "non_causal": (9, 21, 4, 4, 16, 16, 0, None, False, 8),
    "ragged": (13, 19, 6, 3, 8, 8, 0, None, True, 5),
    "dv_ne_d": (10, 10, 4, 4, 24, 16, 0, None, True, 4),
    "one_block": (6, 6, 4, 2, 16, 16, 0, None, True, 1024),
}


@pytest.mark.parametrize("case", list(ATTN))
def test_causal_attention(case):
    Sq, Sk, H, KV, D, Dv, off, window, causal, block = ATTN[case]
    q, k, v = rnd(3, 2, Sq, H, D), rnd(4, 2, Sk, KV, D), rnd(5, 2, Sk, KV, Dv)
    want = RL.causal_attention(J(q), J(k), J(v), q_offset=off, window=window,
                               block=block, causal=causal)
    got = TL.causal_attention(T(q), T(k), T(v), q_offset=off, window=window,
                              block=block, causal=causal)
    held(f"causal_attention {case}", want, got)


@pytest.mark.parametrize("cache_len", [1, 9, 16])
def test_decode_attention(cache_len):
    q, k, v = rnd(6, 3, 1, 4, 16), rnd(7, 3, 16, 2, 16), rnd(8, 3, 16, 2, 8)
    held(f"decode_attention len {cache_len}",
         RL.decode_attention(J(q), J(k), J(v), cache_len),
         TL.decode_attention(T(q), T(k), T(v), cache_len))


def ssd_inputs(b, l, h, p, n):
    x = rnd(9, b, l, h, p)
    dt = np.abs(rnd(10, b, l, h, scale=0.5)).astype(np.float32)
    A = -np.abs(rnd(11, h)).astype(np.float32) - 0.1
    return x, dt, A, rnd(12, b, l, n), rnd(13, b, l, n)


@pytest.mark.parametrize("l,chunk", [(32, 8), (27, 8), (5, 16)])
def test_ssd_chunked(l, chunk):
    """Whole chunks, a padded tail, and one chunk shorter than ``chunk``:
    the outputs and the final state (the cross-chunk carry)."""
    ins = ssd_inputs(2, l, 3, 4, 6)
    y_r, s_r = rssm.ssd_chunked(*map(J, ins), chunk)
    y_t, s_t = tssm.ssd_chunked(*map(T, ins), chunk)
    held(f"ssd_chunked y l={l}", y_r, y_t)
    held(f"ssd_chunked state l={l}", s_r, s_t)


def test_segsum():
    x = rnd(14, 2, 3, 7)
    want = np.asarray(rssm._segsum(J(x)))
    got = tssm._segsum(T(x)).numpy()
    assert np.array_equal(np.isinf(want), np.isinf(got))
    fin = np.isfinite(want)
    held("_segsum", want[fin], got[fin])


def test_ssd_decode_step_and_chunked_agree():
    """One decode step against the reference's, and T steps of the port's
    decode step against the port's chunked form (the same recurrence)."""
    x, dt, A, Bm, Cm = ssd_inputs(2, 6, 3, 4, 5)
    st = rnd(15, 2, 3, 4, 5)
    args = (st, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
    y_r, s_r = rssm.ssd_decode_step(*map(J, args))
    y_t, s_t = tssm.ssd_decode_step(*map(T, args))
    held("ssd_decode_step y", y_r, y_t)
    held("ssd_decode_step state", s_r, s_t)
    s = torch.zeros((2, 3, 4, 5))
    ys = []
    for t in range(6):
        y, s = tssm.ssd_decode_step(s, T(x[:, t]), T(dt[:, t]), T(A),
                                    T(Bm[:, t]), T(Cm[:, t]))
        ys.append(y)
    y_c, s_c = tssm.ssd_chunked(T(x), T(dt), T(A), T(Bm), T(Cm), 4)
    held("decode steps vs chunked", y_c, torch.stack(ys, 1))
    held("decode state vs chunked", s_c, s)


def test_rglru_scan():
    x, r, i = rnd(16, 2, 23, 8), rnd(17, 2, 23, 8), rnd(18, 2, 23, 8)
    r, i = 1 / (1 + np.exp(-r)), 1 / (1 + np.exp(-i))
    lam = rnd(19, 8)
    held("_rglru_scan", rgr._rglru_scan(J(x), J(r), J(i), J(lam)),
         tgr._rglru_scan(T(x), T(r), T(i), T(lam)))


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_activations(act):
    x = rnd(20, 4096, scale=4.0)
    held(act, RL.ACT[act](J(x)), TL.ACT[act](T(x)))
    xb = torch.from_numpy(x).bfloat16()
    want = np.asarray(RL.ACT[act](J(x).astype(jnp.bfloat16)).astype(jnp.float32))
    assert np.array_equal(want, TL.ACT[act](xb).float().numpy()), act


def router(seed, D, E, tie: bool):
    w = rnd(seed, D, E, scale=0.5)
    if tie:                               # columns 2k and 2k+1 equal
        w[:, 1::2] = w[:, 0::2]
    return w


@pytest.mark.parametrize("T_,E,k,cf,tie", [
    (24, 4, 2, 1.25, False), (24, 4, 2, 1.25, True), (7, 8, 2, 1.0, True),
    (40, 16, 2, 0.5, False), (3, 4, 1, 1.25, True), (10, 6, 3, 1.25, False)])
def test_moe_dispatch(T_, E, k, cf, tie):
    x = rnd(21, T_, 16)
    if tie:                               # duplicate tokens tie the queues too
        x[1::3] = x[0::3][: len(x[1::3])]
    w = router(22, 16, E, tie)
    d_r, c_r, a_r, cap_r = RL.moe_dispatch(J(x), J(w), E, k, cf)
    d_t, c_t, a_t, cap_t = TL.moe_dispatch(T(x), T(w), E, k, cf)
    assert cap_t == cap_r
    assert np.array_equal(np.asarray(d_r), d_t.numpy()), "dispatch"
    kept_r = np.argwhere(np.asarray(d_r) > 0)
    assert np.array_equal(kept_r, np.argwhere(d_t.numpy() > 0)), "kept slots"
    print(f"T={T_} E={E} k={k} cf={cf} tie={tie}: cap {cap_t}, "
          f"{len(kept_r)} of {T_ * k} slots kept")
    held("combine", c_r, c_t)
    held("aux", a_r, a_t)


def test_moe_ffn_token_chunks():
    """More tokens than ``token_chunk``: the zero-padded chunks routed and
    their aux averaged as the reference's scan does."""
    x = rnd(23, 2, 9, 16)
    p = {"router": rnd(24, 16, 4), "wi": rnd(25, 4, 16, 12, scale=0.25),
         "wo": rnd(26, 4, 6, 16, scale=0.25)}
    y_r, a_r = RL.moe_ffn(J(x), {k: J(v) for k, v in p.items()}, 4, 2,
                          token_chunk=8)
    y_t, a_t = TL.moe_ffn(T(x), {k: T(v) for k, v in p.items()}, 4, 2,
                          token_chunk=8)
    held("moe_ffn y", y_r, y_t)
    held("moe_ffn aux", a_r, a_t)
