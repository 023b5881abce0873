"""The port's LLM sharding rules, meshes and compressed all-reduce
(``repro_torch.distributed.sharding``, ``repro_torch.launch.mesh``,
``repro_torch.distributed.collectives``) against the JAX reference's, on
the CPU.

The spec tuples equal the reference's ``PartitionSpec``s for every leaf
of all ten archs at full width: the port reads meta ``param_specs`` and
the reference ``eval_shape`` specs on a ``jax.sharding.AbstractMesh``, on
the (16, 16) and (2, 16, 16) production meshes and the (1, 1) host mesh.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.distributed import sharding as rshd
from repro.distributed import collectives as rcol
from repro.distributed.collectives import int8_psum as ref_int8_psum
from repro.distributed.collectives import shard_map_compat
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.models import api as rapi
from repro_torch.distributed import collectives as tcol
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api as tapi
from repro_torch.train.optimizer import init_train_state
from repro_torch.tree import leaves_with_path
from tests.test_torch_batch import one_torch_thread  # noqa: F401

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((1, 1), ("data", "model"))]


def ref_specs(tree):
    """{path: spec tuple} of a reference tree of NamedShardings."""
    flat = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {"/".join(str(getattr(k, "key", k)) for k in kp): tuple(s.spec)
            for kp, s in flat}


def port_specs(tree):
    return {p: s.spec for p, s in leaves_with_path(tree)}


def ref_state_spec(pspec):
    return {"params": pspec, "m": pspec, "v": pspec,
            "step": jax.ShapeDtypeStruct((), jnp.int32)}


@pytest.mark.parametrize("arch", rapi.ARCH_IDS)
def test_sharding_specs_equal_reference(arch):
    """param_, state_, batch_ (train_4k and prefill_32k inputs),
    cache_shardings (decode_32k and long_500k caches) and logits_sharding
    on the three meshes."""
    rcfg, tcfg = rapi.get_config(arch), tapi.get_config(arch)
    rp, tp = rapi.param_specs(rcfg), tapi.param_specs(tcfg)
    tstate = {"params": tp, "m": tp, "v": tp,
              "step": torch.empty((), dtype=torch.int32, device="meta")}
    seen = 0
    for shape, axes in MESHES:
        rm, tm = AbstractMesh(shape, axes), tmesh.Mesh(shape, axes)
        pairs = [(rshd.param_shardings(rp, rm), tshd.param_shardings(tp, tm)),
                 (rshd.state_shardings(ref_state_spec(rp), rm),
                  tshd.state_shardings(tstate, tm))]
        for sname in ("train_4k", "prefill_32k"):
            sh = rapi.SHAPES[sname]
            pairs.append((rshd.batch_shardings(rapi.input_specs(rcfg, sh), rm),
                          tshd.batch_shardings(tapi.input_specs(tcfg, sh), tm)))
        for sname in ("decode_32k", "long_500k"):
            sh = rapi.SHAPES[sname]
            pairs.append((rshd.cache_shardings(rapi.cache_specs(rcfg, sh), rm),
                          tshd.cache_shardings(tapi.cache_specs(tcfg, sh), tm)))
        for want, got in pairs:
            w, g = ref_specs(want), port_specs(got)
            assert w == g, (arch, shape, {k: (w.get(k), g.get(k))
                                          for k in set(w) | set(g)
                                          if w.get(k) != g.get(k)})
            seen += len(w)
        for batch in (0, 1, 16, 256):
            assert tuple(rshd.logits_sharding(rm, rcfg.vocab, batch).spec) == \
                tshd.logits_sharding(tm, tcfg.vocab, batch).spec
        assert tuple(rshd.replicated(rm).spec) == tshd.replicated(tm).spec
    print(f"{arch}: {seen} leaf specs equal on {len(MESHES)} meshes")


def test_param_spec_and_sanitize_equal_reference():
    """The rules on their own, over paths and shapes that reach every
    branch, and sanitize on a dimension that does not divide (granite's
    vocab 49155 on a 16-way axis)."""
    cases = [("embed", (49155, 4096)), ("patch_proj", (16, 64)),
             ("ffn0/router", (4, 64, 8)), ("ffn0/shared_wi", (4, 64, 128)),
             ("ffn0/shared_wo", (4, 64, 64)), ("ffn0/wi", (4, 8, 64, 32)),
             ("ffn0/wo", (4, 8, 32, 64)), ("attn0/wq", (4, 64, 64)),
             ("attn0/w_uv", (4, 32, 64)), ("attn0/w_dkv", (4, 64, 40)),
             ("blocks/conv_w", (4, 4, 160)), ("blocks/other", (4, 4, 160)),
             ("blocks/a_log", (4, 16)), ("attn0/ln", (4, 64)),
             ("final_ln", (64,)), ("step", ())]
    for shape, axes in MESHES:
        rm, tm = AbstractMesh(shape, axes), tmesh.Mesh(shape, axes)
        for path, s in cases:
            assert tuple(rshd.param_spec(path, s)) == tshd.param_spec(path, s)
            assert tuple(rshd.sanitize(rshd.param_spec(path, s), s, rm)) == \
                tshd.sanitize(tshd.param_spec(path, s), s, tm), (path, shape)


def test_meshes():
    """make_production_mesh raises with the count on one device; the host
    mesh holds the device the sharding places leaves on; dp_axes."""
    with pytest.raises(ValueError, match=r"requested 256 devices but only \d+ cpu"):
        tmesh.make_production_mesh(backend="cpu")
    with pytest.raises(ValueError, match=r"requested 512 devices"):
        tmesh.make_production_mesh(multi_pod=True, backend="cpu")
    m = tmesh.make_host_mesh(backend="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.devices == [torch.device("cpu")]
    assert tmesh.dp_axes(m) == ("data",)
    assert tmesh.dp_axes(tmesh.Mesh((2, 16, 16), ("pod", "data", "model"))) == \
        ("pod", "data")
    assert tshd.replicated(m).device == torch.device("cpu")
    with pytest.raises(ValueError, match="abstract"):
        tshd.replicated(tmesh.Mesh((16, 16), ("data", "model"))).device
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="only 0 cuda"):
            tmesh.make_host_mesh()


def test_state_shardings_place_a_train_state():
    """A reduced TrainState's shardings on the host mesh name its device
    for every leaf, with the reference's specs."""
    cfg = tapi.get_config("deepseek_v2_lite").reduced()
    model = tapi.build_model(cfg)
    state = init_train_state(model.init_params(torch.Generator().manual_seed(0)))
    sh = tshd.state_shardings(state, tmesh.make_host_mesh(backend="cpu"))
    flat = leaves_with_path(sh)
    assert [p for p, _ in flat] == [p for p, _ in leaves_with_path(state)]
    assert all(s.device == torch.device("cpu") for _, s in flat)
    rstate = jax.eval_shape(lambda: ref_state_spec(rapi.param_specs(
        rapi.get_config("deepseek_v2_lite").reduced())))
    want = ref_specs(rshd.state_shardings(rstate, AbstractMesh((1, 1),
                                                               ("data", "model"))))
    assert want == port_specs(sh)


def test_int8_psum_one_shard_bit_identical():
    """One shard: the reference test's setup (``make_host_mesh((1,),
    ("pod",))``, 1000 normals): bit for bit the reference's, and within
    1.5/127 of the input."""
    x = np.random.default_rng(0).normal(size=(1000,)).astype(np.float32)
    f = shard_map_compat(lambda t: ref_int8_psum(t, "pod"),
                         mesh=ref_host_mesh((1,), ("pod",)), in_specs=P(),
                         out_specs=P())
    want = np.asarray(f(jnp.asarray(x)))
    got = tcol.int8_psum([torch.from_numpy(x)])[0].numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    rel = np.abs(got - x).max() / np.abs(x).max()
    print(f"one shard: bit for bit the reference's; relative error {rel:.4e}")
    assert rel < 1.5 / 127.0


def numpy_int8_psum(xs):
    """The rule in numpy: per-shard block scales max|x| / 127, payloads
    round-half-even(x / scale) clipped to int8 and summed in int32, the
    scales summed in shard order and divided by the shard count."""
    qs, ss = [], []
    for x in xs:
        flat = x.reshape(-1).astype(np.float32)
        n = flat.shape[0]
        flat = np.pad(flat, (0, (-n) % 256)).reshape(-1, 256)
        s = (np.abs(flat).max(axis=1, keepdims=True) / np.float32(127.0)).astype(np.float32)
        q = np.clip(np.round(flat / np.maximum(s, np.float32(1e-20))), -127, 127)
        qs.append(q.astype(np.int8).astype(np.int32))
        ss.append(s)
    qsum, ssum = qs[0], ss[0]
    for q, s in zip(qs[1:], ss[1:]):
        qsum, ssum = qsum + q, (ssum + s).astype(np.float32)
    avg = (ssum / np.float32(len(xs))).astype(np.float32)
    return (qsum.astype(np.float32) * avg).reshape(-1)[:n].reshape(xs[0].shape)


def ref_four_shards(xs):
    """The reference's ``int8_psum`` over a 4-device ``pod`` mesh, shard i
    holding ``xs[i]``: each shard's result."""
    f = shard_map_compat(lambda t: ref_int8_psum(t[0], "pod")[None],
                         mesh=ref_host_mesh((4,), ("pod",)), in_specs=P("pod"),
                         out_specs=P("pod"))
    return list(np.asarray(f(jnp.asarray(np.stack(xs)))))


def test_int8_psum_four_shards():
    """Four logical shards, each at its own scale (so their block scales
    differ and the scale averaging is exercised): every shard's result bit
    for bit the reference's over a 4-device ``pod`` mesh, and the numpy
    statement of the rule, a second witness; the error against the exact
    sum printed (scale averaging is exact only where the shards' block
    scales agree)."""
    r = np.random.default_rng(1)
    xs = [r.normal(size=(3, 700)).astype(np.float32) * np.float32(1 + i)
          for i in range(4)]
    got = tcol.int8_psum([torch.from_numpy(x) for x in xs])
    want = ref_four_shards(xs)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.int32), w.view(np.int32))
    assert np.array_equal(got[0].numpy().view(np.int32),
                          numpy_int8_psum(xs).view(np.int32))
    exact = np.sum(xs, axis=0)
    rel = np.abs(got[0].numpy() - exact).max() / np.abs(exact).max()
    print(f"four distinct shards: the reference's bit for bit, and the numpy "
          f"rule; relative error {rel:.4e}")


def test_compressed_grad_reduce_four_shards():
    """``compressed_grad_reduce`` on a (4, 1, 1) mesh: every leaf bit for
    bit the reference's on ``Mesh((4, 1, 1))`` (four equal copies of the
    replicated gradients), and the numpy rule's; within 1.5/127 of the
    exact sum."""
    r = np.random.default_rng(2)
    grads = {"a": r.normal(size=(3, 700)).astype(np.float32),
             "b": {"c": r.normal(size=(700,)).astype(np.float32)}}
    want = rcol.compressed_grad_reduce(
        jax.tree.map(jnp.asarray, grads),
        ref_host_mesh((4, 1, 1), ("pod", "data", "model")))
    out = tcol.compressed_grad_reduce(
        jax.tree.map(torch.from_numpy, grads),
        tmesh.Mesh((4, 1, 1), ("pod", "data", "model")))
    worst = 0.0
    for (p, g), (_, w), (_, x) in zip(leaves_with_path(out),
                                      leaves_with_path(jax.tree.map(np.asarray, want)),
                                      leaves_with_path(grads)):
        assert np.array_equal(g.numpy().view(np.int32), w.view(np.int32)), p
        assert np.array_equal(g.numpy(), numpy_int8_psum([x] * 4)), p
        worst = max(worst, float(np.abs(g.numpy() - 4 * x).max()
                                 / np.abs(4 * x).max()))
    print(f"compressed_grad_reduce over 4 shards: the reference's bit for "
          f"bit; relative error {worst:.4e}")
    assert worst < 1.5 / 127.0
