"""Gradient compression and the fixed-order all-reduce of the port against
``repro.distributed.compression``, on the same numpy inputs.

int8 quantization with error feedback over several steps (an empty and a
scalar leaf among the gradients), the wire packing at words 1, 4 and 8,
and ``mesh_allreduce`` on 1, 2 and 4 gloo CPU ranks: bitwise equal across
the rank counts, and equal to the reference's sum over its 1-device mesh
within fp32 reassociation (XLA orders the 8-term sum its own way; the
bf16 transport's widened terms happen to sum exactly, bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.distributed import compression as jc
from repro.launch.mesh import make_train_mesh as jmake_train_mesh
from repro_torch.distributed import compression as tc
from repro_torch.launch import data_axis
from repro_torch.launch.mesh import launch

_WORLDS = (1, 2, 4)
_C = 8


def _grads(rng):
    return {"a.w": rng.standard_normal((5, 7)).astype(np.float32),
            "b.bias": np.zeros((0,), np.float32),
            "c.scale": np.asarray(rng.standard_normal(), np.float32),
            "d.big": (1e3 * rng.standard_normal((3, 4, 6))).astype(
                np.float32)}


def _stacks():
    rng = np.random.default_rng(7)
    return {"conv.w": rng.standard_normal((_C, 3, 3, 4, 5)).astype(
                np.float32),
            "bn.g": rng.standard_normal((_C, 5)).astype(np.float32),
            "head": (1e-3 * rng.standard_normal((_C, 33))).astype(
                np.float32)}


@pytest.fixture(scope="module")
def reduced():
    jobs = [("allreduce", {"stacks": _stacks(), "transport": "dense"}),
            ("allreduce", {"stacks": _stacks(), "transport": "bf16"})]
    started = {n: launch(data_axis.run, n, device="cpu", args=(jobs,),
                         join=False) for n in _WORLDS}
    return {n: ranks.result() for n, ranks in started.items()}


def test_int8_error_feedback_tracks_reference():
    rng = np.random.default_rng(0)
    first = _grads(rng)
    t_err = tc.init_error_feedback({k: torch.from_numpy(v)
                                    for k, v in first.items()})
    j_err = jc.init_error_feedback({k: jnp.asarray(v)
                                    for k, v in first.items()})
    for step in range(5):
        g = first if step == 0 else _grads(rng)
        tq, ts, t_err = tc.compress_int8_ef(
            {k: torch.from_numpy(v) for k, v in g.items()}, t_err)
        jq, js, j_err = jc.compress_int8_ef(
            {k: jnp.asarray(v) for k, v in g.items()}, j_err)
        for k in g:
            assert tq[k].dtype == torch.int8
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
            assert ts[k].item() == float(js[k]), k
            np.testing.assert_array_equal(t_err[k].numpy(),
                                          np.asarray(j_err[k]), err_msg=k)
        got = tc.decompress_int8(tq, ts)
        want = jc.decompress_int8(jq, js)
        for k in g:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_bf16_round_trip_matches_reference():
    g = _grads(np.random.default_rng(1))
    got = tc.decompress_bf16(tc.compress_bf16(
        {k: torch.from_numpy(v) for k, v in g.items()}))
    want = jc.decompress_bf16(jc.compress_bf16(
        {k: jnp.asarray(v) for k, v in g.items()}))
    for k in g:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("word", [1, 4, 8])
def test_pack_unpack_bitwise(word):
    rng = np.random.default_rng(word)
    q = {"x.odd": rng.integers(-127, 128, (3, 5)).astype(np.int8),
         "a.scalar": np.asarray(-7, np.int8),
         "m.empty": np.zeros((0, 4), np.int8),
         "b.vec": rng.integers(-127, 128, (9,)).astype(np.int8)}
    buf, manifest = tc.pack_int8({k: torch.from_numpy(v)
                                  for k, v in q.items()}, word=word)
    jbuf, _ = jc.pack_int8({k: jnp.asarray(v) for k, v in q.items()},
                           word=word)
    assert buf.dtype == torch.int8 and buf.numel() % word == 0
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    back = tc.unpack_int8(buf, manifest)
    assert set(back) == set(q)
    for k, v in q.items():
        assert tuple(back[k].shape) == v.shape
        np.testing.assert_array_equal(back[k].numpy(), v)
    with pytest.raises(ValueError, match="word"):
        tc.pack_int8({}, word=0)


def _reference_allreduce(transport):
    """The reference's ``mesh_allreduce`` inside its ``shard_map`` over
    the 1-device ``(data,)`` mesh."""
    from jax.experimental.shard_map import shard_map

    mesh = jmake_train_mesh(1)
    fn = shard_map(lambda g: jc.mesh_allreduce(g, "data",
                                               transport=transport),
                   mesh=mesh, in_specs=(JP("data"),), out_specs=JP(),
                   check_rep=False)
    out = jax.jit(fn)({k: jnp.asarray(v) for k, v in _stacks().items()})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("transport", ["dense", "bf16"])
@pytest.mark.parametrize("nd", _WORLDS)
def test_mesh_allreduce_bitwise_across_worlds(reduced, nd, transport):
    key = "allreduce" if transport == "dense" else "allreduce#1"
    one = reduced[1][0][key]
    want = _reference_allreduce(transport)
    for rank in reduced[nd]:
        got = rank[key]
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], one[k]), k
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                       atol=1e-6 * np.abs(want[k]).max(),
                                       err_msg=k)


def test_mesh_allreduce_refuses_unknown_transport():
    with pytest.raises(ValueError, match="transport"):
        tc.mesh_allreduce({}, None, transport="int8")
