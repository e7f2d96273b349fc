"""The data axis of the port on gloo CPU ranks (DESIGN.md §13), against the
reference and against the port's own 1-rank results.

``shard_conv2d``'s three engine kinds at B = 5, H = 13 (the padding
remainder path, as ``tests/test_sharding.py``) on 1, 2 and 4 ranks: the
forward bitwise the port's unsharded call and within 1e-5 of the
reference's ``conv2d``, the gradients of ``sum(out)`` within 1e-5 of the
unsharded call's.  The tiny ENet's sharded train step (batch 8 in 8
virtual shards, 16x16, 4 classes, as ``tests/test_distributed_train.py``)
for 3 steps: parameters, AdamW state and losses bitwise equal on 1, 2 and
4 ranks; at 1 rank held to the reference's ``make_sharded_train_step`` on
``make_train_mesh(1)`` at ``tests/test_torch_train.py``'s bars; the bf16
transport within 5e-3 of the dense one per step.  Every world size is one
spawn of the ranks running all of its jobs (``repro_torch.launch.
data_axis``), one thread a rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_enet import _perturb

from repro.core.decompose import conv2d as jconv2d
from repro.launch import train_recipes as jtr
from repro.launch.mesh import make_train_mesh as jmake_train_mesh
from repro.models import enet as jenet
from repro_torch.core.decompose import band_split
from repro_torch.distributed.sharding import MODEL_AXIS_ITEM, model_size
from repro_torch.launch import data_axis
from repro_torch.launch import train_recipes as ttr
from repro_torch.launch.mesh import launch, make_train_mesh
from repro_torch.models.enet import flatten_tree

_B, _HW, _NC, _STEPS = 8, 16, 4, 3
_WORLDS = (1, 2, 4)
_KINDS = {"dense": dict(dilation=1), "dilated": dict(dilation=2),
          "tconv": dict(transposed=True, stride=2)}
_BACKENDS = ("kernels", "torch")
_CASES = [(f"{kind}-{be}", (5, 13, 13, 3), (3, 3, 3, 4),
           dict(kw, backend=be))
          for kind, kw in _KINDS.items() for be in _BACKENDS]
# one image at d = 2: its 4 phase blocks spread over up to 4 ranks
_CASES += [(f"dilated-b1-{be}", (1, 13, 13, 3), (3, 3, 3, 4),
            dict(dilation=2, backend=be)) for be in _BACKENDS]
_TOL = 1e-4
_BF16_GRAD_NORM = 1e-4


def _tree():
    params = jenet.init_params(jax.random.PRNGKey(0), num_classes=_NC)
    return _perturb(jax.tree_util.tree_map(np.asarray, params),
                    np.random.default_rng(0))


def _batch():
    rng = np.random.default_rng(0)
    return {"image": rng.normal(size=(_B, _HW, _HW, 3)).astype(np.float32),
            "label": rng.integers(0, _NC, (_B, _HW, _HW)).astype(np.int32)}


def _ref_steps():
    """The reference's sharded step on its 1-device mesh: per step the
    loss, grad norm, scale and skipped flag."""
    mesh = jmake_train_mesh(1)
    step = jtr.make_sharded_train_step("enet", mesh)
    state = jtr.place_state(mesh, jtr.init_state(_tree()))
    chunks = jtr.shard_batch(mesh, {k: jnp.asarray(v)
                                    for k, v in _batch().items()})
    out = []
    for _ in range(_STEPS):
        state, m = step(state, chunks)
        out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.fixture(scope="module")
def runs():
    """Each world's ranks (all started at once), and the reference's
    steps, computed while they run."""
    params = flatten_tree(_tree())
    started = {}
    for n in _WORLDS:
        transports = (("kernels", "dense"), ("kernels", "bf16")) \
            if n == 4 else (("kernels", "dense"),)
        jobs = [("conv", {"cases": _CASES}),
                ("train", {"params": params, "batch": _batch(),
                           "steps": _STEPS, "runs": transports})]
        started[n] = launch(data_axis.run, n, device="cpu", args=(jobs,),
                            join=False)
    ref = _ref_steps()
    out = {n: ranks.result() for n, ranks in started.items()}
    out["ref"] = ref
    return out


def _operands(i):
    rng = np.random.default_rng(i)
    return (rng.standard_normal(_CASES[i][1], dtype=np.float32),
            rng.standard_normal(_CASES[i][2], dtype=np.float32))


@pytest.mark.parametrize("nd", _WORLDS)
@pytest.mark.parametrize("case", range(len(_CASES)))
def test_shard_conv2d_forward_and_grads(runs, case, nd):
    label, _, _, kw = _CASES[case]
    x, w = _operands(case)
    jkw = {k: v for k, v in kw.items() if k != "backend"}
    want = np.asarray(jconv2d(jnp.asarray(x), jnp.asarray(w), **jkw))
    first = runs[1][0]["conv"][label]
    for rank in runs[nd]:
        got = rank["conv"][label]
        assert got["equal"], label              # bitwise the unsharded call
        assert got["digest"] == first["digest"]
        np.testing.assert_allclose(got["y"].numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        for g in ("dx", "dw"):              # 1e-5 x max(1, max|ref|)
            ref = got[f"ref_{g}"]
            bar = 1e-5 * max(1.0, ref.abs().max().item())
            assert (got[g] - ref).abs().max().item() <= bar, (label, g)


@pytest.mark.parametrize("nd", _WORLDS)
def test_phase_fold_spreads_a_small_batch(runs, nd):
    """The dilated engine folds before it pads: one image's 4 phase blocks
    give each of nd ranks 4 / nd of them (padding the batch to the ranks
    first would give each rank 4 blocks, 3 of them zero at 4 ranks)."""
    for rank in runs[nd]:
        conv = rank["conv"]
        assert conv["dilated-b1-torch"]["conv_rows"] == [4 // nd]
        assert conv["dilated-torch"]["conv_rows"] == [20 // nd]
        # a dense conv splits the batch padded to the ranks: 5, 3, 2 rows
        assert conv["dense-torch"]["conv_rows"] == [-(-5 // nd)]


def _flat_state(state):
    flat = {f"params.{k}": v for k, v in state.params.items()}
    flat.update({f"mu.{k}": v for k, v in state.opt.mu.items()})
    flat.update({f"nu.{k}": v for k, v in state.opt.nu.items()})
    flat["step"] = state.opt.step
    flat["scale"] = state.scale.scale
    flat["good_steps"] = state.scale.good_steps
    return flat


@pytest.mark.parametrize("nd", [2, 4])
def test_sharded_enet_step_bitwise_across_worlds(runs, nd):
    one = runs[1][0]["train"][("kernels", "dense")]
    want = _flat_state(one["state"])
    for rank in runs[nd]:
        got = rank["train"][("kernels", "dense")]
        for m1, m in zip(one["metrics"], got["metrics"]):
            assert torch.equal(m["losses"], m1["losses"])
            assert m["loss"].item() == m1["loss"].item()
            assert m["grad_norm"].item() == m1["grad_norm"].item()
        flat = _flat_state(got["state"])
        assert set(flat) == set(want)
        for k, v in want.items():
            assert torch.equal(flat[k], v), k


def test_world1_step_tracks_reference(runs):
    got = runs[1][0]["train"][("kernels", "dense")]["metrics"]
    for m, want in zip(got, runs["ref"]):
        assert abs(m["loss"].item() - want["loss"]) <= _TOL * want["loss"]
        np.testing.assert_allclose(m["grad_norm"].item(), want["grad_norm"],
                                   rtol=1e-3)
        assert m["scale"].item() == want["scale"]
        assert m["skipped"].item() == want["skipped"] == 0.0


def test_bf16_transport_tracks_dense(runs):
    """The bf16 wire: losses within 5e-3 of the dense run's per step; the
    first step's gradients (both runs from one state, so only the wire
    differs) leave a grad norm that differs from the dense one, by at most
    _BF16_GRAD_NORM of it (4.1e-5 read here); and the trained parameters
    differ.  A wire that sent fp32 would read 0 on both."""
    dense = runs[4][0]["train"][("kernels", "dense")]
    ld = [m["loss"].item() for m in dense["metrics"]]
    gd = dense["metrics"][0]["grad_norm"].item()
    want = _flat_state(dense["state"])
    for rank in runs[4]:
        got = rank["train"][("kernels", "bf16")]
        lb = [m["loss"].item() for m in got["metrics"]]
        for a, b in zip(ld, lb):
            assert abs(a - b) <= 5e-3 * max(abs(a), 1.0), (ld, lb)
        assert lb[-1] < lb[0]
        gap = abs(got["metrics"][0]["grad_norm"].item() - gd) / gd
        assert 0.0 < gap <= _BF16_GRAD_NORM, gap
        flat = _flat_state(got["state"])
        assert any(not torch.equal(flat[k], v) for k, v in want.items()
                   if k.startswith("params."))


def test_shard_batch_errors():
    mesh = make_train_mesh(4)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with pytest.raises(ValueError, match="virtual_shards"):
        ttr.shard_batch(mesh, batch, virtual_shards=6)
    with pytest.raises(ValueError, match="not divisible"):
        ttr.shard_batch(mesh, {"image": torch.zeros(6, 4, 4, 3)},
                        virtual_shards=4)
    chunks = ttr.shard_batch(mesh, batch, virtual_shards=8)
    assert tuple(chunks["image"].shape) == (8, _B // 8, _HW, _HW, 3)
    assert tuple(chunks["label"].shape) == (8, _B // 8, _HW, _HW)
    with pytest.raises(ValueError, match="backend"):
        ttr.make_sharded_train_step("enet", mesh, backend="pallas")


def test_spatial_names_the_model_axis_item():
    """``spatial=True`` runs now (``tests/test_torch_spatial.py``); on a
    mesh with no model axis its rows resolve whole, with the reason, and
    what the model axis still waits for is named."""
    x, w = torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 3, 4)
    m = model_size(make_train_mesh(1))
    assert m == 1
    assert band_split(tuple(x.shape), tuple(w.shape), m) == "one band"
    assert band_split(tuple(x.shape), tuple(w.shape), 2).counts == [2, 2]
    for item in ("experts", "sequence parallelism", "recurrent",
                 "encoder-decoder"):
        assert item in MODEL_AXIS_ITEM
