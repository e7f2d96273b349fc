"""The LM train loop and its checkpoints over ``(data, model)`` meshes of
gloo CPU ranks, training's collectives, and what the mesh refuses.

One spawn of 4 ranks (``data_axis.run_worlds``) runs, in order:

* on ``(2, 2)``: ``launch.train.train(mesh=)`` with a checkpoint every 2
  steps, uninterrupted and with a fault injected at step 3 on every rank;
  2 steps of the reduced StableLM-2-1.6B in fp32 from a seed, saved; the
  3 steps uninterrupted; the adjoints of the new collectives;
* on ``(1, 2)`` (ranks 0-1): that ``(2, 2)`` checkpoint restored, and one
  more step; the 1-rank checkpoint this process wrote first, restored;
  the adjoints.

The restored states are the saved ones bit for bit, leaf for leaf, on
``(1, 2)`` and on one rank (this process), and the step after a restore
has the uninterrupted run's loss within the fp32 bar (1e-5).
"""

import os

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.checkpoint import flatten_tree, latest_step, \
    restore_checkpoint
from repro_torch.distributed.fault_tolerance import Heartbeat
from repro_torch.distributed.sharding import ModelParallel
from repro_torch.launch import data_axis, steps, train
from repro_torch.launch.mesh import launch, make_smoke_mesh
from repro_torch.models import transformer

_ARCH = "stablelm-1.6b"
_FP32 = {"dtype": "float32"}
_LOOP = dict(steps=4, global_batch=4, seq_len=16, microbatches=2,
             ckpt_every=2, log_every=10)
_VALUE_BAR = 1e-5
# a bf16 loss on a mesh against one device's: each rank rounds its
# row-split partial sums to bf16 before they are added, which moved the
# reduced StableLM's losses by at most 2.7e-4 relative on the CPU (4 steps
# of 4 x 64 tokens on (1, 2) and (2, 2), 2 steps of 2 x 16 on (1, 2)); the
# bar is under half a bf16 ulp (2^-9)
_BF16_LOSS_BAR = 1e-3


# a sharded draw of the reduced model at 16 layers, where the whole
# parameters outweigh one layer and a leaf's draw many times over
_INIT = ("init", dict(arch=_ARCH, overrides=dict(_FP32, num_layers=16),
                      seed=3))


def _batches(n, seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, 256, (4, 17), dtype=np.int32)
        mask = np.ones((4, 16), np.float32)
        mask[3, 5:] = 0.0
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                    "mask": mask})
    return out


def _job(**kw):
    return ("train_lm", dict(arch=_ARCH, overrides=_FP32, seed=3,
                             microbatches=2, whole=True, **kw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_loop")
    d = {k: str(root / k) for k in ("clean", "hit", "mesh", "one")}
    batches = _batches(3)
    # a 1-rank checkpoint first, for a mesh to restore
    one = data_axis.train_lm_job(None, _ARCH, overrides=_FP32, seed=3,
                                 batches=batches[:2], microbatches=2,
                                 whole=True, save=d["one"], device="cpu")
    loop = ("train_loop", dict(arch=_ARCH, overrides=_FP32, **_LOOP))
    worlds = [
        ((0, 1, 2, 3), [
            (loop[0], dict(loop[1], ckpt_dir=d["clean"])),
            (loop[0], dict(loop[1], ckpt_dir=d["hit"], fail_at=(3,))),
            _job(batches=batches[:2], save=d["mesh"], expect=[(1, 2)]),
            _job(batches=batches),
            ("adjoint", {"shape": (3, 4, 5)}), _INIT], (2, 2)),
        ((0, 1), [
            _job(batches=batches[2:], restore=d["mesh"]),
            _job(batches=batches[2:], restore=d["one"]),
            ("adjoint", {"shape": (3, 4, 5)})], (1, 2)),
    ]
    ranks = launch(data_axis.run_worlds, 4, device="cpu", args=(worlds,))
    return {"dirs": d, "one": one, "batches": batches,
            "22": [r[0] for r in ranks], "12": [ranks[r][1] for r in (0, 1)]}


def _equal_trees(a, b):
    la, lb = (flatten_tree(t)[0] for t in (a, b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_a_fault_on_every_rank_restores_and_resumes(runs):
    """A fault at step 3 on every rank: all ranks restore the step-2
    checkpoint, replay, and end on the uninterrupted run's state bit for
    bit; each rank beats its own heart."""
    for rank in runs["22"]:
        clean, hit = rank["train_loop"]["metrics"], \
            rank["train_loop#1"]["metrics"]
        assert clean["recoveries"] == 0 and hit["recoveries"] == 1
        assert clean["final_step"] == hit["final_step"] == 4
        assert hit["loss"] == clean["loss"] and np.isfinite(hit["loss"])
        assert len(hit["losses"]) == 5 and hit["losses"][3] == \
            clean["losses"][2]
    lead = runs["22"][0]
    _equal_trees(lead["train_loop#1"]["state"], lead["train_loop"]["state"])
    assert Heartbeat.dead_hosts(runs["dirs"]["hit"], 60.0) == []
    assert len([n for n in os.listdir(runs["dirs"]["hit"])
                if n.startswith("heartbeat_")]) == 4


def test_a_2x2_checkpoint_restores_bitwise_on_1x2_and_one_rank(runs):
    """The ``(2, 2)`` checkpoint (rank 0 wrote the state it gathered) is,
    restored on ``(1, 2)`` and gathered, and restored on one device, the
    saved state bit for bit; the next step's loss is the uninterrupted
    ``(2, 2)`` run's third within 1e-5."""
    saved = runs["22"][0]["train_lm"]["saved"]
    on12 = runs["12"][0]["train_lm"]
    assert on12["restored_step"] == 2
    _equal_trees(on12["restored"], saved)
    # each rank's restored blocks, by digest, as the writer cut them
    expected = on12["expected"]
    assert len(expected) == 2
    for r, rank in enumerate(runs["12"]):
        assert rank["train_lm"]["digests"] == expected[r]
    cfg = configs.get_reduced(_ARCH).replace(**_FP32)
    d = runs["dirs"]["mesh"]
    state = restore_checkpoint(d, latest_step(d),
                               train.init_state(cfg, None, "meta"))
    _equal_trees(state, saved)
    step = steps.make_train_step(cfg, warmup=2, total_steps=10,
                                 microbatches=2)
    batch = {k: torch.from_numpy(v) for k, v in runs["batches"][2].items()}
    _, _, m = step(*state, batch)
    want = runs["22"][0]["train_lm#3"]["metrics"][2]["loss"]
    for got in (float(m["loss"]), on12["metrics"][0]["loss"]):
        assert abs(got - want) <= _VALUE_BAR * abs(want), (got, want)


def test_a_1_rank_checkpoint_restores_on_a_mesh(runs):
    """The checkpoint one device wrote restores on ``(1, 2)``: gathered,
    it is the saved state bit for bit, and the next step's loss is the
    1-rank run's third within 1e-5."""
    got = runs["12"][0]["train_lm#1"]
    _equal_trees(got["restored"], runs["one"]["saved"])
    want = runs["22"][0]["train_lm#3"]["metrics"][2]["loss"]
    loss = got["metrics"][0]["loss"]
    assert abs(loss - want) <= _VALUE_BAR * abs(want)


def test_a_sharded_draw_holds_a_rank_near_its_share(runs):
    """``init_state(tp=)`` on ``(2, 2)`` draws each leaf whole and cuts it
    to this rank's block as it is drawn: the bits of the whole draw cut
    afterwards, and a rank's peak live bytes at most its state plus one
    whole layer and one leaf's draw (fp32, scaled, cast: 3 copies), below
    the peak of the whole draw cut afterwards."""
    cfg = configs.get_reduced(_ARCH).replace(**_INIT[1]["overrides"])
    like = transformer.flatten_params(
        transformer.init_params(None, cfg, device="meta"))

    def drawn(k, t):   # elements of one draw of the leaf
        return t.numel() // (cfg.repeat if k.startswith("blocks.") else 1)

    layer = max(sum(drawn(k, t) * t.element_size() for k, t in like.items()
                    if k.startswith(f"blocks.{pi}."))
                for pi in range(len(cfg.block_pattern)))
    leaf = 4 * max(drawn(k, t) for k, t in like.items())
    for rank in runs["22"]:
        got = rank["init"]
        assert got["bitwise"]
        bound = got["kept"] + layer + 3 * leaf
        assert got["peak"] <= bound < got["peak_whole"], (got, bound)


@pytest.mark.parametrize("world", ["22", "12"])
@pytest.mark.parametrize("fn", ["fsdp_gather", "sum_partials", "copy_in"])
def test_collective_adjoints(runs, fn, world):
    """<A x, y> = <x, A^T y> over the mesh (each rank's terms summed), to
    1e-6 relative, for the FSDP gather (its backward the fixed-order
    reduce-scatter), the sum over ``model`` (backward identity) and the
    copy into the model region (backward the sum)."""
    ax = sum(r["adjoint"][fn][0] for r in runs[world])
    aty = sum(r["adjoint"][fn][1] for r in runs[world])
    assert abs(ax - aty) <= 1e-6 * max(abs(ax), abs(aty)), (ax, aty)


def _shapes(cfg):
    like = transformer.flatten_params(
        steps._model_fns(cfg).init_params(None, cfg, device="meta"))
    return {k: tuple(v.shape) for k, v in like.items()}


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "xlstm-1.3b",
                                  "jamba-1.5-large-398b", "whisper-small"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=str)
def test_untrained_configs_raise_over_a_mesh(arch, shape):
    """A MoE, recurrent or encoder-decoder config trained over more than
    one rank raises, naming what is left, before any group is made."""
    cfg = configs.get_reduced(arch)
    mesh = make_smoke_mesh(2, model=shape[1])
    with pytest.raises(NotImplementedError, match="later item"):
        steps.make_train_step(cfg, mesh=mesh)
    with pytest.raises(NotImplementedError, match="later item"):
        ModelParallel(mesh, cfg, _shapes(cfg), train=True)


def test_cli_trains_on_a_mesh(capfd):
    """``train --devices 2`` spawns a ``(1, 2)`` mesh of gloo ranks; rank 0
    reports, with the 1-device run's losses within the bf16 bar (the
    config's dtype; the fp32 equality is the API's, held above)."""
    argv = ["--arch", _ARCH, "--reduced", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "16", "--microbatches", "2"]
    train.main(argv + ["--devices", "2"])
    out = capfd.readouterr().out
    assert out.count("[train] done on a (1, 2) (data, model) mesh") == 1
    train.main(argv)
    one = capfd.readouterr().out

    def losses(text):
        line = [ln for ln in text.splitlines() if "'losses'" in ln][0]
        return eval(line[line.index("'losses': ") + 10:].split("]")[0]
                    + "]")

    for a, b in zip(losses(out), losses(one)):
        assert abs(a - b) <= _BF16_LOSS_BAR * abs(b), (a, b)
