"""The LM train step over a ``(data, model)`` mesh of gloo CPU ranks: FSDP
over ``data`` and tensor parallelism over ``model`` (heads, FFN, vocab),
trained, against the reference's jitted ``make_train_step`` on one device.

One spawn of 4 ranks runs both worlds (``data_axis.run_worlds``): the
``(2, 2)`` mesh on all four, then the ``(1, 2)`` mesh on ranks 0-1.  Each
runs 3 steps of ``steps.make_train_step(mesh=)`` at 2 microbatches for the
reduced StableLM-2-1.6B (MHA; remat on, at 1,024 tokens: the chunked,
vocab-parallel CE and each layer's FSDP gather again in the recompute),
Qwen3-32B (GQA, qk-norm) and Gemma-3-12B (a tied head, sliding-window
layers) in fp32, from the reference's ``init_params``.  The mask differs
between the microbatches, so a rank that took a contiguous block of the
batch (and so regrouped the microbatches' normalisers) would move the
loss.  Held at ``tests/test_torch_lm_train.py``'s fp32 bars: loss and lr
at 1e-5, ``grad_norm``, the first step's gradients (gathered whole) and
every parameter after each step at 1e-4 x max(1, max|ref|), the final
moments at relative L2 1e-4.  Each rank holds ``1 / (data x model)`` of
every parameter and moment whose spec names both axes, and launches, by
part, what one device's step launches (the plain versions' dispatches,
which stand in for kernels 3 and 4 on the CPU).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs
from repro_torch.launch import data_axis
from repro_torch.launch.mesh import launch

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# arch -> (config overrides on both sides, seq)
_CASES = {"stablelm-1.6b": ({"remat": True}, 1024),
          "qwen3-32b": ({}, 32),
          "gemma3-12b": ({}, 32)}
_MESHES = {(2, 2): (0, 1, 2, 3), (1, 2): (0, 1)}
_STEPS, _MICRO, _ROWS = 3, 2, 4
_VALUE_BAR, _GRAD_BAR, _MOMENT_BAR = 1e-5, 1e-4, 1e-4
_B1 = 0.9


@pytest.fixture(autouse=True)
def _no_sharding_hook(monkeypatch):
    monkeypatch.setattr(jlayers, "_CONSTRAINT_FN", None)


def _batches(vocab, seq, seed):
    """``_STEPS`` global batches; the second microbatch's rows are masked
    far more than the first's, so the microbatches' normalisers differ."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(_STEPS):
        toks = rng.integers(0, vocab, (_ROWS, seq + 1), dtype=np.int32)
        mask = np.ones((_ROWS, seq), np.float32)
        mask[0, :3] = 0.0
        mask[3, seq // 4:] = 0.0
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                    "mask": mask})
    return out


def _inputs(arch):
    """The reference's ``init_params`` (numpy) and the global batches."""
    kw, seq = _CASES[arch]
    jcfg = jconfigs.get_reduced(arch).replace(dtype="float32", **kw)
    start = jax.tree.map(np.asarray,
                         jtr.init_params(jax.random.PRNGKey(11), jcfg))
    return jcfg, start, _batches(jcfg.vocab, seq, 3)


def _reference(jcfg, start, batches):
    """The reference's jitted steps: per step the parameters, the metrics
    and the AdamW state."""
    jstep = jax.jit(jsteps.make_train_step(jcfg, warmup=2, total_steps=10,
                                           microbatches=_MICRO))
    jp = jax.tree.map(jnp.asarray, start)
    jo = jadamw_init(jp)
    runs = []
    for b in batches:
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, b))
        runs.append((jax.tree.map(np.asarray, jp),
                     {k: float(v) for k, v in jm.items()},
                     jax.tree.map(np.asarray, jo)))
    return runs


@pytest.fixture(scope="module")
def trained():
    inputs = {arch: _inputs(arch) for arch in _CASES}
    jobs = [("train_lm", {
        "arch": arch, "overrides": dict(_CASES[arch][0], dtype="float32"),
        "params": start, "batches": batches, "microbatches": _MICRO,
        "whole": True, "grads": True})
        for arch, (_, start, batches) in inputs.items()]
    order = list(_MESHES)
    ranks = launch(data_axis.run_worlds, 4, device="cpu",
                   args=([(_MESHES[m], jobs, m) for m in order],),
                   join=False)
    want = {arch: _reference(*args) for arch, args in inputs.items()}
    out = ranks.result()
    return {"want": want,
            **{m: [out[r][i] for r in _MESHES[m]]
               for i, m in enumerate(order)}}


def _job(rank, arch):
    i = list(_CASES).index(arch)
    return rank["train_lm" if i == 0 else f"train_lm#{i}"]


def _flat(tree):
    from repro_torch.models import transformer
    return transformer.flatten_params(tree)


def _close(got, want, bar, what):
    got = np.asarray(got.float().numpy() if hasattr(got, "float") else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= bar * max(1.0, float(np.abs(want).max())), (what, err)


@pytest.mark.parametrize("mesh", list(_MESHES), ids=str)
@pytest.mark.parametrize("arch", list(_CASES))
def test_steps_match_the_reference(trained, arch, mesh):
    """Loss, lr and gradient norm of each step, and every parameter after
    it, on every rank (the metrics) and gathered on rank 0 (the
    parameters), against the reference's jitted step."""
    runs = trained["want"][arch]
    lead = _job(trained[mesh][0], arch)
    for i, (jp, jm, _) in enumerate(runs):
        for rank in trained[mesh]:
            got = _job(rank, arch)["metrics"][i]
            for k, bar in (("loss", _VALUE_BAR), ("lr", _VALUE_BAR),
                           ("grad_norm", _GRAD_BAR)):
                assert abs(got[k] - jm[k]) <= bar * abs(jm[k]), (i, k, got,
                                                                 jm)
        jflat = _flat(jp)
        tflat = _flat(lead["params"][i])
        assert tflat.keys() == jflat.keys()
        for k, t in tflat.items():
            _close(t, jflat[k], _GRAD_BAR, (i, k))


@pytest.mark.parametrize("mesh", list(_MESHES), ids=str)
@pytest.mark.parametrize("arch", list(_CASES))
def test_first_gradients_and_moments_match_the_reference(trained, arch,
                                                         mesh):
    """The first step's gradients, gathered whole on rank 0, against the
    reference's (its first AdamW step's ``mu / ((1 - b1) x clip scale)``);
    the final moments, gathered whole, at relative L2 1e-4."""
    runs = trained["want"][arch]
    lead = _job(trained[mesh][0], arch)
    _, jm, jo = runs[0]
    scale = min(1.0, 1.0 / jm["grad_norm"])
    jmu = _flat(jo.mu)
    assert lead["grads"].keys() == jmu.keys()
    for k, g in lead["grads"].items():
        _close(g, jmu[k] / ((1 - _B1) * scale), _GRAD_BAR, k)
    final = lead["opt"]
    jfinal = runs[-1][2]
    for part in ("mu", "nu", "master"):
        want, got = _flat(getattr(jfinal, part)), getattr(final, part)
        for k, t in got.items():
            w = np.asarray(want[k], np.float64)
            rel = (np.linalg.norm(t.double().numpy() - w)
                   / max(np.linalg.norm(w), 1e-30))
            assert rel <= _MOMENT_BAR, (part, k, rel)
    assert int(final.step) == _STEPS


@pytest.mark.parametrize("mesh", list(_MESHES), ids=str)
@pytest.mark.parametrize("arch", list(_CASES))
def test_each_rank_holds_its_blocks(trained, arch, mesh):
    """A parameter or moment whose spec names both axes: 1 / (data x
    model) of it on each rank; one that names neither: whole; the rank's
    bytes of parameters and AdamW state under the whole's."""
    dp, m = mesh
    cfg = configs.get_reduced(arch)
    for rank in trained[mesh]:
        got = _job(rank, arch)
        split = 0
        for name, (held, whole, spec) in got["leaves"].items():
            axes = {a for e in spec if e for a in
                    (e if isinstance(e, tuple) else (e,))}
            if {"data", "model"} <= axes:
                assert held * dp * m == whole, name
                split += 1
            elif not axes:
                assert held == whole, name
        # the embedding (and an untied head), and per pattern position the
        # stacks of q/k/v/o and of the three FFN leaves, each a parameter
        # and a moment
        heads = 1 if cfg.tie_embeddings else 2
        assert split == 2 * (heads + 7 * len(cfg.block_pattern))
        held, whole = got["state_bytes"]
        assert held < whole


@pytest.mark.parametrize("mesh", list(_MESHES), ids=str)
@pytest.mark.parametrize("arch", list(_CASES))
def test_each_rank_launches_the_one_device_steps_kernels(trained, arch,
                                                         mesh):
    """Per rank, the first step's products and attentions, by part, are
    one device's (``chip_smoke.lm_train_launches``): every product through
    ``MatmulFn`` on the rank's blocks, every attention through
    ``FlashAttentionFn`` on its heads."""
    kw, seq = _CASES[arch]
    cfg = configs.get_reduced(arch).replace(**kw)
    want = chip_smoke.lm_train_launches(cfg, seq, _MICRO)
    for rank in trained[mesh]:
        assert _job(rank, arch)["parts"] == want
