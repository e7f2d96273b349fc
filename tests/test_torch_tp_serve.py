"""The LM ``Server`` over a ``(data, model)`` mesh of gloo CPU ranks: tensor
parallelism over ``model`` (heads, FFN, vocab) and FSDP over ``data``,
served.

One spawn of 4 ranks runs both worlds (``data_axis.run_worlds``): the
``(2, 2)`` mesh on all four, then the ``(1, 2)`` mesh on ranks 0-1.  Each
serves the reduced StableLM-2-1.6B (MHA) and the reduced Qwen3-32B (GQA,
qk-norm) in fp32 from the reference's ``init_params``: a prefill's logits
and 4 greedy decode steps' logits are held to the reference's model
functions at ``tests/test_torch_lm.py``'s bar for the unsharded port (1e-4
x max|ref|), ``Server.generate``'s tokens equal the 1-rank ``Server``'s,
and each rank holds ``1 / (data x model)`` of every leaf whose spec names
both axes.  Gemma-3-12B's reduced config (sliding-window rings, a tied
head, GQA) decodes past its rings' wrap on every mesh as the 1-rank port
does.  The configs the model axis does not serve yet raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.distributed.sharding import ModelParallel
from repro_torch.launch import data_axis
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import launch, make_smoke_mesh
from repro_torch.models import transformer

_ARCHS = ("stablelm-1.6b", "qwen3-32b")
_MESHES = {(2, 2): (0, 1, 2, 3), (1, 2): (0, 1)}
_DECODE = 4
_LOGIT_BAR = 1e-4
# 8 prompt tokens and 10 steps: past the reduced Gemma's 16-slot rings
_GEMMA = dict(arch="gemma3-12b", dtype="float32", decode=10, gen=4)


@pytest.fixture(autouse=True)
def _no_sharding_hook(monkeypatch):
    monkeypatch.setattr(jlayers, "_CONSTRAINT_FN", None)


def _prompts():
    return np.random.default_rng(5).integers(0, 256, (4, 8), dtype=np.int32)


def _ref_params(arch):
    jcfg = jconfigs.get_reduced(arch).replace(dtype="float32")
    jp = jtr.init_params(jax.random.PRNGKey(7), jcfg)
    return jcfg, jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def served():
    trees = {a: _ref_params(a) for a in _ARCHS}
    prompts = _prompts()
    jobs = [("lm", {"arch": a, "dtype": "float32", "params": trees[a][2],
                    "prompts": prompts, "decode": _DECODE, "gen": 6})
            for a in _ARCHS]
    jobs.append(("lm", dict(_GEMMA, prompts=prompts)))
    order = list(_MESHES)
    ranks = launch(data_axis.run_worlds, 4, device="cpu",
                   args=([(_MESHES[m], jobs, m) for m in order],),
                   join=False)
    one = {"gemma": data_axis.lm_job(None, prompts=prompts, device="cpu",
                                     **_GEMMA)}
    for a in _ARCHS:
        cfg = configs.get_reduced(a).replace(dtype="float32")
        srv = tserve.Server(cfg, max_len=16, device="cpu",
                            params=transformer.load_jax_params(
                                trees[a][2], cfg, device="cpu"))
        one[a] = srv.generate(prompts, 6)
    out = ranks.result()
    return {"trees": trees, "one": one, "prompts": prompts,
            **{m: [out[r][i] for r in _MESHES[m]]
               for i, m in enumerate(order)}}


_REF: dict = {}


def _reference(served, arch, fed):
    """The reference's prefill and decode logits on the tokens the port fed
    (one jitted ``decode_step`` a shape, kept for every mesh feeding the
    same tokens)."""
    key = (arch, tuple(t.tobytes() for t in fed))
    if key not in _REF:
        jcfg, jp, _ = served["trees"][arch]
        prompts = served["prompts"]
        step = jax.jit(jtr.decode_step, static_argnums=(4,))
        jc = jtr.init_caches(jcfg, prompts.shape[0], 16)
        out, jc = step(jp, jnp.asarray(prompts), jc, jnp.int32(0), jcfg)
        outs = [out]
        for i, tok in enumerate(fed):
            out, jc = step(jp, jnp.asarray(tok), jc,
                           jnp.int32(prompts.shape[1] + i), jcfg)
            outs.append(out)
        _REF[key] = outs
    return _REF[key]


def _job(rank, arch):
    return rank["lm" if arch == _ARCHS[0] else "lm#1"]


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= _LOGIT_BAR * float(np.abs(want).max()), err


@pytest.mark.parametrize("mesh", list(_MESHES), ids=str)
@pytest.mark.parametrize("arch", _ARCHS)
def test_logits_match_reference(served, arch, mesh):
    lead = _job(served[mesh][0], arch)
    want = _reference(served, arch, lead["decode_tokens"])
    _close(lead["prefill"], want[0])
    for i in range(_DECODE):
        _close(lead["decode"][i], want[1 + i])
    for rank in served[mesh][1:]:
        got = _job(rank, arch)
        assert all(np.array_equal(a, b) for a, b in
                   zip(got["decode_tokens"], lead["decode_tokens"]))


@pytest.mark.parametrize("mesh", list(_MESHES), ids=str)
@pytest.mark.parametrize("arch", _ARCHS)
def test_tokens_equal_one_rank_server(served, arch, mesh):
    for rank in served[mesh]:
        got = _job(rank, arch)["tokens"]
        assert got.shape == (4, 6) and got.dtype == np.int32
        np.testing.assert_array_equal(got, served["one"][arch])


@pytest.mark.parametrize("mesh", list(_MESHES), ids=str)
@pytest.mark.parametrize("arch", _ARCHS)
def test_each_rank_holds_its_blocks(served, arch, mesh):
    dp, m = mesh
    for rank in served[mesh]:
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
        # embed, the head, and per pattern position the stacks of q/k/v/o
        # and of the three FFN leaves
        assert split == 2 + 7 * len(configs.get_reduced(arch).block_pattern)
        held, whole = got["param_bytes"]
        assert held < whole


@pytest.mark.parametrize("mesh", list(_MESHES), ids=str)
def test_local_attention_and_tied_head_match_one_rank(served, mesh):
    """The reduced Gemma (5 sliding-window layers a period, each rank's ring
    of its own KV heads; the tied head's vocab block is its embedding
    block's transpose): the prefill's and 10 greedy steps' logits, past
    the wrap, at the logit bar of the 1-rank port server, and the same
    tokens."""
    want = served["one"]["gemma"]
    for rank in served[mesh]:
        got = rank["lm#2"]
        assert all(np.array_equal(a, b) for a, b in
                   zip(got["decode_tokens"], want["decode_tokens"]))
        _close(got["prefill"], want["prefill"].numpy())
        for g, w in zip(got["decode"], want["decode"]):
            _close(g, w.numpy())
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def _shapes(cfg):
    like = transformer.flatten_params(transformer.init_params(
        None, cfg, device="meta"))
    return {k: tuple(v.shape) for k, v in like.items()}


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "xlstm-1.3b"])
def test_unserved_configs_raise(arch):
    cfg = configs.get_reduced(arch)
    with pytest.raises(NotImplementedError, match="later item"):
        ModelParallel(make_smoke_mesh(2), cfg, _shapes(cfg))
    with pytest.raises(NotImplementedError, match="later item"):
        tserve.Server(configs.get_reduced("whisper-small"), device="cpu",
                      mesh=make_smoke_mesh(2))


def test_a_split_that_cuts_a_head_raises():
    cfg = configs.get_reduced("qwen3-32b")          # 2 KV heads
    with pytest.raises(ValueError, match="cut a head"):
        ModelParallel(make_smoke_mesh(4, model=4), cfg, _shapes(cfg))


def test_cli_spawns_the_ranks(capfd):
    tserve.main(["--arch", "stablelm-1.6b", "--reduced", "--device", "cpu",
                 "--devices", "2", "--batch", "2", "--prompt-len", "4",
                 "--gen-len", "4"])
    out = capfd.readouterr().out
    assert out.count("[serve] stablelm-1.6b-reduced") == 1   # rank 0
    assert "(1, 2) (data, model)" in out
