"""The MoE FFN (``repro_torch.models.moe``) in the port against the JAX
reference, on the CPU.

The same numpy inputs, drawn from a seed, and the same parameters (the
reference's ``moe_init`` / ``init_params`` carried across leaf for leaf, by
``transformer.load_jax_params`` for a whole model) go through
``repro.models.moe`` and the port, at ``qwen3-moe-30b-a3b``'s reduced
configuration (8 experts, top-2, groups of 64) and
``llama4-scout-17b-a16e``'s (4 experts, top-1, a shared expert of 96).  The
reference's MoE is plain ``jnp``, so no Pallas kernel is involved; on the
CPU the port's ``backend="kernels"`` runs kernel 3's plain versions (the
router's 2-D product and the experts' batched form, fp32 ``torch.bmm``)
and ``backend="torch"`` runs ``torch.matmul`` and ``torch.bmm``.

Routing is discontinuous: a last-bit difference in a router input can swap
the k-th and (k+1)-th expert.  In fp32 the router inputs agree to ~1e-7, so
the tests hold every route and kept mask equal to the reference's and print
the seed's smallest top-k gap (the margin a swap would need).  In bf16 the
FFN is held alone on identical inputs at the 5% bar; through the whole
model the two frameworks round each layer's input apart and some routes
swap, so the swapped routes are counted and printed and every logit row of
a token whose routes all agree is held at 5%.

Bars, the reference's (ROADMAP.md, "Oracle"): fp32 1e-5 x max(1, max|ref|)
on the FFN's output, 1e-4 x max|ref| on logits; bf16 5%.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.launch import serve
from repro_torch.models import moe, transformer

_ARCHS = ("qwen3-moe-30b-a3b", "llama4-scout-17b-a16e")
_JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
_CFG_DTYPE = {"fp32": "float32", "bf16": "bfloat16"}
_VALUE_BAR = {"fp32": 1e-5, "bf16": 5e-2}
_LOGIT_BAR = {"fp32": 1e-4, "bf16": 5e-2}
# (B, S, capacity factor): groups within the sequence (S = 128, two groups
# of 64 a row); across the batch's tokens (decode: 4 tokens, cap 1, so
# tokens that share an expert are dropped); and nearly every slot dropped
_CASES = {"within_sequence": (2, 128, None), "across_batch": (4, 1, None),
          "capacity_1e-9": (2, 128, 1e-9)}

# chip_smoke.py's launch oracles
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True)
def _no_sharding_hook(monkeypatch):
    """The reference's model functions without a mesh: another test file in
    this process may have left the sharding hook of its ``Server``."""
    monkeypatch.setattr(jlayers, "_CONSTRAINT_FN", None)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, rtol, floor=1.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(floor, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, rtol * scale)
    return err


def _cfgs(arch, dtype, cf=None, **kw):
    """The port's and the reference's reduced config of ``arch``."""
    out = []
    for mod in (configs, jconfigs):
        cfg = mod.get_reduced(arch).replace(dtype=_CFG_DTYPE[dtype], **kw)
        if cf is not None:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                      capacity_factor=cf))
        out.append(cfg)
    return out


def _tensors(tree, dtype):
    """A reference tree of arrays as the port's tensors, leaf for leaf (an
    fp32 router stays fp32)."""
    return {k: _tensors(v, dtype) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32)).to(
                torch.float32 if v.dtype == jnp.float32 else dtype)
            for k, v in tree.items()}


def _jax_route(p, x, cfg):
    """The reference's routing (``repro/models/moe.py:50-77``) on x (B, S,
    D): (idx, keep, logits), each (..., g, k) but the logits (..., g, E)."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    if s >= m.group_size and s % m.group_size == 0:
        g = m.group_size
        xt, lead = x.reshape(b, s // g, g, d), (b, s // g)
    else:
        g = min(m.group_size, b * s)
        xt, lead = x.reshape(1, b * s // g, g, d), (1, b * s // g)
    cap = max(1, int(-(-g * k // e) * m.capacity_factor))
    logits = xt.astype(jnp.float32) @ p["router"]
    _, idx = jax.lax.top_k(logits, k)
    flat = jax.nn.one_hot(idx, e, dtype=jnp.int32).reshape(*lead, g * k, e)
    pos = ((jnp.cumsum(flat, axis=2) - 1) * flat).sum(-1).reshape(*lead, g, k)
    return np.asarray(idx), np.asarray(pos < cap), np.asarray(logits)


def _topk_gap(logits, k):
    """The smallest margin between a row's k-th and (k+1)-th logit."""
    top = -np.sort(-np.asarray(logits, np.float64), axis=-1)
    return float((top[..., k - 1] - top[..., k]).min())


# --------------------------------------------------------- the FFN alone ---

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("case", list(_CASES))
@pytest.mark.parametrize("arch", _ARCHS)
def test_moe_ffn_matches_reference(arch, case, backend, dtype):
    b, s, cf = _CASES[case]
    tcfg, jcfg = _cfgs(arch, dtype, cf)
    jp = jmoe.moe_init(jax.random.PRNGKey(3), jcfg, _JDT[dtype])
    tp = _tensors(jp, _TDT[dtype])
    x = np.random.default_rng(4).standard_normal(
        (b, s, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, _JDT[dtype])
    tx = torch.from_numpy(x).to(_TDT[dtype])
    want = jmoe.moe_ffn(jp, jx, jcfg)
    with torch.no_grad():
        got = moe.moe_ffn(tp, tx, tcfg, backend)
        idx, _, _, keep = moe.route(tp["router"], moe.group_tokens(tx, tcfg),
                                    tcfg, backend)
    assert got.dtype == _TDT[dtype]
    err = _close(got, want, _VALUE_BAR[dtype])
    j_idx, j_keep, logits = _jax_route(jp, jx, jcfg)
    gap = _topk_gap(logits, tcfg.moe.top_k)
    print(f"{arch} {case} {backend} {dtype}: max |err| {err:.3e}, smallest "
          f"top-k gap {gap:.3e}, kept {j_keep.mean():.3f}")
    if dtype == "fp32":
        np.testing.assert_array_equal(idx.numpy(), j_idx)
        np.testing.assert_array_equal(keep.numpy(), j_keep)
    if case == "across_batch":
        assert not j_keep.all()         # the decode case drops tokens
    if case == "capacity_1e-9":
        assert j_keep.mean() < 0.5


@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("arch", _ARCHS)
def test_ties_route_to_the_lowest_experts(arch, backend):
    """An all-zero token row gives equal logits: it routes to experts 0 ..
    k - 1, as ``lax.top_k`` orders ties."""
    tcfg, jcfg = _cfgs(arch, "fp32")
    jp = jmoe.moe_init(jax.random.PRNGKey(5), jcfg, jnp.float32)
    tp = _tensors(jp, torch.float32)
    x = np.random.default_rng(6).standard_normal(
        (1, 4, tcfg.d_model)).astype(np.float32)
    x[0, 1] = 0.0
    idx, gates, _, _ = moe.route(
        tp["router"], moe.group_tokens(torch.from_numpy(x), tcfg), tcfg,
        backend)
    k = tcfg.moe.top_k
    assert idx[0, 0, 1].tolist() == list(range(k))
    assert torch.allclose(gates[0, 0, 1], torch.full((k,), 1.0 / k))
    j_idx, _, _ = _jax_route(jp, jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(idx.numpy(), j_idx)


def test_a_group_the_reference_cannot_form_raises():
    """100 tokens in one row, groups of 64: the sequence does not split,
    and neither do the batch's tokens.  The reference asserts; the port
    raises ``ValueError`` and never regroups."""
    tcfg, jcfg = _cfgs("qwen3-moe-30b-a3b", "fp32")
    jp = jmoe.moe_init(jax.random.PRNGKey(7), jcfg, jnp.float32)
    x = np.zeros((1, 100, tcfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="groups of 64"):
        moe.moe_ffn(_tensors(jp, torch.float32), torch.from_numpy(x), tcfg)


@pytest.mark.parametrize("g,cap", [(512, 40), (4, 1), (64, 5)])
def test_capacity_as_the_reference_writes_it(g, cap):
    """Qwen3-MoE's prefill groups (512 tokens, 40 slots), a batch-4 decode
    (1) and a 64-token group (5)."""
    assert moe.capacity(g, configs.get_config("qwen3-moe-30b-a3b")) == cap


# ---------------------------------------------------- the batched matmul ---

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("m", [1, 40, 320])
@pytest.mark.parametrize("e", [1, 16, 128])
def test_matmul_batched_plain_matches_einsum(e, m, dtype):
    rng = np.random.default_rng(e * 1000 + m)
    a = rng.standard_normal((e, m, 24)).astype(np.float32)
    b = rng.standard_normal((e, 24, 40)).astype(np.float32)
    ta, tb = torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype)
    got = kmm.matmul_batched(ta, tb)
    assert got.dtype == dtype and got.shape == (e, m, 40)
    assert torch.equal(got, kmm.matmul_batched_plain(ta, tb))
    want = np.einsum("emk,ekn->emn", ta.float().numpy().astype(np.float64),
                     tb.float().numpy().astype(np.float64))
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_matmul_batched_checks_its_operands():
    with pytest.raises(ValueError, match="matmul_batched"):
        kmm.matmul_batched(torch.zeros(2, 3, 4), torch.zeros(3, 4, 5))
    with pytest.raises(ValueError, match="matmul_batched"):
        kmm.matmul_batched(torch.zeros(2, 3, 4), torch.zeros(2, 5, 5))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kmm.matmul_batched(torch.zeros(2, 3, 4, dtype=torch.float16),
                           torch.zeros(2, 4, 5, dtype=torch.float16))


def test_matmul_batched_variant_rules():
    """The batched form takes ``matmul_variant``'s rule on its last two
    axes: bf16 with K and N multiples of 8 on ``"wgmma"``, else
    ``"simt"``."""
    bf = torch.bfloat16
    assert kmm.matmul_variant(torch.zeros(128, 320, 2048, dtype=bf),
                              torch.zeros(128, 2048, 768, dtype=bf)) == \
        "wgmma"
    assert kmm.matmul_variant(torch.zeros(4, 3, 36, dtype=bf),
                              torch.zeros(4, 36, 40, dtype=bf)) == "simt"
    assert kmm.matmul_variant(torch.zeros(4, 3, 64),
                              torch.zeros(4, 64, 40)) == "simt"


# ------------------------------------------------------- the whole model ---

def _both_params(arch, dtype, seed=0, **kw):
    tcfg, jcfg = _cfgs(arch, dtype, **kw)
    jp = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = transformer.load_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
    return tcfg, jcfg, jp, tp


def _reference_routes(fn):
    """``fn()`` of the reference and its routes, layer by layer:
    ``jax.disable_jit`` runs its ``lax.scan`` as a loop, so each MoE FFN's
    input is a concrete array."""
    seen = []
    orig = jmoe.moe_ffn

    def rec(p, x, cfg):
        seen.append(_jax_route(p, x, cfg))
        return orig(p, x, cfg)

    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jmoe, "moe_ffn", rec)
        out = fn()
    return out, seen


def _port_routes(fn):
    """``fn()`` of the port and its routes, layer by layer."""
    seen = []
    orig = moe.route

    def rec(*args, **kw):
        out = orig(*args, **kw)
        seen.append(out)
        return out

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(moe, "route", rec)
        out = fn()
    return out, seen


def _swapped(t_routes, j_routes, rows):
    """(the tokens of a call whose expert or kept mask differs from the
    reference's in some layer, as a mask of its ``rows`` logit rows; the
    differing (token, layer, slot) routes; all routes)."""
    assert len(t_routes) == len(j_routes)
    hit, differ, total = np.zeros(rows, bool), 0, 0
    for (idx, _, _, keep), (j_idx, j_keep, _) in zip(t_routes, j_routes):
        d = (idx.numpy() != j_idx) | (keep.numpy() != j_keep)
        hit |= d.any(-1).reshape(rows)
        differ += int((idx.numpy() != j_idx).sum())
        total += j_idx.size
    return hit, differ, total


def _hold_logits(got, want, bar, swapped):
    """Logits (B, S, V) within ``bar`` x max|ref|, at every row in fp32
    (``swapped`` is all False there); in bf16 at every row of a token whose
    routes all agree with the reference's.  A swapped route sends a token
    to another expert, a discontinuous change no bar of the arithmetic
    covers: those rows are counted and printed, not held."""
    g, w = (_np(t).reshape(-1, t.shape[-1]) for t in (got, want))
    assert g.shape == w.shape and np.isfinite(g).all()
    tol = bar * float(np.abs(w).max())
    err = np.abs(g - w).max(-1)
    assert (err[~swapped] <= tol).all(), (err[~swapped].max(), tol)
    return int((err[swapped] > tol).sum())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", _ARCHS)
def test_forward_and_decode_match_reference(arch, dtype):
    """``forward`` and ``decode_step`` (a 128-token prefill at cache_pos 0,
    then 3 one-token steps fed the reference's greedy tokens) against the
    reference's on both backends.  In fp32 every layer's routes and kept
    masks equal the reference's and every logit row is held at 1e-4.  In
    bf16 the two frameworks round the layers' inputs apart and some routes
    swap: the swapped (token, layer, slot) routes are counted and printed,
    and every row of a token whose routes all agree is held at 5%."""
    tcfg, jcfg, jp, tp = _both_params(arch, dtype)
    toks = np.random.default_rng(9).integers(0, tcfg.vocab, (2, 128),
                                             dtype=np.int32)
    want, j_fwd = _reference_routes(
        lambda: jtr.forward(jp, jnp.asarray(toks), jcfg))
    jc = jtr.init_caches(jcfg, 2, 132)
    j_steps, tok = [], jnp.asarray(toks)
    for pos in (0, 128, 129, 130):
        (logits, jc), seen = _reference_routes(
            lambda: jtr.decode_step(jp, tok, jc, jnp.int32(pos), jcfg))
        j_steps.append((pos, tok, logits, seen))
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    gap = min(_topk_gap(r[2], tcfg.moe.top_k) for r in j_fwd)
    for backend in ("kernels", "torch"):
        got, t_fwd = _port_routes(lambda: transformer.forward(
            tp, torch.from_numpy(toks), tcfg, backend=backend))
        assert got.dtype == _TDT[dtype]
        assert len(t_fwd) == tcfg.num_layers
        calls = [(got, want, t_fwd, j_fwd)]
        tc = transformer.init_caches(tcfg, 2, 132, device="cpu")
        for pos, tok, w, j_seen in j_steps:
            (logits, tc), t_seen = _port_routes(
                lambda: transformer.decode_step(
                    tp, torch.from_numpy(np.array(tok)), tc, pos, tcfg,
                    backend=backend))
            calls.append((logits, w, t_seen, j_seen))
        differ = total = over = 0
        for g, w, t_seen, j_seen in calls:
            swapped, d, n = _swapped(t_seen, j_seen, g.shape[0] * g.shape[1])
            if dtype == "fp32":
                assert d == 0 and not swapped.any()
            over += _hold_logits(g, w, _LOGIT_BAR[dtype], swapped)
            differ, total = differ + d, total + n
        print(f"{arch} {dtype} {backend}: {differ} of {total} routes swapped "
              f"({differ / total:.2%}), {over} logit rows of their tokens "
              f"past the bar; smallest top-k gap of the forward {gap:.3e}")


@pytest.mark.parametrize("arch", _ARCHS)
def test_server_generate_matches_reference_serve_loop(arch):
    """``Server.generate`` (fp32, kernels backend) against the reference
    ``Server``'s path: the prompt in ONE call of its jitted
    ``make_serve_step`` (``parallel_prefill_ok`` is true for a MoE config),
    then its decode loop.  Tokens equal.  (A MoE model's parallel prefill
    and token loop need not agree: their capacity groups differ.)"""
    tcfg, jcfg, jp, tp = _both_params(arch, "fp32", seed=11)
    toks = np.random.default_rng(12).integers(0, tcfg.vocab, (4, 16),
                                              dtype=np.int32)
    gen, max_len = 8, 16 + 8 + 1
    step = jax.jit(jsteps.make_serve_step(jcfg))
    caches = jtr.init_caches(jcfg, 4, max_len)
    tok, caches = step(jp, caches, {"token": jnp.asarray(toks),
                                    "cache_pos": jnp.int32(0)})
    want = [np.asarray(tok)]
    for t in range(16, 16 + gen - 1):
        tok, caches = step(jp, caches, {"token": tok,
                                        "cache_pos": jnp.int32(t)})
        want.append(np.asarray(tok))
    srv = serve.Server(tcfg, max_len=max_len, device="cpu", params=tp)
    assert srv.parallel_prefill_ok()
    got = srv.generate(toks, gen)
    assert got.shape == (4, gen) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))


@pytest.mark.parametrize("arch", _ARCHS)
def test_parallel_prefill_ok_as_the_reference(arch):
    assert serve.parallel_prefill_ok(configs.get_config(arch))
    assert serve.parallel_prefill_ok(jconfigs.get_config(arch))


@pytest.mark.parametrize("arch", _ARCHS)
def test_load_jax_params_carries_the_moe_tree(arch):
    """The reference tree (an fp32 router beside bf16 expert stacks, and
    Llama-4's shared expert) loads through ``load_tree`` with no code of
    its own, leaf for leaf, bit for bit; a misshapen expert raises."""
    tcfg, _, jp, tp = _both_params(arch, "bf16", seed=2)
    flat = transformer.flatten_params(tp)
    want = transformer.flatten_params(jax.tree.map(np.asarray, jp))
    assert flat.keys() == want.keys()
    assert flat["blocks.0.ffn.router"].dtype == torch.float32
    assert flat["blocks.0.ffn.we_gate"].dtype == torch.bfloat16
    assert ("blocks.0.ffn.shared.w_gate" in flat) == (
        tcfg.moe.shared_expert_ff > 0)
    for k, t in flat.items():
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(want[k], np.float32))
    tree = jax.tree.map(np.asarray, jp)
    tree["blocks"][0]["ffn"]["we_down"] = tree["blocks"][0]["ffn"][
        "we_down"][:, :, :-1]
    with pytest.raises(ValueError, match="we_down"):
        transformer.load_jax_params(tree, tcfg, device="cpu")


def test_moe_every_second_layer_matches_reference():
    """``moe.every_n_layers = 2`` on a two-position attention pattern (as
    Jamba's MoE every second layer, without its mamba mixers): the dense
    FFN at position 0, the MoE at position 1, forward and decode against
    the reference in fp32."""
    moe_cfg = dataclasses.replace(
        configs.get_reduced("qwen3-moe-30b-a3b").moe, every_n_layers=2)
    kw = {"block_pattern": ("attn", "attn"), "d_ff": 80}
    tcfg, jcfg = (c.replace(dtype="float32", moe=moe_cfg, **kw) for c in (
        configs.get_reduced("qwen3-moe-30b-a3b"),
        jconfigs.get_reduced("qwen3-moe-30b-a3b")))
    jp = jtr.init_params(jax.random.PRNGKey(13), jcfg)
    tp = transformer.load_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
    assert set(tp["blocks"][0]["ffn"]) == {"w_gate", "w_up", "w_down"}
    assert "router" in tp["blocks"][1]["ffn"]
    kinds = [fk for *_, fk, _ in transformer.layer_params(tp, tcfg)]
    assert kinds == ["dense", "moe"] * 2
    toks = np.random.default_rng(14).integers(0, tcfg.vocab, (2, 64),
                                              dtype=np.int32)
    with torch.no_grad():
        got = transformer.forward(tp, torch.from_numpy(toks), tcfg)
        _close(got, jtr.forward(jp, jnp.asarray(toks), jcfg), 1e-4,
               floor=0.0)
        tc = transformer.init_caches(tcfg, 2, 65, device="cpu")
        _, tc = transformer.decode_step(tp, torch.from_numpy(toks), tc, 0,
                                        tcfg)
        got1, _ = transformer.decode_step(tp, torch.from_numpy(toks[:, :1]),
                                          tc, 64, tcfg)
    jc = jtr.init_caches(jcfg, 2, 65)
    _, jc = jtr.decode_step(jp, jnp.asarray(toks), jc, jnp.int32(0), jcfg)
    want1, _ = jtr.decode_step(jp, jnp.asarray(toks[:, :1]), jc,
                               jnp.int32(64), jcfg)
    _close(got1, want1, 1e-4, floor=0.0)


def test_an_unaligned_every_n_layers_raises():
    """Every second layer on a one-position pattern would give one stack two
    FFN kinds, which the reference's stacks cannot hold either."""
    cfg = configs.get_reduced("qwen3-moe-30b-a3b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, every_n_layers=2))
    with pytest.raises(ValueError, match="every_n_layers"):
        transformer.check_supported(cfg)


def test_stacked_init_draws_the_weights_as_before():
    """``init_params`` allocates each stack once and draws each layer into
    its slice; a reduced dense config's weights equal the per-layer trees
    drawn in the same order and stacked with ``torch.stack``."""
    cfg = configs.get_reduced("qwen3-32b")
    got = transformer.init_params(torch.Generator().manual_seed(4), cfg,
                                  device="cpu")
    g = torch.Generator().manual_seed(4)
    dtype = torch.bfloat16
    want = {"embed": transformer.normal_init(
        g, (cfg.vocab, cfg.d_model), cfg.d_model ** -0.5, dtype, "cpu"),
        "lm_head": transformer.dense_init(g, cfg.d_model, cfg.vocab, dtype,
                                          device="cpu")}
    layers = [transformer.layer_init(g, cfg, 0, dtype, "cpu")
              for _ in range(cfg.repeat)]
    flat_layers = [transformer.flatten_params(t) for t in layers]
    flat = transformer.flatten_params(got)
    assert torch.equal(flat["embed"], want["embed"])
    assert torch.equal(flat["lm_head"], want["lm_head"])
    for name in flat_layers[0]:
        assert torch.equal(flat[f"blocks.0.{name}"],
                           torch.stack([f[name] for f in flat_layers]))


def test_a_moe_stack_is_built_in_place():
    """The full Qwen3-MoE's shapes on the meta device: 30.5 B parameters,
    an expert stack of (48, 128, 2048, 768)."""
    cfg = configs.get_config("qwen3-moe-30b-a3b")
    flat = transformer.flatten_params(
        transformer.init_params(None, cfg, device="meta"))
    assert flat["blocks.0.ffn.we_gate"].shape == (48, 128, 2048, 768)
    assert flat["blocks.0.ffn.router"].dtype == torch.float32
    assert sum(t.numel() for t in flat.values()) == 30_532_122_624


# ------------------------------------------------------------- launches ---

@pytest.mark.parametrize("arch", _ARCHS)
def test_serve_step_launch_counts(arch):
    """A serve step, prefill or decode, launches ``chip_smoke``'s oracle:
    each MoE layer 4 + 1 two-dimensional matmuls (+ 3 for a shared
    expert), 3 batched ones and 1 attention, and the head (their plain
    versions counted on the CPU); the full configs' counts are phase 29's
    gates."""
    cfg = configs.get_reduced(arch)
    srv = serve.Server(cfg, max_len=12, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    counts = {"matmul": 0, "batched": 0, "flash_attention": 0}

    def count(name, fn):
        def wrapper(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapper

    step = chip_smoke.lm_step_launches(cfg)
    batched = chip_smoke.batched_launches(cfg)
    want = {"matmul": step["matmul"] - batched, "batched": batched,
            "flash_attention": step["flash_attention"]}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kmm, "matmul_plain", count("matmul", kmm.matmul_plain))
        mp.setattr(kmm, "matmul_batched_plain",
                   count("batched", kmm.matmul_batched_plain))
        mp.setattr(kfa, "attention_plain",
                   count("flash_attention", kfa.attention_plain))
        tok, caches, pos = srv.prefill(np.zeros((2, 5), np.int32))
        assert counts == want
        srv.serve_step(srv.params, caches, {"token": tok, "cache_pos": pos})
        assert counts == {k: 2 * v for k, v in want.items()}
    full = configs.get_config("qwen3-moe-30b-a3b")
    assert chip_smoke.lm_step_launches(full)["matmul"] == 48 * 8 + 1
    assert chip_smoke.batched_launches(full) == 48 * 3
    scout = configs.get_config("llama4-scout-17b-a16e").replace(num_layers=4)
    assert chip_smoke.lm_step_launches(scout)["matmul"] == 4 * 11 + 1
    assert chip_smoke.batched_launches(scout) == 4 * 3


def test_a_teacher_forced_route_takes_the_given_experts():
    """``route(experts=)`` takes the given experts, their gates the softmax
    of their own logits, and their slots counted as any route's; given the
    top-k it returns the free route exactly."""
    tcfg, jcfg = _cfgs("qwen3-moe-30b-a3b", "fp32")
    tp = _tensors(jmoe.moe_init(jax.random.PRNGKey(15), jcfg, jnp.float32),
                  torch.float32)
    xt = moe.group_tokens(torch.from_numpy(
        np.random.default_rng(16).standard_normal(
            (2, 64, tcfg.d_model)).astype(np.float32)), tcfg)
    free = moe.route(tp["router"], xt, tcfg)
    again = moe.route(tp["router"], xt, tcfg, experts=free[0])
    for a, b in zip(free, again):
        assert torch.equal(a, b)
    flipped = free[0].flip(-1)
    forced = moe.route(tp["router"], xt, tcfg, experts=flipped)
    assert torch.equal(forced[0], flipped)
    assert torch.allclose(forced[1], free[1].flip(-1))
    assert not torch.equal(forced[2], free[2])
