"""Sliding-window attention (``attn_local``, Gemma-3's local layers) in the
port against the JAX reference, on the CPU.

The same numpy inputs, drawn from a seed, and the same parameters (the
reference's ``init_params`` carried across by
``repro_torch.models.transformer.load_jax_params``) go through the
reference's model functions and the port's, at ``gemma3-12b``'s reduced
configuration (6 layers, 5 local : 1 global, window 16, qk-norm, tied
embeddings).  The reference's attention is plain ``jnp``
(``_chunked_causal(window=)`` without a cache, a ring of ``window`` slots
with one), so no Pallas kernel is involved; on the CPU the port's
``backend="kernels"`` runs kernel 4's plain version with the band and
``backend="torch"`` SDPA with a boolean band mask.

Bars, the reference's (ROADMAP.md, "Oracle"): fp32 1e-5 x max(1, max|ref|)
on values (attention outputs, logits, caches) and 1e-4 on gradients; bf16
5% and 10%.  The cached loop is held to the cache-free forward at the same
bars.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.launch import serve, steps
from repro_torch.models import attention, transformer
from repro_torch.optim import adamw_init

_ARCH = "gemma3-12b"
_JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
_CFG_DTYPE = {"fp32": "float32", "bf16": "bfloat16"}
_VALUE_BAR = {"fp32": 1e-5, "bf16": 5e-2}
_GRAD_BAR = {"fp32": 1e-4, "bf16": 1e-1}

# chip_smoke.py's launch oracle (``windowed_launches``)
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


def _rel_l2(got, want):
    got, want = (_np(a).astype(np.float64) for a in (got, want))
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@functools.lru_cache(maxsize=None)
def _both_params(dtype, seed=0):
    """The configs and the reference's parameters in both packages, made
    once per (dtype, seed): no test changes them (the port's steps return
    new parameters), so each backend's case reads the same ones."""
    tcfg = configs.get_reduced(_ARCH).replace(dtype=_CFG_DTYPE[dtype])
    jcfg = jconfigs.get_reduced(_ARCH).replace(dtype=_CFG_DTYPE[dtype])
    jp = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = transformer.load_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
    return tcfg, jcfg, jp, tp


_REF: dict = {}


def _reference(key, fn):
    """The reference's ``fn()``, run once per ``key``: the backends' cases
    of one test hold the port to the same reference run."""
    if key not in _REF:
        _REF[key] = fn()
    return _REF[key]


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


# ---------------------------------------------------- the config itself ---

def test_gemma_is_supported_and_the_rest_still_raise():
    """Gemma's config passes ``check_supported``, and so, since the
    recurrent mixers were ported, do Jamba's and xLSTM's, full and reduced;
    the rest that the decoder-only module refuses, an encoder-decoder,
    still raises."""
    for arch in (_ARCH, "jamba-1.5-large-398b", "xlstm-1.3b"):
        transformer.check_supported(configs.get_config(arch))
        transformer.check_supported(configs.get_reduced(arch))
    with pytest.raises(NotImplementedError, match="encdec"):
        transformer.check_supported(configs.get_config("whisper-small"))


def test_load_jax_params_carries_gemmas_tree():
    """Gemma's reference tree (the global layers' ``attn_init`` leaves and
    qk-norm gains, the same for the local ones, a tied head) loads with no
    code of its own, leaf for leaf, bit for bit."""
    tcfg, _, jp, tp = _both_params("bf16", seed=2)
    assert "lm_head" not in tp
    flat = transformer.flatten_params(tp)
    want = transformer.flatten_params(jax.tree.map(np.asarray, jp))
    assert flat.keys() == want.keys()
    assert {"blocks.0.mixer.q_norm", "blocks.5.mixer.k_norm"} <= flat.keys()
    for k, t in flat.items():
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(want[k], np.float32))


def test_caches_are_sized_by_kind():
    """A local layer keeps a ring of ``min(max_len, window)`` slots, a
    global one ``max_len``, as the reference's ``init_caches``."""
    tcfg = configs.get_reduced(_ARCH)
    jcfg = jconfigs.get_reduced(_ARCH)
    for max_len in (8, 48):
        got = transformer.init_caches(tcfg, 2, max_len, device="cpu")
        want = jtr.init_caches(jcfg, 2, max_len)
        assert [tuple(c["k"].shape) for c in got] == \
            [tuple(c["k"].shape) for c in want]
        assert got[0]["k"].shape[2] == min(max_len, tcfg.window)
        assert got[5]["k"].shape[2] == max_len


# ------------------------------------------------- windowed attention ---

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("window", [1, 16, 100, 1024, 1500])
def test_windowed_attention_and_grads_match_reference(window, dtype):
    """``attention_plain(window=)`` (kernel 4's plain version) and
    ``FlashAttentionFn`` (its backward :func:`attention_grads`) against the
    reference's ``_chunked_causal(window=)`` and ``jax.vjp``; at S = 1024
    both take two query chunks of 512, so the chunked backward's skipped
    keys and lower band edge are exercised.  A window >= S is the plain
    causal attention."""
    s = 1024
    rng = np.random.default_rng(window)
    q, k, v, cot = (rng.standard_normal((1, 2, s, 16)).astype(np.float32)
                    for _ in range(4))
    pos = jnp.broadcast_to(jnp.arange(s)[None], (1, s))
    jq, jk, jv = (jnp.asarray(a, _JDT[dtype]) for a in (q, k, v))
    want, vjp = jax.vjp(
        lambda a, b, c: jattn._chunked_causal(a, b, c, pos, window),
        jq, jk, jv)
    jgrads = vjp(jnp.asarray(cot, _JDT[dtype]))
    tq, tk, tv = (torch.from_numpy(a).to(_TDT[dtype]).requires_grad_()
                  for a in (q, k, v))
    plain = kfa.attention_plain(tq, tk, tv, window=window)
    _close(plain, want, _VALUE_BAR[dtype])
    out = kfa.FlashAttentionFn.apply(tq, tk, tv, True, window)
    assert torch.equal(out, plain)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(cot).to(_TDT[dtype]))
    for g, jg in zip(grads, jgrads):
        assert g.dtype == _TDT[dtype]
        _close(g, jg, _GRAD_BAR[dtype])
    if window >= s:
        assert torch.equal(plain, kfa.attention_plain(tq, tk, tv))
        for g, g0 in zip(grads, kfa.attention_grads(
                tq, tk, tv, torch.from_numpy(cot).to(_TDT[dtype]))):
            assert torch.equal(g, g0)


def test_window_needs_a_causal_call_with_sq_at_most_sk():
    q = torch.randn(1, 2, 8, 16)
    k = torch.randn(1, 2, 4, 16)
    with pytest.raises(ValueError, match="window"):
        kfa.flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match="window"):
        kfa.flash_attention(q, k, k, window=2)
    with pytest.raises(ValueError, match="window"):
        kfa.flash_attention(q, q, q, window=-1)
    # Sq < Sk: every row keeps its own key
    out = kfa.flash_attention(k, q, q, window=2)
    assert out.shape == k.shape and torch.isfinite(out).all()


@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_torch_backend_band_equals_the_kernels(backend):
    """The cache-free local layer: the kernel's band (its plain version
    here) and SDPA's boolean band mask agree with the reference."""
    tcfg = configs.get_reduced(_ARCH).replace(dtype="float32")
    jcfg = jconfigs.get_reduced(_ARCH).replace(dtype="float32")
    jp = jattn.attn_init(jax.random.PRNGKey(4), jcfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in jax.tree.map(np.asarray, jp).items()}
    x = np.random.default_rng(3).standard_normal(
        (2, 40, tcfg.d_model)).astype(np.float32)
    want, _ = jattn.attention(jp, jnp.asarray(x), jcfg, kind="attn_local")
    got, _ = attention.attention(tp, torch.from_numpy(x), tcfg,
                                 kind="attn_local", backend=backend)
    _close(got, want, _VALUE_BAR["fp32"])


# -------------------------------------------------------- the model ---

@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("seq", [40, 1024])
def test_forward_past_the_window_matches_reference(seq, dtype, backend):
    """``transformer.forward`` at S > window (16): the five local layers'
    bands and the global layer's causal mask, against the reference's
    ``forward``; at S = 1024 the reference takes query chunks of 512."""
    tcfg, jcfg, jp, tp = _both_params(dtype, seed=1)
    toks = _tokens(tcfg.vocab, (2, seq), 5)
    want = _reference(("forward", seq, dtype),
                      lambda: jtr.forward(jp, jnp.asarray(toks), jcfg))
    with torch.no_grad():
        got = transformer.forward(tp, torch.from_numpy(toks), tcfg,
                                  backend=backend)
    assert got.dtype == _TDT[dtype]
    _close(got, want, _VALUE_BAR[dtype])


@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_token_loop_past_the_wrap_matches_reference(dtype, backend):
    """48 one-token steps into caches of 48 slots (the local layers' rings
    16): every step's logits and every cache, ring slots included, against
    the reference's ``decode_step`` loop; the steps past the wrap also
    against the cache-free ``forward`` of the same 48 tokens."""
    tcfg, jcfg, jp, tp = _both_params(dtype, seed=3)
    n = 48
    toks = _tokens(tcfg.vocab, (2, n), 6)
    tc = transformer.init_caches(tcfg, 2, n, device="cpu")
    assert tc[0]["k"].shape[2] == tcfg.window

    def loop():
        jc = jtr.init_caches(jcfg, 2, n)
        jstep = jax.jit(lambda p, t, c, pos: jtr.decode_step(p, t, c, pos,
                                                             jcfg))
        out = []
        for t in range(n):
            want, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                             jnp.int32(t))
            out.append((_np(want), [_np(j) for j in jax.tree.leaves(jc)]))
        return out

    logits = []
    with torch.no_grad():
        for t, (want, jleaves) in enumerate(_reference(("loop", dtype),
                                                       loop)):
            got, tc = transformer.decode_step(
                tp, torch.from_numpy(toks[:, t:t + 1]), tc, t, tcfg,
                backend=backend)
            _close(got, want, _VALUE_BAR[dtype])
            logits.append(got)
            for c, j in zip([c[k] for c in tc for k in ("k", "v")],
                            jleaves):
                _close(c, j, _VALUE_BAR[dtype])
        full = transformer.forward(tp, torch.from_numpy(toks), tcfg,
                                   backend=backend)
    for t in range(tcfg.window, n):
        _close(logits[t][:, 0], full[:, t], _VALUE_BAR[dtype])


def test_server_generate_matches_reference_serve_loop():
    """``Server.generate`` (fp32, kernels backend; the prompt through the
    token loop, as ``parallel_prefill_ok`` says for a windowed config)
    against a loop of the reference's jitted ``make_serve_step``, 30 tokens
    past a 7-token prompt, so the rings wrap: tokens equal."""
    tcfg, jcfg, jp, tp = _both_params("fp32", seed=11)
    toks = _tokens(tcfg.vocab, (3, 7), 12)
    gen, max_len = 30, 7 + 30 + 1
    step = jax.jit(jsteps.make_serve_step(jcfg))
    caches = jtr.init_caches(jcfg, 3, max_len)
    for t in range(7):
        tok, caches = step(jp, caches, {"token": jnp.asarray(toks[:, t:t + 1]),
                                        "cache_pos": jnp.int32(t)})
    want = [np.asarray(tok)]
    for t in range(7, 7 + gen - 1):
        tok, caches = step(jp, caches, {"token": tok,
                                        "cache_pos": jnp.int32(t)})
        want.append(np.asarray(tok))
    srv = serve.Server(tcfg, max_len=max_len, device="cpu", params=tp)
    assert not srv.parallel_prefill_ok()
    got = srv.generate(toks, gen)
    assert got.shape == (3, gen) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))


@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_ring_refuses_what_the_reference_would_clamp(backend):
    """A local layer's chunk of more than one token runs only at cache_pos
    0 and within the ring; the reference's ``dynamic_update_slice`` would
    clamp a chunk behind cached slots, or one longer than the ring."""
    cfg = configs.get_reduced(_ARCH)
    p = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    caches = transformer.init_caches(cfg, 1, 32, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with torch.no_grad():
        transformer.decode_step(p, toks, caches, 0, cfg, backend=backend)
        with pytest.raises(NotImplementedError, match="cache_pos 4"):
            transformer.decode_step(p, toks, caches, 4, cfg,
                                    backend=backend)
        with pytest.raises(ValueError, match="ring of 16 slots"):
            transformer.decode_step(
                p, torch.zeros((1, 17), dtype=torch.int32),
                transformer.init_caches(cfg, 1, 32, device="cpu"), 0, cfg,
                backend=backend)


def test_parallel_prefill_within_the_ring_matches_the_token_loop():
    """A chunk at cache_pos 0 that fits the ring (causal within itself)
    gives the token loop's logits and caches."""
    cfg = configs.get_reduced(_ARCH).replace(dtype="float32")
    p = transformer.init_params(torch.Generator().manual_seed(4), cfg,
                                device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab, (2, 12), 4))
    with torch.no_grad():
        par = transformer.init_caches(cfg, 2, 20, device="cpu")
        got, par = transformer.decode_step(p, toks, par, 0, cfg)
        seq = transformer.init_caches(cfg, 2, 20, device="cpu")
        for t in range(12):
            want, seq = transformer.decode_step(p, toks[:, t:t + 1], seq, t,
                                                cfg)
            _close(got[:, t], want[:, 0], _VALUE_BAR["fp32"])
    for a, b in zip(par, seq):
        for k in ("k", "v"):
            _close(a[k], b[k], _VALUE_BAR["fp32"])


def test_serve_and_prefill_launch_counts():
    """A Gemma forward (``make_prefill_step``) launches 7 x layers + 1
    matmuls and one attention a layer, the local layers' with the window
    (``chip_smoke.windowed_launches``); a decode step as many, none
    windowed (the ring holds only the band)."""
    cfg = configs.get_reduced(_ARCH)
    p = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    counts = {"matmul": 0, "flash_attention": 0, "windowed": 0}
    mm, fa = kmm.matmul_plain, kfa.attention_plain

    def count_mm(a, b):
        counts["matmul"] += 1
        return mm(a, b)

    def count_fa(q, k, v, *, causal=True, window=0):
        counts["flash_attention"] += 1
        counts["windowed"] += bool(window)
        return fa(q, k, v, causal=causal, window=window)

    toks = torch.zeros((2, 40), dtype=torch.int32)
    step = chip_smoke.lm_step_launches(cfg)
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(kmm, "matmul_plain", count_mm)
        mp.setattr(kfa, "attention_plain", count_fa)
        steps.make_prefill_step(cfg)(p, {"tokens": toks})
        assert counts == {"matmul": step["matmul"],
                          "flash_attention": step["flash_attention"],
                          "windowed": chip_smoke.windowed_launches(cfg)}
        assert counts["windowed"] == 5
        for k in counts:
            counts[k] = 0
        srv = serve.Server(cfg, max_len=24, device="cpu", params=p)
        tok, caches, pos = srv.prefill(np.zeros((2, 20), np.int32))
        srv.serve_step(srv.params, caches, {"token": tok, "cache_pos": pos})
        assert counts == {"matmul": 21 * step["matmul"],
                          "flash_attention": 21 * step["flash_attention"],
                          "windowed": 0}
    full = configs.get_config(_ARCH)
    assert chip_smoke.windowed_launches(full) == 40
    assert chip_smoke.lm_step_launches(full)["matmul"] == 48 * 7 + 1


# --------------------------------------------------------- training ---

def _batch(vocab, rows, seq, seed=0):
    toks = _tokens(vocab, (rows, seq + 1), seed)
    mask = np.ones((rows, seq), np.float32)
    mask[0, :3] = 0.0
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def _reference_loss(jcfg):
    def loss_fn(p, mb):
        hidden = jtr.forward(p, mb["tokens"], jcfg, return_hidden=True)
        return jlayers.chunked_softmax_ce(hidden, jtr.lm_head(p, jcfg),
                                          mb["labels"], mb["mask"])
    return loss_fn


@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("dtype,seq", [("fp32", 64), ("bf16", 64),
                                       ("fp32", 1024)])
def test_train_step_matches_reference(dtype, seq, backend):
    """``make_train_step``'s step-0 loss, gradient norm and updated
    parameters against the reference's jitted ``make_train_step`` (2
    microbatches), and every gradient of the port's ``make_value_and_grad``
    against ``jax.value_and_grad`` of the reference's loss.  At S = 1024
    the attention backward recomputes two query chunks a layer and the CE
    two chunks."""
    tcfg, jcfg, jp, tp = _both_params(dtype, seed=7)
    b = _batch(tcfg.vocab, 2, seq, seed=8)
    jb = jax.tree.map(jnp.asarray, b)
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}

    def reference():
        jloss, jgrads = jax.value_and_grad(_reference_loss(jcfg))(jp, jb)
        jstep = jax.jit(jsteps.make_train_step(
            jcfg, warmup=2, total_steps=10, microbatches=2))
        jp1, _, jm = jstep(jp, jadamw_init(jp), jb)
        return (float(jloss),
                transformer.flatten_params(jax.tree.map(np.asarray, jgrads)),
                {k: float(v) for k, v in jm.items()},
                transformer.flatten_params(jax.tree.map(np.asarray, jp1)))

    jloss, jflat, jm, jflat1 = _reference(("train", dtype, seq), reference)
    loss, grads = steps.make_value_and_grad(tcfg, backend=backend)(tp, tb)
    vbar, gbar = _VALUE_BAR[dtype], _GRAD_BAR[dtype]
    assert abs(float(loss) - jloss) <= vbar * abs(jloss)
    assert grads.keys() == jflat.keys()
    for k, g in grads.items():
        if dtype == "fp32":
            _close(g, jflat[k], gbar)
        else:
            assert _rel_l2(g, jflat[k]) <= gbar, k
    step = steps.make_train_step(tcfg, warmup=2, total_steps=10,
                                 microbatches=2, backend=backend)
    tp1, to1, m = step(tp, adamw_init(transformer.flatten_params(tp)), tb)
    assert int(to1.step) == 1
    for key in ("loss", "grad_norm"):
        bar = vbar if key == "loss" else gbar
        assert abs(float(m[key]) - jm[key]) <= bar * abs(jm[key]), key
    for k, t in transformer.flatten_params(tp1).items():
        if dtype == "fp32":
            _close(t, jflat1[k], gbar)
        else:
            assert _rel_l2(t, jflat1[k]) <= vbar, k
