"""The xLSTM mixers (``repro_torch.models.xlstm``) and the reduced xLSTM in
the port against the JAX reference, on the CPU.

The same numpy inputs, drawn from a seed, and the same parameters (the
reference's ``mlstm_init`` / ``slstm_init`` / ``init_params`` carried across
leaf for leaf, by ``transformer.load_jax_params`` for a whole model) go
through ``repro.models.xlstm`` and the port, at ``xlstm-1.3b``'s reduced
configuration (d_model 64, 2 heads, mLSTM d_inner 128 and head width 64,
sLSTM FFN 85 wide; 4 layers alternating mLSTM and sLSTM).  The reference's
mixers are plain ``jnp``, so no Pallas kernel is involved; on the CPU the
port's ``backend="kernels"`` runs kernel 3's plain version and
``backend="torch"`` runs ``torch.matmul``.  Each form is held: the mLSTM's
parallel and chunkwise forms (``M_CHUNK`` set small on both modules with
``monkeypatch``) and the rule that picks between them, the sLSTM loop, and
each decode step with its cache over several steps.

Bars, the reference's (ROADMAP.md, "Oracle"): fp32 1e-5 x max(1, max|ref|),
bf16 2e-2 x max(1, max|ref|) on a mixer's output and state; logits 1e-4 x
max|ref| in fp32 and 5% in bf16.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.models import xlstm as jxlstm
from repro_torch import configs
from repro_torch.kernels import matmul as kmm
from repro_torch.launch import serve
from repro_torch.models import transformer, xlstm
from test_torch_mamba import _reference_layers, _tensor
from test_torch_moe import _close, _np, _tensors

_ARCH = "xlstm-1.3b"
_JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
_CFG_DTYPE = {"fp32": "float32", "bf16": "bfloat16"}
_BAR = {"fp32": 1e-5, "bf16": 2e-2}
_LOGIT_BAR = {"fp32": 1e-4, "bf16": 5e-2}
# (sequence length, M_CHUNK, form the reference takes): the parallel form;
# 4 chunks of 8; a length that is no multiple of the chunk (parallel); a
# length equal to it (parallel: only a longer sequence is chunked)
_FORMS = {"parallel": (24, 512), "chunkwise": (32, 8),
          "not_a_multiple": (36, 8), "one_chunk": (8, 8)}

# chip_smoke.py's launch oracle (``mixer_products``, ``lm_step_launches``)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True)
def _no_sharding_hook(monkeypatch):
    """The reference's model functions without a mesh: another test file in
    this process may have left the sharding hook of its ``Server``."""
    monkeypatch.setattr(jlayers, "_CONSTRAINT_FN", None)


def _chunk(monkeypatch, chunk):
    monkeypatch.setattr(jxlstm, "M_CHUNK", chunk)
    monkeypatch.setattr(xlstm, "M_CHUNK", chunk)


def _cfgs(dtype):
    return (configs.get_reduced(_ARCH).replace(dtype=_CFG_DTYPE[dtype]),
            jconfigs.get_reduced(_ARCH).replace(dtype=_CFG_DTYPE[dtype]))


def _mixer(kind, dtype, seed):
    """The reduced configs and one mixer's parameters: the reference's and
    the same as the port's tensors (``w_if`` stays fp32)."""
    tcfg, jcfg = _cfgs(dtype)
    init = {"mlstm": jxlstm.mlstm_init, "slstm": jxlstm.slstm_init}[kind]
    jp = init(jax.random.PRNGKey(seed), jcfg, _JDT[dtype])
    return tcfg, jcfg, jp, _tensors(jp, _TDT[dtype])


def _x(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, _JDT[dtype]), torch.from_numpy(x).to(_TDT[dtype])


def _block(kind):
    return ({"mlstm": jxlstm.mlstm_block, "slstm": jxlstm.slstm_block}[kind],
            {"mlstm": xlstm.mlstm_block, "slstm": xlstm.slstm_block}[kind])


def _init_cache(kind, cfg, batch, module, **kw):
    return getattr(module, f"init_{kind}_cache")(cfg, batch, **kw)


# ----------------------------------------------------------- the mixers ---

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_has_the_reference_leaves(kind, dtype):
    """Names, shapes and dtypes of each mixer's leaves are the
    reference's (``w_if`` fp32 in a bf16 model; the sLSTM FFN
    ``int(1.3334 d)`` wide), and so are its caches' and their values."""
    tcfg, jcfg = _cfgs(dtype)
    init = {"mlstm": xlstm.mlstm_init, "slstm": xlstm.slstm_init}[kind]
    want = _mixer(kind, dtype, 0)[2]
    got = init(torch.Generator().manual_seed(0), tcfg, _TDT[dtype], "cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        f32 = w.dtype == jnp.float32
        assert got[k].dtype == (torch.float32 if f32 else _TDT[dtype]), k
    if "conv_b" in want:
        np.testing.assert_array_equal(_np(got["conv_b"]), _np(want["conv_b"]))
    j_cache = _init_cache(kind, jcfg, 3, jxlstm)
    t_cache = _init_cache(kind, tcfg, 3, xlstm, device="cpu")
    assert set(t_cache) == set(j_cache)
    for k, w in j_cache.items():
        assert t_cache[k].dtype == torch.float32
        np.testing.assert_array_equal(_np(t_cache[k]), _np(w))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("form", list(_FORMS))
def test_mlstm_block_matches_reference(form, backend, dtype, monkeypatch):
    """``mlstm_block`` without a cache, in each form, against the
    reference's; 6 products (kernel 3's plain version counted)."""
    s, chunk = _FORMS[form]
    _chunk(monkeypatch, chunk)
    tcfg, jcfg, jp, tp = _mixer("mlstm", dtype, seed=1)
    jx, tx = _x((2, s, tcfg.d_model), 2, dtype)
    want, _ = jxlstm.mlstm_block(jp, jx, jcfg)
    calls = []
    monkeypatch.setattr(kmm, "matmul_plain",
                        lambda a, b, plain=kmm.matmul_plain: calls.append(
                            (a.dtype, b.dtype)) or plain(a, b))
    with torch.no_grad():
        got, cache = xlstm.mlstm_block(tp, tx, tcfg, backend=backend)
    assert cache is None and got.dtype == _TDT[dtype]
    _close(got, want, _BAR[dtype])
    if backend == "kernels":
        assert len(calls) == sum(
            chip_smoke.mixer_products(tcfg, "mlstm", s).values()) == 6
        # the gates' product is fp32 on both sides, the rest in the model's
        assert calls[4] == (torch.float32, torch.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_matches_reference(kind, backend, dtype):
    """Six decode steps from the initial cache: each output and the whole
    fp32 state after each step against the reference's; the cache is
    written in place.  An mLSTM step's q, k and v products are fp32 (the
    reference's ``w.astype(f32)``)."""
    tcfg, jcfg, jp, tp = _mixer(kind, dtype, seed=3)
    j_block, t_block = _block(kind)
    jx, tx = _x((2, 6, tcfg.d_model), 4, dtype)
    jc = _init_cache(kind, jcfg, 2, jxlstm)
    tc = _init_cache(kind, tcfg, 2, xlstm, device="cpu")
    for t in range(6):
        want, jc = j_block(jp, jx[:, t:t + 1], jcfg, cache=jc)
        with torch.no_grad():
            got, out = t_block(tp, tx[:, t:t + 1], tcfg, cache=tc,
                               backend=backend)
        assert out is tc and got.dtype == _TDT[dtype]
        _close(got, want, _BAR[dtype])
        for k in jc:
            _close(tc[k], jc[k], _BAR[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_slstm_block_matches_reference(backend, dtype):
    """``slstm_block`` without a cache, the recurrence over 12 steps and
    the FFN; 3 + S products (the recurrent one once a step)."""
    tcfg, jcfg, jp, tp = _mixer("slstm", dtype, seed=5)
    jx, tx = _x((2, 12, tcfg.d_model), 6, dtype)
    want, _ = jxlstm.slstm_block(jp, jx, jcfg)
    calls = []
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(kmm, "matmul_plain",
                   lambda a, b, plain=kmm.matmul_plain: calls.append(
                       b.dtype) or plain(a, b))
        got, cache = xlstm.slstm_block(tp, tx, tcfg, backend=backend)
    assert cache is None and got.dtype == _TDT[dtype]
    _close(got, want, _BAR[dtype])
    if backend == "kernels":
        assert len(calls) == 3 + 12 == sum(
            chip_smoke.mixer_products(tcfg, "slstm", 12).values())
        assert calls[1:13] == [torch.float32] * 12


def test_slstm_ffn_gelu_is_the_references_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh form; ``F.gelu(approximate=
    "tanh")`` is it, where the default erf form is not."""
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_refuses_a_chunk(kind):
    tcfg, _, _, tp = _mixer(kind, "fp32", seed=7)
    cache = _init_cache(kind, tcfg, 1, xlstm, device="cpu")
    with pytest.raises(ValueError, match="one token"):
        _block(kind)[1](tp, torch.zeros(1, 2, tcfg.d_model), tcfg,
                        cache=cache)


def test_mlstm_chunkwise_equals_parallel(monkeypatch):
    """The port's own forms agree, as ``tests/test_recurrent_forms.py``
    holds the reference's: 8 chunks of 16 against the parallel form."""
    tcfg, _, _, tp = _mixer("mlstm", "fp32", seed=8)
    _, tx = _x((2, 128, tcfg.d_model), 9, "fp32")
    with torch.no_grad():
        _chunk(monkeypatch, 16)
        y_chunk, _ = xlstm.mlstm_block(tp, tx, tcfg)
        _chunk(monkeypatch, 1 << 30)
        y_par, _ = xlstm.mlstm_block(tp, tx, tcfg)
    _close(y_chunk, y_par, 1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_equals_parallel(kind, dtype):
    """Ten decode steps against one cache-free call over the same
    tokens."""
    tcfg, _, _, tp = _mixer(kind, dtype, seed=10)
    block = _block(kind)[1]
    _, tx = _x((2, 10, tcfg.d_model), 11, dtype)
    cache = _init_cache(kind, tcfg, 2, xlstm, device="cpu")
    with torch.no_grad():
        y_par, _ = block(tp, tx, tcfg)
        ys = [block(tp, tx[:, t:t + 1], tcfg, cache=cache)[0]
              for t in range(10)]
    _close(torch.cat(ys, dim=1), y_par, _BAR[dtype])


# ---------------------------------------------------- the reduced xLSTM ---

def _both_params(dtype, seed=0):
    tcfg, jcfg = _cfgs(dtype)
    jp = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = transformer.load_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
    return tcfg, jcfg, jp, tp


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def test_load_jax_params_carries_xlstms_tree():
    """The reduced xLSTM's reference tree (mLSTM mixers with an fp32
    ``w_if``, sLSTM mixers, no FFN) loads with no code of its own, leaf for
    leaf, bit for bit."""
    tcfg, _, jp, tp = _both_params("bf16", seed=12)
    want = transformer.flatten_params(jax.tree.map(np.asarray, jp))
    got = transformer.flatten_params(tp)
    assert set(got) == set(want)
    assert not any(".ffn." in k for k in got)
    for k, w in want.items():
        np.testing.assert_array_equal(_np(got[k]), np.asarray(w, np.float32))
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype)


def _xlstm_run(form, monkeypatch, dtype, steps=4):
    """The reduced configs and parameters, (2, S) tokens, and the
    reference's forward and ``decode_step`` loop over them (one token a
    step), each as ``_reference_layers`` records it."""
    s = {"parallel": 24, "chunkwise": 32}[form]
    _chunk(monkeypatch, 8)
    tcfg, jcfg, jp, tp = _both_params(dtype)
    toks = _tokens(tcfg.vocab, (2, s), 13)
    fwd = _reference_layers(lambda: jtr.forward(jp, jnp.asarray(toks), jcfg))
    jc, loop = jtr.init_caches(jcfg, 2, steps), []
    for t in range(steps):
        out = _reference_layers(lambda: jtr.decode_step(
            jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t), jcfg))
        jc = out[0][1]
        loop.append((out[0][0], out[1]))
    return tcfg, tp, toks, fwd[:2], loop


@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("form", ["parallel", "chunkwise"])
def test_xlstm_forward_and_token_loop_match_reference(form, backend,
                                                      monkeypatch):
    """The reduced xLSTM end to end in fp32: ``forward`` over (2, S) and a
    ``decode_step`` loop over the same tokens, one a step, against the
    reference's, every logit at 1e-4 x max|ref|; the loop's last logits
    are the forward's at that position."""
    tcfg, tp, toks, (want, _), loop = _xlstm_run(form, monkeypatch, "fp32")
    with torch.no_grad():
        got = transformer.forward(tp, torch.from_numpy(toks), tcfg,
                                  backend=backend)
        _close(got, want, _LOGIT_BAR["fp32"], floor=0.0)
        tc = transformer.init_caches(tcfg, 2, len(loop), device="cpu")
        for t, (w, _) in enumerate(loop):
            logits, tc = transformer.decode_step(
                tp, torch.from_numpy(toks[:, t:t + 1]), tc, t, tcfg,
                backend=backend)
            _close(logits, w, _LOGIT_BAR["fp32"], floor=0.0)
    _close(logits[:, 0], got[:, len(loop) - 1], _LOGIT_BAR["fp32"],
           floor=0.0)


@pytest.mark.parametrize("form", ["parallel", "chunkwise"])
def test_xlstm_bf16_layers_match_reference(form, monkeypatch):
    """The reduced xLSTM in bf16, layer by layer (as
    ``tests/test_torch_mamba.py`` holds the reduced Jamba): each mLSTM and
    sLSTM layer fed the reference's input to it, in the forward and at each
    step of the ``decode_step`` loop (its cache the port's own), on both
    backends, at the bf16 bar 2e-2 x max(1, max|ref|); the final norm and
    head on the reference's last hidden states at 5% of max|ref|.  End to
    end the two frameworks' bf16 roundings compound over the layers and
    the tokens past the 5% bar (the test prints the logits' drift), while
    in fp32 they agree at 1e-4
    (``test_xlstm_forward_and_token_loop_match_reference``); so end to end
    each backend is held against the fp32 run (``_hold_against_fp32``)."""
    tcfg, tp, toks, fwd, loop = _xlstm_run(form, monkeypatch, "bf16")
    s = toks.shape[1]
    for backend in ("kernels", "torch"):
        tc = transformer.init_caches(tcfg, 2, len(loop), device="cpu")
        runs = [(fwd, None, None)] + [(step, tc, t)
                                      for t, step in enumerate(loop)]
        for (want, layers), caches, pos in runs:
            for (pi, r, kind, fk, p), (x, y) in zip(
                    transformer.layer_params(tp, tcfg), layers):
                cache = (None if caches is None
                         else {k: c[r] for k, c in caches[pi].items()})
                with torch.no_grad():
                    got, _ = transformer.apply_layer(
                        p, _tensor(x), tcfg, kind, fk,
                        torch.arange(s).expand(2, s), cache=cache,
                        cache_pos=pos, backend=backend)
                _close(got, y, _BAR["bf16"])
            head = transformer.linear(
                transformer.rmsnorm(tp["final_norm"], _tensor(layers[-1][1]),
                                    tcfg.norm_eps),
                transformer.lm_head(tp, tcfg), backend)
            _close(head, want, _LOGIT_BAR["bf16"], floor=0.0)
    with torch.no_grad():
        ends = {b: _np(transformer.forward(tp, torch.from_numpy(toks), tcfg,
                                           backend=b))
                for b in ("kernels", "torch")}
    _hold_against_fp32(form, toks, _np(fwd[0]), ends)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _hold_against_fp32(form, toks, want, ends):
    """The bf16 logits end to end (``want`` the reference's eager run,
    ``ends`` the port's by backend), read against the fp32 forward of the
    same bf16 parameters (the reference's, jitted): each port backend no
    farther from it than the reference's own bf16 run is, within a
    quarter.  Printed beside it: port against reference, and two witnesses
    of how far bf16 roundings alone move the logits, the reference jitted
    against eager (they share their products' roundings) and the port's
    two backends."""
    _, jcfg, jp, _ = _both_params("bf16")
    j32 = _cfgs("fp32")[1]
    fp32 = _np(jax.jit(lambda p, t: jtr.forward(p, t, j32))(
        jax.tree.map(lambda a: a.astype(jnp.float32), jp), jnp.asarray(toks)))
    jit = _np(jax.jit(lambda p, t: jtr.forward(p, t, jcfg))(
        jp, jnp.asarray(toks)))
    ref = _rel(want, fp32)
    print(f"{form}: bf16 logits end to end, of max|ref|: reference jitted vs "
          f"eager {_rel(jit, want):.2%}, port kernels vs torch "
          f"{_rel(ends['kernels'], ends['torch']):.2%}; from the fp32 run: "
          f"reference {ref:.2%}")
    for backend, got in ends.items():
        print(f"{form} {backend}: port vs reference {_rel(got, want):.2%}, "
              f"port from the fp32 run {_rel(got, fp32):.2%}")
        assert _rel(got, fp32) <= 1.25 * ref


def test_server_token_loop_matches_reference_decode_loop():
    """``Server.generate`` (fp32, kernels backend; the prompt through the
    token loop, as ``parallel_prefill_ok`` says for a recurrent config)
    against a loop of the reference's jitted ``make_serve_step``, one token
    a step: tokens equal."""
    tcfg, jcfg, jp, tp = _both_params("fp32", seed=14)
    toks = _tokens(tcfg.vocab, (3, 6), 15)
    gen, max_len = 8, 6 + 8
    step = jax.jit(jsteps.make_serve_step(jcfg))
    caches = jtr.init_caches(jcfg, 3, max_len)
    for t in range(6):
        tok, caches = step(jp, caches, {"token": jnp.asarray(toks[:, t:t + 1]),
                                        "cache_pos": jnp.int32(t)})
    want = [np.asarray(tok)]
    for t in range(6, 6 + gen - 1):
        tok, caches = step(jp, caches, {"token": tok,
                                        "cache_pos": jnp.int32(t)})
        want.append(np.asarray(tok))
    srv = serve.Server(tcfg, max_len=max_len, device="cpu", params=tp)
    assert not srv.parallel_prefill_ok()
    got = srv.generate(toks, gen)
    assert got.shape == (3, gen) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))


def test_serve_step_launch_counts():
    """A serve step launches ``chip_smoke``'s oracle: each mLSTM layer 6
    products, each sLSTM layer 4 (3 + its one recurrent step), and the
    head; a forward over S tokens 3 + S a sLSTM layer (their plain versions
    counted on the CPU).  At xLSTM-1.3B's full widths: 241 a decode step,
    24,793 a 1 x 1024 forward, 168 and 24,648 of them on ``"simt"``."""
    cfg = configs.get_reduced(_ARCH)
    srv = serve.Server(cfg, max_len=8, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    counts = {"matmul": 0}

    def count(a, b, plain=kmm.matmul_plain):
        counts["matmul"] += 1
        return plain(a, b)

    step = chip_smoke.lm_step_launches(cfg)["matmul"]
    assert step == 2 * 6 + 2 * 4 + 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kmm, "matmul_plain", count)
        tok, caches, pos = srv.prefill(np.zeros((2, 3), np.int32))
        assert counts["matmul"] == 3 * step
        srv.serve_step(srv.params, caches, {"token": tok, "cache_pos": pos})
        assert counts["matmul"] == 4 * step
        counts["matmul"] = 0
        with torch.no_grad():
            transformer.forward(srv.params,
                                torch.zeros((1, 9), dtype=torch.int32), cfg)
        assert counts["matmul"] == chip_smoke.lm_step_launches(
            cfg, 9)["matmul"] == step + 2 * 8
    full = configs.get_config(_ARCH)
    assert chip_smoke.lm_step_launches(full)["matmul"] == 241
    assert chip_smoke.lm_step_launches(full, 1024)["matmul"] == 24793
    assert chip_smoke.recurrent_simt(full) == 168
    assert chip_smoke.recurrent_simt(full, 1024) == 24648


def test_full_config_widths():
    """xLSTM-1.3B's parameter tree on the meta device: 3,093,137,408
    parameters by the reference's init (``ModelConfig.param_counts``, which
    the port keeps as the reference's, reckons 1.78 B: it assumes
    block-diagonal q, k and v), an mLSTM head width of 4096 / 4 = 1024 (not
    ``cfg.head_dim`` 512), and an sLSTM FFN of 2730."""
    cfg = configs.get_config(_ARCH)
    flat = transformer.flatten_params(transformer.init_params(None, cfg,
                                                              device="meta"))
    assert sum(t.numel() for t in flat.values()) == 3_093_137_408
    assert cfg.param_counts()["total"] == 1_783_431_168
    assert xlstm._dims(cfg)[1:] == (4096, 1024) and cfg.head_dim == 512
    assert tuple(flat["blocks.1.mixer.ff_up"].shape) == (24, 2048, 2730)
    assert flat["blocks.0.mixer.w_if"].dtype == torch.float32
