"""The Mamba mixer (``repro_torch.models.mamba``) and the reduced Jamba in
the port against the JAX reference, on the CPU.

The same numpy inputs, drawn from a seed, and the same parameters (the
reference's ``mamba_init`` / ``init_params`` carried across leaf for leaf,
by ``transformer.load_jax_params`` for a whole model) go through
``repro.models.mamba`` and the port, at ``jamba-1.5-large-398b``'s reduced
configuration (d_model 64, d_inner 128, d_state 8, dt_rank 4; 8 layers,
attention at position 3 without RoPE, a MoE FFN every second layer).  The
reference's scan is plain ``jnp`` (an ``associative_scan``), so no Pallas
kernel is involved; on the CPU the port's ``backend="kernels"`` runs
kernel 3's plain version and ``backend="torch"`` runs ``torch.matmul``.
Each form is held: one scan, the chunked scan (``SCAN_CHUNK`` set small on
both modules with ``monkeypatch``), the rule that picks between them, and
the decode step with its cache over several steps.

``F.softplus`` returns its input above 20, where ``jax.nn.softplus`` adds
``log1p(exp(-x))`` < 2.1e-9: less than half an fp32 step of any x >= 20
(1.9e-6), so the two agree to the last bit there too.

Bars, the reference's (ROADMAP.md, "Oracle"): fp32 1e-5 x max(1, max|ref|),
bf16 2e-2 x max(1, max|ref|) on the mixer's output and state; logits 1e-4
x max|ref| in fp32 and 5% in bf16, every row, the bf16 model on the
reference's MoE routes (``moe.route(experts=)``).
"""

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
from repro.models import mamba as jmamba
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.kernels import matmul as kmm
from repro_torch.launch import serve
from repro_torch.models import mamba, moe, transformer
from test_torch_moe import (_close, _hold_logits, _np, _port_routes,
                            _reference_routes, _swapped, _tensors)

_ARCH = "jamba-1.5-large-398b"
_JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
_CFG_DTYPE = {"fp32": "float32", "bf16": "bfloat16"}
_BAR = {"fp32": 1e-5, "bf16": 2e-2}
_LOGIT_BAR = {"fp32": 1e-4, "bf16": 5e-2}
# (sequence length, SCAN_CHUNK, scan chunks): one scan; 4 chunks of 8; a
# length that is no multiple of the chunk (one scan); a length equal to it
# (one scan: the reference chunks only a longer sequence)
_FORMS = {"one_scan": (24, 512, 1), "chunked": (32, 8, 4),
          "not_a_multiple": (36, 8, 1), "one_chunk": (8, 8, 1)}

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
    monkeypatch.setattr(jmamba, "SCAN_CHUNK", chunk)
    monkeypatch.setattr(mamba, "SCAN_CHUNK", chunk)


def _cfgs(dtype):
    return (configs.get_reduced(_ARCH).replace(dtype=_CFG_DTYPE[dtype]),
            jconfigs.get_reduced(_ARCH).replace(dtype=_CFG_DTYPE[dtype]))


def _mixer(dtype, seed):
    """The reduced configs and one mixer's parameters: the reference's and
    the same as the port's tensors."""
    tcfg, jcfg = _cfgs(dtype)
    jp = jmamba.mamba_init(jax.random.PRNGKey(seed), jcfg, _JDT[dtype])
    return tcfg, jcfg, jp, _tensors(jp, _TDT[dtype])


def _x(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, _JDT[dtype]), torch.from_numpy(x).to(_TDT[dtype])


def _counting(monkeypatch):
    counts = {"matmul": 0}
    plain = kmm.matmul_plain

    def count(*a):
        counts["matmul"] += 1
        return plain(*a)

    monkeypatch.setattr(kmm, "matmul_plain", count)
    return counts


# ------------------------------------------------------------ the mixer ---

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mamba_init_has_the_reference_leaves(dtype):
    """Names, shapes and dtypes of ``mamba_init``'s leaves are the
    reference's (``dt_bias``, ``A_log`` and ``D`` fp32 in a bf16 model),
    and its constant leaves are the reference's values."""
    tcfg, jcfg = _cfgs(dtype)
    want = jmamba.mamba_init(jax.random.PRNGKey(0), jcfg, _JDT[dtype])
    got = mamba.mamba_init(torch.Generator().manual_seed(0), tcfg,
                           _TDT[dtype], "cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        f32 = w.dtype == jnp.float32
        assert got[k].dtype == (torch.float32 if f32 else _TDT[dtype]), k
    for k in ("conv_b", "dt_bias", "D"):
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]))
    np.testing.assert_allclose(_np(got["A_log"]), _np(want["A_log"]),
                               rtol=1e-7)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("form", list(_FORMS))
def test_mamba_block_matches_reference(form, backend, dtype, monkeypatch):
    """``mamba_block`` without a cache, each scan form against the
    reference's; kernel 3 launched 2 + 2 x chunks times (its plain version
    counted on the CPU, as ``chip_smoke.mixer_products`` reckons)."""
    s, chunk, chunks = _FORMS[form]
    _chunk(monkeypatch, chunk)
    tcfg, jcfg, jp, tp = _mixer(dtype, seed=1)
    jx, tx = _x((2, s, tcfg.d_model), 2, dtype)
    want, _ = jmamba.mamba_block(jp, jx, jcfg)
    counts = _counting(monkeypatch)
    with torch.no_grad():
        got, cache = mamba.mamba_block(tp, tx, tcfg, backend=backend)
    assert cache is None and got.dtype == _TDT[dtype]
    _close(got, want, _BAR[dtype])
    if backend == "kernels":
        assert counts["matmul"] == 2 + 2 * chunks == sum(
            chip_smoke.mixer_products(tcfg, "mamba", s).values())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_mamba_decode_matches_reference(backend, dtype):
    """Six decode steps from a zero cache: each output, and the conv window
    (model dtype) and SSM state (fp32) after each step, against the
    reference's; the cache is written in place."""
    tcfg, jcfg, jp, tp = _mixer(dtype, seed=3)
    jx, tx = _x((2, 6, tcfg.d_model), 4, dtype)
    jc = jmamba.init_mamba_cache(jcfg, 2, _JDT[dtype])
    tc = mamba.init_mamba_cache(tcfg, 2, _TDT[dtype], "cpu")
    assert tc["conv"].dtype == _TDT[dtype] and tc["ssm"].dtype == torch.float32
    for t in range(6):
        want, jc = jmamba.mamba_block(jp, jx[:, t:t + 1], jcfg, cache=jc)
        with torch.no_grad():
            got, out = mamba.mamba_block(tp, tx[:, t:t + 1], tcfg, cache=tc,
                                         backend=backend)
        assert out is tc
        _close(got, want, _BAR[dtype])
        for k in ("conv", "ssm"):
            _close(tc[k], jc[k], _BAR[dtype])


def test_mamba_decode_refuses_a_chunk():
    tcfg, _, _, tp = _mixer("fp32", seed=5)
    cache = mamba.init_mamba_cache(tcfg, 1, torch.float32, "cpu")
    with pytest.raises(ValueError, match="one token"):
        mamba.mamba_block(tp, torch.zeros(1, 2, tcfg.d_model), tcfg,
                          cache=cache)


def test_scan_is_the_recurrence():
    """The doubling scan against the loop ``h_t = a_t h_{t-1} + b_t`` in
    fp64, at lengths that are and are not powers of 2."""
    rng = np.random.default_rng(6)
    for s in (1, 7, 16, 33):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, s, 3, 4)))
        b = torch.from_numpy(rng.standard_normal((2, s, 3, 4)))
        h, want = torch.zeros_like(b[:, 0]), []
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(mamba._scan(a, b), torch.stack(want, 1),
                                   rtol=1e-12, atol=1e-12)


def test_mamba_chunked_equals_one_scan(monkeypatch):
    """The port's own forms agree, as ``tests/test_recurrent_forms.py``
    holds the reference's: 8 chunks of 16 against one scan over 128."""
    tcfg, _, _, tp = _mixer("fp32", seed=7)
    _, tx = _x((2, 128, tcfg.d_model), 8, "fp32")
    with torch.no_grad():
        _chunk(monkeypatch, 16)
        y_chunk, _ = mamba.mamba_block(tp, tx, tcfg)
        _chunk(monkeypatch, 1 << 30)
        y_full, _ = mamba.mamba_block(tp, tx, tcfg)
    _close(y_chunk, y_full, 1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mamba_decode_equals_parallel(dtype):
    """Ten decode steps against one cache-free call over the same tokens."""
    tcfg, _, _, tp = _mixer(dtype, seed=9)
    _, tx = _x((2, 10, tcfg.d_model), 10, dtype)
    cache = mamba.init_mamba_cache(tcfg, 2, _TDT[dtype], "cpu")
    with torch.no_grad():
        y_par, _ = mamba.mamba_block(tp, tx, tcfg)
        ys = [mamba.mamba_block(tp, tx[:, t:t + 1], tcfg, cache=cache)[0]
              for t in range(10)]
    _close(torch.cat(ys, dim=1), y_par, _BAR[dtype])


# ---------------------------------------------------- the reduced Jamba ---

def _both_params(dtype, seed=0):
    tcfg, jcfg = _cfgs(dtype)
    jp = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = transformer.load_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
    return tcfg, jcfg, jp, tp


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def test_load_jax_params_carries_jambas_tree():
    """The reduced Jamba's reference tree (Mamba mixers with fp32
    ``dt_bias``/``A_log``/``D``, an attention layer, dense and MoE FFNs)
    loads with no code of its own, leaf for leaf, bit for bit."""
    tcfg, _, jp, tp = _both_params("bf16", seed=12)
    want = transformer.flatten_params(jax.tree.map(np.asarray, jp))
    got = transformer.flatten_params(tp)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape
        if w.dtype == np.float32:
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))


def _jamba_run(form, monkeypatch, dtype, steps=4):
    """The reduced configs and parameters, (2, S) tokens, and the
    reference's forward and ``decode_step`` loop over them (one token a
    step), each as ``_reference_layers`` records it."""
    s = {"one_scan": 24, "chunked": 64}[form]
    _chunk(monkeypatch, 16)
    tcfg, jcfg, jp, tp = _both_params(dtype)
    toks = _tokens(tcfg.vocab, (2, s), 13)
    fwd = _reference_layers(lambda: jtr.forward(jp, jnp.asarray(toks), jcfg))
    jc, loop = jtr.init_caches(jcfg, 2, steps), []
    for t in range(steps):
        out = _reference_layers(lambda: jtr.decode_step(
            jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t), jcfg))
        jc = out[0][1]
        loop.append((out[0][0], *out[1:]))
    return tcfg, tp, toks, fwd, loop


def _reference_layers(fn):
    """``fn()`` of the reference, run op by op (``jax.disable_jit``), with
    each layer's input and output and each MoE layer's routes, in call
    order."""
    layers, orig = [], jtr.apply_layer

    def rec(p, x, cfg, *args, **kw):
        y, cache = orig(p, x, cfg, *args, **kw)
        layers.append((np.asarray(x), np.asarray(y)))
        return y, cache

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "apply_layer", rec)
        out, routes = _reference_routes(fn)
    return out, layers, routes


@pytest.mark.parametrize("form", ["one_scan", "chunked"])
def test_jamba_forward_and_token_loop_match_reference(form, monkeypatch):
    """The reduced Jamba end to end in fp32, NoPE attention, Mamba mixers
    and MoE FFNs together: ``forward`` over (2, S) and a ``decode_step``
    loop over the same tokens, one a step, on both backends against the
    reference's: every route and kept slot equal, every logit row at 1e-4
    x max|ref|."""
    tcfg, tp, toks, (want, _, j_fwd), loop = _jamba_run(form, monkeypatch,
                                                        "fp32")
    for backend in ("kernels", "torch"):
        got, t_fwd = _port_routes(lambda: transformer.forward(
            tp, torch.from_numpy(toks), tcfg, backend=backend))
        calls = [(got, want, t_fwd, j_fwd)]
        tc = transformer.init_caches(tcfg, 2, len(loop), device="cpu")
        for t, (w, _, j_seen) in enumerate(loop):
            (logits, tc), t_seen = _port_routes(
                lambda: transformer.decode_step(
                    tp, torch.from_numpy(toks[:, t:t + 1]), tc, t, tcfg,
                    backend=backend))
            calls.append((logits, w, t_seen, j_seen))
        for g, w, t_seen, j_seen in calls:
            swapped, d, _ = _swapped(t_seen, j_seen, g.shape[0] * g.shape[1])
            assert d == 0 and not swapped.any()
            assert _hold_logits(g, w, _LOGIT_BAR["fp32"], swapped) == 0


@pytest.mark.parametrize("form", ["one_scan", "chunked"])
def test_jamba_bf16_layers_match_reference(form, monkeypatch):
    """The reduced Jamba in bf16, layer by layer: each of its 8 layers
    (Mamba with a dense or a MoE FFN, NoPE attention with a MoE FFN) fed
    the reference's input to it, in the forward over (2, S) and at each
    step of the ``decode_step`` loop (its cache the port's own, written
    from the same inputs), its MoE FFN on the reference's experts
    (``route(experts=)``), on both backends: each layer's output at the
    bf16 bar, 2e-2 x max(1, max|ref|), its kept slots equal; the final norm
    and head on the reference's last hidden states at 5% of max|ref|.

    End to end the two frameworks' bf16 roundings (a few bf16 steps of the
    residual stream after one layer) grow layer by layer in this reduced
    model past the 5% bar (the test prints the logits' drift on the
    reference's routes), while in fp32 the two agree end to end at 1e-4
    (``test_jamba_forward_and_token_loop_match_reference``).  So the bf16
    model is held where no earlier layer's rounding compounds, and end to
    end against the fp32 run (``_hold_against_fp32``)."""
    tcfg, tp, toks, fwd, loop = _jamba_run(form, monkeypatch, "bf16")
    s = toks.shape[1]
    positions = torch.arange(s).expand(2, s)
    for backend in ("kernels", "torch"):
        runs = [(fwd, None, None, positions)]
        tc = transformer.init_caches(tcfg, 2, len(loop), device="cpu")
        runs += [(step, tc, t, None) for t, step in enumerate(loop)]
        for (want, layers, j_routes), caches, pos, positions_ in runs:
            it = iter(j_routes)
            for (pi, r, kind, fk, p), (x, y) in zip(
                    transformer.layer_params(tp, tcfg), layers):
                cache = (None if caches is None
                         else {k: c[r] for k, c in caches[pi].items()})
                got = _forced_routes(
                    lambda: transformer.apply_layer(
                        p, _tensor(x), tcfg, kind, fk, positions_,
                        cache=cache, cache_pos=pos, backend=backend)[0],
                    [next(it)] if fk == "moe" else [])
                _close(got, y, _BAR["bf16"])
            assert next(it, None) is None
            head = transformer.linear(
                transformer.rmsnorm(tp["final_norm"], _tensor(layers[-1][1]),
                                    tcfg.norm_eps),
                transformer.lm_head(tp, tcfg), backend)
            _close(head, want, _LOGIT_BAR["bf16"], floor=0.0)
    ends = {b: _np(_forced_routes(lambda: transformer.forward(
        tp, torch.from_numpy(toks), tcfg, backend=b), fwd[2]))
        for b in ("kernels", "torch")}
    _hold_against_fp32(form, toks, fwd, ends)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _hold_against_fp32(form, toks, fwd, ends):
    """The bf16 logits end to end on the reference's routes (``fwd`` the
    reference's eager run, ``ends`` the port's by backend), read against an
    fp32 forward of the same bf16 parameters on the same routes (the
    port's, which holds the reference's fp32 forward at 1e-4): each port
    backend no farther from it than the reference's own bf16 run is,
    within a quarter.  Printed beside it: port against reference, and two
    witnesses of how far bf16 roundings alone move the logits, the
    reference jitted (on its own routes) against eager and the port's two
    backends."""
    _, jcfg, jp, _ = _both_params("bf16")
    t32 = _cfgs("fp32")[0]
    p32 = transformer.load_jax_params(
        jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), jp),
        t32, device="cpu")
    fp32 = _np(_forced_routes(lambda: transformer.forward(
        p32, torch.from_numpy(toks), t32), fwd[2]))
    jit = _np(jax.jit(lambda p, t: jtr.forward(p, t, jcfg))(
        jp, jnp.asarray(toks)))
    want = _np(fwd[0])
    ref = _rel(want, fp32)
    print(f"{form}: bf16 logits end to end, of max|ref|: reference jitted vs "
          f"eager {_rel(jit, want):.2%}, port kernels vs torch "
          f"{_rel(ends['kernels'], ends['torch']):.2%}; from the fp32 run: "
          f"reference {ref:.2%}")
    for backend, got in ends.items():
        print(f"{form} {backend}: port vs reference {_rel(got, want):.2%}, "
              f"port from the fp32 run {_rel(got, fp32):.2%}")
        assert _rel(got, fp32) <= 1.25 * ref


def _tensor(a):
    """A reference array (bf16 ``ml_dtypes`` or fp32) as a tensor, bit for
    bit."""
    return torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16 if "bfloat16" in str(a.dtype) else torch.float32)


def _forced_routes(fn, j_seen):
    """``fn()`` of the port with each MoE layer, in call order, taking the
    reference's experts (``moe.route(experts=)``), its kept slots held
    equal to the reference's."""
    orig, it = moe.route, iter(j_seen)

    def rec(*args, **kw):
        idx, j_keep, _ = next(it)
        out = orig(*args, experts=torch.from_numpy(np.array(idx)).long(),
                   **kw)
        np.testing.assert_array_equal(out[3].numpy(), j_keep)
        return out

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(moe, "route", rec)
        out = fn()
    assert next(it, None) is None
    return out


def test_server_token_loop_matches_reference_decode_loop():
    """``Server.generate`` (fp32, kernels backend; the prompt through the
    token loop, as ``parallel_prefill_ok`` says for a recurrent config)
    against a loop of the reference's jitted ``make_serve_step``, one token
    a step: tokens equal."""
    tcfg, jcfg, jp, tp = _both_params("fp32", seed=14)
    toks = _tokens(tcfg.vocab, (2, 5), 15)
    gen, max_len = 6, 5 + 6
    step = jax.jit(jsteps.make_serve_step(jcfg))
    caches = jtr.init_caches(jcfg, 2, max_len)
    for t in range(5):
        tok, caches = step(jp, caches, {"token": jnp.asarray(toks[:, t:t + 1]),
                                        "cache_pos": jnp.int32(t)})
    want = [np.asarray(tok)]
    for t in range(5, 5 + gen - 1):
        tok, caches = step(jp, caches, {"token": tok,
                                        "cache_pos": jnp.int32(t)})
        want.append(np.asarray(tok))
    srv = serve.Server(tcfg, max_len=max_len, device="cpu", params=tp)
    assert not srv.parallel_prefill_ok()
    got = srv.generate(toks, gen)
    assert got.shape == (2, gen) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))


def test_jamba_caches_are_the_references():
    """``init_caches``: each pattern position's stacked cache as the
    reference's, name, shape, dtype and value (the attention layer's KV
    cache in the model dtype, the Mamba layers' bf16 conv window and fp32
    state)."""
    tcfg, jcfg = _cfgs("bf16")
    want = jtr.init_caches(jcfg, 3, 10)
    got = transformer.init_caches(tcfg, 3, 10, device="cpu")
    assert len(got) == len(want) == len(tcfg.block_pattern)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert tuple(g[k].shape) == w[k].shape
            assert str(g[k].dtype).removeprefix("torch.") == str(w[k].dtype)
            np.testing.assert_array_equal(_np(g[k]), _np(w[k]))


def test_serve_step_launch_counts():
    """A decode step launches ``chip_smoke``'s oracle: each Mamba layer 4
    products, the attention layer 4 and 1 attention, each FFN its own (a
    MoE FFN's batched launches apart), and the head (their plain versions
    counted on the CPU); a forward over 64 tokens with chunks of 16 adds 2
    a chunk past the first for each Mamba layer."""
    cfg = configs.get_reduced(_ARCH)
    srv = serve.Server(cfg, max_len=8, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    step = chip_smoke.lm_step_launches(cfg)
    two_d = step["matmul"] - chip_smoke.batched_launches(cfg)
    with pytest.MonkeyPatch.context() as mp:
        counts = _counting(mp)
        tok, caches, pos = srv.prefill(np.zeros((2, 3), np.int32))
        assert counts["matmul"] == 3 * two_d
        srv.serve_step(srv.params, caches, {"token": tok, "cache_pos": pos})
        assert counts["matmul"] == 4 * two_d
        _chunk(mp, 16)
        counts["matmul"] = 0
        with torch.no_grad():
            transformer.forward(srv.params,
                                torch.zeros((1, 64), dtype=torch.int32), cfg)
        fwd = chip_smoke.lm_step_launches(cfg, 64)["matmul"]
        assert fwd == step["matmul"] + 7 * 6
        assert counts["matmul"] == fwd - chip_smoke.batched_launches(cfg)
    assert step["flash_attention"] == 1
    full = configs.get_config(_ARCH)
    assert chip_smoke.mixer_products(full, "mamba", 4096) == {"wgmma": 10,
                                                              "simt": 8}
    assert chip_smoke.mixer_products(full, "mamba") == {"wgmma": 3,
                                                        "simt": 1}
