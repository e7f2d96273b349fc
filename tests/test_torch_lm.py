"""The port's LM serving path against the JAX reference, on the CPU.

The same numpy inputs, drawn from a seed, and the same parameters (the
reference's ``init_params`` carried across by
``repro_torch.models.transformer.load_jax_params``) go through the
reference's model functions and the port's.  The reference is called
directly, never through its ``Server``, which builds a mesh and shards;
its jitted ``make_serve_step`` runs without a mesh.  On the CPU the
port's ``backend="kernels"`` runs the matmul and flash-attention kernels'
plain versions; ``backend="torch"`` runs ``torch.matmul`` and
``F.scaled_dot_product_attention``.

Bars: building blocks and attention at 1e-5 x max(1, max|ref|) in fp32
and 2e-2 x max(1, max|ref|) in bf16; logits at 1e-4 x max|ref| in fp32 and
5% of max|ref| in bf16 (DESIGN.md §12's bf16 output bar).
"""

import dataclasses

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
from repro_torch import configs
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.launch import serve, steps
from repro_torch.models import attention, layers, transformer

_JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
_BAR = {"fp32": 1e-5, "bf16": 2e-2}
_LOGIT_BAR = {"fp32": 1e-4, "bf16": 5e-2}
_CFG_DTYPE = {"fp32": "float32", "bf16": "bfloat16"}
_SERVED = ("stablelm-1.6b", "qwen3-32b", "deepseek-coder-33b",
           "chameleon-34b")
# served by the recurrent mixers (tests/test_torch_{mamba,xlstm}.py)
_RECURRENT = ("jamba-1.5-large-398b", "xlstm-1.3b")
# served and trained by repro_torch.models.encdec (tests/test_torch_encdec.py)
_ENCDEC = ("whisper-small",)


@pytest.fixture(autouse=True)
def _no_sharding_hook(monkeypatch):
    """The reference's model functions without a mesh: another test file in
    this process may have left the sharding hook of its ``Server``."""
    monkeypatch.setattr(jlayers, "_CONSTRAINT_FN", None)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, rtol, floor=1.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(floor, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, rtol * scale)
    return err


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg(arch, dtype, **kw):
    return (configs.get_reduced(arch).replace(dtype=_CFG_DTYPE[dtype], **kw),
            jconfigs.get_reduced(arch).replace(dtype=_CFG_DTYPE[dtype], **kw))


# ------------------------------------------------------------- configs ---

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
@pytest.mark.parametrize("which", ["get_config", "get_reduced"])
def test_config_fields_equal_reference(arch, which):
    got = getattr(configs, which)(arch)
    want = getattr(jconfigs, which)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.repeat == want.repeat
    assert got.param_counts() == want.param_counts()


def test_registry_ids_equal_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


def test_stablelm_parameter_count():
    """The published model's tensors: ``param_counts`` (which leaves out
    the RMSNorm gains) plus 2 gains a layer and the final one."""
    cfg = configs.get_config("stablelm-1.6b")
    flat = transformer.flatten_params(transformer.init_params(None, cfg,
                                                        device="meta"))
    norms = sum(t.numel() for k, t in flat.items() if "norm" in k)
    assert norms == (2 * cfg.num_layers + 1) * cfg.d_model
    counted = sum(t.numel() for t in flat.values())
    assert counted - norms == cfg.param_counts()["total"] == 1_644_167_168


# ------------------------------------------------------ building blocks ---

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rmsnorm_and_layernorm_match_reference(dtype):
    x, g, b = _arrays(0, (2, 5, 48), (48,), (48,))
    jx, jg, jb = (jnp.asarray(a, _JDT[dtype]) for a in (x * 3, g, b))
    tx, tg, tb = (torch.from_numpy(a).to(_TDT[dtype]) for a in (x * 3, g, b))
    _close(layers.rmsnorm(tg, tx, 1e-6), jlayers.rmsnorm(jg, jx, 1e-6),
           _BAR[dtype])
    _close(layers.layernorm({"g": tg, "b": tb}, tx),
           jlayers.layernorm({"g": jg, "b": jb}, jx), _BAR[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(dtype, theta):
    (x,) = _arrays(1, (2, 7, 3, 16))
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [9, 10, 11, 12, 13, 14, 15]])
    got = layers.rope(torch.from_numpy(x).to(_TDT[dtype]),
                      torch.from_numpy(pos), theta)
    want = jlayers.rope(jnp.asarray(x, _JDT[dtype]), jnp.asarray(pos), theta)
    assert got.dtype == _TDT[dtype]
    _close(got, want, _BAR[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_mlp_matches_reference(dtype, backend):
    p = _tree_np(jlayers.mlp_init(jax.random.PRNGKey(2), 32, 80,
                                  _JDT[dtype]))
    (x,) = _arrays(3, (2, 5, 32))
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: torch.tensor(np.asarray(v, np.float32)).to(_TDT[dtype])
          for k, v in p.items()}
    got = layers.mlp(tp, torch.from_numpy(x).to(_TDT[dtype]), backend)
    want = jlayers.mlp(jp, jnp.asarray(x, _JDT[dtype]))
    _close(got, want, _BAR[dtype])


def test_rmsnorm_rows_do_not_depend_on_the_row_count():
    """A row's RMSNorm is the same in a many-row call and alone (on the
    card too: ``tests/test_torch_cuda.py``)."""
    (x,) = _arrays(9, (4, 64, 256))
    x = torch.from_numpy(x * 3).bfloat16()
    g = torch.ones(256, dtype=torch.bfloat16)
    full = layers.rmsnorm(g, x)
    for t in (0, 17, 63):
        assert torch.equal(layers.rmsnorm(g, x[:, t:t + 1].contiguous()),
                           full[:, t:t + 1])


def test_layernorm_rows_do_not_depend_on_the_row_count():
    """A row's LayerNorm is the same in a many-row call and alone
    (``F.layer_norm``; on the card too: ``tests/test_torch_cuda.py``)."""
    (x, g, b) = _arrays(13, (4, 64, 256), (256,), (256,))
    x = torch.from_numpy(x * 3 + 1).bfloat16()
    p = {"g": torch.from_numpy(g).bfloat16(),
         "b": torch.from_numpy(b).bfloat16()}
    full = layers.layernorm(p, x)
    for t in (0, 17, 63):
        assert torch.equal(layers.layernorm(p, x[:, t:t + 1].contiguous()),
                           full[:, t:t + 1])


def test_linear_flattens_and_checks_backend():
    a, w = torch.randn(2, 3, 8), torch.randn(8, 5)
    assert torch.allclose(layers.linear(a, w), a @ w, atol=1e-6)
    with pytest.raises(ValueError, match="unknown backend"):
        layers.linear(a, w, "xla")


# ------------------------------------------------------------ attention ---

_ATTN_CASES = {
    # (arch, kv cache length, [(chunk length, cache_pos), ...], causal)
    "causal": ("stablelm-1.6b", None, [(9, None)], True),
    "non_causal": ("stablelm-1.6b", None, [(9, None)], False),
    "prefill_at_0": ("stablelm-1.6b", 16, [(9, 0)], True),
    "decode_after_prefill": ("stablelm-1.6b", 16, [(9, 0), (1, 9), (1, 10)],
                             True),
    "decode_from_empty": ("stablelm-1.6b", 8, [(1, 0), (1, 1), (1, 2)],
                          True),
    "gqa_qk_norm_prefill_decode": ("qwen3-32b", 16, [(9, 0), (1, 9)], True),
    "gqa_causal": ("deepseek-coder-33b", None, [(9, None)], True),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("case", list(_ATTN_CASES))
def test_attention_matches_reference(case, backend, dtype):
    arch, cache_len, chunks, causal = _ATTN_CASES[case]
    tcfg, jcfg = _cfg(arch, dtype)
    jp = jattn.attn_init(jax.random.PRNGKey(4), jcfg, _JDT[dtype])
    tp = {k: torch.tensor(np.asarray(v, np.float32)).to(_TDT[dtype])
          for k, v in _tree_np(jp).items()}
    if cache_len:
        jcache = jattn.init_kv_cache(jcfg, 2, cache_len, "attn", _JDT[dtype])
        tcache = attention.init_kv_cache(tcfg, 2, cache_len, "attn",
                                         _TDT[dtype])
    for i, (s, pos) in enumerate(chunks):
        (x,) = _arrays(10 + i, (2, s, tcfg.d_model))
        kw = {} if pos is None else {"cache_pos": pos}
        want, jnew = jattn.attention(
            jp, jnp.asarray(x, _JDT[dtype]), jcfg, causal=causal,
            kv_cache=jcache if cache_len else None,
            **{k: jnp.int32(v) for k, v in kw.items()})
        got, tnew = attention.attention(
            tp, torch.from_numpy(x).to(_TDT[dtype]), tcfg, causal=causal,
            kv_cache=tcache if cache_len else None, backend=backend, **kw)
        assert got.dtype == _TDT[dtype]
        _close(got, want, _BAR[dtype])
        if cache_len:
            jcache, tcache = jnew, tnew
            for k in ("k", "v"):
                _close(tcache[k], jcache[k], _BAR[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_chunk_behind_cache_runs_on_torch_and_raises_on_kernels(dtype):
    """A 3-token chunk at cache_pos 5 needs the reference's bottom-right
    mask: the torch backend computes it, the kernels backend refuses it
    (the kernel masks top-left) and never falls back."""
    tcfg, jcfg = _cfg("qwen3-32b", dtype)
    jp = jattn.attn_init(jax.random.PRNGKey(5), jcfg, _JDT[dtype])
    tp = {k: torch.tensor(np.asarray(v, np.float32)).to(_TDT[dtype])
          for k, v in _tree_np(jp).items()}
    x0, x1 = _arrays(6, (2, 5, tcfg.d_model), (2, 3, tcfg.d_model))
    jcache = jattn.init_kv_cache(jcfg, 2, 12, "attn", _JDT[dtype])
    _, jcache = jattn.attention(jp, jnp.asarray(x0, _JDT[dtype]), jcfg,
                                kv_cache=jcache, cache_pos=jnp.int32(0))
    want, _ = jattn.attention(jp, jnp.asarray(x1, _JDT[dtype]), jcfg,
                              kv_cache=jcache, cache_pos=jnp.int32(5))
    for backend in ("torch", "kernels"):
        tcache = attention.init_kv_cache(tcfg, 2, 12, "attn", _TDT[dtype])
        attention.attention(tp, torch.from_numpy(x0).to(_TDT[dtype]), tcfg,
                            kv_cache=tcache, cache_pos=0, backend=backend)
        run = lambda: attention.attention(  # noqa: E731
            tp, torch.from_numpy(x1).to(_TDT[dtype]), tcfg, kv_cache=tcache,
            cache_pos=5, backend=backend)
        if backend == "torch":
            _close(run()[0], want, _BAR[dtype])
        else:
            with pytest.raises(NotImplementedError, match="top-left"):
                run()


def test_decode_with_a_causal_kernel_mask_would_fail():
    """The mask the kernel is given matters: decode over the live slots
    with ``causal=True`` (top-left with Sq = 1) attends to slot 0 only."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 1, 16, generator=g)
    k, v = (torch.randn(1, 2, 6, 16, generator=g) for _ in range(2))
    right = kfa.flash_attention(q, k, v, causal=False)
    wrong = kfa.flash_attention(q, k, v, causal=True)
    assert torch.allclose(wrong, v[:, :, :1])
    assert (right - wrong).abs().max() > 0.1


def test_repeat_kv_matches_reference():
    """The reference repeats (B, T, KVH, Dh); the port the kernel's
    (B, KVH, T, Dh), into a contiguous (B, H, T, Dh) in the same head
    order."""
    (k,) = _arrays(7, (2, 5, 3, 4))
    want = jattn._repeat_kv(jnp.asarray(k), 4)
    heads = attention._repeat_kv(torch.from_numpy(k).transpose(1, 2), 4)
    assert heads.is_contiguous() and heads.shape == (2, 12, 5, 4)
    np.testing.assert_array_equal(heads.transpose(1, 2).numpy(),
                                  np.asarray(want))


# ----------------------------------------------------------- transformer ---

def _both_params(arch, dtype, seed=0):
    tcfg, jcfg = _cfg(arch, dtype)
    jp = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    return tcfg, jcfg, jp, transformer.load_jax_params(_tree_np(jp), tcfg,
                                                       device="cpu")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", _SERVED)
def test_forward_and_decode_match_reference(arch, dtype):
    tcfg, jcfg, jp, tp = _both_params(arch, dtype)
    toks = np.random.default_rng(8).integers(0, tcfg.vocab, (2, 8),
                                             dtype=np.int32)
    want = jtr.forward(jp, jnp.asarray(toks), jcfg)
    jc = jtr.init_caches(jcfg, 2, 12)
    want0, jc = jtr.decode_step(jp, jnp.asarray(toks), jc, jnp.int32(0), jcfg)
    want1, jc = jtr.decode_step(jp, jnp.asarray(toks[:, :1]), jc,
                                jnp.int32(8), jcfg)
    with torch.no_grad():
        for backend in ("kernels", "torch"):
            got = transformer.forward(tp, torch.from_numpy(toks), tcfg,
                                      backend=backend)
            assert got.dtype == _TDT[dtype]
            _close(got, want, _LOGIT_BAR[dtype], floor=0.0)
            tc = transformer.init_caches(tcfg, 2, 12, device="cpu")
            got0, tc = transformer.decode_step(
                tp, torch.from_numpy(toks), tc, 0, tcfg, backend=backend)
            got1, tc = transformer.decode_step(
                tp, torch.from_numpy(toks[:, :1]), tc, 8, tcfg,
                backend=backend)
            _close(got0, want0, _LOGIT_BAR[dtype], floor=0.0)
            _close(got1, want1, _LOGIT_BAR[dtype], floor=0.0)
            for t, j in zip([c[k] for c in tc for k in ("k", "v")],
                            jax.tree.leaves(jc)):
                _close(t, j, _BAR[dtype])


def test_tied_head_matches_reference():
    """A tied LM head (the embedding's transpose)."""
    tcfg, jcfg = _cfg("stablelm-1.6b", "fp32", tie_embeddings=True)
    jp = jtr.init_params(jax.random.PRNGKey(3), jcfg)
    tp = transformer.load_jax_params(_tree_np(jp), tcfg, device="cpu")
    assert "lm_head" not in tp
    toks = np.arange(12, dtype=np.int32).reshape(2, 6)
    with torch.no_grad():
        _close(transformer.forward(tp, torch.from_numpy(toks), tcfg),
               jtr.forward(jp, jnp.asarray(toks), jcfg), 1e-4, floor=0.0)


def test_load_jax_params_checks_the_tree():
    tcfg, _, jp, tp = _both_params("stablelm-1.6b", "bf16")
    tree = _tree_np(jp)
    assert tp["blocks"][0]["mixer"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["embed"].float().numpy(), np.asarray(tree["embed"], np.float32))
    missing = dict(tree, blocks=[dict(tree["blocks"][0], norm2=None)])
    del missing["blocks"][0]["norm2"]
    with pytest.raises(KeyError, match="norm2"):
        transformer.load_jax_params(missing, tcfg, device="cpu")
    with pytest.raises(ValueError, match="final_norm"):
        transformer.load_jax_params(
            dict(tree, final_norm=np.ones(3, np.float32)), tcfg,
            device="cpu")
    with pytest.raises(ValueError, match="embed"):
        transformer.load_jax_params(
            dict(tree, embed=np.asarray(tree["embed"], np.float32)), tcfg,
            device="cpu")


def test_init_params_shapes_and_stacks():
    cfg = configs.get_reduced("qwen3-32b")
    g = torch.Generator().manual_seed(0)
    p = transformer.init_params(g, cfg, device="cpu")
    ref = jax.eval_shape(lambda k: jtr.init_params(
        k, jconfigs.get_reduced("qwen3-32b")), jax.random.PRNGKey(0))
    flat = transformer.flatten_params(p)
    want = transformer.flatten_params(jax.tree.map(lambda a: a, ref))
    assert {k: tuple(v.shape) for k, v in flat.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.bfloat16 for v in flat.values())
    # a seed draws the same weights again
    again = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    assert all(torch.equal(flat[k], v)
               for k, v in transformer.flatten_params(again).items())


# --------------------------------------------------------------- serving ---

def test_server_generate_matches_reference_serve_loop():
    """``Server.generate`` (fp32, kernels backend) against a loop of the
    reference's jitted ``make_serve_step`` without a mesh: tokens equal."""
    tcfg, jcfg, jp, tp = _both_params("stablelm-1.6b", "fp32", seed=11)
    toks = np.random.default_rng(12).integers(0, tcfg.vocab, (3, 7),
                                              dtype=np.int32)
    gen = 6
    step = jax.jit(jsteps.make_serve_step(jcfg))
    caches = jtr.init_caches(jcfg, 3, 7 + gen + 1)
    tok, caches = step(jp, caches, {"token": jnp.asarray(toks),
                                    "cache_pos": jnp.int32(0)})
    want = [np.asarray(tok)]
    for t in range(7, 7 + gen - 1):
        tok, caches = step(jp, caches, {"token": tok,
                                        "cache_pos": jnp.int32(t)})
        want.append(np.asarray(tok))
    srv = serve.Server(tcfg, max_len=7 + gen + 1, device="cpu", params=tp)
    got = srv.generate(toks, gen)
    assert got.shape == (3, gen) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen3-32b"])
def test_parallel_prefill_matches_sequential_loop(arch):
    """The reference test's check on the port: ONE multi-token serve step
    gives the same caches (bf16 tolerance) and next token as the
    token-by-token loop."""
    srv = serve.Server(configs.get_reduced(arch), max_len=16, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    assert srv.parallel_prefill_ok()
    toks = np.random.default_rng(0).integers(0, 256, (2, 6), dtype=np.int32)
    tok_par, caches_par, pos_par = srv.prefill(toks)
    tok_seq, caches_seq, pos_seq = srv.prefill(toks, slow=True)
    assert pos_par == pos_seq == 6
    assert torch.equal(tok_par, tok_seq)
    for a, b in zip(caches_par, caches_seq):
        for k in ("k", "v"):
            np.testing.assert_allclose(a[k].float().numpy(),
                                       b[k].float().numpy(),
                                       rtol=2e-2, atol=2e-2)


def test_serve_step_launch_counts():
    """Every product of a serve step goes through the matmul kernel and
    every attention through the flash-attention kernel: 7 x layers + 1 and
    layers launches, prefill or decode (their plain versions counted on
    the CPU; ``chip_smoke.py`` phase 25 gates the same counts on the
    card)."""
    cfg = configs.get_reduced("stablelm-1.6b")
    srv = serve.Server(cfg, max_len=12, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    counts = {"matmul": 0, "flash_attention": 0}
    mm, fa = kmm.matmul_plain, kfa.attention_plain

    def count(name, fn):
        def wrapper(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapper

    toks = np.zeros((2, 5), np.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kmm, "matmul_plain", count("matmul", mm))
        mp.setattr(kfa, "attention_plain", count("flash_attention", fa))
        tok, caches, pos = srv.prefill(toks)
        assert counts == {"matmul": 7 * cfg.num_layers + 1,
                          "flash_attention": cfg.num_layers}
        srv.serve_step(srv.params, caches, {"token": tok, "cache_pos": pos})
        assert counts == {"matmul": 2 * (7 * cfg.num_layers + 1),
                          "flash_attention": 2 * cfg.num_layers}


def test_argmax_takes_the_first_index_on_ties():
    cfg = configs.get_reduced("stablelm-1.6b")
    step = steps.make_serve_step(cfg)
    params = {"embed": torch.zeros(cfg.vocab, cfg.d_model)}
    logits = torch.tensor([[[0.0, 2.0, 2.0, 1.0]]])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transformer, "decode_step",
                   lambda *a, **kw: (logits, a[2]))
        tok, _ = step(params, [], {"token": None, "cache_pos": 0})
    assert tok.tolist() == [[1]] and tok.dtype == torch.int32
    assert int(jnp.argmax(jnp.asarray(logits[0, -1].numpy()))) == 1


def test_prefill_step_is_the_forward():
    cfg = configs.get_reduced("stablelm-1.6b")
    p = transformer.init_params(torch.Generator().manual_seed(1), cfg,
                                device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with torch.no_grad():
        out = steps.make_prefill_step(cfg)(p, {"tokens": toks})
        assert torch.equal(out, transformer.forward(p, toks, cfg))


def test_parallel_prefill_gating():
    """As the reference's: windowed, recurrent and encoder-decoder configs
    keep the sequential loop."""
    for arch, ok in (("stablelm-1.6b", True), ("gemma3-12b", False),
                     ("xlstm-1.3b", False), ("whisper-small", False),
                     ("jamba-1.5-large-398b", False)):
        assert serve.parallel_prefill_ok(configs.get_reduced(arch)) is ok
        assert (serve.parallel_prefill_ok(jconfigs.get_reduced(arch))
                is ok)


@pytest.mark.parametrize("arch", _ENCDEC)
def test_unported_configs_raise_at_construction(arch):
    """An encoder-decoder is refused by the decoder-only module, which
    names its own, while the steps and ``Server`` accept it."""
    cfg = configs.get_reduced(arch)
    g = torch.Generator().manual_seed(0)
    decoder_only = (lambda: transformer.init_params(g, cfg, device="cpu"),
                    lambda: transformer.init_caches(cfg, 1, 8,
                                                    device="cpu"))
    generic = (lambda: serve.Server(cfg, device="cpu", generator=g),
               lambda: steps.make_serve_step(cfg),
               lambda: steps.make_prefill_step(cfg))
    for build in decoder_only:
        with pytest.raises(NotImplementedError,
                           match="repro_torch.models.encdec"):
            build()
    for build in generic:
        assert build() is not None


@pytest.mark.parametrize("arch", _RECURRENT)
def test_recurrent_configs_build_at_construction(arch):
    """The configs of the recurrent mixers build in every entry point: the
    full config's parameters on the meta device, with the reference's tree
    (names, shapes, dtypes); the reduced config's parameters, caches,
    ``Server`` and steps on the CPU, the caches as the reference's."""
    full = configs.get_config(arch)
    got = transformer.flatten_params(transformer.init_params(None, full,
                                                             device="meta"))
    want = transformer.flatten_params(
        jtr.init_abstract(jconfigs.get_config(arch)))
    assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for k, t in got.items()} == {
        k: (tuple(a.shape), str(a.dtype)) for k, a in want.items()}
    cfg = configs.get_reduced(arch)
    g = torch.Generator().manual_seed(0)
    params = transformer.init_params(g, cfg, device="cpu")
    caches = transformer.init_caches(cfg, 2, 8, device="cpu")
    want = jtr.init_caches(jconfigs.get_reduced(arch), 2, 8)
    assert [{k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
             for k, t in c.items()} for c in caches] == [
        {k: (a.shape, str(a.dtype)) for k, a in c.items()} for c in want]
    srv = serve.Server(cfg, device="cpu", params=params)
    assert not srv.parallel_prefill_ok()
    assert steps.make_serve_step(cfg) is not None
    assert steps.make_prefill_step(cfg) is not None


def test_server_rejects_unknown_backend():
    with pytest.raises(ValueError, match="unknown backend"):
        serve.Server(configs.get_reduced("stablelm-1.6b"), device="cpu",
                     backend="xla")


def test_cli_runs_reduced_on_cpu(capsys):
    serve.main(["--arch", "stablelm-1.6b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "5", "--gen-len", "3"])
    out = capsys.readouterr().out
    assert "[serve] stablelm-1.6b-reduced on cpu (kernels): generated (2, 3)" \
        in out
