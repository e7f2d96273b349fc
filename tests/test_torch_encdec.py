"""The port's encoder-decoder (whisper-small) against the JAX reference, on
the CPU.

The reduced ``whisper-small`` config runs in fp32 (``cfg.replace(dtype=
"float32")`` on both sides) and in bf16, on both port backends: on the CPU
``"kernels"`` runs the matmul and flash-attention kernels' plain versions
(through their autograd Functions when a gradient is taken), ``"torch"``
runs ``torch.matmul`` and SDPA.  Inputs are drawn from a seed with numpy;
parameters are the reference's ``init_params`` tree carried across by
``repro_torch.models.encdec.load_jax_params``.  The reference's steps are
jitted without a mesh.

Bars (ROADMAP.md, DESIGN.md §12): fp32 values at 1e-5 and gradients at
1e-4 x max(1, max|ref|); bf16 values within 5% and gradients within 10%
of max|ref| (relative L2 where a whole parameter tensor is held).
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
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.models import layers as jlayers
from repro.optim import adamw_init as jadamw_init
from repro_torch import checkpoint as tckpt
from repro_torch import configs
from repro_torch.distributed.fault_tolerance import FailureInjector
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.launch import serve, steps, train
from repro_torch.models import attention, encdec, transformer
from repro_torch.optim import adamw_init

_JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
_CFG_DTYPE = {"fp32": "float32", "bf16": "bfloat16"}
_VALUE_BAR = {"fp32": 1e-5, "bf16": 5e-2}
_GRAD_BAR = {"fp32": 1e-4, "bf16": 1e-1}
_ARCH = "whisper-small"

# chip_smoke.py's launch oracles and its split of a step's launches by part
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True)
def _no_sharding_hook(monkeypatch):
    """The reference's model functions without a mesh: another test file in
    this process may have left the sharding hook of its ``Server``."""
    monkeypatch.setattr(jlayers, "_CONSTRAINT_FN", None)


@pytest.fixture
def plain_counts(monkeypatch):
    """Count the matmul and attention plain dispatches (the kernels' plain
    versions stand in for them on the CPU)."""
    counts = {"matmul": 0, "flash_attention": 0}
    mm, fa = kmm.matmul_plain, kfa.attention_plain

    def count_mm(a, b):
        counts["matmul"] += 1
        return mm(a, b)

    def count_fa(q, k, v, *, causal=True, window=0):
        counts["flash_attention"] += 1
        return fa(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(kmm, "matmul_plain", count_mm)
    monkeypatch.setattr(kfa, "attention_plain", count_fa)
    return counts


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


def _cfg(dtype, **kw):
    return (configs.get_reduced(_ARCH).replace(dtype=_CFG_DTYPE[dtype], **kw),
            jconfigs.get_reduced(_ARCH).replace(dtype=_CFG_DTYPE[dtype],
                                                **kw))


def _both_params(dtype, seed=0, **kw):
    tcfg, jcfg = _cfg(dtype, **kw)
    jp = jed.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = encdec.load_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return tcfg, jcfg, jp, tp


def _frames(cfg, rows, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (rows, cfg.encoder_ctx, cfg.d_model)).astype(np.float32)


def _tokens(cfg, rows, seq, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (rows, seq),
                                                dtype=np.int32)


def _batch(cfg, rows, seq, seed=0):
    toks = _tokens(cfg, rows, seq + 1, seed)
    mask = np.ones((rows, seq), np.float32)
    mask[0, :3] = 0.0   # a masked-out prefix: the loss is a masked mean
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask,
            "frames": _frames(cfg, rows, seed + 1)}


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            b.items()}


# ------------------------------------------------------ cross attention ---

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("sq,sk", [(1, 32), (9, 32), (40, 7)])
def test_cross_attention_matches_reference(sq, sk, backend, dtype):
    """``attention(xa=)`` with Sq != Sk: k and v from ``xa``, no RoPE, no
    mask; a cache passed beside ``xa`` is neither written nor read."""
    tcfg, jcfg = _cfg(dtype)
    jp = jattn.attn_init(jax.random.PRNGKey(3), jcfg, _JDT[dtype],
                         cross=True)
    tp = {k: torch.tensor(np.asarray(v, np.float32)).to(_TDT[dtype])
          for k, v in jax.tree.map(np.asarray, jp).items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, sq, tcfg.d_model)).astype(np.float32)
    xa = rng.standard_normal((2, sk, tcfg.d_model)).astype(np.float32)
    want, jcache = jattn.attention(jp, jnp.asarray(x, _JDT[dtype]), jcfg,
                                   xa=jnp.asarray(xa, _JDT[dtype]))
    cache = attention.init_kv_cache(tcfg, 2, 4, "attn", _TDT[dtype])
    got, tcache = attention.attention(
        tp, torch.from_numpy(x).to(_TDT[dtype]), tcfg, kv_cache=cache,
        cache_pos=0, xa=torch.from_numpy(xa).to(_TDT[dtype]),
        backend=backend)
    assert jcache is None and tcache is None
    assert not cache["k"].any() and not cache["v"].any()
    assert got.dtype == _TDT[dtype]
    _close(got, want, 2e-2 if dtype == "bf16" else _VALUE_BAR["fp32"])


def test_cross_attention_init_has_no_qk_norm():
    """As the reference's ``attn_init(cross=True)``: a qk-norm config's
    cross attention has only its four projections."""
    cfg = configs.get_reduced("qwen3-32b")
    g = torch.Generator().manual_seed(0)
    assert set(attention.attn_init(g, cfg, device="cpu")) == {
        "wq", "wk", "wv", "wo", "q_norm", "k_norm"}
    assert set(attention.attn_init(g, cfg, device="cpu", cross=True)) == {
        "wq", "wk", "wv", "wo"}


# ---------------------------------------------------------------- model ---

_REF: dict = {}


def _reference_run(dtype, fr, toks):
    """The reference's encoder output, teacher-forced logits and five
    decode steps (logits and caches), run once per dtype: both backends'
    cases hold the port to the same run."""
    if dtype not in _REF:
        _, jcfg, jp, _ = _both_params(dtype)
        jenc = jed.encode(jp, jnp.asarray(fr), jcfg)
        fwd = jed.forward(jp, jnp.asarray(toks), jnp.asarray(fr), jcfg)
        jc, steps_ = jed.init_caches(jcfg, 2, 12), []
        for i in range(5):
            want, jc = jed.decode_step(jp, jnp.asarray(toks[:, i:i + 1]),
                                       jenc, jc, jnp.int32(i), jcfg)
            steps_.append((_np(want), {k: _np(jc[k]) for k in ("k", "v")}))
        _REF[dtype] = (_np(jenc), _np(fwd), steps_)
    return _REF[dtype]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_encode_forward_and_decode_match_reference(backend, dtype):
    """``encode``, the teacher-forced ``forward`` and five ``decode_step``s
    (with their caches) against the reference's."""
    tcfg, jcfg, jp, tp = _both_params(dtype)
    fr, toks = _frames(tcfg, 2), _tokens(tcfg, 2, 8)
    bar = _VALUE_BAR[dtype]
    jenc, jfwd, jsteps_ = _reference_run(dtype, fr, toks)
    with torch.no_grad():
        tenc = encdec.encode(tp, torch.from_numpy(fr), tcfg, backend)
        assert tenc.dtype == _TDT[dtype]
        _close(tenc, jenc, bar)
        _close(encdec.forward(tp, torch.from_numpy(toks),
                              torch.from_numpy(fr), tcfg, backend),
               jfwd, bar, floor=0.0)
        tc = encdec.init_caches(tcfg, 2, 12, device="cpu")
        assert set(tc) == {"k", "v"} and tc["k"].shape == (
            tcfg.num_layers, 2, 12, tcfg.kv_heads, tcfg.head_dim)
        for i, (want, jc) in enumerate(jsteps_):
            got, tc = encdec.decode_step(tp, torch.from_numpy(
                toks[:, i:i + 1]), tenc, tc, i, tcfg, backend)
            _close(got, want, bar, floor=0.0)
            for k in ("k", "v"):
                _close(tc[k], jc[k], bar)


def test_frames_plus_positions_round_once_in_bf16():
    """``frames + enc_pos`` is one bf16 addition of the bf16-cast frames,
    as the reference's: with no encoder layer the encoder output is
    ``enc_norm`` of it, bit for bit."""
    tcfg, jcfg, jp, tp = _both_params("bf16")
    tcfg, jcfg = (c.replace(encoder_layers=0) for c in (tcfg, jcfg))
    fr = _frames(tcfg, 2) * 3
    got = encdec.encode(tp, torch.from_numpy(fr), tcfg)
    want = jed.encode(dict(jp, enc_blocks=jax.tree.map(
        lambda a: a[:0], jp["enc_blocks"])), jnp.asarray(fr), jcfg)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_steps_match_reference():
    """``make_prefill_step`` (frames in the batch) and ``make_serve_step``
    (``enc_out`` in the batch) against the reference's jitted steps."""
    tcfg, jcfg, jp, tp = _both_params("fp32", seed=2)
    fr, toks = _frames(tcfg, 3, 5), _tokens(tcfg, 3, 6, 6)
    want = jax.jit(jsteps.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)})
    got = steps.make_prefill_step(tcfg)(
        tp, {"tokens": torch.from_numpy(toks),
             "frames": torch.from_numpy(fr)})
    _close(got, want, _VALUE_BAR["fp32"], floor=0.0)
    jenc = jed.encode(jp, jnp.asarray(fr), jcfg)
    jstep = jax.jit(jsteps.make_serve_step(jcfg))
    tstep = steps.make_serve_step(tcfg)
    jc = jed.init_caches(jcfg, 3, 8)
    tc = encdec.init_caches(tcfg, 3, 8, device="cpu")
    tenc = encdec.encode(tp, torch.from_numpy(fr), tcfg)
    for i in range(3):
        jt, jc = jstep(jp, jc, {"token": jnp.asarray(toks[:, i:i + 1]),
                                "cache_pos": jnp.int32(i), "enc_out": jenc})
        tt, tc = tstep(tp, tc, {"token": torch.from_numpy(toks[:, i:i + 1]),
                                "cache_pos": i, "enc_out": tenc})
        assert tt.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        for k in ("k", "v"):
            _close(tc[k], jc[k], _VALUE_BAR["fp32"])


def test_load_jax_params_checks_the_tree():
    tcfg, _, jp, tp = _both_params("bf16")
    tree = jax.tree.map(np.asarray, jp)
    assert tp["dec_blocks"]["cross_attn"]["wk"].dtype == torch.bfloat16
    assert tp["enc_blocks"]["attn"]["wq"].shape == (
        tcfg.encoder_layers, tcfg.d_model, tcfg.d_model)
    np.testing.assert_array_equal(_np(tp["enc_pos"]),
                                  np.asarray(tree["enc_pos"], np.float32))
    missing = dict(tree, dec_blocks=dict(tree["dec_blocks"]))
    del missing["dec_blocks"]["norm3"]
    with pytest.raises(KeyError, match="norm3"):
        encdec.load_jax_params(missing, tcfg, device="cpu")
    with pytest.raises(KeyError, match="extra"):
        encdec.load_jax_params(dict(tree, final_norm=tree["enc_norm"]),
                               tcfg, device="cpu")
    with pytest.raises(ValueError, match="enc_pos"):
        encdec.load_jax_params(dict(tree, enc_pos=tree["enc_pos"][:3]),
                               tcfg, device="cpu")


def test_init_params_shapes_and_count():
    """The tree's names, shapes and dtypes are the reference's; a seed
    draws the same weights again; the published model has 334,468,608
    parameters by ``param_counts`` (which leaves out the RMSNorm gains
    and ``enc_pos``)."""
    cfg = configs.get_reduced(_ARCH)
    flat = transformer.flatten_params(encdec.init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    ref = transformer.flatten_params(jax.eval_shape(lambda k: jed.init_params(
        k, jconfigs.get_reduced(_ARCH)), jax.random.PRNGKey(0)))
    assert {k: tuple(v.shape) for k, v in flat.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert all(v.dtype == torch.bfloat16 for v in flat.values())
    again = transformer.flatten_params(encdec.init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    assert all(torch.equal(flat[k], v) for k, v in again.items())
    full = configs.get_config(_ARCH)
    meta = transformer.flatten_params(encdec.init_params(None, full,
                                                         device="meta"))
    n = sum(t.numel() for k, t in meta.items()
            if "norm" not in k and k != "enc_pos")
    assert n == full.param_counts()["total"] == 334_468_608
    with pytest.raises(ValueError, match="no encoder"):
        encdec.init_params(None, configs.get_reduced("stablelm-1.6b"),
                           device="meta")


def test_decoder_only_module_refuses_encdec():
    cfg = configs.get_reduced(_ARCH)
    with pytest.raises(NotImplementedError, match="repro_torch.models.encdec"):
        transformer.init_params(None, cfg, device="meta")


# --------------------------------------------------------------- serving ---

def test_server_generate_matches_reference_serve_loop():
    """``Server.generate(frames=)`` (fp32, kernels backend) against
    ``encode`` and a loop of the reference's jitted ``make_serve_step``
    with ``enc_out`` in every batch: tokens equal."""
    tcfg, jcfg, jp, tp = _both_params("fp32", seed=11)
    fr, toks = _frames(tcfg, 3, 12), _tokens(tcfg, 3, 4, 13)
    gen = 6
    jenc = jed.encode(jp, jnp.asarray(fr), jcfg)
    step = jax.jit(jsteps.make_serve_step(jcfg))
    caches = jed.init_caches(jcfg, 3, 4 + gen + 1)
    for t in range(4):
        tok, caches = step(jp, caches, {"token": jnp.asarray(toks[:, t:t + 1]),
                                        "cache_pos": jnp.int32(t),
                                        "enc_out": jenc})
    want = [np.asarray(tok)]
    for t in range(4, 4 + gen - 1):
        tok, caches = step(jp, caches, {"token": tok,
                                        "cache_pos": jnp.int32(t),
                                        "enc_out": jenc})
        want.append(np.asarray(tok))
    srv = serve.Server(tcfg, max_len=4 + gen + 1, device="cpu", params=tp)
    got = srv.generate(toks, gen, frames=fr)
    assert got.shape == (3, gen) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))


def test_server_frames_rules():
    """An encoder-decoder needs frames (or their encoder output) and keeps
    the token loop; a decoder-only config refuses frames."""
    cfg = configs.get_reduced(_ARCH)
    srv = serve.Server(cfg, max_len=8, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    toks, fr = _tokens(cfg, 2, 3), _frames(cfg, 2)
    assert not srv.parallel_prefill_ok()
    with pytest.raises(ValueError, match="pass frames"):
        srv.prefill(toks)
    with pytest.raises(ValueError, match="pass frames"):
        srv.generate(toks, 2)
    with pytest.raises(ValueError, match="parallel prefill"):
        srv.prefill(toks, frames=fr, slow=False)
    tok_f, caches_f, pos = srv.prefill(toks, frames=fr)
    tok_e, caches_e, _ = srv.prefill(toks, enc_out=srv.encode(fr))
    assert pos == 3 and torch.equal(tok_f, tok_e)
    assert all(torch.equal(caches_f[k], caches_e[k]) for k in ("k", "v"))
    lm = serve.Server(configs.get_reduced("stablelm-1.6b"), max_len=8,
                      device="cpu",
                      generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="decoder-only"):
        lm.prefill(toks, frames=fr)
    with pytest.raises(ValueError, match="decoder-only"):
        lm.generate(toks, 2, frames=fr)
    with pytest.raises(ValueError, match="decoder-only"):
        lm.encode(fr)


def test_serve_launch_counts(plain_counts):
    """An encode launches ``chip_smoke.encode_launches`` and each serve
    step ``chip_smoke.lm_step_launches`` (12 x 7 and 12, 12 x 11 + 1 and 24
    at the published depth; here the plain dispatches; ``chip_smoke.py``
    phase 27a gates the same on the card)."""
    cfg = configs.get_reduced(_ARCH)
    srv = serve.Server(cfg, max_len=8, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    enc = chip_smoke.encode_launches(cfg)
    step = chip_smoke.lm_step_launches(cfg)
    assert (enc["matmul"], enc["flash_attention"]) == (14, 2)
    assert (step["matmul"], step["flash_attention"]) == (23, 4)
    enc_out = srv.encode(_frames(cfg, 2))
    assert plain_counts == {k: enc[k] for k in plain_counts}
    srv.prefill(_tokens(cfg, 2, 3), enc_out=enc_out)
    assert plain_counts == {k: enc[k] + 3 * step[k] for k in plain_counts}
    full = configs.get_config(_ARCH)
    assert chip_smoke.encode_launches(full)["matmul"] == 84
    assert chip_smoke.lm_step_launches(full)["matmul"] == 133
    assert chip_smoke.lm_step_launches(full)["flash_attention"] == 24


def test_serve_cli_on_the_cpu(capsys):
    serve.main(["--arch", _ARCH, "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "4", "--gen-len", "3"])
    out = capsys.readouterr().out
    assert "[serve] whisper-small-reduced on cpu (kernels): generated " \
        "(2, 3)" in out


# -------------------------------------------------------------- training ---

def _opt_leaves(state):
    out = {}
    for part in ("master", "mu", "nu"):
        tree = getattr(state, part)
        if tree is not None:
            out.update({f"{part}.{k}": v for k, v in
                        transformer.flatten_params(tree).items()})
    return out


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("microbatches,remat", [(1, False), (2, False),
                                                (2, True)])
def test_train_step_matches_reference(microbatches, remat, dtype):
    """Two steps of the port's ``make_train_step`` on both backends against
    two of the reference's jitted one, from the same state and batch:
    loss, grad_norm, every parameter and optimizer leaf."""
    tcfg, jcfg, jp, tp = _both_params(dtype, remat=remat)
    b = _batch(tcfg, 4, 12, seed=6)
    jstep = jax.jit(jsteps.make_train_step(jcfg, warmup=2, total_steps=10,
                                           microbatches=microbatches))
    jo = jadamw_init(jp)
    jbatch = jax.tree.map(jnp.asarray, b)
    jp1, jo1, _ = jstep(jp, jo, jbatch)
    jp2, jo2, jm = jstep(jp1, jo1, jbatch)
    jflat = transformer.flatten_params(jax.tree.map(np.asarray, jp2))
    jopt = _opt_leaves(jax.tree.map(np.asarray, jo2))
    exact = dtype == "fp32"
    vbar, gbar = _VALUE_BAR[dtype], _GRAD_BAR[dtype]
    for backend in ("kernels", "torch"):
        step = steps.make_train_step(tcfg, warmup=2, total_steps=10,
                                     microbatches=microbatches,
                                     backend=backend)
        to = adamw_init(transformer.flatten_params(tp))
        batch = _torch_batch(b)
        tp1, to1, _ = step(tp, to, batch)
        tp2, to2, m = step(tp1, to1, batch)
        for k, bar in (("loss", vbar), ("grad_norm", gbar), ("lr", 1e-6)):
            g, w = float(m[k]), float(jm[k])
            assert abs(g - w) <= bar * abs(w), (backend, k, g, w)
        assert int(to2.step) == 2
        for k, t in transformer.flatten_params(tp2).items():
            assert t.dtype == _TDT[dtype]
            if exact:
                _close(t, jflat[k], gbar)
            else:
                assert _rel_l2(t, jflat[k]) <= 0.05, (backend, k)
        topt = _opt_leaves(to2)
        assert topt.keys() == jopt.keys()
        for k, t in topt.items():
            if exact and k.startswith("master."):
                _close(t, jopt[k], gbar)
            else:
                assert _rel_l2(t, jopt[k]) <= (
                    gbar if exact else 0.1), (backend, k)


def test_remat_keeps_the_encoder_output_gradient():
    """With remat each decoder layer recomputes its cross attention's k and
    v from the encoder output, an input of its checkpoint: the gradients
    (``enc_blocks`` included, which reach the loss only through the
    encoder output) are those without remat."""
    tcfg, _, _, tp = _both_params("fp32", seed=4)
    batch = _torch_batch(_batch(tcfg, 2, 8, seed=5))
    out = {}
    for remat in (False, True):
        vg = steps.make_value_and_grad(tcfg.replace(remat=remat))
        out[remat] = vg(tp, batch)
    (l0, g0), (l1, g1) = out[False], out[True]
    assert torch.equal(l0, l1) and g0.keys() == g1.keys()
    assert float(g1["enc_blocks.attn.wq"].abs().max()) > 0
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=1e-7)


def test_training_tree_helpers():
    """Per-layer leaves of both stacks, their names, and the gradients
    put back into the stacked layout."""
    cfg = configs.get_reduced(_ARCH)
    params = encdec.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    leaves = encdec.unstack_blocks(params, cfg)
    assert len(leaves["enc_blocks"]) == cfg.encoder_layers
    assert len(leaves["dec_blocks"]) == cfg.num_layers
    flat = transformer.flatten_params(leaves)
    assert all(t.requires_grad and t.is_leaf for t in flat.values())
    assert encdec.stacked_name("enc_blocks.1.attn.wq") == (
        "enc_blocks.attn.wq", 1)
    assert encdec.stacked_name("dec_blocks.0.cross_attn.wk") == (
        "dec_blocks.cross_attn.wk", 0)
    assert encdec.stacked_name("enc_pos") == ("enc_pos", None)
    stacked = encdec.stack_grads({k: v.detach() for k, v in flat.items()})
    want = transformer.flatten_params(params)
    assert stacked.keys() == want.keys()
    assert all(torch.equal(stacked[k], want[k]) for k in want)


@pytest.mark.parametrize("case", [
    # (overrides, microbatches)
    ({}, 1), ({"remat": True}, 2)], ids=str)
def test_train_step_dispatch_counts(case, plain_counts):
    """One step's matmul and attention dispatches are what
    ``chip_smoke.lm_train_launches`` works out, in all and by part as
    ``Smoke.counting_parts`` splits them (phase 27a's split on the card);
    at the published depth 217 / 216 / 434 products and 36 / 36 / 0
    attentions a microbatch."""
    kw, mb = case
    cfg = configs.get_reduced(_ARCH).replace(**kw)
    params = encdec.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    opt = adamw_init(transformer.flatten_params(params))
    step = steps.make_train_step(cfg, warmup=2, total_steps=10,
                                 microbatches=mb)
    smoke = chip_smoke.Smoke.__new__(chip_smoke.Smoke)
    smoke.torch, smoke.kmm, smoke.kfa = torch, kmm, kfa
    parts = {}
    with smoke.counting_parts(parts, lambda: dict(plain_counts)):
        step(params, opt, _torch_batch(_batch(cfg, 2, 8)))
    want = chip_smoke.lm_train_launches(cfg, 8, mb)
    assert plain_counts == {k: sum(v.values()) for k, v in want.items()}
    assert parts == want
    full = chip_smoke.lm_train_launches(configs.get_config(_ARCH), 448, 2)
    assert full["matmul"] == {"forward": 434, "recompute": 432,
                              "backward": 868}
    assert full["flash_attention"] == {"forward": 72, "recompute": 72,
                                       "backward": 0}


_LOOP = dict(steps=4, global_batch=4, seq_len=8, microbatches=2,
             ckpt_every=2, device="cpu", log_every=10)


def test_train_resumes_bit_for_bit_after_an_injected_fault(tmp_path):
    """The loop with zero frames: a failure injected at step 3 restores
    the step-2 checkpoint and replays to the uninterrupted run's state bit
    for bit; a restart resumes at the newest checkpoint."""
    cfg = configs.get_reduced(_ARCH)

    def final(d):
        return tckpt.restore_checkpoint(d, tckpt.latest_step(d),
                                        train.init_state(cfg, None, "meta"))

    clean = train.train(cfg, ckpt_dir=str(tmp_path / "a"), **_LOOP)
    hit = train.train(cfg, ckpt_dir=str(tmp_path / "b"),
                      injector=FailureInjector({3}), **_LOOP)
    assert clean["recoveries"] == 0 and hit["recoveries"] == 1
    assert clean["final_step"] == hit["final_step"] == 4
    assert hit["loss"] == clean["loss"] and np.isfinite(hit["loss"])
    got, want = (tckpt.flatten_tree(final(str(tmp_path / d)))[0]
                 for d in "ba")
    assert len(got) == len(want)
    assert all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want))
    more = train.train(cfg, ckpt_dir=str(tmp_path / "a"),
                       **dict(_LOOP, steps=6))
    assert more["final_step"] == 6 and more["recoveries"] == 0


def test_train_loop_feeds_zero_frames(monkeypatch):
    """Each batch of the loop carries zero frames (global_batch,
    encoder_ctx, d_model) fp32, as the reference's loop feeds them."""
    cfg = configs.get_reduced(_ARCH)
    seen = []

    def recording(*a, **k):
        step = steps.make_train_step(*a, **k)

        def run(params, opt, batch):
            seen.append(batch["frames"])
            return step(params, opt, batch)
        run.tp = step.tp
        return run

    monkeypatch.setattr(train, "make_train_step", recording)
    train.train(cfg, **dict(_LOOP, steps=2))
    assert len(seen) == 2
    for f in seen:
        assert f.shape == (4, cfg.encoder_ctx, cfg.d_model)
        assert f.dtype == torch.float32 and not f.any()


def test_train_cli_on_the_cpu(capsys):
    train.main(["--arch", _ARCH, "--reduced", "--steps", "2", "--batch",
                "2", "--seq", "8", "--microbatches", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] step=1" in out and "'final_step': 2" in out
