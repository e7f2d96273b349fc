"""Training the Mamba mixer and the reduced Jamba in the port against the
JAX reference, on the CPU.

The same numpy inputs, drawn from a seed, and the same parameters (the
reference's ``mamba_init`` / ``init_params`` carried across leaf for leaf)
go through the reference's ``jax.value_and_grad`` (jitted once per
function and shape in this module), with its AdamW for a train step, and
through the port's autograd, at
``jamba-1.5-large-398b``'s reduced configuration (d_model 64, d_inner 128,
d_state 8, dt_rank 4; 8 layers, NoPE attention at position 3, a MoE FFN
every second layer).  ``SCAN_CHUNK`` is set small on both packages, so the
chunked scan runs, each chunk under its checkpoint.

Bars, as ``tests/test_torch_xlstm_train.py`` (whose helpers these tests
share): fp32 gradients at 1e-4 x max(1, max|ref|), a train step's new
parameters at 1e-5; bf16 layer by layer, each layer's VJP no farther from
the fp32 VJP of the same bf16 weights than the reference's own, within a
quarter, its MoE FFN on the routes the reference's VJP took.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.kernels import matmul as kmm
from repro_torch.launch import steps
from repro_torch.models import mamba, moe, transformer
from test_torch_xlstm_train import (_tensors, batch_np, chip_smoke,
                                    hold_dispatch_counts, hold_grads,
                                    hold_layer_vjps, hold_resume,
                                    hold_train_step, hold_value_and_grad,
                                    mixer_grads, mixer_grads_ref,
                                    reference_value_and_grad, torch_batch)
from test_torch_xlstm_train import plain_counts  # noqa: F401 (a fixture)

_ARCH = "jamba-1.5-large-398b"
_CFG_DTYPE = {"fp32": "float32", "bf16": "bfloat16"}
_SEQ, _CHUNK = 32, 8
# (sequence length, SCAN_CHUNK, dt_bias): one scan; 4 chunks of 8; 4 chunks
# whose decays underflow: dt ~ 13 makes exp(dt A) for A = -1..-8 run from
# normal through subnormal to exactly 0, and most of each chunk's cumprod 0
_FORMS = {"one_scan": (24, 512, 0.0), "chunked": (32, 8, 0.0),
          "underflow": (32, 8, 13.0)}


#: the chunk checkpoint, and a stand-in that runs the chunk plainly
_CHECKPOINT = mamba.checkpoint


def _no_checkpoint(fn, *args, **kwargs):
    return fn(*args)


@pytest.fixture(autouse=True)
def _no_sharding_hook(monkeypatch):
    """The reference's model functions without a mesh: another test file in
    this process may have left the sharding hook of its ``Server``."""
    monkeypatch.setattr(jlayers, "_CONSTRAINT_FN", None)


def _chunk(monkeypatch, chunk):
    monkeypatch.setattr(jmamba, "SCAN_CHUNK", chunk)
    monkeypatch.setattr(mamba, "SCAN_CHUNK", chunk)


def _mixer(seed, dt_bias=0.0):
    tcfg = configs.get_reduced(_ARCH).replace(dtype="float32")
    jcfg = jconfigs.get_reduced(_ARCH).replace(dtype="float32")
    jp = dict(jmamba.mamba_init(jax.random.PRNGKey(seed), jcfg, jnp.float32))
    jp["dt_bias"] = jnp.full_like(jp["dt_bias"], dt_bias)
    return tcfg, jcfg, jp, _tensors(jp, torch.float32)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("backend", ["kernels", "torch"])
@pytest.mark.parametrize("form", list(_FORMS))
def test_mamba_gradients_match_reference(form, backend, monkeypatch):
    """``mamba_block`` under autograd against ``jax.value_and_grad`` of the
    reference's, dx and every leaf (``dt_proj`` through its fp32 product,
    the fp32 ``dt_bias``, ``A_log`` and ``D``) at 1e-4 x max(1, max|ref|):
    one scan, the chunked scan (each chunk checkpointed), and a chunked
    case built to underflow, where the gradient runs through
    ``torch.cumprod``'s zero handling and JAX's scan of products."""
    s, chunk, bias = _FORMS[form]
    _chunk(monkeypatch, chunk)
    tcfg, jcfg, jp, tp = _mixer(seed=1, dt_bias=bias)
    x, cot = _inputs((2, s, tcfg.d_model), 2)
    if form == "underflow":
        with torch.no_grad():
            xz = transformer.linear(torch.from_numpy(x), tp["in_proj"])
            xc = torch.nn.functional.silu(mamba._causal_conv(
                xz[..., :xz.shape[-1] // 2], tp["conv_w"], tp["conv_b"]))
            a = mamba._ssm_params(tp, xc, tcfg, "torch")[0]
        decay = torch.cumprod(a[:, :chunk], dim=1)
        assert (a == 0).any() and ((a > 0) & (a < 1.1754944e-38)).any()
        assert (decay == 0).float().mean() > 0.5
    want = mixer_grads_ref((_ARCH, "mamba", s, chunk, bias),
                           jmamba.mamba_block, jcfg, jp, jnp.asarray(x),
                           jnp.asarray(cot))
    got = mixer_grads(mamba.mamba_block, tcfg, tp, torch.from_numpy(x),
                      torch.from_numpy(cot), backend)
    hold_grads(got, want, f"mamba {form} {backend}")


def _block_grads(tp, x, cfg, backend="kernels"):
    leaves = {k: v.detach().requires_grad_() for k, v in tp.items()}
    tx = x.detach().requires_grad_()
    y = mamba.mamba_block(leaves, tx, cfg, backend=backend)[0]
    return y, torch.autograd.grad(y.float().square().sum(),
                                  [tx, *leaves.values()])


@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_chunk_checkpoint_on_and_off_give_the_same_gradients(
        backend, monkeypatch, plain_counts):
    """The per-chunk checkpoint recomputes each chunk as it ran: output and
    every gradient bit for bit those without it.  On the kernels backend
    the chunked forward launches 2 + 2 x 4 products with it or without it;
    the checkpointed backward runs each chunk's ``x_proj`` and ``dt_proj``
    again before their dA and dB."""
    _chunk(monkeypatch, _CHUNK)
    tcfg, _, _, tp = _mixer(seed=3)
    x = torch.from_numpy(_inputs((2, _SEQ, tcfg.d_model), 4)[0]).bfloat16()
    tp = {k: (v if v.dtype == torch.float32 and k in ("dt_bias", "A_log",
                                                      "D") else v.bfloat16())
          for k, v in tp.items()}
    tcfg = tcfg.replace(dtype="bfloat16")
    out = {}
    for on in (True, False):
        monkeypatch.setattr(mamba, "checkpoint",
                            _CHECKPOINT if on else _no_checkpoint)
        plain_counts["matmul"] = 0
        out[on] = _block_grads(tp, x, tcfg, backend)
        if backend == "kernels":
            assert plain_counts["matmul"] == 3 * (2 + 2 * 4) + (
                2 * 4 if on else 0)
    (y1, g1), (y0, g0) = out[True], out[False]
    assert torch.equal(y1, y0)
    for a, b in zip(g1, g0):
        assert torch.equal(a, b)


def test_serving_runs_no_checkpoint(monkeypatch, plain_counts):
    """Grad off (serving): the chunks run plainly, no checkpoint is made,
    and a chunked forward launches its 2 + 2 x chunks products, as in
    serving before the checkpoint."""
    _chunk(monkeypatch, _CHUNK)
    tcfg, _, _, tp = _mixer(seed=5)
    x = torch.from_numpy(_inputs((1, _SEQ, tcfg.d_model), 6)[0])

    def refuse(*a, **k):
        raise AssertionError("a checkpoint on the serving path")

    monkeypatch.setattr(mamba, "checkpoint", refuse)
    with torch.no_grad():
        mamba.mamba_block(tp, x, tcfg)
    assert plain_counts["matmul"] == 2 + 2 * 4 == sum(
        chip_smoke.mixer_products(tcfg, "mamba", _SEQ).values())


def test_dt_proj_backward_shapes_match_jax():
    """``MatmulFn`` at ``dt_proj``'s training shapes, fp32: the forward
    contracts over K = dt_rank (512 at full width), its dB over the
    512-token chunk, its dA over d_inner (cut to 256 here)."""
    rng = np.random.default_rng(7)
    a, b, cot = (rng.standard_normal(s).astype(np.float32)
                 for s in ((512, 512), (512, 256), (512, 256)))
    jga, jgb = jax.grad(lambda x, w: jnp.sum((x @ w) * cot), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(t).requires_grad_() for t in (a, b))
    ga, gb = torch.autograd.grad(kmm.MatmulFn.apply(ta, tb), (ta, tb),
                                 torch.from_numpy(cot))
    for g, jg in ((ga, jga), (gb, jgb)):
        err = np.abs(g.numpy() - np.asarray(jg)).max()
        assert err <= 1e-4 * max(1.0, float(np.abs(jg).max()))


# ------------------------------------------------------ the reduced Jamba ---

def _both_params(dtype="fp32", seed=0, **kw):
    tcfg = configs.get_reduced(_ARCH).replace(dtype=_CFG_DTYPE[dtype], **kw)
    jcfg = jconfigs.get_reduced(_ARCH).replace(dtype=_CFG_DTYPE[dtype],
                                               **kw)
    jp = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = transformer.load_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
    return tcfg, jcfg, jp, tp


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_value_and_grad_matches_reference(microbatches, mode, monkeypatch):
    """``make_value_and_grad`` over the reduced Jamba in fp32 (Mamba layers
    on the chunked scan, NoPE attention, dense and MoE FFNs; in fp32 both
    packages route alike) on both backends against the reference's loss
    and gradients, every leaf at 1e-4 x max(1, max|ref|), plus the bf16
    accumulation's rounding with ``opt_memory_mode="bf16"`` and 2
    microbatches."""
    _chunk(monkeypatch, _CHUNK)
    tcfg, jcfg, jp, tp = _both_params(opt_memory_mode=mode)
    b = batch_np(tcfg.vocab, 2 * microbatches, _SEQ, seed=8)
    want = reference_value_and_grad((_ARCH, "vg"), jp, jcfg, b,
                                    microbatches)
    hold_value_and_grad(tcfg, tp, b, microbatches, want,
                        ("kernels", "torch"))


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches, mode, monkeypatch):
    """The reduced Jamba's ``make_train_step`` in fp32, 1 and 2
    microbatches of 2 rows, ``opt_memory_mode`` fp32 and bf16 (the full
    config's: bf16 moments, no master, gradients summed in bf16 across
    microbatches), against the reference's step composed from its jitted
    ``value_and_grad`` and AdamW (``hold_train_step``)."""
    _chunk(monkeypatch, _CHUNK)
    tcfg, jcfg, jp, tp = _both_params(opt_memory_mode=mode)
    b = batch_np(tcfg.vocab, 2 * microbatches, _SEQ, seed=8)
    hold_train_step(tcfg, jcfg, jp, tp, b, microbatches, mode,
                    (_ARCH, "step", microbatches, mode))


# the experts every ``lax.top_k`` of the reference reports, in call order:
# its jitted functions are traced once and keep reporting here
_TOPK = []


@pytest.fixture
def reference_topk(monkeypatch):
    """``jax.lax.top_k`` reporting its experts into ``_TOPK`` through an
    ordered ``jax.debug.callback`` (a MoE layer's routing is its only
    ``top_k``), so a jitted function traced now reports them each run."""
    orig = jax.lax.top_k

    def top_k(x, k):
        vals, idx = orig(x, k)
        jax.debug.callback(lambda i: _TOPK.append(np.asarray(i)), idx,
                           ordered=True)
        return vals, idx

    monkeypatch.setattr(jax.lax, "top_k", top_k)
    return _TOPK


@contextlib.contextmanager
def _forced(routes):
    """The port's ``moe.route`` taking ``routes`` (experts arrays, one a
    call, in call order)."""
    orig, it = moe.route, iter(routes)

    def rec(router, xt, cfg, backend="kernels", experts=None):
        return orig(router, xt, cfg, backend,
                    experts=torch.from_numpy(np.array(next(it), np.int64)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "route", rec)
        yield
    assert next(it, None) is None


def test_jamba_bf16_layer_vjps_match_reference(monkeypatch, reference_topk):
    """The reduced Jamba in bf16, layer by layer from the reference's
    inputs (``hold_layer_vjps``): the Mamba mixers on the chunked scan (S =
    32, chunks of 8, each checkpointed), the NoPE attention layer, the
    dense FFNs and the MoE FFNs on the routes the reference's VJP took.
    (The single scan's bf16 gradients are the mixer's own, held with
    the chunked ones' arithmetic; each layer's VJP compiles ~2 s here.)"""
    form = "chunked"
    s, chunk, _ = _FORMS[form]
    _chunk(monkeypatch, chunk)
    tcfg, jcfg, jp, tp = _both_params("bf16")
    toks = batch_np(tcfg.vocab, 2, s, seed=10)["tokens"]
    worst = hold_layer_vjps(tcfg, jcfg, jp, tp, toks, topk=reference_topk,
                            force=_forced)
    print(f"{form}: worst bf16 gradient distance, port / reference's "
          f"{worst:.3f}")


# ------------------------------------------------- remat, launches, loop ---

def _grads(tcfg, tp, batch, backend, remat):
    vg = steps.make_value_and_grad(tcfg.replace(remat=remat),
                                   microbatches=2, backend=backend)
    return vg(tp, batch)


@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_remat_and_chunk_checkpoint_give_the_same_gradients(backend,
                                                            monkeypatch):
    """The layer checkpoint (``cfg.remat``) with the scan's chunk
    checkpoint nested inside it, either, or neither: the loss and every
    gradient bit for bit the same (the MoE layers route again in each
    recompute, bit for bit)."""
    _chunk(monkeypatch, _CHUNK)
    tcfg, _, _, tp = _both_params("bf16")
    batch = torch_batch(batch_np(tcfg.vocab, 4, _SEQ, seed=11))
    out = {}
    for remat in (False, True):
        for chunks in (False, True):
            monkeypatch.setattr(mamba, "checkpoint",
                                _CHECKPOINT if chunks else _no_checkpoint)
            out[remat, chunks] = _grads(tcfg, tp, batch, backend, remat)
    l0, g0 = out[False, False]
    for key, (l1, g1) in out.items():
        assert torch.equal(l0, l1) and g0.keys() == g1.keys(), key
        for k in g0:
            assert torch.equal(g0[k], g1[k]), (key, k)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_dispatch_counts(remat, plain_counts, monkeypatch):
    """A step's dispatches over the reduced Jamba (seq 32 in chunks of 8, 2
    microbatches): each Mamba layer's 2 + 2 x 4 products forward, its
    chunks' 2 x 4 again in the backward (the chunk checkpoint; under remat
    the layer's 10 again as well), the attention layer, the MoE layers'
    batched products and routers, as ``chip_smoke.lm_train_split``
    works them out."""
    _chunk(monkeypatch, _CHUNK)
    cfg = configs.get_reduced(_ARCH).replace(remat=remat)
    want = hold_dispatch_counts(cfg, _SEQ, 2, plain_counts)
    mambas = cfg.repeat * cfg.block_pattern.count("mamba")
    fwd = want["matmul"]["forward"]
    assert want["matmul"]["recompute"] == (
        (fwd - 2 if remat else 0) + 2 * mambas * 2 * 4)


def test_phase_32c_launch_oracle_at_full_width():
    """Phase 32c's Mamba mixer of Jamba-1.5-Large at 1 x 4096 under
    autograd: 2 + 2 x 8 products forward (8 fp32 ``dt_proj`` on
    ``simt``), the chunks' 16 again in the backward, 36 backward products;
    the 8 ``dt_proj`` recomputes and their dA and dB on ``simt``."""
    full = configs.get_config(_ARCH)
    assert chip_smoke.scan_chunks(full, 4096) == 8
    mm = chip_smoke.mixer_matmuls(full, "mamba", 4096)
    assert len(mm) == 18 and mm[-1] == (512, 512, 16384, "fp32")
    assert chip_smoke.mixer_train_split(full, 4096) == {
        "forward": {"wgmma": 10, "simt": 8},
        "recompute": {"wgmma": 8, "simt": 8},
        "backward": {"wgmma": 20, "simt": 16}}


def test_train_resumes_bit_for_bit_after_an_injected_fault(tmp_path,
                                                           monkeypatch):
    _chunk(monkeypatch, _CHUNK)
    hold_resume(configs.get_reduced(_ARCH), tmp_path)


def test_train_cli_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import train

    _chunk(monkeypatch, _CHUNK)
    train.main(["--arch", _ARCH, "--reduced", "--steps", "2", "--batch",
                "4", "--seq", str(_SEQ), "--microbatches", "2", "--device",
                "cpu"])
    out = capsys.readouterr().out
    assert "[train] step=1" in out and "'final_step': 2" in out
