"""xLSTM blocks, the port of ``repro.models.xlstm``: mLSTM (a matrix
memory, parallel over the sequence) and sLSTM (a scalar memory, recurrent),
Beck et al. 2024, arXiv:2405.04517.

Every projection goes through :func:`~repro_torch.models.layers.linear`
(kernel 3 under ``backend="kernels"``), in the dtype the reference gives
each product, form by form:

* **mLSTM without a cache**: ``up_proj``, ``wq``, ``wk``, ``wv`` and
  ``out_proj`` in the model dtype (q, k and v are cast to fp32 after their
  products); the gates ``xc.float() @ w_if``, an fp32 leaf.  The
  sequence mixes in :func:`_mlstm_parallel` (a stabilised, decayed
  attention matrix), or :func:`_mlstm_chunkwise` when ``S > M_CHUNK`` and
  ``S % M_CHUNK == 0`` (a (C, n, m) state carried over chunks of
  :data:`M_CHUNK`).  Their contractions q k^T, scores v and q C are fp32
  ``torch.matmul``/``einsum`` products outside any kernel, as the
  reference leaves them to XLA: IEEE fp32 on the card (no TF32).
* **mLSTM decode** (S = 1): products of fp32 activations with fp32 copies
  of ``wq``, ``wk`` and ``wv``, made at each step (the cast is exact; a
  weight costs its fp32 copy, 4 bytes an entry, only while its product
  runs), as the reference's ``w.astype(f32)``; an fp32 conv cache.
* **sLSTM**: ``x @ w_gates`` in the model dtype, then fp32; the recurrent
  ``h @ r_gates`` in fp32 on one fp32 copy of ``r_gates`` a call (not one a
  step); a loop over time for S > 1 (the reference's ``lax.scan``), one
  step for decode; an FFN ``gelu(y @ ff_up) @ ff_down`` with the
  reference's tanh GELU (``jax.nn.gelu``'s default).

Caches are written in place and returned, as the attention layers' are.
No kernel of the reference carries these recurrences (they are XLA ops); a
persistent sLSTM step and the mLSTM chunk on the tensor cores are levers
(ROADMAP.md).  A call launches kernel 3: an mLSTM block 6 times, an sLSTM
block 3 + S times (the recurrent product once a step).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, linear, normal_init
from repro_torch.models.mamba import _causal_conv

#: the reference's mLSTM chunk (tests set it small on both packages)
M_CHUNK = 512


def _dims(cfg: ModelConfig):
    """(xLSTM config, d_inner, mLSTM head width): the head width is
    ``int(m_proj_factor * d_model) // num_heads``, not ``cfg.head_dim``."""
    x = cfg.xlstm
    d_in = int(x.m_proj_factor * cfg.d_model)
    return x, d_in, d_in // cfg.num_heads


# ------------------------------------------------------------------ mLSTM --

def mlstm_init(generator, cfg: ModelConfig, dtype=torch.bfloat16,
               device=None) -> dict:
    """The reference's leaves: the projections and ``conv_w``/``conv_b``
    in ``dtype``, ``w_if`` (d_inner, 2 heads) in fp32."""
    x, d_in, _ = _dims(cfg)
    return {
        "up_proj": dense_init(generator, cfg.d_model, 2 * d_in, dtype,
                              device=device),
        "conv_w": normal_init(generator, (x.conv_kernel, d_in),
                              x.conv_kernel ** -0.5, dtype, device),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=device),
        "wq": dense_init(generator, d_in, d_in, dtype, device=device),
        "wk": dense_init(generator, d_in, d_in, dtype, device=device),
        "wv": dense_init(generator, d_in, d_in, dtype, device=device),
        "w_if": dense_init(generator, d_in, 2 * cfg.num_heads, torch.float32,
                           device=device),
        "out_proj": dense_init(generator, d_in, cfg.d_model, dtype,
                               device=device),
    }


def init_mlstm_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    x, d_in, hd = _dims(cfg)
    f32, nh = torch.float32, cfg.num_heads
    return {
        "C": torch.zeros((batch, nh, hd, hd), dtype=f32, device=device),
        "n": torch.zeros((batch, nh, hd), dtype=f32, device=device),
        "m": torch.full((batch, nh), -1e30, dtype=f32, device=device),
        "conv": torch.zeros((batch, x.conv_kernel, d_in), dtype=f32,
                            device=device),
    }


def _causal(s: int, device) -> torch.Tensor:
    return torch.ones((s, s), dtype=torch.bool, device=device).tril()


def _mlstm_parallel(q, k, v, i_gate, f_gate):
    """Stabilised decayed-attention form.  q/k/v: (B, H, S, Dh) fp32;
    gates (B, H, S)."""
    s, hd = q.shape[2], q.shape[3]
    cum = torch.cumsum(F.logsigmoid(f_gate), dim=-1)
    # D[t, u] = sum_{j=u+1..t} logf_j + logi_u   (u <= t)
    dmat = cum[..., :, None] - cum[..., None, :] + i_gate[..., None, :]
    dmat = dmat.masked_fill(~_causal(s, q.device), float("-inf"))
    m = dmat.amax(dim=-1, keepdim=True)                      # (B, H, S, 1)
    scores = q @ k.transpose(-1, -2) * (hd ** -0.5) * torch.exp(dmat - m)
    norm = torch.maximum(scores.sum(-1, keepdim=True).abs(), torch.exp(-m))
    return (scores / norm) @ v


def _mlstm_chunkwise(q, k, v, i_gate, f_gate, chunk: int):
    """Chunk-recurrent mLSTM: S / chunk sequential chunks, parallel inside,
    carrying the stabilised matrix state (C, n, m) so that no (S, S) decay
    matrix is made.  q/k/v: (B, H, S, Dh) fp32; gates (B, H, S) fp32."""
    b, h, s, hd = q.shape
    scale = hd ** -0.5
    logf = F.logsigmoid(f_gate)
    causal = _causal(chunk, q.device)
    f32 = torch.float32
    c_st = torch.zeros((b, h, hd, hd), dtype=f32, device=q.device)
    n_st = torch.zeros((b, h, hd), dtype=f32, device=q.device)
    m_st = torch.full((b, h), -1e30, dtype=f32, device=q.device)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        qb, kb, vb, ib = q[:, :, sl], k[:, :, sl], v[:, :, sl], i_gate[..., sl]
        bcum = torch.cumsum(logf[..., sl], dim=-1)           # (B, H, L)
        btot = bcum[..., -1:]
        # intra-chunk decay matrix D[t, u] = bcum_t - bcum_u + i_u (u <= t)
        dmat = bcum[..., :, None] - bcum[..., None, :] + ib[..., None, :]
        dmat = dmat.masked_fill(~causal, float("-inf"))
        m_t = torch.maximum(bcum + m_st[..., None], dmat.amax(dim=-1))
        inter_w = torch.exp(bcum + m_st[..., None] - m_t)    # (B, H, L)
        sc = qb @ kb.transpose(-1, -2) * scale * torch.exp(dmat - m_t[..., None])
        num = sc @ vb + inter_w[..., None] * (qb @ c_st) * scale
        den_vec = (sc.sum(-1) + inter_w
                   * torch.einsum("bhld,bhd->bhl", qb, n_st) * scale)
        den = torch.maximum(den_vec.abs(), torch.exp(-m_t))[..., None]
        ys.append(num / den)
        # the state at the chunk's end
        m_new = torch.maximum(btot[..., 0] + m_st,
                              (btot - bcum + ib).amax(dim=-1))
        w_old = torch.exp(btot[..., 0] + m_st - m_new)       # (B, H)
        w_new = torch.exp(btot - bcum + ib - m_new[..., None])  # (B, H, L)
        c_st = (w_old[..., None, None] * c_st
                + (w_new[..., None] * kb).transpose(-1, -2) @ vb)
        n_st = w_old[..., None] * n_st + torch.einsum("bhu,bhud->bhd", w_new,
                                                      kb)
        m_st = m_new
    return torch.cat(ys, dim=2)


def mlstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                cache: dict | None = None, backend: str = "kernels"
                ) -> tuple[torch.Tensor, dict | None]:
    """x: (B, S, D) -> ((B, S, D), cache).  With ``cache`` (S must be 1)
    one fp32 decode step, the cache written in place and returned."""
    xcfg, d_in, hd = _dims(cfg)
    b, s, _ = x.shape
    nh = cfg.num_heads
    up = linear(x, p["up_proj"], backend)
    xr, z = up[..., :d_in], up[..., d_in:]
    if cache is None:
        xc = F.silu(_causal_conv(xr, p["conv_w"], p["conv_b"]))

        def heads(t):
            return t.reshape(b, s, nh, hd).transpose(1, 2).float()

        q = heads(linear(xc, p["wq"], backend))
        k = heads(linear(xc, p["wk"], backend))
        v = heads(linear(xr, p["wv"], backend))
        gates = linear(xc.float(), p["w_if"], backend)        # (B, S, 2H)
        i_g, f_g = gates.transpose(1, 2).split(nh, dim=1)     # (B, H, S)
        if s > M_CHUNK and s % M_CHUNK == 0:
            y = _mlstm_chunkwise(q, k, v, i_g, f_g, M_CHUNK)
        else:
            y = _mlstm_parallel(q, k, v, i_g, f_g)
        y = y.transpose(1, 2).reshape(b, s, d_in).to(x.dtype)
    else:
        if s != 1:
            raise ValueError(f"an mLSTM decode step takes one token, got {s}")
        conv = torch.cat([cache["conv"][:, 1:], xr.float()], dim=1)
        xc = F.silu((conv * p["conv_w"].float()).sum(1)
                    + p["conv_b"].float())
        q = linear(xc, p["wq"].float(), backend).view(b, nh, hd)
        k = linear(xc, p["wk"].float(), backend).view(b, nh, hd)
        v = linear(xr[:, 0].float(), p["wv"].float(), backend).view(b, nh, hd)
        gates = linear(xc, p["w_if"], backend)
        i_g, f_g = gates[:, :nh], gates[:, nh:]
        logf = F.logsigmoid(f_g)
        m_new = torch.maximum(logf + cache["m"], i_g)
        fi = torch.exp(logf + cache["m"] - m_new)[..., None, None]
        ii = torch.exp(i_g - m_new)[..., None, None]
        c_st = cache["C"].mul_(fi).add_(ii * (v[..., :, None]
                                              * k[..., None, :]))
        n_st = cache["n"].mul_(fi[..., 0]).add_(ii[..., 0] * k)
        num = torch.einsum("bhde,bhe->bhd", c_st, q) * (hd ** -0.5)
        den = torch.maximum((n_st * q).sum(-1).abs() * (hd ** -0.5),
                            torch.exp(-m_new))[..., None]
        y = (num / den).reshape(b, 1, d_in).to(x.dtype)
        cache["m"].copy_(m_new)
        cache["conv"].copy_(conv)
    y = y * F.silu(z)
    return linear(y, p["out_proj"], backend), cache


# ------------------------------------------------------------------ sLSTM --

def slstm_init(generator, cfg: ModelConfig, dtype=torch.bfloat16,
               device=None) -> dict:
    """The reference's leaves: the gate projections (D, 4D) (i, f, z, o),
    and the FFN of ``int(s_ff_factor * D)``."""
    d = cfg.d_model
    dff = int(cfg.xlstm.s_ff_factor * d)
    return {
        "w_gates": dense_init(generator, d, 4 * d, dtype, device=device),
        "r_gates": dense_init(generator, d, 4 * d, dtype, device=device),
        "ff_up": dense_init(generator, d, dff, dtype, device=device),
        "ff_down": dense_init(generator, dff, d, dtype, device=device),
    }


def init_slstm_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    shape, f32 = (batch, cfg.d_model), torch.float32
    return {"c": torch.zeros(shape, dtype=f32, device=device),
            "n": torch.zeros(shape, dtype=f32, device=device),
            "h": torch.zeros(shape, dtype=f32, device=device),
            "m": torch.full(shape, -1e30, dtype=f32, device=device)}


def _slstm_step(r_gates, state, xt, backend: str = "kernels"):
    """One recurrence step.  ``r_gates`` the fp32 recurrent weight (D,
    4D); ``xt`` (B, 4D) the pre-projected gates input; ``state`` (c, n, h,
    m).  Returns the new state."""
    c, n, h, m = state
    gates = xt + linear(h, r_gates, backend)
    i_, f_, z_, o_ = gates.chunk(4, dim=-1)
    m_new = torch.maximum(f_ + m, i_)                         # log-space stab
    i_s = torch.exp(i_ - m_new)
    f_s = torch.exp(f_ + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(z_)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(o_) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, h_new, m_new


def slstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                cache: dict | None = None, backend: str = "kernels"
                ) -> tuple[torch.Tensor, dict | None]:
    """x: (B, S, D) -> ((B, S, D), cache): S steps of the recurrence from
    a zero state, or with ``cache`` (S must be 1) one step from it, the
    cache written in place and returned."""
    b, s, d = x.shape
    xg = linear(x, p["w_gates"], backend).float()             # (B, S, 4D)
    r_gates = p["r_gates"].float()
    if cache is None:
        zero = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        state = (zero, zero, zero, torch.full_like(zero, -1e30))
        hs = []
        for t in range(s):
            state = _slstm_step(r_gates, state, xg[:, t], backend)
            hs.append(state[2])
        y = torch.stack(hs, dim=1).to(x.dtype)                # (B, S, D)
    else:
        if s != 1:
            raise ValueError(f"an sLSTM decode step takes one token, got {s}")
        state = _slstm_step(r_gates, tuple(cache[k] for k in "cnhm"),
                            xg[:, 0], backend)
        for key, t in zip("cnhm", state):
            cache[key].copy_(t)
        y = state[2][:, None, :].to(x.dtype)
    ff = F.gelu(linear(y, p["ff_up"], backend), approximate="tanh")
    return linear(ff, p["ff_down"], backend), cache
