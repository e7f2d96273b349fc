"""Shared building blocks of the port's language models (functional, dict
params), the port of ``repro.models.layers``.

Every module is an ``init(generator, ...) -> params`` / ``apply(params, x,
...)`` pair on plain dicts of tensors, named as in the reference.  The
initialisers draw from an explicit ``torch.Generator`` on the generator's
own device (a CPU generator gives the same weights on every device; a CUDA
one draws a 1.6B-parameter model in milliseconds) and put the result on
``device``; ``device="meta"`` gives shapes and dtypes only.

Every product goes through :func:`linear`: ``backend="kernels"`` calls the
port's matmul kernel (``kernels/matmul.py``; its plain version for CPU
tensors), ``backend="torch"`` calls ``torch.matmul``, the library
yardstick.  Under autograd (grad mode on and an operand that requires
grad) the kernels backend goes through ``kernels.matmul.MatmulFn``, whose
backward is kernel 3 again; otherwise (serving, ``torch.no_grad()``) it
calls the kernel's wrapper directly.  The MoE FFN's expert products,
(E, R, D) buffers against stacked (E, D, F) weights, are not 2-D: they go
to kernel 3's batched form (``kernels.matmul.matmul_batched``, one launch
for all experts; ``torch.bmm`` under ``"torch"``) in
:mod:`repro_torch.models.moe`, under autograd through
``kernels.matmul.BatchedMatmulFn``.  The
reference's sharding hook ``lc`` has no counterpart: the port places
nothing by constraint.  Over the model axis (tensor parallelism,
:class:`repro_torch.distributed.sharding.ModelParallel`) a row-split
product's partial sums are reduced by the caller's ``reduce`` (:func:`mlp`
takes one).

The two cross-entropy functions of training close the module:
:func:`softmax_cross_entropy` on full logits and :func:`chunked_softmax_ce`,
which never materialises the (B, S, V) logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import matmul as kmm

BACKENDS = ("kernels", "torch")


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of "
                         f"{BACKENDS}")


def normal_init(generator: torch.Generator | None, shape, scale: float,
                dtype: torch.dtype, device=None) -> torch.Tensor:
    """``(N(0, 1) * scale).to(dtype)`` of ``shape``, drawn in fp32 on the
    generator's device and put on ``device`` (default: the generator's).
    On the meta device nothing is drawn and ``generator`` may be None."""
    device = torch.device(device) if device is not None else generator.device
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (t * scale).to(device=device, dtype=dtype)


def dense_init(generator, d_in: int, d_out: int, dtype=torch.bfloat16,
               scale: float | None = None, device=None) -> torch.Tensor:
    scale = (d_in ** -0.5) if scale is None else scale
    return normal_init(generator, (d_in, d_out), scale, dtype, device)


def rmsnorm_init(d: int, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """Normalise in fp32, cast to ``x.dtype``, then scale by ``g``.

    The fp32 ``x * rsqrt(mean(x^2) + eps)`` is ``F.rms_norm``: on the card
    one block reduces a row in the same order whatever the row count,
    where ``torch.mean``'s reduction changes order with it (a row's sum in
    a 4096-row prefill and in a 4-row decode call can differ in the last
    bit).  So a token's activations do not depend on how many tokens share
    the call, and the parallel prefill is the token loop bit for bit."""
    xf = x.float()
    return F.rms_norm(xf, (xf.shape[-1],), eps=eps).to(x.dtype) * g


def layernorm_init(d: int, dtype=torch.bfloat16, device=None) -> dict:
    return {"g": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise in fp32, cast to ``x.dtype``, then ``* g + b``.

    The fp32 ``(x - mean) * rsqrt(var + eps)`` is ``F.layer_norm``, for
    :func:`rmsnorm`'s reason: a row is reduced in the same order whatever
    the row count, where ``torch.mean``/``torch.var`` change order with it."""
    xf = x.float()
    return (F.layer_norm(xf, (xf.shape[-1],), eps=eps).to(x.dtype) * p["g"]
            + p["b"])


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, Dh); positions: (..., S).

    The angles are fp32; a bf16 ``x``'s halves are promoted to fp32 by the
    products with cos and sin, and the result is cast back once."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]                   # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, backend: str = "kernels"
           ) -> torch.Tensor:
    """``x @ w`` for ``x`` (..., K) and ``w`` (K, N), in ``x.dtype``.

    The leading axes are flattened to one M axis, the kernel's (M, K)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if backend == "kernels":
        if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
            y = kmm.MatmulFn.apply(x2, w)
        else:
            y = kmm.matmul(x2, w)
    else:
        check_backend(backend)
        y = torch.matmul(x2, w)
    return y.reshape(*lead, w.shape[1])


# ------------------------------------------------------------------ MLP ---

def mlp_init(generator, d: int, d_ff: int, dtype=torch.bfloat16,
             device=None) -> dict:
    return {
        "w_gate": dense_init(generator, d, d_ff, dtype, device=device),
        "w_up": dense_init(generator, d, d_ff, dtype, device=device),
        "w_down": dense_init(generator, d_ff, d, dtype, device=device),
    }


def mlp(p: dict, x: torch.Tensor, backend: str = "kernels",
        reduce=None) -> torch.Tensor:
    """SwiGLU feed-forward: ``silu(x @ w_gate) * (x @ w_up) @ w_down``.
    ``reduce`` sums ``w_down``'s partial products where this rank holds a
    column block of ``w_gate``/``w_up`` and the row block of ``w_down``
    (tensor parallelism)."""
    h = F.silu(linear(x, p["w_gate"], backend)) * linear(x, p["w_up"],
                                                         backend)
    out = linear(h, p["w_down"], backend)
    return out if reduce is None else reduce(out)


# -------------------------------------------------------- cross entropy ---

def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean cross entropy in fp32; with ``mask``, the mean over the
    masked-in tokens (at least one)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def ce_chunks(s: int, chunk: int = 512) -> int:
    """The number of head products :func:`chunked_softmax_ce` makes for a
    sequence of ``s`` tokens: ``s // chunk`` checkpointed chunks, or 1 (the
    full logits, not checkpointed) when ``s <= chunk`` or ``s`` is not a
    multiple of ``chunk``, the reference's rule."""
    return 1 if s % chunk != 0 or s <= chunk else s // chunk


def chunked_softmax_ce(hidden: torch.Tensor, head: torch.Tensor,
                       labels: torch.Tensor, mask: torch.Tensor,
                       chunk: int = 512, backend: str = "kernels", tp=None
                       ) -> torch.Tensor:
    """Cross entropy without ever materialising the full (B, S, V) logits.

    The sequence is cut into chunks of ``chunk`` tokens, taken in order;
    each chunk's head product (:func:`linear`, kernel 3) and fp32 logits
    are recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant, in place of the reference's ``jax.checkpoint``), so one
    chunk's logits are live at a time.  As in the reference, a sequence of
    at most ``chunk`` tokens, or not a multiple of it, takes the full
    logits.

    ``tp`` (a :class:`repro_torch.distributed.sharding.ModelParallel`):
    this rank's rows of the batch and, where the vocab is split, ``head``
    is this rank's vocab columns; see :func:`_vocab_parallel_ce`."""
    if tp is not None:
        return _vocab_parallel_ce(hidden, head, labels, mask, chunk, backend,
                                  tp)
    s = hidden.shape[1]
    if ce_chunks(s, chunk) == 1:
        return softmax_cross_entropy(linear(hidden, head, backend), labels,
                                     mask)

    def body(h, lab, m):
        logits = linear(h, head, backend).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab.long()[..., None])[..., 0]
        return torch.sum((logz - gold) * m)

    nll = msum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        m = mask[:, c0:c0 + chunk]
        nll = nll + checkpoint(body, hidden[:, c0:c0 + chunk],
                               labels[:, c0:c0 + chunk], m,
                               use_reentrant=False, preserve_rng_state=False)
        msum = msum + torch.sum(m)
    return nll / torch.clamp(msum, min=1.0)


def _vocab_parallel_ce(hidden, head, labels, mask, chunk, backend, tp):
    """:func:`chunked_softmax_ce` on one rank of a ``(data, model)`` mesh.

    ``hidden`` (this data rank's rows, whole on every model rank) enters
    the head through ``tp.head_input`` (backward: the sum of every model
    rank's partial gradient).  Each chunk's fp32 logits are this rank's
    vocab columns only; the softmax's three reductions run over ``model``
    on per-row vectors, never on the logits: the row max (exact in any
    order), the sum of exponentials and the gold logit, taken from the
    rank that owns the label (zeros elsewhere), both by the fixed-order
    ``sum_partials``.  The chunk rule (:func:`ce_chunks`) and the
    per-chunk checkpoint are the unsharded function's.  The normaliser is
    the microbatch's mask sum over every data rank (``tp.data_sum``), so
    each data rank returns its rows' share of the microbatch's loss: the
    shares add up, over ``data``, to the unsharded loss."""
    from repro_torch.distributed.collectives import sum_partials

    hidden = tp.head_input(hidden)
    first = tp.vocab_columns(head.shape[-1])

    def body(h, lab, m):
        logits = linear(h, head, backend).float()
        if first is None:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, lab.long()[..., None])[..., 0]
            return torch.sum((logz - gold) * m)
        n = logits.shape[-1]
        top = tp.model_max(torch.amax(logits.detach(), dim=-1))
        total = sum_partials(torch.sum(torch.exp(logits - top[..., None]),
                                       dim=-1), tp.model)
        logz = torch.log(total) + top
        idx = lab.long() - first
        hit = (idx >= 0) & (idx < n)
        got = torch.gather(logits, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
        gold = sum_partials(torch.where(hit, got, torch.zeros_like(got)),
                            tp.model)
        return torch.sum((logz - gold) * m)

    s = hidden.shape[1]
    msum = tp.data_sum(torch.sum(mask.float()))
    if ce_chunks(s, chunk) == 1:
        return body(hidden, labels, mask) / torch.clamp(msum, min=1.0)
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        nll = nll + checkpoint(body, hidden[:, c0:c0 + chunk],
                               labels[:, c0:c0 + chunk],
                               mask[:, c0:c0 + chunk],
                               use_reentrant=False, preserve_rng_state=False)
    return nll / torch.clamp(msum, min=1.0)
