"""Flash attention (forward): the CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::
_flash_kernel`` (launched by ``flash_attention``, ``pallas_call`` at
``flash_attention.py:82``).  The kernel (``csrc/flash_attention.cu``) runs
one block per (batch*head, q tile) and loops over the kv tiles with an fp32
online softmax in registers.  It keeps the reference kernel's semantics,
which differ from ``ref.attention_ref``:

* q, k and v are upcast to fp32 before both products, and the scale
  ``dh ** -0.5`` multiplies the fp32 scores;
* the causal mask is top-left, ``q_pos >= k_pos`` (``ref.attention_ref``
  masks bottom-right, which differs when Sq != Sk);
* a causal call may take a ``window`` w > 0, the band of the reference
  model's sliding-window layers (``_chunked_causal(window=)`` of
  ``src/repro/models/attention.py``): a key is then masked also when
  ``q_pos - k_pos >= w``, so each row sees its last w keys.  The reference
  kernel has no band; the band is the reference model's mask on the kernel
  that carries that model's causal mask;
* masked scores take the finite ``NEG_INF = -1e30``, so no row is NaN;
* the softmax denominator is summed from the fp32 probabilities and the
  output is ``acc / max(l, 1e-30)`` cast to ``q.dtype``.

Any Sq and Sk >= 1 and any head dim up to 256 are taken, with no padded
copies of q, k or v (the reference's wrapper pads them to whole tiles).
Under the causal mask the kv tiles wholly above the diagonal are skipped,
and under a band those wholly below the first row's window too; they would
add exactly 0.  Two variants; :func:`attention_variant` picks
one from dtypes, head dim and alignment alone:

* ``"wgmma"``, for bf16 q, k and v with dh 64 or 128 and 16-byte aligned
  bases: Hopper's tensor cores.  128 query rows a block (two consumer
  warpgroups), 128-key K and V tiles by TMA through a 2-stage ring,
  ``wgmma`` for S = QK^T (exact products, fp32 sums) and for O += PV with
  P in registers.  The fp32 P is split into two bf16 terms, ``P_hi =
  bf16(P)`` and ``P_lo = bf16(P - P_hi)``, and both products go into the
  fp32 O: rounding P once to bf16 misses the bf16 bar on the causal
  4096-token call (the early rows sum few terms and cancel), which
  ``tests/test_torch_wgmma.py`` shows on an emulation of the kernel's
  arithmetic.  Bound on the H100: the softmax's exps and bf16 splits,
  beside the tensor cores' 989 TFLOP/s.
* ``"simt"``, for everything else (fp32, mixed types, other head dims):
  fp32 FMAs on the CUDA cores, 64 x 64 tiles staged in shared memory.
  Bound: the two products' FMAs at 67 TFLOP/s (4 x unmasked pairs x dh
  flops); its scalar shared-memory reads hold it well under that.

This is a dispatch by shape, not a fallback: a failed launch raises.
PERF.md has its times at StableLM-2-1.6B's widths.

:func:`flash_attention` takes its plain version, :func:`attention_plain`,
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.  ``flash_attention.launches`` counts kernel launches,
``flash_attention.launches_by_variant`` splits them by variant and
``flash_attention.launches_windowed`` counts those with a band.

:class:`FlashAttentionFn` makes it differentiable (LM training): the
forward is the kernel, and the backward differentiates the reference
model's own training attention.  The reference has no backward of its
Pallas kernel (``flash_attention.py:67`` has no ``custom_vjp``); its LM
trains through plain ``jnp`` attention (``src/repro/models/attention.py:
63-103``: fp32 scores times ``dh ** -0.5``, masked scores set to a finite
negative, a softmax, the fp32 product with v, query chunks of
``Q_CHUNK`` rows).  :func:`attention_grads` recomputes that one query
chunk at a time and takes its gradients by autograd's own steps: it is the
model's attention, like a product the JAX package leaves to XLA outside
any Pallas kernel, not a plain version of kernel 4 standing in for it.  A hand-written backward
kernel is a later lever (ROADMAP.md).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.util import check_device, dtype_code

#: the reference kernel's finite mask value
NEG_INF = -1e30
#: the largest head dim the kernel takes (Gemma-3's 256)
MAX_HEAD_DIM = 256


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q, k and v must be (B, H, S, dh), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or k.shape[:2] != v.shape[:2]:
        raise ValueError(f"flash_attention: q, k and v need the same batch "
                         f"and head count (no GQA), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[2] != v.shape[2]:
        raise ValueError(f"flash_attention: k and v lengths differ, "
                         f"{k.shape[2]} and {v.shape[2]}")
    dh = q.shape[3]
    if k.shape[3] != dh or v.shape[3] != dh:
        raise ValueError(f"flash_attention: head dims differ, "
                         f"{q.shape[3]}, {k.shape[3]}, {v.shape[3]}")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {dh} outside "
                         f"1..{MAX_HEAD_DIM}")
    if k.shape[2] == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    check_window(q.shape[2], k.shape[2], causal, window)
    for t in (q, k, v):
        dtype_code(t, "flash_attention")
    check_device("flash_attention", q, k, v)


def check_window(sq: int, sk: int, causal: bool, window: int) -> None:
    """Refuse a band the kernel does not take: ``window`` must be 0 (none)
    or positive with ``causal`` and Sq <= Sk (under the top-left mask a row
    past Sk + window - 1 would keep no key)."""
    if window < 0 or (window and not causal) or (window and sq > sk):
        raise ValueError(f"flash_attention: window {window} needs 0, or a "
                         f"causal call with Sq <= Sk (got causal={causal}, "
                         f"Sq {sq}, Sk {sk})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B, H, Sq, dh) x (B, H, Sk, dh) x (B, H, Sk, dh) -> (B, H, Sq, dh);
    ``window`` > 0 (with ``causal``) keeps each row's last ``window``
    keys."""
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal, window)


flash_attention.launches = 0
flash_attention.launches_by_variant = {"wgmma": 0, "simt": 0}
flash_attention.launches_windowed = 0

#: the kernel variants, by their C code (``csrc/flash_attention.cu``)
VARIANTS = {"simt": 0, "wgmma": 1}
#: the head dims the ``"wgmma"`` variant takes
WGMMA_HEAD_DIMS = (64, 128)


def attention_variant(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> str:
    """The variant :func:`flash_attention_cuda` launches: ``"wgmma"`` for
    bf16 q, k and v with a head dim in ``WGMMA_HEAD_DIMS`` and 16-byte
    aligned bases, else ``"simt"``.  Reads dtypes, shapes and data pointers
    only; launches nothing."""
    ts = (q, k, v)
    if (all(t.dtype == torch.bfloat16 for t in ts)
            and q.shape[-1] in WGMMA_HEAD_DIMS
            and all(t.data_ptr() % 16 == 0 for t in ts)):
        return "wgmma"
    return "simt"


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version with the kernel's semantics: fp32 einsums, scale on
    the fp32 scores, top-left causal mask (and with ``window`` > 0 the band
    ``q_pos - k_pos >= window``) and the finite -1e30, softmax denominator
    floored at 1e-30, cast to ``q.dtype``."""
    sq, sk, dh = q.shape[2], k.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * dh ** -0.5
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        hide = q_pos < k_pos
        if window:
            hide |= q_pos - k_pos >= window
        s = s.masked_fill(hide, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return (o / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def _flash_fn():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib, fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: int = 0) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on PyTorch's current stream.

    q, k and v must be contiguous CUDA tensors of one dtype; mixed dtypes
    are upcast to fp32 first (the kernel computes in fp32 anyway) and the
    output is cast to ``q.dtype``.  ``window`` as :func:`flash_attention`.
    """
    ts = (q, k, v)
    if any(t.device.type != "cuda" or t.device != q.device for t in ts):
        raise ValueError(f"flash_attention_cuda: q, k and v must be CUDA "
                         f"tensors on one device, got "
                         f"{[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention_cuda: q, k and v must be "
                         "contiguous")
    if len({t.dtype for t in ts}) > 1:
        qf, kf, vf = (t.float() for t in ts)
        return flash_attention_cuda(qf, kf, vf, causal, window).to(q.dtype)
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    check_window(sq, sk, causal, window)
    out = torch.empty_like(q)
    if b * h == 0 or sq == 0:
        return out
    variant = attention_variant(q, k, v)
    lib, fn = _flash_fn()
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b * h, sq, sk, dh, dh ** -0.5, int(causal), int(window),
                  dtype_code(q, "flash_attention_cuda"), VARIANTS[variant],
                  torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, f"flash_attention ({variant})",
                lib.flash_attention_error_string)
    flash_attention.launches += 1
    flash_attention.launches_by_variant[variant] += 1
    flash_attention.launches_windowed += bool(window)
    return out


#: query rows a chunk of the training attention (the reference's Q_CHUNK)
Q_CHUNK = 512


class FlashAttentionFn(torch.autograd.Function):
    """Attention under autograd: kernel 4 forward (saving q, k and v),
    :func:`attention_grads` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window=0):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        return (*attention_grads(*ctx.saved_tensors, g, causal=ctx.causal,
                                 window=ctx.window), None, None)


def attention_grads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor, *, causal: bool = True,
                    window: int = 0):
    """(dq, dk, dv) of the reference's training attention at cotangent
    ``g``, each in its operand's dtype.

    The query axis is cut into chunks of ``Q_CHUNK`` rows when S > Q_CHUNK
    and S % Q_CHUNK == 0 (else one chunk), as ``_chunked_causal`` cuts it.
    Each chunk's probabilities are recomputed as the reference computes
    them (fp32 scores times ``dh ** -0.5``, masked scores ``NEG_INF``, a
    softmax), so one chunk's (B, H, rows, Sk) scores are live at a time,
    as under the reference's per-chunk ``jax.checkpoint``.  The chunk is
    then differentiated by hand, by the steps autograd takes through that
    forward: the cotangent of the fp32 output is ``g`` upcast; dv += P^T
    g; dP = g V^T; dS = softmax's backward (``torch._softmax_backward_
    data``, autograd's own); dq = scale dS K and dk += scale dS^T Q.  The
    forward's product with v is not needed.  The scale rides on the
    products (``baddbmm``'s ``alpha``) and is not a pass of its own; the
    mask is filled only where it falls, in the chunk's diagonal block, and
    its cotangent needs no pass: a masked probability is exactly 0, so is
    its dS.  Under the causal mask a chunk reads only the keys its last row
    sees, and under a ``window`` only those from its first row's first key
    on, ``[max(0, r0 - window + 1), min(r0 + rows, Sk))``; the band's lower
    edge is then masked too.  The reference's chunk masks all Sk keys; the
    ones skipped here would take probability exactly 0 and add exactly 0
    to every sum.  The cotangents of k and v are summed over the chunks in
    fp32 and cast once."""
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    check_window(sq, sk, causal, window)
    scale = dh ** -0.5
    tq = Q_CHUNK if sq % Q_CHUNK == 0 and sq > Q_CHUNK else sq
    dq = torch.empty_like(q)
    dk = torch.zeros((b * h, sk, dh), dtype=torch.float32, device=k.device)
    dv = torch.zeros((b * h, sk, dh), dtype=torch.float32, device=v.device)
    kf = k.float().reshape(b * h, sk, dh)
    vf = v.float().reshape(b * h, sk, dh)
    for r0 in range(0, sq, tq):
        keys = min(r0 + tq, sk) if causal else sk
        lo = max(0, r0 - window + 1) if window else 0
        rows = min(tq, sq - r0)
        qc = q[:, :, r0:r0 + rows].float().reshape(b * h, rows, dh)
        gc = g[:, :, r0:r0 + rows].float().reshape(b * h, rows, dh)
        kc, vc = kf[:, lo:keys], vf[:, lo:keys]
        s = torch.baddbmm(qc.new_empty(()), qc, kc.transpose(1, 2), beta=0,
                          alpha=scale)
        row = torch.arange(r0, r0 + rows, device=q.device)[:, None]
        if window:
            cols = torch.arange(lo, keys, device=q.device)
            s.masked_fill_((row < cols) | (row - cols >= window), NEG_INF)
        elif causal and keys > r0:
            cols = torch.arange(r0, keys, device=q.device)
            s[:, :, r0:].masked_fill_(row < cols, NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        dv[:, lo:keys].baddbmm_(p.transpose(1, 2), gc)
        ds = torch._softmax_backward_data(
            torch.bmm(gc, vc.transpose(1, 2)), p, -1, torch.float32)
        del p
        dq[:, :, r0:r0 + rows] = torch.baddbmm(
            qc.new_empty(()), ds, kc, beta=0, alpha=scale).view(
                b, h, rows, dh)
        dk[:, lo:keys].baddbmm_(ds.transpose(1, 2), qc, alpha=scale)
        del ds
    return (dq, dk.view(k.shape).to(k.dtype),
            dv.view(v.shape).to(v.dtype))


__all__ = ["flash_attention", "attention_plain", "flash_attention_cuda",
           "attention_variant", "FlashAttentionFn", "attention_grads",
           "check_window",
           "NEG_INF", "MAX_HEAD_DIM", "Q_CHUNK", "VARIANTS",
           "WGMMA_HEAD_DIMS"]
