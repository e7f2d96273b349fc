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
* masked scores take the finite ``NEG_INF = -1e30``, so no row is NaN;
* the softmax denominator is summed from the fp32 probabilities and the
  output is ``acc / max(l, 1e-30)`` cast to ``q.dtype``.

Any Sq and Sk >= 1 and any head dim up to 256 are taken, with no padded
copies of q, k or v (the reference's wrapper pads them to whole tiles).
Under the causal mask the kv tiles wholly above the diagonal are skipped;
they would add exactly 0.  Two variants; :func:`attention_variant` picks
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
raises.  ``flash_attention.launches`` counts kernel launches and
``flash_attention.launches_by_variant`` splits them by variant.
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


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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
    for t in (q, k, v):
        dtype_code(t, "flash_attention")
    check_device("flash_attention", q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """(B, H, Sq, dh) x (B, H, Sk, dh) x (B, H, Sk, dh) -> (B, H, Sq, dh)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal)


flash_attention.launches = 0
flash_attention.launches_by_variant = {"wgmma": 0, "simt": 0}

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
                    causal: bool = True) -> torch.Tensor:
    """Plain version with the kernel's semantics: fp32 einsums, scale on
    the fp32 scores, top-left causal mask and the finite -1e30, softmax
    denominator floored at 1e-30, cast to ``q.dtype``."""
    sq, sk, dh = q.shape[2], k.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * dh ** -0.5
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return (o / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def _flash_fn():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib, fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on PyTorch's current stream.

    q, k and v must be contiguous CUDA tensors of one dtype; mixed dtypes
    are upcast to fp32 first (the kernel computes in fp32 anyway) and the
    output is cast to ``q.dtype``.
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
        return flash_attention_cuda(qf, kf, vf, causal).to(q.dtype)
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    out = torch.empty_like(q)
    if b * h == 0 or sq == 0:
        return out
    variant = attention_variant(q, k, v)
    lib, fn = _flash_fn()
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b * h, sq, sk, dh, dh ** -0.5, int(causal),
                  dtype_code(q, "flash_attention_cuda"), VARIANTS[variant],
                  torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, f"flash_attention ({variant})",
                lib.flash_attention_error_string)
    flash_attention.launches += 1
    flash_attention.launches_by_variant[variant] += 1
    return out


__all__ = ["flash_attention", "attention_plain", "flash_attention_cuda",
           "attention_variant", "NEG_INF", "MAX_HEAD_DIM", "VARIANTS",
           "WGMMA_HEAD_DIMS"]
