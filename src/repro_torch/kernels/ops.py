"""Public kernel entry points, with shape checks (port of
``repro.kernels.ops``).

The same five functions as the reference, with the same checks and
``ValueError`` messages, and the same ``*_ref`` oracle aliases.  There is no
``interpret=`` argument: the tensors' device decides.  CUDA tensors go
through the hand-written kernels (``csrc/*.cu``); CPU tensors through their
plain PyTorch versions.  The conv functions take the epilogue keywords of
the kernel wrappers (``epilogue=``, ``scale=``, ``shift=``, ``alpha=``,
``residual=``).
"""

from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.conv2d import conv2d as _conv2d
from repro_torch.kernels.dilated_conv import dilated_conv2d as _dilated
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.matmul import matmul as _matmul
from repro_torch.kernels.transposed_conv import transposed_conv2d as _tconv


def conv2d(x, w, *, stride=1, padding="SAME", **epilogue_kw):
    """Dense conv: rectangular kernels and fused epilogues supported."""
    if x.dim() != 4 or w.dim() != 4 or x.shape[-1] != w.shape[2]:
        raise ValueError(f"bad conv shapes {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")
    return _conv2d(x, w, stride=stride, padding=padding, **epilogue_kw)


def dilated_conv2d(x, w, dilation, *, stride=1, **epilogue_kw):
    if w.shape[0] != w.shape[1]:
        raise ValueError("square kernels only")
    return _dilated(x, w, dilation, stride=stride, **epilogue_kw)


def transposed_conv2d(x, w, *, stride=2, padding=None, output_padding=1,
                      **epilogue_kw):
    """Fused decomposed transposed conv: any square (k, stride)."""
    if x.dim() != 4 or w.dim() != 4 or x.shape[-1] != w.shape[2]:
        raise ValueError(f"bad conv shapes {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")
    if w.shape[0] != w.shape[1]:
        raise ValueError("square kernels only")
    return _tconv(x, w, stride=stride, padding=padding,
                  output_padding=output_padding, **epilogue_kw)


def matmul(a, b):
    if a.shape[-1] != b.shape[0]:
        raise ValueError(f"bad matmul shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    return _matmul(a, b)


def attention(q, k, v, *, causal=True):
    if q.shape[-1] != k.shape[-1] or k.shape[:2] != v.shape[:2]:
        raise ValueError("bad attention shapes")
    return _flash(q, k, v, causal=causal)


# oracle aliases so callers can switch implementations uniformly
conv2d_ref = ref.conv2d_ref
dilated_conv2d_ref = ref.dilated_conv2d_ref
transposed_conv2d_ref = ref.transposed_conv2d_ref
matmul_ref = ref.matmul_ref
attention_ref = ref.attention_ref
