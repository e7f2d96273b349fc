"""Diffusion U-Net decoder stack and denoiser in PyTorch.

The port of ``repro.models.unet_decoder``: the decoder half of a diffusion
U-Net.  Each level concatenates an encoder skip, runs two dense 3x3 convs
(folded GroupNorm + PReLU fused as their epilogue) and upsamples with a
stride-2 transposed conv whose kernel alternates ``k=4`` and ``k=2``
(``p_lo = k//2``, exact 2x; PReLU fused), then a 3x3 head.  With the
canonical widths (256, 128, 64) from an 8x8 mid-block the decoder launches
the dense conv kernel 7 times and the transposed one 3 times a forward; the
denoiser's four 1x1 encoders add 4 dense launches.

Functional, as the reference is: parameters are nested dicts of tensors
with the reference's keys (``l0_conv1``, ``l0_gn1.g``, ``dec.head``, ...).
:func:`init_params` and :func:`init_denoiser_params` draw them on the CPU
from an explicit ``torch.Generator`` and move them to ``device`` (``None``
-> CUDA).  ``compute_dtype="bf16"`` runs activations in bf16 off fp32
masters (DESIGN.md §12).

``rows=`` (a ``torch.distributed`` group, the model axis of the image:
``GenServer(spatial=True)``) runs :func:`forward` and :func:`denoise` on
this rank's band of rows: every conv through
``decompose.conv2d(rows=)``, which exchanges the halo rows its band reads
(the 3x3 convs 1 row a side, the 1x1 stem and encoders none, the k = 4
upsamplers 1); the average pools, the skip concatenations, the folded-GN
epilogues and the conditioning add are per row or band-local (a band is
a multiple of every pool factor).
"""

from __future__ import annotations

import torch

from repro_torch.core.decompose import conv2d
from repro_torch.core.gen_spec import UNET_UP_KERNELS, UNET_WIDTHS
from repro_torch.kernels.epilogue import EpilogueSpec
from repro_torch.kernels.util import canon_dtype
from repro_torch.models.common import (conv_init, fold_gn, gn_init,
                                       tconv_init, timestep_embedding,
                                       to_device)

#: timestep-embedding width of the denoiser
DENOISE_EMB_DIM = 64

_EP_GN_ACT = EpilogueSpec(bn=True, prelu=True)   # folded-GN affine + PReLU
_EP_ACT = EpilogueSpec(prelu=True)


def _draw_params(g: torch.Generator, widths, skip_chs, out_ch: int) -> dict:
    skip_chs = tuple(widths) if skip_chs is None else tuple(skip_chs)
    if len(skip_chs) != len(widths):
        raise ValueError(f"{len(skip_chs)} skip widths for {len(widths)} "
                         f"levels")
    p: dict = {}
    for i, (c, cs) in enumerate(zip(widths, skip_chs)):
        k = UNET_UP_KERNELS[i % len(UNET_UP_KERNELS)]
        c_next = widths[i + 1] if i + 1 < len(widths) else widths[-1] // 2
        p[f"l{i}_conv1"] = conv_init(g, 3, 3, c + cs, c)
        p[f"l{i}_gn1"] = gn_init(c)
        p[f"l{i}_a1"] = torch.full((1,), 0.2)
        p[f"l{i}_conv2"] = conv_init(g, 3, 3, c, c)
        p[f"l{i}_gn2"] = gn_init(c)
        p[f"l{i}_a2"] = torch.full((1,), 0.2)
        p[f"l{i}_up"] = tconv_init(g, k, k, c, c_next)
        p[f"l{i}_aup"] = torch.full((1,), 0.2)
    p["head"] = conv_init(g, 3, 3, widths[-1] // 2, out_ch)
    return p


def init_params(generator: torch.Generator,
                widths: tuple[int, ...] = UNET_WIDTHS,
                skip_chs: tuple[int, ...] | None = None, out_ch: int = 3,
                device=None) -> dict:
    """Decoder parameters; level ``i`` consumes a ``skip_chs[i]``-wide skip
    (default: its own width)."""
    return to_device(_draw_params(generator, widths, skip_chs, out_ch),
                     device)


def forward(params: dict, x: torch.Tensor, skips: tuple[torch.Tensor, ...],
            decomposed: bool = True, backend: str = "kernels",
            compute_dtype=None, rows=None) -> torch.Tensor:
    """x: (N, H, W, widths[0]) mid features; skips[i] at level i's extent
    (with ``rows``, this rank's bands of them).

    Per level: skip-concat -> 3x3 conv (folded GN + PReLU) -> 3x3 conv
    (same) -> even-k stride-2 transposed upsample (PReLU); then the 3x3
    head.  Returns (N, H * 2**levels, W * 2**levels, out_ch), in
    ``compute_dtype`` when it is given (mid features and skips cast once).
    """
    levels = sum(1 for k in params if k.endswith("_up"))
    if len(skips) != levels:
        raise ValueError(f"{len(skips)} skips for {levels} levels")
    cd = canon_dtype(compute_dtype)
    h = x
    if cd is not None:
        h = h.to(cd)
        skips = tuple(s.to(cd) for s in skips)
    for i in range(levels):
        k = UNET_UP_KERNELS[i % len(UNET_UP_KERNELS)]
        h = torch.cat([h, skips[i]], dim=-1)
        for j in (1, 2):
            sc, sh = fold_gn(params[f"l{i}_gn{j}"])
            h = conv2d(h, params[f"l{i}_conv{j}"], backend=backend,
                       epilogue=_EP_GN_ACT, scale=sc, shift=sh,
                       alpha=params[f"l{i}_a{j}"], compute_dtype=cd,
                       rows=rows)
        h = conv2d(h, params[f"l{i}_up"], stride=2, transposed=True,
                   padding=k // 2, output_padding=0, decomposed=decomposed,
                   backend=backend, epilogue=_EP_ACT,
                   alpha=params[f"l{i}_aup"], compute_dtype=cd, rows=rows)
    return conv2d(h, params["head"], backend=backend, compute_dtype=cd,
                  rows=rows)


# ---------------------------------------------------------------------------
# Denoiser: the eps-model a DDIM sampling loop iterates (DESIGN.md §9)
# ---------------------------------------------------------------------------

def _avg_pool(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Exact average pooling by an integer factor (NHWC), in fp32 and
    returned in ``x``'s dtype.  A window is summed by elementwise adds in
    one fixed order (its columns, then its rows), so an output's bits do
    not depend on how many outputs there are: a reduction kernel may split
    its sums by the output count, and a band of rows is fewer outputs."""
    if factor == 1:
        return x
    n, h, w, c = x.shape
    y = x.float().reshape(n, h // factor, factor, w // factor, factor, c)
    cols = y[..., 0, :]
    for j in range(1, factor):
        cols = cols + y[..., j, :]
    out = cols[:, :, 0]
    for i in range(1, factor):
        out = out + cols[:, :, i]
    return (out / (factor * factor)).to(x.dtype)


def init_denoiser_params(generator: torch.Generator,
                         widths: tuple[int, ...] = UNET_WIDTHS,
                         out_ch: int = 3, emb_dim: int = DENOISE_EMB_DIM,
                         device=None) -> dict:
    """Denoiser ``eps(x_t, t)`` around the decoder: 1x1 encoders of the
    average-pooled image onto the mid features and every skip extent, and a
    two-layer MLP of the timestep embedding added to the mid features."""
    g = generator
    p = {"dec": _draw_params(g, widths, None, out_ch),
         "stem": conv_init(g, 1, 1, out_ch, widths[0]),
         "t_w1": torch.randn((emb_dim, emb_dim), generator=g)
         * (2.0 / emb_dim) ** 0.5,
         "t_w2": torch.randn((emb_dim, widths[0]), generator=g)
         * (2.0 / emb_dim) ** 0.5}
    for i, c in enumerate(widths):
        p[f"enc{i}"] = conv_init(g, 1, 1, out_ch, c)
    return to_device(p, device)


def timestep_cond(params: dict, t: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """The timestep MLP: (N,) timesteps -> (N, C) conditioning in
    ``dtype`` (the fp32 MLP masters are cast to it: a bf16 @ fp32 product
    would promote the conditioning, and then the mid features, to fp32)."""
    emb = timestep_embedding(t, params["t_w1"].shape[0])
    return torch.matmul(
        torch.tanh(torch.matmul(emb.to(dtype), params["t_w1"].to(dtype))),
        params["t_w2"].to(dtype))


def denoise(params: dict, x_t: torch.Tensor, t: torch.Tensor,
            decomposed: bool = True, backend: str = "kernels",
            compute_dtype=None, cond: torch.Tensor | None = None,
            rows=None) -> torch.Tensor:
    """Predict the noise in ``x_t`` (N, S, S, C) at timesteps ``t`` (N,).

    ``S`` is ``hw * 2**levels`` for the decoder's mid extent ``hw``.
    ``cond``: :func:`timestep_cond` of ``t`` when the caller computed it.
    ``rows``: ``x_t`` is this rank's band of the image's rows, and so is
    the result (the module docstring).
    Returns (N, S, S, C), in ``compute_dtype`` when it is given.
    """
    levels = sum(1 for k in params if k.startswith("enc"))
    s = x_t.shape[2]
    hw = s >> levels
    cd = canon_dtype(compute_dtype)
    if cd is not None:
        x_t = x_t.to(cd)
    if cond is None:
        cond = timestep_cond(params, t, x_t.dtype)
    kw = dict(backend=backend, compute_dtype=cd, rows=rows)
    mid = conv2d(_avg_pool(x_t, s // hw), params["stem"], **kw)
    mid = mid + cond[:, None, None, :]
    skips = tuple(
        conv2d(_avg_pool(x_t, s // (hw * 2 ** i)), params[f"enc{i}"], **kw)
        for i in range(levels))
    return forward(params["dec"], mid, skips, decomposed=decomposed,
                   backend=backend, compute_dtype=cd, rows=rows)


__all__ = ["UNET_UP_KERNELS", "UNET_WIDTHS", "DENOISE_EMB_DIM",
           "init_params", "forward", "init_denoiser_params",
           "timestep_cond", "denoise"]
