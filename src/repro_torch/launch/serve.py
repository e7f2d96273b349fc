"""Batched LM serving: parallel prefill and greedy decode with KV caches.

The port of ``repro.launch.serve``.  :class:`Server` holds parameters and
serves fixed-size decode batches through one
:func:`repro_torch.launch.steps.make_serve_step`, whose caches are written
in place.  Prefill runs the whole prompt through that same step in ONE call
(the KV cache takes all ``S`` prompt entries at once and attention masks
causally within the chunk); ``slow=True`` / ``--slow-prefill`` keeps the
token-by-token loop, which gives a dense model the same caches and next
token.  A MoE model (Qwen3-MoE, Llama-4-Scout) prefills in one call too,
as the reference's; its two paths differ, because its capacity groups do
(:meth:`Server.prefill`).

An encoder-decoder (whisper-small) is served as the reference's tests
drive it: the prompt's ``frames`` are encoded once, the caches come from
``encdec.init_caches``, the prompt takes the token loop
(:func:`parallel_prefill_ok` is false, as in the reference) and every
serve step's batch carries ``enc_out``.  The reference's ``Server`` builds
batches of ``token`` and ``cache_pos`` only, which its enc-dec serve step
cannot read (ROADMAP.md §3).

Under ``backend="kernels"`` (the default) every product runs the port's
matmul kernel and every attention its flash-attention kernel: a StableLM
serve step launches 24 x 7 + 1 matmuls and 24 attentions, prefill or
decode; a whisper-small encode 12 x 7 and 12, and each of its serve steps
12 x 11 + 1 and 24 (self and cross attention).  ``backend="torch"`` runs
``torch.matmul`` and ``F.scaled_dot_product_attention``, the library
yardstick.  Parameters come from a seeded ``torch.Generator`` (on the
server's device by default, seed 0) or from ``params=`` (e.g. the model's
``load_jax_params``).

``mesh=`` (a :class:`repro_torch.launch.mesh.LiveMesh` of ``(data,
model)``, the reference's smoke mesh) serves over ranks, as the
reference's ``Server`` places its parameters by ``make_param_shardings``:
each rank keeps only its block of every parameter (FSDP over ``data``,
heads, FFN and vocab over ``model``:
:class:`repro_torch.distributed.sharding.ModelParallel`), the batch
splits over the data axes where it divides, each rank's caches hold its
rows and its KV heads, and every rank returns the whole batch's tokens.
Kernels 3 and 4 run on each rank's blocks.  A dense decoder-only config
(``attn``, ``attn_local`` mixers) takes a model extent above 1; a MoE,
recurrent or encoder-decoder one raises there.  ``--devices N`` spawns N
ranks on ``make_smoke_mesh(N)``.

A sliding-window config (Gemma-3-12B) prefills through the token loop, as
the reference's: its local layers' caches are rings of ``window`` slots
that take one token a step (:mod:`repro_torch.models.attention`).  Its
cache-free prefill, ``make_prefill_step``, is where kernel 4 takes the
window.

A recurrent config (xLSTM-1.3B; Jamba's Mamba layers) prefills through the
token loop too, as the reference's: its caches are fixed-size states
(:mod:`repro_torch.models.mamba`, :mod:`repro_torch.models.xlstm`) that take
one token a step.  An xLSTM-1.3B serve step launches kernel 3 24 x 6 + 24
x 4 + 1 times, 168 of them on ``"simt"`` (the mLSTM's fp32 decode products
and gates, the sLSTM's recurrent product and its 2730-wide FFN).

Under ``backend="kernels"`` a MoE layer launches kernel 3's batched form
for its experts' three products (``models/moe.py``): a Qwen3-MoE serve
step launches 48 x (4 + 1) + 1 two-dimensional matmuls (the router's on
``"simt"``), 48 x 3 batched ones and 48 attentions.

On the card (StableLM-2-1.6B, whisper-small, Gemma-3-12B,
Qwen3-MoE-30B-A3B and xLSTM-1.3B at their published configurations,
bf16)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
      --batch 4 --prompt-len 1024 --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \\
      --batch 8 --prompt-len 4 --gen-len 224
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \\
      --batch 4 --prompt-len 16 --gen-len 16
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch qwen3-moe-30b-a3b --batch 4 --prompt-len 16 --gen-len 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \\
      --batch 4 --prompt-len 32 --gen-len 32

Over ranks (gloo; on the CPU, or all sharing one card)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
      --reduced --device cpu --devices 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
      --devices 4 --batch 4 --prompt-len 1024 --gen-len 16

On the CPU (the kernels' plain versions)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
      --reduced --device cpu --batch 4 --prompt-len 16 --gen-len 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \\
      --reduced --device cpu --batch 2 --prompt-len 4 --gen-len 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \\
      --reduced --device cpu --batch 2 --prompt-len 8 --gen-len 40
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch qwen3-moe-30b-a3b --reduced --device cpu --batch 4 \\
      --prompt-len 16 --gen-len 16
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.util import resolve_device
from repro_torch.launch.steps import _model_fns, make_serve_step
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import check_backend


def parallel_prefill_ok(cfg) -> bool:
    """Whether one multi-token serve_step call can prefill ``cfg``.

    Attention KV caches take a whole prompt chunk in one write with a
    causal-within-chunk mask; recurrent-state mixers (mamba/xlstm) and
    sliding-window ring buffers update one token at a time, so those
    configs keep the sequential fallback.
    """
    return (not cfg.encoder_layers and cfg.window == 0
            and all(k == "attn" for k in cfg.block_pattern))


class Server:
    """Holds params; serves decode batches of the prompts' batch size.

    ``device``: ``None`` -> CUDA (raises without a card), ``"cpu"`` on
    request (with a ``mesh``, the mesh's device unless given).
    ``generator`` draws the parameters when ``params`` is not given.
    ``mesh``: serve over a live ``(data, model)`` mesh (the module
    docstring); ``params`` (or the draw) is the whole tree, of which each
    rank keeps its blocks."""

    def __init__(self, cfg, *, max_len: int = 256,
                 slow_prefill: bool = False, device=None,
                 backend: str = "kernels",
                 generator: torch.Generator | None = None,
                 params: dict | None = None, mesh=None):
        self.mod = _model_fns(cfg)
        check_backend(backend)
        self.cfg = cfg
        self.backend = backend
        self.mesh = mesh
        self.device = resolve_device(
            device if device is not None or mesh is None else mesh.device)
        self.max_len = max_len
        self.slow_prefill = slow_prefill
        self.tp = None
        if mesh is not None:
            if cfg.encoder_layers:
                raise NotImplementedError(
                    f"{cfg.name}: an encoder-decoder over a mesh: "
                    f"{shd.MODEL_AXIS_ITEM}")
            like = transformer.flatten_params(
                transformer.init_params(None, cfg, device="meta"))
            self.tp = shd.ModelParallel(mesh, cfg, {
                k: tuple(v.shape) for k, v in like.items()})
        if params is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            params = self.mod.init_params(generator, cfg, self.device)
        if self.tp is not None:
            flat = self.tp.place(transformer.flatten_params(params))
            del params
            params = transformer.unflatten_params(
                flat, transformer.init_params(None, cfg, device="meta"))
        self.params = params
        self.serve_step = make_serve_step(cfg, backend, tp=self.tp)

    def parallel_prefill_ok(self) -> bool:
        """See the module-level :func:`parallel_prefill_ok`."""
        return parallel_prefill_ok(self.cfg)

    @torch.no_grad()
    def encode(self, frames) -> torch.Tensor:
        """An encoder-decoder's encoder output (B, T, D) of ``frames`` (B,
        T, D), a tensor or an array, on the server's device."""
        if not self.cfg.encoder_layers:
            raise ValueError(f"{self.cfg.name} is decoder-only: it takes no "
                             f"frames")
        frames = torch.as_tensor(frames, device=self.device)
        return encdec.encode(self.params, frames, self.cfg, self.backend)

    def _extra(self, frames, enc_out) -> dict:
        """The serve steps' extra batch entries: ``enc_out`` for an
        encoder-decoder (from ``frames`` unless given), none otherwise."""
        if not self.cfg.encoder_layers:
            if frames is not None or enc_out is not None:
                raise ValueError(f"{self.cfg.name} is decoder-only: it "
                                 f"takes no frames")
            return {}
        if enc_out is None:
            if frames is None:
                raise ValueError(f"{self.cfg.name} is an encoder-decoder: "
                                 f"pass frames")
            enc_out = self.encode(frames)
        return {"enc_out": enc_out}

    @torch.no_grad()
    def prefill(self, tokens, *, frames=None, enc_out=None,
                slow: bool | None = None):
        """Warm the cache with the prompt; returns (next_token, caches, pos).

        Default: ONE serve_step call over the whole (B, S) prompt, the
        parallel prefill forward.  ``slow=True`` (or ``slow_prefill``, or a
        config the parallel path cannot serve) runs the token-by-token
        decode loop instead.  For a dense model both paths produce the same
        caches and next token; for a MoE model they need not, as in the
        reference: one (B, S) call and S (B, 1) calls form other capacity
        groups (at B = 4, S = 16 one group of 64 tokens with 5 slots an
        expert against 16 calls of one group of 4 with 1 slot), so
        other tokens are dropped.  An encoder-decoder needs ``frames``
        (encoded once here) or their :meth:`encode` output ``enc_out``,
        which its later serve steps take too; a decoder-only config
        refuses both.
        """
        extra = self._extra(frames, enc_out)
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int32
                                 ).to(self.device)
        b, s = tokens.shape
        if slow is None:
            slow = self.slow_prefill or not self.parallel_prefill_ok()
        elif not slow and not self.parallel_prefill_ok():
            raise ValueError(
                f"{self.cfg.name}: parallel prefill unsupported "
                "(recurrent mixers / sliding window / encoder-decoder); "
                "use slow=True")
        if self.tp is not None:
            rows = self.tp.batch_rows(b)
            tokens = tokens[rows]
            caches = transformer.init_caches(
                self.cfg, tokens.shape[0], self.max_len, self.device,
                kv_heads=self.tp.kv_heads())
        else:
            caches = self.mod.init_caches(self.cfg, b, self.max_len,
                                          self.device)
        if not slow:
            tok, caches = self.serve_step(
                self.params, caches,
                {"token": tokens, "cache_pos": 0, **extra})
            return tok, caches, s
        tok = None
        for t in range(s):
            tok, caches = self.serve_step(
                self.params, caches,
                {"token": tokens[:, t:t + 1], "cache_pos": t, **extra})
        return tok, caches, s

    @torch.no_grad()
    def generate(self, tokens, gen_len: int, *, frames=None) -> np.ndarray:
        """Prefill, then greedy decode: (B, gen_len) int32 token ids.  An
        encoder-decoder needs the prompts' ``frames`` (B, T, D).  Over a
        mesh every rank returns the whole batch's tokens."""
        extra = self._extra(frames, None)
        tok, caches, pos = self.prefill(tokens, **extra)
        out = [tok]
        for t in range(pos, pos + gen_len - 1):
            tok, caches = self.serve_step(
                self.params, caches, {"token": tok, "cache_pos": t, **extra})
            out.append(tok)
        out = torch.cat(out, dim=1)
        if self.tp is not None:
            out = self.tp.gather_batch(out, np.shape(tokens)[0])
        return out.cpu().numpy()

    def param_bytes(self) -> tuple[int, int]:
        """(bytes of the parameters this rank holds, bytes of the whole
        tree)."""
        flat = transformer.flatten_params(self.params)
        held = sum(t.numel() * t.element_size() for t in flat.values())
        if self.tp is None:
            return held, held
        like = transformer.flatten_params(transformer.init_params(
            None, self.cfg, device="meta"))
        return held, sum(t.numel() * t.element_size() for t in like.values())


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--slow-prefill", action="store_true",
                    help="prefill token-by-token through the decode step "
                         "instead of one parallel forward")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--backend", default="kernels",
                    choices=("kernels", "torch"))
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the prompts")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks to spawn (gloo; all on --device's card or "
                         "on the CPU): the server spans a (data, model) "
                         "mesh of them, each rank holding its parameter "
                         "blocks")
    return ap


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if args.devices > 1:
        from repro_torch.launch.mesh import launch
        launch(_serve_rank, args.devices, device=args.device, args=(argv,))
        return
    _serve(args)


def _serve_rank(device, argv) -> None:
    """One rank of ``--devices N``: the server over a (data, model) mesh of
    the ranks, reported by rank 0."""
    from repro_torch.launch.mesh import live_mesh, make_smoke_mesh

    mesh = live_mesh(make_smoke_mesh(), device)
    shd.make_groups(mesh)
    _serve(_parser().parse_args(argv), mesh)


def _serve(args, mesh=None) -> None:
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    device = resolve_device(args.device if mesh is None else mesh.device)
    server = Server(cfg, max_len=args.prompt_len + args.gen_len + 1,
                    slow_prefill=args.slow_prefill, device=device,
                    backend=args.backend, mesh=mesh,
                    generator=torch.Generator(device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    frames = (rng.standard_normal((args.batch, cfg.encoder_ctx,
                                   cfg.d_model), dtype=np.float32)
              if cfg.encoder_layers else None)
    t0 = time.perf_counter()
    out = server.generate(prompts, args.gen_len, frames=frames)
    dt = time.perf_counter() - t0
    if mesh is not None and mesh.rank:
        return
    where = "" if mesh is None else (
        f", mesh {tuple(mesh.shape.values())} (data, model), "
        f"{server.param_bytes()[0] / 2 ** 20:.1f} of "
        f"{server.param_bytes()[1] / 2 ** 20:.1f} MiB of parameters a rank")
    print(f"[serve] {cfg.name} on {device} ({args.backend}{where}): "
          f"generated {out.shape} tokens in {dt:.2f}s "
          f"({out.size / dt:.1f} tok/s incl. prefill)")
    print(out[:, :8])


if __name__ == "__main__":
    main()
