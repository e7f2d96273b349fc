"""Manifest-driven atomic checkpoints of parameter trees and flat dicts.

The port of ``repro.checkpoint.ckpt``'s layout, its tree form and its
flat-dict transport.
Layout per step::

    <dir>/step_000100/
        manifest.json            # key order, shapes, dtypes, extra payload
        host_000.npz             # the arrays
        COMMITTED                # written last -> crash-safe atomicity

The files are the reference's: a checkpoint written by either package is
read by the other's ``load_flat``.  Arrays are written as numpy arrays;
bf16 (a torch tensor, or an ``ml_dtypes`` array from the reference) is
stored as its ``uint16`` bits with the dtype ``"bfloat16"`` in the
manifest, as the reference stores it, and :func:`load_flat` gives it back
as a CPU ``torch.bfloat16`` tensor (numpy has no bf16).
``save_checkpoint(..., background=True)`` writes on a thread; the returned
:class:`CheckpointFuture`'s ``join()`` re-raises whatever the write hit.
Tensors are copied to the host before the call returns; only file IO is
deferred.  ``extra=`` attaches a JSON payload (the serving layer's
scheduler metadata, DESIGN.md §11).  One process writes ``host_000``; the
reference's multi-host shards are not ported (ROADMAP.md, multi-device):
on a mesh the train loop gathers every leaf whole onto rank 0, which
writes it (``ModelParallel.unshard``), and each rank restores its blocks
(``restore_checkpoint(..., shardings=)``), so a checkpoint moves between
meshes and one device.

A tree is nested dicts, lists, tuples and NamedTuples (an ``AdamWState``)
of tensors or arrays; its leaves are written in JAX's flattening order
(dict keys sorted, sequences in order, ``None`` an empty subtree), so
:func:`restore_checkpoint` reads the reference's tree checkpoints and the
reference reads the port's.  ``restore_checkpoint(directory, step,
abstract_tree)`` rebuilds the structure of ``abstract_tree`` (tensors,
meta tensors for shapes only) and raises when its leaf count or a leaf's
shape differs from the manifest's, as the reference does.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch


def _key(i: int) -> str:
    return f"leaf_{i:05d}"


def _host_array(value) -> tuple[np.ndarray, str]:
    """(npz-safe host array, manifest dtype string) of one leaf."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(value)
    if "bfloat16" in str(arr.dtype):
        return arr.view(np.uint16), "bfloat16"
    if arr.dtype.kind == "V":
        raise TypeError(f"cannot serialise dtype {arr.dtype}")
    return arr, str(arr.dtype)


def _from_serializable(arr: np.ndarray, dtype_str: str):
    if dtype_str == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    if "float8" in dtype_str:
        raise NotImplementedError(f"dtype {dtype_str} is not ported")
    return arr


def as_tensor(value) -> torch.Tensor:
    """One leaf (a numpy array, an ``ml_dtypes`` bf16 array or a tensor) as
    a CPU tensor of its dtype, bf16 carried through its ``uint16`` bits as
    a checkpoint carries it."""
    out = _from_serializable(*_host_array(value))
    return out if isinstance(out, torch.Tensor) else torch.from_numpy(
        np.array(out))


class CheckpointFuture:
    """Handle to a background checkpoint write; ``join()`` blocks until it
    ends and re-raises any exception it hit, so a failed write surfaces at
    the next sync point instead of leaving a step silently missing."""

    def __init__(self, target):
        self._exc: BaseException | None = None

        def _run():
            try:
                target()
            except BaseException as e:     # re-raised on join(), never lost
                self._exc = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout)
        if self._exc is not None:
            raise self._exc

    def is_alive(self) -> bool:
        return self._thread.is_alive()


def flatten_tree(tree) -> tuple[list, str]:
    """(leaves in JAX's flattening order, a description of the structure
    in the manner of JAX's ``PyTreeDef``) of a tree of dicts, lists,
    tuples and NamedTuples; ``None`` is an empty subtree."""
    if tree is None:
        return [], "None"
    if isinstance(tree, dict):
        parts, leaves = [], []
        for k in sorted(tree):
            sub, desc = flatten_tree(tree[k])
            leaves += sub
            parts.append(f"{k!r}: {desc}")
        return leaves, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        parts, leaves = [], []
        for v in tree:
            sub, desc = flatten_tree(v)
            leaves += sub
            parts.append(desc)
        if hasattr(tree, "_fields"):
            return leaves, f"{type(tree).__name__}(" + ", ".join(
                f"{f}={d}" for f, d in zip(tree._fields, parts)) + ")"
        inner = ", ".join(parts)
        return leaves, (f"[{inner}]" if isinstance(tree, list)
                        else f"({inner})")
    return [tree], "*"


def _unflatten(like, leaves):
    """The structure of ``like`` with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        items = [_unflatten(v, leaves) for v in like]
        if hasattr(like, "_fields"):
            return type(like)(*items)
        return items if isinstance(like, list) else tuple(items)
    return next(leaves)


def unflatten_tree(like, leaves: list):
    """The structure of ``like`` with the leaves of a list in
    :func:`flatten_tree`'s order."""
    return _unflatten(like, iter(leaves))


def _is_flat(tree) -> bool:
    return isinstance(tree, dict) and all(
        not isinstance(v, (dict, list, tuple)) and v is not None
        for v in tree.values())


def save_checkpoint(directory: str, step: int, tree, *, keep: int = 3,
                    background: bool = False,
                    extra: dict | None = None) -> CheckpointFuture | None:
    """Save a tree (or a flat ``{name: array or tensor}`` dict) of tensors
    and arrays as step ``step``.

    Leaves are written in JAX's flattening order.  For a flat dict (one
    leaf a key) the manifest also records the key order, so
    :func:`load_flat` needs no template.  ``extra`` (JSON-serialisable)
    rides in the manifest.  The newest ``keep`` committed steps survive.
    """
    flat = _is_flat(tree)
    leaves, treedef = flatten_tree(tree)
    leaves, dtypes = zip(*(_host_array(a) for a in leaves)) \
        if leaves else ((), ())
    manifest = {
        "step": step,
        "treedef": f"PyTreeDef({treedef})",
        "shapes": [list(a.shape) for a in leaves],
        "dtypes": list(dtypes),
        "process_count": 1,
    }
    if flat:
        # a nested dict holding one leaf a top-level key must not qualify:
        # its leaf order would not be the key list's
        manifest["flat_keys"] = sorted(tree)
    if extra is not None:
        manifest["extra"] = extra

    def _write():
        final = os.path.join(directory, f"step_{step:06d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "host_000.npz"),
                 **{_key(i): a for i, a in enumerate(leaves)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(directory, keep)

    if background:
        return CheckpointFuture(_write)
    _write()
    return None


def _gc(directory: str, keep: int):
    for s in all_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:06d}"),
                      ignore_errors=True)


def all_steps(directory: str) -> list[int]:
    """The committed steps under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "COMMITTED")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _read_manifest(directory: str, step: int) -> dict:
    path = os.path.join(directory, f"step_{step:06d}")
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def load_extra(directory: str, step: int) -> dict | None:
    """The manifest's ``extra`` payload (or None if the save had none)."""
    return _read_manifest(directory, step).get("extra")


def load_flat(directory: str, step: int) -> tuple[dict, dict | None]:
    """Load a checkpoint saved from a flat dict: ``(arrays, extra)``.

    Arrays come back as numpy arrays, bf16 ones as CPU ``torch.bfloat16``
    tensors.  A checkpoint of a nested tree (no ``flat_keys`` in its
    manifest) raises ``ValueError``.
    """
    manifest = _read_manifest(directory, step)
    keys = manifest.get("flat_keys")
    if keys is None:
        raise ValueError(
            f"checkpoint at step {step} was not saved from a flat dict "
            f"(no flat_keys in manifest)")
    path = os.path.join(directory, f"step_{step:06d}")
    with np.load(os.path.join(path, "host_000.npz")) as data:
        arrays = {k: _from_serializable(data[_key(i)],
                                        manifest["dtypes"][i])
                  for i, k in enumerate(keys)}
    return arrays, manifest.get("extra")


def restore_checkpoint(directory: str, step: int, abstract_tree,
                       device=None, shardings=None):
    """Restore step ``step`` into the structure of ``abstract_tree``.

    Each leaf of ``abstract_tree`` (a tensor, possibly on the meta device)
    gives the shape the stored leaf must have and the dtype it is cast to;
    the restored leaves are tensors on ``device`` (default the CPU).  A
    leaf count or a shape that differs from the manifest's raises
    ``ValueError``.  ``shardings`` (a tree of the same structure whose
    leaves have a ``shard(tensor)`` method, e.g.
    :class:`repro_torch.distributed.sharding.NamedSharding`) restores each
    leaf as this rank's block of it, read one leaf at a time: the
    reference's ``restore_checkpoint(..., shardings)``.
    """
    manifest = _read_manifest(directory, step)
    refs, _ = flatten_tree(abstract_tree)
    shards = (flatten_tree(shardings)[0] if shardings is not None
              else [None] * len(refs))
    if len(shards) != len(refs):
        raise ValueError(f"{len(shards)} shardings for {len(refs)} leaves")
    if len(refs) != len(manifest["shapes"]):
        raise ValueError(f"tree structure changed: the checkpoint at step "
                         f"{step} holds {len(manifest['shapes'])} leaves, "
                         f"the tree {len(refs)}")
    path = os.path.join(directory, f"step_{step:06d}")
    dev = torch.device("cpu" if device is None else device)
    restored = []
    with np.load(os.path.join(path, "host_000.npz")) as data:
        for i, ref in enumerate(refs):
            arr = _from_serializable(data[_key(i)], manifest["dtypes"][i])
            if not isinstance(arr, torch.Tensor):
                arr = torch.from_numpy(np.array(arr))
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: checkpoint shape "
                                 f"{tuple(arr.shape)} != model "
                                 f"{tuple(ref.shape)}")
            if shards[i] is not None:
                arr = shards[i].shard(arr)
                restored.append(torch.empty(
                    tuple(arr.shape), dtype=ref.dtype,
                    device=dev).copy_(arr))
            else:
                restored.append(arr.to(device=dev, dtype=ref.dtype))
    return _unflatten(abstract_tree, iter(restored))


__all__ = ["as_tensor", "flatten_tree", "unflatten_tree", "save_checkpoint",
           "restore_checkpoint", "all_steps", "latest_step", "load_flat",
           "load_extra", "CheckpointFuture"]
