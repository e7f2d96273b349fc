"""Manifest-driven atomic checkpoints of flat ``{name: array}`` dicts.

The port of ``repro.checkpoint.ckpt``'s layout and flat-dict transport.
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
reference's tree form (``restore_checkpoint``) and its multi-host shards
are not ported yet (ROADMAP.md).
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


def save_checkpoint(directory: str, step: int, arrays: dict, *,
                    keep: int = 3, background: bool = False,
                    extra: dict | None = None) -> CheckpointFuture | None:
    """Save a flat ``{name: array or tensor}`` dict as step ``step``.

    Leaves are written in sorted key order (the reference's flattening of
    a dict), and the manifest records that order so :func:`load_flat`
    needs no template.  ``extra`` (JSON-serialisable) rides in the
    manifest.  The newest ``keep`` committed steps survive.
    """
    if not isinstance(arrays, dict) or any(
            isinstance(v, (dict, list, tuple)) for v in arrays.values()):
        raise TypeError("save_checkpoint takes a flat {name: array} dict "
                        "(the tree form is not ported)")
    keys = sorted(arrays)
    leaves, dtypes = zip(*(_host_array(arrays[k]) for k in keys)) \
        if keys else ((), ())
    manifest = {
        "step": step,
        "treedef": "PyTreeDef({" + ", ".join(f"{k!r}: *" for k in keys)
                   + "})",
        "shapes": [list(a.shape) for a in leaves],
        "dtypes": list(dtypes),
        "process_count": 1,
        "flat_keys": keys,
    }
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


__all__ = ["as_tensor", "save_checkpoint", "all_steps", "latest_step",
           "load_flat", "load_extra", "CheckpointFuture"]
