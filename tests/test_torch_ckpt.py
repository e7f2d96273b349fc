"""The port's flat-dict checkpoints against ``repro.checkpoint`` (the tree
form is tested in ``tests/test_torch_lm_train.py``).

``repro_torch.checkpoint`` writes the reference's manifest+COMMITTED
layout: a round trip keeps every array (bf16 as bf16), ``keep=`` bounds the
committed steps, a step without its COMMITTED marker is ignored, a
background write's failure re-raises on ``join()``, and a checkpoint that
either package writes is read by the other's ``load_flat``.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro_torch import checkpoint as tckpt

_EXTRA = {"tick": 3, "lanes": {"unet_dec": {"pos": [1, 2]}}, "est": None}


def _arrays():
    rng = np.random.default_rng(0)
    return {"b": rng.standard_normal((2, 3)).astype(np.float32),
            "a": np.arange(5, dtype=np.int64),
            "lane:x": torch.from_numpy(rng.standard_normal((2, 4, 4, 3))
                                       .astype(np.float32)).bfloat16(),
            "done:00000001": rng.standard_normal((4, 4, 3)).astype(
                np.float32)}


def _as_f32(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(v).astype(np.float32)


def test_roundtrip_keeps_arrays_dtypes_and_extra(tmp_path):
    d = str(tmp_path)
    arrays = _arrays()
    tckpt.save_checkpoint(d, 7, arrays, extra=_EXTRA)
    assert tckpt.all_steps(d) == [7] and tckpt.latest_step(d) == 7
    got, extra = tckpt.load_flat(d, 7)
    assert extra == _EXTRA == tckpt.load_extra(d, 7)
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        if isinstance(v, torch.Tensor):
            assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], v)
        else:
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v)
    with open(os.path.join(d, "step_000007", "manifest.json")) as f:
        man = json.load(f)
    assert man["flat_keys"] == sorted(arrays)
    assert man["dtypes"][man["flat_keys"].index("lane:x")] == "bfloat16"


def test_gc_keeps_the_newest(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3, 4, 5):
        tckpt.save_checkpoint(d, step, {"x": np.full(2, step)}, keep=2)
    assert tckpt.all_steps(d) == [4, 5]
    assert sorted(os.listdir(d)) == ["step_000004", "step_000005"]
    np.testing.assert_array_equal(tckpt.load_flat(d, 5)[0]["x"], [5, 5])


def test_uncommitted_checkpoints_are_ignored(tmp_path):
    d = str(tmp_path)
    tckpt.save_checkpoint(d, 1, {"x": np.zeros(2)})
    tckpt.save_checkpoint(d, 2, {"x": np.ones(2)})
    os.remove(os.path.join(d, "step_000002", "COMMITTED"))
    os.makedirs(os.path.join(d, "step_000009.tmp"))      # a crashed write
    assert tckpt.all_steps(d) == [1] and tckpt.latest_step(d) == 1
    assert tckpt.all_steps(str(tmp_path / "missing")) == []
    assert tckpt.latest_step(str(tmp_path / "missing")) is None


def test_background_write_and_its_failure(tmp_path):
    d = str(tmp_path / "bg")
    fut = tckpt.save_checkpoint(d, 3, {"x": np.arange(4)}, background=True)
    fut.join()
    assert not fut.is_alive() and tckpt.latest_step(d) == 3
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    fut = tckpt.save_checkpoint(str(blocker), 1, {"x": np.zeros(1)},
                                background=True)
    with pytest.raises(OSError):
        fut.join()


def test_rejects_trees_and_unflat_checkpoints(tmp_path):
    """``load_flat`` refuses a tree checkpoint, the port's (a nested dict
    is written in the tree form, with no key list) and the reference's."""
    d = str(tmp_path / "port")
    tckpt.save_checkpoint(d, 1, {"a": {"b": np.zeros(1)}})
    assert "flat_keys" not in json.load(open(os.path.join(
        d, "step_000001", "manifest.json")))
    with pytest.raises(ValueError, match="flat"):
        tckpt.load_flat(d, 1)
    d = str(tmp_path / "tree")
    jckpt.save_checkpoint(d, 1, {"a": {"b": np.zeros(1)}})
    with pytest.raises(ValueError, match="flat"):
        tckpt.load_flat(d, 1)


def test_reference_reads_the_port(tmp_path):
    d = str(tmp_path)
    arrays = _arrays()
    tckpt.save_checkpoint(d, 4, arrays, extra=_EXTRA)
    assert jckpt.latest_step(d) == 4
    got, extra = jckpt.load_flat(d, 4)
    assert extra == _EXTRA and sorted(got) == sorted(arrays)
    assert got["lane:x"].dtype == ml_dtypes.bfloat16
    for k, v in arrays.items():
        np.testing.assert_array_equal(_as_f32(got[k]), _as_f32(v))


def test_port_reads_the_reference(tmp_path):
    d = str(tmp_path)
    rng = np.random.default_rng(1)
    arrays = {"x": rng.standard_normal((3, 2)).astype(np.float32),
              "h": rng.standard_normal(6).astype(ml_dtypes.bfloat16),
              "n": np.arange(3, dtype=np.int32)}
    jckpt.save_checkpoint(d, 2, arrays, keep=1, extra=_EXTRA)
    assert tckpt.all_steps(d) == [2]
    got, extra = tckpt.load_flat(d, 2)
    assert extra == _EXTRA and tckpt.load_extra(d, 2) == _EXTRA
    assert got["h"].dtype == torch.bfloat16 and got["n"].dtype == np.int32
    for k, v in arrays.items():
        np.testing.assert_array_equal(_as_f32(got[k]), _as_f32(v))
    # and the reference writes the same manifest the port writes
    tckpt.save_checkpoint(str(tmp_path / "t"), 2, arrays, extra=_EXTRA)
    man = [json.load(open(os.path.join(p, "step_000002", "manifest.json")))
           for p in (d, str(tmp_path / "t"))]
    assert man[0] == man[1]
