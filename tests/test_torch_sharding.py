"""The port's sharding rules and mesh geometries against
``repro.distributed.sharding`` and ``repro.launch.{mesh,shapes}``.

The reference's rule functions read only ``mesh.shape``, so one geometry
object (the port's :class:`repro_torch.launch.mesh.Mesh`) serves both
packages without a device.  Every parameter of every config in
``repro_torch.configs`` (the port's meta-device init, its dotted names)
gets the spec the reference gives its ``/`` path (``jax.eval_shape`` of
its init), on the 16x16 and 2x16x16 production geometries; the
activation, image, phase and batch specs, ``pad_batch`` and the shape
cells' input specs agree too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed import sharding as js
from repro.launch import mesh as jmesh
from repro.launch import shapes as jshapes
from repro.models import encdec as jencdec
from repro.models import transformer as jtransformer
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as ts
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shapes as tshapes
from repro_torch.models import encdec, transformer

_GEOMETRIES = {"pod": tmesh.make_production_mesh(),
               "two_pods": tmesh.make_production_mesh(multi_pod=True)}


@functools.lru_cache(maxsize=None)
def _ref_paths(arch):
    cfg = jget_config(arch)
    init = jencdec.init_params if cfg.encoder_layers else \
        jtransformer.init_params
    tree = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {js._path_str(p): tuple(x.shape) for p, x in leaves}


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    cfg = get_config(arch)
    model = encdec if cfg.encoder_layers else transformer
    tree = model.init_params(None, cfg, device="meta")
    return transformer.flatten_params(tree)


def test_geometries_match_reference():
    for multi in (False, True):
        t = tmesh.make_production_mesh(multi_pod=multi)
        shape = (2, 16, 16) if multi else (16, 16)
        axes = ("pod", "data", "model") if multi else ("data", "model")
        assert tuple(t.shape.values()) == shape
        assert t.axis_names == axes and t.size == int(np.prod(shape))
    assert tmesh.make_smoke_mesh(8).shape == {"data": 4, "model": 2}
    assert tmesh.make_smoke_mesh(1).shape == {"data": 1, "model": 1}
    assert tmesh.make_train_mesh(4).shape == {"data": 4}
    assert tmesh.make_train_mesh().shape == {"data": 1}
    # the reference's factories over this host's one device
    assert dict(jmesh.make_train_mesh(1).shape) == \
        tmesh.make_train_mesh(1).shape
    assert dict(jmesh.make_smoke_mesh(1).shape) == \
        tmesh.make_smoke_mesh(1).shape


@pytest.mark.parametrize("geometry", sorted(_GEOMETRIES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspec_matches_reference(arch, geometry):
    mesh = _GEOMETRIES[geometry]
    want = _ref_paths(arch)
    params = _port_params(arch)
    assert {k.replace(".", "/") for k in params} == set(want)
    shardings = ts.make_param_shardings(mesh, params)
    for name, p in params.items():
        path = name.replace(".", "/")
        assert tuple(p.shape) == want[path], name
        spec = ts.param_pspec(mesh, name, tuple(p.shape))
        assert tuple(spec) == tuple(js.param_pspec(mesh, path,
                                                   want[path])), name
        assert shardings[name].spec == spec


_LOGICAL = [
    (("data", None, None), (256, 4096, 5120)),
    (("data", None), (1, 64)),
    (("data", "spatial", None, None), (32, 64, 64, 3)),
    (("data", "spatial", None, None), (4, 15, 15, 3)),
    (("model", "expert"), (64, 128)),
    (("data_kvseq", "kvseq", "model_kv", None), (1, 524288, 8, 256)),
    (("data_kvseq", "kvseq", "model_kv", None), (128, 32768, 8, 128)),
    (("fsdp", "model"), (2048, 8192)),
    (("seq", None), (1, 4096)),
    (("phase", None, None, None), (96, 1, 1, 1)),
    ((None, "bogus"), (4, 4)),
]


@pytest.mark.parametrize("geometry", sorted(_GEOMETRIES) + ["smoke8",
                                                            "train4"])
def test_activation_specs_match_reference(geometry):
    mesh = _GEOMETRIES.get(geometry) or (
        tmesh.make_smoke_mesh(8) if geometry == "smoke8"
        else tmesh.make_train_mesh(4))
    for logical, shape in _LOGICAL:
        assert tuple(ts.resolve_spec(mesh, logical, shape)) == \
            tuple(js.resolve_spec(mesh, logical, shape)), (logical, shape)
    assert ts.data_axes(mesh) == js.data_axes(mesh)
    assert ts.data_axis_size(mesh) == js.data_axis_size(mesh)
    # the reference's NamedSharding constructors need real devices; their
    # specs are these resolutions
    for shape in ((4, 16, 16, 3), (32, 64, 64, 3), (5, 13, 13, 3)):
        for spatial in (False, True):
            logical = ("data", "spatial" if spatial else None, None, None)
            assert tuple(ts.image_sharding(mesh, shape,
                                           spatial=spatial).spec) == \
                tuple(js.resolve_spec(mesh, logical, shape))
    for nph, b in ((4, 5), (16, 8), (9, 1), (1, 256)):
        assert tuple(ts.phase_sharding(mesh, nph, b).spec) == tuple(
            js.resolve_spec(mesh, ("phase", None, None, None),
                            (nph * b, 1, 1, 1)))
    axes = js.data_axes(mesh)
    for ndim in (1, 2, 3):
        assert tuple(ts.batch_sharding(mesh, ndim).spec) == tuple(
            [axes if len(axes) > 1 else axes[0]] + [None] * (ndim - 1))
    assert tuple(ts.replicated(mesh).spec) == ()


@pytest.mark.parametrize("b,multiple", [(5, 4), (8, 4), (1, 1), (3, 8)])
def test_pad_batch_matches_reference(b, multiple):
    x = np.random.default_rng(b).standard_normal((b, 3, 2)).astype(
        np.float32)
    got, n = ts.pad_batch(torch.from_numpy(x), multiple)
    want, m = js.pad_batch(jnp.asarray(x), multiple)
    assert n == m == b
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_use_mesh_sets_the_current_mesh():
    mesh = tmesh.make_train_mesh(1)
    assert ts.current_mesh() is None
    with ts.use_mesh(mesh) as m:
        assert m is mesh and ts.current_mesh() is mesh
    assert ts.current_mesh() is None


@pytest.mark.parametrize("shape", sorted(jshapes.SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_cells_match_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert tshapes.SHAPES[shape] == tshapes.ShapeCell(
        *(getattr(jshapes.SHAPES[shape], f) for f in
          ("name", "seq_len", "global_batch", "kind")))
    assert tshapes.cell_supported(cfg, shape) == \
        jshapes.cell_supported(jcfg, shape)
    got = tshapes.input_specs(cfg, shape)
    want = jshapes.input_specs(jcfg, shape)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).removeprefix("torch.") == \
            str(want[k].dtype), k


def test_backend_follows_the_devices():
    dev = torch.device
    assert tmesh.backend_for([dev("cpu")] * 4) == "gloo"
    assert tmesh.backend_for([dev("cuda", 0)]) == "gloo"
    assert tmesh.backend_for([dev("cuda", 0)] * 4) == "gloo"   # one card
    assert tmesh.backend_for([dev("cuda", 0), dev("cuda", 1)]) == "nccl"
    with pytest.raises(ValueError, match="at once"):
        tmesh.backend_for([dev("cpu"), dev("cuda", 0)])
    assert tmesh.rank_devices("cpu", 3) == [dev("cpu")] * 3
    with pytest.raises(ValueError, match="ranks"):
        tmesh.rank_devices(["cpu"], 2)


def test_a_failing_rank_makes_the_launcher_raise():
    from repro_torch.launch import data_axis

    with pytest.raises(Exception, match="KeyError"):
        tmesh.launch(data_axis.run, 2, device="cpu",
                     args=([("no such job", {})],))
