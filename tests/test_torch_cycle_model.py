"""The port's cycle model and layer tables against the JAX reference.

``repro_torch.core.cycle_model`` is pure Python arithmetic on the paper's
168-MAC array, so every public function must equal
``repro.core.cycle_model``'s exactly (``==``, no tolerance) on every layer
of ENet-512, ESPNet-512, DCGAN-64/128 and the U-Net decoder: the per-layer
MAC and cycle counts, the adjoint layer and the weight-gradient cost, and
per table ``report``, ``headline``, ``serve_report`` (over a ``steps_list``,
``scan_steps``, a snapshot cadence and a calibration), ``serve_percentiles``
and ``training_report``.  The port's layer tables (``enet_spec``,
``espnet_spec``, ``gen_spec``, which now shares ``enet_spec.ConvLayer``)
equal the reference's field by field.
"""

import dataclasses

import pytest

from repro.core import calibrate as jcal
from repro.core import cycle_model as jcm
from repro.core import enet_spec as jenet
from repro.core import espnet_spec as jesp
from repro.core import gen_spec as jgen
from repro_torch.core import calibrate as tcal
from repro_torch.core import cycle_model as tcm
from repro_torch.core import enet_spec as tenet
from repro_torch.core import espnet_spec as tesp
from repro_torch.core import gen_spec as tgen

#: name -> (reference table, port table)
TABLES = {
    "enet19": (jenet.enet_512_layers(), tenet.enet_512_layers()),
    "enet5": (jenet.enet_512_layers(5), tenet.enet_512_layers(5)),
    "espnet": (jesp.espnet_512_layers(), tesp.espnet_512_layers()),
    "dcgan64": (jgen.dcgan_layers(64), tgen.dcgan_layers(64)),
    "dcgan128": (jgen.dcgan_layers(128), tgen.dcgan_layers(128)),
    "unet": (jgen.unet_decoder_layers(), tgen.unet_decoder_layers()),
    "unet_small": (jgen.unet_decoder_layers((8, 8), hw=4),
                   tgen.unet_decoder_layers((8, 8), hw=4)),
}
LAYERS = [(f"{name}:{i}:{ref.name}", ref, port)
          for name, (refs, ports) in TABLES.items()
          for i, (ref, port) in enumerate(zip(refs, ports))]
#: per-layer functions of both modules, compared by name
PER_LAYER = ("ideal_dense_macs", "ideal_sparse_macs", "cycles_ideal_dense",
             "cycles_ideal_sparse", "cycles_our_general",
             "cycles_our_decomposed", "efficiency_vs_sparse",
             "wgrad_contention", "cycles_wgrad")


def _fields(layer):
    return dataclasses.astuple(layer)


def _calibrations():
    """One affine fit per engine kind, as each package keys it (the
    reference's ``xla`` is the port's ``torch``), on this host's device
    kind (``cpu`` on both)."""
    coeffs = {"dense": (0.021, 7.5), "dilated": (0.034, 11.0),
              "tconv": (0.05, 9.25)}
    ref = jcal.Calibration({jcal.key_of(k, "xla"): jcal.Coeffs(a, b, 4)
                            for k, (a, b) in coeffs.items()})
    port = tcal.Calibration({tcal.key_of(k, "torch"): tcal.Coeffs(a, b, 4)
                             for k, (a, b) in coeffs.items()})
    return ref, port


@pytest.mark.parametrize("name", sorted(TABLES))
def test_tables_match_reference(name):
    refs, ports = TABLES[name]
    assert len(refs) == len(ports) > 0
    for r, p in zip(refs, ports):
        assert type(p) is tenet.ConvLayer
        assert _fields(p) == _fields(r)


def test_gen_spec_shares_enet_spec_conv_layer():
    assert tgen.ConvLayer is tenet.ConvLayer is tesp.ConvLayer
    assert [f.name for f in dataclasses.fields(tenet.ConvLayer)] == \
        [f.name for f in dataclasses.fields(jenet.ConvLayer)]
    assert set(tgen.GEN_WORKLOADS) == set(jgen.GEN_WORKLOADS)
    for key in tgen.GEN_WORKLOADS:
        assert [_fields(p) for p in tgen.GEN_WORKLOADS[key]()] == \
            [_fields(r) for r in jgen.GEN_WORKLOADS[key]()]
    assert (tgen.UNET_UP_KERNELS, tgen.UNET_WIDTHS) == \
        (jgen.UNET_UP_KERNELS, jgen.UNET_WIDTHS)
    assert tesp.ESP_DILATIONS == jesp.ESP_DILATIONS


def test_layer_sets_match_reference():
    refs, ports = TABLES["enet19"]
    for fn in ("dilated_layer_sets", "transposed_layer_sets"):
        r, p = getattr(jenet, fn)(refs), getattr(tenet, fn)(ports)
        assert {k: [_fields(l) for l in v] for k, v in p.items()} == \
            {k: [_fields(l) for l in v] for k, v in r.items()}


@pytest.mark.parametrize("label,ref,port", LAYERS,
                         ids=[label for label, _, _ in LAYERS])
def test_per_layer_equal(label, ref, port):
    for fn in PER_LAYER:
        assert getattr(tcm, fn)(port) == getattr(jcm, fn)(ref), fn
    assert _fields(tcm.adjoint_layer(port)) == _fields(jcm.adjoint_layer(ref))
    if ref.kind == "transposed":
        assert tcm.tconv_pads(port) == jcm.tconv_pads(ref)
        assert tcm.tconv_input_size(port) == jcm.tconv_input_size(ref)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_report_and_headline_equal(name):
    refs, ports = TABLES[name]
    assert tcm.report(ports) == jcm.report(refs)
    r_sum, p_sum = jcm.summarize(refs), tcm.summarize(ports)
    assert {k: dataclasses.astuple(v) for k, v in p_sum.items()} == \
        {k: dataclasses.astuple(v) for k, v in r_sum.items()}
    assert tcm.headline(ports) == jcm.headline(refs)
    assert tcm.training_report(ports) == jcm.training_report(refs)


@pytest.mark.parametrize("name", sorted(TABLES))
@pytest.mark.parametrize("scan", [1, 3, 4])
def test_serve_report_equal(name, scan):
    refs, ports = TABLES[name]
    jc, tc = _calibrations()
    steps_list = [50, 25, 10, 1, 7, 3, 50]
    kw = dict(steps=50, batch=8, scan_steps=scan, steps_list=steps_list,
              snapshot_every=2)
    assert tcm.serve_report(ports, backend="torch", **kw) == \
        jcm.serve_report(refs, backend="xla", **kw)
    got = tcm.serve_report(ports, calibration=tc, backend="torch", **kw)
    assert got == jcm.serve_report(refs, calibration=jc, backend="xla", **kw)
    assert "calibrated_us_per_image" in got
    assert got["serve_speedup_vs_naive"] == \
        tcm.report(ports)["speedup_vs_naive"]
    pkw = dict(batch=4, scan_steps=scan, devices=2)
    assert tcm.serve_percentiles(ports, steps_list, calibration=tc,
                                 backend="torch", **pkw) == \
        jcm.serve_percentiles(refs, steps_list, calibration=jc,
                              backend="xla", **pkw)


def test_empty_and_bad_arguments_match_reference():
    assert tcm.report([]) == jcm.report([])
    assert tcm.serve_report([], steps=3) == jcm.serve_report([], steps=3)
    assert tcm.training_report([]) == jcm.training_report([])
    for bad in (dict(steps=0), dict(batch=0), dict(scan_steps=0),
                dict(devices=0)):
        with pytest.raises(ValueError):
            tcm.serve_report(TABLES["unet"][1], **bad)
    with pytest.raises(ValueError):
        tcm.serve_percentiles(TABLES["unet"][1], [])


@pytest.mark.parametrize("vals", [[], [3.0], [1.0, 2.0, 3.0, 4.0],
                                  [9.5, 0.25, 7.0, 7.0, 1e6]])
@pytest.mark.parametrize("p", [0.0, 50.0, 99.0, 100.0])
def test_np_percentile_equal(vals, p):
    assert tcm.np_percentile(vals, p) == jcm.np_percentile(vals, p)


def test_constants_and_docstring():
    for c in ("MACS_PER_CYCLE", "FREQ_HZ", "N_ROWS", "N_BLOCKS",
              "PAPER_FIG10_MIX"):
        assert getattr(tcm, c) == getattr(jcm, c)
    assert "not the H100" in tcm.__doc__
