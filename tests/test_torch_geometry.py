"""The port's geometry, pattern helpers, data builders and state conversion
against the JAX reference: offset tables tuple for tuple, ``shiftnd`` and
the blocking helpers bit for bit, the images byte for byte."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import geometry as jgeo
from repro.core import pattern as jpat
from repro.data import images as jimg
from repro.morph.ops import MorphReconstructOp as JMorph
from repro_torch import convert
from repro_torch.core import geometry as tgeo
from repro_torch.core import pattern as tpat
from repro_torch.data import images as timg
from repro_torch.morph.ops import MorphReconstructOp as TMorph

CPU = torch.device("cpu")
NAMES = ["conn4", "conn8", "conn6", "conn18", "conn26"]


@pytest.mark.parametrize("name", NAMES)
def test_offset_tables_match_reference(name):
    ref, port = jgeo.NEIGHBORHOODS[name], tgeo.NEIGHBORHOODS[name]
    assert port.offsets == ref.offsets
    assert (port.name, port.ndim, port.n_offsets) == (ref.name, ref.ndim,
                                                      ref.n_offsets)
    assert tpat.offsets_for(name) == jpat.offsets_for(name)


@pytest.mark.parametrize("knob", [4, 8, "conn6", "conn26"])
def test_connectivity_names_match_reference(knob):
    assert tgeo.connectivity_name(knob) == jgeo.connectivity_name(knob)
    assert tgeo.neighborhood(knob).offsets == jgeo.neighborhood(knob).offsets


@pytest.mark.parametrize("bad", [True, 5, "conn7"])
def test_bad_connectivity_raises_like_reference(bad):
    with pytest.raises(ValueError):
        jgeo.connectivity_name(bad)
    with pytest.raises(ValueError):
        tgeo.connectivity_name(bad)


def test_moore_offsets_match_reference():
    for ndim in (2, 3):
        for k in range(1, ndim + 1):
            assert tgeo._moore_offsets(ndim, k) == jgeo._moore_offsets(ndim, k)


@pytest.mark.parametrize("shape,lead", [((7, 9), ()), ((5, 6, 4), ()),
                                        ((6, 5), (2,))])
@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.uint8, np.bool_])
def test_shiftnd_matches_reference(shape, lead, dtype):
    rng = np.random.default_rng(1)
    x = (rng.integers(0, 200, lead + shape).astype(dtype))
    fill = False if dtype == np.bool_ else 7
    for off in tgeo._moore_offsets(len(shape), len(shape)):
        ref = np.asarray(jpat.shiftnd(jnp.asarray(x), off, fill))
        port = tpat.shiftnd(torch.from_numpy(x), off, fill).numpy()
        np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("ndim,tile,shape", [(2, 4, (9, 13)), (2, 8, (16, 16)),
                                             (3, 3, (4, 7, 5))])
def test_geometry_blocking_matches_reference(ndim, tile, shape):
    jg, tg = jgeo.Geometry.of(ndim, tile), tgeo.Geometry.of(ndim, tile)
    assert tg.block == jg.block
    assert tg.geodesic_bound == jg.geodesic_bound
    assert tg.grid(shape) == jg.grid(shape)
    assert tg.padded_shape(shape) == jg.padded_shape(shape)
    rng = np.random.default_rng(2)
    state = {"J": rng.integers(-5, 50, shape).astype(np.int32),
             "valid": rng.random(shape) < 0.7}
    pads = {"J": np.iinfo(np.int32).min, "valid": False}
    ref = jg.pad_state({k: jnp.asarray(v) for k, v in state.items()}, pads)
    port = tg.pad_state(convert.state_from_numpy(state, "cpu"), pads)
    for k in state:
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]))
    back = tg.unpad_state(port, shape)
    for k in state:
        np.testing.assert_array_equal(back[k].numpy(), state[k])


def test_ravel_unravel_match_reference():
    shape = (3, 5, 7)
    flat = np.arange(np.prod(shape))
    ref = jgeo.unravel_index(jnp.asarray(flat), shape)
    port = tgeo.unravel_index(torch.from_numpy(flat), shape)
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    np.testing.assert_array_equal(tgeo.ravel_index(port, shape).numpy(), flat)


def test_restore_invalid_matches_reference():
    rng = np.random.default_rng(3)
    shape = (6, 8)
    orig = {"J": rng.integers(0, 9, shape).astype(np.int32),
            "I": rng.integers(0, 9, shape).astype(np.int32),
            "valid": rng.random(shape) < 0.5}
    out = {"J": rng.integers(0, 9, shape).astype(np.int32),
           "I": orig["I"], "valid": orig["valid"]}
    ref = jpat.restore_invalid(JMorph(), {k: jnp.asarray(v) for k, v in
                                          orig.items()},
                               {k: jnp.asarray(v) for k, v in out.items()})
    port = tpat.restore_invalid(TMorph(), convert.state_from_numpy(orig, CPU),
                                convert.state_from_numpy(out, CPU))
    for k in orig:
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("h,w,coverage,seed", [(40, 52, 0.75, 0),
                                               (33, 17, 1.0, 5),
                                               (64, 64, 0.5, 9)])
def test_images_byte_identical(h, w, coverage, seed):
    for a, b in zip(jimg.tissue_image(h, w, coverage, seed),
                    timg.tissue_image(h, w, coverage, seed)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    _, mask = jimg.tissue_image(h, w, coverage, seed)
    a = jimg.seeded_marker(mask, n_seeds=5, seed=seed)
    b = timg.seeded_marker(mask, n_seeds=5, seed=seed)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.uint8, np.int16])
def test_state_from_numpy_round_trips(dtype):
    rng = np.random.default_rng(4)
    shape = (5, 7)
    state = {"J": rng.integers(0, 100, shape).astype(dtype),
             "I": rng.integers(0, 100, shape).astype(dtype),
             "valid": rng.random(shape) < 0.6}
    port = convert.state_from_numpy(state, "cpu")
    for k, v in port.items():
        assert v.device == CPU
        assert v.numpy().dtype == state[k].dtype
    back = convert.state_to_numpy(port)
    for k in state:
        assert back[k].dtype == state[k].dtype
        np.testing.assert_array_equal(back[k], state[k])
    # the reference's own state converts the same way
    jstate = JMorph().make_state(jnp.asarray(state["J"]),
                                 jnp.asarray(state["I"]),
                                 jnp.asarray(state["valid"]))
    port = convert.state_from_numpy({k: np.asarray(v) for k, v in
                                     jstate.items()}, "cpu")
    tstate = TMorph().make_state(torch.from_numpy(state["J"]),
                                 torch.from_numpy(state["I"]),
                                 torch.from_numpy(state["valid"]))
    for k in state:
        assert torch.equal(port[k], tstate[k])
