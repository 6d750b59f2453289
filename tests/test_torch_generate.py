"""Port parity of the forward model on the CPU, float64: the interpolators'
``generate`` (fast, accurate, EEPs given, ``all_As``, ``return_dict``),
``generate_device``, ``generate_binary``, ``isochrone``, ``model_value`` and
``model_mag``, and their remaining public names (``model_grid``, ``bc_grid``,
``prop_map``, ``column_map``, ``mag[band]``, ``initialize``) against the JAX
package on the grid of ``tests/test_models.py``; ``generate_plain`` against
the port's composed functions; the CUDA wrapper's refusals on the CPU and
its packed copy of the model table.

Tolerances: EEPs to 1e-10 absolute; every other column to rtol 1e-10 of the
value plus 1e-10 times the larger of 1 and the column's largest magnitude
(the same lerps, summed in another order; a zero can come out as 1e-17);
NaN patterns identical, with one stated exception, the FMA knife edge (``ROADMAP.md``, "EEP inversion"): XLA on the CPU contracts the
fast inversion's blend ``(1 - d) * e + d * e`` into a fused multiply-add and
lands one unit in the last place below an integer EEP where eager torch gives
the integer. At a track's last valid EEP the integer reads the NaN-padded
neighbour (``0 * NaN``) and the port's row is NaN where the JAX row is
finite. :func:`knife_edge_rows` counts such rows and asserts that each one is
of that kind.
"""

import dataclasses

import numpy as np
import pytest
import torch

from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_torch import get_ichrone
from isochrones_torch.ops.generate import generate_forward, generate_plain, get_eep_fast
from isochrones_torch.ops.generate_cuda import (
    MAX_BANDS, MAX_PROPS, generate_cuda, get_eep_cuda, pack_layout, packed_model,
)
from isochrones_torch.ops.interp import interp_nd
from isochrones_torch.summary import Frame

DIMS = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)
RTOL = 1e-10
N_POINTS = 2000


@pytest.fixture(scope="module")
def ics():
    torch.set_num_threads(1)
    return jax_get_ichrone("synthetic", **DIMS), get_ichrone("synthetic", device="cpu", **DIMS)


def queries(track, n=N_POINTS, seed=0):
    """(mass, age, feh, distance, AV) spread past the grid on every side:
    every exact mass and [Fe/H] knot (the top ones together), ages past the
    ends of the tracks and before their starts, NaN in each coordinate,
    masses and [Fe/H] out of bounds."""
    rng = np.random.default_rng(seed)
    masses, fehs = track.masses, track.fehs
    mass = np.exp(rng.uniform(np.log(0.08), np.log(11.0), n))
    age = rng.uniform(7.0, 10.4, n)
    feh = rng.uniform(-2.2, 0.7, n)
    mass[: len(masses)] = masses
    feh[len(masses): len(masses) + len(fehs)] = fehs
    mass[100], feh[100] = masses[-1], fehs[-1]
    age[101:110] = 10.55
    age[110:120] = 5.0
    mass[120], age[121], feh[122] = np.nan, np.nan, np.nan
    mass[123], feh[124] = 0.05, 0.9
    distance = rng.uniform(10.0, 3000.0, n)
    AV = rng.uniform(0.0, 1.0, n)
    return mass, age, feh, distance, AV


def knife_edge_rows(eep_port, eep_jax, nan_port, nan_jax):
    """The rows whose NaN status differs between the packages, after
    asserting that each one is a knife-edge row: the port's EEP an integer,
    the JAX EEP at most 2 units in the last place below it, the port's row
    NaN and the JAX row finite. Returns their count."""
    eep_port, eep_jax = np.asarray(eep_port, dtype=float), np.asarray(eep_jax, dtype=float)
    differ = np.asarray(nan_port) != np.asarray(nan_jax)
    e, j = eep_port[differ], eep_jax[differ]
    assert np.isfinite(e).all() and np.isfinite(j).all(), (e, j)
    assert (e == np.round(e)).all(), e
    assert ((e - j > 0) & (e - j <= 2 * np.spacing(e))).all(), (e, j)
    assert np.asarray(nan_port)[differ].all() and not np.asarray(nan_jax)[differ].any()
    return int(differ.sum())


def assert_columns_close(got, ref, skip_rows=None, eep_atol=1e-10):
    """Same columns in the same order; each to the tolerances above, NaN
    patterns identical outside ``skip_rows``."""
    assert list(got) == list(ref), (list(got), list(ref))
    keep = slice(None) if skip_rows is None else ~skip_rows
    for c in ref:
        g, r = np.asarray(got[c], dtype=float)[keep], np.asarray(ref[c], dtype=float)[keep]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=c)
        fin = ~np.isnan(r)
        if not fin.any():
            continue
        atol = eep_atol if c.startswith("eep") else 1e-10 * max(1.0, np.abs(r[fin]).max())
        np.testing.assert_allclose(g[fin], r[fin], rtol=RTOL, atol=atol, err_msg=c)


def _jax_frame(df):
    return {c: df[c].values for c in df.columns}


@pytest.mark.parametrize("case", ["fast", "accurate", "eeps", "all_As", "subset"])
def test_generate_matches_jax(ics, case):
    jiso, tiso = ics
    mass, age, feh, distance, AV = queries(jiso.track)
    kw = dict(distance=distance, AV=AV)
    if case == "accurate":
        kw["accurate"] = True
    elif case == "eeps":
        kw["eeps"] = np.random.default_rng(5).uniform(-5.0, 110.0, N_POINTS)
    elif case == "all_As":
        kw["all_As"] = True
    elif case == "subset":
        kw.update(props=["radius", "Teff", "age"], bands=["K", "G", "J"], all_As=True)
    ref = _jax_frame(jiso.track.generate(mass, age, feh, **kw))
    got = tiso.track.generate(mass, age, feh, **kw)
    assert isinstance(got, Frame) and got.index is None
    if case == "eeps":  # no inversion: no knife edge
        assert_columns_close(got, ref)
        return
    # the EEPs of the fast inversion, in each package (the knife edge is there)
    if case == "accurate":
        e_port = tiso.track.get_eep(mass, age, feh, accurate=True)
        e_jax = jiso.track.get_eep(mass, age, feh, accurate=True)
    else:
        e_port, e_jax = tiso.track.get_eep(mass, age, feh), jiso.track.get_eep(mass, age, feh)
    first = next(c for c in ref if c.endswith("_mag"))
    n_edge = knife_edge_rows(e_port, e_jax, np.isnan(got[first]), np.isnan(ref[first]))
    skip = np.isnan(np.asarray(got[first])) != np.isnan(ref[first])
    assert_columns_close(got, ref, skip_rows=skip if n_edge else None)
    assert 500 < int(np.isfinite(got[first]).sum()) < N_POINTS


def test_generate_return_dict_and_iso_delegation(ics):
    jiso, tiso = ics
    mass, age, feh, distance, AV = queries(jiso.track, seed=1)
    frame = tiso.track.generate(mass, age, feh, distance=distance, AV=AV, all_As=True)
    d = tiso.generate(mass, age, feh, distance=distance, AV=AV, all_As=True, return_dict=True)
    assert type(d) is dict and list(d) == list(frame)
    for c in frame:
        np.testing.assert_array_equal(d[c], frame[c])
    ref = jiso.generate(mass, age, feh, distance=distance, AV=AV, all_As=True, return_dict=True)
    assert type(ref) is dict and list(ref) == list(d)
    # scalars broadcast to one row, as in the JAX package
    one = tiso.track.generate(mass[500], age[500], feh[500], distance=distance[500], AV=AV[500], all_As=True)
    assert_columns_close(one, {c: v[500:501] for c, v in frame.items()})


@pytest.mark.parametrize("all_As", [False, True])
def test_generate_binary_matches_jax(ics, all_As):
    jiso, tiso = ics
    mass, age, feh, distance, AV = queries(jiso.track, n=N_POINTS, seed=2)
    mass_B = mass * np.random.default_rng(3).uniform(0.1, 1.0, N_POINTS)
    mass_B[::4] = 0.0  # single stars: a NaN secondary adds no flux
    kw = dict(distance=distance, AV=AV, all_As=all_As)
    ref = _jax_frame(jiso.track.generate_binary(mass, mass_B, age, feh, **kw))
    got = tiso.generate_binary(mass, mass_B, age, feh, **kw)
    e_port = tiso.track.get_eep(np.concatenate([mass, mass_B]), np.tile(age, 2), np.tile(feh, 2))
    e_jax = jiso.track.get_eep(np.concatenate([mass, mass_B]), np.tile(age, 2), np.tile(feh, 2))
    nan_p = np.concatenate([np.isnan(got["J_mag_0"]), np.isnan(got["J_mag_1"])])
    nan_j = np.concatenate([np.isnan(ref["J_mag_0"]), np.isnan(ref["J_mag_1"])])
    n_edge = knife_edge_rows(e_port, e_jax, nan_p, nan_j)
    skip = (nan_p != nan_j).reshape(2, -1).any(axis=0)
    assert_columns_close(got, ref, skip_rows=skip if n_edge else None)
    assert np.isfinite(got["J_mag"]).sum() > 500


@pytest.mark.parametrize("accurate", [False, True])
def test_generate_device_equals_generate(ics, accurate):
    _, tiso = ics
    mass, age, feh, distance, AV = (x[:500] for x in queries(tiso.track, seed=4))
    eeps, values, mags = tiso.generate_device(mass, age, feh, distance=distance, AV=AV, accurate=accurate)
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu" for x in (eeps, values, mags))
    df = tiso.track.generate(mass, age, feh, distance=distance, AV=AV, accurate=accurate)
    cols = list(tiso.track.model.columns)
    np.testing.assert_array_equal(values.numpy(), np.stack([df[c] for c in cols], axis=-1))
    np.testing.assert_array_equal(mags.numpy(), np.stack([df[f"{b}_mag"] for b in tiso.bands], axis=-1))
    np.testing.assert_array_equal(eeps.numpy(), tiso.track.get_eep(mass, age, feh, accurate=accurate))


@pytest.mark.parametrize("age", [8.5, 9.5])
def test_isochrone_matches_jax(ics, age):
    jiso, tiso = ics
    for dropna in (True, False):
        ref = jiso.isochrone(age, feh=-0.3, distance=250.0, AV=0.2, dropna=dropna)
        got = tiso.isochrone(age, feh=-0.3, distance=250.0, AV=0.2, dropna=dropna)
        np.testing.assert_array_equal(got._labels(), ref.index.values)
        assert_columns_close(got, _jax_frame(ref))
    assert 30 < len(got["eep"]) and np.isnan(got["mass"]).any()


@pytest.mark.parametrize("grid", ["track", "iso"])
@pytest.mark.parametrize("approx", [True, False])
def test_model_value_and_mag_match_jax(ics, grid, approx):
    jiso, tiso = ics
    jic, tic = (jiso.track, tiso.track) if grid == "track" else (jiso, tiso)
    mass, age, feh, distance, AV = queries(jiso.track, seed=6)
    ref_v = np.asarray(jic.model_value(mass, age, feh, ["radius", "Teff"], approx=approx))
    got_v = np.asarray(tic.model_value(mass, age, feh, ["radius", "Teff"], approx=approx))
    ref_m = np.asarray(jic.model_mag(mass, age, feh, distance=distance, AV=AV, approx=approx))
    got_m = np.asarray(tic.model_mag(mass, age, feh, distance=distance, AV=AV, approx=approx))
    # both delegate to the track interpolator, whose EEPs decide the knife edge
    n_edge = knife_edge_rows(tiso.track.get_eep(mass, age, feh, accurate=not approx),
                             jiso.track.get_eep(mass, age, feh, accurate=not approx),
                             np.isnan(got_v[:, 0]), np.isnan(ref_v[:, 0]))
    skip = np.isnan(got_v[:, 0]) != np.isnan(ref_v[:, 0]) if n_edge else np.zeros(len(mass), bool)
    assert_columns_close({"v": got_v[~skip].ravel(), "m": got_m[~skip].ravel()},
                         {"v": ref_v[~skip].ravel(), "m": ref_m[~skip].ravel()})
    assert np.isfinite(got_v[:, 0]).sum() > 300
    # scalars give floats, one band a float
    i = int(np.flatnonzero(np.isfinite(got_v[:, 0]) & np.isfinite(got_m).all(axis=1))[0])
    assert tic.model_value(mass[i], age[i], feh[i], "radius", approx=approx) == got_v[i, 0]
    k = tic.bands.index("K")
    assert tic.model_mag(mass[i], age[i], feh[i], distance=distance[i], AV=AV[i], bands=["K"],
                         approx=approx) == pytest.approx(got_m[i, k], rel=1e-15)


def test_generate_plain_matches_composed(ics):
    """``generate_plain`` is the composition of the fast inversion, the
    column lerp and ``interp_mag``, bitwise; the CPU dispatchers take it."""
    _, tiso = ics
    tr = tiso.track
    fm = tr._forward_model
    mass, age, feh, distance, AV = (torch.as_tensor(x) for x in queries(tr, seed=7))
    icols, bcols = tr.model.icols(["radius", "logg", "eep"]), tuple(tr.bc.column_index[b] for b in ("J", "W1"))
    eeps, props, mags, mags0 = generate_plain(fm, mass, age, feh, distance, AV, icols, bcols, all_As=True)
    e_ref = tr.get_eep_batch(mass, age, feh)
    np.testing.assert_array_equal(eeps.numpy(), e_ref.numpy())
    pts = torch.stack([mass, e_ref, feh, distance, AV], dim=-1)
    np.testing.assert_array_equal(props.numpy(), tr.interp_value_batch(pts, ["radius", "logg", "eep"]).numpy())
    np.testing.assert_array_equal(mags.numpy(), tr.interp_mag_batch(pts, ["J", "W1"])[3].numpy())
    pts0 = torch.cat([pts[:, :4], torch.zeros_like(pts[:, 4:])], dim=-1)
    np.testing.assert_array_equal(mags0.numpy(), tr.interp_mag_batch(pts0, ["J", "W1"])[3].numpy())
    for got, ref in zip(generate_forward(fm, mass, age, feh, distance, AV, icols, bcols, all_As=True),
                        (eeps, props, mags, mags0)):
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
    np.testing.assert_array_equal(get_eep_fast(fm, mass, age, feh).numpy(), e_ref.numpy())
    # the accurate form: the Newton step on the fast EEP, NaN past resid_tol
    acc = generate_plain(fm, mass, age, feh, distance, AV, icols, bcols, accurate=True)
    np.testing.assert_array_equal(acc[0].numpy(), tr.get_eep_batch(mass, age, feh, accurate=True).numpy())
    assert acc[3] is None
    # EEPs given: the lerp at those EEPs
    given = torch.linspace(-3.0, 105.0, mass.shape[0], dtype=torch.float64)
    g = generate_plain(fm, mass, age, feh, distance, AV, icols, bcols, eeps=given)
    assert g[0] is given
    gp = torch.stack([mass, given, feh], dim=-1)
    np.testing.assert_array_equal(g[1].numpy(), interp_nd(tr.model.values, tr.model.knots, gp[:, [2, 0, 1]],
                                                          icols=icols, axis_maps=tr.model.axis_maps).numpy())


def test_generate_cuda_refuses_cpu_and_names_caps(ics):
    """The kernel's wrappers refuse CPU tensors (the dispatchers send those
    to the plain version) and name each cap they enforce."""
    _, tiso = ics
    fm = tiso.track._forward_model
    x = torch.ones(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        generate_cuda(fm, x, x, x, x, x, (0,), (0,))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        get_eep_cuda(fm, x, x, x)
    with pytest.raises(ValueError, match=f"at most {MAX_PROPS} model columns"):
        generate_cuda(fm, x, x, x, x, x, (0,) * (MAX_PROPS + 1), (0,))
    with pytest.raises(ValueError, match=f"at most {MAX_BANDS} bands"):
        generate_cuda(fm, x, x, x, x, x, (0,), (0,) * (MAX_BANDS + 1))
    huge = torch.zeros(1, dtype=torch.float64).expand(1 << 31)  # no memory: one element, stride 0
    with pytest.raises(ValueError, match=r"N < 2\*\*31"):
        get_eep_cuda(fm, huge, huge, huge)
    with pytest.raises(ValueError, match="cpu or cuda"):
        generate_forward(fm, x.to("meta"), x, x, x, x, (0,), (0,))


def test_packed_model_holds_every_column_once(ics):
    """The kernel's copy of the model table: every column, Teff, logg, feh
    and Mbol first, zero-padded to a multiple of 4, built once per forward
    model and dtype; a call's columns by their places in it and the lerped
    part of the row (one vector for the magnitudes alone); a table past the
    kernel's 32 columns is refused by name."""
    _, tiso = ics
    fm = tiso.track._forward_model
    vals = fm.model.values
    n = vals.shape[-1]
    table, order = packed_model(fm, torch.float64, vals.device)
    assert packed_model(fm, torch.float64, vals.device)[0] is table
    assert order[:4] == tuple(int(c) for c in fm.model_icols) and sorted(order) == list(range(n))
    assert table.is_contiguous() and table.shape == vals.shape[:-1] + (-(-n // 4) * 4,)
    np.testing.assert_array_equal(table[..., :n].numpy(), vals[..., list(order)].numpy())
    assert not table[..., n:].any()
    assert pack_layout(order, ()) == ([], 4)
    assert pack_layout(order, fm.model_icols[::-1]) == ([3, 2, 1, 0], 4)
    cols = (order[-1], order[0], order[5], order[5])
    assert pack_layout(order, cols) == ([n - 1, 0, 5, 5], -(-n // 4) * 4)
    assert pack_layout(order, (order[4],)) == ([4], 8)
    wide = dataclasses.replace(fm, model=dataclasses.replace(fm.model, values=torch.zeros(2, 2, 2, 33)))
    with pytest.raises(ValueError, match="model table of at most 32 columns"):
        packed_model(wide, torch.float64, vals.device)


@pytest.mark.parametrize("grid", ["track", "iso"])
def test_interpolator_names_match_jax(ics, grid):
    """``model_grid``, ``bc_grid``, ``prop_map``, ``column_map``, the
    ``mag[band]`` accessor and ``initialize``."""
    jiso, tiso = ics
    jic, tic = (jiso.track, tiso.track) if grid == "track" else (jiso, tiso)
    assert tic.model_grid is tic.model and tic.bc_grid is tic.bc
    assert tic.prop_map == jic.prop_map and tic.column_map == jic.column_map
    assert tic.mag.keys() == jic.mag.keys()
    p = [1.0, 60.0, 0.0, 200.0, 0.3] if grid == "track" else [60.0, 9.0, 0.0, 200.0, 0.3]
    assert tic.mag["W2"](*p) == pytest.approx(jic.mag["W2"](*p), rel=RTOL)
    np.testing.assert_array_equal(tic.mag["W2"](*[np.full(3, v) for v in p]), np.full(3, tic.mag["W2"](*p)))
    tic.initialize(p)
    jic.initialize(p)
    # the default point lies past this small grid's 100 EEPs: both refuse it
    for ic in (tic, jic):
        with pytest.raises(AssertionError):
            ic.initialize()
