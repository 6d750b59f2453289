"""The port's query layer against the JAX package's on the same injected
tables (``tests/test_query.py``'s fakes and seeded ones): a pandas
``DataFrame`` to the JAX classes, a ``summary.Frame``, a dict or the same
``DataFrame`` to the port's. Also the sky math, ``get_AV_infinity`` on a
stubbed ``urlopen`` and ``download_file`` on a stubbed ``requests``: nothing
reaches the network."""

import sys
import types
import urllib.request

import numpy as np
import pandas as pd
import pytest

import isochrones_tpu.query as jq
import isochrones_torch.query as tq
from isochrones_tpu import config as jconfig, extinction as jext, starfit as jsf, utils as jutils
from isochrones_tpu.query import query as jqq
from isochrones_torch import config as tconfig, extinction as text, starfit as tsf, utils as tutils
from isochrones_torch.query import query as tqq
from isochrones_torch.summary import Frame

RTOL = 1e-12
KINDS = ("frame", "dict", "pandas")


def _as(kind, cols):
    cols = {k: np.asarray(v) for k, v in cols.items()}
    return {"frame": Frame, "dict": dict, "pandas": pd.DataFrame}[kind](cols)


def _fake_2mass(ra, dec, radius, vizier_name):
    # the base quality cut is _r > 0, so the "close" source sits slightly off the query position
    return {
        "_RAJ2000": [ra + 0.0001, ra + 0.000001], "_DEJ2000": [dec, dec],
        "Jmag": [10.0, 9.0], "e_Jmag": [0.02, 0.02], "Hmag": [9.8, 8.8], "e_Hmag": [0.03, 0.02],
        "Kmag": [9.7, 8.7], "e_Kmag": [0.02, 0.02], "_2MASS": ["far", "close"],
    }


def _seeded(ra, dec, radius, vizier_name, seed=0, n=9):
    """A seeded table of n sources within the radius: every catalog's columns,
    ties in the magnitudes and the separations, NaN in a few cells, one
    source at the query position itself (``_r`` = 0)."""
    rng = np.random.default_rng(seed)
    dra = rng.uniform(-1, 1, n) * radius / 3600 / np.cos(np.radians(dec))
    ddec = rng.uniform(-1, 1, n) * radius / 3600
    dra[3], ddec[3] = dra[1], ddec[1]  # a tie in the separation
    dra[5] = ddec[5] = 0.0
    cols = {"_RAJ2000": ra + dra, "_DEJ2000": dec + ddec}
    for b in ("J", "H", "K", "BT", "VT", "W1", "W2", "W3", "G", "BP", "RP"):
        m = np.round(rng.uniform(8.0, 12.0, n), 1)
        m[[2, 6]] = m[0]  # ties in the magnitudes
        cols[f"{b}mag"] = m
        cols[f"e_{b}mag"] = rng.uniform(0.001, 0.05, n)
    cols["VTmag"] = cols["BTmag"] - rng.uniform(0.0, 1.5, n)
    cols["Jmag"][7] = np.nan
    cols.update(
        RPlx=rng.uniform(5, 60, n), RFG=rng.uniform(30, 200, n), RFRP=rng.uniform(10, 80, n),
        RFBP=rng.uniform(10, 80, n), Nper=rng.integers(5, 20, n), chi2AL=rng.uniform(50, 200, n),
        NgAL=rng.integers(80, 200, n), Plx=rng.uniform(1, 10, n), e_Plx=rng.uniform(0.01, 0.1, n),
        Source=np.arange(1000, 1000 + n), _2MASS=np.array([f"2M{i}" for i in range(n)]),
        AllWISE=np.array([f"W{i}" for i in range(n)]), TYC1=np.arange(n) + 1, TYC2=np.arange(n) + 20,
        TYC3=np.ones(n, dtype=int),
    )
    cols["RPlx"][4] = np.nan
    return cols


def _providers(kind, fake):
    """(JAX provider, port provider) of the same table."""
    return (staticmethod(lambda *a: pd.DataFrame(fake(*a))),
            staticmethod(lambda *a: _as(kind, fake(*a))))


CATALOGS = [("TwoMASS", dict(pmra=20.0, pmdec=-15.0, epoch=2010.0)), ("WISE", {}), ("Gaia", dict(pmra=-3.0)),
            ("Tycho2", {})]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,qkw", CATALOGS)
def test_catalogs_match_jax(monkeypatch, kind, name, qkw):
    jcls, tcls = getattr(jq, name), getattr(tq, name)
    jp, tp = _providers(kind, _seeded)
    monkeypatch.setattr(jcls, "table_provider", jp)
    monkeypatch.setattr(tcls, "table_provider", tp)
    q = dict(ra=123.4, dec=-45.6, radius=6.0, **qkw)
    jc, tc = jcls(jq.Query(**q)), tcls(tq.Query(**q))
    jt, tt = jc.table, tc.table
    np.testing.assert_allclose(tt["_r"], jt["_r"].values, rtol=RTOL)
    np.testing.assert_allclose(tt["PA"], jt["PA"].values, rtol=RTOL)
    np.testing.assert_array_equal(tt["is_good"], jt["is_good"].values)
    assert tc.query_coords == jc.query_coords
    np.testing.assert_array_equal(tc.df._labels(), jc.df.index.values)
    for attr in ("closest", "brightest"):
        trow, jrow = getattr(tc, attr), getattr(jc, attr)
        for c in jrow.index:
            a, b = trow[c], jrow[c]
            assert a == b or (isinstance(b, float) and np.isnan(a) and np.isnan(b)), (attr, c)
    if hasattr(jcls, "id_column") or name == "Tycho2":
        for brightest in (False, True):
            assert tc.get_id(brightest) == jc.get_id(brightest)
    for brightest in (False, True):
        for sys_unc in (0.0, 0.01):
            if name == "Tycho2" and not -0.25 < jc.closest["BTmag"] - jc.closest["VTmag"] < 2.0:
                continue
            tph = tc.get_photometry(brightest=brightest, systematic_unc=sys_unc)
            jph = jc.get_photometry(brightest=brightest, systematic_unc=sys_unc)
            assert list(tph) == list(jph)
            for b in jph:
                np.testing.assert_allclose(tph[b], jph[b], rtol=RTOL)
            tph = tc.get_photometry(brightest=brightest, systematic_unc=sys_unc, convert=False)
            jph = jc.get_photometry(brightest=brightest, systematic_unc=sys_unc, convert=False)
            assert list(tph) == list(jph)
            for b in jph:
                np.testing.assert_allclose(tph[b], jph[b], rtol=RTOL)


def test_twomass_fake_table(monkeypatch):
    """``tests/test_query.py``'s 2MASS table in both packages."""
    monkeypatch.setattr(jq.TwoMASS, "table_provider", staticmethod(lambda *a: pd.DataFrame(_fake_2mass(*a))))
    monkeypatch.setattr(tq.TwoMASS, "table_provider", staticmethod(_fake_2mass))
    jc, tc = jq.TwoMASS(jq.Query(120.0, -20.0)), tq.TwoMASS(tq.Query(120.0, -20.0))
    tph, jph = tc.get_photometry(systematic_unc=0.01), jc.get_photometry(systematic_unc=0.01)
    assert list(tph) == list(jph) == ["J", "H", "K"] and tph["J"][0] == 9.0
    for b in jph:
        np.testing.assert_allclose(tph[b], jph[b], rtol=RTOL)
    assert tc.get_id() == jc.get_id() == "close" and tc.get_id(brightest=True) == "close"
    np.testing.assert_allclose(tc.table["_r"], jc.table["_r"].values, rtol=RTOL)


@pytest.mark.parametrize("x", [0.6, 0.3, -0.1, 1.9])
def test_tycho_conversions(monkeypatch, x):
    def fake(ra, dec, radius, name):
        return {"_RAJ2000": [ra + 0.000001], "_DEJ2000": [dec], "BTmag": [10.0 + x], "e_BTmag": [0.03],
                "VTmag": [10.0], "e_VTmag": [0.02], "TYC1": [1], "TYC2": [2], "TYC3": [3]}

    monkeypatch.setattr(jq.Tycho2, "table_provider", staticmethod(lambda *a: pd.DataFrame(fake(*a))))
    monkeypatch.setattr(tq.Tycho2, "table_provider", staticmethod(fake))
    jc, tc = jq.Tycho2(jq.Query(50.0, 10.0)), tq.Tycho2(tq.Query(50.0, 10.0))
    for conv in ("V", "BmV", "B"):
        np.testing.assert_allclose(getattr(tc, conv)(), getattr(jc, conv)(), rtol=RTOL)
    assert tc.get_id() == jc.get_id() == "1-2-3"
    assert list(tc.get_photometry()) == list(jc.get_photometry()) == ["B", "V"]


def test_tycho_out_of_range(monkeypatch):
    def fake(ra, dec, radius, name):
        return {"_RAJ2000": [ra + 1e-6], "_DEJ2000": [dec], "BTmag": [13.0], "e_BTmag": [0.03],
                "VTmag": [10.0], "e_VTmag": [0.02]}

    monkeypatch.setattr(jq.Tycho2, "table_provider", staticmethod(lambda *a: pd.DataFrame(fake(*a))))
    monkeypatch.setattr(tq.Tycho2, "table_provider", staticmethod(fake))
    for cat in (jq.Tycho2(jq.Query(1.0, 2.0)), tq.Tycho2(tq.Query(1.0, 2.0))):
        for conv in ("V", "BmV", "B"):
            with pytest.raises(ValueError, match="outside of range"):
                getattr(cat, conv)()


@pytest.mark.parametrize("empty", [None, "no rows"])
def test_empty_query(monkeypatch, empty):
    for mod in (jq, tq):
        table = None if empty is None else (pd.DataFrame({"_RAJ2000": [], "_DEJ2000": []}) if mod is jq
                                            else Frame({"_RAJ2000": np.zeros(0), "_DEJ2000": np.zeros(0)}))
        monkeypatch.setattr(mod.TwoMASS, "table_provider", staticmethod(lambda *a, t=table: t))
        cat = mod.TwoMASS(mod.Query(0.0, 0.0))
        with pytest.raises(mod.EmptyQueryError, match="returns empty"):
            _ = cat.table
        with pytest.raises(mod.EmptyQueryError, match="is empty"):
            _ = cat.table


def test_no_good_source_and_no_provider(monkeypatch):
    def fake(ra, dec, radius, name):  # every source fails the cuts
        return {"_RAJ2000": [ra], "_DEJ2000": [dec], "Gmag": [12.0], "RPlx": [1.0], "RFG": [100.0],
                "RFRP": [50.0], "RFBP": [50.0], "Nper": [10], "chi2AL": [100.0], "NgAL": [105]}

    monkeypatch.setattr(jq.Gaia, "table_provider", staticmethod(lambda *a: pd.DataFrame(fake(*a))))
    monkeypatch.setattr(tq.Gaia, "table_provider", staticmethod(fake))
    for mod in (jq, tq):
        with pytest.raises(mod.EmptyQueryError, match="No good sources"):
            _ = mod.Gaia(mod.Query(80.0, 5.0)).df
    # without a provider and without astroquery (hidden, so nothing can reach the network) both refuse
    monkeypatch.setitem(sys.modules, "astroquery", None)
    monkeypatch.setitem(sys.modules, "astroquery.vizier", None)
    for mod in (jq, tq):
        monkeypatch.setattr(mod.WISE, "table_provider", None)
        with pytest.raises(RuntimeError, match="astroquery is not installed"):
            _ = mod.WISE(mod.Query(80.0, 5.0)).table


def test_gaia_data_matches_jax(monkeypatch):
    jp, tp = _providers("frame", _seeded)
    monkeypatch.setattr(jq.Gaia, "table_provider", jp)
    monkeypatch.setattr(tq.Gaia, "table_provider", tp)
    for brightest in (False, True):
        t = tsf.get_gaia_data(10.0, 20.0, radius=8.0, brightest=brightest)
        j = jsf.get_gaia_data(10.0, 20.0, radius=8.0, brightest=brightest)
        assert list(t) == list(j) == ["parallax", "G", "BP", "RP"]
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=RTOL)


def test_query_epoch_and_sky_math():
    rng = np.random.default_rng(3)
    for _ in range(20):
        kw = dict(ra=rng.uniform(0, 360), dec=rng.uniform(-89, 89), pmra=rng.normal(0, 300),
                  pmdec=rng.normal(0, 300), epoch=rng.uniform(1990, 2020), radius=rng.uniform(1, 30))
        jqr, tqr = jq.Query(**kw), tq.Query(**kw)
        for ep in (2000.0, 2015.5, kw["epoch"]):
            np.testing.assert_allclose(tqr.coords_at_epoch(ep), jqr.coords_at_epoch(ep), rtol=RTOL)
        assert str(tqr) == str(jqr) and repr(tqr) == repr(jqr) and tqr.coords == jqr.coords
    a = [rng.uniform(0, 360, 50), rng.uniform(-89, 89, 50), rng.uniform(0, 360, 50), rng.uniform(-89, 89, 50)]
    np.testing.assert_allclose(tqq.separation_arcsec(*a), jqq.separation_arcsec(*a), rtol=RTOL)
    np.testing.assert_allclose(tqq.position_angle_deg(*a), jqq.position_angle_deg(*a), rtol=RTOL)
    assert abs(tqq.position_angle_deg(10.0, 0.0, 10.0 + 1.0, 0.0) - 90.0) < 0.01


class _Response:
    def __init__(self, lines):
        self.lines = lines

    def readlines(self):
        return self.lines

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("ra,dec", [(280.5, 45.25), (0.0, -0.5), (359.99, -0.0001), (12.3456, 0.0),
                                    (200.0, -33.3), (-15.0, 89.9), (725.25, -12.75)])
def test_av_infinity_url_and_value(monkeypatch, ra, dec):
    urls = []

    def fake_urlopen(url):
        urls.append(url)
        return _Response([b"header\n", b"Landolt V (0.54)             0.123  mag\n", b"Landolt V (0.54) 9.9\n"])

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    assert text.get_AV_infinity(ra, dec) == jext.get_AV_infinity(ra, dec) == 0.123
    assert len(urls) == 2 and urls[0] == urls[1]
    if -1 < dec < 0:
        assert "&lat=%2D0%3A" in urls[0]
    assert text._deg_to_hms(ra % 360) == jext._deg_to_hms(ra % 360)
    assert text._deg_to_dms(dec) == jext._deg_to_dms(dec)


def test_av_infinity_errors(monkeypatch):
    monkeypatch.setattr(urllib.request, "urlopen", lambda url: _Response([b"no extinction line\n"]))
    for mod in (text, jext):
        with pytest.raises(RuntimeError, match="AV query fails! URL is http://ned"):
            mod.get_AV_infinity(10.0, 10.0)
        with pytest.raises(NotImplementedError):
            mod.get_AV_infinity(10.0, 10.0, frame="galactic")
    monkeypatch.setattr(tconfig, "OFFLINE", True)
    monkeypatch.setattr(jconfig, "OFFLINE", True)
    for mod in (text, jext):
        with pytest.raises(RuntimeError, match="Offline"):
            mod.get_AV_infinity(280.0, 45.0)


def test_download_file(monkeypatch, tmp_path):
    calls = []

    class _Reply:
        def raise_for_status(self):
            pass

        def iter_content(self, chunk_size):
            return [b"abc", b"", b"def" * 1000]

    fake = types.ModuleType("requests")
    fake.get = lambda url, stream: (calls.append((url, stream)), _Reply())[1]
    monkeypatch.setitem(sys.modules, "requests", fake)
    url = "http://example.invalid/file.txz"
    t, j = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    assert tutils.download_file(url, t) == t and jutils.download_file(url, j) == j
    assert calls == [(url, True)] * 2
    with open(t, "rb") as ft, open(j, "rb") as fj:
        assert ft.read() == fj.read() == b"abc" + b"def" * 1000
    for mod, path in ((tutils, t), (jutils, j)):
        assert mod.download_file(url, path) == path  # exists: kept, not fetched
    assert len(calls) == 2
    for mod, path in ((tutils, t), (jutils, j)):
        mod.download_file(url, path, clobber=True)
    assert len(calls) == 4
    monkeypatch.setattr(tconfig, "OFFLINE", True)
    monkeypatch.setattr(jconfig, "OFFLINE", True)
    for mod in (tutils, jutils):
        with pytest.raises(RuntimeError, match="Offline"):
            mod.download_file(url, str(tmp_path / "new.bin"))
        with pytest.raises(ValueError, match="path is required"):
            mod.download_file(url)
    assert len(calls) == 4
