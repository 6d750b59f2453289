"""Line-of-sight extinction lookup (counterpart of
``isochrones_tpu/extinction.py``): ``get_AV_infinity`` reads the Landolt-V
A_V at infinity along (ra, dec) from the NED calculator. Network access
honours ``config.OFFLINE``; the sexagesimal conversion is plain arithmetic.
"""

from __future__ import annotations

import re

from . import config

__all__ = ["get_AV_infinity"]


def _deg_to_hms(ra_deg):
    h = ra_deg / 15.0
    hh = int(h)
    m = (h - hh) * 60
    mm = int(m)
    ss = (m - mm) * 60
    return hh, mm, ss


def _deg_to_dms(dec_deg):
    sign = 1 if dec_deg >= 0 else -1
    d = abs(dec_deg)
    dd = int(d)
    m = (d - dd) * 60
    mm = int(m)
    ss = (m - mm) * 60
    return sign * dd, mm, ss


def get_AV_infinity(ra, dec, frame="icrs"):
    """A_V at infinity along a line of sight, read from NED
    (reference extinction.py:10-53). ra, dec in degrees (icrs)."""
    if frame != "icrs":
        raise NotImplementedError(
            "only icrs coordinates are supported without astropy installed"
        )
    if config.OFFLINE:
        raise RuntimeError("Offline mode: cannot query NED for A_V")

    rah, ram, ras = _deg_to_hms(float(ra) % 360.0)
    decd, decm, decs = _deg_to_dms(float(dec))
    # the sign comes from dec itself: for -1 < dec < 0 the degrees field is 0
    # and cannot carry it
    decsign = "%2B" if float(dec) >= 0 else "%2D"
    url = (
        "http://ned.ipac.caltech.edu/cgi-bin/nph-calc?in_csys=Equatorial"
        "&in_equinox=J2000.0&obs_epoch=2010&lon="
        + "%i" % rah + "%3A" + "%i" % ram + "%3A" + "%05.2f" % ras
        + "&lat=%s" % decsign
        + "%i" % abs(decd) + "%3A" + "%i" % abs(decm) + "%3A" + "%05.2f" % abs(decs)
        + "&pa=0.0&out_csys=Equatorial&out_equinox=J2000.0"
    )

    from urllib.request import urlopen

    AV = None
    with urlopen(url) as resp:
        for line in resp.readlines():
            m = re.search(rb"^Landolt V \(0.54\)\s+(\d+\.\d+)", line)
            if m:
                AV = float(m.group(1))
                break
    if AV is None:
        raise RuntimeError(f"AV query fails! URL is {url}")
    return AV
