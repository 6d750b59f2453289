"""The port's call signatures against the JAX package's, module by module.

For each module of ``isochrones_tpu`` with a counterpart at the same relative
path in ``isochrones_torch``: every public function, class and method that
both define (the names of ``tests/test_torch_api_names.py``) takes the same
parameters in the same order, once the intended differences are set aside:

- :data:`INTENDED`: the port's ``device`` and ``dtype``, its
  ``torch.Generator`` in place of a ``jax.random`` key, kernel B's ``planar``
  copy, and the JAX-only ``use_pallas``, ``block`` and ``paired``;
- :data:`SCOPED`: parameters that differ in one function only, each with its
  reason.

Named tuples also keep the reference's field order (a result unpacked or
indexed gives the same fields). The last tests hold the repaired
``StarCatalog`` options to the JAX class on one table, and the keywords that
``lnpost`` ignores and ``fit_mcmc``'s order to the reference's behaviour.
"""

import importlib
import inspect
import os

import numpy as np
import pandas as pd
import pytest
import torch

import isochrones_tpu.samplers  # noqa: F401  (the JAX samplers package)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: parameter name -> why the two packages differ in it (dropped from both sides)
INTENDED = {
    "device": "the port's tensors name their device; JAX places arrays itself",
    "dtype": "the port's tables and points take a torch dtype (the JAX package's x64 flag or its own dtype)",
    "generator": "the port draws from a torch.Generator",
    "key": "the JAX package draws from a jax.random key",
    "planar": "kernel B's column-planar copy, a choice of the port's CUDA kernel",
    "use_pallas": "the JAX package's switch to its Pallas TPU kernel",
    "block": "the JAX package's TPU tiling of interp_nd",
    "paired": "the JAX package's paired-column TPU layout",
}

#: "<JAX module>:<name>" -> {JAX parameter: its name in the port, or a
#: parameter that one package alone has: None}, each with its reason
SCOPED = {
    # the port hands the family sampler the likelihood itself: a torch
    # function takes the problems' data as a batch axis, where the JAX
    # package builds one function per problem to vmap
    # (isochrones_torch/samplers/nested.py::run_nested_vmapped)
    "isochrones_tpu.samplers.nested:run_nested_vmapped": {"make_lnlike_u": "lnlike_u"},
    # the port's plain version of kernel F's Newton step: the closed-form slope
    # that the kernel uses, beside autograd's (ops/eep.py::get_eep_newton)
    "isochrones_tpu.ops.eep:get_eep_newton": {"closed_slope": None},
    "isochrones_tpu.ops:get_eep_newton": {"closed_slope": None},
}


def _port_modules():
    """Dotted names of the port's modules that have a JAX counterpart, from the
    files on disk (the same list in every process)."""
    out = ["isochrones_torch"]
    pkg = os.path.join(_ROOT, "isochrones_torch")
    for dirpath, dirnames, files in sorted(os.walk(pkg)):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith("_"))
        rel = os.path.relpath(dirpath, _ROOT).replace(os.sep, ".")
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            name = rel if f == "__init__.py" else f"{rel}.{f[:-3]}"
            jax_path = os.path.join(_ROOT, "isochrones_tpu", *name.split(".")[1:])
            if name != "isochrones_torch" and (os.path.isfile(jax_path + ".py")
                                               or os.path.isfile(os.path.join(jax_path, "__init__.py"))):
                out.append(name)
    return out


def _public(mod):
    """Public top-level names (``__all__`` where the module has one, else the
    functions and classes it defines) and the public attributes of its
    classes."""
    top = list(mod.__all__) if hasattr(mod, "__all__") else [
        n for n, v in vars(mod).items()
        if not n.startswith("_") and (inspect.isclass(v) or inspect.isfunction(v)) and v.__module__ == mod.__name__]
    out = list(top)
    for n in top:
        v = getattr(mod, n)
        if inspect.isclass(v) and v.__module__.startswith("isochrones_tpu"):
            out += [f"{n}.{a}" for a in vars(v) if not a.startswith("_")]
    return out


def _get(mod, name):
    obj = mod
    for part in name.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def _params(obj):
    """Parameter names of a callable (a class: its constructor), or None where
    it has no signature that inspect can read."""
    try:
        return [p.name for p in inspect.signature(obj).parameters.values()]
    except (TypeError, ValueError):
        return None


def _normalised(names, scoped, port):
    """``names`` without the intended differences (and the scoped parameters
    that one package alone has), the JAX side's scoped parameters renamed to
    the port's."""
    drop = set(INTENDED) | {k for k, v in scoped.items() if v is None}
    renames = {} if port else scoped
    return [renames.get(n, n) for n in names if n not in drop]


def _shared_callables(jax_name, port_name):
    """``(name, JAX object, port object)`` of the callables defined by the JAX
    package that both modules have (re-exports of JAX's or numpy's own
    functions are not the package's)."""
    jmod, tmod = importlib.import_module(jax_name), importlib.import_module(port_name)
    out = []
    for n in _public(jmod):
        a, b = _get(jmod, n), _get(tmod, n)
        if a is None or b is None or isinstance(a, property) or not callable(a) or not callable(b):
            continue
        if not (getattr(a, "__module__", None) or "").startswith("isochrones_tpu"):
            continue
        out.append((n, a, b))
    return out


@pytest.mark.parametrize("port_name", _port_modules())
def test_signatures_match_reference(port_name):
    jax_name = "isochrones_tpu" + port_name[len("isochrones_torch"):]
    differ = []
    for n, a, b in _shared_callables(jax_name, port_name):
        pa, pb = _params(a), _params(b)
        if pa is None or pb is None:
            continue
        scoped = SCOPED.get(f"{jax_name}:{n}", {})
        ja, tb = _normalised(pa, scoped, port=False), _normalised(pb, scoped, port=True)
        if ja != tb:
            differ.append(f"{n}: reference {pa}, port {pb}")
        fa, fb = getattr(a, "_fields", None), getattr(b, "_fields", None)
        if fa is not None and _normalised(fa, scoped, False) != _normalised(fb or (), scoped, True):
            differ.append(f"{n} fields: reference {fa}, port {fb}")
    assert not differ, f"{port_name} differs from {jax_name}:\n" + "\n".join(differ)


def test_intended_differences_are_used():
    """Each entry of :data:`INTENDED` and :data:`SCOPED` names a parameter that
    one of the packages really has, so the lists stay true."""
    seen = set()
    for port_name in _port_modules():
        jax_name = "isochrones_tpu" + port_name[len("isochrones_torch"):]
        for n, a, b in _shared_callables(jax_name, port_name):
            names = set(_params(a) or ()) | set(_params(b) or ())
            names |= set(getattr(a, "_fields", ())) | set(getattr(b, "_fields", ()))
            seen |= {p for p in INTENDED if p in names}
            for p, q in SCOPED.get(f"{jax_name}:{n}", {}).items():
                if p in names and (q is None or q in names):
                    seen.add(f"{jax_name}:{n}:{p}")
    want = set(INTENDED) | {f"{k}:{p}" for k, v in SCOPED.items() for p in v}
    assert want <= seen, sorted(want - seen)


@pytest.mark.parametrize("name", ["samplers:NestedResult", "samplers.nested:NestedResult",
                                  "samplers.polychord:NestedResult"])
def test_nested_result_fields(name):
    mod, attr = name.split(":")
    jres = getattr(importlib.import_module(f"isochrones_tpu.{mod}"), attr)
    tres = getattr(importlib.import_module(f"isochrones_torch.{mod}"), attr)
    assert tres._fields == jres._fields
    assert tres._fields[-3:] == ("truncated", "logz_runs", "dynamic_rounds")
    assert tres._field_defaults.keys() == jres._field_defaults.keys()


@pytest.mark.parametrize("name", ["run_nested", "run_polychord", "run_nuts", "run_ensemble"])
def test_sampler_parameter_positions(name):
    """The samplers' shared parameters sit at the reference's positions, so a
    positional call means the same in both (``core`` is ``run_nested``'s 15th)."""
    from isochrones_tpu import samplers as js
    from isochrones_torch import samplers as ts

    pa, pb = _params(getattr(js, name)), _params(getattr(ts, name))
    for i, p in enumerate(pa):
        if p in INTENDED:
            continue
        assert i < len(pb) and pb[i] == p, f"{name}: {p} is at {i} in the reference, the port has {pb}"
    if name == "run_nested":
        assert pb.index("core") == 14


# ------------------------------------------------------------- StarCatalog
def _table(n=12, seed=0):
    rng = np.random.default_rng(seed)
    cols = {}
    for b in ("J", "H", "K"):
        cols[f"{b}_mag"] = rng.uniform(8.0, 12.0, n)
        cols[f"{b}_mag_unc"] = rng.uniform(0.01, 0.05, n)
    cols["Teff"] = rng.uniform(4500.0, 6500.0, n)
    cols["Teff_unc"] = np.full(n, 80.0)
    cols["parallax"] = rng.uniform(2.0, 8.0, n)
    cols["parallax_unc"] = np.full(n, 0.05)
    cols["logg"] = rng.uniform(4.0, 4.6, n)  # no logg_unc: only no_uncs takes it as a property
    return cols


def _both(cols, **kw):
    from isochrones_tpu.catalog import StarCatalog as JaxCatalog
    from isochrones_torch.catalog import StarCatalog

    return StarCatalog(dict(cols), **kw), JaxCatalog(pd.DataFrame(cols), **kw)


def _same_pairs(tit, jit):
    t, j = list(tit), list(jit)
    assert [k for k, _ in t] == [k for k, _ in j]
    for (_, (tv, tu)), (_, (jv, ju)) in zip(t, j):
        assert isinstance(tv, np.ndarray) and isinstance(tu, np.ndarray)
        np.testing.assert_array_equal(tv, np.asarray(jv))
        np.testing.assert_array_equal(tu, np.asarray(ju))
    return len(t)


@pytest.mark.parametrize("values", [False, True])
def test_catalog_measurements(values):
    cols = _table()
    tc, jc = _both(cols)
    assert tc.props == jc.props == ("Teff", "parallax")
    for prop in ("J_mag", "Teff", "parallax"):
        _same_pairs([(prop, tc.get_measurement(prop, values=values))],
                    [(prop, jc.get_measurement(prop, values=values))])
    assert _same_pairs(tc.iter_bands(values=values), jc.iter_bands(values=values)) == 3
    assert _same_pairs(tc.iter_props(values=values), jc.iter_props(values=values)) == 2
    assert _same_pairs(tc.iter_bands(), jc.iter_bands()) == 3
    with pytest.raises(TypeError):
        list(tc.iter_props(unknown=True))
    with pytest.raises(TypeError):
        list(jc.iter_props(unknown=True))


def test_catalog_no_uncs():
    """``no_uncs`` skips the ``_unc`` checks in both packages: a property
    without its uncertainty column, and a band without its column at all,
    are taken as given."""
    cols = _table()
    for kw in (dict(props=("logg",)), dict(bands=("J", "V"))):
        for cls_kw in ({}, {"no_uncs": False}):
            with pytest.raises(ValueError):
                _both(cols, **kw, **cls_kw)
        tc, jc = _both(cols, **kw, no_uncs=True)
        assert (tc.bands, tc.props, tc.band_cols) == (jc.bands, jc.props, jc.band_cols)
        assert len(tc) == len(jc) == 12
    tc, jc = _both(cols, props=("logg",), no_uncs=True)
    np.testing.assert_array_equal(tc.get_measurement("Teff")[0], jc.get_measurement("Teff")[0])
    for cat in (tc, jc):
        with pytest.raises(KeyError):
            list(cat.iter_props())  # logg has no uncertainty column to read


def test_catalog_positional_and_keyword_df():
    from isochrones_torch.catalog import StarCatalog

    cols = _table()
    a = StarCatalog(dict(cols), ("J", "K"), ("Teff",), False)
    b = StarCatalog(df=dict(cols), bands=("J", "K"), props=("Teff",))
    assert (a.bands, a.props) == (b.bands, b.props) == (("J", "K"), ("Teff",))
    assert StarCatalog(a).bands == ("J", "K")


# ----------------------------------------------------- the star model's calls
@pytest.fixture(scope="module")
def star_model():
    import isochrones_torch as it

    torch.set_num_threads(1)
    iso = it.get_ichrone("synthetic", bands=["J", "H", "K"], device="cpu", n_feh=5, n_mass=20, n_eep=60, n_age=20)
    return it.SingleStarModel(iso, J=(10.0, 0.02), H=(9.6, 0.02), K=(9.5, 0.02))


def test_lnpost_ignores_keywords(star_model):
    p = star_model.emcee_p0(1, rng=0)[0]
    ref = star_model.lnpost(p)
    assert star_model.lnpost(p, anything=1, other="x") == ref


def test_fit_mcmc_positional_order(star_model):
    """``fit_mcmc``'s seventh and eighth parameters are ``mesh`` and
    ``moves``, as in the reference: a mesh given by position reaches the mesh
    check (the port has no sharded walkers yet)."""
    with pytest.raises(NotImplementedError, match="mesh"):
        star_model.fit_mcmc(8, 1, 1, 1, None, 0, object())
