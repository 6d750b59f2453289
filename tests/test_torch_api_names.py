"""The port's public names against the JAX package's, module by module.

For each module of ``isochrones_tpu`` with a counterpart at the same relative
path in ``isochrones_torch``: its public top-level names (``__all__`` where it
has one, else the functions and classes it defines) and the public
attributes of its classes. Each must exist in the port or stand in
:data:`PARKED`, which maps it to "not to port" for the TPU-only names
(``ROADMAP.md``, "Not to port"). A parked name that the port now has fails
the test too, so the dict stays true.
"""

import importlib
import inspect
import os

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NOT_TO_PORT = "not to port"

_GRID_TPU = ("GridData.paired", "GridData.tree_flatten", "GridData.tree_unflatten")

_GROUPS = {
    "isochrones_tpu": {NOT_TO_PORT: _GRID_TPU},
    "isochrones_tpu.config": {NOT_TO_PORT: ("enable_compile_cache",)},
    # the g++-built host parser: the port parses with numpy's loadtxt, bitwise the same tables
    "isochrones_tpu.grids.parse": {NOT_TO_PORT: ("get_fastparse_lib",)},
    "isochrones_tpu.ops": {NOT_TO_PORT: _GRID_TPU},
    "isochrones_tpu.ops.interp": {NOT_TO_PORT: _GRID_TPU + ("pair_innermost_columns",)},
    "isochrones_tpu.priors": {NOT_TO_PORT: ("Prior.lnpdf_jax", "BoundedPrior.lnpdf_jax", "BrokenPrior.lnpdf_jax",
                                            "PowerLawPrior.sample_jax", "FehPrior.lnpdf_jax",
                                            "EEP_prior.lnpdf_jax")},
    "isochrones_tpu.samplers": {NOT_TO_PORT: ("EnsembleState.key",)},
    "isochrones_tpu.samplers.ensemble": {NOT_TO_PORT: ("EnsembleState.key",)},
    "isochrones_tpu.utils": {NOT_TO_PORT: ("addmags_jnp",)},
}

#: "<JAX module>:<name>" -> "not to port"
PARKED = {f"{mod}:{name}": item for mod, groups in _GROUPS.items() for item, names in groups.items()
          for name in names}


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
    top = list(mod.__all__) if hasattr(mod, "__all__") else [
        n for n, v in vars(mod).items()
        if not n.startswith("_") and (inspect.isclass(v) or inspect.isfunction(v)) and v.__module__ == mod.__name__]
    out = list(top)
    for n in top:
        v = getattr(mod, n)
        if inspect.isclass(v) and v.__module__.startswith("isochrones_tpu"):
            out += [f"{n}.{a}" for a in vars(v) if not a.startswith("_")]
    return out


def _has(mod, name):
    obj = mod
    for part in name.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


@pytest.mark.parametrize("port_name", _port_modules())
def test_port_has_public_names(port_name):
    jax_name = "isochrones_tpu" + port_name[len("isochrones_torch"):]
    jmod, tmod = importlib.import_module(jax_name), importlib.import_module(port_name)
    names = _public(jmod)
    missing = [n for n in names if not _has(tmod, n)]
    unparked = [n for n in missing if f"{jax_name}:{n}" not in PARKED]
    assert not unparked, f"{port_name} lacks {unparked}: port them or park them in PARKED"
    stale = [k for k in PARKED if k.split(":")[0] == jax_name and _has(tmod, k.split(":")[1])]
    assert not stale, f"parked but present in {port_name}: {stale}"


def test_parked_modules_exist():
    mods = {k.split(":")[0] for k in PARKED}
    have = {"isochrones_tpu" + m[len("isochrones_torch"):] for m in _port_modules()}
    assert mods <= have, sorted(mods - have)
    assert set(PARKED.values()) == {NOT_TO_PORT}
