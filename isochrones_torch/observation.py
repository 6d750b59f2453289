"""Observation trees for resolved multi-star systems (counterpart of
``isochrones_tpu/observation.py``).

The host-side tree building is the JAX package's, kept line for line:
observations sort by decreasing angular resolution, each source attaches to
the closest-on-sky node from coarser observations, relative photometry
references the brightest source, and ``define_models`` hangs N model stars
per system off the finest-resolution leaves. :func:`compile_plan` flattens
the tree once into static index arrays (:class:`TreePlan`), and
:func:`tree_lnlike_batch` evaluates the whole tree for a batch of parameter
vectors through :func:`isochrones_torch.ops.tree.tree_lnlike`: the
hand-written CUDA kernel on the card, its plain version on the CPU.

Tables: where the JAX package takes or returns a ``DataFrame``, this module
takes a list of row dicts, a dict of columns, or a ``DataFrame`` when one is
handed in, and returns a list of row dicts. ``save_hdf``/``load_hdf`` keep
their names and content but write a numpy ``.npz`` container (see
:mod:`isochrones_torch.utils`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Tuple

import numpy as np

from .logger import getLogger
from .utils import addmags, distance, npz_load, npz_save, store_prefix

__all__ = [
    "Node",
    "NodeTraversal",
    "MyLeftAligned",
    "ObsNode",
    "DummyObsNode",
    "ModelNode",
    "Source",
    "Star",
    "Observation",
    "ObservationTree",
    "TreePlan",
    "compile_plan",
    "make_tree_lnlike",
    "make_tree_lnlike_fused",
    "tree_lnlike_batch",
    "table_rows",
    "read_rows_csv",
]

OBS_COLUMNS = ("name", "band", "resolution", "mag", "e_mag", "separation", "pa", "relative")
_OBS_DTYPE = np.dtype([("name", "U32"), ("band", "U16"), ("resolution", "f8"), ("mag", "f8"), ("e_mag", "f8"),
                       ("separation", "f8"), ("pa", "f8"), ("relative", "?")])


def _as_bool(x):
    """Truth of a table cell; a CSV cell reads as the words True/False."""
    if isinstance(x, str):
        return x.strip().lower() in ("true", "1", "1.0")
    return bool(x)


def table_rows(table):
    """A photometry table as a list of row dicts: from a list of row dicts,
    a dict of columns, or a DataFrame."""
    if hasattr(table, "to_dict") and hasattr(table, "columns"):
        return table.to_dict("records")
    if isinstance(table, dict):
        cols = list(table)
        n = len(table[cols[0]]) if cols else 0
        return [{c: table[c][i] for c in cols} for i in range(n)]
    return [dict(r) for r in table]


def read_rows_csv(path):
    """A photometry table written as CSV (a header row, the columns of
    ``ObservationTree.to_df``) -> list of row dicts."""
    import csv

    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    out = []
    for r in rows:
        row = {k: (v if k in ("name", "band") else _as_bool(v) if k == "relative" else float(v))
               for k, v in r.items() if k in OBS_COLUMNS}
        out.append(row)
    return out


# --------------------------------------------------------------------- tree
class Node:
    """Generic tree node; iteration is leaves-first (reference
    observation.py:136-144)."""

    def __init__(self, label):
        self.label = label
        self.parent = None
        self.children = []
        self._leaves = None

    def __iter__(self):
        for c in self.children:
            yield from iter(c)
        yield self

    def __getitem__(self, ind):
        for i, n in enumerate(self):
            if i == ind:
                return n

    @property
    def is_root(self):
        return self.parent is None

    @property
    def is_leaf(self):
        return not self.children and not self.is_root

    def get_root(self):
        return self if self.is_root else self.parent.get_root()

    def get_ancestors(self):
        if self.parent is None or self.parent.is_root:
            return []
        return [self.parent] + self.parent.get_ancestors()

    def _clear_all_leaves(self):
        node = self
        while node is not None:
            node._leaves = None
            node._on_leaves_changed()
            node = node.parent

    def _on_leaves_changed(self):
        pass

    def add_child(self, node):
        node.parent = self
        self.children.append(node)
        self._clear_all_leaves()

    def remove_children(self):
        self.children = []
        self._clear_all_leaves()

    def remove_child(self, label):
        for i, c in enumerate(self.children):
            if c.label == label:
                self.children.pop(i)
                self._clear_all_leaves()
                return
        getLogger().warning("No child labeled %s.", label)

    @property
    def leaves(self):
        if self._leaves is None:
            self._leaves = self._get_leaves()
        return self._leaves

    def _get_leaves(self):
        if self.is_leaf:
            return [self]
        out = []
        for c in self.children:
            out.extend(c._get_leaves())
        return out

    def select_leaves(self, name):
        """All leaves under nodes whose label matches ``name`` (regex)."""
        if self.is_leaf:
            return [self] if re.search(name, self.label) else []
        out = []
        if re.search(name, str(self.label)):
            for c in self.children:
                out.extend(c._get_leaves())
        else:
            for c in self.children:
                out.extend(c.select_leaves(name))
        return out

    @property
    def leaf_labels(self):
        return [l.label for l in self.leaves]

    def get_leaf(self, label):
        for l in self.leaves:
            if l.label == label:
                return l

    def get_obs_nodes(self):
        return [n for n in self if isinstance(n, ObsNode)]

    def get_obs_leaves(self):
        out = []
        for n in self:
            if n.is_leaf:
                l = n.parent if isinstance(n, ModelNode) else n
                if l not in out:
                    out.append(l)
        return out

    @property
    def obs_leaf_nodes(self):
        """reference observation.py:263-265"""
        return self.get_obs_leaves()

    def get_model_nodes(self):
        return [n for n in self._get_leaves() if isinstance(n, ModelNode)]

    @property
    def N_model_nodes(self):
        return len(self.get_model_nodes())

    def attach_to_parent(self, node):
        """Detach from the current parent and attach to ``node``
        (reference observation.py:210-215)."""
        if self.parent is not None:
            self.parent.remove_child(self.label)
        node.add_child(self)

    def print_tree(self):
        """reference observation.py:288-289"""
        print(self.label)

    # ------------------------------------------------------- ascii rendering
    def _render_text(self):
        return str(self.label)

    def print_ascii(self, fout=None, pars=None):
        """Render the tree, optionally annotated with model values at ``pars``
        (reference observation.py:167-172; annotation semantics 40-113)."""
        text = MyLeftAligned(pars)(self)
        if fout is None:
            print(text)
        else:
            fout.write(text)

    def __str__(self):
        return str(self.label)

    def __repr__(self):
        kids = [str(c) for c in self.children]
        return f"<{type(self).__name__} '{self.label}', parent='{self.parent}', children={kids}>"


class ObsNode(Node):
    """One (instrument, band, source) measurement (reference
    observation.py:300-491)."""

    def __init__(self, observation, source, ref_node=None):
        self.observation = observation
        self.source = source
        self.reference = ref_node
        self.parent = None
        self.children = []
        self._leaves = None

    @property
    def instrument(self):
        return self.observation.name

    @property
    def band(self):
        return self.observation.band

    @property
    def value(self):
        return (self.source.mag, self.source.e_mag)

    @property
    def resolution(self):
        return self.observation.resolution

    @property
    def relative(self):
        return self.source.relative

    @property
    def separation(self):
        return self.source.separation

    @property
    def pa(self):
        return self.source.pa

    @property
    def value_str(self):
        """reference observation.py:353-355"""
        return "({:.2f}, {:.2f})".format(*self.value)

    @property
    def inds(self):
        """Leaf model-node indices under this node (reference
        observation.py:398-407)."""
        return [n.index for n in self.get_model_nodes()]

    def distance(self, other):
        return distance((self.separation, self.pa), (other.separation, other.pa))

    def _in_same_observation(self, other):
        return self.instrument == other.instrument and self.band == other.band

    @property
    def n_params(self):
        return 5 * len(self.leaves)

    @property
    def Nstars(self):
        N = {}
        for n in self.get_model_nodes():
            N[n.index] = N.get(n.index, 0) + 1
        return N

    @property
    def systems(self):
        return sorted(self.Nstars)

    @property
    def label(self):
        band_str = f"delta-{self.band}" if self.source.relative else self.band
        return "{} {}=({:.2f}, {:.2f}) @({:.2f}, {:.0f} [{:.2f}])".format(
            self.instrument, band_str, *self.value, self.separation, self.pa, self.resolution
        )

    @property
    def obsname(self):
        return f"{self.instrument}-{self.band}"

    def get_system(self, ind):
        return [l for l in self.get_root().leaves if getattr(l, "index", None) == ind]

    def add_model(self, ic, N=1, index=0):
        """Attach N ModelNodes (reference observation.py:555-575)."""
        if isinstance(index, (list, tuple)):
            if len(index) != N:
                raise ValueError("If a list, index must be of length N.")
        else:
            index = [index] * N
        for idx in index:
            tag = len(self.get_system(idx))
            self.add_child(ModelNode(ic, index=idx, tag=tag))

    def model_mag(self, model_values, use_cache=True):
        """Flux-sum of child model stars in this band (observation.py:450-462)."""
        return addmags(*[model_values[n.label][self.band] for n in self.leaves])

    def lnlike(self, model_values, use_cache=True):
        """Gaussian lnlike incl. relative-photometry referencing
        (observation.py:464-491)."""
        import math

        mag, dmag = self.value
        if np.isnan(dmag):
            return 0
        if self.relative:
            if self.reference is None:
                return 0
            mod = self.model_mag(model_values) - self.reference.model_mag(model_values)
            mag = mag - self.reference.value[0]
        else:
            mod = self.model_mag(model_values)
        from .ops.likelihood import LOG_ONE_OVER_ROOT_2PI

        return (
            -0.5 * (mag - mod) ** 2 / dmag ** 2
            + LOG_ONE_OVER_ROOT_2PI
            + math.log(dmag)
        )


class DummyObsNode(ObsNode):
    """Placeholder when a tree has no photometric observations
    (reference observation.py:494-522)."""

    def __init__(self, *args, **kwargs):
        self.observation = None
        self.source = None
        self.reference = None
        self.parent = None
        self.children = []
        self._leaves = None

    @property
    def label(self):
        return "[dummy]"

    @property
    def value(self):
        return (None, None)

    def lnlike(self, *args, **kwargs):
        return 0


class ModelNode(Node):
    """One physical model star; always a leaf (reference
    observation.py:525-578)."""

    def __init__(self, ic, index=0, tag=0):
        self._ic = ic
        self.index = index
        self.tag = tag
        self.parent = None
        self.children = []
        self._leaves = None

    @property
    def label(self):
        return f"{self.index}_{self.tag}"

    @property
    def ic(self):
        return self._ic

    def get_obs_ancestors(self):
        return [n for n in self.get_ancestors() if isinstance(n, ObsNode)]

    @property
    def contributing_observations(self):
        return [n.obsname for n in self.get_obs_ancestors()]

    def evaluate(self, p, prop):
        if prop in self.ic.bands:
            _, _, _, mags = self.ic.interp_mag(list(p), [prop])
            return float(np.squeeze(mags))
        if prop in ("Teff", "logg", "feh", "radius", "density"):
            return float(np.squeeze(self.ic.interp_value(list(p[:3]), [prop])))
        raise ValueError(f"property {prop} cannot be evaluated")

    def evaluate_mag(self, p, band):
        """reference observation.py:575-576"""
        _, _, _, mags = self.ic.interp_mag(list(p), [band])
        return float(np.squeeze(mags))

    def lnlike(self, *args, **kwargs):
        return 0


# ----------------------------------------------------- ascii-tree rendering
class NodeTraversal:
    """Annotated traversal for ascii tree printing (reference
    observation.py:40-113 subclasses asciitree's ``Traversal``; rebuilt here
    with no asciitree dependency).

    With ``pars`` (a pardict ``{system_label: [eep, age, feh, d, AV]}``),
    ObsNodes show their flux-summed model mag and per-node lnlike, and
    ModelNodes show each spectroscopy / limit / parallax constraint next to
    the model's predicted value.
    """

    def __init__(self, pars=None, **kwargs):
        self.pars = pars
        self._model_values = None

    def get_children(self, node):
        return node.children

    def get_root(self, node):
        return node.get_root()

    def _values(self, root):
        """Every model node's band mags at ``self.pars`` (lazy, once per
        render; host-side diagnostic path, so per-band evaluate is fine)."""
        if self._model_values is None:
            vals = {}
            for n in root.get_model_nodes():
                p = list(self.pars[n.label])
                d = {}
                for band in {a.band for a in n.get_obs_ancestors()}:
                    try:
                        d[band] = n.evaluate_mag(p, band)
                    except Exception:  # annotation only: never fail a print
                        d[band] = np.nan
                vals[n.label] = d
            self._model_values = vals
        return self._model_values

    def get_text(self, node):
        text = node._render_text()
        root = node.get_root()
        spec = getattr(root, "spectroscopy", {})
        limits = getattr(root, "limits", {})
        parallax = getattr(root, "parallax", {})
        AV = getattr(root, "AV", {})
        if self.pars is not None:
            if isinstance(node, ObsNode) and not isinstance(node, DummyObsNode):
                try:
                    mv = self._values(root)
                    text += "; model={:.2f} ({})".format(node.model_mag(mv), node.lnlike(mv))
                except Exception:
                    pass
            if isinstance(node, ModelNode):
                p = list(self.pars[node.label])
                for k, v in spec.get(node.label, {}).items():
                    text += f", {k}={v}"
                    try:
                        modval = node.evaluate(p, k)
                        lnl = -0.5 * (modval - v[0]) ** 2 / v[1] ** 2
                        text += f"; model={modval} ({lnl})"
                    except Exception:
                        pass
                for k, v in limits.get(node.label, {}).items():
                    text += f", {k} limits={v}"
                if node.index in parallax:
                    plx, u_plx = parallax[node.index]
                    modval = 1000.0 / p[3]
                    lnl = -0.5 * (modval - plx) ** 2 / u_plx ** 2
                    text += f", parallax={(plx, u_plx)}; model={modval} ({lnl})"
                if node.index in AV:
                    av, u_av = AV[node.index]
                    modval = p[4]
                    lnl = -0.5 * (modval - av) ** 2 / u_av ** 2
                    text += f", AV={(av, u_av)}; model={modval} ({lnl})"
                text += f": {self.pars[node.label]}"
        elif isinstance(node, ModelNode):
            for k, v in spec.get(node.label, {}).items():
                text += f", {k}={v}"
            if node.index in parallax:
                text += f", parallax={parallax[node.index]}"
            if node.index in AV:
                text += f", AV={AV[node.index]}"
            for k, v in limits.get(node.label, {}).items():
                text += f", {k} limits={v}"
        return text


class MyLeftAligned:
    """Left-aligned box rendering of a tree (reference observation.py:116-125
    subclasses asciitree's ``LeftAligned``; rebuilt dependency-free)."""

    pars = None

    def __init__(self, pars=None, **kwargs):
        self.pars = pars
        self.traverse = NodeTraversal(pars)

    def __call__(self, node):
        return "\n".join(self._lines(node)) + "\n"

    def _lines(self, node, prefix="", is_last=True, top=True):
        tag = "" if top else ("└─ " if is_last else "├─ ")
        yield prefix + tag + self.traverse.get_text(node)
        child_prefix = prefix + ("" if top else ("   " if is_last else "│  "))
        kids = self.traverse.get_children(node)
        for i, c in enumerate(kids):
            yield from self._lines(c, child_prefix, i == len(kids) - 1, top=False)


# ----------------------------------------------------------------- values
class Source:
    """A photometric source (reference observation.py:582-597)."""

    def __init__(self, mag, e_mag, separation=0.0, pa=0.0, relative=False, is_reference=False):
        self.mag = float(mag)
        self.e_mag = float(e_mag)
        self.separation = float(separation)
        self.pa = float(pa)
        self.relative = bool(relative)
        self.is_reference = bool(is_reference)

    def __repr__(self):
        return f"({self.mag}, {self.e_mag}) @({self.separation}, {self.pa})"


class Star:
    """Theoretical counterpart of Source (reference observation.py:600-610)."""

    def __init__(self, pars, separation, pa):
        self.pars = pars
        self.separation = separation
        self.pa = pa

    def distance(self, other):
        return distance((self.separation, self.pa), (other.separation, other.pa))


class Observation:
    """One instrument/band image: named resolution + source list
    (reference observation.py:613-710)."""

    def __init__(self, name, band, resolution, sources=None, relative=False):
        self.name = name
        self.band = band
        self.resolution = resolution
        self.relative = relative
        self.sources = []
        for s in sources or []:
            self.add_source(s)
        self._set_reference()

    def add_source(self, source):
        """Insert keeping sources sorted by separation (observation.py:669-687)."""
        if not isinstance(source, Source):
            raise TypeError("Can only add Source object.")
        ind = 0
        for s in self.sources:
            if source.separation < s.separation:
                break
            ind += 1
        self.sources.insert(ind, source)

    @property
    def brightest(self):
        s0, mag0 = None, np.inf
        for s in self.sources:
            if s.mag < mag0:
                mag0, s0 = s.mag, s
        return s0

    def _set_reference(self):
        if self.sources:
            self.brightest.is_reference = True

    def observe(self, stars, unc, ic=None, rng=None):
        """Synthesize Sources for model stars (reference observation.py:640-667)."""
        if ic is None:
            from .isochrone import get_ichrone

            ic = get_ichrone("mist")
        rng = np.random.default_rng(rng)
        if len(stars) > 2:
            raise NotImplementedError("No support yet for > 2 synthetic stars")

        mags = [float(np.asarray(ic(*s.pars)[f"{self.band}_mag"])[0]) for s in stars]
        d = stars[0].distance(stars[1])
        if d < self.resolution:
            mag = addmags(*mags) + unc * rng.standard_normal()
            sources = [Source(mag, unc, stars[0].separation, stars[0].pa, relative=self.relative)]
        else:
            mags = np.array([m + unc * rng.standard_normal() for m in mags])
            if self.relative:
                mags -= mags.min()
            sources = [
                Source(m, unc, s.separation, s.pa, relative=self.relative)
                for m, s in zip(mags, stars)
            ]
        for s in sources:
            self.add_source(s)
        self._set_reference()

    def __repr__(self):
        return f"{self.name}-{self.band}"


# ------------------------------------------------------------------- tree
class ObservationTree(Node):
    """Assembles Observations into a source-matched hierarchy
    (reference observation.py:713-1302)."""

    spec_props = ["Teff", "logg", "feh", "density"]

    def __init__(self, observations=None, name=None):
        self.label = name if name is not None else "root"
        self.parent = None
        self.children = []
        self._leaves = None
        self._observations = []
        self._plan = None

        self._N = None
        self._index = None
        self.spectroscopy = {}
        self.limits = {}
        self.parallax = {}
        self.AV = {}
        self._Nstars = None

        for obs in observations or []:
            self.add_observation(obs)
        if not self._observations:
            self._build_tree()

    @property
    def name(self):
        return self.label

    def _on_leaves_changed(self):
        self._Nstars = None
        self._plan = None

    # --------------------------------------------------------- constructors
    @classmethod
    def from_df(cls, df, **kwargs):
        """Build from a table with columns
        (name, band, resolution, mag, e_mag, separation, pa, relative)
        (reference observation.py:771-789): a list of row dicts, a dict of
        columns or a DataFrame. Groups are taken in sorted (name, band)
        order, rows in table order within a group, as ``groupby`` does."""
        tree = cls(**kwargs)
        groups = {}
        for r in table_rows(df):
            groups.setdefault((str(r["name"]), str(r["band"])), []).append(r)
        for (n, b) in sorted(groups):
            g = groups[(n, b)]
            sources = [
                Source(
                    mag=r["mag"], e_mag=r["e_mag"], separation=r["separation"],
                    pa=r["pa"], relative=_as_bool(r["relative"]),
                )
                for r in g
            ]
            obs = Observation(n, b, float(np.mean([float(r["resolution"]) for r in g])), sources=sources,
                              relative=any(_as_bool(r["relative"]) for r in g))
            tree.add_observation(obs)
        return tree

    @classmethod
    def from_ini(cls, filename):
        """Build a tree from a ``star.ini`` file's photometry sections, with
        the ini machinery of
        :meth:`isochrones_torch.treemodel.StarModel.from_ini`."""
        from .iniparse import parse_ini
        from .treemodel import ini_photometry_rows

        rows = ini_photometry_rows(parse_ini(filename))
        if not rows:
            raise ValueError(f"No photometry sections found in {filename}")
        return cls.from_df(rows)

    def trim(self):
        """Trim unobserved leaves below the highest-resolution level.
        The reference's implementation is disabled (an unconditional early
        ``return``, observation.py:1100-1109); matched as a no-op."""
        return

    @classmethod
    def synthetic(cls, stars, surveys):
        """reference observation.py:1305-1306 (a stub there too)."""
        pass

    def to_df(self):
        """Round-trippable photometry table (reference
        observation.py:795-832), as a list of row dicts."""
        rows = []
        for o in self._observations:
            for s in o.sources:
                rows.append(
                    dict(name=o.name, band=o.band, resolution=o.resolution, mag=s.mag,
                         e_mag=s.e_mag, separation=s.separation, pa=s.pa, relative=s.relative)
                )
        return rows

    def save_hdf(self, filename, path="", overwrite=False, append=False):
        """Write the tree under the key prefix ``path`` of the ``.npz``
        container ``filename`` (reference observation.py:836-866, which
        writes HDF5): the photometry table as one record array
        ``obs/values`` and the attachments as JSON strings
        ``obs/attrs/<name>``. An existing ``obs`` entry raises unless
        ``overwrite`` (the file is replaced) or ``append`` (the entry is)."""
        import json
        import os

        prefix = store_prefix(path)
        entries = {}
        if os.path.exists(filename):
            entries = npz_load(filename)
            if f"{prefix}obs/values" in entries:
                if overwrite:
                    entries = {}
                elif not append:
                    raise IOError(f"{path} in {filename} exists. Set overwrite or append.")
        entries = {k: v for k, v in entries.items() if not k.startswith(f"{prefix}obs/")}

        rows = self.to_df()
        rec = np.zeros(len(rows), dtype=_OBS_DTYPE)
        for i, r in enumerate(rows):
            rec[i] = tuple(r[c] for c in OBS_COLUMNS)
        entries[f"{prefix}obs/values"] = rec
        attrs = dict(
            spectroscopy=self.spectroscopy,
            limits={l: {k: [None if not np.isfinite(x) else x for x in v] for k, v in d.items()}
                    for l, d in self.limits.items()},
            parallax={str(k): list(v) for k, v in self.parallax.items()},
            AV={str(k): list(v) for k, v in self.AV.items()},
            N=np.atleast_1d(self._N).tolist() if self._N is not None else None,
            index=np.asarray(self._index).tolist() if self._index is not None else None,
        )
        for k, v in attrs.items():
            entries[f"{prefix}obs/attrs/{k}"] = np.array(json.dumps(v))
        npz_save(filename, entries)

    @classmethod
    def load_hdf(cls, filename, path="", ic=None, device="cuda", dtype=None):
        """reference observation.py:868-897, from the ``.npz`` container.
        Without ``ic`` the synthetic grids are built on ``device`` (the card
        unless the caller names another) in ``dtype``."""
        import json

        prefix = store_prefix(path)
        entries = npz_load(filename)
        rec = entries[f"{prefix}obs/values"]
        rows = [{c: rec[c][i].item() for c in OBS_COLUMNS} for i in range(len(rec))]
        attrs = {k: json.loads(str(entries[f"{prefix}obs/attrs/{k}"]))
                 for k in ("spectroscopy", "limits", "parallax", "AV", "N", "index")}
        spectroscopy, limits, parallax, AV, N, index = (attrs[k] for k in
                                                        ("spectroscopy", "limits", "parallax", "AV", "N", "index"))

        new = cls.from_df(rows)
        if ic is None:
            from .isochrone import get_ichrone

            kw = {} if dtype is None else {"dtype": dtype}
            ic = get_ichrone("synthetic", device=device, **kw)
        if N is not None:
            new.define_models(ic, N=N, index=index)
        new.spectroscopy = {l: {k: tuple(v) for k, v in d.items()} for l, d in spectroscopy.items()}
        # non-finite endpoints serialize as None; restore POSITIONALLY
        # (index 0 -> -inf lower, index 1 -> +inf upper)
        _inf = (-np.inf, np.inf)
        new.limits = {
            l: {
                k: tuple(_inf[i] if x is None else x for i, x in enumerate(v))
                for k, v in d.items()
            }
            for l, d in limits.items()
        }
        new.parallax = {int(k): tuple(v) for k, v in parallax.items()}
        new.AV = {int(k): tuple(v) for k, v in AV.items()}
        return new

    def add_observation(self, obs):
        """Insert keeping decreasing-resolution order, rebuild hierarchy
        (reference observation.py:899-913)."""
        ind = 0
        for o in self._observations:
            if obs.resolution > o.resolution:
                break
            ind += 1
        self._observations.insert(ind, obs)
        self._build_tree()

    def add_spectroscopy(self, label="0_0", **props):
        """reference observation.py:916-940"""
        if label not in self.leaf_labels:
            raise ValueError(
                f"No model node named {label} (must be in {self.leaf_labels}). Maybe define models first?"
            )
        for k, v in props.items():
            if k not in self.spec_props:
                raise ValueError(f"Illegal property {k} (only {self.spec_props} allowed).")
            if len(v) != 2:
                raise ValueError(f"Must provide (value, uncertainty) for {k}.")
        self.spectroscopy.setdefault(label, {}).update(
            {k: tuple(float(x) for x in v) for k, v in props.items()}
        )
        self._plan = None

    def add_limit(self, label="0_0", **props):
        """reference observation.py:942-972"""
        if label not in self.leaf_labels:
            raise ValueError(
                f"No model node named {label} (must be in {self.leaf_labels}). Maybe define models first?"
            )
        d = self.limits.setdefault(label, {})
        for k, v in props.items():
            if k not in self.spec_props:
                raise ValueError(f"Illegal property {k} (only {self.spec_props} allowed).")
            vmin, vmax = v
            d[k] = (-np.inf if vmin is None else vmin, np.inf if vmax is None else vmax)
        self._plan = None

    def add_parallax(self, plax, system=0):
        if len(plax) != 2:
            raise ValueError("Must enter (value,uncertainty).")
        if system not in self.systems:
            raise ValueError(f"{system} not in systems ({self.systems}).")
        self.parallax[system] = tuple(plax)
        self._plan = None

    def add_AV(self, AV, system=0):
        if len(AV) != 2:
            raise ValueError("Must enter (value,uncertainty).")
        if system not in self.systems:
            raise ValueError(f"{system} not in systems ({self.systems}).")
        self.AV[system] = tuple(AV)
        self._plan = None

    def define_models(self, ic, leaves=None, N=1, index=0):
        """Attach model stars to the finest-resolution leaves
        (reference observation.py:997-1051)."""
        self.clear_models()
        if leaves is None:
            leaves = self._get_leaves()
        elif isinstance(leaves, str):
            leaves = self.select_leaves(leaves)

        N = np.atleast_1d(np.asarray(N, dtype=int) * np.ones(len(leaves), dtype=int))
        if np.isscalar(index) or np.ndim(index) == 0:
            index = [int(index)] * len(leaves)

        for s, n, i in zip(leaves, N, index):
            s.remove_children()
            s.add_model(ic, int(n), i)

        self._fix_labels()
        self._N = N
        self._index = index
        self._clear_all_leaves()

    def _fix_labels(self):
        """Ensure tag 0 is the brightest star in each system
        (reference observation.py:1053-1072)."""
        for s in self.systems:
            mag0, n0 = np.inf, None
            for n in self.get_system(s):
                if isinstance(n.parent, DummyObsNode):
                    continue
                mag, _ = n.parent.value
                if mag is not None and mag < mag0:
                    mag0, n0 = mag, n
            if n0 is not None and n0.tag != 0:
                other = self.get_leaf(f"{s}_0")
                other.tag = n0.tag
                n0.tag = 0

    def get_system(self, ind):
        return [l for l in self.leaves if getattr(l, "index", None) == ind]

    @property
    def observations(self):
        return self._observations

    def select_observations(self, name):
        return [n for n in self.get_obs_nodes() if n.obsname == name]

    def clear_models(self):
        for n in list(self):
            if isinstance(n, ModelNode):
                n.parent.remove_child(n.label)
        self._clear_all_leaves()

    # --------------------------------------------------------- param mapping
    def p2pardict(self, p):
        """Flat vector -> {star_label: [eep, age, feh, distance, AV]}
        (reference observation.py:1116-1128)."""
        d = {}
        N = self.Nstars
        i = 0
        for s in self.systems:
            age, feh, dist, AV = p[i + N[s] : i + N[s] + 4]
            for j in range(N[s]):
                d[f"{s}_{j}"] = [p[i + j], age, feh, dist, AV]
            i += N[s] + 4
        return d

    def print_ascii(self, fout=None, p=None):
        """Render the tree; with ``p`` (flat vector or pardict), annotate
        every node with model values and lnlikes (reference
        observation.py:1175-1179)."""
        pardict = None
        if p is not None:
            pardict = p if isinstance(p, dict) else self.p2pardict([float(x) for x in p])
        super().print_ascii(fout, pardict)

    def pardict2p(self, pardict):
        """reference observation.py:1130-1140"""
        pars = []
        N = self.Nstars
        for s in self.systems:
            for j in range(N[s]):
                pars.append(pardict[f"{s}_{j}"][0])
            pars += list(pardict[f"{s}_0"][1:])
        return pars

    @property
    def param_description(self):
        N = self.Nstars
        pars = []
        for s in self.systems:
            for j in range(N[s]):
                pars.append(f"eep_{s}_{j}")
            for p in ["age", "feh", "distance", "AV"]:
                pars.append(f"{p}_{s}")
        return pars

    @property
    def Nstars(self):
        if self._Nstars is None:
            N = {}
            for n in self.get_model_nodes():
                N[n.index] = N.get(n.index, 0) + 1
            self._Nstars = N
        return self._Nstars

    @property
    def systems(self):
        lst = []
        for c in self.children:
            lst.extend(c.systems)
        return sorted(set(lst))

    # ------------------------------------------------------------ likelihood
    def lnlike(self, pardict, model_values, use_cache=True):
        """Host-side per-node walk with the reference's semantics
        (observation.py:1181-1234). The batched path on the device is
        :func:`tree_lnlike_batch` via :meth:`plan`."""
        import math

        if not isinstance(pardict, dict):
            # reference accepts a flat parameter vector too
            # (observation.py:1181-1186)
            pardict = self.p2pardict(list(np.asarray(pardict, dtype=float)))

        lnl = 0
        for n in self:
            if n is not self:
                lnl += n.lnlike(model_values, use_cache=use_cache)
            if not np.isfinite(lnl):
                return -np.inf

        from .ops.likelihood import LOG_ONE_OVER_ROOT_2PI as const
        for l in self.spectroscopy:
            for prop, (val, err) in self.spectroscopy[l].items():
                mod = model_values[l][prop]
                lnl += -0.5 * (val - mod) ** 2 / err ** 2 + const + np.log(err)
            if not np.isfinite(lnl):
                return -np.inf

        for l in self.limits:
            for prop, (vmin, vmax) in self.limits[l].items():
                mod = model_values[l][prop]
                if mod < vmin or mod > vmax or not np.isfinite(mod):
                    return -np.inf

        for s, (val, err) in self.parallax.items():
            dist = pardict[f"{s}_0"][3]
            mod = 1000.0 / dist
            lnl += -0.5 * (val - mod) ** 2 / err ** 2 + const + np.log(err)

        for s, (val, err) in self.AV.items():
            AV = pardict[f"{s}_0"][4]
            lnl += -0.5 * (val - AV) ** 2 / err ** 2 + const + np.log(err)

        return lnl if np.isfinite(lnl) else -np.inf

    def plan(self, ic):
        """Compiled static evaluation plan (cached until the tree changes)."""
        if self._plan is None or self._plan.ic is not ic:
            self._plan = compile_plan(self, ic)
        return self._plan

    # --------------------------------------------------------- tree assembly
    def _find_closest(self, n0):
        """Closest node (on-sky) not in the same observation
        (reference observation.py:1236-1270)."""
        ds, nodes = [np.inf], [self]
        for n in self:
            if n is n0:
                continue
            try:
                if n._in_same_observation(n0):
                    continue
                ds.append(n.distance(n0))
                nodes.append(n)
            except AttributeError:
                pass
        # stable sort: ties (equal on-sky distance) resolve to the earliest
        # node in leaves-first iteration, i.e. the deepest chain tip
        for i in np.argsort(ds, kind="stable"):
            n = nodes[i]
            try:
                if ds[i] < n.resolution or n.resolution == -1:
                    return n
            except AttributeError:
                pass
        return self

    def _build_tree(self):
        """reference observation.py:1272-1302"""
        self._clear_all_leaves()
        self.children = []
        for i, o in enumerate(self._observations):
            s0 = o.brightest
            ref_node = ObsNode(o, s0)
            for s in o.sources:
                if s.relative and not s.is_reference:
                    node = ObsNode(o, s, ref_node=ref_node)
                elif s.relative and s.is_reference:
                    node = ref_node
                else:
                    node = ObsNode(o, s)
                parent = self if i == 0 else self._find_closest(node)
                parent.add_child(node)
        if not self.get_obs_nodes():
            self.add_child(DummyObsNode())


# ----------------------------------------------------------- compiled plan
@dataclasses.dataclass
class TreePlan:
    """Static flattening of an ObservationTree for batched evaluation."""

    ic: object
    star_labels: Tuple[str, ...]
    # (n_stars, 5): index into the flat param vector for each star's
    # (per-star param, age, feh, distance, AV) in ic user order
    star_param_idx: np.ndarray
    bands: Tuple[str, ...]
    # photometric obs rows
    member: np.ndarray  # (n_obs, n_stars) 0/1 membership
    obs_band: np.ndarray  # (n_obs,) index into bands
    obs_val: np.ndarray  # (n_obs,)
    obs_unc: np.ndarray  # (n_obs,)
    obs_ref: np.ndarray  # (n_obs,) row index of reference obs, -1 if absolute
    obs_active: np.ndarray  # (n_obs,) 0/1 (0 for nan-unc or self-reference rows)
    # spectroscopy rows: star row, property column (0=Teff 1=logg 2=feh 3=density)
    spec_star: np.ndarray
    spec_prop: np.ndarray
    spec_val: np.ndarray
    spec_unc: np.ndarray
    # limit rows
    lim_star: np.ndarray
    lim_prop: np.ndarray
    lim_lo: np.ndarray
    lim_hi: np.ndarray
    # parallax / AV (per system): param index of distance / AV, value, unc
    plax_idx: np.ndarray
    plax_val: np.ndarray
    plax_unc: np.ndarray
    av_idx: np.ndarray
    av_val: np.ndarray
    av_unc: np.ndarray
    n_params: int


def compile_plan(tree: ObservationTree, ic) -> TreePlan:
    """Flatten the tree into a :class:`TreePlan`."""
    stars = sorted(tree.get_model_nodes(), key=lambda n: (n.index, n.tag))
    star_labels = tuple(n.label for n in stars)
    label_to_row = {l: r for r, l in enumerate(star_labels)}

    # param layout: per system [per-star x N, age, feh, distance, AV]
    N = tree.Nstars
    systems = tree.systems
    sys_base = {}
    i = 0
    for s in systems:
        sys_base[s] = i
        i += N[s] + 4
    n_params = i

    star_param_idx = np.zeros((len(stars), 5), dtype=np.int32)
    for r, n in enumerate(stars):
        base = sys_base[n.index]
        star_param_idx[r] = [
            base + n.tag,
            base + N[n.index],
            base + N[n.index] + 1,
            base + N[n.index] + 2,
            base + N[n.index] + 3,
        ]

    # photometric rows
    obs_nodes = [n for n in tree.get_obs_nodes() if not isinstance(n, DummyObsNode)]
    bands = tuple(sorted({n.band for n in obs_nodes}))
    band_idx = {b: i for i, b in enumerate(bands)}
    node_row = {id(n): i for i, n in enumerate(obs_nodes)}

    n_obs = len(obs_nodes)
    member = np.zeros((n_obs, len(stars)))
    obs_band = np.zeros(n_obs, dtype=np.int32)
    obs_val = np.zeros(n_obs)
    obs_unc = np.ones(n_obs)
    obs_ref = np.full(n_obs, -1, dtype=np.int32)
    obs_active = np.ones(n_obs)
    for i, n in enumerate(obs_nodes):
        for leaf in n.leaves:
            if isinstance(leaf, ModelNode):
                member[i, label_to_row[leaf.label]] = 1.0
        obs_band[i] = band_idx[n.band]
        mag, unc = n.value
        obs_val[i] = mag
        obs_unc[i] = unc if np.isfinite(unc) else 1.0
        if not np.isfinite(unc):
            # NaN and inf uncertainties both mean "unconstrained": an inf-unc
            # row left active with the 1.0 placeholder would invent a
            # full-strength Gaussian term
            obs_active[i] = 0.0
        if n.relative:
            if n.reference is None or n.reference is n:
                obs_active[i] = 0.0
            elif id(n.reference) not in node_row:
                # orphaned reference (mixed per-source relative flags where
                # the brightest source was non-relative, so its ref_node was
                # never attached): the delta-mag has no anchor: deactivate
                # rather than crash
                getLogger().warning(
                    "compile_plan: relative node %s has a reference outside "
                    "the tree; deactivating it", n.label
                )
                obs_active[i] = 0.0
            else:
                obs_ref[i] = node_row[id(n.reference)]
        if not any(isinstance(l, ModelNode) for l in n.leaves):
            obs_active[i] = 0.0

    prop_idx = {"Teff": 0, "logg": 1, "feh": 2, "density": 3}
    spec_star, spec_prop, spec_val, spec_unc = [], [], [], []
    for label, props in tree.spectroscopy.items():
        for k, (val, unc) in props.items():
            spec_star.append(label_to_row[label])
            spec_prop.append(prop_idx[k])
            spec_val.append(val)
            spec_unc.append(unc)

    lim_star, lim_prop, lim_lo, lim_hi = [], [], [], []
    for label, props in tree.limits.items():
        for k, (lo, hi) in props.items():
            lim_star.append(label_to_row[label])
            lim_prop.append(prop_idx[k])
            lim_lo.append(lo)
            lim_hi.append(hi)

    plax_idx, plax_val, plax_unc = [], [], []
    for s, (val, unc) in tree.parallax.items():
        plax_idx.append(sys_base[s] + N[s] + 2)
        plax_val.append(val)
        plax_unc.append(unc)

    av_idx, av_val, av_unc = [], [], []
    for s, (val, unc) in tree.AV.items():
        av_idx.append(sys_base[s] + N[s] + 3)
        av_val.append(val)
        av_unc.append(unc)

    return TreePlan(
        ic=ic,
        star_labels=star_labels,
        star_param_idx=star_param_idx,
        bands=bands,
        member=member,
        obs_band=obs_band,
        obs_val=obs_val,
        obs_unc=obs_unc,
        obs_ref=obs_ref,
        obs_active=obs_active,
        spec_star=np.asarray(spec_star, dtype=np.int32),
        spec_prop=np.asarray(spec_prop, dtype=np.int32),
        spec_val=np.asarray(spec_val, dtype=float),
        spec_unc=np.asarray(spec_unc, dtype=float),
        lim_star=np.asarray(lim_star, dtype=np.int32),
        lim_prop=np.asarray(lim_prop, dtype=np.int32),
        lim_lo=np.asarray(lim_lo, dtype=float),
        lim_hi=np.asarray(lim_hi, dtype=float),
        plax_idx=np.asarray(plax_idx, dtype=np.int32),
        plax_val=np.asarray(plax_val, dtype=float),
        plax_unc=np.asarray(plax_unc, dtype=float),
        av_idx=np.asarray(av_idx, dtype=np.int32),
        av_val=np.asarray(av_val, dtype=float),
        av_unc=np.asarray(av_unc, dtype=float),
        n_params=n_params,
    )


def make_tree_lnlike_fused(plan: TreePlan):
    """Build the batched ``(B, n_params) -> (ll (B,), orig_val (B, n_stars),
    deriv (B, n_stars))`` call of a plan on the device of its interpolator:
    the tree log-likelihood and, per model star (in the order of
    ``plan.star_labels``), the EEP prior's quantity and its d/dEEP
    derivative from the same interpolation. The plan's arrays go to the
    device once; each call is one
    :func:`~isochrones_torch.ops.tree.tree_lnlike_fused`."""
    from .ops.tree import TreeLikelihood, tree_lnlike_fused

    lk = TreeLikelihood.from_plan(plan)

    def lnlike_fused(p):
        return tree_lnlike_fused(p, lk)

    lnlike_fused.likelihood = lk
    return lnlike_fused


def make_tree_lnlike(plan: TreePlan):
    """Build the batched ``(B, n_params) -> (B,)`` tree log-likelihood of a
    plan on the device of its interpolator: ``ll`` of
    :func:`make_tree_lnlike_fused`."""
    fused = make_tree_lnlike_fused(plan)

    def lnlike_batch(p):
        return fused(p)[0]

    lnlike_batch.likelihood = fused.likelihood
    return lnlike_batch


def tree_lnlike_batch(tree: ObservationTree, ic, p):
    """Convenience: compile (cached) + evaluate. ``p`` is a tensor on the
    device of ``ic``, or anything ``torch.as_tensor`` takes."""
    import torch

    p = torch.as_tensor(p, dtype=ic.dtype, device=ic.device)
    return make_tree_lnlike(tree.plan(ic))(p)
