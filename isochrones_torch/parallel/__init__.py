"""Device meshes for the fit engines (counterpart of
``isochrones_tpu/parallel/__init__.py``).

The JAX package's mesh is single-controller SPMD: one process drives its
local devices. The same shape here: a :class:`Mesh` is an ordered tuple of
``torch.device``s of one type with its axis names, and one process drives
it. What is split is the likelihood fan-out, which is embarrassingly
parallel over walkers, live points, runs, chains and stars:

* :func:`mesh_wrap_fn` splits the leading axis of every tensor argument into
  one piece per shard (``torch.tensor_split``: uneven sizes are fine, so
  nothing is padded), moves each piece to its shard's device, calls the
  function on every shard before it waits on any (CUDA launches are
  asynchronous, so shards on several cards overlap), and concatenates the
  results on the mesh's first device;
* the cluster model splits its star axis and sums the shards' partial
  likelihoods on the first device (``StarClusterModel(mesh=)``).

A sampler's own state, its sorting and its ``torch.Generator`` stay on the
mesh's first device, so a sharded fit is the unsharded one wherever a
kernel's arithmetic for one point does not depend on the batch. Read-only
tables (:class:`~isochrones_torch.ops.interp.GridData`, the interpolators,
a model's observations) are copied once to each distinct device of the mesh
(:func:`replicate`). A mesh may repeat a device: several shards on one card.
Fleets of independent fits across processes are
:mod:`isochrones_torch.parallel.multihost`.
"""

from __future__ import annotations

import copy
import dataclasses
import types
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "default_mesh",
    "shard_batch",
    "replicate",
    "sharded_lnpost",
    "pad_to_multiple",
    "mesh_constrain_leading",
    "mesh_wrap_fn",
]


def _device(d) -> torch.device:
    """``d`` as a torch device with its index: a bare ``"cuda"`` is the
    current card, and a CUDA device must exist."""
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise ValueError(f"a mesh on {d} needs a CUDA card; torch.cuda.is_available() is False")
        index = torch.cuda.current_device() if d.index is None else d.index
        if not 0 <= index < torch.cuda.device_count():
            raise ValueError(f"{d}: this machine has {torch.cuda.device_count()} CUDA device(s)")
        return torch.device("cuda", index)
    if d.type == "cpu":
        return torch.device("cpu")
    return d


class Mesh:
    """An ordered tuple of devices of one type (one shard each; a device may
    repeat) and the names of the mesh's axes. The shards lie along the first
    axis; ``shape`` maps each axis name to its size, as the JAX mesh's does."""

    def __init__(self, devices, axis_names: Sequence[str] = ("walkers",)):
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        devices = tuple(_device(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        kinds = sorted({d.type for d in devices})
        if len(kinds) > 1:
            raise ValueError(f"a mesh holds devices of one type, got {kinds}")
        if not axis_names:
            raise ValueError("a mesh needs at least one axis name")
        self.devices = devices
        self.axis_names = tuple(str(a) for a in axis_names)

    @property
    def shape(self):
        return {a: (len(self.devices) if i == 0 else 1) for i, a in enumerate(self.axis_names)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self):
        """The mesh's devices without repeats, in order."""
        return tuple(dict.fromkeys(self.devices))

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, axis_names={self.axis_names})"


def check_mesh(mesh, device=None) -> Mesh:
    """``mesh`` if it is a :class:`Mesh` (else a ``TypeError``) whose first
    device, where a sampler's state lives, is ``device`` when given (else a
    ``ValueError``)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be an isochrones_torch.parallel.Mesh, got {type(mesh).__name__}")
    if device is not None and mesh.devices[0] != _device(device):
        raise ValueError(f"the mesh's first device {mesh.devices[0]} must be the sampler's ({device})")
    return mesh


def default_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("walkers",), device="cuda") -> Mesh:
    """A mesh over the first ``n_devices`` CUDA cards (all of them by
    default); more than the machine has, or a CUDA mesh without a card, is a
    ``ValueError``. ``device="cpu"`` gives ``n_devices`` shards on the CPU
    (one by default), the counterpart of XLA's forced host device count."""
    kind = torch.device(device).type
    if kind == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise ValueError("default_mesh: no CUDA card (torch.cuda.is_available() is False)")
        n = count if n_devices is None else int(n_devices)
        if not 1 <= n <= count:
            raise ValueError(f"default_mesh: asked for {n} CUDA devices, this machine has {count}")
        return Mesh([torch.device("cuda", i) for i in range(n)], axis_names)
    if kind == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"default_mesh: asked for {n} shards")
        return Mesh([torch.device("cpu")] * n, axis_names)
    raise ValueError(f"default_mesh: device must be cuda or cpu, got {device!r}")


def _check_axis(mesh: Mesh, axis: str):
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not an axis of {mesh!r}")


def shard_sizes(n: int, mesh: Mesh):
    """Rows of each shard when ``n`` rows are split over ``mesh``: the first
    ``n % size`` shards take one more, as ``torch.tensor_split`` and
    ``numpy.array_split`` split them."""
    base, extra = divmod(int(n), check_mesh(mesh).size)
    return [base + (1 if k < extra else 0) for k in range(mesh.size)]


def _split(x, mesh: Mesh):
    """One piece per shard of ``x``: a tensor with a leading axis is split
    along it and each piece moved to its shard's device; containers are split
    leaf by leaf; anything else (None, a 0-d tensor, a number) goes whole to
    every shard (a 0-d tensor on the shard's device)."""
    n = mesh.size
    if isinstance(x, torch.Tensor):
        if x.dim() == 0:
            return [x.to(d) for d in mesh.devices]
        return [p.to(d) for p, d in zip(torch.tensor_split(x, n, dim=0), mesh.devices)]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        cols = [_split(v, mesh) for v in x]
        return [type(x)(*(c[k] for c in cols)) for k in range(n)]
    if isinstance(x, (tuple, list)):
        cols = [_split(v, mesh) for v in x]
        return [type(x)(c[k] for c in cols) for k in range(n)]
    if isinstance(x, dict):
        cols = {key: _split(v, mesh) for key, v in x.items()}
        return [{key: c[k] for key, c in cols.items()} for k in range(n)]
    return [x] * n


def _leading_sizes(tree):
    """Leading sizes of the tensors (of one dimension or more) in ``tree``."""
    if isinstance(tree, torch.Tensor):
        return [tree.shape[0]] if tree.dim() > 0 else []
    if isinstance(tree, (tuple, list)):
        return [s for v in tree for s in _leading_sizes(v)]
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _leading_sizes(v)]
    return []


def _gather(outs, device):
    """Concatenate the shards' results leaf by leaf along the leading axis on
    ``device``; None stays None."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(device) for o in outs])
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_gather([o[i] for o in outs], device) for i in range(len(first))))
    if isinstance(first, (tuple, list)):
        return type(first)(_gather([o[i] for o in outs], device) for i in range(len(first)))
    if isinstance(first, dict):
        return {key: _gather([o[key] for o in outs], device) for key in first}
    raise TypeError(f"mesh_wrap_fn: cannot concatenate results of type {type(first).__name__}")


def mesh_constrain_leading(tree, mesh: Mesh):
    """The per-shard pieces of ``tree``: a list of one tree per shard of
    ``mesh``, every tensor's LEADING axis split over the shards (the
    independent runs / chains / stars axes every fit engine shards) and each
    piece on its shard's device."""
    return _split(tree, check_mesh(mesh))


def _per_shard(fn, mesh: Mesh):
    if callable(fn):
        return [fn] * mesh.size
    fns = list(fn)
    if len(fns) != mesh.size or not all(callable(f) for f in fns):
        raise ValueError(f"mesh_wrap_fn takes a callable or one callable per shard ({mesh.size}), got {fn!r}")
    return fns


def _call_shards(fns, mesh: Mesh, pieces):
    """Call ``fns[k](*pieces[k])`` for every shard whose pieces hold rows (all
    before waiting on any) and concatenate the results on the first device.
    With no rows at all, the first shard's function takes its (empty) pieces."""
    live = [k for k in range(mesh.size) if 0 not in _leading_sizes(pieces[k])] or [0]
    return _gather([fns[k](*pieces[k]) for k in live], mesh.devices[0])


def mesh_wrap_fn(fn, mesh: Mesh):
    """Shard ``fn`` over ``mesh``'s first axis: the one mesh-plumbing helper
    every fit engine shares (nested, NUTS, ensemble, batch). The wrapped
    function splits the leading axis of every tensor argument with
    ``torch.tensor_split`` (containers leaf by leaf; uneven sizes are fine),
    moves each piece to its shard's device, calls ``fn`` on every shard
    before it waits on any, and concatenates the results (tensors, or tuples
    and dicts of them) on the mesh's first device. A shard that gets no rows
    is not called. ``fn`` is a callable, or one callable per shard (a shard's
    own tables or data)."""
    mesh = check_mesh(mesh)
    fns = _per_shard(fn, mesh)

    def wrapped(*args):
        cols = [_split(a, mesh) for a in args]
        return _call_shards(fns, mesh, [tuple(c[k] for c in cols) for k in range(mesh.size)])

    return wrapped


def shard_batch(x: torch.Tensor, mesh: Mesh, axis: str = "walkers"):
    """``x``'s leading axis split over ``axis``: a list of one piece per shard,
    each on its shard's device."""
    mesh = check_mesh(mesh)
    _check_axis(mesh, axis)
    return _split(torch.as_tensor(x), mesh)


def sharded_lnpost(lnpost_batch, mesh: Mesh, axis: str = "walkers"):
    """Wrap a batched ``(B, n_params) -> (B,)`` posterior so its batch shards
    over ``axis``: pure data parallel, each shard evaluates its slice (the
    role MPI plays for MultiNest, reference starmodel.py:755-762). The
    wrapped function takes the whole batch or :func:`shard_batch`'s pieces
    and gives back the whole ``(B,)`` result on the mesh's first device."""
    mesh = check_mesh(mesh)
    _check_axis(mesh, axis)
    wrapped = mesh_wrap_fn(lnpost_batch, mesh)
    fns = _per_shard(lnpost_batch, mesh)

    def call(x):
        if isinstance(x, (list, tuple)):
            if len(x) != mesh.size:
                raise ValueError(f"expected {mesh.size} shards, got {len(x)}")
            return _call_shards(fns, mesh, [(p.to(d),) for p, d in zip(x, mesh.devices)])
        return wrapped(x)

    return call


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, fill=np.nan):
    """Pad the batch axis so it divides evenly across devices. Returns
    (padded, n_valid)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, rem)
    return np.pad(x, pad_width, constant_values=fill), n


# ----------------------------------------------------------------- replicas
_PLAIN = (str, bytes, int, float, complex, bool, type(None), np.ndarray, np.generic, torch.device, torch.dtype,
          type, types.FunctionType, types.BuiltinFunctionType, types.MethodType, types.ModuleType)


def _home_device(obj, seen=None):
    """The device of the first tensor found in ``obj``, or None."""
    seen = set() if seen is None else seen
    if id(obj) in seen or isinstance(obj, _PLAIN):
        return None
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return obj.device
    if isinstance(getattr(obj, "device", None), torch.device) and not isinstance(obj, torch.Generator):
        return _device(obj.device)
    if dataclasses.is_dataclass(obj):
        children = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, (tuple, list)):
        children = list(obj)
    elif isinstance(obj, dict):
        children = list(obj.values())
    elif type(obj).__module__.startswith("isochrones_torch") and hasattr(obj, "__dict__"):
        children = list(vars(obj).values())
    else:
        return None
    for c in children:
        d = _home_device(c, seen)
        if d is not None:
            return d
    return None


def _moved(obj, device, memo):
    """A copy of ``obj`` on ``device``: tensors moved, dataclasses (``GridData``,
    the likelihoods' tables), containers and the port's own objects (the
    interpolators, priors, models) copied with their members moved; shared
    members stay shared (``memo``). A copied object's ``_fn_cache`` starts
    empty: its closures are built again on the copy's tables."""
    key = id(obj)
    if key in memo:
        return memo[key]
    if isinstance(obj, _PLAIN) or isinstance(obj, torch.Generator):
        return obj
    if isinstance(obj, torch.Tensor):
        out = memo[key] = obj.to(device)
        return out
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = memo[key] = copy.copy(obj)
        for f in dataclasses.fields(obj):
            object.__setattr__(out, f.name, _moved(getattr(obj, f.name), device, memo))
        return out
    if isinstance(obj, tuple):
        items = [_moved(v, device, memo) for v in obj]
        out = memo[key] = type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
        return out
    if isinstance(obj, list):
        out = memo[key] = []
        out.extend(_moved(v, device, memo) for v in obj)
        return out
    if type(obj) is dict:
        out = memo[key] = {}
        out.update((k, _moved(v, device, memo)) for k, v in obj.items())
        return out
    if type(obj).__module__.startswith("isochrones_torch") and hasattr(obj, "__dict__"):
        out = memo[key] = copy.copy(obj)
        for k, v in vars(obj).items():
            out.__dict__[k] = {} if k == "_fn_cache" else _moved(v, device, memo)
        return out
    return obj


def replicas(obj, mesh: Mesh):
    """``{device: obj on that device}`` for every distinct device of
    ``mesh``; on the object's own device the object itself."""
    mesh = check_mesh(mesh)
    home = _home_device(obj)
    return {d: obj if d == home else _moved(obj, d, {}) for d in mesh.distinct_devices}


def replicate(tree, mesh: Mesh):
    """Copy ``tree`` (a tensor, a ``GridData``, an interpolator and its
    tables, a model, or containers of them) to every distinct device of
    ``mesh``, one copy a device. A mesh of one distinct device gives that
    copy, which is ``tree`` itself where ``tree`` already lies there; a mesh
    of several gives ``{device: copy}``."""
    reps = replicas(tree, mesh)
    return next(iter(reps.values())) if len(reps) == 1 else reps


class ByDevice:
    """A callable that calls the function of the device its first tensor
    argument lies on (one function per distinct device of a mesh, each over
    its own copy of a model's tables)."""

    def __init__(self, fns):
        self.fns = dict(fns)

    def __call__(self, *args, **kwargs):
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        return self.fns[_device(dev)](*args, **kwargs)
