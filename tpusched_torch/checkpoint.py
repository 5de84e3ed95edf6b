"""Workload checkpoint and resume over ``torch.distributed.checkpoint``.

Counterpart of ``tpusched/jaxbridge/checkpoint.py``, which saves with orbax.
A gang the scheduler preempts and places again, possibly on a different
mesh, saves its train state (params, the step, optionally the optimizer
state) and restores it with each rank reading only its own slices: no leaf
is ever gathered whole on one rank.

The port's tensors carry no sharding, so a spec tree says how each leaf is
cut: ``workload.param_specs`` of the mesh, one mesh axis name or None a
dim. On a mesh every shard is saved as a ``DTensor`` on the mesh's
``DeviceMesh`` (``Mesh.device_mesh``): ``Shard(d)`` on the mesh dim whose
axis the spec puts on dim d, ``Replicate()`` on every other, which are
``mesh.local_chunk``'s equal chunks. Restoring into DTensors built the same
way on another mesh reshards. Without a process group the checkpoint is
one process's. AdamW state (``optim.AdamWState``) goes as ``extra``: mu and
nu take their parameter's spec, ``count`` is an int.

A save writes ``step_XXXXXXXX.tmp-<nonce>`` and renames it to
``step_XXXXXXXX`` once every rank has written, so a crashed save leaves
only a directory that :func:`latest_step` skips, and the last good
snapshot loads. :func:`export_for_serving` writes the params alone, cast
to the compute dtype, as ``serving_XXXXXXXX``; :func:`load_for_serving`
reads them back whole, or this rank's tensor-parallel shards on a mesh,
which ``serve.ServeEngine(mesh=)`` takes as they are.

Every entry point that makes tensors runs on the card unless given
``device="cpu"``; on a mesh it uses ``mesh.device``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import uuid
import warnings
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .optim import AdamWState
from .workload import (ModelConfig, Params, cast_params_for_compute,
                       param_dtype, param_shapes, param_specs, resolve_device,
                       shard_shape)


@dataclasses.dataclass(frozen=True)
class Abstract:
    """A leaf's skeleton for :func:`restore`: its whole shape and dtype,
    and the spec it is read into (one mesh axis name or None a dim; None
    for a whole leaf)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Optional[Tuple] = None


# -- trees --------------------------------------------------------------------


def _leaves(tree, specs=None, prefix: str = ""):
    """(path, leaf, spec) of every leaf of a tree of dicts, lists and
    AdamW states, ``specs`` a tree of the same structure down to the leaves
    (or None). An AdamW state's mu and nu take ``specs``, its count none."""
    if isinstance(tree, AdamWState):
        for name in ("count", "mu", "nu"):
            yield from _leaves(getattr(tree, name),
                               None if name == "count" else specs,
                               f"{prefix}{name}.")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, None if specs is None else specs[k],
                               f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, None if specs is None else specs[i],
                               f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree, specs


def _rebuild(tree, values: Dict[str, Any], prefix: str = ""):
    """``tree``'s structure with the leaf at each path from ``values``."""
    if isinstance(tree, AdamWState):
        return AdamWState(**{name: _rebuild(getattr(tree, name), values,
                                            f"{prefix}{name}.")
                             for name in ("count", "mu", "nu")})
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    return values[prefix[:-1]]


# -- skeletons ----------------------------------------------------------------


def _abstract(shape, dtype, spec, mesh) -> Abstract:
    shape = tuple(int(n) for n in shape)
    if spec is not None and mesh is not None:
        for n, name in zip(shape, spec):
            if name is None:
                continue
            if name not in mesh.shape:
                raise ValueError(f"spec {spec} names {name!r}, not an axis "
                                 f"of {mesh.shape}")
            if n % mesh.shape[name]:
                raise ValueError(f"dim of {n} does not split over {name} of "
                                 f"{mesh.shape[name]}")
    return Abstract(shape, dtype, None if spec is None else tuple(spec))


def param_skeleton(cfg: ModelConfig, compute: bool = False) -> Params:
    """The parameter tree's skeleton from ``workload.param_shapes``, no
    initialization: master dtypes, or with ``compute`` the dtypes of
    ``workload.cast_params_for_compute`` (the router stays f32)."""
    def dtype(name):
        if compute and cfg.master_dtype != cfg.dtype and name != "router":
            return cfg.dtype
        return param_dtype(cfg, name)

    shapes = param_shapes(cfg)
    out: Params = {k: Abstract(shapes[k], dtype(k))
                   for k in ("embed", "out", "ln_f")}
    out["layers"] = [{k: Abstract(s, dtype(k)) for k, s in layer.items()}
                     for layer in shapes["layers"]]
    return out


def abstract_state(params_or_shapes, specs=None, mesh=None):
    """The skeleton :func:`restore` reads into: each leaf's whole shape and
    dtype (from a whole tensor or an :class:`Abstract`) with its TARGET
    spec from ``specs`` (``workload.param_specs(cfg, mesh)`` of the new
    mesh; None: whole leaves). ``mesh`` checks that every spec's axis is on
    it and divides its dim."""
    values = {}
    for path, leaf, spec in _leaves(params_or_shapes, specs):
        values[path] = (_abstract(leaf.shape, leaf.dtype, spec, mesh)
                        if isinstance(leaf, (torch.Tensor, Abstract))
                        else leaf)
    return _rebuild(params_or_shapes, values)


def abstract_like(tree, specs=None, mesh=None):
    """The skeleton of a tree of this rank's shards, each leaf read back
    with the spec it has: its whole shape is its shard's times the sizes of
    its spec's axes on ``mesh``. For optimizer state: init it on the new
    mesh's shards, then restore the saved moments into this skeleton (an
    AdamW state's mu and nu take ``specs``, the parameters')."""
    values = {}
    for path, leaf, spec in _leaves(tree, specs):
        if isinstance(leaf, torch.Tensor):
            whole = (leaf.shape if spec is None or mesh is None else
                     [n if a is None else n * mesh.shape[a]
                      for n, a in zip(leaf.shape, spec)])
            leaf = _abstract(whole, leaf.dtype, spec, mesh)
        values[path] = leaf
    return _rebuild(tree, values)


# -- DCP ----------------------------------------------------------------------


def _sharded(mesh) -> bool:
    """Whether ``mesh`` runs over a process group (else its leaves are
    whole: a mesh of one rank without one is read as no mesh)."""
    if mesh is None:
        return False
    if not dist.is_initialized():
        if mesh.size > 1:
            raise RuntimeError(f"mesh {mesh.shape} has no process group: "
                               f"build it with mesh.build_named_mesh")
        return False
    return True


def _dtensor(local: torch.Tensor, spec, mesh):
    """``local``, this rank's slice by ``spec``, as a DTensor of the whole
    leaf on the mesh's DeviceMesh."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dm = mesh.device_mesh()
    spec = tuple(spec) if spec is not None else (None,) * local.dim()
    placements = [Shard(spec.index(a)) if a in spec else Replicate()
                  for a in mesh.axis_names]
    whole = [n if a is None else n * mesh.shape[a]
             for n, a in zip(local.shape, spec)]
    stride, acc = [], 1
    for n in reversed(whole):
        stride.insert(0, acc)
        acc *= n
    local = local.detach().to(dm.device_type).contiguous()
    return DTensor.from_local(local, dm, placements, run_check=False,
                              shape=torch.Size(whole), stride=tuple(stride))


@contextlib.contextmanager
def _one_process_quiet():
    """DCP warns on every call without a process group that it saves or
    loads in one process, which is what is meant here."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled, unavailable or uninitialized")
        yield


def _path(directory: str, prefix: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"{prefix}{step:08d}")


def _write(path: str, tree, step: int, mesh, specs) -> None:
    """Save ``tree`` (leaves this rank's slices by ``specs``) and ``step``
    into ``path`` through a temporary directory renamed once every rank
    has written."""
    import torch.distributed.checkpoint as dcp
    if mesh is not None and specs is None:
        raise ValueError("a save on a mesh needs the specs its leaves were "
                         "cut by (workload.param_specs)")
    sharded = _sharded(mesh)
    state: Dict[str, Any] = {"step": int(step)}
    for key, leaf, spec in _leaves(tree, specs):
        if isinstance(leaf, torch.Tensor):
            leaf = _dtensor(leaf, spec, mesh) if sharded else leaf.detach()
        state[key] = leaf
    distributed = dist.is_initialized()
    nonce = [uuid.uuid4().hex]
    if distributed:              # one temporary directory for every rank
        dist.broadcast_object_list(nonce, src=0)
    tmp = f"{path}.tmp-{nonce[0]}"
    with _one_process_quiet():
        dcp.save(state, checkpoint_id=tmp, no_dist=not distributed)
    if distributed:
        dist.barrier()
    if not distributed or dist.get_rank() == 0:
        os.rename(tmp, path)
    if distributed:
        dist.barrier()


def _read(path: str, tree, mesh, device) -> Tuple[Any, int]:
    """``tree`` (a skeleton) read from ``path``: each :class:`Abstract`
    leaf this rank's slice by its spec on ``mesh``, or whole without one,
    on the device. Returns (tree, step)."""
    import torch.distributed.checkpoint as dcp
    if mesh is not None and mesh.device is not None:
        device = mesh.device
    device = resolve_device(device)
    sharded = _sharded(mesh)
    state: Dict[str, Any] = {"step": 0}
    for key, leaf, _ in _leaves(tree):
        if isinstance(leaf, Abstract):
            if sharded:
                spec = leaf.spec or (None,) * len(leaf.shape)
                local = torch.empty(shard_shape(leaf.shape, spec, mesh),
                                    dtype=leaf.dtype)
                leaf = _dtensor(local, spec, mesh)
            else:
                leaf = torch.empty(leaf.shape, dtype=leaf.dtype,
                                   device=device)
        state[key] = leaf
    with _one_process_quiet():
        dcp.load(state, checkpoint_id=path,
                 no_dist=not dist.is_initialized())
    values = {}
    for key, leaf in state.items():
        if sharded and hasattr(leaf, "to_local"):
            leaf = leaf.to_local().to(device)
        values[key] = leaf
    return _rebuild(tree, values), int(values["step"])


# -- the reference's API ------------------------------------------------------


def save(directory: str, params: Params, step: int, extra: Any = None,
         mesh=None, specs=None) -> None:
    """Save the train state: ``params`` (this rank's shards by ``specs`` on
    ``mesh``, or whole without one), ``step`` and ``extra`` (typically the
    ``optim.AdamWState``, whose mu and nu take ``specs`` too; any other
    tree is saved whole). Every rank of the mesh calls it together.
    ``directory`` must not hold a checkpoint of this step already."""
    tree: Dict[str, Any] = {"params": params}
    tree_specs = None if specs is None else {"params": specs}
    if extra is not None:
        tree["extra"] = extra
        if specs is not None:
            tree_specs["extra"] = (specs if isinstance(extra, AdamWState)
                                   else None)
    _write(_path(directory, "step_", step), tree, step, mesh, tree_specs)


def _latest(directory: str, prefix: str) -> Optional[int]:
    """The highest numeric suffix among ``<prefix><NNN>`` entries. A
    non-numeric suffix is skipped, not fatal: a crashed save leaves a
    temporary directory (``step_00000007.tmp-...``, or orbax's
    ``.orbax-checkpoint-tmp-...``) beside good snapshots, and the last good
    one must still load."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return None
    steps = []
    for n in names:
        if n.startswith(prefix):
            try:
                steps.append(int(n[len(prefix):]))
            except ValueError:
                continue
    return max(steps) if steps else None


def latest_step(directory: str) -> Optional[int]:
    return _latest(directory, "step_")


def latest_serving_step(directory: str) -> Optional[int]:
    return _latest(directory, "serving_")


def restore(directory: str, abstract: Params, mesh=None,
            step: Optional[int] = None, abstract_extra: Any = None,
            device=None):
    """Restore the train state into the skeleton ``abstract`` (from
    :func:`abstract_state`): on ``mesh`` this rank's shards by each leaf's
    spec, on ``mesh.device``; without one whole tensors on ``device``. A
    state saved on one mesh restores onto any other. The latest step when
    ``step`` is None (FileNotFoundError when there is none). Returns
    (params, step), or (params, step, extra) with ``abstract_extra`` (e.g.
    :func:`abstract_like` of ``init_opt`` on the new mesh)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    tree = {"params": abstract}
    if abstract_extra is not None:
        tree["extra"] = abstract_extra
    out, saved = _read(_path(directory, "step_", step), tree, mesh, device)
    if abstract_extra is not None:
        return out["params"], saved, out["extra"]
    return out["params"], saved


def export_for_serving(directory: str, params: Params, cfg: ModelConfig,
                       step: int = 0) -> str:
    """The train → serve hand-off: the whole params alone (no optimizer
    state), cast once to the compute dtype
    (``workload.cast_params_for_compute``), so a serving load reads no
    master bytes. Returns the written path."""
    path = _path(directory, "serving_", step)
    _write(path, {"params": cast_params_for_compute(params, cfg)}, step,
           None, None)
    return path


def load_for_serving(directory: str, cfg: ModelConfig, mesh=None,
                     step: Optional[int] = None, device=None) -> Params:
    """A serving snapshot's params in the compute dtype, from a skeleton
    of ``workload.param_shapes`` (no initialization): whole on ``device``,
    or with ``mesh`` only this rank's slices by ``workload.param_specs``
    (the shards ``ServeEngine(mesh=)`` serves), on ``mesh.device``. The
    latest snapshot when ``step`` is None."""
    if step is None:
        step = latest_serving_step(directory)
        if step is None:
            raise FileNotFoundError(f"no serving snapshot under {directory}")
    abstract = abstract_state(param_skeleton(cfg, compute=True),
                              None if mesh is None
                              else param_specs(cfg, mesh), mesh)
    out, _ = _read(_path(directory, "serving_", step), {"params": abstract},
                   mesh, device)
    return out["params"]
