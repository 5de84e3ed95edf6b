"""Named device meshes over ``torch.distributed``, and the collectives of
tensor and data parallelism on them.

Counterpart of ``tpusched/jaxbridge/mesh.py``. The reference builds a
``jax.sharding.Mesh`` and lets XLA insert the collectives; here every rank
is a process, a :class:`Mesh` holds one process group per named axis, and
the model code calls the collectives itself: the two Megatron-style
autograd functions around a column- and a row-parallel product
(:func:`copy_to`, :func:`reduce_from`), a gather along the last dim whose
backward takes this rank's slice (:func:`gather_last`) and its inverse
(:func:`scatter_last`); for fully-sharded weights a gather along any dim
whose backward is the reduce-scatter sum (:func:`gather`), and for
sequence parallelism the ring hop (:func:`ring_shift`, ``lax.ppermute``'s
counterpart); for the pipeline's hand-offs one point-to-point message
between two ranks of an axis (:func:`send`, :func:`recv`). A collective on
an axis of size 1, or on no axis (``None``), is the identity, so one code
path serves the sharded and the unsharded model.

Every ``torch.distributed`` call of :func:`all_reduce`, :func:`all_gather`,
:func:`broadcast`, the ring hop (:func:`shift`) and the hand-offs
(:func:`send`, :func:`recv` and the wait that ends a send), the autograd
functions' included, passes through one hook. While a program captures its
chain of CUDA graphs (``program.Program``, inside :func:`capturing`) the
hook hands the call, as a :class:`Collective`, to the chain, which breaks
there; at any other time it runs the call. The hook may be reached from
autograd's device thread, in a backward. A call writes its results into
tensors made before it (the hop's and the receive's are allocated where
the body makes the call: during a capture, in the chain's pool), so a
break can run it again between replays on the same addresses.

Ranks are laid out row-major over the axes in the order given, as the
reference reshapes its device list: the last axis (``tp``) varies fastest,
so a tp group is a run of adjacent ranks.

The scheduler's slice placement (:func:`slice_assignment`) is read from
duck-typed pods; the coordinate annotation and its parser are copied here,
since this package never imports ``tpusched``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import os
import pickle
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# tpusched.plugins.topologymatch.COORD_ANNOTATION and
# tpusched.api.topology.parse_coord, copied
COORD_ANNOTATION = "topology.tpu.dev/coord"

BATCH_AXES = ("slice", "dp", "fsdp")
# the axes a loss and its gradients are summed over: the batch axes and sp
# (each sp rank holds a share of the positions); a leaf whose fsdp
# reduce-scatter has summed it over fsdp already is summed over the rest
DATA_AXES = BATCH_AXES + ("sp",)
DATA_AXES_BUT_FSDP = ("slice", "dp", "sp")
# the axes that split the model over ranks holding the same tokens: a
# serving engine's host decisions come from rank 0 of them
MODEL_AXES = ("ep", "tp")
# axis tuples that get a process group of their own, beside each axis
GROUPED_AXES = (BATCH_AXES, DATA_AXES, DATA_AXES_BUT_FSDP, MODEL_AXES)


def parse_coord(s: str) -> Tuple[int, ...]:
    return tuple(int(p) for p in s.split("-"))


def factor_mesh(n_devices: int, max_tp: int = 4) -> Tuple[int, int]:
    """(dp, tp) with tp the largest power-of-two divisor of n <= max_tp: tp
    within a host, dp across hosts. A power of two keeps tp dividing the
    model dims (all sized in multiples of 4)."""
    tp = max_tp
    while tp > 1 and (n_devices % tp or tp & (tp - 1)):
        tp -= 1
    return n_devices // tp, tp


@dataclasses.dataclass(frozen=True)
class Axis:
    """One named axis as this rank sees it: its size, this rank's index
    along it, the process group of the ranks that share every other
    coordinate (None on a layout-only mesh) and their global ranks, in
    index order."""
    name: str
    size: int
    index: int
    group: Optional[dist.ProcessGroup]
    ranks: Tuple[int, ...]


class Mesh:
    """Named axes over ``torch.distributed``: ``axis_sizes`` in order, this
    rank's coordinate, one process group per axis and one for the batch
    axes together, and this rank's device.

    ``Mesh(axis_sizes, rank=r)`` alone is a layout: names, sizes and
    coordinates without process groups, enough for ``param_specs`` and
    ``shard_params``; a collective over one of its axes of size > 1 raises.
    :func:`build_named_mesh` builds the distributed one."""

    def __init__(self, axis_sizes: Dict[str, int], rank: int = 0,
                 device=None, groups: Optional[Dict[Tuple[str, ...],
                                                    dist.ProcessGroup]] = None):
        self.shape: Dict[str, int] = dict(axis_sizes)
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coord: Dict[str, int] = dict(zip(
            self.axis_names, _unravel(rank, tuple(self.shape.values()))))
        self.device = torch.device(device) if device is not None else None
        self._groups = groups or {}
        self._device_mesh = None

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"

    def axis(self, names) -> Optional[Axis]:
        """The axis ``names`` (one name, or a tuple of names taken together
        as one axis, row-major), or None when none of them is on the mesh.
        Names missing from the mesh are left out."""
        names = (names,) if isinstance(names, str) else tuple(names)
        names = tuple(n for n in names if n in self.shape)
        if not names:
            return None
        size = math.prod(self.shape[n] for n in names)
        index = _ravel([self.coord[n] for n in names],
                       [self.shape[n] for n in names])
        return Axis(",".join(names), size, index, self._groups.get(names),
                    tuple(_group_ranks(self.shape, self.coord, names)))

    def device_mesh(self):
        """torch's ``DeviceMesh`` over this mesh's ranks in its layout, with
        its axis names, for ``DTensor`` (the checkpoints): ``"cuda"`` under
        NCCL, ``"cpu"`` under gloo. Built on the first call, which creates
        process groups, so every rank makes it together."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh
            kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
            self._device_mesh = DeviceMesh(
                kind, torch.arange(self.size).reshape(
                    tuple(self.shape.values())),
                mesh_dim_names=self.axis_names)
        return self._device_mesh

    @property
    def tp(self) -> Optional[Axis]:
        return self.axis("tp")

    @property
    def sp(self) -> Optional[Axis]:
        return self.axis("sp")

    @property
    def fsdp(self) -> Optional[Axis]:
        return self.axis("fsdp")

    @property
    def ep(self) -> Optional[Axis]:
        return self.axis("ep")

    @property
    def pp(self) -> Optional[Axis]:
        return self.axis("pp")

    @property
    def batch(self) -> Optional[Axis]:
        """The batch axes (slice, dp, fsdp present on the mesh) as one."""
        return self.axis(BATCH_AXES)

    @property
    def data(self) -> Optional[Axis]:
        """The batch axes and sp as one: what a loss is summed over."""
        return self.axis(DATA_AXES)


def _unravel(i: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for s in reversed(sizes):
        out.append(i % s)
        i //= s
    return tuple(reversed(out))


def _ravel(coord: Sequence[int], sizes: Sequence[int]) -> int:
    i = 0
    for c, s in zip(coord, sizes):
        i = i * s + c
    return i


def _group_ranks(shape: Dict[str, int], coord: Dict[str, int],
                 names: Tuple[str, ...]):
    """Global ranks that share ``coord`` on every axis outside ``names``,
    in row-major order over ``names``."""
    sizes = tuple(shape.values())
    for sub in itertools.product(*(range(shape[n]) for n in names)):
        c = dict(coord, **dict(zip(names, sub)))
        yield _ravel([c[a] for a in shape], sizes)


def build_named_mesh(axis_sizes: Dict[str, int], backend: str = "nccl",
                     device=None, *, rank: Optional[int] = None,
                     init_method: Optional[str] = None,
                     store: Optional[dist.Store] = None) -> Mesh:
    """The named mesh of this process, e.g. ``{"dp": 2, "tp": 2}`` or a
    multi-slice ``{"slice": 2, "dp": 2, "tp": 2}``.

    Initializes the default process group (``backend``, world size the
    mesh's, ``rank`` with ``init_method`` or ``store``) unless one is up, in
    which case its backend and world size must match. Then every rank
    builds every axis's groups, and those of each tuple in
    :data:`GROUPED_AXES` with two or more axes on the mesh, in one order.

    ``backend="nccl"`` (the default) runs one card per rank, rank r on
    ``cuda:r``, and raises when there are more ranks than cards.
    ``backend="gloo"`` runs on ``device`` (the CPU tests pass "cpu"; left
    None, the current CUDA card, which every rank then shares)."""
    n = math.prod(axis_sizes.values())
    if backend == "nccl":
        count = torch.cuda.device_count()
        if n > count:
            raise ValueError(
                f"backend='nccl' runs one card per rank: {n} ranks, {count} "
                f"card(s); pass backend='gloo' to share cards through the "
                f"host")
    elif backend != "gloo":
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if not dist.is_initialized():
        if rank is None:
            raise ValueError("no process group is up: pass rank and "
                             "init_method or store")
        if backend == "nccl":      # NCCL binds a rank to its card at init
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=init_method, store=store,
                                rank=rank, world_size=n)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {axis_sizes} needs {n} ranks, the process "
                         f"group has {dist.get_world_size()}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"the mesh asks for {backend}")
    from .workload import resolve_device   # workload imports this module
    rank = dist.get_rank()
    if backend == "nccl":
        if device is not None and torch.device(device) != torch.device(
                "cuda", rank):
            raise ValueError(f"backend='nccl' puts rank {rank} on cuda:{rank}, "
                             f"not {device}")
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = resolve_device(device)
    shape = dict(axis_sizes)
    sizes = tuple(shape.values())
    names_list = [(a,) for a in shape]
    for grouped in GROUPED_AXES:
        present = tuple(a for a in grouped if a in shape)
        if len(present) > 1 and present not in names_list:
            names_list.append(present)
    groups = {}
    for names in names_list:
        # every rank creates every group of this axis, in one order
        others = [a for a in shape if a not in names]
        for fixed in itertools.product(*(range(shape[a]) for a in others)):
            coord = dict(zip(others, fixed), **{a: 0 for a in names})
            ranks = list(_group_ranks(shape, coord, names))
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[names] = group
    return Mesh(shape, rank, device, groups)


def build_mesh(n_devices: int, axis_names: Tuple[str, str] = ("dp", "tp"),
               **kwargs) -> Mesh:
    """A dp×tp mesh of ``n_devices`` ranks, factored by :func:`factor_mesh`;
    ``kwargs`` go to :func:`build_named_mesh`."""
    dp, tp = factor_mesh(n_devices)
    return build_named_mesh({axis_names[0]: dp, axis_names[1]: tp}, **kwargs)


def mesh_from_slice_shape(shape: Tuple[int, ...], **kwargs) -> Mesh:
    """The mesh of a scheduled slice shape, e.g. (2, 2, 1) -> 4 ranks as
    dp×tp with tp within hosts."""
    return build_mesh(math.prod(shape), **kwargs)


def _launched(rank: int, fn: Callable, axis_sizes: Dict[str, int],
              backend: str, device, workdir: str) -> None:
    with open(os.path.join(workdir, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    store = dist.FileStore(os.path.join(workdir, "store"),
                           math.prod(axis_sizes.values()))
    mesh = build_named_mesh(axis_sizes, backend, device, rank=rank,
                            store=store)
    try:
        out = fn(mesh, *args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, axis_sizes: Dict[str, int], *args,
           backend: str = "nccl", device=None,
           workdir: Optional[str] = None) -> List:
    """Run ``fn(mesh, *args)`` on every rank of a new mesh, one spawned
    process a rank, and return the ranks' results in rank order. The ranks
    meet through a ``FileStore`` in a new temporary directory under
    ``workdir`` (the system's when None), so no port is opened, and take
    ``args`` and pass their results back through it; ``backend`` and
    ``device`` go to :func:`build_named_mesh`. ``fn`` must be importable
    (a module's top-level function) and its result picklable. A rank that
    raises ends the launch, and the exception is raised here."""
    n = math.prod(axis_sizes.values())
    with tempfile.TemporaryDirectory(dir=workdir) as d:
        # the arguments go through a file: in the spawn arguments, anything
        # past a pipe's buffer makes each rank's start wait until the rank
        # before it has imported torch and read them
        with open(os.path.join(d, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        mp.spawn(_launched, args=(fn, dict(axis_sizes), backend, device, d),
                 nprocs=n, join=True)
        out = []
        for r in range(n):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def slice_assignment(pods) -> "list[tuple[tuple[int, ...], str]]":
    """The scheduler's slice placement from bound gang pods: a sorted list
    of (chip coordinate, node name) from the TopologyMatch coordinate
    annotations. Reads ``pod.meta.annotations`` and ``pod.spec.node_name``
    only."""
    out = []
    for p in pods:
        ann = p.meta.annotations.get(COORD_ANNOTATION)
        if ann and p.spec.node_name:
            out.append((parse_coord(ann), p.spec.node_name))
    return sorted(out)


# -- collectives on an axis ------------------------------------------------------


@dataclasses.dataclass(eq=False)
class Collective:
    """One ``torch.distributed`` call as a body made it: its kind
    (``"all_reduce"``, ``"all_gather"``, ``"broadcast"``, ``"shift"``,
    ``"send"``, ``"recv"`` or ``"wait"``), the call, and what it acts on
    (a tensor, the hop's send and receive tensors, or a send's
    :class:`_Sent`) with its keyword arguments. Calling it runs the
    collective, in place."""
    kind: str
    fn: Callable
    tensor: Any
    kwargs: dict

    def __call__(self) -> None:
        self.fn(self.tensor, **self.kwargs)


# the chain being captured (:func:`capturing`), else None: one a process,
# not a thread's, since a backward reaches the hook from autograd's thread
_chain = None
# the collectives the hook has run in this process (a replay's breaks,
# which run without it, not included)
COLLECTIVES_RUN = 0


@contextlib.contextmanager
def capturing(chain):
    """Until the block ends, hand every collective that passes through the
    hook to ``chain.cut`` instead of running it."""
    global _chain
    if _chain is not None:
        raise RuntimeError(f"capturing {chain.name!r} inside the capture of "
                           f"{_chain.name!r}")
    _chain = chain
    try:
        yield
    finally:
        _chain = None


def _collective(kind: str, fn: Callable, tensor, **kwargs) -> None:
    """The one hook: ``fn(tensor, **kwargs)`` now, or a break of the chain
    being captured."""
    global COLLECTIVES_RUN
    call = Collective(kind, fn, tensor, kwargs)
    if _chain is None:
        COLLECTIVES_RUN += 1
        call()
    else:
        _chain.cut(call)


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def _host(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself on the CPU, else a host buffer of its shape: gloo's
    point-to-point ops read and write host memory only."""
    return t if t.device.type == "cpu" else torch.empty(
        t.shape, dtype=t.dtype, device="cpu")


@torch.no_grad()
def _hop(bufs, dst: int, src: int, group) -> None:
    """The ring hop's call: ``sends`` to ``dst`` and ``recvs`` filled from
    ``src``, every send and receive posted before any is waited on, so no
    rank blocks in a send while its neighbour blocks in one too: under
    NCCL in one ``batch_isend_irecv``, under gloo staged through host
    copies."""
    sends, recvs = bufs
    if _nccl(group):
        ops = ([dist.P2POp(dist.isend, t, dst, group) for t in sends]
               + [dist.P2POp(dist.irecv, r, src, group) for r in recvs])
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return
    hosts = [_host(r) for r in recvs]
    works = ([dist.isend(t.to("cpu"), dst, group=group) for t in sends]
             + [dist.irecv(h, src, group=group) for h in hosts])
    for work in works:
        work.wait()
    for r, h in zip(recvs, hosts):
        if h is not r:
            r.copy_(h)


@torch.no_grad()
def _recv_into(buf: torch.Tensor, src: int, group) -> None:
    """A receive's call: ``buf`` filled from ``src`` (blocking), through a
    host copy under gloo. ``buf`` may be a leaf that requires grad (the
    pipeline's received activations)."""
    if _nccl(group):
        dist.recv(buf, src, group=group)
        return
    host = _host(buf)
    dist.recv(host, src, group=group)
    if host is not buf:
        buf.copy_(host)


def _live(axis: Optional[Axis]) -> bool:
    if axis is None or axis.size == 1:
        return False
    if axis.group is None:
        raise RuntimeError(f"axis {axis.name!r} of size {axis.size} has no "
                           f"process group: build the mesh with "
                           f"build_named_mesh")
    return True


def all_reduce(x: torch.Tensor, axis: Optional[Axis],
               op: str = "sum") -> torch.Tensor:
    """The sum (or ``op="max"``) of ``x`` over ``axis``, as a new tensor.
    A floating tensor narrower than float32 is summed in float32 and
    rounded once at the end."""
    if not _live(axis):
        return x
    wide = x.is_floating_point() and x.element_size() < 4
    out = x.float() if wide else x.clone()
    _collective("all_reduce", dist.all_reduce, out,
                op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                group=axis.group)
    return out.to(x.dtype) if wide else out


def all_gather(x: torch.Tensor, axis: Optional[Axis],
               dim: int = -1) -> torch.Tensor:
    """The chunks of ``x`` of every rank of ``axis`` concatenated along
    ``dim`` in index order. Written as the sum of zero-padded buffers (each
    rank's chunk in its own place), which is exact and which every backend
    reduces, CUDA tensors under gloo included."""
    if not _live(axis):
        return x
    dim = dim % x.dim()
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * axis.size
    buf = x.new_zeros(shape)
    buf.narrow(dim, axis.index * n, n).copy_(x)
    _collective("all_gather", dist.all_reduce, buf, group=axis.group)
    return buf


def broadcast(x: torch.Tensor, axis: Optional[Axis],
              index: int = 0) -> torch.Tensor:
    """``x`` of the rank at ``index`` along ``axis``, written into ``x`` in
    place on every rank of the axis."""
    if _live(axis):
        _collective("broadcast", dist.broadcast, x, src=axis.ranks[index],
                    group=axis.group)
    return x


def local_chunk(x: torch.Tensor, axis: Optional[Axis],
                dim: int = -1) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim``: ``size`` equal chunks."""
    if axis is None or axis.size == 1:
        return x
    n = x.shape[dim]
    if n % axis.size:
        raise ValueError(f"dim of {n} does not split over {axis.name} of "
                         f"{axis.size}")
    return x.narrow(dim % x.dim(), axis.index * (n // axis.size),
                    n // axis.size)


def shift(tensors: Sequence[torch.Tensor], axis: Optional[Axis],
          step: int = 1) -> List[torch.Tensor]:
    """One ring hop of each tensor along ``axis``, as new tensors: this
    rank's go to index + ``step`` and the ones of index − ``step`` come
    back (mod the axis size), ``lax.ppermute`` with ``perm = [(i, (i +
    step) % n)]``. One call of the hook (:func:`_hop`): every send and
    receive is posted before any is waited on. Gloo's point-to-point ops
    read and write host memory only, so under gloo a CUDA tensor's hop is
    staged through a host copy (one device-to-host and one host-to-device
    copy of its bytes, where an all-gather would move the axis size times
    them)."""
    if not _live(axis):
        return list(tensors)
    n = axis.size
    sends = [t.detach().contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    _collective("shift", _hop, (sends, recvs),
                dst=axis.ranks[(axis.index + step) % n],
                src=axis.ranks[(axis.index - step) % n], group=axis.group)
    return recvs


def send(x: torch.Tensor, axis: Axis, index: int) -> "_Sent":
    """Post ``x`` to the rank at ``index`` along ``axis`` without waiting;
    returns a handle whose ``wait()`` ends the send (hold it until then).
    Under gloo a CUDA tensor goes through a host copy, as in
    :func:`shift`."""
    sent = _Sent(x.detach().contiguous(), axis.ranks[index], axis.group)
    _collective("send", _Sent.post, sent)
    return sent


def recv(axis: Axis, index: int, shape, dtype: torch.dtype,
         device) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on ``device``, received from the
    rank at ``index`` along ``axis`` (blocking)."""
    buf = torch.empty(shape, dtype=dtype, device=device)
    _collective("recv", _recv_into, buf, src=axis.ranks[index],
                group=axis.group)
    return buf


class _Sent:
    """A posted send: the tensor and its destination, and, from the post
    (a break's run) to the wait, the send's ``Work`` and the buffer it
    reads."""

    def __init__(self, tensor: torch.Tensor, dst: int, group):
        self.tensor, self.dst, self.group = tensor, dst, group
        self.work: Optional[dist.Work] = None
        self.buf: Optional[torch.Tensor] = None

    def post(self) -> None:
        self.buf = (self.tensor if _nccl(self.group)
                    else self.tensor.detach().to("cpu"))
        self.work = dist.isend(self.buf, self.dst, group=self.group)

    def wait(self) -> None:
        """End the send: one call of the hook, so a capture breaks here."""
        _collective("wait", _Sent.finish, self)

    def finish(self) -> None:
        self.work.wait()
        self.work = self.buf = None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """The ranks' chunks joined along ``dim``; backward, this rank's chunk
    of the gradient, summed over the axis first when ``reduce`` (the
    ranks' gradients of the whole differ)."""

    @staticmethod
    def forward(ctx, x, axis, dim, reduce):
        ctx.axis, ctx.dim, ctx.reduce = axis, dim, reduce
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            g = all_reduce(g, ctx.axis)
        return (local_chunk(g, ctx.axis, ctx.dim).contiguous(), None, None,
                None)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return shift([x], axis)[0]

    @staticmethod
    def backward(ctx, g):
        return shift([g], ctx.axis, -1)[0], None


class _ScatterLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return local_chunk(x, axis, -1).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axis, -1), None


def copy_to(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """In front of a column-parallel product: the identity forward, the sum
    of the ranks' partial gradients over ``axis`` backward."""
    return _CopyTo.apply(x, axis) if _live(axis) else x


def reduce_from(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """After a row-parallel product: the sum of the ranks' partial outputs
    over ``axis`` forward (:func:`all_reduce`), the identity backward."""
    return _ReduceFrom.apply(x, axis) if _live(axis) else x


def gather_last(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The ranks' chunks of the last dim joined forward; this rank's chunk
    of the gradient backward."""
    return _Gather.apply(x, axis, -1, False) if _live(axis) else x


def gather(x: torch.Tensor, axis: Optional[Axis], dim: int,
           reduce: bool = True) -> torch.Tensor:
    """The ranks' chunks of ``dim`` joined forward; backward, the sum of the
    ranks' gradients of the whole over ``axis``, this rank's chunk of it
    (a reduce-scatter). Where the ranks hold different data, as fsdp's
    weight gathers and the sequence gathers of sp do, each rank's gradient
    of the whole is a partial one. With ``reduce=False`` the backward takes
    this rank's chunk of its own gradient, no sum: for ranks that compute
    on the same data (the pipeline's fsdp ranks), whose gradients of the
    whole are each the full one."""
    return _Gather.apply(x, axis, dim, reduce) if _live(axis) else x


def ring_shift(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """:func:`shift` by one with gradients: the gradient hops the other
    way, as the transpose of ``lax.ppermute`` does."""
    return _RingShift.apply(x, axis) if _live(axis) else x


def scatter_last(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """This rank's chunk of the last dim of a replicated ``x`` forward; the
    ranks' gradient chunks joined backward."""
    return _ScatterLast.apply(x, axis) if _live(axis) else x
