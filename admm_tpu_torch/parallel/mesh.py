"""Device meshes for the port (counterpart of ``admm_tpu/parallel/mesh.py``).

The JAX package's mesh is a ``jax.sharding.Mesh``: one controller, and
XLA's partitioner inserts the collectives.  PyTorch has neither, so the
port's mesh is explicit: an ordered tuple of D **positions**, each with a
``torch.device``, and an optional ``torch.distributed`` process group.

* One process: ``make_mesh(D, devices=[dev] * D)``.  Every position
  belongs to this process and positions may share a device (the port's
  form of ``--xla_force_host_platform_device_count``).  A cross-position
  sum is a sum over the local positions, in position order.
* Many processes: ``make_mesh(group=pg)``, one position per rank on that
  rank's device.  A cross-position sum is the local sum followed by
  ``all_reduce`` over ``pg``; a gather is ``all_gather``.  Backends: gloo
  on the CPU, NCCL with one rank per GPU, and gloo over CUDA tensors,
  which go through the host (gloo's collectives here take CPU tensors).

Every collective of the port is in this module (:func:`all_sum`,
:func:`all_gather`); no model calls ``torch.distributed`` itself.

:class:`Sharded` is this process's blocks of an array split along one
dimension, as ``torch.tensor_split`` splits it (no zero padding: the
standardization moments divide by the true n).  It supports the
products the solvers make with their data matrix: a product that
contracts the sharded dimension is a cross-position sum, one that keeps
it is gathered into a replicated tensor (an n- or p-vector per lane,
never the matrix itself).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "workers"


def _default_device():
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _indexed(d) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so positions compare with the
    devices tensors report."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """D positions; this process owns ``local`` (global indices), on
    ``devices``.  ``group`` is the process group of a many-process mesh
    (one position per rank), None for one process."""

    def __init__(self, devices, local, size: int, group=None,
                 axis_name: str = DATA_AXIS):
        self.devices = tuple(_indexed(d) for d in devices)
        self.local = tuple(int(i) for i in local)
        self.size = int(size)
        self.group = group
        self.axis_names = (axis_name,)
        if len(self.devices) != len(self.local) or not self.devices:
            raise ValueError("a mesh needs one device per local position")

    @property
    def home(self) -> torch.device:
        """The device of this process's first position: replicated
        tensors live there."""
        return self.devices[0]

    @property
    def nproc(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this process's share of an
        iteration: its positions on one device (a graph captures one
        device's work), and collectives that sit inside a graph (none at
        all, no group, or NCCL's)."""
        return (len(set(self.devices)) == 1
                and (self.group is None or self.backend == "nccl"))

    def spans(self, length: int):
        """``(lo, hi)`` of every position's block of ``length`` items, as
        ``torch.tensor_split`` splits them."""
        edges = np.cumsum([0] + [len(a) for a in
                                 np.array_split(np.arange(length),
                                                self.size)])
        return [(int(edges[i]), int(edges[i + 1])) for i in range(self.size)]

    def local_spans(self, length: int):
        sp = self.spans(length)
        return [sp[i] for i in self.local]

    def warm(self) -> None:
        """One collective on the group, so that its communicator exists
        before a CUDA graph captures a collective."""
        if self.group is not None:
            t = torch.zeros((1,), device=self.home)
            all_sum([t], self)

    def __repr__(self):
        return (f"Mesh(size={self.size}, local={self.local}, "
                f"devices={[str(d) for d in self.devices]}, "
                f"backend={self.backend})")


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis_name: str = DATA_AXIS, *, group=None) -> Mesh:
    """A 1-D mesh.

    ``group`` (or, with no other argument, the default process group when
    one is initialized): one position per rank, on ``devices[0]`` or this
    process's CUDA device (the CPU without one).  Otherwise one process:
    ``n_devices`` positions on ``devices`` (default: the CUDA devices in
    turn, or the CPU), or every device given."""
    if (group is None and n_devices is None and devices is None
            and dist.is_available() and dist.is_initialized()):
        group = dist.group.WORLD
    if group is not None:
        dev = devices[0] if devices else _default_device()
        return Mesh((dev,), (dist.get_rank(group),),
                    dist.get_world_size(group), group, axis_name)
    if devices is None:
        k = 1 if n_devices is None else int(n_devices)
        if torch.cuda.is_available():
            ndev = torch.cuda.device_count()
            devices = [torch.device("cuda", i % ndev) for i in range(k)]
        else:
            devices = [torch.device("cpu")] * k
    elif n_devices is not None:
        devices = list(devices)[:int(n_devices)]
    return Mesh(devices, range(len(devices)), len(devices), None, axis_name)


class ShardSpec(NamedTuple):
    """Where an array goes on a mesh: split along ``dim``, or replicated
    (``dim`` None)."""
    mesh: Mesh
    dim: Optional[int]


def row_sharding(mesh: Mesh, axis_name: str = DATA_AXIS) -> ShardSpec:
    """Shard a (n, ...) array along its leading (row) axis."""
    return ShardSpec(mesh, 0)


def replicated(mesh: Mesh) -> ShardSpec:
    return ShardSpec(mesh, None)


def put(arr, spec: ShardSpec, dtype=None):
    """``arr`` placed by ``spec``: a :class:`Sharded` or, replicated, a
    tensor on the mesh's home device."""
    if spec.dim is None:
        t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(
            np.asarray(arr))
        return t.to(device=spec.mesh.home, dtype=dtype or t.dtype)
    return put_dim_sharded(arr, spec.mesh, spec.dim, dtype)


def put_dim_sharded(arr, mesh: Mesh, dim: int, dtype=None) -> "Sharded":
    """This process's blocks of ``arr`` along ``dim`` (split as
    ``torch.tensor_split`` splits it), one per local position, each on
    its position's device.  Every process may hold the whole host array;
    only its own blocks move to its devices."""
    if isinstance(arr, Sharded):
        return arr
    size = int(arr.shape[dim])
    blocks = []
    for (lo, hi), dev in zip(mesh.local_spans(size), mesh.devices):
        idx = [slice(None)] * len(arr.shape)
        idx[dim] = slice(lo, hi)
        piece = arr[tuple(idx)]
        if isinstance(piece, torch.Tensor):
            piece = piece.to(device=dev, dtype=dtype or piece.dtype)
        else:
            piece = torch.as_tensor(np.asarray(piece), dtype=dtype,
                                    device=dev)
        blocks.append(piece)
    return Sharded(blocks, mesh, dim, size)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _via_host(t, mesh, op):
    """Run ``op`` on ``t`` in place; gloo's collectives take CPU tensors,
    so a CUDA tensor goes through the host."""
    if mesh.backend == "gloo" and t.device.type != "cpu":
        h = t.cpu()
        op(h)
        t.copy_(h)
    else:
        op(t)
    return t


def all_sum(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The sum over every position of the mesh of this process's
    ``parts`` (one per local position, or one already summed over them):
    on the home device, in position order, then ``all_reduce`` over the
    group (one of a single rank too: the collective runs, its sum is the
    rank's own bits).  A single part of a mesh without a group comes back
    as it is."""
    out = parts[0].to(mesh.home)
    for p in parts[1:]:
        out = out + p.to(mesh.home)
    if mesh.group is not None:
        out = out.contiguous() if len(parts) > 1 else out.clone()
        _via_host(out, mesh, lambda t: dist.all_reduce(t, group=mesh.group))
    return out


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh, dim: int,
               size: int) -> torch.Tensor:
    """Every position's part concatenated along ``dim`` in position order
    (``size`` items in all, split as :meth:`Mesh.spans` splits them), on
    the home device of every process."""
    local = [p.to(mesh.home) for p in parts]
    mine = local[0] if len(local) == 1 else torch.cat(local, dim=dim)
    if mesh.group is None:
        return mine
    d = dim % mine.dim()
    lens = [hi - lo for lo, hi in mesh.spans(size)]
    width = max(lens)
    pad = list(mine.shape)
    pad[d] = width - mine.shape[d]
    if pad[d]:
        mine = torch.cat([mine, mine.new_zeros(pad)], dim=d)
    mine = mine.movedim(d, 0).contiguous()
    out = mine.new_empty((mesh.nproc,) + tuple(mine.shape))
    if mesh.backend == "gloo":
        h_out = out.cpu()
        dist.all_gather(list(h_out.unbind(0)), mine.cpu(), group=mesh.group)
        out.copy_(h_out)
    else:
        dist.all_gather_into_tensor(out, mine, group=mesh.group)
    pieces = [out[r, :lens[r]] for r in range(mesh.nproc)]
    return torch.cat(pieces, dim=0).movedim(0, d)


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait, on the host, until every process has reached this point (a
    one-number :func:`all_sum` read back); nothing on one process."""
    if mesh is not None and mesh.group is not None:
        float(all_sum([torch.zeros((), device=mesh.home)], mesh))


def is_writer(mesh: Optional[Mesh]) -> bool:
    """Whether this process writes the files of a run on ``mesh``: the
    one that holds position 0."""
    return mesh is None or 0 in mesh.local


# ---------------------------------------------------------------------------
# A matrix split over the mesh
# ---------------------------------------------------------------------------

def _other(o, sl, axis_len, sharded_dim_of_o):
    """The part of a replicated operand that meets one block: sliced
    along ``sharded_dim_of_o`` when it spans the sharded length there."""
    if not isinstance(o, torch.Tensor) or o.dim() == 0:
        return o
    d = sharded_dim_of_o
    if -o.dim() <= d < o.dim() and o.shape[d] == axis_len and axis_len > 1:
        idx = [slice(None)] * o.dim()
        idx[d] = sl
        return o[tuple(idx)]
    return o


class Sharded:
    """This process's blocks of a 2-D array split along ``axis`` (0: rows,
    1: columns) over ``mesh``; ``size`` is the global length along it.

    Products with replicated tensors follow one rule: contracting the
    sharded axis sums over positions (:func:`all_sum`), keeping it
    gathers the thin result (:func:`all_gather`).  Elementwise arithmetic
    with a tensor or number runs per block, a row-aligned (n, 1) operand
    sliced to each block's rows."""

    def __init__(self, blocks, mesh: Mesh, axis: int, size: int):
        self.blocks = list(blocks)
        self.mesh = mesh
        self.axis = int(axis)
        self.size = int(size)
        self.spans = mesh.local_spans(self.size)

    # -- tensor-like attributes -------------------------------------------
    @property
    def shape(self):
        s = list(self.blocks[0].shape)
        s[self.axis] = self.size
        return torch.Size(s)

    @property
    def dtype(self):
        return self.blocks[0].dtype

    @property
    def device(self):
        return self.mesh.home

    @property
    def mT(self):
        return _Transposed(self)

    def _slices(self):
        return [slice(lo, hi) for lo, hi in self.spans]

    # -- per-block maps and cross-position reductions ---------------------
    def map(self, fn: Callable) -> "Sharded":
        """``fn(block)`` per block (it may change the other axis)."""
        return Sharded([fn(b) for b in self.blocks], self.mesh, self.axis,
                       self.size)

    def map_rows(self, fn: Callable) -> "Sharded":
        """``fn(block, sl)`` per block, ``sl`` the block's slice of the
        sharded axis (to cut a replicated operand to it)."""
        return Sharded([fn(b, sl) for b, sl in zip(self.blocks,
                                                   self._slices())],
                       self.mesh, self.axis, self.size)

    def reduce(self, fn: Callable) -> torch.Tensor:
        """``sum over positions of fn(block, sl)``, replicated."""
        return all_sum([fn(b, sl) for b, sl in zip(self.blocks,
                                                   self._slices())],
                       self.mesh)

    def gather_last(self, parts):
        """Per-block results whose last dimension is the sharded axis,
        gathered."""
        return all_gather(parts, self.mesh, -1, self.size)

    def gram(self) -> torch.Tensor:
        """X'X of a row-sharded X (or AA' of a column-sharded A): a sum
        over positions."""
        if self.axis == 0:
            return self.reduce(lambda b, sl: b.mT @ b)
        return self.reduce(lambda b, sl: b @ b.mT)

    # -- products ---------------------------------------------------------
    def __matmul__(self, b):
        if isinstance(b, Sharded):
            return NotImplemented
        rows = 0 if b.dim() <= 2 else -2     # the result's (or b's) rows
        if self.axis == 0:     # X @ b keeps the rows: gather
            return all_gather([blk @ b for blk in self.blocks], self.mesh,
                              rows, self.size)
        return self.reduce(lambda blk, sl: blk @ _other(b, sl, self.size,
                                                        rows))

    def __rmatmul__(self, u):
        if self.axis == 0:     # u @ X contracts the rows: sum
            return self.reduce(lambda blk, sl: _other(u, sl, self.size, -1)
                               @ blk)
        return self.gather_last([u @ blk for blk in self.blocks])

    def index_select(self, dim: int, idx) -> "Sharded":
        if dim % 2 == self.axis:
            raise ValueError("index_select along the sharded axis")
        return self.map(lambda b: b.index_select(dim, idx))

    def __getitem__(self, key):
        if (self.axis != 0 or not isinstance(key, tuple) or len(key) != 2
                or key[0] != slice(None)):
            raise TypeError("a row-sharded matrix takes [:, cols] only")
        return self.map(lambda b: b[:, key[1]])

    # -- elementwise ------------------------------------------------------
    def _elementwise(self, other, op):
        if isinstance(other, Sharded):
            return Sharded([op(a, b) for a, b in zip(self.blocks,
                                                     other.blocks)],
                           self.mesh, self.axis, self.size)
        d = -2 if self.axis == 0 else -1
        return self.map_rows(lambda b, sl: op(b, _other(other, sl,
                                                        self.size, d)))

    def __add__(self, o):
        return self._elementwise(o, lambda a, b: a + b)

    def __radd__(self, o):
        return self._elementwise(o, lambda a, b: b + a)

    def __sub__(self, o):
        return self._elementwise(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._elementwise(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._elementwise(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._elementwise(o, lambda a, b: b * a)

    def __truediv__(self, o):
        return self._elementwise(o, lambda a, b: a / b)

    def __neg__(self):
        return self.map(lambda b: -b)

    def __repr__(self):
        return (f"Sharded(shape={tuple(self.shape)}, axis={self.axis}, "
                f"blocks={[tuple(b.shape) for b in self.blocks]})")


class _Transposed:
    """``X.mT`` of a :class:`Sharded` X, for the two products it meets:
    ``X.mT @ v`` and ``v @ X.mT``."""

    def __init__(self, base: Sharded):
        self.base = base

    def __matmul__(self, v):
        X = self.base
        if isinstance(v, Sharded):
            if v.axis != X.axis or v.mesh is not X.mesh:
                return NotImplemented
            if X.axis == 0:    # X'V over the rows: sum
                return all_sum([a.mT @ b for a, b in zip(X.blocks,
                                                         v.blocks)], X.mesh)
            return NotImplemented
        rows = 0 if v.dim() <= 2 else -2
        if X.axis == 0:        # X'v contracts the rows: sum
            return X.reduce(lambda blk, sl: blk.mT @ _other(v, sl, X.size,
                                                            rows))
        return all_gather([blk.mT @ v for blk in X.blocks], X.mesh, rows,
                          X.size)

    def __rmatmul__(self, v):
        X = self.base
        if X.axis == 0:        # v X' keeps the rows: gather
            return X.gather_last([v @ blk.mT for blk in X.blocks])
        return X.reduce(lambda blk, sl: _other(v, sl, X.size, -1) @ blk.mT)


def blockwise(X, fn: Callable):
    """``fn(X, all rows)`` on a plain tensor, or ``fn(block, its rows)``
    per block of a :class:`Sharded` (``sl`` cuts a replicated row-aligned
    operand)."""
    if isinstance(X, Sharded):
        return X.map_rows(fn)
    return fn(X, slice(None))


def rowsum(X, fn: Callable) -> torch.Tensor:
    """``fn(X, all rows)`` on a plain tensor; on a row-sharded one the
    sum over positions of ``fn(block, its rows)``: ``fn`` returns a sum
    over its rows, and ``sl`` cuts a replicated row-aligned operand."""
    if isinstance(X, Sharded):
        return X.reduce(fn)
    return fn(X, slice(None))


def is_sharded(X) -> bool:
    return isinstance(X, Sharded)


__all__ = ["DATA_AXIS", "Mesh", "make_mesh", "ShardSpec", "row_sharding",
           "replicated", "put", "put_dim_sharded", "all_sum", "all_gather",
           "barrier", "is_writer",
           "Sharded", "blockwise", "rowsum", "is_sharded"]
