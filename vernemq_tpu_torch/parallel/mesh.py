"""Device mesh and the placement of the sharded match engine's state: the
port of ``vernemq_tpu/parallel/mesh.py``.

The scaling axes: ``batch`` is data parallelism over concurrent publishes,
``sub`` is the subscription-table shard (each grid device holds a
contiguous slice of the table's rows). A :class:`Mesh` is a ``[batch,
sub]`` grid of devices; a partition spec is a tuple of axis names or
``None``, one entry per dimension of the array it places (the reference's
``PartitionSpec``), ``()`` for a scalar. The matcher names its twelve state
arrays (:data:`MATCHER_STATE_NAMES`) and places them through
:data:`MATCHER_PARTITION_RULES`, :func:`match_partition_rules` and
:func:`make_shard_and_gather_fns`, as the reference does.

Departures from the reference:

- A mesh may name the same device more than once (a JAX ``Mesh`` cannot):
  the CPU tests build meshes of one ``torch.device("cpu")`` repeated, and
  a card can hold several shards of one mesh. Each grid entry keeps its
  own copy of its block.
- A grid entry is a :class:`MeshDevice`: a device and the rank of the
  ``torch.distributed`` process that holds it. A block is placed only on
  this process's entries (its addressable shards, as
  ``jax.make_array_from_callback`` places them in a multi-process
  runtime); :func:`global_devices` gathers every process's devices over
  the process group, which the caller starts (no cluster tells a program
  of one).
"""

from __future__ import annotations

import re
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

Spec = Tuple[Optional[str], ...]


class MeshDevice(NamedTuple):
    """A grid entry: the process ``rank`` that holds ``device``."""

    rank: int
    device: torch.device


def process_rank() -> int:
    """This process's rank in the default ``torch.distributed`` process
    group, 0 without one."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _as_mesh_device(d) -> MeshDevice:
    if isinstance(d, MeshDevice):
        return d
    return MeshDevice(process_rank(), torch.device(d))


def global_devices(local: Sequence) -> List[MeshDevice]:
    """Every process's ``local`` devices in rank order, gathered over the
    default process group (this process's alone without one): the
    counterpart of ``jax.devices()`` in a multi-process runtime."""
    import torch.distributed as dist

    mine = [str(torch.device(d)) for d in local]
    if not (dist.is_available() and dist.is_initialized()):
        return [MeshDevice(0, torch.device(d)) for d in mine]
    every: List[Optional[List[str]]] = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return [MeshDevice(r, torch.device(d))
            for r, devs in enumerate(every) for d in devs]


class Mesh:
    """A ``[batch, sub]`` grid of :class:`MeshDevice` s."""

    def __init__(self, grid: np.ndarray):
        self.devices = grid
        self.shape = {"batch": int(grid.shape[0]), "sub": int(grid.shape[1])}

    def device(self, b: int, s: int) -> torch.device:
        return self.devices[b, s].device

    def addressable(self, b: int, s: int) -> bool:
        """Whether this process holds grid entry ``(b, s)``."""
        return self.devices[b, s].rank == process_rank()

    @property
    def first_device(self) -> torch.device:
        """This process's first grid device (where whole-table work, such
        as the coded operand build, runs before placement)."""
        for md in self.devices.flat:
            if md.rank == process_rank():
                return md.device
        raise RuntimeError("this process holds no device of the mesh")


def make_mesh(devices: Optional[Sequence[Union[str, torch.device,
                                               MeshDevice]]] = None,
              batch: Optional[int] = None) -> Mesh:
    """Build a ``('batch', 'sub')`` mesh over the given devices (by default
    every card of this process). With no ``batch`` hint the mesh is 1 x N:
    every device shards the subscription table, the right default since S
    >> B dominates memory."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [_as_mesh_device(d) for d in devices]
    n = len(devs)
    if batch is None:
        batch = 1
    if n == 0 or n % batch:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    grid = np.empty((batch, n // batch), dtype=object)
    for i, d in enumerate(devs):
        grid[i // (n // batch), i % (n // batch)] = d
    return Mesh(grid)


# ---------------------------------------------------------------------------
# Partition rules + shard/gather fns (the mesh-native placement machinery)
# ---------------------------------------------------------------------------

#: Canonical names of the 12 windowed matcher state arrays, in the exact
#: positional order the sharded and mesh matchers carry them: the
#: column-sharded coded operand + its per-row metadata, then the
#: replicated dense g-zone mirrors.
MATCHER_STATE_NAMES: Tuple[str, ...] = (
    "F_t", "t1", "eff_len", "has_hash", "first_wild", "active",
    "g/F_t", "g/t1", "g/eff_len", "g/has_hash", "g/first_wild", "g/active",
)

#: Partition rules for the matcher state: regex on the array name → spec.
#: Rows are sharded on the subscription axis ('sub'); the dense g-zone
#: mirrors are replicated (every slice matches its column chunk of the
#: replicated zone); publish operands are placed per dispatch, by batch row.
MATCHER_PARTITION_RULES: List[Tuple[str, Spec]] = [
    (r"^g/F_t$", (None, None)),
    (r"^g/", (None,)),
    (r"^F_t$", (None, "sub")),  # coded operand [K, S]: columns = rows
    (r".*", ("sub",)),          # per-row metadata [S]
]


def match_partition_rules(rules: Sequence[Tuple[str, Spec]],
                          arrays: Dict[str, object]) -> Dict[str, Spec]:
    """Spec per named array by first matching rule: scalars are never
    partitioned; a name no rule covers is an error (silent replication of
    a multi-GB table array is exactly the bug class this exists to
    prevent)."""
    out: Dict[str, Spec] = {}
    for name, arr in arrays.items():
        shape = tuple(getattr(arr, "shape", ()))
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            out[name] = ()
            continue
        for rule, spec in rules:
            if re.search(rule, name) is not None:
                out[name] = spec
                break
        else:
            raise ValueError(f"no partition rule for array {name!r}")
    return out


class Shard(NamedTuple):
    """One grid entry's block of a :class:`Sharded` array: its ``index``
    (a slice per dimension of the global array), its grid ``coords`` and
    its ``data`` (``None`` where another process holds it)."""

    index: Tuple[slice, ...]
    coords: Tuple[int, int]
    data: Optional[torch.Tensor]


class Sharded:
    """A global array of ``shape`` placed on ``mesh`` under ``spec``: one
    :class:`Shard` per grid entry, in grid order (batch-major). Immutable:
    a delta that must not touch the tensors an in-flight match reads
    builds a new one (:meth:`replace`)."""

    def __init__(self, shape, spec: Spec, mesh: Mesh, shards: List[Shard]):
        self.shape = tuple(shape)
        self.spec = spec
        self.mesh = mesh
        self.shards = shards

    def shard(self, b: int, s: int) -> Shard:
        return self.shards[b * self.mesh.shape["sub"] + s]

    def data(self, b: int, s: int) -> torch.Tensor:
        """Grid entry ``(b, s)``'s tensor; raises where another process
        holds it."""
        d = self.shard(b, s).data
        if d is None:
            raise RuntimeError(
                f"mesh shard {(b, s)} is held by process "
                f"{self.mesh.devices[b, s].rank}, not this one "
                f"({process_rank()})")
        return d

    @property
    def addressable_shards(self) -> List[Shard]:
        return [sh for sh in self.shards if sh.data is not None]

    @property
    def is_fully_addressable(self) -> bool:
        return all(sh.data is not None for sh in self.shards)

    def replace(self, datas: Dict[Tuple[int, int], torch.Tensor]
                ) -> "Sharded":
        """A new array with the blocks of ``datas`` (grid coords → tensor)
        swapped in; every other block is shared."""
        return Sharded(self.shape, self.spec, self.mesh, [
            sh._replace(data=datas[sh.coords]) if sh.coords in datas else sh
            for sh in self.shards])


def _index(shape, spec: Spec, mesh: Mesh, b: int, s: int):
    idx = []
    for dim, n in enumerate(shape):
        axis = spec[dim] if dim < len(spec) else None
        if axis is None:
            idx.append(slice(0, n))
            continue
        parts, i = mesh.shape[axis], (b if axis == "batch" else s)
        if n % parts:
            raise ValueError(f"dimension {dim} of {n} does not divide over "
                             f"the {parts}-way {axis!r} axis")
        w = n // parts
        idx.append(slice(i * w, (i + 1) * w))
    return tuple(idx)


def make_shard_and_gather_fns(
    partition_specs: Dict[str, Spec], mesh: Mesh,
) -> Tuple[Dict[str, Callable], Dict[str, Callable]]:
    """Shard/gather function per named array from its spec.

    A shard fn places a host array (numpy, or a tensor on any device) on
    the mesh: each grid entry of this process gets its block as a
    contiguous tensor on its device; another process's entries get none
    (each process contributes its addressable shards). A gather fn
    returns numpy: the full array when every shard is addressable, else
    only the local shards concatenated in row order, replicated copies of
    one block once (the per-process view; cross-process gathers ride the
    cluster plane)."""

    def make_shard_fn(spec: Spec) -> Callable:
        def shard(x) -> Sharded:
            x = torch.from_numpy(np.ascontiguousarray(x)) \
                if isinstance(x, np.ndarray) else x
            shards = []
            for b in range(mesh.shape["batch"]):
                for s in range(mesh.shape["sub"]):
                    idx = _index(x.shape, spec, mesh, b, s)
                    data = (x[idx].to(mesh.device(b, s), copy=True)
                            .contiguous() if mesh.addressable(b, s) else None)
                    shards.append(Shard(idx, (b, s), data))
            return Sharded(x.shape, spec, mesh, shards)
        return shard

    def gather(arr: Sharded) -> np.ndarray:
        def host(t):
            return t.cpu().numpy()

        if arr.is_fully_addressable:
            first = host(arr.shards[0].data)
            out = np.empty(arr.shape, dtype=first.dtype)
            for sh in arr.shards:
                out[sh.index] = host(sh.data)
            return out
        seen, datas = set(), []
        for sh in sorted(arr.addressable_shards,
                         key=lambda sh: tuple(sl.start for sl in sh.index)):
            key = tuple(sl.start for sl in sh.index)
            if key in seen:  # a replicated copy of the same block
                continue
            seen.add(key)
            datas.append(host(sh.data))
        return np.concatenate(datas, axis=-1 if datas[0].ndim > 1 else 0) \
            if datas else np.empty(0)

    shard_fns = {n: make_shard_fn(spec) for n, spec in partition_specs.items()}
    gather_fns = {n: gather for n in partition_specs}
    return shard_fns, gather_fns


def place_matcher_state(mesh: Mesh, F_t, t1, eff_len, has_hash,
                        first_wild, active, glob: int) -> tuple:
    """Place the 12-array windowed matcher state on ``mesh`` through the
    partition rules (shared by the sharded and mesh matchers' builds and
    the seats' background builds): full-table arrays row-sharded over
    'sub', the ``[0, glob)`` dense g-zone mirrored on every grid entry.
    Inputs are numpy arrays or tensors (a whole-table tensor on a mesh
    device is sliced there). Returns the :class:`Sharded` arrays in
    :data:`MATCHER_STATE_NAMES` order."""
    named = {
        "F_t": F_t, "t1": t1, "eff_len": eff_len, "has_hash": has_hash,
        "first_wild": first_wild, "active": active,
        "g/F_t": F_t[:, :glob], "g/t1": t1[:glob],
        "g/eff_len": eff_len[:glob], "g/has_hash": has_hash[:glob],
        "g/first_wild": first_wild[:glob], "g/active": active[:glob],
    }
    specs = match_partition_rules(MATCHER_PARTITION_RULES, named)
    shard_fns, _ = make_shard_and_gather_fns(specs, mesh)
    return tuple(shard_fns[n](named[n]) for n in MATCHER_STATE_NAMES)
