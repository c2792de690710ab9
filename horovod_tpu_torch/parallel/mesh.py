"""Device meshes for the port (the JAX package's ``parallel/mesh.py``).

A JAX mesh places devices on named axes and XLA turns a collective over an
axis into the collective of each device's line along it. Here one process
drives one GPU, so a :class:`Mesh` places *ranks* on named axes, and an
axis (or a tuple of axes) gives this rank's line as a registered
:class:`~horovod_tpu_torch.common.process_sets.ProcessSet`, which every
collective of the port and ``DistributedOptimizer(process_set=...)`` take.

Rank ``r`` sits at ``np.unravel_index(r, sizes)``, as JAX's
``np.asarray(devices).reshape(sizes)`` places device ``r``.

``new_group`` is collective over the whole world, so building a mesh
registers, on every process and in one fixed order, the line of every
subset of its axes of size > 1 (``add_process_set`` returns a set already
registered with the same ranks). Every process builds the same meshes in the
same order, members or not, as for ``add_process_set``.

- the **global mesh** is 1-D over every rank (axis ``hvt_world``);
- the **hierarchical mesh** is 2-D ``(hvt_cross, hvt_local)`` = (hosts,
  ranks per host), from ``cross_rank``/``local_rank``;
- :func:`make_parallel_mesh` builds N-D meshes for dp/fsdp/pp/ep/sp/tp.
"""

from __future__ import annotations

import itertools

import numpy as np

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.process_sets import ProcessSet, add_process_set

WORLD_AXIS = "hvt_world"
LOCAL_AXIS = "hvt_local"
CROSS_AXIS = "hvt_cross"

# Canonical parallelism axis names, outermost first: dp/fsdp reduce
# gradients once a step and tolerate the slower links; sp/tp communicate
# inside every layer and go innermost, on the fastest links (NVLink).
PARALLEL_AXES = ("dp", "fsdp", "pp", "ep", "sp", "tp")


class Mesh:
    """Ranks on named axes. ``devices`` is the int array of global ranks
    (shape = the axis sizes), ``axis_names`` the axes, outermost first, and
    ``shape`` the ``{axis: size}`` dict, as on a ``jax.sharding.Mesh``."""

    def __init__(self, ranks, axis_names):
        self.devices = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D ranks for axes "
                             f"{self.axis_names}")
        flat = self.devices.reshape(-1)
        if flat.size == 0 or (np.diff(flat) <= 0).any() or flat[0] < 0 \
                or flat[-1] >= basics.size():
            raise ValueError(f"mesh ranks {flat.tolist()} must increase "
                             f"strictly inside [0, {basics.size()})")
        self._sets = {}
        self._register()

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_size(self, axis) -> int:
        """The size of ``axis``; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def coords(self) -> dict:
        """``{axis: index}`` of this process's rank; raises ``ValueError``
        for a rank outside the mesh."""
        where = np.argwhere(self.devices == basics.rank())
        if not len(where):
            raise ValueError(f"rank {basics.rank()} is not in {self!r}")
        return dict(zip(self.axis_names, map(int, where[0])))

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis`` (0 for an absent axis)."""
        return self.coords().get(axis, 0)

    def _key(self, axes):
        if isinstance(axes, str):
            axes = (axes,)
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def process_set(self, axes) -> ProcessSet:
        """This rank's line along ``axes`` (an axis name or a tuple of
        them): the ranks that share every other coordinate. Its members
        are in row-major order over ``axes``, so a member's place in the
        set is its index along a single axis. Absent axes and axes of size
        1 add nothing: with none left it is this rank alone."""
        key = self._key(axes)
        if key not in self._sets:
            raise ValueError(f"rank {basics.rank()} is not in {self!r}")
        return self._sets[key]

    def _register(self):
        """Register the line of every subset of the axes of size > 1 (the
        empty subset gives one set per rank), in one order on every
        process, and keep this rank's."""
        big = [a for a in self.axis_names if self.shape[a] > 1]
        me = basics.rank()
        for n_axes in range(len(big) + 1):
            for subset in itertools.combinations(big, n_axes):
                dims = [self.axis_names.index(a) for a in subset]
                rest = [d for d in range(len(self.axis_names))
                        if d not in dims]
                lines = np.transpose(self.devices, rest + dims).reshape(
                    -1, int(np.prod([self.devices.shape[d] for d in dims],
                                    dtype=np.int64)))
                for line in lines.tolist():
                    ps = add_process_set(line)
                    if me in line:
                        self._sets[subset] = ps

    def __repr__(self):
        return f"Mesh({self.shape}, ranks={self.devices.reshape(-1).tolist()})"


def mesh_factors(n: int):
    """Split n ranks into (dp, sp, tp): tp 2 and sp 2 where they divide,
    the rest into dp (``__graft_entry__._mesh_factors``)."""
    tp = 2 if n % 2 == 0 else 1
    rem = n // tp
    sp = 2 if rem % 2 == 0 else 1
    return rem // sp, sp, tp


def mesh_layout(n, axis_sizes):
    """(axis names, sizes) for ``n`` ranks, by :func:`make_parallel_mesh`'s
    rules; raises its ``ValueError``s."""
    names = [a for a in PARALLEL_AXES if a in axis_sizes]
    names += [a for a in axis_sizes if a not in names]
    sizes = [axis_sizes[a] for a in names]
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    fixed = int(np.prod([s for s in sizes if s != -1])) if sizes else 1
    if -1 in sizes:
        if n % fixed != 0:
            raise ValueError(
                f"{n} devices not divisible by fixed axes product {fixed}")
        sizes[sizes.index(-1)] = n // fixed
        fixed = n
    if fixed != n:
        raise ValueError(
            f"mesh axes {dict(zip(names, sizes))} use {fixed} devices, "
            f"but {n} are available")
    return names, sizes


def make_parallel_mesh(**axis_sizes) -> Mesh:
    """Build an N-D mesh over every rank.

    ``axis_sizes`` maps axis name → size; one axis may be ``-1`` to absorb
    the remaining ranks. Axes are laid out in :data:`PARALLEL_AXES` order
    (unknown names keep their kwarg order, appended innermost) so that
    tp/sp land on the innermost dimensions, where neighbouring ranks share
    a host. The same rules and ``ValueError``s as the JAX function::

        mesh = make_parallel_mesh(dp=-1, tp=4)
        mesh = make_parallel_mesh(dp=2, sp=2, tp=2)     # 8 ranks
    """
    names, sizes = mesh_layout(basics.size(), axis_sizes)
    return Mesh(np.arange(basics.size()).reshape(sizes), names)


def global_mesh() -> Mesh:
    """The GLOBAL communicator: 1-D mesh over every rank, axis
    ``hvt_world``."""
    return Mesh(np.arange(basics.size()), (WORLD_AXIS,))


def hierarchical_mesh() -> Mesh:
    """(hosts × ranks-per-host) mesh, axes ``(hvt_cross, hvt_local)``: the
    LOCAL/CROSS communicator pair. Requires a homogeneous, host-major job
    (rank = cross_rank · local_size + local_rank), as the ``hvtrun``
    launcher assigns ranks."""
    n, local, cross = basics.size(), basics.local_size(), basics.cross_size()
    if local * cross != n or basics.rank() != \
            basics.cross_rank() * local + basics.local_rank():
        raise ValueError(
            f"hierarchical_mesh requires a homogeneous, host-major job; got "
            f"rank {basics.rank()}, local {basics.local_rank()}/{local}, "
            f"cross {basics.cross_rank()}/{cross}")
    return Mesh(np.arange(n).reshape(cross, local), (CROSS_AXIS, LOCAL_AXIS))
