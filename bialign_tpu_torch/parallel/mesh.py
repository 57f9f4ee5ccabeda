"""A mesh of devices, and the shards and streams of a call over one of its
axes.

Counterpart of :class:`jax.sharding.Mesh` as the JAX package uses it:
``mesh=`` of the batched entry points shards each bucket's pairs over the
axis ``"data"`` (:mod:`.batch`), ``seqsplit_mesh=`` one pair's lattice rows
over the axis ``"sp"`` (:mod:`.seqsplit`).  A device may appear more than
once: ``Mesh(["cuda:0"] * 4, ("sp",))`` is four shards on one card, each on
a stream of its own; ``Mesh(["cpu"] * 4, ("data",))`` four shards on the
CPU, run one after the other through the plain twins.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext

import numpy as np
import torch


class Mesh:
    """Devices on named axes.  ``devices``: an array-like of
    :class:`torch.device` or device strings of one or two dimensions, one
    name of ``axis_names`` a dimension.  ``shape`` maps each name to its
    size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices, axis_names):
        grid = np.array(devices, dtype=object)
        names = tuple(axis_names)
        if grid.ndim not in (1, 2) or grid.size == 0:
            raise ValueError(f"a mesh has one or two axes of devices, got "
                             f"shape {grid.shape}")
        if len(names) != grid.ndim or len(set(names)) != len(names):
            raise ValueError(f"axis_names {names} do not name the "
                             f"{grid.ndim} axes of the devices")
        self.devices = np.vectorize(torch.device, otypes=[object])(grid)
        self.axis_names = names
        self.shape = dict(zip(names, grid.shape))

    def along(self, axis: str) -> list:
        """The devices of ``axis``; on a 2-D mesh those at index 0 of the
        other axis (a computation over one axis, replicated over the
        other)."""
        if axis not in self.shape:
            raise ValueError(f"the mesh has axes {self.axis_names}, not "
                             f"{axis!r}")
        at = [slice(None) if name == axis else 0 for name in self.axis_names]
        return list(self.devices[tuple(at)])

    def __eq__(self, other):
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and bool((self.devices == other.devices).all()))

    def __hash__(self):
        return hash((self.axis_names, tuple(self.devices.flat)))

    def __repr__(self):
        return f"Mesh({self.devices.tolist()}, {self.axis_names})"


def mesh_devices(mesh, axis: str) -> list:
    """``mesh.along(axis)``, refusing anything but a :class:`Mesh`."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a bialign_tpu_torch.parallel.Mesh, "
                        f"got {type(mesh)}")
    return mesh.along(axis)


def split(total: int, parts: int) -> list:
    """``parts`` contiguous (lo, hi) ranges of ``range(total)``, as even as
    they divide (the first ``total % parts`` one longer); empty ranges
    included."""
    base, extra = divmod(total, parts)
    out, lo = [], 0
    for k in range(parts):
        hi = lo + base + (k < extra)
        out.append((lo, hi))
        lo = hi
    return out


def shard_stream(device: torch.device):
    """A stream of its own for a shard on a CUDA device; None on another."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def using(stream):
    """Work queued inside runs on ``stream`` (None: where it would)."""
    return torch.cuda.stream(stream) if stream is not None else nullcontext()


@contextmanager
def joined(shards):
    """Each (device, stream) of ``shards`` waits for its device's current
    stream before the body, and the current stream for it after: the work
    a call queues on the shards' streams (:func:`using`) comes after what
    was queued before it, runs side by side, and comes before whatever is
    queued after it, on any stream of those devices."""
    pairs = [(dev, s) for dev, s in shards if s is not None]
    for dev, s in pairs:
        s.wait_stream(torch.cuda.current_stream(dev))
    yield
    for dev, s in pairs:
        torch.cuda.current_stream(dev).wait_stream(s)
