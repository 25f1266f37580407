"""Device meshes and sharding, counterpart of `tts_tpu/parallel/mesh.py`.

The JAX package has one controller: a single process drives every chip of
a `jax.sharding.Mesh`, and GSPMD inserts the collectives.  The port keeps
that contract with a small mesh of its own: an array of `torch.device`s
with axis names, ("dp", "tp") for training, ("tp",) for one serving
replica.  A leaf placed on it is one tensor per shard, each on its
device; the controller does the collectives itself (a row-parallel
product's partial sums are added on the lead device, `.to(device)`
spreads activations), and autograd spans devices with no collective
library.  A device may repeat in a mesh: one card then holds a tp = 2
group (`[cuda:0, cuda:0]`), and the CPU tests build 8-entry meshes out of
`cpu`.

What this is not:
- The multi-process form (one process per card, NCCL collectives through
  `torch.distributed`) is what a machine with several cards would run; it
  is later work.
- One host thread issues every shard's launches.  The Orpheus decode step
  is already bound by the host, so tp = 2 on one card is a path for
  correctness, not for speed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Mesh:
    """`devices`: an object array of torch.device, one axis per name."""

    def __init__(self, devices, axis_names: tuple):
        self.devices = np.frompyfunc(torch.device, 1, 1)(np.asarray(devices, dtype=object))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh: devices of shape {self.devices.shape} for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def lead(self) -> torch.device:
        """The first device: where replicated leaves live and partial sums meet."""
        return self.devices.flat[0]

    def axis_devices(self, name: str) -> list:
        """The devices along axis `name`, every other axis at index 0."""
        axis = self.axis_names.index(name)
        index = [0] * self.devices.ndim
        index[axis] = slice(None)
        return list(self.devices[tuple(index)])


def make_mesh(n_devices: int | None = None, tp: int | None = None,
              devices=None) -> Mesh:
    """A (dp, tp) mesh over the first `n_devices` of `devices` (the visible
    CUDA devices when not given; none visible raises, nothing falls back to
    the CPU).  tp defaults to 2 when n is even and above 1, else 1."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is visible (pass devices= "
                               "to build a mesh of other devices)")
    n = n_devices or len(devices)
    devices = list(devices)[:n]
    if tp is None:
        tp = 2 if n % 2 == 0 and n > 1 else 1
    dp = n // tp
    if dp == 0:
        raise ValueError(f"make_mesh: tp={tp} needs at least {tp} devices; got {n}")
    return Mesh([devices[i * tp:(i + 1) * tp] for i in range(dp)], ("dp", "tp"))


class Sharding(NamedTuple):
    """Where a leaf goes: `spec` names, per dimension, the mesh axis it is
    split over (None: not split); an empty spec replicates."""
    mesh: Mesh
    spec: tuple


def named(mesh: Mesh, *spec) -> Sharding:
    return Sharding(mesh, tuple(spec))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


class Shards(list):
    """A leaf split over a mesh axis: shard j is a tensor on the axis's
    j-th device."""


def place(x: torch.Tensor, sharding: Sharding):
    """A replicated leaf -> one tensor on the mesh's lead device; a leaf
    split over an axis -> `Shards`, one contiguous shard per device along
    it.  A dimension the axis does not divide raises."""
    mesh, spec = sharding
    axes = [(dim, name) for dim, name in enumerate(spec) if name is not None]
    if not axes:
        return x.to(mesh.lead)
    if len(axes) > 1:
        raise ValueError(f"place: one split axis per leaf, got spec {spec}")
    dim, name = axes[0]
    devices = mesh.axis_devices(name)
    if x.shape[dim] % len(devices):
        raise ValueError(f"place: dimension {dim} of shape {tuple(x.shape)} does not "
                         f"split over {name}={len(devices)}")
    return Shards(part.contiguous().to(d)
                  for part, d in zip(torch.chunk(x, len(devices), dim=dim), devices))


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts and lists, `Shards` included
    (`rest`: trees of the same structure, whose leaves are passed
    alongside); a list keeps its type."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)
