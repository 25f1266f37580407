"""Data-parallel request serving across cards, counterpart of
`tts_tpu/parallel/serving.py`.

One runner replica is committed to each card (or to each group of cards,
under tensor parallelism); the server routes each request to a replica,
so independent requests run on independent cards with no collectives.
Replicas go on distinct visible CUDA devices: a device that repeats in a
mesh is for the registry and the tests, not for the server.
"""

from __future__ import annotations

import torch

from tts_tpu_torch.parallel.mesh import Mesh


def _has_tensor(val) -> bool:
    """True if val is a tensor or nests one in dicts, lists or tuples."""
    if isinstance(val, torch.Tensor):
        return True
    if isinstance(val, dict):
        return any(_has_tensor(v) for v in val.values())
    if isinstance(val, (list, tuple)):
        return any(_has_tensor(v) for v in val)
    return False


def _move_tree(val, device):
    if isinstance(val, torch.Tensor):
        return val.to(device)
    if isinstance(val, dict):
        return {k: _move_tree(v, device) for k, v in val.items()}
    if isinstance(val, (list, tuple)):
        return type(val)(_move_tree(v, device) for v in val)
    return val


def move_to_device(obj, device) -> None:
    """Commit every declared device attribute of `obj` onto `device`.

    Classes declare their device state: `device_arrays` names attributes
    holding tensors (or dicts and lists of them), `device_components`
    nested objects (model, codec) that carry their own declarations.  An
    object's `device` attribute, where it has one, becomes `device`, and
    its `placed()` runs after the move where it defines one.  Any
    undeclared attribute that still holds a tensor raises afterwards: a
    new attribute cannot silently stay on the old device."""
    device = torch.device(device)
    arrays = getattr(obj, "device_arrays", ())
    components = getattr(obj, "device_components", ())
    for name in arrays:
        if getattr(obj, name, None) is not None:
            setattr(obj, name, _move_tree(getattr(obj, name), device))
    for name in components:
        if getattr(obj, name, None) is not None:
            move_to_device(getattr(obj, name), device)
    if hasattr(obj, "device"):
        obj.device = device
    if hasattr(obj, "placed"):
        obj.placed()
    declared = set(arrays) | set(components)
    for name, val in vars(obj).items():
        if name not in declared and _has_tensor(val):
            raise RuntimeError(
                f"{type(obj).__name__}.{name} holds tensors but is not in "
                f"device_arrays/device_components: declare it so replicas are wholly "
                f"committed to their device")


def load_replica(model_path: str, config, target):
    """A runner committed to `target`: a device (the weights load there)
    or a ("tp",) mesh (tensor-parallel through the model's
    make_tp_context).  A device's runner then passes `move_to_device`'s
    check that it holds no undeclared device state."""
    from tts_tpu_torch.models.registry import runner_from_file

    if isinstance(target, Mesh):
        return runner_from_file(model_path, config, mesh=target)
    runner = runner_from_file(model_path, config, device=target)
    move_to_device(runner, target)
    return runner


def serving_devices(n: int | None = None) -> list:
    """The visible CUDA devices, each once (the first n): where replicas go."""
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devices[: n or len(devices)]


def replica_meshes(tensor_parallel: int, n_replicas: int | None = None) -> list:
    """DP x TP: partition the visible cards into disjoint ("tp",) meshes of
    `tensor_parallel` distinct cards each, one per replica;
    tensor_parallel=1 gives plain per-card replicas (devices).  Too few
    cards raise."""
    tp = max(tensor_parallel, 1)
    devices = serving_devices()
    n_groups = len(devices) // tp
    if n_groups == 0:
        raise ValueError(f"tensor_parallel={tp} needs at least {tp} devices; "
                         f"{len(devices)} visible")
    if n_replicas is not None:
        n_groups = min(n_groups, n_replicas)
    groups = [devices[g * tp:(g + 1) * tp] for g in range(n_groups)]
    return [g[0] for g in groups] if tp == 1 else [Mesh(g, ("tp",)) for g in groups]
