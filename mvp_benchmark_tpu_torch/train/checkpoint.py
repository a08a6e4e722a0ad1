"""Checkpoints (port of ``mvp_benchmark_tpu/train/checkpoint.py``).

``load_model(path)`` reads the JAX package's pickles,
``{'net_state_dict': {'params', 'batch_stats'}, 'opt_state'}``, whose arrays
are numpy. It needs neither jax nor optax: the unpickler builds numpy and
builtin objects only, and stands an inert ``OpaqueObject`` in for any other
class (the optax states inside ``opt_state``), which the port does not read.
Like any pickle, load only checkpoints this project wrote.

``save_model(path, model, optimizer)`` writes the same layout from the port:
``net_state_dict`` is ``{'params': ...}`` in the flax layout
(``transplant.to_flax_params``), so the JAX package and ``load_flax_params``
both load it, and the torch optimizer's ``state_dict()``, its tensors as
numpy arrays, goes under ``torch_optimizer_state``. Resuming reads
``net_state_dict`` only, as the JAX package does (``engine.py:316-318``).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Optional

import torch

from mvp_benchmark_tpu_torch.models.transplant import to_flax_params

_ALLOWED_MODULES = ("builtins", "collections", "copyreg", "numpy")


class OpaqueObject:
    """Stand-in for a pickled object of a class outside numpy/builtins."""

    qualname = "?"

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args = args
        return obj

    def __setstate__(self, state):
        self.state = state

    def __repr__(self) -> str:
        return f"<OpaqueObject {self.qualname}>"


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if root in _ALLOWED_MODULES:
            return super().find_class(module, name)
        return type(name, (OpaqueObject,), {"qualname": f"{module}.{name}"})


def load_model(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def save_model(path: str, model: torch.nn.Module,
               optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    payload = {"net_state_dict": to_flax_params(model)}
    if optimizer is not None:
        payload["torch_optimizer_state"] = _to_numpy(optimizer.state_dict())
    with open(path, "wb") as f:
        pickle.dump(payload, f)
