"""Parameter transplant from the JAX models into the ported torch modules.

``load_flax_params(model, variables)`` takes the JAX variables as nested
dicts of numpy arrays -- ``{'params': {...}}`` as ``train/checkpoint.py``
pickles them, or the ``params`` tree itself -- and copies every leaf into the
torch module. flax kernels are (in, out); torch weights are (out, in).

Each ported model has an explicit table from flax scope paths (flax names a
module's children ``<Class>_<k>`` in call order) to torch submodule names.
The copy fails loudly on any flax leaf without a home, any torch parameter
left unfilled, and any shape that disagrees.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from mvp_benchmark_tpu_torch.models import ecg, pcn

_PCN_ENCODER = {
    "PCNEncoder_0/TorchDense_0": "encoder.fc1",
    "PCNEncoder_0/TorchDense_1": "encoder.fc2",
    "PCNEncoder_0/DenseCat_0": "encoder.fc3",
    "PCNEncoder_0/TorchDense_2": "encoder.fc4",
}

_PCN = {
    **_PCN_ENCODER,
    "PCNDecoder_0/TorchDense_0": "decoder.fc1",
    "PCNDecoder_0/TorchDense_1": "decoder.fc2",
    "PCNDecoder_0/TorchDense_2": "decoder.fc3",
    "PCNDecoder_0/DenseCat_0": "decoder.fold1",
    "PCNDecoder_0/TorchDense_3": "decoder.fold2",
    "PCNDecoder_0/TorchDense_4": "decoder.fold3",
}


def _ecg_table() -> dict:
    ef = "ECGDecoder_0/EFEncoder_0"
    table = {
        **_PCN_ENCODER,
        "ECGDecoder_0/TorchDense_0": "decoder.fc1",
        "ECGDecoder_0/TorchDense_1": "decoder.fc2",
        "ECGDecoder_0/TorchDense_2": "decoder.fc3",
        "ECGDecoder_0/TorchDense_3": "decoder.fc4",
        "ECGDecoder_0/TorchDense_4": "decoder.fc5",
    }
    names = ("lift", "down2", "down3", "down4", "gf1", "gf2", "gf3")
    table.update({f"{ef}/TorchDense_{i}": f"decoder.ef.{n}"
                  for i, n in enumerate(names)})
    names = ("up4", "up3", "up2", "out")
    table.update({f"{ef}/DenseCat_{i}": f"decoder.ef.{n}"
                  for i, n in enumerate(names)})
    for i in range(4):
        conv, torch_conv = f"{ef}/DenseConv_{i}", f"decoder.ef.conv{i + 1}"
        table[f"{conv}/DenseEdge_0"] = f"{torch_conv}.edge"
        table[f"{conv}/DenseCat_0"] = f"{torch_conv}.convs.0"
        table[f"{conv}/DenseCat_1"] = f"{torch_conv}.convs.1"
    return table


_ECG = _ecg_table()

FLAX_TO_TORCH = {pcn.Model: _PCN, ecg.Model: _ECG}


def _leaf_modules(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, dict]:
    """{'A_0': {'B_1': {'kernel': x}}} -> {'A_0/B_1': {'kernel': x}}."""
    out: Dict[str, dict] = {}
    arrays = {k: v for k, v in tree.items() if not isinstance(v, Mapping)}
    if arrays:
        out[prefix.rstrip("/")] = arrays
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_leaf_modules(v, f"{prefix}{k}/"))
    return out


def _copy(param: torch.Tensor, value: np.ndarray, where: str) -> None:
    value = torch.from_numpy(np.array(value, np.float32))
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{where}: flax shape {tuple(value.shape)} does not "
                         f"fit torch shape {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value)


def load_flax_params(model: torch.nn.Module,
                     variables: Mapping[str, Any]) -> torch.nn.Module:
    table = FLAX_TO_TORCH.get(type(model))
    if table is None:
        raise NotImplementedError(
            f"no flax->torch table for {type(model).__module__}."
            f"{type(model).__name__}")
    if "params" in variables:
        extra = sorted(k for k, v in variables.items() if k != "params" and v)
        if extra:
            raise ValueError(f"collections {extra} have no torch home")
        params = variables["params"]
    else:
        params = variables
    leaves = _leaf_modules(params)
    unknown = sorted(set(leaves) - set(table))
    missing = sorted(set(table) - set(leaves))
    if unknown or missing:
        raise ValueError(f"flax tree does not match {type(model).__name__}: "
                         f"unknown {unknown}, missing {missing}")

    filled = set()
    for path, arrays in leaves.items():
        name = table[path]
        module = model.get_submodule(name)
        for key, value in arrays.items():
            if key == "kernel":
                _copy(module.weight, np.asarray(value).T, f"{path}/kernel")
                filled.add(f"{name}.weight")
            elif key == "bias":
                _copy(module.bias, value, f"{path}/bias")
                filled.add(f"{name}.bias")
            else:
                raise ValueError(f"{path}/{key}: no torch counterpart")
    unfilled = sorted(set(n for n, _ in model.named_parameters()) - filled)
    if unfilled:
        raise ValueError(f"torch parameters not in the flax tree: {unfilled}")
    return model
