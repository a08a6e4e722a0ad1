"""Parameter transplant from the JAX models into the ported torch modules.

``load_flax_params(model, variables)`` takes the JAX variables as nested
dicts of numpy arrays -- ``{'params': {...}}`` as ``train/checkpoint.py``
pickles them, or the ``params`` tree itself -- and copies every leaf into the
torch module. flax kernels are (in, out); torch weights are (out, in).

Each ported model has an explicit table from flax scope paths (flax names a
module's children ``<Class>_<k>`` in the order it builds them) to torch
submodule names; VRCNet's depends on the config, so it is built from the
model. The copy fails loudly on any flax leaf without a home, any torch
parameter left unfilled, and any shape that disagrees.

Leaves by name: ``kernel``/``bias`` go to ``weight`` (transposed) and
``bias``; a MultiDense's ``kernel{i}``/``bias{i}`` to ``weight{i}``
(transposed) and ``bias{i}``; VRCNet's raw SA parameters ``w_mlp1``,
``w_mlp2`` and ``w_mlp2_bias`` to the torch parameters of the same name, in
the flax orientation (they enter a product as ``w_in @ W1``).

A scope mapped to None is one the ported branches never run (VRCNet's prior
net, ``LinearResBlock_2``, which only the train branch calls): a checkpoint
written by JAX training holds it, a tree made for eval does not, and either
loads.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from mvp_benchmark_tpu_torch.models import ecg, pcn, vrcnet

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

_RAW_LEAVES = ("w_mlp1", "w_mlp2", "w_mlp2_bias")


def _dense3(flax: str, torch_name: str) -> dict:
    """A module whose TorchDense_0..2 are torch ``fc1``..``fc3``."""
    return {f"{flax}/TorchDense_{i}": f"{torch_name}.fc{i + 1}" for i in range(3)}


def _vrcnet_table(model: "vrcnet.Model") -> dict:
    dec, tdec = "MSAPSKNDecoder_0", "decoder"
    table = {
        **_PCN_ENCODER,
        **_dense3("LinearResBlock_0", "posterior_infer1"),
        **_dense3("LinearResBlock_1", "posterior_infer2"),
        **dict.fromkeys(_dense3("LinearResBlock_2", "prior_infer")),
        **_dense3("LinearResBlock_3", "generator"),
    }
    heads = ["fc1", "fc2", "fc3", "fc4", "fc5"]
    if model.decoder.top_k:
        heads += ["score1", "score2", "score3"]
    if model.decoder.step_ratio:
        # fine = Dense(3)(relu(Dense(64)(up))): flax names the outer Dense first
        heads += ["fine_out", "fine_mid"]
        table[f"{dec}/Folding_0/DenseCat_0"] = f"{tdec}.folding.fold"
    table.update({f"{dec}/TorchDense_{i}": f"{tdec}.{n}"
                  for i, n in enumerate(heads)})

    enc, tenc = f"{dec}/SASKNResEncoder_0", f"{tdec}.encoder"
    names = ("gf1", "gf2", "gf3", "up3", "up2", "up1", "out")
    table.update({f"{enc}/TorchDense_{i}": f"{tenc}.{n}"
                  for i, n in enumerate(names)})
    table[f"{enc}/DenseCat_0"] = f"{tenc}.up4"
    for u, unit in enumerate(model.decoder.encoder.units):
        fu, tu = f"{enc}/SKNResUnit_{u}", f"{tenc}.units.{u}"
        for i, n in enumerate(("fc_in", "fc_out", "fc_skip")):
            table[f"{fu}/TorchDense_{i}"] = f"{tu}.{n}"
        for b, block in enumerate(unit.blocks):
            fb, tb = f"{fu}/SKSAModule_{b}", f"{tu}.blocks.{b}"
            table[f"{fb}/TorchDense_0"] = f"{tb}.fc_z"
            for i in range(len(block.branches)):
                fs, ts = f"{fb}/SAModule_{i}", f"{tb}.branches.{i}"
                table[fs] = ts                    # w_mlp1, w_mlp2, w_mlp2_bias
                table[f"{fs}/MultiDense_0"] = f"{ts}.proj"
                table[f"{fs}/TorchDense_0"] = f"{ts}.out"
                table[f"{fb}/TorchDense_{i + 1}"] = f"{tb}.fcs.{i}"
    return table


FLAX_TO_TORCH = {pcn.Model: _PCN, ecg.Model: _ECG, vrcnet.Model: _vrcnet_table}


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
    if callable(table):
        table = table(model)
    if "params" in variables:
        extra = sorted(k for k, v in variables.items() if k != "params" and v)
        if extra:
            raise ValueError(f"collections {extra} have no torch home")
        params = variables["params"]
    else:
        params = variables
    leaves = _leaf_modules(params)
    unknown = sorted(set(leaves) - set(table))
    missing = sorted(k for k, v in table.items() if v is not None and k not in leaves)
    if unknown or missing:
        raise ValueError(f"flax tree does not match {type(model).__name__}: "
                         f"unknown {unknown}, missing {missing}")

    filled = set()
    for path, arrays in leaves.items():
        name = table[path]
        if name is None:
            continue
        module = model.get_submodule(name)
        for key, value in arrays.items():
            m = re.fullmatch(r"(kernel|bias)(\d*)", key)
            if m is not None:
                attr = ("weight" if m[1] == "kernel" else "bias") + m[2]
                if m[1] == "kernel":
                    value = np.asarray(value).T
            elif key in _RAW_LEAVES:
                attr = key
            else:
                raise ValueError(f"{path}/{key}: no torch counterpart")
            param = getattr(module, attr, None)
            if not isinstance(param, torch.nn.Parameter):
                raise ValueError(f"{path}/{key}: {name} has no parameter {attr}")
            _copy(param, value, f"{path}/{key}")
            filled.add(f"{name}.{attr}")
    unfilled = sorted(set(n for n, _ in model.named_parameters()) - filled)
    if unfilled:
        raise ValueError(f"torch parameters not in the flax tree: {unfilled}")
    return model
