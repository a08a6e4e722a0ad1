"""Parameter transplant from the JAX models into the ported torch modules.

``load_flax_params(model, variables)`` takes the JAX variables as nested
dicts of numpy arrays -- ``{'params': {...}, 'batch_stats': {...}}`` as
``train/checkpoint.py`` pickles them, or the ``params`` tree itself -- and
copies every leaf into the torch module. flax kernels are (in, out); torch
weights are (out, in). ``batch_stats`` (BatchNorm running statistics, DCP's)
go to the torch buffers of the same names in the same modules; a model with
such buffers needs them, a model without refuses them.

Each ported model has an explicit table from flax scope paths (flax names a
module's children ``<Class>_<k>`` in the order it builds them) to torch
submodule names; VRCNet's depends on the config, so it is built from the
model. The copy fails loudly on any flax leaf without a home, any torch
parameter left unfilled, and any shape that disagrees.

Leaves by name: ``kernel``/``bias`` go to ``weight`` (transposed) and
``bias``; a MultiDense's ``kernel{i}``/``bias{i}`` to ``weight{i}``
(transposed) and ``bias{i}``; a norm's ``scale`` to ``weight``; VRCNet's raw
SA parameters ``w_mlp1``, ``w_mlp2`` and ``w_mlp2_bias``, DCP's fused
edge-chain parameters ``fused_W{i}``, ``fused_scale{i}`` and
``fused_bias{i}``, and IDAM's Propagate ``edge_*`` and similarity-MLP
``sim{i}_*`` parameters (the latter at the model's root scope, "" in its
table) to the torch parameters of the same name, in the flax orientation
(they enter a product as ``x @ W``).

VRCNet's prior net (``LinearResBlock_2``, ``prior_infer``) runs only in the
train branch: a checkpoint written by training holds it, a tree made for eval
need not. ``load_flax_params`` accepts a tree without it unless
``for_training``, and leaves the port's prior net as it was.

``to_flax_params(model)`` is the inverse: the port's parameters as the flax
variables ``{'params': {...}}`` of numpy float32 arrays, plus
``'batch_stats'`` where the model keeps running statistics, which
``train/checkpoint.py`` pickles so that the JAX package loads the port's
checkpoints and the port loads the JAX package's. ``to_flax_grads(model)``
maps the parameters' ``.grad`` into the same flax tree, so that a gradient
compares leaf by leaf with ``jax.grad`` of the JAX model.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from mvp_benchmark_tpu_torch.models import dcp, ecg, idam, layers, pcn, vrcnet

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


def _dense3(flax: str, torch_name: str) -> dict:
    """A module whose TorchDense_0..2 are torch ``fc1``..``fc3``."""
    return {f"{flax}/TorchDense_{i}": f"{torch_name}.fc{i + 1}" for i in range(3)}


def _vrcnet_table(model: "vrcnet.Model") -> dict:
    dec, tdec = "MSAPSKNDecoder_0", "decoder"
    table = {
        **_PCN_ENCODER,
        **_dense3("LinearResBlock_0", "posterior_infer1"),
        **_dense3("LinearResBlock_1", "posterior_infer2"),
        **_dense3("LinearResBlock_2", "prior_infer"),
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


def _dcp_table() -> dict:
    table = {"DGCNN_0": "emb_nn", "DGCNN_0/TorchDense_0": "emb_nn.fc",
             "DGCNN_0/BatchNorm_0/BatchNorm_0": "emb_nn.bn",
             "Transformer_0/UnbiasedLayerNorm_0": "transformer.enc_norm",
             "Transformer_0/UnbiasedLayerNorm_1": "transformer.dec_norm"}
    for side, norms in (("Encoder", 2), ("Decoder", 3)):
        flax = f"Transformer_0/{side}Layer_0"
        tl = f"transformer.{side.lower()}.0"
        table.update({f"{flax}/UnbiasedLayerNorm_{i}": f"{tl}.norm{i}"
                      for i in range(norms)})
        table[f"{flax}/MultiHeadedAttention_0/MultiDense_0"] = f"{tl}.self_attn.proj"
        table[f"{flax}/MultiHeadedAttention_0/TorchDense_0"] = f"{tl}.self_attn.out"
        table[f"{flax}/FeedForward_0/TorchDense_0"] = f"{tl}.ff.fc1"
        table[f"{flax}/FeedForward_0/TorchDense_1"] = f"{tl}.ff.fc2"
    cross, tc = ("Transformer_0/DecoderLayer_0/MultiHeadedAttention_1",
                 "transformer.decoder.0.src_attn")
    table.update({f"{cross}/TorchDense_0": f"{tc}.q",
                  f"{cross}/MultiDense_0": f"{tc}.proj",
                  f"{cross}/TorchDense_1": f"{tc}.out"})
    return table


_DCP = _dcp_table()


def _idam_table(model: "idam.Model") -> dict:
    """IDAM's scopes; the root scope "" holds the similarity MLPs' raw
    parameters and running statistics (``sim{i}_*``), each Propagate its edge
    block's (``edge_*``)."""
    table = {"": ""}
    for p in range(len(model.gnn.props)):
        fp, tp = f"GNN_0/Propagate_{p}", f"gnn.props.{p}"
        table[fp] = tp
        table[f"{fp}/TorchDense_0"] = f"{tp}.fc"
        table[f"{fp}/ConvBlock_0/TorchDense_0"] = f"{tp}.conv.denses.0"
    blocks = [("ConvBlock_0", "significance_fc", model.significance_fc)]
    blocks += [(f"ConvBlock_{i + 1}", f"weight_fcs.{i}", blk)
               for i, blk in enumerate(model.weight_fcs)]
    for fb, tb, blk in blocks:
        table.update({f"{fb}/TorchDense_{n}": f"{tb}.denses.{n}"
                      for n in range(len(blk.denses))})
        table.update({f"{fb}/BatchNorm_{n}/BatchNorm_0": f"{tb}.bns.{n}"
                      for n in range(len(blk.bns))})
    return table


_RAW_PATTERN = (r"(w_mlp1|w_mlp2|w_mlp2_bias|fused_(W|scale|bias)\d+|edge_(W|b|scale|bias)"
                r"|sim\d+_(Wcat|W2|b2|W3|W4|b4|scale1|bias1|scale2|bias2))")
_NORMS = (layers.BatchNorm, layers.UnbiasedLayerNorm)

FLAX_TO_TORCH = {pcn.Model: _PCN, ecg.Model: _ECG, vrcnet.Model: _vrcnet_table,
                 dcp.Model: _DCP, idam.Model: _idam_table}
# scopes that only a train branch runs, which an eval tree may lack
_TRAIN_ONLY = ("LinearResBlock_2/",)


def _table(model: torch.nn.Module) -> dict:
    table = FLAX_TO_TORCH.get(type(model))
    if table is None:
        raise NotImplementedError(
            f"no flax->torch table for {type(model).__module__}."
            f"{type(model).__name__}")
    return table(model) if callable(table) else table


def _join(module_name: str, attr: str) -> str:
    """The torch name of ``attr`` of the submodule ``module_name`` ("" is
    the model itself)."""
    return f"{module_name}.{attr}" if module_name else attr


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


def _torch_attr(module: torch.nn.Module, key: str):
    """(torch attribute, transpose?) of a flax param leaf of ``module``."""
    m = re.fullmatch(r"(kernel|bias|scale)(\d*)", key)
    if m is not None and not (m[1] == "scale" and not isinstance(module, _NORMS)):
        attr = ("bias" if m[1] == "bias" else "weight") + m[2]
        return attr, m[1] == "kernel"
    if re.fullmatch(_RAW_PATTERN, key):
        return key, False
    return None, False


def _flax_key(module: torch.nn.Module, attr: str):
    """The flax leaf of a torch parameter, and whether to transpose it."""
    m = re.fullmatch(r"(weight|bias)(\d*)", attr)
    if m is not None and m[1] == "weight":
        if isinstance(module, _NORMS):
            return "scale", False
        return f"kernel{m[2]}", True
    if m is not None or re.fullmatch(_RAW_PATTERN, attr):
        return attr, False
    return None, False


def _split(variables: Mapping[str, Any]):
    """(params, batch_stats or None) of a variables dict or a bare params
    tree; any other collection has no torch home."""
    if "params" not in variables:
        return variables, None
    extra = sorted(k for k, v in variables.items()
                   if k not in ("params", "batch_stats") and v)
    if extra:
        raise ValueError(f"collections {extra} have no torch home")
    return variables["params"], variables.get("batch_stats") or None


def _load_stats(model: torch.nn.Module, table: dict, stats) -> None:
    buffers = dict(model.named_buffers())
    if stats is None:
        if buffers:
            raise ValueError(f"{type(model).__name__} keeps running statistics "
                             f"{sorted(buffers)}: the flax variables need "
                             "'batch_stats'")
        return
    filled = set()
    for path, arrays in _leaf_modules(stats).items():
        if path not in table:
            raise ValueError(f"batch_stats scope {path} has no torch home")
        for key, value in arrays.items():
            name = _join(table[path], key)
            if name not in buffers:
                raise ValueError(f"batch_stats {path}/{key}: "
                                 f"{type(model).__name__} has no buffer {name}")
            _copy(buffers[name], value, f"batch_stats {path}/{key}")
            filled.add(name)
    unfilled = sorted(set(buffers) - filled)
    if unfilled:
        raise ValueError(f"torch buffers not in batch_stats: {unfilled}")


def load_flax_params(model: torch.nn.Module, variables: Mapping[str, Any],
                     for_training: bool = False) -> torch.nn.Module:
    table = _table(model)
    params, stats = _split(variables)
    leaves = _leaf_modules(params)
    unknown = sorted(set(leaves) - set(table))
    absent = [k for k in table if k not in leaves]
    skipped = [k for k in absent
               if not for_training and k.startswith(_TRAIN_ONLY)]
    missing = sorted(set(absent) - set(skipped))
    if unknown or missing:
        raise ValueError(f"flax tree does not match {type(model).__name__}: "
                         f"unknown {unknown}, missing {missing}")

    filled = set()
    for path, arrays in leaves.items():
        name = table[path]
        module = model.get_submodule(name)
        for key, value in arrays.items():
            attr, transpose = _torch_attr(module, key)
            if attr is None:
                raise ValueError(f"{path}/{key}: no torch counterpart")
            if transpose:
                value = np.asarray(value).T
            param = getattr(module, attr, None)
            if not isinstance(param, torch.nn.Parameter):
                raise ValueError(f"{path}/{key}: {name} has no parameter {attr}")
            _copy(param, value, f"{path}/{key}")
            filled.add(_join(name, attr))
    left = {f"{table[k]}." for k in skipped}
    unfilled = sorted(n for n, _ in model.named_parameters()
                      if n not in filled and not n.startswith(tuple(left)))
    if unfilled:
        raise ValueError(f"torch parameters not in the flax tree: {unfilled}")
    _load_stats(model, table, stats)
    return model


def to_flax_params(model: torch.nn.Module) -> Dict[str, Any]:
    """The inverse of ``load_flax_params``: {'params': nested dicts of numpy
    float32 arrays in the flax layout} (kernels (in, out), norms' ``scale``,
    raw leaves as they are), with 'batch_stats' where the model keeps
    running statistics."""
    return _flax_tree(model, lambda p: p, with_stats=True)


def to_flax_grads(model: torch.nn.Module) -> Dict[str, Any]:
    """{'params': ...} of every parameter's ``.grad`` in the flax layout of
    ``to_flax_params`` (zeros where a parameter has none)."""
    return _flax_tree(model, lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
                      with_stats=False)


def _flax_tree(model: torch.nn.Module, leaf, with_stats: bool) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    done = set()
    buffers = dict(model.named_buffers())
    for path, name in _table(model).items():
        module = model.get_submodule(name)
        for attr, param in module.named_parameters(recurse=False):
            key, transpose = _flax_key(module, attr)
            if key is None:
                raise ValueError(f"{name}.{attr}: no flax counterpart")
            value = leaf(param).detach().cpu().numpy().astype(np.float32)
            _node(tree, path)[key] = np.ascontiguousarray(value.T) if transpose else value
            done.add(_join(name, attr))
        for attr, buf in module.named_buffers(recurse=False):
            _node(stats, path)[attr] = buf.detach().cpu().numpy().astype(np.float32)
            done.add(_join(name, attr))
    left = sorted(n for n in [*dict(model.named_parameters()), *buffers]
                  if n not in done)
    if left:
        raise ValueError(f"torch parameters without a flax scope: {left}")
    if with_stats and stats:
        return {"params": tree, "batch_stats": stats}
    return {"params": tree}


def _node(tree: Dict[str, Any], path: str) -> Dict[str, Any]:
    for part in filter(None, path.split("/")):
        tree = tree.setdefault(part, {})
    return tree
