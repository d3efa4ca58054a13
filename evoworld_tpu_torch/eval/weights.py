"""Weights of the metric networks (counterpart of `evoworld_tpu/eval/weights.py`).

The port's nets keep upstream's names, so upstream torch checkpoints need
little more than loading:
  - `load_metric_weights`: `lpips.pt`, `inception_v4.pt` and `i3d.pt` (or the
    reference's TorchScript `i3d_torchscript.pt`, read through
    `torch.jit.load`) from a directory, as the JAX CLI reads them;
  - `lpips_state_dict`, `inception_v4_state_dict`, `i3d_state_dict`: an
    upstream state dict in the port's names (LPIPS' input scaling filled in
    where absent, timm's classifier dropped, I3D's container prefixes and
    endpoint casing normalised by `normalize_i3d_keys`);
  - `load_net_`: strict loading (batch norms' `num_batches_tracked` filled in).
The `*_params_from_jax` functions turn the JAX package's Flax variables
(`params` and `batch_stats`, numpy leaves) into the port's state dicts: the
parity tests carry the JAX nets' weights across with them. Kernels go from
Flax HWIO / THWIO to torch OIHW / OITHW, dense kernels transpose.
"""

from __future__ import annotations

import logging
import os
import warnings
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

from evoworld_tpu_torch.eval.feature_nets import _ALEX, ScalingLayer
from evoworld_tpu_torch.models.weights import _flatten, load_checkpoint_, params_from_jax

logger = logging.getLogger("evoworld_tpu_torch")

#: The tag of results scored by nets the port drew at random (a CPU
#: generator seeded with 0): not the JAX package's "random_seed0" weights.
RANDOM_TAG = "random_seed0_torch"


def load_metric_weights(weights_dir: str) -> dict[str, dict[str, torch.Tensor]]:
    """{"lpips" | "inception_v4" | "i3d": fp32 state dict} of the files found
    in `weights_dir` (`<stem>.pt` or `.pth`; `i3d_torchscript` is I3D's
    TorchScript archive, whose module's state dict is taken); absent nets
    are left out."""
    out: dict = {}
    if not weights_dir or not os.path.isdir(weights_dir):
        return out
    for name, stems in (("lpips", ("lpips",)), ("inception_v4", ("inception_v4",)),
                        ("i3d", ("i3d", "i3d_torchscript"))):
        paths = [os.path.join(weights_dir, s + e) for s in stems for e in (".pt", ".pth")]
        path = next((p for p in paths if os.path.exists(p)), None)
        if path is None:
            continue
        try:
            with warnings.catch_warnings():
                # torch.load warns that a TorchScript archive is one before it
                # raises under weights_only=True; the except is the dispatch.
                warnings.simplefilter("ignore", UserWarning)
                sd = torch.load(path, map_location="cpu", weights_only=True)
        except (RuntimeError, ValueError, EOFError) as exc:
            try:
                sd = torch.jit.load(path, map_location="cpu").state_dict()
            except RuntimeError:
                raise exc from None
            logger.info(f"{path}: TorchScript archive; using its state dict")
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        out[name] = {k: v.float() for k, v in sd.items()}
        logger.info(f"loaded metric weights: {path}")
    return out


@torch.no_grad()
def load_net_(model: nn.Module, state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Fill `model` strictly from a port-named state dict; batch norms'
    `num_batches_tracked` counters (eval mode never reads them) may be absent."""
    state = dict(state)
    for k in model.state_dict():
        if k.endswith("num_batches_tracked"):
            state.setdefault(k, torch.zeros((), dtype=torch.long))
    return load_checkpoint_(model, state)


def lpips_state_dict(src: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """An `lpips.LPIPS(net="alex")` state dict, its input scaling filled in
    where absent (the package's weight files hold only the heads and trunk)."""
    out = {k: torch.as_tensor(np.asarray(v)) for k, v in src.items()}
    for k, v in ScalingLayer().state_dict().items():
        out.setdefault(f"scaling_layer.{k}", v)
    return out


def inception_v4_state_dict(src: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A timm `inception_v4` state dict without its classifier (`last_linear`)."""
    return {k: torch.as_tensor(np.asarray(v)) for k, v in src.items() if not k.startswith("last_linear.")}


_I3D_UNITS = ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3")
_I3D_MIXED = ("Mixed_3b", "Mixed_3c", "Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f", "Mixed_5b",
              "Mixed_5c")


def normalize_i3d_keys(src: Mapping[str, Any]) -> dict:
    """I3D state-dict keys onto the videogpt / piergiaj naming: container
    prefixes (`module.`, `model.`, `_model.`, `i3d.`, `net.`) stripped and
    endpoint names recased (CamelCase units and mixes, lowercase logits),
    as scripted or wrapped modules' state dicts need."""
    canon = {n.lower(): n for n in _I3D_UNITS + _I3D_MIXED}
    canon["logits"] = "logits"
    out = {}
    for k, v in src.items():
        changed = True
        while changed:
            changed = False
            for pref in ("module.", "model.", "_model.", "i3d.", "net."):
                if k.startswith(pref):
                    k = k[len(pref):]
                    changed = True
        parts = k.split(".")
        parts[0] = canon.get(parts[0].lower(), parts[0])
        out[".".join(parts)] = v
    return out


def i3d_state_dict(src: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """An upstream I3D state dict (any of the namings `normalize_i3d_keys`
    takes) in the port's names."""
    return {k: torch.as_tensor(np.asarray(v)) for k, v in normalize_i3d_keys(src).items()}


# --------------------------------------------------------------------------
# From the JAX package's Flax variables
# --------------------------------------------------------------------------


def _torch_kernel(value: np.ndarray) -> np.ndarray:
    """A Flax kernel in torch's layout: dense (I, O) -> (O, I), conv HWIO ->
    OIHW, THWIO -> OITHW."""
    if value.ndim == 2:
        return value.T
    return value.transpose(value.ndim - 1, value.ndim - 2, *range(value.ndim - 2))


def _tensors(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(np.asarray(v, np.float32))) for k, v in sd.items()}


def _conv_bn_tree(variables: Mapping[str, Any], rename) -> dict[str, torch.Tensor]:
    """Flax conv / batch-norm variables -> a state dict; `rename` maps a Flax
    module path (a tuple, leaf excluded) to the torch module's name."""
    leaves = {"kernel": "weight", "bias": "bias", "scale": "weight", "mean": "running_mean", "var": "running_var"}
    sd = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})).items():
            sd[f"{rename(path[:-1])}.{leaves[path[-1]]}"] = _torch_kernel(value) if path[-1] == "kernel" else value
    return _tensors(sd)


def lpips_params_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`evoworld_tpu.eval.feature_nets.LPIPSAlex` variables -> `LPIPSAlex`'s state dict."""
    convs = {f"conv{i}": f"slice{s}.{idx}" for i, (s, idx, *_) in enumerate(_ALEX)}

    def rename(path):
        if path[0] == "net":
            return "net." + convs[path[1]]
        return f"{path[0]}.model.1"

    return lpips_state_dict(_conv_bn_tree(variables, rename))


# The JAX module paths of Inception-v4's units -> timm's (features index and
# submodule), the inverse of the JAX package's conversion tables.
_I4_STEM = (("stem0", "0"), ("stem1", "1"), ("stem2", "2"), ("stem3", "3.conv"), ("stem4a", "4.branch0.0"),
            ("stem4b", "4.branch0.1"), ("stem5a", "4.branch1.0"), ("stem5b", "4.branch1.1"),
            ("stem5c", "4.branch1.2"), ("stem5d", "4.branch1.3"), ("stem6", "5.conv"))
_I4_BLOCKS = {
    "A": {"b0": "branch0", "b1a": "branch1.0", "b1b": "branch1.1", "b2a": "branch2.0", "b2b": "branch2.1",
          "b2c": "branch2.2", "b3b": "branch3.1"},
    "RA": {"b0": "branch0", "b1a": "branch1.0", "b1b": "branch1.1", "b1c": "branch1.2"},
    "B": {"b0": "branch0", "b1a": "branch1.0", "b1b": "branch1.1", "b1c": "branch1.2", "b2a": "branch2.0",
          "b2b": "branch2.1", "b2c": "branch2.2", "b2d": "branch2.3", "b2e": "branch2.4", "b3b": "branch3.1"},
    "RB": {"b0a": "branch0.0", "b0b": "branch0.1", "b1a": "branch1.0", "b1b": "branch1.1", "b1c": "branch1.2",
           "b1d": "branch1.3"},
    "C": {"b0": "branch0", "b1a": "branch1_0", "b1b1": "branch1_1a", "b1b2": "branch1_1b", "b2a": "branch2_0",
          "b2b": "branch2_1", "b2c": "branch2_2", "b2d1": "branch2_3a", "b2d2": "branch2_3b", "b3b": "branch3.1"},
}


def _inception_block(name: str) -> tuple[int, dict]:
    """A JAX block name -> (timm features index, its branch table)."""
    if name == "reduction_a":
        return 10, _I4_BLOCKS["RA"]
    if name == "reduction_b":
        return 18, _I4_BLOCKS["RB"]
    kind, i = name[len("mixed_"):].split("_")[0][0], int(name[-1])
    return {"a": 6, "b": 11, "c": 19}[kind] + i, _I4_BLOCKS[kind.upper()]


def inception_v4_params_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`InceptionV4Features` variables -> the port's (timm-named) state dict."""
    stem = dict(_I4_STEM)

    def rename(path):
        *units, layer = path
        if len(units) == 1:
            return f"features.{stem[units[0]]}.{layer}"
        index, table = _inception_block(units[0])
        return f"features.{index}.{table[units[1]]}.{layer}"

    return _conv_bn_tree(variables, rename)


def i3d_params_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`InceptionI3D` variables -> the port's (videogpt-named) state dict."""
    return _conv_bn_tree(variables, ".".join)


def dino_params_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """`evoworld_tpu.eval.dreamsim.DinoViT` variables -> the port's DINO state dict."""
    modules = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2", "norm1": "norm1",
               "norm2": "norm2"}
    sd = {}
    for path, value in _flatten(variables.get("params", variables)).items():
        leaf = {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1])
        if path[0] == "cls_token":
            sd["cls_token"] = value.reshape(1, 1, -1)
        elif path[0] == "pos_embed":
            sd["pos_embed"] = value[None]
        elif path[0] == "patch_embed":
            sd[f"patch_embed.proj.{leaf}"] = _torch_kernel(value) if path[-1] == "kernel" else value
        elif path[0] == "norm":
            sd[f"norm.{leaf}"] = value
        else:  # block_i
            block = f"blocks.{path[0][len('block_'):]}"
            if path[1] in ("ls1", "ls2"):
                sd[f"{block}.{path[1]}.gamma"] = value
            else:
                sd[f"{block}.{modules[path[1]]}.{leaf}"] = _torch_kernel(value) if path[-1] == "kernel" else value
    return _tensors(sd)


def clip_b32_params_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A DreamSim CLIP branch's `CLIPVisionTower` variables -> the branch's state dict."""
    return {"tower." + k: v for k, v in params_from_jax(variables).items()}
