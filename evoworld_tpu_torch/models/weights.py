"""Weights for the port's modules: carried across from the JAX package's Flax
trees, or drawn at random.

`params_from_jax` inverts the layout rules of `evoworld_tpu/models/weights.py`
(whose converters map diffusers/transformers names onto Flax trees):
  - Flax conv kernels HWIO / THWIO -> torch OIHW / OITHW;
  - Flax dense kernels (I, O) -> torch Linear (O, I);
  - norm `scale` -> `weight`, dropping the fp32-norm wrapper's inner `norm`;
  - module lists `resnets_0` -> `resnets.0`, `to_out` -> `to_out.0`, the
    GEGLU MLP's `proj_in`/`proj_out` -> `net.0.proj`/`net.2`;
  - the VAE's flat names (`down_blocks_1_resnets_0`, `mid_attn`) and CLIP's
    `vision_model.` prefix.
It takes numpy leaves (any array with `np.asarray`) and returns a state dict
that `load_state_dict(strict=True)` accepts.

`vggt_params_from_jax` inverts `evoworld_tpu/models/vggt/weights.py::
convert_vggt_state_dict` the same way: scanned block stacks (`dino_blocks`,
`blocks_K/frame|global`, the camera trunk) unstack into upstream's numbered
blocks, the flat special tokens fold back into upstream's `pos_embed`
(1, 1+P, C), `camera_token` (1, 2, 1, C) and `register_token` (1, 2, R, C),
and transposed-conv kernels take back their spatial flip.

`init_random_` fills a module in place with deterministic role-aware random
values, the rules of `host_random_params`: norm weights 1, `mix_factor` 0.5,
biases and the class embedding 0, weights of rank >= 2 normal with std
sqrt(1 / fan_in) (fan_in from torch's OIHW layout: every axis but the first),
other vectors normal with std 0.02.

`load_safetensors` / `save_safetensors` read and write the safetensors
format with the standard library and torch alone (the `safetensors` package
is not a dependency): an 8-byte little-endian header length, a JSON header
of `{name: {"dtype", "shape", "data_offsets"}}` and the raw little-endian
data; `safetensors_shapes` reads a file's header alone. `load_safetensors_dir`
merges every `*.safetensors` of a directory (sharded checkpoints), `expand_conv_in_weight` is the UNet's 8 -> 18 input
channel surgery, and `load_checkpoint_` / `load_vggt_checkpoint` fill the
port's modules from upstream-named state dicts.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
import struct
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

_LIST_SEGMENT = re.compile(
    r"(down_blocks|up_blocks|resnets|attentions|transformer_blocks|temporal_transformer_blocks"
    r"|downsamplers|upsamplers|layers)_(\d+)"
)
_VAE_SEGMENT = (
    (re.compile(r"(down|up)_blocks_(\d+)_resnets_(\d+)"), r"\1_blocks.\2.resnets.\3"),
    (re.compile(r"down_blocks_(\d+)_downsamplers_0"), r"down_blocks.\1.downsamplers.0"),
    (re.compile(r"up_blocks_(\d+)_upsamplers_0"), r"up_blocks.\1.upsamplers.0"),
    (re.compile(r"mid_resnets_(\d+)"), r"mid_block.resnets.\1"),
    (re.compile(r"mid_attn"), r"mid_block.attentions.0"),
)
_CLIP_SUBMODULE = {
    "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj", "v_proj": "self_attn.v_proj",
    "out_proj": "self_attn.out_proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2",
}


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _leaf(name: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    """Flax leaf -> (torch leaf name, torch-layout value)."""
    if name == "scale":
        return "weight", value
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 5:
            return "weight", value.transpose(4, 3, 0, 1, 2)
        raise ValueError(f"unexpected kernel rank {value.ndim}")
    return name, value


def _segments(path: tuple, kind: str) -> list[str]:
    """Rename the module segments of one Flax path (leaf excluded)."""
    segs = list(path)
    if len(segs) >= 2 and segs[-1] == "norm":  # our fp32-norm wrapper's inner module
        segs = segs[:-1]
    out = []
    for i, s in enumerate(segs):
        parent = segs[i - 1] if i else ""
        if kind == "vae":
            for pat, rep in _VAE_SEGMENT:
                if pat.fullmatch(s):
                    s = pat.sub(rep, s)
                    break
        elif kind == "clip":
            if _LIST_SEGMENT.fullmatch(s):
                s = "encoder." + _LIST_SEGMENT.sub(r"\1.\2", s)
            s = _CLIP_SUBMODULE.get(s, s)
        if kind != "clip":
            s = _LIST_SEGMENT.sub(r"\1.\2", s) if _LIST_SEGMENT.fullmatch(s) else s
        if s == "to_out":
            s = "to_out.0"
        elif parent in ("ff", "ff_in") and s in ("proj_in", "proj_out"):
            s = "net.0.proj" if s == "proj_in" else "net.2"
        out.append(s)
    return out


def params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax params of the UNet, VAE or CLIP tower (`{"params": ...}` or the
    inner dict) -> the port's state dict (fp32 CPU tensors unless the leaves
    carry another float dtype)."""
    tree = tree.get("params", tree)
    if "encoder" in tree and "decoder" in tree:
        kind = "vae"
    elif "patch_embedding" in tree:
        kind = "clip"
    else:
        kind = "unet"
    sd = {}
    for path, value in _flatten(tree).items():
        leaf, value = _leaf(path[-1], value)
        segs = _segments(path[:-1], kind)
        if kind == "vae" and segs == ["encoder", "quant_conv"]:
            segs = ["quant_conv"]
        if kind == "clip":
            if path[0] == "visual_projection":
                segs = ["visual_projection"]
            elif path[0] in ("patch_embedding", "class_embedding", "position_embedding"):
                segs = ["vision_model", "embeddings"] + (segs or [])
                if path[0] == "class_embedding":
                    leaf = "class_embedding"
                elif path[0] == "position_embedding":
                    segs, leaf = segs + ["position_embedding"], "weight"
            else:
                segs = ["vision_model"] + segs
        name = ".".join(segs + [leaf])
        if value.dtype.kind != "f" or value.dtype.itemsize < 4:
            value = value.astype(np.float32)
        sd[name] = torch.tensor(value)
    return sd


_VGGT_BLOCK_MODULES = {"qkv": "attn.qkv", "proj": "attn.proj", "q_norm": "attn.q_norm", "k_norm": "attn.k_norm",
                       "fc1": "mlp.fc1", "fc2": "mlp.fc2", "norm1": "norm1", "norm2": "norm2"}
_VGGT_RENAMES = (  # Flax module path (regex, leaf excluded) -> upstream module path
    (r"aggregator/patch_embed", "aggregator.patch_embed.patch_embed.proj"),
    (r"aggregator/dino_norm", "aggregator.patch_embed.norm"),
    (r"camera_head/poseLN_modulation", "camera_head.poseLN_modulation.1"),
    (r"camera_head/pose_branch_fc(\d)", r"camera_head.pose_branch.fc\1"),
    (r"(depth|point)_head/project_(\d)", r"\1_head.projects.\2"),
    (r"(depth|point)_head/resize_(\d)", r"\1_head.resize_layers.\2"),
    (r"(depth|point)_head/layer_(\d)_rn", r"\1_head.scratch.layer\2_rn"),
    (r"(depth|point)_head/refinenet(\d)/res(\d)_conv(\d)", r"\1_head.scratch.refinenet\2.resConfUnit\3.conv\4"),
    (r"(depth|point)_head/refinenet(\d)/out_conv", r"\1_head.scratch.refinenet\2.out_conv"),
    (r"(depth|point)_head/output_conv1", r"\1_head.scratch.output_conv1"),
    (r"(depth|point)_head/output_conv2_(\d)", r"\1_head.scratch.output_conv2.\2"),
)


def _vggt_kernel(module: str, value: np.ndarray) -> np.ndarray:
    """A Flax kernel in the torch layout of upstream's module."""
    if value.ndim == 2:  # Dense (I, O); the DPT projections are upstream 1x1 convs
        return value.T[:, :, None, None] if ".projects." in module else value.T
    if re.search(r"resize_layers\.[01]$", module):  # ConvTranspose: (kh, kw, I, O) -> (I, O, kh, kw), flipped
        return value.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    return value.transpose(3, 2, 0, 1)  # Conv HWIO -> OIHW


def vggt_params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax params of `evoworld_tpu.models.vggt.VGGT` (`{"params": ...}` or the
    inner dict) -> the port's VGGT state dict, upstream names (fp32 CPU tensors
    unless the leaves carry another float dtype)."""
    flat = _flatten(tree.get("params", tree))
    sd: dict[str, np.ndarray] = {}

    def block(prefix: str, rel: tuple, value: np.ndarray, start: int = 0) -> None:
        """Unstack one scanned ViTBlock leaf into upstream blocks `prefix.format(start + i)`."""
        if rel[0] in ("ls1", "ls2"):
            name, tf = f"{rel[0]}.gamma", None
        else:
            name = f"{_VGGT_BLOCK_MODULES[rel[0]]}.{'bias' if rel[1] == 'bias' else 'weight'}"
            tf = (lambda a: a.T) if rel[1] == "kernel" else None
        for i, layer in enumerate(value):
            sd[prefix.format(start + i) + name] = tf(layer) if tf else layer

    seg_len = {int(p[1][len("blocks_"):]): v.shape[0] for p, v in flat.items()
               if p[0] == "aggregator" and p[1].startswith("blocks_") and p[2:] == ("frame", "norm1", "scale")}
    seg_start = {seg: sum(seg_len[k] for k in seg_len if k < seg) for seg in seg_len}
    tokens: dict[str, np.ndarray] = {}
    for path, value in flat.items():
        if path[:3] == ("aggregator", "dino_blocks", "block"):
            block("aggregator.patch_embed.blocks.{}.", path[3:], value)
        elif path[0] == "aggregator" and path[1].startswith("blocks_"):
            block(f"aggregator.{path[2]}_blocks.{{}}.", path[3:], value, seg_start[int(path[1][len("blocks_"):])])
        elif path[:3] == ("camera_head", "trunk", "block"):
            block("camera_head.trunk.{}.", path[3:], value)
        elif path[0] == "aggregator" and len(path) == 2:
            tokens[path[1]] = value
        elif path == ("camera_head", "empty_pose_tokens"):
            sd["camera_head.empty_pose_tokens"] = value
        else:
            module = "/".join(path[:-1])
            for pattern, rep in _VGGT_RENAMES:
                if re.fullmatch(pattern, module):
                    module = re.sub(pattern, rep, module)
                    break
            else:
                module = module.replace("/", ".")
            leaf = {"scale": "weight", "kernel": "weight"}.get(path[-1], path[-1])
            sd[f"{module}.{leaf}"] = _vggt_kernel(module, value) if path[-1] == "kernel" else value
    d = tokens["pos_embed"].shape[-1]
    sd["aggregator.patch_embed.pos_embed"] = np.concatenate([tokens["pos_embed_cls"], tokens["pos_embed"]])[None]
    sd["aggregator.patch_embed.cls_token"] = tokens["dino_cls_token"].reshape(1, 1, d)
    sd["aggregator.patch_embed.register_tokens"] = tokens["dino_register_tokens"][None]
    sd["aggregator.camera_token"] = np.stack([tokens["camera_token_first"], tokens["camera_token"]])[None]
    sd["aggregator.register_token"] = np.stack([tokens["register_token_first"], tokens["register_token"]])[None]
    out = {}
    for name, value in sd.items():
        value = np.ascontiguousarray(value)
        if value.dtype.kind != "f" or value.dtype.itemsize < 4:
            value = value.astype(np.float32)
        out[name] = torch.tensor(value)
    return out


_U2NET_BN = {"bn_scale": "bn_s1.weight", "bn_bias": "bn_s1.bias", "bn_mean": "bn_s1.running_mean",
             "bn_var": "bn_s1.running_var"}


def u2net_params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax params of `evoworld_tpu.memory.u2net.U2Net` (`{"params": ...}` or
    the inner dict) -> the port's U2Net state dict under upstream names, batch
    norms' counters left out (fp32 CPU tensors)."""
    sd = {}
    for path, value in _flatten(tree.get("params", tree)).items():
        if path[-1] in _U2NET_BN:
            leaf = _U2NET_BN[path[-1]]
        else:
            leaf, value = _leaf(path[-1], value)
        sd[".".join(path[:-1] + (leaf,))] = torch.tensor(np.ascontiguousarray(value, np.float32))
    return sd


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill `module`'s parameters in place with role-aware random values.

    Draws on the generator's device in fp32 and casts into each parameter.
    """
    norms = (nn.GroupNorm, nn.LayerNorm, nn.modules.batchnorm._BatchNorm)
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, norms) and name == "weight":
                p.fill_(1.0)
            elif name == "mix_factor":
                p.fill_(0.5)
            elif name in ("bias", "class_embedding"):
                p.zero_()
            else:
                fan_in = int(np.prod(p.shape[1:])) if p.dim() >= 2 else 0
                std = float(np.sqrt(1.0 / max(fan_in, 1))) if p.dim() >= 2 else 0.02
                draw = torch.randn(p.shape, generator=generator, device=generator.device, dtype=torch.float32)
                p.copy_(draw.mul_(std))
    return module


# ---------------------------------------------------------------------------
# Checkpoints: safetensors files and upstream-named state dicts
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def _read_header(f) -> tuple[int, dict]:
    """(bytes before the data section, {name: {"dtype", "shape", "data_offsets"}})
    of an open .safetensors file, its `__metadata__` left out."""
    (header_len,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(header_len))
    header.pop("__metadata__", None)
    return 8 + header_len, header


def safetensors_shapes(path: str) -> dict[str, tuple[str, tuple[int, ...]]]:
    """{name: (safetensors dtype name, shape)} of a .safetensors file, from its
    header alone: no tensor's bytes are read."""
    with open(path, "rb") as f:
        header = _read_header(f)[1]
    return {name: (info["dtype"], tuple(info["shape"])) for name, info in header.items()}


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A .safetensors file -> {name: CPU tensor} (counterpart of
    `evoworld_tpu/models/weights.py::load_safetensors`, which returns numpy).

    The data section is read once into one buffer; tensors are views of it
    (`torch.frombuffer`), so bf16 needs no detour through numpy, which has no
    bf16. A tensor whose offset is not a multiple of its element size is copied.
    """
    with open(path, "rb") as f:
        start, header = _read_header(f)
        data = bytearray(os.path.getsize(path) - start)
        f.readinto(data)
    out = {}
    for name, info in header.items():
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        size = torch.empty((), dtype=dtype).element_size()
        if end == start:
            t = torch.empty(0, dtype=dtype)
        elif start % size:
            t = torch.frombuffer(bytearray(data[start:end]), dtype=dtype)
        else:
            t = torch.frombuffer(data, dtype=dtype, count=(end - start) // size, offset=start)
        out[name] = t.reshape(info["shape"])
    return out


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    """Write {name: tensor} as one .safetensors file (tensors moved to the CPU,
    in the order given; the header padded with spaces to 8 bytes)."""
    header, offset, parts = {}, 0, []
    for name, t in tensors.items():
        t = t.detach().to("cpu").contiguous()
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        parts.append(t)
        offset += nbytes
    with open(path, "wb") as f:
        _write_header(f, header)
        for t in parts:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)


def save_safetensors_header(shapes: Mapping[str, tuple[str, tuple[int, ...]]], path: str) -> None:
    """Write a .safetensors file of `shapes` ({name: (dtype name, shape)}, as
    `safetensors_shapes` reads them) whose data section is a hole: the header,
    then the file truncated to its full length. Enough for a check that reads
    headers alone, at full width with no weight bytes on disk."""
    header, offset = {}, 0
    for name, (dtype, shape) in shapes.items():
        nbytes = _ST_DTYPES[dtype].itemsize * math.prod(shape)
        header[name] = {"dtype": dtype, "shape": list(shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    with open(path, "wb") as f:
        f.truncate(_write_header(f, header) + offset)


def _write_header(f, header: dict) -> int:
    """Write a safetensors header (its length, then its JSON padded with spaces
    to 8 bytes) to an open file; returns the bytes written."""
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    f.write(struct.pack("<Q", len(blob)))
    f.write(blob)
    return 8 + len(blob)


def load_safetensors_dir(path: str, reader=load_safetensors) -> dict | None:
    """Every `*.safetensors` of a directory merged into one state dict (sharded
    checkpoints), or None where the directory holds none (counterpart of
    `evoworld_tpu/runtime.py::_load_safetensors_dir`). With
    `reader=safetensors_shapes` the headers alone are merged."""
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        return None
    state: dict = {}
    for f in files:
        state.update(reader(f))
    return state


def expand_conv_in_weight(weight: torch.Tensor, target_in: int) -> torch.Tensor:
    """Zero-pad a conv_in weight (O, I, kh, kw) along I to `target_in` channels:
    SVD's 8-channel input becomes the UNet's 18, the original channels keep
    their weights and the new ones start at zero (counterpart of
    `evoworld_tpu/models/weights.py::expand_conv_in_kernel`, whose kernels are HWIO)."""
    cin = weight.shape[1]
    if cin == target_in:
        return weight
    if cin > target_in:
        raise ValueError(f"conv_in has {cin} input channels, more than the UNet's {target_in}")
    pad = torch.zeros((weight.shape[0], target_in - cin, *weight.shape[2:]), dtype=weight.dtype)
    return torch.cat([weight, pad], dim=1)


#: Keys an upstream checkpoint may hold that the port's modules have no place
#: for, dropped as the JAX converters drop them: CLIP's position ids (a buffer
#: that older transformers releases saved), VGGT's training-only mask token.
IGNORED_KEYS = ("vision_model.embeddings.position_ids", "aggregator.patch_embed.mask_token")


@torch.no_grad()
def load_checkpoint_(module: nn.Module, state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Fill `module` from an upstream-named state dict, strictly: every
    parameter and buffer must be there with its shape, and nothing else but
    IGNORED_KEYS. Values are cast into the module's own dtypes; a UNet's
    conv_in is zero-padded to the module's input channels first."""
    state = {k: v for k, v in state.items() if k not in IGNORED_KEYS}
    own = module.state_dict()
    if "conv_in.weight" in state and "conv_in.weight" in own and own["conv_in.weight"].dim() == 4:
        state["conv_in.weight"] = expand_conv_in_weight(state["conv_in.weight"], own["conv_in.weight"].shape[1])
    module.load_state_dict(state, strict=True)
    return module


def checkpoint_mismatches(module: nn.Module, state: Mapping[str, torch.Tensor]) -> list[str]:
    """What keeps `state` from filling `module` strictly: missing and unexpected
    keys and shape mismatches (IGNORED_KEYS aside); empty when it fits."""
    own = module.state_dict()
    state = {k: v for k, v in state.items() if k not in IGNORED_KEYS}
    report = [f"missing {k}" for k in own if k not in state]
    report += [f"unexpected {k}" for k in state if k not in own]
    report += [f"shape of {k}: {tuple(v.shape)}, the model's {tuple(own[k].shape)}"
               for k, v in state.items() if k in own and tuple(v.shape) != tuple(own[k].shape)]
    return report


def load_vggt_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """facebook/VGGT-1B's `model.pt` (a state dict, or one under "model")
    -> CPU tensors (counterpart of `evoworld_tpu/models/vggt/weights.py::
    load_vggt_torch_checkpoint`, without the conversion: the port keeps
    upstream's names)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "model" in state:
        state = state["model"]
    return dict(state)
