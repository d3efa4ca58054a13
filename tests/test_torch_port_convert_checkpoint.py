"""The port's checkpoint tools (`evoworld_tpu_torch/cli/convert_checkpoint.py`)
against the JAX package's (`evoworld_tpu/cli/convert_checkpoint.py`).

- `halve` at fp16 and bf16: every output tensor byte-equal to the JAX
  `halve`'s (numpy / ml_dtypes casts) on the same file, which holds F32,
  F64 (with values whose fp16 rounding goes wrong when taken through fp32
  first), int64, F16 and BF16 tensors; the printed line equal too.
- `validate` on full-width pipeline directories written as sparse
  safetensors files (a header, then `truncate` to the data's length): no
  weight byte is written, read or allocated (the loader is replaced by one
  that fails). SVD's 8-channel `conv_in` passes; a missing sub-model, an
  extra key and a wrong shape are each reported under their sub-model.
  The JAX `validate` reads every weight and traces the full-width models,
  which takes minutes and gigabytes, so its verdict is compared where it
  runs in seconds: directories whose sub-models are missing.
- `main`'s usage errors and exit codes.
"""

import os

import numpy as np
import pytest
import torch

from evoworld_tpu.cli import convert_checkpoint as jconvert
from evoworld_tpu_torch.cli import convert_checkpoint as tconvert
from evoworld_tpu_torch.models.weights import (
    load_safetensors,
    safetensors_shapes,
    save_safetensors,
    save_safetensors_header,
)
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

def _source_tensors() -> dict[str, torch.Tensor]:
    rng = np.random.default_rng(0)
    # float64 values one 2^-40 past an fp16 tie: rounded through fp32 they
    # land on the tie and round to even, rounded once they round up
    ties = 1.0 + 2.0 ** -11 + np.array([2.0 ** -40, -2.0 ** -40, 0.0])
    return {
        "w32": torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32) * 100),
        "w64": torch.from_numpy(np.concatenate([rng.normal(size=61) * 3, ties, [70000.0, 1e-9, -0.0]])),
        "steps": torch.from_numpy(rng.integers(-2 ** 40, 2 ** 40, size=(4,), dtype=np.int64)),
        "already16": torch.from_numpy(rng.normal(size=(3, 3)).astype(np.float16)),
        "small32": torch.tensor([6e-8, 3e-8, 1e-40, 65504.0, 65520.0, float("inf")], dtype=torch.float32),
    }


@pytest.mark.parametrize("dtype", ["fp16", "bf16"])
def test_halve_equals_the_jax_tool_byte_for_byte(tmp_path, capsys, dtype):
    tensors = _source_tensors()
    save_safetensors(tensors, str(tmp_path / "src.safetensors"))
    jconvert.halve(str(tmp_path / "src.safetensors"), str(tmp_path / "jax.safetensors"), dtype)
    jax_line = capsys.readouterr().out
    tconvert.halve(str(tmp_path / "src.safetensors"), str(tmp_path / "port.safetensors"), dtype)
    assert capsys.readouterr().out.replace("port.", "jax.") == jax_line
    want, got = (load_safetensors(str(tmp_path / f"{n}.safetensors")) for n in ("jax", "port"))
    assert list(got) == list(tensors) and set(want) == set(got)
    half = {"fp16": torch.float16, "bf16": torch.bfloat16}[dtype]
    for name, t in tensors.items():
        expect = half if t.dtype in (torch.float32, torch.float64) else t.dtype
        assert got[name].dtype == want[name].dtype == expect, name
        assert got[name].shape == t.shape
        assert bytes(got[name].reshape(-1).view(torch.uint8).numpy()) == bytes(
            want[name].reshape(-1).view(torch.uint8).numpy()), name
        if t.dtype not in (torch.float32, torch.float64):
            assert torch.equal(got[name], t), name  # passed through unchanged
    if dtype == "fp16":  # the ties: rounded once, as numpy rounds, not through fp32
        assert got["w64"][61:64].view(torch.int16).tolist() == [0x3C01, 0x3C00, 0x3C00]


def test_halve_passes_bf16_through_and_refuses_an_unknown_type(tmp_path):
    """A BF16 tensor (which the JAX tool's numpy reader cannot load) passes
    through; a target type other than fp16 or bf16 is refused by name."""
    src = {"b": torch.arange(6, dtype=torch.float32).to(torch.bfloat16), "f": torch.ones(2)}
    save_safetensors(src, str(tmp_path / "src.safetensors"))
    tconvert.halve(str(tmp_path / "src.safetensors"), str(tmp_path / "out.safetensors"), "fp16")
    out = load_safetensors(str(tmp_path / "out.safetensors"))
    assert torch.equal(out["b"], src["b"]) and out["f"].dtype == torch.float16
    with pytest.raises(SystemExit, match="fp16 or bf16"):
        tconvert.halve(str(tmp_path / "src.safetensors"), str(tmp_path / "x.safetensors"), "float16")


def test_header_only_file_reads_back_as_the_full_file_would(tmp_path):
    """`save_safetensors_header` writes the header `save_safetensors` writes
    for the same tensors, and a file of the same length with no data."""
    tensors = _source_tensors()
    save_safetensors(tensors, tmp_path / "full.safetensors")
    shapes = safetensors_shapes(tmp_path / "full.safetensors")
    save_safetensors_header(shapes, tmp_path / "hole.safetensors")
    assert safetensors_shapes(tmp_path / "hole.safetensors") == shapes
    full, hole = ((tmp_path / f"{n}.safetensors").read_bytes() for n in ("full", "hole"))
    assert len(hole) == len(full)
    head = 8 + int.from_bytes(full[:8], "little")
    assert hole[:head] == full[:head] and not hole[head:].strip(b"\0")


@pytest.fixture(scope="module")
def full_shapes():
    """{sub-model: {name: shape}} of the port's full-width UNet, VAE and CLIP,
    with SVD's 8-channel conv_in."""
    from evoworld_tpu_torch.models.clip import CLIPVisionTower
    from evoworld_tpu_torch.models.unet import UNetSpatioTemporal
    from evoworld_tpu_torch.models.vae import AutoencoderKLTemporal
    from evoworld_tpu_torch.runtime import PRESETS

    out = {}
    for sub, cls, cfg in zip(("unet", "vae", "image_encoder"),
                             (UNetSpatioTemporal, AutoencoderKLTemporal, CLIPVisionTower), PRESETS["full"]):
        with torch.device("meta"):
            out[sub] = {k: tuple(v.shape) for k, v in cls(cfg).state_dict().items()}
    out["unet"]["conv_in.weight"] = (320, 8, 3, 3)
    return out


def _pipeline_dir(root, shapes: dict) -> str:
    for sub, sub_shapes in shapes.items():
        os.makedirs(root / sub, exist_ok=True)
        names = list(sub_shapes)
        half = len(names) // 2  # two shards, merged by the reader
        save_safetensors_header({k: ("F32", sub_shapes[k]) for k in names[:half]}, root / sub / "part-1.safetensors")
        save_safetensors_header({k: ("F32", sub_shapes[k]) for k in names[half:]}, root / sub / "part-2.safetensors")
    return str(root)


@pytest.fixture
def no_weight_reads(monkeypatch):
    monkeypatch.setattr(tconvert, "load_safetensors", lambda *a, **k: pytest.fail("a weight was read"))
    monkeypatch.setattr(torch, "frombuffer", lambda *a, **k: pytest.fail("a weight was read"))
    monkeypatch.setattr(torch.nn.Module, "to_empty", lambda *a, **k: pytest.fail("a model was allocated"))


def test_validate_passes_a_full_width_directory_read_from_headers(tmp_path, capsys, full_shapes, no_weight_reads):
    root = _pipeline_dir(tmp_path, full_shapes)
    unet = tmp_path / "unet" / "part-1.safetensors"
    assert os.path.getsize(unet) > 1e9 and os.stat(unet).st_blocks * 512 < 1e6  # a hole, not data
    assert tconvert.validate_pipeline_dir(root) == []
    assert capsys.readouterr().out.splitlines() == ["unet: OK", "vae: OK", "image_encoder: OK"]
    with pytest.raises(SystemExit) as exit_info:
        tconvert.main(["validate", root])
    assert exit_info.value.code == 0


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "conv_in_wide"])
def test_validate_reports_each_fault_under_its_sub_model(tmp_path, capsys, full_shapes, no_weight_reads, fault):
    shapes = {sub: dict(s) for sub, s in full_shapes.items()}
    if fault == "missing":
        del shapes["vae"]
        want = ["vae: missing safetensors"]
    elif fault == "extra":
        shapes["image_encoder"]["vision_model.extra.weight"] = (4,)
        want = ["image_encoder: unexpected vision_model.extra.weight"]
    elif fault == "shape":
        shapes["unet"]["conv_out.weight"] = (4, 320, 3, 5)
        want = ["unet: shape of conv_out.weight: (4, 320, 3, 5), the model's (4, 320, 3, 3)"]
    else:  # more input channels than the UNet's 18 cannot be padded
        shapes["unet"]["conv_in.weight"] = (320, 20, 3, 3)
        want = ["unet: shape of conv_in.weight: (320, 20, 3, 3), the model's (320, 18, 3, 3)"]
    root = _pipeline_dir(tmp_path, shapes)
    assert tconvert.validate_pipeline_dir(root) == want
    sub = want[0].split(":")[0]
    printed = dict(line.split(": ", 1) for line in capsys.readouterr().out.splitlines())
    assert printed[sub] != "OK" and all(v == "OK" for k, v in printed.items() if k != sub)
    with pytest.raises(SystemExit) as exit_info:
        tconvert.main(["validate", root])
    assert exit_info.value.code == 1


@pytest.mark.parametrize("present", [(), ("unet",)])
def test_validate_verdict_equals_the_jax_tool_where_it_runs_in_seconds(tmp_path, capsys, present):
    """Sub-models missing (an empty directory, or a unet/ with no
    safetensors): the JAX tool reaches no weight, and both report the same
    problems and print the same lines."""
    for sub in present:
        os.makedirs(tmp_path / sub)
    want = jconvert.validate_pipeline_dir(str(tmp_path))
    jax_out = capsys.readouterr().out
    assert tconvert.validate_pipeline_dir(str(tmp_path)) == want == [
        f"{s}: missing safetensors" for s in ("unet", "vae", "image_encoder")]
    assert capsys.readouterr().out == jax_out


def test_main_usage_errors_as_the_jax_tool():
    for argv in ([], ["convert"]):
        for module in (jconvert, tconvert):
            with pytest.raises(SystemExit) as exit_info:
                module.main(argv)
            text = str(exit_info.value.code)
            assert "Usage:" in text and "halve <in.safetensors> <out.safetensors> [bf16|fp16]" in text
            assert ("unknown command 'convert'" in text) == bool(argv)
    usage = tconvert.__doc__[tconvert.__doc__.index("Usage:"):]
    assert usage == jconvert.__doc__[jconvert.__doc__.index("Usage:"):].replace("evoworld_tpu.", "evoworld_tpu_torch.")
    with pytest.raises(TypeError):  # halve without its files, as in the JAX tool
        tconvert.main(["halve"])
