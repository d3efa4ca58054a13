"""The port's `calculate_dreamsim` CLI against the JAX package's, on the CPU:
two PNGs scored in both variants give the same JSON keys and weights tag
and a score within 1e-4 (a cosine distance of 768- or 1792-d fp32
embeddings), both CLIs loading every branch from one directory of
synthesized upstream weights: DINO's naming without LayerScale (as DINO v1)
and OpenAI's `visual.*` for both CLIP branches. JPEG images, sized by their
headers, score as in the JAX CLI too.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from evoworld_tpu.cli import calculate_dreamsim as jax_dreamsim
from evoworld_tpu_torch.cli import calculate_dreamsim
from evoworld_tpu_torch.eval import dreamsim as td
from tests.test_torch_port_calculate_cli import write_predictions
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _openai_visual(state: dict) -> dict:
    """A CLIP branch's state dict (transformers names under `tower.`) in
    OpenAI's `visual.*` naming, with q / k / v fused into `in_proj`."""
    p = "tower.vision_model."
    out = {"visual.conv1.weight": state[p + "embeddings.patch_embedding.weight"],
           "visual.class_embedding": state[p + "embeddings.class_embedding"],
           "visual.positional_embedding": state[p + "embeddings.position_embedding.weight"],
           "visual.ln_pre.weight": state[p + "pre_layrnorm.weight"], "visual.ln_pre.bias": state[p + "pre_layrnorm.bias"],
           "visual.ln_post.weight": state[p + "post_layernorm.weight"],
           "visual.ln_post.bias": state[p + "post_layernorm.bias"],
           "visual.proj": state["tower.visual_projection.weight"].T.contiguous()}
    i = 0
    while f"{p}encoder.layers.{i}.layer_norm1.weight" in state:
        src, dst = f"{p}encoder.layers.{i}.", f"visual.transformer.resblocks.{i}."
        for wb in ("weight", "bias"):
            out[dst + f"ln_1.{wb}"] = state[src + f"layer_norm1.{wb}"]
            out[dst + f"ln_2.{wb}"] = state[src + f"layer_norm2.{wb}"]
            out[dst + f"attn.in_proj_{wb}"] = torch.cat([state[src + f"self_attn.{x}_proj.{wb}"] for x in "qkv"])
            out[dst + f"attn.out_proj.{wb}"] = state[src + f"self_attn.out_proj.{wb}"]
            out[dst + f"mlp.c_fc.{wb}"] = state[src + f"mlp.fc1.{wb}"]
            out[dst + f"mlp.c_proj.{wb}"] = state[src + f"mlp.fc2.{wb}"]
        i += 1
    return out


def _random_like(model: torch.nn.Module, seed: int) -> dict:
    """`model`'s state dict with seeded random values (fan-in-scaled matrices,
    norm scales near 1, small vectors)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in model.state_dict().items():
        if t.dim() >= 2:
            out[name] = torch.randn(t.shape, generator=g) / np.sqrt(np.prod(t.shape[1:]))
        else:
            base = 1.0 if "norm" in name and name.endswith("weight") else 0.0
            out[name] = base + 0.05 * torch.randn(t.shape, generator=g)
    return out


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    """DreamSim's three branches in upstream naming."""
    root = tmp_path_factory.mktemp("dreamsim_weights")
    dino = _random_like(td.DinoViT(), 1)
    torch.save({k: v for k, v in dino.items() if ".ls" not in k}, root / "dreamsim.pt")
    for stem, act, seed in (("dreamsim_clip", "quick_gelu", 2), ("dreamsim_open_clip", "gelu", 3)):
        torch.save(_openai_visual(_random_like(td._ClipBranch(act), seed)), root / f"{stem}.pt")
    return str(root)


@pytest.fixture(scope="module")
def predictions(tmp_path_factory):
    return write_predictions(str(tmp_path_factory.mktemp("pairs")), 2)


@pytest.mark.parametrize("variant", ["dino_vitb16", "ensemble"])
def test_calculate_dreamsim_matches_jax_cli(predictions, weights_dir, variant, capsys):
    a = os.path.join(predictions, "episode_000", "predictions_2", "000.png")
    b = os.path.join(predictions, "episode_000", "predictions_gt_2", "001.png")
    argv = [f"--data.root={a}:{b}", f"--runtime.dreamsim_variant={variant}",
            f"--runtime.metric_weights_dir={weights_dir}"]
    with jax.default_matmul_precision("highest"):
        jax_dreamsim.main(argv)
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ours = calculate_dreamsim.main(argv, device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == ours
    assert ours.keys() == theirs.keys() and ours["weights"] == theirs["weights"]
    assert 100 * 1e-4 < ours["dreamsim"] < 2.0  # far above the tolerance: the nets see the images
    np.testing.assert_allclose(ours["dreamsim"], theirs["dreamsim"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("pair", [("baseline_420.jpg", "baseline_420.png"), ("baseline_420.jpg", "grey.jpg")])
def test_calculate_dreamsim_scores_jpegs_as_the_jax_cli(weights_dir, pair, capsys):
    """JPEG images, which the JAX CLI opens with PIL: the committed 4:2:0
    JPEG against PIL's decode of it stored as a PNG (the same pixels, a
    score of about 0), and against another JPEG (a grey one of another
    size), each within 1e-4 of the JAX CLI's score."""
    data = os.path.join(os.path.dirname(__file__), "torch_port_data")
    a, b = (os.path.join(data, name) for name in pair)
    argv = [f"--data.root={a}:{b}", f"--runtime.metric_weights_dir={weights_dir}"]
    with jax.default_matmul_precision("highest"):
        jax_dreamsim.main(argv)
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ours = calculate_dreamsim.main(argv, device="cpu")
    np.testing.assert_allclose(ours["dreamsim"], theirs["dreamsim"], rtol=0, atol=1e-4)
    if pair[1].endswith(".png"):
        assert abs(ours["dreamsim"]) < 1e-4
    else:
        assert 100 * 1e-4 < ours["dreamsim"] < 2.0
