"""A tiny VGGT reconstruction of the port at compute dtype fp16 against the
JAX package's reconstructor at fp16 and at fp32, on the CPU, under the rule
and tolerances of `test_torch_port_fp16.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from evoworld_tpu.models.vggt.model import VGGT as JVGGT
from evoworld_tpu.models.vggt.model import make_reconstructor as j_make_reconstructor
from evoworld_tpu.runtime import cast_compute_leaves
from evoworld_tpu_torch import runtime
from evoworld_tpu_torch.models.weights import vggt_params_from_jax
from tests.test_torch_port_fp16 import VGGT_TOL, _f16_values, assert_fp16_rule, rel_err
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from tests.test_torch_port_vggt import TINY as VGGT_TINY
from tests.test_torch_port_vggt import _j_config, _random_tree

def test_tiny_vggt_reconstruction_fp16_against_jax(tmp_path):
    """`build_reconstructor("tiny", compute_dtype=torch.float16)` from a
    model.pt of random weights (norms, LayerScales and the pose seed kept in
    fp32 on both sides) on three 16 x 512 crops, against JAX's reconstructor
    at fp16 (`cast_compute_leaves`) and at fp32."""
    jmodel = JVGGT(_j_config(VGGT_TINY))
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.zeros((1, 2, 28, 42, 3))), jax.random.key(0))
    params = _f16_values(_random_tree(shapes, seed=0))
    torch.save(vggt_params_from_jax(params), tmp_path / "model.pt")
    recon = runtime.build_reconstructor("tiny", compute_dtype=torch.float16, device="cpu",
                                        vggt_checkpoint=str(tmp_path / "model.pt"), allow_random_weights=False)
    crops = np.random.default_rng(2).uniform(size=(3, 16, 512, 3)).astype(np.float32)

    def jax_recon(dtype):
        fn = j_make_reconstructor(jmodel, cast_compute_leaves(params, dtype), dtype, offload_params=False)
        with jax.default_matmul_precision("highest"):
            out = fn(jnp.asarray(crops))
        return {k: np.asarray(out[k], np.float32) for k in ("world_points", "conf")}

    want16, want32 = jax_recon(jnp.float16), jax_recon(jnp.float32)
    got = recon(torch.from_numpy(crops))
    for name in ("world_points", "conf"):
        assert_fp16_rule(got[name].float().numpy(), want16[name], want32[name], VGGT_TOL, name)
    moved = recon(torch.from_numpy(crops[::-1].copy()))
    assert rel_err(moved["world_points"].float(), got["world_points"].float()) > 10 * VGGT_TOL[1]
