"""The gradients of the port's mesh attention routes against `evoworld_tpu`,
on CPU ranks over gloo.

Two spawns start together (`parallel/launch.py`, `parallel.checks.several_rank`):
W = 2 (the head-sharded route on 4 heads, and the ring on 5 heads over a
length that pads) and W = 3 (the ring, divisible, with several batch rows,
and a rank whose key block is all padding). Each rank takes the gradient of
sum(out * cotangent) through `multi_head_attention` under
`head_sharded_attention(mesh, 1)` (`parallel.checks.route_grad_rank`, fp32
draws from a seed); the JAX references are `jax.grad` of the same loss
through `_head_sharded` and `seq_sharded_ring` on the 8-device CPU mesh
(`tests/conftest.py`), under matmul precision "highest", compiled in
threads while the ranks run, at the JAX ring test's tolerance
(`tests/test_ring_attention.py`: rtol 2e-4, atol 2e-5). The all-padding
block's case is held to autograd through the port's plain attention in one
process at the same tolerance. Every rank must hold the whole dq, dk and dv,
equal on every rank.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoworld_tpu.ops.attention import _head_sharded, _xla_attention
from evoworld_tpu.ops.ring_attention import seq_sharded_ring
from evoworld_tpu.parallel.mesh import make_mesh as jmake_mesh
from evoworld_tpu_torch.ops.attention import head_sharded_attention, multi_head_attention, plain_attention
from evoworld_tpu_torch.parallel import mesh as tmesh
from evoworld_tpu_torch.parallel.checks import route_inputs
from evoworld_tpu_torch.parallel.launch import Ranks
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

RTOL, ATOL = 2e-4, 2e-5
# name: (world size, (B, S, H, D), seed); head sharding where W divides H, else the ring
CASES = {
    "head_w2": (2, (1, 96, 4, 16), 1),
    "ring_w2_padded": (2, (1, 301, 5, 8), 2),
    "ring_w3_divisible": (3, (2, 3 * 37, 4, 16), 3),
    "ring_w3_padding_block": (3, (1, 4, 2, 8), 4),  # S_local 2: rank 2's block is all padding
}
JAX_CASES = ("head_w2", "ring_w2_padded", "ring_w3_divisible")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({world size: every rank's results in case order}, {case: JAX's gradients}),
    W = 2 and W = 3 started together, JAX's references compiled meanwhile."""
    root = tmp_path_factory.mktemp("mesh_grad")
    jobs = {}
    for w in (2, 3):
        calls = [("route_grad_rank", (shape, "float32", seed, 1)) for world, shape, seed in CASES.values()
                 if world == w]
        jobs[w] = Ranks("evoworld_tpu_torch.parallel.checks:several_rank", w, str(root / f"w{w}"), device="cpu",
                        args=(calls,))
    with concurrent.futures.ThreadPoolExecutor(len(JAX_CASES)) as pool:
        refs = dict(zip(JAX_CASES, pool.map(_jax_grads, JAX_CASES)))
    return {w: job.results() for w, job in jobs.items()}, refs


def _result(ranks, name):
    w = CASES[name][0]
    index = [n for n, (world, _, _) in CASES.items() if world == w].index(name)
    return [r[index] for r in ranks[w]]


def _plain_grads(name):
    _, shape, seed = CASES[name]
    *qkv, cot = route_inputs(shape, "float32", seed, "cpu")
    qkv = [t.requires_grad_(True) for t in qkv]
    (plain_attention(*qkv, 1.0 / np.sqrt(shape[-1])) * cot).sum().backward()
    return [t.grad.numpy() for t in qkv]


def _jax_grads(name):
    w, shape, seed = CASES[name]
    q, k, v, cot = (jnp.asarray(t.numpy()) for t in route_inputs(shape, "float32", seed, "cpu"))
    scale = 1.0 / np.sqrt(shape[-1])
    if name.startswith("head"):
        mesh = jmake_mesh(jax.devices()[:w], data=1, model=w)

        def attend(q, k, v):
            return _head_sharded(q, k, v, scale, mesh)
    else:
        mesh = jmake_mesh(jax.devices()[:w], model=1)

        def attend(q, k, v):
            return seq_sharded_ring(q, k, v, scale, mesh)

    with jax.default_matmul_precision("highest"):
        grads = jax.grad(lambda q, k, v: jnp.sum(attend(q, k, v) * cot), argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", list(CASES))
def test_route_gradients_match_jax(runs, name):
    """Against JAX's; the all-padding block's case against the port's plain attention."""
    ranks, refs = runs
    results = _result(ranks, name)
    want = refs[name] if name in refs else _plain_grads(name)
    assert results[0]["route"] == ("head_sharded" if name.startswith("head") else "ring")
    for r in results:
        assert r["finite"] and r["sha256"] == results[0]["sha256"]  # every rank holds the same whole gradients
    for got, ref, label in zip(results[0]["grads"], want, ("dq", "dk", "dv")):
        assert got.shape == ref.shape and float(np.abs(ref).max()) > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL, err_msg=label)


def test_a_one_rank_mesh_differentiates_the_flash_route():
    """A mesh of one rank (no process group) takes the head-sharded route
    over every head, with its gradient: JAX's exact attention's."""
    shape = (1, 40, 3, 16)
    q, k, v, cot = route_inputs(shape, "float32", 5, "cpu")
    qkv = [t.requires_grad_(True) for t in (q, k, v)]
    with head_sharded_attention(tmesh.make_mesh("cpu"), min_seq=1):
        (multi_head_attention(*qkv) * cot).sum().backward()
    jq, jk, jv, jc = (jnp.asarray(t.detach().numpy()) for t in (q, k, v, cot))
    with jax.default_matmul_precision("highest"):
        want = jax.grad(lambda q, k, v: jnp.sum(_xla_attention(q, k, v, 0.25) * jc), argnums=(0, 1, 2))(jq, jk, jv)
    for t, ref in zip(qkv, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
