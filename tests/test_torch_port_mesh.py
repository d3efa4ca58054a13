"""The port's multi-GPU routes against `evoworld_tpu`, on CPU ranks over gloo.

Ranks are spawned by `evoworld_tpu_torch.parallel.launch.Ranks` (fresh
processes that import torch and the port only, one torch thread each, a
`file://` rendezvous under the test's temporary directory), W = 2 and W = 3
at once; the JAX references run meanwhile on the forced 8-device CPU mesh
(`tests/conftest.py`), under matmul precision "highest".

- Ring attention (`ops/ring_attention.py`) at W = 2 and 3, with the
  sequence divisible and padded, and a rank whose key block is all padding
  (no kernel call, lse = _NEG), against JAX `seq_sharded_ring`; the
  head-sharded route at W = 2 against JAX `_head_sharded`; the W = 2 ranks
  form a 1 x 2 (data x model) mesh, whose axes every route flattens, as
  JAX's test of a two-axis mesh does. Tolerance: rtol / atol 2e-5, the JAX
  package's own ring tests'.
- The view-sharded render (`memory/render.py`) at W = 2 and 3: bit for bit
  the port's unsharded render.
- The mesh's shape rules (`make_mesh`), the backend rule (`backend_for`
  on the ranks' card UUIDs) and `shard_batch`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoworld_tpu.ops.attention import _head_sharded
from evoworld_tpu.ops.ring_attention import seq_sharded_ring
from evoworld_tpu.parallel.mesh import make_mesh as jmake_mesh
from evoworld_tpu_torch.memory.render import render_memory_panoramas
from evoworld_tpu_torch.parallel import mesh as tmesh
from evoworld_tpu_torch.parallel.launch import Ranks
from tests.test_torch_port_models import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TOL = 2e-5
# name: (world size, (B, S, H, D)); the route is head sharding where W divides H, else the ring
CASES = {
    "ring_w2_divisible": (2, (2, 2 * 37, 3, 16)),
    "ring_w2_padded": (2, (1, 301, 5, 8)),
    "head_w2": (2, (1, 96, 4, 16)),
    "ring_w3_divisible": (3, (1, 3 * 37, 4, 16)),
    "ring_w3_padded": (3, (1, 301, 5, 8)),
    "ring_w3_padding_block": (3, (1, 4, 2, 8)),  # S_local 2: rank 2 holds only padding
}
RENDER = dict(views=5, height=24, width=48, points=400)


def _qkv(name):
    shape = CASES[name][1]
    rng = np.random.default_rng(sum(map(ord, name)))
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _render_inputs():
    rng = np.random.default_rng(9)
    n = RENDER["points"]
    points = np.concatenate([rng.uniform(-1, 1, (n, 2)), rng.uniform(1.0, 3.0, (n, 1))], 1).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    t = RENDER["views"]
    rot = np.broadcast_to(np.eye(3, dtype=np.float32) * 1.3, (t, 3, 3))  # scaled rotations, as the aligned poses are
    trans = rng.uniform(-0.2, 0.2, (t, 3, 1)).astype(np.float32)
    return points, colors, valid, np.concatenate([rot, trans], 2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, W = 2 (a 1 x 2 mesh) and W = 3 started together."""
    root = tmp_path_factory.mktemp("mesh")
    jobs = {}
    for w, model in ((2, 2), (3, 1)):
        cases = [(name, *_qkv(name)) for name, (world, _) in CASES.items() if world == w]
        jobs[w] = (Ranks("evoworld_tpu_torch.parallel.checks:attention_rank", w, str(root / f"att{w}"),
                         device="cpu", args=(cases,), mesh_model=model),
                   Ranks("evoworld_tpu_torch.parallel.checks:render_rank", w, str(root / f"render{w}"),
                         device="cpu", args=(*_render_inputs(), RENDER["height"], RENDER["width"])))
    return {w: (att.results(), render.results()) for w, (att, render) in jobs.items()}


def _jax_reference(name):
    w, _ = CASES[name]
    q, k, v = (jnp.asarray(t) for t in _qkv(name))
    scale = 1.0 / np.sqrt(q.shape[-1])
    with jax.default_matmul_precision("highest"):
        if name.startswith("head"):
            return np.asarray(_head_sharded(q, k, v, scale, jmake_mesh(jax.devices()[:w], data=1, model=w)))
        return np.asarray(seq_sharded_ring(q, k, v, scale, jmake_mesh(jax.devices()[:w], model=1)))


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_attention_matches_jax(ranks, name):
    w = CASES[name][0]
    outs = [r[name].numpy() for r in ranks[w][0]]
    ref = _jax_reference(name)
    for out in outs:  # every rank holds the whole output
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("w", [2, 3])
def test_view_sharded_render_is_bit_equal_to_the_unsharded_render(ranks, w):
    points, colors, valid, poses = (torch.as_tensor(a) for a in _render_inputs())
    ref = render_memory_panoramas(points, colors, valid, poses, RENDER["height"], RENDER["width"])
    assert ref.shape[0] == RENDER["views"] and float(ref.amax()) > 0  # the points land in every check
    for out in ranks[w][1]:
        assert torch.equal(out, ref)


@pytest.mark.parametrize("w, model", [(2, 2), (3, 1)])
def test_ranks_form_the_mesh_they_were_given(ranks, w, model):
    for r, res in enumerate(ranks[w][0]):
        assert res["_mesh"] == (w // model, model, r, "gloo")


@pytest.mark.parametrize("count, local_world, expected", [(1, 2, "gloo"), (2, 2, "nccl"), (4, 2, "nccl"),
                                                          (2, 3, "gloo")])
def test_backend_follows_the_devices(monkeypatch, count, local_world, expected):
    """NCCL only where no two ranks hold the same card (`local_world` ranks on
    `cuda:rank % count` of `count` cards, told apart by UUID); the CPU always gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    uuids = [f"GPU-{rank % count}" for rank in range(local_world)]
    assert tmesh.backend_for(torch.device("cuda", 0), uuids) == expected
    assert tmesh.backend_for(torch.device("cpu"), uuids) == "gloo"


def test_one_process_mesh_and_shard_batch():
    """Without a process group the mesh is 1 x 1; a data axis of 0 means all
    ranks; `shard_batch` pads by repeating the last row, as the render's poses are."""
    mesh = tmesh.make_mesh("cpu")
    assert (mesh.data, mesh.model, mesh.size, mesh.rank) == (1, 1, 1, 0)
    with pytest.raises(ValueError, match="2x1 mesh over 1 ranks"):
        tmesh.make_mesh("cpu", data=2)
    x = torch.arange(5)
    shares = [tmesh.shard_batch(x, tmesh.Mesh(3, 1, r, torch.device("cpu"), "gloo")).tolist() for r in range(3)]
    assert shares == [[0, 1], [2, 3], [4, 4]]


def test_shard_batch_over_the_data_axis():
    """Over the data axis a 2 x 2 mesh splits a batch in two halves, each
    model rank taking its data peer's rows as a view, and a batch the data
    axis does not divide is refused rather than padded."""
    x = torch.arange(6)
    meshes = [tmesh.Mesh(2, 2, r, torch.device("cpu"), "gloo") for r in range(4)]
    shares = [tmesh.shard_batch(x, m, over_data=True) for m in meshes]
    assert [t.tolist() for t in shares] == [[0, 1, 2], [0, 1, 2], [3, 4, 5], [3, 4, 5]]
    assert all(t.data_ptr() == x[3 * (m.rank // 2)].data_ptr() for t, m in zip(shares, meshes))
    with pytest.raises(ValueError, match="5 rows do not split over 2 data ranks"):
        tmesh.shard_batch(torch.arange(5), meshes[0], over_data=True)


def test_a_one_rank_mesh_runs_the_flash_forward_on_every_head():
    """The W = 1 side of the card's composed gate: the head-sharded route over
    one rank is the flash forward of all heads (its plain version here), with
    no collective, against JAX's exact attention."""
    from evoworld_tpu.ops.attention import _xla_attention
    from evoworld_tpu_torch.ops.attention import head_sharded_attention, multi_head_attention

    q, k, v = _qkv("ring_w3_divisible")
    with head_sharded_attention(tmesh.make_mesh("cpu"), min_seq=1):
        out = multi_head_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25))
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("count, uuids, expected", [
    (1, ["GPU-a", "GPU-a"], "gloo"),   # one card shared by two ranks
    (2, ["GPU-a", "GPU-b"], "nccl"),   # two cards, each rank on its own
    (1, ["GPU-a", "GPU-b"], "nccl"),   # one visible card a rank (CUDA_VISIBLE_DEVICES per task), two cards
])
def test_ranks_pick_the_backend_from_their_cards(monkeypatch, count, uuids, expected):
    """`init_distributed`'s rule with the device queries patched: each rank
    (a thread here) sets its card's UUID in a shared rendezvous store and
    reads the others'; the device count plays no part."""
    import threading
    import types

    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(uuid=uuids[int(threading.current_thread().name)]))
    store, backends = dist.HashStore(), [None] * len(uuids)

    def rank(r):
        dev = torch.device("cuda", r % count)
        backends[r] = tmesh.backend_for(dev, tmesh.exchange(store, r, len(uuids), tmesh.device_uuid(dev)))

    threads = [threading.Thread(target=rank, args=(r,), name=str(r)) for r in range(len(uuids))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert backends == [expected] * len(uuids)
