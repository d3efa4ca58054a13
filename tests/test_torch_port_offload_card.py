"""VGGT's host parameter offload (`models/vggt/model.py::Reconstructor`,
`offload_params`, the JAX package's default for one device without a mesh).

On the card: the reconstructor that `build_reconstructor` makes by default
keeps VGGT-1B's parameters in pinned host memory, so that after a
reconstruct `torch.cuda.memory_allocated()` is lower than with them kept on
the card by the parameters' and buffers' bytes (each rounded up to the
caching allocator's 512-byte blocks; at most 1% more, where it hands a
tensor a larger cached block), and its outputs equal, bit for bit,
those of the reconstructor without offload from the same seed. The
refusal of `offload_params=True` on the CPU runs anywhere. The file imports
no JAX:

    python -m pytest tests/test_torch_port_offload_card.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from evoworld_tpu_torch.runtime import build_reconstructor


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: host offload has no meaning on the CPU")
    return torch.device("cuda")


def test_offload_is_refused_by_name_on_the_cpu():
    with pytest.raises(ValueError, match="offload_params=True needs a CUDA device"):
        build_reconstructor("tiny", compute_dtype=torch.float32, device="cpu", offload_params=True)
    assert not build_reconstructor("tiny", compute_dtype=torch.float32, device="cpu").offload


def _allocated_after_reconstruct(recon, crops) -> tuple[int, dict]:
    out = {k: v.cpu() for k, v in recon(crops).items()}
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated(), out


@pytest.mark.cuda
def test_offload_frees_the_parameters_and_changes_no_output(cuda):
    rng = np.random.default_rng(0)
    crops = torch.from_numpy(rng.random((3, 384, 512, 3), dtype=np.float32)).to(cuda)
    warm = build_reconstructor("full", seed=1, device=cuda, offload_params=False)
    warm(crops)  # the library workspaces, made once per process
    del warm
    torch.cuda.empty_cache()

    kept = build_reconstructor("full", seed=0, device=cuda, offload_params=False)
    assert not kept.offload
    with_params, want = _allocated_after_reconstruct(kept, crops)
    del kept
    torch.cuda.empty_cache()
    offloaded = build_reconstructor("full", seed=0, device=cuda)
    assert offloaded.offload
    tensors = [*offloaded.model.parameters(), *offloaded.model.buffers()]
    assert all(t.device.type == "cpu" and t.is_pinned() for t in tensors)
    without, got = _allocated_after_reconstruct(offloaded, crops)

    param_bytes = sum(-(-t.numel() * t.element_size() // 512) * 512 for t in tensors)
    assert param_bytes > 2e9  # VGGT-1B in bf16, its norms in fp32
    # the allocator may hand a tensor a cached block a little larger than it asked for
    assert param_bytes <= with_params - without <= param_bytes * 1.01
    assert all(t.device.type == "cpu" for t in offloaded.model.parameters())  # the device copies were dropped
    for k in want:
        assert torch.equal(got[k], want[k]), k
