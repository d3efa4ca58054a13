"""EvoWorld in PyTorch and CUDA: the port of `evoworld_tpu` to one NVIDIA H100.

Each module mirrors the path of its counterpart in `evoworld_tpu` and is held
against it by the tests in `tests/test_torch_port_*.py`. This package imports
torch, numpy and the standard library only; it never imports JAX or
`evoworld_tpu`.

Layer map (bottom-up), the first slice of the port (one clip):
  geometry/   camera poses, equirectangular ray grids, Pluecker embeddings
  ops/        attention dispatch, the hand-written Hopper flash-attention
              kernel (csrc/flash_attn_fwd.cu) and its plain version, resize
  models/     nn.Modules with diffusers/transformers parameter names:
              spatio-temporal UNet, temporal VAE, CLIP vision tower
  diffusion/  Euler/Karras scheduler and the single-clip pipeline
  runtime.py  build_pipeline: the entry point

Entry points run on CUDA unless the caller passes `device="cpu"`; without a
card they raise instead of falling back.
"""

from evoworld_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
__version__ = "0.1.0"
