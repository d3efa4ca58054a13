"""EvoWorld in PyTorch and CUDA: the port of `evoworld_tpu` to one NVIDIA H100.

Each module mirrors the path of its counterpart in `evoworld_tpu` and is held
against it by the tests in `tests/test_torch_port_*.py`. This package imports
torch, numpy and the standard library only; it never imports JAX or
`evoworld_tpu`.

Layer map (bottom-up), the slices ported so far (one clip; EDM fine-tuning;
the evolving-memory loop; the production CLIs; the training CLI and
evaluation; data preparation; the parity gate, the exporters and the
multi-GPU serving path):
  geometry/   camera poses, equirectangular and pinhole ray grids, Pluecker
              embeddings, spherical resampling, similarity alignment
  ops/        attention dispatch, the hand-written Hopper flash-attention
              kernels (csrc/flash_attn_fwd.cu, csrc/flash_attn_bwd.cu) joined
              by an autograd Function, their plain versions, resizes, the
              z-buffer splat
  models/     nn.Modules with upstream parameter names: spatio-temporal UNet,
              temporal VAE, CLIP vision tower (diffusers/transformers), VGGT
              (facebookresearch/vggt)
  diffusion/  Euler/Karras scheduler, EDM helpers, the single-clip pipeline
  memory/     the point-cloud confidence filter, memory panorama rendering
              (view-sharded over a mesh), PLY / OBJ export
  loop/       the navigator and the evolving-memory loop (UnifiedLoop)
  data/, utils/  camera poses, episodes, image IO (PNG, JPEG, GIF), batch
              prefetching, the JSONL metrics tracker, GIF export
  train/      the EDM loss, optimizer and step; the training loop with its
              validation hook
  eval/       PSNR, SSIM, Frechet distance; LPIPS, Inception-v4, I3D and
              DreamSim nets under upstream names; the reference-format harness
  parallel/   the ranks of a multi-GPU run (mesh, backend rule), their
              collectives, a rank launcher and the composed loop gate
  runtime.py  build_pipeline, build_trainer and build_reconstructor: the
              entry points; inference_setup for `torchrun`
  cli/        run_unified, run_single_segment, train, calculate_metrics,
              calculate_dreamsim, validate_parity, the data-preparation CLIs

Entry points run on CUDA unless the caller passes `device="cpu"`; without a
card they raise instead of falling back.
"""

from evoworld_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
__version__ = "0.1.0"
