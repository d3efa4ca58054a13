"""The port's Hopper flash-attention kernel on the card.

Held against `flash_attention_plain` (fp32 on the same bf16 inputs) with the
limits `chip_smoke.py` uses: the error over the RMS of the plain output at
most 0.1 (max) and 0.01 (mean). Keys and values past `kv_len` are set so
large (K = 10, V = 100) that a missed mask would swamp the output. Every test
carries the `cuda` marker and skips without a card. The file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_port_kernel.py --noconftest -q
"""

import pytest
import torch

from evoworld_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

MAX_REL_ERR, MEAN_REL_ERR = 0.1, 0.01


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the flash kernel has no CPU mode")
    return torch.device("cuda")


def _rel_errors(out, ref):
    err = (out.float() - ref).abs()
    rms = ref.pow(2).mean().sqrt()
    return (err.max() / rms).item(), (err.mean() / rms).item()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,sq,skv,kv_len,h,d,use_exp2",
    [(2, 300, 333, 333, 2, 64, False), (1, 1041, 1041, 1041, 16, 64, True), (1, 200, 177, 177, 1, 512, False),
     (2, 130, 130, 130, 2, 128, True), (2, 300, 500, 200, 2, 64, False), (1, 200, 400, 150, 1, 512, True),
     (2, 130, 300, 77, 2, 128, False)],
)
def test_kernel_matches_plain_on_card(cuda, b, sq, skv, kv_len, h, d, use_exp2):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=cuda).bfloat16() for s in (sq, skv, skv))
    k[:, kv_len:], v[:, kv_len:] = 10.0, 100.0
    out = flash_attention(q, k, v, kv_len=kv_len, use_exp2=use_exp2)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q.float(), k.float(), v.float(), kv_len=kv_len, use_exp2=use_exp2)
    max_rel, mean_rel = _rel_errors(out, ref)
    assert max_rel <= MAX_REL_ERR and mean_rel <= MEAN_REL_ERR


@pytest.mark.cuda
def test_kernel_reads_strided_views_and_rejects_bad_inputs(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((1, 500, 3, 4, 64), generator=g, device=cuda).bfloat16()
    q, k, v = qkv.unbind(2)  # strided views of one packed tensor
    ref = flash_attention_plain(q.float(), k.float(), v.float())
    max_rel, mean_rel = _rel_errors(flash_attention(q, k, v), ref)
    assert max_rel <= MAX_REL_ERR and mean_rel <= MEAN_REL_ERR
    with pytest.raises(ValueError):
        flash_attention(q.float(), k.float(), v.float())  # fp32: the kernel takes bf16 only
    with pytest.raises(ValueError):
        flash_attention(q[..., :48], k[..., :48], v[..., :48])  # head dim 48
