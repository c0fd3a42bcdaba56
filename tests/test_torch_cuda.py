"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need an NVIDIA GPU with ``nvcc`` (the kernels are
built at first use) and skip elsewhere. Run them on the card with
``python -m pytest tests/test_torch_cuda.py -q --noconftest`` (the
repository's conftest pins JAX to the CPU, and the card's machine has no
JAX)."""

import pytest
import torch

from specforge_tpu_torch.ops import attention_cuda, loss_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.Generator(device="cuda").manual_seed(0)


def attention_inputs(gen, b, h, kvh, s, d, n_keys):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    valid = torch.ones((b, s), dtype=torch.int32, device="cuda")
    valid[-1, s - s // 4:] = 0
    return (rnd(b, h, s, d), [rnd(b, kvh, s, d) for _ in range(n_keys)],
            [rnd(b, kvh, s, d) for _ in range(n_keys)], valid)


@pytest.mark.parametrize("s,d,n_keys", [(64, 128, 1), (100, 128, 3),
                                        (257, 64, 7), (128, 128, 8)])
def test_ttt_attention_kernel_matches_plain(gen, s, d, n_keys):
    q, keys, values, valid = attention_inputs(gen, 2, 8, 2, s, d, n_keys)
    before = attention_cuda.ttt_flash_attention_fwd.launches
    out, m, l = attention_cuda.ttt_flash_attention_fwd(q, keys, values, valid)
    torch.cuda.synchronize()
    assert attention_cuda.ttt_flash_attention_fwd.launches == before + 1
    ref, ref_m, ref_l = attention_cuda.ttt_flash_attention_plain(
        q, keys, values, valid)
    # bf16 output: relative eps 7.8e-3, sums taken in another order
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(m, ref_m, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(l, ref_l, rtol=1e-3, atol=1e-3)


def test_ttt_attention_reads_strided_views(gen):
    """q/k/v as views of one merged projection, as the draft model has them."""
    b, s, h, kvh, d = 2, 96, 4, 2, 128
    qkv = torch.randn(b, s, (h + 2 * kvh) * d, generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    q = qkv[..., :h * d].view(b, s, h, d).transpose(1, 2)
    k = qkv[..., h * d:(h + kvh) * d].view(b, s, kvh, d).transpose(1, 2)
    v = qkv[..., (h + kvh) * d:].view(b, s, kvh, d).transpose(1, 2)
    out = attention_cuda.ttt_flash_attention(q, [k], [v])
    ref = attention_cuda.ttt_flash_attention_plain(q, [k], [v])[0]
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=2e-2)


@pytest.mark.parametrize("v,dtype", [(32000, torch.bfloat16),
                                     (2500, torch.bfloat16),
                                     (4099, torch.float32)])
def test_fused_ce_kernel_matches_plain(gen, v, dtype):
    b, t = 2, 64
    logits = (torch.randn(b, t, v, generator=gen, device="cuda") * 2).to(dtype)
    target = torch.softmax(
        torch.randn(b, t, v, generator=gen, device="cuda"), dim=-1)
    mask = (torch.rand(b, t, 1, generator=gen, device="cuda") > 0.3).int()
    before = loss_cuda.loss_forward.launches
    loss, stats = loss_cuda.loss_forward(logits, target, mask)
    assert loss_cuda.loss_forward.launches == before + 1
    ref, ref_stats = loss_cuda.loss_forward_plain(logits, target, mask)
    # fp32 sums over the vocab in another order
    torch.testing.assert_close(loss, ref, rtol=1e-4, atol=0)
    for got, want in zip(stats, ref_stats):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_kernels_raise_instead_of_differentiating(gen):
    q, keys, values, valid = attention_inputs(gen, 1, 4, 2, 64, 128, 2)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        attention_cuda.ttt_flash_attention(q, keys, values, valid)
    logits = torch.randn(1, 4, 64, device="cuda", requires_grad=True)
    target = torch.softmax(torch.randn(1, 4, 64, device="cuda"), dim=-1)
    with pytest.raises(NotImplementedError, match="training slice"):
        loss_cuda.loss_forward(logits, target, torch.ones(1, 4, 1,
                                                          device="cuda"))


def test_kernels_refuse_what_they_do_not_take(gen):
    q, keys, values, valid = attention_inputs(gen, 1, 4, 2, 64, 128, 1)
    with pytest.raises(TypeError):
        attention_cuda.ttt_flash_attention(q.float(), keys, values, valid)
    with pytest.raises(ValueError):
        attention_cuda.ttt_flash_attention(q[..., :96], keys, values, valid)
    logits = torch.randn(1, 4, 64, device="cuda")
    with pytest.raises(TypeError):
        loss_cuda.loss_forward(logits, logits.double(),
                               torch.ones(1, 4, 1, device="cuda"))
    strided = torch.softmax(torch.randn(1, 4, 128, device="cuda"), -1)[..., ::2]
    with pytest.raises(ValueError):
        loss_cuda.loss_forward(logits, strided,
                               torch.ones(1, 4, 1, device="cuda"))
