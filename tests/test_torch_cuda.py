"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need an NVIDIA GPU with ``nvcc`` (the kernels are
built at first use) and skip elsewhere. Run them on the card with
``python -m pytest tests/test_torch_cuda.py -q --noconftest`` (the
repository's conftest pins JAX to the CPU, and the card's machine has no
JAX)."""

import pytest
import torch

from specforge_tpu_torch.ops import attention_cuda, loss_cuda
from specforge_tpu_torch.ops.loss import (
    log_softmax_loss,
    log_softmax_loss_reference,
)

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


@pytest.mark.parametrize("s,d,n_keys", [(64, 128, 1), (100, 128, 3),
                                        (257, 64, 7), (130, 128, 2)])
def test_ttt_attention_backward_kernels_match_plain(gen, s, d, n_keys):
    q, keys, values, valid = attention_inputs(gen, 2, 8, 2, s, d, n_keys)
    out, m, l = attention_cuda.ttt_flash_attention_fwd(q, keys, values, valid)
    dout = torch.randn(out.shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    before = (attention_cuda.ttt_attention_bwd_dq.launches,
              attention_cuda.ttt_attention_bwd_dkv.launches)
    dq, dks, dvs = attention_cuda.ttt_flash_attention_bwd(
        q, keys, values, valid, out, m, l, dout)
    torch.cuda.synchronize()
    assert (attention_cuda.ttt_attention_bwd_dq.launches,
            attention_cuda.ttt_attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    ref_dq, ref_dks, ref_dvs = attention_cuda.ttt_flash_attention_backward_plain(
        q, keys, values, valid, out, m, l, dout)
    assert len(dks) == len(dvs) == n_keys
    # bf16 gradients: products of bf16-rounded p and ds, summed in another
    # order; held at 2e-2 of the largest reference value
    for got, want in [(dq, ref_dq), *zip(dks, ref_dks), *zip(dvs, ref_dvs)]:
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2e-2 * float(want.float().abs().max()) + 1e-6


def test_ttt_attention_backward_is_deterministic(gen):
    q, keys, values, valid = attention_inputs(gen, 2, 8, 2, 200, 128, 4)
    out, m, l = attention_cuda.ttt_flash_attention_fwd(q, keys, values, valid)
    dout = torch.randn(out.shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    first = attention_cuda.ttt_flash_attention_bwd(
        q, keys, values, valid, out, m, l, dout)
    second = attention_cuda.ttt_flash_attention_bwd(
        q, keys, values, valid, out, m, l, dout)
    assert torch.equal(first[0], second[0])
    for a, b in zip(first[1] + first[2], second[1] + second[2]):
        assert torch.equal(a, b)


def test_ttt_attention_autograd_reaches_every_key(gen):
    """Gradients of strided q/k/v views of one merged projection, through
    the autograd Function, against the plain backward."""
    b, s, h, kvh, d = 2, 96, 4, 2, 128
    qkvs = [torch.randn(b, s, (h + 2 * kvh) * d, generator=gen, device="cuda",
                        dtype=torch.bfloat16, requires_grad=True)
            for _ in range(3)]

    def split(qkv):
        return (qkv[..., :h * d].view(b, s, h, d).transpose(1, 2),
                qkv[..., h * d:(h + kvh) * d].view(b, s, kvh, d).transpose(1, 2),
                qkv[..., (h + kvh) * d:].view(b, s, kvh, d).transpose(1, 2))

    parts = [split(x) for x in qkvs]
    q = parts[-1][0]
    keys = [p[1] for p in parts]
    values = [p[2] for p in parts]
    out = attention_cuda.ttt_flash_attention(q, keys, values)
    dout = torch.randn(out.shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    grads = torch.autograd.grad(out, qkvs, dout)
    with torch.no_grad():
        ref_out, m, l = attention_cuda.ttt_flash_attention_plain(q, keys, values)
        rq, rks, rvs = attention_cuda.ttt_flash_attention_backward_plain(
            q, keys, values, None, ref_out, m, l, dout)
    for i, g in enumerate(grads):
        assert float(g.float().abs().sum()) > 0, f"no gradient for qkv {i}"
        gq, gk, gv = split(g)
        pairs = [(gk, rks[i]), (gv, rvs[i])] + ([(gq, rq)] if i == 2 else [])
        for got, want in pairs:
            err = float((got.float() - want.float()).abs().max())
            assert err <= 2e-2 * float(want.float().abs().max())


@pytest.mark.parametrize("v,dtype", [(32000, torch.bfloat16),
                                     (2500, torch.bfloat16),
                                     (4099, torch.float32)])
def test_fused_ce_backward_kernel_matches_plain(gen, v, dtype):
    b, t, pad = 2, 64, 7
    logits = (torch.randn(b, t, v, generator=gen, device="cuda") * 2).to(dtype)
    # a window of a longer teacher, as a TTT step reads it
    padded = torch.softmax(
        torch.randn(b, t + pad, v, generator=gen, device="cuda"), dim=-1)
    target = padded[:, 3:3 + t]
    mask = (torch.rand(b, t, 1, generator=gen, device="cuda") > 0.2).int()
    loss, stats = loss_cuda.loss_forward(logits, target, mask)
    ref_loss, _ = loss_cuda.loss_forward_plain(logits, target, mask)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-4, atol=0)
    g = torch.tensor(1.7, device="cuda")
    before = loss_cuda.loss_backward.launches
    grad = loss_cuda.loss_backward(logits, target, stats, g)
    torch.cuda.synchronize()
    assert loss_cuda.loss_backward.launches == before + 1
    ref = loss_cuda.loss_backward_plain(logits, target, stats, g)
    assert grad.dtype == dtype
    masked = mask[..., 0] == 0
    assert float(grad[masked].float().abs().max()) == 0.0
    # the fp32 plain gradient rounded to the working dtype, per element:
    # rtol 1e-2 for two roundings of fp32 values that differ in their last
    # bits, plus 1e-5 of the two terms the gradient is the difference of,
    # for the fp32 rounding (__expf) where they cancel (as chip_smoke.py)
    m, d, ts, mask32 = stats
    softmax = torch.exp(logits.float() - m) / d
    terms = (target + softmax * ts) * (1.7 / (b * t)) * mask32
    tol = 1e-2 * ref.float().abs() + 1e-5 * terms
    assert bool(((grad.float() - ref.float()).abs() <= tol).all())


def test_fused_ce_autograd_uses_the_kernels(gen):
    logits = torch.randn(2, 16, 512, device="cuda", requires_grad=True)
    target = torch.softmax(torch.randn(2, 16, 512, device="cuda"), dim=-1)
    mask = torch.ones(2, 16, 1, device="cuda")
    before = (loss_cuda.loss_forward.launches, loss_cuda.loss_backward.launches)
    loss = log_softmax_loss(logits, target, mask)
    (grad,) = torch.autograd.grad(loss, logits)
    assert (loss_cuda.loss_forward.launches,
            loss_cuda.loss_backward.launches) == (before[0] + 1, before[1] + 1)
    ref_logits = logits.detach().requires_grad_(True)
    (ref,) = torch.autograd.grad(
        log_softmax_loss_reference(ref_logits, target, mask), ref_logits)
    torch.testing.assert_close(grad, ref, rtol=1e-4, atol=1e-7)


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
