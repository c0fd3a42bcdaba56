"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need an NVIDIA GPU with ``nvcc`` (the kernels are
built at first use) and skip elsewhere. Run them on the card with
``python -m pytest tests/test_torch_cuda.py -q --noconftest`` (the
repository's conftest pins JAX to the CPU, and the card's machine has no
JAX)."""

import pytest
import torch

from specforge_tpu_torch.ops import attention_cuda, loss_cuda
from specforge_tpu_torch.ops import dflash_attention_cuda as dflash_cuda
from specforge_tpu_torch.ops import lse_attention_cuda as lse_cuda
from specforge_tpu_torch.ops import peagle_attention_cuda as cod_cuda
from specforge_tpu_torch.ops.masks import sample_anchor_positions
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


def assert_forward_matches_plain(q, keys, values, valid):
    """One forward launch against the plain forward → (out, m, l)."""
    before = attention_cuda.ttt_flash_attention_fwd.launches
    out, m, l = attention_cuda.ttt_flash_attention_fwd(q, keys, values, valid)
    torch.cuda.synchronize()
    assert attention_cuda.ttt_flash_attention_fwd.launches == before + 1
    ref, ref_m, ref_l = attention_cuda.ttt_flash_attention_plain(
        q, keys, values, valid)
    for x in (out, m, l):
        assert bool(torch.isfinite(x).all())
    # bf16 output: relative eps 7.8e-3, sums taken in another order
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(m, ref_m, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(l, ref_l, rtol=1e-3, atol=1e-3)
    return out, m, l


@pytest.mark.parametrize("s,d,n_keys,h,kvh", [
    (64, 128, 1, 8, 2), (100, 128, 3, 8, 2), (257, 64, 7, 8, 2),
    (128, 128, 8, 8, 2),
    # ragged and tiny S, both head dims, 1 and 8 keys
    (1, 128, 8, 8, 2), (63, 64, 1, 8, 2), (64, 64, 8, 8, 2),
    (65, 128, 1, 8, 2), (2047, 128, 8, 8, 2), (2048, 64, 1, 8, 2),
    # groups of 8 (two chunks of four heads), 3 and 1 query heads
    (130, 128, 8, 8, 1), (100, 64, 3, 6, 2), (96, 128, 1, 4, 4),
    (200, 64, 8, 3, 3),
])
def test_ttt_attention_kernel_matches_plain(gen, s, d, n_keys, h, kvh):
    q, keys, values, valid = attention_inputs(gen, 2, h, kvh, s, d, n_keys)
    assert_forward_matches_plain(q, keys, values, valid)


@pytest.mark.parametrize("n_keys,h,kvh", [(1, 8, 2), (1, 4, 4), (3, 8, 2)])
def test_ttt_attention_forward_empty_rows(gen, n_keys, h, kvh):
    """A batch row with no valid key: with no branch its rows attend to
    nothing (out 0, m = -1e30, l = 0, no NaN); with branches they attend to
    the branch keys alone."""
    q, keys, values, valid = attention_inputs(gen, 2, h, kvh, 200, 128, n_keys)
    valid[0] = 0
    out, m, l = assert_forward_matches_plain(q, keys, values, valid)
    if n_keys == 1:
        assert float(out[0].float().abs().max()) == 0.0
        assert bool((m[0] == -1e30).all()) and bool((l[0] == 0).all())


@pytest.mark.parametrize("d,n_keys", [(128, 1), (64, 8), (128, 8)])
def test_ttt_attention_reads_strided_views(gen, d, n_keys):
    """q/k/v as views of one merged projection per step, as the draft model
    has them."""
    b, s, h, kvh = 2, 96, 4, 2
    qkvs = [torch.randn(b, s, (h + 2 * kvh) * d, generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(n_keys)]
    views = [(x[..., :h * d].view(b, s, h, d).transpose(1, 2),
              x[..., h * d:(h + kvh) * d].view(b, s, kvh, d).transpose(1, 2),
              x[..., (h + kvh) * d:].view(b, s, kvh, d).transpose(1, 2))
             for x in qkvs]
    q, keys, values = views[-1][0], [v[1] for v in views], [v[2] for v in views]
    out = attention_cuda.ttt_flash_attention(q, keys, values)
    ref = attention_cuda.ttt_flash_attention_plain(q, keys, values)[0]
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=2e-2)


def test_ttt_attention_forward_is_deterministic(gen):
    """Two launches at the main path's shape (6 branches, padded) give the
    same bits."""
    q, keys, values, valid = attention_inputs(gen, 2, 32, 8, 2048, 128, 7)
    first = attention_cuda.ttt_flash_attention_fwd(q, keys, values, valid)
    second = attention_cuda.ttt_flash_attention_fwd(q, keys, values, valid)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_ttt_attention_forward_refuses_what_it_does_not_take(gen):
    """Layouts the tensor maps cannot describe, and other dtypes, raise in
    the wrapper."""
    q, keys, values, valid = attention_inputs(gen, 1, 4, 2, 64, 128, 2)
    fwd = attention_cuda.ttt_flash_attention_fwd
    wide = torch.randn(1, 4, 64, 136, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fwd(wide[..., 4:132], keys, values, valid)  # 8-byte offset
    odd = torch.randn(1, 2, 64, 132, generator=gen, device="cuda",
                      dtype=torch.bfloat16)[..., :128]  # row stride 132
    with pytest.raises(ValueError):
        fwd(q, keys, [values[0], odd], valid)
    with pytest.raises(TypeError):
        fwd(q, [keys[0], keys[1].float()], values, valid)
    with pytest.raises(TypeError):
        fwd(q.half(), keys, values, valid)


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


@pytest.mark.parametrize("b,h,kvh,s,n_keys", [
    (2, 8, 2, 200, 4),
    (2, 32, 8, 2048, 7),  # the main path's shape: 6 branches, padded
])
def test_ttt_attention_backward_is_deterministic(gen, b, h, kvh, s, n_keys):
    q, keys, values, valid = attention_inputs(gen, b, h, kvh, s, 128, n_keys)
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


def assert_backward_matches_plain(q, keys, values, valid, gen):
    """The backward kernels (one launch each) against the plain backward:
    dq, the causal block's dk/dv and every branch's dk/dv summed over the
    group's heads, within 2e-2 of the largest reference value."""
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
    assert len(dks) == len(dvs) == len(keys)
    for got, want in [(dq, ref_dq), *zip(dks, ref_dks), *zip(dvs, ref_dvs)]:
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert bool(torch.isfinite(got).all())
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2e-2 * float(want.float().abs().max()) + 1e-6
    return dq, dks, dvs


@pytest.mark.parametrize("s,d,n_keys,h,kvh", [
    (1, 128, 8, 8, 2), (63, 64, 8, 8, 2), (64, 128, 8, 8, 2),
    (65, 128, 8, 8, 2), (2047, 128, 8, 8, 2), (2048, 64, 8, 8, 2),
    # groups of 8 (two chunks of resident heads, summed through the fp32
    # workspace), 3 and 1 query heads
    (130, 128, 8, 8, 1), (100, 64, 3, 6, 2), (96, 128, 2, 4, 4),
])
def test_ttt_attention_backward_edge_shapes(gen, s, d, n_keys, h, kvh):
    """Ragged and tiny S, D = 64, 7 branches, group sizes 1, 3, 4 and 8."""
    q, keys, values, valid = attention_inputs(gen, 2, h, kvh, s, d, n_keys)
    assert_backward_matches_plain(q, keys, values, valid, gen)


@pytest.mark.parametrize("h,kvh", [(64, 8), (28, 4), (16, 16)])
def test_ttt_kernels_at_the_offline_drafts_head_layouts(gen, h, kvh):
    """The forward and both backward kernels at the head layouts of the
    Llama-3-70B (a group of 8: two 4-head blocks), Qwen2.5-VL-7B (7: blocks
    of 4 and 3) and DeepSeek-V2-Lite (1) EAGLE3 drafts, at the main path's
    S = 2048 with 6 branches."""
    q, keys, values, valid = attention_inputs(gen, 2, h, kvh, 2048, 128, 7)
    assert_forward_matches_plain(q, keys, values, valid)
    assert_backward_matches_plain(q, keys, values, valid, gen)


@pytest.mark.parametrize("n_keys", [1, 8])
def test_ttt_attention_backward_fully_masked_rows(gen, n_keys):
    """key_valid padded at the end and masking the first keys of batch 0:
    its first rows see no causal key (with no branch they attend to
    nothing and get zero gradients)."""
    q, keys, values, valid = attention_inputs(gen, 2, 8, 2, 200, 128, n_keys)
    valid[0, :5] = 0
    dq, _, _ = assert_backward_matches_plain(q, keys, values, valid, gen)
    if n_keys == 1:
        assert float(dq[0, :, :5].float().abs().max()) == 0.0


@pytest.mark.parametrize("d", [64, 128])
def test_ttt_attention_backward_reads_strided_views(gen, d):
    """q and the 8 keys/values as views of merged projections, 7 branches."""
    b, s, h, kvh = 2, 300, 8, 2
    qkvs = [torch.randn(b, s, (h + 2 * kvh) * d, generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(8)]
    views = [(x[..., :h * d].view(b, s, h, d).transpose(1, 2),
              x[..., h * d:(h + kvh) * d].view(b, s, kvh, d).transpose(1, 2),
              x[..., (h + kvh) * d:].view(b, s, kvh, d).transpose(1, 2))
             for x in qkvs]
    valid = torch.ones((b, s), dtype=torch.int32, device="cuda")
    valid[1, 250:] = 0
    assert_backward_matches_plain(views[-1][0], [v[1] for v in views],
                                  [v[2] for v in views], valid, gen)


def test_ttt_attention_backward_refuses_what_it_does_not_take(gen):
    """Layouts the tensor maps cannot describe raise in the wrapper."""
    q, keys, values, valid = attention_inputs(gen, 1, 4, 2, 64, 128, 2)
    out, m, l = attention_cuda.ttt_flash_attention_fwd(q, keys, values, valid)
    dout = torch.randn(out.shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    wide = torch.randn(1, 4, 64, 136, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    misaligned = wide[..., 4:132]  # 8-byte offset, rows 136 elements apart
    with pytest.raises(ValueError):
        attention_cuda.ttt_flash_attention_bwd(
            misaligned, keys, values, valid, out, m, l, dout)
    odd = torch.randn(1, 2, 64, 132, generator=gen, device="cuda",
                      dtype=torch.bfloat16)[..., :128]  # row stride 132
    with pytest.raises(ValueError):
        attention_cuda.ttt_flash_attention_bwd(
            q, [odd, keys[1]], values, valid, out, m, l, dout)
    with pytest.raises(ValueError):
        attention_cuda.ttt_flash_attention_bwd(
            q, keys, values, valid, out, m[..., :32], l, dout)


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


# --------------------------------------------------------------------------
# DFlash block attention
# --------------------------------------------------------------------------

def dflash_inputs(gen, b, h, kvh, s, n, d, bs=16):
    """Anchors from the port's sampler over a response-part loss mask (row
    1, when there is one, has fewer candidates than slots; row 0's first
    anchor is 0) and bf16 q/k/v, q as a strided view of a merged
    projection, as the draft has them."""
    loss_mask = torch.zeros(b, s, dtype=torch.int32)
    loss_mask[:, s // 4:] = 1
    if b > 1:
        loss_mask[1, :s - n // 2] = 0
    anchors, keep = sample_anchor_positions(torch.Generator().manual_seed(1),
                                            loss_mask, n)
    anchors[0, 0] = 0
    q_len = n * bs

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    qkv = rnd(b, q_len, (h + 2 * kvh) * d)
    q = qkv[..., :h * d].view(b, q_len, h, d).transpose(1, 2)
    k_drf = qkv[..., h * d:(h + kvh) * d].view(b, q_len, kvh, d).transpose(
        1, 2)
    v_drf = qkv[..., (h + kvh) * d:].view(b, q_len, kvh, d).transpose(1, 2)
    return (q, rnd(b, kvh, s, d), rnd(b, kvh, s, d), k_drf, v_drf,
            anchors.cuda(), keep.cuda())


def rel_err(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


# (a) the Domino slice's shapes; (c) the sliding window of
# configs/qwen3.6-27b-dflash.json (w=4096 bites at S=8192); (e) a context
# that is no multiple of the 64-key tile, at D=64; block sizes that are no
# power of two, taken at the kernels' pitch: 7 at configs/qwen3-4b-dspark's
# shapes, 5 at D = 64, 12 under a biting window, 48 (a pitch of 64)
@pytest.mark.parametrize("b,h,kvh,s,n,d,window,bs", [
    (2, 32, 8, 768, 256, 128, None, 16),
    (1, 32, 8, 8192, 512, 128, 4096, 16),
    (2, 14, 2, 700, 40, 64, None, 16),
    (2, 32, 8, 768, 256, 128, None, 7),
    (2, 16, 4, 300, 20, 64, None, 5),
    (1, 16, 2, 1000, 40, 128, 200, 12),
    (2, 8, 2, 257, 10, 128, 48, 48),
])
def test_dflash_kernels_match_plain(gen, b, h, kvh, s, n, d, window, bs):
    inputs = dflash_inputs(gen, b, h, kvh, s, n, d, bs)
    counters = (dflash_cuda.dflash_flash_attention_fwd,
                dflash_cuda.dflash_attention_bwd_dq,
                dflash_cuda.dflash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    out, m, l = dflash_cuda.dflash_flash_attention_fwd(*inputs, bs, window)
    dout = torch.randn(out.shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    grads = dflash_cuda.dflash_flash_attention_bwd(*inputs, bs, window, out,
                                                   m, l, dout)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [x + 1 for x in before]
    q_len = n * bs
    assert out.shape == (b, q_len, h * d) and m.shape == (b, h, q_len)
    ref, ref_m, ref_l = dflash_cuda.dflash_flash_attention_plain(
        *inputs, bs, window)
    # bf16 outputs and gradients: products of bf16-rounded p and ds, sums in
    # another order; held at 2e-2 of the largest reference value
    assert rel_err(out, ref) <= 2e-2
    torch.testing.assert_close(m, ref_m, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(l, ref_l, rtol=1e-3, atol=1e-3)
    not_kept = ~inputs[-1].repeat_interleave(bs, dim=1)
    assert not out[not_kept].any()
    ref_grads = dflash_cuda.dflash_flash_attention_backward_plain(
        *inputs, bs, window, out, m, l, dout)
    for name, got, want, x in zip("q kc vc kd vd".split(), grads, ref_grads,
                                  inputs):
        assert got.shape == x.shape and got.dtype == torch.bfloat16, name
        assert rel_err(got, want) <= 2e-2, name


def test_dflash_autograd_is_deterministic_and_refuses_bad_shapes(gen):
    inputs = [x.detach().requires_grad_(x.is_floating_point())
              for x in dflash_inputs(gen, 2, 8, 2, 300, 20, 128)]
    runs = []
    for _ in range(2):
        out = dflash_cuda.dflash_flash_attention(*inputs, 16)
        runs.append(torch.autograd.grad(out.float().square().sum(),
                                        inputs[:5]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    q, kc, vc, kd, vd, anchors, keep = dflash_inputs(gen, 1, 4, 2, 64, 4, 64)
    with pytest.raises(ValueError, match="head dim"):
        dflash_cuda.dflash_flash_attention(q[..., :32], kc[..., :32],
                                           vc[..., :32], kd[..., :32],
                                           vd[..., :32], anchors, keep, 16)
    with pytest.raises(TypeError):
        dflash_cuda.dflash_flash_attention(q.float(), kc, vc, kd, vd, anchors,
                                           keep, 16)
    # a block of 65 rows has no pitch that divides the 64-row q tile
    q, kc, vc, kd, vd, anchors, keep = dflash_inputs(gen, 1, 4, 2, 64, 4, 64,
                                                     65)
    with pytest.raises(ValueError, match="block_size"):
        dflash_cuda.dflash_flash_attention(q, kc, vc, kd, vd, anchors, keep,
                                           65)


def dflash_dkv(inputs, window, gen, bs=16):
    """One launch of the context dk/dv kernel on the forward's statistics →
    (its operands, dk, dv, the plain dk, dv)."""
    q = inputs[0]
    out, m, l = dflash_cuda.dflash_flash_attention_fwd(*inputs, bs, window)
    dout = torch.randn(out.shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    delta = attention_cuda.backward_delta(out, dout, q.shape[1])
    args = (*inputs, bs, window, dout, m, l, delta)
    before = dflash_cuda.dflash_attention_bwd_dkv.launches
    dk, dv = dflash_cuda.dflash_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert dflash_cuda.dflash_attention_bwd_dkv.launches == before + 1
    ref = dflash_cuda.dflash_flash_attention_backward_plain(
        *inputs, bs, window, out, m, l, dout)
    return args, dk, dv, ref[1], ref[2]


def dflash_reached_keys(anchors, keep, s, window):
    """[B, S] bool: the context keys some kept row may attend."""
    reached = torch.zeros(anchors.shape[0], s, dtype=torch.bool)
    for b, (row, kept) in enumerate(zip(anchors.tolist(), keep.tolist())):
        for a, k in zip(row, kept):
            hi = min(max(a, 0), s)
            lo = min(max(a - (window - 1), 0), hi) if window else 0
            if k:
                reached[b, lo:hi] = True
    return reached


def test_dflash_dkv_is_bit_exact_at_the_domino_slice(gen):
    """Two launches at the Domino slice's shapes give the same bits, and
    both match the plain dk/dv."""
    inputs = dflash_inputs(gen, 2, 32, 8, 768, 256, 128)
    args, dk, dv, ref_dk, ref_dv = dflash_dkv(inputs, None, gen)
    again = dflash_cuda.dflash_attention_bwd_dkv(*args)
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])
    assert rel_err(dk, ref_dk) <= 2e-2 and rel_err(dv, ref_dv) <= 2e-2


# groups of 1, 4, 7 and 8 query heads; contexts that are no multiple of the
# 64-key tile; D = 64 and 128; a sliding window that bites (anchors past
# 2w, so a row's lower bound moves off 0); blocks of 7, 5, 12 and 48 rows
# (the kernels' pitch; padded rows reach no key)
@pytest.mark.parametrize("b,h,kvh,s,n,d,window,bs", [
    (2, 8, 8, 130, 12, 128, None, 16),
    (2, 16, 4, 700, 40, 64, None, 16),
    (2, 14, 2, 333, 24, 64, None, 16),
    (1, 32, 4, 1000, 40, 128, 200, 16),
    (2, 16, 2, 257, 20, 128, 48, 16),
    (2, 32, 8, 768, 256, 128, None, 7),
    (2, 14, 2, 333, 24, 64, None, 5),
    (1, 16, 4, 1000, 40, 128, 200, 12),
    (2, 16, 2, 257, 10, 128, 48, 48),
])
def test_dflash_dkv_matches_plain(gen, b, h, kvh, s, n, d, window, bs):
    inputs = dflash_inputs(gen, b, h, kvh, s, n, d, bs)
    anchors, keep = inputs[5], inputs[6]
    if window:
        assert bool(((anchors.long() - (window - 1)) > 0)[keep].any())
    _, dk, dv, ref_dk, ref_dv = dflash_dkv(inputs, window, gen, bs)
    for got, want in ((dk, ref_dk), (dv, ref_dv)):
        assert got.shape == (b, kvh, s, d) and got.dtype == torch.bfloat16
        # bf16 products of bf16-rounded p and ds, sums in another order
        assert rel_err(got, want) <= 2e-2
    reached = dflash_reached_keys(anchors.cpu(), keep.cpu(), s, window)
    unreached = (~reached).cuda()[:, None].expand(b, kvh, s)
    assert not dk[unreached].any() and not dv[unreached].any()


def test_dflash_dkv_unreached_key_tiles_are_exact_zeros(gen):
    """Key tiles no q tile reaches (every anchor below 200 of S = 700) come
    out exactly 0; the others match the plain dk/dv."""
    inputs = list(dflash_inputs(gen, 2, 8, 2, 700, 16, 128))
    inputs[5] = torch.sort(torch.randint(
        1, 200, (2, 16), generator=torch.Generator().manual_seed(3))
                           ).values.to(torch.int32).cuda()
    inputs[6] = torch.ones_like(inputs[5])
    _, dk, dv, ref_dk, ref_dv = dflash_dkv(inputs, None, gen)
    assert not dk[:, :, 200:].any() and not dv[:, :, 200:].any()
    assert dk[:, :, :190].any()
    assert rel_err(dk, ref_dk) <= 2e-2 and rel_err(dv, ref_dv) <= 2e-2


def test_dflash_dkv_reads_strided_views(gen):
    """Context keys and values cut from one merged [B, S, 2*KVH*D] tensor
    are read through their strides."""
    b, h, kvh, s, n, d = 2, 8, 2, 300, 20, 128
    inputs = list(dflash_inputs(gen, b, h, kvh, s, n, d))
    kv = torch.randn(b, s, 2 * kvh * d, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    inputs[1] = kv[..., :kvh * d].view(b, s, kvh, d).transpose(1, 2)
    inputs[2] = kv[..., kvh * d:].view(b, s, kvh, d).transpose(1, 2)
    _, dk, dv, ref_dk, ref_dv = dflash_dkv(inputs, None, gen)
    assert rel_err(dk, ref_dk) <= 2e-2 and rel_err(dv, ref_dv) <= 2e-2


def test_dflash_dkv_refuses_layouts_a_tensor_map_cannot_read(gen):
    inputs = list(dflash_inputs(gen, 1, 4, 2, 128, 8, 64))
    out, m, l = dflash_cuda.dflash_flash_attention_fwd(*inputs, 16)
    dout = torch.ones_like(out)
    delta = attention_cuda.backward_delta(out, dout, 4)
    wide = torch.randn(1, 2, 128, 68, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    for bad, match in ((wide[..., :64], "multiples of 8"),
                       (wide.flatten()[4:4 + 2 * 128 * 64].view(1, 2, 128, 64),
                        "16-byte aligned")):
        args = list(inputs)
        args[1] = bad
        with pytest.raises(ValueError, match=match):
            dflash_cuda.dflash_attention_bwd_dkv(*args, 16, None, dout, m, l,
                                                 delta)


def dflash_dq(inputs, window, gen, bs=16):
    """One launch of kernel A (dq and the draft dk/dv) on the forward's
    statistics → (its operands, dq, dk_drf, dv_drf, the plain ones)."""
    q = inputs[0]
    out, m, l = dflash_cuda.dflash_flash_attention_fwd(*inputs, bs, window)
    dout = torch.randn(out.shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    delta = attention_cuda.backward_delta(out, dout, q.shape[1])
    args = (*inputs, bs, window, dout, m, l, delta)
    before = dflash_cuda.dflash_attention_bwd_dq.launches
    dq, dkd, dvd = dflash_cuda.dflash_attention_bwd_dq(*args)
    torch.cuda.synchronize()
    assert dflash_cuda.dflash_attention_bwd_dq.launches == before + 1
    ref = dflash_cuda.dflash_flash_attention_backward_plain(
        *inputs, bs, window, out, m, l, dout)
    return args, dq, dkd, dvd, ref[0], ref[3], ref[4]


def test_dflash_dq_is_bit_exact_at_the_domino_slice(gen):
    """Two launches of kernel A at the Domino slice's shapes give the same
    bits, and match the plain dq and draft dk/dv."""
    inputs = dflash_inputs(gen, 2, 32, 8, 768, 256, 128)
    args, dq, dkd, dvd, ref_dq, ref_dkd, ref_dvd = dflash_dq(inputs, None,
                                                             gen)
    again = dflash_cuda.dflash_attention_bwd_dq(*args)
    for got, rep in zip((dq, dkd, dvd), again):
        assert torch.equal(got, rep)
    for got, want in ((dq, ref_dq), (dkd, ref_dkd), (dvd, ref_dvd)):
        assert rel_err(got, want) <= 2e-2


# groups of 1, 4, 7 and 8 query heads (7 and 8 in two chunks of resident
# heads); D = 64 and 128; contexts that are no multiple of the 64-key tile;
# a sliding window that bites; anchor blocks of 32 and 64 rows (two heads
# resident, the draft staging in the free Q slots); blocks of 7, 5, 12 and
# 48 rows at the kernels' pitch (padded rows dead, padded draft keys
# reached by no row)
@pytest.mark.parametrize("b,h,kvh,s,n,d,window,bs", [
    (2, 8, 8, 130, 12, 128, None, 16),
    (2, 16, 4, 700, 40, 64, None, 16),
    (2, 14, 2, 333, 24, 64, None, 16),
    (1, 32, 4, 1000, 40, 128, 200, 16),
    (2, 16, 2, 257, 20, 128, 48, 16),
    (2, 16, 4, 300, 10, 128, None, 32),
    (1, 8, 2, 500, 5, 128, 100, 64),
    (2, 32, 8, 768, 256, 128, None, 7),
    (2, 14, 2, 333, 24, 64, None, 5),
    (1, 16, 4, 1000, 40, 128, 200, 12),
    (2, 16, 2, 257, 10, 128, 48, 48),
])
def test_dflash_dq_matches_plain(gen, b, h, kvh, s, n, d, window, bs):
    inputs = dflash_inputs(gen, b, h, kvh, s, n, d, bs)
    anchors, keep = inputs[5], inputs[6]
    if window:
        assert bool(((anchors.long() - (window - 1)) > 0)[keep].any())
    _, dq, dkd, dvd, ref_dq, ref_dkd, ref_dvd = dflash_dq(inputs, window, gen,
                                                          bs)
    q_len = n * bs
    assert dq.shape == (b, h, q_len, d)
    for got in (dkd, dvd):
        # the draft gradients come out summed over each group's heads
        assert got.shape == (b, kvh, q_len, d) and got.is_contiguous()
    for got, want in ((dq, ref_dq), (dkd, ref_dkd), (dvd, ref_dvd)):
        assert got.dtype == torch.bfloat16
        # bf16 products of bf16-rounded p and ds, sums in another order
        assert rel_err(got, want) <= 2e-2
    # rows of blocks not kept attend nothing: exact zeros
    not_kept = ~keep.repeat_interleave(bs, dim=1)
    if b > 1:
        assert bool(not_kept.any())
    assert not dq.transpose(1, 2)[not_kept].any()
    assert not dkd.transpose(1, 2)[not_kept].any()
    assert not dvd.transpose(1, 2)[not_kept].any()


def test_dflash_dq_reads_strided_views(gen):
    """q and the draft keys cut from one merged qkv, the context keys and
    values from one merged kv: all read through their strides."""
    b, h, kvh, s, n, d = 2, 8, 2, 300, 20, 128
    inputs = list(dflash_inputs(gen, b, h, kvh, s, n, d))
    assert not inputs[0].is_contiguous() and not inputs[3].is_contiguous()
    kv = torch.randn(b, s, 2 * kvh * d, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    inputs[1] = kv[..., :kvh * d].view(b, s, kvh, d).transpose(1, 2)
    inputs[2] = kv[..., kvh * d:].view(b, s, kvh, d).transpose(1, 2)
    _, dq, dkd, dvd, ref_dq, ref_dkd, ref_dvd = dflash_dq(inputs, None, gen)
    for got, want in ((dq, ref_dq), (dkd, ref_dkd), (dvd, ref_dvd)):
        assert rel_err(got, want) <= 2e-2


def test_dflash_dq_refuses_layouts_a_tensor_map_cannot_read(gen):
    inputs = list(dflash_inputs(gen, 1, 4, 2, 128, 8, 64))
    out, m, l = dflash_cuda.dflash_flash_attention_fwd(*inputs, 16)
    dout = torch.ones_like(out)
    delta = attention_cuda.backward_delta(out, dout, 4)
    q_len = 8 * 16
    wide = torch.randn(1, 2, q_len, 68, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    for bad, match in (
            (wide[..., :64], "multiples of 8"),
            (wide.flatten()[4:4 + 2 * q_len * 64].view(1, 2, q_len, 64),
             "16-byte aligned")):
        args = list(inputs)
        args[3] = bad
        with pytest.raises(ValueError, match=match):
            dflash_cuda.dflash_attention_bwd_dq(*args, 16, None, dout, m, l,
                                                delta)


def dflash_forward(inputs, window, bs=16):
    """One launch of the DFlash forward → (out, m, l), held against the
    plain forward: out within 2e-2 of the largest reference value (bf16
    products of bf16-rounded p, sums in another order), m and l within 1e-3
    on rows of kept blocks, and rows of blocks not kept exactly out 0, m
    -1e30, l 0."""
    q = inputs[0]
    before = dflash_cuda.dflash_flash_attention_fwd.launches
    out, m, l = dflash_cuda.dflash_flash_attention_fwd(*inputs, bs, window)
    torch.cuda.synchronize()
    assert dflash_cuda.dflash_flash_attention_fwd.launches == before + 1
    ref, ref_m, ref_l = dflash_cuda.dflash_flash_attention_plain(
        *inputs, bs, window)
    b, h, q_len, d = q.shape
    assert out.shape == (b, q_len, h * d) and out.dtype == torch.bfloat16
    assert m.shape == l.shape == (b, h, q_len)
    assert rel_err(out, ref) <= 2e-2
    kept = inputs[6].repeat_interleave(bs, dim=1).bool()
    rows = kept[:, None].expand_as(m)
    torch.testing.assert_close(m[rows], ref_m[rows], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(l[rows], ref_l[rows], rtol=1e-3, atol=1e-3)
    assert not out[~kept].any()
    assert bool((m[~rows] == dflash_cuda.NEG_INF).all())
    assert not l[~rows].any()
    return out, m, l


def test_dflash_forward_is_bit_exact_at_the_domino_slice(gen):
    """Two launches at the Domino slice's shapes give the same bits, and
    both match the plain forward."""
    inputs = dflash_inputs(gen, 2, 32, 8, 768, 256, 128)
    out, m, l = dflash_forward(inputs, None)
    again = dflash_cuda.dflash_flash_attention_fwd(*inputs, 16)
    for got, rep in zip((out, m, l), again):
        assert torch.equal(got, rep)


# groups of 1, 4, 7 (two blocks: four heads and three) and 8 query heads;
# D = 64 and 128; anchor blocks of 4, 8, 16, 32 and 64 rows; contexts that
# are no multiple of the 64-key tile and q lengths that are no multiple of
# the 64-row tile; sliding windows that bite (anchors past 2w)
@pytest.mark.parametrize("b,h,kvh,s,n,d,window,bs", [
    (2, 8, 8, 130, 12, 128, None, 16),
    (2, 16, 4, 700, 40, 64, None, 4),
    (2, 14, 2, 333, 24, 64, None, 8),
    (1, 32, 4, 1000, 40, 128, 200, 16),
    (2, 16, 2, 257, 20, 128, 48, 8),
    (2, 16, 4, 300, 10, 128, None, 32),
    (1, 8, 2, 500, 5, 128, 100, 64),
    (2, 32, 8, 300, 18, 128, 64, 4),
])
def test_dflash_forward_matches_plain(gen, b, h, kvh, s, n, d, window, bs):
    inputs = dflash_inputs(gen, b, h, kvh, s, n, d, bs)
    anchors, keep = inputs[5], inputs[6]
    if window:
        assert bool(((anchors.long() - (window - 1)) > 0)[keep].any())
    dflash_forward(inputs, window, bs)
    if b > 1:
        assert bool((~keep.bool()).any())


def test_dflash_forward_q_tile_with_no_kept_row(gen):
    """A q tile whose four anchor blocks are all not kept (the block lists
    no tile) and a q tile with kept and dropped blocks both give exact
    zeros on the dropped rows, m -1e30 and l 0, and the plain values on the
    others."""
    inputs = list(dflash_inputs(gen, 2, 8, 2, 300, 16, 128))
    keep = torch.ones(2, 16, dtype=torch.int32)
    keep[0, 4:8] = 0        # the whole second q tile of row 0
    keep[1, 13] = 0         # one block of row 1's last q tile
    keep[1, :4] = 0         # row 1's first q tile
    inputs[6] = keep.cuda()
    out, m, l = dflash_forward(inputs, None)
    assert not out[0, 64:128].any() and not out[1, :64].any()
    assert bool((m[0, :, 64:128] == dflash_cuda.NEG_INF).all())
    assert not l[0, :, 64:128].any()
    assert out[1, 192:208].any() and not out[1, 208:224].any()


def test_dflash_forward_reads_strided_views(gen):
    """q (transposed) and the draft keys and values cut from one merged
    qkv, the context keys and values from one merged kv, as the draft model
    makes them: all read through their strides."""
    b, h, kvh, s, n, d = 2, 8, 2, 300, 20, 128
    inputs = list(dflash_inputs(gen, b, h, kvh, s, n, d))
    assert not inputs[0].is_contiguous() and not inputs[4].is_contiguous()
    kv = torch.randn(b, s, 2 * kvh * d, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    inputs[1] = kv[..., :kvh * d].view(b, s, kvh, d).transpose(1, 2)
    inputs[2] = kv[..., kvh * d:].view(b, s, kvh, d).transpose(1, 2)
    out, m, l = dflash_forward(inputs, None)
    dense = [x.contiguous() if x.is_floating_point() else x for x in inputs]
    for got, want in zip((out, m, l),
                         dflash_cuda.dflash_flash_attention_fwd(*dense, 16)):
        assert torch.equal(got, want)


def test_dflash_forward_refuses_layouts_a_tensor_map_cannot_read(gen):
    inputs = list(dflash_inputs(gen, 1, 4, 2, 128, 8, 64))
    q_len = 8 * 16
    for at, rows in ((1, 128), (4, q_len)):
        wide = torch.randn(1, 2, rows, 68, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
        for bad, match in (
                (wide[..., :64], "multiples of 8"),
                (wide.flatten()[4:4 + 2 * rows * 64].view(1, 2, rows, 64),
                 "16-byte aligned")):
            args = list(inputs)
            args[at] = bad
            with pytest.raises(ValueError, match=match):
                dflash_cuda.dflash_flash_attention_fwd(*args, 16)


# --------------------------------------------------------------------------
# P-EAGLE COD attention
# --------------------------------------------------------------------------

def cod_inputs(gen, b, h, kvh, d, s, doc_lengths=None, unsupervised=(),
               depths=8):
    """A COD sample from the port's sampler and doc-major sort over a
    response-part loss mask, and bf16 q/k/v as strided views of a merged
    projection, as the draft has them → (q, k, v, tiles)."""
    from specforge_tpu_torch.algorithms.peagle.model import (
        doc_major,
        document_ids_from_lengths,
        generate_cod_sample_indices,
    )

    docs = list(doc_lengths or (s,))
    doc_ids = document_ids_from_lengths(torch.tensor([docs] * b), s)
    loss_mask = torch.zeros(b, s, dtype=torch.int32)
    start = 0
    for n in docs:
        loss_mask[:, start + n // 4:start + n] = 1
        start += n
    for row in unsupervised:
        loss_mask[row] = 0
    sample = doc_major(generate_cod_sample_indices(
        torch.Generator().manual_seed(s), loss_mask, doc_ids, depths, 0.7,
        0.2), doc_ids)
    anchor_doc = doc_ids.long().gather(1, sample.anchor_pos.long())
    tiles = cod_cuda.cod_tiles(*(x.cuda() for x in (
        sample.anchor_pos, sample.depth, anchor_doc, sample.valid)))
    t = sample.depth.shape[1]
    qkv = torch.randn(b, t, (h + 2 * kvh) * d, generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    q = qkv[..., :h * d].view(b, t, h, d).transpose(1, 2)
    k = qkv[..., h * d:(h + kvh) * d].view(b, t, kvh, d).transpose(1, 2)
    v = qkv[..., (h + kvh) * d:].view(b, t, kvh, d).transpose(1, 2)
    return q, k, v, tiles


# (a) the slice's heads at S=256 (T=864); (b) 4 packed documents of 64
# (block-diagonal tiles); (e) a document ending at 150 (an invalid tail)
# and a row with no supervised token, at D=64
@pytest.mark.parametrize("b,h,kvh,d,s,docs,unsupervised", [
    (2, 32, 8, 128, 256, None, ()),
    (2, 32, 8, 128, 256, (64, 64, 64, 64), ()),
    (2, 14, 2, 64, 256, (150,), (1,)),
])
def test_cod_kernels_match_plain(gen, b, h, kvh, d, s, docs, unsupervised):
    q, k, v, tiles = cod_inputs(gen, b, h, kvh, d, s, docs, unsupervised)
    counters = (cod_cuda.cod_attention_fwd, cod_cuda.cod_attention_bwd_dq,
                cod_cuda.cod_attention_bwd_dkv)
    before = [c.launches for c in counters]
    out, m, l = cod_cuda.cod_attention_fwd(q, k, v, tiles)
    dout = torch.randn(out.shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    grads = cod_cuda.cod_attention_bwd(q, k, v, tiles, out, m, l, dout)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [x + 1 for x in before]
    ref, ref_m, ref_l = cod_cuda.cod_attention_plain(q, k, v, tiles.props)
    live = ref_l[:, 0] > 0
    assert (~live).any()
    # bf16 outputs and gradients, held at 2e-2 of the largest reference
    # value; rows with no allowed key exactly 0
    assert rel_err(out, ref) <= 2e-2
    assert not out[~live].any() and not l.transpose(1, 2)[~live].any()
    rows = live[:, None].expand_as(m)
    torch.testing.assert_close(m[rows], ref_m[rows], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(l[rows], ref_l[rows], rtol=1e-3, atol=1e-3)
    ref_grads = cod_cuda.cod_attention_backward_plain(q, k, v, tiles.props,
                                                      out, m, l, dout)
    for name, got, want, x in zip("qkv", grads, ref_grads, (q, k, v)):
        assert got.shape == x.shape and got.dtype == torch.bfloat16, name
        assert rel_err(got, want) <= 2e-2, name
    assert not grads[0].transpose(1, 2)[~live].any()


def test_cod_autograd_is_deterministic_and_refuses_bad_shapes(gen):
    q, k, v, tiles = cod_inputs(gen, 2, 8, 2, 128, 200)
    inputs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    runs = []
    for _ in range(2):
        out = cod_cuda.cod_flash_attention(*inputs, tiles=tiles)
        runs.append(torch.autograd.grad(out.float().square().sum(), inputs))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="head dim"):
        cod_cuda.cod_flash_attention(q[..., :32], k[..., :32], v[..., :32],
                                     tiles=tiles)
    with pytest.raises(TypeError):
        cod_cuda.cod_flash_attention(q.float(), k, v, tiles=tiles)
    with pytest.raises(ValueError, match="multiple of KVH"):
        cod_cuda.cod_flash_attention(q[:, :7], k, v, tiles=tiles)


def cod_dkv(q, k, v, tiles, gen):
    """One launch of the COD dk/dv kernel on the forward's statistics →
    (its operands, dk, dv, the plain dk, dv)."""
    out, m, l = cod_cuda.cod_attention_fwd(q, k, v, tiles)
    dout = torch.randn(out.shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    delta = attention_cuda.backward_delta(out, dout, q.shape[1])
    args = (q, k, v, tiles, dout, m, l, delta)
    before = cod_cuda.cod_attention_bwd_dkv.launches
    dk, dv = cod_cuda.cod_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert cod_cuda.cod_attention_bwd_dkv.launches == before + 1
    ref = cod_cuda.cod_attention_backward_plain(q, k, v, tiles.props, out, m,
                                                l, dout)
    return args, dk, dv, ref[1], ref[2]


def test_cod_dkv_is_bit_exact_at_the_slice(gen):
    """Two launches at the P-EAGLE slice's shapes give the same bits, and
    both match the plain dk/dv."""
    q, k, v, tiles = cod_inputs(gen, 2, 32, 8, 128, 1024)
    assert bool(tiles.full.any())
    args, dk, dv, ref_dk, ref_dv = cod_dkv(q, k, v, tiles, gen)
    again = cod_cuda.cod_attention_bwd_dkv(*args)
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])
    assert rel_err(dk, ref_dk) <= 2e-2 and rel_err(dv, ref_dv) <= 2e-2


# groups of 1, 4, 7 and 8 query heads at D = 64 and 128 (T from the
# sampler, no multiple of 64); packed documents; a document with an invalid
# tail and a row with no supervised token
@pytest.mark.parametrize("b,h,kvh,d,s,docs,unsupervised", [
    (2, 8, 8, 128, 200, None, ()),
    (2, 16, 4, 64, 256, (64, 64, 64, 64), ()),
    (2, 14, 2, 64, 300, (150,), (1,)),
    (1, 32, 4, 128, 512, (128, 384), ()),
    (2, 16, 2, 128, 256, (100, 156), (0,)),
])
def test_cod_dkv_matches_plain(gen, b, h, kvh, d, s, docs, unsupervised):
    q, k, v, tiles = cod_inputs(gen, b, h, kvh, d, s, docs, unsupervised)
    t = q.shape[2]
    _, dk, dv, ref_dk, ref_dv = cod_dkv(q, k, v, tiles, gen)
    for got, want in ((dk, ref_dk), (dv, ref_dv)):
        assert got.shape == (b, kvh, t, d) and got.dtype == torch.bfloat16
        assert rel_err(got, want) <= 2e-2
    # keys no row may attend (invalid slots, an unsupervised row): exact 0
    reached = cod_cuda._allow(tiles.props, tiles.props).any(dim=1)
    unreached = (~reached)[:, None].expand(b, kvh, t)
    assert bool(unreached.any())
    assert not dk[unreached].any() and not dv[unreached].any()


def test_cod_tiles_on_the_card_match_the_cpu(gen):
    """The full-tile flags and the two block orders built on the card (no
    host sync) equal those built on the CPU."""
    q, k, v, tiles = cod_inputs(gen, 2, 8, 2, 128, 1024, (256, 256, 512))
    cpu = cod_cuda.cod_tiles(*(x.cpu() for x in (
        tiles.props[..., 0], tiles.props[..., 1], tiles.props[..., 2],
        tiles.props[..., 3])))
    for name in ("table", "full", "order", "dq_order"):
        assert torch.equal(getattr(tiles, name).cpu(), getattr(cpu, name)), name


def test_cod_dkv_refuses_layouts_a_tensor_map_cannot_read(gen):
    q, k, v, tiles = cod_inputs(gen, 1, 4, 2, 64, 100)
    out, m, l = cod_cuda.cod_attention_fwd(q, k, v, tiles)
    dout = torch.ones_like(out)
    delta = attention_cuda.backward_delta(out, dout, 4)
    t = q.shape[2]
    wide = torch.randn(1, 2, t, 68, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    for bad, match in ((wide[..., :64], "multiples of 8"),
                       (wide.flatten()[4:4 + 2 * t * 64].view(1, 2, t, 64),
                        "16-byte aligned")):
        with pytest.raises(ValueError, match=match):
            cod_cuda.cod_attention_bwd_dkv(q, bad, v, tiles, dout, m, l,
                                           delta)
    with pytest.raises(ValueError, match="order"):
        cod_cuda.cod_attention_bwd_dkv(
            q, k, v, tiles._replace(order=tiles.order[:-1]), dout, m, l,
            delta)


def cod_dq(q, k, v, tiles, gen):
    """One launch of the COD dq kernel on the forward's statistics → (its
    operands, dq, the plain dq, the rows with an allowed key [B, T])."""
    out, m, l = cod_cuda.cod_attention_fwd(q, k, v, tiles)
    dout = torch.randn(out.shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    delta = attention_cuda.backward_delta(out, dout, q.shape[1])
    args = (q, k, v, tiles, dout, m, l, delta)
    before = cod_cuda.cod_attention_bwd_dq.launches
    dq = cod_cuda.cod_attention_bwd_dq(*args)
    torch.cuda.synchronize()
    assert cod_cuda.cod_attention_bwd_dq.launches == before + 1
    ref = cod_cuda.cod_attention_backward_plain(q, k, v, tiles.props, out, m,
                                                l, dout)
    return args, dq, ref[0], l[:, 0] > 0


def test_cod_dq_is_bit_exact_at_the_slice(gen):
    """Two launches at the P-EAGLE slice's shapes give the same bits, and
    both match the plain dq."""
    q, k, v, tiles = cod_inputs(gen, 2, 32, 8, 128, 1024)
    assert bool(tiles.full.any())
    args, dq, ref_dq, _ = cod_dq(q, k, v, tiles, gen)
    assert torch.equal(dq, cod_cuda.cod_attention_bwd_dq(*args))
    assert rel_err(dq, ref_dq) <= 2e-2


# groups of 1, 4, 7 and 8 query heads at D = 64 and 128 (T from the
# sampler, no multiple of 64); packed documents; a document with an invalid
# tail and a row with no supervised token
@pytest.mark.parametrize("b,h,kvh,d,s,docs,unsupervised", [
    (2, 8, 8, 128, 200, None, ()),
    (2, 16, 4, 64, 256, (64, 64, 64, 64), ()),
    (2, 14, 2, 64, 300, (150,), (1,)),
    (1, 32, 4, 128, 512, (128, 384), ()),
    (2, 16, 2, 128, 256, (100, 156), (0,)),
])
def test_cod_dq_matches_plain(gen, b, h, kvh, d, s, docs, unsupervised):
    q, k, v, tiles = cod_inputs(gen, b, h, kvh, d, s, docs, unsupervised)
    _, dq, ref_dq, live = cod_dq(q, k, v, tiles, gen)
    assert dq.shape == q.shape and dq.dtype == torch.bfloat16
    assert rel_err(dq, ref_dq) <= 2e-2
    # rows with no allowed key (invalid slots, an unsupervised row): exact 0
    if unsupervised or docs:
        assert bool((~live).any())
    assert not dq.transpose(1, 2)[~live].any()


def test_cod_dq_refuses_layouts_a_tensor_map_cannot_read(gen):
    q, k, v, tiles = cod_inputs(gen, 1, 4, 2, 64, 100)
    out, m, l = cod_cuda.cod_attention_fwd(q, k, v, tiles)
    dout = torch.ones_like(out)
    delta = attention_cuda.backward_delta(out, dout, 4)
    t = q.shape[2]
    wide = torch.randn(1, 2, t, 68, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    for bad, match in ((wide[..., :64], "multiples of 8"),
                       (wide.flatten()[4:4 + 2 * t * 64].view(1, 2, t, 64),
                        "16-byte aligned")):
        with pytest.raises(ValueError, match=match):
            cod_cuda.cod_attention_bwd_dq(q, k, bad, tiles, dout, m, l, delta)
    with pytest.raises(ValueError, match="dq_order"):
        cod_cuda.cod_attention_bwd_dq(
            q, k, v, tiles._replace(dq_order=tiles.dq_order[:-1]), dout, m,
            l, delta)


def cod_forward(q, k, v, tiles):
    """One launch of the COD forward → (out, m, l), held against the plain
    forward: out within 2e-2 of the largest reference value, m and l within
    1e-3 on rows with an allowed key, and rows with none exactly out 0,
    m -1e30, l 0; also returns the rows with an allowed key [B, T]."""
    before = cod_cuda.cod_attention_fwd.launches
    out, m, l = cod_cuda.cod_attention_fwd(q, k, v, tiles)
    torch.cuda.synchronize()
    assert cod_cuda.cod_attention_fwd.launches == before + 1
    ref, ref_m, ref_l = cod_cuda.cod_attention_plain(q, k, v, tiles.props)
    b, h, t, d = q.shape
    assert out.shape == (b, t, h * d) and out.dtype == torch.bfloat16
    assert rel_err(out, ref) <= 2e-2
    live = ref_l[:, 0] > 0
    rows = live[:, None].expand_as(m)
    torch.testing.assert_close(m[rows], ref_m[rows], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(l[rows], ref_l[rows], rtol=1e-3, atol=1e-3)
    assert not out[~live].any()
    assert bool((m[~rows] == cod_cuda.NEG_INF).all())
    assert not l[~rows].any()
    return out, m, l, live


# groups of 1, 2, 4 and 8 query heads (a group of 8: two blocks of four)
# and 7 (four and three) at D = 64 and 128, T from the sampler (no multiple
# of 64); packed documents; a document with an invalid tail and a row with
# no supervised token
@pytest.mark.parametrize("b,h,kvh,d,s,docs,unsupervised", [
    (2, 8, 8, 128, 200, None, ()),
    (2, 4, 2, 64, 256, (64, 64, 64, 64), ()),
    (2, 16, 4, 128, 256, (150,), (1,)),
    (1, 32, 4, 128, 512, (128, 384), ()),
    (2, 14, 2, 64, 300, (150,), (1,)),
    (2, 16, 2, 128, 256, (100, 156), (0,)),
])
def test_cod_forward_matches_plain(gen, b, h, kvh, d, s, docs, unsupervised):
    q, k, v, tiles = cod_inputs(gen, b, h, kvh, d, s, docs, unsupervised)
    _, _, _, live = cod_forward(q, k, v, tiles)
    if unsupervised or docs:
        assert bool((~live).any())


def test_cod_forward_is_bit_exact_at_the_slice(gen):
    """Two launches at the P-EAGLE slice's shapes give the same bits, and
    both match the plain forward."""
    q, k, v, tiles = cod_inputs(gen, 2, 32, 8, 128, 1024)
    assert bool(tiles.full.any())
    out, m, l, _ = cod_forward(q, k, v, tiles)
    for a, b in zip((out, m, l), cod_cuda.cod_attention_fwd(q, k, v, tiles)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("h,kvh,d,docs,unsupervised", [
    (32, 8, 128, None, ()),
    (14, 2, 64, (150,), (1,)),
])
def test_cod_forward_statistics_feed_the_backward(gen, h, kvh, d, docs,
                                                 unsupervised):
    """The backward kernels on the forward kernel's (out, m, l) give the
    plain backward's gradients on the plain forward's, within 2e-2 of the
    largest reference value."""
    q, k, v, tiles = cod_inputs(gen, 2, h, kvh, d, 256, docs, unsupervised)
    out, m, l, _ = cod_forward(q, k, v, tiles)
    dout = torch.randn(out.shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    grads = cod_cuda.cod_attention_bwd(q, k, v, tiles, out, m, l, dout)
    ref, ref_m, ref_l = cod_cuda.cod_attention_plain(q, k, v, tiles.props)
    ref_grads = cod_cuda.cod_attention_backward_plain(
        q, k, v, tiles.props, ref, ref_m, ref_l, dout)
    for name, got, want in zip("qkv", grads, ref_grads):
        assert rel_err(got, want) <= 2e-2, name


def test_cod_forward_refuses_layouts_a_tensor_map_cannot_read(gen):
    q, k, v, tiles = cod_inputs(gen, 1, 4, 2, 64, 100)
    t = q.shape[2]
    wide = torch.randn(1, 2, t, 68, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    for bad, match in ((wide[..., :64], "multiples of 8"),
                       (wide.flatten()[4:4 + 2 * t * 64].view(1, 2, t, 64),
                        "16-byte aligned")):
        with pytest.raises(ValueError, match=match):
            cod_cuda.cod_attention_fwd(q, bad, v, tiles)
        with pytest.raises(ValueError, match=match):
            cod_cuda.cod_attention_fwd(q, k, bad, tiles)
    with pytest.raises(ValueError, match="dq_order"):
        cod_cuda.cod_attention_fwd(
            q, k, v, tiles._replace(dq_order=tiles.dq_order[:-1]))


# --------------------------------------------------------------------------
# offset-causal LSE attention (the USP ring hop)
# --------------------------------------------------------------------------

def lse_inputs(gen, bh, s, d, pad_tail=0):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    valid = torch.ones((bh, s), dtype=torch.int32, device="cuda")
    if pad_tail:
        valid[:, s - pad_tail:] = 0
    return rnd(bh, s, d), rnd(bh, s, d), rnd(bh, s, d), valid


# (a) the own chunk (row_off = col_off); (b) an earlier chunk (every key
# allowed); (c) a later chunk (nothing allowed); (d) a key-padding tail
# with a ragged S; (e) head dim 64 and a half-overlapping chunk
@pytest.mark.parametrize("case,s,d,row_off,col_off,pad", [
    ("a_own", 256, 128, 512, 512, 0),
    ("b_earlier", 256, 128, 512, 256, 0),
    ("c_later", 256, 128, 256, 512, 0),
    ("d_padded_ragged", 250, 128, 250, 250, 37),
    ("e_d64_half", 200, 64, 300, 200, 0),
])
def test_lse_attention_kernels_match_plain(gen, case, s, d, row_off, col_off,
                                           pad):
    q, k, v, valid = lse_inputs(gen, 6, s, d, pad)
    counters = (lse_cuda.lse_attention_fwd, lse_cuda.lse_attention_bwd_dq,
                lse_cuda.lse_attention_bwd_dkv)
    before = [c.launches for c in counters]
    out, lse = lse_cuda.lse_attention_fwd(q, k, v, valid, row_off, col_off)
    dout = torch.randn(out.shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    dlse = torch.randn(lse.shape, generator=gen, device="cuda")
    grads = lse_cuda.lse_attention_bwd(q, k, v, valid, row_off, col_off, out,
                                       lse, dout, dlse)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [x + 1 for x in before]
    ref, ref_lse = lse_cuda.flash_attention_lse_plain(q, k, v, valid,
                                                      row_off, col_off)
    empty = ref_lse[..., 0] == lse_cuda.NEG_INF
    # rows with no allowed key: out exactly 0, lse exactly -1e30
    assert torch.equal(lse[empty], ref_lse[empty])
    assert not out[empty].any()
    if case == "c_later":
        assert bool(empty.all())
    else:
        # bf16 output held at 2e-2 of the largest reference value; the fp32
        # lse from bf16 products within 1e-3
        assert rel_err(out, ref) <= 2e-2
        torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)
    ref_grads = lse_cuda.flash_attention_lse_backward_plain(
        q, k, v, valid, row_off, col_off, out, lse, dout, dlse)
    for name, got, want in zip("qkv", grads, ref_grads):
        assert got.dtype == torch.bfloat16, name
        if case == "c_later":
            assert not got.any(), name
        else:
            assert rel_err(got, want) <= 2e-2, name


def test_lse_attention_autograd_is_deterministic_and_refuses_bad_inputs(gen):
    q, k, v, valid = lse_inputs(gen, 4, 300, 128, 20)
    inputs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    runs = []
    for _ in range(2):
        out, lse = lse_cuda.flash_attention_lse(*inputs, valid, 300, 0)
        loss = out.float().square().sum() + lse.square().sum()
        runs.append(torch.autograd.grad(loss, inputs))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="head dim"):
        lse_cuda.lse_attention_fwd(q[..., :32].contiguous(),
                                   k[..., :32].contiguous(),
                                   v[..., :32].contiguous(), valid, 0, 0)
    with pytest.raises(TypeError):
        lse_cuda.lse_attention_fwd(q.float(), k, v, valid, 0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        lse_cuda.lse_attention_fwd(q.transpose(0, 1).contiguous()
                                   .transpose(0, 1), k, v, valid, 0, 0)
    with pytest.raises(ValueError, match="int32"):
        lse_cuda.lse_attention_fwd(q, k, v, valid.bool(), 0, 0)


def lse_reached_keys(valid, s_q, row_off, col_off):
    """[BH, Sk] bool: the keys some row of the hop may attend."""
    idx = torch.arange(valid.shape[1], device=valid.device)
    return (valid != 0) & (idx + col_off <= s_q - 1 + row_off)[None]


# The tile situations the Hopper backward kernels tell apart: S of 1, 63,
# 64, 65 and 2048; offset differences (row_off - col_off) of 0, +-1, 63,
# 65 and 2048 (an earlier chunk) that are not multiples of 64; both head
# dims; every row dead but the last; a later chunk (all gradients 0); a key
# tail that pads whole 64-key tiles
@pytest.mark.parametrize("s,d,row_off,col_off,pad", [
    (1, 128, 7, 7, 0), (1, 64, 9, 3, 0),
    (63, 128, 100, 37, 0), (64, 64, 64, 1, 0),
    (65, 128, 65, 66, 0), (65, 64, 130, 65, 10),
    (2048, 128, 2048, 2048, 0), (2048, 64, 2111, 2048, 100),
    (2048, 128, 2048, 0, 0), (200, 128, 0, 199, 0),
    (300, 128, 0, 300, 0), (130, 128, 130, 130, 70),
])
def test_lse_backward_kernels_match_plain(gen, s, d, row_off, col_off, pad):
    bh = 4
    q, k, v, valid = lse_inputs(gen, bh, s, d, pad)
    out, lse = lse_cuda.lse_attention_fwd(q, k, v, valid, row_off, col_off)
    dout = torch.randn(out.shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    dlse = torch.randn(lse.shape, generator=gen, device="cuda")
    counters = (lse_cuda.lse_attention_bwd_dq, lse_cuda.lse_attention_bwd_dkv)
    before = [c.launches for c in counters]
    grads = lse_cuda.lse_attention_bwd(q, k, v, valid, row_off, col_off, out,
                                       lse, dout, dlse)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [x + 1 for x in before]
    ref_grads = lse_cuda.flash_attention_lse_backward_plain(
        q, k, v, valid, row_off, col_off, out, lse, dout, dlse)
    for name, got, want in zip("qkv", grads, ref_grads):
        assert got.dtype == torch.bfloat16, name
        assert bool(torch.isfinite(got).all()), name
        if want.any():
            # bf16 gradients held at 2e-2 of the largest reference value
            assert rel_err(got, want) <= 2e-2, name
        else:
            assert not got.any(), name
    # rows with no allowed key: dq exactly 0; keys no row reaches: dk and
    # dv exactly 0 (a later chunk: every gradient)
    dead = lse[..., 0] == lse_cuda.NEG_INF
    assert not grads[0][dead].any()
    unreached = ~lse_reached_keys(valid, s, row_off, col_off)
    assert not grads[1][unreached].any() and not grads[2][unreached].any()
    if col_off - row_off >= s:
        assert bool(dead.all()) and not any(g.any() for g in grads)


@pytest.mark.parametrize("row_off,col_off", [(2048, 2048), (2048, 0)])
def test_lse_backward_repeats_bit_exact_at_main_shape(gen, row_off, col_off):
    """The USP phase's own and earlier hops (BH=16, S=2048, D=128): two
    launches of each backward kernel give the same bits (no atomics)."""
    q, k, v, valid = lse_inputs(gen, 16, 2048, 128, 0)
    out, lse = lse_cuda.lse_attention_fwd(q, k, v, valid, row_off, col_off)
    dout = torch.randn(out.shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    dlse = torch.randn(lse.shape, generator=gen, device="cuda")
    args = (q, k, v, valid, row_off, col_off, dout, lse,
            lse_cuda.backward_dstat(out, dout, dlse))
    assert torch.equal(lse_cuda.lse_attention_bwd_dq(*args),
                       lse_cuda.lse_attention_bwd_dq(*args))
    for a, b in zip(lse_cuda.lse_attention_bwd_dkv(*args),
                    lse_cuda.lse_attention_bwd_dkv(*args)):
        assert torch.equal(a, b)


def test_lse_backward_refuses_misaligned_layouts(gen):
    """The tensor maps need 16-byte aligned bases: a contiguous view that
    starts off a 16-byte boundary raises, as do dout in another dtype or
    shape."""
    q, k, v, valid = lse_inputs(gen, 2, 128, 64, 0)
    out, lse = lse_cuda.lse_attention_fwd(q, k, v, valid, 128, 128)
    dlse = torch.zeros_like(lse)
    flat = torch.zeros(q.numel() + 1, device="cuda", dtype=torch.bfloat16)
    shifted = flat[1:].view(q.shape)
    assert shifted.is_contiguous()
    with pytest.raises(ValueError, match="16-byte"):
        lse_cuda.lse_attention_bwd(shifted, k, v, valid, 128, 128, out, lse,
                                   out, dlse)
    with pytest.raises(ValueError, match="16-byte"):
        lse_cuda.lse_attention_bwd(q, k, v, valid, 128, 128, out, lse,
                                   shifted, dlse)
    with pytest.raises(ValueError, match="dout"):
        lse_cuda.lse_attention_bwd(q, k, v, valid, 128, 128, out, lse,
                                   out.float(), dlse)
    with pytest.raises(ValueError, match="dout"):
        lse_cuda.lse_attention_bwd(q, k, v, valid, 128, 128, out, lse,
                                   out[:, :64], dlse)


def lse_forward(q, k, v, valid, row_off, col_off):
    """One launch of the LSE forward → (out, lse), held against the plain
    forward: out within 2e-2 of the largest reference value, lse within
    1e-3 (relative and absolute) on rows with an allowed key, and rows with
    none exactly out 0, lse -1e30."""
    before = lse_cuda.lse_attention_fwd.launches
    out, lse = lse_cuda.lse_attention_fwd(q, k, v, valid, row_off, col_off)
    torch.cuda.synchronize()
    assert lse_cuda.lse_attention_fwd.launches == before + 1
    ref, ref_lse = lse_cuda.flash_attention_lse_plain(q, k, v, valid,
                                                      row_off, col_off)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    dead = ref_lse[..., 0] == lse_cuda.NEG_INF
    assert not out[dead].any()
    assert bool((lse[dead] == lse_cuda.NEG_INF).all())
    if not dead.all():
        assert rel_err(out, ref) <= 2e-2
        torch.testing.assert_close(lse[~dead], ref_lse[~dead], rtol=1e-3,
                                   atol=1e-3)
    return out, lse


# The tile situations the forward tells apart: offset differences
# (row_off - col_off) of 0, +-1, +-63 and 65 that are not multiples of 64;
# one-row chunks; a key tail that pads whole 64-key tiles; both head dims;
# an earlier chunk (every stage mask-free) and a later one (no stage)
@pytest.mark.parametrize("s,d,row_off,col_off,pad", [
    (256, 128, 257, 256, 0), (256, 128, 256, 257, 0),
    (256, 64, 319, 256, 0), (256, 128, 256, 319, 0),
    (300, 128, 365, 300, 0), (1, 128, 7, 7, 0), (1, 64, 5, 9, 0),
    (250, 128, 250, 250, 70), (2048, 64, 2048, 0, 100),
    (130, 64, 130, 130, 0), (200, 128, 0, 200, 0),
])
def test_lse_forward_matches_plain(gen, s, d, row_off, col_off, pad):
    q, k, v, valid = lse_inputs(gen, 4, s, d, pad)
    out, lse = lse_forward(q, k, v, valid, row_off, col_off)
    if col_off - row_off >= s:
        assert bool((lse == lse_cuda.NEG_INF).all()) and not out.any()


@pytest.mark.parametrize("row_off,col_off", [(2048, 2048), (2048, 0),
                                             (0, 2048)])
def test_lse_forward_repeats_bit_exact_at_main_shape(gen, row_off, col_off):
    """The USP phase's own, earlier and later hops (BH=16, S=2048, D=128):
    two launches give the same bits (no atomics)."""
    q, k, v, valid = lse_inputs(gen, 16, 2048, 128, 0)
    out, lse = lse_forward(q, k, v, valid, row_off, col_off)
    again = lse_cuda.lse_attention_fwd(q, k, v, valid, row_off, col_off)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.parametrize("s,d,row_off,col_off,pad", [
    (256, 128, 256, 256, 0), (300, 64, 363, 300, 37),
])
def test_lse_forward_statistics_feed_the_backward(gen, s, d, row_off,
                                                 col_off, pad):
    """The backward kernels on the forward kernel's (out, lse) give the
    plain backward's gradients on the plain forward's, within 2e-2 of the
    largest reference value."""
    q, k, v, valid = lse_inputs(gen, 4, s, d, pad)
    out, lse = lse_forward(q, k, v, valid, row_off, col_off)
    dout = torch.randn(out.shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    dlse = torch.randn(lse.shape, generator=gen, device="cuda")
    grads = lse_cuda.lse_attention_bwd(q, k, v, valid, row_off, col_off, out,
                                       lse, dout, dlse)
    ref, ref_lse = lse_cuda.flash_attention_lse_plain(q, k, v, valid,
                                                      row_off, col_off)
    ref_grads = lse_cuda.flash_attention_lse_backward_plain(
        q, k, v, valid, row_off, col_off, ref, ref_lse, dout, dlse)
    for name, got, want in zip("qkv", grads, ref_grads):
        assert rel_err(got, want) <= 2e-2, name


# --------------------------------------------------------------------------
# fsdp: the shard collectives and the sharded optimizer, 2 gloo ranks on
# the one card (host-staged, as chip_smoke.py's mesh phase runs them)
# --------------------------------------------------------------------------

def _fsdp_rank(rank, port, factored):
    """One of 2 ranks at fsdp 2 on ``cuda:0``: a gather of every shard is
    the whole tensor; a reduce-scatter of each rank's gradient is its slice
    of their sum; the AdamW step on the slices (the global norm and the
    factored statistics summed over the fsdp group) is the slice of the
    step on the whole tensors."""
    import torch.distributed as dist

    from specforge_tpu_torch.parallel.fsdp import ShardPlan
    from specforge_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from specforge_tpu_torch.training.optimizer import (
        AdamW,
        OptimizerConfig,
        global_norm,
    )

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        mesh = build_mesh(MeshConfig(fsdp=2), torch.device("cuda", 0))
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = torch.nn.ModuleDict({
            "wide": torch.nn.Linear(512, 256, bias=False),   # dim 1
            "tall": torch.nn.Linear(128, 1024, bias=False),  # dim 0
            "small": torch.nn.Linear(256, 8),                # whole
        }).cuda()
        for p in model.parameters():
            p.data = torch.randn(p.shape, generator=gen, device="cuda")
        whole = {n: p.detach().clone() for n, p in model.named_parameters()}
        grads = {n: torch.randn(p.shape, generator=gen, device="cuda")
                 for n, p in whole.items()}
        plan = ShardPlan(model, mesh)
        assert plan.dims == {"wide.weight": 1, "tall.weight": 0,
                             "small.weight": None, "small.bias": None}
        plan.shard_model_(model)
        for n, p in model.named_parameters():
            dim = plan.dim(n)
            assert torch.equal(plan.gather(p, dim) if dim is not None else p,
                               whole[n])
        # each rank's share: rank + 1 times the gradient, summing to 3
        mine = {n: g * (rank + 1) for n, g in grads.items()}
        plan.reduce_grads(mine)
        for n, g in mine.items():
            assert torch.equal(g, plan.local(grads[n] * 3, plan.dim(n)))

        cfg = OptimizerConfig(lr=1e-2, warmup_ratio=0.0, max_grad_norm=1.0,
                              factored_second_moments=factored,
                              factored_min_dim=8,
                              adam_b1=0.0 if factored else 0.9)
        opt = AdamW(cfg, total_steps=10)
        ref_params = {n: p.clone() for n, p in whole.items()}
        ref_state = opt.init(ref_params)
        params = dict(model.named_parameters())
        state = plan.materialize(opt.init(plan.meta(params)), "cuda")
        for step in range(2):
            g_whole = {n: g * (step + 1) for n, g in grads.items()}
            g_local = {n: plan.local(g, plan.dim(n))
                       for n, g in g_whole.items()}
            ref_state = opt.step(ref_params, g_whole, ref_state,
                                 global_norm(g_whole))
            state = opt.step(params, g_local, state,
                             global_norm(g_local, plan), shards=plan)
            for n, p in params.items():
                torch.testing.assert_close(
                    p.detach(), plan.local(ref_params[n], plan.dim(n)),
                    rtol=1e-6, atol=1e-7, msg=n)
        for path, leaf in (("nu_row", "wide.weight"), ("nu_col", "tall.weight"),
                           ("nu", "small.bias")):
            kind = path if factored else "nu"
            if leaf in state[kind]:
                torch.testing.assert_close(
                    state[kind][leaf],
                    plan.local(ref_state[kind][leaf],
                               plan.opt_leaf_dim((kind, leaf))),
                    rtol=1e-6, atol=1e-12)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("factored", [False, True])
def test_fsdp_collectives_and_sharded_optimizer(gen, factored):
    """Two gloo ranks on the card (``torch.multiprocessing.spawn``)."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_fsdp_rank, args=(port, factored), nprocs=2, join=True)
