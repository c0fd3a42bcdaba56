"""PyTorch port ops against the JAX package, on the CPU, at small sizes.

Inputs are made by numpy from a seed and handed to both sides in fp32. On
CPU tensors the port's kernel wrappers take their plain versions, which are
held here against the JAX Pallas kernels run in interpret mode. Tolerances
are those of the matching JAX tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specforge_tpu.ops import attention as jax_attention
from specforge_tpu.ops import attention_pallas as jax_attention_pallas
from specforge_tpu.ops import lk_loss as jax_lk
from specforge_tpu.ops import loss as jax_loss
from specforge_tpu.ops import loss_pallas as jax_loss_pallas
from specforge_tpu.ops import rope as jax_rope
from specforge_tpu.ops import teacher as jax_teacher
from specforge_tpu_torch.ops import attention as pt_attention
from specforge_tpu_torch.ops import attention_cuda as pt_attention_cuda
from specforge_tpu_torch.ops import lk_loss as pt_lk
from specforge_tpu_torch.ops import loss as pt_loss
from specforge_tpu_torch.ops import loss_cuda as pt_loss_cuda
from specforge_tpu_torch.ops import rope as pt_rope
from specforge_tpu_torch.ops import teacher as pt_teacher
from specforge_tpu_torch.utils import shift_pad

B, H, KVH, S, D = 2, 4, 2, 64, 32
V, VD, HID = 2048, 512, 128

ATTN_TOL = 2e-5  # tests/test_attention_pallas.py
CE_RTOL = 1e-5   # tests/test_loss.py


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per test worker (see test_torch_train.py's
    fixture of the same name: the default oversubscribes a shared CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def attention_case(n_branches, padded, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    keys = [rng.normal(size=(B, KVH, S, D)).astype(np.float32)
            for _ in range(n_branches + 1)]
    values = [rng.normal(size=(B, KVH, S, D)).astype(np.float32)
              for _ in range(n_branches + 1)]
    valid = np.ones((B, S), np.int32)
    if padded:
        valid[1, S - 20:] = 0
    return q, keys, values, valid


@pytest.mark.parametrize("n_branches,padded",
                         [(0, False), (1, False), (6, False), (1, True),
                          (6, True)])
def test_ttt_attention_plain_matches_pallas_interpret(n_branches, padded):
    q, keys, values, valid = attention_case(n_branches, padded)
    expected = jax_attention_pallas.ttt_flash_attention(
        jnp.asarray(q), [jnp.asarray(k) for k in keys],
        [jnp.asarray(v) for v in values], key_valid=jnp.asarray(valid),
        interpret=True,
    )
    got = pt_attention_cuda.ttt_flash_attention(
        t(q), [t(k) for k in keys], [t(v) for v in values], t(valid)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(expected),
                               rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("n_branches", [0, 3])
def test_ttt_attention_stats_match_pallas_interpret(n_branches):
    """The saved (m, l) row statistics of the forward, for the backward."""
    q, keys, values, valid = attention_case(n_branches, padded=True, seed=1)
    g = H // KVH

    def flat(x):
        x = np.repeat(x, g, axis=1) if x.shape[1] != H else x
        return jnp.asarray(x.reshape(B * H, S, D))

    branches = tuple((flat(k), flat(v)) for k, v in zip(keys[1:], values[1:]))
    _, res = jax_attention_pallas._ttt_flash_fwd(
        flat(q), flat(keys[0]), flat(values[0]), branches,
        jnp.asarray(np.repeat(valid, H, axis=0)), S, S, True,
    )
    m_ref = np.asarray(res[6])[:, 0].reshape(B, H, S)
    l_ref = np.asarray(res[7])[:, 0].reshape(B, H, S)
    _, m, l = pt_attention_cuda.ttt_flash_attention_fwd(
        t(q), [t(k) for k in keys], [t(v) for v in values], t(valid)
    )
    np.testing.assert_allclose(m.numpy(), m_ref, rtol=ATTN_TOL, atol=ATTN_TOL)
    np.testing.assert_allclose(l.numpy(), l_ref, rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("n_branches,padded", [(0, True), (3, True),
                                               (6, False)])
def test_dense_attention_matches_jax_reference(n_branches, padded):
    q, keys, values, valid = attention_case(n_branches, padded, seed=2)
    bias_j = jax_attention.make_causal_bias(jnp.asarray(valid), B, S)
    expected = jax_attention.ttt_branch_attention_reference(
        jnp.asarray(q), [jnp.asarray(k) for k in keys],
        [jnp.asarray(v) for v in values], bias_j,
    )
    bias = pt_attention.make_causal_bias(t(valid), B, S)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(bias_j))
    got = pt_attention.ttt_branch_attention_reference(
        t(q), [t(k) for k in keys], [t(v) for v in values], bias
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(expected),
                               rtol=ATTN_TOL, atol=ATTN_TOL)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    q, keys, values, valid = attention_case(1, True)
    before = pt_attention_cuda.ttt_flash_attention_fwd.launches
    out, m, l = pt_attention_cuda.ttt_flash_attention_fwd(
        t(q), [t(k) for k in keys], [t(v) for v in values], t(valid))
    ref = pt_attention_cuda.ttt_flash_attention_plain(
        t(q), [t(k) for k in keys], [t(v) for v in values], t(valid))
    for a, b in zip((out, m, l), ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert pt_attention_cuda.ttt_flash_attention_fwd.launches == before

    logits, target, mask = ce_case((2, 8, 40))
    before = pt_loss_cuda.loss_forward.launches
    loss, _ = pt_loss_cuda.loss_forward(t(logits), t(target), t(mask))
    ref, _ = pt_loss_cuda.loss_forward_plain(t(logits), t(target), t(mask))
    assert float(loss) == float(ref)
    assert pt_loss_cuda.loss_forward.launches == before


def ce_case(shape, seed=3):
    b, tt, v = shape
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, tt, v)).astype(np.float32)
    target = rng.random((b, tt, v)).astype(np.float32)
    target /= target.sum(-1, keepdims=True)
    mask = (rng.random((b, tt, 1)) > 0.3).astype(np.int32)
    return logits, target, mask


@pytest.mark.parametrize("shape", [(2, 8, 40), (2, S, VD), (1, 300, 2500)])
def test_ce_plain_matches_pallas_interpret(shape):
    logits, target, mask = ce_case(shape)
    loss_j, (m_j, d_j, ts_j, _) = jax_loss_pallas.loss_forward_pallas(
        jnp.asarray(logits), jnp.asarray(target), jnp.asarray(mask),
        interpret=True,
    )
    loss, (m, d, ts, _) = pt_loss_cuda.loss_forward(
        t(logits), t(target), t(mask))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=CE_RTOL)
    for got, ref in ((m, m_j), (d, d_j), (ts, ts_j)):
        np.testing.assert_allclose(got.reshape(-1, 1).numpy(),
                                   np.asarray(ref), rtol=CE_RTOL)


def test_ce_dispatch_and_reference_match_jax():
    logits, target, mask = ce_case((2, S, VD), seed=4)
    ref_j = jax_loss.log_softmax_loss_reference(
        jnp.asarray(logits), jnp.asarray(target), jnp.asarray(mask))
    fused_j = jax_loss.log_softmax_loss(
        jnp.asarray(logits), jnp.asarray(target), jnp.asarray(mask))
    ref = pt_loss.log_softmax_loss_reference(t(logits), t(target), t(mask))
    fused = pt_loss.log_softmax_loss(t(logits), t(target), t(mask))
    np.testing.assert_allclose(float(ref), float(ref_j), rtol=CE_RTOL)
    np.testing.assert_allclose(float(fused), float(fused_j), rtol=CE_RTOL)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(B, KVH, S, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32) + 3, (B, S)).copy()
    spec_j = jax_rope.RopeSpec(head_dim=D, base=theta)
    spec = pt_rope.RopeSpec(head_dim=D, base=theta)
    cos_j, sin_j = jax_rope.rope_cos_sin(spec_j, jnp.asarray(pos), S + 3)
    cos, sin = pt_rope.rope_cos_sin(spec, t(pos), S + 3)
    np.testing.assert_allclose(cos.numpy(), np.asarray(cos_j), rtol=1e-6,
                               atol=1e-6)
    qj, kj = jax_rope.apply_rope(jnp.asarray(q), jnp.asarray(k), cos_j, sin_j)
    qt, kt = pt_rope.apply_rope(t(q), t(k), cos, sin)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=1e-5,
                               atol=1e-5)


def test_rope_spec_from_config_and_unported_types():
    class Cfg:
        hidden_size, num_attention_heads, head_dim = 4096, 32, 128
        rope_theta, max_position_embeddings = 1e6, 40960
        rope_scaling = {"rope_type": "yarn", "factor": 4.0}

    spec = pt_rope.RopeSpec.from_config(Cfg)
    assert spec == pt_rope.RopeSpec(**jax_rope.RopeSpec.from_config(Cfg).__dict__)
    with pytest.raises(NotImplementedError):
        pt_rope.rope_cos_sin(spec, torch.zeros(1, 4, dtype=torch.int32), 4)


def teacher_case(seed=6):
    rng = np.random.default_rng(seed)
    keep = np.sort(rng.choice(V, size=VD, replace=False))
    t2d = np.zeros(V, bool)
    t2d[keep] = True
    d2t = (keep - np.arange(VD)).astype(np.int32)
    hidden = rng.normal(size=(B, S, HID)).astype(np.float32)
    head = (rng.normal(size=(V, HID)) * 0.2).astype(np.float32)
    loss_mask = (rng.random((B, S, 1)) > 0.2).astype(np.int32)
    return t2d, d2t, hidden, head, loss_mask


def assert_teacher_close(got, ref):
    names = ("target_p", "accept_ratio", "token_ids", "position_mask")
    for name, a, b in zip(names, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_teacher_full_vocab_matches_jax():
    t2d, d2t, hidden, head, loss_mask = teacher_case()
    logits = hidden @ head.T
    ref = jax_teacher.compute_target_p_padded(
        jnp.asarray(logits), jnp.asarray(t2d), jnp.asarray(d2t),
        jnp.asarray(loss_mask), 7)
    got = pt_teacher.compute_target_p_padded(
        t(logits), t(t2d), t(d2t).long(), t(loss_mask), 7)
    assert_teacher_close(got, ref)


@pytest.mark.parametrize("chunk", [512, 600, 4096])
def test_teacher_compact_matches_jax(chunk):
    t2d, d2t, hidden, head, loss_mask = teacher_case(seed=7)
    ref = jax_teacher.compute_target_p_padded_from_hidden(
        jnp.asarray(hidden), jnp.asarray(head), jnp.asarray(t2d),
        jnp.asarray(d2t), jnp.asarray(loss_mask), 7, chunk_size=chunk)
    got = pt_teacher.compute_target_p_padded_from_hidden(
        t(hidden), t(head), t(t2d), t(d2t).long(), t(loss_mask), 7,
        chunk_size=chunk)
    assert_teacher_close(got, ref)
    lz_j, am_j = jax_teacher.tiled_logsumexp_argmax(
        jnp.asarray(hidden), jnp.asarray(head), chunk_size=chunk)
    lz, am = pt_teacher.tiled_logsumexp_argmax(t(hidden), t(head), chunk)
    np.testing.assert_allclose(lz.numpy(), np.asarray(lz_j), rtol=1e-6)
    np.testing.assert_array_equal(am.numpy(), np.asarray(am_j))


@pytest.mark.parametrize("chunk", [128, 8192])
def test_acceptance_matches_jax(chunk):
    rng = np.random.default_rng(8)
    logits = (rng.normal(size=(B, S, VD)) * 2).astype(np.float32)
    target = rng.random((B, S, VD)).astype(np.float32)
    target /= target.sum(-1, keepdims=True)
    ratio = rng.random((B, S, 1)).astype(np.float32)
    mask = (rng.random((B, S, 1)) > 0.3).astype(np.int32)
    per_j = jax_lk._acceptance_per_token(
        jnp.asarray(logits), jnp.asarray(target), jnp.asarray(ratio), chunk)
    per = pt_lk._acceptance_per_token(t(logits), t(target), t(ratio), chunk)
    np.testing.assert_allclose(per.numpy(), np.asarray(per_j), rtol=2e-5,
                               atol=1e-7)
    rate_j, log_j = jax_lk.compute_acceptance_rate(
        jnp.asarray(logits), jnp.asarray(target), jnp.asarray(mask),
        ratio=jnp.asarray(ratio))
    rate, log = pt_lk.compute_acceptance_rate(
        t(logits), t(target), t(mask), ratio=t(ratio))
    np.testing.assert_allclose(float(rate), float(rate_j), rtol=2e-5)
    np.testing.assert_allclose(float(log), float(log_j), rtol=2e-5)
    for mode in ("alpha", "lambda"):
        lk_j = jax_lk.compute_lk_loss(jnp.float32(2.0), rate_j, log_j, mode,
                                      1.0, 0.5)
        lk = pt_lk.compute_lk_loss(torch.tensor(2.0), rate, log, mode, 1.0,
                                   0.5)
        np.testing.assert_allclose(float(lk), float(lk_j), rtol=2e-5)


def test_shift_pad_matches_jax():
    from specforge_tpu.utils import shift_pad as jax_shift_pad

    x = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    for left in (True, False):
        np.testing.assert_array_equal(
            shift_pad(t(x), left=left).numpy(),
            np.asarray(jax_shift_pad(jnp.asarray(x), left=left)))


# --------------------------------------------------------------------------
# backward
# --------------------------------------------------------------------------

BWD_RTOL, BWD_ATOL = 5e-4, 5e-5  # tests/test_attention_pallas.py:76-84


@pytest.mark.parametrize("n_branches", [0, 1, 6])
def test_ttt_attention_backward_matches_pallas_interpret(n_branches):
    """jax.grad through the interpret-mode Pallas kernels against the port's
    autograd Function (plain backward on CPU), on q, every key and every
    value, with padded key_valid."""
    q, keys, values, valid = attention_case(n_branches, padded=True, seed=5)
    do = np.random.default_rng(6).normal(size=(B, S, H * D)).astype(np.float32)
    nk = len(keys)

    def f(q_, ks, vs):
        out = jax_attention_pallas.ttt_flash_attention(
            q_, list(ks), list(vs), key_valid=jnp.asarray(valid),
            interpret=True)
        return jnp.sum(out * jnp.asarray(do))

    gq_j, gk_j, gv_j = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), tuple(jnp.asarray(k) for k in keys),
        tuple(jnp.asarray(v) for v in values))

    tq = t(q).requires_grad_(True)
    tk = [t(k).requires_grad_(True) for k in keys]
    tv = [t(v).requires_grad_(True) for v in values]
    out = pt_attention_cuda.ttt_flash_attention(tq, tk, tv, t(valid))
    grads = torch.autograd.grad(out, [tq, *tk, *tv], t(do))
    assert len(grads) == 1 + 2 * nk
    expected = [gq_j, *gk_j, *gv_j]
    for i, (got, ref) in enumerate(zip(grads, expected)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=BWD_RTOL, atol=BWD_ATOL,
                                   err_msg=f"gradient {i}")


def test_ttt_attention_backward_plain_matches_autograd_of_plain_forward():
    q, keys, values, valid = attention_case(3, padded=True, seed=7)
    do = t(np.random.default_rng(8).normal(size=(B, S, H * D)).astype(
        np.float32))
    tq = t(q).requires_grad_(True)
    tk = [t(k).requires_grad_(True) for k in keys]
    tv = [t(v).requires_grad_(True) for v in values]
    out, m, l = pt_attention_cuda.ttt_flash_attention_plain(tq, tk, tv,
                                                            t(valid))
    expected = torch.autograd.grad(out, [tq, *tk, *tv], do)
    dq, dks, dvs = pt_attention_cuda.ttt_flash_attention_backward_plain(
        tq.detach(), [k.detach() for k in tk], [v.detach() for v in tv],
        t(valid), out.detach(), m.detach(), l.detach(), do)
    for got, ref in zip([dq, *dks, *dvs], expected):
        torch.testing.assert_close(got, ref, rtol=BWD_RTOL, atol=BWD_ATOL)


@pytest.mark.parametrize("shape", [(2, 8, 40), (2, S, VD), (1, 300, 2500)])
def test_ce_backward_plain_matches_pallas_interpret(shape):
    logits, target, mask = ce_case(shape, seed=9)
    g = np.float32(1.3)
    _, res_j = jax_loss_pallas.loss_forward_pallas(
        jnp.asarray(logits), jnp.asarray(target), jnp.asarray(mask),
        interpret=True)
    expected = jax_loss_pallas.loss_backward_pallas(
        jnp.asarray(logits), jnp.asarray(target), res_j, jnp.asarray(g),
        interpret=True)
    _, stats = pt_loss_cuda.loss_forward(t(logits), t(target), t(mask))
    got = pt_loss_cuda.loss_backward(t(logits), t(target), stats,
                                     torch.tensor(g))
    # tests/test_loss.py:95
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-4,
                               atol=1e-6)
    masked = mask[..., 0] == 0
    assert np.all(got.numpy()[masked] == 0.0)


def test_ce_autograd_reads_a_teacher_window_without_copying():
    """The fused CE's gradient, through autograd, for a strided window of a
    padded teacher (as a TTT step slices it), against jax.grad of the JAX
    fused loss."""
    logits, _, mask = ce_case((2, S, VD), seed=10)
    rng = np.random.default_rng(11)
    padded = rng.random((2, S + 7, VD)).astype(np.float32)
    padded /= padded.sum(-1, keepdims=True)
    window = padded[:, 3:3 + S]
    ref = jax.grad(lambda x: jax_loss.log_softmax_loss(
        x, jnp.asarray(window), jnp.asarray(mask)))(jnp.asarray(logits))
    x = t(logits).requires_grad_(True)
    target = t(padded)[:, 3:3 + S]
    assert not target.is_contiguous()
    (got,) = torch.autograd.grad(
        pt_loss.log_softmax_loss(x, target, t(mask)), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-6)
