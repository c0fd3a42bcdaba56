"""The port's RoPE types and the chunked TTT branch attention against the
JAX package, on the CPU.

Every scaling type (default, linear, dynamic below and above its maximum,
llama3, yarn, mrope) at head dim 16: the inverse frequencies, the cos/sin
tables and the rotation, at ``tests/test_rope.py``'s tolerances (rtol 1e-6
on frequencies; 1e-5 / 1e-6 on tables and rotations). Then the dense
backend's chunked path at S = 1024 (the dispatch's threshold): forward and
query gradient against JAX's ``ttt_branch_attention_chunked`` and the dense
path, at ``tests/test_attention.py::test_chunked_matches_dense``'s
tolerances, and the dispatch rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specforge_tpu.data.vlm import VisionSpan as JaxVisionSpan
from specforge_tpu.data.vlm import mrope_position_ids as jax_mrope_position_ids
from specforge_tpu.ops import attention as jax_attention
from specforge_tpu.ops import rope as jax_rope
from specforge_tpu_torch.ops import attention as pt_attention
from specforge_tpu_torch.ops import rope as pt_rope

D, B, S, H, KVH = 16, 2, 24, 4, 2
FREQ_RTOL = 1e-6
TABLE_RTOL, TABLE_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per worker: several pytest workers share
    the machine in the tier-1 run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


#: (id, RopeSpec fields, seq_len the tables are built for)
ROPE_CASES = [
    ("default", dict(), S),
    ("linear", dict(scaling_type="linear", scaling_factor=4.0), S),
    ("dynamic_below", dict(scaling_type="dynamic", scaling_factor=2.0,
                           max_position_embeddings=32), S),
    ("dynamic_above", dict(scaling_type="dynamic", scaling_factor=2.0,
                           max_position_embeddings=16), S),
    # wavelengths of D = 16 at base 1e4 fall in all three llama3 bands
    ("llama3", dict(scaling_type="llama3", scaling_factor=8.0,
                    low_freq_factor=1.0, high_freq_factor=4.0,
                    original_max_position_embeddings=8192), S),
    ("yarn", dict(scaling_type="yarn", scaling_factor=40.0, beta_fast=32.0,
                  beta_slow=1.0, mscale=1.0, mscale_all_dim=0.0,
                  original_max_position_embeddings=4096), S),
    ("mrope", dict(scaling_type="mrope", mrope_section=(2, 3, 3)), S),
]


def positions(kind, rng):
    """[B, S] positions offset as a TTT branch offsets them, or mrope's
    [3, B, S] over a vision span in one row and text in the other."""
    if kind != "mrope":
        return np.broadcast_to(np.arange(S, dtype=np.int32) + 2, (B, S)).copy()
    vision = jax_mrope_position_ids(S, [JaxVisionSpan(start=5, t=2, h=2, w=3)])
    text = jax_mrope_position_ids(S)
    return np.stack([vision, text], axis=1) + 2


@pytest.mark.parametrize("kind,fields,seq_len", ROPE_CASES,
                         ids=[c[0] for c in ROPE_CASES])
def test_rope_type_matches_jax(kind, fields, seq_len):
    spec = pt_rope.RopeSpec(head_dim=D, base=10000.0, **fields)
    spec_j = jax_rope.RopeSpec(head_dim=D, base=10000.0, **fields)
    inv, scale = pt_rope.inv_freq_and_scale(spec, seq_len + 2)
    inv_j, scale_j = jax_rope.inv_freq_and_scale(spec_j, seq_len + 2)
    assert inv.dtype == np.float32
    np.testing.assert_allclose(inv, inv_j, rtol=FREQ_RTOL)
    assert scale == pytest.approx(scale_j, rel=FREQ_RTOL)
    if kind == "yarn":
        assert scale != 1.0
    if kind == "dynamic_above":
        base = pt_rope.inv_freq_and_scale(pt_rope.RopeSpec(head_dim=D), S)[0]
        assert not np.allclose(inv, base)

    rng = np.random.default_rng(7)
    pos = positions(kind, rng)
    cos, sin = pt_rope.rope_cos_sin(spec, t(pos), seq_len + 2)
    cos_j, sin_j = jax_rope.rope_cos_sin(spec_j, jnp.asarray(pos), seq_len + 2)
    for got, ref in ((cos, cos_j), (sin, sin_j)):
        assert tuple(got.shape) == tuple(ref.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=TABLE_RTOL, atol=TABLE_ATOL)

    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(B, KVH, S, D)).astype(np.float32)
    if kind == "mrope":
        qt, kt = pt_rope.apply_multimodal_rope(t(q), t(k), cos, sin,
                                               spec.mrope_section)
        qj, kj = jax_rope.apply_multimodal_rope(
            jnp.asarray(q), jnp.asarray(k), cos_j, sin_j, spec_j.mrope_section)
    else:
        qt, kt = pt_rope.apply_rope(t(q), t(k), cos, sin)
        qj, kj = jax_rope.apply_rope(jnp.asarray(q), jnp.asarray(k), cos_j,
                                     sin_j)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=TABLE_RTOL,
                               atol=TABLE_ATOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=TABLE_RTOL,
                               atol=TABLE_ATOL)


def test_text_only_mrope_is_the_default_rope():
    """Positions shared by the three axes make mrope the default rope, for
    any sections that sum to D/2."""
    rng = np.random.default_rng(8)
    q = t(rng.normal(size=(B, H, S, D)).astype(np.float32))
    k = t(rng.normal(size=(B, KVH, S, D)).astype(np.float32))
    pos = torch.arange(S).expand(B, S) + 3
    spec = pt_rope.RopeSpec(head_dim=D, scaling_type="mrope",
                            mrope_section=(4, 2, 2))
    cos3, sin3 = pt_rope.rope_cos_sin(spec, pos.expand(3, B, S), S + 3)
    cos, sin = pt_rope.rope_cos_sin(pt_rope.RopeSpec(head_dim=D), pos, S + 3)
    got = pt_rope.apply_multimodal_rope(q, k, cos3, sin3, spec.mrope_section)
    ref = pt_rope.apply_rope(q, k, cos, sin)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------------
# chunked TTT branch attention
# --------------------------------------------------------------------------

CHUNK_S, CHUNK_D = 1024, 8


def chunked_case(n_branches, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, H, CHUNK_S, CHUNK_D)).astype(np.float32)
    keys = [rng.normal(size=(1, KVH, CHUNK_S, CHUNK_D)).astype(np.float32)
            for _ in range(n_branches + 1)]
    values = [rng.normal(size=(1, KVH, CHUNK_S, CHUNK_D)).astype(np.float32)
              for _ in range(n_branches + 1)]
    mask = np.ones((1, CHUNK_S), np.int32)
    mask[0, 1000:] = 0
    return q, keys, values, mask


@pytest.mark.parametrize("n_branches", [0, 2])
def test_chunked_attention_matches_jax(n_branches):
    """Forward and dq of the chunked path against JAX's chunked path and
    the port's dense path (rtol 2e-5 / atol 2e-6 forward, 5e-4 / 5e-6
    gradient, as the JAX test holds its chunked path to its dense one)."""
    q, keys, values, mask = chunked_case(n_branches)
    bias_j = jax_attention.make_causal_bias(jnp.asarray(mask), 1, CHUNK_S)
    kj = [jnp.asarray(k) for k in keys]
    vj = [jnp.asarray(v) for v in values]

    def jax_loss(qq):
        return jnp.sum(jax_attention.ttt_branch_attention_chunked(
            qq, kj, vj, bias_j) ** 2)

    out_j = jax_attention.ttt_branch_attention_chunked(
        jnp.asarray(q), kj, vj, bias_j)
    grad_j = jax.grad(jax_loss)(jnp.asarray(q))

    bias = pt_attention.make_causal_bias(t(mask), 1, CHUNK_S)
    kt = [t(k) for k in keys]
    vt = [t(v) for v in values]
    results = {}
    for name, fn in (("chunked", pt_attention.ttt_branch_attention_chunked),
                     ("dense", pt_attention.ttt_branch_attention_reference)):
        qt = t(q).requires_grad_(True)
        out = fn(qt, kt, vt, bias)
        (grad,) = torch.autograd.grad((out ** 2).sum(), qt)
        results[name] = (out.detach(), grad)
    for name, (out, grad) in results.items():
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=2e-5,
                                   atol=2e-6, err_msg=name)
        np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j),
                                   rtol=5e-4, atol=5e-6, err_msg=name)


@pytest.mark.parametrize("seq,chunked", [(1024, True), (2048, True),
                                         (768, False), (1088, False)])
def test_dense_backend_dispatch(monkeypatch, seq, chunked):
    """The ``"dense"`` backend goes chunked at S >= 1024 with S % 256 == 0,
    as JAX's ``ttt_branch_attention`` does."""
    calls = []
    for name in ("ttt_branch_attention_chunked",
                 "ttt_branch_attention_reference"):
        monkeypatch.setattr(pt_attention, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    q = torch.zeros(1, 2, seq, 4)
    pt_attention.ttt_branch_attention(q, [q[:, :1]], [q[:, :1]], None)
    want = ("ttt_branch_attention_chunked" if chunked
            else "ttt_branch_attention_reference")
    assert calls == [want]
    assert (seq >= jax_attention.CHUNKED_ATTENTION_MIN_SEQ
            and seq % 256 == 0) == chunked
