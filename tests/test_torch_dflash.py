"""The PyTorch port's DFlash family (DFlash and Domino; DSpark's own tests
are in test_torch_dspark.py, its train steps here) against the JAX
package, on the CPU.

Tiny shapes (vocab 64, hidden 32, 4 heads over 2 kv heads, S 24, blocks of
4, 4 anchors, 2 layers, as ``tests/test_dflash_family.py``) in fp32, with
numpy inputs from a seed handed to both sides. The JAX side runs as its own
tests run it: the Pallas kernels in interpret mode, the models through
``attention_backend="pallas_interpret"`` or ``"chunked"`` (the JAX tests hold
the two equal; the slower interpret mode is used where the model test is
about the kernel path). The port's models run its kernel path (the plain
versions, on CPU tensors) unless a test names the chunked one. Weights cross over
through ``params_from_jax``, and the port is handed the anchors the JAX
sampler drew (torch cannot replay ``jax.random``). On CPU tensors the port's
kernel wrappers take their plain versions. Each tolerance is the matching
JAX test's unless stated."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specforge_tpu.algorithms.common.dflash_family import (
    OnlineDFlashModel as JaxOnlineDFlashModel,
)
from specforge_tpu.algorithms.common.dflash_family import (
    OnlineDominoModel as JaxOnlineDominoModel,
)
from specforge_tpu.algorithms.common.dflash_family import (
    OnlineDSparkModel as JaxOnlineDSparkModel,
)
from specforge_tpu.algorithms.builtin import (
    builtin_algorithm_registry as jax_builtin_algorithm_registry,
)
from specforge_tpu.algorithms.contracts import FeatureMode as JaxFeatureMode
from specforge_tpu.algorithms.providers import (
    dflash_capture_layers as jax_dflash_capture_layers,
)
from specforge_tpu.models.draft.dflash import DFlashConfig as JaxDFlashConfig
from specforge_tpu.models.draft.dflash import DFlashDraftModel as JaxDFlashDraft
from specforge_tpu.models.draft.dflash import (
    build_target_layer_ids as jax_build_target_layer_ids,
)
from specforge_tpu.models.draft.domino import GRU as JaxGRU
from specforge_tpu.models.draft.domino import DominoDraftModel as JaxDominoDraft
from specforge_tpu.models.draft.dspark import DSparkDraftModel as JaxDSparkDraft
from specforge_tpu.ops import fused_objective as jax_fo
from specforge_tpu.ops import masks as jax_masks
from specforge_tpu.ops.attention import dflash_attention as jax_dflash_attention
from specforge_tpu.ops.attention import masked_attention as jax_masked_attention
from specforge_tpu.ops.chunking import (
    checkpointed_chunk_reduce as jax_chunk_reduce,
)
from specforge_tpu.ops.dflash_pallas import (
    dflash_flash_attention as jax_dflash_flash_attention,
)
from specforge_tpu.training import optimizer as jax_opt
from specforge_tpu.training.strategies import (
    DFlashTrainStrategy as JaxDFlashTrainStrategy,
)
from specforge_tpu.training.strategies import (
    DominoTrainStrategy as JaxDominoTrainStrategy,
)
from specforge_tpu.training.strategies import (
    DSparkTrainStrategy as JaxDSparkTrainStrategy,
)
from specforge_tpu.training.strategies import (
    linear_lambda_base as jax_linear_lambda_base,
)
from specforge_tpu.training.train_step import TrainState as JaxTrainState
from specforge_tpu.training.train_step import (
    make_train_step as jax_make_train_step,
)
from specforge_tpu_torch.algorithms.builtin import builtin_algorithm_registry
from specforge_tpu_torch.algorithms.common.dflash_family import (
    OnlineDFlashModel,
    OnlineDominoModel,
    OnlineDSparkModel,
)
from specforge_tpu_torch.algorithms.contracts import FeatureMode
from specforge_tpu_torch.algorithms.providers import dflash_capture_layers
from specforge_tpu_torch.convert import params_from_jax
from specforge_tpu_torch.models.draft.dflash import (
    DFlashConfig,
    DFlashDraftModel,
    build_target_layer_ids,
)
from specforge_tpu_torch.models.draft.domino import GRU, DominoDraftModel
from specforge_tpu_torch.models.draft.dspark import DSparkDraftModel
from specforge_tpu_torch.ops import dflash_attention_cuda as dac
from specforge_tpu_torch.ops import fused_objective as fo
from specforge_tpu_torch.ops import masks
from specforge_tpu_torch.ops.attention import dflash_attention, masked_attention
from specforge_tpu_torch.ops.chunking import checkpointed_chunk_reduce
from specforge_tpu_torch.training import optimizer as pt_opt
from specforge_tpu_torch.training.strategies import (
    DFlashTrainStrategy,
    DominoTrainStrategy,
    DSparkTrainStrategy,
    linear_lambda_base,
)
from specforge_tpu_torch.training.train_step import TrainState, make_train_step

V, H, S, BS, N_ANCHORS, LAYERS = 64, 32, 24, 4, 4, 2
MASK_TOKEN = V - 1
BASE_CFG = dict(
    vocab_size=V, hidden_size=H, intermediate_size=64,
    num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=LAYERS,
    num_target_layers=8, block_size=BS, mask_token_id=MASK_TOKEN,
    max_position_embeddings=128,
)
DOMINO_CFG = dict(projector_type="domino", emb_dim=16, gru_hidden_dim=16,
                  pure_draft_prefix_len=1)
DSPARK_CFG = dict(projector_type="dspark", markov_rank=8,
                  markov_head_type="gated", enable_confidence_head=True)
#: kind → (JAX draft, JAX wrapper, JAX strategy, draft, wrapper, strategy)
FAMILY = {
    "dflash": (JaxDFlashDraft, JaxOnlineDFlashModel, JaxDFlashTrainStrategy,
               DFlashDraftModel, OnlineDFlashModel, DFlashTrainStrategy),
    "domino": (JaxDominoDraft, JaxOnlineDominoModel, JaxDominoTrainStrategy,
               DominoDraftModel, OnlineDominoModel, DominoTrainStrategy),
    "dspark": (JaxDSparkDraft, JaxOnlineDSparkModel, JaxDSparkTrainStrategy,
               DSparkDraftModel, OnlineDSparkModel, DSparkTrainStrategy),
}
ATTN_FWD = dict(rtol=2e-5, atol=2e-6)    # test_dflash_family.py:126-129
ATTN_GRAD = dict(rtol=3e-5, atol=3e-6)   # test_dflash_family.py:143-146
MODEL_GRAD = dict(rtol=5e-4, atol=1e-5)  # test_dflash_family.py:179-180
LOSS_RTOL = 1e-5
REPO = os.path.join(os.path.dirname(__file__), "..")
STEP_RTOL = 1e-5                         # as tests/test_torch_train.py


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per test worker (see test_torch_train.py's
    fixture of the same name: the default oversubscribes a shared CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), **tol)


# --------------------------------------------------------------------------
# anchors and masks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("num_anchors", [8, 40])
def test_anchor_sampling_properties(num_anchors):
    """As test_dflash_masks.py:89, plus the JAX contract of the slots not
    kept (a sorted prefix is kept, the rest hold 0), also with more slots
    than candidates."""
    rng = np.random.default_rng(1)
    loss_mask = (rng.random((3, 32)) > 0.4).astype(np.int32)
    loss_mask[2] = 0
    loss_mask[2, 5:8] = 1  # two candidates only
    gen = torch.Generator().manual_seed(0)
    anchors, keep = masks.sample_anchor_positions(gen, t(loss_mask),
                                                  num_anchors)
    assert anchors.dtype == torch.int32 and keep.dtype == torch.bool
    anchors, keep = anchors.numpy(), keep.numpy()
    assert anchors.shape == keep.shape == (3, num_anchors)
    for bi in range(3):
        n_valid = int(((loss_mask[bi, :-1] > 0) & (loss_mask[bi, 1:] > 0))
                      .sum())
        n_kept = min(n_valid, num_anchors)
        assert keep[bi].tolist() == [True] * n_kept + [False] * (
            num_anchors - n_kept)
        kept = anchors[bi][keep[bi]]
        assert (np.sort(kept) == kept).all()
        assert len(set(kept.tolist())) == len(kept)
        for a in kept:
            assert loss_mask[bi, a] and loss_mask[bi, a + 1]
        assert (anchors[bi][~keep[bi]] == 0).all()
    again, _ = masks.sample_anchor_positions(
        torch.Generator().manual_seed(0), t(loss_mask), num_anchors)
    np.testing.assert_array_equal(anchors, again.numpy())


def _anchor_inputs(seed=0, b=2, n=N_ANCHORS, s=S):
    rng = np.random.default_rng(seed)
    anchors = np.sort(rng.integers(1, s - 1, size=(b, n)), axis=1).astype(
        np.int32)
    anchors[0, 0] = 0
    keep = np.ones((b, n), bool)
    keep[1, -1] = False
    return anchors, keep


@pytest.mark.parametrize("sliding", [None, 5])
def test_dense_and_chunk_masks_match_jax(sliding):
    anchors, keep = _anchor_inputs()
    dense = masks.dflash_dense_mask(t(anchors), t(keep), S, BS, sliding)
    ref = jax_masks.dflash_dense_mask(jnp.asarray(anchors), jnp.asarray(keep),
                                      S, BS, sliding)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(ref))
    chunk = masks.dflash_chunk_mask(t(anchors[:, 2:]), t(keep[:, 2:]), S, BS,
                                    sliding)
    ref = jax_masks.dflash_chunk_mask(jnp.asarray(anchors[:, 2:]),
                                      jnp.asarray(keep[:, 2:]), S, BS, sliding)
    np.testing.assert_array_equal(chunk.numpy(), np.asarray(ref))


# --------------------------------------------------------------------------
# attention: the chunked path and the kernels' plain versions
# --------------------------------------------------------------------------

def _attention_inputs(s, d=8, seed=2, bs=BS):
    rng = np.random.default_rng(seed)
    b, h, kvh, n = 2, 4, 2, 4
    q_len = n * bs

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    tensors = (arr(b, h, q_len, d), arr(b, kvh, s, d), arr(b, kvh, s, d),
               arr(b, kvh, q_len, d), arr(b, kvh, q_len, d))
    anchors, keep = _anchor_inputs(seed, b, n, s)
    cotangent = arr(b, q_len, h * d)
    return tensors, anchors, keep, cotangent


def _port_value_and_grads(fn, tensors, cotangent):
    ts = [torch.tensor(x, requires_grad=True) for x in tensors]
    out = fn(*ts)
    (out * t(cotangent)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in ts]


def _jax_value_and_grads(fn, tensors, cotangent):
    args = [jnp.asarray(x) for x in tensors]
    out = fn(*args)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * cotangent),
                     argnums=(0, 1, 2, 3, 4))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("sliding", [None, 5])
def test_chunked_attention_matches_jax(sliding):
    tensors, anchors, keep, ct = _attention_inputs(S)
    out, grads = _port_value_and_grads(
        lambda *x: dflash_attention(*x, t(anchors), t(keep), BS,
                                    chunk_blocks=2, sliding_window=sliding),
        tensors, ct)
    ref, ref_grads = _jax_value_and_grads(
        lambda *x: jax_dflash_attention(
            *x, jnp.asarray(anchors), jnp.asarray(keep), BS, chunk_blocks=2,
            sliding_window=sliding),
        tensors, ct)
    close(out, ref, **ATTN_FWD)
    for name, g, r in zip("q kc vc kd vd".split(), grads, ref_grads):
        close(g, r, err_msg=name, **ATTN_GRAD)


@pytest.mark.parametrize("sliding,s,bs", [
    pytest.param(None, 24, BS, id="None-24"),
    pytest.param(5, 24, BS, id="5-24"),
    pytest.param(None, 21, BS, id="None-21"),
    pytest.param(5, 21, BS, id="5-21"),
    # block sizes that are no power of two (DSpark's 7): the kernels' pitch
    pytest.param(None, 24, 7, id="None-24-bs7"),
    pytest.param(5, 21, 5, id="5-21-bs5"),
])
def test_plain_kernel_versions_match_pallas_interpret(sliding, s, bs):
    """The plain forward and backward of the three kernels against the JAX
    Pallas kernels in interpret mode: the output and all five gradients,
    with a block that is not kept, an anchor at 0, GQA, (S=21) a context
    that is no multiple of the tile and blocks of 7 and 5 rows."""
    tensors, anchors, keep, ct = _attention_inputs(s, bs=bs)
    out, grads = _port_value_and_grads(
        lambda *x: dac.dflash_flash_attention(*x, t(anchors), t(keep), bs,
                                              sliding),
        tensors, ct)
    ref, ref_grads = _jax_value_and_grads(
        lambda *x: jax_dflash_flash_attention(
            *x, jnp.asarray(anchors), jnp.asarray(keep), bs,
            sliding_window=sliding, tq=8, tk=8, interpret=True),
        tensors, ct)
    close(out, ref, **ATTN_FWD)
    # the rows of the block not kept are exactly 0, as are its gradients
    q_rows = slice((N_ANCHORS - 1) * bs, N_ANCHORS * bs)
    assert not out[1, q_rows].any() and not grads[0][1, :, q_rows].any()
    for name, g, r in zip("q kc vc kd vd".split(), grads, ref_grads):
        close(g, r, err_msg=name, **ATTN_GRAD)


def test_plain_statistics_and_backward_function():
    """The plain forward's (m, l) against a dense softmax, and the plain
    backward called directly equal to autograd through the Function."""
    tensors, anchors, keep, ct = _attention_inputs(S)
    ts = [t(x) for x in tensors]
    out, m, l = dac.dflash_flash_attention_plain(*ts, t(anchors), t(keep), BS)
    allow = masks.dflash_dense_mask(t(anchors), t(keep), S, BS)[:, 0]
    q, kc, _, kd, _ = ts
    k_all = torch.cat([kc, kd], dim=2).repeat_interleave(2, dim=1)
    w = torch.einsum("bhqd,bhkd->bhqk", q, k_all) / 8 ** 0.5
    w = torch.where(allow[:, None], w, torch.full_like(w, -1e30))
    ref_m = w.amax(-1)
    ref_l = torch.where(allow[:, None], torch.exp(w - ref_m[..., None]),
                        0.0).sum(-1)
    torch.testing.assert_close(m, ref_m)
    torch.testing.assert_close(l, ref_l)
    assert (l[1, :, -BS:] == 0).all() and (m[1, :, -BS:] == -1e30).all()
    direct = dac.dflash_flash_attention_backward_plain(
        *ts, t(anchors), t(keep), BS, None, out, m, l, t(ct))
    _, grads = _port_value_and_grads(
        lambda *x: dac.dflash_flash_attention(*x, t(anchors), t(keep), BS),
        tensors, ct)
    for d, g in zip(direct, grads):
        np.testing.assert_array_equal(d.numpy(), g)


def test_cpu_wrappers_launch_nothing_and_kernel_checks_refuse():
    """CPU tensors take the plain versions (no launch is counted); what the
    kernels do not take is refused by the checks the CUDA path runs."""
    tensors, anchors, keep, _ = _attention_inputs(S)
    counters = (dac.dflash_flash_attention_fwd, dac.dflash_attention_bwd_dq,
                dac.dflash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    ts = [torch.tensor(x, requires_grad=True) for x in tensors]
    dac.dflash_flash_attention(*ts, t(anchors), t(keep), BS).sum().backward()
    assert [c.launches for c in counters] == before

    def check(d=8, bs=BS, dtype=torch.bfloat16, n=N_ANCHORS):
        b, h, kvh = 2, 4, 2
        q = torch.zeros(b, h, n * bs, d, dtype=dtype)
        kc = torch.zeros(b, kvh, S, d, dtype=dtype)
        kd = torch.zeros(b, kvh, n * bs, d, dtype=dtype)
        return dac._check_inputs(q, kc, kc, kd, kd,
                                 torch.zeros(b, n, dtype=torch.int32),
                                 torch.ones(b, n, dtype=torch.bool), bs, None)

    with pytest.raises(ValueError, match="head dim"):
        check(d=32)
    for bs in (0, 65):
        with pytest.raises(ValueError, match="block_size"):
            check(d=64, bs=bs)
    with pytest.raises(TypeError, match="bfloat16"):
        check(d=64, dtype=torch.float32)
    tensors, a32, k32, window = check(d=64)
    _, strides = dac._pointers(tensors)
    assert a32.dtype == k32.dtype == torch.int32 and window == 0
    assert list(strides)[:3] == [4 * 16 * 64, 16 * 64, 64]
    # blocks of 7 (up to 64) are taken at a pitch of 8: q and the draft
    # keys and values are copied into it with zero padding rows
    tensors, _, _, _ = check(d=64, bs=7)
    assert [tuple(x.shape[2:]) for x in tensors] == [
        (4 * 8, 64), (S, 64), (S, 64), (4 * 8, 64), (4 * 8, 64)]
    assert [dac.block_pitch(bs) for bs in (1, 5, 7, 8, 12, 48, 64)] == [
        1, 8, 8, 8, 16, 64, 64]


def test_masked_attention_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 4, 6, 8)).astype(np.float32)
    k = rng.normal(size=(2, 2, 9, 8)).astype(np.float32)
    v = rng.normal(size=(2, 2, 9, 8)).astype(np.float32)
    bias = np.where(rng.random((2, 1, 6, 9)) > 0.3, 0.0, -1e38).astype(
        np.float32)
    out = masked_attention(t(q), t(k), t(v), t(bias))
    ref = jax_masked_attention(*map(jnp.asarray, (q, k, v, bias)))
    close(out.numpy(), ref, **ATTN_FWD)


# --------------------------------------------------------------------------
# fused objectives, chunk reduction, GRU
# --------------------------------------------------------------------------

def _objective_inputs(seed=4, b=2, n=4, k=BS, h=H, e=16):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(b, n, k, h)).astype(np.float32)
    targets = rng.integers(0, V, size=(b, n, k)).astype(np.int32)
    wm = (rng.random((b, n, k)) > 0.25).astype(np.float32)
    wm[:, :, 0] = 0
    head = (rng.normal(size=(V, h)) * 0.3).astype(np.float32)
    act = rng.normal(size=(b, n, k, e)).astype(np.float32)
    p1 = (rng.normal(size=(e, V)) * 0.3).astype(np.float32)
    return hidden, targets, wm, head, act, p1


@pytest.mark.parametrize("loss_type", [
    "dflash", "dpace", "dpace-cumulative-confidence-only",
    "dpace-continuation-value-only",
])
def test_fused_dflash_objective_matches_jax(loss_type):
    hidden, targets, wm, head, _, _ = _objective_inputs()
    lw = wm * np.exp(-np.maximum(np.arange(BS) - 1, 0) / 3.0).astype(
        np.float32)
    opts = jax_fo._DFlashOpts(loss_type=loss_type, dpace_alpha=0.3,
                              chunk_blocks=2)

    def jax_fn(x):
        return jax_fo.dflash_objective_fused(
            x, jnp.asarray(targets), jnp.asarray(lw), jnp.asarray(wm),
            jnp.asarray(head), opts)

    ref = jax_fn(jnp.asarray(hidden))
    ref_grad = jax.grad(lambda x: jax_fn(x)[0])(jnp.asarray(hidden))
    x = torch.tensor(hidden, requires_grad=True)
    terms = fo.dflash_objective_fused(x, t(targets), t(lw), t(wm), t(head),
                                      loss_type, 0.3, 2)
    terms[0].backward()
    for name, a, r in zip(("loss_num", "loss_den", "correct", "acc_den"),
                          terms, ref):
        close(float(a.detach()), float(r), rtol=LOSS_RTOL, atol=1e-7, err_msg=name)
    close(x.grad.numpy(), ref_grad, **MODEL_GRAD)


@pytest.mark.parametrize("lam", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("shift_label", [True, False])
def test_fused_domino_objective_matches_jax(shift_label, lam):
    """All ten terms and the three input gradients; the correction's zero
    prefix (suffix_start) and the eval mask follow shift_label."""
    hidden, targets, wm, head, act, p1 = _objective_inputs()
    start = 1 if shift_label else 2
    act[:, :, :start] = 0
    ewm = wm.copy()
    wm = wm * np.exp(-np.arange(BS) / 4.0).astype(np.float32)

    def jax_fn(x, a, p):
        return jax_fo.domino_objective_fused(
            x, a, p, jnp.asarray(targets), jnp.asarray(wm), jnp.asarray(ewm),
            jnp.asarray(lam, jnp.float32), jnp.asarray(head),
            jax_fo._DominoOpts(chunk_blocks=2))

    args = (jnp.asarray(hidden), jnp.asarray(act), jnp.asarray(p1))
    ref = jax_fn(*args)
    ref_grads = jax.grad(lambda *a: jax_fn(*a)[0], argnums=(0, 1, 2))(*args)
    xs = [torch.tensor(hidden, requires_grad=True),
          torch.tensor(act, requires_grad=True),
          torch.tensor(p1.T.copy(), requires_grad=True)]
    terms = fo.domino_objective_fused(xs[0], xs[1], xs[2], t(targets), t(wm),
                                      t(ewm), lam, t(head), 2)
    terms[0].backward()
    for i, (a, r) in enumerate(zip(terms, ref)):
        close(float(a.detach()), float(r), rtol=LOSS_RTOL, atol=1e-6,
              err_msg=f"term {i}")
    for name, g, r in zip(("hidden", "act", "p1"),
                          [x.grad.numpy() for x in xs],
                          [np.asarray(ref_grads[0]), np.asarray(ref_grads[1]),
                           np.asarray(ref_grads[2]).T]):
        close(g, r, err_msg=name, **MODEL_GRAD)


def test_checkpointed_chunk_reduce_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 4)).astype(np.float32)
    w = rng.random((2, 8, 4)).astype(np.float32)

    def jfn(xc, wc):
        return jnp.sum(xc * wc), jnp.sum(wc), jnp.sum(xc * xc * wc, axis=(0, 1))

    def pfn(xc, wc):
        return (xc * wc).sum(), wc.sum(), (xc * xc * wc).sum(dim=(0, 1))

    xt = torch.tensor(x, requires_grad=True)
    got = checkpointed_chunk_reduce(pfn, xt, t(w), chunk_size=2, axis=1)
    ref = jax_chunk_reduce(jfn, jnp.asarray(x), jnp.asarray(w), chunk_size=2,
                           axis=1)
    for a, r in zip(got, ref):
        close(a.detach().numpy(), r, rtol=1e-5)
    got[0].backward()
    ref_grad = jax.grad(lambda a: jax_chunk_reduce(
        jfn, a, jnp.asarray(w), chunk_size=2, axis=1)[0])(jnp.asarray(x))
    close(xt.grad.numpy(), ref_grad, rtol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        checkpointed_chunk_reduce(pfn, xt, t(w), chunk_size=3, axis=1)


def test_gru_matches_jax():
    rng = np.random.default_rng(0)
    hidden_dim, in_dim, b, steps = 8, 6, 3, 5
    gru = JaxGRU(hidden_dim, dtype=jnp.float32)
    xs = rng.normal(size=(b, steps, in_dim)).astype(np.float32)
    params = gru.init(jax.random.PRNGKey(0), jnp.asarray(xs))
    ref = gru.apply(params, jnp.asarray(xs))
    port = GRU(in_dim, hidden_dim, torch.float32)
    port.load_state_dict({k: t(v) for k, v in params["params"].items()})
    close(port(t(xs)).detach().numpy(), ref, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

def test_config_and_capture_layers_match_jax():
    raw = json.load(open(os.path.join(REPO, "configs",
                                "qwen3.6-27b-dflash.json")))
    port, ref = DFlashConfig.from_dict(raw), JaxDFlashConfig.from_dict(raw)
    for name in ("layer_types", "sliding_window", "mask_token_id",
                 "target_layer_ids", "block_size", "resolved_head_dim"):
        assert getattr(port, name) == getattr(ref, name), name
    assert dflash_capture_layers(port, 64) == jax_dflash_capture_layers(ref, 64)
    assert dflash_capture_layers(port, 64, (3, 4)) == (3, 4)
    for layers in (1, 3, 5):
        assert build_target_layer_ids(36, layers) == (
            jax_build_target_layer_ids(36, layers))
    for bad in ({"layer_types": ["full_attention"]},
                {"layer_types": ["sliding_attention"] * 2,
                 "sliding_window": None},
                {"layer_types": ["global"] * 2}):
        with pytest.raises(ValueError):
            DFlashConfig.from_dict({**BASE_CFG, **bad})


def test_registry_has_the_family_and_resolves_dspark():
    """Every algorithm of the JAX package resolves; DSpark's feature
    contract adds the target's last hidden state (its schema's
    last_hidden_feature), as the JAX registration does."""
    registry = builtin_algorithm_registry()
    assert registry.names == jax_builtin_algorithm_registry().names
    for name in ("dflash", "domino", "dspark"):
        reg = registry.resolve(name)
        ref = jax_builtin_algorithm_registry().resolve(name)
        assert reg.providers.frozen_requirements == {
            "target_head_weight", "target_embed_weight"}
        assert (dataclasses.asdict(reg.spec.offline_schema)
                == dataclasses.asdict(ref.spec.offline_schema))
        for mode in (FeatureMode.OFFLINE, FeatureMode.STREAMING):
            assert (reg.spec.contract_for(mode).required_features
                    == ref.spec.contract_for(JaxFeatureMode(mode.value))
                    .required_features)
    schema = registry.resolve("dspark").spec.offline_schema
    assert schema.aux_feature == "hidden_states"
    assert schema.last_hidden_feature == "target_last_hidden_states"
    with pytest.raises(KeyError, match="unknown algorithm"):
        registry.resolve("medusa")


# --------------------------------------------------------------------------
# models against JAX
# --------------------------------------------------------------------------

def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    n_capture = len(jax_build_target_layer_ids(8, LAYERS))
    tensors = {
        "input_ids": rng.integers(0, V - 1, size=(2, S)).astype(np.int32),
        "hidden_states": rng.normal(size=(2, S, n_capture * H)).astype(
            np.float32),
        "loss_mask": (rng.random((2, S)) > 0.2).astype(np.int32),
    }
    frozen = {
        "target_head_weight": (rng.normal(size=(V, H)) * 0.3).astype(
            np.float32),
        "target_embed_weight": (rng.normal(size=(V, H)) * 0.3).astype(
            np.float32),
    }
    return tensors, frozen


def _jax_model(kind, backend, extra, **kwargs):
    cfg = JaxDFlashConfig.from_dict({**BASE_CFG, **extra})
    draft_cls, wrapper = FAMILY[kind][:2]
    draft = draft_cls(cfg, dtype=jnp.float32, attn_chunk_blocks=2,
                      attention_backend=backend)
    return wrapper(draft_model=draft, mask_token_id=MASK_TOKEN, block_size=BS,
                   num_anchors=N_ANCHORS, objective_chunk_blocks=2, **kwargs)


def _port_model(kind, backend, extra, **kwargs):
    cfg = DFlashConfig.from_dict({**BASE_CFG, **extra})
    draft_cls, wrapper = FAMILY[kind][3:5]
    draft = draft_cls(cfg, dtype=torch.float32, attention_backend=backend,
                      attn_chunk_blocks=2, device="cpu")
    return wrapper(draft, MASK_TOKEN, block_size=BS, num_anchors=N_ANCHORS,
                   objective_chunk_blocks=2, **kwargs)


def _jax_init(kind, extra, kwargs, args):
    """The JAX model's variables, initialised through the chunked backend
    (the same parameter tree; the interpret-mode kernels are slow to run
    eagerly)."""
    return _jax_model(kind, "chunked", extra, **kwargs).init(
        jax.random.PRNGKey(1), *args)


def _jax_anchors(rng_key, loss_mask):
    positions, keep = jax_masks.sample_anchor_positions(
        rng_key, jnp.asarray(loss_mask), N_ANCHORS)
    return t(positions), t(keep)


def _compare_model(kind, jax_backend, port_backend, extra, lam=None,
                   **kwargs):
    tensors, frozen = _inputs()
    jmodel = _jax_model(kind, jax_backend, extra, **kwargs)
    rng_key = jax.random.PRNGKey(3)
    args = [jnp.asarray(tensors[k]) for k in
            ("input_ids", "hidden_states", "loss_mask")]
    args += [jnp.asarray(frozen["target_head_weight"]),
             jnp.asarray(frozen["target_embed_weight"]), rng_key]
    if lam is not None:
        args.append(jnp.asarray(lam, jnp.float32))
    variables = _jax_init(kind, extra, kwargs, args)

    def run(params):
        loss, acc, metrics = jmodel.apply({"params": params}, *args)
        return loss, (acc, metrics)

    (jloss, (jacc, jmetrics)), jgrads = jax.jit(jax.value_and_grad(
        run, has_aux=True))(variables["params"])

    model = _port_model(kind, port_backend, extra, **kwargs)
    model.load_state_dict(params_from_jax(jax.device_get(variables)))
    pargs = [t(tensors[k]) for k in ("input_ids", "hidden_states",
                                     "loss_mask")]
    pargs += [t(frozen["target_head_weight"]),
              t(frozen["target_embed_weight"]), None]
    if lam is not None:
        pargs.append(lam)
    loss, acc, metrics = model(
        *pargs, anchors=_jax_anchors(rng_key, tensors["loss_mask"]))
    loss.backward()
    close(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    close(float(acc), float(jacc), rtol=1e-6)
    ref = params_from_jax(jax.device_get({"params": jgrads}))
    grads = dict(model.named_parameters())
    assert set(grads) == set(ref)
    for name, p in grads.items():
        close(p.grad.numpy(), ref[name].numpy(), err_msg=name, **MODEL_GRAD)
    return metrics, jmetrics


@pytest.mark.parametrize("port_backend,jax_backend,fused", [
    ("pallas", "pallas_interpret", True), ("chunked", "chunked", True),
    ("pallas", "chunked", False), ("chunked", "chunked", False)])
def test_dflash_model_matches_jax(port_backend, jax_backend, fused):
    metrics, jmetrics = _compare_model(
        "dflash", jax_backend, port_backend, {}, loss_decay_gamma=3.0,
        fused_objective=fused)
    for a, r in zip(metrics["loss_terms"], jmetrics["loss_terms"]):
        close(float(a.detach()), float(r), rtol=LOSS_RTOL)


@pytest.mark.parametrize("loss_type", ["dpace", "dpace-continuation-value-only"])
def test_dflash_dpace_model_matches_jax(loss_type):
    metrics, jmetrics = _compare_model(
        "dflash", "chunked", "pallas", {}, loss_type=loss_type)
    assert float(metrics["loss_terms"][1]) == 2.0  # normalised by batch size


def test_dflash_sliding_window_model_matches_jax():
    extra = dict(layer_types=["sliding_attention", "full_attention"],
                 sliding_window=5)
    _compare_model("dflash", "chunked", "pallas", extra)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("shift_label", [True, False])
def test_domino_model_matches_jax(shift_label, fused):
    extra = {**DOMINO_CFG, "shift_label": shift_label}
    metrics, jmetrics = _compare_model(
        "domino", "chunked", "pallas", extra, lam=0.3,
        shift_label=shift_label, loss_decay_gamma=4.0, fused_objective=fused)
    for key in ("final_loss", "base_loss", "base_accuracy", "accept_len",
                "base_accept_len", "lambda_base"):
        close(float(metrics[key]), float(jmetrics[key]), rtol=LOSS_RTOL,
              atol=1e-7, err_msg=key)


# --------------------------------------------------------------------------
# train steps against JAX (loss_terms, lambda_base)
# --------------------------------------------------------------------------

def test_linear_lambda_base_matches_jax():
    for step in range(12):
        assert linear_lambda_base(step, 10, 0.7, 0.5) == float(
            jax_linear_lambda_base(jnp.asarray(step, jnp.int32), 10, 0.7, 0.5))


@pytest.mark.parametrize("kind", ["dflash", "domino", "dspark"])
def test_train_steps_match_jax(kind):
    """Two optimizer steps of 2 micro-batches: the loss (for DFlash the
    ``loss_terms`` numerator over the window's summed denominator), the
    grad norm, every updated parameter, (Domino) the decaying lambda_base
    and (DSpark, whose batches carry the target's last hidden state) its
    nine ratio metrics."""
    extra = {"domino": DOMINO_CFG, "dspark": DSPARK_CFG}.get(kind, {})
    accum, total = 2, 10
    rng = np.random.default_rng(5)
    tensors, frozen = _inputs()
    batches = []
    for _ in range(2):
        batches.append({
            "input_ids": rng.integers(0, V - 1, size=(accum, 2, S)).astype(
                np.int32),
            "hidden_states": rng.normal(
                size=(accum, 2, S, tensors["hidden_states"].shape[-1])
            ).astype(np.float32),
            "loss_mask": (rng.random((accum, 2, S)) > 0.2).astype(np.int32),
        })
        if kind == "dspark":
            batches[-1]["target_last_hidden_states"] = rng.normal(
                size=(accum, 2, S, H)).astype(np.float32)
    opt_kw = dict(lr=1e-3, warmup_ratio=0.0, adam_eps=1e-3)
    strategy_kw = {"seed": 7}
    if kind == "domino":
        strategy_kw.update(lambda_start=0.7, decay_ratio=0.5)

    jmodel = _jax_model(kind, "chunked", extra)
    init_args = [jnp.asarray(batches[0][k][0]) for k in
                 ("input_ids", "hidden_states", "loss_mask")]
    init_args += [jnp.asarray(frozen["target_head_weight"]),
                  jnp.asarray(frozen["target_embed_weight"]),
                  jax.random.PRNGKey(0)]
    if kind == "dspark":
        init_args.append(
            jnp.asarray(batches[0]["target_last_hidden_states"][0]))
    variables = jax.device_get(_jax_init(kind, extra, {}, init_args))
    jstrategy = FAMILY[kind][2](jmodel, **strategy_kw)
    tx = jax_opt.build_optimizer(jax_opt.OptimizerConfig(**opt_kw), total)
    jstate = JaxTrainState.create(variables["params"], {}, tx)
    jstep = jax_make_train_step(
        jstrategy, tx, accum_steps=accum, total_steps=total,
        lr_schedule=jax_opt.build_lr_schedule(
            jax_opt.OptimizerConfig(**opt_kw), total))
    jfrozen = {k: jnp.asarray(v) for k, v in frozen.items()}

    model = _port_model(kind, "pallas", extra)
    model.load_state_dict(params_from_jax(variables))
    strategy = FAMILY[kind][5](model, **strategy_kw)
    # the anchors JAX draws for this step: fold_in(PRNGKey(seed), step)
    strategy.sample_anchors = lambda loss_mask, ctx: _jax_anchors(
        jax.random.fold_in(jax.random.PRNGKey(7), ctx.global_step),
        loss_mask.numpy())
    opt = pt_opt.build_optimizer(pt_opt.OptimizerConfig(**opt_kw), total)
    state = TrainState.create(model, opt)
    step = make_train_step(
        strategy, opt, accum_steps=accum, total_steps=total,
        lr_schedule=pt_opt.build_lr_schedule(pt_opt.OptimizerConfig(**opt_kw),
                                             total))
    pfrozen = {k: t(v) for k, v in frozen.items()}
    keys = ["train/loss", "train/grad_norm", "train/lr", "train/accuracy"]
    keys += {
        "dflash": ["train/acc"],
        "domino": ["train/lambda_base", "train/final_loss",
                   "train/accept_len"],
        "dspark": [f"train/{k}" for k in (
            "acc", "ce_loss", "l1_loss", "confidence_loss",
            "confidence_abs_error", "teacher_agreement", "teacher_top1_prob",
            "draft_top1_prob", "tau_probabilistic")],
    }[kind]
    for batch in batches:
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()}, jfrozen)
        state, metrics = step(state, {k: t(v) for k, v in batch.items()},
                              pfrozen)
        for key in keys:
            close(float(metrics[key]), float(jmetrics[key]), rtol=STEP_RTOL,
                  err_msg=key)
    if kind == "domino":
        assert float(metrics["train/lambda_base"]) == pytest.approx(
            0.7 * (1 - 1 / 5))
    updated = params_from_jax(jax.device_get({"params": jstate.params}))
    assert state.step == 2 and set(state.params) == set(updated)
    for name, p in state.params.items():
        close(p.detach().numpy(), updated[name].numpy(), rtol=STEP_RTOL,
              atol=1e-7, err_msg=name)
