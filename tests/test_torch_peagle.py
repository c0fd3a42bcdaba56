"""The PyTorch port's P-EAGLE (COD) training path against the JAX package,
on the CPU.

Tiny shapes (vocab 2048, draft vocab 256, hidden 64 over 4 heads of 16 and 2
kv heads, 2 layers, S 48, 3 depths) in fp32, with numpy inputs from a seed
handed to both sides. The JAX side runs as its own tests run it: the Pallas
COD kernel in interpret mode, the models through the dense backend (which
``tests/test_peagle.py`` holds equal to the kernel path). Weights cross over
through ``params_from_jax``, and the port is handed the sample the JAX
sampler drew (torch cannot replay ``jax.random``). On CPU tensors the port's
kernel wrappers take their plain versions. Each tolerance is the matching
JAX test's unless stated."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from specforge_tpu.algorithms.peagle import model as jax_peagle
from specforge_tpu.data.collator import PackingCollator as JaxPackingCollator
from specforge_tpu.data.collator import (
    PackingCollatorConfig as JaxPackingCollatorConfig,
)
from specforge_tpu.models.draft import peagle as jax_peagle_draft
from specforge_tpu.ops import peagle_pallas as jax_cod
from specforge_tpu.training import optimizer as jax_opt
from specforge_tpu.training.strategies import (
    PEagleTrainStrategy as JaxPEagleTrainStrategy,
)
from specforge_tpu.training.train_step import SparseEmbedPlan as JaxSparsePlan
from specforge_tpu.training.train_step import TrainState as JaxTrainState
from specforge_tpu.training.train_step import (
    make_train_step as jax_make_train_step,
)
from specforge_tpu_torch.algorithms.builtin import builtin_algorithm_registry
from specforge_tpu_torch.algorithms.peagle.model import (
    CODSample,
    OnlinePEagleModel,
    cod_sort_key,
    doc_major,
    document_ids_from_lengths,
    generate_cod_sample_indices,
    peagle_allow_mask,
)
from specforge_tpu_torch.convert import params_from_jax
from specforge_tpu_torch.data.collator import (
    PackingCollator,
    PackingCollatorConfig,
)
from specforge_tpu_torch.models.draft.peagle import (
    PEagleConfig,
    PEagleDraftModel,
    cod_capacities,
)
from specforge_tpu_torch.ops import peagle_attention_cuda as pac
from specforge_tpu_torch.training import optimizer as pt_opt
from specforge_tpu_torch.training.strategies import PEagleTrainStrategy
from specforge_tpu_torch.training.train_step import (
    SparseEmbedPlan,
    TrainState,
    make_train_step,
)

V, VD, H, S, DEPTHS = 2048, 256, 64, 48, 3
RATIO, RATIO_MIN = 0.7, 0.2
MASK_TOKEN = V - 1
CFG = dict(vocab_size=V, draft_vocab_size=VD, hidden_size=H,
           intermediate_size=128, num_attention_heads=4,
           num_key_value_heads=2, head_dim=16, num_hidden_layers=2,
           max_position_embeddings=256)
#: row 0 packs two documents; row 1 holds one with a padded tail
LENGTHS = np.array([[30, 18], [40, 0]], np.int32)
ATTN_FWD = dict(rtol=2e-5, atol=2e-6)    # test_peagle.py:221-222
ATTN_GRAD = dict(rtol=3e-5, atol=3e-6)   # test_peagle.py:232-233
MODEL_GRAD = dict(rtol=5e-4, atol=1e-5)  # test_peagle.py:269-271
LOSS_RTOL = 1e-5
OPT_TOL = dict(rtol=1e-5, atol=1e-7)
SPARSE_TOL = dict(rtol=2e-5, atol=1e-7)  # test_sparse_embed.py:136-137
STEP_RTOL = 1e-4


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


def _jax_doc_ids(lengths, s):
    return jax.vmap(jax_peagle.document_ids_from_lengths, in_axes=(0, None))(
        jnp.asarray(lengths, jnp.int32), s)


def _jax_sample(rng, loss_mask, lengths, s=S, ratio=RATIO,
                ratio_min=RATIO_MIN) -> CODSample:
    """The depth-major sample OnlinePEagleModel draws for ``rng`` (one key
    split per row), as torch tensors."""
    loss_mask = jnp.asarray(loss_mask).reshape(len(lengths), s)
    sample = _jax_sampler(ratio, ratio_min)(
        jax.random.split(rng, len(lengths)), loss_mask,
        _jax_doc_ids(lengths, s))
    return CODSample(*(t(x) for x in sample))


@functools.lru_cache(maxsize=None)
def _jax_sampler(ratio, ratio_min):
    return jax.jit(jax.vmap(
        lambda r, lm, di: jax_peagle.generate_cod_sample_indices(
            r, lm, di, DEPTHS, ratio, ratio_min)))


def _loss_mask(rng, b=2, s=S):
    mask = (rng.random((b, s)) > 0.2).astype(np.int32)
    mask[1, 40:] = 0  # the padded tail
    return mask


# --------------------------------------------------------------------------
# documents, capacities, predicate, sampler, sort key
# --------------------------------------------------------------------------

def test_document_ids_capacities_and_predicate_match_jax():
    """Exact: document ids of packed and padded rows, the per-depth
    capacities, and the dense COD predicate of a JAX sample."""
    np.testing.assert_array_equal(
        document_ids_from_lengths(t(LENGTHS), S).numpy(),
        np.asarray(_jax_doc_ids(LENGTHS, S)))
    for args in ((1024, 8, 0.7, 0.2), (S, DEPTHS, RATIO, RATIO_MIN),
                 (37, 5, 0.8, 0.3)):
        assert cod_capacities(*args) == jax_peagle_draft.cod_capacities(*args)
    assert cod_capacities(1024, 8, 0.7, 0.2) == (1024, 717, 502, 352, 246,
                                                 205, 205, 205)
    rng = np.random.default_rng(0)
    sample = _jax_sample(jax.random.PRNGKey(1), _loss_mask(rng), LENGTHS)
    doc_ids = document_ids_from_lengths(t(LENGTHS), S)
    ref = jax.vmap(jax_peagle.peagle_allow_mask)(
        jax_peagle.CODSample(*(jnp.asarray(x.numpy()) for x in sample)),
        _jax_doc_ids(LENGTHS, S))
    np.testing.assert_array_equal(peagle_allow_mask(sample, doc_ids).numpy(),
                                  np.asarray(ref))
    anchor_doc = doc_ids.long().gather(1, sample.anchor_pos.long())
    np.testing.assert_array_equal(
        pac.cod_allow_dense(sample.anchor_pos, sample.depth, anchor_doc,
                            sample.valid.int()).numpy(),
        np.asarray(jax.vmap(jax_cod.cod_allow_dense)(
            *(jnp.asarray(x.numpy()) for x in (
                sample.anchor_pos, sample.depth, anchor_doc,
                sample.valid.int())))))


def test_sampler_invariants():
    """As test_peagle.py:51-83, for the torch sampler over a batch: depth 0
    is every position; each kept rollout slot's anchor and target lie in
    one document; depth-1 targets are supervised; the draw is fixed by the
    generator's seed; the field shapes are the static capacities."""
    rng = np.random.default_rng(0)
    loss_mask = t(_loss_mask(rng))
    doc_ids = document_ids_from_lengths(t(LENGTHS), S)

    def draw(seed):
        return generate_cod_sample_indices(
            torch.Generator().manual_seed(seed), loss_mask, doc_ids, DEPTHS,
            RATIO, RATIO_MIN)

    sample = draw(0)
    total = sum(cod_capacities(S, DEPTHS, RATIO, RATIO_MIN))
    assert sample.anchor_pos.shape == (2, total)
    for b in range(2):
        anchor, depth, valid = (x[b].numpy() for x in sample)
        assert (depth[:S] == 0).all() and valid[:S].all()
        assert (anchor[:S] == np.arange(S)).all()
        docs = doc_ids[b].numpy()
        for i in np.where(valid & (depth > 0))[0]:
            a, d = anchor[i], depth[i]
            assert 0 <= a and a + d < S and docs[a + d] == docs[a] >= 0
            if d == 1:
                assert loss_mask[b, a + 1] == 1
        assert (valid & (depth > 0)).any()
    for x, y in zip(sample, draw(0)):
        assert torch.equal(x, y)
    assert any(not torch.equal(x, y) for x, y in zip(sample, draw(1)))


def test_sampler_without_randomness_equals_jax():
    """With down_sample_ratio = 1.0 the sample does not depend on the draw
    (every eligible position is kept): the torch sample equals JAX's
    exactly, before and after the doc-major sort."""
    loss_mask = np.ones((2, S), np.int32)
    loss_mask[1, 40:] = 0
    lengths = np.array([[30, 18], [40, 0]], np.int32)
    doc_ids = document_ids_from_lengths(t(lengths), S)
    sample = generate_cod_sample_indices(
        torch.Generator().manual_seed(3), t(loss_mask), doc_ids, DEPTHS, 1.0,
        1.0)
    ref = _jax_sample(jax.random.PRNGKey(5), loss_mask, lengths, ratio=1.0,
                      ratio_min=1.0)
    for x, y in zip(sample, ref):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    # the JAX model's doc-major sort of the same sample
    orig = (ref.anchor_pos + ref.depth).numpy()
    qdoc = np.take_along_axis(doc_ids.numpy(), orig, axis=1)
    key = ((1 - ref.valid.numpy().astype(np.int32)) * (1 << 27)
           + (qdoc + 1) * (1 << 19) + ref.depth.numpy() * (1 << 14) + orig)
    perm = np.asarray(jnp.argsort(jnp.asarray(key), axis=1))
    for x, y in zip(doc_major(sample, doc_ids), ref):
        np.testing.assert_array_equal(
            x.numpy(), np.take_along_axis(y.numpy(), perm, axis=1))


def test_sort_key_order_within_and_beyond_the_int32_bounds():
    """The int64 key orders as JAX's int32 key where that one is exact
    (positions < 2^14, docs + 1 < 2^8), and lexicographically by
    (invalid, doc, depth, position) beyond it, where JAX's key overflows."""
    rng = np.random.default_rng(4)
    n = 4000
    for pos_max, doc_max in ((1 << 14, (1 << 7) - 1), (1 << 20, 1000)):
        valid = rng.random(n) > 0.3
        doc = rng.integers(-1, doc_max, n)
        depth = rng.integers(0, 8, n)
        pos = rng.integers(0, pos_max, n)
        got = torch.argsort(cod_sort_key(t(valid), t(doc), t(depth), t(pos)),
                            stable=True).numpy()
        want = np.lexsort((np.arange(n), pos, depth, doc, ~valid))
        np.testing.assert_array_equal(got, want)
        if pos_max == 1 << 14:
            jkey = ((1 - valid.astype(np.int32)) * (1 << 27)
                    + (doc.astype(np.int32) + 1) * (1 << 19)
                    + depth.astype(np.int32) * (1 << 14) + pos.astype(np.int32))
            np.testing.assert_array_equal(
                got, np.asarray(jnp.argsort(jnp.asarray(jkey))))


# --------------------------------------------------------------------------
# the COD attention: plain versions against the interpret-mode Pallas kernel
# --------------------------------------------------------------------------

def _attention_inputs(seed=3):
    """The synthetic COD properties of test_peagle.py:169-199 (b=1, h=4,
    kvh=2, d=8, t=40: a depth-0 trunk of 24 over 2 documents, 16 rollout
    slots, an invalid tail) and the rows with an allowed key."""
    rng = np.random.default_rng(seed)
    b, h, kvh, d, tt = 1, 4, 2, 8, 40
    q = rng.normal(size=(b, h, tt, d)).astype(np.float32)
    k = rng.normal(size=(b, kvh, tt, d)).astype(np.float32)
    v = rng.normal(size=(b, kvh, tt, d)).astype(np.float32)
    anchor = np.concatenate([np.arange(24), rng.integers(1, 23, size=16)])
    depth = np.concatenate([np.zeros(24, int), rng.integers(1, 3, size=16)])
    doc_of_pos = np.asarray([0] * 14 + [1] * 8 + [-1] * 2)
    doc = doc_of_pos[np.minimum(anchor, 23)]
    valid = np.ones(tt, bool)
    valid[-3:] = False
    props = [x[None] for x in (anchor.astype(np.int32), depth.astype(np.int32),
                               doc.astype(np.int32), valid)]
    allow = np.asarray(jax_cod.cod_allow_dense(
        *(jnp.asarray(x[0]) for x in props[:3]),
        jnp.asarray(props[3][0].astype(np.int32))))
    live = valid & allow.any(axis=1)
    cot = rng.normal(size=(b, tt, h * d)).astype(np.float32) * live[None, :,
                                                                    None]
    return (q, k, v), props, live, cot


def test_plain_cod_attention_matches_pallas_interpret():
    """``cod_flash_attention`` on CPU tensors (the plain forward and
    backward) against JAX ``cod_flash_attention(..., tq=8, tk=8,
    interpret=True)``, on rows with an allowed key: out, dq, dk, dv. Rows
    without one are exactly 0 in the port (the kernels' rule)."""
    qkv, props, live, cot = _attention_inputs()

    def jax_fn(q, k, v):
        out = jax_cod.cod_flash_attention(q, k, v, *map(jnp.asarray, props),
                                          tq=8, tk=8, interpret=True)
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(jax_fn, argnums=(0, 1, 2),
                                           has_aux=True)(
        *map(jnp.asarray, qkv))
    q, k, v = (t(x).requires_grad_(True) for x in qkv)
    out = pac.cod_flash_attention(q, k, v, *(t(x) for x in props))
    (out * t(cot)).sum().backward()
    close(out.detach().numpy()[:, live], np.asarray(jout)[:, live], **ATTN_FWD)
    assert not out.detach()[:, ~live].any()
    for name, x, ref in zip("qkv", (q, k, v), jgrads):
        close(x.grad.numpy(), np.asarray(ref), err_msg=name, **ATTN_GRAD)
    assert not q.grad.transpose(1, 2)[:, ~live].any()


def test_plain_statistics_tiles_and_chunks():
    """The plain forward's (m, l): m is the row max of the allowed scores and
    l the sum of their exponentials, -1e30 and 0 on rows with no allowed
    key; the row chunking does not change the result; the tile table marks
    exactly the 64 x 64 tile pairs that hold an allowed pair."""
    qkv, props, live, _ = _attention_inputs()
    q, k, v = (t(x) for x in qkv)
    tiles = pac.cod_tiles(*(t(x) for x in props))
    out, m, l = pac.cod_attention_fwd(q, k, v, tiles)
    allow = pac._allow(tiles.props, tiles.props)[0]
    s = torch.einsum("bhsd,bhtd->bhst", q, k.repeat_interleave(2, 1)) / 8 ** 0.5
    s = s.masked_fill(~allow, float("-inf"))
    close(m[:, :, live].numpy(), s.amax(-1)[:, :, live].numpy(), rtol=1e-6)
    close(l[:, :, live].numpy(),
          torch.exp(s - s.amax(-1, keepdim=True)).sum(-1)[:, :, live].numpy(),
          rtol=1e-6)
    assert (m[:, :, ~live] == pac.NEG_INF).all() and not l[:, :, ~live].any()
    old = pac.PLAIN_CHUNK_ELEMENTS
    try:
        pac.PLAIN_CHUNK_ELEMENTS = 4 * 40 * 7  # chunks of 7 rows
        assert len(pac._row_chunks(q)) == 6
        out2, m2, l2 = pac.cod_attention_fwd(q, k, v, tiles)
    finally:
        pac.PLAIN_CHUNK_ELEMENTS = old
    for a, b_ in ((out, out2), (m, m2), (l, l2)):
        close(a.numpy(), b_.numpy(), rtol=1e-6, atol=1e-7)
    assert tiles.table.shape == (1, 1, 1) and int(tiles.table.sum()) == 1
    big = torch.zeros(2, 130, dtype=torch.int32)
    doc = big.clone()
    doc[1] = -1
    table = pac.cod_tiles(big, big, doc, torch.ones_like(big)).table
    assert table.shape == (2, 3, 3)
    # row 0: one document, every slot depth 0 at anchor 0 → every pair allowed
    assert table[0].all() and not table[1].any()


def _slice_sample(lengths, s, seed):
    """A COD sample of the port's sampler (8 depths, the P-EAGLE example's
    ratios) over a response-part loss mask of each document, doc-major →
    the four [B, T] vectors the kernels read."""
    lengths = torch.tensor(lengths, dtype=torch.int32)
    doc_ids = document_ids_from_lengths(lengths, s)
    loss_mask = torch.zeros(lengths.shape[0], s, dtype=torch.int32)
    for row, lens in enumerate(lengths.tolist()):
        start = 0
        for n in lens:
            loss_mask[row, start + n // 4:start + n] = 1
            start += n
    sample = doc_major(generate_cod_sample_indices(
        torch.Generator().manual_seed(seed), loss_mask, doc_ids, 8, RATIO,
        RATIO_MIN), doc_ids)
    anchor_doc = doc_ids.long().gather(1, sample.anchor_pos.long())
    return sample.anchor_pos, sample.depth, anchor_doc, sample.valid


def test_cod_full_tiles_match_the_jax_mask():
    """The full-tile flags mark exactly the 64 x 64 tile pairs whose every
    pair the JAX package's dense predicate allows (a ragged T: the tail
    tiles are never full), a subset of the live table; the table is the
    JAX mask's any-tile."""
    vectors = _slice_sample([[256, 0], [100, 156]], 256, seed=5)
    tiles = pac.cod_tiles(*vectors)
    b, t = vectors[0].shape
    nt = -(-t // pac.TILE)
    assert t % pac.TILE, "the sample's T must be ragged"
    for i in range(b):
        dense = np.asarray(jax_cod.cod_allow_dense(
            *(jnp.asarray(x[i].numpy()) for x in vectors)))
        padded = np.zeros((nt * pac.TILE, nt * pac.TILE), bool)
        padded[:t, :t] = dense
        blocks = padded.reshape(nt, pac.TILE, nt, pac.TILE)
        np.testing.assert_array_equal(tiles.full[i].numpy(),
                                      blocks.all(axis=(1, 3)))
        np.testing.assert_array_equal(tiles.table[i].numpy(),
                                      blocks.any(axis=(1, 3)))
    full = tiles.full.bool()
    assert full.any() and not full[:, -1].any() and not full[:, :, -1].any()
    assert not (full & ~tiles.table.bool()).any()
    assert tiles.full.dtype == torch.int32 and tiles.full.is_contiguous()


#: a hand-made [1, 4, 4] tile table; its column sums order the key tiles
#: 1, 2, 0, 3, its row sums (all 2) keep the q tiles in index order; the
#: transpose swaps the two
HAND_TABLE = [[[1, 1, 0, 0], [0, 1, 1, 0], [0, 1, 1, 0], [0, 1, 1, 0]]]


# the dk/dv kernel's order sums the table over its q tiles (dim 1), the dq
# kernel's over its key tiles (dim 2)
@pytest.mark.parametrize("field,dim,hand", [
    ("order", 1, [[1, 2, 0, 3], [0, 1, 2, 3]]),
    ("dq_order", 2, [[0, 1, 2, 3], [1, 2, 0, 3]]),
])
def test_cod_block_order_is_stable_and_longest_first(field, dim, hand):
    """A launch order is a permutation of the (batch, tile) pairs, by live
    tiles descending, ties in index order: on a real sample, and on a
    hand-made table and its transpose."""
    tiles = pac.cod_tiles(*_slice_sample([[256, 0], [100, 156]], 256, 6))
    b, nt, _ = tiles.table.shape
    order = getattr(tiles, field)
    assert order.dtype == torch.int32 and order.shape == (b * nt,)
    assert torch.equal(order, pac.block_order(tiles.table, dim))
    assert sorted(order.tolist()) == list(range(b * nt))
    live = tiles.table.sum(dim=dim).flatten()[order.long()].tolist()
    assert len(set(live)) > 1
    for i in range(len(live) - 1):
        assert live[i] >= live[i + 1]
        if live[i] == live[i + 1]:
            assert order[i] < order[i + 1]
    table = torch.tensor(HAND_TABLE, dtype=torch.int32)
    assert pac.block_order(table, dim).tolist() == hand[0]
    assert pac.block_order(table.transpose(1, 2), dim).tolist() == hand[1]


def test_cpu_wrappers_launch_nothing_and_kernel_checks_refuse():
    qkv, props, _, _ = _attention_inputs()
    q, k, v = (t(x) for x in qkv)
    tiles = pac.cod_tiles(*(t(x) for x in props))
    counts = [f.launches for f in (pac.cod_attention_fwd,
                                   pac.cod_attention_bwd_dq,
                                   pac.cod_attention_bwd_dkv)]
    out, m, l = pac.cod_attention_fwd(q, k, v, tiles)
    pac.cod_attention_bwd(q, k, v, tiles, out, m, l, torch.ones_like(out))
    assert counts == [f.launches for f in (pac.cod_attention_fwd,
                                           pac.cod_attention_bwd_dq,
                                           pac.cod_attention_bwd_dkv)]
    bf = [x.to(torch.bfloat16) for x in (q, k, v)]
    with pytest.raises(ValueError, match="head dim 8"):
        pac._check_inputs(*bf, tiles)
    q64 = torch.zeros(1, 3, 40, 64, dtype=torch.bfloat16)
    k64 = torch.zeros(1, 2, 40, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of KVH"):
        pac._check_inputs(q64, k64, k64, tiles)
    with pytest.raises(TypeError, match="bfloat16"):
        pac._check_inputs(q64.float()[:, :2], k64, k64, tiles)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pac._check_inputs(q64[:, :2], k64, k64, tiles)
    with pytest.raises(ValueError, match="unsupported device"):
        pac.cod_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"),
                              tiles)


@pytest.mark.parametrize("operand", ["q", "k", "v"])
def test_cod_kernel_inputs_must_be_aligned(operand):
    """The kernels read q, k and v by TMA: the wrapper's check refuses a
    view that starts off a 16-byte boundary, and passes an aligned one on
    to the device check (these tensors lie on the CPU)."""
    _, props, _, _ = _attention_inputs()
    tiles = pac.cod_tiles(*(t(x) for x in props))
    b, n = tiles.props.shape[:2]
    ops = {name: torch.zeros((b, heads, n, 64), dtype=torch.bfloat16)
           for name, heads in (("q", 4), ("k", 2), ("v", 2))}
    x = ops[operand]
    flat = torch.zeros(x.numel() + 16, dtype=torch.bfloat16)
    aligned = flat[8 - flat.data_ptr() % 16 // 2:][:x.numel()].view(x.shape)
    shifted = flat[9 - flat.data_ptr() % 16 // 2:][:x.numel()].view(x.shape)
    assert aligned.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="CUDA tensors"):
        pac._check_inputs(**{**ops, operand: aligned}, tiles=tiles)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pac._check_inputs(**{**ops, operand: shifted}, tiles=tiles)


# --------------------------------------------------------------------------
# the model against JAX
# --------------------------------------------------------------------------

def _inputs(seed=0, b=2):
    rng = np.random.default_rng(seed)
    attention_mask = np.zeros((b, S), np.int32)
    for r in range(b):
        attention_mask[r, :LENGTHS[r].sum()] = 1
    tensors = {
        "input_ids": rng.integers(0, V - 1, size=(b, S)).astype(np.int32),
        "attention_mask": attention_mask,
        "loss_mask": _loss_mask(rng, b),
        "hidden_state": rng.normal(size=(b, S, 3 * H)).astype(np.float32),
        "target": (rng.normal(size=(b, S, V)) * 2).astype(np.float32),
    }
    keep = np.sort(rng.choice(V, size=VD, replace=False))
    t2d = np.zeros(V, bool)
    t2d[keep] = True
    d2t = (keep - np.arange(VD)).astype(np.int32)
    return tensors, t2d, d2t


def _jax_model(backend="dense"):
    draft = jax_peagle_draft.PEagleDraftModel(
        jax_peagle_draft.PEagleConfig.from_dict(CFG), dtype=jnp.float32,
        attention_backend=backend)
    return jax_peagle.OnlinePEagleModel(
        draft_model=draft, mask_token_id=MASK_TOKEN, num_depths=DEPTHS,
        down_sample_ratio=RATIO, down_sample_ratio_min=RATIO_MIN)


def _jax_variables(jmodel, tensors, t2d, d2t):
    args = [jnp.asarray(tensors[k][:1]) for k in (
        "input_ids", "attention_mask", "target", "loss_mask", "hidden_state")]
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *args,
                                     jax.random.PRNGKey(1))
    return jax.device_get({
        "params": variables["params"],
        "buffers": {"draft_model": {"t2d": t2d, "d2t": d2t}},
    })


def _port_model(backend):
    draft = PEagleDraftModel(PEagleConfig.from_dict(CFG), dtype=torch.float32,
                             attention_backend=backend, device="cpu")
    return OnlinePEagleModel(draft, MASK_TOKEN, num_depths=DEPTHS,
                             down_sample_ratio=RATIO,
                             down_sample_ratio_min=RATIO_MIN)


@pytest.fixture(scope="module")
def jax_model_run():
    """The JAX model's loss, metrics and parameter gradients at B=2 (two
    documents packed in row 0), its variables and the sample it drew."""
    tensors, t2d, d2t = _inputs()
    jmodel = _jax_model()
    variables = _jax_variables(jmodel, tensors, t2d, d2t)
    rng_key = jax.random.PRNGKey(2)
    args = [jnp.asarray(tensors[k]) for k in (
        "input_ids", "attention_mask", "target", "loss_mask", "hidden_state")]

    def run(params):
        return jmodel.apply({"params": params,
                             "buffers": variables["buffers"]}, *args, rng_key,
                            jnp.asarray(LENGTHS))

    (loss, metrics), grads = jax.jit(jax.value_and_grad(run, has_aux=True))(
        variables["params"])
    sample = _jax_sample(rng_key, tensors["loss_mask"], LENGTHS)
    return (tensors, variables, sample, float(loss), jax.device_get(metrics),
            params_from_jax(jax.device_get({"params": grads})))


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_model_matches_jax(jax_model_run, backend):
    """Loss, per-depth counters, the embedded ids and every parameter
    gradient of the port's dense and kernel backends against the JAX
    model."""
    tensors, variables, sample, jloss, jmetrics, jgrads = jax_model_run
    model = _port_model(backend)
    model.load_state_dict(params_from_jax(variables))
    loss, metrics = model(
        *(t(tensors[k]) for k in ("input_ids", "attention_mask", "target",
                                  "loss_mask", "hidden_state")),
        lengths=t(LENGTHS), sample=sample)
    loss.backward()
    close(float(loss.detach()), jloss, rtol=LOSS_RTOL)
    for key, value in jmetrics.items():
        if key.endswith(("_acc_sum", "_acc_total")):
            assert float(metrics[key]) == float(value), key
    np.testing.assert_array_equal(metrics["embedded_ids"].numpy(),
                                  np.asarray(jmetrics["embedded_ids"]))
    assert set(dict(model.named_parameters())) == set(jgrads)
    for name, p in model.named_parameters():
        close(p.grad.numpy(), jgrads[name].numpy(), err_msg=name,
              **MODEL_GRAD)


def test_embed_delta_gradient_is_the_embedding_gradient():
    """The row-sparse path's zeros ``embed_delta``: its gradient summed per
    embedded id equals the dense embedding table's gradient."""
    tensors, t2d, d2t = _inputs(1)
    model = _port_model("pallas")
    model.draft_model.set_vocab_maps(t2d, d2t)
    args = [t(tensors[k]) for k in ("input_ids", "attention_mask", "target",
                                    "loss_mask", "hidden_state")]
    sample = generate_cod_sample_indices(
        torch.Generator().manual_seed(0), t(tensors["loss_mask"]),
        document_ids_from_lengths(t(LENGTHS), S), DEPTHS, RATIO, RATIO_MIN)
    loss, _ = model(*args, lengths=t(LENGTHS), sample=sample)
    loss.backward()
    dense = model.draft_model.embed_tokens.weight.grad.clone()
    delta = torch.zeros(2, model.sampled_length(S), H, requires_grad=True)
    loss, metrics = model(*args, lengths=t(LENGTHS), sample=sample,
                          embed_delta=delta)
    (d_delta,) = torch.autograd.grad(loss, [delta])
    uids, rows = pt_opt.segment_sum_rows(metrics["embedded_ids"],
                                         d_delta.reshape(-1, H))
    rebuilt = torch.zeros_like(dense).index_add_(0, uids, rows)
    close(rebuilt.numpy(), dense.numpy(), rtol=1e-6, atol=1e-9)


# --------------------------------------------------------------------------
# optimizer: factored Adam and the row-sparse update
# --------------------------------------------------------------------------

def _opt_params(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (160, 128), "b": (64, 128), "c": (128,)}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in
            shapes.items()}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("b1", [0.0, 0.9])
def test_factored_adam_matches_jax(b1, moments):
    """Three steps of factored Adam (clip included) against JAX
    ``build_optimizer``: parameters and the row/column EMAs; the state
    shapes (fp32 EMAs of the factored matrix only, no first moment at
    b1 = 0)."""
    kw = dict(lr=1e-2, warmup_ratio=0.0, adam_b1=b1, moments_dtype=moments,
              factored_second_moments=True, max_grad_norm=1.0)
    params = _opt_params()
    tx = jax_opt.build_optimizer(jax_opt.OptimizerConfig(**kw), 10)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    opt = pt_opt.build_optimizer(pt_opt.OptimizerConfig(**kw), 10)
    pparams = {k: t(v) for k, v in params.items()}
    state = opt.init(pparams)
    assert {k: tuple(v.shape) for k, v in state["nu_row"].items()} == {
        "a": (160,)}
    assert state["nu_col"]["a"].shape == (128,)
    assert state["nu_col"]["a"].dtype == torch.float32
    assert set(state["nu"]) == {"b", "c"}
    assert set(state["mu"]) == (set() if b1 == 0.0 else {"a", "b", "c"})
    rng = np.random.default_rng(1)
    for _ in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) * 0.3
                 for k, v in params.items()}
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in
                                     grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        state = opt.step(pparams, {k: t(v) for k, v in grads.items()}, state)
    for k in params:
        close(pparams[k].numpy(), np.asarray(jparams[k]), err_msg=k, **OPT_TOL)
    (fstate,) = [s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda x: isinstance(x, jax_opt.FactoredAdamState))
        if isinstance(s, jax_opt.FactoredAdamState)]
    close(state["nu_row"]["a"].numpy(), np.asarray(fstate.nu_row["a"]),
          **OPT_TOL)
    close(state["nu_col"]["a"].numpy(), np.asarray(fstate.nu_col["a"]),
          **OPT_TOL)
    assert state["count"] == int(fstate.count) == 3


def test_row_sparse_regime_check():
    for bad in (dict(), dict(factored_second_moments=True),
                dict(factored_second_moments=True, adam_b1=0.0,
                     weight_decay=0.1)):
        cfg = dict(row_sparse_embedding=True, **bad)
        with pytest.raises(ValueError, match="row_sparse_embedding"):
            pt_opt.build_optimizer(pt_opt.OptimizerConfig(**cfg), 10)
        with pytest.raises(ValueError, match="row_sparse_embedding"):
            jax_opt.build_optimizer(jax_opt.OptimizerConfig(**cfg), 10)


def test_segment_sum_rows_dedups():
    """As test_sparse_embed.py:142-148, and equal to JAX's on the ids it
    keeps."""
    ids = torch.tensor([5, 3, 5, 9, 3, 5])
    rows = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    uids, summed = pt_opt.segment_sum_rows(ids, rows)
    assert uids.tolist() == [3, 5, 9]
    dense = torch.zeros(12, 4).index_add_(0, ids, rows)
    rebuilt = torch.zeros(12, 4).index_add_(0, uids, summed)
    assert torch.equal(rebuilt, dense)
    juids, jsummed = jax_opt.segment_sum_rows(jnp.asarray(ids.numpy()),
                                              jnp.asarray(rows.numpy()))
    np.testing.assert_array_equal(np.asarray(juids)[:3], uids.numpy())
    np.testing.assert_array_equal(np.asarray(jsummed)[:3], summed.numpy())


def _sparse_run(sparse: bool, batches, frozen):
    """Three optimizer steps of the port's P-EAGLE train step (accumulation
    1), with or without the row-sparse embedding update."""
    opt_cfg = pt_opt.OptimizerConfig(
        lr=1e-2, max_grad_norm=0.5, factored_second_moments=True,
        factored_min_dim=8, adam_b1=0.0, row_sparse_embedding=sparse)
    model = _port_model("pallas")
    strategy = PEagleTrainStrategy(model, seed=3)
    opt = pt_opt.build_optimizer(opt_cfg, 20)
    schedule = pt_opt.build_lr_schedule(opt_cfg, 20)
    plan = (SparseEmbedPlan(strategy.sparse_embed_path,
                            strategy.sparse_embed_delta_shape, opt_cfg,
                            schedule) if sparse else None)
    state = TrainState.create(model, opt,
                              sparse_embed_path=plan.path if plan else None)
    step = make_train_step(strategy, opt, accum_steps=1, total_steps=20,
                           metadata={"target_repr": "hidden_state"},
                           sparse_embed=plan)
    losses = []
    for batch in batches:
        state, metrics = step(state, batch, frozen)
        losses.append(float(metrics["train/loss"]))
    return state, losses


def test_row_sparse_update_equals_dense_factored_update():
    """The row-sparse embedding update against the dense factored update
    (test_sparse_embed.py:103-140): losses and every parameter after three
    steps; rows no step embedded stay exactly as initialised in both."""
    rng = np.random.default_rng(7)
    batches = [{
        "input_ids": t(rng.integers(0, V // 4, size=(1, 1, S))),
        "attention_mask": torch.ones(1, 1, S, dtype=torch.int32),
        "loss_mask": t((rng.random((1, 1, S, 1)) > 0.2).astype(np.int32)),
        "hidden_state": t(rng.normal(size=(1, 1, S, 3 * H)).astype(
            np.float32)),
        "target": t(rng.normal(size=(1, 1, S, H)).astype(np.float32)),
    } for _ in range(3)]
    frozen = {"target_head_weight": t(
        (rng.normal(size=(V, H)) * 0.1).astype(np.float32))}
    init = _port_model("pallas").draft_model.embed_tokens.weight.detach()
    dense, dense_losses = _sparse_run(False, batches, frozen)
    sparse, sparse_losses = _sparse_run(True, batches, frozen)
    close(sparse_losses, dense_losses, rtol=1e-5)
    assert set(sparse.params) == set(dense.params)
    for name, p in dense.params.items():
        close(sparse.params[name].detach().numpy(), p.detach().numpy(),
              err_msg=name, **SPARSE_TOL)
    path = "draft_model.embed_tokens.weight"
    untouched = torch.ones(V, dtype=torch.bool)
    untouched[:V // 4] = False
    untouched[MASK_TOKEN] = False
    for state in (dense, sparse):
        assert torch.equal(state.params[path].detach()[untouched],
                           init[untouched])
    assert set(sparse.opt_state) == {"dense", "sparse_embed"}
    assert sparse.opt_state["sparse_embed"]["nu_row"].shape == (V,)
    assert path not in sparse.opt_state["dense"]["nu_row"]


# --------------------------------------------------------------------------
# packing collator
# --------------------------------------------------------------------------

def _doc(rng, n, h=6, v=32):
    return {
        "input_ids": rng.integers(0, v, size=(n,)).astype(np.int32),
        "loss_mask": np.ones((n, 1), np.int32),
        "hidden_state": rng.normal(size=(n, h)).astype(np.float32),
        "target": rng.normal(size=(n, h)).astype(np.float32),
    }


@pytest.mark.parametrize("lens,rows,docs_per_row,max_length", [
    ((5, 7, 3, 4), 2, 4, 16),        # every document placed
    ((9,), 1, 2, 12),                 # one document, as the padding collator
    ((10, 9, 8), 2, 2, 12),           # truncation into the largest gap
    ((20, 11, 12, 2, 1), 2, 2, 12),   # longer than a row; drops
])
def test_packing_collator_matches_jax(lens, rows, docs_per_row, max_length):
    """Exactly JAX's tensors, metadata and sample ids on the same documents
    (test_packing.py:36-106): placement, truncation, drops and the masked
    last position of every document."""
    rng = np.random.default_rng(len(lens))
    docs = [_doc(rng, n) for n in lens]
    ids = [f"doc{i}" for i in range(len(docs))]
    ref = JaxPackingCollator(JaxPackingCollatorConfig(
        max_length=max_length, rows=rows, max_docs_per_row=docs_per_row))(
            docs, sample_ids=ids)
    got = PackingCollator(PackingCollatorConfig(
        max_length=max_length, rows=rows, max_docs_per_row=docs_per_row))(
            [{k: t(v) for k, v in d.items()} for d in docs], sample_ids=ids)
    assert set(got.tensors) == set(ref.tensors)
    for name, x in got.tensors.items():
        assert x.shape == ref.tensors[name].shape, name
        np.testing.assert_array_equal(x.numpy(), ref.tensors[name],
                                      err_msg=name)
    assert got.metadata == ref.metadata
    assert got.sample_ids == ref.sample_ids


def test_packing_collator_keeps_stored_bf16():
    rng = np.random.default_rng(0)
    doc = {k: t(v) for k, v in _doc(rng, 5).items()}
    doc["hidden_state"] = doc["hidden_state"].to(torch.bfloat16)
    batch = PackingCollator(PackingCollatorConfig(max_length=8, rows=1))(
        [doc])
    assert batch.tensors["hidden_state"].dtype == torch.bfloat16
    assert batch.tensors["target"].dtype == torch.float32


# --------------------------------------------------------------------------
# the train step against JAX
# --------------------------------------------------------------------------

def test_registry_builds_peagle():
    reg = builtin_algorithm_registry().resolve("peagle")
    assert reg.providers.frozen_requirements == {"target_head_weight"}
    assert reg.spec.contract_for(
        reg.spec.feature_contracts[0].mode).target_representation == (
            "hidden_state")
    draft, cfg = reg.providers.build_draft({**CFG, "attention_backend":
                                            "dense"}, dtype=torch.float32,
                                           device="cpu")
    assert draft.attention_backend == "dense" and cfg.hidden_size == H
    model = reg.providers.build_training_model(
        draft, {"num_depths": DEPTHS, "down_sample_ratio": RATIO,
                "down_sample_ratio_min": RATIO_MIN, "mask_token_id": 5})
    assert model.sampled_length(S) == sum(cod_capacities(S, DEPTHS, RATIO,
                                                         RATIO_MIN))
    strategy = reg.providers.build_strategy(model, {"seed": 4})
    assert strategy.sparse_embed_delta_shape(
        {"input_ids": torch.zeros(2, S)}) == (2, model.sampled_length(S), H)


def test_train_step_matches_jax():
    """Two optimizer steps of 2 micro-batches with factored moments,
    adam_b1 = 0 and the row-sparse embedding update, against JAX
    ``make_train_step`` with a ``SparseEmbedPlan``: loss, grad norm,
    accuracy and every parameter, at rtol 1e-4."""
    accum, total, seed = 2, 10, 7
    tensors, t2d, d2t = _inputs(2)
    rng = np.random.default_rng(9)
    th = H  # the target's hidden size
    batches = []
    for _ in range(2):
        lm = np.stack([_loss_mask(rng) for _ in range(accum)])
        batches.append({
            "input_ids": rng.integers(0, V - 1, size=(accum, 2, S)).astype(
                np.int32),
            "attention_mask": np.broadcast_to(tensors["attention_mask"],
                                              (accum, 2, S)).copy(),
            "lengths": np.broadcast_to(LENGTHS, (accum, 2, 2)).copy(),
            "loss_mask": lm[..., None],
            "hidden_state": rng.normal(size=(accum, 2, S, 3 * th)).astype(
                np.float32),
            "target": rng.normal(size=(accum, 2, S, th)).astype(np.float32),
        })
    frozen = {"target_head_weight": (rng.normal(size=(V, th)) * 0.1).astype(
        np.float32)}
    kw = dict(lr=1e-3, warmup_ratio=0.0, adam_b1=0.0,
              factored_second_moments=True, factored_min_dim=8,
              row_sparse_embedding=True, max_grad_norm=0.5)
    metadata = {"target_repr": "hidden_state"}

    jmodel = _jax_model()
    variables = _jax_variables(jmodel, tensors, t2d, d2t)
    jstrategy = JaxPEagleTrainStrategy(jmodel, seed=seed)
    jcfg = jax_opt.OptimizerConfig(**kw)
    tx = jax_opt.build_optimizer(jcfg, total, include_clip=False)
    jplan = JaxSparsePlan(jstrategy.sparse_embed_path,
                          jstrategy.sparse_embed_delta_shape, jcfg,
                          jax_opt.build_lr_schedule(jcfg, total))
    jstate = JaxTrainState.create(variables["params"], variables["buffers"],
                                  tx, sparse_embed_path=jplan.path)
    jstep = jax_make_train_step(jstrategy, tx, accum_steps=accum,
                                total_steps=total, metadata=metadata,
                                sparse_embed=jplan)

    model = _port_model("pallas")
    model.load_state_dict(params_from_jax(variables))
    strategy = PEagleTrainStrategy(model, seed=seed)
    # the sample JAX draws for this step: fold_in(PRNGKey(seed), step)
    strategy.draw_sample = lambda loss_mask, lengths, ctx: _jax_sample(
        jax.random.fold_in(jax.random.PRNGKey(seed), ctx.global_step),
        loss_mask.numpy(), lengths.numpy())
    pcfg = pt_opt.OptimizerConfig(**kw)
    opt = pt_opt.build_optimizer(pcfg, total)
    plan = SparseEmbedPlan(strategy.sparse_embed_path,
                           strategy.sparse_embed_delta_shape, pcfg,
                           pt_opt.build_lr_schedule(pcfg, total))
    state = TrainState.create(model, opt, sparse_embed_path=plan.path)
    step = make_train_step(strategy, opt, accum_steps=accum,
                           total_steps=total, metadata=metadata,
                           sparse_embed=plan)
    pfrozen = {k: t(v) for k, v in frozen.items()}
    jfrozen = {k: jnp.asarray(v) for k, v in frozen.items()}
    for batch in batches:
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                          batch.items()}, jfrozen)
        state, metrics = step(state, {k: t(v) for k, v in batch.items()},
                              pfrozen)
        for key in ("train/loss", "train/grad_norm", "train/accuracy"):
            close(float(metrics[key]), float(jmetrics[key]), rtol=STEP_RTOL,
                  err_msg=key)
    updated = params_from_jax(jax.device_get({"params": jstate.params}))
    assert state.step == 2 and set(state.params) == set(updated)
    for name, p in state.params.items():
        close(p.detach().numpy(), updated[name].numpy(), rtol=STEP_RTOL,
              atol=1e-7, err_msg=name)
    close(state.opt_state["sparse_embed"]["nu_row"].numpy(),
          np.asarray(jstate.opt_state["sparse_embed"].nu_row), rtol=STEP_RTOL,
          atol=1e-12)
