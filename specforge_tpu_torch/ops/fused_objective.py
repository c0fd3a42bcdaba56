"""Fused frozen-vocab objectives of the DFlash family, with input gradients
computed in the forward pass.

Counterpart of the DFlash, Domino and DSpark parts of
``specforge_tpu/ops/fused_objective.py``. The objective ends in
``CE(hidden @ W_frozen^T)`` (plus, for Domino and DSpark, a low-rank
correction, and for DSpark an L1 distance to the teacher's probabilities);
the head is frozen and every downstream scale is known in the forward pass,
so

    d loss_num / d logits = w_eff * (softmax(logits) - onehot(target))

is formed chunk by chunk over the anchor axis, multiplied back through the
head at once, and only the small per-token input gradients are kept. Each
objective is a ``torch.autograd.Function`` whose backward is a rescale of
those gradients, as the JAX ``custom_vjp`` is. The vocab products stay
``torch.matmul`` (XLA einsums in the JAX package, not Pallas kernels).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _resolve_chunks(n: int, chunk_blocks: int) -> int:
    if chunk_blocks <= 0 or chunk_blocks >= n:
        return 1
    if n % chunk_blocks != 0:
        raise ValueError(
            f"objective_chunk_blocks {chunk_blocks} must divide anchors {n}"
        )
    return n // chunk_blocks


def _ce_stats(logits: torch.Tensor, targets: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (nlq, softmax): nlq = lse - picked, max-subtracted. The softmax
    is computed in place on the fp32 copy of the logits."""
    l32 = logits.float()
    m = l32.amax(dim=-1)
    lse = m + torch.log(torch.exp(l32 - m[..., None]).sum(dim=-1))
    picked = l32.gather(-1, targets[..., None].long())[..., 0]
    nlq = lse - picked
    softmax = l32.sub_(lse[..., None]).exp_()
    return nlq, softmax


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                         ) -> torch.Tensor:
    """Per-token -log p[target] in fp32 (no reduction), differentiable: the
    nlq half of :func:`_ce_stats` for the unfused (checkpointed) paths."""
    l32 = logits.float()
    m = l32.amax(dim=-1).detach()
    lse = m + torch.log(torch.exp(l32 - m[..., None]).sum(dim=-1))
    picked = l32.gather(-1, targets[..., None].long())[..., 0]
    return lse - picked


def compute_accept_len(pred_ids: torch.Tensor, target_ids: torch.Tensor,
                       valid_mask: torch.Tensor) -> torch.Tensor:
    """Per-block acceptance length [B, N]: the length of the prefix of block
    positions whose prediction matches the label, positions outside
    ``valid_mask`` passing for free."""
    correct = (pred_ids == target_ids) | (~valid_mask)
    prefix = torch.cumprod(correct.to(torch.int32), dim=2) * valid_mask.to(
        torch.int32)
    return prefix.sum(dim=2).float()


def _grad_logits(softmax: torch.Tensor, targets: torch.Tensor,
                 w_eff: torch.Tensor, out_dtype) -> torch.Tensor:
    """``w_eff[..., None] * (softmax - onehot(targets))`` cast to
    ``out_dtype``, formed in place on ``softmax``."""
    softmax.scatter_add_(-1, targets[..., None].long(),
                         torch.full_like(softmax[..., :1], -1.0))
    return softmax.mul_(w_eff[..., None]).to(out_dtype)


def dpace_weight(prob, binary_mask, binary_mask_b, loss_type: str,
                 alpha: float) -> torch.Tensor:
    """D-PACE per-token weights from clean-token probabilities (one source
    for the fused and the unfused paths)."""
    smooth = (1.0 - alpha) * prob + alpha
    smooth = torch.where(binary_mask_b, smooth, torch.ones_like(smooth))
    prefix = torch.cumprod(smooth, dim=-1)
    if loss_type == "dpace-cumulative-confidence-only":
        return prefix
    suffix = torch.flip(torch.cumsum(torch.flip(prefix * binary_mask, [-1]),
                                     dim=-1), [-1])
    if loss_type == "dpace":
        return suffix
    if loss_type == "dpace-continuation-value-only":
        return suffix / torch.clamp(prefix, min=torch.finfo(prefix.dtype).tiny)
    raise ValueError(f"unknown D-PACE loss_type {loss_type!r}")


def linear_rows(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weight^T`` as one 2-D product over x's rows. An anchor chunk of
    [B, N, K, h] is a strided view; handed to ``F.linear`` as it is, it
    becomes a batched product against a broadcast weight, many times slower
    on the card than the 2-D product (PERF.md, the Domino micro-step)."""
    out = F.linear(x.reshape(-1, x.shape[-1]), weight)
    return out.view(*x.shape[:-1], out.shape[-1])


# --- DFlash (single CE over the frozen head) --------------------------------

class _DFlashObjective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden4d, target_ids, loss_weights, weight_mask,
                head_weight, loss_type, dpace_alpha, chunk_blocks):
        n = hidden4d.shape[1]
        cs = n // _resolve_chunks(n, chunk_blocks)
        dtype = hidden4d.dtype
        w_cast = head_weight.to(dtype)
        zero = torch.zeros((), dtype=torch.float32, device=hidden4d.device)
        loss_num, loss_den, correct_num, accuracy_den = zero, zero, zero, zero
        d_hidden = torch.empty_like(hidden4d)
        for start in range(0, n, cs):
            h = hidden4d[:, start:start + cs]
            tgt = target_ids[:, start:start + cs].long()
            lw = loss_weights[:, start:start + cs]
            wm = weight_mask[:, start:start + cs]
            logits = linear_rows(h, w_cast)
            predicted = logits.argmax(dim=-1)
            nlq, softmax = _ce_stats(logits, tgt)
            del logits
            if loss_type == "dflash":
                w_eff = lw
                loss_den = loss_den + lw.sum()
            else:
                w_eff = wm * dpace_weight(torch.exp(-nlq), wm, wm > 0,
                                          loss_type, dpace_alpha)
            loss_num = loss_num + (nlq * w_eff).sum()
            correct_num = correct_num + ((predicted == tgt) & (wm > 0.5)).float(
            ).sum()
            accuracy_den = accuracy_den + wm.sum()
            dl = _grad_logits(softmax, tgt, w_eff, dtype)
            del softmax
            d_hidden[:, start:start + cs] = torch.matmul(dl, w_cast)
            del dl
        ctx.save_for_backward(d_hidden)
        ctx.mark_non_differentiable(loss_den, correct_num, accuracy_den)
        return loss_num, loss_den, correct_num, accuracy_den

    @staticmethod
    def backward(ctx, g, *_):
        (d_hidden,) = ctx.saved_tensors
        dh = (d_hidden.float() * g).to(d_hidden.dtype)
        return dh, None, None, None, None, None, None, None


def dflash_objective_fused(hidden4d, target_ids, loss_weights, weight_mask,
                           head_weight, loss_type: str = "dflash",
                           dpace_alpha: float = 0.5, chunk_blocks: int = 0):
    """→ (loss_num, loss_den, correct_num, accuracy_den), fp32 scalars.

    hidden4d [B, N, K, h]; target_ids, loss_weights (decay applied for
    'dflash'), weight_mask (no decay) [B, N, K]; head_weight frozen [V, h].
    Only ``loss_num`` carries a gradient, to ``hidden4d``."""
    return _DFlashObjective.apply(hidden4d, target_ids, loss_weights,
                                  weight_mask, head_weight, loss_type,
                                  float(dpace_alpha), int(chunk_blocks))


# --- Domino (base CE + GRU-corrected final CE, lambda blend) ----------------

class _DominoObjective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden4d, corr_act, p1_weight, target_ids, weight_mask,
                eval_weight_mask, lambda_base, head_weight, chunk_blocks):
        n = hidden4d.shape[1]
        cs = n // _resolve_chunks(n, chunk_blocks)
        dtype = hidden4d.dtype
        device = hidden4d.device
        w_cast = head_weight.to(dtype)
        p1_cast = p1_weight.to(dtype)
        lam = torch.as_tensor(lambda_base, dtype=torch.float32, device=device)
        sums = torch.zeros(9, dtype=torch.float32, device=device)
        dp1 = torch.zeros(p1_weight.shape, dtype=torch.float32, device=device)
        d_hidden = torch.empty_like(hidden4d)
        d_act = torch.empty_like(corr_act)
        for start in range(0, n, cs):
            h = hidden4d[:, start:start + cs]
            act = corr_act[:, start:start + cs]
            tgt = target_ids[:, start:start + cs].long()
            wm = weight_mask[:, start:start + cs]
            ewm = eval_weight_mask[:, start:start + cs]
            base_logits = linear_rows(h, w_cast)
            final_logits = base_logits + linear_rows(act, p1_cast)
            predicted = final_logits.argmax(dim=-1)
            base_pred = base_logits.argmax(dim=-1)
            nlq_f, sm_f = _ce_stats(final_logits, tgt)
            del final_logits
            nlq_b, sm_b = _ce_stats(base_logits, tgt)
            del base_logits
            bin_mask = ewm > 0.5
            valid_mask = ewm > 0
            accepted = compute_accept_len(predicted, tgt, valid_mask)
            base_accepted = compute_accept_len(base_pred, tgt, valid_mask)
            valid_blocks = valid_mask.any(dim=-1).float()
            sums += torch.stack([
                (nlq_f * wm).sum(),
                (nlq_b * wm).sum(),
                wm.sum(),
                ((predicted == tgt) & bin_mask).float().sum(),
                ((base_pred == tgt) & bin_mask).float().sum(),
                ewm.sum(),
                ((accepted + 1.0) * valid_blocks).sum(),
                ((base_accepted + 1.0) * valid_blocks).sum(),
                valid_blocks.sum(),
            ])
            # forward gradients of blend_num (unit cotangent):
            #   d/d final_logits = (1-lam) * wm * (sm_f - onehot)  [final CE]
            #   d/d base_logits  = that + lam * wm * (sm_b - onehot) [both]
            dl_f = _grad_logits(sm_f, tgt, (1.0 - lam) * wm, dtype)
            del sm_f
            dl_b = _grad_logits(sm_b, tgt, lam * wm, dtype)
            del sm_b
            d_hidden[:, start:start + cs] = torch.matmul(dl_f + dl_b, w_cast)
            del dl_b
            d_act[:, start:start + cs] = torch.matmul(dl_f, p1_cast)
            v, e = dl_f.shape[-1], act.shape[-1]
            # in the compute dtype (fp32 accumulation inside the product,
            # rounded to that dtype), summed over chunks in fp32
            dp1 += torch.matmul(dl_f.reshape(-1, v).t(),
                                act.reshape(-1, e)).float()
            del dl_f
        (final_num, base_num, loss_den, correct_num, base_correct,
         accuracy_den, accept_num, base_accept_num, accept_den) = sums.unbind()
        blend_num = (1.0 - lam) * final_num + lam * base_num
        ctx.save_for_backward(d_hidden, d_act, dp1)
        ctx.p1_dtype = p1_weight.dtype
        outs = (final_num, base_num, loss_den, correct_num, base_correct,
                accuracy_den, accept_num, base_accept_num, accept_den)
        ctx.mark_non_differentiable(*outs)
        return (blend_num, *outs)

    @staticmethod
    def backward(ctx, g, *_):
        d_hidden, d_act, dp1 = ctx.saved_tensors
        return (
            (d_hidden.float() * g).to(d_hidden.dtype),
            (d_act.float() * g).to(d_act.dtype),
            (dp1 * g).to(ctx.p1_dtype),
            None, None, None, None, None, None,
        )


def domino_objective_fused(hidden4d, corr_act, p1_weight, target_ids,
                           weight_mask, eval_weight_mask, lambda_base,
                           head_weight, chunk_blocks: int = 0):
    """→ (blend_num, final_num, base_num, loss_den, correct_num,
    base_correct, accuracy_den, accept_num, base_accept_num, accept_den).

    hidden4d [B, N, K, h]; corr_act [B, N, K, emb] (zeros before
    suffix_start); p1_weight the trainable ``embed_proj_1`` weight [V, emb]
    (logits_e = act @ p1_weight^T); target_ids, weight_mask (decay applied),
    eval_weight_mask [B, N, K]; lambda_base a scalar in [0, 1]; head_weight
    frozen [V, h]. Only ``blend_num = (1-λ)·final_num + λ·base_num`` carries
    a gradient (to hidden4d, corr_act and p1_weight); the rest is
    telemetry."""
    return _DominoObjective.apply(hidden4d, corr_act, p1_weight, target_ids,
                                  weight_mask, eval_weight_mask,
                                  float(lambda_base), head_weight,
                                  int(chunk_blocks))


# --- DSpark (Markov-biased CE + L1 to the teacher's probabilities) ----------

class _DSparkObjective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden4d, latent, w2_weight, ath, target_ids,
                loss_weights, eval_mask, head_weight, ce_alpha, l1_alpha,
                chunk_blocks):
        n = hidden4d.shape[1]
        cs = n // _resolve_chunks(n, chunk_blocks)
        dtype = hidden4d.dtype
        device = hidden4d.device
        has_markov, has_target = latent is not None, ath is not None
        use_l1 = has_target and l1_alpha > 0
        w_cast = head_weight.to(dtype)
        w2_cast = w2_weight.to(dtype) if has_markov else None
        k = hidden4d.shape[2]
        # ce, l1, correct, eval_den, agree, t_top1, d_top1, tau_num, tau_den
        sums = torch.zeros(9, dtype=torch.float32, device=device)
        pos = torch.zeros(3, k, dtype=torch.float32, device=device)
        d_hidden = torch.empty_like(hidden4d)
        d_latent = torch.empty_like(latent) if has_markov else None
        dw2 = (torch.zeros(w2_weight.shape, dtype=torch.float32,
                           device=device) if has_markov else None)
        accept = torch.zeros(target_ids.shape, dtype=torch.float32,
                             device=device)
        zero = torch.zeros((), dtype=torch.float32, device=device)
        for start in range(0, n, cs):
            sl = slice(start, start + cs)
            h = hidden4d[:, sl]
            tgt = target_ids[:, sl].long()
            lw = loss_weights[:, sl]
            em = eval_mask[:, sl].bool()
            emf = em.float()
            draft_logits = linear_rows(h, w_cast)
            if has_markov:
                lat = latent[:, sl]
                draft_logits = draft_logits + linear_rows(lat, w2_cast)
            predicted = draft_logits.argmax(dim=-1)
            nlq, p = _ce_stats(draft_logits, tgt)
            del draft_logits
            correct = ((predicted == tgt) & em).float()
            l1_num = agree = t_top1 = d_top1 = tau_num = tau_den = zero
            diff = None
            if has_target:
                target_logits = linear_rows(ath[:, sl], w_cast)
                teacher_ids = target_logits.argmax(dim=-1)
                q = torch.softmax(target_logits.float(), dim=-1)
                del target_logits
                t_top1 = (q.amax(dim=-1) * emf).sum()
                diff = p - q
                del q
                l1 = diff.abs().sum(dim=-1)
                ap = torch.clamp(1.0 - 0.5 * l1, 0.0, 1.0)
                accept[:, sl] = ap
                if l1_alpha > 0:
                    l1_num = (l1 * lw).sum()
                agree = ((predicted == teacher_ids).float() * emf).sum()
                d_top1 = (p.amax(dim=-1) * emf).sum()
                valid_blocks = em.any(dim=-1).float()
                accepted_exp = torch.cumprod(ap * emf, dim=-1).sum(dim=-1) + 1.0
                tau_num = (accepted_exp * valid_blocks).sum()
                tau_den = valid_blocks.sum()
            sums += torch.stack([
                (nlq * lw).sum(), l1_num, correct.sum(), emf.sum(), agree,
                t_top1, d_top1, tau_num, tau_den,
            ])
            pos += torch.stack([(nlq * emf).sum(dim=(0, 1)),
                                correct.sum(dim=(0, 1)), emf.sum(dim=(0, 1))])
            # forward gradient of vocab_num w.r.t. the draft logits:
            #   ce_alpha·lw·(p - onehot) + l1_alpha·lw·p·(s - <s, p>),
            # s = sign(p - q), in fp32, then cast once
            if use_l1:
                diff.sign_()
                sdot = (diff * p).sum(dim=-1, keepdim=True)
                diff.sub_(sdot).mul_(p).mul_((l1_alpha * lw)[..., None])
            else:
                diff = None
            p.scatter_add_(-1, tgt[..., None],
                           torch.full_like(p[..., :1], -1.0))
            p.mul_((ce_alpha * lw)[..., None])
            if diff is not None:
                p.add_(diff)
                del diff
            dl = p.to(dtype)
            del p
            d_hidden[:, sl] = torch.matmul(dl, w_cast)
            if has_markov:
                d_latent[:, sl] = torch.matmul(dl, w2_cast)
                v, r = dl.shape[-1], lat.shape[-1]
                # in the compute dtype (fp32 accumulation inside the
                # product), summed over chunks in fp32
                dw2 += torch.matmul(dl.reshape(-1, v).t(),
                                    lat.reshape(-1, r)).float()
            del dl
        (ce_num, l1_num, correct_num, eval_den, agree_num, t_top1, d_top1,
         tau_num, tau_den) = sums.unbind()
        ce_pos, correct_pos, pos_den = pos.unbind()
        vocab_num = ce_alpha * ce_num + l1_alpha * l1_num
        ctx.save_for_backward(d_hidden, d_latent, dw2)
        ctx.w2_dtype = w2_weight.dtype if has_markov else None
        outs = (ce_num, l1_num, correct_num, eval_den, ce_pos, correct_pos,
                pos_den, agree_num, t_top1, d_top1, tau_num, tau_den, accept)
        ctx.mark_non_differentiable(*outs)
        return (vocab_num, *outs)

    @staticmethod
    def backward(ctx, g, *_):
        d_hidden, d_latent, dw2 = ctx.saved_tensors
        return (
            (d_hidden.float() * g).to(d_hidden.dtype),
            None if d_latent is None else (d_latent.float() * g).to(
                d_latent.dtype),
            None if dw2 is None else (dw2 * g).to(ctx.w2_dtype),
            None, None, None, None, None, None, None, None,
        )


def dspark_objective_fused(hidden4d, latent, w2_weight, ath, target_ids,
                           loss_weights, eval_mask, head_weight,
                           ce_alpha: float, l1_alpha: float,
                           chunk_blocks: int = 0):
    """→ (vocab_num, ce_num, l1_num, correct_num, eval_den, ce_pos,
    correct_pos, pos_den, agree_num, t_top1, d_top1, tau_num, tau_den,
    accept_probability).

    hidden4d [B, N, K, h]; latent [B, N, K, r], the Markov latent, and
    w2_weight the trainable bias projection [V, r] (logit bias = latent @
    w2^T), both None without a Markov head; ath [B, N, K, h] the aligned
    teacher hidden state, or None; target_ids, loss_weights (decay
    applied), eval_mask [B, N, K]; head_weight frozen [V, h]. Only
    ``vocab_num = ce_alpha·ce_num + l1_alpha·l1_num`` carries a gradient
    (to hidden4d, latent and w2_weight); the rest is telemetry and the
    acceptance probability [B, N, K] (0 without a teacher), which the
    confidence BCE uses outside. Both full-vocab softmaxes (the draft's and
    the teacher's) run once per chunk; the L1 input gradient is formed
    forward as ``p·(s - <s, p>)`` with ``s = sign(p - q)``."""
    return _DSparkObjective.apply(hidden4d, latent, w2_weight, ath,
                                  target_ids, loss_weights, eval_mask,
                                  head_weight, float(ce_alpha),
                                  float(l1_alpha), int(chunk_blocks))
