"""CTC loss (counterpart of ``llm_bci_tpu/ops/ctc.py``).

Semantics match ``torch.nn.CTCLoss(reduction="none", blank,
zero_infinity)``: one unnormalized negative log-likelihood per example.
:func:`ctc_loss` calls one of two ``torch.library`` custom ops, and the op's
dispatch key picks the implementation, so a graph exported with
``torch.export`` keeps the op node wherever it was traced:

* ``llm_bci::ctc_alpha`` (the loss; no gradient): on a CPU tensor
  :func:`ctc_loss_plain`, the log-space alpha recursion in plain tensor ops
  (a Python loop over T); on a CUDA tensor ``ctc_alpha_kernel``;
* ``llm_bci::ctc_alpha_beta`` (the loss and the occupancy sums ``occ =
  -d loss / d log_probs``): on a CPU tensor :func:`ctc_loss_plain` and
  :func:`ctc_occupancy_plain` (the alpha and beta recursions in float64); on
  a CUDA tensor ``ctc_alpha_beta_kernel``. Its registered backward is the
  multiply ``grad = -grad_loss[b] * occ``.

Any other device has no kernel and raises. The CUDA bodies live in
:mod:`llm_bci_tpu_torch.ops.ctc_cuda`, imported at the first CUDA call.

The label sequence is extended with interleaved blanks,
``z = [blank, y1, blank, y2, ..., yS, blank]`` (length ``2S+1``); the
allowed moves are stay, advance by 1, and advance by 2 (illegal into a
blank or into a label equal to the one two slots back). ``NEG_INF = -1e30``
is a finite sentinel so that ``zero_infinity`` (loss >= 5e29 -> 0) and the
gradient guards behave as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


def _lse3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(torch.maximum(a, b), c)
    dead = m <= NEG_INF
    m_safe = torch.where(dead, torch.zeros_like(m), m)
    # Double where: the dead branch gets finite arguments, so the unselected
    # log/exp path cannot put NaN into the backward pass.
    a_s = torch.where(dead, torch.zeros_like(a), a - m_safe)
    b_s = torch.where(dead, torch.zeros_like(b), b - m_safe)
    c_s = torch.where(dead, torch.zeros_like(c), c - m_safe)
    out = m_safe + torch.log(torch.exp(a_s) + torch.exp(b_s) + torch.exp(c_s))
    return torch.where(dead, torch.full_like(out, NEG_INF), out)


def extended_labels(targets: torch.Tensor, blank_id: int):
    """(B, S) labels -> blank-interleaved ``z`` (B, 2S+1) and the skip
    legality ``can_skip`` (B, 2S+1) of the move s-2 -> s."""
    B, S = targets.shape
    L = 2 * S + 1
    slot = torch.arange(L, device=targets.device)
    label_idx = ((slot - 1) // 2).clamp(0, max(S - 1, 0))
    if S > 0:
        labels = targets[:, label_idx]
    else:
        labels = torch.full((B, L), blank_id, dtype=targets.dtype, device=targets.device)
    z = torch.where(slot % 2 == 1, labels, torch.full_like(labels, blank_id))
    z_shift2 = torch.cat([torch.full_like(z[:, :2], -1), z[:, :-2]], dim=1)
    can_skip = (z != blank_id) & (z != z_shift2)
    return z, can_skip


def ctc_loss_plain(
    log_probs: torch.Tensor,        # (B, T, V) log-softmax normalized
    targets: torch.Tensor,          # (B, S) int labels (padding arbitrary)
    input_lengths: torch.Tensor,    # (B,)
    target_lengths: torch.Tensor,   # (B,)
    blank_id: int = 0,
    zero_infinity: bool = True,
) -> torch.Tensor:                  # (B,)
    """The alpha recursion in plain tensor ops; the kernels' reference."""
    B, T, V = log_probs.shape
    if log_probs.dtype != torch.float64:  # float64 stays: a reference for the kernels
        log_probs = log_probs.float()
    targets = targets.long()
    input_lengths = input_lengths.long()
    target_lengths = target_lengths.long()
    z, can_skip = extended_labels(targets, blank_id)
    L = z.shape[1]
    # Emission lattice: emit[b, t, s] = log_probs[b, t, z[b, s]]
    emit = torch.gather(log_probs, 2, z.clamp(0, V - 1)[:, None, :].expand(B, T, L))
    neg = torch.full((B, L), NEG_INF, device=log_probs.device, dtype=log_probs.dtype)
    skip_gate = torch.where(can_skip, torch.zeros_like(neg), neg)

    slot = torch.arange(L, device=log_probs.device)[None, :]
    reachable0 = (slot == 0) | ((slot == 1) & (target_lengths[:, None] > 0))
    alpha = torch.where(reachable0, emit[:, 0], neg)
    neg1, neg2 = neg[:, :1], neg[:, :2]
    for t in range(1, T):
        adv1 = torch.cat([neg1, alpha[:, :-1]], dim=1)
        adv2 = torch.cat([neg2, alpha[:, :-2]], dim=1) + skip_gate
        new = _lse3(alpha, adv1, adv2) + emit[:, t]
        # Frames past input_length leave alpha untouched.
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)

    last_blank = alpha.gather(1, (2 * target_lengths)[:, None])[:, 0]
    last_label = alpha.gather(1, (2 * target_lengths - 1).clamp(min=0)[:, None])[:, 0]
    last_label = torch.where(
        target_lengths == 0, torch.full_like(last_label, NEG_INF), last_label
    )
    loss = -torch.logaddexp(last_blank, last_label)
    if zero_infinity:
        loss = torch.where(loss >= -NEG_INF / 2, torch.zeros_like(loss), loss)
    return loss


def ctc_occupancy_plain(
    log_probs: torch.Tensor,        # (B, T, V)
    targets: torch.Tensor,          # (B, S)
    input_lengths: torch.Tensor,    # (B,)
    target_lengths: torch.Tensor,   # (B,)
    blank_id: int = 0,
) -> torch.Tensor:                  # (B, T, V) float32
    """``occ[b, t, v] = sum_{s: z_s = v} exp(alpha + beta - emit - log p)``,
    the label posteriors, which are ``-d loss_b / d log_probs[b, t, v]``:
    the alpha and beta recursions in float64 (``ctc_alpha_beta_kernel``'s
    plain version). Zero at frames at and past the input length and for an
    infeasible example."""
    B, T, V = log_probs.shape
    lp = log_probs.double()
    targets = targets.long()
    il = input_lengths.long()
    tl = target_lengths.long()
    z, can_skip = extended_labels(targets, blank_id)
    L = z.shape[1]
    zc = z.clamp(0, V - 1)
    emit = torch.gather(lp, 2, zc[:, None, :].expand(B, T, L))           # (B, T, L)
    neg = torch.full((B, L), NEG_INF, dtype=torch.float64, device=lp.device)
    skip_gate = torch.where(can_skip, torch.zeros_like(neg), neg)
    slot = torch.arange(L, device=lp.device)[None, :]
    neg1, neg2 = neg[:, :1], neg[:, :2]

    alphas = [torch.where((slot == 0) | ((slot == 1) & (tl[:, None] > 0)), emit[:, 0], neg)]
    for t in range(1, T):
        a = alphas[-1]
        adv1 = torch.cat([neg1, a[:, :-1]], dim=1)
        adv2 = torch.cat([neg2, a[:, :-2]], dim=1) + skip_gate
        alphas.append(torch.where((t < il)[:, None], _lse3(a, adv1, adv2) + emit[:, t], a))
    alpha = torch.stack(alphas, dim=1)                                   # (B, T, L)

    # beta[t, s]: the paths from (t, s) to the end, emissions at t included;
    # it starts at the last valid frame in the last blank and the last label.
    ends = (slot == 2 * tl[:, None]) | ((slot == 2 * tl[:, None] - 1) & (tl[:, None] > 0))
    skip_from = torch.cat([skip_gate[:, 2:], neg2], dim=1)   # the move s -> s + 2
    betas = [None] * T
    b = neg
    for t in range(T - 1, -1, -1):
        nxt1 = torch.cat([b[:, 1:], neg1], dim=1)
        nxt2 = torch.cat([b[:, 2:], neg2], dim=1) + skip_from
        inner = _lse3(b, nxt1, nxt2) + emit[:, t]
        start = torch.where(ends, emit[:, t], neg)
        b = torch.where((t == il - 1)[:, None], start,
                        torch.where((t < il - 1)[:, None], inner, neg))
        betas[t] = b
    beta = torch.stack(betas, dim=1)                                     # (B, T, L)

    last = lambda s: alpha[torch.arange(B), (il - 1).clamp(min=0), s.clamp(min=0)]
    log_p = torch.logaddexp(last(2 * tl), torch.where(tl > 0, last(2 * tl - 1),
                                                       torch.full_like(last(2 * tl), NEG_INF)))
    feasible = log_p > NEG_INF / 2
    gamma = torch.exp(alpha + beta - emit - log_p[:, None, None])        # (B, T, L)
    gamma = torch.where(feasible[:, None, None] & (beta > NEG_INF / 2), gamma,
                        torch.zeros_like(gamma))
    occ = torch.zeros((B, T, V), dtype=torch.float64, device=lp.device)
    occ.scatter_add_(2, zc[:, None, :].expand(B, T, L), gamma)
    return occ.float()


# --------------------------------------------------------------- custom ops

@torch.library.custom_op("llm_bci::ctc_alpha", mutates_args=(), device_types="cpu")
def ctc_alpha(log_probs: torch.Tensor, targets: torch.Tensor, input_lengths: torch.Tensor,
              target_lengths: torch.Tensor, blank: int, zero_inf: bool) -> torch.Tensor:
    """The per-example loss, no gradient (``ctc_alpha_kernel`` on CUDA)."""
    return ctc_loss_plain(log_probs, targets, input_lengths, target_lengths, blank,
                          zero_inf).float()


@ctc_alpha.register_kernel("cuda")
def _ctc_alpha_cuda(log_probs, targets, input_lengths, target_lengths, blank, zero_inf):
    from llm_bci_tpu_torch.ops import ctc_cuda

    return ctc_cuda.ctc_alpha_cuda(log_probs, targets, input_lengths, target_lengths, blank,
                                   zero_inf)


@ctc_alpha.register_fake
def _ctc_alpha_fake(log_probs, targets, input_lengths, target_lengths, blank, zero_inf):
    return log_probs.new_empty((log_probs.shape[0],), dtype=torch.float32)


@torch.library.custom_op("llm_bci::ctc_alpha_beta", mutates_args=(), device_types="cpu")
def ctc_alpha_beta(log_probs: torch.Tensor, targets: torch.Tensor,
                   input_lengths: torch.Tensor, target_lengths: torch.Tensor, blank: int,
                   zero_inf: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loss and the occupancy sums ``occ`` (``ctc_alpha_beta_kernel`` on
    CUDA)."""
    loss = ctc_loss_plain(log_probs, targets, input_lengths, target_lengths, blank,
                          zero_inf).float()
    return loss, ctc_occupancy_plain(log_probs, targets, input_lengths, target_lengths, blank)


@ctc_alpha_beta.register_kernel("cuda")
def _ctc_alpha_beta_cuda(log_probs, targets, input_lengths, target_lengths, blank, zero_inf):
    from llm_bci_tpu_torch.ops import ctc_cuda

    return ctc_cuda.ctc_alpha_beta_cuda(log_probs, targets, input_lengths, target_lengths,
                                        blank, zero_inf)


@ctc_alpha_beta.register_fake
def _ctc_alpha_beta_fake(log_probs, targets, input_lengths, target_lengths, blank, zero_inf):
    B, T, V = log_probs.shape
    return (log_probs.new_empty((B,), dtype=torch.float32),
            log_probs.new_empty((B, T, V), dtype=torch.float32))


def _ctc_setup(ctx, inputs, output):
    ctx.save_for_backward(output[1])
    ctx.mark_non_differentiable(output[1])


def _ctc_backward(ctx, grad_loss, _grad_occ):
    (occ,) = ctx.saved_tensors
    return occ * (-grad_loss.to(occ.dtype))[:, None, None], None, None, None, None, None


ctc_alpha_beta.register_autograd(_ctc_backward, setup_context=_ctc_setup)


def ctc_loss(
    log_probs: torch.Tensor,        # (B, T, V) log-softmax normalized
    targets: torch.Tensor,          # (B, S)
    input_lengths: torch.Tensor,    # (B,)
    target_lengths: torch.Tensor,   # (B,)
    blank_id: int = 0,
    zero_infinity: bool = True,
) -> torch.Tensor:                  # (B,) float32
    """Per-example CTC loss through ``llm_bci::ctc_alpha_beta`` when autograd
    will ask for the gradient, else ``llm_bci::ctc_alpha``; the arguments are
    cast to the kernels' dtypes first (float32 log-probs, int32 labels and
    lengths, contiguous)."""
    want_grad = torch.is_grad_enabled() and log_probs.requires_grad
    args = (log_probs.float().contiguous(), targets.to(torch.int32).contiguous(),
            input_lengths.to(torch.int32).contiguous(),
            target_lengths.to(torch.int32).contiguous(), int(blank_id), bool(zero_infinity))
    if want_grad:
        return ctc_alpha_beta(*args)[0]
    return ctc_alpha(*args)
