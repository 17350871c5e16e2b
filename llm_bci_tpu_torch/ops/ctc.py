"""CTC loss (counterpart of ``llm_bci_tpu/ops/ctc.py``).

Semantics match ``torch.nn.CTCLoss(reduction="none", blank,
zero_infinity)``: one unnormalized negative log-likelihood per example.
:func:`ctc_loss` dispatches on the tensor's device: a CPU tensor goes
through :func:`ctc_loss_plain`, the log-space alpha recursion in plain
tensor ops (a Python loop over T, autograd through it); a CUDA tensor goes
through the hand-written kernels of :mod:`llm_bci_tpu_torch.ops.ctc_cuda`,
and nothing else.

The label sequence is extended with interleaved blanks,
``z = [blank, y1, blank, y2, ..., yS, blank]`` (length ``2S+1``); the
allowed moves are stay, advance by 1, and advance by 2 (illegal into a
blank or into a label equal to the one two slots back). ``NEG_INF = -1e30``
is a finite sentinel so that ``zero_infinity`` (loss >= 5e29 -> 0) and the
gradient guards behave as in the JAX package.
"""
from __future__ import annotations

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


def ctc_loss(
    log_probs: torch.Tensor,
    targets: torch.Tensor,
    input_lengths: torch.Tensor,
    target_lengths: torch.Tensor,
    blank_id: int = 0,
    zero_infinity: bool = True,
) -> torch.Tensor:
    """Per-example CTC loss: the plain version for a CPU tensor, the CUDA
    kernels for a CUDA tensor."""
    if log_probs.device.type == "cpu":
        return ctc_loss_plain(
            log_probs, targets, input_lengths, target_lengths, blank_id, zero_infinity
        )
    if log_probs.device.type != "cuda":
        raise NotImplementedError(f"ctc_loss: no kernel for device {log_probs.device}")
    from llm_bci_tpu_torch.ops.ctc_cuda import ctc_loss_cuda

    return ctc_loss_cuda(
        log_probs, targets, input_lengths, target_lengths, blank_id, zero_infinity
    )
