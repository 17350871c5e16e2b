"""Autoregressive decoding: greedy, beam search, diverse beam search
(counterpart of ``llm_bci_tpu/models/generation.py``).

The prompt is consumed in one eager prefill call, then ``max_new_tokens``
tokens are chosen one token step at a time. The JAX package runs those steps
under ``lax.scan`` in one compiled program; here every step goes through the
static buffers of a :class:`~llm_bci_tpu_torch.models.decode_graph.TokenStep`
(token embeddings, the key mask and KV cache of ``P + max_new_tokens`` slots,
a 0-dim position tensor, the logits), which on the card captures the step
once as a CUDA graph and replays it for every later token. Nothing inside a
loop reads a value back to the host (no ``.item()``, no branch on a tensor).
The model call after the last token, which the scan makes and throws away,
is not made: ``max_new_tokens`` tokens cost one prefill and
``max_new_tokens - 1`` token steps.

Beam search follows HF ``BeamSearchScorer`` semantics:

- finished hypotheses are collected into a per-batch top-K set the moment a
  beam emits EOS, with the length penalty applied at finish time
  (``score / n_new_tokens ** length_penalty``);
- live beams are refilled from the top-2K candidates that did not emit EOS;
- ``early_stopping=True`` freezes a batch's hypothesis set as soon as K
  hypotheses exist; ``early_stopping=False`` additionally requires that the
  best attainable live score can no longer beat the worst finished one;
- at the end, still-live beams of unfinished batches are merged into the set
  and all K hypotheses are returned sorted by score.

``diverse_beam_search`` is HF group beam search with ``num_beam_groups ==
num_beams`` (group size 1) and ``diversity_penalty``: within a step the
groups pick tokens one after the other, each penalized by the count of the
tokens that earlier groups chose at that step.

``decode_step(embeds, attention_mask, cache, cache_index) -> (logits, cache)``
is the model hook: ``cache_index`` is the int 0 for the prefill and the
token step's 0-dim position tensor afterwards; the cache is updated in place.
``cache`` is a new cache of ``P + max_new_tokens`` slots; the decode's
:class:`TokenStep` takes it as its static cache and lives as long as the
decode. ``embed_tokens`` maps chosen ids back to embeddings. Token ids are
int64. :func:`decode` picks the loop and shapes its result; ``BCI.generate``
calls it with the model's own step, and a serving archive's loader
(``serving.load_decode``) with the archive's exported programs.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from llm_bci_tpu_torch.models.decode_graph import TokenStep

NEG_INF = -1e9


def _top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of the last dim, ties to the lower index (the order
    of ``lax.top_k``): a stable sort, for the small merges whose ``NEG_INF``
    fill values do tie."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _prefill(decode_step, inputs_embeds, attn_mask_prompt, cache, total_len):
    """Run the prompt through the model once; returns ``(last_logits, step)``
    with ``step`` the :class:`TokenStep` over the filled cache and the (B,
    total_len) validity mask of its keys."""
    B, P, _ = inputs_embeds.shape
    step = TokenStep(decode_step, cache, attn_mask_prompt.new_zeros((B, total_len)))
    step.key_mask[:, :P] = attn_mask_prompt
    logits, _ = decode_step(inputs_embeds, step.key_mask, step.cache, 0)
    return logits[:, -1, :], step


@torch.no_grad()
def greedy_decode(
    decode_step: Callable,
    embed_tokens: Callable,
    inputs_embeds: torch.Tensor,     # (B, P, H)
    attention_mask: torch.Tensor,    # (B, P)
    cache,
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int,
) -> torch.Tensor:                   # (B, max_new_tokens)
    B, P, _ = inputs_embeds.shape
    logits, step = _prefill(decode_step, inputs_embeds, attention_mask, cache, P + max_new_tokens)
    tokens = torch.full((B, max_new_tokens), pad_token_id, dtype=torch.long,
                        device=inputs_embeds.device)
    done = torch.zeros((B,), dtype=torch.bool, device=inputs_embeds.device)
    for t in range(max_new_tokens):
        token = torch.argmax(logits, dim=-1)
        token = torch.where(done, torch.full_like(token, pad_token_id), token)
        done = done | (token == eos_token_id)
        tokens[:, t] = token
        if t + 1 == max_new_tokens:
            break
        step.key_mask[:, P + t] = 1
        logits = step(embed_tokens(token[:, None]), P + t)
    return tokens


class BeamResult(NamedTuple):
    """All hypotheses, sorted best-first per batch element."""

    sequences: torch.Tensor       # (B, K, max_new_tokens) int64, pad-filled
    scores: torch.Tensor          # (B, K) length-penalized log-prob


def _gather_beams(x: torch.Tensor, beam_idx: torch.Tensor, B: int, K_src: int) -> torch.Tensor:
    """x: (B*K_src, ...); beam_idx: (B, K_dst) indices into the K_src dim."""
    base = torch.arange(B, device=x.device)[:, None] * K_src
    return x.index_select(0, (base + beam_idx).reshape(-1))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, j]]`` for x (B, K, T) and idx (B, J)."""
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


@torch.no_grad()
def beam_search(
    decode_step: Callable,
    embed_tokens: Callable,
    inputs_embeds: torch.Tensor,     # (B, P, H)
    attention_mask: torch.Tensor,    # (B, P)
    cache,                           # batch dim B * num_beams
    max_new_tokens: int,
    num_beams: int,
    eos_token_id: int,
    pad_token_id: int,
    length_penalty: float = 1.0,
    early_stopping: bool = False,
) -> BeamResult:
    """HF-semantics beam search; returns all ``num_beams`` hypotheses per
    batch element sorted by penalized score (see the module docstring). The
    live beams' cache rows and key mask are reordered every step, gathered and
    copied back into the token step's static buffers."""
    B, P, _ = inputs_embeds.shape
    K = num_beams
    dev = inputs_embeds.device
    expand = lambda x: x.repeat_interleave(K, dim=0)

    logits, step = _prefill(
        decode_step, expand(inputs_embeds), expand(attention_mask), cache, P + max_new_tokens)
    log_probs = torch.log_softmax(logits, dim=-1)                 # (B*K, V)
    V = log_probs.shape[-1]

    # Only beam 0 is live at t = 0, so the K identical prompt copies do not tie.
    live_scores = torch.tensor([0.0] + [NEG_INF] * (K - 1), device=dev).repeat(B, 1)
    live_tokens = torch.full((B, K, max_new_tokens), pad_token_id, dtype=torch.long, device=dev)
    fin_scores = torch.full((B, K), NEG_INF, device=dev)
    fin_tokens = live_tokens.clone()
    stopped = torch.zeros((B,), dtype=torch.bool, device=dev)
    rank_ok = (torch.arange(2 * K, device=dev) < K)[None, :]
    neg_inf = torch.full((), NEG_INF, device=dev)

    for t in range(max_new_tokens):
        pen_div = float(t + 1) ** length_penalty
        cand = (live_scores[:, :, None] + log_probs.view(B, K, V)).view(B, K * V)
        top_scores, top_idx = torch.topk(cand, 2 * K, dim=-1)     # (B, 2K), sorted
        src_beam = top_idx // V
        token = top_idx % V
        is_eos = token == eos_token_id

        # Candidate token buffers: the source beam's tokens with `token` at t
        # (EOS included, as HF's finalize appends it).
        cand_tokens = _take(live_tokens, src_beam)                # (B, 2K, T)
        cand_tokens[:, :, t] = token

        # Finished set: EOS candidates among the top K of the sorted 2K,
        # penalized at finish time.
        pen = torch.where(is_eos & rank_ok & ~stopped[:, None], top_scores / pen_div, neg_inf)
        fin_scores, keep = _top_k_stable(torch.cat([fin_scores, pen], dim=1), K)
        fin_tokens = _take(torch.cat([fin_tokens, cand_tokens], dim=1), keep)

        # Live refill: the best K candidates of the 2K that are not EOS.
        live_scores, pick = _top_k_stable(torch.where(is_eos, neg_inf, top_scores), K)
        live_src = torch.gather(src_beam, 1, pick)                # (B, K)
        live_tok = torch.gather(token, 1, pick)                   # (B, K)
        live_tokens = _take(live_tokens, live_src)
        live_tokens[:, :, t] = live_tok

        # Stopping (HF BeamHypotheses.is_done).
        have_k = fin_scores[:, K - 1] > NEG_INF / 2
        if early_stopping:
            stopped = stopped | have_k
        else:
            best_possible = live_scores[:, 0] / pen_div
            stopped = stopped | (have_k & (fin_scores[:, K - 1] >= best_possible))

        if t + 1 == max_new_tokens:
            break
        # One decode step for the refilled live beams.
        for buf in [step.key_mask] + [c for layer in step.cache for c in layer.values()]:
            buf.copy_(_gather_beams(buf, live_src, B, K))
        step.key_mask[:, P + t] = 1
        log_probs = torch.log_softmax(step(embed_tokens(live_tok.reshape(B * K, 1)), P + t),
                                      dim=-1)

    # Finalize: merge the still-live beams of unfinished batches.
    pen_live = torch.where(stopped[:, None], neg_inf,
                           live_scores / (float(max_new_tokens) ** length_penalty))
    scores, keep = _top_k_stable(torch.cat([fin_scores, pen_live], dim=1), K)
    sequences = _take(torch.cat([fin_tokens, live_tokens], dim=1), keep)
    return BeamResult(sequences=sequences, scores=scores)


@torch.no_grad()
def diverse_beam_search(
    decode_step: Callable,
    embed_tokens: Callable,
    inputs_embeds: torch.Tensor,     # (B, P, H)
    attention_mask: torch.Tensor,    # (B, P)
    cache,                           # batch dim B * num_beams
    max_new_tokens: int,
    num_beams: int,
    eos_token_id: int,
    pad_token_id: int,
    length_penalty: float = 1.0,
    diversity_penalty: float = 1.0,
) -> BeamResult:
    """HF group beam search with one beam per group. Per step, group g's
    log-probs are penalized by ``diversity_penalty * count`` of each token
    among the selections of groups 0..g-1 at this step. Each group keeps one
    finished hypothesis (penalized at finish time); a group whose live beam
    emits EOS continues with its runner-up candidate. Returns all G
    hypotheses sorted. Every group continues its own beam, so the cache is
    never reordered."""
    B, P, _ = inputs_embeds.shape
    G = num_beams
    dev = inputs_embeds.device
    expand = lambda x: x.repeat_interleave(G, dim=0)

    logits, step = _prefill(
        decode_step, expand(inputs_embeds), expand(attention_mask), cache, P + max_new_tokens)
    log_probs = torch.log_softmax(logits, dim=-1)                 # (B*G, V)
    V = log_probs.shape[-1]

    live_scores = torch.zeros((B, G), device=dev)
    live_tokens = torch.full((B, G, max_new_tokens), pad_token_id, dtype=torch.long, device=dev)
    fin_scores = torch.full((B, G), NEG_INF, device=dev)
    fin_tokens = live_tokens.clone()
    done = torch.zeros((B, G), dtype=torch.bool, device=dev)      # group finished
    neg_inf = torch.full((), NEG_INF, device=dev)

    for t in range(max_new_tokens):
        pen_div = float(t + 1) ** length_penalty
        lp_groups = log_probs.view(B, G, V)
        # Sequential group selection with cumulative diversity counts.
        freq = torch.zeros((B, V), device=dev)
        toks, scores, fin_cands = [], [], []
        for g in range(G):
            done_g = done[:, g]
            scores_g = live_scores[:, g, None] + lp_groups[:, g, :] - diversity_penalty * freq
            top2_scores, top2_tok = torch.topk(scores_g, 2, dim=-1)
            is_eos1 = top2_tok[:, 0] == eos_token_id
            # live continuation: the runner-up if the best is EOS
            live_tok_g = torch.where(is_eos1, top2_tok[:, 1], top2_tok[:, 0])
            live_score_g = torch.where(is_eos1, top2_scores[:, 1], top2_scores[:, 0])
            # The EOS pick is a candidate finished hypothesis while the
            # group is still decoding; the group goes on with the runner-up
            # and may later replace the stored hypothesis.
            fin_cands.append(torch.where(is_eos1 & ~done_g, top2_scores[:, 0] / pen_div, neg_inf))
            # groups stopped by is_done keep emitting pad at a frozen score
            live_tok_g = torch.where(done_g, torch.full_like(live_tok_g, pad_token_id),
                                     live_tok_g)
            live_score_g = torch.where(done_g, live_scores[:, g], live_score_g)
            # the selected (live) token counts toward later groups' penalty
            freq.scatter_add_(1, live_tok_g[:, None], (~done_g).to(freq.dtype)[:, None])
            toks.append(live_tok_g)
            scores.append(live_score_g)
        live_tok = torch.stack(toks, dim=1)                       # (B, G)
        new_live_scores = torch.stack(scores, dim=1)
        fin_cand = torch.stack(fin_cands, dim=1)

        # Each group holds at most one finished hypothesis: replace if better.
        eos_tokens = live_tokens.clone()
        eos_tokens[:, :, t] = eos_token_id                        # hypothesis + EOS at t
        better = fin_cand > fin_scores
        fin_scores = torch.where(better, fin_cand, fin_scores)
        fin_tokens = torch.where(better[:, :, None], eos_tokens, fin_tokens)

        # HF BeamHypotheses.is_done (early_stopping=False): the group stops
        # when its stored hypothesis can no longer be beaten by the best
        # attainable penalized score of its live beam.
        has_fin = fin_scores > NEG_INF / 2
        done = done | (has_fin & (fin_scores >= new_live_scores / pen_div))

        live_scores = new_live_scores
        live_tokens[:, :, t] = live_tok

        if t + 1 == max_new_tokens:
            break
        step.key_mask[:, P + t] = 1
        log_probs = torch.log_softmax(step(embed_tokens(live_tok.reshape(B * G, 1)), P + t),
                                      dim=-1)

    # Finalize per group: the finished hypothesis if any, else the live beam.
    pen_live = live_scores / (float(max_new_tokens) ** length_penalty)
    use_fin = fin_scores > NEG_INF / 2
    scores = torch.where(use_fin, fin_scores, pen_live)
    sequences = torch.where(use_fin[:, :, None], fin_tokens, live_tokens)
    order = torch.argsort(-scores, dim=1, stable=True)
    return BeamResult(sequences=_take(sequences, order), scores=torch.gather(scores, 1, order))


def check_generation_args(num_beams: int, num_return_sequences: int,
                          num_beam_groups: int) -> None:
    if num_return_sequences > num_beams:
        raise ValueError("num_return_sequences must be <= num_beams")
    if num_beam_groups > 1 and num_beam_groups != num_beams:
        raise ValueError("only num_beam_groups == num_beams (group size 1) is supported")


def decode(
    decode_step: Callable,
    embed_tokens: Callable,
    inputs_embeds: torch.Tensor,     # (B, P, H)
    attention_mask: torch.Tensor,    # (B, P)
    cache,                           # batch dim B * max(num_beams, 1), P + max_new_tokens slots
    max_new_tokens: int,
    num_beams: int = 1,
    pad_token_id: int = 0,
    eos_token_id: int = 2,
    length_penalty: float = 1.0,
    early_stopping: bool = False,
    num_return_sequences: int = 1,
    num_beam_groups: int = 1,
    diversity_penalty: float = 0.0,
):
    """Greedy (``num_beams=1``), beam search or diverse beam search
    (``num_beam_groups == num_beams > 1``) from a prepared prompt. ``(B,
    max_new_tokens)`` ids when ``num_return_sequences == 1``, else a
    :class:`BeamResult` of the best ``num_return_sequences`` hypotheses."""
    check_generation_args(num_beams, num_return_sequences, num_beam_groups)
    common = (decode_step, embed_tokens, inputs_embeds, attention_mask, cache, max_new_tokens)
    if num_beams <= 1:
        return greedy_decode(*common, eos_token_id, pad_token_id)
    if num_beam_groups > 1:
        result = diverse_beam_search(*common, num_beams, eos_token_id, pad_token_id,
                                     length_penalty, diversity_penalty)
    else:
        result = beam_search(*common, num_beams, eos_token_id, pad_token_id, length_penalty,
                             early_stopping)
    if num_return_sequences == 1:
        return result.sequences[:, 0]
    return BeamResult(sequences=result.sequences[:, :num_return_sequences],
                      scores=result.scores[:, :num_return_sequences])
