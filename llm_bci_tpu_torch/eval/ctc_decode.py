# Mirrors llm_bci_tpu/eval/ctc_decode.py (host code that imports no JAX): the port keeps its own copy.
"""Host-side CTC prefix beam search.

A real-time serving loop runs NDT1-CTC on the device (spike window ->
per-frame log-probs) and decodes on the host. Greedy collapse
(``format_ctc``) is the throughput path; this module adds the standard CTC
prefix beam search (Hannun et al. 2014) for accuracy-critical decoding —
beyond the original PyTorch code, which has no CTC decoder at all (it feeds
CTC posteriors to an LLM instead, in its ``eval_phonemes.py``).

Pure numpy on log-probabilities: the lattice math is a per-frame O(B·V)
update over at most ``beam_width`` prefixes — host-side by design, so it
overlaps the next window's device forward.

An optional ``lm`` hook scores label extensions (shallow fusion):
``lm(prefix_tuple, new_label) -> log p(new_label | prefix)``, weighted by
``lm_weight`` — the slot where a phoneme/word LM or lexicon constraint
plugs in.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

NEG_INF = -math.inf


def _logsumexp2(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = a if a > b else b
    return m + math.log1p(math.exp(-abs(a - b)))


def _advance_frame(
    beams: dict,
    frame: np.ndarray,
    beam_width: int,
    blank_id: int,
    lm: Optional[Callable[[Tuple[int, ...], int], float]],
    lm_weight: float,
) -> dict:
    """One lattice step: advance every beam through one frame's
    log-probabilities, then prune to ``beam_width``. ``beams`` maps
    prefix tuple -> (p_blank, p_nonblank): probability of the prefix with
    the last consumed frame being blank / non-blank."""
    V = frame.shape[0]
    new: dict = {}

    def add(prefix, pb, pnb):
        opb, opnb = new.get(prefix, (NEG_INF, NEG_INF))
        new[prefix] = (_logsumexp2(opb, pb), _logsumexp2(opnb, pnb))

    for prefix, (pb, pnb) in beams.items():
        p_total = _logsumexp2(pb, pnb)
        last = prefix[-1] if prefix else None

        # stay on blank: prefix unchanged, ends blank
        add(prefix, p_total + frame[blank_id], NEG_INF)
        # repeat the last label without a blank in between: the frames
        # collapse, prefix unchanged, ends non-blank
        if last is not None:
            add(prefix, NEG_INF, pnb + frame[last])

        for c in range(V):
            if c == blank_id:
                continue
            p_c = frame[c]
            if p_c == NEG_INF:
                continue
            ext = prefix + (c,)
            bonus = lm_weight * lm(prefix, c) if lm is not None else 0.0
            if c == last:
                # extending with the same label needs a blank between
                # the two emissions: only the ends-blank mass extends
                add(ext, NEG_INF, pb + p_c + bonus)
            else:
                add(ext, NEG_INF, p_total + p_c + bonus)

    scored = sorted(
        new.items(),
        key=lambda kv: _logsumexp2(kv[1][0], kv[1][1]),
        reverse=True,
    )
    return dict(scored[:beam_width])


def _n_best(beams: dict, n_best: int) -> List[Tuple[List[int], float]]:
    final = sorted(
        ((list(p), _logsumexp2(pb, pnb)) for p, (pb, pnb) in beams.items()),
        key=lambda kv: kv[1],
        reverse=True,
    )
    return final[:n_best]


def ctc_prefix_beam_search(
    log_probs: np.ndarray,
    beam_width: int = 16,
    blank_id: int = 0,
    n_best: int = 1,
    lm: Optional[Callable[[Tuple[int, ...], int], float]] = None,
    lm_weight: float = 0.0,
) -> List[Tuple[List[int], float]]:
    """Decode one utterance's ``(T, V)`` log-probabilities.

    Returns the ``n_best`` ``(labels, log_prob)`` pairs, best first, where
    ``log_prob`` is the total probability of the label sequence summed
    over ALL frame alignments that collapse to it — the quantity greedy
    collapse approximates with its single best alignment.
    """
    lp = np.asarray(log_probs, dtype=np.float64)
    beams: dict = {(): (0.0, NEG_INF)}
    for frame in lp:
        beams = _advance_frame(beams, frame, beam_width, blank_id, lm, lm_weight)
    return _n_best(beams, n_best)


class CTCPrefixDecoder:
    """Streaming prefix beam search: the stateful host stage of a
    real-time loop.

    A serving loop's NDT1-CTC emits one window of per-frame
    log-probs at a time; ``step(window)`` folds each window into the
    carried beam state, so decoding chunk-by-chunk is EXACTLY the
    one-shot search over the concatenated frames (the lattice recursion
    is frame-local; window boundaries don't exist in the math — blank /
    repeat bookkeeping carries across them). ``step`` returns the current
    best hypothesis, so the UI can render a live transcript while the
    next window's device forward runs.
    """

    def __init__(
        self,
        beam_width: int = 16,
        blank_id: int = 0,
        lm: Optional[Callable[[Tuple[int, ...], int], float]] = None,
        lm_weight: float = 0.0,
    ):
        self.beam_width = beam_width
        self.blank_id = blank_id
        self.lm = lm
        self.lm_weight = lm_weight
        self.reset()

    def reset(self) -> None:
        """Start a new utterance."""
        self._beams = {(): (0.0, NEG_INF)}

    def step(self, log_probs: np.ndarray) -> Tuple[List[int], float]:
        """Fold a ``(T_window, V)`` chunk of frame log-probs into the
        beam state; returns the current best ``(labels, log_prob)``."""
        lp = np.asarray(log_probs, dtype=np.float64)
        if lp.ndim != 2:
            raise ValueError(f"expected (T, V) frame log-probs, got {lp.shape}")
        for frame in lp:
            self._beams = _advance_frame(
                self._beams, frame, self.beam_width, self.blank_id,
                self.lm, self.lm_weight,
            )
        return self.best()

    def best(self) -> Tuple[List[int], float]:
        return self.n_best(1)[0]

    def n_best(self, n: int) -> List[Tuple[List[int], float]]:
        return _n_best(self._beams, n)


def ctc_brute_force(
    log_probs: np.ndarray, blank_id: int = 0
) -> List[Tuple[List[int], float]]:
    """Exact label-sequence posteriors by enumerating every alignment —
    O(V^T), the test oracle for the beam search (tiny shapes only)."""
    lp = np.asarray(log_probs, dtype=np.float64)
    T, V = lp.shape
    totals: dict = {}
    paths = [((), 0.0)]
    for t in range(T):
        paths = [
            (path + (c,), logp + lp[t, c]) for path, logp in paths for c in range(V)
        ]
    for path, logp in paths:
        labels = []
        prev = None
        for c in path:
            if c != blank_id and c != prev:
                labels.append(c)
            prev = c
        key = tuple(labels)
        totals[key] = _logsumexp2(totals.get(key, NEG_INF), logp)
    return sorted(
        ((list(k), v) for k, v in totals.items()), key=lambda kv: kv[1], reverse=True
    )
