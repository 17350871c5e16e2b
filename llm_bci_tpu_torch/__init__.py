"""PyTorch + CUDA port of ``llm_bci_tpu`` for one NVIDIA H100.

The JAX package ``llm_bci_tpu`` stays the reference; this package mirrors
its module layout and names so each counterpart is easy to find. It imports
``torch`` and never ``jax``. Host-side code that imports no JAX is shared
with the JAX package as it is: ``config``, ``data`` (datasets, speechbci
loader, G2P), ``eval`` (CER/WER, CTC decoding) and ``native``.

Slice 1 covers NDT1-CTC phoneme decoding trained on speechbci; the CTC
loss runs through a hand-written CUDA kernel (``csrc/ctc.cu``).
"""


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error raised by an option whose port is still an open item of
    ``ROADMAP.md``."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {item})")
