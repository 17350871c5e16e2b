"""PyTorch + CUDA port of ``llm_bci_tpu`` for one NVIDIA H100.

The JAX package ``llm_bci_tpu`` stays the reference; this package mirrors
its module layout and names so each counterpart is easy to find. It imports
``torch`` and never ``jax``, and nothing of ``llm_bci_tpu``: host-side
code that imports no JAX is kept here as a copy under the same relative
name (``config``, ``registry``, ``data``: datasets, speechbci and IBL
loaders, G2P; ``eval.eval_bci``: CER / WER; ``eval.metrics``,
``eval.ctc_decode``, ``eval.viz_neuron_fit``; ``native``: the C edit
distance).

Slice 1 covers NDT1-CTC phoneme decoding trained on speechbci; the CTC
loss runs through hand-written CUDA kernels (``csrc/ctc.cu``). Slice 2
covers NDT1 masked-spike pretraining (``mlm``) and the autoregressive
method at the unstacked length; attention there runs through hand-written
banded flash-attention kernels (``csrc/flash_attention.cu``). Slice 3 serves
and fine-tunes BCI with an int8 base (``csrc/int8_matmul.cu``). ROADMAP slice
6 adds co-smoothing, the IBL loader, PhonemeLLM and ``eval_phonemes``; slice 7
iTransformer, PatchTST and behaviour decoding, their ``ctc`` heads on the CTC
kernels.
"""


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error raised by an option whose port is still an open item of
    ``ROADMAP.md``."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {item})")
