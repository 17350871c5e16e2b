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
kernels. The trainer contract is complete on one device: full-state
checkpoint and resume (``training/checkpoint.py``), ``grad_clip_norm``, remat
(``models/remat.py``) and profiling; ``entry.py`` is the counterpart of
``__graft_entry__.entry()``. Slice 10 adds checkpoint interop: component
checkpoints and ``from_pt`` warm start of NDT1, iTransformer and PatchTST
(``models/components.py``), NDT1's ``endtoend``, and import and export of the
reference's PyTorch checkpoint format (``interop/torch_import.py``,
``interop/torch_export.py``, ``interop/safetensors.py``). Slice 11 exports
decodes and forwards as ``torch.export`` archives (``serving.py``). Slice 8
trains on several devices with ``torch.distributed`` (``parallel/``: the
``(data, fsdp, sp, tp)`` mesh, FSDP2, Megatron tensor parallelism of the
Llama decoder, ``torchrun`` launch); slices 12-14 add sequence parallelism
(``sp > 1``, ``parallel/sequence.py``) for every family. Slices 15 and 16
add chained train steps replayed from CUDA graphs (``training/step_graph.py``,
captured under NCCL too) and the device batch pool
(``training/batch_cache.py``), in one process and under a process group.
"""
