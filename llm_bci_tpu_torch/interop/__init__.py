"""Checkpoint formats of the port.

* ``from_jax``: a JAX param tree (numpy arrays) -> the port's ``state_dict``,
  for the tests that hold the port against the JAX package.
* The port's own component checkpoints (``models/components.py``, BCI's
  ``save_checkpoint``): ``encoder.pt`` / ``decoder.pt`` (BCI: ``llm.pt``,
  ``encoder.pt``, ``projector.pt``), ``torch.save``d ``state_dict``s, beside
  ``{component}_config.yaml``.
* The reference's format (``torch_import`` reads it, ``torch_export`` writes
  it, over one key map a family): ``encoder.bin`` / ``decoder.bin`` /
  ``projector.bin`` state dicts with ``*_config.pth`` torch-pickled configs
  (PatchTST's under ``.yaml`` names), a Hugging Face Llama directory
  (``config.json``, ``model.safetensors``) and a PEFT adapter
  (``adapter_model.safetensors``, ``adapter_config.json``). An import is
  strict: a reference key neither consumed nor on the ignore list
  (``.*num_batches_tracked``, ``encoder\\.embedder\\.padding.*``), a shape
  mismatch, or more layers than the model raises.
* ``safetensors``: the file layout read and written with torch alone.
"""
from llm_bci_tpu_torch.interop.from_jax import (  # noqa: F401
    bci_state_dict_from_jax,
    itransformer_state_dict_from_jax,
    llama_state_dict_from_jax,
    ndt1_state_dict_from_jax,
    patchtst_state_dict_from_jax,
    phoneme_llm_state_dict_from_jax,
)
