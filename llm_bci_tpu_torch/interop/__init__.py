from llm_bci_tpu_torch.interop.from_jax import (  # noqa: F401
    bci_state_dict_from_jax,
    itransformer_state_dict_from_jax,
    llama_state_dict_from_jax,
    ndt1_state_dict_from_jax,
    patchtst_state_dict_from_jax,
    phoneme_llm_state_dict_from_jax,
)
