from llm_bci_tpu_torch.interop.from_jax import ndt1_state_dict_from_jax  # noqa: F401
