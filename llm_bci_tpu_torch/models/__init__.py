"""Model families of the port; importing this package fills
:data:`llm_bci_tpu_torch.registry.NAME2MODEL`."""
from llm_bci_tpu_torch.models.ndt1 import NDT1  # noqa: F401
from llm_bci_tpu_torch.models.bci import BCI  # noqa: F401
from llm_bci_tpu_torch.models.phoneme_llm import PhonemeLLM  # noqa: F401
from llm_bci_tpu_torch.models.itransformer import iTransformer  # noqa: F401
from llm_bci_tpu_torch.models.patchtst import PatchTSTForSpikingActivity  # noqa: F401
