"""Multi-device training on ``torch.distributed`` (counterpart of
``llm_bci_tpu/parallel``): the mesh and its layout rules (``mesh.py``),
process start and host collectives (``process.py``), Megatron tensor
parallelism of the Llama decoder (``tensor_parallel.py``), and sequence
parallelism's shard of a sequence and its time-axis gathers
(``sequence.py``)."""
from llm_bci_tpu_torch.parallel.mesh import (  # noqa: F401
    AXES,
    batch_rows,
    fsdp_groups,
    make_mesh,
    mesh_shape,
    tp_layout,
)
