"""Host-side evaluation utilities of the port, the names that
``llm_bci_tpu/eval/__init__.py`` exports: CTC prefix beam search, WER / CER
and the greedy CTC collapse, bits-per-spike and the regression summaries.
``behaviour_decoding``, ``co_smoothing`` and ``viz_neuron_fit`` are modules
of this package too."""
from llm_bci_tpu_torch.eval.ctc_decode import (  # noqa: F401
    CTCPrefixDecoder,
    ctc_prefix_beam_search,
)
from llm_bci_tpu_torch.eval.eval_bci import (  # noqa: F401
    edit_distance,
    format_ctc,
    smoothed_RMS,
    word_error_count,
    word_edit_distance,
)
from llm_bci_tpu_torch.eval.metrics import (  # noqa: F401
    bits_per_spike,
    metrics_list,
    neg_log_likelihood,
    r2_score_np,
)
