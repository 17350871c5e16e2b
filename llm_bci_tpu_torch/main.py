"""CLI train entry point of the port:
``python -m llm_bci_tpu_torch.main -c configs/trainer_ctc_ndt1.yaml -k a.b=1 ...``
(NDT1-CTC on speechbci files), ``-c configs/trainer_ssl_ndt1.yaml`` (NDT1
masked-spike pretraining on an IBL session saved with ``datasets``, or with
``-k data.data_load=file ...`` on a pickle ``{split: [{"spikes": (T, N)
float32, ...}]}``), ``-c configs/trainer_bci.yaml`` (the BCI LoRA fine-tune)
or ``-c configs/trainer_{ssl,choice,wheel}_itransformer.yaml`` (iTransformer
pretraining, choice classification, wheel-speed regression; a PatchTST run
takes ``model: include:configs/patchtst.yaml``).

The counterpart of the repo's ``main.py`` (which imports the JAX trainer):
the same configs and dotted ``-k`` overrides, the ``file``, ``ibl`` and
``speechbci`` datasets (G2P phoneme labels through ``data.vocab_file``),
the CTC CER metric fns, the ``endtoend`` assisted-WER metric fn,
``method.model_kwargs`` (``method_name``, ``loss``, ``log_input``, ``lora``,
``quantize`` ...) handed to the model, and the config surgery that depends on
the dataset: ``n_channels`` for NDT1 and BCI; for a region-aware
iTransformer the region vocabulary (``list(set(...))`` of the names, as the
JAX CLI builds it), which also becomes every masker's target and mask
regions, and the integer ``neuron_regions_idx`` columns; for
``stat_behaviour`` with ``xent`` the labels remapped to contiguous classes,
``n_labels`` and the ``accuracy`` metric fn; iTransformer's ``max_n_bins``
and PatchTST's ``num_input_channels`` and ``context_length`` (the longest
trial, rounded up to a multiple of ``patch_length``) pinned, and the spikes
left-padded to that context. PhonemeLLM goes to the trainer unchanged, as in
the JAX CLI. ``transformers`` (the tokenizer) is imported only when
``data.tokenizer_path`` is set, ``datasets`` only by the ``ibl`` loader.
``--device`` defaults to CUDA; the trainer raises when there is no card.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import List, Optional

import numpy as np

from llm_bci_tpu_torch.config import (
    DictConfig,
    ParseKwargs,
    config_from_kwargs,
    resolve_path,
    update_config,
)
from llm_bci_tpu_torch.data.ibl import load_ibl_dataset
from llm_bci_tpu_torch.data.speechbci import (
    create_llm_labels,
    create_phonemes_ctc_labels,
    load_competition_data,
)
from llm_bci_tpu_torch.eval.eval_bci import format_ctc, word_error_count
from llm_bci_tpu_torch import not_ported
from llm_bci_tpu_torch.models.itransformer import region_names_to_idx
from llm_bci_tpu_torch.training.trainer import Trainer, default_trainer_config


def make_cer_fns(vocab, blank_id: int):
    """(train CER with a ``prepare`` hook, eval CER that prints examples)."""

    def cer(model, model_inputs, unused_inputs, outputs, **kwargs):
        # argmax on the device, then one host copy of (B, T') ints
        prepared = kwargs.get("prepared")
        preds = (
            prepared if prepared is not None
            else outputs["preds"].argmax(-1).cpu().numpy()
        )
        pred_strs = [" ".join(format_ctc(p, vocab, blank_id)) for p in preds]
        phonemes = [" ".join(p) for p in unused_inputs["phonemes"]]
        errors, n_phonemes = word_error_count(pred_strs, phonemes)
        for i in range(min(kwargs.get("n_print", 0), len(pred_strs))):
            print(
                pred_strs[i].replace(" ", "").replace("SIL", " SIL "), "\n#####\n ",
                phonemes[i].replace(" ", "").replace("SIL", " SIL "), "\n#####\n ",
                unused_inputs["sentence"][i], "\n#####\n\n ",
            )
        return errors / n_phonemes

    def train_cer(model, model_inputs, unused_inputs, outputs, **kwargs):
        return cer(model, model_inputs, unused_inputs, outputs, **{**kwargs, "n_print": 0})

    train_cer.prepare = lambda outputs: outputs["preds"].argmax(-1)
    return train_cer, cer


def make_assisted_wer_fn(tokenizer):
    """Teacher-forced ("assisted") WER: the argmax at every sentence position,
    decoded and scored against the sentence. Its ``prepare`` hook takes the
    argmax on the device."""

    def assisted_wer(model, model_inputs, unused_inputs, outputs, **kwargs):
        prepared = kwargs.get("prepared")
        preds = (
            prepared if prepared is not None
            else outputs["preds"].argmax(-1).cpu().numpy()
        )[:, :-1]
        targets = outputs["targets"].cpu().numpy()[:, 1:]
        pred_sentences = [
            tokenizer.decode(p[t != -100], skip_special_tokens=True)
            for t, p in zip(targets, preds)
        ]
        errors, n_words = word_error_count(pred_sentences, unused_inputs["sentence"])
        return errors / n_words

    assisted_wer.prepare = lambda outputs: outputs["preds"].argmax(-1)
    return assisted_wer


def accuracy(model, model_inputs, unused_inputs, outputs, **kwargs):
    """Share of the batch whose argmax class is the target; ``prepare`` takes
    the argmax on the device."""
    prepared = kwargs.get("prepared")
    preds = (
        prepared if prepared is not None
        else outputs["preds"].argmax(-1).cpu().numpy()
    )
    targets = np.asarray(model_inputs["targets"])[:, 0]
    return (preds == targets).sum() / preds.shape[0]


accuracy.prepare = lambda outputs: outputs["preds"].argmax(-1)


def set_region_vocabulary(config, dataset) -> None:
    """The region vocabulary of a region-aware iTransformer: every masker's
    target and mask regions, and ``neuron_regions_idx`` columns in the rows.
    Its order is the JAX CLI's, that of a ``set`` of strings."""
    all_regions = list(set(
        str(b) for rows in dataset.values() for row in rows for b in row["neuron_regions"]
    ))
    config["model"]["encoder"]["regions"] = all_regions
    for key in config["model"]["masker"].keys():
        config["model"]["masker"][key]["target_regions"] = all_regions
        config["model"]["masker"][key]["mask_regions"] = all_regions
    for rows in dataset.values():
        region_names_to_idx(rows, all_regions)


def remap_labels(config, dataset) -> None:
    """Static behaviour labels -> contiguous classes 0..n-1 (in the order of
    a ``set`` of the ints, as the JAX CLI enumerates them) and ``n_labels``."""
    beh = config.method.dataset_kwargs.targets_name
    all_labels = set(int(row[beh][0]) for rows in dataset.values() for row in rows)
    l_to_i = {label: i for i, label in enumerate(all_labels)}
    for rows in dataset.values():
        for row in rows:
            row[beh] = np.atleast_1d([l_to_i[int(row[beh][0])]])
    config["method"]["model_kwargs"]["n_labels"] = len(all_labels)


def pin_context(config, dataset):
    """iTransformer's ``max_n_bins`` (the longest trial) or PatchTST's
    ``num_input_channels`` and ``context_length`` (the longest trial rounded
    up to a multiple of ``patch_length``), and the spikes, their mask and
    timestamps left-padded to exactly that context. Returns the config."""
    spikes_name = (
        "spikes" if "spikes" in dataset["train"][0]
        else config.method.dataset_kwargs.spikes_name
    )
    longest = max(row[spikes_name].shape[0] for rows in dataset.values() for row in rows)
    if config.model.model_class == "PatchTST":
        config["model"]["encoder"]["num_input_channels"] = dataset["train"][0][
            spikes_name].shape[1]
        p = config.model.encoder.patch_length
        context = ((longest + p - 1) // p) * p
        config["model"]["encoder"]["context_length"] = context
    else:
        context = longest
        config["model"]["encoder"]["embedder"]["max_n_bins"] = context
    pad_spec = {"dim": 0, "side": "left", "value": 0, "truncate": context,
                "min_length": context}
    return update_config(config, DictConfig({"method": {"dataloader_kwargs": {"pad_dict": {
        key: dict(pad_spec) for key in ("spikes", "spikes_mask", "spikes_timestamp")}}}}))


def build_trainer(args: argparse.Namespace, dataset=None, tokenizer=None) -> Trainer:
    """The ``Trainer`` that ``args`` describe: config merge, dataset, metric
    fns, model. ``dataset`` (and, for ``endtoend``, its ``tokenizer``) may be
    handed in ready-made, pre-tokenized; they are then not loaded from
    ``config.data``."""
    config = update_config(
        default_trainer_config(), args.config_file if args.config_file != "none" else None
    )
    config = update_config(config, config_from_kwargs(args.kwargs))
    method = config.method.model_kwargs.get("method_name")
    metric_fns, eval_metric_fns = {}, {}
    vocab = None

    if dataset is not None:
        pass
    elif config.data.data_load == "file":
        path = os.path.join(config.data.data_dir, config.data.data_file)
        if not path.endswith((".pkl", ".pickle")):
            raise not_ported(f"data_load 'file' for {path!r} (pickles only)",
                             "Queue 1, slice 1, item 6")
        with open(path, "rb") as f:
            dataset = pickle.load(f)
    elif config.data.data_load == "speechbci":
        dataset = load_competition_data(**config.data)
        if config["data"].get("vocab_file"):
            vocab_file = resolve_path(config.data.vocab_file)
            with open(vocab_file) as f:
                vocab = json.load(f)
            oov = "lts" if config["data"].get("allow_g2p_fallback") else str(
                config["data"].get("g2p_oov", "warn")
            )
            dataset = create_phonemes_ctc_labels(dataset, vocab_file, oov=oov)
        if config["data"].get("tokenizer_path"):
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(
                config.data.tokenizer_path, add_bos_token=False, add_eos_token=False
            )
            dataset = create_llm_labels(dataset, tokenizer, config.data.prompt)
    elif config.data.data_load == "ibl":
        dataset = load_ibl_dataset(**config.data)
    else:
        raise ValueError(f"Unknown data_load {config.data.data_load!r}")

    model_class = config.model.model_class
    if model_class == "iTransformer" and config.model.encoder.embed_region:
        set_region_vocabulary(config, dataset)
    if method == "stat_behaviour" and config.method.model_kwargs.get("loss") == "xent":
        remap_labels(config, dataset)
        metric_fns["accuracy"] = accuracy

    if method == "ctc":
        if vocab is None:
            print("CTC method without data.vocab_file: skipping the CER metric.", flush=True)
        else:
            metric_fns["CER"], eval_metric_fns["CER"] = make_cer_fns(
                vocab, config.method.model_kwargs.blank_id
            )
    elif method == "endtoend":
        if tokenizer is None:
            print("endtoend method without a tokenizer: skipping the A-WER metric.", flush=True)
        else:
            metric_fns["A-WER"] = make_assisted_wer_fn(tokenizer)

    if model_class in ("iTransformer", "PatchTST"):
        config = pin_context(config, dataset)
    elif model_class == "NDT1":
        config["model"]["encoder"]["embedder"]["n_channels"] = dataset["train"][0][
            "spikes"].shape[1]
    elif model_class == "BCI":
        # flax infers the input width at init; here the embedder needs it
        config["model"]["ndt1"]["encoder"]["embedder"]["n_channels"] = dataset["train"][0][
            "spikes"].shape[1]

    return Trainer(
        config, dataset=dataset, metric_fns=metric_fns or None,
        eval_metric_fns=eval_metric_fns or None, device=args.device,
    )


def main(args: argparse.Namespace, dataset=None, tokenizer=None) -> Trainer:
    """Build the trainer (:func:`build_trainer`) and train."""
    trainer = build_trainer(args, dataset, tokenizer)
    trainer.train()
    return trainer


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config_file", type=str, default="none",
                        help="File (.yaml) with configuration for training")
    parser.add_argument("-k", "--kwargs", nargs="*", action=ParseKwargs)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; no card raises)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
