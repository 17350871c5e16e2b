"""WER evaluation of a saved BCI checkpoint of the port: batch-1 generation
and decoding (counterpart of the repo's ``eval_phonemes.py``).

Reloads the ``trainer_config.yaml`` saved with a checkpoint of the port's
``Trainer`` (or a reference checkpoint's torch-pickled ``trainer_config.pth``,
whose ``encoder.bin`` / ``projector.bin`` / LLM files then import on load),
rebuilds the trainer with ``test_batch_size=1``, and drives
``trainer.evaluate`` with a WER metric fn that strips the target sentence and
the pad (unk) tokens from the prompt, generates with diverse beam search (one
group a beam, ``diversity_penalty`` 1.2, every beam returned) or greedily,
decodes, and counts word errors. Each token step of a decode replays one CUDA
graph on the card (``models/decode_graph.py``).

Usage::

  python -m llm_bci_tpu_torch.eval_phonemes -k from_pt=checkpoints/bci/STEP500 \\
      beams=5 savestring=wer_run test_len=50
  # a beam sweep in one process, writing <savestring>_<k>.pkl per beam size
  # (the naming analyze_cli groups on):
  python -m llm_bci_tpu_torch.eval_phonemes -k from_pt=... beams=1,3,5,10,25,50
  # serve the frozen base int8 (weight-only), also from a bf16-trained
  # checkpoint: its float kernels are quantized as they load
  python -m llm_bci_tpu_torch.eval_phonemes -k from_pt=... quantize=int8
  # offline analysis of saved predictions
  python -m llm_bci_tpu_torch.eval_phonemes --analyze -k preds=a_1.pkl,a_5.pkl \\
      tokenizer_path=... out_dir=plots/bci

The JAX script's persistent compilation cache (``setup_compilation_cache``,
``-k compilation_cache=``) has no counterpart: nothing here is compiled ahead
of a run, and each decode captures its own token step.
``transformers`` is imported only to load a tokenizer that was not handed in,
``matplotlib`` only by :func:`analyze`.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import pickle
import time

import numpy as np
import torch

from llm_bci_tpu_torch.config import DictConfig, ParseKwargs, config_from_kwargs
from llm_bci_tpu_torch.interop.torch_import import load_saved_component_config
from llm_bci_tpu_torch.data.speechbci import create_llm_labels, load_competition_data
from llm_bci_tpu_torch.eval.eval_bci import word_error_count
from llm_bci_tpu_torch.training.trainer import Trainer

GEN_COLUMNS = ("input_split", "spikes", "spikes_mask", "spikes_timestamp", "spikes_lengths",
               "block_idx", "day_idx")


def prompt_ids(model_inputs, unk_id: int) -> np.ndarray:
    """The prompt of a batch of one: the positions whose target is -100 (the
    sentence's tokens are cut) and whose token is not the pad (unk) token,
    which also carries -100 on the right padding."""
    input_ids = np.asarray(model_inputs["input_ids"])
    targets = np.asarray(model_inputs["targets"])
    keep = (targets[0] == -100) & (input_ids[0] != unk_id)
    return input_ids[:, keep]


def make_wer_fn(tokenizer, run: dict, autocast=None):
    """The WER metric fn. It appends each ``(tokens, target sentence)`` to
    ``run["preds"]`` and rewrites the pickle at ``run["path"]`` (both set per
    beam size); ``autocast()`` is the trainer's, around each decode."""

    def wer(model, model_inputs, unused_inputs, outputs, **kw):
        dev = next(model.parameters()).device
        unk_id = tokenizer.unk_token_id or 0
        ids = torch.from_numpy(prompt_ids(model_inputs, unk_id)).to(dev)
        gen_inputs = {k: torch.from_numpy(np.asarray(v)).to(dev)
                      for k, v in model_inputs.items() if k in GEN_COLUMNS}
        n_beams = int(kw.get("n_beams", 1))
        with autocast() if autocast is not None else contextlib.nullcontext():
            # one group a beam, diversity_penalty 1.2, every beam returned for
            # the offline best-of-k analysis
            result = model.generate(
                input_ids=ids, attention_mask=torch.ones_like(ids), **gen_inputs,
                max_new_tokens=20, num_beams=n_beams, num_return_sequences=n_beams,
                num_beam_groups=n_beams if n_beams > 1 else 1,
                diversity_penalty=1.2 if n_beams > 1 else 0.0,
                pad_token_id=tokenizer.unk_token_id or 0,
                eos_token_id=tokenizer.eos_token_id or 2,
            )
        tokens = (result.sequences[0] if n_beams > 1 else result).cpu().numpy()
        pred_sentence = tokenizer.decode(tokens[0], skip_special_tokens=True).strip()
        target_sentence = unused_inputs["sentence"][0]
        errors, n_words = word_error_count(pred_sentence, target_sentence)
        print("-" + pred_sentence + "-", "\n#####\n")
        print("-" + target_sentence + "-", "\n#####\n\n ")
        run["preds"].append((tokens, target_sentence))
        with open(run["path"], "wb") as f:
            pickle.dump(run["preds"], f)
        return errors / n_words

    return wer


def main(args: argparse.Namespace, dataset=None, tokenizer=None):
    """Evaluate ``-k from_pt=<checkpoint>`` at each beam size of ``beams``;
    returns the metrics dict, with the ``seconds`` the evaluation took (or
    ``{beams: metrics}`` for a sweep).
    ``dataset`` (pre-tokenized) and ``tokenizer`` may be handed in ready-made;
    otherwise they are loaded from the saved ``config.data``."""
    kwargs = config_from_kwargs(args.kwargs)
    beam_list = [int(b) for b in str(kwargs.get("beams", 1)).split(",") if str(b).strip()]
    from_pt = kwargs.get("from_pt")
    if not from_pt:
        raise SystemExit("pass -k from_pt=<checkpoint dir containing trainer_config.yaml>")
    savestring = kwargs.get("savestring", "test_decoding")
    # the port's trainer_config.yaml, or a reference checkpoint's
    # torch-pickled trainer_config.pth (its weights import on load)
    saved = load_saved_component_config(from_pt, "trainer")
    if saved is None:
        raise SystemExit(f"{from_pt}: no trainer_config.yaml/.pth found")
    config = DictConfig(saved)
    config["model"]["from_pt"] = from_pt
    config["training"]["test_batch_size"] = 1
    config["data"]["test_len"] = kwargs.get("test_len")
    config["method"]["metric_kwargs"]["n_beams"] = beam_list[0]
    # serve the frozen LLM base int8 even from a bf16-trained checkpoint: the
    # restore quantizes the saved kernels (models/llama.py::load_llm_state)
    if kwargs.get("quantize"):
        config["method"]["model_kwargs"]["quantize"] = kwargs["quantize"]

    loaded = dataset is None
    if loaded:
        dataset = load_competition_data(**config.data)
    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(
            config.data.tokenizer_path, add_bos_token=False, add_eos_token=False)
    if loaded:
        dataset = create_llm_labels(dataset, tokenizer, config.data.prompt)

    run = {"preds": [], "path": f"{savestring}.pkl"}
    trainer = Trainer(config, dataset=dataset, device=getattr(args, "device", None))
    trainer.metric_fns = {"WER": make_wer_fn(tokenizer, run, trainer.autocast)}
    all_metrics = {}
    for k in beam_list:
        trainer.metric_kwargs["n_beams"] = k
        run["preds"] = []
        run["path"] = f"{savestring}_{k}.pkl" if len(beam_list) > 1 else f"{savestring}.pkl"
        t0 = time.perf_counter()
        _, metrics = trainer.evaluate(eval_train_set=False)
        dt = time.perf_counter() - t0
        print(f"beams={k}: WER {metrics['WER']:.4f} ({dt:.1f}s)", flush=True)
        all_metrics[k] = {**metrics, "seconds": dt}
    return all_metrics if len(beam_list) > 1 else all_metrics[beam_list[0]]


# ------------------------------------------------------------------ analysis

def bootstrap_wer_ci(preds_file: str, tokenizer, n_boot: int = 1000, seed: int = 0):
    """Bootstrap confidence interval for WER over saved predictions."""
    with open(preds_file, "rb") as f:
        all_preds = pickle.load(f)
    pairs = []
    for tokens, target in all_preds:
        pred = tokenizer.decode(np.asarray(tokens)[0], skip_special_tokens=True).strip()
        pairs.append(word_error_count(pred, target))
    errors = np.array([e for e, _ in pairs])
    words = np.array([w for _, w in pairs])
    rng = np.random.default_rng(seed)
    boots = []
    for _ in range(n_boot):
        idx = rng.integers(0, len(pairs), len(pairs))
        boots.append(errors[idx].sum() / words[idx].sum())
    boots = np.sort(boots)
    return {
        "wer": errors.sum() / words.sum(),
        "ci_low": float(boots[int(0.025 * n_boot)]),
        "ci_high": float(boots[int(0.975 * n_boot)]),
    }


def best_of_k_wer(preds_file: str, tokenizer):
    """Oracle WER over the k returned beams per example."""
    with open(preds_file, "rb") as f:
        all_preds = pickle.load(f)
    total_errors, total_words = 0, 0
    for tokens, target in all_preds:
        tokens = np.asarray(tokens)
        if tokens.ndim == 1:
            tokens = tokens[None, :]
        best = None
        for beam in tokens:
            pred = tokenizer.decode(beam, skip_special_tokens=True).strip()
            e, w = word_error_count(pred, target)
            if best is None or e / max(w, 1) < best[0] / max(best[1], 1):
                best = (e, w)
        total_errors += best[0]
        total_words += best[1]
    return total_errors / total_words


def wer_bootstrap_distributions(preds_file: str, tokenizer, n_boot: int = 1000,
                                seed: int = 0):
    """Paired bootstrap vectors for top-beam WER and best-of-k WER over one
    predictions pickle: the same resample index set drives both curves."""
    with open(preds_file, "rb") as f:
        all_preds = pickle.load(f)
    words, errors, best_errors = [], [], []
    for tokens, target in all_preds:
        tokens = np.asarray(tokens)
        if tokens.ndim == 1:
            tokens = tokens[None, :]
        per_beam = [
            word_error_count(tokenizer.decode(beam, skip_special_tokens=True).strip(), target)
            for beam in tokens
        ]
        words.append(per_beam[0][1])
        errors.append(per_beam[0][0])
        best_errors.append(min(e for e, _ in per_beam))
    words = np.asarray(words)
    errors = np.asarray(errors)
    best_errors = np.asarray(best_errors)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(words), size=(n_boot, len(words)))
    return {
        "wer": errors.sum() / words.sum(),
        "best_wer": best_errors.sum() / words.sum(),
        "boots_wer": errors[idx].sum(1) / words[idx].sum(1),
        "boots_best": best_errors[idx].sum(1) / words[idx].sum(1),
    }


def _grouped_bar_figure(stats, boot_key, ylabel, xlabel, out_path):
    """Grouped bars (one group per beam size, one bar per run label) with 95%
    bootstrap CI whiskers."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = list(stats)
    beams_axis = sorted({b for m in stats.values() for b in m})
    x = np.arange(len(beams_axis))
    width = 0.8 / max(len(labels), 1)
    fig, ax = plt.subplots(figsize=(10, 6))
    for j, lab in enumerate(labels):
        pos, means, lo, hi = [], [], [], []
        # a label is plotted only at the beam sizes it has
        for xi, b in zip(x, beams_axis):
            if b not in stats[lab]:
                continue
            boots = stats[lab][b][boot_key] * 100.0
            m = boots.mean()
            p_lo, p_hi = np.percentile(boots, [2.5, 97.5])
            pos.append(xi)
            means.append(m)
            lo.append(m - p_lo)
            hi.append(p_hi - m)
        ax.bar(np.asarray(pos) + (j - (len(labels) - 1) / 2) * width, means, yerr=[lo, hi],
               width=width, label=lab, capsize=3)
    ax.set_xlabel(xlabel, fontsize=14)
    ax.set_ylabel(ylabel, fontsize=14)
    ax.set_xticks(x)
    ax.set_xticklabels([str(b) for b in beams_axis], fontsize=13)
    ax.grid(True, which="both", linestyle="--", linewidth=0.5)
    ax.minorticks_on()
    ax.legend(fontsize=13)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def analyze(preds_files, tokenizer, out_dir: str = "plots/bci", n_boot: int = 1000,
            seed: int = 0):
    """Offline analysis of saved predictions: ``wer.png`` (top-beam WER vs
    beam size), ``best_wer.png`` (best-of-k oracle WER) and ``examples.json``
    (per-sentence decodes sorted by WER). ``preds_files``: ``{run_label:
    {beams: path_to_pickle}}``. Returns the per-run stats dict."""
    import json

    os.makedirs(out_dir, exist_ok=True)
    stats = {
        lab: {b: wer_bootstrap_distributions(path, tokenizer, n_boot, seed)
              for b, path in sorted(m.items())}
        for lab, m in preds_files.items()
    }
    _grouped_bar_figure(stats, "boots_wer", "Word Error Rate (%)", "Beam size",
                        os.path.join(out_dir, "wer.png"))
    _grouped_bar_figure(stats, "boots_best", "Best Word Error Rate (%)", "Top-$k$",
                        os.path.join(out_dir, "best_wer.png"))

    first_lab = next(iter(preds_files))
    first_path = preds_files[first_lab][sorted(preds_files[first_lab])[-1]]
    examples = []
    with open(first_path, "rb") as f:
        saved = pickle.load(f)
    for tokens, target in saved:
        tokens = np.asarray(tokens)
        best = tokens[0] if tokens.ndim > 1 else tokens
        pred = tokenizer.decode(best, skip_special_tokens=True).strip()
        e, w = word_error_count(pred, target)
        examples.append([pred, target, int(e), int(w)])
    examples.sort(key=lambda ex: ex[2] / max(ex[3], 1))
    with open(os.path.join(out_dir, "examples.json"), "w") as f:
        json.dump(examples, f, indent=1)
    return stats


def group_preds_files(preds) -> dict:
    """Comma-separated pickles -> ``{label: {beams: path}}``: files named
    ``<label>_<beams>.pkl`` group into one series per label; other stems
    become their own single-beam series."""
    files: dict = {}
    for path in str(preds).split(","):
        stem = os.path.splitext(os.path.basename(path))[0]
        lab, _, tail = stem.rpartition("_")
        if lab and tail.isdigit():
            files.setdefault(lab, {})[int(tail)] = path
        else:
            files.setdefault(stem, {})[1] = path
    return files


def analyze_cli(kwargs) -> None:
    """``python -m llm_bci_tpu_torch.eval_phonemes --analyze -k
    preds=lora_1.pkl,lora_5.pkl tokenizer_path=... out_dir=plots/bci``."""
    preds = kwargs.get("preds")
    if not preds:
        raise SystemExit("pass -k preds=<comma-separated predictions pickles>")
    tok_path = kwargs.get("tokenizer_path")
    if not tok_path:
        raise SystemExit("pass -k tokenizer_path=<tokenizer dir>")
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(tok_path)
    stats = analyze(
        group_preds_files(preds), tokenizer,
        out_dir=str(kwargs.get("out_dir", "plots/bci")),
        n_boot=int(kwargs.get("n_boot", 1000)), seed=int(kwargs.get("seed", 0)),
    )
    for lab, m in stats.items():
        for b, s in m.items():
            print(f"{lab} beams={b}: WER {100 * s['wer']:.2f}% "
                  f"best-of-k {100 * s['best_wer']:.2f}%")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--analyze", action="store_true")
    parser.add_argument("-k", "--kwargs", nargs="*", action=ParseKwargs)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; no card raises)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    cli = parse_args()
    if cli.analyze:
        analyze_cli(config_from_kwargs(cli.kwargs))
    else:
        main(cli)
