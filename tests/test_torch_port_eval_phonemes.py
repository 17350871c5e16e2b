"""``llm_bci_tpu_torch.eval_phonemes`` against the repo's ``eval_phonemes.py``,
and the quantization-layout repair of ``BCI.load_checkpoint_params`` that its
``-k quantize=int8`` goes through.

* A BCI checkpoint saved with a float base (float32 or bf16) reloads with
  ``quantize: int8``: every int8 leaf equals the JAX package's
  ``quantize_int8(axis=0)`` of the saved weight, and the prompt logits stay
  within the int8 tolerance that ``chip_smoke.py`` holds the int8 BCI's prompt
  logits to (max error 2^-5, mean error 2^-8 of the largest logit) of the
  float model's. The other way, an int8 checkpoint reloads
  into a float base as the JAX ``dequantize_int8`` of its codes, with the int8
  model's logits (float32 sums in another order: rtol 1e-5).
* ``main`` on a debug-size BCI checkpoint with a stub tokenizer and
  ``beams=1,3``: pickles named as ``analyze_cli`` groups them, finite WER.
* The WER fn's prompt (target and pad tokens stripped) and its ``generate``
  call equal the JAX script's on the same batch; ``bootstrap_wer_ci``,
  ``best_of_k_wer`` and ``analyze`` equal the script's on the same pickles.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from llm_bci_tpu.ops import quant as jquant
from llm_bci_tpu_torch.config import DictConfig as PortDictConfig
from llm_bci_tpu_torch.models import bci as tbci
from tests.test_bci import synth_bci_dataset


class WordTokenizer:
    """A stand-in for the Llama tokenizer over a fixed word list: ids 0, 1, 2
    are unk, bos and eos, which ``skip_special_tokens`` drops; any other id
    decodes to a word."""

    unk_token_id, bos_token_id, eos_token_id = 0, 1, 2
    WORDS = sorted(set("the quick brown fox jumps over the lazy dog how are you doing "
                       "today my friend i would like a glass of water please".split()))

    def decode(self, ids, skip_special_tokens=True):
        ids = [int(i) for i in np.asarray(ids).reshape(-1)]
        return " ".join(self.WORDS[i % len(self.WORDS)] for i in ids
                        if not (skip_special_tokens and i < 3))


LORA = {"r": 2, "alpha": 16, "dropout": 0.0,
        "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                           "down_proj"]}
PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj", "lm_head")


def model_config():
    return {"ndt1": {"encoder": {
        "masker": {"neuron": {"active": False}},
        "smooth_and_noise": {"noise": False},
        "embedder": {"n_channels": 8, "max_F": 16, "input_dim": 12, "dropout": 0.0,
                     "stack": {"active": True, "size": 4, "stride": 2}},
        "transformer": {"n_layers": 1, "hidden_size": 16, "n_heads": 2, "inter_size": 16,
                        "dropout": 0.0}}},
        "projector": {"stacking": 2, "inter_size": 24, "bias": True, "act": "relu"}}


def build(quantize=None, dtype="float32", from_pt=None, seed=0):
    torch.manual_seed(seed)
    cfg = model_config() | ({"from_pt": from_pt} if from_pt else {})
    model = tbci.BCI.from_config(PortDictConfig(cfg), debug=True, lora=dict(LORA),
                                 quantize=quantize, compute_dtype=dtype).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_B"):
                p.normal_(0, 0.05)
    if from_pt:
        model.warm_start()
    return model


def batch():
    rows = synth_bci_dataset(n_train=3, n_test=1)["train"]
    stack = lambda k: torch.from_numpy(np.stack([r[k] for r in rows]))
    B, T = len(rows), rows[0]["spikes"].shape[0]
    return {"input_ids": stack("input_ids"), "attention_mask": stack("attention_mask"),
            "input_split": stack("input_split"), "spikes": stack("spikes"),
            "spikes_mask": torch.ones(B, T, dtype=torch.int64),
            "spikes_timestamp": torch.arange(T).expand(B, T)}


def logits(model):
    with torch.no_grad():
        return model(**batch()).preds.float().numpy()


@pytest.mark.parametrize("saved_dtype", ["float32", "bfloat16"])
def test_a_float_checkpoint_serves_int8(tmp_path, saved_dtype):
    trained = build(dtype=saved_dtype)
    trained.save_checkpoint(str(tmp_path))
    trained.save_config(str(tmp_path))
    served = build(quantize="int8", from_pt=str(tmp_path), seed=1)
    saved = torch.load(tmp_path / "llm.pt", weights_only=True)
    got = served.llm.state_dict()
    n = 0
    for key, value in saved.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf == "weight" and prefix.rpartition(".")[2] in PROJ:
            q, s = jquant.quantize_int8(value.float().numpy().T, axis=0)
            np.testing.assert_array_equal(got[prefix + ".kernel"].numpy(), np.asarray(q))
            np.testing.assert_array_equal(got[prefix + ".kernel_scale"].numpy(), np.asarray(s))
            n += 1
        else:
            assert torch.equal(got[key], value.to(got[key].dtype)), key
    assert n == 7 * 2 + 1
    # the float model with the saved weights, in float32
    reference = build(seed=2)
    reference.load_state_dict({k: v.float() for k, v in trained.state_dict().items()})
    got, want = logits(served), logits(reference)
    err, top = np.abs(got - want), np.abs(want).max()
    assert err.max() <= 2.0 ** -5 * top and err.mean() <= 2.0 ** -8 * top, (err.max(), top)


def test_an_int8_checkpoint_serves_on_a_float_base(tmp_path):
    trained = build(quantize="int8")
    trained.save_checkpoint(str(tmp_path))
    trained.save_config(str(tmp_path))
    served = build(from_pt=str(tmp_path), seed=1)
    saved, got = torch.load(tmp_path / "llm.pt", weights_only=True), served.llm.state_dict()
    for key in saved:
        prefix, _, leaf = key.rpartition(".")
        if leaf == "kernel":
            w = jquant.dequantize_int8(saved[key].numpy(), saved[prefix + ".kernel_scale"].numpy())
            np.testing.assert_array_equal(got[prefix + ".weight"].numpy(), np.asarray(w).T)
    assert not any(k.endswith((".kernel", ".kernel_scale")) for k in got)
    np.testing.assert_allclose(logits(served), logits(trained), rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="does not fit"):
        torch.save({"model.layers.0.self_attn.q_proj.nothing": torch.zeros(1)},
                   tmp_path / "llm.pt")
        served.load_checkpoint_params(str(tmp_path))


def train_and_save(tmp_path, dataset):
    """A debug-size BCI trained one step on a float32 base and saved."""
    from llm_bci_tpu_torch import main as port_main

    args = port_main.parse_args(["-c", "configs/trainer_bci.yaml", "-k",
                                 f"dirs.checkpoint_dir={tmp_path / 'ck'}", "dirs.log_dir=null",
                                 "verbosity=3", "training.max_steps=1", "training.eval_every=null",
                                 "training.save_every=1", "training.train_batch_size=4",
                                 "training.test_batch_size=4", "precision.compute_dtype=float32",
                                 "method.model_kwargs.debug=true",
                                 "method.model_kwargs.lora.dropout=0.0",
                                 *[f"model.ndt1.encoder.{k}" for k in (
                                     "transformer.n_layers=1", "transformer.hidden_size=16",
                                     "transformer.n_heads=2", "transformer.inter_size=16",
                                     "embedder.input_dim=8", "embedder.max_F=16",
                                     "embedder.stack.size=4", "embedder.stack.stride=2")],
                                 "model.projector.inter_size=16", "--device", "cpu"])
    trainer = port_main.main(args, dataset=dataset)
    return os.path.join(trainer.checkpoint_dir, "STEP1")


def test_main_sweeps_beams_on_an_int8_base(tmp_path):
    from llm_bci_tpu_torch import eval_phonemes as tep

    dataset = synth_bci_dataset(n_train=4, n_test=3)
    ckpt = train_and_save(tmp_path, dataset)
    assert "kernel" not in "".join(torch.load(os.path.join(ckpt, "llm.pt"), weights_only=True))
    save = str(tmp_path / "wer")
    args = tep.parse_args(["-k", f"from_pt={ckpt}", "beams=1,3", f"savestring={save}",
                           "test_len=2", "quantize=int8", "--device", "cpu"])
    metrics = tep.main(args, dataset=dataset, tokenizer=WordTokenizer())
    assert sorted(metrics) == [1, 3]
    assert all(np.isfinite(m["WER"]) and m["WER"] >= 0 for m in metrics.values())
    paths = [f"{save}_1.pkl", f"{save}_3.pkl"]
    assert tep.group_preds_files(",".join(paths)) == {"wer": {1: paths[0], 3: paths[1]}}
    for k, path in zip((1, 3), paths):
        with open(path, "rb") as f:
            preds = pickle.load(f)
        assert len(preds) == 2 and all(t.shape == (k, 20) for t, _ in preds)
        assert all(s == "a b c" for _, s in preds)
    with pytest.raises(NotImplementedError, match="slice 3, left"):
        ref_ckpt = tmp_path / "reference"
        ref_ckpt.mkdir()
        (ref_ckpt / "trainer_config.pth").write_bytes(b"")
        tep.main(tep.parse_args(["-k", f"from_pt={ref_ckpt}"]), dataset=dataset,
                 tokenizer=WordTokenizer())


class RecordingModel(torch.nn.Module):
    """Records each ``generate`` call and answers with fixed tokens."""

    def __init__(self, to_tensor):
        super().__init__()
        self.dummy = torch.nn.Parameter(torch.zeros(1))
        self.calls, self.to_tensor = [], to_tensor

    def generate(self, **kw):
        self.calls.append({k: np.asarray(v) if hasattr(v, "shape") else v
                           for k, v in kw.items()})
        n = kw["num_beams"]
        tokens = (np.arange(n * 20).reshape(1, n, 20) * 7 + len(self.calls)) % 40 + 3
        if n == 1:
            return self.to_tensor(tokens[:, 0])
        return type("Beams", (), {"sequences": self.to_tensor(tokens)})()


def model_inputs():
    """A batch of one whose prompt ends in right padding (unk ids with
    -100 targets) and whose sentence tokens sit in the middle."""
    ids = np.array([[5, 9, 11, 4, 30, 31, 32, 0, 0]], np.int64)
    targets = np.array([[-100, -100, -100, -100, 30, 31, 32, -100, -100]], np.int64)
    return {"input_ids": ids, "attention_mask": np.ones_like(ids), "targets": targets,
            "input_split": np.array([[3]]), "spikes": np.ones((1, 16, 8), np.float32),
            "spikes_mask": np.ones((1, 16), np.int64),
            "spikes_timestamp": np.arange(16)[None], "spikes_lengths": np.array([16]),
            "block_idx": np.array([1]), "day_idx": np.array([0])}


def run_script(module, trainer_attr, tmp_path, monkeypatch, label, to_tensor):
    """``module.main`` with ``beams=1,3`` on the same batch, its Trainer replaced
    by one that calls the WER fn with a :class:`RecordingModel`."""
    model = RecordingModel(to_tensor)

    class FakeTrainer:
        def __init__(self, config, dataset=None, metric_fns=None, **kw):
            self.metric_fns, self.metric_kwargs = metric_fns or {}, {}

        def autocast(self):
            return torch.autocast("cpu", enabled=False)

        def evaluate(self, eval_train_set=False):
            unused = {"sentence": ["the quick brown fox"]}
            return 0.0, {"WER": self.metric_fns["WER"](model, model_inputs(), unused, None,
                                                       **self.metric_kwargs)}

    monkeypatch.setattr(module, trainer_attr, FakeTrainer)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir(exist_ok=True)
    with open(ckpt / "trainer_config.yaml", "w") as f:
        f.write("model: {}\ntraining: {}\ndata: {tokenizer_path: none, prompt: p}\n"
                "method: {model_kwargs: {}, metric_kwargs: {}}\n")
    save = str(tmp_path / label)
    argv = ["-k", f"from_pt={ckpt}", "beams=1,3", f"savestring={save}", "compilation_cache=off"]
    if module.__name__ == "eval_phonemes":
        import argparse

        from llm_bci_tpu.config import ParseKwargs

        parser = argparse.ArgumentParser()
        parser.add_argument("-k", "--kwargs", nargs="*", action=ParseKwargs)
        metrics = module.main(parser.parse_args(argv))
    else:
        metrics = module.main(module.parse_args(argv), dataset={}, tokenizer=WordTokenizer())
    return model.calls, metrics, [f"{save}_1.pkl", f"{save}_3.pkl"]


def test_the_wer_fn_and_the_analysis_equal_the_jax_script(tmp_path, monkeypatch):
    import transformers

    import eval_phonemes as jep
    from llm_bci_tpu_torch import eval_phonemes as tep

    monkeypatch.setattr(jep, "load_competition_data", lambda **kw: {})
    monkeypatch.setattr(jep, "create_llm_labels", lambda dataset, *a: dataset)
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda *a, **k: WordTokenizer()))
    jcalls, jmetrics, jpaths = run_script(jep, "Trainer", tmp_path, monkeypatch, "jax",
                                          lambda a: np.asarray(a))
    tcalls, tmetrics, tpaths = run_script(tep, "Trainer", tmp_path, monkeypatch, "port",
                                          torch.from_numpy)
    assert len(jcalls) == len(tcalls) == 2
    for jc, tc in zip(jcalls, tcalls):
        assert sorted(jc) == sorted(tc)
        for key in jc:
            np.testing.assert_array_equal(tc[key], jc[key], err_msg=key)
    np.testing.assert_array_equal(tcalls[0]["input_ids"], [[5, 9, 11, 4]])
    assert {k: {"WER": m["WER"]} for k, m in tmetrics.items()} == jmetrics
    assert all(m["seconds"] > 0 for m in tmetrics.values())
    tok = WordTokenizer()
    for jp, tp in zip(jpaths, tpaths):
        with open(jp, "rb") as f, open(tp, "rb") as g:
            for (ja, js), (ta, ts) in zip(pickle.load(f), pickle.load(g)):
                np.testing.assert_array_equal(ta, ja)
                assert ts == js
        assert tep.bootstrap_wer_ci(tp, tok, n_boot=200) == jep.bootstrap_wer_ci(
            jp, tok, n_boot=200)
        assert tep.best_of_k_wer(tp, tok) == jep.best_of_k_wer(jp, tok)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return
    files = lambda paths: {"run": {1: paths[0], 3: paths[1]}}
    jstats = jep.analyze(files(jpaths), tok, out_dir=str(tmp_path / "jplots"), n_boot=50)
    tstats = tep.analyze(files(tpaths), tok, out_dir=str(tmp_path / "plots"), n_boot=50)
    for b in (1, 3):
        for key, value in jstats["run"][b].items():
            np.testing.assert_array_equal(tstats["run"][b][key], value)
    assert sorted(os.listdir(tmp_path / "plots")) == ["best_wer.png", "examples.json",
                                                      "wer.png"]
