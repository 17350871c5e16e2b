# Mirrors llm_bci_tpu/data/speechbci.py (host code that imports no JAX): the port keeps its own copy.
"""Brain-to-Text speech BCI competition data loader.

Reimplements the reference ``data_utils/speechbci_dataset.py:38-206``:
``.mat`` session files → per-example dicts with concatenated
``tx1``+``spikePow`` features, optional per-block/per-day z-scoring, day and
block indexing, sentence cleanup; plus phoneme CTC labels (g2p_en) and
LLM prompt labels for the end-to-end BCI method.

Host-side numpy only. ``g2p_en`` is not baked into this image, so
:func:`create_phonemes_ctc_labels` accepts any callable g2p and falls back
to a rule-based ARPAbet approximation (clearly flagged) when the package is
missing — competition-grade labels require the real g2p_en.
"""
from __future__ import annotations

import json
import os
import re
import string
from glob import glob
from typing import Any, Callable, Dict, List, Optional

import numpy as np

_PUNCTUATION = string.punctuation.replace("'", "")


def get_split_dict(
    split_dir: str,
    zscore_block: bool,
    features: List[str],
    area_start: int,
    area_end: int,
) -> List[Dict[str, Any]]:
    """One split directory of ``.mat`` files → list of example dicts
    (reference ``data_utils/speechbci_dataset.py:52-96``)."""
    import scipy.io

    all_files = glob(os.path.join(split_dir, "*"))
    all_files.sort(key=lambda file: tuple(file.split("/")[-1].split(".")[1:4]))
    x, y, b, d = [], [], [], []
    for file in all_files:
        data = scipy.io.loadmat(file)
        n = len(data["sentenceText"])
        x_i = np.array(
            [
                np.concatenate(
                    [data[f][0, i][:, area_start:area_end] for f in features], axis=1
                )
                for i in range(n)
            ],
            dtype=object,
        )
        y_i = data["sentenceText"]
        b_i = data["blockIdx"]
        d_i = [tuple(file.split("/")[-1].split(".")[1:4])] * len(b_i)
        if zscore_block:
            for block in set(int(v) for [v] in b_i.tolist()):
                idx = np.where(b_i == block)[0]
                cat = np.concatenate(list(x_i[idx]), axis=0)
                mu, sd = cat.mean(axis=0), cat.std(axis=0)
                # Dead channels (no activity in the block) have sd == 0;
                # dividing would inject NaN into every trial's features.
                sd = np.where(sd == 0, 1.0, sd)
                for i in idx:
                    x_i[i] = (x_i[i] - mu) / sd
        x.append(x_i)
        y.append(y_i)
        b.append(b_i)
        d += d_i
    x = np.concatenate(x).tolist()
    y = np.concatenate(y)
    b = (np.concatenate(b).squeeze() - 1).tolist()
    return [
        {
            "spikes": x_i.astype(np.float32),
            "sentence": str(y_i).translate(str.maketrans("", "", _PUNCTUATION)).lower().strip(),
            "block": b_i,
            "day": d_i,
        }
        for x_i, y_i, b_i, d_i in zip(x, y, b, d)
    ]


def load_competition_data(
    data_dir: str,
    day_idxs: Optional[List[int]] = None,
    zscore_block: bool = False,
    zscore_day: bool = False,
    features: Optional[List[str]] = None,
    area_start: int = 0,
    area_end: int = 128,
    **kwargs,
) -> Dict[str, List[Dict[str, Any]]]:
    """Splits train/test/competitionHoldOut with day/block indexing and
    optional per-day z-scoring (reference
    ``data_utils/speechbci_dataset.py:38-127``). The reference config's
    ``date_idxs`` key is a typo for ``day_idxs`` (SURVEY.md §5) — we accept
    both, preferring ``day_idxs``."""
    if features is None:
        features = ["tx1", "spikePow"]
    if day_idxs is None and kwargs.get("date_idxs") is not None:
        day_idxs = kwargs["date_idxs"]

    splits = ["train", "test", "competitionHoldOut"]
    dataset_dict = {
        split: get_split_dict(
            os.path.join(data_dir, split), zscore_block, features, area_start, area_end
        )
        for split in splits
    }

    # sorted: a raw set's iteration order is hash-table order, so block_idx
    # assignments (and the learned block embeddings keyed by them) would not
    # be stable across runs/builds.
    all_blocks = sorted(set(row["block"] for split in splits for row in dataset_dict[split]))
    all_days = sorted(set(row["day"] for split in splits for row in dataset_dict[split]))
    if day_idxs is None:
        day_idxs = list(range(len(all_days)))

    d_to_i = {d: i for i, d in enumerate(all_days)}
    b_to_i = {b: i for i, b in enumerate(all_blocks)}
    for split in splits:
        kept = []
        for row in dataset_dict[split]:
            if d_to_i[row["day"]] in day_idxs:
                row["block_idx"] = np.asarray(b_to_i[row["block"]])
                row["day_idx"] = np.asarray(d_to_i[row["day"]])
                kept.append(row)
        dataset_dict[split] = kept

    if zscore_day:
        by_day = {}
        for i in day_idxs:
            rows = [
                row["spikes"]
                for row in dataset_dict["train"]
                if int(row["day_idx"]) == i
            ]
            if not rows:
                raise ValueError(
                    f"zscore_day: day_idx {i} has no train rows to compute "
                    "statistics from (day statistics come from the train "
                    "split, reference data_utils/speechbci_dataset.py:119-125); "
                    "drop it from day_idxs or disable zscore_day."
                )
            by_day[i] = np.concatenate(rows, axis=0)
        mean = {i: v.mean(axis=0) for i, v in by_day.items()}
        # Dead channels: sd == 0 would turn every trial's feature into NaN.
        std = {i: np.where(v.std(axis=0) == 0, 1.0, v.std(axis=0)) for i, v in by_day.items()}
        for split in splits:
            for row in dataset_dict[split]:
                i = int(row["day_idx"])
                row["spikes"] = (row["spikes"] - mean[i]) / std[i]
                row["day_mean"] = mean[i]
                row["day_std"] = std[i]

    return dataset_dict


# --------------------------------------------------------------------------
# Phoneme CTC labels
# --------------------------------------------------------------------------

_ARPABET_DICT_PATH = os.path.join(os.path.dirname(__file__), "arpabet_dict.txt")


# Optional full pronunciation dictionary: if the user drops the
# public-domain CMUdict (cmudict.dict / cmudict-0.7b, ~134k entries) at this
# path — or points LLM_BCI_CMUDICT at one — it merges over the vendored
# subset and rule-based fallback becomes a rarity. Not vendored here because
# this build environment has no network access to fetch it.
_CMUDICT_PATH = os.path.join(os.path.dirname(__file__), "cmudict.txt")


def _strip_stress(phone: str) -> str:
    return phone.rstrip("012")


# English suffix phonology: voicing of -s/-ed assimilates to the stem's
# final sound, and a syllable is inserted after homorganic codas.
_SIBILANTS = frozenset({"S", "Z", "SH", "ZH", "CH", "JH"})
_VOICELESS = frozenset({"P", "T", "K", "F", "TH", "S", "SH", "CH", "HH"})


def _s_suffix_phones(base_phones: List[str]) -> List[str]:
    """-s / -es / possessive 's: IH0 Z after sibilants, S after voiceless
    consonants, Z elsewhere (vowels and voiced consonants)."""
    last = _strip_stress(base_phones[-1])
    if last in _SIBILANTS:
        return ["IH0", "Z"]
    if last in _VOICELESS:
        return ["S"]
    return ["Z"]


def _ed_suffix_phones(base_phones: List[str]) -> List[str]:
    """-ed: IH0 D after T/D, T after voiceless consonants, D elsewhere."""
    last = _strip_stress(base_phones[-1])
    if last in ("T", "D"):
        return ["IH0", "D"]
    if last in _VOICELESS:
        return ["T"]
    return ["D"]


# Derivational prefixes: transparent pronunciations prepended to a
# dictionary stem (UNHAPPY = UN + HAPPY). Stems must be >= _PREFIX_MIN_STEM
# letters so short words never mis-split (READ must not parse RE+AD);
# CO requires one more (COAT must not parse CO+AT even if the dictionary
# lost its COAT entry).
_PREFIXES = (
    ("UN", ["AH0", "N"]),
    ("RE", ["R", "IY1"]),
    ("DIS", ["D", "IH0", "S"]),
    ("MIS", ["M", "IH0", "S"]),
    ("NON", ["N", "AA1", "N"]),
    ("PRE", ["P", "R", "IY1"]),
    ("OVER", ["OW1", "V", "ER0"]),
    ("UNDER", ["AH1", "N", "D", "ER0"]),
    ("OUT", ["AW1", "T"]),
    ("SEMI", ["S", "EH1", "M", "IY0"]),
    ("ANTI", ["AE1", "N", "T", "IY0"]),
    ("SUPER", ["S", "UW1", "P", "ER0"]),
    ("SUB", ["S", "AH1", "B"]),
    ("CO", ["K", "OW1"]),
)
_PREFIX_MIN_STEM = 3


class DictionaryG2P:
    """Dictionary-backed grapheme→phoneme with the ``g2p_en`` call protocol
    (phonemes with stress digits, ``" "`` tokens at word boundaries).

    Lookup order: the vendored hand-vetted subset (:data:`_ARPABET_DICT_PATH`)
    merged under a full CMUdict if present (``data/cmudict.txt`` or
    ``$LLM_BCI_CMUDICT``); then **morphological derivation** — inflected and
    derived forms (plural -s/-es, past -ed, -ing, -er/-est, -ly, -ness/
    -ment/-ful/-less, clitics like N'T/'LL, the prefixes of
    :data:`_PREFIXES`, and closed compounds like CATFISH/FIREWORKS) resolve
    through dictionary BASE words plus English affix phonology
    (:meth:`_derive`), which is far more accurate than spelling rules; only
    words neither listed nor derivable go through the NRL-style rule engine
    (:class:`llm_bci_tpu_torch.data.lts.RuleLTS`) or raise, depending on ``oov``:

    * ``"raise"`` (default here): OOV is an error — a competition run should
      not silently mix approximate labels with dictionary labels.
    * ``"warn"``: label via letter-to-sound rules and report the OOV words
      once, loudly (the pipeline default — arbitrary sentences stay
      labelable self-contained, reference parity with g2p_en's
      model-fallback behavior, ``data_utils/speechbci_dataset.py:142-168``).
    * ``"lts"``: rule-based fallback, quiet.

    ``allow_fallback=True`` is kept as an alias for ``oov="lts"``."""

    def __init__(
        self,
        dict_path: Optional[str] = None,
        oov: str = "raise",
        allow_fallback: Optional[bool] = None,
    ):
        from llm_bci_tpu_torch.data.lts import RuleLTS

        if allow_fallback is not None:
            oov = "lts" if allow_fallback else "raise"
        if oov not in ("raise", "warn", "lts"):
            raise ValueError(f"oov must be raise|warn|lts, got {oov!r}")
        self.oov = oov
        self._lts = RuleLTS()
        self.oov_words: set = set()
        self.derived_words: set = set()  # labeled via morphological derivation
        # Label provenance (VERDICT r3 #4c): per-OCCURRENCE counts of which
        # tier labeled each word — "dict" (direct entry), "derived"
        # (suffix/prefix/compound morphology over dictionary bases), "lts"
        # (rule engine). create_phonemes_ctc_labels snapshots these per
        # split so users can see how noisy their labels are.
        self.tier_counts: Dict[str, int] = {"dict": 0, "derived": 0, "lts": 0}
        self.entries: Dict[str, List[str]] = {}
        paths = [dict_path or _ARPABET_DICT_PATH]
        full = os.environ.get("LLM_BCI_CMUDICT", _CMUDICT_PATH)
        if os.path.exists(full):
            paths.append(full)
        for path in paths:
            self._load(path)

    def _load(self, path: str) -> None:
        with open(path, encoding="latin-1") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or line.startswith(";;;"):
                    continue
                word, *phones = line.split()
                word = word.upper()
                if word.endswith(")") and "(" in word:
                    continue  # CMUdict alternate pronunciations: keep the first
                # strip cmudict.dict-style inline comments
                if "#" in phones:
                    phones = phones[: phones.index("#")]
                self.entries[word] = phones

    def __call__(self, sentence: str) -> List[str]:
        out: List[str] = []
        oov: List[str] = []
        for w, word in enumerate(sentence.split()):
            if w > 0:
                out.append(" ")
            key = word.upper().strip(".,!?;:\"")
            phones = self.entries.get(key)
            if phones is not None:
                self.tier_counts["dict"] += 1
            else:
                phones = self._derive(key)
                if phones is not None:
                    self.derived_words.add(key)
                    self.tier_counts["derived"] += 1
            if phones is None:
                oov.append(word)
                if self.oov == "raise":
                    continue
                phones = self._lts(key.lower())
                self.tier_counts["lts"] += 1
            out.extend(phones)
        if oov:
            if self.oov == "raise":
                raise ValueError(
                    f"words not in the pronunciation dictionary: {sorted(set(oov))}; "
                    "install g2p_en, drop a full CMUdict at "
                    "llm_bci_tpu_torch/data/cmudict.txt (or $LLM_BCI_CMUDICT), or pass "
                    "oov='warn'/'lts' to accept rule-based letter-to-sound labels"
                )
            if self.oov == "warn":
                fresh = set(oov) - self.oov_words
                if fresh:
                    print(
                        "DictionaryG2P: rule-based letter-to-sound labels for "
                        f"out-of-dictionary words {sorted(fresh)}",
                        flush=True,
                    )
        self.oov_words.update(oov)
        return out

    # -------------------------------------------------------- morphology
    def _lookup(self, base: str, depth: int) -> Optional[List[str]]:
        """Dictionary entry for ``base``, optionally via one more level of
        derivation (so e.g. PLAYERS resolves as (PLAY+ER)+S)."""
        if len(base) < 2:
            return None  # too short to be a stem ("IS" must not split I+S)
        phones = self.entries.get(base)
        if phones is None and depth > 0:
            phones = self._derive(base, depth - 1)
        return phones

    def _derive(self, word: str, depth: int = 1) -> Optional[List[str]]:
        """Pronounce an inflected/derived form from a dictionary BASE word
        plus English suffix phonology — far more accurate than the
        letter-to-sound rules, which only see spelling. Returns ``None``
        when no suffix pattern resolves to a dictionary stem (the caller
        then falls through to the OOV policy).

        Covers the regular inflections (the reference's ``g2p_en`` handles
        these through its dictionary+model, ``data_utils/
        speechbci_dataset.py:142-168``): plural/3sg/possessive -s/-es with
        sibilant/voicing assimilation, past -ed (T/D/IH-D), -ing, -er/-est
        (with drop-e, doubled-consonant and Y→I stem spellings), adverbial
        -ly, -ness/-ment/-ful/-less, and the clitics 'S 'LL 'VE 'RE 'D N'T."""
        w = word
        lk = self._lookup

        def first(tail_fn, *stems):
            # Two passes: DIRECT dictionary stems (ground truth) across all
            # spelling alternatives first, then derived stems (heuristic).
            # Without this, REACHED's silent-e alternative "REACHE" would
            # "derive" through the prefix pass as RE+ACHE before the bare
            # stem REACH — a direct entry — was ever consulted.
            for lookup in (
                lambda s: self.entries.get(s) if len(s) >= 2 else None,
                lambda s: lk(s, depth),
            ):
                for stem in stems:
                    if not stem:
                        continue
                    b = lookup(stem)
                    if b:
                        return list(b) + tail_fn(b)
            return None

        def dedouble(stem: str) -> Optional[str]:
            # RUNN -> RUN, STOPP -> STOP (doubled final consonant spelling)
            if len(stem) >= 3 and stem[-1] == stem[-2] and stem[-1] not in "AEIOUSY":
                return stem[:-1]
            return None

        plural = _s_suffix_phones
        past = _ed_suffix_phones
        const = lambda tail: (lambda b: list(tail))

        # Clitics first: the apostrophe pins the split point exactly.
        for suf, tail in (
            ("'S", None), ("N'T", ["AH0", "N", "T"]), ("'LL", ["AH0", "L"]),
            ("'VE", ["AH0", "V"]), ("'RE", ["ER0"]), ("'D", ["D"]),
        ):
            if w.endswith(suf):
                got = first(plural if tail is None else const(tail), w[: -len(suf)])
                if got:
                    return got
        # Y-stem spellings (CARRIED/CITIES/HAPPIER/HAPPIEST/HAPPILY).
        for suf, tail_fn in (
            ("IEST", const(["AH0", "S", "T"])), ("IES", plural), ("IED", past),
            ("IER", const(["ER0"])),
        ):
            if w.endswith(suf):
                got = first(tail_fn, w[: -len(suf)] + "Y")
                if got:
                    return got
        if w.endswith("ILY"):
            b = lk(w[:-3] + "Y", depth)
            if b:  # HAPPY -> HAPP(Y->AH0)+L IY0: HH AE1 P AH0 L IY0
                core = b[:-1] + ["AH0"] if _strip_stress(b[-1]) == "IY" else list(b)
                return core + ["L", "IY0"]
        # For the e-dropping suffixes the SILENT-E base is tried BEFORE the
        # bare-spelling stem: when both are dictionary words the e-base is
        # the right parse (RATED->RATE not RAT, STARING->STARE not STAR,
        # CUTEST->CUTE not CUT), because a bare CVC stem would have doubled
        # its final consonant in the inflection (RATTED, STARRING, CUTTEST).
        # INVARIANT this ordering relies on: stems whose e-base changes the
        # final phone (soft-G -NGE words: SINGE/LUNGE/TINGE vs SING/LUNG)
        # must have their common inflections listed DIRECTLY in the
        # dictionary (SINGING, SINGER, LUNGING ...), because e-base-first
        # would otherwise mis-derive SINGING through SINGE. The vendored
        # dictionary carries those forms; keep them when editing it.
        if w.endswith("ING") and len(w) > 4:
            stem = w[:-3]
            # drop-e only from 3+ letter stems: THING must not parse THE+ING
            got = first(const(["IH0", "NG"]),
                        stem + "E" if len(stem) >= 3 else None, stem,
                        dedouble(stem))
            if got:
                return got
        if w.endswith("EST") and len(w) > 4:
            stem = w[:-3]
            got = first(const(["AH0", "S", "T"]),
                        stem + "E" if len(stem) >= 3 else None, stem,
                        dedouble(stem))
            if got:
                return got
        if w.endswith("ED") and len(w) > 3:
            stem = w[:-2]
            got = first(past, stem + "E", stem, dedouble(stem))
            if got:
                return got
        if w.endswith("ES") and len(w) > 3:
            # Try the -S reading first (MAKES -> MAKE + S), then the -ES
            # syllabic reading (BUSES -> BUS + IH0 Z).
            got = first(plural, w[:-1], w[:-2])
            if got:
                return got
        # Whole-word prefix split with a DIRECT dictionary stem
        # (REAPPLY = RE+APPLY, UNEASY = UN+EASY): placed AFTER the
        # inflectional suffixes — REACHED must parse REACH+ED, not
        # RE+ACHED even when ACHED happens to be a dictionary entry — but
        # BEFORE the -LY/-NESS class, whose stem respelling can otherwise
        # manufacture a garbage base (-LY turned REAPPLY into "REAPPLE"
        # and derived THAT through RE+APPLE). Prefixes with DERIVED stems
        # run again at the bottom, after every suffix pattern.
        for pre, pre_phones in _PREFIXES:
            min_stem = _PREFIX_MIN_STEM + (1 if pre == "CO" else 0)
            if w.startswith(pre) and len(w) >= len(pre) + min_stem:
                b = self.entries.get(w[len(pre):])
                if b:
                    return list(pre_phones) + list(b)
        for suf, tail in (
            ("NESS", ["N", "AH0", "S"]), ("MENT", ["M", "AH0", "N", "T"]),
            ("LESS", ["L", "AH0", "S"]), ("FUL", ["F", "AH0", "L"]),
            ("SHIP", ["SH", "IH0", "P"]),
        ):
            if w.endswith(suf) and len(w) > len(suf) + 1:
                stem = w[: -len(suf)]
                # I->Y restore: HAPPINESS/LAZINESS spell the -Y stem with I
                ystem = stem[:-1] + "Y" if stem.endswith("I") else None
                got = first(const(tail), stem, ystem)
                if got:
                    return got
        if w.endswith("LY") and len(w) > 3:
            b = lk(w[:-2], depth)
            if b is None:  # SIMPLY -> SIMPLE: ...AH0 L collapses to L IY0
                b = lk(w[:-2] + "LE", depth)
                if b and b[-2:] and _strip_stress(b[-1]) == "L" and _strip_stress(b[-2]) == "AH":
                    return b[:-2] + ["L", "IY0"]
                b = None
            if b:  # -LLY spellings (REAL+LY): the double L is one phone
                if _strip_stress(b[-1]) == "L":
                    return b + ["IY0"]
                return b + ["L", "IY0"]
        if w.endswith("ER") and not w.endswith("EER") and len(w) > 4:
            # -EER words (BEER, CAREER, ENGINEER) are not agent nouns; and
            # 3-letter -ER words never decompose (HER, PER).
            stem = w[:-2]
            got = first(const(["ER0"]), stem + "E",
                        stem if len(stem) >= 3 else None, dedouble(stem))
            if got:
                return got
        if w.endswith("S") and not w.endswith("SS") and len(w) > 2:
            got = first(plural, w[:-1])
            if got:
                return got
        # -ABLE/-ABLY (AGREEABLE, LOVABLE, FORGETTABLE): suffix phonology
        # AH0 B AH0 L — NOT the standalone word ABLE's EY1 — so this must
        # come before the compound splitter, which would otherwise glue
        # AGREE+ABLE with the wrong vowel.
        for suf, tail in (
            ("ABLE", ["AH0", "B", "AH0", "L"]), ("ABLY", ["AH0", "B", "L", "IY0"]),
        ):
            if w.endswith(suf) and len(w) > len(suf) + 2:
                stem = w[: -len(suf)]
                got = first(const(tail), stem, stem + "E", dedouble(stem))
                if got:
                    return got
        # Derivational prefixes (UNHAPPY, REAPPLY, DISAGREE ...): stem must
        # resolve through the dictionary (or one more derivation level, so
        # UNLOCKED parses UN+(LOCK+ED)). Tried after every suffix pattern:
        # suffixes bind tighter, and the recursive suffix path above reaches
        # here for its stems.
        for pre, pre_phones in _PREFIXES:
            min_stem = _PREFIX_MIN_STEM + (1 if pre == "CO" else 0)
            if w.startswith(pre) and len(w) >= len(pre) + min_stem:
                b = lk(w[len(pre):], depth) if len(w[len(pre):]) >= min_stem else None
                if b:
                    return list(pre_phones) + b
        # Closed compounds (FIREWORKS, SNOWSTORM, NOTEBOOK): both halves
        # >= 4 letters, the FIRST half a direct dictionary entry (no
        # derivation — a derived first half is how false splits creep in),
        # the second half a dictionary entry or one more derivation
        # (FIREWORKS = FIRE+WORK+S). Among the valid split points, the
        # most BALANCED split wins, longer-first-half as tiebreak: English
        # compounds pair two content words of similar weight, so HORSESHOE
        # parses HORSE+SHOE (5+4) rather than the longest-first HORSES+HOE
        # (6+3). Both r5 tightenings (the r4 rule was longest-first with
        # >= 3-letter halves) are measured against the dictionary's own
        # inflection sweep (tests/test_lts.py): 3-letter halves mostly
        # manufactured false splits of monomorphemic words and names —
        # STEP+HEN, HEAT+HER, BAR+RAGE, CAME+RON — while the short TRUE
        # compounds they could catch (CATFISH, TEAPOT) are dictionary
        # entries anyway, so excluding them costs a rule-engine fallback
        # only for genuinely-OOV short compounds.
        if len(w) >= 8 and "'" not in w:
            mid = len(w) / 2
            for i in sorted(
                range(4, len(w) - 3), key=lambda i: (abs(i - mid), -i)
            ):
                a = self.entries.get(w[:i])
                if a is None:
                    continue
                b = lk(w[i:], depth)
                if b:
                    return list(a) + b
        return None


def create_phonemes_ctc_labels(
    dataset: Dict[str, List[Dict[str, Any]]],
    vocab_file: str,
    g2p: Optional[Callable[[str], List[str]]] = None,
    oov: str = "warn",
    allow_fallback: Optional[bool] = None,
) -> Dict[str, List[Dict[str, Any]]]:
    """Adds ``phonemes`` (list[str]) and ``phonemes_idx`` (np int array) per
    example: g2p, strip stress digits, ``SIL`` at word ends, map through the
    41-token vocab (reference ``data_utils/speechbci_dataset.py:142-168``).

    G2P resolution order: explicit ``g2p`` arg > installed ``g2p_en`` >
    dictionary + rule engine (:class:`DictionaryG2P`). The pipeline default
    ``oov="warn"`` labels out-of-dictionary words with the NRL-style
    letter-to-sound rules and reports them loudly, so arbitrary English
    sentences are labelable self-contained (the reference's g2p_en behaves
    the same way: dictionary first, model fallback). Pass ``oov="raise"``
    for hard-fail strictness."""
    if g2p is None:
        try:
            from g2p_en import G2p

            g2p = G2p()
        except ImportError:
            g2p = DictionaryG2P(oov=oov, allow_fallback=allow_fallback)
    vocab = json.load(open(vocab_file))

    def s_to_p(s: str) -> List[str]:
        return [
            re.sub(r"[0-9]", "", pp) if pp != " " else "SIL"
            for pp in g2p(s)
            if re.match(r"[A-Z]+", pp) or pp == " "
        ] + ["SIL"]

    def p_to_i(p: List[str]) -> List[int]:
        return [vocab.index(pp) for pp in p]

    # Label provenance (VERDICT r3 #4c): report, per split, how many word
    # occurrences were labeled from the dictionary, from morphological
    # derivation over dictionary bases, and from the rule-based LTS
    # fallback — the one tier whose quality is approximate. Only the
    # self-contained DictionaryG2P tracks tiers (g2p_en is a neural model;
    # its labels are all one tier).
    tiers = getattr(g2p, "tier_counts", None)
    for split in dataset:
        before = dict(tiers) if tiers is not None else None
        for row in dataset[split]:
            phonemes = s_to_p(row["sentence"])
            row["phonemes"] = phonemes
            row["phonemes_idx"] = np.asarray(p_to_i(phonemes))
        if tiers is not None and dataset[split]:
            got = {k: tiers[k] - before[k] for k in tiers}
            n = max(sum(got.values()), 1)
            print(
                f"phoneme labels [{split}]: "
                + ", ".join(f"{k} {v} ({v / n:.1%})" for k, v in got.items()),
                flush=True,
            )
    return dataset


# --------------------------------------------------------------------------
# LLM labels (end-to-end BCI)
# --------------------------------------------------------------------------

def create_llm_labels(
    dataset: Dict[str, List[Dict[str, Any]]],
    tokenizer,
    prompt: str = "neural activity:#-> sentence:",
) -> Dict[str, List[Dict[str, Any]]]:
    """Adds ``input_ids``/``attention_mask``/``input_split``/``labels``:
    the prompt is split at ``#`` (spike embeddings spliced there) and the
    sentence tokens carry the loss, −100 elsewhere (reference
    ``data_utils/speechbci_dataset.py:185-206``)."""
    part_a, part_b = prompt.split("#")
    # add_special_tokens=False: the pieces are concatenated below, so a
    # default-configured tokenizer (add_bos_token=True) would otherwise
    # scatter BOS tokens mid-sequence — and into the loss-bearing labels.
    # The appended eos STRING still maps to the eos id (AddedToken match).
    # When the caller's tokenizer is configured with add_bos_token, the
    # sequence-INITIAL BOS is re-prepended below (landing in part_a,
    # loss-masked to −100). NOTE the shipped pipeline never takes this
    # branch: main.py and eval_phonemes.py both build the tokenizer with
    # add_bos_token=False, exactly like the reference (`main.py:35`,
    # `eval_phonemes.py:109`) — no BOS anywhere is reference parity. A
    # caller who opts into BOS here must serve with a BOS-initial prompt
    # too, or training and decoding see different prompt prefixes.
    prompt_tokens_a = tokenizer(
        part_a, return_tensors="np", add_special_tokens=False
    )["input_ids"][0]
    if getattr(tokenizer, "add_bos_token", False) and tokenizer.bos_token_id is not None:
        prompt_tokens_a = np.concatenate(
            [np.asarray([tokenizer.bos_token_id], dtype=prompt_tokens_a.dtype), prompt_tokens_a]
        )
    prompt_tokens_b = tokenizer(
        part_b, return_tensors="np", add_special_tokens=False
    )["input_ids"][0]

    for split in dataset:
        for row in dataset[split]:
            sentence_tokens = tokenizer(
                row["sentence"] + tokenizer.eos_token,
                return_tensors="np",
                add_special_tokens=False,
            )["input_ids"][0]
            row["input_ids"] = np.concatenate(
                [prompt_tokens_a, prompt_tokens_b, sentence_tokens], axis=0
            )
            row["attention_mask"] = np.ones_like(row["input_ids"])
            row["input_split"] = np.atleast_1d(prompt_tokens_a.shape[0])
            row["labels"] = np.concatenate(
                [
                    np.full_like(prompt_tokens_a, -100),
                    np.full_like(prompt_tokens_b, -100),
                    sentence_tokens,
                ],
                axis=0,
            )
    return dataset
