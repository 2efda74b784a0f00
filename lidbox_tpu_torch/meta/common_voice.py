"""
Mozilla Common Voice metadata loader (https://commonvoice.mozilla.org)
(counterpart of ``lidbox_tpu.meta.common_voice``; reference:
lidbox/meta/common_voice.py).

Corpus layout: ``<corpus_dir>/<lang>/{train,dev,test,validated}.tsv`` and
``<corpus_dir>/<lang>/clips/*.mp3``. Tables are dicts of columns
(``meta.utils``).
"""
import multiprocessing
import os

from lidbox_tpu_torch.meta.utils import (concat, read_csv, set_unique_index,
                                         sort_by_id, take_rows)

SPLIT_NAMES = ("train", "dev", "test")
USE_COLUMNS = ("client_id", "path", "sentence")


def load_split(corpus_dir, lang, split, usecols=USE_COLUMNS):
    """One split tsv -> table with utterance ``id`` from the mp3 stem,
    absolute clip ``path``, and ``client_id`` prefixed with the language to
    avoid cross-dataset collisions (reference: common_voice.py:32-46)."""
    table = read_csv(os.path.join(corpus_dir, lang, split + ".tsv"),
                     delimiter="\t", usecols=list(usecols))
    n = len(table["path"])
    table["label"] = [lang] * n
    table["split"] = [split] * n
    # the filename stem, as rsplit(".", 1): '.mp3' inside a name stays
    table["id"] = [p.rsplit(".", 1)[0] for p in table["path"]]
    table["path"] = [os.path.join(corpus_dir, lang, "clips", p)
                     for p in table["path"]]
    table["client_id"] = [f"{lang}_{c}" for c in table["client_id"]]
    return table


def load(corpus_dir, lang, usecols=USE_COLUMNS):
    """All train/dev/test splits of one language as one table sorted by id
    (reference: common_voice.py:14-29)."""
    return sort_by_id(concat([load_split(corpus_dir, lang, s, usecols)
                              for s in SPLIT_NAMES]))


def load_all(corpus_dir, langs, usecols=USE_COLUMNS, num_processes=None):
    """Multiple languages merged with globally unique utterance ids, loaded
    in parallel processes (reference: common_voice.py:49-58)."""
    if num_processes is None:
        num_processes = os.cpu_count()
    if num_processes and num_processes > 1 and len(langs) > 1:
        with multiprocessing.Pool(processes=num_processes) as pool:
            tables = pool.starmap(
                load, ((corpus_dir, lang, usecols) for lang in langs))
    else:
        tables = [load(corpus_dir, lang, usecols) for lang in langs]
    return sort_by_id(concat(tables))


def load_all_validated_data(meta, corpus_dir, lang, usecols=USE_COLUMNS):
    """Merge ``validated.tsv`` rows as extra training data, excluding any
    speaker already present in non-train splits; duplicates by id are
    dropped keeping the existing row (reference: common_voice.py:61-78)."""
    validated = load_split(corpus_dir, lang, "validated", usecols)
    nontrain = {c for c, s in zip(meta["client_id"], meta["split"])
                if s != "train"}
    validated = take_rows(validated, [i for i, c in enumerate(
        validated["client_id"]) if c not in nontrain])
    validated["split"] = ["train"] * len(validated["id"])
    seen = set(meta["id"])
    new_rows = []
    for i, uid in enumerate(validated["id"]):
        if uid not in seen:
            seen.add(uid)
            new_rows.append(i)
    merged = concat([meta, take_rows(validated, new_rows)])
    return sort_by_id(set_unique_index(merged))
