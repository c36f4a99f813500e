"""Dataset ETL: session pickles <-> CSV flattening.

Equivalent of decompose_data.py:5-43: flattens session lists into
per-action CSV rows ``[session_id, timestamp, action_type, keyword, asin]``
and a distinct-asin catalog ``[asin, product_type, brand, title]``; plus the
inverse (CSV -> sessions) the reference lacks, so public filtered-Amazon
dumps in that schema can be loaded directly.
"""

from __future__ import annotations

import csv
import pickle
from typing import Dict, List, Sequence, Tuple

from sessionsimilaritysearch.data.schema import Action

ACTION_HEADER = ["session_id", "timestamp", "action type", "keyword", "asin"]
ASIN_HEADER = ["asin", "product type", "brand", "product title"]


def decompose_sessions(
    sessions: Sequence,
    actions_csv: str,
    asin_csv: str,
    id_offset: int = 0,
) -> None:
    """Flatten sessions to CSVs (decompose_data.py:8-43)."""
    rows = []
    catalog: Dict[str, tuple] = {}
    for i, session in enumerate(sessions):
        for a in session:
            rows.append([i + id_offset, a[0], a[1], a[2], a[3]])
            if a[3] is not None and a[3] not in catalog:
                catalog[a[3]] = (a[3], a[4], a[5], a[6])
    with open(actions_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(ACTION_HEADER)
        w.writerows(rows)
    with open(asin_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(ASIN_HEADER)
        w.writerows(catalog.values())


def load_sessions_from_csv(
    actions_csv: str, asin_csv: str
) -> Tuple[List[List[Action]], Dict[str, int]]:
    """Rebuild sessions (with integer asin ids appended) from the CSV pair.

    Returns (sessions, asin2id); ids start at 1 (0 = unknown product,
    matching util_amazon_filtered.py:133)."""
    catalog: Dict[str, tuple] = {}
    with open(asin_csv, newline="") as f:
        r = csv.reader(f)
        next(r)
        for asin, ptype, brand, title in r:
            catalog[asin] = (ptype or None, brand or None, title or None)

    asin2id: Dict[str, int] = {}
    sessions: Dict[int, List[Action]] = {}
    with open(actions_csv, newline="") as f:
        r = csv.reader(f)
        next(r)
        for sid, ts, atype, keyword, asin in r:
            sid = int(sid)
            if atype == "s":
                act = Action(float(ts), "s", keyword or None, None, None,
                             None, None, 0)
            else:
                if asin not in asin2id:
                    asin2id[asin] = len(asin2id) + 1
                ptype, brand, title = catalog.get(asin, (None, None, None))
                act = Action(float(ts), atype, None, asin, ptype, brand,
                             title, asin2id[asin])
            sessions.setdefault(sid, []).append(act)
    ordered = [sessions[k] for k in sorted(sessions)]
    return ordered, asin2id


def save_sessions(sessions, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(sessions, f, protocol=4)


def load_sessions(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def sessions_from_item_sequences(seqs: Sequence[Sequence[int]]):
    """Convert bare item-id sequences (the Yoochoose format consumed at
    test_amazon_filterd.py:102-103: lists of clicked item ids, no queries /
    titles / types) into schema sessions."""
    out = []
    for seq in seqs:
        out.append([
            Action(float(i), "c", None, str(item), None, None, None, int(item))
            for i, item in enumerate(seq)
        ])
    return out


def split_prefix_future(sessions, rng, min_prefix: int = 1):
    """Turn full sessions into (prefix, future) training pairs -- the
    us-filtered-split-* construction implied by fine_tune_ours.py:169-171."""
    out = []
    for s in sessions:
        if len(s) < 2:
            out.append((list(s), []))
            continue
        cut = int(rng.integers(min_prefix, len(s)))
        out.append((list(s[:cut]), list(s[cut:])))
    return out
