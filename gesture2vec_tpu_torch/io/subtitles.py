"""Transcript readers: Google-STT JSON (Trinity) and GENEA TSV.

The port's copy of the JAX package's `io/subtitles.py`.

Rebuild of SubtitleWrapper (ref: scripts/utils/data_utils.py:36-121 for
JSON, scripts/utils/data_utils_twh.py:36-115 for TSV). Returns uniform
word lists [[word, start_s, end_s], ...] with reference-identical text
normalization.
"""
from __future__ import annotations

import json
from typing import List

from gesture2vec_tpu_torch.text.vocab import normalize_string


def _parse_ts(value) -> float:
    """Timestamps like '1.200s' or plain numbers."""
    if isinstance(value, str):
        return float(value.rstrip("s"))
    return float(value)


def read_subtitle_json(path: str) -> List[List]:
    """Google SpeechToText JSON: results[].alternatives[0].words[] with
    word/startTime/endTime, or a flat list of {word, start_time,
    end_time} dicts (the layout the reference iterates,
    ref: trinity_data_to_lmdb.py:107-115)."""
    with open(path) as f:
        data = json.load(f)

    raw = []
    if isinstance(data, dict) and "results" in data:
        for res in data["results"]:
            alt = res["alternatives"][0]
            for w in alt.get("words", []):
                raw.append((w["word"], _parse_ts(w["startTime"]),
                            _parse_ts(w["endTime"])))
    else:
        for w in data:
            raw.append((w["word"], _parse_ts(w["start_time"]),
                        _parse_ts(w["end_time"])))

    out = []
    for word, s, e in raw:
        norm = normalize_string(word)
        if norm:
            out.append([norm, s, e])
    return out


def read_subtitle_tsv(path: str) -> List[List]:
    """GENEA TSV: start\tend\tword per line
    (ref: utils/data_utils_twh.py:36-115)."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            s, e, word = float(parts[0]), float(parts[1]), parts[2]
            norm = normalize_string(word)
            if norm:
                out.append([norm, s, e])
    return out


def read_subtitles(path: str) -> List[List]:
    if path.endswith(".tsv"):
        return read_subtitle_tsv(path)
    return read_subtitle_json(path)
