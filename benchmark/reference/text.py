"""Text normalisation and the UTF-8 byte tokenizer of the published
inference (inference.py:115-136, 192-214): BOS = 0, padded to a fixed
width with a boolean mask."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def normalize_text(text: str) -> str:
    text = text.replace("…", "...")
    text = text.replace("’", "'")
    text = text.replace("”", '"')
    text = text.replace("\n", " ")
    text = text.replace(":", ",")
    text = text.replace(";", ",")
    text = text.replace("—", ", ")
    if (not text.startswith("[") and not text.startswith("(")
            and "S1" not in text and "S2" not in text):
        text = "[S1] " + text
    return text


def text_ids(texts: List[str], width: int) -> Tuple[np.ndarray, np.ndarray]:
    """(ids int64 (B, width), mask bool (B, width))."""
    ids = np.zeros((len(texts), width), np.int64)
    mask = np.zeros((len(texts), width), bool)
    for i, text in enumerate(texts):
        b = [0] + list(normalize_text(text).encode("utf-8"))
        n = min(len(b), width)
        ids[i, :n] = b[:n]
        mask[i, :n] = True
    return ids, mask
