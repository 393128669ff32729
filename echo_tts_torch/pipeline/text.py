"""Host text stack: byte tokenizer, normalization, chunkers.

Bit-identical re-implementation of the reference host text processing
(reference: inference.py:115-214, handler.py:49-123).  Pure Python/numpy —
no torch.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

_WHITESPACE_RE = re.compile(r"\s+")


def normalize_text(text: str) -> str:
    """Normalization applied before byte-tokenizing
    (reference: inference.py:117-127).  Note the reference replaces the
    right curly double-quote twice and never the left one; we keep the
    exact same (asymmetric) substitutions."""
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


def tokenizer_encode(text: str, append_bos: bool = True,
                     normalize: bool = True,
                     return_normalized_text: bool = False):
    """UTF-8 byte tokenizer with BOS=0 (reference: inference.py:115-136)."""
    if normalize:
        text = normalize_text(text)
    b = list(text.encode("utf-8"))
    if append_bos:
        b.insert(0, 0)
    ids = np.asarray(b, dtype=np.int32)
    if return_normalized_text:
        return ids, text
    return ids


def dia_text_ids(texts: List[str], length: int = 1024,
                 pad: int = 0) -> np.ndarray:
    """Dia's byte encoding (dia/model.py _prepare_text_input): each text's
    UTF-8 bytes with "[S1]" and "[S2]" as 0x01 and 0x02, cut to `length`
    or padded with `pad` to it; (len(texts), length) int64."""
    out = np.full((len(texts), length), pad, np.int64)
    for i, text in enumerate(texts):
        b = (text.encode("utf-8").replace(b"[S1]", b"\x01")
             .replace(b"[S2]", b"\x02"))[:length]
        out[i, :len(b)] = list(b)
    return out


def chunk_text(text: str, max_chars: int = 300) -> List[str]:
    """<= max_chars chunks preferring sentence > clause > space boundaries
    (reference: inference.py:140-190 == handler.py:49-99)."""
    if max_chars <= 0:
        raise ValueError("max_chars must be > 0")

    text = _WHITESPACE_RE.sub(" ", (text or "")).strip()
    if not text:
        return []

    if len(text) <= max_chars:
        return [text]

    sentence_enders = {".", "!", "?"}
    clause_enders = {",", ";", ":"}
    closers = {'"', "'", ")", "]", "}", "”", "’"}

    chunks: List[str] = []
    remaining = text
    while remaining:
        if len(remaining) <= max_chars:
            chunks.append(remaining)
            break

        window = remaining[: max_chars + 1]
        candidate_sentence = None
        candidate_clause = None
        candidate_space = None

        for i in range(1, len(window)):
            if not window[i].isspace():
                continue

            candidate_space = i
            prev = window[i - 1]
            prev2 = window[i - 2] if i >= 2 else ""

            if prev in sentence_enders or (prev in closers
                                           and prev2 in sentence_enders):
                candidate_sentence = i
            elif prev in clause_enders or (prev in closers
                                           and prev2 in clause_enders):
                candidate_clause = i

        split_at = (candidate_sentence or candidate_clause
                    or candidate_space or max_chars)
        chunk = remaining[:split_at].strip()
        if chunk:
            chunks.append(chunk)

        remaining = remaining[split_at:].strip()

    return chunks


def chunk_text_for_audio(text: str, max_chars: int = 300,
                         target_duration_seconds: float = 10.0) -> List[str]:
    """Audio-aware chunking: ~12 chars/sec heuristic, merge a too-short
    final chunk (reference: handler.py:102-123)."""
    target_chars = min(max_chars, int(target_duration_seconds * 12))
    chunks = chunk_text(text, max_chars=target_chars)
    if len(chunks) > 1 and len(chunks[-1]) < 24:
        chunks[-2] += " " + chunks[-1]
        chunks.pop()
    return chunks


def get_text_input_ids_and_mask(
    text_arr: List[str],
    max_length: Optional[int],
    normalize: bool = True,
    return_normalized_text: bool = False,
) -> Tuple[np.ndarray, np.ndarray] | Tuple[np.ndarray, np.ndarray, List[str]]:
    """Batch byte-encode + pad (reference: inference.py:192-214).
    Returns int32 ids and bool mask, numpy."""
    encoded = [tokenizer_encode(t, normalize=normalize,
                                return_normalized_text=True)
               for t in text_arr]
    if max_length is None:
        max_length = max(len(e) for e, _ in encoded)

    tokens = np.zeros((len(text_arr), max_length), dtype=np.int32)
    mask = np.zeros((len(text_arr), max_length), dtype=bool)
    for i, (ids, _) in enumerate(encoded):
        n = min(len(ids), max_length)
        tokens[i, :n] = ids[:n]
        mask[i, :n] = True

    if return_normalized_text:
        return tokens, mask, [t for _, t in encoded]
    return tokens, mask


def find_min_bucket_gte(values_str: str, actual_length: int) -> Optional[int]:
    """Static-shape bucket selection (reference: gradio_app.py:128-155)."""
    if not values_str or not values_str.strip():
        return None
    values_str = values_str.strip()
    if "," not in values_str:
        return int(values_str)
    values = [int(v.strip()) for v in values_str.split(",") if v.strip()]
    if not values:
        return None
    candidates = [v for v in values if v >= actual_length]
    if candidates:
        return min(candidates)
    return max(values)
