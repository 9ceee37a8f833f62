"""CLIP byte-level BPE tokenizer (counterpart of
``image_restoration_agent_tpu/retrieval/tokenizer.py``, the ``clip.tokenize``
path the reference calls for its retrieval caption).

The merges table (``bpe_simple_vocab_16e6.txt.gz``) ships with CLIP
checkpoints, not with this repo: point ``SimpleTokenizer`` at it. Text
cleaning uses ftfy where installed; plain ASCII captions (the agent only
ever tokenizes "similar degradation") are unaffected by its absence.

The JAX package splits words with the third-party ``regex`` module's
``\\p{L}`` (letters) and ``\\p{N}`` (numbers). The port uses the standard
library's ``re``: letters are ``[^\\W\\d_]`` and numbers ``\\d``. They agree
on every assigned character but the numbers that are not decimal digits
(Unicode categories Nl and No: ``½``, ``²``, Roman numerals, circled
digits), which ``re`` counts as word characters, so they join a run of
letters where ``\\p{N}`` makes each one a token of its own; the four
information separators U+001C-U+001F, whitespace to ``re`` (and so also
to ``_clean``); and U+0345, which ``regex`` case-folds to a letter.
"""

from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from pathlib import Path

import numpy as np

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"

_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
    re.IGNORECASE)


@lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2/CLIP convention)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text: str) -> str:
    try:
        import ftfy
        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text.strip()).lower()


class SimpleTokenizer:
    def __init__(self, bpe_path: str | Path):
        bpe_path = Path(bpe_path)
        if not bpe_path.exists():
            raise FileNotFoundError(
                f"BPE merges file not found at {bpe_path}; put "
                "bpe_simple_vocab_16e6.txt.gz beside the CLIP weights")
        self.byte_encoder = bytes_to_unicode()
        with gzip.open(bpe_path) as f:
            merges = f.read().decode("utf-8").split("\n")
        merges = merges[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT, EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {SOT: SOT, EOT: EOT}
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first \
                        and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for token in _PAT.findall(_clean(text)):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def tokenize(self, texts: str | list[str],
                 context_length: int = 77) -> np.ndarray:
        """(N, context_length) int32, SOT/EOT-delimited, zero-padded (the
        ``clip.tokenize`` contract); a text too long for the context keeps
        its first ``context_length - 1`` ids and ends in EOT."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > context_length:
                ids = ids[:context_length]
                ids[-1] = self.eot_id
            out[i, : len(ids)] = ids
        return out
