"""CLIP BPE tokenizer (pure Python, standard library only).

The port's copy of `rdm_tpu/utils/tokenizer.py`: OpenAI CLIP's byte-pair
encoding over the vocabulary `rdm_tpu_torch/assets/bpe_simple_vocab_16e6.txt.gz`
(OpenAI's released merge table, MIT licensed, the same file as the JAX
package's), so captions give the token ids the released CLIP weights
expect.

The JAX tokenizer splits text with the `regex` package's pattern
``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
[^\\s\\p{L}\\p{N}]+`` (IGNORECASE). Python's `re` has no ``\\p{..}``, and
``[^\\W\\d_]`` is not ``\\p{L}``: it also matches No / Nl characters such as
``²``, ``½`` and ``Ⅻ``. So the split here is a scanner over `unicodedata`
categories that gives that pattern's matches: a run of letters (L*), one
number character (N*), or a run of anything else that is not whitespace.
Whitespace is `regex`'s: Python's minus U+001C..U+001F. U+0345 (Mn, whose
case fold is a letter) falls out of the negated class under IGNORECASE,
so it splits like whitespace, as with `regex`.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import List, Sequence, Union

import numpy as np

_VOCAB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "bpe_simple_vocab_16e6.txt.gz")

CONTEXT_LENGTH = 77

# the pattern's leading alternatives, matched before the classes
_SPECIAL = re.compile(r"<\|startoftext\|>|<\|endoftext\|>"
                      r"|'s|'t|'re|'ve|'m|'ll|'d", re.IGNORECASE)
# `regex`'s \s, which leaves out the separators U+001C..U+001F
_NOT_SPACE = "\x1c\x1d\x1e\x1f"
_SPACE_RUN = re.compile(r"[^\S\x1c-\x1f]+")


@functools.lru_cache(maxsize=None)
def _kind(c: str) -> str:
    """'L' letter, 'N' number, ' ' split point, 'P' anything else."""
    cat = unicodedata.category(c)[0]
    if cat in "LN":
        return cat
    if c == "\u0345" or (c.isspace() and c not in _NOT_SPACE):
        return " "
    return "P"


def pretokenize(text: str) -> List[str]:
    """The JAX tokenizer's `re.findall(pat, text)` on cleaned text."""
    out, i, n = [], 0, len(text)
    while i < n:
        m = _SPECIAL.match(text, i)
        if m:
            out.append(m.group())
            i = m.end()
            continue
        kind = _kind(text[i])
        j = i + 1
        if kind in "LP":
            while j < n and _kind(text[j]) == kind:
                j += 1
        if kind != " ":
            out.append(text[i:j])
        i = j
    return out


@functools.lru_cache()
def bytes_to_unicode():
    """Bijective byte -> printable-unicode map (GPT-2 convention)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _pairs(word):
    return set(zip(word[:-1], word[1:]))


def _clean(text: str) -> str:
    """ftfy.fix_text when installed, else the JAX package's mojibake
    repair; html unescape twice; whitespace runs to one space; strip;
    lower case."""
    try:
        import ftfy  # optional dependency
        text = ftfy.fix_text(text)
    except ImportError:
        text = _fix_mojibake(text)
    text = html.unescape(html.unescape(text))
    text = _SPACE_RUN.sub(" ", text)
    return text.strip().lower()


def _fix_mojibake(text: str) -> str:
    """Repair UTF-8 text that was decoded as latin-1 / cp1252."""
    if text.isascii():
        return text
    for enc in ("latin-1", "cp1252"):
        try:
            fixed = text.encode(enc).decode("utf-8")
        except (UnicodeEncodeError, UnicodeDecodeError):
            continue
        if fixed != text and any(ord(c) > 0x7F for c in fixed):
            return fixed
    return text


class ClipTokenizer:
    def __init__(self, vocab_path: str = _VOCAB_PATH):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            merge_lines = f.read().split("\n")
        # header line first; 48894 merges used by CLIP
        merge_lines = merge_lines[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merge_lines]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.sot_token = self.encoder["<|startoftext|>"]
        self.eot_token = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        for token in pretokenize(_clean(text)):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t]
                              for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def default_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(texts: Union[str, Sequence[str]],
             context_length: int = CONTEXT_LENGTH,
             truncate: bool = True) -> np.ndarray:
    """[SOT] + BPE tokens + [EOT], zero-padded to `context_length`, int32
    [len(texts), context_length]; `truncate` clips a long caption and keeps
    the final EOT."""
    if isinstance(texts, str):
        texts = [texts]
    tok = default_tokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [tok.sot_token] + tok.encode(text) + [tok.eot_token]
        if len(ids) > context_length:
            if not truncate:
                raise ValueError(f"input {text!r} is too long for context "
                                 f"{context_length}")
            ids = ids[:context_length - 1] + [tok.eot_token]
        result[i, :len(ids)] = ids
    return result
