"""Self-contained CLIP byte-level BPE tokenizer (copy of the JAX package's
``models/sd/tokenizer.py``), without the ``regex`` package.

Prompts are tokenized from the ``vocab.json`` + ``merges.txt`` that every
SD checkpoint ships in ``tokenizer/`` (or openai/CLIP's single-file
``bpe_simple_vocab_16e6.txt.gz``): GPT-2 byte->unicode mapping, a
word-level split, BPE merges with the ``</w>`` end-of-word marker,
``<|startoftext|>``/``<|endoftext|>`` specials and a fixed 77-token
context.

The JAX tokenizer splits words with the ``regex`` pattern
``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
[^\\s\\p{L}\\p{N}]+`` under ``IGNORECASE``. Stdlib ``re`` cannot express
it (``[^\\W\\d_]`` takes ``No``/``Nl`` characters such as ``²`` and ``Ⅻ``
for letters), so ``split_words`` is a scanner over
``unicodedata.category`` that takes, at each position, the first of:
a special token, a contraction, a run of ``L*`` characters, one ``N*``
character, a run of anything else that is not whitespace. Two quirks of
``regex``'s case-insensitive classes are kept: ``ſ`` (U+017F) folds to
``s`` in the literals, and U+0345 (a combining mark whose case fold is a
letter) belongs to no class, so it is skipped like whitespace.
``tests/test_torch_sd_tokenizer.py`` holds the scanner against the JAX
tokenizer token for token.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import unicodedata

import numpy as np

_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# Unicode White_Space, which ``regex``'s ``\s`` matches (``str.isspace``
# also takes U+001C-U+001F)
_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(chr(c) for c in range(0x2000, 0x200B)))
# the one character besides the case pairs that ``regex`` matches
# case-insensitively to an ASCII letter of the literals
_FOLD = {"\u017f": "s"}
_SKIPPED = frozenset("\u0345")


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte->printable-unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _whitespace_clean(text: str) -> str:
    """``regex.sub(r"\\s+", " ", text).strip()``."""
    out, in_space = [], False
    for c in text:
        if c in _WHITESPACE:
            if not in_space:
                out.append(" ")
            in_space = True
        else:
            out.append(c)
            in_space = False
    return "".join(out).strip()


def _kind(c: str) -> str:
    """``"L"``, ``"N"``, ``" "`` (whitespace or skipped) or ``"O"``."""
    if c in _WHITESPACE or c in _SKIPPED:
        return " "
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "O"


def _literal_at(text: str, i: int, literal: str) -> bool:
    if i + len(literal) > len(text):
        return False
    return all(_FOLD.get(c, c.lower()) == want
               for c, want in zip(text[i:i + len(literal)], literal))


def split_words(text: str) -> list[str]:
    """The JAX tokenizer's ``regex.findall`` split of (lower-cased) text."""
    out, i, n = [], 0, len(text)
    while i < n:
        lit = next((s for s in _SPECIALS + _CONTRACTIONS if _literal_at(text, i, s)), None)
        if lit is not None:
            out.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        kind = _kind(text[i])
        if kind == " ":
            i += 1
            continue
        if kind == "N":
            out.append(text[i])
            i += 1
            continue
        j = i + 1
        while j < n and _kind(text[j]) == kind:
            j += 1
        out.append(text[i:j])
        i = j
    return out


class CLIPTokenizer:
    """vocab: token string -> id; merges: ordered (a, b) pairs."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 bos: str = "<|startoftext|>", eos: str = "<|endoftext|>",
                 pad: str | None = None, context_length: int = 77):
        self.encoder = dict(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos_id = self.encoder[bos]
        self.eos_id = self.encoder[eos]
        self.pad_id = self.encoder[pad] if pad else self.eos_id
        self.context_length = context_length
        self._cache: dict[str, list[str]] = {bos: [bos], eos: [eos]}

    @classmethod
    def from_dir(cls, path: str, **kw) -> "CLIPTokenizer":
        """HF-format ``vocab.json`` + ``merges.txt`` (an SD checkpoint's
        ``tokenizer/`` folder); the pad token from ``tokenizer_config.json``
        when it names one (SD-2.x pads with ``!``)."""
        with open(os.path.join(path, "vocab.json")) as f:
            vocab = json.load(f)
        merges = []
        with open(os.path.join(path, "merges.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        pad = None
        cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                pt = json.load(f).get("pad_token")
            if isinstance(pt, dict):
                pt = pt.get("content")
            if pt in vocab:
                pad = pt
        return cls(vocab, merges, pad=pad, **kw)

    @classmethod
    def from_gzip(cls, path: str, **kw) -> "CLIPTokenizer":
        """openai/CLIP's ``bpe_simple_vocab_16e6.txt.gz``, padded with ``!``
        as the SD-2.x HF tokenizers pad."""
        with gzip.open(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines[1:48895]]
        byte_vocab = list(bytes_to_unicode().values())
        tokens = byte_vocab + [v + "</w>" for v in byte_vocab]
        tokens += ["".join(m) for m in merges]
        tokens += list(_SPECIALS)
        kw.setdefault("pad", "!")
        return cls({t: i for i, t in enumerate(tokens)}, merges, **kw)

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            a, b = best
            new_word: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    new_word.append(a + b)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        """Text -> BPE ids (no specials)."""
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: list[int] = []
        for token in split_words(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token))
        return ids

    def __call__(self, prompts: list[str] | str) -> np.ndarray:
        """Batch-encode to the fixed (B, 77) int32 context with bos/eos,
        padding and truncation (HF ``padding='max_length', truncation=True``)."""
        if isinstance(prompts, str):
            prompts = [prompts]
        n = self.context_length
        out = np.full((len(prompts), n), self.pad_id, np.int32)
        for i, p in enumerate(prompts):
            ids = [self.bos_id] + self.encode(p)[: n - 2] + [self.eos_id]
            out[i, : len(ids)] = ids
        return out
