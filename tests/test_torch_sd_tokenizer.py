"""The port's CLIP BPE tokenizer (no ``regex`` package) against the JAX
package's, token for token, on a fabricated HF ``vocab.json`` +
``merges.txt`` (``tests/test_sd_tokenizer.py``'s), the same files with a
pad token in ``tokenizer_config.json``, and an openai-format gzip file.
The corpus: ``tests/test_sd_tokenizer.py``'s prompts and the characters
where a stdlib ``re`` split or ``str.isspace`` would part from ``regex``:
``No``/``Nl`` numbers, a decomposed accent, CJK, an emoji, ``_``, the
specials, upper-case contractions, ``ſ`` (which ``regex`` folds to ``s``),
U+0345 (which no class of ``regex``'s takes) and U+001C (whitespace to
``str.isspace`` only)."""

import gzip
import json
import os
import sys

import numpy as np
import pytest
import regex

from midvision_probe_torch.models.sd import tokenizer as t_tok
from midvision_probe_tpu.models.sd import tokenizer as j_tok

sys.path.insert(0, os.path.dirname(__file__))

from test_sd_tokenizer import PROMPTS, tok_dir  # noqa: E402,F401

CORPUS = PROMPTS + [
    "x² + y² = z²", "½ cup, ¾ done", "Ⅻ o'clock ⅻ", "café café", "漢字とカタカナ 한국어",
    "a 😀 emoji 🐈‍⬛", "snake_case__name", "it's <|startoftext|> the <|endoftext|> end",
    "THEY'LL WE'RE I'M YOU'VE HE'D DON'T", "it'ſ ſ", "ͅaͅb", "a\x1cb \x1c",
    "tab\tnew\nline　wide thin\xa0nbsp", "&amp;amp; &lt;tag&gt; &#39;s",
    "'''s ''t ''", "12345 6.7e-8 ٣٤ ५", "  leading and trailing  ",
]


@pytest.mark.parametrize("text", CORPUS)
def test_split_matches_the_regex_split(text):
    for t in (text, text.lower()):
        assert t_tok.split_words(t) == regex.findall(j_tok._PAT, t)
    assert t_tok._whitespace_clean(text) == j_tok._whitespace_clean(text)


def test_from_dir_matches_jax_token_for_token(tok_dir):  # noqa: F811
    for pad in (None, "!"):
        cfg = os.path.join(tok_dir, "tokenizer_config.json")
        if pad:
            with open(cfg, "w") as f:
                json.dump({"pad_token": {"content": pad}}, f)
        try:
            got = t_tok.CLIPTokenizer.from_dir(tok_dir)(CORPUS)
            ref = j_tok.CLIPTokenizer.from_dir(tok_dir)(CORPUS)
        finally:
            if pad:
                os.remove(cfg)
        assert got.dtype == ref.dtype == np.int32 and got.shape == (len(CORPUS), 77)
        np.testing.assert_array_equal(got, ref)


def test_from_gzip_matches_jax(tmp_path):
    merges = [("t", "h"), ("th", "e</w>"), ("a", "t</w>"), ("c", "at</w>"), ("1", "2")]
    path = tmp_path / "bpe_simple_vocab_16e6.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    got = t_tok.CLIPTokenizer.from_gzip(str(path))
    ref = j_tok.CLIPTokenizer.from_gzip(str(path))
    assert got.encoder == ref.encoder and got.pad_id == ref.pad_id == got.encoder["!"]
    np.testing.assert_array_equal(got(CORPUS), ref(CORPUS))
