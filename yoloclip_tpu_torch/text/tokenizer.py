"""Host-side CLIP byte-pair-encoding tokenizer (pure Python, no torch/clip).

The port's copy of `yoloclip_tpu/text/tokenizer.py`. It implements the
public CLIP tokenization scheme of `clip.tokenize`: lowercase +
whitespace-collapse, byte->unicode mapping, BPE over a 48,894-merge table,
vocabulary laid out as [256 byte symbols, 256 byte</w> symbols, merges...,
<|startoftext|>, <|endoftext|>], context length 77 with SOT/EOT framing and
zero padding.

The merges table ships with OpenAI CLIP as `bpe_simple_vocab_16e6.txt.gz`.
The loader searches, in order, env `CLIP_BPE_PATH`, `~/.cache/clip/` and
this package's `text/assets/`; it downloads nothing. When no file is found
the tokenizer runs with ZERO merges: every word splits into byte symbols (+
`</w>` on the last), which are exactly the first 512 entries of the real
CLIP vocabulary -- token ids remain valid CLIP ids, so the text tower still
consumes them; only the segmentation (and thus embedding quality with real
CLIP weights) differs. `degraded` is True in that mode.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
N_MERGES = VOCAB_SIZE - 512 - 2  # 48894

# CLIP's word-splitting pattern is
#   <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|
#   [\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+
# (IGNORECASE). stdlib `re` lacks \p classes, so `word_split` below scans
# with unicodedata general categories instead -- exact \p{L}/\p{N}
# semantics for non-ASCII prompts ("café", "日本").

_SPECIALS = ('<|startoftext|>', '<|endoftext|>')
# tried in the regex's alternation order ('s before 'll etc.)
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _is_letter(c: str) -> bool:
    return unicodedata.category(c).startswith('L')     # \p{L}


def _is_number(c: str) -> bool:
    return unicodedata.category(c).startswith('N')     # \p{N}


def word_split(text: str) -> List[str]:
    """CLIP word-splitting regex as a unicodedata scanner.

    Alternation semantics are preserved: alternatives are only tried at
    match START positions, so e.g. an apostrophe swallowed by a preceding
    punctuation run never becomes a contraction (matching the greedy
    `[^\\s\\p{L}\\p{N}]+`). Input is expected pre-lowercased (encode()
    lowercases, like the reference's clip.tokenize)."""
    tokens: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
            continue
        special = next((s for s in _SPECIALS if text.startswith(s, i)), None)
        if special is not None:
            tokens.append(special)
            i += len(special)
            continue
        if c == "'":
            head = text[i:i + 3].lower()
            con = next((k for k in _CONTRACTIONS if head.startswith(k)), None)
            if con is not None:
                tokens.append(text[i:i + len(con)])
                i += len(con)
                continue
        if _is_letter(c):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
            tokens.append(text[i:j])
            i = j
            continue
        if _is_number(c):     # [\p{N}] matches ONE numeral at a time
            tokens.append(c)
            i += 1
            continue
        j = i + 1
        while j < n and not (text[j].isspace() or _is_letter(text[j])
                             or _is_number(text[j])):
            j += 1
        tokens.append(text[i:j])
        i = j
    return tokens


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (standard GPT-2/CLIP table)."""
    bs = (list(range(ord('!'), ord('~') + 1)) +
          list(range(ord('\xa1'), ord('\xac') + 1)) +
          list(range(ord('\xae'), ord('\xff') + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _basic_clean(text: str) -> str:
    # CLIP runs ftfy.fix_text (entity decode + mojibake repair + NFC)
    # then a double html.unescape; for well-formed input that reduces to
    # unescape-then-NFC. Order matters for escaped combining marks:
    # "e&#769;tude" must compose to U+00E9 "etude" -- NFC before
    # unescape would leave a decomposed e+U+0301 pair that word_split
    # then breaks apart.
    text = html.unescape(html.unescape(text))
    text = unicodedata.normalize('NFC', text)
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r'\s+', ' ', text).strip()


def find_bpe_file() -> Optional[str]:
    env = os.environ.get('CLIP_BPE_PATH')
    candidates = [env] if env else []
    candidates += [
        os.path.expanduser('~/.cache/clip/bpe_simple_vocab_16e6.txt.gz'),
        os.path.join(os.path.dirname(__file__), 'assets',
                     'bpe_simple_vocab_16e6.txt.gz'),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


class CLIPTokenizer:
    """Byte-level BPE tokenizer with the CLIP vocabulary layout."""

    def __init__(self, bpe_path: Optional[str] = None,
                 merges: Optional[Sequence[Tuple[str, str]]] = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        if merges is None:
            path = bpe_path or find_bpe_file()
            if path is not None:
                with gzip.open(path, 'rt', encoding='utf-8') as f:
                    lines = f.read().split('\n')
                # standard file layout: header line, then merge pairs.
                # Truncated fixtures leave trailing blank lines -- drop
                # anything that isn't a pair.
                merges = [m for m in
                          (tuple(ln.split()) for ln in lines[1:N_MERGES + 1])
                          if len(m) == 2]
            else:
                merges = []
        self.merges = list(merges)

        vocab = list(self.byte_encoder.values())
        vocab += [v + '</w>' for v in vocab]
        vocab += [''.join(m) for m in self.merges]
        self.encoder: Dict[str, int] = {t: i for i, t in enumerate(vocab)}
        # Specials sit at their fixed CLIP ids (49406/49407) even when the
        # merge table is short/absent, so token ids always index the real
        # CLIP embedding table.
        self.encoder['<|startoftext|>'] = VOCAB_SIZE - 2
        self.encoder['<|endoftext|>'] = VOCAB_SIZE - 1
        self.decoder: Dict[int, str] = {i: t for t, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(self.merges)}
        self.sot = self.encoder['<|startoftext|>']
        self.eot = self.encoder['<|endoftext|>']
        self._cache: Dict[str, str] = {}
        self.degraded = len(self.merges) == 0

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + '</w>',)
        pairs = _get_pairs(word)
        if not pairs:
            return token + '</w>'
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float('inf')))
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
            pairs = _get_pairs(word)
        result = ' '.join(word)
        self._cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for tok in word_split(text):
            tok = ''.join(self.byte_encoder[b] for b in tok.encode('utf-8'))
            ids.extend(self.encoder[t] for t in self.bpe(tok).split(' '))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = ''.join(self.decoder.get(i, '') for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode('utf-8', errors='replace').replace('</w>', ' ')

    def tokenize(self, texts: Sequence[str] | str,
                 context_length: int = CONTEXT_LENGTH,
                 truncate: bool = True) -> np.ndarray:
        """Batch of prompts -> (N, context_length) int32 with SOT/EOT + pad."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > context_length:
                if not truncate:
                    raise ValueError(
                        f'Prompt too long for context {context_length}: {text!r}')
                ids = ids[:context_length]
                ids[-1] = self.eot
            out[i, :len(ids)] = ids
        return out


@functools.lru_cache()
def default_tokenizer() -> CLIPTokenizer:
    return CLIPTokenizer()
