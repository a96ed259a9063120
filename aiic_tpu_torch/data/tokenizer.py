"""CLIP byte-pair-encoding tokenizer (host-side, pure Python) — the port's
own copy of ``aiic_tpu.data.tokenizer``, held to it by
``tests/test_torch_bridge.py``. The merges file is looked up by
``AIIC_BPE_PATH`` or beside this file, never in the JAX package.

Implements the exact tokenization pipeline the reference depends on through
``clip.tokenize`` (reference main.py:180, main.py:307, train_lora.py:153):

  text -> unicode fixup -> whitespace collapse -> lowercase
       -> regex word split -> byte-level BPE with ``</w>`` word suffix
       -> [SOT] ids [EOT] padded to 77.

Vocabulary: when the standard ``bpe_simple_vocab_16e6.txt.gz`` merges file is
available (env ``AIIC_BPE_PATH`` or alongside this file) we reproduce OpenAI
CLIP's 49,408-token vocabulary exactly. The build environment has no network
egress and does not ship that file, so the default is a **hermetic fallback
vocabulary**: the same 256 byte tokens + 256 ``</w>`` byte tokens at the same
ids, zero merges (every word encodes to its byte sequence), and SOT/EOT at
49406/49407 — identical tensor shapes and special-token semantics, fully
deterministic, swap-in compatible with the real merges file.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import regex as re

SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"
VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77

# Merge count in OpenAI CLIP's bpe_simple_vocab_16e6.txt.gz after the
# header, truncated the way clip.simple_tokenizer does: 49152-256-2 entries.
_REAL_CLIP_MERGES = 49152 - 256 - 2


def _file_sha256(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


_WORD_PATTERN = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE,
)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte -> printable unicode char mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def basic_clean(text: str) -> str:
    """Unicode fixup. Uses ftfy when importable; otherwise a deterministic
    approximation (double html-unescape + NFC normalization)."""
    try:
        import ftfy  # optional dependency, absent in this environment

        text = ftfy.fix_text(text)
    except ImportError:
        text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


class ClipTokenizer:
    """Byte-level BPE tokenizer with CLIP semantics."""

    def __init__(self, bpe_path: Optional[str] = None, context_length: int = CONTEXT_LENGTH):
        self.context_length = context_length
        byte_encoder = bytes_to_unicode()
        self.byte_encoder = byte_encoder
        self.byte_decoder = {v: k for k, v in byte_encoder.items()}

        vocab: List[str] = list(byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]

        merges: List[Tuple[str, str]] = []
        bpe_path = bpe_path or os.environ.get("AIIC_BPE_PATH") or self._default_bpe_path()
        self.bpe_path = bpe_path if (bpe_path and os.path.exists(bpe_path)) else None
        if self.bpe_path:
            expected_sha = os.environ.get("AIIC_BPE_SHA256")
            if expected_sha:
                got = _file_sha256(self.bpe_path)
                if got != expected_sha.lower():
                    raise ValueError(
                        f"BPE merges file {self.bpe_path} sha256 {got} != "
                        f"AIIC_BPE_SHA256 {expected_sha} — refusing to build "
                        "text features from a corrupted/wrong vocabulary"
                    )
            with gzip.open(self.bpe_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # Standard file layout: header line, then 48894 merges used by CLIP.
            raw = lines[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in raw if m]
            if len(merges) != _REAL_CLIP_MERGES:
                import warnings

                warnings.warn(
                    f"BPE file {self.bpe_path} has {len(merges)} merges; the "
                    f"real CLIP bpe_simple_vocab_16e6.txt.gz has "
                    f"{_REAL_CLIP_MERGES}. Token ids will NOT match OpenAI "
                    "CLIP unless this is intentional (test fixture).",
                    stacklevel=2,
                )
            vocab.extend("".join(m) for m in merges)
            vocab.extend([SOT_TOKEN, EOT_TOKEN])
            self.hermetic = False
        else:
            # Hermetic fallback: byte vocabulary only, specials pinned to the
            # real CLIP ids so embedding tables keep their (49408, W) shape.
            self.hermetic = True

        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        if self.hermetic:
            self.encoder[SOT_TOKEN] = VOCAB_SIZE - 2
            self.encoder[EOT_TOKEN] = VOCAB_SIZE - 1
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}
        self.sot = self.encoder[SOT_TOKEN]
        self.eot = self.encoder[EOT_TOKEN]
        self.vocab_size = VOCAB_SIZE if self.hermetic else len(self.encoder)

    @staticmethod
    def _default_bpe_path() -> Optional[str]:
        here = os.path.dirname(os.path.abspath(__file__))
        cand = os.path.join(here, "bpe_simple_vocab_16e6.txt.gz")
        return cand if os.path.exists(cand) else None

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if not self.bpe_ranks:
            out = " ".join(word)
            self.cache[token] = out
            return out
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
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
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for word in re.findall(_WORD_PATTERN, text):
            word = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(word).split(" "))
        return tokens

    def decode(self, tokens: Iterable[int]) -> str:
        # Strip SOT/EOT and trailing zero-padding only: in the real CLIP vocab
        # id 0 is the legitimate token '!', so dropping every 0 would lose it.
        toks = [int(t) for t in tokens]
        while toks and toks[-1] == 0:
            toks.pop()
        specials = {self.sot, self.eot}
        text = "".join(self.decoder.get(t, "") for t in toks if t not in specials)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def __call__(self, texts, truncate: bool = True) -> np.ndarray:
        """Tokenize to a (N, context_length) int32 array.

        Same contract as ``clip.tokenize`` (pad with 0, SOT/EOT wrapped);
        ``truncate=True`` clips long prompts and keeps EOT as the final token.
        """
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), self.context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > self.context_length:
                if not truncate:
                    raise ValueError(f"input too long for context {self.context_length}: {text!r}")
                ids = ids[: self.context_length]
                ids[-1] = self.eot
            result[i, : len(ids)] = ids
        return result


@functools.lru_cache()
def _default_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(texts, context_length: int = CONTEXT_LENGTH, truncate: bool = True) -> np.ndarray:
    tok = _default_tokenizer()
    if context_length != tok.context_length:
        tok = ClipTokenizer(context_length=context_length)
    return tok(texts, truncate=truncate)


def tokenize_for_model(texts, config, truncate: bool = True) -> np.ndarray:
    """Tokenize against a model config: clamps ids into ``config.vocab_size``
    while pinning SOT/EOT to the top two ids, so reduced-vocab test models
    (e.g. ``TINY_TEST``) keep the EOT-is-argmax pooling invariant."""
    ids = tokenize(texts, context_length=config.context_length, truncate=truncate)
    v = config.vocab_size
    if v >= VOCAB_SIZE:
        return ids
    out = ids % (v - 2)
    out = np.where(ids == VOCAB_SIZE - 2, v - 2, out)
    out = np.where(ids == VOCAB_SIZE - 1, v - 1, out)
    out = np.where(ids == 0, 0, out)
    return out.astype(np.int32)
