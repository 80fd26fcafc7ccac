"""Text encodings for the federated NLP datasets (host side, numpy).

Port of ``fedml_tpu/data/text.py``: the Shakespeare char vocabulary (86
TFF characters with pad, bos, eos and oov: 90 symbols, windows of 80),
the StackOverflow word vocabulary (the top-k words of a
``stackoverflow.word_count`` file, bos/eos/pad framing at length 20,
crc32 out-of-vocabulary buckets), and the tag-prediction features (a
10k bag of words and a 500-tag multi-hot).  Outputs are int32 / float32
numpy arrays for `stacking.stack_client_data`."""

from __future__ import annotations

import json
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

# The TFF text-generation tutorial vocabulary (86 printable chars, ordered by
# frequency). language_utils.py:11-13 / fed_shakespeare/utils.py:19-21.
CHAR_VOCAB = list(
    'dhlptx@DHLPTX $(,048cgkoswCGKOSW[_#\'/37;?bfjnrvzBFJNRVZ"&*.26:\naeimquyAEIMQUY]!%)-159\r'
)
SHAKESPEARE_SEQ_LEN = 80


class CharVocab:
    """fed_shakespeare token layout: [pad] + chars + [bos] + [eos], oov = size
    (fed_shakespeare/utils.py:24-33,47-52)."""

    def __init__(self, chars: Sequence[str] = CHAR_VOCAB):
        self.pad = 0
        self._ids = {c: i + 1 for i, c in enumerate(chars)}
        self.bos = len(chars) + 1
        self.eos = len(chars) + 2
        self.oov = len(chars) + 3
        self.vocab_size = len(chars) + 4  # 90 for the default vocab

    def char_id(self, c: str) -> int:
        return self._ids.get(c, self.oov)

    def encode_snippet(self, text: str, seq_len: int = SHAKESPEARE_SEQ_LEN
                       ) -> List[np.ndarray]:
        """<bos> text <eos>, chopped into (seq_len+1)-length windows, last
        window padded — mirrors fed_shakespeare/utils.py preprocess/to_ids.
        Each window yields (x, y) by the shift-by-one split done in
        utils.split (fed_shakespeare/utils.py:72-76)."""
        ids = [self.bos] + [self.char_id(c) for c in text] + [self.eos]
        out = []
        for i in range(0, len(ids), seq_len + 1):
            win = ids[i:i + seq_len + 1]
            if len(win) < 2:
                break
            win = win + [self.pad] * (seq_len + 1 - len(win))
            out.append(np.asarray(win, dtype=np.int32))
        return out


# LEAF's shakespeare variant indexes raw chars directly into the same 86-char
# string (oov = -1 from str.find; the reference one-hots at VOCAB_SIZE 90,
# language_utils.py:16-40). We clamp oov to the shared oov id instead.
def leaf_word_to_indices(word: str, vocab: Optional[CharVocab] = None
                         ) -> np.ndarray:
    vocab = vocab or CharVocab()
    return np.asarray([vocab.char_id(c) for c in word], dtype=np.int32)


class WordVocab:
    """StackOverflow word vocab: [pad] + top-k words + [bos] + [eos], hashed
    oov buckets after (stackoverflow_nwp/utils.py:33-41,60-66)."""

    def __init__(self, words: Sequence[str], num_oov_buckets: int = 1):
        self.pad = 0
        self._ids = {w: i + 1 for i, w in enumerate(words)}
        self.bos = len(words) + 1
        self.eos = len(words) + 2
        self.num_oov_buckets = num_oov_buckets
        self.vocab_size = len(words) + 3 + num_oov_buckets  # 10004 at k=10000

    @classmethod
    def from_word_count_file(cls, path: str, vocab_size: int = 10000,
                             num_oov_buckets: int = 1) -> "WordVocab":
        """`stackoverflow.word_count`: one "word count" line per word,
        most-frequent first (stackoverflow_nwp/utils.py:26-30)."""
        words = []
        with open(path) as f:
            for line in f:
                words.append(line.split()[0])
                if len(words) >= vocab_size:
                    break
        return cls(words, num_oov_buckets)

    def word_id(self, w: str) -> int:
        i = self._ids.get(w)
        if i is not None:
            return i
        # stable across processes (Python's hash() is salted per-interpreter)
        bucket = zlib.crc32(w.encode("utf8")) % self.num_oov_buckets
        return bucket + len(self._ids) + 3

    def encode_sentence(self, sentence: str, seq_len: int = 20) -> np.ndarray:
        """<bos> tokens [<eos>] <pad>... at length seq_len+1
        (stackoverflow_nwp/utils.py:68-82: eos only when the truncated
        sentence is shorter than seq_len)."""
        tokens = [self.word_id(w) for w in sentence.split(" ")[:seq_len]]
        if len(tokens) < seq_len:
            tokens = tokens + [self.eos]
        tokens = [self.bos] + tokens
        tokens += [self.pad] * (seq_len + 1 - len(tokens))
        return np.asarray(tokens[:seq_len + 1], dtype=np.int32)


def split_next_word(windows: np.ndarray) -> Dict[str, np.ndarray]:
    """[N, L+1] id windows -> x=[N, L], y=[N, L] shifted by one
    (fed_shakespeare/utils.py:72-76 splits off only the last column; the
    TFF-style LM target is the full shift, which the reference's RNN also
    uses — we keep the full shift so every position trains)."""
    return {"x": windows[:, :-1], "y": windows[:, 1:]}


def bag_of_words(sentences: Sequence[str], vocab: Dict[str, int],
                 normalize: bool = True) -> np.ndarray:
    """StackOverflow-LR x: 10k-dim token-frequency vector per example
    (stackoverflow_lr/utils.py:65-74: counts / num_tokens)."""
    out = np.zeros((len(sentences), len(vocab)), dtype=np.float32)
    for i, s in enumerate(sentences):
        toks = s.split(" ")
        for t in toks:
            j = vocab.get(t)
            if j is not None:
                out[i, j] += 1.0
        if normalize and toks:
            out[i] /= len(toks)
    return out


def multi_hot_tags(tag_lists: Sequence[str], tag_vocab: Dict[str, int],
                   sep: str = "|") -> np.ndarray:
    """StackOverflow-LR y: 500-dim multi-hot tag vector
    (stackoverflow_lr/utils.py:77-84)."""
    out = np.zeros((len(tag_lists), len(tag_vocab)), dtype=np.float32)
    for i, tags in enumerate(tag_lists):
        for t in tags.split(sep):
            j = tag_vocab.get(t)
            if j is not None:
                out[i, j] = 1.0
    return out


def load_tag_dict(path: str, tag_size: int = 500) -> Dict[str, int]:
    """`stackoverflow.tag_count` is a json {tag: count} ordered by frequency
    (stackoverflow_lr/utils.py:39-42)."""
    with open(path) as f:
        tags = json.load(f)
    return {t: i for i, t in enumerate(list(tags.keys())[:tag_size])}
