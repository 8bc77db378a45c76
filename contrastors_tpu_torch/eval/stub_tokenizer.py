"""A whitespace tokenizer with the Hugging Face call interface.

No tokenizer files ship with the repo, so the smoke script and the parity
tests drive `Encoder` and the trainers with this stand-in: [CLS], then one
id per word (an integer word is its own id modulo the vocab, any other word
a stable crc32 id). A text pair is [CLS] a [SEP] b [SEP], with token type 0
up to the first [SEP] and 1 after it. The special ids default to
bert-base-uncased's (pad 0, [CLS] 101, [SEP] 102, [MASK] 103); XLM-R's are
pad 1, <s> 0, </s> 2, <mask> 250001. Like bert-base-uncased's tokenizer it
has no EOS token, and it pads on the right, so `TokenizeCollator` takes it
with add_eos off. `VocabTokenizer` is the same stand-in over a word list.
"""

import re
import zlib

import numpy as np


class StubTokenizer:
    eos_token = None
    eos_token_id = None
    padding_side = "right"

    def __init__(self, vocab_size: int, pad_token_id: int = 0, cls_token_id: int = 101,
                 sep_token_id: int = 102, mask_token_id: int = 103):
        self.vocab_size = vocab_size
        self.pad_token_id, self.cls_token_id = pad_token_id, cls_token_id
        self.sep_token_id, self.mask_token_id = sep_token_id, mask_token_id

    @property
    def all_special_ids(self):
        return [self.pad_token_id, self.cls_token_id, self.sep_token_id, self.mask_token_id]

    def __len__(self) -> int:
        return self.vocab_size

    def _words(self, text):
        return [int(w) % self.vocab_size if w.isdigit() else zlib.crc32(w.encode()) % self.vocab_size
                for w in text.split()]

    def _ids(self, text, max_length):
        return ([self.cls_token_id] + self._words(text))[:max_length]

    def _pair(self, a, b, max_length):
        first = [self.cls_token_id] + self._words(a) + [self.sep_token_id]
        ids = (first + self._words(b) + [self.sep_token_id])[:max_length]
        return ids, [0 if i < len(first) else 1 for i in range(len(ids))]

    def __call__(self, texts, text_pair=None, padding=False, truncation=True, max_length=512,
                 return_tensors=None):
        if text_pair is None:
            ids = [self._ids(t, max_length) for t in texts]
            types = None
        else:
            ids, types = zip(*(self._pair(a, b, max_length) for a, b in zip(texts, text_pair)))
        if padding == "max_length":
            arr = np.full((len(ids), max_length), self.pad_token_id, np.int64)
            mask = np.zeros((len(ids), max_length), np.int64)
            for r, x in enumerate(ids):
                arr[r, : len(x)], mask[r, : len(x)] = x, 1
            out = {"input_ids": arr, "attention_mask": mask}
            if types is not None:
                tt = np.zeros((len(ids), max_length), np.int64)
                for r, t in enumerate(types):
                    tt[r, : len(t)] = t
                out["token_type_ids"] = tt
            return out
        out = {"input_ids": list(ids), "attention_mask": [[1] * len(x) for x in ids]}
        if types is not None:
            out["token_type_ids"] = list(types)
        return out


class VocabTokenizer(StubTokenizer):
    """The stand-in over a word list: a word's id is its index in `vocab`
    (unknown words [UNK]), the special ids are those of [PAD], [CLS],
    [SEP] and [MASK] in it, and text splits into lower-cased words and
    single punctuation marks. Over a vocab.txt whose entries are whole
    words (the train-to-signal scripts' worlds) it gives the ids that
    `BertTokenizerFast(vocab_file=...)` gives: [CLS] words [SEP]."""

    def __init__(self, vocab):
        self.vocab = list(vocab)
        self.index = {w: i for i, w in enumerate(self.vocab)}
        self.unk_token_id = self.index["[UNK]"]
        super().__init__(len(self.vocab), pad_token_id=self.index["[PAD]"], cls_token_id=self.index["[CLS]"],
                         sep_token_id=self.index["[SEP]"], mask_token_id=self.index["[MASK]"])

    def _words(self, text):
        return [self.index.get(w, self.unk_token_id) for w in re.findall(r"\w+|[^\w\s]", text.lower())]

    def _ids(self, text, max_length):
        return [self.cls_token_id] + self._words(text)[:max(max_length - 2, 0)] + [self.sep_token_id]
