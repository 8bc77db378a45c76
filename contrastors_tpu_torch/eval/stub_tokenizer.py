"""A whitespace tokenizer with the Hugging Face call interface.

No tokenizer files ship with the repo, so the smoke script and the parity
tests drive `Encoder` with this stand-in: [CLS]=101, then one id per word
(an integer word is its own id modulo the vocab, any other word a stable
crc32 id). Like bert-base-uncased's tokenizer it has no EOS token, and it
pads on the right, so `TokenizeCollator` takes it with add_eos off.
"""

import zlib

import numpy as np


class StubTokenizer:
    pad_token_id = 0
    eos_token = None
    eos_token_id = None
    padding_side = "right"

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def _ids(self, text, max_length):
        ids = [101] + [int(w) % self.vocab_size if w.isdigit() else zlib.crc32(w.encode()) % self.vocab_size
                       for w in text.split()]
        return ids[:max_length]

    def __call__(self, texts, padding=False, truncation=True, max_length=512, return_tensors=None):
        ids = [self._ids(t, max_length) for t in texts]
        if padding == "max_length":
            arr = np.zeros((len(ids), max_length), np.int64)
            mask = np.zeros((len(ids), max_length), np.int64)
            for r, x in enumerate(ids):
                arr[r, : len(x)], mask[r, : len(x)] = x, 1
            return {"input_ids": arr, "attention_mask": mask}
        return {"input_ids": ids, "attention_mask": [[1] * len(x) for x in ids]}
