"""Dataset constants, the port's copy of what it needs of
`contrastors_tpu/data/constants.py`: the per-language corpus sizes of the
multilingual MLM mix (`multilingual_lengths.json`, the same file)."""

import json
import os

_here = os.path.dirname(os.path.abspath(__file__))


def reference_multilingual_lengths():
    """Per-language corpus sizes that the multilingual sampler draws by
    (alpha-temperature sampling), so that the mix can follow the published
    recipe when only some corpora are local."""
    with open(os.path.join(_here, "multilingual_lengths.json")) as f:
        return json.load(f)["multilingual_lengths"]
