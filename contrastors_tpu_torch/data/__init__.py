from contrastors_tpu_torch.data.text import (  # noqa: F401
    LocalJsonlDataset,
    StreamingShardDataset,
    TokenizeCollator,
    expand_urls,
)
