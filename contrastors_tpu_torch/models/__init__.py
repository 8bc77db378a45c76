from contrastors_tpu_torch.models.model_config import TrunkConfig  # noqa: F401
from contrastors_tpu_torch.models.nomic_bert import (  # noqa: F401
    NomicBertForPreTraining,
    NomicBertForSequenceClassification,
    NomicBertModel,
    init_weights,
    masked_cross_entropy,
)
from contrastors_tpu_torch.models.biencoder import BiEncoder, LogitScale  # noqa: F401
from contrastors_tpu_torch.models.vit import ViTModel  # noqa: F401
from contrastors_tpu_torch.models.dual_encoder import DualEncoder  # noqa: F401
from contrastors_tpu_torch.models.decoder_heads import (  # noqa: F401
    DecoderForCausalLM,
    DecoderForQuestionAnswering,
    DecoderForSequenceClassification,
    DecoderForTokenClassification,
)
