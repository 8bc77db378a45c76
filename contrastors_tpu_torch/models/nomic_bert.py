"""NomicBERT encoder trunk and its heads, counterpart of
`contrastors_tpu/models/nomic_bert.py` (`NomicBertModel`,
`NomicBertForPreTraining`, `NomicBertForSequenceClassification`,
`masked_cross_entropy`).

Postnorm blocks, the embedding LayerNorm, optional rotary (nomic-bert-2048;
rotated inside the flash kernels with `fused_rotary`), ModernBERT-style
local/global alternation and prenorm trunks. Padding is handled by
static-shape masks, as on the JAX side. MoE layers (every
`moe_every_n_layers`-th, from layer 1) run the dropless MoEMLP; the output
carries their masked router logits, in layer order, under "router_logits"
(an empty list for a dense trunk).

Dropout, in training mode (`module.train()`), where JAX's runs with
deterministic=False: after the embedding LayerNorm (`embd_pdrop`), in each
block (`layers/block.py`), before the prenorm trunk's final add-norm
(`resid_pdrop`) and on the classifier's pooled input. Every forward takes
`generator`, whose seed (`ops/dropout.py:noise_seed`, no device sync) seeds
every site: the same seed draws the same noise, as the same flax rng does.
A trunk with any dropout on refuses training mode without one.
`drop_path_rate` is ignored here, as JAX's NomicBertModel ignores it (only
its ViT passes it to its blocks).
With `remat`, each block runs under `torch.utils.checkpoint` (JAX's
`nn.remat(Block)`): its activations are recomputed in the backward instead
of kept. The checkpoint restores only the global RNG state, so the block's
seed is derived on the host outside the checkpointed call and its
generators are built inside it: the replay draws the same noise.
"""

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from contrastors_tpu_torch._device import resolve_device
from contrastors_tpu_torch.layers.activations import ACT2FN
from contrastors_tpu_torch.layers.block import Block
from contrastors_tpu_torch.layers.dense import Dense
from contrastors_tpu_torch.layers.embeddings import BertEmbeddings
from contrastors_tpu_torch.layers.norms import LayerNorm, make_norm
from contrastors_tpu_torch.models.model_config import TrunkConfig
from contrastors_tpu_torch.ops.dropout import active, dropout, fold_seed, noise_seed, site_generator


def _layer_is_moe(config: TrunkConfig, i: int) -> bool:
    # moe when i % every_n == 1 (the upstream placement rule)
    if config.num_experts <= 0:
        return False
    if config.moe_every_n_layers == 1:
        # i % 1 == 1 never holds, so every_n=1 (the default) would silently
        # build a fully dense model; fail loudly instead
        raise ValueError(
            "num_experts > 0 with moe_every_n_layers == 1 places MoE on NO "
            "layers (the placement rule is i % every_n == 1); set moe_every_n_layers >= 2"
        )
    if config.moe_every_n_layers > 0:
        return i % config.moe_every_n_layers == 1
    return False


# parameters that keep their constant initial value (layer scale, the cls token)
CONSTANT_INIT = ("ls1", "ls2", "cls_token")


def init_weights(module: nn.Module, seed: int, std: float = 0.02) -> nn.Module:
    """Random weights from a seeded CPU torch.Generator, copied to the
    module's device: Linear/Embedding weights, MoE routers and expert
    tensors, the ViT's position table, register tokens and pooling latent
    ~ N(0, std), biases (the MoE output bias and the MLM decoder_bias too)
    0, norm weights (the decoder's ln_f too) 1, layer scales and the cls
    token as constructed (layer_scale_init, 0), the kinds of the JAX
    initialisers. The same seed gives the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in CONSTANT_INIT:
                continue
            if leaf.endswith("bias"):
                p.zero_()
            elif "norm" in name or "emb_ln" in name or "ln_f" in name:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * std)
    return module


# dropout sites under a forward's seed (ops/dropout.py:fold_seed paths)
SITE_EMBEDDING, SITE_BLOCK, SITE_FINAL, SITE_CLASSIFIER = range(4)


class NomicBertModel(nn.Module):
    def __init__(self, config: TrunkConfig, dtype=torch.float32, device="cuda", remat: bool = False,
                 add_pooling_layer: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.remat = remat
        if config.parallel_block:
            raise ValueError("parallel_block: the parallel-residual blocks belong to the decoder trunk "
                             "(models/decoder.py, trunk_type='decoder')")
        self.config, self.dtype = config, dtype
        self.embeddings = BertEmbeddings(config, dtype=dtype, device=device)
        self.emb_ln = LayerNorm(
            config.n_embd, eps=config.layer_norm_epsilon, use_bias=config.norm_bias, device=device
        )
        every_n = config.global_attn_every_n_layers
        layers = []
        for i in range(config.n_layer):
            is_global = every_n <= 0 or i % every_n == 0
            layers.append(Block(
                config,
                dtype=dtype,
                moe=_layer_is_moe(config, i),
                attn_window=0 if is_global else config.sliding_window,
                rotary_base_override=None if is_global else config.local_rotary_emb_base,
                norm1_identity=config.prenorm and config.skip_first_prenorm and i == 0,
                device=device,
            ))
        self.layers = nn.ModuleList(layers)
        self.final_norm = make_norm(config, device=device) if config.prenorm else None
        self.pooler_dense = Dense(config.n_embd, config.n_embd, dtype=dtype, device=device) if add_pooling_layer \
            else None

    def uses_dropout(self) -> bool:
        """True when a forward in the current mode draws noise."""
        cfg = self.config
        return self.training and max(cfg.embd_pdrop, cfg.resid_pdrop, cfg.attn_pdrop,
                                     cfg.moe_resid_pdrop or 0.0) > 0.0

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        cfg = self.config
        seed = noise_seed(generator) if self.uses_dropout() else None
        dev, train = input_ids.device, self.training
        hidden = self.emb_ln(self.embeddings(input_ids, position_ids, token_type_ids))
        if active(cfg.embd_pdrop, train):
            hidden = dropout(hidden, cfg.embd_pdrop, site_generator(seed, SITE_EMBEDDING, device=dev))
        residual, router_logits = None, []
        for i, block in enumerate(self.layers):
            # the block's seed is a host int, fixed before the checkpointed call
            block_seed = None if seed is None else fold_seed(seed, SITE_BLOCK, i)
            args = (hidden, residual, attention_mask, segment_ids, position_ids, block_seed)
            if self.remat and torch.is_grad_enabled():
                hidden, residual, rl = checkpoint(block, *args, use_reentrant=False)
            else:
                hidden, residual, rl = block(*args)
            if rl is not None:
                router_logits.append(rl)
        if self.final_norm is not None:
            # the final dropout-add-norm closes the shifted-prenorm carry
            if active(cfg.resid_pdrop, train):
                hidden = dropout(hidden, cfg.resid_pdrop, site_generator(seed, SITE_FINAL, device=dev))
            resid_dtype = torch.float32 if cfg.residual_in_fp32 else hidden.dtype
            h = hidden.to(resid_dtype)
            residual = h if residual is None else residual + h
            hidden = self.final_norm(residual).to(self.dtype)
        out: Dict[str, Any] = {"last_hidden_state": hidden, "router_logits": router_logits}
        if self.pooler_dense is not None:
            out["pooler_output"] = torch.tanh(self.pooler_dense(hidden[:, 0]))
        return out


class NomicBertForPreTraining(nn.Module):
    """MLM head with the decoder tied to the word embeddings (JAX
    `NomicBertForPreTraining`). Two loss paths:
      - default: label-masked CE over all positions (-100 ignored);
      - dense_seq_output: `masked_positions` [B, k] per-row indices into the
        sequence (host-collated to a static per-row k with -100-labelled
        filler slots, `trainers/mlm.py:masked_positions_static`) and `labels`
        as the matching [B, k] matrix; the vocab projection then runs on
        B*k rows instead of B*S.
    The head is dense -> act (silu for swiglu) -> norm, then the tied
    decoder, the fp32 word-embedding table cast to the compute dtype (a
    plain torch.matmul), plus an fp32 `decoder_bias`. `generator` seeds the
    trunk's dropout in training mode; `remat` checkpoints its blocks."""

    def __init__(self, config: TrunkConfig, dtype=torch.float32, device="cuda", remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.config, self.dtype = config, dtype
        self.bert = NomicBertModel(config, dtype=dtype, device=device, remat=remat)
        self.transform_dense = Dense(config.n_embd, config.n_embd, bias=config.mlp_fc1_bias,
                                     dtype=dtype, device=device)
        self.transform_layer_norm = make_norm(config, device=device)
        self.decoder = None
        if not config.tie_word_embeddings:
            self.decoder = Dense(config.n_embd, config.vocab_size, bias=False, dtype=dtype, device=device)
        self.decoder_bias = nn.Parameter(torch.zeros(config.vocab_size, device=device))

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        masked_positions: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        cfg = self.config
        hidden = self.bert(input_ids, attention_mask=attention_mask, position_ids=position_ids,
                           token_type_ids=token_type_ids, generator=generator)["last_hidden_state"]
        if masked_positions is not None:
            # dense_seq_output: project only the masked rows, gathered per batch row
            idx = masked_positions.to(device=hidden.device, dtype=torch.int64)
            hidden = torch.gather(hidden, 1, idx[:, :, None].expand(-1, -1, hidden.shape[-1]))
        act = torch.nn.functional.silu if cfg.activation_function == "swiglu" else ACT2FN[cfg.activation_function]
        h = self.transform_layer_norm(act(self.transform_dense(hidden)))
        if self.decoder is None:
            table = self.bert.embeddings.word_embeddings.weight
            logits = torch.matmul(h, table.to(self.dtype).t())
        else:
            logits = self.decoder(h)
        logits = logits + self.decoder_bias.to(logits.dtype)
        out: Dict[str, Any] = {"prediction_logits": logits}
        if labels is not None:
            out["loss"] = masked_cross_entropy(logits, labels)
        return out


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over positions with label >= 0 (HF ignore_index=-100), in fp32."""
    flat = logits.reshape(-1, logits.shape[-1]).float()
    flat_labels = labels.reshape(-1).to(flat.device)
    valid = flat_labels >= 0
    safe = torch.where(valid, flat_labels, 0).to(torch.int64)
    gold = flat.gather(-1, safe[:, None])[:, 0]
    nll = (torch.logsumexp(flat, dim=-1) - gold) * valid.float()
    return nll.sum() / valid.float().sum().clamp_min(1.0)


class NomicBertForSequenceClassification(nn.Module):
    """GLUE head (JAX `NomicBertForSequenceClassification`): the trunk with
    its pooler (dense + tanh on the first token), dropout on the pooled
    vector (`classifier_dropout`, else `embd_pdrop`) and a dense classifier
    to `num_labels`. With labels the loss follows `problem_type`, or, when
    it is None, num_labels == 1 -> regression (MSE), integer labels ->
    single-label CE, else multi-label BCE with logits, each a mean in fp32."""

    def __init__(self, config: TrunkConfig, dtype=torch.float32, device="cuda", remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.config, self.dtype = config, dtype
        self.bert = NomicBertModel(config, dtype=dtype, device=device, remat=remat, add_pooling_layer=True)
        self.classifier = Dense(config.n_embd, config.num_labels, dtype=dtype, device=device)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        cfg = self.config
        pooled = self.bert(input_ids, attention_mask=attention_mask, token_type_ids=token_type_ids,
                           generator=generator)["pooler_output"]
        p_drop = cfg.classifier_dropout if cfg.classifier_dropout is not None else cfg.embd_pdrop
        if active(p_drop, self.training):
            seed = noise_seed(generator)
            pooled = dropout(pooled, p_drop, site_generator(seed, SITE_CLASSIFIER, device=pooled.device))
        logits = self.classifier(pooled)
        out: Dict[str, Any] = {"logits": logits}
        if labels is not None:
            out["loss"] = classification_loss(logits, labels, cfg.num_labels, cfg.problem_type)
        return out


def classification_loss(logits: torch.Tensor, labels: torch.Tensor, num_labels: int,
                        problem_type: Optional[str] = None) -> torch.Tensor:
    """JAX's three losses, by problem_type (inferred as JAX infers it)."""
    problem = problem_type
    if problem is None:
        if num_labels == 1:
            problem = "regression"
        elif not labels.dtype.is_floating_point:
            problem = "single_label_classification"
        else:
            problem = "multi_label_classification"
    lg = logits.float()
    labels = labels.to(lg.device)
    if problem == "regression":
        return F.mse_loss(lg.squeeze(), labels.squeeze().float())
    if problem == "single_label_classification":
        return F.cross_entropy(lg, labels.long())
    return F.binary_cross_entropy_with_logits(lg, labels.float())
