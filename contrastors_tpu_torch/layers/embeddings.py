"""Token and patch embeddings, counterpart of
`contrastors_tpu/layers/embeddings.py` (`BertEmbeddings`,
`pad_aware_position_ids`, `sincos_2d_pos_embed`, `PatchEmbedding`,
`interpolate_pos_embed`, `patch_dropout`). Rotary models carry no absolute
positions.

`PatchEmbedding` is a Dense over patches flattened in (c p1 p2) order, as
in JAX, so an HF or timm conv weight [D, C, p, p] lands as its reshape to
[D, C*p*p]. `interpolate_pos_embed` is JAX's `jax.image.resize(...,
"cubic")`: the Keys kernel with a = -0.5, antialiased when it shrinks the
grid (the kernel widened by in/out); its weight matrices are built in numpy
by JAX's rule and applied with one einsum, so the resize is differentiable
in the table. torch's bicubic (a = -0.75, no antialias) is another function.
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from contrastors_tpu_torch._device import resolve_device
from contrastors_tpu_torch.layers.dense import Dense, Embed
from contrastors_tpu_torch.layers.rotary import build_2d_rope_cat
from contrastors_tpu_torch.ops.dropout import need_generator


def pad_aware_position_ids(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """XLM-R/fairseq convention: positions count non-pad tokens from
    pad_token_id + 1."""
    mask = (input_ids != pad_token_id).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


def sincos_2d_pos_embed(embed_dim: int, grid_size: int, cls_token: bool = True) -> np.ndarray:
    """MAE's fixed 2-D sin/cos table [(1 +) grid^2, embed_dim] fp32: the
    first half encodes the W coordinate, as transformers' ViTMAE builds it."""
    if embed_dim % 4 != 0:
        raise ValueError("embed_dim must be divisible by 4")

    def one_axis(pos):
        omega = np.arange(embed_dim // 4, dtype=np.float64) / (embed_dim / 4.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid = np.arange(grid_size, dtype=np.float32)
    gw, gh = np.meshgrid(grid, grid)  # w varies fastest
    emb = np.concatenate([one_axis(gw), one_axis(gh)], axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros((1, embed_dim)), emb], axis=0)
    return emb.astype(np.float32)


class BertEmbeddings(nn.Module):
    def __init__(self, config, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.config = config
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.word_embeddings = Embed(config.vocab_size, config.n_embd, **kw)
        self.use_abs_pos = config.n_positions > 0 and config.rotary_emb_fraction <= 0
        self.position_embeddings = (
            Embed(config.n_positions, config.n_embd, **kw) if self.use_abs_pos else None
        )
        self.token_type_embeddings = (
            Embed(config.type_vocab_size, config.n_embd, **kw)
            if config.type_vocab_size > 0 else None
        )

    def forward(
        self,
        input_ids: torch.Tensor,
        position_ids: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        cfg = self.config
        embeddings = self.word_embeddings(input_ids)
        if self.position_embeddings is not None:
            if position_ids is None:
                if cfg.pad_token_id is not None and cfg.pad_token_id > 0:
                    position_ids = pad_aware_position_ids(input_ids, cfg.pad_token_id)
                else:
                    position_ids = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
            embeddings = embeddings + self.position_embeddings(position_ids)
        if self.token_type_embeddings is not None:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            embeddings = embeddings + self.token_type_embeddings(token_type_ids)
        return embeddings


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel with a = -0.5 (jax.image's "cubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def cubic_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] fp32 weights of jax.image.resize(method="cubic",
    antialias=True) along one axis (jax `compute_weight_mat`, scale out/in,
    no translation)."""
    inv_scale = np.float32(1.0) / (np.float32(out_size) / np.float32(in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def interpolate_pos_embed(table: torch.Tensor, target_len: int, has_cls: bool = True) -> torch.Tensor:
    """Resize the square patch grid of a [1, (1 +) n, D] position table to
    target_len rows (the cls row kept as is), as JAX's cubic resize."""
    cls_part = table[:, :1] if has_cls else None
    patch = table[:, 1:] if has_cls else table
    side = int(math.sqrt(patch.shape[1]))
    tgt_side = int(math.sqrt(target_len - (1 if has_cls else 0)))
    w = torch.from_numpy(cubic_resize_weights(side, tgt_side)).to(device=table.device, dtype=table.dtype)
    grid = patch.reshape(side, side, -1)
    grid = torch.einsum("hwd,hi,wj->ijd", grid, w, w)
    patch = grid.reshape(1, tgt_side * tgt_side, -1)
    return torch.cat([cls_part, patch], dim=1) if has_cls else patch


def patch_dropout(x: torch.Tensor, prob: float, generator: torch.Generator, exclude_first: bool = True):
    """Keep a random subset of max(1, int(N * (1 - prob))) patches per row:
    the top scores of normal noise drawn from `generator` (JAX's top_k of
    jax.random.normal); the first token stays when exclude_first."""
    cls_part = x[:, :1] if exclude_first else None
    patches = x[:, 1:] if exclude_first else x
    B, N, D = patches.shape
    keep = max(1, int(N * (1.0 - prob)))
    scores = torch.randn((B, N), generator=generator, device=x.device)
    idx = torch.topk(scores, keep, dim=1).indices
    kept = torch.gather(patches, 1, idx[:, :, None].expand(-1, -1, D))
    return torch.cat([cls_part, kept], dim=1) if exclude_first else kept


class PatchEmbedding(nn.Module):
    """pixel_values [B, C, H, W] -> (embeddings [B, (prefix +) N, D], the 2-D
    rope table [N, 2 * head_dim] or None). Parameters, as JAX names them:
    `proj` (the patch Dense), `cls_token` (unless no_cls_token), `pos_embed`
    (learned, [1, N (+ 1 without registers), D]; the MAE table is fixed and
    not a parameter), `reg_token` (register tokens)."""

    def __init__(self, config, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        cfg = config
        self.config, self.dtype = cfg, dtype
        p = cfg.patch_size
        self.proj = Dense(cfg.num_channels * p * p, cfg.n_embd, bias=cfg.patch_embed_bias, dtype=dtype,
                          device=device)
        num_patches = (cfg.img_size // p) ** 2
        self.cls_token = None if cfg.no_cls_token else nn.Parameter(torch.zeros(1, 1, cfg.n_embd, device=device))
        self.pos_embed = None
        if cfg.use_pos_embed:
            if cfg.sinusoidal_pos_embedding:
                table = sincos_2d_pos_embed(cfg.n_embd, cfg.img_size // p, cls_token=True)
                self.register_buffer("sincos_table", torch.from_numpy(table)[None].to(device), persistent=False)
            else:
                # timm-dinov2-with-registers quirk: no cls slot when registers exist
                n = num_patches if cfg.register_tokens > 0 else num_patches + 1
                self.pos_embed = nn.Parameter(torch.randn(1, n, cfg.n_embd, device=device) * 0.02)
        self.reg_token = (nn.Parameter(torch.randn(1, cfg.register_tokens, cfg.n_embd, device=device) * 0.02)
                          if cfg.register_tokens > 0 else None)
        self._rope = {}

    def _table(self):
        if self.pos_embed is not None:
            return self.pos_embed
        return getattr(self, "sincos_table", None)

    def rope(self, gh: int, gw: int, device) -> Optional[torch.Tensor]:
        if not self.config.use_rotary_pos_emb:
            return None
        key = (gh, gw, str(device))
        if key not in self._rope:
            cfg = self.config
            self._rope[key] = build_2d_rope_cat(cfg.head_dim, (gh, gw), ref_feat_shape=cfg.ref_feat_shape,
                                                device=device)
        return self._rope[key]

    def forward(self, pixel_values: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """`generator` draws the patch dropout (training mode, patch_dropout > 0)."""
        cfg = self.config
        B, C, Himg, Wimg = pixel_values.shape
        p = cfg.patch_size
        gh, gw = Himg // p, Wimg // p
        # b c (h p1) (w p2) -> b (h w) (c p1 p2), then one matmul
        x = pixel_values.reshape(B, C, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5).reshape(B, gh * gw, C * p * p)
        x = self.proj(x.to(self.dtype))

        table = self._table()
        sincos = cfg.sinusoidal_pos_embedding and table is not None
        to_cat = []
        if self.cls_token is not None:
            tok = self.cls_token.to(x.dtype).expand(B, 1, cfg.n_embd)
            if sincos:
                tok = tok + table[:, :1].to(x.dtype)
            to_cat.append(tok)
        if self.reg_token is not None:
            to_cat.append(self.reg_token.to(x.dtype).expand(B, cfg.register_tokens, cfg.n_embd))
        rope = self.rope(gh, gw, x.device)

        def add_pos(emb, t):
            if t is None:
                return emb
            t = t.to(emb.dtype)
            if t.shape[1] != emb.shape[1]:
                t = interpolate_pos_embed(t, emb.shape[1], has_cls=not cfg.no_embed_class and not cfg.no_cls_token)
            return emb + t

        if cfg.no_embed_class:
            # positions on the patches only, prefix tokens in front after
            x = add_pos(x, table[:, 1:] if sincos else table)
            if to_cat:
                x = torch.cat(to_cat + [x], dim=1)
        else:
            if to_cat:
                x = torch.cat(to_cat + [x], dim=1)
            x = add_pos(x, table)

        if cfg.patch_dropout > 0.0 and self.training:
            if rope is not None:
                # kept patches would misalign with the full-grid rope rows
                raise ValueError("patch_dropout > 0 is unsupported with 2-D rotary position embeddings; "
                                 "disable one of them")
            need_generator(generator, cfg.patch_dropout, "patch dropout")
            x = patch_dropout(x, cfg.patch_dropout, generator, exclude_first=True)
        return x, rope
