"""Mixture-of-experts MLP, dropless, counterpart of
`contrastors_tpu/layers/moe.py:MoEMLP` with `moe_impl="dropless"`.

Routing (token choice): fp32 router logits x @ router [D, E]; softmax over
the unmasked logits; top-k; optional renormalisation; then the weights of
padding tokens are set to 0. Padding tokens are still dispatched: they
occupy rows and contribute nothing. The layer returns the masked logits
(-1e9 on padding) for the router load-balance loss.

Dispatch: the N*k assignments are laid out expert-sorted with 128-row
aligned groups (`ops.grouped_matmul.aligned_group_layout`), gathered from
the tokens through an appended zero row (the padding rows' sentinel; its
gradient is dropped), run through three grouped matmuls (up and gate, then
down after the gated activation) and gathered back by `dest` and combined
by weight. Optional shared experts (Dense layers on every token) blend in
by assignment count, then the output bias. Nothing is read back to the
host.

Parameters keep the JAX names and shapes so that `convert.flax_to_torch`
maps them one to one: `router` [D, E], `w_up`/`w_gate` [E, D, F] and
`w_down` [E, F, D] (`w_in` for an ungated activation), `bias` [D], and the
`shared_*` Dense layers. They are stored in fp32 and cast to the compute
dtype where used, as `layers/dense.py` does. The capacity dispatch and
expert-choice routing are not ported yet (ROADMAP, Queue 1).
"""

import torch
from torch import nn

from contrastors_tpu_torch._device import resolve_device
from contrastors_tpu_torch.layers.activations import ACT2FN, is_gated
from contrastors_tpu_torch.layers.dense import Dense
from contrastors_tpu_torch.ops.grouped_matmul import aligned_group_layout, block_experts, gmm


class MoEMLP(nn.Module):
    def __init__(self, config, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        cfg = config
        if cfg.expert_choice_router:
            raise NotImplementedError("expert-choice routing is not ported yet (ROADMAP, Queue 1: MoE)")
        if cfg.moe_impl == "capacity":
            raise NotImplementedError("moe_impl='capacity' is not ported yet (ROADMAP, Queue 1: MoE)")
        if cfg.moe_impl != "dropless":
            raise ValueError(f"moe_impl={cfg.moe_impl!r}: expected 'dropless' or 'capacity'")
        self.config, self.dtype = cfg, dtype
        D, std = cfg.n_embd, cfg.initializer_range
        self.num_shared = cfg.num_shared_experts
        self.num_routed = cfg.num_experts - self.num_shared
        self.top_k = cfg.moe_top_k - self.num_shared
        self.block_m = int(cfg.moe_block_m)
        self.gated = is_gated(cfg.activation_function)
        self.act = ACT2FN[cfg.activation_function]
        F_hid = cfg.n_inner // cfg.ffn_div
        E = self.num_routed

        def param(*shape):
            return nn.Parameter(torch.randn(shape, device=device) * std)

        self.router = param(D, E)
        if self.gated:
            self.w_up, self.w_gate = param(E, D, F_hid), param(E, D, F_hid)
        else:
            self.w_in = param(E, D, F_hid)
        self.w_down = param(E, F_hid, D)
        if self.num_shared > 0:
            hid = F_hid * self.num_shared
            kw = dict(bias=False, dtype=dtype, device=device)
            self.shared_up = Dense(D, hid, **kw)
            self.shared_gate = Dense(D, hid, **kw)
            self.shared_down = Dense(hid, D, **kw)
        self.bias = nn.Parameter(torch.zeros(D, device=device))

    def route(self, probs, valid):
        """Token-choice routing of the router probabilities [N, E]: (top-k
        weights, top-k experts), the weights renormalised when the config
        asks and 0 for padding tokens (valid [N, 1] False)."""
        top_w, top_e = torch.topk(probs, self.top_k, dim=-1)
        if self.config.moe_normalize_expert_weights:
            top_w = top_w / top_w.sum(dim=-1, keepdim=True)
        return top_w * valid.to(top_w.dtype), top_e

    def _experts(self, xs, group_sizes):
        """The expert MLPs over the aligned rows [P, D]; the three gmm share
        one block -> expert table."""
        dt, bm = self.dtype, self.block_m
        blocks = block_experts(group_sizes, xs.shape[0] // bm, bm)
        if self.gated:
            h = gmm(xs, self.w_up.to(dt), group_sizes, bm, blocks)
            h = h * self.act(gmm(xs, self.w_gate.to(dt), group_sizes, bm, blocks))
        else:
            h = self.act(gmm(xs, self.w_in.to(dt), group_sizes, bm, blocks))
        return gmm(h, self.w_down.to(dt), group_sizes, bm, blocks)

    def forward(self, hidden_states: torch.Tensor, attention_mask=None):
        """Returns (output [B, S, D] in hidden_states.dtype, masked router
        logits [B*S, E] fp32)."""
        B, S, D = hidden_states.shape
        N, E, k = B * S, self.num_routed, self.top_k
        x = hidden_states.reshape(N, D)

        logits = x.float() @ self.router  # [N, E]
        if attention_mask is not None:
            valid = attention_mask.reshape(N, 1).bool()
            logits_masked = logits.masked_fill(~valid, -1e9)
        else:
            valid = torch.ones((N, 1), dtype=torch.bool, device=x.device)
            logits_masked = logits
        top_w, top_e = self.route(torch.softmax(logits, dim=-1), valid)  # [N, k]

        token_of = torch.arange(N, device=x.device).repeat_interleave(k)
        dest, group_sizes, P, src = aligned_group_layout(
            top_e.reshape(-1), E, self.block_m, src_of=token_of, sentinel=N
        )
        x_pad = torch.cat([x.to(self.dtype), x.new_zeros((1, D), dtype=self.dtype)])
        y = self._experts(x_pad[src], group_sizes)
        y_assign = y[dest].reshape(N, k, D)
        out = (y_assign * top_w[..., None].to(y_assign.dtype)).sum(dim=1)

        if self.num_shared > 0:
            shared = self.shared_down(self.shared_up(x) * self.act(self.shared_gate(x)))
            # megablocks shared_expert_weighted_sum: blend by assignment counts
            frac = self.num_shared / self.config.moe_top_k
            out = shared * frac + out * (1.0 - frac)
        out = out + self.bias.to(out.dtype)
        return out.reshape(B, S, D).to(hidden_states.dtype), logits_masked
