#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (contrastors_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only {moe_kernels,moe,flash_fwd,flash_bwd,dense,trainer,mlm_trainer,vision,families}
                             [--tree DIR]

The second form runs phases 1, 2 and 9 (moe_kernels), or 1, 2 and 9-12
without the gradient agreement (moe: the kernels, MoE serving and the MoE
step's timing and profile), or (flash_fwd) 1, 2, the forward checks of 3
and 13, the forward timing of 6, the fused encode of 14 and the MLM step's
timing, fused and outside in turns, or (flash_bwd) 1, 2, the backward
checks of 4 and 13, the backward timing of 8 (the whole backward only) and
the MLM step's timing, or (dense) 1, 2 and the dense step of 7-8
(launches, timing, profile; no gradient agreement), or (trainer) 1, 2 and
17, or (mlm_trainer) 1, 2 and 18, or (vision) 1, 2, the ViT shape's
checks of 3 and 4 and 19, or (families) 1, 2, the families' two shapes'
checks of 3 and 4 and 20, on this checkout's
package or on the one under DIR (another checkout, e.g. the parent commit
unpacked by `git archive`), so that two versions can be timed in turns on
one card.

Phases, each printing one JSON line; any failure exits non-zero:
  1. card: name and power limit (nvidia-smi), torch and CUDA versions; TF32 off.
  2. build: nvcc builds csrc/flash_fwd.cu, csrc/flash_bwd.cu and
     csrc/gmm.cu for sm_90a from this checkout, all at once.
  3. kernel_check: the flash-forward kernel against its plain PyTorch version
     on the card in bf16 (padding with a fully masked row, ragged and sub-tile
     lengths, the multi-tile regime at 4096/8192, causal S != T, window,
     segments, GQA, D=128, the training step's two shapes, B=512 S=32
     and B=16 S=256, and the edges of the persistent walk: S = T = 1, 65,
     129 with GQA, D = 128 at 129, B * H = 143, GQA at S = 2048; the GLUE
     eval batch, 64 x 128 padded, as the dispatch hands it over; the
     families' window band with a padding mask, 32 x 512, and causal band
     with one, 128 x 128 in the dispatch's form); a second run
     bit-identical to the first.
  4. kernel_check_bwd: the two backward kernels (dq, which also computes
     delta; dk/dv) against the plain backward on the same O and LSE, with a
     strided dO, in 13 of those cases (the training shapes included) and in
     the edges of the kernels' persistent walk (S = T = 1, 65, 129 at D = 64
     and 128, B * H = 143, GQA with Hkv = 4 at S = 2048); dq must be 0 on
     the fully masked row, and a second run bit-identical to the first.
  5. main_path: a full-width nomic-bert-2048 BiEncoder (bf16, random weights
     from a seed) answers encode requests through the port's Encoder at
     batch 256 / seq_len 512, then one long-context NTK batch at S=4096. Each
     of the two runs has its own launch count, set to 0 just before it, which
     must equal n_layer x its batches; embeddings must be finite, unit-norm
     and agree with the same weights under attn_impl="sdpa".
  6. timing: encode throughput at 256 x 512, and the forward kernel's time
     (ms, device_ms, enqueue us) beside its bound, its plain version and
     torch's scaled_dot_product_attention (a yardstick only; the port never
     calls it) the same three ways, at B=256 S=512, B=16 S=4096, the
     contrastive step's B=512 S=32 and B=16 S=256, and the MLM shape B=8
     S=2048 plain and with fused rotary (against SDPA plus apply_rotary),
     all with the all-ones mask, and the padded GLUE eval batch (64 x 128,
     against SDPA with the mask).
  7. dead_row_check and train_step: attention_core(impl="flash") with a
     mask only at kv 256, as the step's document chunks call it (and with
     GQA and fused rotary), on a batch whose last row has no valid key:
     output and q/k/v gradients against fp32 SDPA, the dead row (SDPA's
     uniform softmax) within 2^-6 max |ref| and 2^-7 relative L2, the live
     rows at cosine >= 0.9999. Then the text GradCache step at full width
     (the JAX headline geometry: 512 pairs, query 32 / document 256 tokens,
     chunk 16, every query chunk direct, document chunks cached, AdamW lr
     2e-4 wd 0.01 clip 1.0, LogitScale(50) fixed) takes 5 steps on one
     batch whose documents start with their query's tokens. Each step's launch counts, set to 0
     before it, must be n_layer x its forwards (780) and backwards (396, dq
     and dk/dv each); losses finite and falling. Then, at 64 pairs: the
     grad-cache grads against the standard step's, and the flash step's
     against attn_impl="sdpa"'s, per tensor; two faulty steps (the backward
     kernels given O = 0, so delta = 0; pass 2 replaying each document chunk
     with its rows rotated) must fall outside those bounds.
  8. train_timing and kernel_timing_bwd: step time, pairs/s and tokens/s;
     one profiled step split into its phases (the profiler ranges of
     grad_cache.py and the trainer); the whole backward and each backward
     kernel at the main-path shapes (B=512 S=32, B=16 S=256, and the MLM
     step's B=8 S=2048 plain and with fused rotary, all with the steps'
     all-ones mask), checked once more against the plain version, as ms,
     device_ms and enqueue us, beside its bound, the plain backward and
     torch SDPA's backward (autograd, forward+backward minus forward).
The dropless MoE path (nomic-bert-2048 with 8 experts, top-2, MoE on every
second layer: 6 MoE layers, ~435M parameters):
  9. kernel_check_gmm and moe_kernel_timing (after phase 4): gmm, dlhs
     (gmm on the transposed-rhs view, as the backward runs it) and tgmm
     against their plain versions, per element, on the layouts of the MoE
     step's document and query chunks (A = 16384 and 2048 assignments from
     skewed random routing, one expert empty, one of exactly 128 rows,
     trailing inactive blocks) and gmm and dlhs on one encode batch's
     layout, each at (K, N) = (768, 3072) and (3072, 768); padding rows and
     the empty expert exactly 0. Then each kernel's time on those inputs
     beside its bound, its plain version and torch._grouped_mm (a
     yardstick only; a per-expert matmul loop where the installed torch
     lacks it), the kernel's and the library's each as ms, as device_ms
     and as the host's enqueue per call. The build line gives each
     kernel's registers, spills and static shared memory (ptxas).
 10. moe_main_path: a full-width MoE BiEncoder (bf16, seed weights) encodes
     512 requests at batch 256 / seq_len 512 through Encoder; launches
     flash = 12 and gmm = 18 per batch, no tgmm; embeddings finite,
     unit-norm, cosine >= 0.999 against the same weights under
     attn_impl="sdpa" and the plain grouped matmul; the share of tokens
     routed to another expert pair by that switch is recorded.
 11. moe_train_step: the JAX MoE benchmark step (bench.py:908-956): 512
     pairs, 32/256 tokens, chunk 32, every chunk cached, router aux 0.001,
     AdamW lr 2e-4 wd 0.01 clip 1.0, LogitScale(50) fixed, 5 steps; per
     step 768 / 384 / 384 flash fwd / dq / dk-dv launches, 1728 gmm and
     576 tgmm; losses finite and falling, each chunk's aux near top_k = 2.
     At 64 pairs with aux 0: grad cache against the standard step (with
     the tokens the two route differently, and read beside it with the
     standard step replaying the grad-cache run's choices) and the
     kernels against sdpa with the plain grouped matmul (replaying the
     kernel run's expert choices), per tensor; the same comparison with
     each run routing on its own, at three data seeds, beside the gmm
     kernels' and the attention's share of it; a tgmm writing expert e's
     gradient into expert e+1 must fall outside. Read beside it, not
     bounded (moe_grad_margin_reading): grad cache against the standard
     step by layer, with the router aux off and at 0.001, and by chunk (the
     chunk's embeddings, cotangent and gradient contribution against the
     standard step's for the same rows).
 12. moe_timing: MoE encode texts/s, step ms (median of 5), one profiled
     step with gmm and tgmm as their own groups and its device-to-host
     copies counted.
The fused-rotary kernels (q and k rotated inside the flash kernels) and the
MLM pretraining step:
 13. fused_kernel_check (after phase 4): the fused forward, dq and dk/dv
     kernels against their plain versions, per element, at the MLM shape
     (B=8 S=2048 H=12 D=64, NeoX), an encode batch with padding (256 x
     512), packed rows (B=4 S=2048, three segments per row, positions
     restarting: per-batch tables), interleaved rotary over 32 of 64
     features, GQA (Hkv=4), S=300 and D=128, and the walk's edges (S = 1,
     65, 129 with GQA and at D = 128, B * H = 143, GQA at S = 2048); every
     forward and backward bit-identical on a second run; at the MLM shape
     the backward kernels given negated sin tables (the wrong adjoint) must
     fall outside.
 14. fused_encode (after phase 6): the encode batch of 256 x 512 with
     fused_rotary=True, 12 fused launches, cosine >= 0.999 against the
     outside rotation; both models' forward timed in turns.
 15. fused_kernel_timing and rotary_ablation (after the forward timing):
     each fused kernel at the MLM shape beside its bound, the unfused kernel
     on pre-rotated q/k, the plain versions and the nearest library
     composite; the port of scripts/ablate_rotary_fusion.py (rotary outside,
     pre-rotated, fused; forward and forward+backward).
 16. mlm_*: the JAX MLM benchmark step (bench.py:837-884) at full width,
     NomicBertForPreTraining(nomic-bert-2048, flash, fused_rotary=True) in
     bf16 with fp32 parameters, B=8 x 2048 with 30% masked and
     dense_seq_output (768 positions per row), AdamW lr 5e-4 wd 0.01 clip
     1.0: 5 steps, each with exactly 12 fused forward, dq and dk/dv
     launches and no unfused one, loss falling; the same step with
     fused_rotary=False timed in turns with it; one profiled step; one
     update at gradient_accumulation_steps=4; at B=2 the gradients per
     tensor against the unfused kernels and against sdpa (cosine >= 0.999),
     with the negated-sin fault outside.
The trainer entry point (after phase 7):
 17. trainer: configs/train/contrastive_pretrain.yaml (PRETRAIN_RECIPE) with
     the overrides of `trainer_overrides` (a local config.json of
     nomic-bert-2048 with random weights, 512 pairs of local synthetic
     data, 8 steps, warmup 2, log and save every 4, the retrieval eval at
     step 8, every query chunk direct) through train.run and the
     TextTextTrainer with the stand-in tokenizer, in bf16: per step 780 /
     396 / 396 flash launches (the bare step's), the loss at step 8 below
     step 1's, the logged lr on make_schedule, a second trainer resumed
     from step_4 logging steps 5-8 within 2e-3 relative, the eval logged,
     and no more synchronising calls per quiet loop step (sync debug mode)
     than the bare step makes. Timed against the bare step in turns (bare,
     loop, bare, resumed loop): the loop's median ms per quiet step, its
     idle share, the time it waits on the prefetch queue, and one
     grad-cache step's peak memory with and without activation
     checkpointing.
The BERT pretraining and fine-tuning family (after phase 16):
 18. mlm_trainer, mmlm_trainer, glue_trainer and dropout_checks:
     configs/train/mlm.yaml, mmlm.yaml and glue.yaml through the port's
     read_config and train.run at full width (12 x 768, H = 12, D = 64; the
     public config.json fields of bert-base-uncased and xlm-roberta-base,
     random weights, in-memory data, the stand-in tokenizer), in bf16, cut
     in batch, steps and data only (`bert_family_overrides`): MLM 32
     micro-steps of 4 x 2048 (8 updates at the recipe's accumulation 4,
     warmup 2 updates, the eval at the end over 2 batches), MMLM 4 steps of
     8 x 512 over two languages, GLUE sst2 the recipe's 3 epochs of 12
     steps (32 x 128, eval batch 64 on 100 padded sentences). Gates: no
     flash launch in any training step (the recipes' attention dropout 0.1
     runs sdpa, as in JAX) and 12 forwards per eval batch; finite losses,
     the MLM loss falling (the mean of updates 7-8 below that of updates
     1-2); 0 synchronising calls per quiet loop step; `loss/<lang>` logged;
     the MLM val_loss through the kernel within 1e-2 of the plain path's;
     the GLUE eval logits at cosine >= 0.999 with the same argmax on >= 99%
     of rows; a train-mode forward bit-identical under one seed, another
     under another; one MLM micro-step's gradients with remat on and off
     bit-identical, and a planted global-RNG dropout failing that check;
     each dropout site's keep share within 0.9 +- 0.0006 over >= 10^7
     draws, the kept values 1 / 0.9. Recorded: peak memory, the micro-steps'
     ms, and the MLM micro-step with dropout on (sdpa) and off (the flash
     kernels) in turns beside phase 16's dropout-free step.
The vision / LiT family (after phase 18):
 19. vit_kernel_timing, vision_main_path, lit_standard, lit_grad_cache and
     lit_grad_agreement. The ViT's attention shape (B=64 S=T=197 H=12
     D=64, no mask: a partial last tile) is a case of phases 3 and 4; here
     its forward, dq and dk/dv are timed beside their bounds, the plain
     versions and SDPA. A full-width DualEncoder in bf16 with seed weights
     (text: nomic-bert-2048's geometry at 77 tokens, hamming LN; vision:
     EVA02-B/16 at 224, 2-D rope, SwiGLU 2048 with norm_mlp, no final LN,
     MAP head) encodes 256 images and 256 captions: 12 flash launches per
     tower forward, cosine >= 0.999 against attn_impl="sdpa" in fp32,
     images/s.
     Then configs/train/nomic_embed_vision_v1.5.yaml through read_config and
     train.run (`lit_recipe`: pretrained false on both towers, remat on as
     the recipe sets it; cut in batch 16384 -> 512, warmup 2000 -> 2, 8
     steps, in-memory uint8 images and stand-in captions through the
     trainer's data hook, the zero-shot eval at the last step over 4
     in-memory batches through its eval hook), and the same recipe with
     grad_cache, chunk 128, at batch 2048 for 3 steps. Gates: flash
     launches per step as the code predicts (36 / 12 / 12, and 768 / 192
     / 192), the loss falling, the logit scale moving, the text tower
     bit-identical, 0 synchronising calls per quiet step, the eval's
     launches (12 per batch of the 8000 prompts and of images); grad cache
     against the standard step on one batch of 512 (cosine >= 0.9999,
     relative L2 <= 0.01), a planted rolled replay outside both.
The families of configs/train/ no earlier phase drives (after phase 19):
 20. modernbert_*, moe_training, distill_training, pythia_*,
     family_kernel_timing: each model at its published widths (the
     config.json of ModernBERT-base, nomic-bert-2048 and pythia-160m; the
     distill student that config.json at 6 layers) with seeded weights
     written under the HF names as pytorch_model.bin, loaded through the
     port's loaders. Serving (ModernBERT 256 x 512, mean pooling; pythia
     256 x 128, last pooling; one padded batch through Encoder): n_layer
     flash launches, cosine >= 0.999 against sdpa in fp32, texts/s.
     Training through read_config and train.run on
     contrastive_finetune_modernbert.yaml, contrastive_finetune_moe.yaml
     (the dense checkpoint upcycled to 8 experts: every expert the dense
     MLP bit for bit after the load), distill.yaml (student layer i the
     teacher's layer 2i bit for bit after the init, the teacher unchanged
     after the steps) and contrastive_finetune_decoder.yaml, each cut in
     batch, steps, warmup and data (`FAMILIES`; one in-memory batch
     repeated), in bf16: launches per step as the code predicts them
     (flash, and gmm / tgmm for the MoE), the loss falling, 0 synchronising
     calls per quiet step, step ms and peak memory. Then the two new
     shapes timed: forward, dq and dk/dv beside bounds over the live pairs
     only and SDPA with the equivalent boolean mask.
Kernel times (ms) are CUDA-event times of calls made on an idle card, so a
short kernel's time holds the host's enqueue; phases 8 and 9 give beside
them the device's work alone (device_ms: each call queued behind a device
sleep) and the host's enqueue per call, for the kernels and the library.
Every timing line carries the card's SM clock, power draw and temperature,
and every phase line the seconds since the start (t); the command_time line
gives the whole run's. The line before the last holds the kernels'
summary, and the last line is {"ok": true, "device": {...}}. Exits
non-zero without a CUDA device.
"""

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


T0 = time.perf_counter()


def emit(**kw):
    """One JSON line, with the seconds since the script started."""
    print(json.dumps(dict(kw, t=round(time.perf_counter() - T0, 1))), flush=True)


def _smi(fields):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def card_line():
    return _smi("name,power.limit")


def gpu_state():
    """SM clock, its maximum, power draw and temperature, read beside a timing."""
    return _smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")


def make_texts(rng, n, lo, hi, lognormal=True):
    if lognormal:
        lens = np.clip(rng.lognormal(np.log(96), 0.9, size=n), lo, hi).astype(int)
    else:
        lens = rng.integers(lo, hi + 1, size=n)
    return [" ".join(map(str, rng.integers(1000, 30000, size=L - 1))) for L in lens]


def ptxas_usage(log):
    """{kernel<D>: "R registers, S bytes spilled, M bytes static smem"} from
    nvcc -Xptxas=-v output (dynamic shared memory is set at the launch)."""
    usage, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv))_kernelILi(\d+)E(?:Li(\d+)E)?(?:Lb([01])E)?"
                      r"|(t?gmm_kernel)(?:ILb([01])E)?", line)
        if m and m.group(1):  # <D[, consumer warpgroups][, rotary]>
            groups = f", {m.group(3)} warpgroups" if m.group(3) else ""
            rotary = ", rotary" if m.group(4) == "1" else ""
            fn, spill = f"{m.group(1)}_kernel<{m.group(2)}{groups}{rotary}>", "?"
        elif m:
            layout = {"0": "<false>", "1": "<true>", None: ""}[m.group(6)]
            fn, spill = m.group(5) + layout, "?"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", line)
            usage[fn] = (f"{m.group(1)} registers, {spill} bytes spilled, "
                         f"{smem.group(1) if smem else 0} bytes static smem")
    return usage


def event_ms(fn, runs=10, warmup=3, queued=False):
    """CUDA-event times of `runs` calls after `warmup` untimed ones, the card
    idle before each: where the device waits for the host, the host's
    enqueue is in the time. With queued=True each timed call is queued
    behind ~1 ms of device sleep instead, so the events time the device's
    work alone."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def median_ms(fn, runs=10, warmup=3, queued=False):
    return float(np.median(event_ms(fn, runs, warmup, queued)))


def live_pairs(lens, S, T, causal=False, window=0, all_rows=False):
    """The (query row, key) pairs the kernels must compute on these inputs:
    key c of batch row b is live when c < lens[b] and inside the band
    (bottom-right causal: c <= r + T - S; window: |r - c| <= window // 2);
    the query rows are r < lens[b] (the mask as the query ids, S == T), or
    every row with all_rows (the dispatch's form below kv 512: query ids
    1). Counted on the host, exactly."""
    r, c = np.arange(S)[:, None], np.arange(T)[None, :]
    band = np.ones((S, T), bool)
    if causal:
        band &= c <= r + T - S
    if window:
        band &= np.abs(r - c) <= window // 2
    below = np.cumsum(band, axis=1)  # [r, c]: band keys of row r at columns <= c
    return int(sum(below[:S if all_rows else n, n - 1].sum() for n in np.asarray(lens, np.int64) if n > 0))


def _live_rows(B, S, lens, all_rows):
    """(query rows each kernel must read, key rows of k and v it must read):
    every row without lens; else the live keys, and the live query rows
    unless all_rows."""
    if lens is None:
        return B * S, None
    return (B * S if all_rows else int(sum(min(n, S) for n in lens))), int(sum(lens))


def attention_bound(B, S, T, H, Hkv, D, lens=None, causal=False, window=0, all_rows=False):
    """Least time for the forward on this card: the larger of the tensor-core
    time for the live (row, key) pairs these inputs need (`live_pairs`:
    every pair without lens, a padding mask's keys of length lens, and with
    them its rows unless all_rows; the causal or window band) and the time
    to read q at live rows, k and v at live keys and the ids (with lens),
    and to write O and LSE once."""
    live_q, live_kv = _live_rows(B, S, lens, all_rows)
    live_kv = B * T if live_kv is None else live_kv
    pairs = live_pairs([T] * B if lens is None else lens, S, T, causal, window, all_rows=all_rows or lens is None)
    flops = 4.0 * D * H * pairs
    nbytes = 2 * (live_q * H * D + B * S * H * D + 2 * live_kv * Hkv * D) + 4 * B * H * S
    if lens is not None:
        nbytes += 4 * (B * S + B * T)
    return _bound(flops, nbytes)


def _bound(flops, nbytes):
    bound_s = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
    return bound_s * 1e3, "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes", flops, nbytes


def backward_bound(kernel, B, S, T, H, Hkv, D, lens=None, causal=False, window=0, all_rows=False):
    """Least time for one backward kernel on this card, over the live (row,
    key) pairs (as `attention_bound`): dq runs 3 products (q k^T, dO v^T,
    ds k), dk/dv 4 (q k^T, dO v^T, p^T dO, ds^T q), each 2*D FLOP per pair
    and q head. Bytes are what each kernel must move once: dq reads q, dO,
    O and LSE at live query rows, k and v at live keys (and the ids) and
    writes dq and delta; dk/dv reads q, dO, LSE and delta at live query
    rows, k and v at live keys (and the ids) and writes dk and dv."""
    live_q, live_kv = _live_rows(B, S, lens, all_rows)
    live_kv = B * T if live_kv is None else live_kv
    kv = 2 * 2 * live_kv * Hkv * D
    if kernel == "dq":
        products, nbytes = 3, kv + 2 * 3 * live_q * H * D + 4 * H * live_q + 2 * B * S * H * D + 4 * B * H * S
    else:
        products, nbytes = 4, kv + 2 * 2 * live_q * H * D + 8 * H * live_q + 4 * B * T * Hkv * D
    pairs = live_pairs([T] * B if lens is None else lens, S, T, causal, window, all_rows=all_rows or lens is None)
    flops = products * 2.0 * D * H * pairs
    if lens is not None:
        nbytes += 4 * (B * S + B * T)
    return _bound(flops, nbytes)


# the JAX headline step's geometry (bench.py: build_headline_step and its batches)
PAIRS, Q_LEN, D_LEN, CHUNK = 512, 32, 256, 16
# the JAX MoE benchmark step (bench.py:886-980): chunk 32, every chunk
# cached, router aux 0.001
MOE_CHUNK, MOE_AUX = 32, 0.001


def moe_config(impl="flash"):
    """nomic-bert-2048 with the MoE recipe's experts
    (configs/train/contrastive_finetune_moe.yaml): 8 experts, top-2, MoE on
    every second layer, dropless."""
    from contrastors_tpu_torch.models.presets import nomic_bert_2048

    return nomic_bert_2048(attn_impl=impl, num_experts=8, moe_top_k=2, moe_every_n_layers=2,
                           moe_impl="dropless")


# the seed-0 weights of each model, drawn once and kept on the host
SEED_WEIGHTS = {}


def seed_weights(model, key):
    """Load the seed-0 weights (`init_weights`) of the model family `key`
    into model, drawing them on first use; every later model of the family
    gets the same values by copy, without drawing them again."""
    from contrastors_tpu_torch.models import init_weights

    if key in SEED_WEIGHTS:
        model.load_state_dict(SEED_WEIGHTS[key])
    else:
        init_weights(model, seed=0)
        SEED_WEIGHTS[key] = {n: t.detach().to("cpu", copy=True) for n, t in model.state_dict().items()}
    return model


def train_modules(impl, dev, lr=2e-4, max_grad_norm=1.0, moe=False, dtype=None):
    """BiEncoder(nomic-bert-2048, or its MoE form, mean pooling, bf16
    compute unless `dtype`) with random weights from seed 0, a fixed
    LogitScale(50) and AdamW (the headline's: lr 2e-4, wd 0.01, clip 1.0)."""
    import torch

    from contrastors_tpu_torch.models import BiEncoder, LogitScale
    from contrastors_tpu_torch.models.presets import nomic_bert_2048
    from contrastors_tpu_torch.utils.optim import make_optimizer

    cfg = moe_config(impl) if moe else nomic_bert_2048(attn_impl=impl)
    model = seed_weights(BiEncoder(cfg, pooling="mean", dtype=dtype or torch.bfloat16, device=dev),
                         "moe" if moe else "dense")
    scale = LogitScale(50.0, trainable=False, device=dev)
    named = [("model." + n, p) for n, p in model.named_parameters()]
    named += [("logit_scale." + n, p) for n, p in scale.named_parameters()]
    return model, scale, make_optimizer(named, lr, weight_decay=0.01, max_grad_norm=max_grad_norm)


def token_batches(pairs, dev, seed=0):
    """Query and document token batches from numpy; each document starts
    with its query's tokens, which gives the model something to learn."""
    import torch

    rng = np.random.default_rng(seed)
    q = rng.integers(5, 30000, size=(pairs, Q_LEN))
    d = rng.integers(5, 30000, size=(pairs, D_LEN))
    d[:, :Q_LEN] = q

    def batch(ids):
        t = torch.from_numpy(ids).to(dev)
        return {"input_ids": t, "attention_mask": torch.ones_like(t)}

    return batch(q), batch(d)


def step_grads(impl, grad_cache, dev, qb, db, moe=False, router_aux_coef=0.0, dtype=None):
    """The gradients of one train step at the headline settings (the MoE
    benchmark's with moe, router aux router_aux_coef; compute in bf16 unless
    `dtype`), read after a step whose optimizer (lr 0, no clip) leaves the
    weights and the gradients as they were."""
    import torch

    from contrastors_tpu_torch.trainers.text_text import make_train_step

    model, scale, opt = train_modules(impl, dev, lr=0.0, max_grad_norm=None, moe=moe, dtype=dtype)
    kw = dict(chunk_size=MOE_CHUNK, direct_chunks_q=0) if moe else dict(chunk_size=CHUNK, direct_chunks_q=-1)
    step = make_train_step(model, scale, opt, grad_cache=grad_cache, direct_chunks_d=0,
                           router_aux_coef=router_aux_coef, **kw)
    step(qb, db, torch.Generator().manual_seed(0))
    return {n: p.grad.float().clone() for n, p in model.named_parameters() if p.grad is not None}


@contextlib.contextmanager
def planted_fault(kind):
    """A fault planted in the step, to show that the agreement bounds reject
    it: "no_delta" hands the backward kernels O = 0, so the dq kernel
    computes delta = 0 for both; "rolled_replay"
    makes pass 2 replay each document chunk with its rows rotated by one,
    so each row's embedding receives another row's cotangent; "tgmm_roll"
    makes tgmm write expert e's gradient into expert (e + 1) mod E;
    "negated_sin" gives the fused-rotary backward kernels negated sin
    tables, so they recompute the inverse rotation and apply the wrong
    adjoint."""
    import torch

    from contrastors_tpu_torch.ops import flash_attention as fa
    from contrastors_tpu_torch.ops import grouped_matmul as gm
    from contrastors_tpu_torch.trainers import text_text

    if kind == "tgmm_roll":
        def patched(*args, orig=gm.launch_tgmm):
            return torch.roll(orig(*args), 1, 0)
        patches = [(gm, "launch_tgmm", patched)]
    elif kind == "no_delta":
        def patched(*args, orig=fa.prepare_backward):  # O = 0: the dq kernel computes delta = 0
            inputs = orig(*args)
            return (*inputs[:4], torch.zeros_like(inputs[4]), *inputs[5:])
        patches = [(fa, "prepare_backward", patched)]
    elif kind == "negated_sin":
        def negated(orig):
            def launch(*args, rot=None):
                return orig(*args, rot=rot._replace(sin=-rot.sin) if rot is not None else None)
            return launch
        patches = [(fa, name, negated(getattr(fa, name))) for name in ("launch_bwd_dq", "launch_bwd_dkv")]
    else:
        def patched(model, batch, generator=None, orig=text_text.encode_batch):
            if torch.is_grad_enabled() and batch["input_ids"].shape[1] == D_LEN:
                batch = {k: v.roll(1, 0) for k, v in batch.items()}
            return orig(model, batch, generator)
        patches = [(text_text, "encode_batch", patched)]
    saved = [(module, name, getattr(module, name)) for module, name, _ in patches]
    for module, name, fn in patches:
        setattr(module, name, fn)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def compare_grads(got, ref):
    """Per-tensor cosine and relative L2 distance of got against ref."""
    cos, rel = {}, {}
    for n, y in ref.items():
        x, y = got[n].flatten().double(), y.flatten().double()
        ny = y.norm().item()
        if ny == 0:
            continue
        cos[n] = (x @ y).item() / max(x.norm().item() * ny, 1e-300)
        rel[n] = (x - y).norm().item() / ny
    worst_cos, worst_rel = min(cos, key=cos.get), max(rel, key=rel.get)
    return dict(tensors=len(cos), min_cosine=cos[worst_cos], min_cosine_tensor=worst_cos,
                max_rel_l2=rel[worst_rel], max_rel_l2_tensor=worst_rel)


@contextlib.contextmanager
def plain_grouped_matmul():
    """The comparison side of the MoE checks: gmm's and tgmm's wrappers run
    their plain versions on CUDA tensors (the package has no such switch)."""
    from contrastors_tpu_torch.ops import grouped_matmul as gm

    saved = gm.launch_gmm, gm.launch_tgmm
    gm.launch_gmm = lambda lhs, rhs, blk_e, act, block_m=128: gm._gmm_plain(lhs, rhs, blk_e, act, block_m)
    gm.launch_tgmm = lambda lhs, dout, gs, block_m=128: gm.tgmm_reference(lhs, dout, gs, block_m)
    try:
        yield
    finally:
        gm.launch_gmm, gm.launch_tgmm = saved


@contextlib.contextmanager
def shared_routing(decisions, replay):
    """Record each MoE layer's expert choices and token validity in call
    order (replay=False), or route by the recorded choices (replay=True):
    the weights are then the run's own probabilities at those experts. A
    reference run that replays the kernel run's choices differs from it only
    in arithmetic, not in the discrete top-k, which a bf16 rounding can flip
    for a near-tie token."""
    from contrastors_tpu_torch.layers.moe import MoEMLP

    orig = MoEMLP.route

    def route(self, probs, valid):
        if not replay:
            top_w, top_e = orig(self, probs, valid)
            decisions.append((top_e.detach().clone(), valid.detach().clone()))
            return top_w, top_e
        top_e = decisions.pop(0)[0]
        top_w = probs.gather(-1, top_e)
        if self.config.moe_normalize_expert_weights:
            top_w = top_w / top_w.sum(dim=-1, keepdim=True)
        return top_w * valid.to(top_w.dtype), top_e

    MoEMLP.route = route
    try:
        yield
    finally:
        MoEMLP.route = orig


# every launch counter: name in the counts -> (module, attribute)
COUNTERS = dict(fwd=("fa", "launches"), dq=("fa", "launches_bwd_dq"), dkv=("fa", "launches_bwd_dkv"),
                fwd_rot=("fa", "launches_rot"), dq_rot=("fa", "launches_bwd_dq_rot"),
                dkv_rot=("fa", "launches_bwd_dkv_rot"), gmm=("gm", "launches_gmm"),
                tgmm=("gm", "launches_tgmm"))


def _counter_modules():
    from contrastors_tpu_torch.ops import flash_attention as fa
    from contrastors_tpu_torch.ops import grouped_matmul as gm

    return dict(fa=fa, gm=gm)


def reset_counts():
    mods = _counter_modules()
    for mod, attr in COUNTERS.values():
        setattr(mods[mod], attr, 0)


def read_counts():
    mods = _counter_modules()
    return {name: getattr(mods[mod], attr) for name, (mod, attr) in COUNTERS.items()}


def expect(**counts):
    """Expected counts: the ones given, every other counter 0."""
    return dict(dict.fromkeys(COUNTERS, 0), **counts)


def moe_layout(dev, A, E=8, seed=0):
    """The MoE layer's own layout call (aligned_group_layout) on A skewed
    random assignments: expert 2 gets none, expert 5 exactly 128 rows (a
    group with no padding), the rest a cubed-uniform share; the sentinel
    marks padding rows. Returns (group_sizes, P, pad row mask, blk_e, act)."""
    import torch

    from contrastors_tpu_torch.ops import grouped_matmul as gm

    gen = torch.Generator(device=dev).manual_seed(seed)
    p = torch.rand(E, generator=gen, device=dev) ** 3 + 0.01
    p[2] = p[5] = 0.0
    flat_e = torch.multinomial(p, A - 128, replacement=True, generator=gen)
    flat_e = torch.cat([flat_e, torch.full((128,), 5, device=dev)])
    flat_e = flat_e[torch.randperm(A, generator=gen, device=dev)]
    _, gs, P, src = gm.aligned_group_layout(flat_e, E, 128, src_of=torch.arange(A, device=dev), sentinel=A)
    blk_e, act = gm.block_experts(gs, P // 128, 128)
    return gs, P, src == A, blk_e, act


# (name, assignments): the MoE step's document chunk (32 x 256 tokens,
# top-2) and query chunk (32 x 32), and one encode batch (256 x 512)
MOE_LAYOUTS = (("doc_chunk", 32 * 256 * 2), ("query_chunk", 32 * 32 * 2), ("encode", 256 * 512 * 2))


def gmm_operands(dev, P, K, N, pad, seed):
    """Random bf16 lhs [P, K], rhs [8, K, N] and dout [P, N], with lhs and
    dout zero on padding rows, as the MoE layer's gather and its gradient
    leave them."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    lhs = torch.randn(P, K, generator=gen, device=dev).bfloat16().masked_fill(pad[:, None], 0)
    rhs = torch.randn(8, K, N, generator=gen, device=dev).bfloat16()
    dout = torch.randn(P, N, generator=gen, device=dev).bfloat16().masked_fill(pad[:, None], 0)
    return lhs, rhs, dout


def differing_choices(a, b):
    """(tokens routed differently, tokens routed) between two shared_routing
    recordings of the same calls, over valid tokens only (padding tokens
    carry weight 0); a token counts once if its expert set differs."""
    diff = sum(int(((x.sort(-1).values != y.sort(-1).values).any(-1) & v[:, 0]).sum())
               for (x, v), (y, _) in zip(a, b))
    return diff, sum(int(v.sum()) for _, v in a)


def standard_order(decisions, chunks):
    """A grad-cache run's recorded expert choices (shared_routing) in the
    call order of the standard step, which encodes each tower in one batch:
    the pass-2 half of the recording (each tower's `chunks` chunks in order,
    queries first, one call per MoE layer and chunk) joined over each
    tower's chunks, layer by layer."""
    import torch

    pass2 = decisions[len(decisions) // 2:]
    n_moe = len(pass2) // (2 * chunks)
    joined = []
    for tower in range(2):
        for layer in range(n_moe):
            parts = [pass2[(tower * chunks + c) * n_moe + layer] for c in range(chunks)]
            joined.append((torch.cat([e for e, _ in parts]), torch.cat([v for _, v in parts])))
    return joined


def moe_serving(dev, card, tok, rng, gen):
    """Phases moe_main_path, moe_sdpa_agreement and moe_encode_throughput.
    Returns (launches of the encode run, its batches)."""
    import torch

    from contrastors_tpu_torch.eval.encoder import Encoder
    from contrastors_tpu_torch.models import BiEncoder

    cfg = moe_config()
    model = seed_weights(BiEncoder(cfg, pooling="mean", dtype=torch.bfloat16, device=dev), "moe")
    n_params = sum(p.numel() for p in model.parameters())
    docs = [{"title": "", "text": t} for t in make_texts(rng, 512, 8, 511)]
    enc = Encoder(model, tok, seq_len=512, batch_size=256)
    reset_counts()
    t0 = time.perf_counter()
    emb = enc.encode_corpus(docs)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    batches = -(-len(docs) // 256)
    n_moe = sum(1 for b in model.trunk.layers if b.moe)
    expected = expect(fwd=cfg.n_layer * batches, gmm=3 * n_moe * batches)
    norms = np.linalg.norm(emb, axis=-1)
    ok = (launches == expected and emb.shape == (len(docs), cfg.n_embd) and bool(np.isfinite(emb).all())
          and float(np.abs(norms - 1).max()) < 1e-4)
    emit(phase="moe_main_path", params=n_params, moe_layers=n_moe, experts=cfg.num_experts,
         top_k=cfg.moe_top_k, requests=len(docs), batches=batches, launches=launches,
         expected_launches=expected, seconds=seconds, max_norm_dev=float(np.abs(norms - 1).max()), ok=ok)
    if not ok:
        raise AssertionError("MoE main path: launch counts, shape, finiteness or norm check failed")

    # the same weights under attn_impl="sdpa" and the plain grouped matmul;
    # both encodes run again with their expert choices recorded, to count
    # the tokens that the switch routes to another expert pair
    model_ref = BiEncoder(moe_config("sdpa"), pooling="mean", dtype=torch.bfloat16, device=dev)
    model_ref.load_state_dict(model.state_dict())
    kernel_choices, ref_choices = [], []
    with shared_routing(kernel_choices, replay=False):
        enc.encode_corpus(docs)
    with plain_grouped_matmul(), shared_routing(ref_choices, replay=False):
        ref = Encoder(model_ref, tok, seq_len=512, batch_size=256).encode_corpus(docs)
    cos = (emb * ref).sum(-1)
    flipped, routed = differing_choices(kernel_choices, ref_choices)
    ok = float(cos.min()) >= 0.999
    emit(phase="moe_sdpa_agreement", min_cosine=float(cos.min()), mean_cosine=float(cos.mean()),
         threshold=0.999, tokens_routed=routed, tokens_routed_differently=flipped,
         note="reference: attn_impl='sdpa' and the plain grouped matmul, same weights, each "
              "routing on its own; valid tokens counted once per MoE layer", ok=ok)
    if not ok:
        raise AssertionError("MoE embeddings: kernels and sdpa + plain grouped matmul disagree")
    del model_ref, ref, kernel_choices, ref_choices

    texts_512 = make_texts(rng, 256, 512, 512, lognormal=False)
    enc.query_prefix = enc.document_prefix = None
    host_ms = []
    for i in range(6):
        t0 = time.perf_counter()
        e = enc.encode(texts_512)
        if i >= 1:
            host_ms.append((time.perf_counter() - t0) * 1e3)
    assert e.shape == (256, cfg.n_embd) and np.isfinite(e).all()
    ids = torch.randint(1000, 30000, (256, 512), generator=gen, device=dev)
    with torch.inference_mode():
        fwd_ms = median_ms(lambda: model(ids, torch.ones_like(ids), normalize=False), runs=5, warmup=2)
    enc_ms = float(np.median(host_ms))
    emit(phase="moe_encode_throughput", card=card, gpu_state=gpu_state(), batch=256, seq_len=512,
         encode_ms=enc_ms, encode_ms_min=min(host_ms), encode_ms_max=max(host_ms),
         texts_per_s=256 / enc_ms * 1e3, tokens_per_s=256 * 512 / enc_ms * 1e3,
         forward_ms=fwd_ms, forward_tokens_per_s=256 * 512 / fwd_ms * 1e3)
    del model, enc
    torch.cuda.empty_cache()
    return launches, batches


@contextlib.contextmanager
def chunk_aux_recorder(into):
    """Record each chunk's router aux that pass 2 backpropagates."""
    import torch

    from contrastors_tpu_torch.trainers import text_text

    orig = text_text.encode_batch

    def recording(model, batch, generator=None):
        out = orig(model, batch, generator)
        if torch.is_grad_enabled() and "router_aux" in out:
            into.append(out["router_aux"].detach())
        return out

    text_text.encode_batch = recording
    try:
        yield
    finally:
        text_text.encode_batch = orig


GC_PHASES = ("grad_cache/direct", "grad_cache/pass1", "grad_cache/loss", "grad_cache/pass2",
             "train_step/optimizer")
STD_PHASES = ("train_step/forward", "train_step/backward", "train_step/optimizer")


def profile_step(run, step_ms, phases=GC_PHASES):
    """One step, run(), under torch.profiler: busy time by kernel group and
    of the 12 largest kernels outside the named groups, the split at the
    profiler ranges, and the device-to-host copies and host syncs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    # one pass over the events: key_averages() takes minutes on a step's
    # ~1M host events, this loop about a second
    split = {name: {} for name in phases}
    by_group, other, busy_ms, launches, dtoh, items = {}, {}, 0.0, 0, 0, 0
    for e in prof.events():
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name in split:
            if on_device:
                split[e.name]["device_span_ms"] = e.device_time_total / 1e3
            else:
                split[e.name]["host_ms"] = e.cpu_time_total / 1e3
        elif on_device and not getattr(e, "is_user_annotation", False):  # ranges are not kernels
            ms = e.self_device_time_total / 1e3
            busy_ms += ms
            launches += 1
            group = kernel_group(e.name)
            g = by_group.setdefault(group, [0.0, 0])
            g[0] += ms
            g[1] += 1
            if group == OTHER:
                g = other.setdefault(e.name[:120], [0.0, 0])
                g[0] += ms
                g[1] += 1
        if "DtoH" in e.name:
            dtoh += 1
        elif e.name == "aten::item":
            items += 1
    return dict(device_busy_ms=busy_ms, kernel_launches=launches,
                idle_share_of_step=1.0 - busy_ms / step_ms, profiled_step_ms=profiled_ms, split=split,
                by_group={k: dict(ms=v[0], launches=v[1])
                          for k, v in sorted(by_group.items(), key=lambda kv: -kv[1][0])},
                top_other={k: dict(ms=v[0], launches=v[1])
                           for k, v in sorted(other.items(), key=lambda kv: -kv[1][0])[:12]},
                device_to_host_copies=dtoh, item_calls=items)


OTHER = "other (elementwise, reductions, copies)"


def kernel_group(name):
    """The profile's group of a device event: each kernel of the port by
    name, cuBLAS products, and the rest."""
    m = re.search(r"flash_\w+_kernel<\d+(?:, \d+)?(?:, (?:true|false))?>|tgmm_kernel|gmm_kernel", name)
    if m:
        return m.group(0)
    if "gemm" in name or "nvjet" in name or "cutlass" in name or "sm90" in name:
        return "matmul"
    return OTHER


def moe_training(dev, card, agreement=True):
    """Phases moe_train_step, moe_train_timing, moe_train_profile and (with
    agreement) moe_train_grad_agreement. Returns the launches of one step."""
    import gc

    import torch

    from contrastors_tpu_torch.trainers.text_text import make_train_step

    cfg = moe_config()
    torch.cuda.reset_peak_memory_stats()
    model, scale, opt = train_modules("flash", dev, moe=True)
    step = make_train_step(model, scale, opt, grad_cache=True, chunk_size=MOE_CHUNK, direct_chunks_q=0,
                           direct_chunks_d=0, router_aux_coef=MOE_AUX)
    qb, db = token_batches(PAIRS, dev)
    n_chunks = 2 * PAIRS // MOE_CHUNK  # query and document chunks
    n_moe = sum(1 for b in model.trunk.layers if b.moe)
    # forwards: every chunk in pass 1 and pass 2; backwards: every chunk;
    # gmm: 3 per MoE layer per forward, and one dlhs per backward of each
    expected = expect(fwd=cfg.n_layer * 2 * n_chunks, dq=cfg.n_layer * n_chunks, dkv=cfg.n_layer * n_chunks,
                      gmm=3 * n_moe * 2 * n_chunks + 3 * n_moe * n_chunks, tgmm=3 * n_moe * n_chunks)
    train_gen = torch.Generator().manual_seed(0)
    steps, chunk_aux = [], []
    for i in range(5):
        reset_counts()
        t0 = time.perf_counter()
        with chunk_aux_recorder(chunk_aux) if i == 0 else contextlib.nullcontext():
            m = step(qb, db, train_gen)
        loss = m["loss"].item()
        steps.append(dict(loss=loss, router_aux=m["router_aux"].item(), grad_norm=m["grad_norm"].item(),
                          accuracy=m["accuracy"].item(), seconds=time.perf_counter() - t0,
                          launches=read_counts()))
    launches = steps[0]["launches"]
    losses = [x["loss"] for x in steps]
    chunk_aux = [float(a) for a in chunk_aux]
    aux_ok = (len(chunk_aux) == n_chunks and all(np.isfinite(x["router_aux"]) for x in steps)
              and 1.9 <= min(chunk_aux) and max(chunk_aux) <= 3.0)
    ok = (all(x["launches"] == expected for x in steps) and bool(np.isfinite(losses).all())
          and losses[-1] < losses[0] and aux_ok)
    emit(phase="moe_train_step", params=sum(p.numel() for p in model.parameters()), pairs=PAIRS,
         q_len=Q_LEN, d_len=D_LEN, chunk=MOE_CHUNK, router_aux_coef=MOE_AUX, expected_launches=expected,
         steps=steps, first_step_chunk_aux=dict(n=len(chunk_aux), min=min(chunk_aux), max=max(chunk_aux),
                                                mean=float(np.mean(chunk_aux)), balanced=2.0),
         peak_memory_gb=torch.cuda.max_memory_allocated() / 2**30, ok=ok)
    if not ok:
        raise AssertionError("MoE train step: launch counts, finiteness, falling loss or router aux failed")

    host_ms, enqueue_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        step(qb, db, train_gen)
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(host_ms))
    emit(phase="moe_train_timing", card=card, gpu_state=gpu_state(), pairs=PAIRS, runs=len(host_ms),
         step_ms=step_ms, step_ms_min=min(host_ms), step_ms_max=max(host_ms),
         enqueue_ms=float(np.median(enqueue_ms)), pairs_per_s=PAIRS / step_ms * 1e3,
         tokens_per_s=PAIRS * (Q_LEN + D_LEN) / step_ms * 1e3)
    emit(phase="moe_train_profile", card=card, gpu_state=gpu_state(),
         **profile_step(lambda: step(qb, db, train_gen), step_ms),
         note="one profiled step: busy time of its kernels (idle share against the unprofiled median "
              "step_ms); device_to_host_copies counts the step's device-to-host memcpys (host syncs); "
              "item_calls counts Tensor.item, including those on CPU tensors (AdamW's step counters)")
    del model, scale, opt, step, qb, db
    gc.collect()
    torch.cuda.empty_cache()
    if agreement:
        moe_grad_agreement(dev)
    return launches


def tensor_group(name):
    """The layer a parameter belongs to: layer_<i>, embeddings or other."""
    m = re.search(r"layers\.(\d+)\.", name)
    return f"layer_{int(m.group(1)):02d}" if m else ("embeddings" if "embeddings" in name else "other")


def per_group_rel_l2(got, ref):
    """Relative L2 distance of got against ref over each tensor group."""
    import torch

    groups = {}
    for n in ref:
        groups.setdefault(tensor_group(n), []).append(n)
    out = {}
    for g, names in sorted(groups.items()):
        x = torch.cat([got[n].flatten().double() for n in names])
        y = torch.cat([ref[n].flatten().double() for n in names])
        out[g] = (x - y).norm().item() / max(y.norm().item(), 1e-300)
    return out


def moe_chunk_reading(dev, sq, sd):
    """The grad-cache margin chunk by chunk (MOE_CHUNK rows, both towers):
    for each chunk, the relative L2 distance of its pass-1 embeddings and of
    its loss cotangent from the standard step's rows, and of the gradient it
    contributes (<embedding, cotangent> backpropagated through its own
    forward) from the one the standard step's whole-tower forward gives the
    same rows, overall and by layer. Router aux off: the embedding part."""
    import gc

    import torch

    from contrastors_tpu_torch.losses import clip_loss
    from contrastors_tpu_torch.trainers.text_text import encode_batch

    model, scale, _ = train_modules("flash", dev, lr=0.0, max_grad_norm=None, moe=True)
    n = 64 // MOE_CHUNK

    def rows(b, i):
        return {k: v[i * MOE_CHUNK:(i + 1) * MOE_CHUNK] for k, v in b.items()}

    def cotangents(embs):
        leaves = [e.detach().float().requires_grad_() for e in embs]
        clip_loss(*leaves, scale)[0].backward()
        return [x.grad for x in leaves]

    with torch.no_grad():
        gc_emb = [torch.cat([encode_batch(model, rows(b, i))["embedding"] for i in range(n)]) for b in (sq, sd)]
        std_emb = [encode_batch(model, b)["embedding"] for b in (sq, sd)]
    gc_cot, std_cot = cotangents(gc_emb), cotangents(std_emb)

    def grads():
        out = {name: p.grad.float().clone() for name, p in model.named_parameters() if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return out

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    reading = {}
    for t, (tower, b) in enumerate((("query", sq), ("document", sd))):
        model.zero_grad(set_to_none=True)
        std_out = encode_batch(model, b)["embedding"]
        for i in range(n):
            sl = slice(i * MOE_CHUNK, (i + 1) * MOE_CHUNK)
            (std_out[sl] * std_cot[t][sl].to(std_out.dtype)).sum().backward(retain_graph=i + 1 < n)
            g_std = grads()
            out = encode_batch(model, rows(b, i))["embedding"]
            (out * gc_cot[t][sl].to(out.dtype)).sum().backward()
            g_gc = grads()
            reading[f"{tower}_chunk{i}"] = dict(
                embedding_rel_l2=rel(gc_emb[t][sl], std_emb[t][sl]), cotangent_rel_l2=rel(gc_cot[t][sl],
                                                                                         std_cot[t][sl]),
                gradient=compare_grads(g_gc, g_std), gradient_by_layer=per_group_rel_l2(g_gc, g_std))
            del g_std, g_gc, out
        del std_out
        gc.collect()
        torch.cuda.empty_cache()
    del model, scale
    gc.collect()
    torch.cuda.empty_cache()
    return reading


def moe_grad_agreement(dev):
    """Phase moe_train_grad_agreement."""
    import gc

    import torch

    # at 64 pairs, router aux 0: grad cache against the standard step, the
    # kernels against sdpa with the plain grouped matmul, and a planted tgmm
    # fault that the bounds must reject. The sdpa run replays the kernel
    # run's expert choices (shared_routing), so the two differ only in
    # arithmetic; the same comparison with each run routing on its own is
    # bounded apart, at three data seeds, beside its two halves (the gmm
    # kernels alone, flash on both sides; the attention alone, the plain
    # grouped matmul on both sides), with the tokens each switch reroutes.
    # The grad-cache run and the standard step each route on their own; the
    # tokens they route differently are counted, and a third reading has the
    # standard step replay the grad-cache run's choices (read, not bounded).
    sq, sd = token_batches(64, dev, seed=1)
    grads, kernel_choices, std_choices, gc_in_std_order = {}, [], [], []
    runs = (  # label, attention, grad cache, what the run is given
        ("gc", "flash", True, lambda: shared_routing(kernel_choices, replay=False)),
        ("std", "flash", False, lambda: shared_routing(std_choices, replay=False)),
        ("std_shared", "flash", False, lambda: shared_routing(list(gc_in_std_order), replay=True)),
        ("sdpa_plain", "sdpa", True, lambda: shared_routing(list(kernel_choices), replay=True)),
        ("tgmm_roll", "flash", True, lambda: planted_fault("tgmm_roll")),
    )
    for label, impl, grad_cache, ctx in runs:
        plain = plain_grouped_matmul() if impl == "sdpa" else contextlib.nullcontext()
        with ctx(), plain:
            grads[label] = step_grads(impl, grad_cache, dev, sq, sd, moe=True)
        if label == "gc":
            gc_in_std_order = standard_order(kernel_choices, 64 // MOE_CHUNK)
        gc.collect()
        torch.cuda.empty_cache()
    # the margin's reading by layer, router aux off (the runs above) and on
    # (the benchmark's 0.001: grad cache sums one aux per chunk, the standard
    # step one per tower), and by chunk (read, not bounded)
    by_layer = dict(aux_0=per_group_rel_l2(grads["gc"], grads["std"]))
    aux_grads = {}
    for label, grad_cache in (("gc", True), ("std", False)):
        aux_grads[label] = step_grads("flash", grad_cache, dev, sq, sd, moe=True, router_aux_coef=MOE_AUX)
        gc.collect()
        torch.cuda.empty_cache()
    by_layer[f"aux_{MOE_AUX:g}"] = dict(per_group_rel_l2(aux_grads["gc"], aux_grads["std"]),
                                        whole=compare_grads(aux_grads["gc"], aux_grads["std"]))
    # the same pair computed in fp32 (sdpa and the plain grouped matmul: the
    # kernels take bf16), aux off: a bf16 weight gradient is rounded once per
    # chunk in grad cache and once per batch in the standard step
    with plain_grouped_matmul():
        for label, grad_cache in (("gc", True), ("std", False)):
            aux_grads[label] = step_grads("sdpa", grad_cache, dev, sq, sd, moe=True, dtype=torch.float32)
            gc.collect()
            torch.cuda.empty_cache()
    by_layer["aux_0_fp32_compute"] = dict(per_group_rel_l2(aux_grads["gc"], aux_grads["std"]),
                                          whole=compare_grads(aux_grads["gc"], aux_grads["std"]))
    del aux_grads
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase="moe_grad_margin_reading", pairs=64, chunk=MOE_CHUNK, gc_vs_standard_by_layer=by_layer,
         gc_vs_standard_by_chunk=moe_chunk_reading(dev, sq, sd),
         note="relative L2 of the grad-cache step's gradients against the standard step's, by layer (each "
              "routing on its own), with the router aux off and on, and aux off with fp32 compute; by chunk: the chunk's pass-1 embeddings, "
              "its cotangent and the gradient it contributes against the standard step's for the same rows "
              "(aux off); read, not bounded")
    bounds = dict(gc_vs_std_min_cosine=0.9999, gc_vs_std_max_rel_l2=0.01, kernels_vs_plain_min_cosine=0.999,
                  own_routing_min_cosine=0.995)
    flipped, routed = differing_choices(gc_in_std_order, std_choices)
    gc_vs_std = dict(compare_grads(grads["gc"], grads["std"]), tokens_routed=routed,
                     tokens_routed_differently=flipped)
    gc_vs_std_shared = compare_grads(grads["gc"], grads["std_shared"])
    kernels_vs_plain = compare_grads(grads["gc"], grads["sdpa_plain"])
    fault = compare_grads(grads["tgmm_roll"], grads["sdpa_plain"])
    del grads
    gc.collect()
    torch.cuda.empty_cache()

    own_routing = {}
    for seed in (1, 2, 3):
        wq, wd = token_batches(64, dev, seed=seed)
        wg, choices = {}, {}
        for label, impl, plain in (("kernels", "flash", False), ("flash_plain_gmm", "flash", True),
                                   ("sdpa_plain_gmm", "sdpa", True)):
            choices[label] = []
            with shared_routing(choices[label], replay=False), \
                    plain_grouped_matmul() if plain else contextlib.nullcontext():
                wg[label] = step_grads(impl, True, dev, wq, wd, moe=True)
            gc.collect()
            torch.cuda.empty_cache()
        reading = {}
        for name, a, b in (("kernels_vs_sdpa_plain_gmm", "kernels", "sdpa_plain_gmm"),
                           ("gmm_kernels_alone", "kernels", "flash_plain_gmm"),
                           ("attention_alone", "flash_plain_gmm", "sdpa_plain_gmm")):
            flipped, routed = differing_choices(choices[a], choices[b])
            reading[name] = dict(compare_grads(wg[a], wg[b]), tokens_routed=routed,
                                 tokens_routed_differently=flipped)
        reading["margin"] = reading["kernels_vs_sdpa_plain_gmm"]["min_cosine"] - bounds["own_routing_min_cosine"]
        own_routing[f"seed{seed}"] = reading
        del wg, choices
        gc.collect()
        torch.cuda.empty_cache()

    def within(r, c):
        return r["min_cosine"] >= c

    ok = (within(gc_vs_std, bounds["gc_vs_std_min_cosine"])
          and gc_vs_std["max_rel_l2"] <= bounds["gc_vs_std_max_rel_l2"]
          and within(kernels_vs_plain, bounds["kernels_vs_plain_min_cosine"])
          and all(r["margin"] >= 0 for r in own_routing.values())
          and not within(fault, bounds["own_routing_min_cosine"]))
    emit(phase="moe_train_grad_agreement", pairs=64, chunk=MOE_CHUNK, router_aux_coef=0.0,
         gc_vs_standard=gc_vs_std, gc_vs_standard_shared_routing=gc_vs_std_shared,
         kernels_vs_sdpa_plain_gmm=kernels_vs_plain,
         own_routing=own_routing, planted_fault=dict(tgmm_roll_vs_sdpa_plain_gmm=fault), bounds=bounds,
         note="gc_vs_standard: each step routes on its own (tokens_routed_differently counts the "
              "tokens whose expert pair differs); gc_vs_standard_shared_routing: the standard step "
              "replays the grad-cache run's choices (read, not bounded); "
              "kernels_vs_sdpa_plain_gmm replays the kernel run's expert choices; own_routing: each run "
              "routes on its own (kernels_vs_sdpa_plain_gmm bounded by own_routing_min_cosine; its halves "
              "read, not bounded); tokens counted once per MoE layer when valid", ok=ok)
    if not ok:
        raise AssertionError("MoE train step gradients: a sound step is outside its bounds, "
                             "or the planted fault is inside them")


def gmm_bound(kernel, rows, P, K, N, nonempty, E=8):
    """Least time on this card: 2*K*N FLOP per active (padded) row, against
    the bf16 bytes each kernel must move once. gmm reads the active rows of
    lhs and the panels of the experts that own rows, and writes all P rows
    of out (inactive blocks as 0); tgmm reads the active rows of lhs and
    dout and writes all E panels (an empty expert's as 0)."""
    flops = 2.0 * rows * K * N
    if kernel == "gmm":
        nbytes = 2 * (rows * K + nonempty * K * N + P * N)
    else:
        nbytes = 2 * (rows * (K + N) + E * K * N)
    return _bound(flops, nbytes)


def library_grouped_mm(kernel, lhs, rhs_or_dout, gs):
    """(callable, label): torch._grouped_mm on the same layout where the
    installed torch has it and it takes these operands, else a per-expert
    torch.matmul loop over the groups. A yardstick only."""
    import torch

    offs = torch.cumsum(gs, 0).to(torch.int32)
    if hasattr(torch, "_grouped_mm"):
        try:
            if kernel == "gmm":
                fn = lambda: torch._grouped_mm(lhs, rhs_or_dout, offs=offs)  # noqa: E731
            else:
                fn = lambda: torch._grouped_mm(lhs.t(), rhs_or_dout, offs=offs)  # noqa: E731
            fn()
            torch.cuda.synchronize()
            return fn, "torch._grouped_mm"
        except (RuntimeError, TypeError) as e:
            label = f"per-expert torch.matmul loop (torch._grouped_mm refused: {str(e).splitlines()[0][:120]})"
    else:
        label = "per-expert torch.matmul loop (no torch._grouped_mm)"
    ends = offs.tolist()
    starts = [0] + ends[:-1]
    groups = [(e, a, b) for e, (a, b) in enumerate(zip(starts, ends)) if b > a]
    if kernel == "gmm":
        def loop():
            out = torch.zeros(lhs.shape[0], rhs_or_dout.shape[2], dtype=lhs.dtype, device=lhs.device)
            for e, a, b in groups:
                out[a:b] = lhs[a:b] @ rhs_or_dout[e]
            return out
    else:
        def loop():
            out = torch.zeros(gs.shape[0], lhs.shape[1], rhs_or_dout.shape[1], dtype=lhs.dtype, device=lhs.device)
            for e, a, b in groups:
                out[e] = lhs[a:b].t() @ rhs_or_dout[a:b]
            return out
    return loop, label


def host_enqueue_us(fn, n=50):
    """Host microseconds per call of fn over n calls queued back to back:
    the wrapper's checks, its tensor maps and the launch; then a sync."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def moe_kernels(dev, card):
    """Phases kernel_check_gmm and moe_kernel_timing, per layout and (K, N):
    gmm (the forward), dlhs (gmm on the rhs.transpose(1, 2) view, as the
    backward runs it) and tgmm against their plain versions, per element,
    padding rows and the empty expert exactly 0; then each kernel's time
    (ms, and device_ms without the host's enqueue) beside its bound, its
    plain version, the library's (both ways) and the host's enqueue per
    call of each. Returns ({kernel: max abs error},
    {(kernel, layout, K, N): row})."""
    import torch

    from contrastors_tpu_torch.ops import grouped_matmul as gm

    errs, rows_out = {"gmm": 0.0, "tgmm": 0.0}, {}
    for layout, A in MOE_LAYOUTS:
        gs, P, pad, blk_e, act = moe_layout(dev, A, seed=1)
        active_rows, nonempty = int(gs.sum()), int((gs > 0).sum())
        for K, N in ((768, 3072), (3072, 768)):
            lhs, rhs, dout = gmm_operands(dev, P, K, N, pad, seed=K + 1)
            rhs_t = rhs.transpose(1, 2)
            kernels = {  # name: (kernel, plain, the library's (kind, operands), the bound's (K, N))
                "gmm": (lambda: gm.launch_gmm(lhs, rhs, blk_e, act),
                        lambda: gm._gmm_plain(lhs, rhs, blk_e, act, 128), ("gmm", lhs, rhs), (K, N)),
                "dlhs": (lambda: gm.launch_gmm(dout, rhs_t, blk_e, act),
                         lambda: gm._gmm_plain(dout, rhs_t, blk_e, act, 128), ("gmm", dout, rhs_t), (N, K)),
            }
            if layout != "encode":  # serving runs no backward
                kernels["tgmm"] = (lambda: gm.launch_tgmm(lhs, dout, gs),
                                   lambda: gm.tgmm_reference(lhs, dout, gs, 128), ("tgmm", lhs, dout), (K, N))
            line, ok = {}, True
            for name, (run, plain, _, _) in kernels.items():
                out, ref = run(), plain()
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                ratio = gm.error_ratio(out, ref)
                zero = bool((out[2] == 0).all()) if name == "tgmm" else bool((out[pad] == 0).all())
                key = "tgmm" if name == "tgmm" else "gmm"
                errs[key] = max(errs[key], err)
                line[name] = dict(max_abs_err=err, ref_abs_max=ref.float().abs().max().item(),
                                  err_over_tol=ratio, padding_exactly_zero=zero)
                ok = ok and ratio <= 1.0 and zero and bool(torch.isfinite(out.float()).all())
                del out, ref
            emit(phase="kernel_check_gmm", layout=layout, assignments=A, P=P, K=K, N=N,
                 group_sizes=gs.tolist(), active_blocks=int(act.sum()), blocks=P // 128, **line,
                 tol=f"{gm.REL:g}*|ref| + {gm.ABS_FRAC:g}*max|ref|", ok=ok)
            if not ok:
                raise AssertionError(f"grouped-matmul kernels disagree with their plain versions ({layout} K={K} N={N})")
            for name, (run, plain, (kind, a, b), (bK, bN)) in kernels.items():
                ms, device_ms, enqueue_us = median_ms(run), median_ms(run, queued=True), host_enqueue_us(run)
                plain_ms = median_ms(plain, runs=3, warmup=1)
                lib_fn, lib_label = library_grouped_mm(kind, a, b, gs)
                library_ms, library_device_ms = median_ms(lib_fn, runs=5, warmup=2), median_ms(lib_fn, queued=True)
                b_ms, b_by, flops, nbytes = gmm_bound(kind, active_rows, P, bK, bN, nonempty)
                row = dict(ms=ms, device_ms=device_ms, enqueue_us=enqueue_us, plain_ms=plain_ms,
                           library_ms=library_ms, library_device_ms=library_device_ms,
                           library_enqueue_us=host_enqueue_us(lib_fn), library=lib_label,
                           bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
                           tflops=flops / ms / 1e9, roofline_share=b_ms / ms, device_roofline_share=b_ms / device_ms,
                           err_over_tol=line[name]["err_over_tol"])
                rows_out[(name, layout, K, N)] = row
                emit(phase="moe_kernel_timing", card=card, gpu_state=gpu_state(), kernel=name, layout=layout,
                     assignments=A, P=P, active_rows=active_rows, nonempty_experts=nonempty, K=K, N=N, **row)
            del lhs, rhs, rhs_t, dout, kernels
            torch.cuda.empty_cache()
    return errs, rows_out


# The flash kernels' check cases: (name, shape, options). mask=(full, empty)
# gives random lengths with `full` rows whole and `empty` rows fully masked.
BASE_CASES = [
    ("pad_b8_s512_empty_row", dict(B=8, S=512, T=512, H=12, Hkv=12, D=64), dict(mask=(1, 1))),
    ("pad_b256_s512", dict(B=256, S=512, T=512, H=12, Hkv=12, D=64), dict(mask=(1, 0))),
    ("s16", dict(B=4, S=16, T=16, H=12, Hkv=12, D=64), dict(mask=(1, 0))),
    ("s32", dict(B=4, S=32, T=32, H=12, Hkv=12, D=64), dict(mask=(1, 0))),
    ("s200", dict(B=4, S=200, T=200, H=12, Hkv=12, D=64), dict(mask=(1, 0))),
    ("s256", dict(B=4, S=256, T=256, H=12, Hkv=12, D=64), dict(mask=(1, 0))),
    ("s4096", dict(B=1, S=4096, T=4096, H=12, Hkv=12, D=64), dict(mask=(1, 0))),
    ("s8192", dict(B=1, S=8192, T=8192, H=12, Hkv=12, D=64), dict()),
    ("causal_s200_t700", dict(B=2, S=200, T=700, H=12, Hkv=12, D=64), dict(causal=True)),
    ("window128_s1000", dict(B=2, S=1000, T=1000, H=12, Hkv=12, D=64), dict(window=128)),
    ("segments_s512", dict(B=2, S=512, T=512, H=12, Hkv=12, D=64), dict(segments=True)),
    ("gqa_hkv4_s512", dict(B=2, S=512, T=512, H=12, Hkv=4, D=64), dict(mask=(1, 0))),
    ("d128_s384", dict(B=2, S=384, T=384, H=8, Hkv=8, D=128), dict(mask=(1, 0))),
    # the training step's shapes: the direct query tower and a document chunk
    ("train_q_b512_s32", dict(B=512, S=32, T=32, H=12, Hkv=12, D=64), dict(mask=(512, 0))),
    ("train_d_b16_s256", dict(B=16, S=256, T=256, H=12, Hkv=12, D=64), dict(mask=(16, 0))),
]
# the edges of the kernels' persistent walk: one row, partial last tiles
# (65, 129; the items are 128 rows, but 64 for the backward at D = 128 and
# for every kernel at D = 64 when the rows are at most 64), B * H = 143 items
# (not a multiple of the 132 SMs), GQA at the MLM length
EDGE_CASES = [
    ("s1", dict(B=4, S=1, T=1, H=12, Hkv=12, D=64), dict(mask=(4, 0))),
    ("s65", dict(B=3, S=65, T=65, H=12, Hkv=12, D=64), dict(mask=(1, 0))),
    ("s129_gqa", dict(B=3, S=129, T=129, H=12, Hkv=4, D=64), dict(mask=(1, 0))),
    ("d128_s129", dict(B=2, S=129, T=129, H=8, Hkv=8, D=128), dict(mask=(1, 0))),
    ("bh143_s96", dict(B=11, S=96, T=96, H=13, Hkv=13, D=64), dict(mask=(1, 0))),
    ("gqa_hkv4_s2048", dict(B=1, S=2048, T=2048, H=12, Hkv=4, D=64), dict(mask=(1, 0))),
]
# the GLUE eval batch (64 x 128, padded sentences) as attention_core hands it
# to the kernel below kv 512: every query row live, the mask as kv ids
GLUE_CASES = [
    ("glue_pad_b64_s128", dict(B=64, S=128, T=128, H=12, Hkv=12, D=64), dict(mask=(0, 0), dispatch=True)),
]
# the ViT's self-attention (phase 19): no mask, S = T = 197 (196 patches and
# the cls token), a partial last tile; the vision step's image chunk of 64
VIT_CASES = [
    ("vit_b64_s197", dict(B=64, S=197, T=197, H=12, Hkv=12, D=64), dict()),
]
# the families phase's attention (phase 20): ModernBERT-base's windowed
# layers (window 128, i.e. +-64 keys) with a padding mask at the finetune
# recipe's 512 tokens, and pythia-160m's causal band with a padding mask at
# 128 tokens, below kv 512 in the dispatch's form (query ids 1, the mask as
# kv ids)
FAMILY_CASES = [
    ("modernbert_window128_pad_b32_s512", dict(B=32, S=512, T=512, H=12, Hkv=12, D=64),
     dict(window=128, mask=(1, 0))),
    ("pythia_causal_pad_b128_s128", dict(B=128, S=128, T=128, H=12, Hkv=12, D=64),
     dict(causal=True, mask=(1, 0), dispatch=True)),
]
# the same two bands at the batches the families phase launches them with,
# since the kernels walk a persistent grid: ModernBERT's query tower (8),
# documents (64) and serving batch (256); pythia's queries (64), documents
# (512) and serving batch (256). The serving batches run no backward
FAMILY_PATH_CASES = [
    (f"modernbert_window128_pad_b{B}_s512", dict(B=B, S=512, T=512, H=12, Hkv=12, D=64),
     dict(window=128, mask=(1, 0))) for B in (8, 64, 256)
] + [
    (f"pythia_causal_pad_b{B}_s128", dict(B=B, S=128, T=128, H=12, Hkv=12, D=64),
     dict(causal=True, mask=(1, 0), dispatch=True)) for B in (64, 512, 256)
]
FAMILY_SERVING = ("modernbert_window128_pad_b256_s512", "pythia_causal_pad_b256_s128")
FWD_CASES = BASE_CASES + EDGE_CASES + GLUE_CASES + VIT_CASES + FAMILY_CASES + FAMILY_PATH_CASES
# the backward kernels: the same but the two largest and the eval-only batches
BWD_CASES = [c for c in FWD_CASES if c[0] not in ("pad_b256_s512", "s8192", "glue_pad_b64_s128") + FAMILY_SERVING]


def make_qkv(gen, dev, B, S, T, H, Hkv, D):
    """bf16 q, k, v: views of one fused projection when S == T and H == Hkv,
    as the model gives them."""
    import torch

    if S == T and H == Hkv:
        x = torch.randn(B, S, 3, H, D, generator=gen, device=dev).bfloat16()
        return x[:, :, 0], x[:, :, 1], x[:, :, 2]
    return tuple(torch.randn(B, L, h, D, generator=gen, device=dev).bfloat16()
                 for L, h in ((S, H), (T, Hkv), (T, Hkv)))


def case_inputs(gen, dev, shp, opt):
    """q, k, v and the keyword arguments of one FWD_CASES / BWD_CASES case."""
    import torch

    q, k, v = make_qkv(gen, dev, *(shp[n] for n in ("B", "S", "T", "H", "Hkv", "D")))
    kw = dict(causal=opt.get("causal", False), window=opt.get("window", 0))
    if "mask" in opt:
        B, T = shp["B"], shp["T"]
        full_rows, empty_rows = opt["mask"]
        lens = torch.randint(1, T + 1, (B,), generator=gen, device=dev)
        lens[:full_rows] = T
        if empty_rows:
            lens[B - empty_rows:] = 0
        kw["attention_mask"] = (torch.arange(T, device=dev)[None] < lens[:, None]).int()
    if opt.get("dispatch"):
        kw["segment_ids"] = torch.ones(shp["B"], shp["S"], dtype=torch.int32, device=dev)
        kw["kv_segment_ids"] = kw.pop("attention_mask")
    if opt.get("segments"):
        seg = torch.zeros(shp["B"], shp["S"], dtype=torch.int32, device=dev)
        seg[:, :100], seg[:, 100:300], seg[:, 300:450] = 1, 2, 3  # 450.. is padding
        kw["segment_ids"] = seg
    return q, k, v, kw


def forward_checks(dev, gen, cases=None):
    """Phase kernel_check: the forward kernel against its plain version in
    `cases` (default FWD_CASES), a second run bit-identical to the first.
    Returns {case: max abs error of O}."""
    import torch

    from contrastors_tpu_torch.ops import flash_attention as fa

    o_errs = {}
    for name, shp, opt in cases or FWD_CASES:
        q, k, v, kw = case_inputs(gen, dev, shp, opt)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        again = fa.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        o_err = (out.float() - ref_out.float()).abs().max().item()
        o_ratio = fa.output_error_ratio(out, ref_out)
        lse_err = (lse - ref_lse).abs().max().item()
        deterministic = bool(torch.equal(out, again[0])) and bool(torch.equal(lse, again[1]))
        ok = (o_ratio <= 1.0 and lse_err <= fa.LSE_ATOL and bool(torch.isfinite(out.float()).all())
              and deterministic)
        if name.endswith("empty_row"):
            ok = ok and bool((out[-1] == 0).all()) and bool((lse[-1] == fa.NEG_INF).all())
        o_errs[name] = o_err
        emit(phase="kernel_check", case=name, **shp, o_max_abs_err=o_err,
             o_ref_abs_max=ref_out.float().abs().max().item(),
             o_ref_abs_mean=ref_out.float().abs().mean().item(),
             o_tol=f"{fa.O_REL:g}*|ref| + {fa.O_ABS_FRAC:g}*max|ref|", o_err_over_tol=o_ratio,
             lse_max_abs_err=lse_err, lse_tol=fa.LSE_ATOL, deterministic=deterministic, ok=ok)
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain version, or is not deterministic, "
                                 f"in case {name}")
        del q, k, v, out, lse, again, ref_out, ref_lse
    torch.cuda.empty_cache()
    return o_errs


def grad_check(grad, ref, name, dv_ref, single_key):
    """(max abs error, error over tolerance) of one backward output: the
    per-element rule (`grad_error_ratio`), except for dq and dk with a
    single key, where p = 1 makes ds = dp - delta zero in exact arithmetic
    and both sides hold rounding noise: there |grad| <= 2^-8 * max |dv|."""
    from contrastors_tpu_torch.ops import flash_attention as fa

    err = (grad.float() - ref.float()).abs().max().item()
    if single_key and name != "dv":
        return err, grad.float().abs().max().item() / (2.0**-8 * dv_ref.float().abs().max().item())
    return err, fa.grad_error_ratio(grad, ref, name)


def backward_checks(dev, gen, cases=None):
    """Phase kernel_check_bwd: the two backward kernels (dq; dk/dv) against
    the plain backward on the same O and LSE, with a strided dO, in `cases`
    (default BWD_CASES); dq exactly 0 on a fully masked row; a second run
    bit-identical to the first. Returns {"dq"|"dk"|"dv": {case: max abs
    error}}."""
    import torch

    from contrastors_tpu_torch.ops import flash_attention as fa

    grad_errs = {"dq": {}, "dk": {}, "dv": {}}
    for name, shp, opt in cases or BWD_CASES:
        q, k, v, kw = case_inputs(gen, dev, shp, opt)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        # a strided dO, as a view of a wider buffer
        dout = torch.randn(*out.shape[:3], out.shape[3] + 8, generator=gen, device=dev).bfloat16()
        dout = dout[..., : out.shape[3]]
        grads = fa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
        again = fa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        refs = fa.flash_attention_backward_reference(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        line = dict(deterministic=all(bool(torch.equal(a, b)) for a, b in zip(grads, again)))
        ok = line["deterministic"]
        for g, r, gname in zip(grads, refs, ("dq", "dk", "dv")):
            err, ratio = grad_check(g, r, gname, refs[2], shp["T"] == 1)
            grad_errs[gname][name] = err
            line.update({f"{gname}_max_abs_err": err, f"{gname}_ref_abs_max": r.float().abs().max().item(),
                         f"{gname}_err_over_tol": ratio})
            ok = ok and ratio <= 1.0 and bool(torch.isfinite(g.float()).all())
        if name.endswith("empty_row"):
            line["dq_empty_row_zero"] = bool((grads[0][-1] == 0).all())
            ok = ok and line["dq_empty_row_zero"]
        emit(phase="kernel_check_bwd", case=name, **shp, **line,
             tol={n: f"{fa.GRAD_REL:g}*|ref| + {fa.GRAD_ABS_FRAC[n]:g}*max|ref|" for n in grad_errs},
             ok=ok)
        if not ok:
            raise AssertionError(f"flash backward kernels disagree with their plain version, or are not "
                                 f"deterministic, in case {name}")
        del q, k, v, out, lse, dout, grads, again, refs
    torch.cuda.empty_cache()
    return grad_errs


# attention_core(impl="flash") with a mask only below kv 512, where a batch
# row with no valid key takes SDPA's mean(v) and its gradient: the dense
# step's document chunk, and GQA with fused rotary
DEAD_ROW_CASES = [
    ("doc_b16_s256", dict(B=16, S=256, H=12, Hkv=12, D=64), False),
    ("gqa_rot_b4_s256", dict(B=4, S=256, H=12, Hkv=4, D=64), True),
]


def dead_row_check(dev, gen):
    """Phase dead_row_check: attention_core(impl="flash") on the card, bf16,
    with the last batch row's mask all 0, output and q/k/v gradients against
    attention_core(impl="sdpa") in fp32 on the same values. In the dead row
    (batch rows are independent, so all of its dq, dk and dv come from the
    uniform softmax, which the kernels compute on the row's scaled k) each
    tensor's max |err| must stay within 2^-6 max |ref| and its relative L2
    error within 2^-7; in the live rows, cosine >= 0.9999 (bf16 kernels
    against fp32 SDPA)."""
    import torch

    from contrastors_tpu_torch.layers.rotary import rotary_cos_sin
    from contrastors_tpu_torch.ops import attention_core

    for name, shp, rotary in DEAD_ROW_CASES:
        B, S, H, Hkv, D = (shp[n] for n in ("B", "S", "H", "Hkv", "D"))
        q, k, v, kw = case_inputs(gen, dev, dict(shp, T=S), dict(mask=(1, 1)))
        if rotary:
            kw["rotary_cos"], kw["rotary_sin"] = rotary_cos_sin(S, D, device=dev)
        dout = torch.randn(q.shape, generator=gen, device=dev)
        runs = {}
        for impl, dtype in (("flash", torch.bfloat16), ("sdpa", torch.float32)):
            leaves = [x.detach().to(dtype).requires_grad_() for x in (q, k, v)]
            out = attention_core(*leaves, impl=impl, **kw)
            out.backward(dout.to(dtype))
            runs[impl] = [out.detach()] + [x.grad for x in leaves]
        torch.cuda.synchronize()
        line, ok = {}, True
        for tname, got, ref in zip(("out", "dq", "dk", "dv"), runs["flash"], runs["sdpa"]):
            got, ref = got.double(), ref.double()
            err, dead = (got[-1] - ref[-1]).abs(), ref[-1].abs()
            cos = torch.nn.functional.cosine_similarity(got[:-1].flatten(), ref[:-1].flatten(), dim=0).item()
            line[tname] = dict(dead_max_err_over_max_ref=(err.max() / dead.max()).item(),
                               dead_rel_l2=(err.norm() / dead.norm()).item(), live_cosine=cos)
            ok = (ok and line[tname]["dead_max_err_over_max_ref"] <= 2**-6 and line[tname]["dead_rel_l2"] <= 2**-7
                  and cos >= 0.9999 and bool(torch.isfinite(got).all()))
        emit(phase="dead_row_check", case=name, **shp, rotary=rotary, **line,
             bounds=dict(dead_max_err_over_max_ref=2**-6, dead_rel_l2=2**-7, live_min_cosine=0.9999), ok=ok)
        if not ok:
            raise AssertionError(f"attention_core(impl='flash') disagrees with sdpa on a batch row "
                                 f"with no valid key, or on the live rows, in case {name}")
        del q, k, v, dout, runs
    torch.cuda.empty_cache()


# The fused-rotary kernels' check cases: (name, shape, options). The MLM
# step's shape; an encode batch with padding; packed rows (three segments
# per row, positions restarting at each: per-batch tables); interleaved
# rotary over 32 of 64 features; GQA; a length off the 64-row tile; D=128.
FUSED_CASES = [
    ("mlm_b8_s2048", dict(B=8, S=2048, H=12, Hkv=12, D=64), dict()),
    ("encode_b256_s512_pad", dict(B=256, S=512, H=12, Hkv=12, D=64), dict(mask=True)),
    ("packed_b4_s2048_3seg", dict(B=4, S=2048, H=12, Hkv=12, D=64), dict(packed=True)),
    ("interleaved_rot32_s512", dict(B=2, S=512, H=12, Hkv=12, D=64), dict(rot_dim=32, interleaved=True, mask=True)),
    ("gqa_hkv4_s512", dict(B=2, S=512, H=12, Hkv=4, D=64), dict(mask=True)),
    ("unaligned_s300", dict(B=4, S=300, H=12, Hkv=12, D=64), dict(mask=True)),
    ("d128_s384", dict(B=2, S=384, H=8, Hkv=8, D=128), dict(mask=True)),
    # the edges of the kernels' persistent walk, as in EDGE_CASES
    ("s1", dict(B=4, S=1, H=12, Hkv=12, D=64), dict()),
    ("s65", dict(B=3, S=65, H=12, Hkv=12, D=64), dict(mask=True)),
    ("s129_gqa", dict(B=3, S=129, H=12, Hkv=4, D=64), dict(mask=True)),
    ("d128_s129", dict(B=2, S=129, H=8, Hkv=8, D=128), dict(mask=True)),
    ("bh143_s96", dict(B=11, S=96, H=13, Hkv=13, D=64), dict(mask=True)),
    ("gqa_hkv4_s2048", dict(B=1, S=2048, H=12, Hkv=4, D=64), dict()),
]


def rotary_case(dev, gen, B, S, H, Hkv, D, rot_dim=None, interleaved=False, mask=False, packed=False):
    """bf16 q, k, v (views of one fused projection when H == Hkv, as the
    model gives them) and the rotary keyword arguments of one case, with
    nomic-bert's rotary base 1000."""
    import torch

    from contrastors_tpu_torch.layers.rotary import rotary_cos_sin

    if H == Hkv:
        x = torch.randn(B, S, 3, H, D, generator=gen, device=dev).bfloat16()
        q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    else:
        q, k, v = (torch.randn(B, S, h, D, generator=gen, device=dev).bfloat16() for h in (H, Hkv, Hkv))
    cos, sin = rotary_cos_sin(S, rot_dim or D, base=1000.0, device=dev)
    kw = dict(rotary_cos=cos, rotary_sin=sin, rotary_interleaved=interleaved)
    idx = torch.arange(S, device=dev)
    if mask:  # random lengths, the first row full
        lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
        lens[0] = S
        kw["attention_mask"] = (idx[None] < lens[:, None]).int()
    if packed:  # three segments per row at random cuts, positions restarting at each
        cuts = torch.sort(torch.randint(1, S, (B, 2), generator=gen, device=dev), dim=1).values
        seg = (idx[None] >= cuts[:, :1]).int() + (idx[None] >= cuts[:, 1:]).int()
        start = torch.where(seg == 0, 0, torch.where(seg == 1, cuts[:, :1], cuts[:, 1:]))
        kw["segment_ids"] = (seg + 1).contiguous()
        kw["rotary_position_ids"] = (idx[None] - start).contiguous()
    return q, k, v, kw


def fused_kernel_checks(dev, gen, backward=True):
    """Phase fused_kernel_check: the fused-rotary forward, dq and dk/dv
    kernels against their plain versions in FUSED_CASES, with a strided dO,
    a second forward and backward bit-identical to the first; at the MLM
    shape the backward kernels given negated sin tables must fall outside the
    rule. backward=False checks the forward alone. Returns {"fwd"|"dq"|"dk"|"dv":
    max abs error}."""
    import torch

    from contrastors_tpu_torch.ops import flash_attention as fa

    errs = dict(fwd=0.0, dq=0.0, dk=0.0, dv=0.0) if backward else dict(fwd=0.0)
    for name, shp, opt in FUSED_CASES:
        q, k, v, kw = rotary_case(dev, gen, **shp, **opt)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        out2, lse2 = fa.flash_attention_fwd(q, k, v, **kw)
        grads = again = refs = ()
        if backward:
            dout = torch.randn(*out.shape[:3], out.shape[3] + 8, generator=gen, device=dev).bfloat16()
            dout = dout[..., : out.shape[3]]
            grads = fa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
            again = fa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
        if backward:
            refs = fa.flash_attention_backward_reference(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        line = dict(o_max_abs_err=(out.float() - ref_out.float()).abs().max().item(),
                    o_err_over_tol=fa.output_error_ratio(out, ref_out),
                    lse_max_abs_err=(lse - ref_lse).abs().max().item(),
                    deterministic=(bool(torch.equal(out, out2)) and bool(torch.equal(lse, lse2))
                                   and all(bool(torch.equal(a, b)) for a, b in zip(grads, again))))
        ok = (line["o_err_over_tol"] <= 1.0 and line["lse_max_abs_err"] <= fa.LSE_ATOL
              and bool(torch.isfinite(out.float()).all()) and line["deterministic"])
        errs["fwd"] = max(errs["fwd"], line["o_max_abs_err"])
        for g, r, gname in zip(grads, refs, ("dq", "dk", "dv")):
            err, ratio = grad_check(g, r, gname, refs[2], shp["S"] == 1)
            errs[gname] = max(errs[gname], err)
            line[f"{gname}_max_abs_err"], line[f"{gname}_err_over_tol"] = err, ratio
            ok = ok and line[f"{gname}_err_over_tol"] <= 1.0 and bool(torch.isfinite(g.float()).all())
        if backward and name == "mlm_b8_s2048":
            with planted_fault("negated_sin"):
                bad = fa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
            line["negated_sin_err_over_tol"] = {gname: fa.grad_error_ratio(g, r, gname)
                                                for g, r, gname in zip(bad, refs, ("dq", "dk", "dv"))}
            ok = ok and min(line["negated_sin_err_over_tol"][g] for g in ("dq", "dk")) > 1.0
            del bad
        emit(phase="fused_kernel_check", case=name, **shp, rot_dim=opt.get("rot_dim", shp["D"]),
             interleaved=opt.get("interleaved", False), tables="per batch row" if opt.get("packed") else "shared",
             backward=backward, **line, ok=ok)
        if not ok:
            raise AssertionError(f"fused-rotary kernels disagree with their plain versions in case {name}, "
                                 "or are not deterministic, or the planted fault is inside the bound")
        del q, k, v, kw, out, lse, out2, lse2, grads, again, ref_out, ref_lse, refs
    torch.cuda.empty_cache()
    return errs


def fused_kernel_timing(dev, card, gen):
    """Phase fused_kernel_timing at the MLM shape (B=8 S=T=2048 H=12 D=64,
    NeoX over the whole head, tables shared by the batch): each fused kernel
    alone beside its bound (the flash FLOP; bytes plus the two fp32 tables),
    the unfused kernel on pre-rotated q/k, the plain versions, and the
    nearest library composite (no one PyTorch call computes fused-rotary
    attention): SDPA on pre-rotated q/k plus apply_rotary on q and k (their
    autograd backward for dq, dk/dv)."""
    import torch
    import torch.nn.functional as F

    from contrastors_tpu_torch.layers.rotary import apply_rotary, expanded_tables
    from contrastors_tpu_torch.ops import flash_attention as fa

    B, S, H, D = MLM_B, MLM_S, 12, 64
    q, k, v, kw = rotary_case(dev, gen, B, S, H, H, D)
    cos, sin = kw["rotary_cos"], kw["rotary_sin"]
    cos_d, sin_d = expanded_tables(cos, sin, D, False, S, pad_to=fa.KERNEL_TILE)
    rot = fa.RotaryTables(cos_d, sin_d, D, False)
    qr, kr = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
    args = (False, 0, 0, 1.0 / D**0.5)
    out, lse = fa._launch_kernel(q, k, v, None, None, rot, *args)
    dout = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()
    inputs = fa.prepare_backward(q, k, v, out, lse, dout, None, None)
    inputs_r = fa.prepare_backward(qr, kr, v, out, lse, dout, None, None)
    ms = dict(
        fwd=median_ms(lambda: fa._launch_kernel(q, k, v, None, None, rot, *args)),
        dq=median_ms(lambda: fa.launch_bwd_dq(*inputs, *args, rot=rot)),
        dkv=median_ms(lambda: fa.launch_bwd_dkv(*inputs, *args, rot=rot)),
    )
    unfused_ms = dict(
        fwd=median_ms(lambda: fa._launch_kernel(qr, kr, v, None, None, None, *args)),
        dq=median_ms(lambda: fa.launch_bwd_dq(*inputs_r, *args)),
        dkv=median_ms(lambda: fa.launch_bwd_dkv(*inputs_r, *args)),
    )
    plain_ms = dict(fwd=median_ms(lambda: fa.flash_attention_reference(q, k, v, **kw), runs=3, warmup=1),
                    bwd=median_ms(lambda: fa.flash_attention_backward_reference(q, k, v, out, lse, dout, **kw),
                                  runs=3, warmup=1))
    qt, kt, vt = (x.transpose(1, 2) for x in (qr, kr, v))
    sdpa_fwd = median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    dot = dout.transpose(1, 2)
    sdpa_bwd = median_ms(lambda: torch.autograd.grad(F.scaled_dot_product_attention(*leaves), leaves, dot)) - sdpa_fwd
    rotary_fwd = median_ms(lambda: (apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)))
    ql, kl = (x.detach().requires_grad_() for x in (q, k))
    rotary_bwd = median_ms(lambda: torch.autograd.grad(
        (apply_rotary(ql, cos, sin), apply_rotary(kl, cos, sin)), (ql, kl), (dout, dout))) - rotary_fwd
    table_bytes = 2 * cos_d.numel() * 4
    rows = {}
    for kname in ("fwd", "dq", "dkv"):
        if kname == "fwd":
            _, _, flops, nbytes = attention_bound(B, S, S, H, H, D)
            plain, composite = plain_ms["fwd"], sdpa_fwd + rotary_fwd
        else:
            _, _, flops, nbytes = backward_bound(kname, B, S, S, H, H, D)
            plain, composite = plain_ms["bwd"], sdpa_bwd + rotary_bwd
        b_ms, b_by, _, nbytes = _bound(flops, nbytes + table_bytes)
        rows[kname] = dict(ms=ms[kname], unfused_ms=unfused_ms[kname], plain_ms=plain, bound_ms=b_ms,
                           bound_by=b_by, flops=flops, bytes=nbytes, tflops=flops / ms[kname] / 1e9,
                           roofline_share=b_ms / ms[kname], library_ms=None, library_composite_ms=composite)
    emit(phase="fused_kernel_timing", card=card, gpu_state=gpu_state(), B=B, S=S, T=S, H=H, D=D, rot_dim=D,
         **rows, sdpa_fwd_ms=sdpa_fwd, sdpa_bwd_ms=sdpa_bwd, rotary_fwd_ms=rotary_fwd, rotary_bwd_ms=rotary_bwd,
         note="ms: each fused kernel alone; unfused_ms: the same kernel on pre-rotated q/k; plain_ms for "
              "dq and dkv is the whole plain backward; library_composite_ms: SDPA on pre-rotated q/k + "
              "apply_rotary on q and k (no single PyTorch call computes fused-rotary attention)")
    del q, k, v, qr, kr, out, lse, dout, inputs, inputs_r, qt, kt, vt, leaves, dot, ql, kl
    torch.cuda.empty_cache()
    return rows


# The forward's timed shapes: the encode batch, a long-context batch, the
# contrastive step's query tower and document chunk, and the MLM step's
# shape, plain and with fused rotary; each with the all-ones attention mask
# that the encoder and the steps pass.
FWD_TIMING_SHAPES = (("b256_s512", 256, 512, False), ("b16_s4096", 16, 4096, False),
                     ("b512_s32", 512, 32, False), ("b16_s256", 16, 256, False),
                     ("mlm_b8_s2048", 8, 2048, False), ("mlm_b8_s2048_fused", 8, 2048, True),
                     ("glue_b64_s128_padded", 64, 128, False))


def glue_lengths(B, S, seed=3):
    """Padded sentence lengths of a GLUE eval batch: 8 to S tokens."""
    return np.random.default_rng(seed).integers(8, S + 1, size=B)


def forward_timing(dev, card, gen):
    """Phase kernel_timing at FWD_TIMING_SHAPES (H=12, D=64): the forward
    through `flash_attention_fwd` (so that trees whose C arguments differ
    are timed alike), checked once more against its plain version, as ms,
    device_ms and the host's enqueue per call, beside its bound, the plain
    version and torch SDPA the same three ways: SDPA without a mask (the
    all-ones mask selects every key), and for the fused shape on q and k
    rotated by apply_rotary inside the timed call (the nearest composite:
    no PyTorch call fuses rotary into attention); at the unfused shapes
    also SDPA with the mask as a boolean attn_mask (`library_masked_ms`,
    the yardstick of earlier runs). The padded GLUE eval batch (64 x
    128, `glue_lengths`) runs as attention_core hands it to the kernel below
    kv 512 (every query row live, the mask as kv ids), against SDPA with the
    mask as a boolean attn_mask (`library_ms`); its bound counts the pairs
    of live keys. Returns {shape: row}."""
    import torch
    import torch.nn.functional as F

    from contrastors_tpu_torch.layers.rotary import apply_rotary, rotary_cos_sin
    from contrastors_tpu_torch.ops import flash_attention as fa

    rows = {}
    for label, B, S, fused in FWD_TIMING_SHAPES:
        H, D = 12, 64
        q, k, v = make_qkv(gen, dev, B, S, S, H, H, D)
        mask = torch.ones(B, S, dtype=torch.int32, device=dev)
        kw = dict(attention_mask=mask)
        b_ms, b_by, flops, nbytes = attention_bound(B, S, S, H, H, D, [S] * B)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        padded = label.endswith("padded")
        if padded:
            lens_host = glue_lengths(B, S)
            lens = torch.from_numpy(lens_host).to(dev)
            mask = (torch.arange(S, device=dev)[None] < lens[:, None]).int()
            kw = dict(segment_ids=torch.ones(B, S, dtype=torch.int32, device=dev), kv_segment_ids=mask)
            live = float(lens_host.sum())
            # every query row against its live keys; q and O in full, k and v
            # only at live keys, LSE, and the two id vectors
            flops = 4.0 * D * H * S * live
            nbytes = 2 * (2 * B * S * H * D + 2 * H * D * live) + 4 * B * H * S + 4 * 2 * B * S
            b_ms, b_by, _, nbytes = _bound(flops, nbytes)
            keep = mask.bool()[:, None, None, :]

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep)
        elif fused:
            cos, sin = rotary_cos_sin(S, D, base=1000.0, device=dev)
            kw.update(rotary_cos=cos, rotary_sin=sin)
            # + the two expanded fp32 tables, padded to the 64-row tile
            b_ms, b_by, _, nbytes = _bound(flops, nbytes + 2 * 4 * (-(-S // 64) * 64) * D)

            def sdpa():
                return F.scaled_dot_product_attention(apply_rotary(q, cos, sin).transpose(1, 2),
                                                      apply_rotary(k, cos, sin).transpose(1, 2), vt)
        else:
            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt)

        def run():
            return fa.flash_attention_fwd(q, k, v, **kw)

        out, lse = run()
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
        ratio, lse_err = fa.output_error_ratio(out, ref_out), (lse - ref_lse).abs().max().item()
        del out, lse, ref_out, ref_lse
        row = dict(ms=median_ms(run), device_ms=median_ms(run, queued=True), enqueue_us=host_enqueue_us(run),
                   plain_ms=median_ms(lambda: fa.flash_attention_reference(q, k, v, **kw), runs=3, warmup=1),
                   library_ms=median_ms(sdpa), library_device_ms=median_ms(sdpa, queued=True),
                   library_enqueue_us=host_enqueue_us(sdpa), bound_ms=b_ms, bound_by=b_by, flops=flops,
                   bytes=nbytes, o_err_over_tol=ratio, lse_max_abs_err=lse_err)
        if not fused and not padded:
            keep = mask.bool()[:, None, None, :]
            row["library_masked_ms"] = median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep))
        row.update(tflops=flops / row["ms"] / 1e9, roofline_share=b_ms / row["ms"],
                   device_roofline_share=b_ms / row["device_ms"])
        rows[label] = row
        emit(phase="kernel_timing", card=card, gpu_state=gpu_state(), shape=label, B=B, S=S, T=S, H=H, D=D,
             fused_rotary=fused, **row,
             note="ms, device_ms, enqueue_us: flash_attention_fwd; " + (
                 "the dispatch's form of a padded batch (segment ids 1, the mask as kv ids); library: SDPA "
                 "with the mask as a boolean attn_mask" if padded else
                 "library: SDPA without a mask" + (" on q, k rotated by apply_rotary in the same call" if fused
                                                   else "; library_masked_ms: SDPA with the all-ones mask as a "
                                                        "boolean attn_mask")))
        if ratio > 1.0 or lse_err > fa.LSE_ATOL:
            raise AssertionError(f"flash forward kernel disagrees with its plain version at {label}")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


# The backward's timed shapes: the contrastive step's query tower and
# document chunk, and the MLM step's shape, plain and with fused rotary;
# each with the all-ones attention mask the steps pass.
BWD_TIMING_SHAPES = (("b512_s32", 512, 32, False), ("b16_s256", 16, 256, False),
                     ("mlm_b8_s2048", 8, 2048, False), ("mlm_b8_s2048_fused", 8, 2048, True))


def backward_timing(dev, card, gen, per_kernel=True):
    """Phase kernel_timing_bwd at BWD_TIMING_SHAPES (H=12, D=64): the whole
    backward through `flash_attention_backward` (this package's: dq, which
    computes delta, and dk/dv; an earlier one's may compute delta outside),
    checked once more against its plain version, as ms, device_ms and the
    host's enqueue per call, beside the plain backward and torch SDPA's
    backward (autograd, forward + backward minus forward; on pre-rotated q/k
    for the fused shape), each the same three ways. per_kernel (this
    package's launchers only) adds dq and dk/dv alone, each beside its
    bound. Returns {shape: row}."""
    import torch
    import torch.nn.functional as F

    from contrastors_tpu_torch.layers.rotary import apply_rotary, rotary_cos_sin
    from contrastors_tpu_torch.ops import flash_attention as fa

    rows = {}
    for label, B, S, fused in BWD_TIMING_SHAPES:
        H, D = 12, 64
        q, k, v = make_qkv(gen, dev, B, S, S, H, H, D)
        mask = torch.ones(B, S, dtype=torch.int32, device=dev)
        kw = dict(attention_mask=mask)
        if fused:
            cos, sin = rotary_cos_sin(S, D, base=1000.0, device=dev)
            kw.update(rotary_cos=cos, rotary_sin=sin)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        dout = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()

        def run():
            return fa.flash_attention_backward(q, k, v, out, lse, dout, **kw)

        refs = fa.flash_attention_backward_reference(q, k, v, out, lse, dout, **kw)
        ratios = {n: fa.grad_error_ratio(g, r, n) for g, r, n in zip(run(), refs, ("dq", "dk", "dv"))}
        row = dict(ms=median_ms(run), device_ms=median_ms(run, queued=True), enqueue_us=host_enqueue_us(run),
                   plain_ms=median_ms(lambda: fa.flash_attention_backward_reference(
                       q, k, v, out, lse, dout, **kw), runs=3, warmup=1),
                   err_over_tol=ratios)
        del refs
        # the yardstick: autograd of torch SDPA (all rows valid, so no mask)
        qs, ks = (apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)) if fused else (q, k)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (qs, ks, v))
        dot = dout.transpose(1, 2)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qt, kt, vt)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(F.scaled_dot_product_attention(qt, kt, vt), (qt, kt, vt), dot)

        row.update(library_ms=median_ms(sdpa_fwd_bwd) - median_ms(sdpa_fwd),
                   library_device_ms=median_ms(sdpa_fwd_bwd, queued=True) - median_ms(sdpa_fwd, queued=True),
                   library_enqueue_us=host_enqueue_us(sdpa_fwd_bwd) - host_enqueue_us(sdpa_fwd))
        if per_kernel:
            qk, kk, rot = fa._rotary(q, k, kw.get("rotary_cos"), kw.get("rotary_sin"), False, None)
            seg_q, seg_kv = fa.merge_segments(B, S, S, mask, None, None, dev)
            inputs = fa.prepare_backward(qk, kk, v, out, lse, dout, seg_q, seg_kv)
            args = (False, 0, 0, 1.0 / D**0.5)
            launchers = dict(dq=lambda: fa.launch_bwd_dq(*inputs, *args, rot=rot),
                             dkv=lambda: fa.launch_bwd_dkv(*inputs, *args, rot=rot))
            launchers["dq"]()  # delta for dk/dv
            for kname, launch in launchers.items():
                b_ms, b_by, flops, nbytes = backward_bound(kname, B, S, S, H, H, D, [S] * B)
                if fused:  # + the two fp32 tables
                    b_ms, b_by, _, nbytes = _bound(flops, nbytes + 2 * rot.cos.numel() * 4)
                k_ms, k_dev = median_ms(launch), median_ms(launch, queued=True)
                row[kname] = dict(ms=k_ms, device_ms=k_dev, enqueue_us=host_enqueue_us(launch), bound_ms=b_ms,
                                  bound_by=b_by, flops=flops, bytes=nbytes, tflops=flops / k_ms / 1e9,
                                  roofline_share=b_ms / k_ms, device_roofline_share=b_ms / k_dev)
            del inputs
        rows[label] = row
        emit(phase="kernel_timing_bwd", card=card, gpu_state=gpu_state(), shape=label, B=B, S=S, T=S, H=H, D=D,
             fused_rotary=fused, **row,
             note="ms, device_ms, enqueue_us: the whole backward (flash_attention_backward); plain_ms and "
                  "library_ms are whole backwards too (library: SDPA, on pre-rotated q/k where fused)")
        if max(ratios.values()) > 1.0:
            raise AssertionError(f"flash backward kernels disagree with their plain version at {label}")
        del q, k, v, out, lse, dout, qs, ks, qt, kt, vt, dot
        torch.cuda.empty_cache()
    return rows


# the MLM pretraining step of the JAX benchmark (bench.py:837-884):
# nomic-bert-2048, B=8 x S=2048, 30% masked, dense_seq_output, AdamW lr 5e-4
# wd 0.01 clip 1.0; gradient accumulation as the recipe sets it
# (configs/train/mlm.yaml:13)
MLM_B, MLM_S, MLM_P, MLM_GA = 8, 2048, 0.30, 4


def mlm_batch(dev, seed, rows=MLM_B):
    """One MLM micro-batch: random ids masked by the port's mlm_mask at 30%
    (bert-base-uncased's [MASK] and special ids), dense_seq_output positions
    at k = dense_budget(2048, 0.30) = 768 per row."""
    import torch

    from contrastors_tpu_torch.trainers.mlm import dense_budget, masked_positions_static, mlm_mask

    rng = np.random.default_rng(seed)
    ids = rng.integers(1000, 30000, size=(rows, MLM_S))
    masked, labels = mlm_mask(ids, MLM_P, 103, 30522, {0, 101, 102, 103}, rng)
    pos, lab = masked_positions_static(labels, dense_budget(MLM_S, MLM_P))

    def dev_tensor(x):
        return torch.from_numpy(np.asarray(x, np.int64)).to(dev)

    return dict(input_ids=dev_tensor(masked), attention_mask=torch.ones(rows, MLM_S, dtype=torch.int64, device=dev),
                labels=dev_tensor(lab), masked_positions=dev_tensor(pos))


def mlm_model(dev, fused=True, impl="flash"):
    """NomicBertForPreTraining(nomic-bert-2048) in bf16 with fp32 parameters
    and random weights from seed 0."""
    import torch

    from contrastors_tpu_torch.models import NomicBertForPreTraining
    from contrastors_tpu_torch.models.presets import nomic_bert_2048

    model = NomicBertForPreTraining(nomic_bert_2048(attn_impl=impl, fused_rotary=fused), dtype=torch.bfloat16,
                                    device=dev)
    return seed_weights(model, "mlm")


def mlm_training(dev, card, agreement=True):
    """Phases mlm_train_step, mlm_train_timing, mlm_train_profile,
    mlm_grad_accumulation and mlm_grad_agreement (the last three only with
    agreement). Returns the launches of one micro-step and the timing."""
    import gc

    import torch

    from contrastors_tpu_torch.trainers.mlm import make_mlm_train_step
    from contrastors_tpu_torch.utils.optim import make_optimizer

    def optimizer(model):
        return make_optimizer(model.named_parameters(), 5e-4, weight_decay=0.01, max_grad_norm=1.0)

    torch.cuda.reset_peak_memory_stats()
    model = mlm_model(dev)
    opt = optimizer(model)
    step = make_mlm_train_step(model, opt)
    batch = mlm_batch(dev, 0)
    n = model.config.n_layer
    expected = expect(fwd_rot=n, dq_rot=n, dkv_rot=n)
    steps = []
    for _ in range(5):
        reset_counts()
        t0 = time.perf_counter()
        m = step(batch)
        loss = m["loss"].item()
        steps.append(dict(loss=loss, grad_norm=m["grad_norm"].item(), seconds=time.perf_counter() - t0,
                          launches=read_counts()))
    losses = [x["loss"] for x in steps]
    ok = (all(x["launches"] == expected for x in steps) and bool(np.isfinite(losses).all())
          and losses[-1] < losses[0])
    emit(phase="mlm_train_step", params=sum(p.numel() for p in model.parameters()), batch=MLM_B, seq_len=MLM_S,
         mlm_prob=MLM_P, masked_budget=batch["labels"].shape[1],
         masked_tokens=int((batch["labels"] >= 0).sum().item()), fused_rotary=True, expected_launches=expected,
         steps=steps, peak_memory_gb=torch.cuda.max_memory_allocated() / 2**30, ok=ok)
    if not ok:
        raise AssertionError("MLM step: launch counts, finiteness or falling loss failed")

    # the same step with fused_rotary=False (rotary outside, the unfused
    # kernels), from the same initial weights, timed in turns with the fused one
    model_o = mlm_model(dev, fused=False)
    step_o = make_mlm_train_step(model_o, optimizer(model_o))
    reset_counts()
    step_o(batch)
    launches_o = read_counts()
    times = dict(fused=[], outside=[])
    runs = (("fused", step), ("outside", step_o))
    for i in range(6):
        for label, run in runs if i % 2 == 0 else runs[::-1]:
            t0 = time.perf_counter()
            run(batch)
            torch.cuda.synchronize()
            times[label].append((time.perf_counter() - t0) * 1e3)
    tokens = MLM_B * MLM_S
    timing = {label: dict(step_ms=float(np.median(t)), step_ms_min=min(t), step_ms_max=max(t),
                          tokens_per_s=tokens / float(np.median(t)) * 1e3) for label, t in times.items()}
    ok = launches_o == expect(fwd=n, dq=n, dkv=n)
    emit(phase="mlm_train_timing", card=card, gpu_state=gpu_state(), runs=6, tokens_per_step=tokens, **timing,
         fused_over_outside=timing["fused"]["step_ms"] / timing["outside"]["step_ms"],
         outside_launches=launches_o, ok=ok,
         note="host clock around each step and a synchronize; the two steps run in turns "
              "(fused, outside, outside, fused, ...)")
    if not ok:
        raise AssertionError("MLM step with fused_rotary=False: launch counts failed")
    del model_o, step_o
    gc.collect()
    torch.cuda.empty_cache()
    if not agreement:
        del model, opt, step, batch
        gc.collect()
        torch.cuda.empty_cache()
        return steps[0]["launches"], timing

    torch.cuda.reset_peak_memory_stats()
    emit(phase="mlm_train_profile", card=card, gpu_state=gpu_state(),
         **profile_step(lambda: step(batch), timing["fused"]["step_ms"], STD_PHASES),
         peak_memory_gb=torch.cuda.max_memory_allocated() / 2**30,
         note="one profiled fused-rotary step: busy time of its kernels (idle share against the "
              "unprofiled median step_ms); split: host time of each profiler range")

    # the recipe's form: one update over gradient_accumulation_steps = 4
    step_ga = make_mlm_train_step(model, opt, gradient_accumulation_steps=MLM_GA)
    micro = []
    t0 = time.perf_counter()
    for i in range(MLM_GA):
        reset_counts()
        m = step_ga(mlm_batch(dev, 1 + i))
        micro.append(dict(loss=m["loss"].item(), launches=read_counts(),
                          grad_norm=m["grad_norm"].item() if "grad_norm" in m else None))
    torch.cuda.synchronize()
    ok = (all(x["launches"] == expected for x in micro) and all(np.isfinite(x["loss"]) for x in micro)
          and [x["grad_norm"] is not None for x in micro] == [False] * (MLM_GA - 1) + [True]
          and bool(np.isfinite(micro[-1]["grad_norm"])))
    emit(phase="mlm_grad_accumulation", gradient_accumulation_steps=MLM_GA, micro_steps=micro,
         update_seconds=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise AssertionError("MLM gradient accumulation: launches, losses or the update's grad_norm failed")
    del model, opt, step, step_ga, batch
    gc.collect()
    torch.cuda.empty_cache()
    mlm_grad_agreement(dev)
    return steps[0]["launches"], timing


def mlm_grad_agreement(dev):
    """Phase mlm_grad_agreement: the MLM loss's gradients at B=2 x 2048, per
    tensor, fused-rotary kernels against the unfused kernels with rotary
    outside and against attn_impl="sdpa"; the fused backward kernels given
    negated sin tables must fall outside the bound."""
    import gc

    import torch

    batch = {n: t[:2] for n, t in mlm_batch(dev, 7, rows=2).items()}

    def grads(fused, impl, fault=None):
        model = mlm_model(dev, fused=fused, impl=impl)
        with planted_fault(fault) if fault else contextlib.nullcontext():
            model(**batch)["loss"].backward()
        out = {n: p.grad.float().clone() for n, p in model.named_parameters() if p.grad is not None}
        del model
        gc.collect()
        torch.cuda.empty_cache()
        return out

    reset_counts()
    fused = grads(True, "flash")
    launches = read_counts()
    outside = grads(False, "flash")
    sdpa = grads(False, "sdpa")
    fault = grads(True, "flash", "negated_sin")
    bound = 0.999
    readings = dict(fused_vs_outside=compare_grads(fused, outside), fused_vs_sdpa=compare_grads(fused, sdpa),
                    outside_vs_sdpa=compare_grads(outside, sdpa),
                    planted_fault=dict(negated_sin_vs_sdpa=compare_grads(fault, sdpa)))
    ok = (readings["fused_vs_outside"]["min_cosine"] >= bound and readings["fused_vs_sdpa"]["min_cosine"] >= bound
          and readings["planted_fault"]["negated_sin_vs_sdpa"]["min_cosine"] < bound
          and launches == expect(fwd_rot=12, dq_rot=12, dkv_rot=12))
    emit(phase="mlm_grad_agreement", batch=2, seq_len=MLM_S, **readings, fused_launches=launches,
         bound_min_cosine=bound, ok=ok)
    if not ok:
        raise AssertionError("MLM gradients: the fused kernels are outside the bound against the outside "
                             "rotation or sdpa, or the planted fault is inside it")
    del fused, outside, sdpa, fault
    gc.collect()
    torch.cuda.empty_cache()


def dense_training(dev, card, agreement=True):
    """Phases train_step, train_timing, train_profile and (with agreement)
    train_grad_agreement: the dense GradCache step at full width. Returns
    the launches of one step and its timing (host-clock step ms, busy ms by
    kernel group from the profiled step)."""
    import gc

    import torch

    from contrastors_tpu_torch.models.presets import nomic_bert_2048
    from contrastors_tpu_torch.trainers.text_text import make_train_step

    tcfg = nomic_bert_2048(attn_impl="flash")
    torch.cuda.reset_peak_memory_stats()
    t_model, t_scale, t_opt = train_modules("flash", dev)
    step = make_train_step(t_model, t_scale, t_opt, grad_cache=True, chunk_size=CHUNK,
                           direct_chunks_q=-1, direct_chunks_d=0)
    qb, db = token_batches(PAIRS, dev)
    n_chunks = PAIRS // CHUNK
    # forwards: the direct query batch, and each document chunk in pass 1 and
    # pass 2; backwards: the direct query batch and each document chunk
    expected = expect(fwd=tcfg.n_layer * (1 + 2 * n_chunks), dq=tcfg.n_layer * (1 + n_chunks),
                      dkv=tcfg.n_layer * (1 + n_chunks))
    train_gen = torch.Generator().manual_seed(0)
    steps = []
    for _ in range(5):
        reset_counts()
        t0 = time.perf_counter()
        m = step(qb, db, train_gen)
        loss = m["loss"].item()
        steps.append(dict(loss=loss, grad_norm=m["grad_norm"].item(), accuracy=m["accuracy"].item(),
                          seconds=time.perf_counter() - t0, launches=read_counts()))
    losses = [x["loss"] for x in steps]
    train_ok = (all(x["launches"] == expected for x in steps)
                and bool(np.isfinite(losses).all()) and losses[-1] < losses[0])
    emit(phase="train_step", params=sum(p.numel() for p in t_model.parameters()), pairs=PAIRS,
         q_len=Q_LEN, d_len=D_LEN, chunk=CHUNK, expected_launches=expected, steps=steps,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 2**30, ok=train_ok)
    if not train_ok:
        raise AssertionError("train step: launch counts, finiteness or falling loss failed")
    launches_train = steps[0]["launches"]

    # the step's time on the host clock
    host_ms, enqueue_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        step(qb, db, train_gen)
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)  # step() returned
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(host_ms))
    emit(phase="train_timing", card=card, gpu_state=gpu_state(), pairs=PAIRS, runs=len(host_ms),
         step_ms=step_ms, step_ms_min=min(host_ms), step_ms_max=max(host_ms),
         enqueue_ms=float(np.median(enqueue_ms)),
         pairs_per_s=PAIRS / step_ms * 1e3, tokens_per_s=PAIRS * (Q_LEN + D_LEN) / step_ms * 1e3,
         note="enqueue_ms = host time until step() returns, before the final synchronize")

    # one step under torch.profiler: the device's busy time by kernel, and
    # the step split at its profiler ranges
    profile = profile_step(lambda: step(qb, db, train_gen), step_ms)
    emit(phase="train_profile", card=card, gpu_state=gpu_state(), **profile,
         note="one profiled step: busy time of its kernels (idle share against the unprofiled median "
              "step_ms); split: host time of each profiler range and, where the trace has it, the "
              "device span of the kernels launched in it; the profiler slows the host")
    del t_model, t_scale, t_opt, step, qb, db
    gc.collect()
    torch.cuda.empty_cache()
    timing = dict(step_ms=step_ms, step_ms_min=min(host_ms), step_ms_max=max(host_ms),
                  pairs_per_s=PAIRS / step_ms * 1e3, enqueue_ms=float(np.median(enqueue_ms)),
                  device_busy_ms=profile["device_busy_ms"], idle_share=profile["idle_share_of_step"],
                  busy_by_group={g: v["ms"] for g, v in profile["by_group"].items()})
    if not agreement:
        return launches_train, timing

    # grad-cache grads against the standard step's, and flash against sdpa,
    # at 64 pairs with the same weights; then two planted faults, which the
    # bounds must reject
    sq, sd = token_batches(64, dev, seed=1)
    grads = {}
    for label, impl, grad_cache, fault in (("gc", "flash", True, None), ("std", "flash", False, None),
                                           ("sdpa", "sdpa", True, None),
                                           ("no_delta", "flash", True, "no_delta"),
                                           ("rolled_replay", "flash", True, "rolled_replay")):
        with planted_fault(fault) if fault else contextlib.nullcontext():
            grads[label] = step_grads(impl, grad_cache, dev, sq, sd)
        gc.collect()
        torch.cuda.empty_cache()
    bounds = dict(gc_vs_std_min_cosine=0.9999, gc_vs_std_max_rel_l2=0.01, flash_vs_sdpa_min_cosine=0.999)

    def gc_ok(r):
        return r["min_cosine"] >= bounds["gc_vs_std_min_cosine"] and r["max_rel_l2"] <= bounds["gc_vs_std_max_rel_l2"]

    def flash_ok(r):
        return r["min_cosine"] >= bounds["flash_vs_sdpa_min_cosine"]

    gc_vs_std = compare_grads(grads["gc"], grads["std"])
    flash_vs_sdpa = compare_grads(grads["gc"], grads["sdpa"])
    # each fault is read against the comparison that must catch it
    faults = dict(no_delta_vs_sdpa=compare_grads(grads["no_delta"], grads["sdpa"]),
                  rolled_replay_vs_std=compare_grads(grads["rolled_replay"], grads["std"]))
    agree_ok = (gc_ok(gc_vs_std) and flash_ok(flash_vs_sdpa)
                and not flash_ok(faults["no_delta_vs_sdpa"]) and not gc_ok(faults["rolled_replay_vs_std"]))
    emit(phase="train_grad_agreement", pairs=64, gc_vs_standard=gc_vs_std, flash_vs_sdpa=flash_vs_sdpa,
         planted_faults=faults, bounds=bounds, ok=agree_ok)
    if not agree_ok:
        raise AssertionError("train step gradients: a sound step is outside its bounds, "
                             "or a planted fault is inside them")
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    return launches_train, timing


# configs/train/contrastive_pretrain.yaml, the recipe the trainer phase runs
PRETRAIN_RECIPE = {
    "train_args": {
        "num_epochs": 1, "learning_rate": 2.0e-4, "weight_decay": 0.01, "warmup_steps": 700,
        "schedule_type": "cosine", "max_grad_norm": 1.0, "adam_beta1": 0.9, "adam_beta2": 0.999,
        "grad_cache": True, "chunk_size": 16, "loss_fn": "clip", "clamp_logits": False,
        "log_grads_every": 100, "log_lr_every": 10, "save_every": 2500,
        "output_dir": "ckpts/contrastive-pretrain", "wandb": False, "wandb_project_name": "text-contrastors",
    },
    "model_args": {
        "model_type": "encoder", "model_name": "nomic-ai/nomic-bert-2048", "tokenizer_name": "bert-base-uncased",
        "pooling": "mean", "logit_scale": 50, "trainable_logit_scale": False, "nomic_encoder": True,
        "add_prefix": True, "pretrained": True, "seq_len": 2048, "attn_impl": "flash",
    },
    "data_args": {
        "input_shards": "configs/data/contrastive_pretrain.yaml", "batch_size": 16384, "seed": 42,
        "workers": 0, "shuffle": False,
    },
}

# the public config.json of nomic-ai/nomic-bert-2048 (weights random here)
NOMIC_BERT_2048_CONFIG = {
    "model_type": "nomic_bert", "architectures": ["NomicBertForPreTraining"], "activation_function": "swiglu",
    "attn_pdrop": 0.0, "embd_pdrop": 0.0, "resid_pdrop": 0.0, "causal": False, "dense_seq_output": True,
    "initializer_range": 0.02, "layer_norm_epsilon": 1e-12, "mlp_fc1_bias": False, "mlp_fc2_bias": False,
    "n_embd": 768, "n_head": 12, "n_inner": 3072, "n_layer": 12, "n_positions": 2048,
    "pad_vocab_size_multiple": 64, "parallel_block": False, "prenorm": False, "qkv_proj_bias": False,
    "rotary_emb_base": 1000, "rotary_emb_fraction": 1.0, "rotary_emb_interleaved": False,
    "rotary_emb_scale_base": None, "type_vocab_size": 2, "use_rms_norm": False, "vocab_size": 30528,
}

TRAIN_STEPS, SAVE_EVERY = 8, 4


def trainer_overrides(model_dir, pairs, eval_dir, out_dir):
    """What the trainer phase changes in the recipe: the model (a local
    config.json, random weights), the batch (16384 -> 512 pairs), the data
    (local synthetic pairs), the run's length and cadence, the eval, and
    every query chunk direct as in the dense step of phase 7."""
    return {
        "train_args": {"num_train_steps": TRAIN_STEPS, "warmup_steps": 2, "save_every": SAVE_EVERY,
                       "log_lr_every": SAVE_EVERY, "eval_strategy": "steps", "eval_steps": TRAIN_STEPS,
                       "output_dir": out_dir, "grad_cache_direct_chunks_q": -1},
        "model_args": {"model_name": model_dir, "pretrained": False},
        "data_args": {"batch_size": PAIRS, "input_shards": pairs, "streaming": False, "eval_retrieval": eval_dir},
    }


def trainer_recipe(model_dir, pairs, eval_dir, out_dir, checkpoint=None):
    recipe = json.loads(json.dumps(PRETRAIN_RECIPE))
    for group, values in trainer_overrides(model_dir, pairs, eval_dir, out_dir).items():
        recipe[group].update(values)
    if checkpoint:
        recipe["train_args"]["checkpoint"] = checkpoint
    return recipe


def write_trainer_inputs(root, seed=0):
    """config.json, TRAIN_STEPS batches of synthetic pairs (each document
    starts with its query's words, queries of 40 words and documents of
    300, so that with the prefixes every row fills 32 / 256 tokens) and an
    eval set (256 documents, 64 queries made of a document's first 20 words
    and 10 others, one relevant document each)."""
    rng = np.random.default_rng(seed)
    paths = dict(model_dir=os.path.join(root, "nomic-bert-2048"), pairs=os.path.join(root, "pairs.jsonl"),
                 eval_dir=os.path.join(root, "eval"), out_dir=os.path.join(root, "run"))
    os.makedirs(paths["model_dir"])
    with open(os.path.join(paths["model_dir"], "config.json"), "w") as f:
        json.dump(NOMIC_BERT_2048_CONFIG, f)

    def words(a):
        return " ".join(map(str, a))

    with open(paths["pairs"], "w") as f:
        for _ in range(TRAIN_STEPS * PAIRS):
            q = rng.integers(1000, 30000, size=40)
            f.write(json.dumps({"query": words(q), "document": words(q) + " " + words(
                rng.integers(1000, 30000, size=260))}) + "\n")
    os.makedirs(paths["eval_dir"])
    docs = rng.integers(1000, 30000, size=(256, 200))
    with open(os.path.join(paths["eval_dir"], "corpus.jsonl"), "w") as f:
        for i, d in enumerate(docs):
            f.write(json.dumps({"_id": f"d{i}", "text": words(d)}) + "\n")
    with open(os.path.join(paths["eval_dir"], "queries.jsonl"), "w") as f, \
            open(os.path.join(paths["eval_dir"], "qrels.tsv"), "w") as g:
        for i in range(64):
            f.write(json.dumps({"_id": f"q{i}", "text": words(np.concatenate(
                [docs[4 * i, :20], rng.integers(1000, 30000, size=10)]))}) + "\n")
            g.write(f"q{i}\td{4 * i}\t1\n")
    return paths


@contextlib.contextmanager
def sync_log():
    """The synchronising CUDA calls made inside, as torch's sync debug mode
    ("warn") reports them, from any thread."""
    import warnings

    import torch

    log = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def record(message, category, *args, **kwargs):
            if "synchroniz" in str(message):
                log.append(str(message).splitlines()[0])
            else:
                shown(message, category, *args, **kwargs)

        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield log
        finally:
            torch.cuda.set_sync_debug_mode(0)


def chip_trainer_class(base=None, tokenizer=None, splits=None):
    """A trainer class (default: TextTextTrainer with the stand-in
    tokenizer) whose get_tokenizer hook gives `tokenizer`, whose
    load_dataset hook hands out `splits` (in memory, by the path's last
    part) and whose steps record, per loop step: the host clock and the
    count of synchronising calls at the step's start, its flash launches,
    and its metrics (device tensors, read after the run)."""
    from contrastors_tpu_torch.eval.stub_tokenizer import StubTokenizer
    from contrastors_tpu_torch.trainers import TextTextTrainer

    tokenizer = tokenizer or StubTokenizer(NOMIC_BERT_2048_CONFIG["vocab_size"])

    class ChipTrainer(base or TextTextTrainer):
        syncs = None  # the list sync_log() fills

        def get_tokenizer(self):
            return tokenizer

        def load_dataset(self, path):
            return splits[os.path.basename(path)]

        def make_train_step(self):
            step = super().make_train_step()
            self.record = []

            def recorded(batch, generator):
                t, n_sync, before = time.perf_counter(), len(self.syncs), read_counts()
                metrics = step(batch, generator)
                after = read_counts()
                self.record.append(dict(step=self.step + 1, t=t, syncs=n_sync, metrics=metrics,
                                        launches={k: after[k] - before[k] for k in after}))
                return metrics

            return recorded

    return ChipTrainer


def run_chip_trainer(recipe, dev, cls=None):
    """One trainer run of the recipe on dev, its sync log kept; returns
    (trainer, per-step rows, seconds, launches over the whole run)."""
    from contrastors_tpu_torch.config import Config
    from contrastors_tpu_torch.train import run

    cls = cls or chip_trainer_class()
    reset_counts()
    t0 = time.perf_counter()
    with sync_log() as syncs:
        cls.syncs = syncs
        trainer = run(Config.from_dict(recipe), "bf16", dev, trainer_cls=cls)
        t_end, n_end = time.perf_counter(), len(syncs)
    launches = read_counts()
    rows = trainer.record
    for i, row in enumerate(rows):  # an iteration runs from its step's start to the next one's
        nxt = rows[i + 1] if i + 1 < len(rows) else dict(t=t_end, syncs=n_end)
        row["iteration_ms"] = (nxt["t"] - row["t"]) * 1e3
        row["iteration_syncs"] = nxt["syncs"] - row["syncs"]
        row["loss"] = row["metrics"]["loss"].item()
        del row["metrics"]
    return trainer, rows, time.perf_counter() - t0, launches, list(syncs)


def bare_step_timing(step, qb, db, gen, runs=3):
    """Host-clock ms of `runs` bare steps, each ending in a synchronize, and
    the synchronising calls each made (the synchronize excluded)."""
    import torch

    ms, syncs = [], []
    for _ in range(runs):
        with sync_log() as log:
            t0 = time.perf_counter()
            step(qb, db, gen)
            n = len(log)
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        syncs.append(n)
    return ms, syncs


def trainer_phase(dev, card, bare_busy_ms=None):
    """Phase trainer: the port's contrastive trainer entry point
    (train.run -> TextTextTrainer -> BaseTrainer.train) on the pretrain
    recipe at full width, against the bare GradCache step of the same
    geometry, in turns: bare, loop, bare, resumed loop. The idle shares
    take bare_busy_ms, the device busy ms of one profiled bare step (phase
    7's, in the full run), or profile one here. Returns the launches of one
    loop step."""
    import gc
    import tempfile

    import torch

    from contrastors_tpu_torch.config import Config
    from contrastors_tpu_torch.models.auto import load_biencoder
    from contrastors_tpu_torch.models.biencoder import LogitScale
    from contrastors_tpu_torch.trainers.text_text import make_train_step
    from contrastors_tpu_torch.utils.optim import make_optimizer, make_schedule

    root = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    paths = write_trainer_inputs(root)
    recipe = trainer_recipe(**paths)
    config = Config.from_dict(recipe)
    n_layer = NOMIC_BERT_2048_CONFIG["n_layer"]
    expected = expect(fwd=n_layer * (1 + 2 * PAIRS // CHUNK), dq=n_layer * (1 + PAIRS // CHUNK),
                      dkv=n_layer * (1 + PAIRS // CHUNK))

    # the bare step: the same model (load_biencoder, seed 42) and optimizer,
    # driven from hand-built token batches
    model, _ = load_biencoder(config.model_args, dtype=torch.bfloat16, device=dev, seed=42)
    scale = LogitScale(50.0, trainable=False, device=dev)
    named = [("model." + n, p) for n, p in model.named_parameters()]
    named += [("logit_scale." + n, p) for n, p in scale.named_parameters()]
    opt = make_optimizer(named, 2e-4, weight_decay=0.01, max_grad_norm=1.0)
    step = make_train_step(model, scale, opt, grad_cache=True, chunk_size=CHUNK, direct_chunks_q=-1)
    qb, db = token_batches(PAIRS, dev)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        step(qb, db, gen)
    torch.cuda.synchronize()
    peak_gb = {}
    for remat in (False, True):
        model.trunk.remat = remat
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        step(qb, db, gen)
        torch.cuda.synchronize()
        peak_gb["remat" if remat else "no_remat"] = torch.cuda.max_memory_allocated() / 2**30
        if not remat:  # the replay adds forward launches
            bare_launches = read_counts()
    model.trunk.remat = False
    bare_ms, bare_syncs = bare_step_timing(step, qb, db, gen)
    busy_ms = bare_busy_ms or profile_step(lambda: step(qb, db, gen), float(np.median(bare_ms)))["device_busy_ms"]

    # the loop, uninterrupted
    trainer, rows, seconds, run_launches, syncs = run_chip_trainer(recipe, dev)
    wait_s = trainer.prefetch_wait_seconds
    del trainer
    gc.collect()

    # the bare step again, then a loop resumed from step_4
    bare_ms_2, bare_syncs_2 = bare_step_timing(step, qb, db, gen)
    del model, scale, opt, step, qb, db
    gc.collect()
    torch.cuda.empty_cache()
    checkpoint = os.path.join(paths["out_dir"], f"step_{SAVE_EVERY}")
    resumed_recipe = trainer_recipe(**dict(paths, out_dir=os.path.join(root, "resumed")), checkpoint=checkpoint)
    resumed, rows_b, seconds_b, _, _ = run_chip_trainer(resumed_recipe, dev)
    wait_b = resumed.prefetch_wait_seconds
    del resumed
    gc.collect()
    torch.cuda.empty_cache()

    with open(os.path.join(paths["out_dir"], "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    schedule = make_schedule("cosine", 2e-4, TRAIN_STEPS, 2)
    lr_logged = {m["step"]: m["lr"] for m in logged if "lr" in m}
    lr_err = max(abs(v - schedule(k)) for k, v in lr_logged.items())
    evals = [m for m in logged if "retrieval/ndcg@10" in m]
    losses = {r["step"]: r["loss"] for r in rows}
    resumed_losses = {r["step"]: r["loss"] for r in rows_b}
    resume_rel = max(abs(resumed_losses[k] - losses[k]) / abs(losses[k]) for k in resumed_losses)
    log_steps = {k for k in losses if k % SAVE_EVERY == 0}
    quiet = [r for r in rows if r["step"] not in log_steps and r["step"] > 1]
    quiet_b = [r for r in rows_b if r["step"] not in log_steps and r["step"] > SAVE_EVERY + 1]
    loop_ms = float(np.median([r["iteration_ms"] for r in quiet]))
    loop_syncs = max(r["iteration_syncs"] for r in quiet)
    checks = dict(
        launches_per_step=all(r["launches"] == expected for r in rows + rows_b) and bare_launches == expected,
        loss_falls=losses[TRAIN_STEPS] < losses[1],
        lr_follows_schedule=sorted(lr_logged) == [SAVE_EVERY, TRAIN_STEPS] and lr_err < 1e-9,
        resume_within_2e_3=sorted(resumed_losses) == list(range(SAVE_EVERY + 1, TRAIN_STEPS + 1))
        and resume_rel <= 2e-3,
        eval_logged=[m["step"] for m in evals] == [TRAIN_STEPS],
        syncs_at_most_bare=loop_syncs <= min(bare_syncs + bare_syncs_2),
        finite=bool(np.isfinite(list(losses.values()) + list(resumed_losses.values())).all()),
    )
    ok = all(checks.values())
    emit(phase="trainer", card=card, gpu_state=gpu_state(), recipe="configs/train/contrastive_pretrain.yaml",
         overrides=trainer_overrides(**{k: os.path.basename(v) for k, v in paths.items()}),
         pairs=PAIRS, q_len=Q_LEN, d_len=D_LEN, chunk=CHUNK, steps=TRAIN_STEPS, dtype="bf16",
         expected_launches=expected, launches_per_step=[r["launches"] for r in rows],
         run_launches=run_launches, losses=losses, resumed_losses=resumed_losses,
         resume_max_rel_diff=resume_rel, resume_bit_identical=all(
             resumed_losses[k] == losses[k] for k in resumed_losses),
         lr_logged=lr_logged, lr_max_err=lr_err, eval=evals[-1] if evals else None,
         peak_memory_gb_grad_cache_step=peak_gb, checks=checks, ok=ok)
    emit(phase="trainer_timing", card=card, gpu_state=gpu_state(),
         loop_ms=loop_ms, loop_ms_runs=[r["iteration_ms"] for r in rows],
         resumed_loop_ms=float(np.median([r["iteration_ms"] for r in quiet_b])) if quiet_b else None,
         resumed_loop_ms_runs=[r["iteration_ms"] for r in rows_b],
         bare_step_ms=float(np.median(bare_ms + bare_ms_2)), bare_step_ms_turns=[bare_ms, bare_ms_2],
         loop_minus_bare_ms=loop_ms - float(np.median(bare_ms + bare_ms_2)),
         bare_device_busy_ms=busy_ms, bare_idle_share=1.0 - busy_ms / float(np.median(bare_ms + bare_ms_2)),
         loop_idle_share=1.0 - busy_ms / loop_ms,
         prefetch_wait_ms_per_step=wait_s * 1e3 / len(rows), resumed_prefetch_wait_ms_per_step=wait_b * 1e3 / len(rows_b),
         loop_syncs_per_quiet_step=[r["iteration_syncs"] for r in quiet],
         loop_syncs_per_step=[r["iteration_syncs"] for r in rows], bare_syncs_per_step=bare_syncs + bare_syncs_2,
         sync_examples=sorted(set(syncs))[:8], run_seconds=seconds, resumed_run_seconds=seconds_b,
         note="loop_ms: median host time from one step's start to the next over the steps that neither log, "
              "save nor evaluate (steps 2, 3, 5, 6, 7); bare: the step alone on hand-built batches, "
              "synchronized after each call; idle shares take the device busy ms of one profiled bare step "
              "(phase 7's in the full run; the loop runs the same kernels); syncs: calls that torch's sync "
              "debug mode reports")
    shutil.rmtree(root)  # ~5 GB of checkpoints
    if not ok:
        raise AssertionError(f"trainer: a check failed: {checks}")
    return rows[1]["launches"]


# the public config.json fields of bert-base-uncased and xlm-roberta-base
# (the weights are random here)
BERT_BASE_UNCASED_CONFIG = {
    "model_type": "bert", "architectures": ["BertForMaskedLM"], "vocab_size": 30522, "hidden_size": 768,
    "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072, "hidden_act": "gelu",
    "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1, "max_position_embeddings": 512,
    "type_vocab_size": 2, "initializer_range": 0.02, "layer_norm_eps": 1e-12, "pad_token_id": 0,
    "position_embedding_type": "absolute",
}
XLM_ROBERTA_BASE_CONFIG = {
    "model_type": "xlm-roberta", "architectures": ["XLMRobertaForMaskedLM"], "vocab_size": 250002,
    "hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072,
    "hidden_act": "gelu", "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1,
    "max_position_embeddings": 514, "type_vocab_size": 1, "initializer_range": 0.02, "layer_norm_eps": 1e-05,
    "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2, "position_embedding_type": "absolute",
}
# what the phase cuts from each recipe: the rows of one loop step (one
# micro-step: the trainers' batch_size), the steps and the data
MLM_ROWS, MLM_STEPS, MLM_WARMUP, MLM_GA_RECIPE = 4, 32, 8, 4  # 8 updates of 4 micro-steps, warmup 2 updates
MMLM_ROWS, MMLM_STEPS = 8, 4
GLUE_TRAIN_ROWS, GLUE_VAL_ROWS, GLUE_EPOCHS = 384, 100, 3  # 12 steps of 32 per epoch, the recipe's 3 epochs
KEEP_BAND, KEEP_DRAWS = 0.0006, 10**7


class Rows:
    """Rows held in memory with what the trainers read of a `datasets`
    split: len() and, for a list of indices, a dict of columns."""

    def __init__(self, **columns):
        self.columns = {k: np.asarray(v) for k, v in columns.items()}

    def __len__(self):
        return len(next(iter(self.columns.values())))

    def __getitem__(self, idx):
        if isinstance(idx, str):
            return self.columns[idx]
        return {k: v[np.asarray(idx, dtype=np.int64)] for k, v in self.columns.items()}


def bert_family_inputs(root, seed=42):
    """The config.json directories, the multilingual root (one empty
    directory per language: the trainer lists them) and the in-memory
    splits by the last part of the recipes' data paths. MLM and MMLM rows
    draw ids from 300 token values, so that the loss can fall; GLUE's are
    sentences of 4-120 number words, label 1 where "7777" is one of them."""
    rng = np.random.default_rng(seed)
    dirs = {}
    for name, cfg in (("bert-base-uncased", BERT_BASE_UNCASED_CONFIG), ("xlm-roberta-base", XLM_ROBERTA_BASE_CONFIG)):
        dirs[name] = os.path.join(root, name)
        os.makedirs(dirs[name])
        with open(os.path.join(dirs[name], "config.json"), "w") as f:
            json.dump(cfg, f)

    def ids(n, S, lo):
        return rng.integers(lo, lo + 300, size=(n, S))

    splits = {"wiki-books-2048": {"train": Rows(input_ids=ids(MLM_STEPS * MLM_ROWS, 2048, 1000)),
                                  "validation": Rows(input_ids=ids(2 * MLM_ROWS, 2048, 1000))}}
    mm_root = os.path.join(root, "multilingual")
    for lang, n, lo in (("en", 3 * MMLM_ROWS, 5000), ("fr", 2 * MMLM_ROWS, 6000)):
        os.makedirs(os.path.join(mm_root, lang))
        splits[lang] = Rows(input_ids=ids(n, 512, lo))

    def sentences(n):
        texts, labels = [], []
        for _ in range(n):
            words = rng.integers(1000, 2000, size=rng.integers(4, 121)).astype(str).tolist()
            label = int(rng.random() < 0.5)
            if label:
                words[rng.integers(len(words))] = "7777"
            texts.append(" ".join(words))
            labels.append(label)
        return Rows(sentence=np.asarray(texts, dtype=object), label=labels)

    splits["sst2"] = {"train": sentences(GLUE_TRAIN_ROWS), "validation": sentences(GLUE_VAL_ROWS)}
    return dirs, mm_root, splits


def bert_family_overrides(dirs, mm_root, out_root):
    """What the phase changes in each recipe: the model (a local config.json,
    random weights), the batch, the steps (and their warmup and eval in
    the MLM run, the log cadence in the MMLM run, which is 4 steps long),
    the data and the output directory."""
    bert, xlmr = dirs["bert-base-uncased"], dirs["xlm-roberta-base"]
    return {
        "mlm": {"train_args": {"num_train_steps": MLM_STEPS, "warmup_steps": MLM_WARMUP, "eval_steps": MLM_STEPS,
                               "output_dir": os.path.join(out_root, "mlm")},
                "model_args": {"model_name": bert}, "data_args": {"batch_size": MLM_ROWS}},
        "mmlm": {"train_args": {"num_train_steps": MMLM_STEPS, "log_lr_every": 2,
                                "output_dir": os.path.join(out_root, "mmlm")},
                 "model_args": {"model_name": xlmr},
                 "data_args": {"batch_size": MMLM_ROWS, "tokenized_dataset": mm_root}},
        "glue": {"train_args": {"output_dir": os.path.join(out_root, "glue")},
                 "model_args": {"model_name": bert, "pretrained": False}},
    }


def bert_family_recipe(name, overrides):
    """configs/train/<name>.yaml through the port's read_config, with the
    phase's overrides."""
    from contrastors_tpu_torch.read import read_config

    raw = read_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "train",
                                   f"{name}.yaml")).to_dict()
    for group, values in overrides[name].items():
        raw[group].update(values)
    return raw


@contextlib.contextmanager
def dropout_sites(stats):
    """Count the keep masks drawn inside by site: stats[site] = [kept (a
    device tensor), draws]. A site is known by the generator it draws from,
    which the model and its blocks build per site (`site_generator`)."""
    from contrastors_tpu_torch.layers import block
    from contrastors_tpu_torch.models import nomic_bert
    from contrastors_tpu_torch.ops import dropout as drop

    names = {}
    block_sites = {0: "residual_1", 1: "drop_path_1", 2: "attention", 3: "residual_2", 4: "drop_path_2"}
    model_sites = {nomic_bert.SITE_EMBEDDING: "embedding", nomic_bert.SITE_FINAL: "final",
                   nomic_bert.SITE_CLASSIFIER: "classifier"}

    def tagged(orig, sites):
        def site_generator(seed, *path, device):
            g = orig(seed, *path, device=device)
            if g is not None:
                names[id(g)] = sites[path[0]]
            return g
        return site_generator

    def keep_mask(shape, keep, generator, device, orig=drop.keep_mask):
        m = orig(shape, keep, generator, device)
        row = stats.setdefault(names.get(id(generator), "unknown"), [0, 0])
        row[0] = row[0] + m.sum()
        row[1] += m.numel()
        return m

    patches = [(block, "site_generator", tagged(block.site_generator, block_sites)),
               (nomic_bert, "site_generator", tagged(nomic_bert.site_generator, model_sites)),
               (drop, "keep_mask", keep_mask)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield stats
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def global_rng_dropout():
    """The planted fault of the replay check: keep masks drawn from the
    global RNG instead of the site's generator."""
    import torch

    from contrastors_tpu_torch.ops import dropout as drop

    orig = drop.keep_mask
    drop.keep_mask = lambda shape, keep, generator, device: torch.rand(tuple(shape), device=device) < keep
    try:
        yield
    finally:
        drop.keep_mask = orig


def remat_grads(model, batch, dev, remat):
    """One MLM micro-step's gradients, dropout on (seed 11), with or without
    activation checkpointing; deterministic algorithms where torch has them
    (the dense_seq_output gather's backward adds with atomics otherwise)."""
    import warnings

    import torch

    flags = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    model.bert.remat = remat
    model.zero_grad(set_to_none=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.use_deterministic_algorithms(True, warn_only=True)
            out = model(batch["input_ids"], attention_mask=batch["attention_mask"], labels=batch["labels"],
                        masked_positions=batch.get("masked_positions"),
                        generator=torch.Generator(device=dev).manual_seed(11))
            out["loss"].backward()
    finally:
        torch.use_deterministic_algorithms(flags[0], warn_only=flags[1])
        model.bert.remat = False
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return grads


def bit_identical(a, b):
    import torch

    return all(torch.equal(a[n], b[n]) for n in a) and set(a) == set(b)


def quiet_rows(rows, noisy):
    """The loop steps that neither log, save nor evaluate (nor start the run)."""
    return [r for r in rows if r["step"] > 1 and r["step"] not in noisy]


def mlm_trainer_phase(dev, card, mlm_step_ms=None):
    """Phase mlm_trainer: configs/train/{mlm,mmlm,glue}.yaml through the
    port's read_config and train.run at full width (bert-base-uncased's and
    xlm-roberta-base's public config.json, random weights, in-memory data,
    the stand-in tokenizer), cut in batch, steps and data only; the recipes'
    dropout 0.1 runs attention through sdpa in every training step, as in
    JAX, and the flash forward in the evals. Then on the trained MLM model:
    eval through the kernel against the plain path, one micro-step's
    gradients with remat on and off (and with a planted global-RNG dropout),
    determinism of the noise, each site's keep share, and the micro-step
    timed with dropout on and off in turns; on the GLUE model the eval
    logits through the kernel against the plain path and the classifier's
    keep share. Returns {"mlm_eval": launches, "glue_eval": launches, ...}."""
    import gc
    import tempfile

    import torch

    from contrastors_tpu_torch.eval.stub_tokenizer import StubTokenizer
    from contrastors_tpu_torch.ops import dropout as drop
    from contrastors_tpu_torch.trainers import GlueTrainer, MLMTrainer, MMLMTrainer
    from contrastors_tpu_torch.trainers.mlm import make_mlm_train_step
    from contrastors_tpu_torch.utils.optim import make_optimizer

    root = tempfile.mkdtemp(prefix="chip_smoke_bert_")
    dirs, mm_root, splits = bert_family_inputs(root)
    overrides = bert_family_overrides(dirs, mm_root, os.path.join(root, "runs"))
    n_layer = BERT_BASE_UNCASED_CONFIG["num_hidden_layers"]
    bert_tok = StubTokenizer(BERT_BASE_UNCASED_CONFIG["vocab_size"])
    xlmr_tok = StubTokenizer(XLM_ROBERTA_BASE_CONFIG["vocab_size"], pad_token_id=1, cls_token_id=0,
                             sep_token_id=2, mask_token_id=250001)
    zero = expect()
    checks, out = {}, {}

    def logged(name):
        with open(os.path.join(root, "runs", name, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    # -- MLM ------------------------------------------------------------------
    recipe = bert_family_recipe("mlm", overrides)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer, rows, seconds, run_launches, syncs = run_chip_trainer(
        recipe, dev, chip_trainer_class(MLMTrainer, bert_tok, splits))
    mlm_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    model, cfg = trainer.model, trainer.trunk_config
    losses = [r["loss"] for r in rows]
    per_update = [float(np.mean(losses[i:i + MLM_GA_RECIPE])) for i in range(0, len(losses), MLM_GA_RECIPE)]
    step_launches = {k: sum(r["launches"][k] for r in rows) for k in zero}
    eval_launches = {k: run_launches[k] - step_launches[k] for k in zero}
    mlm_log = logged("mlm")
    evals = [m for m in mlm_log if "val_loss" in m]
    quiet = quiet_rows(rows, {k for k in range(1, MLM_STEPS + 1) if k % recipe["train_args"]["log_lr_every"] == 0}
                       | {MLM_STEPS})
    n_val_batches = len(splits["wiki-books-2048"]["validation"]) // MLM_ROWS
    checks.update(
        mlm_no_flash_in_training=all(r["launches"] == zero for r in rows),
        mlm_eval_flash_launches=eval_launches == expect(fwd=n_layer * n_val_batches),
        mlm_finite=bool(np.isfinite(losses).all()) and len(evals) == 1 and np.isfinite(evals[0]["val_loss"]),
        mlm_loss_falls=float(np.mean(per_update[-2:])) < float(np.mean(per_update[:2])),
        mlm_no_sync_per_quiet_step=all(r["iteration_syncs"] == 0 for r in quiet),
    )
    mlm_ms = float(np.median([r["iteration_ms"] for r in quiet]))

    # eval through the kernel against the plain path, on the same weights
    reset_counts()
    val_flash = trainer.eval_loop(MLM_STEPS)["val_loss"]
    eval_flash_launches = read_counts()
    cfg.attn_impl = "sdpa"
    val_plain = trainer.eval_loop(MLM_STEPS)["val_loss"]
    cfg.attn_impl = "flash"
    val_rel = abs(val_flash - val_plain) / abs(val_plain)
    checks["mlm_eval_kernel_vs_plain_1e_2"] = val_rel <= 1e-2
    checks["mlm_eval_launches_12_per_batch"] = eval_flash_launches == expect(fwd=n_layer * n_val_batches)

    # one micro-batch of the run's data, on the card
    loader_batch = next(iter(trainer.dataloader))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in loader_batch.items()}
    model.train()

    # determinism: the same seed draws the same noise, another seed other noise
    def logits(seed):
        with torch.no_grad():
            return model(batch["input_ids"], attention_mask=batch["attention_mask"],
                         masked_positions=batch["masked_positions"],
                         generator=torch.Generator(device=dev).manual_seed(seed))["prediction_logits"]

    a, b, c = logits(1), logits(1), logits(2)
    checks["same_seed_bit_identical"] = bool(torch.equal(a, b))
    checks["other_seed_differs"] = not bool(torch.equal(a, c))
    del a, b, c

    # replay: remat on and off bit-identical; a global-RNG dropout must fail it
    g_off = remat_grads(model, batch, dev, remat=False)
    g_on = remat_grads(model, batch, dev, remat=True)
    replay_ok = bit_identical(g_off, g_on)
    replay = dict(remat_on_off_bit_identical=replay_ok)
    if not replay_ok:  # is the step itself deterministic?
        replay["remat_off_twice_bit_identical"] = bit_identical(g_off, remat_grads(model, batch, dev, remat=False))
    del g_on
    with global_rng_dropout():
        f_off = remat_grads(model, batch, dev, remat=False)
        f_on = remat_grads(model, batch, dev, remat=True)
    replay["planted_global_rng_bit_identical"] = bit_identical(f_off, f_on)
    del g_off, f_off, f_on
    checks["remat_replay_bit_identical"] = replay_ok
    checks["planted_global_rng_fails_replay"] = not replay["planted_global_rng_bit_identical"]

    # each site's keep share, over two train-mode forwards
    stats = {}
    with dropout_sites(stats), torch.no_grad():
        for seed in (3, 4):
            model(batch["input_ids"], attention_mask=batch["attention_mask"],
                  masked_positions=batch["masked_positions"], generator=torch.Generator(device=dev).manual_seed(seed))

    # the micro-step with dropout on (attention through sdpa) and off (the
    # flash kernels), in turns, on the run's model and batch
    opt = make_optimizer(model.named_parameters(), 5e-4, weight_decay=0.01, max_grad_norm=1.0)
    step = make_mlm_train_step(model, opt)
    drops = (cfg.embd_pdrop, cfg.resid_pdrop, cfg.attn_pdrop)

    def set_dropout(on):
        cfg.embd_pdrop, cfg.resid_pdrop, cfg.attn_pdrop = drops if on else (0.0, 0.0, 0.0)

    step_ms, step_launches_by = dict(dropout=[], no_dropout=[]), {}
    gen = torch.Generator()
    for i in range(6):
        for label in (("dropout", "no_dropout") if i % 2 == 0 else ("no_dropout", "dropout")):
            set_dropout(label == "dropout")
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(batch, gen)
            torch.cuda.synchronize()
            step_ms[label].append((time.perf_counter() - t0) * 1e3)
            step_launches_by[label] = read_counts()
    set_dropout(True)
    checks["bare_step_launches"] = (step_launches_by["dropout"] == zero
                                    and step_launches_by["no_dropout"] == expect(fwd=n_layer, dq=n_layer,
                                                                                 dkv=n_layer))
    mlm_eval_launches = eval_flash_launches["fwd"]
    del trainer, model, opt, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase="mlm_trainer", card=card, gpu_state=gpu_state(), recipe="configs/train/mlm.yaml",
         overrides=overrides["mlm"], rows_per_micro_step=MLM_ROWS, seq_len=2048, micro_steps=MLM_STEPS,
         gradient_accumulation_steps=MLM_GA_RECIPE, dtype="bf16", dropout=drops, losses=losses,
         loss_per_update=per_update, eval=evals[-1] if evals else None, eval_launches=eval_launches,
         val_loss_flash=val_flash, val_loss_plain=val_plain, val_loss_rel_diff=val_rel,
         replay=replay, peak_memory_gb=mlm_peak_gb, run_seconds=seconds,
         quiet_step_ms=mlm_ms, quiet_step_ms_runs=[r["iteration_ms"] for r in quiet],
         syncs_per_quiet_step=[r["iteration_syncs"] for r in quiet], sync_examples=sorted(set(syncs))[:8],
         bare_micro_step_ms={k: float(np.median(v)) for k, v in step_ms.items()}, bare_micro_step_ms_runs=step_ms,
         bare_micro_step_launches=step_launches_by,
         dropout_free_mlm_train_step_ms=mlm_step_ms,
         note="quiet_step_ms: median host time from one loop step's start to the next over the steps that "
              "neither log nor evaluate; bare_micro_step_ms: the same model and batch, one micro-step with a "
              "synchronize, dropout on (attention through sdpa) and off (the flash kernels) in turns; "
              "dropout_free_mlm_train_step_ms: phase mlm_train_timing's fused step at B=8 x 2048")

    # -- MMLM -----------------------------------------------------------------
    recipe = bert_family_recipe("mmlm", overrides)
    torch.cuda.reset_peak_memory_stats()
    trainer, m_rows, m_seconds, m_launches, _ = run_chip_trainer(
        recipe, dev, chip_trainer_class(MMLMTrainer, xlmr_tok, splits))
    mmlm_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    mmlm_log = logged("mmlm")
    lang_keys = sorted({k for m in mmlm_log for k in m if k.startswith("loss/")})
    m_losses = [r["loss"] for r in m_rows]
    m_quiet = quiet_rows(m_rows, {2, 4})
    checks.update(
        mmlm_no_flash=m_launches == zero and all(r["launches"] == zero for r in m_rows),
        mmlm_finite=bool(np.isfinite(m_losses).all()) and all(
            np.isfinite(m[k]) for m in mmlm_log for k in lang_keys if k in m),
        mmlm_lang_losses_logged=bool(lang_keys) and set(lang_keys) <= {"loss/en", "loss/fr"},
        mmlm_no_sync_per_quiet_step=all(r["iteration_syncs"] == 0 for r in m_quiet),
    )
    emit(phase="mmlm_trainer", card=card, gpu_state=gpu_state(), recipe="configs/train/mmlm.yaml",
         overrides=overrides["mmlm"], rows=MMLM_ROWS, seq_len=512, steps=MMLM_STEPS, dtype="bf16",
         vocab=trainer.trunk_config.vocab_size, losses=m_losses, lang_losses=[
             {k: m[k] for k in m if k.startswith("loss/")} for m in mmlm_log],
         launches=m_launches, peak_memory_gb=mmlm_peak_gb, run_seconds=m_seconds,
         step_ms_runs=[r["iteration_ms"] for r in m_rows],
         quiet_step_ms=float(np.median([r["iteration_ms"] for r in m_quiet])),
         syncs_per_quiet_step=[r["iteration_syncs"] for r in m_quiet])
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # -- GLUE -----------------------------------------------------------------
    recipe = bert_family_recipe("glue", overrides)
    torch.cuda.reset_peak_memory_stats()
    trainer, g_rows, g_seconds, g_launches, _ = run_chip_trainer(
        recipe, dev, chip_trainer_class(GlueTrainer, bert_tok, splits))
    glue_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    glue_log = logged("glue")
    g_losses = [r["loss"] for r in g_rows]
    steps_per_epoch = GLUE_TRAIN_ROWS // recipe["data_args"]["batch_size"]
    eval_batch = recipe["data_args"]["eval_batch_size"]
    n_eval_batches = -(-GLUE_VAL_ROWS // eval_batch)
    g_step_launches = {k: sum(r["launches"][k] for r in g_rows) for k in zero}
    g_eval_launches = {k: g_launches[k] - g_step_launches[k] for k in zero}
    g_evals = [m for m in glue_log if "glue_sst2/accuracy" in m]
    noisy = ({k for k in range(1, len(g_rows) + 1) if k % recipe["train_args"]["log_lr_every"] == 0}
             | {k for k in range(1, len(g_rows) + 1) if k % steps_per_epoch == 0})
    g_quiet = quiet_rows(g_rows, noisy)

    # the eval logits through the kernel against the plain path
    model, gcfg = trainer.model, trainer.trunk_config
    val = splits["sst2"]["validation"]
    model.eval()
    enc = [trainer.encode(val[list(range(i, min(i + eval_batch, len(val))))])
           for i in range(0, len(val), eval_batch)]
    reset_counts()
    lg_flash = np.concatenate([trainer.eval_logits(b) for b in enc])
    glue_logit_launches = read_counts()
    gcfg.attn_impl = "sdpa"
    lg_plain = np.concatenate([trainer.eval_logits(b) for b in enc])
    gcfg.attn_impl = "flash"
    x, y = lg_flash.astype(np.float64).ravel(), lg_plain.astype(np.float64).ravel()
    glue_cos = float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))
    argmax_share = float((lg_flash.argmax(-1) == lg_plain.argmax(-1)).mean())
    checks.update(
        glue_no_flash_in_training=all(r["launches"] == zero for r in g_rows),
        glue_eval_flash_launches=g_eval_launches == expect(fwd=n_layer * n_eval_batches * GLUE_EPOCHS)
        and glue_logit_launches == expect(fwd=n_layer * n_eval_batches),
        glue_finite=bool(np.isfinite(g_losses).all()) and len(g_evals) == GLUE_EPOCHS,
        glue_eval_logits_cosine_0_999=glue_cos >= 0.999,
        glue_eval_argmax_99_percent=argmax_share >= 0.99,
        glue_no_sync_per_quiet_step=all(r["iteration_syncs"] == 0 for r in g_quiet),
    )

    # the classifier's keep share: one train-mode forward of 13056 rows of 16 tokens
    model.train()
    cls_ids = torch.randint(1000, 2000, (13056, 16), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(5))
    with dropout_sites(stats), torch.no_grad():
        model(cls_ids, attention_mask=torch.ones_like(cls_ids), generator=torch.Generator(device=dev).manual_seed(6))
    emit(phase="glue_trainer", card=card, gpu_state=gpu_state(), recipe="configs/train/glue.yaml",
         overrides=overrides["glue"], train_rows=GLUE_TRAIN_ROWS, val_rows=GLUE_VAL_ROWS, epochs=GLUE_EPOCHS,
         seq_len=recipe["model_args"]["seq_len"], batch=recipe["data_args"]["batch_size"], eval_batch=eval_batch,
         dtype="bf16", losses=g_losses, evals=g_evals, eval_launches=g_eval_launches,
         eval_logits_cosine=glue_cos, eval_argmax_agreement=argmax_share, peak_memory_gb=glue_peak_gb,
         run_seconds=g_seconds, quiet_step_ms=float(np.median([r["iteration_ms"] for r in g_quiet])),
         step_ms_runs=[r["iteration_ms"] for r in g_rows],
         syncs_per_quiet_step=[r["iteration_syncs"] for r in g_quiet])
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()

    # -- dropout: each site's keep share and the scale of the kept values ------
    shares = {site: dict(draws=n, keep_share=float(kept.item()) / n) for site, (kept, n) in stats.items()}
    scale = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.ones(KEEP_DRAWS, dtype=dt, device=dev)
        y = drop.dropout(x, 0.1, torch.Generator(device=dev).manual_seed(7))
        kept = y != 0
        scale[str(dt)] = dict(keep_share=float(kept.float().mean().item()),
                              kept_values_are_1_over_0_9=bool((y[kept] == x[0] / 0.9).all().item()))
    sites = ("embedding", "residual_1", "residual_2", "attention", "classifier")
    checks["keep_share_per_site"] = all(
        site in shares and shares[site]["draws"] >= KEEP_DRAWS and abs(shares[site]["keep_share"] - 0.9) <= KEEP_BAND
        for site in sites) and set(shares) <= set(sites)
    checks["kept_scale_1_over_0_9"] = all(v["kept_values_are_1_over_0_9"] and abs(v["keep_share"] - 0.9) <= KEEP_BAND
                                          for v in scale.values())
    checks = {k: bool(v) for k, v in checks.items()}
    ok = all(checks.values())
    emit(phase="dropout_checks", keep_shares=shares, band=KEEP_BAND, min_draws=KEEP_DRAWS, scale=scale,
         checks=checks, ok=ok,
         note="keep shares per site from two train-mode forwards of the trained MLM model (4 x 2048) and one of "
              "the GLUE model at 13056 x 16 (the classifier); scale: dropout(ones) in fp32 and bf16")
    shutil.rmtree(root)
    if not ok:
        raise AssertionError(f"mlm_trainer: a check failed: {checks}")
    out.update(mlm_eval=mlm_eval_launches, mlm_eval_batches=n_val_batches,
               glue_eval=glue_logit_launches["fwd"], glue_eval_batches=n_eval_batches,
               mlm_micro_step_ms=mlm_ms)
    return out


def fused_encode(dev, card, model, tok, texts, e):
    """Phase fused_encode: the encode batch (256 texts of 512 tokens) through
    a BiEncoder with fused_rotary=True and the weights of `model` (rotary
    outside), whose embeddings of the same texts are e: 12 fused launches,
    cosine >= 0.999; then both models' forward at 256 x 512 timed in turns
    (CUDA events). Returns the launch counts."""
    import torch

    from contrastors_tpu_torch.eval.encoder import Encoder
    from contrastors_tpu_torch.models import BiEncoder
    from contrastors_tpu_torch.models.presets import nomic_bert_2048

    cfg = nomic_bert_2048(attn_impl="flash", fused_rotary=True)
    model_f = BiEncoder(cfg, pooling="mean", dtype=torch.bfloat16, device=dev)
    model_f.load_state_dict(model.state_dict())
    enc_f = Encoder(model_f, tok, seq_len=512, batch_size=256)
    enc_f.query_prefix = enc_f.document_prefix = None
    reset_counts()
    e_f = enc_f.encode(texts)
    launches = read_counts()
    cos_f = (e_f * e).sum(-1)
    gen = torch.Generator(device=dev).manual_seed(5)
    ids = torch.randint(1000, 30000, (256, 512), generator=gen, device=dev)
    full = torch.ones(256, 512, dtype=torch.int64, device=dev)
    fwd_ms = dict(fused=[], outside=[])
    with torch.inference_mode():
        runs = (("fused", model_f), ("outside", model))
        for i in range(4):
            for label, m in runs if i % 2 == 0 else runs[::-1]:
                fwd_ms[label].append(median_ms(lambda: m(ids, full, normalize=False), runs=3, warmup=1))
    ok = (launches == expect(fwd_rot=cfg.n_layer) and e_f.shape == e.shape
          and bool(np.isfinite(e_f).all()) and float(cos_f.min()) >= 0.999)
    emit(phase="fused_encode", card=card, batch=256, seq_len=512, launches=launches,
         expected_launches=expect(fwd_rot=cfg.n_layer), min_cosine_vs_outside=float(cos_f.min()),
         mean_cosine_vs_outside=float(cos_f.mean()), threshold=0.999,
         forward_ms={k: float(np.median(v)) for k, v in fwd_ms.items()}, forward_ms_runs=fwd_ms, ok=ok,
         note="forward_ms: the model's forward at 256 x 512, fused and outside rotation in turns")
    if not ok:
        raise AssertionError("fused-rotary encode: launch counts or agreement with the outside rotation failed")
    del model_f, enc_f
    torch.cuda.empty_cache()
    return launches


# -- the vision / LiT family (phase 19) ---------------------------------------
VISION_RECIPE = "nomic_embed_vision_v1.5"
EVA02 = "timm/vit_eva02_base_patch16_224"
VIT_B, VIT_S, VIT_IMG, CAPTION_LEN = 64, 197, 224, 77  # serving batch; 196 patches + cls; image side; seq_len
SERVING_COSINE = 0.999  # the kernel's embeddings against sdpa's in fp32
LIT_BATCH, LIT_STEPS, LIT_GC_BATCH, LIT_GC_CHUNK, LIT_GC_STEPS = 512, 8, 2048, 128, 3


def vit_attention_timing(dev, card, gen):
    """Phase vit_kernel_timing: the ViT's attention shape (B=64 S=T=197 H=12
    D=64, no mask) through the flash forward, dq and dk/dv, checked once
    more against the plain version, each as ms, device_ms and enqueue us
    beside its bound (`attention_bound`, `backward_bound` with no ids), the
    plain version and torch SDPA without a mask (forward; the backward as
    forward + backward minus forward). Returns {"fwd"|"dq"|"dkv": row}."""
    import torch
    import torch.nn.functional as F

    from contrastors_tpu_torch.ops import flash_attention as fa

    B, S, H, D = VIT_B, VIT_S, 12, 64
    q, k, v = make_qkv(gen, dev, B, S, S, H, H, D)
    scale = 1.0 / D**0.5
    out, lse = fa.flash_attention_fwd(q, k, v)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v)
    fwd_ratio = fa.output_error_ratio(out, ref_out)
    dout = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()
    refs = fa.flash_attention_backward_reference(q, k, v, out, lse, dout)
    grads = fa.flash_attention_backward(q, k, v, out, lse, dout)
    bwd_ratio = max(fa.grad_error_ratio(g, r, n) for g, r, n in zip(grads, refs, ("dq", "dk", "dv")))
    del ref_out, ref_lse, refs, grads
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = dout.transpose(1, 2)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(F.scaled_dot_product_attention(qt, kt, vt), (qt, kt, vt), dot)

    inputs = fa.prepare_backward(q, k, v, out, lse, dout, None, None)
    args = (False, 0, 0, scale)
    runs = dict(fwd=lambda: fa.flash_attention_fwd(q, k, v),
                dq=lambda: fa.launch_bwd_dq(*inputs, *args),
                dkv=lambda: fa.launch_bwd_dkv(*inputs, *args))
    plain = dict(fwd=lambda: fa.flash_attention_reference(q, k, v),
                 bwd=lambda: fa.flash_attention_backward_reference(q, k, v, out, lse, dout))
    lib_fwd, lib_fwd_dev = median_ms(sdpa_fwd), median_ms(sdpa_fwd, queued=True)
    lib_bwd = median_ms(sdpa_fwd_bwd) - lib_fwd
    lib_bwd_dev = median_ms(sdpa_fwd_bwd, queued=True) - lib_fwd_dev
    plain_fwd = median_ms(plain["fwd"], runs=3, warmup=1)
    plain_bwd = median_ms(plain["bwd"], runs=3, warmup=1)
    whole_bwd = lambda: fa.flash_attention_backward(q, k, v, out, lse, dout)  # noqa: E731
    rows = {}
    for kname, run in runs.items():
        if kname == "fwd":
            b_ms, b_by, flops, nbytes = attention_bound(B, S, S, H, H, D)
        else:
            b_ms, b_by, flops, nbytes = backward_bound(kname, B, S, S, H, H, D)
        k_ms, k_dev = median_ms(run), median_ms(run, queued=True)
        rows[kname] = dict(ms=k_ms, device_ms=k_dev, enqueue_us=host_enqueue_us(run), bound_ms=b_ms, bound_by=b_by,
                           flops=flops, bytes=nbytes, plain_ms=plain_fwd if kname == "fwd" else plain_bwd,
                           library_ms=lib_fwd if kname == "fwd" else lib_bwd,
                           library_device_ms=lib_fwd_dev if kname == "fwd" else lib_bwd_dev,
                           roofline_share=b_ms / k_ms, device_roofline_share=b_ms / k_dev,
                           err_over_tol=fwd_ratio if kname == "fwd" else bwd_ratio)
    rows["backward"] = dict(ms=median_ms(whole_bwd), device_ms=median_ms(whole_bwd, queued=True))
    emit(phase="vit_kernel_timing", card=card, gpu_state=gpu_state(), B=B, S=S, T=S, H=H, D=D, mask=None, **rows,
         note="dq and dkv: each kernel alone on prepared inputs (dq writes the delta dkv reads); plain_ms and "
              "library_ms of dq and dkv are whole backwards; library: torch SDPA without a mask")
    if fwd_ratio > 1.0 or bwd_ratio > 1.0:
        raise AssertionError("flash kernels disagree with their plain version at the ViT's shape")
    del q, k, v, out, lse, dout, qt, kt, vt, inputs
    torch.cuda.empty_cache()
    return rows


def lit_configs(impl="flash"):
    """The recipe's towers at full width: nomic-bert-2048's geometry for the
    text, EVA02-B/16 at 224 (2-D rope, SwiGLU 2048 with norm_mlp, no final
    LN) for the images."""
    from contrastors_tpu_torch.models.hf_interop_timm import timm_name_to_trunk_config
    from contrastors_tpu_torch.models.presets import nomic_bert_2048

    return nomic_bert_2048(attn_impl=impl), timm_name_to_trunk_config(EVA02, attn_impl=impl)


def caption_batch(tok, rng, n):
    """n stand-in captions of 5-76 words, tokenised to 77 ids (numpy)."""
    texts = [" ".join(map(str, rng.integers(1000, 30000, size=int(L)))) for L in rng.integers(5, 77, size=n)]
    enc = tok(texts, padding="max_length", truncation=True, max_length=CAPTION_LEN, return_tensors="np")
    return enc["input_ids"], enc["attention_mask"]


def normalised(px_u8):
    """uint8 pixels on the card -> fp32 with the OpenAI mean / std, as the
    trainer normalises them."""
    import torch

    from contrastors_tpu_torch.config import OPENAI_IMAGE_MEAN, OPENAI_IMAGE_STD

    mean = torch.tensor(OPENAI_IMAGE_MEAN, device=px_u8.device).reshape(3, 1, 1)
    std = torch.tensor(OPENAI_IMAGE_STD, device=px_u8.device).reshape(3, 1, 1)
    return (px_u8.float() / 255.0 - mean) / std


def vision_serving(dev, card, tok, gen):
    """Phase vision_main_path: a full-width DualEncoder in bf16 with seed
    weights encodes 256 images (4 batches of 64, uniform noise from their
    own seed) and 256 captions (one batch of 77 tokens, hamming LN) with
    encode_image / encode_text: 12 flash launches per tower forward,
    embeddings finite and unit-norm, and through the kernel against the
    same weights under attn_impl="sdpa" in fp32 at cosine >= 0.999; the
    cosines of bf16 sdpa to fp32 and of the kernel to bf16 sdpa are read
    beside it. Images/s and captions/s, median of 5 host-clock runs.
    Returns (launches per image forward, per text forward, the timings)."""
    import torch

    from contrastors_tpu_torch.models import BiEncoder, DualEncoder, init_weights

    text_cfg, vis_cfg = lit_configs()
    dual = DualEncoder(text_cfg, vis_cfg, text_hamming=True, dtype=torch.bfloat16, device=dev).eval()
    init_weights(dual.text, 0)
    init_weights(dual.vision, 1)
    n_params = dict(text=sum(p.numel() for p in dual.text.parameters()),
                    vision=sum(p.numel() for p in dual.vision.parameters()))
    px = normalised(torch.randint(0, 256, (256, 3, VIT_IMG, VIT_IMG), device=dev, dtype=torch.uint8,
                                  generator=torch.Generator(device=dev).manual_seed(19)))
    ids, mask = (torch.from_numpy(a).to(dev) for a in caption_batch(tok, np.random.default_rng(5), 256))

    def images(model):
        with torch.inference_mode():
            return torch.cat([model(px[i:i + VIT_B]) for i in range(0, 256, VIT_B)]).float()

    def captions():
        with torch.inference_mode():
            return dual.encode_text(ids, mask).float()

    reset_counts()
    images(dual.encode_image)
    per_image_fwd = read_counts()["fwd"] / (256 // VIT_B)
    reset_counts()
    t_emb = captions()
    per_text_fwd = read_counts()["fwd"]
    img_emb = images(dual.encode_image)
    # the same weights with attn_impl="sdpa", in bf16 and in fp32
    refs = {}
    for dtype in (torch.bfloat16, torch.float32):
        vis = BiEncoder(vis_cfg.replace(attn_impl="sdpa"), trunk_type="vision", pooling="map", dtype=dtype,
                        device=dev).eval()
        vis.load_state_dict(dual.vision.state_dict())
        txt = BiEncoder(text_cfg.replace(attn_impl="sdpa"), hamming=True, dtype=dtype, device=dev).eval()
        txt.load_state_dict(dual.text.state_dict())
        with torch.inference_mode():
            refs[dtype] = (images(lambda x, m=vis: m(pixel_values=x.to(dtype))["embedding"]),
                           txt(ids, mask)["embedding"].float())
        del vis, txt

    def min_cos(a, b):
        return float((a * b).sum(-1).min())

    fp32_img, fp32_txt = refs[torch.float32]
    agreement = dict(
        image_kernel_vs_sdpa_bf16=min_cos(img_emb, refs[torch.bfloat16][0]),
        text_kernel_vs_sdpa_bf16=min_cos(t_emb, refs[torch.bfloat16][1]),
        image_kernel_vs_sdpa_fp32=min_cos(img_emb, fp32_img), text_kernel_vs_sdpa_fp32=min_cos(t_emb, fp32_txt),
        image_sdpa_bf16_vs_fp32=min_cos(refs[torch.bfloat16][0], fp32_img),
        text_sdpa_bf16_vs_fp32=min_cos(refs[torch.bfloat16][1], fp32_txt))
    # the gate's reference is sdpa in fp32: against bf16 sdpa the kernel's
    # cosine holds two bf16 roundings, each ~0.9993 from fp32 at random init
    cos_img, cos_txt = agreement["image_kernel_vs_sdpa_fp32"], agreement["text_kernel_vs_sdpa_fp32"]
    del refs

    def host_ms(fn, runs=5):
        times = []
        for _ in range(runs + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times[1:]))

    img_ms, txt_ms = host_ms(lambda: images(dual.encode_image)), host_ms(captions)
    norms = img_emb.norm(dim=-1)
    ok = (per_image_fwd == vis_cfg.n_layer and per_text_fwd == text_cfg.n_layer
          and bool(torch.isfinite(img_emb).all()) and bool(torch.isfinite(t_emb).all())
          and float((norms - 1).abs().max()) < 1e-2 and min(cos_img, cos_txt) >= SERVING_COSINE)
    timing = dict(images_ms=img_ms, images_per_s=256 / img_ms * 1e3, captions_ms=txt_ms,
                  captions_per_s=256 / txt_ms * 1e3)
    emit(phase="vision_main_path", card=card, gpu_state=gpu_state(), params=n_params, images=256,
         image_batch=VIT_B, captions=256, caption_len=CAPTION_LEN, flash_per_image_forward=per_image_fwd,
         flash_per_text_forward=per_text_fwd, min_cosine=agreement, threshold=SERVING_COSINE, max_norm_dev=float((norms - 1).abs().max()), **timing, ok=ok)
    if not ok:
        raise AssertionError("vision serving: launches, finiteness, norms or agreement with sdpa failed")
    del dual, px
    torch.cuda.empty_cache()
    return per_image_fwd, per_text_fwd, timing


def lit_inputs(root, seed=0):
    """The text tower's config.json (nomic-bert-2048's public one; random
    weights), two in-memory batches of LIT_BATCH and one of LIT_GC_BATCH
    uint8 images with their stand-in captions, one batch of LIT_BATCH
    uniform-noise images, and 4 zero-shot eval batches of 64 normalised
    images with labels. A training image is a colour of its own plus noise
    (+-24), so that images differ in content and the model has something
    to learn; uniform noise alone makes every image's embedding nearly the
    same at random init (the cls token averages 196 noise patches)."""
    from contrastors_tpu_torch.eval.stub_tokenizer import StubTokenizer

    text_dir = os.path.join(root, "nomic-bert-2048")
    os.makedirs(text_dir)
    with open(os.path.join(text_dir, "config.json"), "w") as f:
        json.dump(NOMIC_BERT_2048_CONFIG, f)
    rng = np.random.default_rng(seed)
    tok = StubTokenizer(NOMIC_BERT_2048_CONFIG["vocab_size"])

    def batch(n, noise_only=False):
        ids, mask = caption_batch(tok, rng, n)
        if noise_only:
            px = rng.integers(0, 256, size=(n, 3, VIT_IMG, VIT_IMG), dtype=np.uint8)
        else:
            colour = rng.integers(24, 232, size=(n, 3, 1, 1), dtype=np.int16)
            px = (colour + rng.integers(-24, 25, size=(n, 3, VIT_IMG, VIT_IMG), dtype=np.int16)).astype(np.uint8)
        return dict(pixel_values=px, input_ids=ids, attention_mask=mask)

    evals = [dict(pixel_values=rng.normal(size=(64, 3, VIT_IMG, VIT_IMG)).astype(np.float32),
                  labels=rng.integers(0, 1000, size=64).astype(np.int32)) for _ in range(4)]
    return (text_dir, tok, [batch(LIT_BATCH), batch(LIT_BATCH)], [batch(LIT_GC_BATCH)],
            batch(LIT_BATCH, noise_only=True), evals)


def lit_recipe(text_dir, out_dir, grad_cache=False):
    """configs/train/nomic_embed_vision_v1.5.yaml through the port's
    read_config, cut in batch (16384 -> 512, or 2048 with grad cache), data
    (in memory, through the hooks), steps (8, or 3), warmup (2000 -> 2) and
    cadence (log every 4, the eval at the last step, no save before the
    end); both towers pretrained: false (no checkpoint in the repo), remat on
    as the recipe sets it."""
    from contrastors_tpu_torch.read import read_config

    raw = read_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "train",
                                   f"{VISION_RECIPE}.yaml")).to_dict()
    steps = LIT_GC_STEPS if grad_cache else LIT_STEPS
    raw["train_args"].update(num_train_steps=steps, warmup_steps=2, log_lr_every=4, eval_steps=steps,
                             output_dir=out_dir)
    if grad_cache:
        raw["train_args"].update(grad_cache=True, chunk_size=LIT_GC_CHUNK)
    raw["text_model_args"].update(model_name=text_dir, pretrained=False)
    raw["vision_model_args"].update(pretrained=False)
    raw["data_args"].update(batch_size=LIT_GC_BATCH if grad_cache else LIT_BATCH, imagenet_val_path="in-memory")
    return raw


def lit_trainer_class(tok, batches, evals):
    """The phase's ImageTextTrainer: the stand-in tokenizer, in-memory batches
    (`get_dataloaders`) and eval batches (`imagenet_batches`), each loop
    step recorded (`chip_trainer_class`), and the eval's flash launches."""
    from contrastors_tpu_torch.trainers import ImageTextTrainer

    class LitChipTrainer(chip_trainer_class(ImageTextTrainer, tok)):
        def get_dataloaders(self):
            return batches, len(batches)

        def imagenet_batches(self):
            return iter(evals)

        def eval_loop(self, step):
            before = read_counts()
            metrics = super().eval_loop(step)
            after = read_counts()
            self.eval_launches = {k: after[k] - before[k] for k in after}
            return metrics

    return LitChipTrainer


def lit_step_grads(trainer, batch, rolled_replay=False):
    """The gradients of one step of the trainer's own train step on `batch`
    (device tensors), its optimizer update and scheduler step stubbed out so
    that the weights stay as they were. rolled_replay plants a fault: grad
    cache's pass 2 replays each image chunk with its rows rotated by one."""
    import torch

    opt, sched = trainer.optimizer, trainer.scheduler
    opt.step, sched.step = (lambda *a, **k: None), (lambda *a, **k: None)
    if rolled_replay:
        pixels = trainer.pixels
        trainer.pixels = lambda px: pixels(px.roll(1, 0) if torch.is_grad_enabled() else px)
    try:
        trainer.make_train_step()(batch, torch.Generator().manual_seed(0))
        return {n: p.grad.float().clone() for n, p in trainer.dual.named_parameters() if p.grad is not None}
    finally:
        del opt.step, sched.step
        if rolled_replay:
            del trainer.pixels


def lit_fp32_agreement(dual, batch):
    """Grad cache (chunk LIT_GC_CHUNK) against the standard step's gradients
    for a copy of `dual` computing in fp32 with sdpa (the flash kernels take
    bf16 only), on `batch` (device tensors, uint8 pixels)."""
    import torch

    from contrastors_tpu_torch.grad_cache import grad_cache_loss_and_grads
    from contrastors_tpu_torch.losses import clip_loss_symmetric
    from contrastors_tpu_torch.models import DualEncoder

    t, v = dual.text, dual.vision
    ref_dual = DualEncoder(t.config.replace(attn_impl="sdpa"), v.config.replace(attn_impl="sdpa"), text_hamming=True,
                           dtype=torch.float32, device=batch["input_ids"].device, remat=True)
    ref_dual.load_state_dict(dual.state_dict())
    for p in ref_dual.text.parameters():
        p.requires_grad_(False)
    px = normalised(batch["pixel_values"])

    def grads():
        out = {n: p.grad.clone() for n, p in ref_dual.named_parameters() if p.grad is not None}
        ref_dual.zero_grad(set_to_none=True)
        return out

    ref_dual(batch["input_ids"], batch["attention_mask"], px)["loss"].backward()
    standard = grads()
    grad_cache_loss_and_grads(
        ref_dual, {"pixel_values": px}, {k: batch[k] for k in ("input_ids", "attention_mask")},
        lambda m, b, g: {"embedding": m.encode_image(b["pixel_values"])},
        lambda m, b, g: {"embedding": m.encode_text(b["input_ids"], b["attention_mask"])},
        clip_loss_symmetric, chunk_size=LIT_GC_CHUNK, d_trainable=False, extra_params=ref_dual.logit_scale)
    cached = grads()
    del ref_dual
    torch.cuda.empty_cache()
    return flat_agreement(cached, standard)


def flat_agreement(got, ref):
    """Cosine and relative L2 of all gradients together, beside the worst tensor's."""
    import torch

    x = torch.cat([got[n].flatten() for n in ref]).double()
    y = torch.cat([ref[n].flatten() for n in ref]).double()
    return dict(cosine=float(x @ y / (x.norm() * y.norm())), rel_l2=float((x - y).norm() / y.norm()),
                **compare_grads(got, ref))


def vision_phase(dev, card):
    """Phase 19, lit_trainer and lit_grad_cache: the vision recipe through
    read_config and train.run (ImageTextTrainer -> DualEncoder: the frozen
    text tower, EVA02 with remat, MAP pooling, clip_loss_symmetric, AdamW),
    8 steps at 512 and then 3 grad-cache steps at 2048 (chunk 128), bf16.
    Gates: flash launches per step as the code predicts them (standard:
    text 12 + vision 12 + the remat replay 12 forwards, 12 dq, 12 dk/dv;
    grad cache per chunk: pass 1 text 12 and vision 12, pass 2 vision 12 +
    remat 12 forwards, 12 dq, 12 dk/dv), the loss falling, the logit scale
    moving, every text parameter bit-identical to its start, 0 synchronising
    calls per quiet step, the eval's flash launches (12 per text batch of
    the 8000 prompts, 12 per image batch) and finite accuracies; then grad
    cache against the standard step on one batch of 512 (cosine >= 0.9999,
    relative L2 <= 0.01, all gradients together), a planted rolled replay
    outside both bounds; read beside it, the same on uniform-noise images,
    in bf16 and in fp32. One standard step is profiled (busy time by
    kernel group). Returns the launches and timings."""
    import gc
    import shutil
    import tempfile

    import torch

    root = tempfile.mkdtemp(prefix="chip_smoke_vision_")
    try:
        text_dir, tok, batches, gc_batches, noise_batch, evals = lit_inputs(root)
        text_cfg, vis_cfg = lit_configs()
        L = vis_cfg.n_layer
        n_chunks = LIT_GC_BATCH // LIT_GC_CHUNK
        n_eval_text = -(-8 * 1000 // 256)
        predicted = dict(standard=expect(fwd=3 * L, dq=L, dkv=L),
                         grad_cache=expect(fwd=4 * L * n_chunks, dq=L * n_chunks, dkv=L * n_chunks),
                         eval=expect(fwd=L * n_eval_text + L * len(evals)))
        out, checks, trainers = {}, {}, {}
        for name, gc_on, data in (("standard", False, batches), ("grad_cache", True, gc_batches)):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            recipe = lit_recipe(text_dir, os.path.join(root, name), grad_cache=gc_on)
            cls = lit_trainer_class(tok, data, evals)
            # the text tower's start, before any step
            start = {}

            class Snap(cls):
                def get_model(self):
                    model = super().get_model()
                    start.update({k: v.detach().clone() for k, v in model.text.state_dict().items()})
                    return model

            trainer, rows, seconds, launches, syncs = run_chip_trainer(recipe, dev, Snap)
            peak_gb = torch.cuda.max_memory_allocated() / 2**30
            steps = len(rows)
            noisy = {s for s in range(1, steps + 1) if s % 4 == 0} | {steps}
            quiet = quiet_rows(rows, noisy)
            losses = [r["loss"] for r in rows]
            scale = float(trainer.dual.logit_scale.logit_scale.detach().exp())
            text_same = all(torch.equal(v, start[k]) for k, v in trainer.dual.text.state_dict().items())
            metrics = [json.loads(line) for line in open(os.path.join(root, name, "metrics.jsonl"))]
            evals_logged = [m for m in metrics if "imagenet_zeroshot_top1" in m]
            eval_ok = (len(evals_logged) == 1 and 0.0 <= evals_logged[0]["imagenet_zeroshot_top1"]
                       <= evals_logged[0]["imagenet_zeroshot_top5"] <= 1.0)
            row = dict(
                launches_per_step=rows[0]["launches"], predicted_per_step=predicted[name],
                eval_launches=trainer.eval_launches, predicted_eval=predicted["eval"], losses=losses,
                logit_scale=scale, peak_gb=peak_gb, seconds=seconds,
                quiet_step_ms=float(np.median([r["iteration_ms"] for r in quiet])) if quiet else None,
                syncs_per_quiet_step=[r["iteration_syncs"] for r in quiet], eval=evals_logged[-1] if evals_logged
                else None)
            row["images_per_s"] = (len(data[0]["pixel_values"]) / row["quiet_step_ms"] * 1e3
                                   if row["quiet_step_ms"] else None)
            checks.update({
                f"{name}_launches": all(r["launches"] == predicted[name] for r in rows),
                f"{name}_finite": bool(np.isfinite(losses).all()),
                f"{name}_logit_scale_moves": abs(scale - 1 / 0.07) > 1e-3,
                f"{name}_text_bit_identical": text_same,
                f"{name}_no_sync_per_quiet_step": all(r["iteration_syncs"] == 0 for r in quiet),
                f"{name}_eval_launches": trainer.eval_launches == predicted["eval"],
                f"{name}_eval_finite": eval_ok,
            })
            if name == "standard":  # the mean of the last two steps below that of the first two
                checks["standard_loss_falls"] = float(np.mean(losses[-2:])) < float(np.mean(losses[:2]))
            emit(phase=f"lit_{name}", card=card, gpu_state=gpu_state(), batch=len(data[0]["pixel_values"]),
                 chunk=LIT_GC_CHUNK if gc_on else None, steps=steps, **row,
                 first_syncs=syncs[:3], ok=all(v for k, v in checks.items() if k.startswith(name)))
            out[name] = row
            trainers[name] = trainer
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)

        # one profiled standard step: device busy time by kernel group, idle share
        std, gcache = trainers["standard"], trainers["grad_cache"]
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batches[0].items()}
        step = std.make_train_step()
        step(batch, torch.Generator().manual_seed(1))
        prof = profile_step(lambda: step(batch, torch.Generator().manual_seed(2)), out["standard"]["quiet_step_ms"],
                            phases=STD_PHASES)
        emit(phase="lit_profile", card=card, gpu_state=gpu_state(), batch=LIT_BATCH, **prof)
        out["standard"]["profile"] = {k: prof[k] for k in ("device_busy_ms", "idle_share_of_step", "by_group")}

        # grad cache against the standard step, on one batch of 512 and the same weights
        gcache.dual.load_state_dict(std.dual.state_dict())
        ref = lit_step_grads(std, batch)
        sound = flat_agreement(lit_step_grads(gcache, batch), ref)
        fault = flat_agreement(lit_step_grads(gcache, batch, rolled_replay=True), ref)
        checks["grad_cache_vs_standard"] = sound["cosine"] >= 0.9999 and sound["rel_l2"] <= 0.01
        checks["rolled_replay_outside"] = fault["cosine"] < 0.9999 and fault["rel_l2"] > 0.01
        emit(phase="lit_grad_agreement", batch=LIT_BATCH, chunk=LIT_GC_CHUNK, sound=sound, rolled_replay=fault,
             bounds=dict(cosine=0.9999, rel_l2=0.01), ok=checks["grad_cache_vs_standard"]
             and checks["rolled_replay_outside"])
        # read beside it, not bounded: the same two steps on uniform-noise
        # images, in bf16 through the trainers and in fp32 (sdpa) outside them
        noise = {k: torch.from_numpy(v).to(dev) for k, v in noise_batch.items()}
        noise_bf16 = flat_agreement(lit_step_grads(gcache, noise), lit_step_grads(std, noise))
        noise_fp32 = lit_fp32_agreement(std.dual, noise)
        emit(phase="lit_grad_margin_reading", batch=LIT_BATCH, chunk=LIT_GC_CHUNK, noise_images_bf16=noise_bf16,
             noise_images_fp32_sdpa=noise_fp32, note="grad cache against the standard step on uniform-noise "
             "images: the trainers' bf16 steps, and both computed in fp32 with sdpa on the same weights")
        out["grad_agreement"] = dict(sound=sound, rolled_replay=fault, noise_images_bf16=noise_bf16,
                                     noise_images_fp32_sdpa=noise_fp32)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(phase="vision_trainer", card=card, checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise AssertionError(f"vision phase gates failed: {[k for k, v in checks.items() if not v]}")
    del trainers, std, gcache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def vision_family(dev, card, gen):
    """Phase 19 whole: the ViT attention timing, serving and training."""
    from contrastors_tpu_torch.eval.stub_tokenizer import StubTokenizer

    timing = vit_attention_timing(dev, card, gen)
    per_image, per_text, serving = vision_serving(dev, card, StubTokenizer(NOMIC_BERT_2048_CONFIG["vocab_size"]),
                                                  gen)
    training = vision_phase(dev, card)
    return dict(kernels=timing, serving=dict(serving, flash_per_image_forward=per_image,
                                             flash_per_text_forward=per_text), training=training)


# -- phase 20: the families of configs/train/ that no earlier phase drives ----

# answerdotai/ModernBERT-base's config.json (the fields the loader reads)
MODERNBERT_BASE_CONFIG = {
    "model_type": "modernbert", "architectures": ["ModernBertForMaskedLM"], "vocab_size": 50368,
    "hidden_size": 768, "num_hidden_layers": 22, "num_attention_heads": 12, "intermediate_size": 1152,
    "hidden_activation": "gelu", "max_position_embeddings": 8192, "norm_eps": 1e-5, "norm_bias": False,
    "global_rope_theta": 160000.0, "local_rope_theta": 10000.0, "local_attention": 128,
    "global_attn_every_n_layers": 3, "attention_bias": False, "mlp_bias": False, "pad_token_id": 50283,
    "embedding_dropout": 0.0, "mlp_dropout": 0.0, "attention_dropout": 0.0, "initializer_range": 0.02,
}
# EleutherAI/pythia-160m's config.json
PYTHIA_160M_CONFIG = {
    "model_type": "gpt_neox", "architectures": ["GPTNeoXForCausalLM"], "vocab_size": 50304, "hidden_size": 768,
    "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072, "hidden_act": "gelu",
    "rotary_pct": 0.25, "rotary_emb_base": 10000, "use_parallel_residual": True, "layer_norm_eps": 1e-5,
    "max_position_embeddings": 2048, "initializer_range": 0.02, "tie_word_embeddings": False,
    "bos_token_id": 0, "eos_token_id": 0,
}
FAMILY_STEPS, FAMILY_LOG_EVERY = 6, 3
# per family: (recipe, batch as run, the recipe's batch, negatives, query / document tokens)
FAMILIES = {
    "modernbert": ("contrastive_finetune_modernbert", 8, 256, 7, 512, 512),
    "moe": ("contrastive_finetune_moe", 32, 256, 7, 32, 256),
    "distill": ("distill", 256, 256, 0, 32, 256),
    "pythia": ("contrastive_finetune_decoder", 64, 128, 7, 128, 128),
}


def _hf_shapes(family, cfg):
    """{HF name: shape} of a family's checkpoint, under the names the loaders
    read (ModernBERT and GPT-NeoX without their "model." / "gpt_neox."
    prefix, which the remaps strip; nomic-bert in its flash layout)."""
    if family == "modernbert":
        D, F = cfg["hidden_size"], cfg["intermediate_size"]
        shapes = {"embeddings.tok_embeddings.weight": (cfg["vocab_size"], D), "embeddings.norm.weight": (D,),
                  "final_norm.weight": (D,)}
        for i in range(cfg["num_hidden_layers"]):
            p = f"layers.{i}."
            shapes.update({p + "attn.Wqkv.weight": (3 * D, D), p + "attn.Wo.weight": (D, D),
                           p + "mlp_norm.weight": (D,), p + "mlp.Wi.weight": (2 * F, D), p + "mlp.Wo.weight": (D, F)})
            if i:
                shapes[p + "attn_norm.weight"] = (D,)
        return shapes
    if family == "pythia":
        D, F = cfg["hidden_size"], cfg["intermediate_size"]
        shapes = {"embed_in.weight": (cfg["vocab_size"], D), "final_layer_norm.weight": (D,),
                  "final_layer_norm.bias": (D,)}
        for i in range(cfg["num_hidden_layers"]):
            p = f"layers.{i}."
            for n, shp in (("input_layernorm", (D,)), ("post_attention_layernorm", (D,))):
                shapes.update({p + n + ".weight": shp, p + n + ".bias": shp})
            shapes.update({p + "attention.query_key_value.weight": (3 * D, D),
                           p + "attention.query_key_value.bias": (3 * D,), p + "attention.dense.weight": (D, D),
                           p + "attention.dense.bias": (D,), p + "mlp.dense_h_to_4h.weight": (F, D),
                           p + "mlp.dense_h_to_4h.bias": (F,), p + "mlp.dense_4h_to_h.weight": (D, F),
                           p + "mlp.dense_4h_to_h.bias": (D,)})
        return shapes
    D, F = cfg["n_embd"], cfg["n_inner"]  # nomic-bert
    shapes = {"embeddings.word_embeddings.weight": (cfg["vocab_size"], D),
              "embeddings.token_type_embeddings.weight": (cfg["type_vocab_size"], D), "emb_ln.weight": (D,),
              "emb_ln.bias": (D,)}
    for i in range(cfg["n_layer"]):
        p = f"encoder.layers.{i}."
        shapes.update({p + "attn.Wqkv.weight": (3 * D, D), p + "attn.out_proj.weight": (D, D),
                       p + "mlp.fc11.weight": (F, D), p + "mlp.fc12.weight": (F, D), p + "mlp.fc2.weight": (D, F),
                       p + "norm1.weight": (D,), p + "norm1.bias": (D,), p + "norm2.weight": (D,),
                       p + "norm2.bias": (D,)})
    return shapes


def write_family_checkpoint(path, family, cfg, seed, weights=True):
    """config.json and, with weights, pytorch_model.bin (torch.save) of
    seeded random weights under the HF names: N(0, 0.02) matrices and
    embeddings, norm scales 1, biases 0. Returns the state dict written."""
    import torch

    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    if not weights:
        return None
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, shape in _hf_shapes(family, cfg).items():
        if name.endswith("bias"):
            sd[name] = torch.zeros(shape)
        elif len(shape) == 1:
            sd[name] = torch.ones(shape)
        else:
            sd[name] = torch.randn(shape, generator=gen) * 0.02
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    return sd


def family_batch(rng, vocab, B, negatives, q_len, d_len):
    """One in-memory host batch of the text trainers: B queries and
    B * (1 + negatives) documents, padded right with random lengths (the
    first row of each full); document i * (1 + negatives) is query i's
    positive and starts with its first 8 tokens (a signal the model can
    learn, not one that separates the batch at random init), the others
    are random."""
    docs = B * (1 + negatives)

    def rows(n, L, lo):
        lens = rng.integers(lo, L + 1, size=n)
        lens[0] = L
        ids = rng.integers(1000, vocab - 1000, size=(n, L))
        mask = (np.arange(L)[None] < lens[:, None]).astype(np.int64)
        return ids * mask, mask, lens

    q_ids, q_mask, q_lens = rows(B, q_len, max(2, q_len // 2))
    d_ids, d_mask, _ = rows(docs, d_len, max(2, d_len // 4))
    for i in range(B):
        n = min(q_lens[i], d_len, 8)
        d_ids[i * (1 + negatives), :n] = q_ids[i, :n]
        d_mask[i * (1 + negatives), :n] = 1
    return dict(query_input_ids=q_ids, query_attention_mask=q_mask, document_input_ids=d_ids,
                document_attention_mask=d_mask)


def family_recipe(family, model_dir, out_dir, teacher_dir=None):
    """The family's recipe through the port's read_config, cut in batch,
    steps (FAMILY_STEPS), warmup (2) and cadence (log every
    FAMILY_LOG_EVERY); its model a local directory."""
    from contrastors_tpu_torch.read import read_config

    name, batch = FAMILIES[family][:2]
    raw = read_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "train",
                                   f"{name}.yaml")).to_dict()
    raw["train_args"].update(num_train_steps=FAMILY_STEPS, warmup_steps=2, log_lr_every=FAMILY_LOG_EVERY,
                             output_dir=out_dir)
    raw["model_args"]["model_name"] = model_dir
    if teacher_dir:
        raw["tower_model_args"]["model_name"] = teacher_dir
    raw["data_args"]["batch_size"] = batch
    return raw


def family_serving(dev, card, family, model_dir, seq_len, pooling):
    """`load_biencoder` of the family's checkpoint (bf16, attn_impl flash)
    encodes 256 texts of random lengths padded to seq_len, one batch,
    through the port's Encoder: n_layer flash
    forwards a batch, finite unit-norm embeddings, cosine >= 0.999 against
    the same checkpoint under attn_impl="sdpa" in fp32; texts/s."""
    import torch

    from contrastors_tpu_torch.config import ModelArgs
    from contrastors_tpu_torch.eval.encoder import Encoder
    from contrastors_tpu_torch.eval.stub_tokenizer import StubTokenizer
    from contrastors_tpu_torch.models.auto import load_biencoder

    args = dict(model_type="encoder", model_name=model_dir, pooling=pooling, pretrained=True, attn_impl="flash")
    model, cfg = load_biencoder(ModelArgs.from_dict(args), dtype=torch.bfloat16, device=dev)
    tok = StubTokenizer(cfg.vocab_size)
    texts = make_texts(np.random.default_rng(7), 256, 8, seq_len - 2, lognormal=False)

    def encoder(m):
        enc = Encoder(m.eval(), tok, seq_len=seq_len, batch_size=256, bucketed=False)
        enc.query_prefix = enc.document_prefix = None
        return enc

    enc = encoder(model)
    reset_counts()
    emb = enc.encode(texts)
    launches = read_counts()
    ref_model, _ = load_biencoder(ModelArgs.from_dict(dict(args, attn_impl="sdpa")), dtype=torch.float32,
                                  device=dev)
    ref = encoder(ref_model).encode(texts)
    del ref_model
    cos = float((emb * ref).sum(-1).min())
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        enc.encode(texts)
        times.append((time.perf_counter() - t0) * 1e3)
    norms = np.linalg.norm(emb, axis=-1)
    ok = (launches == expect(fwd=cfg.n_layer) and emb.shape == (256, cfg.n_embd) and bool(np.isfinite(emb).all())
          and float(np.abs(norms - 1).max()) < 1e-2 and cos >= SERVING_COSINE)
    row = dict(texts=256, seq_len=seq_len, pooling=pooling, launches_per_batch=launches, min_cosine_vs_sdpa_fp32=cos,
               encode_ms=float(np.median(times[1:])), texts_per_s=256 / float(np.median(times[1:])) * 1e3)
    emit(phase=f"{family}_serving", card=card, gpu_state=gpu_state(),
         params=sum(p.numel() for p in model.parameters()), n_layer=cfg.n_layer, **row, threshold=SERVING_COSINE,
         ok=ok)
    del model, enc
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"{family} serving: launches, finiteness, norms or agreement with sdpa failed")
    return row


def family_training(dev, card, family, model_dir, teacher_dir=None, dense_sd=None):
    """The family's recipe through train.run (`family_recipe`), one
    in-memory batch repeated: flash (and gmm / tgmm) launches per step as
    predicted, finite losses, the mean of the last two below that of the
    first two, 0 synchronising calls per quiet step; with dense_sd (the
    upcycled MoE) every expert of an MoE layer the dense MLP bit for bit
    after the load; distill: student layer i the teacher's layer 2i bit
    for bit after the init, and the teacher unchanged by the steps. Returns
    the row."""
    import gc
    import shutil
    import tempfile

    import torch

    from contrastors_tpu_torch.eval.stub_tokenizer import StubTokenizer
    from contrastors_tpu_torch.models.nomic_bert import _layer_is_moe
    from contrastors_tpu_torch.trainers import DistillTrainer, TextTextTrainer

    name, batch, recipe_batch, negatives, q_len, d_len = FAMILIES[family]
    out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{family}_")
    raw = family_recipe(family, model_dir, out_dir, teacher_dir)
    vocab = {"modernbert": MODERNBERT_BASE_CONFIG, "pythia": PYTHIA_160M_CONFIG}.get(
        family, NOMIC_BERT_2048_CONFIG)
    vocab = vocab.get("vocab_size")
    host = [family_batch(np.random.default_rng(11), vocab, batch, negatives, q_len, d_len)]
    base = DistillTrainer if family == "distill" else TextTextTrainer
    checks = {}

    class FamilyTrainer(chip_trainer_class(base, StubTokenizer(vocab))):
        def get_dataloaders(self):
            return host, len(host)

        def get_model(self):
            model = super().get_model()
            trunk = self.biencoder.trunk.state_dict()
            if dense_sd is not None:
                moe_layers = [i for i in range(self.trunk_config.n_layer) if _layer_is_moe(self.trunk_config, i)]
                checks["experts_equal_dense_mlp"] = all(
                    torch.equal(trunk[f"layers.{i}.mlp.{ours}"][e].to("cpu"), dense_sd[
                        f"encoder.layers.{i}.mlp.{theirs}.weight"].t())
                    for i in moe_layers for e in range(self.trunk_config.num_experts)
                    for ours, theirs in (("w_up", "fc11"), ("w_gate", "fc12")))
                checks["experts_equal_dense_mlp"] &= all(
                    torch.equal(trunk[f"layers.{i}.mlp.w_down"][e].to("cpu"),
                                dense_sd[f"encoder.layers.{i}.mlp.fc2.weight"].t())
                    for i in moe_layers for e in range(self.trunk_config.num_experts))
            if family == "distill":
                teacher = self.teacher.trunk.state_dict()
                checks["student_layer_i_is_teacher_layer_2i"] = all(
                    torch.equal(v, teacher[re.sub(r"^layers\.(\d+)\.", lambda m: f"layers.{2 * int(m[1])}.", k)])
                    for k, v in trunk.items())
                self.teacher_start = {k: v.clone() for k, v in self.teacher.state_dict().items()}
            return model

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    allocated_before_gb = torch.cuda.memory_allocated() / 2**30
    try:
        trainer, rows, seconds, launches, syncs = run_chip_trainer(raw, dev, FamilyTrainer)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    cfg = trainer.trunk_config
    L = cfg.n_layer
    if family == "moe":
        n_moe = sum(1 for i in range(L) if _layer_is_moe(cfg, i))
        predicted = expect(fwd=2 * L, dq=2 * L, dkv=2 * L, gmm=2 * 6 * n_moe, tgmm=2 * 3 * n_moe)
    elif family == "distill":
        predicted = expect(fwd=2 * L + 2 * len(trainer.teacher.trunk.layers), dq=2 * L, dkv=2 * L)
    else:
        predicted = expect(fwd=2 * L, dq=2 * L, dkv=2 * L)
    noisy = {s for s in range(1, len(rows) + 1) if s % FAMILY_LOG_EVERY == 0} | {len(rows)}
    quiet = quiet_rows(rows, noisy)
    losses = [r["loss"] for r in rows]
    checks.update(
        launches=all(r["launches"] == predicted for r in rows), finite=bool(np.isfinite(losses).all()),
        loss_falls=float(np.mean(losses[-2:])) < float(np.mean(losses[:2])),
        no_sync_per_quiet_step=bool(quiet) and all(r["iteration_syncs"] == 0 for r in quiet))
    if family == "distill":
        checks["teacher_unchanged"] = all(torch.equal(v, trainer.teacher_start[k])
                                          for k, v in trainer.teacher.state_dict().items())
    row = dict(recipe=f"configs/train/{name}.yaml", n_layer=L, launches_per_step=rows[0]["launches"],
               predicted_per_step=predicted, losses=losses, peak_gb=peak_gb,
               allocated_before_gb=allocated_before_gb, seconds=seconds,
               step_ms=float(np.median([r["iteration_ms"] for r in quiet])) if quiet else None,
               syncs_per_quiet_step=[r["iteration_syncs"] for r in quiet],
               cuts=dict(batch=f"{recipe_batch} -> {batch}", negatives=negatives,
                         tokens=f"query {q_len} / document {d_len}", steps=FAMILY_STEPS,
                         warmup=f"{raw['train_args']['warmup_steps']} (recipe: see its yaml)",
                         data="one in-memory batch of stand-in token ids, repeated", tokenizer="StubTokenizer",
                         weights="seeded random, written under the HF names"),
               params=sum(p.numel() for p in trainer.biencoder.parameters()))
    if family == "distill":
        row["teacher_params"] = sum(p.numel() for p in trainer.teacher.parameters())
    emit(phase=f"{family}_training", card=card, gpu_state=gpu_state(), **row, checks=checks,
         first_syncs=syncs[:3], ok=all(checks.values()))
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"{family} training gates failed: {[k for k, v in checks.items() if not v]}")
    return row


def family_kernel_timing(dev, card, gen):
    """The two new attention shapes (FAMILY_CASES) timed: the forward
    (flash_attention_fwd) and dq and dk/dv alone, each as ms and device_ms
    beside its bound over the live pairs only (the band with the padding
    mask: `live_pairs`), beside the plain versions (the forward; the whole
    backward) and beside torch SDPA with the equivalent boolean
    mask (the valid keys inside the band; forward, and forward + backward
    minus forward for the backward). Each is checked once more against its
    plain version. Returns {case: row}."""
    import torch
    import torch.nn.functional as F

    from contrastors_tpu_torch.ops import flash_attention as fa

    rows = {}
    for name, shp, opt in FAMILY_CASES:
        B, S, T, H, Hkv, D = (shp[n] for n in ("B", "S", "T", "H", "Hkv", "D"))
        q, k, v, kw = case_inputs(gen, dev, shp, opt)
        causal, window, dispatch = kw["causal"], kw["window"], opt.get("dispatch", False)
        mask = kw["kv_segment_ids"] if dispatch else kw["attention_mask"]
        lens = mask.sum(dim=1).tolist()
        band = dict(causal=causal, window=window, all_rows=dispatch)
        b_ms, b_by, flops, nbytes = attention_bound(B, S, T, H, Hkv, D, lens, **band)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        ref_out, _ = fa.flash_attention_reference(q, k, v, **kw)
        ratio = fa.output_error_ratio(out, ref_out)
        del ref_out

        def run():
            return fa.flash_attention_fwd(q, k, v, **kw)

        r_i, c_i = torch.arange(S, device=dev)[:, None], torch.arange(T, device=dev)[None, :]
        keep = (c_i[None] < mask.sum(dim=1)[:, None, None])
        if causal:
            keep = keep & (c_i <= r_i + T - S)
        if window:
            keep = keep & ((r_i - c_i).abs() <= window // 2)
        keep = keep[:, None]
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep)

        row = dict(fwd=dict(ms=median_ms(run), device_ms=median_ms(run, queued=True), bound_ms=b_ms, bound_by=b_by,
                            flops=flops, bytes=nbytes, live_pairs=live_pairs(lens, S, T, **band),
                            all_pairs=B * S * T,
                            plain_ms=median_ms(lambda: fa.flash_attention_reference(q, k, v, **kw), runs=3, warmup=1),
                            library_ms=median_ms(sdpa),
                            library_device_ms=median_ms(sdpa, queued=True), o_err_over_tol=ratio))
        dout = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()
        seg_q, seg_kv = fa.merge_segments(B, S, T, kw.get("attention_mask"), kw.get("segment_ids"),
                                          kw.get("kv_segment_ids"), dev)
        inputs = fa.prepare_backward(q, k, v, out, lse, dout, seg_q, seg_kv)
        args = (causal, T - S, window, 1.0 / D**0.5)
        launchers = dict(dq=lambda: fa.launch_bwd_dq(*inputs, *args), dkv=lambda: fa.launch_bwd_dkv(*inputs, *args))
        launchers["dq"]()  # delta for dk/dv
        for kname, launch in launchers.items():
            k_ms, k_by, k_flops, k_bytes = backward_bound(kname, B, S, T, H, Hkv, D, lens, **band)
            row[kname] = dict(ms=median_ms(launch), device_ms=median_ms(launch, queued=True), bound_ms=k_ms,
                              bound_by=k_by, flops=k_flops, bytes=k_bytes)
        dot = dout.transpose(1, 2)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

        row["plain_backward_ms"] = median_ms(lambda: fa.flash_attention_backward_reference(
            q, k, v, out, lse, dout, **kw), runs=3, warmup=1)
        row["library_backward_ms"] = median_ms(sdpa_fwd_bwd) - row["fwd"]["library_ms"]
        row["library_backward_device_ms"] = median_ms(sdpa_fwd_bwd, queued=True) - row["fwd"]["library_device_ms"]
        grads = fa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
        refs = fa.flash_attention_backward_reference(q, k, v, out, lse, dout, **kw)
        row["grad_err_over_tol"] = {n: fa.grad_error_ratio(g, r, n) for g, r, n in zip(grads, refs, ("dq", "dk", "dv"))}
        rows[name] = row
        emit(phase="family_kernel_timing", card=card, gpu_state=gpu_state(), case=name, **shp, causal=causal,
             window=window, dispatch=dispatch, **row,
             note="fwd: flash_attention_fwd; dq, dkv: the kernels alone; bound over the live pairs; library: "
                  "SDPA with the valid keys inside the band as a boolean attn_mask")
        if ratio > 1.0 or max(row["grad_err_over_tol"].values()) > 1.0:
            raise AssertionError(f"flash kernels disagree with their plain versions at {name}")
        del q, k, v, out, lse, dout, inputs, grads, refs, qt, kt, vt, keep
        torch.cuda.empty_cache()
    return rows


def families_phase(dev, card, gen):
    """Phase 20: the four families of configs/train/ that no earlier phase
    drives, each at its published widths with seeded weights written under
    the HF names to a temporary directory, through the port's loaders and
    train.run: ModernBERT-base (serving 256 x 512, and
    contrastive_finetune_modernbert.yaml), nomic-bert-2048 upcycled to 8
    experts (contrastive_finetune_moe.yaml, from a dense checkpoint), the
    distill pair of configs/train/distill.yaml (teacher nomic-embed-text-
    v1.5's widths, a 6-layer student of the same config.json) and
    pythia-160m (serving 256 x 128 with last pooling, and
    contrastive_finetune_decoder.yaml); then the two new attention shapes
    timed. Returns the rows."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_families_")
    out = {}
    try:
        mb_dir = os.path.join(root, "ModernBERT-base")
        write_family_checkpoint(mb_dir, "modernbert", MODERNBERT_BASE_CONFIG, seed=20)
        out["modernbert"] = dict(serving=family_serving(dev, card, "modernbert", mb_dir, 512, "mean"),
                                 training=family_training(dev, card, "modernbert", mb_dir))
        shutil.rmtree(mb_dir)

        dense_dir = os.path.join(root, "nomic-bert-2048")
        dense_sd = write_family_checkpoint(dense_dir, "nomic", NOMIC_BERT_2048_CONFIG, seed=21)
        out["moe"] = dict(training=family_training(dev, card, "moe", dense_dir, dense_sd=dense_sd))
        del dense_sd
        shutil.rmtree(dense_dir)

        teacher_dir, student_dir = os.path.join(root, "nomic-embed-text-v1.5"), os.path.join(root, "nomic-bert-6l")
        write_family_checkpoint(teacher_dir, "nomic", NOMIC_BERT_2048_CONFIG, seed=22)
        # the student: the teacher's config.json at half its depth (6 layers)
        write_family_checkpoint(student_dir, "nomic", dict(NOMIC_BERT_2048_CONFIG,
                                                           n_layer=NOMIC_BERT_2048_CONFIG["n_layer"] // 2),
                                seed=0, weights=False)
        out["distill"] = dict(training=family_training(dev, card, "distill", student_dir, teacher_dir=teacher_dir))

        py_dir = os.path.join(root, "pythia-160m")
        write_family_checkpoint(py_dir, "pythia", PYTHIA_160M_CONFIG, seed=23)
        out["pythia"] = dict(serving=family_serving(dev, card, "pythia", py_dir, 128, "last"),
                             training=family_training(dev, card, "pythia", py_dir))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["kernels"] = family_kernel_timing(dev, card, gen)
    emit(phase="families", card=card, ok=True, **{f: {k: {kk: vv for kk, vv in v.items() if kk in (
        "launches_per_step", "launches_per_batch", "step_ms", "peak_gb", "texts_per_s")} for k, v in rows.items()}
        for f, rows in out.items() if f != "kernels"})
    return out


def finish(card, summary):
    """The run's ending: the command_time line, the card's line, the summary
    and the last line, these three as the contract gives them, without t."""
    import torch

    emit(phase="command_time", seconds=time.perf_counter() - T0)
    print(card, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps(dict(ok=True, device=dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                                               count=torch.cuda.device_count()))), flush=True)
    return 0


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Drive the PyTorch / CUDA port on one NVIDIA GPU.")
    ap.add_argument("--only", choices=["moe_kernels", "moe", "flash_fwd", "flash_bwd", "dense", "trainer",
                                       "mlm_trainer", "vision", "families"],
                    help="run only the card, build and grouped-matmul phases (9), or (moe) also MoE "
                         "serving and the MoE step's timing and profile (10-12, no gradient agreement); "
                         "flash_fwd: the card, build, the forward checks (3, 13), the forward timing (6), "
                         "the fused encode (14) and the MLM step's timing, fused and outside; "
                         "flash_bwd: the card, build, the backward checks (4, 13), the backward timing "
                         "(8, the whole backward only) and the MLM step's timing, fused and outside; "
                         "dense: the card, build and the dense step's timing and profile (7-8, no "
                         "gradient agreement); trainer: the card, build and the trainer phase (17); "
                         "mlm_trainer: the card, build and the MLM, MMLM and GLUE trainers (18); vision: the "
                         "card, build, the ViT attention shape's forward and backward checks and phase 19; "
                         "families: the card, build, the families' attention shapes' forward and backward "
                         "checks and phase 20")
    ap.add_argument("--tree", help="with --only: the root of another checkout whose contrastors_tpu_torch "
                                   "package is built and timed (an earlier commit, for old against new)")
    args = ap.parse_args(argv)
    if args.tree:
        if not args.only:
            ap.error("--tree needs --only")
        sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA device",
              file=sys.stderr)
        return 1
    try:
        from contrastors_tpu_torch.eval.encoder import Encoder
        from contrastors_tpu_torch.eval.stub_tokenizer import StubTokenizer
        from contrastors_tpu_torch.models import BiEncoder
        from contrastors_tpu_torch.models.presets import nomic_bert_2048
        from contrastors_tpu_torch.ops import _build
        from contrastors_tpu_torch.ops import flash_attention as fa
        from contrastors_tpu_torch.scripts import ablate_rotary_fusion
    except ImportError as e:
        print(f"chip_smoke: the contrastors_tpu_torch package is missing ({e}); "
              "run from the root of a checkout", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit(phase="card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         allow_tf32_matmul=False, allow_tf32_cudnn=False)

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = dict(moe_kernels=("gmm",), flash_fwd=("flash_fwd", "flash_bwd"), flash_bwd=("flash_fwd", "flash_bwd"),
                dense=("flash_fwd", "flash_bwd"), trainer=("flash_fwd", "flash_bwd"),
                mlm_trainer=("flash_fwd", "flash_bwd"), vision=("flash_fwd", "flash_bwd")).get(args.only, _build.LIBRARIES)
    with ThreadPoolExecutor(len(libs)) as pool:
        paths = dict(zip(libs, pool.map(_build.build, libs)))
    for name in libs:
        _build.load_library(name)
    emit(phase="build", seconds=time.perf_counter() - t0, package=str(_build.CSRC.parents[2]),
         nvcc_seconds={n: _build.build_seconds.get(n) for n in libs},
         libraries={n: p.name for n, p in paths.items()},
         ptxas={n: ptxas_usage(_build.build_logs.get(n, "")) for n in libs},
         ptxas_warnings=[x for n in libs for x in _build.build_logs.get(n, "").splitlines() if "arning" in x])
    if args.only:
        summary = dict(package=str(_build.CSRC.parents[2]))
        gen = torch.Generator(device=dev).manual_seed(0)
        if args.only == "flash_fwd":
            o_errs = forward_checks(dev, gen)
            fused_errs = fused_kernel_checks(dev, gen, backward=False)
            summary["flash_fwd"] = forward_timing(dev, card, gen)
            cfg = nomic_bert_2048(attn_impl="flash")
            model = seed_weights(BiEncoder(cfg, pooling="mean", dtype=torch.bfloat16, device=dev), "dense")
            tok = StubTokenizer(cfg.vocab_size)
            texts = make_texts(np.random.default_rng(0), 256, 512, 512, lognormal=False)
            enc = Encoder(model, tok, seq_len=512, batch_size=256)
            enc.query_prefix = enc.document_prefix = None
            summary["fused_encode_launches"] = fused_encode(dev, card, model, tok, texts, enc.encode(texts))
            del model, enc
            torch.cuda.empty_cache()
            summary["mlm_launches"], summary["mlm_step"] = mlm_training(dev, card, agreement=False)
            summary["max_abs_err"] = dict(fwd=max(o_errs.values()), fused_fwd=fused_errs["fwd"])
        elif args.only == "flash_bwd":
            grad_errs = backward_checks(dev, gen)
            fused_errs = fused_kernel_checks(dev, gen)
            summary["flash_bwd"] = backward_timing(dev, card, gen, per_kernel=False)
            summary["mlm_launches"], summary["mlm_step"] = mlm_training(dev, card, agreement=False)
            summary["max_abs_err"] = dict({g: max(e.values()) for g, e in grad_errs.items()}, fused=fused_errs)
        elif args.only == "dense":
            summary["dense_launches"], summary["dense_step"] = dense_training(dev, card, agreement=False)
        elif args.only == "trainer":
            summary["trainer_launches"] = trainer_phase(dev, card)
        elif args.only == "mlm_trainer":
            summary["mlm_trainer"] = mlm_trainer_phase(dev, card)
        elif args.only in ("vision", "families"):
            cases, phase = ((VIT_CASES, vision_family) if args.only == "vision"
                            else (FAMILY_CASES + FAMILY_PATH_CASES, families_phase))
            o_errs = forward_checks(dev, gen, cases)
            grad_errs = backward_checks(dev, gen, [c for c in cases if c[0] not in FAMILY_SERVING])
            summary[args.only] = phase(dev, card, gen)
            summary["max_abs_err"] = dict(fwd=max(o_errs.values()), **{g: max(e.values()) for g, e in grad_errs.items()})
        else:
            summary["max_abs_err"], moe_times = moe_kernels(dev, card)
            summary["moe_kernels"] = {f"{k[0]} {k[1]} K={k[2]} N={k[3]}": v for k, v in moe_times.items()}
            if args.only == "moe":
                summary["moe_encode_launches"], _ = moe_serving(
                    dev, card, StubTokenizer(moe_config().vocab_size), np.random.default_rng(0), gen)
                summary["moe_train_launches"] = moe_training(dev, card, agreement=False)
        return finish(card, summary)

    # 3-4. the flash kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(0)
    o_errs = forward_checks(dev, gen)
    grad_errs = backward_checks(dev, gen)

    # 13. the fused-rotary kernels against their plain versions
    fused_errs = fused_kernel_checks(dev, gen)

    # 9. the grouped-matmul kernels against their plain versions, and timed
    gmm_errs, moe_times = moe_kernels(dev, card)

    # 5. the slice at full width: encode requests through the port's Encoder
    cfg = nomic_bert_2048(attn_impl="flash")
    model = seed_weights(BiEncoder(cfg, pooling="mean", dtype=torch.bfloat16, device=dev), "dense")
    n_params = sum(p.numel() for p in model.parameters())
    tok = StubTokenizer(cfg.vocab_size)
    rng = np.random.default_rng(0)
    docs = make_texts(rng, 1024, 8, 511)
    long_texts = make_texts(rng, 16, 3000, 4096, lognormal=False)
    cfg_long = nomic_bert_2048(attn_impl="flash", rotary_scaling_factor=2.0)
    model_long = BiEncoder(cfg_long, pooling="mean", dtype=torch.bfloat16, device=dev)
    model_long.load_state_dict(model.state_dict())
    enc = Encoder(model, tok, seq_len=512, batch_size=256)
    enc_long = Encoder(model_long, tok, seq_len=4096, batch_size=16)

    fa.launches = 0
    t0 = time.perf_counter()
    emb = enc.encode_corpus([{"title": "", "text": t} for t in docs])
    t_docs = time.perf_counter() - t0
    launches_docs = fa.launches
    fa.launches = 0
    t0 = time.perf_counter()
    emb_long = enc_long.encode(long_texts)
    t_long = time.perf_counter() - t0
    launches_long = fa.launches
    batches = -(-len(docs) // 256)
    norms = np.linalg.norm(emb, axis=-1)
    norms_long = np.linalg.norm(emb_long, axis=-1)
    main_ok = (
        launches_docs == cfg.n_layer * batches
        and launches_long == cfg.n_layer
        and emb.shape == (len(docs), cfg.n_embd) and emb_long.shape == (16, cfg.n_embd)
        and bool(np.isfinite(emb).all()) and bool(np.isfinite(emb_long).all())
        and float(np.abs(norms - 1).max()) < 1e-4 and float(np.abs(norms_long - 1).max()) < 1e-4
    )
    emit(phase="main_path", params=n_params, requests=len(docs), long_requests=16,
         batches=batches, launches=launches_docs, expected_launches=cfg.n_layer * batches,
         long_batches=1, long_launches=launches_long, expected_long_launches=cfg.n_layer,
         docs_seconds=t_docs, long_seconds=t_long, max_norm_dev=float(np.abs(norms - 1).max()),
         ok=main_ok)
    if not main_ok:
        raise AssertionError("main path: launch count, shape, finiteness or norm check failed")

    # the same weights under attn_impl="sdpa" (the plain attention path)
    model_sdpa = BiEncoder(nomic_bert_2048(attn_impl="sdpa"), pooling="mean",
                           dtype=torch.bfloat16, device=dev)
    model_sdpa.load_state_dict(model.state_dict())
    ref = Encoder(model_sdpa, tok, seq_len=512, batch_size=256).encode_corpus(
        [{"title": "", "text": t} for t in docs])
    cos = (emb * ref).sum(-1)
    model_sdpa_long = BiEncoder(nomic_bert_2048(attn_impl="sdpa", rotary_scaling_factor=2.0),
                                pooling="mean", dtype=torch.bfloat16, device=dev)
    model_sdpa_long.load_state_dict(model.state_dict())
    ref_long = Encoder(model_sdpa_long, tok, seq_len=4096, batch_size=4).encode(long_texts)
    cos_long = (emb_long * ref_long).sum(-1)
    cos_ok = float(cos.min()) >= 0.999 and float(cos_long.min()) >= 0.999
    emit(phase="sdpa_agreement", min_cosine=float(cos.min()), min_cosine_long=float(cos_long.min()),
         threshold=0.999, ok=cos_ok)
    if not cos_ok:
        raise AssertionError("flash and sdpa embeddings disagree")
    del model_sdpa, model_sdpa_long, model_long, enc_long
    torch.cuda.empty_cache()

    # 6. timing
    texts_512 = make_texts(rng, 256, 512, 512, lognormal=False)
    enc.query_prefix = enc.document_prefix = None
    host_ms = []
    for i in range(8):
        t0 = time.perf_counter()
        e = enc.encode(texts_512)
        if i >= 2:
            host_ms.append((time.perf_counter() - t0) * 1e3)
    assert e.shape == (256, cfg.n_embd) and np.isfinite(e).all()
    ids = torch.randint(1000, 30000, (256, 512), generator=gen, device=dev)
    full = torch.ones(256, 512, dtype=torch.int64, device=dev)
    with torch.inference_mode():
        fwd_ms = median_ms(lambda: model(ids, full, normalize=False), runs=7)
    enc_ms = float(np.median(host_ms))
    emit(phase="encode_throughput", card=card, gpu_state=gpu_state(), batch=256, seq_len=512, encode_ms=enc_ms,
         texts_per_s=256 / enc_ms * 1e3, tokens_per_s=256 * 512 / enc_ms * 1e3,
         forward_ms=fwd_ms, forward_tokens_per_s=256 * 512 / fwd_ms * 1e3)

    # 14. fused-rotary encode: the same weights and texts with fused_rotary=True
    launches_fused_enc = fused_encode(dev, card, model, tok, texts_512, e)
    del model, enc
    torch.cuda.empty_cache()

    timings = forward_timing(dev, card, gen)

    # 15. the fused-rotary kernels timed at the MLM shape, and the ported
    # rotary-fusion ablation (rotary outside, pre-rotated, fused)
    fused_times = fused_kernel_timing(dev, card, gen)
    emit(phase="rotary_ablation", card=card, gpu_state=gpu_state(), **ablate_rotary_fusion.run())

    # 7. training at full width: the text GradCache step, after the dead-row
    # dispatch it runs through
    dead_row_check(dev, gen)
    launches_train, dense_timing = dense_training(dev, card)

    # 17. the trainer entry point on the pretrain recipe, against the bare step
    launches_trainer = trainer_phase(dev, card, bare_busy_ms=dense_timing["device_busy_ms"])

    # 8. the backward kernels at the main-path shapes
    bwd_timings = backward_timing(dev, card, gen)

    # 16. the MLM pretraining step with fused rotary at full width
    mlm_launches, mlm_timing = mlm_training(dev, card)

    # 18. the MLM, multilingual MLM and GLUE trainers on their recipes
    bert_family = mlm_trainer_phase(dev, card, mlm_step_ms=mlm_timing["fused"]["step_ms"])

    # 19. the vision / LiT family: the ViT's attention shape, serving, the recipe's trainer
    vision = vision_family(dev, card, gen)

    # 20. the families: ModernBERT, the upcycled MoE, distill and pythia
    families = families_phase(dev, card, gen)

    # 10-12. the dropless MoE path: serving and training
    moe_enc_launches, moe_batches = moe_serving(dev, card, tok, rng, gen)
    moe_train_launches = moe_training(dev, card)

    main = timings["b256_s512"]

    def gmm_entry(kname, replaces):
        pick = ("ms", "device_ms", "enqueue_us", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_device_ms", "library_enqueue_us", "library")
        doc = moe_times[(kname, "doc_chunk", 768, 3072)]
        entry = dict(
            name=kname, route="cuda", source="contrastors_tpu_torch/ops/csrc/gmm.cu", replaces=replaces,
            launches=moe_train_launches[kname], max_abs_err=gmm_errs[kname],
            **{k: doc[k] for k in pick},
            shape="document chunk: 16384 assignments, P=17408, K=768 N=3072, 8 experts",
            # every layout and (K, N); dlhs is gmm on the rhs.transpose(1, 2) view (dout @ rhs^T),
            # listed under the forward's K, N
            timings={f"{name} {layout} K={K} N={N}": {k: row[k] for k in pick}
                     for (name, layout, K, N), row in moe_times.items() if (name == "tgmm") == (kname == "tgmm")},
        )
        entry["families"] = family_entry(kname)
        if kname == "gmm":
            entry["encode_launches"] = moe_enc_launches["gmm"]
            entry["encode_batches"] = moe_batches
        return entry

    def family_entry(kname):
        """Phase 20: launches per training step of each family (and per
        serving batch), and for the flash kernels the two new shapes'
        timing rows."""
        entry = {f"{f}_launches_per_step": families[f]["training"]["launches_per_step"][kname]
                 for f in ("modernbert", "moe", "distill", "pythia")}
        if kname == "fwd":
            entry.update({f"{f}_launches_per_serving_batch": families[f]["serving"]["launches_per_batch"]["fwd"]
                          for f in ("modernbert", "pythia")})
        if kname in ("fwd", "dq", "dkv"):
            lib = ("library_ms", "library_device_ms") if kname == "fwd" else ("library_backward_ms",
                                                                              "library_backward_device_ms")
            entry["timings"] = {case: dict(row[kname], **{k: row[k] if k in row else row["fwd"][k] for k in lib})
                                for case, row in families["kernels"].items()}
        return entry

    def vision_entry(kname):
        """The ViT's attention shape: timing row, launches per vision step, error."""
        row = vision["kernels"][kname]
        training = vision["training"]
        errs = [o_errs["vit_b64_s197"]] if kname == "fwd" else [
            grad_errs[g]["vit_b64_s197"] for g in (("dq",) if kname == "dq" else ("dk", "dv"))]
        return dict(shape="B=64 S=T=197 H=12 D=64, no mask (the ViT)", max_abs_err=max(errs),
                    launches_per_step=training["standard"]["launches_per_step"][kname],
                    launches_per_grad_cache_step=training["grad_cache"]["launches_per_step"][kname],
                    **({"launches_per_eval": training["standard"]["eval_launches"]["fwd"],
                        "launches_per_image_forward": vision["serving"]["flash_per_image_forward"]}
                       if kname == "fwd" else {}),
                    **{k: row[k] for k in ("ms", "device_ms", "enqueue_us", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms", "library_device_ms")})

    def bwd_entry(kname, replaces):
        doc, query, mlm = bwd_timings["b16_s256"], bwd_timings["b512_s32"], bwd_timings["mlm_b8_s2048"]

        def at(row, shape):
            return dict(shape=shape, ms=row[kname]["ms"], device_ms=row[kname]["device_ms"],
                        enqueue_us=row[kname]["enqueue_us"], bound_ms=row[kname]["bound_ms"],
                        bound_by=row[kname]["bound_by"], plain_ms=row["plain_ms"], library_ms=row["library_ms"],
                        library_device_ms=row["library_device_ms"], backward_ms=row["ms"],
                        backward_device_ms=row["device_ms"])

        return dict(
            name=f"flash_bwd_{kname}",
            route="cuda",
            source="contrastors_tpu_torch/ops/csrc/flash_bwd.cu",
            replaces=replaces,
            launches=launches_train[kname],
            trainer_launches=launches_trainer[kname],
            max_abs_err=max(max(grad_errs[g].values()) for g in (("dq",) if kname == "dq" else ("dk", "dv"))),
            **{k: v for k, v in at(doc, "B=16 S=T=256 H=12 D=64 (document chunk)").items()},
            query_tower=at(query, "B=512 S=T=32 H=12 D=64"),
            mlm_unfused=at(mlm, "B=8 S=T=2048 H=12 D=64, rotary outside"),
            vision=vision_entry(kname),
            families=family_entry(kname),
            note="plain_ms and library_ms time a whole backward (dq, dk and dv); backward_ms is the whole "
                 "flash_attention_backward (dq, with delta, then dk/dv)",
        )

    def fused_entry(kname, replaces, also):
        row = fused_times[kname]
        errs = ("fwd",) if kname == "fwd" else ("dq",) if kname == "dq" else ("dk", "dv")
        return dict(
            name=f"flash_{'fwd' if kname == 'fwd' else 'bwd_' + kname}_rot",
            route="cuda",
            source=f"contrastors_tpu_torch/ops/csrc/{'flash_fwd' if kname == 'fwd' else 'flash_bwd'}.cu",
            replaces=replaces,
            also_replaces=also,
            launches=mlm_launches[f"{kname}_rot"],
            max_abs_err=max(fused_errs[g] for g in errs),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            library_composite_ms=row["library_composite_ms"],
            unfused_ms=row["unfused_ms"],
            shape="B=8 S=T=2048 H=12 D=64, NeoX over the whole head (the MLM step); launches per micro-step",
            note="no single PyTorch call computes fused-rotary attention: library_ms is null, and "
                 "library_composite_ms is SDPA on pre-rotated q/k plus apply_rotary on q and k"
                 + ("" if kname == "fwd" else "; plain_ms and the composite are whole backwards"),
        )

    return finish(card, dict(kernels=[
        dict(
            name="flash_fwd",
            route="cuda",
            source="contrastors_tpu_torch/ops/csrc/flash_fwd.cu",
            replaces="contrastors_tpu/ops/flash_attention.py:225",
            also_replaces="contrastors_tpu/ops/flash_attention.py:115",
            launches=launches_docs,
            train_launches=launches_train["fwd"],
            trainer_launches=launches_trainer["fwd"],
            mlm_eval_launches=bert_family["mlm_eval"], mlm_eval_batches=bert_family["mlm_eval_batches"],
            glue_eval_launches=bert_family["glue_eval"], glue_eval_batches=bert_family["glue_eval_batches"],
            max_abs_err=max(o_errs.values()),
            **{k: main[k] for k in ("ms", "device_ms", "enqueue_us", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "library_device_ms", "library_masked_ms")},
            shape="B=256 S=T=512 H=12 D=64, all-ones mask (the encode batch)",
            long_context=dict(timings["b16_s4096"], launches=launches_long,
                              max_abs_err=max(o_errs["s4096"], o_errs["s8192"])),
            vision=vision_entry("fwd"),
            families=family_entry("fwd"),
            timings={label: {k: row[k] for k in ("ms", "device_ms", "enqueue_us", "plain_ms", "bound_ms",
                                                 "library_ms", "library_device_ms")}
                     for label, row in timings.items()},
            note="library: torch SDPA without a mask (the all-ones mask selects every key); "
                 "library_masked_ms: SDPA with the mask as a boolean attn_mask; timings: every timed shape "
                 "(the fused one against SDPA on q, k rotated by apply_rotary)",
        ),
        bwd_entry("dq", "contrastors_tpu/ops/flash_attention.py:422"),
        bwd_entry("dkv", "contrastors_tpu/ops/flash_attention.py:512"),
        gmm_entry("gmm", "contrastors_tpu/ops/grouped_matmul.py:75"),
        gmm_entry("tgmm", "contrastors_tpu/ops/grouped_matmul.py:125"),
        dict(fused_entry("fwd", "contrastors_tpu/ops/flash_attention.py:225",
                         ["contrastors_tpu/ops/flash_attention.py:115",
                          "contrastors_tpu/scripts/ablate_rotary_fusion.py:42"]),
             encode_launches=launches_fused_enc["fwd_rot"]),
        fused_entry("dq", "contrastors_tpu/ops/flash_attention.py:422", []),
        fused_entry("dkv", "contrastors_tpu/ops/flash_attention.py:512", []),
    ]))


if __name__ == "__main__":
    sys.exit(main())
