#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (contrastors_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only {moe_kernels,moe,flash_fwd,flash_bwd,dense,trainer,mlm_trainer,vision,families,
                                  inference,distributed,knobs,parallel,scripts}
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
checks of 3 and 4 and 20, or (inference) 1, 2, the long-context case's
check of 3 and 21, or (distributed) 1, 2 and 22, or (knobs) 1, 2, the packed step's
cases of 3, 4 and 13, and 23, or (parallel) 1, 2, the local shapes' cases of 3 and 4 and 24,
or (scripts) 1, 2, the ViT shape's cases of 3 and 4 and 25,
on this checkout's package or on the one under DIR (another checkout, e.g. the parent commit
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
     with one, 128 x 128 in the dispatch's form; the packed step's rows
     of phase 23, 128 x 128 and 4 x 512, up to 4 sequences a row of
     lognormal lengths placed by pack_tokenized, segment ids with the
     mask merged in); a second run bit-identical to the first.
  4. kernel_check_bwd: the two backward kernels (dq, which also computes
     delta; dk/dv) against the plain backward on the same O and LSE, with a
     strided dO, in 15 of those cases (the training shapes and the packed
     step's rows included) and in
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
     2e-4 wd 0.01 clip 1.0, LogitScale(50) fixed) takes 3 steps on one
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
     AdamW lr 2e-4 wd 0.01 clip 1.0, LogitScale(50) fixed, 3 steps; per
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
     step by layer, with the router aux off (the readings with the aux on,
     by chunk and in fp32 were cut for the 900 s budget).
 12. moe_timing: MoE encode texts/s, step ms (median of 2); with --only moe
     one profiled step with gmm and tgmm as their own groups and its
     device-to-host copies counted (the full run skips the profile since
     phase 25, for the 900 s budget).
The fused-rotary kernels (q and k rotated inside the flash kernels) and the
MLM pretraining step:
 13. fused_kernel_check (after phase 4): the fused forward, dq and dk/dv
     kernels against their plain versions, per element, at the MLM shape
     (B=8 S=2048 H=12 D=64, NeoX), an encode batch with padding (256 x
     512), packed rows (B=4 S=2048, three segments per row, positions
     restarting: per-batch tables), interleaved rotary over 32 of 64
     features, GQA (Hkv=4), S=300 and D=128, and the walk's edges (S = 1,
     65, 129 with GQA and at D = 128, B * H = 143, GQA at S = 2048), and
     the packed step's rows of phase 23 (128 x 128 and 4 x 512) with
     positions restarting at each segment; every
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
     data, 6 steps (8 before phase 25), warmup 2, log and save every 3, the
     retrieval eval at step 6, every query chunk direct) through train.run
     and the TextTextTrainer with the stand-in tokenizer, in bf16: per step
     780 / 396 / 396 flash launches (the bare step's), the loss at step 6
     below step 1's, the logged lr on make_schedule, a second trainer
     resumed from step_3 logging steps 4-6 within 2e-3 relative, the eval logged,
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
The inference side (after phase 20), at full width with seeded weights:
 21. inference_*: the encode CLI's function (scripts/encode.py) on 2048
     texts at 256 x 512 into a .npy (12 flash launches a batch, the rows
     bit for bit Encoder.encode's, --matryoshka_dim 256 --binarize the
     packed signs of the first 256 dims, cosine >= 0.999 against fp32
     sdpa, texts/s); export with weights_format="bin" reloaded by the
     port's load_biencoder bit for bit (nomic-bert-2048 through the
     trust_remote_code package, bert-base-uncased's widths as vanilla
     BERT, ViT-B/16 as HF ViT; EVA02-B/16 refused); the long-context eval
     (build_long_context_encoder at 8192, batch 8, NTK 2.0, over a written
     BEIR directory of 64 documents of 4098-8191 tokens and 16 queries,
     through run_beir_dirs: 12 launches a batch, nDCG@10 finite, one
     batch at cosine >= 0.999 against fp32 sdpa row by row, documents/s);
     six synthetic MTEB tasks through eval_mteb.run_mteb and the offline
     runner (scores equal to those computed from Encoder.encode's
     embeddings outside the harness, score_table over the folder); mine
     and consistency_keep_mask on 4096 pairs of embeddings whose products
     are exact in fp32, against numpy's full sort (identical); the decoder
     heads at pythia-160m's widths, 256 x 128 (the causal LM's logits and
     one backward against sdpa, 12 / 12 / 12 launches, peak memory; the
     sequence, token and QA heads' forwards). The long-context case
     (longctx_ntk_pad_b8_s8192, a case of phase 3, its plain version
     row by row) timed beside its bound, its plain version and SDPA.
Data-parallel training across processes (after phase 21):
 22. distributed, distributed_timing, distributed_nccl: the pretrain
     recipe (PRETRAIN_RECIPE at 512 pairs, 32 / 256 tokens, grad cache
     with chunk 16 a rank, every query chunk direct, 3 steps, full
     nomic-bert-2048 width, bf16) and configs/train/mlm.yaml (bert-base-
     uncased's widths, dropout 0, 4 x 2048, rows 2-3 short) through
     train.run, first on one rank in this process, then on two ranks of
     this script started in torchrun's environment (RANK, WORLD_SIZE,
     LOCAL_RANK, MASTER_ADDR / MASTER_PORT, CONTRASTORS_DIST_BACKEND=gloo),
     over gloo with CUDA tensors, both on card 0 (NCCL refuses two ranks on
     one device); with --tree the ranks import that tree's package too, and
     each rank's package path is checked against the launcher's. Gates, stated
     before the first run: each step's loss within 2e-3 relative of the
     one-rank run's at the same global batch; the two runs' parameter
     updates after the last step at cosine >= 0.99 per tensor and >= 0.999
     over all; a planted fault (labels without the rank offset; for MLM
     the mean of the ranks' means) outside them; flash launches per rank
     step 396 / 204 / 204 (the one-rank step's 780 / 396 / 396); the
     ranks' initial parameters the one-rank run's; the optimizer state
     sharded; no synchronising call outside the collectives in a quiet
     step. Recorded, marked as gloo on one shared card: per-rank step ms,
     the gradient all-reduce, embedding gather and sharded optimizer's row
     gather ms at the step's sizes, peak memory per rank. Then NCCL at world size 1 in torchrun's
     environment (the default backend on a card): the gather forward and
     backward, the gradient all-reduce, the metric reductions and the
     broadcast checked and timed; across two cards only where there are
     two.
The training step's last single-card knobs (after phase 12):
 23. knobs_packed, knobs_packed_agreement: PRETRAIN_RECIPE with
     data_args.packed (K = 4 segments a row at the default geometry: rows
     of 128 query tokens, 512 document tokens) through train.run, 512
     pairs a step of lognormal lengths (queries <= 32 tokens, documents
     <= 256), chunk 16 (4 rows), every query chunk direct, 3 steps, bf16.
     Gates: 780 / 396 / 396 flash launches a step (the queries' one direct
     forward, the documents' 32 row chunks in both passes) on segment ids,
     losses finite and falling, 0 synchronising calls in a quiet step.
     Then on the first batch from the recipe's initial weights: packed
     against padded embeddings (each sequence that packing kept whole,
     both towers) at cosine >= 0.999, the step's gradient (grad cache, lr
     0) against the padded step's on the sequences as packing kept them
     (each mask cut to its kept tokens) at cosine >= 0.999 overall, and
     the same with fused_rotary (the fused kernels on per-batch tables,
     positions restarting per segment: 780 / 396 / 396 fused launches); a
     planted fault (the query pair_index rolled by one slot) outside both.
     Recorded: the predicted gain, kept share, sequences kept whole and
     truncated to 0 per tower (and the kept share at phase 5's document
     lengths), the gradient against the padded step on the whole
     sequences, AdamW's first-update cosine, packed and padded step ms in
     turns.
     knobs_moe_encode, knobs_moe_step: the MoE model (moe_config) on its
     seed weights with moe_impl="capacity": the encode batch (256 x 512,
     lognormal lengths) at factor E / k = 4 (C = N, nothing can drop) at
     cosine >= 0.999 against dropless, 0 gmm launches; the dropped share at
     the default factor 2.0 recorded. The MoE benchmark step (phase 11's
     geometry) with the capacity dispatch, in turns with dropless on the
     same weights: 768 / 384 / 384 flash launches and 0 gmm and tgmm a
     step, the loss falling over 2 steps; then expert choice: every table
     [8, C] with C distinct tokens an expert (C = 512 / 4096 for a query /
     document chunk), 0 gmm, the loss falling over 2 steps.
     knobs_embed_parallel: grad cache's pass 1 with 4 chunks to a forward
     against 1, on the vision recipe's grad-cache step (2048 images, chunk
     128, LiT) and the dense text step (phase 7's geometry): gradients at
     cosine >= 0.9999 and relative L2 <= 0.01; pass-1 ms and step ms in
     turns (1, 4, 4, 1).
The tensor and expert axes (after phase 23):
 24. parallel, parallel_timing, parallel_nccl: the pretrain recipe cut to
     32 pairs a step (32 / 256 tokens, chunk 16, every query chunk direct,
     3 steps, full nomic-bert-2048 width, bf16) through train.run on one
     rank in this process, then on ranks of this script started in
     torchrun's environment over gloo with CUDA tensors, all on card 0, in
     the cells: parallel_tensor (1 x 1 x 2: Megatron column / row splits,
     6 of the 12 heads a rank), parallel_expert (the MoE model, 8 experts,
     top-2, MoE every second layer, cut to 6 layers, at 1 x 2 x 1 under
     moe_impl "auto",
     which must resolve to capacity, and under "dropless", whose gmm /
     tgmm run on 4 local experts) and parallel_expert_tensor (the MoE model
     at 1 x 2 x 2 on four ranks, w_up [4, 768, 1536] a rank). Gates: each
     step's loss within 2e-3 relative of the one-rank run's with the same
     moe_impl; the first step's gradient, gathered whole, at cosine >= 0.99
     per tensor and >= 0.999 over all (phase 22's numbers) or >= 0.995
     over all (the MoE cells, phase 11's bar) against one rank's (not the
     parameter updates: AdamW's first updates, about sign(g), flip near-0
     gradients on the split's bf16 rounding); the replicated parameters
     equal on every peer after the steps; the kernels' launches per rank
     step the one-rank step's (60 / 36 / 36 flash; MoE, one direct forward
     a query chunk: 36 / 24 / 24, and 90 gmm and 36 tgmm under dropless),
     at 6 heads, at 4 experts; the all-reduces per rank step as
     `predicted_all_reduces` counts them; two planted faults far outside,
     on one fp32 block at nomic-bert-2048's widths with BERT's projection
     biases (nomic-bert-2048 has none, so its recipe cannot show the
     first) split against whole (relative L2 <= 1e-5 clean): the row
     split's bias added on every rank, and copy_to_group without its
     backward all-reduce.
     Recorded, marked as gloo on one shared card: per-rank step ms,
     all-reduces per rank step and their ms, peak GB per rank. NCCL across
     two cards only where there are two. Then the flash kernels at the
     local shapes (B=512 S=32 and B=16 S=256, H=6, cases of phases 3 and 4)
     and gmm / tgmm on a local layout of 4 experts (reruns bit-identical),
     timed beside their bounds, plain versions and the library.
     parallel_data_routing: the MoE model (4 layers, fp32, sdpa, seed
     weights) with the capacity dispatch and with expert choice at
     capacity factor 1.0, on two data ranks (2 x 1 x 1) against one rank
     on the whole batch (16 x 128 tokens with padding): the port's
     standard step (lr 0) and the mesh Encoder (32 texts, batches of 16).
     Gates: every MoE call's routing (the capacity dispatch's dropped
     (token, expert) assignments, expert choice's picks), united over the
     ranks, the one-rank run's; something dropped (a top-k choice without
     a slot; a (token, expert) pair not picked); the same run routed per
     rank (the dispatch before it routed over the data axis) routes
     otherwise; loss within 2e-3, the
     gradient at cosine >= 0.995, serving embeddings at >= 0.9999.
     parallel_resume: the MoE recipe (capacity; the model cut to 2 layers,
     MoE on layer 1) saved at 1 x 1 x 2 after step 2 of 3, resumed at 1 x 2 x 1 (the two ranks, after the save) and
     1 x 1 x 1 (this process); the dense recipe saved at 2 x 1 x 1 with
     shard_optimizer_state (cut to 2 layers), resumed without it. Gates: step 3 within 2e-3
     of the uninterrupted run's loss, every rank's restored optimizer state
     (gathered whole) the saved one by checksum, the optimizer of the
     resumed layout.
The last modules (after phase 24):
 25. scripts_datacomp: eval/datacomp.py's zero-shot, grouped (fairness)
     and retrieval tasks and the aggregate on EVA02-B/16 with MAP pooling
     and nomic-bert-2048's text tower at full width (bf16, seed weights),
     fed decoded 224 x 224 images of 4 colour classes in memory (the
     card's machine has no Pillow) and the stand-in tokenizer at 77
     tokens. Gates: metrics finite in [0, 1]; flash forward launches 12 a
     tower batch, predicted from the tasks' batches (120); an image batch's
     and a text batch's embeddings at cosine >= 0.999 against the towers
     in fp32 on sdpa. scripts_train_to_signal and
     scripts_vision_train_to_signal: scripts/train_to_signal.py (320 steps
     of 128 pairs) and scripts/vision_train_to_signal.py (400 steps of 64
     images, grad cache at chunk 16) at their defaults in fp32, from the
     worlds they build (JAX's files and weights, made without transformers
     or Pillow), gated on JAX's bars: nDCG@10 above init and above 0.9;
     zero-shot top-1 above init and >= 0.5; their learning curves printed;
     0 flash launches (head dim 16: sdpa). scripts_ablate_vision:
     scripts/ablate_vision.py's split of the LiT grad-cache step (EVA02-B/16,
     chunk 32, batch 512, bf16) into patch embedding, LayerNorm, rotary,
     attention (the flash kernels), SwiGLU with its post-LN, a block, MAP
     pooling, the loss and the optimizer, CUDA-event times.
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
import functools
import io
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
# steps of the dense and MoE steps' launch and loss gates (phases 7, 11) and of
# the MoE step's timing (12): 3, so that the whole script, phase 23 included, stays under 900 s
GATE_STEPS = 3


def moe_config(impl="flash", **over):
    """nomic-bert-2048 with the MoE recipe's experts
    (configs/train/contrastive_finetune_moe.yaml): 8 experts, top-2, MoE on
    every second layer, dropless unless `over` says otherwise."""
    from contrastors_tpu_torch.models.presets import nomic_bert_2048

    return nomic_bert_2048(**dict(dict(attn_impl=impl, num_experts=8, moe_top_k=2, moe_every_n_layers=2,
                                       moe_impl="dropless"), **over))


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
        def patched(model, batch, generator=None, orig=text_text.encode_batch, **kw):
            if torch.is_grad_enabled() and batch["input_ids"].shape[1] == D_LEN:
                batch = {k: v.roll(1, 0) for k, v in batch.items()}
            return orig(model, batch, generator, **kw)
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
    random assignments: expert 2 gets none, expert min(5, E - 1) exactly 128
    rows (a group with no padding), the rest a cubed-uniform share; the
    sentinel marks padding rows. Returns (group_sizes, P, pad row mask,
    blk_e, act)."""
    import torch

    from contrastors_tpu_torch.ops import grouped_matmul as gm

    gen = torch.Generator(device=dev).manual_seed(seed)
    exact = min(5, E - 1)
    p = torch.rand(E, generator=gen, device=dev) ** 3 + 0.01
    p[2] = p[exact] = 0.0
    flat_e = torch.multinomial(p, A - 128, replacement=True, generator=gen)
    flat_e = torch.cat([flat_e, torch.full((128,), exact, device=dev)])
    flat_e = flat_e[torch.randperm(A, generator=gen, device=dev)]
    _, gs, P, src = gm.aligned_group_layout(flat_e, E, 128, src_of=torch.arange(A, device=dev), sentinel=A)
    blk_e, act = gm.block_experts(gs, P // 128, 128)
    return gs, P, src == A, blk_e, act


# (name, assignments): the MoE step's document chunk (32 x 256 tokens,
# top-2) and query chunk (32 x 32), and one encode batch (256 x 512)
MOE_LAYOUTS = (("doc_chunk", 32 * 256 * 2), ("query_chunk", 32 * 32 * 2), ("encode", 256 * 512 * 2))


def gmm_operands(dev, P, K, N, pad, seed, E=8):
    """Random bf16 lhs [P, K], rhs [E, K, N] and dout [P, N], with lhs and
    dout zero on padding rows, as the MoE layer's gather and its gradient
    leave them."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    lhs = torch.randn(P, K, generator=gen, device=dev).bfloat16().masked_fill(pad[:, None], 0)
    rhs = torch.randn(E, K, N, generator=gen, device=dev).bfloat16()
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

    def recording(model, batch, generator=None, **kw):
        out = orig(model, batch, generator, **kw)
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
    # one pass over kineto's raw events (each a range, an op or a kernel with
    # its own duration): key_averages() takes minutes on a step's ~1M host
    # events, and building prof.events() about a minute, this loop seconds
    split = {name: {} for name in phases}
    by_group, other, busy_ms, launches, dtoh, items = {}, {}, 0.0, 0, 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.is_hidden_event():
            continue
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        # kernel names demangled, as the profiler's own events show them
        name, ms = torch._C._demangle(e.name()) if on_device else e.name(), e.duration_ns() / 1e6
        if name in split:
            split[name]["device_span_ms" if on_device else "host_ms"] = ms
        elif on_device and not e.is_user_annotation():  # ranges are not kernels
            busy_ms += ms
            launches += 1
            group = kernel_group(name)
            g = by_group.setdefault(group, [0.0, 0])
            g[0] += ms
            g[1] += 1
            if group == OTHER:
                g = other.setdefault(name[:120], [0.0, 0])
                g[0] += ms
                g[1] += 1
        if "DtoH" in name:
            dtoh += 1
        elif name == "aten::item":
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
    """Phases moe_train_step, moe_train_timing, and with agreement
    moe_train_grad_agreement, else moe_train_profile. Returns the launches
    of one step."""
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
    for i in range(GATE_STEPS):
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
    for _ in range(2):  # 3 runs before phase 25, for the 900 s budget
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
    if not agreement:  # (--only moe; the full run skips it for the 900 s budget since phase 25)
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
    # the margin's reading by layer, router aux off (the runs above; the
    # readings with the aux on, in fp32 and by chunk, are cut
    # for the 900 s budget: PERF.md keeps their numbers)
    by_layer = dict(aux_0=per_group_rel_l2(grads["gc"], grads["std"]))
    emit(phase="moe_grad_margin_reading", pairs=64, chunk=MOE_CHUNK, gc_vs_standard_by_layer=by_layer,
         note="relative L2 of the grad-cache step's gradients against the standard step's, by layer (each "
              "routing on its own), with the router aux off; read, not bounded")
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


def moe_kernels(dev, card, layouts=MOE_LAYOUTS, E=8, kn=((768, 3072), (3072, 768))):
    """Phases kernel_check_gmm and moe_kernel_timing, per layout of `layouts`
    (E experts) and (K, N) of `kn` (each kernel's second run bit-identical
    to its first):
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
    for layout, A in layouts:
        gs, P, pad, blk_e, act = moe_layout(dev, A, E=E, seed=1)
        active_rows, nonempty = int(gs.sum()), int((gs > 0).sum())
        for K, N in kn:
            lhs, rhs, dout = gmm_operands(dev, P, K, N, pad, seed=K + 1, E=E)
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
                out, ref, again = run(), plain(), run()
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                ratio = gm.error_ratio(out, ref)
                zero = bool((out[2] == 0).all()) if name == "tgmm" else bool((out[pad] == 0).all())
                key = "tgmm" if name == "tgmm" else "gmm"
                errs[key] = max(errs[key], err)
                line[name] = dict(max_abs_err=err, ref_abs_max=ref.float().abs().max().item(),
                                  err_over_tol=ratio, padding_exactly_zero=zero,
                                  deterministic=bool(torch.equal(out, again)))
                ok = (ok and ratio <= 1.0 and zero and bool(torch.isfinite(out.float()).all())
                      and line[name]["deterministic"])
                del out, ref, again
            emit(phase="kernel_check_gmm", layout=layout, experts=E, assignments=A, P=P, K=K, N=N,
                 group_sizes=gs.tolist(), active_blocks=int(act.sum()), blocks=P // 128, **line,
                 tol=f"{gm.REL:g}*|ref| + {gm.ABS_FRAC:g}*max|ref|", ok=ok)
            if not ok:
                raise AssertionError(f"grouped-matmul kernels disagree with their plain versions ({layout} K={K} N={N})")
            for name, (run, plain, (kind, a, b), (bK, bN)) in kernels.items():
                ms, device_ms, enqueue_us = median_ms(run), median_ms(run, queued=True), host_enqueue_us(run)
                plain_ms = median_ms(plain, runs=3, warmup=1)
                lib_fn, lib_label = library_grouped_mm(kind, a, b, gs)
                library_ms, library_device_ms = median_ms(lib_fn, runs=5, warmup=2), median_ms(lib_fn, queued=True)
                b_ms, b_by, flops, nbytes = gmm_bound(kind, active_rows, P, bK, bN, nonempty, E=E)
                row = dict(ms=ms, device_ms=device_ms, enqueue_us=enqueue_us, plain_ms=plain_ms,
                           library_ms=library_ms, library_device_ms=library_device_ms,
                           library_enqueue_us=host_enqueue_us(lib_fn), library=lib_label,
                           bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
                           tflops=flops / ms / 1e9, roofline_share=b_ms / ms, device_roofline_share=b_ms / device_ms,
                           err_over_tol=line[name]["err_over_tol"])
                rows_out[(name, layout, K, N)] = row
                emit(phase="moe_kernel_timing", card=card, gpu_state=gpu_state(), kernel=name, layout=layout,
                     experts=E, assignments=A, P=P, active_rows=active_rows, nonempty_experts=nonempty, K=K, N=N,
                     **row)
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
# the packed step's rows (phase 23): the queries' 128 rows of 128 tokens and
# a document chunk's 4 rows of 512, each row up to 4 sequences that
# `pack_tokenized` places at data-dependent cuts, then trailing pad; pack =
# (K, median, shortest, longest) of the lognormal lengths in tokens, as
# phase 23's batches have them. The segment ids come with the mask
# segment_ids > 0, as the packed trunk passes them
PACKED_STEP_CASES = [
    ("packed_q_b128_s128", dict(B=128, S=128, T=128, H=12, Hkv=12, D=64), dict(pack=(4, 14, 4, 32))),
    ("packed_d_b4_s512", dict(B=4, S=512, T=512, H=12, Hkv=12, D=64), dict(pack=(4, 66, 10, 256))),
]
BASE_CASES += PACKED_STEP_CASES
# the tensor axis' local heads (phase 24): a rank of tensor 2 runs 6 of
# nomic-bert-2048's 12 heads, as views of its local Wqkv output (q | k | v of
# its heads), at the step's query tower and document chunk
TENSOR_STEP_CASES = [
    ("tp2_q_b512_s32_h6", dict(B=512, S=32, T=32, H=6, Hkv=6, D=64), dict(mask=(512, 0))),
    ("tp2_d_b16_s256_h6", dict(B=16, S=256, T=256, H=6, Hkv=6, D=64), dict(mask=(16, 0))),
]
BASE_CASES += TENSOR_STEP_CASES
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
# the long-context eval's batch (phase 21): nomic-bert-2048 at 8192 tokens,
# batch 8, a padding mask with key lengths drawn in 4096-8192; the plain
# version is computed a batch row at a time (`ref_rows`): the 8 rows' fp32
# scores alone are 8 x 12 x 8192^2 x 4 B = 25.8 GB
LONGCTX_CASES = [
    ("longctx_ntk_pad_b8_s8192", dict(B=8, S=8192, T=8192, H=12, Hkv=12, D=64), dict(lens=(4096, 8192), ref_rows=1)),
]
FWD_CASES = BASE_CASES + EDGE_CASES + GLUE_CASES + VIT_CASES + FAMILY_CASES + FAMILY_PATH_CASES + LONGCTX_CASES
# the backward kernels: the same but the two largest and the eval-only batches
BWD_CASES = [c for c in FWD_CASES if c[0] not in ("pad_b256_s512", "s8192", "glue_pad_b64_s128") + FAMILY_SERVING
             + tuple(c[0] for c in LONGCTX_CASES)]


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
    if "lens" in opt:
        lo, hi = opt["lens"]
        lens = torch.randint(lo, hi + 1, (shp["B"],), generator=gen, device=dev)
        kw["attention_mask"] = (torch.arange(shp["T"], device=dev)[None] < lens[:, None]).int()
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
    if "pack" in opt:
        kw["segment_ids"], _ = packed_rows(dev, shp["B"], shp["S"], *opt["pack"])
        kw["attention_mask"] = (kw["segment_ids"] > 0).int()
    return q, k, v, kw


def packed_rows(dev, B, S, K, median, lo, hi, seed=0):
    """Segment and position ids [B, S] (int32, on dev) of `pack_tokenized`
    packing B * K sequences of lognormal lengths in tokens (`knob_lengths`)
    into B rows of S tokens."""
    import torch

    from contrastors_tpu_torch.data.packing import pack_tokenized

    lens = knob_lengths(np.random.default_rng(seed), B * K, median, lo, hi)
    mask = (np.arange(int(lens.max()))[None] < lens[:, None]).astype(np.int64)
    packed = pack_tokenized(mask, mask, row_len=S, max_segments=K)
    return tuple(torch.from_numpy(packed[k]).to(dev) for k in ("segment_ids", "position_ids"))


def reference_in_rows(q, k, v, kw, rows=None):
    """The forward's plain version, on all batch rows at once or on `rows`
    of them at a time (the rows are independent, so the result is the same
    per element, in less memory)."""
    import torch

    from contrastors_tpu_torch.ops import flash_attention as fa

    if not rows:
        return fa.flash_attention_reference(q, k, v, **kw)
    parts = []
    for r in range(0, q.shape[0], rows):
        part = {n: (x[r:r + rows] if isinstance(x, torch.Tensor) else x) for n, x in kw.items()}
        parts.append(fa.flash_attention_reference(q[r:r + rows], k[r:r + rows], v[r:r + rows], **part))
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


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
        ref_out, ref_lse = reference_in_rows(q, k, v, kw, opt.get("ref_rows"))
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
# rotary over 32 of 64 features; GQA; a length off the 64-row tile; D=128;
# the packed step's rows (PACKED_STEP_CASES) with their positions.
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
PACKED_STEP_FUSED_CASES = [(f"{name}_rot", {k: v for k, v in shp.items() if k != "T"}, opt)
                           for name, shp, opt in PACKED_STEP_CASES]
FUSED_CASES += PACKED_STEP_FUSED_CASES


def rotary_case(dev, gen, B, S, H, Hkv, D, rot_dim=None, interleaved=False, mask=False, packed=False, pack=None):
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
    if pack:  # the packed step's rows (PACKED_STEP_CASES), positions restarting at each segment
        kw["segment_ids"], kw["rotary_position_ids"] = packed_rows(dev, B, S, *pack)
        kw["attention_mask"] = (kw["segment_ids"] > 0).int()
    return q, k, v, kw


def fused_kernel_checks(dev, gen, backward=True, cases=None):
    """Phase fused_kernel_check: the fused-rotary forward, dq and dk/dv
    kernels against their plain versions in FUSED_CASES, with a strided dO,
    a second forward and backward bit-identical to the first; at the MLM
    shape the backward kernels given negated sin tables must fall outside the
    rule. backward=False checks the forward alone; `cases` replaces
    FUSED_CASES. Returns {"fwd"|"dq"|"dk"|"dv": max abs error}."""
    import torch

    from contrastors_tpu_torch.ops import flash_attention as fa

    errs = dict(fwd=0.0, dq=0.0, dk=0.0, dv=0.0) if backward else dict(fwd=0.0)
    for name, shp, opt in cases or FUSED_CASES:
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
             interleaved=opt.get("interleaved", False), tables="per batch row" if opt.get("packed") or opt.get("pack") else "shared",
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


def forward_timing(dev, card, gen, shapes=FWD_TIMING_SHAPES, H=12):
    """Phase kernel_timing at `shapes` (default FWD_TIMING_SHAPES; H heads, D=64): the forward
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
    for label, B, S, fused in shapes:
        D = 64
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


def backward_timing(dev, card, gen, per_kernel=True, shapes=BWD_TIMING_SHAPES, H=12):
    """Phase kernel_timing_bwd at `shapes` (default BWD_TIMING_SHAPES; H heads, D=64): the whole
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
    for label, B, S, fused in shapes:
        D = 64
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
    for _ in range(GATE_STEPS):
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

    # the step's time on the host clock (3 runs; 5 before phase 25, for the 900 s budget)
    host_ms, enqueue_ms = [], []
    for _ in range(3):
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

TRAIN_STEPS, SAVE_EVERY = 6, 3  # 8, 4 before phase 25, for the 900 s budget


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
    bare_ms, bare_syncs = bare_step_timing(step, qb, db, gen, runs=1)
    busy_ms = bare_busy_ms or profile_step(lambda: step(qb, db, gen), float(np.median(bare_ms)))["device_busy_ms"]

    # the loop, uninterrupted
    trainer, rows, seconds, run_launches, syncs = run_chip_trainer(recipe, dev)
    wait_s = trainer.prefetch_wait_seconds
    del trainer
    gc.collect()

    # the bare step again, then a loop resumed from step_4
    bare_ms_2, bare_syncs_2 = bare_step_timing(step, qb, db, gen, runs=1)
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
              "save nor evaluate (after step 1); bare: the step alone on hand-built batches, "
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
    outside both bounds. One standard step is profiled (busy time by kernel
    group). Returns the launches and timings."""
    import gc
    import shutil
    import tempfile

    import torch

    root = tempfile.mkdtemp(prefix="chip_smoke_vision_")
    try:
        text_dir, tok, batches, gc_batches, _, evals = lit_inputs(root)
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
        # (the uniform-noise images' reading is cut for the 900 s
        # budget: ROADMAP keeps its diagnosis)
        out["grad_agreement"] = dict(sound=sound, rolled_replay=fault)
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


# -- phase 21: the inference side (the encode CLI, export, long context, MTEB, mining, decoder heads) --

# google/vit-base-patch16-224's config.json: the HF ViT layout at EVA02-B/16's widths
VIT_BASE_CONFIG = {
    "model_type": "vit", "architectures": ["ViTModel"], "hidden_size": 768, "num_hidden_layers": 12,
    "num_attention_heads": 12, "intermediate_size": 3072, "hidden_act": "gelu", "image_size": 224,
    "patch_size": 16, "num_channels": 3, "layer_norm_eps": 1e-12, "qkv_bias": True,
    "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
}
INFER_TEXTS, INFER_BATCH, INFER_SEQ = 2048, 256, 512  # 4096 texts before phase 25, for the 900 s budget
LONG_SEQ, LONG_BATCH, LONG_NTK, LONG_DOCS, LONG_QUERIES = 8192, 8, 2.0, 64, 16
HEADS_B, HEADS_S = 256, 128


def min_row_cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))).min())


def encode_cli_check(dev, card, model, tok, root):
    """The encode CLI's function (`scripts/encode.py:encode_texts`) on 2048
    texts at batch 256 / seq_len 512 into a .npy: 12 flash launches per
    batch, the rows bit for bit those of `Encoder.encode`, --matryoshka_dim
    256 --binarize the packed signs of the first 256 dims, cosine >= 0.999
    against the same weights under attn_impl="sdpa" in fp32; texts/s.
    Returns (row, the texts, the float embeddings)."""
    import torch

    from contrastors_tpu_torch.eval.encoder import Encoder
    from contrastors_tpu_torch.models import BiEncoder
    from contrastors_tpu_torch.models.presets import nomic_bert_2048
    from contrastors_tpu_torch.scripts.encode import encode_texts

    texts = make_texts(np.random.default_rng(21), INFER_TEXTS, 8, INFER_SEQ - 1)
    args = dict(seq_len=INFER_SEQ, batch_size=INFER_BATCH)
    path = os.path.join(root, "embeddings.npy")
    reset_counts()
    np.save(path, encode_texts(model, tok, texts, **args))
    launches = read_counts()
    embs = np.load(path)
    batches = -(-INFER_TEXTS // INFER_BATCH)
    direct = Encoder(model, tok, **args).encode(texts)
    bits = encode_texts(model, tok, texts, matryoshka_dim=256, binarize=True, **args)
    dims = min(256, embs.shape[1])
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        encode_texts(model, tok, texts, **args)
        times.append(time.perf_counter() - t0)
    ref_model = BiEncoder(nomic_bert_2048(attn_impl="sdpa"), pooling="mean", dtype=torch.float32, device=dev)
    ref_model.load_state_dict(model.state_dict())
    ref = Encoder(ref_model.eval(), tok, **args).encode(texts)
    del ref_model
    torch.cuda.empty_cache()
    cos = min_row_cosine(embs, ref)
    row = dict(texts=INFER_TEXTS, batch=INFER_BATCH, seq_len=INFER_SEQ, batches=batches, launches=launches["fwd"],
               launches_per_batch=launches["fwd"] / batches, rows_equal_encoder=bool(np.array_equal(embs, direct)),
               binarize_equals_packed_signs=bool(np.array_equal(bits, np.packbits(embs[:, :dims] > 0, axis=-1))),
               binarized_shape=list(bits.shape), min_cosine_vs_sdpa_fp32=cos,
               encode_s=float(np.median(times)), texts_per_s=INFER_TEXTS / float(np.median(times)))
    ok = (launches == expect(fwd=model.trunk.config.n_layer * batches)
          and embs.shape == (INFER_TEXTS, model.trunk.config.n_embd) and embs.dtype == np.float32
          and bool(np.isfinite(embs).all()) and row["rows_equal_encoder"] and row["binarize_equals_packed_signs"]
          and bits.shape == (INFER_TEXTS, dims // 8) and cos >= SERVING_COSINE)
    emit(phase="inference_encode_cli", card=card, gpu_state=gpu_state(), **row, threshold=SERVING_COSINE, ok=ok)
    if not ok:
        raise AssertionError("encode CLI: launches, the Encoder's rows, the packed bits or agreement with sdpa failed")
    return row, texts, embs


def export_round_trips(dev, card, model, tok, texts, root):
    """Each trunk exported with weights_format="bin" and reloaded by the
    port's `load_biencoder` gives the original model's embeddings bit for
    bit: the dense nomic-bert-2048 trunk (routed to the trust_remote_code
    package), bert-base-uncased's widths (vanilla BERT) and a ViT at
    EVA02-B/16's widths in the HF ViT layout (ViT-B/16); EVA02-B/16 itself
    (2-D rope, SwiGLU with its MLP norm) must be refused. Returns
    (row, the nomic export's directory)."""
    from types import SimpleNamespace

    import torch

    from contrastors_tpu_torch import export
    from contrastors_tpu_torch.config import ModelArgs
    from contrastors_tpu_torch.eval.encoder import Encoder
    from contrastors_tpu_torch.models import BiEncoder, init_weights
    from contrastors_tpu_torch.models.auto import load_biencoder
    from contrastors_tpu_torch.models.hf_interop import bert_config_to_trunk_config
    from contrastors_tpu_torch.models.hf_interop_timm import timm_name_to_trunk_config
    from contrastors_tpu_torch.models.hf_interop_vit import vit_config_to_trunk_config

    rows = {}

    def reload(path, pooling):
        margs = ModelArgs(model_type="encoder", model_name=path, pooling=pooling, attn_impl="flash")
        return load_biencoder(margs, dtype=torch.bfloat16, device=dev)[0].eval()

    def text_round_trip(name, m, cfg):
        path = os.path.join(root, name)
        t0 = time.perf_counter()
        export.export_bert_trunk(m.trunk.state_dict(), cfg, path, weights_format="bin")
        t_export = time.perf_counter() - t0
        again = reload(path, "mean")
        sample = texts[:INFER_BATCH]
        a = Encoder(m, tok, seq_len=INFER_SEQ, batch_size=INFER_BATCH).encode(sample)
        b = Encoder(again, tok, seq_len=INFER_SEQ, batch_size=INFER_BATCH).encode(sample)
        with open(os.path.join(path, "config.json")) as f:
            model_type = json.load(f)["model_type"]
        rows[name] = dict(model_type=model_type, files=sorted(os.listdir(path)), export_s=t_export,
                          bin_mb=os.path.getsize(os.path.join(path, "pytorch_model.bin")) / 2**20,
                          bit_identical=bool(np.array_equal(a, b)))
        del again
        return path

    nomic_dir = text_round_trip("nomic-bert-2048", model, model.trunk.config)
    bert_cfg = bert_config_to_trunk_config(SimpleNamespace(**BERT_BASE_UNCASED_CONFIG), attn_impl="flash")
    bert = init_weights(BiEncoder(bert_cfg, pooling="mean", dtype=torch.bfloat16, device=dev), 31).eval()
    text_round_trip("bert-base-uncased", bert, bert_cfg)
    del bert

    vit_cfg = vit_config_to_trunk_config(VIT_BASE_CONFIG, attn_impl="flash")
    vit = init_weights(BiEncoder(vit_cfg, trunk_type="vision", pooling="cls", dtype=torch.bfloat16, device=dev),
                       32).eval()
    path = os.path.join(root, "vit-base-patch16-224")
    export.export_vit_trunk(vit.trunk.state_dict(), vit_cfg, path, weights_format="bin")
    again = reload(path, "cls")
    img = VIT_BASE_CONFIG["image_size"]
    px = torch.randn(64, 3, img, img, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    with torch.inference_mode():
        a, b = vit(pixel_values=px)["embedding"], again(pixel_values=px)["embedding"]
    rows["vit-base-patch16-224"] = dict(model_type="vit", files=sorted(os.listdir(path)),
                                        bit_identical=bool(torch.equal(a, b)))
    del vit, again
    eva = timm_name_to_trunk_config("timm/vit_eva02_base_patch16_224")
    try:
        export.export_vit_trunk({}, eva, os.path.join(root, "eva02"))
        refusal = None
    except ValueError as e:
        refusal = str(e)
    rows["eva02_base_patch16_224"] = dict(refused=refusal)
    torch.cuda.empty_cache()
    ok = (all(r.get("bit_identical") for k, r in rows.items() if k != "eva02_base_patch16_224")
          and rows["nomic-bert-2048"]["model_type"] == "nomic_bert"
          and "modeling_nomic_bert.py" in rows["nomic-bert-2048"]["files"]
          and rows["bert-base-uncased"]["model_type"] == "bert" and refusal is not None and "rotary" in refusal)
    emit(phase="inference_export", card=card, weights_format="bin", **rows, ok=ok)
    if not ok:
        raise AssertionError("export: a reloaded model's embeddings differ, or EVA02 was not refused")
    return rows, nomic_dir


def long_context_check(dev, card, model_dir, tok, root):
    """`build_long_context_encoder` (seq_len 8192, batch 8, NTK factor 2.0)
    over a written BEIR directory (64 documents of 4097-8190 stand-in
    tokens, 16 queries sharing 16 tokens with their document) through
    `run_beir_dirs`: 12 flash launches per batch, nDCG@10 finite, and one
    batch of 8 documents at cosine >= 0.999 against the same weights under
    attn_impl="sdpa" in fp32 (encoded one row at a time, for memory: a
    row's fp32 scores are 12 x 8192^2 x 4 B = 3.2 GB); documents/s."""
    import torch

    from contrastors_tpu_torch.config import ModelArgs
    from contrastors_tpu_torch.eval.encoder import Encoder
    from contrastors_tpu_torch.eval.eval_long_context import build_long_context_encoder, load_beir_dir
    from contrastors_tpu_torch.models.auto import load_biencoder
    from contrastors_tpu_torch.eval.loco_data import export_beir_dir
    from contrastors_tpu_torch.eval.retrieval import run_beir_dirs

    rng = np.random.default_rng(22)
    # 2 + words tokens each ([CLS], the document prefix): 4098-8191, all in the 8192 bucket
    words = [rng.integers(1000, 30000, size=n) for n in rng.integers(LONG_SEQ // 2, LONG_SEQ - 2, size=LONG_DOCS)]
    corpus = {f"d{i}": {"title": "", "text": " ".join(map(str, w))} for i, w in enumerate(words)}
    queries = {f"q{i}": " ".join(map(str, words[4 * i][100:116])) for i in range(LONG_QUERIES)}
    qrels = {f"q{i}": {f"d{4 * i}": 1} for i in range(LONG_QUERIES)}
    data = export_beir_dir(corpus, queries, qrels, os.path.join(root, "longctx"))
    enc = build_long_context_encoder(model_dir, seq_len=LONG_SEQ, rotary_scaling_factor=LONG_NTK,
                                     batch_size=LONG_BATCH, dtype="bf16", device=dev, tokenizer=tok)
    cfg = enc.module.trunk.config
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_beir_dirs(enc, [data], ks=(10,))
    t_all = time.perf_counter() - t0
    launches = read_counts()
    batches = -(-LONG_DOCS // LONG_BATCH) + -(-LONG_QUERIES // LONG_BATCH)
    c, _, _ = load_beir_dir(data)
    docs = [c[f"d{i}"] for i in range(LONG_BATCH)]
    t0 = time.perf_counter()
    got = enc.encode_corpus(docs)
    t_batch = time.perf_counter() - t0
    margs = ModelArgs(model_type="encoder", model_name=model_dir, pooling="mean", attn_impl="sdpa")
    ref_model = load_biencoder(margs, dtype=torch.float32, device=dev,
                               trunk_overrides=dict(rotary_scaling_factor=LONG_NTK))[0].eval()
    ref = Encoder(ref_model, tok, seq_len=LONG_SEQ, batch_size=1).encode_corpus(docs)
    del ref_model
    torch.cuda.empty_cache()
    cos = min_row_cosine(got, ref)
    ndcg = results["longctx"]["ndcg@10"]
    row = dict(seq_len=LONG_SEQ, batch=LONG_BATCH, ntk_factor=cfg.rotary_scaling_factor,
               max_trained_positions=cfg.max_trained_positions, documents=LONG_DOCS, queries=LONG_QUERIES,
               doc_tokens=[int(min(len(w) for w in words)) + 2, int(max(len(w) for w in words)) + 2],
               batches=batches, launches=launches["fwd"], launches_per_batch=launches["fwd"] / batches,
               ndcg_at_10=ndcg, min_cosine_vs_sdpa_fp32=cos, eval_s=t_all, batch_s=t_batch,
               documents_per_s=LONG_BATCH / t_batch)
    ok = (launches == expect(fwd=cfg.n_layer * batches) and cfg.rotary_scaling_factor == LONG_NTK and np.isfinite(ndcg)
          and cos >= SERVING_COSINE)
    emit(phase="inference_long_context", card=card, gpu_state=gpu_state(), **row, threshold=SERVING_COSINE, ok=ok)
    if not ok:
        raise AssertionError("long context: launches, the NTK factor, nDCG or agreement with sdpa failed")
    return row


def write_mteb_tasks(root, seed=23):
    """Six synthetic tasks, one per type, of a few hundred stand-in texts
    each (numbers, which the stand-in tokenizer maps to themselves), none
    two alike: retrieval (200 documents, 100 queries of 6 of their
    document's 24 tokens), STS (150 pairs sharing 0-10 of 10 tokens, scored
    by that count), classification (200 train / 100 test, two classes on
    disjoint token ranges), clustering (300 texts, three ranges), pair
    classification (150 pairs, half sharing 8 of 10 tokens) and reranking
    (60 queries, one positive and four negatives each)."""
    rng = np.random.default_rng(seed)

    def sent(n=10, lo=1000, hi=30000):
        return [str(x) for x in rng.integers(lo, hi, size=n)]

    def mix(a, keep):
        b = a[:keep] + sent(len(a) - keep)
        rng.shuffle(b)
        return b

    def jsonl(path, rows):
        with open(path, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)

    def task(name):
        d = os.path.join(root, name)
        os.makedirs(d)
        return d

    d = task("SciFact")
    docs = [sent(24) for _ in range(200)]
    jsonl(os.path.join(d, "corpus.jsonl"), [{"_id": f"d{i}", "title": "", "text": " ".join(w)}
                                            for i, w in enumerate(docs)])
    jsonl(os.path.join(d, "queries.jsonl"), [{"_id": f"q{i}", "text": " ".join(docs[2 * i][5:11])} for i in range(100)])
    with open(os.path.join(d, "qrels.tsv"), "w") as f:
        f.write("query-id\tcorpus-id\tscore\n" + "".join(f"q{i}\td{2 * i}\t1\n" for i in range(100)))
    rows = []
    for i in range(150):
        a, keep = sent(), i % 11
        rows.append({"sentence1": " ".join(a), "sentence2": " ".join(mix(a, keep)), "score": float(keep)})
    jsonl(os.path.join(task("STSBenchmark"), "pairs.jsonl"), rows)
    d = task("Banking77Classification")
    label = lambda n, k: [{"text": " ".join(sent(lo=1000 + 9000 * g, hi=10000 + 9000 * g)), "label": g}  # noqa: E731
                          for _ in range(n) for g in range(k)]
    jsonl(os.path.join(d, "train.jsonl"), label(100, 2))
    jsonl(os.path.join(d, "test.jsonl"), label(50, 2))
    jsonl(os.path.join(task("TwentyNewsgroupsClustering"), "docs.jsonl"), label(100, 3))
    rows = []
    for i in range(75):
        a = sent()
        rows.append({"sentence1": " ".join(a), "sentence2": " ".join(mix(a, 8)), "label": 1})
        rows.append({"sentence1": " ".join(sent()), "sentence2": " ".join(sent()), "label": 0})
    jsonl(os.path.join(task("SprintDuplicateQuestions"), "pairs.jsonl"), rows)
    rows = []
    for _ in range(60):
        pos = sent(16)
        rows.append({"query": " ".join(pos[:5]), "positive": [" ".join(pos)], "negative": [" ".join(sent(16))
                                                                                           for _ in range(4)]})
    jsonl(os.path.join(task("SciDocsRR"), "samples.jsonl"), rows)
    return ["SciFact", "STSBenchmark", "Banking77Classification", "TwentyNewsgroupsClustering",
            "SprintDuplicateQuestions", "SciDocsRR"]


def mteb_direct_scores(model, tok, data, tasks):
    """Each task's main score from `Encoder.encode`'s embeddings, outside
    the harness: numpy scores and rankings, with mini_mteb's metric
    functions (spearman, average precision, kmeans + v_measure, softmax
    regression) and the harness's renormalisation of the embeddings."""
    from contrastors_tpu_torch.eval import mini_mteb
    from contrastors_tpu_torch.eval.encoder import Encoder
    from contrastors_tpu_torch.eval.eval_mteb import task_prefixes

    def read(task, name):
        with open(os.path.join(data, task, name)) as f:
            return [json.loads(line) for line in f if line.strip()]

    scores = {}
    for task in tasks:
        qp, dp = task_prefixes(task)
        enc = Encoder(model, tok, seq_len=512, batch_size=64)

        def emb(texts):
            # the harness encodes every task but retrieval without a prefix
            e = enc.encode(texts)
            return e / np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-12)

        if task == "SciFact":
            corpus, queries = read(task, "corpus.jsonl"), read(task, "queries.jsonl")
            d = enc.encode([(c["title"] + " " + c["text"]).strip() for c in corpus], prefix=dp)
            q = enc.encode([r["text"] for r in queries], prefix=qp)
            order = np.argsort(-(q.astype(np.float64) @ d.T.astype(np.float64)), axis=1, kind="stable")
            rank = np.array([np.flatnonzero(order[i] == 2 * i)[0] for i in range(len(queries))])
            scores[task] = float(np.mean(np.where(rank < 10, 1.0 / np.log2(rank + 2), 0.0)))
        elif task in ("STSBenchmark", "SprintDuplicateQuestions"):
            rows = read(task, "pairs.jsonl")
            cos = (emb([r["sentence1"] for r in rows]) * emb([r["sentence2"] for r in rows])).sum(-1)
            if task == "STSBenchmark":
                scores[task] = mini_mteb.spearman(cos, np.array([r["score"] for r in rows]))
            else:
                scores[task] = mini_mteb.average_precision(cos, np.array([r["label"] for r in rows]))
        elif task == "Banking77Classification":
            train, test = read(task, "train.jsonl"), read(task, "test.jsonl")
            pred = mini_mteb.softmax_regression(emb([r["text"] for r in train]), np.array([r["label"] for r in train]),
                                                emb([r["text"] for r in test]))
            scores[task] = float((pred == np.array([r["label"] for r in test])).mean())
        elif task == "TwentyNewsgroupsClustering":
            rows = read(task, "docs.jsonl")
            labels = np.array([r["label"] for r in rows])
            scores[task] = mini_mteb.v_measure(labels, mini_mteb.kmeans(emb([r["text"] for r in rows]),
                                                                        len(np.unique(labels))))
        else:  # reranking: every query in one call, every document in another, as the harness batches them
            rows = read(task, "samples.jsonl")
            q = emb([r["query"] for r in rows])
            docs = emb([t for r in rows for t in r["positive"] + r["negative"]])
            aps, start = [], 0
            for i, r in enumerate(rows):
                n = len(r["positive"]) + len(r["negative"])
                labels = np.array([1] * len(r["positive"]) + [0] * len(r["negative"]))
                aps.append(mini_mteb.average_precision(docs[start:start + n] @ q[i], labels))
                start += n
            scores[task] = float(np.mean(aps))
    return scores


def mteb_check(dev, card, model, tok, root):
    """The six synthetic tasks (`write_mteb_tasks`) through
    `eval_mteb.run_mteb` with the offline runner: the scores finite, equal
    (within 1e-6) to `mteb_direct_scores` from the same model, and
    `score_table` reading the output folder."""
    from contrastors_tpu_torch.eval.eval_mteb import run_mteb
    from contrastors_tpu_torch.eval.mteb_tools import score_table

    data, out = os.path.join(root, "mteb_data"), os.path.join(root, "mteb_results")
    tasks = write_mteb_tasks(data)
    reset_counts()
    t0 = time.perf_counter()
    results = run_mteb(model, tok, tasks, out, local_data_dir=data, seq_len=512, batch_size=64)
    t_run = time.perf_counter() - t0
    launches = read_counts()
    got = {t: results[t]["test"]["main_score"] for t in tasks}
    want = mteb_direct_scores(model, tok, data, tasks)
    table = score_table(out)
    diff = max(abs(got[t] - want[t]) for t in tasks)
    ok = (all(np.isfinite(v) for v in got.values()) and diff <= 1e-6 and table["n_tasks"] == 6
          and len(table["per_type"]) == 6 and launches["fwd"] > 0 and launches["fwd"] % 12 == 0)
    emit(phase="inference_mteb", card=card, scores=got, direct_scores=want, max_abs_diff=diff,
         average=table["average"], per_type=table["per_type"], launches=launches["fwd"], run_s=t_run, ok=ok)
    if not ok:
        raise AssertionError("offline MTEB: non-finite scores, disagreement with the direct scores, or the table")
    return dict(scores=got, max_abs_diff=diff, launches=launches["fwd"], run_s=t_run)


def exact_embeddings(n=4096, dim=768, seed=24):
    """Queries and documents whose every dot product is exact in fp32, in
    any order of summation, and distinct per query: 767 coordinates of
    64 x {-2..2} (so each product is 4096 x an integer of at most 4 and
    every partial sum stays below 4096 x 3068), and a last one, 1 for the
    queries and the document's index for the documents (a tie-breaker
    under 4096). Document i is query i's positive (the query with a fifth
    of its coordinates moved by one), and every odd document nearly repeats
    the even one before it (false negatives for the margin)."""
    rng = np.random.default_rng(seed)
    q_int = rng.integers(-2, 3, size=(n, dim - 1))
    moved = rng.random(size=q_int.shape) < 0.2
    d_int = np.clip(q_int + moved * rng.choice([-1, 1], size=q_int.shape), -2, 2)
    d_int[1::2] = d_int[0::2]
    d_int[1::2, :10] = rng.integers(-2, 3, size=(n // 2, 10))
    q = np.concatenate([64.0 * q_int, np.ones((n, 1))], axis=1).astype(np.float32)
    d = np.concatenate([64.0 * d_int, np.arange(n)[:, None]], axis=1).astype(np.float32)
    return q, d


def mine_reference(q, d, positives, num_negatives, margin, k):
    """`mine` by a numpy full sort in float64 of the same embeddings."""
    scores = q.astype(np.float64) @ d.T.astype(np.float64)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    out = []
    for i in range(len(q)):
        pos = positives[i]
        pos_score = float(q[i] @ d[pos])
        negs, overflow = [], []
        for j in order[i]:
            if j == pos:
                continue
            if scores[i, j] >= margin * pos_score:
                overflow.append(int(j))
                continue
            negs.append(int(j))
            if len(negs) == num_negatives:
                break
        while len(negs) < num_negatives and overflow:
            negs.append(overflow.pop())
        out.append(negs)
    return out


def mining_check(dev, card, real_q, real_d):
    """`mine` (7 negatives, margin 0.95, chunks of 1024) and
    `consistency_keep_mask` (top 2, all 4096 and a pool of 1024) on 4096
    pairs of `exact_embeddings`, on the card, against a numpy full sort and
    count in float64: identical lists and masks. Read beside it, not
    bounded: the same on the encode CLI's embeddings (queries with the
    search_query prefix), where the card's fp32 products and numpy's differ
    in their last bits."""
    from contrastors_tpu_torch.scripts.consistency_filter import consistency_keep_mask
    from contrastors_tpu_torch.scripts.mine_hard_negatives import mine

    q, d = exact_embeddings()
    pos = np.arange(len(q))
    t0 = time.perf_counter()
    got = mine(q, d, pos, num_negatives=7, margin=0.95, device=dev)
    t_mine = time.perf_counter() - t0
    want = mine_reference(q, d, pos, 7, 0.95, k=7 + 32)
    skipped = sum(1 for i, negs in enumerate(want) if i % 2 == 0 and i + 1 not in negs)
    masks = {}
    for pool in (0, len(q) // 4):
        keep = consistency_keep_mask(q, d, top_k=2, pool_size=pool, seed=0, device=dev)
        pool_idx = np.random.default_rng(0).choice(len(q), size=pool, replace=False) if pool else np.arange(len(q))
        scores = q.astype(np.float64) @ d[pool_idx].T.astype(np.float64)
        ref = (scores > (q.astype(np.float64) * d.astype(np.float64)).sum(-1)[:, None]).sum(1) < 2
        masks[pool] = dict(equal=bool(np.array_equal(keep, ref)), kept=int(keep.sum()))
    real_pos = np.arange(len(real_q))
    real = mine(real_q, real_d, real_pos, num_negatives=7, margin=0.95, device=dev)
    real_ref = mine_reference(real_q, real_d, real_pos, 7, 0.95, k=7 + 32)
    # how far apart the candidates' scores lie: the spread of each row's 39 best, in float64
    real_top = -np.sort(-(real_q.astype(np.float64) @ real_d.T.astype(np.float64)), axis=1)[:, :39]
    row = dict(pairs=len(q), dim=q.shape[1], lists_equal=got == want, false_negatives_skipped=skipped,
               mine_s=t_mine, keep_masks=masks,
               real_embeddings_lists_differing=sum(a != b for a, b in zip(real, real_ref)),
               real_median_top39_spread=float(np.median(real_top[:, 0] - real_top[:, -1])),
               real_median_top39_gap=float(np.median(np.diff(-real_top, axis=1))))
    ok = row["lists_equal"] and all(m["equal"] for m in masks.values()) and skipped > 0
    emit(phase="inference_mining", card=card, **row, ok=ok)
    if not ok:
        raise AssertionError("mining: the device's lists or keep masks differ from numpy's")
    return row


def decoder_heads_check(dev, card):
    """The decoder heads at pythia-160m's published widths (12 x 768, H 12,
    rotary on 16 of 64 dims, parallel residual, vocab 50304, untied
    embed_out), bf16 compute, seeded weights, 256 x 128 padded rows: the
    causal LM's forward (12 causal flash launches; the logits at every live
    position at cosine >= 0.999 against the same weights under sdpa in
    fp32), one loss.backward (12 dq and 12 dk/dv launches; each gradient
    tensor at cosine >= 0.999 against sdpa's in bf16, as phase 7 holds the
    train step's, and read against fp32), the peak memory of forward and
    backward (the fp32 loss keeps no copy of the 3.3 GB logits; read
    beside the same step with the plain masked CE, which does), then the
    sequence, token and QA heads' forwards (12 launches each, finite)."""
    import torch

    from contrastors_tpu_torch.models import (DecoderForCausalLM, DecoderForQuestionAnswering,
                                              DecoderForSequenceClassification, DecoderForTokenClassification,
                                              init_weights)
    from contrastors_tpu_torch.models import hf_interop_decoder as dec
    from contrastors_tpu_torch.models.decoder_heads import shift_labels
    from contrastors_tpu_torch.models.nomic_bert import masked_cross_entropy

    cfg = dec.decoder_config_to_trunk_config(PYTHIA_160M_CONFIG, attn_impl="flash", num_labels=5)
    rng = np.random.default_rng(25)
    lens = rng.integers(HEADS_S // 2, HEADS_S + 1, size=HEADS_B)
    lens[0] = HEADS_S
    mask_np = (np.arange(HEADS_S)[None] < lens[:, None]).astype(np.int64)
    ids = torch.from_numpy(rng.integers(1000, cfg.vocab_size - 1000, size=(HEADS_B, HEADS_S)) * mask_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    labels = torch.where(mask > 0, ids, torch.full_like(ids, -100))

    def causal(impl, dtype):
        m = DecoderForCausalLM(cfg.replace(attn_impl=impl), dtype=dtype, device=dev)
        return init_weights(m, 26)

    model = causal("flash", torch.bfloat16)
    reset_counts()
    with torch.inference_mode():
        logits = model(ids, mask)["logits"]
    fwd_launches = read_counts()
    live = mask.bool()
    with torch.inference_mode():
        ref32 = causal("sdpa", torch.float32)(ids, mask)["logits"]
        cosines = []
        for r in range(0, HEADS_B, 32):  # 32 rows at a time: no fp32 copy of the whole logits
            a, b = logits[r:r + 32][live[r:r + 32]].float(), ref32[r:r + 32][live[r:r + 32]]
            cosines.append(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min())
        logits_cos = float(torch.stack(cosines).min())
    del ref32, a, b, logits
    torch.cuda.empty_cache()

    def grads(m, plain_ce=False):
        """(gradients, loss, peak GB above the model) of one loss.backward();
        plain_ce: the plain masked CE on the logits (an fp32 copy of them)
        in place of the head's `lm_cross_entropy`."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        if plain_ce:
            out = m(ids, mask)
            out["loss"] = masked_cross_entropy(out["logits"], shift_labels(labels))
        else:
            out = m(ids, mask, labels=labels)
        out["loss"].backward()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        g = {n: p.grad.detach().float().clone() for n, p in m.named_parameters()}
        loss = float(out["loss"].detach())
        del out
        m.zero_grad(set_to_none=True)
        return g, loss, peak

    reset_counts()
    got, loss, peak_gb = grads(model)
    bwd_launches = read_counts()
    plain_ce_peak_gb = grads(model, plain_ce=True)[2]
    ref_bf16 = causal("sdpa", torch.bfloat16)
    want, ref_loss, ref_peak_gb = grads(ref_bf16)
    del ref_bf16
    ref_fp32 = causal("sdpa", torch.float32)
    want32, ref32_loss, _ = grads(ref_fp32)
    del ref_fp32
    torch.cuda.empty_cache()
    vs_bf16, vs_fp32 = compare_grads(got, want), compare_grads(got, want32)
    del got, want, want32

    others = {}
    for name, cls, kw in (("sequence", DecoderForSequenceClassification, dict(labels=torch.arange(HEADS_B, device=dev) % 5)),
                          ("token", DecoderForTokenClassification, dict(labels=torch.where(mask > 0, ids % 5, -100))),
                          ("qa", DecoderForQuestionAnswering, dict(start_positions=torch.zeros(HEADS_B, device=dev),
                                                                   end_positions=torch.full((HEADS_B,), 9, device=dev)))):
        head = init_weights(cls(cfg, dtype=torch.bfloat16, device=dev), 27).eval()
        reset_counts()
        with torch.inference_mode():
            out = head(ids, mask, **kw)
        n = read_counts()
        finite = all(bool(torch.isfinite(v.float()).all()) for v in out.values())
        others[name] = dict(launches=n["fwd"], loss=float(out["loss"]), finite=finite,
                            shapes={k: list(v.shape) for k, v in out.items() if v.dim()})
        del head, out
    torch.cuda.empty_cache()
    logits_gb = HEADS_B * HEADS_S * cfg.vocab_size * 2 / 2**30
    row = dict(batch=HEADS_B, seq_len=HEADS_S, vocab=cfg.vocab_size, forward_launches=fwd_launches["fwd"],
               backward_launches=dict(fwd=bwd_launches["fwd"], dq=bwd_launches["dq"], dkv=bwd_launches["dkv"]),
               min_logit_cosine_vs_sdpa_fp32=logits_cos, loss=loss, sdpa_bf16_loss=ref_loss, sdpa_fp32_loss=ref32_loss,
               grads_vs_sdpa_bf16=vs_bf16, grads_vs_sdpa_fp32=vs_fp32, peak_gb=peak_gb, sdpa_peak_gb=ref_peak_gb,
               plain_ce_peak_gb=plain_ce_peak_gb,
               logits_gb=logits_gb, heads=others)
    ok = (fwd_launches == expect(fwd=12) and bwd_launches == expect(fwd=12, dq=12, dkv=12)
          and logits_cos >= SERVING_COSINE and vs_bf16["min_cosine"] >= 0.999 and np.isfinite(loss)
          and all(h["launches"] == 12 and h["finite"] for h in others.values()))
    emit(phase="inference_decoder_heads", card=card, gpu_state=gpu_state(), **row, ok=ok)
    if not ok:
        raise AssertionError("decoder heads: launches, logits or gradients against sdpa, or the other heads failed")
    return row


def longctx_kernel_timing(dev, card, gen):
    """The long-context case (LONGCTX_CASES) timed: the forward as ms and
    device_ms beside its bound over the live keys and rows (`lens`), its
    plain version (row by row, for memory: the 8 rows' fp32 scores would be
    25.8 GB) and torch SDPA with the equivalent boolean key mask."""
    import torch
    import torch.nn.functional as F

    from contrastors_tpu_torch.ops import flash_attention as fa

    name, shp, opt = LONGCTX_CASES[0]
    B, S, T, H, Hkv, D = (shp[n] for n in ("B", "S", "T", "H", "Hkv", "D"))
    q, k, v, kw = case_inputs(gen, dev, shp, opt)
    lens = kw["attention_mask"].sum(dim=1).tolist()
    b_ms, b_by, flops, nbytes = attention_bound(B, S, T, H, Hkv, D, lens)

    def run():
        return fa.flash_attention_fwd(q, k, v, **kw)

    def plain():
        for r in range(B):
            fa.flash_attention_reference(q[r:r + 1], k[r:r + 1], v[r:r + 1],
                                         attention_mask=kw["attention_mask"][r:r + 1])

    keep = (torch.arange(T, device=dev)[None] < kw["attention_mask"].sum(dim=1)[:, None])[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep)

    row = dict(shape=f"B={B} S=T={S} H={H} D={D}, key lengths {min(lens)}-{max(lens)} (the long-context batch)",
               ms=median_ms(run), device_ms=median_ms(run, queued=True), plain_ms=median_ms(plain, runs=2, warmup=1),
               bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes, library_ms=median_ms(sdpa),
               library_device_ms=median_ms(sdpa, queued=True))
    row["fraction_of_bound"] = row["bound_ms"] / row["device_ms"]
    emit(phase="longctx_kernel_timing", card=card, gpu_state=gpu_state(), case=name, **row,
         library="torch SDPA with the boolean key mask [B, 1, 1, T]")
    del q, k, v, kw, keep
    torch.cuda.empty_cache()
    return row


def inference_phase(dev, card, gen):
    """Phase 21: the inference side at full width with seeded weights and
    the stand-in tokenizer, each part its module: the encode CLI
    (scripts/encode.py), export round trips (export.py, hf_interop*.py),
    long context (eval/eval_long_context.py, eval/retrieval.py,
    eval/loco_data.py), the offline MTEB (eval/eval_mteb.py, mini_mteb.py,
    mteb_tools.py), mining (scripts/mine_hard_negatives.py,
    consistency_filter.py) and the decoder heads (models/decoder_heads.py),
    then the long-context kernel case timed. Returns the rows."""
    import shutil
    import tempfile

    import torch

    from contrastors_tpu_torch.eval.encoder import Encoder
    from contrastors_tpu_torch.eval.stub_tokenizer import StubTokenizer
    from contrastors_tpu_torch.models import BiEncoder
    from contrastors_tpu_torch.models.presets import nomic_bert_2048

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_inference_")
    out = {}
    try:
        cfg = nomic_bert_2048(attn_impl="flash")
        model = seed_weights(BiEncoder(cfg, pooling="mean", dtype=torch.bfloat16, device=dev), "dense").eval()
        tok = StubTokenizer(cfg.vocab_size)
        out["encode"], texts, embs = encode_cli_check(dev, card, model, tok, root)
        out["export"], nomic_dir = export_round_trips(dev, card, model, tok, texts, root)
        out["long_context"] = long_context_check(dev, card, nomic_dir, tok, root)
        out["mteb"] = mteb_check(dev, card, model, tok, root)
        queries = Encoder(model, tok, seq_len=INFER_SEQ, batch_size=INFER_BATCH).encode_queries(texts)
        del model
        torch.cuda.empty_cache()
        out["mining"] = mining_check(dev, card, queries, embs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["decoder_heads"] = decoder_heads_check(dev, card)
    out["kernel"] = longctx_kernel_timing(dev, card, gen)
    emit(phase="inference", card=card, seconds=time.perf_counter() - t_phase,
         texts_per_s=out["encode"]["texts_per_s"], documents_per_s=out["long_context"]["documents_per_s"],
         heads_peak_gb=out["decoder_heads"]["peak_gb"], ok=True)
    return out


# -- phase 22: data-parallel training across processes ------------------------
DIST_WORLD, DIST_STEPS = 2, 3  # 3 steps (4 before phase 23), for the 900 s budget
# bounds stated before the phase's first run (PERF.md): each step's loss of
# two ranks against one rank's at the same global batch, and the cosine of
# the two runs' parameter updates after the last step, per tensor and over
# every tensor at once
DIST_LOSS_RTOL, DIST_UPDATE_COSINE, DIST_UPDATE_COSINE_ALL = 2e-3, 0.99, 0.999
DIST_MLM_ROWS, DIST_MLM_SEQ, DIST_MLM_SHORT = 4, 2048, 64  # rows 2 and 3 hold 64 tokens, the rest padding
DIST_TIMEOUT = 600
TREE = None  # --tree: the checkout whose package this run and its ranks import
DIST_GRAD_ELEMENTS = 136_731_648  # nomic-bert-2048's parameters (phase 5's count)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_pretrain_recipe(paths, world):
    """The trainer phase's pretrain recipe at DIST_STEPS steps of the same
    global batch (512 pairs, chunk 16 a rank), no eval, no checkpoint, one
    log at the end; `world` ranks on the data axis."""
    recipe = trainer_recipe(**paths)
    recipe["train_args"].update(num_train_steps=DIST_STEPS, save_every=None, log_lr_every=DIST_STEPS,
                                eval_strategy=None, output_dir=None)
    recipe["data_args"]["eval_retrieval"] = None
    recipe["parallel_args"] = {"data": world}
    return recipe


def dist_mlm_recipe(model_dir, world):
    """configs/train/mlm.yaml through read_config at DIST_MLM_ROWS global
    rows of 2048 tokens, dropout 0 (the model dir's config.json), one update
    a step, no eval and no checkpoint; `world` ranks on the data axis."""
    from contrastors_tpu_torch.read import read_config

    raw = read_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "train",
                                   "mlm.yaml")).to_dict()
    raw["train_args"].update(num_train_steps=DIST_STEPS, warmup_steps=1, gradient_accumulation_steps=1,
                             eval_strategy=None, eval_steps=None, save_every=None, log_lr_every=DIST_STEPS,
                             output_dir=None, wandb=False)
    raw["model_args"].update(model_name=model_dir)
    raw["data_args"].update(batch_size=DIST_MLM_ROWS)
    raw["parallel_args"] = {"data": world}
    return raw


def dist_mlm_inputs(root):
    """A config.json dir of bert-base-uncased's widths with dropout 0, and
    DIST_STEPS global batches of token ids: rows 0 and 1 of each random
    ids, rows 2 and 3 DIST_MLM_SHORT copies of one id and padding. Rank 1
    masks ~30x fewer tokens than rank 0, and at random init the model's
    loss on them differs from rank 0's, so a mean of the ranks' means is
    far from the global masked mean."""
    model_dir = os.path.join(root, "bert-base-uncased-nodrop")
    os.makedirs(model_dir)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(dict(BERT_BASE_UNCASED_CONFIG, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0), f)
    rng = np.random.default_rng(7)
    ids = rng.integers(1000, 1300, size=(DIST_STEPS * DIST_MLM_ROWS, DIST_MLM_SEQ))
    mask = np.ones_like(ids)
    short = np.arange(len(ids)) % DIST_MLM_ROWS >= DIST_MLM_ROWS // 2
    mask[short, DIST_MLM_SHORT:] = 0
    ids[short] = 1000
    return model_dir, ids * mask, mask


def dist_mlm_class(tokenizer, batches_path, ids=None, mask=None):
    """MLMTrainer with the stand-in tokenizer whose data are the global
    batches masked once (by the one-rank run, with its own _mask_batch, and
    saved to batches_path) and read back by every rank, which takes its
    window of each: two ranks and one rank train on the same masked rows."""
    from contrastors_tpu_torch.trainers import MLMTrainer

    base = chip_trainer_class(MLMTrainer, tokenizer)

    class Batches:
        def __init__(self, trainer):
            self.trainer = trainer

        def __iter__(self):
            t = self.trainer
            if ids is not None:
                rng = np.random.default_rng(0)
                batches = [t._mask_batch(ids[i:i + DIST_MLM_ROWS], mask[i:i + DIST_MLM_ROWS], 0.3, rng)
                           for i in range(0, len(ids), DIST_MLM_ROWS)]
                np.savez(batches_path, **{f"{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})
            else:
                with np.load(batches_path) as z:
                    flat = {key: z[key] for key in z.files}
                batches = [{k.split("/")[1]: v for k, v in flat.items() if k.split("/")[0] == str(i)}
                           for i in range(DIST_STEPS)]
                per = DIST_MLM_ROWS // t.mesh.data
                rows = slice(t.mesh.rank * per, (t.mesh.rank + 1) * per)
                batches = [{k: v[rows] for k, v in b.items()} for b in batches]
            return iter(batches)

    class DistMLM(base):
        def get_dataloaders(self):
            self._val = None
            return Batches(self), DIST_STEPS

    return DistMLM


def initial_params_class(base):
    """base whose model keeps a copy of its initial parameters (`init`)."""

    class Kept(base):
        def get_model(self):
            model = super().get_model()
            self.init = {n: p.detach().clone() for n, p in model.named_parameters()}
            return model

    return Kept


def update_cosines(model, init, ref_delta):
    """Per-tensor cosine between this run's update (final - init) and the
    reference's (ref_delta), over the tensors the reference moved."""
    import torch

    out, dot, got_sq, ref_sq = {}, 0.0, 0.0, 0.0
    for n, p in model.named_parameters():
        ref = ref_delta[n].to(p.device).double()
        if float(ref.norm()) == 0.0:
            continue
        got = (p.detach() - init[n]).double()
        d, g, r = float((got * ref).sum()), float(got.square().sum()), float(ref.square().sum())
        out[n] = d / max((g * r) ** 0.5, 1e-300)
        dot, got_sq, ref_sq = dot + d, got_sq + g, ref_sq + r
    return out, dot / max((got_sq * ref_sq) ** 0.5, 1e-300)


@contextlib.contextmanager
def collectives_outside_sync_log():
    """The torch.distributed collectives run with sync debug mode off: gloo
    stages CUDA tensors through the host, and what the phase counts are
    the synchronising calls outside the collectives."""
    import torch
    import torch.distributed as dist

    names = ("all_reduce", "all_gather", "broadcast", "barrier")
    saved = {n: getattr(dist, n) for n in names}

    def quiet(fn):
        def call(*args, **kwargs):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(mode)

        return call

    for n in names:
        setattr(dist, n, quiet(saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def collective_ms(fn, dev, runs=3):
    """Median host ms of fn() ended by a synchronize, after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize(dev)
    ms = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def dist_timings(trainer, dev, rows):
    """ms of the step's three collectives on this process group, at the
    step's sizes: the gradient all-reduce (every gradient of the model, one
    flat fp32 buffer), the embedding gather of `rows` x 768 fp32, and the
    sharded optimizer's gather of the updated rows (one flat buffer; the
    rows are those of the last step, so the parameters stay as they are)."""
    import torch
    import torch.distributed as dist

    from contrastors_tpu_torch.parallel.collectives import all_gather_rows, all_reduce_grads

    params = [p for p in trainer.model.parameters() if p.grad is not None]
    emb = torch.randn(rows, 768, device=dev)
    opt = trainer.optimizer
    return dict(grad_all_reduce_ms=collective_ms(lambda: all_reduce_grads(params, dist.group.WORLD), dev),
                grad_elements=sum(p.numel() for p in params),
                embedding_gather_ms=collective_ms(lambda: all_gather_rows(emb, dist.group.WORLD), dev),
                embedding_rows=rows,
                optimizer_gather_ms=collective_ms(opt.gather_updated_rows, dev),
                optimizer_gather_elements=sum(p.numel() for p, s in zip(opt.full_params, opt.sharded)
                                              if s and p.grad is not None))


def dist_case_pretrain(spec, dev, rank, fault=False):
    """The pretrain recipe on this rank; with `fault`, the labels lose the
    rank offset (every rank's queries point at rank 0's documents)."""
    import torch

    from contrastors_tpu_torch import losses
    from contrastors_tpu_torch.parallel.mesh import fingerprint

    saved = losses.group_rank
    if fault:
        losses.group_rank = lambda group: 0
    try:
        cls = initial_params_class(chip_trainer_class())
        torch.cuda.reset_peak_memory_stats(dev)
        with collectives_outside_sync_log():
            trainer, rows, seconds, _, _ = run_chip_trainer(dist_pretrain_recipe(spec["paths"], spec["world"]),
                                                            dev, cls)
    finally:
        losses.group_rank = saved
    out = dict(losses=[r["loss"] for r in rows], launches=[r["launches"] for r in rows],
               step_ms=[r["iteration_ms"] for r in rows],
               quiet_syncs=[r["iteration_syncs"] for r in quiet_rows(rows, {DIST_STEPS})],
               peak_gb=torch.cuda.max_memory_allocated(dev) / 2**30, seconds=seconds,
               replicas_agreed=trainer.init_replicas_agreed,
               sharded_optimizer=type(trainer.optimizer).__name__,
               init_fingerprint=fingerprint(trainer.init.values()))
    if rank == 0:
        ref = torch.load(spec["ref_delta"], map_location="cpu", weights_only=True)
        cos, cos_all = update_cosines(trainer.model, trainer.init, ref)
        worst = min(cos, key=cos.get)
        out.update(update_cosine_min=cos[worst], update_cosine_worst=worst, update_cosine_all=cos_all,
                   update_tensors=len(cos))
    if not fault:
        out.update(dist_timings(trainer, dev, PAIRS // spec["world"]))
    del trainer
    torch.cuda.empty_cache()
    return out


def dist_case_mlm(spec, dev, rank, fault=False):
    """The MLM recipe on this rank; with `fault`, the loss is the mean of the
    ranks' means, not the global masked mean."""
    import torch

    from contrastors_tpu_torch.eval.stub_tokenizer import StubTokenizer
    from contrastors_tpu_torch.trainers import mlm as mlm_module

    saved = mlm_module.masked_mean_weight
    if fault:
        mlm_module.masked_mean_weight = lambda labels, group: 1.0
    try:
        cls = dist_mlm_class(StubTokenizer(BERT_BASE_UNCASED_CONFIG["vocab_size"]), spec["mlm_batches"])
        torch.cuda.reset_peak_memory_stats(dev)
        with collectives_outside_sync_log():
            trainer, rows, seconds, _, _ = run_chip_trainer(dist_mlm_recipe(spec["mlm_dir"], spec["world"]), dev, cls)
    finally:
        mlm_module.masked_mean_weight = saved
    masked = [int((b["labels"] >= 0).sum()) for b in iter(trainer.dataloader)]
    out = dict(losses=[r["loss"] for r in rows], launches=[r["launches"] for r in rows],
               step_ms=[r["iteration_ms"] for r in rows], masked_tokens=masked,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 2**30, seconds=seconds)
    del trainer
    torch.cuda.empty_cache()
    return out


def dist_case_collectives(spec, dev, rank):
    """The collectives on this process group (NCCL by default): the
    differentiable gather forward and backward, the gradient all-reduce,
    the metric and host reductions, the broadcast, each against what it
    must give; and their ms at the pretrain step's sizes."""
    import torch
    import torch.distributed as dist

    from contrastors_tpu_torch.parallel import all_gather_rows, all_reduce_grads, make_mesh, reduce_metrics, replicate
    from contrastors_tpu_torch.utils import dist as du

    world, group = dist.get_world_size(), dist.group.WORLD
    gen = torch.Generator(device=dev).manual_seed(rank)
    x = torch.randn(PAIRS // world, 768, device=dev, generator=gen, requires_grad=True)
    y = all_gather_rows(x, group)
    lo = rank * x.shape[0]
    y.backward(torch.full_like(y, float(rank + 1)))
    lin = torch.nn.Linear(768, 768, device=dev)
    replicate(lin, make_mesh())
    lin(y.detach()).sum().backward()  # the same input on every rank: the same gradient
    own = lin.weight.grad.clone()
    all_reduce_grads(lin.parameters(), group)
    reduced = reduce_metrics({"loss": torch.tensor(1.0, device=dev), "accuracy": torch.tensor(float(rank), device=dev)},
                             group, summed=("loss",))
    host = du.process_allmean({"m": float(rank)})
    checks = dict(
        gather_rows=bool(torch.equal(y[lo:lo + x.shape[0]], x.detach())) and y.shape[0] == PAIRS,
        gather_backward=bool(torch.equal(x.grad, torch.full_like(x, world * (world + 1) / 2))),
        all_reduce=bool(torch.equal(lin.weight.grad, own * world)),
        reduce_metrics=abs(float(reduced["loss"]) - world) < 1e-6
        and abs(float(reduced["accuracy"]) - (world - 1) / 2) < 1e-6,
        process_allmean=abs(host["m"] - (world - 1) / 2) < 1e-6,
        backend=dist.get_backend(), current_device=torch.cuda.current_device(),
    )
    flat = [torch.zeros(DIST_GRAD_ELEMENTS, device=dev)]  # the pretrain model's gradients, one fp32 buffer
    flat[0].grad = torch.randn(DIST_GRAD_ELEMENTS, device=dev, generator=gen)
    timing = dict(grad_all_reduce_ms=collective_ms(lambda: all_reduce_grads(flat, group), dev),
                  grad_elements=flat[0].numel(),
                  embedding_gather_ms=collective_ms(lambda: all_gather_rows(x.detach(), group), dev),
                  embedding_rows=x.shape[0])
    ok = all(v for k, v in checks.items() if k not in ("backend", "current_device"))
    return dict(checks=checks, ok=ok, env={k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")},
                **timing)


DIST_CASES = {
    "pretrain": dist_case_pretrain,
    "pretrain_fault": lambda spec, dev, rank: dist_case_pretrain(spec, dev, rank, fault=True),
    "mlm": dist_case_mlm,
    "mlm_fault": lambda spec, dev, rank: dist_case_mlm(spec, dev, rank, fault=True),
    "collectives": dist_case_collectives,
}


def dist_rank_main(spec_path):
    """One rank of the distributed phase, in torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT, and
    $CONTRASTORS_DIST_BACKEND where the caller chose a backend): import the
    package from the spec's tree (the launcher's), join the process group
    on the device the spec names, run the spec's cases in order and write
    each result, with the package's path, to <out>/<case>.rank<r>.json.
    Any error exits non-zero."""
    with open(spec_path) as f:
        spec = json.load(f)
    if spec.get("tree"):
        sys.path.insert(0, spec["tree"])
    import torch

    import contrastors_tpu_torch
    from contrastors_tpu_torch.utils import dist as du

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    du.maybe_initialize_distributed(device=spec.get("device"))
    rank = du.rank()
    dev = torch.device(spec["device"]) if spec.get("device") else torch.device("cuda", torch.cuda.current_device())
    try:
        for case in spec["cases"]:
            result = dict(DIST_CASES[case](spec, dev, rank), package=contrastors_tpu_torch.__file__)
            with open(os.path.join(spec["out"], f"{case}.rank{rank}.json"), "w") as f:
                json.dump(result, f)
            du.barrier()
    finally:
        du.destroy()
    return 0


def launch_ranks(spec, root, name, world, devices=None):
    """Start `world` ranks of this script in torchrun's environment (with
    $CONTRASTORS_DIST_BACKEND set to spec["backend"] where it names one),
    on the package this process imported (`--tree`), wait for them (killing
    every one at DIST_TIMEOUT), and return {case: [each rank's result]}; a
    failed rank, or one that imported another package, raises."""
    import contrastors_tpu_torch

    out = os.path.join(root, name)
    os.makedirs(out)
    spec = dict(spec, out=out, world=world, tree=TREE)
    spec_path = os.path.join(out, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        env.pop("CONTRASTORS_DIST_BACKEND", None)
        if spec.get("backend"):
            env["CONTRASTORS_DIST_BACKEND"] = spec["backend"]
        if devices is not None:
            spec_rank = dict(spec, device=devices[rank])
            path = os.path.join(out, f"spec{rank}.json")
            with open(path, "w") as f:
                json.dump(spec_rank, f)
        else:
            path = spec_path
        log = open(os.path.join(out, f"rank{rank}.log"), "w")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-worker", path],
                                      env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    deadline = time.perf_counter() + DIST_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        logs = []
        for rank in range(world):
            with open(os.path.join(out, f"rank{rank}.log")) as f:
                logs.append(f"--- rank {rank} (rc {procs[rank].returncode}) ---\n" + f.read()[-6000:])
        raise AssertionError(f"distributed {name}: a rank failed\n" + "\n".join(logs))
    results = {}
    for case in spec["cases"]:
        results[case] = []
        for rank in range(world):
            with open(os.path.join(out, f"{case}.rank{rank}.json")) as f:
                results[case].append(json.load(f))
            if results[case][-1]["package"] != contrastors_tpu_torch.__file__:
                raise AssertionError(f"distributed {name}: rank {rank} imported {results[case][-1]['package']}, "
                                     f"the launcher {contrastors_tpu_torch.__file__}")
    return results


def rel_diffs(a, b):
    return [abs(x - y) / abs(y) for x, y in zip(a, b)]


def distributed_phase(dev, card):
    """Phase distributed: data-parallel training across processes on the
    card. The pretrain recipe (full nomic-bert-2048 width, 512 pairs of
    32 / 256 tokens, grad cache with chunk 16 a rank, DIST_STEPS steps, the
    sharded optimizer state) and the MLM recipe (bert-base-uncased's widths,
    4 x 2048, dropout 0) through train.run on one rank in this process, then
    on two ranks of this script (torchrun's environment, gloo, both on card
    0: NCCL refuses two ranks on one device), with a planted fault each;
    then NCCL at world size 1, and NCCL across two cards where there are
    two. Returns the launches of one two-rank pretrain step per rank."""
    import gc
    import tempfile

    import torch

    from contrastors_tpu_torch.eval.stub_tokenizer import StubTokenizer
    from contrastors_tpu_torch.parallel.mesh import fingerprint

    root = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    paths = write_trainer_inputs(root)
    n_layer, n_bert = NOMIC_BERT_2048_CONFIG["n_layer"], BERT_BASE_UNCASED_CONFIG["num_hidden_layers"]
    expected_mlm = expect(fwd=n_bert, dq=n_bert, dkv=n_bert)
    per_rank = PAIRS // DIST_WORLD
    expected_rank = expect(fwd=n_layer * (1 + 2 * per_rank // CHUNK), dq=n_layer * (1 + per_rank // CHUNK),
                           dkv=n_layer * (1 + per_rank // CHUNK))
    expected_one = expect(fwd=n_layer * (1 + 2 * PAIRS // CHUNK), dq=n_layer * (1 + PAIRS // CHUNK),
                          dkv=n_layer * (1 + PAIRS // CHUNK))

    # one rank, this process: the reference losses and parameter update
    gc.collect()
    torch.cuda.empty_cache()
    cls = initial_params_class(chip_trainer_class())
    one, rows, one_seconds, _, _ = run_chip_trainer(dist_pretrain_recipe(paths, 1), dev, cls)
    one_losses = [r["loss"] for r in rows]
    ref_delta = {n: (p.detach() - one.init[n]).cpu() for n, p in one.model.named_parameters()}
    ref_path = os.path.join(root, "ref_delta.pt")
    torch.save(ref_delta, ref_path)
    one_launches = [r["launches"] for r in rows]
    one_step_ms = [r["iteration_ms"] for r in rows]
    one_fingerprint = fingerprint(one.init.values())
    del one, ref_delta, rows, cls
    gc.collect()
    torch.cuda.empty_cache()

    mlm_dir, ids, mask = dist_mlm_inputs(root)
    mlm_batches = os.path.join(root, "mlm_batches.npz")
    tok = StubTokenizer(BERT_BASE_UNCASED_CONFIG["vocab_size"])
    one_mlm, mlm_rows, _, _, _ = run_chip_trainer(dist_mlm_recipe(mlm_dir, 1), dev,
                                                  dist_mlm_class(tok, mlm_batches, ids, mask))
    one_mlm_losses = [r["loss"] for r in mlm_rows]
    one_mlm_launches = [r["launches"] for r in mlm_rows]
    del one_mlm, mlm_rows
    gc.collect()
    torch.cuda.empty_cache()

    # two ranks on the one card, gloo
    spec = dict(backend="gloo", device="cuda:0", paths=paths, ref_delta=ref_path, mlm_dir=mlm_dir,
                mlm_batches=mlm_batches, cases=["pretrain", "pretrain_fault", "mlm", "mlm_fault"])
    t0 = time.perf_counter()
    two = launch_ranks(spec, root, "gloo_two_ranks", DIST_WORLD)
    two_seconds = time.perf_counter() - t0

    def pretrain_gates(res):
        r0 = res[0]
        loss_rel = max(rel_diffs(r0["losses"], one_losses))
        return dict(
            loss_rel=loss_rel, update_cosine_min=r0["update_cosine_min"],
            update_cosine_worst=r0["update_cosine_worst"], update_cosine_all=r0["update_cosine_all"],
            losses_within=loss_rel <= DIST_LOSS_RTOL,
            updates_within=r0["update_cosine_min"] >= DIST_UPDATE_COSINE
            and r0["update_cosine_all"] >= DIST_UPDATE_COSINE_ALL,
        )

    good, bad = pretrain_gates(two["pretrain"]), pretrain_gates(two["pretrain_fault"])
    mlm_rel = max(rel_diffs(two["mlm"][0]["losses"], one_mlm_losses))
    mlm_fault_rel = max(rel_diffs(two["mlm_fault"][0]["losses"], one_mlm_losses))
    pre = two["pretrain"]
    checks = dict(
        pretrain_losses_within=good["losses_within"],
        pretrain_updates_within=good["updates_within"],
        fault_fails_losses=not bad["losses_within"],
        fault_fails_updates=not bad["updates_within"],
        ranks_log_the_same_losses=all(r["losses"] == pre[0]["losses"] for r in pre),
        one_rank_launches=all(x == expected_one for x in one_launches),
        launches_per_rank=all(x == expected_rank for r in pre for x in r["launches"]),
        same_initial_parameters=all(r["init_fingerprint"] == one_fingerprint and r["replicas_agreed"] for r in pre),
        optimizer_state_sharded=all(r["sharded_optimizer"] == "ShardedAdamW" for r in pre),
        no_sync_outside_collectives=all(n == 0 for r in pre for n in r["quiet_syncs"]),
        losses_finite=bool(np.isfinite([x for r in pre for x in r["losses"]]).all()),
        mlm_losses_within=mlm_rel <= DIST_LOSS_RTOL,
        mlm_fault_fails=mlm_fault_rel > DIST_LOSS_RTOL,
        mlm_launches=all(x == expected_mlm for r in two["mlm"] for x in r["launches"])
        and all(x == expected_mlm for x in one_mlm_launches),
    )
    ok = all(checks.values())
    emit(phase="distributed", card=card, gpu_state=gpu_state(), backend="gloo", ranks=DIST_WORLD,
         device="cuda:0 (both ranks)", recipe="configs/train/contrastive_pretrain.yaml", pairs=PAIRS,
         pairs_per_rank=per_rank, chunk_per_rank=CHUNK, steps=DIST_STEPS,
         bounds=dict(loss_rtol=DIST_LOSS_RTOL, update_cosine_per_tensor=DIST_UPDATE_COSINE,
                     update_cosine_all=DIST_UPDATE_COSINE_ALL),
         one_rank_losses=one_losses, two_rank_losses=[r["losses"] for r in pre], pretrain=good,
         planted_fault_labels_without_rank_offset=dict(bad, losses=two["pretrain_fault"][0]["losses"]),
         expected_launches_per_rank=expected_rank, launches_per_rank=[r["launches"][1] for r in pre],
         one_rank_launches=one_launches[1], quiet_syncs=[r["quiet_syncs"] for r in pre],
         mlm=dict(recipe="configs/train/mlm.yaml", rows=DIST_MLM_ROWS, seq=DIST_MLM_SEQ,
                  one_rank_losses=one_mlm_losses, two_rank_losses=two["mlm"][0]["losses"], loss_rel=mlm_rel,
                  masked_tokens_per_rank=[r["masked_tokens"] for r in two["mlm"]],
                  planted_fault_mean_of_rank_means=dict(losses=two["mlm_fault"][0]["losses"],
                                                        loss_rel=mlm_fault_rel)),
         checks=checks, ok=ok)
    emit(phase="distributed_timing", card=card, gpu_state=gpu_state(),
         note="gloo, two ranks sharing one card: not NCCL's speed; step ms: host clock from one loop step's "
              "start to the next; collectives: median host ms ended by a synchronize, at the step's sizes",
         one_rank_step_ms=one_step_ms, step_ms_per_rank=[r["step_ms"] for r in pre],
         grad_all_reduce_ms=[r["grad_all_reduce_ms"] for r in pre], grad_elements=pre[0]["grad_elements"],
         embedding_gather_ms=[r["embedding_gather_ms"] for r in pre], embedding_rows=pre[0]["embedding_rows"],
         optimizer_gather_ms=[r["optimizer_gather_ms"] for r in pre],
         optimizer_gather_elements=pre[0]["optimizer_gather_elements"],
         peak_gb_per_rank=[r["peak_gb"] for r in pre], mlm_step_ms_per_rank=[r["step_ms"] for r in two["mlm"]],
         mlm_peak_gb_per_rank=[r["peak_gb"] for r in two["mlm"]], two_rank_seconds=two_seconds,
         one_rank_seconds=one_seconds)
    if not ok:
        raise AssertionError(f"distributed: a check failed: {checks}")

    # NCCL at world size 1 (torchrun's environment, the default backend on a
    # card), and across two cards only where there are two
    nccl = launch_ranks(dict(cases=["collectives"]), root, "nccl_one_rank", 1)["collectives"]
    count = torch.cuda.device_count()
    nccl2 = (launch_ranks(dict(cases=["collectives"]), root, "nccl_two_cards", 2, devices=["cuda:0", "cuda:1"])
             ["collectives"] if count >= 2 else None)
    nccl_ok = all(r["ok"] and r["checks"]["backend"] == "nccl" for r in nccl + (nccl2 or []))
    emit(phase="distributed_nccl", card=card, gpu_state=gpu_state(), world_1=nccl,
         two_cards=nccl2 if nccl2 is not None else f"not run: {count} card(s)", ok=nccl_ok)
    shutil.rmtree(root)
    if not nccl_ok:
        raise AssertionError("distributed: an NCCL collective check failed")
    return pre[0]["launches"][1]


# -- the training step's last single-card knobs (phase 23) ---------------------
KNOB_K, KNOB_STEPS = 4, 3  # segments a packed row; train.run steps of the packed recipe
# words of a query / a document: with [CLS] and the prefix word, <= 32 / <= 256 tokens;
# the default geometry truncates a few documents, and the phase reads the kept share
KNOB_Q_WORDS, KNOB_D_WORDS = (2, 30), (8, 254)
KNOB_EC_STEPS = 2  # expert-choice steps
KNOB_ENC_B, KNOB_ENC_S = 256, 512  # the MoE encode batch


def knob_lengths(rng, n, median, lo, hi):
    return np.clip(rng.lognormal(np.log(median), 0.7, size=n), lo, hi).astype(int)


def write_packed_inputs(root, seed=0):
    """nomic-bert-2048's config.json and KNOB_STEPS batches of PAIRS pairs
    with lognormal lengths (queries of median 12 words, documents of median
    64, clipped to KNOB_Q_WORDS / KNOB_D_WORDS); each document starts with
    its query's words."""
    rng = np.random.default_rng(seed)
    paths = dict(model_dir=os.path.join(root, "nomic-bert-2048"), pairs=os.path.join(root, "pairs.jsonl"))
    os.makedirs(paths["model_dir"])
    with open(os.path.join(paths["model_dir"], "config.json"), "w") as f:
        json.dump(NOMIC_BERT_2048_CONFIG, f)
    n = KNOB_STEPS * PAIRS
    q_lens, d_lens = knob_lengths(rng, n, 12, *KNOB_Q_WORDS), knob_lengths(rng, n, 64, *KNOB_D_WORDS)
    with open(paths["pairs"], "w") as f:
        for lq, ld in zip(q_lens, np.maximum(d_lens, q_lens)):
            q = rng.integers(1000, 30000, size=lq)
            d = np.concatenate([q, rng.integers(1000, 30000, size=ld - lq)])
            f.write(json.dumps({"query": " ".join(map(str, q)), "document": " ".join(map(str, d))}) + "\n")
    return paths


def packed_recipe(model_dir, pairs, packed=True):
    """PRETRAIN_RECIPE with data_args.packed (K = KNOB_K, the default row
    length: 128 tokens for queries of <= 32, 512 for documents of <= 256),
    cut as the trainer phase cuts it (a local config.json with random
    weights, PAIRS pairs a step, warmup 2, every query chunk direct), for
    KNOB_STEPS steps with no checkpoint."""
    recipe = json.loads(json.dumps(PRETRAIN_RECIPE))
    recipe["train_args"].update(num_train_steps=KNOB_STEPS, warmup_steps=2, log_lr_every=KNOB_STEPS,
                                output_dir=None, chunk_size=CHUNK, grad_cache_direct_chunks_q=-1)
    recipe["model_args"].update(model_name=model_dir, pretrained=False)
    recipe["data_args"].update(batch_size=PAIRS, input_shards=pairs, streaming=False, query_max_length=Q_LEN,
                               document_max_length=D_LEN, packed=packed, packed_max_segments=KNOB_K)
    return recipe


def model_grads(model):
    return {n: p.grad.float().clone() for n, p in model.named_parameters() if p.grad is not None}


def adam_first_update(grads, params, eps=1e-8, max_norm=1.0, wd=0.01):
    """The direction of AdamW's first update from these gradients (clipped
    to max_norm; bias-corrected moments g and g^2, so g / (|g| + eps), plus
    the decoupled decay), as one flat vector."""
    import torch

    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).item()
    c = min(1.0, max_norm / max(norm, 1e-30))
    return torch.cat([(c * grads[n] / ((c * grads[n]).abs() + eps) + wd * params[n].float()).flatten()
                      for n in grads])


def vector_cosine(a, b):
    return float((a.double() @ b.double()) / (a.double().norm() * b.double().norm()))


@contextlib.contextmanager
def phase_clock(into):
    """grad_cache.py's profiler ranges timed on the host clock, the card
    synchronized at each range's ends: into[name] gets the ms."""
    import torch

    from contrastors_tpu_torch import grad_cache as gcm

    orig = gcm.record_function

    @contextlib.contextmanager
    def timed(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with orig(name):
                yield
        finally:
            torch.cuda.synchronize()
            into[name] = into.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    gcm.record_function = timed
    try:
        yield into
    finally:
        gcm.record_function = orig


def timed_call(fn):
    """(fn's result, host ms to a synchronize after it)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def kept_lengths(packed, K):
    """Each sequence's tokens in a `pack_tokenized` result (a truncated
    sequence keeps its first ones)."""
    seg = packed["segment_ids"]
    counts = (seg[:, :, None] == np.arange(1, K + 1)).sum(axis=1).reshape(-1)  # [rows * K]
    return counts[packed["pair_index"]]


def knobs_packed(dev, card):
    """Phase 23a, knobs_packed and knobs_packed_agreement: the pretrain
    recipe with data_args.packed through train.run (KNOB_STEPS steps), then,
    on its first batch from the recipe's initial weights, the packed step
    against the padded step on the sequences as packing kept them (each
    mask cut to its kept tokens) and a planted fault (the query pair_index
    rolled by one slot). Returns the launches of one packed loop step."""
    import gc
    import tempfile

    import torch

    from contrastors_tpu_torch.config import Config
    from contrastors_tpu_torch.data.packing import packing_efficiency, packing_kept_fraction
    from contrastors_tpu_torch.models.auto import load_biencoder
    from contrastors_tpu_torch.models.biencoder import BiEncoder, LogitScale
    from contrastors_tpu_torch.models.presets import nomic_bert_2048
    from contrastors_tpu_torch.trainers.text_text import PACKED_KEYS, encode_batch, make_train_step
    from contrastors_tpu_torch.utils.optim import make_optimizer

    root = tempfile.mkdtemp(prefix="chip_smoke_knobs_")
    try:
        paths = write_packed_inputs(root)
        recipe = packed_recipe(**paths)
        n_layer = NOMIC_BERT_2048_CONFIG["n_layer"]
        rows = PAIRS // KNOB_K  # each tower's packed rows
        chunk_rows = CHUNK // KNOB_K
        # the queries' one direct forward, the documents' chunks in pass 1 and 2
        expected = expect(fwd=n_layer * (1 + 2 * rows // chunk_rows), dq=n_layer * (1 + rows // chunk_rows),
                          dkv=n_layer * (1 + rows // chunk_rows))
        trainer, loop_rows, seconds, run_launches, syncs = run_chip_trainer(recipe, dev)
        host = next(iter(trainer.dataloader))  # the first batch, padded
        packed_host = trainer.transform_host_batch(dict(host))
        geometry = {col: trainer._pack_geometry(col) for col in ("query", "document")}
        data_ok = trainer.config.data_args.packed
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        reading, whole, kept_masks = {}, {}, {}
        for col in ("query", "document"):
            ids, mask = host[f"{col}_input_ids"], host[f"{col}_attention_mask"]
            L, K = geometry[col]
            reading[col] = dict(row_len=L, max_segments=K, real_tokens=int(mask.sum()),
                                padded_tokens=int(mask.size), packed_tokens=int(packed_host[f"{col}_input_ids"].size),
                                predicted_gain=packing_efficiency(mask, L, K),
                                kept_share=packing_kept_fraction(ids, mask, L, K),
                                real_share_of_packed=float(mask.sum()) / packed_host[f"{col}_input_ids"].size)
            kept = kept_lengths({k: packed_host[f"{col}_{k}"] for k in ("segment_ids", "pair_index")}, K)
            whole[col] = kept == mask.sum(axis=1)
            kept_masks[col] = (np.arange(mask.shape[1])[None] < kept[:, None]).astype(mask.dtype)
            reading[col].update(sequences=int(mask.shape[0]), kept_whole=int(whole[col].sum()),
                                truncated_to_0=int((kept == 0).sum()))
        # the kept share at phase 5's document lengths (lognormal, median 96 words, up to 511)
        rng = np.random.default_rng(1)
        lens = np.clip(rng.lognormal(np.log(96), 0.9, size=PAIRS), 8, D_LEN).astype(int)
        m5 = (np.arange(D_LEN)[None] < lens[:, None]).astype(np.int64)
        with contextlib.redirect_stdout(io.StringIO()):  # its 0-token truncations print a line each
            reading["document"]["kept_share_at_phase5_lengths"] = packing_kept_fraction(
                m5 * 7, m5, *geometry["document"])

        config = Config.from_dict(recipe)
        model, _ = load_biencoder(config.model_args, dtype=torch.bfloat16, device=dev, seed=42)
        scale = LogitScale(50.0, trainable=False, device=dev)
        opt = make_optimizer([("model." + n, p) for n, p in model.named_parameters()], 0.0, weight_decay=0.0,
                             max_grad_norm=None)  # lr 0: the weights and gradients stay as they are
        batches = {}
        for col in ("query", "document"):
            batches[("padded", col)] = {k: torch.from_numpy(host[f"{col}_{k}"]).to(dev)
                                        for k in ("input_ids", "attention_mask")}
            batches[("kept", col)] = dict(batches[("padded", col)],
                                          attention_mask=torch.from_numpy(kept_masks[col]).to(dev))
            batches[("packed", col)] = {k: torch.from_numpy(packed_host[f"{col}_{k}"]).to(dev) for k in PACKED_KEYS}
        fault_q = dict(batches[("packed", "query")])
        fault_q["pair_index"] = fault_q["pair_index"].roll(1)
        kw = dict(grad_cache=True, chunk_size=CHUNK, direct_chunks_q=-1)
        steps = dict(padded=make_train_step(model, scale, opt, **kw),
                     packed=make_train_step(model, scale, opt, packed_segments=KNOB_K, **kw))

        # embeddings, in one tower's forward each
        with torch.no_grad():
            emb = {(form, col): encode_batch(model, batches[(form, col)],
                                             max_segments=KNOB_K if form == "packed" else None)["embedding"].float()
                   for form in ("padded", "packed") for col in ("query", "document")}
            emb_fault = encode_batch(model, fault_q, max_segments=KNOB_K)["embedding"].float()
        # on the sequences packing kept whole
        rows_whole = {col: torch.from_numpy(whole[col]).to(dev) for col in whole}
        emb_cos = {col: float(torch.nn.functional.cosine_similarity(emb[("packed", col)], emb[("padded", col)])
                              [rows_whole[col]].min()) for col in ("query", "document")}
        emb_cos_fault = float(torch.nn.functional.cosine_similarity(emb_fault, emb[("padded", "query")])
                              [rows_whole["query"]].min())

        # the steps' gradients and times: padded, then packed (in turns padded,
        # packed, packed, padded before phase 25, cut for the 900 s budget)
        gen = torch.Generator().manual_seed(0)
        grads, ms, launches = {}, dict(padded=[], packed=[]), None
        for form in ("padded", "packed"):
            reset_counts()
            _, t = timed_call(lambda: steps[form](batches[(form, "query")], batches[(form, "document")], gen))
            ms[form].append(t)
            if form not in grads:
                grads[form] = model_grads(model)
                if form == "packed":
                    launches = read_counts()
        steps["padded"](batches[("kept", "query")], batches[("kept", "document")], gen)
        grads["kept"] = model_grads(model)
        steps["packed"](fault_q, batches[("packed", "document")], gen)
        grads_fault = model_grads(model)

        # the fused-rotary kernels on the packed rows: positions restarting per segment (per-batch tables)
        model_f = BiEncoder(nomic_bert_2048(attn_impl="flash", fused_rotary=True), pooling="mean",
                            dtype=torch.bfloat16, device=dev)
        model_f.load_state_dict(model.state_dict())
        opt_f = make_optimizer([("model." + n, p) for n, p in model_f.named_parameters()], 0.0, weight_decay=0.0,
                               max_grad_norm=None)
        step_f = make_train_step(model_f, scale, opt_f, packed_segments=KNOB_K, **kw)
        reset_counts()
        step_f(batches[("packed", "query")], batches[("packed", "document")], gen)
        launches_fused = read_counts()
        grads_fused = model_grads(model_f)
        params = {n: p.detach() for n, p in model.named_parameters()}
        update = {k: adam_first_update(g, params) for k, g in (("packed", grads["packed"]),
                                                               ("kept", grads["kept"]), ("fault", grads_fault))}
        agreement = dict(
            grad=flat_agreement(grads["packed"], grads["kept"]),
            fused_grad=flat_agreement(grads_fused, grads["kept"]),
            fault_grad=flat_agreement(grads_fault, grads["kept"]),
            grad_against_untruncated=flat_agreement(grads["packed"], grads["padded"]),
            adam_update_cosine=vector_cosine(update["packed"], update["kept"]),
            fault_adam_update_cosine=vector_cosine(update["fault"], update["kept"]),
        )
        del model_f, opt_f, step_f, grads_fused
        del model, scale, opt, steps, grads, grads_fault, batches, emb
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root)

    losses = [r["loss"] for r in loop_rows]
    quiet = [r for r in loop_rows if 1 < r["step"] < KNOB_STEPS]
    checks = dict(
        packed=data_ok and "query_pair_index" in packed_host,
        launches_per_step=all(r["launches"] == expected for r in loop_rows) and launches == expected,
        fused_launches=launches_fused == expect(fwd_rot=expected["fwd"], dq_rot=expected["dq"],
                                                dkv_rot=expected["dkv"]),
        embeddings_cosine_0_999=min(emb_cos.values()) >= 0.999,
        gradient_cosine_0_999=agreement["grad"]["cosine"] >= 0.999 and agreement["fused_grad"]["cosine"] >= 0.999,
        fault_outside=emb_cos_fault < 0.999 and agreement["fault_grad"]["cosine"] < 0.999,
        losses_finite_and_falling=bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
        no_sync_in_quiet_steps=all(r["iteration_syncs"] == 0 for r in quiet),
    )
    ok = all(checks.values())
    emit(phase="knobs_packed", card=card, gpu_state=gpu_state(), recipe="configs/train/contrastive_pretrain.yaml",
         pairs=PAIRS, chunk=CHUNK, max_segments=KNOB_K, steps=KNOB_STEPS, dtype="bf16", data=reading,
         expected_launches=expected, launches_per_step=[r["launches"] for r in loop_rows], run_launches=run_launches,
         losses=losses, loop_ms_runs=[r["iteration_ms"] for r in loop_rows],
         loop_syncs_per_step=[r["iteration_syncs"] for r in loop_rows], sync_examples=sorted(set(syncs))[:8],
         run_seconds=seconds, checks=checks, ok=ok)
    emit(phase="knobs_packed_agreement", card=card, gpu_state=gpu_state(), embedding_min_cosine=emb_cos,
         fault_embedding_min_cosine=emb_cos_fault, threshold=0.999, **agreement, bare_step_launches=launches,
         fused_step_launches=launches_fused, step_ms=dict(packed=float(np.median(ms["packed"])),
                                                         padded=float(np.median(ms["padded"]))),
         step_ms_turns=ms, ok=ok,
         note="on the first batch from the recipe's initial weights: packed against padded embeddings (each "
              "sequence that packing kept whole, both towers) and the step's gradient (grad cache, lr 0: all "
              "parameters together) against the padded step on the sequences as packing kept them (each mask "
              "cut to its kept tokens); grad_against_untruncated: against the padded step on the whole "
              "sequences (read, not bounded); the fault rolls the query pair_index by one slot; "
              "adam_update_cosine reads AdamW's first update from "
              "those gradients (about sign(g), so near-0 gradients flip it: read, not bounded); step_ms: the "
              "step (its optimizer at lr 0) to a synchronize, padded and packed in turns")
    if not ok:
        raise AssertionError(f"knobs packed: a check failed: {checks}")
    return dict(plain=launches, fused=launches_fused)


@contextlib.contextmanager
def capacity_reading(into):
    """Each capacity dispatch's dropped assignments: into gets (dropped,
    valid) device counts per call, from the layer's own slot assignment
    (`MoEMLP._capacity_slots`): a valid token's assignment that takes no
    slot is dropped."""
    from contrastors_tpu_torch.layers.moe import MoEMLP

    orig = MoEMLP._capacity_slots

    def read(self, top_e, valid, groups, dp):
        out = orig(self, top_e, valid, groups, dp)
        live = valid.sum() * self.top_k
        into.append((live - out[-1].sum(), live))
        return out

    MoEMLP._capacity_slots = read
    try:
        yield into
    finally:
        MoEMLP._capacity_slots = orig


@contextlib.contextmanager
def expert_choice_reading(into):
    """Each expert-choice dispatch's token table: into gets its shape [E, C]
    and the count of distinct tokens in each expert's row (device)."""
    import torch

    from contrastors_tpu_torch.layers.moe import MoEMLP

    orig = MoEMLP._combine

    def read(self, x_rows, idx, weights, n_out):
        if self.config.expert_choice_router:
            srt = torch.sort(idx, dim=1).values
            into.append((tuple(idx.shape), (srt[:, 1:] != srt[:, :-1]).sum(dim=1) + 1))
        return orig(self, x_rows, idx, weights, n_out)

    MoEMLP._combine = read
    try:
        yield into
    finally:
        MoEMLP._combine = orig


def knobs_moe(dev, card):
    """Phase 23b, knobs_moe_encode and knobs_moe_step: the MoE model
    (moe_config) with moe_impl="capacity" and with expert_choice_router, on
    the dropless model's seed weights. Returns the launches of one capacity
    step."""
    import gc

    import torch

    from contrastors_tpu_torch.models import BiEncoder, LogitScale
    from contrastors_tpu_torch.trainers.text_text import make_train_step
    from contrastors_tpu_torch.utils.optim import make_optimizer

    def model_of(**over):
        return seed_weights(BiEncoder(moe_config(**over), pooling="mean", dtype=torch.bfloat16, device=dev), "moe")

    cfg = moe_config()
    E, k, n_layer = cfg.num_experts, cfg.moe_top_k, cfg.n_layer
    B, S = KNOB_ENC_B, KNOB_ENC_S
    gen = torch.Generator(device=dev).manual_seed(23)
    lens = torch.from_numpy(np.clip(np.random.default_rng(23).lognormal(np.log(96), 0.9, size=B), 8, S)
                            .astype(np.int64)).to(dev)
    ids = torch.randint(1000, 30000, (B, S), generator=gen, device=dev)
    mask = (torch.arange(S, device=dev)[None] < lens[:, None]).long()
    encode = {}
    with torch.no_grad():
        for name, over in (("dropless", {}), ("capacity_no_drop", dict(moe_impl="capacity",
                                                                        moe_capacity_factor=float(E // k))),
                           ("capacity", dict(moe_impl="capacity"))):
            model = model_of(**over)
            drops = []
            reset_counts()
            with capacity_reading(drops):
                e = model(ids * mask, mask)["embedding"].float()
            encode[name] = dict(embedding=e, launches=read_counts(),
                                dropped=[int(a) for a, _ in drops], assignments=[int(b) for _, b in drops])
            del model
            torch.cuda.empty_cache()
    n_moe = len(encode["capacity"]["dropped"])
    cos = float(torch.nn.functional.cosine_similarity(encode["capacity_no_drop"]["embedding"],
                                                      encode["dropless"]["embedding"]).min())
    enc_checks = dict(
        no_drop_cosine_0_999=cos >= 0.999 and sum(encode["capacity_no_drop"]["dropped"]) == 0,
        no_gmm=all(encode[n]["launches"]["gmm"] == 0 for n in ("capacity_no_drop", "capacity")),
        dropless_gmm=encode["dropless"]["launches"]["gmm"] == 3 * n_moe,
        flash=all(encode[n]["launches"]["fwd"] == n_layer for n in encode),
    )
    emit(phase="knobs_moe_encode", card=card, batch=B, seq_len=S, min_cosine_no_drop_vs_dropless=cos,
         threshold=0.999, launches={n: v["launches"] for n, v in encode.items()},
         dropped_share_factor_2=sum(encode["capacity"]["dropped"]) / sum(encode["capacity"]["assignments"]),
         dropped_share_by_layer=[a / b for a, b in zip(encode["capacity"]["dropped"],
                                                       encode["capacity"]["assignments"])],
         checks=enc_checks, ok=all(enc_checks.values()),
         note="the encode batch (256 x 512, lognormal lengths) through the dropless model and the capacity "
              "dispatch on its weights, at factor E / k = 4 (C = N: nothing can drop) and at the default 2.0; "
              "dropped share: valid tokens' assignments past their expert's C")
    if not all(enc_checks.values()):
        raise AssertionError(f"knobs MoE encode: a check failed: {enc_checks}")
    del encode
    gc.collect()

    qb, db = token_batches(PAIRS, dev)
    n_chunks = 2 * PAIRS // MOE_CHUNK
    expected = expect(fwd=n_layer * 2 * n_chunks, dq=n_layer * n_chunks, dkv=n_layer * n_chunks)

    def trained(**over):
        model = model_of(**over)
        scale = LogitScale(50.0, trainable=False, device=dev)
        named = [("model." + n, p) for n, p in model.named_parameters()]
        opt = make_optimizer(named, 2e-4, weight_decay=0.01, max_grad_norm=1.0)
        step = make_train_step(model, scale, opt, grad_cache=True, chunk_size=MOE_CHUNK, direct_chunks_q=0,
                               direct_chunks_d=0, router_aux_coef=MOE_AUX)
        return model, step

    runs = {}
    train_gen = torch.Generator().manual_seed(0)
    models = dict(capacity=trained(moe_impl="capacity"), dropless=trained())
    # in turns: the first call of each warms it up; capacity's 2 losses
    for name in ("capacity", "dropless", "capacity", "dropless"):
        reset_counts()
        m, t = timed_call(lambda: models[name][1](qb, db, train_gen))
        r = runs.setdefault(name, dict(losses=[], ms=[], launches=[]))
        r["losses"].append(m["loss"].item())
        r["ms"].append(t)
        r["launches"].append(read_counts())
    del models
    gc.collect()
    torch.cuda.empty_cache()
    ec_model, ec_step = trained(expert_choice_router=True)
    tables = []
    ec = dict(losses=[], launches=[])
    for i in range(KNOB_EC_STEPS):
        reset_counts()
        with expert_choice_reading(tables) if i == 0 else contextlib.nullcontext():
            ec["losses"].append(ec_step(qb, db, train_gen)["loss"].item())
        ec["launches"].append(read_counts())
    del ec_model, ec_step
    gc.collect()
    torch.cuda.empty_cache()
    # a chunk's tokens: n = MOE_CHUNK x its length; C = factor n k / E
    c_of = {length: min(int(max(2.0 * MOE_CHUNK * length * k / E, 1)), MOE_CHUNK * length) for length in (Q_LEN, D_LEN)}
    tables = [(shape, distinct.tolist()) for shape, distinct in tables]
    ec_ok = bool(tables) and all(shape[0] == E and shape[1] in c_of.values() and all(d == shape[1] for d in distinct)
                                 for shape, distinct in tables)
    cap = runs["capacity"]
    checks = dict(
        capacity_launches=all(x == expected for x in cap["launches"]),
        capacity_no_gmm=all(x["gmm"] == 0 and x["tgmm"] == 0 for x in cap["launches"] + ec["launches"]),
        capacity_losses_falling=bool(np.isfinite(cap["losses"]).all()) and cap["losses"][-1] < cap["losses"][0],
        expert_choice_c_tokens_each=ec_ok,
        expert_choice_losses_falling=bool(np.isfinite(ec["losses"]).all()) and ec["losses"][-1] < ec["losses"][0],
        expert_choice_launches=all(x == expected for x in ec["launches"]),
    )
    ok = all(checks.values())
    emit(phase="knobs_moe_step", card=card, gpu_state=gpu_state(), pairs=PAIRS, chunk=MOE_CHUNK,
         router_aux_coef=MOE_AUX, expected_launches=expected, capacity=cap, dropless=runs["dropless"],
         expert_choice=ec, expert_choice_tables=dict(n=len(tables), c_per_chunk=c_of,
                                                     shapes=sorted({shape for shape, _ in tables})),
         step_ms=dict(capacity=cap["ms"][1], dropless=runs["dropless"]["ms"][1]),
         checks=checks, ok=ok,
         note="the MoE benchmark step (phase 11's geometry) with moe_impl capacity (factor 2.0) and dropless on "
              "the same seed weights, in turns (capacity, dropless, capacity, dropless; the first call of each "
              "a warm-up, left out of step_ms), then expert choice; step ms to a synchronize")
    if not ok:
        raise AssertionError(f"knobs MoE step: a check failed: {checks}")
    return cap["launches"][0]


def knobs_embed_parallel(dev, card, m=4):
    """Phase 23c, knobs_embed_parallel: grad cache's pass 1 m chunks to a
    forward against m = 1, on the vision recipe's grad-cache step (LiT,
    LIT_GC_BATCH images, chunk LIT_GC_CHUNK) and on the dense text step
    (phase 7's geometry), gradients from one step each (lr 0), pass-1 ms
    and step ms, m = 1 then m (in turns (1, m, m, 1) before phase 25, cut
    for the 900 s budget)."""
    import gc
    import tempfile

    import torch

    from contrastors_tpu_torch.config import Config
    from contrastors_tpu_torch.trainers.text_text import make_train_step

    out = {}

    def compare(name, run):
        """run(mm) -> gradients of one step with embed_parallel mm."""
        grads, pass1, step_ms = {}, {1: [], m: []}, {1: [], m: []}
        for mm in (1, m):
            clock = {}
            with phase_clock(clock):
                g, t = timed_call(lambda: run(mm))
            grads.setdefault(mm, g)
            pass1[mm].append(clock["grad_cache/pass1"])
            step_ms[mm].append(t)
        out[name] = dict(grad=flat_agreement(grads[m], grads[1]),
                         pass1_ms={k: float(np.median(v)) for k, v in pass1.items()}, pass1_ms_turns=pass1,
                         step_ms={k: float(np.median(v)) for k, v in step_ms.items()}, step_ms_turns=step_ms)

    root = tempfile.mkdtemp(prefix="chip_smoke_knobs_lit_")
    try:
        text_dir, tok, _, gc_batches, _, evals = lit_inputs(root)
        recipe = lit_recipe(text_dir, os.path.join(root, "run"), grad_cache=True)
        trainer = lit_trainer_class(tok, gc_batches, evals)(Config.from_dict(recipe), "bf16", dev)
        trainer.syncs = []  # its steps' record (chip_trainer_class) outside run_chip_trainer
        batch = {k: torch.from_numpy(v).to(dev) for k, v in gc_batches[0].items()}

        def lit_run(mm):
            trainer.config.train_args.grad_cache_embed_parallel = mm
            return lit_step_grads(trainer, batch)

        compare("lit_grad_cache", lit_run)
        del trainer, batch
    finally:
        shutil.rmtree(root)
    gc.collect()
    torch.cuda.empty_cache()

    model, scale, opt = train_modules("flash", dev, lr=0.0, max_grad_norm=None)
    qb, db = token_batches(PAIRS, dev)
    steps = {mm: make_train_step(model, scale, opt, grad_cache=True, chunk_size=CHUNK, direct_chunks_q=-1,
                                 embed_parallel=mm) for mm in (1, m)}

    def dense_run(mm):
        steps[mm](qb, db, torch.Generator().manual_seed(0))
        return model_grads(model)

    compare("dense_text", dense_run)
    del model, scale, opt, steps
    gc.collect()
    torch.cuda.empty_cache()
    checks = {f"{name}_cosine_0_9999_rel_l2_0_01": r["grad"]["cosine"] >= 0.9999 and r["grad"]["rel_l2"] <= 0.01
              for name, r in out.items()}
    ok = all(checks.values())
    emit(phase="knobs_embed_parallel", card=card, gpu_state=gpu_state(), embed_parallel=m,
         lit=dict(images=LIT_GC_BATCH, chunk=LIT_GC_CHUNK), dense=dict(pairs=PAIRS, chunk=CHUNK), **out,
         checks=checks, ok=ok,
         note="gradients of one grad-cache step (lr 0, all parameters together) with pass 1 embedding m chunks "
              "to a forward against m = 1; ms: host clock to a synchronize (pass1_ms from grad_cache.py's "
              "pass-1 range, the card synchronized at its ends), m = 1 then m; the LiT "
              "step's optimizer update is stubbed")
    if not ok:
        raise AssertionError(f"knobs embed_parallel: a check failed: {checks}")
    return out


def knobs_phase(dev, card):
    """Phase 23 (module docstring). Returns the launches of one packed step
    (plain and fused rotary) and of one capacity MoE step."""
    packed = knobs_packed(dev, card)
    moe = knobs_moe(dev, card)
    knobs_embed_parallel(dev, card)
    return dict(packed=packed["plain"], packed_fused=packed["fused"], capacity=moe)


# -- the tensor and expert axes (phase 24) -------------------------------------
# the pretrain recipe cut to PAR_PAIRS pairs a step (chunk 16, every query
# chunk direct): every split layer all-reduces [chunk, S, 768] twice a
# forward and twice a backward, and gloo on one card stages each through the host
PAR_PAIRS, PAR_STEPS = 32, 3
PAR_MOE_LAYERS = 6  # the MoE cells' depth (of 12; MoE on layers 1, 3 and 5), for the 900 s budget
# the gates: each step's loss against one rank's (phase 22's bar), and the first step's
# gathered gradient against one rank's, per tensor and over all (phase 22's numbers; the MoE
# cells phase 11's bar, as routing may flip on rounding). Not the parameter updates: the
# split's partial sums round in bf16 before they are summed, and AdamW's first updates,
# about sign(g), turn that into flips on near-0 gradients (as phase 23's packing gate found)
PAR_LOSS_RTOL, PAR_GRAD_COSINE, PAR_GRAD_COSINE_ALL = 2e-3, 0.99, 0.999
PAR_MOE_GRAD_COSINE_ALL = 0.995
PAR_LAYER_REL = 1e-5  # the fp32 layer check's relative L2 bar
# cells: name -> (layout (data, expert, tensor), MoE dispatch or None for the dense recipe)
PAR_CELLS = {
    "parallel_tensor": ((1, 1, 2), None),
    "parallel_expert": ((1, 2, 1), "auto"),
    "parallel_expert_dropless": ((1, 2, 1), "dropless"),
    "parallel_expert_tensor": ((1, 2, 2), "auto"),
}
# the one-rank reference of each cell: the dense recipe, or the MoE one with the dispatch that
# "auto" resolves to under the expert axis (capacity), or dropless
PAR_REFERENCE = {"parallel_tensor": "dense", "parallel_expert": "capacity", "parallel_expert_dropless": "dropless",
                 "parallel_expert_tensor": "capacity"}
PAR_FAULTS = ("row_bias_every_rank", "copy_without_all_reduce")
# the local experts' layout of gmm / tgmm (expert 2 of 4): half a document chunk's
# 16 x 256 x 2 assignments, at the dropless cell's widths
PAR_GMM_LAYOUTS = (("local_doc_chunk_e4", 16 * 256 * 2 // 2),)
PAR_GMM_KN = ((768, 3072), (3072, 768))
TENSOR_TIMING_SHAPES = (("tp2_b512_s32_h6", 512, 32, False), ("tp2_b16_s256_h6", 16, 256, False))


def par_recipe(paths, layout, moe_impl=None):
    """The pretrain recipe at PAR_PAIRS pairs a step for PAR_STEPS steps on
    `layout`, and with moe_impl the MoE model (nomic-bert-2048 at
    PAR_MOE_LAYERS layers, `paths["moe_dir"]`; 8 experts, top-2, MoE on every
    second layer, router aux MOE_AUX)."""
    recipe = dist_pretrain_recipe({k: paths[k] for k in ("model_dir", "pairs", "eval_dir", "out_dir")}, 1)
    recipe["train_args"].update(num_train_steps=PAR_STEPS, log_lr_every=PAR_STEPS, chunk_size=CHUNK)
    recipe["data_args"]["batch_size"] = PAR_PAIRS
    d, e, t = layout
    recipe["parallel_args"] = {"data": d, "expert": e, "tensor": t}
    if moe_impl:
        recipe["model_args"].update(model_name=paths["moe_dir"], num_experts=8, moe_top_k=2, moe_every_n_layers=2,
                                    moe_impl=moe_impl)
        recipe["train_args"]["router_aux_loss_coef"] = MOE_AUX
    return recipe


def step_passes(moe, pairs=PAR_PAIRS, chunk=CHUNK):
    """(forwards, backwards) of one grad-cache step of the cut recipe: the
    queries' direct forward and backward (one per query chunk with the
    router aux on, as grad cache runs them for an MoE model), and 2
    forwards and a backward of each document chunk."""
    n = pairs // chunk
    return (3 * n, 2 * n) if moe else (1 + 2 * n, 1 + n)


def predicted_launches(moe_impl, n_layer=12, pairs=PAR_PAIRS, chunk=CHUNK):
    """The kernels' launches of one step of the cut recipe, the same on a
    rank of any layout as on one rank (`step_passes`); gated MoE layers
    (every second one) launch 3 gmm a forward and 3 gmm (dlhs) and 3 tgmm
    a backward under the dropless dispatch."""
    fwd, bwd = step_passes(moe_impl is not None, pairs, chunk)
    moe = n_layer // 2 if moe_impl == "dropless" else 0
    return expect(fwd=n_layer * fwd, dq=n_layer * bwd, dkv=n_layer * bwd, gmm=moe * 3 * (fwd + bwd),
                  tgmm=moe * 3 * bwd)


def predicted_all_reduces(layout, moe, n_layer=12, pairs=PAR_PAIRS, chunk=CHUNK):
    """torch.distributed all-reduce calls of one rank step on `layout`
    (data 1: nothing over the data group). Each forward: out_proj of every
    layer and fc2 of every dense layer under the tensor axis, and each MoE
    layer's output once per split group; each backward: the column splits'
    inputs (Wqkv, the gated MLP's fc11 / fc12) and each MoE layer's tokens
    and combine weights once per split group. Then the optimizer: the
    gradients of the parameters held whole on several peers averaged, one
    all-reduce per group for each kind (those whole on every model axis;
    under the tensor and the expert axis, the tensor-split ones whole on
    the expert axis), and the global norm, one all-reduce per group of
    each kind of split parameter."""
    d, e, t = layout
    moe_layers = n_layer // 2 if moe else 0
    tp, groups = int(t > 1), int(t > 1) + int(e > 1)
    fwd, bwd = step_passes(moe, pairs, chunk)
    per_fwd = tp * (2 * n_layer - moe_layers) + moe_layers * groups
    per_bwd = tp * (2 * n_layer - moe_layers) + moe_layers * 2 * groups
    replicas = groups + (int(e > 1) if tp else 0)
    norm = tp + (groups if moe_layers else 0)
    return fwd * per_fwd + bwd * per_bwd + replicas + norm


@contextlib.contextmanager
def kernel_shapes(into):
    """The flash kernels' head counts and the grouped matmuls' expert counts
    of every launch inside, into sets `into["heads"]` and `into["experts"]`."""
    from contrastors_tpu_torch.ops import flash_attention as fa
    from contrastors_tpu_torch.ops import grouped_matmul as gm

    saved = dict(fwd=fa._launch_kernel, dq=fa.launch_bwd_dq, dkv=fa.launch_bwd_dkv, gmm=gm.launch_gmm,
                 tgmm=gm.launch_tgmm)
    into.setdefault("heads", set())
    into.setdefault("experts", set())

    def heads(fn):
        @functools.wraps(fn)
        def call(q, *args, **kwargs):
            into["heads"].add(int(q.shape[2]))
            return fn(q, *args, **kwargs)
        return call

    def experts(fn, pos):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            into["experts"].add(int(args[pos].shape[0]))
            return fn(*args, **kwargs)
        return call

    fa._launch_kernel, fa.launch_bwd_dq, fa.launch_bwd_dkv = (heads(saved[k]) for k in ("fwd", "dq", "dkv"))
    gm.launch_gmm, gm.launch_tgmm = experts(saved["gmm"], 1), experts(saved["tgmm"], 2)
    try:
        yield into
    finally:
        fa._launch_kernel, fa.launch_bwd_dq, fa.launch_bwd_dkv = saved["fwd"], saved["dq"], saved["dkv"]
        gm.launch_gmm, gm.launch_tgmm = saved["gmm"], saved["tgmm"]


@contextlib.contextmanager
def counted_all_reduces(dev, into):
    """Every torch.distributed.all_reduce inside counted, and its host ms
    (after a synchronize: gloo stages a CUDA tensor through the host, so
    the call waits for the work queued before it) summed, into `into`."""
    import torch
    import torch.distributed as dist

    saved = dist.all_reduce
    into.update(count=0, ms=0.0)

    def call(*args, **kwargs):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = saved(*args, **kwargs)
        torch.cuda.synchronize(dev)
        into["count"] += 1
        into["ms"] += (time.perf_counter() - t0) * 1e3
        return out

    dist.all_reduce = call
    try:
        yield into
    finally:
        dist.all_reduce = saved


def tensor_cosines(got, ref):
    """({name: cosine}, cosine over all) of got against ref (host tensors
    by name), over the tensors where ref is not 0: (worst name, its
    cosine, over all)."""
    out, dot, got_sq, ref_sq = {}, 0.0, 0.0, 0.0
    for n, r in ref.items():
        r = r.double()
        if float(r.norm()) == 0.0:
            continue
        g = got[n].double().cpu()
        d, gg, rr = float((g * r).sum()), float(g.square().sum()), float(r.square().sum())
        out[n] = d / max((gg * rr) ** 0.5, 1e-300)
        dot, got_sq, ref_sq = dot + d, got_sq + gg, ref_sq + rr
    worst = min(out, key=out.get)
    return worst, out[worst], dot / max((got_sq * ref_sq) ** 0.5, 1e-300)


def first_grads_class(base):
    """base whose first step keeps its gradients, whole (gathered over the
    mesh's model groups: every rank takes part), on global rank 0's host as
    `first_grads`; the clip scales them all alike, so their direction is
    the step's."""
    from contrastors_tpu_torch.parallel.sharding import gather_tensors, param_splits

    class FirstGrads(base):
        def make_train_step(self):
            step = super().make_train_step()

            def kept(batch, generator):
                metrics = step(batch, generator)
                if not hasattr(self, "first_grads"):
                    named = {n: p.grad for n, p in self.model.named_parameters() if p.grad is not None}
                    whole = gather_tensors(named, param_splits(self.model), self.mesh)
                    self.first_grads = ({n: v.float().cpu() for n, v in whole.items()}
                                        if self.mesh.global_rank == 0 else None)
                return metrics

            return kept

    return FirstGrads


def par_case(spec, dev, rank, cell):
    """One cell of phase 24 on this rank: the recipe through train.run on
    the cell's layout, the kernels' launches and shapes per step, the
    all-reduces per step and their ms, the replicated parameters' sums, and
    (rank 0) the first step's gathered gradient against the one-rank
    reference's."""
    import torch

    layout, moe_impl = PAR_CELLS[cell]
    shapes, reduces = {}, {}
    cls = first_grads_class(chip_trainer_class())
    torch.cuda.reset_peak_memory_stats(dev)
    with collectives_outside_sync_log(), kernel_shapes(shapes), counted_all_reduces(dev, reduces):
        trainer, rows, seconds, _, _ = run_chip_trainer(par_recipe(spec["paths"], layout, moe_impl), dev, cls)
    model_args = trainer.config.model_args
    out = dict(cell=cell, layout=list(layout), losses=[r["loss"] for r in rows],
               launches=[r["launches"] for r in rows], step_ms=[r["iteration_ms"] for r in rows],
               all_reduces_per_step=reduces["count"] / PAR_STEPS, all_reduce_ms_per_step=reduces["ms"] / PAR_STEPS,
               heads=sorted(shapes["heads"]), experts=sorted(shapes["experts"]),
               peak_gb=torch.cuda.max_memory_allocated(dev) / 2**30, seconds=seconds,
               replicas_agreed=trainer.init_replicas_agreed,
               moe_impl=model_args.moe_impl if model_args.num_experts else None,
               # the replicated parameters after the steps, to hold equal on every peer
               replicated={n: float(p.detach().double().sum()) for n, p in trainer.model.named_parameters()
                           if getattr(p, "mesh_split", None) is None},
               local_w_up=(list(trainer.model["model"].trunk.layers[1].mlp.w_up.shape)
                           if model_args.num_experts else None))
    if rank == 0:
        ref = torch.load(spec["refs"][PAR_REFERENCE[cell]], map_location="cpu", weights_only=True)
        worst, low, all_ = tensor_cosines(trainer.first_grads, ref)
        out.update(grad_cosine_min=low, grad_cosine_worst=worst, grad_cosine_all=all_)
    del trainer
    torch.cuda.empty_cache()
    return out


def par_case_layer_faults(spec, dev, rank):
    """The two planted faults, on one block at nomic-bert-2048's widths with
    BERT's projection biases (drawn from N(0, 0.5); nomic-bert-2048 has none
    on its projections, so its recipe cannot show the first), fp32,
    attention through sdpa, 16 x 256 tokens, split at 1 x 1 x 2 against the
    whole block in this process: the output's and the input gradient's
    relative L2 error, clean, with the row split's bias added on every rank
    before the sum, and with copy_to_group's backward all-reduce dropped."""
    import torch

    from contrastors_tpu_torch.layers import dense as dense_mod
    from contrastors_tpu_torch.layers.block import Block
    from contrastors_tpu_torch.models.presets import nomic_bert_2048
    from contrastors_tpu_torch.parallel import collectives, make_mesh
    from contrastors_tpu_torch.parallel.sharding import shard_module

    cfg = nomic_bert_2048(attn_impl="sdpa", qkv_proj_bias=True, mlp_fc1_bias=True, mlp_fc2_bias=True)
    torch.manual_seed(0)
    whole = Block(cfg, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for n, p in whole.named_parameters():
            if n.endswith("bias"):
                p.normal_(0.0, 0.5)
    state = {k: v.clone() for k, v in whole.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(16, 256, cfg.n_embd, generator=gen, device=dev)
    dy = torch.randn(16, 256, cfg.n_embd, generator=gen, device=dev)

    def run(block):
        xi = x.clone().requires_grad_()
        y = block(xi)[0]
        y.backward(dy)
        return y.detach(), xi.grad

    ref_y, ref_dx = run(whole)
    mesh = make_mesh(data=1, tensor=2)

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    real_forward, real_copy = dense_mod.Dense.forward, collectives._CopyToGroup.__dict__["backward"]

    def bias_every_rank(self, x_):
        if self.split == "row":
            return collectives.reduce_from_group(self.local(x_), self.group)
        return real_forward(self, x_)

    out = {}
    for case in ("split",) + PAR_FAULTS:
        block = Block(cfg, dtype=torch.float32, device=dev)
        block.load_state_dict(state)
        shard_module(block, mesh)
        if case == "row_bias_every_rank":
            dense_mod.Dense.forward = bias_every_rank
        elif case == "copy_without_all_reduce":
            collectives._CopyToGroup.backward = staticmethod(lambda ctx, grad: (grad, None))
        try:
            y, dx = run(block)
        finally:
            dense_mod.Dense.forward, collectives._CopyToGroup.backward = real_forward, real_copy
        out[case] = dict(output_rel_l2=rel(y, ref_y), input_grad_rel_l2=rel(dx, ref_dx))
    return out


DIST_CASES.update({cell: (lambda spec, dev, rank, cell=cell: par_case(spec, dev, rank, cell)) for cell in PAR_CELLS})
DIST_CASES["parallel_layer_faults"] = par_case_layer_faults


# the data-axis routing cell: the MoE model at PAR_MOE_LAYERS layers in fp32 (routing then
# depends on the tokens alone, not on a batch's bf16 rounding), the capacity and expert-choice
# dispatch at a factor that drops, a global batch of PAR_ROUTE_B x PAR_ROUTE_S tokens with
# padding, two data ranks against one rank on the whole batch
PAR_ROUTES, PAR_ROUTE_FACTOR, PAR_ROUTE_B, PAR_ROUTE_S = ("capacity", "expert_choice"), 1.0, 16, 128
PAR_ROUTE_LAYERS = 4  # MoE on layers 1 and 3
PAR_ROUTE_TEXTS, PAR_ROUTE_ENC_BATCH = 32, 16
PAR_SERVING_COSINE = 0.9999  # fp32 both sides: only the batch's reassociation differs
# the resume cells: (layout, MoE dispatch or None, shard_optimizer_state, the cell whose step-2
# checkpoint it resumes or None for a saving run); PAR_RESUME_STEPS steps, saved every 2, on
# nomic-bert-2048 cut to PAR_RESUME_LAYERS layers (the MoE one with MoE on layer 1)
PAR_RESUME_STEPS, PAR_RESUME_LAYERS = 3, 2
PAR_RESUME = {
    "parallel_resume_save_tp": ((1, 1, 2), "capacity", False, None),
    "parallel_resume_save_zero": ((2, 1, 1), None, True, None),
    "parallel_resume_expert": ((1, 2, 1), "capacity", False, "parallel_resume_save_tp"),
    "parallel_resume_one_rank": ((1, 1, 1), "capacity", False, "parallel_resume_save_tp"),
    "parallel_resume_data": ((2, 1, 1), None, False, "parallel_resume_save_zero"),
}


def route_model(dev, route, state=None):
    """The MoE BiEncoder of the data-axis cell (PAR_ROUTE_LAYERS layers,
    fp32, sdpa) with the capacity
    dispatch or expert choice at PAR_ROUTE_FACTOR; `state` its weights (else
    the seed weights)."""
    import torch

    from contrastors_tpu_torch.models import BiEncoder

    cfg = moe_config("sdpa", n_layer=PAR_ROUTE_LAYERS, moe_impl="capacity", moe_capacity_factor=PAR_ROUTE_FACTOR,
                     expert_choice_router=route == "expert_choice")
    model = BiEncoder(cfg, pooling="mean", dtype=torch.float32, device=dev)
    if state is None:
        return seed_weights(model, "par_route")
    model.load_state_dict(state)
    return model


def route_inputs():
    """The cell's global batch (ids, mask, fixed loss weights, numpy) and
    serving texts, from a seed."""
    rng = np.random.default_rng(31)
    ids = rng.integers(1000, 30000, size=(PAR_ROUTE_B, PAR_ROUTE_S))
    lens = rng.integers(PAR_ROUTE_S // 2, PAR_ROUTE_S + 1, size=PAR_ROUTE_B)
    mask = (np.arange(PAR_ROUTE_S)[None] < lens[:, None]).astype(np.int64)
    w = rng.normal(size=(PAR_ROUTE_B, NOMIC_BERT_2048_CONFIG["n_embd"])).astype(np.float32)
    return ids, mask, w, make_texts(rng, PAR_ROUTE_TEXTS, 8, 120)


@contextlib.contextmanager
def moe_decisions(into):
    """Every MoE layer call's routing inside, as a sorted list of global
    (token * E + expert) into `into`: the capacity dispatch's dropped
    assignments of valid tokens, expert choice's picks of valid tokens (the
    global token index is the data rank's offset plus the local one)."""
    import torch

    from contrastors_tpu_torch.layers import moe as M

    forward, slots, combine = M.MoEMLP.forward, M.MoEMLP._capacity_slots, M.MoEMLP._combine

    def seen_forward(self, hidden, attention_mask=None, groups=1):
        n = hidden.shape[0] * hidden.shape[1]
        dp = self.dp if groups == 1 and not M._LOCAL_ROUTING[0] else None
        valid = (torch.ones(n, dtype=torch.bool, device=hidden.device) if attention_mask is None
                 else attention_mask.reshape(-1).bool())
        self._seen = (dp.rank * n if dp is not None else 0, valid)
        return forward(self, hidden, attention_mask, groups)

    def seen_slots(self, top_e, valid, groups, dp):
        out = slots(self, top_e, valid, groups, dp)
        offset, _ = self._seen
        k, E = self.top_k, self.num_routed
        token = torch.arange(valid.shape[0], device=valid.device).repeat_interleave(k)
        dropped = valid.reshape(-1).repeat_interleave(k) & ~out[-1].reshape(-1)
        into.append(sorted(((token[dropped] + offset) * E + top_e.reshape(-1)[dropped]).tolist()))
        return out

    def seen_combine(self, x_rows, idx, weights, n_out):
        if self.config.expert_choice_router:
            offset, valid = self._seen
            lo, n_local = self._local_experts()
            n = valid.shape[0]
            expert = torch.arange(lo, lo + n_local, device=idx.device)[:, None].expand_as(idx)
            live = torch.cat([valid, valid.new_zeros(1)])[idx.clamp(max=n)] & (idx < n)
            into.append(sorted(((idx[live] + offset) * self.num_routed + expert[live]).tolist()))
        return combine(self, x_rows, idx, weights, n_out)

    M.MoEMLP.forward, M.MoEMLP._capacity_slots, M.MoEMLP._combine = seen_forward, seen_slots, seen_combine
    try:
        yield into
    finally:
        M.MoEMLP.forward, M.MoEMLP._capacity_slots, M.MoEMLP._combine = forward, slots, combine


def route_run(model, dev, mesh):
    """The cell's two forms on this rank's rows: the port's standard step
    (`make_standard_train_step`, lr 0, no clip) on mean(emb . w), and the
    Encoder (its mesh form on a data axis) on the serving texts. Returns
    (the global loss, the whole gradients on the host, the step's routing,
    the serving embeddings, the serving routing)."""
    import torch

    from contrastors_tpu_torch.eval.encoder import Encoder
    from contrastors_tpu_torch.eval.stub_tokenizer import StubTokenizer
    from contrastors_tpu_torch.parallel.mesh import local_rows
    from contrastors_tpu_torch.trainers.base import make_standard_train_step
    from contrastors_tpu_torch.utils.optim import make_optimizer

    ids, mask, w, texts = route_inputs()
    rows = local_rows(PAR_ROUTE_B, mesh)
    batch = {k: torch.from_numpy(v[rows]).to(dev) for k, v in (("ids", ids), ("mask", mask), ("w", w))}

    def loss_fn(b, generator):
        emb = model(b["ids"], b["mask"])["embedding"]
        return (emb * b["w"]).sum(-1).mean(), {}

    opt = make_optimizer(model.named_parameters(), 0.0, max_grad_norm=None)
    step = make_standard_train_step(loss_fn, opt, group=mesh.group)
    with moe_decisions([]) as step_routing:
        loss = float(step(batch)["loss"])
    grads = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters() if p.grad is not None}
    enc = Encoder(model, StubTokenizer(NOMIC_BERT_2048_CONFIG["vocab_size"]), seq_len=PAR_ROUTE_S,
                  batch_size=PAR_ROUTE_ENC_BATCH, query_prefix=None, document_prefix=None, mesh=mesh)
    with moe_decisions([]) as serve_routing:
        emb = enc.encode(texts)
    return loss, grads, step_routing, emb, serve_routing


def par_case_data_routing(spec, dev, rank):
    """The data-axis cell on this rank (data 2): each route's loss, its
    routing (as the step and the Encoder route it, and, as the planted
    fault, routed per rank), and on rank 0 the gradient's and the serving
    embeddings' agreement with the one-rank run's."""
    import torch

    from contrastors_tpu_torch.layers.moe import local_routing
    from contrastors_tpu_torch.parallel import make_mesh
    from contrastors_tpu_torch.parallel.sharding import shard_module

    mesh = make_mesh(data=2)
    state = torch.load(spec["route"]["state"], map_location="cpu", weights_only=True)
    out = {}
    for route in PAR_ROUTES:
        model = route_model(dev, route, state)
        shard_module(model, mesh)
        loss, grads, routing, emb, serve = route_run(model, dev, mesh)
        with local_routing():
            fault = route_run(model, dev, mesh)
        res = dict(loss=loss, routing=routing, serve_routing=serve, fault_routing=fault[2],
                   fault_serve_routing=fault[4])
        if rank == 0:
            ref = torch.load(spec["route"][route], map_location="cpu", weights_only=False)
            _, _, res["grad_cosine_all"] = tensor_cosines(grads, ref["grads"])
            res["serve_min_cosine"] = min_row_cosine(emb, ref["emb"])
            res["fault_serve_min_cosine"] = min_row_cosine(fault[3], ref["emb"])
        out[route] = res
        del model
        torch.cuda.empty_cache()
    return out


def resume_recipe(spec, cell):
    """The recipe of a resume cell: the cut pretrain recipe (the MoE one
    with its dispatch fixed) on PAR_RESUME_LAYERS layers at the cell's
    layout, PAR_RESUME_STEPS steps with a log every step; a saving cell checkpoints every 2 steps into the
    cell's directory, a resuming one starts from its source cell's step 2
    and writes nothing."""
    layout, impl, shard, source = PAR_RESUME[cell]
    recipe = par_recipe(spec["paths"], layout, impl)
    recipe["model_args"]["model_name"] = spec["paths"]["resume_moe_dir" if impl else "resume_dense_dir"]
    recipe["train_args"].update(num_train_steps=PAR_RESUME_STEPS, log_lr_every=1)
    recipe["parallel_args"]["shard_optimizer_state"] = shard
    if source is None:
        recipe["train_args"].update(save_every=2, output_dir=os.path.join(spec["resume_root"], cell))
    else:
        recipe["train_args"]["checkpoint"] = os.path.join(spec["resume_root"], source, "step_2")
    return recipe


def moments_fingerprint(whole):
    """A float64 checksum of a whole optimizer state's tensors (moments and
    step counters), in the state's order, on the host."""
    from contrastors_tpu_torch.parallel.mesh import fingerprint

    tensors = [v for i in sorted(whole["state"]) for k, v in sorted(whole["state"][i].items())
               if hasattr(v, "detach")]
    return fingerprint(t.detach().cpu() for t in tensors)


def resume_class(base):
    """base that saves at step 2 alone, reads the whole optimizer state it
    saves there (`saved_fingerprint`) and, after a resume, the one it
    restored (`restored_fingerprint`); every rank takes part in the
    gathers."""
    from contrastors_tpu_torch.parallel.sharding import whole_optimizer_state

    class Resumed(base):
        saved_fingerprint = None

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.restored_fingerprint = (moments_fingerprint(whole_optimizer_state(self.optimizer, self.mesh))
                                         if self.config.train_args.checkpoint else None)

        def _state(self):
            state = super()._state()
            if self.step == 2:
                self.saved_fingerprint = moments_fingerprint(state["optimizer"])
            return state

        def save_state(self, out_dir, step):
            if step == 2:  # the checkpoint the resumes read; not the run's last one
                super().save_state(out_dir, step)

    return Resumed


def par_case_resume(spec, dev, rank, cell):
    """One resume cell on this rank (or in the script's process): the steps'
    losses and the optimizer it resumed."""
    import torch

    trainer, rows, seconds, _, _ = run_chip_trainer(resume_recipe(spec, cell), dev,
                                                    resume_class(chip_trainer_class()))
    out = dict(cell=cell, steps=[r["step"] for r in rows], losses=[r["loss"] for r in rows],
               optimizer=type(trainer.optimizer).__name__, restored_fingerprint=trainer.restored_fingerprint,
               saved_fingerprint=trainer.saved_fingerprint, seconds=seconds)
    del trainer
    torch.cuda.empty_cache()
    return out


DIST_CASES["parallel_data_routing"] = par_case_data_routing
DIST_CASES.update({cell: (lambda spec, dev, rank, cell=cell: par_case_resume(spec, dev, rank, cell))
                   for cell in PAR_RESUME})


def data_routing_reference(dev, root):
    """The data-axis cell on one rank, in this process: the seed weights
    (written for the ranks), and each route's loss, routing, gradient and
    serving embeddings (written for rank 0)."""
    import gc

    import torch

    from contrastors_tpu_torch.parallel.mesh import Mesh

    paths = dict(state=os.path.join(root, "route_state.pt"))
    torch.save(route_model(dev, "capacity").state_dict(), paths["state"])
    state = torch.load(paths["state"], map_location="cpu", weights_only=True)
    refs = {}
    for route in PAR_ROUTES:
        model = route_model(dev, route, state)
        loss, grads, routing, emb, serve = route_run(model, dev, Mesh())
        paths[route] = os.path.join(root, f"route_ref_{route}.pt")
        torch.save(dict(grads=grads, emb=emb), paths[route])
        refs[route] = dict(loss=loss, routing=routing, serve_routing=serve,
                           dropped_share=dropped_share(route, routing, int(route_inputs()[1].sum())))
        del model, grads
        gc.collect()
        torch.cuda.empty_cache()
    return paths, refs


def dropped_share(route, routing, valid):
    """The step's share of (valid token, expert) assignments that routing
    left out, over its MoE layers: the capacity dispatch's top-k choices
    without a slot (its routing lists them), or the (token, expert) pairs
    that expert choice did not pick (its routing lists the picks)."""
    E = moe_config().num_experts
    if route == "capacity":
        return sum(map(len, routing)) / (2 * valid * len(routing))
    return 1.0 - sum(map(len, routing)) / (E * valid * len(routing))


def data_routing_gates(results, refs):
    """The cell's gates: per route, the two ranks' routing (each call's
    union over the ranks) the one-rank run's in both forms, the per-rank
    fault's not; the loss within PAR_LOSS_RTOL, the gradient at cosine >=
    PAR_MOE_GRAD_COSINE_ALL, the serving embeddings at >= PAR_SERVING_COSINE,
    the fault's below."""
    def union(ranks, key):
        return [sorted(set().union(*(r[key][i] for r in ranks))) for i in range(len(ranks[0][key]))]

    out, checks = {}, {}
    for route in PAR_ROUTES:
        ranks, ref = [r[route] for r in results], refs[route]
        step, serve = union(ranks, "routing"), union(ranks, "serve_routing")
        fault, fault_serve = union(ranks, "fault_routing"), union(ranks, "fault_serve_routing")
        loss_rel = abs(ranks[0]["loss"] - ref["loss"]) / abs(ref["loss"])
        out[route] = dict(loss=ranks[0]["loss"], reference_loss=ref["loss"], loss_rel=loss_rel,
                          grad_cosine_all=ranks[0]["grad_cosine_all"], serve_min_cosine=ranks[0]["serve_min_cosine"],
                          fault_serve_min_cosine=ranks[0]["fault_serve_min_cosine"],
                          dropped_share=ref["dropped_share"], calls=len(step), serving_calls=len(serve),
                          differing_calls=sum(a != b for a, b in zip(step, ref["routing"])),
                          fault_differing_calls=sum(a != b for a, b in zip(fault, ref["routing"])))
        checks.update({
            f"{route}_step_routing_equal": step == ref["routing"],
            f"{route}_serving_routing_equal": serve == ref["serve_routing"],
            f"{route}_drops": ref["dropped_share"] > 0,
            f"{route}_per_rank_fault_differs": fault != ref["routing"] and fault_serve != ref["serve_routing"],
            f"{route}_loss_within": loss_rel <= PAR_LOSS_RTOL,
            f"{route}_grad_within": ranks[0]["grad_cosine_all"] >= PAR_MOE_GRAD_COSINE_ALL,
            f"{route}_serving_within": ranks[0]["serve_min_cosine"] >= PAR_SERVING_COSINE,
            f"{route}_ranks_agree": all(r["loss"] == ranks[0]["loss"] for r in ranks),
        })
    return out, checks


def resume_gates(cells):
    """Each resumed cell: its steps (3 on) each within PAR_LOSS_RTOL of its
    source run's loss, every rank's restored optimizer state (gathered whole)
    the one its source saved at step 2 (checksum), and the optimizer it
    resumed into the cell's (ZeRO-2 moments or not)."""
    out, checks = {}, {}
    for cell, (layout, impl, shard, source) in PAR_RESUME.items():
        if source is None:
            continue
        ranks, base = cells[cell], cells[source][0]
        rel = rel_diffs(ranks[0]["losses"], base["losses"][2:])
        out[cell] = dict(layout=layout, source=source, losses=ranks[0]["losses"], uninterrupted=base["losses"][2:],
                         loss_rel=rel, optimizer=ranks[0]["optimizer"], source_optimizer=base["optimizer"],
                         restored_fingerprints=[r["restored_fingerprint"] for r in ranks],
                         saved_fingerprint=base["saved_fingerprint"])
        checks.update({
            f"{cell}_steps": all(r["steps"] == list(range(3, PAR_RESUME_STEPS + 1)) for r in ranks),
            f"{cell}_losses_within": max(rel) <= PAR_LOSS_RTOL,
            f"{cell}_state_restored": all(r["restored_fingerprint"] == base["saved_fingerprint"] is not None
                                          for r in ranks),
            f"{cell}_optimizer": all(r["optimizer"] == "AdamW" for r in ranks)
            and cells[source][0]["optimizer"] == ("ShardedAdamW" if PAR_RESUME[source][2] else "AdamW"),
        })
    return out, checks


def parallel_phase(dev, card, gen):
    """Phase 24 (module docstring): the tensor and expert axes on ranks that
    share the card. Returns the launches and shapes of the cells' rank steps
    and the kernels' timing rows at the new shapes."""
    import gc
    import tempfile

    import torch

    root = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    paths = write_trainer_inputs(root)
    paths["moe_dir"] = os.path.join(root, "nomic-bert-2048-moe-cells")
    os.makedirs(paths["moe_dir"])
    with open(os.path.join(paths["moe_dir"], "config.json"), "w") as f:
        json.dump(dict(NOMIC_BERT_2048_CONFIG, n_layer=PAR_MOE_LAYERS), f)
    for key in ("resume_dense_dir", "resume_moe_dir"):
        paths[key] = os.path.join(root, key)
        os.makedirs(paths[key])
        with open(os.path.join(paths[key], "config.json"), "w") as f:
            json.dump(dict(NOMIC_BERT_2048_CONFIG, n_layer=PAR_RESUME_LAYERS), f)
    t_phase = time.perf_counter()

    # one rank, this process: the reference losses and parameter updates
    refs = {}
    for name, impl in (("dense", None), ("capacity", "capacity"), ("dropless", "dropless")):
        gc.collect()
        torch.cuda.empty_cache()
        cls = first_grads_class(chip_trainer_class())
        with kernel_shapes({}) as seen:
            one, rows, seconds, _, _ = run_chip_trainer(par_recipe(paths, (1, 1, 1), impl), dev, cls)
        path = os.path.join(root, f"ref_{name}.pt")
        torch.save(one.first_grads, path)
        refs[name] = dict(path=path, losses=[r["loss"] for r in rows], launches=[r["launches"] for r in rows],
                          step_ms=[r["iteration_ms"] for r in rows], heads=sorted(seen["heads"]),
                          experts=sorted(seen["experts"]), seconds=seconds)
        del one, rows
    gc.collect()
    torch.cuda.empty_cache()

    # the data-axis cell's one-rank run on the whole batch
    route_paths, route_refs = data_routing_reference(dev, root)
    gc.collect()
    torch.cuda.empty_cache()

    resume_root = os.path.join(root, "resume")
    spec = dict(backend="gloo", device="cuda:0" if dev.type == "cuda" else "cpu", paths=paths,
                refs={k: v["path"] for k, v in refs.items()}, route=route_paths, resume_root=resume_root,
                cases=["parallel_tensor", "parallel_layer_faults", "parallel_expert", "parallel_expert_dropless",
                       "parallel_data_routing", "parallel_resume_save_tp", "parallel_resume_save_zero",
                       "parallel_resume_expert", "parallel_resume_data"])
    t0 = time.perf_counter()
    two = launch_ranks(spec, root, "gloo_two_ranks", 2)
    four = launch_ranks(dict(spec, cases=["parallel_expert_tensor"]), root, "gloo_four_ranks", 4)
    ranks_seconds = time.perf_counter() - t0
    results = dict(two, **four)

    # the 1 x 1 x 2 checkpoint resumed on one rank here (the two ranks resumed theirs in the launch)
    t0 = time.perf_counter()
    resumes = {cell: results[cell] for cell in PAR_RESUME if cell != "parallel_resume_one_rank"}
    resumes["parallel_resume_one_rank"] = [par_case_resume(spec, dev, 0, "parallel_resume_one_rank")]
    resume_seconds = time.perf_counter() - t0
    routing, routing_checks = data_routing_gates(results["parallel_data_routing"], route_refs)
    resumed, resume_checks = resume_gates(resumes)
    ok_new = all(routing_checks.values()) and all(resume_checks.values())
    emit(phase="parallel_data_routing", card=card, backend="gloo", layout=[2, 1, 1], dtype="fp32",
         factor=PAR_ROUTE_FACTOR, batch=[PAR_ROUTE_B, PAR_ROUTE_S], serving_texts=PAR_ROUTE_TEXTS,
         moe_layers=PAR_ROUTE_LAYERS // 2, bounds=dict(loss_rtol=PAR_LOSS_RTOL, grad_cosine_all=PAR_MOE_GRAD_COSINE_ALL,
                                                     serving_cosine=PAR_SERVING_COSINE),
         routes=routing, checks=routing_checks, ok=all(routing_checks.values()))
    emit(phase="parallel_resume", card=card, backend="gloo", steps=PAR_RESUME_STEPS, save_every=2,
         cells={cell: dict(layout=PAR_RESUME[cell][0], moe_impl=PAR_RESUME[cell][1],
                           shard_optimizer_state=PAR_RESUME[cell][2], losses=resumes[cell][0]["losses"],
                           seconds=[r["seconds"] for r in resumes[cell]]) for cell in PAR_RESUME},
         resumed=resumed, checks=resume_checks, one_rank_seconds=resume_seconds,
         ok=all(resume_checks.values()))
    if not ok_new:
        raise AssertionError(f"parallel: a data-axis routing or resume check failed: {routing_checks} "
                             f"{resume_checks}")

    def gates(cell):
        res = results[cell]
        ref = refs[PAR_REFERENCE[cell]]
        loss_rel = max(rel_diffs(res[0]["losses"], ref["losses"]))
        moe = PAR_CELLS[cell][1] is not None
        within = loss_rel <= PAR_LOSS_RTOL and (
            res[0]["grad_cosine_all"] >= PAR_MOE_GRAD_COSINE_ALL if moe else
            res[0]["grad_cosine_min"] >= PAR_GRAD_COSINE and res[0]["grad_cosine_all"] >= PAR_GRAD_COSINE_ALL)
        return dict(loss_rel=loss_rel, within=within,
                    **{k: res[0][k] for k in ("grad_cosine_min", "grad_cosine_worst", "grad_cosine_all")})

    n_head = NOMIC_BERT_2048_CONFIG["n_head"]

    def n_layer(cell):
        return PAR_MOE_LAYERS if PAR_CELLS[cell][1] else NOMIC_BERT_2048_CONFIG["n_layer"]

    def all_reduces(cell):
        return predicted_all_reduces(PAR_CELLS[cell][0], PAR_CELLS[cell][1] is not None, n_layer=n_layer(cell))

    def shape_checks(cell):
        res, (layout, impl) = results[cell], PAR_CELLS[cell]
        d, e, t = layout
        resolved = "capacity" if impl == "auto" and e > 1 else impl
        want = predicted_launches(resolved if impl else None, n_layer=n_layer(cell))
        return dict(
            launches=all(x == want for r in res for x in r["launches"]),
            reference_launches=all(x == want for x in refs[PAR_REFERENCE[cell]]["launches"]),
            heads=all(r["heads"] == [n_head // t] for r in res),
            experts=all(r["experts"] == ([8 // e] if resolved == "dropless" else []) for r in res),
            all_reduces=all(r["all_reduces_per_step"] == all_reduces(cell) for r in res),
            resolved=all(r["moe_impl"] == resolved for r in res),
            ranks_log_the_same_losses=all(r["losses"] == res[0]["losses"] for r in res),
            replicated_parameters_equal=all(r["replicated"] == res[0]["replicated"] for r in res),
            replicas_agreed=all(r["replicas_agreed"] for r in res),
            losses_finite=bool(np.isfinite([x for r in res for x in r["losses"]]).all()),
        )

    cells = {cell: dict(gates=gates(cell), checks=shape_checks(cell)) for cell in PAR_CELLS}
    layer = results["parallel_layer_faults"]

    def worst(r):
        return max(r["output_rel_l2"], r["input_grad_rel_l2"])

    checks = dict(
        layer_split_within=all(worst(r["split"]) <= PAR_LAYER_REL for r in layer),
        **{f"{fault}_far_outside": all(worst(r[fault]) > 100 * PAR_LAYER_REL for r in layer) for fault in PAR_FAULTS},
        **{f"{cell}_within": cells[cell]["gates"]["within"] for cell in PAR_CELLS},
        **{f"{cell}_{k}": v for cell in PAR_CELLS for k, v in cells[cell]["checks"].items()},
        local_w_up=[r["local_w_up"] for r in results["parallel_expert_tensor"]] == [
            [4, NOMIC_BERT_2048_CONFIG["n_embd"], NOMIC_BERT_2048_CONFIG["n_inner"] // 2]] * 4,
    )
    ok = all(checks.values())
    emit(phase="parallel", card=card, gpu_state=gpu_state(), backend="gloo", device="cuda:0 (every rank)",
         recipe="configs/train/contrastive_pretrain.yaml", pairs=PAR_PAIRS, chunk=CHUNK, steps=PAR_STEPS,
         bounds=dict(loss_rtol=PAR_LOSS_RTOL, grad_cosine_per_tensor=PAR_GRAD_COSINE,
                     grad_cosine_all=PAR_GRAD_COSINE_ALL, moe_grad_cosine_all=PAR_MOE_GRAD_COSINE_ALL,
                     layer_rel_l2=PAR_LAYER_REL),
         references={k: {x: v[x] for x in ("losses", "heads", "experts")} for k, v in refs.items()},
         cells={cell: dict(layout=PAR_CELLS[cell][0], moe_impl=results[cell][0]["moe_impl"],
                           losses=results[cell][0]["losses"], launches_per_rank_step=results[cell][0]["launches"][-1],
                           heads=results[cell][0]["heads"], experts=results[cell][0]["experts"],
                           all_reduces_per_step=results[cell][0]["all_reduces_per_step"],
                           predicted_all_reduces=all_reduces(cell),
                           local_w_up=results[cell][0]["local_w_up"], seconds=[r["seconds"] for r in results[cell]],
                           losses_per_rank=[r["losses"] for r in results[cell]],
                           replicated_differing=sorted({n for r in results[cell] for n, v in r["replicated"].items()
                                                        if v != results[cell][0]["replicated"][n]})[:20],
                           **cells[cell]) for cell in PAR_CELLS},
         layer_faults=layer, checks=checks, ok=ok)
    emit(phase="parallel_timing", card=card, gpu_state=gpu_state(),
         note="gloo, ranks sharing one card: not NCCL's speed; step ms: host clock from one loop step's start to "
              "the next (the all-reduces timed inside it, each after a synchronize); all-reduce ms: host ms of "
              "every torch.distributed.all_reduce of a step, summed",
         one_rank_step_ms={k: v["step_ms"] for k, v in refs.items()},
         cells={cell: dict(step_ms_per_rank=[r["step_ms"] for r in results[cell]],
                           all_reduces_per_rank_step=[r["all_reduces_per_step"] for r in results[cell]],
                           all_reduce_ms_per_rank_step=[r["all_reduce_ms_per_step"] for r in results[cell]],
                           peak_gb_per_rank=[r["peak_gb"] for r in results[cell]])
                for cell in PAR_CELLS},
         ranks_seconds=ranks_seconds)
    if not ok:
        raise AssertionError(f"parallel: a check failed: {checks}")

    # NCCL across two cards, only where there are two
    count = torch.cuda.device_count()
    nccl = None
    if count >= 2:
        nccl = launch_ranks(dict(spec, backend=None, cases=["parallel_tensor"]), root, "nccl_two_cards", 2,
                            devices=["cuda:0", "cuda:1"])["parallel_tensor"]
    nccl_ok = nccl is None or (max(rel_diffs(nccl[0]["losses"], refs["dense"]["losses"])) <= PAR_LOSS_RTOL
                               and nccl[0]["grad_cosine_min"] >= PAR_GRAD_COSINE
                               and nccl[0]["grad_cosine_all"] >= PAR_GRAD_COSINE_ALL)
    emit(phase="parallel_nccl", card=card,
         two_cards=(dict(losses=nccl[0]["losses"], step_ms_per_rank=[r["step_ms"] for r in nccl],
                         all_reduce_ms_per_rank_step=[r["all_reduce_ms_per_step"] for r in nccl],
                         grad_cosine_all=nccl[0]["grad_cosine_all"])
                    if nccl else f"not run: {count} card(s)"),
         ok=nccl_ok)
    shutil.rmtree(root)
    if not nccl_ok:
        raise AssertionError("parallel: the tensor axis over NCCL disagrees with one rank")

    # the kernels at the new shapes: the flash kernels at a tensor rank's 6
    # heads, gmm / tgmm on 4 local experts
    fwd_rows = forward_timing(dev, card, gen, TENSOR_TIMING_SHAPES, H=6)
    bwd_rows = backward_timing(dev, card, gen, shapes=TENSOR_TIMING_SHAPES, H=6)
    gmm_errs, gmm_rows = moe_kernels(dev, card, PAR_GMM_LAYOUTS, E=4, kn=PAR_GMM_KN)
    emit(phase="parallel_phase_seconds", seconds=time.perf_counter() - t_phase)
    tensor, dropless = results["parallel_tensor"][0], results["parallel_expert_dropless"][0]
    return dict(routing=routing, resumed=resumed,
                tensor_launches=tensor["launches"][-1], expert_dropless_launches=dropless["launches"][-1],
                expert_launches=results["parallel_expert"][0]["launches"][-1],
                expert_tensor_launches=results["parallel_expert_tensor"][0]["launches"][-1],
                fwd=fwd_rows, bwd=bwd_rows, gmm=gmm_rows, gmm_errs=gmm_errs)


# phase 25: DataComp's tasks at full width on in-memory images (DC_CLASSES colours, each image
# its colour plus noise), the two train-to-signal scripts at their defaults, ablate_vision
DC_CLASSES = ("red", "green", "blue", "yellow")
DC_COLOURS = ((220, 40, 40), (40, 200, 40), (50, 70, 230), (230, 220, 40))
DC_PER_CLASS, DC_GROUPS, DC_PAIRS, DC_BATCH, DC_TEXT_LEN = 32, ("north", "south"), 128, 64, 77
ABLATE_CHUNK, ABLATE_BATCH, ABLATE_ITERS = 32, 512, 10


def datacomp_images(rng, n, classes):
    """n uint8 [n, 224, 224, 3] images, each its class's colour plus noise."""
    labels = rng.integers(0, len(classes), size=n)
    colour = np.asarray(DC_COLOURS)[labels][:, None, None, :].astype(np.int16)
    px = colour + rng.integers(-40, 41, size=(n, VIT_IMG, VIT_IMG, 3), dtype=np.int16)
    return np.clip(px, 0, 255).astype(np.uint8), labels


def datacomp_check(dev, card):
    """Phase 25a, scripts_datacomp: eval/datacomp.py's zero-shot, grouped
    and retrieval tasks and their aggregate, on EVA02-B/16 with MAP pooling
    and nomic-bert-2048's text tower at full width (bf16, seed weights), fed
    images already decoded (`samples=`; the card's machine has no Pillow)
    and texts through the stand-in tokenizer at 77 tokens. Gates: every
    metric finite in [0, 1]; flash forward launches 12 a tower batch, as
    predicted from the batches the tasks make; an image batch's and a text
    batch's embeddings at cosine >= SERVING_COSINE against the towers in fp32
    on sdpa."""
    import torch

    from contrastors_tpu_torch.eval import datacomp
    from contrastors_tpu_torch.eval.stub_tokenizer import StubTokenizer
    from contrastors_tpu_torch.eval.zero_shot import PROMPT_TEMPLATES
    from contrastors_tpu_torch.models import BiEncoder

    text_cfg, vit_cfg = lit_configs("flash")
    text = seed_weights(BiEncoder(text_cfg, pooling="mean", dtype=torch.bfloat16, device=dev), "dense").eval()
    vision = seed_weights(BiEncoder(vit_cfg, trunk_type="vision", pooling="map", dtype=torch.bfloat16,
                                    device=dev), "eva02_map").eval()
    tok = StubTokenizer(text_cfg.vocab_size)
    encode_image, encode_text = datacomp.make_encoders(text, vision, tok, DC_TEXT_LEN)
    rng = np.random.default_rng(25)

    def chw(px_u8):
        return normalised(torch.from_numpy(px_u8).to(dev).permute(0, 3, 1, 2)).cpu().numpy()

    imgs, labels = datacomp_images(rng, DC_PER_CLASS * len(DC_CLASSES), DC_CLASSES)
    g_imgs, g_labels = datacomp_images(rng, DC_PER_CLASS * len(DC_CLASSES), DC_CLASSES)
    groups = rng.choice(DC_GROUPS, size=len(g_labels))
    r_imgs, r_labels = datacomp_images(rng, DC_PAIRS, DC_CLASSES)
    captions = [f"a photo of a {DC_CLASSES[c]} square {i}" for i, c in enumerate(r_labels)]
    px, g_px, r_px = chw(imgs), chw(g_imgs), chw(r_imgs)
    reset_counts()
    t0 = time.perf_counter()
    results = dict(
        zeroshot=datacomp.zeroshot_classification_task(
            encode_image, encode_text, None, list(DC_CLASSES), batch_size=DC_BATCH, samples=zip(px, labels)),
        fairness=datacomp.grouped_zeroshot_task(
            encode_image, encode_text, None, list(DC_CLASSES), batch_size=DC_BATCH,
            samples=zip(g_px, g_labels, groups)),
        retrieval=datacomp.retrieval_task(encode_image, encode_text, None, batch_size=DC_BATCH,
                                          samples=list(zip(r_px, captions))),
    )
    results["aggregate"] = datacomp.aggregate(results)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    prompts = len(DC_CLASSES) * len(PROMPT_TEMPLATES)
    image_batches = 2 * -(-len(labels) // DC_BATCH) + -(-DC_PAIRS // DC_BATCH)
    text_batches = 2 * -(-prompts // 256) + -(-DC_PAIRS // DC_BATCH)
    predicted = expect(fwd=vit_cfg.n_layer * image_batches + text_cfg.n_layer * text_batches)
    # the towers against fp32 sdpa on one batch each
    text32, vit32 = lit_configs("sdpa")
    ref_text = BiEncoder(text32, pooling="mean", dtype=torch.float32, device=dev).eval()
    ref_text.load_state_dict(text.state_dict())
    ref_vision = BiEncoder(vit32, trunk_type="vision", pooling="map", dtype=torch.float32, device=dev).eval()
    ref_vision.load_state_dict(vision.state_dict())
    ref_image, ref_caption = datacomp.make_encoders(ref_text, ref_vision, tok, DC_TEXT_LEN)
    cos_image = min_row_cosine(encode_image(px[:DC_BATCH]), ref_image(px[:DC_BATCH]))
    cos_text = min_row_cosine(encode_text(captions[:DC_BATCH]), ref_caption(captions[:DC_BATCH]))
    values = [v for r in results.values() for v in r.values()]
    checks = dict(metrics_in_range=all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in values),
                  aggregate=set(results["aggregate"]) == {"zeroshot_acc1", "worst_group_acc1", "retrieval_R@1"},
                  launches=launches == predicted,
                  image_cosine=cos_image >= SERVING_COSINE, text_cosine=cos_text >= SERVING_COSINE)
    ok = all(checks.values())
    emit(phase="scripts_datacomp", card=card, gpu_state=gpu_state(), vision=EVA02 + " (MAP pooling)",
         text="nomic-bert-2048", dtype="bf16", weights="seed", images=dict(zeroshot=len(labels),
                                                                             fairness=len(g_labels),
                                                                             retrieval=DC_PAIRS),
         results=results, launches=launches, predicted_launches=predicted, image_batches=image_batches,
         text_batches=text_batches, seconds=seconds, min_cosine_image=cos_image, min_cosine_text=cos_text,
         threshold=SERVING_COSINE, checks=checks, ok=ok)
    if not ok:
        raise AssertionError(f"scripts datacomp: a check failed: {checks}")
    del text, vision, ref_text, ref_vision
    torch.cuda.empty_cache()
    return launches


def signal_runs(dev, card):
    """Phase 25b, scripts_train_to_signal and scripts_vision_train_to_signal:
    each script's run at its defaults (320 steps of 128 pairs; 400 of 64
    images, grad cache at chunk 16) on the card in fp32, from the world the
    script builds (JAX's, draw for draw and weight for weight, without
    transformers or Pillow), gated on the script's own bars (JAX's):
    nDCG@10 above its value at init and above 0.9; zero-shot top-1 above its
    value at init and >= 0.5. Their models' head dim is 16, so attention
    runs the plain sdpa: 0 flash launches, predicted and counted."""
    import torch

    from contrastors_tpu_torch.scripts import train_to_signal, vision_train_to_signal

    out = {}
    for name, script in (("train_to_signal", train_to_signal), ("vision_train_to_signal", vision_train_to_signal)):
        reset_counts()
        t0 = time.perf_counter()
        result = script.run(device=dev, log=lambda *a: None)
        seconds = time.perf_counter() - t0
        launches = read_counts()
        try:
            script.check(result)
            bars = True
        except AssertionError as e:
            bars = str(e)
        checks = dict(bars=bars is True, launches=launches == expect(),
                      losses_finite=bool(np.isfinite([x for _, x in result["loss_curve"]]).all()))
        emit(phase=f"scripts_{name}", card=card, gpu_state=gpu_state(), seconds=seconds, launches=launches,
             **{k: v for k, v in result.items()}, checks=checks, failed_bar=None if bars is True else bars,
             ok=all(checks.values()))
        if not all(checks.values()):
            raise AssertionError(f"scripts {name}: a check failed: {checks} {bars}")
        out[name] = result
        torch.cuda.empty_cache()
    return out


def ablate_vision_split(dev, card):
    """Phase 25c, scripts_ablate_vision: scripts/ablate_vision.py's split of
    the LiT grad-cache step (EVA02-B/16, chunk 32, batch 512, bf16) into its
    pieces, CUDA-event times; flash launches counted (they time the
    kernels, outside any main path)."""
    from contrastors_tpu_torch.scripts import ablate_vision

    reset_counts()
    result = ablate_vision.ablate(dev, ABLATE_CHUNK, ABLATE_BATCH, ABLATE_ITERS)
    launches = read_counts()
    ok = all(np.isfinite(p["step_ms"]) and p["step_ms"] > 0 for p in result["pieces"].values()) and launches["fwd"] > 0
    emit(phase="scripts_ablate_vision", card=card, gpu_state=gpu_state(), launches=launches, **result, ok=ok)
    if not ok:
        raise AssertionError("scripts ablate_vision: a piece's time is not finite, or no flash launch")
    return result


def scripts_phase(dev, card):
    """Phase 25: DataComp, the train-to-signal runs and the vision ablation.
    Returns DataComp's flash launches."""
    t0 = time.perf_counter()
    launches = datacomp_check(dev, card)
    signal_runs(dev, card)
    ablate_vision_split(dev, card)
    emit(phase="scripts_phase_seconds", seconds=time.perf_counter() - t0)
    return launches


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
                                       "mlm_trainer", "vision", "families", "inference", "distributed", "knobs",
                                       "parallel", "scripts"],
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
                         "checks and phase 20; inference: the card, build, the long-context case's forward "
                         "check and phase 21; distributed: the card, build and phase 22; knobs: the card, "
                         "build and phase 23; parallel: the card, build, the local shapes' kernel checks of 3 "
                         "and 4 and phase 24; scripts: the card, build, the ViT shape's checks of 3 and 4 and "
                         "phase 25")
    ap.add_argument("--tree", help="with --only: the root of another checkout whose contrastors_tpu_torch "
                                   "package is built and timed (an earlier commit, for old against new)")
    ap.add_argument("--dist-worker", metavar="SPEC", help=argparse.SUPPRESS)  # one rank of phase 22
    args = ap.parse_args(argv)
    if args.dist_worker:
        return dist_rank_main(args.dist_worker)
    if args.tree:
        if not args.only:
            ap.error("--tree needs --only")
        global TREE
        TREE = os.path.abspath(args.tree)
        sys.path.insert(0, TREE)
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
                mlm_trainer=("flash_fwd", "flash_bwd"), vision=("flash_fwd", "flash_bwd"),
                inference=("flash_fwd", "flash_bwd"), distributed=("flash_fwd", "flash_bwd"),
                scripts=("flash_fwd", "flash_bwd")).get(
        args.only, _build.LIBRARIES)
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
        elif args.only == "distributed":
            summary["distributed_launches_per_rank_step"] = distributed_phase(dev, card)
        elif args.only == "parallel":
            o_errs = forward_checks(dev, gen, TENSOR_STEP_CASES)
            grad_errs = backward_checks(dev, gen, TENSOR_STEP_CASES)
            par = parallel_phase(dev, card, gen)
            summary["parallel_launches_per_rank_step"] = {k: v for k, v in par.items() if k.endswith("launches")}
            summary["max_abs_err"] = dict(fwd=max(o_errs.values()), **{g: max(e.values()) for g, e in grad_errs.items()},
                                          **par["gmm_errs"])
        elif args.only == "knobs":
            o_errs = forward_checks(dev, gen, PACKED_STEP_CASES)
            grad_errs = backward_checks(dev, gen, PACKED_STEP_CASES)
            fused_errs = fused_kernel_checks(dev, gen, cases=PACKED_STEP_FUSED_CASES)
            summary["knobs_launches_per_step"] = knobs_phase(dev, card)
            summary["max_abs_err"] = dict(fwd=max(o_errs.values()), **{g: max(e.values()) for g, e in grad_errs.items()},
                                          fused=fused_errs)
        elif args.only == "scripts":
            o_errs = forward_checks(dev, gen, VIT_CASES)
            grad_errs = backward_checks(dev, gen, VIT_CASES)
            summary["datacomp_launches"] = scripts_phase(dev, card)
            summary["max_abs_err"] = dict(fwd=max(o_errs.values()), **{g: max(e.values()) for g, e in grad_errs.items()})
        elif args.only == "inference":
            o_errs = forward_checks(dev, gen, LONGCTX_CASES)
            summary["inference"] = inference_phase(dev, card, gen)
            summary["max_abs_err"] = dict(fwd=max(o_errs.values()))
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

    # 21. the inference side: the encode CLI, export, long context, MTEB, mining, the decoder heads
    inference = inference_phase(dev, card, gen)

    # 22. data-parallel training across processes: two ranks on the card (gloo), NCCL at world size 1
    dist_launches = distributed_phase(dev, card)

    # 10-12. the dropless MoE path: serving and training
    moe_enc_launches, moe_batches = moe_serving(dev, card, tok, rng, gen)
    moe_train_launches = moe_training(dev, card)

    # 23. the training step's last single-card knobs: packing, capacity and expert-choice MoE, embed_parallel
    knobs = knobs_phase(dev, card)

    # 24. the tensor and expert axes: two and four ranks on the card (gloo), the kernels at the local shapes;
    # the MoE dispatch routed over a data axis, the optimizer state resumed at other layouts
    par = parallel_phase(dev, card, gen)

    # 25. DataComp at full width, the train-to-signal scripts, the vision ablation
    scripts_launches = scripts_phase(dev, card)

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
        entry["capacity_moe_step_launches"] = knobs["capacity"][kname]
        entry["parallel"] = parallel_entry(kname)
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

    def parallel_entry(kname):
        """Phase 24: launches per rank step of its cells (a tensor rank's 6
        heads, an expert rank's 4 experts) and the new shapes' timing rows."""
        pick = ("ms", "device_ms", "enqueue_us", "plain_ms", "bound_ms", "bound_by", "library_ms")
        if kname in ("gmm", "tgmm"):
            return dict(expert_dropless_launches_per_rank_step=par["expert_dropless_launches"][kname],
                        local_experts=4, max_abs_err=par["gmm_errs"][kname],
                        timings={f"{name} {layout} K={K} N={N}": dict({k: row[k] for k in pick}, library=row["library"])
                                 for (name, layout, K, N), row in par["gmm"].items()
                                 if (name == "tgmm") == (kname == "tgmm")})
        entry = dict(local_heads=6, tensor_launches_per_rank_step=par["tensor_launches"][kname],
                     expert_launches_per_rank_step=par["expert_launches"][kname],
                     expert_tensor_launches_per_rank_step=par["expert_tensor_launches"][kname])
        cases = [c[0] for c in TENSOR_STEP_CASES]
        if kname == "fwd":
            entry.update(max_abs_err=max(o_errs[c] for c in cases),
                         timings={label: {k: row[k] for k in pick} for label, row in par["fwd"].items()})
        else:
            entry.update(max_abs_err=max(grad_errs[g][c] for g in (("dq",) if kname == "dq" else ("dk", "dv"))
                                         for c in cases),
                         timings={label: dict({k: row[kname][k] for k in ("ms", "device_ms", "enqueue_us",
                                                                           "bound_ms", "bound_by")},
                                              plain_ms=row["plain_ms"], library_ms=row["library_ms"])
                                  for label, row in par["bwd"].items()})
        return entry

    def inference_entry(kname):
        """Phase 21: launches per encode-CLI and long-context batch, and
        per pythia-160m causal-LM step; for the forward, the long-context
        case's timing row and error."""
        heads = inference["decoder_heads"]
        if kname != "fwd":
            return dict(pythia_causal_lm_backward_launches=heads["backward_launches"][kname])
        return dict(encode_cli_launches_per_batch=inference["encode"]["launches_per_batch"],
                    long_context_launches_per_batch=inference["long_context"]["launches_per_batch"],
                    pythia_causal_lm_forward_launches=heads["forward_launches"],
                    pythia_causal_lm_step_launches=heads["backward_launches"]["fwd"],
                    long_context=dict(inference["kernel"], max_abs_err=o_errs["longctx_ntk_pad_b8_s8192"]))

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
            distributed_launches_per_rank_step=dist_launches[kname],
            packed_step_launches=knobs["packed"][kname],
            max_abs_err=max(max(grad_errs[g].values()) for g in (("dq",) if kname == "dq" else ("dk", "dv"))),
            packed_step_max_abs_err=max(grad_errs[g][c[0]] for g in (("dq",) if kname == "dq" else ("dk", "dv"))
                                        for c in PACKED_STEP_CASES),
            **{k: v for k, v in at(doc, "B=16 S=T=256 H=12 D=64 (document chunk)").items()},
            query_tower=at(query, "B=512 S=T=32 H=12 D=64"),
            mlm_unfused=at(mlm, "B=8 S=T=2048 H=12 D=64, rotary outside"),
            vision=vision_entry(kname),
            families=family_entry(kname),
            inference=inference_entry(kname),
            parallel=parallel_entry(kname),
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
            packed_step_launches=knobs["packed_fused"][f"{kname}_rot"],
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
            distributed_launches_per_rank_step=dist_launches["fwd"],
            packed_step_launches=knobs["packed"]["fwd"],
            packed_step_max_abs_err=max(o_errs[c[0]] for c in PACKED_STEP_CASES),
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
            inference=inference_entry("fwd"),
            parallel=parallel_entry("fwd"),
            datacomp_launches=scripts_launches["fwd"],
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
