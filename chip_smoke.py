"""Drive the PyTorch port's main path on one CUDA card and hold its kernels to their plain versions.

    python3 chip_smoke.py

Phases, each failing loudly (non-zero exit):
  1. build   compile every CUDA kernel of the path from csrc/ (nvcc, sm_90a)
  2. kernels each kernel against its plain PyTorch version on the card, at the
             main path's shapes and at ragged ones, with timings and bounds
             (flash_attention at the serving shape at batch 64 and 1 and at
             the training shape, and at MVLA's batch-64 prefix (T = S = 436),
             expert suffix (51) and joint prompt (108, with its all-true
             mask and without one), each beside SDPA; w8a8_matmul on K-major
             codes at every bridge, MVLA and SpatialVLA shape (the tied
             unembedding at N 259,714 with fp32 out, batch 64 and 1, the
             Gemma2 prefill at M 19,456 and a decode product; Magma's untied
             lm_head at N 128,256 with bf16 out, batch 64 and 1, the LLaMA
             prefill's down (K 14,336), gate and k at M 20,544 and the
             decode's down at M 64; one tensor rank's slices at t = 2: the
             unembedding's 129,857 rows and the lm_head's 64,128 columns;
             bit-equal),
             per row and per 2048-chunk, beside
             torch._int_mm on its codes and the bf16 matmul it replaces, with
             effective rates and device time per call; fused_adam_rows at
             the Gemma-2B gate leaf in fp8 with and without SR, fp32 moments,
             fp32 p and g, and two calls back to back, its fast division and
             square root bit for bit against the correctly rounded ones, its
             SASS instructions per element, device time, wrapper host time,
             and the gate leaf with fp32 p)
  3. serving full-width Pi0 bridge (SigLIP So400m + Gemma-2B + 300M expert,
             random bf16 weights from a seed): requests through
             Pi0Policy.select_action at batch 1 with a reset, and a batch-64
             sample_action_chunk; checks the kernel launch counts, the action
             shapes and finiteness, and the actions against the plain-attention
             path on the same params and noise; then latency at batch 1 and 64,
             and one torch.profiler pass each (device busy share, top kernels)
  3b. int8   the server role's Pi0PolicyWrapper from
             config/experiment/simpler/pi0_finetune_bridge_ev.yaml with
             quantize_int8 on (the bf16 phase's random weights, quantized):
             fused requests through infer_batch at batch 1 and 64, with the
             launches of both serving kernels per inference checked (1544
             w8a8_matmul, 17 flash_attention at the bridge); env actions finite
             and of the right shape; the actions bit-equal with only the
             W8A8 product plain, and within ACTIONS_RTOL of the plain path;
             int8 against bf16 (reported); peak memory; latency and profiles
             beside the same wrapper with quantize_int8 off (bf16)
  3c. serving in a group: the server role's Pi0PolicyWrapper from the same
             yaml in a one-rank NCCL group joined from torchrun's variables
             (parallel.distributed.initialize, the yaml's mesh through
             make_mesh, serve/group.py's protocol: rank 0 broadcasts each
             call's header and arrays and gathers the actions), int8 at batch
             64 and bf16 at batch 1, each beside the same wrapper without a
             group built from the same seed. Gates: the backend is nccl; env
             actions bit-equal to the wrapper without a group, call by call
             (a world of one gathers no weight and reduces nothing); 17
             flash_attention and, in int8, 1544 w8a8_matmul launches per
             inference; per inference 7 broadcasts (the header, five arrays,
             the noise) and one all-gather. Reported: time per inference with
             and without the group (alternating, each first in turn), a
             profile of each at int8 batch 64, the card's name and power limit.
             Then the int8 wrapper once more with every leaf the rules split at
             fsdp 2 held as a Sharded of one part over the world group, so each
             layer, the embedding and every W8A8 product run on weights
             gathered through the group: actions bit-equal to the wrapper
             without a group, 17 and 1544 launches, one bucket all-gather per
             layer that holds split leaves and one for the embedding (226);
             its time beside the wrapper without one, and, from one profiled
             inference, its device busy share and the host and device ms of
             the buckets' gather and unpack ranges
  3d. tensor parallelism: two ranks on the one card, each a process of its
             own in a gloo group over the card's tensors (NCCL refuses two
             ranks of one device; every collective is staged through the
             host, counted), mesh (1, 1, 2). First the row-parallel W8A8 entry
             against its plain versions at Gemma-2B's o and down, Magma-8B's
             o and down and SpatialVLA-4B's down K / 2 slices
             of a batch-64 prefill (int32 partials and row scales equal, the
             finish pass within one bf16 ulp of the row's max, two slices
             summed and finished bit-equal to w8a8_matmul on the whole rows),
             with times beside the bound, the plain versions and
             torch._int_mm (and MVLA's expert down K / 2 at batch 64 and
             16). Then the server role's Pi0PolicyWrapper from the ev yaml at
             TP_PI0_DEPTH of its 18 Gemma layers (both towers) and
             TP_PI0_VISION_DEPTH of SigLIP's 27 on each rank
             (its tensor slices of the split leaves: column-parallel q, gate,
             up and fc1, row-parallel o, down and fc2, the embedding's
             vocabulary rows; the one K/V head and the patch embed whole),
             rank 0 serving int8 at batch 64 and 1, then bf16 at 64 and 1,
             rank 1 following. Gates, per rank and inference: the
             flash_attention launches (3 at 4 layers, 17 at 18), all on 4
             local query heads; in int8 234 w8a8_matmul, 94 w8a8_partial and
             94 w8a8_finish at 4 and 4 layers (1096, 448, 448 at 27 and 18:
             SigLIP's o and fc2, the prefill's o and down, the expert's per
             Euler step); each rank's actions against the one-card wrapper
             (built here first, the same weights and noise): int8 bit-equal,
             bf16 within TP_BF16_RTOL. Then, in the same two processes, two
             expert-only micro-steps on the int8-frozen prefix (fp32, plain
             attention), held against the same steps without a group on rank
             0 (loss rtol 1e-4, params 1e-4 abs, the int8 codes equal), and
             two in bf16 with the kernel. Reported: each inference's time on
             the ranks, the tensor group's collectives per inference and
             micro-step, the card's name and power limit
  3e. the tensor axis for the token-decoding families: as 3d, two ranks on
             the one card over gloo, mesh (1, 1, 2). The server role's
             Pi0FAST, native SpatialVLA and native Magma wrappers from their ev
             yamls, at full width and the depths the script serves them
             (FAST_SERVING_DEPTH, SVLA_SERVING_DEPTH, MAGMA_SERVING_DEPTH),
             each rank holding its tensor slices (the tables and Magma's
             lm_head split over the vocabulary, the K/V heads where they
             divide), rank 0 serving int8 and then bf16 at batch 1 and 16,
             rank 1 following. Gates, per rank and inference: the launches of
             each kernel and the tensor group's all-reduces and MAX
             all-reduces as counted from the configuration; int8 tokens
             bit-equal to the one-card wrapper's (built here first, the same
             weights and requests); bf16 tokens held by one card's logits
             teacher-forced with them (each within TPA_MARGIN standard
             deviations of the step's maximum; the agreement reported).
             Reported: each inference's time on the ranks and in the staged
             collectives, peak memory per rank and family, and the device
             time the one padding costs (Pi0FAST's decode attention on a
             rank's 4 query heads among zero ones at its 8)
  3f. the tensor axis for MVLA: as 3d, two ranks on the one card over
             gloo, mesh (1, 1, 2). The server role's Pi0PolicyWrapper from
             the ev yaml with config/models/mvla_bridge.json, at phase 8's
             depths (MVLA_VLM_DEPTH, MVLA_EXPERT_DEPTH) and full width, for
             the self/cross expert (mvla), the joint expert (mmmvla) and the
             DiT head (its zero-initialised modulation drawn from the seed),
             each rank holding its tensor slices (the connector's, the
             expert pairs' and the DiT's heads and MLPs; the cross layers'
             one K/V head whole), rank 0 serving int8 and then bf16 at batch
             1 and 16, rank 1 following. Gates, per rank and inference: the
             launches of each kernel and the tensor group's all-reduces and
             MAX all-reduces as counted from the configuration, the attention
             kernel on 4 local query heads; actions against the one-card
             wrapper (built here first: the same weights, requests and
             noise): int8 bit-equal, bf16 within ACTIONS_RTOL. Then two
             expert-only micro-steps of the self/cross model on 4 rows in
             fp32 (plain attention) and two in bf16 (the kernel), against the
             same steps without a group on rank 0 (as 3d's). Reported: each
             inference's time on the ranks and in the staged collectives,
             peak memory per rank
  3g. the tensor axis for the last two training paths: as 3d, two ranks on
             the one card over gloo, mesh (1, 1, 2), against the same work on
             one card without a group (run here first: the same seed's
             weights, batches, draws and salt). First the row kernel at tensor
             rank 1's rows of the Gemma-2B layer pack (its part of the gate
             leaf with the salt shifted, its up leaf at a row offset) and the
             attention kernel on 4 local heads at both paths' training shapes,
             each against its plain version and timed. Then Pi0FAST's
             standard step (pi0fast_finetune_bridge.yaml's model at full
             width, FAST_SERVING_DEPTH trunk and TP_PI0_VISION_DEPTH SigLIP
             layers, the 257,152-row tied table split 128,576 per rank), two
             fp32 micro-steps with the plain attention (one AdamW update) and
             two bf16 ones with the kernel, on TPT_ROWS rows. Gates: fp32
             loss, grad_norm and param_norm within TPT_FP32_RTOL, the params
             within TPT_PARAMS_ATOL, token accuracy equal, the table's first
             gradient gathered within TPT_TABLE_RTOL; bf16 at 3d's
             tolerances; per micro-step the tensor all-reduces and MAX
             all-reduces and the attention launches on 4 local heads as
             counted. Then two fused steps of the 1-chip recipe (bf16 masters,
             SR, fp8 moments, both kernels) at full width and TPT_FUSED_DEPTH
             layer pairs: loss, grad_norm, params, updates and moment codes at
             phase 4's kernel-vs-plain tolerances, grad_norm and the delayed
             clip equal on both ranks, the row kernel's launches per rank as
             counted from the packs' row split, the attention launches and
             tensor collectives as counted; and layer 0 of the VLM trunk
             updated once from one card's gradient (each rank its share)
             bit-equal to one card, params and moments. Reported: the ranks'
             time per path, staged collectives, peak memory per rank
  4. training the 1-chip joint recipe (config/train/pi0_finetune_bridge_1chip.yaml:
             fused step, bf16 params with stochastic rounding, fp8 moments,
             batch 16, synthetic data) at full width and depth through the
             Trainer: every step's loss and grad_norm finite and its launches
             of both kernels as expected; median step time, samples/s, peak
             memory and a profiler pass (the row update's device time per
             step); every distinct row-update leaf shape timed alone beside
             its bound, summed over the step's launches; one step through the
             kernels against one through their plain versions at full width,
             4 layers; and two steps with fp32 masters (master_dtype float32)
             through the Trainer, the row kernel launched on fp32 p and g. The
             trainer saves its last update; these full-tower saves are recorded,
             not written (record_saves)
  5a. the RLDS training-data path without TensorFlow: the host codec's
             self-checks (JPEG q95 round trips above JPEG_PSNR_FLOOR at 256 px
             and at 257 x 255, PNG round trips bit-exact in 1-4 channels, a
             corrupted TFRecord record raising), then a BridgeV2-shaped
             `bridge_dataset` written by the port's writer into RLDS_DIR (64
             episodes of 34-42 steps, the registry's two cameras at 256 x 256
             as JPEG q95, 7-d actions and state, instructions from
             config/dataset/bridge_paraphrases.json, 4 shards), and the train
             path's loader at the recipe's micro-batch and thread count:
             frames/s, the split between read+parse, decode and
             crop-resize-jitter, batches' shapes, dtypes and ranges, and the
             paraphrased share
  5. standard training through the Trainer's standard step, at full width and
             depth (random weights from the seed, hash tokenizer):
             expert-only, config/train/pi0_finetune_bridge_expertonly.yaml
             fed from phase 5a's directory (data.backend rlds, augmentation,
             task_paraphrase on; every raw batch checked as in 5a; the
             trainer's wait on next(data) per update reported)
             (frozen int8 prefix, fp32 expert masters, AdamW) with mesh.fsdp 1,
             micro-batch 96, global 192 (accumulation 2), 3 updates, saves at
             2 and 3, validation at 3 on one batch of 96: every micro-step's
             loss, grad_norm and param_norm finite and its launches as counted
             from the configuration (flash_attention: the kv_only prefill's
             depth - 1; w8a8_matmul: the int8 nodes quantize_frozen made, from
             the tree), the validation's too; l1_loss finite and one acc@t per
             eval_threshold; frozen leaves (int8 codes, scales, bf16) bit-
             unchanged and the trainable ones moved; step_2 and step_3 written,
             and a resume from step_3 restoring cnt_update 3 and a state equal
             to the saved one; each prefill attention launch against its plain
             version on its own inputs (STD_ATTN_RTOL); the frozen prefix K/V
             cache bit-equal with only the W8A8 product plain, and within
             STD_KV_RTOL with only the attention plain; one micro-step's
             gradient of every trainable leaf and one update through the
             kernels against through their plain versions (STD_* tolerances);
             a profiler pass.
             standard joint (synthetic episodes), config/train/pi0_finetune_bridge.yaml (bf16
             masters, 8-bit AdamW, stochastic rounding, remat) with mesh.fsdp
             1, micro-batch 32, global 64, 2 updates: finite metrics, int8
             moment codes, flash_attention per micro-step as counted (the
             forward's depth - 1 and their remat recompute), the last update's
             save asked; a profiler pass. Both report median micro-step and
             update times, samples/s and peak memory
  5b. the multi-card recipes (config/train/pi0_finetune_bridge.yaml,
             pi0_finetune_bridge_expertonly.yaml fed from phase 5a's
             directory, with --mesh.fsdp 1 as the script runs on one card, and the
             fused pi0_finetune_bridge_1chip.yaml) through the Trainer in a
             one-rank NCCL group joined from torchrun's variables
             (parallel.distributed.initialize; destroyed at the end), two
             updates each at full width (32 x 2, 96 x 2, 16 x 1); the joint and
             expert-only runs on ZeRO-3: every leaf the recipes' own fsdp-4
             rules split held as a Sharded of one part over the group (each
             layer through the bucket all-gather and, where it trains, the
             bucket reduce-scatter; the 8-bit moments through the per-block MAX
             all-reduce; the expert-only prefix's W8A8 kernel on gathered
             codes). Gates: the trainer's init at fsdp > 1 (drawn on the
             card, each leaf handed to the host) bit-equal to the init on the
             card at pi0_tiny; the backend is nccl; the launches of the three
             kernels per micro-step are phases 4 and 5's; the bucket
             all-gathers and reduce-scatters per micro-step and the
             collectives per update (each wrapper's count) are the ones
             counted from the configuration and the state; loss and grad norm
             finite; the params after the updates bit-equal to phases 4 and
             5's runs of the same recipes without a group at the same
             micro-step. Reported: each update's and micro-step's time and the
             peak memory with and without the group and the shares, the
             buckets' host and device ms, the card's name and power limit
  6. Pi0FAST serving: the server role's Pi0PolicyWrapper from
             config/experiment/simplerMS3/pi0fast_finetune_bridge_ev.yaml
             (SigLIP So400m + Gemma-2B at full width, its depth cut to
             FAST_SERVING_DEPTH of 18 layers, 329-token prefix, 28 greedy
             single-token steps of the whole trunk against a growing K/V
             cache; random weights from the seed, hash tokenizer) with
             quantize_int8 on: requests through infer_batch at batch 1 and at
             bucket 64 (one request of the sweep's n_parallel_eval 60 rows, as
             one ManiSkill3 client sends them), with 17 flash_attention and the tree's count of
             w8a8_matmul launches per inference checked; env actions finite and
             of the right shape; every token in the vocabulary tail window; the
             int8 tokens, every step's window logits and the actions bit-equal
             with only the W8A8 product plain, and the served env actions
             equal to those tokens postprocessed; then in bf16 (the same weights,
             quantize_int8 off) the kernel path against the plain-attention
             path three ways (the prefix K/V cache, every step's window logits
             with the kernel path's tokens forced into the plain path, and the
             plain logit of each kernel token within a margin of the plain
             maximum; the share of agreeing tokens is reported); latency at
             batch 1 and 64 (int8 beside bf16 through the same wrapper), peak
             memory and one profiler pass each
  7. Pi0FAST training: config/train/pi0fast_finetune_bridge.yaml through
             the Trainer's standard step at full width and depth (fp32 masters,
             AdamW, per-layer recompute) with mesh.fsdp 1, micro-batch 16, global 32
             (accumulation 2), 2 updates, validation once on one batch, the
             last save recorded: every micro-step's loss, token accuracy and
             grad norm finite, flash_attention launches per micro-step as
             counted (the prefill's layers and their recompute), the
             validation's too; micro-step and update time, samples/s, peak
             memory and a profiler pass; one micro-step's gradient of every
             leaf through the kernel against through plain attention at full
             width and 4 layers
  8. MVLA serving: the server role's Pi0PolicyWrapper from
             config/experiment/simpler/pi0_finetune_bridge_ev.yaml with
             config/models/mvla_bridge.json as its model (SigLIP So400m,
             Gemma-2B over a 436-token prefix with 108 metaqueries, the
             12-layer connector, the 18-layer self/cross expert, chunk 50, 10
             Euler steps; the VLM cut to MVLA_VLM_DEPTH and the expert to
             MVLA_EXPERT_DEPTH of their 18 layers; random weights from the
             seed, hash tokenizer): int8
             at batch 1 and 64 with the launches of both kernels per
             inference checked against the count from the configuration
             (34 flash_attention and 641 w8a8_matmul at 4 and 6 layers,
             108 and 1471 at 18 and 18); env actions finite and
             of the right shape; the int8 actions bit-equal with only the W8A8
             product plain; then bf16 behind the same wrapper (the connector
             prompt within MVLA_PROMPT_RTOL and the actions within
             ACTIONS_RTOL of the plain-attention path); latency at batch 1
             and 64 (int8 beside bf16), peak memory and profiles; then
             mmmvla (the joint expert, 9 attention launches at 4 and 6
             layers, 35 at 18 and 18) in bf16 at
             batch 64, and the DiT head (action_head "dit", its zero-init
             leaves drawn from the seed) through sample_actions at batch 64,
             each against its plain-attention path
  9. MVLA training: config/train/pi0_finetune_bridge.yaml with
             mvla_bridge.json (bf16 masters, 8-bit AdamW, SR, remat, the
             full tower at MVLA_VLM_DEPTH VLM and MVLA_EXPERT_DEPTH expert
             layers; the recipe freezes nothing for mvla) through the
             Trainer at micro-batch 16 x 2, 2 updates, validation on one
             batch, a save at update 2 and a resume equal to it: every
             micro-step's metrics finite and its flash_attention launches
             (11 at 4 and 6 layers: the prefill's layers, their recompute,
             the expert's self layers; 45 at 18 and 18), 34 per validation
             batch (108 at 18 and 18); update time, samples/s, peak memory
             and a
             profile; one micro-step's gradient of every leaf through the
             kernel against through plain attention at full width, 4 layers
  10. SpatialVLA serving: the server role's SpatialVLANativePolicyWrapper from
             config/experiment/simpler/spatialvla_finetune_bridge_ev.yaml with
             model_cfg {"type": "spatialvla_native"} (SigLIP So400m, Ego3D,
             Gemma2-2B at full width, its depth cut to SVLA_SERVING_DEPTH of
             26 layers, over a 304-token bidirectional prefix, 12 greedy
             spatial tokens against its K/V cache, the tied 259,714-row
             vocabulary; random weights from the seed, hash tokenizer, the Bridge
             adapter in place of the yaml's undefined one): int8 at batch 1 and
             64 with the W8A8 launches per inference counted from the
             configuration (the tied unembedding among them) and no attention
             kernel launch; ensembled env actions finite, (1, 7); the served
             actions equal to the decoded tokens'; the int8 tokens and every
             step's teacher-forced logits bit-equal with only the W8A8 product
             plain; then bf16 behind the same wrapper, and bf16 against an fp32
             run of the same weights at full width and SVLA_FP32_DEPTH Gemma2
             layers (token agreement and logit margins, reported);
             latency at batch 1 and 64 (int8 beside bf16), peak memory, profiles
             and the unembedding's share of device time
  11. Magma serving: the server role's MagmaNativePolicyWrapper from
             config/experiment/simpler/magma_bridge_ev.yaml with model_cfg
             {"type": "magma_native"} (ConvNeXt-XXLarge at 512 px, the
             2-layer projector, LLaMA-3-8B at full width, its depth cut to
             MAGMA_SERVING_DEPTH of 32 layers, over a 321-token prompt with 256
             image placeholders, 8 greedy tokens against its K/V cache, the
             untied 128,256-row lm_head; random weights from the seed, hash
             tokenizer, the Bridge adapter in place of the yaml's undefined
             one): int8 at batch 1 and 64 with the W8A8 launches per
             inference counted from the configuration (456 at 8 layers: 7
             per layer and the lm_head per step) and no attention kernel launch; env
             actions finite, (1, 7); the served actions equal to the decoded
             tokens'; the int8 tokens and every step's teacher-forced logits
             bit-equal with only the W8A8 product plain; then bf16 behind the
             same wrapper, and bf16 against fp32 at full width and 4 LLaMA
             layers (token agreement and logits rel L2, reported); latency at
             batch 1 and 64 (int8 beside bf16), peak memory, profiles and the
             lm_head's share of device time
  12. Octo serving: the server role's OctoPolicyWrapper from
             config/experiment/simpler/octo_base_bridge_ev.yaml with model_cfg
             {"type": "octo_base_upstream"} (octo-base as released: SmallStem16
             at 256 px, T5-base, ViT-B over 16 + 2 x 257 tokens, 20 clipped
             DDPM steps of the MLPResNet head; random fp32 weights from the
             seed, bf16 compute, hash tokenizer, OctoBridgeSimplerAdapter in
             place of the yaml's undefined adapter, its antialiased lanczos3
             through the port's codec at 256 px): two requests per session through the
             session's history deque (padded, then full) fused at batch 1 and
             64, with no hand-kernel launch (gated: plain attention, no int8
             Octo, as in the reference); env actions finite, of the right
             shape; the raw chunk within +-max_action; the padded frame's
             pixels leave the actions bit-equal (same generator state); the
             weights written as a released-layout flax-msgpack snapshot and
             loaded through switch_model give bit-equal actions; the yaml's
             own native "octo" type at batch 64; one compute_loss and
             backward at batch 16, finite; bf16 against fp32 readouts,
             latency at batch 1 and 64, peak memory and profiles
  13. the client role: the Simpler, ManiSkill3 and LIBERO evaluators
             (intact_tpu_torch/envs/evaluators) against one int8 Pi0PolicyWrapper
             built as in phase 3b, each through a LoopbackClient that makes
             the batching server's per-connection calls in this process (a
             PolicySession's preprocess, then infer_batch of the one request;
             the card machine has no websockets or msgpack) over fakes that
             render at the model's 224 px (no cv2 or PIL resize runs):
             Simpler on the yaml's first task, 2 episodes of 24 steps, the
             first recorded (.npz); ManiSkill3 from
             config/experiment/simplerMS3/pi0_finetune_bridge_ev.yaml, one
             batch episode of its n_parallel_eval 60 envs whose observations
             are tensors on the card (60-row requests, bucket 64); LIBERO's
             libero_spatial, one episode of 10 settle steps and 24 more,
             through a LiberoAdapter session. Gates: 12 / 6 / 6 inferences, and
             17 flash_attention and 1544 w8a8_matmul launches per inference
             (this is what turns an error LIBERO's per-episode except swallows
             into a failed phase); every stepped action finite, of shape (7,)
             or (60, 7), with a +-1 gripper (Bridge adapters) and equal to the
             served chunks' first action_step rows in order; LIBERO's frame
             the env's rotated 180 degrees; results with exactly the metric
             keys in [0, 1]; eval.log with the summary block under the
             reference's log-dir layout. Reported: wall time, inferences, env
             steps/s and the share of the loop inside client.infer
The second-to-last line is `nvidia-smi`'s card name and power limit; the last
line is {"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))

DEVICE = "cuda"
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
# the kernel and its plain version round at different places (bf16 P, bf16
# output, fp32 sums in another order): 2 bf16 ulps at |out| ~ 1
KERNEL_ATOL = 2e-2
# relative L2 distance between bf16 actions from the kernel path and the plain
# path: the two round q*scale and the logits at different places in 17 layers,
# and 10 Euler steps carry that through the expert (bf16 rounding is 2^-9)
ACTIONS_RTOL = 5e-2
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores, H100 SXM data sheet
# fused_adam_rows: bytes each element must move (p read+write 2+2, g 2, the two
# fp8 codes read+write 1+1 each) and its fp32 operations (decode 2, clip 1,
# g*g and the ss sum 2, the two moments 7, direction 5, decay and update 4,
# two absmax 2, encode 2)
ADAM_BYTES_PER_ELEM = 10
ADAM_FLOPS_PER_ELEM = 25
ADAM_ELEMS_PER_THREAD = 16  # csrc/fused_adam_rows.cu: two 8-element octets per thread and row (B = 2048)
# the kernel repeats the plain version's fp32 operations one by one (no fused
# multiply-adds) and sums ss in another order: scales (one division of equal
# maxima) agree to an fp32 ulp, ss (16 M squares) to 1e-5
ADAM_SCALE_RTOL = 1e-6
ADAM_SS_RTOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 10, kernel: str | None = None) -> float:
    """Device milliseconds of one call of fn: the summed time of the kernels
    it launches, under torch.profiler, over reps calls. Unlike cuda_ms it
    excludes the host's time between the launches, which bounds a call of
    small kernels from an eager host. With `kernel`, for a call that launches
    that one kernel: its mean time over the launches the profiler recorded
    (late in a long run the profiler has been seen to drop kernel records,
    which the plain sum over reps would count as time not taken)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if kernel is None:
        return sum(e.self_device_time_total for e in events) / reps / 1e3
    ours = [e for e in events if kernel in e.key]
    count = sum(e.count for e in ours)
    if count != reps:
        log(f"#   device_ms: the profiler recorded {count} of {reps} launches of {kernel}")
    return sum(e.self_device_time_total for e in ours) / max(count, 1) / 1e3


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from intact_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.build_all(build.SOURCES + tuple(build.HOST_SOURCES))  # nvcc and g++, all started at once
    log(f"# build: {time.perf_counter() - t0:.2f} s for {len(build.SOURCES)} CUDA and {len(build.HOST_SOURCES)} "
        f"host source(s)")
    for name, text in build.ptxas_logs.items():
        entry = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line or "setmaxnreg" in line:
                log(f"# ptxas {name} {entry[:96]}: {line.strip()}")
    # dynamic shared memory, which ptxas does not report
    attn, w8 = build.load("flash_attention"), build.load("w8a8_matmul")
    log(f"# dynamic shared memory per block: attn_kernel D=64/128/256 "
        f"{[attn.intact_flash_attention_smem_bytes(d) for d in (64, 128, 256)]} bytes; w8a8 gemm_kernel "
        f"row/chunk/split {[w8.intact_w8a8_smem_bytes(m) for m in (0, 1, 2)]} bytes")
    log(f"# card: {gpu_name_and_power()}")


def sass_fast_path(so: Path, symbol: str) -> tuple[int, dict]:
    """SASS instructions one thread issues in one pass of the row loop of
    the kernel whose mangled name contains `symbol`, on the path every
    element takes when the operands are in range: from cuobjdump's listing,
    walking from the loop head (the backward branch around the first
    mbarrier wait) to the loop's back-edge; conditional forward branches skip
    the slow paths of the rounded operations and thread 0's ring refill, and
    otherwise fall through (both octets valid); other backward branches (wait loops) are not taken. The
    fast path itself calls nothing, so a forward branch over a CALL skips a
    slow path.
    -> (instructions, {opcode: count})."""
    from intact_tpu_torch.ops import build

    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], check=True, capture_output=True, text=True,
                          timeout=120).stdout
    return count_fast_path(text, symbol)


def count_fast_path(text: str, symbol: str) -> tuple[int, dict]:
    """sass_fast_path on a cuobjdump -sass listing."""
    import re
    from collections import Counter

    ins = None
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        if symbol in part.split("\n")[0]:
            ins = [(int(m.group(1), 16), m.group(2).strip())
                   for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", part)]
            break
    if not ins:
        raise SystemExit(f"no SASS for {symbol}")
    at = {a: i for i, (a, _) in enumerate(ins)}
    branch = re.compile(r"\bBRA(\.\S+)?\s+(?:!?U?P\d,\s*)?0x([0-9a-f]+)")
    wait = next(a for a, t in ins if "SYNCS.PHASECHK" in t)
    back = [(a, int(m.group(2), 16)) for a, t in ins if (m := branch.search(t)) and int(m.group(2), 16) <= a]
    end, head = max(((a, tg) for a, tg in back if tg <= wait < a), key=lambda x: x[0] - x[1])
    i, n, ops = at[head], 0, Counter()
    while True:
        a, t = ins[i]
        n += 1
        ops[re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0]] += 1
        m = branch.search(t)
        if a == end or n > 20000:
            break
        if not m:
            i += 1
            continue
        target = int(m.group(2), 16)
        if not t.startswith("@"):
            i = at[target]
        elif target <= a:
            i += 1
        else:
            skipped = " ".join(x for _, x in ins[i + 1:at[target]])
            i = at[target] if "CALL" in skipped or "UBLKCP" in skipped else i + 1
    return n, dict(ops)


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def prefix_mask(b: int, n_img: int, n_lang: int, rng: np.random.Generator) -> torch.Tensor:
    """The Pi0 prefix mask: every valid image token, a ragged number of
    valid language tokens per row, one full-attention block."""
    from intact_tpu_torch.ops.masks import make_att_2d_masks

    pad = np.zeros((b, n_img + n_lang), bool)
    pad[:, :n_img] = True
    for i, n in enumerate(rng.integers(4, n_lang + 1, size=b)):
        pad[i, n_img:n_img + n] = True
    pad = torch.from_numpy(pad).cuda()
    return make_att_2d_masks(pad, torch.zeros_like(pad, dtype=torch.int32))


def fast_mask(b: int, n_suffix: int, rng: np.random.Generator) -> torch.Tensor:
    """The Pi0FAST mask: 256 image tokens, a ragged number of the 72 language
    tokens and the state token as one full-attention block, then n_suffix
    causal action tokens (the serving prefill has none, training 28)."""
    from intact_tpu_torch.ops.masks import make_att_2d_masks

    n = 256 + 72 + 1
    pad = np.ones((b, n + n_suffix), bool)
    for i, k in enumerate(rng.integers(4, 73, size=b)):
        pad[i, 256 + k:256 + 72] = False
    att = np.zeros(pad.shape, np.int32)
    att[:, n:] = 1
    return make_att_2d_masks(torch.from_numpy(pad).cuda(), torch.from_numpy(att).cuda())


def mvla_prefix_mask(b: int, rng: np.random.Generator) -> torch.Tensor:
    """MVLA's prefix mask: 256 image tokens and a ragged number of the 72
    language tokens as one full-attention block, then the 108 metaqueries as
    a block of their own (they see everything before them; nothing before
    sees them)."""
    from intact_tpu_torch.ops.masks import make_att_2d_masks

    pad = np.ones((b, 256 + 72 + 108), bool)
    for i, k in enumerate(rng.integers(4, 73, size=b)):
        pad[i, 256 + k:256 + 72] = False
    att = np.zeros(pad.shape, np.int32)
    att[:, 256 + 72] = 1
    return make_att_2d_masks(torch.from_numpy(pad).cuda(), torch.from_numpy(att).cuda())


def suffix_mask(b: int, chunk: int) -> torch.Tensor:
    """The flow suffix's mask: the state token, then the action chunk, each
    a block of its own (models/pi0/model.py::suffix_layout)."""
    from intact_tpu_torch.models.pi0.model import suffix_layout
    from intact_tpu_torch.ops.masks import make_att_2d_masks

    pad, att = suffix_layout(b, types.SimpleNamespace(chunk_size=chunk), "cuda")
    return make_att_2d_masks(pad, att)


def attention_case(rng, b, t, s, h, kvh, d, dtype, mask):
    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)

    return rnd(b, t, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d), mask


def phase_kernels() -> list[dict]:
    from intact_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

    rng = np.random.default_rng(0)
    # bridge: 256 image + 72 language tokens, 8 query heads over 1 KV head
    b, t, h, kvh, d = 64, 328, 8, 1, 256
    bridge = attention_case(rng, b, t, t, h, kvh, d, torch.bfloat16, prefix_mask(b, 256, 72, rng))
    cases = {"bridge": bridge}
    for name, (b_, t_, s_, h_, kvh_, d_, dt) in {
        "ragged_g1_d128": (3, 77, 203, 8, 8, 128, torch.bfloat16),
        "ragged_g8_d256": (2, 45, 150, 8, 1, 256, torch.bfloat16),
        "ragged_g2_d64": (2, 33, 95, 4, 2, 64, torch.bfloat16),
    }.items():
        mask = torch.from_numpy(rng.random((b_, t_, s_)) > 0.3).cuda()
        mask[:, ::7] = False  # fully masked query rows
        cases[name] = attention_case(rng, b_, t_, s_, h_, kvh_, d_, dt, mask)

    max_err = 0.0
    for name, (q, k, v, mask) in cases.items():
        out = flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        ref = flash_attention_reference(q, k, v, mask)
        err = (out.float() - ref.float()).abs().max().item()
        dead = ~mask.any(dim=-1)  # [B, T] rows that attend nothing
        dead_max = out[dead].abs().max().item() if dead.any() else 0.0
        log(f"# flash_attention {name}: q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} "
            f"max_abs_err {err:.3e} (atol {KERNEL_ATOL}), fully masked rows {int(dead.sum())} max |out| {dead_max}")
        if not torch.isfinite(out).all() or err > KERNEL_ATOL or dead_max != 0.0:
            raise SystemExit(f"flash_attention disagrees with its plain version on {name}")
        max_err = max(max_err, err)

    # the serving shape at batch 64 and 1, and the training forward's shape
    # (batch 16, 77 language tokens: 333-byte mask rows), each beside SDPA;
    # then Pi0FAST's: the serving prefill at batch 64 over 329 tokens and the
    # training prefill at batch 16 over 357 (the prefix and 28 causal tokens)
    timed = {"bridge": bridge}
    for name, (b_, n_lang) in {"batch1": (1, 72), "train": (16, 77)}.items():
        timed[name] = attention_case(rng, b_, 256 + n_lang, 256 + n_lang, h, kvh, d, torch.bfloat16,
                                     prefix_mask(b_, 256, n_lang, rng))
    for name, (b_, n_suffix) in {"fast_serve": (64, 0), "fast_train": (16, 28)}.items():
        n = 329 + n_suffix
        timed[name] = attention_case(rng, b_, n, n, h, kvh, d, torch.bfloat16, fast_mask(b_, n_suffix, rng))
    # MVLA's at batch 64: the prefill over 256 image + 72 language + 108
    # metaquery tokens, the expert's self-attention over the 51-token suffix
    # (every self layer of every Euler step), and the joint expert's prompt
    # prefill over the 108 metaqueries (the all-true mask the path builds;
    # held without a mask as well)
    timed["mvla_prefix"] = attention_case(rng, 64, 436, 436, h, kvh, d, torch.bfloat16, mvla_prefix_mask(64, rng))
    timed["mvla_suffix"] = attention_case(rng, 64, 51, 51, h, kvh, d, torch.bfloat16, suffix_mask(64, 50))
    timed["mvla_joint"] = attention_case(rng, 64, 108, 108, h, kvh, d, torch.bfloat16,
                                         torch.ones((64, 108, 108), dtype=torch.bool, device="cuda"))
    # and MVLA's prefix on one tensor rank's 4 local query heads at t = 2 (phase 3f)
    timed["mvla_prefix_local"] = attention_case(rng, 64, 436, 436, h // 2, kvh, d, torch.bfloat16,
                                                mvla_prefix_mask(64, rng))
    q, k, v, _ = timed["mvla_joint"]
    err = (flash_attention(q, k, v, None).float() - flash_attention_reference(q, k, v, None).float()).abs().max().item()
    log(f"# flash_attention mvla_joint without a mask: max_abs_err {err:.3e} (atol {KERNEL_ATOL})")
    if not err <= KERNEL_ATOL:
        raise SystemExit("flash_attention disagrees with its plain version on mvla_joint without a mask")
    max_err = max(max_err, err)
    times = {}
    for name, (q, k, v, mask) in timed.items():
        b_, t_, s_ = q.shape[0], q.shape[1], k.shape[1]
        out = flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        err = (out.float() - flash_attention_reference(q, k, v, mask).float()).abs().max().item()
        if name != "bridge" and (err > KERNEL_ATOL or not torch.isfinite(out).all()):
            raise SystemExit(f"flash_attention disagrees with its plain version on {name}")
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: flash_attention(q, k, v, mask))
        plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, mask), reps=10)
        qt, kt, vt, mt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask[:, None]
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mt, enable_gqa=True))
        moved = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size() + mask.numel()
        flops = 4 * q.shape[2] * d * int(mask.sum())  # QK^T and P.V over the live (query, key) pairs only
        bytes_ms, ops_ms = moved / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3
        times[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bytes_ms=bytes_ms, ops_ms=ops_ms)
        log(f"# flash_attention {name} timing (B={b_}, T=S={t_}, max_abs_err {err:.3e}): kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
            f"({moved / 1e6:.1f} MB -> {bytes_ms:.4f} ms, {flops / 1e9:.1f} GFLOP -> {ops_ms:.4f} ms), "
            f"{flops / ms / 1e9:.1f} TFLOP/s, kernel / sdpa {ms / library_ms:.3f}")
    flash_attention.launches = 0  # comparison launches do not count
    ms, plain_ms, library_ms, bytes_ms, ops_ms = (times["bridge"][k] for k in
                                                  ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms"))
    return [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "intact_tpu_torch/csrc/flash_attention.cu",
        "replaces": "intact_tpu/ops/pallas_attention.py:71",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "batch1_ms": times["batch1"]["ms"], "batch1_library_ms": times["batch1"]["library_ms"],
        "train_ms": times["train"]["ms"], "train_library_ms": times["train"]["library_ms"],
        **{f"{name}_{key}": (max(times[name]["bytes_ms"], times[name]["ops_ms"]) if key == "bound_ms"
                             else times[name][key])
           for name in ("fast_serve", "fast_train", "mvla_prefix", "mvla_suffix", "mvla_joint", "mvla_prefix_local")
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
    }, phase_adam_kernel(), phase_w8a8_kernel()]


def fp8_index(codes: torch.Tensor) -> torch.Tensor:
    """fp8 codes (sign-magnitude bytes) -> integers ordered like their
    values, so that neighbouring codes differ by 1."""
    u = codes.view(torch.uint8).to(torch.int32)
    return torch.where(u >= 128, -(u - 128), u)


def adam_case(rng: np.random.Generator, L: int, r: int, NB: int, B: int, fp8: bool, p_dtype=torch.bfloat16):
    """Random p and g (bf16 or fp32) and moments at realistic magnitudes."""
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 31)))

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda").mul_(std)

    p = randn(L, r, B, std=0.02).to(p_dtype)
    g = randn(r, B, std=1e-3).to(p_dtype)
    mu, nu = randn(L, NB, B, std=1e-3), randn(L, NB, B, std=1e-6).square_()
    if not fp8:
        return p, g, mu, torch.zeros(L, NB, device="cuda"), nu, torch.zeros(L, NB, device="cuda")
    out = []
    for x, dt in ((mu, torch.float8_e4m3fn), (nu, torch.float8_e5m2)):
        s = x.abs().amax(-1) / (448.0 if dt == torch.float8_e4m3fn else 57344.0)
        out += [(x / s[..., None]).to(dt), s]
        del x
    return (p, g, *out)


def adam_bytes(r: int, B: int, p_dtype, fp8: bool) -> int:
    """Bytes one call must move: p read and written, g read, the two moment
    rows read and written, and with fp8 the two scale rows read and written."""
    p = torch.finfo(p_dtype).bits // 8
    m = 1 if fp8 else 4
    return r * B * (3 * p + 4 * m) + (r * 4 * 4 if fp8 else 0)


def adam_check_case(name: str, orig, kw: dict, calls: int = 1) -> float:
    """fused_adam_rows against its plain version on copies of orig; with
    calls > 1 the kernel runs that many times back to back on its cached
    workspace and the plain version's last call starts from the kernel's
    state (ss accumulates every call on both sides). -> max |p difference|."""
    from intact_tpu_torch.ops.fused_adam import fused_adam_rows, fused_adam_rows_reference

    layer, off = kw["layer"], kw["row_offset"]
    L, r, B = orig[0].shape
    kern = [x.clone() for x in orig]
    ref = [x.clone() for x in orig]
    ss_k, ss_r = torch.zeros(1, device="cuda"), torch.zeros(1, device="cuda")
    for c in range(calls):
        if c == calls - 1:
            ref = [x.clone() for x in kern]
        fused_adam_rows(*kern, ss=ss_k, **kw)
        torch.cuda.synchronize()
        fused_adam_rows_reference(*ref, ss=ss_r, **kw)
    rows = slice(off, off + r)
    fp8 = kern[2].dtype != torch.float32
    pk, pr = kern[0][layer].float(), ref[0][layer].float()
    mant = 7 if kern[0].dtype == torch.bfloat16 else 23
    ulp = torch.exp2(torch.floor(torch.log2(pr.abs().clamp_min(2.0**-126))) - mant)
    p_ulps = ((pk - pr).abs() / ulp).max().item()
    if fp8:
        code_gap = max((fp8_index(kern[i][layer, rows]) - fp8_index(ref[i][layer, rows])).abs().max().item()
                       for i in (2, 4))
        scale_rel = max(((kern[i][layer, rows] - ref[i][layer, rows]).abs() / ref[i][layer, rows]).max().item()
                        for i in (3, 5))
    else:
        code_gap = 0
        scale_rel = max(((kern[i][layer, rows] - ref[i][layer, rows]).abs()
                         / ref[i][layer, rows].abs().clamp_min(1e-30)).max().item() for i in (2, 4))
    ss_rel = abs(ss_k.item() - ss_r.item()) / ss_r.item()
    untouched = all(
        torch.equal(k[:layer], o[:layer]) and torch.equal(k[layer + 1:], o[layer + 1:])
        for k, o in zip(kern, orig)
    ) and all(
        torch.equal(kern[i][layer, :off], orig[i][layer, :off])
        and torch.equal(kern[i][layer, off + r:], orig[i][layer, off + r:]) for i in (2, 3, 4, 5))
    same_p = torch.equal(kern[0], ref[0])
    log(f"# fused_adam_rows {name}: p [{L}, {r}, {B}] {kern[0].dtype}, moments {list(kern[2].shape)} "
        f"{kern[2].dtype}/{kern[4].dtype}, layer {layer}, rows [{off}, {off + r}), SR {kw['stochastic']}, "
        f"{calls} call(s): p max {p_ulps:.3f} ulp (gate: bit-equal {same_p}), codes max {code_gap} apart (tol 1), "
        f"{'scales' if fp8 else 'fp32 moments'} max rel {scale_rel:.3e} (tol {ADAM_SCALE_RTOL}), "
        f"ss rel {ss_rel:.3e} (tol {ADAM_SS_RTOL}), outside rows/layers bit-identical {untouched}")
    if not (same_p and code_gap <= 1 and scale_rel <= ADAM_SCALE_RTOL and ss_rel <= ADAM_SS_RTOL
            and untouched and all(torch.isfinite(x.float()).all() for x in kern)):
        raise SystemExit(f"fused_adam_rows disagrees with its plain version on {name}")
    return (pk - pr).abs().max().item()


def adam_math_checks() -> None:
    """The kernel's fast division, square root and direction against the
    correctly rounded operations, bit for bit, wherever it takes them."""
    from intact_tpu_torch.ops.fused_adam import math_check

    gen = torch.Generator(device="cuda").manual_seed(4)
    n = 1 << 24

    def exp2(lo, hi):
        return torch.exp2(torch.randint(lo, hi, (n,), generator=gen, device="cuda").float())

    def with_zeros(x):  # a tenth of the values +0 or -0, as moments that never had a gradient
        zero = torch.rand(n, generator=gen, device="cuda") < 0.1
        return torch.where(zero, torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, 0.0, -0.0), x)

    a = (torch.rand(n, generator=gen, device="cuda") * 2 - 1) * exp2(-61, 62)
    d = (torch.rand(n, generator=gen, device="cuda") + 1) * exp2(-61, 62)
    results = {"divide": math_check(with_zeros(a), d, "divide"), "sqrt": math_check(a.abs(), d, "sqrt")}
    for c1, c2 in ((1 - 0.9, 1 - 0.999), (1 - 0.9**3, 1 - 0.999**3), (1.0, 1.0)):
        for scale in (1e-3, 1e-9):
            m = with_zeros(torch.randn(n, generator=gen, device="cuda") * scale)
            v = with_zeros(torch.randn(n, generator=gen, device="cuda").square() * scale**2 + torch.rand(
                n, generator=gen, device="cuda") * scale)
            results[f"direction c1 {c1:.3g} c2 {c2:.3g} |mu| ~{scale:g}"] = math_check(m, v, "direction", c1, c2, 1e-8)
    log("# fused_adam_rows fast paths vs correctly rounded (cases in range, differing): "
        + ", ".join(f"{k} {t}/{w}" for k, (t, w) in results.items()))
    if any(w for _, w in results.values()) or any(t < n // 2 for t, _ in results.values()):
        raise SystemExit("the row kernel's fast division or square root differs from the correctly rounded one")


def phase_adam_kernel() -> dict:
    """fused_adam_rows against its plain version on the card: the Gemma-2B
    gate leaf in the full packed fp8 moments (SR on and off), an fp32 moment
    case, fp32 p and g (the fp32-master case) and two calls back to back;
    every row and layer outside the leaf's must stay as it was. Then the
    fast-path checks, the SASS instructions per element, and the gate leaf's
    times beside its bound (bf16 and fp32 p)."""
    from intact_tpu_torch.ops import build
    from intact_tpu_torch.ops.fused_adam import fused_adam_rows, fused_adam_rows_reference
    from intact_tpu_torch.train.optim import OptimizerConfig

    hp = OptimizerConfig(lr=5e-5, weight_decay=0.0)
    rng = np.random.default_rng(3)
    # Gemma-2B trunk pack at block 2048: NB = 57344 rows per layer, the gate
    # leaf owns rows [20992, 20992 + 16384) (TrunkPack order: attn k, o, q, v,
    # mlp down, gate, up, then the norms)
    gate = dict(L=18, r=16384, NB=57344, B=2048, off=20992, layer=5)
    expert_q = dict(L=4, r=1024, NB=4096, B=2048, off=1024, layer=2)
    cases = {
        "gate_fp8_sr": (gate, True, True, torch.bfloat16, 1),
        "gate_fp8": (gate, True, False, torch.bfloat16, 1),
        "expert_q_fp32_sr": (expert_q, False, True, torch.bfloat16, 1),
        "expert_q_fp32_params": (expert_q, True, False, torch.float32, 1),
        "expert_q_two_calls": (expert_q, True, True, torch.bfloat16, 2),
    }
    hyp = torch.tensor([1 - 0.9**3, 1 - 0.999**3, 5e-5, 0.7], device="cuda")
    max_err = 0.0
    timed = None
    for name, (sh, fp8, sr, p_dtype, calls) in cases.items():
        L, r, NB, B, off, layer = (sh[k] for k in ("L", "r", "NB", "B", "off", "layer"))
        orig = adam_case(rng, L, r, NB, B, fp8, p_dtype)
        kw = dict(layer=layer, row_offset=off, hyp=hyp, hp=hp, salt=987654321, stochastic=sr)
        max_err = max(max_err, adam_check_case(name, orig, kw, calls))
        if name == "gate_fp8_sr":
            timed = [x.clone() for x in orig], kw
        del orig
        torch.cuda.empty_cache()
    adam_math_checks()

    so = build._target("fused_adam_rows")
    clock_hz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                    check=True, capture_output=True, text=True, timeout=60).stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sass = {}
    for label, symbol in (("bf16 p, fp8, SR", "fused_adam_rows_kernelILb0ELb1ELb1E"),
                          ("fp32 p, fp8", "fused_adam_rows_kernelILb1ELb1ELb0E")):
        n_ins, ops = sass_fast_path(so, symbol)
        sass[label] = n_ins / ADAM_ELEMS_PER_THREAD
        top = ", ".join(f"{k} {v}" for k, v in sorted(ops.items(), key=lambda x: -x[1])[:10])
        log(f"# fused_adam_rows SASS ({label}): {n_ins} instructions per thread per row on the in-range path, "
            f"{sass[label]:.2f} per element ({top})")

    args, kw = timed
    L, r, B = args[0].shape
    ss = torch.zeros(1, device="cuda")
    call = lambda: fused_adam_rows(*args, ss=ss, **kw)  # noqa: E731
    ms = cuda_ms(call)
    dev_ms = device_ms(call, kernel="fused_adam_rows_kernel")
    plain_ms = cuda_ms(lambda: fused_adam_rows_reference(*args, ss=ss, **kw), reps=5, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        call()
    host_us = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()
    n = r * B
    moved = adam_bytes(r, B, torch.bfloat16, True)
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    ops_ms = n * ADAM_FLOPS_PER_ELEM / H100_FP32_FLOPS * 1e3
    issue_ms = n / 32 * sass["bf16 p, fp8, SR"] / (sms * 4 * clock_hz) * 1e3
    log(f"# fused_adam_rows gate leaf timing: kernel {ms:.4f} ms (CUDA events around the wrapper), device "
        f"{dev_ms:.4f} ms (profiler), plain {plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
        f"({moved / 1e6:.1f} MB -> {bytes_ms:.4f} ms, {n * ADAM_FLOPS_PER_ELEM / 1e9:.2f} GFLOP fp32 -> "
        f"{ops_ms:.4f} ms), {moved / dev_ms / 1e6:.1f} GB/s on the device, device / bound "
        f"{dev_ms / bytes_ms:.3f}; issue time of its SASS at {clock_hz / 1e9:.3f} GHz on {sms} SMs "
        f"{issue_ms:.4f} ms; wrapper host time {host_us:.1f} us per call; no library call computes this function")
    del args, timed
    torch.cuda.empty_cache()
    # what this card's memory sustains for a plain read-and-write stream of
    # the gate leaf's size: one device-to-device copy of 336 MB
    src = torch.empty(moved // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = device_ms(lambda: dst.copy_(src))
    log(f"# a device copy of {src.numel() / 1e6:.1f} MB (reads and writes {2 * src.numel() / 1e6:.1f} MB): device "
        f"{copy_ms:.4f} ms, {2 * src.numel() / copy_ms / 1e9:.3f} TB/s; the row kernel moves "
        f"{moved / dev_ms / 1e9:.3f} TB/s, {copy_ms * moved / (2 * src.numel()) / dev_ms:.3f} of the copy's rate")
    del src, dst
    # the fp32-master case at the gate leaf's shape (one layer)
    args32 = adam_case(rng, 1, 16384, 16384, 2048, True, torch.float32)
    kw32 = dict(kw, layer=0, row_offset=0, stochastic=False)
    ms32 = cuda_ms(lambda: fused_adam_rows(*args32, ss=ss, **kw32))
    dev32 = device_ms(lambda: fused_adam_rows(*args32, ss=ss, **kw32), kernel="fused_adam_rows_kernel")
    bound32 = adam_bytes(16384, 2048, torch.float32, True) / H100_BYTES_PER_S * 1e3
    log(f"# fused_adam_rows gate leaf with fp32 p and g: kernel {ms32:.4f} ms, device {dev32:.4f} ms, "
        f"bound {bound32:.4f} ms (bytes), device / bound {dev32 / bound32:.3f}")
    del args32
    torch.cuda.empty_cache()
    fused_adam_rows.launches = 0  # comparison launches do not count
    return {
        "name": "fused_adam_rows",
        "route": "cuda",
        "source": "intact_tpu_torch/csrc/fused_adam_rows.cu",
        "replaces": "intact_tpu/ops/pallas_adam.py:141",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        # fp8 moments with per-row absmax scales and hash SR: no single
        # PyTorch call computes this update
        "library_ms": None,
        "device_ms": dev_ms,
        "host_us_per_call": host_us,
        "sass_per_element": sass["bf16 p, fp8, SR"],
        "issue_ms": issue_ms,
        "fp32_params_ms": ms32,
        "fp32_params_device_ms": dev32,
        "fp32_params_bound_ms": bound32,
        "copy_rate_tb_s": moved / copy_ms / 1e9,
        "shape": "Gemma-2B gate leaf, 16384 x 2048, fp8 moments, SR",
    }


H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak, H100 SXM data sheet
# w8a8_matmul against its plain version: the same codes and scales are
# expected; each fused multiply-add of the plain version is formed in float64,
# which rounds twice where the kernel's __fmaf_rn rounds once, so an output
# may differ by one fp32 ulp where that lands on an fp32 tie (about 2^-29 of
# values), which a bf16 cast hides unless it also sits on a bf16 tie: allow
# one bf16 ulp of the row's largest |y| per element
W8A8_ROW_RTOL = 2.0**-8
# the bridge's W8A8 products: (name, M, K, N); M = B*256 (SigLIP, img_proj),
# B*328 (Gemma prefill), B*5 (expert decode) at batch 64, and a batch-1 decode;
# Pi0FAST's greedy decode runs every Gemma-2B product at M = B (64 and 1)
W8A8_SHAPES = (
    ("gemma_q", 20992, 2048, 2048), ("gemma_k", 20992, 2048, 256), ("gemma_up", 20992, 2048, 16384),
    ("gemma_down", 20992, 16384, 2048), ("siglip_fc1", 16384, 1152, 4304), ("siglip_fc2", 16384, 4304, 1152),
    ("img_proj", 16384, 1152, 2048), ("expert_q", 320, 1024, 2048), ("expert_down", 320, 4096, 1024),
    ("expert_q_b1", 5, 1024, 2048), ("expert_down_b1", 5, 4096, 1024),
    ("fast_decode_q", 64, 2048, 2048), ("fast_decode_k", 64, 2048, 256), ("fast_decode_up", 64, 2048, 16384),
    ("fast_decode_down", 64, 16384, 2048), ("fast_decode_k_b1", 1, 2048, 256),
    ("mvla_conn_up", 6912, 1024, 4096), ("mvla_cross_k", 6912, 1024, 256), ("mvla_expert_q", 3264, 1024, 2048),
    # SpatialVLA-4B: the tied unembedding (fp32 out) at batch 64 and 1, the
    # Gemma2 prefill at M = 64 x 304, and a decode product at M = 64; no bias,
    # as the model's products have none
    ("svla_unembed", 64, 2304, 259_714), ("svla_unembed_b1", 1, 2304, 259_714), ("svla_q", 19456, 2304, 2048),
    ("svla_k", 19456, 2304, 1024), ("svla_gate", 19456, 2304, 9216), ("svla_down", 19456, 9216, 2304),
    ("svla_decode_gate", 64, 2304, 9216),
    # Magma-8B (LLaMA-3-8B): the untied lm_head (bf16 out, cast to fp32 after)
    # at batch 64 and 1, the prefill at M = 64 x 321 (down at K 14,336, the
    # largest K of any path; gate; the GQA k), and the decode's down at M = 64
    ("magma_lm_head", 64, 4096, 128_256), ("magma_lm_head_b1", 1, 4096, 128_256),
    ("magma_down", 20544, 14336, 4096), ("magma_gate", 20544, 4096, 14336), ("magma_k", 20544, 4096, 1024),
    ("magma_decode_down", 64, 14336, 4096),
    # one tensor rank's column slice at t = 2 (phase 3e): SpatialVLA's unembedding rows 129,857 (fp32 out, rows not
    # 16-byte aligned) and Magma's lm_head columns 64,128, at batch 64 and 1
    ("svla_unembed_t2", 64, 2304, 129_857), ("svla_unembed_t2_b1", 1, 2304, 129_857),
    ("magma_lm_head_t2", 64, 4096, 64_128), ("magma_lm_head_t2_b1", 1, 4096, 64_128),
)
W8A8_TIMED = "gemma_up"  # the shape of the kernels line
W8A8_DECODE = "fast_decode_k"  # Pi0FAST's decode shape the kernels line reports beside it
# MVLA's at batch 64, reported beside it: the connector's up projection
# (M = 64 x 108 metaqueries), a cross layer's prompt k, the expert's q (M = 64 x 51)
W8A8_MVLA = ("mvla_conn_up", "mvla_cross_k", "mvla_expert_q")
# SpatialVLA's, reported beside it; held bit-equal to the plain version (no
# bias: each output is round(round(float(sum) * xs) * ws) on both sides)
W8A8_SVLA = ("svla_unembed", "svla_unembed_b1", "svla_q", "svla_k", "svla_gate", "svla_down", "svla_decode_gate",
             "svla_unembed_t2", "svla_unembed_t2_b1")
# Magma's, reported beside it and held bit-equal the same way (no bias)
W8A8_MAGMA = ("magma_lm_head", "magma_lm_head_b1", "magma_down", "magma_gate", "magma_k", "magma_decode_down",
              "magma_lm_head_t2", "magma_lm_head_t2_b1")
W8A8_EXACT = ("svla", "magma")  # the name prefixes of the shapes held bit-equal


def w8a8_case(gen: torch.Generator, m: int, k: int, n: int):
    """bf16 activations at unit scale with a few large channels, int8 weight
    codes over the full range, K-major ([N, K], as the serving tree holds
    them), per-channel scales near 1e-3, a bias."""
    x = torch.randn(m, k, generator=gen, device="cuda")
    x[:, ::97] *= 8.0  # outlier channels, as real activations have
    wq = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    ws = (torch.rand(n, generator=gen, device="cuda") + 0.5) * 1e-3
    bias = torch.randn(n, generator=gen, device="cuda") * 0.1
    return x.to(torch.bfloat16), wq, ws, bias


def plain_w8a8(x, wq, wscale, bias=None, k_chunk=None, out_dtype=None, weight_layout="kn"):
    """The W8A8 wrapper's signature over its plain version: swapped in for
    the wrapper where a comparison needs the plain product on the main path."""
    from intact_tpu_torch.ops import w8a8

    return w8a8.w8a8_matmul_reference(x, wq if weight_layout == "kn" else wq.t(), wscale, bias, k_chunk, out_dtype)


def w8a8_moved(m: int, k: int, n: int, out_bytes: int = 2) -> int:
    """Bytes of one product: x bf16 read once, w int8 and its fp32 scales read
    once, y (bf16, or fp32 for the unembedding) written once."""
    return m * k * 2 + k * n + n * 4 + m * n * out_bytes


def w8a8_bound_ms(m: int, k: int, n: int, out_bytes: int = 2) -> tuple[float, float, str]:
    """(bound ms, bytes ms, what bounds it): the bytes of w8a8_moved over the
    memory rate, 2*M*K*N int8 operations over the int8 peak."""
    moved = w8a8_moved(m, k, n, out_bytes)
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    ops_ms = 2 * m * k * n / H100_INT8_OPS * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, "bytes" if bytes_ms >= ops_ms else "operations"


def phase_w8a8_kernel() -> dict:
    """w8a8_matmul against its plain version on the card at the bridge's
    shapes with K-major codes (the serving tree's), per row and (at K 16384
    and 4304, and the expert's K 4096) per 2048-chunk, and two ragged cases
    (one with [K, N] codes): the wrapper's outputs, and the kernel's codes and
    scales (SpatialVLA's and Magma's shapes, without a bias, bit-equal: the
    tied unembedding with fp32 out, Magma's lm_head at N 128,256 and its down
    projection at K 14,336 among them); then times at each per-row shape
    beside the bound, the plain
    version, torch._int_mm on the same codes (the product only) and the bf16
    matmul that int8 replaces, with the kernel's effective rates."""
    from intact_tpu_torch.ops import w8a8

    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = [(name, m, k, n, None) for name, m, k, n in W8A8_SHAPES]
    cases += [(name + "_chunk2048", m, k, n, w8a8.PALLAS_BLOCK_K)
              for name, m, k, n in W8A8_SHAPES if k in (16384, 4304) or name == "expert_down"]
    cases += [("ragged_fp32", 77, 300, 131, None), ("ragged_chunk128", 45, 1000, 200, 128)]
    max_err, rows, timed = 0.0, [], {}
    for name, m, k, n, chunk in cases:
        x, wk, ws, bias = w8a8_case(gen, m, k, n)
        layout, w_in = "nk", wk
        if name.startswith("ragged_fp32"):
            x, out_dtype = x.float(), torch.float32
            layout, w_in = "kn", wk.t().contiguous()  # the [K, N] form
        else:
            out_dtype = torch.float32 if name.startswith("svla_unembed") else torch.bfloat16
        if name.startswith(W8A8_EXACT):
            bias = None
        n0 = w8a8.w8a8_matmul.launches
        y = w8a8.w8a8_matmul(x, w_in, ws, bias, chunk, out_dtype, layout)  # the wrapper the main path calls
        if w8a8.w8a8_matmul.launches != n0 + 1:
            raise SystemExit(f"w8a8_matmul did not launch its kernel on {name}")
        _, xq, xs = w8a8.launch(x, w_in, ws, bias, chunk, out_dtype, layout)  # for its codes and scales
        torch.cuda.synchronize()
        rq, rs = w8a8.quantize_reference(x, chunk)
        ref = w8a8.w8a8_matmul_reference(x, wk.t(), ws, bias, chunk, out_dtype)
        same_codes = torch.equal(xq[:, :k], rq) and not xq[:, k:].any().item()
        same_scales = torch.equal(xs, rs)
        diff = (y.float() - ref.float()).abs()
        err = diff.max().item()
        row_tol = W8A8_ROW_RTOL * ref.float().abs().amax(dim=1, keepdim=True)
        unequal = int((y != ref).sum().item())
        ok = same_codes and same_scales and bool((diff <= row_tol).all()) and bool(torch.isfinite(y).all())
        ok = ok and (unequal == 0 or not name.startswith(W8A8_EXACT))
        log(f"# w8a8_matmul {name}: M {m} K {k} N {n} chunk {chunk or 'row'} {x.dtype}->{out_dtype} {layout} "
            f"{w8a8.plan(m, n, k, chunk)}: codes equal "
            f"{same_codes}, scales equal {same_scales}, outputs unequal {unequal} of {y.numel()}, max abs err "
            f"{err:.3e} (tol {'bit-equal' if name.startswith(W8A8_EXACT) else f'{W8A8_ROW_RTOL:.4g} x row max |y|'}), "
            f"max |y| {ref.float().abs().max().item():.3e}")
        if not ok:
            raise SystemExit(f"w8a8_matmul disagrees with its plain version on {name}")
        max_err = max(max_err, err)
        if chunk is None and not name.startswith("ragged"):
            rows.append((name, m, k, n, x, wk, ws, bias, xq, out_dtype))
        del y, ref, rq, rs
    for name, m, k, n, x, wk, ws, bias, xq, out_dtype in rows:
        ms = cuda_ms(lambda: w8a8.w8a8_matmul(x, wk, ws, bias, out_dtype=out_dtype, weight_layout="nk"))
        plain_ms = cuda_ms(lambda: w8a8.w8a8_matmul_reference(x, wk.t(), ws, bias, out_dtype=out_dtype),
                           reps=3, warmup=1)
        codes = xq[:, :k].contiguous()
        try:
            int_mm_ms = cuda_ms(lambda: torch._int_mm(codes, wk.t()))
        except RuntimeError as e:  # _int_mm takes M > 16 only
            int_mm_ms = None
            log(f"#   torch._int_mm refused {name}: {str(e).splitlines()[0][:100]}")
        wb = wk.t().to(torch.bfloat16)
        bf16_ms = cuda_ms(lambda: torch.matmul(x, wb))
        dev_ms = device_ms(lambda: w8a8.w8a8_matmul(x, wk, ws, bias, out_dtype=out_dtype, weight_layout="nk"))
        bf16_dev_ms = device_ms(lambda: torch.matmul(x, wb))
        out_bytes = out_dtype.itemsize
        bound, bytes_ms, by = w8a8_bound_ms(m, k, n, out_bytes)
        moved = w8a8_moved(m, k, n, out_bytes)
        log(f"# w8a8_matmul timing {name} (M {m} K {k} N {n}, {w8a8.plan(m, n, k).mode}): kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, torch._int_mm on the same codes (product only) "
            f"{'n/a' if int_mm_ms is None else f'{int_mm_ms:.4f} ms'}, bf16 torch.matmul {bf16_ms:.4f} ms "
            f"(kernel / bf16 {ms / bf16_ms:.3f}), bound {bound:.4f} ms by {by} ({2 * m * k * n / 1e12:.3f} T int8 "
            f"ops, bytes {bytes_ms:.4f} ms); kernel {2 * m * k * n / ms / 1e9:.1f} TOPS, {moved / ms / 1e6:.1f} GB/s; "
            f"device time per call (profiler, no host gaps): kernel {dev_ms:.4f} ms, bf16 {bf16_dev_ms:.4f} ms")
        if name in (W8A8_TIMED, W8A8_DECODE) + W8A8_MVLA + W8A8_SVLA + W8A8_MAGMA:
            timed[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, int_mm_ms=int_mm_ms,
                               bf16_ms=bf16_ms, device_ms=dev_ms, bf16_device_ms=bf16_dev_ms)
        del wb
    rows.clear()
    torch.cuda.empty_cache()
    w8a8.w8a8_matmul.launches = 0  # comparison launches do not count
    decode, mvla, svla = timed[W8A8_DECODE], {n: timed[n] for n in W8A8_MVLA}, {n: timed[n] for n in W8A8_SVLA}
    magma = {n: timed[n] for n in W8A8_MAGMA}
    timed = timed[W8A8_TIMED]
    return {
        "name": "w8a8_matmul",
        "route": "cuda",
        "source": "intact_tpu_torch/csrc/w8a8_matmul.cu",
        "replaces": "intact_tpu/ops/pallas_int8.py:81",
        "launches": None,
        "max_abs_err": max_err,
        "ms": timed["ms"],
        "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"],
        "bound_by": timed["bound_by"],
        # no single PyTorch call quantizes the activations, multiplies in int8
        # and rescales; the product alone and the bf16 product it replaces:
        "library_ms": None,
        "int_mm_product_only_ms": timed["int_mm_ms"],
        "bf16_matmul_ms": timed["bf16_ms"],
        "device_ms": timed["device_ms"],
        "shape": "Gemma-2B up projection, M 20992 K 2048 N 16384 (batch-64 prefill)",
        "fast_decode_shape": "Gemma-2B k projection of a Pi0FAST decode step, M 64 K 2048 N 256",
        **{f"fast_decode_{k}": decode[k] for k in ("ms", "plain_ms", "bound_ms", "bf16_ms", "device_ms")},
        **{f"{n}_{k}": mvla[n][k] for n in W8A8_MVLA for k in ("ms", "plain_ms", "bound_ms", "bf16_ms", "device_ms")},
        "svla_unembed_shape": "SpatialVLA-4B tied unembedding, M 64 (and 1) K 2304 N 259714, fp32 out",
        **{f"{n}_{k}": svla[n][k] for n in W8A8_SVLA
           for k in ("ms", "plain_ms", "bound_ms", "bf16_ms", "device_ms", "bf16_device_ms")},
        "magma_lm_head_shape": "Magma-8B untied lm_head, M 64 (and 1) K 4096 N 128256, bf16 out",
        **{f"{n}_{k}": magma[n][k] for n in W8A8_MAGMA
           for k in ("ms", "plain_ms", "bound_ms", "int_mm_ms", "bf16_ms", "device_ms", "bf16_device_ms")},
    }


# ---------------------------------------------------------------------------
# 3. full-width serving
# ---------------------------------------------------------------------------

def make_obs(rng: np.random.Generator, b: int, size: int) -> dict:
    tasks = ["put the spoon on the towel", "put carrot on plate",
             "stack the green block on the yellow block", "put eggplant into yellow basket"]
    return {
        "image": rng.integers(0, 256, size=(b, size, size, 3), dtype=np.uint8),
        "state": rng.standard_normal((b, 7), dtype=np.float32),
        "task": [tasks[i % len(tasks)] for i in range(b)],
    }


def phase_serving() -> int:
    """-> the kernel's launches on the main path."""
    from intact_tpu_torch.models.common import tree_leaves
    from intact_tpu_torch.models.pi0 import model as pi0
    from intact_tpu_torch.models.pi0.config import Pi0Config
    from intact_tpu_torch.models.pi0.policy import Pi0Policy
    from intact_tpu_torch.ops.flash_attention import flash_attention

    cfg = Pi0Config.bridge()
    per_inference = cfg.vlm.depth - 1  # kv_only prefill: depth-1 attention layers
    torch.cuda.reset_peak_memory_stats()  # the kernel phase's comparisons are not serving's
    t0 = time.perf_counter()
    policy = Pi0Policy(cfg, seed=0, tokenizer_path="hash", device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(policy.params))
    log(f"# serving: Pi0 bridge, {n_params / 1e9:.3f} B params bf16, init {time.perf_counter() - t0:.3f} s")

    rng = np.random.default_rng(1)
    size = cfg.vision.image_size
    obs1, obs64 = make_obs(rng, 1, size), make_obs(rng, 64, size)

    # --- the main path: a few requests as the server's handler makes them ---
    flash_attention.launches = 0
    inferences = 0

    def request(fn, *args):
        nonlocal inferences
        before = flash_attention.launches
        out = fn(*args)
        grew = flash_attention.launches - before
        if grew not in (0, per_inference):
            raise SystemExit(f"{grew} kernel launches in one request; expected 0 or {per_inference}")
        inferences += grew // per_inference
        return out

    actions = [request(policy.select_action, obs1) for _ in range(5)]  # infers on calls 1 and 5
    policy.reset()  # what the server does on {"reset": True}
    actions.append(request(policy.select_action, obs1))
    chunk64 = request(policy.sample_action_chunk, obs64)
    launches = flash_attention.launches
    # -------------------------------------------------------------------------

    if inferences != 4 or launches != per_inference * inferences:
        raise SystemExit(f"{launches} kernel launches over {inferences} inferences; expected {per_inference} each")
    for a in actions:
        if a.shape != (1, cfg.max_action_dim) or not np.isfinite(a).all():
            raise SystemExit(f"bad batch-1 action {a.shape}")
    if chunk64.shape != (64, cfg.chunk_size, cfg.max_action_dim) or not np.isfinite(chunk64).all():
        raise SystemExit(f"bad batch-64 chunk {chunk64.shape}")
    log(f"# serving: {inferences} inferences, {launches} flash_attention launches "
        f"({per_inference} per inference), actions finite, chunk {chunk64.shape}")

    # kernel path vs plain-attention path: same params, inputs and noise
    inputs = policy.device_inputs(obs64)
    gen = torch.Generator(device="cuda").manual_seed(2)
    noise = pi0.sample_noise(gen, (64, cfg.chunk_size, cfg.max_action_dim), "cuda")
    a_kernel = pi0.sample_actions(policy.params, None, *inputs, cfg, policy.policy, noise=noise)
    a_plain = pi0.sample_actions(policy.params, None, *inputs,
                                 dataclasses.replace(cfg, attention_impl="xla"), policy.policy, noise=noise)
    rel = ((a_kernel - a_plain).norm() / a_plain.norm()).item()
    diff = (a_kernel - a_plain).abs().max().item()
    log(f"# serving: kernel vs plain attention, batch 64 actions: rel L2 {rel:.3e} (rtol {ACTIONS_RTOL}), "
        f"max abs {diff:.3e}, max |a| {a_plain.abs().max().item():.3e}")
    if not rel <= ACTIONS_RTOL:
        raise SystemExit("actions from the kernel path disagree with the plain-attention path")

    for b, obs, reps in ((1, obs1, 5), (64, obs64, 3)):
        policy.sample_action_chunk(obs)  # warm
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            policy.sample_action_chunk(obs)  # ends in a device->host copy
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        log(f"# serving batch {b}: median inference {med * 1e3:.2f} ms over {reps} "
            f"({[round(x * 1e3, 2) for x in times]}), {b * cfg.n_action_steps / med:.2f} policy steps/s")
    log(f"# peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for b, obs in ((1, obs1), (64, obs64)):
        profile_pass(f"batch {b}", lambda: policy.sample_action_chunk(obs))
    return launches


KERNEL_SYMBOLS = ("attn_kernel", "fused_adam_rows_kernel", "quantize_kernel", "gemm_kernel", "finish_kernel")


def profile_pass(label: str, fn, in_order: str | None = None, annotation: str | None = None,
                 buckets: str | None = None):
    """Device busy share and the kernels that take the most device time in
    one call of fn (which ends in a sync), under torch.profiler (which adds
    host time of its own). -> {kernel name: (device ms, launches)} for the
    kernels of KERNEL_SYMBOLS; with `in_order`, also the device ms of each
    launch of the kernels whose name holds it, in launch order, and the
    device busy ms; with `annotation`, instead the device ms of the kernels
    that ran inside the device spans of the `record_function` ranges of that
    name, the number of spans, and the device busy ms (the spans themselves
    are not kernels: they count neither as busy time nor as launches). With
    `buckets` (the card's name and power limit), the same profile's layer
    bucket ranges are printed too (bucket_stats)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key != annotation and e.key not in BUCKET_RANGES]  # ranges' device spans are no kernels
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"# profile {label}: wall {wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
        f"({100 * busy_us / wall_us:.1f}%), {sum(e.count for e in kernels)} kernel launches")
    if buckets is not None:
        bucket_stats(prof, wall_us / 1e3, label, buckets)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    ours = [e for e in kernels if any(name in e.key for name in KERNEL_SYMBOLS) and e not in top]
    for e in top + ours:
        log(f"#   {e.self_device_time_total / 1e3:8.3f} ms {100 * e.self_device_time_total / busy_us:5.1f}% "
            f"x{e.count:<5d} {e.key[:90]}")
    totals = {}
    for e in kernels:
        for name in KERNEL_SYMBOLS:
            if name in e.key:
                ms, n = totals.get(name, (0.0, 0))
                totals[name] = (ms + e.self_device_time_total / 1e3, n + e.count)
    if annotation is not None:
        # the device spans of the ranges (CUDA events of the annotation's name), and the kernels inside them: on
        # one stream those are the kernels launched in the range, however they were launched (ctypes launches
        # are attributed to no CPU op)
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = [e.time_range for e in device if e.name == annotation]
        inside = [e for e in device if e.name != annotation
                  and any(s.start <= e.time_range.start and e.time_range.end <= s.end for s in spans)]
        return totals, sum(e.time_range.elapsed_us() for e in inside) / 1e3, len(spans), busy_us / 1e3
    if in_order is None:
        return totals
    launches = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                       and in_order in e.name), key=lambda e: e.time_range.start)
    return totals, [(e.time_range.end - e.time_range.start) / 1e3 for e in launches], busy_us / 1e3


# ---------------------------------------------------------------------------
# 3b. full-width int8 serving through the server role's wrapper
# ---------------------------------------------------------------------------

EV_CONFIG = "config/experiment/simpler/pi0_finetune_bridge_ev.yaml"
SERVING_SEED = 0  # the bf16 serving phase's weights, quantized


def ev_config(quantize: bool = True, path: str = EV_CONFIG, model_cfg: dict | None = None,
              overrides: dict | None = None):
    """The server role's config (by default config/experiment/simpler/pi0_finetune_bridge_ev.yaml)
    with int8 on (or off), random weights from the bf16 phase's seed (no
    checkpoint) and the hash tokenizer; `model_cfg` replaces the yaml's model
    JSON, `overrides` ({dotted.path: value}) go on top."""
    from intact_tpu_torch.config import TrainPipelineConfig, apply_overrides, from_dict, load_yaml

    overrides = {"eval_cfg.role": "server", "eval_cfg.quantize_int8": json.dumps(quantize),
                 "eval_cfg.pretrained_model_path": "null", "tokenizer_path": "hash", "seed": str(SERVING_SEED),
                 **(overrides or {})}
    d = load_yaml(path)
    if model_cfg is not None:
        d["model_cfg"] = dict(model_cfg)
    return from_dict(TrainPipelineConfig, apply_overrides(d, overrides))


def w8a8_per_inference(cfg) -> int:
    """W8A8 products of one inference: SigLIP 6 per layer, img_proj, the
    kv_only prefill's 7 per full layer and the last layer's k and v, and the
    expert's 7 per layer per Euler step."""
    return cfg.vision.depth * 6 + 1 + (cfg.vlm.depth - 1) * 7 + 2 + cfg.num_steps * cfg.expert.depth * 7


def wire_inputs(rng: np.random.Generator, b: int, size: int) -> list[dict]:
    """b single-row requests as Pi0Session.preprocess emits them: a resized
    uint8 frame, the normalized 7-d proprio, one task string."""
    obs = make_obs(rng, b, size)
    state = np.clip(obs["state"], -1.0, 1.0)
    return [{"image": obs["image"][i:i + 1], "state": state[i:i + 1], "task": [obs["task"][i]]} for i in range(b)]


def phase_int8_serving() -> dict:
    """-> {kernel: launches} on the int8 serving path."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.pi0 import model as pi0
    from intact_tpu_torch.ops import w8a8
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    cfg = ev_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wrapper = make_policy_wrapper(cfg, device=DEVICE)
    torch.cuda.synchronize()
    mc = wrapper.model_cfg
    leaves = cm.tree_leaves(wrapper.policy.params)
    n_int8 = sum(x.numel() for x in leaves if x.dtype == torch.int8)
    n_other = sum(x.numel() for x in leaves if x.dtype != torch.int8)
    per_inference = w8a8_per_inference(mc)
    flash_per = mc.vlm.depth - 1
    log(f"# int8 serving: Pi0PolicyWrapper from {EV_CONFIG} ({cfg.model_type}, quantize_int8 "
        f"{cfg.eval_cfg.quantize_int8}, seed {cfg.seed}), {n_int8 / 1e9:.3f} B int8 weights + "
        f"{n_other / 1e9:.3f} B bf16/fp32 values, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, "
        f"init {time.perf_counter() - t0:.2f} s (peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB); "
        f"expect {per_inference} w8a8_matmul and {flash_per} flash_attention launches per inference")

    rng = np.random.default_rng(1)
    size = mc.vision.image_size
    sessions = [wrapper.new_session() for _ in range(64)]
    req1, req64 = wire_inputs(rng, 1, size), wire_inputs(rng, 64, size)

    # --- the main path: fused requests through the wrapper, as the batching server calls it ---
    w8a8.w8a8_matmul.launches = flash_attention.launches = 0
    inferences = 0

    def fused(items):
        nonlocal inferences
        w0, f0 = w8a8.w8a8_matmul.launches, flash_attention.launches
        out = wrapper.infer_batch(items)
        dw, df = w8a8.w8a8_matmul.launches - w0, flash_attention.launches - f0
        if dw != per_inference or df != flash_per:
            raise SystemExit(f"one fused inference launched w8a8_matmul {dw} and flash_attention {df} times; "
                             f"expected {per_inference} and {flash_per}")
        inferences += 1
        return out

    out1 = [fused([(req1[0], sessions[0])]) for _ in range(2)]
    out64 = fused(list(zip(req64, sessions)))
    launches = {"w8a8_matmul": w8a8.w8a8_matmul.launches, "flash_attention": flash_attention.launches}
    # -------------------------------------------------------------------------------------------
    for a in [o[0] for o in out1] + out64:
        if isinstance(a, Exception) or a.shape != (cfg.eval_cfg.action_step, 7) or not np.isfinite(a).all():
            raise SystemExit(f"bad int8 serving result {a!r:.200}")
    log(f"# int8 serving: {inferences} fused inferences (batch 1, 1, 64), launches {launches} "
        f"({per_inference} w8a8_matmul and {flash_per} flash_attention each), 66 env actions of shape "
        f"{out64[0].shape}, finite")

    # kernel path vs plain path on the same int8 params, inputs and noise
    policy = wrapper.policy
    batch = {"image": np.concatenate([r["image"] for r in req64]),
             "state": np.concatenate([r["state"] for r in req64]), "task": [r["task"][0] for r in req64]}
    inputs = policy.device_inputs(batch)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    noise = pi0.sample_noise(gen, (64, mc.chunk_size, mc.max_action_dim), DEVICE)
    n0 = w8a8.w8a8_matmul.launches
    a_kernel = pi0.sample_actions(policy.params, None, *inputs, mc, policy.policy, noise=noise)
    n1 = w8a8.w8a8_matmul.launches
    real = w8a8.w8a8_matmul

    w8a8.w8a8_matmul = plain_w8a8  # the plain W8A8 product, for this comparison only
    try:
        a_w8a8_plain = pi0.sample_actions(policy.params, None, *inputs, mc, policy.policy, noise=noise)
        a_plain = pi0.sample_actions(policy.params, None, *inputs, dataclasses.replace(mc, attention_impl="xla"),
                                     policy.policy, noise=noise)
    finally:
        w8a8.w8a8_matmul = real
    if n1 - n0 != per_inference or w8a8.w8a8_matmul.launches != n1:
        raise SystemExit(f"the comparison's kernel run launched w8a8_matmul {n1 - n0} times and its plain runs "
                         f"{w8a8.w8a8_matmul.launches - n1}; expected {per_inference} and 0")
    rel = ((a_kernel - a_plain).norm() / a_plain.norm()).item()
    rel_w = ((a_kernel - a_w8a8_plain).norm() / a_w8a8_plain.norm()).item()
    same = torch.equal(a_kernel, a_w8a8_plain)
    log(f"# int8 serving: kernel path vs plain path (plain W8A8 product and plain attention), batch 64 "
        f"actions: rel L2 {rel:.3e} (rtol {ACTIONS_RTOL}), max abs {(a_kernel - a_plain).abs().max().item():.3e}; "
        f"with only the W8A8 product plain: rel L2 {rel_w:.3e}, bit-equal {same} (gate: bit-equal)")
    # the kernel's codes, scales and outputs equal the plain version's at every
    # bridge shape (phase 2), so swapping only the W8A8 product must leave the
    # actions bit for bit; a tolerance would pass a kernel that skipped the
    # quantization (int8 vs bf16 moves the actions by ~4e-2)
    if not same:
        raise SystemExit("int8 actions with the W8A8 kernel differ from those with its plain version")
    if not rel <= ACTIONS_RTOL:
        raise SystemExit("int8 actions from the kernel path disagree with the plain path")
    del a_plain, a_w8a8_plain
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    items1, items64 = [(req1[0], sessions[0])], list(zip(req64, sessions))
    for items in (items1, items64):
        wrapper.infer_batch(items)
    log(f"# int8 serving peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(one wrapper, batch 1 and 64)")

    # the same server role with quantize_int8 off: the same random weights in
    # bf16 behind the same wrapper, so both latencies include the fuse, the
    # uint8 upload and the adapters' postprocess
    bf16_wrapper = make_policy_wrapper(ev_config(quantize=False), device=DEVICE)
    bf16_sessions = [bf16_wrapper.new_session() for _ in range(64)]
    a_bf16 = pi0.sample_actions(bf16_wrapper.policy.params, None, *inputs, mc, bf16_wrapper.policy.policy,
                                noise=noise)
    mse = (a_kernel - a_bf16).square().mean().item()
    log(f"# int8 vs bf16 actions (same random weights, inputs and noise, batch 64): MSE {mse:.4e}, "
        f"rel L2 {((a_kernel - a_bf16).norm() / a_bf16.norm()).item():.3e}, mean |a_bf16|^2 "
        f"{a_bf16.square().mean().item():.4e} (no gate on random weights)")
    del a_bf16, inputs
    torch.cuda.empty_cache()

    # latency through infer_batch, int8 and bf16 wrappers alternating call by call
    runs = {"int8": (wrapper, sessions), "bf16": (bf16_wrapper, bf16_sessions)}
    time_wrappers("Pi0", runs, {1: req1, 64: req64}, mc.n_action_steps, {1: 5, 64: 3})
    del wrapper, policy, bf16_wrapper, runs
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 3c. serving in a one-rank group (serve/group.py), beside the wrapper without one
# ---------------------------------------------------------------------------

GROUP_SERVING = {True: (64, 4), False: (1, 4)}  # quantize_int8 -> (rows, timed inferences per wrapper)
GROUP_CALL_BROADCASTS = 7  # a header, image, img_masks, lang_tokens, lang_masks, state, the noise
GATHERED_REPS = 3  # timed inferences per wrapper on the gathered layout


def one_part(params, mesh, fsdp: int = 2):
    """The tree with every leaf that the rules split at `fsdp` held as a
    `Sharded` of one part over the world group: at world 1 each use gathers
    the whole leaf through the group (one bucket all-gather per layer, a
    contiguous copy of each leaf), and where it trains its gradient is
    reduce-scattered back (one bucket per layer): the path a rank takes at
    fsdp > 1."""
    from intact_tpu_torch.models.common import flatten_paths, unflatten_paths
    from intact_tpu_torch.parallel.mesh import Mesh
    from intact_tpu_torch.parallel.sharding import Sharded, spec_for_path

    rules = Mesh(1, fsdp, 1, 0, mesh.groups)
    out = {}
    for path, x in flatten_paths(params).items():
        spec = spec_for_path(path, x.shape, rules)
        out[path] = Sharded(x, spec.index("fsdp"), tuple(x.shape), mesh.groups["world"], 1) if "fsdp" in spec else x
    return unflatten_paths(out)


def split_prefixes(params, prefixes: tuple) -> dict:
    """{prefix: whether any `Sharded` leaf lies under it}, raising where a
    split leaf lies under none of them."""
    from intact_tpu_torch.models.common import flatten_paths
    from intact_tpu_torch.parallel.sharding import Sharded

    split = [k for k, v in flatten_paths(params).items() if isinstance(v, Sharded)]
    stray = [k for k in split if not k.startswith(prefixes)]
    if stray:
        raise SystemExit(f"gathered layout: split leaves outside {prefixes}: {stray}")
    return {p: any(k.startswith(p) for k in split) for p in prefixes}


def buckets_per_inference(params, cfg) -> int:
    """The bucket all-gathers of one Pi0 inference on a tree of Sharded
    leaves, one per layer that holds split leaves (cm.layer): SigLIP's and
    the VLM's once, the expert's once per Euler step; and one for the
    embedding's language lookup."""
    has = split_prefixes(params, ("siglip/blocks/", "vlm/blocks/", "expert/blocks/", "vlm_embed/"))
    return (has["siglip/blocks/"] * cfg.vision.depth + has["vlm/blocks/"] * cfg.vlm.depth
            + has["expert/blocks/"] * cfg.num_steps * cfg.expert.depth + has["vlm_embed/"])


BUCKET_RANGES = ("bucket gather", "bucket unpack", "bucket reduce-scatter")


def bucket_profile(label: str, fn, card: str) -> dict:
    """One call of fn (which ends in a sync) under torch.profiler -> {range:
    (calls, host ms, device ms)} for the layer buckets' record_function
    ranges (parallel/sharding.py): the host time spent inside each range and
    the device time of the kernels inside its device spans (NCCL's and the
    copies'), each printed per call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - t0) * 1e3
    return bucket_stats(prof, wall, label, card)


def bucket_stats(prof, wall: float, label: str, card: str) -> dict:
    """bucket_profile's numbers from a finished profile of `wall` ms."""
    import bisect

    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted(((e.time_range.start, e.time_range.end) for e in events
                      if e.device_type == cuda and e.name not in BUCKET_RANGES))
    starts = [k[0] for k in kernels]
    out = {}
    for name in BUCKET_RANGES:
        host = [e for e in events if e.name == name and e.device_type != cuda]
        dev_us = 0.0
        for span in (e.time_range for e in events if e.name == name and e.device_type == cuda):
            i = bisect.bisect_left(starts, span.start)
            while i < len(kernels) and kernels[i][0] <= span.end:
                dev_us += (kernels[i][1] - kernels[i][0]) if kernels[i][1] <= span.end else 0
                i += 1
        out[name] = (len(host), sum(e.time_range.elapsed_us() for e in host) / 1e3, dev_us / 1e3)
    parts = ", ".join(f"{name}: {n} calls, host {h:.2f} ms ({h / max(n, 1):.4f} ms per call), device {d:.2f} ms "
                      f"({d / max(n, 1):.4f} ms per call)" for name, (n, h, d) in out.items())
    log(f"# buckets {label} ({card}): wall {wall:.2f} ms under the profiler; {parts}")
    return out


def phase_multirank_serving() -> dict:
    """-> {kernel: launches} of the grouped wrappers' inferences. The script
    joins a one-rank NCCL group as torchrun would start it and builds the
    server role's wrapper as run.serve_on_ranks does (the yaml's mesh), beside
    the same wrapper without a group."""
    import os
    import socket

    from intact_tpu_torch.ops import w8a8
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.parallel import MeshConfig, collectives, distributed, make_mesh
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    card = gpu_name_and_power()
    host_staged_init()
    launch_env = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    saved_env = {k: os.environ.get(k) for k in launch_env}
    totals = {"flash_attention": 0, "w8a8_matmul": 0}
    try:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        t0 = time.perf_counter()
        device = distributed.initialize(DEVICE)
        log(f"# group serving: process group {distributed.backend()} of {distributed.process_count()} rank(s) on "
            f"{device}, joined in {time.perf_counter() - t0:.2f} s")
        if distributed.backend() != "nccl" or distributed.process_count() != 1:
            raise SystemExit(f"the card's process group is {distributed.backend()}, not a one-rank NCCL group")
        for quantize, (rows, reps) in GROUP_SERVING.items():
            cfg = ev_config(quantize)
            mesh = make_mesh(MeshConfig(cfg.mesh.data, cfg.mesh.fsdp, cfg.mesh.tensor))
            grouped = make_policy_wrapper(cfg, device=device, mesh=mesh)
            plain = make_policy_wrapper(ev_config(quantize), device=DEVICE)
            if grouped.group is None or plain.group is not None or grouped.effective_fused_size(rows) != rows:
                raise SystemExit(f"group serving: the wrappers' groups are {grouped.group} and {plain.group}")
            mc = grouped.model_cfg
            want = {"flash_attention": mc.vlm.depth - 1, "w8a8_matmul": w8a8_per_inference(mc) if quantize else 0}
            label = f"{'int8' if quantize else 'bf16'} batch {rows}"
            reqs = wire_inputs(np.random.default_rng(5), rows, mc.vision.image_size)
            calls = {name: [(r, w.new_session()) for r in reqs] for name, w in (("group", grouped), ("plain", plain))}
            # --- the main path: the grouped wrapper's fused inferences ---
            w8a8.w8a8_matmul.launches = flash_attention.launches = 0
            collectives.reset()
            out = grouped.infer_batch(calls["group"])
            torch.cuda.synchronize()
            got = {"flash_attention": flash_attention.launches, "w8a8_matmul": w8a8.w8a8_matmul.launches}
            coll = collectives.counts()
            # --------------------------------------------------------------
            for k in totals:
                totals[k] += got[k]
            ref = plain.infer_batch(calls["plain"])
            same = all(not isinstance(a, Exception) and np.array_equal(a, b) for a, b in zip(out, ref))
            log(f"# group serving {label}: launches {got} (expected {want}), collectives {coll} (expected "
                f"{GROUP_CALL_BROADCASTS} broadcasts and 1 all_gather), env actions bit-equal to the wrapper "
                f"without a group: {same}")
            if got != want or coll != {**dict.fromkeys(coll, 0), "broadcast": GROUP_CALL_BROADCASTS, "all_gather": 1}:
                raise SystemExit(f"group serving {label}: launches {got}, collectives {coll}")
            if not same or any(a.shape != (cfg.eval_cfg.action_step, 7) or not np.isfinite(a).all() for a in out):
                raise SystemExit(f"group serving {label}: env actions differ from the wrapper without a group")
            times = {"group": [], "plain": []}
            order = (("group", grouped), ("plain", plain))
            for i in range(reps):  # the wrappers alternating call by call, which goes first alternating too
                for name, w in (order if i % 2 == 0 else order[::-1]):
                    t = time.perf_counter()
                    w.infer_batch(calls[name])  # ends in a device->host copy and the adapters' postprocess
                    times[name].append(time.perf_counter() - t)
            med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
            log(f"# group serving {label} ({card}): median fused inference with the one-rank NCCL group "
                f"{med['group']:.2f} ms {[round(x * 1e3, 2) for x in times['group']]}, without a group "
                f"{med['plain']:.2f} ms {[round(x * 1e3, 2) for x in times['plain']]}, ratio "
                f"{med['group'] / med['plain']:.4f}")
            if quantize:  # where an inference's time goes, with and without the group
                for name, w in order:
                    profile_pass(f"group serving {label} {name}", lambda: w.infer_batch(calls[name]))
                for k, v in gathered_serving(grouped, plain, calls, mesh, label, want, card).items():
                    totals[k] += v
            grouped.group.stop()
            del grouped, plain, out, ref
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        distributed.destroy()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return totals


def gathered_serving(grouped, plain, calls: dict, mesh, label: str, want: dict, card: str) -> dict:
    """The grouped wrapper again with the rules' leaves as Sharded of one
    part (`one_part`): every layer, the embedding and the W8A8 products run
    on weights gathered through the group, bit-equal to the wrapper without
    a group, timed beside it and profiled -> the kernels' launches of its
    inference."""
    from intact_tpu_torch.ops import w8a8
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.parallel import collectives

    grouped.policy.params = one_part(grouped.policy.params, mesh)
    want_coll = {**dict.fromkeys(collectives.counts(), 0), "all_gather": 1,
                 "bucket_all_gather": buckets_per_inference(grouped.policy.params, grouped.model_cfg),
                 "broadcast": GROUP_CALL_BROADCASTS}
    # --- the main path: the grouped wrapper's fused inference on gathered weights ---
    w8a8.w8a8_matmul.launches = flash_attention.launches = 0
    collectives.reset()
    out = grouped.infer_batch(calls["group"])
    torch.cuda.synchronize()
    got = {"flash_attention": flash_attention.launches, "w8a8_matmul": w8a8.w8a8_matmul.launches}
    coll = collectives.counts()
    # --------------------------------------------------------------------------------
    ref = plain.infer_batch(calls["plain"])
    same = all(not isinstance(a, Exception) and np.array_equal(a, b) for a, b in zip(out, ref))
    log(f"# group serving {label} on gathered weights: launches {got} (expected {want}), collectives {coll} "
        f"(expected {want_coll}), env actions bit-equal to the wrapper without a group: {same}")
    if got != want or coll != want_coll or not same:
        raise SystemExit(f"group serving {label} on gathered weights: launches {got}, collectives {coll}, "
                         f"bit-equal {same}")
    times = {"gathered": [], "plain": []}
    order = (("gathered", grouped, "group"), ("plain", plain, "plain"))
    for i in range(GATHERED_REPS):
        for name, w, key in (order if i % 2 == 0 else order[::-1]):
            t = time.perf_counter()
            w.infer_batch(calls[key])
            times[name].append(time.perf_counter() - t)
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    log(f"# group serving {label} on gathered weights ({card}): median fused inference {med['gathered']:.2f} ms "
        f"{[round(x * 1e3, 2) for x in times['gathered']]}, without a group {med['plain']:.2f} ms "
        f"{[round(x * 1e3, 2) for x in times['plain']]}, ratio {med['gathered'] / med['plain']:.4f}")
    # where the gathers' time goes (the plain wrapper's profile is phase 3c's), in one profiled inference
    profile_pass(f"group serving {label} on gathered weights", lambda: grouped.infer_batch(calls["group"]),
                 buckets=card)
    return got


# ---------------------------------------------------------------------------
# 3d. tensor parallelism: two ranks on the one card (mesh 1 x 1 x 2)
# ---------------------------------------------------------------------------

TP_DIR = Path(".chip_smoke_tp")  # the phase's inputs and each rank's results (git-ignored), removed after it
TP_SERVING = ((True, 64), (True, 1), (False, 64), (False, 1))  # (quantize_int8, rows), in each wrapper's call order
TP_JOIN_S = 600.0  # the two ranks' limit, then the phase fails and kills them
# rel L2 of a rank's bf16 actions against the one-card wrapper's: the row-parallel products sum fp32 partials
# where one card rounds one GEMM (an fp32 ulp before the bf16 cast), carried through 17 layers and 10 Euler steps
TP_BF16_RTOL = 5e-2
# two expert-only micro-steps (accumulation 2) on the int8-frozen prefix, fp32 compute and plain attention (the
# attention kernel takes bf16 only), against the same steps without a group at tests/test_torch_distributed.py's
# tolerances: the expert-only recipe's AdamW there (eps 1e-3, no warmup: each update moves elements by ~lr)
TP_TRAIN_ROWS = 4
TP_TRAIN_OPT = dict(lr=1e-3, weight_decay=1e-4, warmup_steps=0, first_cycle_steps=100, max_grad_norm=0.5,
                    grad_accumulation_steps=2, eps=1e-3)
TP_LOSS_RTOL = 1e-4
TP_PARAMS_ATOL = 1e-4
TP_NORM_RTOL = 1e-4  # grad_norm (one batch coordinate: one card's) and param_norm of the fp32 micro-steps
# then two bf16 micro-steps (the recipe's compute dtype, fp32 masters) with the attention kernel on the ranks'
# local heads, from the state the fp32 update left: the ranks' row-parallel products sum fp32 partials of bf16
# operands where one card rounds one GEMM, so the loss and grad_norm move by ~1e-3 relative (tests' kernel-vs-plain
# tolerances: TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL)
TP_BF16_LOSS_RTOL = 2e-2
TP_BF16_GNORM_RTOL = 5e-2
# the row-parallel W8A8 entry's shapes, each rank's K / 2 slice at a batch-64 prefill: Gemma-2B's o and down (Pi0),
# Magma-8B's o and down (LLaMA-3, M 64 x 321) and SpatialVLA-4B's down (Gemma2, M 64 x 304)
TP_W8A8_SHAPES = (("gemma_o_half", 20992, 1024, 2048), ("gemma_down_half", 20992, 8192, 2048),
                  ("magma_o_half", 20544, 2048, 4096), ("magma_down_half", 20544, 7168, 4096),
                  ("svla_down_half", 19456, 4608, 2304),
                  # MVLA's expert down at batch 64 and 16 (M 51 suffix rows each, phase 3f)
                  ("mvla_expert_down_half", 3264, 2048, 1024), ("mvla_expert_down_half_b16", 816, 2048, 1024))
TP_FROZEN = ("siglip", "img_proj", "vlm", "vlm_embed")
# Pi0's layers on the ranks and their references (SigLIP 27, Gemma 18 and 18 before phase 3f joined the script's
# budget): the VLM and the expert run layer by layer together, so both take one depth; SigLIP's batch-64 partials
# are most of the ranks' host staging
TP_PI0_DEPTH = 4
TP_PI0_VISION_DEPTH = 4


@contextlib.contextmanager
def pi0_depth(depth: int = TP_PI0_DEPTH, vision: int = TP_PI0_VISION_DEPTH):
    """The pi0 type's config from its model JSON (pipeline.pi0_config_from_json)
    with both Gemma towers cut to `depth` layers and SigLIP to `vision`,
    restored on exit."""
    from intact_tpu_torch.config import pipeline

    real = pipeline.pi0_config_from_json

    def cut(d):
        cfg = real(d)
        return dataclasses.replace(cfg, vlm=dataclasses.replace(cfg.vlm, depth=depth),
                                   expert=dataclasses.replace(cfg.expert, depth=depth),
                                   vision=dataclasses.replace(cfg.vision, depth=vision))

    pipeline.pi0_config_from_json = cut
    try:
        yield
    finally:
        pipeline.pi0_config_from_json = real


def row_parallel_bound_ms(m: int, k: int, n: int) -> tuple[float, str, float, str]:
    """(bound ms, by) of w8a8_partial and of w8a8_finish on a K slice: the
    partial reads x (bf16), the codes and the row absmax and writes the int32
    partials and the row scales, 2*M*K*N int8 operations; the finish reads the
    partials, the scales, ws and the bias and writes bf16 y (bytes-bound)."""
    part_bytes = m * k * 2 + n * k + m * 4 + m * n * 4 + m * 4
    part_bytes_ms = part_bytes / H100_BYTES_PER_S * 1e3
    ops_ms = 2 * m * k * n / H100_INT8_OPS * 1e3
    fin_ms = (m * n * 4 + m * 4 + 2 * n * 4 + m * n * 2) / H100_BYTES_PER_S * 1e3
    return max(part_bytes_ms, ops_ms), "bytes" if part_bytes_ms >= ops_ms else "operations", fin_ms, "bytes"


def tp_kernel_checks(card: str) -> dict:
    """The row-parallel W8A8 entry at the K / 2 slices of TP_W8A8_SHAPES: each
    slice's int32 partials and row scales equal to the plain version's, the
    finish pass within one bf16 ulp of the row's max of its plain version,
    and the two slices' summed partials finished bit-equal to w8a8_matmul on
    the whole rows; times beside the bound, the plain versions and
    torch._int_mm on the same codes (the product alone). -> the kernels
    line's two entries (launches filled in by the phase)."""
    from intact_tpu_torch.ops import w8a8

    gen = torch.Generator(device="cuda").manual_seed(17)
    rows, max_err = {}, {"w8a8_partial": 0.0, "w8a8_finish": 0.0}
    for name, m, k, n in TP_W8A8_SHAPES:
        x, wq, ws, bias = w8a8_case(gen, m, 2 * k, n)
        halves = [slice(0, k), slice(k, 2 * k)]
        xs_, ws_ = [x[:, h].contiguous() for h in halves], [wq[:, h].contiguous() for h in halves]
        amax = torch.maximum(w8a8.row_absmax(xs_[0]), w8a8.row_absmax(xs_[1]))
        total = torch.zeros((m, n), dtype=torch.int32, device="cuda")
        p0, f0 = w8a8.w8a8_partial.launches, w8a8.w8a8_finish.launches
        equal = True
        for xh, wh in zip(xs_, ws_):
            part, xs = w8a8.w8a8_partial(xh, wh, amax, weight_layout="nk")
            rpart, rxs = w8a8.w8a8_partial_reference(xh, wh.t(), amax)
            equal &= torch.equal(part, rpart) and torch.equal(xs, rxs)
            total += part
            del rpart
        y = w8a8.w8a8_finish(total, xs, ws, bias, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        if (w8a8.w8a8_partial.launches - p0, w8a8.w8a8_finish.launches - f0) != (2, 1):
            raise SystemExit(f"the row-parallel W8A8 entry did not launch its kernels on {name}")
        ref = w8a8.w8a8_finish_reference(total, xs, ws, bias, torch.bfloat16)
        diff = (y.float() - ref.float()).abs()
        fin_ok = bool((diff <= W8A8_ROW_RTOL * ref.float().abs().amax(dim=1, keepdim=True)).all())
        one = w8a8.w8a8_matmul(x, wq, ws, bias, out_dtype=torch.bfloat16, weight_layout="nk")
        same = torch.equal(y, one)
        max_err["w8a8_finish"] = max(max_err["w8a8_finish"], diff.max().item())
        log(f"# row-parallel w8a8 {name} (M {m} K {k} of {2 * k} N {n}, {w8a8.partial_plan(m, n, k)}): partials and "
            f"row scales equal to the plain version {equal}, finish max abs err {diff.max().item():.3e} (tol "
            f"{W8A8_ROW_RTOL:.4g} x row max |y|), two slices finished bit-equal to w8a8_matmul on the whole "
            f"rows {same}")
        if not (equal and fin_ok and same and bool(torch.isfinite(y).all())):
            raise SystemExit(f"the row-parallel W8A8 entry disagrees with its plain version or one card's on {name}")
        xh, wh = xs_[0], ws_[0]
        ms = cuda_ms(lambda: w8a8.w8a8_partial(xh, wh, amax, weight_layout="nk"))
        plain_ms = cuda_ms(lambda: w8a8.w8a8_partial_reference(xh, wh.t(), amax), reps=3, warmup=1)
        fin_ms = cuda_ms(lambda: w8a8.w8a8_finish(total, xs, ws, bias, out_dtype=torch.bfloat16))
        fin_plain_ms = cuda_ms(lambda: w8a8.w8a8_finish_reference(total, xs, ws, bias, torch.bfloat16), reps=3,
                               warmup=1)
        codes = torch.round(xh.float() / xs[:, None]).to(torch.int8)
        int_mm_ms = cuda_ms(lambda: torch._int_mm(codes, wh.t()))
        whole_ms = cuda_ms(lambda: w8a8.w8a8_matmul(x, wq, ws, bias, out_dtype=torch.bfloat16, weight_layout="nk"))
        wb = wh.t().to(torch.bfloat16)
        bf16_ms = cuda_ms(lambda: torch.matmul(xh, wb))  # the bf16 product of the same slice, as bf16 serving runs it
        bound, by, fin_bound, fin_by = row_parallel_bound_ms(m, k, n)
        log(f"# row-parallel w8a8 timing {name} ({card}): w8a8_partial {ms:.4f} ms (plain {plain_ms:.4f} ms, "
            f"torch._int_mm on the same codes {int_mm_ms:.4f} ms, the slice's bf16 torch.matmul {bf16_ms:.4f} ms, "
            f"bound {bound:.4f} ms by {by}), w8a8_finish "
            f"{fin_ms:.4f} ms (plain {fin_plain_ms:.4f} ms, bound {fin_bound:.4f} ms by {fin_by}); one card's "
            f"w8a8_matmul on the whole K {whole_ms:.4f} ms")
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, int_mm_ms=int_mm_ms, bf16_ms=bf16_ms,
                          fin_ms=fin_ms, fin_plain_ms=fin_plain_ms, fin_bound_ms=fin_bound, whole_ms=whole_ms)
        del x, wq, xs_, ws_, total, y, ref, one, codes, wb
        torch.cuda.empty_cache()
    w8a8.w8a8_partial.launches = w8a8.w8a8_finish.launches = 0  # comparison launches do not count
    main = rows["gemma_down_half"]
    extra = {f"{name}_{k}": v for name, r in rows.items() for k, v in r.items() if k != "bound_by"}
    partial = {"name": "w8a8_partial", "route": "cuda", "source": "intact_tpu_torch/csrc/w8a8_matmul.cu",
               "replaces": "intact_tpu/ops/pallas_int8.py:81", "launches": None, "max_abs_err": 0.0,
               "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
               "bound_by": main["bound_by"],
               # no single PyTorch call quantizes against a given row scale and multiplies in int8
               "library_ms": None, "int_mm_product_only_ms": main["int_mm_ms"],
               "shape": "Gemma-2B down at a batch-64 prefill, one tensor rank's K / 2: M 20992 K 8192 N 2048", **extra}
    finish = {"name": "w8a8_finish", "route": "cuda", "source": "intact_tpu_torch/csrc/w8a8_matmul.cu",
              "replaces": "intact_tpu/ops/pallas_int8.py:81", "launches": None,
              "max_abs_err": max_err["w8a8_finish"], "ms": main["fin_ms"], "plain_ms": main["fin_plain_ms"],
              "bound_ms": main["fin_bound_ms"], "bound_by": "bytes", "library_ms": None,
              "shape": "the summed int32 partials of Gemma-2B's down at a batch-64 prefill: M 20992 N 2048"}
    return {"w8a8_partial": partial, "w8a8_finish": finish}


def tp_decode_attention_cost(card: str) -> None:
    """What the decode attention's zero heads cost: a tensor rank runs its
    H / t query heads among zero ones at one card's shapes
    (parallel/tensor.py::whole_groups), so its plain attention does one
    card's work where its own heads are H / t of it. Times the expert's
    split-cache attention at Pi0's serving shapes on all 8 heads (what a rank
    runs at t = 2) and on the rank's 4 alone."""
    from intact_tpu_torch.ops.attention import xla_attention_cached

    mc = ev_config(False).make_model_config()
    cfg, p_len, s_len = mc.expert, mc.prefix_len, mc.suffix_len
    gen = torch.Generator(device="cuda").manual_seed(23)
    for b in (64, 1):
        k_cache, v_cache = (torch.randn(b, p_len, 1, cfg.head_dim, generator=gen, device="cuda").to(torch.bfloat16)
                            for _ in range(2))
        k_new, v_new = (torch.randn(b, s_len, 1, cfg.head_dim, generator=gen, device="cuda").to(torch.bfloat16)
                        for _ in range(2))
        masks = (torch.ones(b, s_len, p_len, dtype=torch.bool, device="cuda"),
                 torch.ones(b, s_len, s_len, dtype=torch.bool, device="cuda"))
        wall, dev = {}, {}
        for heads in (cfg.num_heads, cfg.num_heads // 2):
            q = torch.randn(b, s_len, heads, cfg.head_dim, generator=gen, device="cuda").to(torch.bfloat16)
            call = lambda q=q: xla_attention_cached(q, k_cache, v_cache, k_new, v_new, *masks,  # noqa: E731
                                                    scale=cfg.head_dim**-0.5)
            wall[heads], dev[heads] = cuda_ms(call), device_ms(call, reps=20)
        full, half = cfg.num_heads, cfg.num_heads // 2
        per_inference = cfg.depth * mc.num_steps
        log(f"# tensor parallel decode attention ({card}), batch {b}, {s_len} query rows over {p_len} + {s_len} keys, "
            f"per layer: {full} heads (a rank's {half} among zero ones, as it runs) {wall[full]:.4f} ms of wall, "
            f"{dev[full]:.4f} ms of device; {half} heads alone {wall[half]:.4f} / {dev[half]:.4f} ms; the zero heads "
            f"x {cfg.depth} layers x {mc.num_steps} steps: {(dev[full] - dev[half]) * per_inference:.3f} ms of device "
            f"time per inference ({(wall[full] - wall[half]) * per_inference:.2f} ms of wall, host-bound)")


def tp_batch(rng: np.random.Generator, rows: int, size: int) -> dict:
    """One fused device batch as Pi0PolicyWrapper.sample_action_chunk takes it."""
    obs = make_obs(rng, rows, size)
    return {"image": obs["image"], "state": np.clip(obs["state"], -1.0, 1.0), "task": list(obs["task"])}


def tp_expert_steps(device, mesh, inputs: dict, heads: list, cfg=None) -> dict:
    """Two expert-only micro-steps (one update) at full width in fp32 with
    the plain attention, then two in bf16 with the attention kernel (its
    query heads recorded into `heads`): on the tensor ranks, and on rank 0
    without a group on the same weights, rows and draws. Pi0 (the ev yaml's
    config) on its int8-frozen prefix, or the model config `cfg` (MVLA) on
    its float frozen tower, as the trainer keeps it. -> the ranks' losses
    and norms and, on rank 0, one card's and whether the gathered params
    after the fp32 update are within TP_PARAMS_ATOL, with the launches of
    the bf16 micro-steps."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models import registry
    from intact_tpu_torch.ops import w8a8
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.parallel.mesh import single_rank_mesh
    from intact_tpu_torch.parallel.sharding import Sharded, gather_leaf, shard_tree
    from intact_tpu_torch.train.optim import OptimizerConfig, make_optimizer
    from intact_tpu_torch.train.train_step import init_train_state, make_train_step

    frozen_int8 = cfg is None  # the trainer's quantize_frozen_int8 is sound for Pi0 only
    base = dataclasses.replace(cfg or ev_config(False).make_model_config(), train_expert_only=True)
    model = registry.module_for_config(base)
    batches = [{k: v.to(device) for k, v in b.items()} for b in inputs["train_batches"]]
    out = {}
    for name, group in (("tensor", mesh), ("one", None)):
        if name == "one" and mesh.rank != 0:
            break
        mc = dataclasses.replace(base, attention_impl="xla")
        params = model.init(mc, inputs["train_seed"], device, torch.float32)
        mask = {k: cm.tree_map(lambda _, t=k not in TP_FROZEN: t, v) for k, v in params.items()}
        if frozen_int8:
            params = cm.quantize_frozen(params, mask)
            mask = {k: cm.tree_map(lambda _, t=k not in TP_FROZEN: t, v) for k, v in params.items()}
        if group is not None:
            params = shard_tree(params, mesh, consume=True, heads=model.tensor_heads(mc))
        tx, _ = make_optimizer(OptimizerConfig(**TP_TRAIN_OPT), mask, mesh=mesh if group is not None else
                               single_rank_mesh())
        state = init_train_state(params, tx, seed=0)
        res = {"losses": [], "norms": [], "partial": sorted(tx.partial)}
        for precision, impl, policy in (("fp32", "xla", cm.FP32_POLICY), ("bf16", "pallas", cm.DEFAULT_POLICY)):
            mc = dataclasses.replace(base, attention_impl=impl)
            step = make_train_step(lambda p, r, b, n, t, mc=mc, policy=policy: model.compute_loss(
                p, r, b, mc, policy, noise=n, time=t), tx)
            heads.clear()
            before = (flash_attention.launches, w8a8.w8a8_matmul.launches, w8a8.w8a8_partial.launches,
                      w8a8.w8a8_finish.launches)
            for i, b in enumerate(batches):
                state, metrics = step(state, b, noise=inputs["train_noise"][i].to(device),
                                      time=inputs["train_time"][i].to(device))
                res["losses"].append(metrics["l2_loss"].item())
                res["norms"].append([metrics["grad_norm"].item(), metrics["param_norm"].item()])
            torch.cuda.synchronize()
            res[f"launches_{precision}"] = [a - b for a, b in zip(
                (flash_attention.launches, w8a8.w8a8_matmul.launches, w8a8.w8a8_partial.launches,
                 w8a8.w8a8_finish.launches), before)]
            res[f"heads_{precision}"] = sorted(set(heads))
            if precision == "fp32":  # every rank joins the gathers; rank 0 keeps the leaves
                flat = {k: (gather_leaf(v.local, v) if isinstance(v, Sharded) else v) for k, v in
                        cm.flatten_paths(state.params).items()}
                if mesh.rank == 0:
                    res["params"] = {k: v.detach().to("cpu", torch.float32, copy=True) for k, v in flat.items()
                                     if k in tx.trainable}  # a copy: the bf16 steps update the leaves in place
                    res["codes"] = {k: v.cpu() for k, v in flat.items() if k.endswith("kernel_q")}
                del flat
        out[name] = res
        del params, state, tx, step
        gc.collect()
        torch.cuda.empty_cache()
    tp = out["tensor"]
    result = {k: tp[k] for k in ("losses", "norms", "partial", "launches_fp32", "launches_bf16", "heads_fp32",
                                 "heads_bf16")}
    if mesh.rank == 0:
        one = out["one"]
        diff = max((one["params"][k] - tp["params"][k]).abs().max().item() for k in one["params"])
        codes_equal = all(torch.equal(one["codes"][k], tp["codes"][k]) for k in one["codes"])
        result.update(one_losses=one["losses"], one_norms=one["norms"], one_launches=one["launches_fp32"],
                      one_launches_bf16=one["launches_bf16"], params_max_abs=diff, codes_equal=codes_equal,
                      n_trainable=len(one["params"]))
    return result


@pi0_depth()
def tp_rank(rank: int, world: int, port: int, workdir: str) -> None:
    """One of the phase's two ranks: a gloo group over the card's tensors
    (NCCL refuses two ranks of one device), mesh (1, 1, 2); the server role's
    int8 and bf16 wrappers (rank 0 serves TP_SERVING, rank 1 follows), then
    the expert-only micro-steps. Writes workdir/rank{r}.pt."""
    import os

    from intact_tpu_torch.ops import attention, w8a8
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.parallel import MeshConfig, collectives, distributed, make_mesh
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    workdir = Path(workdir)
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    device = distributed.initialize(DEVICE, backend="gloo")
    mesh = make_mesh(MeshConfig(1, 1, world))
    heads: list = []
    real_flash = attention.flash_attention

    def counted_flash(q, *args, **kw):  # the query heads of every launch on the path
        heads.append(q.shape[2])
        return real_flash(q, *args, **kw)

    attention.flash_attention = counted_flash
    result = {"backend": distributed.backend(), "mesh": mesh.shape, "serving": []}
    try:
        for quantize in (True, False):
            wrapper = make_policy_wrapper(ev_config(quantize), device=device, mesh=mesh)
            policy = wrapper.policy
            real_rows = policy._sample_rows
            calls = []

            def rows(*arrays, real_rows=real_rows, calls=calls):  # the rows' arrays, then the noise
                heads.clear()
                before = (flash_attention.launches, w8a8.w8a8_matmul.launches, w8a8.w8a8_partial.launches,
                          w8a8.w8a8_finish.launches)
                c0 = collectives.counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = real_rows(*arrays)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t
                after = (flash_attention.launches, w8a8.w8a8_matmul.launches, w8a8.w8a8_partial.launches,
                         w8a8.w8a8_finish.launches)
                calls.append({"out": out.float().cpu(), "seconds": seconds, "heads": sorted(set(heads)),
                              "launches": dict(zip(("flash_attention", "w8a8_matmul", "w8a8_partial", "w8a8_finish"),
                                                   (a - b for a, b in zip(after, before)))),
                              "collectives": {k: v - c0[k] for k, v in collectives.counts().items() if v - c0[k]},
                              "staged": collectives.staged_calls()})
                return out

            policy._sample_rows = rows
            wrapper.group.on("sample", rows)
            if rank == 0:
                walls = []
                for q, n in TP_SERVING:
                    if q != quantize:
                        continue
                    t = time.perf_counter()
                    wrapper.sample_action_chunk(inputs["batches"][n])
                    walls.append(time.perf_counter() - t)
                wrapper.group.stop()
            else:
                walls = []
                wrapper.group.follow()
            result["serving"].append({"quantize": quantize, "calls": calls, "walls": walls,
                                      "split": sum(1 for _ in _tensor_split(policy.params))})
            del wrapper, policy, real_rows
            gc.collect()
            torch.cuda.empty_cache()
        collectives.reset()
        result["train"] = tp_expert_steps(device, mesh, inputs, heads)
        result["train"]["collectives"] = collectives.counts()
        result["train"]["staged"] = collectives.staged_calls()
        result["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        attention.flash_attention = real_flash
        torch.save(result, workdir / f"rank{rank}.pt")
        distributed.destroy()


def _tensor_split(params):
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.parallel.sharding import Sharded

    return (k for k, v in cm.flatten_paths(params).items() if isinstance(v, Sharded) and v.tensor is not None)


@pi0_depth()
def phase_tensor_parallel() -> tuple[dict, dict]:
    """-> ({kernel: launches} on the two ranks' serving and training, summed
    over the ranks; the kernels line's entries of the row-parallel W8A8
    entry). The one-card references (the server role's int8 and bf16
    wrappers without a group, as phase 3b builds them, at TP_PI0_DEPTH) run
    here first; the two ranks then run in processes of their own on the same
    card."""
    import shutil
    import socket

    import torch.multiprocessing as mp

    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    card = gpu_name_and_power()
    kernels = tp_kernel_checks(card)
    tp_decode_attention_cost(card)
    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    refs, batches = {}, {}
    try:
        for quantize in (True, False):
            wrapper = make_policy_wrapper(ev_config(quantize), device=DEVICE)
            size = wrapper.model_cfg.vision.image_size
            for q, n in TP_SERVING:
                if q != quantize:
                    continue
                batches.setdefault(n, tp_batch(np.random.default_rng(20 + n), n, size))
                t = time.perf_counter()
                refs[(q, n)] = torch.from_numpy(wrapper.sample_action_chunk(batches[n]))
                log(f"# tensor parallel: one-card reference {'int8' if q else 'bf16'} batch {n}: "
                    f"{(time.perf_counter() - t) * 1e3:.2f} ms")
            del wrapper
            gc.collect()
            torch.cuda.empty_cache()
        mc = ev_config(False).make_model_config()
        rng = np.random.default_rng(31)
        train_batches = [{k: torch.from_numpy(np.asarray(v)) for k, v in
                          make_train_batch(rng, mc, TP_TRAIN_ROWS).items()} for _ in range(2)]
        torch.save({"batches": batches, "train_batches": train_batches, "train_seed": 5,
                    "train_noise": [torch.from_numpy(rng.standard_normal((TP_TRAIN_ROWS, mc.chunk_size,
                                                                          mc.max_action_dim), dtype=np.float32))
                                    for _ in range(2)],
                    "train_time": [torch.from_numpy(rng.uniform(0.1, 0.9, TP_TRAIN_ROWS).astype(np.float32))
                                   for _ in range(2)]}, TP_DIR / "inputs.pt")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        ctx = mp.start_processes(tp_rank, args=(2, port, str(TP_DIR)), nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + TP_JOIN_S
        while not ctx.join(timeout=max(0.5, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                raise SystemExit(f"the tensor-parallel ranks did not finish within {TP_JOIN_S:.0f} s")
        log(f"# tensor parallel: the two ranks ran in {time.perf_counter() - t0:.1f} s")
        ranks = [torch.load(TP_DIR / f"rank{r}.pt", weights_only=False) for r in range(2)]
    finally:
        shutil.rmtree(TP_DIR, ignore_errors=True)
    return tp_gates(ranks, refs, mc, card), kernels


def make_train_batch(rng: np.random.Generator, mc, rows: int) -> dict:
    """A training batch at the model's shapes: [-1, 1] frames, the first
    eight language tokens live, state and actions."""
    s, n = mc.vision.image_size, mc.tokenizer_max_length
    lang_masks = np.zeros((rows, n), bool)
    lang_masks[:, :8] = True
    return {"images": rng.uniform(-1, 1, (rows, mc.num_cameras, s, s, 3)).astype(np.float32),
            "img_masks": np.ones((rows, mc.num_cameras), bool),
            "lang_tokens": rng.integers(0, 256, (rows, n)).astype(np.int32), "lang_masks": lang_masks,
            "state": rng.standard_normal((rows, mc.max_state_dim), dtype=np.float32),
            "actions": rng.standard_normal((rows, mc.chunk_size, mc.max_action_dim), dtype=np.float32)}


def tp_gates(ranks: list, refs: dict, mc, card: str) -> dict:
    """The phase's gates over the two ranks' results -> the path's launches."""
    row_products = 2 * mc.vision.depth + 2 * (mc.vlm.depth - 1) + 2 * mc.num_steps * mc.expert.depth
    local_heads = mc.vlm.num_heads // 2
    totals = dict.fromkeys(("flash_attention", "w8a8_matmul", "w8a8_partial", "w8a8_finish"), 0)
    for r, res in enumerate(ranks):
        if res["backend"] != "gloo" or res["mesh"] != {"data": 1, "fsdp": 1, "tensor": 2}:
            raise SystemExit(f"tensor parallel rank {r}: group {res['backend']} mesh {res['mesh']}")
        for serving in res["serving"]:
            q = serving["quantize"]
            want = {"flash_attention": mc.vlm.depth - 1,
                    "w8a8_matmul": w8a8_per_inference(mc) - row_products if q else 0,
                    "w8a8_partial": row_products if q else 0, "w8a8_finish": row_products if q else 0}
            sizes = [n for qq, n in TP_SERVING if qq == q]
            if len(serving["calls"]) != len(sizes):
                raise SystemExit(f"tensor parallel rank {r}: {len(serving['calls'])} inferences, not {len(sizes)}")
            for call, n in zip(serving["calls"], sizes):
                ref = refs[(q, n)]
                got = call["out"]
                label = f"rank {r} {'int8' if q else 'bf16'} batch {n}"
                rel = ((got - ref).norm() / ref.norm()).item()
                same = torch.equal(got, ref)
                log(f"# tensor parallel {label} ({card}): {call['seconds'] * 1e3:.2f} ms on the rank, launches "
                    f"{call['launches']} (expected {want}), attention on {call['heads']} local heads (expected "
                    f"[{local_heads}]), collectives {call['collectives']} ({call['staged']} staged through the host "
                    f"so far), actions vs the one-card wrapper: bit-equal {same}, rel L2 {rel:.3e}, max abs "
                    f"{(got - ref).abs().max().item():.3e}")
                for k in totals:
                    totals[k] += call["launches"][k]
                ok = call["launches"] == want and call["heads"] == [local_heads] and bool(torch.isfinite(got).all())
                ok = ok and (same if q else rel <= TP_BF16_RTOL) and got.shape == ref.shape
                if not ok:
                    raise SystemExit(f"tensor parallel {label}: the gates failed")
        if r == 0:
            for serving in res["serving"]:
                log(f"# tensor parallel rank 0 {'int8' if serving['quantize'] else 'bf16'} walls through "
                    f"sample_action_chunk (broadcasts, the rank's rows, the actions' gather): "
                    f"{[round(w * 1e3, 2) for w in serving['walls']]} ms for batches "
                    f"{[n for q, n in TP_SERVING if q == serving['quantize']]}; {serving['split']} leaves held as "
                    f"tensor slices")
        train = res["train"]
        log(f"# tensor parallel rank {r} expert-only micro-steps (2 fp32 with the plain attention, then 2 bf16 with "
            f"the kernel): losses {train['losses']}, [grad_norm, param_norm] {train['norms']}, launches "
            f"(flash_attention, w8a8_matmul, w8a8_partial, w8a8_finish) fp32 {train['launches_fp32']} bf16 "
            f"{train['launches_bf16']}, the kernel on {train['heads_bf16']} local heads (expected [{local_heads}]), "
            f"collectives { {k: v for k, v in train['collectives'].items() if v} } ({train['staged']} staged), K/V "
            f"and biases summed over tensor {train['partial']}, peak {res['peak_gib']:.2f} GiB")
        for launches in (train["launches_fp32"], train["launches_bf16"]):
            for k, n in zip(("flash_attention", "w8a8_matmul", "w8a8_partial", "w8a8_finish"), launches):
                totals[k] += n
        ok = train["launches_fp32"][0] == 0 and train["launches_bf16"][0] == 2 * (mc.vlm.depth - 1)
        ok = ok and train["launches_fp32"][2] > 0 and train["launches_bf16"][2] > 0
        ok = ok and train["heads_bf16"] == [local_heads] and bool(np.isfinite(train["losses"] + sum(train["norms"], [])).all())
        if not ok:
            raise SystemExit(f"tensor parallel rank {r}: the expert-only micro-steps failed")
    tp_steps_against_one_card(ranks, "tensor parallel")
    return totals


def tp_steps_against_one_card(ranks: list, label: str) -> None:
    """The gates of the ranks' expert-only micro-steps (tp_expert_steps)
    against the same steps on one card without a group: the fp32 losses
    and norms within TP_LOSS_RTOL / TP_NORM_RTOL and the params after the
    update within TP_PARAMS_ATOL (the int8 codes, where the tower is int8,
    equal); the bf16 ones within TP_BF16_LOSS_RTOL / TP_BF16_GNORM_RTOL; the
    two ranks' losses equal."""
    lead = ranks[0]["train"]
    got, one = np.array(lead["norms"]), np.array(lead["one_norms"])
    loss_ok = np.allclose(lead["losses"][:2], lead["one_losses"][:2], rtol=TP_LOSS_RTOL, atol=0)
    norms_ok = np.allclose(got[:2], one[:2], rtol=TP_NORM_RTOL, atol=0)
    bf16_ok = np.allclose(lead["losses"][2:], lead["one_losses"][2:], rtol=TP_BF16_LOSS_RTOL, atol=0)
    bf16_ok = bf16_ok and np.allclose(got[2:], one[2:], rtol=TP_BF16_GNORM_RTOL, atol=0)
    log(f"# {label} expert-only against one card without a group: fp32 losses {lead['one_losses'][:2]} "
        f"(rtol {TP_LOSS_RTOL}: {loss_ok}), [grad_norm, param_norm] {lead['one_norms'][:2]} (rtol {TP_NORM_RTOL}: "
        f"{norms_ok}; max rel {np.abs(got[:2] / one[:2] - 1).max():.3e}), {lead['n_trainable']} trainable leaves max abs "
        f"diff {lead['params_max_abs']:.3e} (atol {TP_PARAMS_ATOL}), int8 codes equal {lead['codes_equal']}; bf16 "
        f"with the kernel losses {lead['one_losses'][2:]} (max rel "
        f"{np.abs(np.array(lead['losses'][2:]) / np.array(lead['one_losses'][2:]) - 1).max():.3e}, rtol "
        f"{TP_BF16_LOSS_RTOL}), norms {lead['one_norms'][2:]} (max rel {np.abs(got[2:] / one[2:] - 1).max():.3e}, "
        f"rtol {TP_BF16_GNORM_RTOL}): {bf16_ok}; one card's launches fp32 {lead['one_launches']} bf16 "
        f"{lead['one_launches_bf16']}")
    if not (loss_ok and norms_ok and bf16_ok and lead["params_max_abs"] <= TP_PARAMS_ATOL and lead["codes_equal"]):
        raise SystemExit(f"{label}: the expert-only micro-steps disagree with one card's")
    if ranks[1]["train"]["losses"] != lead["losses"]:
        raise SystemExit(f"{label}: the two ranks' losses differ")


# ---------------------------------------------------------------------------
# 3e. the tensor axis for the token-decoding families (two ranks on one card)
# ---------------------------------------------------------------------------

TPA_DIR = Path(".chip_smoke_tp_ar")  # the phase's inputs and each rank's results (git-ignored), removed after it
TPA_ROWS = (1, 16)  # rows of each fused device call: 16 bound the host staging of the row-parallel partials
TPA_JOIN_S = 900.0  # the two ranks' limit, then the phase fails and kills them
# bf16 on the ranks against one card: the row-parallel products sum fp32 partials where one card rounds one GEMM,
# so a greedy token may flip where two logits lie within that rounding. Held as phases 6, 10 and 11 hold the
# attention kernel: one card's logits teacher-forced with the ranks' tokens, each rank token's logit within
# TPA_MARGIN standard deviations of the step's maximum; the agreement is reported
TPA_MARGIN = 0.1
TPA_OPS = {"pi0fast": "sample", "spatialvla": "predict", "magma": "generate"}  # each wrapper's serving-group op


def tpa_config(family: str, quantize: bool):
    """The server role's config of a family, from its ev yaml."""
    if family == "pi0fast":
        return ev_config(quantize, path=FAST_EV_CONFIG)
    return svla_config(quantize) if family == "spatialvla" else magma_config(quantize)


class cut_depths:
    """Registry types' default configs with a tower cut to a depth, as
    ((type, tower, depth), ...), or with top-level fields replaced, as
    (type, None, {field: value}), restored on exit: the script's full-width
    models at the depths its time limit allows."""

    def __init__(self, *cuts):
        self.cuts = cuts

    def __enter__(self):
        from intact_tpu_torch.models import registry

        self.saved = {}
        for name, tower, depth in self.cuts:
            entry = registry.get(name)
            full = entry["default_config"]  # a second cut of a type applies over the first
            self.saved.setdefault(name, full)
            entry["default_config"] = lambda full=full, tower=tower, depth=depth: dataclasses.replace(
                full(), **({tower: dataclasses.replace(getattr(full(), tower), depth=depth)} if tower else depth))
        return self

    def __exit__(self, *exc):
        from intact_tpu_torch.models import registry

        for name, full in self.saved.items():
            registry.get(name)["default_config"] = full


def served_depths() -> cut_depths:
    """Pi0FAST, SpatialVLA and Magma at the depths the script serves them."""
    return cut_depths(("pi0fast", "vlm", FAST_SERVING_DEPTH), ("spatialvla_native", "lm", SVLA_SERVING_DEPTH),
                      ("magma_native", "lm", MAGMA_SERVING_DEPTH))


def tpa_request(family: str, mc, rng: np.random.Generator, rows: int) -> dict:
    """One fused device call's host arrays for the model config `mc`, as the
    family's sessions emit them."""
    if family == "pi0fast":
        return {"batch": fast_request(rng, rows, mc.vision.image_size)}
    reqs = svla_requests(rng, mc, rows) if family == "spatialvla" else magma_requests(rng, mc, rows)
    return {"reqs": reqs}


def tpa_call(family: str, wrapper, request: dict) -> np.ndarray:
    """The wrapper's fused device call -> its greedy tokens [B, T] (Pi0FAST's
    bin-center actions mapped back to their tokens)."""
    if family == "pi0fast":
        return fast_tokens(wrapper.sample_action_chunk(request["batch"]), wrapper.model_cfg)
    reqs = request["reqs"]
    images, tasks = np.concatenate([r["image"] for r in reqs]), [r["task"][0] for r in reqs]
    if family == "spatialvla":
        return wrapper.predict_tokens(images, np.concatenate([r["depth"] for r in reqs]), tasks)
    return wrapper.generate_tokens(images, tasks)


def fast_tokens(actions: np.ndarray, mc) -> np.ndarray:
    """Pi0FAST's detokenized bin centers [B, chunk, dim] -> their tokens [B, chunk * dim]."""
    step = (mc.action_high - mc.action_low) / mc.n_action_bins
    idx = np.clip(np.floor((actions - mc.action_low) / step), 0, mc.n_action_bins - 1).astype(np.int64)
    return (mc.vlm.vocab_size - idx - 1).reshape(actions.shape[0], -1)


def tpa_forced_logits(family: str, wrapper, request: dict, forced: torch.Tensor) -> torch.Tensor:
    """One card's per-step logits [T, B, window or V] with `forced` tokens fed back."""
    mc, policy = wrapper.model_cfg, wrapper.policy
    if family == "pi0fast":
        first = mc.vlm.vocab_size - (mc.action_vocab_size or mc.n_action_bins)
        inputs = policy.device_inputs(request["batch"])
        return greedy_logits(policy.params, inputs, mc, policy.policy, forced=forced)[1], first
    if family == "spatialvla":
        return svla_greedy_logits(wrapper.params, svla_inputs(wrapper, request["reqs"]), mc, policy, forced)[1], 0
    return magma_greedy_logits(wrapper.params, magma_inputs(wrapper, request["reqs"]), mc, policy, forced)[1], 0


def tpa_expected(family: str, mc, quantize: bool, rows: int) -> tuple[dict, dict]:
    """(kernel launches, tensor collectives) of one inference on a rank at
    tensor 2, from the configuration. Row-parallel products (o and down, and
    SigLIP's o and fc2): w8a8_partial and w8a8_finish in int8, one all-reduce
    each, and in int8 one MAX all-reduce of their row absmax; every other
    W8A8 product runs w8a8_matmul on the rank's columns or whole. Each lookup
    of the vocabulary-parallel table is one all-reduce, each greedy token one
    MAX all-reduce."""
    if family == "pi0fast":
        n_tok, depth = mc.n_action_tokens, mc.vlm.depth
        row = 2 * mc.vision.depth + 2 * (depth - 1) + 2 * n_tok * depth
        total, flash, lookups = w8a8_per_fast_inference(mc), depth - 1, 1 + n_tok
    elif family == "spatialvla":
        n_tok = mc.tokens_per_action * mc.n_action_steps
        row = 2 * mc.vision.depth + 2 * mc.lm.depth * n_tok
        total, flash, lookups = svla_per_inference(mc), 0, n_tok
    else:
        n_tok = mc.n_action_tokens + 1
        row = 2 * mc.lm.depth * n_tok
        total, flash, lookups = magma_per_inference(mc), 0, n_tok
    launches = {"flash_attention": flash, "w8a8_matmul": total - row if quantize else 0,
                "w8a8_partial": row if quantize else 0, "w8a8_finish": row if quantize else 0}
    coll = {"tensor_all_reduce": row + lookups, "tensor_all_reduce_max": (row if quantize else 0) + n_tok}
    return launches, coll


def tpa_rank(rank: int, world: int, port: int, workdir: str) -> None:
    """One of the phase's two ranks: a gloo group over the card's tensors,
    mesh (1, 1, 2); for each family the server role's int8 and then bf16
    wrapper (rank 0 serves the fused calls, rank 1 follows), each call's
    tokens on this rank, its launches and tensor collectives, the seconds its
    staged collectives took, and the family's peak memory. Writes
    workdir/rank{r}.pt."""
    import os

    from intact_tpu_torch.ops import w8a8
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.parallel import MeshConfig, collectives, distributed, make_mesh
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    workdir = Path(workdir)
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    device = distributed.initialize(DEVICE, backend="gloo")
    mesh = make_mesh(MeshConfig(1, 1, world))
    kernels = {"flash_attention": flash_attention, "w8a8_matmul": w8a8.w8a8_matmul,
               "w8a8_partial": w8a8.w8a8_partial, "w8a8_finish": w8a8.w8a8_finish}
    real_host, staged_s = collectives._on_host, [0.0]

    def timed_host(*args):  # the staged collectives' seconds (the host copies and gloo's reduction)
        t = time.perf_counter()
        real_host(*args)
        staged_s[0] += time.perf_counter() - t

    timed_host.calls = 0
    collectives._on_host = timed_host
    result = {"backend": distributed.backend(), "mesh": mesh.shape, "runs": []}
    try:
        with served_depths():
            for family in TPA_OPS:
                torch.cuda.reset_peak_memory_stats()
                for quantize in (True, False):
                    wrapper = make_policy_wrapper(tpa_config(family, quantize), device=device, mesh=mesh)
                    owner = wrapper.policy if family == "pi0fast" else wrapper
                    name = {"pi0fast": "_sample_rows", "spatialvla": "_predict_rows", "magma": "_generate_rows"}
                    real_rows, calls = getattr(owner, name[family]), []

                    def rows(*arrays, real_rows=real_rows, calls=calls):
                        before = {k: c.launches for k, c in kernels.items()}
                        c0, s0 = collectives.counts(), staged_s[0]
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        out = real_rows(*arrays)
                        torch.cuda.synchronize()
                        calls.append({"out": out.cpu(), "seconds": time.perf_counter() - t,
                                      "staged_s": staged_s[0] - s0,
                                      "launches": {k: c.launches - before[k] for k, c in kernels.items()},
                                      "collectives": {k: v - c0[k] for k, v in collectives.counts().items()
                                                      if v - c0[k]}})
                        return out

                    setattr(owner, name[family], rows)
                    wrapper.group.on(TPA_OPS[family], rows)
                    if rank == 0:
                        for n in TPA_ROWS:
                            tpa_call(family, wrapper, inputs[family][n])
                        wrapper.group.stop()
                    else:
                        wrapper.group.follow()
                    params = wrapper.policy.params if family == "pi0fast" else wrapper.params
                    result["runs"].append({"family": family, "quantize": quantize, "calls": calls,
                                           "split": sum(1 for _ in _tensor_split(params))})
                    del wrapper, owner, params, real_rows
                    gc.collect()
                    torch.cuda.empty_cache()
                result[f"peak_gib_{family}"] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        collectives._on_host = real_host
        torch.save(result, workdir / f"rank{rank}.pt")
        distributed.destroy()


def tpa_padding_cost(card: str) -> None:
    """What the one padding the phase keeps costs: a rank's Pi0FAST query
    heads (4 of 8 at t = 2) run the decode attention among zero ones at one
    card's 8 heads over the one K/V head (`tensor_parallel.whole_groups`),
    so its plain attention does one card's work. Times the decode step's
    attention over the cache (prefix + action slots) on 8 heads and on the
    rank's 4 alone, per layer and per inference (layers x greedy steps)."""
    from intact_tpu_torch.ops.attention import xla_attention

    mc = ev_config(False, path=FAST_EV_CONFIG).make_model_config()
    vc = mc.vlm
    slots = mc.num_cameras * mc.vision.num_patches + mc.tokenizer_max_length + 1 + mc.n_action_tokens
    gen = torch.Generator(device="cuda").manual_seed(29)
    for b in TPA_ROWS[::-1]:
        k, v = (torch.randn(b, slots, vc.num_kv_heads, vc.head_dim, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        mask = torch.ones(b, 1, slots, dtype=torch.bool, device="cuda")
        dev = {}
        for heads in (vc.num_heads, vc.num_heads // 2):
            q = torch.randn(b, 1, heads, vc.head_dim, generator=gen, device="cuda").to(torch.bfloat16)
            dev[heads] = device_ms(lambda q=q: xla_attention(q, k, v, mask, vc.head_dim**-0.5), reps=20)
        full, half = vc.num_heads, vc.num_heads // 2
        steps = mc.n_action_tokens
        extra = dev[full] - dev[half]
        log(f"# tensor parallel AR padding ({card}): Pi0FAST's decode attention at batch {b} over {slots} keys, per "
            f"layer: {full} heads (a rank's {half} among zero ones, as it runs) {dev[full]:.4f} ms of device, {half} "
            f"alone {dev[half]:.4f} ms; the zero heads per inference: {extra * FAST_SERVING_DEPTH * steps:.3f} ms at "
            f"the {FAST_SERVING_DEPTH} layers served here, {extra * vc.depth * steps:.3f} ms at {vc.depth} ({steps} "
            f"greedy steps)")


def phase_tensor_parallel_ar() -> dict:
    """-> {kernel: launches} of the three token-decoding families served at
    tensor 2 by two ranks on the one card (gloo, every collective staged
    through the host), summed over the ranks. The one-card references (each
    family's int8 and bf16 wrapper without a group, at the depths the script
    serves) run here first; the bf16 ones stay for the teacher-forced check
    of the ranks' tokens."""
    import shutil
    import socket

    import torch.multiprocessing as mp

    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    card = gpu_name_and_power()
    tpa_padding_cost(card)
    shutil.rmtree(TPA_DIR, ignore_errors=True)
    TPA_DIR.mkdir(parents=True)
    refs, bf16 = {}, {}
    try:
        with served_depths():
            requests = {(family, n): tpa_request(family, tpa_config(family, True).make_model_config(),
                                                 np.random.default_rng(40 + n), n)
                        for family in TPA_OPS for n in TPA_ROWS}
            for family in TPA_OPS:
                for quantize in (True, False):
                    wrapper = make_policy_wrapper(tpa_config(family, quantize), device=DEVICE)
                    for n in TPA_ROWS:
                        refs[family, quantize, n] = tpa_call(family, wrapper, requests[family, n])
                    if quantize:
                        del wrapper
                        gc.collect()
                        torch.cuda.empty_cache()
                    else:
                        bf16[family] = wrapper
            torch.save({family: {n: requests[family, n] for n in TPA_ROWS} for family in TPA_OPS},
                       TPA_DIR / "inputs.pt")
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            t0 = time.perf_counter()
            ctx = mp.start_processes(tpa_rank, args=(2, port, str(TPA_DIR)), nprocs=2, join=False,
                                     start_method="spawn")
            deadline = time.monotonic() + TPA_JOIN_S
            while not ctx.join(timeout=max(0.5, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    for p in ctx.processes:
                        p.kill()
                    raise SystemExit(f"the tensor-parallel AR ranks did not finish within {TPA_JOIN_S:.0f} s")
            ranks_s = time.perf_counter() - t0
            log(f"# tensor parallel AR: the two ranks ran in {ranks_s:.1f} s")
            ranks = [torch.load(TPA_DIR / f"rank{r}.pt", weights_only=False) for r in range(2)]
            totals = tpa_gates(ranks, refs, requests, bf16, card, ranks_s)
    finally:
        shutil.rmtree(TPA_DIR, ignore_errors=True)
        bf16.clear()
        gc.collect()
        torch.cuda.empty_cache()
    return totals


def tpa_gates(ranks: list, refs: dict, requests: dict, bf16: dict, card: str, ranks_s: float) -> dict:
    """The phase's gates over the two ranks' results -> the path's launches."""
    totals = dict.fromkeys(("flash_attention", "w8a8_matmul", "w8a8_partial", "w8a8_finish"), 0)
    staged = 0.0
    for r, res in enumerate(ranks):
        if res["backend"] != "gloo" or res["mesh"] != {"data": 1, "fsdp": 1, "tensor": 2}:
            raise SystemExit(f"tensor parallel AR rank {r}: group {res['backend']} mesh {res['mesh']}")
        for run in res["runs"]:
            family, q = run["family"], run["quantize"]
            wrapper = bf16[family]
            mc = wrapper.model_cfg
            label = f"rank {r} {family} {'int8' if q else 'bf16'}"
            if len(run["calls"]) != len(TPA_ROWS):
                raise SystemExit(f"tensor parallel AR {label}: {len(run['calls'])} inferences, not {len(TPA_ROWS)}")
            for call, n in zip(run["calls"], TPA_ROWS):
                want, coll = tpa_expected(family, mc, q, n)
                got = call["out"].numpy()
                if family == "pi0fast":
                    got = fast_tokens(got, mc)
                ref = refs[family, q, n]
                same = np.array_equal(got, ref)
                agree = float((got == ref).mean()) if got.shape == ref.shape else 0.0
                tensor_coll = {k: call["collectives"].get(k, 0) for k in coll}
                staged += call["staged_s"]
                ok = call["launches"] == want and tensor_coll == coll and got.shape == ref.shape
                margin = ""
                if not q and ok:  # one card's logits teacher-forced with the rank's tokens
                    forced = torch.from_numpy(got).to(DEVICE)
                    logits, first = tpa_forced_logits(family, wrapper, requests[family, n], forced)
                    chosen = logits.gather(-1, (forced - first).T[..., None])[..., 0]
                    below = (logits.amax(dim=-1) - chosen) / logits.std()
                    margin = (f", one card's teacher-forced logit of the rank's token below the maximum by at most "
                              f"{below.max().item():.3e} std (at {int((below > 0).sum())} of {below.numel()} steps "
                              f"and rows; gate {TPA_MARGIN})")
                    ok = ok and below.max().item() <= TPA_MARGIN
                    del logits
                else:
                    ok = ok and same
                log(f"# tensor parallel AR {label} batch {n} ({card}): {call['seconds'] * 1e3:.2f} ms on the rank "
                    f"({call['staged_s'] * 1e3:.2f} ms in staged collectives), launches {call['launches']} (expected "
                    f"{want}), tensor collectives {tensor_coll} (expected {coll}; all {call['collectives']}), tokens "
                    f"vs the one-card wrapper: bit-equal {same}, agreement {agree:.4f}{margin}")
                if not ok:
                    raise SystemExit(f"tensor parallel AR {label} batch {n}: the gates failed")
                for k in totals:
                    totals[k] += call["launches"][k]
        log(f"# tensor parallel AR rank {r}: peak device memory per family "
            f"{ {f: round(res[f'peak_gib_{f}'], 2) for f in TPA_OPS} } GiB; leaves held as tensor slices "
            f"{ {(x['family'], 'int8' if x['quantize'] else 'bf16'): x['split'] for x in res['runs']} }")
    log(f"# tensor parallel AR: the staged collectives took {staged:.1f} s of the ranks' inferences over both ranks; "
        f"the ranks' processes {ranks_s:.1f} s")
    return totals


# ---------------------------------------------------------------------------
# 3f. the tensor axis for MVLA (two ranks on one card)
# ---------------------------------------------------------------------------

TPM_DIR = Path(".chip_smoke_tp_mvla")  # the phase's inputs and each rank's results (git-ignored), removed after it
TPM_CASES = ("mvla", "mmmvla", "dit")  # the self/cross expert, the joint expert, the DiT head
TPM_ROWS = (1, 16)  # rows of each fused device call, as phase 3e's
TPM_JOIN_S = 900.0  # the two ranks' limit, then the phase fails and kills them
TPM_TRAIN_ROWS = 4


def tpm_wrapper(case: str, quantize: bool, device, mesh=None):
    """The server role's Pi0PolicyWrapper of a case from the ev yaml with
    MVLA_JSON: the mvla or mmmvla type, or the DiT head (the mvla type with
    action_head "dit"), whose adaLN-Zero modulation and output projection
    start at 0 (the blocks would not reach the actions) and are drawn from
    the seed here, on every rank alike: they are whole on each."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    cfg = ev_config(quantize, model_cfg=mvla_model_cfg("mmmvla" if case == "mmmvla" else "mvla"))
    with cut_depths(("mvla", None, {"action_head": "dit"})) if case == "dit" else contextlib.nullcontext():
        wrapper = make_policy_wrapper(cfg, device=device, mesh=mesh)
    if case == "dit":
        gen = torch.Generator(device=device).manual_seed(SERVING_SEED + 1)
        flat = cm.flatten_paths(wrapper.policy.params["dit"])
        for path in sorted(p for p in flat if p.startswith(("blocks/ada/", "final/"))):
            flat[path].copy_(torch.randn(flat[path].shape, generator=gen, device=device) * 0.02)
    return wrapper


def tpm_padding_cost(card: str) -> None:
    """What the cross attention's zero heads cost: a rank's 4 of the
    expert's 8 query heads over the prompt's one K/V head run among zero
    ones at one card's 8 (`tensor_parallel.whole_groups`). Times that plain
    attention over the 108 prompt keys on the padded 8 heads and on the
    rank's 4 alone, per layer and per inference (cross layers x Euler
    steps), and reports whether the 4 alone give the padded run's output
    bit for bit at these shapes."""
    from intact_tpu_torch.models.mvla.config import MVLAConfig
    from intact_tpu_torch.ops.attention import xla_attention
    from intact_tpu_torch.parallel import tensor as tensor_parallel

    with mvla_depths():
        mc = ev_config(False, model_cfg=mvla_model_cfg()).make_model_config()
    e, rows, keys = mc.expert, 1 + mc.chunk_size, mc.num_metaqueries
    whole_pairs = MVLAConfig().expert.depth // 2  # the whole expert's cross layers
    rank0 = tensor_parallel.TensorParallel(None, 2, 0)
    gen = torch.Generator(device="cuda").manual_seed(37)
    for b in TPM_ROWS[::-1]:
        k, v = (torch.randn(b, keys, e.num_kv_heads, e.head_dim, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        q = torch.randn(b, rows, e.num_heads // 2, e.head_dim, generator=gen, device="cuda").to(torch.bfloat16)
        padded, own = tensor_parallel.whole_groups(q, rank0, e.num_heads, e.num_kv_heads)
        same = torch.equal(xla_attention(padded, k, v, None, e.head_dim**-0.5)[:, :, own],
                           xla_attention(q, k, v, None, e.head_dim**-0.5))
        dev = {n: device_ms(lambda x=x: xla_attention(x, k, v, None, e.head_dim**-0.5), reps=20)
               for n, x in ((padded.shape[2], padded), (q.shape[2], q))}
        (full, dev_full), (half, dev_half) = dev.items()
        extra = dev_full - dev_half
        log(f"# tensor parallel MVLA padding ({card}): the cross attention at batch {b}, {rows} query rows over "
            f"{keys} prompt keys, per layer: {full} heads (a rank's {half} among zero ones, as it runs) "
            f"{dev_full:.4f} ms of device, {half} alone {dev_half:.4f} ms (bit-equal to the padded run's heads: "
            f"{same}); the zero heads per inference: {extra * (e.depth // 2) * mc.num_steps:.3f} ms at the "
            f"{e.depth // 2} cross layers served here, {extra * whole_pairs * mc.num_steps:.3f} ms at {whole_pairs} "
            f"({mc.num_steps} Euler steps)")


def ddim_steps(mc) -> int:
    """The DDIM sampler's steps (models/diffusion.py::ddim_sample's respacing)."""
    return len(range(mc.diffusion_steps - 1, -1, -max(mc.diffusion_steps // mc.num_steps, 1)))


def tpm_expected(mc, quantize: bool) -> tuple[dict, dict]:
    """(kernel launches, tensor collectives) of one inference on a rank at
    tensor 2, from the configuration, every tower's heads and MLP split.
    Row-parallel products: SigLIP's o and fc2, the VLM prefill's, the
    connector's, the expert's and the DiT's o and down/fc2, each one
    all-reduce and, in int8, w8a8_partial, w8a8_finish and one MAX
    all-reduce of its row absmax; the other W8A8 products run w8a8_matmul on
    the rank's columns (q, gate, up, fc1; the connector's and the DiT's k
    and v) or whole (the one-head K/V, img_proj). One all-reduce more: the
    embedding's vocabulary-parallel lookup. The attention kernel: every VLM
    layer, then the self layers of every Euler step (self/cross), the joint
    expert's kv_only prompt prefill, or nothing (the DiT's attention is
    plain)."""
    e, steps = mc.expert, mc.num_steps
    column = mc.vision.depth * 4 + 1 + mc.vlm.depth * 5 + mc.connector.depth * 5
    row = 2 * (mc.vision.depth + mc.vlm.depth + mc.connector.depth)
    flash = mc.vlm.depth
    if mc.action_head == "dit":
        column += ddim_steps(mc) * mc.dit_depth * 4
        row += ddim_steps(mc) * mc.dit_depth * 2
    elif mc.alternate_pattern == "joint":
        column += (e.depth - 1) * 5 + 2 + steps * e.depth * 5
        row += (e.depth - 1) * 2 + steps * e.depth * 2
        flash += e.depth - 1
    else:
        pairs = e.depth // 2
        column += 2 * pairs + steps * pairs * (5 + 3)
        row += steps * pairs * (2 + 2)
        flash += steps * pairs
    launches = {"flash_attention": flash, "w8a8_matmul": column if quantize else 0,
                "w8a8_partial": row if quantize else 0, "w8a8_finish": row if quantize else 0}
    return launches, {"tensor_all_reduce": row + 1, "tensor_all_reduce_max": row if quantize else 0}


def tpm_rank(rank: int, world: int, port: int, workdir: str) -> None:
    """One of the phase's two ranks: a gloo group over the card's tensors,
    mesh (1, 1, 2); for each case the server role's int8 and then bf16
    wrapper (rank 0 serves TPM_ROWS, rank 1 follows), each call's actions on
    this rank, its launches, the query heads of its attention launches, its
    tensor collectives and staged seconds; then the expert-only micro-steps.
    Writes workdir/rank{r}.pt."""
    import os

    from intact_tpu_torch.ops import attention, w8a8
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.parallel import MeshConfig, collectives, distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    workdir = Path(workdir)
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    device = distributed.initialize(DEVICE, backend="gloo")
    mesh = make_mesh(MeshConfig(1, 1, world))
    kernels = {"flash_attention": flash_attention, "w8a8_matmul": w8a8.w8a8_matmul,
               "w8a8_partial": w8a8.w8a8_partial, "w8a8_finish": w8a8.w8a8_finish}
    heads: list = []
    real_flash, real_host, staged_s = attention.flash_attention, collectives._on_host, [0.0]

    def counted_flash(q, *args, **kw):  # the query heads of every launch on the path
        heads.append(q.shape[2])
        return real_flash(q, *args, **kw)

    def timed_host(*args):  # the staged collectives' seconds (the host copies and gloo's reduction)
        t = time.perf_counter()
        real_host(*args)
        staged_s[0] += time.perf_counter() - t

    timed_host.calls = 0
    attention.flash_attention, collectives._on_host = counted_flash, timed_host
    result = {"backend": distributed.backend(), "mesh": mesh.shape, "runs": []}
    try:
        with mvla_depths():
            for case in TPM_CASES:
                for quantize in (True, False):
                    wrapper = tpm_wrapper(case, quantize, device, mesh)
                    policy = wrapper.policy
                    real_rows, calls = policy._sample_rows, []

                    def rows(*arrays, real_rows=real_rows, calls=calls):  # the rows' arrays, then the noise
                        heads.clear()
                        before = {k: c.launches for k, c in kernels.items()}
                        c0, s0 = collectives.counts(), staged_s[0]
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        out = real_rows(*arrays)
                        torch.cuda.synchronize()
                        calls.append({"out": out.float().cpu(), "seconds": time.perf_counter() - t,
                                      "staged_s": staged_s[0] - s0, "heads": sorted(set(heads)),
                                      "launches": {k: c.launches - before[k] for k, c in kernels.items()},
                                      "collectives": {k: v - c0[k] for k, v in collectives.counts().items()
                                                      if v - c0[k]}})
                        return out

                    policy._sample_rows = rows
                    wrapper.group.on("sample", rows)
                    if rank == 0:
                        for n in TPM_ROWS:
                            wrapper.sample_action_chunk(inputs["batches"][n])
                        wrapper.group.stop()
                    else:
                        wrapper.group.follow()
                    result["runs"].append({"case": case, "quantize": quantize, "calls": calls,
                                           "split": sum(1 for _ in _tensor_split(policy.params))})
                    del wrapper, policy, real_rows
                    gc.collect()
                    torch.cuda.empty_cache()
            result["serving_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            collectives.reset()
            mc = ev_config(False, model_cfg=mvla_model_cfg()).make_model_config()
            result["train"] = tp_expert_steps(device, mesh, inputs, heads, cfg=mc)
            result["train"]["collectives"] = {k: v for k, v in collectives.counts().items() if v}
            result["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        attention.flash_attention, collectives._on_host = real_flash, real_host
        torch.save(result, workdir / f"rank{rank}.pt")
        distributed.destroy()


def phase_tensor_parallel_mvla() -> dict:
    """-> {kernel: launches} of MVLA served (the self/cross expert, the joint
    expert, the DiT head) and trained expert-only at tensor 2 by two ranks on
    the one card (gloo, every collective staged through the host), summed
    over the ranks, at phase 8's depths. The one-card references (each
    case's int8 and bf16 wrapper without a group, the same seed, requests
    and call order, so the same noise) run here first."""
    import shutil
    import socket

    import torch.multiprocessing as mp

    card = gpu_name_and_power()
    tpm_padding_cost(card)
    shutil.rmtree(TPM_DIR, ignore_errors=True)
    TPM_DIR.mkdir(parents=True)
    refs, mcs = {}, {}
    try:
        with mvla_depths():
            mc = ev_config(False, model_cfg=mvla_model_cfg()).make_model_config()
            batches = {n: tp_batch(np.random.default_rng(50 + n), n, mc.vision.image_size) for n in TPM_ROWS}
            for case in TPM_CASES:
                for quantize in (True, False):
                    wrapper = tpm_wrapper(case, quantize, DEVICE)
                    mcs[case] = wrapper.model_cfg
                    for n in TPM_ROWS:
                        t = time.perf_counter()
                        refs[case, quantize, n] = torch.from_numpy(wrapper.sample_action_chunk(batches[n]))
                        log(f"# tensor parallel MVLA: one-card reference {case} {'int8' if quantize else 'bf16'} batch "
                            f"{n}: {(time.perf_counter() - t) * 1e3:.2f} ms")
                    del wrapper
                    gc.collect()
                    torch.cuda.empty_cache()
            rng = np.random.default_rng(51)
            torch.save({"batches": batches, "train_seed": 5,
                        "train_batches": [{k: torch.from_numpy(np.asarray(v)) for k, v in
                                           make_train_batch(rng, mc, TPM_TRAIN_ROWS).items()} for _ in range(2)],
                        "train_noise": [torch.from_numpy(rng.standard_normal((TPM_TRAIN_ROWS, mc.chunk_size,
                                                                              mc.max_action_dim), dtype=np.float32))
                                        for _ in range(2)],
                        "train_time": [torch.from_numpy(rng.uniform(0.1, 0.9, TPM_TRAIN_ROWS).astype(np.float32))
                                       for _ in range(2)]}, TPM_DIR / "inputs.pt")
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            t0 = time.perf_counter()
            ctx = mp.start_processes(tpm_rank, args=(2, port, str(TPM_DIR)), nprocs=2, join=False, start_method="spawn")
            deadline = time.monotonic() + TPM_JOIN_S
            while not ctx.join(timeout=max(0.5, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    for p in ctx.processes:
                        p.kill()
                    raise SystemExit(f"the tensor-parallel MVLA ranks did not finish within {TPM_JOIN_S:.0f} s")
            ranks_s = time.perf_counter() - t0
            log(f"# tensor parallel MVLA: the two ranks ran in {ranks_s:.1f} s")
            ranks = [torch.load(TPM_DIR / f"rank{r}.pt", weights_only=False) for r in range(2)]
    finally:
        shutil.rmtree(TPM_DIR, ignore_errors=True)
    return tpm_gates(ranks, refs, mcs, card, ranks_s)


def tpm_gates(ranks: list, refs: dict, mcs: dict, card: str, ranks_s: float) -> dict:
    """The phase's gates over the two ranks' results -> the path's launches."""
    totals = dict.fromkeys(("flash_attention", "w8a8_matmul", "w8a8_partial", "w8a8_finish"), 0)
    local_heads = mcs["mvla"].vlm.num_heads // 2
    staged = 0.0
    for r, res in enumerate(ranks):
        if res["backend"] != "gloo" or res["mesh"] != {"data": 1, "fsdp": 1, "tensor": 2}:
            raise SystemExit(f"tensor parallel MVLA rank {r}: group {res['backend']} mesh {res['mesh']}")
        for run in res["runs"]:
            case, q = run["case"], run["quantize"]
            label = f"rank {r} {case} {'int8' if q else 'bf16'}"
            if len(run["calls"]) != len(TPM_ROWS):
                raise SystemExit(f"tensor parallel MVLA {label}: {len(run['calls'])} inferences, not {len(TPM_ROWS)}")
            want, coll = tpm_expected(mcs[case], q)
            for call, n in zip(run["calls"], TPM_ROWS):
                ref, got = refs[case, q, n], call["out"]
                same = got.shape == ref.shape and torch.equal(got, ref)
                rel = rel_l2(got, ref) if got.shape == ref.shape else float("inf")
                tensor_coll = {k: call["collectives"].get(k, 0) for k in coll}
                staged += call["staged_s"]
                want_heads = [local_heads] if want["flash_attention"] else []
                log(f"# tensor parallel MVLA {label} batch {n} ({card}): {call['seconds'] * 1e3:.2f} ms on the rank "
                    f"({call['staged_s'] * 1e3:.2f} ms in staged collectives), launches {call['launches']} (expected "
                    f"{want}), attention on {call['heads']} local heads (expected {want_heads}), tensor collectives "
                    f"{tensor_coll} (expected {coll}; all {call['collectives']}), actions vs the one-card wrapper: "
                    f"bit-equal {same}, rel L2 {rel:.3e} (bf16 gate {ACTIONS_RTOL})")
                ok = call["launches"] == want and tensor_coll == coll and call["heads"] == want_heads
                ok = ok and bool(torch.isfinite(got).all()) and (same if q else rel <= ACTIONS_RTOL)
                if not ok:
                    raise SystemExit(f"tensor parallel MVLA {label} batch {n}: the gates failed")
                for k in totals:
                    totals[k] += call["launches"][k]
        train = res["train"]
        mc = mcs["mvla"]
        want_flash = 2 * (2 * mc.vlm.depth + mc.expert.depth // 2)
        log(f"# tensor parallel MVLA rank {r} expert-only micro-steps (2 fp32 with the plain attention, then 2 bf16 "
            f"with the kernel): losses {train['losses']}, [grad_norm, param_norm] {train['norms']}, launches "
            f"(flash_attention, w8a8_matmul, w8a8_partial, w8a8_finish) fp32 {train['launches_fp32']} bf16 "
            f"{train['launches_bf16']} (flash_attention expected {want_flash}: each micro-step's VLM layers twice, "
            f"the checkpointed prefill's forward and recompute, and the expert's self layers), the kernel on "
            f"{train['heads_bf16']} local heads, collectives {train['collectives']}, summed over tensor "
            f"{train['partial']}; peak {res['serving_peak_gib']:.2f} GiB serving, {res['peak_gib']:.2f} GiB with "
            f"training")
        for launches in (train["launches_fp32"], train["launches_bf16"]):
            for k, n in zip(("flash_attention", "w8a8_matmul", "w8a8_partial", "w8a8_finish"), launches):
                totals[k] += n
        ok = train["launches_fp32"] == [0, 0, 0, 0] and train["launches_bf16"] == [want_flash, 0, 0, 0]
        finite = bool(np.isfinite(train["losses"] + sum(train["norms"], [])).all())
        ok = ok and train["heads_bf16"] == [local_heads] and finite
        ok = ok and {"connector/blocks/attn/q_norm/scale", "expert/pairs/cross/attn/k/kernel"} <= set(train["partial"])
        if not ok:
            raise SystemExit(f"tensor parallel MVLA rank {r}: the expert-only micro-steps failed")
    tp_steps_against_one_card(ranks, "tensor parallel MVLA")
    log(f"# tensor parallel MVLA: the staged collectives took {staged:.1f} s of the ranks' inferences over both "
        f"ranks; the ranks' processes {ranks_s:.1f} s")
    return totals


# ---------------------------------------------------------------------------
# 3g. the tensor axis for the last two training paths (two ranks on one card)
# ---------------------------------------------------------------------------

TPT_DIR = Path(".chip_smoke_tp_train")  # the phase's inputs and each rank's results (git-ignored), removed after it
TPT_JOIN_S = 600.0  # the two ranks' limit, then the phase fails and kills them
TPT_ROWS = 4  # the rows of each micro-step and fused step: one batch coordinate, which both ranks take
TPT_SEED, TPT_SALT = 6, 12345
# Pi0FAST at phase 3e's trunk depth (FAST_SERVING_DEPTH) and phase 3d's SigLIP depth; the fused step at 4 of its
# 18 layer pairs (it needs equal VLM and expert depth) and the same SigLIP
TPT_FUSED_DEPTH = 4
TPT_VISION_DEPTH = TP_PI0_VISION_DEPTH
# Pi0FAST's two fp32 micro-steps (AdamW, accumulation 2: phase 3d's TP_TRAIN_OPT) against one card: the ranks'
# row-parallel products and cross entropy sum fp32 partials in another order than one card's GEMMs and softmax
TPT_FP32_RTOL = 1e-5  # loss, grad_norm, param_norm
TPT_PARAMS_ATOL = 1e-5  # the params after the update
TPT_TABLE_RTOL = 1e-5  # rel L2 of the tied table's first micro-step gradient, gathered over the ranks
# the fused step (bf16 masters, SR, fp8 moments, the kernels) against one card: loss and grad_norm at the
# kernel-vs-plain tolerances of phase 4 (TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL), params, updates and moment codes at
# TRAIN_PARAMS_RTOL, TRAIN_UPDATE_RTOL and TRAIN_CODES_SHARE: the ranks' reduced gradient rounds otherwise (the
# partial K/V and bias sums, the row-parallel fp32 partials), and the stochastic rounding carries each difference
# to a bf16 ulp
TPT_BLOCK = 2048


def tpt_fast_config():
    """Pi0FAST's recipe model (pi0fast_finetune_bridge.yaml) at full width,
    FAST_SERVING_DEPTH trunk and TPT_VISION_DEPTH SigLIP layers."""
    full = trainer_config(FAST_RECIPE, FAST_OVERRIDES).make_model_config()
    return dataclasses.replace(full, vlm=dataclasses.replace(full.vlm, depth=FAST_SERVING_DEPTH),
                               vision=dataclasses.replace(full.vision, depth=TPT_VISION_DEPTH))


def tpt_fused_config():
    """(the 1-chip recipe's config, its model at full width, TPT_FUSED_DEPTH
    layer pairs and TPT_VISION_DEPTH SigLIP layers, its optimizer)."""
    from intact_tpu_torch.config.pipeline import optimizer_config_from_model_json

    cfg = recipe_config()
    full = cfg.make_model_config()
    mc = dataclasses.replace(full, attention_impl="pallas", vlm=dataclasses.replace(full.vlm, depth=TPT_FUSED_DEPTH),
                             expert=dataclasses.replace(full.expert, depth=TPT_FUSED_DEPTH),
                             vision=dataclasses.replace(full.vision, depth=TPT_VISION_DEPTH))
    return cfg, mc, optimizer_config_from_model_json(cfg.model_cfg, cfg)


def tpt_host(flat: dict, mesh, dtype=None) -> dict | None:
    """{path: leaf} whole on the host: every rank joins each split leaf's
    gather (one at a time); rank 0 (or one card, mesh None) keeps them."""
    from intact_tpu_torch.parallel.sharding import Sharded, gather_leaf

    out = {}
    for k, v in flat.items():
        whole = gather_leaf(v.local, v) if isinstance(v, Sharded) else v
        if mesh is None or mesh.rank == 0:
            out[k] = whole.detach().to("cpu", dtype or whole.dtype, copy=True)
        del whole
    return out if mesh is None or mesh.rank == 0 else None


def tpt_counters() -> tuple:
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.ops.fused_adam import fused_adam_rows
    from intact_tpu_torch.parallel import collectives

    return flash_attention.launches, fused_adam_rows.launches, collectives.counts()


def tpt_delta(before: tuple) -> dict:
    """The kernels' launches and the tensor group's collectives since `before`."""
    flash, adam, coll = tpt_counters()
    out = {"flash_attention": flash - before[0], "fused_adam_rows": adam - before[1]}
    out.update({k: v - before[2][k] for k, v in coll.items() if k.startswith("tensor_")})
    return out


def tpt_fast_steps(device, mesh, inputs: dict, heads: list) -> dict:
    """Pi0FAST's standard step at full width: two fp32 micro-steps with the
    plain attention (one AdamW update), then two bf16 ones with the kernel,
    on the mesh's tensor slices or (mesh None) on one card, from the seed's
    weights and the same batches. -> per micro-step the loss, token accuracy,
    [grad_norm, param_norm], launches, tensor collectives and attention
    heads; on rank 0 (or one card) the params after the fp32 update and the
    tied table's first micro-step gradient, whole on the host."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.pi0fast import model
    from intact_tpu_torch.parallel.mesh import single_rank_mesh
    from intact_tpu_torch.parallel.sharding import gather_leaf, shard_tree
    from intact_tpu_torch.train.optim import OptimizerConfig, make_optimizer
    from intact_tpu_torch.train.train_step import init_train_state, make_train_step

    base = tpt_fast_config()
    params = model.init(base, inputs["seed"], device, torch.float32)
    if mesh is not None:
        params = shard_tree(params, mesh, consume=True, heads=model.tensor_heads(base))
    tx, _ = make_optimizer(OptimizerConfig(**TP_TRAIN_OPT), None, mesh=mesh or single_rank_mesh())
    state = init_train_state(params, tx, seed=0)
    table = []
    real_apply = tx.apply

    def apply(grads, *args):  # the first micro-step's gradient of the tied table, as the step hands it over
        if not table:
            table.append(grads["vlm_embed/embedding"].clone())
        return real_apply(grads, *args)

    tx.apply = apply
    batches = [{k: v.to(device) for k, v in b.items()} for b in inputs["fast_batches"]]
    res = {"losses": [], "accs": [], "norms": [], "counts": [], "heads": [], "partial": sorted(tx.partial)}
    for precision, impl, policy in (("fp32", "xla", cm.FP32_POLICY), ("bf16", "pallas", cm.DEFAULT_POLICY)):
        mc = dataclasses.replace(base, attention_impl=impl)
        step = make_train_step(lambda p, r, b, n, t, mc=mc, policy=policy: model.compute_loss(p, r, b, mc, policy), tx)
        for b in batches:
            heads.clear()
            before = tpt_counters()
            state, metrics = step(state, b)
            torch.cuda.synchronize()
            res["counts"].append(tpt_delta(before))
            res["heads"].append(sorted(set(heads)))
            res["losses"].append(metrics["l2_loss"].item())
            res["accs"].append(metrics["token_accuracy"].item())
            res["norms"].append([metrics["grad_norm"].item(), metrics["param_norm"].item()])
        if precision == "fp32":  # every rank joins the gathers; rank 0 keeps the leaves
            flat = cm.flatten_paths(state.params)
            res["params"] = tpt_host(flat, mesh)
            like = flat["vlm_embed/embedding"]
            grad = gather_leaf(table[0], like) if mesh is not None else table[0]
            res["table_grad"] = grad.cpu() if mesh is None or mesh.rank == 0 else None
            res["table_split"] = mesh is not None and like.tensor is not None
            del flat, grad, table[:]
    del params, state, tx
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tpt_row_launches(state, mesh) -> int:
    """fused_adam_rows launches of one fused step on this rank (mesh None:
    one card): each kernel-eligible trunk leaf with rows in the rank's share
    of its layer's pack, in every layer, and each eligible 8-bit leaf of the
    head and the embed side with rows in the rank's share of its own."""
    from intact_tpu_torch.ops.fused_adam import eligible
    from intact_tpu_torch.parallel.mesh import single_rank_mesh
    from intact_tpu_torch.parallel.sharding import held
    from intact_tpu_torch.train import fused_joint as fj

    mesh = mesh or single_rank_mesh()
    n = 0
    for tower in ("vlm", "expert"):
        blocks = state.params[tower]["blocks"]
        pack = fj.TrunkPack(blocks, TPT_BLOCK)
        shard = fj.pack_shard(pack, mesh)
        depth = held(next(fj.tree_items(blocks))[1]).shape[0]
        n += depth * sum(eligible(size, TPT_BLOCK) and max(off, shard.r0) < min(off + r, shard.r1)
                         for size, r, off in zip(pack.sizes, pack.rows, pack.offsets))
    for name in fj.EMBED_NAMES + ("action_out_proj",):
        moments = dict(fj.tree_items(state.mu[name], quant_leaves=True))
        for path, p in fj.tree_items(state.params[name]):
            shard = fj.leaf_shard(p, TPT_BLOCK, mesh) if fj._is_quant_leaf(moments[path]) else None
            n += shard is not None and shard.rows > 0
    return n


def tpt_fused_steps(device, mesh, inputs: dict, heads: list) -> dict:
    """Two fused steps of the 1-chip recipe (bf16 masters with stochastic
    rounding, fp8 moments, the attention and row kernels) at full width and
    TPT_FUSED_DEPTH layer pairs, from the seed's weights past the warmup, on
    the mesh's tensor slices or (mesh None) on one card. -> per step the
    loss, grad_norm, clip factor, launches, tensor collectives and attention
    heads, the row kernel's launches counted from the packs' row split, the
    tensor-split leaves outside the trunks; on rank 0 (or one card) the
    params before and after and the moments in the one-card layout, on the
    host."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.pi0 import model as pi0
    from intact_tpu_torch.parallel.mesh import single_rank_mesh
    from intact_tpu_torch.parallel.sharding import Sharded, shard_tree
    from intact_tpu_torch.train import fused_joint as fj

    _, mc, opt = tpt_fused_config()
    params = pi0.init(mc, inputs["seed"], device, torch.bfloat16)
    before = tpt_host(cm.flatten_paths(params), None) if mesh is None else None
    if mesh is not None:
        params = shard_tree(params, mesh, consume=True, heads=pi0.tensor_heads(mc), over_fsdp=False)
    state = fj.init_fused_state(params, inputs["seed"], block_size=TPT_BLOCK, mesh=mesh)
    state.count = opt.warmup_steps  # past the warmup: the learning rate at its peak
    policy = cm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.bfloat16)
    step = fj.make_fused_joint_step(mc, opt, policy, block_size=TPT_BLOCK, stochastic_rounding=True,
                                    scale_mode="exact", mesh=mesh)
    batch = {k: v.to(device) for k, v in inputs["fused_batch"].items()}
    res = {"losses": [], "gnorms": [], "clips": [], "counts": [], "heads": [],
           "want_rows": tpt_row_launches(state, mesh),
           "split_outside": sum(isinstance(v, Sharded) for k, v in cm.flatten_paths(params).items()
                                if k.split("/")[0] in fj.EMBED_NAMES + ("action_out_proj",))}
    for i in range(2):
        heads.clear()
        counters = tpt_counters()
        state, metrics = step(state, batch, noise=inputs["fused_noise"][i].to(device),
                              time=inputs["fused_time"][i].to(device), salt=inputs["salt"] + i)
        torch.cuda.synchronize()
        res["counts"].append(tpt_delta(counters))
        res["heads"].append(sorted(set(heads)))
        res["losses"].append(metrics["l2_loss"].item())
        res["gnorms"].append(metrics["grad_norm"].item())
        res["clips"].append(metrics["clip_factor"].item())
    res["params"] = tpt_host(cm.flatten_paths(state.params), mesh)
    mu, nu = fj.global_moments(state, mesh or single_rank_mesh(), block_size=TPT_BLOCK)
    if mesh is None or mesh.rank == 0:
        res["moments"] = {k: v.cpu() for k, v in cm.flatten_paths({"mu": mu, "nu": nu}).items()}
        res["before"] = before  # one card's: the ranks start from the same weights
    del params, state, mu, nu
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tpt_fed_update(device, mesh, inputs: dict) -> dict:
    """One update of layer 0 of the VLM trunk (every leaf of Gemma-2B's layer,
    bf16 with stochastic rounding, fp8 moments, the row kernel) fed one
    card's gradient, drawn from the seed: on the mesh each rank its share
    (its tensor slices; a partial leaf's on tensor index 0, zeros on the
    other), through the fused step's own updater, or on one card (mesh
    None). -> the launches; on rank 0 (or one card) the layer's leaves and
    its moment rows in the one-card layout, on the host."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.pi0 import model as pi0
    from intact_tpu_torch.ops.fused_adam import fused_adam_rows
    from intact_tpu_torch.parallel import sharding
    from intact_tpu_torch.parallel import tensor as tensor_parallel
    from intact_tpu_torch.parallel.mesh import single_rank_mesh
    from intact_tpu_torch.parallel.sharding import shard_tree
    from intact_tpu_torch.train import fused_joint as fj

    _, mc, opt = tpt_fused_config()
    params = pi0.init(mc, inputs["seed"], device, torch.bfloat16)
    if mesh is not None:
        params = shard_tree(params, mesh, consume=True, heads=pi0.tensor_heads(mc), over_fsdp=False)
    state = fj.init_fused_state(params, inputs["seed"], block_size=TPT_BLOCK, mesh=mesh)
    partial = tensor_parallel.partial_paths(cm.flatten_paths(params)) if mesh is not None else frozenset()
    blocks = params["vlm"]["blocks"]
    gen = torch.Generator(device=device).manual_seed(inputs["seed"] + 1)
    grads = []
    for path, leaf in fj.tree_items(blocks):
        g = torch.randn(fj._whole_shape(leaf)[1:], generator=gen, device=device).mul_(1e-3).to(torch.bfloat16)
        if mesh is not None and fj._split(leaf) is not None:
            g = fj._slice_of(leaf, g).contiguous()
        elif mesh is not None and "vlm/blocks/" + "/".join(path) in partial and mesh.tensor_index != 0:
            g = torch.zeros_like(g)
        grads.append(g)
    hyp = torch.tensor([1 - 0.9**3, 1 - 0.999**3, 5e-5, 0.7], device=device)
    upd = fj._Updater(hyp, opt, torch.zeros(1, device=device), stochastic=True, block_size=TPT_BLOCK,
                      use_kernel=True, scale_mode="exact", apply_updates=True,
                      mesh=mesh or single_rank_mesh(), partial=partial)
    pack = fj.TrunkPack(blocks, TPT_BLOCK)
    a0 = fused_adam_rows.launches
    upd.trunk_rows(pack, blocks, grads, state.mu["vlm"]["blocks"], state.nu["vlm"]["blocks"], 0, inputs["salt"],
                   "vlm/blocks/")
    torch.cuda.synchronize()
    res = {"launches": fused_adam_rows.launches - a0}
    leaves = fj._tensor_whole([x for _, x in fj.tree_items(blocks)], 0)
    rows = {}
    for tree in ("mu", "nu"):
        for k, x in getattr(state, tree)["vlm"]["blocks"].items():
            rows[f"{tree}/{k}"] = (x[0] if mesh is None else
                                   sharding.gather_leading(x[:1], mesh, pack.nb, axis=1)[0])
    if mesh is None or mesh.rank == 0:
        res["leaves"] = [x.cpu() for x in leaves]
        res["moments"] = {k: v.cpu() for k, v in rows.items()}
    del params, state, leaves, rows, grads
    gc.collect()
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def tpt_attention(heads: list, errors: list):
    """ops.attention's flash_attention recording each launch's query heads,
    and the first launch at each shape held against its plain version on
    its own inputs (its shape, rel L2 and max abs difference into `errors`;
    gated at phase 5's STD_ATTN_RTOL: the activations reach |out| ~ 10, where
    KERNEL_ATOL's two bf16 ulps at 1 do not apply); restored on exit."""
    from intact_tpu_torch.ops import attention
    from intact_tpu_torch.ops.flash_attention import flash_attention_reference

    real = attention.flash_attention
    seen = set()

    def counted(q, k, v, mask=None, scale=None):
        heads.append(q.shape[2])
        out = real(q, k, v, mask, scale)
        if tuple(q.shape) not in seen:
            seen.add(tuple(q.shape))
            ref = flash_attention_reference(q, k, v, mask, scale)
            errors.append((tuple(q.shape), rel_l2(out, ref), (out.float() - ref.float()).abs().max().item()))
        return out

    attention.flash_attention = counted
    try:
        yield
    finally:
        attention.flash_attention = real


def tpt_rank(rank: int, world: int, port: int, workdir: str) -> None:
    """One of the phase's two ranks: a gloo group over the card's tensors
    (NCCL refuses two ranks of one device), mesh (1, 1, 2); Pi0FAST's
    micro-steps, the fused steps and the fed update. Writes
    workdir/rank{r}.pt."""
    import os

    from intact_tpu_torch.parallel import MeshConfig, collectives, distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    workdir = Path(workdir)
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    device = distributed.initialize(DEVICE, backend="gloo")
    mesh = make_mesh(MeshConfig(1, 1, world))
    heads, errors = [], []
    result = {"backend": distributed.backend(), "mesh": mesh.shape}
    try:
        with tpt_attention(heads, errors):
            collectives.reset()
            t = time.perf_counter()
            result["fast"] = tpt_fast_steps(device, mesh, inputs, heads)
            result["fast_s"] = time.perf_counter() - t
            t = time.perf_counter()
            result["fused"] = tpt_fused_steps(device, mesh, inputs, heads)
            result["fused_s"] = time.perf_counter() - t
            result["fed"] = tpt_fed_update(device, mesh, inputs)
        result["attention_errors"] = errors
        result["staged"] = collectives.staged_calls()
        result["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        torch.save(result, workdir / f"rank{rank}.pt")
        distributed.destroy()


def tpt_kernel_checks(card: str) -> None:
    """The row kernel at a tensor rank's rows of the Gemma-2B layer pack at t =
    2 (57,344 rows, 28,672 per rank): rank 1's part of the gate leaf (its
    salt shifted by the rows before it, row_offset 0) and its up leaf (at
    row_offset 8,704), each against its plain version, timed beside its
    bound; flash_attention on one rank's 4 local query heads at the two
    paths' training shapes at the recipes' micro-batch 16 (Pi0FAST's 357
    tokens with the causal suffix, the fused step's 333), beside SDPA."""
    from intact_tpu_torch.models import gemma
    from intact_tpu_torch.models.common import Initializer
    from intact_tpu_torch.ops.fused_adam import fused_adam_rows, fused_adam_rows_reference, shift_salt
    from intact_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference
    from intact_tpu_torch.parallel.mesh import Mesh
    from intact_tpu_torch.train import fused_joint as fj
    from intact_tpu_torch.train.optim import OptimizerConfig

    blocks = gemma.init_block_params(Initializer(0, torch.device("meta"), torch.bfloat16), gemma.gemma_2b(), (1,))
    pack = fj.TrunkPack(blocks, TPT_BLOCK)
    shard = fj.pack_shard(pack, Mesh(1, 1, 2, 1, dict.fromkeys(("data", "fsdp", "tensor", "batch", "model", "world"))))
    names = ["/".join(p) for p, _ in fj.tree_items(blocks)]
    hp = OptimizerConfig(lr=5e-5, weight_decay=0.0)
    hyp = torch.tensor([1 - 0.9**3, 1 - 0.999**3, 5e-5, 0.7], device="cuda")
    rng = np.random.default_rng(9)
    for name in ("mlp/gate/kernel", "mlp/up/kernel"):
        i = names.index(name)
        off, r = pack.offsets[i], pack.rows[i]
        a, b = max(off, shard.r0), min(off + r, shard.r1)
        orig = adam_case(rng, 1, b - a, shard.per, TPT_BLOCK, True)
        kw = dict(layer=0, row_offset=a - shard.r0, hyp=hyp, hp=hp, salt=shift_salt(987654321, (a - off) * TPT_BLOCK),
                  stochastic=True)
        adam_check_case(f"tensor rank 1's {name} rows [{a}, {b}) of the layer pack", orig, kw)
        ss = torch.zeros(1, device="cuda")
        ms = cuda_ms(lambda: fused_adam_rows(*orig, ss=ss, **kw))
        plain_ms = cuda_ms(lambda: fused_adam_rows_reference(*orig, ss=ss, **kw), reps=3, warmup=1)
        n = (b - a) * TPT_BLOCK
        bytes_ms = adam_bytes(b - a, TPT_BLOCK, torch.bfloat16, True) / H100_BYTES_PER_S * 1e3
        ops_ms = n * ADAM_FLOPS_PER_ELEM / H100_FP32_FLOPS * 1e3
        log(f"# tensor parallel training: fused_adam_rows at rank 1's {name} rows ({card}): {b - a} rows from "
            f"row_offset {a - shard.r0}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{max(bytes_ms, ops_ms):.4f} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'})")
        del orig
    torch.cuda.empty_cache()
    rng = np.random.default_rng(10)
    for name, (b_, n, mask) in {"Pi0FAST micro-step": (16, 357, fast_mask(16, 28, rng)),
                                "fused step": (16, 333, prefix_mask(16, 256, 77, rng))}.items():
        q, k, v, mask = attention_case(rng, b_, n, n, 4, 1, 256, torch.bfloat16, mask)
        out = flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        err = (out.float() - flash_attention_reference(q, k, v, mask).float()).abs().max().item()
        ms = cuda_ms(lambda: flash_attention(q, k, v, mask))
        plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, mask), reps=10)
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask[:, None], enable_gqa=True))
        moved = 2 * q.numel() * 2 + 2 * k.numel() * 2 + mask.numel()
        flops = 4 * 4 * 256 * int(mask.sum())
        bound = max(moved / H100_BYTES_PER_S, flops / H100_BF16_FLOPS) * 1e3
        log(f"# tensor parallel training: flash_attention at the {name}'s shape on 4 local heads ({card}): q "
            f"{tuple(q.shape)}, max_abs_err {err:.3e} (atol {KERNEL_ATOL}), kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, sdpa {library_ms:.4f} ms, bound {bound:.4f} ms")
        if not (err <= KERNEL_ATOL and torch.isfinite(out).all()):
            raise SystemExit(f"flash_attention disagrees with its plain version at the {name}'s local heads")
    flash_attention.launches = 0  # comparison launches do not count
    fused_adam_rows.launches = 0


def phase_tensor_parallel_train() -> dict:
    """-> {kernel: launches} of Pi0FAST's standard micro-steps and Pi0's
    fused steps at tensor 2 by two ranks on the one card (gloo, every
    collective staged through the host), summed over the ranks. The one-card
    references (the same functions without a group: the same weights,
    batches, draws and salt) run here first."""
    import shutil
    import socket

    import torch.multiprocessing as mp

    card = gpu_name_and_power()
    tpt_kernel_checks(card)
    shutil.rmtree(TPT_DIR, ignore_errors=True)
    TPT_DIR.mkdir(parents=True)
    try:
        rng = np.random.default_rng(60)
        fast_mc, (_, fused_mc, _) = tpt_fast_config(), tpt_fused_config()
        batch = make_train_batch(rng, fused_mc, TPT_ROWS)
        inputs = {"seed": TPT_SEED, "salt": TPT_SALT,
                  "fast_batches": [{k: torch.from_numpy(np.asarray(v)) for k, v in
                                    make_train_batch(rng, fast_mc, TPT_ROWS).items()} for _ in range(2)],
                  "fused_batch": {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
                  "fused_noise": [torch.from_numpy(rng.standard_normal(batch["actions"].shape, dtype=np.float32))
                                  for _ in range(2)],
                  "fused_time": [torch.from_numpy(rng.uniform(0.1, 0.9, TPT_ROWS).astype(np.float32))
                                 for _ in range(2)]}
        torch.save(inputs, TPT_DIR / "inputs.pt")
        heads, errors = [], []
        t = time.perf_counter()
        with tpt_attention(heads, errors):
            one = {"fast": tpt_fast_steps(DEVICE, None, inputs, heads),
                   "fused": tpt_fused_steps(DEVICE, None, inputs, heads),
                   "fed": tpt_fed_update(DEVICE, None, inputs)}
        log(f"# tensor parallel training: the one-card references in {time.perf_counter() - t:.1f} s, attention "
            f"against its plain version {errors}")
        gc.collect()
        torch.cuda.empty_cache()
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        ctx = mp.start_processes(tpt_rank, args=(2, port, str(TPT_DIR)), nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + TPT_JOIN_S
        while not ctx.join(timeout=max(0.5, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                raise SystemExit(f"the tensor-parallel training ranks did not finish within {TPT_JOIN_S:.0f} s")
        ranks_s = time.perf_counter() - t0
        log(f"# tensor parallel training: the two ranks ran in {ranks_s:.1f} s")
        ranks = [torch.load(TPT_DIR / f"rank{r}.pt", weights_only=False) for r in range(2)]
    finally:
        shutil.rmtree(TPT_DIR, ignore_errors=True)
    return tpt_gates(ranks, one, fast_mc, fused_mc, card)


def tpt_fast_gates(ranks: list, one: dict, mc, card: str) -> None:
    """Pi0FAST's micro-steps on the ranks against one card's."""
    local = mc.vlm.num_heads // 2
    # per micro-step: SigLIP's o and fc2 partials and its two regions' input gradients (4 a layer); the trunk's
    # o and down partials, o's again in the recompute (torch's checkpoint stops recomputing after the last saved
    # tensor, before down's) and its two regions' input gradients (5 a layer); the language and the
    # teacher-forced lookups, the cross entropy's sums, the head's input gradient and the partial leaves' sum
    # (5); the MAX all-reduces of the cross entropy and of the accuracy's argmax (2)
    want_sum, want_max = 4 * mc.vision.depth + 5 * mc.vlm.depth + 5, 2
    want_flash = 2 * mc.vlm.depth  # the checkpointed prefill's forward and recompute
    ref = one["fast"]
    for r, res in enumerate(ranks):
        fast = res["fast"]
        log(f"# tensor parallel training rank {r} Pi0FAST micro-steps (2 fp32 with the plain attention, then 2 bf16 "
            f"with the kernel; {card}): losses {fast['losses']}, token accuracy {fast['accs']}, [grad_norm, "
            f"param_norm] {fast['norms']}, launches and tensor collectives {fast['counts']} (expected per micro-step "
            f"{want_sum} all-reduces, {want_max} MAX all-reduces, {want_flash} flash_attention in bf16), attention "
            f"heads {fast['heads']}, summed over tensor {fast['partial']}, the table a tensor slice "
            f"{fast['table_split']}; {res['fast_s']:.1f} s")
        for i, c in enumerate(fast["counts"]):
            bf16 = i >= 2
            ok = c["tensor_all_reduce"] == want_sum and c["tensor_all_reduce_max"] == want_max
            ok = ok and c["flash_attention"] == (want_flash if bf16 else 0) and c["tensor_all_gather"] == 0
            ok = ok and fast["heads"][i] == ([local] if bf16 else [])
            if not ok:
                raise SystemExit(f"tensor parallel training rank {r} Pi0FAST micro-step {i + 1}: launches or "
                                 f"collectives {c}, heads {fast['heads'][i]}")
        if not (fast["table_split"] and {"vlm/blocks/attn/k/kernel", "siglip/blocks/attn/q/bias"} <= set(
                fast["partial"]) and np.isfinite(fast["losses"] + sum(fast["norms"], [])).all()):
            raise SystemExit(f"tensor parallel training rank {r}: Pi0FAST's split, partial leaves or metrics")
    lead = ranks[0]["fast"]
    if ranks[1]["fast"]["losses"] != lead["losses"] or ranks[1]["fast"]["accs"] != lead["accs"]:
        raise SystemExit("tensor parallel training: the two ranks' Pi0FAST losses differ")
    got, want = np.array(lead["norms"]), np.array(ref["norms"])
    loss_rel = np.abs(np.array(lead["losses"]) / np.array(ref["losses"]) - 1)
    norm_rel = np.abs(got / want - 1)
    params_diff = max((lead["params"][k] - ref["params"][k]).abs().max().item() for k in ref["params"])
    table_rel = rel_l2(lead["table_grad"], ref["table_grad"])
    log(f"# tensor parallel training Pi0FAST against one card: fp32 losses {ref['losses'][:2]} (max rel "
        f"{loss_rel[:2].max():.3e}, rtol {TPT_FP32_RTOL}), norms max rel {norm_rel[:2].max():.3e} (rtol "
        f"{TPT_FP32_RTOL}), token accuracy {ref['accs'][:2]} (equal: {lead['accs'][:2] == ref['accs'][:2]}), params "
        f"after the update max abs {params_diff:.3e} (atol {TPT_PARAMS_ATOL}), the tied table's gradient rel L2 "
        f"{table_rel:.3e} (rtol {TPT_TABLE_RTOL}); bf16 with the kernel losses {ref['losses'][2:]} (max rel "
        f"{loss_rel[2:].max():.3e}, rtol {TP_BF16_LOSS_RTOL}), norms max rel {norm_rel[2:].max():.3e} (rtol "
        f"{TP_BF16_GNORM_RTOL}); one card's launches and collectives {ref['counts']}")
    ok = loss_rel[:2].max() <= TPT_FP32_RTOL and norm_rel[:2].max() <= TPT_FP32_RTOL
    ok = ok and lead["accs"][:2] == ref["accs"][:2] and params_diff <= TPT_PARAMS_ATOL and table_rel <= TPT_TABLE_RTOL
    ok = ok and loss_rel[2:].max() <= TP_BF16_LOSS_RTOL and norm_rel[2:].max() <= TP_BF16_GNORM_RTOL
    if not ok:
        raise SystemExit("tensor parallel training: Pi0FAST's micro-steps disagree with one card's")


def bits_of(x: torch.Tensor) -> torch.Tensor:
    """x, with fp8 codes as their bytes (torch.equal takes no fp8 on the host)."""
    return x.view(torch.uint8) if x.dtype in (torch.float8_e4m3fn, torch.float8_e5m2) else x


def tpt_fused_gates(ranks: list, one: dict, mc, card: str) -> None:
    """The fused steps and the fed update on the ranks against one card's."""
    depth, local = mc.vlm.depth, mc.vlm.num_heads // 2
    ref = one["fused"]
    # per step: the trunk's forward (no gradient) and recomputed pairs with the kernel, the suffix-only last pair
    # plain; the tensor all-reduces: 12 per full layer pair (the two streams' o and down partials in the forward
    # and again in the recompute, their two regions' input gradients), 5 for the last pair, 4 per SigLIP layer
    # and the frozen lookup; the tensor all-gathers: each trunk layer's split leaves joined for its update (2 per
    # layer pair) and each split leaf outside the trunks
    want_flash = 2 * (depth - 1)
    want_sum = 12 * (depth - 1) + 5 + 4 * mc.vision.depth + 1
    for r, res in enumerate(ranks):
        fused = res["fused"]
        want_gather = 2 * depth + fused["split_outside"]
        log(f"# tensor parallel training rank {r} fused steps (bf16 masters, SR, fp8 moments, the kernels; "
            f"{card}): losses {fused['losses']}, grad_norm {fused['gnorms']}, clip {fused['clips']}, launches and "
            f"tensor collectives {fused['counts']} (expected per step fused_adam_rows {fused['want_rows']} from the "
            f"packs' row split, flash_attention {want_flash} on {local} local heads, {want_sum} all-reduces, "
            f"{want_gather} all-gathers), attention heads {fused['heads']}; {res['fused_s']:.1f} s")
        for i, c in enumerate(fused["counts"]):
            ok = c["fused_adam_rows"] == fused["want_rows"] and c["flash_attention"] == want_flash
            ok = ok and c["tensor_all_reduce"] == want_sum and c["tensor_all_gather"] == want_gather
            ok = ok and fused["heads"][i] == [local] and np.isfinite(fused["losses"][i]) and c["tensor_all_reduce_max"] == 0
            if not ok:
                raise SystemExit(f"tensor parallel training rank {r} fused step {i + 1}: launches or collectives {c}")
    a, b = ranks[0]["fused"], ranks[1]["fused"]
    if a["gnorms"] != b["gnorms"] or a["clips"] != b["clips"] or a["losses"] != b["losses"]:
        raise SystemExit(f"tensor parallel training: the ranks' fused grad_norm {a['gnorms']} / {b['gnorms']} or "
                         f"clip {a['clips']} / {b['clips']} differ")
    loss_rel = max(abs(x / y - 1) for x, y in zip(a["losses"], ref["losses"]))
    gnorm_rel = max(abs(x / y - 1) for x, y in zip(a["gnorms"], ref["gnorms"]))
    pk, pp, p0 = a["params"], ref["params"], ref["before"]
    num = sum((pk[k].float() - pp[k].float()).square().sum().item() for k in pp)
    den = sum(pp[k].float().square().sum().item() for k in pp)
    dnum = sum(((pk[k].float() - p0[k].float()) - (pp[k].float() - p0[k].float())).square().sum().item() for k in pp)
    dden = sum((pp[k].float() - p0[k].float()).square().sum().item() for k in pp)
    far = total = 0
    for k, x in ref["moments"].items():
        if x.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            gap = (fp8_index(a["moments"][k]) - fp8_index(x)).abs()
            far += int((gap > 1).sum())
            total += gap.numel()
    share = far / max(total, 1)
    log(f"# tensor parallel training fused steps against one card: losses {ref['losses']} (max rel {loss_rel:.3e}, "
        f"tol {TRAIN_LOSS_RTOL}), grad_norm {ref['gnorms']} (max rel {gnorm_rel:.3e}, tol {TRAIN_GNORM_RTOL}), "
        f"clip {ref['clips']}, params rel L2 {(num / den) ** 0.5:.3e} (tol {TRAIN_PARAMS_RTOL}), update rel L2 "
        f"{(dnum / dden) ** 0.5:.3e} (tol {TRAIN_UPDATE_RTOL}), moment codes more than one apart {share:.3e} of "
        f"{total} (tol {TRAIN_CODES_SHARE}); one card's launches and collectives {ref['counts']}, its row kernel "
        f"launches expected {ref['want_rows']}")
    ok = loss_rel <= TRAIN_LOSS_RTOL and gnorm_rel <= TRAIN_GNORM_RTOL and (num / den) ** 0.5 <= TRAIN_PARAMS_RTOL
    ok = ok and (dnum / dden) ** 0.5 <= TRAIN_UPDATE_RTOL and share <= TRAIN_CODES_SHARE
    ok = ok and all(c["fused_adam_rows"] == ref["want_rows"] for c in ref["counts"])
    if not ok:
        raise SystemExit("tensor parallel training: the fused steps disagree with one card's")
    fed, fed_one = ranks[0]["fed"], one["fed"]
    same_leaves = all(torch.equal(x, y) for x, y in zip(fed["leaves"], fed_one["leaves"]))
    same_moments = all(torch.equal(bits_of(x), bits_of(fed_one["moments"][k])) for k, x in fed["moments"].items())
    moved = sum(not torch.equal(x, y) for x, y in zip(fed["leaves"], fed_one["leaves"]))
    log(f"# tensor parallel training: layer 0 of the VLM trunk fed one card's gradient (bf16, SR, fp8 moments, the "
        f"row kernel on each rank's rows with its salt shifted): params bit-equal {same_leaves} ({moved} leaves "
        f"differ), moments bit-equal {same_moments}; fused_adam_rows launches rank 0 {fed['launches']}, rank 1 "
        f"{ranks[1]['fed']['launches']}, one card {fed_one['launches']}")
    if not (same_leaves and same_moments and fed["launches"] > 0 and ranks[1]["fed"]["launches"] > 0):
        raise SystemExit("tensor parallel training: the fed update is not one card's bit for bit")


def tpt_gates(ranks: list, one: dict, fast_mc, fused_mc, card: str) -> dict:
    """The phase's gates over the two ranks' results -> the path's launches."""
    for r, res in enumerate(ranks):
        if res["backend"] != "gloo" or res["mesh"] != {"data": 1, "fsdp": 1, "tensor": 2}:
            raise SystemExit(f"tensor parallel training rank {r}: group {res['backend']} mesh {res['mesh']}")
        worst = max((e for _, e, _ in res["attention_errors"]), default=float("inf"))
        log(f"# tensor parallel training rank {r}: attention launches against their plain versions (shape, rel L2, "
            f"max abs) {res['attention_errors']} (rel L2 gate {STD_ATTN_RTOL}), {res['staged']} collectives staged "
            f"through the host, peak {res['peak_gib']:.2f} GiB")
        if not worst <= STD_ATTN_RTOL:
            raise SystemExit(f"tensor parallel training rank {r}: an attention launch disagrees with its plain version")
    tpt_fast_gates(ranks, one, fast_mc, card)
    tpt_fused_gates(ranks, one, fused_mc, card)
    totals = {"flash_attention": 0, "fused_adam_rows": 0}
    for res in ranks:
        for path in ("fast", "fused"):
            for c in res[path]["counts"]:
                for k in totals:
                    totals[k] += c[k]
    return totals


# ---------------------------------------------------------------------------
# 4. full-width training
# ---------------------------------------------------------------------------

RECIPE = "config/train/pi0_finetune_bridge_1chip.yaml"
TRAIN_STEPS = 4
# kernel path vs plain path, one step at full width and 4 layers: the two
# round the attention (bf16 P, fp32 sums in another order) at different
# places, which moves the loss and the gradients by ~1e-3 relative; the
# updated parameters differ only where stochastic rounding lands on the other
# side (same salt, nearly the same exact value); a moment code may move by one
# where the gradient moved
TRAIN_LOSS_RTOL = 2e-2
TRAIN_GNORM_RTOL = 5e-2
TRAIN_PARAMS_RTOL = 1e-3  # relative L2 of the parameters after the step
TRAIN_UPDATE_RTOL = 0.5  # relative L2 of the parameter change (mostly +-1 bf16 ulp flips)
TRAIN_CODES_SHARE = 0.05  # share of moment codes more than one code apart


def record_saves(trainer) -> list:
    """Replace trainer.save with a recorder of the update counts it is asked
    at: a save of the full-tower state writes 13-19 GB, and the expert-only
    run of phase 5 covers saving and resuming."""
    saves = []
    trainer.save = lambda: saves.append(trainer.cnt_update)
    return saves


def recipe_config():
    """The 1-chip recipe (config/train/pi0_finetune_bridge_1chip.yaml) with
    the hash tokenizer and a few logged steps."""
    from intact_tpu_torch.config import TrainPipelineConfig, apply_overrides, from_dict, load_yaml

    overrides = {"n_updates": str(TRAIN_STEPS), "log_freq": "1", "tokenizer_path": "hash"}
    return from_dict(TrainPipelineConfig, apply_overrides(load_yaml(RECIPE), overrides))


def expected_row_updates(state, block: int = 2048) -> list[int]:
    """The sizes of the leaves one step updates through fused_adam_rows, one
    entry per launch: every kernel-eligible trunk leaf in every layer, and
    every eligible 8-bit leaf of the head and the embed side."""
    from intact_tpu_torch.ops.fused_adam import eligible
    from intact_tpu_torch.train.fused_joint import EMBED_NAMES, TrunkPack, _is_quant_leaf, tree_items

    sizes = []
    for t in ("vlm", "expert"):
        blocks = state.params[t]["blocks"]
        depth = next(tree_items(blocks))[1].shape[0]
        sizes += depth * [size for size in TrunkPack(blocks, block).sizes if eligible(size, block)]
    for name in EMBED_NAMES + ("action_out_proj",):
        moments = dict(tree_items(state.mu[name], quant_leaves=True))
        sizes += [p.numel() for path, p in tree_items(state.params[name])
                  if _is_quant_leaf(moments[path]) and eligible(p.numel(), block)]
    return sizes


def time_row_update_shapes(sizes: list[int], block: int = 2048) -> float:
    """Each distinct leaf shape of the step (rows of `block`, bf16 p with SR,
    fp8 moments) timed alone: CUDA events around the wrapper and device time
    per call, beside its byte bound; then the step's sum of device time over
    its launches against the bound of all of them. -> that sum, ms. A step
    touches each leaf once, so the calls cycle through copies of the
    arguments, 500 MB in all (ten times the 50 MB L2; 200 MB still left
    the 42 MB leaves partly in L2), and no call finds its bytes there."""
    import itertools
    from collections import Counter

    from intact_tpu_torch.ops.fused_adam import fused_adam_rows
    from intact_tpu_torch.train.optim import OptimizerConfig

    hp = OptimizerConfig(lr=5e-5, weight_decay=0.0)
    hyp = torch.tensor([1 - 0.9**3, 1 - 0.999**3, 5e-5, 0.7], device="cuda")
    ss = torch.zeros(1, device="cuda")
    rng = np.random.default_rng(9)
    step_ms = step_bound = 0.0
    for r, count in sorted(Counter(n // block for n in sizes).items()):
        moved = adam_bytes(r, block, torch.bfloat16, True)
        copies = [adam_case(rng, 1, r, r, block, True) for _ in range(-(-500_000_000 // moved))]
        kw = dict(layer=0, row_offset=0, hyp=hyp, hp=hp, salt=5, stochastic=True)
        cycle = itertools.cycle(copies)
        call = lambda: fused_adam_rows(*next(cycle), ss=ss, **kw)  # noqa: E731
        ms, dev = cuda_ms(call, reps=30), device_ms(call, reps=30, kernel="fused_adam_rows_kernel")
        bound = moved / H100_BYTES_PER_S * 1e3
        step_ms += dev * count
        step_bound += bound * count
        log(f"# fused_adam_rows leaf shape {r} x {block} (x{count} per step): kernel {ms:.4f} ms, device "
            f"{dev:.4f} ms, bound {bound:.4f} ms, device / bound {dev / bound:.3f} ({len(copies)} argument sets)")
        del copies, cycle
    log(f"# fused_adam_rows per training step: {len(sizes)} launches, device time {step_ms:.3f} ms (sum over the "
        f"shapes above) against a bound of {step_bound:.3f} ms ({step_ms / step_bound:.3f}x)")
    torch.cuda.empty_cache()
    return step_ms


def phase_training() -> dict:
    """-> {kernel: launches} on the training path."""
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.ops.fused_adam import fused_adam_rows
    from intact_tpu_torch.train import fused_joint as fj
    from intact_tpu_torch.train.fused_joint import tree_items
    from intact_tpu_torch.train.trainer import Trainer

    cfg = recipe_config()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=DEVICE)
    torch.cuda.synchronize()
    mc = trainer.model_cfg
    n_params = sum(x.numel() for _, x in tree_items(trainer.state.params))
    sizes = expected_row_updates(trainer.state)
    want_adam, adam_elems = len(sizes), sum(sizes)
    want_flash = 2 * (mc.vlm.depth - 1)
    log(f"# training: Pi0 bridge ({mc.vlm.depth}+{mc.expert.depth} trunk layers, SigLIP {mc.vision.depth}), "
        f"{n_params / 1e9:.3f} B params bf16, batch {trainer.micro_batch_size}, init "
        f"{time.perf_counter() - t0:.2f} s; per step expect {want_adam} fused_adam_rows launches over "
        f"{adam_elems / 1e9:.3f} G elements (bound {adam_elems * ADAM_BYTES_PER_ELEM / H100_BYTES_PER_S * 1e3:.3f} ms) "
        f"and {want_flash} flash_attention launches")

    # record each step the trainer takes: its launches, metrics and time
    steps = []
    real_step = trainer.train_step

    def recorded(state, batch):
        f0, a0 = flash_attention.launches, fused_adam_rows.launches
        t = time.perf_counter()
        out = real_step(state, batch)
        torch.cuda.synchronize()
        steps.append((flash_attention.launches - f0, fused_adam_rows.launches - a0,
                      out[1]["l2_loss"].item(), out[1]["grad_norm"].item(), time.perf_counter() - t))
        return out

    trainer.train_step = recorded
    saves = record_saves(trainer)
    keep_reference("fused", trainer)
    torch.cuda.reset_peak_memory_stats()
    # --- the main path: the trainer's loop, as `python -m intact_tpu_torch.run` drives it ---
    flash_attention.launches = fused_adam_rows.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches, "fused_adam_rows": fused_adam_rows.launches}
    # -------------------------------------------------------------------------------------------
    park_reference("fused")
    if saves != [TRAIN_STEPS]:
        raise SystemExit(f"the trainer asked to save at updates {saves}, not at its last update {TRAIN_STEPS}")
    peak = torch.cuda.max_memory_allocated()
    for i, (nf, na, loss, gnorm, dt) in enumerate(steps):
        log(f"# training step {i + 1}: loss {loss:.6f}, grad_norm {gnorm:.6f}, {dt * 1e3:.2f} ms, "
            f"launches flash_attention {nf}, fused_adam_rows {na}")
        if not (np.isfinite(loss) and np.isfinite(gnorm)) or nf != want_flash or na != want_adam:
            raise SystemExit(f"training step {i + 1}: non-finite metrics or unexpected kernel launches")
    if len(steps) != TRAIN_STEPS or launches["fused_adam_rows"] != TRAIN_STEPS * want_adam:
        raise SystemExit(f"{len(steps)} steps, launches {launches}")
    med = statistics.median(dt for *_, dt in steps[1:])
    log(f"# training: median step {med * 1e3:.2f} ms over steps 2..{TRAIN_STEPS} "
        f"({[round(s[-1] * 1e3, 2) for s in steps]}), {trainer.micro_batch_size / med:.2f} samples/s; "
        f"loop wall {wall:.2f} s for {TRAIN_STEPS} steps incl. data; peak device memory {peak / 2**30:.2f} GiB")
    batch = trainer.device_batch(next(iter(trainer.train_data)))
    rows = []  # the leaf row count of each row-update launch of the profiled step, in order
    real_update = fj.fused_adam_rows

    def recording(p, *args, **kw):
        rows.append(p.shape[1])
        return real_update(p, *args, **kw)

    fj.fused_adam_rows = recording
    try:
        totals, per_launch, _ = profile_pass("training step", lambda: (real_step(trainer.state, batch),
                                                                    torch.cuda.synchronize()),
                                          in_order="fused_adam_rows_kernel")
    finally:
        fj.fused_adam_rows = real_update
    adam_ms, adam_n = totals.get("fused_adam_rows_kernel", (0.0, 0))
    log(f"# training profile: fused_adam_rows_kernel {adam_ms:.3f} ms of device time over {adam_n} launches in one "
        f"step, bound {adam_elems * ADAM_BYTES_PER_ELEM / H100_BYTES_PER_S * 1e3:.3f} ms")
    if len(rows) == len(per_launch):
        by_rows = {}
        for i, (r, ms) in enumerate(zip(rows, per_launch)):
            by_rows.setdefault(r, []).append((ms, i))
        for r, entries in sorted(by_rows.items()):
            times = [ms for ms, _ in entries]
            bound = adam_bytes(r, 2048, torch.bfloat16, True) / H100_BYTES_PER_S * 1e3
            slow = ", ".join(f"#{i} {ms:.4f}" for ms, i in sorted(entries, reverse=True)[:4])
            log(f"#   in the step, leaf shape {r} x 2048: x{len(times)}, {sum(times):.3f} ms, median "
                f"{statistics.median(times):.4f} ms per launch (min {min(times):.4f}; slowest, by launch index "
                f"in the step: {slow}), bound {bound:.4f} ms")
    else:
        log(f"#   {len(rows)} row-update calls against {len(per_launch)} profiled launches: no per-shape split")
    del trainer, batch
    gc.collect()  # the recorders installed on the trainer refer back to it
    torch.cuda.empty_cache()
    time_row_update_shapes(sizes)
    compare_training_paths()
    train_fp32_masters(want_adam)
    return launches


def train_fp32_masters(want_adam: int, steps: int = 2) -> None:
    """The 1-chip recipe with master_dtype float32 (fp32 trainable
    parameters, no stochastic rounding; the frozen embedding in bf16) through
    the Trainer for a few steps: finite loss and grad norm, and the row
    kernel launched for every eligible leaf, now on fp32 p and g."""
    from intact_tpu_torch.config import TrainPipelineConfig, apply_overrides, from_dict, load_yaml
    from intact_tpu_torch.ops.fused_adam import fused_adam_rows
    from intact_tpu_torch.train.fused_joint import tree_items
    from intact_tpu_torch.train.trainer import Trainer

    overrides = {"n_updates": str(steps), "log_freq": "1", "tokenizer_path": "hash", "master_dtype": "float32"}
    cfg = from_dict(TrainPipelineConfig, apply_overrides(load_yaml(RECIPE), overrides))
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, device=DEVICE)
    dtypes = {str(x.dtype) for path, x in tree_items(trainer.state.params["vlm"]["blocks"])}
    records = []
    real_step = trainer.train_step

    def recorded(state, batch):
        a0 = fused_adam_rows.launches
        out = real_step(state, batch)
        torch.cuda.synchronize()
        records.append((fused_adam_rows.launches - a0, out[1]["l2_loss"].item(), out[1]["grad_norm"].item()))
        return out

    trainer.train_step = recorded
    record_saves(trainer)
    t0 = time.perf_counter()
    trainer.train()
    wall = time.perf_counter() - t0
    log(f"# training with fp32 masters (VLM trunk {sorted(dtypes)}, bf16_masters {trainer.bf16_masters}): "
        + "; ".join(f"step {i + 1} loss {loss:.6f} grad_norm {gn:.6f} fused_adam_rows {n}"
                    for i, (n, loss, gn) in enumerate(records))
        + f"; {wall:.2f} s for {steps} steps; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if (dtypes != {"torch.float32"} or trainer.bf16_masters or len(records) != steps
            or any(n != want_adam or not (np.isfinite(loss) and np.isfinite(gn)) for n, loss, gn in records)):
        raise SystemExit("the fp32-master training run did not take its steps through the row kernel")
    del trainer
    gc.collect()  # the recorders installed on the trainer refer back to it
    torch.cuda.empty_cache()


def compare_training_paths(depth: int = 4) -> None:
    """One fused step at full width and `depth` layers through the kernels
    (flash attention, fused_adam_rows) and through their plain versions
    (plain attention; the row update's plain math, `fused_rows_update` with
    exact scales, which fused_adam_rows_reference runs), from the same
    params, batch, noise, time and salt."""
    from intact_tpu_torch.config.pipeline import optimizer_config_from_model_json
    from intact_tpu_torch.data.dataset import InterleavedDataset
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.pi0 import model as pi0
    from intact_tpu_torch.models.tokenizer import HashTokenizer
    from intact_tpu_torch.train import fused_joint as fj
    from intact_tpu_torch.train.trainer import preprocess_batch

    cfg = recipe_config()
    full = cfg.make_model_config()
    mc = dataclasses.replace(full, vlm=dataclasses.replace(full.vlm, depth=depth),
                             expert=dataclasses.replace(full.expert, depth=depth),
                             vision=dataclasses.replace(full.vision, depth=depth))
    opt = optimizer_config_from_model_json(cfg.model_cfg, cfg)
    policy = cm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.bfloat16)
    data = InterleavedDataset(cfg.data, 16, seed=7, image_size=mc.vision.image_size)
    raw = preprocess_batch(next(iter(data)), HashTokenizer(mc.vlm.vocab_size, mc.tokenizer_max_length), mc)
    batch = {k: torch.from_numpy(np.asarray(v)).to(DEVICE) for k, v in raw.items()}
    rng = np.random.default_rng(8)
    noise = torch.from_numpy(rng.standard_normal(batch["actions"].shape, dtype=np.float32)).to(DEVICE)
    time_ = pi0.sample_time(rng, 16, mc, DEVICE)
    runs = {}
    for name, attn, mode in (("kernel", "pallas", "on"), ("plain", "xla", "off")):
        params = pi0.init(mc, seed=1, device=DEVICE, dtype=torch.bfloat16)
        before = {k: v.clone() for k, v in fj.tree_items(params)}
        state = fj.init_fused_state(params, seed=1)
        state.count = opt.warmup_steps  # past warmup: lr at its peak
        step = fj.make_fused_joint_step(dataclasses.replace(mc, attention_impl=attn), opt, policy,
                                        stochastic_rounding=True, pallas_mode=mode, scale_mode="exact")
        state, metrics = step(state, batch, noise=noise, time=time_, salt=12345)
        torch.cuda.synchronize()
        runs[name] = (state, metrics, before)
    (sk, mk, before), (sp, mp, _) = runs["kernel"], runs["plain"]
    loss_rel = abs(mk["l2_loss"].item() - mp["l2_loss"].item()) / abs(mp["l2_loss"].item())
    gnorm_rel = abs(mk["grad_norm"].item() - mp["grad_norm"].item()) / mp["grad_norm"].item()
    pk, pp = dict(fj.tree_items(sk.params)), dict(fj.tree_items(sp.params))
    num = sum((pk[k].float() - pp[k].float()).square().sum().item() for k in pp)
    den = sum(pp[k].float().square().sum().item() for k in pp)
    dnum = sum(((pk[k].float() - before[k].float()) - (pp[k].float() - before[k].float())).square().sum().item()
               for k in pp)
    dden = sum((pp[k].float() - before[k].float()).square().sum().item() for k in pp)
    far = total = 0
    for tree in ("mu", "nu"):
        qk = dict(fj.tree_items(getattr(sk, tree), quant_leaves=True))
        qp = dict(fj.tree_items(getattr(sp, tree), quant_leaves=True))
        for k, node in qp.items():
            if fj._is_quant_leaf(node) and node["q"].dtype != torch.float32:
                gap = (fp8_index(qk[k]["q"]) - fp8_index(node["q"])).abs()
                far += int((gap > 1).sum())
                total += gap.numel()
    share = far / total
    log(f"# training kernel vs plain path (full width, {depth} layers, batch 16, one step, same params, batch, "
        f"noise, time and salt): loss {mk['l2_loss'].item():.6f} vs {mp['l2_loss'].item():.6f} (rel {loss_rel:.3e}, "
        f"tol {TRAIN_LOSS_RTOL}), grad_norm rel {gnorm_rel:.3e} (tol {TRAIN_GNORM_RTOL}), params rel L2 "
        f"{(num / den) ** 0.5:.3e} (tol {TRAIN_PARAMS_RTOL}), update rel L2 {(dnum / dden) ** 0.5:.3e} "
        f"(tol {TRAIN_UPDATE_RTOL}), moment codes more than one apart {share:.3e} of {total} (tol {TRAIN_CODES_SHARE})")
    if not (loss_rel <= TRAIN_LOSS_RTOL and gnorm_rel <= TRAIN_GNORM_RTOL and (num / den) ** 0.5 <= TRAIN_PARAMS_RTOL
            and (dnum / dden) ** 0.5 <= TRAIN_UPDATE_RTOL and share <= TRAIN_CODES_SHARE):
        raise SystemExit("the training step through the kernels disagrees with the plain path")


# ---------------------------------------------------------------------------
# 5a. the RLDS training-data path without TensorFlow: the host codec's
#     self-checks, a BridgeV2-shaped directory written by the port's writer,
#     and the train-path loader's figures
# ---------------------------------------------------------------------------

RLDS_DIR = Path(".chip_smoke_rlds")  # the phase's RLDS directory (git-ignored), removed after phase 5
RLDS_EPISODES = 64
RLDS_STEPS = (34, 43)  # steps per episode, drawn in [34, 43): ~38, as BridgeV2's
RLDS_SIZE = 256  # BridgeV2's 256 x 256 frames, JPEG at quality 95
RLDS_CAMERAS = ("image_0", "image_1")  # the registry's bridge entry: primary and secondary
PARAPHRASES = "config/dataset/bridge_paraphrases.json"
# the recipe's 200,000-frame shuffle buffer would cycle the directory's 2,432
# frames ~80 times before the first batch: cut to about one pass
RLDS_OVERRIDES = {"data.backend": "rlds", "data.train.data_path": RLDS_DIR, "data.train.shuffle_buffer_size": 2400,
                  "task_paraphrase": "true", "data.paraphrase_json": PARAPHRASES}
JPEG_PSNR_FLOOR = 30.0  # dB at quality 95 on the phase's frames (noise sigma 6; reading ~33 dB)
LOADER_BATCHES = 6  # timed batches of the micro-batch after a first, buffer-filling one


def scene_frames(rng: np.random.Generator, steps: int, size: int = RLDS_SIZE) -> np.ndarray:
    """uint8 [steps, size, size, 3]: a lit table (gradients), a few coloured
    blocks and a gripper-like bar that moves, sensor noise (sigma 6, from a
    bank of 8 fields per episode: drawing a field per frame would cost more
    than encoding it)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    base = np.stack([xx / size * 200 + 20, yy / size * 180 + 30, (xx + yy) / (2 * size) * 150 + 50], -1)
    for _ in range(4):
        y0, x0, s = rng.integers(0, size - 48), rng.integers(0, size - 48), rng.integers(16, 48)
        base[y0:y0 + s, x0:x0 + s] = rng.integers(0, 255, 3)
    base = base.astype(np.int16)
    noise = np.rint(rng.normal(0, 6, (8, size, size, 3))).astype(np.int16)
    out = np.empty((steps, size, size, 3), np.uint8)
    y, x = rng.uniform(40, size - 40, 2)
    for t in range(steps):
        y, x = np.clip([y + rng.normal(0, 4), x + rng.normal(0, 4)], 20, size - 20)
        img = base + noise[t % 8]
        img[int(y) - 20:int(y) + 20, int(x) - 4:int(x) + 4] = 40
        out[t] = np.clip(img, 0, 255)
    return out


def bridge_episodes(seed: int, instructions: list[str]):
    rng = np.random.default_rng(seed)
    for i in range(RLDS_EPISODES):
        steps = int(rng.integers(*RLDS_STEPS))
        state = np.cumsum(rng.normal(0, 0.01, (steps, 7)), 0).astype(np.float32)
        state[:, 6] = rng.uniform(0, 1, steps)
        action = np.concatenate([rng.normal(0, 0.01, (steps, 6)), rng.uniform(0, 1, (steps, 1))], 1)
        yield {"observation": {cam: scene_frames(rng, steps) for cam in RLDS_CAMERAS} | {"state": state},
               "action": action.astype(np.float32),
               "language_instruction": np.array([instructions[i % len(instructions)]] * steps)}


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(((a.astype(np.float64) - b) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def codec_self_checks(rng: np.random.Generator) -> None:
    """JPEG round trips above the PSNR floor (the writer's 4:2:0 at 256 px,
    and edge MCUs at 257 x 255), PNG round trips bit-exact, a corrupted
    record raises."""
    from intact_tpu_torch.data import codec, tfrecord_rlds

    frame = scene_frames(rng, 1)[0]
    odd = scene_frames(rng, 1, 257)[0][:, :255]
    for label, img in (("256x256", frame), ("257x255", odd)):
        data = codec.encode_jpeg(img, 95)
        t = time.perf_counter()
        dec = codec.decode_image(data)
        ms = (time.perf_counter() - t) * 1e3
        p = psnr(dec, img)
        log(f"# codec: JPEG q95 {label} {len(data)} bytes, PSNR {p:.2f} dB (floor {JPEG_PSNR_FLOOR}), decode "
            f"{ms:.2f} ms")
        if dec.shape != img.shape or not p >= JPEG_PSNR_FLOOR:
            raise SystemExit(f"codec: JPEG round trip {label} PSNR {p:.2f} dB < {JPEG_PSNR_FLOOR}")
    for c in (1, 2, 3, 4):
        img = rng.integers(0, 256, (37, 41, c), dtype=np.uint8)
        dec = codec.decode_image(codec.encode_png(img))
        want = img[..., :1].repeat(3, -1) if c <= 2 else img[..., :3]
        if not np.array_equal(dec, want):
            raise SystemExit(f"codec: PNG round trip with {c} channels not bit-exact")
    rec = bytearray(tfrecord_rlds.frame_record(codec.encode_jpeg(frame)))
    rec[100] ^= 0x01
    bad = RLDS_DIR / "corrupt.tfrecord"
    bad.write_bytes(bytes(rec))
    try:
        list(tfrecord_rlds.iter_records(bad))
    except tfrecord_rlds.RecordError as e:
        log(f"# codec: a corrupted record raises: {e}")
    else:
        raise SystemExit("codec: a corrupted record read without an error")
    finally:
        bad.unlink()
    log("# codec: PNG round trips (1-4 channels) bit-exact")


def check_batch(batch: dict, b: int, size: int, table: dict) -> float:
    """The train path's batch: shapes, dtypes, ranges; -> the share of
    instructions that are paraphrases."""
    obs = batch["observation"]
    img, prop, act = obs["image_primary"], obs["proprio"], batch["action"]
    lang = [s.decode() for s in batch["task"]["language_instruction"]]
    ok = (img.shape == (b, 1, size, size, 3) and img.dtype == np.uint8 and img.any() and
          prop.shape == (b, 1, 7) and prop.dtype == np.float32 and np.isfinite(prop).all() and
          act.shape == (b, 1, 4, 7) and act.dtype == np.float32 and np.isfinite(act).all() and
          np.abs(act).max() <= 1.0 and batch["action_pad_mask"].shape == act.shape and
          batch["future_action"].shape == (b, 1, 50, 7) and all(lang))
    if not ok:
        raise SystemExit(f"rlds batch: {img.shape} {img.dtype} {prop.shape} {prop.dtype} {act.shape} {act.dtype} "
                         f"|action| max {np.abs(act).max()}, {sum(not s for s in lang)} empty instructions")
    return float(np.mean([s not in table for s in lang]))


def phase_rlds_data() -> dict:
    """-> the loader's figures. Writes RLDS_DIR (removed after phase 5)."""
    import shutil

    from intact_tpu_torch.data import tfrecord_rlds
    from intact_tpu_torch.data.dataset import InterleavedDataset

    shutil.rmtree(RLDS_DIR, ignore_errors=True)
    RLDS_DIR.mkdir(parents=True)
    rng = np.random.default_rng(13)
    codec_self_checks(rng)
    table = json.loads(Path(PARAPHRASES).read_text())
    t = time.perf_counter()
    ds_dir = tfrecord_rlds.write_rlds_dataset(RLDS_DIR, "bridge_dataset", bridge_episodes(13, list(table)),
                                              num_shards=4, image_keys=RLDS_CAMERAS, image_encoding="jpeg")
    wall = time.perf_counter() - t
    size = sum(p.stat().st_size for p in ds_dir.glob("*.tfrecord-*"))
    info = tfrecord_rlds.load_split_info(ds_dir)
    log(f"# rlds: wrote {info} episodes of bridge_dataset ({len(RLDS_CAMERAS)} cameras {RLDS_SIZE} px, JPEG q95, "
        f"4 shards, {size / 2**20:.1f} MiB) in {wall:.2f} s")
    cfg = trainer_config(EXPERT_RECIPE, {**EXPERT_OVERRIDES, **RLDS_OVERRIDES})
    b, size = cfg.per_device_batch_size, cfg.make_model_config().vision.image_size
    t = time.perf_counter()
    ds = InterleavedDataset(cfg.data, b, split="train", seed=cfg.seed, normalization_type="bound", image_size=size,
                            task_paraphrase=True)
    build_s = time.perf_counter() - t
    threads = ds._ds._mix.num_threads
    it = iter(ds)
    try:
        t = time.perf_counter()
        shares = [check_batch(next(it), b, size, table)]
        first_s = time.perf_counter() - t
        before = ds.loader_stats.snapshot()
        t = time.perf_counter()
        for _ in range(LOADER_BATCHES):
            shares.append(check_batch(next(it), b, size, table))
        wall = time.perf_counter() - t
        after = ds.loader_stats.snapshot()
    finally:
        it.close()
    frames = LOADER_BATCHES * b
    d = {k: after[k] - before[k] for k in after}
    card = gpu_name_and_power()
    fig = {"frames_per_s": frames / wall, "threads": threads, "first_batch_s": first_s, "build_s": build_s,
           "read_parse_ms_per_episode": 1e3 * d["read_parse_s"] / max(d["episodes"], 1),
           "decode_ms_per_frame": 1e3 * d["decode_s"] / max(d["frames"], 1),
           "crop_resize_jitter_ms_per_frame": 1e3 * d["transform_s"] / max(d["frames"], 1),
           "paraphrased_share": float(np.mean(shares)), "errors": after["errors"]}
    log(f"# rlds loader ({card}): train path {fig['frames_per_s']:.1f} frames/s over {frames} frames "
        f"({LOADER_BATCHES} batches of {b}) at {threads} threads; statistics and build {build_s:.2f} s, first batch "
        f"(shuffle buffer fill) {first_s:.2f} s")
    log(f"# rlds loader stages ({card}), CPU time summed over threads: read+parse "
        f"{fig['read_parse_ms_per_episode']:.2f} ms per episode ({d['episodes']} episodes), decode "
        f"{fig['decode_ms_per_frame']:.2f} ms per frame ({d['frames']} frames; the recipe loads the primary "
        f"camera), crop-resize-jitter {fig['crop_resize_jitter_ms_per_frame']:.2f} ms per "
        f"frame; {fig['paraphrased_share']:.3f} of instructions paraphrased; {fig['errors']} skipped")
    if fig["errors"] or not 0.0 < fig["paraphrased_share"] < 1.0:
        raise SystemExit(f"rlds loader: {fig}")
    return fig


def loader_contention(steps: int = 6, rounds: int = 2) -> None:
    """Not part of main(); run after phase_rlds_data. Expert-only micro-steps
    at the recipe's micro-batch, one trainer, fed in turns from synthetic
    batches (no loader threads) and from RLDS_DIR with 8, 4 and 2 loader
    threads, each through the trainer's prefetch thread: the median
    micro-step (its next(data) included) and the median wait on next(data)."""
    import copy

    from intact_tpu_torch.data.dataset import InterleavedDataset
    from intact_tpu_torch.train.trainer import Trainer
    from intact_tpu_torch.utils.prefetch import PrefetchIterator

    cfg = trainer_config(EXPERT_RECIPE, {**EXPERT_OVERRIDES, **RLDS_OVERRIDES})
    trainer = Trainer(cfg, device=DEVICE)
    size, card = trainer.model_cfg.vision.image_size, gpu_name_and_power()
    results: dict = {}
    for r in range(rounds):
        order = [0, 8, 4, 2] if r % 2 == 0 else [2, 4, 8, 0]
        for threads in order:
            data_cfg = copy.deepcopy(cfg.data)
            if threads:
                data_cfg.train.num_parallel_calls = threads
            else:
                data_cfg.backend = "synthetic"
            ds = InterleavedDataset(data_cfg, trainer.micro_batch_size, split="train", seed=cfg.seed + r,
                                    normalization_type="bound", image_size=size)
            data = PrefetchIterator(iter(ds), prepare=trainer.device_batch, depth=2)
            try:
                trainer.state, _ = trainer.train_step(trainer.state, next(data))  # not timed: the buffer fill
                torch.cuda.synchronize()
                for _ in range(steps):
                    t0 = time.perf_counter()
                    batch = next(data)
                    t1 = time.perf_counter()
                    trainer.state, _ = trainer.train_step(trainer.state, batch)
                    torch.cuda.synchronize()
                    results.setdefault(threads, []).append((time.perf_counter() - t0, t1 - t0))
            finally:
                data.close()
    for threads, rec in sorted(results.items()):
        label = f"RLDS, {threads} loader threads" if threads else "synthetic batches"
        log(f"# loader contention ({card}): {label}: median micro-step {statistics.median(s for s, _ in rec) * 1e3:.2f} "
            f"ms, median wait on next(data) {statistics.median(w for _, w in rec) * 1e3:.2f} ms, "
            f"{len(rec)} micro-steps of {trainer.micro_batch_size} over {rounds} rounds in turns")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 5. the trainer's standard step: expert-only (frozen int8 prefix) and the
#    standard joint recipe
# ---------------------------------------------------------------------------

EXPERT_RECIPE = "config/train/pi0_finetune_bridge_expertonly.yaml"
JOINT_RECIPE = "config/train/pi0_finetune_bridge.yaml"
RUN_DIR = Path(".chip_smoke_runs")  # the phase's checkpoints (git-ignored), removed after it
EXPERT_OVERRIDES = {"mesh.fsdp": 1, "per_device_batch_size": 96, "global_batch_size": 192, "n_updates": 3,
                    "save_model_freq": 2, "eval_freq": 3, "eval_size": 96}
JOINT_OVERRIDES = {"mesh.fsdp": 1, "per_device_batch_size": 32, "global_batch_size": 64, "n_updates": 2}
# the expert-only path through the kernels against its plain versions, from
# the same resumed state, batches and draws (readings on an H100 80GB HBM3 at
# 700 W, in PERF.md; they repeat to 3 digits from run to run). The W8A8 products are bit-equal to the
# plain ones (phase 2; the prefix cache gate here). Each prefill attention
# launch is within ~1 bf16 ulp of its plain version (rel L2 9.2e-4); the
# int8 activation codes of the next products flip where that moves a value
# across a rounding tie, so the prefix K/V with only the attention plain sits
# at the int8 step's scale (rel L2 1.6e-2 at layer 1, rising to 2.9e-2 at
# the last, 2.5e-2 in all), and is gated at 2x its reading. The rest are ~10x their readings: one
# micro-step's gradient of every trainable leaf, then one update of 2
# micro-steps on loss, grad norm and the trainable update
STD_ATTN_RTOL = 1e-2  # rel L2 of each prefill attention launch
STD_KV_RTOL = 5e-2  # rel L2 of the prefix K and V at the unpadded tokens
STD_GRAD_RTOL = 3e-2  # rel L2 of all trainable gradients (reading 3.6e-3)
STD_LEAF_RTOL = 0.1  # worst trainable leaf's rel L2 (reading 1.25e-2)
STD_LOSS_RTOL = 3e-3  # reading 3.0e-4
STD_GNORM_RTOL = 2e-3  # reading 2.0e-4
STD_UPDATE_RTOL = 4e-2  # reading 4.2e-3


def trainer_config(recipe: str, overrides: dict, model_cfg: dict | None = None):
    """A recipe with the hash tokenizer, a log line per update, checkpoints
    under RUN_DIR, and `overrides`; `model_cfg` replaces its model JSON."""
    from intact_tpu_torch.config import TrainPipelineConfig, apply_overrides, from_dict, load_yaml

    kw = {"tokenizer_path": "hash", "log_freq": 1, "log_dir": RUN_DIR, **overrides}
    d = load_yaml(recipe)
    if model_cfg is not None:
        d["model_cfg"] = dict(model_cfg)
    return from_dict(TrainPipelineConfig, apply_overrides(d, {k: str(v) for k, v in kw.items()}))


def w8a8_per_prefix(params) -> int:
    """W8A8 products of one frozen-prefix pass, counted from the tree: every
    layer of every int8 dense node, less the last VLM layer's nodes other
    than k and v, which the kv_only prefill does not run."""
    from intact_tpu_torch.models.common import flatten_paths

    n = 0
    for path, leaf in flatten_paths(params).items():
        if path.endswith("/kernel_q"):
            n += int(np.prod(leaf.shape[:-2]))
            n -= path.startswith("vlm/blocks/") and not path.startswith(("vlm/blocks/attn/k/", "vlm/blocks/attn/v/"))
    return n


def state_items(state) -> dict:
    """Every tensor and number of a training state, by path."""
    from intact_tpu_torch.models.common import flatten_paths
    from intact_tpu_torch.train.checkpoint import state_fields

    out = {f"params/{k}": v for k, v in flatten_paths(state.params).items()}
    for name, value in state_fields(state).items():
        out.update({f"{name}/{k}": v for k, v in flatten_paths(value).items()} if isinstance(value, dict)
                   else {name: value})
    return out


def record_steps(trainer, counters: dict) -> list:
    """Wrap trainer.train_step: each micro-step appends (launches per counter,
    l2_loss, grad_norm, param_norm, seconds), synchronized."""
    records = []
    real = trainer.train_step

    def recorded(state, batch):
        before = {k: c.launches for k, c in counters.items()}
        t = time.perf_counter()
        out = real(state, batch)
        torch.cuda.synchronize()
        m = out[1]
        records.append(({k: c.launches - before[k] for k, c in counters.items()}, m["l2_loss"].item(),
                         m["grad_norm"].item(), m["param_norm"].item(), time.perf_counter() - t))
        return out

    trainer.train_step = recorded
    return records


def report_steps(label: str, records: list, accum: int, global_batch: int) -> None:
    for i, (n, loss, gn, pn, dt) in enumerate(records):
        log(f"# {label} micro-step {i + 1}: loss {loss:.6f}, grad_norm {gn:.6f}, param_norm {pn:.3f}, "
            f"{dt * 1e3:.2f} ms, launches {n}")
    micro = [dt for *_, dt in records[1:]]
    updates = [sum(r[-1] for r in records[i:i + accum]) for i in range(accum, len(records), accum)]
    med_u = statistics.median(updates)
    log(f"# {label}: median micro-step {statistics.median(micro) * 1e3:.2f} ms over micro-steps 2..{len(records)}, "
        f"median update ({accum} micro-steps) {med_u * 1e3:.2f} ms over updates 2..{len(records) // accum}, "
        f"{global_batch / med_u:.2f} samples/s; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def phase_standard_training() -> dict:
    """-> {kernel: launches} on the standard step's two recipes (the
    expert-only one fed from phase_rlds_data's RLDS_DIR)."""
    import shutil

    if not (RLDS_DIR / "bridge_dataset").exists():
        raise SystemExit(f"{RLDS_DIR}/bridge_dataset is missing: run phase_rlds_data first")
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    try:
        expert = train_expert_only()
        joint = train_standard_joint()
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)  # phase 5b reads RLDS_DIR and removes it
    return {"flash_attention": expert["flash_attention"] + joint["flash_attention"],
            "w8a8_matmul": expert["w8a8_matmul"]}


def train_expert_only() -> dict:
    """pi0_finetune_bridge_expertonly.yaml through the Trainer: 3 updates of 2
    micro-steps of 96, validation at update 3, saves at 2 and 3, then a
    resume from step_3 and the kernel-vs-plain comparisons."""
    from intact_tpu_torch.models.common import flatten_paths
    from intact_tpu_torch.ops import w8a8
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.train import checkpoint as ckpt
    from intact_tpu_torch.train.trainer import Trainer

    cfg = trainer_config(EXPERT_RECIPE, {**EXPERT_OVERRIDES, **RLDS_OVERRIDES})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=DEVICE)
    if trainer.train_data.backend != "rlds" or trainer.train_data.rephraser is None:
        raise SystemExit(f"expert-only: data backend {trainer.train_data.backend}, paraphrasing "
                         f"{trainer.train_data.rephraser is not None}")
    table = json.loads(Path(PARAPHRASES).read_text())
    paraphrased = []
    real_device_batch = trainer.device_batch

    def checked_device_batch(raw):  # the prefetch thread's raw RLDS batches, checked on the way
        paraphrased.append(check_batch(raw, trainer.micro_batch_size, mc.vision.image_size, table))
        return real_device_batch(raw)

    trainer.device_batch = checked_device_batch
    torch.cuda.synchronize()
    mc, accum = trainer.model_cfg, trainer.opt_cfg.grad_accumulation_steps
    params = flatten_paths(trainer.state.params)
    frozen = {k for k, t in flatten_paths(trainer.frozen_mask).items() if not t}
    before = {k: v.clone() for k, v in params.items()}
    want_w8a8, want_flash = w8a8_per_prefix(trainer.state.params), mc.vlm.depth - 1
    n_int8 = sum(v.numel() for v in params.values() if v.dtype == torch.int8)
    n_train = sum(v.numel() for k, v in params.items() if k not in frozen)
    log(f"# expert-only: {EXPERT_RECIPE} ({mc.vlm.depth}+{mc.expert.depth} trunk layers, SigLIP {mc.vision.depth}), "
        f"{n_int8 / 1e9:.3f} B int8 frozen weights, {n_train / 1e6:.1f} M trainable fp32 params, micro-batch "
        f"{trainer.micro_batch_size} x accumulation {accum}, init {time.perf_counter() - t0:.2f} s; per micro-step "
        f"expect {want_w8a8} w8a8_matmul (counted from the tree) and {want_flash} flash_attention launches")

    counters = {"flash_attention": flash_attention, "w8a8_matmul": w8a8.w8a8_matmul}
    records = record_steps(trainer, counters)
    calls = []  # (host time, seconds waited on next(data) so far) at each micro-step's start
    recorded = trainer.train_step

    def timed_step(state, batch):
        calls.append((time.perf_counter(), trainer.data_wait_s))
        return recorded(state, batch)

    trainer.train_step = timed_step
    validations = []
    real_validate = trainer.validate

    def validate():
        before_n = {k: c.launches for k, c in counters.items()}
        metrics = real_validate()
        validations.append((metrics, {k: c.launches - before_n[k] for k, c in counters.items()}))
        return metrics

    trainer.validate = validate
    keep_reference("expert-only", trainer)
    # --- the main path: the trainer's loop, as `python -m intact_tpu_torch.run` drives it ---
    flash_attention.launches = w8a8.w8a8_matmul.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches, "w8a8_matmul": w8a8.w8a8_matmul.launches}
    # -------------------------------------------------------------------------------------------
    park_reference("expert-only")
    report_steps("expert-only", records, accum, cfg.global_batch_size)
    log(f"# expert-only: loop wall {wall:.2f} s for {cfg.n_updates} updates incl. data, validation and saves; "
        f"launches {launches}")
    card = gpu_name_and_power()
    calls.append((t0 + wall, trainer.data_wait_s))
    for u in range(cfg.n_updates):  # from the start of its first micro-step to the next update's
        (ta, wa), (tb, wb) = calls[u * accum], calls[(u + 1) * accum]
        log(f"# expert-only from RLDS ({card}): update {u + 1} wall {tb - ta:.3f} s, waiting on next(data) "
            f"{wb - wa:.3f} s ({(wb - wa) / (tb - ta):.1%}){', with the saves or validation after it' if u else ''}")
    log(f"# expert-only from RLDS ({card}): the first batch's wait (statistics, shuffle buffer fill) "
        f"{calls[0][1]:.3f} s")
    log(f"# expert-only from RLDS ({card}): loop waited {trainer.data_wait_s:.3f} s of {wall:.2f} s on next(data) "
        f"({trainer.data_wait_s / wall:.1%}); {len(paraphrased)} batches checked, {np.mean(paraphrased):.3f} of "
        f"instructions paraphrased; loader {trainer.train_data.loader_stats.snapshot()}")
    if not paraphrased or not 0.0 < np.mean(paraphrased) < 1.0 or trainer.train_data.loader_stats.errors:
        raise SystemExit(f"expert-only from RLDS: paraphrased shares {paraphrased}, "
                         f"{trainer.train_data.loader_stats.errors} frames skipped")
    n_val = max(1, cfg.eval_size // trainer.micro_batch_size)
    for metrics, n in validations:
        log(f"# expert-only validation at update 3: {metrics}, launches {n}")
    bad = [i + 1 for i, (n, loss, gn, pn, _) in enumerate(records)
           if not (np.isfinite(loss) and np.isfinite(gn) and np.isfinite(pn))
           or n != {"flash_attention": want_flash, "w8a8_matmul": want_w8a8}]
    if bad or len(records) != cfg.n_updates * accum:
        raise SystemExit(f"expert-only micro-steps {bad}: non-finite metrics or unexpected launches "
                         f"({len(records)} micro-steps)")
    if (len(validations) != 1 or validations[0][1] != {"flash_attention": n_val * want_flash,
                                                       "w8a8_matmul": n_val * want_w8a8}
            or not np.isfinite(validations[0][0]["l1_loss"])
            or [k for k in validations[0][0] if k.startswith("acc@")] != [f"acc@{t}" for t in cfg.eval_thresholds]):
        raise SystemExit(f"expert-only validation: {validations}")
    after = flatten_paths(trainer.state.params)
    changed_frozen = [k for k in frozen if not torch.equal(after[k], before[k])]
    moved = sum(not torch.equal(after[k], before[k]) for k in after if k not in frozen)
    log(f"# expert-only: {len(frozen)} frozen leaves ({sum(before[k].dtype == torch.int8 for k in frozen)} int8), "
        f"{len(changed_frozen)} changed; {moved} of {len(after) - len(frozen)} trainable leaves moved")
    if changed_frozen or moved < (len(after) - len(frozen)) // 2:
        raise SystemExit(f"expert-only: frozen leaves changed {changed_frozen[:5]} or too few trainable moved ({moved})")
    del before
    steps = ckpt.list_steps(trainer.ckpt_root, committed_only=True)
    resumed = Trainer(trainer_config(EXPERT_RECIPE, {**EXPERT_OVERRIDES, **RLDS_OVERRIDES,
                                                     "load_from_checkpoint": trainer.ckpt_root / "step_3"}),
                      device=DEVICE)
    ia, ib = state_items(trainer.state), state_items(resumed.state)
    unequal = [k for k, v in ia.items()
               if not (torch.equal(v, ib[k]) if isinstance(v, torch.Tensor) else v == ib.get(k))]
    log(f"# expert-only checkpoints {steps}; resumed from step_3: cnt_update {resumed.cnt_update}, "
        f"{len(ia)} state entries, {len(unequal)} unequal")
    if steps != [2, 3] or resumed.cnt_update != 3 or set(ia) != set(ib) or unequal:
        raise SystemExit(f"expert-only checkpoints {steps} / resume: cnt_update {resumed.cnt_update}, unequal {unequal[:5]}")
    compare_expert_paths(trainer, resumed)
    batch = trainer.device_batch(next(iter(trainer.train_data)))
    profile_pass("expert-only micro-step", lambda: (trainer.train_step(trainer.state, batch), torch.cuda.synchronize()))
    # the bound validate, device_batch and train_step would keep the trainer past gc.collect
    del trainer, resumed, batch, real_validate, real_device_batch, recorded
    gc.collect()  # the recorders installed on the trainer refer back to it
    torch.cuda.empty_cache()
    return launches


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64."""
    den = b.double().norm().item()
    return (a.double() - b.double()).norm().item() / den if den > 0 else float(a.ne(b).any())


def trainable_grads(trainer, cfg, batch) -> dict:
    """One micro-step's gradient of every trainable leaf at the trainer's
    state, with that micro-step's draws, as its train_step forms it."""
    from intact_tpu_torch.models.common import flatten_paths, unflatten_paths
    from intact_tpu_torch.models.pi0 import model as pi0

    flat = flatten_paths(trainer.state.params)
    views = {k: flat[k].detach().requires_grad_() for k in trainer.tx.paths(flat)}
    draws = np.random.default_rng((trainer.state.seed, trainer.state.step))
    with torch.enable_grad():
        loss, _ = pi0.compute_loss(unflatten_paths({**flat, **views}), draws, batch, cfg, trainer.policy)
        grads = torch.autograd.grad(loss, list(views.values()), allow_unused=True, materialize_grads=True)
    return dict(zip(views, grads))


def compare_expert_paths(kernel, plain) -> None:
    """Two trainers at the same state: the frozen prefix cache with the W8A8
    kernel against the same pass with only the W8A8 product plain
    (bit-equal) and with only the attention plain (STD_KV_RTOL); one
    micro-step's trainable gradients through the kernels against through
    their plain versions (STD_GRAD_RTOL, STD_LEAF_RTOL); then one update (two
    micro-steps on the same batches) through the kernels against one through
    the plain versions (loss, grad norm, update)."""
    from intact_tpu_torch.models.common import flatten_paths
    from intact_tpu_torch.models.pi0 import model as pi0
    from intact_tpu_torch.ops import attention, w8a8
    from intact_tpu_torch.ops.flash_attention import flash_attention_reference
    from intact_tpu_torch.train import train_step as ts

    mc = kernel.model_cfg
    real_attn = attention.flash_attention
    plain_cfg = dataclasses.replace(mc, attention_impl="xla")
    data = iter(kernel.train_data)
    batches = [kernel.device_batch(next(data)) for _ in range(2)]
    inputs = [batches[0][k] for k in ("images", "img_masks", "lang_tokens", "lang_masks")]
    real = w8a8.w8a8_matmul

    attn_errs = []  # each prefill launch against the plain version on its own inputs

    def checked_attention(q, k, v, mask=None, scale=None):
        out = real_attn(q, k, v, mask, scale)
        ref = flash_attention_reference(q, k, v, mask, scale)
        attn_errs.append((rel_l2(out, ref), (out.float() - ref.float()).abs().max().item(),
                          ref.float().abs().max().item(), bool(torch.isfinite(out).all())))
        return out

    with torch.no_grad():
        attention.flash_attention = checked_attention
        try:
            (k1, v1), _ = pi0.prefix_cache(kernel.state.params, *inputs, mc, kernel.policy)
        finally:
            attention.flash_attention = real_attn
        worst = max(attn_errs)
        log(f"# expert-only prefill attention kernel vs its plain version on each launch's own inputs (batch "
            f"{inputs[0].shape[0]}, {len(attn_errs)} launches): worst rel L2 {worst[0]:.3e} (tol "
            f"{STD_ATTN_RTOL}), max abs err {max(e[1] for e in attn_errs):.3e} (max |out| "
            f"{max(e[2] for e in attn_errs):.3e}), per launch {[f'{e[0]:.1e}' for e in attn_errs]}")
        if len(attn_errs) != mc.vlm.depth - 1 or not all(e[3] for e in attn_errs) or worst[0] > STD_ATTN_RTOL:
            raise SystemExit(f"the prefill's attention kernel disagrees with its plain version: {attn_errs}")
        w8a8.w8a8_matmul = plain_w8a8
        try:
            (k2, v2), _ = pi0.prefix_cache(kernel.state.params, *inputs, mc, kernel.policy)
        finally:
            w8a8.w8a8_matmul = real
        same = torch.equal(k1, k2) and torch.equal(v1, v2)
        del k2, v2
        (k3, v3), pre_pad = pi0.prefix_cache(kernel.state.params, *inputs, plain_cfg, kernel.policy)
        # [layer, batch, token, kv head, dim] at the tokens a query reads: a
        # padded token's query row is fully masked, which the kernel answers
        # with 0 and the plain attention with the mean of V, so its K/V from
        # the next layer on differ by design and are never read
        ka, va, kp, vp = (c[:, pre_pad] for c in (k1, v1, k3, v3))
    kv_rel = {"K": rel_l2(ka, kp), "V": rel_l2(va, vp)}
    layer_rel = [max(rel_l2(ka[i], kp[i]), rel_l2(va[i], vp[i])) for i in range(ka.shape[0])]
    kv_abs = {"K": (ka.float() - kp.float()).abs().max().item(), "V": (va.float() - vp.float()).abs().max().item()}
    log(f"# expert-only prefix K/V cache {tuple(k1.shape)} {k1.dtype}: W8A8 kernel vs plain W8A8 product "
        f"bit-equal {same} (gate: bit-equal); attention kernel vs plain attention (W8A8 kernel on both sides) "
        f"at the {int(pre_pad.sum())} unpadded tokens: rel L2 K {kv_rel['K']:.3e} V {kv_rel['V']:.3e} (tol "
        f"{STD_KV_RTOL}), per layer {[f'{r:.1e}' for r in layer_rel]}, max abs err K {kv_abs['K']:.3e} V "
        f"{kv_abs['V']:.3e} (max |K| {kp.float().abs().max().item():.3e}, |V| {vp.float().abs().max().item():.3e}); "
        f"all tokens rel L2 K {rel_l2(k1, k3):.3e} V {rel_l2(v1, v3):.3e}")
    del k1, v1, k3, v3, ka, va, kp, vp
    if not same:
        raise SystemExit("the frozen prefix cache with the W8A8 kernel differs from the one with its plain version")
    if not max(kv_rel.values()) <= STD_KV_RTOL:
        raise SystemExit(f"the frozen prefix cache with the attention kernel differs from the plain one: {kv_rel}")

    gk = trainable_grads(kernel, mc, batches[0])
    w8a8.w8a8_matmul = plain_w8a8
    try:
        gp = trainable_grads(plain, plain_cfg, batches[0])
    finally:
        w8a8.w8a8_matmul = real
    num = sum((gk[k].double() - gp[k].double()).square().sum().item() for k in gp)
    den = sum(g.double().square().sum().item() for g in gp.values())
    grad_rel = (num / den) ** 0.5 if den > 0 else float("inf")
    leaf_rel = sorted(((rel_l2(gk[k], gp[k]), k) for k in gp), reverse=True)
    log(f"# expert-only kernel vs plain path, one micro-step's gradients of the {len(gp)} trainable leaves "
        f"(resumed state, same batch and draws): rel L2 {grad_rel:.3e} (tol {STD_GRAD_RTOL}), worst leaves "
        f"{[(k, f'{r:.3e}') for r, k in leaf_rel[:3]]} (tol {STD_LEAF_RTOL}), median leaf "
        f"{leaf_rel[len(leaf_rel) // 2][0]:.3e}")
    del gk, gp
    if not (grad_rel <= STD_GRAD_RTOL and leaf_rel[0][0] <= STD_LEAF_RTOL):
        raise SystemExit("the expert-only gradients through the kernels disagree with the plain path")

    plain.train_step = ts.make_train_step(
        lambda p, rng, b, n, t: pi0.compute_loss(p, rng, b, plain_cfg, plain.policy, noise=n, time=t), plain.tx)
    trainable = [k for k, t in flatten_paths(kernel.frozen_mask).items() if t]
    before = {k: flatten_paths(kernel.state.params)[k].clone() for k in trainable}
    out = {}
    for name, trainer in (("kernel", kernel), ("plain", plain)):
        metrics = []
        if name == "plain":
            w8a8.w8a8_matmul = plain_w8a8
        try:
            for b in batches:
                trainer.state, m = trainer.train_step(trainer.state, b)
                metrics.append((m["l2_loss"].item(), m["grad_norm"].item()))
        finally:
            w8a8.w8a8_matmul = real
        torch.cuda.synchronize()
        out[name] = (metrics, flatten_paths(trainer.state.params))
    (mk, pk), (mp, pp) = out["kernel"], out["plain"]
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(mk, mp))
    gnorm_rel = max(abs(a[1] - b[1]) / b[1] for a, b in zip(mk, mp))
    num = sum(((pk[k] - before[k]) - (pp[k] - before[k])).double().square().sum().item() for k in trainable)
    den = sum((pp[k] - before[k]).double().square().sum().item() for k in trainable)
    upd_rel = (num / den) ** 0.5 if den > 0 else float("inf")
    log(f"# expert-only kernel vs plain path (one update of 2 micro-steps from the resumed state, same batches and "
        f"draws): losses {[round(x[0], 6) for x in mk]} vs {[round(x[0], 6) for x in mp]} (max rel {loss_rel:.3e}, "
        f"tol {STD_LOSS_RTOL}), grad_norm max rel {gnorm_rel:.3e} (tol {STD_GNORM_RTOL}), trainable update rel L2 "
        f"{upd_rel:.3e} (tol {STD_UPDATE_RTOL})")
    if not (loss_rel <= STD_LOSS_RTOL and gnorm_rel <= STD_GNORM_RTOL and upd_rel <= STD_UPDATE_RTOL):
        raise SystemExit("the expert-only update through the kernels disagrees with the plain path")


def train_standard_joint() -> dict:
    """pi0_finetune_bridge.yaml through the Trainer: bf16 masters, 8-bit
    AdamW with stochastic rounding, per-layer remat, 2 updates of 2
    micro-steps of 32. The final save is recorded, not written (record_saves)."""
    from intact_tpu_torch.models.common import flatten_paths
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.train.trainer import Trainer

    cfg = trainer_config(JOINT_RECIPE, JOINT_OVERRIDES)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=DEVICE)
    torch.cuda.synchronize()
    mc, accum = trainer.model_cfg, trainer.opt_cfg.grad_accumulation_steps
    params = flatten_paths(trainer.state.params)
    mu = trainer.state.opt_state["mu"]
    n_q = sum(isinstance(m, dict) for m in mu.values())
    want_flash = 2 * (mc.vlm.depth - 1)  # the forward's full layers, and their recompute in the backward (remat)
    log(f"# standard joint: {JOINT_RECIPE}, {sum(v.numel() for v in params.values()) / 1e9:.3f} B params "
        f"{sorted({str(v.dtype) for v in params.values()})}, remat {cfg.remat}, 8-bit moments on {n_q} of {len(mu)} "
        f"trainable leaves, micro-batch {trainer.micro_batch_size} x accumulation {accum}, init "
        f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card; per "
        f"micro-step expect {want_flash} flash_attention launches")
    records = record_steps(trainer, {"flash_attention": flash_attention})
    saves = record_saves(trainer)
    keep_reference("joint", trainer)
    # --- the main path: the trainer's loop ---
    flash_attention.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches}
    # -----------------------------------------
    park_reference("joint")
    report_steps("standard joint", records, accum, cfg.global_batch_size)
    codes = {m["q"].dtype for m in trainer.state.opt_state["mu"].values() if isinstance(m, dict)}
    log(f"# standard joint: loop wall {wall:.2f} s for {cfg.n_updates} updates; launches {launches}; moment codes "
        f"{sorted(map(str, codes))}; saves asked at updates {saves}")
    bad = [i + 1 for i, (n, loss, gn, pn, _) in enumerate(records)
           if not (np.isfinite(loss) and np.isfinite(gn) and np.isfinite(pn)) or n["flash_attention"] != want_flash]
    if bad or len(records) != cfg.n_updates * accum or codes != {torch.int8} or not n_q or saves != [cfg.n_updates]:
        raise SystemExit(f"standard joint: micro-steps {bad} non-finite or unexpected launches, codes {codes}, "
                         f"saves {saves}")
    batch = trainer.device_batch(next(iter(trainer.train_data)))
    profile_pass("standard joint micro-step", lambda: (trainer.train_step(trainer.state, batch),
                                                       torch.cuda.synchronize()))
    del trainer, batch
    gc.collect()  # the recorders installed on the trainer refer back to it
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 5b. the multi-card recipes through the trainer in a one-rank NCCL group
# ---------------------------------------------------------------------------

# the repo's multi-card recipes with --mesh.fsdp 1 (the script runs on one card),
# two updates of two micro-steps each (update 2 is warm on both sides); the
# fused recipe takes no accumulation: two updates of one step (the second
# clips with the first's norm)
MULTI_RECIPES = {
    "joint": (JOINT_RECIPE, {"mesh.fsdp": 1, "per_device_batch_size": 32, "global_batch_size": 64, "n_updates": 2}),
    "expert-only": (EXPERT_RECIPE, {"mesh.fsdp": 1, "per_device_batch_size": 96, "global_batch_size": 192,
                                    "n_updates": 2, **RLDS_OVERRIDES}),
    "fused": (RECIPE, {"n_updates": 2}),
}
MULTI_MICRO_STEPS = {"joint": 4, "expert-only": 4, "fused": 2}
ZERO3_RULES_FSDP = 4  # the standard recipes' own mesh.fsdp, whose rules phase 5b's ZeRO-3 runs split by
ZERO3_LABELS = ("joint", "expert-only")
# the runs without a group that phase 5b holds its group runs to: the params
# after MULTI_MICRO_STEPS micro-steps of phases 4 and 5's runs of the same
# recipes (same seed, same data), on the host, and their micro-step times
NO_GROUP: dict = {}


def keep_reference(label: str, trainer) -> None:
    """Wrap trainer.train_step (outermost): time each micro-step and clone the
    params on the card after MULTI_MICRO_STEPS[label] of them (a device copy,
    a few ms); park_reference moves them to the host after the loop."""
    real = trainer.train_step
    ref = NO_GROUP[label] = {"times": [], "params": None, "peak_gib": None}

    def step(state, batch):
        t = time.perf_counter()
        out = real(state, batch)
        torch.cuda.synchronize()
        ref["times"].append(time.perf_counter() - t)
        if len(ref["times"]) == MULTI_MICRO_STEPS[label]:
            from intact_tpu_torch.models.common import flatten_paths

            ref["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30  # the phase's peak so far
            ref["params"] = {k: v.detach().clone() for k, v in flatten_paths(out[0].params).items()}
        return out

    trainer.train_step = step


def park_reference(label: str) -> None:
    ref = NO_GROUP[label]
    if ref["params"] is None:
        raise SystemExit(f"{label}: the run stopped before micro-step {MULTI_MICRO_STEPS[label]}")
    ref["params"] = {k: v.to("cpu") for k, v in ref["params"].items()}
    torch.cuda.empty_cache()


def expected_collectives(trainer) -> dict:
    """The collectives one update issues, counted from the trainer's state
    as the code issues them (train/optim.py, train/fused_joint.py), plus the
    log line's all-reduce (log_freq 1)."""
    from intact_tpu_torch.models.common import flatten_paths
    from intact_tpu_torch.parallel import collectives
    from intact_tpu_torch.parallel.sharding import Sharded
    from intact_tpu_torch.train import fused_joint as fj

    want = dict.fromkeys(collectives.counts(), 0)
    if trainer.cfg.fused_update:
        state, mesh = trainer.state, trainer.mesh
        depth = trainer.model_cfg.vlm.depth
        split = 2 * depth  # each trunk layer: its pack's rows
        replicated = 0
        small = [(name, trainer.state.params[name], state.mu[name]) for name in fj.EMBED_NAMES + ("action_out_proj",)]
        small.append(("final_norm", state.params["expert"]["final_norm"], state.mu["expert"]["final_norm"]))
        for _, ptree, mtree in small:
            moments = dict(fj.tree_items(mtree, quant_leaves=True))
            for path, p in fj.tree_items(ptree):
                quant = fj._is_quant_leaf(moments[path])
                if quant and fj.leaf_shard(p, 2048, mesh) is not None:
                    split += 1
                else:
                    replicated += 1
        # a split gradient: reduce-scatter (fsdp) and all-reduce (data), its rows all-gathered after the update;
        # a replicated one: one all-reduce; the norm's sum of squares and the log line: one each
        return {**want, "all_reduce": split + replicated + 2, "reduce_scatter": split, "all_gather": split}
    # ZeRO-3: per micro-step the layer buckets and one all-reduce of the norms; per update a data all-reduce
    # per split leaf and a MAX all-reduce per 8-bit one, a world all-reduce per replicated leaf, the clip's
    # and the log line's
    flat = flatten_paths(trainer.state.params)
    paths = trainer.tx.paths(flat)
    mu = trainer.state.opt_state["mu"]
    split = [k for k in paths if isinstance(flat[k], Sharded)]
    accum = trainer.opt_cfg.grad_accumulation_steps
    gathers, scatters = buckets_per_micro_step(trainer)
    return {**want, "all_reduce": accum + len(paths) + 2, "all_reduce_max": sum(isinstance(mu[k], dict) for k in split),
            "bucket_all_gather": accum * gathers, "bucket_reduce_scatter": accum * scatters}


def buckets_per_micro_step(trainer) -> tuple[int, int]:
    """(bucket all-gathers, bucket reduce-scatters) of one standard Pi0
    micro-step on a tree of Sharded leaves, from the configuration: the
    joint recipe gathers each SigLIP layer and each layer of both Gemma
    stacks in the forward and again in its recomputed backward (all but the
    last pair, which is not recomputed), and the embedding once; each layer
    that trains reduce-scatters once. The expert-only recipe gathers the
    frozen prefix once under no_grad (SigLIP, the embedding, the kv_only
    prefill's every VLM layer) and the expert's layers once, each of them
    reduce-scattered."""
    from intact_tpu_torch.models.common import flatten_paths

    mc = trainer.model_cfg
    has = split_prefixes(trainer.state.params, ("siglip/blocks/", "vlm/blocks/", "expert/blocks/", "vlm_embed/"))
    trains = {p: any(v for k, v in flatten_paths(trainer.frozen_mask).items() if k.startswith(p))
              if trainer.frozen_mask is not None else True for p in has}
    v, g, e, emb = (has[p] for p in ("siglip/blocks/", "vlm/blocks/", "expert/blocks/", "vlm_embed/"))
    if mc.train_expert_only:
        return v * mc.vision.depth + emb + g * mc.vlm.depth + e * mc.expert.depth, e * mc.expert.depth
    remat = 2 if trains["siglip/blocks/"] else 1
    gathers = (v * remat * mc.vision.depth + emb + g * (2 * (mc.vlm.depth - 1) + 1)
               + e * (2 * (mc.expert.depth - 1) + 1))
    scatters = (v * trains["siglip/blocks/"] * mc.vision.depth + emb * trains["vlm_embed/"]
                + g * trains["vlm/blocks/"] * mc.vlm.depth + e * trains["expert/blocks/"] * mc.expert.depth)
    return gathers, scatters


def multirank_run(label: str, group: bool) -> dict:
    """One recipe of MULTI_RECIPES through the Trainer, with or without the
    process group: its updates' launches, collectives, metrics and times,
    and the params after the last update on the host."""
    from intact_tpu_torch.models.common import flatten_paths
    from intact_tpu_torch.ops import w8a8
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.ops.fused_adam import fused_adam_rows
    from intact_tpu_torch.parallel import collectives
    from intact_tpu_torch.parallel.sharding import Sharded, gather_leaf
    from intact_tpu_torch.train.trainer import Trainer

    recipe, overrides = MULTI_RECIPES[label]
    cfg = trainer_config(recipe, {**overrides, "eval_freq": 10**6})
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, device=DEVICE)
    mc, accum = trainer.model_cfg, trainer.opt_cfg.grad_accumulation_steps
    if trainer.mesh.distributed != group or trainer.mesh.size != 1:
        raise SystemExit(f"{label}: mesh {trainer.mesh} (group expected: {group})")
    zero3 = group and not cfg.fused_update
    if zero3:  # the recipe's own rules (fsdp 4), each split leaf a Sharded of one part over the group
        from intact_tpu_torch.train import train_step as ts

        params, trainer.state = trainer.state.params, None
        gc.collect()
        trainer.state = ts.init_train_state(one_part(params, trainer.mesh, fsdp=ZERO3_RULES_FSDP), trainer.tx,
                                            seed=cfg.seed)
        del params
    counters = {"flash_attention": flash_attention, "w8a8_matmul": w8a8.w8a8_matmul, "fused_adam_rows": fused_adam_rows}
    if cfg.fused_update:
        want = {"flash_attention": 2 * (mc.vlm.depth - 1), "w8a8_matmul": 0,
                "fused_adam_rows": len(expected_row_updates(trainer.state))}
    elif mc.train_expert_only:
        want = {"flash_attention": mc.vlm.depth - 1, "w8a8_matmul": w8a8_per_prefix(trainer.state.params),
                "fused_adam_rows": 0}
    else:
        want = {"flash_attention": 2 * (mc.vlm.depth - 1), "w8a8_matmul": 0, "fused_adam_rows": 0}
    want_coll = expected_collectives(trainer) if group else dict.fromkeys(collectives.counts(), 0)
    records = []
    real_step = trainer.train_step

    def recorded(state, batch):
        before = {k: c.launches for k, c in counters.items()}
        c0 = collectives.counts()
        t = time.perf_counter()
        out = real_step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        records.append(({k: c.launches - before[k] for k, c in counters.items()},
                        {k: v - c0[k] for k, v in collectives.counts().items()},
                        out[1]["l2_loss"].item(), out[1]["grad_norm"].item(), dt))
        return out

    trainer.train_step = recorded
    saves = record_saves(trainer)
    # --- the main path: the trainer's loop ---
    for c in counters.values():
        c.launches = 0
    collectives.reset()
    t0 = time.perf_counter()
    trainer.train()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    per_update = collectives.counts()  # with the log lines' all-reduces, outside train_step
    # -----------------------------------------
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_updates = cfg.n_updates
    updates = [sum(r[-1] for r in records[i:i + accum]) for i in range(0, len(records), accum)]
    where = "one-rank NCCL group" if group else "no group"
    for i, (n, coll, loss, gn, dt) in enumerate(records):
        log(f"# multi-card {label} ({where}) micro-step {i + 1}: loss {loss:.6f}, grad_norm {gn:.6f}, "
            f"{dt * 1e3:.2f} ms, launches {n}, collectives {coll}")
    log(f"# multi-card {label} ({where}{', ZeRO-3 at the fsdp-4 rules, one part' if zero3 else ''}): {n_updates} "
        f"update(s) of {accum} micro-step(s), update times {[round(u * 1e3, 2) for u in updates]} ms, loop wall "
        f"{wall:.2f} s, peak memory since the trainer's init {peak:.2f} GiB; launches {launches}; collectives {per_update} "
        f"(expected per update {want_coll}); saves asked at {saves}")
    per_micro = ({"bucket_all_gather": want_coll["bucket_all_gather"] // accum,
                  "bucket_reduce_scatter": want_coll["bucket_reduce_scatter"] // accum} if group else {})
    bad = [i + 1 for i, (n, coll, loss, gn, _) in enumerate(records)
           if not (np.isfinite(loss) and np.isfinite(gn)) or n != want
           or any(coll[k] != v for k, v in per_micro.items())]
    coll_want = {k: v * n_updates for k, v in want_coll.items()}
    if bad or len(records) != n_updates * accum or per_update != coll_want or saves != [n_updates]:
        raise SystemExit(f"multi-card {label} ({where}): micro-steps {bad} non-finite or launches other than {want} "
                         f"or buckets other than {per_micro}, {len(records)} micro-steps, collectives {per_update} "
                         f"(expected {coll_want}), saves {saves}")
    if zero3:  # where the buckets' time goes in one more micro-step
        batch = trainer.device_batch(next(iter(trainer.train_data)))
        bucket_profile(f"multi-card {label}, one micro-step", lambda: (real_step(trainer.state, batch),
                                                                        torch.cuda.synchronize()),
                       gpu_name_and_power())
        del batch
    params = {}
    for k, v in flatten_paths(trainer.state.params).items():  # a split leaf gathered (a bucket of its own)
        params[k] = (gather_leaf(v.local, v) if isinstance(v, Sharded) else v).detach().to("cpu", copy=True)
    out = {"launches": launches, "times": [r[-1] for r in records], "accum": accum, "params": params,
           "collectives": per_update, "peak_gib": peak}
    del trainer, real_step, recorded
    gc.collect()
    torch.cuda.empty_cache()
    return out


def update_times(times: list, accum: int) -> list:
    return [round(sum(times[i:i + accum]) * 1e3, 2) for i in range(0, len(times), accum)]


def host_staged_init() -> None:
    """The trainer's init at fsdp > 1 draws each leaf on the card and hands it
    to the host (cm.made_on_host) before placing the rank's shares: at
    pi0_tiny, every leaf on the host and bit-equal to the init on the card."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.pi0 import model as pi0
    from intact_tpu_torch.models.pi0.config import Pi0Config

    on_card = cm.flatten_paths(pi0.init(Pi0Config.tiny(), 3, DEVICE, torch.bfloat16))
    with cm.made_on_host():
        staged = cm.flatten_paths(pi0.init(Pi0Config.tiny(), 3, DEVICE, torch.bfloat16))
    bad = [k for k, v in on_card.items() if staged[k].device.type != "cpu" or not torch.equal(staged[k].to(DEVICE), v)]
    log(f"# host-staged init (pi0_tiny): {len(staged)} leaves on the host, {len(bad)} unequal to the init on the card")
    if bad or set(staged) != set(on_card):
        raise SystemExit(f"the host-staged init differs from the card's at {bad[:5]}")


def phase_multirank_training() -> dict:
    """-> {kernel: launches} of the three recipes in the group. The script
    joins a one-rank NCCL group as torchrun would start it, runs each recipe
    through the Trainer, and holds its params after the updates bit-equal to
    the same recipe's run without a group (phases 4 and 5's, or its own when
    run alone): a world of one reduces nothing."""
    import os
    import shutil
    import socket

    from intact_tpu_torch.parallel import distributed

    if not (RLDS_DIR / "bridge_dataset").exists():
        raise SystemExit(f"{RLDS_DIR}/bridge_dataset is missing: run phase_rlds_data first")
    card = gpu_name_and_power()
    host_staged_init()
    launch_env = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    saved_env = {k: os.environ.get(k) for k in launch_env}
    try:
        for label in MULTI_RECIPES:
            if label not in NO_GROUP:  # the phase alone: its own runs without a group
                alone = multirank_run(label, group=False)
                NO_GROUP[label] = {"times": alone["times"], "params": alone["params"], "peak_gib": alone["peak_gib"]}
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        t0 = time.perf_counter()
        device = distributed.initialize(DEVICE)
        log(f"# multi-card: process group {distributed.backend()} of {distributed.process_count()} rank(s) on "
            f"{device}, joined in {time.perf_counter() - t0:.2f} s")
        if distributed.backend() != "nccl" or distributed.process_count() != 1:
            raise SystemExit(f"the card's process group is {distributed.backend()}, not a one-rank NCCL group")
        totals = {"flash_attention": 0, "w8a8_matmul": 0, "fused_adam_rows": 0}
        for label in MULTI_RECIPES:
            grouped = multirank_run(label, group=True)
            for k in totals:
                totals[k] += grouped["launches"][k]
            ref = NO_GROUP.pop(label)
            n = MULTI_MICRO_STEPS[label]
            unequal = [k for k, v in grouped["params"].items() if not torch.equal(v, ref["params"][k])]
            gap = max(((grouped["params"][k].double() - ref["params"][k].double()).abs().max().item()
                       for k in unequal), default=0.0)
            times_with, times_without = grouped["times"][:n], ref["times"][:n]
            log(f"# multi-card {label} ({card}): update times with the one-rank NCCL group "
                f"{update_times(grouped['times'], grouped['accum'])} ms, without a group "
                f"{update_times(ref['times'][:n], grouped['accum'])} ms; micro-step median "
                f"{statistics.median(times_with) * 1e3:.2f} ms with the group"
                f"{' and the fsdp-4 shares (one part)' if label in ZERO3_LABELS else ''}, "
                f"{statistics.median(times_without) * 1e3:.2f} ms without; peak memory {grouped['peak_gib']:.2f} GiB "
                f"with, {ref['peak_gib'] if ref['peak_gib'] is None else round(ref['peak_gib'], 2)} GiB without; "
                f"params after {n} micro-steps bit-equal to the run without a group: {not unequal} ({len(unequal)} of "
                f"{len(ref['params'])} leaves differ, max abs {gap:.3e})")
            if unequal or set(ref["params"]) != set(grouped["params"]):
                raise SystemExit(f"multi-card {label}: the one-rank group's params differ from the run without a "
                                 f"group at {unequal[:5]}")
            del grouped, ref
            gc.collect()
    finally:
        distributed.destroy()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(RLDS_DIR, ignore_errors=True)
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    return totals


# ---------------------------------------------------------------------------
# 6. Pi0FAST serving through the server role's wrapper: bf16 and int8
# ---------------------------------------------------------------------------

FAST_EV_CONFIG = "config/experiment/simplerMS3/pi0fast_finetune_bridge_ev.yaml"
# Pi0FAST's bf16 kernel path against its plain-attention path. Greedy decoding
# is discontinuous (one flipped token changes every later one), so the actions
# cannot hold the attention kernel; it is held three ways instead: the prefix
# K/V cache at the unpadded tokens; every step's window logits with the kernel
# path's tokens fed to the plain path (teacher forcing); and at every step the
# plain logit of the kernel's token within FAST_MARGIN of the plain maximum,
# in units of the plain window logits' standard deviation. Readings on an H100
# 80GB HBM3 at 700 W (PERF.md): K/V rel L2 9.1e-3 (0 at layer 0, rising to
# 1.2e-2 at the last: bf16 ulps of P carried through the layers), logits 9.8e-3,
# margin 2.9e-2 at 1 of 1792 steps and rows; gates 3.5-5.5x the readings
FAST_KV_RTOL = 5e-2
FAST_LOGITS_RTOL = 5e-2
FAST_MARGIN = 0.1
FAST_TIMING_REPS = 3  # timed inferences per wrapper and batch (5 before phase 5b joined the script's budget)
# Gemma layers of the served Pi0FAST (18 before phase 5b joined the script's budget, 9 before phase 3d joined
# it, 4 before phase 3f): the launches and every gate follow the configuration
FAST_SERVING_DEPTH = 2


def w8a8_per_fast_inference(cfg) -> int:
    """W8A8 products of one Pi0FAST inference: SigLIP 6 per layer, img_proj, the
    kv_only prefill's 7 per full layer and the last layer's k and v, and 7 per
    trunk layer in each of the n_action_tokens decode steps (state_proj and the
    tied logits stay bf16, as in the reference)."""
    return cfg.vision.depth * 6 + 1 + (cfg.vlm.depth - 1) * 7 + 2 + cfg.n_action_tokens * cfg.vlm.depth * 7


def fast_request(rng: np.random.Generator, b: int, size: int) -> dict:
    """One request of b rows as the batched ManiSkill3 adapter's preprocess
    emits it on the uint8 wire (resized uint8 frames, the normalized 7-d
    proprio, a task per row)."""
    obs = make_obs(rng, b, size)
    return {"image": obs["image"], "state": np.clip(obs["state"], -1.0, 1.0), "task": list(obs["task"])}


def greedy_logits(params, inputs, cfg, policy, forced=None):
    """`pi0fast.sample_actions`' decode step by step from its own pieces ->
    (tokens [B, T], window logits [T, B, window] fp32); with `forced` [B, T]
    the given tokens are fed back in place of the argmax (teacher forcing)."""
    from intact_tpu_torch.models.pi0fast import model as fast

    with torch.inference_mode():
        (ck, cv), pre_pad = fast.prefix_cache(params, *inputs, cfg, policy)
        b, p_len = pre_pad.shape
        first = cfg.vlm.vocab_size - (cfg.action_vocab_size or cfg.n_action_bins)
        key_valid = torch.cat([pre_pad, pre_pad.new_zeros((b, cfg.n_action_tokens))], dim=1)
        count = pre_pad.sum(dim=1, keepdim=True).to(torch.int32)
        x = policy.cast(params["action_start"]).expand(b, 1, cfg.vlm.width)
        tokens, logits = [], []
        for s in range(cfg.n_action_tokens):
            key_valid[:, p_len + s] = True
            h = fast.decode_token(params, x, (ck, cv), p_len + s, key_valid, count + s, cfg, policy)
            logits.append(fast._logits(params, h, policy, first))
            tokens.append(first + logits[-1].argmax(dim=-1))
            x = fast.embed_tokens(params, (tokens[-1] if forced is None else forced[:, s])[:, None], cfg, policy)
        return torch.stack(tokens, dim=1), torch.stack(logits)


def phase_fast_serving() -> dict:
    """-> {kernel: launches} on Pi0FAST's serving path, at full width and
    FAST_SERVING_DEPTH Gemma layers."""
    with cut_depths(("pi0fast", "vlm", FAST_SERVING_DEPTH)):
        return fast_serving()


def fast_serving() -> dict:
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.pi0fast import model as fast
    from intact_tpu_torch.ops import w8a8
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    cfg = ev_config(path=FAST_EV_CONFIG)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wrapper = make_policy_wrapper(cfg, device=DEVICE)
    torch.cuda.synchronize()
    mc, policy = wrapper.model_cfg, wrapper.policy
    leaves = cm.tree_leaves(policy.params)
    per_inference, flash_per = w8a8_per_fast_inference(mc), mc.vlm.depth - 1
    first = mc.vlm.vocab_size - (mc.action_vocab_size or mc.n_action_bins)
    log(f"# Pi0FAST serving: Pi0PolicyWrapper from {FAST_EV_CONFIG} ({cfg.model_type} at {mc.vlm.depth} Gemma layers, "
        f"model {policy.model.__name__}, "
        f"adapter {cfg.eval_cfg.env_adapter}, quantize_int8 {cfg.eval_cfg.quantize_int8}, seed {cfg.seed}): "
        f"{sum(x.numel() for x in leaves if x.dtype == torch.int8) / 1e9:.3f} B int8 weights + "
        f"{sum(x.numel() for x in leaves if x.dtype != torch.int8) / 1e9:.3f} B bf16/fp32 values, init "
        f"{time.perf_counter() - t0:.2f} s; prefix "
        f"{mc.num_cameras * mc.vision.num_patches + mc.tokenizer_max_length + 1} tokens, {mc.n_action_tokens} greedy steps over the last {mc.vlm.vocab_size - first} ids; expect "
        f"{per_inference} w8a8_matmul and {flash_per} flash_attention launches per inference")

    rng = np.random.default_rng(3)
    size = mc.vision.image_size
    # batch 64: one request of the sweep's n_parallel_eval rows (60: one
    # ManiSkill3 client's vectorized envs), which the wrapper pads to bucket 64
    n_env = int(cfg.eval_cfg.n_parallel_eval)
    if wrapper.bucket_size(n_env) != 64:
        raise SystemExit(f"n_parallel_eval {n_env} pads to bucket {wrapper.bucket_size(n_env)}, not 64")
    req1, req64 = fast_request(rng, 1, size), fast_request(rng, n_env, size)
    sessions = [wrapper.new_session(), wrapper.new_session()]  # the batch-1 client's and the sweep client's

    # --- the main path: fused multi-row requests through the wrapper, as the batching server calls it ---
    w8a8.w8a8_matmul.launches = flash_attention.launches = 0
    inferences = 0

    def fused(items):
        nonlocal inferences
        w0, f0 = w8a8.w8a8_matmul.launches, flash_attention.launches
        out = wrapper.infer_batch(items)
        dw, df = w8a8.w8a8_matmul.launches - w0, flash_attention.launches - f0
        if dw != per_inference or df != flash_per:
            raise SystemExit(f"one fused Pi0FAST inference launched w8a8_matmul {dw} and flash_attention {df} "
                             f"times; expected {per_inference} and {flash_per}")
        inferences += 1
        return out

    out1 = [fused([(req1, sessions[0])]) for _ in range(2)]
    out64 = fused([(req64, sessions[1])])
    launches = {"w8a8_matmul": w8a8.w8a8_matmul.launches, "flash_attention": flash_attention.launches}
    # -------------------------------------------------------------------------------------------------
    results = [o[0] for o in out1] + out64
    rows = [1, 1, n_env]
    for a, r in zip(results, rows):
        if isinstance(a, Exception) or a.shape != (r, cfg.eval_cfg.action_step, 7) or not np.isfinite(a).all():
            raise SystemExit(f"bad Pi0FAST serving result {a!r:.200}")
    log(f"# Pi0FAST serving: {inferences} fused inferences (batch 1, 1, and one request of {n_env} rows padded to "
        f"bucket 64), launches {launches}, env actions of shape {results[-1].shape} per request, finite")

    pad = 64 - n_env  # the wrapper's padding: the last row repeated up to the bucket
    batch = {"image": np.concatenate([req64["image"], np.repeat(req64["image"][-1:], pad, axis=0)]),
             "state": np.concatenate([req64["state"], np.repeat(req64["state"][-1:], pad, axis=0)]),
             "task": req64["task"] + [req64["task"][-1]] * pad}
    inputs = policy.device_inputs(batch)
    # int8: the tokens and actions with the W8A8 kernel against those with only its product plain
    tokens, log_k = greedy_logits(policy.params, inputs, mc, policy.policy)
    in_window = bool(((tokens >= first) & (tokens < mc.vlm.vocab_size)).all())
    actions = fast.detokenize_actions(tokens, mc)
    env = sessions[1].adapter.postprocess_batch(actions[:n_env, :cfg.eval_cfg.action_step, :7].cpu().numpy())
    same_as_served = bool(np.array_equal(env, out64[0]))
    real = w8a8.w8a8_matmul
    n0 = w8a8.w8a8_matmul.launches
    w8a8.w8a8_matmul = plain_w8a8  # the plain W8A8 product, for this comparison only
    try:
        tok_w, log_w = greedy_logits(policy.params, inputs, mc, policy.policy)
    finally:
        w8a8.w8a8_matmul = real
    # the actions are the detokenized tokens, so equal tokens give equal actions
    same = (torch.equal(tok_w, tokens) and torch.equal(log_k, log_w)
            and torch.equal(fast.detokenize_actions(tok_w, mc), actions))
    log(f"# Pi0FAST int8, batch 64: {tokens.numel()} tokens, all in the window [{first}, {mc.vlm.vocab_size}) "
        f"{in_window}, {tokens.unique().numel()} distinct; the served env actions equal the postprocessed "
        f"detokenized tokens {same_as_served}; with only the W8A8 product plain: tokens, every step's window "
        f"logits and the actions bit-equal {same} (gates: both bit-equal; plain runs launched w8a8_matmul "
        f"{w8a8.w8a8_matmul.launches - n0} times)")
    if not in_window or not same or not same_as_served or w8a8.w8a8_matmul.launches != n0:
        raise SystemExit("Pi0FAST int8 tokens outside the window, the W8A8 kernel's tokens differ from its plain "
                         "version's, or the served actions differ from the checked tokens'")
    del log_k, log_w
    torch.cuda.reset_peak_memory_stats()
    for items in ([(req1, sessions[0])], [(req64, sessions[1])]):
        wrapper.infer_batch(items)
    int8_peak = torch.cuda.max_memory_allocated()

    # bf16: the same random weights behind the same wrapper, quantize_int8 off
    bf16_wrapper = make_policy_wrapper(ev_config(quantize=False, path=FAST_EV_CONFIG), device=DEVICE)
    bf16_sessions = [bf16_wrapper.new_session(), bf16_wrapper.new_session()]
    bp, bpol = bf16_wrapper.policy.params, bf16_wrapper.policy.policy
    plain_cfg = dataclasses.replace(mc, attention_impl="xla")
    with torch.inference_mode():
        (k1, v1), pre_pad = fast.prefix_cache(bp, *inputs, mc, bpol)
        (k3, v3), _ = fast.prefix_cache(bp, *inputs, plain_cfg, bpol)
        p_len = pre_pad.shape[1]
        ka, va, kp, vp = (c[:, :, :p_len][:, pre_pad] for c in (k1, v1, k3, v3))
    kv_rel = {"K": rel_l2(ka, kp), "V": rel_l2(va, vp)}
    layer_rel = [max(rel_l2(ka[i], kp[i]), rel_l2(va[i], vp[i])) for i in range(ka.shape[0])]
    del k1, v1, k3, v3, ka, va, kp, vp
    tok_b, log_b = greedy_logits(bp, inputs, mc, bpol)
    tok_bs = fast.sample_actions(bp, None, *inputs, mc, bpol, return_tokens=True)
    _, log_pf = greedy_logits(bp, inputs, plain_cfg, bpol, forced=tok_b)  # teacher-forced plain path
    tok_p, _ = greedy_logits(bp, inputs, plain_cfg, bpol)  # the plain path's own greedy decode
    logits_rel = rel_l2(log_b, log_pf)
    step_rel = [rel_l2(log_b[s], log_pf[s]) for s in range(log_b.shape[0])]
    chosen = log_pf.gather(-1, (tok_b.T - first)[..., None])[..., 0]  # [T, B]
    margin = (log_pf.amax(dim=-1) - chosen) / log_pf.std()
    agree = (tok_b == tok_p).float().mean().item()
    int8_bf16 = (tokens == tok_b).float().mean().item()
    log(f"# Pi0FAST bf16 kernel vs plain attention, batch 64: prefix K/V {tuple(pre_pad.shape)} at the "
        f"{int(pre_pad.sum())} unpadded tokens rel L2 K {kv_rel['K']:.3e} V {kv_rel['V']:.3e} (tol {FAST_KV_RTOL}), "
        f"per layer {[f'{r:.1e}' for r in layer_rel]}; teacher-forced window logits rel L2 {logits_rel:.3e} (tol "
        f"{FAST_LOGITS_RTOL}), per step max {max(step_rel):.3e}, max abs {(log_b - log_pf).abs().max().item():.3e} "
        f"(logits std {log_pf.std().item():.3e}); plain logit of the kernel's token below the plain maximum by at most "
        f"{margin.max().item():.3e} std (tol {FAST_MARGIN}), at {int((margin > 0).sum())} of {margin.numel()} "
        f"steps and rows; tokens equal to the plain path's own greedy decode {agree:.4f} (no gate); the stepwise "
        f"decode equals sample_actions {torch.equal(tok_b, tok_bs)}; int8 tokens equal to bf16's {int8_bf16:.4f}")
    if not (max(kv_rel.values()) <= FAST_KV_RTOL and logits_rel <= FAST_LOGITS_RTOL
            and margin.max().item() <= FAST_MARGIN and torch.equal(tok_b, tok_bs)
            and bool(((tok_b >= first) & (tok_b < mc.vlm.vocab_size)).all())):
        raise SystemExit("Pi0FAST's bf16 kernel path disagrees with its plain-attention path")
    del log_b, log_pf, inputs
    torch.cuda.empty_cache()

    runs = {"int8": (wrapper, sessions), "bf16": (bf16_wrapper, bf16_sessions)}
    torch.cuda.reset_peak_memory_stats()
    for b, i, n in ((1, 0, 1), (64, 1, n_env)):
        req = req1 if b == 1 else req64
        times = {k: [] for k in runs}
        calls = {k: [(req, ss[i])] for k, (w, ss) in runs.items()}
        for k, (w, _) in runs.items():
            w.infer_batch(calls[k])  # warm
        for _ in range(FAST_TIMING_REPS):
            for k, (w, _) in runs.items():
                t0 = time.perf_counter()
                w.infer_batch(calls[k])  # ends in a device->host copy and the adapters' postprocess
                times[k].append(time.perf_counter() - t0)
        med = {k: statistics.median(v) for k, v in times.items()}
        for k in runs:
            log(f"# Pi0FAST {k} serving batch {b} ({n} rows; Pi0PolicyWrapper.infer_batch): median fused "
                f"inference {med[k] * 1e3:.2f} ms over {FAST_TIMING_REPS} ({[round(x * 1e3, 2) for x in times[k]]}), "
                f"{n * mc.n_action_steps / med[k]:.2f} policy steps/s")
        log(f"# Pi0FAST serving batch {b} through the wrapper: int8 / bf16 latency {med['int8'] / med['bf16']:.3f}")
    log(f"# Pi0FAST peak device memory: int8 wrapper alone {int8_peak / 2**30:.2f} GiB (batch 1 and 64); both "
        f"wrappers during the timing {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for b, i, req in ((1, 0, req1), (64, 1, req64)):
        for k, (w, ss) in runs.items():
            calls = [(req, ss[i])]
            profile_pass(f"Pi0FAST {k} wrapper batch {b}", lambda: w.infer_batch(calls))
    del wrapper, policy, bf16_wrapper, runs, bp
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 7. Pi0FAST training: the full tower through the trainer's standard step
# ---------------------------------------------------------------------------

FAST_RECIPE = "config/train/pi0fast_finetune_bridge.yaml"
FAST_OVERRIDES = {"mesh.fsdp": 1, "per_device_batch_size": 16, "global_batch_size": 32, "n_updates": 2,
                  "eval_freq": 2, "eval_size": 16}
# one micro-step's gradient of every leaf through the attention kernel against
# through the plain attention, at full width and 4 layers (SigLIP and Gemma).
# SigLIP's key biases are left out of the per-leaf gate: a key bias shifts a
# query row's logits by a constant the softmax cancels, so their exact
# gradient is 0 and both sides hold rounding noise. Readings on an H100 80GB
# HBM3 at 700 W: 1.9e-3 overall, worst leaf 3.3e-3; gates ~10x
FAST_GRAD_RTOL = 2e-2
FAST_LEAF_RTOL = 3e-2


def phase_fast_training() -> dict:
    """pi0fast_finetune_bridge.yaml through the Trainer: 2 updates of 2
    micro-steps of 16, validation at update 2 on one batch, the last save
    recorded. -> {kernel: launches} on the path."""
    from intact_tpu_torch.models.common import tree_leaves
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.train.trainer import Trainer

    cfg = trainer_config(FAST_RECIPE, FAST_OVERRIDES)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=DEVICE)
    torch.cuda.synchronize()
    mc, accum = trainer.model_cfg, trainer.opt_cfg.grad_accumulation_steps
    n_params = sum(x.numel() for x in tree_leaves(trainer.state.params))
    # the prefill's full layers, and their recompute in the backward (every
    # layer is checkpointed under autograd, as the reference's prefill)
    want_flash = 2 * mc.vlm.depth
    log(f"# Pi0FAST training: {FAST_RECIPE} ({cfg.model_type}, SigLIP {mc.vision.depth} + Gemma {mc.vlm.depth} "
        f"layers, {n_params / 1e9:.3f} B params {trainer.cfg.master_dtype}, trainable all: "
        f"{trainer.frozen_mask is None}), micro-batch {trainer.micro_batch_size} x accumulation "
        f"{accum}, {mc.tokenizer_max_length + mc.vision.num_patches + 1 + mc.n_action_tokens} tokens, init "
        f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card; per "
        f"micro-step expect {want_flash} flash_attention launches")
    records = []
    real_step = trainer.train_step

    def recorded(state, batch):
        f0 = flash_attention.launches
        t = time.perf_counter()
        out = real_step(state, batch)
        torch.cuda.synchronize()
        m = out[1]
        records.append((flash_attention.launches - f0, m["l2_loss"].item(), m["token_accuracy"].item(),
                         m["grad_norm"].item(), time.perf_counter() - t))
        return out

    trainer.train_step = recorded
    validations = []
    real_validate = trainer.validate

    def validate():
        f0 = flash_attention.launches
        metrics = real_validate()
        validations.append((metrics, flash_attention.launches - f0))
        return metrics

    trainer.validate = validate
    saves = record_saves(trainer)
    # --- the main path: the trainer's loop, as `python -m intact_tpu_torch.run` drives it ---
    flash_attention.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches}
    # -------------------------------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    for i, (n, loss, acc, gn, dt) in enumerate(records):
        log(f"# Pi0FAST micro-step {i + 1}: loss {loss:.6f}, token_accuracy {acc:.4f}, grad_norm {gn:.6f}, "
            f"{dt * 1e3:.2f} ms, flash_attention {n}")
    micro = [r[-1] for r in records[1:]]
    updates = [sum(r[-1] for r in records[i:i + accum]) for i in range(accum, len(records), accum)]
    med_u = statistics.median(updates)
    log(f"# Pi0FAST training: median micro-step {statistics.median(micro) * 1e3:.2f} ms over micro-steps 2.."
        f"{len(records)}, update ({accum} micro-steps) {med_u * 1e3:.2f} ms over updates 2..{len(records) // accum}, "
        f"{cfg.global_batch_size / med_u:.2f} samples/s; loop wall {wall:.2f} s for {cfg.n_updates} updates incl. data "
        f"and validation; peak device memory {peak / 2**30:.2f} GiB; launches {launches}; saves asked at {saves}")
    n_val = max(1, cfg.eval_size // trainer.micro_batch_size)
    for metrics, n in validations:
        log(f"# Pi0FAST validation at update {cfg.n_updates}: {metrics}, flash_attention {n}")
    bad = [i + 1 for i, (n, loss, acc, gn, _) in enumerate(records)
           if not (np.isfinite(loss) and np.isfinite(acc) and np.isfinite(gn)) or n != want_flash]
    if bad or len(records) != cfg.n_updates * accum or saves != [cfg.n_updates]:
        raise SystemExit(f"Pi0FAST micro-steps {bad}: non-finite metrics or unexpected launches "
                         f"({len(records)} micro-steps, saves {saves})")
    if (len(validations) != 1 or validations[0][1] != n_val * (mc.vlm.depth - 1)
            or not np.isfinite(validations[0][0]["l1_loss"])):
        raise SystemExit(f"Pi0FAST validation: {validations}")
    batch = trainer.device_batch(next(iter(trainer.train_data)))
    profile_pass("Pi0FAST micro-step", lambda: (real_step(trainer.state, batch), torch.cuda.synchronize()))
    del trainer, batch, real_validate  # the bound validate would keep the trainer past gc.collect
    gc.collect()  # the recorders installed on the trainer refer back to it
    torch.cuda.empty_cache()
    compare_fast_grads()
    return {"flash_attention": launches["flash_attention"]}


def compare_fast_grads(depth: int = 4) -> None:
    """One micro-step's gradient of every parameter of the Pi0FAST recipe's
    model at full width and `depth` layers, through the attention kernel
    (each layer recomputed in the backward) and through the plain attention, from the
    same params and batch."""
    from intact_tpu_torch.data.dataset import InterleavedDataset
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.pi0fast import model as fast
    from intact_tpu_torch.models.tokenizer import HashTokenizer
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.train.trainer import preprocess_batch

    cfg = trainer_config(FAST_RECIPE, FAST_OVERRIDES)
    full = cfg.make_model_config()
    mc = dataclasses.replace(full, vlm=dataclasses.replace(full.vlm, depth=depth),
                             vision=dataclasses.replace(full.vision, depth=depth))
    policy = cm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.bfloat16)
    data = InterleavedDataset(cfg.data, 16, seed=7, image_size=mc.vision.image_size)
    raw = preprocess_batch(next(iter(data)), HashTokenizer(mc.vlm.vocab_size, mc.tokenizer_max_length), mc)
    batch = {k: torch.from_numpy(np.asarray(v)).to(DEVICE) for k, v in raw.items()}
    params = cm.flatten_paths(fast.init(mc, seed=1, device=DEVICE))
    out = {}
    for name, attn in (("kernel", "pallas"), ("plain", "xla")):
        views = {k: v.detach().requires_grad_() for k, v in params.items()}
        f0 = flash_attention.launches
        loss, aux = fast.compute_loss(cm.unflatten_paths(views), None, batch,
                                      dataclasses.replace(mc, attention_impl=attn), policy)
        grads = torch.autograd.grad(loss, list(views.values()))
        out[name] = (loss.item(), aux["token_accuracy"].item(), dict(zip(views, grads)), flash_attention.launches - f0)
        del views, grads
    (lk, ak, gk, nk), (lp, ap, gp, np_) = out["kernel"], out["plain"]
    shift = [k for k in gp if k.endswith("attn/k/bias")]
    num = sum((gk[k].double() - gp[k].double()).square().sum().item() for k in gp)
    den = sum(g.double().square().sum().item() for g in gp.values())
    grad_rel = (num / den) ** 0.5
    leaf_rel = sorted(((rel_l2(gk[k], gp[k]), k) for k in gp if k not in shift), reverse=True)
    log(f"# Pi0FAST kernel vs plain attention, one micro-step at full width and {depth} layers (batch 16, per-layer recompute): "
        f"loss {lk:.6f} vs {lp:.6f}, token_accuracy {ak:.4f} vs {ap:.4f}; gradients of the {len(gp)} leaves rel L2 "
        f"{grad_rel:.3e} (tol {FAST_GRAD_RTOL}), worst leaves {[(k, f'{r:.3e}') for r, k in leaf_rel[:3]]} (tol "
        f"{FAST_LEAF_RTOL}), median leaf {leaf_rel[len(leaf_rel) // 2][0]:.3e}; key biases (exact gradient 0) "
        f"|g| {max(gk[k].norm().item() for k in shift):.3e} / {max(gp[k].norm().item() for k in shift):.3e} of a "
        f"total {den ** 0.5:.3e}; flash_attention launches {nk} / {np_} (expect {2 * depth} / 0)")
    if not (grad_rel <= FAST_GRAD_RTOL and leaf_rel[0][0] <= FAST_LEAF_RTOL and nk == 2 * depth and np_ == 0
            and np.isfinite(lk)):
        raise SystemExit("Pi0FAST gradients through the attention kernel disagree with the plain path")
    del out, gk, gp, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 8. MVLA serving through the server role's wrapper: int8, bf16, mmmvla, DiT
# ---------------------------------------------------------------------------

MVLA_JSON = "config/models/mvla_bridge.json"
# the connector prompt (the 18-layer prefill over 436 tokens, then 12
# connector layers) through the attention kernel against through the plain
# attention, in bf16: relative L2
MVLA_PROMPT_RTOL = 5e-2
# VLM and expert layers of the served and trained MVLA (18 and 18 before phase 3e joined the script's budget, the
# expert 10 before phase 3f): the VLM is independent of the expert's depth (the expert reads the connector's
# prompt), the expert runs self/cross pairs (an even depth), and the launches and every gate follow the configuration
MVLA_VLM_DEPTH = 4
MVLA_EXPERT_DEPTH = 6


def mvla_depths() -> cut_depths:
    """MVLA and mmmvla at the depths the script serves them."""
    return cut_depths(("mvla", "vlm", MVLA_VLM_DEPTH), ("mmmvla", "vlm", MVLA_VLM_DEPTH),
                      ("mvla", "expert", MVLA_EXPERT_DEPTH), ("mmmvla", "expert", MVLA_EXPERT_DEPTH))


def mvla_model_cfg(model_type: str = "mvla") -> dict:
    return {**json.loads(Path(MVLA_JSON).read_text()), "type": model_type}


def mvla_per_inference(cfg) -> dict:
    """Kernel launches of one MVLA inference, counted from the configuration:
    the full prefill's attention in every VLM layer, then the expert's (the
    self layers of every Euler step; the joint expert's kv_only prompt
    prefill; none for the DiT head, whose attention is plain). W8A8 is
    counted for the int8 self/cross model, the one served in int8 here:
    SigLIP 6 per layer, img_proj, the prefill's 7 per layer, the connector's
    7 per layer, the cross layers' prompt k and v, and per Euler step 7 per
    self and 5 per cross layer; the joint expert and the DiT head are served
    in bf16 and launch none."""
    e, steps = cfg.expert, cfg.num_steps
    if cfg.action_head == "dit":
        return {"flash_attention": cfg.vlm.depth, "w8a8_matmul": 0}
    if cfg.alternate_pattern == "joint":
        return {"flash_attention": cfg.vlm.depth + e.depth - 1, "w8a8_matmul": 0}
    prefix_w8a8 = cfg.vision.depth * 6 + 1 + cfg.vlm.depth * 7 + cfg.connector.depth * 7
    return {"flash_attention": cfg.vlm.depth + steps * e.depth // 2,
            "w8a8_matmul": prefix_w8a8 + e.depth + steps * (e.depth // 2) * (7 + 5)}


def mvla_kernel_vs_plain(label: str, params, inputs, cfg, policy, noise) -> None:
    """The actions through the attention kernel against through the plain
    attention, same params, inputs and noise (ACTIONS_RTOL)."""
    from intact_tpu_torch.models.mvla import model as mvla

    a_kernel = mvla.sample_actions(params, None, *inputs, cfg, policy, noise=noise)
    a_plain = mvla.sample_actions(params, None, *inputs, dataclasses.replace(cfg, attention_impl="xla"), policy,
                                  noise=noise)
    rel = rel_l2(a_kernel, a_plain)
    log(f"# {label}: kernel vs plain attention, batch {noise.shape[0]} actions: rel L2 {rel:.3e} (rtol "
        f"{ACTIONS_RTOL}), max abs {(a_kernel - a_plain).abs().max().item():.3e}, max |a| "
        f"{a_plain.abs().max().item():.3e}")
    if not rel <= ACTIONS_RTOL:
        raise SystemExit(f"{label}: actions through the attention kernel disagree with the plain path")


def time_wrappers(label: str, runs: dict, requests: dict, steps: int, reps: dict, in_order: str | None = None,
                  annotation: str | None = None):
    """Median latency of infer_batch per wrapper, the wrappers alternating
    call by call, at each batch of `requests` ({batch: [request, ...]}, one
    single-row request per session); then one profiler pass each -> {(wrapper
    key, batch): profile_pass's result (with `in_order`, its launch times;
    with `annotation`, the device time inside those ranges)}."""
    for b, reqs in requests.items():
        times = {k: [] for k in runs}
        calls = {k: [(r, ss[i]) for i, r in enumerate(reqs)] for k, (w, ss) in runs.items()}
        for k, (w, _) in runs.items():
            w.infer_batch(calls[k])  # warm
        for _ in range(reps[b]):
            for k, (w, _) in runs.items():
                t0 = time.perf_counter()
                w.infer_batch(calls[k])  # ends in a device->host copy and the adapters' postprocess
                times[k].append(time.perf_counter() - t0)
        med = {k: statistics.median(v) for k, v in times.items()}
        for k in runs:
            log(f"# {label} {k} serving batch {b} ({type(runs[k][0]).__name__}.infer_batch): median fused inference "
                f"{med[k] * 1e3:.2f} ms over {reps[b]} ({[round(x * 1e3, 2) for x in times[k]]}), "
                f"{b * steps / med[k]:.2f} policy steps/s")
        if len(runs) == 2:
            a, c = runs
            log(f"# {label} serving batch {b} through the wrapper: {a} / {c} latency {med[a] / med[c]:.3f}")
    profiles = {}
    for b, reqs in requests.items():
        for k, (w, ss) in runs.items():
            calls = [(r, ss[i]) for i, r in enumerate(reqs)]
            profiles[k, b] = profile_pass(f"{label} {k} wrapper batch {b}", lambda: w.infer_batch(calls), in_order,
                                          annotation)
    return profiles


def phase_mvla_serving() -> dict:
    """-> {kernel: launches} on MVLA's serving paths (int8 mvla, bf16
    mmmvla, the DiT head), each path's counts set to 0 just before it, at
    MVLA_VLM_DEPTH VLM and MVLA_EXPERT_DEPTH expert layers."""
    with mvla_depths():
        return mvla_serving()


def mvla_serving() -> dict:
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.mvla import model as mvla
    from intact_tpu_torch.models.pi0 import model as pi0
    from intact_tpu_torch.ops import w8a8
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    cfg = ev_config(model_cfg=mvla_model_cfg())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wrapper = make_policy_wrapper(cfg, device=DEVICE)
    torch.cuda.synchronize()
    mc, policy = wrapper.model_cfg, wrapper.policy
    leaves = cm.tree_leaves(policy.params)
    want = mvla_per_inference(mc)
    log(f"# MVLA serving: Pi0PolicyWrapper from {EV_CONFIG} with {MVLA_JSON} ({cfg.model_type}, model "
        f"{policy.model.__name__}, quantize_int8 {cfg.eval_cfg.quantize_int8}, seed {cfg.seed}): "
        f"{sum(x.numel() for x in leaves if x.dtype == torch.int8) / 1e9:.3f} B int8 weights + "
        f"{sum(x.numel() for x in leaves if x.dtype != torch.int8) / 1e9:.3f} B bf16/fp32 values, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, init {time.perf_counter() - t0:.2f} s; prefix "
        f"{mc.vision.num_patches + mc.tokenizer_max_length + mc.num_metaqueries} tokens, connector "
        f"{mc.connector.depth} layers, expert {mc.expert.depth} layers ({mc.alternate_pattern}), chunk "
        f"{mc.chunk_size}, {mc.num_steps} Euler steps; expect {want} launches per inference")

    rng = np.random.default_rng(4)
    size = mc.vision.image_size
    sessions = [wrapper.new_session() for _ in range(64)]
    req1, req64 = wire_inputs(rng, 1, size), wire_inputs(rng, 64, size)
    counters = {"flash_attention": flash_attention, "w8a8_matmul": w8a8.w8a8_matmul}

    def fused(w, items, expect, label):
        before = {k: c.launches for k, c in counters.items()}
        out = w.infer_batch(items)
        grew = {k: c.launches - before[k] for k, c in counters.items()}
        if grew != expect:
            raise SystemExit(f"one fused {label} inference launched {grew}; expected {expect}")
        for a in out:
            if isinstance(a, Exception) or a.shape != (cfg.eval_cfg.action_step, 7) or not np.isfinite(a).all():
                raise SystemExit(f"bad {label} serving result {a!r:.200}")
        return out

    # --- the main path: fused requests through the wrapper, as the batching server calls it ---
    flash_attention.launches = w8a8.w8a8_matmul.launches = 0
    for _ in range(2):
        fused(wrapper, [(req1[0], sessions[0])], want, "int8 MVLA")
    fused(wrapper, list(zip(req64, sessions)), want, "int8 MVLA")
    launches = {k: c.launches for k, c in counters.items()}
    # -------------------------------------------------------------------------------------------
    log(f"# MVLA int8 serving: 3 fused inferences (batch 1, 1, 64), launches {launches}, env actions of shape "
        f"({cfg.eval_cfg.action_step}, 7), finite")

    # int8: the actions with the W8A8 kernel against those with only its product plain
    batch = {"image": np.concatenate([r["image"] for r in req64]),
             "state": np.concatenate([r["state"] for r in req64]), "task": [r["task"][0] for r in req64]}
    inputs = policy.device_inputs(batch)
    noise = pi0.sample_noise(torch.Generator(device=DEVICE).manual_seed(5), (64, mc.chunk_size, mc.max_action_dim),
                             DEVICE)
    n0 = w8a8.w8a8_matmul.launches
    a_kernel = mvla.sample_actions(policy.params, None, *inputs, mc, policy.policy, noise=noise)
    n1 = w8a8.w8a8_matmul.launches
    real = w8a8.w8a8_matmul
    w8a8.w8a8_matmul = plain_w8a8  # the plain W8A8 product, for this comparison only
    try:
        a_w8a8_plain = mvla.sample_actions(policy.params, None, *inputs, mc, policy.policy, noise=noise)
    finally:
        w8a8.w8a8_matmul = real
    same = torch.equal(a_kernel, a_w8a8_plain)
    log(f"# MVLA int8, batch 64: actions with only the W8A8 product plain bit-equal {same} (gate: bit-equal; "
        f"kernel run {n1 - n0} w8a8_matmul launches, plain run {w8a8.w8a8_matmul.launches - n1})")
    if not same or n1 - n0 != want["w8a8_matmul"] or w8a8.w8a8_matmul.launches != n1:
        raise SystemExit("int8 MVLA actions with the W8A8 kernel differ from those with its plain version")
    mvla_kernel_vs_plain("MVLA int8", policy.params, inputs, mc, policy.policy, noise)
    del a_w8a8_plain
    torch.cuda.reset_peak_memory_stats()
    for items in ([(req1[0], sessions[0])], list(zip(req64, sessions))):
        wrapper.infer_batch(items)
    int8_peak = torch.cuda.max_memory_allocated()

    # bf16: the same random weights behind the same wrapper, quantize_int8 off
    bf16_wrapper = make_policy_wrapper(ev_config(quantize=False, model_cfg=mvla_model_cfg()), device=DEVICE)
    bf16_sessions = [bf16_wrapper.new_session() for _ in range(64)]
    bp, bpol = bf16_wrapper.policy.params, bf16_wrapper.policy.policy
    with torch.inference_mode():
        p_kernel = mvla.compute_prompt(bp, *inputs[:4], mc, bpol)
        p_plain = mvla.compute_prompt(bp, *inputs[:4], dataclasses.replace(mc, attention_impl="xla"), bpol)
    prompt_rel = rel_l2(p_kernel, p_plain)
    log(f"# MVLA bf16, batch 64: connector prompt {tuple(p_kernel.shape)} through the attention kernel vs plain "
        f"attention rel L2 {prompt_rel:.3e} (tol {MVLA_PROMPT_RTOL}), max abs "
        f"{(p_kernel - p_plain).abs().max().item():.3e} (max |prompt| {p_plain.abs().max().item():.3e})")
    if not prompt_rel <= MVLA_PROMPT_RTOL:
        raise SystemExit("the MVLA connector prompt through the attention kernel disagrees with the plain path")
    del p_kernel, p_plain
    mvla_kernel_vs_plain("MVLA bf16", bp, inputs, mc, bpol, noise)
    a_bf16 = mvla.sample_actions(bp, None, *inputs, mc, bpol, noise=noise)
    log(f"# MVLA int8 vs bf16 actions (same random weights, inputs and noise, batch 64): rel L2 "
        f"{rel_l2(a_kernel, a_bf16):.3e} (no gate on random weights)")
    del a_kernel, a_bf16
    torch.cuda.empty_cache()

    runs = {"int8": (wrapper, sessions), "bf16": (bf16_wrapper, bf16_sessions)}
    torch.cuda.reset_peak_memory_stats()
    # policy steps: the eval_cfg.action_step actions each row's answer carries
    time_wrappers("MVLA", runs, {1: req1, 64: req64}, cfg.eval_cfg.action_step, {1: 5, 64: 3})
    log(f"# MVLA peak device memory: int8 wrapper alone {int8_peak / 2**30:.2f} GiB (batch 1 and 64); both wrappers "
        f"during the timing {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del wrapper, policy, bf16_wrapper, runs, bp, sessions, bf16_sessions
    gc.collect()
    torch.cuda.empty_cache()

    # mmmvla: the joint expert in bf16, batch 64
    jwrapper = make_policy_wrapper(ev_config(quantize=False, model_cfg=mvla_model_cfg("mmmvla")), device=DEVICE)
    jmc, jpol = jwrapper.model_cfg, jwrapper.policy
    jwant = mvla_per_inference(jmc)
    jsessions = [jwrapper.new_session() for _ in range(64)]
    # --- the main path: one fused batch-64 inference of the joint expert ---
    flash_attention.launches = w8a8.w8a8_matmul.launches = 0
    fused(jwrapper, list(zip(req64, jsessions)), jwant, "bf16 mmmvla")
    joint = {k: c.launches for k, c in counters.items()}
    # ------------------------------------------------------------------------
    log(f"# mmmvla bf16 serving ({jmc.alternate_pattern} expert, {jmc.expert.depth} layers over [108 prompt | "
        f"{1 + jmc.chunk_size} suffix]): 1 fused batch-64 inference, launches {joint} (expect {jwant})")
    mvla_kernel_vs_plain("mmmvla bf16", jpol.params, inputs, jmc, jpol.policy, noise)
    torch.cuda.reset_peak_memory_stats()
    time_wrappers("mmmvla", {"bf16": (jwrapper, jsessions)}, {64: req64}, cfg.eval_cfg.action_step, {64: 3})
    log(f"# mmmvla peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del jwrapper, jpol, jsessions
    gc.collect()
    torch.cuda.empty_cache()

    # the DiT head (action_head "dit") in bf16 through sample_actions at batch 64; its
    # adaLN-Zero leaves and output projection start at 0 (eps = 0 whatever the
    # prompt), so they are drawn from the seed as well
    dmc = dataclasses.replace(mc, action_head="dit")
    dparams = mvla.init(dmc, SERVING_SEED, DEVICE, torch.bfloat16)
    gen = torch.Generator(device=DEVICE).manual_seed(SERVING_SEED + 1)
    for leaf in cm.tree_leaves(dparams["dit"]):
        if not leaf.any():
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device=DEVICE) * 0.02)
    dwant = mvla_per_inference(dmc)
    # --- the main path: sample_actions with the DiT head, batch 64 ---
    flash_attention.launches = w8a8.w8a8_matmul.launches = 0
    a_dit = mvla.sample_actions(dparams, torch.Generator(device=DEVICE).manual_seed(6), *inputs, dmc, cm.SERVING_POLICY)
    dit = {k: c.launches for k, c in counters.items()}
    # ------------------------------------------------------------------
    log(f"# MVLA DiT head (DiT {dmc.dit_depth} layers x {dmc.dit_width}, {dmc.num_steps} DDIM steps of "
        f"{dmc.diffusion_steps}), batch 64: actions {tuple(a_dit.shape)}, finite {bool(torch.isfinite(a_dit).all())}, "
        f"max |a| {a_dit.abs().max().item():.3e}, launches {dit} (expect {dwant})")
    if dit != dwant or a_dit.shape != (64, dmc.chunk_size, dmc.max_action_dim) or not torch.isfinite(a_dit).all():
        raise SystemExit("the MVLA DiT head's sampler launched unexpectedly or gave bad actions")
    mvla_kernel_vs_plain("MVLA DiT bf16", dparams, inputs, dmc, cm.SERVING_POLICY, noise)
    ms = cuda_ms(lambda: mvla.sample_actions(dparams, None, *inputs, dmc, cm.SERVING_POLICY, noise=noise), reps=3,
                 warmup=1)
    log(f"# MVLA DiT head batch 64: median sample_actions {ms:.2f} ms over 3 (CUDA events)")
    del dparams, a_dit, inputs
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] + joint[k] + dit[k] for k in counters}


# ---------------------------------------------------------------------------
# 9. MVLA training: the full tower through the trainer's standard step
# ---------------------------------------------------------------------------

MVLA_OVERRIDES = {"mesh.fsdp": 1, "per_device_batch_size": 32, "global_batch_size": 64, "n_updates": 2,
                  "eval_freq": 2, "eval_size": 32, "save_model_freq": 2}
# one micro-step's gradient of every leaf through the attention kernel
# against through the plain attention, at full width and 4 layers of each
# tower (SigLIP, Gemma, connector, expert); SigLIP's key biases (exact
# gradient 0) are left out of the per-leaf gate
MVLA_GRAD_RTOL = 2e-2
MVLA_LEAF_RTOL = 5e-2


def phase_mvla_training() -> dict:
    """config/train/pi0_finetune_bridge.yaml with mvla_bridge.json as its
    model (bf16 masters, 8-bit AdamW, SR, remat, the full tower at
    MVLA_VLM_DEPTH VLM and MVLA_EXPERT_DEPTH expert layers) through the Trainer: 2 updates of 2
    micro-steps of 32 (the recipe's per-device batch), validation at update
    2 on one batch, a save at update 2 and a resume from it; then the
    gradients against the plain attention and the frozen leaves of a
    freeze_vlm run. -> {kernel: launches}."""
    with cut_depths(("mvla", "vlm", MVLA_VLM_DEPTH), ("mvla", "expert", MVLA_EXPERT_DEPTH)):
        return mvla_training()


def mvla_training() -> dict:
    import shutil

    from intact_tpu_torch.models.common import flatten_paths
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.train import checkpoint as ckpt
    from intact_tpu_torch.train.trainer import Trainer

    cfg = trainer_config(JOINT_RECIPE, MVLA_OVERRIDES, model_cfg=mvla_model_cfg())
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=DEVICE)
    torch.cuda.synchronize()
    mc, accum = trainer.model_cfg, trainer.opt_cfg.grad_accumulation_steps
    params = flatten_paths(trainer.state.params)
    mu = trainer.state.opt_state["mu"]
    # the prefill's layers and their recompute in the backward, and the
    # expert's self layers (the expert runs without recompute, as the reference's)
    want = 2 * mc.vlm.depth + mc.expert.depth // 2
    want_val = mvla_per_inference(mc)["flash_attention"]
    log(f"# MVLA training: {JOINT_RECIPE} with {MVLA_JSON} ({cfg.model_type}), "
        f"{sum(v.numel() for v in params.values()) / 1e9:.3f} B params {sorted({str(v.dtype) for v in params.values()})}"
        f", frozen set {'none' if trainer.frozen_mask is None else 'some'} (freeze_lm_head freezes pi0's embedding "
        f"only), 8-bit moments on {sum(isinstance(m, dict) for m in mu.values())} of {len(mu)} leaves, micro-batch "
        f"{trainer.micro_batch_size} x accumulation {accum}, init {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card; per micro-step expect {want} flash_attention "
        f"launches, {want_val} per validation batch")
    counters = {"flash_attention": flash_attention}
    records = record_steps(trainer, counters)
    validations = []
    real_validate = trainer.validate

    def validate():
        f0 = flash_attention.launches
        metrics = real_validate()
        validations.append((metrics, flash_attention.launches - f0))
        return metrics

    trainer.validate = validate
    # --- the main path: the trainer's loop, as `python -m intact_tpu_torch.run` drives it ---
    flash_attention.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches}
    # -------------------------------------------------------------------------------------------
    report_steps("MVLA", records, accum, cfg.global_batch_size)
    log(f"# MVLA training: loop wall {wall:.2f} s for {cfg.n_updates} updates incl. data, validation and the save; "
        f"launches {launches}")
    for metrics, n in validations:
        log(f"# MVLA validation at update {cfg.n_updates}: {metrics}, flash_attention {n}")
    n_val = max(1, cfg.eval_size // trainer.micro_batch_size)
    codes = {m["q"].dtype for m in trainer.state.opt_state["mu"].values() if isinstance(m, dict)}
    bad = [i + 1 for i, (n, loss, gn, pn, _) in enumerate(records)
           if not (np.isfinite(loss) and np.isfinite(gn) and np.isfinite(pn)) or n["flash_attention"] != want]
    if (bad or len(records) != cfg.n_updates * accum or codes != {torch.int8} or trainer.frozen_mask is not None
            or len(validations) != 1 or validations[0][1] != n_val * want_val
            or not np.isfinite(validations[0][0]["l1_loss"])):
        raise SystemExit(f"MVLA training: micro-steps {bad} non-finite or unexpected launches, codes {codes}, "
                         f"frozen set {trainer.frozen_mask is not None}, validations {validations}")
    steps = ckpt.list_steps(trainer.ckpt_root, committed_only=True)
    resumed = Trainer(trainer_config(JOINT_RECIPE, {**MVLA_OVERRIDES, "load_from_checkpoint": trainer.ckpt_root / "step_2"},
                                     model_cfg=mvla_model_cfg()), device=DEVICE)
    ia, ib = state_items(trainer.state), state_items(resumed.state)
    unequal = [k for k, v in ia.items()
               if not (torch.equal(v, ib[k]) if isinstance(v, torch.Tensor) else v == ib.get(k))]
    log(f"# MVLA checkpoints {steps}; resumed from step_2: cnt_update {resumed.cnt_update}, {len(ia)} state entries, "
        f"{len(unequal)} unequal")
    if steps != [2] or resumed.cnt_update != 2 or set(ia) != set(ib) or unequal:
        raise SystemExit(f"MVLA checkpoints {steps} / resume: cnt_update {resumed.cnt_update}, unequal {unequal[:5]}")
    del resumed, ia, ib
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    batch = trainer.device_batch(next(iter(trainer.train_data)))
    profile_pass("MVLA micro-step", lambda: (trainer.train_step(trainer.state, batch), torch.cuda.synchronize()))
    del trainer, batch, real_validate  # the bound validate would keep the trainer past gc.collect
    gc.collect()  # the recorders installed on the trainer refer back to it
    torch.cuda.empty_cache()
    compare_mvla_grads()
    mvla_frozen_vlm()
    return launches


def mvla_frozen_vlm() -> None:
    """One update of the MVLA recipe with freeze_vlm (the VLM and its
    embedding frozen; the metaqueries train through it), at lr 1e-2 and no
    warmup so that a trainable leaf moves by far more than a bf16 ulp:
    every frozen leaf stays bit-equal, the metaqueries move."""
    import shutil

    from intact_tpu_torch.models.common import flatten_paths
    from intact_tpu_torch.train.trainer import Trainer

    overrides = {**MVLA_OVERRIDES, "per_device_batch_size": 16, "global_batch_size": 16, "n_updates": 1,
                 "eval_freq": 100, "save_model_freq": 100, "freeze_vlm": True, "model_cfg.optimizer_lr": 1e-2,
                 "model_cfg.scheduler_warmup_steps": 0}
    trainer = Trainer(trainer_config(JOINT_RECIPE, overrides, model_cfg=mvla_model_cfg()), device=DEVICE)
    params = flatten_paths(trainer.state.params)
    frozen = {k for k, t in flatten_paths(trainer.frozen_mask).items() if not t}
    before = {k: v.clone() for k, v in params.items()}
    trainer.train()
    after = flatten_paths(trainer.state.params)
    changed_frozen = [k for k in frozen if not torch.equal(after[k], before[k])]
    moved = {k for k in after if k not in frozen and not torch.equal(after[k], before[k])}
    log(f"# MVLA freeze_vlm, 1 update of 16: {len(frozen)} frozen leaves "
        f"({sum(before[k].numel() for k in frozen) / 1e9:.3f} B values, all under vlm/ and vlm_embed/: "
        f"{all(k.startswith(('vlm/', 'vlm_embed/')) for k in frozen)}), {len(changed_frozen)} changed; {len(moved)} of "
        f"{len(after) - len(frozen)} trainable leaves moved, metaquery moved {'metaquery' in moved}")
    if (trainer.cnt_update != 1 or not frozen or changed_frozen or "metaquery" not in moved
            or not all(k.startswith(("vlm/", "vlm_embed/")) for k in frozen)
            or len(moved) < (len(after) - len(frozen)) // 2):
        raise SystemExit(f"MVLA freeze_vlm: frozen leaves changed {changed_frozen[:5]} or too few trainable "
                         f"leaves moved ({len(moved)})")
    del trainer, params, before, after
    shutil.rmtree(RUN_DIR, ignore_errors=True)  # the trainer saves its last update
    gc.collect()
    torch.cuda.empty_cache()


def compare_mvla_grads(depth: int = 4) -> None:
    """One micro-step's gradient of every leaf of the MVLA recipe's model at
    full width and `depth` layers of SigLIP, Gemma, the connector and the
    expert, through the attention kernel and through the plain attention,
    from the same params, batch and draws."""
    from intact_tpu_torch.data.dataset import InterleavedDataset
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.mvla import model as mvla
    from intact_tpu_torch.models.tokenizer import HashTokenizer
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.train.trainer import preprocess_batch

    cfg = trainer_config(JOINT_RECIPE, MVLA_OVERRIDES, model_cfg=mvla_model_cfg())
    full = cfg.make_model_config()
    mc = dataclasses.replace(full, vlm=dataclasses.replace(full.vlm, depth=depth),
                             vision=dataclasses.replace(full.vision, depth=depth),
                             expert=dataclasses.replace(full.expert, depth=depth),
                             connector=dataclasses.replace(full.connector, depth=depth))
    policy = cm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.bfloat16)
    data = InterleavedDataset(cfg.data, 16, seed=7, image_size=mc.vision.image_size)
    raw = preprocess_batch(next(iter(data)), HashTokenizer(mc.vlm.vocab_size, mc.tokenizer_max_length), mc)
    batch = {k: torch.from_numpy(np.asarray(v)).to(DEVICE) for k, v in raw.items()}
    params = cm.flatten_paths(mvla.init(mc, seed=1, device=DEVICE))
    out = {}
    for name, attn in (("kernel", "pallas"), ("plain", "xla")):
        views = {k: v.detach().requires_grad_() for k, v in params.items()}
        f0 = flash_attention.launches
        loss, _ = mvla.compute_loss(cm.unflatten_paths(views), np.random.default_rng(3), batch,
                                    dataclasses.replace(mc, attention_impl=attn), policy)
        grads = torch.autograd.grad(loss, list(views.values()))
        out[name] = (loss.item(), dict(zip(views, grads)), flash_attention.launches - f0)
        del views, grads
    (lk, gk, nk), (lp, gp, np_) = out["kernel"], out["plain"]
    shift = [k for k in gp if k.endswith("attn/k/bias")]
    num = sum((gk[k].double() - gp[k].double()).square().sum().item() for k in gp)
    den = sum(g.double().square().sum().item() for g in gp.values())
    grad_rel = (num / den) ** 0.5
    leaf_rel = sorted(((rel_l2(gk[k], gp[k]), k) for k in gp if k not in shift), reverse=True)
    want = 2 * depth + depth // 2
    log(f"# MVLA kernel vs plain attention, one micro-step at full width and {depth} layers per tower (batch 16): "
        f"loss {lk:.6f} vs {lp:.6f}; gradients of the {len(gp)} leaves rel L2 {grad_rel:.3e} (tol {MVLA_GRAD_RTOL}), "
        f"worst leaves {[(k, f'{r:.3e}') for r, k in leaf_rel[:3]]} (tol {MVLA_LEAF_RTOL}), median leaf "
        f"{leaf_rel[len(leaf_rel) // 2][0]:.3e}, metaquery {rel_l2(gk['metaquery'], gp['metaquery']):.3e}; "
        f"flash_attention launches {nk} / {np_} (expect {want} / 0)")
    if not (grad_rel <= MVLA_GRAD_RTOL and leaf_rel[0][0] <= MVLA_LEAF_RTOL and nk == want and np_ == 0
            and np.isfinite(lk)):
        raise SystemExit("MVLA gradients through the attention kernel disagree with the plain path")
    del out, gk, gp, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 10. SpatialVLA serving: the native wrapper in int8 and bf16
# ---------------------------------------------------------------------------

SVLA_EV_CONFIG = "config/experiment/simpler/spatialvla_finetune_bridge_ev.yaml"
# the yaml's adapter, BridgeSimplerSpatialVLAAdapter, is defined in neither
# package (scripts/gen_experiment_configs.py makes up the name): the Bridge
# adapter serves in its place
SVLA_OVERRIDES = {"eval_cfg.env_adapter": "BridgeSimplerAdapter"}
SVLA_FP32_DEPTH = 4  # Gemma2 layers of the bf16-against-fp32 comparison (views of the bf16 tree), as Magma's
SVLA_TIMING_REPS = 3  # timed inferences per wrapper and batch (5 before phase 5b joined the script's budget)
# Gemma2 layers served of SpatialVLA-4B's 26 (full width), the script's time limit's cut since phase 3c (13
# until phase 3d joined the budget, 7 until phase 3e did)
SVLA_SERVING_DEPTH = 4


def svla_config(quantize: bool):
    """The server role's config from the SpatialVLA yaml: model_cfg
    {"type": "spatialvla_native"}, no checkpoint (random weights from the
    seed), the hash tokenizer."""
    return ev_config(quantize, path=SVLA_EV_CONFIG, model_cfg={"type": "spatialvla_native"}, overrides=SVLA_OVERRIDES)


def svla_per_inference(cfg) -> int:
    """W8A8 launches of one int8 SpatialVLA inference, from the configuration:
    SigLIP 6 per layer, img_proj, the Gemma2 prefill's 7 per layer and the
    first token's unembedding, then for each token fed back (all but the
    last) 7 per layer and the unembedding. The Ego3D MLP and the patch
    embedding stay fp."""
    step = cfg.lm.depth * 7 + 1
    return cfg.vision.depth * 6 + 1 + step * cfg.tokens_per_action * cfg.n_action_steps


def svla_requests(rng: np.random.Generator, cfg, b: int) -> list[dict]:
    """b single-row requests as SpatialVLASession.preprocess emits them: a
    resized uint8 frame, the flat-depth prior, one task string."""
    from intact_tpu_torch.models.spatialvla import model as svla

    obs = make_obs(rng, b, cfg.vision.image_size)
    return [{"image": obs["image"][i:i + 1], "depth": svla.flat_depth(1, cfg), "task": [obs["task"][i]]}
            for i in range(b)]


def svla_inputs(wrapper, reqs: list[dict]) -> tuple:
    """The wrapper's device inputs for the fused requests (images normalized)."""
    cfg = wrapper.model_cfg
    lang, masks = wrapper.tokenizer([r["task"][0] for r in reqs], cfg.tokenizer_max_length)
    images = np.concatenate([r["image"] for r in reqs])
    return (wrapper.model.normalize_images(wrapper._put(images)), wrapper._put(np.concatenate([r["depth"] for r in reqs])),
            wrapper._put(lang), wrapper._put(masks))


def svla_greedy_logits(params, inputs, cfg, policy, forced=None):
    """`predict_action_tokens` step by step from its own pieces -> (tokens
    [B, T], softcapped logits [T, B, V] fp32); with `forced` [B, T] the given
    tokens are fed back in place of the argmax (teacher forcing)."""
    from intact_tpu_torch.models import gemma2
    from intact_tpu_torch.models.spatialvla import model as svla

    n = cfg.tokens_per_action * cfg.n_action_steps
    with torch.inference_mode():
        embeds, mask = svla.embed_prefix(params, *inputs, cfg, policy)
        last, cache, key_valid, key_pos, pos = gemma2.prefill(params["lm"], embeds, mask, n, cfg.lm, policy,
                                                              prefix_full_attention=True)
        p_len = embeds.shape[1]
        logits = [gemma2.logits(params["lm"], last, cfg.lm, policy)]
        tokens = [logits[-1].argmax(dim=-1)]
        for s in range(n - 1):
            feed = tokens[-1] if forced is None else forced[:, s]
            h = gemma2.decode_step(params["lm"], feed, cache, p_len + s, key_valid, key_pos, pos + s, cfg.lm, policy)
            logits.append(gemma2.logits(params["lm"], h, cfg.lm, policy))
            tokens.append(logits[-1].argmax(dim=-1))
        return torch.stack(tokens, dim=1), torch.stack(logits)


def phase_svla_serving() -> dict:
    """-> {kernel: launches} on SpatialVLA's int8 serving path (the bf16 path
    launches none of the three kernels: SigLIP and Gemma2 attention are
    plain, as in the reference), at full width and SVLA_SERVING_DEPTH Gemma2
    layers."""
    with cut_depths(("spatialvla_native", "lm", SVLA_SERVING_DEPTH)):
        return svla_serving()


def svla_serving() -> dict:
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.ops import w8a8
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    cfg = svla_config(quantize=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wrapper = make_policy_wrapper(cfg, device=DEVICE)
    torch.cuda.synchronize()
    mc = wrapper.model_cfg
    leaves = cm.tree_leaves(wrapper.params)
    want = {"flash_attention": 0, "w8a8_matmul": svla_per_inference(mc)}
    n_tok, vocab, offset = mc.tokens_per_action * mc.n_action_steps, mc.lm.vocab_size, mc.spatial_offset
    log(f"# SpatialVLA serving: {type(wrapper).__name__} from {SVLA_EV_CONFIG} ({cfg.model_type}, adapter "
        f"{cfg.eval_cfg.env_adapter}, quantize_int8 {cfg.eval_cfg.quantize_int8}, seed {cfg.seed}): "
        f"{sum(x.numel() for x in leaves if x.dtype == torch.int8) / 1e9:.3f} B int8 weights + "
        f"{sum(x.numel() for x in leaves if x.dtype != torch.int8) / 1e9:.3f} B bf16/fp32 values, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, init {time.perf_counter() - t0:.2f} s; prefix "
        f"{mc.vision.num_patches} image + {mc.tokenizer_max_length} language tokens, {n_tok} greedy tokens over a "
        f"vocabulary of {vocab} (spatial from {offset}); expect {want} launches per inference")

    rng = np.random.default_rng(5)
    req1, req64 = svla_requests(rng, mc, 1), svla_requests(rng, mc, 64)
    s1, sessions = wrapper.new_session(), [wrapper.new_session() for _ in range(64)]
    counters = {"flash_attention": flash_attention, "w8a8_matmul": w8a8.w8a8_matmul}

    def fused(w, items, expect, label):
        before = {k: c.launches for k, c in counters.items()}
        out = w.infer_batch(items)
        grew = {k: c.launches - before[k] for k, c in counters.items()}
        if grew != expect:
            raise SystemExit(f"one fused {label} inference launched {grew}; expected {expect}")
        for a in out:
            if isinstance(a, Exception) or a.shape != (1, 7) or not np.isfinite(a).all():
                raise SystemExit(f"bad {label} serving result {a!r:.200}")
        return out

    # --- the main path: fused requests through the wrapper, as the batching server calls it ---
    flash_attention.launches = w8a8.w8a8_matmul.launches = 0
    for _ in range(2):
        fused(wrapper, [(req1[0], s1)], want, "int8 SpatialVLA")
    out64 = fused(wrapper, list(zip(req64, sessions)), want, "int8 SpatialVLA")
    launches = {k: c.launches for k, c in counters.items()}
    # -------------------------------------------------------------------------------------------
    log(f"# SpatialVLA int8 serving: 3 fused inferences (batch 1, 1, 64), launches {launches}, ensembled env "
        f"actions of shape (1, 7), finite")

    # int8: the tokens and every step's logits with the W8A8 kernel against with only its product plain
    inputs = svla_inputs(wrapper, req64)
    images, depth = np.concatenate([r["image"] for r in req64]), np.concatenate([r["depth"] for r in req64])
    tasks = [r["task"][0] for r in req64]
    ids = wrapper.predict_tokens(images, depth, tasks)  # the wrapper's device call
    tokens, log_k = svla_greedy_logits(wrapper.params, inputs, mc, wrapper.policy)
    stepwise = np.array_equal(tokens.cpu().numpy(), ids)
    in_vocab = bool(((tokens >= 0) & (tokens < vocab)).all())
    spatial = ((tokens >= offset) & (tokens < vocab)).float().mean().item()
    # the batch-64 sessions were fresh: each env action is its chunk's first action, postprocessed
    env = [sessions[i].adapter.postprocess(
        wrapper.action_tokenizer.decode(ids[i].reshape(mc.n_action_steps, mc.tokens_per_action))[:1]) for i in range(64)]
    same_as_served = all(np.array_equal(e, o) for e, o in zip(env, out64))
    real = w8a8.w8a8_matmul
    n0 = w8a8.w8a8_matmul.launches
    w8a8.w8a8_matmul = plain_w8a8  # the plain W8A8 product, for this comparison only
    try:
        ids_plain = wrapper.predict_tokens(images, depth, tasks)
        tok_p, log_p = svla_greedy_logits(wrapper.params, inputs, mc, wrapper.policy, forced=tokens)
    finally:
        w8a8.w8a8_matmul = real
    same = np.array_equal(ids_plain, ids) and torch.equal(tok_p, tokens) and torch.equal(log_p, log_k)
    log(f"# SpatialVLA int8, batch 64: {tokens.numel()} tokens in [0, {vocab}) {in_vocab}, "
        f"{tokens.unique().numel()} distinct, spatial share {spatial:.4f} (random weights: the greedy argmax runs over "
        f"the whole vocabulary, as in the reference, and the spatial rows are "
        f"{(vocab - offset) / vocab:.4f} of it; not gated); the stepwise decode equals the wrapper's {stepwise}; the "
        f"served env actions equal the decoded tokens' {same_as_served}; with only the W8A8 product plain (the "
        f"unembedding included): tokens and every step's teacher-forced logits bit-equal {same} (gates: all; plain "
        f"runs launched w8a8_matmul {w8a8.w8a8_matmul.launches - n0} times)")
    if not (in_vocab and stepwise and same_as_served and same and w8a8.w8a8_matmul.launches == n0):
        raise SystemExit("SpatialVLA int8: tokens outside the vocabulary, the W8A8 kernel's tokens or logits differ "
                         "from its plain version's, or the served actions differ from the checked tokens'")
    del log_p, tok_p
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for items in ([(req1[0], s1)], list(zip(req64, sessions))):
        wrapper.infer_batch(items)
    int8_peak = torch.cuda.max_memory_allocated()

    # bf16: the same random weights behind the same wrapper, quantize_int8 off; against an fp32 run of them
    bf16_wrapper = make_policy_wrapper(svla_config(quantize=False), device=DEVICE)
    bf16_sessions = [bf16_wrapper.new_session() for _ in range(64)]
    bp, bpol = bf16_wrapper.params, bf16_wrapper.policy
    tok_b, log_b = svla_greedy_logits(bp, inputs, mc, bpol)
    ids_b = bf16_wrapper.predict_tokens(images, depth, tasks)
    # bf16 against fp32 at full width and SVLA_FP32_DEPTH Gemma2 layers (views of the bf16 tree)
    mc4 = dataclasses.replace(mc, lm=dataclasses.replace(mc.lm, depth=SVLA_FP32_DEPTH))
    bp4 = {**bp, "lm": {**bp["lm"], "blocks": cm.tree_map(lambda a: a[:SVLA_FP32_DEPTH], bp["lm"]["blocks"])}}
    tok_b4, log_b = svla_greedy_logits(bp4, inputs, mc4, bpol)
    fp32 = cm.tree_map(lambda x: x.float(), bp4)
    tok_f, _ = svla_greedy_logits(fp32, inputs, mc4, cm.FP32_POLICY)
    _, log_ff = svla_greedy_logits(fp32, inputs, mc4, cm.FP32_POLICY, forced=tok_b4)  # teacher-forced fp32
    del fp32, bp4
    chosen = log_ff.gather(-1, tok_b4.T[..., None])[..., 0]  # [T, B]
    below = (log_ff.amax(dim=-1) - chosen) / log_ff.std()
    top2 = log_b.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).flatten()
    log(f"# SpatialVLA bf16, batch 64: the stepwise decode equals the wrapper's {np.array_equal(tok_b.cpu().numpy(), ids_b)}; "
        f"at {SVLA_FP32_DEPTH} of {mc.lm.depth} Gemma2 layers, tokens equal to an fp32 run of the same weights on the "
        f"card {(tok_b4 == tok_f).float().mean().item():.4f}; "
        f"teacher-forced fp32 logits rel L2 {rel_l2(log_b, log_ff):.3e}, fp32 logit of the bf16 token below the fp32 "
        f"maximum by at most {below.max().item():.3e} std (at {int((below > 0).sum())} of {below.numel()} steps and "
        f"rows); bf16 top-2 logit margin median {gap.median().item():.3e}, min {gap.min().item():.3e} (logits std "
        f"{log_b.std().item():.3e}); int8 tokens equal to bf16's {(tokens == tok_b).float().mean().item():.4f} "
        f"(reported, no gate)")
    if not bool(((tok_b >= 0) & (tok_b < vocab)).all()) or not np.array_equal(tok_b.cpu().numpy(), ids_b):
        raise SystemExit("SpatialVLA bf16: the wrapper's tokens differ from the stepwise decode's")
    del log_b, log_ff, log_k, inputs
    gc.collect()
    torch.cuda.empty_cache()

    runs = {"int8": (wrapper, sessions), "bf16": (bf16_wrapper, bf16_sessions)}
    torch.cuda.reset_peak_memory_stats()
    # one ensembled env action per inference: 1 policy step per row
    # the unembedding is the path's only W8A8 product with fp32 out: its gemm_kernel<0, float> launches
    profiles = time_wrappers("SpatialVLA", runs, {1: req1, 64: req64}, 1, {1: SVLA_TIMING_REPS, 64: SVLA_TIMING_REPS},
                             in_order="gemm_kernel<0, float>")
    log(f"# SpatialVLA peak device memory: int8 wrapper alone {int8_peak / 2**30:.2f} GiB (batch 1 and 64); both "
        f"wrappers during the timing {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for b in (1, 64):
        totals, unembed, busy = profiles["int8", b]
        w8 = totals.get("gemm_kernel", (0.0, 0))[0]
        log(f"# SpatialVLA int8 batch {b}: the unembedding products (the profiler recorded {len(unembed)} of "
            f"{n_tok}) take {sum(unembed):.3f} ms of device time (each {[round(u, 4) for u in unembed[:3]]}... ms), "
            f"{100 * sum(unembed) / busy:.1f}% of the device busy time {busy:.3f} ms and "
            f"{100 * sum(unembed) / w8:.1f}% of the W8A8 products' gemm_kernel time {w8:.3f} ms")
    del wrapper, bf16_wrapper, runs, bp, sessions, bf16_sessions
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 11. Magma serving: the native wrapper in int8 and bf16
# ---------------------------------------------------------------------------

MAGMA_EV_CONFIG = "config/experiment/simpler/magma_bridge_ev.yaml"
# the yaml's adapter, BridgeSimplerMagmaAdapter, is defined in neither package
# (scripts/gen_experiment_configs.py makes up the name): the Bridge adapter
# serves in its place; its checkpoint, microsoft/Magma-8B, is a hub id
MAGMA_OVERRIDES = {"eval_cfg.env_adapter": "BridgeSimplerAdapter"}
MAGMA_FP32_DEPTH = 4  # LLaMA layers of the bf16-against-fp32 comparison (all 32 in fp32 next to both wrappers is 36 GB)
# LLaMA layers served of Magma-8B's 32 (full width), the script's time limit's cut since phase 3c's gathered step
# (16 until phase 3d joined the budget, 8 until phase 3e did)
MAGMA_SERVING_DEPTH = 4


def magma_config(quantize: bool):
    """The server role's config from the Magma yaml: model_cfg {"type":
    "magma_native"}, no checkpoint (random weights from the seed), the hash
    tokenizer."""
    return ev_config(quantize, path=MAGMA_EV_CONFIG, model_cfg={"type": "magma_native"}, overrides=MAGMA_OVERRIDES)


def magma_per_inference(cfg) -> int:
    """W8A8 launches of one int8 Magma inference, from the configuration: the
    LLaMA prefill's 7 per layer and the first token's lm_head, then for each
    token fed back (all but the last of n_action_tokens + 1) 7 per layer and
    the lm_head. ConvNeXt and the projector stay fp."""
    return (cfg.lm.depth * 7 + 1) * (cfg.n_action_tokens + 1)


def magma_requests(rng: np.random.Generator, cfg, b: int) -> list[dict]:
    """b single-row requests as MagmaSession.preprocess emits them: a uint8
    frame at the ConvNeXt resolution, one task string."""
    obs = make_obs(rng, b, cfg.image_size)
    return [{"image": obs["image"][i:i + 1], "task": [obs["task"][i]]} for i in range(b)]


def magma_inputs(wrapper, reqs: list[dict]) -> tuple:
    """The wrapper's device inputs for the fused requests: normalized images,
    the prompt's ids and mask."""
    tokens, masks = wrapper.model.build_prompt(wrapper.tokenizer, [r["task"][0] for r in reqs], wrapper.model_cfg)
    images = np.concatenate([r["image"] for r in reqs])
    return wrapper.model.normalize_images(wrapper._put(images)), wrapper._put(tokens), wrapper._put(masks)


def magma_greedy_logits(params, inputs, cfg, policy, forced=None):
    """`generate` step by step from its own pieces -> (tokens [B, T], logits
    [T, B, V] fp32); with `forced` [B, T] the given tokens are fed back in
    place of the argmax (teacher forcing)."""
    from intact_tpu_torch.models import llama
    from intact_tpu_torch.models.magma import model as magma

    n = cfg.n_action_tokens + 1
    with torch.inference_mode():
        embeds, mask = magma.embed_prompt(params, *inputs, cfg, policy)
        last, cache, key_valid, pos = llama.prefill(params["lm"], embeds, mask, n, cfg.lm, policy)
        p_len = embeds.shape[1]
        logits = [llama.logits(params["lm"], last, cfg.lm, policy)]
        tokens = [logits[-1].argmax(dim=-1)]
        for s in range(n - 1):
            feed = tokens[-1] if forced is None else forced[:, s]
            h = llama.decode_step(params["lm"], feed, cache, p_len + s, key_valid, pos + s, cfg.lm, policy)
            logits.append(llama.logits(params["lm"], h, cfg.lm, policy))
            tokens.append(logits[-1].argmax(dim=-1))
        return torch.stack(tokens, dim=1), torch.stack(logits)


def magma_env_actions(wrapper, ids: np.ndarray, sessions) -> list:
    """The env actions of `ids` [B, T] as `_infer_fused` makes them: the
    first n_action_tokens through the bins, the quantile denormalization,
    each session's postprocess."""
    from intact_tpu_torch.serve.decoding import denormalize_with_quantiles, tokens_to_actions

    cfg = wrapper.model_cfg
    out = []
    for i, session in enumerate(sessions):
        norm = tokens_to_actions(ids[i, :cfg.n_action_tokens], vocab_size=cfg.lm.vocab_size, n_bins=cfg.n_action_bins)
        stats = session.adapter.dataset_statistics["action"]
        raw = denormalize_with_quantiles(norm, stats["p01"], stats["p99"], np.array([True] * 6 + [False]))
        out.append(session.adapter.postprocess(raw[None]))
    return out


def phase_magma_serving() -> dict:
    """-> {kernel: launches} on Magma's int8 serving path (the bf16 path
    launches none of the three kernels: ConvNeXt, the projector and LLaMA's
    attention are plain, as in the reference), at full width and
    MAGMA_SERVING_DEPTH LLaMA layers."""
    with cut_depths(("magma_native", "lm", MAGMA_SERVING_DEPTH)):
        return magma_serving()


def magma_serving() -> dict:
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models import llama
    from intact_tpu_torch.ops import w8a8
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper

    cfg = magma_config(quantize=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wrapper = make_policy_wrapper(cfg, device=DEVICE)
    torch.cuda.synchronize()
    mc = wrapper.model_cfg
    leaves = cm.tree_leaves(wrapper.params)
    want = {"flash_attention": 0, "w8a8_matmul": magma_per_inference(mc)}
    n_tok, vocab = mc.n_action_tokens + 1, mc.lm.vocab_size
    rng = np.random.default_rng(7)
    req1, req64 = magma_requests(rng, mc, 1), magma_requests(rng, mc, 64)
    inputs = magma_inputs(wrapper, req64)
    p_len, n_valid = inputs[1].shape[1], inputs[2].sum(dim=1)
    log(f"# Magma serving: {type(wrapper).__name__} from {MAGMA_EV_CONFIG} ({cfg.model_type}, adapter "
        f"{cfg.eval_cfg.env_adapter}, quantize_int8 {cfg.eval_cfg.quantize_int8}, seed {cfg.seed}): "
        f"{sum(x.numel() for x in leaves if x.dtype == torch.int8) / 1e9:.3f} B int8 weights + "
        f"{sum(x.numel() for x in leaves if x.dtype != torch.int8) / 1e9:.3f} B bf16/fp32 values, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, init {time.perf_counter() - t0:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; prompt {p_len} tokens ({mc.n_image_tokens} image; "
        f"{int(n_valid.min())}-{int(n_valid.max())} valid over the 64 rows), {n_tok} greedy tokens over a vocabulary "
        f"of {vocab}; expect {want} launches per inference")

    s1, sessions = wrapper.new_session(), [wrapper.new_session() for _ in range(64)]
    counters = {"flash_attention": flash_attention, "w8a8_matmul": w8a8.w8a8_matmul}

    def fused(w, items, expect, label):
        before = {k: c.launches for k, c in counters.items()}
        out = w.infer_batch(items)
        grew = {k: c.launches - before[k] for k, c in counters.items()}
        if grew != expect:
            raise SystemExit(f"one fused {label} inference launched {grew}; expected {expect}")
        for a in out:
            if isinstance(a, Exception) or a.shape != (1, 7) or not np.isfinite(a).all():
                raise SystemExit(f"bad {label} serving result {a!r:.200}")
        return out

    # --- the main path: fused requests through the wrapper, as the batching server calls it ---
    flash_attention.launches = w8a8.w8a8_matmul.launches = 0
    for _ in range(2):
        fused(wrapper, [(req1[0], s1)], want, "int8 Magma")
    out64 = fused(wrapper, list(zip(req64, sessions)), want, "int8 Magma")
    launches = {k: c.launches for k, c in counters.items()}
    # -------------------------------------------------------------------------------------------
    log(f"# Magma int8 serving: 3 fused inferences (batch 1, 1, 64), launches {launches}, env actions of shape "
        f"(1, 7), finite")

    # int8: the tokens and every step's logits with the W8A8 kernel against with only its product plain
    images, tasks = np.concatenate([r["image"] for r in req64]), [r["task"][0] for r in req64]
    ids = wrapper.generate_tokens(images, tasks)  # the wrapper's device call
    tokens, log_k = magma_greedy_logits(wrapper.params, inputs, mc, wrapper.policy)
    stepwise = np.array_equal(tokens.cpu().numpy(), ids)
    in_vocab = bool(((tokens >= 0) & (tokens < vocab)).all())
    same_as_served = all(np.array_equal(e, o) for e, o in zip(magma_env_actions(wrapper, ids, sessions), out64))
    real = w8a8.w8a8_matmul
    n0 = w8a8.w8a8_matmul.launches
    w8a8.w8a8_matmul = plain_w8a8  # the plain W8A8 product, for this comparison only
    try:
        ids_plain = wrapper.generate_tokens(images, tasks)
        tok_p, log_p = magma_greedy_logits(wrapper.params, inputs, mc, wrapper.policy, forced=tokens)
    finally:
        w8a8.w8a8_matmul = real
    same = np.array_equal(ids_plain, ids) and torch.equal(tok_p, tokens) and torch.equal(log_p, log_k)
    top2 = log_k.topk(2, dim=-1).values
    ties = int((top2[..., 0] == top2[..., 1]).sum())
    log(f"# Magma int8, batch 64: {tokens.numel()} tokens in [0, {vocab}) {in_vocab}, {tokens.unique().numel()} "
        f"distinct, {ties} steps and rows with a tie at the bf16 maximum (argmax takes the first, as jnp.argmax); "
        f"the stepwise decode equals the wrapper's {stepwise}; the served env actions equal the decoded tokens' "
        f"{same_as_served}; with only the W8A8 product plain (the lm_head included): tokens and every step's "
        f"teacher-forced logits bit-equal {same} (gates: all; plain runs launched w8a8_matmul "
        f"{w8a8.w8a8_matmul.launches - n0} times)")
    if not (in_vocab and stepwise and same_as_served and same and w8a8.w8a8_matmul.launches == n0):
        raise SystemExit("Magma int8: tokens outside the vocabulary, the W8A8 kernel's tokens or logits differ from "
                         "its plain version's, or the served actions differ from the checked tokens'")
    del log_p, tok_p
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for items in ([(req1[0], s1)], list(zip(req64, sessions))):
        wrapper.infer_batch(items)
    int8_peak = torch.cuda.max_memory_allocated()

    # bf16: the same random weights behind the same wrapper, quantize_int8 off
    bf16_wrapper = make_policy_wrapper(magma_config(quantize=False), device=DEVICE)
    bf16_sessions = [bf16_wrapper.new_session() for _ in range(64)]
    bp, bpol = bf16_wrapper.params, bf16_wrapper.policy
    tok_b, _ = magma_greedy_logits(bp, inputs, mc, bpol)
    ids_b = bf16_wrapper.generate_tokens(images, tasks)
    log(f"# Magma bf16, batch 64: the stepwise decode equals the wrapper's {np.array_equal(tok_b.cpu().numpy(), ids_b)}"
        f"; int8 tokens equal to bf16's {(tokens == tok_b).float().mean().item():.4f} (reported, no gate)")
    if not bool(((tok_b >= 0) & (tok_b < vocab)).all()) or not np.array_equal(tok_b.cpu().numpy(), ids_b):
        raise SystemExit("Magma bf16: the wrapper's tokens differ from the stepwise decode's")
    del log_k
    # bf16 against fp32 at full width and MAGMA_FP32_DEPTH LLaMA layers (views of the bf16 tree)
    mc4 = dataclasses.replace(mc, lm=dataclasses.replace(mc.lm, depth=MAGMA_FP32_DEPTH))
    bp4 = {**bp, "lm": {**bp["lm"], "blocks": cm.tree_map(lambda a: a[:MAGMA_FP32_DEPTH], bp["lm"]["blocks"])}}
    tok_b4, log_b4 = magma_greedy_logits(bp4, inputs, mc4, bpol)
    fp32 = cm.tree_map(lambda x: x.float(), bp4)
    tok_f4, _ = magma_greedy_logits(fp32, inputs, mc4, cm.FP32_POLICY)
    _, log_ff4 = magma_greedy_logits(fp32, inputs, mc4, cm.FP32_POLICY, forced=tok_b4)  # teacher-forced fp32
    del fp32
    log(f"# Magma bf16 against fp32 at {MAGMA_FP32_DEPTH} of {mc.lm.depth} LLaMA layers, batch 64: tokens equal "
        f"{(tok_b4 == tok_f4).float().mean().item():.4f}, teacher-forced logits rel L2 {rel_l2(log_b4, log_ff4):.3e} "
        f"(logits std {log_b4.std().item():.3e}; reported, no gate)")
    del log_b4, log_ff4, inputs, bp4
    gc.collect()
    torch.cuda.empty_cache()

    runs = {"int8": (wrapper, sessions), "bf16": (bf16_wrapper, bf16_sessions)}
    torch.cuda.reset_peak_memory_stats()
    real_logits = llama.logits

    def annotated_logits(*args, **kwargs):  # the lm_head's kernels, read by name in the profiles
        with torch.profiler.record_function("magma_lm_head"):
            return real_logits(*args, **kwargs)

    llama.logits = annotated_logits
    try:
        # one env action per inference: 1 policy step per row
        profiles = time_wrappers("Magma", runs, {1: req1, 64: req64}, 1, {1: 3, 64: 3}, annotation="magma_lm_head")
    finally:
        llama.logits = real_logits
    log(f"# Magma peak device memory: int8 wrapper alone {int8_peak / 2**30:.2f} GiB (batch 1 and 64); both wrappers "
        f"during the timing {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for (k, b), (totals, head_ms, n_head, busy) in profiles.items():
        w8 = totals.get("gemm_kernel", (0.0, 0))[0]
        log(f"# Magma {k} batch {b}: the lm_head's kernels (in the device spans of {n_head} of its {n_tok} calls) take "
            f"{head_ms:.3f} ms of device time, {100 * head_ms / busy:.1f}% of the device busy time {busy:.3f} ms"
            + (f" and {100 * head_ms / w8:.1f}% of the W8A8 products' gemm_kernel time {w8:.3f} ms" if w8 else ""))
    del wrapper, bf16_wrapper, runs, bp, sessions, bf16_sessions
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 12. Octo serving: the released architecture (T5-base) and the native model
# ---------------------------------------------------------------------------

OCTO_EV_CONFIG = "config/experiment/simpler/octo_base_bridge_ev.yaml"
# the yaml includes config/models/octo.json (type "octo", the from-scratch
# model) but names a released snapshot as its checkpoint, and its adapter,
# BridgeSimplerOctoAdapter, is defined in neither package: the phase serves
# octo_base_upstream (the released architecture) behind
# OctoBridgeSimplerAdapter at Octo's 256 px
OCTO_OVERRIDES = {"eval_cfg.env_adapter": "OctoBridgeSimplerAdapter", "env.image_size": "[256, 256]"}
OCTO_TRAIN_BATCH = 16


def octo_config(model_cfg: dict | None):
    """The server role's config from the octo-base yaml (bf16 compute over fp32
    params, as the reference's Octo wrapper), random weights from the seed,
    the hash tokenizer; `model_cfg` None keeps the yaml's own model JSON."""
    return ev_config(False, path=OCTO_EV_CONFIG, model_cfg=model_cfg, overrides=OCTO_OVERRIDES)


def octo_sessions(wrapper, n: int) -> list:
    """n sessions as served: the adapter's antialiased lanczos3 (the port's
    codec; no TF or cv2 on the card), its uint8 frame, zero state and task,
    then the session's history deque."""
    return [wrapper.new_session() for _ in range(n)]


def octo_round(rng: np.random.Generator, sessions, size: int) -> list[dict]:
    """One request per session, through its preprocess (the deque appends)."""
    obs = make_obs(rng, len(sessions), size)
    return [s.preprocess({"observation.images.top": obs["image"][i], "task": obs["task"][i]})
            for i, s in enumerate(sessions)]


def octo_fused(reqs: list[dict]) -> tuple:
    """The fused arrays of single-row requests (images, img_masks, tasks, state)."""
    return (np.concatenate([r["images"] for r in reqs]), np.concatenate([r["img_masks"] for r in reqs]),
            [r["task"][0] for r in reqs], np.concatenate([r["state"] for r in reqs]))


def octo_chunk_at(wrapper, state: torch.Tensor, *inputs) -> np.ndarray:
    """The wrapper's raw chunk for `inputs` with its generator at `state`."""
    wrapper.generator.set_state(state)
    return wrapper.sample_chunk(*inputs)


def phase_octo_serving() -> dict:
    """-> {kernel: launches} on Octo's serving paths: none by design (plain
    attention in both packages, no int8 Octo in the reference)."""
    import shutil

    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.octo import upstream as tup
    from intact_tpu_torch.ops import fused_adam, w8a8
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper
    from intact_tpu_torch.utils import flax_msgpack

    counters = {"flash_attention": flash_attention, "w8a8_matmul": w8a8.w8a8_matmul,
                "fused_adam_rows": fused_adam.fused_adam_rows}
    cfg = octo_config({"type": "octo_base_upstream"})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wrapper = make_policy_wrapper(cfg, device=DEVICE)
    torch.cuda.synchronize()
    mc = wrapper.model_cfg
    size, steps = mc.image_size, min(cfg.eval_cfg.action_step, mc.horizon)
    n_params = sum(x.numel() for x in cm.tree_leaves(wrapper.params))
    log(f"# Octo serving: {type(wrapper).__name__} from {OCTO_EV_CONFIG} ({cfg.model_type}, adapter "
        f"{cfg.eval_cfg.env_adapter}, seed {cfg.seed}): {n_params / 1e6:.1f} M fp32 parameters (T5 "
        f"{sum(x.numel() for x in cm.tree_leaves(wrapper.params['t5'])) / 1e6:.1f} M), compute "
        f"{wrapper.policy.compute_dtype}, init {time.perf_counter() - t0:.2f} s; {mc.max_lang_tokens} language + "
        f"{mc.history} x ({mc.n_patches} + 1) frame tokens, ViT {mc.depth} x {mc.width} ({mc.num_heads} heads), "
        f"{mc.diffusion_steps} DDPM steps clipped to +-{mc.max_action}; {steps} actions per row")

    rng = np.random.default_rng(12)
    s1, sessions = octo_sessions(wrapper, 1), octo_sessions(wrapper, 64)

    def serve(items, label):
        out = wrapper.infer_batch(items)
        for a in out:
            if isinstance(a, Exception) or a.shape != (steps, 7) or not np.isfinite(a).all():
                raise SystemExit(f"bad {label} serving result {a!r:.200}")
        return out

    # --- the main path: each session's two requests (padded, then full history) fused, at batch 1 and 64 ---
    for c in counters.values():
        c.launches = 0
    rounds = {1: [], 64: []}
    for _ in range(2):
        for b, ss in ((1, s1), (64, sessions)):
            rounds[b].append(octo_round(rng, ss, size))
            serve(list(zip(rounds[b][-1], ss)), f"Octo batch {b}")
    launches = {k: c.launches for k, c in counters.items()}
    # -------------------------------------------------------------------------------------------
    first, second = rounds[64]
    pad_ok = (all(r["img_masks"].tolist() == [[False, True]] for r in first)
              and all(r["img_masks"].tolist() == [[True, True]] for r in second)
              and all(np.array_equal(r["images"][0, 0], r["images"][0, 1]) for r in first))
    log(f"# Octo served 2 x 2 fused inferences (batch 1, 64; the first with the padded history), launches {launches} "
        f"(none by design), env actions of shape ({steps}, 7) finite; first requests front-padded with their frame "
        f"and masked, second ones full: {pad_ok}")
    if any(launches.values()) or not pad_ok:
        raise SystemExit("Octo: a hand kernel launched on the Octo path, or the history was not padded as served")

    # the raw chunk within +-max_action; the padded frame's pixels do not reach the actions (same draws)
    state = wrapper.generator.get_state()
    inputs = octo_fused(first)
    chunk = octo_chunk_at(wrapper, state, *inputs)
    changed_pad = (255 - inputs[0][:, 0:1], inputs[0][:, 1:])
    chunk_pad = octo_chunk_at(wrapper, state, np.concatenate(changed_pad, axis=1), *inputs[1:])
    changed_real = np.concatenate([inputs[0][:, :1], 255 - inputs[0][:, 1:]], axis=1)
    chunk_real = octo_chunk_at(wrapper, state, changed_real, *inputs[1:])
    bound = float(np.abs(chunk).max())
    unfilled_ok = np.array_equal(chunk, chunk_pad) and not np.array_equal(chunk, chunk_real)
    log(f"# Octo batch 64, padded history: raw chunk {chunk.shape}, max |a| {bound:.4f} (bound {mc.max_action}, "
        f"{int((np.abs(chunk) == np.float32(mc.max_action)).sum())} values clipped); with the padded frame's pixels "
        f"inverted the actions are bit-equal {np.array_equal(chunk, chunk_pad)}, with the real frame's inverted they "
        f"differ {not np.array_equal(chunk, chunk_real)} (same generator state)")
    if not (np.isfinite(chunk).all() and bound <= mc.max_action and unfilled_ok):
        raise SystemExit("Octo: the raw chunk leaves +-max_action, or the padded frame reaches the actions")

    # bf16 compute against fp32 readouts, same params and inputs (reported)
    dev = [wrapper._put(x) for x in (inputs[0], inputs[1], *wrapper.tokenizer(inputs[2], mc.max_lang_tokens))]
    images = dev[0].float() * (2.0 / 255.0) - 1.0
    with torch.inference_mode():
        r16 = tup.encode(wrapper.params, images, dev[1], dev[2], dev[3], mc, wrapper.policy)
        r32 = tup.encode(wrapper.params, images, dev[1], dev[2], dev[3], mc, cm.FP32_POLICY)
    log(f"# Octo batch 64: bf16-compute readouts against fp32 rel L2 {rel_l2(r16.float(), r32):.3e} (reported, no gate)")
    del r16, r32, images, dev

    # latency, launches and busy share (the second round's full-history requests)
    torch.cuda.reset_peak_memory_stats()
    time_wrappers("Octo", {"bf16": (wrapper, sessions)}, {1: rounds[1][1], 64: second}, steps, {1: 5, 64: 5})
    log(f"# Octo peak device memory during the timing: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # a released-layout flax-msgpack snapshot of these weights through switch_model: the same actions
    snapshot = RUN_DIR / "octo_snapshot"
    snapshot.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    (snapshot / "octo_base.msgpack").write_bytes(flax_msgpack.packb({"params": tup.to_released_tree(wrapper.params,
                                                                                                     mc)}))
    written = time.perf_counter() - t0
    t0 = time.perf_counter()
    wrapper.switch_model(str(snapshot))
    torch.cuda.synchronize()
    loaded = time.perf_counter() - t0
    chunk_back = octo_chunk_at(wrapper, state, *inputs)
    mb = (snapshot / "octo_base.msgpack").stat().st_size / 1e6
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    log(f"# Octo msgpack round trip: {mb:.1f} MB written in {written:.2f} s, switch_model {loaded:.2f} s; actions "
        f"bit-equal to before the switch {np.array_equal(chunk_back, chunk)}")
    if not np.array_equal(chunk_back, chunk):
        raise SystemExit("Octo: the actions changed through the msgpack snapshot")

    # one compute_loss and backward at the training batch (fp32 params, bf16 compute)
    b = OCTO_TRAIN_BATCH
    leaves = {k: v.detach().requires_grad_() for k, v in cm.flatten_paths(wrapper.params).items()}
    lang, lmask = wrapper.tokenizer(inputs[2][:b], mc.max_lang_tokens)
    batch = {"images": wrapper._put(inputs[0][:b]).float() * (2.0 / 255.0) - 1.0, "img_masks": wrapper._put(inputs[1][:b]),
             "lang_tokens": wrapper._put(lang), "lang_masks": wrapper._put(lmask),
             "actions": torch.rand((b, mc.horizon, mc.action_dim), device=DEVICE) * 2 - 1}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, _ = tup.compute_loss(cm.unflatten_paths(leaves), np.random.default_rng(0), batch, mc, wrapper.policy)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True, materialize_grads=True)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    log(f"# Octo compute_loss + backward at batch {b}: loss {loss.item():.4f}, {len(grads)} gradients finite {finite}, "
        f"norm {torch.sqrt(sum(g.float().square().sum() for g in grads)).item():.4e}, "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (first call), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (np.isfinite(loss.item()) and finite):
        raise SystemExit("Octo: the loss or a gradient is not finite")
    del leaves, grads, loss, batch, wrapper, s1, sessions
    gc.collect()
    torch.cuda.empty_cache()

    # the yaml's own type: the native octo (octo.json), once at batch 64
    native = make_policy_wrapper(octo_config(None), device=DEVICE)
    nc = native.model_cfg
    ns = octo_sessions(native, 64)
    out = native.infer_batch(list(zip(octo_round(rng, ns, nc.image_size), ns)))
    ok = all(not isinstance(a, Exception) and a.shape == (steps, 7) and np.isfinite(a).all() for a in out)
    log(f"# Octo native ({native.config.model_type} from the yaml's model JSON: ViT {nc.depth} x {nc.width}, "
        f"{nc.image_size} px, {nc.diffusion_steps} DDPM steps): batch 64 env actions finite {ok}; launches "
        f"{ {k: c.launches for k, c in counters.items()} }")
    if not ok or any(c.launches for c in counters.values()):
        raise SystemExit("Octo native: bad serving result, or a hand kernel launched")
    del native, ns, out
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 13. the client role: the three simulator evaluators against the served int8 Pi0
# ---------------------------------------------------------------------------

MS3_EV_CONFIG = "config/experiment/simplerMS3/pi0_finetune_bridge_ev.yaml"
EPISODE_STEPS = 24  # the fakes' episodes (FakeSimplerEnv.max_episode_steps); LIBERO's after its settle steps


class LoopbackClient:
    """The policy client's surface served in this process, through the calls
    the batching server's per-connection handler makes
    (intact_tpu_torch/serve/batching.py::_handler): one PolicySession, `infer`
    its preprocess and then the wrapper's infer_batch of that one request,
    `reset` the session's, `switch_model` the wrapper's. No msgpack round trip
    (the card machine has neither msgpack nor websockets). It keeps every
    request, every returned chunk, and the host seconds spent inside infer."""

    def __init__(self, wrapper, session):
        self.wrapper, self.session = wrapper, session
        self.obs, self.chunks = [], []
        self.infer_s = 0.0

    def get_server_metadata(self) -> dict:
        return {"model": self.wrapper.config.model_type, "action_step": self.wrapper.action_step}

    def infer(self, obs):
        t = time.perf_counter()
        out = self.wrapper.infer_batch([(self.session.preprocess(obs), self.session)])[0]
        self.infer_s += time.perf_counter() - t
        if isinstance(out, Exception):
            raise out
        self.obs.append(obs)
        self.chunks.append(np.array(out))
        return out

    def reset(self) -> dict:
        self.session.reset()
        return {"status": "reset"}

    def switch_model(self, new_model_path: str) -> dict:
        self.wrapper.switch_model(new_model_path)
        return {"status": "model switched"}


class SteppedEnv:
    """An env that keeps every action it is stepped with."""

    def __init__(self, env):
        self.env, self.stepped = env, []

    def step(self, action):
        self.stepped.append(np.array(action))
        return self.env.step(action)

    def __getattr__(self, name):
        return getattr(self.env, name)


class FakeMS3Env:
    """The vectorized ManiSkill3 env as its GPU simulation answers: n envs whose
    observations, truncation, episode stats and success are torch tensors on the
    card; the end effectors move with the actions; all truncate after
    EPISODE_STEPS. Frames: `size` px, one value per (step, env), so the videos
    compress."""

    def __init__(self, n: int, size: int):
        self.n, self.size, self.stepped = n, size, []

    @property
    def unwrapped(self):
        return self

    def get_language_instruction(self) -> str:
        return "put carrot on plate"

    def reset(self, seed=None, options=None):
        self.t = 0
        self.pos = torch.zeros(self.n, 3, device=DEVICE, dtype=torch.float64)
        return self.obs(), {}

    def step(self, action):
        self.stepped.append(np.array(action))
        self.pos += torch.as_tensor(action[:, :3], device=DEVICE)
        self.t += 1
        truncated = torch.full((self.n,), self.t >= EPISODE_STEPS, device=DEVICE)
        info = {}
        if self.t >= EPISODE_STEPS:
            near = self.pos.norm(dim=1) < 0.1
            info = {"episode_stats": {"moved_correct_obj": near.int(), "moved_wrong_obj": torch.zeros_like(near).int(),
                                      "is_src_obj_grasped": near.int(), "source_intention": (self.pos[:, 0] > 0).int()},
                    "success": near}
        return self.obs(), torch.zeros(self.n, device=DEVICE), torch.zeros_like(truncated), truncated, info

    def obs(self) -> dict:
        quat = torch.tensor([1.0, 0, 0, 0], device=DEVICE, dtype=torch.float64).expand(self.n, 4)
        grip = torch.full((self.n, 1), 0.5, device=DEVICE, dtype=torch.float64)
        return {"agent": {"eef_pos": torch.cat([self.pos, quat, grip], dim=1)}}

    def image(self) -> torch.Tensor:
        value = (self.t * 7 + torch.arange(self.n, device=DEVICE)) % 256
        return value.to(torch.uint8)[:, None, None, None].expand(self.n, self.size, self.size, 3).contiguous()


class FakeLiberoEnv:
    """A LIBERO env: `size` px agentview frames that a 180-degree flip changes
    (a ramp across the rows and columns, shifted every step), an end effector
    moved by the actions, done after the settle steps and EPISODE_STEPS more.
    It keeps every frame it rendered and every action it was stepped with."""

    def __init__(self, size: int, settle: int):
        self.size, self.done_at = size, settle + EPISODE_STEPS
        self.frames, self.stepped = [], []

    def reset(self):
        self.t, self.pos = 0, np.zeros(3)

    def set_init_state(self, state):
        return self.obs()

    def step(self, action):
        self.stepped.append(np.array(action))
        self.pos = self.pos + np.asarray(action[:3])
        self.t += 1
        return self.obs(), 0.0, self.t >= self.done_at, {}

    def close(self):
        pass

    def obs(self) -> dict:
        ramp, shape = np.arange(self.size), (self.size, self.size)
        frame = np.stack([np.broadcast_to((ramp[:, None] + 3 * self.t) % 256, shape),
                          np.broadcast_to(ramp[None, :], shape), np.full(shape, self.t)], axis=-1).astype(np.uint8)
        self.frames.append(frame)
        return {"agentview_image": frame, "robot0_eef_pos": self.pos.copy(),
                "robot0_eef_quat": np.array([0.0, 0.0, 0.0, 1.0]), "robot0_gripper_qpos": np.array([0.03, -0.03])}


class FakeLiberoSuite:
    n_tasks = 1

    def get_task(self, task_id):
        return types.SimpleNamespace(bddl_file="fake.bddl", language="pick up the black bowl and place it on the plate")

    def get_task_init_states(self, task_id):
        return [np.zeros(4)]


def client_config(path: str, **eval_overrides):
    """The yaml at `path` as the client role reads it (the server's seed and
    hash tokenizer, no checkpoint sweep), with `eval_overrides` on eval_cfg."""
    overrides = {"eval_cfg.role": "client", "eval_cfg.pretrained_model_gradient_step_cnt": "null",
                 **{f"eval_cfg.{k}": v if isinstance(v, str) else json.dumps(v) for k, v in eval_overrides.items()}}
    return ev_config(path=path, overrides=overrides)


def check_actions(label: str, stepped: list, chunks: list, action_step: int, shape: tuple,
                  binary_gripper: bool = True) -> None:
    """Every stepped action finite and of `shape`, its gripper -1 or +1 where the
    adapter binarizes it, and the stepped sequence the chunks' first
    action_step rows in order."""
    stepped = np.stack(stepped)
    rows = [np.moveaxis(c[..., :action_step, :], -2, 0) for c in chunks]  # [action_step, (N,) 7] per chunk
    planned = np.concatenate(rows)
    grippers = np.unique(stepped[..., 6])
    ok = (stepped.shape[1:] == shape and np.isfinite(stepped).all()
          and (not binary_gripper or np.isin(grippers, (-1.0, 1.0)).all())
          and planned.shape == stepped.shape and np.array_equal(planned, stepped))
    log(f"#   {label}: {len(stepped)} actions of shape {stepped.shape[1:]} stepped, finite, "
        f"{len(grippers)} gripper values in [{grippers.min():.4f}, {grippers.max():.4f}], equal to the chunks' first "
        f"{action_step} rows in order: {ok}")
    if not ok:
        raise SystemExit(f"{label}: the stepped actions are not the served chunks' first {action_step} rows, or not "
                         f"finite {shape} actions{' with a +-1 gripper' if binary_gripper else ''}")


def check_log(label: str, root: Path, cfg, episodes: int) -> None:
    """eval.log under the reference's layout eval_online/<sim>/<name>/step_0/ta_K/<seed>/<timestamp>,
    with the _log_summary block."""
    ec = cfg.eval_cfg
    layout = f"eval_online/{ec.simulator_name}/{cfg.name}/step_0/ta_{ec.action_step}/{cfg.seed}/*/eval.log"
    logs = list(root.glob(layout))
    text = logs[0].read_text() if len(logs) == 1 else ""
    block = ["============ Evaluation Summary ============", f"Number of episodes: {episodes}",
             "Total Task Eval Time: ", "============================================"]
    if not all(line in text for line in block):
        raise SystemExit(f"{label}: no eval.log with the summary block under the reference's layout ({logs})")


def check_results(label: str, results: dict, task: str, keys: set) -> None:
    got = results.get(task, {})
    if set(got) != keys or not all(0.0 <= v <= 1.0 for v in got.values()):
        raise SystemExit(f"{label}: results {results} do not have exactly the metric keys {sorted(keys)} in [0, 1]")


def phase_client() -> dict:
    """-> {kernel: launches} of the three evaluators' episodes against the int8 wrapper."""
    import os
    import shutil

    from intact_tpu_torch.config import load_yaml
    from intact_tpu_torch.envs.evaluators import libero, simpler, simplerMS3
    from intact_tpu_torch.envs.evaluators.fake import FakeSimplerEnv
    from intact_tpu_torch.ops import w8a8
    from intact_tpu_torch.ops.flash_attention import flash_attention
    from intact_tpu_torch.serve.policy_wrapper import make_policy_wrapper
    from intact_tpu_torch.utils.pipeline import get_class_from_path

    t0 = time.perf_counter()
    wrapper = make_policy_wrapper(ev_config(), device=DEVICE)
    mc = wrapper.model_cfg
    size = mc.vision.image_size
    w8a8_per, flash_per = w8a8_per_inference(mc), mc.vlm.depth - 1
    log(f"# client: one int8 Pi0PolicyWrapper from {EV_CONFIG} (seed {SERVING_SEED}, {size} px) in "
        f"{time.perf_counter() - t0:.2f} s; {w8a8_per} w8a8_matmul and {flash_per} flash_attention launches per "
        f"inference; {gpu_name_and_power()}")
    first_task = load_yaml(EV_CONFIG)["eval_cfg"]["task_list"][0]
    npe = load_yaml(MS3_EV_CONFIG)["eval_cfg"]["n_parallel_eval"]
    log_root = RUN_DIR  # the evaluators' logs and videos, removed after the phase
    shutil.rmtree(log_root, ignore_errors=True)
    saved_log_dir = os.environ.get("VLA_LOG_DIR")
    os.environ["VLA_LOG_DIR"] = str(log_root)
    # the videos take the evaluators' .npz path, which the card machine (no imageio) takes anyway
    saved_imageio = sys.modules.get("imageio")
    sys.modules["imageio"] = None
    totals = {"flash_attention": 0, "w8a8_matmul": 0}

    def drive(label: str, cfg, evaluator_cls, want_inferences: int, env_steps: int, **kw) -> tuple:
        """Run one evaluator against the wrapper through a LoopbackClient whose
        session holds the adapter cfg names -> (results, client)."""
        adapter = get_class_from_path(cfg.eval_cfg.env_adapter_path)(cfg)
        client = LoopbackClient(wrapper, wrapper.session_cls(wrapper, adapter))
        evaluator = evaluator_cls(cfg, client=client, **kw)
        w8a8.w8a8_matmul.launches = flash_attention.launches = 0
        t = time.perf_counter()
        results = evaluator.evaluate()
        wall = time.perf_counter() - t
        launches = {"flash_attention": flash_attention.launches, "w8a8_matmul": w8a8.w8a8_matmul.launches}
        n = len(client.chunks)
        log(f"# client {label} ({evaluator_cls.__name__}, {type(adapter).__name__}): {n} inferences in {wall:.2f} s, "
            f"{env_steps} env steps ({env_steps / wall:.1f} env steps/s), {client.infer_s / wall:.1%} of the loop's "
            f"wall inside client.infer ({client.infer_s / max(n, 1) * 1e3:.1f} ms per inference); launches {launches}; "
            f"results {results}")
        if n != want_inferences or launches != {"flash_attention": flash_per * n, "w8a8_matmul": w8a8_per * n}:
            raise SystemExit(f"client {label}: {n} inferences (expected {want_inferences}) and launches {launches} "
                             f"(expected {flash_per} flash_attention and {w8a8_per} w8a8_matmul per inference)")
        for k in totals:
            totals[k] += launches[k]
        return results, client

    try:
        # Simpler: the yaml's first task, 2 episodes, the first one recorded (.npz where imageio is absent)
        cfg = client_config(EV_CONFIG, task_list=[first_task], n_eval_episode=2, n_video=1, recording=True)
        envs = []

        def simpler_env(task):
            envs.append(SteppedEnv(FakeSimplerEnv(task, image_size=size)))
            return envs[-1]

        steps = cfg.eval_cfg.action_step
        results, client = drive("Simpler", cfg, simpler.SimplerEvaluator, 2 * EPISODE_STEPS // steps,
                                2 * EPISODE_STEPS, env_factory=simpler_env, image_getter=lambda env, obs: obs["image"])
        check_actions("Simpler", envs[0].stepped, client.chunks, steps, (7,))
        check_results("Simpler", results, first_task, set(simpler.METRIC_KEYS))
        check_log("Simpler", log_root, cfg, 2)
        videos = sorted(p.name for p in log_root.rglob(f"{first_task}/videos/*"))
        log(f"#   Simpler videos: {videos}")
        if len(videos) != 1:
            raise SystemExit(f"Simpler: expected one video of the first episode, found {videos}")

        # ManiSkill3: one batch episode of the sweep's n_parallel_eval envs on the card (tensors there)
        cfg = client_config(MS3_EV_CONFIG, task_list=["widowx_carrot_on_plate"], n_eval_episode=npe)
        envs = []

        def ms3_env(task, n, seed):
            envs.append(FakeMS3Env(n, size))
            return envs[-1]

        # the frames come to the host as the default getter brings them (simplerMS3._to_numpy)
        results, client = drive(f"ManiSkill3 x{npe}", cfg, simplerMS3.SimplerMS3Evaluator, EPISODE_STEPS // steps,
                                EPISODE_STEPS * npe, env_factory=ms3_env,
                                image_getter=lambda env, obs: simplerMS3._to_numpy(env.image()))
        rows = {o["observation.images.top"].shape[0] for o in client.obs}
        log(f"#   ManiSkill3: {sorted(rows)} rows per request, padded to the wrapper's bucket "
            f"{wrapper.bucket_size(npe)}")
        if rows != {npe}:
            raise SystemExit(f"ManiSkill3: requests of {rows} rows, expected {npe}")
        check_actions("ManiSkill3", envs[0].stepped, client.chunks, steps, (npe, 7))
        check_results("ManiSkill3", results, "widowx_carrot_on_plate", set(simpler.METRIC_KEYS))
        check_log("ManiSkill3", log_root, cfg, npe)

        # LIBERO: libero_spatial, one task, one episode; the session a LIBERO server builds (LiberoAdapter)
        cfg = client_config(EV_CONFIG, simulator_name="libero", env_adapter="LiberoAdapter",
                            task_list=["libero_spatial"], n_eval_episode=1)
        env = FakeLiberoEnv(size, libero.SETTLE_STEPS)
        results, client = drive("LIBERO", cfg, libero.LiberoEvaluator, EPISODE_STEPS // steps,
                                libero.SETTLE_STEPS + EPISODE_STEPS, suite_factory=lambda name: FakeLiberoSuite(),
                                env_factory=lambda task, res, seed: (env, task.language))
        # LiberoAdapter.postprocess passes the model's actions through (the gripper too), as the reference's does
        check_actions("LIBERO", env.stepped[libero.SETTLE_STEPS:], client.chunks, steps, (7,), binary_gripper=False)
        # the k-th request carries the frame rendered after SETTLE_STEPS + k * action_step steps (frames[j]: j steps)
        sent = [o["observation.images.top"] for o in client.obs]
        rendered = [env.frames[libero.SETTLE_STEPS + k * steps] for k in range(len(sent))]
        flipped = all(np.array_equal(s, r[::-1, ::-1]) and not np.array_equal(s, r) for s, r in zip(sent, rendered))
        log(f"#   LIBERO: each of the {len(sent)} frames sent is the rendered frame rotated 180 degrees: {flipped}")
        if not flipped:
            raise SystemExit("LIBERO: a frame sent is not the env's frame rotated 180 degrees")
        check_results("LIBERO", results, "libero_spatial", {"Success Rate"})
        check_log("LIBERO", log_root, cfg, 1)
        if results["libero_spatial"]["Success Rate"] != 1.0:
            raise SystemExit("LIBERO: the episode did not run to the env's end (an error abandoned it)")
    finally:
        if saved_log_dir is None:
            os.environ.pop("VLA_LOG_DIR", None)
        else:
            os.environ["VLA_LOG_DIR"] = saved_log_dir
        if saved_imageio is None:
            sys.modules.pop("imageio", None)
        else:
            sys.modules["imageio"] = saved_imageio
        shutil.rmtree(log_root, ignore_errors=True)
    del wrapper
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import intact_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    def run(phase):  # each phase's wall time, to budget the script's time limit
        t = time.perf_counter()
        out = phase()
        log(f"# {phase.__name__}: {time.perf_counter() - t:.1f} s")
        return out

    run(phase_build)
    kernels = {k["name"]: k for k in run(phase_kernels)}
    serving = run(phase_serving)
    torch.cuda.empty_cache()
    int8 = run(phase_int8_serving)
    group_serving = run(phase_multirank_serving)
    tensor_parallel, tp_kernels = run(phase_tensor_parallel)
    kernels.update(tp_kernels)
    tensor_parallel_ar = run(phase_tensor_parallel_ar)
    tensor_parallel_mvla = run(phase_tensor_parallel_mvla)
    tensor_parallel_train = run(phase_tensor_parallel_train)
    training = run(phase_training)
    run(phase_rlds_data)
    standard = run(phase_standard_training)
    multirank = run(phase_multirank_training)
    fast_serving = run(phase_fast_serving)
    fast_training = run(phase_fast_training)
    mvla_serving = run(phase_mvla_serving)
    mvla_training = run(phase_mvla_training)
    svla_serving = run(phase_svla_serving)
    magma_serving = run(phase_magma_serving)
    octo_serving = run(phase_octo_serving)
    client = run(phase_client)
    paths = {"serving": {"flash_attention": serving}, "int8": int8, "group_serving": group_serving,
             "tensor_parallel": tensor_parallel, "tensor_parallel_ar": tensor_parallel_ar,
             "tensor_parallel_mvla": tensor_parallel_mvla, "tensor_parallel_train": tensor_parallel_train,
             "training": training, "standard": standard,
             "multirank": multirank, "fast_serving": fast_serving, "fast_training": fast_training, "mvla_serving": mvla_serving,
             "mvla_training": mvla_training, "svla_serving": svla_serving, "magma_serving": magma_serving,
             "octo_serving": octo_serving, "client": client}
    # SpatialVLA and Magma launch no attention kernel (SpatialVLA's head_dim 72 and softcap keep it plain; LLaMA
    # calls the plain path, as in the reference), and Octo none of the three (plain attention, no int8 Octo), by
    # design
    if not all(n > 0 for path, counts in paths.items() for name, n in counts.items()
               if path != "octo_serving" and (path not in ("svla_serving", "magma_serving") or name == "w8a8_matmul")):
        raise SystemExit(f"a kernel of the path never launched: {paths}")
    for name in kernels:
        kernels[name]["launches"] = sum(counts.get(name, 0) for counts in paths.values())
    log(f"# launches on the main paths: flash_attention {serving} serving + {int8['flash_attention']} int8 "
        f"serving + {group_serving['flash_attention']} group serving + {training['flash_attention']} fused training + {standard['flash_attention']} standard "
        f"training + {multirank['flash_attention']} multi-card recipes + {fast_serving['flash_attention']} Pi0FAST "
        f"serving + {fast_training['flash_attention']} Pi0FAST training, fused_adam_rows {training['fused_adam_rows']} "
        f"fused training + {multirank['fused_adam_rows']} multi-card fused recipe, w8a8_matmul "
        f"{int8['w8a8_matmul']} int8 serving + {group_serving['w8a8_matmul']} int8 group serving + "
        f"{tensor_parallel['w8a8_matmul']} on the two tensor ranks (with w8a8_partial "
        f"{tensor_parallel['w8a8_partial']} and w8a8_finish {tensor_parallel['w8a8_finish']}; flash_attention "
        f"{tensor_parallel['flash_attention']} on local heads) + {tensor_parallel_mvla['w8a8_matmul']} MVLA on the "
        f"two tensor ranks (w8a8_partial {tensor_parallel_mvla['w8a8_partial']}, w8a8_finish "
        f"{tensor_parallel_mvla['w8a8_finish']}, flash_attention {tensor_parallel_mvla['flash_attention']}; "
        f"training on the two tensor ranks: flash_attention {tensor_parallel_train['flash_attention']}, "
        f"fused_adam_rows {tensor_parallel_train['fused_adam_rows']}) + "
        f"{standard['w8a8_matmul']} expert-only training + "
        f"{multirank['w8a8_matmul']} multi-card expert-only + "
        f"{fast_serving['w8a8_matmul']} Pi0FAST int8 serving + {mvla_serving['w8a8_matmul']} MVLA int8 serving; "
        f"MVLA flash_attention {mvla_serving['flash_attention']} serving + {mvla_training['flash_attention']} training; "
        f"SpatialVLA w8a8_matmul {svla_serving['w8a8_matmul']} int8 serving (flash_attention "
        f"{svla_serving['flash_attention']}); Magma w8a8_matmul {magma_serving['w8a8_matmul']} int8 serving "
        f"(flash_attention {magma_serving['flash_attention']}); Octo {octo_serving} (none by design); the client "
        f"role's evaluators flash_attention {client['flash_attention']}, w8a8_matmul {client['w8a8_matmul']}")
    torch.cuda.synchronize()
    log(f"# total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
