#!/usr/bin/env python3
"""Drive flipped_tpu_torch on one CUDA card, end to end.

    python3 chip_smoke.py

Phases; any failure prints its traceback and exits 1 without a result line:
  1. device   torch and CUDA versions, the card's name and power limit;
              exits 1 when torch sees no CUDA device (there is no CPU path)
  2. build    compile flipped_tpu_torch/csrc/ with nvcc for sm_90a, one
              process per source, all started together; fails, naming the
              source, if ptxas reports serialised wgmmas (C7510-C7520,
              `build.wgmma_serialisation_warnings`)
  3. K1       flash_text_fwd against its plain version in bf16 at the unit
              shape, the main-path shapes and the edges of its 128-row q
              and key tiles (S 1 to 255), on strided q/k/v views (slices
              of one (B, S, 3, H, Dh) tensor), and lse against float64;
              at S 2049 and 4096 (the forward-only regime up to
              MAX_SEQ_FWD) within K5's bound (K1_LONG_CASES)
  4. K2       flash_text_bwd against its plain version in bf16 at the unit
              shapes, the training shape and S 650, within the bound stated
              at K2_CASES; dgate2 against a float64 sum
  5. grads    the autograd.Function (K1 forward, K2 backward) against
              autograd through the plain formulation, all seven grads, at
              the training shape
  6. K5/K6    K5, K6a and K6b against their plain versions in bf16 at S
              4096 (B 1 and the long train path's B 3) and a ragged 4100
              (forward and backward) and the S 8192 eval's B 1 and B 5
              (forward), within the bounds stated at STREAM_CASES; the B 1
              S 4096 case also as four q shards at q_offset 0, 1024, 2048,
              3072 against its full K/V: out, lse and dq bit for bit the
              full run's rows, dk, dv and dgate2 partials summed against
              the full backward; then the streaming regime of the
              autograd.Function (K5 forward, K6a + K6b backward) at S 2304,
              its seven grads against plain autograd
  7. quant    K3 int8_fwd, K7 int8_grouped_fwd, K8 int4_fwd's w4a8 branch
              and K10 int8_dgrad bitwise against their plain versions, K4
              quant_dx, K8's weight-only branch and K9 int4_dx within the
              bounds stated at K4_REL and K8_WO_REL, at odd-M unit shapes,
              the wgmma kernels' tile edges (QUANT_EDGE, and K3's, K7's
              and K8 w4a8's own at K3_EDGE, K7_EDGE and K8A_EDGE) and every
              7B main-path shape (K10 on 2-D and 3-D cotangents);
              then through the autograd Functions int8_matmul,
              int8_matmul_grouped, int4_matmul, int4_matmul_grouped and
              int8_matmul_dgrad at the w1/w3 shape
  8. timing   K1 and K2, kernel and plain version: device time by CUDA-graph
              replay between CUDA events, host time per eager call; the
              library yardstick `scaled_dot_product_attention` with the
              gate2 + causal bias as a float mask (forward for K1; for K2
              its backward alone on a saved forward, with forward and
              backward beside it); and each kernel's bound from its bytes
              and operations. K3, K7, K4, K8 (both branches), K9 and K10 the
              same way at the three 3072-row shapes, and K3 and K8 w4a8 at
              the eval's prefill and extend shapes, with the yardsticks
              `time_quant` names; K3, K7 and K8's two branches at the
              decode shapes (M 32, DECODE_SHAPES) beside a bf16 `F.linear`
              on the dequantized weight. K5, K6a and K6b at the long
              training shape (B 3, S 4096), against SDPA's forward (K5) and
              its backward alone on a saved forward (K6a + K6b), with SDPA
              without the mask as an aside
  9. train    `flipped_tpu_torch.cli.train.main` at LLaMA-7B width (dim
              4096, 32 layers, random frozen weights from a seed), --vaq
              --qav, batch 8, S 128, one epoch over 64 synthetic NExT-QA
              items (8 updates) with remat, then its val eval, at --quantize
              none, w8a8, w4a8 and w8a8d, and one update at w8a8g, w8a8o,
              int4 and w4a8r (TRAIN_RUNS): every loss finite, the launches
              per update that `per_update` derives from the code (bf16: 64
              K1, 32 K2; w8a8: 576 K3 more; w8a8g and w8a8o: 576 K7 and 288
              K4 more; the int4 modes: 576 K8 and 288 K9 more; w8a8d: 576
              K3 and 288 K10 more), frozen weights bitwise unchanged, no
              trainable moved by update 1 (lr 0) and every trainable moved
              by update 2; the step without remat (the bench default) timed
              at none, w8a8, w4a8, w8a8d, int4 and w8a8g
 10. eval     the classification eval at 7B width through
              `flipped_tpu_torch.cli.evaluate.main` at --quantize none, w8a8
              and w4a8: 32 K1 (and 576 K3 under w8a8, 576 K8 under w4a8)
              launches per scored batch, every score finite; one batch
              through the cached and the dense eval steps, which must agree
 11. gen      generation eval on the MUSIC-AVQA recipe at 7B width (batch
              32, S 128, --is_generation_task; 128 synthetic items, one val
              batch of 32): `cli.train.main --debug` (one update, then the
              val loop generates: 32 val rows with unique qids in
              extracted_answers_epoch0.json, val_counting in log.txt), then
              `cli.evaluate.main` at --quantize none, w8a8 and w4a8: the
              launches per batch `gen_per_batch` derives from the code (32
              K1 in the prefill; 9 K3 or K8 per block in the prefill and in
              each of the 30 decode steps), similarities finite; s per
              batch, prefill ms and decode ms per token (CUDA events), peak
              memory and the decode step's bytes bound; the cached decode's
              logits against a re-forward of prompt and generated tokens,
              and K1's prefill against the plain attention's, within
              GEN_LOGIT_REL. After phase 12's eval, one batch at S 8192,
              batch 1, bf16: 32 K5 in the prefill, timed the same way
 12. long     the long-context paths at 7B width: `cli.train.main` at
              --batch_size 1 --max_seq_len 4096 --vaq --qav with
              --lm_head_chunk 512 (LONG_RUNS: 4 updates, then one with
              --remat_group 2 and one at --quantize w8a8), 64 K5, 32 K6a,
              32 K6b and no K1 or K2 launches per update (576 K3 more at
              w8a8), losses finite, frozen weights bitwise unchanged, the
              update timed with remat; then `cli.evaluate.main` at
              --max_seq_len 8192 (32 K5 per batch) and one batch through
              the cached and the dense scorers (32 K5 each), which agree
 13. ckpt     the checkpoint path at LLaMA-7B width: the bf16 backbone of
              seed 0 (as phase 9 builds it) exported as two fp16 Meta
              shards (`ckpt.convert.export_meta_checkpoint`, with Meta's 7B
              params.json but vocab_size 32000) under build/; loaded at
              --quantize none, every frozen leaf bit for bit
              bf16(fp16(original)); `cli.train.main --quantize w8a8
              --epochs 1 --debug` from it with an --output_dir: K1, K2 and
              K3 launched, the build's peak allocated memory within the
              parameters' bytes plus 2 GiB, the codes and scales of
              CKPT_HELD bit for bit `quantize_kernel` on the CPU,
              checkpoint_last (and checkpoint_best when the val accuracy
              rose), their sidecars and one log.txt line written; then
              `--resume checkpoint_last --epochs 2`: epoch 1 only, the
              restored trainables, AdamW moments and count bit for bit the
              saved ones, two log.txt lines; `cli.evaluate.main --resume`
              of the best (else the last) checkpoint: its acc the logged
              val_acc; a build at w4a8r (rotate, then int4) scoring one
              val batch: scores finite, K8 launched, qav_rot symmetric.
              Each build's seconds and peak memory are printed; the shards
              are deleted at the end
 14. paths    every quant kernel against its plain version (as in 7) at
              every (M, K, N) that phases 9-13 and 15 handed it (the decode
              steps' M 32 included), on the first inputs each path gave at
              that shape
 15. audio    (run before 14) the audio merges and the rest of the trainer
              through `cli.train.main` at 7B width: the fork's headline
              recipe (--dataset musicavqa --is_generation_task --audio
              --audio_merge attention, batch 32, S 128; 64 items: 2
              updates, then the generated val batch), then sum, concat and
              audio_only at none and attention at w8a8 on NExT-QA (batch 8,
              --vaq --qav, 2 updates each): every loss finite, the video-
              only update's launches (`per_update`; generation's
              `gen_per_batch`), frozen weights unchanged, no trainable moved
              by update 1, every one by update 2 (audio_proj, visual_proj
              and the cross-attention among them) but the attention
              merge's query and key biases, whose gradients over its one
              audio key are exactly zero; the answers by qid; the
              attention update timed without remat beside phase 9's;
              --remat_policy full and qkv (2 updates each: 64 and 32 K1 an
              update, metrics and update 2's gradients within GRAD_REL,
              each timed with remat, peaks), qkv at w8a8, and qkv at S 4096
              (32 K5, 32 K6a, 32 K6b an update); --loader grain
              --num_workers 2 (metrics bit for bit the thread loader's);
              --trace_dir over 4 updates (the Chrome trace's steps 1-3
              hold K1's and K2's kernels, as many as the launch counts say)
Each main path (9, 10, 11, 12, 15, and each run of 13) runs with the launch
counts set to 0 just before it and read just after. The last lines of stdout are the nvidia-smi line, a
JSON line of the kernels and the contract line {"ok": true, "device": ...}.
"""
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

TRAIN_B, TRAIN_S = 8, 128           # --batch_size 8 --max_seq_len 128
# video_start per stacked row of the training encode: VQA and VAQ rows start
# their video at a prompt position, QAV rows carry -1 (no gate2 block)
TRAIN_VS = (5, 1, 9, 0, 5, 3, 2, 5) * 2 + (-1,) * TRAIN_B
TRAIN_SHAPE = (3 * TRAIN_B, TRAIN_S, 32, 128)   # --vaq --qav: 24 sequences

K1_SOURCE = "flipped_tpu_torch/csrc/flash_text_fwd.cu"
K1_REPLACES = "flipped_tpu/model/pallas/flash_attention.py:59"
# (B, S, H, Dh, video_start per example): the unit shape (two batches, so
# -1, 0 and 5 all occur next to another value), the training encode, the
# cached prefill of the eval (batch 8), the dense encode (8 examples x 5
# options), the TVQA length
K1_CASES = [
    (2, 37, 4, 128, (-1, 5)),
    (2, 37, 4, 128, (0, 5)),
    (*TRAIN_SHAPE, TRAIN_VS),
    (8, 128, 32, 128, (5, 1, -1, 0, 5, 3, 2, 5)),
    (40, 128, 32, 128, (5,) * 40),
    (1, 650, 32, 128, (4,)),
    # the edges of K1's 128-row q tiles and 128-key K/V tiles: one row,
    # half a tile, one past it, one short of a tile, one past it, two
    # tiles less one
    (2, 1, 8, 128, (-1, 0)),
    (2, 64, 8, 128, (5, -1)),
    (2, 65, 8, 128, (0, 5)),
    (2, 127, 8, 128, (3, 9)),
    (2, 129, 8, 128, (5, -1)),
    (2, 255, 8, 128, (7, 0)),
]
# K1 on q, k, v that are slices of one (B, S, 3, H, Dh) tensor, as a fused
# projection hands them: strides that are not those of a (B, S, H, Dh)
# tensor, read through the kernel's tensor maps
K1_STRIDED = [(2, 300, 8, 128, (3, -1)), (*TRAIN_SHAPE, TRAIN_VS)]
MAX_FEATS = 10
# Tolerance of K1 against its plain version. The kernel rounds the
# unnormalised P to bf16 and divides by the row sum at the end; the plain
# version, like the TPU kernel, rounds the normalised P. Each rounding moves
# a term by at most half an ulp, 2^-8 relative (bf16 keeps 8 significant
# bits), so the two outputs differ by at most 2^-7 * (P @ |V|) before their
# final roundings to bf16, which add at most 2^-8 |out| each:
#   |kernel - plain| <= 2^-7 * ((P @ |V|) + |plain|) + 2^-14
# (the f32 sums of the two sides, within S 2^-24 of P @ |V| each, are left
# to the floor and to the random signs of the roundings at K1's S <= 650;
# K5's bound at STREAM_CASES, for S up to 8192, writes them out)
K1_REL = 2.0 ** -7
K1_ABS_FLOOR = 2.0 ** -14     # for outputs within rounding of zero
LSE_ATOL = 1e-4               # f32 row sums of up to 650 terms vs float64
# K1 past S 650, in the forward-only regime up to MAX_SEQ_FWD (B, S, H,
# Dh, video_start, strided): there K1_REL's analysis no longer covers the
# f32 sums, and K1 is held within the bound stated at STREAM_CASES for K5,
# which writes them out: K1 computes K5's function at q_offset 0 with
# S_k = S, so out within 2^-7 ((P @ |V|) + |plain|) + 2^-14 + (2 (S + S/64)
# 2^-24 + 2^-16 max_c B) (P @ |V|), and lse within 2^-16 max_c B + (S +
# S/64 + 64) 2^-24 + 2^-23 |lse64| of the float64 log-sum-exp.
K1_LONG_CASES = [(1, 2049, 32, 128, (6,), False),
                 (1, 4096, 32, 128, (9,), False),
                 (1, 2049, 32, 128, (0,), True)]

K2_SOURCE = "flipped_tpu_torch/csrc/flash_text_bwd.cu"
K2_REPLACES = "flipped_tpu/model/pallas/flash_attention.py:174"
# K1 timing shapes: the training encode, the cached eval prefill (batch 8),
# the dense eval encode (8 examples x 5 options) and the generation
# prefill (the MUSIC-AVQA recipe's batch 32)
K1_SHAPES = {"train": TRAIN_SHAPE, "prefill": (8, 128, 32, 128),
             "dense": (40, 128, 32, 128), "gen prefill": (32, 128, 32, 128)}
ADAPTER_LEN = 10
N_TRAIN_ITEMS = 64                  # 8 updates at batch 8; 16 val examples
# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM bytes/s, dense bf16
# tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
K2_CASES = [
    (2, 37, 4, 128, (-1, 5)),
    (2, 37, 4, 128, (0, 5)),
    (*TRAIN_SHAPE, TRAIN_VS),
    (1, 650, 32, 128, (4,)),
]
# Tolerance of K2 against its plain version, from where the two differ.
# Both take the same bf16 operands. The kernel reads P as exp(s - lse) with
# K1's f32 lse, and D = rowsum(dO*O) with K1's bf16 output O; the plain
# version recomputes P by softmax and O = bf16(P).V in f32. Per element, with
# A = |dO|.|V|^T and B = scale |Q|.|K|^T:
#   - P of either side is within eps_P = 2^-16 (B + max_row B) relative of
#     the exact P (f32 sums of Dh products, and the f32 lse);
#   - the two D differ by E_D = |dO.(O_K1 - O_f64)| + |dO.(O_plain - O_f64)|
#     + 2^-15 |dO|.|O|, taken in float64 from the actual outputs;
#   - so the two f32 dS differ by at most
#       dds = P (2 eps_P |dP - D| + E_D + 2^-15 A) + 2^-15 |dS|;
#   - rounding P or dS to bf16 flips by at most one ulp, 2^-7 relative, and
#     the final rounding of dq, dk, dv by at most 2^-7 of the value.
# The bounds double each rounding term:
#   |dv| <= 2^-6 (P^T |dO| + |dv|)
#   |dq| <= scale (2^-6 |dS| + 2 dds) |K| + 2^-6 |dq|
#   |dk| <= scale (2^-6 |dS|^T + 2 dds^T) |Q| + 2^-6 |dk|
# dgate2 is held against the float64 sum of what the kernel computes from
# the same inputs (K1's O in D): within 2 sum_block (P (eps_P |dP - D|
# + 2^-16 A + 2^-16 |dO|.|O|) + 2^-16 |dS|).
K2_ABS_FLOOR = 1e-6
# The seven attention grads (K1 + K2 through the autograd.Function) against
# autograd through the plain formulation in bf16: the two differ by the bf16
# rounding of P, dS and the text output (relative 2^-8 per term, of random
# sign), so the relative Frobenius error of each grad is of order 2^-8; the
# bound allows four times that.
GRAD_REL = 2.0 ** -6
SCORE_RTOL = 2e-2             # cached vs dense eval, both bf16

# The streaming kernels of the long-context path: K5 (forward), K6a (dq and
# dgate2), K6b (dk, dv). The train path runs `cli.train` at --batch_size 1
# --max_seq_len 4096 --vaq --qav (3 sequences of 4096 per encode), the eval
# path `cli.evaluate` at --max_seq_len 8192.
K5_SOURCE = "flipped_tpu_torch/csrc/flash_stream_fwd.cu"
K5_REPLACES = "flipped_tpu/model/pallas/flash_attention.py:314"
K6_SOURCE = "flipped_tpu_torch/csrc/flash_stream_bwd.cu"
K6A_REPLACES = "flipped_tpu/model/pallas/flash_attention.py:484"
K6B_REPLACES = "flipped_tpu/model/pallas/flash_attention.py:535"
LONG_B, LONG_S, LONG_EVAL_S = 1, 4096, 8192
LONG_VS = (7, 3, -1)                # VQA, VAQ, QAV rows of one example
LONG_SHAPE = (3 * LONG_B, LONG_S, 32, 128)
LM_CHUNK = "512"
N_LONG_ITEMS = 4                    # 4 updates at batch 1; 2 val examples
# The generation eval on the MUSIC-AVQA recipe (scripts/recipes.sh:38-42):
# 7B, batch 32, S 128, --is_generation_task; 128 fixture items give 32 val
# rows, one batch; at --quantize none, w8a8 and w4a8
GEN_B, GEN_S = 32, 128
N_GEN_ITEMS = 128
GEN_RUNS = ("none", "w8a8", "w4a8")
# Tolerance of the generation checks at 7B in bf16, as a share of each
# row's largest |logit|. The cached decode and the re-forward (or K1's
# prefill and the plain attention's) compute the same function and round
# at other places: the plain decode attention rounds the normalised P to
# bf16 where K1 rounds the unnormalised one (2^-7 relative, K1_REL), and a
# GEMM at M 32 rows may sum in another order than at M 5088 and round to
# the other bf16 neighbour (2^-8 relative). About 10 such roundings a block
# differ, by half an ulp on average and of random sign, so over 32 blocks
# the residual stream's relative difference grows as sqrt(320) 2^-9 =
# 2^-4.8, and the logits, a projection of it, by as much of their scale:
# held at 2^-4 of the row's largest |logit|.
GEN_LOGIT_REL = 2.0 ** -4
# (B, S_q, S_k, H, q_offset, video_start, with the backward): the training
# length at B 1, the long train path's encode (LONG_SHAPE: K5, K6a and K6b),
# a ragged S, and the S 8192 eval's forward-only shapes, the cached prefill
# (B 1) and the dense scorer's batch (B 5). The plain versions go one head
# at a time, so every case runs at the full 32 heads. The first case also
# runs as SHARDS q shards at q_offset 0, S/4, S/2, 3S/4 against its full K/V
STREAM_CASES = [(1, 4096, 4096, 32, 0, (7,), True),
                (3, LONG_S, LONG_S, 32, 0, LONG_VS, True),
                (1, 4100, 4100, 32, 0, (5,), True),
                (1, LONG_EVAL_S, LONG_EVAL_S, 32, 0, (40,), False),
                (5, LONG_EVAL_S, LONG_EVAL_S, 32, 0, (40, 7, -1, 0, 12),
                 False)]
SHARDS = 4
# K5 against its plain version: K1's bound (K1_REL) plus what grows with S:
# the f32 sums of up to S_k terms and S_k/64 rescales on both sides, and
# each side's score errors (2^-17 B per score, B = scale |q|.|k|, moving
# each P by as much relative), with P @ |V| from the plain version on |V|:
#   |kernel - plain| <= 2^-7 ((P @ |V|) + |plain|) + 2^-14
#       + (2 (S_k + S_k/64) 2^-24 + 2^-16 max_c B) (P @ |V|)
# K5's lse against the float64 log-sum-exp of the same bf16 inputs: the
# kernel's scores carry
# f32 sums of Dh products (2^-17 B per score, B = scale |q|.|k|) plus the
# scale and bias roundings (within 2^-16 B together), the row sum l adds up
# to S_k terms and S_k/64 rescales, each rounding 2^-24, and m + log(l)
# rounds once more:
#   |lse - lse64| <= 2^-16 max_c B + (S_k + S_k/64 + 64) 2^-24
#                    + 2^-23 |lse64|
# K6a and K6b against their plain versions: K2's analysis (K2_CASES) with
# the same lse and D on both sides (the wrapper and the plain version take D
# from one torch expression, so E_D = 0) and the f32 sums written out: with
# x = s - lse, __expf's error (2 + 1.2|x|) 2^-22 joins eps_P on each side,
#   eps_P = 2^-16 B + 2^-21 (2 + 1.2 |x|)
#   dds   = P (2 eps_P |dP - D| + 2^-15 A) + 2^-15 |dS|
#   w     = 2^-6 |dS| + 2 dds
#   |dq| <= scale (w + 2 S_k 2^-24 |dS|) |K| + 2^-6 |dq| + floor
#   |dk| <= scale (w + 2 S_q 2^-24 |dS|)^T |Q| + 2^-6 |dk| + floor
#   |dv| <= (2^-6 + 2 S_q 2^-24) P^T |dO| + 2^-6 |dv| + floor
# (the accumulation terms are the worst-case f32 sums of up to S terms on
# each side), and dgate2 within sum_block dds + 2 n_block 2^-24 sum_block
# |dS| (both sum the same f32 dS in other orders). The shards' summed
# dk, dv partials against the unsharded K6b: the terms are the same (the
# same lse, D and tiles), each partial and the full result round an f32
# sum to bf16 once (2^-8 relative), and the f32 sums, split at the shard
# boundaries, each lie within S_q 2^-24 M of the exact sum, M = scale
# |dS|^T |Q| (for dv, P^T |dO|):
#   |sum_i dk_i - dk| <= 2^-8 (sum_i |dk_i| + |dk|) + 2 S_q 2^-24 M + floor
# and dgate2 within 2^-16 sum_block |dS| (the same per-tile partials, each at
# most the sum of its |dS|, summed in another order: 68 roundings of
# 2^-24). out, lse and dq of a shard equal the matching rows of the full
# run bit for bit: the same tiles, the same operations.
STREAM_FLOOR = 1e-6
STREAM_GRAD_SHAPE = (1, 2304, 32, 128)     # S > MAX_SEQ_BWD: the K5/K6 VJP

# The int8 GEMMs of the quantized backbone: K3 (w8a8), K7 and K4 (w8a8g,
# w8a8o). (M, K, N) for a Linear of K inputs and N outputs on M rows: unit
# shapes with odd M (K not a multiple of 128 only for K3, which takes any
# K % 16 == 0), then every 7B main-path shape: the 3072 rows of the stacked
# training encode through wq/wk/wv/wo (4096 -> 4096), w1/w3 (4096 -> 11008)
# and w2 (11008 -> 4096), and the 10 adapter rows through wk/wv.
K3_SOURCE = "flipped_tpu_torch/csrc/int8_fwd.cu"
K3_REPLACES = "flipped_tpu/model/pallas/quant_matmul.py:603"
K7_SOURCE = "flipped_tpu_torch/csrc/int8_grouped_fwd.cu"
K7_REPLACES = "flipped_tpu/model/pallas/quant_matmul.py:55"
K4_SOURCE = "flipped_tpu_torch/csrc/quant_dx.cu"
K4_REPLACES = "flipped_tpu/model/pallas/quant_matmul.py:316"
TRAIN_M = 3 * TRAIN_B * TRAIN_S
QUANT_UNIT = [(10, 256, 136), (37, 384, 256), (37, 272, 120),
              (130, 1024, 1040)]
# edges of the TMA + wgmma tiles of K8 weight-only (128 x rows by 64 packed
# rows, 64-deep stages), K10's GEMM (256 rows by 128 output columns,
# 128-deep stages) and K4 / K9 (256 g rows by 128 dx columns, 64-deep
# stages; K9's of 64 packed rows): 3 rows (quant_inputs zeroes the middle
# one), M past a 256-row tile (257, 300, 1000), N/2 of 200, 56, 72 and 520,
# a contraction of one group and of 86, K4 contractions N (400, 112, 144,
# 1040) and a K10 contraction that end part-way through a stage, and K4 /
# K9 dx widths K of exactly one group (128)
QUANT_EDGE = [(3, 11008, 400), (65, 128, 112), (1000, 512, 144),
              (257, 256, 1040), (300, 128, 400)]
# edges of K3's tiles (128 rows by 256 columns, 128-deep stages): one row,
# M past a 128- and a 256-row tile (129, 257), N past a 256-column tile
# (264) and short of one (136), a contraction of one 16-byte step (16) and
# contractions that end part-way through a stage (144, 400)
K3_EDGE = [(1, 16, 264), (129, 144, 136), (257, 400, 264), (1, 4096, 136),
           (257, 16, 136), (129, 1040, 264)]
# edges of K7's tiles (128 rows by 128 columns, one 128-wide group a stage,
# two accumulators alternating between groups) and K8 w4a8's (128 x rows by
# 64 packed rows, the same group loop): one row, M short of and past a
# 64-row warpgroup and past a 128- and a 256-row tile, N past and short of
# a tile (K7 N 136 and 264, K8 N/2 72 and 200), a contraction of one group,
# an odd group count (9) and 86 groups (an even count: the kernels' other
# instantiation); K8 also at group 256 (K8A_EDGE: (M, K, N, group))
K7_EDGE = [(1, 128, 136), (63, 1152, 264), (65, 11008, 136),
           (129, 128, 264), (257, 1152, 136), (257, 11008, 264)]
K8A_EDGE = [(1, 128, 144, 128), (63, 1152, 400, 128), (65, 11008, 144, 128),
            (129, 2304, 400, 256), (257, 2304, 144, 256),
            (257, 11008, 400, 128)]
QUANT_MAIN = {"wq/wk/wv/wo": (TRAIN_M, 4096, 4096),
              "w1/w3": (TRAIN_M, 4096, 11008),
              "w2": (TRAIN_M, 11008, 4096),
              "adapter wk/wv": (ADAPTER_LEN, 4096, 4096)}
# K3 timed at the w1/w3 shape of the eval too: the cached scorer's prefill
# (batch 8 x S 128 rows) and its chunk extend (8 x 5 options x 8 tokens).
# Every shape any main path hands K3, K7 or K4 is also held against the
# plain version after the paths have run (`catch_quant_inputs`). K8's w4a8
# branch, the w4a8 eval's GEMM, is timed at the same two shapes.
K3_EVAL = {"eval prefill w1/w3": (TRAIN_B * TRAIN_S, 4096, 11008),
           "eval extend w1/w3": (320, 4096, 11008)}
# the shape of each kernel's row in the kernels line: the largest per call
QUANT_ROW_SHAPE = "w1/w3"
# The generation eval's decode steps hand K3, K7 and K8 one row per
# example: M = the batch's 32 rows at the three block shapes. Timed in the
# timing phase beside a bf16 `F.linear` on the dequantized weight
# (`time_decode_shape`); the paths' own inputs at these shapes are held
# against the plain versions in the last phase.
DECODE_SHAPES = {"decode wq/wk/wv/wo": (32, 4096, 4096),
                 "decode w1/w3": (32, 4096, 11008),
                 "decode w2": (32, 11008, 4096)}
# K3 and K7 against their plain versions: bitwise. Both compute the same
# IEEE operations in the same order (explicit __fmul_rn/__fadd_rn/__fdiv_rn
# in the kernels, one op per tensor pass in the plain versions, exact integer
# dots on both sides), so the count of unequal output elements must be 0.
# K4 against its plain version (a cuBLAS bf16 product on the dequantized
# weight, reduced-precision reductions off): the two f32 sums of N products
# differ by at most N*2^-24*(|g|.|W|^T), and each rounds to bf16 once:
#   |kernel - plain| <= 2^-7 |plain| + N 2^-24 (|g|.|W|^T)
K4_REL = 2.0 ** -7
# H100 SXM dense int8 tensor-core peak (NVIDIA data sheet, at 700 W)
INT8_OP_PER_S = 1979e12

# The packed-int4 GEMMs and the w8a8d dgrad: K8 (int4_fwd: w4a8 and the
# weight-only int4), K9 (int4_dx) and K10 (int8_dgrad). K8 and K9 take the
# shapes the model's guard lets through (N/2 and the group multiples of 128;
# their unit shapes here only need N % 16 == 0 and K % 128 == 0), K10 any
# N % 16 == 0 and K % 16 == 0.
K8_SOURCE = "flipped_tpu_torch/csrc/int4_fwd.cu"
K8_REPLACES = "flipped_tpu/model/pallas/quant_matmul.py:160"
K9_SOURCE = "flipped_tpu_torch/csrc/int4_dx.cu"
K9_REPLACES = "flipped_tpu/model/pallas/quant_matmul.py:701"
K10_SOURCE = "flipped_tpu_torch/csrc/int8_dgrad.cu"
K10_REPLACES = "flipped_tpu/model/pallas/quant_matmul.py:449"
# K8's w4a8 branch and K10 against their plain versions: bitwise, as K3 and
# K7 (the same IEEE operations in the same order on exact integer dots; K10
# also the same uint32 hash and f32 comparisons). K8's weight-only branch
# and K9 sum bf16 products (exact in f32) in f32 in the tensor cores' order,
# the plain versions exactly (K8: each group's sum in float64, rounded once
# to f32) or in cuBLAS's order (K9). Over a contraction of C terms the two
# f32 results differ by at most C·2^-24·(|a|·|W|ᵀ), and K8's G group folds
# (a multiply and an add, each rounded) add 2G·2^-24·(|a|·|W|ᵀ). Rounding
# both to bf16 adds at most half an ulp on each side, ≤ 2^-8 of each value:
#   |kernel - plain| ≤ (2^-7·|plain| + (C + 2G)·2^-24·(|a|·|W|ᵀ))·(1 + 2^-8)
# with W the weight as each side multiplies it (K8: codes·s_g; K9: the bf16
# dequantized weight), C = K for K8 and N for K9 (G = 0).
K8_WO_REL = 2.0 ** -7


# the quant kernels' keys: K8's two branches are held and timed apart
QUANT_KERNELS = ("k3", "k7", "k4", "k8a", "k8w", "k9", "k10")
# (--quantize, one update only): 8 updates where the mode's kernels carry
# the epoch's counts, one where an earlier run covers its kernels already
TRAIN_RUNS = (("none", False), ("w8a8", False), ("w8a8g", True),
              ("w8a8o", True), ("w4a8", False), ("w8a8d", False),
              ("int4", True), ("w4a8r", True))
TIMED_STEPS = ("none", "w8a8", "w4a8", "w8a8d", "int4", "w8a8g")
EVAL_RUNS = ("none", "w8a8", "w4a8")
# the long-context train path (--quantize, flags, one update only): 4
# updates with the chunked LM head (their update timed with remat), one
# with remat groups of 2, one at w8a8 (the mode of the JAX package's
# S = 4096 row)
LONG_RUNS = (("none", ("--lm_head_chunk", LM_CHUNK), False),
             ("none", ("--lm_head_chunk", LM_CHUNK, "--remat_group", "2"),
              True),
             ("w8a8", ("--lm_head_chunk", LM_CHUNK), True))


def phase(name):
    print(f"== {name}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def k1_inputs(torch, b, s, h, dh, vs, seed, strided=False):
    """q, k, v (B, S, H, Dh) bf16, or with `strided` the three slices of
    one (B, S, 3, H, Dh) tensor; gate2 (H,) f32, video_start (B,) int32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if strided:
        q, k, v = torch.randn(b, s, 3, h, dh, device="cuda", generator=g).to(
            torch.bfloat16).unbind(2)
    else:
        q, k, v = (torch.randn(b, s, h, dh, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(3))
    gate2 = torch.randn(h, device="cuda", generator=g)
    video_start = torch.tensor(vs, dtype=torch.int32, device="cuda")
    return q, k, v, gate2, video_start


def check_k1(torch, fa):
    from flipped_tpu_torch.model.attention import video_block_bias

    worst = 0.0
    cases = ([(c, i, False) for i, c in enumerate(K1_CASES)]
             + [(c, 50 + i, True) for i, c in enumerate(K1_STRIDED)])
    for (b, s, h, dh, vs), seed, strided in cases:
        q, k, v, gate2, video_start = k1_inputs(torch, b, s, h, dh, vs, seed,
                                                strided)
        out, lse = fa.flash_text_attention(q, k, v, gate2, video_start,
                                           MAX_FEATS)
        torch.cuda.synchronize()
        ref, _ = fa.flash_text_attention_ref(q, k, v, gate2, video_start,
                                             MAX_FEATS)
        torch.cuda.synchronize()
        ref32 = ref.float()
        err = (out.float() - ref32).abs()
        scale, _ = fa.flash_text_attention_ref(q, k, v.abs(), gate2,
                                               video_start, MAX_FEATS)
        bound = K1_REL * (scale.float() + ref32.abs()) + K1_ABS_FLOOR
        ratio = float((err / bound).max())
        sc = torch.einsum("bshd,bthd->bhst", q.double(), k.double()) \
            / math.sqrt(dh)
        sc = sc + video_block_bias(video_start, s, MAX_FEATS, gate2.double())
        causal = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
        lse64 = torch.logsumexp(sc.masked_fill(~causal, -math.inf), dim=-1)
        lse_err = float((lse.double() - lse64).abs().max())
        torch.cuda.synchronize()
        max_err = float(err.max())
        worst = max(worst, max_err)
        print(f"K1 {(b, s, h, dh)} vs={vs[:4]}"
              + (" (strided views)" if strided else "")
              + f": max|out-plain|={max_err:.6g} (worst {ratio:.3f} of the "
              f"bound), max|lse-f64|={lse_err:.3g}", flush=True)
        if not torch.isfinite(out).all():
            raise AssertionError("K1 produced non-finite values")
        if ratio > 1.0:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{(b, s, h, dh)}")
        if lse_err > LSE_ATOL:
            raise AssertionError(f"K1 lse off by {lse_err} at {(b, s, h, dh)}")
    return worst


def check_k1_long(torch, fa):
    """K1 at K1_LONG_CASES (S past 650, up to MAX_SEQ_FWD) within K5's
    bounds (`hold_k5` at q_offset 0); returns the worst |kernel - plain|."""
    worst = 0.0
    for i, (b, s, h, dh, vs, strided) in enumerate(K1_LONG_CASES):
        q, k, v, gate2, video_start = k1_inputs(torch, b, s, h, dh, vs,
                                                70 + i, strided)
        before = fa.flash_text_attention.launches
        out, lse = fa.flash_text_attention(q, k, v, gate2, video_start,
                                           MAX_FEATS)
        torch.cuda.synchronize()
        if fa.flash_text_attention.launches != before + 1:
            raise AssertionError(f"S {s} did not launch K1")
        err, ratio, lse_ratio = hold_k5(torch, fa, q, k, v, gate2,
                                        video_start, 0, out, lse)
        worst = max(worst, err)
        print(f"K1 {(b, s, h, dh)} vs={vs}"
              + (" (strided views)" if strided else "")
              + f": max|out-plain|={err:.6g} ({ratio:.3f} of K5's bound), "
              f"lse {lse_ratio:.3f} of its bound", flush=True)
        if ratio > 1.0 or lse_ratio > 1.0:
            raise AssertionError(f"K1 disagrees with its plain version or "
                                 f"float64 at {(b, s, h, dh)}")
        del q, k, v, out, lse
    return worst


def k2_inputs(torch, b, s, h, dh, vs, seed):
    q, k, v, gate2, video_start = k1_inputs(torch, b, s, h, dh, vs, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    do = torch.randn(b, s, h, dh, device="cuda", generator=g).to(
        torch.bfloat16)
    return q, k, v, gate2, video_start, do


def k2_bounds(torch, fa, q, k, v, gate2, video_start, do, out, refs):
    """Float64 quantities of the K2 tolerance (see K2_CASES): the bounds of
    |kernel - plain| for dq, dk, dv given the plain grads `refs`, and the
    float64 dgate2 of the kernel's inputs with its bound."""
    from flipped_tpu_torch.model.attention import video_block_bias

    b, s, h, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    q64, k64, v64, do64, out64 = (x.double() for x in (q, k, v, do, out))
    sc = torch.einsum("bshd,bthd->bhst", q64, k64) * scale
    sc = sc + video_block_bias(video_start, s, MAX_FEATS, gate2.double())
    causal = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    p = torch.softmax(sc.masked_fill(~causal, -math.inf), dim=-1)
    o = torch.einsum("bhst,bthd->bshd", p, v64)
    # the plain version's O, by its own ops on the same device
    p_plain = torch.softmax(fa._masked_scores(q, k, gate2, video_start,
                                              MAX_FEATS), dim=-1)
    o_plain = torch.einsum("bhst,bthd->bshd", p_plain.to(q.dtype).float(),
                           v.float()).double()
    rowdot = lambda x, y: (x * y).sum(-1).transpose(1, 2)     # (B,H,S)
    d = rowdot(o, do64)[..., None]
    dp = torch.einsum("bshd,bthd->bhst", do64, v64)
    ds = p * (dp - d)
    a = torch.einsum("bshd,bthd->bhst", do64.abs(), v64.abs())
    bb = torch.einsum("bshd,bthd->bhst", q64.abs(), k64.abs()) * scale
    eps_p = 2.0 ** -16 * (bb + bb.masked_fill(~causal, 0).amax(-1, True))
    do_o = rowdot(do64.abs(), out64.abs())[..., None]
    e_d = (rowdot(do64, out64 - o).abs() + rowdot(do64, o_plain - o).abs()
           )[..., None] + 2.0 ** -15 * do_o
    dds = p * (2 * eps_p * (dp - d).abs() + e_d + 2.0 ** -15 * a) \
        + 2.0 ** -15 * ds.abs()
    w = 2.0 ** -6 * ds.abs() + 2 * dds
    dq_ref, dk_ref, dv_ref = (x.double().abs() for x in refs)
    bound_dq = scale * torch.einsum("bhst,bthd->bshd", w, k64.abs()) \
        + 2.0 ** -6 * dq_ref + K2_ABS_FLOOR
    bound_dk = scale * torch.einsum("bhst,bshd->bthd", w, q64.abs()) \
        + 2.0 ** -6 * dk_ref + K2_ABS_FLOOR
    bound_dv = 2.0 ** -6 * (torch.einsum("bhst,bshd->bthd", p, do64.abs())
                            + dv_ref) + K2_ABS_FLOOR
    block = video_block_bias(video_start, s, MAX_FEATS,
                             torch.ones(h, dtype=torch.float64,
                                        device="cuda")) > 0
    ds_k = p * (dp - rowdot(out64, do64)[..., None])
    eps_k = p * (eps_p * (dp - d).abs() + 2.0 ** -16 * (a + do_o)) \
        + 2.0 ** -16 * ds.abs()
    dg2 = torch.where(block, ds_k, 0).sum(dim=(0, 2, 3))
    bound_dg2 = 2 * torch.where(block, eps_k, 0).sum(dim=(0, 2, 3)) \
        + K2_ABS_FLOOR
    return (bound_dq, bound_dk, bound_dv), dg2, bound_dg2


def check_k2(torch, fa):
    worst = 0.0
    for i, (b, s, h, dh, vs) in enumerate(K2_CASES):
        q, k, v, gate2, video_start, do = k2_inputs(torch, b, s, h, dh, vs, i)
        out, lse = fa.flash_text_attention(q, k, v, gate2, video_start,
                                           MAX_FEATS)
        grads = fa.flash_text_attention_bwd(q, k, v, gate2, video_start,
                                            MAX_FEATS, do, out, lse)
        torch.cuda.synchronize()
        refs = fa.flash_text_attention_bwd_ref(q, k, v, gate2, video_start,
                                               MAX_FEATS, do)
        bounds, dg2_64, bound_dg2 = k2_bounds(torch, fa, q, k, v, gate2,
                                              video_start, do, out, refs[:3])
        msg = []
        for name, x, ref, bound in zip(("dq", "dk", "dv"), grads, refs,
                                       bounds):
            if not torch.isfinite(x).all():
                raise AssertionError(f"K2 {name} non-finite at {(b, s, h)}")
            err = (x.double() - ref.double()).abs()
            ratio = float((err / bound).max())
            worst = max(worst, float(err.max()))
            msg.append(f"{name} max|d|={float(err.max()):.4g} "
                       f"({ratio:.3f} of bound)")
            if ratio > 1.0:
                raise AssertionError(f"K2 {name} disagrees with its plain "
                                     f"version at {(b, s, h, dh)}: "
                                     f"{ratio:.3f} of the bound")
        g_err = (grads[3].double() - dg2_64).abs()
        g_ratio = float((g_err / bound_dg2).max())
        torch.cuda.synchronize()
        print(f"K2 {(b, s, h, dh)} vs={vs[:4]}: " + ", ".join(msg)
              + f", dgate2 max|d-f64|={float(g_err.max()):.4g} "
              f"({g_ratio:.3f} of bound)", flush=True)
        if g_ratio > 1.0:
            raise AssertionError(f"K2 dgate2 off the float64 sum at "
                                 f"{(b, s, h, dh)}: {g_ratio:.3f} of bound")
    return worst


def device_ms(torch, fn, n=20, reps=5, stream=None):
    """Device time of one call: `n` calls captured in a CUDA graph, replayed
    `reps` times between CUDA events. Replay has no host work between the
    launches, so this is the kernels' time, not the Python wrapper's.
    `stream`, if given, is the stream the warm-up runs on and the graph
    captures (an autograd backward runs on its forward's stream)."""
    side = stream if stream is not None else torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def host_us(torch, fn, n=30):
    """Host time of one eager call (enqueue only), after one warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def check_grads(torch, fa):
    """All seven grads of the autograd.Function against autograd through
    the plain formulation, at the training shape; returns the worst
    relative Frobenius error."""
    from flipped_tpu_torch.model.attention import adapter_gated_attention

    b, s, h, dh = TRAIN_SHAPE
    g = torch.Generator(device="cuda").manual_seed(7)
    mk = lambda *shape: torch.randn(*shape, device="cuda", generator=g)
    leaves = [mk(b, s, h, dh).to(torch.bfloat16) for _ in range(3)] \
        + [mk(ADAPTER_LEN, h, dh).to(torch.bfloat16) for _ in range(2)] \
        + [mk(h) * 0.5, mk(h) - 3.0]          # gate1, gate2 (f32)
    w = mk(b, s, h * dh).to(torch.bfloat16)
    vs = torch.tensor(TRAIN_VS, dtype=torch.int32, device="cuda")
    grads = {}
    for name, fn in (("kernels", fa.flash_adapter_attention),
                     ("plain", adapter_gated_attention)):
        xs = [x.detach().requires_grad_() for x in leaves]
        out = fn(*xs, vs, MAX_FEATS)
        grads[name] = torch.autograd.grad(out, xs, w)
    torch.cuda.synchronize()
    worst, msg = 0.0, []
    for name, a, r in zip(("dq", "dk", "dv", "dak", "dav", "dgate1",
                           "dgate2"), grads["kernels"], grads["plain"]):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name} through the kernels is not finite")
        rel = float((a.double() - r.double()).norm() / r.double().norm())
        worst = max(worst, rel)
        msg.append(f"{name} {rel:.3g}")
        if rel > GRAD_REL:
            raise AssertionError(f"{name}: relative error {rel} > {GRAD_REL}")
    print(f"attention grads {TRAIN_SHAPE}, relative Frobenius error of "
          f"kernels vs plain autograd: " + ", ".join(msg), flush=True)
    return worst


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOP_PER_S):
    """(least time in ms, what bounds it) at the card's published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def k1_bound(b, s, h, dh):
    """q, k, v read and out written (bf16), lse written (f32); QK^T and PV
    over the causal pairs."""
    nbytes = 4 * b * s * h * dh * 2 + b * h * s * 4
    return bound_ms(nbytes, 2 * 2 * dh * causal_pairs(s) * b * h)


def k2_bound(b, s, h, dh):
    """q, k, v, dout and lse read, dq, dk, dv written; five products
    (QK^T, dO V^T, P^T dO, dS K, dS^T Q) over the causal pairs. The kernel
    also reads out (for rowsum(dO*O)), but the function does not need it:
    O can be recomputed from the K and V it reads."""
    nbytes = 7 * b * s * h * dh * 2 + b * h * s * 4
    return bound_ms(nbytes, 5 * 2 * dh * causal_pairs(s) * b * h)


def sdpa_mask(torch, gate2, video_start, s):
    """The gate2 video block and the causal mask as one additive bf16 mask
    (B, H, S, S), the form `scaled_dot_product_attention` takes."""
    from flipped_tpu_torch.model.attention import video_block_bias

    bias = video_block_bias(video_start, s, MAX_FEATS, gate2.float())
    causal = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    return bias.masked_fill(~causal, -math.inf).to(torch.bfloat16)


def stream_inputs(torch, b, s_q, s_k, h, vs, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda s: torch.randn(b, s, h, 128, device="cuda",
                               generator=g).to(torch.bfloat16)
    q, k, v, do = mk(s_q), mk(s_k), mk(s_k), mk(s_q)
    gate2 = torch.randn(h, device="cuda", generator=g)
    return q, k, v, do, gate2, torch.tensor(vs, dtype=torch.int32,
                                            device="cuda")


def head_terms(torch, fa, q, k, gate2, video_start, q_offset, j):
    """float64 scores s (B, S_q, S_k) of head j with the gate2 bias, the
    causal mask, B = scale |q|.|k|^T, and the video block."""
    s_q, s_k, dh = q.shape[1], k.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(dh)
    qj, kj = q[:, :, j].double(), k[:, :, j].double()
    block = fa._video_block(s_q, s_k, video_start, MAX_FEATS, "cuda",
                            q_offset)[:, 0]
    s = torch.einsum("bsd,btd->bst", qj, kj) * scale \
        + torch.where(block, gate2[j].double(), 0.0)
    causal = (torch.arange(s_k, device="cuda")[None, :]
              <= torch.arange(s_q, device="cuda")[:, None] + q_offset)
    bb = torch.einsum("bsd,btd->bst", qj.abs(), kj.abs()) * scale
    return s, causal, bb, block


def hold_k5(torch, fa, q, k, v, gate2, video_start, q_offset, out, lse):
    """K5's out against its plain version and its lse against the float64
    log-sum-exp (the bounds at STREAM_CASES). Returns (max |out - plain|,
    out ratio to its bound, lse ratio to its bound)."""
    b, s_q, h, _ = q.shape
    s_k = k.shape[1]
    max_b = torch.empty((b, s_q, h, 1), dtype=torch.float64, device="cuda")
    lse_ratio = 0.0
    for j in range(h):
        s, causal, bb, _ = head_terms(torch, fa, q, k, gate2, video_start,
                                      q_offset, j)
        lse64 = torch.logsumexp(s.masked_fill(~causal, -math.inf), dim=-1)
        max_b[:, :, j, 0] = bb.masked_fill(~causal, 0).amax(-1)
        bound = (2.0 ** -16 * max_b[:, :, j, 0]
                 + (s_k + s_k / 64 + 64) * 2.0 ** -24
                 + 2.0 ** -23 * lse64.abs())
        lse_ratio = max(lse_ratio, float(((lse[:, j].double() - lse64).abs()
                                          / bound).max()))
        del s, causal, bb, lse64
    ref, _ = fa.flash_streaming_fwd_ref(q, k, v, gate2, video_start,
                                        MAX_FEATS, q_offset)
    mag, _ = fa.flash_streaming_fwd_ref(q, k, v.abs(), gate2, video_start,
                                        MAX_FEATS, q_offset)
    mag = mag.double()
    bound = (K1_REL * (mag + ref.double().abs()) + K1_ABS_FLOOR
             + (2 * (s_k + s_k / 64) * 2.0 ** -24 + 2.0 ** -16 * max_b) * mag)
    err = (out.double() - ref.double()).abs()
    ratio = float((err / bound).max())
    if not torch.isfinite(out).all():
        raise AssertionError("K5 produced non-finite values")
    return float(err.max()), ratio, lse_ratio


def k6_bounds(torch, fa, q, k, v, gate2, video_start, q_offset, do, lse,
              delta, refs):
    """float64 bounds of |kernel - plain| for K6a's dq, dgate2 and K6b's
    dk, dv given the plain results `refs` (dq, dgate2, dk, dv), head by head
    (the bound at STREAM_CASES); and the magnitudes {"dk": scale |dS|^T |Q|,
    "dv": P^T |dO|, "dgate2": sum_block |dS| per head}."""
    b, s_q, h, dh = q.shape
    s_k = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    dq_ref, dg2_ref, dk_ref, dv_ref = refs
    bq, bk, bv, mk, mv = (
        torch.zeros(x.shape, dtype=torch.float64, device="cuda")
        for x in (q, k, v, k, v))
    bg = torch.zeros(h, dtype=torch.float64, device="cuda")
    ds_mag = torch.zeros(h, dtype=torch.float64, device="cuda")
    for j in range(h):
        s, causal, bb, block = head_terms(torch, fa, q, k, gate2,
                                          video_start, q_offset, j)
        x = torch.where(causal, s - lse[:, j, :, None].double(), 0.0)
        p = torch.where(causal, torch.exp(x), 0.0)
        vj, doj = v[:, :, j].double(), do[:, :, j].double()
        dp = torch.einsum("bsd,btd->bst", doj, vj)
        dpd = dp - delta[:, j, :, None].double()
        ds = p * dpd
        a = torch.einsum("bsd,btd->bst", doj.abs(), vj.abs())
        eps_p = 2.0 ** -16 * bb + 2.0 ** -21 * (2 + 1.2 * x.abs())
        dds = p * (2 * eps_p * dpd.abs() + 2.0 ** -15 * a) \
            + 2.0 ** -15 * ds.abs()
        w = 2.0 ** -6 * ds.abs() + 2 * dds
        qa, ka = q[:, :, j].double().abs(), k[:, :, j].double().abs()
        bq[:, :, j] = scale * torch.einsum(
            "bst,btd->bsd", w + 2 * s_k * 2.0 ** -24 * ds.abs(), ka)
        mk[:, :, j] = scale * torch.einsum("bst,bsd->btd", ds.abs(), qa)
        mv[:, :, j] = torch.einsum("bst,bsd->btd", p, doj.abs())
        bk[:, :, j] = scale * torch.einsum("bst,bsd->btd", w, qa) \
            + 2 * s_q * 2.0 ** -24 * mk[:, :, j]
        bv[:, :, j] = (2.0 ** -6 + 2 * s_q * 2.0 ** -24) * mv[:, :, j]
        in_block = block & causal
        ds_mag[j] = torch.where(in_block, ds.abs(), 0.0).sum()
        bg[j] = (torch.where(in_block, dds, 0.0).sum()
                 + 2 * float(in_block.sum()) * 2.0 ** -24 * ds_mag[j])
    bq += 2.0 ** -6 * dq_ref.double().abs() + STREAM_FLOOR
    bk += 2.0 ** -6 * dk_ref.double().abs() + STREAM_FLOOR
    bv += 2.0 ** -6 * dv_ref.double().abs() + STREAM_FLOOR
    return (bq, bg + STREAM_FLOOR, bk, bv), {"dk": mk, "dv": mv,
                                             "dgate2": ds_mag}


def hold_k6(torch, fa, q, k, v, gate2, video_start, q_offset, do, lse,
            delta, got, worst, where):
    """K6a's (dq, dgate2) and K6b's (dk, dv) `got` against their plain
    versions on the same lse and D, within `k6_bounds`; updates worst["k6a"]
    (dq) and worst["k6b"] (dk, dv). Returns `k6_bounds`' magnitudes."""
    args = (q, k, v, gate2, video_start, MAX_FEATS, do, lse, delta, q_offset)
    refs = fa.flash_streaming_dq_ref(*args) + fa.flash_streaming_dkv_ref(*args)
    bounds, mags = k6_bounds(torch, fa, q, k, v, gate2, video_start,
                             q_offset, do, lse, delta, refs)
    msg = []
    for name, x, r, bound in zip(("dq", "dgate2", "dk", "dv"), got, refs,
                                 bounds):
        if not torch.isfinite(x).all():
            raise AssertionError(f"K6 {name} non-finite at {where}")
        err = (x.double() - r.double()).abs()
        ratio = float((err / bound).max())
        if name != "dgate2":
            key = "k6a" if name == "dq" else "k6b"
            worst[key] = max(worst[key], float(err.max()))
        msg.append(f"{name} max|d|={float(err.max()):.4g} ({ratio:.3f} of "
                   f"bound)")
        if ratio > 1.0:
            raise AssertionError(f"K6 {name} disagrees with its plain version "
                                 f"at {where}: {ratio:.3f} of the bound")
    print(f"  K6 vs plain at {where}: " + ", ".join(msg), flush=True)
    return mags


def run_stream(fa, q, k, v, gate2, video_start, q_offset, do, lse, delta):
    dq, dg2 = fa.flash_streaming_dq(q, k, v, gate2, video_start, MAX_FEATS,
                                    do, lse, delta, q_offset)
    dk, dv = fa.flash_streaming_dkv(q, k, v, gate2, video_start, MAX_FEATS,
                                    do, lse, delta, q_offset)
    return dq, dg2, dk, dv


def check_stream(torch, fa):
    """K5, K6a and K6b against their plain versions at STREAM_CASES, and
    the first case as SHARDS q shards (see the bounds at STREAM_CASES).
    Returns the worst |kernel - plain| of each."""
    worst = {"k5": 0.0, "k6a": 0.0, "k6b": 0.0}
    for i, (b, s_q, s_k, h, q_offset, vs, bwd) in enumerate(STREAM_CASES):
        q, k, v, do, gate2, video_start = stream_inputs(torch, b, s_q, s_k,
                                                        h, vs, 500 + i)
        out, lse = fa.flash_streaming_fwd(q, k, v, gate2, video_start,
                                          MAX_FEATS, q_offset)
        torch.cuda.synchronize()
        where = f"{(b, s_q, h, 128)} S_k {s_k} q_offset {q_offset}"
        err, ratio, lse_ratio = hold_k5(torch, fa, q, k, v, gate2,
                                        video_start, q_offset, out, lse)
        worst["k5"] = max(worst["k5"], err)
        print(f"K5 {where} vs={vs}: max|out-plain|={err:.6g} ({ratio:.3f} "
              f"of the bound), lse {lse_ratio:.3f} of its bound", flush=True)
        if ratio > 1.0 or lse_ratio > 1.0:
            raise AssertionError(f"K5 disagrees with its plain version or "
                                 f"float64 at {where}")
        if not bwd:
            continue
        delta = fa.stream_delta(do, out)
        got = run_stream(fa, q, k, v, gate2, video_start, q_offset, do, lse,
                         delta)
        torch.cuda.synchronize()
        mags = hold_k6(torch, fa, q, k, v, gate2, video_start, q_offset, do,
                       lse, delta, got, worst, where)
        if i == 0:
            check_shards(torch, fa, (q, k, v, do, gate2, video_start), out,
                         lse, delta, got, mags, worst)
        del mags
    return worst


def check_shards(torch, fa, inputs, out, lse, delta, full, full_mags,
                 worst):
    """SHARDS q shards of the full run against full K/V, each with its rows
    of D: every shard's K5 and K6 against their plain versions; out, lse,
    dq bit for bit the full run's rows; the dk, dv, dgate2 partials summed
    against the full K6 (the bounds at STREAM_CASES)."""
    q, k, v, do, gate2, video_start = inputs
    s = q.shape[1]
    n = s // SHARDS
    sums = {"dk": 0.0, "dv": 0.0, "dgate2": 0.0}
    mags = {"dk": 0.0, "dv": 0.0}
    for i in range(SHARDS):
        sl = slice(i * n, (i + 1) * n)
        q_i, do_i, off = q[:, sl], do[:, sl], i * n
        o_i, lse_i = fa.flash_streaming_fwd(q_i, k, v, gate2, video_start,
                                            MAX_FEATS, off)
        d_i = delta[:, :, sl].contiguous()
        got = run_stream(fa, q_i, k, v, gate2, video_start, off, do_i, lse_i,
                         d_i)
        torch.cuda.synchronize()
        same = (torch.equal(o_i, out[:, sl])
                and torch.equal(lse_i, lse[:, :, sl])
                and torch.equal(got[0], full[0][:, sl]))
        where = f"shard {i} (q rows {off}..{off + n - 1} of {s})"
        err, ratio, lse_ratio = hold_k5(torch, fa, q_i, k, v, gate2,
                                        video_start, off, o_i, lse_i)
        worst["k5"] = max(worst["k5"], err)
        print(f"K5 {where}: max|out-plain|={err:.6g} ({ratio:.3f} of the "
              f"bound), lse {lse_ratio:.3f}; out, lse, dq equal the full "
              f"run's rows: {same}", flush=True)
        if ratio > 1.0 or lse_ratio > 1.0 or not same:
            raise AssertionError(f"K5/K6a off at {where}")
        hold_k6(torch, fa, q_i, k, v, gate2, video_start, off, do_i, lse_i,
                d_i, got, worst, where)
        for name, x in zip(("dgate2", "dk", "dv"), got[1:]):
            sums[name] = sums[name] + x.double()
            if name in mags:
                mags[name] = mags[name] + x.double().abs()
    msg = []
    for name, r in (("dk", full[2]), ("dv", full[3])):
        bound = (2.0 ** -8 * (mags[name] + r.double().abs())
                 + 2 * s * 2.0 ** -24 * full_mags[name] + STREAM_FLOOR)
        ratio = float(((sums[name] - r.double()).abs() / bound).max())
        msg.append(f"{name} {ratio:.3f}")
        if ratio > 1.0:
            raise AssertionError(f"the shards' {name} partials do not sum to "
                                 f"the full K6b: {ratio:.3f} of the bound")
    g_ratio = float(((sums["dgate2"] - full[1].double()).abs()
                     / (2.0 ** -16 * full_mags["dgate2"]
                        + STREAM_FLOOR)).max())
    print(f"{SHARDS} shards summed against the full backward, of the "
          f"bounds: " + ", ".join(msg) + f", dgate2 {g_ratio:.3f}",
          flush=True)
    if g_ratio > 1.0:
        raise AssertionError("the shards' dgate2 partials do not sum to the "
                             f"full K6a: {g_ratio:.3f} of the bound")


def check_stream_grads(torch, fa):
    """The streaming regime of the autograd.Function (K5 forward, K6a + K6b
    backward from the saved text and lse) at STREAM_GRAD_SHAPE: all seven
    grads against autograd through the plain formulation (GRAD_REL), one
    launch of each streaming kernel and none of K1 or K2."""
    from flipped_tpu_torch.model.attention import adapter_gated_attention

    b, s, h, dh = STREAM_GRAD_SHAPE
    g = torch.Generator(device="cuda").manual_seed(9)
    mk = lambda *shape: torch.randn(*shape, device="cuda", generator=g)
    leaves = [mk(b, s, h, dh).to(torch.bfloat16) for _ in range(3)] \
        + [mk(ADAPTER_LEN, h, dh).to(torch.bfloat16) for _ in range(2)] \
        + [mk(h) * 0.5, mk(h) - 3.0]
    w = mk(b, s, h * dh).to(torch.bfloat16)
    vs = torch.tensor((11,), dtype=torch.int32, device="cuda")
    names = ("k1", "k2", "k5", "k6a", "k6b")
    before = {n: f.launches for n, f in attention_counters(fa).items()}
    grads = {}
    for name, fn in (("kernels", fa.flash_adapter_attention),
                     ("plain", adapter_gated_attention)):
        xs = [x.detach().requires_grad_() for x in leaves]
        out = fn(*xs, vs, MAX_FEATS)
        grads[name] = torch.autograd.grad(out, xs, w)
        del out, xs
    torch.cuda.synchronize()
    moved = {n: f.launches - before[n]
             for n, f in attention_counters(fa).items()}
    if moved != {"k1": 0, "k2": 0, "k5": 1, "k6a": 1, "k6b": 1}:
        raise AssertionError(f"streaming regime launches {moved}")
    msg = []
    for name, a, r in zip(("dq", "dk", "dv", "dak", "dav", "dgate1",
                           "dgate2"), grads["kernels"], grads["plain"]):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name} through the kernels is not finite")
        rel = float((a.double() - r.double()).norm() / r.double().norm())
        msg.append(f"{name} {rel:.3g}")
        if rel > GRAD_REL:
            raise AssertionError(f"{name}: relative error {rel} > {GRAD_REL}")
    print(f"attention grads, streaming regime {STREAM_GRAD_SHAPE} (launches "
          f"{ {n: moved[n] for n in names} }), relative Frobenius error of "
          f"kernels vs plain autograd: " + ", ".join(msg), flush=True)


def k6a_bound(b, s, h, dh):
    """q, k, v, dO read, lse and D read (f32), dq written; QK^T, dO V^T and
    dS K over the causal pairs."""
    nbytes = 5 * b * s * h * dh * 2 + 2 * b * h * s * 4
    return bound_ms(nbytes, 3 * 2 * dh * causal_pairs(s) * b * h)


def k6b_bound(b, s, h, dh):
    """q, k, v, dO read, lse and D read (f32), dk and dv written; QK^T,
    dO V^T, P^T dO and dS^T Q over the causal pairs."""
    nbytes = 6 * b * s * h * dh * 2 + 2 * b * h * s * 4
    return bound_ms(nbytes, 4 * 2 * dh * causal_pairs(s) * b * h)


def sdpa_times(torch, q, k, v, do, mask):
    """Device ms of `scaled_dot_product_attention` on q, k, v (B, S, H, Dh)
    with cotangent do: "mask" with the gate2 + causal bias as the bf16
    (B, H, S, S) `mask`, "causal" with is_causal=True and no mask (no gate2
    bias: not the same function, an aside); each as "fwd" the forward,
    "fwd_bwd" the forward and backward, and "bwd" the backward alone on one
    saved forward, as the kernels K2 and K6 take the forward's out and lse
    (`torch.autograd.grad` with retain_graph; the forward runs once, outside
    the timing, on the stream that the graph captures)."""
    import torch.nn.functional as F

    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    dot = do.transpose(1, 2)

    def sdpa(**kw):
        return F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in xs), **kw)

    def backward(**kw):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            out = sdpa(**kw)
        ms = device_ms(torch, lambda: torch.autograd.grad(
            out, xs, dot, retain_graph=True), stream=stream)
        torch.cuda.current_stream().wait_stream(stream)
        return ms

    times = {}
    for key, kw in (("mask", {"attn_mask": mask}),
                    ("causal", {"is_causal": True})):
        times[key] = {
            "fwd": device_ms(torch, lambda: sdpa(**kw)),
            "fwd_bwd": device_ms(torch, lambda: torch.autograd.grad(
                sdpa(**kw), xs, dot)),
            "bwd": backward(**kw)}
    return times


def time_stream(torch, fa):
    """K5, K6a and K6b at the long training shape (LONG_SHAPE): kernel and
    plain version (`timed`, the plain versions with few calls: each takes
    tens of ms), the bound, and the library yardstick
    `scaled_dot_product_attention` with the gate2 + causal bias as a bf16
    (B, H, S, S) mask (`sdpa_mask`): forward for K5; its backward alone for
    K6a and K6b, which take the forward's lse and D as inputs as K6 does
    (one call computes both passes' grads; `torch.autograd.grad` with
    retain_graph on one saved forward), with forward and backward beside
    it. As an aside, SDPA with is_causal=True and no mask (no gate2 bias:
    not the same function) shows what the mask costs it (`sdpa_times`)."""
    b, s, h, dh = LONG_SHAPE
    q, k, v, do, gate2, vs = stream_inputs(torch, b, s, s, h, LONG_VS, 600)
    out, lse = fa.flash_streaming_fwd(q, k, v, gate2, vs, MAX_FEATS)
    delta = fa.stream_delta(do, out)
    args = (q, k, v, gate2, vs, MAX_FEATS)
    few = dict(n=2, reps=2, host_n=2)
    times = {
        "k5": timed(torch, lambda: fa.flash_streaming_fwd(*args),
                    lambda: fa.flash_streaming_fwd_ref(*args), **few),
        "k6a": timed(torch, lambda: fa.flash_streaming_dq(
                         *args, do, lse, delta),
                     lambda: fa.flash_streaming_dq_ref(*args, do, lse, delta),
                     **few),
        "k6b": timed(torch, lambda: fa.flash_streaming_dkv(
                         *args, do, lse, delta),
                     lambda: fa.flash_streaming_dkv_ref(*args, do, lse, delta),
                     **few)}
    sdpa = sdpa_times(torch, q, k, v, do, sdpa_mask(torch, gate2, vs, s))
    fwd, fwd_bwd, bwd = (sdpa["mask"][x] for x in ("fwd", "fwd_bwd", "bwd"))
    causal_fwd, causal_fwd_bwd, causal_bwd = (
        sdpa["causal"][x] for x in ("fwd", "fwd_bwd", "bwd"))
    # K5 moves K1's bytes and does K1's products
    for key, bound, lib in (("k5", k1_bound, fwd),
                            ("k6a", k6a_bound, bwd),
                            ("k6b", k6b_bound, bwd)):
        t = times[key]
        t["library_ms"] = lib
        t["bound_ms"], t["bound_by"] = bound(b, s, h, dh)
        what = ("forward" if key == "k5" else
                f"backward alone (forward+backward {fwd_bwd:.5f} ms)")
        print(f"{key.upper()} timing {LONG_SHAPE}: device kernel "
              f"{t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, sdpa "
              f"{what} with the bias mask {lib:.5f} ms, bound "
              f"{t['bound_ms']:.5f} ms ({t['bound_by']}); runs {t['runs']}; "
              f"host per eager call: kernel {t['host_us']:.1f} us, plain "
              f"{t['plain_host_us']:.1f} us", flush=True)
    print(f"sdpa at {LONG_SHAPE} without the mask (is_causal=True, no gate2 "
          f"bias): forward {causal_fwd:.5f} ms, backward alone "
          f"{causal_bwd:.5f} ms, forward+backward {causal_fwd_bwd:.5f} ms; "
          f"the mask costs it {fwd - causal_fwd:.5f}, {bwd - causal_bwd:.5f} "
          f"and {fwd_bwd - causal_fwd_bwd:.5f} ms", flush=True)
    print(f"K6a + K6b {times['k6a']['ms'] + times['k6b']['ms']:.5f} ms "
          f"against sdpa's backward alone: {bwd:.5f} ms with the bias mask, "
          f"{causal_bwd:.5f} ms without", flush=True)
    return times


def timed(torch, kern, plain, n=20, reps=5, host_n=30):
    """Host us per eager call of kernel and plain version, then their device
    ms in turns (plain, kernel, kernel, plain). The host times come first:
    after the CUDA graphs of `device_ms` the allocator's pools differ. `n`,
    `reps` and `host_n` apply to the plain version (`device_ms`, `host_us`);
    the kernel always takes the defaults."""
    host = {"host_us": host_us(torch, kern),
            "plain_host_us": host_us(torch, plain, n=host_n)}
    p1, k1, k2, p2 = (device_ms(torch, f, **kw) for f, kw in (
        (plain, dict(n=n, reps=reps)), (kern, {}), (kern, {}),
        (plain, dict(n=n, reps=reps))))
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "runs": (k1, k2, p1, p2), **host}


def time_k1(torch, fa):
    import torch.nn.functional as F

    times = {}
    for name, (b, s, h, dh) in K1_SHAPES.items():
        q, k, v, gate2, vs = k1_inputs(torch, b, s, h, dh,
                                       (TRAIN_VS * 2)[:b], 100)
        t = timed(torch, lambda: fa.flash_text_attention(q, k, v, gate2, vs,
                                                         MAX_FEATS),
                  lambda: fa.flash_text_attention_ref(q, k, v, gate2, vs,
                                                      MAX_FEATS))
        mask = sdpa_mask(torch, gate2, vs, s)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        t["library_ms"] = device_ms(
            torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          attn_mask=mask))
        t["bound_ms"], t["bound_by"] = k1_bound(b, s, h, dh)
        times[name] = t
        print(f"K1 timing {name} {(b, s, h, dh)}: device kernel "
              f"{t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, sdpa "
              f"{t['library_ms']:.5f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}); runs {t['runs']}; host per eager call: "
              f"kernel {t['host_us']:.1f} us, plain "
              f"{t['plain_host_us']:.1f} us", flush=True)
    return times


def time_k2(torch, fa):
    """K2 at the training shape against its plain version, its bound, and
    the library yardstick: SDPA's backward alone on one saved forward with
    the gate2 + causal mask (K2 reads K1's out and lse: it is the backward
    alone), with SDPA's forward + backward beside it and SDPA without the
    mask as an aside (`sdpa_times`)."""
    b, s, h, dh = TRAIN_SHAPE
    q, k, v, gate2, vs, do = k2_inputs(torch, b, s, h, dh, TRAIN_VS, 200)
    out, lse = fa.flash_text_attention(q, k, v, gate2, vs, MAX_FEATS)
    t = timed(torch, lambda: fa.flash_text_attention_bwd(
                  q, k, v, gate2, vs, MAX_FEATS, do, out, lse),
              lambda: fa.flash_text_attention_bwd_ref(
                  q, k, v, gate2, vs, MAX_FEATS, do))
    lib = sdpa_times(torch, q, k, v, do, sdpa_mask(torch, gate2, vs, s))
    t["library_ms"] = lib["mask"]["bwd"]
    t["bound_ms"], t["bound_by"] = k2_bound(b, s, h, dh)
    print(f"K2 timing {TRAIN_SHAPE}: device kernel {t['ms']:.5f} ms, plain "
          f"{t['plain_ms']:.5f} ms, sdpa backward alone with the bias mask "
          f"{t['library_ms']:.5f} ms (forward+backward "
          f"{lib['mask']['fwd_bwd']:.5f} ms), bound {t['bound_ms']:.5f} ms "
          f"({t['bound_by']}); runs {t['runs']}; host per eager call: kernel "
          f"{t['host_us']:.1f} us, plain {t['plain_host_us']:.1f} us",
          flush=True)
    print(f"sdpa at {TRAIN_SHAPE} without the mask (is_causal=True, no gate2 "
          f"bias): backward alone {lib['causal']['bwd']:.5f} ms, "
          f"forward+backward {lib['causal']['fwd_bwd']:.5f} ms", flush=True)
    return t


def quant_inputs(torch, m, k, n, seed):
    """x (M, K) bf16 with one all-zero row and one large column (so group
    scales differ), kq (N, K) int8 codes in [-127, 127], per-channel scale
    (N,) and grouped scale (K/128, N) f32 (None where 128 does not divide
    K), and a cotangent g (M, N) bf16, the weight scales as the synthetic
    model draws them (1/(127 sqrt K)) times U(0.5, 1.5)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, device="cuda", generator=gen)
    x[:, 3] *= 20.0
    x[m // 2] = 0.0
    x = x.to(torch.bfloat16)
    kq = torch.randint(-127, 128, (n, k), device="cuda", generator=gen,
                       dtype=torch.int8)
    base = 1.0 / (127.0 * math.sqrt(k))
    scale = (torch.rand(n, device="cuda", generator=gen) + 0.5) * base
    sg = ((torch.rand(k // 128, n, device="cuda", generator=gen) + 0.5)
          * base if k % 128 == 0 else None)
    g = torch.randn(m, n, device="cuda", generator=gen).to(torch.bfloat16)
    return x, kq, scale, sg, g


def int4_inputs(torch, m, k, n, seed, group=128):
    """x, g as `quant_inputs`; int4 codes (N, K) in [-8, 7] packed to
    kq4 (N/2, K), and the int4 scales (K / group, N) 1/(7 sqrt K) times
    U(0.5, 1.5)."""
    from flipped_tpu_torch.model.int4 import pack_int4

    x, _, _, _, g = quant_inputs(torch, m, k, n, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    codes = torch.randint(-8, 8, (n, k), device="cuda", generator=gen,
                          dtype=torch.int8)
    sg = ((torch.rand(k // group, n, device="cuda", generator=gen) + 0.5)
          / (7.0 * math.sqrt(k)))
    return x, pack_int4(codes), sg, g


def unequal(torch, out, ref):
    """Elements whose bf16 bit patterns differ (+0 and -0 counted equal)."""
    bits = lambda t: torch.where(t == 0, torch.zeros_like(t), t).view(
        torch.int16)
    return int((bits(out) != bits(ref)).sum())


def bound_ratio(torch, out, ref, bound):
    """max |kernel - plain| / bound (0/0 counting 0), max |kernel - plain|."""
    err = (out.double() - ref.double()).abs()
    ratio = float(torch.where(bound > 0, err / bound,
                              torch.where(err > 0, math.inf, 0.0)).max())
    return ratio, float(err.max())


def k4_ratio(torch, qm, dx, ref, g, kq, sg):
    """max |kernel - plain| / bound (K4_REL), and max |kernel - plain|."""
    n = kq.shape[0]
    w = qm.dequant(kq, sg, torch.bfloat16).double()
    bound = K4_REL * ref.double().abs() \
        + n * 2.0 ** -24 * (g.double().abs() @ w.abs())
    return bound_ratio(torch, dx, ref, bound)


def mma_ratio(torch, qm, kern, out, ref, a, kq4, sg):
    """K8 weight-only ("k8w") or K9 against its plain version: max
    |kernel - plain| / the bound stated at K8_WO_REL, and max |d|."""
    codes = qm.unpack_int4(kq4)
    n, k = codes.shape
    if kern == "k8w":
        groups = sg.shape[0]
        w = (codes.double().view(n, groups, k // groups)
             * sg.t().double()[:, :, None]).view(n, k)
        mag = a.reshape(-1, k).double().abs() @ w.abs().t()
        terms = k + 2 * groups
    else:
        w = qm.dequant(codes, sg, torch.bfloat16).double()
        mag = a.reshape(-1, n).double().abs() @ w.abs()
        terms = n
    bound = (K8_WO_REL * ref.double().abs().reshape(mag.shape)
             + terms * 2.0 ** -24 * mag) * (1 + 2.0 ** -8)
    return bound_ratio(torch, out.reshape(mag.shape), ref.reshape(mag.shape),
                       bound)


def quant_call(qm, kern, plain):
    """The wrapper (or its plain version) of a quant kernel as a function of
    (activation, weight, scale, extra): extra is K10's s_mod."""
    return {
        "k3": lambda a, w, s, e: (qm.int8_fwd_ref if plain else qm.int8_fwd)(
            a, w, s),
        "k7": lambda a, w, s, e: (qm.grouped_matmul_ref if plain
                                  else qm.grouped_matmul)(a, w, s),
        "k4": lambda a, w, s, e: (qm.quant_dx_ref if plain
                                  else qm.quant_dx)(a, w, s),
        "k8a": lambda a, w, s, e: (qm.int4_matmul_ref if plain
                                   else qm.int4_matmul)(a, w, s, True),
        "k8w": lambda a, w, s, e: (qm.int4_matmul_ref if plain
                                   else qm.int4_matmul)(a, w, s, False),
        "k9": lambda a, w, s, e: (qm.int4_dx_ref if plain
                                  else qm.int4_dx)(a, w, s),
        "k10": lambda a, w, s, e: (qm.int8_dgrad_ref if plain
                                   else qm.int8_dgrad)(a, w, s, e),
    }[kern]


def hold_quant(torch, qm, kern, a, kq, scale, worst, extra=None):
    """One kernel call against its plain version on the same inputs (a is x,
    or g for K4, K9 and K10; kq is kq4 for K8 and K9): K3, K7, K8 w4a8 and
    K10 bitwise, K4, K8 weight-only and K9 within their bounds. Updates
    worst[kern] with |kernel - plain| and returns a line for the log."""
    out = quant_call(qm, kern, False)(a, kq, scale, extra)
    torch.cuda.synchronize()
    ref = quant_call(qm, kern, True)(a, kq, scale, extra)
    n, k = kq.shape               # kq (N, K), or kq4 (N/2, K)
    if kern in ("k8a", "k8w", "k9"):
        n *= 2
    where = (f"(M {a.numel() // a.shape[-1]}, K {k}, N {n}"
             + (f", s_mod {extra})" if extra is not None else ")"))
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{kern} non-finite at {where}")
    err = float((out.double() - ref.double()).abs().max())
    worst[kern] = max(worst[kern], err)
    label = kern.upper()
    if kern in ("k4", "k8w", "k9"):
        ratio, _ = (k4_ratio(torch, qm, out, ref, a, kq, scale)
                    if kern == "k4" else
                    mma_ratio(torch, qm, kern, out, ref, a, kq, scale))
        if ratio > 1.0:
            raise AssertionError(f"{label} off its plain version at {where}: "
                                 f"{ratio:.3f} of the bound")
        return f"{label} max|d|={err:.4g} ({ratio:.3f} of bound)"
    bad = unequal(torch, out, ref)
    if bad:
        raise AssertionError(f"{label} differs from its plain version "
                             f"at {where} in {bad} elements (max |d| "
                             f"{err:.4g})")
    return f"{label} unequal {bad} of {out.numel()}"


def check_quant(torch, qm, worst):
    """K3, K7, K8 w4a8 and K10 bitwise against their plain versions, K4, K8
    weight-only and K9 within their bounds, at the unit, the tile-edge and
    the 7B training shapes, on `quant_inputs` / `int4_inputs`; K10 on a 2-D cotangent and on
    the same rows as (2, M/2, N) where M is even (the dither's row period
    M/2)."""
    cases = ([(f"unit {s}", s) for s in QUANT_UNIT]
             + [(f"edge {s}", s) for s in QUANT_EDGE]
             + list(QUANT_MAIN.items()))
    for i, (name, (m, k, n)) in enumerate(cases):
        x, kq, scale, sg, g = quant_inputs(torch, m, k, n, 300 + i)
        msg = [hold_quant(torch, qm, "k3", x, kq, scale, worst)]
        if sg is not None:
            msg += [hold_quant(torch, qm, "k7", x, kq, sg, worst),
                    hold_quant(torch, qm, "k4", g, kq, sg, worst)]
        if k % 128 == 0 and n % 16 == 0:
            x4, kq4, sg4, g4 = int4_inputs(torch, m, k, n, 320 + i)
            msg += [hold_quant(torch, qm, kern, a, kq4, sg4, worst)
                    for kern, a in (("k8a", x4), ("k8w", x4), ("k9", g4))]
        if n % 16 == 0 and k % 16 == 0:
            msg.append(hold_quant(torch, qm, "k10", g, kq, scale, worst, m))
            if m % 2 == 0:
                msg.append(hold_quant(torch, qm, "k10",
                                      g.view(2, m // 2, n), kq, scale,
                                      worst, m // 2))
        print(f"quant {name} (M {m}, K {k}, N {n}): " + ", ".join(msg),
              flush=True)
    def one_row(x, seed):
        """quant_inputs zeroes row m // 2: for M 1 the only one"""
        if x.shape[0] > 1:
            return x
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(1, x.shape[1], device="cuda", generator=gen).to(
            torch.bfloat16)

    for i, (m, k, n) in enumerate(K3_EDGE):
        x, kq, scale, _, _ = quant_inputs(torch, m, k, n, 380 + i)
        print(f"quant K3 edge (M {m}, K {k}, N {n}): "
              + hold_quant(torch, qm, "k3", one_row(x, 390 + i), kq, scale,
                           worst), flush=True)
    for i, (m, k, n) in enumerate(K7_EDGE):
        x, kq, _, sg, _ = quant_inputs(torch, m, k, n, 420 + i)
        print(f"quant K7 edge (M {m}, K {k}, N {n}): "
              + hold_quant(torch, qm, "k7", one_row(x, 430 + i), kq, sg,
                           worst), flush=True)
    for i, (m, k, n, group) in enumerate(K8A_EDGE):
        x, kq4, sg, _ = int4_inputs(torch, m, k, n, 440 + i, group)
        print(f"quant K8 w4a8 edge (M {m}, K {k}, N {n}, group {group}): "
              + hold_quant(torch, qm, "k8a", one_row(x, 450 + i), kq4, sg,
                           worst), flush=True)


@contextlib.contextmanager
def catch_quant_inputs(caught):
    """While a main path runs, keep the first inputs of each distinct
    (M, K, N) that it hands each quant kernel (by the names model/int8.py
    and model/int4.py call the wrappers by) in caught[kernel][(M, K, N)] =
    [inputs, calls], so that each kernel is held against its plain version
    afterwards at the path's own shapes and values (`check_caught`). The
    kernels launch as before."""
    from flipped_tpu_torch.model import int4 as q4
    from flipped_tpu_torch.model import int8 as q8

    patched = {(q8, "int8_fwd"): lambda a, w, s: ("k3", None),
               (q8, "grouped_matmul"): lambda a, w, s: ("k7", None),
               (q8, "quant_dx"): lambda a, w, s: ("k4", None),
               (q8, "int8_dgrad"): lambda a, w, s, e: ("k10", e),
               (q4, "int4_kernel"): lambda a, w, s, e: ("k8a" if e else "k8w",
                                                       None),
               (q4, "int4_dx"): lambda a, w, s: ("k9", None)}
    orig = {key: getattr(*key) for key in patched}

    def catching(key):
        def call(a, w, s, *extra):
            kern, e = patched[key](a, w, s, *extra)
            n, k = w.shape
            if kern in ("k8a", "k8w", "k9"):
                n *= 2
            shape = (a.numel() // a.shape[-1], k, n)
            if shape not in caught[kern]:
                # kept in host memory: the paths' peak device memory and
                # the weights they free stay as they were
                caught[kern][shape] = [tuple(t.detach().to("cpu", copy=True)
                                             for t in (a, w, s)) + (e,), 0]
            caught[kern][shape][1] += 1
            return orig[key](a, w, s, *extra)
        return call
    for key in patched:
        setattr(*key, catching(key))
    try:
        yield
    finally:
        for key in patched:
            setattr(*key, orig[key])


def check_caught(torch, qm, caught, worst, kernels):
    """Every (M, K, N) the main paths handed a quant kernel, on the first
    inputs the path gave it at that shape: K3, K7, K8 w4a8 and K10 bitwise,
    K4, K8 weight-only and K9 within their bounds. Each of `kernels` must
    have been handed something."""
    for kern, shapes in caught.items():
        for (m, k, n), (inputs, calls) in sorted(shapes.items()):
            *tensors, extra = inputs
            line = hold_quant(torch, qm, kern,
                              *(t.to("cuda") for t in tensors), worst, extra)
            print(f"{kern.upper()} at a main path's (M {m}, K {k}, N {n}), "
                  f"{calls} calls: {line}", flush=True)
    if not all(caught[k] for k in kernels):
        raise AssertionError(f"a main path left a quant kernel uncalled: "
                             f"{ {k: len(v) for k, v in caught.items()} }")


def check_quant_autograd(torch, qm, q8):
    """At the w1/w3 shape, through the autograd Functions: Int8Matmul (K3
    forward, the exact bf16 dx) and Int8MatmulGrouped (K7 forward, K4
    backward), against the plain versions."""
    m, k, n = QUANT_MAIN["w1/w3"]
    x, kq, scale, sg, g = quant_inputs(torch, m, k, n, 350)
    before = (qm.int8_fwd.launches, qm.grouped_matmul.launches,
              qm.quant_dx.launches)
    xa, xb = (x.detach().requires_grad_() for _ in range(2))
    ya = q8.int8_matmul(xa, kq, scale)
    ya.backward(g)
    yb = q8.int8_matmul_grouped(xb, kq, sg)
    yb.backward(g)
    torch.cuda.synchronize()
    after = (qm.int8_fwd.launches, qm.grouped_matmul.launches,
             qm.quant_dx.launches)
    if tuple(a - b for a, b in zip(after, before)) != (1, 1, 1):
        raise AssertionError(f"autograd launches {before} -> {after}")
    w = qm.dequant(kq, scale, torch.bfloat16)
    bad_a = unequal(torch, ya, qm.int8_fwd_ref(x, kq, scale)) \
        + unequal(torch, xa.grad, g @ w)
    bad_b = unequal(torch, yb, qm.grouped_matmul_ref(x, kq, sg))
    ratio, err = k4_ratio(torch, qm, xb.grad, qm.quant_dx_ref(g, kq, sg), g,
                          kq, sg)
    print(f"autograd (M {m}, K {k}, N {n}): int8_matmul out and dx unequal "
          f"{bad_a}; int8_matmul_grouped out unequal {bad_b}, dx (K4) max|d|"
          f"={err:.4g} ({ratio:.3f} of bound)", flush=True)
    if bad_a or bad_b or ratio > 1.0:
        raise AssertionError("the autograd Functions disagree with the plain "
                             "versions")


def check_int4_dgrad_autograd(torch, qm, q4, q8):
    """At the w1/w3 shape, through the autograd Functions: Int4Matmul (K8
    weight-only forward, K9 backward), Int4MatmulGrouped (K8 w4a8, K9) and
    Int8MatmulDgrad (K3, K10) on a (3B, S, K) input, as the stacked encode
    hands them, against the plain versions: K8 w4a8, K3 and K10 bitwise,
    K8 weight-only and K9 within their bounds."""
    m, k, n = QUANT_MAIN["w1/w3"]
    x, kq4, sg, g = int4_inputs(torch, m, k, n, 360)
    _, kq, scale, _, _ = quant_inputs(torch, m, k, n, 361)
    shape = (3 * TRAIN_B, TRAIN_S)
    before = read_counts_quant(qm)
    xa, xb, xc = (x.view(*shape, k).detach().requires_grad_()
                  for _ in range(3))
    ya = q4.int4_matmul(xa, kq4, sg)
    ya.backward(g.view(*shape, n))
    yb = q4.int4_matmul_grouped(xb, kq4, sg)
    yb.backward(g.view(*shape, n))
    yc = q8.int8_matmul_dgrad(xc, kq, scale)
    yc.backward(g.view(*shape, n))
    torch.cuda.synchronize()
    moved = {kern: c - before[kern]
             for kern, c in read_counts_quant(qm).items()}
    if moved != {"k3": 1, "k8": 2, "k9": 2, "k10": 1}:
        raise AssertionError(f"autograd launches {moved}")
    bad = (unequal(torch, yb.view(m, n), qm.int4_matmul_ref(x, kq4, sg, True))
           + unequal(torch, yc.view(m, n), qm.int8_fwd_ref(x, kq, scale))
           + unequal(torch, xc.grad, qm.int8_dgrad_ref(
               g.view(*shape, n), kq, scale, TRAIN_S)))
    ra, _ = mma_ratio(torch, qm, "k8w", ya, qm.int4_matmul_ref(
        x, kq4, sg, False), x, kq4, sg)
    dx9 = qm.int4_dx_ref(g, kq4, sg)
    r9 = max(mma_ratio(torch, qm, "k9", d, dx9, g, kq4, sg)[0]
             for d in (xa.grad, xb.grad))
    print(f"autograd (M {m}, K {k}, N {n}) as {shape}: int4_matmul_grouped "
          f"out, int8_matmul_dgrad out and dx (K10) unequal {bad}; "
          f"int4_matmul out {ra:.3f} of bound, both dx (K9) {r9:.3f} of "
          f"bound", flush=True)
    if bad or ra > 1.0 or r9 > 1.0:
        raise AssertionError("the int4 / dgrad autograd Functions disagree "
                             "with the plain versions")


def read_counts_quant(qm):
    return {"k3": qm.int8_fwd.launches, "k8": qm.int4_matmul.launches,
            "k9": qm.int4_dx.launches, "k10": qm.int8_dgrad.launches}


def quant_bound(m, k, n, scale_floats, dx=False, weight_bytes=None,
                bf16=None):
    """x (M, K) or, for dx, g (M, N) read, the weight read once (kq, N K
    bytes, or kq4, N K / 2), the scales read, the output written; 2 M K N
    products at the int8 peak, or for dx (and K8's weight-only branch,
    bf16=True) at the bf16 peak. The quantize pass's write and read of its
    codes is the kernels' own traffic, not the function's."""
    act = m * n + m * k
    peak = BF16_FLOP_PER_S if (dx if bf16 is None else bf16) \
        else INT8_OP_PER_S
    wb = n * k if weight_bytes is None else weight_bytes
    return bound_ms(2 * act + wb + 4 * scale_floats, 2.0 * m * k * n, peak)


def time_k3(torch, qm, m, k, n):
    """K3 and its plain version (`timed`), its bound, and its yardsticks:
    `torch._int_mm` on operands quantized beforehand (the int8 GEMM alone:
    no quantize pass, no scales, int32 out), with B the (N, K) weight as
    stored, i.e. column-major (K, N), the layout cuBLASLt's int8 path
    takes without a copy — and, as an aside, on a row-major copy of it —
    and a bf16 `F.linear` on the dequantized weight (no int8 at all)."""
    import torch.nn.functional as F

    x, kq, scale, _, _ = quant_inputs(torch, m, k, n, 400)
    t = timed(torch, lambda: qm.int8_fwd(x, kq, scale),
              lambda: qm.int8_fwd_ref(x, kq, scale))
    xq = qm.quantize_act(x)[0].to(torch.int8)
    kq_t, kq_kn = kq.t(), kq.t().contiguous()
    t["library_ms"] = device_ms(torch, lambda: torch._int_mm(xq, kq_t))
    t["int_mm_row_major_ms"] = device_ms(torch,
                                         lambda: torch._int_mm(xq, kq_kn))
    w = qm.dequant(kq, scale, torch.bfloat16)
    t["linear_ms"] = device_ms(torch, lambda: F.linear(x, w))
    t["bound_ms"], t["bound_by"] = quant_bound(m, k, n, n)
    return t


def time_k8a(torch, qm, m, k, n):
    """K8's w4a8 branch and its plain version (`timed`) and its bound; no
    library yardstick (no PyTorch call computes a grouped-scale int4
    product)."""
    x, kq4, sg, _ = int4_inputs(torch, m, k, n, 410)
    t = timed(torch, lambda: qm.int4_matmul(x, kq4, sg, True),
              lambda: qm.int4_matmul_ref(x, kq4, sg, True))
    t["library_ms"] = None
    t["bound_ms"], t["bound_by"] = quant_bound(m, k, n, sg.numel(),
                                               weight_bytes=n * k // 2)
    return t


def time_int4_dgrad(torch, qm, m, k, n):
    """K8 (both branches), K9 and K10 at one shape: kernel and plain version
    (`timed`), the bound, and the library yardsticks: for K8 weight-only a
    bf16 `F.linear` and for K9 a cuBLAS bf16 product on the weight
    dequantized beforehand; for K10 `torch._int_mm` on codes quantized
    beforehand (the int8 GEMM alone, int32 out) with B a column-major copy
    of kq made beforehand (the layout cuBLASLt's int8 path takes), and as an
    aside with B the (N, K) kq as stored (row-major); for K8 w4a8 none (no
    PyTorch call computes a grouped-scale int4 product)."""
    import torch.nn.functional as F

    x, kq4, sg, g = int4_inputs(torch, m, k, n, 410)
    _, kq, scale, _, _ = quant_inputs(torch, m, k, n, 400)
    wd = qm.dequant(qm.unpack_int4(kq4), sg, torch.bfloat16)
    int4_bytes = dict(weight_bytes=n * k // 2)
    t8a = time_k8a(torch, qm, m, k, n)
    t8w = timed(torch, lambda: qm.int4_matmul(x, kq4, sg, False),
                lambda: qm.int4_matmul_ref(x, kq4, sg, False))
    t8w["library_ms"] = device_ms(torch, lambda: F.linear(x, wd))
    t8w["bound_ms"], t8w["bound_by"] = quant_bound(
        m, k, n, sg.numel(), bf16=True, **int4_bytes)
    t9 = timed(torch, lambda: qm.int4_dx(g, kq4, sg),
               lambda: qm.int4_dx_ref(g, kq4, sg))
    t9["library_ms"] = device_ms(torch, lambda: torch.matmul(g, wd))
    t9["bound_ms"], t9["bound_by"] = quant_bound(m, k, n, sg.numel(),
                                                 dx=True, **int4_bytes)
    t10 = timed(torch, lambda: qm.int8_dgrad(g, kq, scale, TRAIN_S),
                lambda: qm.int8_dgrad_ref(g, kq, scale, TRAIN_S))
    gs = g.float() * scale
    gsc = torch.clamp_min(gs.abs().amax(-1, keepdim=True) * qm.INV127,
                          qm.EPS)
    gq = qm.sr_codes(gs / gsc, TRAIN_S).to(torch.int8)
    kq_cm = kq.t().contiguous().t()
    t10["library_ms"] = device_ms(torch, lambda: torch._int_mm(gq, kq_cm))
    t10["int_mm_row_major_ms"] = device_ms(torch,
                                           lambda: torch._int_mm(gq, kq))
    # the quantize pass's operations are a few per element of g, 1/N of
    # the GEMM's: the GEMM's products bound it
    t10["bound_ms"], t10["bound_by"] = quant_bound(m, k, n, n)
    return {"k8a": t8a, "k8w": t8w, "k9": t9, "k10": t10}


def time_quant(torch, qm):
    """K3, K7, K4, K8 (both branches), K9 and K10 at the three 3072-row
    shapes, and K3 and K8 w4a8 at the eval's w1/w3 shapes: kernel and plain
    version
    (`timed`), the bound, and the library yardsticks: for K3 those of
    `time_k3`; for K4 a cuBLAS bf16 product on the weight dequantized
    beforehand (no dequantize); for K7 none (no PyTorch call computes a
    grouped-scale int8 product); for K8, K9 and K10 those of
    `time_int4_dgrad`."""
    times = {kern: {} for kern in ("k3", "k7", "k4", "k8a", "k8w", "k9",
                                   "k10")}
    for name in ("wq/wk/wv/wo", "w1/w3", "w2", *K3_EVAL):
        m, k, n = QUANT_MAIN.get(name) or K3_EVAL[name]
        rows = [("K3", time_k3(torch, qm, m, k, n))]
        times["k3"][name] = rows[0][1]
        if name not in K3_EVAL:
            x, kq, _, sg, g = quant_inputs(torch, m, k, n, 400)
            t7 = timed(torch, lambda: qm.grouped_matmul(x, kq, sg),
                       lambda: qm.grouped_matmul_ref(x, kq, sg))
            t7["library_ms"] = None
            t7["bound_ms"], t7["bound_by"] = quant_bound(m, k, n, sg.numel())
            t4 = timed(torch, lambda: qm.quant_dx(g, kq, sg),
                       lambda: qm.quant_dx_ref(g, kq, sg))
            wd = qm.dequant(kq, sg, torch.bfloat16)
            t4["library_ms"] = device_ms(torch, lambda: torch.matmul(g, wd))
            t4["bound_ms"], t4["bound_by"] = quant_bound(
                m, k, n, sg.numel(), dx=True)
            rows += [("K7", t7), ("K4", t4)]
            times["k7"][name], times["k4"][name] = t7, t4
            for kern, t in time_int4_dgrad(torch, qm, m, k, n).items():
                rows.append((kern.upper(), t))
                times[kern][name] = t
        else:
            times["k8a"][name] = time_k8a(torch, qm, m, k, n)
            rows.append(("K8A", times["k8a"][name]))
        for kern, t in rows:
            print_quant_time(kern, name, m, k, n, t)
    for name, (m, k, n) in DECODE_SHAPES.items():
        for kern, t in time_decode_shape(torch, qm, m, k, n).items():
            times[kern][name] = t
            print_quant_time(kern.upper(), name, m, k, n, t)
    return times


def print_quant_time(kern, name, m, k, n, t):
    lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.5f} ms"
    extra = (f" (row-major B {t['int_mm_row_major_ms']:.5f} ms)"
             if "int_mm_row_major_ms" in t else "")
    extra += (f", bf16 F.linear {t['linear_ms']:.5f} ms"
              if "linear_ms" in t else "")
    print(f"{kern} timing {name} (M {m}, K {k}, N {n}): device kernel "
          f"{t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, library "
          f"{lib}{extra}, bound {t['bound_ms']:.5f} ms "
          f"({t['bound_by']}); runs {t['runs']}; host per eager "
          f"call: kernel {t['host_us']:.1f} us, plain "
          f"{t['plain_host_us']:.1f} us", flush=True)


def time_decode_shape(torch, qm, m, k, n):
    """K3, K7 and K8's two branches at one decode shape (M = the batch's
    rows): kernel and plain version (`timed`), the bound (at M 32 the
    weight's bytes), and as the library yardstick a bf16 `F.linear` on the
    weight dequantized beforehand; K3 also `torch._int_mm` (`time_k3`)."""
    import torch.nn.functional as F

    t3 = time_k3(torch, qm, m, k, n)
    x, kq, _, sg, _ = quant_inputs(torch, m, k, n, 400)
    t7 = timed(torch, lambda: qm.grouped_matmul(x, kq, sg),
               lambda: qm.grouped_matmul_ref(x, kq, sg))
    w7 = qm.dequant(kq, sg, torch.bfloat16)
    t7["library_ms"] = device_ms(torch, lambda: F.linear(x, w7))
    t7["bound_ms"], t7["bound_by"] = quant_bound(m, k, n, sg.numel())
    x4, kq4, sg4, _ = int4_inputs(torch, m, k, n, 410)
    w4 = qm.dequant(qm.unpack_int4(kq4), sg4, torch.bfloat16)
    t8a = time_k8a(torch, qm, m, k, n)
    t8a["library_ms"] = device_ms(torch, lambda: F.linear(x4, w4))
    t8w = timed(torch, lambda: qm.int4_matmul(x4, kq4, sg4, False),
                lambda: qm.int4_matmul_ref(x4, kq4, sg4, False))
    t8w["library_ms"] = device_ms(torch, lambda: F.linear(x4, w4))
    t8w["bound_ms"], t8w["bound_by"] = quant_bound(
        m, k, n, sg4.numel(), bf16=True, weight_bytes=n * k // 2)
    return {"k3": t3, "k7": t7, "k8a": t8a, "k8w": t8w}


def write_fixtures(root, n):
    import numpy as np

    from flipped_tpu_torch.data.synthetic import make_nextqa

    make_nextqa(root, n, np.random.RandomState(0))


def write_gen_fixtures(root, n):
    import numpy as np

    from flipped_tpu_torch.data.synthetic import make_musicavqa

    make_musicavqa(root, n, np.random.RandomState(0))


def cli_args(data_root, *extra, seq=TRAIN_S, batch=TRAIN_B):
    from flipped_tpu_torch.core.config import get_args_parser

    return get_args_parser().parse_args(
        ["--model", "llama7B", "--dataset", "nextqa", "--data_root",
         data_root, "--max_seq_len", str(seq), "--batch_size",
         str(batch), "--device", "cuda", "--llama_model_path",
         os.path.join(WORK, "no_checkpoint"), *extra])


def attention_counters(fa):
    return {"k1": fa.flash_text_attention, "k2": fa.flash_text_attention_bwd,
            "k5": fa.flash_streaming_fwd, "k6a": fa.flash_streaming_dq,
            "k6b": fa.flash_streaming_dkv}


def counters(fa, qm):
    """Every kernel's wrapper, whose `launches` the main paths are read by."""
    return {**attention_counters(fa),
            "k3": qm.int8_fwd, "k7": qm.grouped_matmul, "k4": qm.quant_dx,
            "k8": qm.int4_matmul, "k9": qm.int4_dx, "k10": qm.int8_dgrad}


def read_counts(fa, qm):
    return {k: f.launches for k, f in counters(fa, qm).items()}


def zero_counts(fa, qm):
    for f in counters(fa, qm).values():
        f.launches = 0


INT4_MODES = ("int4", "w4a8", "int4r", "w4a8r")
PER_CHANNEL_W8A8 = ("w8a8", "w8a8r", "w8a8d", "w8a8rd")


def per_update(quantize, blocks, streaming=False, policy="full"):
    """Launches per training update with remat, from the code: each block's
    forward runs twice (the update's forward and its recompute in the
    backward, per block or per --remat_group) and its backward once. A
    block forward launches one attention forward — K1, or K5 in the
    streaming regime (a differentiated call with S > MAX_SEQ_BWD = 2048),
    which under --remat_policy qkv the recompute takes from the forward
    instead of launching it again (model/llama.py) — and has 9 quantized
    matmuls: wq, wk, wv, wo, w1, w3, w2 on the stacked
    rows and wk, wv on the adapter rows (model/llama.py) — each K3 under the
    per-channel w8a8 modes, whose backward launches K10 once each under
    w8a8d/w8a8rd; K7 under w8a8g/w8a8o, and K8 under the int4 modes, whose
    backward launches K4 or K9 once each. At 7B width every block matmul
    passes K8's shape guard (model/int4.py). The LM head is weight-only (no
    kernel), chunked or not. A block backward runs K2 once, or K6a and K6b
    once each in the streaming regime."""
    fwd = 2 * blocks
    attn = blocks if policy == "qkv" else fwd
    grouped = quantize in ("w8a8g", "w8a8o")
    return {"k1": 0 if streaming else attn,
            "k2": 0 if streaming else blocks,
            "k5": attn if streaming else 0,
            "k6a": blocks if streaming else 0,
            "k6b": blocks if streaming else 0,
            "k3": 9 * fwd if quantize in PER_CHANNEL_W8A8 else 0,
            "k7": 9 * fwd if grouped else 0,
            "k4": 9 * blocks if grouped else 0,
            "k8": 9 * fwd if quantize in INT4_MODES else 0,
            "k9": 9 * blocks if quantize in INT4_MODES else 0,
            "k10": 9 * blocks if quantize in ("w8a8d", "w8a8rd") else 0}


def forward_kernel(quantize):
    """The kernel that carries a mode's block matmuls forward."""
    if quantize == "none":
        return "k1"
    if quantize in PER_CHANNEL_W8A8:
        return "k3"
    return "k8" if quantize in INT4_MODES else "k7"


def watch_train(torch, fa, qm, args, caught, grads_at=0):
    """`cli.train.main(args)` with its build, step and val entry points
    wrapped to watch them: snapshots of the trainables before the first
    update and after each of the first two, the frozen weights at build,
    every update's metrics and seconds, the trainables' gradients of
    update `grads_at` (0: none), the launch counts when the val loop
    starts and its seconds. Counts are zeroed just before main and read
    just after; the quant kernels' inputs go to `caught`. → the watch
    dict, with 'model', 'history', 'seconds', 'launches' and 'peak'."""
    from flipped_tpu_torch.cli import train as train_cli

    watch = {"metrics": [], "snaps": [], "secs": []}
    orig = (train_cli.build_train_state, train_cli.make_train_step,
            train_cli.val_one_epoch)

    def build(*a, **kw):
        model, cfg, tok = orig[0](*a, **kw)
        watch["model"] = model
        watch["frozen0"] = {n: p.detach().clone()
                            for n, p in model.named_parameters()
                            if not p.requires_grad}
        watch["snaps"].append(trainables(model))
        return model, cfg, tok

    def make_step(*a, **kw):
        step = orig[1](*a, **kw)

        def watched(batch):
            t0 = time.perf_counter()
            m = step(batch)
            watch["metrics"].append([float(x) for x in m])   # synchronises
            watch["secs"].append(time.perf_counter() - t0)
            if len(watch["snaps"]) < 3:
                watch["snaps"].append(trainables(watch["model"]))
            if len(watch["metrics"]) == grads_at:
                watch["grads"] = {
                    n: p.grad.detach().clone()
                    for n, p in watch["model"].named_parameters()
                    if p.requires_grad}
            return m
        return watched

    def val(*a, **kw):
        watch["at_val"] = read_counts(fa, qm)
        t0 = time.perf_counter()
        out = orig[2](*a, **kw)
        torch.cuda.synchronize()
        watch["val_secs"] = time.perf_counter() - t0
        return out

    train_cli.build_train_state, train_cli.make_train_step, \
        train_cli.val_one_epoch = build, make_step, val
    try:
        torch.cuda.reset_peak_memory_stats()
        zero_counts(fa, qm)
        t0 = time.perf_counter()
        with catch_quant_inputs(caught):
            watch["model"], watch["history"] = train_cli.main(args)
        torch.cuda.synchronize()
        watch["seconds"] = time.perf_counter() - t0
        watch["launches"] = read_counts(fa, qm)
        watch["peak"] = torch.cuda.max_memory_allocated()
    finally:
        train_cli.build_train_state, train_cli.make_train_step, \
            train_cli.val_one_epoch = orig
    return watch


def check_trainables(torch, watch, still=()):
    """Frozen weights bitwise unchanged; no trainable moved by update 1 (lr
    0); every trainable but those of `still` moved by update 2, when there
    was one (`still`: trainables whose gradient is zero by the model's
    math, which must also stay). → (update 1's, update 2's trainables)."""
    model = watch["model"]
    frozen0 = watch.pop("frozen0")      # 12.6 GiB at 7B: free it here
    for n, p in model.named_parameters():
        if not p.requires_grad and not torch.equal(p, frozen0[n]):
            raise AssertionError(f"frozen weight {n} changed")
    del frozen0
    init, *after = watch["snaps"]
    moved1 = [n for n in init if not torch.equal(init[n], after[0][n])]
    still2 = ([n for n in init if torch.equal(after[0][n], after[1][n])]
              if len(after) > 1 else list(still))
    if moved1 or sorted(still2) != sorted(still):
        raise AssertionError(f"update 1 (lr 0) moved {moved1}; update 2 "
                             f"left {still2} unchanged, want {list(still)}")
    print(f"  frozen weights bitwise unchanged; update 1 moved none of the "
          f"{len(init)} trainables"
          + (f", update 2 moved all of them but {list(still)}"
             if len(after) > 1 else ""), flush=True)
    return init


def print_updates(watch):
    for i, (m, sec) in enumerate(zip(watch["metrics"], watch["secs"])):
        print(f"  update {i + 1}: {sec:.4f} s, loss {m[0]:.6f} (vqa "
              f"{m[1]:.6f}, vaq {m[2]:.6f}, qav {m[3]:.6f}), grad_norm "
              f"{m[4]:.6g}, lr {m[5]:.6g}", flush=True)


def run_train_slice(torch, fa, qm, data_root, caught, quantize="none",
                    debug=False, extra=(), long=False):
    """The train CLI at --quantize `quantize` (--debug: one update and one
    val batch; `extra` more flags; `long`: the long-context path, batch
    LONG_B at S LONG_S, in the streaming regime), watched by `watch_train`;
    the quant kernels' inputs go to `caught`."""
    shape = dict(seq=LONG_S, batch=LONG_B) if long else {}
    args = cli_args(data_root, "--vaq", "--qav", "--epochs", "1",
                    "--output_dir", "", "--quantize", quantize, *extra,
                    *(["--debug"] if debug else []), **shape)
    watch = watch_train(torch, fa, qm, args, caught)
    model, history = watch["model"], watch["history"]
    launches, seconds = watch["launches"], watch["seconds"]
    steps = len(watch["metrics"])
    epoch = watch["at_val"]
    print(f"train --quantize {quantize} {' '.join(extra)} (batch "
          f"{args.batch_size}, S {args.max_seq_len}): main took "
          f"{seconds:.3f} s (7B init and val eval included), {steps} "
          f"updates, launches over the epoch {epoch}, over the whole run "
          f"{launches}; peak allocated "
          f"{watch['peak'] / 2**30:.3f} GiB", flush=True)
    print_updates(watch)
    print(f"  history: {json.dumps(history)}", flush=True)
    want_steps = (1 if debug else N_LONG_ITEMS // LONG_B if long
                  else N_TRAIN_ITEMS // TRAIN_B)
    if steps != want_steps:
        raise AssertionError(f"expected {want_steps} updates, ran {steps}")
    if not all(math.isfinite(x) for m in watch["metrics"] for x in m):
        raise AssertionError("a training metric is not finite")
    blocks = len(model.layers)      # 32 at 7B
    per = per_update(quantize, blocks, streaming=long)
    want = {k: v * steps for k, v in per.items()}
    print(f"  launches per update {per} (from the code), over the epoch "
          f"want {want}", flush=True)
    if epoch != want:
        raise AssertionError(f"launches over the epoch {epoch}, want {want}")
    fwd_kernel = forward_kernel(quantize)
    # the val eval's prefill at S <= MAX_SEQ_FWD takes K1 in both regimes
    if (any(launches[k] != epoch[k]
            for k in ("k2", "k4", "k9", "k10", "k5", "k6a", "k6b"))
            or launches["k1"] <= epoch["k1"]
            or launches[fwd_kernel] <= epoch[fwd_kernel]):
        raise AssertionError("the val eval should launch the forward "
                             "kernels and no backward kernel")
    check_trainables(torch, watch)
    del watch
    return model, args, launches


def trainables(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if p.requires_grad}


def time_train_step(torch, model, args, n=5, remat=False):
    """One update on one training batch, without remat (the bench default)
    or with it, the --lm_head_chunk of `args`: s per step (median of n
    after two warm-up updates), examples per second, peak allocated
    memory."""
    from flipped_tpu_torch.cli.evaluate import batch_to_device
    from flipped_tpu_torch.core.config import run_config_from_args
    from flipped_tpu_torch.data.pipeline import load_data
    from flipped_tpu_torch.text import load_tokenizer
    from flipped_tpu_torch.train.optim import make_optimizer
    from flipped_tpu_torch.train.step import make_train_step

    run_cfg = run_config_from_args(args)
    loader = load_data(run_cfg.data,
                       load_tokenizer("", n_words=model.cfg.vocab_size),
                       "train")
    it = iter(loader)
    batch = batch_to_device(next(it), "cuda")
    it.close()
    model.remat = remat
    batch_size = run_cfg.data.batch_size
    step = make_train_step(model, make_optimizer(model, run_cfg.train, 8,
                                                 batch_size),
                           vaq=True, qav=True,
                           lm_chunk=run_cfg.train.lm_head_chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for i in range(n + 2):
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        if i >= 2:
            secs.append(time.perf_counter() - t0)
        if not math.isfinite(float(m.loss)):
            raise AssertionError("non-finite loss in the timed updates")
    med = sorted(secs)[len(secs) // 2]
    peak = torch.cuda.max_memory_allocated()
    print(f"train step --quantize {args.quantize} "
          f"{'with' if remat else 'without'} remat, batch {batch_size}, S "
          f"{args.max_seq_len}, --lm_head_chunk {args.lm_head_chunk}: "
          f"{med:.5f} s/step (median of {n}: "
          f"{', '.join(f'{x:.5f}' for x in secs)}), {batch_size / med:.3f} "
          f"examples/s, peak allocated {peak / 2**30:.3f} GiB", flush=True)
    return med, peak


def eval_per_batch(quantize, blocks, long=False):
    """Launches per scored batch of the cached scorer, from the code: its
    prefill and its chunk extend each run every block once; K1 runs in the
    prefill only (K5 at S > MAX_SEQ_FWD = 4096: `long`), and each pass has
    9 quantized matmuls per block (K3 under w8a8, K8 under w4a8)."""
    counts = {k: 0 for k in ("k2", "k6a", "k6b", "k3", "k7", "k4", "k8",
                             "k9", "k10")}
    if quantize != "none":
        counts[forward_kernel(quantize)] = 18 * blocks
    return {"k1": 0 if long else blocks, "k5": blocks if long else 0,
            **counts}


def run_eval_slice(torch, fa, qm, data_root, caught, quantize="none",
                   long=False):
    """The eval CLI at --quantize `quantize` (`long`: batch LONG_B at S
    LONG_EVAL_S). Both val batches of the fixture take the cached scorer
    (their answer spans are exact). The quant kernels' inputs go to
    `caught`."""
    from flipped_tpu_torch.cli import evaluate
    from flipped_tpu_torch.core.config import run_config_from_args
    from flipped_tpu_torch.train.builder import resolve_model_config

    args = cli_args(data_root, "--quantize", quantize,
                    **(dict(seq=LONG_EVAL_S, batch=LONG_B) if long else {}))
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa, qm)
    t0 = time.perf_counter()
    with catch_quant_inputs(caught):
        stats = evaluate.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(fa, qm)
    peak = torch.cuda.max_memory_allocated()
    print(f"eval --quantize {quantize} (batch {args.batch_size}, S "
          f"{args.max_seq_len}): evaluate.main took {seconds:.3f} s "
          f"(7B init included), {stats['batches']} batches, launches "
          f"{launches}, peak allocated {peak / 2**30:.3f} GiB", flush=True)
    if stats["batches"] != 2:
        raise AssertionError(f"expected 2 val batches, got {stats['batches']}")
    blocks = resolve_model_config(run_config_from_args(args)).adapter_layer
    want = {k: v * stats["batches"]
            for k, v in eval_per_batch(quantize, blocks, long).items()}
    if launches != want:
        raise AssertionError(f"eval launches {launches}, want {want}")
    return args


def compare_cached_dense(torch, fa, args, caught):
    """One val batch through the cached and the dense eval steps: scores
    finite and in agreement, s/batch of each, and each warm-up call's
    attention launches (one forward per block: K1, or K5 above
    MAX_SEQ_FWD); the warm-up calls' quant kernel inputs go to `caught`."""
    from flipped_tpu_torch.cli.evaluate import batch_to_device
    from flipped_tpu_torch.core.config import run_config_from_args
    from flipped_tpu_torch.data.datasets import build_dataset
    from flipped_tpu_torch.data.pipeline import Loader
    from flipped_tpu_torch.train.builder import build_eval_state
    from flipped_tpu_torch.train.step import make_eval_step

    run_cfg = run_config_from_args(args)
    model, _, tokenizer = build_eval_state(run_cfg, torch.device("cuda"))
    loader = Loader(build_dataset(run_cfg.data, tokenizer, "val"),
                    run_cfg.data.batch_size, shuffle=False, split="val",
                    prefetch=0)
    it = iter(loader)
    batch = next(it)
    it.close()
    tb = batch_to_device(batch, "cuda")
    span = (int(batch["span_need"]), bool(batch["span_exact"]))
    steps = {"cached": make_eval_step(model, cached=True),
             "dense": make_eval_step(model, cached=False)}
    outs, secs = {}, {}
    fwd_key = "k5" if args.max_seq_len > fa.MAX_SEQ_FWD else "k1"
    want = {k: len(model.layers) if k == fwd_key else 0
            for k in attention_counters(fa)}
    for name, step in steps.items():
        before = {k: f.launches for k, f in attention_counters(fa).items()}
        with catch_quant_inputs(caught):
            outs[name] = step(tb, span_info=span)      # warm-up
        torch.cuda.synchronize()
        moved = {k: f.launches - before[k]
                 for k, f in attention_counters(fa).items()}
        if moved != want:
            raise AssertionError(f"eval {name} attention launches {moved}, "
                                 f"want {want}")
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            outs[name] = step(tb, span_info=span)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        secs[name] = sorted(runs)[1]
    c, d = outs["cached"]["scores"].float(), outs["dense"]["scores"].float()
    if not (torch.isfinite(c).all() and torch.isfinite(d).all()):
        raise AssertionError("non-finite eval scores")
    delta = (c - d).abs()
    agree = float((outs["cached"]["prediction"]
                   == outs["dense"]["prediction"]).float().mean())
    n = tb["vqa_tokens"].shape[0]
    print(f"cached vs dense on one batch (S {args.max_seq_len}, attention "
          f"launches per call {want}): max|dscore|={float(delta.max()):.5g} "
          f"(|score| up to {float(d.abs().max()):.4g}), argmin agreement "
          f"{agree:.3f}", flush=True)
    for name in steps:
        print(f"eval {name}: {secs[name]:.5f} s/batch (median of 3), "
              f"{n / secs[name]:.2f} ex/s at batch {n}", flush=True)
    if bool((delta > SCORE_RTOL * d.abs()).any()):
        raise AssertionError("cached and dense scores disagree beyond "
                             f"{SCORE_RTOL} relative")


def gen_per_batch(quantize, blocks, long=False):
    """Launches per generated batch, from the code: the prefill runs every
    block once over the prompt (K1, or K5 above MAX_SEQ_FWD = 4096: `long`)
    and each of the MAX_NEW_TOKENS - 1 decode steps every block once on one
    token a row (plain decode attention, no attention kernel); each of
    those passes has 9 quantized matmuls a block (wq, wk, wv, wo, w1, w3,
    w2 and the adapter rows' wk, wv: K3 under w8a8, K8 under w4a8); the LM
    head is weight-only."""
    from flipped_tpu_torch.train.generation import MAX_NEW_TOKENS

    counts = {k: 0 for k in ("k2", "k6a", "k6b", "k3", "k7", "k4", "k8",
                             "k9", "k10")}
    if quantize != "none":
        counts[forward_kernel(quantize)] = 9 * blocks * MAX_NEW_TOKENS
    return {"k1": 0 if long else blocks, "k5": blocks if long else 0,
            **counts}


def gen_args(data_root, quantize, out, *extra, **shape):
    """The MUSIC-AVQA recipe's flags (scripts/recipes.sh:38-42) at 7B:
    --is_generation_task, batch 32, S 128, max_feats 10, bias 3, tau 100."""
    return cli_args(data_root, "--dataset", "musicavqa",
                    "--is_generation_task", "--max_feats", str(MAX_FEATS),
                    "--bias", "3", "--tau", "100", "--quantize", quantize,
                    "--output_dir", out, *extra,
                    **({"seq": GEN_S, "batch": GEN_B} | shape))


def read_answers(out, n_rows):
    """The extracted-answers file of epoch 0: `n_rows` rows, unique qids,
    string answers."""
    path = os.path.join(out, "extracted_answers",
                        "extracted_answers_epoch0.json")
    with open(path) as f:
        rows = json.load(f)
    qids = [r["qid"] for r in rows]
    if (len(rows) != n_rows or len(set(qids)) != n_rows
            or not all(isinstance(r["generated_answer"], str)
                       for r in rows)):
        raise AssertionError(f"{path}: {len(rows)} rows, {len(set(qids))} "
                             f"unique qids, want {n_rows} string answers")
    return rows


def run_gen_train(torch, fa, qm, data_root, caught):
    """`cli.train.main` on the MUSIC-AVQA recipe at 7B, --debug: one update
    (VQA only: the recipe has no --vaq/--qav), then generation eval on one
    val batch of 32; launches as `per_update` and `gen_per_batch` derive
    them, the extracted answers and log.txt's `val_counting` checked."""
    from flipped_tpu_torch.cli import train as train_cli

    out = os.path.join(WORK, "gen_train_out")
    shutil.rmtree(out, ignore_errors=True)
    args = gen_args(data_root, "none", out, "--epochs", "1", "--debug")
    zero_counts(fa, qm)
    t0 = time.perf_counter()
    with catch_quant_inputs(caught):
        model, history = train_cli.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(fa, qm)
    blocks = len(model.layers)
    want = {k: v + gen_per_batch("none", blocks)[k]
            for k, v in per_update("none", blocks).items()}
    rows = read_answers(out, GEN_B)
    with open(os.path.join(out, "log.txt")) as f:
        logged = json.loads(f.readline())
    print(f"train --dataset musicavqa --is_generation_task (batch "
          f"{args.batch_size}, S {args.max_seq_len}): main took "
          f"{seconds:.3f} s (7B init included), launches {launches}; val "
          f"acc {logged['val_acc']}; first answer "
          f"{rows[0]['generated_answer'][:60]!r}", flush=True)
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    if "val_counting" not in logged or history[0]["val_batches"] != 1:
        raise AssertionError(f"log.txt line {logged}")
    del model
    shutil.rmtree(out, ignore_errors=True)


def run_gen_eval(torch, fa, qm, data_root, caught, quantize="none",
                 long=False):
    """`cli.evaluate.main --is_generation_task` (`long`: NExT-QA prompts at
    batch 1, S 8192, --debug: one batch) with launches as `gen_per_batch`
    derives them, the quant kernels' inputs to `caught`. → (args, the
    model the CLI built, its tokenizer)."""
    from flipped_tpu_torch.cli import evaluate

    built = {}
    orig = evaluate.build_eval_state

    def build(*a, **kw):
        built["model"], cfg, built["tok"] = orig(*a, **kw)
        return built["model"], cfg, built["tok"]

    out = os.path.join(WORK, "gen_eval_out")
    shutil.rmtree(out, ignore_errors=True)
    args = (gen_args(data_root, quantize, out, "--dataset", "nextqa",
                     "--debug", seq=LONG_EVAL_S, batch=LONG_B)
            if long else gen_args(data_root, quantize, out))
    evaluate.build_eval_state = build
    try:
        torch.cuda.reset_peak_memory_stats()
        zero_counts(fa, qm)
        t0 = time.perf_counter()
        with catch_quant_inputs(caught):
            stats = evaluate.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        evaluate.build_eval_state = orig
    launches = read_counts(fa, qm)
    peak = torch.cuda.max_memory_allocated()
    read_answers(out, args.batch_size)
    shutil.rmtree(out, ignore_errors=True)
    print(f"generation eval --quantize {quantize} (batch {args.batch_size}, "
          f"S {args.max_seq_len}): evaluate.main took {seconds:.3f} s (7B "
          f"init included), {stats['batches']} batch, acc {stats['acc']}, "
          f"launches {launches}, peak allocated {peak / 2**30:.3f} GiB",
          flush=True)
    want = gen_per_batch(quantize, len(built["model"].layers), long)
    if stats["batches"] != 1 or launches != want:
        raise AssertionError(f"{stats['batches']} batches, launches "
                             f"{launches}, want 1 and {want}")
    return args, built["model"], built["tok"]


def gen_batch(torch, args, tokenizer, device="cuda"):
    """The first val batch of `args`' dataset on the card."""
    from flipped_tpu_torch.cli.evaluate import batch_to_device
    from flipped_tpu_torch.core.config import run_config_from_args
    from flipped_tpu_torch.data.datasets import build_dataset
    from flipped_tpu_torch.data.pipeline import Loader

    run_cfg = run_config_from_args(args)
    loader = Loader(build_dataset(run_cfg.data, tokenizer, "val"),
                    run_cfg.data.batch_size, shuffle=False, split="val",
                    prefetch=0)
    it = iter(loader)
    batch = next(it)
    it.close()
    return batch_to_device(batch, device)


@contextlib.contextmanager
def recording(torch, model, names, record):
    """Wrap the model's `names` methods for the duration: each call's
    output goes to record[name] with a pair of CUDA events around it."""
    def wrap(name, fn):
        def call(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            record.setdefault(name, []).append((start, end, out))
            return out
        return call
    for name in names:
        setattr(model, name, wrap(name, getattr(model, name)))
    try:
        yield record
    finally:
        for name in names:
            delattr(model, name)


def decode_bytes(model, prefix, steps):
    """The least bytes a decode step must move, averaged over the steps:
    every weight a step reads once (the blocks', the LM head's, the final
    norm's and the adapter rows': all but the token and video embeddings)
    and the live KV cache (columns <= pos of every row, K and V, every
    layer) read once; step i decodes at pos = prefix + i."""
    weights = sum(p.numel() * p.element_size()
                  for n, p in model.named_parameters()
                  if not n.startswith(("tok_embeddings", "temporal_emb",
                                       "visual_proj")))
    cfg = model.cfg
    row = len(model.layers) * cfg.n_heads * cfg.head_dim * 2 * 2
    live = sum(float((prefix + i + 1).sum()) for i in range(steps)) / steps
    return weights + live * row, weights


def time_gen(torch, model, tokenizer, tb, label):
    """One batch through `make_generation_step`: s per batch (median of 3
    after one warm-up, each ending in torch.cuda.synchronize()), the
    prefill's ms and the decode ms per token by CUDA events around each
    call, the peak allocated memory over the timed runs, and the decode
    step's bytes bound at 3.35 TB/s."""
    from flipped_tpu_torch.train.generation import (MAX_NEW_TOKENS,
                                                    make_generation_step)

    gen_step = make_generation_step(model, tokenizer.eos_id)
    gen_step(tb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, prefill, decode = [], [], []
    for _ in range(3):
        record = {}
        with recording(torch, model, ("prefill", "decode_step"), record):
            t0 = time.perf_counter()
            out = gen_step(tb)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        prefill.append(sum(a.elapsed_time(b) for a, b, _ in
                           record["prefill"]))
        decode.append(sum(a.elapsed_time(b) for a, b, _ in
                          record["decode_step"]) / (MAX_NEW_TOKENS - 1))
        del record
    peak = torch.cuda.max_memory_allocated()
    med = lambda x: sorted(x)[1]
    s = tb["vqa_tokens"].shape[-1]
    need, weights = decode_bytes(model, tb["prefix"].long(),
                                 MAX_NEW_TOKENS - 1)
    b = tb["vqa_tokens"].shape[0]
    print(f"generation {label} (batch {b}, S {s}, {MAX_NEW_TOKENS} tokens): "
          f"{med(secs):.5f} s/batch (median of 3: "
          f"{', '.join(f'{x:.5f}' for x in secs)}), {b / med(secs):.3f} ex/s; "
          f"prefill {med(prefill):.4f} ms, decode {med(decode):.4f} ms per "
          f"token (CUDA events), bytes bound per decode step "
          f"{need / HBM_BYTES_PER_S * 1e3:.4f} ms ({need / 2**30:.3f} GiB: "
          f"weights {weights / 2**30:.3f} GiB, live cache "
          f"{(need - weights) / 2**30:.3f} GiB); peak allocated "
          f"{peak / 2**30:.3f} GiB", flush=True)
    if not bool(torch.isfinite(out["similarity"]).all()):
        raise AssertionError("non-finite similarities")
    return {"s_per_batch": med(secs), "prefill_ms": med(prefill),
            "decode_ms_per_token": med(decode), "peak_gib": peak / 2**30,
            "decode_bound_ms": need / HBM_BYTES_PER_S * 1e3}


def check_gen_consistency(torch, model, tokenizer, tb, label):
    """At 7B through the kernels, on one batch. (a) The cached decode
    against a re-forward: the prompt with the generated tokens written at
    prefix.. runs once through `encode` and `lm_logits`; at each of the 31
    decoded positions the cached logits lie within GEN_LOGIT_REL of the
    row's largest |logit| of the re-forward's, and the re-forward's logit
    of the chosen token within as much of the row's maximum. (b) The
    prefill with use_flash off (plain attention) against K1's: the first
    token's logits within GEN_LOGIT_REL, and the first token equal wherever
    the plain top-2 margin exceeds that bound."""
    from flipped_tpu_torch.train.generation import make_generation_step

    gen_step = make_generation_step(model, tokenizer.eos_id)
    record = {}
    with recording(torch, model, ("lm_logits", "decode_step"), record):
        out = gen_step(tb)
    cached = torch.stack([record["lm_logits"][0][2][:, 0]]
                         + [o[0] for _, _, o in record["decode_step"]],
                         dim=1).float()                   # (B, T, V)
    del record
    gen = out["generated"]
    b, t = gen.shape
    tokens = tb["vqa_tokens"][:, 0]
    s, dev = tokens.shape[1], tokens.device
    prefix = tb["prefix"].long()
    cols = torch.arange(s + t, device=dev)[None]
    seq = torch.zeros(b, s + t, dtype=tokens.dtype, device=dev)
    seq[:, :s] = tokens
    seq = torch.where(cols < prefix[:, None], seq, torch.zeros_like(seq))
    rows = torch.arange(b, device=dev)[:, None]
    at = prefix[:, None] + torch.arange(t, device=dev)[None]      # (B, T)
    seq[rows, at] = gen.to(seq.dtype)
    with torch.inference_mode():
        vf = model.fuse(tb["video"])
        h = model.encode(seq, vf, tb["vqa_video_start"], tb["vqa_splice"])
        ref = model.lm_logits(h[rows, at - 1]).float()            # (B, T, V)
        scale = ref.abs().amax(-1)
        err = ((cached - ref).abs().amax(-1) / scale).max().item()
        chosen = ref.gather(-1, gen[..., None])[..., 0]
        gap = ((ref.amax(-1) - chosen) / scale).max().item()
        blocks = [blk.attention for blk in model.layers.values()]
        for att in blocks:
            att.use_flash = False
        try:
            hp, _, _ = model.prefill(tokens, vf, tb["vqa_video_start"],
                                     tb["vqa_splice"], s + t + 1)
        finally:
            for att in blocks:
                att.use_flash = True
        plain = model.lm_logits(hp[rows[:, 0], prefix - 1]).float()  # (B, V)
    pscale = plain.abs().amax(-1)
    err_b = ((cached[:, 0] - plain).abs().amax(-1) / pscale).max().item()
    top2 = plain.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > GEN_LOGIT_REL * pscale
    same = plain.argmax(-1) == gen[:, 0]
    print(f"generation {label} consistency: (a) cached vs re-forward max "
          f"|d logit| {err:.5f} of the row's max |logit| (bound "
          f"{GEN_LOGIT_REL}), chosen token at most {gap:.5f} below the "
          f"re-forward's max; tokens equal to the re-forward's argmax "
          f"{float((ref.argmax(-1) == gen).float().mean()):.4f}; (b) K1 vs "
          f"plain prefill, first token: max |d logit| {err_b:.5f} of the "
          f"row's max, {int(clear.sum())} of {b} rows with a clear top-2 "
          f"margin, first token equal in {int(same.sum())} of {b} rows "
          f"({int((same | ~clear).sum())} of {b} where it must)", flush=True)
    if err > GEN_LOGIT_REL or gap > GEN_LOGIT_REL:
        raise AssertionError(f"cached decode off the re-forward: {err:.5f}, "
                             f"chosen token {gap:.5f} below the max")
    if err_b > GEN_LOGIT_REL or not bool((same | ~clear).all()):
        raise AssertionError("K1's prefill off the plain attention's")


# the checkpoint phase: Meta's 7B params.json, but a vocabulary of 32000
# where Meta writes -1 (the tokenizer's): the smoke has no tokenizer.model
META_7B = {"dim": 4096, "multiple_of": 256, "n_heads": 32, "n_layers": 32,
           "norm_eps": 1e-06, "vocab_size": 32000}
CKPT_SHARDS = 2
CKPT_HELD = ("layers.0.attention.wq", "layers.31.feed_forward.w2", "output")
LOAD_SLACK = 2 * 2**30        # build + load at w8a8: parameters + 2 GiB


def param_bytes(model):
    return sum(p.numel() * p.element_size() for p in model.parameters())


def timed_build(torch, build):
    """→ (build's result, seconds, {'peak': torch.cuda.max_memory_allocated
    over the build, 'before': what was allocated before it, 'added': the
    peak less that, the build's own})."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = build()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return out, time.perf_counter() - t0, {"peak": peak, "before": base,
                                           "added": peak - base}


def memory_line(mem, model):
    return (f"max_memory_allocated {mem['peak'] / 2**30:.3f} GiB, "
            f"{mem['before'] / 2**30:.3f} GiB allocated before the build, "
            f"{mem['added'] / 2**30:.3f} GiB added by it, for "
            f"{param_bytes(model) / 2**30:.3f} GiB of parameters")


def export_checkpoint(torch, data_root, ckpt_dir):
    """The bf16 7B backbone from seed 0, as the train phases build it,
    written as fp16 Meta shards (one at a time through the host); → the
    fp16 state, kept on the card."""
    from flipped_tpu_torch.ckpt.convert import export_meta_checkpoint
    from flipped_tpu_torch.core.config import run_config_from_args
    from flipped_tpu_torch.train.builder import build_eval_state

    model, _, _ = build_eval_state(run_config_from_args(cli_args(data_root)),
                                   torch.device("cuda"))
    half = {n: p.detach().to(torch.float16)
            for n, p in model.named_parameters() if not p.requires_grad}
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    export_meta_checkpoint(half, CKPT_SHARDS, ckpt_dir, META_7B)
    secs = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(ckpt_dir, f))
               for f in os.listdir(ckpt_dir))
    print(f"export: {len(half)} frozen leaves as {CKPT_SHARDS} fp16 shards, "
          f"{size / 2**30:.3f} GiB, in {secs:.3f} s", flush=True)
    return half


def check_loaded_none(torch, data_root, ckpt_root, half):
    """Build at --quantize none from the shards: every frozen leaf is
    bf16(fp16(original)) bit for bit."""
    from flipped_tpu_torch.core.config import run_config_from_args
    from flipped_tpu_torch.train.builder import build_eval_state

    args = cli_args(data_root, "--llama_model_path", ckpt_root)
    (model, _, _), secs, mem = timed_build(torch, lambda: build_eval_state(
        run_config_from_args(args), torch.device("cuda")))
    frozen = {n: p for n, p in model.named_parameters()
              if not p.requires_grad}
    if set(frozen) != set(half):
        raise AssertionError(f"loaded leaves {sorted(set(frozen) ^ set(half))}"
                             f" differ from the exported ones")
    for n, p in frozen.items():
        if not torch.equal(p, half[n].to(torch.bfloat16)):
            raise AssertionError(f"loaded {n} is not bf16(fp16(original))")
    print(f"load --quantize none: {secs:.3f} s (init included), "
          f"{memory_line(mem, model)} (the exported fp16 state stays on "
          f"the card beside it); {len(frozen)} frozen leaves bit for bit "
          f"bf16(fp16(original))", flush=True)


def held_codes(torch, model, ckpt_dir):
    """The card's codes and scales of CKPT_HELD against quantize_kernel on
    the CPU, from the same shards, bit for bit (w8a8: per channel)."""
    from flipped_tpu_torch.ckpt.convert import load_meta_checkpoint
    from flipped_tpu_torch.ckpt.quantize import quantize_kernel

    src = dict(load_meta_checkpoint(ckpt_dir, [f"{b}.weight"
                                               for b in CKPT_HELD]))
    for base in CKPT_HELD:
        linear = model.get_submodule(base)
        want = quantize_kernel(src[f"{base}.weight"])
        for leaf in ("kernel_q", "scale"):
            if not torch.equal(getattr(linear, leaf).cpu(), want[leaf]):
                raise AssertionError(f"{base}.{leaf}: the card's quantize "
                                     f"differs from the CPU's")
    print(f"  codes and scales of {', '.join(CKPT_HELD)} bit for bit "
          f"quantize_kernel's on the CPU", flush=True)


def adapter_state(model, optimizer):
    """Trainables and optimizer state, copied to the CPU."""
    st = optimizer.state_dict()
    return {"trainable": {n: p.detach().to("cpu", copy=True) for n, p in
                          model.named_parameters() if p.requires_grad},
            "count": st["count"],
            "moments": {n: {k: v.to("cpu", copy=True) for k, v in m.items()}
                        for n, m in st["params"].items()}}


def same_adapter(torch, a, b):
    return (a["count"] == b["count"]
            and a["trainable"].keys() == b["trainable"].keys()
            and all(torch.equal(t, b["trainable"][n])
                    for n, t in a["trainable"].items())
            and a["moments"].keys() == b["moments"].keys()
            and all(torch.equal(v, b["moments"][n][k])
                    for n, m in a["moments"].items() for k, v in m.items()))


def saved_adapter(torch, out, name):
    st = torch.load(os.path.join(out, name, "state.pt"), weights_only=True)
    return {"trainable": st["trainable"], "count": st["optimizer"]["count"],
            "moments": st["optimizer"]["params"]}, st["meta"]


def run_ckpt_train(torch, fa, qm, args):
    """cli.train.main with its build and optimizer watched: → (history,
    {'model', 'optimizer', 'build_s', 'build_mem', 'resumed' (the adapter
    when the step is made, after any restore)}, launches)."""
    from flipped_tpu_torch.cli import train as train_cli

    watch = {}
    orig = (train_cli.build_train_state, train_cli.make_optimizer,
            train_cli.make_train_step)

    def build(*a, **kw):
        out, watch["build_s"], watch["build_mem"] = timed_build(
            torch, lambda: orig[0](*a, **kw))
        watch["model"] = out[0]
        return out

    def make_optimizer(*a, **kw):
        watch["optimizer"] = orig[1](*a, **kw)
        return watch["optimizer"]

    def make_step(*a, **kw):
        watch["resumed"] = adapter_state(watch["model"], watch["optimizer"])
        return orig[2](*a, **kw)

    train_cli.build_train_state, train_cli.make_optimizer, \
        train_cli.make_train_step = build, make_optimizer, make_step
    try:
        zero_counts(fa, qm)
        _, history = train_cli.main(args)
        torch.cuda.synchronize()
        launches = read_counts(fa, qm)
    finally:
        train_cli.build_train_state, train_cli.make_optimizer, \
            train_cli.make_train_step = orig
    return history, watch, launches


def log_lines(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def check_checkpoints(torch, fa, qm, data_root):
    """The checkpoint path at 7B (phase 12 of the module docstring); the
    shards and the runs' output are deleted at its end."""
    import shutil

    from flipped_tpu_torch.cli import evaluate
    from flipped_tpu_torch.core.config import run_config_from_args
    from flipped_tpu_torch.data.datasets import build_dataset
    from flipped_tpu_torch.data.pipeline import Loader
    from flipped_tpu_torch.cli.evaluate import batch_to_device
    from flipped_tpu_torch.train.builder import build_eval_state
    from flipped_tpu_torch.train.step import make_eval_step

    ckpt_root = os.path.join(WORK, "ckpt")
    ckpt_dir = os.path.join(ckpt_root, "llama7B")
    out = os.path.join(WORK, "ckpt_out")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    shutil.rmtree(out, ignore_errors=True)
    try:
        half = export_checkpoint(torch, data_root, ckpt_dir)
        check_loaded_none(torch, data_root, ckpt_root, half)
        del half
        torch.cuda.empty_cache()

        base = ("--vaq", "--qav", "--quantize", "w8a8", "--debug",
                "--llama_model_path", ckpt_root, "--output_dir", out)
        history, watch, launches = run_ckpt_train(
            torch, fa, qm, cli_args(data_root, *base, "--epochs", "1"))
        model = watch["model"]
        print(f"train --quantize w8a8 from the checkpoint: load+quantize "
              f"{watch['build_s']:.3f} s (init included), "
              f"{memory_line(watch['build_mem'], model)}; launches "
              f"{launches}; history {json.dumps(history)}", flush=True)
        # the build's own peak: earlier phases' allocations are not its
        if watch["build_mem"]["added"] > param_bytes(model) + LOAD_SLACK:
            raise AssertionError("the w8a8 build held more than its "
                                 "parameters and 2 GiB")
        if any(launches[k] == 0 for k in ("k1", "k2", "k3")):
            raise AssertionError("the w8a8 train path did not launch K1, "
                                 "K2 and K3")
        held_codes(torch, model, ckpt_dir)
        # checkpoint_best is written when the val accuracy rises above 0
        for name, want in (("checkpoint_last", True),
                           ("checkpoint_best", history[0]["val_acc"] > 0)):
            there = (os.path.isfile(os.path.join(out, name, "state.pt"))
                     and os.path.isfile(os.path.join(out,
                                                     f"{name}.meta.json")))
            if there != want:
                raise AssertionError(f"{name} and its sidecar: written "
                                     f"{there}, want {want}")
        saved, meta = saved_adapter(torch, out, "checkpoint_last")
        if not same_adapter(torch, saved, adapter_state(
                model, watch["optimizer"])) or meta["epoch"] != 0:
            raise AssertionError("checkpoint_last is not the run's state")
        if len(log_lines(out)) != 1:
            raise AssertionError("log.txt should have one line")
        del model, watch
        torch.cuda.empty_cache()

        history, watch, launches = run_ckpt_train(
            torch, fa, qm, cli_args(data_root, *base, "--epochs", "2",
                                    "--resume", "checkpoint_last"))
        print(f"train --resume checkpoint_last --epochs 2: load+quantize "
              f"{watch['build_s']:.3f} s, launches {launches}; history "
              f"{json.dumps(history)}", flush=True)
        if [h["epoch"] for h in history] != [1]:
            raise AssertionError("the resumed run should run epoch 1 only")
        if not same_adapter(torch, watch["resumed"], saved):
            raise AssertionError("the resumed trainables, moments or count "
                                 "differ from the saved ones")
        lines = log_lines(out)
        if [line["epoch"] for line in lines] != [0, 1]:
            raise AssertionError(f"log.txt epochs {[x['epoch'] for x in lines]}")
        print(f"  resumed at epoch 1 with the saved trainables, AdamW "
              f"moments and count {saved['count']} bit for bit; log.txt "
              f"has 2 lines", flush=True)
        del watch
        torch.cuda.empty_cache()

        # no epoch scored above 0: no checkpoint_best, so the last
        name = ("checkpoint_best" if max(x["val_acc"] for x in lines) > 0
                else "checkpoint_last")
        with open(os.path.join(out, f"{name}.meta.json")) as f:
            best = json.load(f)
        logged = next(x for x in lines if x["epoch"] == best["epoch"])
        zero_counts(fa, qm)
        stats = evaluate.main(cli_args(
            data_root, "--quantize", "w8a8", "--debug", "--llama_model_path",
            ckpt_root, "--output_dir", out, "--resume", name))
        print(f"evaluate --resume {name} (epoch {best['epoch']}): "
              f"acc {stats['acc']}, logged val_acc {logged['val_acc']}; "
              f"launches {read_counts(fa, qm)}", flush=True)
        if stats["acc"] != logged["val_acc"]:
            raise AssertionError("evaluate's acc differs from the logged "
                                 "val_acc")
        torch.cuda.empty_cache()

        args = cli_args(data_root, "--quantize", "w4a8r",
                        "--llama_model_path", ckpt_root)
        run_cfg = run_config_from_args(args)
        (model, _, tokenizer), secs, mem = timed_build(
            torch, lambda: build_eval_state(run_cfg, torch.device("cuda")))
        print(f"load --quantize w4a8r (rotate, then int4): {secs:.3f} s "
              f"(init included), {memory_line(mem, model)}", flush=True)
        if not torch.equal(model.qav_rot, model.qav_rot.t()):
            raise AssertionError("qav_rot is not symmetric")
        loader = Loader(build_dataset(run_cfg.data, tokenizer, "val"),
                        run_cfg.data.batch_size, shuffle=False, split="val",
                        prefetch=0)
        it = iter(loader)
        batch = next(it)
        it.close()
        zero_counts(fa, qm)
        with torch.no_grad():
            scores = make_eval_step(model, cached=True)(
                batch_to_device(batch, "cuda"),
                span_info=(int(batch["span_need"]),
                           bool(batch["span_exact"])))["scores"]
        torch.cuda.synchronize()
        launches = read_counts(fa, qm)
        print(f"  one val batch: scores {tuple(scores.shape)}, launches "
              f"{launches}; qav_rot symmetric", flush=True)
        if not bool(torch.isfinite(scores).all()) or launches["k8"] == 0:
            raise AssertionError("w4a8r scores not finite, or K8 idle")
        del model, scores
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
        shutil.rmtree(out, ignore_errors=True)


# Phase 15, audio and trainer. The fork's headline recipe
# (scripts/params.txt "1 0 attention llama7B musicavqa", recipes.sh's
# MUSIC-AVQA batch 32) on 64 items: 2 updates, then one generated val
# batch of its 16 val rows. The other merges, the qkv remat policy and the
# grain loader on 16 NExT-QA items (2 updates at batch 8, one val batch),
# the trace on 32 (4 updates: steps 1 to 3 traced).
N_AUDIO_GEN_ITEMS = 64
N_PHASE15_ITEMS = 16
N_TRACE_ITEMS = 32
AUDIO_RUNS = (("sum", ("--audio", "--audio_merge", "sum")),
              ("concat", ("--audio", "--audio_merge", "concat")),
              ("audio_only", ("--audio", "--audio_only")))
CROSS_ATTN = tuple(f"video_audio_cross_attn.{m}.{leaf}"
                   for m in ("query", "key", "value")
                   for leaf in ("weight", "bias"))
# each merge's fusion trainables (model/llama.py): all of them train, the
# audio ones included, which the fork's name filter left frozen
FUSION = {"attention": ("audio_proj.weight", "visual_proj.weight")
          + CROSS_ATTN,
          "sum": ("audio_proj.weight", "visual_proj.weight"),
          "concat": ("visual_proj.weight",),
          "audio_only": ("audio_proj.weight",)}
# The attention merge reads one audio clip embedding a video
# (audio_imagebind_clip.pth): a softmax over one key is 1, so the
# cross-attention's query and key get exactly zero gradients; their
# kernels move by weight decay alone and their biases (no decay) stay.
ATTENTION_STILL = ("video_audio_cross_attn.key.bias",
                   "video_audio_cross_attn.query.bias")
ATTENTION_ZERO_GRAD = ATTENTION_STILL + ("video_audio_cross_attn.key.weight",
                                         "video_audio_cross_attn.query.weight")
K1_KERNEL, K2_KERNELS = "flash_text_fwd_kernel", ("flash_text_dq_kernel",
                                                  "flash_text_dkv_kernel")


def run_phase15(torch, fa, qm, args, caught, label, n_updates, per,
                merge=None, grads_at=0, gen=False):
    """One watched `cli.train.main` run of phase 15: `n_updates` updates
    with finite metrics, the launches per update `per` over the epoch (and
    one generated batch's `gen_per_batch` after it under `gen`), the
    merge's fusion trainables among the trainables, frozen weights
    unchanged, no trainable moved by update 1 and every one moved by
    update 2 but the attention merge's query and key biases, whose
    gradients (with the query and key kernels') are exactly zero."""
    watch = watch_train(torch, fa, qm, args, caught,
                        grads_at=2 if merge == "attention" else grads_at)
    steps, blocks = len(watch["metrics"]), len(watch["model"].layers)
    epoch, launches = watch["at_val"], watch["launches"]
    secs = watch["secs"]
    snapshot = sum(p.numel() * p.element_size()
                   for p in watch["frozen0"].values())
    print(f"{label} (batch {args.batch_size}, S {args.max_seq_len}): main "
          f"took {watch['seconds']:.3f} s (7B init and val included), "
          f"{steps} updates at {', '.join(f'{x:.4f}' for x in secs)} s, "
          f"val {watch['val_secs']:.3f} s, launches over the epoch {epoch}, "
          f"over the run {launches}; peak allocated "
          f"{watch['peak'] / 2**30:.3f} GiB, {snapshot / 2**30:.3f} of it "
          f"this check's copy of the frozen weights", flush=True)
    print_updates(watch)
    if steps != n_updates:
        raise AssertionError(f"expected {n_updates} updates, ran {steps}")
    if not all(math.isfinite(x) for m in watch["metrics"] for x in m):
        raise AssertionError("a training metric is not finite")
    want = {k: v * steps for k, v in per.items()}
    if epoch != want:
        raise AssertionError(f"launches over the epoch {epoch}, want {want}")
    if gen:
        rest = {k: launches[k] - epoch[k] for k in launches}
        want_gen = gen_per_batch(args.quantize, blocks)
        if rest != want_gen:
            raise AssertionError(f"generation launches {rest}, want "
                                 f"{want_gen}")
    names = set(watch["snaps"][0])
    missing = [n for n in FUSION.get(merge, ()) if n not in names]
    if missing:
        raise AssertionError(f"{missing} are not trainable")
    still = ATTENTION_STILL if merge == "attention" and steps > 1 else ()
    if merge == "attention":
        nonzero = [n for n in ATTENTION_ZERO_GRAD
                   if bool(watch["grads"][n].any())]
        if nonzero:
            raise AssertionError(f"{nonzero}: gradients over one audio key "
                                 f"should be zero")
    check_trainables(torch, watch, still)
    print(f"  launches per update {per}, as the video-only update's"
          + (f"; fusion trainables {list(FUSION[merge])} moved"
             + (f" but {list(still)} (zero gradients over one audio key)"
                if still else "") if merge else ""), flush=True)
    return watch


def grads_rel(a, b):
    """The largest relative Frobenius difference over the trainables'
    gradients a and b."""
    return max(float((a[n].double() - b[n].double()).norm()
                     / b[n].double().norm().clamp_min(1e-30)) for n in b)


def check_trace(path, blocks, steps):
    """The Chrome trace of `--trace_dir`: spans `train step 1` ..
    `train step {steps}`, and in them K1's kernel 2 x `blocks` times a step
    and K2's two kernels `blocks` times each (one K2 call launches a dq and
    a dk/dv kernel)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("train step")}
    want_spans = [f"train step {i}" for i in range(1, steps + 1)]
    if sorted(spans) != want_spans:
        raise AssertionError(f"trace spans {sorted(spans)}, want "
                             f"{want_spans}")
    lo = min(a for a, _ in spans.values())
    hi = max(b for _, b in spans.values())
    kernels = [e for e in events if e.get("cat") == "kernel"]
    found = {name: [e for e in kernels if name in e["name"]]
             for name in (K1_KERNEL,) + K2_KERNELS}
    want = {K1_KERNEL: 2 * blocks * steps,
            **{k: blocks * steps for k in K2_KERNELS}}
    counts = {k: len(v) for k, v in found.items()}
    outside = sum(not lo <= float(e["ts"]) <= hi
                  for v in found.values() for e in v)
    print(f"  trace {os.path.basename(path)}: {os.path.getsize(path)} "
          f"bytes, {len(kernels)} kernel events, spans "
          f"{sorted(spans)}; {counts} (want {want}), {outside} of them "
          f"outside the traced steps", flush=True)
    if counts != want or outside:
        raise AssertionError("the trace does not hold K1's and K2's "
                             "kernels of the traced steps")


def audio_and_trainer(torch, fa, qm, caught, video_step):
    """Phase 15: the audio merges, --remat_policy qkv, --trace_dir and
    --loader grain at 7B width through `cli.train.main`; `video_step` is
    phase 9's (s, peak bytes) of a video-only update without remat."""
    from flipped_tpu_torch.cli.train import trace_file

    gen_root = os.path.join(WORK, "data_audio_gen")
    write_gen_fixtures(gen_root, N_AUDIO_GEN_ITEMS)
    root = os.path.join(WORK, "data_phase15")
    write_fixtures(root, N_PHASE15_ITEMS)
    none = per_update("none", 32)

    out = os.path.join(WORK, "audio_gen_out")
    shutil.rmtree(out, ignore_errors=True)
    args = gen_args(gen_root, "none", out, "--audio", "--audio_merge",
                    "attention", "--epochs", "1")
    watch = run_phase15(torch, fa, qm, args, caught,
                        "train --audio --audio_merge attention on the "
                        "MUSIC-AVQA recipe, then generation", 2, none,
                        merge="attention", gen=True)
    rows = read_answers(out, N_AUDIO_GEN_ITEMS // 4)
    print(f"  {len(rows)} val answers by qid; s per update "
          f"{', '.join(f'{x:.4f}' for x in watch['secs'])}, s per "
          f"generation batch {watch['val_secs']:.3f} (its first call), "
          f"peak allocated {watch['peak'] / 2**30:.3f} GiB", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    step = time_train_step(torch, watch["model"], cli_args(
        root, "--vaq", "--qav", "--audio", "--audio_merge", "attention"))
    print(f"  the attention merge's update without remat {step[0]:.5f} s, "
          f"peak {step[1] / 2**30:.3f} GiB; the video-only update's "
          f"(phase 9) {video_step[0]:.5f} s, peak "
          f"{video_step[1] / 2**30:.3f} GiB", flush=True)
    del watch
    torch.cuda.empty_cache()

    base = ("--vaq", "--qav", "--epochs", "1", "--output_dir", "")
    for merge, flags in AUDIO_RUNS + (("attention", ("--audio",
                                                     "--audio_merge",
                                                     "attention")),):
        quantize = "w8a8" if merge == "attention" else "none"
        run_phase15(torch, fa, qm, cli_args(root, *base, *flags,
                                            "--quantize", quantize),
                    caught, f"train {' '.join(flags)} --quantize "
                    f"{quantize}", 2, per_update(quantize, 32), merge=merge)
        torch.cuda.empty_cache()

    runs, timed = {}, {}
    for policy in ("full", "qkv"):
        args = cli_args(root, *base, "--remat_policy", policy)
        runs[policy] = run_phase15(
            torch, fa, qm, args, caught, f"train --remat_policy {policy}",
            2, per_update("none", 32, policy=policy), grads_at=2)
        timed[policy] = time_train_step(torch, runs[policy].pop("model"),
                                        args, n=3, remat=True)
        torch.cuda.empty_cache()
    rel = grads_rel(runs["qkv"]["grads"], runs["full"]["grads"])
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30)
                   for ma, mb in zip(runs["qkv"]["metrics"],
                                     runs["full"]["metrics"])
                   for a, b in zip(ma[:5], mb[:5]))
    print(f"  qkv against full: metrics within {loss_rel:.3g} relative "
          f"(bit for bit: {runs['qkv']['metrics'] == runs['full']['metrics']}"
          f"), update 2's gradients within {rel:.3g} (relative Frobenius, "
          f"bound {GRAD_REL}); with remat full {timed['full'][0]:.5f} s, "
          f"peak {timed['full'][1] / 2**30:.3f} GiB, qkv "
          f"{timed['qkv'][0]:.5f} s, peak {timed['qkv'][1] / 2**30:.3f} "
          f"GiB; K1 per update {per_update('none', 32)['k1']} and "
          f"{per_update('none', 32, policy='qkv')['k1']}", flush=True)
    if rel > GRAD_REL or loss_rel > GRAD_REL:
        raise AssertionError("--remat_policy qkv disagrees with full")
    run_phase15(torch, fa, qm, cli_args(root, *base, "--remat_policy", "qkv",
                                        "--quantize", "w8a8", "--debug"),
                caught, "train --remat_policy qkv --quantize w8a8, one "
                "update", 1, per_update("w8a8", 32, policy="qkv"))
    torch.cuda.empty_cache()
    long_root = os.path.join(WORK, "data_long_qkv")
    write_fixtures(long_root, N_LONG_ITEMS)
    run_phase15(torch, fa, qm, cli_args(
        long_root, *base, "--remat_policy", "qkv", "--lm_head_chunk",
        LM_CHUNK, "--debug", seq=LONG_S, batch=LONG_B), caught,
        "train --remat_policy qkv, long context, one update", 1,
        per_update("none", 32, streaming=True, policy="qkv"))
    torch.cuda.empty_cache()

    grain = run_phase15(torch, fa, qm, cli_args(
        root, *base, "--loader", "grain", "--num_workers", "2"), caught,
        "train --loader grain --num_workers 2", 2, none)
    same = grain["metrics"] == runs["full"]["metrics"]
    print(f"  grain's metrics bit for bit the thread loader's: {same}",
          flush=True)
    if not same:
        raise AssertionError("--loader grain changed the losses")
    del grain, runs
    torch.cuda.empty_cache()

    trace_root = os.path.join(WORK, "data_trace")
    write_fixtures(trace_root, N_TRACE_ITEMS)
    trace_dir = os.path.join(WORK, "trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    watch = run_phase15(torch, fa, qm, cli_args(
        trace_root, *base, "--trace_dir", trace_dir), caught,
        "train --trace_dir", N_TRACE_ITEMS // TRAIN_B, none)
    check_trace(trace_file(trace_dir, 0), len(watch["model"].layers),
                min(4, N_TRACE_ITEMS // TRAIN_B - 1))
    shutil.rmtree(trace_dir, ignore_errors=True)
    del watch
    torch.cuda.empty_cache()


def main() -> int:
    t_start = time.perf_counter()
    import torch

    phase("device")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("torch sees no CUDA device: chip_smoke.py runs only on the card",
              file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from flipped_tpu_torch.model import int4 as q4
    from flipped_tpu_torch.model import int8 as q8
    from flipped_tpu_torch.model.kernels import build as kbuild
    from flipped_tpu_torch.model.kernels import flash_attention as fa
    from flipped_tpu_torch.model.kernels import quant_matmul as qm

    phase("build")
    t0 = time.perf_counter()
    lib = kbuild.build(force=True)
    print(f"built {lib.path} in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("# nvcc"):
            print("  " + line.strip(), flush=True)
    serialised = kbuild.wgmma_serialisation_warnings(lib.log)
    if serialised:
        raise AssertionError(
            "ptxas serialised wgmmas in "
            + "; ".join(f"{src}: {line}" for src, line in serialised))

    phase("K1 vs plain")
    k1_err = check_k1(torch, fa)
    k1_err = max(k1_err, check_k1_long(torch, fa))

    phase("K2 vs plain")
    k2_err = check_k2(torch, fa)

    phase("attention grads")
    check_grads(torch, fa)

    phase("K5 / K6a / K6b vs plain")
    stream_err = check_stream(torch, fa)
    torch.cuda.empty_cache()

    phase("attention grads, streaming regime")
    check_stream_grads(torch, fa)
    torch.cuda.empty_cache()

    phase("K3 / K7 / K4 / K8 / K9 / K10 vs plain")
    # K4's and K9's plain versions are cuBLAS bf16 products: their sums stay
    # in f32 for the comparison and the timing (the model's own GEMMs keep
    # the default)
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    quant_err = {k: 0.0 for k in QUANT_KERNELS}
    check_quant(torch, qm, quant_err)
    check_quant_autograd(torch, qm, q8)
    check_int4_dgrad_autograd(torch, qm, q4, q8)

    phase("timing")
    k1_times = time_k1(torch, fa)
    k2_time = time_k2(torch, fa)
    stream_times = time_stream(torch, fa)
    torch.cuda.empty_cache()
    quant_times = time_quant(torch, qm)
    matmul.allow_bf16_reduced_precision_reduction = reduced

    data_root = os.path.join(WORK, "data")
    write_fixtures(data_root, N_TRAIN_ITEMS)
    long_root = os.path.join(WORK, "data_long")
    write_fixtures(long_root, N_LONG_ITEMS)

    launches, caught = {}, {k: {} for k in QUANT_KERNELS}
    step_times = {}
    for quantize, debug in TRAIN_RUNS:
        phase(f"train --quantize {quantize}"
              + (", one update" if debug else ""))
        model, args, launches[quantize] = run_train_slice(
            torch, fa, qm, data_root, caught, quantize, debug)
        if quantize in TIMED_STEPS:
            step_times[quantize] = time_train_step(torch, model, args)
        del model
        torch.cuda.empty_cache()

    for quantize in EVAL_RUNS:
        phase(f"eval --quantize {quantize}")
        compare_cached_dense(torch, fa, run_eval_slice(
            torch, fa, qm, data_root, caught, quantize), caught)
        torch.cuda.empty_cache()

    gen_root = os.path.join(WORK, "data_gen")
    write_gen_fixtures(gen_root, N_GEN_ITEMS)
    phase("generation: cli.train on the MUSIC-AVQA recipe")
    run_gen_train(torch, fa, qm, gen_root, caught)
    torch.cuda.empty_cache()
    for quantize in GEN_RUNS:
        phase(f"generation eval --quantize {quantize}")
        args, model, tok = run_gen_eval(torch, fa, qm, gen_root, caught,
                                        quantize)
        tb = gen_batch(torch, args, tok)
        time_gen(torch, model, tok, tb, f"--quantize {quantize}")
        check_gen_consistency(torch, model, tok, tb, f"--quantize {quantize}")
        del model, tb
        torch.cuda.empty_cache()

    phase("checkpoints: 7B Meta shards, load, train, resume, evaluate")
    check_checkpoints(torch, fa, qm, data_root)

    for quantize, extra, debug in LONG_RUNS:
        phase(f"train, long context: --quantize {quantize} {' '.join(extra)}"
              + (", one update" if debug else ""))
        model, args, launches[(quantize, extra)] = run_train_slice(
            torch, fa, qm, long_root, caught, quantize, debug, extra,
            long=True)
        if not debug:
            time_train_step(torch, model, args, n=3, remat=True)
        del model
        torch.cuda.empty_cache()

    phase(f"eval, long context: S {LONG_EVAL_S}")
    compare_cached_dense(torch, fa, run_eval_slice(
        torch, fa, qm, long_root, caught, long=True), caught)
    torch.cuda.empty_cache()

    phase(f"generation eval, long context: S {LONG_EVAL_S}")
    args, model, tok = run_gen_eval(torch, fa, qm, long_root, caught,
                                    long=True)
    time_gen(torch, model, tok, gen_batch(torch, args, tok),
             f"bf16, S {LONG_EVAL_S}")
    del model
    torch.cuda.empty_cache()

    phase("audio and trainer: the audio merges, --remat_policy qkv, "
          "--loader grain, --trace_dir")
    t15 = time.perf_counter()
    audio_and_trainer(torch, fa, qm, caught, step_times["none"])
    print(f"phase 15 took {time.perf_counter() - t15:.1f} s", flush=True)

    phase("quant kernels vs plain at the main paths' shapes")
    matmul.allow_bf16_reduced_precision_reduction = False
    check_caught(torch, qm, caught, quant_err, QUANT_KERNELS)
    matmul.allow_bf16_reduced_precision_reduction = reduced
    del caught

    if any(m in ("jax", "flipped_tpu") or m.startswith(("jax.", "flipped_tpu."))
           for m in sys.modules):
        raise AssertionError("the port pulled in jax or the JAX package")
    rows = []
    for name, source, replaces, count, err, t in (
            ("flash_text_fwd", K1_SOURCE, K1_REPLACES,
             launches["none"]["k1"], k1_err, k1_times["train"]),
            ("flash_text_bwd", K2_SOURCE, K2_REPLACES,
             launches["none"]["k2"], k2_err, k2_time),
            ("flash_stream_fwd", K5_SOURCE, K5_REPLACES,
             launches[LONG_RUNS[0][:2]]["k5"], stream_err["k5"],
             stream_times["k5"]),
            ("flash_stream_dq", K6_SOURCE, K6A_REPLACES,
             launches[LONG_RUNS[0][:2]]["k6a"], stream_err["k6a"],
             stream_times["k6a"]),
            ("flash_stream_dkv", K6_SOURCE, K6B_REPLACES,
             launches[LONG_RUNS[0][:2]]["k6b"], stream_err["k6b"],
             stream_times["k6b"]),
            ("int8_fwd", K3_SOURCE, K3_REPLACES, launches["w8a8"]["k3"],
             quant_err["k3"], quant_times["k3"][QUANT_ROW_SHAPE]),
            ("int8_grouped_fwd", K7_SOURCE, K7_REPLACES,
             launches["w8a8g"]["k7"], quant_err["k7"],
             quant_times["k7"][QUANT_ROW_SHAPE]),
            ("quant_dx", K4_SOURCE, K4_REPLACES, launches["w8a8g"]["k4"],
             quant_err["k4"], quant_times["k4"][QUANT_ROW_SHAPE]),
            ("int4_fwd (w4a8)", K8_SOURCE, K8_REPLACES,
             launches["w4a8"]["k8"], quant_err["k8a"],
             quant_times["k8a"][QUANT_ROW_SHAPE]),
            ("int4_fwd (int4 weight-only)", K8_SOURCE, K8_REPLACES,
             launches["int4"]["k8"], quant_err["k8w"],
             quant_times["k8w"][QUANT_ROW_SHAPE]),
            ("int4_dx", K9_SOURCE, K9_REPLACES, launches["w4a8"]["k9"],
             quant_err["k9"], quant_times["k9"][QUANT_ROW_SHAPE]),
            ("int8_dgrad", K10_SOURCE, K10_REPLACES,
             launches["w8a8d"]["k10"], quant_err["k10"],
             quant_times["k10"][QUANT_ROW_SHAPE])):
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": count,
                     "max_abs_err": err, "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    print(f"chip_smoke.py ran {time.perf_counter() - t_start:.1f} s, the "
          f"kernels' build included", flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
