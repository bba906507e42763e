#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths, its trainer, and the
stages before and after it, on one NVIDIA card and check them.

Both paths run from cached video tokens and from raw frames through the
vision towers.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card
    python3 chip_smoke.py --trainer DIR     # phase 9t alone, under DIR
    python3 chip_smoke.py --after-train DIR # phase 9p alone, on 9t's DIR
    python3 chip_smoke.py --extract DIR     # phase 9e alone, under DIR
    python3 chip_smoke.py --remat DIR       # phase 8r alone (DIR is not written)
    python3 chip_smoke.py --from-jax DIR    # phase 9j alone, under DIR
    python3 chip_smoke.py --full-width DIR  # phase 9w alone, under DIR
    python3 chip_smoke.py --quality DIR     # phase 9q alone, under DIR
    python -m torch.distributed.run --standalone --nproc_per_node=1 chip_smoke.py --sharded DIR
        # phase 9d (a)-(c) alone; --sharded-pair with 2 processes for (d)
    python -m torch.distributed.run --standalone --nproc_per_node=2 chip_smoke.py --tensor-pair DIR
        # phase 9d (e) alone: mesh.tensor=2 on 2 processes of the one card (gloo)
    python -m torch.distributed.run --standalone --nproc_per_node=N chip_smoke.py --caches DIR
        # phase 9d (f) alone: the two caches at world 1 (NCCL) or on 2 processes of the one card (gloo)
    python3 chip_smoke.py --keep-table PATH
        # only the table tests/test_torch_keep_bytes.py holds the 32-bit
        # keep draw to, read from torch.rand on this card, written to PATH
    python3 chip_smoke.py --ring-issue ROOT [ROOT ...]
        # only the host's issue time of a fused ring pass, for the package
        # under each root in turn (e.g. a parent tree and this one), each
        # timed by the same code in a process of its own
    python3 chip_smoke.py --lora-calls ROOT [ROOT ...]
        # only the LoRA forward and dA calls' device time and kernels a
        # call, for the package under each root in turn, as --ring-issue
    python3 chip_smoke.py --lora-step ROOT [ROOT ...]
        # only phase 8's traced bf16 LoRA step (device time and kernels by
        # group), for the tree under each root in turn, each in its own process

Phases, each printed with its wall time; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of the paths with ``nvcc``, and flash_bwd.cu,
   flash_fwd.cu, lora_epilogue.cu and lora_dropout.cu with each of their cost probes, one
   process each, all at once (registers and spills per kernel; the flash
   kernels and the ring's must not spill);
3. each kernel against its plain PyTorch version at the paths' shapes:
   flash forward and backward (prep, main and post kernels) at the serving /
   training shapes, a ragged length and S = 4608 (where the reference takes
   its split backward), GQA groups 1, 2, 4 and 8, and a batch row with every
   key masked, with the prep's q_s and the post's dq bit for bit; the
   three LoRA dropout kernels at M = 6144, K = 4096 and 14336,
   in bits mode and in hash mode, the hash also from a global first row
   ``row0`` (a rank's rows of a split batch; dx exactly 0 where the mask
   drops; all three masks read back exactly through dx, and dA's hash and
   bits masks through dA; keep rate, seed determinism), the forward and dA
   on an M tail (M - 37 rows), and their plans (``_fwd_plan``,
   ``_da_plan``) against the clusters the card holds at once; the 32-bit
   rule's keep kernel at (6144, 4096) and (6144, 14336) against
   ``keep_bytes_plain`` on the card's grid and ``torch.rand(...) < 0.9``,
   bit for bit, and the three LoRA kernels in bits mode on its bytes at the
   rule's f32 scale against their plain versions; the row quant (both entry points) at
   (6144, 4096) and (6144, 14336) bf16 with a zero row, and at a row count
   that is not a multiple of 8, and at the vision tower's (20772, 1024) and
   (20772, 4096) (q and s bit for bit); the LoRA epilogue's
   forward, fused dz + dB, and dz and dB alone at M = 6144, r = 16, N =
   1024, 4096 and 14336 (two calls of each backward bit for bit; the
   forward's elements that differ from plain counted); the
   fused ring forward against its plain version on rings of 4 and 2 ranks
   on the card at B = 3, S_loc 512 and 500, with and without padded keys,
   and at S = 2048 on 2 ranks, one ring per n taking every case in turn
   (landing slots reused pass after pass), n(n-1)/2 chunk sends a pass; the
   flash kernels with causal offsets S_loc, 192, 64 and 0 at S_loc, and q
   tiles shorter than 128 rows (S 100, and S 300 at offset 64); and at the
   shapes one ``tensor`` rank gives each kernel: flash forward and backward
   at (3, 2048) with heads 16/4 (``tensor`` 2) and 4/1 (8), the LoRA
   dropout kernels from a first column ``col0`` = 2048 at K 2048 and 7168
   at K 7168 (a row-parallel o and down at ``tensor`` 2; the hash's columns
   read back exactly), the epilogue at N 2048, 512 and 7168, and the row
   quant's passes alone (``row_absmax``, ``row_quant_given``) at (6144,
   2048) and (6144, 7168), plain and scaled, each half of a whole row
   quantized with the maximum of the halves' maxima bit-equal to the whole
   row's codes and scale;
4. the full-width VLB model (the CLIP ViT-L/14-336 tower's 23 layers, the
   STC connector and the 32-layer Mistral-7B, bf16), made on the card from a
   seeded generator;
5. ``predict_batches`` over 3 synthetic batches of 5, with every kernel's
   launch count read around that run alone;
6. one more served batch under ``torch.profiler``: device time by kernel
   and by group, and the device's idle share; then (6b) that batch again
   through the fused ring (``attention_impl='ring_fused'`` on 4 ranks of the card,
   switched on the same model), held against phase 5's predictions;
6v. 3 batches of 5 served from frames made on the card (12 x 3 x 336 x 336
   each) through the same model's towers, with launch counts; the same
   batches fed the tokens ``encode_video`` gives for their frames (the
   predictions held against the frames path's); ``encode_video``'s device
   time per batch (CUDA events) and its share of the batch's; one more
   batch traced, with the ``vision`` group (the kernels launched inside
   ``encode_video``'s ``record_function`` range) and the idle share;
7. the full-width LoRA model (r 16, alpha 32, fused u8 dropout 0.1, remat
   per layer): 3 steps of ``train_batches`` at batch 3, launch counts
   against what the code implies, gradients reaching layer 0's adapters;
8. one more LoRA step under ``torch.profiler``; then, on the same weights,
   3 steps with the fused LoRA epilogue (``fused_epilogue='pallas'``), so
   the step time with the flag off and on come from one run; then (8v) 3
   steps from frames on the same weights (launch counts, adapter
   gradients), one more traced, and its batch's ``encode_video`` traced
   with the ``vision`` group (the vision share of the step); then (8c)
   phase 7's starting adapters again, for 3 steps through the fused ring
   on 4 ranks of the card (first loss and gradient norm against phase 7's,
   launch counts) and one more under ``torch.profiler``, and 2 steps
   through the per-step flash ring;
8r. the decoder's checkpoint policies (``remat_policy``) on phase 7's
   weights: full-width LoRA models (bf16, r 16, fused u8 dropout, batch 3
   from cached tokens), the packed path (32 layers), and at phase 7's
   first 8 layers the packed path with the fused epilogue and each ring
   (``'ring_fused'``, ``'ring_flash'``, on 4 ranks of the card), each switched in place to each of ``'nothing'``
   (twice), ``'attn'``, ``'mids'``, ``'flash'`` and ``'dots'``, 2 steps
   each from phase 7's starting adapters and seeds, the second traced
   (device busy time and idle share): each kernel's launches against what
   the JAX grad's jaxpr runs for the policy (32 flash forwards and 224
   ``lora_fwd`` a step under ``'flash'`` on the packed path, a quarter
   of each at 8 layers; under a ring
   the ring's passes run again under every policy; with the fused
   epilogue 13 ``epi_fwd`` a layer a step: the replay runs neither the last
   projection's base product nor its epilogue), the first loss bit-equal across policies, the step-1
   adapter gradients against the first ``'nothing'`` run's within 1.25
   times the gap of the two ``'nothing'`` runs (dq's reduce-adds sum in a
   run-dependent order), step 1's ms (a synchronised host clock) and
   peak device memory (``device_memory_stats``); then one step each of the
   trainer's unfused 32-bit dropout under ``'nothing'`` and ``'mids'``
   (the keep kernel's route): the first loss bit-equal, each kernel's
   launches, and the mids (``lora_fwd`` launches) ``'mids'`` keeps, 7 a
   layer;
8b. the w8a8g8 LoRA step of record: phase 7's weights quantized to int8 on
   the card in place, projection by projection (the tower's too), then 3
   steps at batch 3
   with the fused epilogue (launch counts of every kernel but the ring's,
   non-zero adapter gradients, peak device memory), and one more under
   ``torch.profiler`` (with the epilogue group's device time and
   ``epi_fwd``'s);
9. the frozen-baseline regime: 3 steps at batch 5, only the head trains;
9t. the trainer users run (``vlb-train`` through the port), in a process of
   its own (``--trainer DIR``; its peak host RSS held to the same bound):
   ``experiment=vlb_friends_lora subject=sub-01`` composed by the port's
   config reader with ``trainer.max_epochs=2 trainer.val_check_interval=0.5
   trainer.log_every_n_steps=2`` and a temporary ``output_dir``, through
   ``build_trainer`` at full width and ``VLBTrainer.fit`` over 4 train and
   2 val batches of 3 from frames made on the card (8 steps, 4
   validations): metrics.csv (train rows at steps 2/4/6/8, 4 val rows of
   1000 ROI columns, ``lr-AdamW`` = ``learning_rate(cfg, step)``), the best
   checkpoint at the least val loss, ``last``, the adapters (head and
   ``lora_*`` only), the launches the code implies (flash; the keep kernel
   and the LoRA kernels of the 32-bit unfused route: keep and forward 14
   a layer a step, dx 7 less layer 0's q, k, v, dA 7; none of another
   kernel), step, validation and save ms, save bytes and peak device
   memory; a fresh trainer with ``max_epochs=3`` resumed from ``last``
   (tensors and AdamW state bit-equal) that ends at step 12;
   ``vlb_friends_baseline`` at batch 5, 1 epoch of 3 batches (head tensors
   only in ``last`` and the adapters); at narrow width the NaN-streak abort
   at step 5 with the state of step 2, and HF-keyed safetensors shards
   (written by ``write_safetensors``) through ``load_pretrained_params``,
   their predictions bit-equal to the same weights' through
   ``from_state_dict``;
9p. the stages after the trainer, in a process of its own (``--after-train
   DIR``, on 9t's DIR; its peak host RSS held to the same bound), from
   frames made on the card from seed 0, at full width, only batch counts
   cut: (a) ``predict_split`` composed like ``vlb-predict-torch
   experiment=vlb_friends_lora subject=sub-01 predict.checkpoint=<9t's
   last>`` over 9t's 2 val batches of 3 (32 flash forwards a batch, no
   other kernel; per-ROI r against 9t's val row at the step ``last``
   holds); (b) ``build_cached_trainer`` for ``vlb_friends_baseline
   model.cache_features=true`` at batch 5 over 3 train and 1 val batches
   into in-memory stores (128 flash forwards in the build, none while the
   head trains; 1247 x 4096 f16 a sample; one batch's cached-head
   predictions against the full forward), then the head trained 2 epochs
   with its validations; (c) ``vlb_friends_lora``'s clips through
   ``encode_tokens`` (bit-equal to ``encode_video``), then 2 LoRA steps
   from the cached tokens against 2 from the frames on the same weights
   and seeds, beside 2 more from the frames (first loss bit-equal;
   gradients and second loss within tolerance, each gap printed beside
   frames against frames; launch counts); (d) ``vlb-brainmaps-torch`` over 9t's
   metrics.csv with an atlas of one label per ROI written by
   ``save_nifti`` (an HTML and a volume a val row, each parcel its r²).
   Where ``h5py`` imports, (a)-(c) also write and read the files;
9j. a run of the JAX trainer resumed on the card, in a process of its own
   (``--from-jax DIR``): a JAX ``TrainState``'s raw tree at full width from
   a numpy seed (flax layouts, the decoder stacked in ``layers_scan``:
   rank-16 adapters on the 7 projections of the 32 layers and the head,
   AdamW's ``mu`` and ``nu``, the counts at step 5) and a
   ``trainer_state.json``, converted by ``train/from_jax.py`` (the card's
   machine has no orbax: the tree is handed over in place of Orbax's
   reader); ``vlb_friends_lora model.lora_fused_dropout=true`` resumed from
   the converted root through ``build_trainer`` and ``maybe_resume``:
   tensors and both moments bit-equal to the tree laid out by hand, the
   step, AdamW's per-tensor steps and the rate the schedule's; one LoRA
   step from frames (the launches the code implies) and one val batch
   served; the same step from the same tensors handed to a trainer
   directly (``load_params``, ``load_state_dict``), FROM_JAX_DIRECT_RUNS
   times: the first loss bit-equal, the gradient norm within
   FROM_JAX_NORM_TOL, the updated parameters within
   FROM_JAX_UPDATE_FLOOR_RATIO times the largest gap between two direct
   runs from each; the conversion's seconds and bytes;
9w. full-width weights in HF layout, in a process of its own
   (``--full-width DIR``): a random 4-layer Mistral-7B with the CLIP
   tower (24 layers and ``post_layernorm``) and the STC connector, under
   VideoLLaMA2's keys (and ``lm_head``), made on the card and written by
   the port's safetensors writer; ``vlb_friends_baseline
   model.checkpoint_path=DIR/hf`` (the decoder cut to 4 layers) built in
   bf16 through ``load_pretrained_params``, and the same shards in f32;
   one batch of 2 from frames at S = 2048 through each, the bf16 one on
   the hand kernels (4 flash forwards), the f32 one on the plain attention
   with TF32 off: each decoder layer's output, the final norm, the video
   tokens and the predictions within FULL_WIDTH_TOL;
9q. the two quality-run scripts at full width through their own
   functions, in a process of its own (``--quality DIR``), only their
   counts cut: (a) ``scripts/quant_quality_run_torch.py`` (32 layers,
   batch 6, frames, a bf16 teacher, the bf16, w8a8 and w8a8g8 students, 3
   steps over 2 train batches, 1 val batch): the targets finite, every
   student's start bitwise the teacher's, the int8 codes and scales the
   teacher's base quantized (fingerprints of their bits), w8a8's and
   w8a8g8's first losses bit-equal, each step's and evaluation's launches
   against what the code implies (no LoRA kernel at dropout 0; the
   decoder's and the tower's row quants), the JSON lines' keys; (b)
   ``scripts/plateau_run_torch.py --layers 32 --plant self --configs
   bf16,w8a8g8`` over 2 train and 1 val batch of 6 for 2 epochs, then
   ``--probe`` on the same data: the tokens encoded once (one
   ``encode_video`` a batch, no hand kernel in the bf16 towers, none in the
   fits), the pooled reps finite with a forward's launches a batch, each
   fit's launches, one CSV row an epoch, the records' keys; step ms, peak
   device memory and the process's peak host RSS;
9e. the first two stages users run, in a process of its own (``--extract
   DIR``; its peak host RSS held to the same bound), at the geometry of
   record (TR 1.49 s, 4 frames a TR, window 3, 336 px, 866 text ids, 64
   onsets), only the episodes and TRs cut: (a) a season of 2 episodes (11
   and 8 TRs; transcript and scene TSVs written under DIR and read by
   ``read_tsv``; 720x480 frames at 29.97 fps made from the seed when asked
   for) through ``extract_episode`` with ``DevicePreprocessor`` on the card
   and the ``SentencePieceTestTokenizer`` (joiner counts validated), each
   episode checked and written into an in-memory features store as
   ``extract_features`` writes it, a second pass writing nothing; the
   card's preprocessed frames against ``preprocess`` on the CPU; (b) a
   1000-parcel BOLD store and ``build_lazyload_dsets`` into 2 in-memory
   lazy-load stores (every sample's rows bit-equal to its source rows);
   (c) the features store released, ``vlb_friends_lora`` at batch 3 with
   ``trainer.max_epochs=1``: ``build_trainer`` over ``BatchLoader``s of
   those stores, 2 steps and 2 validations with the launches the
   code implies, the first step's loss bit-equal to the same batch
   collated from the source arrays and fed to ``train_batches`` from the
   same adapters and seed. The native libav decoder is not built there
   (the card's machine has no libav headers); the CPU tests hold it;
9d. the trainer of record across processes: ``torch.distributed.run
   --standalone --nproc_per_node=1 chip_smoke.py --sharded DIR`` (NCCL,
   one process a card): (a) ``vlb_friends_lora subject=sub-01
   mesh.fsdp=-1`` from frames at full width, 1 epoch of 2 steps and a
   validation, FSDP2 over the world (59 units), against the unsharded
   trainer on the same weights, frames and seeds: the first loss bit-equal,
   the step-1 adapter gradients bit-equal or at the floor of two unsharded
   runs (printed beside it), the launches of the fit, the units'
   parameters plain, contiguous and 16-byte aligned while they run; (b)
   each trainer's ``last`` restored by the other, bit-equal; (c) one
   sharded step with ``model.lora_fused_dropout=true`` (its LoRA kernels'
   launches); the 32-bit masks' cost a step (the keep kernel) as a rank's
   draw of the global batch; step ms, peak device memory and each rank's peak host
   RSS. (d) with 2 cards, ``--sharded-pair`` on 2 processes at
   ``datamodule.batch_size=4`` against one card at 4; otherwise it prints
   that (d) was skipped. (e) ``mesh.fsdp=1 mesh.tensor=2`` on 2 processes
   that share the one card, their collectives over gloo on CUDA tensors
   (NCCL refuses two ranks on one device; ``--tensor-pair``):
   ``vlb_friends_lora`` with the fused u8 dropout at full width (the
   decoder cut to RANK_LAYERS = 8 layers in (e) and (f)) from cached
   tokens, 1 epoch of 2 steps and a validation, each rank's decoder the
   rank's 16 of 32 heads, 4 of 8 kv heads and 7168 of the MLP's 14336,
   against one process on the same batches (first loss and step-1 adapter
   gradients within tolerance, the gradients beside the floor of two
   one-process runs); then one ``model.base_quant=w8a8g8`` step against one
   process (its first loss bit-equal: fresh adapters add nothing, and the
   int8 products sum their int32 partials). Each rank's launches against
   what the code implies (the row-parallel quants through the split
   kernel pair), its peak device memory and step ms, printed as a check
   through host-staged gloo, not as a speed of tensor parallelism. (f) the
   two caches under ``--caches``, at world 1 over NCCL (``mesh.fsdp=-1``)
   and on 2 processes of the one card over gloo (``mesh.data=2
   mesh.fsdp=1``: each rank 2 rows of each batch of 4), at full width (8
   layers) from
   frames made on the card, 1 train and 1 val batch of 4: (f1)
   ``vlb_friends_baseline model.cache_features=true`` through
   ``build_cached_trainer`` into in-memory stores (each rank runs the
   backbone over its rows of every batch: 32 flash forwards a batch; the
   rows gathered, every rank's stores the same bytes), then the head's fit
   over them on the sharded step; (f2) ``vlb_friends_lora
   datamodule.vision_token_cache`` through ``build_trainer`` over native
   loaders of in-memory lazy-load stores into an in-memory sidecar store
   (no kernel launched; every rank's the same bytes), then a LoRA fit from
   its tokens. Rank 0 builds and fits each in one process on the same
   batches: the features and tokens bit-equal to one process's built over
   the same rows a forward (a rank's), their gap to one process's over 4
   printed (the ranks' backbone runs 2 rows where one process runs 4, and
   cuBLAS's kernels for the shape round otherwise), the fingerprints
   equal, the head's and the LoRA fit's first loss within TOKEN_LOSS_TOL
   and step-1 gradients within TOKEN_GRAD_TOL (the LoRA fit's as (e)
   holds them); each rank's launches, peak device memory and host RSS;
9v. one batch of 5 served from frames through a w8a8g8 frozen model (its
   decoder's and its tower's projections int8): ``row_quant`` launched once
   for each of the 7 x 32 decoder and 6 x 23 tower projections;
10. narrow models (same geometry, 2 layers, 256 wide) on the card against
    the same weights in f32 on the CPU: served predictions (from cached
    tokens, and from frames through narrow towers: 2 CLIP layers 256 wide
    and an STC of depth 1, the video tokens compared too), the LoRA loss
    and adapter gradients of one step (packed, and through the fused ring
    on 2 ranks of the card), and the same for a w8a8g8 LoRA step (the same
    int8 weights on both sides);
11. timings: each kernel's device time (``torch.profiler``), its wrapper's
    (device and CUDA events), its plain version's and a library yardstick's,
    beside the bound, at the one-card shapes and (printed only) at one
    ``tensor`` rank's (``time_tensor_shapes``); for the LoRA forward and dA
    also the whole call's device time against the bound and the kernels a
    call (one), and each against its cost probe without the mask; the keep
    kernel against its plain draw and ``torch.rand`` with the compare, and
    the three LoRA kernels in bits mode at the 32-bit rule's scale against
    the eager route's ops (printed only); SDPA's
    ``is_causal`` forward beside the masked one;
    the flash backward as the sum of its three kernels against SDPA's whole
    backward (the kernels it ran named), and SDPA with ``is_causal=True``,
    at (3, 2048) and (1, 4608); one pass of the fused ring (first send to
    last output) and each rank's kernel, beside SDPA over the whole
    sequence (masked and ``is_causal``) and the per-step flash ring's
    forward, with the host's issue time of a pass split into Python and the
    C launcher and the chunk sends a pass (a process of its own times 50
    passes after 10 and divides); ``torch._int_mm`` in each weight
    layout against bf16 ``F.linear`` at 6144 x 4096 -> 14336; the flash
    forward and the flash backward's main kernel against their cost probes
    (printed only); the epilogue's forward against ``addmm`` with its
    grid, its fused dz + dB against both ``addmm`` calls, and dz and dB
    alone against one each, with their f32 partial bytes, each with its
    share of the byte bound, and the fused kernel against its cost probe
    (printed only); the CLIP tower per frame and the STC connector per clip
    (phase 4's towers, 5 clips), SDPA at (60, 16, 577, 64), the 4096-channel
    depthwise 3x3 and the sampler's Conv3d, each beside its bound (printed
    only);
12. peak host RSS (peak device memory is printed in phases 5, 6v, 7, 8v and
    11).

The last two lines of standard output are the kernels' JSON record and the
device JSON record. Without a card it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import csv
import ctypes
import dataclasses
import faulthandler
import gc
import hashlib
import importlib.util
import io
import json
import math
import os
import resource
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.fsdp import FSDPModule
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from phantom_vlb_tpu_torch.cli.brainmaps import main as brainmaps_main
from phantom_vlb_tpu_torch.cli.predict import predict_batches, predict_split, synthetic_batches, write_predictions
from phantom_vlb_tpu_torch.core.config import load_config
from phantom_vlb_tpu_torch.core.distributed import (
    MULTI_CARD_OPT_IN, maybe_initialize_distributed, shutdown_distributed)
from phantom_vlb_tpu_torch.core.geometry import REFERENCE_GEOMETRY
from phantom_vlb_tpu_torch.core.mesh import AXIS_NAMES, MeshEnv, SequenceRing, set_sequence_ring
from phantom_vlb_tpu_torch.core.remat import REMAT_POLICIES
from phantom_vlb_tpu_torch.data.extract import extract_episode
from phantom_vlb_tpu_torch.data.hrf import get_hrf_weights
from phantom_vlb_tpu_torch.data.lazyload_build import LazyloadBuildConfig, build_lazyload_dsets, infer_geometry
from phantom_vlb_tpu_torch.data.loader import BatchLoader, LazyDataset, batch_fields, split_train_val
from phantom_vlb_tpu_torch.data.schemas import (
    LazySample,
    MemoryStore,
    bold_episode_keys,
    lazyload_len,
    list_feature_episodes,
    write_feature_episode,
)
from phantom_vlb_tpu_torch.data.synthetic import write_synthetic_bold_file
from phantom_vlb_tpu_torch.data.text import SentencePieceTestTokenizer, read_tsv, validate_joiner_counts
from phantom_vlb_tpu_torch.data.token_cache import TokenCachedDataset, dataset_fingerprint, encode_tokens
from phantom_vlb_tpu_torch.models.clip_vit import CLIPVisionConfig
from phantom_vlb_tpu_torch.models.convert import hf_key, init_params, write_safetensors
from phantom_vlb_tpu_torch.models.lora import LoRAConfig, keep_rows
from phantom_vlb_tpu_torch.models import mistral as mistral_module
from phantom_vlb_tpu_torch.models.mistral import MistralConfig, set_attention_impl, set_remat_policy
from phantom_vlb_tpu_torch.models.stc_connector import STCConfig
from phantom_vlb_tpu_torch.models.videollama2 import (
    VISION_PREFIXES,
    VLBConfig,
    VideoLLaMA2VLB,
    trainable_parameters,
    trainable_predicate,
)
from phantom_vlb_tpu_torch.ops._build import CudaKernel, build_all
from phantom_vlb_tpu_torch.ops.context_parallel import ring_flash_fwd
from phantom_vlb_tpu_torch.ops.flash_attention import (
    FLASH_BWD,
    FLASH_BWD_POST,
    FLASH_BWD_PREP,
    FLASH_FWD,
    attention_packed,
    attention_packed_bwd,
    attention_packed_bwd_plain,
    attention_packed_plain,
    attention_with_stats,
    bwd_padded_len,
    flash_bwd_post,
    flash_bwd_post_plain,
    flash_bwd_prep,
    flash_bwd_prep_plain,
    kv_bias,
)
from phantom_vlb_tpu_torch.ops.lora_epilogue import (
    EPI_DB,
    EPI_DZ,
    EPI_DZDB,
    EPI_FWD,
    lora_epilogue_db,
    lora_epilogue_db_plain,
    lora_epilogue_dz,
    lora_epilogue_dz_plain,
    lora_epilogue_dzdb,
    lora_epilogue_dzdb_plain,
    lora_epilogue_fwd,
    lora_epilogue_plain,
    partial_bytes,
    _fwd_grid,
    _padded_rank,
)
from phantom_vlb_tpu_torch.ops.lora_fused import (
    CLUSTER_SIZES,
    H100_CLUSTERS,
    LORA_DA,
    LORA_DX,
    LORA_FWD,
    LORA_KEEP,
    _card_threads,
    _cluster_capacity,
    _da_plan,
    _fwd_plan,
    dropout_rule,
    dropout_threshold,
    fused_dropout_bwd,
    fused_dropout_bwd_plain,
    fused_dropout_matmul,
    fused_dropout_matmul_plain,
    hash_bytes,
    keep_bytes,
    keep_bytes_plain,
    plan_smem_bytes,
)
from phantom_vlb_tpu_torch.ops.preprocess import DevicePreprocessor, preprocess
from phantom_vlb_tpu_torch.ops.quant import is_base_projection, quantize_int8, quantize_state_dict
from phantom_vlb_tpu_torch.ops.ring_fused import RING_FWD, RING_STATS, ring_fwd, ring_fwd_plain, ring_send_plan
from phantom_vlb_tpu_torch.ops.rowquant import (
    ROW_ABSMAX,
    ROW_QUANT,
    ROW_QUANT_GIVEN,
    ROW_QUANT_SCALED,
    row_absmax,
    row_absmax_plain,
    row_quant,
    row_quant_given,
    row_quant_given_plain,
    row_quant_plain,
    row_quant_scaled,
    row_quant_split,
)
from phantom_vlb_tpu_torch.parallel.sharding import whole
from phantom_vlb_tpu_torch.postprocessing.nifti import NiftiImage, load_nifti, save_nifti
from phantom_vlb_tpu_torch.train.builder import (
    build_cached_trainer,
    build_model,
    build_model_config,
    build_trainer,
    load_pretrained_params,
    split_loaders,
)
from phantom_vlb_tpu_torch.train import builder as train_builder
from phantom_vlb_tpu_torch.train.checkpoint import ADAPTERS_FILE, STATE_FILE
from phantom_vlb_tpu_torch.train.loop import TrainLoopConfig, VLBTrainer, is_adapter, train_batches
from phantom_vlb_tpu_torch.train.from_jax import convert as convert_from_jax
from phantom_vlb_tpu_torch.train.metrics import CSVMetricsLogger, NullMetricsLogger
from phantom_vlb_tpu_torch.train.optim import AdamWCosine, OptimConfig, learning_rate
from phantom_vlb_tpu_torch.train.precompute import build_feature_cache, head_forward
from phantom_vlb_tpu_torch.train.step import loss_fn
from phantom_vlb_tpu_torch.utils.profiling import device_memory_stats

ROOT = Path(__file__).resolve().parent
BUILD_ROOT = ROOT / "build"          # ignored by git: the kernels' libraries and scratch output
SEED = 0
BATCH = 5                 # configs/experiment/vlb_friends_baseline.yaml
LORA_BATCH = 3            # configs/experiment/vlb_friends_lora.yaml:14
N_BATCHES = 3
HQ, HKV, D = 32, 8, 128
LORA_M, LORA_KS, LORA_R, LORA_P = LORA_BATCH * 2048, (4096, 14336), 16, 0.1
LORA_ROW0 = 2 * 2048 + 77      # a global first row for the hash mask, off every tile edge
LORA_TAIL = 37                 # phase 3's M tail: rows LORA_M - LORA_TAIL, off the 64-row tile
LORA_KEEP_SEEDS = (5, 2 ** 31 + 11)   # phase 3's 32-bit keep bytes: a small seed and one past 32 bits
EPI_NS = (1024, 4096, 14336)   # k/v, q/o/down, gate/up output widths
# What one rank of mesh.tensor=2 gives the kernels: the row-parallel o and
# down read columns [K, 2K) of the input (rank 1), K = 2048 and 7168; the
# column-parallel q, k/v and gate/up write N = 2048, 512 and 7168 columns;
# the attention runs 16 of 32 heads (4 of 8 kv), and at tensor 8, 4 (1).
TENSOR = 2
TENSOR_LORA = ((2048, 2048), (7168, 7168))          # (K, col0)
TENSOR_EPI_NS = (2048, 512, 7168)
TENSOR_HEADS = ((16, 4), (4, 1))
# The vision tower's projections at batch 3: 12 frames of 577 tokens (not a
# multiple of 8 rows), at its two input widths.
TOWER_ROWS = LORA_BATCH * REFERENCE_GEOMETRY.num_frames * (REFERENCE_GEOMETRY.patch_grid ** 2 + 1)
TOWER_WIDTHS = (1024, 4096)
KERNELS = {"flash_fwd": FLASH_FWD, "flash_bwd_prep": FLASH_BWD_PREP, "flash_bwd": FLASH_BWD,
           "flash_bwd_post": FLASH_BWD_POST,
           "lora_fwd": LORA_FWD, "lora_dx": LORA_DX, "lora_da": LORA_DA, "lora_keep": LORA_KEEP,
           "row_quant": ROW_QUANT, "row_quant_scaled": ROW_QUANT_SCALED,
           "row_absmax": ROW_ABSMAX, "row_quant_given": ROW_QUANT_GIVEN,
           "epi_fwd": EPI_FWD, "epi_dz": EPI_DZ, "epi_db": EPI_DB, "epi_dzdb": EPI_DZDB,
           "ring_fwd": RING_FWD}
# flash_bwd.cu built with each of its cost probes (see its header): the main
# kernel without a part, or in another block order; timed in phase 11 only.
BWD_PROBES = {name: CudaKernel("flash_bwd.cu", "flash_bwd_launch", FLASH_BWD.argtypes,
                               defines=(f"FLASH_BWD_PROBE_{name.upper()}",))
              for name in ("no_dq_reduce", "no_exp", "grouped")}
# flash_fwd.cu built with each cost probe of its core (see attn_fwd.cuh):
# the exponential or the P V product left out; timed in phase 11 only.
FWD_PROBES = {name: CudaKernel("flash_fwd.cu", "flash_fwd_launch", FLASH_FWD.argtypes,
                               defines=(f"ATTN_FWD_PROBE_{name.upper()}",))
              for name in ("no_exp", "no_pv")}
# The epilogue's backward built with its cost probe (see lora_epilogue.cu):
# the fold left out; timed in phase 11 only.
EPI_NO_FOLD = CudaKernel("lora_epilogue.cu", "epi_dzdb_launch", EPI_DZDB.argtypes,
                         defines=("EPI_DZDB_PROBE_NO_FOLD",))
# The LoRA forward and dA built with the mask and scale left out (wrong on
# purpose): what the mask costs, and what the TMA stream alone reaches;
# timed in phase 11 only.
LORA_NO_MASK = {name: CudaKernel("lora_dropout.cu", f"{name}_launch", LORA_FWD.argtypes,
                                 defines=("LORA_DROPOUT_PROBE_NO_MASK",)) for name in ("lora_fwd", "lora_da")}
REPLACES = {
    "flash_fwd": ("flash_fwd.cu", "phantom_vlb_tpu/ops/flash_attention.py:93"),
    "flash_bwd_prep": ("flash_bwd.cu", "phantom_vlb_tpu/ops/flash_attention.py:509"),
    "flash_bwd": ("flash_bwd.cu", "phantom_vlb_tpu/ops/flash_attention.py:284"),
    "flash_bwd_post": ("flash_bwd.cu", "phantom_vlb_tpu/ops/flash_attention.py:351"),
    "lora_fwd": ("lora_dropout.cu", "phantom_vlb_tpu/ops/lora_fused.py:62"),
    "lora_dx": ("lora_dropout.cu", "phantom_vlb_tpu/ops/lora_fused.py:92"),
    "lora_da": ("lora_dropout.cu", "phantom_vlb_tpu/ops/lora_fused.py:111"),
    "lora_keep": ("lora_dropout.cu", "phantom_vlb_tpu/models/lora.py:83"),
    "row_quant": ("rowquant.cu", "phantom_vlb_tpu/ops/rowquant.py:35"),
    "row_quant_scaled": ("rowquant.cu", "phantom_vlb_tpu/ops/rowquant.py:45"),
    "row_absmax": ("rowquant.cu", "phantom_vlb_tpu/ops/rowquant.py:35,45"),
    "row_quant_given": ("rowquant.cu", "phantom_vlb_tpu/ops/rowquant.py:35,45"),
    "epi_fwd": ("lora_epilogue.cu", "phantom_vlb_tpu/ops/lora_epilogue.py:45"),
    "epi_dz": ("lora_epilogue.cu", "phantom_vlb_tpu/ops/lora_epilogue.py:51"),
    "epi_db": ("lora_epilogue.cu", "phantom_vlb_tpu/ops/lora_epilogue.py:69"),
    "epi_dzdb": ("lora_epilogue.cu", "phantom_vlb_tpu/ops/lora_epilogue.py:51,69"),
    "ring_fwd": ("ring_fwd.cu", "phantom_vlb_tpu/ops/ring_fused.py:48"),
}
RING_RANKS = 4            # the sequence ring on one card: S_loc = 512 at S = 2048
# bf16 kernel vs f32 plain on the same bf16 inputs (q pre-scaled in bf16 on
# both sides): out is bf16 (2^-8 relative at |out| <= ~1, plus bf16 P in the
# PV product); lse sums f32 scores that differ only in order.
OUT_TOL, LSE_TOL = 2e-2, 1e-3
# Flash backward vs its plain version, max|err| / max|ref| of dq, dk, dv:
# bf16 outputs (2^-9) and bf16 p and ds, whose roundings may flip where the
# kernel's exp2 and the plain exp differ by an ulp.
BWD_REL_TOL = 2e-2
# The backward's prep kernel's di against its plain version, max|err| /
# max|ref|: f32 sums of 128 products in another order (~128 * 2^-24).
DI_REL_TOL = 1e-5
# Kernels of the backward, by the names the profiler gives them.
BWD_PARTS = {"flash_bwd_prep": "flash_bwd_prep_kernel", "flash_bwd": "flash_bwd_kernel",
             "flash_bwd_post": "flash_bwd_post_kernel"}
# LoRA kernels vs plain, max|err| / max|ref|: mid and dx are bf16 (one
# rounding after f32 sums in another order), dA is f32 (order only).
MID_REL_TOL, DX_REL_TOL, DA_REL_TOL = 1e-2, 1e-2, 1e-3
KEEP_RATE_TOL = 1e-3
# Narrow bf16 model on the card vs the same weights in f32 on the CPU: two
# layers of bf16 activations (2^-8 relative each) ahead of an f32 head whose
# predictions have unit scale.
PRED_TOL = 1e-1
# The same for one LoRA step, as |err| / |ref| of the loss and max|err| /
# max|ref| over all adapter gradients: bf16 activations and gradients
# through two layers, and the dropout scale 1/keep rounded to bf16 on the
# card (1.109375) but not in f32 (1.113043).
LORA_LOSS_TOL, LORA_GRAD_TOL = 1e-3, 5e-2
# Epilogue kernels vs plain, max|err| / max|ref|: bf16 outputs after f32
# sums in another order (the forward also rounds acc and acc * s to bf16).
EPI_REL_TOL = 1e-2
# Narrow w8a8g8 LoRA step, card (bf16) vs CPU (f32) on the same int8
# weights: the loss as |err| / |ref|, each adapter gradient by its cosine
# (the bound of tests/test_quant.py:227-276 for int8 against exact dx): the
# activations' int8 codes differ where bf16 and f32 values straddle a .5.
W8_LOSS_TOL, W8_GRAD_COS = 5e-3, 0.98
# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, f32 outside
# them, and HBM3.
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 989e12, 67e12, 3.35e12
# Serving through the fused ring against phase 5's predictions for the same
# batch, max|err| / max|pred|: the two attentions sum in another order and
# round their bf16 outputs differently, through 32 bf16 layers ahead of
# the f32 head.
RING_PRED_TOL = 5e-2
# A ring LoRA step's first loss and gradient norm against phase 7's, |err| /
# |ref|: the same weights, batch and dropout masks; only the attention's
# summation order and bf16 roundings differ (and the flash backward's dq
# reduce-adds sum in a run-dependent order).
RING_STEP_TOL = 2e-2
# The full-width model served from frames against the same model fed the
# tokens its encode_video gives for those frames, max|err| / max|pred|: the
# same kernels on the same inputs, so bit-equal is expected; 1e-6 would
# still catch any token that reached the decoder otherwise.
FRAMES_TOKENS_TOL = 1e-6
# Narrow towers on the card (bf16) against the same weights in f32 on the
# CPU, the video tokens as max|err| / max|ref|: bf16 activations (2^-8
# relative each) through the patch conv, 2 CLIP layers and an STC block of
# four convolutions, each after a LayerNorm whose output is rounded to
# bf16, then the 2-layer readout. The predictions keep PRED_TOL.
NARROW_TOKENS_TOL = 5e-2
# Phase 9p's predict sweep against 9t's validation at the step ``last``
# holds, per-ROI r absolute: the same weights, batches, shapes and kernels,
# so bit-equal is expected (the CSV's text holds an f32 value whole); 1e-6
# would still catch another checkpoint or other batches.
PREDICT_CORR_TOL = 1e-6
# The head over the feature cache against the full forward on the same
# batch, max|err| / max|ref|: at full width the backbone's bf16 hidden
# states convert to f16 exactly, so only the head's f32 pooling sums (1247
# against 2048 terms, the rest weighted 0) may run in another order, ~2^-24
# sqrt(2048) ~ 3e-6 relative (runs t1, f1, fx read 0.0). One cached
# position of the 1247 misplaced or misweighted moves the pool by ~1e-3.
CACHED_HEAD_TOL = 1e-5
# 2 LoRA steps from cached tokens against 2 from the same frames, the same
# weights and dropout seeds, beside 2 more from the frames (the floor): the
# first loss bit-equal in all three (the forward sees the same bits); step
# 1's adapter gradients, all of them as one vector, as |err| / |ref|
# (2-norms), and step 2's loss as |err| / |ref|. The flash backward's dq
# reduce-adds sum in a run-dependent order and bf16 roundings of the 32
# layers' gradients then flip, so frames against frames differ too: on an
# H100 both gaps read 6.79e-3 and 6.81e-3 by 2-norm, and single flips put
# the largest per-tensor max|err| / max|ref| at 1.86e-2 for the floor and
# 1.73e-2 for the tokens (printed, not held). Each gap is held within
# TOKEN_GRAD_TOL, and the tokens' within TOKEN_FLOOR_RATIO times the floor.
TOKEN_GRAD_TOL, TOKEN_FLOOR_RATIO, TOKEN_LOSS_TOL = 1e-2, 1.25, 1e-3
# Phase 9j: a step resumed from a converted JAX state against the same step
# from the same tensors handed over directly. The first loss is a forward
# of the same bits, so bit-equal. The backward sums dq's reduce-adds in a
# run-dependent order: the gradient norm, one scalar, moved 1.4e-6 to
# 2.1e-5 (at 5.13) between two direct runs in four calls, so it is held to
# FROM_JAX_NORM_TOL relative (~25x the widest); the parameters after the
# update, where the moments enter (a moment mapped wrong moves every
# update by its own size), are held as a whole by 2-norm: the resumed
# run's gap to each of FROM_JAX_DIRECT_RUNS direct runs within
# FROM_JAX_UPDATE_FLOOR_RATIO times the floor, the largest gap between two
# of them. (One pair's gap alone, as a floor, read 4.0e-4 and 5.4e-4 in
# two calls: the resumed run then stood 1.51x and 2.07x from it.)
FROM_JAX_NORM_TOL = 1e-4
FROM_JAX_UPDATE_FLOOR_RATIO = 2.0
FROM_JAX_DIRECT_RUNS = 4
# Phase 9w: the bf16 hand-kernel forward of a full-width checkpoint against
# the f32 plain forward of the same shards on the card (TF32 off), each
# decoder layer's output, the final norm, the video tokens and the
# predictions as |err| / |ref| by 2-norm: bf16 activations round at 2^-9 a
# time, ~10 times a layer on the residual path (norm, q/k/v, attention, o,
# residual, gate/up, SiLU product, down), adding in quadrature to ~1.3e-2
# over 4 layers; the tower's 23 layers and the STC's convolutions round as
# often, each after an f32 LayerNorm (narrow towers on the CPU: 1.1e-2).
# The bound is ~4x that estimate.
FULL_WIDTH_TOL = 5e-2
HOST_RSS_LIMIT_GB = 8.0
GEMM_MARKERS = ("gemm", "cutlass", "xmma", "nvjet", "cublas")
QUEUE_FULL = "Command Buffer Full"
INT8_GEMM_MARKERS = ("s8", "i8", "imma", "int8")


def host_rss_gb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize() / 1e9


def peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9   # KiB on Linux


@contextlib.contextmanager
def phase(name: str):
    print(f"[{name}] ...", flush=True)
    t0 = time.perf_counter()
    yield
    release_host_memory(collect=True)
    peak_gb = peak_rss_gb()
    print(f"[{name}] ok in {time.perf_counter() - t0:.2f} s (host RSS now {host_rss_gb():.2f} GB, "
          f"peak so far {peak_gb:.2f} GB)", flush=True)


def release_host_memory(collect: bool = False) -> None:
    """Hand freed heap back to the OS (glibc's malloc_trim): profiler
    sessions leave much of it in malloc's free lists, and the phases after
    them would otherwise stack on that for the peak RSS."""
    if collect:
        gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# The host's issue time of a fused ring pass, measured in a process of its
# own on the package under argv[1] (this tree's, or another tree's for a
# comparison: the same code times both). Inputs as attention_inputs makes
# them at (LORA_BATCH, S) on RING_RANKS ranks of card 0; WARMUP passes,
# then one window of PASSES passes with the card waited for before and
# after: the host's time in the window over the passes, the C launcher's
# part of it and the sends a pass where the package counts them (else
# null). Prints one JSON line.
RING_ISSUE_CHILD = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from phantom_vlb_tpu_torch.core.mesh import SequenceRing
from phantom_vlb_tpu_torch.ops import ring_fused
b, s, n, hq, hkv, d, seed, warmup, passes = json.loads(sys.argv[2])
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(seed)
q = torch.randn(b, s, hq * d, generator=gen, device=dev, dtype=torch.bfloat16)
k = torch.randn(b, s, hkv * d, generator=gen, device=dev, dtype=torch.bfloat16)
v = torch.randn(b, s, hkv * d, generator=gen, device=dev, dtype=torch.bfloat16)
valid = torch.tensor([s - (s * i) // (2 * b) for i in range(b)], device=dev)
kv_mask = (torch.arange(s, device=dev)[None] < valid[:, None]).int()
ring = SequenceRing([dev] * n)
stats = getattr(ring_fused, "RING_STATS", None)
for _ in range(warmup):
    ring_fused.ring_fwd(q, k, v, hq, hkv, ring, kv_mask=kv_mask)
torch.cuda.synchronize()
c0, sends0 = (stats.launch_s, stats.sends) if stats else (0.0, 0)
t0 = time.perf_counter()
for _ in range(passes):
    ring_fused.ring_fwd(q, k, v, hq, hkv, ring, kv_mask=kv_mask)
host_s = time.perf_counter() - t0
torch.cuda.synchronize()
print(json.dumps({"host_ms": host_s / passes * 1e3,
                  "c_ms": (stats.launch_s - c0) / passes * 1e3 if stats else None,
                  "sends": (stats.sends - sends0) / passes if stats else None, "passes": passes}))
"""
RING_ISSUE_WARMUP, RING_ISSUE_PASSES = 10, 50


def ring_issue(root: str) -> dict:
    """RING_ISSUE_CHILD on the package under ``root``: its JSON record."""
    shape = [LORA_BATCH, REFERENCE_GEOMETRY.feature_len, RING_RANKS, HQ, HKV, D, SEED,
             RING_ISSUE_WARMUP, RING_ISSUE_PASSES]
    proc = subprocess.run([sys.executable, "-c", RING_ISSUE_CHILD, root, json.dumps(shape)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"ring issue timing under {root} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def compare_ring_issue(roots: list[str]) -> int:
    """``--ring-issue ROOT ...``: the host's issue time of a ring pass for
    the package under each root, in the order given (e.g. parent, change,
    change, parent), each in a process of its own; printed, one line each."""
    print(card_name_and_power())
    for root in roots:
        rec = ring_issue(root)
        print(json.dumps({"root": root, **rec}), flush=True)
    return 0


# The LoRA forward and dA calls as a user makes them (``fused_dropout_matmul``
# and ``fused_dropout_bwd(need_dx=False)``, hash mode), timed in a process
# of its own on the package under argv[1] (this tree's, or a parent's for a
# comparison: the same code times both). Inputs as lora_inputs makes them
# at (m, k) for each (k, col0); per call: the device time of everything it
# launches and of the kernel alone (torch.profiler over ITERS calls, up to 3
# sessions for a whole record), the kernels it launches and its CUDA-event
# time (host gaps included). Prints one JSON line.
LORA_CALLS_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from torch.profiler import ProfilerActivity, profile
from phantom_vlb_tpu_torch.ops.lora_fused import fused_dropout_bwd, fused_dropout_matmul
m, r, p, seed, iters, shapes = json.loads(sys.argv[2])
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(seed)
records = []
for k, col0 in shapes:
    x = torch.randn(m, k, generator=gen, device=dev, dtype=torch.bfloat16)
    a = (k ** -0.5 * torch.randn(k, r, generator=gen, device=dev)).to(torch.bfloat16)
    dmid = torch.randn(m, r, generator=gen, device=dev, dtype=torch.bfloat16)
    calls = {"lora_fwd": lambda: fused_dropout_matmul(x, a, 7, p, col0=col0),
             "lora_da": lambda: fused_dropout_bwd(x, a, dmid, 7, p, need_dx=False, col0=col0)}
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        events = []
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            events = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
            if sum(c for key, _, c in events if name + "_kernel" in key) == iters:
                break
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        records.append({"name": name, "k": k, "col0": col0,
                        "whole_ms": sum(t for _, t, _ in events) / iters,
                        "kernel_ms": sum(t for key, t, _ in events if name + "_kernel" in key) / iters,
                        "kernels_a_call": sum(c for _, _, c in events) / iters,
                        "event_ms": start.elapsed_time(end) / iters})
print(json.dumps({"records": records}))
"""
LORA_CALLS_ITERS = 20
# Phase 8's traced bf16 LoRA step (full width, batch 3, fused u8 dropout,
# remat per layer, from cached tokens) in a process of its own on the tree
# under argv[1], run by that tree's own chip_smoke.py functions (its launch
# checks included): after its 3 steps and one more, one step traced for the
# device alone. The same code here groups the trace for every tree. Prints
# one JSON line: wall and device ms, kernels, and ms and kernels by group.
LORA_STEP_CHILD = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(cs.SEED)
cfg = cs.lora_train_config()
sd = cs.init_params(cfg, dev, gen)
run = cs.train_lora_steps(cfg, sd, cs.lora_batches(cfg, gen, dev), dev, fresh=True)
run.one_more_step()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    run.one_more_step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
groups, counts = {}, {}
for e in prof.key_averages():
    if e.device_type != torch.autograd.DeviceType.CUDA or e.key == cs.QUEUE_FULL:
        continue
    g = cs.kernel_group(e.key)
    groups[g] = groups.get(g, 0.0) + e.device_time_total / 1e3
    counts[g] = counts.get(g, 0) + e.count
print(json.dumps({"wall_ms": wall_ms, "device_ms": sum(groups.values()), "kernels": sum(counts.values()),
                  "groups": groups, "counts": counts, "launches": run.launches}))
"""


def lora_bytes(name: str, m: int, k: int, r: int) -> int:
    """The bytes a LoRA dropout kernel must move at (m, k), rank r: x read
    once, A or dmid read once, the output written once."""
    return {"lora_fwd": (m * k + k * r + m * r) * 2, "lora_dx": (m * r + k * r + m * k) * 2,
            "lora_da": (m * k + m * r) * 2 + k * r * 4}[name]


def compare_lora_calls(roots: list[str]) -> int:
    """``--lora-calls ROOT ...``: the LoRA forward and dA calls' device
    time for the package under each root, in the order given (e.g. parent,
    change, change, parent), each in a process of its own, at the path's
    widths (K 4096 and 14336) and one tensor rank's (K 2048 from column
    2048, 7168 from 7168); printed, one JSON line a root and one line a
    call with its share of the bound."""
    print(card_name_and_power())
    shapes = [[k, 0] for k in LORA_KS] + [list(t) for t in TENSOR_LORA]
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", LORA_CALLS_CHILD, root,
                               json.dumps([LORA_M, LORA_R, LORA_P, SEED, LORA_CALLS_ITERS, shapes])],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"LoRA call timing under {root} failed:\n{proc.stderr[-4000:]}")
        recs = json.loads(proc.stdout.strip().splitlines()[-1])["records"]
        print(json.dumps({"root": root, "records": recs}), flush=True)
        for rec in recs:
            bound_ms = lora_bytes(rec["name"], LORA_M, rec["k"], LORA_R) / PEAK_BYTES_PER_S * 1e3
            print(f"  {root} {rec['name']} M={LORA_M} K={rec['k']} col0={rec['col0']}: whole call "
                  f"{rec['whole_ms']:.4f} ms ({bound_ms / rec['whole_ms']:.1%} of the {bound_ms:.4f} ms bound), "
                  f"kernel {rec['kernel_ms']:.4f}, {rec['kernels_a_call']:g} kernels a call, "
                  f"{rec['event_ms']:.4f} ms by CUDA events", flush=True)
    return 0


def compare_lora_step(roots: list[str]) -> int:
    """``--lora-step ROOT ...``: phase 8's traced bf16 LoRA step for the
    tree under each root, in the order given, each in a process of its own
    (LORA_STEP_CHILD); printed, one JSON line and one summary line a root."""
    print(card_name_and_power())
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", LORA_STEP_CHILD, root], capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"the LoRA step under {root} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"root": root, **rec}), flush=True)
        g, c = rec["groups"], rec["counts"]
        print(f"  {root} traced LoRA step: wall {rec['wall_ms']:.3f} ms, device {rec['device_ms']:.3f} ms, "
              f"{rec['kernels']} kernels; lora {g.get('lora', 0.0):.3f} ms ({c.get('lora', 0)} kernels), other "
              f"{g.get('other', 0.0):.3f} ms ({c.get('other', 0)}), gemm {g.get('gemm', 0.0):.3f} ms "
              f"({c.get('gemm', 0)}); LoRA launches counted {({k: v for k, v in rec['launches'].items() if 'lora' in k})}",
              flush=True)
    return 0


def build_kernels() -> None:
    kernels = [*KERNELS.values(), *BWD_PROBES.values(), *FWD_PROBES.values(), EPI_NO_FOLD, *LORA_NO_MASK.values()]
    builds = {}                                          # one kernel per build
    for kernel in kernels:
        builds.setdefault(kernel.target, kernel)
    build_all(list(builds))
    for kernel in kernels:
        kernel.load()
    for target, kernel in builds.items():
        report = [ln.split("info    : ")[-1].strip() for ln in kernel.build_log.splitlines()
                  if ("Used" in ln and "registers" in ln) or "spill" in ln]
        probe = "".join(f" -D{d}" for d in target[1]) if isinstance(target, tuple) else ""
        print(f"  {kernel.source.name}{probe}: " + " | ".join(report or ["cached"]))
        spills = [ln for ln in report
                  if "spill" in ln and not ln.startswith("0 bytes stack frame, 0 bytes spill")]
        if target in (FLASH_BWD.target, FLASH_FWD.target, RING_FWD.target) and spills:
            raise AssertionError(f"{kernel.source.name} spills: {spills}")


def reset_launches() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0
    RING_STATS.sends = 0


def sends_per_pass(n: int) -> int:
    return len(ring_send_plan(n))


def check_ring_sends(launches: dict[str, int], label: str) -> None:
    """The chunk sends since the counts were reset: n(n-1)/2 per pass of
    the RING_RANKS-rank ring (``ring_fwd`` launches n kernels a pass)."""
    want = launches["ring_fwd"] // RING_RANKS * sends_per_pass(RING_RANKS)
    print(f"  ring chunk sends {RING_STATS.sends} (want {want}: {sends_per_pass(RING_RANKS)} a pass)")
    if RING_STATS.sends != want:
        raise AssertionError(f"{label}: the ring passes made {RING_STATS.sends} sends, want {want}")


def read_launches() -> dict[str, int]:
    return {name: kernel.launches for name, kernel in KERNELS.items()}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30)).item()


def abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()


def attention_inputs(b: int, s: int, gen: torch.Generator, dev, hq: int = HQ, hkv: int = HKV,
                     valid: list[int] | None = None):
    q = torch.randn(b, s, hq * D, generator=gen, device=dev, dtype=torch.bfloat16)
    k = torch.randn(b, s, hkv * D, generator=gen, device=dev, dtype=torch.bfloat16)
    v = torch.randn(b, s, hkv * D, generator=gen, device=dev, dtype=torch.bfloat16)
    # Right padding of varied length per row, as the text padding gives.
    valid = torch.tensor(valid or [s - (s * i) // (2 * b) for i in range(b)], device=dev)
    kv_mask = (torch.arange(s, device=dev)[None] < valid[:, None]).int()
    return q, k, v, kv_mask


def check_bwd_parts(q, out, do, lse, hq: int, label: str) -> tuple[float, float]:
    """The backward's prep kernel (q_s and the padded lse bit for bit, di
    within DI_REL_TOL, the accumulator zeroed) and post kernel (both forms
    bit for bit) against their plain versions; returns their max abs
    errors (q_s and di; dq)."""
    got, want = flash_bwd_prep(q, out, do, lse, hq), flash_bwd_prep_plain(q, out, do, lse, hq)
    acc = torch.randn(want.acc.shape, generator=torch.Generator(device=q.device).manual_seed(5),
                      device=q.device)
    dq32 = torch.randn(q.shape, generator=torch.Generator(device=q.device).manual_seed(6), device=q.device)
    scale = D ** -0.5
    acc2, dq32_2 = acc.clone(), dq32.clone()
    post, post_ref = flash_bwd_post(acc, q.shape[1], scale), flash_bwd_post_plain(acc, q.shape[1], scale)
    flash_bwd_post(acc, q.shape[1], scale, dq32=dq32)
    flash_bwd_post_plain(acc2, q.shape[1], scale, dq32=dq32_2)
    torch.cuda.synchronize()
    same = {"q_s": torch.equal(got.qs, want.qs), "lse": torch.equal(got.lse, want.lse),
            "acc zero": bool((got.acc == 0).all()), "post": torch.equal(post, post_ref),
            "post accumulate": torch.equal(dq32, dq32_2) and torch.equal(acc, acc2)}
    di_rel = rel_err(got.di, want.di)
    print(f"  flash_bwd prep/post {label}: bit-equal {same}; di max|err|/max|ref| {di_rel:.3e} "
          f"(tol {DI_REL_TOL})")
    if not (all(same.values()) and di_rel <= DI_REL_TOL):
        raise AssertionError(f"the backward's prep or post kernel disagrees with its plain version at {label}")
    return max(abs_err(got.qs, want.qs), abs_err(got.di, want.di)), abs_err(post, post_ref)


def check_flash(b: int, s: int, gen, dev, causal_offset: int = 0, hq: int = HQ,
                hkv: int = HKV, valid: list[int] | None = None) -> tuple[float, float, tuple[float, float]]:
    """Forward and backward kernels vs plain (f32) on one input; returns the
    forward's out max abs error, the backward's over dq, dk, dv, and the
    prep's and post's (check_bwd_parts)."""
    q, k, v, kv_mask = attention_inputs(b, s, gen, dev, hq, hkv, valid)
    out, lse = attention_packed(q, k, v, hq, hkv, kv_mask=kv_mask, causal_offset=causal_offset)
    do = torch.randn(out.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    grads = attention_packed_bwd(q, k, v, out, lse, do, hq, hkv, kv_mask=kv_mask,
                                 causal_offset=causal_offset)
    torch.cuda.synchronize()
    # The kernel pre-scales q in bf16; give the plain version that same q.
    q_s = q * torch.tensor(D ** -0.5, dtype=torch.bfloat16, device=dev)
    out_ref, lse_ref = attention_packed_plain(
        q_s.float(), k.float(), v.float(), hq, hkv, sm_scale=1.0, kv_mask=kv_mask,
        causal_offset=causal_offset,
    )
    out_err, lse_err = abs_err(out, out_ref), abs_err(lse, lse_ref)
    label = f"B={b} S={s}" + (f" heads {hq}/{hkv}" if (hq, hkv) != (HQ, HKV) else "") + (
        f" causal_offset={causal_offset}" if causal_offset else "") + (f" valid {valid}" if valid else "")
    print(f"  flash_fwd {label}: out max|err| {out_err:.3e} (tol {OUT_TOL}), "
          f"lse max|err| {lse_err:.3e} (tol {LSE_TOL})")
    if not (out_err <= OUT_TOL and lse_err <= LSE_TOL):
        raise AssertionError(f"flash_fwd disagrees with its plain version at {label}")
    del out_ref, lse_ref
    refs = attention_packed_bwd_plain(q, k, v, out, lse, do, hq, hkv, kv_mask=kv_mask,
                                      causal_offset=causal_offset)
    rels = [rel_err(g, r) for g, r in zip(grads, refs)]
    bwd_err = max(abs_err(g, r) for g, r in zip(grads, refs))
    print(f"  flash_bwd {label}: max|err|/max|ref| dq {rels[0]:.3e}, dk {rels[1]:.3e}, "
          f"dv {rels[2]:.3e} (tol {BWD_REL_TOL}); max|err| {bwd_err:.3e}")
    if not max(rels) <= BWD_REL_TOL:
        raise AssertionError(f"flash_bwd disagrees with its plain version at {label}")
    del refs, grads
    return out_err, bwd_err, check_bwd_parts(q, out, do, lse, hq, label)


def check_ring(gen, dev) -> float:
    """The fused ring kernel vs its plain version (the same bf16 roundings:
    q pre-scaled and P cast to bf16; sums in another order) on rings of
    RING_RANKS and 2 ranks of the card at B = 3, S_loc 512 and 500 (not a
    multiple of the 128-row tile), with the right padding of
    attention_inputs and without a kv mask, and at S = 2048 on 2 ranks. One
    ring per n takes every case in turn, so its landing slots are reused
    pass after pass and made anew when S_loc changes; each pass makes
    n(n-1)/2 sends. Tolerances are the flash forward's: out 2e-2 absolute
    and as max|err| / max|ref| (bf16 out, 2^-8 relative at |out| <= ~1, and
    bf16 P), lse 1e-3 (f32, order only). Returns the out's max abs error."""
    worst = 0.0
    rings = {n: SequenceRing([dev] * n) for n in (RING_RANKS, 2)}
    for n, s, masked in ((RING_RANKS, 2048, True), (RING_RANKS, 2048, False), (RING_RANKS, 2000, True),
                         (RING_RANKS, 2000, False), (2, 2048, True), (2, 2048, False), (2, 1024, True),
                         (2, 1024, False), (2, 1000, True), (2, 1000, False)):
        q, k, v, kv_mask = attention_inputs(LORA_BATCH, s, gen, dev)
        kv_mask = kv_mask if masked else None
        ring = rings[n]
        sends = RING_STATS.sends
        out, lse = ring_fwd(q, k, v, HQ, HKV, ring, kv_mask=kv_mask)
        torch.cuda.synchronize()
        sends = RING_STATS.sends - sends
        out_ref, lse_ref = ring_fwd_plain(q, k, v, HQ, HKV, ring, kv_mask=kv_mask)
        rel, err, lse_err = rel_err(out, out_ref), abs_err(out, out_ref), abs_err(lse, lse_ref)
        finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
        print(f"  ring_fwd n={n} B={LORA_BATCH} S={s} (S_loc {s // n}) {'padded' if masked else 'no mask'}: "
              f"out max|err|/max|ref| {rel:.3e}, max|err| {err:.3e} (tol {OUT_TOL}), lse max|err| "
              f"{lse_err:.3e} (tol {LSE_TOL}), finite {finite}, {sends} sends (want {sends_per_pass(n)})")
        if not (rel <= OUT_TOL and err <= OUT_TOL and lse_err <= LSE_TOL and finite):
            raise AssertionError(f"ring_fwd disagrees with its plain version at n={n} S={s}")
        if sends != sends_per_pass(n):
            raise AssertionError(f"a ring pass on {n} ranks made {sends} sends, want {sends_per_pass(n)}")
        worst = max(worst, err)
        del q, k, v, out, lse, out_ref, lse_ref
    return worst


def lora_inputs(k: int, gen, dev):
    x = torch.randn(LORA_M, k, generator=gen, device=dev, dtype=torch.bfloat16)
    a = (k ** -0.5 * torch.randn(k, LORA_R, generator=gen, device=dev)).to(torch.bfloat16)
    dmid = torch.randn(LORA_M, LORA_R, generator=gen, device=dev, dtype=torch.bfloat16)
    return x, a, dmid


def check_lora(k: int, gen, dev) -> dict[str, float]:
    """The three kernels vs plain at (6144, k), r 16, p 0.1, in bits mode and
    in hash mode, from row 0 and from global row LORA_ROW0 (a rank's rows of
    a batch split over ranks); the 32-bit rule's keep bytes against the
    plain draw on the card's grid and against ``torch.rand`` (bit for bit),
    and the three kernels in bits mode on them at the rule's f32 scale;
    returns each kernel's max abs error (bits mode; the keep kernel's
    mismatched bytes)."""
    thr, keep = dropout_threshold(LORA_P)
    x, a, dmid = lora_inputs(k, gen, dev)
    bits = torch.randint(0, 256, x.shape, generator=gen, device=dev, dtype=torch.uint8)
    errs = {}
    for mode, b, seed, row0 in (("bits", bits, 0, 0), ("hash", None, 1234, 0),
                                (f"hash from row {LORA_ROW0}", None, 1234, LORA_ROW0)):
        mid = fused_dropout_matmul(x, a, seed, LORA_P, bits=b, row0=row0)
        dx, da = fused_dropout_bwd(x, a, dmid, seed, LORA_P, bits=b, row0=row0)
        torch.cuda.synchronize()
        mid_ref = fused_dropout_matmul_plain(x, a, seed, thr, b, row0)
        dx_ref, da_ref = fused_dropout_bwd_plain(x, a, dmid, seed, thr, b, row0)
        rels = (rel_err(mid, mid_ref), rel_err(dx, dx_ref), rel_err(da, da_ref))
        # dx is exactly 0 wherever the mask drops (bits or hash bytes below
        # thr); both masks are also read back exactly below.
        drops = (hash_bytes(seed, LORA_M, k, dev, row0) if b is None else b) < thr
        zero_drops = bool((dx[drops] == 0).all())
        print(f"  lora K={k} {mode}: max|err|/max|ref| fwd {rels[0]:.3e} (tol {MID_REL_TOL}), "
              f"dx {rels[1]:.3e} (tol {DX_REL_TOL}), dA {rels[2]:.3e} (tol {DA_REL_TOL}); "
              f"dx exactly 0 at the {int(drops.sum())} dropped elements: {zero_drops}")
        if not (rels[0] <= MID_REL_TOL and rels[1] <= DX_REL_TOL and rels[2] <= DA_REL_TOL and zero_drops):
            raise AssertionError(f"LoRA kernels disagree with their plain versions ({mode}, K={k})")
        if mode == "bits":
            errs = {"lora_fwd": abs_err(mid, mid_ref), "lora_dx": abs_err(dx, dx_ref),
                    "lora_da": abs_err(da, da_ref)}
        del mid_ref, dx_ref, da_ref
    errs.update(check_lora_keep32(x, a, dmid, dev, errs))
    # The hash and bits masks read back exactly: dmid = e0 rows and A = e0
    # columns make dmid @ A^T all ones, so dx = mask / keep.
    e_a = torch.zeros_like(a)
    e_a[:, 0] = 1
    e_d = torch.zeros_like(dmid)
    e_d[:, 0] = 1
    masks = {}
    for seed in (1234, 1234, 99):
        dx, _ = fused_dropout_bwd(x, e_a, e_d, seed, LORA_P, need_da=False)
        masks.setdefault(seed, []).append(dx != 0)
    plain = hash_bytes(1234, LORA_M, k, dev) >= thr
    mismatches = int((masks[1234][0] != plain).sum())
    dx, _ = fused_dropout_bwd(x, e_a, e_d, 0, LORA_P, bits=bits, need_da=False)
    bits_mismatches = int(((dx != 0) != (bits >= thr)).sum())
    rate = masks[1234][0].float().mean().item()
    same = bool(torch.equal(masks[1234][0], masks[1234][1]))
    differ = (masks[1234][0] != masks[99][0]).float().mean().item()
    # From global row LORA_ROW0: the rows [LORA_ROW0, LORA_ROW0 + M) of the
    # hash mask, which rows [LORA_ROW0 - 5, ...) of a longer draw hold too.
    dx, _ = fused_dropout_bwd(x, e_a, e_d, 1234, LORA_P, need_da=False, row0=LORA_ROW0)
    longer = hash_bytes(1234, LORA_M + 5, k, dev, LORA_ROW0 - 5)[5:] >= thr
    row0_mismatches = int(((dx != 0) != longer).sum())
    print(f"  lora K={k} hash mask via dx: {mismatches} mismatches with the plain hash, keep rate "
          f"{rate:.6f} (want {keep:.6f} +- {KEEP_RATE_TOL}), same seed same mask {same}, "
          f"another seed differs in {differ:.4f} of elements; bits mask via dx: "
          f"{bits_mismatches} mismatches; from row {LORA_ROW0}: {row0_mismatches} mismatches")
    if (mismatches or bits_mismatches or row0_mismatches or abs(rate - keep) > KEEP_RATE_TOL or not same
            or differ < 0.1):
        raise AssertionError(f"LoRA dropout mask is not exact, at its rate or deterministic (K={k})")
    # An M tail (rows off the 64-row tile, from global row LORA_ROW0): the
    # forward and dA (one launch each, their partials folded in the launch).
    tail = LORA_M - LORA_TAIL
    mid = fused_dropout_matmul(x[:tail], a, 1234, LORA_P, row0=LORA_ROW0)
    _, da = fused_dropout_bwd(x[:tail], a, dmid[:tail], 1234, LORA_P, need_dx=False, row0=LORA_ROW0)
    torch.cuda.synchronize()
    tail_rels = (rel_err(mid, fused_dropout_matmul_plain(x[:tail], a, 1234, thr, row0=LORA_ROW0)),
                 rel_err(da, fused_dropout_bwd_plain(x[:tail], a, dmid[:tail], 1234, thr, row0=LORA_ROW0)[1]))
    # dA's mask read back exactly: x all ones and dmid[m, n] = 2^(m - 16 n)
    # on rows [16 n, 16 n + 16) (zero elsewhere) make dA[c, n] = s times the
    # kept rows' powers of two, an integer below 2^16 times s (8 bits): f32
    # exact in any order, so round(dA / s) is the mask of rows 0..255.
    ones = torch.ones_like(x)
    powers = torch.zeros_like(dmid)
    for n in range(LORA_R):
        powers[16 * n:16 * n + 16, n] = 2.0 ** torch.arange(16, device=dev, dtype=torch.float32)
    scale = float(torch.tensor(1.0 / keep, dtype=torch.bfloat16))
    for mode, b in (("hash", None), ("bits", bits)):
        _, da = fused_dropout_bwd(ones, a, powers, 1234, LORA_P, bits=b, need_dx=False, row0=LORA_ROW0)
        words = torch.round(da / scale).to(torch.int64)            # (k, R): 16 rows' bits each
        got = ((words.T[:, None, :] >> torch.arange(16, device=dev)[None, :, None]) & 1).reshape(16 * LORA_R, k)
        want = ((hash_bytes(1234, 16 * LORA_R, k, dev, LORA_ROW0) if b is None else b[:16 * LORA_R]) >= thr)
        da_mismatches = int((got.bool() != want).sum())
        print(f"  lora K={k} {mode}: dA's mask read back on rows 0..{16 * LORA_R - 1}: {da_mismatches} mismatches")
        if da_mismatches:
            raise AssertionError(f"lora_da's {mode} mask is not exact (K={k})")
    print(f"  lora K={k} M tail {tail} from row {LORA_ROW0}: max|err|/max|ref| fwd {tail_rels[0]:.3e} "
          f"(tol {MID_REL_TOL}), dA {tail_rels[1]:.3e} (tol {DA_REL_TOL})")
    if not (tail_rels[0] <= MID_REL_TOL and tail_rels[1] <= DA_REL_TOL):
        raise AssertionError(f"LoRA forward or dA disagrees with plain on an M tail (K={k})")
    return errs


def check_lora_keep32(x, a, dmid, dev, errs: dict[str, float]) -> dict[str, float]:
    """The 32-bit rule (the trainer of record's unfused dropout) at x's
    (6144, k): ``keep_bytes`` against ``keep_bytes_plain`` on the card's
    grid and against ``torch.rand(...) < keep`` from the seed's CUDA
    generator, bit for bit, for each of LORA_KEEP_SEEDS; then the forward,
    dx and dA kernels in bits mode on the last seed's bytes against their
    plain versions at the rule's f32 scale (dx exactly 0 where a byte is
    0). Returns ``errs``' LoRA errors raised to these, and the keep
    kernel's mismatched bytes."""
    m, k = x.shape
    keep = 1.0 - LORA_P
    thr, scale, _ = dropout_rule(LORA_P, 32, x.dtype)
    mismatches = {}
    for seed in LORA_KEEP_SEEDS:
        got = keep_bytes((m, k), seed, keep, dev)
        plain = keep_bytes_plain((m, k), seed, keep, *_card_threads(dev.index or 0), device=dev)
        rand = torch.rand((m, k), generator=torch.Generator(device=dev).manual_seed(seed), device=dev) < keep
        mismatches[seed] = (int((got != plain).sum()), int((got.bool() != rand).sum()))
        del plain, rand
    mid = fused_dropout_matmul(x, a, 0, LORA_P, bits=got, dropout_bits=32)
    dx, da = fused_dropout_bwd(x, a, dmid, 0, LORA_P, bits=got, dropout_bits=32)
    torch.cuda.synchronize()
    mid_ref = fused_dropout_matmul_plain(x, a, 0, thr, got, scale=scale)
    dx_ref, da_ref = fused_dropout_bwd_plain(x, a, dmid, 0, thr, got, scale=scale)
    rels = (rel_err(mid, mid_ref), rel_err(dx, dx_ref), rel_err(da, da_ref))
    zero_drops = bool((dx[got == 0] == 0).all())
    print(f"  lora K={k} 32-bit keep bytes, mismatches (against keep_bytes_plain, against torch.rand) by seed "
          f"{mismatches}, kept {got.float().mean().item():.6f}; bits mode at the f32 scale {scale!r}: "
          f"max|err|/max|ref| fwd {rels[0]:.3e} (tol {MID_REL_TOL}), dx {rels[1]:.3e} (tol {DX_REL_TOL}), "
          f"dA {rels[2]:.3e} (tol {DA_REL_TOL}); dx exactly 0 at the dropped elements: {zero_drops}")
    if any(any(v) for v in mismatches.values()):
        raise AssertionError(f"the keep kernel's bytes are not torch.rand's (K={k}): {mismatches}")
    if not (rels[0] <= MID_REL_TOL and rels[1] <= DX_REL_TOL and rels[2] <= DA_REL_TOL and zero_drops):
        raise AssertionError(f"LoRA kernels disagree with their plain versions under the 32-bit rule (K={k})")
    return {"lora_fwd": max(errs["lora_fwd"], abs_err(mid, mid_ref)),
            "lora_dx": max(errs["lora_dx"], abs_err(dx, dx_ref)),
            "lora_da": max(errs["lora_da"], abs_err(da, da_ref)),
            "lora_keep": float(sum(sum(v) for v in mismatches.values()))}


def check_lora_plans(dev) -> None:
    """The clusters of each size the card holds at once for the forward's
    and dA's kernels (the plans' limits; ``H100_CLUSTERS`` is the CPU
    tests' card), and the plans (``_fwd_plan``, ``_da_plan``) they give at
    the path's widths, each held to one wave. Printed."""
    caps = {da: _cluster_capacity(dev, LORA_R, da) for da in (False, True)}
    print(f"  lora clusters the card holds at once (sizes {CLUSTER_SIZES}): forward {caps[False]}, dA "
          f"{caps[True]}; the CPU tests' H100 {H100_CLUSTERS}")
    for m, k in ((LORA_M, LORA_KS[0]), (LORA_M, LORA_KS[1]), (LORA_M // 2, LORA_KS[0]),
                 *((LORA_M, kk) for kk, _ in TENSOR_LORA)):
        line = []
        for da, plan, n_red in ((False, _fwd_plan(m, k, LORA_R, caps=caps[False]), k // 64),
                                (True, _da_plan(m, k, LORA_R, caps=caps[True]), -(-m // 64))):
            if plan[1] > caps[da][CLUSTER_SIZES.index(plan[0])]:
                raise AssertionError(f"the {'dA' if da else 'forward'} plan {plan} at ({m}, {k}) is over one wave")
            line.append(f"{'dA' if da else 'forward'} {plan[1]} clusters of {plan[0]} "
                        f"({'resident' if plan[2] else 'streamed'}, {plan_smem_bytes(plan, n_red, LORA_R, False)} B)")
        print(f"  lora plans at ({m}, {k}): " + "; ".join(line))


def check_lora_col0(k: int, col0: int, gen, dev) -> dict[str, float]:
    """The three kernels vs plain at (6144, k), r 16, p 0.1, hash mode from
    global row LORA_ROW0 and first column ``col0`` (a row-parallel
    projection's input on a ``tensor`` rank); the mask read back exactly
    through dx is the hash's columns [col0, col0 + k). Returns each
    kernel's max abs error."""
    thr, _ = dropout_threshold(LORA_P)
    x, a, dmid = lora_inputs(k, gen, dev)
    mid = fused_dropout_matmul(x, a, 1234, LORA_P, row0=LORA_ROW0, col0=col0)
    dx, da = fused_dropout_bwd(x, a, dmid, 1234, LORA_P, row0=LORA_ROW0, col0=col0)
    torch.cuda.synchronize()
    mid_ref = fused_dropout_matmul_plain(x, a, 1234, thr, row0=LORA_ROW0, col0=col0)
    dx_ref, da_ref = fused_dropout_bwd_plain(x, a, dmid, 1234, thr, row0=LORA_ROW0, col0=col0)
    rels = (rel_err(mid, mid_ref), rel_err(dx, dx_ref), rel_err(da, da_ref))
    errs = {"lora_fwd": abs_err(mid, mid_ref), "lora_dx": abs_err(dx, dx_ref), "lora_da": abs_err(da, da_ref)}
    del mid_ref, dx_ref, da_ref
    e_a = torch.zeros_like(a)
    e_a[:, 0] = 1
    e_d = torch.zeros_like(dmid)
    e_d[:, 0] = 1
    dx, _ = fused_dropout_bwd(x, e_a, e_d, 1234, LORA_P, need_da=False, row0=LORA_ROW0, col0=col0)
    wider = hash_bytes(1234, LORA_M, col0 + k, dev, LORA_ROW0)[:, col0:] >= thr
    mismatches = int(((dx != 0) != wider).sum())
    print(f"  lora K={k} hash from row {LORA_ROW0}, column {col0}: max|err|/max|ref| fwd {rels[0]:.3e} "
          f"(tol {MID_REL_TOL}), dx {rels[1]:.3e} (tol {DX_REL_TOL}), dA {rels[2]:.3e} (tol {DA_REL_TOL}); "
          f"mask via dx against columns [{col0}, {col0 + k}) of the whole row's hash: {mismatches} mismatches")
    if not (rels[0] <= MID_REL_TOL and rels[1] <= DX_REL_TOL and rels[2] <= DA_REL_TOL) or mismatches:
        raise AssertionError(f"LoRA kernels from column {col0} disagree with their plain versions (K={k})")
    return errs


def check_row_quant_split(gen, dev) -> dict[str, float]:
    """The kernel's passes alone at one ``tensor`` rank's widths, (6144,
    2048) and (6144, 7168) bf16 with a zero row, plain and scaled: the
    maxima and the codes from a given scale bit-equal to their plain
    versions, and each half of a whole row quantized with the maximum of
    the halves' maxima (``row_quant_split``) bit-equal to the whole row's
    q and s. Returns each entry point's max abs error (0 when bit-equal)."""
    errs = {"row_absmax": 0.0, "row_quant_given": 0.0}
    for k, _ in TENSOR_LORA:
        x = (3 * torch.randn(LORA_M, TENSOR * k, generator=gen, device=dev)).to(torch.bfloat16)
        x[LORA_M // 3] = 0
        w = torch.rand(TENSOR * k, generator=gen, device=dev) * 2 + 0.01
        for ws in (None, w):
            q, s = row_quant_plain(x, ws)
            halves = [(x[:, i * k:(i + 1) * k].contiguous(), None if ws is None else ws[i * k:(i + 1) * k].contiguous())
                      for i in range(TENSOR)]
            maxima = [row_absmax(h, hw) for h, hw in halves]
            given = [row_quant_given(h, s, hw) for h, hw in halves]
            split = [row_quant_split(h, lambda m: torch.stack(maxima).amax(0), hw) for h, hw in halves]
            torch.cuda.synchronize()
            mis = {"absmax": sum(int((m != row_absmax_plain(h, hw)).sum()) for m, (h, hw) in zip(maxima, halves)),
                   "given": sum(int((g != row_quant_given_plain(h, s, hw)).sum()) for g, (h, hw) in zip(given, halves)),
                   "split q": sum(int((qs != q[:, i * k:(i + 1) * k]).sum()) for i, (qs, _) in enumerate(split)),
                   "split s": sum(int((ss != s).sum()) for _, ss in split)}
            label = f"(6144, {k}) bf16{' scaled' if ws is not None else ''}"
            print(f"  row quant's passes alone {label}: mismatches {mis}")
            if any(mis.values()):
                raise AssertionError(f"the split row quant disagrees with its plain version at {label}")
            errs["row_absmax"] = max(errs["row_absmax"], *(abs_err(m, row_absmax_plain(h, hw))
                                                          for m, (h, hw) in zip(maxima, halves)))
            errs["row_quant_given"] = max(errs["row_quant_given"],
                                          *(abs_err(g, row_quant_given_plain(h, s, hw)) for g, (h, hw) in zip(given, halves)))
        del x, w
    return errs


def check_row_quant(gen, dev) -> dict[str, float]:
    """Both entry points vs plain, bit for bit: bf16 at (6144, 4096) and
    (6144, 14336) with a zero row, 6141 rows (not a multiple of 8), and the
    vision tower's (20772, 1024) and (20772, 4096); returns each entry
    point's max abs error over q (as float)."""
    errs = {"row_quant": 0.0, "row_quant_scaled": 0.0}
    for rows, n in ((LORA_M, LORA_KS[0]), (LORA_M, LORA_KS[1]), (LORA_M - 3, LORA_KS[0]),
                    *((TOWER_ROWS, n) for n in TOWER_WIDTHS)):
        x = (3 * torch.randn(rows, n, generator=gen, device=dev)).to(torch.bfloat16)
        x[rows // 3] = 0
        w = torch.rand(n, generator=gen, device=dev) * 2 + 0.01
        for name, got, want in (("row_quant", row_quant(x), row_quant_plain(x)),
                                ("row_quant_scaled", row_quant_scaled(x, w), row_quant_plain(x, w))):
            torch.cuda.synchronize()
            q_mis = int((got[0] != want[0]).sum())
            s_same = bool(torch.equal(got[1], want[1]))
            floor = got[1][rows // 3].item()
            print(f"  {name} ({rows}, {n}) bf16: {q_mis} q mismatches, s bit-equal {s_same}, "
                  f"zero row's s {floor:.3e}")
            if q_mis or not s_same or floor != torch.tensor(1e-12).item():
                raise AssertionError(f"{name} disagrees with its plain version at ({rows}, {n})")
            errs[name] = max(errs[name], abs_err(got[0], want[0]))
    return errs


def epilogue_inputs(n: int, gen, dev):
    y = torch.randn(LORA_M, n, generator=gen, device=dev, dtype=torch.bfloat16)
    z = torch.randn(LORA_M, LORA_R, generator=gen, device=dev, dtype=torch.bfloat16)
    b = (0.05 * torch.randn(LORA_R, n, generator=gen, device=dev)).to(torch.bfloat16)
    dy = torch.randn(LORA_M, n, generator=gen, device=dev, dtype=torch.bfloat16)
    return y, z, b, dy


def check_epilogue(gen, dev, ns=EPI_NS) -> dict[str, float]:
    """Forward, the fused dz + dB, and dz and dB alone vs plain at M = 6144,
    r = 16, N in ``ns`` (the one-card widths 1024, 4096, 14336 by default),
    and two calls of each backward entry point bit for bit; returns each
    kernel's max abs error."""
    errs = {"epi_fwd": 0.0, "epi_dz": 0.0, "epi_db": 0.0, "epi_dzdb": 0.0}
    scaling = 32.0 / LORA_R
    for n in ns:
        y, z, b, dy = epilogue_inputs(n, gen, dev)
        backward = {"epi_dz": lambda: (lora_epilogue_dz(dy, b, scaling),),
                    "epi_db": lambda: (lora_epilogue_db(z, dy, scaling),),
                    "epi_dzdb": lambda: lora_epilogue_dzdb(z, dy, b, scaling)}
        runs = {k: (fn(), fn()) for k, fn in backward.items()}
        fwd = lora_epilogue_fwd(y, z, b, scaling)
        torch.cuda.synchronize()
        dz_p, db_p = lora_epilogue_dzdb_plain(z, dy, b, scaling)
        got = {"epi_fwd": (fwd,), **{k: first for k, (first, _) in runs.items()}}
        want = {"epi_fwd": (lora_epilogue_plain(y, z, b, scaling),), "epi_dz": (dz_p,), "epi_db": (db_p,),
                "epi_dzdb": (dz_p, db_p)}
        rels = {k: max(rel_err(g, w) for g, w in zip(got[k], want[k])) for k in got}
        repeat = all(torch.equal(a, c) for first, second in runs.values() for a, c in zip(first, second))
        # The forward's tensor-core sums may differ from the plain version's
        # in the last bits, and so flip a rounding.
        differ = int((got["epi_fwd"][0] != want["epi_fwd"][0]).sum())
        print(f"  epilogue N={n}: max|err|/max|ref| " + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
              + f" (tol {EPI_REL_TOL}); epi_fwd elements that differ from plain: {differ} of {fwd.numel()}; "
              f"two calls of each backward bit-equal: {repeat}")
        if max(rels.values()) > EPI_REL_TOL or not all(torch.isfinite(t).all() for g in got.values() for t in g):
            raise AssertionError(f"the epilogue kernels disagree with their plain versions at N={n}")
        if not repeat:
            raise AssertionError(f"the epilogue's backward does not repeat bit for bit at N={n}")
        for k in got:
            errs[k] = max(errs[k], *(abs_err(g, w) for g, w in zip(got[k], want[k])))
        del y, z, b, dy, runs, got, want
    return errs


def check_predictions(res: dict, rows: int, num_target: int) -> None:
    pred = res["predicted"]
    if pred.shape != (rows, num_target) or not np.isfinite(pred).all():
        raise AssertionError(f"predictions {pred.shape}, finite={np.isfinite(pred).all()}")
    if not (np.isfinite(res["brain_loss"]).all() and np.isfinite(res["val_corr_roi"]).all()):
        raise AssertionError("non-finite loss or correlation")


def kernel_group(name: str) -> str:
    for group in ("flash_fwd", "flash_bwd", "ring_fwd"):
        if group in name:
            return group
    if "lora_" in name:
        return "lora"
    if "row_quant" in name:
        return "row_quant"
    if "epi_" in name:
        return "epilogue"
    low = name.lower()
    if any(m in low for m in GEMM_MARKERS):
        return "gemm_int8" if any(m in low for m in INT8_GEMM_MARKERS) else "gemm"
    return "other"


def span_device_ms(prof, span: str) -> float:
    """Device time of the kernels launched inside the ``record_function``
    range ``span`` (each kernel is attributed to the op that launched it,
    and that op's ancestors are searched for the range)."""
    total = 0.0
    for e in prof.events():
        parent = e.cpu_parent
        while parent is not None and parent.name != span:
            parent = parent.cpu_parent
        if parent is not None:
            total += e.self_device_time_total
    return total / 1e3


def traced(fn, label: str, span: str | None = None) -> tuple[dict[str, float], dict[str, float]]:
    """Trace ``fn()`` on a warm model: device time by kernel and by group,
    and the idle share of its wall time; with ``span`` (a
    ``record_function`` range, which needs the host's ops traced too) also
    the group of kernels launched inside it, on top of the others. Returns
    ms by group and by kernel."""
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if span else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    # CUPTI's record of the host blocked on a full launch queue, and the
    # span's own range on the device's timeline: no kernels.
    queue_full = [e for e in kernels if e.key == QUEUE_FULL]
    kernels = [e for e in kernels if e.key not in (QUEUE_FULL, span)]
    if queue_full:
        print(f"  host blocked on a full launch queue ({QUEUE_FULL!r}) {queue_full[0].device_time_total / 1e3:.3f} "
              f"ms: not counted as device time")
    by_kernel = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in kernels),
                       key=lambda x: -x[1])
    groups: dict[str, float] = {}
    launched: dict[str, int] = {}
    for name, ms, count in by_kernel:
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + ms
        launched[kernel_group(name)] = launched.get(kernel_group(name), 0) + count
    busy_ms = sum(groups.values())
    print(f"  traced {label} wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          + (f"{1.0 - busy_ms / wall_ms:.4f}" if busy_ms else "not measured (no device events)")
          + f", {sum(launched.values())} kernels")
    for name, ms, count in by_kernel[:14]:
        print(f"  {ms:10.3f} ms  x{count:<5d} ({ms / count:.4f} ms each) {name[:100]}")
    for group, ms in sorted(groups.items(), key=lambda x: -x[1]):
        print(f"  group {group:9s} {ms:10.3f} ms ({ms / max(busy_ms, 1e-9):.1%} of device time), "
              f"{launched[group]} kernels")
    if span:
        groups[span] = span_device_ms(prof, span)
        print(f"  group {span:9s} {groups[span]:10.3f} ms ({groups[span] / max(busy_ms, 1e-9):.1%} of device "
              f"time: the kernels launched inside the {span!r} range, counted in the groups above too); "
              f"host RSS after the trace {host_rss_gb():.2f} GB, peak so far {peak_rss_gb():.2f} GB")
    del prof, kernels
    release_host_memory(collect=True)
    return groups, {name: ms for name, ms, _ in by_kernel}


def serve_through_the_ring(model, batch: dict, want: np.ndarray, dev) -> None:
    """Phase 5's last batch again on the same model switched to the fused
    ring on RING_RANKS ranks of the card: launch counts and predictions."""
    set_sequence_ring(SequenceRing([dev] * RING_RANKS))
    set_attention_impl(model, "ring_fused")
    try:
        torch.cuda.synchronize()
        reset_launches()
        res = predict_batches(model, [batch], dev)
        launches = read_launches()
    finally:
        set_attention_impl(model, "auto")
        set_sequence_ring(None)
    check_ring_sends(launches, "serving through the ring")
    check_predictions(res, BATCH, model.cfg.num_target)
    err = np.abs(res["predicted"] - want).max() / np.abs(want).max()
    print(f"  batch ms {[round(float(x), 3) for x in res['batch_ms']]}, launches {launches}; "
          f"predictions max|ring - phase 5| / max|phase 5| {err:.3e} (tol {RING_PRED_TOL})")
    layers = model.cfg.mistral.num_hidden_layers
    want_launches = {n: (layers * RING_RANKS if n == "ring_fwd" else 0) for n in KERNELS}
    if launches != want_launches:
        raise AssertionError(f"serving through the ring launched {launches}, want {want_launches}")
    if not err <= RING_PRED_TOL:
        raise AssertionError("predictions through the fused ring disagree with the flash path's")


def serve_from_frames(model, gen, dev) -> None:
    """3 batches of 5 from frames made on the card, through the towers of
    the phase-4 model: launch counts, then the same batches fed the tokens
    ``encode_video`` gives for their frames (predictions against the frames
    path), ``encode_video``'s CUDA-event time per batch and its share of the
    batch's, and one more batch traced with the ``vision`` group."""
    cfg = model.cfg
    batches = synthetic_batches(cfg, N_BATCHES, BATCH, np.random.default_rng(SEED), gen, dev, frames=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = predict_batches(model, batches, dev)
    launches = read_launches()
    check_predictions(res, N_BATCHES * BATCH, cfg.num_target)
    print(f"  frames {tuple(batches[0]['vision'].shape)} f32 per batch; batch ms "
          f"{[round(float(x), 3) for x in res['batch_ms']]}, brain_loss "
          f"{[round(float(x), 5) for x in res['brain_loss']]}, launches {launches}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, host RSS "
          f"{host_rss_gb():.2f} GB (peak so far {peak_rss_gb():.2f})")
    want = {n: (cfg.mistral.num_hidden_layers * N_BATCHES if n == "flash_fwd" else 0) for n in KERNELS}
    if launches != want:
        raise AssertionError(f"serving from frames launched {launches}, want {want}")
    with torch.inference_mode():
        tokens = [dict(b, vision=model.encode_video(b["vision"])) for b in batches]
    print(f"  encode_video: {tuple(tokens[0]['vision'].shape)} {tokens[0]['vision'].dtype} tokens per batch")
    from_tokens = predict_batches(model, tokens, dev)
    err = np.abs(res["predicted"] - from_tokens["predicted"]).max() / np.abs(from_tokens["predicted"]).max()
    print(f"  predictions from frames against the same model fed encode_video's tokens: "
          f"max|err| / max|pred| {err:.3e} (tol {FRAMES_TOKENS_TOL})")
    if not err <= FRAMES_TOKENS_TOL:
        raise AssertionError("serving from frames disagrees with serving encode_video's tokens")
    with torch.inference_mode():
        enc_ms = [cuda_ms(lambda b=b: model.encode_video(b["vision"]), 1, warmup=0) for b in batches]
        batch_ms = [cuda_ms(lambda b=b: predict_batches(model, [b], dev), 1, warmup=0) for b in batches]
    print(f"  encode_video {[round(x, 3) for x in enc_ms]} ms per batch of {BATCH} (CUDA events), of a "
          f"served batch's {[round(x, 3) for x in batch_ms]}: {[round(e / t, 4) for e, t in zip(enc_ms, batch_ms)]}")
    traced(lambda: predict_batches(model, [batches[-1]], dev), "served batch from frames", span="vision")
    del batches, tokens


def serve_w8a8g8_from_frames(gen, dev) -> dict[str, int]:
    """One batch of 5 from frames through a w8a8g8 frozen model, its
    decoder's and tower's projections int8 (made on the card and quantized
    at once): every projection's input goes through ``row_quant``, 7 a
    decoder layer and 6 a tower layer. Returns the launch counts."""
    cfg = VLBConfig.full(base_quant="w8a8g8")
    model = VideoLLaMA2VLB.from_state_dict(cfg, init_params(cfg, dev, gen))
    batch = synthetic_batches(cfg, 1, BATCH, np.random.default_rng(SEED), gen, dev, frames=True)
    predict_batches(model, batch, dev)                   # warm
    torch.cuda.synchronize()
    reset_launches()
    res = predict_batches(model, batch, dev)
    launches = read_launches()
    check_predictions(res, BATCH, cfg.num_target)
    layers, tower_layers = cfg.mistral.num_hidden_layers, cfg.clip.effective_layers
    want = {n: 0 for n in KERNELS}
    want.update(flash_fwd=layers, row_quant=7 * layers + 6 * tower_layers)
    print(f"  w8a8g8 batch of {BATCH} from frames: {float(res['batch_ms'][0]):.3f} ms, launches {launches} "
          f"(row_quant: {7 * layers} decoder + {6 * tower_layers} tower projections)")
    if launches != want:
        raise AssertionError(f"w8a8g8 serving from frames launched {launches}, want {want}")
    return launches


def lora_train_config(mistral: MistralConfig | None = None, fused_epilogue: str = "",
                      base_quant: str | None = None, **overrides) -> VLBConfig:
    """The reference's LoRA recipe with the fused u8 dropout the bench runs."""
    lora = LoRAConfig(rank=16, alpha=32.0, dropout=LORA_P, dropout_bits=8, fused_dropout=True,
                      fused_epilogue=fused_epilogue)
    if mistral is None:
        mistral = MistralConfig.full(lora=lora, remat=True, base_quant=base_quant)
    return VLBConfig.full(use_lora=True, base_quant=base_quant, mistral=mistral, **overrides)


def expected_train_launches(layers: int, steps: int, epilogue: bool = False,
                            int8: bool = False, ring: str | None = None,
                            remat_policy: str = "nothing", keep: bool = False) -> dict[str, int]:
    """What one LoRA step launches with remat per layer: every layer's forward
    runs twice (the pass and its replay in the backward), so 2 flash forwards
    and 2 x 7 LoRA forwards (and, with the int8 base, row quants, and with
    the fused epilogue, epilogue forwards: 13 a layer, as the replay stops
    before the last projection's base product, and the fused epilogue saves
    z and B before that product, so its replay runs neither it nor the
    kernel, as the JAX grad's does not); ``remat_policy`` 'flash' keeps the
    packed path's flash forward's outputs (1 a layer; a ring's flash
    forwards are not named, as in the reference, and run again), 'mids' and
    'flash' the LoRA mids (7 LoRA forwards a layer, under a ring too); one
    flash backward; 7 dA (and 7
    fused epilogue backwards, dz and dB from one launch: the single dz and
    dB entry points never run, as both grads are always needed); and 7 dx
    (7 scaled row quants) except for layer 0's q, k and v,
    whose input (the normed embeddings) needs no gradient. A flash backward
    is a prep, a main kernel and a post. Through a ring of n = RING_RANKS
    ranks a layer's attention pass is n ring kernels ('ring_fused') or
    n(n+1)/2 offset flash forwards ('ring_flash': the steps from later ranks
    are skipped), and its backward one prep per rank and a main kernel and a
    post (accumulate form) per step, n(n+1)/2 of each. ``keep``: the 32-bit
    unfused dropout's route (the LoRA config of record), whose masks the
    keep kernel draws in the forward and again in every replay, whatever
    the policy keeps: 14 a layer; otherwise the fused u8 route's hash
    (none)."""
    pairs = RING_RANKS * (RING_RANKS + 1) // 2
    ring_bwd = {"flash_bwd_prep": RING_RANKS * layers, "flash_bwd": pairs * layers,
                "flash_bwd_post": pairs * layers}
    attn = {None: {"flash_fwd": 2 * layers, "flash_bwd_prep": layers, "flash_bwd": layers,
                   "flash_bwd_post": layers, "ring_fwd": 0},
            "ring_fused": {"flash_fwd": 0, **ring_bwd, "ring_fwd": 2 * RING_RANKS * layers},
            "ring_flash": {"flash_fwd": 2 * pairs * layers, **ring_bwd, "ring_fwd": 0}}[ring]
    kept = REMAT_POLICIES[remat_policy] or set()
    if "flash_out" in kept and ring is None:
        attn["flash_fwd"] = layers
    per_step = {**attn,
                "lora_fwd": (7 if "lora_mid" in kept else 14) * layers, "lora_dx": 7 * layers - 3,
                "lora_da": 7 * layers, "lora_keep": 14 * layers if keep else 0,
                "row_quant": 13 * layers if int8 else 0,
                "row_quant_scaled": 7 * layers - 3 if int8 else 0, "row_absmax": 0, "row_quant_given": 0,
                "epi_fwd": 13 * layers if epilogue else 0, "epi_dz": 0, "epi_db": 0,
                "epi_dzdb": 7 * layers if epilogue else 0}
    return {name: per_step[name] * steps for name in KERNELS}


def grad_of(model, name: str) -> torch.Tensor:
    return dict(model.named_parameters())[name].grad


@dataclasses.dataclass
class LoraRun:
    launches: dict
    step_ms: list
    loss: list
    norm: list
    one_more_step: object


def train_lora_steps(cfg: VLBConfig, sd: dict, batches: list, dev, fresh: bool,
                     steps: int = N_BATCHES) -> LoraRun:
    """``steps`` steps of ``train_batches`` at batch 3 on ``sd``'s tensors
    (assigned, not copied), with the launch counts the code implies and
    gradients on layer 0's adapters: from fresh adapters (lora_b = 0)
    lora_b's is non-zero and lora_a's exactly 0 at step 1 and non-zero at
    step 2; otherwise both are non-zero from step 1. The run's record holds
    a closure that runs one more step."""
    model = VideoLLaMA2VLB.from_state_dict(cfg, sd)
    optimizer = AdamWCosine(trainable_parameters(model))
    n_train = sum(p.numel() for p in optimizer.params)
    mcfg = cfg.mistral
    ring = None if mcfg.attention_impl == "auto" else mcfg.attention_impl
    print(f"  {mcfg.num_hidden_layers} layers, base {mcfg.base_quant or 'bf16'}, fused epilogue "
          f"{mcfg.lora.fused_epilogue or 'off'}, attention {mcfg.attention_impl}"
          + (f" on {RING_RANKS} ranks of the card" if ring else "")
          + f", {n_train / 1e6:.3f} M trainable ({len(optimizer.params)} tensors), batch {LORA_BATCH}")
    seeds = torch.Generator().manual_seed(SEED)
    q_a, q_b = (f"model.layers.0.self_attn.q_proj.lora_{x}" for x in "ab")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    runs = []
    for step in range(steps):
        runs.append(train_batches(model, [batches[step]], device=dev, generator=seeds,
                                  optimizer=optimizer))
        ga, gb = grad_of(model, q_a), grad_of(model, q_b)
        print(f"  step {step + 1}: |grad| layer 0 q_proj lora_a {ga.norm().item():.4e}, "
              f"lora_b {gb.norm().item():.4e}")
        if not (gb.abs().max() > 0 and torch.isfinite(gb).all() and torch.isfinite(ga).all()):
            raise AssertionError(f"step {step + 1}: layer 0's lora_b needs a non-zero finite gradient")
        if fresh and step == 0 and ga.abs().max() != 0:
            raise AssertionError("step 1: with lora_b = 0, layer 0's lora_a gradient must be exactly 0")
        if (step >= 1 or not fresh) and not ga.abs().max() > 0:
            raise AssertionError(f"step {step + 1}: layer 0's lora_a needs a non-zero gradient")
    launches = read_launches()
    step_ms = [float(r["step_ms"][0]) for r in runs]
    loss = [float(r["brain_loss"][0]) for r in runs]
    norm = [float(r["grad_norm"][0]) for r in runs]
    print(f"  step ms {[round(x, 3) for x in step_ms]}, brain_loss {[round(x, 5) for x in loss]}, "
          f"grad norm {[round(x, 5) for x in norm]}, launches {launches}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not np.isfinite(loss + norm).all():
        raise AssertionError("non-finite LoRA training loss or gradient norm")
    expected = expected_train_launches(mcfg.num_hidden_layers, steps,
                                       epilogue=bool(mcfg.lora.fused_epilogue),
                                       int8=mcfg.base_quant is not None, ring=ring)
    if launches != expected:
        raise AssertionError(f"LoRA training launched {launches}, want {expected}")
    check_ring_sends(launches, "LoRA training")
    if steps > 1:
        print(f"  clips/s at batch {LORA_BATCH} (steps 2-{steps}): "
              f"{[round(LORA_BATCH / (x / 1e3), 3) for x in step_ms[1:]]}")

    def one_more_step():
        train_batches(model, [batches[-1]], device=dev, generator=seeds, optimizer=optimizer)

    return LoraRun(launches, step_ms, loss, norm, one_more_step)


def lora_batches(cfg: VLBConfig, gen, dev, frames: bool = False) -> list:
    return synthetic_batches(cfg, N_BATCHES + 1, LORA_BATCH, np.random.default_rng(SEED), gen, dev,
                             frames=frames)


def train_through_the_ring(sd: dict, start: dict, batches: list, first: LoraRun, dev) -> dict[str, int]:
    """Phase 7's starting adapters and head again (``start``), on the same
    bf16 weights and batches: 3 steps through the fused ring (and one more
    under ``torch.profiler``) and 2 through the per-step flash ring on
    RING_RANKS ranks of the card. Each first step's loss and gradient norm
    are held against phase 7's. Returns the fused ring run's launch
    counts."""
    set_sequence_ring(SequenceRing([dev] * RING_RANKS))
    runs = {}
    try:
        for impl, steps in (("ring_fused", N_BATCHES), ("ring_flash", 2)):
            with phase(f"8c LoRA train through the {impl} ring at full width"):
                for key, t in start.items():
                    sd[key].copy_(t)
                mistral = dataclasses.replace(lora_train_config().mistral, attention_impl=impl)
                run = train_lora_steps(lora_train_config(mistral), sd, batches, dev, fresh=True,
                                       steps=steps)
                loss_rel = abs(run.loss[0] - first.loss[0]) / abs(first.loss[0])
                norm_rel = abs(run.norm[0] - first.norm[0]) / abs(first.norm[0])
                print(f"  step 1 against phase 7's: brain_loss {run.loss[0]:.6f} vs {first.loss[0]:.6f} "
                      f"(|err|/|ref| {loss_rel:.3e}), grad norm {run.norm[0]:.6f} vs {first.norm[0]:.6f} "
                      f"({norm_rel:.3e}); tol {RING_STEP_TOL}")
                print(f"  step ms {[round(x, 3) for x in run.step_ms]} through the ring, "
                      f"{[round(x, 3) for x in first.step_ms[:steps]]} in phase 7 (flash, one run)")
                if not (loss_rel <= RING_STEP_TOL and norm_rel <= RING_STEP_TOL):
                    raise AssertionError(f"the {impl} LoRA step disagrees with the flash step")
                if impl == "ring_fused":
                    traced(run.one_more_step, "LoRA train step through the fused ring")
                run.one_more_step = None
                runs[impl] = run
                torch.cuda.empty_cache()
    finally:
        set_sequence_ring(None)
    return runs["ring_fused"].launches


def train_lora_full(gen, dev) -> tuple[dict[str, int], dict[str, int]]:
    """Phases 7, 8, 8v, 8c and 8b on one set of full-width weights: bf16
    without and with the fused epilogue, from frames, through the rings,
    then quantized in place (the decoder's projections and the tower's) for
    the w8a8g8 step. Returns the w8a8g8 run's launch counts (every kernel
    but the ring's) and the fused ring run's."""
    cfg = lora_train_config()
    sd = init_params(cfg, dev, gen)
    start = {key: t.clone() for key, t in sd.items() if trainable_predicate(key)}
    batches = lora_batches(cfg, gen, dev)
    first = train_lora_steps(cfg, sd, batches, dev, fresh=True)
    with phase("8 profile one LoRA step"):
        traced(first.one_more_step, "LoRA train step")
        first.one_more_step = None
        torch.cuda.empty_cache()
    with phase("8 LoRA train with the fused epilogue"):
        on = train_lora_steps(lora_train_config(fused_epilogue="pallas"), sd, lora_batches(cfg, gen, dev),
                              dev, fresh=False)
        print(f"  step ms with the fused epilogue off {[round(x, 3) for x in first.step_ms[1:]]}, "
              f"on {[round(x, 3) for x in on.step_ms[1:]]} (steps 2-3, one run)")
        del on
        torch.cuda.empty_cache()
    with phase("8v LoRA train from frames at full width"):
        frame_batches = lora_batches(cfg, gen, dev, frames=True)
        frames = train_lora_steps(cfg, sd, frame_batches, dev, fresh=False)
        print(f"  step ms from frames {[round(x, 3) for x in frames.step_ms[1:]]}, from cached tokens "
              f"{[round(x, 3) for x in first.step_ms[1:]]} in phase 7 (steps 2-3, one run)")
        # The step traced for the device alone (tracing the host's ops of a
        # whole step costs host memory the RSS bound has little room for),
        # then its batch's encode_video with its vision range.
        _, step_kernels = traced(frames.one_more_step, "LoRA train step from frames")
        towers = VideoLLaMA2VLB.from_state_dict(cfg, sd)
        groups, _ = traced(lambda: towers.encode_video(frame_batches[-1]["vision"]),
                           f"encode_video at batch {LORA_BATCH}", span="vision")
        print(f"  vision share of the LoRA step from frames: {groups['vision']:.3f} ms of "
              f"{sum(step_kernels.values()):.3f} ms device time "
              f"({groups['vision'] / sum(step_kernels.values()):.1%})")
        del frames, frame_batches, towers
        torch.cuda.empty_cache()
    ring_launches = train_through_the_ring(sd, start, batches, first, dev)
    with phase("8r the decoder's checkpoint policies (remat_policy) on phase 7's weights"):
        remat_policies(sd, start, batches, dev, card_name_and_power())
    del start, batches
    with phase("8b w8a8g8 LoRA train at full width"):
        t0 = time.perf_counter()
        quantize_state_dict(sd)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = [t for k, t in sd.items() if k.endswith((".weight_q", ".weight_scale"))]
        print(f"  quantized {len(base) // 2} projections (the decoder's and the tower's) on the card in place in "
              f"{time.perf_counter() - t0:.2f} s: int8 base {sum(t.numel() * t.element_size() for t in base) / 1e9:.2f} GB, "
              f"device memory now {torch.cuda.memory_allocated() / 1e9:.2f} GB")
        del base
        cfg8 = lora_train_config(fused_epilogue="pallas", base_quant="w8a8g8")
        w8 = train_lora_steps(cfg8, sd, lora_batches(cfg, gen, dev), dev, fresh=False)
    with phase("8b profile one w8a8g8 LoRA step"):
        groups, by_kernel = traced(w8.one_more_step, "w8a8g8 LoRA train step")
        print(f"  epilogue group (epi_fwd + epi_dzdb) {groups.get('epilogue', 0.0):.3f} ms of device time, "
              f"epi_fwd {kernel_ms(by_kernel, 'epi_fwd'):.3f} ms")
    return w8.launches, ring_launches


def train_baseline_full(gen, dev) -> None:
    cfg = VLBConfig.full()
    model = VideoLLaMA2VLB.from_state_dict(cfg, init_params(cfg, dev, gen))
    batches = synthetic_batches(cfg, N_BATCHES, BATCH, np.random.default_rng(SEED), gen, dev)
    torch.cuda.synchronize()
    reset_launches()
    res = train_batches(model, batches, device=dev, generator=torch.Generator().manual_seed(SEED))
    launches = read_launches()
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"  {n_train} trainable (head only), step ms {[round(float(x), 3) for x in res['step_ms']]}, "
          f"brain_loss {[round(float(x), 5) for x in res['brain_loss']]}, launches {launches}")
    want = {n: (cfg.mistral.num_hidden_layers * N_BATCHES if n == "flash_fwd" else 0) for n in KERNELS}
    if launches != want or not np.isfinite(res["brain_loss"]).all():
        raise AssertionError(f"baseline training: launches {launches} (want {want}), "
                             f"loss {res['brain_loss']}")


def narrow_mistral(dtype, lora=None) -> MistralConfig:
    return MistralConfig.tiny(
        vocab_size=32000, hidden_size=256, intermediate_size=512, num_attention_heads=2,
        num_key_value_heads=1, head_dim=D, dtype=dtype, lora=lora, remat=lora is not None,
    )


def narrow_towers(dtype, base_quant: str | None = None) -> dict:
    """The vision path at the serving geometry (336 px, 12 frames -> 1183
    tokens), narrow: 2 CLIP layers 256 wide (4 heads of 64), an STC of depth
    1 from 256 through 512 to the decoder's 256."""
    clip = CLIPVisionConfig(hidden_size=256, intermediate_size=1024, num_attention_heads=4,
                            num_hidden_layers=3, dtype=dtype, base_quant=base_quant)
    stc = STCConfig(encoder_hidden_size=256, hidden_size=512, output_hidden_size=256, depth=1, dtype=dtype)
    return {"clip": clip, "stc": stc}


def narrow_reference_check(gen, dev, frames: bool = False) -> None:
    """A 2-layer, 256-wide model at the serving geometry: card (bf16, kernels)
    against the same weights in f32 on the CPU (plain versions), at batch 2;
    with ``frames``, at batch 1 (the CPU's f32 towers hold the host's
    memory) served from frames through the narrow towers, whose video
    tokens are compared too."""
    cfg = VLBConfig.full(mistral=narrow_mistral(torch.bfloat16), **narrow_towers(torch.bfloat16))
    sd = init_params(cfg, dev, gen)
    rows = 1 if frames else 2
    batches = synthetic_batches(cfg, 1, rows, np.random.default_rng(SEED), gen, dev, frames=frames)
    card_model = VideoLLaMA2VLB.from_state_dict(cfg, sd)
    card = predict_batches(card_model, batches, dev)
    cfg32 = dataclasses.replace(cfg, mistral=narrow_mistral(torch.float32), **narrow_towers(torch.float32))
    cpu_model = VideoLLaMA2VLB.from_state_dict(cfg32, sd, device="cpu")
    cpu_batches = [{k: torch.as_tensor(v).cpu() for k, v in bt.items()} for bt in batches]
    ref = predict_batches(cpu_model, cpu_batches, "cpu")
    check_predictions(card, rows, cfg.num_target)
    err = np.abs(card["predicted"] - ref["predicted"]).max()
    scale = np.abs(ref["predicted"]).max()
    label = "narrow model from frames (2 CLIP layers, STC depth 1)" if frames else "narrow model"
    print(f"  {label}: preds max|card - cpu f32| {err:.3e} (tol {PRED_TOL}), max|pred| {scale:.3f}")
    if not err <= PRED_TOL:
        raise AssertionError(f"{label} on the card disagrees with its f32 CPU reference")
    if frames:
        tokens = card_model.encode_video(batches[0]["vision"]).float().cpu()
        want = cpu_model.encode_video(cpu_batches[0]["vision"])
        rel = rel_err(tokens, want)
        print(f"  narrow towers: video tokens {tuple(tokens.shape)} max|card - cpu f32| / max|cpu| {rel:.3e} "
              f"(tol {NARROW_TOKENS_TOL}), max|token| {want.abs().max().item():.3f}")
        if not rel <= NARROW_TOKENS_TOL:
            raise AssertionError("the narrow towers on the card disagree with their f32 CPU reference")


def narrow_lora_check(gen, dev, base_quant: str | None = None, attention_impl: str = "auto") -> None:
    """One LoRA step's loss and adapter gradients of the narrow model (fused
    hash dropout at p 0.1, which the CPU's plain version reproduces bit for
    bit; head dropout off, whose mask comes from a device generator). With
    ``base_quant`` the projections are int8 (the same codes and scales on
    both sides) and the epilogue fused, so every kernel of the w8a8g8 path
    runs on the card. With a ring ``attention_impl`` the card's model runs
    it on 2 ranks of the card, against plain attention on the CPU."""
    lora = LoRAConfig(rank=16, alpha=32.0, dropout=LORA_P, dropout_bits=8, fused_dropout=True,
                      fused_epilogue="pallas" if base_quant else "")

    def mistral(dtype, impl="auto"):
        return dataclasses.replace(narrow_mistral(dtype, lora), base_quant=base_quant,
                                   attention_impl=impl)

    cfg = lora_train_config(mistral(torch.bfloat16, attention_impl), base_quant=base_quant,
                            dropout_rate=0.0, **narrow_towers(torch.bfloat16, base_quant))
    sd = init_params(cfg, dev, gen)
    for key in sd:
        if key.endswith("lora_b"):       # non-zero, so lora_a's gradient is too
            sd[key] = 0.05 * torch.randn(sd[key].shape, generator=gen, device=dev)
    batch = synthetic_batches(cfg, 1, 1, np.random.default_rng(SEED), gen, dev)[0]
    results = []
    set_sequence_ring(SequenceRing([dev] * 2))
    cfg32 = dataclasses.replace(cfg, mistral=mistral(torch.float32), **narrow_towers(torch.float32, base_quant))
    for device, mcfg in ((dev, cfg), ("cpu", cfg32)):
        model = VideoLLaMA2VLB.from_state_dict(mcfg, sd, device=device)
        trainable_parameters(model)
        model.train()
        loss = loss_fn(model, {k: torch.as_tensor(v).to(device) for k, v in batch.items()}, seed=77)[0]
        loss.backward()
        grads = {n: p.grad.float().cpu() for n, p in model.named_parameters() if "lora_" in n}
        results.append((loss.item(), grads))
        del model
    set_sequence_ring(None)
    (loss_c, g_c), (loss_r, g_r) = results
    loss_rel = abs(loss_c - loss_r) / abs(loss_r)
    flat_c = torch.cat([g_c[n].flatten() for n in sorted(g_r)])
    flat_r = torch.cat([g_r[n].flatten() for n in sorted(g_r)])
    grad_rel = rel_err(flat_c, flat_r)
    cos = min(F.cosine_similarity(g_c[n].flatten().double(), g_r[n].flatten().double(), dim=0).item()
              for n in g_r)
    label = f"narrow {base_quant or 'bf16'} LoRA step" + (
        f" through the {attention_impl} ring on 2 ranks" if attention_impl != "auto" else "")
    print(f"  {label}: loss card {loss_c:.6f} cpu f32 {loss_r:.6f} (|err|/|ref| {loss_rel:.3e}); adapter "
          f"grads max|err|/max|ref| {grad_rel:.3e}, least cosine {cos:.6f} over {len(g_r)} tensors, "
          f"max|ref| {flat_r.abs().max().item():.4e}")
    if base_quant:
        ok = loss_rel <= W8_LOSS_TOL and cos >= W8_GRAD_COS
        print(f"  tolerances: loss {W8_LOSS_TOL}, cosine >= {W8_GRAD_COS} for every tensor")
    else:
        ok = loss_rel <= LORA_LOSS_TOL and grad_rel <= LORA_GRAD_TOL
        print(f"  tolerances: loss {LORA_LOSS_TOL}, gradients {LORA_GRAD_TOL}")
    if not (ok and flat_c.abs().max() > 0 and all(g_c[n].abs().max() > 0 for n in g_c)):
        raise AssertionError(f"{label} on the card disagrees with its f32 CPU reference")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_bwd_probes(dev) -> None:
    """The flash backward's main kernel alone, as built and with each cost
    probe, at the training shape and at the ring's step (S_loc, offset
    S_loc): CUDA events over 20 launches on the same inputs, the builds
    taken in turns twice and the lower kept; printed."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    s_loc = REFERENCE_GEOMETRY.feature_len // RING_RANKS
    builds = {"as built": FLASH_BWD, **BWD_PROBES}
    for b, s, offset in ((LORA_BATCH, REFERENCE_GEOMETRY.feature_len, 0), (LORA_BATCH, s_loc, s_loc)):
        q, k, v, kv_mask = attention_inputs(b, s, gen, dev)
        o, lse = attention_packed(q, k, v, HQ, HKV, kv_mask=kv_mask, causal_offset=offset)
        do = torch.randn(o.shape, generator=gen, device=dev, dtype=torch.bfloat16)
        bias, inp = kv_bias(kv_mask), flash_bwd_prep(q, o, do, lse, HQ)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        stream = torch.cuda.current_stream().cuda_stream
        times = {}
        for _ in range(2):
            for name, kernel in builds.items():
                times.setdefault(name, []).append(cuda_ms(lambda kernel=kernel: kernel.launch(
                    inp.qs.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), do.data_ptr(),
                    inp.lse.data_ptr(), inp.di.data_ptr(), inp.acc.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), b, s, HQ, HKV, inp.lse.shape[-1], offset, stream), 20, warmup=3))
        base = min(times["as built"])
        print(f"  flash_bwd main kernel B={b} S={s} causal_offset={offset}, cost probes (CUDA events): "
              + ", ".join(f"{name} {min(t):.4f} ms ({min(t) - base:+.4f})" for name, t in times.items()))
        del q, k, v, o, lse, do, bias, inp, dk, dv


def time_fwd_probes(dev) -> None:
    """The flash forward kernel alone, as built and with each cost probe of
    its core, at the serving shape (masked) and at the ring's step (S_loc,
    offset S_loc): CUDA events over 20 launches on the same inputs, the
    builds taken in turns twice and the lower kept; printed."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    s_loc = REFERENCE_GEOMETRY.feature_len // RING_RANKS
    builds = {"as built": FLASH_FWD, **FWD_PROBES}
    for b, s, offset in ((BATCH, REFERENCE_GEOMETRY.feature_len, 0), (LORA_BATCH, s_loc, s_loc)):
        q, k, v, kv_mask = attention_inputs(b, s, gen, dev)
        bias = kv_bias(kv_mask)
        out, lse = torch.empty_like(q), torch.empty(b, HQ, s, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        times = {}
        for _ in range(2):
            for name, kernel in builds.items():
                times.setdefault(name, []).append(cuda_ms(lambda kernel=kernel: kernel.launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), b, s, HQ, HKV, D ** -0.5, offset, stream), 20, warmup=3))
        base = min(times["as built"])
        print(f"  flash_fwd kernel B={b} S={s} causal_offset={offset}, cost probes (CUDA events): "
              + ", ".join(f"{name} {min(t):.4f} ms ({min(t) - base:+.4f})" for name, t in times.items()))
        del q, k, v, kv_mask, bias, out, lse


def traced_kernels(fn, iters: int, kernel: str = "", warmup: int = 2, tries: int = 3) -> dict[str, float]:
    """Device time per call of every kernel ``fn`` launches, by kernel name
    (``torch.profiler``). The tracer drops sessions, or some of a session's
    records, now and then, so up to ``tries`` sessions that recorded any
    device time are taken (and as many more that recorded none). With
    ``kernel`` named, the first whose records of the kernels whose name
    holds it number a nonzero multiple of ``iters`` (each call launches
    the same) is returned; when none does, each kernel's mean over what the
    sessions recorded times the most launches a call made in any of them
    (at least 1), which is printed; when none recorded those kernels, this
    raises. With none named, the session with the most device time is
    returned (dropped records only lower it). When no session recorded any
    device time, named or not, the call's time by CUDA events (host gaps
    included) is returned under the kernel's name, printed."""
    for _ in range(warmup):
        fn()
    sessions = []
    for _ in range(2 * tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
        del prof
        release_host_memory()
        count = sum(n for key, _, n in events if kernel and kernel in key)
        if count and count % iters == 0:
            return {key: t / iters for key, t, _ in events}
        if events:
            sessions.append(events)
            if len(sessions) == tries:
                break
    if not sessions:
        print(f"  (no trace of {kernel or 'the call'} recorded in {2 * tries} sessions: its time by CUDA events)")
        return {f"{kernel}: the call, by CUDA events" if kernel else "the call, by CUDA events":
                cuda_ms(fn, iters, warmup=0)}
    if not kernel:
        return max(({key: t / iters for key, t, _ in ev} for ev in sessions), key=lambda t: sum(t.values()))
    totals: dict[str, list[float]] = {}                  # key: [time, records, most records]
    for events in sessions:
        for key, t, n in events:
            acc = totals.setdefault(key, [0.0, 0, 0])
            acc[0], acc[1], acc[2] = acc[0] + t, acc[1] + n, max(acc[2], n)
    times = {key: t / n * max(1, round(most / iters)) for key, (t, n, most) in totals.items()}
    if kernel_ms(times, kernel) <= 0:
        raise RuntimeError(f"torch.profiler recorded no device time for {kernel} in {tries} sessions, only "
                           f"{sorted(times)[:4]}")
    print(f"  (no whole trace of {kernel} in {tries} sessions: per-launch means of what was recorded)")
    return times


def kernel_ms(times: dict[str, float], name: str) -> float:
    return sum(t for key, t in times.items() if name in key)


def device_ms(fn, iters: int, kernel: str = "", warmup: int = 2, tries: int = 3) -> tuple[float, float]:
    """Device time per call of the kernels whose name holds ``kernel``, and
    of every kernel the call launches (traced_kernels)."""
    times = traced_kernels(fn, iters, kernel, warmup, tries)
    return kernel_ms(times, kernel), sum(times.values())


def timed(kernel_fn, kernel: str, plain_fn, library_fn, iters: int) -> dict:
    """The kernel's own device time, the device time of everything its
    wrapper, the plain version and the library call launch, and the
    wrapper's CUDA-event time per call (which includes host gaps)."""
    ms, wrapper_ms = device_ms(kernel_fn, iters, kernel)
    return {"ms": ms, "wrapper_ms": wrapper_ms, "wrapper_event_ms": cuda_ms(kernel_fn, iters),
            "plain_ms": device_ms(plain_fn, 2, warmup=1)[1],
            "library_ms": device_ms(library_fn, iters)[1]}


def report(name: str, shape: str, rec: dict, flops: float, nbytes: float,
           peak_flops: float = PEAK_BF16_FLOPS) -> None:
    rec.update(bound(flops, nbytes, peak_flops))
    print(f"  {name} {shape}: kernel {rec['ms']:.4f} ms (wrapper {rec['wrapper_ms']:.4f} ms on the device, "
          f"{rec['wrapper_event_ms']:.4f} ms by CUDA events), plain {rec['plain_ms']:.4f} ms, library "
          f"{rec['library_ms']:.4f} ms; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB -> bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); {flops / rec['ms'] / 1e9:.1f} TFLOP/s, "
          f"{nbytes / rec['ms'] / 1e6:.1f} GB/s achieved")


def kernels_a_call(fn, iters: int = 10, tries: int = 10) -> float:
    """The kernels one call of ``fn`` launches: ``iters`` warm calls traced,
    their kernel records over the calls. The tracer drops whole sessions
    now and then, so up to ``tries`` sessions, until one recorded any."""
    fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        count = sum(e.count for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0)
        del prof
        if count:
            return count / iters
    raise RuntimeError(f"torch.profiler recorded no kernel of the call in {tries} sessions")


def report_whole_call(name: str, shape: str, rec: dict, fn) -> None:
    """The whole call's device time (every kernel the wrapper launches)
    against the bound, and the kernels a call; printed, and kept in
    ``rec`` (not in the JSON line)."""
    rec["kernels_a_call"] = kernels_a_call(fn)
    print(f"  {name} {shape}: whole call {rec['wrapper_ms']:.4f} ms of device time, "
          f"{rec['bound_ms'] / rec['wrapper_ms']:.1%} of the bound; {rec['kernels_a_call']:g} kernel(s) a call "
          f"(the kernel alone {rec['ms']:.4f} ms, {rec['bound_ms'] / rec['ms']:.1%})")


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def time_flash(gen, dev) -> dict[str, dict]:
    """Flash forward at the serving shape, backward at the training shape;
    the library is SDPA with the same causal + padding mask (timed only)."""
    out = {}
    s = REFERENCE_GEOMETRY.feature_len

    def keep_mask(kv_mask):
        n = kv_mask.shape[1]
        return torch.ones(n, n, dtype=torch.bool, device=dev).tril()[None, None] & (kv_mask > 0)[:, None, None, :]

    b = BATCH
    q, k, v, kv_mask = attention_inputs(b, s, gen, dev)
    q4, k4, v4 = (t.view(b, s, -1, D).transpose(1, 2) for t in (q, k, v))
    keep = keep_mask(kv_mask)
    out["flash_fwd"] = timed(
        lambda: attention_packed(q, k, v, HQ, HKV, kv_mask=kv_mask), "flash_fwd_kernel",
        lambda: attention_packed_plain(q, k, v, HQ, HKV, kv_mask=kv_mask),
        lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=keep, enable_gqa=True), 10)
    # q, k, v and the bias row read once; out and lse written once.
    report("flash_fwd", f"B={b} S={s}", out["flash_fwd"], 4 * b * HQ * D * s * (s + 1) // 2,
           (2 * q.numel() + k.numel() + v.numel()) * 2 + (b * HQ * s + b * s) * 4)
    # SDPA's causal forward without the padding mask (the unmasked function,
    # the fastest PyTorch call of this shape): a yardstick only, printed.
    causal = traced_kernels(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                                   enable_gqa=True), 10)
    print(f"  flash_fwd B={b} S={s}: SDPA is_causal (no padding mask) {sum(causal.values()):.4f} ms device "
          f"time ({top_kernels(causal)}), against the masked SDPA's {out['flash_fwd']['library_ms']:.4f} "
          f"and the kernel's {out['flash_fwd']['ms']:.4f}")
    del q, k, v, q4, k4, v4, keep

    b = LORA_BATCH
    out.update(time_flash_bwd(b, s, gen, dev, keep_mask, 10, json_record=True))
    # Where the reference takes its split backward (_dq_kernel + _dkv_kernel,
    # skv > 4096): printed, not in the JSON line.
    time_flash_bwd(1, 4608, gen, dev, keep_mask, 5)
    # A step of the per-step ring: a chunk of S_loc = 512 against an earlier
    # rank's whole chunk (offset S_loc, no mask), by CUDA events; printed.
    b, s = LORA_BATCH, REFERENCE_GEOMETRY.feature_len // RING_RANKS
    q, k, v, kv_mask = attention_inputs(b, s, gen, dev)
    o, lse = attention_packed(q, k, v, HQ, HKV, kv_mask=kv_mask, causal_offset=s)
    do = torch.randn(o.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    fwd_ms = cuda_ms(lambda: attention_with_stats(q, k, v, HQ, HKV, kv_mask=kv_mask, causal_offset=s), 20)
    fwd_dev = device_ms(lambda: attention_with_stats(q, k, v, HQ, HKV, kv_mask=kv_mask, causal_offset=s), 20,
                        "flash_fwd_kernel")[0]

    def ring_step_bwd():
        return attention_packed_bwd(q, k, v, o, lse, do, HQ, HKV, kv_mask=kv_mask, causal_offset=s)

    bwd_ms = cuda_ms(ring_step_bwd, 20)
    parts = traced_kernels(ring_step_bwd, 20, "flash_bwd")
    print(f"  flash_fwd / flash_bwd B={b} S={s} causal_offset={s}: {fwd_ms:.4f} / {bwd_ms:.4f} ms per "
          f"call (CUDA events, wrappers included); backward device time: "
          + ", ".join(f"{name} {kernel_ms(parts, kernel):.4f}" for name, kernel in BWD_PARTS.items())
          + f"; forward kernel {fwd_dev:.4f} ms device time"
          + f"; bounds {2 * 2 * b * HQ * D * s * s / PEAK_BF16_FLOPS * 1e3:.4f}"
          f" / {5 * 2 * b * HQ * D * s * s / PEAK_BF16_FLOPS * 1e3:.4f} ms (operations)")
    return out


def top_kernels(times: dict[str, float], n: int = 4) -> str:
    return "; ".join(f"{key[:72]} {t:.4f}" for key, t in sorted(times.items(), key=lambda x: -x[1])[:n])


def time_flash_bwd(b: int, s: int, gen, dev, keep_mask, iters: int,
                   json_record: bool = False) -> dict[str, dict]:
    """The port's whole backward (prep + main + post, each kernel's device
    time and their sum) at (b, s) with padding, beside its plain version,
    SDPA's backward with the same boolean causal + padding mask (the
    library yardstick; the kernels it ran are printed) and SDPA's backward
    with ``is_causal=True`` and no mask (PyTorch's flash backend, printed).
    Returns the records of the three kernels when ``json_record``."""
    q, k, v, kv_mask = attention_inputs(b, s, gen, dev)
    o, lse = attention_packed(q, k, v, HQ, HKV, kv_mask=kv_mask)
    do = torch.randn(o.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    q4, k4, v4 = (t.view(b, s, -1, D).transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    do4 = do.view(b, s, -1, D).transpose(1, 2)
    o4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=keep_mask(kv_mask), enable_gqa=True)
    sdpa = traced_kernels(lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True), iters)
    del o4
    o4c = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True, enable_gqa=True)
    sdpa_causal = traced_kernels(lambda: torch.autograd.grad(o4c, (q4, k4, v4), do4, retain_graph=True),
                                 iters)
    del o4c, q4, k4, v4, do4

    def whole():
        return attention_packed_bwd(q, k, v, o, lse, do, HQ, HKV, kv_mask=kv_mask)

    parts = traced_kernels(whole, iters, "flash_bwd")
    ms = {name: kernel_ms(parts, kernel) for name, kernel in BWD_PARTS.items()}
    s_pad = bwd_padded_len(s)
    inp = flash_bwd_prep(q, o, do, lse, HQ)
    rec = {"ms": sum(ms.values()), "main_ms": ms["flash_bwd"], "wrapper_ms": sum(parts.values()),
           "wrapper_event_ms": cuda_ms(whole, iters),
           "plain_ms": device_ms(lambda: attention_packed_bwd_plain(q, k, v, o, lse, do, HQ, HKV,
                                                                    kv_mask=kv_mask), 2, warmup=1)[1],
           "library_ms": sum(sdpa.values())}
    prep = {"ms": ms["flash_bwd_prep"], "library_ms": None,
            "plain_ms": device_ms(lambda: flash_bwd_prep_plain(q, o, do, lse, HQ), iters)[1],
            # q, o, do and lse read once; q_s, the padded lse and di, and the
            # zeroed accumulator written once.
            **bound(3 * q.numel(), 4 * q.numel() * 2 + b * HQ * s * 4 + 2 * b * HQ * s_pad * 4
                    + b * HQ * s_pad * D * 4, PEAK_F32_FLOPS)}
    post = {"ms": ms["flash_bwd_post"], "library_ms": None,
            "plain_ms": device_ms(lambda: flash_bwd_post_plain(inp.acc, s, D ** -0.5), iters)[1],
            # The accumulator's rows below S read once, dq written once.
            **bound(q.numel(), b * HQ * s * D * 4 + q.numel() * 2, PEAK_F32_FLOPS)}
    del inp
    # Five products over the causal half. q, o, do read and dq written (Hq
    # wide); k, v read and dk, dv written (Hkv wide); lse and bias read.
    flops = 10 * b * HQ * D * s * (s + 1) // 2
    rec.update(bound(flops, 4 * q.numel() * 2 + 4 * k.numel() * 2 + (b * HQ * s + b * s) * 4))
    print(f"  flash_bwd B={b} S={s}: whole backward {rec['ms']:.4f} ms of device time (prep "
          f"{prep['ms']:.4f} + main {rec['main_ms']:.4f} + post {post['ms']:.4f}; everything the wrapper "
          f"launches {rec['wrapper_ms']:.4f}, {rec['wrapper_event_ms']:.4f} by CUDA events); SDPA backward "
          f"with the boolean mask {rec['library_ms']:.4f} ms [{top_kernels(sdpa)}]; SDPA is_causal without "
          f"padding {sum(sdpa_causal.values()):.4f} ms [{top_kernels(sdpa_causal)}]; plain "
          f"{rec['plain_ms']:.4f} ms; {flops / 1e9:.2f} GFLOP -> bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}): whole {rec['bound_ms'] / rec['ms']:.1%} of it, main kernel "
          f"{rec['bound_ms'] / rec['main_ms']:.1%}, {flops / rec['main_ms'] / 1e9:.1f} TFLOP/s in the main "
          f"kernel")
    for name, r in (("flash_bwd_prep", prep), ("flash_bwd_post", post)):
        print(f"  {name} B={b} S={s}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} of it)")
    del q, k, v, o, lse, do
    torch.cuda.empty_cache()
    return {"flash_bwd_prep": prep, "flash_bwd": rec, "flash_bwd_post": post} if json_record else {}


def lora_reduce_launcher(kernel, name: str, x, a, dmid, seed: int, thr: int):
    """A closure that makes one launch of the forward's (``name``
    lora_fwd) or dA's launcher ``kernel`` (as built or a cost probe) on x
    and A or dmid in hash mode, with the wrapper's plan and scale, the
    output made once."""
    m, k = x.shape
    r, da = a.shape[1], name == "lora_da"
    cs, clusters, resident = (_da_plan if da else _fwd_plan)(m, k, r, caps=_cluster_capacity(x.device, r, da))
    out = torch.empty((k, r) if da else (m, r), dtype=torch.float32 if da else x.dtype, device=x.device)
    scale = float(torch.tensor(1.0 / (1.0 - thr / 256.0), dtype=x.dtype))
    args = (x.data_ptr(), (dmid if da else a).data_ptr(), None, out.data_ptr(), m, k, r, cs, clusters,
            int(resident), seed, 0, 0, thr, scale, torch.cuda.current_stream().cuda_stream)
    return lambda: (kernel.launch(*args), out)


def time_lora(gen, dev) -> dict[str, dict]:
    """The three kernels (hash mode) at M = 6144, K = 4096 and 14336; the
    library is the unfused torch sequence on a precomputed mask (timed
    only). The 32-bit rule's keep kernel against its plain draw and
    ``torch.rand`` with the compare (its library), 1 byte written an
    element; and the three kernels in bits mode on its bytes at the rule's
    f32 scale against the eager route's ops on the same bytes (printed
    only). The JSON carries K = 4096, the input width of 6 of a layer's 7
    sites."""
    thr, _ = dropout_threshold(LORA_P)
    keep32 = 1.0 - LORA_P
    thr32, scale32, _ = dropout_rule(LORA_P, 32, torch.bfloat16)
    bf16_keep = float(torch.tensor(keep32, dtype=torch.bfloat16))
    threads = _card_threads(dev.index or 0)
    out = {}
    m, r = LORA_M, LORA_R
    for k in LORA_KS:
        x, a, dmid = lora_inputs(k, gen, dev)
        scale = torch.tensor(1.0 / (1.0 - thr / 256.0), dtype=torch.bfloat16, device=dev)
        mask_scale = (hash_bytes(7, m, k, dev) >= thr).to(torch.bfloat16) * scale
        cases = {
            "lora_fwd": (lambda: fused_dropout_matmul(x, a, 7, LORA_P), "lora_fwd_kernel",
                         lambda: fused_dropout_matmul_plain(x, a, 7, thr),
                         lambda: (x * mask_scale) @ a, (m * k + k * r + m * r) * 2),
            "lora_dx": (lambda: fused_dropout_bwd(x, a, dmid, 7, LORA_P, need_da=False), "lora_dx_kernel",
                        lambda: fused_dropout_bwd_plain(x, a, dmid, 7, thr),
                        lambda: (dmid @ a.T) * mask_scale, (m * r + k * r + m * k) * 2),
            "lora_da": (lambda: fused_dropout_bwd(x, a, dmid, 7, LORA_P, need_dx=False), "lora_da_kernel",
                        lambda: fused_dropout_bwd_plain(x, a, dmid, 7, thr),
                        lambda: (x * mask_scale).T @ dmid, (m * k + m * r) * 2 + k * r * 4),
        }
        for name, (kernel_fn, kernel, plain_fn, library_fn, nbytes) in cases.items():
            rec = timed(kernel_fn, kernel, plain_fn, library_fn, 20)
            report(name, f"M={m} K={k}", rec, 2 * m * k * r, nbytes)
            if name != "lora_dx":
                report_whole_call(name, f"M={m} K={k}", rec, kernel_fn)
            if k == LORA_KS[0]:
                out[name] = rec
        # The cost probe: each kernel as built and without the mask, device
        # time over 20 launches on the same inputs (at K 4096 a launch takes
        # less device time than the host takes to issue it, so CUDA events
        # would time the host), in turns twice, the lower kept.
        times: dict = {}
        for _ in range(2):
            for name, built in (("lora_fwd", LORA_FWD), ("lora_da", LORA_DA)):
                for label, kernel in (("as built", built), ("no mask", LORA_NO_MASK[name])):
                    times.setdefault((name, label), []).append(device_ms(
                        lora_reduce_launcher(kernel, name, x, a, dmid, 7, thr), 20, f"{name}_kernel")[0])
        for name in ("lora_fwd", "lora_da"):
            base, bare = min(times[name, "as built"]), min(times[name, "no mask"])
            print(f"  {name} M={m} K={k}, cost probe (device time): as built {base:.4f} ms, without the mask "
                  f"{bare:.4f} ms ({bare - base:+.4f}; the stream alone at {m * k * 2 / bare / 1e9:.2f} TB/s of x)")
        # The 32-bit rule: the three kernels in bits mode on the keep
        # kernel's bytes (printed only), then the keep kernel itself.
        keep = keep_bytes((m, k), 7, keep32, dev)
        kept = keep.bool()
        bits32 = {
            "lora_fwd": (lambda: fused_dropout_matmul(x, a, 7, LORA_P, bits=keep, dropout_bits=32),
                         lambda: fused_dropout_matmul_plain(x, a, 7, thr32, keep, scale=scale32),
                         lambda: torch.where(kept, x / bf16_keep, 0.0) @ a),
            "lora_dx": (lambda: fused_dropout_bwd(x, a, dmid, 7, LORA_P, bits=keep, need_da=False, dropout_bits=32),
                        lambda: fused_dropout_bwd_plain(x, a, dmid, 7, thr32, keep, scale=scale32),
                        lambda: torch.where(kept, dmid @ a.T, 0.0) / bf16_keep),
            "lora_da": (lambda: fused_dropout_bwd(x, a, dmid, 7, LORA_P, bits=keep, need_dx=False, dropout_bits=32),
                        lambda: fused_dropout_bwd_plain(x, a, dmid, 7, thr32, keep, scale=scale32),
                        lambda: torch.where(kept, x / bf16_keep, 0.0).T @ dmid),
        }
        for name, (kernel_fn, plain_fn, library_fn) in bits32.items():
            report(f"{name} 32-bit bits mode", f"M={m} K={k}", timed(kernel_fn, f"{name}_kernel", plain_fn,
                                                                     library_fn, 20),
                   2 * m * k * r, lora_bytes(name, m, k, r) + m * k)
        del keep, kept
        rec = timed(lambda: keep_bytes((m, k), 7, keep32, dev), "lora_keep_kernel",
                    lambda: keep_bytes_plain((m, k), 7, keep32, *threads, device=dev),
                    lambda: torch.rand((m, k), generator=torch.Generator(device=dev).manual_seed(7),
                                       device=dev) < keep32, 20)
        report("lora_keep", f"M={m} K={k}", rec, 0, m * k)
        if k == LORA_KS[0]:
            out["lora_keep"] = rec
        del x, a, dmid, mask_scale
    return out


def time_tensor_shapes(gen, dev) -> None:
    """Each kernel of the tensor-parallel step at the shapes one rank of
    mesh.tensor=2 gives it, beside its plain version, a library yardstick
    and the bound (printed only; the JSON keeps the one-card shapes): the
    flash forward and the backward's main kernel with 16 of 32 heads (4 of
    8 kv) at (3, 2048); the LoRA dropout kernels from column K of a
    row-parallel input (o: K 2048, down: 7168); the epilogue's forward and
    fused dz + dB at N 2048, 512 and 7168 (q, k/v, gate/up)."""
    b, s = LORA_BATCH, REFERENCE_GEOMETRY.feature_len
    hq, hkv = TENSOR_HEADS[0]
    q, k, v, kv_mask = attention_inputs(b, s, gen, dev, hq, hkv)
    out, lse = attention_packed(q, k, v, hq, hkv, kv_mask=kv_mask)
    do = torch.randn(out.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    q4, k4, v4 = (t.view(b, s, -1, D).transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    keep = torch.ones(s, s, dtype=torch.bool, device=dev).tril()[None, None] & (kv_mask > 0)[:, None, None, :]
    o4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=keep, enable_gqa=True)
    do4 = do.view(b, s, -1, D).transpose(1, 2)
    fwd_flops = 4 * b * hq * D * s * (s + 1) // 2
    shape = f"B={b} S={s} heads {hq}/{hkv}"
    rec = timed(lambda: attention_packed(q, k, v, hq, hkv, kv_mask=kv_mask), "flash_fwd_kernel",
                lambda: attention_packed_plain(q, k, v, hq, hkv, kv_mask=kv_mask),
                lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=keep, enable_gqa=True), 10)
    report("flash_fwd", shape, rec, fwd_flops, (2 * q.numel() + k.numel() + v.numel()) * 2 + (b * hq * s + b * s) * 4)
    rec = timed(lambda: attention_packed_bwd(q, k, v, out, lse, do, hq, hkv, kv_mask=kv_mask), "flash_bwd_kernel",
                lambda: attention_packed_bwd_plain(q, k, v, out, lse, do, hq, hkv, kv_mask=kv_mask),
                lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True), 10)
    report("flash_bwd", shape, rec, 10 * b * hq * D * s * (s + 1) // 2,
           4 * q.numel() * 2 + 4 * k.numel() * 2 + (b * hq * s + b * s) * 4)
    del q, k, v, out, lse, do, q4, k4, v4, o4, do4, keep
    thr, _ = dropout_threshold(LORA_P)
    m, r = LORA_M, LORA_R
    for kk, col0 in TENSOR_LORA:
        x, a, dmid = lora_inputs(kk, gen, dev)
        mask_scale = ((hash_bytes(7, m, kk, dev, col0=col0) >= thr).to(torch.bfloat16)
                      * torch.tensor(1.0 / (1.0 - thr / 256.0), dtype=torch.bfloat16, device=dev))
        cases = {
            "lora_fwd": (lambda: fused_dropout_matmul(x, a, 7, LORA_P, col0=col0), "lora_fwd_kernel",
                         lambda: fused_dropout_matmul_plain(x, a, 7, thr, col0=col0),
                         lambda: (x * mask_scale) @ a, (m * kk + kk * r + m * r) * 2),
            "lora_dx": (lambda: fused_dropout_bwd(x, a, dmid, 7, LORA_P, need_da=False, col0=col0), "lora_dx_kernel",
                        lambda: fused_dropout_bwd_plain(x, a, dmid, 7, thr, col0=col0),
                        lambda: (dmid @ a.T) * mask_scale, (m * r + kk * r + m * kk) * 2),
            "lora_da": (lambda: fused_dropout_bwd(x, a, dmid, 7, LORA_P, need_dx=False, col0=col0), "lora_da_kernel",
                        lambda: fused_dropout_bwd_plain(x, a, dmid, 7, thr, col0=col0),
                        lambda: (x * mask_scale).T @ dmid, (m * kk + m * r) * 2 + kk * r * 4),
        }
        for name, (kernel_fn, kernel, plain_fn, library_fn, nbytes) in cases.items():
            rec = timed(kernel_fn, kernel, plain_fn, library_fn, 20)
            report(name, f"M={m} K={kk} col0={col0}", rec, 2 * m * kk * r, nbytes)
            if name != "lora_dx":
                report_whole_call(name, f"M={m} K={kk} col0={col0}", rec, kernel_fn)
        del x, a, dmid, mask_scale
    scaling = 32.0 / LORA_R
    for n in TENSOR_EPI_NS:
        y, z, bb, dy = epilogue_inputs(n, gen, dev)
        rec = timed(lambda: lora_epilogue_fwd(y, z, bb, scaling), "epi_",
                    lambda: lora_epilogue_plain(y, z, bb, scaling),
                    lambda: torch.addmm(y, z, bb, alpha=scaling), 20)
        report("epi_fwd", f"M={m} N={n}", rec, 2 * m * r * n, (2 * m * n + m * r + r * n) * 2)
        rec = timed(lambda: lora_epilogue_dzdb(z, dy, bb, scaling), "epi_",
                    lambda: lora_epilogue_dzdb_plain(z, dy, bb, scaling),
                    lambda: (torch.mm(dy, bb.t()) * scaling, torch.mm(z.t(), dy) * scaling), 20)
        report("epi_dzdb", f"M={m} N={n}", rec, 4 * m * r * n, (m * n + 2 * m * r + 2 * r * n) * 2)
        del y, z, bb, dy


def eager_row_quant(x, w=None):
    """The row quant as the obvious eager torch sequence (library yardstick)."""
    v = x.float() if w is None else x.float() * w
    s = (v.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    return torch.round(v / s).clamp(-127, 127).to(torch.int8), s


def time_row_quant(gen, dev) -> dict[str, dict]:
    """Both entry points at (6144, 4096) and (6144, 14336) bf16; the JSON
    carries N = 4096, the input width of 6 of a layer's 7 projections."""
    out = {}
    for n in LORA_KS:
        x = torch.randn(LORA_M, n, generator=gen, device=dev, dtype=torch.bfloat16)
        w = torch.rand(n, generator=gen, device=dev) + 0.5
        cases = {
            "row_quant": (lambda: row_quant(x), lambda: row_quant_plain(x), lambda: eager_row_quant(x), 0),
            "row_quant_scaled": (lambda: row_quant_scaled(x, w), lambda: row_quant_plain(x, w),
                                 lambda: eager_row_quant(x, w), n * 4),
        }
        for name, (kernel_fn, plain_fn, library_fn, extra) in cases.items():
            rec = timed(kernel_fn, "row_quant_kernel", plain_fn, library_fn, 20)
            # x read once; q and s written once (w_scale read once).
            report(name, f"({LORA_M}, {n})", rec, 0.0, LORA_M * n * 3 + LORA_M * 4 + extra)
            if n == LORA_KS[0]:
                out[name] = rec
        del x, w
    # The passes alone at one tensor rank's widths (the row-parallel o and
    # down at tensor 2); the JSON carries K = 2048. Each pass reads x once;
    # the first writes a maximum a row, the second reads a scale a row and
    # writes q. The library: max|x| a row as one call; the eager codes.
    for k, _ in TENSOR_LORA:
        x = torch.randn(LORA_M, k, generator=gen, device=dev, dtype=torch.bfloat16)
        s = row_quant_plain(x)[1]
        cases = {
            "row_absmax": (lambda: row_absmax(x), lambda: row_absmax_plain(x),
                           lambda: torch.linalg.vector_norm(x, float("inf"), dim=-1), LORA_M * k * 2 + LORA_M * 4),
            "row_quant_given": (lambda: row_quant_given(x, s), lambda: row_quant_given_plain(x, s),
                                lambda: torch.round(x.float() / s).clamp(-127, 127).to(torch.int8),
                                LORA_M * k * 3 + LORA_M * 4),
        }
        for name, (kernel_fn, plain_fn, library_fn, nbytes) in cases.items():
            rec = timed(kernel_fn, "row_quant_kernel", plain_fn, library_fn, 20)
            report(name, f"({LORA_M}, {k})", rec, 0.0, nbytes)
            if k == TENSOR_LORA[0][0]:
                out[name] = rec
        del x, s
    return out


def time_epilogue(gen, dev) -> dict[str, dict]:
    """Forward, dz, dB and the fused dz + dB at M = 6144, r = 16, N = 1024,
    4096, 14336; the library is one PyTorch call each (``addmm`` with the
    scaling as alpha), and for the fused call the pair of them, timed only.
    Each prints its share of the byte bound and library / kernel, the
    forward its grid, each backward its grid's f32 partial bytes; the fused
    kernel is also timed against its cost probe (device time, printed
    only). The JSON carries N = 4096 (q, o and down); the fused kernel's
    library_ms is null there, as no single PyTorch call computes both
    outputs."""
    out = {}
    s, m, r = 32.0 / LORA_R, LORA_M, LORA_R
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in EPI_NS:
        y, z, b, dy = epilogue_inputs(n, gen, dev)
        dz_out = torch.empty(m, r, device=dev, dtype=torch.bfloat16)
        db_out = torch.empty(r, n, device=dev, dtype=torch.bfloat16)

        def addmm_dz():
            return torch.addmm(dz_out, dy, b.t(), beta=0, alpha=s)

        def addmm_db():
            return torch.addmm(db_out, z.t(), dy, beta=0, alpha=s)

        cases = {
            # y, z, B read once, out written once; mma.sync bf16.
            "epi_fwd": (lambda: lora_epilogue_fwd(y, z, b, s), lambda: lora_epilogue_plain(y, z, b, s),
                        lambda: torch.addmm(y, z, b, alpha=s), 2 * m * n * r,
                        (2 * m * n + m * r + r * n) * 2, PEAK_BF16_FLOPS),
            # dy and B (z) read once, dz (dB) written once; mma.sync bf16.
            "epi_dz": (lambda: lora_epilogue_dz(dy, b, s), lambda: lora_epilogue_dz_plain(dy, b, s),
                       addmm_dz, 2 * m * n * r, (m * n + r * n + m * r) * 2, PEAK_BF16_FLOPS),
            "epi_db": (lambda: lora_epilogue_db(z, dy, s), lambda: lora_epilogue_db_plain(z, dy, s),
                       addmm_db, 2 * m * n * r, (m * n + m * r + r * n) * 2, PEAK_BF16_FLOPS),
            # dy, z and B read once, dz and dB written once.
            "epi_dzdb": (lambda: lora_epilogue_dzdb(z, dy, b, s), lambda: lora_epilogue_dzdb_plain(z, dy, b, s),
                         lambda: (addmm_dz(), addmm_db()), 4 * m * n * r,
                         (m * n + 2 * (m * r + r * n)) * 2, PEAK_BF16_FLOPS),
        }
        for name, (kernel_fn, plain_fn, library_fn, flops, nbytes, peak) in cases.items():
            rec = timed(kernel_fn, "epi_", plain_fn, library_fn, 20)
            report(name, f"M={m} N={n} r={r}", rec, flops, nbytes, peak)
            if name == "epi_fwd":
                mb, nb = _fwd_grid(m, n, _padded_rank(r), sms)
                grid = f"grid mb x nb = {mb} x {nb}"
            else:
                part = partial_bytes(m, n, r, dz=name != "epi_db", db=name != "epi_dz", sms=sms)
                grid = f"{part / 1e6:.2f} MB of f32 partials"
            print(f"    {name}: {grid}; "
                  + ("library = both addmm calls; " if name == "epi_dzdb" else "")
                  + f"{rec['bound_ms'] / rec['ms']:.1%} of the byte bound, "
                  + f"library / kernel {rec['library_ms'] / rec['ms']:.2f}")
            if n == 4096:
                out[name] = dict(rec, library_ms=None) if name == "epi_dzdb" else rec
        times = {}
        for _ in range(2):
            for label, kernel in (("as built", EPI_DZDB), ("no_fold", EPI_NO_FOLD)):
                times.setdefault(label, []).append(device_ms(
                    lambda kernel=kernel: lora_epilogue_dzdb(z, dy, b, s, kernel=kernel), 20, "epi_dzdb")[0])
        base = min(times["as built"])
        print(f"  epi_dzdb N={n}, cost probe (device time): as built {base:.4f} ms, without the fold "
              f"{min(times['no_fold']):.4f} ms ({min(times['no_fold']) - base:+.4f})")
        del y, z, b, dy, dz_out, db_out
    return out


def per_stream_ms(fn, iters: int, kernel: str) -> list[float]:
    """Mean device time per launch of the kernels named ``kernel``, by the
    stream they ran on (``torch.profiler`` kernel events), sorted; empty
    when the tracer recorded none."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_stream: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name:
            by_stream.setdefault(e.device_resource_id, []).append(e.time_range.elapsed_us())
    return sorted(sum(x) / len(x) / 1e3 for x in by_stream.values())


def time_ring(gen, dev) -> dict[str, dict]:
    """The fused ring on RING_RANKS ranks of the card at the training shape
    (B 3, S 2048; the JSON's) and the serving one (B 5). ``ms`` is one pass:
    CUDA events on the caller's stream around ``ring_fwd``, from before the
    first send to after the last rank's output, the sends and the ranks'
    concurrent kernels included. Beside it each rank's kernel (by stream;
    rank i folds i + 1 chunks), the plain version, the library (SDPA causal
    with the padding mask over the whole (B, S) on the card: the same
    output) and the per-step flash ring's forward (timed only). The bound is
    the causal work's (tiles above each diagonal chunk's diagonal skipped),
    against q, k, v, bias read and out, lse written once; the sends' bytes
    are printed beside it."""
    out = {}
    s = REFERENCE_GEOMETRY.feature_len
    s_loc = s // RING_RANKS
    ring = SequenceRing([dev] * RING_RANKS)
    for b in (LORA_BATCH, BATCH):
        q, k, v, kv_mask = attention_inputs(b, s, gen, dev)
        q4, k4, v4 = (t.view(b, s, -1, D).transpose(1, 2) for t in (q, k, v))
        keep = (torch.ones(s, s, dtype=torch.bool, device=dev).tril()[None, None]
                & (kv_mask > 0)[:, None, None, :])

        def fused():
            return ring_fwd(q, k, v, HQ, HKV, ring, kv_mask=kv_mask)

        rec = {"ms": cuda_ms(fused, 20),
               "plain_ms": device_ms(lambda: ring_fwd_plain(q, k, v, HQ, HKV, ring, kv_mask=kv_mask),
                                     2, warmup=1)[1],
               "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                   q4, k4, v4, attn_mask=keep, enable_gqa=True), 10)[1]}
        # Few traced passes: each holds ~20 host API events per pass, and the
        # host's RSS peaks in this phase.
        kernels_ms, pass_device_ms = device_ms(fused, 5, "ring_fwd_kernel")
        causal_ms = device_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                                     enable_gqa=True), 10)[1]
        ranks_ms = per_stream_ms(fused, 5, "ring_fwd_kernel")
        per_step_ms = cuda_ms(lambda: ring_flash_fwd(q, k, v, HQ, HKV, ring, kv_mask=kv_mask), 10)
        flops = 4 * b * HQ * D * s * (s + 1) // 2
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + (b * HQ * s + b * s) * 4
        rec.update(bound(flops, nbytes))
        sent = 2 * sends_per_pass(RING_RANKS) * b * s_loc * HKV * D * 2
        print(f"  ring_fwd n={RING_RANKS} B={b} S={s}: pass {rec['ms']:.4f} ms (CUDA events), kernels "
              f"{kernels_ms:.4f} ms summed over ranks, each rank "
              f"{[round(x, 4) for x in ranks_ms] or 'not measured'} ms (by stream, sorted); "
              f"everything it launches {pass_device_ms:.4f} ms device time; plain {rec['plain_ms']:.4f} ms, "
              f"SDPA {rec['library_ms']:.4f} ms (is_causal, no padding mask: {causal_ms:.4f}), per-step "
              f"flash ring {per_step_ms:.4f} ms; "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB -> bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}), {flops / rec['ms'] / 1e9:.1f} TFLOP/s achieved; sends "
              f"{sent / 1e6:.1f} MB read and written ({2 * sent / PEAK_BYTES_PER_S * 1e3:.4f} ms at the "
              f"HBM rate)")
        if b == LORA_BATCH:
            out["ring_fwd"] = rec
        del q, k, v, q4, k4, v4, keep
    issue = ring_issue(str(ROOT))
    print(f"  ring_fwd n={RING_RANKS} B={LORA_BATCH} S={s}: the host takes {issue['host_ms']:.4f} ms to issue "
          f"a pass ({issue['host_ms'] - issue['c_ms']:.4f} in Python, {issue['c_ms']:.4f} in the C launcher; "
          f"{RING_ISSUE_PASSES} passes after {RING_ISSUE_WARMUP}, in a process of its own), "
          f"{issue['sends']:g} sends a pass (want {sends_per_pass(RING_RANKS)})")
    if issue["sends"] != sends_per_pass(RING_RANKS):
        raise AssertionError(f"the timed ring passes made {issue['sends']:g} sends a pass, "
                             f"want {sends_per_pass(RING_RANKS)}")
    return out


def clip_flops(cfg: CLIPVisionConfig) -> float:
    """Multiply-adds x 2 of the tower on one frame: the patch conv, and each
    layer's four projections, MLP and the two attention products."""
    s, e, p = cfg.num_patches + 1, cfg.hidden_size, cfg.patch_size
    layer = 2 * s * (4 * e * e + 2 * e * cfg.intermediate_size) + 4 * s * s * e
    return 2 * cfg.num_patches * 3 * p * p * e + cfg.effective_layers * layer


def stc_flops(cfg: STCConfig, t: int, grid: int) -> float:
    """Multiply-adds x 2 of the connector on one clip of t frames of
    grid x grid features: each bottleneck's 1x1 convs (and shortcut), its
    depthwise 3x3 and squeeze-excite, the sampler and the readout."""
    def block(images, side, cin, cout):
        rd = max(1, int(round(cin * cfg.se_ratio)))
        px = images * side * side
        convs = cin * cout + cout * cout + (cin * cout if cin != cout else 0) + 9 * cout
        return 2 * px * convs + 2 * images * 2 * cout * rd

    c = cfg.hidden_size
    td, gd = t // 2 + 1, grid // 2 + 1
    s1 = block(t, grid, cfg.encoder_hidden_size, c) + (cfg.depth - 1) * block(t, grid, c, c)
    s2 = cfg.depth * block(td, gd, c, c)
    px2 = td * gd * gd
    readout = 2 * px2 * (c * cfg.output_hidden_size + (cfg.mlp_depth - 1) * cfg.output_hidden_size ** 2)
    return s1 + 2 * px2 * 8 * c * c + s2 + readout


def time_vision(towers, gen, dev) -> None:
    """The phase-4 model's towers at the serving batch (5 clips of 12
    frames): the CLIP tower per frame and the STC connector per clip by CUDA
    events, beside their operations bound at the bf16 peak; SDPA at the
    tower's (60, 16, 577, 64); the 4096-channel depthwise 3x3 of s1 and the
    sampler's Conv3d, each beside its bound. Printed, not in the JSON line
    (the vision path has no kernel of its own)."""
    tower, connector = towers
    ccfg, scfg = tower.cfg, connector.cfg
    g, frames = REFERENCE_GEOMETRY, BATCH * REFERENCE_GEOMETRY.num_frames
    x = torch.randn(frames, 3, g.image_size, g.image_size, generator=gen, device=dev)
    with torch.inference_mode():
        clip_ms = cuda_ms(lambda: tower(x), 5)
        feats = tower(x).reshape(BATCH, g.num_frames, ccfg.grid, ccfg.grid, ccfg.hidden_size)
        stc_ms = cuda_ms(lambda: connector(feats), 5)
        h = torch.randn(frames, ccfg.grid, ccfg.grid, scfg.hidden_size, generator=gen, device=dev,
                        dtype=scfg.dtype)
        dw = connector.s1.b2.conv2
        dw_ms = cuda_ms(lambda: dw(h.permute(0, 3, 1, 2)), 10)
        h3 = h.reshape(BATCH, g.num_frames, ccfg.grid, ccfg.grid, scfg.hidden_size)
        conv3d = connector.sampler_conv
        conv3d_ms = cuda_ms(lambda: conv3d(h3.permute(0, 4, 1, 2, 3)), 10)
        heads, s = ccfg.num_attention_heads, ccfg.num_patches + 1
        q, k, v = (torch.randn(frames, heads, s, ccfg.hidden_size // heads, generator=gen, device=dev,
                               dtype=ccfg.dtype) for _ in range(3))
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10)
    c, px = scfg.hidden_size, frames * ccfg.grid * ccfg.grid
    td, gd = g.num_frames // 2 + 1, ccfg.grid // 2 + 1
    cases = (
        ("CLIP tower per frame", clip_ms / frames, clip_flops(ccfg), 0.0),
        ("STC connector per clip", stc_ms / BATCH, stc_flops(scfg, g.num_frames, ccfg.grid), 0.0),
        (f"depthwise 3x3 ({frames}, {c}, {ccfg.grid}, {ccfg.grid}) channels-last", dw_ms,
         2 * px * c * 9, 2 * h.numel() * 2 + c * 9 * 2),
        (f"Conv3d k 2 s 2 p 1 ({BATCH}, {c}, {g.num_frames}, {ccfg.grid}, {ccfg.grid})", conv3d_ms,
         2 * BATCH * td * gd * gd * 8 * c * c, (h3.numel() + BATCH * td * gd * gd * c + 8 * c * c) * 2),
        (f"SDPA ({frames}, {heads}, {s}, {ccfg.hidden_size // heads}) bf16", sdpa_ms,
         4 * frames * heads * s * s * (ccfg.hidden_size // heads), 4 * q.numel() * 2),
    )
    for label, ms, flops, nbytes in cases:
        rec = bound(flops, nbytes)
        print(f"  {label}: {ms:.4f} ms (CUDA events); {flops / 1e9:.2f} GFLOP -> bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}, {rec['bound_ms'] / ms:.1%} of it), {flops / ms / 1e9:.1f} TFLOP/s")
    del x, feats, h, h3, q, k, v


def time_int_mm(gen, dev) -> None:
    """``torch._int_mm`` at 6144 x 4096 -> 14336 and its dx (6144 x 14336
    -> 4096), each with the weight stored (out, in) and (in, out), beside
    bf16 ``F.linear`` on the same shapes: what decides the int8 base's
    worth and the layout it is stored in. Printed, not in the JSON line."""
    m, k, n = LORA_M, LORA_KS[0], LORA_KS[1]
    x8 = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    g8 = torch.randint(-127, 128, (m, n), generator=gen, device=dev, dtype=torch.int8)
    w_oi = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
    w_io = w_oi.t().contiguous()
    xb, gb = x8.to(torch.bfloat16), g8.to(torch.bfloat16)
    wb = w_oi.to(torch.bfloat16)
    cases = {
        "forward, weight (out, in)": (lambda: torch._int_mm(x8, w_oi.t()), 2 * m * k * n),
        "forward, weight (in, out)": (lambda: torch._int_mm(x8, w_io), 2 * m * k * n),
        "dx, weight (out, in)": (lambda: torch._int_mm(g8, w_oi), 2 * m * k * n),
        "dx, weight (in, out)": (lambda: torch._int_mm(g8, w_io.t()), 2 * m * k * n),
        "dx, weight (out, in) transposed per call": (lambda: torch._int_mm(g8, w_oi.t().contiguous().t()),
                                                     2 * m * k * n),
        "bf16 F.linear forward": (lambda: F.linear(xb, wb), 2 * m * k * n),
        "bf16 dx (dy @ W)": (lambda: gb @ wb, 2 * m * k * n),
    }
    for label, (fn, flops) in cases.items():
        ms = cuda_ms(fn, 20)
        print(f"  {label}: {ms:.4f} ms ({flops / ms / 1e9:.1f} TOP/s)")
    del x8, g8, w_oi, w_io, xb, gb, wb


# ---------------------------------------------------------------------------
# Phase 9t: the trainer users run (vlb-train through the port), in a process
# of its own (``--trainer DIR``), so its host memory stands apart from the
# phases before it; it holds the same RSS bound and prints its peak.

CONFIGS = ROOT / "configs"
# The phase's overrides of the LoRA config of record; nothing else changes.
LORA_TRAIN_OVERRIDES = ("trainer.max_epochs=2", "trainer.val_check_interval=0.5",
                        "trainer.log_every_n_steps=2")
TRAIN_BATCHES, VAL_BATCHES = 4, 2          # LoRA run: 8 steps, 4 validations
BASELINE_TRAIN_BATCHES = 3
NAN_STEPS = (2, 3, 4)                      # 0-based: steps 3-5 have NaN targets


def compose(experiment: str, out: Path, *overrides: str):
    return load_config(CONFIGS, "base", [f"experiment={experiment}", "subject=sub-01", *overrides,
                                         f"output_dir={out}"])


def frame_loaders(config, n_train: int, n_val: int, gen, dev) -> tuple[list, list]:
    """Train and val batches of the config's batch size from frames made on
    the card from seed 0, as dicts of device tensors."""
    cfg = build_model_config(config.model)
    batches = synthetic_batches(cfg, n_train + n_val, int(config.datamodule.batch_size),
                                np.random.default_rng(SEED), gen, dev, frames=True)
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in b.items()} for b in batches]
    return batches[:n_train], batches[n_train:]


def timed_calls(obj, name: str) -> list:
    """Wrap ``obj.name`` so each call's host time, the card waited for
    before and after, is appended (ms) to the returned list."""
    fn, times = getattr(obj, name), []

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(obj, name, wrapper)
    return times


def expected_fit_launches(layers: int, steps: int, val_batches: int, lora: bool) -> dict[str, int]:
    """A fit's launches: a LoRA step of the config of record (r 16, the
    32-bit unfused dropout, bf16, remat 'nothing') what
    ``expected_train_launches`` gives with ``keep`` (the flash forward and
    the keep and LoRA forward kernels twice a layer, the forward and its
    replay; one flash backward; dx and dA); a baseline step one forward;
    a validation batch one forward (no dropout, so no LoRA kernel)."""
    if lora:
        want = expected_train_launches(layers, steps, keep=True)
    else:
        want = dict.fromkeys(KERNELS, 0)
        want["flash_fwd"] = layers * steps
    want["flash_fwd"] += layers * val_batches
    return want


def read_csv(path: Path) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def check_lora_run(trainer, out: Path, num_target: int) -> None:
    rows = read_csv(trainer.csv_logger.path)
    train_rows = [r for r in rows if r.get("train/brain_loss")]
    val_rows = [r for r in rows if r.get("val/brain_loss")]
    roi = [c for c in rows[0] if c.startswith("val_corr_ROI_")]
    print(f"  metrics.csv: {len(rows)} rows, train rows at steps {[int(r['step']) for r in train_rows]}, "
          f"val rows at steps {[int(r['step']) for r in val_rows]}, {len(roi)} ROI columns, "
          f"val/brain_loss {[round(float(r['val/brain_loss']), 5) for r in val_rows]}, "
          f"val_corr_avg {[round(float(r['val_corr_avg']), 5) for r in val_rows]}")
    if [int(r["step"]) for r in train_rows] != [2, 4, 6, 8] or len(val_rows) != 4 or len(roi) != num_target:
        raise AssertionError("metrics.csv lacks the train rows at steps 2/4/6/8, the 4 val rows or their ROIs")
    if not all(r[c] != "" for r in val_rows for c in roi) or not all(
            np.isfinite(float(r["val_corr_avg"])) for r in val_rows):
        raise AssertionError("a val row has an empty ROI cell or a non-finite val_corr_avg")
    for r in train_rows:
        if float(r["lr-AdamW"]) != learning_rate(trainer.optimizer.config, int(r["step"])):
            raise AssertionError(f"lr-AdamW at step {r['step']} is not learning_rate(cfg, step)")
    losses = [float(r["val/brain_loss"]) for r in val_rows]
    best = val_rows[losses.index(min(losses))]
    (best_dir,) = out.glob("best_brainloss_*")
    want = f"best_brainloss_{best['epoch']}-{best['step']}"
    print(f"  {best_dir.name} (minimum val/brain_loss {min(losses):.6f}), last: "
          f"{(out / 'last' / STATE_FILE).stat().st_size / 1e6:.1f} MB")
    if best_dir.name != want or not (out / "last" / STATE_FILE).exists():
        raise AssertionError(f"best checkpoint {best_dir.name}, want {want}; or no last")
    adapters = torch.load(out / "adapters" / ADAPTERS_FILE, map_location="cpu", weights_only=True)
    if set(adapters) != set(trainer.trainable) or not all(is_adapter(k) for k in adapters):
        raise AssertionError("the adapters export holds other tensors than the head and lora_*")
    print(f"  adapters: {len(adapters)} tensors (head + lora_a/lora_b), "
          f"{sum(t.numel() for t in adapters.values()) / 1e6:.3f} M values")


def snapshot(trainer) -> tuple[dict, dict]:
    """Copies of the trainable tensors and of the AdamW state."""
    params = {k: p.detach().clone() for k, p in trainer.trainable.items()}
    opt = trainer.optimizer.state_dict()
    state = {i: {k: v.clone() for k, v in s.items()} for i, s in opt["adamw"]["state"].items()}
    return params, {"step": opt["step"], "state": state}


def same_state(trainer, params: dict, opt: dict) -> bool:
    now_params, now_opt = snapshot(trainer)
    return (now_params.keys() == params.keys() and all(torch.equal(now_params[k], params[k]) for k in params)
            and now_opt["step"] == opt["step"] and now_opt["state"].keys() == opt["state"].keys()
            and all(torch.equal(now_opt["state"][i][k], opt["state"][i][k])
                    for i in opt["state"] for k in opt["state"][i]))


def fit_and_count(trainer, train: list, val: list) -> tuple[dict, list, list, list]:
    """``trainer.fit`` with the launch counts set to 0 just before and read
    just after, and each step's, validation's and save's host ms."""
    step_ms = timed_calls(trainer, "train_one")
    val_ms = timed_calls(trainer, "validate")
    save_ms = timed_calls(trainer.ckpt, "save")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    trainer.fit(train, val)
    torch.cuda.synchronize()
    return read_launches(), step_ms, val_ms, save_ms


def report_fit(label: str, trainer, launches: dict, step_ms: list, val_ms: list, save_ms: list,
               want: dict) -> None:
    ckpt = trainer.ckpt
    print(f"  {label}: step ms {[round(x, 3) for x in step_ms]}, validation ms (with its best save) "
          f"{[round(x, 3) for x in val_ms]}, checkpoint saves ms {[round(x, 3) for x in save_ms]} "
          f"({ckpt.bytes_written / 1e6:.1f} MB in {len(save_ms)} saves, "
          f"{ckpt.bytes_written / max(len(save_ms), 1) / 1e6:.1f} MB each), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    if launches != want:
        raise AssertionError(f"{label}: launched {launches}, want {want}")


def trainer_lora_and_resume(out: Path, gen, dev) -> dict:
    """The LoRA config of record from frames, 2 epochs of 4 batches with a
    validation every 2 (8 steps, 4 validations); then a fresh trainer with
    max_epochs 3 resumed from last (bit-equal tensors and AdamW state),
    which runs epoch 3 alone."""
    config = compose("vlb_friends_lora", out, *LORA_TRAIN_OVERRIDES)
    train, val = frame_loaders(config, TRAIN_BATCHES, VAL_BATCHES, gen, dev)
    t0 = time.perf_counter()
    trainer, train, val = build_trainer(config, device=dev, loaders=(train, val))
    torch.cuda.synchronize()
    model_cfg = trainer.model.cfg
    layers = model_cfg.mistral.num_hidden_layers
    lora = model_cfg.mistral.lora
    print(f"  built in {time.perf_counter() - t0:.2f} s: {layers} layers, LoRA r {lora.rank} alpha "
          f"{lora.alpha} dropout {lora.dropout} ({lora.dropout_bits}-bit, fused {lora.fused_dropout}), "
          f"remat {model_cfg.mistral.remat}, batch {config.datamodule.batch_size}, "
          f"{sum(p.numel() for p in trainer.trainable.values()) / 1e6:.3f} M trainable")
    launches, step_ms, val_ms, save_ms = fit_and_count(trainer, train, val)
    report_fit("LoRA fit", trainer, launches, step_ms, val_ms, save_ms,
               expected_fit_launches(layers, TRAIN_BATCHES * 2, VAL_BATCHES * 4, lora=True))
    if trainer.global_step != 8:
        raise AssertionError(f"the LoRA fit ended at step {trainer.global_step}, want 8")
    check_lora_run(trainer, out, model_cfg.num_target)
    record = {"lora_step_ms": step_ms, "lora_val_ms": val_ms, "lora_save_ms": save_ms,
              "lora_save_bytes": trainer.ckpt.bytes_written / max(len(save_ms), 1),
              "lora_peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
              "lora_launches": launches}
    params, opt = snapshot(trainer)
    del trainer
    torch.cuda.empty_cache()

    config3 = compose("vlb_friends_lora", out, *LORA_TRAIN_OVERRIDES, "trainer.max_epochs=3")
    trainer, train, val = build_trainer(config3, device=dev, loaders=(train, val))
    if not trainer.maybe_resume() or trainer.global_step != 8:
        raise AssertionError(f"the resumed trainer is at step {trainer.global_step}, want 8")
    last = torch.load(out / "last" / STATE_FILE, map_location=dev, weights_only=True)
    bit_equal = same_state(trainer, params, opt) and all(
        torch.equal(trainer.trainable[k], t) for k, t in last["params"].items())
    print(f"  resumed at step {trainer.global_step}: trainable tensors and AdamW state bit-equal to "
          f"last: {bit_equal}")
    if not bit_equal:
        raise AssertionError("the resumed state differs from last")
    del last, params, opt
    launches, step_ms, val_ms, save_ms = fit_and_count(trainer, train, val)
    report_fit("resumed fit (epoch 3)", trainer, launches, step_ms, val_ms, save_ms,
               expected_fit_launches(layers, TRAIN_BATCHES, VAL_BATCHES * 2, lora=True))
    if trainer.global_step != 12:
        raise AssertionError(f"the resumed fit ended at step {trainer.global_step}, want 12")
    record["resume_launches"] = launches
    del trainer, train, val
    torch.cuda.empty_cache()
    return record


def trainer_baseline(out: Path, gen, dev) -> dict:
    """The frozen-baseline config of record from frames: batch 5, 1 epoch of
    3 batches (validations every batch, as 0.2 of 3 rounds to 1)."""
    config = compose("vlb_friends_baseline", out, "trainer.max_epochs=1")
    train, val = frame_loaders(config, BASELINE_TRAIN_BATCHES, 1, gen, dev)
    trainer, train, val = build_trainer(config, device=dev, loaders=(train, val))
    layers = trainer.model.cfg.mistral.num_hidden_layers
    launches, step_ms, val_ms, save_ms = fit_and_count(trainer, train, val)
    report_fit("baseline fit", trainer, launches, step_ms, val_ms, save_ms,
               expected_fit_launches(layers, BASELINE_TRAIN_BATCHES, BASELINE_TRAIN_BATCHES, lora=False))
    saved = torch.load(out / "last" / STATE_FILE, map_location="cpu", weights_only=True)["params"]
    adapters = torch.load(out / "adapters" / ADAPTERS_FILE, map_location="cpu", weights_only=True)
    print(f"  last holds {sorted(saved)}; adapters {sorted(adapters)}")
    if not (saved and adapters and all(k.startswith("head.") for k in [*saved, *adapters])):
        raise AssertionError("the baseline's checkpoint or adapters hold more than the head")
    record = {"baseline_step_ms": step_ms, "baseline_val_ms": val_ms, "baseline_save_ms": save_ms,
              "baseline_launches": launches}
    del trainer, train, val
    torch.cuda.empty_cache()
    return record


def trainer_nan_abort(out: Path, gen, dev) -> None:
    """A narrow LoRA model whose targets are NaN at steps 3-5: the trainer
    raises at step 5 (the streak reaches 3 there, logging every step) with
    the tensors and AdamW state of step 2."""
    cfg = VLBConfig.full(use_lora=True, mistral=narrow_mistral(torch.bfloat16, LoRAConfig()),
                         **narrow_towers(torch.bfloat16))
    model = VideoLLaMA2VLB.from_state_dict(cfg, init_params(cfg, dev, gen))
    batches = synthetic_batches(cfg, 6, 2, np.random.default_rng(SEED), gen, dev)
    for i in NAN_STEPS:
        batches[i]["timeseries"] = np.full_like(batches[i]["timeseries"], np.nan)
    loop = TrainLoopConfig(max_epochs=1, val_check_interval=0.0, log_every_n_steps=1, checkpoint=False,
                           num_target=cfg.num_target)
    trainer = VLBTrainer(model, OptimConfig(), loop, device=dev, csv_logger=CSVMetricsLogger(out, "nan"))
    after_two = []

    class AfterStepTwo:
        def log_metrics(self, metrics, step, epoch):
            if step == 2:
                after_two.append(snapshot(trainer))

    trainer.extra_loggers.append(AfterStepTwo())
    try:
        trainer.fit(batches, batches[:1])
    except FloatingPointError as e:
        message = str(e)
    else:
        raise AssertionError("the NaN streak did not abort the fit")
    unchanged = same_state(trainer, *after_two[0])
    print(f"  NaN abort: {message.split(';')[0]}; {trainer.optimizer.step} updates applied; state as "
          f"after step 2: {unchanged}")
    if trainer.global_step != 5 or trainer.optimizer.step != 2 or not unchanged:
        raise AssertionError("the NaN abort came at the wrong step or the state moved")


def trainer_safetensors(out: Path, gen, dev) -> None:
    """Narrow weights (decoder, towers, connector) written under their HF
    keys in two shards by ``write_safetensors``, loaded through
    ``load_pretrained_params`` into other random weights: every tensor the
    checkpoint holds is taken, the head keeps its own, and the predictions
    are bit-equal to those of the same tensors through ``from_state_dict``."""
    cfg = VLBConfig.full(mistral=narrow_mistral(torch.bfloat16), **narrow_towers(torch.bfloat16))
    written = init_params(cfg, dev, gen)
    hf = {hf_key(k): t for k, t in written.items() if hf_key(k) is not None}
    ckpt = out / "hf"
    ckpt.mkdir(parents=True)
    vision = {k: t for k, t in hf.items() if not k.startswith("model.layers.")}
    write_safetensors(ckpt / "model-00001-of-00002.safetensors",
                      {k: t for k, t in hf.items() if k not in vision})
    write_safetensors(ckpt / "model-00002-of-00002.safetensors", vision)
    params = init_params(cfg, dev, torch.Generator(device=dev).manual_seed(SEED + 1))
    loaded = load_pretrained_params(cfg, ckpt, params)
    reference = {k: written[k] if hf_key(k) is not None else params[k] for k in params}
    taken = all(torch.equal(loaded[k], reference[k]) for k in reference)
    batch = synthetic_batches(cfg, 1, 1, np.random.default_rng(SEED), gen, dev, frames=True)
    got = predict_batches(VideoLLaMA2VLB.from_state_dict(cfg, loaded), batch, dev)["predicted"]
    want = predict_batches(VideoLLaMA2VLB.from_state_dict(cfg, reference), batch, dev)["predicted"]
    size = sum(p.stat().st_size for p in ckpt.iterdir())
    print(f"  HF safetensors: {len(hf)} tensors in 2 shards ({size / 1e6:.1f} MB, bf16), every one taken: "
          f"{taken}; predictions from frames bit-equal: {np.array_equal(got, want)}")
    if not (taken and np.array_equal(got, want)):
        raise AssertionError("weights loaded from HF safetensors differ from the ones written")


def trainer_child(out: str) -> int:
    """``--trainer DIR``: phase 9t in this process, under DIR; prints one
    JSON line of its numbers last."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(out)
    record = {}
    with phase("9t LoRA trainer (vlb_friends_lora) from frames at full width, then resume"):
        record.update(trainer_lora_and_resume(root / "lora", gen, dev))
    with phase("9t baseline trainer (vlb_friends_baseline) from frames at full width"):
        record.update(trainer_baseline(root / "baseline", gen, dev))
    with phase("9t narrow NaN abort and HF safetensors"):
        trainer_nan_abort(root / "nan", gen, dev)
        trainer_safetensors(root, gen, dev)
    record["peak_rss_gb"] = peak_rss_gb()
    print(json.dumps(record))
    if record["peak_rss_gb"] > HOST_RSS_LIMIT_GB:
        raise AssertionError(f"the trainer phase's peak host RSS {record['peak_rss_gb']:.2f} GB is over "
                             f"{HOST_RSS_LIMIT_GB}")
    return 0


# ---------------------------------------------------------------------------
# Phase 9p: the stages after the trainer (vlb-predict, the feature and token
# caches, vlb-brainmaps), in a process of its own (``--after-train DIR``) on
# phase 9t's DIR. Stores are in memory (the card's machine has no h5py);
# where h5py imports, the files are written and read as well.

CACHE_TRAIN_BATCHES, CACHE_EPOCHS = 3, 2  # baseline at batch 5: 3 train + 1 val batch
TOKEN_STEPS = 2                           # LoRA at batch 3 from cached tokens and from frames
ATLAS_SHAPE = (20, 20, 10)                # 4000 voxels for 1000 labels and background


def h5py_present() -> bool:
    import importlib.util

    return importlib.util.find_spec("h5py") is not None


def metrics_rows(root: Path, version: int) -> list[dict]:
    (path,) = root.glob(f"*/version_{version}/metrics.csv")
    return read_csv(path)


def after_train_predict(root: Path, dev, files: bool) -> dict:
    """(a) ``vlb-predict-torch experiment=vlb_friends_lora subject=sub-01
    predict.checkpoint=<9t's last>`` over the 2 val batches 9t validated on
    (the frames remade from seed 0): per-ROI r against 9t's val row at the
    step ``last`` holds (its resumed run's CSV, version_1), 32 flash
    forwards a batch and no other kernel."""
    last = root / "lora" / "last"
    config = compose("vlb_friends_lora", root / "predict", f"predict.checkpoint={last}", f"predict.out={root / 'predictions.h5'}")
    train, val = frame_loaders(config, TRAIN_BATCHES, VAL_BATCHES, torch.Generator(device=dev).manual_seed(SEED),
                               dev)
    step = torch.load(last / STATE_FILE, map_location="cpu", weights_only=True)["step"]
    (row,) = [r for r in metrics_rows(root / "lora", 1) if r.get("val/brain_loss") and int(r["step"]) == step]
    torch.cuda.synchronize()
    reset_launches()
    res = predict_split(config, dev, loaders=(train, val))
    launches = read_launches()
    layers = build_model_config(config.model).mistral.num_hidden_layers
    want = {n: layers * VAL_BATCHES if n == "flash_fwd" else 0 for n in KERNELS}
    num_target = res["val_corr_roi"].shape[0]
    check_predictions(res, VAL_BATCHES * LORA_BATCH, num_target)
    csv_r = np.array([float(row[f"val_corr_ROI_{i:06d}"]) for i in range(num_target)])
    err = float(np.abs(res["val_corr_roi"] - csv_r).max())
    print(f"  predict from last (step {step}): {res['predicted'].shape[0]} rows, batch ms "
          f"{[round(float(x), 3) for x in res['batch_ms']]}, corr avg {float(np.nanmean(res['val_corr_roi'])):.6f} "
          f"against 9t's val row at step {step} {float(row['val_corr_avg']):.6f}, max|r - CSV r| {err:.3e} "
          f"(tol {PREDICT_CORR_TOL}), launches { {k: v for k, v in launches.items() if v} }")
    if launches != want:
        raise AssertionError(f"predict launched {launches}, want {want}")
    if err > PREDICT_CORR_TOL:
        raise AssertionError("the predict sweep's per-ROI r differs from 9t's validation at the same step")
    if files:
        write_predictions(res, root / "predictions.h5")
        import h5py

        with h5py.File(root / "predictions.h5", "r") as f:
            shapes = {k: f[k].shape for k in f}
            same = all(np.array_equal(f[k][...], res[k]) for k in f)
        print(f"  wrote and read {root / 'predictions.h5'}: {shapes}, equal to the sweep's: {same}")
        if not same or sorted(shapes) != ["actual", "predicted", "val_corr_roi"]:
            raise AssertionError("the predictions file does not hold the sweep's arrays")
    return {"predict_batch_ms": res["batch_ms"].tolist(), "predict_launches": launches,
            "predict_corr_err": err}


def cache_sample(source, i: int) -> tuple[np.ndarray, np.ndarray]:
    """Sample ``i``'s (features, weights) of a feature cache (store or file)."""
    if isinstance(source, Path):
        import h5py

        with h5py.File(source, "r") as f:
            return f[f"{i}/{i}_features"][...], f[f"{i}/{i}_weights"][...]
    return source[f"{i}"][f"{i}_features"], source[f"{i}"][f"{i}_weights"]


def after_train_feature_cache(root: Path, dev, files: bool) -> dict:
    """(b) ``vlb_friends_baseline model.cache_features=true`` at batch 5
    over 3 train and 1 val batches from frames: 32 flash forwards a batch
    in the build and none while the head trains; 1247 x 4096 f16 values a
    sample; one batch's cached-head predictions against the full forward;
    the head trained 2 epochs with its validations over the cache."""
    config = compose("vlb_friends_baseline", root / "cached", "model.cache_features=true",
                     f"trainer.max_epochs={CACHE_EPOCHS}")
    batch = int(config.datamodule.batch_size)
    train, val = frame_loaders(config, CACHE_TRAIN_BATCHES, 1, torch.Generator(device=dev).manual_seed(SEED), dev)
    stores = None if files else {"train": MemoryStore(), "val": MemoryStore()}
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    trainer, cached_train, cached_val = build_cached_trainer(config, dev, loaders=(train, val), caches=stores)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = read_launches()
    model_cfg = build_model_config(config.model)
    layers, geom = model_cfg.mistral.num_hidden_layers, model_cfg.geometry
    want = {n: layers * (CACHE_TRAIN_BATCHES + 1) if n == "flash_fwd" else 0 for n in KERNELS}
    k = geom.num_vis_tokens + geom.onsets_width
    shapes = set()
    for source, n in ((cached_train.source, cached_train.length), (cached_val.source, cached_val.length)):
        for i in range(n):
            feats, weights = cache_sample(source, i)
            shapes.add((feats.shape, str(feats.dtype), weights.shape))
    sample_bytes = k * model_cfg.mistral.hidden_size * 2
    print(f"  cache built in {build_s:.2f} s (the model, then 4 backbone batches): {cached_train.length} train + "
          f"{cached_val.length} val samples in {'files' if files else 'memory stores'}, each {shapes}: "
          f"{sample_bytes / 1e6:.2f} MB a sample, {sample_bytes * (cached_train.length + cached_val.length) / 1e6:.1f} "
          f"MB in all; launches {build_launches}")
    if build_launches != want:
        raise AssertionError(f"the cache build launched {build_launches}, want {want}")
    if (cached_train.length, cached_val.length) != (CACHE_TRAIN_BATCHES * batch, batch) or shapes != {
            ((k, model_cfg.mistral.hidden_size), "float16", (k,))}:
        raise AssertionError(f"the caches hold {shapes}, want ({k}, {model_cfg.mistral.hidden_size}) f16 a sample")

    model = build_model(config.model, int(config.random_state), dev)
    full = predict_batches(model, val, dev)["predicted"]
    del model
    torch.cuda.empty_cache()
    head = trainer.model.eval()
    cb = next(iter(cached_val))
    with torch.no_grad():
        cached, _ = head_forward(head, {k_: torch.as_tensor(v).to(dev) for k_, v in cb.items()})
    cached = cached.cpu().numpy()
    err = float(np.abs(cached - full).max() / np.abs(full).max())
    print(f"  cached head against the full forward on the val batch: max|err| / max|ref| {err:.3e} "
          f"(tol {CACHED_HEAD_TOL})")
    if not err <= CACHED_HEAD_TOL:
        raise AssertionError("the head over the cache differs from the full forward")

    step_ms = timed_calls(trainer, "train_one")
    val_ms = timed_calls(trainer, "validate")
    torch.cuda.synchronize()
    reset_launches()
    trainer.fit(cached_train, cached_val)
    launches = read_launches()
    rows = read_csv(trainer.csv_logger.path)
    n_val = sum(1 for r in rows if r.get("val/brain_loss"))
    saved = torch.load(root / "cached" / "last" / STATE_FILE, map_location="cpu", weights_only=True)["params"]
    print(f"  head trained {CACHE_EPOCHS} epochs over the cache: step ms {[round(x, 3) for x in step_ms]}, "
          f"validation ms {[round(x, 3) for x in val_ms]}, {n_val} val rows, last holds {sorted(saved)}, "
          f"launches { {k_: v for k_, v in launches.items() if v} }")
    if any(launches.values()) or trainer.global_step != CACHE_EPOCHS * CACHE_TRAIN_BATCHES or not n_val:
        raise AssertionError("the head's training over the cache launched a kernel or ran other steps")
    if not saved or not all(k_.startswith("head.") for k_ in saved):
        raise AssertionError("the cached trainer's checkpoint holds more than the head")
    del trainer
    return {"cache_build_s": build_s, "cache_build_launches": build_launches, "cache_sample_bytes": sample_bytes,
            "cached_head_err": err, "cached_step_ms": step_ms, "cached_val_ms": val_ms}


def clip_samples(cfg: VLBConfig, n_batches: int, batch: int, dev) -> list:
    """``n_batches`` x ``batch`` samples whose frames are made on the card
    from seed 0 (``synthetic_batches``'), one ``LazySample`` each."""
    batches = synthetic_batches(cfg, n_batches, batch, np.random.default_rng(SEED),
                                torch.Generator(device=dev).manual_seed(SEED), dev, frames=True)
    return [LazySample(**{f: b[f][r] for f in LazySample.FIELDS}) for b in batches for r in range(batch)]


def two_lora_steps(model, start: dict, loader, dev) -> dict:
    """``TOKEN_STEPS`` steps of ``train_batches`` from ``start``'s adapters
    and a fresh AdamW, dropout seeds from seed 0; step 1's adapter
    gradients are kept."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, t in start.items():
            params[name].copy_(t)
    optimizer = AdamWCosine(trainable_parameters(model))
    seeds = torch.Generator().manual_seed(SEED)
    batches = [b.as_dict() for b in loader]
    first = train_batches(model, batches[:1], device=dev, generator=seeds, optimizer=optimizer)
    grads = {name: p.grad.detach().clone() for name, p in params.items() if "lora_" in name}
    rest = train_batches(model, batches[1:], device=dev, generator=seeds, optimizer=optimizer)
    return {"loss": [float(x) for x in (*first["brain_loss"], *rest["brain_loss"])],
            "step_ms": [float(x) for x in (*first["step_ms"], *rest["step_ms"])], "grads": grads}


def after_train_token_cache(root: Path, dev, files: bool) -> dict:
    """(c) ``vlb_friends_lora`` with the token cache at batch 3: the tokens
    bit-equal to ``encode_video`` of the same frames; 2 LoRA steps from the
    cached tokens against 2 from the frames on the same weights and seeds."""
    config = compose("vlb_friends_lora", root / "tokens")
    batch = int(config.datamodule.batch_size)
    model = build_model(config.model, int(config.random_state), dev)
    cfg = model.cfg
    samples = clip_samples(cfg, TOKEN_STEPS, batch, dev)
    shape = (len(samples), cfg.geometry.num_vis_tokens, cfg.mistral.hidden_size)
    tokens = np.zeros(shape, np.uint16)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    encode_tokens(model, samples, tokens, batch_size=batch)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    encode_launches = {k: v for k, v in read_launches().items() if v}
    with torch.no_grad():
        want = torch.cat([model.encode_video(torch.stack([s.vision for s in samples[i:i + batch]]))
                          for i in range(0, len(samples), batch)]).to(torch.bfloat16)
    equal = np.array_equal(tokens, want.view(torch.int16).cpu().numpy().view(np.uint16))
    source = tokens
    if files:
        import h5py

        path = root / "vision_tokens.h5"
        with h5py.File(path, "w") as f:
            out = f.create_dataset("tokens", shape=shape, dtype=np.uint16, chunks=(1, *shape[1:]))
            encode_tokens(model, samples, out, batch_size=batch)
        with h5py.File(path, "r") as f:
            equal = equal and np.array_equal(f["tokens"][...], tokens)
        source = path
    print(f"  {len(samples)} clips' tokens {shape[1:]} ({tokens.nbytes / 1e6:.1f} MB as uint16 bf16 bits"
          f"{', in a file too' if files else ''}) in {encode_ms:.1f} ms, launches {encode_launches}; bit-equal to "
          f"encode_video of the same frames: {equal}")
    if not equal or encode_launches:
        raise AssertionError("the cached tokens differ from encode_video's, or the sweep launched a kernel")

    start = {name: p.detach().clone() for name, p in model.named_parameters() if trainable_predicate(name)}
    frames = two_lora_steps(model, start, BatchLoader(samples, batch, shuffle=False, prefetch=0), dev)
    again = two_lora_steps(model, start, BatchLoader(samples, batch, shuffle=False, prefetch=0), dev)
    torch.cuda.synchronize()
    reset_launches()
    cached = two_lora_steps(model, start, BatchLoader(TokenCachedDataset(samples, source), batch, shuffle=False,
                                                      prefetch=0), dev)
    launches = read_launches()
    layers = cfg.mistral.num_hidden_layers
    want = expected_fit_launches(layers, TOKEN_STEPS, 0, lora=True)

    def gaps(run: dict) -> dict:
        """``run`` against the first run from frames: step 1's adapter
        gradients per tensor (the largest max|err| / max|ref|) and as one
        vector by 2-norm, step 2's loss relative, step 1's loss bit-equal."""
        names = sorted(frames["grads"])
        want_g = torch.cat([frames["grads"][k].flatten() for k in names])
        got_g = torch.cat([run["grads"][k].flatten() for k in names])
        return {"tensor": max(rel_err(run["grads"][k], frames["grads"][k]) for k in names),
                "norm": ((got_g - want_g).norm() / want_g.norm()).item(),
                "loss2": abs(run["loss"][1] - frames["loss"][1]) / abs(frames["loss"][1]),
                "loss1_equal": run["loss"][0] == frames["loss"][0]}

    floor, gap = gaps(again), gaps(cached)
    print(f"  LoRA steps from frames: brain_loss {frames['loss']}, ms {[round(x, 3) for x in frames['step_ms']]}; "
          f"again from frames: brain_loss {again['loss']}, ms {[round(x, 3) for x in again['step_ms']]}; "
          f"from cached tokens: brain_loss {cached['loss']}, ms {[round(x, 3) for x in cached['step_ms']]}")
    for label, g in (("frames against frames (the floor)", floor), ("tokens against frames", gap)):
        print(f"  {label}: step 1 loss bit-equal {g['loss1_equal']}, adapter grads |err| / |ref| {g['norm']:.3e} "
              f"(tol {TOKEN_GRAD_TOL}; per tensor max|err| / max|ref| up to {g['tensor']:.3e}), step 2 loss "
              f"|err| / |ref| {g['loss2']:.3e} (tol {TOKEN_LOSS_TOL})")
    print(f"  tokens' gradient gap / the floor's {gap['norm'] / max(floor['norm'], 1e-30):.3f} (tol "
          f"{TOKEN_FLOOR_RATIO}); launches from tokens { {k: v for k, v in launches.items() if v} }")
    if not all(g["loss1_equal"] and g["norm"] <= TOKEN_GRAD_TOL and g["loss2"] <= TOKEN_LOSS_TOL
               for g in (floor, gap)) or gap["norm"] > TOKEN_FLOOR_RATIO * floor["norm"]:
        raise AssertionError("the LoRA steps from cached tokens differ from those from frames more than frames "
                             "from frames may")
    if launches != want:
        raise AssertionError(f"the steps from cached tokens launched {launches}, want {want}")
    del model
    torch.cuda.empty_cache()
    return {"token_encode_ms": encode_ms, "frames_step_ms": frames["step_ms"], "tokens_step_ms": cached["step_ms"],
            "frames_again_step_ms": again["step_ms"], "token_gap": gap, "token_floor": floor,
            "token_launches": launches}


def after_train_brainmaps(root: Path) -> dict:
    """(d) ``vlb-brainmaps-torch`` over 9t's first metrics.csv (4 val rows)
    with an atlas of one label per ROI column (1000), 3 voxels each,
    written by ``save_nifti``: one HTML and one ``.nii.gz`` a row, each
    parcel holding r² of its row."""
    (csv_path,) = (root / "lora").glob("*/version_0/metrics.csv")
    rows = read_csv(csv_path)
    val_rows = [r for r in rows if r.get("val/brain_loss")]
    n_roi = sum(c.startswith("val_corr_ROI_") for c in rows[0])
    rng = np.random.default_rng(SEED)
    n_voxels = int(np.prod(ATLAS_SHAPE))
    labels = np.concatenate([np.repeat(np.arange(1, n_roi + 1), 3), np.zeros(n_voxels - 3 * n_roi, np.int64)])
    atlas = rng.permutation(labels).reshape(ATLAS_SHAPE).astype(np.int32)
    save_nifti(NiftiImage(atlas, np.diag([2.0, 2.0, 2.0, 1.0])), root / "atlas.nii.gz")
    (root / "maps").mkdir()
    t0 = time.perf_counter()
    if brainmaps_main(["--metrics_path", str(csv_path.parent), "--atlas_path", str(root / "atlas.nii.gz"),
                       "--out_path", str(root / "maps" / "sub-01"), "--export_nii", "True"]) != 0:
        raise AssertionError("vlb-brainmaps-torch failed")
    wall_s = time.perf_counter() - t0
    html = sorted((root / "maps").glob("*.html"))
    nii = sorted((root / "maps").glob("*.nii.gz"))
    exact = True
    for i, row in enumerate(val_rows):
        volume = load_nifti(root / "maps" / f"sub-01_val-{i}.nii.gz").data
        r2 = np.array([float(row[f"val_corr_ROI_{k:06d}"]) for k in range(n_roi)]) ** 2
        exact = exact and all((volume[atlas == k + 1] == np.float32(r2[k])).all() for k in range(n_roi)) and \
            (volume[atlas == 0] == 0).all()
    print(f"  {n_roi}-label atlas {ATLAS_SHAPE}; {len(val_rows)} val rows -> {len(html)} HTML ({sum(p.stat().st_size for p in html) / 1e6:.2f} MB) and "
          f"{len(nii)} .nii.gz in {wall_s:.2f} s; every parcel holds its row's r²: {exact}")
    if len(val_rows) != 4 or len(html) != 4 or len(nii) != 4 or not exact:
        raise AssertionError("the brain maps are not one HTML and one volume of r² per val row")
    return {"brainmaps_s": wall_s}


def after_train_child(out: str) -> int:
    """``--after-train DIR``: phase 9p in this process, on phase 9t's DIR;
    prints one JSON line of its numbers last."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(out)
    files = h5py_present()
    print(f"{card_name_and_power()}; h5py {'imports: files are written and read too' if files else 'is absent: the caches and predictions stay in memory'}")
    record = {"h5py": files}
    with phase("9p predict (vlb-predict-torch) from 9t's last"):
        record.update(after_train_predict(root, dev, files))
    with phase("9p feature cache (vlb_friends_baseline model.cache_features=true)"):
        record.update(after_train_feature_cache(root, dev, files))
    with phase("9p vision-token cache (vlb_friends_lora) against frames"):
        record.update(after_train_token_cache(root, dev, files))
    with phase("9p brain maps (vlb-brainmaps-torch) over 9t's metrics.csv"):
        record.update(after_train_brainmaps(root))
    record["peak_rss_gb"] = peak_rss_gb()
    print(json.dumps(record))
    if record["peak_rss_gb"] > HOST_RSS_LIMIT_GB:
        raise AssertionError(f"the after-train phase's peak host RSS {record['peak_rss_gb']:.2f} GB is over "
                             f"{HOST_RSS_LIMIT_GB}")
    return 0


# ---------------------------------------------------------------------------
# Phase 9e: the first two stages users run (vlb-extract, vlb-build-lazyload)
# through the port, in a process of its own (``--extract DIR``), then a LoRA
# step from what they built. The stores are in memory (the card's machine
# has no h5py) and the libav decoder is not built there (no libav headers):
# frames come from a seeded VideoSource, and go through the card's
# preprocessor.

# The season, cut to two episodes: s01e01a trains (11 TRs: 6 samples, 2
# batches of 3), s01e01b validates (8 TRs: 3 samples); split_train_val at
# random_state 1234 takes the second of the two split stores for val.
EXTRACT_EPISODES = {"s01e01a": 11, "s01e01b": 8}
EXTRACT_SPLITS = 2
FRAME_SIZE, FRAME_FPS = (480, 720), 29.97        # DVD-sized NTSC frames (height, width), not square
EXTRACT_STEPS = 2
# The card's preprocessed frames against the port's preprocess on the CPU
# for the same frames: the CPU tests' bound against the JAX device path,
# kept after a reading of 5.15e-5 on an NVIDIA H100 80GB HBM3 (700 W; f32
# sums of the antialiased bicubic taps in another order).
PREPROCESS_TOL = 1e-4
SEASON_WORDS = ("hey oh okay you know I just really think that Ross Rachel Monica Chandler Joey Phoebe "
                "couch coffee pivot we were on a break how you doin").split()


class SeededFrames:
    """A ``VideoSource`` whose frame ``i`` is made from (seed, i) when asked
    for, so no episode's frames are all held at once."""

    def __init__(self, seed: int, num_frames: int, size: tuple[int, int] = FRAME_SIZE, fps: float = FRAME_FPS):
        self.seed, self._n, self.size, self._fps = seed, num_frames, size, fps

    @property
    def fps(self) -> float:
        return self._fps

    @property
    def num_frames(self) -> int:
        return self._n

    def get_batch(self, indices) -> np.ndarray:
        return np.stack([np.random.default_rng([self.seed, int(i)]).integers(0, 256, (*self.size, 3), np.uint8)
                         for i in indices])


class TimedPreprocessor:
    """A ``preprocess_batch`` that times each call of ``pre`` with CUDA
    events (upload, resize and normalise, download) and counts frames."""

    def __init__(self, pre):
        self.pre, self.ms, self.frames = pre, [], 0

    def __call__(self, images) -> np.ndarray:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.pre(images)
        end.record()
        end.synchronize()
        self.ms.append(start.elapsed_time(end))
        self.frames += len(out)
        return out


def episode_frames(geom, n_tr: int) -> int:
    """Frames of an episode whose video gives ``n_tr`` TR windows."""
    return int(n_tr * geom.tr * FRAME_FPS) + 5


def write_season(root: Path, geom, seed: int = SEED) -> None:
    """Each episode's transcript (a few words a TR, every third TR silent)
    and scene TSVs, written with the csv module."""
    rng = np.random.default_rng(seed)
    for sub in ("transcripts", "segs"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for ep, n_tr in EXTRACT_EPISODES.items():
        with open(root / "transcripts" / f"friends_{ep}.tsv", "w", newline="") as f:
            w = csv.writer(f, delimiter="\t", lineterminator="\n")
            w.writerow(["text_per_tr", "words_per_tr", "onsets_per_tr"])
            for i in range(n_tr):
                if i % 3 == 2:
                    w.writerow(["", "", ""])
                    continue
                words = [str(x) for x in rng.choice(SEASON_WORDS, size=int(rng.integers(2, 7)))]
                onsets = sorted(round(i * geom.tr + float(x), 3) for x in rng.uniform(0, geom.tr, len(words)))
                w.writerow([" ".join(words) + " ", str(words), str(onsets)])
        with open(root / "segs" / f"friends_{ep.replace('s0', 's')}_manualseg.tsv", "w", newline="") as f:
            w = csv.writer(f, delimiter="\t", lineterminator="\n")
            w.writerow(["scene", "onset"])
            w.writerows([[1, 0.0], [2, round(n_tr * geom.tr * 0.4, 3)], [3, round(n_tr * geom.tr * 0.7, 3)]])


def extract_season(root: Path, geom, dev) -> tuple:
    """(a) Each episode not yet in an in-memory features store through
    ``extract_episode`` with the card's preprocessor, checked and written
    as ``extract_features`` writes it; a second pass writes nothing
    (resume). Then the preprocessor's output against ``preprocess`` on the
    CPU for 16 frames. Returns the store and the record."""
    tok = SentencePieceTestTokenizer()
    validate_joiner_counts(tok)
    pre = TimedPreprocessor(DevicePreprocessor(geom.image_size, device=dev))
    store = MemoryStore()

    def one_pass() -> list[str]:
        done, written = set(list_feature_episodes(store)), []
        for k, (ep, n_tr) in enumerate(EXTRACT_EPISODES.items()):
            if ep in done:
                continue
            transcript = read_tsv(root / "transcripts" / f"friends_{ep}.tsv")
            seg = read_tsv(root / "segs" / f"friends_{ep.replace('s0', 's')}_manualseg.tsv")
            episode = extract_episode(transcript, seg, SeededFrames(SEED + k, episode_frames(geom, n_tr)), geom,
                                      tok, preprocess_batch=pre)
            episode.validate(geom)
            if episode.video_features.shape[0] != n_tr or episode.transcript_features.shape[0] != n_tr:
                raise AssertionError(f"{ep}: {episode.video_features.shape[0]} video and "
                                     f"{episode.transcript_features.shape[0]} text TRs, want {n_tr}")
            write_feature_episode(store, ep, episode)
            written.append(ep)
        return written

    t0 = time.perf_counter()
    written = one_pass()
    extract_s = time.perf_counter() - t0
    calls = len(pre.ms)
    again = one_pass()
    n_tr = sum(EXTRACT_EPISODES.values())
    if written != list(EXTRACT_EPISODES) or again or len(pre.ms) != calls:
        raise AssertionError(f"extraction wrote {written}, then {again} on resume; want all, then none")

    frames = SeededFrames(SEED, 64).get_batch(range(0, 64, 4))
    card = pre.pre(frames)
    host = preprocess(frames, geom.image_size, device="cpu").numpy()
    err = float(np.abs(card - host).max())
    ms_frame = sum(pre.ms) / pre.frames
    sizes = {ep: store[ep]["video_features"].shape for ep in store}
    print(f"  {len(written)} episodes, {n_tr} TRs of {FRAME_SIZE[1]}x{FRAME_SIZE[0]} frames at {FRAME_FPS} fps: "
          f"{extract_s:.3f} s, {extract_s / n_tr:.4f} s a TR; the card's preprocessor {pre.frames} frames in "
          f"{calls} calls, {ms_frame:.4f} ms a frame (CUDA events); video_features {sizes} f32, "
          f"{store['s01e01a']['video_features'][0].nbytes / 1e6:.2f} MB a TR; resume wrote {again}; "
          f"card against the CPU's preprocess max|err| {err:.3e} (tol {PREPROCESS_TOL})")
    if not err <= PREPROCESS_TOL:
        raise AssertionError("the card's preprocessed frames differ from the CPU's")
    return store, {"extract_s": extract_s, "extract_s_per_tr": extract_s / n_tr, "preprocess_ms_per_frame": ms_frame,
                   "preprocess_calls_ms": pre.ms, "preprocess_err": err}


def build_season(features, geom) -> tuple:
    """(b) A 1000-parcel BOLD store and ``build_lazyload_dsets`` into
    ``EXTRACT_SPLITS`` in-memory lazy-load stores; the sample count and
    every sample's rows against the source rows, bit-equal. Returns the
    container, each split's (episode, row) per sample, and the record."""
    inferred = infer_geometry(features, window=geom.window, delay=geom.delay, tr=geom.tr)
    if dataclasses.replace(inferred, num_parcels=geom.num_parcels) != geom:
        raise AssertionError("the geometry inferred from the features store is not the extraction's")
    bold = MemoryStore()
    write_synthetic_bold_file(bold, EXTRACT_EPISODES, geom, seed=SEED + 1)
    container = MemoryStore()
    t0 = time.perf_counter()
    stores = build_lazyload_dsets(LazyloadBuildConfig(features, bold, container, "sub-01", "s1",
                                                      n_split=EXTRACT_SPLITS, geometry=geom))
    build_s = time.perf_counter() - t0
    keys = bold_episode_keys(bold)
    vis = get_hrf_weights(geom.vision_onset_deltas())
    episodes = sorted(EXTRACT_EPISODES)
    chunk = np.floor(np.arange(len(episodes)) / (len(episodes) / EXTRACT_SPLITS)).astype(int)
    sources, n_samples = [], 0
    for i, store in enumerate(stores):
        rows = []
        for ep in [e for e, c in zip(episodes, chunk) if c == i]:
            src = features[ep]
            ses, run = keys[ep]
            ts = bold[ses][run]
            n_rows = min(len(ts) - geom.bold_offset, len(src["video_features"]) - geom.window_offset,
                         len(src["transcript_features"]) - geom.window_offset)
            onsets = geom.target_tr_onsets(len(ts) - geom.bold_offset)
            for n in range(n_rows):
                g, idx, row = store[f"{len(rows)}"], len(rows), geom.window_offset + n
                diag = int(src["masking_params"][row][2])
                lang = src["transcript_onsets"][row].copy()
                lang[:diag] = get_hrf_weights(onsets[n] - lang[:diag])
                want = {"vision": src["video_features"][row], "language": src["transcript_features"][row],
                        "padvals": src["masking_params"][row], "timeseries": ts[geom.bold_offset + n],
                        "vis_weights": vis, "lang_weights": lang}
                for field, value in want.items():
                    if not np.array_equal(g[f"{idx}_{field}"], value):
                        raise AssertionError(f"split {i} sample {idx} ({ep} row {row}): {field} differs from "
                                             f"its source")
                rows.append((ep, n))
        if lazyload_len(store) != len(rows):
            raise AssertionError(f"split {i} holds {lazyload_len(store)} samples, want {len(rows)}")
        sources.append(rows)
        n_samples += len(rows)
    want_n = sum(n - geom.bold_offset for n in EXTRACT_EPISODES.values())
    sample_bytes = sum(v.nbytes for v in stores[0]["0"].values())
    print(f"  {len(stores)} lazy-load stores {[lazyload_len(s) for s in stores]} samples ({n_samples}, want "
          f"{want_n}), every row bit-equal to its source; {sample_bytes / 1e6:.2f} MB a sample; built in "
          f"{build_s:.3f} s, {build_s / n_samples:.4f} s a sample")
    if n_samples != want_n:
        raise AssertionError(f"the build made {n_samples} samples, want {want_n}")
    return container, sources, bold, {"build_s": build_s, "build_s_per_sample": build_s / n_samples,
                                      "samples": n_samples}


def source_batch(features, bold, geom, rows: list) -> dict:
    """The samples at (episode, n) ``rows`` collated from the features and
    BOLD stores' source arrays, with the loader's dtypes, without the
    lazy-load stores."""
    from phantom_vlb_tpu_torch.data.hrf import get_hrf_weights
    keys = bold_episode_keys(bold)
    vis = get_hrf_weights(geom.vision_onset_deltas())
    out = {f: [] for f in ("timeseries", "vision", "language", "vis_weights", "lang_weights", "padvals")}
    for ep, n in rows:
        src, (ses, run) = features[ep], keys[ep]
        row = geom.window_offset + n
        onsets = geom.target_tr_onsets(len(bold[ses][run]) - geom.bold_offset)
        diag = int(src["masking_params"][row][2])
        lang = src["transcript_onsets"][row].copy()
        lang[:diag] = get_hrf_weights(onsets[n] - lang[:diag])
        for field, value in (("timeseries", bold[ses][run][geom.bold_offset + n]),
                             ("vision", src["video_features"][row]), ("language", src["transcript_features"][row]),
                             ("vis_weights", vis), ("lang_weights", lang), ("padvals", src["masking_params"][row])):
            out[field].append(np.array(value))
    dtypes = {"timeseries": np.float32, "vision": np.float32, "language": np.int32, "vis_weights": np.float32,
              "lang_weights": np.float32, "padvals": np.int32}
    batch = {f: np.stack(v).astype(dtypes[f]) for f, v in out.items()}
    batch["row_mask"] = np.ones(len(rows), np.float32)
    return batch


def stage_loaders(config, container) -> tuple:
    """The train and val loaders over the lazy-load stores, split as
    ``build_loaders`` splits the files; and the train splits' indices."""
    names = sorted(container)
    train_names, val_names = split_train_val(names, int(config.datamodule.random_state))
    train, val = split_loaders(config.datamodule, [container[n] for n in train_names],
                               [container[n] for n in val_names])
    return train, val, [names.index(n) for n in train_names]


def first_batch_rows(train: BatchLoader, sources: list, train_splits: list) -> list:
    """The (episode, n) of the samples in the first batch of ``train``'s
    first epoch: its shuffle is ``default_rng(seed)`` over the indices."""
    order = np.arange(len(train.dataset))
    np.random.default_rng(train.seed).shuffle(order)
    flat = [r for i in train_splits for r in sources[i]]
    return [flat[int(i)] for i in order[:train.batch_size]]


def train_from_stores(config, train, val, arrays: dict, dev) -> dict:
    """(c) ``VLBTrainer`` of the config over the stores' loaders, 2 steps
    with its validations; the first step's loss against the same batch fed
    as arrays (from the sources) to ``train_batches`` from the same
    starting adapters and dropout seed."""
    t0 = time.perf_counter()
    trainer, train, val = build_trainer(config, device=dev, loaders=(train, val))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    model_cfg = trainer.model.cfg
    print(f"  trainer built in {time.perf_counter() - t0:.2f} s: {model_cfg.mistral.num_hidden_layers} layers, "
          f"batch {train.batch_size}, {len(train)} train and {len(val)} val batches from the stores")
    start = {k: p.detach().clone() for k, p in trainer.trainable.items()}
    seen, losses = [], []
    train_one = trainer.train_one

    def recording(batch):
        if not seen:
            seen.append({k: np.array(v) for k, v in batch.as_dict().items()})
        out = train_one(batch)
        losses.append(float(out["brain_loss"]))
        return out

    trainer.train_one = recording
    if dev.type == "cuda":
        launches, step_ms, val_ms, save_ms = fit_and_count(trainer, train, val)
        peak_device_gb = torch.cuda.max_memory_allocated() / 1e9
    else:
        trainer.fit(train, val)
        launches, step_ms, val_ms, save_ms, peak_device_gb = {}, [], [], [], 0.0
    if trainer.global_step != EXTRACT_STEPS or len(losses) != EXTRACT_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"the fit took {trainer.global_step} steps with losses {losses}, want "
                             f"{EXTRACT_STEPS} finite")
    same_batch = seen[0].keys() == arrays.keys() and all(
        seen[0][k].dtype == arrays[k].dtype and np.array_equal(seen[0][k], arrays[k]) for k in arrays)
    if not same_batch:
        raise AssertionError("the trainer's first batch is not the one collated from the sources")
    params = dict(trainer.model.named_parameters())
    with torch.no_grad():
        for name, t in start.items():
            params[name].copy_(t)
    again = train_batches(trainer.model, [arrays], device=dev,
                          generator=torch.Generator().manual_seed(trainer.config.seed),
                          optimizer=None)
    array_loss = float(again["brain_loss"][0])
    print(f"  LoRA fit over the stores: losses {losses}; the same first batch fed as arrays: {array_loss} "
          f"(bit-equal: {array_loss == losses[0]}); step ms {[round(x, 3) for x in step_ms]}, validation ms "
          f"{[round(x, 3) for x in val_ms]}, saves ms {[round(x, 3) for x in save_ms]}, peak device memory "
          f"{peak_device_gb:.2f} GB, launches { {k: v for k, v in launches.items() if v} }")
    if array_loss != losses[0]:
        raise AssertionError("the first step's loss from the stores differs from the same batch fed as arrays")
    return {"losses": losses, "array_loss": array_loss, "step_ms": step_ms, "val_ms": val_ms, "save_ms": save_ms,
            "launches": launches, "validations": len(val_ms), "val_batches": len(val),
            "layers": model_cfg.mistral.num_hidden_layers, "peak_device_gb": peak_device_gb}


def extract_child(out: str) -> int:
    """``--extract DIR``: phase 9e in this process, under DIR; prints one
    JSON line of its numbers last."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(out)
    card = card_name_and_power()
    geom = REFERENCE_GEOMETRY
    print(f"{card}; {len(EXTRACT_EPISODES)} episodes {EXTRACT_EPISODES} TRs (cut), geometry of record: TR {geom.tr} s, "
          f"{geom.frames_per_tr} frames a TR, window {geom.window} ({geom.num_frames} frames a sample), "
          f"{geom.image_size} px, {geom.max_lang_tokens} text ids, {geom.onsets_width} onsets")
    record = {}
    with phase("9e (a) extract (vlb-extract) with the card's preprocessor into a features store"):
        write_season(root, geom)
        features, rec = extract_season(root, geom, dev)
        record.update(rec)
    with phase("9e (b) build (vlb-build-lazyload) into lazy-load stores"):
        container, sources, bold, rec = build_season(features, geom)
        record.update(rec)
        config = compose("vlb_friends_lora", root / "train", "trainer.max_epochs=1")
        train, val, train_splits = stage_loaders(config, container)
        arrays = source_batch(features, bold, geom, first_batch_rows(train, sources, train_splits))
        del features                       # released before the model is made
    with phase("9e (c) LoRA steps (vlb_friends_lora) from the stores at full width"):
        rec = train_from_stores(config, train, val, arrays, dev)
        want = expected_fit_launches(rec["layers"], EXTRACT_STEPS, rec["validations"] * rec["val_batches"], lora=True)
        if rec["launches"] != want:
            raise AssertionError(f"the fit launched {rec['launches']}, want {want}")
        record.update(rec)
    record["peak_rss_gb"] = peak_rss_gb()
    print(f"  peak host RSS {record['peak_rss_gb']:.2f} GB ({card})")
    print(json.dumps(record))
    if record["peak_rss_gb"] > HOST_RSS_LIMIT_GB:
        raise AssertionError(f"the extract phase's peak host RSS {record['peak_rss_gb']:.2f} GB is over "
                             f"{HOST_RSS_LIMIT_GB}")
    return 0


# ---------------------------------------------------------------------------
# Phase 8r: the decoder's checkpoint policies (``remat_policy``) on phase 7's
# full-width LoRA weights from cached tokens, one model switched in place
# (alone, on weights of its own: ``python3 chip_smoke.py --remat DIR``).

REMAT_RUNS = ("nothing", "nothing", "attn", "mids", "flash", "dots")
REMAT_STEPS = 2


class ProductCount(TorchDispatchMode):
    """Counts the ``aten.mm`` calls dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def device_busy(fn) -> tuple[float, float, dict[str, float]]:
    """``fn()`` under ``torch.profiler`` (the device's activity only): its
    wall ms, the device's busy ms and ms by kernel group."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.key != QUEUE_FULL:
            groups[kernel_group(e.key)] = groups.get(kernel_group(e.key), 0.0) + e.device_time_total / 1e3
    return wall_ms, sum(groups.values()), groups


def remat_run(model, start: dict, batches: list, dev, policy: str, steps: int = REMAT_STEPS) -> dict:
    """``steps`` steps of ``train_batches`` under ``policy`` from ``start``'s
    adapters and a fresh AdamW, dropout seeds from seed 0: launches, losses,
    step-1 adapter gradients, the peak device memory, step 1's ms
    (a synchronised host clock) and, of two steps, step 2's wall and device busy ms
    (traced); of one step, the ``aten.mm`` calls it dispatched."""
    set_remat_policy(model, policy)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, t in start.items():
            params[name].copy_(t)
    optimizer = AdamWCosine(trainable_parameters(model))
    seeds = torch.Generator().manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    products = ProductCount()

    def step(i):
        return train_batches(model, [batches[i]], device=dev, generator=seeds, optimizer=optimizer)

    t0 = time.perf_counter()
    with products if steps == 1 else contextlib.nullcontext():
        loss = [float(step(0)["brain_loss"][0])]
        torch.cuda.synchronize()
    step_ms = {"step 1": round((time.perf_counter() - t0) * 1e3, 3)}
    grads = {n: p.grad.detach().clone() for n, p in params.items() if "lora_" in n}
    run = {"step_ms": step_ms, "mm": products.mm, "grads": grads}
    if steps > 1:
        out = {}
        run["wall_ms"], run["busy_ms"], run["groups"] = device_busy(lambda: out.update(step(1)))
        loss.append(float(out["brain_loss"][0]))
    run.update(launches=read_launches(), loss=loss,
               peak_gb=device_memory_stats()[0]["peak_bytes_in_use"] / 1e9)
    return run


# The models phase 8r switches through the policies: (label, attention_impl,
# fused_epilogue, decoder layers). The rings run on RING_RANKS ranks of the
# card. The packed model keeps its 32 layers; the others run phase 7's
# first 8 layers at full width, which the policies' checks hold per layer,
# to keep the script's time (``--remat`` alone at 32 layers each takes
# ~225 s).
REMAT_MODELS = (("packed", "auto", "", None), ("fused epilogue", "auto", "pallas", 8),
                ("ring_fused", "ring_fused", "", 8), ("ring_flash", "ring_flash", "", 8))


def first_layers(tensors: dict, layers: int) -> dict:
    """``tensors`` (a state dict, or a part of one) without the decoder
    layers from ``layers`` on."""
    return {k: t for k, t in tensors.items()
            if not (k.startswith("model.layers.") and int(k.split(".")[2]) >= layers)}


def policy_sweep(model, label: str, start: dict, batches: list, dev, card: str) -> dict:
    """``model`` through REMAT_RUNS: each policy's launches against what the
    JAX grad's jaxpr runs (``expected_train_launches``), its first loss
    bit-equal to the first 'nothing' run's and its step-1 gradients within
    TOKEN_FLOOR_RATIO x the gap of the two 'nothing' runs; its numbers."""
    mcfg = model.cfg.mistral
    layers = mcfg.num_hidden_layers
    ring = None if mcfg.attention_impl == "auto" else mcfg.attention_impl
    runs = []
    for policy in REMAT_RUNS:
        run = remat_run(model, start, batches, dev, policy)
        want = expected_train_launches(layers, REMAT_STEPS, epilogue=bool(mcfg.lora.fused_epilogue), ring=ring,
                                       remat_policy=policy)
        print(f"  {label} {policy!r}: losses {run['loss']}, step 1 ms {run['step_ms']['step 1']}, step 2 (traced) "
              f"wall {run['wall_ms']:.3f} ms, device busy {run['busy_ms']:.3f} ms (idle share "
              f"{1.0 - run['busy_ms'] / run['wall_ms']:.4f}; "
              + ", ".join(f"{g} {ms:.3f}" for g, ms in sorted(run["groups"].items(), key=lambda x: -x[1]))
              + f"), peak device memory {run['peak_gb']:.3f} GB, launches "
              f"{ {k: v for k, v in run['launches'].items() if v} }")
        if run["launches"] != want:
            raise AssertionError(f"{label}: remat_policy {policy!r} launched {run['launches']}, want {want}")
        if ring == "ring_fused":
            check_ring_sends(run["launches"], f"{label} under {policy!r}")
        runs.append((policy, run))
    ref = runs[0][1]
    floor = grad_gap(runs[1][1]["grads"], ref["grads"])
    print(f"  {label}: step-1 adapter gradients of the two 'nothing' runs: |err|/|ref| {floor['norm']:.4e} by "
          f"2-norm (the floor), largest per-tensor max|err|/max|ref| {floor['tensor']:.4e}")
    keys = ("step_ms", "wall_ms", "busy_ms", "peak_gb")
    record = {"nothing": {**{k: [ref[k], runs[1][1][k]] for k in keys}, "grad_gap": floor["norm"],
                          "launches": ref["launches"]}}
    for policy, run in runs[2:]:
        gap = grad_gap(run["grads"], ref["grads"])
        print(f"  {label} {policy!r}: first loss {run['loss'][0]!r} against {ref['loss'][0]!r}; gradients "
              f"{gap['norm']:.4e} from the first 'nothing' run's (limit {TOKEN_FLOOR_RATIO} x "
              f"{floor['norm']:.4e}), per tensor {gap['tensor']:.4e}; step 2 wall {run['wall_ms']:.3f} ms, "
              f"device busy {run['busy_ms']:.3f} ms against {ref['wall_ms']:.3f} and {ref['busy_ms']:.3f}, "
              f"peak {run['peak_gb']:.3f} GB against {ref['peak_gb']:.3f} ({card})")
        if run["loss"][0] != ref["loss"][0]:
            raise AssertionError(f"{label}: remat_policy {policy!r}: the first loss differs from 'nothing''s")
        if not gap["norm"] <= TOKEN_FLOOR_RATIO * floor["norm"]:
            raise AssertionError(f"{label}: remat_policy {policy!r}: the step-1 gradients are {gap['norm']:.4e} "
                                 f"from 'nothing''s, over {TOKEN_FLOOR_RATIO} x the floor {floor['norm']:.4e}")
        record[policy] = {**{k: run[k] for k in keys}, "grad_gap": gap["norm"], "launches": run["launches"]}
    return record


def remat_policies(sd: dict, start: dict, batches: list, dev, card: str) -> dict:
    """Phase 8r on ``sd``'s full-width LoRA weights (phase 7's), from
    ``start``'s adapters, over ``batches`` of cached tokens: each model of
    REMAT_MODELS through the policies; returns its numbers."""
    record = {}
    for label, impl, epilogue, depth in REMAT_MODELS:
        cfg = lora_train_config(fused_epilogue=epilogue)
        layers = depth or cfg.mistral.num_hidden_layers
        cfg = dataclasses.replace(cfg, mistral=dataclasses.replace(cfg.mistral, attention_impl=impl,
                                                                   num_hidden_layers=layers))
        model = VideoLLaMA2VLB.from_state_dict(cfg, first_layers(sd, layers))
        print(f"  {label}: {layers} layers bf16, LoRA r {cfg.mistral.lora.rank} with the fused u8 dropout {LORA_P}, "
              f"fused epilogue {epilogue or 'off'}, attention {impl}"
              + (f" on {RING_RANKS} ranks of the card" if impl != "auto" else "")
              + f", batch {LORA_BATCH} from cached tokens, {REMAT_STEPS} steps a policy, the second traced")
        if impl != "auto":
            set_sequence_ring(SequenceRing([dev] * RING_RANKS))
        try:
            record[label] = policy_sweep(model, label, first_layers(start, layers), batches, dev, card)
        finally:
            set_sequence_ring(None)
        del model
        torch.cuda.empty_cache()                   # 'dots' kept ~34 GB
    layers = lora_train_config().mistral.num_hidden_layers
    lora = LoRAConfig(rank=16, alpha=32.0, dropout=LORA_P)
    umodel = VideoLLaMA2VLB.from_state_dict(
        VLBConfig.full(use_lora=True, mistral=MistralConfig.full(lora=lora, remat=True)), sd)
    unfused = {policy: remat_run(umodel, start, batches, dev, policy, steps=1) for policy in ("nothing", "mids")}
    for policy, run in unfused.items():
        want = expected_train_launches(layers, 1, remat_policy=policy, keep=True)
        print(f"  the trainer's unfused 32-bit dropout under {policy!r}: loss {run['loss'][0]!r}, {run['mm']} "
              f"products (aten.mm), step ms {run['step_ms']}, peak {run['peak_gb']:.3f} GB, launches "
              f"{ {k: v for k, v in run['launches'].items() if v} }")
        if run["launches"] != want:
            raise AssertionError(f"the unfused step under {policy!r} launched {run['launches']}, want {want}")
    kept = unfused["nothing"]["launches"]["lora_fwd"] - unfused["mids"]["launches"]["lora_fwd"]
    print(f"  'mids' keeps {kept} mids a step (want {7 * layers}: the keep route's dropped x A, 7 a layer; "
          f"its masks drawn again in the replay)")
    if kept != 7 * layers or unfused["mids"]["loss"][0] != unfused["nothing"]["loss"][0]:
        raise AssertionError("the unfused step under 'mids' did not keep x A's 7 mids a layer, or "
                             "its loss differs from 'nothing''s")
    record["unfused"] = {p: {"step_ms": r["step_ms"], "peak_gb": r["peak_gb"], "mm": r["mm"]}
                         for p, r in unfused.items()}
    del umodel
    torch.cuda.empty_cache()
    return record


def remat_child(out: str) -> int:
    """``--remat DIR``: phase 8r alone in this process, on weights of its
    own; prints one JSON line of its numbers last (DIR is not written)."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(SEED)
    card = card_name_and_power()
    print(card)
    cfg = lora_train_config()
    sd = init_params(cfg, dev, gen)
    start = {key: t.clone() for key, t in sd.items() if trainable_predicate(key)}
    with phase("8r the decoder's checkpoint policies (remat_policy)"):
        record = remat_policies(sd, start, lora_batches(cfg, gen, dev), dev, card)
    record["peak_rss_gb"] = peak_rss_gb()
    print(f"  peak host RSS {record['peak_rss_gb']:.2f} GB ({card})")
    print(json.dumps(record))
    if record["peak_rss_gb"] > HOST_RSS_LIMIT_GB:
        raise AssertionError(f"the remat phase's peak host RSS {record['peak_rss_gb']:.2f} GB is over "
                             f"{HOST_RSS_LIMIT_GB}")
    return 0


# ---------------------------------------------------------------------------
# Phase 9d: the trainer of record across processes (``mesh.fsdp=-1`` through
# ``torchrun`` on FSDP2), each rank a process of its own
# (``python -m torch.distributed.run --standalone --nproc_per_node=N
# chip_smoke.py --sharded DIR``), with NCCL. On one card the mesh is one
# process: the sharded step is held against the unsharded trainer's on the
# same weights, batches and seeds; (d) runs where the machine has 2 cards.

SHARDED_OVERRIDES = ("mesh.fsdp=-1", "trainer.max_epochs=1", "trainer.val_check_interval=1.0",
                     "trainer.log_every_n_steps=1")
SHARDED_STEPS = 2                         # 1 epoch of 2 steps and a validation
SHARDED_LIMIT_S = 600                     # each launch of the phase's ranks
SHARDED_COLLECTIVE_S = 240                # a collective's time limit in a rank
PAIR_BATCH = 4                            # (d): 2 ranks of 2 rows against one card at 4
# (d)'s first loss against one card's, |err| / |ref|: the same function, the
# squared errors of each rank's rows summed apart (f32, then added), and
# each card's GEMMs over 2 rows where one card's run over 4, whose bf16
# roundings differ wherever cuBLAS picks another kernel for the shape
# (9p's bound for a loss after bf16 roundings moved: TOKEN_LOSS_TOL).
PAIR_LOSS_TOL = TOKEN_LOSS_TOL


def one_device_mesh() -> MeshEnv:
    return MeshEnv(dict.fromkeys(AXIS_NAMES, 1))


def first_seed(trainer) -> int:
    """The dropout seed of a fresh trainer's first step (``train_one``'s draw)."""
    return int(torch.randint(0, 2**32, (), generator=torch.Generator().manual_seed(trainer.config.seed)))


def recorded_fit(trainer, train: list, val: list, keep=lambda name: "lora_" in name) -> dict:
    """``trainer.fit`` with each step's output and host ms (the card waited
    for before and after), the gradients of step 1 before the clip (whole;
    of the trainable tensors ``keep`` selects, the adapters by default),
    the launch counts set to 0 just before and read just after, and the
    peak device memory."""
    outs, step_ms, grads = [], [], {}
    train_one, clip = trainer.train_one, trainer.optimizer.clip_

    def timed_step(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_one(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
        return out

    def clip_after_snapshot():
        if not grads:
            grads.update({k: whole(p.grad, p).detach().clone() for k, p in trainer.trainable.items()
                          if keep(k)})
        return clip()

    trainer.train_one, trainer.optimizer.clip_ = timed_step, clip_after_snapshot
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    trainer.fit(train, val)
    torch.cuda.synchronize()
    launches = read_launches()
    trainer.train_one, trainer.optimizer.clip_ = train_one, clip
    return {"loss": [float(o["brain_loss"]) for o in outs], "step_ms": step_ms, "grads": grads,
            "launches": launches, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def grad_gap(got: dict, want: dict) -> dict:
    """Adapter gradients against ``want``'s: as one vector by 2-norm, and
    the largest per-tensor max|err| / max|ref|; bit-equal or not."""
    names = sorted(want)
    w = torch.cat([want[k].flatten() for k in names])
    g = torch.cat([got[k].flatten() for k in names])
    return {"norm": ((g - w).norm() / w.norm()).item(),
            "tensor": max(rel_err(got[k], want[k]) for k in names),
            "equal": all(torch.equal(got[k], want[k]) for k in names)}


def unsharded_floor(trainer, batch: dict) -> dict:
    """Step 1's adapter gradients (before the clip) of the unsharded trainer
    once more, without an update: the gap two unsharded runs leave."""
    model = trainer.model.train()
    trainer.optimizer.zero_grad()
    dev_batch = {k: torch.as_tensor(v).to(trainer.device) for k, v in batch.items()}
    loss_fn(model, dev_batch, first_seed(trainer))[0].backward()
    grads = {k: p.grad.detach().clone() for k, p in trainer.trainable.items() if "lora_" in k}
    trainer.optimizer.zero_grad()
    return grads


def saved_state(path: Path, dev) -> dict:
    """``last`` under ``path``, read onto the card (host RSS stays apart)."""
    return torch.load(path / "last" / STATE_FILE, map_location=dev, weights_only=True)


def state_equal(state: dict, saved: dict) -> bool:
    """A trainer's state() against a saved one, tensor for tensor (on the
    saved one's device)."""
    a, b = state["optimizer"]["adamw"]["state"], saved["optimizer"]["adamw"]["state"]

    def same(x, y):
        return torch.equal(x.to(y.device), y)

    return (state["step"] == saved["step"] and state["params"].keys() == saved["params"].keys()
            and all(same(t, saved["params"][k]) for k, t in state["params"].items())
            and state["optimizer"]["step"] == saved["optimizer"]["step"] and a.keys() == b.keys()
            and all(same(a[i][k], b[i][k]) for i in a for k in a[i]))


def rss_note() -> str:
    release_host_memory(collect=True)
    return f"host RSS now {host_rss_gb():.2f} GB, peak {peak_rss_gb():.2f} GB"


def unsharded_buffers_check(model) -> dict:
    """Hooks inside FSDP2 units (a decoder layer's q_proj, a CLIP layer's
    q_proj): whether, while the unit runs, each of the module's parameters
    is a plain, contiguous, 16-byte-aligned tensor (what the kernels and
    their TMA descriptors take)."""
    seen = {}

    def hook(name):
        def record(module, args):
            seen[name] = all(not hasattr(p, "to_local") and p.is_contiguous() and p.data_ptr() % 16 == 0
                             for p in module.parameters())
        return record

    handles = [model.model.layers[0].self_attn.q_proj.register_forward_pre_hook(hook("decoder layer 0 q_proj")),
               model.vision_tower.layers[0].self_attn.q_proj.register_forward_pre_hook(hook("CLIP layer 0 q_proj"))]
    return {"seen": seen, "handles": handles}


def dropout_draw_ms(cfg: VLBConfig, dev) -> dict:
    """One layer's 7 adapter-input masks of the 32-bit path at batch 3 (6
    reading K = 4096, the down projection 14336), the keep kernel's bytes
    as the route draws them (``keep_rows``), for this rank's rows alone
    and for rank 0 of a batch split over 2 ranks (the global batch of 6
    drawn, its rows kept), by CUDA events; a step draws each twice a layer
    (remat), so x 64."""
    keep, s = 1.0 - cfg.mistral.lora.dropout, cfg.geometry.feature_len
    xs = [torch.randn(LORA_BATCH, s, k, device=dev, dtype=torch.bfloat16) for k in (4096, 14336)]

    def layer(rows):
        for i in range(7):
            keep_rows(xs[i == 6], rows, lambda shape: keep_bytes(shape, 1000 + i, keep, dev))

    return {"local_ms": cuda_ms(lambda: layer(None), 5), "global2_ms": cuda_ms(lambda: layer((0, 2 * LORA_BATCH)), 5)}


def sharded_lora(root: Path, dev) -> dict:
    """(a)-(c) on this launch's mesh of one process."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    config_s = compose("vlb_friends_lora", root / "sharded", *SHARDED_OVERRIDES)
    config_u = compose("vlb_friends_lora", root / "unsharded", *SHARDED_OVERRIDES)
    train, val = frame_loaders(config_s, SHARDED_STEPS, 1, gen, dev)
    print(f"  frames made: {rss_note()}")
    unsharded, _, _ = build_trainer(config_u, device=dev, loaders=(train, val), mesh=one_device_mesh())
    layers = unsharded.model.cfg.mistral.num_hidden_layers
    floor_grads = unsharded_floor(unsharded, train[0])
    u = recorded_fit(unsharded, train, val)
    print(f"  unsharded fit: {rss_note()}")
    del unsharded                              # each fit's peak device memory its own
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded, _, _ = build_trainer(config_s, device=dev, loaders=(train, val))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mesh = sharded.mesh
    if mesh is None or not mesh.sharded:
        raise AssertionError("the launch's mesh did not shard the trainer")
    units = sum(isinstance(m, FSDPModule) for m in sharded.model.modules())
    print(f"  sharded trainer built in {build_s:.2f} s: mesh {mesh.shape} over {mesh.n_devices} process(es), "
          f"{units} FSDP2 units, {len(sharded.trainable)} trainable tensors")
    buffers = unsharded_buffers_check(sharded.model)
    s = recorded_fit(sharded, train, val)
    for h in buffers["handles"]:
        h.remove()
    print(f"  inside the units, parameters plain, contiguous and 16-byte aligned: {buffers['seen']}")
    if len(buffers["seen"]) != 2 or not all(buffers["seen"].values()):
        raise AssertionError("an FSDP2 unit ran on parameters that are not plain, contiguous, aligned tensors")
    want = expected_fit_launches(layers, SHARDED_STEPS, 1, lora=True)
    floor, gap = grad_gap(u["grads"], floor_grads), grad_gap(s["grads"], u["grads"])
    loss_equal = s["loss"][0] == u["loss"][0]
    print(f"  (a) unsharded: brain_loss {u['loss']}, step ms {[round(x, 3) for x in u['step_ms']]}, peak device "
          f"memory {u['peak_gb']:.2f} GB; sharded (FSDP2, NCCL): brain_loss {s['loss']}, step ms "
          f"{[round(x, 3) for x in s['step_ms']]}, peak device memory {s['peak_gb']:.2f} GB, launches "
          f"{ {k: v for k, v in s['launches'].items() if v} }")
    for label, g in (("unsharded against unsharded (the floor)", floor), ("sharded against unsharded", gap)):
        print(f"  {label}: step-1 adapter gradients bit-equal {g['equal']}, |err| / |ref| {g['norm']:.3e}, "
              f"per tensor max|err| / max|ref| up to {g['tensor']:.3e}")
    print(f"  first loss bit-equal: {loss_equal}")
    if not loss_equal:
        raise AssertionError(f"the sharded first loss {s['loss'][0]!r} is not the unsharded {u['loss'][0]!r}")
    if not gap["equal"] and (gap["norm"] > TOKEN_FLOOR_RATIO * floor["norm"] or gap["norm"] > TOKEN_GRAD_TOL):
        raise AssertionError("the sharded step-1 gradients differ from the unsharded ones more than two unsharded "
                             "runs do")
    if s["launches"] != want or u["launches"] != want:
        raise AssertionError(f"the fits launched {s['launches']} and {u['launches']}, want {want}")
    rows = read_csv(sharded.csv_logger.path)
    if len([r for r in rows if r.get("val_corr_avg")]) != 1 or len([r for r in rows if r.get("train/brain_loss")]) != 2:
        raise AssertionError("the sharded metrics.csv lacks its 2 train rows or its validation row")

    print(f"  after (a): {rss_note()}")
    u_saved = saved_state(root / "unsharded", dev)
    sharded.ckpt.directory = root / "unsharded"
    into_sharded = sharded.maybe_resume() and state_equal(sharded.state(), u_saved)
    del sharded, u_saved
    torch.cuda.empty_cache()
    print(f"  after the sharded trainer's resume: {rss_note()}")
    s_saved = saved_state(root / "sharded", dev)
    unsharded, _, _ = build_trainer(config_u, device=dev, loaders=(train, val), mesh=one_device_mesh())
    unsharded.ckpt.directory = root / "sharded"
    restored = (unsharded.maybe_resume() and state_equal(unsharded.state(), s_saved), into_sharded)
    print(f"  (b) the sharded last restored by the unsharded trainer bit-equal: {restored[0]}; the unsharded "
          f"last restored by the sharded trainer bit-equal: {restored[1]}; {rss_note()}")
    if not all(restored):
        raise AssertionError("a last checkpoint did not restore bit for bit across the mesh")
    record = {"unsharded_step_ms": u["step_ms"], "sharded_step_ms": s["step_ms"],
              "unsharded_peak_gb": u["peak_gb"], "sharded_peak_gb": s["peak_gb"],
              "grad_gap": gap["norm"], "grad_floor": floor["norm"], "launches": s["launches"]}
    del unsharded, s_saved, floor_grads, u, s
    gc.collect()
    torch.cuda.empty_cache()

    config_f = compose("vlb_friends_lora", root / "fused", *SHARDED_OVERRIDES, "model.lora_fused_dropout=true")
    fused, _, _ = build_trainer(config_f, device=dev, loaders=(train, val))
    fused.model.train()
    torch.cuda.synchronize()
    reset_launches()
    out = fused.train_one(train[0])
    torch.cuda.synchronize()
    launches = read_launches()
    want = expected_train_launches(layers, 1)
    print(f"  (c) one sharded step with model.lora_fused_dropout=true: brain_loss {float(out['brain_loss'])}, "
          f"launches { {k: v for k, v in launches.items() if v} }; {rss_note()}")
    if not out["finite"] or launches != want:
        raise AssertionError(f"the fused-dropout sharded step launched {launches}, want {want}")
    record["fused_launches"] = launches
    draws = dropout_draw_ms(fused.model.cfg, dev)
    print(f"  the 32-bit path's masks a step (x 64 one layer's 7): {64 * draws['local_ms']:.3f} ms for a batch of "
          f"{LORA_BATCH} rows, {64 * draws['global2_ms']:.3f} ms as rank 0 of 2 (the global batch of "
          f"{2 * LORA_BATCH} drawn, its rows kept)")
    record.update(draw_local_ms=64 * draws["local_ms"], draw_global2_ms=64 * draws["global2_ms"])
    del fused
    torch.cuda.empty_cache()
    return record


def sharded_pair(root: Path, dev) -> dict:
    """(d): 2 ranks at datamodule.batch_size=4 (2 rows each) against one
    card at batch 4 on the same global batches and seeds; rank 0 runs the
    one-card trainer after the sharded fit."""
    rank = dist.get_rank()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    overrides = (*SHARDED_OVERRIDES, f"datamodule.batch_size={PAIR_BATCH}")
    config = compose("vlb_friends_lora", root / "pair", *overrides)
    train, val = frame_loaders(config, SHARDED_STEPS, 1, gen, dev)
    sharded, _, _ = build_trainer(config, device=dev, loaders=(train, val))
    print(f"  [rank {rank}] sharded trainer built on {dev}; {rss_note()}")
    s = recorded_fit(sharded, train, val)
    print(f"  [rank {rank}] sharded fit done: brain_loss {s['loss']}")
    del sharded
    torch.cuda.empty_cache()
    record = {"pair_step_ms": s["step_ms"], "pair_peak_gb": s["peak_gb"]}
    # Rank 0 compares while rank 1 waits at the barrier: a failure is
    # recorded, not raised, so that no rank leaves a collective unmatched.
    if rank == 0:
        one, _, _ = build_trainer(compose("vlb_friends_lora", root / "one", *overrides), device=dev,
                                  loaders=(train, val), mesh=one_device_mesh())
        u = recorded_fit(one, train, val)
        gap = grad_gap(s["grads"], u["grads"])
        loss_gap = abs(s["loss"][0] - u["loss"][0]) / abs(u["loss"][0])
        print(f"  (d) 2 ranks: brain_loss {s['loss']}, step ms {[round(x, 3) for x in s['step_ms']]}; one card at "
              f"batch {PAIR_BATCH}: brain_loss {u['loss']}, step ms {[round(x, 3) for x in u['step_ms']]}; first "
              f"loss |err| / |ref| {loss_gap:.3e} (tol {PAIR_LOSS_TOL}), step-1 adapter gradients |err| / |ref| "
              f"{gap['norm']:.3e} (tol {TOKEN_GRAD_TOL})")
        if loss_gap > PAIR_LOSS_TOL or gap["norm"] > TOKEN_GRAD_TOL:
            record["error"] = "2 ranks' step differs from one card's on the same global batch"
        record.update(one_card_step_ms=u["step_ms"], pair_grad_gap=gap["norm"], pair_loss_gap=loss_gap)
    dist.barrier()
    return record


# (e): mesh.tensor=2 on the one card. Two processes share cuda:0 and reach
# each other over gloo, which takes CUDA tensors (staged through the host);
# NCCL refuses two ranks on one device. A check of the tensor-parallel path
# on the card's kernels, not a speed of tensor parallelism.
TENSOR_OVERRIDES = ("mesh.fsdp=1", f"mesh.tensor={TENSOR}", "model.lora_fused_dropout=true",
                    "trainer.max_epochs=1", "trainer.val_check_interval=1.0", "trainer.log_every_n_steps=1")
TENSOR_STEPS = 2                          # bf16: 1 epoch of 2 steps and a validation; w8a8g8: 1 step
# (e)'s first loss against one process's on the same batches and seeds,
# |err| / |ref|: the row-parallel products' f32 partials are added over the
# 2 ranks and rounded once, so a bf16 rounding may flip (9p's bound for a
# loss after bf16 roundings moved). Under w8a8g8 it is bit-equal: fresh
# adapters add nothing and the int8 products add int32 partials. The step-1
# adapter gradients, |err| / |ref| by 2-norm over all of them, are held
# within TENSOR_FLOOR_RATIO times the gap of two one-process runs (the
# flash backward's dq reduce-adds sum in a run-dependent order), or
# TOKEN_GRAD_TOL where that is larger: under bf16 each rank's partial of
# every column-parallel dx is rounded to bf16 before the ranks' sum, where
# one card rounds the whole sum once, and these roundings move through 32
# layers. On an H100 80GB HBM3 at 700 W the bf16 gap read 4.78e-2 beside a
# floor of 1.63e-2 (2.9x), and w8a8g8's, whose int8 dx adds int32 partials,
# 6.72e-2 beside 6.72e-2.
TENSOR_LOSS_TOL, TENSOR_FLOOR_RATIO = TOKEN_LOSS_TOL, 4.0


def token_loaders(config, n_train: int, n_val: int, gen, dev) -> tuple[list, list]:
    """Train and val batches of cached video tokens made on the card from
    seed 0, as dicts of device tensors."""
    cfg = build_model_config(config.model)
    batches = synthetic_batches(cfg, n_train + n_val, int(config.datamodule.batch_size),
                                np.random.default_rng(SEED), gen, dev)
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in b.items()} for b in batches]
    return batches[:n_train], batches[n_train:]


def expected_tensor_launches(layers: int, steps: int, val_batches: int, int8: bool) -> dict[str, int]:
    """What one tensor rank launches in a fit of ``steps`` LoRA steps (fused
    u8 dropout, remat per layer) and ``val_batches`` validation batches: a
    one-card step's kernels (the rank's heads in each flash launch, the
    rank's block of each projection in each LoRA launch), and a flash
    forward a layer per validation batch. Under w8a8g8 the quants of rows
    whose columns are split run as the kernel's two passes
    (``row_absmax``, ``row_quant_given``): x of the row-parallel o (pass
    and replay) and down (the replay stops before it), and dy of the
    column-parallel five's dx (but layer 0's q, k, v, whose input needs no
    gradient); the whole-row quant keeps x of the column-parallel five
    (pass and replay) and the scaled one dy of o and down. A validation
    batch quantizes x once a projection."""
    want = expected_train_launches(layers, steps, int8=int8)
    want["flash_fwd"] += layers * val_batches
    if int8:
        split = (3 * layers + 5 * layers - 3) * steps + 2 * layers * val_batches
        want.update(row_quant=10 * layers * steps + 5 * layers * val_batches, row_quant_scaled=2 * layers * steps,
                    row_absmax=split, row_quant_given=split)
    return want


def tensor_pair(root: Path, dev) -> dict:
    """(e) in each of the 2 ranks: ``vlb_friends_lora`` with mesh.tensor=2
    (bf16, then one w8a8g8 step) through ``build_trainer`` and ``fit``;
    rank 0 then runs one process's trainer on the same batches while rank 1
    waits at the barrier. A failed check is recorded, not raised, so that
    no rank leaves a collective unmatched."""
    rank = dist.get_rank()
    record, errors = {}, []
    for key, extra, steps in (("bf16", (), TENSOR_STEPS), ("w8a8g8", ("model.base_quant=w8a8g8",), 1)):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        overrides = (*TENSOR_OVERRIDES, *extra)
        config = compose("vlb_friends_lora", root / f"tensor_{key}", *overrides)
        train, val = token_loaders(config, steps, 1, gen, dev)
        trainer, _, _ = build_trainer(config, device=dev, loaders=(train, val))
        layers = trainer.model.cfg.mistral.num_hidden_layers
        split = trainer.model.model.layers[0].self_attn.q_proj.tensor_split
        t = recorded_fit(trainer, train, val)
        want = expected_tensor_launches(layers, steps, 1, int8=key != "bf16")
        print(f"  [rank {rank}] (e) mesh.tensor={TENSOR} {key} ({split.role}-parallel q, rank {split.rank} of "
              f"{split.size}): brain_loss {t['loss']}, step ms {[round(x, 3) for x in t['step_ms']]} (gloo, host-"
              f"staged), peak device memory {t['peak_gb']:.2f} GB, launches "
              f"{ {k: v for k, v in t['launches'].items() if v} }")
        if t["launches"] != want:
            errors.append(f"(e) {key}: rank {rank} launched {t['launches']}, want {want}")
        peaks = [None] * dist.get_world_size()
        dist.all_gather_object(peaks, t["peak_gb"])
        rec = {"loss": t["loss"], "step_ms": t["step_ms"], "rank_peak_gb": peaks, "launches": t["launches"]}
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            one, _, _ = build_trainer(compose("vlb_friends_lora", root / f"one_{key}", *overrides), device=dev,
                                      loaders=(train, val), mesh=one_device_mesh())
            floor_grads = unsharded_floor(one, train[0])
            u = recorded_fit(one, train, val)
            floor, gap = grad_gap(u["grads"], floor_grads), grad_gap(t["grads"], u["grads"])
            loss_gap = abs(t["loss"][0] - u["loss"][0]) / abs(u["loss"][0])
            grad_tol = max(TOKEN_GRAD_TOL, TENSOR_FLOOR_RATIO * floor["norm"])
            print(f"  (e) {key}: one process brain_loss {u['loss']}, step ms {[round(x, 3) for x in u['step_ms']]}, "
                  f"peak device memory {u['peak_gb']:.2f} GB; first loss bit-equal {t['loss'][0] == u['loss'][0]}, "
                  f"|err| / |ref| {loss_gap:.3e} (tol {TENSOR_LOSS_TOL}); step-1 adapter gradients |err| / |ref| "
                  f"{gap['norm']:.3e} against one process's (tol {grad_tol:.3e}), beside {floor['norm']:.3e} between "
                  f"two one-process runs; per tensor max|err| / max|ref| up to {gap['tensor']:.3e} (the floor's "
                  f"{floor['tensor']:.3e})")
            if loss_gap > TENSOR_LOSS_TOL or gap["norm"] > grad_tol:
                errors.append(f"(e) {key}: the tensor={TENSOR} step differs from one process's")
            if key == "w8a8g8" and t["loss"][0] != u["loss"][0]:
                errors.append(f"(e) w8a8g8: the tensor={TENSOR} first loss is not one process's bit for bit")
            rec.update(one_loss=u["loss"], one_step_ms=u["step_ms"], one_peak_gb=u["peak_gb"], loss_gap=loss_gap,
                       loss_equal=t["loss"][0] == u["loss"][0], grad_gap=gap["norm"], grad_floor=floor["norm"])
            del one, u
            gc.collect()
            torch.cuda.empty_cache()
        record[key] = rec
        dist.barrier()
    if errors:
        record["error"] = "; ".join(errors)
    return record


# Decoder layers in the rank phases (e) and (f), at full width: their
# checks hold per layer, and 2 processes of one card over gloo stage every
# collective through the host (at 32 layers a step of (e) takes 25-30 s).
RANK_LAYERS = 8


def cut_decoder_depth(layers: int) -> None:
    """Have the builder (``build_trainer``, ``build_cached_trainer``) make
    the decoder ``layers`` deep in this process, all else as configured."""
    full = train_builder.build_model_config

    def cut(m):
        cfg = full(m)
        return dataclasses.replace(cfg, mistral=dataclasses.replace(cfg.mistral, num_hidden_layers=layers))

    train_builder.build_model_config = cut


def tensor_child(out: str) -> int:
    """``--tensor-pair DIR`` under torchrun with 2 processes: (e), both on
    cuda:0, the process group over gloo."""
    if "RANK" not in os.environ:
        raise RuntimeError("--tensor-pair runs under torch.distributed.run (torchrun)")
    torch.cuda.set_device(0)
    faulthandler.enable(sys.__stderr__)
    dist.init_process_group("gloo", init_method="env://", timeout=timedelta(seconds=SHARDED_COLLECTIVE_S))
    cut_decoder_depth(RANK_LAYERS)
    return rank_child(out, tensor_pair)


# ---------------------------------------------------------------------------
# Phase 9d (f): the two caches under torchrun (``--caches DIR``), at world 1
# over NCCL and as 2 processes of the one card over gloo. The 2 processes
# take mesh.data=2 (each rank 2 rows of each batch of 4, the model
# replicated: HSDP, whose collectives are the rows' gathers and the
# gradients' all-reduce; as in (e), gloo carries CUDA tensors through the
# host).

CACHE_BATCH = 4
# Train and val batches each cache is built over (and the head and LoRA
# fits run over): the fewest that give a step and a validation. Each rank
# is a process whose host RSS is held to HOST_RSS_LIMIT_GB, and an NCCL
# rank starts near 7 GB; every further batch keeps its frames (in the
# lazy-load stores, 65 MB a batch), its features (41 MB) and its tokens
# (39 MB) on the host, in the ranks' copy and in one process's.
CACHE_BATCHES = (1, 1)
CACHE_OVERRIDES = ("trainer.max_epochs=1", "trainer.val_check_interval=1.0", "trainer.log_every_n_steps=1",
                   f"datamodule.batch_size={CACHE_BATCH}")
# The fits over the ranks' caches against one process's at the same global
# batch of 4: the first loss as |err| / |ref| within TOKEN_LOSS_TOL and the
# step-1 gradients by 2-norm within TOKEN_GRAD_TOL (the head's; the
# adapters' as (e) holds them). A rank's backbone runs on its 2 rows where
# one process's runs on 4, so cuBLAS may take other kernels and bf16
# roundings move through the layers (as in (d), PAIR_LOSS_TOL): the caches
# are held bit for bit against one process's build over the same rows a
# forward (the rank's), and their gap to the build over 4 is printed.


def cache_mesh_overrides(world: int) -> tuple:
    return ("mesh.fsdp=-1",) if world == 1 else ("mesh.data=2", "mesh.fsdp=1")


def lazy_store(batches: list) -> MemoryStore:
    """A lazy-load store (the layout ``LazyDataset`` reads, as
    ``build_lazyload_dsets`` writes it) of the real rows of ``batches``
    (dicts of device tensors), on the host."""
    store, i = MemoryStore(), 0
    for batch in batches:
        host = {k: v.cpu().numpy() for k, v in batch.items()}
        for r in np.flatnonzero(host["row_mask"] > 0):
            group = store.create_group(f"{i}")
            for field in LazySample.FIELDS:
                group.create_dataset(f"{i}_{field}", data=host[field][r])
            i += 1
    store.create_dataset("dset_len", data=[i])
    return store


def split_rows(batches: list, n: int) -> list:
    """Each batch (a dict of tensors) cut into batches of ``n`` rows, in order."""
    return [{k: v[i:i + n] for k, v in b.items()} for b in batches for i in range(0, len(b["row_mask"]), n)]


def value_gap(pairs, dev, bits: bool = False) -> dict:
    """``(got, want)`` array pairs on the card: |got - want| / |want| by
    2-norm over all of them, and the fraction of values that differ;
    ``bits``: uint16 arrays of bf16 bit patterns."""
    num = den = moved = total = 0.0
    for got, want in pairs:
        g, w = (torch.from_numpy(np.ascontiguousarray(x).view(np.int16) if bits else np.ascontiguousarray(x)).to(dev)
                for x in (got, want))
        g, w = (x.view(torch.bfloat16).float() if bits else x.float() for x in (g, w))
        num += float((g - w).square().sum())
        den += float(w.square().sum())
        moved += float((g != w).sum())
        total += w.numel()
    return {"rel": (num / max(den, 1e-30)) ** 0.5, "moved": moved / max(total, 1.0)}


def feature_store_gap(got: MemoryStore, want: MemoryStore, dev) -> dict:
    """A feature cache against another: the sample counts, the features'
    :func:`value_gap`, and the weights and targets bit for bit."""
    n = int(want["dset_len"][0])
    if int(got["dset_len"][0]) != n:
        return {"n": int(got["dset_len"][0]), "want_n": n, "rel": float("inf"), "moved": 1.0, "others_equal": False}
    gap = value_gap(((got[f"{i}"][f"{i}_features"], want[f"{i}"][f"{i}_features"]) for i in range(n)), dev)
    others = all(np.asarray(got[f"{i}"][f"{i}_{f}"]).tobytes() == np.asarray(want[f"{i}"][f"{i}_{f}"]).tobytes()
                 for i in range(n) for f in ("weights", "timeseries"))
    return {"n": n, **gap, "others_equal": others}


def store_digest(store) -> str:
    """A sha256 of a store's arrays (names and bytes), to compare ranks'."""
    h = hashlib.sha256()

    def walk(node, prefix):
        for key in sorted(node):
            value = node[key]
            if isinstance(value, dict):
                walk(value, f"{prefix}{key}/")
            else:
                h.update(f"{prefix}{key}".encode())
                h.update(value.encode() if isinstance(value, str) else np.ascontiguousarray(value).tobytes())

    walk(store, "")
    return h.hexdigest()[:16]


def caches_on_ranks(root: Path, dev) -> dict:
    """(f) in each rank of the launch: (f1) ``vlb_friends_baseline
    model.cache_features=true`` through ``build_cached_trainer`` into
    in-memory stores (flash launches of the build: each rank runs every
    batch on its rows) and the head's fit over them; (f2) ``vlb_friends_lora
    datamodule.vision_token_cache`` through ``build_trainer`` over native
    loaders of lazy-load stores, into an in-memory sidecar store, and a LoRA
    fit from its tokens. Rank 0 then builds and fits each in one process on
    the same batches while the others wait at the barrier. A failed check
    is recorded, not raised, so that no rank leaves a collective unmatched."""
    rank, world = dist.get_rank(), dist.get_world_size()
    overrides = (*CACHE_OVERRIDES, *cache_mesh_overrides(world))
    n_train, n_val = CACHE_BATCHES
    local = CACHE_BATCH // world                        # a rank's rows of each batch
    record, errors = {"world": world}, []
    head_keys = lambda k: k.startswith("head.")            # noqa: E731

    # (f1) the feature cache and the head over it.
    gen = torch.Generator(device=dev).manual_seed(SEED)
    config = compose("vlb_friends_baseline", root / f"cached_{world}", "model.cache_features=true", *overrides)
    layers = train_builder.build_model_config(config.model).mistral.num_hidden_layers
    train, val = frame_loaders(config, n_train, n_val, gen, dev)
    stores = {"train": MemoryStore(), "val": MemoryStore()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer, cached_train, cached_val = build_cached_trainer(config, dev, loaders=(train, val), caches=stores)
    torch.cuda.synchronize()
    build_s, build_launches = time.perf_counter() - t0, read_launches()
    build_peak = torch.cuda.max_memory_allocated() / 1e9
    want = {n: layers * (n_train + n_val) if n == "flash_fwd" else 0 for n in KERNELS}
    if build_launches != want:
        errors.append(f"(f1) rank {rank}: the feature-cache build launched {build_launches}, want {want}")
    h = recorded_fit(trainer, cached_train, cached_val, keep=head_keys)
    if any(h["launches"].values()):
        errors.append(f"(f1) rank {rank}: the head's fit launched {h['launches']}")
    digests = [None] * world
    dist.all_gather_object(digests, [store_digest(stores["train"]), store_digest(stores["val"])])
    peaks = [None] * world
    dist.all_gather_object(peaks, [build_peak, h["peak_gb"]])
    print(f"  [rank {rank}] (f1) feature cache built in {build_s:.2f} s ({stores['train']['dset_len'][0]} + "
          f"{stores['val']['dset_len'][0]} samples, {n_train} + {n_val} batches of {CACHE_BATCH}, {local} rows of each "
          f"here), launches { {k: v for k, v in build_launches.items() if v} }, peak device memory {build_peak:.2f} "
          f"GB; head fit brain_loss {h['loss']}, step ms {[round(x, 3) for x in h['step_ms']]}; {rss_note()}")
    if len(set(map(tuple, digests))) != 1:
        errors.append(f"(f1) the ranks' stores differ: {digests}")
    rec = {"build_s": build_s, "build_launches": build_launches, "loss": h["loss"], "step_ms": h["step_ms"],
           "rank_peak_gb": peaks}
    del trainer, cached_train, cached_val
    gc.collect()
    torch.cuda.empty_cache()
    release_host_memory(collect=True)
    if rank == 0:
        # One process over batches of 4, and (where a rank holds fewer rows)
        # over the same rows a forward as a rank.
        one_stores = {"train": MemoryStore(), "val": MemoryStore()}
        one, ot, ov = build_cached_trainer(compose("vlb_friends_baseline", root / "cached_one",
                                                   "model.cache_features=true", *overrides), dev,
                                           loaders=(train, val), caches=one_stores, mesh=one_device_mesh())
        u = recorded_fit(one, ot, ov, keep=head_keys)
        same = one_stores
        if local < CACHE_BATCH:
            model = build_model(config.model, int(config.random_state), dev)
            same = {split: MemoryStore() for split in stores}
            for split, batches in (("train", train), ("val", val)):
                build_feature_cache(model, split_rows(batches, local), same[split])
            del model
            gc.collect()
            torch.cuda.empty_cache()
        equal = all(store_digest(stores[k]) == store_digest(same[k]) for k in stores)
        del same
        gaps = {split: feature_store_gap(stores[split], one_stores[split], dev) for split in stores}
        loss_gap = abs(h["loss"][0] - u["loss"][0]) / abs(u["loss"][0])
        grad = grad_gap(h["grads"], u["grads"])
        print(f"  (f1) the ranks' caches bit-equal to one process's built {local} rows a forward: {equal}; against "
              f"one process's built 4 a forward: {gaps}; head first loss bit-equal {h['loss'][0] == u['loss'][0]} "
              f"(|err| / |ref| {loss_gap:.3e}, tol {TOKEN_LOSS_TOL}), step-1 head gradients |err| / |ref| "
              f"{grad['norm']:.3e} (tol {TOKEN_GRAD_TOL}), bit-equal {grad['equal']}; one process's head step ms "
              f"{[round(x, 3) for x in u['step_ms']]}; {rss_note()}")
        if not equal or not all(g["others_equal"] for g in gaps.values()):
            errors.append(f"(f1) the ranks' feature cache differs from one process's: equal {equal}, {gaps}")
        if loss_gap > TOKEN_LOSS_TOL or grad["norm"] > TOKEN_GRAD_TOL:
            errors.append("(f1) the head's fit over the ranks' cache differs from one process's")
        rec.update(same_rows_equal=equal, store_gap=gaps, loss_gap=loss_gap, grad_gap=grad["norm"],
                   one_loss=u["loss"], one_step_ms=u["step_ms"])
        del one, ot, ov, u, one_stores
        gc.collect()
        torch.cuda.empty_cache()
        release_host_memory(collect=True)
    record["feature_cache"] = rec
    del stores, train, val
    release_host_memory(collect=True)
    dist.barrier()

    # (f2) the vision-token cache and a LoRA fit from it.
    gen = torch.Generator(device=dev).manual_seed(SEED)
    config = compose("vlb_friends_lora", root / f"tokens_{world}", "datamodule.vision_token_cache=memory",
                     *overrides)
    batches = frame_loaders(config, n_train, n_val, gen, dev)
    lazy = [lazy_store(b) for b in batches]
    del batches
    release_host_memory(collect=True)

    def loaders():
        return tuple(BatchLoader(LazyDataset([store]), CACHE_BATCH, shuffle=False, prefetch=0) for store in lazy)

    tokens = MemoryStore()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer, train, val = build_trainer(config, device=dev, loaders=loaders(), token_cache=tokens)
    torch.cuda.synchronize()
    build_s, build_launches = time.perf_counter() - t0, read_launches()
    if any(build_launches.values()):
        errors.append(f"(f2) rank {rank}: the token-cache build launched {build_launches}")
    t = recorded_fit(trainer, train, val)
    want = expected_fit_launches(layers, n_train, n_val, lora=True)
    if t["launches"] != want:
        errors.append(f"(f2) rank {rank}: the LoRA fit launched {t['launches']}, want {want}")
    digests, peaks = [None] * world, [None] * world
    dist.all_gather_object(digests, store_digest(tokens))
    dist.all_gather_object(peaks, t["peak_gb"])
    print(f"  [rank {rank}] (f2) token cache and the trainer built in {build_s:.2f} s ({len(tokens)} sidecars, "
          f"{sum(tokens[k]['tokens'].nbytes for k in tokens) / 1e6:.1f} MB), LoRA fit brain_loss {t['loss']}, step ms "
          f"{[round(x, 3) for x in t['step_ms']]}, peak device memory {t['peak_gb']:.2f} GB, launches "
          f"{ {k: v for k, v in t['launches'].items() if v} }; {rss_note()}")
    if len(set(digests)) != 1:
        errors.append(f"(f2) the ranks' sidecars differ: {digests}")
    rec = {"build_s": build_s, "loss": t["loss"], "step_ms": t["step_ms"], "rank_peak_gb": peaks,
           "launches": t["launches"]}
    del trainer, train, val
    gc.collect()
    torch.cuda.empty_cache()
    release_host_memory(collect=True)
    if rank == 0:
        one_tokens = MemoryStore()
        one, ot, ov = build_trainer(compose("vlb_friends_lora", root / "tokens_one",
                                            "datamodule.vision_token_cache=memory", *overrides), device=dev,
                                    loaders=loaders(), mesh=one_device_mesh(), token_cache=one_tokens)
        # The same clips through one process's towers at the rank's rows a forward.
        equal, tok = tokens.keys() == one_tokens.keys(), {}
        for loader in (ot, ov):
            base = loader.dataset.base
            name = f"vision_tokens_{dataset_fingerprint(base, 0, 0)[:8]}"
            same = one_tokens[name]["tokens"]
            if local < CACHE_BATCH:
                same = np.empty_like(same)
                encode_tokens(one.model, base, same, batch_size=local)
            equal = equal and np.array_equal(tokens[name]["tokens"], same)
            tok[name] = {"fingerprint_equal": tokens[name]["fingerprint"] == one_tokens[name]["fingerprint"],
                         **value_gap(zip(tokens[name]["tokens"], one_tokens[name]["tokens"]), dev, bits=True)}
            del same
        floor_grads = unsharded_floor(one, batch_fields(next(iter(ot))))
        u = recorded_fit(one, ot, ov)
        floor, gap = grad_gap(u["grads"], floor_grads), grad_gap(t["grads"], u["grads"])
        loss_gap = abs(t["loss"][0] - u["loss"][0]) / abs(u["loss"][0])
        grad_tol = max(TOKEN_GRAD_TOL, TENSOR_FLOOR_RATIO * floor["norm"])
        print(f"  (f2) the ranks' sidecars bit-equal to one process's tokens at {local} clips a forward: {equal}; "
              f"against one process's at 4: {tok}; first loss bit-equal {t['loss'][0] == u['loss'][0]} (|err| / "
              f"|ref| {loss_gap:.3e}, tol {TOKEN_LOSS_TOL}); step-1 adapter gradients |err| / |ref| {gap['norm']:.3e} "
              f"(tol {grad_tol:.3e}) beside {floor['norm']:.3e} between two one-process runs; one process's step ms "
              f"{[round(x, 3) for x in u['step_ms']]}; {rss_note()}")
        if not equal or not all(g["fingerprint_equal"] for g in tok.values()):
            errors.append(f"(f2) the ranks' sidecars differ from one process's: equal {equal}, {tok}")
        if loss_gap > TOKEN_LOSS_TOL or gap["norm"] > grad_tol:
            errors.append("(f2) the LoRA fit from the ranks' tokens differs from one process's")
        rec.update(same_rows_equal=equal, token_gap=tok, loss_gap=loss_gap, grad_gap=gap["norm"],
                   grad_floor=floor["norm"], one_loss=u["loss"], one_step_ms=u["step_ms"])
        del one, ot, ov, u
        gc.collect()
        torch.cuda.empty_cache()
        release_host_memory(collect=True)
    record["token_cache"] = rec
    dist.barrier()
    if errors:
        record["error"] = "; ".join(errors)
    return record


def caches_child(out: str) -> int:
    """``--caches DIR`` under torchrun: (f), at world 1 over NCCL, or on 2
    processes that share card 0 over gloo."""
    if "RANK" not in os.environ:
        raise RuntimeError("--caches runs under torch.distributed.run (torchrun)")
    if int(os.environ["WORLD_SIZE"]) == 1:
        if not maybe_initialize_distributed("cuda", timeout_s=SHARDED_COLLECTIVE_S):
            raise RuntimeError("--caches could not join its group")
    else:
        torch.cuda.set_device(0)
        faulthandler.enable(sys.__stderr__)
        dist.init_process_group("gloo", init_method="env://", timeout=timedelta(seconds=SHARDED_COLLECTIVE_S))
    cut_decoder_depth(RANK_LAYERS)
    return rank_child(out, caches_on_ranks)


def sharded_child(out: str, pair: bool) -> int:
    """``--sharded DIR`` (or ``--sharded-pair DIR``) under torchrun: this
    rank's part of phase 9d over NCCL."""
    if not maybe_initialize_distributed("cuda", timeout_s=SHARDED_COLLECTIVE_S):
        raise RuntimeError("--sharded runs under torch.distributed.run (torchrun)")
    return rank_child(out, sharded_pair if pair else sharded_lora)


def rank_child(out: str, body) -> int:
    """A rank of phase 9d in its group: ``body(root, device)``; rank 0
    prints one JSON line of its numbers, every rank's peak host RSS among
    them, last."""
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(out)
    rank = dist.get_rank()
    # Where each thread stands, dumped before the launcher is killed, should
    # the rank stall outside a collective (inside one, the watchdog ends it).
    stacks = open(root / f"stacks.rank{rank}.txt", "w")
    faulthandler.dump_traceback_later(SHARDED_LIMIT_S - 60, file=stacks)
    # On an error the process exits with its group as it stands: leaving a
    # group while a peer waits in a collective can block.
    record = body(root, dev)
    rss = [None] * dist.get_world_size()
    dist.all_gather_object(rss, peak_rss_gb())
    shutdown_distributed()
    faulthandler.cancel_dump_traceback_later()
    record["peak_rss_gb"] = max(rss)
    record["rank_peak_rss_gb"] = rss
    if rank == 0:
        print(json.dumps(record))
    if "error" in record:
        raise AssertionError(record["error"])
    if max(rss) > HOST_RSS_LIMIT_GB:
        raise AssertionError(f"a rank's peak host RSS ({rss} GB) is over {HOST_RSS_LIMIT_GB}")
    return 0


# ---------------------------------------------------------------------------
# Phase 9j: a run of the JAX trainer resumed on the card (``--from-jax DIR``).
# A JAX TrainState's raw tree (what scripts/orbax_to_torch.py restores from
# Orbax: flax layouts, the decoder stacked in ``layers_scan``, frozen leaves
# None) is made at full width from a numpy seed, converted by
# train/from_jax.py (the card's machine has no orbax: a restore that hands
# over that tree stands in for Orbax's reader), and vlb-train-torch's
# trainer resumes from the converted root.

FROM_JAX_STEP = 5                          # the JAX run's applied updates
# (site, projection) -> (input, output) width of Mistral-7B's projections.
PROJ_WIDTHS = {("self_attn", "q_proj"): (4096, 4096), ("self_attn", "k_proj"): (4096, 1024),
               ("self_attn", "v_proj"): (4096, 1024), ("self_attn", "o_proj"): (4096, 4096),
               ("mlp", "gate_proj"): (4096, 14336), ("mlp", "up_proj"): (4096, 14336),
               ("mlp", "down_proj"): (14336, 4096)}
FROM_JAX_OVERRIDES = ("trainer.max_epochs=1", "model.lora_fused_dropout=true", "trainer.resume=true")


def jax_trainable_tree(layers: int, rank: int, hidden: int, targets: int, rng: np.random.Generator,
                       kind: str) -> dict:
    """The JAX trainer's trainable subtree at full width in flax layouts:
    ``model/layers_scan/<site>/<proj>/lora_a`` (L, in, r) and ``lora_b``
    (L, r, out), the base kernels and norms None; the head's LayerNorm
    ``scale``/``bias`` and the ridge ``kernel`` (in, out). ``kind``: the
    parameters, or AdamW's first or second moments (non-negative)."""
    def draw(shape, scale):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return np.abs(a) if kind == "nu" else a

    big, small = {"param": (1.0, 0.01), "mu": (1e-4, 1e-4), "nu": (1e-8, 1e-8)}[kind]
    scan: dict = {"input_layernorm": {"weight": None}, "post_attention_layernorm": {"weight": None}}
    for (site, proj), (n_in, n_out) in PROJ_WIDTHS.items():
        scan.setdefault(site, {})[proj] = {
            "kernel": None, "lora_a": draw((layers, n_in, rank), big / np.sqrt(n_in)),
            "lora_b": draw((layers, rank, n_out), small)}
    head = {f"layer_norm{i}": {"scale": (1.0 + draw((hidden,), 0.1)) if kind == "param" else draw((hidden,), big),
                               "bias": draw((hidden,), small)} for i in (1, 2)}
    head["ridge"] = {"linear": {"kernel": draw((hidden, targets), big / np.sqrt(hidden)),
                                "bias": draw((targets,), small)}}
    return {"model": {"embed_tokens": {"embedding": None}, "layers_scan": scan, "norm": {"weight": None}},
            "head": head}


def port_layout(tree: dict, layers: int) -> dict[str, np.ndarray]:
    """``tree``'s arrays by the port's names, laid out by hand: layer l of a
    stacked factor as it is, the ridge kernel transposed, LayerNorm
    ``scale`` as ``weight``."""
    out = {}
    for (site, proj) in PROJ_WIDTHS:
        for f in ("lora_a", "lora_b"):
            stacked = tree["model"]["layers_scan"][site][proj][f]
            for layer in range(layers):
                out[f"model.layers.{layer}.{site}.{proj}.{f}"] = stacked[layer]
    for i in (1, 2):
        ln = tree["head"][f"layer_norm{i}"]
        out[f"head.layer_norm{i}.weight"], out[f"head.layer_norm{i}.bias"] = ln["scale"], ln["bias"]
    ridge = tree["head"]["ridge"]["linear"]
    out["head.ridge.linear.weight"], out["head.ridge.linear.bias"] = ridge["kernel"].T, ridge["bias"]
    return out


def direct_trainer(model, trainer, tensors: dict, dev) -> VLBTrainer:
    """A trainer over ``model`` handed ``tensors`` ("param", "mu", "nu" by
    name) straight, through ``load_params`` and ``load_state_dict``."""
    direct = VLBTrainer(model, trainer.optimizer.config,
                        TrainLoopConfig(seed=trainer.config.seed, checkpoint=False, num_target=trainer.config.num_target),
                        device=dev, csv_logger=NullMetricsLogger())
    names = list(direct.trainable)
    direct.load_params({n: tensors["param"][n] for n in names})
    state = {i: {"step": torch.tensor(float(FROM_JAX_STEP)), "exp_avg": tensors["mu"][n].clone(),
                 "exp_avg_sq": tensors["nu"][n].clone()}
             for i, n in enumerate(names)}
    direct.optimizer.load_state_dict({"step": FROM_JAX_STEP, "adamw": {
        "state": state, "param_groups": direct.optimizer.adamw.state_dict()["param_groups"]}})
    direct.global_step = FROM_JAX_STEP
    return direct


def from_jax_child(out: str) -> int:
    """``--from-jax DIR``: phase 9j in this process, under DIR; prints one
    JSON line of its numbers last."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(out)
    card = card_name_and_power()
    cfg = VLBConfig.full(use_lora=True)
    layers, rank = cfg.mistral.num_hidden_layers, cfg.mistral.lora.rank
    hidden, targets = cfg.mistral.hidden_size, cfg.num_target
    with phase("9j (a) a JAX TrainState at full width from a numpy seed, converted"):
        rng = np.random.default_rng(SEED)
        trees = {kind: jax_trainable_tree(layers, rank, hidden, targets, rng, kind) for kind in ("param", "mu", "nu")}
        count = np.asarray(FROM_JAX_STEP, np.int32)
        # optax's chain(clip_by_global_norm, adamw) restored raw: the clip's
        # and the weight decay's empty states None, Adam's and the schedule's.
        state = {"step": count, "params": trees["param"],
                 "opt_state": [None, [{"count": count, "mu": trees["mu"], "nu": trees["nu"]}, None,
                                      {"count": count}]]}
        jax_root = root / "jax"
        (jax_root / "last").mkdir(parents=True)
        (jax_root / "last" / "_METADATA").write_text("{}")       # an Orbax directory's marker
        meta = {"es_best": float("inf"), "es_strikes": 0, "best_metric": 1.25, "best_path": "",
                "epoch": 0, "global_step": FROM_JAX_STEP}
        (jax_root / "trainer_state.json").write_text(json.dumps(meta))
        n_leaves = sum(1 for kind in trees.values() for _ in _leaves(kind))
        report, kinds = convert_from_jax(jax_root, root / "port", lambda path: state)
        print(f"  {n_leaves} leaves ({sum(a.nbytes for t in trees.values() for a in _leaves(t)) / 1e6:.1f} MB "
              f"f32: {layers} layers' rank-{rank} adapters on 7 projections and the head, with mu and nu); "
              f"kinds {kinds}; converted in {report.seconds:.3f} s: {len(report.files)} files, {report.bytes} "
              f"bytes ({card})")
        # The tree laid out by hand, kept on the card; the host's copies go.
        want = {kind: {n: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for n, a in port_layout(trees[kind], layers).items()} for kind in trees}
        del trees, state
    with phase("9j (b) vlb-train-torch's trainer resumed from the converted root"):
        config = compose("vlb_friends_lora", root / "port", *FROM_JAX_OVERRIDES)
        train, val = frame_loaders(config, 1, 1, gen, dev)
        trainer, train, val = build_trainer(config, device=dev, loaders=(train, val))
        if not trainer.maybe_resume():
            raise AssertionError("the converted root did not resume")
        opt = trainer.optimizer.state_dict()
        names = list(trainer.trainable)
        if set(names) != set(want["param"]):
            raise AssertionError(f"trainable {sorted(set(names) ^ set(want['param']))[:8]} differ")
        bit_equal = all(torch.equal(trainer.trainable[n], want["param"][n])
                        and torch.equal(opt["adamw"]["state"][i]["exp_avg"], want["mu"][n])
                        and torch.equal(opt["adamw"]["state"][i]["exp_avg_sq"], want["nu"][n])
                        for i, n in enumerate(names))
        steps = {float(s["step"]) for s in opt["adamw"]["state"].values()}
        del opt
        ocfg = trainer.optimizer.config
        lr = learning_rate(ocfg, trainer.optimizer.step)
        lr_want = ocfg.lr * (1.0 + math.cos(math.pi * FROM_JAX_STEP / ocfg.t_max)) / 2.0
        print(f"  resumed at step {trainer.global_step} (schedule {trainer.optimizer.step}, AdamW's per-tensor "
              f"steps {sorted(steps)}), lr {lr!r} against the schedule's {lr_want!r}; {len(names)} tensors and "
              f"both moments bit-equal to the tree after layout: {bit_equal}; best metric "
              f"{trainer.ckpt.best_metric} carried")
        if not (bit_equal and trainer.global_step == trainer.optimizer.step == FROM_JAX_STEP
                and steps == {float(FROM_JAX_STEP)} and lr == lr_want and trainer.ckpt.best_metric == 1.25):
            raise AssertionError("the resumed state is not the JAX state")
    with phase("9j (c) one LoRA step from frames, one val batch served"):
        trainer.model.train()                  # as fit sets it: the adapters' dropout on
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        first = trainer.train_one(train[0])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        updated = {n: p.detach().clone() for n, p in trainer.trainable.items()}
        launches = read_launches()
        want_launches = expected_train_launches(layers, 1)
        if launches != want_launches:
            raise AssertionError(f"the resumed step launched {launches}, want {want_launches}")
        reset_launches()
        served = predict_batches(trainer.model.eval(), val, dev)
        serve_launches = read_launches()
        check_predictions(served, LORA_BATCH, targets)
        if serve_launches["flash_fwd"] != layers or sum(serve_launches.values()) != layers:
            raise AssertionError(f"the served batch launched {serve_launches}")
        loss, norm = float(first["brain_loss"]), float(first["grad_norm"])
        print(f"  step {trainer.optimizer.step}: brain_loss {loss!r}, grad norm {norm!r}, {step_ms:.1f} ms, "
              f"launches { {k: v for k, v in launches.items() if v} }, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; one val batch served ({serve_launches['flash_fwd']} "
              f"flash_fwd) ({card})")
    with phase(f"9j (d) the same step from the same tensors handed over directly ({FROM_JAX_DIRECT_RUNS} times: "
               f"the floor)"):
        t_direct = time.perf_counter()
        direct = []
        for _ in range(FROM_JAX_DIRECT_RUNS):
            d = direct_trainer(trainer.model.train(), trainer, want, dev)
            out = d.train_one(train[0])
            direct.append((float(out["brain_loss"]), float(out["grad_norm"]),
                           {n: p.detach().clone() for n, p in d.trainable.items()}))
            del d
        direct_s = time.perf_counter() - t_direct
        losses, norms, upds = zip(*direct)

        def apart(x: dict, y: dict) -> float:
            return float(torch.stack([(x[n] - y[n]).float().square().sum() for n in x]).sum().sqrt())

        gap, floor = abs(norm - norms[0]), abs(norms[0] - norms[1])
        pair_gaps = [apart(upds[i], upds[j]) for i in range(len(upds)) for j in range(i + 1, len(upds))]
        upd_gaps = [apart(updated, u) for u in upds]
        upd_floor, upd_gap = max(pair_gaps), max(upd_gaps)
        upd_size = apart(upds[0], want["param"])
        loss_equal = all(x == loss for x in losses)
        print(f"  first loss bit-equal to the {len(losses)} direct trainers': {loss_equal} ({loss!r}, "
              f"{losses!r}); grad norm {norm!r} against {norms[0]!r} (bit-equal {gap == 0.0}; the first two direct "
              f"runs {floor:.3e} apart: dq's reduce-adds sum in a run-dependent order); the updated tensors "
              f"{', '.join(f'{g:.3e}' for g in upd_gaps)} from each direct trainer's by 2-norm, the direct runs' "
              f"{len(pair_gaps)} pairs {min(pair_gaps):.3e} to {upd_floor:.3e} apart (the floor: their largest; the "
              f"widest gap {upd_gap / max(upd_floor, 1e-30):.2f}x it, held within {FROM_JAX_UPDATE_FLOOR_RATIO}x; "
              f"the update itself {upd_size:.3e}); the {FROM_JAX_DIRECT_RUNS} direct runs took {direct_s:.1f} s")
        if not loss_equal:
            raise AssertionError("the converted state's first loss differs from the directly loaded one's")
        if gap > FROM_JAX_NORM_TOL * norms[0]:
            raise AssertionError(f"grad norm {gap:.3e} from the direct trainer's, over {FROM_JAX_NORM_TOL} relative")
        if upd_gap > FROM_JAX_UPDATE_FLOOR_RATIO * upd_floor:
            raise AssertionError(f"the update {upd_gap:.3e} from a direct trainer's, over "
                                 f"{FROM_JAX_UPDATE_FLOOR_RATIO} x the floor {upd_floor:.3e}")
        del direct, upds
    record = {"convert_s": report.seconds, "convert_bytes": report.bytes, "step_ms": step_ms,
              "loss": loss, "grad_norm": norm, "grad_norm_gap": gap, "grad_norm_floor": floor,
              "update_gap": upd_gap, "update_gaps": upd_gaps, "update_floor": upd_floor,
              "update_pair_gaps": pair_gaps, "update_size": upd_size, "direct_runs": FROM_JAX_DIRECT_RUNS,
              "direct_s": direct_s, "peak_rss_gb": peak_rss_gb()}
    print(json.dumps(record))
    if record["peak_rss_gb"] > HOST_RSS_LIMIT_GB:
        raise AssertionError(f"9j's peak host RSS {record['peak_rss_gb']:.2f} GB is over {HOST_RSS_LIMIT_GB}")
    return 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif v is not None:
            yield v


# ---------------------------------------------------------------------------
# Phase 9w: full-width weights in HF layout on the card (``--full-width
# DIR``): a random 4-layer Mistral-7B with the CLIP tower and the STC in
# VideoLLaMA2's key layout, written by the port's safetensors writer, loaded
# through load_pretrained_params in bf16 (the hand kernels) and in f32 (the
# plain attention, TF32 off), both on the card, and served one batch from
# frames at S = 2048.

FULL_WIDTH_LAYERS = 4
FULL_WIDTH_BATCH = 2


def hf_shards(out: Path, cfg: VLBConfig, gen, dev) -> tuple[int, int]:
    """The model's frozen weights under VideoLLaMA2's HF keys, made on the
    card from ``gen``, a shard each decoder layer and one each for the rest,
    the tower's and the connector's; with what a real checkpoint holds and
    the feature path never reads (``lm_head``, the tower's last layer and
    ``post_layernorm``). Returns (tensors, bytes)."""
    sd = init_params(cfg, dev, gen)
    hf = {hf_key(k): t for k, t in sd.items() if hf_key(k) is not None}
    del sd
    h, vision = cfg.mistral.hidden_size, "model.vision_tower.vision_tower.vision_model."
    extra = {"lm_head.weight": torch.randn(cfg.mistral.vocab_size, h, generator=gen, device=dev,
                                           dtype=torch.bfloat16).mul_(0.02),
             vision + "post_layernorm.weight": torch.ones(cfg.clip.hidden_size, device=dev),
             vision + "post_layernorm.bias": torch.zeros(cfg.clip.hidden_size, device=dev)}
    last = f"{vision}encoder.layers.{cfg.clip.effective_layers - 1}."
    extra.update({f"{vision}encoder.layers.{cfg.clip.effective_layers}." + k[len(last):]: t.clone()
                  for k, t in hf.items() if k.startswith(last)})
    hf.update(extra)
    groups: dict[str, dict] = {}
    for k, t in hf.items():
        name = (f"model-layer-{int(k.split('.')[2]):05d}" if k.startswith("model.layers.")
                else "vision" if k.startswith(vision) else "stc" if k.startswith("model.mm_projector.")
                else "model-top")
        groups.setdefault(name, {})[k] = t
    out.mkdir(parents=True)
    size = sum(write_safetensors(out / f"{name}.safetensors", tensors) for name, tensors in groups.items())
    return len(hf), size


def layer_outputs(model):
    """Forward hooks on each decoder layer and the final norm: their outputs
    (f32 copies) in order, appended to the returned list."""
    outs, handles = [], []
    for module in [*model.model.layers, model.model.norm]:
        handles.append(module.register_forward_hook(lambda m, a, o: outs.append(o.float().clone())))
    return outs, handles


def rel_norm(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def full_width_child(out: str) -> int:
    """``--full-width DIR``: phase 9w in this process, under DIR; prints one
    JSON line of its numbers last."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(out)
    card = card_name_and_power()
    cut_decoder_depth(FULL_WIDTH_LAYERS)
    config = compose("vlb_friends_baseline", root / "run", f"model.checkpoint_path={root / 'hf'}")
    cfg = train_builder.build_model_config(config.model)              # the cut depth
    with phase(f"9w (a) a random {FULL_WIDTH_LAYERS}-layer full-width checkpoint in HF layout, written"):
        t0 = time.perf_counter()
        n, size = hf_shards(root / "hf", cfg, gen, dev)
        write_s = time.perf_counter() - t0
        print(f"  {n} tensors, {size / 1e9:.3f} GB bf16 in {len(list((root / 'hf').iterdir()))} shards, written in "
              f"{write_s:.2f} s by the port's writer ({card})")
        torch.cuda.empty_cache()
    with phase("9w (b) loaded through load_pretrained_params in bf16"):
        t0 = time.perf_counter()
        model = build_model(config.model, SEED + 1, dev)       # other random weights under the checkpoint's
        load_s = time.perf_counter() - t0
    with phase("9w (c) the same shards in f32"):
        f32 = VLBConfig.full(mistral=dataclasses.replace(cfg.mistral, dtype=torch.float32),
                             clip=dataclasses.replace(cfg.clip, dtype=torch.float32),
                             stc=dataclasses.replace(cfg.stc, dtype=torch.float32))
        params = {k: t.float() for k, t in model.state_dict().items()}
        reference = VideoLLaMA2VLB.from_state_dict(f32, load_pretrained_params(f32, root / "hf", params))
        del params
    with phase("9w (d) one batch from frames at S = 2048 through each"):
        batch = synthetic_batches(cfg, 1, FULL_WIDTH_BATCH, np.random.default_rng(SEED), gen, dev, frames=True)
        outs, handles = layer_outputs(model)
        reset_launches()
        got = predict_batches(model, batch, dev)
        launches = read_launches()
        for hnd in handles:
            hnd.remove()
        want_outs, handles = layer_outputs(reference)
        reset_launches()
        with plain_attention():
            want = predict_batches(reference, batch, dev)
        plain_launches = read_launches()
        for hnd in handles:
            hnd.remove()
        if launches["flash_fwd"] != FULL_WIDTH_LAYERS or sum(launches.values()) != FULL_WIDTH_LAYERS \
                or sum(plain_launches.values()):
            raise AssertionError(f"bf16 launched {launches}, f32 {plain_launches}")
        video = batch[0]["vision"]
        tokens_err = rel_norm(model.encode_video(video), reference.encode_video(video))
        errs = [rel_norm(g, w) for g, w in zip(outs, want_outs)]
        pred_err = rel_norm(torch.from_numpy(got["predicted"]), torch.from_numpy(want["predicted"]))
        print(f"  loaded in {load_s:.2f} s (bf16); bf16 hand-kernel forward against the f32 plain forward of the "
              f"same shards (TF32 off), |err| / |ref| by 2-norm: video tokens {tokens_err:.3e}; decoder layers "
              f"{[f'{e:.3e}' for e in errs[:-1]]}, final norm {errs[-1]:.3e}; predictions {pred_err:.3e}; tolerance "
              f"{FULL_WIDTH_TOL} (bf16 activations, 2^-9 a rounding, ~10 roundings a layer on the residual path "
              f"over {FULL_WIDTH_LAYERS} layers; the f32 side exact to ~1e-6); launches {launches}, f32 plain 0 "
              f"({card})")
        if max(errs + [tokens_err, pred_err]) > FULL_WIDTH_TOL:
            raise AssertionError("the bf16 full-width forward is off the f32 one")
    record = {"write_s": write_s, "bytes": size, "load_s": load_s, "layer_err": errs, "tokens_err": tokens_err,
              "pred_err": pred_err, "peak_rss_gb": peak_rss_gb()}
    print(json.dumps(record))
    if record["peak_rss_gb"] > HOST_RSS_LIMIT_GB:
        raise AssertionError(f"9w's peak host RSS {record['peak_rss_gb']:.2f} GB is over {HOST_RSS_LIMIT_GB}")
    return 0


# ---------------------------------------------------------------------------
# Phase 9q: the two quality-run scripts (scripts/quant_quality_run_torch.py,
# scripts/plateau_run_torch.py) at full width through their own functions,
# in a process of its own (``--quality DIR``), only their counts cut.

QUALITY_ARGV = ["--steps", "3", "--eval-every", "3", "--n-train", "2", "--n-val", "1"]
PLATEAU_ARGV = ["--layers", "32", "--plant", "self", "--configs", "bf16,w8a8g8", "--train-batches", "2",
                "--val-batches", "1", "--max-epochs", "2"]
QUALITY_JSON_KEYS = ["config", "geometry", "curve"]
PLATEAU_JSON_KEYS = ["config", "layers", "noise_ceiling_r", "final_val_corr_avg", "stopped_early", "stop_step",
                     "walltime_s", "curve"]
PROBE_JSON_KEYS = ["config", "probe_alpha", "probe_val_r"]
INT_VIEWS = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def load_script(name: str):
    """``scripts/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module                   # its dataclasses look their module up
    spec.loader.exec_module(module)
    return module


def fingerprint(t: torch.Tensor) -> tuple[int, int]:
    """Two integer sums of a tensor's bits on its device (plain and weighted
    by position mod 65521): equal tensors give equal pairs, and a flipped
    bit moves both."""
    bits = t.detach().contiguous().view(INT_VIEWS[t.element_size()]).reshape(-1).to(torch.int64)
    weights = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
    return int(bits.sum()), int((bits * weights).sum())


def quality_launches(layers: int, tower_layers: int, quant: str | None, train: bool) -> dict[str, int]:
    """A teacher-student step from frames (``train``: the decoder's layers
    twice under remat, one flash backward a layer) or a val batch: no LoRA
    kernel (no dropout), and with an int8 base a row quant a projection
    each time it runs (13 a layer in a step, the replay stopping before the
    last projection's base product; the tower's 6 a layer once), with
    w8a8g8 a scaled one a dx (layer 0's q, k, v need none)."""
    want = dict.fromkeys(KERNELS, 0)
    want["flash_fwd"] = (2 if train else 1) * layers
    if train:
        want.update(flash_bwd_prep=layers, flash_bwd=layers, flash_bwd_post=layers)
    if quant is not None:
        want["row_quant"] = (13 if train else 7) * layers + 6 * tower_layers
    if quant == "w8a8g8" and train:
        want["row_quant_scaled"] = 7 * layers - 3
    return want


def plateau_fit_launches(layers: int, steps: int, val_batches: int, quant: str | None) -> dict[str, int]:
    """A plateau fit from cached tokens: a step as above without the tower
    (the adapters' dropout unfused: no LoRA kernel), a val batch a forward."""
    step = quality_launches(layers, 0, quant, train=True)
    val = quality_launches(layers, 0, quant, train=False)
    return {k: steps * step[k] + val_batches * val[k] for k in KERNELS}


def wrap(module, name: str, before=None, after=None) -> None:
    """Replace ``module.name`` by a call between ``before()`` and
    ``after(result)``."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        if before is not None:
            before()
        out = real(*args, **kwargs)
        if after is not None:
            after(out)
        return out

    setattr(module, name, wrapper)


def json_lines(text: str) -> list[dict]:
    lines = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
    for line in text.splitlines():
        print(f"  {line}")
    return lines


def quality_teacher_student(card: str) -> dict:
    """``quant_quality_run_torch.run`` at its defaults (32 layers, batch 6,
    bf16, w8a8 and w8a8g8, a bf16 teacher) but 3 steps, 2 train and 1 val
    batch, through the script's own functions, watched from outside."""
    qq = load_script("quant_quality_run_torch")
    args = qq.parse_args(QUALITY_ARGV)
    configs = args.configs.split(",")
    cfg = qq.build_cfg(None, args.layers, args.preset)
    layers, tower_layers = cfg.mistral.num_hidden_layers, cfg.clip.effective_layers
    bases, codes, want_codes, targets, steps, evals = [], [], {}, [], [], []

    def state(cfg_, device):
        sd = qq.base_state(cfg_, device)
        bases.append({k: fingerprint(t) for k, t in sd.items()})
        if not want_codes:                         # the teacher's base, quantized as q8_dev would
            for key, t in sd.items():
                if is_base_projection(key, t):
                    q, s = quantize_int8(t, axis=1)
                    base = key[: -len("weight")]
                    want_codes[base + "weight_q"], want_codes[base + "weight_scale"] = fingerprint(q), fingerprint(s)
        return sd

    wrap(qq, "quantize_base", after=lambda sd: codes.append(
        {k: fingerprint(t) for k, t in sd.items() if k.endswith((".weight_q", ".weight_scale"))}))

    def set_targets(model, batches, rng):
        reset_launches()
        real_targets(model, batches, rng)
        torch.cuda.synchronize()
        targets.append((read_launches(), [b["timeseries"] for b in batches]))

    real_targets = qq.set_teacher_targets
    qq.set_teacher_targets = set_targets

    def step_before():
        torch.cuda.synchronize()
        reset_launches()
        steps.append({"t0": time.perf_counter()})

    def step_after(out):
        torch.cuda.synchronize()
        steps[-1].update(ms=(time.perf_counter() - steps[-1]["t0"]) * 1e3, launches=read_launches(),
                         loss=float(out["brain_loss"]))

    wrap(qq, "train_step", before=step_before, after=step_after)
    wrap(qq, "evaluate", before=reset_launches, after=lambda r: evals.append((read_launches(), r)))
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        records = qq.run(args, state=state)
    wall_s = time.perf_counter() - t0
    lines = json_lines(out.getvalue())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    (teacher_launches, ys), = targets
    if not all(np.isfinite(y).all() and y.shape == (args.batch, cfg.num_target) for y in ys):
        raise AssertionError(f"the teacher's targets are not finite ({args.batch}, {cfg.num_target}) arrays")
    t_quant = qq.teacher_quant(configs, args.teacher)
    if teacher_launches != {k: v * len(ys) for k, v in
                            quality_launches(layers, tower_layers, t_quant, train=False).items()}:
        raise AssertionError(f"the teacher's forward launched {teacher_launches}")
    if len(bases) != 1 + len(configs) or any(b != bases[0] for b in bases[1:]):
        raise AssertionError("a student's starting state is not bitwise the teacher's")
    if len(codes) != 2 or any(c != want_codes for c in codes):
        raise AssertionError("a student's int8 codes or scales are not the teacher's base quantized")
    if [line.get("config") for line in lines] != configs or any(list(line) != QUALITY_JSON_KEYS for line in lines) \
            or any([list(p) for p in line["curve"]] != [["step", "val_pearson_avg"]] for line in lines):
        raise AssertionError(f"the JSON lines are not the JAX script's: {lines}")
    per = args.steps
    by_config = {name: steps[i * per:(i + 1) * per] for i, name in enumerate(configs)}
    for i, name in enumerate(configs):
        quant = qq.quant_of(name)
        want_step = quality_launches(layers, tower_layers, quant, train=True)
        want_eval = {k: v * args.n_val for k, v in quality_launches(layers, tower_layers, quant, train=False).items()}
        got = [s["launches"] for s in by_config[name]]
        if any(g != want_step for g in got) or evals[i][0] != want_eval:
            raise AssertionError(f"{name}: a step launched {got}, an evaluation {evals[i][0]}; want {want_step} "
                                 f"and {want_eval}")
        if not all(np.isfinite(s["loss"]) for s in by_config[name]) or not np.isfinite(records[i]["curve"][-1][1]):
            raise AssertionError(f"{name}: a non-finite loss or val r")
    first = {name: by_config[name][0]["loss"] for name in configs}
    if first["w8a8"] != first["w8a8g8"]:
        raise AssertionError(f"w8a8's first loss {first['w8a8']!r} is not w8a8g8's {first['w8a8g8']!r}")
    for name in configs:
        print(f"  {name}: step ms {[round(s['ms'], 3) for s in by_config[name]]}, first loss "
              f"{by_config[name][0]['loss']!r}, launches a step "
              f"{ {k: v for k, v in by_config[name][0]['launches'].items() if v} }, val r "
              f"{records[configs.index(name)]['curve'][-1][1]:.6f} ({card})")
    print(f"  teacher: {len(ys)} batches of {args.batch}, {teacher_launches['flash_fwd']} flash forwards; every "
          f"student's start bitwise the teacher's ({len(bases[0])} tensors), the int8 codes and scales "
          f"({len(want_codes)} tensors) the teacher's base quantized; w8a8 and w8a8g8 first losses bit-equal; "
          f"{wall_s:.1f} s in all, peak device memory {peak_gb:.2f} GB ({card})")
    return {"quality_step_ms": {name: [s["ms"] for s in by_config[name]] for name in configs},
            "quality_first_loss": first, "quality_peak_gb": peak_gb, "quality_s": wall_s}


def quality_plateau(root: Path, dev, card: str) -> dict:
    """``plateau_run_torch`` at 32 layers, ``--plant self``, bf16 and
    w8a8g8, 2 train and 1 val batch of 6, 2 epochs; then ``--probe`` on the
    same data."""
    pr = load_script("plateau_run_torch")
    args = pr.parse_args([*PLATEAU_ARGV, "--out", str(root / "plateau")])
    quant = {name: pr.quant_of(name) for name in args.configs.split(",")}
    n_batches = args.train_batches + args.val_batches
    encodes, pooled, fits = [], [], []
    real_encode, real_train_one = VideoLLaMA2VLB.encode_video, VLBTrainer.train_one
    VideoLLaMA2VLB.encode_video = lambda self, video: (encodes.append(video.shape[0]), real_encode(self, video))[1]
    try:
        t0 = time.perf_counter()
        reset_launches()
        data = pr.prepare(args, pr.base_state)
        torch.cuda.synchronize()
        encode_launches, prepare_s = read_launches(), time.perf_counter() - t0
        if encodes != [args.batch] * n_batches or any(encode_launches.values()):
            raise AssertionError(f"the tokens were encoded {encodes} (want {n_batches} batches of {args.batch}), "
                                 f"launching {encode_launches} (the bf16 towers launch no hand kernel)")
        if not all(b["vision"].dtype == torch.bfloat16 and b["vision"].device == dev for b in data.batches):
            raise AssertionError("the cached tokens are not bf16 on the card")

        def pooled_after(reps):
            torch.cuda.synchronize()
            pooled.append((read_launches(), reps))

        wrap(pr, "pooled_reps", before=reset_launches, after=pooled_after)
        step_ms = timed_calls(VLBTrainer, "train_one")

        def fit_before():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()

        def fit_after(rec):
            torch.cuda.synchronize()
            fits.append((read_launches(), torch.cuda.max_memory_allocated() / 1e9))

        wrap(pr, "fit", before=fit_before, after=fit_after)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            records = pr.run(args, data=data)
        lines = json_lines(out.getvalue())
        probe_args = pr.parse_args([*PLATEAU_ARGV, "--out", str(root / "plateau"), "--probe"])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            probes = pr.run(probe_args, data=data)
        probe_lines = json_lines(out.getvalue())
    finally:
        VideoLLaMA2VLB.encode_video, VLBTrainer.train_one = real_encode, real_train_one
    if len(encodes) != n_batches:
        raise AssertionError(f"the fits encoded frames again ({len(encodes) - n_batches} more batches)")
    layers, hidden = args.layers, pr.build_cfg(None, args.layers, args.preset).mistral.hidden_size
    for (launches, reps), name in zip(pooled, [*quant, *quant]):
        want = {k: v * n_batches for k, v in quality_launches(layers, 0, quant[name], train=False).items()}
        if launches != want or not np.isfinite(reps).all() or reps.shape != (n_batches * args.batch, hidden):
            raise AssertionError(f"{name}: the pooled reps launched {launches} (want {want}) or are not finite "
                                 f"({reps.shape})")
    steps = args.train_batches * args.max_epochs
    for (launches, peak_gb), rec, line, name in zip(fits, records, lines, quant):
        want = plateau_fit_launches(layers, steps, args.max_epochs * args.val_batches, quant[name])
        if launches != want:
            raise AssertionError(f"{name}: the fit launched {launches}, want {want}")
        if list(line) != PLATEAU_JSON_KEYS or len(rec["curve"]) != args.max_epochs or rec["stop_step"] != steps \
                or not all(np.isfinite(r) and np.isfinite(loss) for _, r, loss in rec["curve"]):
            raise AssertionError(f"{name}: the record is not the JAX script's, or its curve has not one finite "
                                 f"row an epoch: {line}")
        print(f"  {name}: fit {rec['walltime_s']:.1f} s, launches "
              f"{ {k: v for k, v in launches.items() if v} }, curve {pr.rounded(rec)['curve']}, peak device "
              f"memory {peak_gb:.2f} GB ({card})")
    if [list(line) for line in probe_lines] != [PROBE_JSON_KEYS] * 3 * len(quant) or not all(
            np.isfinite(p["probe_val_r"]) for p in probes):
        raise AssertionError(f"the probe lines are not the JAX script's: {probe_lines}")
    print(f"  tokens of {n_batches} batches of {args.batch} encoded once in {prepare_s:.1f} s (host pixels "
          f"included); LoRA step ms {[round(x, 3) for x in step_ms]} ({card})")
    return {"plateau_step_ms": step_ms, "plateau_prepare_s": prepare_s,
            "plateau_fit_s": [rec["walltime_s"] for rec in records],
            "probe": [(p["config"], p["probe_alpha"], p["probe_val_r"]) for p in probes]}


def quality_child(out: str) -> int:
    """``--quality DIR``: phase 9q in this process, under DIR; prints one
    JSON line of its numbers last."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name_and_power()
    record = {}
    with phase("9q (a) teacher-student LoRA recovery (scripts/quant_quality_run_torch.py) at full width"):
        record.update(quality_teacher_student(card))
        torch.cuda.empty_cache()
    with phase("9q (b) the planted-HRF plateau (scripts/plateau_run_torch.py) at 32 layers, then its probe"):
        record.update(quality_plateau(Path(out), dev, card))
    record["peak_rss_gb"] = peak_rss_gb()
    print(json.dumps(record))
    if record["peak_rss_gb"] > HOST_RSS_LIMIT_GB:
        raise AssertionError(f"9q's peak host RSS {record['peak_rss_gb']:.2f} GB is over {HOST_RSS_LIMIT_GB}")
    return 0


@contextlib.contextmanager
def plain_attention():
    """The decoder's attention through its plain PyTorch version on CUDA
    tensors (f32, which the kernel does not take), in this process."""
    real = mistral_module.attention_packed
    mistral_module.attention_packed = attention_packed_plain
    try:
        yield
    finally:
        mistral_module.attention_packed = real


def run_sharded(out: str, nproc: int, flag: str, label: str, timeout: int) -> dict:
    """``chip_smoke.py flag out`` on ``nproc`` processes through
    ``torch.distributed.run --standalone``; the ranks' output is passed on
    line by line as it comes. Returns rank 0's JSON record. Past
    ``timeout`` the launcher and its ranks (a session of their own) are
    killed; on a failure each rank's stacks, if it dumped them
    (``sharded_child``), are printed."""
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             f"--nproc_per_node={nproc}", str(ROOT / "chip_smoke.py"), flag, out],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True,
                            env={**os.environ, "PYTHONUNBUFFERED": "1", MULTI_CARD_OPT_IN: "1"})
    lines: list[str] = []

    def pass_on():
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            print(f"  | {lines[-1]}", flush=True)

    reader = threading.Thread(target=pass_on, daemon=True)
    reader.start()
    try:
        proc.wait(timeout=timeout)
        failure = None if proc.returncode == 0 else f"failed (exit {proc.returncode})"
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        failure = f"ran past {timeout} s and was killed"
    reader.join(timeout=30)
    # Rank 0's record: the last line of the ranks' merged output that holds one.
    records = [line for line in lines if line.startswith("{") and "rank_peak_rss_gb" in line]
    if failure is None and not records:
        failure = "printed no record"
    if failure is not None:
        for stacks in sorted(Path(out).glob("stacks.rank*.txt")):
            print(f"  {stacks.name}:\n{stacks.read_text()[-6000:]}")
        raise RuntimeError(f"{label} {failure}")
    record = json.loads(records[-1])
    print(f"  {label}: peak host RSS of each rank {[round(x, 2) for x in record['rank_peak_rss_gb']]} GB "
          f"(limit {HOST_RSS_LIMIT_GB})")
    return record


# ``--keep-table PATH``: the table ``tests/test_torch_keep_bytes.py`` holds
# the plain 32-bit keep draw to, read from ``torch.rand`` on an H100 SXM (132
# SMs of 2048 threads): under one grid, between one and four grids (words
# 0-2), several iterations, several iterations with a tail off 4.
KEEP_TABLE_SEEDS = (0, 1, 12345, 2 ** 31 + 7, 2 ** 40 + 3)
KEEP_TABLE_SHAPES = ((1000,), (2, 300001), (3, 1100, 1001), (7, 331, 1201))


def keep_table_indices(numel: int, seed: int) -> list[int]:
    """The indices whose bytes the table holds: the H100 grid's edges, the
    middle, the tail, and 16 drawn from the seed and the size."""
    t = 132 * 2048
    edges = [0, 1, t - 1, t, t + 1, 2 * t, 3 * t, 4 * t - 1, 4 * t, 4 * t + 1, 8 * t, numel // 2,
             numel - 4, numel - 3, numel - 2, numel - 1]
    rng = np.random.default_rng(seed % 1000 + numel)
    return sorted({i for i in edges if 0 <= i < numel} | set(rng.integers(0, numel, 16).tolist()))


def write_keep_table(path: str) -> int:
    """Per (seed, shape) of ``torch.rand(shape, generator=torch.Generator(
    "cuda").manual_seed(seed)) < 0.9`` on this card: the kept count, the
    sha256 of the 0/1 bytes and the bytes at ``keep_table_indices``;
    written to PATH as JSON."""
    import hashlib

    dev, keep = torch.device("cuda", 0), 0.9
    cases = []
    for shape in KEEP_TABLE_SHAPES:
        for seed in KEEP_TABLE_SEEDS:
            gen = torch.Generator(device=dev).manual_seed(seed)
            kept = (torch.rand(shape, generator=gen, device=dev) < keep).to(torch.uint8).reshape(-1).cpu()
            at = keep_table_indices(kept.numel(), seed)
            cases.append({"seed": seed, "shape": list(shape), "kept": int(kept.sum()),
                          "sha256": hashlib.sha256(kept.numpy().tobytes()).hexdigest(),
                          "at": at, "bytes": [int(kept[i]) for i in at]})
    table = {"keep": keep, "card": torch.cuda.get_device_name(dev), "torch": torch.__version__, "cases": cases}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(table, indent=1) + "\n", encoding="utf-8")
    print(f"{len(cases)} cases written to {path} ({card_name_and_power()})")
    return 0


def run_child(flag: str, out: str, label: str, timeout: int) -> dict:
    """``chip_smoke.py flag out`` in a process of its own; its output is
    passed on. Returns its JSON record."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), flag, out],
                          capture_output=True, text=True, timeout=timeout)
    for line in proc.stdout.splitlines()[:-1]:
        print(f"  | {line}")
    if proc.returncode != 0:
        raise RuntimeError(f"{label} failed (exit {proc.returncode}):\n{proc.stderr[-6000:]}")
    record = json.loads(proc.stdout.splitlines()[-1])
    print(f"  {label}'s process: peak host RSS {record['peak_rss_gb']:.2f} GB (limit {HOST_RSS_LIMIT_GB})")
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--ring-issue"]:
        return compare_ring_issue(sys.argv[2:])
    if sys.argv[1:2] == ["--lora-calls"]:
        return compare_lora_calls(sys.argv[2:])
    if sys.argv[1:2] == ["--lora-step"]:
        return compare_lora_step(sys.argv[2:])
    if sys.argv[1:2] == ["--trainer"]:
        return trainer_child(sys.argv[2])
    if sys.argv[1:2] == ["--after-train"]:
        return after_train_child(sys.argv[2])
    if sys.argv[1:2] == ["--extract"]:
        return extract_child(sys.argv[2])
    if sys.argv[1:2] == ["--from-jax"]:
        return from_jax_child(sys.argv[2])
    if sys.argv[1:2] == ["--full-width"]:
        return full_width_child(sys.argv[2])
    if sys.argv[1:2] == ["--quality"]:
        return quality_child(sys.argv[2])
    if sys.argv[1:2] == ["--remat"]:
        return remat_child(sys.argv[2])
    if sys.argv[1:2] in (["--sharded"], ["--sharded-pair"]):
        return sharded_child(sys.argv[2], pair=sys.argv[1] == "--sharded-pair")
    if sys.argv[1:2] == ["--tensor-pair"]:
        return tensor_child(sys.argv[2])
    if sys.argv[1:2] == ["--caches"]:
        return caches_child(sys.argv[2])
    if sys.argv[1:2] == ["--keep-table"]:
        return write_keep_table(sys.argv[2])
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    with phase("1 card"):
        card = card_name_and_power()
        print(card)
    with phase("2 build kernels"):
        build_kernels()
    with phase("3 kernels vs plain"):
        max_abs_err = {}
        max_abs_err["flash_fwd"], max_abs_err["flash_bwd"], parts = check_flash(
            LORA_BATCH, REFERENCE_GEOMETRY.feature_len, gen, dev)
        max_abs_err["flash_bwd_prep"], max_abs_err["flash_bwd_post"] = parts
        fwd_err, _, _ = check_flash(BATCH, REFERENCE_GEOMETRY.feature_len, gen, dev)
        max_abs_err["flash_fwd"] = max(max_abs_err["flash_fwd"], fwd_err)
        check_flash(2, 1000, gen, dev)                 # S not a multiple of 64 or 128
        # Past skv 4096 the reference switches to its split backward
        # (_dq_kernel + _dkv_kernel, flash_attention.py:583); one kernel here.
        check_flash(1, 4608, gen, dev)
        # The ring's steps: a whole chunk back (S_loc), a tile (64), and none;
        # and an offset that is no multiple of the 128-row tile (192).
        s_loc = REFERENCE_GEOMETRY.feature_len // RING_RANKS
        for offset in (s_loc, 192, 64, 0):
            check_flash(LORA_BATCH, s_loc, gen, dev, causal_offset=offset)
        # q tiles shorter than 128 rows: one tile of 100, and a last tile of 44
        # with half a tile's offset.
        check_flash(2, 100, gen, dev)
        check_flash(2, 300, gen, dev, causal_offset=64)
        # GQA groups 1, 2 and 8 (4 above) at lengths off the 128-row kv tile.
        for b, s, hq, hkv in ((2, 200, 8, 8), (2, 1000, 16, 8), (1, 4608, 32, 4)):
            check_flash(b, s, gen, dev, hq=hq, hkv=hkv)
        check_flash(2, 256, gen, dev, hq=16, hkv=4, valid=[0, 256])   # a row with every key masked
        max_abs_err["ring_fwd"] = check_ring(gen, dev)
        torch.cuda.empty_cache()
        check_lora_plans(dev)
        for k in LORA_KS:
            for name, err in check_lora(k, gen, dev).items():
                max_abs_err[name] = max(max_abs_err.get(name, 0.0), err)
        torch.cuda.empty_cache()
        max_abs_err.update(check_row_quant(gen, dev))
        max_abs_err.update(check_epilogue(gen, dev))
        torch.cuda.empty_cache()
        # The shapes one tensor rank gives each kernel (mesh.tensor=2, and
        # the heads at 8): the errors join each kernel's.
        for hq, hkv in TENSOR_HEADS:
            fwd_err, bwd_err, parts = check_flash(LORA_BATCH, REFERENCE_GEOMETRY.feature_len, gen, dev, hq=hq, hkv=hkv)
            for name, err in zip(("flash_fwd", "flash_bwd", "flash_bwd_prep", "flash_bwd_post"),
                                 (fwd_err, bwd_err, *parts)):
                max_abs_err[name] = max(max_abs_err[name], err)
        for k, col0 in TENSOR_LORA:
            for name, err in check_lora_col0(k, col0, gen, dev).items():
                max_abs_err[name] = max(max_abs_err[name], err)
        max_abs_err.update(check_row_quant_split(gen, dev))
        for name, err in check_epilogue(gen, dev, TENSOR_EPI_NS).items():
            max_abs_err[name] = max(max_abs_err[name], err)
        torch.cuda.empty_cache()
    with phase("4 full-width model"):
        cfg = VLBConfig.full()
        model = VideoLLaMA2VLB.from_state_dict(cfg, init_params(cfg, dev, gen))
        n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        n_params = sum(p.numel() for p in model.parameters())
        n_vision = sum(p.numel() for name, p in model.named_parameters() if name.startswith(VISION_PREFIXES))
        print(f"  {cfg.mistral.num_hidden_layers} layers, {n_params / 1e9:.3f} B parameters "
              f"({n_vision / 1e9:.3f} B in the CLIP tower's {cfg.clip.effective_layers} layers and the STC "
              f"connector), {n_bytes / 1e9:.2f} GB on {torch.cuda.get_device_name(0)}")
    with phase("5 serve"):
        batches = synthetic_batches(cfg, N_BATCHES, BATCH, np.random.default_rng(SEED), gen, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res = predict_batches(model, batches, dev)
        serve_launches = read_launches()
        check_predictions(res, N_BATCHES * BATCH, cfg.num_target)
        print(f"  batch ms {[round(float(x), 3) for x in res['batch_ms']]}, "
              f"brain_loss {[round(float(x), 5) for x in res['brain_loss']]}, "
              f"corr avg {float(np.nanmean(res['val_corr_roi'])):.5f}, launches {serve_launches}, "
              f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        want = {n: (cfg.mistral.num_hidden_layers * N_BATCHES if n == "flash_fwd" else 0) for n in KERNELS}
        if serve_launches != want:
            raise AssertionError(f"serving launched {serve_launches}, want {want}")
    with phase("6 profile one served batch"):
        traced(lambda: predict_batches(model, [batches[-1]], dev), "served batch")
    with phase("6b serve through the fused ring"):
        serve_through_the_ring(model, batches[-1], res["predicted"][-BATCH:], dev)
        del batches
    with phase("6v serve from frames"):
        serve_from_frames(model, gen, dev)
        towers = (model.vision_tower, model.mm_projector)          # timed in phase 11
        del model
        torch.cuda.empty_cache()
    with phase("7 LoRA train at full width"):
        launches, ring_launches = train_lora_full(gen, dev)
        launches["ring_fwd"] = ring_launches["ring_fwd"]
        torch.cuda.empty_cache()
    with phase("9 frozen-baseline train at full width"):
        train_baseline_full(gen, dev)
        torch.cuda.empty_cache()
    # Phases 9t and 9p, each in a process of its own, under a temporary
    # directory of the (ignored) build tree, deleted after.
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    out = tempfile.mkdtemp(prefix="trainer-", dir=BUILD_ROOT)
    try:
        with phase("9t the trainer (vlb-train) at full width, in a process of its own"):
            trained = run_child("--trainer", out, "the trainer phase", 900)
        with phase("9p after the trainer (predict, feature and token caches, brain maps), in a process of its own"):
            after = run_child("--after-train", out, "the after-train phase", 600)
            print(f"  head step over the feature cache ms {[round(x, 3) for x in after['cached_step_ms']]} against "
                  f"9t's baseline step from frames {[round(x, 3) for x in trained['baseline_step_ms']]}; LoRA step "
                  f"from cached tokens {[round(x, 3) for x in after['tokens_step_ms']]} against from frames "
                  f"{[round(x, 3) for x in after['frames_step_ms']]} ({card})")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    out = tempfile.mkdtemp(prefix="from-jax-", dir=BUILD_ROOT)
    try:
        with phase("9j a JAX run's state converted and resumed on the card, in a process of its own"):
            resumed = run_child("--from-jax", out, "the from-JAX phase", 600)
            print(f"  converted in {resumed['convert_s']:.3f} s ({resumed['convert_bytes']} bytes); the resumed step "
                  f"{resumed['step_ms']:.1f} ms, grad norm {resumed['grad_norm_gap']:.3e} from the direct trainer's "
                  f"(floor {resumed['grad_norm_floor']:.3e}), the update {resumed['update_gap']:.3e} (floor "
                  f"{resumed['update_floor']:.3e}) ({card})")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    out = tempfile.mkdtemp(prefix="full-width-", dir=BUILD_ROOT)
    try:
        with phase("9w full-width weights in HF layout, bf16 hand kernels against f32 plain, in a process of its own"):
            wide = run_child("--full-width", out, "the full-width phase", 600)
            print(f"  wrote {wide['bytes'] / 1e9:.3f} GB in {wide['write_s']:.2f} s, loaded in {wide['load_s']:.2f} s; "
                  f"worst layer {max(wide['layer_err']):.3e}, tokens {wide['tokens_err']:.3e}, predictions "
                  f"{wide['pred_err']:.3e} (tolerance {FULL_WIDTH_TOL}) ({card})")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    out = tempfile.mkdtemp(prefix="quality-", dir=BUILD_ROOT)
    try:
        with phase("9q the quality-run scripts (teacher-student, plateau) at full width, in a process of its own"):
            quality = run_child("--quality", out, "the quality-run phase", 600)
            print(f"  teacher-student step ms {quality['quality_step_ms']} in {quality['quality_s']:.1f} s (peak "
                  f"device memory {quality['quality_peak_gb']:.2f} GB); plateau tokens in "
                  f"{quality['plateau_prepare_s']:.1f} s, fits {[round(x, 1) for x in quality['plateau_fit_s']]} s, "
                  f"LoRA step ms {[round(x, 3) for x in quality['plateau_step_ms']]} ({card})")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    out = tempfile.mkdtemp(prefix="extract-", dir=BUILD_ROOT)
    try:
        with phase("9e the first two stages (vlb-extract, vlb-build-lazyload) and LoRA steps from what they "
                   "built, in a process of its own"):
            staged = run_child("--extract", out, "the extract phase", 600)
            print(f"  extraction {staged['extract_s_per_tr']:.4f} s a TR, the card's preprocessor "
                  f"{staged['preprocess_ms_per_frame']:.4f} ms a frame, build {staged['build_s_per_sample']:.4f} s "
                  f"a sample, LoRA steps from the stores ms {[round(x, 3) for x in staged['step_ms']]} ({card})")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    out = tempfile.mkdtemp(prefix="sharded-", dir=BUILD_ROOT)
    try:
        with phase("9d the trainer of record across processes (torchrun, FSDP2, NCCL), in processes of "
                   "their own"):
            sharded = run_sharded(out, 1, "--sharded", "the sharded phase on 1 process", SHARDED_LIMIT_S)
            print(f"  step ms sharded {[round(x, 3) for x in sharded['sharded_step_ms']]} against unsharded "
                  f"{[round(x, 3) for x in sharded['unsharded_step_ms']]}, peak device memory "
                  f"{sharded['sharded_peak_gb']:.2f} GB against {sharded['unsharded_peak_gb']:.2f} GB ({card})")
            n_cards = torch.cuda.device_count()
            if n_cards >= 2:
                pair = run_sharded(out, 2, "--sharded-pair", "(d) on 2 processes", SHARDED_LIMIT_S)
                print(f"  (d) step ms on 2 cards {[round(x, 3) for x in pair['pair_step_ms']]} against one card "
                      f"{[round(x, 3) for x in pair['one_card_step_ms']]} at batch {PAIR_BATCH} ({card})")
            else:
                print(f"  (d) skipped: the machine has {n_cards} card (2 ranks at batch {PAIR_BATCH} against one "
                      "card need 2)")
            tensor = run_sharded(out, TENSOR, "--tensor-pair", f"(e) mesh.tensor={TENSOR} on {TENSOR} processes of "
                                 "the one card (gloo)", SHARDED_LIMIT_S)
            for key in ("bf16", "w8a8g8"):
                e = tensor[key]
                print(f"  (e) {key}, a check through host-staged gloo, not a speed of tensor parallelism: step ms "
                      f"{[round(x, 3) for x in e['step_ms']]} against one process's "
                      f"{[round(x, 3) for x in e['one_step_ms']]}, peak device memory per rank "
                      f"{[round(x, 2) for x in e['rank_peak_gb']]} GB against {e['one_peak_gb']:.2f} GB, first loss "
                      f"bit-equal {e['loss_equal']} (|err| / |ref| {e['loss_gap']:.3e}), step-1 gradients "
                      f"{e['grad_gap']:.3e} beside the floor {e['grad_floor']:.3e} ({card})")
            for world, label in ((1, "(f) the caches at world 1 (NCCL)"),
                                 (2, "(f) the caches on 2 processes of the one card (gloo)")):
                f = run_sharded(out, world, "--caches", label, SHARDED_LIMIT_S)
                fc, tc = f["feature_cache"], f["token_cache"]
                print(f"  {label}: feature cache built in {fc['build_s']:.2f} s, flash_fwd "
                      f"{fc['build_launches']['flash_fwd']} a rank, head step ms {[round(x, 3) for x in fc['step_ms']]} "
                      f"against one process's {[round(x, 3) for x in fc['one_step_ms']]}, caches' gap {fc['store_gap']}; "
                      f"token cache and trainer built in {tc['build_s']:.2f} s, LoRA step ms "
                      f"{[round(x, 3) for x in tc['step_ms']]} against {[round(x, 3) for x in tc['one_step_ms']]}; "
                      f"peak device memory per rank {fc['rank_peak_gb']} and {tc['rank_peak_gb']} GB ({card})")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    with phase("9v w8a8g8 serve from frames"):
        serve_w8a8g8_from_frames(gen, dev)
        torch.cuda.empty_cache()
    with phase("10 narrow models vs f32 CPU"):
        # Each check's CPU work handed back before the next (peak host RSS).
        for check in (lambda: narrow_reference_check(gen, dev),
                      lambda: narrow_reference_check(gen, dev, frames=True),
                      lambda: narrow_lora_check(gen, dev),
                      lambda: narrow_lora_check(gen, dev, attention_impl="ring_fused"),
                      lambda: narrow_lora_check(gen, dev, base_quant="w8a8g8")):
            check()
            release_host_memory(collect=True)
    with phase("11 timing"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timing = {**time_flash(gen, dev), **time_lora(gen, dev), **time_row_quant(gen, dev),
                  **time_epilogue(gen, dev), **time_ring(gen, dev)}
        time_tensor_shapes(gen, dev)
        time_bwd_probes(dev)
        time_fwd_probes(dev)
        time_int_mm(gen, dev)
        time_vision(towers, gen, dev)
        del towers
        print(f"  peak device memory in timing {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    with phase("12 host"):
        rss_gb = peak_rss_gb()
        print(f"  peak host RSS {rss_gb:.2f} GB (limit {HOST_RSS_LIMIT_GB}), "
              f"total wall {time.perf_counter() - t_start:.1f} s")
        if rss_gb > HOST_RSS_LIMIT_GB:
            raise AssertionError("peak host RSS over its limit")

    # The row quant's passes alone run where a row's columns are split: the
    # launches of (e)'s w8a8g8 step on rank 0. The keep kernel runs where
    # the dropout is 32-bit and unfused: the launches of 9t's LoRA fit.
    for name in ("row_absmax", "row_quant_given"):
        launches[name] = tensor["w8a8g8"]["launches"][name]
    launches["lora_keep"] = trained["lora_launches"]["lora_keep"]
    records = [
        {"name": name, "route": "cuda", "source": f"phantom_vlb_tpu_torch/csrc/{REPLACES[name][0]}",
         "replaces": REPLACES[name][1], "launches": launches[name],
         "max_abs_err": max_abs_err[name],
         **{key: timing[name][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for name in KERNELS
    ]
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
