"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Phases, each of which stops the script on failure:
1. device: name, count, and nvidia-smi's name and power limit;
2. build: nvcc builds the three sources of ``pipelinerl_tpu_torch/csrc/``
   for sm_90a (in parallel) and reports registers, shared memory and spills
   of the five kernels;
3. the decode-attention kernel (#1) against its plain version at the
   engine's shapes and on lengths at the edges of its splits, with its
   time, the plain version's, one SDPA call's and the bound; then the paged
   decode-attention kernel (#5) against its plain version at the paged
   engine's shape (pages out of order), at BT 16, on a stale length with a
   released table row, at the bandit_tpu shapes, at the prefix-cache
   engine's (S 8, W 16, tables 4 and 8 pages wide) and on split edges at
   BT 128 and 16, each case also bit for bit against #1 over the gathered
   pages and against a second launch; with its time beside the plain
   version's, a page gather plus one SDPA call, kernel #1 on the same
   lengths over a contiguous cache, and the bound. Each shape logs its grid
   (S, K, splits);
4. the GQA forward kernel (#2) against its plain version and bit for bit
   against a second call (prefill shape, a packed 2048 row of 8 segments,
   q_offset > 0 with Lq < Lkv, a ``forward_extend`` tail, the training row
   and a resumed turn that splits over a cluster, each timed beside SDPA
   and its bound; checked also at the paged
   engine's prefill buckets, on tails laid out as ``forward_extend`` lays
   them out, on unsorted segment ids, with a fully masked row, at Dh 128,
   and on lengths at the edges of its cluster split with S forced from 1 to
   8); each shape logs its grid, and the kernel's registers, shared memory
   and spills at Dh 64 and 128 (it fails on a spill);
5. the GQA backward kernels (dq, dk/dv) against the plain backward at the
   training shape and six more (unsorted segment ids, one 4,096-token
   segment among them), each also bit for bit against a second call and
   with its tile schedule against the plain one; the autograd function
   against autograd through the plain forward; each kernel's grid, cluster,
   registers, shared memory and spills; times and bounds, and a gate that
   dq + dk/dv beats one SDPA backward;
   phases 3-5 also check each kernel at the shapes of phase 9's bandit_tpu
   loop (H 4, K 2; its engine's slots, window and buckets; its packed row);
6. a full-width Qwen2.5-0.5B train step through the port's ``TrainerLoop``
   (L 4096 in 8 segments, remat, the GQA kernels): launch counts, gradient
   parity with the plain attention, one pass through ``attn_impl="flash"``,
   ms per step, tokens/s, MFU and a profile;
7. the slab engine at Qwen2.5-0.5B width (random weights from a seed) with
   GRPO forks, an abort and an in-flight push of the trained weights from
   that ``TrainerLoop``, checked for budgets, finite logprobs, the
   padded-vocabulary guard, kernel launch counts, and against teacher
   forcing through the plain attention;
8. the in-process client on a toy-width model;
9. the paged engine at Qwen2.5-0.5B width (12 of its 24 layers) with the
   JAX package's paged configuration (96 slots, max_len 4096, BT 128, a pool of half the slab's
   pages): long-tail requests, two GRPO groups sharing prompt pages, an
   abort; the peak of active slots, pages returned, kernel #5 launch counts,
   teacher forcing and a decode profile; then kernel #5 against its plain
   version and timed on the tables and lengths this engine gave it, with
   the share of the rows it reads that belong to inactive slots;
10. the paged prefix cache at full width (8 lineages x 3 turns): prefix hits,
   tails prefilled through ``forward_extend`` on kernel #2 at q_offset > 0,
   teacher forcing;
11. slab prefix parking on the same conversations, cold and warm: hits,
   fewer tokens prefilled warm, tails through ``forward_extend``, launch
   counts, teacher forcing; then ``score_tokens`` on third-turn transcripts
   against the sampler's logprobs and against the plain attention;
12. the bandit RL loop (``bandit_tpu``) through the port's ``launch.main``
   with every attention on the kernels, on the slab layout and again on the
   paged layout, the preset's 60 steps each: it must learn both
   times; then with the ``ppo`` group's
   KL penalty against a reference engine, whose weights must stay the
   initial ones in storage of their own;
13. the ``guessing`` preset on the toy model through ``launch.main``: every
   sample carries its turn's prompt, and the run trains;
14. the ``test`` preset (guessing, the reference's Qwen2.5-0.5B oracle) from
   an HF directory at Qwen2.5-0.5B width that ``export_hf`` writes with
   the committed fixture tokenizer (vocabulary padded from 540 to
   151,936): the directory reads back bit for bit through
   ``launch.build_model``; two steps through ``launch.main`` with a save
   after each (kernels #1-#4 launched, no sampled id at or past
   ``valid_vocab``, the version advanced); a second run resumes at step 2
   with params and optimizer state bit for bit those saved and ends at
   step 3; the export reads back as the trainer's final params; a
   ``force_restart`` run starts from step 0; LoRA on the same directory
   trains only its adapters and pushes ``merge_lora``'s weights; and
   ``finetune=actor_critic`` on the toy model trains its value head.
   Write, read, save and resume seconds, file sizes, wall and useful
   tokens/s are logged;
15. the served engine at Qwen2.5-0.5B width (an ``export_hf`` directory
   with the fixture tokenizer; slab S 64, window 16, bucket 128, as phase
   7): ``python -m pipelinerl_tpu_torch.entrypoints.run_engine`` in a child
   process; a greedy request alone over HTTP returns the same ids and
   logprobs, bit for bit, as the same request through an engine built the
   same way in this process; a separate client process
   (``chip_smoke.py --http-load``) sends 64 concurrent chat completions of
   128 tokens, one over SSE; ``/v1/completions`` echo scores agree with the
   sampled logprobs within phase 11's tolerance; useful tokens/s over HTTP
   beside the same load in process; kernel launches read from the child;
16. a full-width PWT3 push while decoding: a trainer process
   (``chip_smoke.py --push``) holds the same weights times 0.5 and posts
   them with ``push_weights_http`` while at least 32 requests are live; the
   server's per-tensor checksums then equal the pusher's, decode windows
   were read back while the push was in flight, and two pushes posted
   back to back show the supersede policy (the first yields to the second,
   whose weights land). Body bytes, serialize seconds, POST-to-200
   seconds and the largest gap between decode windows beside the steady
   gap are logged;
17. ``bandit_tpu`` through ``python -m pipelinerl_tpu_torch.launch
   launch_mode=processes`` (the preset's 60 steps), as a device job and split with
   ``world.trainer_procs=1`` (every version after 0 reaching the engine
   over PWT3): exit 0, the trainer's steps done, the engine on the last
   pushed version, kernel launches read from the children's stats files,
   phase 12's learning gate, and no child left alive; the two runs go side
   by side;
18. the ``math`` preset (the reference's flagship run) through
   ``launch.main`` from phase 14's HF directory at the preset's own engine
   and trainer widths (64 slots of max_len 10,240, prefill buckets
   256-2,048, L 12,288 rows, flash attention) on the synthetic arithmetic
   and countdown sets, cut to 512 new tokens and one step of 64 samples, with the difficulty-aware penalty over a 128-token buffer: every
   reward is the reward table's plus a penalty in [-1, 0], a rollout cut at
   ``max_tokens`` carries the full penalty, the losses are finite, no
   sampled id reaches ``valid_vocab``, kernels #1-#4 launched; each train
   pass's ms and peak memory are logged. Then kernel #1 at that slab
   allocation (live lengths, the same in an allocation that just holds
   them, and full lengths) and #2-#4 on a packed L 12,288 row of the run,
   against their plain versions and timed beside SDPA and their bounds;
19. the ``multi_domain`` preset the same way on math's synthetic sets,
   guessing and counting under the preset's domain mix with adaptive
   sampling: every domain drawn and dispatched among the groups started
   before any finishes, each finished sample carrying its domain's prompt,
   and the stats stream reporting the finished groups' domains; with the
   memory debugger on and step 2 profiled (``finetune.memory_debug``,
   ``finetune.profile``):
   the memory records in the JAX trainer's order, each with the card's
   ``device_<i>`` (in use after each pass, its peak within the card's
   limit), the trace holding #1 (the engine decodes through the step) and
   #2-#4; the step's device ms by family (#1/#5, #2-#4, fp32 and other
   GEMMs, the rest), the device's busy share over the window, the trace's
   size and export seconds are logged;
20. the ``logic``, ``ifeval`` and ``fn_calling`` presets, one step each on
   their synthetic sets: finite rewards from each domain's reward set, and
   the fn_calling prompts carrying the tool's schema through a chat
   template with a tools block;
21. the ``tir`` preset the same way at its own widths on one card (32
   slots of max_len 32,768, prefill buckets 512-16,384, packed rows of
   L 32,768 under GSPO on the GQA kernels; ``parallel.cp=1``, the synthetic
   arithmetic set, 512 new tokens, one step): every reward the math table's
   plus a python-shaping term within ``±max_abs`` plus the length term, no
   rollout past ``max_turns``, finite losses, kernels #1-#4 launched, each
   L 32,768 pass's time and peak memory logged. Then kernel #1 at that slab
   (129 splits), #2 at its smallest and largest prefill buckets, and #2-#4
   on the L 32,768 row it trained on, against their plain versions (by
   blocks of 1,024 queries where a row's scores would not fit) and timed
   beside SDPA and their bounds;
22. the ``coding`` preset on ``synthetic_coding`` with no sandbox (every
   reward the table's no-answer or unparsable entry plus the overlong
   penalty) and the ``miniwob`` preset on ``simweb_train`` with the
   simulated env in process (every reward ``compute_reward``'s under
   ``nico``, no episode past ``agent_max_loops``), one step each;
23. deep_research through the ``base`` preset with the research policy and
   loader: one step, every reward from the domain's set;
24. the ``logic`` preset in processes mode at its own widths over two local
   host names (``world.hosts`` [127.0.0.1, localhost]): the stream hub
   carries every topic, two ``LogicEnvironment`` jobs grade every rollout
   over RPC, and an eval of 8 test problems runs after each version; three
   steps of 64 samples of 128 new tokens. Gates: exit 0 and no child left,
   the engine on the trainer's last version, each verifier's request log,
   the hub's ``.scf`` mirror read back with the counts the stages report, a
   ``stats_test`` snapshot for each eval, kernels #1-#4 in the device job;
25. the toy VLM: ``vlm_bandit_cpu`` inline on the card with the JAX
   package's gate (at least 100 steps, a success tail of at least 0.7 in one
   of two runs, here side by side in two processes; an image-blind policy
   caps at 0.5), then its model on a slab
   and a paged engine (16-token pages): 8 greedy requests of 4 images, two
   each (GRPO forks), give the same tokens on both layouts (#1, #5);
26. Qwen2.5-VL-3B-Instruct at full width (the published config.json, random
   bf16 weights from seed 0, written by ``export_hf``; the fixture tokenizer
   with the three vision tokens at their published ids) through the chartqa
   route (``launch._is_vlm_checkpoint``, ``build_model``, ``build_vision``,
   ``build_processor``) with ``finetune.train_vision_tower``, at the
   chartqa preset's serving and training shapes with the cuts in
   ``VLM_CUTS`` and Qwen2.5-VL-3B's published ``preprocessor_config.json``:
   (a) chartqa prompts with 600x800, 900x900 and 780x1,000 chart images
   sent as the committed files' data URLs (a lossy WebP with an ALPH chunk
   at 600x800, a baseline 4:2:0 JPEG at 900x900, a progressive 4:4:4 one
   at 780x1,000), decoded, resized and patchified by the port's image
   pipeline into 609, 1,024 and 1,008 merged tokens (each size's raw RGB
   as a PNG data URL gives its array's features bit for bit; each
   committed file, and a GIF, an RLE8 BMP, an LZW TIFF with the
   predictor, a JPEG-in-TIFF, a lossless WebP, an ICO, a CUR, a PPM, an
   RLE TGA, a QOI, a PCX, an RLE SGI, an XBM and an XPM beside them,
   decodes to PIL's RGB, its committed SHA-256, and its data URL's
   features equal its pixels'; so does each committed raw image, a 2-D
   array of each dtype PIL reads as I;16, I or F and a PIL image's samples
   in each of the modes CMYK, YCbCr, HSV, I;16, I, F, PA, RGBX and RGBa,
   through ``array_to_rgb``; then one greedy batch of 16 new tokens, a
   request for each new file as a data URL and each raw image, equals in
   tokens and logprobs the same batch with the decoded pixels as PNG data
   URLs, #2 and #1 launched; each prompt carries t*h*w/4 image pads; host
   seconds per image and the decodes the rollouts made logged), all
   finish, the VLM prefill on #2 at Dh 128; (b) the
   engine's logprobs of 4 completions against the trainer's forward of the
   same spliced [1, 8,192] rows; (c) a step on those rows (vlm_bandit's
   reward), #2-#4 launched, the tower's gradients nonzero; (d) the
   trainer's tree as one 7.5 GB PWT3 body while 8 requests decode:
   ``blob-chunked``, the embedding row-spliced, at most 2 x 256 MiB plus
   ``PUSH_SLACK_BYTES`` over decoding's own peak device memory (and over
   the resident weights when the same body goes into the idle engine), the
   version landed, every leaf's checksum the body's, decode windows during
   the push;
   (e) the trained tower exported and read back bit for bit. Then #2 at its
   prefill buckets, #1 at its slab and #2-#4 on its row, at Dh 128 and G 8,
   against their plain versions and timed;
27. the sharded trainer (``parallel/``) as two rank processes on this one
   card (gloo: NCCL refuses two ranks on one GPU): (a) which of
   all_gather_into_tensor, reduce_scatter_tensor, all_reduce and broadcast
   gloo takes on CUDA tensors (the phase fails if one the port calls is
   refused); (b)-(c) at 12 of the 24 layers: (b) cp 2 at the tir preset's
   width on one packed L 32,768 row
   over phase 21's segment ids, each rank's #2-#4 at its q_offset (0,
   16,384), the loss, grad norm, each leaf's Adam first moment and the
   updated params after one step at lr 1e-3 (no warmup) held against one
   rank's pass of the row, each rank's pass time and peak memory logged;
   (c) dp 2 at Qwen2.5-0.5B width on two L 2,048 rows with the params cut
   by the rule table and gathered a layer at a time, held the same way
   against one rank's two passes; (d) ``launch`` in processes
   mode with ``world.trainer_procs=2 parallel.dp=2`` on the ``test`` preset
   from phase 14's directory: rank 0's pushes reach the engine, the version
   is the trained samples, both ranks exit 0 ((d) runs beside phases
   18-23, whose one process leaves most cores idle; phase 17's two runs go
   side by side the same way, and phase 25's two beside phases 26 and 27).
   Then #2-#4 at each cp rank's
   shape of that row against their plain versions by blocks and timed
   beside SDPA and their bounds;
28. tensor parallelism as two gloo rank processes on this card, from phase
   14's directory at Qwen2.5-0.5B width (7 query heads, 1 KV head, 2,432
   FFN columns and 75,968 vocabulary rows a rank; (a)-(c) at 12 of its 24
   layers): (a) the tp engine on the
   slab layout (S 64, max_len 2,048, W 16, the kernels): 32 greedy requests
   (a GRPO group of 8 among them) against one rank's engine on the same
   prompts (equal tokens, or a divergence at a near-tie of the one-rank
   model; the shared tokens' logprobs within phase 7's teacher-forcing
   limits), a sampled batch, and a PWT3 push into rank 0 while 16
   requests decode: the version lands on both ranks, each rank's checksums
   equal its slice of the pushed tree, and the window gaps are logged; the
   ranks read back the same windows; (b) the same on the paged layout; (c)
   one pass of the math preset's L 12,288 row (phase 18's segments; the
   logits by chunks) and one AdamW step at lr 1e-3 (no warmup) at
   ``parallel.tp=2``, held against one rank as phase 27 holds its steps;
   (d) the ``test`` preset through ``launch`` with ``engine.tp=2
   parallel.tp=2``, 2 steps (after 27 (d), beside phases 18-23; not beside
   phase 26, whose 3B trainer needs the device memory its four processes
   hold): both trainer ranks step, both engine ranks end on the
   trainer's version with one window digest; (e) #1 at the tp slab (S 64, K
   1, G 7), #5 on the tp paged engine's own tables, #2-#4 on (c)'s row at K
   1, G 7, against their plain versions and timed beside SDPA and their
   bounds;
29. pipeline parallelism and heads that do not split, as gloo rank
   processes on this card from phase 14's directory: (a) a pp 2 engine at
   full width and depth (12 layers a stage; the embedding table on stage
   0, the final norm and the tied head on stage 1), slab then paged, on
   phase 28's greedy prompts: tokens and logprobs equal one rank's bit for
   bit, each stage launches #1 or #5 once a layer a dispatched step and #2
   once a layer a prefill batch, a decode step's ms beside one rank's, and
   a 988 MB push while 8 requests decode: windows read back during it, the
   version lands on both stages, each stage's checksums equal its slice;
   (b) tp 2 x pp 2 (four ranks) and (c) tp 4 over the 14 query heads (4,
   4, 3, 3 a rank at G 4, 1, 3, 3), both at 8 layers: greedy tokens
   against one rank under phase 28's near-tie rule with at least 19 of 24
   equal, launches on every rank; (c) also one pass of an L 4,096 row and
   one AdamW step at ``parallel.tp=4`` held against one rank as phase 28's
   (c);
30. Llama-3.2-1B width (the published ``config.json``: V 128,256, D 2,048,
   F 8,192, 16 layers, H 32, K 8, Dh 64, tied, its ``rope_scaling`` unread
   as in JAX) from an ``export_hf`` directory of random bf16 weights with
   the committed Llama-3-style tokenizer (its specials at 128,000-128,255,
   the padded-vocabulary guard over the rest): the ``test`` preset through
   ``launch`` for 2 steps in a child process (engine prefill and decode,
   the trainer's steps, the pushes; after 28 (d), beside phases 18-23),
   #1-#4 launched, prompts that open with ``<|begin_of_text|>``; the
   committed tokenizer families (Llama 3, SentencePiece with
   Prepend/Replace and with Metaspace) give AutoTokenizer's committed ids
   for fixed chats and prompts (BOS added), and ``decode_jpeg`` and
   ``decode_image`` give PIL's RGB of the committed JPEGs and of the GIF,
   BMP, TIFF and WebP charts, each decode timed. Then #1 at its slab, #2
   at its prefill
   bucket and #2-#4 on a row it trained on, at H 32, K 8 (G 4), Dh 64,
   against their plain versions and timed beside SDPA and their bounds.
Then one JSON line of kernel numbers, and last the result line.

``python3 chip_smoke.py --http-load URL N TOKENS OUT`` and
``python3 chip_smoke.py --push URL HF_DIR DIR DEVICE`` are the client and pusher
processes of phases 15 and 16; ``python3 chip_smoke.py --world-rank RANK
WORLD HOST:PORT DIR HF_DIR`` is a rank of phase 27, and ``python3
chip_smoke.py --trainer-world N`` runs phase 27's (b) and (c) alone as N
ranks (N=4 on a host with four cards, over NCCL); ``python3 chip_smoke.py
--tp-rank RANK WORLD HOST:PORT DIR HF_DIR`` is a rank of phase 28, and
``python3 chip_smoke.py --tp-world`` runs phase 28 alone after phases 1-2;
``python3 chip_smoke.py --pp-rank PART RANK WORLD HOST:PORT DIR HF_DIR`` is
a rank of phase 29, and ``python3 chip_smoke.py --pp-world`` runs phase 29
alone after phases 1-2; ``python3 chip_smoke.py --llama3-run WORK OUT`` is
phase 30's child, and ``python3 chip_smoke.py --llama3`` runs phase 30 alone
after phases 1-2; ``python3 chip_smoke.py --profile-study N`` runs phase 19 N
times beside 27 (d) after phases 1-2 (ROADMAP Queue 3's profiler study);
``python3 chip_smoke.py --tp-loss-study N`` runs phase 18's math preset,
then phase 28 (c)'s comparison over N of its L 12,288 rows (ROADMAP Queue
3's study of that bound), each rank a ``python3 chip_smoke.py
--tp-loss-rank RANK WORLD HOST:PORT DIR HF_DIR``.

Each mode a user starts (no argument, ``--tp-world``, ``--pp-world``,
``--llama3``, ``--trainer-world N``, ``--profile-study N``,
``--tp-loss-study N``) runs as a thin parent (``pipelinerl_tpu_torch/reaper.py``):
it runs the phases in one child process with a run marker
(``CHIP_SMOKE_RUN``) in its environment and a temporary directory of its
own, waits for it, kills every process that carries the marker or names the
directory (SIGTERM, then SIGKILL), and exits with the child's code, or 1
when an ok child left a process behind; it writes nothing to stdout. The
child and every rank process print every thread's Python stack on a crash
(``faulthandler``), and the child's last check, just before the result
line, is that no process of the run is left.

It needs a CUDA device and raises without one; it never falls back to the CPU.
"""

from __future__ import annotations

import os
import sys

# the modes a user starts run as a thin parent (above); a process inside a
# run (the phase child, its ranks and clients) has the run's marker and
# runs its mode directly
USER_MODES = ("--tp-world", "--pp-world", "--llama3", "--trainer-world", "--profile-study", "--tp-loss-study")
if __name__ == "__main__" and "CHIP_SMOKE_RUN" not in os.environ and (sys.argv[1:2] == [] or sys.argv[1] in USER_MODES):
    from pipelinerl_tpu_torch import reaper

    sys.exit(reaper.run_parent([sys.executable, os.path.abspath(__file__), *sys.argv[1:]]))

import asyncio
import base64
import collections
import contextlib
import dataclasses
import faulthandler
import gc
import hashlib
import json
import math
import re
import shutil
import signal
import socket
import statistics
import subprocess
import tempfile
import threading
import time
import urllib.request
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from pipelinerl_tpu_torch import launch, reaper
from pipelinerl_tpu_torch.config import compose
from pipelinerl_tpu_torch.domains import registry
from pipelinerl_tpu_torch.domains.math.rollouts import RewardTable, get_reward, length_penalty
from pipelinerl_tpu_torch.domains.tir.rollouts import compute_shaping
from pipelinerl_tpu_torch.domains.tir.tool_parser import parse_tool_calls
from pipelinerl_tpu_torch.inference import EngineConfig, GenRequest, InferenceEngine, SamplingParams
from pipelinerl_tpu_torch.inference import engine as engine_mod
from pipelinerl_tpu_torch.inference.client import InProcessLLM, Prompt
from pipelinerl_tpu_torch.inference.http_client import HTTPLLM
from pipelinerl_tpu_torch.inference.server import param_checksums
from pipelinerl_tpu_torch.inference.weight_transfer import post_weights, push_weights_http, serialize_params
from pipelinerl_tpu_torch.models.hf_loader import load_hf_model
from pipelinerl_tpu_torch.models.hf_tokenizer import HFTokenizer
from pipelinerl_tpu_torch.models.toy_tokenizer import ToyTokenizer
from pipelinerl_tpu_torch.models.transformer import ModelConfig, extend_segments, forward, init_params
from pipelinerl_tpu_torch.entrypoints.common import wait_for_http
from pipelinerl_tpu_torch.ops import _build, kernel_launches
from pipelinerl_tpu_torch.ops import decode_attention as dattn
from pipelinerl_tpu_torch.ops import gqa_attention as gattn
from pipelinerl_tpu_torch.ops import paged_attention as pattn
from pipelinerl_tpu_torch.inference.block_pool import BlockPool
from pipelinerl_tpu_torch.streams import SingleStreamSpec, StreamReader, StreamWriter
from pipelinerl_tpu_torch.streams_binary import FrameReader
from pipelinerl_tpu_torch.train.checkpoints import CURRENT_DIR, export_hf
from pipelinerl_tpu_torch.train.lora import merge_lora
from pipelinerl_tpu_torch.train.trainer import TrainerLoop, detached_copy, param_leaves
from pipelinerl_tpu_torch.types import TrainerBatch

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 flop/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# Qwen2.5-0.5B widths and depth, as the JAX package's bench.py builds it
QWEN05B = ModelConfig(
    vocab_size=151_936, hidden_size=896, intermediate_size=4864, num_layers=24,
    num_heads=14, num_kv_heads=2, head_dim=64, rope_theta=1_000_000.0,
    attention_bias=True, dtype=torch.bfloat16, valid_vocab=151_643,
)
# Qwen2.5-0.5B's published config.json (tied embeddings) for phase 14's HF
# directory; its vocabulary is padded past the fixture tokenizer's 540
QWEN05B_TIED = dataclasses.replace(QWEN05B, tie_word_embeddings=True, valid_vocab=None,
                                   hf_architecture="Qwen2ForCausalLM")
QWEN05B_HEADS = (QWEN05B.num_heads, QWEN05B.num_kv_heads, QWEN05B.head_dim_)
FIXTURE_TOKENIZER = Path(__file__).resolve().parent / "pipelinerl_tpu_torch" / "fixtures" / "hf_tokenizer"
# Qwen2.5-VL's vision tokens at their published ids (Qwen2.5-VL-3B-Instruct's
# tokenizer_config.json), added to the fixture tokenizer for phase 26
VL_TOKENS = {"<|vision_start|>": 151_652, "<|vision_end|>": 151_653, "<|image_pad|>": 151_655}


def vl_tokenizer_dir(out: Path, tokens: dict[str, int] = VL_TOKENS) -> Path:
    """A copy of the fixture tokenizer in ``out`` with ``tokens`` added as
    special tokens at their ids, and Qwen2.5-VL's chat template
    (``fixtures/chat_template_vl.jinja``), which places
    ``<|vision_start|><|image_pad|><|vision_end|>`` for each image part."""
    out.mkdir(parents=True, exist_ok=True)
    for name in ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json"):
        shutil.copyfile(FIXTURE_TOKENIZER / name, out / name)
    shutil.copyfile(FIXTURE_TOKENIZER.parent / "chat_template_vl.jinja", out / "chat_template.jinja")
    spec = json.loads((out / "tokenizer.json").read_text())
    config = json.loads((out / "tokenizer_config.json").read_text())
    for content, i in tokens.items():
        flags = {"single_word": False, "lstrip": False, "rstrip": False, "normalized": False, "special": True}
        spec["added_tokens"].append({"id": i, "content": content, **flags})
        config["added_tokens_decoder"][str(i)] = {"content": content, **flags}
    (out / "tokenizer.json").write_text(json.dumps(spec))
    (out / "tokenizer_config.json").write_text(json.dumps(config))
    return out


SLOTS, PROMPT_LEN, MAX_TOKENS, WINDOW, DEPTH, BUCKET = 64, 128, 128, 16, 2, 128
MAX_LEN = PROMPT_LEN + MAX_TOKENS + 72  # 328, as bench.py's headline engine

# tolerances, stated with their reason
DECODE_ATOL = 2e-2  # fp32 out; both sides bf16 operands, bf16 P, fp32 sums
GQA_OUT_ATOL = 2e-2  # bf16 out (2^-8 relative rounding) over O(1) values
GQA_LSE_ATOL = 2e-3  # fp32 scores from bf16 operands, summed in another order
# #1, #2 and #5's outputs are also held relative to their size, row by row
# (a decode slot's query, a packed row's token, over all heads): the
# largest ||out - ref|| / ||ref||. A softmax over n keys of N(0, 1) values
# gives outputs of about sqrt(e / n): past 10^4 keys that is below the
# absolute limits above, which then see nothing. Both sides round P to
# bf16 at another running max, and #2's bf16 output rounding flips an ulp
# where the fp32 values differ: on an H100 (700 W) every shape this script
# checks read 3.5e-3 at most, while a copy of the kernels with #2's output
# 1% high (both store paths) read 1.08e-2 to 1.10e-2, and one with a split
# dropped from #1's merge 0.100 at the full tir slab; the absolute limits
# passed both
OUT_ROW_RTOL = 6e-3
# backward kernels, bf16 dq/dk/dv against the plain backward from the same
# inputs: 2^-8 relative output rounding, plus bf16 roundings of P and dS
# that flip where fp32 sums run in another order; held to 1e-2 of the
# largest reference value
GQA_BWD_RTOL = 1e-2
# train step at full width, per-tensor relative L2 error of the gradients
# with the GQA kernels against the plain attention on the same bf16 weights:
# the kernels round P and dS to bf16 where the plain path keeps fp32, and
# bf16 activations carry the difference through 24 layers, so every tensor
# reads alike (2.4e-2 to 3.7e-2 on an H100). Every tensor is held to it: no
# gradient is zero by construction here (RoPE rotates bk by key position, so
# softmax's shift invariance does not cancel bk's gradient; its rms per entry
# is that of bq and wq), and the script prints each reference norm
TRAIN_GRAD_REL_L2 = 5e-2
TRAIN_L, TRAIN_STEPS = 4096, 5  # bench.py's training row; steps after one warm-up
# engine logprobs (bf16 weights and KV, kernels, batched windows) against a
# T=1 teacher-forced forward through the plain attention: bf16 rounding of
# the 24-layer residual stream lands at different places in the two paths
TF_MEAN_ATOL = 0.03
TF_MAX_ATOL = 0.3
# the JAX package's paged engine configuration (bench.py:577-621): 96 slots
# at max_len 4096 in BT 128 pages, a pool of half the pages a 32-slot slab
# engine would hold (32 * ceil(4128 / 128) / 2 = 528, 0.42 GB of bf16 K+V
# at P_LAYERS)
P_SLOTS, P_MAX_LEN, P_BT, P_WINDOW, P_BUCKETS = 96, 4096, 128, 32, (256, 512)
# phase 9's depth, cut from Qwen2.5-0.5B's 24 (bench.py's paged engine) to
# pay for phase 29's time: its host-bound decode steps scale with the layers
P_LAYERS = 12
P_MAXB = -(-(P_MAX_LEN + P_WINDOW) // P_BT)  # 33 pages per slot
P_POOL = 32 * P_MAXB // 2
P_REQUESTS = 96  # long-tail requests: prompts 128-400 tokens, budgets 128-1024


def bandit_shapes() -> dict:
    """The shapes at which the bandit_tpu RL loop (phase 9) runs the kernels,
    read from its preset: the toy model's heads, the engine's slots, window,
    cache length and prefill buckets, and the trainer's packed row."""
    cfg = compose("bandit_tpu")
    toy, eng = cfg.toy_model, cfg.engine
    return {
        "H": toy.num_heads, "K": toy.num_kv_heads, "Dh": toy.hidden_size // toy.num_heads,
        "S": eng.max_slots, "W": eng.decode_window, "T": eng.max_len + eng.decode_window,
        "buckets": list(eng.prefill_buckets), "seq_length": cfg.finetune.seq_length,
    }


BANDIT = bandit_shapes()
# a packed training row of bandit samples (prompt and answer, 22-31 tokens)
# and the padding segment that fills the row
BANDIT_ROW = [26, 29, 24, 31, 27, 22, 30, 25, 28, BANDIT["seq_length"] - 242]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fns, iters: int = 30) -> float:
    """Mean device time of one call: ``iters`` calls captured in one CUDA
    graph, so host-side launch cost leaves no gaps, and timed with CUDA
    events around a replay. ``fns`` cycles over input sets large enough
    together to spill the 50 MB L2."""
    for f in fns[:3]:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def n_sets(bytes_per_set: int) -> int:
    return max(1, min(32, -(-120_000_000 // max(1, bytes_per_set))))


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    info = {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(), "smi": smi}
    log(f"device: {info['kind']} x{info['count']}, torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    return info


SOURCES = ["decode_attention", "gqa_attention_fwd", "gqa_attention_bwd"]


def phase_build() -> dict[str, str]:
    """Builds the sources; returns each one's ``-Xptxas -v`` report (empty
    for a library built before this run)."""
    t0 = time.monotonic()
    infos = _build.build(SOURCES)
    log(f"build: {time.monotonic() - t0:.1f} s wall for {len(infos)} kernels (nvcc, sm_90a, in parallel)")
    for info in infos:
        log(f"  {info.name}: {info.seconds:.1f} s -> {info.path.name}")
        for line in info.ptxas.splitlines():
            if re.search(r"registers|spill|Compiling entry", line):
                log(f"    {line.strip()}")
    for name in SOURCES:
        _build.library(name)
    return {info.name: info.ptxas for info in infos}


def ptxas_entry(report: str, symbol: str) -> str:
    """The registers and spills ptxas reported for the entry whose mangled
    name contains ``symbol``."""
    entries = report.split("Compiling entry")
    for entry in entries[1:]:
        if symbol in entry.splitlines()[0]:
            stats = " ".join(entry.splitlines()[1:])
            regs = re.search(r"Used (\d+) registers", stats)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", stats)
            if regs and spill:
                return f"ptxas: {regs.group(1)} registers, {spill.group(1)} / {spill.group(2)} bytes spill stores / loads"
    return "ptxas: not reported (library built before this run)"


def _decode_inputs(gen, S, H, K, Dh, T, W, lens, step, dev):
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    return (
        rnd(S, H, Dh), rnd(S, K, Dh), rnd(S, K, Dh), rnd(S, T, K, Dh), rnd(S, T, K, Dh),
        torch.tensor(lens, dtype=torch.int32, device=dev), rnd(W, S, K, Dh), rnd(W, S, K, Dh),
        step,
    )


def _decode_lens(S, T, W, seed):
    special = [0, 1, 37 % (T - W), T - W]
    return special + [int(x) for x in np.random.default_rng(seed).integers(0, T - W + 1, S - 4)]


def split_edge_lens(S, cap, seed) -> list[int]:
    """Lengths on the edges of the decode kernels' splits of C rows: 0,
    C - 1, C, C + 1 and 2C + 1 where the cap allows, the cap itself, then
    random ones below it."""
    C = dattn.SPLIT_ROWS
    special = [n for n in (0, C - 1, C, C + 1, 2 * C + 1) if n < cap] + [cap]
    return special + [int(x) for x in np.random.default_rng(seed).integers(0, cap + 1, S - len(special))]


def grid_note(S, K, cap) -> str:
    splits = dattn.split_plan(cap)
    return f"grid ({S}, {K}, {splits}): {splits} split{'s' if splits > 1 else ''} of {dattn.SPLIT_ROWS} rows"


def _time_decode(gen, S, H, K, Dh, T, W, lens, dev, library: bool = True) -> dict:
    """Kernel #1's time at the last step of a window over ``lens``, the plain
    version's, one masked SDPA call's (with ``library``) and the bound."""
    step = W - 1
    rows = sum(lens) + S * (step + 1)  # K/V rows the function must read
    set_bytes = 2 * rows * K * Dh * 2 + S * H * Dh * (2 + 4) + S * 4
    sets = [_decode_inputs(gen, S, H, K, Dh, T, W, lens, step, dev) for _ in range(n_sets(set_bytes))]
    kernel_ms = time_ms([lambda a=a: dattn.decode_attention_staged_ragged(*a) for a in sets])
    plain_ms = time_ms([lambda a=a: dattn.decode_attention_staged_ragged_plain(*a) for a in sets[:2]], 10)
    library_ms = None
    if library:  # yardstick only: one SDPA call over the same keys with a boolean mask
        lib_sets = []
        for q, kn, vn, kc, vc, ln, ks, vs, _ in sets:
            k_all = torch.cat([kc, ks.transpose(0, 1), kn[:, None]], 1).permute(0, 2, 1, 3).contiguous()
            v_all = torch.cat([vc, vs.transpose(0, 1), vn[:, None]], 1).permute(0, 2, 1, 3).contiguous()
            r = torch.arange(T + W + 1, device=dev)
            mask = torch.where(r[None] < T, r[None] < ln[:, None].long(), (r[None] - T < step) | (r[None] == T + W))
            lib_sets.append((q[:, :, None], k_all, v_all, mask[:, None, None]))
        library_ms = time_ms([
            lambda a=a: F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3], enable_gqa=True)
            for a in lib_sets
        ])
    flops = 4 * H * Dh * rows  # QK and PV, 2 flops per multiply-add, per head and row
    bound_ms, bound_by = bound(set_bytes, flops)
    log(
        f"decode kernel S={S} H={H} K={K} Dh={Dh} W={W} T_alloc={T} step={step}, mean length "
        f"{sum(lens) / len(lens):.0f}: {grid_note(S, K, T)}: {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms if library_ms is None else f'{library_ms:.4f}'} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"roofline share {bound_ms / kernel_ms:.3f}"
    )
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "splits": dattn.split_plan(T)}


def phase_decode_kernel(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1)
    b = BANDIT
    H, K = QWEN05B.num_heads, QWEN05B.num_kv_heads
    T_engine = MAX_LEN + WINDOW
    cases = [  # (label, S, H, K, Dh, W, T_alloc, lens): the engine cell's, then the bandit_tpu engine's
        ("Qwen2.5-0.5B engine", SLOTS, H, K, 64, WINDOW, T_engine, _decode_lens(SLOTS, T_engine, WINDOW, 1)),
        ("Qwen2.5-0.5B engine, split edges", SLOTS, H, K, 64, WINDOW, T_engine, split_edge_lens(SLOTS, T_engine, 2)),
        ("split edges at T_alloc 1024", 16, H, K, 64, WINDOW, 1024, split_edge_lens(16, 1024, 3)),
        ("bandit_tpu engine", b["S"], b["H"], b["K"], b["Dh"], b["W"], b["T"], _decode_lens(b["S"], b["T"], b["W"], 1)),
    ]
    max_err = 0.0
    for label, S, H, K, Dh, W, T, lens in cases:
        for step in (0, W - 1):
            args = _decode_inputs(gen, S, H, K, Dh, T, W, lens, step, dev)
            out = dattn.decode_attention_staged_ragged(*args)
            torch.cuda.synchronize()
            ref = dattn.decode_attention_staged_ragged_plain(*args)
            err = (out.float() - ref.float()).abs().max().item()
            rel = row_rel_err(out, ref, 1)
            log(f"decode kernel vs plain, {label} S={S} H={H} K={K} Dh={Dh} W={W} T_alloc={T}, step {step}, "
                f"{grid_note(S, K, T)}, lengths {lens[:6]}...: max abs err {err:.3e} "
                f"(tolerance {DECODE_ATOL}), slot relative {rel:.3e} (tolerance {OUT_ROW_RTOL})")
            check(math.isfinite(err) and err <= DECODE_ATOL and rel <= OUT_ROW_RTOL,
                  f"decode kernel disagrees with its plain version ({label})")
            check(torch.equal(out, dattn.decode_attention_staged_ragged(*args)), f"decode kernel is not deterministic ({label})")
            max_err = max(max_err, err)

    # times at the engine cell's shape
    H, K, T = QWEN05B.num_heads, QWEN05B.num_kv_heads, T_engine  # T_alloc 344
    times = _time_decode(gen, SLOTS, H, K, 64, T, WINDOW, _decode_lens(SLOTS, T, WINDOW, 1), dev)
    return {
        "name": "decode_attention_staged_ragged", "route": "cuda",
        "source": "pipelinerl_tpu_torch/csrc/decode_attention.cu",
        "replaces": "pipelinerl_tpu/ops/decode_attention.py:33",
        "max_abs_err": max_err, **times, "kernel_ms": times["ms"],
    }


def scattered_table(S, BT, MAXB, NB, lens, seed) -> torch.Tensor:
    """A BlockPool table whose pages come out of order (every other slot's
    first page is released and reused); a slot whose length passes MAXB * BT
    is released, its row all -1, as an inactive slot's. The card's tests of
    kernel #5 (tests/test_torch_cuda.py) build their tables with it too."""
    rng = np.random.default_rng(seed)
    pool = BlockPool(NB, BT, MAXB, S)
    order = [int(s) for s in rng.permutation(S)]
    for s in order:
        pool.allocate(s, 1)
    for s in order[::2]:
        pool.release(s)
    for i, s in enumerate(order):
        need = min(max(lens[s], 1), MAXB * BT)
        pool.allocate(s, need) if i % 2 == 0 else pool.extend(s, need)
    for s in range(S):
        if lens[s] > MAXB * BT:
            pool.release(s)
    return torch.from_numpy(pool.table.copy())


def _paged_inputs(gen, S, H, K, Dh, BT, MAXB, NB, W, lens, step, dev):
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    return (
        rnd(S, H, Dh), rnd(S, K, Dh), rnd(S, K, Dh), rnd(NB, BT, K, Dh), rnd(NB, BT, K, Dh),
        scattered_table(S, BT, MAXB, NB, lens, 0).to(dev), torch.tensor(lens, dtype=torch.int32, device=dev),
        rnd(W, S, K, Dh), rnd(W, S, K, Dh), step,
    )


def _paged_special_lens(S, BT, MAXB, W, high, seed) -> list[int]:
    """Lengths 0, 1, BT, BT + 1 and MAXB * BT - W, then random ones below
    ``high``."""
    special = [0, 1, BT, BT + 1, MAXB * BT - W]
    return special + [int(x) for x in np.random.default_rng(seed).integers(0, high, S - len(special))]


def _paged_bound(a) -> tuple[float, float]:
    """Bytes and flops of one call of kernel #5 on input set ``a``: each K/V
    row it must read (min(len, MAXB * BT) cache rows and step + 1 band rows
    per slot), q, the output, the lengths and the table."""
    q, table, lens, step = a[0], a[5], a[6], a[9]
    S, H, Dh = q.shape
    K, BT, MAXB = a[3].shape[2], a[3].shape[1], table.shape[1]
    rows = int(lens.clamp(max=MAXB * BT).sum()) + S * (step + 1)
    return 2 * rows * K * Dh * 2 + S * H * Dh * (2 + 4) + S * 4 + S * MAXB * 4, 4 * H * Dh * rows


def _time_paged(sets) -> dict:
    """Mean device times of one call, each of ``sets`` in turn: kernel #5;
    its plain version; the library yardstick, a page gather plus one SDPA
    call with a boolean mask (never called by the port); kernel #1 on the
    same lengths over the gathered, contiguous cache. With the mean bound of
    one call. Kernel #1 there must give #5's output bit for bit."""
    n = len(sets)
    reps = -(-30 // n)
    kernel_ms = time_ms([lambda a=a: pattn.paged_decode_attention(*a) for a in sets], reps * n)
    plain_ms = time_ms([lambda a=a: pattn.paged_decode_attention_plain(*a) for a in sets], max(n, 4))

    def library(a, mask):
        q, kn, vn, kp, vp, table, _, ks, vs, _ = a
        k_all = torch.cat([pattn.gather_pages(kp, table), ks.transpose(0, 1), kn[:, None]], 1)
        v_all = torch.cat([pattn.gather_pages(vp, table), vs.transpose(0, 1), vn[:, None]], 1)
        return F.scaled_dot_product_attention(q[:, :, None], k_all.transpose(1, 2), v_all.transpose(1, 2),
                                              attn_mask=mask, enable_gqa=True)

    masks = []
    for a in sets:
        T, W, step = a[5].shape[1] * a[3].shape[1], a[7].shape[0], a[9]
        r = torch.arange(T + W + 1, device=a[0].device)
        ln = a[6].long()
        masks.append(torch.where(r[None] < T, r[None] < ln[:, None], (r[None] - T < step) | (r[None] == T + W))[:, None, None])
    library_ms = time_ms([lambda a=a, m=m: library(a, m) for a, m in zip(sets, masks)], reps * n)
    slab_sets = [(a[0], a[1], a[2], pattn.gather_pages(a[3], a[5]), pattn.gather_pages(a[4], a[5]), a[6], a[7], a[8], a[9])
                 for a in sets]
    slab_ms = time_ms([lambda a=a: dattn.decode_attention_staged_ragged(*a) for a in slab_sets], reps * n)
    for a, s in zip(sets, slab_sets):
        check(torch.equal(dattn.decode_attention_staged_ragged(*s), pattn.paged_decode_attention(*a)),
              "kernel #1 over the gathered pages differs from kernel #5 through the table")
    del slab_sets
    bounds = [bound(*_paged_bound(a)) for a in sets]
    return {
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms, "slab_kernel_ms": slab_ms,
        "bound_ms": sum(b for b, _ in bounds) / n, "bound_by": bounds[0][1],
        "rows": sum(int(a[6].clamp(max=a[5].shape[1] * a[3].shape[1]).sum()) for a in sets) / n,
    }


def _log_paged_times(label: str, t: dict) -> None:
    log(f"paged kernel {label}, {t['rows']:.0f} cache rows per call: {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
        f"page gather + SDPA {t['library_ms']:.4f} ms, kernel #1 on the same lengths (contiguous) "
        f"{t['slab_kernel_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
        f"roofline share {t['bound_ms'] / t['ms']:.3f}")


def _check_paged(label: str, args) -> float:
    """Kernel #5 against its plain version on ``args``, bit for bit against
    kernel #1 over the gathered pages and against a second launch; returns
    the error."""
    out = pattn.paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = pattn.paged_decode_attention_plain(*args)
    err = (out.float() - ref.float()).abs().max().item()
    rel = row_rel_err(out, ref, 1)
    S, H, Dh = args[0].shape
    NB, BT, K = args[3].shape[:3]
    MAXB = args[5].shape[1]
    log(f"paged kernel vs plain, {label}: S={S} H={H} K={K} Dh={Dh} BT={BT} MAXB={MAXB} NB={NB} "
        f"W={args[7].shape[0]} step {args[9]}, {grid_note(S, K, MAXB * BT)}: max abs err {err:.3e} "
        f"(tolerance {DECODE_ATOL}), slot relative {rel:.3e} (tolerance {OUT_ROW_RTOL})")
    check(math.isfinite(err) and err <= DECODE_ATOL and rel <= OUT_ROW_RTOL,
          f"paged kernel disagrees with its plain version ({label})")
    slab = (*args[:3], pattn.gather_pages(args[3], args[5]), pattn.gather_pages(args[4], args[5]), *args[6:])
    check(torch.equal(dattn.decode_attention_staged_ragged(*slab), out),
          f"kernel #1 over the gathered pages differs from kernel #5 through the table ({label})")
    check(torch.equal(pattn.paged_decode_attention(*args), out), f"paged kernel is not deterministic ({label})")
    return err


def phase_paged_kernel(dev) -> dict:
    """Kernel #5 against its plain version in five cases, and its times at
    case (i). Phase 9 times it again on the paged engine's own tables and
    lengths (``time_paged_working_set``)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    H, K, Dh = QWEN05B.num_heads, QWEN05B.num_kv_heads, 64
    S, BT, MAXB, W = P_SLOTS, P_BT, P_MAXB, P_WINDOW
    engine_lens = _paged_special_lens(S, BT, MAXB, W, 1000, 5)
    b = BANDIT
    b_maxb = -(-b["T"] // 16)
    b_lens = _paged_special_lens(b["S"], 16, b_maxb, b["W"], 64, 6)
    # the prefix-cache phase's engine: 8 slots, W 16, tables sliced to 4 and
    # 8 of its 17 pages, a pool of 8 * 17
    x_nb = 8 * -(-(2048 + 16) // 128)
    C = dattn.SPLIT_ROWS
    cases = [  # (label, S, H, K, Dh, BT, MAXB, NB, W, lens, steps)
        ("(i) paged engine", S, H, K, Dh, BT, MAXB, P_POOL, W, engine_lens, (0, W - 1)),
        ("(vi) split edges, BT 128, a stale length past MAXB*BT", 8, H, K, Dh, BT, MAXB, P_POOL, W,
         [0, C - 1, C, C + 1, 2 * C + 1, MAXB * BT, MAXB * BT + 50, 1456], (0, W - 1)),
        ("(vii) split edges, BT 16, a stale length past MAXB*BT", 8, H, K, Dh, 16, 40, 320, W,
         [0, C - 1, C, C + 1, 2 * C + 1, 40 * 16, 40 * 16 + 10, 100], (0, W - 1)),
        ("(ii) BT 16 < the 64-row tile", 4, H, K, Dh, 16, 5, 24, 4, [0, 17, 33, 80], (0, 3)),
        ("(iii) a stale length past MAXB*BT on a released row", 4, H, K, Dh, 16, 5, 24, 4, [87, 5, 0, 40], (2,)),
        ("(iv) bandit_tpu engine, BT 16", b["S"], b["H"], b["K"], b["Dh"], 16, b_maxb, b["S"] * b_maxb, b["W"],
         b_lens, (0, b["W"] - 1)),
    ] + [
        (f"(v) prefix-cache engine, table width {m}", 8, H, K, Dh, 128, m, x_nb, 16,
         _paged_special_lens(8, 128, m, 16, m * 128 - 16, 7), (0, 15))
        for m in (4, 8)
    ]
    max_err = 0.0
    for label, Sc, Hc, Kc, Dc, BTc, MAXBc, NB, Wc, lens, steps in cases:
        for step in steps:
            args = _paged_inputs(gen, Sc, Hc, Kc, Dc, BTc, MAXBc, NB, Wc, lens, step, dev)
            max_err = max(max_err, _check_paged(label, args))

    # times at (i), the last step of a window
    step = W - 1
    first = _paged_inputs(gen, S, H, K, Dh, BT, MAXB, P_POOL, W, engine_lens, step, dev)
    sets = [first] + [_paged_inputs(gen, S, H, K, Dh, BT, MAXB, P_POOL, W, engine_lens, step, dev)
                      for _ in range(n_sets(_paged_bound(first)[0]) - 1)]
    case_i = _time_paged(sets)
    del sets
    _log_paged_times(f"(i) S={S} H={H} K={K} Dh={Dh} BT={BT} MAXB={MAXB} NB={P_POOL} W={W} step={step}", case_i)
    return {
        "name": "paged_decode_attention", "route": "cuda",
        "source": "pipelinerl_tpu_torch/csrc/decode_attention.cu",
        "replaces": "pipelinerl_tpu/ops/paged_attention.py:41",
        "max_abs_err": max_err, "case_i": case_i,
    }


def time_paged_working_set(dev, snapshots, record: dict, heads: tuple[int, int, int] = QWEN05B_HEADS,
                           pool: int = P_POOL, bt: int = P_BT, window: int = P_WINDOW, slots: int = P_SLOTS) -> None:
    """Kernel #5 on the tables and lengths the paged engine of phase 9 (or
    phase 28's tp engine: its ``heads``, ``pool`` pages of ``bt`` tokens,
    ``window``, ``slots``) handed its decode windows (one snapshot every few
    steps), at the last step of a window, with random q, pools and band:
    first against its plain version on every snapshot, then timed over all
    of them. These are the record's times; case (i)'s stay beside them."""
    gen = torch.Generator(device=dev).manual_seed(9)
    (H, K, Dh), W = heads, window

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    sets = []
    rows_read = rows_inactive = 0
    for table, lens, active in snapshots:
        S = lens.shape[0]
        sets.append((rnd(S, H, Dh), rnd(S, K, Dh), rnd(S, K, Dh), rnd(pool, bt, K, Dh), rnd(pool, bt, K, Dh),
                     table, lens, rnd(W, S, K, Dh), rnd(W, S, K, Dh), W - 1))
        rows = lens.long().clamp(max=table.shape[1] * bt)
        rows_read += int(rows.sum())
        rows_inactive += int(rows[~active[:S].bool()].sum())
    err = max(_check_paged(f"paged engine snapshot {i}", a) for i, a in enumerate(sets))
    record["max_abs_err"] = max(record["max_abs_err"], err)
    t = _time_paged(sets)
    widths = sorted({int(a[5].shape[1]) for a in sets})
    _log_paged_times(f"on the paged engine's own tables and lengths ({len(sets)} snapshots, table widths {widths}, "
                     f"W={W} step={W - 1}, H={H} K={K}, {grid_note(slots, K, widths[-1] * bt)} at the widest)", t)
    share = rows_inactive / max(1, rows_read)
    log(f"paged engine snapshots: {rows_inactive} of the {rows_read} cache rows kernel #5 reads belong to "
        f"inactive slots (share {share:.3f}), stale lengths capped at the table's width")
    record.update(t)
    record["kernel_ms"] = t["ms"]
    record["snapshot_widths"] = widths
    record["inactive_row_share"] = share


def _gqa_inputs(gen, B, Lq, Lkv, H, K, Dh, segs, dev, q_offset=None):
    """``segs``: a number of equal segments over the row, their lengths, or
    (a numpy array) the id of every position. The queries are the row's
    last ``Lq`` positions, or those from ``q_offset`` (a cp rank's slice
    against the gathered keys)."""
    bf = torch.bfloat16
    q = torch.randn((B, Lq, H, Dh), generator=gen, device=dev).to(bf)
    k = torch.randn((B, Lkv, K, Dh), generator=gen, device=dev).to(bf)
    v = torch.randn((B, Lkv, K, Dh), generator=gen, device=dev).to(bf)
    if isinstance(segs, np.ndarray):
        check(segs.shape == (Lkv,), f"segment ids of shape {segs.shape} do not cover {Lkv}")
        seg = torch.from_numpy(segs.astype(np.int32)).to(dev)
    elif isinstance(segs, int):
        seg = (torch.arange(Lkv, device=dev) * segs // Lkv).to(torch.int32)
    else:
        check(sum(segs) == Lkv, f"segment lengths {segs} do not cover {Lkv}")
        seg = torch.repeat_interleave(torch.arange(len(segs), dtype=torch.int32, device=dev),
                                      torch.tensor(segs, device=dev))
    kv_seg = seg[None].expand(B, Lkv).contiguous()
    q_off = Lkv - Lq if q_offset is None else q_offset
    q_seg = kv_seg[:, q_off : q_off + Lq].contiguous()
    return q, k, v, q_seg, kv_seg, q_off


def _extend_inputs(gen, Lt, Pfx, prefix_lens, H, K, Dh, dev):
    """Kernel #2's inputs as ``forward_extend`` gives them: B = len(prefix_lens)
    tails of Lt queries at q_offset = Pfx against [padded prefix | tail]
    keys, the prefix pad in segment 1 between the valid prefix and the tail
    in segment 0."""
    bf, B = torch.bfloat16, len(prefix_lens)
    q = torch.randn((B, Lt, H, Dh), generator=gen, device=dev).to(bf)
    k = torch.randn((B, Pfx + Lt, K, Dh), generator=gen, device=dev).to(bf)
    v = torch.randn((B, Pfx + Lt, K, Dh), generator=gen, device=dev).to(bf)
    q_seg, kv_seg = extend_segments(torch.tensor(prefix_lens, device=dev), Pfx, Lt)
    return q, k, v, q_seg, kv_seg, Pfx


def _gqa_work(q, k, q_seg, kv_seg, q_offset):
    """Bytes in and out, and flops over the visible (query, key) pairs. K
    and V count only the keys that some query of their batch row sees; q,
    out, lse and every id count in full."""
    B, Lq, H, Dh = q.shape
    Lkv, K = k.shape[1], k.shape[2]
    i = torch.arange(Lq, device=q.device)[:, None] + q_offset
    j = torch.arange(Lkv, device=q.device)[None, :]
    mask = (i >= j)[None] & (q_seg[:, :, None] == kv_seg[:, None, :])  # [B, Lq, Lkv]
    visible = mask.sum().item()
    seen_keys = mask.any(1).sum().item()
    n_bytes = (2 * q.numel() * 2 + 2 * seen_keys * K * Dh * 2 + B * Lq * H * 4
               + 4 * (q_seg.numel() + kv_seg.numel()))
    return n_bytes, 4 * H * Dh * visible, visible


def gqa_grid(args) -> str:
    """Kernel #2's grid and cluster for ``args``."""
    B, Lq, H, Dh = args[0].shape
    Lkv, K = args[1].shape[1], args[1].shape[2]
    S = gattn.fwd_splits(B, Lq, Lkv, K, H // K, Dh)
    return f"grid ({-(-Lq * (H // K) // gattn.TILE)}, {B * K}, {S}), cluster (1, 1, {S})"


def _check_gqa_forward(label, args, masked_row=None, plain=gattn.mha_packed_gqa_plain) -> float:
    """Kernel #2 against its plain version on ``args`` (``plain``: the whole
    version, or its blocked form on rows whose scores would not fit) and
    bit for bit against a second call; ``masked_row`` (b, i) must get out 0
    and lse -1e30. Returns the out error."""
    out, lse = gattn.mha_packed_gqa(*args)
    torch.cuda.synchronize()
    ref_out, ref_lse = plain(*args)
    e_out = (out.float() - ref_out.float()).abs().max().item()
    e_rel = row_rel_err(out, ref_out, 2)
    e_lse = (lse - ref_lse).abs().max().item()
    again = gattn.mha_packed_gqa(*args)
    repeat = torch.equal(again[0], out) and torch.equal(again[1], lse)
    log(f"gqa kernel vs plain, {label}, {gqa_grid(args)}: out max abs err {e_out:.3e} (tolerance "
        f"{GQA_OUT_ATOL}), row relative {e_rel:.3e} (tolerance {OUT_ROW_RTOL}), lse {e_lse:.3e} (tolerance "
        f"{GQA_LSE_ATOL}); a second call bit for bit: {repeat}")
    check(math.isfinite(e_out) and e_out <= GQA_OUT_ATOL and e_rel <= OUT_ROW_RTOL, f"gqa out disagrees ({label})")
    check(math.isfinite(e_lse) and e_lse <= GQA_LSE_ATOL, f"gqa lse disagrees ({label})")
    check(repeat, f"gqa forward is not deterministic ({label})")
    if masked_row is not None:
        check(bool((lse[masked_row] == -1e30).all() and (out[masked_row] == 0).all()),
              f"a fully masked query row must get out 0 and lse -1e30 ({label})")
    return e_out


def _time_gqa_forward(label, args, make, dev, plain_by_events=False, plain=gattn.mha_packed_gqa_plain) -> dict:
    """Kernel #2's time on ``args`` (and more sets from ``make`` past the
    L2), the plain version's, one masked SDPA call's and the bound.
    ``plain_by_events`` times the plain version (``plain``: blocked on rows
    whose scores would not fit) without a CUDA graph, for rows whose fp32
    scores are gigabytes."""
    H, Dh, K = args[0].shape[2], args[0].shape[3], args[1].shape[2]
    Lq, Lkv = args[0].shape[1], args[1].shape[1]
    n_bytes, flops, visible = _gqa_work(args[0], args[1], args[3], args[4], args[5])
    sets = [args] + [make() for _ in range(n_sets(n_bytes) - 1)]
    kernel_ms = time_ms([lambda a=a: gattn.mha_packed_gqa(*a) for a in sets])
    if plain_by_events:
        plain_ms = time_events_ms(lambda: plain(*args), 2)
    else:
        plain_ms = time_ms([lambda a=a: plain(*a) for a in sets[:2]], 10)
    lib_sets = []
    for q, k, v, q_seg, kv_seg, q_off in sets:
        i = torch.arange(Lq, device=dev)[:, None] + q_off
        j = torch.arange(Lkv, device=dev)[None, :]
        mask = ((i >= j)[None] & (q_seg[:, :, None] == kv_seg[:, None, :]))[:, None]
        lib_sets.append((q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask))
    library_ms = time_ms([
        lambda a=a: F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3], enable_gqa=True)
        for a in lib_sets
    ])
    bound_ms, bound_by = bound(n_bytes, flops)
    log(f"gqa kernel {label} (H={H} K={K} Dh={Dh}, {visible} visible pairs, {gqa_grid(args)}): "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), roofline share {bound_ms / kernel_ms:.3f}")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_gqa_kernel(dev, ptxas: str) -> dict:
    """Kernel #2 against its plain version at every shape the main paths
    give it and at the edges of its design; its build; its times, SDPA's
    and its bound at seven shapes. The prefill shape is the record's own;
    the q_offset row, the forward_extend tail, the training row, a partial
    batch of extends and a resumed turn (both cluster splits) sit beside
    it."""
    H, K, Dh = QWEN05B.num_heads, QWEN05B.num_kv_heads, 64
    gen = torch.Generator(device=dev).manual_seed(2)
    timed = [  # (label, record key, inputs)
        ("prefill B=8 L=128", None, lambda: _gqa_inputs(gen, 8, BUCKET, BUCKET, H, K, Dh, 1, dev)),
        ("packed L=2048, 8 segments", None, lambda: _gqa_inputs(gen, 1, 2048, 2048, H, K, Dh, 8, dev)),
        ("q_offset=384, Lq=256 < Lkv=640", "offset_shape", lambda: _gqa_inputs(gen, 2, 256, 640, H, K, Dh, 3, dev)),
        ("forward_extend tail B=8 Lt=128 at q_offset 512, prefix lengths 384", "extend_tail_shape",
         lambda: _extend_inputs(gen, 128, 4 * 128, [384] * 8, H, K, Dh, dev)),
        ("training row L=4096, 8 segments", "train_shape", lambda: _gqa_inputs(gen, 1, TRAIN_L, TRAIN_L, H, K, Dh, 8, dev)),
        # short grids over long spans, where fwd_splits splits: a partial
        # batch of the paged engine's extends, and a slab turn resumed deep in
        # a long conversation
        ("forward_extend tail B=1 Lt=128 at q_offset 2048, prefix length 1920", "partial_extend_shape",
         lambda: _extend_inputs(gen, 128, 16 * 128, [15 * 128], H, K, Dh, dev)),
        ("resumed turn B=1 Lt=128 at q_offset 3968, one segment", "resumed_turn_shape",
         lambda: _gqa_inputs(gen, 1, 128, TRAIN_L, H, K, Dh, 1, dev)),
        # the slab multi-turn phase's shapes: a third turn's tails resuming
        # parked slots (transcripts of 487 tokens in a 512 bucket), and
        # score_tokens on a third-turn transcript (568 tokens, bucket 1024)
        ("slab extend tail B=8 Lt=128 at q_offset 512, prefix lengths 487", "slab_extend_shape",
         lambda: _extend_inputs(gen, 128, 4 * 128, [487] * 8, H, K, Dh, dev)),
        ("score_tokens B=1 L=1024, one segment", "score_shape",
         lambda: _gqa_inputs(gen, 1, 1024, 1024, H, K, Dh, 1, dev)),
        # the math preset's (phase 18) smallest prefill bucket, which holds
        # its prompts, at the largest prefill batch
        ("math prefill B=8 L=256", "math_prefill_shape", lambda: _gqa_inputs(gen, 8, 256, 256, H, K, Dh, 1, dev)),
    ]
    for Dc, symbol in ((64, "gqa_fwd_kernelILi64E"), (128, "gqa_fwd_kernelILi128E")):
        info = gattn.fwd_kernel_info(Dc)
        log(f"gqa forward kernel, Dh={Dc}: {ptxas_entry(ptxas, symbol)}; card: {info['registers']} registers, "
            f"{info['local_bytes']} local bytes, {info['smem_bytes']} bytes of dynamic shared memory, "
            f"{info['blocks_per_sm']} blocks per SM")
        check(info["local_bytes"] == 0, f"gqa forward kernel at Dh={Dc} spills")
        check(info["blocks_per_sm"] == gattn.FWD_BLOCKS_PER_SM[Dc],
              f"fwd_splits counts {gattn.FWD_BLOCKS_PER_SM[Dc]} resident blocks per SM at Dh={Dc}, the card "
              f"holds {info['blocks_per_sm']}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    check(sms == gattn.SM_COUNT, f"fwd_splits counts {gattn.SM_COUNT} SMs, the card has {sms}")
    # the bandit_tpu loop's shapes, checked only: its engine's prefill
    # buckets at the largest prefill batch, and its trainer's packed row
    b, L = BANDIT, BANDIT["seq_length"]
    bandit_cases = [(f"bandit_tpu prefill B=8 L={Lb}", 8, Lb, Lb, 1) for Lb in b["buckets"]]
    bandit_cases.append((f"bandit_tpu training row L={L}, {len(BANDIT_ROW)} segments", 1, L, L, BANDIT_ROW))
    max_err = 0.0
    for label, B, Lq, Lkv, segs in bandit_cases:
        args = _gqa_inputs(gen, B, Lq, Lkv, b["H"], b["K"], b["Dh"], segs, dev)
        max_err = max(max_err, _check_gqa_forward(f"{label} (H={b['H']} K={b['K']} Dh={b['Dh']})", args))
    # checked only, at the paged phases' shapes: the paged engine's prefill
    # buckets at the largest batch, and the prefix-cache phase's tails
    for Lb in P_BUCKETS:
        args = _gqa_inputs(gen, 8, Lb, Lb, H, K, Dh, 1, dev)
        max_err = max(max_err, _check_gqa_forward(f"paged engine prefill B=8 L={Lb}", args))
    for tail, prefix_lens in ((128, [384] * 8), (256, [384, 128, 512, 256, 384, 384, 512, 256]), (128, [407] * 8)):
        args = _extend_inputs(gen, tail, 4 * 128, prefix_lens, H, K, Dh, dev)
        max_err = max(max_err, _check_gqa_forward(
            f"forward_extend tail {tail} against a 512-token padded prefix, prefix lengths {prefix_lens}", args))
    # the engine's partial batches of extends (fewer than 8 of one tail and
    # page bucket), where fwd_splits splits: page buckets of 8 and 16
    for B, pages in ((1, 16), (2, 16), (4, 8)):
        args = _extend_inputs(gen, 128, pages * 128, [(pages - 1) * 128] * B, H, K, Dh, dev)
        max_err = max(max_err, _check_gqa_forward(
            f"forward_extend tail 128, B={B}, against a {pages * 128}-token padded prefix", args))
    # the design's edges: unsorted ids, a fully masked row, Dh 128, and
    # lengths that are not multiples of 64 at every cluster size
    for label, B, Lq, Lkv, segs in (
            ("unsorted segment ids, L=4096, 8 segments shuffled, 1 id in 64 stray", 1, TRAIN_L, TRAIN_L,
             unsorted_segments(TRAIN_L, 8, 4)),
            ("unsorted segment ids, q_offset=384, Lq=256 < Lkv=640", 2, 256, 640, unsorted_segments(640, 3, 5))):
        max_err = max(max_err, _check_gqa_forward(label, _gqa_inputs(gen, B, Lq, Lkv, H, K, Dh, segs, dev)))
    args = list(_gqa_inputs(gen, 2, 256, 640, H, K, Dh, 2, dev))
    args[3] = args[3].clone()
    args[3][1, 100] = int(args[4].max()) + 7  # no key carries it
    max_err = max(max_err, _check_gqa_forward("a fully masked query row at q_offset=384", args, (1, 100)))
    max_err = max(max_err, _check_gqa_forward("Dh=128, H=8 K=1, ragged L=1000",
                                              _gqa_inputs(gen, 2, 1000, 1000, 8, 1, 128, 3, dev)))
    auto_splits = gattn.fwd_splits
    try:
        for S in range(1, gattn.MAX_SPLITS + 1):
            gattn.fwd_splits = lambda *_, s=S: s
            for Hc, Kc, Dc in ((H, K, Dh), (8, 1, 128)):
                max_err = max(max_err, _check_gqa_forward(
                    f"split edges, Lq=201 at q_offset 576, Lkv=777, H={Hc} K={Kc} Dh={Dc}, S forced to {S}",
                    _gqa_inputs(gen, 2, 201, 777, Hc, Kc, Dc, [300, 260, 217], dev)))
    finally:
        gattn.fwd_splits = auto_splits
    record = None
    for label, key, make in timed:
        args = make()
        max_err = max(max_err, _check_gqa_forward(label, args))
        times = _time_gqa_forward(label, args, make, dev)
        if record is None:  # the prefill shape is the main path's
            record = {
                "name": "mha_packed_gqa (forward)", "route": "cuda",
                "source": "pipelinerl_tpu_torch/csrc/gqa_attention_fwd.cu",
                "replaces": "pipelinerl_tpu/ops/gqa_attention.py:54", **times, "kernel_ms": times["ms"],
            }
        if key is not None:  # another shape of the main paths, beside the prefill record
            record[key] = times
    record["max_abs_err"] = max_err
    return record


def reset_counts() -> None:
    dattn.launches = gattn.launches = gattn.dq_launches = gattn.dkv_launches = pattn.launches = 0


def counts() -> dict[str, int]:
    return kernel_launches()


def _gqa_bwd_args(gen, B, Lq, Lkv, H, K, Dh, segs, dev, masked_row=None, q_offset=None):
    """(q, k, v, q_seg, kv_seg, q_offset, scale, out, lse, do, delta), out
    and lse from kernel #2."""
    q, k, v, q_seg, kv_seg, q_off = _gqa_inputs(gen, B, Lq, Lkv, H, K, Dh, segs, dev, q_offset)
    q_seg = q_seg.clone()  # at Lq == Lkv it is kv_seg itself
    if masked_row is not None:
        q_seg[0, masked_row] = int(kv_seg.max()) + 7  # no key carries it
    out, lse = gattn.mha_packed_gqa(q, k, v, q_seg, kv_seg, q_off)
    do = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    delta = (do.float() * out.float()).sum(-1).reshape(B, Lq, K, H // K)
    return q, k, v, q_seg, kv_seg, q_off, Dh**-0.5, out, lse, do, delta


def row_rel_err(got: torch.Tensor, ref: torch.Tensor, row_dims: int) -> float:
    """The largest ||got - ref|| / ||ref|| over rows, a row being the first
    ``row_dims`` axes; a row whose reference is 0 (a fully masked query)
    reads 0 if ``got`` is 0 there too, else inf."""
    d = (got.float() - ref.float()).flatten(row_dims).norm(dim=-1)
    r = ref.float().flatten(row_dims).norm(dim=-1)
    rel = torch.where(r > 0, d / r.clamp(min=1e-30), torch.where(d > 0, math.inf, 0.0))
    return rel.max().item()


def _rel_err(got, ref) -> tuple[float, float]:
    """(max abs error, max abs error over max(1, max |ref|))."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(1.0, ref.float().abs().max().item())


def time_events_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` from CUDA events around ``iters`` calls,
    for calls that a CUDA graph cannot capture (autograd's backward)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def unsorted_segments(L: int, n: int, seed: int) -> np.ndarray:
    """Ids of n segments of random lengths (at least 16) in shuffled order,
    and one position in 64 given a random id of the n: ids that are neither
    sorted nor contiguous."""
    rng = np.random.default_rng(seed)
    ids = np.repeat(rng.permutation(n), rng.multinomial(L - 16 * n, np.ones(n) / n) + 16)
    stray = rng.choice(L, L // 64, replace=False)
    ids[stray] = rng.integers(0, n, stray.size)
    return ids


def _time_gqa_bwd(label: str, make, dev, plain_iters: int = 4,
                  plain=gattn.mha_packed_gqa_bwd_plain) -> dict[str, dict]:
    """Kernels #3 and #4 timed on ``make()``'s inputs (and more sets past the
    L2), beside the whole plain backward, the backward alone of one masked
    SDPA call, and each kernel's bound. Returns {"dq": times, "dkv": times}."""
    a = make()
    q, k, lse, q_seg, kv_seg, q_off = a[0], a[1], a[8], a[3], a[4], a[5]
    H, Lq, Lkv = q.shape[2], q.shape[1], k.shape[1]
    _, _, visible = _gqa_work(q, k, q_seg, kv_seg, q_off)
    product = 2 * q.shape[3] * H * visible  # one Dh-long product over every visible (query head, key) pair
    in_bytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + 2 * lse.numel() * 4 + 4 * (q_seg.numel() + kv_seg.numel())
    work = {"dq": (in_bytes + q.numel() * 2, 3 * product), "dkv": (in_bytes + 2 * k.numel() * 2, 4 * product)}
    sets = [a] + [make() for _ in range(n_sets(work["dq"][0]) - 1)]
    dq_ms = time_ms([lambda a=a: gattn.mha_packed_gqa_bwd_dq(*a[:7], a[8], a[10], a[9]) for a in sets])
    dkv_ms = time_ms([lambda a=a: gattn.mha_packed_gqa_bwd_dkv(*a[:7], a[8], a[10], a[9]) for a in sets])
    del sets
    plain_ms = time_events_ms(lambda: plain(*a[:10]), plain_iters)
    # yardstick only: the backward alone of one SDPA call with a boolean mask
    i, j = torch.arange(Lq, device=dev) + q_off, torch.arange(Lkv, device=dev)
    mask = ((i[:, None] >= j[None, :])[None] & (q_seg[:, :, None] == kv_seg[:, None, :]))[:, None]
    sq, sk, sv = (t.transpose(1, 2).detach().requires_grad_() for t in a[:3])
    s_out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask, enable_gqa=True)
    s_do = a[9].transpose(1, 2)
    library_ms = time_events_ms(lambda: torch.autograd.grad(s_out, (sq, sk, sv), s_do, retain_graph=True))
    del s_out
    least_ms, least_by = bound(in_bytes + q.numel() * 2 + 2 * k.numel() * 2, 5 * product)
    log(f"gqa backward, {label} (H={H} K={k.shape[2]} Dh={q.shape[3]}, {visible} visible pairs): least work of a "
        f"flash backward 5 products = {5 * product / 1e9:.2f} GFLOP, the dq + dk/dv split computes 7 = "
        f"{7 * product / 1e9:.2f} GFLOP; bound of the whole backward {least_ms:.4f} ms ({least_by}); "
        f"dq + dkv {dq_ms + dkv_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA backward {library_ms:.4f} ms "
        f"({(dq_ms + dkv_ms) / library_ms:.3f} of it)")
    out = {}
    for name, ms in (("dq", dq_ms), ("dkv", dkv_ms)):
        bound_ms, bound_by = bound(*work[name])
        log(f"gqa backward {name} kernel, {label}: {ms:.4f} ms, plain (whole backward) {plain_ms:.4f} ms, "
            f"SDPA backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
            f"{work[name][1] / 1e9:.2f} GFLOP, {work[name][0] / 1e6:.1f} MB), roofline share {bound_ms / ms:.3f}")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by}
    return out


def phase_gqa_bwd_kernels(dev, ptxas: str) -> list[dict]:
    """Kernels #3 (dq) and #4 (dk/dv) against the plain backward, bit for bit
    against a second call, and their tile schedule against the plain one;
    the autograd function against autograd through the plain forward; the
    kernels' build and launch shapes, and their times at the training
    shape."""
    H, K = QWEN05B.num_heads, QWEN05B.num_kv_heads
    b, Lb = BANDIT, BANDIT["seq_length"]
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = [  # (label, B, Lq, Lkv, H, K, Dh, segments, fully masked query row)
        ("(a) training row L=4096, 8 segments", 1, TRAIN_L, TRAIN_L, H, K, 64, 8, None),
        ("(b) packed L=2048, 8 segments", 1, 2048, 2048, H, K, 64, 8, None),
        ("(c) q_offset=384, Lq=256 < Lkv=640", 2, 256, 640, H, K, 64, 3, None),
        ("(d) Dh=128, H=8 K=1, ragged L=1000", 2, 1000, 1000, 8, 1, 128, 3, None),
        ("(e) a fully masked query row", 1, 512, 512, H, K, 64, 2, 300),
        (f"(f) bandit_tpu training row L={Lb}, {len(BANDIT_ROW)} segments, H={b['H']} K={b['K']}",
         1, Lb, Lb, b["H"], b["K"], b["Dh"], BANDIT_ROW, None),
        ("(g) unsorted segment ids, L=4096, 8 segments shuffled, 1 id in 64 stray", 1, TRAIN_L, TRAIN_L, H, K, 64,
         unsorted_segments(TRAIN_L, 8, 4), None),
        ("(h) one 4096-token segment (the longest spans)", 1, TRAIN_L, TRAIN_L, H, K, 64, 1, None),
    ]
    max_err = {"dq": 0.0, "dkv": 0.0}
    for label, B, Lq, Lkv, Hc, Kc, Dh, n_segs, masked in cases:
        a = _gqa_bwd_args(gen, B, Lq, Lkv, Hc, Kc, Dh, n_segs, dev, masked)
        dq, dk, dv = gattn.mha_packed_gqa_bwd(*a[:10])
        torch.cuda.synchronize()
        rq, rk, rv = gattn.mha_packed_gqa_bwd_plain(*a[:10])
        errs = {n: _rel_err(g, r) for n, g, r in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv))}
        del rq, rk, rv
        G = Hc // Kc
        spans = gattn.bwd_tile_spans(a[3], a[4], a[5], G, Dh)
        same_spans = all(torch.equal(x, y) for x, y in zip(spans, gattn.bwd_tile_spans_plain(a[3], a[4], a[5], G, Dh)))
        repeat = all(torch.equal(x, y) for x, y in zip(gattn.mha_packed_gqa_bwd(*a[:10]), (dq, dk, dv)))
        visits = [int((s[..., 1] - s[..., 0] + 1).clamp(min=0).sum()) for s in spans]
        log(f"gqa backward kernels vs plain, {label}: "
            + ", ".join(f"{n} max abs err {e:.3e} ({rel:.2e} of max |ref|)" for n, (e, rel) in errs.items())
            + f" (tolerance {GQA_BWD_RTOL} of max |ref|); a second call bit for bit: {repeat}; "
            f"tile schedule = plain: {same_spans} ({visits[0]} dq and {visits[1]} dk/dv tile visits per "
            f"kv head, dk/dv split over {gattn.dkv_splits(B, Lq, Lkv, Kc, G, Dh)} blocks)")
        for n, (e, rel) in errs.items():
            check(math.isfinite(e) and rel <= GQA_BWD_RTOL, f"gqa backward {n} disagrees ({label})")
        check(repeat, f"gqa backward kernels are not deterministic ({label})")
        check(same_spans, f"the device's tile schedule differs from the plain one ({label})")
        if masked is not None:
            check(bool((a[8][0, masked] == -1e30).all() and (dq[0, masked] == 0).all()),
                  "a fully masked query row must get lse = -1e30 and zero dq")
        max_err["dq"] = max(max_err["dq"], errs["dq"][0])
        max_err["dkv"] = max(max_err["dkv"], errs["dk"][0], errs["dv"][0])

    # the autograd function (kernels #2-#4) against autograd through the
    # plain forward in fp32, at the training shape and the bandit_tpu row
    for label, shape in (("training shape", (1, TRAIN_L, TRAIN_L, H, K, 64, 8)),
                         ("bandit_tpu row", (1, Lb, Lb, b["H"], b["K"], b["Dh"], BANDIT_ROW))):
        q, k, v, q_seg, kv_seg, q_off, scale, _, _, do, _ = _gqa_bwd_args(gen, *shape, dev)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        gattn.mha_packed_gqa(*leaves, q_seg, kv_seg, q_off)[0].backward(do)
        ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
        gattn.mha_packed_gqa_plain(*ref_leaves, q_seg, kv_seg, q_off, scale)[0].backward(do.float())
        errs = [_rel_err(x.grad, r.grad) for x, r in zip(leaves, ref_leaves)]
        del ref_leaves
        log(f"gqa autograd function vs autograd through the plain forward (fp32), {label}: "
            + ", ".join(f"d{n} {e:.3e} ({rel:.2e} of max |ref|)" for n, (e, rel) in zip("qkv", errs))
            + f" (tolerance {GQA_BWD_RTOL})")
        check(all(rel <= GQA_BWD_RTOL for _, rel in errs), f"the autograd function's gradients disagree ({label})")

    # what each kernel is built and launched as (grid and cluster at the training shape)
    G, S = H // K, gattn.dkv_splits(1, TRAIN_L, TRAIN_L, K, H // K, 64)
    grids = {"dq": f"grid ({-(-TRAIN_L * G // gattn.TILE)}, {K}), no cluster",
             "dkv": f"grid ({-(-TRAIN_L // gattn.TILE)}, {K}, {S}), cluster (1, 1, {S})"}
    symbols = {("dq", 64): "gqa_bwd_dq_kernelILi64E", ("dq", 128): "gqa_bwd_dq_kernelILi128E",
               ("dkv", 64): "gqa_bwd_dkv_kernelILi64ELi64E", ("dkv", 128): "gqa_bwd_dkv_kernelILi128ELi32E"}
    for (name, Dh), symbol in symbols.items():
        info = gattn.bwd_kernel_info(name, Dh)
        log(f"gqa backward {name} kernel, Dh={Dh}: {grids[name]} at the training shape; {ptxas_entry(ptxas, symbol)}; "
            f"card: {info['registers']} registers, {info['local_bytes']} local bytes, "
            f"{info['smem_bytes']} bytes of dynamic shared memory, {info['blocks_per_sm']} blocks per SM")
        check(info["local_bytes"] == 0, f"gqa backward {name} kernel at Dh={Dh} spills")

    # times at the training shape
    t = _time_gqa_bwd("training shape", lambda: _gqa_bwd_args(gen, 1, TRAIN_L, TRAIN_L, H, K, 64, 8, dev), dev)
    check(t["dq"]["ms"] + t["dkv"]["ms"] < t["dq"]["library_ms"],
          "dq + dk/dv is not faster than one SDPA backward in the same call")
    records = []
    for name, src_line, what in (("dq", 225, "_bwd_dq_kernel"), ("dkv", 302, "_bwd_dkv_kernel")):
        records.append({
            "name": f"mha_packed_gqa_bwd_{name} ({what})", "route": "cuda",
            "source": "pipelinerl_tpu_torch/csrc/gqa_attention_bwd.cu",
            "replaces": f"pipelinerl_tpu/ops/gqa_attention.py:{src_line}",
            "max_abs_err": max_err[name], **t[name], "kernel_ms": t[name]["ms"],
        })
    return records


def _train_batch(L: int) -> TrainerBatch:
    """bench.py's training row (bench.py:776-792): one packed row of 8
    segments, every token labelled, advantages 1."""
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 100_000, (1, L)).astype(np.int32)
    seg_len = L // 8
    ones = np.ones((1, L), np.float32)
    return TrainerBatch(
        input_ids=ids, labels=ids, position_ids=(np.arange(L) % seg_len)[None],
        segment_ids=(np.arange(L) // seg_len)[None], rewards=ones, advantages=ones,
        ref_logprobs=0 * ones, old_logprobs=-ones, group_tokens=seg_len * ones, num_labels=seg_len * ones,
        overflow=0 * ones, num_sequences=8,
    )


def phase_train_step(dev, smi: str, exp_dir: str) -> tuple[TrainerLoop, dict]:
    """A full-width Qwen2.5-0.5B train step through the port's TrainerLoop,
    with bench.py's training settings (bench.py:760-826): reinforce,
    batch_size 8, max_segments 64, AdamW at lr 1e-5, per-layer remat."""
    cfg = compose("base", [
        f"output_dir={exp_dir}", f"finetune.seq_length={TRAIN_L}", "finetune.rl.policy_loss=reinforce",
        "finetune.rl.batch_size=8", "finetune.rl.max_segments=64", "finetune.learning_rate=1e-5",
        "finetune.num_warmup_steps=0", "finetune.weight_decay=1e-4", "finetune.gradient_clipping_threshold=null",
        "finetune.gradient_checkpointing=true", "finetune.param_dtype=bfloat16", "finetune.save_checkpoint_steps=0",
    ])
    params = init_params(torch.Generator(device=dev).manual_seed(0), QWEN05B, dev)
    n_params = sum(p.numel() for _, p in param_leaves(params))
    trainer = TrainerLoop(cfg, params, QWEN05B, exp_dir)
    check(trainer.attn_impl == "gqa" and trainer.remat is True, f"auto picked {trainer.attn_impl}")
    batch = _train_batch(TRAIN_L)
    initial = {name: p.detach().clone() for name, p in param_leaves(params)}
    L = QWEN05B.num_layers
    per_pass = {"gqa_fwd": 2 * L, "gqa_dq": L, "gqa_dkv": L, "decode": 0, "paged": 0}  # forward + remat recompute

    def one_pass(impl: str) -> tuple[dict, dict, dict]:
        trainer.attn_impl = impl
        reset_counts()
        metrics = trainer.train_pass(batch)
        grads = {name: p.grad.float() for name, p in param_leaves(trainer.params)}
        trainer.zero_grad()
        return metrics, grads, counts()

    # gradient parity at full width: the kernels against the plain attention
    m_gqa, g_gqa, c_gqa = one_pass("gqa")
    m_xla, g_xla, c_xla = one_pass("xla")
    ref_norms = {name: g.norm().item() for name, g in g_xla.items()}
    rel = {name: ((g_gqa[name] - g_xla[name]).norm() / g_xla[name].norm().clamp(min=1e-30)).item() for name in g_xla}
    log(f"train pass, gqa vs xla attention on the same weights (L={TRAIN_L}): loss {m_gqa['loss']:.6f} vs "
        f"{m_xla['loss']:.6f}; per-tensor relative L2 error of the gradients (reference norm, rms per entry): "
        + ", ".join(f"{n} {rel[n]:.2e} ({ref_norms[n]:.3e}, {ref_norms[n] / g_xla[n].numel() ** 0.5:.2e})"
                    for n in sorted(rel, key=lambda n: -rel[n]))
        + f" (tolerance {TRAIN_GRAD_REL_L2})")
    check(max(rel.values()) <= TRAIN_GRAD_REL_L2, "train gradients with the kernels disagree with the plain attention")
    check(c_gqa == per_pass, f"gqa pass launches {c_gqa} != {per_pass}")
    check(not any(c_xla.values()), f"the plain pass launched kernels {c_xla}")
    del g_gqa, g_xla
    _, _, c_flash = one_pass("flash")
    check(c_flash == per_pass, f"flash pass launches {c_flash} != {per_pass}")
    log(f"launches per train pass: gqa {c_gqa}, flash {c_flash}: kernel #2 runs twice per layer "
        f"(forward and the remat recompute), #3 and #4 once per layer")

    trainer.attn_impl = "gqa"
    times, losses, norms = [], [], []
    reset_counts()
    for _ in range(1 + TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        metrics = trainer.train_pass(batch)
        trainer.optimizer_step()
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        losses.append(metrics["loss"])
        norms.append(trainer.metrics.grad_norm)
    launches = counts()
    check(launches == {k: v * (1 + TRAIN_STEPS) for k, v in per_pass.items()}, f"train launches {launches}")
    check(all(math.isfinite(x) for x in losses + norms) and min(norms) > 0, f"loss {losses}, grad norm {norms}")
    changed = sum(not torch.equal(p.detach(), initial[name]) for name, p in param_leaves(trainer.params))
    check(changed > 0, "no parameter changed")
    step_s = statistics.median(times[1:])
    tok_s = TRAIN_L / step_s
    mfu = 6 * n_params * TRAIN_L / (PEAK_BF16_FLOPS * step_s)
    log(f"train step (TrainerLoop, Qwen2.5-0.5B, {n_params} params, L={TRAIN_L}, remat, gqa kernels): "
        f"{step_s * 1e3:.1f} ms median of {TRAIN_STEPS} after warm-up ({', '.join(f'{t * 1e3:.1f}' for t in times)} ms), "
        f"{tok_s:.0f} tokens/s, train MFU {mfu:.4f} (6 N tokens / 989 TFLOP/s) on {smi}; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, grad norm {norms[0]:.4f} -> {norms[-1]:.4f}, "
        f"{changed} of {len(initial)} tensors changed, peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del initial
    profile_train_step(trainer, batch)
    return trainer, launches


def profile_train_step(trainer: TrainerLoop, batch: TrainerBatch) -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        trainer.train_pass(batch)
        trainer.optimizer_step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    report_profile(prof, wall_ms, 1, "train step")


def report_profile(prof, wall_ms: float, n_steps: int, label: str) -> None:
    """Device busy share and the top device kernels of a profiled window."""
    from torch.autograd import DeviceType

    # device events, without the user annotations (an optimizer's step range
    # on the device timeline) that overlap the kernels they enclose
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        log(f"{label} profile: the profiler saw no device time (not measured)")
        return
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    log(f"{label} profile: {n_steps} steps in {wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms "
        f"(share {busy_ms / wall_ms:.3f}), {busy_ms / n_steps:.3f} device ms per step")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3 / n_steps:8.4f} ms/step  {e.count // n_steps:5d}/step  {e.key[:90]}")
    for what, pattern in (("decode attention (kernel #1 or #5 with its split merge)",
                           r"decode_attention_kernel|merge_splits_kernel"),
                          ("GQA forward (kernel #2)", r"gqa_fwd_kernel"),
                          ("GQA backward (kernels #3 and #4)", r"gqa_bwd_dq_kernel|gqa_bwd_dkv_kernel")):
        attn = [e for e in kernels if re.search(pattern, e.key)]
        if attn:
            log(f"{label} profile: {what} {sum(e.self_device_time_total for e in attn) / 1e3 / n_steps:.4f} "
                f"ms/step in {sum(e.count for e in attn) // n_steps} launches/step")


def phase_rl_loop(exp_dir: str, paged: bool = False) -> dict:
    """The bandit RL loop through the port's entry point, every attention on
    the kernels, the preset's 60 steps; it must learn
    (tests/test_e2e_bandit.py:43-58). At 30 steps a run failed the gate
    (paged, 0.579 -> 0.477; a split run of phase 17, 0.573 -> 0.642).
    ``paged`` runs its engine on the paged layout in 16-token pages (kernel
    #5 in place of #1)."""
    layout = ["engine.kv_layout=paged", "engine.kv_block_size=16"] if paged else []
    reset_counts()
    t0 = time.monotonic()
    stats = launch.main(["--config-name=bandit_tpu", f"output_dir={exp_dir}", "finetune.save_checkpoint_steps=0",
                         "engine.attn_impl=gqa", "finetune.attn_impl=gqa",
                         *layout])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = counts()
    snaps = list(StreamReader(SingleStreamSpec(exp_dir, "stats")).read_available())
    rewards = [s["reward_mean"] for s in snaps if "reward_mean" in s]
    successes = [s["success_mean"] for s in snaps if "success_mean" in s]
    check(len(rewards) >= 4, f"too few stats snapshots: {rewards}")
    early, late = sum(rewards[:2]) / 2, sum(rewards[-2:]) / 2
    # the gate reads the reward; whether the run ends on the target letter
    # (success 1.0 in the last snapshot) is reported beside it
    log(f"bandit_tpu RL loop through launch.main ({'paged, BT 16' if paged else 'slab'}): {wall:.1f} s wall, {stats['trainer']['completed_steps']} steps, "
        f"version {stats['trainer']['last_broadcasted_version']}, reward {early:.3f} -> {late:.3f} "
        f"(snapshots {[round(r, 3) for r in rewards]}), success snapshots {[round(x, 3) for x in successes]}, "
        f"success tail {stats['actor'].get('success_tail_mean')}, ends on the target: "
        f"{'yes' if successes and successes[-1] == 1.0 else 'no'}, launches {launches}")
    check(stats["trainer"]["completed_steps"] >= 10, "the RL loop trained fewer than 10 steps")
    check(stats["trainer"]["last_broadcasted_version"] > 0, "the RL loop pushed no weights")
    check(late > early + 0.1, f"the RL loop did not learn: reward {early:.3f} -> {late:.3f}")
    decode_kernel, unused = ("paged", "decode") if paged else ("decode", "paged")
    check(all(launches[k] for k in ("gqa_fwd", "gqa_dq", "gqa_dkv", decode_kernel)) and not launches[unused],
          f"the RL loop's kernel launches are wrong: {launches}")
    check(stats["engine"].get("kv_pages_total", 0) > 0 if paged else "kv_pages_total" not in stats["engine"],
          f"the RL loop's engine ran the wrong layout: {stats['engine']}")
    return launches


def spy_launch_builds() -> tuple[list, dict, Callable[[], None]]:
    """Wrap ``launch.build_model`` and ``launch.build_engine`` to record
    what a run builds: the trainer's parameters, then each engine in build
    order, and a copy of the initial weights. Returns (built, initial,
    restore)."""
    built, initial = [], {}
    build_model, build_engine = launch.build_model, launch.build_engine

    def spy_model(*args, **kw):
        out = build_model(*args, **kw)
        initial.update({name: p.detach().clone() for name, p in param_leaves(out[0])})
        built.append(out[0])
        return out

    def spy_engine(*args, **kw):
        built.append(build_engine(*args, **kw))
        return built[-1]

    def restore():
        launch.build_model, launch.build_engine = build_model, build_engine

    launch.build_model, launch.build_engine = spy_model, spy_engine
    return built, initial, restore


def phase_rl_loop_kl(exp_dir: str) -> dict:
    """The bandit RL loop with the ``ppo`` finetune group's KL penalty
    (kl_coef 0.1 against a reference engine on the initial weights),
    shortened to 20 steps, every attention on the kernels. The reward curve
    is reported, not gated (the JAX package does not gate its KL run on
    learning)."""
    built, initial, restore = spy_launch_builds()
    reset_counts()
    t0 = time.monotonic()
    try:
        stats = launch.main(["--config-name=bandit_tpu", f"output_dir={exp_dir}", "finetune=ppo",
                             "finetune.save_checkpoint_steps=0", "finetune.max_train_steps=20", "total_groups=200",
                             "engine.attn_impl=gqa", "finetune.attn_impl=gqa"])
    finally:
        restore()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = counts()
    trained, policy, ref = built
    with open(f"{exp_dir}/metrics/trainer_0.jsonl") as f:
        steps = [json.loads(line) for line in f]
    kls, coefs = [s["rl/kl"] for s in steps], {s["rl/kl_coef"] for s in steps}
    snaps = list(StreamReader(SingleStreamSpec(exp_dir, "stats")).read_available())
    rewards = [round(s["reward_mean"], 3) for s in snaps if "reward_mean" in s]
    log(f"bandit_tpu RL loop with the ppo group's KL (kl_coef {sorted(coefs)}) through launch.main: {wall:.1f} s "
        f"wall, {stats['trainer']['completed_steps']} steps, version {stats['trainer']['last_broadcasted_version']}, "
        f"kl per step {[float(f'{k:.3g}') for k in kls]}, reward snapshots {rewards}, launches {launches}")
    check(stats["trainer"]["completed_steps"] >= 10, "the KL loop trained fewer than 10 steps")
    # a step's stats are sums over its micro-batches, kl_coef included
    check(all(round(c / 0.1) >= 1 and abs(c / 0.1 - round(c / 0.1)) < 1e-5 for c in coefs),
          f"kl_coef per step {coefs}, not micro-batch sums of the ppo group's 0.1")
    check(all(math.isfinite(k) for k in kls) and all(k > 0 for k in kls[1:]), f"kl per step {kls}")
    check(ref.version == 0 and policy.version > 0, f"reference engine at version {ref.version}")
    trained = dict(param_leaves(trained))
    check(all(torch.equal(t, initial[name]) and
              t.untyped_storage().data_ptr() != trained[name].untyped_storage().data_ptr()
              for name, t in param_leaves(ref.params)),
          "the reference engine's weights are not an untouched copy of the initial ones")
    check(any(not torch.equal(trained[name].detach(), initial[name]) for name in initial), "the trainer did not move")
    check(all(launches[k] for k in ("gqa_fwd", "gqa_dq", "gqa_dkv", "decode")) and not launches["paged"],
          f"the KL loop's kernel launches are wrong: {launches}")
    log("KL loop: the reference engine stayed at version 0 on the initial weights, in storage the trainer never held")
    return launches


def phase_guessing(exp_dir: str) -> dict:
    """The ``guessing`` preset on the toy model (widened to Dh 64, the GQA
    kernels' head size) through ``launch.main``: up to 4 groups of 64
    attempts, 2 train steps of 64 samples (the run ends at its last step, so
    2 groups usually complete). A random model rarely answers in the format,
    so most rollouts end at turn 0; every sample must carry its own turn's
    prompt."""
    reset_counts()
    t0 = time.monotonic()
    stats = launch.main(["--config-name=guessing", "model_path=toy", f"output_dir={exp_dir}",
                         "toy_model.hidden_size=256", "toy_model.intermediate_size=512", "total_groups=4",
                         "finetune.samples_per_step=64", "finetune.max_train_steps=2",
                         "finetune.save_checkpoint_steps=0", "engine.attn_impl=gqa", "finetune.attn_impl=gqa"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = counts()
    actor = stats["actor"]
    tok = ToyTokenizer()
    turns = {}
    for group in StreamReader(SingleStreamSpec(exp_dir, "actor")).read_available():
        for sample in group["samples"]:
            n_prompt = sum(1 for label in sample["labels"] if label == -100)
            prompt = tok.decode(sample["input_ids"][:n_prompt])
            step = sample["step_index"]
            check("You must guess a number between 1 and 1024" in prompt
                  and (step == 0 or f"Your {step} previous guesses:" in prompt),
                  f"a sample of turn {step} does not carry its turn's prompt")
            key = (group["group_id"], sample["rollout_index"])
            turns[key] = max(turns.get(key, 0), step + 1)
    log(f"guessing (toy model, Dh 64) through launch.main: {wall:.1f} s wall, {actor['groups_completed']} groups, "
        f"{actor['rollouts_completed']} rollouts, {actor['samples_written']} samples (turns per rollout "
        f"{sorted(set(turns.values()))}), reward mean {actor.get('reward_mean')}, "
        f"{stats['trainer']['completed_steps']} train steps, launches {launches}")
    check(actor["groups_completed"] >= 2 and actor["rollouts_completed"] == 64 * actor["groups_completed"],
          f"actor stats {actor}")
    check(actor["samples_written"] == sum(turns.values()) >= actor["rollouts_completed"], "samples and turns differ")
    check(stats["trainer"]["completed_steps"] == 2, "the guessing run did not train")
    check(all(launches[k] for k in ("gqa_fwd", "gqa_dq", "gqa_dkv", "decode")), f"guessing launches {launches}")
    return launches


def recording_trainer() -> tuple[type, list]:
    """A TrainerLoop that records what phase 14 checks: each instance, the
    trainable tensors and optimizer state as ``try_resume`` left them (a
    copy), the seconds of each save and resume, and the value head's
    gradient after each pass. Returns (the class, its instances)."""
    instances: list = []

    class Recording(TrainerLoop):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.resumed = None
            self.save_s: list[float] = []
            self.resume_s = None
            self.value_grad: list[float] = []
            instances.append(self)

        def try_resume(self) -> bool:
            t0 = time.monotonic()
            resumed = super().try_resume()
            torch.cuda.synchronize()
            if resumed:
                self.resume_s = time.monotonic() - t0
                self.resumed = (self.metrics.completed_steps,
                                {name: p.detach().clone() for name, p in param_leaves(self.params)},
                                [t.clone() for t in optimizer_tensors(self)])
            return resumed

        def save_checkpoint(self, tokenizer=None) -> None:
            t0 = time.monotonic()
            super().save_checkpoint(tokenizer)
            self.save_s.append(time.monotonic() - t0)

        def train_pass(self, batch):
            out = super().train_pass(batch)
            if "value_head" in self.params:
                self.value_grad.append(self.params["value_head"]["w"].grad.abs().sum().item())
            return out

    return Recording, instances


def optimizer_tensors(trainer: TrainerLoop) -> list[torch.Tensor]:
    """Every tensor of the optimizer's state (moments and step counts), in
    its ``state_dict`` order."""
    return [t for s in trainer.optimizer.state_dict()["state"].values() for t in s.values()]


def run_recorded(argv: list[str]) -> tuple[dict, TrainerLoop, InferenceEngine, float, dict]:
    """``launch.main(argv)`` with its trainer recorded and its engines
    spied on. Returns (stats, trainer, policy engine, wall seconds, kernel
    launches)."""
    Recording, instances = recording_trainer()
    built, _, restore = spy_launch_builds()
    original = launch.TrainerLoop
    launch.TrainerLoop = Recording
    reset_counts()
    t0 = time.monotonic()
    try:
        stats = launch.main(argv)
    finally:
        launch.TrainerLoop = original
        restore()
    torch.cuda.synchronize()
    return stats, instances[0], built[1], time.monotonic() - t0, counts()


def sampled_ids(exp_dir: str) -> list[int]:
    """Every sampled token id of the run's actor stream."""
    groups = StreamReader(SingleStreamSpec(exp_dir, "actor")).read_available()
    return [i for g in groups for s in g["samples"] for i, label in zip(s["input_ids"], s["labels"]) if label != -100]


def phase_hf_checkpoint(dev, smi: str, tmp: str) -> dict[str, dict]:
    """Phase 14: the ``test`` preset from an HF directory at Qwen2.5-0.5B
    width (tied embeddings, random bf16 weights from seed 0, the committed
    fixture tokenizer, so the vocabulary is padded from 540 to 151,936),
    through ``launch.main``: write and read the directory, train and save,
    resume, read the export back, then LoRA on the same directory and
    ``finetune=actor_critic`` on the toy model. A random model's guesses
    all score -2, so leave-one-out advantages are 0: an entropy bonus of
    0.001 gives the steps a gradient, so the saved moments are not 0."""
    paths = {}
    tok = HFTokenizer(FIXTURE_TOKENIZER)
    params = init_params(torch.Generator(device=dev).manual_seed(0), QWEN05B_TIED, dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    hf_dir = export_hf(f"{tmp}/hf_in", params, QWEN05B_TIED, tok)
    write_s = time.monotonic() - t0
    size = (hf_dir / "model.safetensors").stat().st_size
    cfg = compose("test", [f"model_path={hf_dir}", f"output_dir={tmp}/unused"])
    t0 = time.monotonic()
    loaded, model_cfg, tokenizer = launch.build_model(cfg, dev)
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(param_leaves(loaded), param_leaves(params), strict=True))
    log(f"HF directory at Qwen2.5-0.5B width (tied, bf16, {sum(p.numel() for _, p in param_leaves(params))} params): "
        f"export_hf wrote {size} bytes of model.safetensors in {write_s:.2f} s ({size / write_s / 1e9:.2f} GB/s); "
        f"launch.build_model read it onto the card in {load_s:.2f} s ({size / load_s / 1e9:.2f} GB/s), "
        f"bit for bit: {same}, valid_vocab {model_cfg.valid_vocab} of {model_cfg.vocab_size}, tokenizer "
        f"{type(tokenizer).__name__} of {len(tokenizer)} entries, on {smi}")
    check(same, "the loaded checkpoint differs from the tensors written")
    check(model_cfg.valid_vocab == len(tokenizer) == 540, f"valid_vocab {model_cfg.valid_vocab}")
    del loaded
    torch.cuda.empty_cache()

    out = f"{tmp}/test_run"
    # 32 new tokens (the preset's 500; 128 before phase 27 joined the
    # smoke): every guess of a random model runs to the budget, and the
    # saves, resumes and exports do not need more
    common = ["--config-name=test", f"model_path={hf_dir}", f"output_dir={out}", "finetune.rl.entropy_bonus=0.001",
              "engine.attn_impl=gqa", "finetune.attn_impl=gqa", "llm.parameters.max_tokens=32"]
    # 2. train two steps, saving after each
    stats, first, engine, wall, launches = run_recorded([*common, "finetune.max_train_steps=2",
                                                         "finetune.save_checkpoint_steps=1"])
    paths["hf_test"] = launches
    ids = sampled_ids(out)
    state_bytes = Path(f"{out}/finetune/training_state/state.pt").stat().st_size
    actor = stats["actor"]
    with open(f"{out}/metrics/trainer_0.jsonl") as f:
        norms = [json.loads(line)["grad_norm"] for line in f]
    log(f"test preset through launch.main (2 steps, a save after each): {wall:.1f} s wall, {actor['samples_written']} "
        f"samples, {actor['output_tokens']} sampled tokens, {actor['output_tokens'] / wall:.1f} useful tokens/s, "
        f"grad norms {norms}, version {stats['trainer']['last_broadcasted_version']} (engine {engine.version}), "
        f"max sampled id {max(ids)} (valid_vocab 540), saves {[round(s, 2) for s in first.save_s]} s "
        f"(training_state {state_bytes} bytes + model.safetensors), launches {launches}, on {smi}")
    check(stats["trainer"]["completed_steps"] == 2, f"trainer {stats['trainer']}")
    check(Path(f"{out}/finetune/training_state").is_dir() and Path(f"{out}/finetune/current").is_dir(),
          "no finetune/training_state or finetune/current")
    check(all(launches[k] for k in ("decode", "gqa_fwd", "gqa_dq", "gqa_dkv")), f"test preset launches {launches}")
    check(ids and max(ids) < 540, f"a sampled id reached valid_vocab: {max(ids)}")
    check(engine.version > 0 and stats["trainer"]["last_broadcasted_version"] > 0, "the weight version did not advance")
    check(min(norms) > 0, f"grad norms {norms}")

    # 3. resume on the same output_dir: step 2's state, bit for bit
    stats, second, _, wall, launches = run_recorded([*common, "finetune.max_train_steps=3",
                                                     "finetune.save_checkpoint_steps=1"])
    check(second.resumed is not None, "the second run did not resume")
    step, resumed_params, resumed_opt = second.resumed
    same_params = all(torch.equal(resumed_params[name], p.detach()) for name, p in param_leaves(first.params))
    saved_opt = optimizer_tensors(first)
    same_opt = len(saved_opt) == len(resumed_opt) and all(torch.equal(a.cpu(), b.cpu())
                                                          for a, b in zip(resumed_opt, saved_opt))
    log(f"resume: at step {step}, params bit for bit {same_params}, optimizer state ({len(resumed_opt)} tensors) "
        f"bit for bit {same_opt}, read in {second.resume_s:.2f} s; ended at step {stats['trainer']['completed_steps']} "
        f"in {wall:.1f} s wall, launches {launches}")
    check(step == 2 and same_params and same_opt, "the resumed state differs from the one saved")
    check(stats["trainer"]["completed_steps"] == 3, f"the resumed run ended at {stats['trainer']}")
    paths["hf_test_resume"] = launches
    del first, resumed_params, resumed_opt, saved_opt
    torch.cuda.empty_cache()

    # 4. the export reads back as the trainer's final weights
    t0 = time.monotonic()
    exported, exported_cfg = load_hf_model(f"{out}/finetune/current", device=dev)
    torch.cuda.synchronize()
    read_s = time.monotonic() - t0
    final = dict(param_leaves(second.params))
    same = all(torch.equal(t, final[name].detach()) for name, t in param_leaves(exported))
    config_in = json.loads((hf_dir / "config.json").read_text())
    config_out = json.loads(Path(f"{out}/finetune/current/config.json").read_text())
    log(f"export: finetune/current read back in {read_s:.2f} s, bit for bit the trainer's final params: {same}; "
        f"config.json equal to the input's: {config_in == config_out}")
    check(same and sorted(final) == sorted(name for name, _ in param_leaves(exported)), "the export differs")
    check(config_in == config_out and exported_cfg.hf_architecture == "Qwen2ForCausalLM", "config.json differs")
    del exported, final, second
    torch.cuda.empty_cache()

    # 3b. force_restart ignores the saved state
    stats, forced, _, wall, launches = run_recorded([*common, "finetune.max_train_steps=1", "force_restart=true",
                                                     "finetune.save_checkpoint_steps=0"])
    log(f"force_restart: resumed {forced.resumed is not None}, ended at step {stats['trainer']['completed_steps']} "
        f"in {wall:.1f} s wall")
    check(forced.resumed is None and stats["trainer"]["completed_steps"] == 1, "force_restart resumed")
    paths["hf_test_resume"] = {k: v + launches[k] for k, v in paths["hf_test_resume"].items()}
    del forced
    torch.cuda.empty_cache()

    # 5a. LoRA on the same directory: the base stays, the adapters move
    stats, lora, engine, wall, launches = run_recorded([
        *common[:2], f"output_dir={tmp}/lora_run", *common[3:], "finetune.max_train_steps=1",
        "finetune.num_warmup_steps=0", "+finetune.lora.enabled=true"])
    base_same = all(torch.equal(a, b) for (_, a), (_, b) in zip(param_leaves(lora.frozen_params),
                                                               param_leaves(params), strict=True))
    moved = [name for name, p in param_leaves(lora.params) if name.endswith("_B") and p.abs().sum() > 0]
    with torch.no_grad():
        merged = merge_lora(lora.frozen_params, lora.params, lora.lora_cfg)
    pushed_same = all(torch.equal(a, b) for (_, a), (_, b) in zip(param_leaves(engine.params), param_leaves(merged),
                                                                 strict=True))
    log(f"LoRA (r {lora.lora_cfg.r}, targets {lora.lora_cfg.target_modules}): {wall:.1f} s wall, "
        f"{stats['trainer']['completed_steps']} step; base bit for bit {base_same}, adapters moved {moved}, "
        f"engine weights equal merge_lora {pushed_same} (version {engine.version}), launches {launches}")
    check(stats["trainer"]["completed_steps"] == 1 and base_same and len(moved) == len(lora.lora_cfg.target_modules)
          and pushed_same and engine.version > 0, "LoRA trained something other than its adapters")
    check(all(launches[k] for k in ("decode", "gqa_fwd", "gqa_dq", "gqa_dkv")), f"LoRA launches {launches}")
    paths["hf_lora"] = launches
    del lora, merged, engine, params
    torch.cuda.empty_cache()

    # 5b. the value head on the toy model
    stats, critic, engine, wall, launches = run_recorded([
        "--config-name=bandit_tpu", "finetune=actor_critic", f"output_dir={tmp}/actor_critic",
        "finetune.max_train_steps=1", "finetune.save_checkpoint_steps=0", "engine.attn_impl=gqa",
        "finetune.attn_impl=gqa"])
    with open(f"{tmp}/actor_critic/metrics/trainer_0.jsonl") as f:
        value_loss = [json.loads(line)["rl/value_loss"] for line in f]
    log(f"actor_critic (toy, bandit_tpu): {wall:.1f} s wall, value_loss {value_loss}, value head |grad| per pass "
        f"{[float(f'{g:.4g}') for g in critic.value_grad]}, engine without the head: "
        f"{'value_head' not in engine.params}, launches {launches}")
    check(stats["trainer"]["completed_steps"] == 1 and all(math.isfinite(v) for v in value_loss)
          and max(critic.value_grad) > 0 and "value_head" not in engine.params, "the value head did not train")
    check(all(launches[k] for k in ("decode", "gqa_fwd", "gqa_dq", "gqa_dkv")), f"actor_critic launches {launches}")
    paths["actor_critic"] = launches
    return paths


def phase_engine(dev, smi: str, trainer: TrainerLoop, exp_dir: str) -> tuple[int, int]:
    """The engine at full width; at its sixth step, with requests live, the
    phase-6 TrainerLoop pushes its trained weights through
    ``weight_update_cb = engine.update_params``."""
    cfg = QWEN05B
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    engine = InferenceEngine(
        params, cfg,
        EngineConfig(
            max_slots=SLOTS, max_len=MAX_LEN, prefill_buckets=(BUCKET,), seed=0,
            cache_dtype=torch.bfloat16, decode_window=WINDOW, window_pipeline_depth=DEPTH,
        ),
        eos_token_id=-1,  # random weights: run every request to its budget
        device=dev,
    )
    check(engine.attn_impl == "gqa" and engine.decode_attn_impl == "ragged", "auto did not pick the kernels")
    rng = np.random.default_rng(0)

    def request(prompt, rid=""):
        return GenRequest(list(prompt), SamplingParams(temperature=1.0, max_tokens=MAX_TOKENS), rid)

    def prompt():
        return rng.integers(1, min(100_000, cfg.valid_vocab), PROMPT_LEN - 1).tolist()

    reqs = [request(prompt(), "abort-me")]
    reqs += [request(prompt()) for _ in range(SLOTS)]
    for _ in range(2):
        p = prompt()
        reqs += [request(p) for _ in range(8)]

    writer = StreamWriter(SingleStreamSpec(exp_dir, "weight_update_request"))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    futures = [engine.submit(r) for r in reqs]
    n_steps, updated, aborted = 0, False, False
    while not all(f.done() for f in futures):
        engine.step()
        n_steps += 1
        if n_steps == 3:
            check(any(s is not None and s.request.request_id == "abort-me" for s in engine._slots),
                  "the request to abort is not in flight")
            engine.abort("abort-me")
            aborted = True
        if n_steps == 6:
            check(engine.num_active > 0, "no live request at the weight update")
            trainer.weight_update_cb = engine.update_params
            updated = trainer.maybe_push_weights(writer, force=True)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = counts()
    decode_launches, gqa_launches = launches["decode"], launches["gqa_fwd"]
    counters = engine.perf_counters()
    results = [f.result() for f in futures]

    check(aborted and updated, "the abort or the weight update did not happen")
    check(results[0].finish_reason == "abort", f"aborted request finished {results[0].finish_reason}")
    for r in results[1:]:
        check(r.finish_reason == "length" and len(r.token_ids) == MAX_TOKENS,
              f"request finished {r.finish_reason} with {len(r.token_ids)} tokens")
    for r in results:
        lp = np.asarray(r.logprobs, np.float64)
        check(len(lp) == len(r.token_ids), "one logprob per token")
        check(bool(np.all(np.isfinite(lp)) and np.all(lp <= 0)), "logprobs finite and <= 0")
        check(all(t < cfg.valid_vocab for t in r.token_ids), "a padded-vocabulary id was emitted")
    writer.close()
    check(any(r.model_version_end > r.model_version_start for r in results),
          "no request spanned the weight update")
    check(engine.version == trainer.metrics.samples > 0, "the engine does not run the pushed version")
    trained = dict(param_leaves(trainer.params))
    check(all(t.data_ptr() != trained[name].data_ptr() and torch.equal(t, trained[name].detach())
              for name, t in param_leaves(engine.params)),
          "the engine's weights are not equal copies of the trainer's")
    pushed = [m["version"] for m in StreamReader(SingleStreamSpec(exp_dir, "weight_update_request")).read_available()]
    log(f"weight push: version {engine.version} = trained samples, live requests spanned it, "
        f"engine tensors are copies (no shared storage); published versions {pushed}")
    L = cfg.num_layers
    check(decode_launches == L * engine.decode_steps,
          f"decode launches {decode_launches} != {L} x {engine.decode_steps} decode steps")
    check(gqa_launches == L * engine.prefill_batches,
          f"gqa launches {gqa_launches} != {L} x {engine.prefill_batches} prefill batches")
    check(not launches["paged"], "the slab engine launched the paged kernel")
    useful = sum(len(r.token_ids) for r in results[1:])
    log(f"engine: {len(reqs)} requests, {useful} tokens in {wall:.2f} s: {useful / wall:.1f} useful tokens/s, "
        f"{wall / engine.decode_steps * 1e3:.2f} ms per decode step (wall, prefill included) on {smi}")
    log(f"engine counters: {json.dumps(counters)}")
    log(f"engine launches: decode {decode_launches} = {L} x {engine.decode_steps} steps, "
        f"gqa {gqa_launches} = {L} x {engine.prefill_batches} prefill batches")

    # teacher forcing through the plain attention (tests/test_engine.py:96)
    errs = []
    for req, r in list(zip(reqs, results))[1:5]:
        ids = torch.tensor([req.prompt_ids + r.token_ids], device=dev)
        n, T = len(req.prompt_ids), ids.shape[1]
        with torch.no_grad():
            logits = forward(engine.params, cfg, ids, torch.arange(T, device=dev)[None],
                             torch.zeros((1, T), dtype=torch.int32, device=dev), attn_impl="xla")
        lp = torch.log_softmax(logits[0, n - 1 : T - 1], -1)
        tf = lp.gather(-1, ids[0, n:, None])[:, 0].double().cpu().numpy()
        errs.append(np.abs(tf - np.asarray(r.logprobs)))
    errs = np.concatenate(errs)
    log(f"teacher forcing: mean abs err {errs.mean():.4f} (tolerance {TF_MEAN_ATOL}), "
        f"max {errs.max():.4f} (tolerance {TF_MAX_ATOL}) over {errs.size} tokens")
    check(errs.mean() <= TF_MEAN_ATOL and errs.max() <= TF_MAX_ATOL, "engine logprobs disagree with teacher forcing")
    profile_decode(engine, [request(prompt()) for _ in range(SLOTS)])
    return launches


def teacher_forcing(engine: InferenceEngine, pairs, label: str) -> None:
    """Engine logprobs against a teacher-forced forward over prompt +
    completion through the plain attention (tests/test_engine.py:96)."""
    dev = engine.device
    errs = []
    for prompt_ids, r in pairs:
        ids = torch.tensor([list(prompt_ids) + r.token_ids], device=dev)
        n, T = len(prompt_ids), ids.shape[1]
        with torch.no_grad():
            logits = forward(engine.params, engine.model_cfg, ids, torch.arange(T, device=dev)[None],
                             torch.zeros((1, T), dtype=torch.int32, device=dev), attn_impl="xla")
        lp = torch.log_softmax(logits[0, n - 1 : T - 1], -1)
        tf = lp.gather(-1, ids[0, n:, None])[:, 0].double().cpu().numpy()
        errs.append(np.abs(tf - np.asarray(r.logprobs)))
        del logits, lp
    errs = np.concatenate(errs)
    log(f"{label} teacher forcing: mean abs err {errs.mean():.4f} (tolerance {TF_MEAN_ATOL}), "
        f"max {errs.max():.4f} (tolerance {TF_MAX_ATOL}) over {errs.size} tokens in {len(pairs)} requests")
    check(errs.mean() <= TF_MEAN_ATOL and errs.max() <= TF_MAX_ATOL,
          f"{label} logprobs disagree with teacher forcing")


def check_results(results, budgets, cfg: ModelConfig) -> None:
    """Every budget met, logprobs finite and <= 0, no padded-vocabulary id."""
    for r, budget in zip(results, budgets):
        check(r.finish_reason == "length" and len(r.token_ids) == budget,
              f"request finished {r.finish_reason} with {len(r.token_ids)} of {budget} tokens")
    for r in results:
        lp = np.asarray(r.logprobs, np.float64)
        check(len(lp) == len(r.token_ids), "one logprob per token")
        check(bool(np.all(np.isfinite(lp)) and np.all(lp <= 0)), "logprobs finite and <= 0")
        check(all(t < cfg.valid_vocab for t in r.token_ids), "a padded-vocabulary id was emitted")


def phase_paged_engine(dev, smi: str) -> dict:
    """The paged engine at Qwen2.5-0.5B width (P_LAYERS deep) with the JAX
    package's paged configuration (bench.py:577-621): long-tail requests,
    two GRPO groups of 8 whose 300-token prompts share two full pages, and
    one abort."""
    cfg = dataclasses.replace(QWEN05B, num_layers=P_LAYERS)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    engine = InferenceEngine(
        params, cfg,
        EngineConfig(
            max_slots=P_SLOTS, max_len=P_MAX_LEN, prefill_buckets=P_BUCKETS, seed=0,
            cache_dtype=torch.bfloat16, decode_window=P_WINDOW, window_pipeline_depth=2,
            kv_layout="paged", kv_block_size=P_BT, kv_pool_blocks=P_POOL, prefix_cache=False,
        ),
        eos_token_id=-1,  # random weights: run every request to its budget
        device=dev,
    )
    check(engine.paged and engine.attn_impl == "gqa" and engine.decode_attn_impl == "ragged",
          "auto did not pick the kernels")
    kv_bytes = engine.k_pool.nbytes + engine.v_pool.nbytes
    rng = np.random.default_rng(3)

    def request(n, budget, rid=""):
        prompt = rng.integers(1, 100_000, n).tolist()
        return GenRequest(prompt, SamplingParams(temperature=1.0, max_tokens=budget), rid)

    # the groups and the abort first, so each group is admitted in one wave
    reqs = [request(200, 1024, "abort-me")]
    groups = []
    for _ in range(2):
        r = request(300, 256)
        groups.append(r.prompt_ids)
        reqs += [GenRequest(r.prompt_ids, r.params) for _ in range(8)]
    reqs += [request(int(rng.integers(128, 400)), int(rng.integers(128, 1024))) for _ in range(P_REQUESTS)]
    pool = engine.block_pool
    # every fourth decode window's table, starting lengths and active mask,
    # kernel #5's inputs on this path, for time_paged_working_set
    snapshots, window_fn = [], engine_mod._decode_window_paged_fn

    def spy(*args, **kw):
        if engine.windows_dispatched % 4 == 1:
            snapshots.append((args[6], args[8].clone(), args[10].clone()))
        return window_fn(*args, **kw)

    engine_mod._decode_window_paged_fn = spy
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    futures = [engine.submit(r) for r in reqs]
    n_steps, peak, shared_checked, aborted = 0, 0, False, False
    while not all(f.done() for f in futures):
        engine.step()
        n_steps += 1
        peak = max(peak, engine.num_active)
        if not shared_checked:
            for prompt in groups:
                slots = [i for i, s in enumerate(engine._slots) if s is not None and s.request.prompt_ids == prompt]
                check(len(slots) == 8, f"a GRPO group is live in {len(slots)} slots, not 8")
                rows = pool.table[slots]
                check(all((rows[:, j] == rows[0, j]).all() and pool.refs[rows[0, j]] == 8 for j in (0, 1)),
                      "the group's two full prompt pages are not shared with refcount 8")
                check(len(set(rows[:, 2].tolist())) == 8, "the group's tail pages are not each its own")
            shared_checked = True
        if n_steps == 3:
            check(any(s is not None and s.request.request_id == "abort-me" for s in engine._slots),
                  "the request to abort is not in flight")
            engine.abort("abort-me")
            aborted = True
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    engine_mod._decode_window_paged_fn = window_fn
    launches = counts()
    counters = engine.perf_counters()
    results = [f.result() for f in futures]
    check(aborted and results[0].finish_reason == "abort", f"aborted request finished {results[0].finish_reason}")
    check_results(results[1:], [r.params.max_tokens for r in reqs[1:]], cfg)
    pool.check_invariants()
    check(pool.free_blocks == pool.n_blocks, f"{pool.n_blocks - pool.free_blocks} pages not returned")
    check(peak > 32, f"peak of active slots {peak} is not above the 32 of a slab engine at twice the bytes")
    L = cfg.num_layers
    check(launches["paged"] == L * engine.decode_steps,
          f"paged launches {launches['paged']} != {L} x {engine.decode_steps} decode steps")
    check(launches["decode"] == 0, f"kernel #1 ran on the paged engine {launches['decode']} times")
    check(launches["gqa_fwd"] == L * engine.prefill_batches,
          f"gqa launches {launches['gqa_fwd']} != {L} x {engine.prefill_batches} prefill batches")
    useful = sum(len(r.token_ids) for r in results[1:])
    log(f"paged engine: {len(reqs)} requests, {useful} tokens in {wall:.2f} s: {useful / wall:.1f} useful tokens/s, "
        f"{wall / engine.decode_steps * 1e3:.2f} ms per decode step (wall, prefill included), peak {peak} active "
        f"of {P_SLOTS} slots, KV pool {kv_bytes / 1e9:.3f} GB ({P_POOL} pages of {P_BT}) on {smi}")
    log(f"paged engine counters: {json.dumps(counters)}")
    log(f"paged engine launches: paged {launches['paged']} = {L} x {engine.decode_steps} steps, "
        f"gqa {launches['gqa_fwd']} = {L} x {engine.prefill_batches} prefill batches, decode {launches['decode']}")
    picks = [1, 9, int(np.argmax([len(r.token_ids) for r in results])), len(reqs) - 1]
    teacher_forcing(engine, [(reqs[i].prompt_ids, results[i]) for i in picks], "paged engine")
    prof_rng = np.random.default_rng(4)
    profile_decode(engine, [GenRequest(prof_rng.integers(1, 100_000, 200).tolist(),
                                       SamplingParams(temperature=1.0, max_tokens=128)) for _ in range(P_SLOTS)])
    return launches, snapshots


def multiturn_engine(dev, **layout) -> InferenceEngine:
    """The engine of the JAX package's bench_multiturn (bench.py:673-733) at
    Qwen2.5-0.5B width: S 8, max_len 2048, buckets 128-2048, W 16, depth 2."""
    cfg = QWEN05B
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    return InferenceEngine(
        params, cfg,
        EngineConfig(
            max_slots=8, max_len=2048, prefill_buckets=(128, 256, 512, 1024, 2048), seed=0,
            cache_dtype=torch.bfloat16, decode_window=16, window_pipeline_depth=2, **layout,
        ),
        eos_token_id=-1, device=dev,
    )


def run_multiturn(engine: InferenceEngine) -> tuple[list, float, dict]:
    """bench_multiturn's conversations: 8 lineages x 3 turns from 384 tokens,
    24 new tokens and 56 more prompt tokens per turn (cut from 13 turns).
    Returns the third turn's (prompt, result) pairs, the wall time and the
    launches."""
    rng = np.random.default_rng(5)
    transcripts = [rng.integers(1, 100_000, 384).tolist() for _ in range(8)]
    last = []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(3):
        prompts = [list(t) for t in transcripts]
        futures = [engine.submit(GenRequest(p, SamplingParams(temperature=1.0, max_tokens=24))) for p in prompts]
        while not all(f.done() for f in futures):
            engine.step()
        last = [(p, f.result()) for p, f in zip(prompts, futures)]
        transcripts = [p + r.token_ids + rng.integers(1, 100_000, 56).tolist() for p, r in last]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = counts()
    check_results([r for _, r in last], [24] * 8, engine.model_cfg)
    return last, wall, launches


def phase_prefix_cache(dev) -> dict:
    """The paged prefix cache at full width on bench_multiturn's
    conversations."""
    cfg = QWEN05B
    engine = multiturn_engine(dev, kv_layout="paged", kv_block_size=128, prefix_cache=True)
    last, wall, launches = run_multiturn(engine)
    c = engine.perf_counters()
    check(c["prefix_cache_hits"] >= 16 and c["prefix_cache_reused_tokens"] > 0, f"prefix cache: {c}")
    check(c["prefill_extend_batches"] > 0, "no tail went through forward_extend")
    L = cfg.num_layers
    check(launches["gqa_fwd"] == L * engine.prefill_batches,
          f"gqa launches {launches['gqa_fwd']} != {L} x {engine.prefill_batches} prefill batches")
    check(launches["paged"] == L * engine.decode_steps and not launches["decode"], f"decode launches {launches}")
    log(f"paged prefix cache: 8 lineages x 3 turns in {wall:.2f} s, {c['prefill_tokens']} tokens prefilled, "
        f"{c['prefill_reused_tokens']} reused, {c['prefix_cache_hits']} hits; {c['prefill_extend_batches']} of "
        f"{engine.prefill_batches} prefill batches were tails through forward_extend (kernel #2 at "
        f"q_offset = the padded prefix length: {L * c['prefill_extend_batches']} of {launches['gqa_fwd']} launches)")
    teacher_forcing(engine, last[:3], "paged prefix cache, third turn,")
    return launches


def phase_slab_prefix(dev, smi: str) -> tuple[dict, dict]:
    """Slab prefix parking at full width on bench_multiturn's conversations,
    run cold (``prefix_cache=False``) and warm from the same seed: resumed
    turns prefill only their tails, through ``forward_extend`` on kernel #2
    at q_offset = the parked prefix's bucket. Then ``score_tokens`` on three
    third-turn transcripts through the kernels, against the engine's own
    sampled logprobs and against itself through the plain attention.
    Returns the warm run's launches and those of one ``score_tokens``."""
    L = QWEN05B.num_layers
    runs = {}
    for warm in (False, True):
        engine = multiturn_engine(dev, kv_layout="slab", prefix_cache=warm, slab_prefix_min_tokens=32)
        last, wall, launches = run_multiturn(engine)
        c = engine.perf_counters()
        check(launches["gqa_fwd"] == L * engine.prefill_batches,
              f"gqa launches {launches['gqa_fwd']} != {L} x {engine.prefill_batches} prefill batches")
        check(launches["decode"] == L * engine.decode_steps and not launches["paged"], f"decode launches {launches}")
        useful = sum(len(r.token_ids) for _, r in last) * 3
        label = "warm" if warm else "cold"
        log(f"slab multi-turn, {label} (prefix_cache={warm}): 8 lineages x 3 turns in {wall:.2f} s, "
            f"{useful / wall:.1f} useful tokens/s, {c['prefill_tokens']} tokens prefilled, {c['prefill_reused_tokens']} "
            f"reused, {c['prefix_cache_hits']} hits, {c['prefill_extend_batches']} of {engine.prefill_batches} prefill "
            f"batches were tails through forward_extend, launches {launches} on {smi}")
        runs[label] = (engine, last, c, launches)
    engine, last, c, launches = runs["warm"]
    cold = runs["cold"][2]
    check(c["prefix_cache_hits"] >= 16 and c["prefill_extend_batches"] > 0, f"slab prefix parking: {c}")
    check(c["prefill_tokens"] < cold["prefill_tokens"],
          f"warm prefilled {c['prefill_tokens']} tokens, cold {cold['prefill_tokens']}")
    teacher_forcing(engine, last[:3], "slab prefix parking, third turn,")
    del runs

    # score_tokens: the transcripts' logprobs at T 1.0 through kernel #2
    scored, errs = [], []
    reset_counts()
    for prompt, r in last[:3]:
        scores = engine.score_tokens(prompt + r.token_ids)
        check(counts()["gqa_fwd"] == L * (len(scored) + 1), f"score_tokens launches {counts()}")
        scored.append(scores)
        errs.append(np.abs(np.asarray(scores[len(prompt) - 1:]) - np.asarray(r.logprobs)))
    score_launches = {k: v // 3 for k, v in counts().items()}
    errs = np.concatenate(errs)
    log(f"score_tokens vs the engine's sampled logprobs (T 1.0), 3 third-turn transcripts of "
        f"{len(last[0][0]) + 24} tokens (bucket {engine._bucket(len(last[0][0]) + 24)}): mean abs err {errs.mean():.4f} "
        f"(tolerance {TF_MEAN_ATOL}), max {errs.max():.4f} (tolerance {TF_MAX_ATOL}); {L} gqa launches per call")
    check(errs.mean() <= TF_MEAN_ATOL and errs.max() <= TF_MAX_ATOL, "score_tokens disagrees with the sampler")
    engine.attn_impl = "xla"
    plain = [engine.score_tokens(p + r.token_ids) for p, r in last[:3]]
    errs = np.concatenate([np.abs(np.asarray(a) - np.asarray(b)) for a, b in zip(scored, plain)])
    log(f"score_tokens through kernel #2 vs through the plain attention: mean abs err {errs.mean():.4f} "
        f"(tolerance {TF_MEAN_ATOL}), max {errs.max():.4f} (tolerance {TF_MAX_ATOL}) over {errs.size} tokens")
    check(errs.mean() <= TF_MEAN_ATOL and errs.max() <= TF_MAX_ATOL, "score_tokens' kernel and plain paths disagree")
    return launches, score_launches


def profile_decode(engine: InferenceEngine, reqs: list[GenRequest]) -> None:
    """Where a steady decode window's time goes: two windows with every slot
    busy under torch.profiler; device busy share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    futures = [engine.submit(r) for r in reqs]
    for _ in range(3):  # admission and the first windows stay outside
        engine.step()
    torch.cuda.synchronize()
    steps0 = engine.windows_dispatched
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.step()
        engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    n_steps = (engine.windows_dispatched - steps0) * engine.cfg.decode_window
    while not all(f.done() for f in futures):
        engine.step()
    report_profile(prof, wall_ms, n_steps, "decode")


def phase_client(dev) -> None:
    tok = ToyTokenizer()
    cfg = ModelConfig(vocab_size=tok.vocab_size, hidden_size=128, intermediate_size=256,
                      num_layers=2, num_heads=2, num_kv_heads=1, head_dim=64, dtype=torch.bfloat16)
    params = init_params(torch.Generator(device=dev).manual_seed(3), cfg, dev)
    engine = InferenceEngine(
        params, cfg, EngineConfig(max_slots=4, max_len=128, prefill_buckets=(64, 128), decode_window=8),
        eos_token_id=tok.eos_token_id, device=dev,
    )
    llm = InProcessLLM(engine, tok, parameters={"max_tokens": 24, "temperature": 1.0})
    prompts = [Prompt(messages=[{"role": "user", "content": f"say {w}"}]) for w in ("hello", "bye")]

    async def run():
        return await asyncio.gather(*(llm.agenerate(p) for p in prompts))

    engine.start()
    try:
        calls = asyncio.run(run())
    finally:
        engine.stop()
    for p, c in zip(prompts, calls):
        check(c.prompt_token_ids == llm.prompt_token_ids(p), "prompt ids differ from the template")
        check(1 <= len(c.output_token_ids) <= 24 and len(c.logprobs) == len(c.output_token_ids),
              "client call has a wrong token count")
        check(c.finish_reason in ("stop", "length") and isinstance(c.output.content, str), "bad LLMCall")
    log(f"client: {[(c.finish_reason, len(c.output_token_ids)) for c in calls]}")


# ----------------------------------------------------------------------
# phases 15-17: processes mode
# ----------------------------------------------------------------------
SERVE_REQUESTS = 64  # concurrent chat completions of MAX_TOKENS, one over SSE
PUSH_LIVE = 32  # requests live in the server when the push starts
PUSH_SCALES = (0.5, 0.25, 0.125)  # exact in bf16: the pushed weights are known bit for bit


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def survivors(marker: str) -> list[int]:
    """Processes whose command line holds ``marker``."""
    found = []
    for proc in Path("/proc").iterdir():
        if proc.name.isdigit() and proc.name != str(os.getpid()):
            try:
                if marker.encode() in (proc / "cmdline").read_bytes():
                    found.append(int(proc.name))
            except OSError:
                pass
    return found


def http_get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def serve_prompts(n: int) -> list[Prompt]:
    return [Prompt(messages=[{"role": "user", "content": f"Tell me a story about the number {i}, in a few words."}])
            for i in range(n)]


def http_load(url: str, n: int, max_tokens: int, out: str) -> None:
    """The client process of phases 15 and 16: ``n`` concurrent chat
    completions at T 1.0, the first over SSE; writes the calls and the wall
    to ``out``."""
    tok = HFTokenizer(FIXTURE_TOKENIZER)
    llm = HTTPLLM(url, tok, {"max_tokens": max_tokens, "temperature": 1.0})
    prompts = serve_prompts(n)

    async def stream(prompt):
        chunks = [c async for c in llm.astream(prompt)]
        return {"prompt_ids": tok.apply_chat_template(prompt.messages, add_generation_prompt=True),
                "ids": [t for c in chunks for t in c[0]], "logprobs": [lp for c in chunks for lp in c[1]],
                "finish": chunks[-1][3], "sse_events": len(chunks)}

    async def call(prompt):
        c = await llm.agenerate(prompt)
        return {"prompt_ids": c.prompt_token_ids, "ids": c.output_token_ids, "logprobs": c.logprobs,
                "finish": c.finish_reason}

    async def run():
        return await asyncio.gather(stream(prompts[0]), *(call(p) for p in prompts[1:]))

    t0 = time.monotonic()
    calls = asyncio.run(run())
    Path(out).write_text(json.dumps({"wall": time.monotonic() - t0, "calls": calls}))


def scaled(params: dict, c: float) -> dict:
    return {k: scaled(v, c) if isinstance(v, dict) else v * c for k, v in params.items()}


def push_client(url: str, hf_dir: str, work: str, device: str) -> None:
    """The trainer process of phase 16: the HF directory's weights times
    PUSH_SCALES. Writes ``ready``, waits for ``go``, pushes the first with
    ``push_weights_http`` while requests are live, then posts the other two
    back to back (the second ``gap`` seconds after the first, a few gaps
    until one supersedes, each pair two versions past the last); checks
    each landing through the server's
    checksums and writes what it saw to ``push.json``."""
    work_dir = Path(work)
    params, _ = load_hf_model(hf_dir, dtype=torch.bfloat16, device=device)
    trees = [scaled(params, c) for c in PUSH_SCALES]
    sums = [param_checksums(t) for t in trees]
    (work_dir / "ready").touch()
    while not (work_dir / "go").exists():
        time.sleep(0.01)
    before = http_get(f"{url}/health")["counters"]
    first = push_weights_http([url], trees[0], version=1_000_001)
    landed = http_get(f"{url}/debug/param_checksums")
    health = http_get(f"{url}/health")
    out = {"live_at_push": before["num_active"], "first": {k: v for k, v in first.items() if k != "replies"},
           "reply": first["replies"][url], "last_push": health["last_push"],
           "first_bit_exact": landed["checksums"] == sums[0] and landed["version"] == 1_000_001}
    attempts = []
    for i, gap in enumerate((0.02, 0.0, 0.05, 0.1)):
        # each attempt newer than the last landing: the engine drops a push
        # older than the version it serves before staging it
        versions = (1_000_002 + 2 * i, 1_000_003 + 2 * i)
        bodies = [serialize_params(trees[1], versions[0]), serialize_params(trees[2], versions[1])]
        superseded0 = http_get(f"{url}/weight_version")["pushes_superseded"]
        replies: dict = {}

        def post(i):
            replies[i] = post_weights(url, bodies[i], 660.0)

        threads = [threading.Thread(target=post, args=(0,)), threading.Thread(target=post, args=(1,))]
        threads[0].start()
        time.sleep(gap)
        threads[1].start()
        for t in threads:
            t.join()
        version = http_get(f"{url}/weight_version")
        landed = http_get(f"{url}/debug/param_checksums")
        attempts.append({"gap_s": gap, "superseded": version["pushes_superseded"] - superseded0,
                         "version": landed["version"], "bit_exact": landed["checksums"] == sums[2],
                         "pushed": list(versions), "replies": [replies[0]["version"], replies[1]["version"]]})
        if attempts[-1]["superseded"]:
            break
    out["supersede"] = attempts
    (work_dir / "push.json").write_text(json.dumps(out))


def serving_config(hf_dir: Path, exp: str, dev):
    """The test preset on the HF directory with phase 7's engine."""
    return compose("test", [
        f"model_path={hf_dir}", f"output_dir={exp}", f"device={dev.type}", f"engine.max_slots={SLOTS}", f"engine.max_len={MAX_LEN}",
        f"engine.prefill_buckets=[{BUCKET}]", f"engine.decode_window={WINDOW}",
        f"engine.window_pipeline_depth={DEPTH}", "engine.adaptive_window=false", "engine.attn_impl=gqa",
    ])


def start_job(module: str, conf: Path, kind: str, port: int, log_path: Path) -> subprocess.Popen:
    with open(log_path, "w") as f:
        return subprocess.Popen(
            [sys.executable, "-m", module, f"--config-dir={conf}", "--config-name=exp_config", f"+me.kind={kind}",
             "+me.replica_idx=0", f"+me.port={port}"],
            stdout=f, stderr=subprocess.STDOUT, start_new_session=True, cwd=Path(__file__).resolve().parent,
        )


def stop_group(proc: subprocess.Popen, timeout: float = 30.0) -> int:
    try:
        os.killpg(proc.pid, signal.SIGTERM)
    except ProcessLookupError:
        pass
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        return proc.wait(timeout=timeout)


def run_script(args: list[str]) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), *args],
                            cwd=Path(__file__).resolve().parent, start_new_session=True)


def load_results(out: Path) -> dict:
    data = json.loads(out.read_text())
    for c in data["calls"]:
        lp = np.asarray(c["logprobs"], np.float64)
        check(c["finish"] in ("stop", "length") and 1 <= len(c["ids"]) <= MAX_TOKENS and len(lp) == len(c["ids"]),
              f"a served call finished {c['finish']} with {len(c['ids'])} ids and {len(lp)} logprobs")
        check(bool(np.all(np.isfinite(lp)) and np.all(lp <= 0)), "served logprobs not finite and <= 0")
        check(max(c["ids"]) < 540, "a served id lies past the tokenizer's 540")
    return data


def phase_served_engine(dev, smi: str, tmp: str) -> tuple[dict, dict]:
    """Phases 15 and 16: one engine job at Qwen2.5-0.5B width, driven over
    HTTP by a client process and pushed to by a trainer process."""
    tok = HFTokenizer(FIXTURE_TOKENIZER)
    params = init_params(torch.Generator(device=dev).manual_seed(0), QWEN05B_TIED, dev)
    hf_dir = export_hf(f"{tmp}/hf_serve", params, QWEN05B_TIED, tok)
    del params
    exp = Path(tmp) / "serve"
    cfg = serving_config(hf_dir, str(exp), dev)
    conf = exp / "conf"
    cfg.save(conf / "exp_config.json")
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    job = start_job("pipelinerl_tpu_torch.entrypoints.run_engine", conf, "engine", port, exp / "engine.out")
    children: list[subprocess.Popen] = []
    try:
        # the same engine in this process, built the same way from the same config
        local_params, model_cfg, _ = launch.build_model(cfg, dev)
        engine = launch.build_engine(cfg, launch.engine_params(local_params), model_cfg, tok, dev)
        del local_params
        engine.start()
        greedy = {"max_tokens": MAX_TOKENS, "temperature": 0.0}
        prompt = serve_prompts(1)[0]
        local = asyncio.run(InProcessLLM(engine, tok, greedy).agenerate(prompt))
        prompts = serve_prompts(SERVE_REQUESTS)
        llm = InProcessLLM(engine, tok, {"max_tokens": MAX_TOKENS, "temperature": 1.0})

        async def load():
            return await asyncio.gather(*(llm.agenerate(p) for p in prompts))

        t0 = time.monotonic()
        local_calls = asyncio.run(load())
        local_wall = time.monotonic() - t0
        engine.stop()
        del engine
        torch.cuda.empty_cache()
        local_useful = sum(len(c.output_token_ids) for c in local_calls)

        t0 = time.monotonic()
        wait_for_http([url], 300, [("engine job", job)])
        log(f"served engine: the engine job answered /health {time.monotonic() - t0:.1f} s after this process's "
            f"in-process run")
        remote = asyncio.run(HTTPLLM(url, tok, greedy).agenerate(prompt))
        check(remote.output_token_ids == local.output_token_ids and remote.logprobs == local.logprobs,
              "a greedy request over HTTP differs from the same request in process")
        log(f"served engine: a greedy request alone ({len(remote.prompt_token_ids)} prompt tokens, "
            f"{len(remote.output_token_ids)} sampled) returns over HTTP the same ids and logprobs, bit for bit, "
            f"as the same request in process")

        out = exp / "load.json"
        client = run_script(["--http-load", url, str(SERVE_REQUESTS), str(MAX_TOKENS), str(out)])
        children.append(client)
        check(client.wait(timeout=600) == 0, "the HTTP load client failed")
        data = load_results(out)
        useful = sum(len(c["ids"]) for c in data["calls"])
        streamed = data["calls"][0]
        check(streamed["sse_events"] >= 3, f"the SSE call came in {streamed['sse_events']} events")
        errs = []
        for c in data["calls"][1:4]:
            scores = asyncio.run(HTTPLLM(url, tok).ascore(c["prompt_ids"] + c["ids"]))
            errs.append(np.abs(np.asarray(scores[len(c["prompt_ids"]) - 1:]) - np.asarray(c["logprobs"])))
        errs = np.concatenate(errs)
        log(f"served engine: /v1/completions echo scores vs the sampled logprobs (T 1.0) over {errs.size} tokens: "
            f"mean abs err {errs.mean():.4f} (tolerance {TF_MEAN_ATOL}), max {errs.max():.4f} "
            f"(tolerance {TF_MAX_ATOL})")
        check(errs.mean() <= TF_MEAN_ATOL and errs.max() <= TF_MAX_ATOL, "echo scores disagree with the sampler")
        health = http_get(f"{url}/health")
        served = dict(health["kernel_launches"])
        check(served["decode"] > 0 and served["gqa_fwd"] > 0 and not served["paged"],
              f"the engine job's kernel launches: {served}")
        log(f"served engine: {SERVE_REQUESTS} concurrent chat completions of {MAX_TOKENS} tokens from a client "
            f"process (one over SSE, {streamed['sse_events']} events): {useful} tokens in {data['wall']:.2f} s, "
            f"{useful / data['wall']:.1f} useful tokens/s over HTTP; the same load in process: {local_useful} "
            f"tokens in {local_wall:.2f} s, {local_useful / local_wall:.1f} useful tokens/s; on {smi}")
        log(f"served engine: kernel launches in the engine job {served}; counters {json.dumps(health['counters'])}")

        # phase 16: a full-width push while decoding
        work = exp / "push"
        work.mkdir()
        pusher = run_script(["--push", url, str(hf_dir), str(work), dev.type])
        children.append(pusher)
        deadline = time.monotonic() + 300
        while not (work / "ready").exists():
            check(pusher.poll() is None and time.monotonic() < deadline, "the pusher did not get ready")
            time.sleep(0.1)
        out = exp / "load_push.json"
        client = run_script(["--http-load", url, str(2 * SERVE_REQUESTS), str(MAX_TOKENS), str(out)])
        children.append(client)
        deadline = time.monotonic() + 120
        while http_get(f"{url}/health")["counters"]["num_active"] < PUSH_LIVE:
            check(client.poll() is None and time.monotonic() < deadline, f"fewer than {PUSH_LIVE} requests went live")
            time.sleep(0.02)
        (work / "go").touch()
        check(pusher.wait(timeout=900) == 0, "the pusher failed")
        check(client.wait(timeout=600) == 0, "the HTTP load client failed during the push")
        load_results(out)
        push = json.loads((work / "push.json").read_text())
        span, h2d = push["reply"]["push_span"], push["last_push"]
        log(f"push while decoding: {push['first']['bytes']} body bytes, serialize {push['first']['serialize_s']:.3f} s, "
            f"POST to 200 {push['first']['post_s']:.3f} s (body read {push['reply']['read_s']:.3f} s, stage and swap "
            f"{push['reply']['wait_s']:.3f} s: H2D staging {h2d['transfer_s']:.3f} s at {h2d['gbps']:.2f} GB/s, "
            f"publish to swap {h2d.get('publish_to_swap_s', float('nan')) * 1e3:.2f} ms), "
            f"{push['live_at_push']} requests live at the push; decode windows read back from the body's arrival "
            f"to the swap: {span['windows_during']} (during the H2D staging alone: {h2d['windows_during']}); "
            f"largest gap between windows then {span['max_window_gap_s'] * 1e3:.1f} ms against a steady "
            f"{(span['steady_window_gap_s'] or float('nan')) * 1e3:.1f} ms; on {smi}")
        check(push["live_at_push"] >= PUSH_LIVE, f"only {push['live_at_push']} requests live at the push")
        check(push["first_bit_exact"], "the pushed weights did not land bit for bit")
        check(span["windows_during"] >= 1, "no decode window completed while the push was in flight")
        log(f"push supersede attempts: {push['supersede']}")
        last = push["supersede"][-1]
        check(last["superseded"] >= 1, "no second push superseded the first mid-transfer")
        check(last["bit_exact"] and last["version"] == last["pushed"][1] and last["replies"] == last["pushed"],
              f"the superseding push did not land bit for bit: {last}")
        final = http_get(f"{url}/health")["kernel_launches"]
        pushed = {k: final[k] - served[k] for k in final}
    finally:
        for proc in children:
            if proc.poll() is None:
                stop_group(proc)
        rc = stop_group(job)
    stats = json.loads((exp / "engine" / "stats_engine_0.json").read_text())
    check(stats["version"] == last["pushed"][1], f"the engine job ended on version {stats['version']}")
    check(not survivors(str(conf)), "the engine job outlived its SIGTERM")
    log(f"engine job stopped with {rc} after SIGTERM; push counters {stats['push']}")
    return served, pushed


# the task presets at Qwen2.5-0.5B width (phases 18-20): the HF directory of
# phase 14, and the cuts each run makes to the preset, logged with the
# preset's own value
MATH_CUTS = {"llm.parameters.max_tokens": 512, "finetune.samples_per_step": 64, "finetune.max_train_steps": 1,
             "total_groups": 16, "rewards.buffer_tokens": 128, "actor.difficulty_aware_penalty.enabled": "true",
             "finetune.rl.entropy_bonus": 0.001, "finetune.save_checkpoint_steps": 0}
MATH_SETS = "[synthetic_arithmetic,countdown]"
MULTI_SETS = "[math::synthetic_arithmetic,math::countdown,guessing::train,counting::train]"
# phase 19 also runs the memory debugger and profiles step 2. Steps of 16
# samples take their data from the engine's first 64 slots (8 groups, which
# finish together), so step 2 waits for none and its window is the step;
# the groups past those keep the engine decoding through it, and the run's
# end cancels them. (At 32 or 64 samples a step, step 2 waited on the
# engine, which the profiler slows, for 19 s of trace, 306 MB.)
MULTI_CUTS = {"llm.parameters.max_tokens": 128, "finetune.samples_per_step": 16, "finetune.max_train_steps": 2,
              "total_groups": 24, "finetune.rl.entropy_bonus": 0.001, "finetune.save_checkpoint_steps": 0,
              "finetune.memory_debug.enabled": "true", "finetune.profile.enabled": "true",
              "finetune.profile.start_step": 1, "finetune.profile.num_steps": 1}
SHORT_CUTS = {"llm.parameters.max_tokens": 128, "finetune.samples_per_step": 32, "finetune.max_train_steps": 1,
              "total_groups": 8, "finetune.rl.entropy_bonus": 0.001, "finetune.save_checkpoint_steps": 0}
# each domain's prompt carries this text (phase 19's dispatch gate)
DOMAIN_PROMPTS = {"math": ("What is ", "Using the numbers"), "guessing": ("You must guess a number",),
                  "counting": ("How many times does the letter",)}
TOOLS_TEMPLATE = FIXTURE_TOKENIZER.parent / "chat_template_tools.jinja"


def cut_args(name: str, cuts: dict, hf_dir, out: str) -> list[str]:
    """``launch.main``'s argv for preset ``name`` with ``cuts``, each logged
    beside the preset's own value."""
    base = compose(name, [f"model_path={hf_dir}", f"output_dir={out}"])
    log(f"{name} preset cuts: " + ", ".join(f"{k} {v} (preset {base.select(k)})" for k, v in cuts.items()))
    return [f"--config-name={name}", f"model_path={hf_dir}", f"output_dir={out}",
            *(f"{k}={v}" for k, v in cuts.items())]


def run_rows_recorded(argv: list[str], made: list | None = None) -> tuple[dict, list[dict], tuple, float, dict]:
    """``launch.main(argv)`` with each train pass timed (synchronized) and
    its peak device memory read, and the engine's (slots, window, T_alloc);
    the trainer goes to ``made`` where given. Returns (stats, passes, engine
    shape, wall seconds, kernel launches)."""
    passes, shapes = [], []

    class RowRecording(TrainerLoop):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            if made is not None:
                made.append(self)

        def train_pass(self, batch):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            out = super().train_pass(batch)
            torch.cuda.synchronize()
            passes.append({"s": time.monotonic() - t0, "peak": torch.cuda.max_memory_allocated(), "before": before,
                           "step": self.metrics.completed_steps, "length": batch.length,
                           "segment_ids": batch.segment_ids[0].copy(), "padding": batch.padding})
            return out

    build_engine, original = launch.build_engine, launch.TrainerLoop

    def spy_engine(*args, **kw):
        engine = build_engine(*args, **kw)
        shapes.append((engine.cfg.max_slots, max(1, engine.cfg.decode_window), engine.T_alloc))
        return engine

    launch.build_engine, launch.TrainerLoop = spy_engine, RowRecording
    reset_counts()
    t0 = time.monotonic()
    try:
        stats = launch.main(argv)
    finally:
        launch.build_engine, launch.TrainerLoop = build_engine, original
    torch.cuda.synchronize()
    return stats, passes, shapes[0], time.monotonic() - t0, counts()


def actor_samples(out: str) -> list[dict]:
    return [s for g in StreamReader(SingleStreamSpec(out, "actor")).read_available() for s in g["samples"]]


def stats_means(out: str, key: str) -> dict[str, float]:
    """Each ``*_mean`` whose name holds ``key`` in the actor's stats stream,
    averaged over its snapshots."""
    values: dict[str, list[float]] = {}
    for snap in StreamReader(SingleStreamSpec(out, "stats")).read_available():
        for k, v in snap.items():
            if key in k and k.endswith("_mean"):
                values.setdefault(k, []).append(v)
    return {k: round(sum(v) / len(v), 4) for k, v in sorted(values.items())}


def train_losses(out: str) -> list[float]:
    with open(f"{out}/metrics/trainer_0.jsonl") as f:
        return [json.loads(line)["loss"] for line in f]


def phase_math(hf_dir: Path, smi: str, tmp: str) -> tuple[dict, dict]:
    """Phase 18: the ``math`` preset through ``launch.main`` at its own
    engine and trainer widths (64 slots of max_len 10,240, prefill buckets
    256-2,048, L 12,288 rows, flash attention) from the HF directory, on
    the synthetic arithmetic and countdown sets, with the difficulty-aware
    penalty over a 128-token buffer. Returns (launches, what the kernel
    rows of these shapes need: the engine shape and a packed row's segment
    ids)."""
    out = f"{tmp}/math"
    argv = cut_args("math", MATH_CUTS, hf_dir, out) + [f"train_dataset_names={MATH_SETS}"]
    stats, passes, shape, wall, launches = run_rows_recorded(argv)
    cfg = compose("math", argv[1:])
    table = RewardTable.from_config(cfg)
    max_tokens = cfg.llm.parameters.max_tokens
    samples = actor_samples(out)
    cut, off_table = 0, []
    for s in samples:
        n_out = sum(1 for label in s["labels"] if label != -100)
        base = [v for k, v in vars(table).items() if k != "buffer_tokens" and k.endswith("_not_finished") != s["finished"]]
        if not any(-1.0 - 1e-9 <= s["reward"] - b <= 1e-9 for b in base):
            off_table.append(s["reward"])
        if n_out == max_tokens and not s["finished"]:
            cut += 1
            check(any(s["reward"] == b - 1.0 for b in base), f"a rollout cut at max_tokens got {s['reward']}")
    ids = sampled_ids(out)
    losses = train_losses(out)
    rows = [p for p in passes if p["length"] == cfg.finetune.seq_length]
    steps = {}
    for p in passes:
        steps[p["step"]] = steps.get(p["step"], 0.0) + p["s"]
    actor = stats["actor"]
    row = max(rows, key=lambda p: int(p["segment_ids"].max()))
    log(f"math preset through launch.main: {wall:.1f} s wall, {actor['groups_completed']} groups, "
        f"{actor['samples_written']} samples, {actor['output_tokens']} sampled tokens, "
        f"{actor['output_tokens'] / wall:.1f} useful tokens/s; engine S {shape[0]} W {shape[1]} T_alloc {shape[2]}; "
        f"rewards {sorted(set(round(s['reward'], 4) for s in samples))[:12]}..., {cut} rollouts cut at "
        f"max_tokens {max_tokens} with the full penalty, means over the stats stream "
        f"{ {k: v for k, v in stats_means(out, '').items() if '/' not in k} }; {len(rows)} train passes at L {cfg.finetune.seq_length}: "
        f"{[round(p['s'] * 1e3, 1) for p in rows]} ms, peak memory {[round(p['peak'] / 2**30, 2) for p in rows]} GiB "
        f"({[round(p['before'] / 2**30, 2) for p in rows]} GiB held before each); ms per train step "
        f"{ {k: round(v * 1e3, 1) for k, v in steps.items()} }, losses {losses}; max sampled id {max(ids)} "
        f"(valid_vocab 540); launches {launches}; on {smi}")
    check(not off_table, f"rewards off the table plus a penalty in [-1, 0]: {off_table[:5]}")
    check(cut > 0, "no rollout reached max_tokens: the full-penalty gate saw nothing")
    steps = MATH_CUTS["finetune.max_train_steps"]
    check(stats["trainer"]["completed_steps"] == steps and len(losses) == steps and all(map(math.isfinite, losses)),
          f"math trainer {stats['trainer']}, losses {losses}")
    check(all(launches[k] for k in ("decode", "gqa_fwd", "gqa_dq", "gqa_dkv")), f"math launches {launches}")
    check(ids and max(ids) < 540, f"a sampled id reached valid_vocab: {max(ids)}")
    check(rows, "no train pass ran a full row")
    return launches, {"engine": shape, "segment_ids": row["segment_ids"], "padding": row["padding"],
                      "rows": [(p["segment_ids"], p["padding"]) for p in rows]}




def time_slab(dev, kernels: list[dict], name: str, engine: tuple, live: tuple[int, int], seed: int,
              heads: tuple[int, int, int] = QWEN05B_HEADS) -> None:
    """Kernel #1 at a preset's slab allocation ``engine`` (slots, window,
    T_alloc) against its plain version and timed: at live lengths (a prompt
    plus the cut's new tokens), at the same lengths in an allocation that
    just holds them, and at lengths near the full allocation; into
    ``kernels[0][name]``. ``heads`` is the model's (H, K, Dh)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    H, K, Dh = heads
    S, W, T = engine
    log(f"device memory held before the {name} rows: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(seed)
    lens = {"live": [int(x) for x in rng.integers(live[0], live[1] + 1, S)],
            "full": [int(x) for x in rng.integers(T - W - 512, T - W + 1, S)]}
    for label, ls in lens.items():
        args = _decode_inputs(gen, S, H, K, Dh, T, W, ls, W - 1, dev)
        out = dattn.decode_attention_staged_ragged(*args)
        ref = dattn.decode_attention_staged_ragged_plain(*args)
        err, rel = (out.float() - ref.float()).abs().max().item(), row_rel_err(out, ref, 1)
        log(f"decode kernel vs plain at the {name} slab, {label} lengths: max abs err {err:.3e} "
            f"(tolerance {DECODE_ATOL}), slot relative {rel:.3e} (tolerance {OUT_ROW_RTOL})")
        check(math.isfinite(err) and err <= DECODE_ATOL and rel <= OUT_ROW_RTOL,
              f"decode kernel disagrees at the {name} slab ({label})")
        kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], err)
        del args, out, ref
    record = _time_decode(gen, S, H, K, Dh, T, W, lens["live"], dev)
    record["full_length"] = _time_decode(gen, S, H, K, Dh, T, W, lens["full"], dev)
    fit = -(-(max(lens["live"]) + W) // dattn.SPLIT_ROWS) * dattn.SPLIT_ROWS  # an allocation that just holds them
    record["live_in_fitted_alloc"] = _time_decode(gen, S, H, K, Dh, fit, W, lens["live"], dev, library=False)
    spent = record["ms"] - record["live_in_fitted_alloc"]["ms"]
    log(f"decode kernel at the {name} slab: {record['splits']} splits of {dattn.SPLIT_ROWS} rows at T_alloc {T}, "
        f"{record['live_in_fitted_alloc']['splits']} at T_alloc {fit}; the splits that only exit cost "
        f"{spent * 1e3:.1f} us a launch ({spent / record['ms']:.3f} of it)")
    kernels[0][name] = record
    torch.cuda.empty_cache()


def time_prefill(dev, kernels: list[dict], name: str, B: int, L: int, seed: int, block: int | None = None,
                 heads: tuple[int, int, int] = QWEN05B_HEADS) -> None:
    """Kernel #2 at a prefill bucket: B rows of L tokens, one segment each
    (the engine's prefill), against its plain version (by blocks of
    ``block`` queries where the scores would not fit) and timed; into
    ``kernels[1][name]``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    H, K, Dh = heads
    plain = gattn.mha_packed_gqa_plain if block is None else \
        (lambda *a: gattn.mha_packed_gqa_plain_blocked(*a, block=block))
    label = f"{name} prefill B {B} L {L}"
    args = _gqa_inputs(gen, B, L, L, H, K, Dh, 1, dev)
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], _check_gqa_forward(label, args, plain=plain))
    kernels[1][name] = _time_gqa_forward(label, args, lambda: _gqa_inputs(gen, B, L, L, H, K, Dh, 1, dev), dev,
                                         plain_by_events=block is not None, plain=plain)
    del args
    torch.cuda.empty_cache()


def time_train_row(dev, kernels: list[dict], name: str, seg: np.ndarray, padding: int, seed: int,
                   block: int | None = None, heads: tuple[int, int, int] = QWEN05B_HEADS) -> None:
    """Kernels #2-#4 on a packed training row a preset trained on (its
    segment ids), against their plain versions (by blocks of ``block``
    queries where the row's fp32 scores would not fit) and timed beside
    SDPA and their bounds; into ``kernels[1..3][name]``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    H, K, Dh = heads
    L = seg.shape[0]
    if block is None:
        fwd_plain, bwd_plain, how = gattn.mha_packed_gqa_plain, gattn.mha_packed_gqa_bwd_plain, ""
    else:
        fwd_plain = lambda *a: gattn.mha_packed_gqa_plain_blocked(*a, block=block)  # noqa: E731
        bwd_plain = lambda *a: gattn.mha_packed_gqa_bwd_plain_blocked(*a, block=block)  # noqa: E731
        how = f", the plain versions by blocks of {block} queries"
    label = f"{name} training row L={L}, {int(seg.max()) + 1} segments ({padding} padding){how}"
    args = _gqa_inputs(gen, 1, L, L, H, K, Dh, seg, dev)
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], _check_gqa_forward(label, args, plain=fwd_plain))
    kernels[1][name] = _time_gqa_forward(label, args, lambda: _gqa_inputs(gen, 1, L, L, H, K, Dh, seg, dev), dev,
                                         plain_by_events=True, plain=fwd_plain)
    del args
    torch.cuda.empty_cache()
    a = _gqa_bwd_args(gen, 1, L, L, H, K, Dh, seg, dev)
    grads = gattn.mha_packed_gqa_bwd(*a[:10])
    refs = bwd_plain(*a[:10])
    errs = {n: _rel_err(g, r) for n, g, r in zip(("dq", "dk", "dv"), grads, refs)}
    del a, grads, refs
    log(f"gqa backward kernels vs plain, {label}: " + ", ".join(
        f"{n} max abs err {e:.3e} ({rel:.2e} of max |ref|)" for n, (e, rel) in errs.items())
        + f" (tolerance {GQA_BWD_RTOL} of max |ref|)")
    check(all(math.isfinite(e) and rel <= GQA_BWD_RTOL for e, rel in errs.values()), f"gqa backward disagrees ({label})")
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], errs["dq"][0])
    kernels[3]["max_abs_err"] = max(kernels[3]["max_abs_err"], errs["dk"][0], errs["dv"][0])
    torch.cuda.empty_cache()
    t = _time_gqa_bwd(label, lambda: _gqa_bwd_args(gen, 1, L, L, H, K, Dh, seg, dev), dev, plain_iters=2,
                      plain=bwd_plain)
    kernels[2][name], kernels[3][name] = t["dq"], t["dkv"]
    torch.cuda.empty_cache()


def time_math_shapes(dev, kernels: list[dict], math_shapes: dict) -> None:
    """Kernel #1 at phase 18's slab allocation (live lengths of a prompt plus
    up to 512 tokens), and #2-#4 on the packed L 12,288 row phase 18 trained
    on, each against its plain version, and timed beside SDPA and its bound,
    into the kernel records."""
    time_slab(dev, kernels, "math_slab_shape", math_shapes["engine"], (64, 576), 18)
    time_train_row(dev, kernels, "math_row_shape", math_shapes["segment_ids"], math_shapes["padding"], 18)


# the device families of phase 19's profiled step, the first match naming
# a kernel's family; cuBLAS names its fp32 GEMMs (the fp32 lm_head, the only
# fp32 matmul of a bf16 step) sgemm or f32f32_f32f32
PROFILE_FAMILIES = (("#1/#5 decode attention", r"decode_attention_kernel|merge_splits_kernel"),
                    ("#2-#4 GQA attention", r"gqa_fwd_kernel|gqa_bwd_dq_kernel|gqa_bwd_dkv_kernel"),
                    ("fp32 GEMMs (lm_head)", r"(?i)sgemm|f32f32_f32f32|gemm_f32|nvjet_sss"),
                    ("other GEMMs", r"(?i)gemm|nvjet|xmma|cutlass"),
                    ("other", r""))


def memory_phases_in_order(recs: list[dict], steps: int) -> bool:
    """Whether the records run as the JAX trainer writes them: each step's
    passes as (before, after) pairs at the step count so far, then
    after_optimizer_step and after_weight_push at the new count (no saves:
    the phase's cuts turn them off)."""
    seq = [(r["phase"], r["step"]) for r in recs]
    i = 0
    for step in range(steps):
        n = 0
        while seq[i : i + 2] == [("before_train_pass", step), ("after_train_pass", step)]:
            i, n = i + 2, n + 1
        if not n or seq[i : i + 2] != [("after_optimizer_step", step + 1), ("after_weight_push", step + 1)]:
            return False
        i += 2
    return i == len(seq)


def read_step_profile(trace: Path) -> dict:
    """Phase 19's trace: kernel ms and launches by family (and the top
    kernels of each), the device's busy share over the window (the union
    of kernel, copy and set intervals over the span of every event), the
    file's size."""
    events = json.loads(trace.read_text())["traceEvents"]
    timed = [e for e in events if "ts" in e and e.get("ph") == "X"]
    window_us = max(e["ts"] + e.get("dur", 0) for e in timed) - min(e["ts"] for e in timed)
    device = sorted((e for e in timed if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                    key=lambda e: e["ts"])
    busy_us, end = 0.0, -math.inf
    for e in device:  # the union of the device intervals, over every stream
        start, stop = max(e["ts"], end), e["ts"] + e["dur"]
        if stop > start:
            busy_us += stop - start
        end = max(end, stop)
    families = {name: {"ms": 0.0, "launches": 0, "top": {}} for name, _ in PROFILE_FAMILIES}
    for e in device:
        if e["cat"] != "kernel":
            continue
        name = next(n for n, pattern in PROFILE_FAMILIES if re.search(pattern, e["name"]))
        fam = families[name]
        fam["ms"] += e["dur"] / 1e3
        fam["launches"] += 1
        fam["top"][e["name"]] = fam["top"].get(e["name"], 0.0) + e["dur"] / 1e3
    kernels = {k: sum(1 for e in device if e["cat"] == "kernel" and re.search(pattern, e["name"]))
               for k, pattern in (("decode", r"decode_attention_kernel"), ("gqa_fwd", r"gqa_fwd_kernel"),
                                  ("gqa_dq", r"gqa_bwd_dq_kernel"), ("gqa_dkv", r"gqa_bwd_dkv_kernel"))}
    return {"window_ms": window_us / 1e3, "busy_ms": busy_us / 1e3, "families": families, "kernels": kernels,
            "events": len(events), "mb": trace.stat().st_size / 1e6}


def phase_multi_domain(hf_dir: Path, smi: str, tmp: str) -> dict:
    """Phase 19: the ``multi_domain`` preset through ``launch.main`` at its
    widths from the HF directory, on math's synthetic sets, guessing and
    counting under the preset's domain mix with adaptive sampling: every
    domain is drawn and its rollout dispatched (the rollout policy's calls,
    recorded as they start: the attempts of the first
    ``actor.max_parallel_groups`` draws are dispatched before any group
    finishes, so this does not depend on the order in which groups
    finish); each sample of a finished group
    carries its domain's prompt, and the stats stream reports per domain
    the domains of the finished groups. The run has
    ``finetune.memory_debug`` on and ``finetune.profile`` over step 2: the
    memory records run in the JAX trainer's order with the card's readings,
    and the trace holds #2-#4 and, where the engine thread launched #1 while
    the profiler ran (its launch counter read as the profiler starts and
    stops), #1 too: in inline mode the trainer's thread can hold the engine
    off the whole step; the step's device ms by family are logged."""
    out = f"{tmp}/multi_domain"
    argv = cut_args("multi_domain", MULTI_CUTS, hf_dir, out) + [f"train_dataset_names={MULTI_SETS}"]
    cfg = compose("multi_domain", argv[1:])
    made: list = []
    dispatched: list[str] = []
    dispatch = registry.generate_dispatched_rollout

    async def recorded_dispatch(run_cfg, llm, problem, session):
        dispatched.append(problem["domain"])
        return await dispatch(run_cfg, llm, problem, session)

    # #1's launch counter as the profiler starts, and as it stops
    from pipelinerl_tpu_torch.utils.memory_debug import StepProfiler

    spans: list[int] = []
    on_step = StepProfiler.on_step

    def counted_on_step(self, step):
        if self.active and step >= self.stop_step:
            spans.append(dattn.launches)
        was = self.active
        on_step(self, step)
        if self.active and not was:
            spans.append(dattn.launches)

    registry.generate_dispatched_rollout = recorded_dispatch
    StepProfiler.on_step = counted_on_step
    try:
        stats, passes, shape, wall, launches = run_rows_recorded(argv, made)
    finally:
        registry.generate_dispatched_rollout = dispatch
        StepProfiler.on_step = on_step
    profiler = made[0].profiler
    trace, export_s = profiler.trace_path, profiler.export_s
    made.clear()
    tok = HFTokenizer(hf_dir)
    finished: dict[str, int] = {}
    for s in actor_samples(out):
        prompt = tok.decode([i for i, label in zip(s["input_ids"], s["labels"]) if label == -100])
        check(any(text in prompt for text in DOMAIN_PROMPTS[s["domain"]]),
              f"a {s['domain']} sample does not carry its domain's prompt: {prompt[:200]!r}")
        finished[s["domain"]] = finished.get(s["domain"], 0) + 1
    snaps = list(StreamReader(SingleStreamSpec(out, "stats")).read_available()) + [stats["actor"]]
    reported = {k.split("/")[1] for snap in snaps for k in snap if k.startswith("domain/")}
    per_domain = stats_means(out, "/reward")
    losses = train_losses(out)
    steps = int(cfg.finetune.max_train_steps)
    # one call per attempt: the first groups' attempts all start before any
    # group finishes
    first = dispatched[: int(cfg.actor.max_parallel_groups) * int(cfg.attempts)]
    log(f"multi_domain preset through launch.main: {wall:.1f} s wall, rollouts dispatched by domain "
        f"{ {d: dispatched.count(d) for d in sorted(set(dispatched))} } (the first {len(first)}: "
        f"{ {d: first.count(d) for d in sorted(set(first))} }), finished samples by domain {finished}, domains in "
        f"the stats stream {sorted(reported)}, reward means there {per_domain}, "
        f"{stats['actor']['output_tokens'] / wall:.1f} useful tokens/s, {stats['trainer']['completed_steps']} steps, "
        f"losses {losses}, launches {launches}; on {smi}")
    check(set(first) == set(DOMAIN_PROMPTS), f"domains dispatched first {sorted(set(first))}")
    check(reported == set(finished) and finished, f"domains finished {finished}, reported {reported}")
    check(stats["trainer"]["completed_steps"] == steps and all(map(math.isfinite, losses)), f"losses {losses}")
    check(all(launches[k] for k in ("decode", "gqa_fwd", "gqa_dq", "gqa_dkv")), f"multi_domain launches {launches}")

    # the memory debugger's records
    with open(f"{out}/metrics/memory_debug_0.jsonl") as f:
        recs = [json.loads(line) for line in f]
    card = f"device_{torch.cuda.current_device()}"
    after = [r[card] for r in recs if r["phase"] == "after_train_pass" and card in r]
    log(f"multi_domain memory records: {len(recs)} ({[r['phase'] for r in recs].count('after_train_pass')} passes), "
        f"{card} in use after the passes {min(a['bytes_in_use'] for a in after) / 2**30:.2f}-"
        f"{max(a['bytes_in_use'] for a in after) / 2**30:.2f} GiB, peak "
        f"{max(r[card]['peak_bytes_in_use'] for r in recs) / 2**30:.2f} of {recs[0][card]['bytes_limit'] / 2**30:.2f} "
        f"GiB, host RSS up to {max(r['vmrss'] for r in recs) / 2**30:.2f} GiB, live blocks up to "
        f"{max(r['live_arrays'] for r in recs)}")
    check(memory_phases_in_order(recs, steps), f"memory records out of the JAX trainer's order: "
          f"{[(r['phase'], r['step']) for r in recs]}")
    check(all(card in r for r in recs), f"a memory record lacks {card}")
    check(all(a["bytes_in_use"] > 0 for a in after), "no device memory in use after a pass")
    check(all(r[card]["peak_bytes_in_use"] <= r[card]["bytes_limit"] for r in recs), "a peak above the card's limit")

    # the profiled step
    check(trace is not None and trace.exists(), f"no trace under {out}/profile")
    prof = read_step_profile(trace)
    fams = prof["families"]
    check(len(spans) == 2, f"the profiler's start and stop were not both seen: {spans}")
    during = spans[1] - spans[0]
    with open(f"{out}/metrics/trainer_0.jsonl") as f:
        step2 = [json.loads(line) for line in f][1]
    rows = [p for p in passes if p["step"] == 1]
    log(f"multi_domain step 2: {step2['throughput/tokens_per_step']} samples in {len(rows)} passes of "
        f"{[(p['length'], p['length'] - p['padding']) for p in rows]} (row, unpadded) tokens")
    log(f"multi_domain step 2 profile: window {prof['window_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms "
        f"(share {prof['busy_ms'] / prof['window_ms']:.3f}), trace {prof['mb']:.1f} MB of {prof['events']} events "
        f"exported in {export_s:.2f} s; device ms by family: "
        + ", ".join(f"{n} {f['ms']:.2f} ({f['launches']} launches)" for n, f in fams.items())
        + f"; kernels in the trace {prof['kernels']}; the engine launched #1 {during} times while the profiler "
        f"ran; on {smi}")
    for name, fam in fams.items():
        top = sorted(fam["top"].items(), key=lambda kv: -kv[1])[:4]
        log(f"  {name}: " + "; ".join(f"{ms:.2f} ms {k[:80]}" for k, ms in top))
    check(all(prof["kernels"][k] for k in ("gqa_fwd", "gqa_dq", "gqa_dkv"))
          and (during == 0 or prof["kernels"]["decode"]),
          f"the profiled step's trace misses a kernel: {prof['kernels']} ({during} #1 launches while it ran)")
    return launches


def phase_short_domains(hf_dir: Path, smi: str, tmp: str) -> dict[str, dict]:
    """Phase 20: the ``logic``, ``ifeval`` and ``fn_calling`` presets, one
    short run each from the HF directory on their synthetic sets: the step
    completes and every reward is finite and one the domain can give. The
    fn_calling run reads an HF directory whose chat template has Qwen2.5's
    tools block (the fixture's ChatML template drops tools), and its
    prompts must carry the tool's schema."""
    tools_dir = Path(tmp) / "hf_tools"
    tools_dir.mkdir()
    for f in hf_dir.iterdir():
        (tools_dir / f.name).symlink_to(f)
    (tools_dir / "chat_template.jinja").unlink()
    (tools_dir / "chat_template.jinja").write_text(TOOLS_TEMPLATE.read_text())
    table = RewardTable.from_config(compose("logic", ["output_dir=/tmp/unused"]))
    logic_rewards = {v for k, v in vars(table).items() if k != "buffer_tokens"}
    allowed = {"logic": lambda r: r in logic_rewards, "ifeval": lambda r: r in (0.0, 0.5, 1.0),
               "fn_calling": lambda r: 0.0 <= r <= 1.0}
    paths = {}
    for name in ("logic", "ifeval", "fn_calling"):
        directory = tools_dir if name == "fn_calling" else hf_dir
        out = f"{tmp}/{name}"
        stats, _, _, wall, launches = run_rows_recorded(cut_args(name, SHORT_CUTS, directory, out))
        samples = actor_samples(out)
        rewards = [s["reward"] for s in samples]
        losses = train_losses(out)
        note = ""
        if name == "fn_calling":
            prompt = HFTokenizer(directory).decode(
                [i for i, label in zip(samples[0]["input_ids"], samples[0]["labels"]) if label == -100])
            check("<tools>" in prompt and '"name": "get_weather"' in prompt, f"no tools in the prompt: {prompt!r}")
            note = f", the prompt's {prompt.count('get_weather')} get_weather mentions rendered by the tools template"
        log(f"{name} preset through launch.main: {wall:.1f} s wall, {len(samples)} samples, rewards "
            f"{sorted(set(round(r, 4) for r in rewards))}, losses {losses}{note}, launches {launches}; on {smi}")
        check(stats["trainer"]["completed_steps"] == 1 and all(map(math.isfinite, losses)), f"{name} losses {losses}")
        check(all(math.isfinite(r) and allowed[name](r) for r in rewards), f"{name} rewards {sorted(set(rewards))}")
        check(all(launches[k] for k in ("decode", "gqa_fwd", "gqa_dq", "gqa_dkv")), f"{name} launches {launches}")
        paths[name] = launches
        torch.cuda.empty_cache()
    return paths


# phase 21: one card (CP waits for the mesh), the synthetic arithmetic set in
# place of the hub set, 512 new tokens and one step of 32 samples (from
# 16,000 and 1,024) out of 40 rollouts, an overlong buffer of 128 so the
# length term runs, and an entropy bonus of 0.001 (the preset's 0) so the
# loss's entropy term runs, as the other presets' phases set it
TIR_CUTS = {"parallel.cp": 1, "llm.parameters.max_tokens": 512, "finetune.samples_per_step": 32,
            "finetune.max_train_steps": 1, "total_groups": 5, "rewards.buffer_tokens": 128,
            "finetune.rl.entropy_bonus": 0.001, "finetune.save_checkpoint_steps": 0}
TIR_SETS = "[synthetic_arithmetic]"
TIR_ROW_BLOCK = 1024  # queries per block of the plain checks at L 32,768: 1.9 GB of fp32 scores a block
# phase 22: the hermetic sets, a short budget and one step each (32 new
# tokens a turn for miniwob's 8 sequential turns, which set its wall)
CODING_CUTS = {"llm.parameters.max_tokens": 256, "finetune.samples_per_step": 32, "finetune.max_train_steps": 1,
               "total_groups": 10, "rewards.buffer_tokens": 64, "finetune.rl.entropy_bonus": 0.001,
               "finetune.save_checkpoint_steps": 0}
MINIWOB_CUTS = {"llm.parameters.max_tokens": 32, "finetune.samples_per_step": 32, "finetune.max_train_steps": 1,
                "total_groups": 2, "finetune.rl.entropy_bonus": 0.001, "finetune.save_checkpoint_steps": 0}
# phase 23: the base preset with the research policy and loader (JAX's launch
# takes the same overrides; there is no preset), its rows as long as the
# engine's max_len as validate_config asks
RESEARCH_CUTS = {"rollout_policy": "pipelinerl_tpu_torch.domains.deep_research.generate_research_rollout",
                 "dataset_loader": "pipelinerl_tpu_torch.domains.deep_research.load_problems",
                 "finetune.seq_length": 2048, "llm.parameters.max_tokens": 32, "finetune.samples_per_step": 32,
                 "finetune.max_train_steps": 1, "total_groups": 2, "finetune.rl.entropy_bonus": 0.001,
                 "finetune.save_checkpoint_steps": 0}
KERNEL_KEYS = ("decode", "gqa_fwd", "gqa_dq", "gqa_dkv")


def n_out(sample: dict) -> int:
    return sum(1 for label in sample["labels"] if label != -100)


def max_stat(out: str, stats: dict, key: str) -> float:
    """The largest ``key`` over the stats stream's snapshots and the run's
    last one."""
    snaps = list(StreamReader(SingleStreamSpec(out, "stats")).read_available()) + [stats["actor"]]
    return max(snap.get(key, 0) for snap in snaps)


def phase_tir(hf_dir: Path, smi: str, tmp: str) -> tuple[dict, dict]:
    """Phase 21: the ``tir`` preset through ``launch.main`` from the HF
    directory at its own engine and trainer widths (32 slots of max_len
    32,768, prefill buckets 512-16,384, packed rows of L 32,768 under GSPO,
    ``attn_impl: auto`` on the GQA kernels), on one card. Every rollout's
    reward is the one its texts give (``tir_rewards``) for some answer
    status; no rollout has more than ``max_turns`` turns; the
    step's losses are finite; kernels #1-#4 launch; each L 32,768 pass's
    time and peak memory are logged. Returns (launches, the engine shape
    and a trained row's segment ids)."""
    out = f"{tmp}/tir"
    argv = cut_args("tir", TIR_CUTS, hf_dir, out) + [f"train_dataset_names={TIR_SETS}"]
    stats, passes, shape, wall, launches = run_rows_recorded(argv)
    cfg = compose("tir", argv[1:])
    table = RewardTable.from_config(cfg)
    max_tokens, buffer = cfg.llm.parameters.max_tokens, table.buffer_tokens
    samples = actor_samples(out)
    turns = max_stat(out, stats, "num_steps_max")
    rollouts: dict[tuple, list[dict]] = {}
    for s in samples:
        rollouts.setdefault((s["group_id"], s["rollout_index"]), []).append(s)
    tok = HFTokenizer(hf_dir)
    off = [texts[0]["reward"] for texts in rollouts.values()
           if not any(all(abs(t["reward"] - r) <= 1e-9 for t in texts) for r in tir_rewards(cfg, table, tok, texts))]
    cut = sum(1 for s in samples if n_out(s) == max_tokens and not s["finished"])
    most = max(len(texts) for texts in rollouts.values())
    rows = [p for p in passes if p["length"] == cfg.finetune.seq_length]
    losses = train_losses(out)
    calls = max_stat(out, stats, "num_python_calls_max")
    actor = stats["actor"]
    log(f"tir preset through launch.main: {wall:.1f} s wall, {actor['groups_completed']} groups, "
        f"{actor['samples_written']} samples, {actor['output_tokens']} sampled tokens, "
        f"{actor['output_tokens'] / wall:.1f} useful tokens/s; engine S {shape[0]} W {shape[1]} T_alloc {shape[2]}; "
        f"rewards {sorted(set(round(s['reward'], 4) for s in samples))[:12]}, {cut} texts cut at max_tokens "
        f"{max_tokens} (overlong buffer {buffer}), most turns in a rollout {most} (max_turns {cfg.actor.max_turns}), "
        f"most python calls {calls}; {len(rows)} train passes at L {cfg.finetune.seq_length}: "
        f"{[round(p['s'] * 1e3, 1) for p in rows]} ms, peak memory {[round(p['peak'] / 2**30, 2) for p in rows]} GiB "
        f"({[round(p['before'] / 2**30, 2) for p in rows]} GiB held before each), segments "
        f"{[int(p['segment_ids'].max()) + 1 for p in rows]}, padding {[p['padding'] for p in rows]}; losses {losses}; "
        f"launches {launches}; on {smi}")
    check(not off, f"tir rewards other than the table's plus the shaping and length terms of their texts: {off[:5]}")
    check(0 < most <= cfg.actor.max_turns and turns <= cfg.actor.max_turns,
          f"a tir rollout took {most} turns ({turns} in the stats)")
    check(stats["trainer"]["completed_steps"] == 1 and losses and all(map(math.isfinite, losses)),
          f"tir trainer {stats['trainer']}, losses {losses}")
    check(rows, "no train pass ran an L 32,768 row")
    check(all(launches[k] for k in KERNEL_KEYS), f"tir launches {launches}")
    row = max(rows, key=lambda p: int(p["segment_ids"].max()))
    return launches, {"engine": shape, "segment_ids": row["segment_ids"], "padding": row["padding"],
                      "buckets": list(cfg.engine.prefill_buckets)}


def tir_rewards(cfg, table: RewardTable, tok: HFTokenizer, texts: list[dict]) -> list[float]:
    """The rewards a tir rollout with these texts (one a turn) can get, one
    for each answer status: the math table's entry for its status and
    whether every turn finished, plus ``compute_shaping`` of its python
    calls (counted in its turns' decoded completions) and mean turn length,
    plus the overlong penalty of that mean."""
    max_gen = int(cfg.llm.parameters.max_tokens)
    finished = all(t["finished"] for t in texts)
    avg_out = sum(n_out(t) for t in texts) / len(texts)
    calls = sum(call.function.name == "run_python_code" for t in texts for call in parse_tool_calls(
        tok.decode([i for i in t["labels"] if i != -100], skip_special_tokens=True))[0])
    length = length_penalty(max_gen, int(avg_out), table.buffer_tokens) if table.buffer_tokens > 0 else 0.0
    return [get_reward(status, finished, table) + compute_shaping(cfg, status, calls, avg_out, max_gen) + length
            for status in ("correct", "wrong", "no_answer", "unparsable")]


def time_tir_shapes(dev, kernels: list[dict], tir_shapes: dict) -> None:
    """Kernel #1 at phase 21's slab (live lengths of a prompt plus up to
    512 tokens, and full lengths), #2 at its smallest and largest prefill
    buckets, and #2-#4 on the L 32,768 row it trained on, the plain
    versions of the long rows by blocks of queries."""
    time_slab(dev, kernels, "tir_slab_shape", tir_shapes["engine"], (64, 640), 21)
    buckets = tir_shapes["buckets"]
    time_prefill(dev, kernels, "tir_prefill_shape", 8, buckets[0], 21)
    time_prefill(dev, kernels, "tir_prefill_largest_shape", 1, buckets[-1], 21, block=TIR_ROW_BLOCK)
    time_train_row(dev, kernels, "tir_row_shape", tir_shapes["segment_ids"], tir_shapes["padding"], 21,
                   block=TIR_ROW_BLOCK)


def phase_coding_miniwob(hf_dir: Path, smi: str, tmp: str) -> dict[str, dict]:
    """Phase 22: the ``coding`` preset (64 slots of max_len 6,144, L 8,192)
    on ``synthetic_coding`` with no sandbox, and the ``miniwob`` preset (32
    slots of max_len 4,096, L 8,192, 8 agent loops) on ``simweb_train``
    with the simulated env in process, one step each. Every coding reward
    is the table's unparsable or no-answer entry (the hermetic path runs no
    code) plus the overlong penalty; every miniwob reward is what
    ``compute_reward`` gives under ``nico``."""
    paths = {}
    runs = {"coding": (CODING_CUTS, "[synthetic_coding]"), "miniwob": (MINIWOB_CUTS, "[simweb_train]")}
    for name, (cuts, sets) in runs.items():
        out = f"{tmp}/{name}"
        argv = cut_args(name, cuts, hf_dir, out) + [f"train_dataset_names={sets}"]
        stats, passes, shape, wall, launches = run_rows_recorded(argv)
        cfg = compose(name, argv[1:])
        samples = actor_samples(out)
        losses = train_losses(out)
        if name == "coding":
            table = RewardTable.from_config(cfg)
            max_tokens = cfg.llm.parameters.max_tokens
            off = []
            for s in samples:
                suffix = "finished" if s["finished"] else "not_finished"
                base = {getattr(table, f"{status}_{suffix}") for status in ("unparsable", "no_answer")}
                penalty = length_penalty(max_tokens, n_out(s), table.buffer_tokens)
                if not any(abs(s["reward"] - b - penalty) < 1e-9 for b in base):
                    off.append(s["reward"])
            check(not off, f"coding rewards off the hermetic table plus the overlong penalty: {off[:5]}")
            note = f"compile errors (code refused) {max_stat(out, stats, 'compile_error_max')}"
        else:
            loops = max_stat(out, stats, "n_llm_calls_max")
            off = [s["reward"] for s in samples
                   if s["reward"] != -1.0 and not any(abs(s["reward"] - 0.99**k) < 1e-12 for k in range(2 * loops + 1))]
            check(not off, f"miniwob rewards off compute_reward's nico values: {off[:5]}")
            check(0 < loops <= cfg.actor.agent_max_loops, f"a miniwob episode took {loops} LLM calls")
            note = f"most LLM calls in an episode {loops} (agent_max_loops {cfg.actor.agent_max_loops})"
        log(f"{name} preset through launch.main: {wall:.1f} s wall, {len(samples)} samples, engine S {shape[0]} "
            f"W {shape[1]} T_alloc {shape[2]}, rewards {sorted(set(round(s['reward'], 4) for s in samples))[:12]}, "
            f"{note}, {len(passes)} train passes of L {sorted({p['length'] for p in passes})}, peak memory "
            f"{max(p['peak'] for p in passes) / 2**30:.2f} GiB, losses {losses}, launches {launches}; on {smi}")
        check(stats["trainer"]["completed_steps"] == 1 and losses and all(map(math.isfinite, losses)),
              f"{name} losses {losses}")
        check(all(launches[k] for k in KERNEL_KEYS), f"{name} launches {launches}")
        paths[name] = launches
        torch.cuda.empty_cache()
    return paths


def phase_deep_research(hf_dir: Path, smi: str, tmp: str) -> dict:
    """Phase 23: deep_research through the ``base`` preset (32 slots of
    max_len 2,048) with the research policy and loader: one step, every
    reward from the domain's set (1 or -0.5 less 0.05 a step after the
    first, or -1 without an answer)."""
    out = f"{tmp}/deep_research"
    argv = cut_args("base", RESEARCH_CUTS, hf_dir, out)
    stats, passes, shape, wall, launches = run_rows_recorded(argv)
    cfg = compose("base", argv[1:])
    loops = int(cfg.actor.get("max_loops", 8))
    allowed = [-1.0] + [base - 0.05 * k for base in (1.0, -0.5) for k in range(loops)]
    samples = actor_samples(out)
    off = [s["reward"] for s in samples if not any(abs(s["reward"] - r) < 1e-9 for r in allowed)]
    losses = train_losses(out)
    log(f"deep_research through the base preset: {wall:.1f} s wall, {len(samples)} samples, engine S {shape[0]} "
        f"W {shape[1]} T_alloc {shape[2]}, rewards {sorted(set(round(s['reward'], 4) for s in samples))}, most steps "
        f"{max_stat(out, stats, 'num_steps_max')}, searches {max_stat(out, stats, 'num_searches_max')}, losses "
        f"{losses}, launches {launches}; on {smi}")
    check(samples and all(s["domain"] == "deep_research" for s in samples), "no deep_research samples")
    check(not off, f"deep_research rewards off the domain's set: {off[:5]}")
    check(stats["trainer"]["completed_steps"] == 1 and losses and all(map(math.isfinite, losses)),
          f"deep_research losses {losses}")
    check(all(launches[k] for k in KERNEL_KEYS), f"deep_research launches {launches}")
    return launches


# phase 24: the logic preset in processes mode over two local host names
# (the stream hub starts, every topic rides it; two verifier servers), with
# an eval after each version on 8 problems of the synthetic test set. Cut:
# 128 new tokens for training and eval (from 4,096 and 512), 64 samples a
# step (from 1,024), 3 steps, and no checkpoint (phase 14 runs the save);
# max_lag 0 lets the actor run one step ahead of the trainer at most, so the
# eval after the first step ends before the third step's rollouts start.
# The loss is the preset's (no entropy bonus)
LOGIC_PROCESSES_CUTS = {"llm.parameters.max_tokens": 128, "test_llm.parameters.max_tokens": 128,
                        "finetune.samples_per_step": 64, "finetune.max_train_steps": 3, "max_lag": 0,
                        "eval_every_n_versions": 1, "test_subset": 8, "world.env_replicas": 2,
                        "finetune.save_checkpoint_steps": 0}
LOGIC_HOSTS = "[127.0.0.1,localhost]"


def phase_logic_processes(hf_dir: Path, smi: str, tmp: str) -> dict:
    """Phase 24: the ``logic`` preset through ``python -m
    pipelinerl_tpu_torch.launch launch_mode=processes`` from the HF
    directory at its own engine and trainer widths (64 slots of max_len
    6,144, prefill buckets 256-1,024, L 8,192 rows, flash attention), placed
    over ``world.hosts`` [127.0.0.1, localhost]: the stream hub, two
    ``LogicEnvironment`` verifier jobs, the device job, the actor and the
    preprocessor. Gates: exit 0 and no child left; the trainer's steps done
    and the engine on its last version; each verifier answered
    ``/verify_answer`` with 200 (its request log); the hub's ``.scf`` mirror
    of ``actor``, ``training_data``, ``stats`` and ``stats_test`` read back
    through the port's frame reader with the counts the hub, the actor and
    the preprocessor report; a ``stats_test`` snapshot for each eval, the
    first eval whole; kernels #1-#4 launched in the device job."""
    out = f"{tmp}/logic_processes"
    argv = cut_args("logic", LOGIC_PROCESSES_CUTS, hf_dir, out) + [
        "launch_mode=processes", f"world.hosts={LOGIC_HOSTS}", f"world.engine_start_port={free_port()}",
        f"world.stream_hub_port={free_port()}", f"world.environment_start_port={free_port()}"]
    t0 = time.monotonic()
    try:
        proc = subprocess.run([sys.executable, "-m", "pipelinerl_tpu_torch.launch", *argv], capture_output=True,
                              text=True, timeout=600, cwd=Path(__file__).resolve().parent)
    finally:
        left = survivors(f"--config-dir={out}/conf")
        for pid in left:
            os.kill(pid, signal.SIGKILL)
    wall = time.monotonic() - t0
    check(proc.returncode == 0, f"logic in processes mode exited {proc.returncode}: {proc.stderr[-3000:]}")
    check(not left, f"children outlived the launcher: {left}")
    jobs = json.loads(proc.stdout.strip().splitlines()[-1])["jobs"]
    device, actor = jobs["device_0"], jobs["actor_0"]
    trainer = device["trainer"]
    check(trainer["completed_steps"] == LOGIC_PROCESSES_CUTS["finetune.max_train_steps"]
          and device["version"] == trainer["last_broadcasted_version"] > 0,
          f"trainer {trainer}, the engine ended on {device['version']}")
    verifier = {name: job["requests"].get("/verify_answer", {}) for name, job in jobs.items()
                if name.startswith("environment_")}
    check(len(verifier) == 2 and all(v.get("200", 0) >= 1 and set(v) == {"200"} for v in verifier.values()),
          f"verifier request logs {verifier}")
    hub = jobs["stream_hub_0"]["keys"]
    frames = {}
    for topic in ("actor", "training_data", "stats", "actor_test", "stats_test"):
        key = f"{topic}/0/0"
        frames[topic] = list(FrameReader(Path(out) / "streams_hub" / f"{key}.scf").read_available())
        check(key in hub and len(frames[topic]) == hub[key]["messages"] > 0,
              f"{key}: {len(frames[topic])} frames on disk, the hub reports {hub.get(key)}")
    check(len(frames["actor"]) == actor["actor"]["groups_completed"],
          f"{len(frames['actor'])} actor frames, the actor wrote {actor['actor']['groups_completed']} groups")
    packed = sum(b["num_sequences"] for b in frames["training_data"])
    check(packed == jobs["preprocessor_0"]["published_samples"],
          f"{packed} samples in training_data frames, the preprocessor published "
          f"{jobs['preprocessor_0']['published_samples']}")
    evals = actor["evals"]
    check(evals and evals[0]["groups"] == LOGIC_PROCESSES_CUTS["test_subset"]
          and len(frames["stats_test"]) >= len(evals), f"evals {evals}, {len(frames['stats_test'])} stats_test frames")
    table = RewardTable.from_config(compose("logic", ["output_dir=/tmp/unused"]))
    allowed = {v for k, v in vars(table).items() if k != "buffer_tokens"}
    rewards = [s["reward"] for g in frames["actor"] for s in g["samples"]]
    check(rewards and set(rewards) <= allowed, f"logic rewards off the table: {sorted(set(rewards) - allowed)}")
    launches = device["kernel_launches"]
    check(all(launches[k] for k in KERNEL_KEYS), f"logic processes launches {launches}")
    hub_note = ", ".join(f"{k} {v['messages']} msgs / {v['bytes']} B" for k, v in sorted(hub.items()))
    log(f"logic preset in processes mode over {LOGIC_HOSTS} (stream hub, 2 verifiers, device job): {wall:.1f} s wall, "
        f"{trainer['completed_steps']} steps, version {trainer['last_broadcasted_version']} (engine "
        f"{device['version']}), {actor['actor']['output_tokens']} sampled tokens, "
        f"{actor['actor']['output_tokens'] / wall:.1f} useful tokens/s; verifier /verify_answer answers {verifier}; "
        f"hub {hub_note}; evals {evals} with {len(frames['stats_test'])} stats_test snapshots; rewards "
        f"{sorted(set(rewards))}; launches {launches}, no child left; on {smi}")
    return launches


def start_launch(cmd: list[str], out: str) -> tuple[subprocess.Popen, float]:
    """A ``launch`` run in a child process, its output to ``<out>.out`` and
    ``<out>.err``; → (the process, its start time on the wall clock)."""
    t0 = time.time()
    with open(f"{out}.out", "w") as so, open(f"{out}.err", "w") as se:
        proc = subprocess.Popen(cmd, stdout=so, stderr=se, text=True, cwd=Path(__file__).resolve().parent,
                                start_new_session=True)
    return proc, t0


def job_logs(exp: str, chars: int = 2000) -> str:
    """The end of each job log a processes-mode run wrote under
    ``<exp>/logs/``, for a failure's message."""
    return "\n".join(f"--- {p.name}: {p.read_text(errors='replace')[-chars:]}"
                     for p in sorted(Path(exp, "logs").glob("*.out")))


def finish_launch(run: tuple[subprocess.Popen, float], exp: str, out: str, timeout: float) -> tuple[int, str, str,
                                                                                                     float, list]:
    """Wait for a ``start_launch`` run, then kill what it left; → (exit
    code, stdout, stderr, wall, the pids that outlived it). The wall runs to
    the run's last write (its summary line), not to this wait: a run read
    after another phase ended before it."""
    proc, t0 = run
    try:
        proc.wait(timeout=max(1.0, t0 + timeout - time.time()))
    except subprocess.TimeoutExpired:
        stop_group(proc)
    finally:
        left = survivors(f"--config-dir={exp}/conf")
        for pid in left:
            os.kill(pid, signal.SIGKILL)
    wall = max(os.path.getmtime(f"{out}.out"), os.path.getmtime(f"{out}.err")) - t0
    return proc.returncode, Path(f"{out}.out").read_text(), Path(f"{out}.err").read_text(), wall, left


def start_processes(exp: str, split: bool) -> tuple[subprocess.Popen, float]:
    """Phase 17's run: bandit_tpu through ``launch`` in processes mode."""
    layout = ["world.trainer_procs=1"] if split else []
    cmd = [sys.executable, "-m", "pipelinerl_tpu_torch.launch", "--config-name=bandit_tpu", f"output_dir={exp}",
           "launch_mode=processes", "finetune.save_checkpoint_steps=0", "engine.attn_impl=gqa",
           "finetune.attn_impl=gqa", f"world.engine_start_port={free_port()}", *layout]
    return start_launch(cmd, exp)


def phase_processes(exp: str, split: bool, smi: str, run: tuple[subprocess.Popen, float]) -> dict:
    """Phase 17: a ``start_processes`` run's gates. The device-job and the
    split runs go side by side (a toy model: the card and most cores sit
    idle under one), so the phase takes about one run's wall."""
    returncode, stdout, stderr, wall, left = finish_launch(run, exp, exp, 600)
    proc = subprocess.CompletedProcess([], returncode, stdout, stderr)
    label = "split (engine job + trainer job)" if split else "device job"
    check(proc.returncode == 0, f"processes mode ({label}) exited {proc.returncode}: {proc.stderr[-3000:]}")
    check(not left, f"children outlived the launcher: {left}")
    jobs = json.loads(proc.stdout.strip().splitlines()[-1])["jobs"]
    engine = jobs["engine_0" if split else "device_0"]
    trainer = jobs["trainer_0" if split else "device_0"]["trainer"]
    check(trainer["completed_steps"] >= 10, f"the trainer completed {trainer['completed_steps']} steps")
    check(engine["version"] == trainer["last_broadcasted_version"] > 0,
          f"the engine ended on {engine['version']}, the trainer pushed {trainer['last_broadcasted_version']}")
    if split:
        pushes = jobs["trainer_0"]["pushes"]
        check(engine["push"]["pushes_completed"] == engine["push"]["pushes_received"] == len(pushes)
              and engine["push"]["push_last_version"] == pushes[-1]["version"],
              f"not every version reached the engine over PWT3: {engine['push']}, {len(pushes)} pushes")
        launches = {k: engine["kernel_launches"][k] + jobs["trainer_0"]["kernel_launches"][k]
                    for k in engine["kernel_launches"]}
        check(engine["kernel_launches"]["decode"] and engine["kernel_launches"]["gqa_fwd"]
              and all(jobs["trainer_0"]["kernel_launches"][k] for k in ("gqa_fwd", "gqa_dq", "gqa_dkv")),
              f"kernel launches: engine {engine['kernel_launches']}, trainer {jobs['trainer_0']['kernel_launches']}")
        post = [p["post_s"] for p in pushes[1:]]
        push_note = (f", {len(pushes)} PWT3 pushes of {pushes[-1]['bytes']} bytes, POST to 200 median "
                     f"{statistics.median(post) * 1e3:.1f} ms")
    else:
        launches = engine["kernel_launches"]
        check(all(launches[k] for k in ("decode", "gqa_fwd", "gqa_dq", "gqa_dkv")), f"kernel launches {launches}")
        push_note = ""
    snaps = list(StreamReader(SingleStreamSpec(exp, "stats")).read_available())
    rewards = [s["reward_mean"] for s in snaps if "reward_mean" in s]
    check(len(rewards) >= 4, f"too few stats snapshots: {rewards}")
    early, late = sum(rewards[:2]) / 2, sum(rewards[-2:]) / 2
    log(f"bandit_tpu in processes mode, {label}: {wall:.1f} s wall, {trainer['completed_steps']} steps, version "
        f"{trainer['last_broadcasted_version']} (engine {engine['version']}), reward {early:.3f} -> {late:.3f} "
        f"(snapshots {[round(r, 3) for r in rewards]}){push_note}, launches {launches}, no child left; on {smi}")
    check(late > early + 0.1, f"processes mode ({label}) did not learn: reward {early:.3f} -> {late:.3f}")
    return launches


# ---------------------------------------------------------------------------
# phases 25-26: the VLM path
# ---------------------------------------------------------------------------

# Qwen2.5-VL-3B-Instruct's published config.json
# (https://huggingface.co/Qwen/Qwen2.5-VL-3B-Instruct/blob/main/config.json),
# written out by hand; weights random from seed 0
QWEN25VL3B_CONFIG = {
    "architectures": ["Qwen2_5_VLForConditionalGeneration"], "attention_dropout": 0.0, "bos_token_id": 151643,
    "eos_token_id": 151645, "vision_start_token_id": 151652, "vision_end_token_id": 151653,
    "vision_token_id": 151654, "image_token_id": 151655, "video_token_id": 151656, "hidden_act": "silu",
    "hidden_size": 2048, "initializer_range": 0.02, "intermediate_size": 11008, "max_position_embeddings": 128000,
    "max_window_layers": 70, "model_type": "qwen2_5_vl", "num_attention_heads": 16, "num_hidden_layers": 36,
    "num_key_value_heads": 2, "rms_norm_eps": 1e-06, "rope_theta": 1000000.0, "sliding_window": 32768,
    "tie_word_embeddings": True, "torch_dtype": "bfloat16", "use_cache": True, "use_sliding_window": False,
    "vision_config": {"depth": 32, "hidden_act": "silu", "hidden_size": 1280, "intermediate_size": 3420,
                      "num_heads": 16, "in_chans": 3, "out_hidden_size": 2048, "patch_size": 14,
                      "spatial_merge_size": 2, "spatial_patch_size": 14, "window_size": 112,
                      "fullatt_block_indexes": [7, 15, 23, 31], "tokens_per_second": 2, "temporal_patch_size": 2},
    "rope_scaling": {"type": "mrope", "mrope_section": [16, 24, 24]},
    "vocab_size": 151936,
}
# phase 26's images: raw RGB of these sizes (height, width), which
# Qwen2.5-VL's smart_resize (factor 28) maps onto patch grids of 609, 1,024
# and 1,008 merged tokens, one GRPO group each (their prompts land in the
# 1,024 and 2,048 buckets). Each fits the tower's default bucket of 1,024
# merged tokens: 4,096 patches, whose dense [16, N, N] fp32 scores are 1.07
# GB a layer (the next bucket, 4,096 tokens, would hold 17.2 GB)
VLM_SIZES = [(600, 800), (900, 900), (780, 1000)]
VLM_GRIDS = [(1, 42, 58), (1, 64, 64), (1, 56, 72)]
# the groups of these sizes send committed JPEGs (chart images; a baseline
# 4:2:0 file and a progressive 4:4:4 one, ``tests/test_torch_jpeg.py``
# builds them) as data URLs; the image gates run PNG at all three sizes
VLM_JPEGS = {(900, 900): "chart_900x900_baseline_420.jpg", (780, 1000): "chart_780x1000_progressive_444.jpg"}
# the 600x800 group sends the committed lossy WebP with an ALPH chunk, and
# the image gates run one committed file of each other format the port
# reads beside PNG and JPEG (``tests/test_torch_image_fixtures.py`` builds
# them all under fixtures/images/)
VLM_WEBP = {(600, 800): "chart_600x800_lossy_alpha.webp"}
GATE_IMAGES = ("chart_480x640.gif", "chart_480x640_rle8.bmp", "chart_480x640_lzw_predictor.tif",
               "chart_480x640_jpeg.tif", "chart_480x640_lossless.webp")
# every committed chart and raw image, and the SHA-256 of PIL's RGB of each
# (``tests/test_torch_image_fixtures.py`` writes them)
IMAGE_DIGESTS = json.loads((FIXTURE_TOKENIZER.parent / "images" / "digests.json").read_text())
# the gates of the formats ported after WebP: the committed charts that no
# earlier gate or group sends
RASTER_GATES = tuple(name for name in IMAGE_DIGESTS if not name.startswith("raw_")
                     and name not in (*GATE_IMAGES, *VLM_WEBP.values()))
# raw images, one committed ``raw_96x128_<kind>.npy`` each, and the mode
# each stands for: a 2-D array of a dtype PIL reads as I;16, I or F (kind
# in lower case; mode None, as ``Image.fromarray`` reads it), or a PIL
# image's samples in a mode (as ``__array_interface__`` gives them; I;16's
# kind is I16, PA's palette is a file of its own)
RAW_GATES = {name: None if kind.islower() else kind.replace("I16", "I;16")
             for name in IMAGE_DIGESTS if name.startswith("raw_") for kind in [name[len("raw_96x128_"):-len(".npy")]]}
RAW_PALETTE = "raw_96x128_PA_palette.npy"


class ModeImage:
    """A raw image as a PIL image shows itself to the port (the card host
    has no PIL): ``mode``, ``__array_interface__``, ``getpalette()``."""

    def __init__(self, array: np.ndarray, mode: str, palette: list[int] | None = None):
        self.array, self.mode, self.palette = array, mode, palette

    @property
    def __array_interface__(self) -> dict:
        return self.array.__array_interface__

    def getpalette(self) -> list[int] | None:
        return self.palette


def raw_gate_image(folder: Path, name: str):
    """The raw image of ``RAW_GATES[name]``: the array, or a ``ModeImage``."""
    array = np.load(folder / name)
    mode = RAW_GATES[name]
    if mode is None:
        return array
    palette = np.load(folder / RAW_PALETTE).tolist() if mode == "PA" else None
    return ModeImage(array, mode, palette)


# Qwen2.5-VL-3B-Instruct's published preprocessor_config.json
QWEN25VL3B_PREPROCESSOR = {
    "min_pixels": 3136, "max_pixels": 12845056, "patch_size": 14, "temporal_patch_size": 2, "merge_size": 2,
    "image_mean": [0.48145466, 0.4578275, 0.40821073], "image_std": [0.26862954, 0.26130258, 0.27577711],
    "image_processor_type": "Qwen2VLImageProcessor", "processor_class": "Qwen2_5_VLProcessor",
}
# the chartqa preset's cuts for phase 26, each logged beside the preset's
# value
VLM_CUTS = {"llm.parameters.max_tokens": 128, "finetune.samples_per_step": 8, "finetune.max_train_steps": 1,
            "attempts": 8, "finetune.train_vision_tower": "true", "finetune.param_dtype": "bfloat16",
            "finetune.save_checkpoint_steps": 0}
# the push's extra device memory beyond two stream pieces: the decode
# windows that run meanwhile (logits [16, 151,936] fp32, the staged band)
# and the caching allocator's 2 MiB rounding
PUSH_SLACK_BYTES = 64 << 20


# a vlm_bandit_cpu run in a child process: ``launch.main``'s summary line,
# then the child's kernel launches
VLM_BANDIT_CHILD = (
    "import json, sys\n"
    "from pipelinerl_tpu_torch import launch\n"
    "from pipelinerl_tpu_torch.ops import kernel_launches\n"
    "launch.main(sys.argv[1:])\n"
    "print('LAUNCHES ' + json.dumps(kernel_launches()), flush=True)\n"
)


def start_vlm_bandit(tmp: str) -> tuple[list[subprocess.Popen], float]:
    """Phase 25's two runs of the ``vlm_bandit_cpu`` preset, one child
    process each, their output to ``<tmp>/vlm_bandit<i>.out`` and ``.err``;
    → (the processes, their start on the monotonic clock)."""
    procs = []
    t0 = time.monotonic()
    for attempt in range(2):
        out = f"{tmp}/vlm_bandit{attempt}"
        with open(f"{out}.out", "w") as so, open(f"{out}.err", "w") as se:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", VLM_BANDIT_CHILD, "--config-name=vlm_bandit_cpu", f"output_dir={out}",
                 "finetune.save_checkpoint_steps=0"],
                cwd=Path(__file__).resolve().parent, stdout=so, stderr=se, text=True, start_new_session=True))
    return procs, t0


def phase_vlm_bandit(tmp: str, run: tuple[list[subprocess.Popen], float]) -> dict:
    """Phase 25: ``start_vlm_bandit``'s runs, the ``vlm_bandit_cpu`` preset
    inline on the card with JAX's gate (tests/test_e2e_vlm_bandit.py): at
    least 100 steps, and a success tail of at least 0.7 in one of two runs
    (an image-blind policy caps at 0.5; identical runs read 0.60-0.94 on the
    card). The two runs go side by side, so the phase takes one run's wall.
    Returns the kernel launches of both."""
    procs, t0 = run
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, t0 + 900 - time.monotonic()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                stop_group(proc)
    wall = time.monotonic() - t0
    tails, total = [], {}
    for attempt, proc in enumerate(procs):
        stdout, stderr = (Path(f"{tmp}/vlm_bandit{attempt}.{ext}").read_text() for ext in ("out", "err"))
        check(proc.returncode == 0, f"vlm_bandit run {attempt + 1} exited {proc.returncode}: {stderr[-3000:]}")
        lines = stdout.strip().splitlines()
        launches = json.loads(lines[-1].removeprefix("LAUNCHES "))
        stats = json.loads(next(line for line in reversed(lines) if line.startswith("{")))
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        tails.append(stats["actor"]["success_tail_mean"])
        log(f"vlm_bandit_cpu through launch.main on the card, run {attempt + 1} of 2 side by side: "
            f"{stats['trainer']['completed_steps']} steps, success tail {tails[-1]:.4f}, success mean "
            f"{stats['actor']['success_mean']:.4f}, engine prefills {stats['engine']['prefill_batches']} "
            f"(reused tokens {stats['engine']['prefill_reused_tokens']}), launches {launches}")
        check(stats["trainer"]["completed_steps"] >= 100, f"vlm_bandit trained {stats['trainer']['completed_steps']} steps")
        check(launches["decode"] > 0, f"vlm_bandit's decode did not launch kernel #1: {launches}")
    log(f"vlm_bandit_cpu: two runs in {wall:.1f} s of wall, success tails {[round(t, 4) for t in tails]}")
    check(max(tails) >= 0.7, f"vlm_bandit never cleared a success tail of 0.7: {tails}")
    return total


def phase_vlm_paged(dev) -> tuple[dict, dict]:
    """Phase 25, paged: the toy VLM of ``vlm_bandit_cpu`` on a slab engine
    and on a paged one (16-token pages) from the same weights; 8 greedy
    requests of 4 images, two of each (a GRPO fork), give the same tokens
    on both layouts. Returns the slab's and the paged run's launches."""
    from pipelinerl_tpu_torch.domains.vlm_bandit import make_image
    from pipelinerl_tpu_torch.models.toy_tokenizer import ToyVisualProcessor
    from pipelinerl_tpu_torch.train.trainer import detached_copy

    base = compose("vlm_bandit_cpu", ["output_dir=/unused"])
    params, mc, tok = launch.build_model(base, "cuda")
    tower, vc = launch.build_vision(base, mc, "cuda")
    processor = ToyVisualProcessor(tok, vc.spatial_merge_size)
    specs = []
    for i, sign in enumerate((1, -1, 1, -1)):
        ids, visual = processor([{"role": "user", "content": [
            {"type": "image", "image": make_image(sign, vc.patch_dim, seed=i)}, {"type": "text", "text": "press"}]}])
        specs += [(ids, visual)] * 2
    outs, launches = {}, {}
    for layout in ("slab", "paged"):
        cfg = compose("vlm_bandit_cpu", ["output_dir=/unused", f"engine.kv_layout={layout}", "engine.kv_block_size=16"])
        engine = launch.build_engine(cfg, launch.engine_params(params), mc, tok, "cuda", detached_copy(tower), vc)
        reset_counts()
        futs = [engine.submit(GenRequest(list(ids), SamplingParams(temperature=0.0, max_tokens=24), visual=vis))
                for ids, vis in specs]
        for _ in range(5000):
            engine.step()
            if all(f.done() for f in futs):
                break
        torch.cuda.synchronize()
        launches[layout] = counts()
        outs[layout] = [f.result().token_ids for f in futs]
        log(f"toy VLM on the {layout} engine: {engine.prefill_batches} prefills, "
            f"{engine.prefill_reused_tokens} prompt tokens forked, launches {launches[layout]}")
        engine.stop()
    log(f"toy VLM greedy tokens, slab {outs['slab'][:2]} ... paged {outs['paged'][:2]} ...")
    check(outs["slab"] == outs["paged"], "the paged VLM engine's greedy tokens differ from the slab's")
    check(all(len(t) == 24 or (t and t[-1] == tok.eos_token_id) for t in outs["paged"]), "a VLM request fell short")
    check(launches["paged"]["paged"] > 0 and launches["slab"]["decode"] > 0 and not launches["paged"]["decode"],
          f"VLM decode launches: {launches}")
    return launches["slab"], launches["paged"]


def vlm_first_token_reward(problem: dict, token_ids: list[int], vocab: int) -> tuple[float, int]:
    """vlm_bandit's reward over the fixture vocabulary: a "+" image wants a
    first token in the lower half, a "-" image one in the upper half,
    shaped by the distance to its half's centre. Returns (reward, success)."""
    if not token_ids:
        return -0.5, 0
    first, lo = token_ids[0], problem["sign"] > 0
    success = int(first < vocab // 2 if lo else first >= vocab // 2)
    centre = vocab // 8 if lo else 7 * vocab // 8
    return float(success) + 0.25 * (1.0 - abs(first - centre) / vocab), success


def vlm_problems(n_groups: int) -> list[dict]:
    """chartqa problems over raw uint8 RGB images, one of ``VLM_SIZES``
    each: noise N(0, 40) about a grey of 128 plus 48 times a sign that
    vlm_bandit's reward reads (also under ``noise``). The groups of
    ``VLM_JPEGS``' and ``VLM_WEBP``'s sizes carry the committed file
    instead, as a pre-built message with its data URL (its decoded pixels
    under ``image``, its folder and name under ``file``)."""
    from pipelinerl_tpu_torch.inference.image_pipeline import decode_image

    rng = np.random.default_rng(0)
    problems = []
    for g in range(n_groups):
        h, w = VLM_SIZES[g % len(VLM_SIZES)]
        sign = 1 if g % 2 == 0 else -1
        pixels = np.clip(rng.normal(128 + 48 * sign, 40, (h, w, 3)), 0, 255).astype(np.uint8)
        problem = {"question": f"What is the value of bar {g}?", "answer": str(g), "sign": sign, "image": pixels,
                   "noise": pixels}
        if (h, w) in VLM_JPEGS or (h, w) in VLM_WEBP:
            folder, name, mime = (("jpeg", VLM_JPEGS[h, w], "jpeg") if (h, w) in VLM_JPEGS else
                                  ("images", VLM_WEBP[h, w], "webp"))
            data = (FIXTURE_TOKENIZER.parent / folder / name).read_bytes()
            url = f"data:image/{mime};base64," + base64.b64encode(data).decode()
            problem.update(image=decode_image(data), file=(folder, name), message={"role": "user", "content": [
                {"type": "image_url", "image_url": {"url": url}}, {"type": "text", "text": problem["question"]}]})
        problems.append(problem)
    return problems


@contextlib.contextmanager
def counting_decodes():
    """Count the image files the visual processors decode, by format,
    while the block runs: → the running Counter."""
    from pipelinerl_tpu_torch.inference import processor as processor_mod
    from pipelinerl_tpu_torch.inference.image_pipeline import image_kind

    decodes, decode = collections.Counter(), processor_mod.decode_image

    def counted(data):
        decodes[image_kind(bytes(data))] += 1
        return decode(data)

    processor_mod.decode_image = counted
    try:
        yield decodes
    finally:
        processor_mod.decode_image = decode


def check_image_route(hf_dir: Path, problems: list[dict], tok,
                      smi: str) -> tuple[dict[tuple[int, int], tuple], dict[str, tuple[dict, np.ndarray]]]:
    """Phase 26's image gates: each size goes through ``multimodal_message``
    as a PNG data URL and through ``HFVisualProcessor``; its features equal
    those of the same array bit for bit, and its grid is the one
    ``smart_resize`` gives. Then each committed-file group's data URL (the
    JPEGs, the lossy WebP with alpha) and each of ``GATE_IMAGES`` (a GIF,
    an RLE8 BMP, an LZW TIFF with the predictor, a JPEG-in-TIFF, a lossless
    WebP), of ``RASTER_GATES`` and of ``RAW_GATES`` (through
    ``array_to_rgb``): its decode is PIL's RGB (the committed SHA-256) and
    its features are those of its pixels (a gate's pixels as
    ``multimodal_message`` sends them). Logs each image's host seconds
    (encode, decode, preprocess). Returns ({size: grid}, {name: (its
    message part, its RGB)} for ``RASTER_GATES`` and ``RAW_GATES``)."""
    from pipelinerl_tpu_torch.domains.chartqa.chartqa import multimodal_message
    from pipelinerl_tpu_torch.inference.image_pipeline import ImageProcessor, decode_image, decode_png, image_kind
    from pipelinerl_tpu_torch.inference.processor import HFVisualProcessor, array_to_rgb, image_source

    image_proc = ImageProcessor.from_pretrained(hf_dir)
    grids = {}
    for size, grid in zip(VLM_SIZES, VLM_GRIDS):
        image = next(p["noise"] for p in problems if p["noise"].shape[:2] == size)
        t0 = time.monotonic()
        url_msg = multimodal_message(image, "q")
        t1 = time.monotonic()
        rgb = decode_png(image_source(url_msg["content"][0]))
        t2 = time.monotonic()
        pixels, got_grid = image_proc(rgb)
        t3 = time.monotonic()
        _, from_url = HFVisualProcessor(hf_dir, tok)([url_msg])
        _, from_array = HFVisualProcessor(hf_dir, tok)([{"role": "user", "content": [
            {"type": "image", "image": image}, {"type": "text", "text": "q"}]}])
        log(f"image {size[0]}x{size[1]}: PNG data URL {len(url_msg['content'][0]['image_url']['url']) / 1e6:.2f} MB "
            f"encoded in {t1 - t0:.3f} s, decoded in {t2 - t1:.3f} s, resized, normalized and patchified in "
            f"{t3 - t2:.3f} s (host seconds) to grid {got_grid}, {pixels.shape[0]} patches; on {smi}")
        check(np.array_equal(rgb, image), f"the {size} PNG does not decode to its array")
        check(tuple(got_grid) == grid and np.array_equal(from_url["image_grid_thw"], [grid]),
              f"the {size} image maps to grid {got_grid}, not {grid}")
        check(np.array_equal(from_url["pixel_values"], from_array["pixel_values"])
              and np.array_equal(from_url["pixel_values"], pixels),
              f"the {size} data URL's features differ from the array's")
        grids[size] = grid
    checked = set()
    for problem in problems:
        if "file" not in problem or problem["file"] in checked:
            continue
        checked.add(problem["file"])
        folder, name = problem["file"]
        digests = json.loads((FIXTURE_TOKENIZER.parent / folder / "digests.json").read_text())
        part = problem["message"]["content"][0]
        t0 = time.monotonic()
        rgb = decode_image(image_source(part))
        t1 = time.monotonic()
        _, from_url = HFVisualProcessor(hf_dir, tok)([problem["message"]])
        t2 = time.monotonic()
        _, from_array = HFVisualProcessor(hf_dir, tok)([{"role": "user", "content": [
            {"type": "image", "image": rgb}, {"type": "text", "text": "q"}]}])
        size = rgb.shape[:2]
        log(f"image {size[0]}x{size[1]}: {image_kind(image_source(part))} data URL ({name}, "
            f"{len(part['image_url']['url']) / 1e6:.2f} MB) decoded in {t1 - t0:.3f} s, through the processor in "
            f"{t2 - t1:.3f} s (host seconds) to grid {[int(x) for x in from_url['image_grid_thw'][0]]}; on {smi}")
        check(hashlib.sha256(rgb.tobytes()).hexdigest() == digests[name], f"{name} does not decode to PIL's RGB")
        check(np.array_equal(from_url["pixel_values"], from_array["pixel_values"])
              and np.array_equal(from_url["image_grid_thw"], [grids[size]]),
              f"the {size} {name} data URL's features differ from its pixels'")
    check(len(checked) == len(VLM_JPEGS) + len(VLM_WEBP), f"committed-file groups {checked}")
    digests, gates = IMAGE_DIGESTS, {}
    for name in (*GATE_IMAGES, *RASTER_GATES):
        data = (FIXTURE_TOKENIZER.parent / "images" / name).read_bytes()
        part = {"type": "image_url", "image_url": {"url": "data:image/x;base64," + base64.b64encode(data).decode()}}
        t0 = time.monotonic()
        rgb = decode_image(data)
        t1 = time.monotonic()
        _, from_url = HFVisualProcessor(hf_dir, tok)([{"role": "user", "content": [part, {"type": "text", "text": "q"}]}])
        t2 = time.monotonic()
        _, from_pixels = HFVisualProcessor(hf_dir, tok)([multimodal_message(rgb, "q")])
        log(f"image gate {name} ({image_kind(data)}, {len(data)} bytes): decoded to {rgb.shape[0]}x{rgb.shape[1]} "
            f"in {t1 - t0:.3f} s, its data URL through the processor in {t2 - t1:.3f} s (host seconds) to grid "
            f"{[int(x) for x in from_url['image_grid_thw'][0]]}; on {smi}")
        check(hashlib.sha256(rgb.tobytes()).hexdigest() == digests[name], f"{name} does not decode to PIL's RGB")
        check(np.array_equal(from_url["pixel_values"], from_pixels["pixel_values"])
              and np.array_equal(from_url["image_grid_thw"], from_pixels["image_grid_thw"]),
              f"{name}'s data URL's features differ from its pixels' as a PNG data URL")
        if name in RASTER_GATES:
            gates[name] = part, rgb
    for name in RAW_GATES:
        image = raw_gate_image(FIXTURE_TOKENIZER.parent / "images", name)
        t0 = time.monotonic()
        rgb = array_to_rgb(image)
        t1 = time.monotonic()
        _, from_raw = HFVisualProcessor(hf_dir, tok)([{"role": "user", "content": [
            {"type": "image", "image": image}, {"type": "text", "text": "q"}]}])
        t2 = time.monotonic()
        _, from_pixels = HFVisualProcessor(hf_dir, tok)([multimodal_message(rgb, "q")])
        log(f"image gate {name} (mode {getattr(image, 'mode', None)}, {np.asarray(image).dtype} "
            f"{list(np.asarray(image).shape)}): converted to RGB in {t1 - t0:.4f} s, through the processor in "
            f"{t2 - t1:.3f} s (host seconds) to grid {[int(x) for x in from_raw['image_grid_thw'][0]]}; on {smi}")
        check(hashlib.sha256(rgb.tobytes()).hexdigest() == digests[name], f"{name} does not convert to PIL's RGB")
        check(np.array_equal(from_raw["pixel_values"], from_pixels["pixel_values"])
              and np.array_equal(from_raw["image_grid_thw"], from_pixels["image_grid_thw"]),
              f"{name}'s features differ from its pixels' as a PNG data URL")
        gates[name] = {"type": "image", "image": image}, rgb
    return grids, gates


IMAGE_BATCH_TIMEOUT = 120.0  # phase 26's greedy image batch: 1-5 s expected


def image_batch(engine: InferenceEngine, processor, gates: dict[str, tuple[dict, np.ndarray]],
                smi: str) -> dict[str, int]:
    """Phase 26 (a), the new inputs through the engine: one greedy batch of
    16 new tokens whose requests each carry one of ``gates`` (from
    ``check_image_route``: each of ``RASTER_GATES`` as a data URL, each of
    ``RAW_GATES`` as a raw image), through the chartqa processor; then the
    same batch with each gate's RGB as a PNG data URL
    (``multimodal_message``). The engine, not yet started, is stepped
    by hand, so both batches are admitted alike. Tokens and logprobs must
    be equal, #2 (the prefill) and #1 (the decode) launched. → the
    launches of both batches."""
    from pipelinerl_tpu_torch.domains.chartqa.chartqa import multimodal_message

    question = "What is the value of the third bar?"

    def run(messages: list[list[dict]]) -> tuple[list, float, float, dict]:
        t0 = time.monotonic()
        reqs = []
        for msgs in messages:
            ids, visual = processor(msgs)
            reqs.append(GenRequest(ids, SamplingParams(temperature=0.0, max_tokens=16), visual=visual))
        t1 = time.monotonic()
        reset_counts()
        futures = [engine.submit(r) for r in reqs]
        deadline = time.monotonic() + IMAGE_BATCH_TIMEOUT
        while not all(f.done() for f in futures):
            check(time.monotonic() < deadline, f"the greedy image batch is not done after {IMAGE_BATCH_TIMEOUT} s: "
                  f"{sum(f.done() for f in futures)} of {len(futures)} requests done")
            engine.step()
        torch.cuda.synchronize()
        return [f.result() for f in futures], t1 - t0, time.monotonic() - t1, counts()

    got, host_s, engine_s, launches = run([[{"role": "user", "content": [part, {"type": "text", "text": question}]}]
                                           for part, _ in gates.values()])
    want, twin_host_s, twin_engine_s, twin_launches = run([[multimodal_message(rgb, question)]
                                                           for _, rgb in gates.values()])
    equal = sum(g.token_ids == w.token_ids and g.logprobs == w.logprobs for g, w in zip(got, want))
    log(f"VLM greedy batch of {len(got)} requests ({len(RASTER_GATES)} file formats as data URLs, {len(RAW_GATES)} "
        f"raw images), 16 new tokens each: processed in {host_s:.2f} host s, served in {engine_s:.2f} s; its twins "
        f"(the decoded pixels as PNG data URLs) processed in {twin_host_s:.2f} s, served in {twin_engine_s:.2f} s; "
        f"{equal} of {len(got)} equal in tokens and logprobs; prompt lengths {sorted({g.prompt_tokens for g in got})}; "
        f"launches {launches} and {twin_launches}; on {smi}")
    check(equal == len(got) and all(len(g.token_ids) == 16 or g.finish_reason == "stop" for g in got),
          "the new inputs' greedy batch differs from its PNG twins'")
    check(all(c["gqa_fwd"] > 0 and c["decode"] > 0 for c in (launches, twin_launches)),
          f"the greedy batches missed #2 or #1: {launches}, {twin_launches}")
    return {k: launches[k] + twin_launches[k] for k in launches}


QWEN25VL3B = ModelConfig(
    vocab_size=151_936, hidden_size=2048, intermediate_size=11_008, num_layers=36, num_heads=16, num_kv_heads=2,
    head_dim=128, rope_theta=1_000_000.0, rms_norm_eps=1e-6, attention_bias=True, tie_word_embeddings=True,
    dtype=torch.bfloat16, mrope_section=(16, 24, 24), image_token_id=151_655,
    hf_architecture="Qwen2_5_VLForConditionalGeneration")
QWEN25VL3B_TEXT_PARAMS = 3_085_938_688  # the published model's language trunk, tied


def phase_vlm_3b(dev, smi: str, tmp: str) -> tuple[dict, dict]:
    """Phase 26: Qwen2.5-VL-3B-Instruct at full width on one card through
    the chartqa route, with ``finetune.train_vision_tower``: an HF
    directory from the port's ``export_hf`` (random bf16 weights, the
    published config.json, the fixture tokenizer with the vision tokens),
    loaded by ``launch._is_vlm_checkpoint``, ``build_model``,
    ``build_vision`` and ``build_processor`` (with the published
    ``preprocessor_config.json``); the preset's engine (S 16, max_len 8,192,
    buckets 1,024-8,192, flash) serves chartqa prompts whose chart images
    travel as the committed WebP and JPEG files' data URLs through the
    port's image pipeline; a step trains
    on unpacked [1, 8,192] rows; then the
    trainer's tree goes to the engine as one PWT3 body while 8 requests
    decode. Gates (a)-(e) are checked in turn. Returns (launches, the shapes
    the kernels ran at)."""
    from pipelinerl_tpu_torch.domains.chartqa.chartqa import generate_chartqa_rollout
    from pipelinerl_tpu_torch.models.hf_loader import load_hf_vision
    from pipelinerl_tpu_torch.models.transformer import lm_head_logits
    from pipelinerl_tpu_torch.models.vision import VisionConfig, init_vision_params
    from pipelinerl_tpu_torch.train.advantages import populate_rl_data, training_text_to_sample
    from pipelinerl_tpu_torch.train.packing import pack_visual_sample
    from pipelinerl_tpu_torch.train.trainer import batch_to_tensors, detached_copy

    hf = Path(tmp) / "qwen25vl3b"
    mc = QWEN25VL3B
    vj = QWEN25VL3B_CONFIG["vision_config"]
    vc = VisionConfig(hidden_size=vj["hidden_size"], intermediate_size=vj["intermediate_size"], num_heads=vj["num_heads"],
                      depth=vj["depth"], out_hidden_size=vj["out_hidden_size"], patch_size=vj["patch_size"],
                      temporal_patch_size=vj["temporal_patch_size"], spatial_merge_size=vj["spatial_merge_size"],
                      window_size=vj["window_size"], fullatt_block_indexes=tuple(vj["fullatt_block_indexes"]),
                      tokens_per_second=vj["tokens_per_second"], dtype=mc.dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    tree = init_params(gen, mc, dev)
    tree["vision_tower"] = init_vision_params(gen, vc, dev)
    n_text = sum(t.numel() for n, t in param_leaves(tree) if not n.startswith("vision_tower."))
    n_tower = sum(t.numel() for n, t in param_leaves(tree["vision_tower"]))
    t0 = time.monotonic()
    export_hf(hf, tree, mc, vision_cfg=vc)
    write_s = time.monotonic() - t0
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    hf_dir = hf / CURRENT_DIR
    (hf_dir / "config.json").write_text(json.dumps(QWEN25VL3B_CONFIG, indent=2))
    vl_tokenizer_dir(hf_dir)
    (hf_dir / "preprocessor_config.json").write_text(json.dumps(QWEN25VL3B_PREPROCESSOR, indent=2))
    size = (hf_dir / "model.safetensors").stat().st_size
    log(f"Qwen2.5-VL-3B directory: {n_text:,} language and {n_tower:,} tower parameters, {size / 1e9:.3f} GB "
        f"written by export_hf in {write_s:.1f} s")
    check(n_text == QWEN25VL3B_TEXT_PARAMS, f"the language trunk has {n_text:,} parameters, Qwen2.5-VL-3B's "
          f"has {QWEN25VL3B_TEXT_PARAMS:,}")

    # the chartqa route
    check(launch._is_vlm_checkpoint(str(hf_dir)), "the directory does not read as a VLM checkpoint")
    base = compose("chartqa", [f"model_path={hf_dir}", f"output_dir={tmp}/chartqa"])
    log("chartqa preset cuts: " + ", ".join(f"{k} {v} (preset {base.select(k)})" for k, v in VLM_CUTS.items()))
    cfg = compose("chartqa", [f"model_path={hf_dir}", f"output_dir={tmp}/chartqa",
                              *(f"{k}={v}" for k, v in VLM_CUTS.items())])
    launch.validate_config(cfg)
    t0 = time.monotonic()
    params, model_cfg, tok = launch.build_model(cfg, dev)
    tower, vcfg = launch.build_vision(cfg, model_cfg, dev)
    processor = launch.build_processor(cfg, tok, vcfg)
    read_s = time.monotonic() - t0
    check((model_cfg.mrope_section, model_cfg.image_token_id, model_cfg.num_layers, vcfg) ==
          (mc.mrope_section, mc.image_token_id, mc.num_layers, vc), f"the checkpoint read back as {model_cfg} / {vcfg}")
    engine = launch.build_engine(cfg, launch.engine_params(params), model_cfg, tok, dev, detached_copy(tower), vcfg)
    trainer = TrainerLoop(cfg, params, model_cfg, f"{tmp}/chartqa", vision_params=tower, vision_cfg=vcfg)
    check(trainer.train_vision and trainer.attn_impl in ("flash", "gqa"), "the trainer's route is not the chartqa one")
    log(f"loaded through the chartqa route in {read_s:.1f} s; engine S {engine.cfg.max_slots} max_len "
        f"{engine.cfg.max_len} buckets {engine.buckets} attn {engine.attn_impl}/{engine.decode_attn_impl}, tower "
        f"buckets {engine.cfg.vision_unit_buckets}; device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # (a) rollouts: chartqa prompts with raw images as PNG data URLs, GRPO
    # groups of 8
    attempts = int(cfg.attempts)
    n_train = int(cfg.finetune.max_train_steps) * int(cfg.finetune.samples_per_step)
    problems = vlm_problems(max(len(VLM_SIZES), -(-n_train // attempts)))
    t0 = time.monotonic()
    with counting_decodes() as decodes:
        grids, gates = check_image_route(hf_dir, problems, tok, smi)
    log(f"image gates: {time.monotonic() - t0:.1f} host s, the processors' decodes {dict(decodes)}")
    t0 = time.monotonic()
    batch_launches = image_batch(engine, processor, gates, smi)
    log(f"phase wall: the new inputs' greedy batches {time.monotonic() - t0:.1f} s")
    llm = InProcessLLM(engine, tok, dict(cfg.llm.parameters.items()), processor=processor)
    engine.start()
    reset_counts()
    t0 = time.monotonic()

    async def rollouts():
        return await asyncio.gather(*(generate_chartqa_rollout(cfg, llm, p, None)
                                      for p in problems for _ in range(attempts)))

    with counting_decodes() as decodes:
        results = asyncio.run(rollouts())
    torch.cuda.synchronize()
    roll_s = time.monotonic() - t0
    launches = counts()
    decodes = dict(decodes)
    n_webp = sum(1 for p in problems if p.get("file", ("", ""))[1] in VLM_WEBP.values())
    log(f"VLM rollouts decoded {decodes} image files (the WebP groups' {n_webp * attempts} rollouts each send the "
        f"lossy WebP with alpha)")
    check(decodes.get("WebP", 0) >= n_webp * attempts > 0, f"the WebP group's rollouts made {decodes} decodes")
    texts = [r.training_texts[0] for r in results]
    out_tokens = sum(t.output_tokens for t in texts)
    prompt_lens = sorted({t.prompt_tokens for t in texts})
    log(f"VLM rollouts: {len(texts)} in {roll_s:.1f} s ({out_tokens} tokens, {out_tokens / roll_s:.1f} useful "
        f"tokens/s), prompt lengths {prompt_lens}, finishes {sorted({t.finish_reason for t in texts})}, engine "
        f"{ {k: engine.perf_counters()[k] for k in ('prefill_batches', 'prefill_reused_tokens', 'decode_steps')} }, "
        f"launches {launches}")
    check(all(t.finish_reason in ("stop", "length") and t.output_tokens > 0 for t in texts),
          "a VLM rollout did not finish")
    check(launches["gqa_fwd"] > 0 and launches["decode"] > 0, f"the VLM prefill or decode missed its kernel: {launches}")
    check({engine._bucket(n) for n in prompt_lens} == {1024, 2048}, f"prompts in buckets {prompt_lens}")
    pads = [t.input_ids[: t.prompt_tokens].count(model_cfg.image_token_id) for t in texts]
    want_pads = [int(np.prod(grids[p["image"].shape[:2]])) // 4 for p in problems for _ in range(attempts)]
    check(pads == want_pads, f"image pads per prompt {sorted(set(pads))}, want {sorted(set(want_pads))}")

    # (b) the engine's logprobs against the trainer's forward of the same row
    L = int(cfg.finetune.seq_length)
    image_id, merge = int(model_cfg.image_token_id), vcfg.spatial_merge_size
    errs = []
    for text in (texts[::attempts] + texts[1:])[:4]:  # each group's first completion, then more
        sample = training_text_to_sample(text, model_version=0)
        batch = pack_visual_sample(sample, L, tok.eos_token_id, image_id, merge)
        arrays = batch_to_tensors(batch, dev)
        with torch.no_grad():
            vlm = trainer._vlm_inputs(batch, arrays)
            normed = forward(trainer.model_params(), model_cfg, arrays["input_ids"], arrays["position_ids"],
                             arrays["segment_ids"], attn_impl=trainer.attn_impl, skip_unembed=True, **vlm)
            n, m = text.prompt_tokens, text.output_tokens
            logits = lm_head_logits(trainer.model_params(), model_cfg, normed[0, n - 1 : n + m - 1]).float()
            lp = torch.log_softmax(logits / float(cfg.llm.parameters.temperature), -1)
            tf = lp.gather(-1, arrays["input_ids"][0, n : n + m, None])[:, 0].double().cpu().numpy()
        errs.append(np.abs(tf - np.asarray(text.logprobs)))
        del normed, logits, lp, vlm
    errs = np.concatenate(errs)
    log(f"VLM engine logprobs against the trainer's forward of the spliced [1, {L}] rows: mean abs err "
        f"{errs.mean():.4f} (tolerance {TF_MEAN_ATOL}), max {errs.max():.4f} (tolerance {TF_MAX_ATOL}) over "
        f"{errs.size} tokens of 4 completions")
    check(errs.mean() <= TF_MEAN_ATOL and errs.max() <= TF_MAX_ATOL, "the VLM engine and trainer disagree")

    # (c) a step on unpacked [1, L] rows, the tower trained
    samples = []
    for problem, group in zip(problems, [results[i : i + attempts] for i in range(0, len(results), attempts)]):
        gid = f"g{len(samples)}"
        for k, r in enumerate(group):
            text = r.training_texts[0]
            text.reward, _ = vlm_first_token_reward(problem, text.input_ids[text.prompt_tokens:], len(tok))
            text.group_id = gid
            samples.append(training_text_to_sample(text, model_version=0, rollout_index=k))
    populate_rl_data(samples, eos_token_id=tok.eos_token_id)
    passes, tower_grad = [], None
    reset_counts()
    for i, sample in enumerate(samples[:n_train]):
        batch = pack_visual_sample(sample, L, tok.eos_token_id, image_id, merge)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        metrics = trainer.train_pass(batch)
        torch.cuda.synchronize()
        passes.append({"s": time.monotonic() - t0, "peak": torch.cuda.max_memory_allocated(), "loss": metrics["loss"]})
        if i == 0:
            tower_grad = sum(float(p.grad.float().abs().sum()) for _, p in param_leaves(trainer.params["vision_tower"])
                             if p.grad is not None)
        if (i + 1) % int(cfg.finetune.samples_per_step) == 0:
            trainer.optimizer_step()
    train_launches = counts()
    launches = {k: launches[k] + train_launches[k] + batch_launches[k] for k in launches}
    rows = [len(s["input_ids"]) for s in samples[:n_train]]
    log(f"VLM train: {len(passes)} passes on [1, {L}] rows ({min(rows)}-{max(rows)} real tokens, one segment plus "
        f"padding), {[round(p['s'] * 1e3, 1) for p in passes]} ms, peak {max(p['peak'] for p in passes) / 2**30:.2f} "
        f"GiB, losses {[round(p['loss'], 4) for p in passes[:4]]}..., steps {trainer.metrics.completed_steps}, grad "
        f"norm {trainer.metrics.grad_norm:.4f}, tower |grad| sum after pass 1 {tower_grad:.4e}, launches "
        f"{train_launches}; on {smi}")
    check(trainer.metrics.completed_steps == int(cfg.finetune.max_train_steps)
          and all(math.isfinite(p["loss"]) for p in passes),
          f"the VLM trainer ran {trainer.metrics.completed_steps} steps")
    check(all(train_launches[k] >= len(passes) for k in ("gqa_fwd", "gqa_dq", "gqa_dkv")),
          f"#2-#4 did not launch on the training rows: {train_launches}")
    check(tower_grad is not None and tower_grad > 0 and math.isfinite(tower_grad), "the tower got no gradient")

    # (d) the push: the trainer's tree as one PWT3 body while 8 requests decode
    served = detached_copy(trainer.served_params())
    t0 = time.monotonic()
    body = serialize_params(served, version=trainer.metrics.samples)
    ser_s = time.monotonic() - t0
    check(len(body) > engine.cfg.push_double_buffer_max_bytes, "the push fits the double buffer")
    futs = [engine.submit(GenRequest(tok.encode(f"Tell a long story, part {i}:"),
                                     SamplingParams(temperature=0.7, max_tokens=4000), request_id=f"story{i}"))
            for i in range(8)]
    while engine.windows_dispatched < 8:
        time.sleep(0.01)
    # the peak over a second of decoding, then the peak over the push with
    # the same decoding beside it: the resident weights do not change size
    # (pieces are copied into them), so the difference is the push's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    time.sleep(1.0)
    torch.cuda.synchronize()
    decode_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    version = engine.update_params_serialized(body)
    while engine.version != version and time.monotonic() - t0 < 300:
        time.sleep(0.01)
    push_s = time.monotonic() - t0
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - decode_peak
    timings = dict(engine.last_push_timings)
    for i in range(len(futs)):
        engine.abort(f"story{i}")
    for f in futs:
        f.result(timeout=60)
    # the same body again into the idle engine: no decode transient hides
    # what the push itself holds beside the resident weights
    done = engine.push_counters()["pushes_completed"]
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.monotonic()
    engine.update_params_serialized(body)
    while engine.push_counters()["pushes_completed"] == done and time.monotonic() - t1 < 300:
        time.sleep(0.01)
    idle_s = time.monotonic() - t1
    torch.cuda.synchronize()
    idle_extra = torch.cuda.max_memory_allocated() - resident
    idle_timings = dict(engine.last_push_timings)
    engine.stop()
    landed = param_checksums(engine.live_tree())
    want = param_checksums(served)
    bound = 2 * engine.cfg.push_stream_chunk_bytes + PUSH_SLACK_BYTES
    log(f"VLM push: {len(body) / 1e9:.3f} GB body (serialized in {ser_s:.1f} s) over a double-buffer budget of "
        f"{engine.cfg.push_double_buffer_max_bytes / 1e9:.3f} GB, mode {timings.get('mode')}, {timings.get('pieces')} "
        f"pieces, row-spliced {timings.get('row_spliced')}, landed in {push_s:.2f} s ({timings.get('gbps', 0):.2f} "
        f"GB/s); peak device memory {extra / 2**20:.1f} MiB over decoding's own peak of "
        f"{decode_peak / 2**30:.3f} GiB (bound {bound / 2**20:.0f} MiB); windows during "
        f"{timings.get('windows_during')}, largest gap {timings.get('max_window_gap_s')} s against a steady "
        f"{timings.get('steady_window_gap_s')} s; the same body into the idle engine: {idle_s:.2f} s "
        f"({idle_timings.get('gbps', 0):.2f} GB/s, mode {idle_timings.get('mode')}), peak device memory "
        f"{idle_extra / 2**20:.1f} MiB over the resident {resident / 2**30:.3f} GiB; on {smi}")
    check(engine.version == version, f"the push did not land: engine at v{engine.version}, pushed v{version}")
    check(timings.get("mode") == idle_timings.get("mode") == "blob-chunked", f"the push took mode {timings.get('mode')}")
    check("embed" in (timings.get("row_spliced") or []), "the embedding was not row-spliced")
    check(extra <= bound and idle_extra <= bound,
          f"the push raised peak device memory by {extra / 2**20:.1f} MiB ({idle_extra / 2**20:.1f} MiB idle)")
    check(landed == want, f"{sum(landed[k] != want.get(k) for k in landed)} engine leaves differ from the body")
    check(any(k.startswith("vision_tower/") for k in landed), "the tower's leaves were not compared")
    check(timings.get("windows_during", 0) >= 1, "no decode window completed while the push was in flight")
    del body, served
    gc.collect()

    # (e) export_hf of the trained tower reads back bit for bit
    t0 = time.monotonic()
    out = export_hf(Path(tmp) / "qwen25vl3b_trained", trainer.served_params(), model_cfg, None, vcfg)
    back, back_cfg = load_hf_vision(out, dtype=mc.dtype, device=dev)
    exp_s = time.monotonic() - t0
    trained = dict(param_leaves(trainer.params["vision_tower"]))
    same = all(torch.equal(t, trained[n].detach()) for n, t in param_leaves(back))
    log(f"trained tower export and read-back: {exp_s:.1f} s, {len(trained)} tensors, equal {same}")
    check(same and back_cfg == vcfg, "the exported tower does not read back bit for bit")
    shapes = {"engine": (engine.cfg.max_slots, engine.cfg.decode_window, engine.T_alloc),
              "row": (L, max(rows)), "prompts": prompt_lens, "buckets": sorted({engine._bucket(n) for n in prompt_lens}),
              "heads": (model_cfg.num_heads, model_cfg.num_kv_heads, model_cfg.head_dim_)}
    del trainer, engine, params, tower, back, trained
    gc.collect()
    torch.cuda.empty_cache()
    return launches, shapes


def time_vlm_shapes(dev, kernels: list[dict], shapes: dict) -> None:
    """Kernel #2 at phase 26's prefill buckets (B 1), #1 at its slab (live
    lengths of a prompt plus up to 128 tokens, and full lengths), and #2-#4
    on an unpacked [1, 8,192] row (one segment plus padding), at Dh 128 and
    G 8, each against its plain version and timed beside SDPA and its
    bound."""
    heads = shapes["heads"]
    for bucket in shapes["buckets"]:
        time_prefill(dev, kernels, f"vlm_prefill_{bucket}_shape", 1, bucket, 26, heads=heads)
    time_slab(dev, kernels, "vlm_slab_shape", shapes["engine"], (min(shapes["prompts"]), max(shapes["prompts"]) + 128),
              26, heads=heads)
    L, n = shapes["row"]
    seg = np.concatenate([np.zeros(n, np.int32), np.ones(L - n, np.int32)])
    time_train_row(dev, kernels, "vlm_row_shape", seg, L - n, 26, heads=heads)


# ---------------------------------------------------------------------------
# phase 27: the trainer world (dp x cp ranks on torch.distributed)
# ---------------------------------------------------------------------------

# the world against one rank on the same rows, both bf16, after one AdamW
# step at WORLD_LR with no warmup (the preset's 50 warmup steps give the
# first update a rate of 0, and its lr of 1e-6 moves no bf16 weight): the
# loss and the grad norm; each leaf's Adam first moment (0.1 of its
# clipped gradient) as the norm of the difference over the reference's
# (a wrong cp or dp gradient is off by O(1)); and the updated params, where
# an element more than one bf16 step of |ref| + lr away is a flipped update
# (a gradient at its bf16 noise changes sign: 2 lr). The reference must
# have moved most of its elements. Kernel #2's split of a row's keys, the
# logits chunks and the order of the bf16 sums differ between the layouts.
# The limits are about three times the readings on an H100 (loss equal,
# grad norm 1.0e-3 to 3.1e-3, worst moment 1.5e-2, flips 5.6e-3); a wrong
# cp or dp gradient reads O(1) on each
WORLD_LR = 1e-3
WORLD_LOSS_RTOL = 1e-4
WORLD_NORM_RTOL = 1e-2
WORLD_MOMENT_RTOL = 5e-2
WORLD_FLIP_FRAC = 2e-2
WORLD_MOVED_FRAC = 0.5
DP_ROW_L = 2048  # (c)'s two rows: phase 6's training length halved
WORLD_TIMEOUT = 420.0
# (b)-(c)'s depth, cut from Qwen2.5-0.5B's 24 to pay for phase 29's time (a
# pass's gloo traffic and work scale with the layers); (d) runs the whole
# directory
WORLD_LAYERS = 12


def world_row(seg: np.ndarray, seed: int, signed: bool = True) -> TrainerBatch:
    """A packed row over the segment ids ``seg`` (contiguous runs): token
    ids within the fixture tokenizer's 540, the first 16 tokens of each
    segment its prompt, advantages and rewards +-1 by segment (``signed``)
    or +1 throughout, old logprobs -1."""
    rng = np.random.default_rng(seed)
    L = seg.shape[0]
    ids = rng.integers(1, 540, (1, L)).astype(np.int32)
    starts = np.r_[0, np.flatnonzero(np.diff(seg)) + 1]
    lengths = np.diff(np.r_[starts, L])
    pos = (np.arange(L) - np.repeat(starts, lengths))[None].astype(np.int32)
    signs = rng.choice([-1.0, 1.0], len(lengths)) if signed else np.ones(len(lengths))
    adv = np.repeat(signs, lengths)[None].astype(np.float32)
    ones = np.ones((1, L), np.float32)
    return TrainerBatch(
        input_ids=ids, labels=np.where(pos < 16, -100, ids).astype(np.int32), position_ids=pos,
        segment_ids=seg[None].astype(np.int32), rewards=adv, advantages=adv, ref_logprobs=0 * ones,
        old_logprobs=-ones, group_tokens=np.repeat(lengths, lengths)[None].astype(np.float32),
        num_labels=np.repeat(np.maximum(lengths - 16, 1), lengths)[None].astype(np.float32), overflow=0 * ones,
        num_sequences=len(lengths))


def world_args(hf_dir, out: str, part: str, n: int) -> list[str]:
    """The tir preset's overrides for (b) (``part`` "cp": its L 32,768 rows
    over ``n`` cp ranks) or (c) (``part`` "dp": L 2,048 rows over ``n`` dp
    ranks), training only."""
    common = [f"model_path={hf_dir}", f"output_dir={out}", "finetune.save_checkpoint_steps=0",
              f"finetune.learning_rate={WORLD_LR}", "finetune.num_warmup_steps=0"]
    if part == "cp":
        return [*common, f"parallel.cp={n}", "parallel.dp=1"]
    return [*common, f"finetune.seq_length={DP_ROW_L}", f"parallel.dp={n}", "parallel.cp=1"]


def spy_q_offsets() -> dict[str, set]:
    """Record the q_offset of every launch of #2-#4 in this process (the
    launch counts stay the wrappers')."""
    seen: dict[str, set] = {"gqa_fwd": set(), "gqa_dq": set(), "gqa_dkv": set()}
    for key, name in (("gqa_fwd", "_gqa_fwd_cuda"), ("gqa_dq", "mha_packed_gqa_bwd_dq"),
                      ("gqa_dkv", "mha_packed_gqa_bwd_dkv")):
        inner = getattr(gattn, name)

        def spy(*a, _inner=inner, _key=key):
            if a[0].is_cuda:
                seen[_key].add(int(a[5]))
            return _inner(*a)

        setattr(gattn, name, spy)
    return seen


def probe_gloo_cuda(dev) -> dict[str, bool]:
    """Which of the four collectives gloo takes on CUDA tensors, each tried
    on every rank of the world; the ranks agree through a CPU all-reduce
    (an op refused on one counts as refused on all). Gloo refuses an op
    before it communicates."""
    dist = torch.distributed
    world = dist.get_world_size()
    calls = {
        "all_gather_into_tensor": lambda x: dist.all_gather_into_tensor(torch.empty(2 * world, device=dev), x),
        "reduce_scatter_tensor": lambda x: dist.reduce_scatter_tensor(torch.empty(2, device=dev),
                                                                      x.repeat(world)),
        "all_reduce": dist.all_reduce,
        "broadcast": lambda x: dist.broadcast(x, src=0),
    }
    ok = []
    for call in calls.values():
        try:
            call(torch.ones(2, device=dev))
            torch.cuda.synchronize()
            ok.append(1.0)
        except (RuntimeError, ValueError, NotImplementedError):
            ok.append(0.0)
    agreed = torch.tensor(ok)
    dist.all_reduce(agreed, op=dist.ReduceOp.MIN)
    return dict(zip(calls, map(bool, agreed.tolist())))


def world_step(trainer: TrainerLoop, rows: list[TrainerBatch]) -> dict:
    """The rows' passes and one optimizer step, each pass timed
    (synchronized) with its peak device memory."""
    out = {"pass_s": [], "peak": [], "loss": 0.0}
    for row in rows:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        trainer.train_pass(row)
        torch.cuda.synchronize()
        out["pass_s"].append(time.monotonic() - t0)
        out["peak"].append(torch.cuda.max_memory_allocated())
        out["loss"] += trainer.metrics.train_loss
    t0 = time.monotonic()
    trainer.optimizer_step()
    torch.cuda.synchronize()
    out.update(step_s=time.monotonic() - t0, grad_norm=trainer.metrics.grad_norm,
               lr=float(trainer.cfg.finetune.learning_rate))
    return out


def step_state(trainer: TrainerLoop) -> tuple[dict, dict]:
    """The full updated params and Adam first moments by leaf name, on the
    card (a world's ranks all join the gathers)."""
    named, state = trainer.gathered_state()
    return dict(named), {n: st["exp_avg"] for n, st in trainer.leaf_state(state).items()}


def world_vs_ref(params: dict, moments: dict, ref: dict, lr: float) -> dict:
    """The world's updated params and first moments against the one-rank
    reference's, on the card: the worst leaf's moment difference (norm over
    the reference's norm), and the share of elements off by more than one
    bf16 step of |ref| + lr (flipped updates)."""
    worst, leaf, off, total, most = 0.0, "", 0, 0, 0.0
    for name, r in ref["moments"].items():
        r = r.float()
        rel = ((moments[name].float() - r).norm() / r.norm().clamp_min(1e-30)).item()
        if rel >= worst:
            worst, leaf = rel, name
    for name, r in ref["params"].items():
        d = (params[name].float() - r.float()).abs()
        off += int((d > 2.0**-7 * (r.float().abs() + lr)).sum())
        total += r.numel()
        most = max(most, d.max().item())
    return {"moment_rel": worst, "moment_leaf": leaf, "flip_frac": off / total, "param_max_abs": most}


def world_rank_main(rank: int, world: int, coordinator: str, work: str, hf_dir: str) -> None:
    """One rank of (b) and (c): start and join the gloo world on the one
    card while the parent runs the one-rank references, then, once their
    passes are done, for each part one pass of this rank's rows (cp: its
    half of the L 32,768 row; dp: its row of two) and one optimizer step;
    rank 0 holds the gathered params and moments against the references.
    Writes ``<work>/rank<rank>.json`` with the seconds each stage took."""
    from pipelinerl_tpu_torch.parallel.multihost import leave_world, maybe_initialize_distributed

    t0, marks = time.monotonic(), {}
    host, port = coordinator.rsplit(":", 1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR=host, MASTER_PORT=port)
    _, dev = maybe_initialize_distributed(None, "cuda")
    marks["joined"] = time.monotonic() - t0
    rows = torch.load(f"{work}/rows.pt", weights_only=False)
    backend = torch.distributed.get_backend()
    out = {"rank": rank, "backend": backend, "gloo_cuda": probe_gloo_cuda(dev) if backend == "gloo" else {}}
    wait_for(Path(work) / "refs.timed", "the one-rank references' passes")
    marks["refs_timed"] = time.monotonic() - t0
    params, model_cfg, _ = launch.build_model(compose("tir", world_args(hf_dir, work, "cp", world)), dev)
    params, model_cfg = cut_depth(params, model_cfg, WORLD_LAYERS)
    offsets = spy_q_offsets()
    marks["built"] = time.monotonic() - t0
    for part in ("cp", "dp"):
        exp = f"{work}/{part}_{rank}"
        trainer = TrainerLoop(compose("tir", world_args(hf_dir, exp, part, world)), params, model_cfg, exp)
        mine = rows[part] if part == "cp" else rows[part][rank::world]
        for seen in offsets.values():
            seen.clear()
        reset_counts()
        res = world_step(trainer, mine)
        res.update(launches=counts(), q_offsets={k: sorted(v) for k, v in offsets.items()},
                   shard=list(trainer.params["embed"].shape), mesh=list(trainer.mesh.shape))
        marks[f"{part}_stepped"] = time.monotonic() - t0
        full, moments = step_state(trainer)
        if rank == 0:
            wait_for(Path(work) / "refs.done", "the one-rank references' files")
            ref = torch.load(f"{work}/ref_{part}.pt", map_location=dev, weights_only=False)
            res.update(world_vs_ref(full, moments, ref, res["lr"]))
            del ref
        marks[f"{part}_compared"] = time.monotonic() - t0
        out[part] = res
        del trainer, full, moments
        gc.collect()
        torch.cuda.empty_cache()
    leave_world()
    out["marks"] = {k: round(v, 2) for k, v in marks.items()}
    Path(f"{work}/rank{rank}.json").write_text(json.dumps(out))
    exit_now()


def exit_now() -> None:
    """A rank process's end once its results are written and it has left
    its world, without the interpreter's teardown (the card's memory, the
    process groups), which the parent would wait for."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def wait_for(path: Path, what: str) -> None:
    deadline = time.monotonic() + WORLD_TIMEOUT
    while not path.exists():
        check(time.monotonic() < deadline, f"{what} never came")
        time.sleep(0.1)


def start_ranks(flag: list[str], work: Path, hf_dir: Path, world: int, prefix: str = "") -> list[subprocess.Popen]:
    """``world`` rank processes of ``chip_smoke.py <flag> RANK WORLD
    HOST:PORT DIR HF_DIR`` on this card, each logging to
    ``<work>/<prefix>rank<r>.log``."""
    coordinator = f"127.0.0.1:{free_port()}"
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (str(root), os.environ.get("PYTHONPATH")) if p))
    procs = []
    for r in range(world):
        with open(work / f"{prefix}rank{r}.log", "w") as f:
            procs.append(subprocess.Popen([sys.executable, str(root / "chip_smoke.py"), *flag, str(r), str(world),
                                           coordinator, str(work), str(hf_dir)],
                                          stdout=f, stderr=subprocess.STDOUT, env=env, cwd=root,
                                          start_new_session=True))
    return procs


def start_world_ranks(work: Path, hf_dir: Path, world: int = 2) -> list[subprocess.Popen]:
    """``world`` rank processes of ``world_rank_main`` on this card."""
    return start_ranks(["--world-rank"], work, hf_dir, world)


def wait_world_ranks(procs: list[subprocess.Popen], work: Path, deadline: float, prefix: str = "") -> list[dict]:
    """The ranks' results (``<work>/<prefix>rank<r>.json``), or a failure
    with their logs."""
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.returncode for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                stop_group(p, 10)
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    logs = {r: (work / f"{prefix}rank{r}.log").read_text()[-3000:] for r in failed}
    check(not failed, f"{prefix}rank(s) {failed} failed: {logs}")
    return [json.loads((work / f"{prefix}rank{r}.json").read_text()) for r in range(len(procs))]


def phase_trainer_world(hf_dir: Path, smi: str, tmp: str, tir_seg: np.ndarray, world: int = 2) -> dict:
    """Phase 27 (a)-(c): the sharded trainer on one card as two gloo ranks.
    (a) which collectives gloo takes on CUDA tensors in this torch; (b) cp 2
    at the tir preset's width: one
    packed L 32,768 row over phase 21's segment ids, each rank its half
    against the gathered K/V (#2-#4 at q_offset 0 and 16,384), held against
    one rank's pass of the same row (loss, grad norm, each leaf's Adam
    first moment, the updated params, after one step at ``WORLD_LR``);
    (c) dp 2 at Qwen2.5-0.5B width: two L 2,048 rows, the params cut by the
    rule table, held against one rank's two passes ((d), the trainer world
    through ``launch``, is ``phase_world_launch``). ``world`` ranks (one card each where the host has as many, NCCL) run
    (b) at cp ``world`` and (c) on ``world`` rows; ``--trainer-world``.
    Returns the world's kernel launches."""
    dev = torch.device("cuda")
    work = Path(tmp) / "world"
    work.mkdir()
    rng = np.random.default_rng(27)
    rows = {"cp": [world_row(tir_seg, 27)],
            "dp": [world_row(np.repeat(np.arange(6), rng.multinomial(DP_ROW_L - 6 * 64, np.ones(6) / 6) + 64), s)
                   for s in range(28, 28 + world)]}
    torch.save(rows, work / "rows.pt")
    # the ranks start (import, join) while this process runs the one-rank
    # references; they build once the references' passes are done
    # (refs.timed) and rank 0 reads their files after its own step
    # (refs.done)
    t0 = time.monotonic()
    procs = start_world_ranks(work, hf_dir, world)
    try:
        params, model_cfg, _ = launch.build_model(compose("tir", world_args(hf_dir, tmp, "cp", 1)), dev)
        params, model_cfg = cut_depth(params, model_cfg, WORLD_LAYERS)
        refs, moved, states = {}, {}, {}
        for part in ("cp", "dp"):
            exp = f"{work}/ref_{part}"
            trainer = TrainerLoop(compose("tir", world_args(hf_dir, exp, part, 1)), detached_copy(params),
                                  model_cfg, exp)
            reset_counts()
            refs[part] = world_step(trainer, rows[part])
            refs[part]["launches"] = counts()
            new, moments = step_state(trainer)
            n_moved = sum(int((new[k] != p0).sum()) for k, p0 in param_leaves(params))
            moved[part] = n_moved / sum(p0.numel() for _, p0 in param_leaves(params))
            states[part] = {"params": {k: v.cpu() for k, v in new.items()},
                            "moments": {k: v.cpu() for k, v in moments.items()}}
            del trainer, new, moments
            gc.collect()
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
        refs_s = time.monotonic() - t0
        (work / "refs.timed").touch()
        for part, state in states.items():
            torch.save(state, work / f"ref_{part}.pt")
        del states
        (work / "refs.done").touch()
    except BaseException:
        for p in procs:
            stop_group(p, 10)
        raise
    ranks = wait_world_ranks(procs, work, t0 + WORLD_TIMEOUT)
    wall = time.monotonic() - t0
    r0 = ranks[0]
    log(f"trainer world (a): backend {r0['backend']}, torch {torch.__version__}; gloo takes on CUDA tensors "
        f"{r0['gloo_cuda'] or '(not asked: not gloo)'}")
    check(r0["backend"] != "gloo" or all(r0["gloo_cuda"].values()),
          f"gloo refuses a collective the port calls on CUDA tensors: {r0['gloo_cuda']}")
    launches = {k: 0 for k in KERNEL_KEYS + ("paged",)}
    n_layers = WORLD_LAYERS
    for part, label in (("cp", f"(b) cp {world}, the tir row L {tir_seg.shape[0]}"),
                        ("dp", f"(c) dp {world}, {world} rows of L {DP_ROW_L}")):
        ref, res = refs[part], [r[part] for r in ranks]
        loss_err = abs(res[0]["loss"] - ref["loss"]) / max(abs(ref["loss"]), 1e-30)
        norm_err = abs(res[0]["grad_norm"] - ref["grad_norm"]) / max(ref["grad_norm"], 1e-30)
        log(f"trainer world {label} on {smi}: " + "; ".join(
            f"rank {i} mesh {res[i]['mesh']} embed shard {res[i]['shard']}: pass "
            f"{[round(s, 3) for s in res[i]['pass_s']]} s, peak {[round(b / 2**30, 2) for b in res[i]['peak']]} GiB, "
            f"step {res[i]['step_s']:.3f} s, launches {res[i]['launches']}, q_offsets {res[i]['q_offsets']}"
            for i, r in enumerate(ranks))
            + f"; one rank: pass {[round(s, 3) for s in ref['pass_s']]} s, peak "
            f"{[round(b / 2**30, 2) for b in ref['peak']]} GiB, launches {ref['launches']}; loss {res[0]['loss']:.6f} "
            f"vs {ref['loss']:.6f} (relative {loss_err:.2e}, tolerance {WORLD_LOSS_RTOL}), grad norm "
            f"{res[0]['grad_norm']:.6f} vs {ref['grad_norm']:.6f} (relative {norm_err:.2e}, tolerance "
            f"{WORLD_NORM_RTOL}), Adam first moments: worst leaf {res[0]['moment_leaf']} off by "
            f"{res[0]['moment_rel']:.3e} of its norm (tolerance {WORLD_MOMENT_RTOL}), updated params (lr {ref['lr']}, "
            f"no warmup): the reference moved {moved[part]:.4f} of its elements (at least {WORLD_MOVED_FRAC}), "
            f"{res[0]['flip_frac']:.3e} of them more than one bf16 step of |ref| + lr off (at most "
            f"{WORLD_FLIP_FRAC}), max abs difference {res[0]['param_max_abs']:.3e}; world wall {wall:.1f} s "
            f"(the references' passes {refs_s:.1f} s, beside the ranks' start; rank 0's marks {ranks[0]['marks']} s)")
        check(all(math.isfinite(r["loss"]) for r in res) and loss_err <= WORLD_LOSS_RTOL,
              f"{label}: loss {res[0]['loss']} vs one rank's {ref['loss']}")
        check(norm_err <= WORLD_NORM_RTOL, f"{label}: grad norm {res[0]['grad_norm']} vs {ref['grad_norm']}")
        check(res[0]["moment_rel"] <= WORLD_MOMENT_RTOL,
              f"{label}: the first moment of {res[0]['moment_leaf']} off by {res[0]['moment_rel']}")
        check(moved[part] >= WORLD_MOVED_FRAC, f"{label}: the reference step moved {moved[part]} of the params")
        check(res[0]["flip_frac"] <= WORLD_FLIP_FRAC, f"{label}: {res[0]['flip_frac']} of the updated params off")
        # remat: each layer's forward runs again in the backward pass
        want = {"gqa_fwd": 2 * n_layers, "gqa_dq": n_layers, "gqa_dkv": n_layers}
        for i, r in enumerate(res):
            check(all(r["launches"][k] == n * len(rows[part] if part == "cp" else rows[part][i::world])
                      for k, n in want.items()), f"{label}: rank {i} launches {r['launches']}, want {want} a pass")
            for k in want:
                launches[k] += r["launches"][k]
        if part == "cp":
            c = tir_seg.shape[0] // world
            for i, r in enumerate(res):
                check(all(r["q_offsets"][k] == [i * c] for k in want),
                      f"(b) rank {i} launched #2-#4 at q_offsets {r['q_offsets']}, want {i * c}")
    return launches


def trainer_world_main(world: int) -> None:
    """``python3 chip_smoke.py --trainer-world N``: phases 1-2, then phase
    27's (b) and (c) as N ranks (one card each on a host of N cards: NCCL)
    on a tir-width row of 24 even segments from seed 21, from an
    ``export_hf`` directory of random Qwen2.5-0.5B weights."""
    info = phase_device()
    dev = torch.device("cuda")
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        params = init_params(torch.Generator(device=dev).manual_seed(0), QWEN05B_TIED, dev)
        hf_dir = export_hf(f"{tmp}/hf_in", params, QWEN05B_TIED, HFTokenizer(FIXTURE_TOKENIZER))
        del params
        torch.cuda.empty_cache()
        rng = np.random.default_rng(21)
        seg = np.repeat(np.arange(24), rng.multinomial(32768 - 24 * 256, np.ones(24) / 24) + 256)
        t0 = time.monotonic()
        phase_trainer_world(hf_dir, info["smi"], tmp, seg, world)
        log(f"trainer world of {world}: {time.monotonic() - t0:.1f} s")


def start_world_launch(hf_dir: Path, tmp: str) -> tuple[subprocess.Popen, float]:
    """Phase 27 (d)'s run: the ``test`` preset through ``launch`` in
    processes mode as an engine job and a trainer world of two ranks (dp 2)
    on this card. It goes beside phases 18-23, which leave most cores
    idle, and ``phase_world_launch`` reads it."""
    exp = f"{tmp}/world_launch"
    cmd = [sys.executable, "-m", "pipelinerl_tpu_torch.launch", "--config-name=test", f"model_path={hf_dir}",
           f"output_dir={exp}", "launch_mode=processes", "world.trainer_procs=2", "parallel.dp=2",
           "finetune.max_train_steps=2", "finetune.save_checkpoint_steps=0", "llm.parameters.max_tokens=32",
           "finetune.rl.entropy_bonus=0.001", "engine.attn_impl=gqa", "finetune.attn_impl=gqa",
           f"world.engine_start_port={free_port()}", f"world.coordinator_port={free_port()}"]
    return start_launch(cmd, exp)


def phase_world_launch(smi: str, tmp: str, run: tuple[subprocess.Popen, float]) -> dict:
    """Phase 27 (d): ``start_world_launch``'s run; every push from rank 0
    reaches the engine, the version is the trained samples, both ranks exit
    0. Returns the ranks' launches."""
    exp = f"{tmp}/world_launch"
    returncode, stdout, stderr, wall, left = finish_launch(run, exp, exp, 300)
    check(returncode == 0, f"(d) the trainer world through launch exited {returncode}: {stderr[-3000:]}\n"
          f"{job_logs(exp)}")
    check(not left, f"(d) children outlived the launcher: {left}")
    jobs = json.loads(stdout.strip().splitlines()[-1])["jobs"]
    engine, ranks = jobs["engine_0"], [jobs["trainer_0"], jobs["trainer_1"]]
    trainer = ranks[0]["trainer"]
    pushes = ranks[0]["pushes"]
    log(f"trainer world (d) through launch (test preset, engine job + 2 trainer ranks, dp 2): {wall:.1f} s wall, "
        f"ranks {[(r['rank'], r['world'], r['trainer']['completed_steps'], r['trainer']['samples']) for r in ranks]} "
        f"(rank, world, steps, samples), {len(pushes)} PWT3 pushes from rank 0 "
        f"({len(ranks[1]['pushes'])} from rank 1), engine version {engine['version']} (pushes "
        f"{engine['push']['pushes_completed']}/{engine['push']['pushes_received']}), launches "
        f"{[r['kernel_launches'] for r in ranks]}; on {smi}")
    check(all(r["trainer"]["completed_steps"] == 2 and r["world"] == 2 for r in ranks), f"(d) ranks {ranks}")
    check(pushes and not ranks[1]["pushes"] and engine["push"]["pushes_completed"] == len(pushes)
          and engine["push"]["push_last_version"] == pushes[-1]["version"],
          f"(d) rank 0's pushes did not all reach the engine: {engine['push']}, {len(pushes)} pushes")
    check(engine["version"] == trainer["last_broadcasted_version"] == trainer["samples"] > 0,
          f"(d) engine version {engine['version']}, trainer {trainer}")
    check(all(r["kernel_launches"][k] for r in ranks for k in ("gqa_fwd", "gqa_dq", "gqa_dkv")),
          f"(d) launches {[r['kernel_launches'] for r in ranks]}")
    return {k: sum(r["kernel_launches"][k] for r in ranks) for k in ranks[0]["kernel_launches"]}


def time_cp_rows(dev, kernels: list[dict], seg: np.ndarray, cp: int = 2) -> None:
    """#2-#4 at each cp rank's shape of the tir row (Lq L/cp against the
    gathered L keys at q_offset rank * L/cp) against their plain versions by
    blocks of queries, timed beside one masked SDPA call and their bounds
    from the rank's visible pairs; into ``kernels[1..3]["tir_cp2_rank<r>"]``."""
    gen = torch.Generator(device=dev).manual_seed(27)
    H, K, Dh = QWEN05B_HEADS
    L = seg.shape[0]
    Lq = L // cp
    fwd_plain = lambda *a: gattn.mha_packed_gqa_plain_blocked(*a, block=TIR_ROW_BLOCK)  # noqa: E731
    bwd_plain = lambda *a: gattn.mha_packed_gqa_bwd_plain_blocked(*a, block=TIR_ROW_BLOCK)  # noqa: E731
    for rank in range(cp):
        off = rank * Lq
        name = f"tir_cp{cp}_rank{rank}_shape"
        label = (f"tir row at cp {cp}, rank {rank}: Lq {Lq} at q_offset {off} against the gathered L={L}, "
                 f"{int(seg.max()) + 1} segments, the plain versions by blocks of {TIR_ROW_BLOCK} queries")
        make = lambda off=off: _gqa_inputs(gen, 1, Lq, L, H, K, Dh, seg, dev, off)  # noqa: E731
        args = make()
        kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], _check_gqa_forward(label, args, plain=fwd_plain))
        kernels[1][name] = _time_gqa_forward(label, args, make, dev, plain_by_events=True, plain=fwd_plain)
        del args
        torch.cuda.empty_cache()
        a = _gqa_bwd_args(gen, 1, Lq, L, H, K, Dh, seg, dev, q_offset=off)
        grads = gattn.mha_packed_gqa_bwd(*a[:10])
        refs = bwd_plain(*a[:10])
        errs = {n: _rel_err(g, r) for n, g, r in zip(("dq", "dk", "dv"), grads, refs)}
        del a, grads, refs
        log(f"gqa backward kernels vs plain, {label}: " + ", ".join(
            f"{n} max abs err {e:.3e} ({rel:.2e} of max |ref|)" for n, (e, rel) in errs.items())
            + f" (tolerance {GQA_BWD_RTOL} of max |ref|)")
        check(all(math.isfinite(e) and rel <= GQA_BWD_RTOL for e, rel in errs.values()),
              f"gqa backward disagrees ({label})")
        kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], errs["dq"][0])
        kernels[3]["max_abs_err"] = max(kernels[3]["max_abs_err"], errs["dk"][0], errs["dv"][0])
        torch.cuda.empty_cache()
        t = _time_gqa_bwd(label, lambda off=off: _gqa_bwd_args(gen, 1, Lq, L, H, K, Dh, seg, dev, q_offset=off),
                          dev, plain_iters=2, plain=bwd_plain)
        kernels[2][name], kernels[3][name] = t["dq"], t["dkv"]
        torch.cuda.empty_cache()


# -- phase 28: tensor parallelism on one card ---------------------------------
#
# (a)-(c) run in two gloo rank processes on the one card (NCCL refuses two
# ranks on one GPU), beside the one-rank references in this process, as
# phase 27's do. Greedy tokens: a rank's GEMMs run at half the widths (other
# cuBLAS tiles and split-K), kernel #2 splits its work by B·K, so sums run
# in another order and a bf16 rounding can fall the other way; an argmax
# between two tokens that close can flip. Where the tp engine's tokens
# leave the one-rank engine's, the one-rank model must rate its own token
# above the tp engine's by at most TP_TIE_NATS (a near-tie, not a wrong
# token), and the logprobs of the tokens both produced agree within the
# teacher-forcing limits of phase 7.
TP_RANKS = 2
TP_HEADS = (QWEN05B.num_heads // TP_RANKS, QWEN05B.num_kv_heads // TP_RANKS, 64)  # (7, 1, 64)
TP_SLOTS, TP_MAX_LEN, TP_WINDOW, TP_BT = 64, 2048, 16, 128
TP_BUCKETS = (128, 256, 512)
TP_NEW = 16  # new tokens of each request: one window
# about three times the largest margin read on the card (0.0366 nats, my
# chip runs of phase 28); a random model's next-token distribution is
# nearly flat
TP_TIE_NATS = 0.1
TP_ROW_L = 12288  # (c)'s row: the math preset's seq_length, so the logits go by chunks
# (a)-(c)'s depth, cut from Qwen2.5-0.5B's 24 to pay for phase 29's time (a
# tp 2 decode step carries two all-reduces a layer); (d) runs the whole
# directory
TP_LAYERS = 12
# (c)'s limits where phase 27's are too tight for tp: cp and dp change no
# product, tp changes the widths of every GEMM (above), so every activation
# can move by a bf16 step. The loss limit is three times the largest of
# ``--tp-loss-study 20``'s readings (1.06e-4 relative; median 4.3e-5, on
# rows of +1 advantages whose loss near 0.089 has no terms that cancel; an
# NVIDIA H100 80GB HBM3 at 700 W), no closer to one rank that forms
# ``wo``/``wdown`` in fp32 as tp does (median 5.3e-5): spread, not a fault.
# With ``_row_parallel``'s reduce dropped the loss reads 5.1e-3, the grad
# norm 5.6 and the first moment 7.5 relative, 33% of the signs flipped.
# Moments (2.2e-2 to 3.5e-2) and flips (1.4e-2 to 2.7e-2) at about three
# times their readings
TP_LOSS_RTOL = 3.2e-4
TP_MOMENT_RTOL = 0.1
TP_FLIP_FRAC = 8e-2
TP_TIMEOUT = 600.0
TP_PUSH_SCALE = 0.5  # exact in bf16: the pushed weights are known bit for bit


def tp_args(hf_dir, out: str, tp: int) -> list[str]:
    """The math preset's overrides for phase 28: the HF directory, no
    saves, (c)'s step at ``WORLD_LR`` with no warmup, ``parallel.tp``."""
    return [f"model_path={hf_dir}", f"output_dir={out}", "finetune.save_checkpoint_steps=0",
            f"finetune.learning_rate={WORLD_LR}", "finetune.num_warmup_steps=0", f"parallel.tp={tp}"]


def tp_engine_cfg(layout: str) -> EngineConfig:
    """Phase 28's engine: 64 slots of max_len 2,048, window 16, the kernels;
    the paged layout in 128-token pages."""
    return EngineConfig(max_slots=TP_SLOTS, max_len=TP_MAX_LEN, prefill_buckets=TP_BUCKETS, decode_window=TP_WINDOW,
                        attn_impl="gqa", decode_attn_impl="ragged", kv_layout=layout, kv_block_size=TP_BT)


def tp_workload(seed: int) -> dict:
    """16 greedy prompts of 64-400 fixture-tokenizer ids and a GRPO group of
    8 identical ones (forks); 8 sampled prompts."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 540, int(n)).tolist() for n in rng.integers(64, 401, 16)]
    group = rng.integers(1, 540, 300).tolist()
    return {"greedy": prompts + [group] * 8, "sampled": [rng.integers(1, 540, 128).tolist() for _ in range(8)]}


def tp_serve(engine: InferenceEngine, w: dict) -> dict:
    """The greedy and sampled batches through a started engine, each timed;
    → their tokens and logprobs."""
    out = {}
    for key, params in (("greedy", SamplingParams(temperature=0.0, max_tokens=TP_NEW)),
                        ("sampled", SamplingParams(temperature=1.0, top_p=0.95, max_tokens=TP_NEW))):
        t0 = time.monotonic()
        res = [f.result(timeout=300) for f in [engine.submit(GenRequest(list(p), params)) for p in w[key]]]
        out[key] = [{"tokens": r.token_ids, "logprobs": r.logprobs, "finish": r.finish_reason} for r in res]
        out[f"{key}_s"] = time.monotonic() - t0
    return out


def tp_push(engine: InferenceEngine, params: dict, w: dict, model_cfg,
            slices: Callable[[dict], list[dict]] | None = None, live_tokens: int = 2 * TP_NEW) -> dict:
    """A PWT3 body of TP_PUSH_SCALE times the weights pushed into
    rank 0 while 8 sampled requests decode ``live_tokens`` each: the
    seconds to the swap, the window gaps, the versions the requests saw,
    and each rank's checksums against its slice of the pushed tree
    (``slices``: the ranks' slices of a full tree; phase 28's tp 2 cut by
    default)."""
    from pipelinerl_tpu_torch.parallel.sharding import tp_cut, tp_local

    if slices is None:
        def slices(tree):
            return [tp_local(tree, r, TP_RANKS, tp_cut(model_cfg, TP_RANKS)) for r in range(TP_RANKS)]

    pushed = scaled({k: v for k, v in params.items() if k != "value_head"}, TP_PUSH_SCALE)
    body = bytes(serialize_params(pushed, 1))
    live = [engine.submit(GenRequest(list(p), SamplingParams(temperature=1.0, max_tokens=live_tokens)))
            for p in w["sampled"]]
    time.sleep(0.5)  # the requests are decoding
    t0 = time.monotonic()
    engine.update_params_serialized(body)
    deadline = t0 + 120
    while engine.version != 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    swap_s = time.monotonic() - t0
    timings = dict(engine.last_push_timings)
    done = [f.result(timeout=300) for f in live]
    sums = engine.rank_checksums()
    want = [param_checksums(t) for t in slices(pushed)]
    return {"version": engine.version, "swap_s": swap_s, "bytes": len(body), "timings": timings,
            "checksums_equal": [s == x for s, x in zip(sums, want)], "live_tokens": sum(len(r.token_ids) for r in done),
            "live_versions": sorted({(r.model_version_start, r.model_version_end) for r in done})}


def tp_collective_ms(dev) -> dict:
    """Wall ms of one decode step's collectives on this world (host clock,
    synchronized, mean of 20): the all-reduce after ``wo``/``wdown`` ([64,
    896] bf16) and the logits' all-gather ([64, 75,968] fp32 a rank)."""
    from pipelinerl_tpu_torch.parallel import collectives

    group = torch.distributed.group.WORLD
    cases = {"all_reduce_64x896_bf16": (lambda x: collectives.reduce_(x, group),
                                        torch.ones(TP_SLOTS, QWEN05B.hidden_size, dtype=torch.bfloat16, device=dev)),
             "all_gather_64x75968_fp32": (lambda x: collectives.gather(x, 1, group),
                                          torch.ones(TP_SLOTS, QWEN05B.vocab_size // TP_RANKS, device=dev))}
    out = {}
    for name, (fn, x) in cases.items():
        fn(x)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(20):
            fn(x)
        torch.cuda.synchronize()
        out[name] = (time.monotonic() - t0) / 20 * 1e3
    return out


def tp_rank_main(rank: int, world: int, coordinator: str, work: str, hf_dir: str) -> None:
    """One rank of phase 28 (a)-(c): join the gloo world on the one card
    while the parent runs the one-rank references; then the tp engine on
    the slab layout (rank 0 drives it: greedy and sampled batches, a push
    while decoding), on the paged layout (rank 0 keeps every fourth
    window's table for (e)), and one trainer pass and AdamW step at
    ``parallel.tp`` 2. Writes ``<work>/rank<rank>.json``."""
    from pipelinerl_tpu_torch.inference.tp_ranks import join_engine_world
    from pipelinerl_tpu_torch.parallel.multihost import leave_world, maybe_initialize_distributed

    t0, marks = time.monotonic(), {}
    host, port = coordinator.rsplit(":", 1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR=host, MASTER_PORT=port)
    _, dev = maybe_initialize_distributed(None, "cuda")
    out = {"rank": rank, "backend": torch.distributed.get_backend()}
    w = torch.load(f"{work}/tp_work.pt", weights_only=False)
    wait_for(Path(work) / "refs.timed", "the one-rank references' runs")
    marks["refs_timed"] = time.monotonic() - t0
    out["collectives_ms"] = tp_collective_ms(dev)
    params, model_cfg, tok = launch.build_model(compose("math", tp_args(hf_dir, work, 1)), dev)
    params, model_cfg = cut_depth(params, model_cfg, TP_LAYERS)
    for layout in ("slab", "paged"):
        ew = join_engine_world(rank, world, "", dev)
        snapshots, window_fn = [], engine_mod._decode_window_paged_fn
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        engine = InferenceEngine(launch.engine_params(params), model_cfg, tp_engine_cfg(layout), tok.eos_token_id,
                                 device=dev, tp_world=ew)
        res = {"cache_heads": (engine.k_pool if engine.paged else engine.k_cache).shape[-2]}
        if rank == 0:
            if layout == "paged":
                def spy(*args, **kw):
                    if engine.windows_dispatched % 4 == 1:
                        snapshots.append((args[6].cpu(), args[8].cpu(), args[10].cpu()))
                    return window_fn(*args, **kw)

                engine_mod._decode_window_paged_fn = spy
            engine.start()
            try:
                res.update(tp_serve(engine, w))
                if layout == "slab":
                    res["push"] = tp_push(engine, params, w, model_cfg)
            finally:
                engine_mod._decode_window_paged_fn = window_fn
                engine.stop()
            if snapshots:
                torch.save(snapshots, f"{work}/tp_snapshots.pt")
        else:
            engine.serve_tp_worker()
        torch.cuda.synchronize()
        res.update(launches=counts(), digest=engine.window_digest, version=engine.version,
                   peak=torch.cuda.max_memory_allocated())
        out[layout] = res
        marks[layout] = time.monotonic() - t0
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    exp = f"{work}/train_{rank}"
    trainer = TrainerLoop(compose("math", tp_args(hf_dir, exp, world)), params, model_cfg, exp)
    del params
    reset_counts()
    res = world_step(trainer, [w["row"]])
    res.update(launches=counts(), shard=list(trainer.params["layers"]["wq"].shape), mesh=list(trainer.mesh.shape),
               chunk=trainer.logits_chunk)
    marks["stepped"] = time.monotonic() - t0
    full, moments = step_state(trainer)
    if rank == 0:
        wait_for(Path(work) / "refs.done", "the one-rank references' files")
        ref = torch.load(f"{work}/ref_tp.pt", map_location=dev, weights_only=False)
        res.update(world_vs_ref(full, moments, ref, res["lr"]))
        del ref
    out["train"] = res
    del trainer, full, moments
    leave_world()
    out["marks"] = {k: round(v, 2) for k, v in marks.items()}
    Path(f"{work}/rank{rank}.json").write_text(json.dumps(out))
    exit_now()


def start_tp_ranks(work: Path, hf_dir: Path, world: int = TP_RANKS) -> list[subprocess.Popen]:
    """``world`` rank processes of ``tp_rank_main`` on this card."""
    return start_ranks(["--tp-rank"], work, hf_dir, world)


def tp_compare(label: str, got: list[dict], ref: list[dict], prompts: list, ref_engine: InferenceEngine) -> dict:
    """The tp engine's greedy results against the one-rank engine's: how
    many are equal, the logprobs of the tokens both produced, and at each
    first divergence the one-rank model's margin for its own token over the
    tp engine's (teacher forcing through ``score_tokens``)."""
    equal, diffs, margins, agreed = 0, [], [], []
    for g, r, prompt in zip(got, ref, prompts):
        n = next((i for i, (a, b) in enumerate(zip(g["tokens"], r["tokens"])) if a != b),
                 min(len(g["tokens"]), len(r["tokens"])))
        agreed.append(n / max(1, len(r["tokens"])))
        diffs += [abs(a - b) for a, b in zip(g["logprobs"][:n], r["logprobs"][:n])]
        if g["tokens"] == r["tokens"]:
            equal += 1
        elif n < min(len(g["tokens"]), len(r["tokens"])):
            tf = ref_engine.score_tokens(list(prompt) + g["tokens"][: n + 1])[-1]
            margins.append(r["logprobs"][n] - tf)
    errs = np.asarray(diffs or [0.0])
    out = {"equal": equal, "n": len(got), "agreed_mean": float(np.mean(agreed)), "lp_mean": float(errs.mean()),
           "lp_max": float(errs.max()), "margins": [round(m, 4) for m in margins]}
    log(f"tp engine (a)/(b) {label}: {equal} of {len(got)} greedy requests equal to the one-rank engine's, "
        f"{out['agreed_mean']:.3f} of the tokens before the first divergence on average; logprobs of the tokens "
        f"both produced: mean abs diff {out['lp_mean']:.4f} (tolerance {TF_MEAN_ATOL}), max {out['lp_max']:.4f} "
        f"(tolerance {TF_MAX_ATOL}); the one-rank model's margin for its own token at each divergence "
        f"{out['margins']} nats (at most {TP_TIE_NATS})")
    check(out["lp_mean"] <= TF_MEAN_ATOL and out["lp_max"] <= TF_MAX_ATOL, f"tp {label}: logprobs off: {out}")
    check(all(m <= TP_TIE_NATS for m in margins), f"tp {label}: a divergence that is no near-tie: {out['margins']}")
    return out


def phase_tp(hf_dir: Path, smi: str, tmp: str, seg: np.ndarray, padding: int) -> tuple[dict, dict]:
    """Phase 28 (a)-(c): the tp engine (slab, then paged) and one trainer
    step at tp 2, two gloo ranks on this card, each held against one rank
    in this process. → (the ranks' kernel launches, (e)'s inputs)."""
    dev = torch.device("cuda")
    work = Path(tmp) / "tp"
    work.mkdir()
    w = tp_workload(28)
    # +1 advantages throughout: with +-1 by segment the loss is a difference
    # of two near-equal sums (it read -0.0049 and -0.00018 on two of phase
    # 18's rows), and its relative gap measured that, not tp
    torch.save({**w, "row": world_row(seg, 28, signed=False)}, work / "tp_work.pt")
    t0 = time.monotonic()
    procs = start_tp_ranks(work, hf_dir)
    try:
        params, model_cfg, tok = launch.build_model(compose("math", tp_args(hf_dir, tmp, 1)), dev)
        params, model_cfg = cut_depth(params, model_cfg, TP_LAYERS)
        refs, engines = {}, {}
        for layout in ("slab", "paged"):
            engine = InferenceEngine(launch.engine_params(params), model_cfg, tp_engine_cfg(layout), tok.eos_token_id,
                                     device=dev)
            engine.start()
            refs[layout] = tp_serve(engine, w)
            engine.stop()
            engines[layout] = engine
        exp = f"{work}/ref_train"
        trainer = TrainerLoop(compose("math", tp_args(hf_dir, exp, 1)), detached_copy(params), model_cfg, exp)
        reset_counts()
        refs["train"] = world_step(trainer, [torch.load(work / "tp_work.pt", weights_only=False)["row"]])
        refs["train"]["launches"] = counts()
        new, moments = step_state(trainer)
        moved = sum(int((new[k] != p0).sum()) for k, p0 in param_leaves(params)) / sum(
            p0.numel() for _, p0 in param_leaves(params))
        state = {"params": {k: v.cpu() for k, v in new.items()}, "moments": {k: v.cpu() for k, v in moments.items()}}
        del trainer, new, moments, engines["paged"]
        gc.collect()
        torch.cuda.empty_cache()
        refs_s = time.monotonic() - t0
        (work / "refs.timed").touch()
        torch.save(state, work / "ref_tp.pt")
        del state
        (work / "refs.done").touch()
    except BaseException:
        for p in procs:
            stop_group(p, 10)
        raise
    ranks = wait_world_ranks(procs, work, t0 + TP_TIMEOUT)
    wall = time.monotonic() - t0
    r0 = ranks[0]
    log(f"tp world: backend {r0['backend']}, {TP_RANKS} ranks on {smi}; world wall {wall:.1f} s (the one-rank "
        f"references {refs_s:.1f} s beside the ranks' start; rank 0's marks {r0['marks']} s); a decode step's "
        f"collectives on rank 0, ms each (host clock): "
        f"{ {k: round(v, 3) for k, v in r0['collectives_ms'].items()} }")
    for layout in ("slab", "paged"):
        res = [r[layout] for r in ranks]
        log(f"tp engine ({'a' if layout == 'slab' else 'b'}) {layout}: greedy {res[0]['greedy_s']:.2f} s, sampled "
            f"{res[0]['sampled_s']:.2f} s (one rank: {refs[layout]['greedy_s']:.2f} s, {refs[layout]['sampled_s']:.2f} "
            f"s); cache heads {[r['cache_heads'] for r in res]}; peak {[round(r['peak'] / 2**30, 2) for r in res]} GiB; "
            f"launches {[r['launches'] for r in res]}; window digests {[r['digest'] for r in res]}")
        check(res[0]["digest"] == res[1]["digest"] != 0, f"tp {layout}: the ranks read back other windows")
        check(all(r["cache_heads"] == TP_HEADS[1] for r in res), f"tp {layout}: cache heads {res}")
        key = "decode" if layout == "slab" else "paged"
        check(all(r["launches"][key] > 0 and r["launches"]["gqa_fwd"] > 0 for r in res),
              f"tp {layout}: launches {[r['launches'] for r in res]}")
        tp_compare(layout, res[0]["greedy"], refs[layout]["greedy"], w["greedy"], engines["slab"])
        for s in res[0]["sampled"]:
            check(0 < len(s["tokens"]) <= TP_NEW and all(math.isfinite(x) and x <= 0 for x in s["logprobs"]),
                  f"tp {layout}: a sampled result {s['finish']}, {len(s['tokens'])} tokens")
    push = r0["slab"]["push"]
    t = push["timings"]
    log(f"tp engine (a) push: {push['bytes'] / 1e6:.1f} MB PWT3 body into rank 0 while 8 requests decode, swapped on "
        f"both ranks {push['swap_s']:.3f} s after the call ({t.get('mode')}, staged {t.get('transfer_s', 0):.3f} s, "
        f"publish to swap {t.get('publish_to_swap_s', 0):.3f} s); {t.get('windows_during')} windows read back during "
        f"it, largest gap {t.get('max_window_gap_s', 0):.3f} s against the steady {t.get('steady_window_gap_s')} s; "
        f"the live requests' (start, end) versions {push['live_versions']}; each rank's checksums equal its slice of "
        f"the pushed tree: {push['checksums_equal']}; ranks' versions {[r['slab']['version'] for r in ranks]}")
    check(all(r["slab"]["version"] == 1 for r in ranks) and push["version"] == 1, f"tp push: versions {push}")
    check(all(push["checksums_equal"]) and len(push["checksums_equal"]) == TP_RANKS, f"tp push checksums {push}")
    # a window takes seconds here (two ranks' gloo traffic on one card), so
    # the push lands between two windows of requests that go on decoding
    check(push["live_versions"] == [[0, 1]], f"tp push: the live requests did not decode through it: {push}")
    engines["slab"] = None
    ref, res = refs["train"], [r["train"] for r in ranks]
    loss_err = abs(res[0]["loss"] - ref["loss"]) / max(abs(ref["loss"]), 1e-30)
    norm_err = abs(res[0]["grad_norm"] - ref["grad_norm"]) / max(ref["grad_norm"], 1e-30)
    log(f"tp trainer (c) tp {TP_RANKS}, the math preset's L {seg.shape[0]} row ({int(seg.max()) + 1} segments, logits "
        f"chunk {res[0]['chunk']}) on {smi}: " + "; ".join(
            f"rank {i} mesh {r['mesh']} wq shard {r['shard']}: pass {[round(s, 3) for s in r['pass_s']]} s, peak "
            f"{[round(b / 2**30, 2) for b in r['peak']]} GiB, step {r['step_s']:.3f} s, launches {r['launches']}"
            for i, r in enumerate(res))
        + f"; one rank: pass {[round(s, 3) for s in ref['pass_s']]} s, peak {[round(b / 2**30, 2) for b in ref['peak']]}"
        f" GiB; loss {res[0]['loss']:.6f} vs {ref['loss']:.6f} (relative {loss_err:.2e}, tolerance {TP_LOSS_RTOL}), "
        f"grad norm {res[0]['grad_norm']:.6f} vs {ref['grad_norm']:.6f} (relative {norm_err:.2e}, tolerance "
        f"{WORLD_NORM_RTOL}), worst first moment {res[0]['moment_leaf']} off by {res[0]['moment_rel']:.3e} (tolerance "
        f"{TP_MOMENT_RTOL}); the reference moved {moved:.4f} of its elements (at least {WORLD_MOVED_FRAC}), "
        f"{res[0]['flip_frac']:.3e} more than one bf16 step of |ref| + lr off (at most {TP_FLIP_FRAC}), max abs "
        f"difference {res[0]['param_max_abs']:.3e}")
    check(all(math.isfinite(r["loss"]) for r in res) and loss_err <= TP_LOSS_RTOL, f"tp (c) loss {res[0]['loss']}")
    check(norm_err <= WORLD_NORM_RTOL, f"tp (c) grad norm {res[0]['grad_norm']} vs {ref['grad_norm']}")
    check(res[0]["moment_rel"] <= TP_MOMENT_RTOL, f"tp (c) first moment of {res[0]['moment_leaf']} off")
    check(moved >= WORLD_MOVED_FRAC, f"tp (c): the reference step moved {moved} of the params")
    check(res[0]["flip_frac"] <= TP_FLIP_FRAC, f"tp (c): {res[0]['flip_frac']} of the updated params off")
    want = {"gqa_fwd": 2 * TP_LAYERS, "gqa_dq": TP_LAYERS, "gqa_dkv": TP_LAYERS}
    check(all(r["launches"][k] == n for r in res for k, n in want.items()), f"tp (c) launches {res}")
    launches = {k: sum(r[part]["launches"][k] for r in ranks for part in ("slab", "paged", "train"))
                for k in KERNEL_KEYS + ("paged",)}
    snapshots = torch.load(work / "tp_snapshots.pt", weights_only=False)
    return launches, {"snapshots": snapshots, "segment_ids": seg, "padding": padding}


def start_after(first: tuple[subprocess.Popen, float] | Callable[[], tuple | None],
                start: Callable[[], tuple[subprocess.Popen, float]]) -> Callable[..., tuple | None]:
    """Call ``start`` on a thread once ``first``'s process has ended
    (``first`` a run, or a function that returns one once it has started,
    as this function's result does). → a function that waits for that call
    and returns its run; given ``cancel=True`` it keeps the call from being
    made, or stops its run."""
    runs: list = []
    cancelled = threading.Event()

    def chain() -> None:
        run = first() if callable(first) else first
        while run is not None and run[0].poll() is None and not cancelled.is_set():
            time.sleep(0.5)
        if not cancelled.is_set():
            runs.append(start())

    thread = threading.Thread(target=chain, daemon=True)
    thread.start()

    def started(cancel: bool = False) -> tuple | None:
        if cancel:
            cancelled.set()
        thread.join()
        if cancel:
            for proc, _ in runs:
                stop_group(proc)
        return runs[0] if runs else None

    return started


def start_tp_launch(hf_dir: Path, tmp: str) -> tuple[subprocess.Popen, float]:
    """Phase 28 (d)'s run: the ``test`` preset through ``launch`` with
    ``engine.tp=2 parallel.tp=2`` (two engine ranks, two trainer ranks on
    this card), 2 steps, beside a phase that leaves the card idle."""
    exp = f"{tmp}/tp_launch"
    cmd = [sys.executable, "-m", "pipelinerl_tpu_torch.launch", "--config-name=test", f"model_path={hf_dir}",
           f"output_dir={exp}", "engine.tp=2", "parallel.tp=2", "finetune.max_train_steps=2",
           "finetune.save_checkpoint_steps=0", "llm.parameters.max_tokens=32", "finetune.rl.entropy_bonus=0.001",
           "engine.attn_impl=gqa", "finetune.attn_impl=gqa", f"world.engine_start_port={free_port()}",
           f"world.coordinator_port={free_port()}", f"world.engine_tp_port={free_port()}"]
    return start_launch(cmd, exp)


def phase_tp_launch(smi: str, tmp: str, run: tuple[subprocess.Popen, float]) -> dict:
    """Phase 28 (d): ``start_tp_launch``'s run; both trainer ranks step, the
    two engine ranks end on the trainer's last version with the same window
    digest, every push from trainer rank 0 lands. → the jobs' launches."""
    exp = f"{tmp}/tp_launch"
    returncode, stdout, stderr, wall, left = finish_launch(run, exp, exp, 400)
    check(returncode == 0, f"(d) the tp run through launch exited {returncode}: {stderr[-3000:]}\n{job_logs(exp)}")
    check(not left, f"(d) children outlived the launcher: {left}")
    jobs = json.loads(stdout.strip().splitlines()[-1])["jobs"]
    engine, follower = jobs["engine_0"], jobs["engine_rank_0"]
    ranks = [jobs["trainer_0"], jobs["trainer_1"]]
    trainer = ranks[0]["trainer"]
    log(f"tp (d) through launch (test preset, engine.tp=2 parallel.tp=2: 2 engine ranks, 2 trainer ranks): {wall:.1f} "
        f"s wall, trainer ranks {[(r['rank'], r['trainer']['completed_steps'], r['trainer']['samples']) for r in ranks]}"
        f" (rank, steps, samples), {len(ranks[0]['pushes'])} pushes, engine versions {engine['version']} / "
        f"{follower['version']} (pushes {engine['push']['pushes_completed']}/{engine['push']['pushes_received']}), "
        f"window digests {engine['window_digest']} / {follower['window_digest']}, launches "
        f"{[j['kernel_launches'] for j in (engine, follower, *ranks)]}; on {smi}")
    check(all(r["trainer"]["completed_steps"] == 2 and r["world"] == 2 for r in ranks), f"(d) ranks {ranks}")
    check(engine["version"] == follower["version"] == trainer["last_broadcasted_version"] == trainer["samples"] > 0,
          f"(d) engine versions {engine['version']}, {follower['version']}, trainer {trainer}")
    check(engine["window_digest"] == follower["window_digest"] != 0, "(d) the engine ranks read back other windows")
    check(engine["push"]["pushes_completed"] == len(ranks[0]["pushes"]) > 0, f"(d) pushes {engine['push']}")
    jobs_launches = [j["kernel_launches"] for j in (engine, follower, *ranks)]
    check(all(j["decode"] for j in jobs_launches[:2]) and all(j["gqa_dkv"] for j in jobs_launches[2:]),
          f"(d) launches {jobs_launches}")
    return {k: sum(j[k] for j in jobs_launches) for k in jobs_launches[0]}


def time_tp_shapes(dev, kernels: list[dict], shapes: dict) -> None:
    """(e): kernel #1 at the tp engine's slab (S 64, K 1, G 7), #5 on the tp
    paged engine's own tables, #2-#4 on (c)'s row at K 1, G 7, each against
    its plain version, timed beside SDPA and its bound."""
    time_slab(dev, kernels, "tp2_slab_shape", (TP_SLOTS, TP_WINDOW, TP_MAX_LEN + TP_WINDOW), (64, 464), 28,
              heads=TP_HEADS)
    record: dict = {"max_abs_err": 0.0}
    time_paged_working_set(dev, [tuple(t.to(dev) for t in s) for s in shapes["snapshots"]], record,
                           heads=TP_HEADS, pool=TP_SLOTS * -(-(TP_MAX_LEN + TP_WINDOW) // TP_BT), bt=TP_BT,
                           window=TP_WINDOW, slots=TP_SLOTS)
    kernels[4]["max_abs_err"] = max(kernels[4]["max_abs_err"], record.pop("max_abs_err"))
    kernels[4]["tp2_paged_tables"] = record
    time_train_row(dev, kernels, "tp2_math_row_shape", shapes["segment_ids"], shapes["padding"], 28, heads=TP_HEADS)


def tp_main() -> None:
    """``python3 chip_smoke.py --tp-world``: phases 1-2, then phase 28
    (a)-(e) alone from an ``export_hf`` directory of random Qwen2.5-0.5B
    weights, on a math-width row of 28 segments from seed 28."""
    info = phase_device()
    dev = torch.device("cuda")
    phase_build()
    kernels = [{"max_abs_err": 0.0} for _ in range(5)]
    with tempfile.TemporaryDirectory() as tmp:
        params = init_params(torch.Generator(device=dev).manual_seed(0), QWEN05B_TIED, dev)
        hf_dir = export_hf(f"{tmp}/hf_in", params, QWEN05B_TIED, HFTokenizer(FIXTURE_TOKENIZER))
        del params
        torch.cuda.empty_cache()
        rng = np.random.default_rng(28)
        seg = np.repeat(np.arange(28), rng.multinomial(TP_ROW_L - 63 - 28 * 128, np.ones(28) / 28) + 128)
        seg = np.concatenate([seg, np.full(63, 28)])
        t0 = time.monotonic()
        launches, shapes = phase_tp(hf_dir, info["smi"], tmp, seg, 63)
        log(f"phase wall: tp (a)-(c) {time.monotonic() - t0:.1f} s")
        t1 = time.monotonic()
        launches_d = phase_tp_launch(info["smi"], tmp, start_tp_launch(hf_dir, tmp))
        log(f"phase wall: tp (d) {time.monotonic() - t1:.1f} s")
        t2 = time.monotonic()
        time_tp_shapes(dev, kernels, shapes)
        log(f"phase wall: tp (e) {time.monotonic() - t2:.1f} s; launches {launches}, (d) {launches_d}")
    log(json.dumps({"kernels": kernels}))


# -- the study of phase 28 (c)'s loss bound (ROADMAP Queue 3) -----------------
#
# (c)'s tp 2 step against one rank's, over many rows of the math preset's
# L 12,288: the math run's own full rows, then packings of its rollouts'
# segments in an order drawn from a seed of the OS's entropy (logged), each
# row's tokens from a seed drawn the same way. For each row: the relative
# loss error, the grad norm's, the worst first moment and the flip fraction;
# and the loss of a third pass, one rank with ``_row_parallel``'s fp32
# products rounded once, as tp computes them (the known difference: one rank
# runs bf16 ``x @ w``), so a reading from that difference reads small there.


@contextlib.contextmanager
def fp32_row_parallel():
    """One rank's ``wo`` and ``wdown`` products as tp's ``_row_parallel``
    forms them: fp32 operands, rounded once to the activations' dtype."""
    from pipelinerl_tpu_torch.models import transformer

    original = transformer._row_parallel

    def row_parallel(x, w, tp):
        return (x.float() @ w.float()).to(x.dtype) if tp is None or tp.size == 1 else original(x, w, tp)

    transformer._row_parallel = row_parallel
    try:
        yield
    finally:
        transformer._row_parallel = original


def study_rows(rows: list[tuple[np.ndarray, int]], n: int, rng: np.random.Generator) -> list[np.ndarray]:
    """``n`` segment-id rows of ``TP_ROW_L``: ``rows`` (a run's full rows,
    the padding segment last) first, then the real segments of all of them
    in an order ``rng`` draws, packed in turn until the next would not fit,
    the rest of the row one padding segment."""
    out = [seg for seg, _ in rows][:n]
    lengths = []
    for seg, padding in rows:
        real = seg[: len(seg) - padding]
        lengths += np.diff(np.r_[0, np.flatnonzero(np.diff(real)) + 1, len(real)]).tolist()
    while len(out) < n:
        take, total = [], 0
        for i in rng.permutation(len(lengths)):
            if total + lengths[i] >= TP_ROW_L:
                break
            take.append(lengths[i])
            total += lengths[i]
        seg = np.repeat(np.arange(len(take)), take)
        out.append(np.concatenate([seg, np.full(TP_ROW_L - total, len(take))]).astype(np.int32))
    return out


def tp_loss_rank_main(rank: int, world: int, coordinator: str, work: str, hf_dir: str) -> None:
    """One rank of the study: for each row of ``<work>/study_rows.pt`` a
    fresh trainer at ``parallel.tp`` 2 from the same params, one pass and
    one AdamW step; rank 0 holds each against the parent's one-rank step.
    Writes ``<work>/rank<rank>.json``."""
    from pipelinerl_tpu_torch.parallel.multihost import leave_world, maybe_initialize_distributed

    host, port = coordinator.rsplit(":", 1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR=host, MASTER_PORT=port)
    _, dev = maybe_initialize_distributed(None, "cuda")
    rows = torch.load(f"{work}/study_rows.pt", weights_only=False)
    params, model_cfg, _ = launch.build_model(compose("math", tp_args(hf_dir, work, 1)), dev)
    params, model_cfg = cut_depth(params, model_cfg, TP_LAYERS)
    out = []
    for i, row in enumerate(rows):
        exp = f"{work}/train_{rank}_{i}"
        trainer = TrainerLoop(compose("math", tp_args(hf_dir, exp, world)), detached_copy(params), model_cfg, exp)
        res = world_step(trainer, [row])
        full, moments = step_state(trainer)
        if rank == 0:
            wait_for(Path(work) / f"ref{i}.done", f"the one-rank reference of row {i}")
            ref = torch.load(f"{work}/ref{i}.pt", map_location=dev, weights_only=False)
            res.update(world_vs_ref(full, moments, ref, res["lr"]))
            del ref
            Path(f"{work}/ref{i}.pt").unlink()
        out.append(res)
        del trainer, full, moments
        gc.collect()
        torch.cuda.empty_cache()
    leave_world()
    Path(f"{work}/rank{rank}.json").write_text(json.dumps(out))
    exit_now()


def tp_loss_study_main(n: int) -> None:
    """``python3 chip_smoke.py --tp-loss-study N``: phases 1-2, phase 18's
    math run from an ``export_hf`` directory of random Qwen2.5-0.5B weights,
    then (c)'s comparison over N rows (``study_rows``) as two gloo ranks on
    this card beside the one-rank references in this process; each row's
    readings logged, then the study's JSON line, then (c)'s gates on every
    row."""
    info = phase_device()
    dev = torch.device("cuda")
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        params = init_params(torch.Generator(device=dev).manual_seed(0), QWEN05B_TIED, dev)
        hf_dir = export_hf(f"{tmp}/hf_in", params, QWEN05B_TIED, HFTokenizer(FIXTURE_TOKENIZER))
        del params
        torch.cuda.empty_cache()
        _, shapes = phase_math(hf_dir, info["smi"], tmp)
        gc.collect()
        torch.cuda.empty_cache()
        seed = int.from_bytes(os.urandom(4), "little")
        rng = np.random.default_rng(seed)
        segs = study_rows(shapes["rows"], n, rng)
        batches = [world_row(seg, int(rng.integers(2**31)), signed=False) for seg in segs]
        log(f"tp loss study: {n} rows of L {TP_ROW_L}, {len(shapes['rows'])} of them the math run's own, the rest "
            f"packed from its rollouts in an order drawn from seed {seed}; segments a row (the padding one among "
            f"them) {[int(b.num_sequences) for b in batches]}")
        work = Path(tmp) / "tp_study"
        work.mkdir()
        torch.save(batches, work / "study_rows.pt")
        t0 = time.monotonic()
        procs = start_ranks(["--tp-loss-rank"], work, hf_dir, TP_RANKS)
        refs = []
        try:
            params, model_cfg, _ = launch.build_model(compose("math", tp_args(hf_dir, tmp, 1)), dev)
            params, model_cfg = cut_depth(params, model_cfg, TP_LAYERS)
            for i, row in enumerate(batches):
                trainer = TrainerLoop(compose("math", tp_args(hf_dir, f"{work}/ref_{i}", 1)), detached_copy(params),
                                      model_cfg, f"{work}/ref_{i}")
                ref = world_step(trainer, [row])
                new, moments = step_state(trainer)
                # at most two references (about 2 GB each) wait on disk for rank 0
                deadline = time.monotonic() + WORLD_TIMEOUT
                while (work / f"ref{i - 2}.pt").exists() and all(p.poll() is None for p in procs):
                    check(time.monotonic() < deadline, f"rank 0 never read the reference of row {i - 2}")
                    time.sleep(0.1)
                torch.save({"params": {k: v.cpu() for k, v in new.items()},
                            "moments": {k: v.cpu() for k, v in moments.items()}}, work / f"ref{i}.pt")
                (work / f"ref{i}.done").touch()
                del trainer, new, moments
                with fp32_row_parallel():
                    trainer = TrainerLoop(compose("math", tp_args(hf_dir, f"{work}/ref32_{i}", 1)),
                                          detached_copy(params), model_cfg, f"{work}/ref32_{i}")
                    trainer.train_pass(row)
                    ref["loss32"] = trainer.metrics.train_loss
                del trainer
                gc.collect()
                torch.cuda.empty_cache()
                refs.append(ref)
        except BaseException:
            for p in procs:
                stop_group(p, 10)
            raise
        ranks = wait_world_ranks(procs, work, t0 + TP_TIMEOUT + 60 * n)
        wall = time.monotonic() - t0
    readings = []
    for i, (ref, got) in enumerate(zip(refs, ranks[0])):
        r = {"row": i, "segments": int(batches[i].num_sequences), "loss": got["loss"], "loss_ref": ref["loss"],
             "loss_rel": abs(got["loss"] - ref["loss"]) / max(abs(ref["loss"]), 1e-30),
             "loss_rel_fp32_ref": abs(got["loss"] - ref["loss32"]) / max(abs(ref["loss32"]), 1e-30),
             "grad_norm": got["grad_norm"], "grad_norm_rel": abs(got["grad_norm"] - ref["grad_norm"]) / max(
                 ref["grad_norm"], 1e-30), "moment_rel": got["moment_rel"], "moment_leaf": got["moment_leaf"],
             "flip_frac": got["flip_frac"]}
        readings.append(r)
        log(f"tp loss study row {i}: {json.dumps(r)}")
    worst = {k: max(r[k] for r in readings) for k in ("loss_rel", "loss_rel_fp32_ref", "grad_norm_rel",
                                                       "moment_rel", "flip_frac")}
    log(f"tp loss study: {n} rows in {wall:.1f} s on {info['smi']}; worst {json.dumps(worst)}; limits loss "
        f"{TP_LOSS_RTOL}, grad norm {WORLD_NORM_RTOL}, moment {TP_MOMENT_RTOL}, flips {TP_FLIP_FRAC}")
    log("tp loss study readings: " + json.dumps({k: [r[k] for r in readings] for k in readings[0]}))
    for r in readings:
        check(math.isfinite(r["loss"]) and r["loss_rel"] <= TP_LOSS_RTOL, f"tp study row {r['row']}: loss {r}")
        check(r["grad_norm_rel"] <= WORLD_NORM_RTOL, f"tp study row {r['row']}: grad norm {r}")
        check(r["moment_rel"] <= TP_MOMENT_RTOL, f"tp study row {r['row']}: first moment {r}")
        check(r["flip_frac"] <= TP_FLIP_FRAC, f"tp study row {r['row']}: flips {r}")


# -- phase 29: pipeline parallelism and heads that do not split, on one card ---
#
# Gloo rank processes on the one card, as phase 28's, beside the one-rank
# references in this process. Gloo's send of a CUDA tensor aborts its
# process (gloo::IoException, writev: Bad address, on an H100 host), so
# the stage hand-offs are broadcasts in two-rank groups, which gloo takes on
# CUDA tensors. (a) pp 2 at full width and depth (12 layers a
# stage): each stage runs one rank's layers at one rank's shapes and the
# last stage samples with the one-rank engine's generator seed, so tokens
# and logprobs must equal the one-rank engine's bit for bit. (b) tp 2 x pp 2
# and (c) tp 4 at H 14 (4, 4, 3, 3 query heads a rank, at G 4, 1, 3, 3) run
# a model cut to PP_DEPTH layers; their tp sums run in another order, so
# their greedy tokens are held to phase 28's near-tie rule and at least
# PP_EQUAL of phase 28's 24 requests equal, and (c)'s step to phase 28's
# limits.
PP_DEPTH = 8  # (b), (c): layers of the cut model (Qwen2.5-0.5B: 24)
PP_ROW_L = 4096  # (c)'s row (phase 28: the math preset's 12,288)
PP_EQUAL = 19  # of 24 greedy requests, phase 28's reading at tp 2
PP_DECODE_NEW = 48  # the timed decode: 64 requests, 3 windows of 16 steps
PP_LIVE_TOKENS = 128  # the live requests during (a)'s push: 8 windows
# (c)'s loss limit: about three times the reading at tp 4 (9.49e-5 relative
# on an NVIDIA H100 80GB HBM3 at 700 W; phase 28 read 2.4e-5 to 4.0e-5 at tp
# 2), since four ranks' GEMMs at a quarter of the widths round more of
# the activations apart; a wrong tp gradient reads O(1)
PP_LOSS_RTOL = 3e-4
PP_TIMEOUT = 900.0


def cut_depth(params: dict, cfg: ModelConfig, n: int) -> tuple[dict, ModelConfig]:
    """The first ``n`` layers of a model (copies), and its config."""
    cut = {**params, "layers": {k: v[:n].clone() for k, v in params["layers"].items()}}
    return cut, dataclasses.replace(cfg, num_layers=n)


def pp_greedy(engine: InferenceEngine, w: dict) -> dict:
    """The greedy batch through a started engine, timed → its tokens and
    logprobs."""
    t0 = time.monotonic()
    params = SamplingParams(temperature=0.0, max_tokens=TP_NEW)
    res = [f.result(timeout=300) for f in [engine.submit(GenRequest(list(p), params)) for p in w["greedy"]]]
    return {"greedy": [{"tokens": r.token_ids, "logprobs": r.logprobs, "finish": r.finish_reason} for r in res],
            "greedy_s": time.monotonic() - t0}


def pp_step_ms(engine: InferenceEngine, seed: int) -> float:
    """Wall ms of a decode step of a started engine with its 64 slots busy:
    64 prompts of 64 tokens decode PP_DECODE_NEW tokens, and the gaps
    between the windows read back after the first, over their steps."""
    rng = np.random.default_rng(seed)
    before = len(engine._window_times)
    params = SamplingParams(temperature=0.0, max_tokens=PP_DECODE_NEW)
    for f in [engine.submit(GenRequest(rng.integers(1, 540, 64).tolist(), params)) for _ in range(TP_SLOTS)]:
        f.result(timeout=300)
    times = list(engine._window_times)[before:]
    check(len(times) >= 3, f"the timed decode read back {len(times)} windows")
    return (times[-1] - times[0]) / ((len(times) - 1) * TP_WINDOW) * 1e3


def pp_engine_run(rank: int, world, params: dict, model_cfg, tok, layout: str, w: dict, dev,
                  push: bool = False, timed: bool = False) -> dict:
    """One engine of phase 29 on this rank: rank 0 drives it (the greedy
    batch, the timed decode, a push while decoding), the others follow.
    → what this rank ran: its layers, top leaves and cache heads, launches,
    dispatched steps and prefill batches, window digest and version."""
    from pipelinerl_tpu_torch.parallel.sharding import pp_local, tp_cut, tp_local

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    engine = InferenceEngine(launch.engine_params(params), model_cfg, tp_engine_cfg(layout), tok.eos_token_id,
                             device=dev, tp_world=world)
    res = {"layers": int(engine.params["layers"]["wq"].shape[0]), "top": sorted(k for k in engine.params
                                                                               if k != "layers"),
           "cache_heads": int((engine.k_pool if engine.paged else engine.k_cache).shape[-2])}
    if rank == 0:
        engine.start()
        try:
            res.update(pp_greedy(engine, w))
            if timed:
                res["step_ms"] = pp_step_ms(engine, 29)
            if push:
                tp, pp = world.tp_size, world.pp

                def slices(tree):
                    return [tp_local(pp_local(tree, r // tp, pp), r % tp, tp, tp_cut(model_cfg, tp))
                            for r in range(world.size)]

                res["push"] = tp_push(engine, params, w, model_cfg, slices, PP_LIVE_TOKENS)
        finally:
            engine.stop()
    else:
        engine.serve_tp_worker()
    torch.cuda.synchronize()
    res.update(launches=counts(), steps=sum(k * v for k, v in engine.window_size_counts.items()),
               prefills=engine.prefill_batches, digest=engine.window_digest, version=engine.version,
               peak=torch.cuda.max_memory_allocated())
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return res


def pp_rank_main(part: str, rank: int, world: int, coordinator: str, work: str, hf_dir: str) -> None:
    """One rank of phase 29: part "a" of two ranks ((a): pp 2 at full depth,
    slab with a push, then paged), part "bc" of four ((b): tp 2 x pp 2,
    then (c): tp 4 and one trainer step, at PP_DEPTH layers). Each joins its
    gloo world while the parent runs the one-rank references, and starts
    its engines once the parent says so (part "bc" once part "a" has
    ended). Writes ``<work>/<part>_rank<rank>.json``."""
    from pipelinerl_tpu_torch.inference.tp_ranks import join_engine_world
    from pipelinerl_tpu_torch.parallel.multihost import leave_world, maybe_initialize_distributed

    t0, marks = time.monotonic(), {}
    host, port = coordinator.rsplit(":", 1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR=host, MASTER_PORT=port)
    _, dev = maybe_initialize_distributed(None, "cuda")
    out = {"rank": rank, "backend": torch.distributed.get_backend()}
    w = torch.load(f"{work}/pp_work.pt", weights_only=False)
    params, model_cfg, tok = launch.build_model(compose("math", tp_args(hf_dir, work, 1)), dev)
    if part == "a":
        wait_for(Path(work) / "refs.timed", "the one-rank references' runs")
        marks["start"] = time.monotonic() - t0
        for layout in ("slab", "paged"):
            ew = join_engine_world(rank, world, "", dev, pp=2)
            out[layout] = pp_engine_run(rank, ew, params, model_cfg, tok, layout, w, dev, push=layout == "slab",
                                        timed=layout == "slab")
            marks[layout] = time.monotonic() - t0
    else:
        params, model_cfg = cut_depth(params, model_cfg, PP_DEPTH)
        wait_for(Path(work) / "a.done", "part (a)'s end")
        marks["start"] = time.monotonic() - t0
        ew = join_engine_world(rank, world, "", dev, pp=2)
        out["b"] = pp_engine_run(rank, ew, params, model_cfg, tok, "slab", w, dev, timed=True)
        marks["b"] = time.monotonic() - t0
        ew = join_engine_world(rank, world, "", dev)
        out["c"] = pp_engine_run(rank, ew, params, model_cfg, tok, "slab", w, dev)
        marks["c_engine"] = time.monotonic() - t0
        exp = f"{work}/train_{rank}"
        trainer = TrainerLoop(compose("math", tp_args(hf_dir, exp, world)), params, model_cfg, exp)
        del params
        reset_counts()
        res = world_step(trainer, [w["row"]])
        res.update(launches=counts(), shard=list(trainer.params["layers"]["wq"].shape), mesh=list(trainer.mesh.shape))
        full, moments = step_state(trainer)
        if rank == 0:
            ref = torch.load(f"{work}/ref_pp.pt", map_location=dev, weights_only=False)
            res.update(world_vs_ref(full, moments, ref, res["lr"]))
            del ref
        out["train"] = res
        marks["c_train"] = time.monotonic() - t0
        del trainer, full, moments
    leave_world()
    out["marks"] = {k: round(v, 2) for k, v in marks.items()}
    Path(f"{work}/{part}_rank{rank}.json").write_text(json.dumps(out))
    exit_now()


def check_stage_launches(label: str, ranks: list[dict], layers: int, key: str) -> None:
    """Each rank launched its decode kernel once a layer a dispatched step
    and #2 once a layer a prefill batch, over its stage's ``layers``."""
    for i, r in enumerate(ranks):
        got, want = r["launches"], {key: layers * r["steps"], "gqa_fwd": layers * r["prefills"]}
        check(r["steps"] > 0 and all(got[k] == n for k, n in want.items()),
              f"pp {label} rank {i}: launches {got}, want {want} ({r['steps']} steps, {r['prefills']} prefills)")


def phase_pp(hf_dir: Path, smi: str, tmp: str) -> dict:
    """Phase 29 (a)-(c), each held against one rank in this process. → the
    ranks' kernel launches."""
    from pipelinerl_tpu_torch.models.transformer import tp_heads
    from pipelinerl_tpu_torch.parallel.collectives import TP

    dev = torch.device("cuda")
    work = Path(tmp) / "pp"
    work.mkdir()
    w = tp_workload(28)
    rng = np.random.default_rng(29)
    seg = np.repeat(np.arange(8), rng.multinomial(PP_ROW_L - 31 - 8 * 128, np.ones(8) / 8) + 128)
    seg = np.concatenate([seg, np.full(31, 8)])
    torch.save({**w, "row": world_row(seg, 29, signed=False)}, work / "pp_work.pt")
    t0 = time.monotonic()
    procs = {part: start_ranks(["--pp-rank", part], work, hf_dir, n, f"{part}_")
             for part, n in (("a", 2), ("bc", 4))}
    try:
        params, model_cfg, tok = launch.build_model(compose("math", tp_args(hf_dir, tmp, 1)), dev)
        refs, engines = {}, {}
        for name, layout, p, cfg in (("a_slab", "slab", params, model_cfg), ("a_paged", "paged", params, model_cfg),
                                     ("cut", "slab", *cut_depth(params, model_cfg, PP_DEPTH))):
            engine = InferenceEngine(launch.engine_params(p), cfg, tp_engine_cfg(layout), tok.eos_token_id, device=dev)
            engine.start()
            refs[name] = pp_greedy(engine, w)
            if layout == "slab":
                refs[name]["step_ms"] = pp_step_ms(engine, 29)
            engine.stop()
            engines[name] = engine
        del engines["a_paged"], engines["a_slab"]
        cut, cut_cfg = cut_depth(params, model_cfg, PP_DEPTH)
        del params
        exp = f"{work}/ref_train"
        trainer = TrainerLoop(compose("math", tp_args(hf_dir, exp, 1)), detached_copy(cut), cut_cfg, exp)
        reset_counts()
        refs["train"] = world_step(trainer, [torch.load(work / "pp_work.pt", weights_only=False)["row"]])
        new, moments = step_state(trainer)
        # at PP_DEPTH layers the tied table (of whose 151,936 rows the fixture
        # tokenizer's ids reach 540) holds about half the elements, so the
        # step's reach is read over the stacked layers, every element of
        # which has a gradient
        layers = [(k, p0) for k, p0 in param_leaves(cut) if k.startswith("layers.")]
        moved = sum(int((new[k] != p0).sum()) for k, p0 in layers) / sum(p0.numel() for _, p0 in layers)
        moved_all = sum(int((new[k] != p0).sum()) for k, p0 in param_leaves(cut)) / sum(
            p0.numel() for _, p0 in param_leaves(cut))
        torch.save({"params": {k: v.cpu() for k, v in new.items()},
                    "moments": {k: v.cpu() for k, v in moments.items()}}, work / "ref_pp.pt")
        del trainer, new, moments, cut
        gc.collect()
        torch.cuda.empty_cache()
        refs_s = time.monotonic() - t0
        (work / "refs.timed").touch()
    except BaseException:
        for p in procs["a"] + procs["bc"]:
            stop_group(p, 10)
        raise
    try:
        a = wait_world_ranks(procs["a"], work, t0 + PP_TIMEOUT, "a_")
    except BaseException:
        for p in procs["bc"]:
            stop_group(p, 10)
        raise
    a_s = time.monotonic() - t0
    (work / "a.done").touch()
    bc = wait_world_ranks(procs["bc"], work, t0 + PP_TIMEOUT, "bc_")
    wall = time.monotonic() - t0
    log(f"pp world on {smi}: backend {a[0]['backend']} (the stage hand-offs broadcast in two-rank groups); "
        f"wall {wall:.1f} s: the one-rank references {refs_s:.1f} s beside the ranks' start, (a) ended at "
        f"{a_s:.1f} s, (b)-(c) at {wall:.1f} s; marks {[r['marks'] for r in a]} / {[r['marks'] for r in bc]} s")

    # (a): pp 2 at full depth, bit for bit
    n_layers = model_cfg.num_layers
    for layout in ("slab", "paged"):
        res, ref = [r[layout] for r in a], refs[f"a_{layout}"]
        equal = sum(g == r for g, r in zip(res[0]["greedy"], ref["greedy"]))
        log(f"pp (a) {layout}, pp 2 x 12 layers: greedy {res[0]['greedy_s']:.2f} s (one rank {ref['greedy_s']:.2f} s)"
            + (f", a decode step {res[0]['step_ms']:.2f} ms (one rank {ref['step_ms']:.2f} ms)" if layout == "slab"
               else "")
            + f"; {equal} of {len(ref['greedy'])} greedy results equal the one-rank engine's tokens and logprobs bit "
            f"for bit; stages' layers {[r['layers'] for r in res]}, top leaves {[r['top'] for r in res]}, cache heads "
            f"{[r['cache_heads'] for r in res]}, peak {[round(r['peak'] / 2**30, 2) for r in res]} GiB; launches "
            f"{[r['launches'] for r in res]} over {[r['steps'] for r in res]} dispatched steps and "
            f"{[r['prefills'] for r in res]} prefill batches; window digests {[r['digest'] for r in res]}")
        check(equal == len(ref["greedy"]), f"pp (a) {layout}: greedy results off the one-rank engine's")
        check(res[0]["digest"] == res[1]["digest"] != 0, f"pp (a) {layout}: the stages read back other windows")
        check([r["layers"] for r in res] == [n_layers // 2] * 2 and res[0]["top"] == ["embed"]
              and res[1]["top"] == ["embed", "final_norm"], f"pp (a) {layout}: stage weights {res}")
        check_stage_launches(f"(a) {layout}", res, n_layers // 2, "decode" if layout == "slab" else "paged")
    push = a[0]["slab"]["push"]
    t = push["timings"]
    log(f"pp (a) push: {push['bytes'] / 1e6:.1f} MB PWT3 body into rank 0 while 8 requests decode "
        f"{PP_LIVE_TOKENS} tokens, swapped on both stages {push['swap_s']:.3f} s after the call ({t.get('mode')}, "
        f"staged {t.get('transfer_s', 0):.3f} s, publish to swap {t.get('publish_to_swap_s', 0):.3f} s); "
        f"{t.get('windows_during')} windows read back during it, largest gap {t.get('max_window_gap_s', 0):.3f} s "
        f"against the steady {t.get('steady_window_gap_s')} s; the live requests' (start, end) versions "
        f"{push['live_versions']}; each stage's checksums equal its slice of the pushed tree: "
        f"{push['checksums_equal']}; stages' versions {[r['slab']['version'] for r in a]}")
    check(all(r["slab"]["version"] == 1 for r in a) and push["version"] == 1, f"pp push: versions {push}")
    check(all(push["checksums_equal"]) and len(push["checksums_equal"]) == 2, f"pp push checksums {push}")
    check((t.get("windows_during") or 0) > 0, f"pp push: no window read back while it landed: {push}")

    # (b): tp 2 x pp 2 at PP_DEPTH layers; (c): tp 4, heads that do not split
    ref = refs["cut"]
    for part, layers, key in (("b", PP_DEPTH // 2, "tp 2 x pp 2"), ("c", PP_DEPTH, "tp 4")):
        res = [r[part] for r in bc]
        log(f"pp ({part}) {key} at {PP_DEPTH} layers: greedy {res[0]['greedy_s']:.2f} s (one rank "
            f"{ref['greedy_s']:.2f} s)" + (f", a decode step {res[0]['step_ms']:.2f} ms (one rank {ref['step_ms']:.2f} "
                                          f"ms)" if part == "b" else "")
            + f"; layers {[r['layers'] for r in res]}, cache heads {[r['cache_heads'] for r in res]}, peak "
            f"{[round(r['peak'] / 2**30, 2) for r in res]} GiB; launches {[r['launches'] for r in res]} over "
            f"{[r['steps'] for r in res]} steps, {[r['prefills'] for r in res]} prefills; digests "
            f"{[r['digest'] for r in res]}")
        check(len({r["digest"] for r in res}) == 1 and res[0]["digest"] != 0, f"pp ({part}): other windows")
        check(all(r["layers"] == layers for r in res), f"pp ({part}): layers {[r['layers'] for r in res]}")
        check_stage_launches(f"({part})", res, layers, "decode")
        cmp = tp_compare(f"pp ({part}) {key}", res[0]["greedy"], ref["greedy"], w["greedy"], engines["cut"])
        check(cmp["equal"] >= PP_EQUAL, f"pp ({part}): {cmp['equal']} of {cmp['n']} greedy requests equal")
    heads = [tp_heads(model_cfg, TP(None, r, 4)) for r in range(4)]
    want_heads = [len(kv) for _, kv in heads]
    log(f"pp (c) query heads a rank {[h for h, _ in heads]}, KV heads {want_heads} (G "
        f"{[h // len(kv) for h, kv in heads]})")
    check([r["c"]["cache_heads"] for r in bc] == want_heads == [1, 4, 1, 1], f"pp (c): cache heads {want_heads}")
    res, rt = [r["train"] for r in bc], refs["train"]
    loss_err = abs(res[0]["loss"] - rt["loss"]) / max(abs(rt["loss"]), 1e-30)
    norm_err = abs(res[0]["grad_norm"] - rt["grad_norm"]) / max(rt["grad_norm"], 1e-30)
    log(f"pp (c) trainer tp 4 at {PP_DEPTH} layers, an L {PP_ROW_L} row (8 segments) on {smi}: " + "; ".join(
        f"rank {i} mesh {r['mesh']} wq shard {r['shard']}: pass {[round(x, 3) for x in r['pass_s']]} s, peak "
        f"{[round(b / 2**30, 2) for b in r['peak']]} GiB, step {r['step_s']:.3f} s, launches {r['launches']}"
        for i, r in enumerate(res))
        + f"; one rank: pass {[round(x, 3) for x in rt['pass_s']]} s; loss {res[0]['loss']:.6f} vs {rt['loss']:.6f} "
        f"(relative {loss_err:.2e}, tolerance {PP_LOSS_RTOL}), grad norm {res[0]['grad_norm']:.6f} vs "
        f"{rt['grad_norm']:.6f} (relative {norm_err:.2e}, tolerance {WORLD_NORM_RTOL}), worst first moment "
        f"{res[0]['moment_leaf']} off by {res[0]['moment_rel']:.3e} (tolerance {TP_MOMENT_RTOL}); the reference moved "
        f"{moved:.4f} of its layers' elements (at least {WORLD_MOVED_FRAC}; {moved_all:.4f} of all), "
        f"{res[0]['flip_frac']:.3e} off by more than one bf16 step (at most {TP_FLIP_FRAC}), max abs difference "
        f"{res[0]['param_max_abs']:.3e}")
    check(all(math.isfinite(r["loss"]) for r in res) and loss_err <= PP_LOSS_RTOL, f"pp (c) loss {res[0]['loss']}")
    check(norm_err <= WORLD_NORM_RTOL, f"pp (c) grad norm {res[0]['grad_norm']} vs {rt['grad_norm']}")
    check(res[0]["moment_rel"] <= TP_MOMENT_RTOL, f"pp (c) first moment of {res[0]['moment_leaf']} off")
    check(moved >= WORLD_MOVED_FRAC, f"pp (c): the reference step moved {moved} of the params")
    check(res[0]["flip_frac"] <= TP_FLIP_FRAC, f"pp (c): {res[0]['flip_frac']} of the updated params off")
    want = {"gqa_fwd": 2 * PP_DEPTH, "gqa_dq": PP_DEPTH, "gqa_dkv": PP_DEPTH}
    check(all(r["launches"][k] == n for r in res for k, n in want.items()), f"pp (c) trainer launches {res}")
    del engines
    return {k: sum(r[part]["launches"][k] for r in a for part in ("slab", "paged"))
            + sum(r[part]["launches"][k] for r in bc for part in ("b", "c", "train")) for k in KERNEL_KEYS + ("paged",)}


def pp_main() -> None:
    """``python3 chip_smoke.py --pp-world``: phases 1-2, then phase 29
    alone from an ``export_hf`` directory of random Qwen2.5-0.5B weights."""
    info = phase_device()
    phase_build()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        params = init_params(torch.Generator(device=dev).manual_seed(0), QWEN05B_TIED, dev)
        hf_dir = export_hf(f"{tmp}/hf_in", params, QWEN05B_TIED, HFTokenizer(FIXTURE_TOKENIZER))
        del params
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        launches = phase_pp(hf_dir, info["smi"], tmp)
        log(f"phase wall: pp (a)-(c) {time.monotonic() - t0:.1f} s; launches {launches}")


# -- phase 30: Llama-3.2-1B width; the tokenizer families and JPEG fixtures ---

# Llama-3.2-1B's published config.json
# (https://huggingface.co/meta-llama/Llama-3.2-1B/blob/main/config.json),
# written out by hand; weights random from seed 0. Its rope_scaling
# (rope_type llama3) is read by neither package's loader (ROADMAP Queue 3)
LLAMA32_1B_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False, "attention_dropout": 0.0, "bos_token_id": 128000,
    "eos_token_id": 128001, "head_dim": 64, "hidden_act": "silu", "hidden_size": 2048, "initializer_range": 0.02,
    "intermediate_size": 8192, "max_position_embeddings": 131072, "mlp_bias": False, "model_type": "llama",
    "num_attention_heads": 32, "num_hidden_layers": 16, "num_key_value_heads": 8, "pretraining_tp": 1,
    "rms_norm_eps": 1e-05, "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                                            "original_max_position_embeddings": 8192, "rope_type": "llama3"},
    "rope_theta": 500000.0, "tie_word_embeddings": True, "torch_dtype": "bfloat16", "use_cache": True,
    "vocab_size": 128256,
}
LLAMA32_1B = ModelConfig(
    vocab_size=128_256, hidden_size=2048, intermediate_size=8192, num_layers=16, num_heads=32, num_kv_heads=8,
    head_dim=64, rope_theta=500_000.0, rms_norm_eps=1e-5, tie_word_embeddings=True, dtype=torch.bfloat16,
    hf_architecture="LlamaForCausalLM")
LLAMA32_1B_PARAMS = 1_235_814_400  # the published model, tied
LLAMA3_HEADS = (LLAMA32_1B.num_heads, LLAMA32_1B.num_kv_heads, LLAMA32_1B.head_dim_)
FIXTURES = FIXTURE_TOKENIZER.parent
FAMILIES = ("llama3_tokenizer", "sp_tokenizer", "sp_metaspace_tokenizer")
# the test preset's cuts for phase 30, as phase 14 cuts it (each logged
# beside the preset's value): 32 new tokens (500), 2 steps (100), no save,
# an entropy bonus (0.0) so a random model's steps have a gradient, the
# kernels' route (xla)
LLAMA3_CUTS = {"llm.parameters.max_tokens": 32, "finetune.max_train_steps": 2, "finetune.save_checkpoint_steps": 0,
               "finetune.rl.entropy_bonus": 0.001, "engine.attn_impl": "gqa", "finetune.attn_impl": "gqa"}


def llama3_run_main(work: str, out: str) -> None:
    """``python3 chip_smoke.py --llama3-run WORK OUT``: phase 30's child. An
    HF directory at Llama-3.2-1B width (``export_hf`` of random bf16 weights
    from seed 0 with the committed Llama-3-style tokenizer, then the
    published ``config.json``), and the ``test`` preset through
    ``launch.main`` on it; the result, with the kernels' launches and the
    shapes the kernel rows need, as JSON in ``OUT``."""
    dev = torch.device("cuda")
    tok = HFTokenizer(FIXTURES / "llama3_tokenizer")
    params = init_params(torch.Generator(device=dev).manual_seed(0), LLAMA32_1B, dev)
    n_params = sum(t.numel() for _, t in param_leaves(params))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    hf_dir = export_hf(Path(work) / "hf", params, LLAMA32_1B, tok)
    write_s = time.monotonic() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    (hf_dir / "config.json").write_text(json.dumps(LLAMA32_1B_CONFIG, indent=2))
    exp = str(Path(work) / "run")
    made: list = []
    stats, passes, shape, wall, launches = run_rows_recorded(cut_args("test", LLAMA3_CUTS, hf_dir, exp), made)
    trainer = made[0]
    samples = actor_samples(exp)
    prompts = [[i for i, label in zip(s["input_ids"], s["labels"]) if label == -100] for s in samples]
    with open(f"{exp}/metrics/trainer_0.jsonl") as f:
        norms = [json.loads(line)["grad_norm"] for line in f]
    seq = compose("test", ["output_dir=/x"]).finetune.seq_length
    row = max((p for p in passes if p["length"] == seq), key=lambda p: int(p["segment_ids"].max()))
    mc = trainer.model_cfg
    result = {
        "params": n_params, "bytes": (hf_dir / "model.safetensors").stat().st_size, "write_s": write_s,
        "config": [mc.hf_architecture, mc.vocab_size, mc.valid_vocab, mc.num_layers, mc.num_heads, mc.num_kv_heads,
                   mc.head_dim_, mc.rope_theta, mc.rms_norm_eps, mc.tie_word_embeddings],
        "tokenizer": len(tok), "stats": stats, "wall": wall, "launches": launches, "engine": shape,
        "passes": [{"s": p["s"], "peak": p["peak"], "length": p["length"], "step": p["step"]} for p in passes],
        "losses": train_losses(exp), "grad_norms": norms, "sampled": sampled_ids(exp),
        "prompt_heads": sorted({tuple(p[:2]) for p in prompts}), "prompt_lens": sorted({len(p) for p in prompts}),
        "segment_ids": row["segment_ids"].tolist(), "padding": row["padding"],
        "peak_gib": torch.cuda.max_memory_reserved() / 2**30,
    }
    Path(out).write_text(json.dumps(result))
    exit_now()


def start_llama3_launch(tmp: str) -> tuple[subprocess.Popen, float]:
    """Phase 30's run in a child process (``llama3_run_main``); it goes
    after 28 (d) beside phases 18-23, and ``phase_llama3`` reads it."""
    work = Path(f"{tmp}/llama3")
    work.mkdir(parents=True, exist_ok=True)
    return start_launch([sys.executable, str(Path(__file__).resolve()), "--llama3-run", str(work),
                         str(work / "result.json")], str(work / "child"))


def check_fixtures(smi: str) -> None:
    """Phase 30's host checks: the committed tokenizer families give the
    ids ``AutoTokenizer`` gave for the committed chats and prompts (the
    prompts with BOS where transformers adds it), and ``decode_jpeg`` of
    the committed JPEGs gives the SHA-256 of PIL's RGB; each decode's host
    seconds logged. Phase 26 gates the committed charts and raw images."""
    from pipelinerl_tpu_torch.inference.image_pipeline import decode_jpeg

    committed = json.loads((FIXTURES / "tokenizer_ids.json").read_text(encoding="utf-8"))
    for name in FAMILIES:
        tok = HFTokenizer(FIXTURES / name)
        chats = committed["messages"]["llama3" if name == "llama3_tokenizer" else "mistral"]
        t0 = time.monotonic()
        got = {chat: tok.apply_chat_template(messages, add_generation_prompt=True, date_string=committed["date_string"],
                                             tools=committed["tools"] if chat == "tool_call" else None)
               for chat, messages in chats.items()}
        encoded = [tok.encode(p) for p in committed["prompts"]]
        spent = time.monotonic() - t0
        want = committed["ids"][name]
        log(f"tokenizer {name} ({len(tok)} entries, bos {tok.bos_token_id}, eos {tok.eos_token_id}): "
            f"{len(got)} chats ({sum(map(len, got.values()))} ids) and {len(encoded)} prompts equal AutoTokenizer's "
            f"committed ids: {got == want['chat'] and encoded == want['encode']}, in {spent:.3f} host s")
        check(got == want["chat"], f"{name}: the chat ids differ from AutoTokenizer's")
        check(encoded == want["encode"] and all(ids[0] == tok.bos_token_id for ids in encoded),
              f"{name}: encode differs from AutoTokenizer's or adds no BOS")
    digests = json.loads((FIXTURES / "jpeg" / "digests.json").read_text())
    for name, digest in digests.items():
        data = (FIXTURES / "jpeg" / name).read_bytes()
        t0 = time.monotonic()
        rgb = decode_jpeg(data)
        spent = time.monotonic() - t0
        same = hashlib.sha256(rgb.tobytes()).hexdigest() == digest
        log(f"JPEG {name} ({len(data)} bytes): decode_jpeg to {rgb.shape[0]}x{rgb.shape[1]} in {spent:.3f} host s, "
            f"its SHA-256 equal to PIL's RGB: {same}; on {smi}")
        check(same, f"{name} does not decode to PIL's RGB")


def phase_llama3(smi: str, tmp: str, run: tuple[subprocess.Popen, float]) -> tuple[dict, dict]:
    """Phase 30: ``start_llama3_launch``'s run, the ``test`` preset at
    Llama-3.2-1B width for 2 steps (engine prefill and decode, the
    trainer's steps, the pushes); then the fixtures on this host. Returns
    (launches, the shapes the kernel rows need)."""
    work = f"{tmp}/llama3"
    returncode, stdout, stderr, wall, left = finish_launch(run, work, f"{work}/child", 900)
    check(returncode == 0, f"phase 30's child exited {returncode}: {(stdout + stderr)[-3000:]}")
    r = json.loads(Path(f"{work}/result.json").read_text())
    for line in stdout.splitlines():
        if "preset cuts" in line:
            log(line.split("] ", 1)[-1] if line.startswith("[") else line)
    stats, actor = r["stats"], r["stats"]["actor"]
    rows = [p for p in r["passes"] if p["length"] == compose("test", ["output_dir=/x"]).finetune.seq_length]
    log(f"Llama-3.2-1B width (tied, bf16, {r['params']:,} params): export_hf wrote {r['bytes']} bytes in "
        f"{r['write_s']:.1f} s; read back as {r['config']} with the {r['tokenizer']}-entry Llama-3-style tokenizer")
    log(f"test preset at Llama-3.2-1B width through launch.main (2 steps): {r['wall']:.1f} s wall, "
        f"{actor['samples_written']} samples, {actor['output_tokens']} sampled tokens, "
        f"{actor['output_tokens'] / r['wall']:.1f} useful tokens/s; engine S {r['engine'][0]} W {r['engine'][1]} "
        f"T_alloc {r['engine'][2]}; prompt lengths {r['prompt_lens']}, first ids {r['prompt_heads']}; "
        f"{len(rows)} passes at L {rows[0]['length'] if rows else '-'}: {[round(p['s'] * 1e3, 1) for p in rows]} ms, "
        f"peak {[round(p['peak'] / 2**30, 2) for p in rows]} GiB (child's peak reserved {r['peak_gib']:.2f} GiB); "
        f"losses {r['losses']}, grad norms {r['grad_norms']}, version {stats['trainer']['last_broadcasted_version']}; "
        f"max sampled id {max(r['sampled'])} (valid_vocab {r['config'][2]}); launches {r['launches']}; child wall "
        f"{wall:.1f} s; on {smi}")
    check(r["params"] == LLAMA32_1B_PARAMS, f"{r['params']:,} params, Llama-3.2-1B has {LLAMA32_1B_PARAMS:,}")
    check(r["config"] == ["LlamaForCausalLM", 128256, r["tokenizer"], 16, 32, 8, 64, 500000.0, 1e-5, True],
          f"the directory read back as {r['config']}")
    check(stats["trainer"]["completed_steps"] == 2 and all(map(math.isfinite, r["losses"]))
          and min(r["grad_norms"]) > 0, f"Llama trainer {stats['trainer']}, losses {r['losses']}")
    check(stats["trainer"]["last_broadcasted_version"] > 0, "no weights were pushed to the engine")
    check(all(r["launches"][k] for k in ("decode", "gqa_fwd", "gqa_dq", "gqa_dkv")), f"launches {r['launches']}")
    check(r["prompt_heads"] == [[128000, 128006]], f"prompts start {r['prompt_heads']}, not <|begin_of_text|> and "
          "a header at their published ids")
    check(max(r["sampled"]) < r["config"][2], f"a sampled id reached valid_vocab: {max(r['sampled'])}")
    check(not left, f"phase 30's child left {left}")
    check_fixtures(smi)
    return r["launches"], {"engine": tuple(r["engine"]), "prompt_lens": r["prompt_lens"],
                           "segment_ids": np.asarray(r["segment_ids"]), "padding": r["padding"]}


def time_llama3_shapes(dev, kernels: list[dict], shapes: dict) -> None:
    """#1 at phase 30's slab (live lengths of its prompts plus up to 32
    tokens), #2 at its prefill bucket (B 8) and #2-#4 on a row it trained
    on, at H 32, K 8 (G 4), Dh 64, each against its plain version and timed
    beside SDPA and its bound."""
    lens = shapes["prompt_lens"]
    time_slab(dev, kernels, "llama3_slab_shape", shapes["engine"], (min(lens), max(lens) + 32), 30, heads=LLAMA3_HEADS)
    bucket = min(b for b in compose("test", ["output_dir=/x"]).engine.prefill_buckets if b >= max(lens))
    time_prefill(dev, kernels, "llama3_prefill", 8, bucket, 30, heads=LLAMA3_HEADS)
    time_train_row(dev, kernels, "llama3_row_shape", shapes["segment_ids"], shapes["padding"], 30, heads=LLAMA3_HEADS)


def profile_study_main(n: int) -> None:
    """``python3 chip_smoke.py --profile-study N``: phases 1-2, then phase 19
    N times as the full smoke runs it, each beside 27 (d)'s processes (an
    engine job and two trainer ranks), from an ``export_hf`` directory of
    random Qwen2.5-0.5B weights: the study of the segfault seen once under
    phase 19's profiler (ROADMAP Queue 3)."""
    info = phase_device()
    dev = torch.device("cuda")
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        params = init_params(torch.Generator(device=dev).manual_seed(0), QWEN05B_TIED, dev)
        hf_dir = export_hf(f"{tmp}/hf_in", params, QWEN05B_TIED, HFTokenizer(FIXTURE_TOKENIZER))
        del params
        torch.cuda.empty_cache()
        for i in range(n):
            work = f"{tmp}/run{i}"
            Path(work).mkdir()
            t0 = time.monotonic()
            world = start_world_launch(hf_dir, work)
            try:
                launches = phase_multi_domain(hf_dir, info["smi"], work)
            except BaseException:
                stop_group(world[0])
                raise
            phase_world_launch(info["smi"], work, world)
            log(f"profile study: run {i + 1} of {n} passed in {time.monotonic() - t0:.1f} s; launches {launches}")
            # each inline run leaves its trainer and engine in reference
            # cycles: without a collection the sixth run's 27 (d) ran out
            # of device memory
            gc.collect()
            torch.cuda.empty_cache()


def llama3_main() -> None:
    """``python3 chip_smoke.py --llama3``: phases 1-2, then phase 30 alone
    and its kernel rows."""
    info = phase_device()
    dev = torch.device("cuda")
    phase_build()
    kernels = [{"max_abs_err": 0.0} for _ in range(5)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        launches, shapes = phase_llama3(info["smi"], tmp, start_llama3_launch(tmp))
        log(f"phase wall: Llama-3.2-1B width {time.monotonic() - t0:.1f} s; launches {launches}")
        t1 = time.monotonic()
        time_llama3_shapes(dev, kernels, shapes)
        log(f"phase wall: Llama-3.2-1B kernel rows {time.monotonic() - t1:.1f} s")
    log(json.dumps({"kernels": kernels}))


def main() -> None:
    marks = [time.monotonic()]

    def lap(name: str) -> None:
        """Log the seconds since the previous mark: each phase's wall."""
        marks.append(time.monotonic())
        log(f"phase wall: {name} {marks[-1] - marks[-2]:.1f} s (total {marks[-1] - marks[0]:.1f} s)")

    info = phase_device()
    dev = torch.device("cuda")
    ptxas = phase_build()
    kernels = [phase_decode_kernel(dev), phase_gqa_kernel(dev, ptxas.get("gqa_attention_fwd", "")),
               *phase_gqa_bwd_kernels(dev, ptxas.get("gqa_attention_bwd", "")),
               phase_paged_kernel(dev)]
    lap("kernels")
    torch.cuda.empty_cache()
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        trainer, paths["train_step"] = phase_train_step(dev, info["smi"], f"{tmp}/train")
        paths["engine"] = phase_engine(dev, info["smi"], trainer, f"{tmp}/train")
        lap("train step, engine")
        del trainer
        torch.cuda.empty_cache()
        paths["paged_engine"], snapshots = phase_paged_engine(dev, info["smi"])
        torch.cuda.empty_cache()
        time_paged_working_set(dev, snapshots, kernels[-1])
        lap("paged engine")
        del snapshots
        torch.cuda.empty_cache()
        paths["prefix_cache"] = phase_prefix_cache(dev)
        torch.cuda.empty_cache()
        paths["slab_prefix"], paths["score_tokens"] = phase_slab_prefix(dev, info["smi"])
        torch.cuda.empty_cache()
        phase_client(dev)
        lap("prefix cache, slab prefix, client")
        paths["rl_loop"] = phase_rl_loop(f"{tmp}/bandit")
        paths["rl_loop_paged"] = phase_rl_loop(f"{tmp}/bandit_paged", paged=True)
        paths["rl_loop_kl"] = phase_rl_loop_kl(f"{tmp}/bandit_kl")
        lap("rl loops")
        paths["guessing"] = phase_guessing(f"{tmp}/guessing")
        lap("guessing")
        torch.cuda.empty_cache()
        paths.update(phase_hf_checkpoint(dev, info["smi"], f"{tmp}/hf"))
        lap("hf checkpoint")
        # phase 14's recording trainers sit in a reference cycle (instance,
        # class, the closure's list): about 24 GiB that phase 18 needs
        gc.collect()
        torch.cuda.empty_cache()
        paths["served_engine"], paths["push_while_decoding"] = phase_served_engine(dev, info["smi"], tmp)
        lap("served engine, push")
        runs = {split: start_processes(f"{tmp}/processes_{name}", split)
                for split, name in ((False, "device"), (True, "split"))}
        try:
            paths["processes_device"] = phase_processes(f"{tmp}/processes_device", False, info["smi"], runs[False])
            paths["processes_split"] = phase_processes(f"{tmp}/processes_split", True, info["smi"], runs[True])
        finally:
            for proc, _ in runs.values():
                if proc.poll() is None:
                    stop_group(proc)
        lap("processes mode")
        hf_dir = Path(f"{tmp}/hf/hf_in") / CURRENT_DIR  # where phase 14's export_hf wrote
        # phases 27 (d) and then 28 (d) go beside phases 18-23, whose single
        # process leaves most cores idle and holds at most about 26 GiB of the
        # card beside their 33; the kernel rows wait until they have ended
        world_launch = start_world_launch(hf_dir, tmp)
        tp_launch = start_after(world_launch, lambda: start_tp_launch(hf_dir, tmp))
        # phase 30 after 28 (d): its 1.24 B model's trainer and engine
        # reserve about 30 GiB, which the card has beside phases 18-23 and
        # one of the three runs at a time
        llama_launch = start_after(tp_launch, lambda: start_llama3_launch(tmp))
        try:
            paths["math"], math_shapes = phase_math(hf_dir, info["smi"], tmp)
            lap("math")
            gc.collect()
            torch.cuda.empty_cache()
            paths["multi_domain"] = phase_multi_domain(hf_dir, info["smi"], tmp)
            lap("multi_domain")
            torch.cuda.empty_cache()
            paths.update(phase_short_domains(hf_dir, info["smi"], tmp))
            lap("logic, ifeval, fn_calling")
            gc.collect()
            torch.cuda.empty_cache()
            paths["tir"], tir_shapes = phase_tir(hf_dir, info["smi"], tmp)
            lap("tir")
            gc.collect()
            torch.cuda.empty_cache()
            paths.update(phase_coding_miniwob(hf_dir, info["smi"], tmp))
            paths["deep_research"] = phase_deep_research(hf_dir, info["smi"], tmp)
            lap("coding, miniwob, deep_research")
            paths["trainer_world_launch"] = phase_world_launch(info["smi"], tmp, world_launch)
            paths["tp_launch"] = phase_tp_launch(info["smi"], tmp, tp_launch())
            lap("trainer world (d) and tp (d), the rest of their wall beside phases 18-23")
            paths["llama3"], llama_shapes = phase_llama3(info["smi"], tmp, llama_launch())
        except BaseException:
            if world_launch[0].poll() is None:
                stop_group(world_launch[0])
            tp_launch(cancel=True)
            llama_launch(cancel=True)
            raise
        lap("Llama-3.2-1B width (phase 30), the rest of its wall after 28 (d)")
        gc.collect()
        torch.cuda.empty_cache()
        time_math_shapes(dev, kernels, math_shapes)
        time_tir_shapes(dev, kernels, tir_shapes)
        time_llama3_shapes(dev, kernels, llama_shapes)
        lap("math, tir and Llama-3.2-1B kernel rows")
        torch.cuda.empty_cache()
        paths["logic_processes"] = phase_logic_processes(hf_dir, info["smi"], tmp)
        lap("logic in processes mode")
        gc.collect()
        torch.cuda.empty_cache()
        # phase 25's two toy runs go beside phases 26 and 27, which leave most
        # cores idle; the kernel rows wait until they have ended
        vlm_bandit = start_vlm_bandit(tmp)
        try:
            paths["vlm_slab"], paths["vlm_paged"] = phase_vlm_paged(dev)
            lap("toy VLM slab and paged")
            gc.collect()
            torch.cuda.empty_cache()
            free, total = torch.cuda.mem_get_info()
            log(f"device memory free before phase 26: {free / 2**30:.2f} of {total / 2**30:.2f} GiB")
            paths["vlm_3b"], vlm_shapes = phase_vlm_3b(dev, info["smi"], tmp)
            lap("Qwen2.5-VL-3B")
            gc.collect()
            torch.cuda.empty_cache()
            paths["trainer_world"] = phase_trainer_world(hf_dir, info["smi"], tmp, tir_shapes["segment_ids"])
            lap("trainer world")
        except BaseException:
            for proc in vlm_bandit[0]:
                if proc.poll() is None:
                    stop_group(proc)
            raise
        paths["vlm_bandit"] = phase_vlm_bandit(tmp, vlm_bandit)
        lap("vlm_bandit, the rest of its wall beside phases 26-27")
        gc.collect()
        torch.cuda.empty_cache()
        time_vlm_shapes(dev, kernels, vlm_shapes)
        torch.cuda.empty_cache()
        time_cp_rows(dev, kernels, tir_shapes["segment_ids"])
        lap("VLM and cp kernel rows")
        gc.collect()
        torch.cuda.empty_cache()
        paths["tp"], tp_shapes = phase_tp(hf_dir, info["smi"], tmp, math_shapes["segment_ids"], math_shapes["padding"])
        torch.cuda.empty_cache()
        time_tp_shapes(dev, kernels, tp_shapes)
        lap("tensor parallelism")
        gc.collect()
        torch.cuda.empty_cache()
        paths["pp"] = phase_pp(hf_dir, info["smi"], tmp)
        lap("pipeline parallelism")
    for record, key in zip(kernels, ("decode", "gqa_fwd", "gqa_dq", "gqa_dkv", "paged")):
        record["launches_by_path"] = {path: c[key] for path, c in paths.items()}
        record["launches"] = sum(record["launches_by_path"].values())
    log(json.dumps({"kernels": kernels}))
    check_reaped()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"], "count": info["count"]}}))


# seconds a process of the run that is still ending (a launcher's job after
# its SIGTERM) gets before the last check calls it left
REAP_SETTLE_S = 5.0


def check_reaped() -> None:
    """The child's last check: no process of this run is left. A process
    still ending gets ``REAP_SETTLE_S`` to go by itself; each one left then
    is killed and named in the failure."""
    marker, tmp = os.environ.get(reaper.MARKER), os.environ.get(reaper.RUN_TMP)
    deadline = time.monotonic() + REAP_SETTLE_S
    while marker and reaper.marked(marker, tmp) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = reaper.sweep_run()
    check(not left, f"{len(left)} process(es) of this run still running at its end: {reaper.describe(left)}")


def child_main() -> None:
    """A user mode's work in the parent's one child (this process carries
    the run's marker): the mode, then ``check_reaped``; on a failure, a
    sweep of the run before the error goes up."""
    reaper.guard_child()
    mode = sys.argv[1:2]
    try:
        if mode == ["--trainer-world"]:
            trainer_world_main(int(sys.argv[2]))
        elif mode == ["--tp-world"]:
            tp_main()
        elif mode == ["--pp-world"]:
            pp_main()
        elif mode == ["--llama3"]:
            llama3_main()
        elif mode == ["--profile-study"]:
            profile_study_main(int(sys.argv[2]))
        elif mode == ["--tp-loss-study"]:
            tp_loss_study_main(int(sys.argv[2]))
        else:
            main()
            return  # main checks before its result line
        check_reaped()
    except BaseException:
        left = reaper.sweep_run()
        if left:
            log(f"swept after the failure: {reaper.describe(left)}")
        raise


if __name__ == "__main__":
    faulthandler.enable(all_threads=True)
    if sys.argv[1:2] == ["--http-load"]:
        http_load(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    elif sys.argv[1:2] == ["--push"]:
        push_client(*sys.argv[2:6])
    elif sys.argv[1:2] == ["--world-rank"]:
        world_rank_main(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    elif sys.argv[1:2] == ["--tp-rank"]:
        tp_rank_main(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    elif sys.argv[1:2] == ["--tp-loss-rank"]:
        tp_loss_rank_main(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    elif sys.argv[1:2] == ["--pp-rank"]:
        pp_rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), *sys.argv[5:8])
    elif sys.argv[1:2] == ["--llama3-run"]:
        llama3_run_main(sys.argv[2], sys.argv[3])
    else:
        child_main()
