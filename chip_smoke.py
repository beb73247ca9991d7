#!/usr/bin/env python3
"""Drive the PyTorch port's MACE serving and training paths on one NVIDIA
GPU, at every kernel impl and precision, and its LM family, and check them.

    python3 chip_smoke.py

Run from the repository root (the script finds ``src/repro_torch`` next to
itself).  Phases, none of them caught, so any failure exits nonzero:

1. build the CUDA kernels from ``src/repro_torch/csrc``: nine libraries, one
   ``nvcc`` each, all started together (the symmetric-contraction source and
   the interaction source for each layer's tensor-product spec, each at
   fp32, bf16 and fp8, with the generated header of that spec and
   precision), and print ptxas's register, stack and spill report per
   kernel; every kernel must have no stack frame and no spills; then hold
   each precision's operand rounding (``round_op``) against the plain
   ``round_to``, bit for bit, on a table of edge cases and 100,000 random
   values;
2. hold each of the four kernels at each precision against its plain
   PyTorch version on the card, at the shapes the 256-atom bucket of the
   paper's model gives it (both interaction layers; receivers with a hub
   atom spanning several tiles and fully masked padding tiles), check that
   two launches of each kernel give bit-identical outputs and that a bf16
   or fp8 launch does not give the fp32 one's, and time both versions by
   CUDA events per call (``ms`` and ``plain_ms``, the wrapper's host work
   included); time the dense-U einsum baseline ``symcon_ref`` on the
   symmetric contraction's inputs (``library_ms``: its einsums, and its
   ``torch.autograd.grad`` for the backward) after checking that it
   computes what the fp32 kernels compute; run all four kernels at every
   precision, checked the same way, at the training capacity of 3,072 atoms
   too, on the edge blocking of the training run's first bin (the
   interaction kernels at both layers); and the interaction kernels as the
   TP-only op ``tp_cuda`` launches them (the identity blocking, a tile per
   128 edges), fp32, on the bin's 147,456 padded edges;
3. start a full-width ``GraphServer`` (the paper's §5.2 widths, random
   weights from a seed, buckets of 64 and 256 atoms, 2 workers; each
   bucket captured as one CUDA graph at warm-up) and serve 48 molecules of
   a skewed mix; the census is one graph per bucket after the warm-up and
   after the mix, and every kernel's launch count over that run (made by
   replays) must be above zero; then, per bucket, one replay on a real bin
   against the eager ``mace_energy_forces`` on the same batch (within the
   kernel tolerance), each kernel's launches per bin through the replay
   equal to the eager call's, both timed per bin (CUDA events and wall
   time), each bucket's graph pool, and the memory a closed engine
   returns; then the serving entry point ``python -m
   repro_torch.launch.serve_mace --config paper`` as a child process,
   with ``--kill-worker`` and with ``REPRO_FAULT_PLAN`` arming a worker
   fault: each exits 0, serves every request through a drain-and-rebuild,
   and ends with one graph per bucket;
4. train at the paper's width: ``Trainer`` with the balanced sampler at
   capacity 3,072 (``edge_factor`` 48) over ``SyntheticCFMDataset(2000,
   seed=0, max_atoms=256)``, one rank, prefetch 1, random weights from the
   seed; 5 steps, each engine step timed by CUDA events with its atoms/s,
   loss, ``e_rmse``, ``f_rmse`` and kernel launches, which must be 2/4/2/4
   for ``symcon_fwd``/``symcon_bwd``/``tp_scatter_fwd``/``tp_gather_bwd``
   per bin; every loss finite; the peak device memory;
5. the variants, each run with the launch counts set to 0 just before it
   and read just after: serve the 48 molecules again at bf16 and at fp8
   (energies and forces finite, within the reference's ``PRECISION_TOL`` of
   the fp32 run's, L2 norm-relative, not bitwise equal to them, every
   kernel launched on that precision's libraries); one 256-atom bin of
   them without the edge blocking (the unblocked path) and with the
   ``fused`` and ``ref`` impls, each against the blocked ``cuda`` path
   within the kernel tolerance; 3 training steps at bf16 from phase 4's
   parameters and bins (losses within 5e-2 relative of its first three,
   not equal, 2/4/2/4 launches per bin on the bf16 libraries); 3 fp32 steps
   with the interaction's fused backward against 3 with its kernel
   backward, at capacity 1,024 (losses within 5e-4);
6. measure under ``torch.profiler``: serve the molecules once more,
   through the graphs, for the card's busy and idle share and each
   kernel's launches recorded beside those made (a reading from under 90%
   of them is taken again, and then fails); time each kernel's own device time per
   launch on phase 2's inputs (``device_ms``), with its share of its bound
   per layer, and at 3,072 atoms with the L2 cache flushed before each
   launch; profile one more training step (device-op breakdown, idle
   share, each kernel's device time in the step beside its launches
   recorded and made);
7. checkpoint the trainer after its last step and restore it into a fresh
   one: parameters, optimizer state and EMA bit-identical;
8. compare with the CPU (plain versions): a few served molecules'
   energies and forces, and a 3-step training trajectory at capacity 256
   from the same parameters over the same bins (each step's loss,
   gradients and update from the CPU's state; then the card's own
   trajectory: its losses, and its final parameters wherever Adam's
   update is well conditioned);
9. data parallelism, one process per rank (``launch.multihost.spawn_local``
   children of this script, ``--dp-rank``, sharing the card over gloo),
   after the parent releases its cached memory: ``DataParallelEngine`` at
   R = 2, plain and int8-compressed, and ``MultiHostEngine`` at 2 nodes x 2
   devices, compressed, 3 steps each at capacity 3,072 from the seed's
   weights; each run timed, then again under torch's deterministic
   algorithms with autograd on the calling thread, and the sequential
   oracle at the same R in a process of its own run that way too, from the
   same weights over the same bins; in both runs each step's reduction and
   update against the oracle's on the ranks' own gradients from the
   step's state (within the JAX engine bounds) and the losses against the
   oracle's (rtol 1e-5); the deterministic run's free trajectory against
   the oracle's (parameters, optimizer state and EMA within the bound
   wherever the oracle's Adam stayed well conditioned, the rest counted);
   every rank a bit-identical replica with 2/4/2/4 launches per bin per
   step; printed
   per rank of the timed run: step ms, atoms/s, the all-reduce's ms (CUDA events around the
   reduction, host staging and the wait for the slowest rank included), a
   host round trip of the flat gradient, peak memory, and the measured
   straggler ratio beside the token-count proxy of the same bins; then one
   compressed step of a world of one through NCCL against phase 4's first
   loss;
10. the autotuner (``kernels.autotune``): tune the main paths' shapes at
   the paper's width (the 64- and 256-atom buckets and the 3,072-atom bin,
   ``edge_factor`` 48) for at most ``AUTOTUNE_BUDGET_S`` seconds into a
   temporary trajectory, CUDA-event medians of 5 graph replays per
   candidate, and
   print each ``gpu`` decision with its two best measured configs beside
   the committed table's decision and the card's name and power limit (not
   held: the run-to-run spread can flip a near tie); ``check_table("gpu")``
   on the committed table and trajectory must report no problem; then a
   ``Trainer`` with ``impl="auto"`` and ``interaction_impl="auto"`` at
   3,072 atoms takes 2 steps, and one naming the impls, tile geometry and
   backward those resolve to takes the same 2 steps, each in a process of
   its own under phase 9's deterministic settings: their losses equal,
   bit for bit, and each step's launches per bin those the resolved names
   imply (2/4/2/4 when every kind resolves to ``cuda``); and a
   ``GraphServer`` with ``interaction_impl="auto"`` serves the 48
   molecules (one graph per bucket, the decisions in ``stats()``, energies
   and forces within 2e-4 L2-relative of phase 3's); last the tiles
   ``"auto"`` resolves to are timed against the default 32x128 on the same
   inputs, in the order default, auto, auto, default: each serving
   bucket's graph replay on one real bin of the 48 molecules (the two
   within ``KERNEL_TOL``), and training steps on the same 3,072-atom bins
   at each geometry the two paths resolve to (not held: a measurement);
11. elastic and supervised training, at the paper's width and capacity
   3,072 (``edge_factor`` 48) over phase 4's dataset: (a) an
   ``ElasticTrainer`` on the sequential engine at R = 2, prefetch 1, a
   checkpoint every step, rescaled to R = 1 after step 2, 4 steps: per
   step the CUDA-event ms, atoms/s, loss and launches (2/4/2/4 per bin),
   the rescale event and the merged telemetry of its 2 generations; no
   graph taken twice, every one from epoch 0; the checkpoints of steps 2
   and 4 record R and the lineage; (b) restart equivalence, three
   processes at once under phase 9's deterministic settings: the
   uninterrupted run of (a); drill A, killed by ``REPRO_FAULT_PLAN``
   ``crash_at_step`` after step 4 (before its checkpoint), then a trainer
   at R = 1 with ``elastic`` restores step 3 and takes step 4; drill B, 2
   steps at R = 2, then a trainer at R = 1 with ``elastic`` restores across
   rank counts and takes steps 3-4; each drill's losses within rtol 1e-5
   of the uninterrupted run's, its final parameters, optimizer state and
   EMA within the JAX engine bounds where Adam stayed well conditioned
   (the rest counted); (c) the supervised drills:
   ``python -m repro_torch.launch.train --distributed --supervised
   --nprocs 2 --steps 4 --ckpt-every 1`` (the paper's config at capacity
   3,072, two gloo ranks on the card) with process 1 crashing after step
   2, and with process 0 hung in collation at step 2 under a step deadline
   of 10 times (a)'s slowest warm step (at least 20 s): each exits 0 with the
   incidents crash (or hang), relaunch at world size 1, recovered,
   success, its final checkpoint step 4 at one rank by one process, and
   the relaunched rank's launches 2/4/2/4 per step; ``detection_s``,
   ``recovery_s``, ``steps_lost`` and each attempt's wall time printed;
12. the LM family (``repro_torch.models``; no TPU kernel, so none of
   the four CUDA kernels: their launch counts over the phase must stay 0),
   after freeing phase 11's memory: (a) full-width training of
   ``granite_3_2b`` at its published config (40 layers, d 2048, 32/8
   heads, d_ff 8192, vocab 49,155; bf16 compute, fp32 parameters and
   Adam, remat), random weights from the seed, on 2 x 2,048 tokens packed
   by Algorithm 1 (``pack_documents``) from ``launch/lm_pretrain.py``'s
   synthetic Pareto documents: the bf16 forward loss of the first batch
   within ``PRECISION_TOL["bf16"]`` of an fp32-compute forward on the same
   parameters, then one warm-up ``make_lm_train_step`` step and 3 timed
   by CUDA events: step ms, tokens/s, peak memory and the model-FLOP share
   of ``HW.peak_flops_bf16`` (``lm_cell_cost``); every loss and gradient
   norm finite; (b) every one of the ten ``REDUCED`` configs, fp32, on the
   card and on the CPU from the same seeded parameters: one train step
   (loss, Adam's moments and the parameters after it within 2e-4; the
   parameters where Adam is well conditioned, the rest within 2 lr), then
   ``LMServeEngine``'s prefill and 4 decode steps by graph replay (census
   1 and 1) against the CPU engine's eager calls: logits within 2e-5, the
   same greedy tokens; (c) full-width serving: ``python -m
   repro_torch.launch.serve --config full --arch granite-3-2b`` in
   process (bf16 parameters), 20 requests of 512 tokens in batches of 8
   (the last padded), 64 new tokens each: tokens/s, prefill ms and decode
   ms per token by replay, the same eager on the first batch (its first 8
   greedy tokens those of the replay), the census exactly 1 and 1;
13. the LM scaffold's multi-device half (no TPU kernel: the four CUDA
   kernels' launch counts over the phase, read in every child process
   that runs it and summed, must stay 0): (a) the manual-DP
   step ``make_lm_train_step_ddp`` on ``xlstm_125m`` at its published
   config (12 layers, d 768, 4 heads, vocab 50,304; bf16 compute, fp32
   parameters and Adam), R = 2 gloo processes sharing the card
   (``chip_smoke.py --lm-ddp-rank`` children, phase 9's deterministic
   settings), random weights from the seed, one packed sequence of
   ``LM_DDP_SEQ`` tokens per rank from ``launch/lm_pretrain.py``'s
   documents; 3 plain steps and 3 compressed (the two groups and (b) at
   once), each timed by CUDA events
   (step ms, all-reduce ms with the host staging, tokens/s, peak memory
   per rank); the ranks stay bit-identical replicas (a digest of every
   parameter's and moment's bits, and the losses), and after the run rank
   0 holds each step against the oracle from the step's own state: both
   ranks' gradients computed in turn, averaged (or quantised and averaged
   by the port's one-process emulation), the same AdamW (losses within
   rtol 1e-5; parameters, m and v within 2e-4 where Adam is well
   conditioned, the rest counted); (b) one plain step of (a)'s model
   in an NCCL world of one against ``make_lm_train_step`` on the
   same state and batch (the mean of one rank issues no collective; phase
   9's compressed world of one drives NCCL's); (c) the dry run at full width as child processes,
   all at once (``python -m repro_torch.launch.dryrun``: ``DRYRUN_CELLS``), each ok
   with all-reduce bytes (any collective, for a decode cell), collective
   bytes and FLOPs above 0 and ``argument_gb`` equal to its placements'
   local shard bytes, printing ``trace_s``, the bytes by kind and the
   roofline terms, and recording the four kernels' launches while it
   traced (``kernel_launches``);
14. report: the card's name and power limit, one JSON line of kernel
   numbers (each kernel at each precision, and the identity-blocked
   interaction kernels; the fp32 entries also carry the data-parallel
   runs' launches, the autotune phase's and the elastic phase's), and
   last a JSON line with ``"ok": true``.

Without a CUDA device it exits with code 2 before printing any result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import inspect
import itertools
import json
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC_DIR))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.bridge import params_to, unflatten  # noqa: E402
from repro_torch.configs.mace_cfm import CONFIG  # noqa: E402
from repro_torch.core.mace import init_mace, mace_energy_forces  # noqa: E402
from repro_torch.core.symmetric_contraction import symcon_ref  # noqa: E402
from repro_torch.data.blocking import (  # noqa: E402
    DEFAULT_BLOCK_E, DEFAULT_BLOCK_N, EdgeBlocking, block_edges, blocking_from_batch,
)
from repro_torch.data.collate import collate_bin  # noqa: E402
from repro_torch.core.binpack import Bins, balance_metrics  # noqa: E402
from repro_torch.data.molecules import SyntheticCFMDataset  # noqa: E402
from repro_torch.kernels import autotune, cuda_lib  # noqa: E402
from repro_torch.kernels.channelwise_tp import kernel as tpk  # noqa: E402
from repro_torch.kernels.channelwise_tp import ops as tp_ops  # noqa: E402
from repro_torch.kernels.precision import PRECISIONS, round_to  # noqa: E402
from repro_torch.kernels.symmetric_contraction import kernel as sck  # noqa: E402
from repro_torch.kernels.bench import card_line  # noqa: E402
from repro_torch.configs import ARCH_IDS as LM_ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config as get_lm_config  # noqa: E402
from repro_torch.configs import get_reduced as get_lm_reduced  # noqa: E402
from repro_torch.data.sequence_pack import pack_documents  # noqa: E402
from repro_torch.launch import lm_pretrain  # noqa: E402
from repro_torch.launch import serve as lm_serve_cli  # noqa: E402
from repro_torch.launch.lm_train_step import (  # noqa: E402
    init_opt_state, lm_value_and_grad, make_lm_train_step, make_lm_train_step_ddp,
)
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.roofline.analytic import lm_cell_cost  # noqa: E402
from repro_torch.serve.lm_engine import LMServeEngine  # noqa: E402
from repro_torch.launch.multihost import initialize_distributed, spawn_local  # noqa: E402
from repro_torch.roofline.analysis import HW  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    GraphServer,
    ServeConfig,
    ServeEngine,
    bucket_key,
    bucket_ladder,
    make_serve_engine,
    select_bucket,
)
from repro_torch.resilience import ENV_FAULT_PLAN, SimulatedCrash  # noqa: E402
from repro_torch.train.checkpoint import flatten_state, latest_step, read_meta  # noqa: E402
from repro_torch.train.engine import MergedTelemetry, SequentialEngine, make_engine  # noqa: E402
from repro_torch.train.optimizer import adamw, apply_updates  # noqa: E402
from repro_torch.train.optimizer import tree_map as opt_tree_map  # noqa: E402
from repro_torch.train.train_loop import ElasticTrainer, Trainer, TrainerConfig  # noqa: E402

HBM_BYTES_PER_S = HW().hbm_bw       # H100 SXM device memory
FP32_FLOPS = HW().peak_flops_fp32   # H100 SXM fp32 outside the tensor cores
KERNEL_TOL = 2e-5           # relative to the output's largest magnitude
SERVE_RTOL = 1e-4           # GPU vs CPU, energies and forces
SEED = 0
CAPACITIES = (64, 256)
EDGE_FACTOR = 48
N_REQUESTS = 48
TRAIN_ATOMS = 3072          # examples/train_mace_cfm.py's capacity on real hardware
TRAIN_GRAPHS = 2000         # examples/train_mace_cfm.py's --n-graphs default
TRAIN_STEPS = 5
# launches of each kernel per bin of a training step: the forward kernels
# once; the backward kernels inside the forces' autograd.grad and again in
# the loss's backward (the derivative of a backward is its plain twin's)
PER_BIN = {"symcon_fwd": 2, "symcon_bwd": 4, "tp_scatter_fwd": 2, "tp_gather_bwd": 4}
# the card against the CPU over a short trajectory: the cross-implementation
# tolerances of tests/test_engine.py:493 (the card's index_add_ sums in no
# fixed order)
CPU_CAPACITY = 256
CPU_STEPS = 3
TRAIN_LOSS_RTOL = 5e-4
TRAIN_PARAM_RTOL, TRAIN_PARAM_ATOL = 2e-3, 2e-5
# the free-running parameters are held to that bound where the CPU's Adam
# denominator sqrt(v_hat) was 0 or above this many eps at every step: there
# a gradient's float32 rounding moves Adam's update by little (see
# compare_training_with_cpu); eps and b2 are TrainerConfig's AdamW's
ADAM_HELD_EPS = 100
_ADAM_DEFAULTS = inspect.signature(adamw).parameters
ADAM_EPS, ADAM_B2 = _ADAM_DEFAULTS["eps"].default, _ADAM_DEFAULTS["b2"].default
# zeroed before each launch timed at TRAIN_ATOMS, five times the card's 50 MB
# L2: the kernel reads its inputs from device memory and, as after an op
# that wrote its output, writes back the dirty lines it evicts (the
# slowest of the cache states compared in PERF.md)
L2_FLUSH_BYTES = 256 << 20
# the profiler does not always record every launch (it has missed 1 of 20):
# a device time counts only when it averages over at least this share of
# the launches made, and the JSON line carries both counts
MIN_RECORDED = 0.9

# the reference's bound per precision, L2 norm-relative (tests/test_precision.py:41)
PRECISION_TOL = {"fp32": 2e-4, "bf16": 5e-2, "fp8": 4e-1}
VARIANT_STEPS = 3           # training steps of each variant's run
# the interaction's fused backward (bwd_impl="fused": autograd through
# interaction_fused) keeps every [E, k, nnz] intermediate of both layers for
# the loss's second order, which the chunked twin of bwd_impl="cuda" does
# not; its run is cut to this capacity, a third of TRAIN_ATOMS, and prints
# its peak memory
FUSED_BWD_CAPACITY = 1024
FUSED_BWD_PER_BIN = dict(PER_BIN, tp_gather_bwd=0)  # no backward kernel
FUSED_BWD_LOSS_RTOL = 5e-4  # as TRAIN_LOSS_RTOL: one function, two backwards
# the operand rounding of the bf16 and fp8 builds against round_to, bit for
# bit: zeros, fp8's largest value 448 and its NaN threshold above 464, the
# infinities and NaNs, ties (to even) of both types, subnormals of e4m3, and
# bf16's overflow to infinity; then ROUND_RANDOM values over 22 binades
ROUND_TABLE = [0.0, -0.0, 448.0, 449.0, 464.0, -464.0, 465.0, -465.0, 480.0, 1000.0,
               float("inf"), float("-inf"), float("nan"), -float("nan"),
               1.0625, 1.1875, -1.0625, 1 + 2 ** -8, 1 + 3 * 2 ** -8,
               2 ** -10, 1.5 * 2 ** -9, 1.25 * 2 ** -9, 2 ** -7 * 1.0625, 3.3e38, -3.4e38]
ROUND_RANDOM = 100_000

# the data-parallel phase: each run spawns one gloo process per rank on the
# card and is held against the sequential oracle at the same R (name,
# engine, R, n_nodes, compressed); the JAX engine bounds of
# tests/test_engine.py:296-302,362 per compression
DP_RUNS = [("data_parallel_plain", "data_parallel", 2, None, False),
           ("data_parallel_compressed", "data_parallel", 2, None, True),
           ("multihost_compressed", "multihost", 4, 2, True)]
DP_STEPS = 3
DP_LOSS_RTOL = 1e-5
DP_PARAM_TOL = {False: (2e-5, 1e-6), True: (1e-4, 2e-5)}
DP_DEADLINE_S = 300         # each group of rank processes, start to exit
DP_COLLECTIVE_TIMEOUT_S = 240
# the autotune phase: the tuner's search budget (checked before each shape,
# as the JAX tuner's) and the steps of each training run
AUTOTUNE_BUDGET_S = 90.0
AUTOTUNE_STEPS = 2
GEOMETRY_REPLAYS = 20       # graph replays a reading, per bucket
GEOMETRY_STEPS = 3          # training steps a reading

KERNELS = {
    "symcon_fwd": dict(kernel=sck.SYMCON_FWD, symbol="symcon_fwd_kernel",
                       source="src/repro_torch/csrc/symmetric_contraction.cu",
                       replaces="src/repro/kernels/symmetric_contraction/kernel.py:82"),
    "symcon_bwd": dict(kernel=sck.SYMCON_BWD, symbol="symcon_bwd_kernel",
                       source="src/repro_torch/csrc/symmetric_contraction.cu",
                       replaces="src/repro/kernels/symmetric_contraction/kernel.py:166"),
    "tp_scatter_fwd": dict(kernel=tpk.TP_SCATTER_FWD, symbol="tp_scatter_kernel",
                           source="src/repro_torch/csrc/channelwise_tp.cu",
                           replaces="src/repro/kernels/channelwise_tp/kernel.py:58"),
    "tp_gather_bwd": dict(kernel=tpk.TP_GATHER_BWD, symbol="tp_gather_bwd_kernel",
                          source="src/repro_torch/csrc/channelwise_tp.cu",
                          replaces="src/repro/kernels/channelwise_tp/kernel.py:106"),
}


def _ptxas_report(log: str):
    """``{kernel: "S bytes stack frame, ...; Used N registers, ..."}`` from
    ptxas -v, by the kernel symbols of ``KERNELS``."""
    symbols = [spec["symbol"] for spec in KERNELS.values()]
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            name = next((s for s in symbols if s in m.group(1)), m.group(1))
        elif name and ("stack frame" in line or "registers" in line):
            text = line.split("ptxas info    :")[-1].strip()
            out[name] = f"{out[name]}; {text}" if name in out else text
    return out


def _time_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, symbol: str, reps: int, before=None):
    """``(ms, recorded)``: mean device milliseconds per launch of the kernel
    ``symbol`` over the ``recorded`` launches the profiler records in
    ``reps`` calls of ``fn``, after a warm-up: the kernel's own time,
    without the host work around the launch.  ``before``, if given, runs
    before each call (an L2 flush).  A run that records fewer than
    ``MIN_RECORDED`` of the launches is measured again, twice at most, and
    then fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        mine = [e for e in prof.key_averages() if symbol in e.key]
        us, seen = sum(map(_device_us, mine)), sum(e.count for e in mine)
        if seen != reps:
            print(f"profiler: {seen} launches of {symbol} recorded of {reps}", flush=True)
        if us > 0 and seen >= MIN_RECORDED * reps:
            return us / seen / 1e3, seen
    raise AssertionError(f"the profiler recorded {seen} launches of {symbol} of {reps}, "
                         f"device time {us} us")


def _bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _compare(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err, scale = 0.0, 0.0
    for g, w in zip(got, want):
        err = max(err, float((g - w).abs().max()))
        scale = max(scale, float(w.abs().max()))
    ok = err <= KERNEL_TOL * max(1.0, scale)
    return err, scale, ok


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------


def _symcon_work(spec, N, k):
    """(bytes, flops) of the forward and of the backward over N atoms and k
    channels: each input read once, each output written once."""
    groups = sck._group_entries(spec, sck.build_symcon_tables(spec))[0]
    d_in, P, d_out = spec.in_spec.dim, sck.p_total_of(spec), spec.out_spec.dim
    fwd_ops = sum(n * (nu + 1) + 2 for (_, _, nu, n, _) in groups) * N * k
    bwd_ops = sum(n * (nu + 1 + nu * (nu + 2)) + 3 for (_, _, nu, n, _) in groups) * N * k
    return ((4 * N * k * (d_in + P + d_out), fwd_ops),
            (4 * N * k * (2 * (d_in + P) + d_out), bwd_ops))


def _symcon_library(A_t, W_t, G_t, spec):
    """The dense-U einsum baseline ``symcon_ref`` on the kernels' inputs:
    species ``arange(N)`` and per-atom weights sliced from ``W_t``, so its
    weight gather is an identity and it computes the kernels' B.  Returns
    (forward, backward) pairs of (call, its output in kernel layout): the
    forward runs the einsums, the backward ``torch.autograd.grad`` of their
    output with respect to (A, W) with G."""
    species = torch.arange(A_t.shape[0], device=A_t.device)
    A = A_t.transpose(1, 2).contiguous().requires_grad_(True)
    weights, off = {}, 0
    for (L, nu) in spec.terms():
        n = spec.n_paths(L, nu)
        weights[f"w_L{L}_nu{nu}"] = (
            W_t[:, off:off + n].transpose(1, 2).contiguous().requires_grad_(True))
        off += n
    G = G_t.transpose(1, 2).contiguous()
    leaves = [A, *weights.values()]
    B = symcon_ref(A, species, weights, spec)

    def fwd():
        with torch.no_grad():
            return symcon_ref(A, species, weights, spec)

    def bwd():
        return torch.autograd.grad(B, leaves, G, retain_graph=True)

    return ((fwd, lambda b: b.transpose(1, 2)),
            (bwd, lambda g: (g[0].transpose(1, 2), torch.cat(g[1:], -1).transpose(1, 2))))


def _bucket_blocking(rng, bucket):
    """Receivers of a 256-atom bucket: degrees like the dataset's plus one hub
    atom of degree 300 (three tiles sharing a base); the rest of the static
    tile count is padding tiles."""
    n_atoms = bucket.max_nodes
    deg = rng.integers(8, 40, n_atoms)
    deg[5] = 300
    receivers = np.repeat(np.arange(n_atoms), deg).astype(np.int32)
    rng.shuffle(receivers)
    E = bucket.max_edges
    edge_mask = np.zeros(E, bool)
    edge_mask[: receivers.size] = True
    receivers = np.concatenate([receivers, np.zeros(E - receivers.size, np.int32)])
    blk = block_edges(receivers, edge_mask, n_atoms, block_n=bucket.block_n,
                      block_e=bucket.block_e, n_tiles=bucket.blocking_tiles)
    assert (blk.tile_base == 0).sum() >= 3, "expected the hub to span tiles"
    assert not blk.valid[-bucket.block_e:].any(), "expected padding tiles"
    return blk


def _kernel_calls(dev, rng, blk, N, layer):
    """The four kernels' calls at one interaction layer's shapes over ``N``
    atoms and the slots of the edge blocking ``blk``, on fresh random
    inputs, at every precision, keyed by (kernel, precision): each with its
    plain version at that precision, the bytes and operations its inputs
    need (the same at every precision: the operands stay fp32), at fp32 the
    symmetric contraction's library baseline, and at bf16 and fp8 the fp32
    call on the same inputs."""
    T, bn, k = blk.n_atom_tiles, blk.block_n, CONFIG.channels
    E_p = blk.perm.shape[0]
    n_valid = int(blk.valid.sum())
    local = torch.from_numpy(blk.local_rcv).to(dev)
    valid = torch.from_numpy(blk.valid).to(dev)
    rows_needed = np.unique(
        (np.arange(E_p) // blk.epb * bn + blk.local_rcv)[blk.valid]).size

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    spec = CONFIG.symcon_spec()
    d_in, d_out, P = spec.in_spec.dim, spec.out_spec.dim, sck.p_total_of(spec)
    (fwd_bytes, fwd_ops), (bwd_bytes, bwd_ops) = _symcon_work(spec, N, k)
    kw = dict(n_tiles=T, block_n=bn)
    A_t, W_t, G_t = randn(N, d_in, k), randn(N, P, k), randn(N, d_out, k)
    tp = CONFIG.tp_spec_at(layer)
    d_sh, d_h, n_paths, d_a = tp.y_spec.dim, tp.h_spec.dim, tp.n_paths, tp.out_spec.dim
    n_ent = len(tpk.tp_entries(tp))
    Y_b, h_b, R_b = randn(E_p, d_sh), randn(E_p, d_h, k), randn(E_p, n_paths, k)
    G_a = randn(T * bn, d_a, k)
    slot_bytes = 4 * n_valid * (d_sh + (d_h + n_paths) * k) + 5 * E_p
    lib_fwd, lib_bwd = _symcon_library(A_t, W_t, G_t, spec)

    def at(p):
        return {
            "symcon_fwd": dict(
                run=lambda: sck.symcon_fwd(A_t, W_t, spec, p),
                plain=lambda: sck.symcon_plain(A_t, W_t, spec, p),
                library=lib_fwd, bytes=fwd_bytes, ops=fwd_ops),
            "symcon_bwd": dict(
                run=lambda: sck.symcon_bwd(A_t, W_t, G_t, spec, p),
                plain=lambda: sck.symcon_bwd_plain(A_t, W_t, G_t, spec, p),
                library=lib_bwd, bytes=bwd_bytes, ops=bwd_ops),
            "tp_scatter_fwd": dict(
                run=lambda: tpk.tp_scatter(Y_b, h_b, R_b, local, valid, tp, **kw,
                                           precision=p),
                plain=lambda: tpk.tp_scatter_plain(Y_b, h_b, R_b, local, valid, tp, **kw,
                                                   precision=p),
                bytes=slot_bytes + 4 * T * bn * d_a * k, ops=4 * n_valid * k * n_ent),
            "tp_gather_bwd": dict(
                run=lambda: tpk.tp_gather_bwd(G_a, Y_b, h_b, R_b, local, valid, tp, **kw,
                                              precision=p),
                plain=lambda: tpk.tp_gather_bwd_plain(
                    G_a, Y_b, h_b, R_b, local, valid, tp, **kw, precision=p),
                bytes=(slot_bytes + 4 * rows_needed * d_a * k
                       + 4 * E_p * (d_sh + (d_h + n_paths) * k)),
                ops=11 * n_valid * k * n_ent),
        }

    fp32 = at("fp32")
    calls = {(name, "fp32"): c for name, c in fp32.items()}
    for p in PRECISIONS[1:]:
        for name, c in at(p).items():
            c.pop("library", None)  # symcon_ref computes the fp32 function
            calls[(name, p)] = dict(c, fp32=fp32[name]["run"])
    return calls


def check_kernels(dev):
    """Phase 2 at the 256-atom bucket, both layers, every precision: rows
    summed over the layers' calls, as one forward makes them; keyed by
    (kernel, precision)."""
    rng = np.random.default_rng(SEED)
    bucket = bucket_ladder(CAPACITIES, edge_factor=EDGE_FACTOR)[-1]
    blk = _bucket_blocking(rng, bucket)
    calls = {}
    for layer in range(CONFIG.n_interactions):
        for key, c in _kernel_calls(dev, rng, blk, bucket.max_nodes, layer).items():
            calls.setdefault(key, []).append(dict(c, layer=layer))

    results = {}
    for (name, p), cs in calls.items():
        rows = [_check_call(name, f"layer {c['layer']} {p}", c) for c in cs]
        results[(name, p)] = _summed(rows)
    return results


def _summed(rows):
    """One kernel's rows (its calls of one forward) summed: times, the bound
    of their summed work, the largest error."""
    bound, bound_by = _bound_ms(sum(r["bytes"] for r in rows), sum(r["ops"] for r in rows))
    library = [r["library_ms"] for r in rows]
    return dict(rows=rows, max_abs_err=max(r["err"] for r in rows),
                ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=bound, bound_by=bound_by,
                library_ms=None if None in library else sum(library))


def _check_call(name, where, c):
    """One kernel call against its plain version (and against the library
    baseline, where the call has one), two launches bit-identical, and the
    CUDA-event times per call of all three."""
    got, want = c["run"](), c["plain"]()
    torch.cuda.synchronize()
    err, scale, ok = _compare(got, want)
    again = c["run"]()  # every kernel sums in a fixed order
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(
        got if isinstance(got, tuple) else (got,),
        again if isinstance(again, tuple) else (again,)))
    print(f"kernel {name} {where}: two launches bit-identical={same}", flush=True)
    if not same:
        raise AssertionError(f"kernel {name} {where} is not deterministic")
    if "fp32" in c:  # a reduced precision must change the result
        ref = c["fp32"]()
        if all(torch.equal(a, b) for a, b in zip(
                got if isinstance(got, tuple) else (got,),
                ref if isinstance(ref, tuple) else (ref,))):
            raise AssertionError(f"kernel {name} {where} returned the fp32 kernel's "
                                 "outputs bit for bit")
    ms = _time_ms(c["run"], reps=20)
    plain_ms = _time_ms(c["plain"], reps=3)
    bound, bound_by = _bound_ms(c["bytes"], c["ops"])
    library_ms, library = None, ""
    if "library" in c:
        call, layout = c["library"]
        lib_err, _, lib_ok = _compare(got, layout(call()))
        if not lib_ok:
            raise AssertionError(f"symcon_ref disagrees with kernel {name} {where}: "
                                 f"{lib_err:.3e}")
        library_ms = _time_ms(call, reps=5)
        library = f" library_ms={library_ms:.4f} library_abs_err={lib_err:.3e}"
    print(f"kernel {name} {where}: max_abs_err={err:.3e} "
          f"max_rel_err={err / max(scale, 1e-30):.3e} "
          f"tol={KERNEL_TOL:g}*max(1,{scale:.3g}) ok={ok} "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound:.4f} ({bound_by}){library}", flush=True)
    if not ok:
        raise AssertionError(f"kernel {name} {where} disagrees with its plain "
                             f"version: {err:.3e}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound=bound, library_ms=library_ms,
                bytes=c["bytes"], ops=c["ops"], run=c["run"], where=where)


def check_training_size(dev, blk):
    """The four kernels at the training capacity (3,072 atoms), on the edge
    blocking of the training run's first bin, at every precision, checked
    and timed as in ``check_kernels``: the interaction kernels at both
    layers, the symmetric contraction (one spec for both layers) at one.  At
    this size launch latency no longer hides the bound."""
    rng = np.random.default_rng(SEED + 1)
    out = {}
    for layer in range(CONFIG.n_interactions):
        for (name, p), c in _kernel_calls(dev, rng, blk, TRAIN_ATOMS, layer).items():
            if layer == 0 or name.startswith("tp_"):
                out.setdefault((name, p), []).append(_check_call(
                    name, f"N={TRAIN_ATOMS} layer {layer} {p}", c))
    return out


def _identity_calls(dev, rng, E, layer):
    """The interaction kernels as ``tp_cuda`` launches them, over ``E``
    random edges of one layer: the identity blocking of
    ``tp_ops._identity_operands`` (a tile per 128 edges, each edge its own
    row, every slot valid), fp32."""
    k, tp = CONFIG.channels, CONFIG.tp_spec_at(layer)
    d_sh, d_h, n_paths, d_out = tpk.spec_dims(tp)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    operands, tiles = tp_ops._identity_operands(
        randn(E, d_sh), randn(E, k, d_h), randn(E, n_paths, k))
    E_p = operands[0].shape[0]
    G_t = randn(E_p, d_out, k)
    n_ent = len(tpk.tp_entries(tp))
    slot_bytes = 4 * E_p * (d_sh + (d_h + n_paths) * k) + 5 * E_p
    return {
        "tp_scatter_fwd": dict(
            run=lambda: tpk.tp_scatter(*operands, tp, **tiles),
            plain=lambda: tpk.tp_scatter_plain(*operands, tp, **tiles),
            bytes=slot_bytes + 4 * E_p * d_out * k, ops=4 * E_p * k * n_ent),
        "tp_gather_bwd": dict(
            run=lambda: tpk.tp_gather_bwd(G_t, *operands, tp, **tiles),
            plain=lambda: tpk.tp_gather_bwd_plain(G_t, *operands, tp, **tiles),
            bytes=slot_bytes + 4 * E_p * d_out * k + 4 * E_p * (d_sh + (d_h + n_paths) * k),
            ops=11 * E_p * k * n_ent),
    }


def check_identity_launch(dev, E):
    """The identity-blocked launch of ``tp_cuda`` (the TP-only op and the
    unblocked interaction) on ``E`` edges, the training bin's padded edge
    count, both layers, fp32, checked and timed as in ``check_kernels``."""
    rng = np.random.default_rng(SEED + 3)
    out = {}
    for layer in range(CONFIG.n_interactions):
        for name, c in _identity_calls(dev, rng, E, layer).items():
            out.setdefault(name, []).append(_check_call(
                name, f"identity E={E} layer {layer}", c))
    return out


def check_rounding(dev):
    """``round_op`` of each precision's symmetric-contraction build (the
    rounding every bf16 and fp8 kernel applies to its loads) against the
    plain ``round_to``, bit for bit, on ``ROUND_TABLE`` and
    ``ROUND_RANDOM`` random values."""
    rng = np.random.default_rng(SEED + 4)
    x = np.concatenate([np.asarray(ROUND_TABLE, np.float32), (
        rng.standard_normal(ROUND_RANDOM) * np.exp(rng.uniform(-14, 8, ROUND_RANDOM))
    ).astype(np.float32)])
    for p in PRECISIONS:
        got = sck.round_on_card(torch.from_numpy(x).to(dev), CONFIG.symcon_spec(), p)
        got = got.cpu().numpy().view(np.uint32)
        want = round_to(torch.from_numpy(x), p).numpy().view(np.uint32)
        bad = np.nonzero(got != want)[0]
        print(f"rounding {p}: {x.size} values, {bad.size} differ from round_to "
              f"(table: {[hex(v) for v in got[:len(ROUND_TABLE)]]})", flush=True)
        if bad.size:
            raise AssertionError(f"round_op at {p} differs from round_to at "
                                 f"{[(float(x[i]), hex(got[i]), hex(want[i])) for i in bad[:8]]}")


def time_kernels(results, training) -> None:
    """Each kernel's own device time per launch (``torch.profiler``) on
    phase 2's inputs, with its share of the bound per layer, and at the
    training capacity (``training``: rows by key, the identity-blocked
    launch's too), each launch finding its inputs outside the L2 cache.
    Run after the serving and training measurements: once the profiler has
    run in a process, later launches in it were slower (serving runs in
    PERF.md)."""
    reps = 20
    for (name, p), res in results.items():
        per_layer, recorded = [], 0
        for layer, r in enumerate(res["rows"]):
            ms, seen = _device_ms(r["run"], KERNELS[name]["symbol"], reps)
            print(f"kernel {name} layer {layer} {p}: device_ms={ms:.4f} "
                  f"bound_ms={r['bound']:.4f} share_of_bound={r['bound'] / ms:.3f} "
                  f"launches_recorded={seen}/{reps}", flush=True)
            per_layer.append(ms)
            recorded += seen
        res.update(device_ms=sum(per_layer), per_layer_device_ms=per_layer,
                   per_layer_share_of_bound=[r["bound"] / ms
                                             for r, ms in zip(res["rows"], per_layer)],
                   device_launches_recorded=recorded,
                   device_launches_made=reps * len(per_layer))
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    for key, rows in training.items():
        name = key[0] if isinstance(key, tuple) else key
        for r in rows:
            ms, seen = _device_ms(r["run"], KERNELS[name]["symbol"], reps,
                                  before=lambda: flush.zero_())
            library = "" if r["library_ms"] is None else f" library_ms={r['library_ms']:.4f}"
            print(f"kernel {name} {r['where']}: "
                  f"max_abs_err={r['err']:.3e} device_ms={ms:.4f} "
                  f"bound_ms={r['bound']:.4f} share_of_bound={r['bound'] / ms:.3f} "
                  f"launches_recorded={seen}/{reps} ms={r['ms']:.4f}{library}", flush=True)
            r.update(device_ms=ms, recorded=seen)


# ---------------------------------------------------------------------------
# phases 3 and 8: serve on the card, compare with the CPU
# ---------------------------------------------------------------------------


def skewed_requests():
    """Hubs from the large tail interleaved with small molecules."""
    ds = SyntheticCFMDataset(256, seed=1, max_atoms=max(CAPACITIES))
    by_size = sorted(range(len(ds)), key=lambda i: int(ds.sizes[i]))
    hub_pool, small_pool = by_size[-32:], by_size[:128]
    rng = random.Random(SEED)
    picks = [rng.choice(hub_pool if rng.random() < 0.2 else small_pool)
             for _ in range(N_REQUESTS)]
    max_edges = max(CAPACITIES) * EDGE_FACTOR
    mols = [m for m in (ds.get(i) for i in picks) if m.n_edges <= max_edges]
    assert len(mols) == N_REQUESTS, "a request overflowed the largest bucket"
    return mols


def _check_census(server, when):
    """The JAX serve contract: one captured graph per bucket."""
    census = server.stats()["compile_census"]
    print(f"census {when}: {census}", flush=True)
    if census != {bucket_key(b): 1 for b in server.buckets}:
        raise AssertionError(f"the census {when} is {census}, not one graph per bucket")


def serve(params, mols, config=None):
    """Serve ``mols`` through a ``GraphServer`` of ``config`` (one CUDA
    graph per bucket, captured at warm-up: the census is 1 per bucket after
    warm-up and after the mix), with the launches of the run, every one of
    them on ``config.precision``'s libraries."""
    config = config or CONFIG
    cfg = ServeConfig(capacities=CAPACITIES, edge_factor=EDGE_FACTOR,
                      n_workers=2, max_wait_s=0.01)
    t0 = time.perf_counter()
    server = GraphServer(config, params, cfg)  # device None: the CUDA card
    print(f"server warm in {time.perf_counter() - t0:.2f}s "
          f"(buckets {[b.max_nodes for b in server.buckets]}; graph pool bytes "
          f"{server.engine.pool_bytes()})", flush=True)
    _check_census(server, f"after warm-up at {config.precision}")
    _reset_launches()
    futures = []
    for m in mols:
        futures.append(server.submit(m, timeout=60.0))
        time.sleep(0.001)  # a trickle, so waves form and mix
    results = [f.result(timeout=600.0) for f in futures]
    torch.cuda.synchronize()
    launches = _launches()
    if _launches(config.precision) != launches:
        raise AssertionError(f"serving at {config.precision} launched "
                             f"{_launches(config.precision)} of its {launches} launches "
                             "on its own libraries")
    stats = server.stats()
    _check_census(server, f"after the mix at {config.precision}")
    server.close()
    for m, r in zip(mols, results):
        assert np.isfinite(r.energy), "non-finite energy"
        assert r.forces.shape == (m.n_atoms, 3) and np.isfinite(r.forces).all()
    assert stats["served"] == len(mols) and stats["failed"] == 0, stats
    return results, stats, launches, server.buckets


def _bin_for(bucket, mols):
    """As many of ``mols`` as fit ``bucket``, in order."""
    picked, n, e = [], 0, 0
    for m in mols:
        if (n + m.n_atoms <= bucket.max_nodes and e + m.n_edges <= bucket.max_edges
                and len(picked) < bucket.max_graphs):
            picked.append(m)
            n, e = n + m.n_atoms, e + m.n_edges
    return picked


def _wall_ms(fn, reps: int) -> float:
    """Mean host milliseconds per call, each call waited for, after a
    warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def check_graphs(params, mols, buckets):
    """Each bucket's captured graph against the eager ``mace_energy_forces``
    on one real bin of the served molecules: the replay within
    ``KERNEL_TOL`` of the largest magnitude, each kernel launched as often
    per bin through a replay as by the eager call, both timed per bin (CUDA
    events over back-to-back calls, and wall time with each call waited
    for), and each bucket's graph pool; then the engine closed and its
    memory returned.  Returns {bucket: row}."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    engine = make_serve_engine(CONFIG, params, buckets)
    census, pools = engine.compile_census(), engine.pool_bytes()
    if census != {bucket_key(b): 1 for b in buckets}:
        raise AssertionError(f"the engine's census after warm-up is {census}")
    rows = {}
    for bucket in buckets:
        picked = _bin_for(bucket, sorted(mols, key=lambda m: -m.n_atoms))
        batch, _ = engine.collate(picked, bucket)
        G = bucket.max_graphs

        def eager():
            return mace_energy_forces(engine.params, CONFIG, batch, G)

        def replay():
            return engine.forward(batch, bucket)

        _reset_launches()
        want = eager()
        torch.cuda.synchronize()
        eager_launches = _launches()
        _reset_launches()
        got = tuple(t.clone() for t in replay())
        torch.cuda.synchronize()
        replay_launches = _launches()
        err, scale, ok = _compare(got, want)
        row = dict(graphs=len(picked), atoms=sum(m.n_atoms for m in picked),
                   max_abs_err=err, eager_launches=eager_launches,
                   replay_launches=replay_launches,
                   eager_event_ms=_time_ms(eager, reps=10),
                   replay_event_ms=_time_ms(replay, reps=10),
                   eager_wall_ms=_wall_ms(eager, reps=10),
                   replay_wall_ms=_wall_ms(replay, reps=10),
                   pool_bytes=pools[bucket_key(bucket)])
        print(f"graph {bucket_key(bucket)}: {row['graphs']} graphs, {row['atoms']} atoms: "
              f"replay against eager max_abs_err={err:.3e} "
              f"(tol {KERNEL_TOL:g}*max(1,{scale:.3g})) ok={ok}; launches per bin "
              f"eager={eager_launches} replay={replay_launches}; per-bin ms eager "
              f"{row['eager_event_ms']:.3f} (events) {row['eager_wall_ms']:.3f} (wall), "
              f"replay {row['replay_event_ms']:.3f} (events) {row['replay_wall_ms']:.3f} "
              f"(wall); graph pool {row['pool_bytes'] / 2**20:.1f} MiB", flush=True)
        if not ok:
            raise AssertionError(f"the graph of {bucket_key(bucket)} disagrees with the "
                                 "eager forward")
        if replay_launches != eager_launches or any(n <= 0 for n in eager_launches.values()):
            raise AssertionError(f"a replay of {bucket_key(bucket)} launched "
                                 f"{replay_launches}, the eager call {eager_launches}")
        rows[bucket_key(bucket)] = row
    if engine.compile_census() != census:
        raise AssertionError(f"the census moved to {engine.compile_census()}")
    held = torch.cuda.memory_reserved()
    engine.close()
    freed = held - torch.cuda.memory_reserved()
    print(f"graph engine closed: {freed / 2**20:.1f} MiB of device memory returned "
          f"(pools {sum(pools.values()) / 2**20:.1f} MiB)", flush=True)
    if freed < sum(pools.values()):
        raise AssertionError("closing the engine did not return its graph pools")
    return rows


SERVE_DRILLS = {
    "kill_worker": (["--kill-worker"], {}),
    "fault_plan": ([], {"REPRO_FAULT_PLAN": json.dumps({"serve_worker_fault": {}})}),
}
SERVE_DRILL_TIMEOUT_S = 600


def serve_drills():
    """``python -m repro_torch.launch.serve_mace --config paper
    --interaction-impl cuda`` as a child process, with ``--kill-worker`` and
    then with ``REPRO_FAULT_PLAN``: each
    exits 0 with every request served, after a drain-and-rebuild, with one
    graph per bucket in the rebuilt engine.  Returns {drill: its summary}."""
    root = Path(__file__).resolve().parent
    out = {}
    for name, (flags, env) in SERVE_DRILLS.items():
        cmd = [sys.executable, "-m", "repro_torch.launch.serve_mace", "--config", "paper",
               "--interaction-impl", "cuda", *flags]
        t0 = time.perf_counter()
        proc = subprocess.run(
            cmd, cwd=root, capture_output=True, text=True, timeout=SERVE_DRILL_TIMEOUT_S,
            env=dict(os.environ, PYTHONPATH=str(root / "src"), **env))
        seconds = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            print(f"drill {name}: {line}")
        summary = next((json.loads(line[len("summary "):])
                        for line in proc.stdout.splitlines() if line.startswith("summary ")),
                       None)
        if proc.returncode != 0 or summary is None:
            raise AssertionError(f"drill {name} exited {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
        census = summary["compile_census"]
        if (summary["served"] != summary["requests"] or summary["failed"]
                or summary["rebuilds"] < 1 or not census
                or any(v != 1 for v in census.values())):
            raise AssertionError(f"drill {name}: {summary}")
        print(f"drill {name}: exit 0 in {seconds:.1f}s, {summary['served']} served, "
              f"{summary['rebuilds']} rebuild(s), census {census}", flush=True)
        out[name] = dict(summary, seconds=seconds)
    return out


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def _kernel_events(prof):
    """The device kernels of a profile, by name: the operators that launch
    them carry the same device time and are left out, so sums count each
    kernel once."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0]


def profile_serving(params, mols):
    """Serve the same requests again, through the graphs, under
    ``torch.profiler``: the share of the wall time the card is busy, on
    which operations, and each kernel's launches recorded by the profiler
    beside those made (counted through the replays).  A reading that
    records fewer than ``MIN_RECORDED`` of any kernel's launches is taken
    again, twice at most, and then fails.  Returns {kernel: (recorded,
    made)}."""
    from torch.profiler import ProfilerActivity, profile

    cfg = ServeConfig(capacities=CAPACITIES, edge_factor=EDGE_FACTOR,
                      n_workers=2, max_wait_s=0.01)
    server = GraphServer(CONFIG, params, cfg)
    try:
        for _ in range(3):
            bins_before = sum(server.stats()["bucket_bins"].values())
            _reset_launches()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                futures = [server.submit(m, timeout=60.0) for m in mols]
                for f in futures:
                    f.result(timeout=600.0)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            made = _launches()
            bins = sum(server.stats()["bucket_bins"].values()) - bins_before
            events = _kernel_events(prof)
            busy_ms = sum(_device_us(e) for e in events) / 1e3
            print(f"profile: {len(mols)} graphs in {bins} bins, wall_ms={wall_ms:.1f} "
                  f"device_busy_ms={busy_ms:.1f} "
                  f"device_idle_share={1 - busy_ms / wall_ms:.3f} "
                  f"device_ops={sum(e.count for e in events)}", flush=True)
            for e in sorted(events, key=_device_us, reverse=True)[:8]:
                print(f"profile top: {_device_us(e) / 1e3:9.3f} ms x{e.count:<5d} "
                      f"{e.key[:90]}")
            counts = {}
            for name, spec in KERNELS.items():
                mine = [e for e in events if spec["symbol"] in e.key]
                counts[name] = (sum(e.count for e in mine), made[name])
                print(f"profile kernel {name}: {sum(map(_device_us, mine)) / 1e3:.3f} ms "
                      f"launches_recorded={counts[name][0]}/{made[name]}", flush=True)
            if all(seen >= MIN_RECORDED * n and n > 0 for seen, n in counts.values()):
                return counts
            print("profile: the profiler recorded too few launches; measuring again",
                  flush=True)
        raise AssertionError(f"the serving profile recorded launches {counts} "
                             "(recorded, made)")
    finally:
        server.close()


def compare_with_cpu(params, mols, results, buckets):
    engine = ServeEngine(CONFIG, params, buckets, device="cpu")
    order = sorted(range(len(mols)), key=lambda i: mols[i].n_atoms)
    worst = 0.0
    for i in (order[0], order[len(order) // 2], order[-1]):
        m, r = mols[i], results[i]
        bucket = select_bucket(buckets, m.n_atoms, m.n_edges, 1)
        batch, _ = engine.collate([m], bucket)
        e, f = engine.forward(batch, bucket)
        e_cpu, f_cpu = float(e[0]), f[: m.n_atoms].numpy()
        de = abs(r.energy - e_cpu) / max(abs(e_cpu), 1e-6)
        df = float(np.abs(r.forces - f_cpu).max()) / max(float(np.abs(f_cpu).max()), 1e-6)
        print(f"cpu compare: {m.n_atoms} atoms E_gpu={r.energy:.6f} E_cpu={e_cpu:.6f} "
              f"rel_err_E={de:.2e} rel_err_F={df:.2e} (tol {SERVE_RTOL:g})", flush=True)
        if de > SERVE_RTOL or df > SERVE_RTOL:
            raise AssertionError(f"GPU and CPU disagree on a {m.n_atoms}-atom molecule")
        worst = max(worst, de, df)
    engine.close()
    return worst


# ---------------------------------------------------------------------------
# phase 4: training on the card
# ---------------------------------------------------------------------------


def _launches(precision=None):
    """Each kernel's launches since the last reset: all of them, or those
    of ``precision``'s libraries."""
    if precision is None:
        return {name: spec["kernel"].launches for name, spec in KERNELS.items()}
    tag = cuda_lib.precision_define(precision)
    return {name: sum(n for header, n in spec["kernel"].launches_by_header.items()
                      if tag in header)
            for name, spec in KERNELS.items()}


def _reset_launches():
    for spec in KERNELS.values():
        spec["kernel"].reset()


def _trainer(capacity, device, params=None, ckpt_dir=None, config=None, **overrides):
    """``examples/train_mace_cfm.py``'s trainer at the paper's width: the
    balanced sampler over ``SyntheticCFMDataset(2000, seed=0,
    max_atoms=256)``, one rank, prefetch 1, ``max_graphs = capacity // 8``;
    random weights from ``SEED`` unless ``params`` are given; ``overrides``
    are ``TrainerConfig`` fields (the kernel selection, the engine and its
    ranks, the tile geometry)."""
    tcfg = TrainerConfig(capacity=capacity, edge_factor=EDGE_FACTOR,
                         max_graphs=max(16, capacity // 8), prefetch=1,
                         ckpt_dir=ckpt_dir, ckpt_every=0, **overrides)
    dataset = SyntheticCFMDataset(TRAIN_GRAPHS, seed=SEED, max_atoms=max(CAPACITIES))
    return Trainer(config or CONFIG, tcfg, dataset, seed=SEED, params=params, device=device)


def first_bin_blocking(tr):
    """The edge blocking of the training run's first bin (the shapes the
    training path gives the interaction kernels)."""
    rank_bins = next(tr.sampler.step_iter(tr.sampler_state))
    (batch,), _ = tr.engine.collate([[tr.dataset.get(i) for i in rank_bins[0]]],
                                    tr.bin_shape)
    blk = blocking_from_batch(batch)
    return EdgeBlocking(blk["perm"], blk["valid"], blk["local"], blk["base"],
                        tr.bin_shape.block_n, blk["perm"].shape[0] // blk["base"].shape[0])


def train_steps(tr):
    """``TRAIN_STEPS`` steps of ``Trainer.train`` on the card, each engine
    step timed by CUDA events with the kernel launches it made; every count
    is set to 0 just before the run and read just after."""
    rows, engine_step = [], tr.engine.step

    def timed_step(params, opt_state, ef_state, batches, step):
        before = _launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = engine_step(params, opt_state, ef_state, batches, step)
        end.record()
        torch.cuda.synchronize()
        after = _launches()
        rows.append(dict(ms=start.elapsed_time(end),
                         atoms=sum(float(b["node_mask"].sum()) for b in batches),
                         launches={k: after[k] - before[k] for k in after}))
        return out

    tr.engine.step = timed_step
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    hist = tr.train(n_epochs=1, max_steps=TRAIN_STEPS)["history"]
    torch.cuda.synchronize()
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    tr.engine.step = engine_step
    for i, (h, r) in enumerate(zip(hist, rows)):
        print(f"train step {i}: loss={h['loss']:.6f} e_rmse={h['e_rmse']:.6f} "
              f"f_rmse={h['f_rmse']:.6f} step_ms={r['ms']:.2f} atoms={r['atoms']:.0f} "
              f"atoms_per_s={r['atoms'] / r['ms'] * 1e3:.1f} launches={r['launches']}",
              flush=True)
    print(f"train: {len(hist)} steps at capacity {TRAIN_ATOMS}, "
          f"peak_memory_allocated_gb={peak / 2**30:.2f} (of which "
          f"{held / 2**30:.2f} held before the run: the parameters and phase 2's "
          f"inputs) launches={launches}", flush=True)
    if len(hist) != TRAIN_STEPS or not all(np.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"training did not take {TRAIN_STEPS} finite steps: {hist}")
    for r in rows:
        if r["launches"] != PER_BIN:
            raise AssertionError(f"a training step launched {r['launches']}, "
                                 f"expected {PER_BIN} for its one bin")
    return dict(history=hist, rows=rows, launches=launches, peak_bytes=peak)


# ---------------------------------------------------------------------------
# phase 5: the variants: precisions, the unblocked path, the other impls, the fused
# backward
# ---------------------------------------------------------------------------


def _l2_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def serve_at_precisions(params, mols, fp32_results):
    """Serve the same molecules at bf16 and at fp8: energies and forces
    finite, within ``PRECISION_TOL`` (L2 norm-relative over all of them) of
    the fp32 run's, not bitwise equal to them, every kernel launched on
    that precision's libraries.  Returns {precision: launches}."""
    e32 = np.array([r.energy for r in fp32_results])
    f32 = np.concatenate([r.forces.ravel() for r in fp32_results])
    out = {}
    for p in PRECISIONS[1:]:
        results, stats, launches, _ = serve(params, mols, dataclasses.replace(CONFIG, precision=p))
        e = np.array([r.energy for r in results])
        f = np.concatenate([r.forces.ravel() for r in results])
        err_e, err_f = _l2_rel(e, e32), _l2_rel(f, f32)
        same = np.array_equal(e, e32) and np.array_equal(f, f32)
        print(f"serve {p}: {stats['served']} graphs graphs_per_s={stats['graphs_per_s']:.2f} "
              f"energies L2-rel {err_e:.3e}, forces L2-rel {err_f:.3e} against fp32 "
              f"(tol {PRECISION_TOL[p]:g}); bitwise equal to fp32={same}; "
              f"launches={launches}", flush=True)
        if max(err_e, err_f) > PRECISION_TOL[p] or same:
            raise AssertionError(f"serving at {p} is not within its tolerance of fp32, "
                                 "or is fp32 bit for bit")
        missing = [name for name, n in launches.items() if n <= 0]
        if missing:
            raise AssertionError(f"serving at {p} launched no {missing}")
        out[p] = launches
    return out


def check_paths_and_impls(dev, params, mols, bucket):
    """One 256-atom bin of the served molecules through
    ``mace_energy_forces``: collated without the ``blk_*`` arrays (the
    unblocked path: the interaction kernels under the identity blocking)
    against the blocked path, and the blocked bin with the ``fused`` and
    ``ref`` impls (every kind) against ``cuda``, all at fp32, within the
    kernel tolerance of the largest magnitude.  Returns the unblocked run's
    launches."""
    picked = _bin_for(bucket, mols)
    n, e = sum(m.n_atoms for m in picked), sum(m.n_edges for m in picked)
    dev_params = params_to(params, dev)
    batches = {blocked: {k: torch.from_numpy(v).to(dev) for k, v in collate_bin(
        picked, bucket, strict=True, with_blocking=blocked).items()}
        for blocked in (True, False)}
    G = bucket.max_graphs
    e_b, f_b = mace_energy_forces(dev_params, CONFIG, batches[True], G)
    _reset_launches()
    e_u, f_u = mace_energy_forces(dev_params, CONFIG, batches[False], G)
    torch.cuda.synchronize()
    launches = _launches()
    runs = {"unblocked": (e_u, f_u, launches)}
    for impl in ("fused", "ref"):
        cfg = dataclasses.replace(CONFIG, impl=impl, interaction_impl=impl)
        _reset_launches()
        e_i, f_i = mace_energy_forces(dev_params, cfg, batches[True], G)
        torch.cuda.synchronize()
        runs[impl] = (e_i, f_i, _launches())
    for what, (e_x, f_x, made) in runs.items():
        err, scale, ok = _compare((e_x, f_x), (e_b, f_b))
        print(f"paths: {len(picked)} graphs, {n} atoms, {e} edges: {what} against the "
              f"blocked cuda path max_abs_err={err:.3e} (tol {KERNEL_TOL:g}*max(1,{scale:.3g})) "
              f"ok={ok} launches={made}", flush=True)
        if not ok:
            raise AssertionError(f"the {what} path disagrees with the blocked cuda path")
    if any(v <= 0 for v in launches.values()):
        raise AssertionError(f"the unblocked path launched {launches}")
    if any(n for impl in ("fused", "ref") for n in runs[impl][2].values()):
        raise AssertionError("the fused or ref impl launched a kernel")
    return launches


def _train_variant(what, tr, steps, per_bin, precision="fp32"):
    """``steps`` steps of a trainer; every loss finite, each kernel launched
    ``per_bin`` times a step on ``precision``'s libraries and nowhere else."""
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    hist = tr.train(n_epochs=1, max_steps=steps)["history"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, own = _launches(), _launches(precision)
    losses = [h["loss"] for h in hist]
    print(f"train {what}: {len(hist)} steps in {wall:.1f}s, losses={losses}, "
          f"peak_memory_allocated_gb={torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"(held before the run {held / 2**30:.2f}) launches={launches}", flush=True)
    want = {k: steps * v for k, v in per_bin.items()}
    if len(hist) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"train {what} did not take {steps} finite steps")
    if own != want or launches != want:
        raise AssertionError(f"train {what} launched {launches} ({own} at {precision}), "
                             f"expected {want}")
    return np.asarray(losses), own


def train_variants(fp32_history):
    """``VARIANT_STEPS`` training steps at bf16 (capacity 3,072, the same
    parameters and bins as the fp32 run's first steps): losses finite,
    within ``PRECISION_TOL["bf16"]`` relative of the fp32 losses and not
    equal to them.  Then ``VARIANT_STEPS`` fp32 steps with the fused
    interaction backward against ``bwd_impl="cuda"`` at
    ``FUSED_BWD_CAPACITY``, from the same parameters and bins: losses
    within ``FUSED_BWD_LOSS_RTOL``.  Returns the bf16 run's launches."""
    l16, launches = _train_variant("bf16", _trainer(TRAIN_ATOMS, None, precision="bf16"),
                                   VARIANT_STEPS, PER_BIN, "bf16")
    l32 = np.asarray([h["loss"] for h in fp32_history[:VARIANT_STEPS]])
    drift = np.abs(l16 - l32) / np.abs(l32)
    print(f"train bf16 against fp32 losses {l32.tolist()}: relative drift {drift.tolist()} "
          f"(tol {PRECISION_TOL['bf16']:g})", flush=True)
    if drift.max() > PRECISION_TOL["bf16"] or drift.max() == 0.0:
        raise AssertionError("bf16 training is not within its tolerance of fp32, or equal to it")
    lc, _ = _train_variant(f"fp32 bwd_impl=cuda at capacity {FUSED_BWD_CAPACITY}",
                           _trainer(FUSED_BWD_CAPACITY, None), VARIANT_STEPS, PER_BIN)
    lf, _ = _train_variant(f"fp32 bwd_impl=fused at capacity {FUSED_BWD_CAPACITY}",
                           _trainer(FUSED_BWD_CAPACITY, None, interaction_bwd_impl="fused"),
                           VARIANT_STEPS, FUSED_BWD_PER_BIN)
    err = float((np.abs(lf - lc) / np.abs(lc)).max())
    print(f"train bwd_impl=fused against cuda: max relative loss difference {err:.3e} "
          f"(tol {FUSED_BWD_LOSS_RTOL:g})", flush=True)
    if err > FUSED_BWD_LOSS_RTOL:
        raise AssertionError("the fused backward's losses differ from the cuda backward's")
    return launches


def profile_train_step(tr, step_ms):
    """One more training step under ``torch.profiler``: the card's busy and
    idle share of the step's wall time, its device operations by time, and
    each kernel's device time in the step beside its launches recorded and
    made.  The profiler's own host work stretches the profiled step, so its
    busy time is also set against ``step_ms``, the CUDA-event times of the
    unprofiled steps after the first."""
    from torch.profiler import ProfilerActivity, profile

    before = _launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train(n_epochs=1, max_steps=tr.global_step + 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    made = {k: v - before[k] for k, v in _launches().items()}
    events = _kernel_events(prof)
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    if busy_ms == 0:
        raise AssertionError("the profiler saw no device time in the training step")
    print(f"train profile: one step, wall_ms={wall_ms:.1f} device_busy_ms={busy_ms:.1f} "
          f"device_idle_share={1 - busy_ms / wall_ms:.3f} "
          f"device_ops={sum(e.count for e in events)}", flush=True)
    print(f"train profile: device busy against the unprofiled steps 2-{len(step_ms)} "
          f"(CUDA events, {min(step_ms[1:]):.1f}-{max(step_ms[1:]):.1f} ms): idle share "
          f"{1 - busy_ms / min(step_ms[1:]):.3f}-{1 - busy_ms / max(step_ms[1:]):.3f}",
          flush=True)
    for e in sorted(events, key=_device_us, reverse=True)[:12]:
        print(f"train profile top: {_device_us(e) / 1e3:9.3f} ms x{e.count:<5d} {e.key[:90]}")
    out = {}
    for name, spec in KERNELS.items():
        mine = [e for e in events if spec["symbol"] in e.key]
        ms, seen = sum(map(_device_us, mine)) / 1e3, sum(e.count for e in mine)
        print(f"train profile kernel {name}: device_ms={ms:.4f} "
              f"launches_recorded={seen}/{made[name]}", flush=True)
        if seen < MIN_RECORDED * made[name]:
            raise AssertionError(f"the profiler recorded {seen} of {made[name]} "
                                 f"launches of {name}")
        out[name] = dict(device_ms=ms, recorded=seen, made=made[name])
    return out


def checkpoint_round_trip(tr):
    """Save after the last step, restore into a fresh trainer: parameters,
    optimizer state and EMA bit-identical."""
    ckpt_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    tr.tcfg.ckpt_dir = str(ckpt_dir)
    tr.save()
    fresh = _trainer(TRAIN_ATOMS, None, ckpt_dir=str(ckpt_dir))
    if not fresh.maybe_restore() or fresh.global_step != tr.global_step:
        raise AssertionError("the checkpoint did not restore")
    want, got = flatten_state(tr._state()), flatten_state(fresh._state())
    same = want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want)
    print(f"checkpoint: step {fresh.global_step}, {len(want)} arrays restored "
          f"bit-identical={same}", flush=True)
    if not same:
        raise AssertionError("the restored state differs from the saved one")
    shutil.rmtree(ckpt_dir, ignore_errors=True)


def _beyond(got, want, held):
    """(elements of ``got`` beyond rtol / atol of ``want``, of how many,
    the largest excess and where), over the elements of flat {path: tensor}
    trees that the boolean tree ``held`` selects."""
    n_over, n_all, worst = 0, 0, (-float("inf"), "", 0)
    for k, w in want.items():
        w, mask = w.cpu(), held[k].cpu()
        excess = (got[k].cpu() - w).abs() - TRAIN_PARAM_ATOL - TRAIN_PARAM_RTOL * w.abs()
        excess = excess.masked_fill(~mask, -float("inf"))
        n_over += int((excess > 0).sum())
        n_all += int(mask.sum())
        if n_all and float(excess.max()) > worst[0]:
            worst = (float(excess.max()), k, int(excess.argmax()))
    return n_over, n_all, worst


def _adam_denominator(opt_state, step):
    """{path: sqrt(v_hat)} of the AdamW state after ``step`` (0-based)."""
    (adam,) = [s for s in opt_state if isinstance(s, dict) and "v" in s]
    return {k: (v / (1 - ADAM_B2 ** (step + 1))).sqrt()
            for k, v in flatten_state(adam["v"]).items()}


def compare_training_with_cpu():
    """``CPU_STEPS`` steps at capacity ``CPU_CAPACITY`` on the CPU (plain
    versions) and on the card, from the same parameters over the same bins.
    Each step is checked in its two parts, from the CPU's state before it:
    the loss and its parameter gradients on the card against the CPU's
    (loss rtol 5e-4; gradients within the reference's bound, 2e-4 of each
    leaf's largest magnitude, tests/test_backward.py), and the optimizer
    update on the card from the CPU's gradients against the CPU's update
    (parameters within rtol 2e-3 / atol 2e-5, tests/test_engine.py:493).
    Then the card's own 3-step trajectory: its losses within rtol 5e-4 of
    the CPU's, and its final parameters within rtol 2e-3 / atol 2e-5 of the
    CPU's wherever Adam is well conditioned, that is where the CPU's
    denominator sqrt(v_hat) was, at every step, either 0 (no gradient yet:
    a species the bins do not hold) or above ``ADAM_HELD_EPS`` eps.  Adam
    maps a gradient g to about ``lr * g / (|g| + eps)``, so where |g| is
    near eps float32 rounding in g moves a parameter by more than 2e-5
    (PERF.md); the elements in between are counted, and those of them
    beyond the bound reported."""
    params = init_mace(CONFIG, torch.Generator().manual_seed(SEED + 2))
    cpu = _trainer(CPU_CAPACITY, "cpu", params=params)
    card = _trainer(CPU_CAPACITY, "cuda", params=params)
    to_card = lambda tree: opt_tree_map(lambda t: t.to(card.device), tree)  # noqa: E731
    everywhere = {k: torch.ones_like(v, dtype=torch.bool)
                  for k, v in flatten_state(params).items()}
    p, o, losses, held = cpu.params, cpu.opt_state, [], everywhere
    t0 = time.perf_counter()
    for step, rank_bins in enumerate(itertools.islice(
            cpu.sampler.step_iter(cpu.sampler_state), CPU_STEPS)):
        host, _ = cpu.engine.collate(
            [[cpu.dataset.get(i) for i in b] for b in rank_bins], cpu.bin_shape)
        gc, mc = cpu.engine.grads(p, cpu.engine.to_device(host)[0])
        gg, mg = card.engine.grads(to_card(p), card.engine.to_device(host)[0])
        losses.append(float(mc["loss"]))
        loss_err = abs(float(mg["loss"]) - losses[-1]) / abs(losses[-1])
        grad_err, grad_key = max((float((gg[k].cpu() - gc[k]).abs().max())
                                  / max(float(gc[k].abs().max()), 1e-30), k) for k in gc)
        gc = unflatten(gc)
        upd_c, o_next = cpu.optimizer.update(gc, o, p, step)
        upd_g, _ = card.optimizer.update(to_card(gc), to_card(o), to_card(p), step)
        p_next = apply_updates(p, upd_c)
        n_over, n_all, worst = _beyond(flatten_state(apply_updates(to_card(p), upd_g)),
                                       flatten_state(p_next), everywhere)
        print(f"train cpu compare: step {step} from the CPU's state: loss cpu "
              f"{losses[-1]:.7f} card {float(mg['loss']):.7f} (rel {loss_err:.2e}, tol "
              f"{TRAIN_LOSS_RTOL:g}); gradients max leaf-relative diff {grad_err:.3e} "
              f"({grad_key}; tol 2e-4); update from the CPU's gradients: {n_over} of "
              f"{n_all} parameters beyond rtol {TRAIN_PARAM_RTOL:g} / atol "
              f"{TRAIN_PARAM_ATOL:g} (worst excess {worst[0]:.3e})", flush=True)
        if loss_err > TRAIN_LOSS_RTOL or grad_err > 2e-4 or n_over:
            raise AssertionError(f"training step {step} on the card differs from the CPU's")
        denom = _adam_denominator(o_next, step)
        held = {k: held[k] & ((denom[k] == 0) | (denom[k] > ADAM_HELD_EPS * ADAM_EPS))
                for k in held}
        p, o = p_next, o_next
    print(f"train cpu compare: cpu losses={losses} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    tr = _trainer(CPU_CAPACITY, "cuda", params=params)
    hist = tr.train(n_epochs=1, max_steps=CPU_STEPS)["history"]
    loss_err = max(abs(h["loss"] - c) / abs(c) for h, c in zip(hist, losses))
    final, want = flatten_state(tr.params), flatten_state(p)
    n_over, n_held, worst = _beyond(final, want, held)
    n_zero = sum(int((d == 0).sum()) for d in _adam_denominator(o, CPU_STEPS - 1).values())
    r_over, r_all, r_worst = _beyond(final, want, {k: ~m for k, m in held.items()})
    print(f"train cpu compare: card losses={[h['loss'] for h in hist]} "
          f"max_rel_loss_err={loss_err:.3e} (tol {TRAIN_LOSS_RTOL:g}); final params, "
          f"held where the CPU's Adam denominator stayed 0 or above {ADAM_HELD_EPS:g} eps "
          f"({n_zero} of them with no gradient): "
          f"{n_over} of {n_held} beyond rtol {TRAIN_PARAM_RTOL:g} / atol "
          f"{TRAIN_PARAM_ATOL:g} (worst excess {worst[0]:.3e} at {worst[1]}[{worst[2]}]); "
          f"the other {r_all} (reported): {r_over} beyond, worst excess "
          f"{r_worst[0]:.3e} at {r_worst[1]}[{r_worst[2]}]", flush=True)
    if len(hist) != CPU_STEPS or loss_err > TRAIN_LOSS_RTOL:
        raise AssertionError("the card's loss trajectory differs from the CPU's")
    if n_over:
        raise AssertionError("the card's free-running parameters differ from the CPU's "
                             "where Adam is well conditioned")



# ---------------------------------------------------------------------------
# phase 9: data parallelism, one process per rank
# ---------------------------------------------------------------------------


def _oracle_step(oracle, n_nodes, state, local, out, step):
    """Rank 0 of a distributed run, after it: the sequential oracle's
    reduction and update (``SequentialEngine.finalize``) on every rank's
    gradients, metrics and residuals of one step, from that step's own
    state, against the engine's result: its parameters and optimizer
    state, and every rank's new residual.  Every rank takes part in the gathers;
    returns ``(elements beyond the bound, bit-identical, all)`` on rank 0,
    else None."""
    rank, R = dist.get_rank(), dist.get_world_size()
    (grads, metrics), ef_state = local, state[2]

    def gather(tree):
        """Every rank's flat {path: tensor} of ``tree``, on rank 0."""
        flat = flatten_state(tree)
        mine = torch.cat([v.reshape(-1) for v in flat.values()]).cpu()
        rows = [torch.empty_like(mine) for _ in range(R)] if rank == 0 else None
        dist.gather(mine, rows, dst=0)
        trees = []
        for row in rows or []:
            row, at, tree_r = row.to(oracle.device), 0, {}
            for k, v in flat.items():
                tree_r[k] = row[at:at + v.numel()].view_as(v)
                at += v.numel()
            trees.append(tree_r)
        return trees

    grads_l, metrics_l = gather(grads), gather(metrics)
    if oracle.compress:
        ef_l, new_ef_l = gather(ef_state), gather(out[2])
    if rank != 0:
        return None
    if oracle.compress:
        # one residual per quantisation site: every rank's, or each node's
        sites = range(0, R, R // n_nodes) if n_nodes else range(R)
        ef_state = unflatten({k: torch.cat([ef_l[r][k] for r in sites]) for k in ef_l[0]})
    p, o, e, _ = oracle.finalize(state[0], state[1], ef_state, grads_l, metrics_l, step)
    rtol, atol = DP_PARAM_TOL[oracle.compress]
    pairs = [(flatten_state({"params": p, "opt_state": o}),
              flatten_state({"params": out[0], "opt_state": out[1]}))]
    if oracle.compress:
        site = (lambda r: r // (R // n_nodes)) if n_nodes else (lambda r: r)
        e = flatten_state(e)
        pairs += [({k: v[site(r)] for k, v in e.items()}, {k: v[0] for k, v in new_ef_l[r].items()})
                  for r in range(R)]
    beyond = bitwise = total = 0
    for want, got in pairs:
        for k, w in want.items():
            g = got[k]
            beyond += int(((g - w).abs() > atol + rtol * w.abs()).sum())
            bitwise += int((g == w).sum())
            total += w.numel()
    return beyond, bitwise, total


def dp_rank(cfg) -> int:
    """One process of the data-parallel phase (``chip_smoke.py --dp-rank
    CFG``): a rank of a ``torch.distributed`` group on the card, or, with
    the ``sequential`` engine, the oracle at R logical ranks.  Trains
    ``cfg["steps"]`` steps at the paper's width from ``SEED``'s weights and
    writes to ``cfg["out"]`` its final state (``rank<r>.npz``) and a
    record (``rank<r>.json``): losses; per step the CUDA-event ms of the
    engine step and of the gradient reduction (the all-reduce, host
    staging included), the atoms and each kernel's launches, and, on rank 0
    of a gloo group, ``_oracle_step``'s counts; the per-rank
    telemetry; the peak memory; the time of one host round trip of the
    flat gradient (gloo's staging); and (``held<r>.npz``, read for the
    oracle) where Adam's denominator stayed 0 or above ``ADAM_HELD_EPS``
    eps at every step.  With ``cfg["deterministic"]`` it runs torch's
    deterministic algorithms and autograd on its own thread, so that its
    gradients are those of any other such process on the same bin, bit
    for bit.  ``cfg["mace"]`` / ``cfg["tcfg"]`` override fields of
    ``CONFIG`` / ``TrainerConfig`` (the autotune phase's kernel selection);
    the record names the kernels the trainer ran and its autotune
    decisions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg["deterministic"]:
        # sorted index_add_, and backward on this thread: on autograd's
        # worker thread a process's first backward differs from its later
        # ones in the last bits
        torch.use_deterministic_algorithms(True)
        torch.autograd.set_multithreading_enabled(False)
    distributed = cfg["engine"] != "sequential"
    if distributed:
        initialize_distributed(backend=cfg["backend"], timeout_s=DP_COLLECTIVE_TIMEOUT_S)
    rank = dist.get_rank() if distributed else 0
    torch.cuda.reset_peak_memory_stats()
    tr = _trainer(TRAIN_ATOMS, None, config=dataclasses.replace(CONFIG, **cfg.get("mace", {})),
                  engine=cfg["engine"], n_ranks=cfg["n_ranks"], n_nodes=cfg["n_nodes"],
                  compress_grads=cfg["compress"], **cfg.get("tcfg", {}))
    engine_step, engine_grads = tr.engine.step, tr.engine.grads
    reduce = getattr(tr.engine, "reduce_grads", None)
    # gloo groups: rank 0 gathers every rank's step on the host
    oracle = (make_engine("sequential", tr.mace_cfg, dataclasses.replace(
        tr.tcfg, engine="sequential"), tr.optimizer, tr.tcfg.max_graphs, tr.device)
        if distributed and cfg["backend"] == "gloo" else None)
    rows, reduce_ms, local, steps = [], [], [], []
    held = {k: torch.ones_like(v, dtype=torch.bool)
            for k, v in flatten_state(tr.params).items()}

    def kept_grads(params, batch):
        local[:] = [engine_grads(params, batch)]
        return local[0]

    def timed_reduce(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = reduce(*args)
        end.record()
        torch.cuda.synchronize()
        reduce_ms.append(start.elapsed_time(end))
        return out

    def timed_step(params, opt_state, ef_state, batches, step):
        nonlocal held
        before = _launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = engine_step(params, opt_state, ef_state, batches, step)
        end.record()
        torch.cuda.synchronize()
        after = _launches()
        rows.append(dict(ms=start.elapsed_time(end),
                         atoms=sum(float(b["node_mask"].sum()) for b in batches),
                         launches={k: after[k] - before[k] for k in after}))
        if oracle is not None:  # checked after the run, so no rank waits on it
            steps.append((opt_tree_map(lambda t: t.cpu(), (
                (params, opt_state, ef_state), local[0], out[:3])), step))
        denom = _adam_denominator(out[1], step)
        held = {k: held[k] & ((denom[k] == 0) | (denom[k] > ADAM_HELD_EPS * ADAM_EPS))
                for k in held}
        return out

    tr.engine.step = timed_step
    if distributed:
        tr.engine.grads, tr.engine.reduce_grads = kept_grads, timed_reduce
    _reset_launches()
    hist = tr.train(n_epochs=1, max_steps=cfg["steps"])["history"]
    torch.cuda.synchronize()
    for row, (record, step) in zip(rows, steps):
        record = opt_tree_map(lambda t: t.to(tr.device), record)
        row["oracle_step"] = _oracle_step(oracle, cfg["n_nodes"], *record, step)
    n_params = sum(v.numel() for v in flatten_state(tr.params).values())
    flat = torch.zeros(n_params, device=tr.device)
    staging_ms = _time_ms(lambda: flat.copy_(flat.cpu()), reps=5)
    out = Path(cfg["out"])
    np.savez(out / f"rank{rank}.npz",
             **{k: v.cpu().numpy() for k, v in flatten_state(tr._state()).items()})
    np.savez(out / f"held{rank}.npz", **{k: v.cpu().numpy() for k, v in held.items()})
    tel = tr.telemetry
    (out / f"rank{rank}.json").write_text(json.dumps(dict(
        losses=[h["loss"] for h in hist], rows=rows, reduce_ms=reduce_ms,
        work=tel.straggler_matrix().tolist(), loads=tel.load_matrix().tolist(),
        peak_bytes=torch.cuda.max_memory_allocated(), staging_ms=staging_ms,
        n_params=n_params, local=list(tr.engine.local_rank_range),
        kernels=_kernel_names(tr),
        decisions={k: d.describe() for k, d in tr.autotune_decisions.items()},
        bins=tr.sampler.bins_for_epoch(0)[:cfg["steps"] * cfg["n_ranks"]])))
    if distributed:
        dist.destroy_process_group()
    return 0


def _spawn_ranks(root, name, n_procs, **cfg):
    """Run ``dp_rank`` in ``n_procs`` processes (one group) and read back
    each one's record and final state; a failed process fails the phase."""
    out = Path(root) / name
    out.mkdir()
    cfg = dict(cfg, out=str(out), steps=cfg.get("steps", DP_STEPS))
    t0 = time.perf_counter()
    # cuBLAS is deterministic under torch's deterministic mode only with a
    # fixed workspace
    env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"} if cfg["deterministic"] else None
    group = spawn_local(n_procs, [sys.executable, str(Path(__file__).resolve()),
                                  "--dp-rank", json.dumps(cfg)], env=env,
                        log_dir=str(out / "logs"))
    codes = group.wait(timeout=DP_DEADLINE_S)
    if codes != [0] * n_procs:
        for p in group.procs:
            print(f"{name} process {p.process_id} log tail:\n"
                  f"{Path(p.log_path).read_text()[-4000:]}", flush=True)
        raise AssertionError(f"{name}: rank processes exited {codes}")
    print(f"{name}: {n_procs} process(es) done in {time.perf_counter() - t0:.1f}s", flush=True)
    return [(json.loads((out / f"rank{r}.json").read_text()),
             dict(np.load(out / f"rank{r}.npz")), dict(np.load(out / f"held{r}.npz")))
            for r in range(n_procs)]


def _check_replicas(name, ranks):
    """Every rank bit-identical to rank 0 (a synchronous replica), each
    having collated only its own bin, with 2/4/2/4 launches per step."""
    info0, state0, _ = ranks[0]
    for r, (info, state, _) in enumerate(ranks):
        diff = [k for k in state0 if not k.startswith("ef/")
                and not np.array_equal(state[k], state0[k])]
        if diff or info["losses"] != info0["losses"]:
            raise AssertionError(f"{name}: rank {r} is not rank 0's replica ({diff[:3]})")
        if info["local"] != [r]:
            raise AssertionError(f"{name}: rank {r} collated bins {info['local']}")
        for step, row in enumerate(info["rows"]):
            if row["launches"] != PER_BIN:
                raise AssertionError(f"{name}: rank {r} step {step} launched "
                                     f"{row['launches']}, expected {PER_BIN}")


def _hold_against_oracle(name, ranks, det, oracle, compress, card):
    """The timed run ``ranks`` and its deterministic twin ``det`` against
    the deterministic sequential oracle at the same R.  In both runs every
    rank is a bit-identical replica with 2/4/2/4 launches per step, and each
    step's reduction and update equal the oracle's on the ranks' own
    gradients from the step's own state (parameters, optimizer state and
    residuals within the JAX engine bounds); rank 0's losses are within
    rtol 1e-5 of the oracle's.  Free running, ``det``'s parameters,
    optimizer state and EMA are within the bound wherever the oracle's
    Adam stayed well conditioned, plain and compressed, and the rest are
    counted.  The timed run's free trajectory is not held element by
    element: the card's ``index_add_`` sums in no fixed order, and the
    oracle run twice that way differs from itself beyond the bound."""
    rtol, atol = DP_PARAM_TOL[compress]
    want_info, want, held = oracle[0]
    for run, label in ((ranks, name), (det, f"{name}_deterministic")):
        _check_replicas(label, run)
        steps = [row["oracle_step"] for row in run[0][0]["rows"]]
        loss_err = max(abs(a - b) / abs(b)
                       for a, b in zip(run[0][0]["losses"], want_info["losses"]))
        print(f"{label}: each step's reduction and update against the oracle's on the "
              f"ranks' gradients from the step's state (beyond rtol {rtol:g} / atol "
              f"{atol:g}, bit-identical, of): {steps}; losses {run[0][0]['losses']} vs "
              f"the deterministic oracle's {want_info['losses']} (max rel "
              f"{loss_err:.3e}, tol {DP_LOSS_RTOL:g}); card {card}", flush=True)
        if loss_err > DP_LOSS_RTOL or any(b for b, _, _ in steps):
            raise AssertionError(f"{label} differs from the sequential oracle")
    n = _count_against_oracle(det[0][1], want, held, rtol, atol)
    print(f"{name}_deterministic free running against the sequential oracle at "
          f"R={len(det)}: parameters, optimizer state, EMA: {n['over']} of {n['held']} "
          f"held beyond rtol {rtol:g} / atol {atol:g}; {n['free']} not held (where "
          f"Adam's denominator came within {ADAM_HELD_EPS:g} eps), {n['free_over']} of "
          f"them beyond (reported); {n['bitwise']} of {n['all']} bit-identical; card "
          f"{card}", flush=True)
    if n["over"]:
        raise AssertionError(f"{name}_deterministic differs from the sequential oracle")


def _count_against_oracle(state, want, held, rtol, atol):
    """Counts of a free-running final state against the oracle's, over
    parameters, optimizer state and EMA (not the residuals): elements
    beyond rtol / atol where the oracle's Adam stayed well conditioned
    (``held``, per parameter) and where it did not, bit-identical ones, and
    the largest difference."""
    n = dict(held=0, over=0, free=0, free_over=0, bitwise=0, all=0, worst=0.0)
    for k, w in want.items():
        if k.startswith("ef/"):
            continue
        # params/<p>, ema/<p>, opt_state/#<i>/<m|v>/<p>: the mask of <p>
        parts = k.split("/")
        mask = held["/".join(parts[3:] if parts[0] == "opt_state" else parts[1:])]
        diff = np.abs(state[k] - w)
        over = diff - atol - rtol * np.abs(w) > 0
        n["held"] += int(mask.sum())
        n["over"] += int((over & mask).sum())
        n["free"] += int((~mask).sum())
        n["free_over"] += int((over & ~mask).sum())
        n["bitwise"] += int((state[k] == w).sum())
        n["all"] += w.size
        n["worst"] = max(n["worst"], float(diff.max(initial=0.0)))
    return n


def _report_ranks(name, ranks, card):
    """Per-rank step ms, atoms/s, all-reduce ms and peak memory; the
    measured straggler ratio beside the token-count proxy of the same
    bins."""
    for r, (info, _, _) in enumerate(ranks):
        ms = [row["ms"] for row in info["rows"]]
        rate = [row["atoms"] / row["ms"] * 1e3 for row in info["rows"]]
        print(f"{name} rank {r}: step_ms={[round(x, 2) for x in ms]} "
              f"atoms_per_s={[round(x, 1) for x in rate]} "
              f"allreduce_ms={[round(x, 3) for x in info['reduce_ms']]} "
              f"staging_round_trip_ms={info['staging_ms']:.3f} "
              f"({info['n_params']} floats) peak_memory_allocated_gb="
              f"{info['peak_bytes'] / 2**30:.2f}; card {card}", flush=True)
    # steps 2 on: the first step loads the kernels and touches memory first
    info = ranks[0][0]
    R = len(info["work"][0])
    bins = Bins(info["bins"][R:], SyntheticCFMDataset(
        TRAIN_GRAPHS, seed=SEED, max_atoms=max(CAPACITIES)).sizes, TRAIN_ATOMS)
    proxy = balance_metrics(bins, R)
    measured = balance_metrics(bins, R, measured_work=np.asarray(info["work"])[1:])
    print(f"{name}: straggler ratio measured {measured.straggler_ratio:.4f} (steps 2-"
          f"{len(info['work'])}, per-rank forward+backward seconds from RankTelemetry) vs "
          f"token-count proxy {proxy.straggler_ratio:.4f} (the same steps' bins, atoms "
          f"{info['loads'][1:]}); card {card}", flush=True)


def data_parallel(card, first_loss):
    """Phase 9: each run of ``DP_RUNS`` as ``spawn_local`` processes on the
    card (gloo, the ranks share one card), timed; again under
    deterministic algorithms; and the deterministic sequential oracle at
    the same R, each from ``SEED``'s weights over the same bins; then one
    step of a world of one through NCCL.  Returns each kernel's launches
    per timed run, summed over its ranks."""
    torch.cuda.empty_cache()  # the parent's cached blocks, for the children
    launches = {}
    with tempfile.TemporaryDirectory() as root:
        for name, engine, R, n_nodes, compress in DP_RUNS:
            common = dict(n_ranks=R, n_nodes=n_nodes, compress=compress)
            ranks = _spawn_ranks(root, name, R, engine=engine, backend="gloo",
                                 deterministic=False, **common)
            det = _spawn_ranks(root, f"{name}_deterministic", R, engine=engine,
                               backend="gloo", deterministic=True, **common)
            oracle = _spawn_ranks(root, f"{name}_oracle", 1, engine="sequential",
                                  deterministic=True, **common)
            _report_ranks(name, ranks, card)
            _hold_against_oracle(name, ranks, det, oracle, compress, card)
            launches[name] = {k: sum(sum(row["launches"][k] for row in info["rows"])
                                     for info, _, _ in ranks) for k in PER_BIN}
        # compressed: a group of one is still quantised, so the gradients
        # go through NCCL's all_reduce (MAX of the scales, SUM of the payload)
        (info, _, _), = _spawn_ranks(root, "nccl", 1, engine="data_parallel",
                                     backend="nccl", n_ranks=1, n_nodes=None,
                                     compress=True, steps=1, deterministic=False)
        err = abs(info["losses"][0] - first_loss) / abs(first_loss)
        print(f"nccl: one step of a world of one, loss {info['losses'][0]:.7f} against "
              f"phase 4's first {first_loss:.7f} (rel {err:.2e}, tol {DP_LOSS_RTOL:g}), "
              f"step_ms={info['rows'][0]['ms']:.2f} allreduce_ms="
              f"{info['reduce_ms'][0]:.3f} launches={info['rows'][0]['launches']}; "
              f"card {card}", flush=True)
        if err > DP_LOSS_RTOL or info["rows"][0]["launches"] != PER_BIN:
            raise AssertionError("the NCCL step differs from the sequential one")
        launches["nccl"] = info["rows"][0]["launches"]
    return launches


# ---------------------------------------------------------------------------
# phase 10: the autotuner, and "auto" training and serving
# ---------------------------------------------------------------------------


def _kernel_names(tr):
    """The kernels a trainer runs: impl names, interaction backward, tiles."""
    cfg = tr.mace_cfg
    return dict(impl=cfg.symcon_impl_name, interaction_impl=cfg.interaction_impl_name,
                interaction_bwd_impl=cfg.interaction_bwd_impl,
                block=[tr.bin_shape.block_n, tr.bin_shape.block_e])


def _per_bin_for(cfg):
    """Each kernel's launches per training bin that ``cfg``'s resolved
    names imply (``PER_BIN`` when every kind runs cuda)."""
    want = dict(PER_BIN)
    if cfg.symcon_impl_name != "cuda":
        want.update(symcon_fwd=0, symcon_bwd=0)
    if cfg.interaction_impl_name != "cuda":
        want.update(tp_scatter_fwd=0, tp_gather_bwd=0)
    elif cfg.interaction_bwd_impl == "fused":
        want.update(tp_gather_bwd=0)
    return want


def tune_and_check(card):
    """Tune the main paths' shapes into a temporary trajectory, print each
    decision beside the committed one with the two best measured configs,
    and hold the committed table to ``check_table("gpu")``.  Returns the
    tuning seconds."""
    shapes = {kind: [s for s in shape_list if s["k"] == CONFIG.channels]
              for kind, shape_list in autotune.CANONICAL_SHAPES.items()}
    committed = autotune.load_table()
    with tempfile.TemporaryDirectory() as tmp:
        traj = Path(tmp) / "bench_kernels.json"
        t0 = time.perf_counter()
        rows = autotune.tune(shapes, AUTOTUNE_BUDGET_S, platform="gpu", trajectory_path=traj)
        tune_s = time.perf_counter() - t0
        runs = autotune.load_trajectory(traj)
        fresh = autotune.build_table(platforms=["gpu"], trajectory_path=traj)
    failed = sorted({(r["kind"], r["impl"], r["mode"], r["params"].get("E", r["params"].get("N")))
                     for r in rows if r.get("failed")})
    print(f"autotune: tuned {sum(map(len, shapes.values()))} shapes in {tune_s:.1f}s (budget "
          f"{AUTOTUNE_BUDGET_S:g}s, checked before each shape): {len(rows)} rows, "
          f"{len(failed)} failed configs {failed}; card {card}", flush=True)
    for kind, shape_list in shapes.items():
        for dims in shape_list:
            for mode in autotune.MODES:
                d = autotune.lookup(fresh, kind, dims, "gpu", mode)
                c = autotune.lookup(committed, kind, dims, "gpu", mode)
                top = sorted(autotune.measured_scores(runs, kind, "gpu", mode, dims,
                                                      max_dist=0.0).items(),
                             key=lambda kv: kv[1][0])[:2]
                best = "; ".join(f"{'/'.join(str(x) for x in cfg if x is not None)} "
                                 f"{us:.1f}us" for cfg, (us, _) in top)
                print(f"autotune {kind} {dims} {mode}: fresh "
                      f"{d.describe() if d else None} [best two: {best}] | committed "
                      f"{c.describe() if c else None}; card {card}", flush=True)
    problems = autotune.check_table("gpu")
    if problems:
        raise AssertionError(f"the committed tuning table fails its check: {problems}")
    print("autotune: the committed table passes check_table('gpu')", flush=True)
    return tune_s


def train_auto(card):
    """2 steps of a ``Trainer`` with ``"auto"`` impls and 2 of one naming
    what they resolve to, each in a deterministic process of its own: the
    same kernels, losses equal bit for bit, each step's launches per bin
    those the names imply.  Returns each kernel's launches in the "auto"
    run."""
    resolved, decisions = autotune.resolve_mace_config(
        dataclasses.replace(CONFIG, impl="auto", interaction_impl="auto"),
        capacity=TRAIN_ATOMS, edge_factor=EDGE_FACTOR, platform="gpu")
    for d in decisions.values():
        print(f"autotune: {d.describe()}", flush=True)
    d = decisions["interaction"]
    explicit = dict(mace=dict(impl=resolved.impl, interaction_impl=resolved.interaction_impl,
                              interaction_bwd_impl=resolved.interaction_bwd_impl,
                              interaction_block_n=resolved.interaction_block_n),
                    tcfg={} if d.block_n is None else dict(block_n=d.block_n,
                                                            block_e=d.block_e))
    per_bin = _per_bin_for(resolved)
    torch.cuda.empty_cache()  # the parent's cached blocks, for the children
    common = dict(engine="sequential", n_ranks=1, n_nodes=None, compress=False,
                  steps=AUTOTUNE_STEPS, deterministic=True)
    with tempfile.TemporaryDirectory() as root:
        (auto, _, _), = _spawn_ranks(root, "autotune_auto", 1, **common,
                                     tcfg=dict(impl="auto", interaction_impl="auto"))
        (named, _, _), = _spawn_ranks(root, "autotune_named", 1, **common, **explicit)
    print(f"autotune train: 'auto' ran {auto['kernels']}, losses {auto['losses']}, "
          f"launches {[r['launches'] for r in auto['rows']]}, step_ms "
          f"{[round(r['ms'], 2) for r in auto['rows']]}; named ran {named['kernels']}, "
          f"losses {named['losses']}; card {card}", flush=True)
    if auto["kernels"] != named["kernels"] or set(auto["decisions"]) != set(decisions):
        raise AssertionError("the 'auto' trainer did not resolve to the named kernels")
    if (len(auto["losses"]) != AUTOTUNE_STEPS or auto["losses"] != named["losses"]
            or not all(np.isfinite(auto["losses"]))):
        raise AssertionError(f"'auto' losses {auto['losses']} differ from the named "
                             f"trainer's {named['losses']}")
    for info in (auto, named):
        if any(r["launches"] != per_bin for r in info["rows"]):
            raise AssertionError(f"launches {[r['launches'] for r in info['rows']]} "
                                 f"per step, expected {per_bin} for the resolved names")
    return {k: sum(r["launches"][k] for r in auto["rows"]) for k in PER_BIN}


def serve_auto(params, mols, fp32_results, card):
    """The 48 molecules through a ``GraphServer`` with
    ``interaction_impl="auto"``: one graph per bucket (``serve``), the
    decisions in ``stats()``, the kernels of the resolved names launched,
    energies and forces within ``PRECISION_TOL["fp32"]`` of phase 3's."""
    results, stats, launches, _ = serve(params, mols,
                                        dataclasses.replace(CONFIG, interaction_impl="auto"))
    decisions = stats["autotune_decisions"]
    e32 = np.array([r.energy for r in fp32_results])
    f32 = np.concatenate([r.forces.ravel() for r in fp32_results])
    err_e = _l2_rel(np.array([r.energy for r in results]), e32)
    err_f = _l2_rel(np.concatenate([r.forces.ravel() for r in results]), f32)
    print(f"autotune serve: decisions {decisions}, {stats['served']} graphs "
          f"graphs_per_s={stats['graphs_per_s']:.2f}, census {stats['compile_census']}, "
          f"launches {launches}, energies / forces L2-rel {err_e:.3e} / {err_f:.3e} "
          f"against phase 3; card {card}", flush=True)
    if set(decisions) != {"interaction"}:
        raise AssertionError(f"the server reported decisions {decisions}")
    resolved, _ = autotune.resolve_mace_config(
        dataclasses.replace(CONFIG, interaction_impl="auto"), capacity=max(CAPACITIES),
        edge_factor=EDGE_FACTOR, platform="gpu")
    want = [k for k, n in _per_bin_for(resolved).items() if n]
    if any(launches[k] <= 0 for k in want):
        raise AssertionError(f"the 'auto' server launched {launches}, expected {want}")
    if max(err_e, err_f) > PRECISION_TOL["fp32"]:
        raise AssertionError("the 'auto' server disagrees with phase 3's")
    return launches


def _step_ms(tr, steps):
    """CUDA-event ms of each of ``tr``'s next ``steps`` engine steps."""
    times, engine_step = [], tr.engine.step

    def timed_step(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = engine_step(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        return out

    tr.engine.step = timed_step
    try:
        hist = tr.train(n_epochs=1, max_steps=tr.global_step + steps)["history"]
    finally:
        tr.engine.step = engine_step
    if len(times) != steps or not all(np.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"the geometry run took {len(times)} of {steps} steps: {hist}")
    return times


def _abba(run_default, run_auto):
    """Readings in the order default, auto, auto, default."""
    d1, a1, a2, d2 = run_default(), run_auto(), run_auto(), run_default()
    return [d1, d2], [a1, a2]


def compare_geometries(params, mols, card):
    """The tiles ``"auto"`` resolves to against the default 32x128, on the
    same inputs, each read twice (default, auto, auto, default) so that a
    configuration's own spread stands beside the gap: per serving bucket,
    the CUDA-event ms of a graph replay on one real bin of ``mols`` (the
    two outputs within ``KERNEL_TOL``); per geometry the training and
    serving resolutions name, ms of training steps on the same 3,072-atom
    bins.  Returns the readings."""
    default = (DEFAULT_BLOCK_N, DEFAULT_BLOCK_E)
    serve_cfg, serve_dec = autotune.resolve_mace_config(
        dataclasses.replace(CONFIG, interaction_impl="auto"), capacity=max(CAPACITIES),
        edge_factor=EDGE_FACTOR, platform="gpu")
    _, train_dec = autotune.resolve_mace_config(
        dataclasses.replace(CONFIG, interaction_impl="auto"), capacity=TRAIN_ATOMS,
        edge_factor=EDGE_FACTOR, platform="gpu")
    tiles = {path: (d["interaction"].block_n, d["interaction"].block_e)
             for path, d in (("serving", serve_dec), ("training", train_dec))}
    out = {"card": card, "tiles": {p: list(t) for p, t in tiles.items()}, "serving": {},
           "training": {}}

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = bucket_ladder(CAPACITIES, edge_factor=EDGE_FACTOR)
    tuned = bucket_ladder(CAPACITIES, edge_factor=EDGE_FACTOR, block_n=tiles["serving"][0],
                          block_e=tiles["serving"][1])
    engines = (make_serve_engine(CONFIG, params, base),
               make_serve_engine(serve_cfg, params, tuned))
    try:
        for b_default, b_auto in zip(base, tuned):
            picked = _bin_for(b_default, sorted(mols, key=lambda m: -m.n_atoms))
            calls = [lambda eng=eng, b=b, batch=eng.collate(picked, b)[0]: eng.forward(batch, b)
                     for eng, b in zip(engines, (b_default, b_auto))]
            want = tuple(t.clone() for t in calls[0]())
            got = tuple(t.clone() for t in calls[1]())
            err, scale, ok = _compare(got, want)
            d_ms, a_ms = _abba(lambda: _time_ms(calls[0], GEOMETRY_REPLAYS),
                               lambda: _time_ms(calls[1], GEOMETRY_REPLAYS))
            out["serving"][bucket_key(b_default)] = dict(default=d_ms, auto=a_ms)
            print(f"geometry serving {bucket_key(b_default)} ({len(picked)} graphs): replay "
                  f"ms at {default[0]}x{default[1]} {d_ms}, at {tiles['serving'][0]}x"
                  f"{tiles['serving'][1]} {a_ms} (default, auto, auto, default); "
                  f"max_abs_err={err:.3e} (tol {KERNEL_TOL:g}*max(1,{scale:.3g})); "
                  f"card {card}", flush=True)
            if not ok:
                raise AssertionError(f"the {tiles['serving']} graph of "
                                     f"{bucket_key(b_default)} disagrees with the default's")
    finally:
        for eng in engines:
            eng.close()

    others = sorted({t for t in tiles.values() if t != default})
    if not others:
        print(f"geometry training: both paths resolve to {default}; nothing to compare",
              flush=True)
    for t in others:
        torch.cuda.empty_cache()
        trainers = (_trainer(TRAIN_ATOMS, None),
                    _trainer(TRAIN_ATOMS, None, block_n=t[0], block_e=t[1],
                             config=dataclasses.replace(CONFIG, interaction_block_n=t[0])))
        for tr in trainers:
            _step_ms(tr, 1)  # warm-up
        d_ms, a_ms = _abba(lambda: _step_ms(trainers[0], GEOMETRY_STEPS),
                           lambda: _step_ms(trainers[1], GEOMETRY_STEPS))
        out["training"][f"{t[0]}x{t[1]}"] = dict(default=d_ms, auto=a_ms)
        print(f"geometry training at {TRAIN_ATOMS} atoms: step ms at {default[0]}x{default[1]} "
              f"{d_ms}, at {t[0]}x{t[1]} {a_ms} (default, auto, auto, default; the same "
              f"bins in each pair); card {card}", flush=True)
        del trainers
    return out


# ---------------------------------------------------------------------------
# phase 11: elastic and supervised training
# ---------------------------------------------------------------------------

ELASTIC_R = 2
ELASTIC_SCHEDULE = {2: 1}   # after step 2, R = 2 -> 1
ELASTIC_STEPS = 4
ELASTIC_DEADLINE_S = 300    # each child process of (b), start to exit
SUPERVISED_DEADLINE_S = 420  # each supervised pod, start to exit
# the step watchdog of the hang drill: this many times (a)'s slowest warm
# step (after each generation's first), and no less than the floor (a cold
# child's first step builds its cuBLAS handles and loads the kernel
# libraries, and the watchdog spans it too)
DEADLINE_STEPS, DEADLINE_FLOOR_S = 10, 20.0


def _elastic_trainer(ckpt_dir, n_ranks=ELASTIC_R, schedule=None, elastic=False):
    """Phase 4's trainer (the paper's width at capacity 3,072, prefetch 1,
    ``SEED``'s weights) on the ``sequential`` engine at ``n_ranks`` logical
    ranks, checkpointing every step; an ``ElasticTrainer`` when given a
    ``schedule``."""
    tcfg = TrainerConfig(capacity=TRAIN_ATOMS, edge_factor=EDGE_FACTOR,
                         max_graphs=max(16, TRAIN_ATOMS // 8), prefetch=1,
                         n_ranks=n_ranks, ckpt_dir=ckpt_dir, ckpt_every=1, elastic=elastic)
    dataset = SyntheticCFMDataset(TRAIN_GRAPHS, seed=SEED, max_atoms=max(CAPACITIES))
    if schedule:
        return ElasticTrainer(CONFIG, tcfg, dataset, rescale_schedule=schedule, seed=SEED)
    return Trainer(CONFIG, tcfg, dataset, seed=SEED)


@contextlib.contextmanager
def _timed_sequential_steps(rows):
    """Time every ``SequentialEngine.step`` (the engines a rescale builds
    too) by CUDA events, with its atoms, ranks and each kernel's launches."""
    step = SequentialEngine.step

    def timed(self, params, opt_state, ef_state, batches, global_step):
        before = _launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(self, params, opt_state, ef_state, batches, global_step)
        end.record()
        torch.cuda.synchronize()
        after = _launches()
        rows.append(dict(ms=start.elapsed_time(end), n_ranks=len(batches),
                         atoms=sum(float(b["node_mask"].sum()) for b in batches),
                         launches={k: after[k] - before[k] for k in after},
                         denominator=_adam_denominator(out[1], global_step)))
        return out

    SequentialEngine.step = timed
    try:
        yield
    finally:
        SequentialEngine.step = step


def _check_step_launches(label, rows):
    """Each step's launches: ``PER_BIN`` per bin of the step."""
    for i, r in enumerate(rows):
        want = {k: n * r["n_ranks"] for k, n in PER_BIN.items()}
        if r["launches"] != want:
            raise AssertionError(f"{label} step {i + 1} at R={r['n_ranks']} launched "
                                 f"{r['launches']}, expected {want}")


def elastic_in_process(card):
    """Phase 11 (a): an ``ElasticTrainer`` at R = 2 rescaled to R = 1 after
    step 2, 4 steps, in this process.  Printed per step: CUDA-event ms,
    atoms/s, loss, launches (``PER_BIN`` per bin); the rescale event; the
    merged telemetry.  Held: every loss finite; no graph taken twice and
    every one from epoch 0's packing, each step's atoms those of its bins;
    the checkpoints of steps 2 and 4 record R and the lineage.  Returns
    the launches and the slowest warm step's ms (after each generation's
    first, which pays the engine's set-up)."""
    rows = []
    with tempfile.TemporaryDirectory() as d:
        tr = _elastic_trainer(d, schedule=dict(ELASTIC_SCHEDULE))
        first = tr.sampler
        _reset_launches()
        with _timed_sequential_steps(rows):
            hist = tr.train(n_epochs=1, max_steps=ELASTIC_STEPS)["history"]
        torch.cuda.synchronize()
        launches = _launches()
        metas = {s: read_meta(d, step=s)[1] for s in (2, ELASTIC_STEPS)}
    for i, (h, r) in enumerate(zip(hist, rows)):
        print(f"elastic step {i + 1}: R={r['n_ranks']} loss={h['loss']:.6f} "
              f"step_ms={r['ms']:.2f} atoms={r['atoms']:.0f} "
              f"atoms_per_s={r['atoms'] / r['ms'] * 1e3:.1f} launches={r['launches']}; "
              f"card {card}", flush=True)
    (ev,) = tr.rescale_events
    print(f"elastic rescale @step {ev['step']}: from_ranks={ev['from_ranks']} "
          f"to_ranks={ev['to_ranks']} repack_s={ev['repack_s']:.6f} "
          f"rebuild_s={ev['rebuild_s']:.6f} discarded_batches={ev['discarded_batches']}",
          flush=True)
    tel = tr.telemetry
    if not isinstance(tel, MergedTelemetry) or tel.n_generations != 2:
        raise AssertionError(f"expected the merged telemetry of 2 generations, got {tel}")
    print(f"elastic telemetry: {tel.n_generations} generations, steps "
          f"{[g.n_steps for g in tel.generations]}, ranks "
          f"{[g.n_ranks for g in tel.generations]}, c_token={tel.c_token():.4e} s/atom, "
          f"measured straggler {tel.measured_straggler():.4f}, rescale (repack, rebuild) "
          f"{tel.rescale_seconds()} s, collate hidden {tel.overlap_seconds():.4f} s",
          flush=True)
    if len(hist) != ELASTIC_STEPS or not all(np.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"the elastic run did not take {ELASTIC_STEPS} finite steps")
    if [r["n_ranks"] for r in rows] != [2, 2, 1, 1]:
        raise AssertionError(f"ranks per step {[r['n_ranks'] for r in rows]}")
    _check_step_launches("elastic", rows)
    # the graphs taken: the R = 2 packing's first 2 steps, then the first 2
    # steps of the remainder packed at R = 1
    bins = (first.bins_for_epoch(0)[:2 * ELASTIC_R]
            + tr.sampler.bins_for_epoch(0)[:ELASTIC_STEPS - 2])
    taken = [i for b in bins for i in b]
    epoch0 = {i for b in first.bins_for_epoch(0) for i in b}
    if len(set(taken)) != len(taken) or not set(taken) <= epoch0:
        raise AssertionError("the elastic run took a graph twice or outside epoch 0")
    sizes = tr.dataset.sizes
    per_step = [bins[0] + bins[1], bins[2] + bins[3], bins[4], bins[5]]
    if [float(sizes[s].sum()) for s in per_step] != [r["atoms"] for r in rows]:
        raise AssertionError("a step's atoms are not those of its bins")
    want = {2: (2, []), ELASTIC_STEPS: (1, [{"n_ranks": 2, "cursor": 2}])}
    for s, (n_ranks, lineage) in want.items():
        if (metas[s]["n_ranks"], metas[s]["lineage"]) != (n_ranks, lineage):
            raise AssertionError(f"checkpoint {s}: n_ranks {metas[s]['n_ranks']}, lineage "
                                 f"{metas[s]['lineage']}; expected {n_ranks}, {lineage}")
    print(f"elastic: {len(taken)} graphs, none twice; checkpoints step 2 {metas[2]['n_ranks']} "
          f"ranks lineage {metas[2]['lineage']}, step {ELASTIC_STEPS} "
          f"{metas[ELASTIC_STEPS]['n_ranks']} rank lineage {metas[ELASTIC_STEPS]['lineage']}; "
          f"launches {launches}", flush=True)
    del tr
    warm = [r["ms"] for i, r in enumerate(rows) if i and r["n_ranks"] == rows[i - 1]["n_ranks"]]
    return launches, max(warm)


def elastic_run(cfg) -> int:
    """One process of phase 11 (``chip_smoke.py --elastic-run CFG``), under
    phase 9's deterministic settings: ``oracle`` (the uninterrupted run of
    (a)), ``crash`` (drill A: killed by ``crash_at_step`` after step 4,
    before its checkpoint; a trainer at R = 1 with ``elastic`` restores
    step 3's and takes step 4), ``restart`` (drill B: 2 steps at R = 2, then
    a trainer at R = 1 with ``elastic`` restores across rank counts and
    takes steps 3-4).  Writes its record (``run.json``)
    and final state (``state.npz``, and ``held.npz``: where Adam's
    denominator stayed 0 or above ``ADAM_HELD_EPS`` eps at every step)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.autograd.set_multithreading_enabled(False)
    out, mode = Path(cfg["out"]), cfg["mode"]
    d, rows, losses, record = str(out / "ckpt"), [], [], {}
    _reset_launches()
    with _timed_sequential_steps(rows):
        if mode == "oracle":
            tr = _elastic_trainer(d, schedule=dict(ELASTIC_SCHEDULE))
            losses = [h["loss"] for h in tr.train(n_epochs=1, max_steps=ELASTIC_STEPS)["history"]]
        elif mode == "crash":
            os.environ[ENV_FAULT_PLAN] = json.dumps(
                {"crash_at_step": {"step": ELASTIC_STEPS, "mode": "raise"}})
            tr, history = _elastic_trainer(d, schedule=dict(ELASTIC_SCHEDULE)), []
            try:
                tr.run_epoch(history, max_steps=ELASTIC_STEPS)
            except SimulatedCrash as exc:
                record["crash"] = str(exc)
            else:
                raise AssertionError("crash_at_step did not fire")
            del os.environ[ENV_FAULT_PLAN]
            del tr
            record["newest_checkpoint"] = latest_step(d)
            tr = _elastic_trainer(d, n_ranks=1, elastic=True)
            if not tr.maybe_restore():
                raise AssertionError("drill A found no checkpoint")
            record["restored"] = [tr.global_step, tr._lineage]
            losses = [h["loss"] for h in history[:tr.global_step]]
            losses += [h["loss"] for h in tr.train(n_epochs=1, max_steps=ELASTIC_STEPS)["history"]]
        else:
            first = _elastic_trainer(d)
            losses = [h["loss"] for h in first.train(n_epochs=1, max_steps=2)["history"]]
            del first
            tr = _elastic_trainer(d, n_ranks=1, elastic=True)
            if not tr.maybe_restore():
                raise AssertionError("drill B found no checkpoint")
            record["restored"] = [tr.global_step, tr._lineage]
            losses += [h["loss"] for h in tr.train(n_epochs=1, max_steps=ELASTIC_STEPS)["history"]]
    torch.cuda.synchronize()
    held = None
    for r in rows:
        ok = {k: (v == 0) | (v > ADAM_HELD_EPS * ADAM_EPS) for k, v in r.pop("denominator").items()}
        held = ok if held is None else {k: held[k] & ok[k] for k in held}
    np.savez(out / "state.npz", **{k: v.cpu().numpy() for k, v in flatten_state(
        {"params": tr.params, "opt_state": tr.opt_state, "ema": tr.ema_params}).items()})
    np.savez(out / "held.npz", **{k: v.cpu().numpy() for k, v in held.items()})
    (out / "run.json").write_text(json.dumps(dict(
        record, losses=losses, rows=rows, launches=_launches(),
        final=[tr.global_step, tr.engine.n_ranks, read_meta(d)[1]["lineage"]])))
    return 0


def _spawn_elastic(root, mode):
    """Start ``elastic_run`` in a process of its own; returns (mode, out,
    its group)."""
    out = Path(root) / mode
    out.mkdir()
    group = spawn_local(1, [sys.executable, str(Path(__file__).resolve()), "--elastic-run",
                            json.dumps(dict(mode=mode, out=str(out)))],
                        env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}, log_dir=str(out / "logs"))
    return mode, out, group


def _wait_elastic(mode, out, group):
    """Wait for an ``elastic_run`` process; its record, or its log on
    failure."""
    codes = group.wait(timeout=ELASTIC_DEADLINE_S)
    if codes != [0]:
        print(f"elastic {mode} log tail:\n{Path(group.procs[0].log_path).read_text()[-4000:]}",
              flush=True)
        raise AssertionError(f"elastic {mode}: the process exited {codes}")
    return json.loads((out / "run.json").read_text())


def restart_equivalence(card):
    """Phase 11 (b): the oracle, drill A and drill B, each a process under
    the deterministic settings, all three at once.  Each drill against the
    oracle: losses within ``DP_LOSS_RTOL``, final parameters, optimizer
    state and EMA within the JAX engine bounds wherever the oracle's Adam
    stayed well conditioned (the rest counted).  Returns each run's
    launches."""
    torch.cuda.empty_cache()  # the parent's cached blocks, for the children
    rtol, atol = DP_PARAM_TOL[False]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        started = [_spawn_elastic(root, mode) for mode in ("oracle", "crash", "restart")]
        runs = {mode: (_wait_elastic(mode, out, group), dict(np.load(out / "state.npz")),
                       dict(np.load(out / "held.npz")))
                for mode, out, group in started}
    print(f"elastic restarts: 3 processes done in {time.perf_counter() - t0:.1f}s", flush=True)
    oracle, want, held = runs["oracle"]
    launches = {}
    for mode, (info, state, _) in runs.items():
        _check_step_launches(f"elastic {mode}", info["rows"])
        launches[mode] = info["launches"]
        if not all(n > 0 for n in info["launches"].values()):
            raise AssertionError(f"elastic {mode} launched no {info['launches']}")
        if info["final"] != [ELASTIC_STEPS, 1, [{"n_ranks": 2, "cursor": 2}]]:
            raise AssertionError(f"elastic {mode} ended at (step, R, lineage) {info['final']}")
        if mode == "oracle":
            continue
        restored = [3, [{"n_ranks": 2, "cursor": 2}]] if mode == "crash" else [
            2, [{"n_ranks": 2, "cursor": 2}]]
        if info["restored"] != restored or (mode == "crash" and info["newest_checkpoint"] != 3):
            raise AssertionError(f"elastic {mode} restored {info['restored']}")
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(info["losses"], oracle["losses"]))
        n = _count_against_oracle(state, want, held, rtol, atol)
        label = {"crash": "drill A (crash after step 4, restore step 3 at R=1)",
                 "restart": "drill B (2 steps at R=2, restore at R=1)"}[mode]
        print(f"elastic {label}: losses {info['losses']} vs the oracle's {oracle['losses']} "
              f"(max rel {loss_err:.3e}, tol {DP_LOSS_RTOL:g}); parameters, optimizer "
              f"state, EMA: {n['over']} of {n['held']} held beyond rtol {rtol:g} / atol "
              f"{atol:g}, {n['free']} not held ({n['free_over']} of them beyond), largest "
              f"difference {n['worst']:.3e}, {n['bitwise']} of {n['all']} bit-identical; "
              f"step_ms {[round(r['ms'], 2) for r in info['rows']]}; card {card}", flush=True)
        if loss_err > DP_LOSS_RTOL or n["over"] or len(info["losses"]) != ELASTIC_STEPS:
            raise AssertionError(f"elastic {mode} differs from the uninterrupted oracle")
    return launches


def _supervised(root, name, plan, extra=()):
    """``launch.train --distributed --supervised --nprocs 2`` at the paper's
    config (capacity 3,072) on the card, with ``plan`` in
    ``REPRO_FAULT_PLAN``; returns (incidents, final meta, the relaunched
    trainer's kernel launches, seconds from start to each incident)."""
    ckpt = Path(root) / name
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--distributed", "--supervised",
           "--nprocs", "2", "--steps", str(ELASTIC_STEPS), "--ckpt-every", "1",
           "--ckpt-dir", str(ckpt), *extra]
    env = dict(os.environ, REPRO_FAULT_PLAN=json.dumps(plan),
               PYTHONPATH=str(SRC_DIR))
    t0 = time.time()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=SUPERVISED_DEADLINE_S)
    logs = sorted((ckpt / "supervisor" / "logs").glob("*/*.log"))
    if proc.returncode != 0:
        tails = "".join(f"{p}:\n{p.read_text()[-3000:]}\n" for p in logs)
        raise AssertionError(f"supervised {name} exited {proc.returncode}:\n{proc.stdout}"
                             f"{proc.stderr}\n{tails}")
    incidents = [json.loads(line) for line in
                 (ckpt / "supervisor" / "incidents.jsonl").read_text().splitlines() if line]
    relaunched = "".join(p.read_text() for p in logs if p.parent.name == "attempt1")
    launches = [json.loads(line.split("kernel launches: ", 1)[1])
                for line in relaunched.splitlines() if line.startswith("kernel launches: ")]
    resumed = [int(n) for n in re.findall(r"^resumed at step (\d+)$", relaunched, re.M)]
    return incidents, read_meta(str(ckpt))[1], launches, resumed, t0


def supervised_drills(card, warm_step_ms):
    """Phase 11 (c): the crash drill (process 1 exits 43 after step 2) and
    the hang drill (process 0 hangs in collation at step 2, its step
    watchdog exits 44), each a supervised pod of 2 gloo ranks on the card.
    Held: exit 0; the incidents crash (or hang), relaunch at world 1,
    recovered, success; the final checkpoint step 4 at 1 rank by 1
    process; the relaunched rank's launches ``PER_BIN`` per step.
    Printed: detection_s (for the hang, as the deadline plus the
    overshoot), recovery_s, steps_lost, each attempt's wall time.  Returns
    each drill's relaunched launches."""
    deadline = round(max(DEADLINE_FLOOR_S, DEADLINE_STEPS * warm_step_ms / 1e3), 1)
    print(f"supervised: the hang drill's step deadline is {deadline:.1f} s: "
          f"{DEADLINE_STEPS} x the slowest warm step of (a) ({warm_step_ms:.1f} ms), "
          f"at least {DEADLINE_FLOOR_S:g} s", flush=True)
    torch.cuda.empty_cache()
    drills = {"crash": ({"crash_at_step": {"step": 2, "process": 1}}, (), "crash", 43),
              "hang": ({"hang_at_step": {"step": 2, "process": 0}},
                       ("--step-deadline-s", f"{deadline:.1f}"), "hang", 44)}
    launches = {}
    with tempfile.TemporaryDirectory() as root:
        for name, (plan, extra, kind, code) in drills.items():
            incidents, meta, counts, resumed, t0 = _supervised(root, name, plan, extra)
            # attempt 0's incidents: the fault, and any peer that the same
            # poll found dead or stalled too (both watchdogs of a hang fire)
            faults = [r for r in incidents if r["attempt"] == 0]
            kinds = [r["kind"] for r in incidents]
            fault = faults[0] if faults else None
            if (not faults or {r["kind"] for r in faults} - {"crash", "hang"}
                    or kinds[len(faults):] != ["relaunch", "recovered", "success"]
                    or fault["kind"] != kind or code not in fault["exit_codes"]):
                raise AssertionError(f"supervised {name}: incidents {incidents}")
            relaunch, recovered, success = incidents[len(faults):]
            if relaunch["world_size"] != 1:
                raise AssertionError(f"supervised {name}: relaunched at {relaunch}")
            if name == "crash" and (fault["process_index"], fault["exit_codes"][1]) != (1, 43):
                raise AssertionError(f"supervised crash: {fault}")
            if (meta["step"], meta["n_ranks"], meta["process_count"]) != (ELASTIC_STEPS, 1, 1):
                raise AssertionError(f"supervised {name}: final checkpoint {meta}")
            if len(counts) != 1 or len(resumed) != 1:
                raise AssertionError(f"supervised {name}: the relaunch logged {counts}, "
                                     f"resumed at {resumed}")
            taken = ELASTIC_STEPS - resumed[0]
            if counts[0] != {k: n * taken for k, n in PER_BIN.items()}:
                raise AssertionError(f"supervised {name}: the relaunch launched {counts[0]} "
                                     f"in {taken} steps")
            launches[name] = counts[0]
            detection = f"{fault['detection_s']:.3f}"
            if name == "hang":
                detection += (f" (the deadline {deadline:.1f} + overshoot "
                              f"{fault['detection_s'] - deadline:.3f})")
            print(f"supervised {name}: {'; '.join(r['detail'] for r in faults)}; detection_s="
                  f"{detection} recovery_s={recovered['recovery_s']:.3f} "
                  f"steps_lost={recovered['steps_lost']} first_beat_step="
                  f"{recovered['first_beat_step']} resumed at step {resumed[0]}; attempt 0 "
                  f"wall {fault['t'] - t0:.1f} s (start to the incident), attempt 1 wall "
                  f"{success['t'] - relaunch['t']:.1f} s (relaunch to success); final "
                  f"checkpoint step {meta['step']} n_ranks {meta['n_ranks']} process_count "
                  f"{meta['process_count']} lineage {meta['lineage']}; relaunch launches "
                  f"{counts[0]}; card {card}", flush=True)
    return launches


def elastic_phase(card):
    """Phase 11: (a) the in-process rescale, (b) restart equivalence, (c)
    the supervised drills.  Returns each part's launches."""
    t0 = time.perf_counter()
    launches, warm = elastic_in_process(card)
    parts = {"in_process": launches}
    parts.update({f"restart_{m}": n for m, n in restart_equivalence(card).items()})
    parts.update({f"supervised_{m}": n
                  for m, n in supervised_drills(card, warm).items()})
    print(f"elastic phase: {time.perf_counter() - t0:.1f}s", flush=True)
    return parts


# ---------------------------------------------------------------------------
# phase 12: the LM family
# ---------------------------------------------------------------------------

# a dense GQA family whose training state fits one card with room for the
# activations: 2.634 B parameters at 16 B each (fp32 weights, gradients, m
# and v) is about 42 GB
LM_TRAIN_ARCH = "granite_3_2b"
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 2, 2048
LM_TRAIN_STEPS = 3                  # timed, after one warm-up step
LM_LR = lm_pretrain.LR
LM_REDUCED_BATCH, LM_REDUCED_SEQ = 2, 32
LM_DECODE_STEPS = 4
LM_STEP_TOL = 2e-4                  # rtol = atol, tests/test_backward.py
LM_LOGITS_TOL = 2e-5                # rtol = atol, tests/test_kernels.py
LM_SERVE_ARGV = ["--config", "full", "--arch", "granite-3-2b", "--requests", "20",
                 "--batch", "8", "--prompt-len", "512", "--max-new", "64"]
LM_EAGER_TOKENS = 8
LM_PROFILE_GROUPS = (("gemm", ("gemm", "nvjet", "cutlass", "xmma")),
                     ("elementwise", ("elementwise",)), ("reduce", ("reduce",)))


def _free_device_memory():
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def _lm_profile(label, fn, step_ms=None):
    """``fn()`` once under ``torch.profiler``, recording the card only (the
    host's ops of a training step would make the profile slow to
    aggregate): the card's busy and idle share of its wall time (and of
    ``step_ms``, an unprofiled CUDA-event time of the same work, when
    given), its kernels by group (GEMM, elementwise, reduction, the rest)
    and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _kernel_events(prof)
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    if busy_ms == 0:
        raise AssertionError(f"the profiler saw no device time in {label}")
    groups = {name: 0.0 for name, _ in LM_PROFILE_GROUPS}
    groups["other"] = 0.0
    for e in events:
        key = e.key.lower()
        name = next((g for g, subs in LM_PROFILE_GROUPS if any(x in key for x in subs)), "other")
        groups[name] += _device_us(e) / 1e3
    against = (f" device_idle_share_against_unprofiled={1 - busy_ms / step_ms:.3f} "
               f"(unprofiled {step_ms:.1f} ms)" if step_ms else "")
    print(f"{label} profile: wall_ms={wall_ms:.1f} device_busy_ms={busy_ms:.1f} "
          f"device_idle_share={1 - busy_ms / wall_ms:.3f}{against} "
          f"device_ops={sum(e.count for e in events)} by group ms "
          f"{json.dumps({k: round(v, 3) for k, v in groups.items()})}", flush=True)
    for e in sorted(events, key=_device_us, reverse=True)[:10]:
        print(f"{label} profile top: {_device_us(e) / 1e3:9.3f} ms x{e.count:<5d} {e.key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, groups=groups,
                ops=sum(e.count for e in events))


def lm_train_full_width(card, dev=None, cfg=None):
    """Phase 12 (a): ``granite_3_2b`` at its published config, trained on
    packed documents; returns the timed steps' numbers."""
    dev = dev or torch.device("cuda")
    cfg = cfg or get_lm_config(LM_TRAIN_ARCH)
    B, S = LM_TRAIN_BATCH, LM_TRAIN_SEQ
    lengths, token_fn = lm_pretrain.synth_docs(400, cfg.vocab, seed=SEED)
    packed = pack_documents(lengths, S, B, token_fn)
    batches = [lm_pretrain.packed_batch(packed, i, B, cfg, dev)
               for i in range(2 + LM_TRAIN_STEPS)]
    held_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    model = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    m, v = init_opt_state(model)
    n_params = sum(p.numel() for p in model.parameters())
    with torch.no_grad():
        loss16 = float(lm.forward_train(model, cfg, batches[0])[0])
        loss32 = float(lm.forward_train(
            model, dataclasses.replace(cfg, compute_dtype=torch.float32), batches[0])[0])
    rel = abs(loss16 - loss32) / abs(loss32)
    print(f"lm train {cfg.name}: {n_params:,} parameters (param_count {cfg.param_count():,}), "
          f"{packed.tokens.shape[0]} packed bins of {S}; first batch loss bf16 {loss16:.6f} "
          f"fp32 {loss32:.6f} rel {rel:.2e} (tol {PRECISION_TOL['bf16']:g}); set-up "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    if not rel <= PRECISION_TOL["bf16"]:
        raise AssertionError(f"bf16 loss {loss16} is {rel:.2e} from the fp32 {loss32}")
    step = make_lm_train_step(cfg, lr=LM_LR)
    cost = lm_cell_cost(cfg, {"kind": "train", "batch": B, "seq": S})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for i, batch in enumerate(batches[:-1]):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        model, m, v, loss, gnorm = step(model, m, v, batch, i)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        row = dict(step=i, ms=ms, loss=float(loss), grad_norm=float(gnorm),
                   tokens_per_s=B * S / (ms / 1e3),
                   real_tokens=int((batch["segments"] > 0).sum()),
                   mfu=cost["model_flops"] / (ms / 1e3) / HW().peak_flops_bf16)
        rows.append(row)
        print(f"lm train step {i}{' (warm-up)' if i == 0 else ''}: {ms:.1f} ms, "
              f"{row['tokens_per_s']:.0f} tokens/s ({row['real_tokens']} of {B * S} real), "
              f"model-FLOP share {row['mfu']:.4f} of {HW().peak_flops_bf16 / 1e12:.0f} "
              f"TFLOP/s bf16, loss {row['loss']:.6f}, grad norm {row['grad_norm']:.4f}; "
              f"card {card}", flush=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"lm train peak memory {peak:.2f} GB, of which {held_gb:.2f} GB held by earlier "
          f"phases: {peak - held_gb:.2f} GB for the model, m, v and the steps", flush=True)
    bad = [r for r in rows if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]))]
    if bad:
        raise AssertionError(f"non-finite loss or gradient norm: {bad}")
    timed = rows[1:]
    state = [model, m, v]

    def one_more_step():
        state[:] = step(*state, batches[-1], len(rows))[:3]

    profile = _lm_profile("lm train", one_more_step, min(r["ms"] for r in timed))
    # the optimizer's share: a step against value-and-grad alone on a batch
    # of the same shape
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    lm_value_and_grad(state[0], cfg, batches[-1])
    end.record()
    torch.cuda.synchronize()
    vg_ms = start.elapsed_time(end)
    print(f"lm train value-and-grad alone {vg_ms:.1f} ms: AdamW and the gradient norm take "
          f"{min(r['ms'] for r in timed) - vg_ms:.1f} ms of the fastest timed step", flush=True)
    out = dict(arch=cfg.name, params=n_params, model_flops=cost["model_flops"],
               flops=cost["flops"], peak_gb=peak, held_gb=held_gb, steps=rows, profile=profile,
               value_and_grad_ms=vg_ms,
               step_ms=[r["ms"] for r in timed], tokens_per_s=[r["tokens_per_s"] for r in timed],
               mfu=[r["mfu"] for r in timed], loss_bf16=loss16, loss_fp32=loss32)
    print(f"lm train summary: {json.dumps(out)}", flush=True)
    del model, m, v, step, state
    return out


def _lm_reduced_batch(cfg):
    """LM_REDUCED_BATCH bins of LM_REDUCED_SEQ tokens: documents of 3-19
    tokens packed by Algorithm 1, ids in the config's vocabulary."""
    rng = np.random.default_rng(SEED)
    packed = pack_documents(rng.integers(3, 20, size=60), LM_REDUCED_SEQ, LM_REDUCED_BATCH,
                            lambda d, ln: np.random.default_rng(d).integers(1, cfg.vocab, ln))
    return lm_pretrain.packed_batch(packed, 0, LM_REDUCED_BATCH, cfg, "cpu")


def _hold_lm_step(arch, got, want, lr):
    """One train step on the card against the CPU: Adam's moments
    everywhere, the parameters where the CPU's sqrt(v_hat) is 0 or above
    ``ADAM_HELD_EPS`` eps (Adam turns float32 rounding near |g| = eps into
    up to lr of an update), the rest within 2 lr.  Returns the count of
    parameters not held."""
    (gmodel, gm, gv), (wmodel, wm, wv) = got, want
    for name, g, w in (("m", gm, wm), ("v", gv, wv)):
        for k in w:
            torch.testing.assert_close(g[k].cpu(), w[k], rtol=LM_STEP_TOL, atol=LM_STEP_TOL,
                                       msg=lambda s: f"{arch} {name} {k}: {s}")
    wparams = dict(wmodel.named_parameters())
    unheld = 0
    for k, p in gmodel.named_parameters():
        g, w = p.detach().cpu(), wparams[k].detach()
        den = torch.sqrt(wv[k] / (1 - ADAM_B2))
        held = (den == 0) | (den > ADAM_HELD_EPS * ADAM_EPS)
        torch.testing.assert_close(g[held], w[held], rtol=LM_STEP_TOL, atol=LM_STEP_TOL,
                                   msg=lambda s: f"{arch} parameter {k}: {s}")
        if float((g - w).abs().max()) > 2 * lr + LM_STEP_TOL:
            raise AssertionError(f"{arch} parameter {k} moved {float((g - w).abs().max())}")
        unheld += int((~held).sum())
    return unheld


def lm_reduced_families(card, dev=None):
    """Phase 12 (b): every architecture's REDUCED config on the card
    against the CPU, from the same seeded parameters: one train step, then
    prefill and decode by graph replay."""
    dev = dev or torch.device("cuda")
    cpu = torch.device("cpu")
    want_census = 1 if dev.type == "cuda" else 0
    rows = {}
    for arch in LM_ARCH_IDS:
        t0 = time.perf_counter()
        cfg = get_lm_reduced(arch)
        init = lm.init_params(cfg, torch.Generator().manual_seed(SEED))
        batch = _lm_reduced_batch(cfg)
        prompts = batch["tokens"]
        stepped = []
        for d in (cpu, dev):
            model = copy.deepcopy(init).to(d)
            m, v = init_opt_state(model)
            model, m, v, loss, gnorm = make_lm_train_step(cfg, lr=LM_LR)(
                model, m, v, {k: t.to(d) for k, t in batch.items()}, 0)
            stepped.append((model, m, v, float(loss), float(gnorm)))
        (cm, cmm, cmv, closs, _), (gm, gmm, gmv, gloss, ggn) = stepped
        if not (np.isfinite(gloss) and np.isfinite(ggn)):
            raise AssertionError(f"{arch}: loss {gloss} grad norm {ggn}")
        np.testing.assert_allclose(gloss, closs, rtol=LM_STEP_TOL, atol=LM_STEP_TOL,
                                   err_msg=f"{arch} loss")
        unheld = _hold_lm_step(arch, (gm, gmm, gmv), (cm, cmm, cmv), LM_LR)

        engines = [LMServeEngine(copy.deepcopy(init).to(d), cfg, LM_REDUCED_BATCH,
                                 LM_REDUCED_SEQ, device=d) for d in (cpu, dev)]
        for eng in engines:
            eng.warmup()
        census = engines[1].compile_census()
        if census != {"prefill": want_census, "decode": want_census}:
            raise AssertionError(f"{arch}: census {census}")
        logit_err, tokens = 0.0, []
        for i in range(1 + LM_DECODE_STEPS):
            res = []
            for eng in engines:
                tok, logits = (eng.prefill(prompts.to(eng.device)) if i == 0
                               else eng.decode(LM_REDUCED_SEQ + i - 1))
                res.append((tok.cpu().clone(), logits.cpu().clone()))
            (ct, cl), (gt, gl) = res
            torch.testing.assert_close(gl, cl, rtol=LM_LOGITS_TOL, atol=LM_LOGITS_TOL,
                                       msg=lambda s: f"{arch} logits at step {i}: {s}")
            if not torch.equal(gt, ct):
                raise AssertionError(f"{arch}: greedy tokens differ at step {i}")
            logit_err = max(logit_err, float((gl - cl).abs().max()))
            tokens.append(gt[:, 0].tolist())
        for eng in engines:
            eng.close()
        rows[arch] = dict(loss=gloss, loss_cpu=closs, grad_norm=ggn, unheld=unheld,
                          logits_max_abs_err=logit_err, census=census,
                          s=time.perf_counter() - t0)
        print(f"lm {arch} reduced: loss card {gloss:.7f} cpu {closs:.7f}, grad norm {ggn:.5f}, "
              f"{unheld} parameters not held (Adam near eps), logits max abs err "
              f"{logit_err:.2e} over prefill + {LM_DECODE_STEPS} decode replays, census "
              f"{census}, greedy {tokens[:2]}... ({rows[arch]['s']:.1f}s)", flush=True)
    return rows


def lm_serve_full_width(card, argv=None):
    """Phase 12 (c): the serving entry point at the published width, then
    the first batch again by replay and eagerly, timed alike."""
    args = lm_serve_cli.parse_args(argv or LM_SERVE_ARGV)
    res = lm_serve_cli.serve(args)
    st, eng = res["stats"], res["engine"]
    dev = eng.device
    if st["census"] != {"prefill": 1, "decode": 1} and dev.type == "cuda":
        raise AssertionError(f"serving census {st['census']}")
    prompts = torch.from_numpy(res["prompts"][:args.batch]).to(dev)
    timed = {}
    for mode, eager in (("replay", False), ("eager", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = [eng.prefill(prompts, eager=eager)[0].clone()]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(LM_EAGER_TOKENS - 1):
            toks.append(eng.decode(args.prompt_len + i, eager=eager)[0].clone())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        timed[mode] = dict(prefill_ms=1e3 * (t1 - t0),
                           decode_ms_per_token=1e3 * (t2 - t1) / (LM_EAGER_TOKENS - 1),
                           tokens=torch.cat(toks, 1).cpu().numpy())
    served = res["tokens"][:args.batch, :LM_EAGER_TOKENS]
    for mode in timed:
        if not np.array_equal(timed[mode]["tokens"], served):
            raise AssertionError(f"{mode} greedy tokens {timed[mode]['tokens'].tolist()} differ "
                                 f"from the served run's {served.tolist()}")
    profiles = {mode: _lm_profile(f"lm decode {mode}", lambda eager=eager: eng.decode(
        args.prompt_len + LM_EAGER_TOKENS, eager=eager)) for mode, eager in
        (("replay", False), ("eager", True))}
    census = eng.compile_census()
    eng.close()
    out = dict(st, profiles=profiles, **{f"{m}_{k}": v for m, t in timed.items() for k, v in t.items()
                      if k != "tokens"})
    print(f"lm serve {st['arch']}: {args.requests} requests x {args.max_new} tokens in "
          f"{st['wall_s']:.2f}s, {st['tokens_per_s']:.1f} tokens/s; per batch prefill ms "
          f"{[round(x, 2) for x in st['prefill_ms']]}, decode ms per token "
          f"{[round(x, 3) for x in st['decode_ms_per_token']]}; first batch, "
          f"{LM_EAGER_TOKENS} tokens: replay prefill {timed['replay']['prefill_ms']:.2f} ms, "
          f"decode {timed['replay']['decode_ms_per_token']:.3f} ms/token; eager prefill "
          f"{timed['eager']['prefill_ms']:.2f} ms, decode "
          f"{timed['eager']['decode_ms_per_token']:.3f} ms/token; first {LM_EAGER_TOKENS} "
          f"greedy tokens equal (replay, eager, served); census {census}; warm-up "
          f"{st['warmup_s']:.1f}s; card {card}", flush=True)
    return out


def lm_phase(card):
    """Phase 12: (a) full-width training, (b) every family reduced, (c)
    full-width serving.  The LM path has no CUDA kernel of the four: their
    counts over the phase stay 0."""
    print(f"lm phase: {_free_device_memory():.2f} GB held after phase 11, "
          f"{threading.active_count()} threads alive", flush=True)
    t0 = time.perf_counter()
    _reset_launches()
    train = lm_train_full_width(card)
    print(f"lm phase: {_free_device_memory():.2f} GB held after (a)", flush=True)
    reduced = lm_reduced_families(card)
    serving = lm_serve_full_width(card)
    launches = _launches()
    if any(launches.values()):
        raise AssertionError(f"the LM path launched MACE kernels: {launches}")
    print(f"lm phase: {time.perf_counter() - t0:.1f}s; MACE kernel launches {launches}",
          flush=True)
    _free_device_memory()
    return dict(train=train, reduced=reduced, serving=serving)


# ---------------------------------------------------------------------------
# phase 13: the LM scaffold's multi-device half
# ---------------------------------------------------------------------------

# the architecture the JAX package runs manual DP for (its dry run's xlstm
# override); train_4k gives each rank 4,096 tokens, halved for the sLSTM's
# one Python step per token, and again each time a step passed 10 s (at
# 512 tokens this phase's steps took 14.5-19.3 s; PERF.md §6)
LM_DDP_ARCH = "xlstm_125m"
LM_DDP_DEVICE = "cuda"
LM_DDP_SEQ = 256
LM_DDP_R = 2
LM_DDP_STEPS = 3
LM_DDP_DEADLINE_S = 900
LM_DDP_LOSS_RTOL = 1e-5
DRYRUN_CELLS = [("granite_3_2b", "train_4k", "single"), ("granite_3_2b", "train_4k", "multi"),
                ("mace_cfm", "train_bins", "single")]
DRYRUN_TIMEOUT_S = 300


def _lm_ddp_batches(cfg, dev):
    """One batch per step: ``LM_DDP_R`` packed sequences of ``LM_DDP_SEQ``
    tokens (row r is rank r's)."""
    lengths, token_fn = lm_pretrain.synth_docs(400, cfg.vocab, seed=SEED)
    packed = pack_documents(lengths, LM_DDP_SEQ, LM_DDP_R, token_fn)
    return [lm_pretrain.packed_batch(packed, i, LM_DDP_R, cfg, dev) for i in range(LM_DDP_STEPS)]


def _bits_digest(tensors) -> list:
    """One integer per tensor from its bits (int32 view, position-weighted
    sum): equal tensors give equal digests."""
    out = []
    for t in tensors:
        bits = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out.append(int((bits * w).sum()))
    return out


def _lm_oracle_step(cfg, compress, state, batch, step_idx):
    """One step of the one-process oracle from ``state`` (model, m, v):
    each rank's gradient in turn on its rows, their float32 mean (plain:
    the sum over ranks, then / R, as gloo sums two ranks; compressed: the
    port's emulation of the int8 wire, one scale per ``stacked_groups``
    group), the loss's mean, and AdamW as ``make_lm_train_step_ddp``."""
    from repro_torch.launch.lm_train_step import _adamw_in_place, rank_rows, stacked_groups
    from repro_torch.train.engine import _emulated_compressed_mean_ef

    model, m, v = state
    per_rank = [lm_value_and_grad(model, cfg, rank_rows(batch, r, LM_DDP_R))
                for r in range(LM_DDP_R)]
    loss = sum(l.to(torch.float32) for l, _ in per_rank) / LM_DDP_R
    names = list(per_rank[0][1])
    if compress:
        grads = {}
        for group in stacked_groups(cfg, names):
            g = torch.stack([torch.stack([gr[n].to(torch.float32) for n in group])
                             for _, gr in per_rank])
            mean, _ = _emulated_compressed_mean_ef(g, torch.zeros_like(g))
            grads.update(zip(group, mean.unbind(0)))
    else:
        grads = {n: sum(gr[n].to(torch.float32) for _, gr in per_rank) / LM_DDP_R for n in names}
    _adamw_in_place(adamw(LM_LR, weight_decay=0.1), model, m, v, grads, step_idx)
    return model, m, v, loss


def lm_ddp_rank(cfg) -> int:
    """One process of phase 13 (a) or (b) (``chip_smoke.py --lm-ddp-rank
    CFG``), under phase 9's deterministic settings.  ``cfg["role"]`` is
    ``"rank"`` (a gloo group of ``LM_DDP_R``, ``cfg["compress"]``'s run from
    ``SEED``'s weights; rank 0 then holds every step against the oracle)
    or ``"nccl"`` (a world of one: one plain DDP step against
    ``make_lm_train_step``).  Writes ``cfg["out"]/rank<r>.json``."""
    import repro_torch.launch.lm_train_step as lts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.autograd.set_multithreading_enabled(False)
    dev = torch.device(LM_DDP_DEVICE)
    lm_cfg = get_lm_config(LM_DDP_ARCH)
    backend = "gloo" if cfg["role"] == "rank" else "nccl"
    initialize_distributed(backend=backend, timeout_s=DP_COLLECTIVE_TIMEOUT_S)
    rank = dist.get_rank()
    batches = _lm_ddp_batches(lm_cfg, dev)
    out = Path(cfg["out"])

    def fresh():
        model = lm.init_params(lm_cfg, torch.Generator(dev).manual_seed(SEED), dev)
        return [model, *init_opt_state(model)]

    _reset_launches()
    if cfg["role"] == "nccl":
        batch = lts.rank_rows(batches[0], 0, LM_DDP_R)
        want = fresh()
        want_loss = make_lm_train_step(lm_cfg, lr=LM_LR)(*want, batch, 0)[3]
        got = fresh()
        got_loss = make_lm_train_step_ddp(lm_cfg, lr=LM_LR)(*got, batch, 0)[3]
        n = _count_lm_states(got, want, 1)
        (out / "rank0.json").write_text(json.dumps(dict(
            loss=float(got_loss), want_loss=float(want_loss), counts=n, launches=_launches())))
        dist.destroy_process_group()
        return 0

    timed_reduce = []
    average = lts.average_gradients

    def timed_average(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = average(*args, **kwargs)
        end.record()
        torch.cuda.synchronize()
        timed_reduce.append(start.elapsed_time(end))
        return res

    lts.average_gradients = timed_average
    compress = cfg["compress"]
    state = fresh()
    step = make_lm_train_step_ddp(lm_cfg, lr=LM_LR, compress=compress)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, saved = [], []
    for i, batch in enumerate(batches):
        if rank == 0:  # the step's own state, for the oracle after the run
            saved.append([copy.deepcopy(state[0]).cpu(),
                          *({k: t.cpu() for k, t in d.items()} for d in state[1:])])
        dist.barrier()  # both ranks start the timed step together
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        model, m, v, loss, gnorm = step(*state, batch, i)
        end.record()
        torch.cuda.synchronize()
        state = [model, m, v]
        rows.append(dict(ms=start.elapsed_time(end), loss=float(loss), grad_norm=float(gnorm),
                         allreduce_ms=timed_reduce[-1]))
    peak = torch.cuda.max_memory_allocated()
    digest = _bits_digest([p for _, p in state[0].named_parameters()]
                          + list(state[1].values()) + list(state[2].values()))
    oracle = []
    if rank == 0:
        def load(s):
            return [s[0].to(dev), *({k: t.to(dev) for k, t in d.items()} for d in s[1:])]

        for i, batch in enumerate(batches):
            *want, want_loss = _lm_oracle_step(lm_cfg, compress, load(saved[i]), batch, i)
            got = state if i == len(batches) - 1 else load(saved[i + 1])
            oracle.append(dict(loss=float(want_loss), counts=_count_lm_states(got, want, i + 1)))
    (out / f"rank{rank}.json").write_text(json.dumps(dict(
        rows=rows, peak_bytes=peak, digest=digest, oracle=oracle, launches=_launches())))
    dist.destroy_process_group()
    return 0


def _count_lm_states(got, want, step):
    """``got`` (model, m, v) against ``want``: m and v beyond 2e-4
    everywhere, the parameters beyond it where ``want``'s Adam denominator
    sqrt(v_hat) is 0 or above ``ADAM_HELD_EPS`` eps (the rest counted)."""
    n = dict(over=0, held=0, free=0, free_over=0, all=0, worst=0.0)
    wparams = dict(want[0].named_parameters())
    for name, p in got[0].named_parameters():
        for g, w, mask in ((got[1][name], want[1][name], None), (got[2][name], want[2][name], None),
                           (p.detach(), wparams[name].detach(), "adam")):
            over = (g - w).abs() > LM_STEP_TOL + LM_STEP_TOL * w.abs()
            if mask is None:
                held = torch.ones_like(over)
            else:
                den = torch.sqrt(want[2][name] / (1 - ADAM_B2 ** step))
                held = (den == 0) | (den > ADAM_HELD_EPS * ADAM_EPS)
            n["over"] += int((over & held).sum())
            n["held"] += int(held.sum())
            n["free"] += int((~held).sum())
            n["free_over"] += int((over & ~held).sum())
            n["all"] += over.numel()
            n["worst"] = max(n["worst"], float((g - w).abs().max()))
    return n


def _spawn_lm_ddp(root, name, n_procs, **cfg):
    """Start one group of ``lm_ddp_rank`` processes; returns a function
    that waits for it and reads each one's record."""
    out = Path(root) / name
    out.mkdir()
    t0 = time.perf_counter()
    group = spawn_local(n_procs, [sys.executable, str(Path(__file__).resolve()), "--lm-ddp-rank",
                                  json.dumps(dict(cfg, out=str(out)))],
                        env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}, log_dir=str(out / "logs"))

    def wait():
        codes = group.wait(timeout=LM_DDP_DEADLINE_S)
        if codes != [0] * n_procs:
            for p in group.procs:
                print(f"{name} process {p.process_id} log tail:\n"
                      f"{Path(p.log_path).read_text()[-4000:]}", flush=True)
            raise AssertionError(f"{name}: processes exited {codes}")
        print(f"{name}: {n_procs} process(es) done in {time.perf_counter() - t0:.1f}s",
              flush=True)
        return [json.loads((out / f"rank{r}.json").read_text()) for r in range(n_procs)]

    return wait


def lm_ddp(card):
    """Phase 13 (a), the plain and the compressed group, and (b), all at
    once (5 processes on the card)."""
    with tempfile.TemporaryDirectory() as root:
        waits = {mode: _spawn_lm_ddp(root, f"lm_ddp_{mode}", LM_DDP_R, role="rank",
                                     compress=mode == "compressed")
                 for mode in ("plain", "compressed")}
        wait_nccl = _spawn_lm_ddp(root, "lm_ddp_nccl", 1, role="nccl")
        runs = {mode: wait() for mode, wait in waits.items()}
        (one,) = wait_nccl()
    for mode, recs in runs.items():
        losses = [[row["loss"] for row in rec["rows"]] for rec in recs]
        if any(rec["digest"] != recs[0]["digest"] for rec in recs) or \
                any(ls != losses[0] for ls in losses):
            raise AssertionError(f"lm ddp {mode}: the ranks are not bit-identical replicas")
        for r, rec in enumerate(recs):
            ms = [row["ms"] for row in rec["rows"]]
            print(f"lm ddp {mode} rank {r}: step_ms={[round(x, 1) for x in ms]} "
                  f"allreduce_ms={[round(row['allreduce_ms'], 2) for row in rec['rows']]} "
                  f"tokens_per_s={[round(LM_DDP_SEQ / (x / 1e3), 1) for x in ms]} "
                  f"(one rank's {LM_DDP_SEQ}; the group's is {LM_DDP_R}x) "
                  f"peak_memory_allocated_gb={rec['peak_bytes'] / 1e9:.2f} "
                  f"losses={losses[r]}; card {card}", flush=True)
        for i, (row, orc) in enumerate(zip(recs[0]["rows"], recs[0]["oracle"])):
            err = abs(row["loss"] - orc["loss"]) / abs(orc["loss"])
            n = orc["counts"]
            print(f"lm ddp {mode} step {i} against the oracle from the step's state: loss "
                  f"{row['loss']:.7f} vs {orc['loss']:.7f} (rel {err:.2e}, tol "
                  f"{LM_DDP_LOSS_RTOL:g}); {n['over']} of {n['held']} held elements "
                  f"beyond {LM_STEP_TOL:g}, {n['free']} not held (Adam near eps), "
                  f"{n['free_over']} of them beyond; worst {n['worst']:.3e}", flush=True)
            if err > LM_DDP_LOSS_RTOL or n["over"]:
                raise AssertionError(f"lm ddp {mode} step {i} differs from the oracle")
    err = abs(one["loss"] - one["want_loss"]) / abs(one["want_loss"])
    n = one["counts"]
    print(f"lm ddp nccl world of one: loss {one['loss']:.7f} vs make_lm_train_step's "
          f"{one['want_loss']:.7f} (rel {err:.2e}); {n['over']} of {n['held']} held elements "
          f"beyond {LM_STEP_TOL:g}, {n['free']} not held; card {card}", flush=True)
    if err > LM_DDP_LOSS_RTOL or n["over"]:
        raise AssertionError("the NCCL DDP step differs from make_lm_train_step")
    return runs, [rec["launches"] for recs in runs.values() for rec in recs] + [one["launches"]]


def dryrun_cells(card):
    """Phase 13 (c): each of ``DRYRUN_CELLS`` as ``python -m
    repro_torch.launch.dryrun`` (one fake world each), all at once, each
    with its own results file."""
    env = dict(os.environ, PYTHONPATH=str(SRC_DIR))
    t0 = time.perf_counter()
    recs = {}
    with tempfile.TemporaryDirectory() as root:
        procs = {}
        for arch, shape, mesh in DRYRUN_CELLS:
            path = Path(root) / f"{arch}-{shape}-{mesh}.json"
            procs[(arch, shape, mesh)] = (path, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                 shape, "--mesh", mesh, "--results", str(path)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for (arch, shape, mesh), (path, proc) in procs.items():
            try:
                _, err = proc.communicate(timeout=max(1.0, DRYRUN_TIMEOUT_S - (
                    time.perf_counter() - t0)))
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            rec = json.loads(path.read_text()).get(f"{arch}|{shape}|{mesh}") \
                if path.exists() else None
            if rec is None:
                raise AssertionError(f"dryrun {arch} {shape} {mesh} recorded nothing: {err[-2000:]}")
            coll = rec.get("collectives_per_device", {})
            mem = rec.get("memory_per_device", {})
            print(f"dryrun {arch} {shape} {mesh}: ok={rec['ok']} trace_s={rec.get('trace_s')} "
                  f"wall_s={rec.get('wall_s')} argument_gb={mem.get('argument_gb')} (placements "
                  f"{mem.get('argument_gb_from_placements')}) flops_per_device="
                  f"{rec.get('cost_analysis', {}).get('flops')} collectives_per_device="
                  f"{json.dumps(coll)} counts={json.dumps(rec.get('collective_counts'))} roofline="
                  f"{json.dumps({k: v for k, v in rec.get('roofline', {}).items() if k != 'recommendation'})}"
                  f"; card {card}", flush=True)
            needed = coll.get("total", 0) if shape.startswith("decode") else coll.get("all-reduce", 0)
            if (proc.returncode or not rec["ok"] or needed <= 0 or coll.get("total", 0) <= 0
                    or rec["cost_analysis"]["flops"] <= 0
                    or mem["argument_gb"] != mem["argument_gb_from_placements"]):
                raise AssertionError(f"dryrun {arch} {shape} {mesh}: {rec.get('error')} {err[-2000:]}")
            recs[(arch, shape, mesh)] = rec
    print(f"dryrun cells, at once: {time.perf_counter() - t0:.1f}s", flush=True)
    return recs


def lm_multi_device_phase(card):
    """Phase 13: (a) and (b) the DDP step, (c) the dry run.  Launches none
    of the four CUDA kernels: every one of its processes (the DDP ranks,
    the dry-run cells and this one) reports its counts, summed here."""
    t0 = time.perf_counter()
    _free_device_memory()
    _reset_launches()
    ranks, rank_launches = lm_ddp(card)
    t1 = time.perf_counter()
    recs = dryrun_cells(card)
    counts = [_launches()] + rank_launches + [rec["kernel_launches"] for rec in recs.values()]
    if any(set(c) != set(KERNELS) for c in counts):
        raise AssertionError(f"a process of phase 13 did not report the four kernels: {counts}")
    launches = {k: sum(c[k] for c in counts) for k in KERNELS}
    if any(launches.values()):
        raise AssertionError(f"the multi-device LM path launched MACE kernels: {counts}")
    print(f"lm multi-device phase: {time.perf_counter() - t0:.1f}s ((a)+(b) {t1 - t0:.1f}s, "
          f"(c) {time.perf_counter() - t1:.1f}s); MACE kernel launches {launches}, summed over "
          f"its {len(counts)} processes ({len(rank_launches)} DDP, {len(recs)} dry-run, this "
          f"one)", flush=True)
    return ranks, recs


def kernel_units():
    """(label, (source, header)) of the nine kernel libraries: the
    symmetric contraction's spec and both layers' tensor-product specs, each
    at every precision."""
    units = []
    for p in PRECISIONS:
        units += [(f"symcon {p}", u) for u in sck.build_units([CONFIG.symcon_spec()], [p])]
        units += [(f"tp layer {layer} {p}", u)
                  for layer in range(CONFIG.n_interactions)
                  for u in tpk.build_units([CONFIG.tp_spec_at(layer)], [p])]
    return units


def kernel_entries(results, training, identity, launches, train, train_profile,
                   variant_launches, bf16_training_launches, identity_launches,
                   dp_launches, serving_profile, graph_rows, autotune_launches,
                   elastic_launches):
    """The ``kernels`` JSON line: each kernel at fp32 (the serving run's
    launches, all of them through graph replays, with its launches per
    replay of each bucket's graph, the serving profile's launches recorded
    and made, its training-step numbers and the data-parallel runs'
    launches summed over their ranks), at bf16 and fp8 (the launches of the
    serving run at that precision; bf16 also the variant training run's),
    and the identity-blocked interaction kernels (the unblocked bin's
    launches).  The fp32 entries also carry the autotune phase's launches
    (its "auto" training run and its "auto" server) and the elastic phase's
    (each part's run: the in-process rescale, the three restart runs, the
    relaunched rank of each supervised drill)."""
    entries = []
    for name, spec in KERNELS.items():
        common = dict(route="cuda", source=spec["source"], replaces=spec["replaces"])
        for p in PRECISIONS:
            res, rows = results[(name, p)], training[(name, p)]
            entry = dict(
                name=name if p == "fp32" else f"{name}_{p}", precision=p, **common,
                launches=launches[name] if p == "fp32" else variant_launches[p][name],
                max_abs_err=res["max_abs_err"], ms=res["ms"], plain_ms=res["plain_ms"],
                bound_ms=res["bound_ms"], bound_by=res["bound_by"],
                library_ms=res["library_ms"], device_ms=res["device_ms"],
                per_layer_device_ms=res["per_layer_device_ms"],
                per_layer_share_of_bound=res["per_layer_share_of_bound"],
                device_launches_recorded=res["device_launches_recorded"],
                device_launches_made=res["device_launches_made"],
                train_bin_max_abs_err=max(r["err"] for r in rows),
                train_bin_ms=[r["ms"] for r in rows],
                train_bin_device_ms=[r["device_ms"] for r in rows],
                train_bin_bound_ms=[r["bound"] for r in rows],
                train_bin_device_launches_recorded=[r["recorded"] for r in rows])
            if p == "fp32":
                entry.update(
                    training_launches=train["launches"][name],
                    training_launches_per_step=[r["launches"][name] for r in train["rows"]],
                    training_device_ms_per_step=train_profile[name]["device_ms"],
                    training_device_launches_recorded=train_profile[name]["recorded"],
                    training_device_launches_made=train_profile[name]["made"],
                    data_parallel_launches={run: n[name] for run, n in dp_launches.items()},
                    replay_launches_per_bin={b: r["replay_launches"][name]
                                             for b, r in graph_rows.items()},
                    serving_device_launches_recorded=serving_profile[name][0],
                    serving_device_launches_made=serving_profile[name][1],
                    autotune_launches={run: n[name] for run, n in autotune_launches.items()},
                    elastic_launches={run: n[name] for run, n in elastic_launches.items()})
            elif p == "bf16":
                entry.update(training_launches=bf16_training_launches[name])
            entries.append(entry)
        if name in identity:
            rows = identity[name]
            res = _summed(rows)
            entries.append(dict(
                name=f"{name}_identity", precision="fp32", **common,
                launches=identity_launches[name], max_abs_err=res["max_abs_err"],
                ms=res["ms"], plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
                bound_by=res["bound_by"], library_ms=None,
                device_ms=sum(r["device_ms"] for r in rows),
                per_layer_device_ms=[r["device_ms"] for r in rows],
                per_layer_share_of_bound=[r["bound"] / r["device_ms"] for r in rows],
                device_launches_recorded=sum(r["recorded"] for r in rows)))
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--dp-rank"]:
        return dp_rank(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--elastic-run"]:
        return elastic_run(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--lm-ddp-rank"]:
        return lm_ddp_rank(json.loads(sys.argv[2]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}; card: {card}", flush=True)

    t_start = t0 = time.perf_counter()
    units = kernel_units()
    cuda_lib.build([unit for _, unit in units])
    print(f"{len(units)} kernel libraries built in {time.perf_counter() - t0:.1f}s", flush=True)
    for label, unit in units:
        library = cuda_lib.library_path(*unit).stem
        for kernel, report in _ptxas_report(cuda_lib.build_logs[library]).items():
            print(f"ptxas {library} ({label}) {kernel}: {report}")
            stack_or_spill = re.findall(r"(\d+) bytes (?:stack frame|spill)", report)
            if any(int(n) for n in stack_or_spill):
                raise AssertionError(f"{kernel} ({label}) uses a stack frame or spills: {report}")
    check_rounding(dev)

    kernel_results = check_kernels(dev)
    tr = _trainer(TRAIN_ATOMS, None)  # device None: the CUDA card
    blk = first_bin_blocking(tr)
    training_results = check_training_size(dev, blk)
    identity_results = check_identity_launch(dev, tr.bin_shape.max_edges)

    params = init_mace(CONFIG, torch.Generator().manual_seed(SEED))
    mols = skewed_requests()
    results, stats, launches, buckets = serve(params, mols)
    print(f"serve: {stats['served']} graphs in {stats['wall_s']:.3f}s "
          f"graphs_per_s={stats['graphs_per_s']:.2f} "
          f"p50_ms={stats['latency_p50_ms']:.1f} p99_ms={stats['latency_p99_ms']:.1f} "
          f"bins={stats['bucket_bins']} launches={launches}", flush=True)
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"the serving run launched no {missing}")
    graph_rows = check_graphs(params, mols, buckets)
    serve_drills()
    train = train_steps(tr)
    variant_launches = serve_at_precisions(params, mols, results)
    identity_launches = check_paths_and_impls(dev, params, mols, buckets[-1])
    bf16_training_launches = train_variants(train["history"])

    serving_profile = profile_serving(params, mols)
    time_kernels(kernel_results, {**training_results, **identity_results})
    train_profile = profile_train_step(tr, [r["ms"] for r in train["rows"]])
    checkpoint_round_trip(tr)
    compare_with_cpu(params, mols, results, buckets)
    compare_training_with_cpu()
    dp_launches = data_parallel(card, train["history"][0]["loss"])

    t0 = time.perf_counter()
    tune_s = tune_and_check(card)
    autotune_launches = {"training": train_auto(card),
                         "serving": serve_auto(params, mols, results, card)}
    print(f"geometry: {json.dumps(compare_geometries(params, mols, card))}", flush=True)
    print(f"autotune phase: {time.perf_counter() - t0:.1f}s, of which tuning "
          f"{tune_s:.1f}s", flush=True)
    elastic_launches = elastic_phase(card)
    lm_phase(card)
    lm_multi_device_phase(card)

    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernel_entries(
        kernel_results, training_results, identity_results, launches, train,
        train_profile, variant_launches, bf16_training_launches, identity_launches,
        dp_launches, serving_profile, graph_rows, autotune_launches, elastic_launches)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
