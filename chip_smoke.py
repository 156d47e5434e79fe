#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase catches its own error):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA source of the port with nvcc, in parallel, timed,
   and each local-sort kernel's registers, shared memory and spills as
   ``ptxas -v`` reports them;
3. every RAMS kernel at the shapes of the main path at p = 256, n = 2^26
   (sort and merge on (256, 2 196 992) with an int32 payload, partition on
   (256, 1 048 576) with nb = 64, every classify variant): equal to its
   plain PyTorch version on the card, timed with CUDA events (kernel,
   plain, library call) beside its bound; the whole local sort on full
   rows and at the main path's occupancy (about 2^18 valid keys per row, a
   tail of pad words), and on all-equal keys;
3b. the k-way classifier at the shapes of the external lane (C = 2^25
   with nb = 16 for pass C, C = 2^21 with nb = 8 for pass D), with
   sorted splitter keys and ties in no order (C = 2^25, nb = 2, 128,
   2048), with splitters in random order (nb = 2048, which every block
   sorts) and with more splitters than one shared-memory tree holds
   (nb = 2^16): bucket and
   histogram equal to the plain version's; its device time per launch
   (``torch.profiler`` over back-to-back calls, which also counts the
   device operations of a call), the host-clock time per call and CUDA
   events around one call, beside its bound (bytes 12·C + 4·nb +
   8·(nb − 1), compares C·⌈log2 nb⌉), the plain version and the library's
   ``torch.searchsorted`` of the int64 composites over sorted splitters;
4. ``psort`` end to end on the card with RAMS at p = 256, n = 2^26 uint32
   keys, on Uniform, Zero and AllToOne: wall time after a warm-up run, peak
   device memory, balance, overflow and kernel launches, with the output
   checked (nondecreasing, n − overflow elements, ``perm`` a partial
   permutation with ``input[perm] == output``, equal to ``np.sort`` where
   nothing overflowed, every RAMS kernel launched);
5. the card and the CPU (plain versions) agree bit for bit at p = 64,
   n = 2^20 Uniform, where the reference drops 3442 keys;
6. ``psort`` through the external lane at p = 16, n = 2^27 uint32 keys,
   budget 2^21 (4 runs per PE, the classifier engine), on Uniform after
   a warm-up: wall time, keys/s, peak device memory, peak host RSS,
   host-clock seconds of passes A–D and kernel launches, with the output
   checked (overflow 0, equal to ``torch.sort`` of the input on the card,
   ``perm`` a permutation with ``input[perm] == output``, the classifier
   and the local-sort kernels launched);
7. the card and the CPU agree bit for bit on the external lane at p = 16,
   n = 2^20, budget 2^13, and double buffering off equals on;
8. RQuick at p = 2^18 emulated PEs, n = 2^26 uint32 keys (n/p = 2^8):
   its two kernels at the shapes of that path (``tile_sort`` on
   (2^18, 1024) rows with an int32 payload and 2^8 to 2^10 valid keys per
   row; ``partition_classify`` with nb = 2 on the lifted key planes, every
   variant of the inclusive pass and the strict pass's histogram) against
   their plain versions, timed beside their bounds;
   ``psort(algorithm="rquick")`` end to end on Uniform and Zero after a
   warm-up on 2^22 of the keys, with the checks of phase 4; and the card
   against the CPU bit for bit for ``rquick`` and ``ntb-quick`` at p = 64,
   n = 2^18;
9. printed last, after phase 14: one ``kernels`` JSON line (a row per
   kernel, classify variant, path and shape, NTB-AMS's at RAMS's, every
   row of phase 3b, and the streamed paths of phase 14 at their barrier
   paths' shapes, with each variant's launches in that path's run), the
   card line, and the ``ok`` line;
10. the other algorithms, each at its regime: every kernel of those
   paths at the shapes each path gives it (every ``partition_classify``
   variant with nb = p = 256 at SSort's (256, 2^20) and NS-SSort's
   (256, 2^19), ~2^18 valid keys per row, and the buckets-only variant at
   SSort's shape on the (hi, lo) planes of int64 keys; ``tile_sort`` and one
   ``run_merge`` pass at (256, 2^19) with 2^18 valid keys per row, the
   first sort of every path and both of bitonic's, and at SSort's
   (256, p·slot_cap) after the shuffle and the route; ``tile_sort`` at
   RFIS's (2^18, 4) and (2^18, 2048) and GatherM's (2^12, 4) rows), each
   against its plain version and timed beside its bound; then ``psort``
   after a warm-up with RFIS at p = 2^18, n = 2^18 (n/p = 1), GatherM and
   AllGatherM at p = 2^12, n = 2^9 (n/p = 2^-3; the sim layout holds
   p·p·capacity slots), each on Uniform and Zero, and SSort, NS-SSort,
   bitonic and NTB-AMS at p = 256, n = 2^26 on Uniform and Zero (where
   the non-robust ones overflow, as the reference does), with the checks
   of phase 4 and each path's kernels launched; and the card
   against the CPU bit for bit for ``ssort``, ``ns-ssort`` and
   ``bitonic`` at p = 64, n = 2^18, ``ntb-ams`` at p = 64, n = 2^20,
   ``rfis`` at p = 2^10, n = 2^12,
   ``gatherm`` and ``allgatherm`` at p = 2^8, n = 2^5;
11. 8-byte keys: the card against the CPU bit for bit on int64, uint64
   and float64 keys for the eight algorithms that take them (``rquick``,
   ``ntb-quick``, ``rfis``, ``ssort``, ``ns-ssort``, ``bitonic``,
   ``gatherm``, ``allgatherm``) at the check sizes of phases 8 and 10;
   then each sorts int64 Uniform keys at its phase-8 or phase-10 cell
   (RQuick and NTB-Quick at p = 2^16, n = 2^24, that cell's n/p: cut
   from p = 2^18, n = 2^26) with
   the checks of phase 4 (RFIS at p = 2^16, n = 2^16 first; it keeps the
   cut, and says so, when 8x that peak would pass 70 GB at p = 2^18);
12. collective traces (``trace_collectives``): on the card equal to the
   CPU's, event for event, for every algorithm at the card-vs-CPU check
   sizes and the external lane at phase 7's; then one ``table1`` JSON line,
   the paper's Table I taken on the card: launches, point-to-point
   launches, fused launches and wire bytes per PE (and the lane's
   host-device bytes) at each path's cell;
13. selection: the committed profile (``repro_torch/profiles/h100-sim.json``,
   the port's ``DEFAULT_MODEL``), which must name an H100, its constants
   and its regime tables at p = 2^8, 2^12 and 2^18; a fresh profile from
   phase 1 of ``tools/calibrate_torch.py`` at p = 2^6 and 2^8 beside it
   (every constant finite and positive, ``overlap`` in [0, 1]); then
   ``psort(algorithm="auto")`` at the cells of RAMS, RQuick (cut to
   p = 2^16, n = 2^24), RFIS and GatherM above on Uniform keys, bit for
   bit equal to the algorithm it
   picked, with both wall times (a pick whose reckoned peak passes 60 GB
   is printed with that size and not run);
14. the streamed exchange (``overlap=True``) against the barrier path, bit
   for bit, with both wall times, peaks and launches: RAMS and SSort at
   p = 256, n = 2^26 on Uniform and Zero (first the local sort's kernels
   at the shapes of the blocks they sort there), and the external lane at
   p = 16, n = 2^20, budget 2^13 (also against the CPU); the card against
   the CPU for ``rams`` and ``ssort`` at p = 64, n = 2^20; and phase 12's
   trace check with ``overlap=True``, its ``ovl:`` chunk events included.

15. batched keys and nested meshes: the RAMS kernels at the batched RAMS
   cell's shapes (1024 rows: ``tile_sort`` and a ``run_merge`` pass on
   level 0's route output, every classify variant and ``partition_rank``
   with nb = 64), as phase 3 times them; batched RAMS, d = 4 rows of
   n = 2^24 at p = 256 (the RAMS cell's state), on four Uniform rows and
   on [Uniform, Zero, AllToOne, Staggered], after a warm-up: wall, peak,
   each row's overflow and the launches, every row bit for bit its 1-D
   sort on the card (keys, perm, counts, overflow) with the checks of
   phase 4, and the four 1-D walls beside the batched one; batched
   RQuick, d = 4 rows of n = 2^24 at p = 2^16 (the RQuick cell's rows),
   rows 0 and 1 against their 1-D sorts; nested RAMS at p = 256,
   n = 2^26 on the meshes (16, 16) (schedule [4, 4]) and (4, 64) ([2, 3,
   3]), each bit for bit the flat sort on its schedule, both walls and
   peaks, its trace on the card equal to the CPU's at n = 2^18 and its
   inter/intra bytes and inter-axis ``all_to_all`` tags at the cell; the
   card against the CPU bit for bit for the ten algorithms batched
   (d = 2, p = 16, n = 2^14), nested on (2, 8), batched and nested, and
   RAMS and SSort batched with ``overlap=True``.  The ``kernels`` line
   gains the rows of ``rams-batched``, ``rquick-batched`` (phase 8's
   shapes) and ``rams-nested`` (phase 3's), with their runs' launches.
16. query serving (``repro_torch.core.queries``, ``SortService``) over the
   RAMS cell's data: ``tile_sort`` and a ``run_merge`` pass at the
   ingest's (256, 2^18) full rows of keys, against their plain versions;
   ``shard_data`` at p = 256, n = 2^26 Uniform uint32 (wall, peak, its
   launches, rows equal to the library's row sort); every query kind bit
   for bit against one ``torch.sort`` of the keys on Uniform, Zero and
   Staggered uint32 and int64 Uniform (``select_rank`` over 64 ranks with
   the window on and off, ``percentile``, ``top_k`` for k = 1 … 64 and
   4096, ``rank_of_key``, ``range_query``); per batch on Uniform the
   median wall of 5 after a warm-up, its host syncs (``torch.profiler``)
   and peak, beside phase 4's RAMS wall; the reference CLI's stream of 512
   queries through ``SortService`` under ``selection``, ``fullsort``
   (bitonic's sorted copy: RAMS drops keys at this cell) and ``auto``,
   p50/p99 per kind and queries/s, every answer against the oracle; and
   the card against the CPU at p = 64, n = 2^20 (every kind on uint32,
   int64, uint64 and float64 keys, the service under ``selection`` and
   ``fullsort``, ``trace_query`` for every kind and key width).  The
   ``kernels`` line gains the ``serve-ingest`` rows with the ingest's
   launches.
17. faults and elastic rescale (``SortConfig(fault_policy=...)``): the
   card against the CPU bit for bit (output, counts, overflow, perm, the
   fault record, the attempts and every trace event) for the reference's
   fast-lane cases at p = 8 (a kill and a straggler for GatherM,
   AllGatherM, RFIS, RQuick, RAMS, bitonic and SSort; the nested (2, 4)
   kill; batched RQuick; ``"auto"``; two kills; the exhausted budget) and
   for the external lane at p = 16, n = 2^20 (kills in ``ext:merge`` and
   ``ext:pass1``, a rescale that crosses into the lane); a kill in RAMS's
   ``level1`` at p = 256, n = 2^25 and a straggler there, each equal bit
   for bit to the fault-free sort at p = 128, with each attempt's wall,
   the total against that sort's wall, the rescaled attempt's peak against
   its peak, each over the allocation before its call (at most 5 % more),
   and every RAMS kernel launched; and the
   RAMS cell (p = 256, n = 2^26) with that kill, whose rescale to p = 128
   is refused (capacity 2^20), as the reference's, with the memory
   released.  The ``kernels`` line gains the ``rams-fault`` rows (the RAMS
   kernels at the rescaled attempt's shapes) with the killed run's
   launches.
18. the distributed backend (``backend="shard_map"``): (a) eight ranks of
   one gloo group spawned on the card (p = 8; gloo moves CUDA tensors
   through the host, so the walls are of eight processes sharing one
   card, not a multi-GPU figure) sort with each of the ten algorithms on
   Uniform at n = 2^23 (RAMS and NTB-AMS at 2^21, their
   capacity limit); (b) on the same ranks batched RQuick (d = 2 rows of
   2^22 on a (2, 4) mesh), nested RAMS on (2, 4), ``overlap=True`` for
   RAMS and SSort, ``shard_data`` of 2^22 keys with a batch of 64
   ``select_rank``, and
   RQuick on ``sort_mesh(p=4, exclude=(3, 5, 6, 7))``, the excluded
   ranks joining only its making; (c) one NCCL rank (p = 1), the eight
   algorithms that take 2^24 keys there and RAMS and NTB-AMS at 2^18.
   Each equal bit for bit to the sim backend on the card at the same p
   (a digest of keys, perm, counts and overflow on rank 0, every rank's
   counts, rank 0's trace event for event), with each rank's launches,
   wall and peak; the ``kernels`` line gains the ``dist-*`` and
   ``nccl-*`` rows (each kernel at one rank's shapes, the launches summed
   over the path's ranks).  ``--dist-only`` runs phases 1, 2 and 18
   alone.
19. the model-serving stack (``repro_torch.models``, ``launch.serve``,
   ``data.pipeline``): (a) ``serve`` of granite-moe-1b-a400m at full size
   (batch 32, 64 steps over a 1024-slot bf16 cache: p50/p99 step ms,
   tok/s, peak), one step under ``torch.profiler`` (device busy time and
   operations, idle share, host syncs), and the card against the CPU at
   full width and depth 2 in float32 (tokens equal, logits within the CPU
   tests' 1e-4/1e-5); (b) every architecture at full width, its depth cut
   where weights and cache reckon past 40 GB: one forward over (2, 2048)
   and 8 decode steps, logits finite with the reference's shapes;
   llama3.2-1b's teacher-forced decode against prefill in float32 at full
   size; the serving CLI's default architecture in a subprocess; (c) one
   granite MoE layer on x (8, 2048, 1024): ``moe_local`` and
   ``moe_ep_sim`` at (1, 8) and (1, 32) against ``moe_dense`` in float32
   with nothing dropped, the skewed router's drops, each layout's wall,
   peak and host syncs in bf16; (d) four gloo ranks on a (data 2, model
   2) mesh: ``moe_ep_shardmap`` equal bit for bit to ``moe_ep_sim(d=2,
   ep=2)``, ``moe_tp_shardmap`` against ``moe_local``; (e)
   ``length_balanced_batches`` on 2^26 lengths at p = 256 with
   ``"auto"``, ``"rams"`` (RAMS drops keys there, so the batching
   refuses as the reference's does) and ``"bitonic"``, and the card
   against the CPU at p = 64, n = 2^20.  The ``kernels`` line gains the
   ``lbb`` rows (RAMS's kernels with the batching's launches).
   ``--model-only`` runs phases 1, 2 and 19 alone.
20. the training stack (``repro_torch.launch.train``, ``optim``,
   ``runtime.checkpoint``): (a) ``train`` of granite-moe-1b-a400m at full
   width and 4 of its 24 layers (cut to 12 when phase 21 joined, to 6
   when phase 22 did and then to 4, for the script's time limit; bf16,
   remat ``full``,
   AdamW, batch 8 × seq 2048 from
   ``TokenPipeline``) for 10 steps, a checkpoint every 5 and a crash
   injected at step 8 (for the script's time limit): each
   step's loss (finite), p50/p99 step ms
   (host walls of an eager step), tokens/s and peak, the restart from
   step 5 and ``latest_step()`` 10, the restored state equal bit for bit
   to the saved leaves, and one step under ``torch.profiler`` (device
   busy time, top operations, idle share); (b) the card against the CPU,
   granite at full width and depth 2 in float32, batch 2 × seq 256, 2
   steps: loss, lr, grad_norm and every leaf of the state within the CPU
   tests' 1e-4/1e-5; (c) mixtral-8x22b at full width with Adafactor, its
   depth cut where weights, gradients and optimizer state reckon past
   40 GB, batch 1 × seq 4096, 3 steps: losses finite, peak, step ms; (d)
   ``compressed_psum`` on the gradients of one full-width granite layer
   (a row per PE, each from its own batch): the sim backend at p = 8 and
   at p = 4 with the trace's wire bytes against float32's, and four gloo
   ranks sharing the card equal to the sim at p = 4 bit for bit (the
   chunks, and so the bits, depend on p).  Each part prints its seconds.
   ``--train-only`` runs phases 1, 2 and 20 alone.
21. serving on a mesh (``dist.sharding``, ``convert.shard_params``,
   ``serve(cfg, mesh)``): four gloo ranks sharing the card on a (data 2,
   model 2) ``DeviceMesh``, every weight sharded at rest as
   ``make_shardings`` places it, the attention and the head multiplying
   their slices in place (the partial products summed over ``model``),
   the MoE layer on a rank's rows with its experts where the
   reference's layouts hold them (``moe_local`` in decode: the slices in
   place; the expert-parallel dispatch: the rank's experts, re-cut by one
   all-to-all), the norms, the MoE routers and granite's tied embedding
   (49 155 words, which 2 does not divide) gathered whole over ``model``
   at their block; each part counts the bytes a rank sends and receives a step at
   the port's transport seam (``core.comm.count_wire``) and holds them
   equal to the dry-run's reckoning for that rank (``launch/dryrun.py``
   on the meta device, printed beside them): (a) ``serve`` of
   granite-moe-1b-a400m at full size (bf16, batch
   32, 4 steps over a 1024-slot cache): each rank's resident weight
   bytes (equal to the slices ``make_shardings`` reckons) and cache bytes
   (its rows and 4 of granite's 8 KV heads, as the reference's rule
   splits them: equal to the slice ``cache_specs`` reckons, printed
   beside its rows' whole cache), the weight bytes it receives a step
   (the gathered ones), its peaks while drawing and while serving, p50/p99
   step ms and tok/s (walls of processes that share one card through
   the host, not a multi-GPU speed), every rank's tokens equal and their
   share equal to 19a's one-device serve at the same seed (reported: bf16
   on 16 rows may round apart from 32); (b) the mesh against one device,
   granite at full width and depth 2 in float32, 8 greedy steps, the
   caches split on their heads: tokens equal, each rank's logits of its
   rows within 1e-4/1e-5 of one device's; (c) context-parallel prefill of
   llama3.2-1b at full width and depth 2 in float32 over (2, 2048)
   tokens in 1024-key blocks (query blocks over ``model``, rows over
   ``data``): the last-token logits within 1e-4/1e-5 of one device's
   ``forward`` in float64 on each rank's rows, the prefill step's tokens
   equal one device's float32 ones (one device's float32 logits are
   printed beside them, with the count of logits either float32 run
   misses the tolerance by against the other and against float64: at
   d = 2048 a float32 run summed in another order, the mesh's or one
   device's on 4096 rows, misses it on a few of 128 256); (d) the caches
   split on their
   length: llama3.2-1b's smoke width (2 KV heads) on a (data 1, model 4)
   mesh of the same ranks, float32, 64 teacher-forced steps over 64
   slots (16 a rank, so every block takes writes): the logits within
   1e-4/1e-5 of one device's; (e) rwkv6-1.6b at its published width
   cut to 2 layers and (f) zamba2-2.7b at its published width cut to
   one group (6 mamba layers and the shared block), float32, the blocks
   on a rank's heads with its slices of their weights and the recurrent
   states split over ``model`` by the reference's rule: prefill of (2,
   256) tokens within 1e-4/1e-5 of one device's float32 logits (or,
   where one device's float32 misses its float64 forward by that, of
   the float64 forward) with its tokens equal, 8 greedy decode steps at
   batch 4 against one device (tokens equal, logits within
   1e-4/1e-5), each rank's ``wkv`` (rows, 32, 32, 64) on hd_k or ``ssm``
   (rows, 80, 32, 64) on P within 1e-4/1e-5 of one device's slice, the
   conv window the same bits along ``model``, the bytes of the prefill
   step and of each decode step the dry-run's.  ``--mesh-only`` runs
   phases 1, 2 and 21 alone.
22. training on a mesh (``launch.train``, ``launch.steps``,
   ``runtime.checkpoint`` and ``rescale_state`` on a ``DeviceMesh``):
   four gloo ranks sharing the card on a (data 2, model 2) mesh, weights
   and optimizer state sharded at rest as ``make_shardings`` places them,
   the attention, the dense MLP and the head multiplying their slices in
   place, the MoE layer on a rank's rows with the rank's experts,
   gradients through the sums' all-reduces, the gathers'
   reduce-scatters, the experts' re-cuts and the expert-parallel
   dispatch; each part's bytes a
   step on every rank equal to the dry-run's reckoning, as in 21: (a)
   ``train`` of granite-moe-1b-a400m at full
   width and 2 of its 24 layers (bf16, remat ``full``, AdamW, batch 4 ×
   seq 2048 from ``TokenPipeline``, the expert-parallel dispatch) for 4
   steps, a checkpoint every 2 and a crash injected at step 3 (cut from 6,
   3 and 4 for the script's time limit): each rank's resident bytes of weights and of optimizer state
   against the slices ``make_shardings`` reckons, the bytes it sends and
   receives in a step (the logits and the loss on its rows: under what
   every rank moved when it gathered the whole logits), its peak (under
   that layout's), p50 step ms and tokens/s (walls of
   processes that share one card through the host, not a multi-GPU
   speed), every rank's losses equal and finite, the replayed step's loss
   that of the first attempt, the saved checkpoint's whole leaves equal
   bit for bit to the ranks' slices put together; (b) the mesh against
   one device: llama3.2-1b at full width and depth 2 in float32, batch 2
   × seq 256, 2 steps: loss, lr and grad_norm at each step and every
   rank's slice of every leaf of the state within 1e-4/1e-5 of the
   one-device run on the card (each rank runs it, so every leaf is
   compared whole), then a checkpoint and a third step; (c) granite at
   full width and depth 2 in float32, batch 2 × seq 256, 1 step on the
   four ranks with card tensors and with CPU tensors: losses and every
   slice within 1e-4/1e-5; (d) ``rescale_state`` of (b)'s checkpoint
   onto (4, 1) and (1, 4) meshes of the four ranks: every slice equal bit
   for bit to the new ``make_shardings`` slice of the saved leaf, the
   next step's loss on (4, 1) within 1e-4/1e-5 of (b)'s third step; and
   (a)'s checkpoint onto both, slices only (its expert-parallel dispatch
   drops other items at another ``model``); (e) one training step of
   21e's rwkv6 on 2 × 256 tokens: the loss and each rank's slice of
   every gradient leaf within 1e-4/1e-5 of one device's, the step's
   bytes the dry-run's.  ``--mesh-train-only`` runs phases 1, 2 and 22
   alone.
23. the dry-run against the card (``launch/dryrun.py``: one step reckoned
   from shapes on the meta device under ``launch/op_cost.py``, no new
   model run): (a) the roofline terms of 19a's decode step (granite,
   batch 32, 1024 slots) and 20a's training step (granite at 20a's depth,
   8 x 2048, bf16, remat ``full``) beside their measured p50, the
   roofline fraction (the largest term over the p50) and 2·N_active·D or
   6·N_active·D over the p50 at the data sheet's 989 TFLOP/s; (b)
   op_cost's matmul FLOPs of 20a's step against ``torch.profiler``'s
   FLOPs over the matmul operators of a second profiled step of 20a's
   (taken ``with_flops``, apart from the step whose wall and idle share
   20a reports), within 2 %; (c) the reckoned argument + temp bytes
   beside ``max_memory_allocated`` of 20a and 22a (reported); (d) the
   bytes a rank sends and receives a step of 22a, reckoned on rank 0's
   ``MeshLayout``, equal to what 22a's ranks counted; (e) one bf16 8192^3
   ``torch.matmul`` rate and one 4 GiB device-to-device copy rate beside
   989 TFLOP/s and 3.35 TB/s.  ``--dryrun-only`` runs phases 1, 2, 19a,
   20a, 22a and 23 alone.

Every algorithm of ``repro_torch.psort`` runs: ``rams`` (phases 4, 5,
14, 15), ``rquick`` and ``ntb-quick`` (8), the external lane (6, 7, 14),
``rfis``, ``gatherm``, ``allgatherm``, ``ssort``, ``ns-ssort``,
``bitonic`` and ``ntb-ams`` (10; ``ssort`` also 14), all but the AMS
family on 8-byte keys (11), ``"auto"`` (13), every in-core one on
batched keys and nested meshes (15), and the query path with its ingest
(the local sort) and bitonic behind the service's sorted copy (16),
the fault lane over seven algorithms and the external lane (17), and
RAMS and bitonic behind length-balanced batching (19).  Before
phase 1 the script checks that the kernels are switched on
(``local_kernels()``).  Each phase prints its seconds.

It imports torch, numpy and the port only.  Without a CUDA device, or
without the repository around it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import re
import resource
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
OPS_PER_S = 67e12                # H100 SXM float32 outside the tensor cores,
                                 # taken for 32-bit integer compares (same)
REPS = 5
P_MAIN, LOG_N_MAIN = 256, 26
INSTANCES_MAIN = ("Uniform", "Zero", "AllToOne")
P_CHECK, LOG_N_CHECK, OVERFLOW_CHECK = 64, 20, 3442
P_EXT, LOG_N_EXT, BUDGET_EXT = 16, 27, 1 << 21
INSTANCES_EXT = ("Uniform",)
LOG_N_EXT_CHECK, BUDGET_EXT_CHECK = 20, 1 << 13
P_RQUICK, LOG_N_RQUICK = 1 << 18, 26
INSTANCES_RQUICK = ("Uniform", "Zero")
# RQuick's and NTB-Quick's card-against-CPU checks (phases 8, 11, 12, 14):
# p = 64 at n = 2^18, where RQuick's CPU run takes ~2 s (~14 s at 2^20)
RQUICK_CHECKS = (("rquick", 64, 18), ("ntb-quick", 64, 18))
# the kernels of the RAMS path, and the launches (the classify: of the
# variant the path reads) each path must show
RAMS_KERNELS = ("tile_sort", "run_merge", "partition_classify",
                "partition_rank")
RAMS_LAUNCHES = ("tile_sort", "run_merge", "partition_classify:rank",
                 "partition_rank")
EXTERNAL_KERNELS = ("kway_classify", "tile_sort", "run_merge")
RQUICK_KERNELS = ("tile_sort", "partition_classify:hist")
# phase 10: each other path's p, log2 n, instances and kernels.  RFIS at
# its band (n/p = 1) at the survey's 2^18 PEs; GatherM and AllGatherM at
# n/p = 2^-3, cut to p = 2^12 because the sim layout carries p·p·capacity
# slots; the four baselines at the RAMS phase's size
P_RFIS, LOG_N_RFIS = 1 << 18, 18
P_GATHER, LOG_N_GATHER = 1 << 12, 9
SSORT_KERNELS = ("tile_sort", "run_merge", "partition_classify:bucket")
OTHER_PATHS = (
    ("rfis", P_RFIS, LOG_N_RFIS, ("Uniform", "Zero"), ("tile_sort",)),
    ("gatherm", P_GATHER, LOG_N_GATHER, ("Uniform", "Zero"), ("tile_sort",)),
    ("allgatherm", P_GATHER, LOG_N_GATHER, ("Uniform", "Zero"),
     ("tile_sort",)),
    ("ssort", P_MAIN, LOG_N_MAIN, ("Uniform", "Zero"),
     SSORT_KERNELS),
    ("ns-ssort", P_MAIN, LOG_N_MAIN, ("Uniform", "Zero"),
     SSORT_KERNELS),
    ("bitonic", P_MAIN, LOG_N_MAIN, ("Uniform", "Zero"),
     ("tile_sort", "run_merge")),
    ("ntb-ams", P_MAIN, LOG_N_MAIN, ("Uniform", "Zero"),
     RAMS_LAUNCHES),
)
# the card against the CPU, bit for bit: (algorithm, p, log2 n); SSort,
# NS-SSort and bitonic at 2^18 (their CPU runs at 2^20 were a large share
# of phases 10-12 and 14), NTB-AMS at 2^20, where the reference drops 3442
# keys
OTHER_CHECKS = (("ssort", 64, 18), ("ns-ssort", 64, 18), ("bitonic", 64, 18),
                ("ntb-ams", 64, 20), ("rfis", 1 << 10, 12),
                ("gatherm", 1 << 8, 5), ("allgatherm", 1 << 8, 5))
# RQuick's cell cut to p = 2^16, n = 2^24 (its n/p, a sixteenth of the
# work) where phases 11 and 13 run it again, for the script's time limit
P_RQUICK_CUT, LOG_N_RQUICK_CUT = 1 << 16, 24
# phase 11: 8-byte keys.  Each algorithm that takes them at its phase-8 or
# phase-10 cell (RQuick and NTB-Quick at the cut one), and the kernel
# launch each path must show (its local sorts take the library's sort:
# the tile sort takes 4-byte words only)
KEYS64_PATHS = (
    ("rquick", P_RQUICK_CUT, LOG_N_RQUICK_CUT, "partition_classify:hist"),
    ("ntb-quick", P_RQUICK_CUT, LOG_N_RQUICK_CUT, "partition_classify:hist"),
    ("rfis", P_RFIS, LOG_N_RFIS, None),
    ("gatherm", P_GATHER, LOG_N_GATHER, None),
    ("allgatherm", P_GATHER, LOG_N_GATHER, None),
    ("ssort", P_MAIN, LOG_N_MAIN, "partition_classify:bucket"),
    ("ns-ssort", P_MAIN, LOG_N_MAIN, "partition_classify:bucket"),
    ("bitonic", P_MAIN, LOG_N_MAIN, None),
)
KEYS64_CHECKS = RQUICK_CHECKS + tuple(
    c for c in OTHER_CHECKS if c[0] != "ntb-ams")
# phase 12: the collective traces, card against CPU at the check sizes,
# and Table I at each path's cell
TRACE_CHECKS = ((("rams", P_CHECK, LOG_N_CHECK),) + RQUICK_CHECKS
                + OTHER_CHECKS)
TRACE_CELLS = ((("rams", P_MAIN, LOG_N_MAIN),
                ("rquick", P_RQUICK, LOG_N_RQUICK),
                ("ntb-quick", P_RQUICK, LOG_N_RQUICK))
               + tuple(path[:3] for path in OTHER_PATHS))
# phase 13: the regime cells at which "auto" runs against the algorithm it
# picks, and the reckoned peak past which a choice is printed, not run
AUTO_CELLS = (("rams", P_MAIN, LOG_N_MAIN),
              ("rquick", P_RQUICK_CUT, LOG_N_RQUICK_CUT),
              ("rfis", P_RFIS, LOG_N_RFIS), ("gatherm", P_GATHER,
                                             LOG_N_GATHER))
REGIME_PS = (1 << 8, 1 << 12, 1 << 18)
FRESH_PS = (1 << 6, 1 << 8)
AUTO_PEAK_LIMIT = 60e9
# phase 14: the streamed exchange (overlap=True) against the barrier path
OVERLAP_PATHS = (("rams", RAMS_LAUNCHES), ("ssort", SSORT_KERNELS))
OVERLAP_INSTANCES = ("Uniform",)
OVERLAP_CHECKS = (("rams", P_CHECK, LOG_N_CHECK),
                  ("ssort", P_CHECK, LOG_N_CHECK))
# phase 15: batched keys and nested meshes.  d sorts of 2^24 keys hold the
# state of the RAMS cell (p = 256) and of the RQuick cell (2^16 PEs each);
# the nested meshes run at the RAMS cell, their traces checked at 2^18
D_BATCH, LOG_N_BATCH, LOG_P_MAIN = 4, 24, 8
P_BATCH_RQUICK = 1 << 16
BATCH_MIXED = ("Uniform", "Zero", "AllToOne", "Staggered")
NESTED_MESHES = ((16, 16), (4, 64))
LOG_N_NESTED_TRACE = 18
ALGORITHMS = ("rams", "ntb-ams", "rquick", "ntb-quick", "rfis", "ssort",
              "ns-ssort", "bitonic", "gatherm", "allgatherm")
# phase 16: query serving over the RAMS cell's data (256 rows of 2^18 keys
# resident on the card); batches of 64 queries, the reference CLI's mix;
# the service's sorted copy is bitonic's, exact on any input and the
# fastest exact sort at this cell (RAMS's second level drops 25 204 keys
# here, RQuick takes seconds); the card against the CPU at p = 64, n = 2^20
P_SERVE, LOG_N_SERVE = P_MAIN, LOG_N_MAIN
SERVE_INSTANCES = ("Uniform", "Zero", "Staggered")
SERVE_B, SERVE_TOPK_BIG, SERVE_QUERIES = 64, 4096, 512
SERVE_MIX = "top_k=4,percentile=2,rank_of_key=2,range_query=1"
SERVE_SORT = "bitonic"
P_SERVE_CHECK, LOG_N_SERVE_CHECK = P_CHECK, LOG_N_CHECK
SERVE_B_CHECK, SERVE_QUERIES_CHECK = 16, 64
# phase 17: the fault lane.  The card against the CPU at p = 8 for the
# reference's fast-lane algorithms; the lane's crossing budget lies between
# n/16 and n/8 at its check cell; RAMS killed at n = 2^25 (p = 256 → 128,
# capacity 2^19: survivable) and at the RAMS cell (→ capacity 2^20, which
# RAMS refuses, as the reference does); the memory slack of its checks
FAULT_ALGOS = ("gatherm", "allgatherm", "rfis", "rquick", "rams", "bitonic",
               "ssort")
BUDGET_FAULT_CROSS = 3 << 15
LOG_N_FAULT = 25
FAULT_SLACK = 64 << 20
# phase 18: the distributed backend.  Eight gloo ranks share the card
# (p = 8) at n = 2^23 (2^20 keys a rank; cut from the RAMS cell's 2^26 to
# keep the script inside its time limit: gloo moves every exchange through
# the host); RAMS and NTB-AMS at 2^21, as RAMS's capacity (< 2^20 a PE)
# allows; one NCCL rank at p = 1.  Every sort is held against the sim
# backend on the card at the same p
DIST_RANKS, DIST_LOG_N = 8, 23
DIST_LOG_N_CUT = {"rams": 21, "ntb-ams": 21}
DIST_INSTANCES = ("Uniform",)
DIST_BATCH, DIST_BATCH_ALGO = (2, 4, 22), "rquick"
DIST_NESTED = ((2, 4), 21)
DIST_EXCLUDE = (4, (3, 5, 6, 7), 22)
DIST_SERVE_LOG_N, DIST_SERVE_B = 22, 64
DIST_NCCL_LOG_N, DIST_NCCL_LOG_N_AMS = 24, 18
DIST_TIMEOUT_S = 300
DIST_REQUIRED = {"rams": RAMS_LAUNCHES, "ntb-ams": RAMS_LAUNCHES,
                 "rquick": RQUICK_KERNELS, "ntb-quick": RQUICK_KERNELS,
                 "ssort": SSORT_KERNELS, "ns-ssort": SSORT_KERNELS,
                 "bitonic": ("tile_sort", "run_merge")}
# phase 19: the model-serving stack.  granite-moe-1b-a400m served at full
# size (batch 32, 64 steps over a 1024-slot cache), checked against the
# CPU at full width and depth 2 in float32 within the CPU tests'
# tolerance; every architecture at full width, its depth cut where its
# reckoned weights and cache pass 40 GB; llama3.2-1b's teacher-forced
# decode against prefill in float32 at full size; one granite MoE layer
# on x (8, 2048, 1024); four gloo ranks on a (data 2, model 2) mesh;
# length-balanced batching at the RAMS cell, card vs CPU at p = 64
MODEL_ARCH = "granite-moe-1b-a400m"
MODEL_BATCH, MODEL_TOKENS, MODEL_CACHE = 32, 64, 1024
MODEL_CHECK_DEPTH, MODEL_CHECK_STEPS = 2, 8
MODEL_F32_TOL = {"rtol": 1e-4, "atol": 1e-5}
MODEL_ARCH_B, MODEL_ARCH_S, MODEL_ARCH_STEPS = 2, 2048, 8
MODEL_BYTES_LIMIT = 40e9
MODEL_TF_S, MODEL_TF_TOL = 64, {"rtol": 1e-3, "atol": 1e-3}
MODEL_CLI_TIMEOUT_S = 300
MODEL_MOE_X = (8, 2048, 1024)
MODEL_MOE_EPS = (8, 32)
MODEL_DIST_RANKS = 4
MODEL_LBB_LOG_N, MODEL_LBB_P, MODEL_LBB_BATCH = 26, 256, 64
MODEL_LBB_CHECK = (64, 20)
MODEL_DEV = "cuda"          # phase 19 runs here (a CPU rehearsal sets "cpu")
# phase 20: the training stack.  granite-moe-1b-a400m trained at full size
# through a crash and a restart; the card against the CPU at full width
# and depth 2 in float32; mixtral-8x22b's Adafactor at full width, its
# depth cut where weights, gradients and optimizer state pass 40 GB; the
# compressed gradient mean of one full-width granite layer, sim against
# gloo ranks sharing the card
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_DEPTH = 4             # of granite's 24 layers, to keep the script
                            # inside its 1200 s (the full depth took ~180 s
                            # of phase 20, 12 layers 83 s)
# 10 steps, a checkpoint every 5, the crash at 8: few, for the script's
# time limit
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 10
TRAIN_CKPT_EVERY, TRAIN_CRASH_AT = 5, 8
TRAIN_CHECK_DEPTH, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 2, 256
TRAIN_CHECK_STEPS = 2         # few, for the script's time limit
TRAIN_ADAFACTOR_ARCH = "mixtral-8x22b"
TRAIN_ADAFACTOR_BATCH, TRAIN_ADAFACTOR_SEQ, TRAIN_ADAFACTOR_STEPS = 1, 4096, 3
TRAIN_BYTES_LIMIT = 40e9
TRAIN_COMPRESS_P, TRAIN_COMPRESS_RANKS, TRAIN_COMPRESS_SEQ = (8, 4), 4, 256
TRAIN_DEV = "cuda"          # phase 20 runs here (a CPU rehearsal sets "cpu")
# phase 21: serving on a mesh.  Four gloo ranks share the card on a (data
# 2, model 2) mesh: granite-moe-1b-a400m served at full size (batch 32, 4
# steps over a 1024-slot bf16 cache: a step takes ~3-4.5 s through the
# host's gloo, so 16 would pass the script's time limit) with its weights
# sharded at rest,
# against 19a's one-device serve at the same seed; the mesh against one
# device at full width and depth 2 in float32 (8 decode steps); and
# context-parallel prefill of llama3.2-1b (dense: granite's prefill takes
# the expert-parallel dispatch on a mesh, which drops other items than the
# one-device layer, as the reference's does) at full width and depth 2 in
# float32 on (2, 2048) tokens in 1024-key blocks.  granite's 8 KV heads
# split over model 2, so its caches split their heads; the length split
# is held to one device on llama3.2-1b's smoke width (2 KV heads) on
# (data 1, model 4): 64 teacher-forced steps over 64 slots, 16 a rank, so
# every rank's block takes writes
MESH_RANKS, MESH_LAYOUT = 4, (2, 2)
MESH_TOKENS, MESH_SEED = 4, 21
MESH_CP_ARCH, MESH_CP_SHAPE = "llama3.2-1b", (2, 2048)
MESH_LENGTH_ARCH, MESH_LENGTH_LAYOUT = "llama3.2-1b", (1, 4)
MESH_LENGTH_BATCH, MESH_LENGTH_CACHE, MESH_LENGTH_STEPS = 4, 64, 64
MESH_SMOKE = False          # a CPU rehearsal sets True (smoke widths)
# 21e/21f: rwkv6-1.6b cut to 2 of its 24 layers and zamba2-2.7b to one
# group (6 mamba layers and the shared block), at their published widths
# in float32: prefill of MESH_SSM_PREFILL tokens and MESH_SSM_STEPS greedy
# decode steps at batch MESH_SSM_BATCH over MESH_SSM_CACHE slots, the
# blocks on a rank's heads and the recurrent states split over model by
# the reference's rule; 22e one training step of 21e's rwkv6 on the
# prefill's shape
MESH_SSM = {"rwkv6-1.6b": 2, "zamba2-2.7b": 6}
MESH_SSM_PREFILL, MESH_SSM_BATCH = (2, 256), 4
MESH_SSM_STEPS, MESH_SSM_CACHE = 8, 16
# phase 22: training on a mesh.  Four gloo ranks share the card on a (data
# 2, model 2) mesh: granite-moe-1b-a400m trained at full width through a
# crash and a restart (its depth reckoned so the phase fits its budget: a
# step moves ~1-3 GB a rank through the host's gloo at 0.3-0.5 GB/s); the
# mesh against one device for llama3.2-1b (dense) in float32; granite's
# card ranks against the same ranks on the CPU; the elastic restores onto
# (4, 1) and (1, 4)
MESH_TRAIN_DEPTH = 2        # of granite's 24 layers
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 4, 2048
# 4 steps, a checkpoint every 2, the crash at 3: cut from 6, 3 and 4 for
# the script's time limit (a step is ~4.4 s of gloo traffic)
MESH_TRAIN_STEPS, MESH_TRAIN_CKPT_EVERY, MESH_TRAIN_CRASH_AT = 4, 2, 3
# what a rank of 22a sent a step and its peak when every rank gathered the
# whole logits over data for the loss (PERF.md section 5): the logits and
# the loss on a rank's rows must come in under both
MESH_TRAIN_WHOLE_LOGITS_BYTES, MESH_TRAIN_WHOLE_LOGITS_PEAK = (
    1_891_142_132, 10_123_124_736)
MESH_CHECK_ARCH, MESH_CHECK_DEPTH = "llama3.2-1b", 2
MESH_CHECK_BATCH, MESH_CHECK_SEQ, MESH_CHECK_STEPS = 2, 256, 2
MESH_CPU_STEPS = 1            # the CPU step takes ~10 s on four ranks
MESH_ELASTIC = ((4, 1), (1, 4))
MESH_TRAIN_SEED = 22
# phase 23: the dry-run against the card; its achieved peaks from one bf16
# matmul of this size and one device-to-device copy of these bytes
DRYRUN_MATMUL_N, DRYRUN_COPY_BYTES, DRYRUN_REPS = 8192, 4 << 30, 10
# RFIS's cut if its projected peak at p = 2^18 passes this: the projection
# is 8x the peak at p = 2^16 (the gathered rows, columns and route shards
# hold p · 2^(cb) · capacity slots, 2^29 against 2^26)
P_RFIS_CUT, LOG_N_RFIS_CUT, RFIS_PEAK_LIMIT = 1 << 16, 16, 70e9


# what phases 19a, 20a and 22a measured, for phase 23 to hold the dry-run to
MEASURED = {}
STARTED = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line carries ``t``, the seconds since
    the script started."""
    if "phase" in obj:
        obj = {**obj, "t": time.perf_counter() - STARTED}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    return 1


def cuda_ms(torch, fn, reps: int = REPS) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs after one warm-up,
    timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, ops: float):
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def max_abs_err(torch, pairs) -> int:
    err = 0
    for a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
        err = max(err, int(d))
    return err


def launch_key(row) -> str:
    """The launch counter of a row's kernel: the classify's per variant."""
    return row["name"] + (f":{row['variant']}" if row.get("variant") else "")


def measure(torch, results, name, source, replaces, got, want, fn, plain,
            nbytes, ops, library=None, shape=None, variant=None, ms=None,
            **extra):
    """Hold one kernel against its plain version, time both (and the library
    call, where there is one; the kernel with CUDA events around one call
    unless the caller measured ``ms``), emit the row and keep it in
    ``results`` under its launch key."""
    if len(got) != len(want):
        raise AssertionError(f"{name} returns {len(got)} outputs, its plain "
                             f"version {len(want)}")
    err = max_abs_err(torch, zip(got, want))
    if err != 0:
        raise AssertionError(f"{name} differs from its plain version "
                             f"(max abs err {err})")
    b_ms, b_by = bound(nbytes, ops)
    row = {"name": name, "shape": shape, "variant": variant, "route": "cuda",
           "source": source, "replaces": replaces, "max_abs_err": err,
           "ms": cuda_ms(torch, fn) if ms is None else ms,
           "plain_ms": cuda_ms(torch, plain),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None if library is None
           else cuda_ms(torch, library)}
    emit({"phase": "kernel", **extra, **row,
          "kernel_ms": row["ms"]})
    results.setdefault(launch_key(row), row)
    return row


SRC_P = "src/repro_torch/kernels/partition/csrc/partition.cu"
REPLACES_P = "src/repro/kernels/partition/partition.py:72"


def partition_rows(torch, keys, ties, s_keys, s_ties, count, nb,
                   inclusive=True, wants=None, **extra):
    """Every classify launch variant (or those in ``wants``) at one path's
    shape, each against its plain version with ``max_abs_err`` 0, timed
    beside the bound of the bytes that launch moves: 8 per valid key (key
    and tie, read below the count only), 4 per bucket written, its
    histogram (per tile for the rank, per row otherwise), each row's
    splitters and count.  The bucket variant is also timed beside the
    library's ``torch.searchsorted`` on the int64 composites (what the
    plain version calls), which gives the bucket ids without the trash
    bucket.  Returns the rows, keyed by launch key."""
    from repro_torch.kernels import partition as pt
    from repro_torch.kernels.partition import ref as pref
    rows, C = keys.shape
    valid = int(count.sum())
    tiles = -(-C // pt.PTILE)
    out_bytes = {"rank": 4 * rows * C + 4 * rows * tiles * (nb + 1),
                 "bucket_hist": 4 * rows * C + 4 * rows * nb,
                 "bucket": 4 * rows * C, "hist": 4 * rows * nb}
    out = {}
    for want in wants or pt.WANTS:
        kw = dict(n_buckets=nb, inclusive=inclusive, want=want)
        library = None
        if want == "bucket":
            elem = pref._composite(keys, ties)
            spl = pref._composite(s_keys, s_ties).contiguous()

            def library():
                return torch.searchsorted(spl, elem, right=inclusive)
        measure(torch, out, "partition_classify", SRC_P, REPLACES_P,
                pt.classify(keys, ties, s_keys, s_ties, count, **kw),
                pref.classify_ref(keys, ties, s_keys, s_ties, count,
                                  tile=pt.PTILE, **kw),
                lambda: pt.classify(keys, ties, s_keys, s_ties, count, **kw),
                lambda: pref.classify_ref(keys, ties, s_keys, s_ties, count,
                                          tile=pt.PTILE, **kw),
                nbytes=8 * valid + out_bytes[want] + rows * 8 * nb,
                ops=valid * max(1, (nb - 1).bit_length()), library=library,
                shape=[rows, C], variant=want, nb=nb, inclusive=inclusive,
                valid_keys=valid, **extra)
        library = elem = spl = None
        torch.cuda.empty_cache()
    return out


def ptxas_report(log: str) -> dict:
    """Registers, static shared memory and spills of every kernel in one
    nvcc log (``-Xptxas -v``)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(\w+?)_kernel", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def padded(torch, x, width, fill):
    """``x`` (rows, C) with columns of ``fill`` up to a multiple of
    ``width``, so a library call can take its (rows·C/width, width) view."""
    extra = -x.shape[1] % width
    return torch.cat([x, x.new_full((x.shape[0], extra), fill)], 1)


def kernel_phases(torch):
    """Phase 3: each RAMS kernel against its plain version at main-path
    shapes."""
    from repro_torch.kernels import bitonic as bt
    from repro_torch.kernels import partition as pt
    from repro_torch.kernels.bitonic import ref as bref
    from repro_torch.kernels.partition import ref as pref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows, C = P_MAIN, 2_196_992            # level-0 route output at n = 2^26
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, C), generator=g,
                         device=dev, dtype=torch.int32)
    vals = torch.arange(rows * C, device=dev,
                        dtype=torch.int32).reshape(rows, C)
    n = rows * C
    results = {}

    def record(*args, **kw):
        return measure(torch, results, *args, **kw)

    def lib_segments(k, v, width):
        """The library's stable sort of every ``width`` segment (k and v
        padded to a multiple of it with the pad word, which sorts last)."""
        ks, order = torch.sort(k.view(-1, width), dim=1, stable=True)
        return (ks.view(rows, -1),
                torch.gather(v.view(-1, width), 1, order).view(rows, -1))

    src_b = "src/repro_torch/kernels/bitonic/csrc/bitonic.cu"
    t = bt.TILE
    pad_word = 2 ** 31 - 1
    kp, vp = padded(torch, keys, t, pad_word), padded(torch, vals, t, 0)
    tiles_sorted = bt.sort_tiles(keys, vals)
    lib = [a[:, :C] for a in lib_segments(kp, vp, t)]
    if max_abs_err(torch, zip(tiles_sorted, lib)) != 0:
        raise AssertionError("tile_sort differs from the library's "
                             "segmented stable sort")
    del lib
    record("tile_sort", src_b, "src/repro/kernels/bitonic/bitonic.py:121",
           tiles_sorted, bref.sort_tiles_ref(keys, vals, t),
           lambda: bt.sort_tiles(keys, vals),
           lambda: bref.sort_tiles_ref(keys, vals, t),
           nbytes=16 * n, ops=n * (t.bit_length() - 1),
           library=lambda: lib_segments(kp, vp, t), shape=[rows, C])
    del kp, vp
    runs_k, runs_v = tiles_sorted
    del tiles_sorted
    # one merge pass: a stable sort of two adjacent sorted runs is their
    # left-ties-first merge
    kp = padded(torch, runs_k, 2 * t, pad_word)
    vp = padded(torch, runs_v, 2 * t, 0)
    merged = bt.merge_runs(runs_k, runs_v, t)
    lib = [a[:, :C] for a in lib_segments(kp, vp, 2 * t)]
    if max_abs_err(torch, zip(merged, lib)) != 0:
        raise AssertionError("run_merge differs from the library's "
                             "segmented stable sort")
    del lib
    record("run_merge", src_b, "src/repro/kernels/bitonic/bitonic.py:146",
           merged, bref.merge_runs_ref(runs_k, runs_v, t),
           lambda: bt.merge_runs(runs_k, runs_v, t),
           lambda: bref.merge_runs_ref(runs_k, runs_v, t),
           nbytes=16 * n, ops=n * t.bit_length(),
           library=lambda: lib_segments(kp, vp, 2 * t), shape=[rows, C])
    del runs_k, runs_v, merged, kp, vp
    torch.cuda.empty_cache()
    # the whole local sort (tile sort + every merge pass) beside the
    # library's stable sort + payload gather, which computes the same
    def lib_sort():
        ks, order = torch.sort(keys, dim=1, stable=True)
        return ks, torch.gather(vals, 1, order)
    got = bt.local_sort_fast(keys, vals)
    err = max_abs_err(torch, zip(got, lib_sort()))
    if err != 0:
        raise AssertionError("local_sort_fast differs from a stable sort")
    del got
    passes = bt.ops.merge_passes(C)
    emit({"phase": "local_sort", "shape": [rows, C], "merge_passes": passes,
          "max_abs_err": err,
          "kernel_ms": cuda_ms(torch, lambda: bt.local_sort_fast(keys, vals)),
          "plain_ms": cuda_ms(torch, lambda: bref.sort_ref(keys, vals)),
          "library_ms": cuda_ms(torch, lib_sort),
          "bound_ms": bound(16 * n * (1 + passes), 0)[0]})
    # the main path's occupancy: about 2^18 valid keys per row (the level-0
    # output), then pad words; the library's full-row stable sort computes
    # the same function there, because the pad word sorts last, and so
    # does its sort of the longest prefix alone
    count = (1 << 18) - 2000 + (torch.arange(rows, device=dev) * 997) % 4000
    col = torch.arange(C, device=dev)
    keys = torch.where(col[None, :] < count[:, None], keys, pad_word)
    del col
    def lib_prefix():
        """The library's stable sort + gather of the longest valid prefix
        only, the tail copied: the same function on ~1/8 of the data."""
        w = int(count.max())
        ks, order = torch.sort(keys[:, :w], dim=1, stable=True)
        vs = torch.gather(vals[:, :w], 1, order)
        return torch.cat([ks, keys[:, w:]], 1), torch.cat([vs, vals[:, w:]],
                                                          1)
    got = bt.local_sort_fast(keys, vals, count)
    err = max(max_abs_err(torch, zip(got, lib_sort())),
              max_abs_err(torch, zip(got, lib_prefix())),
              max_abs_err(torch, zip(got, bref.sort_ref(keys, vals, count))))
    if err != 0:
        raise AssertionError("count-aware local_sort_fast differs from a "
                             "stable sort")
    del got
    valid = int(count.sum())
    passes = bt.ops.merge_passes(int(count.max()))
    occ = {"kernel_ms": cuda_ms(torch, lambda: bt.local_sort_fast(
        keys, vals, count)),
        "plain_ms": cuda_ms(torch, lambda: bref.sort_ref(keys, vals, count)),
        "library_ms": cuda_ms(torch, lib_sort),
        "library_prefix_ms": cuda_ms(torch, lib_prefix)}
    emit({"phase": "local_sort_occupancy", "shape": [rows, C],
          "valid_keys": valid, "merge_passes": passes, "max_abs_err": err,
          **occ, "kernel_over_library": occ["kernel_ms"] / occ["library_ms"],
          "kernel_over_library_prefix": occ["kernel_ms"]
          / occ["library_prefix_ms"],
          "bound_ms": bound(16 * valid * (1 + passes) + 16 * (n - valid),
                            0)[0]})
    # all keys equal (the Zero instance): every diagonal inside one tie run
    keys.zero_()
    got = bt.local_sort_fast(keys, vals)
    err = max_abs_err(torch, zip(got, bref.sort_ref(keys, vals)))
    if err != 0 or not torch.equal(got[1], vals):
        raise AssertionError("local_sort_fast on equal keys differs from its "
                             "plain version")
    del got
    emit({"phase": "local_sort_equal_keys", "shape": [rows, C],
          "max_abs_err": err,
          "kernel_ms": cuda_ms(torch, lambda: bt.local_sort_fast(keys,
                                                                  vals))})
    del keys, vals, count
    torch.cuda.empty_cache()

    # partition at level 0: (256, 2^20) locally sorted keys, nb = 64
    rows, C, nb = P_MAIN, 1 << 20, 64
    keys = torch.sort(torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, C),
                                    generator=g, device=dev,
                                    dtype=torch.int32), dim=1)[0]
    ties = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, C), generator=g,
                         device=dev, dtype=torch.int32)
    pick = torch.randint(0, C, (rows, nb - 1), generator=g, device=dev)
    comp = (torch.gather(keys, 1, pick).to(torch.int64) << 32) | (
        torch.gather(ties, 1, pick).to(torch.int64) & 0xFFFFFFFF)
    comp = torch.sort(comp, dim=1)[0]
    s_keys = (comp >> 32).to(torch.int32).contiguous()
    s_ties = ((comp & 0xFFFFFFFF) - ((comp & 0x80000000) << 1)).to(
        torch.int32).contiguous()
    count = C - (torch.arange(rows, device=dev) * 997) % 5000
    n = rows * C
    tiles = -(-C // pt.PTILE)
    hist_bytes = rows * tiles * (nb + 1) * 4
    results.update(partition_rows(torch, keys, ties, s_keys, s_ties, count,
                                  nb, path="rams"))
    cl = pt.classify(keys, ties, s_keys, s_ties, count, n_buckets=nb)
    bucket, th = cl
    del cl
    off = torch.cumsum(th, dim=1, dtype=torch.int32) - th
    record("partition_rank", SRC_P, REPLACES_P,
           [pt.rank(bucket, off, n_buckets=nb)],
           [pref.rank_ref(bucket, off, n_buckets=nb, tile=pt.PTILE)],
           lambda: pt.rank(bucket, off, n_buckets=nb),
           lambda: pref.rank_ref(bucket, off, n_buckets=nb, tile=pt.PTILE),
           nbytes=8 * n + hist_bytes, ops=n, shape=[rows, C])
    got = pt.partition_buckets(keys, ties, s_keys, s_ties, n_buckets=nb,
                               count=count)
    want = pref.partition_ref(keys, ties, s_keys, s_ties, n_buckets=nb,
                              count=count)
    err = max_abs_err(torch, zip(got, want))
    if err != 0 or not torch.equal(got[2].sum(1, dtype=torch.int64), count):
        raise AssertionError("partition_buckets differs from partition_ref")
    emit({"phase": "partition", "shape": [rows, C], "nb": nb,
          "max_abs_err": err,
          "kernel_ms": cuda_ms(torch, lambda: pt.partition_buckets(
              keys, ties, s_keys, s_ties, n_buckets=nb, count=count)),
          "plain_ms": cuda_ms(torch, lambda: pref.partition_ref(
              keys, ties, s_keys, s_ties, n_buckets=nb, count=count)),
          "library_ms": None, "bound_ms": bound(16 * n, 0)[0]})
    del keys, ties, bucket, th, off, got, want
    torch.cuda.empty_cache()
    return results


def device_ms(torch, fn, kernel: str, reps: int, tries: int = 3):
    """Device time per launch of ``kernel`` over ``reps`` back-to-back
    calls of ``fn`` under ``torch.profiler`` (the kernel's own intervals,
    so the host's time between launches does not count), and the number
    of device operations (kernels, copies, memsets) per call.

    The profiler now and then loses one activity record of a window of
    many short launches, so a window that does not show exactly ``reps``
    launches is profiled again, up to ``tries`` windows in all; a count
    that is wrong in every window fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        mine = [e for e in ops if kernel in e.name]
        if len(mine) == reps:
            total_us = sum(e.time_range.end - e.time_range.start
                           for e in mine)
            return total_us / reps / 1e3, len(ops) / reps
        seen.append(len(mine))
        print(f"  profiler window saw {len(mine)} launches of {kernel} in "
              f"{reps} calls; profiling again", flush=True)
    raise AssertionError(f"the profiler saw {seen} launches of {kernel} in "
                         f"{reps} calls in each of {tries} windows")


def wall_ms(torch, fn, reps: int) -> float:
    """Host-clock milliseconds per call over ``reps`` back-to-back calls,
    ended by one synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def kway_phase(torch):
    """Phase 3b: the k-way classifier against its plain version at the
    shapes of the external lane, with splitters out of lex order, and with
    more splitters than one shared-memory tree holds.  Returns the rows."""
    from repro_torch.kernels import kway as kw
    from repro_torch.kernels.kway import ref as kref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    src = "src/repro_torch/kernels/kway/csrc/kway.cu"
    rows = []
    # (what, C, nb, splitters: "lex" order, sorted keys with "ties" in no
    # order, or "shuffled" (a sort in every block), calls timed back to
    # back).  Random distinct keys rarely tie, so "ties" splitters are in
    # lex order but for the rare pick of equal keys
    shapes = [("pass C", P_EXT * BUDGET_EXT, P_EXT, "lex", 20),
              ("pass D", BUDGET_EXT, 8, "lex", 200),
              ("unordered ties", P_EXT * BUDGET_EXT, 2, "ties", 20),
              ("unordered ties", P_EXT * BUDGET_EXT, 128, "ties", 20),
              ("unordered ties", P_EXT * BUDGET_EXT, 2048, "ties", 20),
              ("shuffled", P_EXT * BUDGET_EXT, 2048, "shuffled", 20),
              ("past one tree", P_EXT * BUDGET_EXT, 1 << 16, "ties", 5)]
    for what, C, nb, order, reps in shapes:
        # the runs of one pass: sorted segments of BUDGET_EXT keys
        keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (C,), generator=g,
                             device=dev, dtype=torch.int32)
        keys = torch.sort(keys.view(-1, min(C, BUDGET_EXT)), dim=1)[0]
        keys = keys.reshape(-1)
        ties = torch.randint(-2 ** 31, 2 ** 31 - 1, (C,), generator=g,
                             device=dev, dtype=torch.int32)
        pick = torch.randint(0, C, (nb - 1,), generator=g, device=dev)
        s_keys = torch.sort(keys[pick])[0]
        s_ties = ties[pick]
        if order == "shuffled":
            perm = torch.randperm(nb - 1, generator=g, device=dev)
            s_keys, s_ties = s_keys[perm], s_ties[perm]
        if order == "lex":
            comp = torch.sort((s_keys.to(torch.int64) << 32)
                              | (s_ties.to(torch.int64) & 0xFFFFFFFF))[0]
            s_keys = (comp >> 32).to(torch.int32)
            s_ties = ((comp & 0xFFFFFFFF) - ((comp & 0x80000000) << 1)).to(
                torch.int32)
        s_keys, s_ties = s_keys.contiguous(), s_ties.contiguous()
        got = kw.kway_classify(keys, ties, s_keys, s_ties, n_buckets=nb)
        if int(got[1].sum()) != C:
            raise AssertionError(f"kway histogram sums to "
                                 f"{int(got[1].sum())}, not C = {C}")
        elem = kref._composite(keys, ties)
        spl = torch.sort(kref._composite(s_keys, s_ties))[0]

        def run():
            return kw.kway_classify(keys, ties, s_keys, s_ties, n_buckets=nb)

        dev_ms, ops = device_ms(torch, run, "kway_classify_kernel", reps)
        row = measure(
            torch, {}, "kway_classify", src,
            "src/repro/kernels/kway/kway.py:59", got,
            kref.kway_classify_ref(keys, ties, s_keys, s_ties, n_buckets=nb),
            run,
            lambda: kref.kway_classify_ref(keys, ties, s_keys, s_ties,
                                           n_buckets=nb),
            nbytes=12 * C + 4 * nb + 8 * (nb - 1),
            ops=C * max(1, (nb - 1).bit_length()),
            library=lambda: torch.searchsorted(spl, elem, right=True),
            shape=[C], ms=dev_ms, nb=nb, what=what,
            event_ms=cuda_ms(torch, run), wall_ms=wall_ms(torch, run, reps),
            device_ops_per_call=ops)
        rows.append({**row, "what": what})
        del keys, ties, got, elem, spl
        torch.cuda.empty_cache()
    return rows


def rquick_kernel_phase(torch):
    """Phase 8, first part: ``tile_sort`` and ``partition_classify`` at the
    shapes of the RQuick path at p = 2^18, n = 2^26 — rows of C = 1024
    (twice the input capacity 512) holding 2^8 to 2^10 valid keys, and
    one splitter per row over the lifted (hi, lo) planes, whose hi word is
    0 or 1 (the key 0xFFFFFFFF lifts to 2^32)."""
    from repro_torch.core.median import lift, planes
    from repro_torch.kernels import bitonic as bt
    from repro_torch.kernels.bitonic import ref as bref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    rows = P_RQUICK
    C = 2 * 2 * ((1 << LOG_N_RQUICK) // P_RQUICK)
    pad_word = 2 ** 31 - 1                   # the flip of 0xFFFFFFFF
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, C), generator=g,
                         device=dev, dtype=torch.int32)
    keys[::7, 0] = pad_word                  # valid keys of 0xFFFFFFFF
    vals = torch.arange(rows * C, device=dev,
                        dtype=torch.int32).reshape(rows, C)
    count = C // 4 + (torch.arange(rows, device=dev) * 997) % (3 * C // 4 + 1)
    col = torch.arange(C, device=dev)
    keys = torch.where(col[None, :] < count[:, None], keys, pad_word)
    del col
    valid = int(count.sum())
    rows_out = []

    def record(*args, **kw):
        rows_out.append(measure(torch, {}, *args, path="rquick", **kw))

    def lib_sort():
        """The library's stable row sort + payload gather: the same
        function, because the tail past the count holds pad words, which
        sort last and keep their order."""
        ks, order = torch.sort(keys, dim=1, stable=True)
        return ks, torch.gather(vals, 1, order)

    got = bt.sort_tiles(keys, vals, count)
    if max_abs_err(torch, zip(got, lib_sort())) != 0:
        raise AssertionError("tile_sort at the RQuick shape differs from "
                             "the library's stable sort")
    record("tile_sort", "src/repro_torch/kernels/bitonic/csrc/bitonic.cu",
           "src/repro/kernels/bitonic/bitonic.py:121", got,
           bref.sort_tiles_ref(keys, vals, bt.TILE, count),
           lambda: bt.sort_tiles(keys, vals, count),
           lambda: bref.sort_tiles_ref(keys, vals, bt.TILE, count),
           nbytes=16 * rows * C, ops=valid * (C.bit_length() - 1),
           library=lib_sort, shape=[rows, C], valid_keys=valid)
    sorted_keys = got[0]
    del got, vals
    torch.cuda.empty_cache()
    e_key, e_tie = planes(lift(sorted_keys))
    pick = (torch.arange(rows, device=dev) * 7919) % count
    s_key, s_tie = planes(lift(torch.gather(sorted_keys, 1, pick[:, None])))
    del sorted_keys, pick
    # every variant of the inclusive pass (the path launches the histogram
    # only), and the strict pass's histogram, which the path launches too
    rows_out += partition_rows(torch, e_key, e_tie, s_key, s_tie, count, 2,
                               path="rquick").values()
    partition_rows(torch, e_key, e_tie, s_key, s_tie, count, 2,
                   inclusive=False, wants=("hist",), path="rquick")
    del e_key, e_tie, s_key, s_tie, keys, count
    torch.cuda.empty_cache()
    return rows_out


def rquick_phase(torch, np, psort, SortConfig, generate_instance,
                 launch_counts, reset_launch_counts):
    """Phase 8, second and third parts: ``psort`` with RQuick at p = 2^18,
    n = 2^26 end to end, then the card against the CPU at p = 64,
    n = 2^18.
    Returns the launches of the first measured sort."""
    n = 1 << LOG_N_RQUICK
    cfg = SortConfig(p=P_RQUICK, algorithm="rquick")
    first = None
    for i, name in enumerate(INSTANCES_RQUICK):
        x = generate_instance(name, P_RQUICK, n).astype(np.uint32)
        if i == 0:              # warm-up on 2^22 of the keys: same p, the
            psort(x[:1 << 22], cfg)     # same code, a sixteenth of the work
            torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, info = psort(x, cfg, return_info=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check_sorted(torch, np, x, out, info, n)
        missing = [k for k in RQUICK_KERNELS if launches[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the RQuick "
                                 f"path: {missing}")
        if info["algorithm"] != "rquick":
            raise AssertionError(f"algorithm {info['algorithm']} ran")
        if first is None:
            first = launches
        emit({"phase": "rquick_psort", "instance": name, "p": P_RQUICK,
              "n": n, "algorithm": info["algorithm"], "wall_s": wall,
              "keys_per_s": n / wall, "max_memory_allocated": peak,
              "balance": info["balance"], "overflow": info["overflow"],
              "launches": launches})
        del out, info, x
        torch.cuda.empty_cache()

    for algorithm, p, log_n in RQUICK_CHECKS:
        n = 1 << log_n
        x = generate_instance("Uniform", p, n).astype(np.uint32)
        cfg = SortConfig(p=p, algorithm=algorithm)
        go, gi = psort(x, cfg, return_info=True, device="cuda")
        co, ci = psort(x, cfg, return_info=True, device="cpu")
        same = (torch.equal(go.view(torch.int32).cpu(), co.view(torch.int32))
                and torch.equal(gi["perm"].cpu(), ci["perm"])
                and torch.equal(gi["counts"].cpu(), ci["counts"])
                and gi["overflow"] == ci["overflow"])
        emit({"phase": "rquick_cuda_vs_cpu", "algorithm": algorithm,
              "p": p, "n": n, "instance": "Uniform",
              "identical": same, "overflow_cuda": gi["overflow"],
              "overflow_cpu": ci["overflow"]})
        if not same:
            raise AssertionError(f"{algorithm}: cuda and cpu runs differ")
        check_sorted(torch, np, x, go, gi, n)
    return first


def sort_kernel_rows(torch, g, rows, C, count, paths, merge):
    """``tile_sort`` and, with ``merge``, one ``run_merge`` pass of width
    TILE on (rows, C) int32 keys with an int32 payload, the first count[r]
    keys of row r valid and pad words after them: each against its plain
    version, timed beside its bound and the library's stable sort + gather
    of the same segments of the prefix that holds every valid key.  The
    merge is timed as one launch into buffers made beforehand, as
    ``local_sort_fast`` launches it.  Returns [(row, paths)]."""
    from repro_torch.kernels import bitonic as bt
    from repro_torch.kernels.bitonic import ref as bref
    dev = torch.device("cuda")
    src = "src/repro_torch/kernels/bitonic/csrc/bitonic.cu"
    t, pad_word = bt.TILE, 2 ** 31 - 1
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, C), generator=g,
                         device=dev, dtype=torch.int32)
    col = torch.arange(C, device=dev)
    keys = torch.where(col[None, :] < count[:, None], keys, pad_word)
    del col
    vals = torch.arange(rows * C, device=dev,
                        dtype=torch.int32).reshape(rows, C)
    valid, cmax = int(count.sum()), int(count.max())
    info = {"shape": [rows, C], "valid_keys": valid, "paths": list(paths)}

    def lib_segments(k, v, seg):
        seg = min(seg, C)
        w = -(-cmax // seg) * seg
        ks, order = torch.sort(k[:, :w].reshape(-1, seg), dim=1, stable=True)
        return ks.view(rows, w), torch.gather(v[:, :w].reshape(-1, seg), 1,
                                              order).view(rows, w)

    def same_as_library(got, lib, what):
        w = lib[0].shape[1]
        if max_abs_err(torch, zip((a[:, :w] for a in got), lib)) != 0:
            raise AssertionError(f"{what} at {rows} x {C} differs from the "
                                 f"library's segmented stable sort")

    got = bt.sort_tiles(keys, vals, count)
    same_as_library(got, lib_segments(keys, vals, t), "tile_sort")
    out = [(measure(
        torch, {}, "tile_sort", src,
        "src/repro/kernels/bitonic/bitonic.py:121", got,
        bref.sort_tiles_ref(keys, vals, t, count),
        lambda: bt.sort_tiles(keys, vals, count),
        lambda: bref.sort_tiles_ref(keys, vals, t, count),
        nbytes=16 * rows * C, ops=valid * (min(C, t).bit_length() - 1),
        library=lambda: lib_segments(keys, vals, t), **info), paths)]
    del keys, vals
    if merge:
        runs_k, runs_v = got
        ok, ov = runs_k.clone(), runs_v.clone()
        merged = bt.merge_runs(runs_k, runs_v, t, count)
        same_as_library(merged, lib_segments(runs_k, runs_v, 2 * t),
                        "run_merge")
        out.append((measure(
            torch, {}, "run_merge", src,
            "src/repro/kernels/bitonic/bitonic.py:146", merged,
            bref.merge_runs_ref(runs_k, runs_v, t, count),
            lambda: bt.ops.launch_run_merge(runs_k, runs_v, count, t, cmax,
                                            ok, ov),
            lambda: bref.merge_runs_ref(runs_k, runs_v, t, count),
            nbytes=16 * valid, ops=valid * t.bit_length(),
            library=lambda: lib_segments(runs_k, runs_v, 2 * t), **info),
            paths))
        del runs_k, runs_v, ok, ov, merged
    del got
    torch.cuda.empty_cache()
    return out


def other_kernel_phase(torch):
    """Phase 10, first part: each kernel of the other paths at the shapes
    those paths give it, against its plain version, timed beside its
    bound.  ``partition_classify`` alone (no rank) with nb = p = 256 and
    zero ties at SSort's (256, 2^20) and NS-SSort's (256, 2^19), ~2^18
    valid keys per row; the local sort's kernels at every path's first
    sort, (256, 2^19) with 2^18 valid keys per row (both of bitonic's
    sorts), and at SSort's and NS-SSort's sorts after the shuffle or the
    route, (256, p·slot_cap) with ~2^18; ``tile_sort`` at RFIS's (2^18, 4)
    and (2^18, 2048) rows and at GatherM's and AllGatherM's (2^12, 4),
    each with at most one valid key per row.  Returns [(row, paths)]."""
    from repro_torch.core.median import planes
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    pad_word = 2 ** 31 - 1
    rows_out = []
    rows, nb = P_MAIN, P_MAIN
    near = (1 << 18) - 2000 + (torch.arange(rows, device=dev) * 997) % 4000
    full = torch.full((rows,), 1 << 18, dtype=torch.int64, device=dev)

    for path, C, count in (("ssort", 1 << 20, near),
                           ("ns-ssort", 1 << 19, full)):
        keys = torch.sort(torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, C),
                                        generator=g, device=dev,
                                        dtype=torch.int32), dim=1)[0]
        col = torch.arange(C, device=dev)
        keys = torch.where(col[None, :] < count[:, None], keys, pad_word)
        del col
        ties = torch.zeros_like(keys)
        pick = torch.randint(0, int(count.min()), (nb - 1,), generator=g,
                             device=dev)
        s_keys = torch.sort(keys[0, pick])[0].expand(rows,
                                                     nb - 1).contiguous()
        s_ties = torch.zeros_like(s_keys)
        rows_out += [(row, (path,)) for row in partition_rows(
            torch, keys, ties, s_keys, s_ties, count, nb,
            path=path).values()]
        del keys, ties, s_keys, s_ties, pick
        torch.cuda.empty_cache()

    # SSort on 8-byte keys: the (hi, lo) planes of sorted int64 words, so
    # the ties are not zero, against u64 splitters drawn from the keys
    words = torch.randint(-2 ** 63, 2 ** 63 - 1, (rows, 1 << 20),
                          generator=g, device=dev, dtype=torch.int64)
    col = torch.arange(1 << 20, device=dev)
    words = torch.where(col[None, :] < near[:, None],
                        torch.sort(words, dim=1)[0], 2 ** 63 - 1)
    del col
    pick = torch.randint(0, int(near.min()), (nb - 1,), generator=g,
                         device=dev)
    keys, ties = planes(words)
    s_keys, s_ties = planes(torch.sort(words[0, pick])[0].expand(
        rows, nb - 1))
    del words, pick
    rows_out += [(row, ("ssort-int64",)) for row in partition_rows(
        torch, keys, ties, s_keys, s_ties, near, nb, wants=("bucket",),
        path="ssort-int64").values()]
    del keys, ties, s_keys, s_ties
    torch.cuda.empty_cache()

    # the shuffle's and the route's output: p slots of samplesort's
    # slot_cap = ceil(2·mean + 6·sqrt(mean) + 6), mean = capacity / p
    mean = 2 * (1 << LOG_N_MAIN) // P_MAIN / P_MAIN
    slot_cap = int(math.ceil(2 * mean + 6 * math.sqrt(mean) + 6))
    rows_out += sort_kernel_rows(torch, g, rows, 1 << 19, full,
                                 ("bitonic",), merge=True)
    rows_out += sort_kernel_rows(torch, g, rows, P_MAIN * slot_cap, near,
                                 ("ssort", "ns-ssort"), merge=True)
    one = torch.ones(P_RFIS, dtype=torch.int64, device=dev)
    for C in (4, 2048):
        rows_out += sort_kernel_rows(torch, g, P_RFIS, C, one, ("rfis",),
                                     merge=False)
    gathered = (torch.arange(P_GATHER, device=dev)
                < (1 << LOG_N_GATHER)).to(torch.int64)
    rows_out += sort_kernel_rows(torch, g, P_GATHER, 4, gathered,
                                 ("gatherm", "allgatherm"), merge=False)
    return rows_out


def other_paths_phase(torch, np, psort, SortConfig, generate_instance,
                      launch_counts, reset_launch_counts):
    """Phase 10, second and third parts: ``psort`` with each other
    algorithm at its size (``OTHER_PATHS``) after a warm-up, with the
    checks of phase 4 and its kernels launched; then each on the card
    against the CPU bit for bit (``OTHER_CHECKS``).  Returns each path's
    launches in its first measured sort."""
    first = {}
    for algorithm, p, log_n, instances, kernels in OTHER_PATHS:
        n = 1 << log_n
        cfg = SortConfig(p=p, algorithm=algorithm)
        for i, name in enumerate(instances):
            x = generate_instance(name, p, n).astype(np.uint32)
            if i == 0:                               # warm-up
                psort(x, cfg)
                torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, info = psort(x, cfg, return_info=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            peak = torch.cuda.max_memory_allocated()
            check_other(torch, np, x, out, info, n, p)
            missing = [k for k in kernels if launches[k] <= 0]
            if missing:
                raise AssertionError(f"kernels never launched on the "
                                     f"{algorithm} path: {missing}")
            first.setdefault(algorithm, launches)
            emit({"phase": "other_psort", "algorithm": info["algorithm"],
                  "instance": name, "p": p, "n": n, "wall_s": wall,
                  "keys_per_s": n / wall, "max_memory_allocated": peak,
                  "balance": info["balance"], "overflow": info["overflow"],
                  "launches": launches})
            del out, info, x
            torch.cuda.empty_cache()

    for algorithm, p, log_n in OTHER_CHECKS:
        n = 1 << log_n
        x = generate_instance("Uniform", p, n).astype(np.uint32)
        cfg = SortConfig(p=p, algorithm=algorithm)
        go, gi = psort(x, cfg, return_info=True, device="cuda")
        co, ci = psort(x, cfg, return_info=True, device="cpu")
        same = (torch.equal(go.view(torch.int32).cpu(), co.view(torch.int32))
                and torch.equal(gi["perm"].cpu(), ci["perm"])
                and torch.equal(gi["counts"].cpu(), ci["counts"])
                and gi["overflow"] == ci["overflow"])
        emit({"phase": "other_cuda_vs_cpu", "algorithm": algorithm, "p": p,
              "n": n, "instance": "Uniform", "identical": same,
              "overflow_cuda": gi["overflow"], "overflow_cpu": ci["overflow"]})
        if not same:
            raise AssertionError(f"{algorithm}: cuda and cpu runs differ")
        check_other(torch, np, x, go, gi, n, p)
    return first


def check_other(torch, np, x_np, out, info, n, p):
    """Phase-4 assertions on a psort result of any algorithm.  AllGatherM
    returns PE 0's copy, and its ``perm`` holds every PE's: p equal
    copies, the first of which the checks read."""
    if info["algorithm"] == "allgatherm":
        perm = info["perm"]
        if perm.numel() != p * n or not bool(
                (perm.view(p, n) == perm[None, :n]).all()):
            raise AssertionError("allgatherm's perm is not p copies of one")
        info = {**info, "perm": perm[:n]}
    check_sorted(torch, np, x_np, out, info, n)


def check_sorted(torch, np, x_np, out, info, n):
    """Phase-4 assertions on one psort result (all on the card): uint32
    keys, or int64 keys (phase 11)."""
    dev = out.device
    if out.dtype == torch.int64:
        return check_sorted64(torch, np, x_np, out, info, n)
    o = out.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ovf = info["overflow"]
    if o.numel() != n - ovf:
        raise AssertionError(f"{o.numel()} keys out, expected n - overflow "
                             f"= {n - ovf}")
    if o.numel() > 1 and not bool((o[1:] >= o[:-1]).all()):
        raise AssertionError("output is not nondecreasing")
    perm = info["perm"]
    sp = torch.sort(perm)[0]
    if sp.numel() > 1 and not bool((sp[1:] > sp[:-1]).all()):
        raise AssertionError("perm has a repeated entry")
    if sp.numel() and not (0 <= int(sp[0]) and int(sp[-1]) < n):
        raise AssertionError("perm indexes outside the input")
    xin = torch.from_numpy(x_np.view(np.int32)).to(dev).to(
        torch.int64) & 0xFFFFFFFF
    if not torch.equal(xin[perm], o):
        raise AssertionError("input[perm] != output")
    if ovf == 0 and not np.array_equal(
            np.sort(x_np), o.cpu().numpy().astype(np.uint32)):
        raise AssertionError("output differs from np.sort(input)")


def check_sorted64(torch, np, x_np, out, info, n):
    """The assertions of phase 4 on a psort result of int64 keys."""
    ovf = info["overflow"]
    if out.numel() != n - ovf:
        raise AssertionError(f"{out.numel()} keys out, expected n - overflow "
                             f"= {n - ovf}")
    if out.numel() > 1 and not bool((out[1:] >= out[:-1]).all()):
        raise AssertionError("output is not nondecreasing")
    perm = info["perm"]
    sp = torch.sort(perm)[0]
    if sp.numel() > 1 and not bool((sp[1:] > sp[:-1]).all()):
        raise AssertionError("perm has a repeated entry")
    if sp.numel() and not (0 <= int(sp[0]) and int(sp[-1]) < n):
        raise AssertionError("perm indexes outside the input")
    if not torch.equal(torch.from_numpy(x_np).to(out.device)[perm], out):
        raise AssertionError("input[perm] != output")
    if ovf == 0 and not np.array_equal(np.sort(x_np), out.cpu().numpy()):
        raise AssertionError("output differs from np.sort(input)")


def keys64(np, generate_instance, name, p, n, dtype):
    """The instance as 8-byte keys with its order and ties: the u32 word u
    as the u64 ``u << 32 | u`` (int64 views those bits), or the float64
    ``(u − 2^31) · 0.37``."""
    u = generate_instance(name, p, n).astype(np.uint64)
    if dtype == np.float64:
        return (u.astype(np.float64) - 2.0 ** 31) * 0.37
    return ((u << np.uint64(32)) | u).view(dtype)


def keys64_phase(torch, np, psort, SortConfig, generate_instance,
                 launch_counts, reset_launch_counts):
    """Phase 11: 8-byte keys.  First the card against the CPU bit for bit
    for int64, uint64 and float64 keys with each of the eight algorithms
    that take them, at the check sizes (which also warms their int64
    kernels); then each sorts int64 Uniform keys at its phase-8 or phase-10
    cell (``KEYS64_PATHS``) with the checks of phase 4, and its path's
    classify launched.
    RFIS first runs at p = 2^16, n = 2^16 and takes the cell only if 8x
    that peak stays under 70 GB.  Returns each path's launches."""
    for algorithm, p, log_n in KEYS64_CHECKS:
        n = 1 << log_n
        cfg = SortConfig(p=p, algorithm=algorithm)
        for dtype in (np.int64, np.uint64, np.float64):
            x = keys64(np, generate_instance, "Uniform", p, n, dtype)
            go, gi = psort(x, cfg, return_info=True, device="cuda")
            co, ci = psort(x, cfg, return_info=True, device="cpu")
            same = (go.dtype == co.dtype
                    and torch.equal(go.cpu().view(torch.int64),
                                    co.view(torch.int64))
                    and torch.equal(gi["perm"].cpu(), ci["perm"])
                    and torch.equal(gi["counts"].cpu(), ci["counts"])
                    and gi["overflow"] == ci["overflow"])
            emit({"phase": "keys64_cuda_vs_cpu", "algorithm": algorithm,
                  "dtype": np.dtype(dtype).name, "p": p, "n": n,
                  "instance": "Uniform", "identical": same,
                  "overflow_cuda": gi["overflow"],
                  "overflow_cpu": ci["overflow"]})
            if not same:
                raise AssertionError(f"{algorithm} on {np.dtype(dtype).name} "
                                     f"keys: cuda and cpu runs differ")
            if dtype == np.int64:
                check_other(torch, np, x, go, gi, n, p)

    def one_sort(algorithm, p, log_n):
        n = 1 << log_n
        x = keys64(np, generate_instance, "Uniform", p, n, np.int64)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, info = psort(x, SortConfig(p=p, algorithm=algorithm),
                          return_info=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if out.dtype != torch.int64:
            raise AssertionError(f"{algorithm} returned {out.dtype} keys")
        check_other(torch, np, x, out, info, n, p)
        row = {"phase": "keys64_psort", "algorithm": info["algorithm"],
               "dtype": "int64", "instance": "Uniform", "p": p, "n": n,
               "wall_s": wall, "keys_per_s": n / wall,
               "max_memory_allocated": peak, "balance": info["balance"],
               "overflow": info["overflow"], "launches": launches}
        del out, info, x
        torch.cuda.empty_cache()
        return row

    first = {}
    for algorithm, p, log_n, kernel in KEYS64_PATHS:
        if algorithm == "rfis":
            small = one_sort(algorithm, P_RFIS_CUT, LOG_N_RFIS_CUT)
            projected = 8 * small["max_memory_allocated"]
            cut = projected > RFIS_PEAK_LIMIT
            emit({**small, "phase": "keys64_rfis_reckoning",
                  "projected_peak_at_p_2_18": projected, "cut": cut})
            if cut:
                p, log_n = P_RFIS_CUT, LOG_N_RFIS_CUT
        row = one_sort(algorithm, p, log_n)
        if kernel is not None and row["launches"][kernel] <= 0:
            raise AssertionError(f"{kernel} never launched on the 8-byte "
                                 f"{algorithm} path")
        emit(row)
        first[algorithm] = row["launches"]
    return first


def trace_phase(torch, SortConfig, ExternalPolicy, trace_collectives,
                overlap=False):
    """Phase 12: every algorithm's collective trace on the card equals its
    trace on the CPU, event for event, at the card-vs-CPU check sizes (the
    external lane at phase 7's); then the paper's Table I on the card:
    launches, point-to-point launches and wire bytes per PE (and the
    lane's host-device bytes) at each path's cell, one JSON line.  With
    ``overlap`` (phase 14) the check only, of the streamed exchanges."""
    def events(t):
        return [(e.primitive, e.bytes, e.group_size, e.axis, e.tag)
                for e in t.events]

    ext_check = SortConfig(p=P_EXT, overlap=overlap, external=ExternalPolicy(
        budget=BUDGET_EXT_CHECK))
    checks = [(a, p, log_n, SortConfig(p=p, algorithm=a, overlap=overlap))
              for a, p, log_n in TRACE_CHECKS]
    checks.append(("external", P_EXT, LOG_N_EXT_CHECK, ext_check))
    for algorithm, p, log_n, cfg in checks:
        got = trace_collectives(1 << log_n, cfg, device="cuda")
        want = trace_collectives(1 << log_n, cfg, device="cpu")
        same = (events(got) == events(want)
                and got.summary(p) == want.summary(p)
                and got.io_bytes() == want.io_bytes())
        emit({"phase": "trace_cuda_vs_cpu", "algorithm": algorithm, "p": p,
              "n": 1 << log_n, "overlap": overlap,
              "events": len(got.events), "ovl_events": sum(
                  1 for e in got.events if (e.tag or "").startswith("ovl:")),
              "identical": same})
        if not same:
            raise AssertionError(f"{algorithm}: the trace on the card "
                                 f"differs from the CPU's")
    if overlap:
        return
    cells = [(a, p, log_n, SortConfig(p=p, algorithm=a))
             for a, p, log_n in TRACE_CELLS]
    cells.append(("external", P_EXT, LOG_N_EXT, SortConfig(
        p=P_EXT, external=ExternalPolicy(budget=BUDGET_EXT))))
    table = []
    for algorithm, p, log_n, cfg in cells:
        t = trace_collectives(1 << log_n, cfg, device="cuda")
        table.append({"algorithm": algorithm, "p": p, "n": 1 << log_n,
                      "launches": t.launches,
                      "p2p_launches": t.p2p_launches,
                      "fused_launches": t.fused_launches,
                      "wire_bytes": t.wire_bytes(),
                      "io_bytes": t.io_bytes(),
                      "counts": t.counts()})
    emit({"table1": table})


def calibrate_tool():
    """``tools/calibrate_torch.py`` of this checkout, as a module."""
    import importlib.util
    path = Path(__file__).resolve().parent / "tools" / "calibrate_torch.py"
    spec = importlib.util.spec_from_file_location("calibrate_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same_result(torch, a, b) -> bool:
    """Two psort results (output, info) equal bit for bit: keys, perm,
    counts and overflow."""
    (ao, ai), (bo, bi) = a, b
    return (torch.equal(ao.view(torch.int32).cpu(), bo.view(torch.int32).cpu())
            and torch.equal(ai["perm"].cpu(), bi["perm"].cpu())
            and torch.equal(ai["counts"].cpu(), bi["counts"].cpu())
            and ai["overflow"] == bi["overflow"])


def timed_psort(torch, psort, x, cfg, reset_launch_counts, launch_counts,
                **kw):
    """One psort after a reset of the launch counts: (out, info, wall s,
    launches, peak bytes)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, info = psort(x, cfg, return_info=True, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, info, wall, launch_counts(),
            torch.cuda.max_memory_allocated())


def selection_phase(torch, np, psort, SortConfig, generate_instance,
                    launch_counts, reset_launch_counts):
    """Phase 13: the committed profile (the port's DEFAULT_MODEL) and its
    regime tables; a fresh profile from the tool's phase 1 beside it; then
    ``psort(algorithm="auto")`` at each regime cell, bit for bit equal to
    the algorithm it picked (a pick whose reckoned peak passes 60 GB is
    printed with that size and not run)."""
    from repro_torch.core import selection
    t0 = time.perf_counter()
    model = selection.DEFAULT_MODEL
    consts = ("alpha", "alpha_c", "alpha_hop", "beta", "local_rate",
              "partition_rate", "io_beta", "overlap")
    emit({"phase": "profile", "name": model.name,
          "card": model.meta.get("card"),
          **{k: getattr(model, k) for k in consts}})
    if "H100" not in str(model.meta.get("card")):
        raise AssertionError(f"the committed profile was not measured on an "
                             f"H100: {model.meta.get('card')!r}")
    for p in REGIME_PS:
        emit({"phase": "regime_table", "p": p, "rows": [
            [e, a] for e, _, a in selection.regime_table(p, range(-8, 24))]})
    tool = calibrate_tool()
    fresh = tool.measure_profile(FRESH_PS, "fresh", "cuda")
    emit({"phase": "profile_fresh", "p": list(FRESH_PS),
          "card": fresh.meta["card"],
          **{k: getattr(fresh, k) for k in consts},
          "committed": {k: getattr(model, k) for k in consts}})
    for k in consts:
        v = getattr(fresh, k)
        if not math.isfinite(v) or (k != "overlap" and v <= 0):
            raise AssertionError(f"fresh profile: {k} = {v}")
    if not 0.0 <= fresh.overlap <= 1.0:
        raise AssertionError(f"fresh profile: overlap {fresh.overlap}")
    for cell, p, log_n in AUTO_CELLS:
        n = 1 << log_n
        chosen = selection.select_algorithm(n, p)
        need = tool.reckon_bytes(chosen, n, p)
        row = {"phase": "auto", "cell": cell, "p": p, "n": n,
               "chosen": chosen, "reckoned_bytes": need}
        if need > AUTO_PEAK_LIMIT:
            emit({**row, "run": False})
            continue
        x = generate_instance("Uniform", p, n).astype(np.uint32)
        auto = timed_psort(torch, psort, x, SortConfig(p=p), reset_launch_counts,
                           launch_counts)
        named = timed_psort(torch, psort, x, SortConfig(p=p, algorithm=chosen),
                            reset_launch_counts, launch_counts)
        same = same_result(torch, auto[:2], named[:2])
        emit({**row, "run": True, "algorithm": auto[1]["algorithm"],
              "wall_s": auto[2], "named_wall_s": named[2],
              "max_memory_allocated": auto[4], "identical": same})
        if not same or auto[1]["algorithm"] != chosen:
            raise AssertionError(f"auto at {cell}'s cell differs from "
                                 f"{chosen}")
        del auto, named, x
        torch.cuda.empty_cache()
    emit({"phase": "selection_done", "seconds": time.perf_counter() - t0})


def overlap_phase(torch, np, psort, SortConfig, ExternalPolicy,
                  generate_instance, launch_counts, reset_launch_counts,
                  trace_collectives):
    """Phase 14: ``overlap=True`` against the barrier path, bit for bit,
    with both wall times and launches: RAMS and SSort at p = 256,
    n = 2^26 (Uniform), the external lane at p = 16, n = 2^20,
    budget 2^13; the card against the CPU with ``overlap=True``; and
    phase 12's trace check with ``overlap=True``.  Returns the launches of
    each streamed path's first measured sort, and the local sort's kernel
    rows at the shapes of the blocks it sorts."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    spread = torch.arange(P_MAIN, device=dev) * 997
    # the blocks each streamed exchange sorts as they arrive, at
    # p = 256, n = 2^26: the shuffle's (and SSort's route's) 256 blocks of
    # slot_cap 4374 with ~1024 keys, RAMS level 0's of 8582 with ~1024,
    # level 1's 16 blocks of 132 614 with ~16 384 (one merge pass)
    chunk_rows = []
    for C, valid, merge, paths in (
            (4374, 1024, False, ("rams-overlap", "ssort-overlap")),
            (8582, 1024, False, ("rams-overlap",)),
            (132614, 1 << 14, True, ("rams-overlap",))):
        count = valid - 32 + spread % 64
        chunk_rows += sort_kernel_rows(torch, g, P_MAIN, C, count, paths,
                                       merge)
    first = {}
    n = 1 << LOG_N_MAIN
    for algorithm, kernels in OVERLAP_PATHS:
        cfg = SortConfig(p=P_MAIN, algorithm=algorithm)
        for i, name in enumerate(OVERLAP_INSTANCES):
            x = generate_instance(name, P_MAIN, n).astype(np.uint32)
            if i == 0:                               # warm-up
                psort(x, cfg.replace(overlap=True))
                torch.cuda.synchronize()
            bar = timed_psort(torch, psort, x, cfg, reset_launch_counts,
                              launch_counts)
            ovl = timed_psort(torch, psort, x, cfg.replace(overlap=True),
                              reset_launch_counts, launch_counts)
            same = same_result(torch, bar[:2], ovl[:2])
            check_sorted(torch, np, x, ovl[0], ovl[1], n)
            missing = [k for k in kernels if ovl[3][k] <= 0]
            first.setdefault(algorithm, ovl[3])
            emit({"phase": "overlap_psort", "algorithm": algorithm,
                  "instance": name, "p": P_MAIN, "n": n, "identical": same,
                  "barrier_wall_s": bar[2], "overlap_wall_s": ovl[2],
                  "ratio": ovl[2] / bar[2],
                  "barrier_max_memory_allocated": bar[4],
                  "overlap_max_memory_allocated": ovl[4],
                  "overflow": ovl[1]["overflow"],
                  "barrier_launches": bar[3], "overlap_launches": ovl[3]})
            if not same:
                raise AssertionError(f"{algorithm} {name}: overlap=True "
                                     f"differs from the barrier path")
            if missing:
                raise AssertionError(f"kernels never launched on the "
                                     f"streamed {algorithm} path: {missing}")
            del bar, ovl, x
            torch.cuda.empty_cache()

    n = 1 << LOG_N_EXT_CHECK
    x = generate_instance("Uniform", P_EXT, n).astype(np.uint32)
    cfg = SortConfig(p=P_EXT, algorithm="external", external=ExternalPolicy(
        budget=BUDGET_EXT_CHECK))
    psort(x, cfg.replace(overlap=True))                # warm-up
    bar = timed_psort(torch, psort, x, cfg, reset_launch_counts,
                      launch_counts)
    ovl = timed_psort(torch, psort, x, cfg.replace(overlap=True),
                      reset_launch_counts, launch_counts)
    cpu = psort(x, cfg.replace(overlap=True), return_info=True, device="cpu")
    same = same_result(torch, bar[:2], ovl[:2])
    same_cpu = same_result(torch, ovl[:2], cpu)
    first["external"] = ovl[3]
    emit({"phase": "overlap_external", "p": P_EXT, "n": n,
          "budget": BUDGET_EXT_CHECK, "identical": same,
          "identical_cpu": same_cpu, "barrier_wall_s": bar[2],
          "overlap_wall_s": ovl[2], "ratio": ovl[2] / bar[2],
          "barrier_launches": bar[3], "overlap_launches": ovl[3]})
    if not (same and same_cpu):
        raise AssertionError("the streamed external lane differs")
    # at this budget (one tile) a run needs no merge pass: the lane's
    # classify and tile sorts are its kernels
    missing = [k for k in ("kway_classify", "tile_sort") if ovl[3][k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the streamed "
                             f"lane: {missing}")

    for algorithm, p, log_n in OVERLAP_CHECKS:
        n = 1 << log_n
        x = generate_instance("Uniform", p, n).astype(np.uint32)
        cfg = SortConfig(p=p, algorithm=algorithm, overlap=True)
        go = psort(x, cfg, return_info=True, device="cuda")
        co = psort(x, cfg, return_info=True, device="cpu")
        same = same_result(torch, go, co)
        emit({"phase": "overlap_cuda_vs_cpu", "algorithm": algorithm,
              "p": p, "n": n, "identical": same,
              "overflow": go[1]["overflow"]})
        if not same:
            raise AssertionError(f"{algorithm}: streamed cuda and cpu runs "
                                 f"differ")
        check_sorted(torch, np, x, go[0], go[1], n)
    trace_phase(torch, SortConfig, ExternalPolicy, trace_collectives,
                overlap=True)
    emit({"phase": "overlap_done", "seconds": time.perf_counter() - t0})
    return first, chunk_rows


def batch_kernel_rows(torch):
    """Phase 15, first part: the RAMS kernels at the shapes of the batched
    RAMS cell (d = 4 sorts of n = 2^24 at p = 256: 1024 rows of capacity
    2^17), as phase 3 times them: ``tile_sort`` and one ``run_merge`` pass
    on level 0's route output (1024, 256·2246) with ~2^16 valid keys per
    row, and every classify variant and ``partition_rank`` with nb = 64
    on the level's (1024, 2^18) sorted keys with ~2^16 valid.  Returns
    (rows keyed by launch key, [(row, paths)] of the local sort)."""
    return rams_kernel_rows(torch, D_BATCH * P_MAIN, P_MAIN,
                            1 << (LOG_N_BATCH - LOG_P_MAIN), "rams-batched",
                            seed=15)


def rams_kernel_rows(torch, rows, p, per, path, seed):
    """The RAMS kernels at the shapes of level 0 of a sort of ``rows``
    rows of ``per`` keys on p PEs (rows = d·p), as phase 3 times them:
    ``tile_sort`` and one ``run_merge`` pass on the level's route output
    (rows, p·slot_cap) and every classify variant and ``partition_rank``
    with nb = 64 on its (rows, 4·per) sorted keys (the shuffle's
    capacity), ~per valid keys per row in both.  Returns (rows keyed by
    launch key, [(row, paths)] of the local sort)."""
    from repro_torch.core.rams import _slot_cap
    from repro_torch.kernels import partition as pt
    from repro_torch.kernels.partition import ref as pref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    C, nb = 4 * per, 64
    count = per - (torch.arange(rows, device=dev) * 997) % 2000
    sort_rows = sort_kernel_rows(torch, g, rows, p * _slot_cap(C, p, 2.0),
                                 count, (path,), merge=True)
    col = torch.arange(C, device=dev)
    keys = torch.sort(torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, C),
                                    generator=g, device=dev,
                                    dtype=torch.int32), dim=1)[0]
    keys = torch.where(col[None, :] < count[:, None], keys, 2 ** 31 - 1)
    del col
    ties = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, C), generator=g,
                         device=dev, dtype=torch.int32)
    pick = torch.randint(0, int(count.min()), (rows, nb - 1), generator=g,
                         device=dev)
    comp = torch.sort((torch.gather(keys, 1, pick).to(torch.int64) << 32)
                      | (torch.gather(ties, 1, pick).to(torch.int64)
                         & 0xFFFFFFFF), dim=1)[0]
    s_keys = (comp >> 32).to(torch.int32).contiguous()
    s_ties = ((comp & 0xFFFFFFFF) - ((comp & 0x80000000) << 1)).to(
        torch.int32).contiguous()
    del pick, comp
    results = partition_rows(torch, keys, ties, s_keys, s_ties, count, nb,
                             path=path)
    bucket, th = pt.classify(keys, ties, s_keys, s_ties, count, n_buckets=nb)
    off = torch.cumsum(th, dim=1, dtype=torch.int32) - th
    valid = int(count.sum())
    measure(torch, results, "partition_rank", SRC_P, REPLACES_P,
            [pt.rank(bucket, off, n_buckets=nb)],
            [pref.rank_ref(bucket, off, n_buckets=nb, tile=pt.PTILE)],
            lambda: pt.rank(bucket, off, n_buckets=nb),
            lambda: pref.rank_ref(bucket, off, n_buckets=nb, tile=pt.PTILE),
            nbytes=8 * rows * C + 4 * th.numel(), ops=valid,
            shape=[rows, C], path=path)
    del keys, ties, s_keys, s_ties, bucket, th, off
    torch.cuda.empty_cache()
    return results, sort_rows


def same_rows(torch, a, b) -> bool:
    """Two 1-D psort outputs (keys or perm) bit for bit, on any device."""
    return a.shape == b.shape and torch.equal(
        a.view(torch.int32).cpu() if a.element_size() == 4 else a.cpu(),
        b.view(torch.int32).cpu() if b.element_size() == 4 else b.cpu())


def batch_against_rows(torch, np, psort, x, cfg, batched, n, rows,
                       reset_launch_counts, launch_counts):
    """Each of ``rows`` of a timed batched run (out, info, wall, launches,
    peak) against the port's 1-D sort of that row on the card, bit for
    bit (keys, perm, counts, overflow), with the checks of phase 4.
    Returns the 1-D walls and each row's overflow."""
    out, info = batched[0], batched[1]
    walls, overflows = [], []
    for r in rows:
        one = timed_psort(torch, psort, x[r], cfg, reset_launch_counts,
                          launch_counts)
        got = out[r]
        ovf = n - int(info["counts"][r].sum())
        same = (same_rows(torch, got, one[0])
                and same_rows(torch, info["perm"][r],
                              one[1]["perm"])
                and torch.equal(info["counts"][r].cpu(),
                                one[1]["counts"].cpu())
                and ovf == one[1]["overflow"])
        if not same:
            raise AssertionError(f"{cfg.algorithm}: row {r} of the batch "
                                 f"differs from its 1-D sort")
        check_sorted(torch, np, x[r], got, {
            "perm": info["perm"][r], "overflow": ovf}, n)
        walls.append(one[2])
        overflows.append(ovf)
        del one, got
    return walls, overflows


def batched_phase(torch, np, psort, SortConfig, generate_instance,
                  launch_counts, reset_launch_counts, trace_collectives):
    """Phase 15: batched (d, n) keys and nested meshes on the card.

    Batched RAMS, d = 4 rows of n = 2^24 at p = 256 (the RAMS cell's 2^27
    slots), on four Uniform rows of their own seeds and on [Uniform,
    Zero, AllToOne, Staggered], after a warm-up; batched RQuick, d = 4
    rows of n = 2^24 at p = 2^16 (RQuick's cell's 2^18 rows of 1024);
    nested RAMS at the RAMS cell (p = 256, n = 2^26) on the meshes
    (16, 16) and (4, 64) against the flat sort on the same schedule, with
    both walls and peaks, and each mesh's trace on the card against the
    CPU's; then the card against the CPU for the ten algorithms batched,
    nested, batched and nested, and RAMS and SSort batched with
    ``overlap=True``.  Returns the launches of the batched RAMS, batched
    RQuick and nested RAMS runs."""
    t0 = time.perf_counter()
    launches = {}
    n = 1 << LOG_N_BATCH
    cfg = SortConfig(p=P_MAIN, algorithm="rams")
    for label, names in (("uniform", ("Uniform",) * D_BATCH),
                         ("mixed", BATCH_MIXED)):
        x = np.stack([generate_instance(name, P_MAIN, n, seed=r).astype(
            np.uint32) for r, name in enumerate(names)])
        if label == "uniform":                       # warm-up
            psort(x, cfg)
            torch.cuda.synchronize()
        batched = timed_psort(torch, psort, x, cfg, reset_launch_counts,
                              launch_counts)
        missing = [k for k in RAMS_LAUNCHES if batched[3][k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the batched "
                                 f"RAMS path: {missing}")
        launches.setdefault("rams-batched", batched[3])
        walls, overflows = batch_against_rows(
            torch, np, psort, x, cfg, batched, n, range(D_BATCH),
            reset_launch_counts, launch_counts)
        emit({"phase": "batched_rams", "batch": label,
              "instances": list(names), "d": D_BATCH, "p": P_MAIN, "n": n,
              "identical_rows": True, "wall_s": batched[2],
              "rows_wall_s": walls, "rows_wall_sum_s": sum(walls),
              "max_memory_allocated": batched[4],
              "overflow_rows": overflows,
              "overflow": batched[1]["overflow"],
              "balance": batched[1]["balance"], "launches": batched[3]})
        del batched, x
        torch.cuda.empty_cache()

    cfg = SortConfig(p=P_BATCH_RQUICK, algorithm="rquick")
    x = np.stack([generate_instance("Uniform", P_BATCH_RQUICK, n,
                                    seed=r).astype(np.uint32)
                  for r in range(D_BATCH)])
    batched = timed_psort(torch, psort, x, cfg, reset_launch_counts,
                          launch_counts)
    missing = [k for k in RQUICK_KERNELS if batched[3][k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the batched "
                             f"RQuick path: {missing}")
    launches["rquick-batched"] = batched[3]
    walls, overflows = batch_against_rows(
        torch, np, psort, x, cfg, batched, n, (0, 1), reset_launch_counts,
        launch_counts)
    emit({"phase": "batched_rquick", "d": D_BATCH, "p": P_BATCH_RQUICK,
          "n": n, "identical_rows": [0, 1], "wall_s": batched[2],
          "rows_wall_s": walls, "max_memory_allocated": batched[4],
          "overflow_rows": overflows, "overflow": batched[1]["overflow"],
          "balance": batched[1]["balance"], "launches": batched[3]})
    del batched, x
    torch.cuda.empty_cache()
    emit({"phase": "batched_done", "seconds": time.perf_counter() - t0})

    from repro_torch.core.rams import nested_level_bits
    n = 1 << LOG_N_MAIN
    x = generate_instance("Uniform", P_MAIN, n).astype(np.uint32)
    for mesh in NESTED_MESHES:
        bits = tuple(nested_level_bits(*mesh))
        nested_cfg = SortConfig(mesh_shape=mesh, algorithm="rams")
        flat_cfg = SortConfig(p=P_MAIN, algorithm="rams",
                              algo_kw={"level_bits": bits})
        psort(x, nested_cfg)                         # warm-up
        torch.cuda.synchronize()
        nest = timed_psort(torch, psort, x, nested_cfg, reset_launch_counts,
                           launch_counts)
        flat = timed_psort(torch, psort, x, flat_cfg, reset_launch_counts,
                           launch_counts)
        same = same_result(torch, nest[:2], flat[:2])
        check_sorted(torch, np, x, nest[0], nest[1], n)
        missing = [k for k in RAMS_LAUNCHES if nest[3][k] <= 0]
        launches.setdefault("rams-nested", nest[3])
        t_card = trace_collectives(1 << LOG_N_NESTED_TRACE, nested_cfg,
                                   device="cuda")
        t_cpu = trace_collectives(1 << LOG_N_NESTED_TRACE, nested_cfg,
                                  device="cpu")
        t_cell = trace_collectives(n, nested_cfg, device="cuda")
        trace_same = [(e.primitive, e.bytes, e.group_size, e.axis, e.tag)
                      for e in t_card.events] == [
            (e.primitive, e.bytes, e.group_size, e.axis, e.tag)
            for e in t_cpu.events]
        inter = t_cell.filter(primitive="all_to_all", axis="inter").tags()
        emit({"phase": "nested_rams", "mesh_shape": list(mesh),
              "level_bits": list(bits), "p": P_MAIN, "n": n,
              "identical_to_flat": same, "nested_wall_s": nest[2],
              "flat_wall_s": flat[2], "ratio": nest[2] / flat[2],
              "nested_max_memory_allocated": nest[4],
              "flat_max_memory_allocated": flat[4],
              "overflow": nest[1]["overflow"],
              "nested_launches": nest[3], "flat_launches": flat[3],
              "trace_identical_cpu": trace_same,
              "trace_n": 1 << LOG_N_NESTED_TRACE,
              "wire_bytes_by_axis": {a: s["wire_bytes"] for a, s in
                                     t_cell.by_axis().items()},
              "inter_all_to_all_tags": inter})
        if not same:
            raise AssertionError(f"nested RAMS on {mesh} differs from the "
                                 f"flat run on {bits}")
        if missing:
            raise AssertionError(f"kernels never launched on the nested "
                                 f"RAMS path: {missing}")
        if not trace_same:
            raise AssertionError(f"the nested trace on {mesh} differs on "
                                 f"the card from the CPU's")
        if inter != ["level0", "shuffle"]:
            raise AssertionError(f"inter-axis all_to_all tags {inter}")
        del nest, flat
        torch.cuda.empty_cache()
    del x
    emit({"phase": "nested_done", "seconds": time.perf_counter() - t0})

    # the card against the CPU at the check size, every in-core algorithm
    d, p, n = 2, 1 << 4, 1 << 14
    xs = np.stack([generate_instance(name, p, n, seed=r).astype(np.uint32)
                   for r, name in enumerate(("Uniform", "Staggered"))])
    layouts = (("batched", xs, {"p": p}), ("nested", xs[0],
                                           {"mesh_shape": (2, 8)}),
               ("batched-nested", xs, {"mesh_shape": (2, 8)}))
    checks = [(a, label, keys, kw) for a in ALGORITHMS
              for label, keys, kw in layouts]
    checks += [(a, "batched-overlap", xs, {"p": p, "overlap": True})
               for a in ("rams", "ssort")]
    for algorithm, label, keys, kw in checks:
        c = SortConfig(algorithm=algorithm, **kw)
        go = psort(keys, c, return_info=True, device="cuda")
        co = psort(keys, c, return_info=True, device="cpu")
        rows = range(len(keys)) if keys.ndim == 2 else (slice(None),)
        same = (all(same_rows(torch, go[0][r], co[0][r])
                    and same_rows(torch, go[1]["perm"][r], co[1]["perm"][r])
                    for r in rows)
                and torch.equal(go[1]["counts"].cpu(), co[1]["counts"])
                and go[1]["overflow"] == co[1]["overflow"])
        emit({"phase": "batched_cuda_vs_cpu", "algorithm": algorithm,
              "layout": label, "d": d if keys.ndim == 2 else 1, "p": p,
              "n": n, **{k: list(v) if isinstance(v, tuple) else v
                         for k, v in kw.items() if k != "p"},
              "identical": same, "overflow": go[1]["overflow"]})
        if not same:
            raise AssertionError(f"{algorithm} {label}: cuda and cpu runs "
                                 f"differ")
    emit({"phase": "batched_nested_done",
          "seconds": time.perf_counter() - t0})
    return launches


def ingest_kernel_rows(torch):
    """Phase 16, first part: ``tile_sort`` and one ``run_merge`` pass at
    the shape the serving ingest gives them, (256, 2^18) full rows of
    keys with no payload (``shard_data`` at p = 256, n = 2^26), each
    against its plain version, timed beside its bound (8 bytes a key:
    read once, written once) and the library's sort of the same segments.
    Returns the rows keyed by kernel."""
    from repro_torch.kernels import bitonic as bt
    from repro_torch.kernels.bitonic import ref as bref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    src = "src/repro_torch/kernels/bitonic/csrc/bitonic.cu"
    rows, C = P_SERVE, 1 << (LOG_N_SERVE - LOG_P_MAIN)
    t = bt.TILE
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, C), generator=g,
                         device=dev, dtype=torch.int32)
    count = torch.full((rows,), C, dtype=torch.int64, device=dev)
    info = {"shape": [rows, C], "valid_keys": rows * C,
            "path": "serve-ingest"}

    def segments(k, seg):
        return torch.sort(k.reshape(-1, seg), dim=1)[0].view(rows, C)

    out = {}
    runs = bt.sort_tiles(keys, None, count)[0]
    measure(torch, out, "tile_sort", src,
            "src/repro/kernels/bitonic/bitonic.py:121", [runs],
            [bref.sort_tiles_ref(keys, None, t, count)[0]],
            lambda: bt.sort_tiles(keys, None, count),
            lambda: bref.sort_tiles_ref(keys, None, t, count),
            nbytes=8 * rows * C, ops=rows * C * (t.bit_length() - 1),
            library=lambda: segments(keys, t), **info)
    del keys
    merged = torch.empty_like(runs)
    measure(torch, out, "run_merge", src,
            "src/repro/kernels/bitonic/bitonic.py:146",
            [bt.merge_runs(runs, None, t, count)[0]],
            [bref.merge_runs_ref(runs, None, t, count)[0]],
            lambda: bt.ops.launch_run_merge(runs, None, count, t, C, merged,
                                            None),
            lambda: bref.merge_runs_ref(runs, None, t, count),
            nbytes=8 * rows * C, ops=rows * C * t.bit_length(),
            library=lambda: segments(runs, 2 * t), **info)
    del runs, merged
    torch.cuda.empty_cache()
    return out


def key_words(torch, x, device):
    """numpy keys → the port's words (``key_to_int``) on ``device``."""
    from repro_torch.core.types import key_to_int
    return key_to_int(torch.from_numpy(x).to(device))


def same_bits(np, a, b) -> bool:
    """Two numpy keys or arrays equal bit for bit, dtype included."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def serve_args(torch, np, rng, x, oracle, batch):
    """Query batches of phase 16 over keys ``x`` (numpy) with sorted
    words ``oracle`` on the card: ranks with 1, 2, n/2, n − 1 and n;
    percentiles with 0 and 100; k = 1 … batch; keys with the minimum, the
    maximum and one absent from the data; intervals with an empty one
    (lo = hi), one with hi < lo and (min, max)."""
    n = len(x)
    ranks = np.concatenate([[1, 2, n // 2, n - 1, n], rng.integers(
        1, n + 1, size=batch - 5)]).astype(np.int64)
    qs = np.concatenate([[0.0, 100.0], rng.uniform(0, 100, batch - 2)])
    lo_key, hi_key = x.min(), x.max()
    info = np.iinfo(x.dtype) if x.dtype.kind in "iu" else None
    draws = (rng.integers(info.min, info.max, size=64, dtype=x.dtype,
                          endpoint=True) if info is not None
             else rng.uniform(-1e12, 1e12, 64).astype(x.dtype))
    w = key_words(torch, draws, oracle.device)
    absent = (torch.searchsorted(oracle, w) ==
              torch.searchsorted(oracle, w, right=True)).cpu().numpy()
    if not absent.any():
        raise AssertionError("no absent key among 64 draws")
    absent_key = draws[np.argmax(absent)]
    keys = np.concatenate([[lo_key, hi_key, absent_key],
                           x[rng.integers(0, n, batch - 3)]]).astype(x.dtype)
    a, b = x[rng.integers(0, n, batch)], x[rng.integers(0, n, batch)]
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    lo[0] = hi[0]                                     # empty
    lo[1], hi[1] = x.max(), x.min()                   # hi < lo
    lo[2], hi[2] = x.min(), x.max()
    return {"ranks": ranks, "q": qs, "k": np.arange(1, batch + 1),
            "keys": keys, "lo": lo, "hi": hi}


def serve_expected(torch, np, oracle, dtype, args):
    """The oracle's answers (sorted words ``oracle`` on the card) to the
    batches of :func:`serve_args`, as the port returns them."""
    from repro_torch.core.queries import _np_keys
    dev, n = oracle.device, oracle.numel()

    def keys(words):
        return _np_keys(words.cpu().numpy(), dtype)

    def ranks(words):
        return (torch.searchsorted(oracle, words).cpu().numpy(),
                torch.searchsorted(oracle, words, right=True).cpu().numpy())

    sel = oracle[torch.as_tensor(args["ranks"] - 1, device=dev)]
    pct = oracle[torch.as_tensor(np.floor(args["q"] / 100.0 * (n - 1))
                                 .astype(np.int64), device=dev)]
    lo = torch.searchsorted(oracle, key_words(torch, args["lo"], dev))
    hi = torch.searchsorted(oracle, key_words(torch, args["hi"], dev))
    return {"select": (keys(sel),) + ranks(sel), "percentile": keys(pct),
            "top_k": [keys(oracle[n - int(k):]) for k in args["k"]],
            "rank_of_key": ranks(key_words(torch, args["keys"], dev)),
            "range_query": np.maximum((hi - lo).cpu().numpy(), 0)}


def serve_answers(np, Q, data, args, window=True):
    """Every query kind over ``data`` on the batches of
    :func:`serve_args` (``window`` for select_rank)."""
    return {"select": Q.select_rank(data, args["ranks"], window=window),
            "percentile": Q.percentile(data, args["q"]),
            "top_k": Q.top_k(data, args["k"]),
            "rank_of_key": Q.rank_of_key(data, args["keys"]),
            "range_query": Q.range_query(data, args["lo"], args["hi"])}


def same_answers(np, got, want) -> list:
    """The kinds whose answers differ bit for bit."""
    bad = []
    for kind, w in want.items():
        g = got[kind]
        if isinstance(w, (tuple, list)):
            ok = len(g) == len(w) and all(same_bits(np, a, b)
                                          for a, b in zip(g, w))
        else:
            ok = same_bits(np, g, w)
        if not ok:
            bad.append(kind)
    return bad


def host_syncs(torch, fn) -> dict:
    """Synchronising CUDA runtime calls of one ``fn()``, as
    ``torch.profiler`` records them on the host, less those it records
    around an empty window (its own)."""
    from torch.profiler import ProfilerActivity, profile
    names = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
             "cudaEventSynchronize", "cudaMemcpy")

    def count(f):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            f()
        return {e.key: e.count for e in prof.key_averages()
                if e.key in names}
    own, got = count(lambda: None), count(fn)
    return {k: v - own.get(k, 0) for k, v in got.items()
            if v != own.get(k, 0)}


MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def device_breakdown(torch, fn, top: int = 8, with_flops: bool = False
                     ) -> dict:
    """Where one ``fn()`` spends the card's time under ``torch.profiler``:
    its wall, the device operations and their summed time, and the
    ``top`` operation names by device time; ``with_flops``, also the
    profiler's FLOPs summed over the matmul operators (``MATMUL_OPS``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_flops=with_flops) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + us)
    busy = sum(t for _, t in by_name.values()) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy,
           "device_ops": sum(n for n, _ in by_name.values()),
           "top": [{"name": name[:90], "launches": n, "ms": t / 1e3}
                   for name, (n, t) in ranked]}
    if with_flops:
        out["matmul_flops"] = sum(
            e.flops or 0 for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name in MATMUL_OPS)
    return out


def time_batch(torch, fn, reps: int = REPS):
    """(median wall s of ``reps`` calls after a warm-up, peak bytes of one
    call, its host syncs): each call ends with its answers on the host."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    fn()
    peak = torch.cuda.max_memory_allocated()
    return statistics.median(walls), peak, host_syncs(torch, fn)


def service_run(torch, np, SortService, SortConfig, parse_mix, gen_stream,
                keys, p, policy, queries, device, seed=0):
    """The reference CLI's stream of ``queries`` requests over ``keys``
    through one ``SortService``: (service, results in order, drain wall
    s)."""
    svc = SortService(keys, config=SortConfig(p=p, algorithm=SERVE_SORT),
                      policy=policy, max_batch=SERVE_B, device=device)
    rng = np.random.default_rng(seed)
    pool = keys[rng.integers(0, len(keys), size=256)]
    for kind, arg in gen_stream(rng, len(keys), queries,
                                parse_mix(SERVE_MIX), pool):
        svc.submit(kind, arg)
    t0 = time.perf_counter()
    done = svc.drain()
    return svc, done, time.perf_counter() - t0


def check_service(torch, np, done, oracle, dtype):
    """Every answer of a drained stream against the oracle (sorted words
    on the card; the keys are unsigned, so the key order is the word
    order on both paths)."""
    from repro_torch.core.queries import _np_keys
    n = oracle.numel()
    bad = 0
    for r in done:
        kind, arg, v = r.request.kind, r.request.arg, r.value
        if kind == "top_k":
            ok = same_bits(np, v, _np_keys(oracle[n - arg:].cpu().numpy(),
                                           dtype))
        elif kind == "percentile":
            i = int(np.floor(arg / 100.0 * (n - 1)))
            ok = same_bits(np, np.asarray(v), _np_keys(
                oracle[i:i + 1].cpu().numpy(), dtype)[0])
        elif kind == "rank_of_key":
            w = key_words(torch, np.asarray([arg], dtype), oracle.device)
            ok = tuple(v) == (int(torch.searchsorted(oracle, w)),
                              int(torch.searchsorted(oracle, w, right=True)))
        else:
            lo, hi = key_words(torch, np.asarray(arg, dtype), oracle.device)
            ok = int(v) == max(int(torch.searchsorted(oracle, hi[None]))
                               - int(torch.searchsorted(oracle, lo[None])),
                               0)
        bad += not ok
    return bad


def serve_phase(torch, np, generate_instance, launch_counts,
                reset_launch_counts, rams_wall):
    """Phase 16: query serving over the RAMS cell's data on the card.

    The ingest (``shard_data``, p = 256, n = 2^26 Uniform uint32): wall,
    peak and launches, rows equal to the library's row sort; then on
    Uniform, Zero and Staggered uint32 and int64 Uniform, every query kind
    bit for bit against one ``torch.sort`` of the keys (select_rank with
    the window on and off, percentile, top_k for k = 1 … 64 and 4096,
    rank_of_key, range_query); the median wall of 5 per batch after a
    warm-up, its host syncs and peak, beside phase 4's RAMS wall; the
    reference CLI's stream of 512 queries through ``SortService`` under
    ``selection``, ``fullsort`` and ``auto``, every answer against the
    oracle; and the card against the CPU at p = 64, n = 2^20 (every kind
    on uint32, int64, uint64 and float64 keys, the service under
    ``selection`` and ``fullsort``, ``trace_query`` for every kind and
    key width).  Returns the ingest's launches."""
    from repro_torch.core import queries as Q
    from repro_torch import SortConfig
    from repro_torch.launch.sort_serve import (SortService, _gen_stream,
                                               parse_mix)
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    p, n = P_SERVE, 1 << LOG_N_SERVE

    # --- the ingest
    x = generate_instance("Uniform", p, n).astype(np.uint32)
    Q.shard_data(x, p)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    data = Q.shard_data(x, p)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rows = key_words(torch, x, dev).reshape(p, -1)
    same = (torch.equal(data.keys, torch.sort(rows, dim=1)[0])
            and bool((data.counts == n // p).all()))
    row_sort_ms = cuda_ms(torch, lambda: torch.sort(rows, dim=1))
    del rows
    emit({"phase": "serve_ingest", "p": p, "n": n, "instance": "Uniform",
          "wall_s": wall, "max_memory_allocated": peak,
          "resident_bytes": data.keys.numel() * data.keys.element_size(),
          "launches": launches, "rows_equal_library_sort": same,
          "library_row_sort_ms": row_sort_ms})
    if not same:
        raise AssertionError("shard_data's rows differ from torch.sort")
    missing = [k for k in ("tile_sort", "run_merge") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the ingest: "
                             f"{missing}")

    # --- every kind against the oracle, and the batches timed
    rng = np.random.default_rng((16, 1))      # apart from the PEs' seeds
    datasets = [(name, "uint32") for name in SERVE_INSTANCES] + [
        ("Uniform", "int64")]
    for name, dtype in datasets:
        if dtype == "int64":
            x = keys64(np, generate_instance, name, p, n, np.int64)
        elif name != "Uniform":
            x = generate_instance(name, p, n).astype(np.uint32)
        if name != "Uniform" or dtype == "int64":
            data = Q.shard_data(x, p)
        oracle = torch.sort(key_words(torch, x, dev))[0]
        args = serve_args(torch, np, rng, x, oracle, SERVE_B)
        want = serve_expected(torch, np, oracle, x.dtype, args)
        bad = {}
        for window in ((True, False) if dtype == "uint32" else (True,)):
            got = serve_answers(np, Q, data, args, window)
            bad[f"window={window}"] = same_answers(np, got, want)
        big = Q.top_k(data, SERVE_TOPK_BIG)
        big_ok = same_bits(np, big, Q._np_keys(
            oracle[n - SERVE_TOPK_BIG:].cpu().numpy(), x.dtype))
        emit({"phase": "serve_oracle", "instance": name, "dtype": dtype,
              "p": p, "n": n, "batch": SERVE_B, "differs": bad,
              "top_k_4096_identical": big_ok})
        if any(bad.values()) or not big_ok:
            raise AssertionError(f"{name} {dtype}: answers differ from the "
                                 f"oracle: {bad}, top_k 4096 {big_ok}")
        if name == "Uniform":
            batches = {
                "select_rank": lambda: Q.select_rank(data, args["ranks"]),
                "percentile": lambda: Q.percentile(data, args["q"]),
                "top_k": lambda: Q.top_k(data, args["k"]),
                "top_k_4096": lambda: Q.top_k(data, SERVE_TOPK_BIG),
                "rank_of_key": lambda: Q.rank_of_key(data, args["keys"]),
                "range_query": lambda: Q.range_query(data, args["lo"],
                                                     args["hi"])}
            if dtype == "uint32":
                batches["select_rank_no_window"] = lambda: Q.select_rank(
                    data, args["ranks"], window=False)
            emit({"phase": "serve_breakdown", "kind": "select_rank",
                  "dtype": dtype, "p": p, "n": n, "batch": SERVE_B,
                  **device_breakdown(torch, batches["select_rank"])})
            for kind, fn in batches.items():
                med, bpeak, syncs = time_batch(torch, fn)
                emit({"phase": "serve_batch", "kind": kind, "dtype": dtype,
                      "p": p, "n": n,
                      "batch": 1 if kind == "top_k_4096" else SERVE_B,
                      "rounds": Q.n_rounds(data.bits) if kind not in (
                          "rank_of_key", "range_query") else 0,
                      "wall_s": med, "max_memory_allocated": bpeak,
                      "host_syncs": syncs, "rams_psort_wall_s": rams_wall})
        del data, oracle, x
        torch.cuda.empty_cache()
    emit({"phase": "serve_oracle_done", "seconds": time.perf_counter() - t0})

    # --- SortService at the cell: the CLI's stream, three policies
    keys = np.random.default_rng(0).integers(0, 1 << 32, size=n).astype(
        np.uint32)
    oracle = torch.sort(key_words(torch, keys, dev))[0]
    for policy in ("selection", "fullsort", "auto"):
        svc, done, wall = service_run(torch, np, SortService, SortConfig,
                                      parse_mix, _gen_stream, keys, p,
                                      policy, SERVE_QUERIES, None)
        bad = check_service(torch, np, done, oracle, keys.dtype)
        routes = sorted({(r.request.kind, r.path) for r in done})
        emit({"phase": "serve_service", "policy": policy, "p": p, "n": n,
              "queries": len(done), "mix": SERVE_MIX, "sort": SERVE_SORT,
              "drain_wall_s": wall, "steps": len({(r.request.kind,
                                                   r.step_s) for r in done}),
              "routes": [list(r) for r in routes], "stats": svc.stats(),
              "wrong_answers": bad})
        if bad or len(done) != SERVE_QUERIES:
            raise AssertionError(f"SortService ({policy}): {bad} answers "
                                 f"differ from the oracle")
        del svc, done
        torch.cuda.empty_cache()
    del oracle, keys
    emit({"phase": "serve_service_done",
          "seconds": time.perf_counter() - t0})

    # --- the card against the CPU at p = 64, n = 2^20
    p, n = P_SERVE_CHECK, 1 << LOG_N_SERVE_CHECK
    rng = np.random.default_rng((16, 2))
    u = generate_instance("Uniform", p, n)
    for dtype in (np.uint32, np.int64, np.uint64, np.float64):
        x = u.astype(np.uint32) if dtype == np.uint32 else keys64(
            np, generate_instance, "Uniform", p, n, dtype)
        if dtype == np.float64:                     # both zeros
            x[:4] = [0.0, -0.0, -0.0, 0.0]
        dg, dc = Q.shard_data(x, p), Q.shard_data(x, p, device="cpu")
        oracle = torch.sort(key_words(torch, x, "cpu"))[0]
        args = serve_args(torch, np, rng, x, oracle, SERVE_B_CHECK)
        bad = {"rows": not (torch.equal(dg.keys.cpu(), dc.keys)
                            and torch.equal(dg.counts.cpu(), dc.counts))}
        for window in ((True, False) if dtype == np.uint32 else (True,)):
            bad[f"window={window}"] = same_answers(
                np, serve_answers(np, Q, dg, args, window),
                serve_answers(np, Q, dc, args, window))
        emit({"phase": "serve_cuda_vs_cpu", "dtype": np.dtype(dtype).name,
              "p": p, "n": n, "batch": SERVE_B_CHECK, "differs": bad})
        if any(bad.values()):
            raise AssertionError(f"{np.dtype(dtype).name}: card and CPU "
                                 f"answers differ: {bad}")
        del dg, dc, oracle
    keys = u.astype(np.uint32)
    for policy in ("selection", "fullsort"):
        runs = [service_run(torch, np, SortService, SortConfig, parse_mix,
                            _gen_stream, keys, p, policy,
                            SERVE_QUERIES_CHECK, d)[1]
                for d in ("cuda", "cpu")]
        same = [(r.request.kind, r.path, r.batch) for r in runs[0]] == [
            (r.request.kind, r.path, r.batch) for r in runs[1]] and all(
            same_bits(np, np.asarray(a.value), np.asarray(b.value))
            for a, b in zip(*runs))
        emit({"phase": "serve_service_cuda_vs_cpu", "policy": policy,
              "p": p, "n": n, "queries": SERVE_QUERIES_CHECK,
              "identical": same})
        if not same:
            raise AssertionError(f"SortService ({policy}): card and CPU "
                                 f"differ")
    for dtype in (np.uint32, np.uint64):
        for kind in Q.QUERY_KINDS:
            if kind == "sort" and dtype == np.uint64:
                continue                     # the sort's trace is uint32
            tg, tc = (Q.trace_query(kind, n, p, batch=4, dtype=dtype, k=8,
                                    device=d) for d in ("cuda", "cpu"))
            same = [(e.primitive, e.bytes, e.group_size, e.axis, e.tag)
                    for e in tg.events] == [
                (e.primitive, e.bytes, e.group_size, e.axis, e.tag)
                for e in tc.events]
            emit({"phase": "serve_trace_cuda_vs_cpu", "kind": kind,
                  "dtype": np.dtype(dtype).name, "p": p, "n": n,
                  "identical": same, "summary": tg.summary(p)})
            if not same:
                raise AssertionError(f"trace_query({kind}, "
                                     f"{np.dtype(dtype).name}) differs")
    emit({"phase": "serve_done", "seconds": time.perf_counter() - t0})
    return launches


def fault_events(trace):
    return [(e.primitive, e.bytes, e.group_size, e.axis, e.tag, e.pe)
            for e in trace.events]


def fault_run(torch, psort, SortConfig, x, faults, device, policy_kw=None,
              **cfg):
    """psort under the fault plan ``faults`` on ``device``: (out, info) or
    the error it raised, and the policy (its attempts and trace)."""
    from repro_torch.core import comm
    from repro_torch.runtime import FaultPolicy
    pol = FaultPolicy(plan=comm.FaultPlan(tuple(faults)),
                      **(policy_kw or {}))
    try:
        out = psort(x, SortConfig(fault_policy=pol, **cfg), return_info=True,
                    device=device)
    except comm.PEFailure as e:
        out = e
    return out, pol


def same_fault_run(torch, a, b) -> bool:
    """Two fault runs (card, CPU) equal: output, counts, overflow, perm,
    ``info["fault"]`` (or the same PEFailure), the attempts and every
    trace event."""
    (ra, pa), (rb, pb) = a, b
    if pa.attempts != pb.attempts or \
            fault_events(pa.trace) != fault_events(pb.trace):
        return False
    if isinstance(ra, Exception) or isinstance(rb, Exception):
        return (type(ra) is type(rb) and str(ra) == str(rb))
    (ao, ai), (bo, bi) = ra, rb
    rows = ao if isinstance(ao, list) else [ao]
    rows_b = bo if isinstance(bo, list) else [bo]
    return (len(rows) == len(rows_b)
            and all(same_rows(torch, u, v) for u, v in zip(rows, rows_b))
            and torch.equal(ai["perm"].cpu(), bi["perm"].cpu())
            and torch.equal(ai["counts"].cpu(), bi["counts"].cpu())
            and ai["overflow"] == bi["overflow"]
            and ai["fault"] == bi["fault"])


def fault_phase(torch, np, psort, SortConfig, ExternalPolicy,
                generate_instance, launch_counts, reset_launch_counts):
    """Phase 17: the fault lane (``SortConfig(fault_policy=...)``).

    (a) the card against the CPU, bit for bit, at p = 8: the reference's
    fast-lane cases (a kill and a straggler for seven algorithms, attempts
    8 → 4 → 2; the nested (2, 4) kill; batched RQuick; ``"auto"``; two
    kills; the exhausted budget); (b) the external lane at its check cell
    (p = 16, n = 2^20, budget 2^13): kills tagged ``ext:merge`` and
    ``ext:pass1``, and a rescale from p = 16 to 8 that crosses into the
    lane (budget 3·2^15, between n/16 and n/8), with ``kway_classify``
    launched; (c) a kill in RAMS's ``level1`` at p = 256, n = 2^25: the
    rescaled attempt at p = 128 equals the fault-free sort there bit for
    bit, each attempt's wall, the rescaled attempt's peak against the
    fault-free one's (the policy's logger resets the peak at the rescale
    and reads the allocation there), every RAMS kernel launched; (d) the
    same cell with a straggler (the first attempt completes, then is
    flagged); (e) the RAMS cell itself (p = 256, n = 2^26) with the kill
    of (c): the rescaled attempt's capacity 2^20 is refused as in the
    reference, and the dead attempts' memory is released.  Returns the
    launches of (c)."""
    from repro_torch.core import comm
    t0 = time.perf_counter()

    # (a) card against CPU at p = 8
    x8 = generate_instance("Uniform", 8, 8 * 1024).astype(np.int32)
    r = np.random.default_rng(3)
    cases = [(f"{a}-kill-straggler", x8,
              [comm.kill_pe(2), comm.delay_pe(1, factor=8.0)], None,
              {"p": 8, "algorithm": a}) for a in FAULT_ALGOS]
    cases += [
        ("rams-nested-kill", x8, [comm.kill_pe(5)], None,
         {"mesh_shape": (2, 4), "algorithm": "rams"}),
        ("rquick-batched-kill", r.integers(0, 1 << 20, size=(3, 4 * 1024)
                                           ).astype(np.int32),
         [comm.kill_pe(1)], None, {"p": 4, "algorithm": "rquick"}),
        ("auto-kill", x8, [comm.kill_pe(0)], None,
         {"p": 8, "algorithm": "auto"}),
        ("rfis-two-kills", x8, [comm.kill_pe(6), comm.kill_pe(1, after=2)],
         None, {"p": 8, "algorithm": "rfis"}),
        ("rquick-budget-exhausted", np.arange(4096, dtype=np.int32),
         [comm.kill_pe(0), comm.kill_pe(1)], {"max_restarts": 1},
         {"p": 4, "algorithm": "rquick"}),
    ]
    for label, x, faults, pkw, cfg in cases:
        card = fault_run(torch, psort, SortConfig, x, faults, "cuda", pkw,
                         **cfg)
        cpu = fault_run(torch, psort, SortConfig, x, faults, "cpu", pkw,
                        **cfg)
        same = same_fault_run(torch, card, cpu)
        emit({"phase": "fault_cuda_vs_cpu", "case": label,
              "attempts": card[1].attempts, "identical": same,
              "error": type(card[0]).__name__
              if isinstance(card[0], Exception) else None})
        if not same:
            raise AssertionError(f"fault case {label}: cuda and cpu differ")
        if isinstance(card[0], Exception) != (pkw is not None):
            raise AssertionError(f"fault case {label}: {card[0]!r}")
        del card, cpu

    # (b) the external lane at its check cell
    n = 1 << LOG_N_EXT_CHECK
    x = generate_instance("Uniform", P_EXT, n).astype(np.uint32)
    for label, faults, budget in (
            ("ext-merge-kill", [comm.kill_pe(3, tag="ext:merge")],
             BUDGET_EXT_CHECK),
            ("ext-pass1-kill", [comm.kill_pe(1, tag="ext:pass1")],
             BUDGET_EXT_CHECK),
            ("ext-crossing", [comm.kill_pe(2)], BUDGET_FAULT_CROSS)):
        cfg = {"p": P_EXT, "external": ExternalPolicy(budget=budget)}
        reset_launch_counts()
        card = fault_run(torch, psort, SortConfig, x, faults, "cuda", **cfg)
        launches = launch_counts()
        cpu = fault_run(torch, psort, SortConfig, x, faults, "cpu", **cfg)
        same = same_fault_run(torch, card, cpu)
        algos = [a["algorithm"] for a in card[1].attempts]
        emit({"phase": "fault_external", "case": label, "p": P_EXT, "n": n,
              "budget": budget, "attempts": card[1].attempts,
              "identical": same, "launches": launches})
        if not same:
            raise AssertionError(f"fault case {label}: cuda and cpu differ")
        if isinstance(card[0], Exception) or algos[-1] != "external" or \
                launches["kway_classify"] <= 0:
            raise AssertionError(f"fault case {label}: {algos}, {launches}")
        if label == "ext-crossing" and algos[0] == "external":
            raise AssertionError(f"no crossing into the lane: {algos}")
        check_external(torch, np, x, card[0][0], card[0][1], n)
        del card, cpu
    emit({"phase": "fault_checks_done", "seconds": time.perf_counter() - t0})

    # (c) and (d): RAMS at p = 256, n = 2^25, killed or straggling
    n = 1 << LOG_N_FAULT
    x = generate_instance("Uniform", P_MAIN, n).astype(np.uint32)
    ref_cfg = SortConfig(p=P_MAIN // 2, algorithm="rams")
    psort(x, ref_cfg)                                # warm-up at p = 128
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    ref = timed_psort(torch, psort, x, ref_cfg, reset_launch_counts,
                      launch_counts)
    check_sorted(torch, np, x, ref[0], ref[1], n)
    fault_launches = None
    for label, fault in (("kill", comm.kill_pe(17, tag="level1")),
                         ("straggler", comm.delay_pe(5, factor=8.0))):
        run = timed_fault(torch, psort, SortConfig, x, fault, P_MAIN,
                          reset_launch_counts, launch_counts)
        out, info = run["result"]
        same = same_result(torch, (out, info), ref[:2])
        check_sorted(torch, np, x, out, info, n)
        attempts = [(a["p"], a["ok"]) for a in run["attempts"]]
        missing = [k for k in RAMS_LAUNCHES if run["launches"][k] <= 0]
        # each peak over what was allocated before its call (the fault
        # runs hold the p = 128 result beside them)
        peak_ratio = (run["rescaled_peak"] - run["before"]) / (ref[4] - base)
        emit({"phase": "fault_rams", "case": label, "p": P_MAIN, "n": n,
              "fault": [fault.kind, fault.pe, fault.tag, fault.factor],
              "attempts": attempts, "identical_to_p128": same,
              "attempt_walls_s": run["walls"], "total_wall_s": run["wall"],
              "p128_wall_s": ref[2],
              "total_over_p128": run["wall"] / ref[2],
              "rescaled_peak": run["rescaled_peak"], "p128_peak": ref[4],
              "p128_allocated_before": base,
              "rescaled_peak_over_p128": peak_ratio,
              "allocated_at_rescale": run["at_rescale"],
              "allocated_before": run["before"],
              "overflow": info["overflow"], "launches": run["launches"]})
        if attempts != [(P_MAIN, False), (P_MAIN // 2, True)] or not same:
            raise AssertionError(f"fault {label}: attempts {attempts}, "
                                 f"identical {same}")
        if peak_ratio > 1.05:
            raise AssertionError(f"fault {label}: the rescaled attempt's "
                                 f"peak is {peak_ratio:.3f}x the p = 128 "
                                 f"sort's")
        if missing:
            raise AssertionError(f"kernels never launched on the fault "
                                 f"path: {missing}")
        if fault_launches is None:
            fault_launches = run["launches"]
        del run, out, info
    del ref, x
    torch.cuda.empty_cache()
    emit({"phase": "fault_rams_done", "seconds": time.perf_counter() - t0})

    # (e) the RAMS cell: the rescale to p = 128 passes RAMS's capacity
    n = 1 << LOG_N_MAIN
    x = generate_instance("Uniform", P_MAIN, n).astype(np.uint32)
    err, seen = None, {}
    try:
        timed_fault(torch, psort, SortConfig, x,
                    comm.kill_pe(17, tag="level1"), P_MAIN,
                    reset_launch_counts, launch_counts, record=seen)
    except ValueError as e:
        err = str(e)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    attempts = [(a["p"], a["ok"]) for a in seen["policy"].attempts]
    words = 4 * n
    emit({"phase": "fault_rams_cell", "p": P_MAIN, "n": n, "error": err,
          "attempts": attempts, "allocated_before": seen["before"],
          "allocated_at_rescale": seen["at_rescale"],
          "allocated_after": after, "input_device_bytes": words,
          "peak_after_rescale": torch.cuda.max_memory_allocated()})
    if err is None or "capacity < 2^20" not in err:
        raise AssertionError(f"the RAMS cell's rescale did not fail as the "
                             f"reference's: {err!r}")
    if attempts != [(P_MAIN, False), (P_MAIN // 2, False)]:
        raise AssertionError(f"the RAMS cell's attempts: {attempts}")
    if after > seen["before"] + FAULT_SLACK or \
            seen["at_rescale"][0] > seen["before"] + words + FAULT_SLACK:
        raise AssertionError("the dead attempts' memory was not released")
    del x
    torch.cuda.empty_cache()
    emit({"phase": "fault_done", "seconds": time.perf_counter() - t0})
    return fault_launches


def timed_fault(torch, psort, SortConfig, x, fault, p, reset_launch_counts,
                launch_counts, record=None):
    """RAMS at p under one fault, timed: its result, each attempt's wall
    (the rescale ends the first), the total, the allocation before the
    call and at each rescale, the rescaled attempt's peak (the logger
    resets it) and the launches.  ``record`` gets the policy and the
    allocations as they are taken, for a run that raises."""
    from repro_torch.core import comm
    from repro_torch.runtime import FaultPolicy
    rec = {} if record is None else record
    marks, at_rescale = [], []

    def logger(msg):
        if msg.startswith("[psort]"):           # psort's rescale
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            at_rescale.append(torch.cuda.memory_allocated())
            torch.cuda.reset_peak_memory_stats()

    pol = FaultPolicy(plan=comm.FaultPlan((fault,)), logger=logger)
    rec.update(policy=pol, at_rescale=at_rescale)
    torch.cuda.empty_cache()
    reset_launch_counts()
    torch.cuda.synchronize()
    rec["before"] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    result = psort(x, SortConfig(p=p, algorithm="rams", fault_policy=pol),
                   return_info=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    edges = [t0] + marks + [t1]
    return {"result": result, "attempts": pol.attempts,
            "walls": [b - a for a, b in zip(edges, edges[1:])],
            "wall": t1 - t0, "before": rec["before"],
            "at_rescale": at_rescale,
            "rescaled_peak": torch.cuda.max_memory_allocated(),
            "launches": launch_counts()}


# ---------------------------------------------------------------------------
# Phase 18: the distributed backend (backend="shard_map") on the card
# ---------------------------------------------------------------------------


def dist_keys(np, generate_instance, cache, name, p, log_n, rows=1):
    """The instance ``name`` of 2^log_n keys at p as uint32, made once per
    process (each rank makes its own: the keys never cross processes);
    ``rows`` > 1 stacks that many rows, row r seeded r."""
    key = (name, p, log_n, rows)
    if key not in cache:
        xs = [generate_instance(name, p, 1 << log_n, seed=r).astype(
            np.uint32) for r in range(rows)]
        cache[key] = xs[0] if rows == 1 else np.stack(xs)
    return cache[key]


def digest(torch, out, info) -> str:
    """sha256 of a psort result's bits: keys, perm, counts, overflow (a
    list of rows or a tensor, on any device)."""
    import hashlib
    h = hashlib.sha256()
    for part in (out, info["perm"], info["counts"]):
        for t in (part if isinstance(part, list) else [part]):
            t = t.contiguous()
            signed = {4: torch.int32, 8: torch.int64}[t.element_size()]
            h.update(str(tuple(t.shape)).encode())
            h.update(t.view(signed).cpu().numpy().tobytes())
    h.update(str(info["overflow"]).encode())
    return h.hexdigest()


def trace_events(trace) -> list:
    return [list(e.__dict__.values()) for e in trace.events]


def dist_cases(np):
    """Phase 18's sorts on the eight gloo ranks: (label, algorithm, cfg
    keywords, instance, p, log2 n, rows, mesh keywords or None), each held
    against the sim backend at the same p on the card."""
    cases = []
    for algorithm in ALGORITHMS:
        log_n = DIST_LOG_N_CUT.get(algorithm, DIST_LOG_N)
        for name in DIST_INSTANCES:
            cases.append((f"dist-{algorithm}", algorithm, {}, name,
                          DIST_RANKS, log_n, 1, None))
    d, p, log_n = DIST_BATCH
    cases.append(("dist-batched", DIST_BATCH_ALGO, {}, "Uniform", p, log_n,
                  d, {"p": p, "d": d}))
    cases.append(("dist-nested", "rams", {"mesh_shape": DIST_NESTED[0]},
                  "Uniform", DIST_RANKS, DIST_NESTED[1], 1, None))
    for algorithm in ("rams", "ssort"):
        cases.append((f"dist-{algorithm}-overlap", algorithm,
                      {"overlap": True}, "Uniform", DIST_RANKS,
                      DIST_LOG_N_CUT.get(algorithm, DIST_LOG_N), 1, None))
    p, excluded, log_n = DIST_EXCLUDE
    cases.append(("dist-exclude", "rquick", {}, "Uniform", p, log_n, 1,
                  {"p": p, "exclude": excluded}))
    return cases


def nccl_cases():
    """(c): every algorithm at p = 1 on one NCCL rank; RAMS and NTB-AMS at
    the largest n their capacity (< 2^20 a PE) takes at p = 1."""
    return [(f"nccl-{a}", a, {}, "Uniform", 1,
             DIST_NCCL_LOG_N_AMS if a in ("rams", "ntb-ams")
             else DIST_NCCL_LOG_N, 1, None) for a in ALGORITHMS]


def dist_rank(rank, world, port, backend, jobs, results):
    """One rank of phase 18 (spawned; every rank on the card 0): joins the
    group, then runs each job it is sent and answers with its launches,
    wall, peak and, on rank 0, the result's digest and trace."""
    import datetime
    import traceback
    try:
        import numpy as np
        import torch
        import torch.distributed as dist
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        from repro_torch import SortConfig, psort
        from repro_torch.core import comm, queries
        from repro_torch.data import generate_instance
        from repro_torch.dist import sort_mesh
        from repro_torch.kernels import launch_counts, reset_launch_counts
        torch.cuda.set_device(0)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S),
            **({"device_id": torch.device("cuda", 0)}
               if backend == "nccl" else {}))
        results.put((rank, "ready", None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        return
    cache = {}
    while True:
        job = jobs.get()
        if job is None:
            break
        try:
            kind, case = job
            label, algorithm, kw, name, p, log_n, rows, mesh_kw = case
            x = dist_keys(np, generate_instance, cache, name, p, log_n, rows)
            mesh = sort_mesh(**mesh_kw) if mesh_kw is not None else None
            dist.barrier()                  # every rank, the excluded too
            if mesh is not None and rank not in mesh.mesh.reshape(
                    -1).tolist():
                results.put((rank, "ok", None))      # joined the mesh only
                continue
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with comm.counting() as trace:
                if kind == "serve":
                    data = queries.shard_data(x, p, device="cuda")
                    ranks = np.linspace(1, x.size, DIST_SERVE_B).astype(
                        np.int64)
                    t0 = time.perf_counter()
                    got = queries.select_rank(data, ranks,
                                              backend="shard_map")
                    wall = time.perf_counter() - t0      # answers on host
                    out = {"answers": [np.asarray(a).tolist() for a in got]}
                else:
                    o, info = psort(x, SortConfig(
                        p=None if "mesh_shape" in kw else p,
                        algorithm=algorithm, backend="shard_map", mesh=mesh,
                        **kw), return_info=True, device="cuda")
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    out = {"digest": digest(torch, o, info) if rank == 0
                           else None,
                           "overflow": info["overflow"],
                           "counts": info["counts"].tolist(),
                           "algorithm": info["algorithm"]}
                    del o, info
            out.update(wall_s=wall, launches=launch_counts(),
                       peak=torch.cuda.max_memory_allocated(),
                       events=trace_events(trace) if rank == 0 else None)
            results.put((rank, "ok", out))
        except BaseException:
            results.put((rank, "error", traceback.format_exc()))
    torch.cuda.empty_cache()
    dist.destroy_process_group()


class DistRanks:
    """``world`` spawned ranks on the card in one group of ``backend``;
    :meth:`run` sends a job to every rank and returns their answers, and
    any error, silence past the deadline or early exit is fatal.  With
    ``wait=False`` the ranks start in the background and :meth:`ready`
    waits for them."""

    def __init__(self, world, backend, target=None, wait=True):
        import multiprocessing
        import socket
        ctx = multiprocessing.get_context("spawn")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self.world = world
        self.t0 = time.perf_counter()
        self.results = ctx.Queue()
        self.jobs = [ctx.Queue() for _ in range(world)]
        self.procs = [ctx.Process(target=target or dist_rank, args=(
            r, world, port, backend, self.jobs[r], self.results))
            for r in range(world)]
        for proc in self.procs:
            proc.start()
        self.up = False
        if wait:
            self.ready()

    def ready(self):
        """Wait until every rank has joined its group (once)."""
        if not self.up:
            self.t0 = time.perf_counter()
            self.collect("start")
            self.up = True
        return self

    def collect(self, what):
        import queue
        out, errors = {}, []
        while len(out) < self.world:
            try:
                rank, status, value = self.results.get(timeout=10)
            except queue.Empty:
                if time.perf_counter() - self.t0 > DIST_TIMEOUT_S or any(
                        not p.is_alive() for p in self.procs):
                    self.close()
                    raise AssertionError(
                        f"phase 18/19 {what}: ranks "
                        f"{sorted(set(range(self.world)) - set(out))} gave "
                        f"no answer" + "".join(
                            f"\n{e}" for e in errors)) from None
                continue
            if status == "error":
                errors.append(f"rank {rank}: {value}")
            out[rank] = value
        if errors:
            self.close()
            raise AssertionError(f"phase 18/19 {what}:\n"
                                 + "\n".join(errors))
        return [out[r] for r in range(self.world)]

    def run(self, job):
        self.ready()
        for q in self.jobs:
            q.put(job)
        self.t0 = time.perf_counter()
        return self.collect(job[1][0])

    def serve(self, name):
        """Turn ranks of ``pooled_rank`` to the phase whose rank function
        ``POOLED`` names ``name``, and wait until they are ready."""
        self.ready()
        for q in self.jobs:
            q.put(name)
        self.serving = name
        self.t0 = time.perf_counter()
        self.collect(f"{name} ranks up")

    def release(self):
        """End the phase's rank function; the processes stay."""
        if getattr(self, "serving", None) is not None:
            for q in self.jobs:
                q.put(None)
            self.serving = None

    def close(self):
        self.release()
        for q in self.jobs:
            q.put(None)
        for proc in self.procs:
            proc.join(60)
            if proc.is_alive():
                proc.kill()
                proc.join(10)


def pooled_rank(rank, world, port, backend, jobs, results):
    """One of the four gloo ranks that phases 19d, 20d, 21 and 22 share,
    spawned once (a start costs 10-15 s): it joins the group on the card
    and says it is up, then for each phase runs the rank function
    ``POOLED`` names until the phase's None, and frees what the phase
    left."""
    import datetime
    import gc
    import traceback
    try:
        import torch
        import torch.distributed as dist
        if torch.cuda.is_available():
            torch.cuda.set_device(0)
            torch.cuda.synchronize()          # the context, made now
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        results.put((rank, "ready", None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        return
    while True:
        name = jobs.get()
        if name is None:
            break
        POOLED[name](rank, world, jobs, results)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    dist.destroy_process_group()


POOL = []
EARLY = {}       # phase 18's eight ranks, started before the build


def start_pool(wait=True):
    """Start the pooled gloo ranks (MESH_RANKS of them) if they are not."""
    if not POOL:
        POOL.append(DistRanks(MESH_RANKS, "gloo", target=pooled_rank,
                              wait=wait))
    return POOL[0]


def four_ranks(name):
    """The pooled ranks, started on first use, turned to phase ``name``;
    the phase ends with ``release()`` and ``close_pool`` stops them."""
    ranks = start_pool()
    ranks.serve(name)
    return ranks


def close_pool():
    while POOL:
        POOL.pop().close()
    while EARLY:
        EARLY.popitem()[1].close()


def sim_reference(torch, np, psort, SortConfig, generate_instance, case,
                  cache):
    """The digest and trace of one phase-18 case on the sim backend on the
    card, at the same p (its keys kept in ``cache``)."""
    from repro_torch.core import comm
    label, algorithm, kw, name, p, log_n, rows, mesh_kw = case
    x = dist_keys(np, generate_instance, cache, name, p, log_n, rows)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with comm.counting() as trace:
        out, info = psort(x, SortConfig(
            p=None if "mesh_shape" in kw else p, algorithm=algorithm, **kw),
            return_info=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ref = {"digest": digest(torch, out, info), "overflow": info["overflow"],
           "counts": info["counts"].tolist(), "wall_s": wall,
           "peak": torch.cuda.max_memory_allocated(),
           "events": trace_events(trace)}
    del out, info
    torch.cuda.empty_cache()
    return ref


def check_dist(label, answers, ref, case):
    """A case's ranks against its sim run: rank 0's digest and trace, and
    every sorting rank's counts and overflow."""
    sorting = [a for a in answers if a is not None]
    if len(sorting) != case[4] * case[6]:
        raise AssertionError(f"{label}: {len(sorting)} ranks sorted, not "
                             f"{case[4] * case[6]}")
    a0 = answers[0]
    same = {"digest": a0["digest"] == ref["digest"],
            "trace": a0["events"] == ref["events"],
            "counts": all(a["counts"] == ref["counts"]
                          and a["overflow"] == ref["overflow"]
                          for a in sorting)}
    if not all(same.values()):
        raise AssertionError(f"{label}: the distributed run differs from "
                             f"the sim run on the card: {same}")
    return same


def dist_phase(torch, np, psort, SortConfig, generate_instance):
    """Phase 18: the distributed backend on the card.  (a) the ten
    algorithms on eight gloo ranks sharing the card (p = 8) on Uniform and
    Zero, (b) batched keys, a nested (2, 4) mesh, ``overlap=True``, the
    resident query path and a mesh with excluded ranks on the same ranks,
    (c) every algorithm on one NCCL rank (p = 1); each equal bit for bit to
    the sim backend on the card at the same p (keys, perm, counts,
    overflow; rank 0's trace event for event).  Times are of eight
    processes on one card through gloo over the host: not a multi-GPU
    figure.  Returns the launches of every path, summed over its ranks."""
    from repro_torch.core import queries
    emit({"phase": "dist_transport", "gloo_ranks": DIST_RANKS,
          "nccl_ranks": 1, "torch": torch.__version__,
          "note": "eight processes share one card; gloo moves CUDA tensors "
                  "through the host: times are not multi-GPU figures"})
    t18 = time.perf_counter()
    cases, cache = dist_cases(np), {}
    refs = {c[0] + c[3]: sim_reference(torch, np, psort, SortConfig,
                                       generate_instance, c, cache)
            for c in cases}
    x = dist_keys(np, generate_instance, cache, "Uniform", DIST_RANKS,
                  DIST_SERVE_LOG_N)
    data = queries.shard_data(x, DIST_RANKS, device="cuda")
    ranks = np.linspace(1, x.size, DIST_SERVE_B).astype(np.int64)
    serve_ref = [np.asarray(a).tolist() for a in queries.select_rank(
        data, ranks)]
    del data, x
    cache.clear()
    torch.cuda.empty_cache()
    emit({"phase": "dist_sim_refs", "seconds": time.perf_counter() - t18})
    launches = {}

    def record(label, answers, ref, case):
        sorting = [a for a in answers if a is not None]
        same = check_dist(label, answers, ref, case) if ref else {}
        per_rank = [a["launches"] if a else None for a in answers]
        total = {}
        for a in sorting:
            for k, v in a["launches"].items():
                total[k] = total.get(k, 0) + v
        launches.setdefault(label, total)        # the first instance's
        need = ("tile_sort",) if case[4] == 1 else DIST_REQUIRED.get(
            case[1], ("tile_sort",))
        missing = [k for k in need if total.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched on the "
                                 f"ranks: {missing}")
        emit({"phase": "dist", "case": label, "instance": case[3],
              "algorithm": case[1], "p": case[4], "log2_n": case[5],
              "rows": case[6], "kw": case[2], "mesh": case[7],
              "identical": same, "overflow": sorting[0].get("overflow"),
              "wall_s_gloo_over_host": answers[0]["wall_s"],
              "sim_wall_s": ref["wall_s"] if ref else None,
              "peak_per_rank": [a["peak"] if a else None for a in answers],
              "sim_peak": ref["peak"] if ref else None,
              "launches_per_rank": per_rank})

    ranks8 = EARLY.pop("dist", None) or DistRanks(DIST_RANKS, "gloo")
    try:
        for case in cases:
            record(case[0], ranks8.run(("sort", case)),
                   refs[case[0] + case[3]], case)
        case = ("dist-serve", None, {}, "Uniform", DIST_RANKS,
                DIST_SERVE_LOG_N, 1, None)
        answers = ranks8.run(("serve", case))
        if any(a["answers"] != serve_ref for a in answers):
            raise AssertionError("dist-serve: select_rank on the ranks "
                                 "differs from the sim backend")
        record("dist-serve", answers, None, case)
    finally:
        ranks8.close()
    emit({"phase": "dist_gloo_done", "seconds": time.perf_counter() - t18})
    ranks1 = DistRanks(1, "nccl")
    try:
        for case in nccl_cases():
            ref = sim_reference(torch, np, psort, SortConfig,
                                generate_instance, case, cache)
            record(case[0], ranks1.run(("sort", case)), ref, case)
    finally:
        ranks1.close()
    emit({"phase": "dist_done", "seconds": time.perf_counter() - t18})
    return launches


def dist_kernel_rows(torch):
    """The kernels of phase 18's paths at one rank's shapes: RAMS's at a
    rank of the 2^21-key sorts (p = 8, 2^18 keys a rank), ``tile_sort`` and
    a ``run_merge`` pass at a rank of the 2^23-key sorts ((1, 2^21) with
    2^20 valid keys) and of the NCCL rank's ((1, 2^25) with 2^24), and the
    classify of SSort (nb = 8) and RQuick (nb = 2) at a rank's (1, 2^22)
    with 2^20 valid.  Returns (RAMS rows by launch key, [(row, paths)])."""
    dev = torch.device("cuda")
    ams, ams_sort = rams_kernel_rows(torch, 1, DIST_RANKS,
                                     1 << (DIST_LOG_N_CUT["rams"] - 3),
                                     "dist-rams", seed=18)
    g = torch.Generator(device=dev)
    g.manual_seed(18)
    per = 1 << (DIST_LOG_N - 3)
    out = ams_sort + sort_kernel_rows(
        torch, g, 1, 2 * per, torch.tensor([per], device=dev),
        ("dist-8",), merge=True)
    out += sort_kernel_rows(
        torch, g, 1, 2 << DIST_NCCL_LOG_N,
        torch.tensor([1 << DIST_NCCL_LOG_N], device=dev), ("nccl",),
        merge=True)
    C, count = 4 * per, torch.tensor([per], device=dev)
    keys = torch.sort(torch.randint(-2 ** 31, 2 ** 31 - 1, (1, C),
                                    generator=g, device=dev,
                                    dtype=torch.int32), dim=1)[0]
    keys = torch.where(torch.arange(C, device=dev)[None, :] < per, keys,
                       2 ** 31 - 1)
    ties = torch.zeros_like(keys)
    for nb, want, path in ((8, "bucket", "dist-ssort"),
                           (2, "hist", "dist-rquick")):
        s_keys = torch.sort(keys[:, torch.randint(0, per, (nb - 1,),
                                                  generator=g, device=dev)],
                            dim=1)[0].contiguous()
        rows = partition_rows(torch, keys, ties, s_keys,
                              torch.zeros_like(s_keys), count, nb,
                              wants=(want,), path=path)
        out += [(row, (path,)) for row in rows.values()]
    del keys, ties
    torch.cuda.empty_cache()
    return ams, out


def dist_summary_rows(launches, ams, sort_rows):
    """The ``kernels`` line's rows of phase 18: each kernel row at a rank's
    shape with the launches of every path of that shape, summed over the
    path's ranks."""
    ams_paths = [k for k in launches if k.startswith(
        ("dist-rams", "dist-ntb-ams", "dist-nested"))]
    wide = [k for k in launches if k.startswith("dist-")
            and k not in ams_paths and k != "dist-serve"]
    by_shape = {"dist-rams": ams_paths, "dist-8": wide,
                "nccl": [k for k in launches if k.startswith("nccl-")],
                "dist-ssort": [k for k in wide if "ssort" in k],
                "dist-rquick": [k for k in wide if "quick" in k
                                or k in ("dist-batched", "dist-exclude")]}
    out = []
    for key, row in ams.items():
        out += [(row, path, launches[path].get(key, 0)) for path in ams_paths]
    for row, (shape,) in sort_rows:
        out += [(row, path, launches[path].get(launch_key(row), 0))
                for path in by_shape[shape]]
    return out


def check_external(torch, np, x_np, out, info, n):
    """Phase-6 assertions on one external psort result (all on the card):
    the lane ran, nothing overflowed, the output is the sorted input and
    ``perm`` a permutation with ``input[perm] == output``."""
    if info["algorithm"] != "external" or info["overflow"] != 0:
        raise AssertionError(f"algorithm {info['algorithm']}, overflow "
                             f"{info['overflow']}")
    flip = -(1 << 31)
    words = torch.from_numpy(x_np.view(np.int32)).to(out.device) ^ flip
    o = out.view(torch.int32) ^ flip
    if not torch.equal(torch.sort(words)[0], o):
        raise AssertionError("output differs from torch.sort(input)")
    perm = info["perm"]
    seen = torch.zeros(n, dtype=torch.bool, device=out.device)
    seen[perm] = True
    if perm.numel() != n or not bool(seen.all()):
        raise AssertionError("perm is not a permutation of the input")
    if not torch.equal(words[perm], o):
        raise AssertionError("input[perm] != output")


# ---------------------------------------------------------------------------
# Phase 19: the model-serving stack
# ---------------------------------------------------------------------------


def model_bytes(cfg, L: int, cache_slots: int, batch: int) -> int:
    """The reckoned device bytes of ``cfg`` cut to L layers: its weights
    (``param_count``, norms and routers counted in the model's dtype) and
    the decode state of ``batch`` sequences over ``cache_slots`` slots
    (bf16 KV caches, float32 recurrent states)."""
    import dataclasses
    c = dataclasses.replace(cfg, n_layers=L)
    weights = c.param_count() * 2
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        slots = min(cache_slots, cfg.sliding_window or cache_slots)
        cache = L * 2 * batch * slots * cfg.n_kv_heads * cfg.head_dim * 2
    elif cfg.family == "ssm":
        hd = cfg.d_model // cfg.n_heads
        cache = L * batch * (cfg.n_heads * hd * hd + cfg.d_model) * 4
    else:
        di = 2 * cfg.d_model
        cache = L * batch * (di * cfg.ssm_state + 3 * (di + 2 * cfg.ssm_state)
                             ) * 4 + (L // cfg.attn_every) * 2 * batch \
            * cache_slots * cfg.n_kv_heads * cfg.head_dim * 2
    return weights + cache


def model_depth(cfg, cache_slots: int, batch: int) -> int:
    """The most layers (at most the config's; zamba2 in whole groups of
    ``attn_every``) whose reckoned bytes stay under MODEL_BYTES_LIMIT."""
    step = cfg.attn_every if cfg.family == "hybrid" else 1
    L = cfg.n_layers
    while L > step and model_bytes(cfg, L, cache_slots, batch) \
            > MODEL_BYTES_LIMIT:
        L -= step
    return L


def decode_inputs(torch, np, cfg, batch, seed, device):
    r = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"embeds": torch.from_numpy(r.normal(
            size=(batch, 1, cfg.d_model))).to(device, torch.bfloat16)}
    return {"tokens": torch.from_numpy(r.integers(
        0, cfg.vocab, size=(batch, 1))).to(device)}


def serve_card_vs_cpu(torch, np, cfg):
    """Phase 19a's check: the served architecture at full width, depth
    MODEL_CHECK_DEPTH, in float32 with float32 caches, on the CPU and on
    the card from the same weights; over MODEL_CHECK_STEPS greedy steps
    the tokens equal and the logits within MODEL_F32_TOL."""
    import copy
    import dataclasses
    from repro_torch.models import transformer as T
    c = dataclasses.replace(cfg, n_layers=MODEL_CHECK_DEPTH, dtype="float32")
    cpu = T.init_params(c, torch.Generator().manual_seed(19), device="cpu")
    gpu = copy.deepcopy(cpu).to(MODEL_DEV)
    st_c = T.init_decode_state(c, MODEL_BATCH, MODEL_CACHE, torch.float32,
                               device="cpu")
    st_g = T.init_decode_state(c, MODEL_BATCH, MODEL_CACHE, torch.float32,
                               device=MODEL_DEV)
    inp = decode_inputs(torch, np, c, MODEL_BATCH, 19, "cpu")
    err, same = 0.0, True
    with torch.inference_mode():
        for _ in range(MODEL_CHECK_STEPS):
            lc, st_c = T.decode_step(cpu, st_c, inp, c)
            lg, st_g = T.decode_step(gpu, st_g, {k: v.to(MODEL_DEV) for k, v
                                                 in inp.items()}, c)
            lg = lg.cpu()
            err = max(err, float((lg - lc).abs().max()))
            if not torch.allclose(lg, lc, **MODEL_F32_TOL):
                raise AssertionError(f"19a: card logits differ from the "
                                     f"CPU's by {err}")
            tc, tg = lc[:, -1].argmax(-1), lg[:, -1].argmax(-1)
            same &= bool(torch.equal(tc, tg))
            if not same:
                raise AssertionError("19a: card tokens differ from the CPU's")
            inp = {"tokens": tc[:, None]}
    del cpu, gpu, st_c, st_g
    torch.cuda.empty_cache()
    return {"depth": MODEL_CHECK_DEPTH, "steps": MODEL_CHECK_STEPS,
            "batch": MODEL_BATCH, "tokens_equal": same,
            "max_abs_logit_err": err, "tol": MODEL_F32_TOL}


def model_serve_phase(torch, np, card):
    """19a: ``serve`` of granite-moe-1b-a400m at full size through the
    port's entry point (bf16 weights and caches, ``moe_local`` on every
    decode step), then its card-vs-CPU check."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    cfg = get_config(MODEL_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks, stats = serve(cfg, None, batch=MODEL_BATCH, tokens=MODEL_TOKENS,
                        cache_len=MODEL_CACHE, logger=lambda s: None,
                        device=MODEL_DEV)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if toks.shape != (MODEL_TOKENS * MODEL_BATCH,) or toks.min() < 0 \
            or toks.max() >= cfg.vocab or stats["p50_ms"] is None:
        raise AssertionError(f"19a: tokens {toks.shape} in "
                             f"[{toks.min()}, {toks.max()}], stats {stats}")
    row = {"phase": "model_serve", "arch": MODEL_ARCH, "card": card,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "experts": cfg.n_experts, "top_k": cfg.top_k, "vocab": cfg.vocab,
           "dtype": cfg.dtype, "batch": MODEL_BATCH, "tokens": MODEL_TOKENS,
           "cache_len": MODEL_CACHE, "params": cfg.param_count(),
           "cache_bytes": model_bytes(cfg, cfg.n_layers, MODEL_CACHE,
                                      MODEL_BATCH) - cfg.param_count() * 2,
           "max_memory_allocated": peak, "wall_s": wall,
           "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
           "tok_per_s": stats["tok_per_s"], "steps_timed": stats["n"]}
    emit(row)
    MEASURED["19a"] = row
    emit({"phase": "model_serve_profile", "arch": MODEL_ARCH, "card": card,
          **decode_profile(torch, np, cfg)})
    check = serve_card_vs_cpu(torch, np, cfg)
    emit({"phase": "model_serve_cuda_vs_cpu", "arch": MODEL_ARCH, **check})
    return row


def decode_profile(torch, np, cfg):
    """Where one serve step of the full model spends its time, after three
    warm-up steps: its wall (tokens on the host), the device's busy time
    and operations under ``torch.profiler``, the idle share, and its
    synchronising host calls."""
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    model = T.init_params(cfg, torch.Generator(device=MODEL_DEV).manual_seed(
        0), device=MODEL_DEV)
    state = [T.init_decode_state(cfg, MODEL_BATCH, MODEL_CACHE,
                                 torch.bfloat16, device=MODEL_DEV)]
    step = S.make_serve_step(cfg, None)
    inp = decode_inputs(torch, np, cfg, MODEL_BATCH, 0, MODEL_DEV)

    def one():
        nxt, state[0] = step(model, state[0], inp)
        nxt.cpu()
    with torch.inference_mode():
        for _ in range(3):
            one()
        brk = device_breakdown(torch, one)
        syncs = host_syncs(torch, one)
    del model, state
    torch.cuda.empty_cache()
    return {"batch": MODEL_BATCH, "cache_len": MODEL_CACHE, **brk,
            "idle_share": 1.0 - brk["device_busy_ms"] / brk["wall_ms"],
            "host_syncs": syncs}


def arch_phase(torch, np, card):
    """19b: every architecture at full width and its reckoned depth: one
    ``forward`` over (B, S) = (MODEL_ARCH_B, MODEL_ARCH_S) (past one
    attention block and many SSD/WKV chunks), then MODEL_ARCH_STEPS decode
    steps; logits finite with the reference's shapes.  Then llama3.2-1b's
    teacher-forced decode against prefill in float32 at full size, and the
    CLI's default architecture through ``python -m
    repro_torch.launch.serve``."""
    import dataclasses
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models import transformer as T
    rows = []
    for arch in list_archs():
        full = get_config(arch)
        L = model_depth(full, MODEL_ARCH_S, MODEL_ARCH_B)
        cfg = dataclasses.replace(full, n_layers=L)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = T.init_params(cfg, torch.Generator(
            device=MODEL_DEV).manual_seed(19), device=MODEL_DEV)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        r = np.random.default_rng(19)
        if cfg.family == "audio":
            inp = {"embeds": torch.from_numpy(r.normal(size=(
                MODEL_ARCH_B, MODEL_ARCH_S, cfg.d_model))).to(
                    MODEL_DEV, torch.bfloat16)}
        else:
            inp = {"tokens": torch.from_numpy(r.integers(
                0, cfg.vocab, size=(MODEL_ARCH_B, MODEL_ARCH_S))).to(
                    MODEL_DEV)}
        tail = (cfg.n_codebooks, cfg.vocab) if cfg.family == "audio" \
            else (cfg.vocab,)
        with torch.inference_mode():
            t0 = time.perf_counter()
            logits, _ = T.forward(model, inp, cfg)
            ok = bool(torch.isfinite(logits).all())
            fwd_s = time.perf_counter() - t0
            shape = tuple(logits.shape)
            del logits
            st = T.init_decode_state(cfg, MODEL_ARCH_B, MODEL_ARCH_S,
                                     torch.bfloat16, device=MODEL_DEV)
            dec = []
            for t in range(MODEL_ARCH_STEPS):
                step_in = decode_inputs(torch, np, cfg, MODEL_ARCH_B, 100 + t,
                                        MODEL_DEV)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, st = T.decode_step(model, st, step_in, cfg)
                ok &= bool(torch.isfinite(lg).all())
                dec.append(time.perf_counter() - t0)
            dshape = tuple(lg.shape)
        row = {"phase": "model_arch", "arch": arch, "card": card,
               "family": cfg.family, "layers": L,
               "layers_published": full.n_layers, "d_model": cfg.d_model,
               "reckoned_bytes": model_bytes(cfg, L, MODEL_ARCH_S,
                                             MODEL_ARCH_B),
               "params": cfg.param_count(), "init_s": t_init,
               "forward_shape": list(shape), "forward_s": fwd_s,
               "decode_shape": list(dshape),
               "decode_step_ms": [1e3 * d for d in dec],
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "finite": ok}
        emit(row)
        rows.append(row)
        if not ok or shape != (MODEL_ARCH_B, MODEL_ARCH_S) + tail \
                or dshape != (MODEL_ARCH_B, 1) + tail:
            raise AssertionError(f"19b {arch}: finite {ok}, shapes {shape}, "
                                 f"{dshape}")
        del model, st, lg
        torch.cuda.empty_cache()
    rows.append(prefill_vs_decode(torch, np, card))
    rows.append(serve_cli(card))
    return rows


def prefill_vs_decode(torch, np, card):
    """llama3.2-1b at full size in float32 with float32 caches: the
    logits of MODEL_TF_S teacher-forced decode steps against one prefill
    of the same tokens, within MODEL_TF_TOL."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("llama3.2-1b"), dtype="float32")
    torch.cuda.empty_cache()
    model = T.init_params(cfg, torch.Generator(device=MODEL_DEV).manual_seed(
        19), device=MODEL_DEV)
    tok = torch.from_numpy(np.random.default_rng(19).integers(
        0, cfg.vocab, size=(1, MODEL_TF_S))).to(MODEL_DEV)
    with torch.inference_mode():
        full, _ = T.forward(model, {"tokens": tok}, cfg)
        st = T.init_decode_state(cfg, 1, MODEL_TF_S, torch.float32,
                                 device=MODEL_DEV)
        dec = []
        for t in range(MODEL_TF_S):
            lg, st = T.decode_step(model, st, {"tokens": tok[:, t:t + 1]},
                                   cfg)
            dec.append(lg[:, 0])
        dec = torch.stack(dec, dim=1)
    err = float((dec - full).abs().max())
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    row = {"phase": "model_prefill_vs_decode", "arch": "llama3.2-1b",
           "card": card, "dtype": "float32", "layers": cfg.n_layers,
           "tokens": MODEL_TF_S, "max_abs_err": err, "argmax_agree": agree,
           "tol": MODEL_TF_TOL, "logit_scale": float(full.abs().max())}
    emit(row)
    if not torch.allclose(dec, full, **MODEL_TF_TOL):
        raise AssertionError(f"19b: decode differs from prefill by {err}")
    del model, st, full, dec
    torch.cuda.empty_cache()
    return row


def serve_cli(card):
    """The serving CLI's default architecture (rwkv6-1.6b, full size) in
    a subprocess of its own, as a user runs it."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=MODEL_CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    line = run.stdout.strip().splitlines()[-1] if run.stdout.strip() else ""
    row = {"phase": "model_serve_cli", "command":
           "python -m repro_torch.launch.serve", "card": card,
           "returncode": run.returncode, "wall_s": wall, "stdout": line}
    emit(row)
    if run.returncode != 0 or not line.startswith("[serve] rwkv6-1.6b:"):
        raise AssertionError(f"19b: the serving CLI failed: "
                             f"{run.stderr[-2000:]}")
    return row


def moe_layer(torch, np, dtype, skewed=False, dev=None):
    """One granite layer's MoE weights drawn on the card (float32 router,
    experts in ``dtype``), the skewed router (everything to expert 0)
    when asked, and x (MODEL_MOE_X) in ``dtype``."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import MoE
    cfg = get_config(MODEL_ARCH)
    dev = dev or MODEL_DEV
    g = torch.Generator(device=dev).manual_seed(19)
    p = MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, dtype, dev, g)
    if skewed:
        p.router.data.zero_()
        p.router.data[:, 0] = 10.0
    x = torch.randn(MODEL_MOE_X, generator=g, device=dev, dtype=dtype)
    return cfg, p, x


def moe_phase(torch, np, card):
    """19c: the MoE dispatch of one granite layer at full width, x (8,
    2048, 1024).  In float32 with factors that drop nothing (16, the
    expert buffers' at least 2·ep) ``moe_local``, ``moe_ep_sim`` at (1,
    ep) for ep in MODEL_MOE_EPS against
    ``moe_dense`` within MODEL_F32_TOL; under the skewed router at the
    default factors each EP layout's exchange drops and a finite y; in
    bf16 at the default factors each call's wall (the median of 3 ending in
    a synchronise), peak and host syncs."""
    import dataclasses
    from repro_torch.models import moe as M
    cfg, p, x = moe_layer(torch, np, torch.float32)
    cfg = dataclasses.replace(cfg, dtype="float32")

    def no_drop(ep):
        """Factors 16, the expert buffers' at least 2·ep: an expert's
        buffer holds capacity_factor·k·T/E items and receives from all ep
        PEs, ep·k·T/E on average (T the tokens of one PE), so factor 16
        drops at ep = 32 in the reference's formula too."""
        return dict(capacity_factor=max(16.0, 2.0 * ep), slot_factor=16.0)
    with torch.inference_mode():
        dense, _ = M.moe_dense(x, p, cfg)
        errs = {}
        for name, fn in (
                ("moe_local", lambda: M.moe_local(x, p, cfg,
                                                  capacity_factor=16.0)),
                *[(f"moe_ep_sim(1,{ep})", lambda ep=ep: M.moe_ep_sim(
                    x, p, cfg, d=1, ep=ep, **no_drop(ep)))
                  for ep in MODEL_MOE_EPS]):
            y, _ = fn()
            errs[name] = float((y - dense).abs().max())
            if not torch.allclose(y, dense, **MODEL_F32_TOL):
                raise AssertionError(f"19c: {name} differs from moe_dense by "
                                     f"{errs[name]}")
            del y
        del dense, x, p
        torch.cuda.empty_cache()
        emit({"phase": "model_moe_check", "card": card, "dtype": "float32",
              "x": list(MODEL_MOE_X), "factors": {
                  "moe_local": 16.0, **{f"moe_ep_sim(1,{ep})": no_drop(ep)
                                        for ep in MODEL_MOE_EPS}},
              "max_abs_err_vs_dense": errs, "tol": MODEL_F32_TOL})
        cfg, p, x = moe_layer(torch, np, torch.float32, skewed=True)
        cfg = dataclasses.replace(cfg, dtype="float32")
        skew = {}
        for ep in MODEL_MOE_EPS:
            y, _, drops = M._ep_sim(x, p, cfg, 1, ep, 2.0, 2.0)
            skew[ep] = {"drops": int(drops.sum()),
                        "drops_per_pe": drops.tolist(),
                        "finite": bool(torch.isfinite(y).all())}
            if not skew[ep]["finite"]:
                raise AssertionError(f"19c: skewed y not finite at ep={ep}")
            del y
        emit({"phase": "model_moe_skewed", "card": card, "router":
              "all to expert 0", "factors": 2.0, "by_ep": skew})
        del x, p
        torch.cuda.empty_cache()
        cfg, p, x = moe_layer(torch, np, torch.bfloat16)
        times = {}
        for name, fn in (("moe_local", lambda: M.moe_local(x, p, cfg)),
                         ("moe_dense", lambda: M.moe_dense(x, p, cfg)),
                         *[(f"moe_ep_sim(1,{ep})", lambda ep=ep: M.moe_ep_sim(
                             x, p, cfg, d=1, ep=ep)) for ep in MODEL_MOE_EPS]):
            wall, peak, syncs = time_batch(
                torch, lambda fn=fn: (fn(), torch.cuda.synchronize()), reps=3)
            times[name] = {"ms": 1e3 * wall, "max_memory_allocated": peak,
                           "host_syncs": syncs}
        emit({"phase": "model_moe_times", "card": card, "dtype": "bfloat16",
              "x": list(MODEL_MOE_X), "factors": 2.0, "calls": times})
    del x, p
    torch.cuda.empty_cache()
    return {"errs": errs, "skewed": skew, "times": times}


def moe_rank(rank, world, jobs, results):
    """One rank of phase 19d (run by ``pooled_rank`` in its gloo group;
    every rank on the card 0): makes the (data 2, model 2) mesh, then for
    each dtype runs ``moe_ep_shardmap`` and ``moe_tp_shardmap`` on the
    granite layer; rank 0 also runs ``moe_ep_sim(d=2, ep=2)`` and
    ``moe_local`` on the card and compares."""
    import dataclasses
    import traceback
    try:
        import numpy as np
        import torch
        import torch.distributed as dist
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        from repro_torch.dist.sharding import make_mesh
        from repro_torch.models import moe as M
        mesh = make_mesh(np.arange(world).reshape(2, world // 2),
                         ("data", "model"))
        results.put((rank, "ready", None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        return
    while True:
        job = jobs.get()
        if job is None:
            break
        try:
            kind, (dtype_name, dev) = job
            dtype = getattr(torch, dtype_name)
            cfg, p, x = moe_layer(torch, np, dtype, dev=dev)
            cfg = dataclasses.replace(cfg, dtype=dtype_name)
            out = {}
            with torch.inference_mode():
                for name, fn in (
                        ("ep", lambda: M.moe_ep_shardmap(
                            x, p, cfg, mesh, data_axes=("data",))),
                        ("tp", lambda: M.moe_tp_shardmap(
                            x, p, cfg, mesh, data_axes=("data",)))):
                    dist.barrier()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    y, _ = fn()
                    torch.cuda.synchronize()
                    out[name + "_wall_s"] = time.perf_counter() - t0
                    out[name] = y
                out["peak"] = torch.cuda.max_memory_allocated()
                if rank == 0:
                    sim, _ = M.moe_ep_sim(x, p, cfg, d=2, ep=world // 2)
                    local, _ = M.moe_local(x, p, cfg)
                    out["ep_equal_sim"] = bool(torch.equal(out["ep"], sim))
                    out["tp_err"] = float((out["tp"].float()
                                           - local.float()).abs().max())
                    out["tp_scale"] = float(local.float().abs().max())
                    if dtype == torch.float32:
                        out["tp_close"] = bool(torch.allclose(
                            out["tp"], local, **MODEL_F32_TOL))
                    del sim, local
            ep_bits = out.pop("ep").view(torch.int16 if dtype == torch.bfloat16
                                         else torch.int32)
            out["ep_digest"] = int(ep_bits.to(torch.int64).sum())
            out.pop("tp")
            results.put((rank, "ok", out))
            del p, x, ep_bits
            torch.cuda.empty_cache()
        except BaseException:
            results.put((rank, "error", traceback.format_exc()))


def moe_dist_phase(torch, card):
    """19d: the distributed dispatch on four gloo ranks sharing the card,
    a (data 2, model 2) ``DeviceMesh``: ``moe_ep_shardmap`` equal bit for
    bit to ``moe_ep_sim(d=2, ep=2)`` on the card, ``moe_tp_shardmap``
    against ``moe_local`` (float32: within MODEL_F32_TOL); walls of four
    processes sharing one card through the host, not a multi-GPU speed."""
    ranks = four_ranks("moe")
    rows = []
    try:
        for dtype in ("bfloat16", "float32"):
            answers = ranks.run(("moe", (dtype, MODEL_DEV)))
            a0 = answers[0]
            row = {"phase": "model_moe_dist", "card": card, "dtype": dtype,
                   "ranks": MODEL_DIST_RANKS, "mesh": {"data": 2, "model": 2},
                   "transport": "gloo through the host, four processes "
                                "sharing one card",
                   "ep_equal_sim": a0["ep_equal_sim"],
                   "ep_same_on_every_rank": len({a["ep_digest"]
                                                 for a in answers}) == 1,
                   "tp_max_abs_err_vs_local": a0["tp_err"],
                   "tp_scale": a0["tp_scale"],
                   "tp_close": a0.get("tp_close"),
                   "ep_wall_s": [a["ep_wall_s"] for a in answers],
                   "tp_wall_s": [a["tp_wall_s"] for a in answers],
                   "peak_per_rank": [a["peak"] for a in answers]}
            emit(row)
            rows.append(row)
            if not (row["ep_equal_sim"] and row["ep_same_on_every_rank"]) \
                    or row["tp_close"] is False:
                raise AssertionError(f"19d: {row}")
    finally:
        ranks.release()
    return rows


def lbb_lengths(np, n, seed):
    """The reference test's law of example lengths: min(32 + zipf(1.5) %
    992, 1024)."""
    rng = np.random.default_rng(seed)
    return np.minimum(32 + (rng.zipf(1.5, size=n) % 992), 1024)


def lbb_phase(torch, np, card, psort, SortConfig, launch_counts,
              reset_launch_counts):
    """19e: ``length_balanced_batches`` on 2^26 lengths at p = 256, batch
    64, with ``"auto"``, ``"rams"`` and ``"bitonic"``: the algorithm and
    overflow of its sort, the waste before and after, the wall and the
    kernels launched.  RAMS drops keys at its second level at this n/p
    (ROADMAP §3), so where the sort overflows the batching must refuse
    as the reference's does (its reshape raises ``ValueError``); bitonic
    sorts exactly.  Then the card against the CPU at p = 64, n = 2^20, bit
    for bit.  Returns the launches of each run by algorithm."""
    from repro_torch.data.pipeline import length_balanced_batches
    n = 1 << MODEL_LBB_LOG_N
    lengths = lbb_lengths(np, n, 19)
    out = {}
    for algorithm in ("auto", "rams", "bitonic"):
        _, info = psort(lengths.astype(np.int32), SortConfig(
            p=MODEL_LBB_P, algorithm=algorithm), return_info=True,
            device=MODEL_DEV)
        chosen, overflow = info["algorithm"], info["overflow"]
        del info
        torch.cuda.empty_cache()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        row = {"phase": "model_lbb", "card": card, "n": n,
               "p": MODEL_LBB_P, "batch": MODEL_LBB_BATCH,
               "algorithm": algorithm, "chosen": chosen,
               "overflow": overflow}
        if overflow:
            refusal = expect_refusal(lambda: length_balanced_batches(
                lengths, MODEL_LBB_BATCH, p=MODEL_LBB_P, algorithm=algorithm,
                device=MODEL_DEV))
            row.update(wall_s=time.perf_counter() - t0, refused=refusal)
        else:
            batches, before, after = length_balanced_batches(
                lengths, MODEL_LBB_BATCH, p=MODEL_LBB_P, algorithm=algorithm,
                device=MODEL_DEV)
            wall = time.perf_counter() - t0
            ls = lengths[batches.reshape(-1)]
            ok = (batches.shape == (n // MODEL_LBB_BATCH, MODEL_LBB_BATCH)
                  and bool((np.diff(ls) >= 0).all()) and after < before)
            row.update(wall_s=wall, waste_before=before, waste_after=after,
                       sorted_batches=ok)
            del batches, ls
            if not ok:
                raise AssertionError(f"19e: {row}")
        row["launches"] = launch_counts()
        emit(row)
        want = RAMS_LAUNCHES if chosen == "rams" else ("tile_sort",
                                                       "run_merge")
        missing = [k for k in want if row["launches"][k] <= 0]
        if missing:
            raise AssertionError(f"19e: kernels never launched: {missing}")
        out[algorithm] = row["launches"]
    del lengths
    p, log_n = MODEL_LBB_CHECK
    lengths = lbb_lengths(np, 1 << log_n, 20)
    runs = [length_balanced_batches(lengths, MODEL_LBB_BATCH, p=p,
                                    algorithm="rams", device=dev)
            for dev in (MODEL_DEV, "cpu")]
    same = bool(np.array_equal(runs[0][0], runs[1][0])
                and runs[0][1:] == runs[1][1:])
    emit({"phase": "model_lbb_cuda_vs_cpu", "card": card, "p": p,
          "n": 1 << log_n, "algorithm": "rams", "identical": same,
          "waste_before": runs[0][1], "waste_after": runs[0][2]})
    if not same:
        raise AssertionError("19e: card batches differ from the CPU's")
    return out


def expect_refusal(fn) -> str:
    """The message of the ``ValueError`` ``fn()`` must raise (the
    reference's reshape of a perm shorter than the batches); fails if it
    returns."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("19e: the batching of an overflowed sort returned "
                         "where the reference's raises")


def model_phase(torch, np, card, psort, SortConfig, launch_counts,
                reset_launch_counts):
    """Phase 19: (a) serving, (b) every architecture, (c) the MoE
    dispatch, (d) the distributed dispatch, (e) length-balanced batching.
    Returns the launches of (e)'s RAMS run."""
    t0 = time.perf_counter()
    model_serve_phase(torch, np, card)
    arch_phase(torch, np, card)
    moe_phase(torch, np, card)
    moe_dist_phase(torch, card)
    lbb = lbb_phase(torch, np, card, psort, SortConfig, launch_counts,
                    reset_launch_counts)
    emit({"phase": "model_done", "seconds": time.perf_counter() - t0})
    return lbb


def train_bytes(cfg, L: int) -> int:
    """The reckoned device bytes of ``cfg`` cut to L layers for training:
    weights and gradients in the model's dtype (``param_count``, norms and
    routers counted in it), and the optimizer state: AdamW's two float32
    moments, or Adafactor's factored statistics (under 1 % of the
    weights: each leaf's rows plus columns, reckoned as 1 % here)."""
    import dataclasses
    n = dataclasses.replace(cfg, n_layers=L).param_count()
    opt = 8 * n if cfg.optimizer == "adamw" else n // 100
    return 4 * n + opt


def train_depth(cfg) -> int:
    """The most layers whose reckoned training bytes stay under
    TRAIN_BYTES_LIMIT (phase 19b's rule, for training)."""
    L = cfg.n_layers
    while L > 1 and train_bytes(cfg, L) > TRAIN_BYTES_LIMIT:
        L -= 1
    return L


def train_log(lines):
    """(step rows, restored steps) from ``train``'s log lines: each step's
    loss, lr, grad norm and host ms, in the order they ran."""
    rows, restored = [], []
    for ln in lines:
        m = re.match(r"\[train\] step (\d+) loss (\S+) lr (\S+) gnorm (\S+) "
                     r"ms (\S+)", ln)
        if m:
            rows.append({"step": int(m[1]), "loss": float(m[2]),
                         "lr": float(m[3]), "grad_norm": float(m[4]),
                         "ms": float(m[5])})
        m = re.match(r"\[train\] restored step (\d+)", ln)
        if m:
            restored.append(int(m[1]))
    return rows, restored


def step_stats(rows, tokens: int) -> dict:
    """p50/p99 step ms and tokens/s over the steps after each attempt's
    first (its warm-up)."""
    import numpy as np
    ms, prev = [], None
    for r in rows:
        if prev is not None and r["step"] == prev + 1:
            ms.append(r["ms"])
        prev = r["step"]
    p50 = float(np.percentile(ms, 50))
    return {"steps_timed": len(ms), "p50_ms": p50,
            "p99_ms": float(np.percentile(ms, 99)),
            "tok_per_s": tokens / (p50 / 1e3)}


KERNEL_KINDS = (("matmul", ("gemm", "nvjet", "xmma", "cutlass")),
                ("scan", ("scan",)), ("reduction", ("reduce",)),
                ("scatter/gather/index", ("scatter", "gather", "index")),
                ("copy/cast", ("copy",)), ("elementwise", ("elementwise",)))


def kernel_kinds(top) -> dict:
    """Device time and launches of a profile's operations by kind (the
    first kind whose word the kernel's name holds; "other" if none)."""
    out = {}
    for row in top:
        kind = next((k for k, words in KERNEL_KINDS
                     if any(w in row["name"] for w in words)), "other")
        n, ms = out.get(kind, (0, 0.0))
        out[kind] = (n + row["launches"], ms + row["ms"])
    return {k: {"launches": n, "ms": ms} for k, (n, ms) in
            sorted(out.items(), key=lambda kv: -kv[1][1])}


def restored_equals_saved(torch, np, mgr, state, step) -> int:
    """Restore checkpoint ``step`` into ``state`` and compare every leaf,
    read back from the card, with the saved file bit for bit; returns the
    leaves compared."""
    from repro_torch.optim import tree as tr
    state = mgr.restore(state, step=step)
    d = mgr.dir / f"step_{step:09d}"
    leaves = tr.leaves(state)
    for k, leaf in enumerate(leaves):
        arr, _ = tr.host_leaf(leaf)
        saved = np.load(d / f"leaf_{k}.npy")
        if arr.dtype != saved.dtype or not np.array_equal(arr, saved):
            raise AssertionError(f"20a: restored leaf_{k} differs from the "
                                 f"saved one")
    return len(leaves)


def train_full_phase(torch, np, card):
    """20a: ``train`` of the model at full width and TRAIN_DEPTH layers
    through a crash and a restart, then the restored state against the
    saved leaves and one step under the profiler."""
    import dataclasses
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch import train as TR
    from repro_torch.runtime import CheckpointManager
    from repro_torch.data.pipeline import TokenPipeline
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_DEPTH)
    lines = []
    with tempfile.TemporaryDirectory(prefix="train_ckpt_") as ckpt:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        final, losses = TR.train(
            cfg, None, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            ckpt_dir=ckpt, ckpt_every=TRAIN_CKPT_EVERY, log_every=1,
            crash_at=TRAIN_CRASH_AT, logger=lines.append, device=TRAIN_DEV)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        rows, restored = train_log(lines)
        mgr = CheckpointManager(ckpt)
        latest = mgr.latest_step()
        ran = [r["step"] for r in rows]
        want = list(range(TRAIN_CRASH_AT)) + list(range(
            TRAIN_CKPT_EVERY, TRAIN_STEPS))
        if final != TRAIN_STEPS or latest != TRAIN_STEPS \
                or restored != [TRAIN_CKPT_EVERY] or ran != want \
                or not all(math.isfinite(r["loss"]) for r in rows):
            raise AssertionError(f"20a: final {final}, latest {latest}, "
                                 f"restored {restored}, steps {ran}, "
                                 f"losses {[r['loss'] for r in rows]}")
        row = {"phase": "train_full", "arch": TRAIN_ARCH, "card": card,
               "layers": cfg.n_layers,
               "layers_published": get_config(TRAIN_ARCH).n_layers,
               "params": cfg.param_count(),
               "dtype": cfg.dtype, "remat": cfg.remat,
               "optimizer": cfg.optimizer, "batch": TRAIN_BATCH,
               "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
               "ckpt_every": TRAIN_CKPT_EVERY, "crash_at": TRAIN_CRASH_AT,
               "restored_from": restored, "latest_step": latest,
               "reckoned_state_bytes": train_bytes(cfg, cfg.n_layers),
               "max_memory_allocated": peak, "wall_s": wall,
               **step_stats(rows, TRAIN_BATCH * TRAIN_SEQ),
               "losses": [r["loss"] for r in rows],
               "lr": [r["lr"] for r in rows],
               "grad_norm": [r["grad_norm"] for r in rows],
               "step_ms": [r["ms"] for r in rows],
               "what": "host walls of eager steps, each ending with its "
                       "loss on the host"}
        emit(row)
        torch.cuda.empty_cache()
        state, step_fn, _ = TR.build_everything(cfg, None, TRAIN_BATCH,
                                                TRAIN_SEQ, device=TRAIN_DEV)
        t0 = time.perf_counter()
        n_leaves = restored_equals_saved(torch, np, mgr, state,
                                         TRAIN_STEPS)
        restore_s = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in (
            mgr.dir / f"step_{TRAIN_STEPS:09d}").glob("leaf_*.npy"))
    pipe = TokenPipeline(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ)
    box = [state]

    def one():
        box[0], metrics = step_fn(box[0], pipe.batch_at(int(box[0].step)))
        float(metrics["loss"])
    one()                                          # warm-up after restore
    brk = device_breakdown(torch, one, top=1 << 20)
    # phase 23's FLOPs from a step of their own: recording shapes adds host
    # work to every operator, which the wall and idle share above leave out
    flops = device_breakdown(torch, one, top=0, with_flops=True)
    MEASURED["20a"] = dict(row, matmul_flops=flops["matmul_flops"])
    emit({"phase": "train_full_restore", "card": card,
          "leaves_bit_for_bit": n_leaves, "checkpoint_bytes": ckpt_bytes,
          "restore_and_compare_s": restore_s})
    emit({"phase": "train_full_profile", "arch": TRAIN_ARCH, "card": card,
          **brk, "top": brk["top"][:12], "by_kind": kernel_kinds(brk["top"]),
          "idle_share": 1.0 - brk["device_busy_ms"] / brk["wall_ms"]})
    del state, box, step_fn
    torch.cuda.empty_cache()
    return row


def train_card_vs_cpu(torch, np, card):
    """20b: the full-width model at depth TRAIN_CHECK_DEPTH in float32,
    built once on the CPU and copied to the card, TRAIN_CHECK_STEPS steps
    on each from the same batches: metrics and every leaf of the state
    within MODEL_F32_TOL."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as TR
    from repro_torch.models.convert import train_state_leaves
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TRAIN_CHECK_DEPTH, dtype="float32")
    cpu, step, _ = TR.build_everything(cfg, None, TRAIN_CHECK_BATCH,
                                       TRAIN_CHECK_SEQ, seed=20,
                                       device="cpu")
    model = copy.deepcopy(cpu.params).to(TRAIN_DEV)
    gpu = S.TrainState(model, S.make_train_step(cfg, None)[1](model), 0)
    pipe = TokenPipeline(cfg.vocab, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ)
    metrics = []
    for i in range(TRAIN_CHECK_STEPS):
        batch = pipe.batch_at(i)
        cpu, mc = step(cpu, batch)
        gpu, mg = step(gpu, batch)
        for k in ("loss", "lr", "grad_norm"):
            c, g = float(mc[k]), float(mg[k])
            metrics.append({"step": i, "metric": k, "cpu": c, "card": g})
            if not math.isclose(g, c, rel_tol=MODEL_F32_TOL["rtol"],
                                abs_tol=MODEL_F32_TOL["atol"]):
                raise AssertionError(f"20b: step {i} {k}: card {g}, cpu {c}")
    err, n = 0.0, 0
    for a, b in zip(train_state_leaves(gpu), train_state_leaves(cpu)):
        n += 1
        if not np.allclose(a, b, **MODEL_F32_TOL):
            raise AssertionError(f"20b: leaf {n - 1} of the state differs "
                                 f"by {float(np.abs(a - b).max())}")
        err = max(err, float(np.abs(a - b).max()))
    row = {"phase": "train_cuda_vs_cpu", "arch": TRAIN_ARCH, "card": card,
           "depth": TRAIN_CHECK_DEPTH, "dtype": "float32",
           "batch": TRAIN_CHECK_BATCH, "seq": TRAIN_CHECK_SEQ,
           "steps": TRAIN_CHECK_STEPS, "leaves": n,
           "max_abs_leaf_err": err, "metrics": metrics,
           "tol": MODEL_F32_TOL}
    emit(row)
    del cpu, gpu, model
    torch.cuda.empty_cache()
    return row


def train_adafactor_phase(torch, np, card):
    """20c: mixtral-8x22b at full width with Adafactor, its depth cut by
    ``train_depth``, through ``train``: losses finite, peak, step ms."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import train as TR
    full = get_config(TRAIN_ADAFACTOR_ARCH)
    L = train_depth(full)
    cfg = dataclasses.replace(full, n_layers=L)
    lines = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    TR.train(cfg, None, steps=TRAIN_ADAFACTOR_STEPS,
             batch=TRAIN_ADAFACTOR_BATCH, seq=TRAIN_ADAFACTOR_SEQ,
             log_every=1, logger=lines.append, device=TRAIN_DEV)
    wall = time.perf_counter() - t0
    rows, _ = train_log(lines)
    if len(rows) != TRAIN_ADAFACTOR_STEPS or not all(
            math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"20c: {lines}")
    row = {"phase": "train_adafactor", "arch": TRAIN_ADAFACTOR_ARCH,
           "card": card, "layers": L, "layers_published": full.n_layers,
           "optimizer": cfg.optimizer, "dtype": cfg.dtype,
           "remat": cfg.remat, "batch": TRAIN_ADAFACTOR_BATCH,
           "seq": TRAIN_ADAFACTOR_SEQ, "params": cfg.param_count(),
           "reckoned_bytes": train_bytes(full, L),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "wall_s": wall, "losses": [r["loss"] for r in rows],
           "grad_norm": [r["grad_norm"] for r in rows],
           "step_ms": [r["ms"] for r in rows],
           "what": "host walls of eager steps; the first holds the "
                   "warm-up"}
    emit(row)
    torch.cuda.empty_cache()
    return row


def layer_grads(torch, np, p: int, directory, ranks: int):
    """The gradients of block 0 of the full-width granite model cut to one
    layer, one row per PE, each from its own batch: (p, …) tensors on the
    card by leaf name; the first ``ranks`` rows are also saved as
    ``<name>.npy`` in ``directory`` for the ranks."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import batch_on
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=1)
    model = T.init_params(cfg, torch.Generator(device=TRAIN_DEV).manual_seed(
        21), device=TRAIN_DEV).requires_grad_(True)
    pipe = TokenPipeline(cfg.vocab, 1, TRAIN_COMPRESS_SEQ)
    rows = {}
    for pe in range(p):
        model.zero_grad(set_to_none=True)
        T.loss_fn(model, batch_on(pipe.batch_at(pe), TRAIN_DEV),
                  cfg).backward()
        for name, w in model.blocks[0].named_parameters():
            rows.setdefault(name, []).append(w.grad.detach().clone())
    del model
    grads = {k: torch.stack(v) for k, v in rows.items()}
    for k, v in grads.items():
        np.save(Path(directory) / f"{k}.npy",
                v[:ranks].float().cpu().numpy())
    return grads


def digests(np, tensors) -> dict:
    """sha256 of each tensor's bytes, row by row (bit-for-bit identity)."""
    import hashlib
    out = {}
    for k, t in tensors.items():
        a = t.detach().cpu().contiguous().numpy()
        out[k] = [hashlib.sha256(a[r].tobytes()).hexdigest()
                  for r in range(a.shape[0])]
    return out


def compress_rank(rank, world, jobs, results):
    """One rank of phase 20d (run by ``pooled_rank`` in its gloo group;
    every rank on the card): for each job ("compress", (directory,)) runs
    ``compressed_psum`` at p = world on its rows of the saved gradients
    and answers the digests of its mean and residual rows, its wall and
    peak."""
    import traceback
    try:
        import numpy as np
        import torch
        import torch.distributed as dist
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        from repro_torch.core import comm
        from repro_torch.optim import compressed_psum, init_error_feedback
        results.put((rank, "ready", None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        return
    while True:
        job = jobs.get()
        if job is None:
            break
        try:
            _, (directory,) = job
            grads = {f.stem: torch.from_numpy(np.load(f, mmap_mode="r")[
                rank:rank + 1].copy()).to(TRAIN_DEV)
                for f in sorted(Path(directory).glob("*.npy"))}
            err = init_error_feedback(grads)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()   # the pool ran others
            dist.barrier()
            t0 = time.perf_counter()
            with comm.distributed(dist.group.WORLD):
                out, new = compressed_psum(grads, err, "data", world)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            results.put((rank, "ok", {
                "out": digests(np, out), "err": digests(np, new),
                "wall_s": wall, "peak": torch.cuda.max_memory_allocated()}))
            del grads, err, out, new
            torch.cuda.empty_cache()
        except BaseException:
            results.put((rank, "error", traceback.format_exc()))


def train_compress_phase(torch, np, card):
    """20d: ``compressed_psum`` of one full-width granite layer's
    gradients: the sim backend at each p of TRAIN_COMPRESS_P on the card,
    its wire bytes against an f32 all-reduce's and its error against the
    exact mean; TRAIN_COMPRESS_RANKS gloo ranks sharing the card equal to
    the sim at their p bit for bit."""
    import tempfile
    from repro_torch.core import comm
    from repro_torch.optim import compressed_psum, init_error_feedback
    world = TRAIN_COMPRESS_RANKS
    rows = []
    with tempfile.TemporaryDirectory(prefix="train_grads_") as directory:
        grads = layer_grads(torch, np, max(TRAIN_COMPRESS_P), directory,
                            world)
        numel = sum(v[0].numel() for v in grads.values())
        ranks = four_ranks("compress")
        try:
            for p in TRAIN_COMPRESS_P:
                g = {k: v[:p] for k, v in grads.items()}
                err = init_error_feedback(g)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with comm.counting() as trace:
                    out, new = compressed_psum(g, err, "data", p)
                torch.cuda.synchronize()
                sim_s = time.perf_counter() - t0
                worst = max(float((out[k][0] - g[k].float().mean(0)).abs()
                                  .max() / g[k].float().abs().max())
                            for k in g)
                row = {"phase": "train_compress", "card": card, "p": p,
                       "leaves": len(g), "elements": numel,
                       "wire_bytes_per_pe": trace.wire_bytes(),
                       "f32_allreduce_bytes_per_pe": 4 * numel,
                       "wire_ratio": trace.wire_bytes() / (4 * numel),
                       "max_err_vs_exact_mean_rel": worst,
                       "sim_wall_s": sim_s}
                if p == world:
                    answers = ranks.run(("compress", (directory,)))
                    want_out, want_err = digests(np, out), digests(np, new)
                    same = all(a["out"][k] == [want_out[k][r]]
                               and a["err"][k] == [want_err[k][r]]
                               for r, a in enumerate(answers) for k in g)
                    row.update({
                        "ranks": world, "gloo_equal_sim": same,
                        "transport": "gloo through the host, processes "
                                     "sharing one card",
                        "rank_wall_s": [a["wall_s"] for a in answers],
                        "rank_peak": [a["peak"] for a in answers]})
                    if not same:
                        raise AssertionError(f"20d: gloo ranks differ from "
                                             f"the sim at p = {p}")
                emit(row)
                rows.append(row)
                del out, new, err
        finally:
            ranks.release()
    del grads
    torch.cuda.empty_cache()
    return rows


def train_phase(torch, np, card):
    """Phase 20: (a) full-size training through a crash, (b) card against
    CPU, (c) Adafactor, (d) gradient compression; each part's seconds."""
    t0 = time.perf_counter()
    parts = {}
    for part, fn in (("a", train_full_phase), ("b", train_card_vs_cpu),
                     ("c", train_adafactor_phase),
                     ("d", train_compress_phase)):
        t = time.perf_counter()
        fn(torch, np, card)
        parts[part] = time.perf_counter() - t
    emit({"phase": "train_done", "seconds": time.perf_counter() - t0,
          "part_seconds": parts})


def mesh_cfg(arch, smoke, **kw):
    """The config of ``arch`` (its smoke variant in a rehearsal) with
    ``kw`` replaced."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_variant
    cfg = get_config(arch)
    return dataclasses.replace(smoke_variant(cfg) if smoke else cfg, **kw)


def reckoned_bytes(cfg, mesh) -> int:
    """The bytes of the slices of every weight that ``make_shardings``
    gives this rank of ``mesh`` (from the shapes alone)."""
    import torch
    from repro_torch.dist.sharding import leaf_slices, make_shardings
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.tree import param_tree
    tree = param_tree(Transformer(cfg, torch.device("meta")))
    places = make_shardings(tree, cfg, mesh)
    total = 0
    for path, leaf in tree.items():
        cut = leaf_slices(tuple(leaf.shape), places[path], mesh)
        total += math.prod(len(range(*c.indices(n)))
                           for c, n in zip(cut, leaf.shape)) * \
            torch.empty((), dtype=leaf.dtype).element_size()
    return total


def reckoned_cache_bytes(torch, cfg, mesh) -> dict:
    """The bytes of the decode state (bf16 caches of MODEL_BATCH rows over
    MODEL_CACHE slots) this rank of ``mesh`` holds by the reference's
    placement (``cache_specs`` cut to the rank's slice), and of its rows
    whole, from the shapes alone."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.dist.sharding import local_rows
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    state, shards = S.cache_specs(cfg, ShapeConfig(
        "serve", MODEL_CACHE, MODEL_BATCH, "decode"), mesh)
    rows = local_rows(MODEL_BATCH, mesh)
    return {"reckoned_cache_bytes": state_bytes(S.sharded_specs(state,
                                                                shards)),
            "rows_whole_cache_bytes": state_bytes(T.init_decode_state(
                cfg, rows.stop - rows.start, MODEL_CACHE, torch.bfloat16,
                device="meta"))}


def reckoned_wire(torch, cfg, kind, seq, batch, layout, rank,
                  cache_dtype=None) -> list:
    """[sent, received]: the bytes the dry-run (``launch/dryrun.py``, on
    the meta device) reckons that rank ``rank`` of a (data, model) mesh
    of ``layout`` sends and receives in one ``kind`` step of ``cfg`` on
    ``batch`` × ``seq`` (a decode's caches of ``cache_dtype``, bf16 by
    default).  Outside any counted scope: the dry transport counts into
    every open counter."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.dist.sharding import MeshLayout
    from repro_torch.launch import dryrun
    rec = dryrun.reckon(cfg, ShapeConfig(kind, seq, batch, kind),
                        MeshLayout.of_rank(("data", "model"), layout, rank),
                        cache_dtype=cache_dtype or torch.bfloat16)
    return [rec["sent_bytes_per_device"], rec["received_bytes_per_device"]]


def counted(comm, fn, *args):
    """(``fn(*args)``, [sent, received]): the bytes this rank's transport
    carried in the call, counted at the port's seam (the counter the
    dry-run reads)."""
    with comm.count_wire() as w:
        out = fn(*args)
    return out, [w.sent, w.received]


def wire_ok(results, key: str = "wire") -> bool:
    """Every step of every rank sent and received what the dry-run
    reckons for that rank."""
    return all(r[key] and all(step == r["reckoned_wire"] for step in r[key])
               for r in results)


def wire_row(results, key: str = "wire") -> dict:
    """The counted bytes a step of each rank (sent, received; their
    distinct values over the steps) beside the dry-run's reckoning."""
    return {"wire_counted_per_step": [sorted({tuple(x) for x in r[key]})
                                      for r in results],
            "wire_reckoned_per_step": [r["reckoned_wire"] for r in results],
            "wire_equal": wire_ok(results, key)}


def mesh_serve_job(torch, np, mesh, dev, smoke):
    """21a on one rank: ``serve`` of granite at full size on the mesh, its
    tokens and stats, the weights it holds against the bytes
    ``make_shardings`` reckons for it, its peaks (the whole call, and from
    the first step on), its wall."""
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.launch import serve as SV, steps as S
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import resident_bytes
    cfg = mesh_cfg(MODEL_ARCH, smoke)
    held = {"wire": [], "gathered": []}
    init, make_step = T.init_params, S.make_serve_step
    init_state = T.init_decode_state
    gather_model = T.gather_model
    m = MESH_LAYOUT[1]

    def gathered(shards, *a, **k):       # the weights a block gathers
        held["gathered"][-1] += sum(t.numel() * t.element_size()
                                    for t in shards) * (m - 1)
        return gather_model(shards, *a, **k)

    def keep(c, gen, device=None):
        held["model"] = init(c, gen, device=device)
        return held["model"]

    def keep_state(*a, **k):
        st = init_state(*a, **k)
        held["cache_bytes"] = state_bytes(st)
        held["cache_split"] = sorted({getattr(c, "split", None)
                                      for c in st.caches}, key=str)
        return st

    def steps_start(c, mm):              # serve's weights and state are made
        if dev == "cuda":
            torch.cuda.synchronize()
            held["peak_init"] = torch.cuda.max_memory_allocated()
            held["before_steps"] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        step = make_step(c, mm)

        def one(*a):                     # each step's bytes on the wire
            held["gathered"].append(0)
            out, wire = counted(comm, step, *a)
            held["wire"].append(wire)
            return out
        return one

    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    T.init_params, S.make_serve_step = keep, steps_start
    T.init_decode_state, T.gather_model = keep_state, gathered
    try:
        toks, stats = SV.serve(cfg, mesh, batch=MODEL_BATCH,
                               tokens=MESH_TOKENS, cache_len=MODEL_CACHE,
                               logger=lambda s: None, device=dev)
    finally:
        T.init_params, S.make_serve_step = init, make_step
        T.init_decode_state, T.gather_model = init_state, gather_model
    wall = time.perf_counter() - t0
    # the weights a step gathers at use (the other model ranks' slices
    # come in): the norms, the MoE routers and the tied embedding, whose
    # 49 155 words model 2 does not divide; attention and the experts
    # multiply in place
    out = {"wall_s": wall, "tokens": toks,
           "weight_bytes_received_per_step": held["gathered"],
           "wire": held["wire"],
           "reckoned_wire": reckoned_wire(torch, cfg, "decode", MODEL_CACHE,
                                          MODEL_BATCH, MESH_LAYOUT,
                                          dist.get_rank()),
           "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
           "tok_per_s": stats["tok_per_s"], "steps_timed": stats["n"],
           "resident_bytes": resident_bytes(held["model"]),
           "reckoned_bytes": reckoned_bytes(cfg, mesh),
           "cache_bytes": held["cache_bytes"],
           "cache_split": held["cache_split"],
           **reckoned_cache_bytes(torch, cfg, mesh),
           "whole_bytes": sum(t.numel() * t.element_size() for t in
                              T.Transformer(cfg, torch.device(
                                  "meta")).parameters())}
    if dev == "cuda":
        out.update(peak_init=held["peak_init"],
                   before_steps=held["before_steps"],
                   peak_steps=torch.cuda.max_memory_allocated())
    del held
    return out


def mesh_decode_job(torch, np, mesh, dev, smoke):
    """21b on one rank: granite at full width and depth 2 in float32, 8
    greedy decode steps on one device from a whole copy (the logits of
    this rank's rows kept on the host), then on the mesh (weights sharded
    at rest, this rank's slice of a float32 state: its rows, its KV heads)
    with the tokens gathered over ``data`` as the next input: the two
    runs' largest difference, their tokens and the mesh's wall."""
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.dist.sharding import gather_rows, local_rows
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import shard_params
    c = mesh_cfg(MODEL_ARCH, smoke, n_layers=MODEL_CHECK_DEPTH,
                 dtype="float32")
    model = T.init_params(c, torch.Generator(device=dev).manual_seed(
        MESH_SEED), device=dev)
    inp = decode_inputs(torch, np, c, MODEL_BATCH, MESH_SEED, dev)
    rows = local_rows(MODEL_BATCH, mesh)
    with torch.inference_mode():
        st = T.init_decode_state(c, MODEL_BATCH, MODEL_CACHE, torch.float32,
                                 device=dev)
        x, one, one_tok = inp, [], []
        for _ in range(MODEL_CHECK_STEPS):
            lg, st = T.decode_step(model, st, x, c)
            x = {"tokens": lg[:, -1].argmax(-1)[:, None]}
            one.append(lg[rows].cpu())
            one_tok.append(x["tokens"][:, 0].cpu().numpy())
        del st
        shard_params(model, c, mesh)
        st = T.init_decode_state(c, MODEL_BATCH, MODEL_CACHE, torch.float32,
                                 device=dev, mesh=mesh)
        splits = sorted({cache.split for cache in st.caches}, key=str)
        x, err, close, toks, wire = inp, 0.0, True, [], []
        t0 = time.perf_counter()
        for lo in one:
            (lg, st), w = counted(comm, T.decode_step, model, st, x, c, mesh,
                                  ("data",))
            wire.append(w)
            nxt = gather_rows(lg[:, -1].argmax(-1), mesh, MODEL_BATCH)
            x = {"tokens": nxt[:, None]}
            lg = lg.cpu()
            err = max(err, float((lg - lo).abs().max()))
            close &= bool(torch.allclose(lg, lo, **MODEL_F32_TOL))
            toks.append(nxt.cpu().numpy())
        wall = time.perf_counter() - t0
    return {"max_abs_logit_err": err, "within_tol": close,
            "tokens_equal": all(np.array_equal(a, b)
                                for a, b in zip(toks, one_tok)),
            "tokens": toks, "cache_split": splits, "wall_s": wall,
            "wire": wire,
            "reckoned_wire": reckoned_wire(torch, c, "decode", MODEL_CACHE,
                                           MODEL_BATCH, MESH_LAYOUT,
                                           dist.get_rank(), torch.float32)}


def mesh_length_job(torch, np, dev):
    """21d on one rank: llama3.2-1b's smoke width (2 KV heads) in float32
    on a (data 1, model 4) mesh of the four ranks, where its caches split
    their length: MESH_LENGTH_STEPS teacher-forced decode steps on one
    device, then on the mesh (each rank a block of MESH_LENGTH_CACHE / 4
    slots); the largest logit difference, the cache's shape a rank."""
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import shard_params
    mesh = make_mesh(np.arange(MESH_RANKS).reshape(MESH_LENGTH_LAYOUT),
                     ("data", "model"))
    c = mesh_cfg(MESH_LENGTH_ARCH, True, dtype="float32")
    model = T.init_params(c, torch.Generator(device=dev).manual_seed(
        MESH_SEED), device=dev)
    feeds = [torch.from_numpy(np.random.default_rng(MESH_SEED + t).integers(
        0, c.vocab, size=(MESH_LENGTH_BATCH, 1))).to(dev)
        for t in range(MESH_LENGTH_STEPS)]
    with torch.inference_mode():
        st = T.init_decode_state(c, MESH_LENGTH_BATCH, MESH_LENGTH_CACHE,
                                 torch.float32, device=dev)
        one = []
        for tok in feeds:
            lg, st = T.decode_step(model, st, {"tokens": tok}, c)
            one.append(lg)
        shard_params(model, c, mesh)
        st = T.init_decode_state(c, MESH_LENGTH_BATCH, MESH_LENGTH_CACHE,
                                 torch.float32, device=dev, mesh=mesh)
        err, close, wire = 0.0, True, []
        t0 = time.perf_counter()
        for tok, lo in zip(feeds, one):
            (lg, st), w = counted(comm, T.decode_step, model, st,
                                  {"tokens": tok}, c, mesh, ("data",))
            wire.append(w)
            err = max(err, float((lg - lo).abs().max()))
            close &= bool(torch.allclose(lg, lo, **MODEL_F32_TOL))
        wall = time.perf_counter() - t0
    return {"max_abs_logit_err": err, "within_tol": close,
            "cache_shape": list(st.caches[0].k.shape),
            "cache_split": st.caches[0].split, "wall_s": wall,
            "wire": wire,
            "reckoned_wire": reckoned_wire(
                torch, c, "decode", MESH_LENGTH_CACHE, MESH_LENGTH_BATCH,
                MESH_LENGTH_LAYOUT, dist.get_rank(), torch.float32)}


def mesh_prefill_job(torch, np, mesh, dev, smoke, rank):
    """21c on one rank: llama3.2-1b at full width and depth 2 in float32
    with context-parallel attention and ``prefill_last_only``: the prefill
    step on the mesh over (2, 2048) tokens (1024-key blocks: each model
    index takes one query block, each data index one row), the logits of
    this rank's rows and its tokens.  Rank 0 first runs ``forward`` on one
    device from a whole copy: on each data index's rows (what a rank
    computes), on the whole batch, and on the whole batch with the
    context-parallel attention of a (1, 1) layout."""
    import copy
    import dataclasses
    from repro_torch.core import comm
    from repro_torch.dist.sharding import MeshLayout, local_rows
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import shard_params
    c = mesh_cfg(MESH_CP_ARCH, smoke, n_layers=MODEL_CHECK_DEPTH,
                 dtype="float32", attn_context_parallel=True,
                 prefill_last_only=True)
    tok = torch.from_numpy(np.random.default_rng(MESH_SEED).integers(
        0, c.vocab, size=MESH_CP_SHAPE)).to(dev)
    model = T.init_params(c, torch.Generator(device=dev).manual_seed(
        MESH_SEED), device=dev)
    rows = local_rows(MESH_CP_SHAPE[0], mesh)
    out = {"rows": (rows.start, rows.stop)}
    with torch.inference_mode():
        if rank == 0:
            def one(t, layout=None):
                return T.forward(model, {"tokens": t}, c, layout,
                                 last_only=True)[0].cpu()
            n = MESH_CP_SHAPE[0] // MESH_LAYOUT[0]
            out["one_rows"] = torch.cat([one(t) for t in tok.split(n)])
            out["one_whole"] = one(tok)
            out["one_cp"] = one(tok, MeshLayout(("data", "model"), (1, 1),
                                                (0, 0)))
            # the same forward in float64 on each data index's rows: the
            # answer both float32 runs are held to
            wide = copy.deepcopy(model).double()
            c64 = dataclasses.replace(c, dtype="float64")
            out["one_float64"] = torch.cat([T.forward(
                wide, {"tokens": t}, c64, None, last_only=True)[0].cpu()
                for t in tok.split(n)])
            del wide
            model = copy.deepcopy(model)
        shard_params(model, c, mesh)
        t0 = time.perf_counter()
        lg, _ = T.forward(model, {"tokens": tok}, c, mesh, ("data",),
                          last_only=True)
        nxt, wire = counted(comm, S.make_prefill_step(c, mesh), model,
                            {"tokens": tok})
        out["wall_s"] = time.perf_counter() - t0
    out["mesh"] = lg.cpu() if rank == 0 else None
    out["tokens"] = nxt.cpu().numpy()
    out["wire"] = [wire]
    out["reckoned_wire"] = reckoned_wire(
        torch, c, "prefill", MESH_CP_SHAPE[1], MESH_CP_SHAPE[0], MESH_LAYOUT,
        rank)
    return out


def state_digest(t) -> str:
    """A tensor's bytes, hashed (the same bits on two ranks: the same
    digest)."""
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().view(
        -1).numpy().tobytes()).hexdigest()


def wide_state(st):
    """A decode state with its recurrent leaves in float64 (a float64
    reference run; ``init_decode_state`` makes them float32)."""
    return st._replace(caches=[type(c)(*(t.double() for t in c))
                               for c in st.caches])


def held_to(torch, got, one, exact) -> dict:
    """``got`` (the mesh's, float32) against one device's float32 ``one``
    and float64 ``exact`` results: the largest differences, how many
    values miss 1e-4/1e-5 against each, and one device's own float32
    distance and misses against float64.  ``ok``: within 1e-4/1e-5 of
    one device's float32, or else held to the float64 result: within
    1e-4/1e-5 of it, or, where one device's own float32 misses it too,
    no further from it than that (the largest difference and the
    misses)."""
    got, one, exact = got.cpu(), one.cpu(), exact.cpu()

    def misses(a, b):
        return int((~torch.isclose(a, b, **MODEL_F32_TOL)).sum())
    out = {"err": float((got - one).abs().max()),
           "err_float64": float((got.double() - exact).abs().max()),
           "one_err_float64": float((one.double() - exact).abs().max()),
           "misses": misses(got, one),
           "misses_float64": misses(got.double(), exact),
           "one_misses_float64": misses(one.double(), exact)}
    out["ok"] = out["misses"] == 0 or out["misses_float64"] == 0 or (
        out["misses_float64"] <= out["one_misses_float64"] and
        out["err_float64"] <= out["one_err_float64"])
    return out


def held(rows) -> dict:
    """:func:`held_to`'s records (or merged ones) merged: the largest
    distances, the misses summed, and whether every one is ``ok``."""
    out = {k: max(r[k] for r in rows)
           for k in ("err", "err_float64", "one_err_float64")}
    for k in ("misses", "misses_float64", "one_misses_float64"):
        out[k] = sum(r[k] for r in rows)
    out["ok"] = all(r["ok"] for r in rows)
    return out


def mesh_ssm_job(torch, np, mesh, dev, smoke, arch, rank):
    """21e/21f on one rank: ``arch`` at its published width cut to
    MESH_SSM[arch] layers, in float32.  One device first, from a whole
    copy: ``forward`` on MESH_SSM_PREFILL tokens and MESH_SSM_STEPS
    greedy decode steps at batch MESH_SSM_BATCH (the logits and state of
    this rank's rows kept), then both again in float64, the decode fed
    the float32 run's tokens; then the mesh, the weights sharded at rest
    and this rank's slice of a float32 state: the prefill's logits and
    tokens, the decode's logits and tokens (the tokens gathered over
    ``data`` as the next input) and each state leaf's slice
    (``cache_split_dim``), each against one device's float32 and
    float64 results (:func:`held_to`); the conv window's digest, the
    bytes of the prefill step and of each decode step, and the walls."""
    import copy
    import dataclasses
    from repro_torch.core import comm
    from repro_torch.dist.sharding import (block_slices, cache_split_dim,
                                           gather_rows, local_rows)
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import shard_params
    c = mesh_cfg(arch, smoke, n_layers=MESH_SSM[arch], dtype="float32")
    c64 = dataclasses.replace(c, dtype="float64")
    model = T.init_params(c, torch.Generator(device=dev).manual_seed(
        MESH_SEED), device=dev)
    rng = np.random.default_rng(MESH_SEED)
    tok = torch.from_numpy(rng.integers(0, c.vocab, size=MESH_SSM_PREFILL)
                           ).to(dev)
    first = torch.from_numpy(rng.integers(
        0, c.vocab, size=(MESH_SSM_BATCH, 1))).to(dev)
    prow = local_rows(MESH_SSM_PREFILL[0], mesh)
    drow = local_rows(MESH_SSM_BATCH, mesh)
    B = MESH_SSM_BATCH

    def decode(m, cfg, st, feeds):
        """One device's decode from ``first``: greedy (``feeds`` None) or
        fed ``feeds``; each step's logits of this rank's rows and the
        tokens, and the last state's rows."""
        x, steps = first, []
        for i in range(MESH_SSM_STEPS):
            lg, st = T.decode_step(m, st, {"tokens": x}, cfg)
            nxt = lg[:, -1].argmax(-1) if feeds is None else feeds[i]
            steps.append((lg[drow].cpu(), nxt.cpu().numpy()))
            x = nxt[:, None]
        return steps, [[leaf[drow] for leaf in layer]
                       for layer in st.caches]
    with torch.inference_mode():
        one = T.forward(model, {"tokens": tok}, c)[0][prow]
        one_steps, one_state = decode(model, c, T.init_decode_state(
            c, B, MESH_SSM_CACHE, torch.float32, device=dev), None)
        wide = copy.deepcopy(model).double()
        exact = T.forward(wide, {"tokens": tok[prow]}, c64)[0]
        exact_steps, exact_state = decode(wide, c64, wide_state(
            T.init_decode_state(c64, B, MESH_SSM_CACHE, torch.float64,
                                device=dev)),
            [torch.from_numpy(t).to(dev) for _, t in one_steps])
        del wide
        shard_params(model, c, mesh)
        t0 = time.perf_counter()
        lm, _ = T.forward(model, {"tokens": tok}, c, mesh, ("data",))
        nxt, pwire = counted(comm, S.make_prefill_step(c, mesh), model,
                             {"tokens": tok})
        prefill_s = time.perf_counter() - t0
        st = T.init_decode_state(c, B, MESH_SSM_CACHE, torch.float32,
                                 device=dev, mesh=mesh)
        x, steps, toks, wire = first, [], [], []
        t0 = time.perf_counter()
        for (lo, want), (ex, _) in zip(one_steps, exact_steps):
            (lg, st), w = counted(comm, T.decode_step, model, st,
                                  {"tokens": x}, c, mesh, ("data",))
            wire.append(w)
            x = gather_rows(lg[:, -1].argmax(-1), mesh, B)[:, None]
            steps.append(held_to(torch, lg, lo, ex))
            toks.append(bool(np.array_equal(x[:, 0].cpu().numpy(), want)))
        decode_s = time.perf_counter() - t0
    leaves = {}
    for mine, one_l, exact_l in zip(st.caches, one_state, exact_state):
        for f, a, b, e in zip(mine._fields, mine, one_l, exact_l):
            spec = [()] * b.ndim
            dim = cache_split_dim((B,) + tuple(b.shape[1:]), mesh)
            if dim is not None:
                spec[dim] = ("model",)
            cut = block_slices(b.shape, spec, mesh)
            got = leaves.setdefault(f, {"shape": list(a.shape), "split": dim,
                                        "layers": [], "digests": []})
            got["layers"].append(held_to(torch, a, b[cut], e[cut]))
            if f == "conv":
                got["digests"].append(state_digest(a))
    for got in leaves.values():
        got.update(held(got.pop("layers")))
    return {"rows": (prow.start, prow.stop),
            "prefill": held([held_to(torch, lm, one, exact)]),
            "prefill_tokens_equal": bool(np.array_equal(
                nxt.cpu().numpy(), one[:, -1].argmax(-1).cpu().numpy())),
            "decode": held(steps), "tokens_equal": all(toks),
            "leaves": leaves, "prefill_s": prefill_s, "decode_s": decode_s,
            "wire": [pwire], "decode_wire": wire,
            "reckoned_wire": reckoned_wire(
                torch, c, "prefill", MESH_SSM_PREFILL[1],
                MESH_SSM_PREFILL[0], MESH_LAYOUT, rank),
            "decode_reckoned_wire": reckoned_wire(
                torch, c, "decode", MESH_SSM_CACHE, B, MESH_LAYOUT, rank,
                torch.float32)}


def mesh_rank(rank, world, jobs, results):
    """One rank of phase 21 (run by ``pooled_rank`` in its gloo group;
    every rank on the card 0): makes the (data 2, model 2) mesh, then runs
    each job ("mesh", (part, device, smoke)) for part serve, decode, prefill or
    length."""
    import traceback
    try:
        import numpy as np
        import torch
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        from repro_torch.dist.sharding import make_mesh
        mesh = make_mesh(np.arange(world).reshape(MESH_LAYOUT),
                         ("data", "model"))
        results.put((rank, "ready", None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        return
    while True:
        job = jobs.get()
        if job is None:
            break
        try:
            _, (part, dev, smoke) = job
            if part == "serve":
                out = mesh_serve_job(torch, np, mesh, dev, smoke)
            elif part == "decode":
                out = mesh_decode_job(torch, np, mesh, dev, smoke)
            elif part == "length":
                out = mesh_length_job(torch, np, dev)
            elif part in MESH_SSM:
                out = mesh_ssm_job(torch, np, mesh, dev, smoke, part, rank)
            else:
                out = mesh_prefill_job(torch, np, mesh, dev, smoke, rank)
            results.put((rank, "ok", out))
            del out
            if dev == "cuda":
                torch.cuda.empty_cache()
        except BaseException:
            results.put((rank, "error", traceback.format_exc()))


def mesh_ssm_check(got, part, arch, card, smoke):
    """21e/21f's row from the ranks' results, checked: the prefill's
    logits, each decode step's and each recurrent state leaf's slice
    within 1e-4/1e-5 of one device's float32 result, or held to its
    float64 one (:func:`held_to`: at d = 2048 one device's own float32
    run misses float64 by that on some values, as 21c's does, and at
    zamba2's d = 2560 the mesh too); the prefill's tokens and the decode's as
    one device's; rwkv6's ``wkv`` split on hd_k and mamba2's ``ssm`` on
    P, as the reference's rule says; the conv window the same bits on
    both ranks along ``model``; every rank's bytes the dry-run's."""
    cfg = mesh_cfg(arch, smoke)
    heads = cfg.ssm_heads if cfg.family == "hybrid" else cfg.n_heads
    hd = (2 * cfg.d_model if cfg.family == "hybrid" else cfg.d_model) \
        // heads
    state = "ssm" if cfg.family == "hybrid" else "wkv"
    m = MESH_LAYOUT[1]
    want_shape = [MESH_SSM_BATCH // MESH_LAYOUT[0], heads, hd // m,
                  cfg.ssm_state if cfg.family == "hybrid" else hd]

    def merged(key):
        return held([r[key] for r in got])
    row = {"phase": f"mesh_{arch.split('-')[0]}", "arch": arch,
           "card": card, "layers": MESH_SSM[arch], "dtype": "float32",
           "mesh": dict(zip(("data", "model"), MESH_LAYOUT)),
           "prefill_shape": list(MESH_SSM_PREFILL), "batch": MESH_SSM_BATCH,
           "steps": MESH_SSM_STEPS, "cache_len": MESH_SSM_CACHE,
           "prefill": merged("prefill"),
           "prefill_tokens_equal": all(r["prefill_tokens_equal"]
                                       for r in got),
           "decode": merged("decode"),
           "tokens_equal": all(r["tokens_equal"] for r in got),
           "leaves": {f: dict(held([r["leaves"][f] for r in got]),
                              shape=[r["leaves"][f]["shape"] for r in got],
                              split=[r["leaves"][f]["split"] for r in got])
                      for f in got[0]["leaves"]},
           "tol": MODEL_F32_TOL,
           "prefill_s": [r["prefill_s"] for r in got],
           "decode_s": [r["decode_s"] for r in got], **wire_row(got),
           **{"decode_" + k: v for k, v in wire_row(
               [{"wire": r["decode_wire"],
                 "reckoned_wire": r["decode_reckoned_wire"]} for r in got]
               ).items()}}
    emit(row)
    digests = [r["leaves"].get("conv", {}).get("digests") for r in got]
    if not row["prefill"]["ok"] or not row["decode"]["ok"] \
            or not row["prefill_tokens_equal"] or not row["tokens_equal"] \
            or not all(x["ok"] for x in row["leaves"].values()) \
            or any(r["leaves"][state]["shape"] != want_shape or
                   r["leaves"][state]["split"] != 2 for r in got) \
            or any(digests[k] != digests[k - k % m] for k in range(len(got))) \
            or not row["wire_equal"] or not row["decode_wire_equal"]:
        raise AssertionError(f"21{part}: {row}")


def mesh_phase(torch, np, card):
    """Phase 21: serving on a (data 2, model 2) mesh of four gloo ranks
    sharing the card; (a) granite served at full size against 19a's
    one-device serve at the same seed, each rank's cache (its rows, its KV
    heads) against the slice the reference's rule reckons, (b) the mesh
    against one device in float32 at depth 2, (c) context-parallel
    prefill against one device, (d) caches split on their length, on a
    (data 1, model 4) mesh of the same ranks, against one device.  The
    walls are of four processes that share one card through the host, not
    a multi-GPU speed.  Each part prints its seconds."""
    from repro_torch.launch.serve import serve
    dev, smoke = MODEL_DEV, MESH_SMOKE
    t_all = time.perf_counter()
    parts = {}
    cfg = mesh_cfg(MODEL_ARCH, smoke)
    # 19a's serve at the same seed, cut to MESH_TOKENS steps
    one, one_stats = serve(cfg, None, batch=MODEL_BATCH, tokens=MESH_TOKENS,
                           cache_len=MODEL_CACHE, logger=lambda s: None,
                           device=dev)
    if dev == "cuda":
        torch.cuda.empty_cache()
    parts["one_device"] = time.perf_counter() - t_all
    t = time.perf_counter()
    ranks = four_ranks("mesh")
    parts["ranks_up"] = time.perf_counter() - t
    try:
        t = time.perf_counter()
        a = ranks.run(("mesh", ("serve", dev, smoke)))
        parts["a"] = time.perf_counter() - t
        toks = a[0]["tokens"]
        row = {"phase": "mesh_serve", "arch": cfg.name, "card": card,
               "mesh": dict(zip(("data", "model"), MESH_LAYOUT)),
               "ranks": MESH_RANKS,
               "transport": "gloo through the host, four processes "
                            "sharing one card",
               "dtype": cfg.dtype, "batch": MODEL_BATCH,
               "tokens": MESH_TOKENS, "cache_len": MODEL_CACHE,
               "tokens_equal_on_every_rank": all(
                   np.array_equal(r["tokens"], toks) for r in a),
               "share_equal_to_one_device": float(np.mean(toks == one)),
               "one_device_p50_ms": one_stats["p50_ms"],
               "whole_bytes": a[0]["whole_bytes"]}
        for k in ("resident_bytes", "reckoned_bytes", "cache_bytes",
                  "reckoned_cache_bytes", "rows_whole_cache_bytes",
                  "cache_split", "peak_init", "before_steps", "peak_steps",
                  "p50_ms", "p99_ms", "tok_per_s", "steps_timed",
                  "wall_s"):
            row[k] = [r.get(k) for r in a]
        row["weight_bytes_received_per_step"] = [
            sorted(set(r["weight_bytes_received_per_step"])) for r in a]
        row.update(wire_row(a))
        emit(row)
        if not row["tokens_equal_on_every_rank"] or toks.shape != (
                MESH_TOKENS * MODEL_BATCH,) or any(
                r["resident_bytes"] != r["reckoned_bytes"] or
                r["cache_bytes"] != r["reckoned_cache_bytes"] or
                r["cache_split"] != [2] for r in a) \
                or any(r["p50_ms"] is None for r in a) \
                or not row["wire_equal"]:
            raise AssertionError(f"21a: {row}")

        t = time.perf_counter()
        b = ranks.run(("mesh", ("decode", dev, smoke)))
        parts["b"] = time.perf_counter() - t
        same = all(r["tokens_equal"] for r in b) and all(
            np.array_equal(np.stack(r["tokens"]), np.stack(b[0]["tokens"]))
            for r in b)
        row = {"phase": "mesh_vs_one_device", "arch": cfg.name,
               "card": card, "depth": MODEL_CHECK_DEPTH, "dtype": "float32",
               "steps": MODEL_CHECK_STEPS, "batch": MODEL_BATCH,
               "cache_split": [r["cache_split"] for r in b],
               "tokens_equal": same,
               "max_abs_logit_err": max(r["max_abs_logit_err"] for r in b),
               "tol": MODEL_F32_TOL, "wall_s": [r["wall_s"] for r in b],
               **wire_row(b)}
        emit(row)
        if not same or not all(r["within_tol"] for r in b) or any(
                r["cache_split"] != [2] for r in b) or not row["wire_equal"]:
            raise AssertionError(f"21b: {row}")

        t = time.perf_counter()
        c = ranks.run(("mesh", ("prefill", dev, smoke)))
        parts["c"] = time.perf_counter() - t
        lm, (lo, hi) = c[0]["mesh"], c[0]["rows"]
        exact = c[0]["one_float64"][lo:hi]

        def off(a, b):                   # (largest difference, misses of
            d = (a.double() - b.double()).abs()     # MODEL_F32_TOL)
            return float(d.max()), int((d > MODEL_F32_TOL["atol"] +
                                        MODEL_F32_TOL["rtol"] *
                                        b.double().abs()).sum())
        errs = {k: off(lm, c[0][k][lo:hi])
                for k in ("one_rows", "one_whole", "one_cp")}
        want = c[0]["one_rows"][:, -1].argmax(-1).numpy()
        row = {"phase": "mesh_cp_prefill", "arch": MESH_CP_ARCH,
               "card": card, "depth": MODEL_CHECK_DEPTH, "dtype": "float32",
               "shape": list(MESH_CP_SHAPE), "block": 1024,
               "logits_shape": list(lm.shape),
               "max_abs_logit_err": errs["one_rows"][0],
               "misses_of_tol": errs["one_rows"][1],
               "max_abs_logit_err_whole_batch": errs["one_whole"][0],
               "max_abs_logit_err_one_device_cp": errs["one_cp"][0],
               "float64": {"mesh": off(lm, exact),
                           "one_device": off(c[0]["one_rows"][lo:hi], exact),
                           "one_device_whole_batch": off(
                               c[0]["one_whole"][lo:hi], exact)},
               "tol": MODEL_F32_TOL,
               "tokens_equal": all(np.array_equal(
                   r["tokens"], want[r["rows"][0]:r["rows"][1]])
                   for r in c),
               "wall_s": [r["wall_s"] for r in c], **wire_row(c)}
        emit(row)
        # the mesh sums the products over model in another order than one
        # device's matmuls; at d = 2048 either float32 run misses the
        # tolerance on a few of the 128 256 logits against the other, so
        # both are held to the float64 forward, the mesh within it
        if not torch.allclose(lm.double(), exact.double(),
                              **MODEL_F32_TOL) or not row["tokens_equal"] \
                or not row["wire_equal"]:
            raise AssertionError(f"21c: {row}")

        t = time.perf_counter()
        d = ranks.run(("mesh", ("length", dev, smoke)))
        parts["d"] = time.perf_counter() - t
        row = {"phase": "mesh_length_split", "arch": MESH_LENGTH_ARCH,
               "card": card, "width": "smoke", "dtype": "float32",
               "mesh": dict(zip(("data", "model"), MESH_LENGTH_LAYOUT)),
               "batch": MESH_LENGTH_BATCH, "cache_len": MESH_LENGTH_CACHE,
               "steps": MESH_LENGTH_STEPS,
               "cache_shape": [r["cache_shape"] for r in d],
               "cache_split": [r["cache_split"] for r in d],
               "max_abs_logit_err": max(r["max_abs_logit_err"] for r in d),
               "tol": MODEL_F32_TOL, "wall_s": [r["wall_s"] for r in d],
               **wire_row(d)}
        emit(row)
        if not all(r["within_tol"] for r in d) or any(
                r["cache_split"] != 1 for r in d) or not row["wire_equal"]:
            raise AssertionError(f"21d: {row}")

        for part, arch in (("e", "rwkv6-1.6b"), ("f", "zamba2-2.7b")):
            t = time.perf_counter()
            got = ranks.run(("mesh", (arch, dev, smoke)))
            parts[part] = time.perf_counter() - t
            mesh_ssm_check(got, part, arch, card, smoke)
    finally:
        ranks.release()
    emit({"phase": "mesh_done", "seconds": time.perf_counter() - t_all,
          "part_seconds": parts})


def state_bytes(tree) -> int:
    """The bytes of the tensors of a tree (a rank's slices on a mesh)."""
    from repro_torch.optim import tree as tr
    return sum(t.numel() * t.element_size() for leaf in tr.leaves(tree)
               if not isinstance(leaf, int) for t in tr.layers(leaf))


def reckoned_state_bytes(torch, cfg, shards) -> dict:
    """The bytes of the slices ``make_shardings`` gives this rank of the
    weights and of the optimizer state of ``cfg`` (from the shapes)."""
    from repro_torch.launch import steps as S
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import make_optimizer
    from repro_torch.optim import tree as tr
    params = tr.param_tree(Transformer(cfg, torch.device("meta")))
    opt = make_optimizer(cfg.optimizer)[0](params)
    out = {}
    for name, whole, sh in (("weights", params, shards.params),
                            ("opt", opt, shards.opt)):
        cut = tr.map_with(lambda leaf, s: s.cut(leaf), whole, sh)
        out[name] = state_bytes(cut)
    return out


def mesh_train_full_job(torch, np, mesh, dev, smoke, ckpt):
    """22a on one rank: ``train`` of granite at full width and
    MESH_TRAIN_DEPTH layers on the mesh through a crash and a restart;
    each step's exact loss and transport bytes, the resident bytes of the
    final state against the reckoned slices, the peak, and the saved
    step's whole leaves against the slices put together (rank 0 reads
    the files)."""
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.launch import train as TR
    from repro_torch.models.convert import resident_bytes
    from repro_torch.optim import tree as tr
    cfg = mesh_cfg(TRAIN_ARCH, smoke, n_layers=MESH_TRAIN_DEPTH)
    held = {"steps": []}
    build = TR.build_everything

    def keep(*a, **k):
        state, step_fn, shards = build(*a, **k)
        held["shards"] = shards

        def step(st, batch):
            wire.sent = wire.received = 0
            st, metrics = step_fn(st, batch)
            held["steps"].append({"step": st.step - 1,
                                  "loss": float(metrics["loss"]),
                                  "sent": wire.sent,
                                  "received": wire.received})
            held["state"] = st
            return st, metrics
        return state, step, shards

    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    lines = []
    dist.barrier()
    t0 = time.perf_counter()
    TR.build_everything = keep
    try:
        # the bytes this rank sends and receives, counted at the port's
        # transport seam (the counter the dry-run's op_cost reads)
        with comm.count_wire() as wire:
            final, _ = TR.train(
                cfg, mesh, steps=MESH_TRAIN_STEPS, batch=MESH_TRAIN_BATCH,
                seq=MESH_TRAIN_SEQ, ckpt_dir=ckpt,
                ckpt_every=MESH_TRAIN_CKPT_EVERY, log_every=1,
                crash_at=MESH_TRAIN_CRASH_AT, logger=lines.append,
                device=dev)
    finally:
        TR.build_everything = build
    wall = time.perf_counter() - t0
    state, shards = held["state"], held["shards"]
    out = {"final": final, "wall_s": wall, "steps": held["steps"],
           "lines": lines,
           "wire": [[s["sent"], s["received"]] for s in held["steps"]],
           "reckoned_wire": reckoned_wire(torch, cfg, "train",
                                          MESH_TRAIN_SEQ, MESH_TRAIN_BATCH,
                                          MESH_LAYOUT, dist.get_rank()),
           "resident_weight_bytes": resident_bytes(state.params),
           "resident_opt_bytes": state_bytes(state.opt),
           "reckoned": reckoned_state_bytes(torch, cfg, shards)}
    if dev == "cuda":
        out["peak"] = torch.cuda.max_memory_allocated()
    rows, _ = train_log(lines)
    out.update(step_stats(rows, MESH_TRAIN_BATCH * MESH_TRAIN_SEQ))
    # the saved step's whole leaves against this state's slices put
    # together (the gathers are collective; rank 0 reads the files)
    t0 = time.perf_counter()
    d = Path(ckpt) / f"step_{MESH_TRAIN_STEPS:09d}"
    rank0, same, n = dist.get_rank() == 0, True, 0
    for k, (leaf, sh) in enumerate(zip(tr.leaves(state),
                                       tr.leaves(shards))):
        whole = sh.whole(leaf)
        if rank0:
            arr, _ = tr.host_leaf(whole)
            saved = np.load(d / f"leaf_{k}.npy")
            same &= arr.dtype == saved.dtype and np.array_equal(arr, saved)
            n += 1
        del whole
    out.update(saved_leaves=n, saved_bit_for_bit=same if rank0 else None,
               compare_s=time.perf_counter() - t0)
    del state, held
    return out


def slice_err(torch, mesh_state, one_state, shards) -> tuple:
    """(largest difference, all within MODEL_F32_TOL, leaves) between this
    rank's slices of a state on the mesh and the same slices of the
    one-device state."""
    from repro_torch.optim import tree as tr
    err, ok, n = 0.0, True, 0
    for mine, one, sh in zip(tr.leaves(mesh_state), tr.leaves(one_state),
                             tr.leaves(shards)):
        n += 1
        if isinstance(mine, int):
            ok &= mine == one
            continue
        for a, b in zip(tr.layers(mine), tr.layers(sh.cut(one))):
            a, b = a.detach(), b.detach()
            err = max(err, float((a.float() - b.float()).abs().max()))
            ok &= bool(torch.allclose(a, b, **MODEL_F32_TOL))
    return err, ok, n


def mesh_train_check_job(torch, np, mesh, dev, smoke, ckpt):
    """22b on one rank: llama3.2-1b at full width and depth 2 in float32,
    MESH_CHECK_STEPS steps on one device (this rank) and on the mesh from
    the same weights, the metrics of each step and this rank's slices of
    the state compared; then the mesh's state saved to ``ckpt`` and one
    more step on each."""
    import copy
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import shard_params
    c = mesh_cfg(MESH_CHECK_ARCH, smoke, n_layers=MESH_CHECK_DEPTH,
                 dtype="float32")
    model = T.init_params(c, torch.Generator(device=dev).manual_seed(
        MESH_TRAIN_SEED), device=dev)
    whole = copy.deepcopy(model).requires_grad_(True)
    sharded = shard_params(model, c, mesh).requires_grad_(True)
    step1, init1 = S.make_train_step(c, None)
    stepm, initm = S.make_train_step(c, mesh)
    one = S.TrainState(whole, init1(whole), 0)
    on_mesh = S.TrainState(sharded, initm(sharded), 0)
    shards = S.state_shardings(c, mesh)
    pipe = TokenPipeline(c.vocab, MESH_CHECK_BATCH, MESH_CHECK_SEQ)
    metrics, ms, wire = [], [], []
    for i in range(MESH_CHECK_STEPS + 1):
        if i == MESH_CHECK_STEPS:            # the checkpoint (d) restores
            from repro_torch.runtime import CheckpointManager
            mgr = CheckpointManager(ckpt, mesh=mesh)
            t0 = time.perf_counter()
            mgr.save(on_mesh.step, on_mesh, shardings=shards)
            mgr.wait()
            save_s = time.perf_counter() - t0
            err, ok, n = slice_err(torch, on_mesh, one, shards)
        batch = pipe.batch_at(i)
        one, m1 = step1(one, batch)
        t0 = time.perf_counter()
        (on_mesh, mm), w = counted(comm, stepm, on_mesh, batch)
        float(mm["loss"])
        wire.append(w)
        ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append({k: (float(m1[k]), float(mm[k]))
                        for k in ("loss", "lr", "grad_norm")})
    out = {"metrics": metrics, "step_ms": ms, "max_abs_leaf_err": err,
           "leaves_within_tol": ok, "leaves": n, "save_s": save_s,
           "wire": wire,
           "reckoned_wire": reckoned_wire(torch, c, "train", MESH_CHECK_SEQ,
                                          MESH_CHECK_BATCH, MESH_LAYOUT,
                                          dist.get_rank()),
           "checkpoint_bytes": sum(f.stat().st_size for f in (
               Path(ckpt) / f"step_{MESH_CHECK_STEPS:09d}").glob(
                   "leaf_*.npy")) if mgr.writer else None}
    del one, on_mesh, whole, sharded, model
    return out


def mesh_train_cpu_job(torch, np, mesh, dev, smoke):
    """22c on one rank: granite at full width and depth 2 in float32,
    drawn on the CPU, MESH_CPU_STEPS steps on the mesh with card tensors
    and with CPU tensors from the same weights: both runs' losses and
    this rank's slices compared."""
    import copy
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import shard_params
    c = mesh_cfg(TRAIN_ARCH, smoke, n_layers=MESH_CHECK_DEPTH,
                 dtype="float32")
    cpu_model = shard_params(T.init_params(c, torch.Generator().manual_seed(
        MESH_TRAIN_SEED), device="cpu"), c, mesh).requires_grad_(True)
    card_model = copy.deepcopy(cpu_model).to(dev)
    step, init = S.make_train_step(c, mesh)
    runs, wire = {}, []
    for name, model in (("card", card_model), ("cpu", cpu_model)):
        st = S.TrainState(model, init(model), 0)
        pipe = TokenPipeline(c.vocab, MESH_CHECK_BATCH, MESH_CHECK_SEQ)
        losses = []
        t0 = time.perf_counter()
        for i in range(MESH_CPU_STEPS):
            (st, m), w = counted(comm, step, st, pipe.batch_at(i))
            losses.append(float(m["loss"]))
            wire.append(w)
        runs[name] = (st, losses, time.perf_counter() - t0)
    err, ok, n = 0.0, True, 0
    from repro_torch.optim import tree as tr
    for a, b in zip(tr.leaves(runs["card"][0]), tr.leaves(runs["cpu"][0])):
        n += 1
        if isinstance(a, int):
            ok &= a == b
            continue
        for x, y in zip(tr.layers(a), tr.layers(b)):
            x = x.detach().cpu()
            err = max(err, float((x - y.detach()).abs().max()))
            ok &= bool(torch.allclose(x, y.detach(), **MODEL_F32_TOL))
    return {"card_losses": runs["card"][1], "cpu_losses": runs["cpu"][1],
            "card_s": runs["card"][2], "cpu_s": runs["cpu"][2],
            "max_abs_leaf_err": err, "leaves_within_tol": ok, "leaves": n,
            "wire": wire,
            "reckoned_wire": reckoned_wire(torch, c, "train", MESH_CHECK_SEQ,
                                           MESH_CHECK_BATCH, MESH_LAYOUT,
                                           dist.get_rank())}


def mesh_train_ssm_job(torch, np, mesh, dev, smoke):
    """22e on one rank: rwkv6 at 21e's size (its published width, 2
    layers, float32) on a batch of MESH_SSM_PREFILL's shape:
    ``loss_and_grads`` on one device (a whole copy) and on the mesh from
    the same weights, the loss and this rank's slice of every gradient
    leaf against one device's; then one ``make_train_step`` step on the
    mesh, its bytes beside the dry-run's."""
    import copy
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import shard_params
    from repro_torch.optim.tree import layers
    arch = "rwkv6-1.6b"
    c = mesh_cfg(arch, smoke, n_layers=MESH_SSM[arch], dtype="float32")
    model = T.init_params(c, torch.Generator(device=dev).manual_seed(
        MESH_TRAIN_SEED), device=dev)
    whole = copy.deepcopy(model).requires_grad_(True)
    sharded = shard_params(model, c, mesh).requires_grad_(True)
    batch = TokenPipeline(c.vocab, *MESH_SSM_PREFILL).batch_at(0)
    on_dev = S.batch_on(batch, dev)
    one_loss, one_grads = S.loss_and_grads(whole, on_dev, c)
    del whole
    t0 = time.perf_counter()
    loss, grads = S.loss_and_grads(sharded, on_dev, c, mesh, ("data",))
    grads_s = time.perf_counter() - t0
    shards = S.state_shardings(c, mesh).params
    err, ok, n = 0.0, True, 0
    for k, g in grads.items():
        for a, b in zip(layers(g), layers(shards[k].cut(one_grads[k]))):
            n += 1
            err = max(err, float((a - b).abs().max()))
            ok &= a.shape == b.shape and bool(torch.allclose(
                a, b, **MODEL_F32_TOL))
    del grads, one_grads
    step, init = S.make_train_step(c, mesh)
    state = S.TrainState(sharded, init(sharded), 0)
    t0 = time.perf_counter()
    (state, m), w = counted(comm, step, state, batch)
    step_loss = float(m["loss"])
    step_s = time.perf_counter() - t0
    return {"one_loss": float(one_loss), "loss": float(loss),
            "step_loss": step_loss, "max_abs_leaf_err": err,
            "leaves_within_tol": ok, "leaves": n, "grads_s": grads_s,
            "step_s": step_s, "wire": [w],
            "reckoned_wire": reckoned_wire(
                torch, c, "train", MESH_SSM_PREFILL[1], MESH_SSM_PREFILL[0],
                MESH_LAYOUT, dist.get_rank())}


def mesh_elastic_job(torch, np, dev, smoke, ckpts):
    """22d on one rank: ``rescale_state`` of 22b's and 22a's checkpoints
    onto the MESH_ELASTIC meshes of the four ranks, into states drawn
    from another seed; each restored slice against the new
    ``make_shardings`` slice of the saved leaf, bit for bit; on (4, 1)
    the next step of 22b's model."""
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.launch import train as TR
    from repro_torch.optim import tree as tr
    from repro_torch.runtime import CheckpointManager, rescale_state
    out = []
    for arch, layers_, dtype, ckpt in (
            (MESH_CHECK_ARCH, MESH_CHECK_DEPTH, "float32", ckpts["b"]),
            (TRAIN_ARCH, MESH_TRAIN_DEPTH, None, ckpts["a"])):
        kw = {"n_layers": layers_} | ({"dtype": dtype} if dtype else {})
        c = mesh_cfg(arch, smoke, **kw)
        mgr = CheckpointManager(ckpt)
        step = mgr.latest_step()
        d = Path(ckpt) / f"step_{step:09d}"
        for layout in MESH_ELASTIC:
            t0 = time.perf_counter()
            mesh = make_mesh(np.arange(4).reshape(layout),
                             ("data", "model"))
            like, step_fn, shards = TR.build_everything(
                c, mesh, MESH_CHECK_BATCH, MESH_CHECK_SEQ, seed=1,
                device=dev)
            state = rescale_state(None, like, c, mesh, mgr)
            same, n = True, 0
            for k, (leaf, sh) in enumerate(zip(tr.leaves(state),
                                               tr.leaves(shards))):
                saved = np.load(d / f"leaf_{k}.npy")
                if not isinstance(leaf, int):
                    saved = saved[sh.slices(saved.shape)]
                arr, _ = tr.host_leaf(leaf)
                same &= arr.dtype == saved.dtype and np.array_equal(
                    arr, saved)
                n += 1
            row = {"arch": arch, "mesh": list(layout), "step": step,
                   "leaves": n, "slices_bit_for_bit": same}
            if arch == MESH_CHECK_ARCH and layout == MESH_ELASTIC[0]:
                pipe = TokenPipeline(c.vocab, MESH_CHECK_BATCH,
                                     MESH_CHECK_SEQ)
                (state, m), w = counted(comm, step_fn, state,
                                        pipe.batch_at(step))
                row["next_loss"] = float(m["loss"])
                row["wire"] = [w]
                row["reckoned_wire"] = reckoned_wire(
                    torch, c, "train", MESH_CHECK_SEQ, MESH_CHECK_BATCH,
                    layout, dist.get_rank())
            row["seconds"] = time.perf_counter() - t0
            out.append(row)
            del like, state, step_fn
            if dev == "cuda":
                torch.cuda.empty_cache()
    return out


def mesh_train_rank(rank, world, jobs, results):
    """One rank of phase 22 (run by ``pooled_rank`` in its gloo group;
    every rank on the card 0): makes the (data 2, model 2) mesh, then runs
    each job ("train", (part, device, smoke, directories)) for part full,
    check, cpu or elastic."""
    import traceback
    try:
        import numpy as np
        import torch
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        from repro_torch.dist.sharding import make_mesh
        mesh = make_mesh(np.arange(world).reshape(MESH_LAYOUT),
                         ("data", "model"))
        results.put((rank, "ready", None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        return
    while True:
        job = jobs.get()
        if job is None:
            break
        try:
            _, (part, dev, smoke, dirs) = job
            if part == "full":
                out = mesh_train_full_job(torch, np, mesh, dev, smoke,
                                          dirs["a"])
            elif part == "check":
                out = mesh_train_check_job(torch, np, mesh, dev, smoke,
                                           dirs["b"])
            elif part == "cpu":
                out = mesh_train_cpu_job(torch, np, mesh, dev, smoke)
            elif part == "ssm":
                out = mesh_train_ssm_job(torch, np, mesh, dev, smoke)
            else:
                out = mesh_elastic_job(torch, np, dev, smoke, dirs)
            results.put((rank, "ok", out))
            del out
            if dev == "cuda":
                torch.cuda.empty_cache()
        except BaseException:
            results.put((rank, "error", traceback.format_exc()))


# the rank function of each phase that runs on the pooled ranks
POOLED = {"moe": moe_rank, "compress": compress_rank, "mesh": mesh_rank,
          "train": mesh_train_rank}


def close_to(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=MODEL_F32_TOL["rtol"],
                        abs_tol=MODEL_F32_TOL["atol"])


def mesh_train_full(ranks, card, dev, smoke, dirs):
    """22a on the ranks: ``train`` of granite at full width and
    MESH_TRAIN_DEPTH layers on the mesh through a crash and a restart,
    checked; its row kept for phase 23."""
    a = ranks.run(("train", ("full", dev, smoke, dirs)))
    cfg = mesh_cfg(TRAIN_ARCH, smoke, n_layers=MESH_TRAIN_DEPTH)
    losses = [[s["loss"] for s in r["steps"]] for r in a]
    ran = [s["step"] for s in a[0]["steps"]]
    want = list(range(MESH_TRAIN_CRASH_AT)) + list(range(
        MESH_TRAIN_CKPT_EVERY, MESH_TRAIN_STEPS))
    first = {s["step"]: s["loss"] for s in
             a[0]["steps"][:MESH_TRAIN_CRASH_AT]}
    replayed = {s["step"]: s["loss"] for s in
                a[0]["steps"][MESH_TRAIN_CRASH_AT:]
                if s["step"] in first}
    timed = [s for s in a[0]["steps"][1:]]
    row = {"phase": "mesh_train", "arch": cfg.name, "card": card,
           "mesh": dict(zip(("data", "model"), MESH_LAYOUT)),
           "ranks": MESH_RANKS,
           "transport": "gloo through the host, four processes "
                        "sharing one card",
           "layers": cfg.n_layers, "dtype": cfg.dtype,
           "remat": cfg.remat, "optimizer": cfg.optimizer,
           "batch": MESH_TRAIN_BATCH, "seq": MESH_TRAIN_SEQ,
           "steps": MESH_TRAIN_STEPS,
           "ckpt_every": MESH_TRAIN_CKPT_EVERY,
           "crash_at": MESH_TRAIN_CRASH_AT, "steps_ran": ran,
           "losses": losses[0],
           "losses_equal_on_every_rank": all(
               x == losses[0] for x in losses),
           "replayed": {str(k): [first[k], v]
                        for k, v in replayed.items()},
           "sent_bytes_per_step": statistics.median(
               s["sent"] for s in timed),
           "received_bytes_per_step": statistics.median(
               s["received"] for s in timed),
           "whole_logits_bytes_per_step": MESH_TRAIN_WHOLE_LOGITS_BYTES,
           # the whole logits gathered over data and their gradient
           # reduce-scattered: (d - 1) / d of the bf16 logits, twice
           "logits_share": 2 * MESH_TRAIN_BATCH * MESH_TRAIN_SEQ * cfg.vocab
           * 2 * (MESH_LAYOUT[0] - 1) // MESH_LAYOUT[0],
           "whole_logits_peak": MESH_TRAIN_WHOLE_LOGITS_PEAK,
           "what": "host walls of eager steps of four ranks "
                   "sharing one card through gloo; bytes are "
                   "this rank's to and from the others"}
    for k in ("resident_weight_bytes", "resident_opt_bytes",
              "reckoned", "peak", "p50_ms", "p99_ms",
              "tok_per_s", "steps_timed", "wall_s",
              "saved_bit_for_bit", "compare_s"):
        row[k] = [r.get(k) for r in a]
    row.update(wire_row(a))
    emit(row)
    if ran != want or not row["losses_equal_on_every_rank"] \
            or not row["wire_equal"] \
            or not all(math.isfinite(v) for v in losses[0]) \
            or not replayed or any(first[k] != v for k, v in
                                   replayed.items()) \
            or any(r["final"] != MESH_TRAIN_STEPS for r in a) \
            or any(r["resident_weight_bytes"] !=
                   r["reckoned"]["weights"] or
                   r["resident_opt_bytes"] != r["reckoned"]["opt"]
                   for r in a) \
            or not a[0]["saved_bit_for_bit"] \
            or a[0]["saved_leaves"] == 0 \
            or row["sent_bytes_per_step"] >= MESH_TRAIN_WHOLE_LOGITS_BYTES \
            or (dev == "cuda" and max(row["peak"])
                >= MESH_TRAIN_WHOLE_LOGITS_PEAK):
        raise AssertionError(f"22a: {row}")
    MEASURED["22a"] = row
    return row


def mesh_train_phase(torch, np, card):
    """Phase 22: training on a (data 2, model 2) mesh of four gloo ranks
    sharing the card: (a) granite at full width through a crash and a
    restart, (b) llama3.2-1b on the mesh against one device in float32,
    (c) granite's card ranks against the same ranks on the CPU, (d) the
    elastic restores.  The walls are of four processes that share one
    card through the host, not a multi-GPU speed.  Each part prints its
    seconds."""
    import tempfile
    dev, smoke = MODEL_DEV, MESH_SMOKE
    t_all = time.perf_counter()
    parts = {}
    with tempfile.TemporaryDirectory(prefix="mesh_train_") as tmp:
        dirs = {"a": str(Path(tmp) / "a"), "b": str(Path(tmp) / "b")}
        t = time.perf_counter()
        ranks = four_ranks("train")
        parts["ranks_up"] = time.perf_counter() - t
        try:
            t = time.perf_counter()
            mesh_train_full(ranks, card, dev, smoke, dirs)
            parts["a"] = time.perf_counter() - t

            t = time.perf_counter()
            b = ranks.run(("train", ("check", dev, smoke, dirs)))
            parts["b"] = time.perf_counter() - t
            ok = all(r["leaves_within_tol"] for r in b) and all(
                close_to(x, y) for r in b for m in r["metrics"]
                for x, y in m.values())
            mesh_metrics = [[{k: v[1] for k, v in m.items()}
                             for m in r["metrics"]] for r in b]
            same = all(m == mesh_metrics[0] for m in mesh_metrics)
            row = {"phase": "mesh_train_vs_one_device",
                   "arch": MESH_CHECK_ARCH, "card": card,
                   "depth": MESH_CHECK_DEPTH, "dtype": "float32",
                   "batch": MESH_CHECK_BATCH, "seq": MESH_CHECK_SEQ,
                   "steps": MESH_CHECK_STEPS,
                   "metrics_one_device_vs_mesh": b[0]["metrics"],
                   "mesh_metrics_equal_on_every_rank": same,
                   "max_abs_leaf_err": max(r["max_abs_leaf_err"]
                                           for r in b),
                   "leaves": b[0]["leaves"], "tol": MODEL_F32_TOL,
                   "step_ms": [r["step_ms"] for r in b],
                   "save_s": [r["save_s"] for r in b],
                   "checkpoint_bytes": b[0]["checkpoint_bytes"],
                   **wire_row(b)}
            emit(row)
            if not ok or not same or not row["wire_equal"]:
                raise AssertionError(f"22b: {row}")

            t = time.perf_counter()
            c = ranks.run(("train", ("cpu", dev, smoke, dirs)))
            parts["c"] = time.perf_counter() - t
            row = {"phase": "mesh_train_cuda_vs_cpu", "arch": TRAIN_ARCH,
                   "card": card, "depth": MESH_CHECK_DEPTH,
                   "dtype": "float32", "batch": MESH_CHECK_BATCH,
                   "seq": MESH_CHECK_SEQ, "steps": MESH_CPU_STEPS,
                   "card_losses": c[0]["card_losses"],
                   "cpu_losses": c[0]["cpu_losses"],
                   "max_abs_leaf_err": max(r["max_abs_leaf_err"]
                                           for r in c),
                   "leaves": c[0]["leaves"], "tol": MODEL_F32_TOL,
                   "card_s": [r["card_s"] for r in c],
                   "cpu_s": [r["cpu_s"] for r in c], **wire_row(c)}
            emit(row)
            if not all(r["leaves_within_tol"] for r in c) or not all(
                    close_to(x, y) for r in c for x, y in zip(
                        r["card_losses"], r["cpu_losses"])) \
                    or not row["wire_equal"]:
                raise AssertionError(f"22c: {row}")

            t = time.perf_counter()
            d = ranks.run(("train", ("elastic", dev, smoke, dirs)))
            parts["d"] = time.perf_counter() - t
            want_next = b[0]["metrics"][MESH_CHECK_STEPS]["loss"][1]
            nxt = [row["next_loss"] for r in d for row in r
                   if "next_loss" in row]
            stepped = [x for r in d for x in r if "wire" in x]
            row = {"phase": "mesh_train_elastic", "card": card,
                   "restores": [{k: v for k, v in x.items()
                                 if "wire" not in k} for x in d[0]],
                   "next_loss_on_4x1": nxt,
                   "next_loss_on_2x2": want_next, "tol": MODEL_F32_TOL,
                   "seconds": [[x["seconds"] for x in r] for r in d],
                   **wire_row(stepped)}
            emit(row)
            if not all(x["slices_bit_for_bit"] for r in d for x in r) \
                    or len(nxt) != MESH_RANKS \
                    or not all(close_to(v, want_next) for v in nxt) \
                    or not row["wire_equal"]:
                raise AssertionError(f"22d: {row}")

            t = time.perf_counter()
            e = ranks.run(("train", ("ssm", dev, smoke, dirs)))
            parts["e"] = time.perf_counter() - t
            row = {"phase": "mesh_train_rwkv6", "arch": "rwkv6-1.6b",
                   "card": card, "layers": MESH_SSM["rwkv6-1.6b"],
                   "dtype": "float32", "batch": MESH_SSM_PREFILL[0],
                   "seq": MESH_SSM_PREFILL[1],
                   "one_device_loss": e[0]["one_loss"],
                   "mesh_loss": [r["loss"] for r in e],
                   "step_loss": [r["step_loss"] for r in e],
                   "max_abs_leaf_err": max(r["max_abs_leaf_err"]
                                           for r in e),
                   "leaves": e[0]["leaves"], "tol": MODEL_F32_TOL,
                   "grads_s": [r["grads_s"] for r in e],
                   "step_s": [r["step_s"] for r in e], **wire_row(e)}
            emit(row)
            if not all(r["leaves_within_tol"] for r in e) or not all(
                    close_to(r["loss"], r["one_loss"]) and
                    r["loss"] == e[0]["loss"] and
                    close_to(r["step_loss"], r["loss"]) for r in e) \
                    or not row["wire_equal"]:
                raise AssertionError(f"22e: {row}")
        finally:
            ranks.release()
    emit({"phase": "mesh_train_done", "seconds": time.perf_counter() - t_all,
          "part_seconds": parts})


def mesh_train_full_only(card):
    """22a alone: the four gloo ranks up, 22a run and checked, the ranks
    down (``--dryrun-only``)."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="mesh_train_") as tmp:
        dirs = {"a": str(Path(tmp) / "a"), "b": str(Path(tmp) / "b")}
        ranks = four_ranks("train")
        try:
            mesh_train_full(ranks, card, MODEL_DEV, MESH_SMOKE, dirs)
        finally:
            ranks.release()


def peak_rates(torch) -> dict:
    """The card's achieved peaks: one bf16 (8192, 8192) x (8192, 8192)
    ``torch.matmul`` and one 4 GiB device-to-device copy, each the median
    of DRYRUN_REPS calls timed with CUDA events after a warm-up."""
    n = DRYRUN_MATMUL_N
    a = torch.randn((n, n), device="cuda", dtype=torch.bfloat16)
    b = torch.randn((n, n), device="cuda", dtype=torch.bfloat16)
    mm_ms = cuda_ms(torch, lambda: torch.matmul(a, b), reps=DRYRUN_REPS)
    del a, b
    src = torch.empty(DRYRUN_COPY_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    cp_ms = cuda_ms(torch, lambda: dst.copy_(src), reps=DRYRUN_REPS)
    del src, dst
    torch.cuda.empty_cache()
    return {"matmul_n": n, "matmul_ms": mm_ms,
            "matmul_tflop_per_s": 2 * n ** 3 / (mm_ms / 1e3) / 1e12,
            "copy_bytes": DRYRUN_COPY_BYTES, "copy_ms": cp_ms,
            # a copy reads and writes its bytes once each
            "copy_tb_per_s": 2 * DRYRUN_COPY_BYTES / (cp_ms / 1e3) / 1e12,
            "datasheet_tflop_per_s": 989.0, "datasheet_tb_per_s": 3.35}


def dryrun_phase(torch, card):
    """Phase 23: the dry-run (``launch/dryrun.py``, reckoned on the meta
    device) held to what phases 19a, 20a and 22a measured in this run:
    (a) the roofline of 19a's decode step and 20a's training step beside
    their p50, the roofline fraction and 2·N·D or 6·N·D over the p50 at
    the bf16 peak; (b) op_cost's matmul FLOPs of 20a's step against the
    profiler's in 20a's profiled step, within 2 %; (c) the reckoned
    argument + temp bytes beside the measured peaks of 20a and 22a;
    (d) the reckoned bytes a rank sends a step of 22a, equal to what its
    ranks counted; (e) the card's achieved matmul and copy rates."""
    import dataclasses
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.dist.sharding import MeshLayout
    from repro_torch.launch import dryrun
    t_all = time.perf_counter()
    granite = get_config(MODEL_ARCH)
    cells = {
        "19a": (granite, ShapeConfig("serve", MODEL_CACHE, MODEL_BATCH,
                                     "decode"), None),
        "20a": (dataclasses.replace(get_config(TRAIN_ARCH),
                                    n_layers=TRAIN_DEPTH),
                ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"), None),
        "22a": (mesh_cfg(TRAIN_ARCH, MESH_SMOKE, n_layers=MESH_TRAIN_DEPTH),
                ShapeConfig("mesh_train", MESH_TRAIN_SEQ, MESH_TRAIN_BATCH,
                            "train"),
                MeshLayout.of_rank(("data", "model"), MESH_LAYOUT, 0))}
    rec = {}
    for name, (cfg, shape, mesh) in cells.items():
        t = time.perf_counter()
        rec[name] = dryrun.reckon(cfg, shape, mesh)
        rec[name]["reckon_s"] = time.perf_counter() - t
    # (a) the roofline beside the measured step
    for name in ("19a", "20a"):
        r, m = rec[name], MEASURED[name]
        p50_s = m["p50_ms"] / 1e3
        emit({"phase": "dryrun_roofline", "of": name, "card": card,
              "arch": cells[name][0].name, "layers": cells[name][0].n_layers,
              "shape": dataclasses.asdict(cells[name][1]),
              "roofline": r["roofline"], "dominant": r["dominant"],
              "flops": r["flops_per_device"],
              "dot_flops": r["dot_flops_per_device"],
              "bytes_min": r["bytes_per_device"],
              "bytes_min_by_operator": r["bytes_min_by_operator"],
              "bytes_upper": r["bytes_upper_per_device"],
              "operators": r["operators"],
              "p50_ms": m["p50_ms"],
              "roofline_fraction": max(r["roofline"].values()) / p50_s,
              "model_flops": r["model_flops_global"],
              "model_flops_share_of_bf16_peak":
                  r["model_flops_global"] / (p50_s * dryrun.PEAK_FLOPS),
              "reckon_s": r["reckon_s"]})
    # (b) matmul FLOPs: op_cost on meta against the profiler on the card
    got, want = rec["20a"]["dot_flops_per_device"], MEASURED["20a"][
        "matmul_flops"]
    row = {"phase": "dryrun_matmul_flops", "of": "20a", "card": card,
           "op_cost_dot_flops": got, "profiler_matmul_flops": want,
           "profiler_ops": list(MATMUL_OPS),
           "ratio": got / want if want else None, "tol": 0.02}
    emit(row)
    if not want or abs(got - want) > 0.02 * want:
        raise AssertionError(f"23b: {row}")
    # (c) peak memory: reckoned argument + temp against measured
    for name, peak in (("20a", MEASURED["20a"]["max_memory_allocated"]),
                       ("22a", max(MEASURED["22a"]["peak"]))):
        mem = rec[name]["memory"]
        held = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        emit({"phase": "dryrun_memory", "of": name, "card": card, **mem,
              "argument_plus_temp": held, "max_memory_allocated": peak,
              "ratio": held / peak})
    # (d) the transport's bytes a step of 22a: reckoned against counted
    row = {"phase": "dryrun_transport", "of": "22a", "card": card,
           "reckoned_sent": rec["22a"]["sent_bytes_per_device"],
           "reckoned_received": rec["22a"]["received_bytes_per_device"],
           "counted_sent": MEASURED["22a"]["sent_bytes_per_step"],
           "counted_received": MEASURED["22a"]["received_bytes_per_step"],
           "collective_bytes": rec["22a"]["collective_bytes_per_device"],
           "links": rec["22a"]["links"],
           "roofline": rec["22a"]["roofline"]}
    emit(row)
    if row["reckoned_sent"] != row["counted_sent"] or \
            row["reckoned_received"] != row["counted_received"]:
        raise AssertionError(f"23d: {row}")
    # (e) the card's achieved peaks beside the data sheet's
    emit({"phase": "dryrun_peaks", "card": card, **peak_rates(torch)})
    emit({"phase": "dryrun_done", "seconds": time.perf_counter() - t_all})


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: this script measures the port on a GPU")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        return fail(f"the port is not beside this script ({src}/repro_torch)")
    # the gloo ranks of phases 18-22 start now and join their groups while
    # this process starts and nvcc builds (each start costs 10-15 s); they
    # wait idle until used
    whole_run = not any(a.endswith("-only") for a in sys.argv[1:])
    if whole_run:
        start_pool(wait=False)
        EARLY["dist"] = DistRanks(DIST_RANKS, "gloo", wait=False)
    sys.path.insert(0, str(src))
    from repro_torch import (ExternalPolicy, SortConfig, psort,
                             trace_collectives)
    from repro_torch.data import generate_instance
    from repro_torch.core import local_kernels
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts

    kernels_on = local_kernels()
    if not (kernels_on.sort and kernels_on.partition):
        return fail(f"the kernels are switched off ({kernels_on}): unset "
                    f"REPRO_LOCAL_KERNELS / REPRO_PALLAS_LOCAL_SORT")
    start = clock = time.perf_counter()

    def lap(name):
        """Print the seconds of the phase that just ended."""
        nonlocal clock
        now = time.perf_counter()
        emit({"phase": "seconds", "of": name, "seconds": now - clock})
        clock = now

    # --- 1. the card ---------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "local_kernels": {"sort": kernels_on.sort,
                            "partition": kernels_on.partition}})

    # --- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {k: str(v.relative_to(src.parent))
                      for k, v in _build.SOURCES.items()}})
    log = _build.BUILD_LOG.get("bitonic")        # None: no log kept
    emit({"phase": "ptxas", "source": "bitonic",
          "kernels": None if log is None else ptxas_report(log)})

    if whole_run:                # no phase is timed while ranks start
        t0 = time.perf_counter()
        start_pool().ready()
        EARLY["dist"].ready()
        emit({"phase": "ranks_up", "ranks": [MESH_RANKS, DIST_RANKS],
              "seconds_after_build": time.perf_counter() - t0})
    lap("1-2")
    if "--train-only" in sys.argv[1:]:          # phase 20 alone
        train_phase(torch, np, card)
        lap("20")
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--dryrun-only" in sys.argv[1:]:         # phase 23 and what it reads
        model_serve_phase(torch, np, card)
        train_full_phase(torch, np, card)
        mesh_train_full_only(card)
        lap("19a, 20a, 22a")
        dryrun_phase(torch, card)
        lap("23")
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--mesh-train-only" in sys.argv[1:]:     # phase 22 alone
        mesh_train_phase(torch, np, card)
        lap("22")
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--mesh-only" in sys.argv[1:]:           # phase 21 alone
        mesh_phase(torch, np, card)
        lap("21")
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--model-only" in sys.argv[1:]:          # phase 19 alone
        model_phase(torch, np, card, psort, SortConfig, launch_counts,
                    reset_launch_counts)
        lap("19")
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--dist-only" in sys.argv[1:]:           # phase 18 alone
        dist_launches = dist_phase(torch, np, psort, SortConfig,
                                   generate_instance)
        dist_ams, dist_rows = dist_kernel_rows(torch)
        lap("18")
        emit_kernels(dist_summary_rows(dist_launches, dist_ams, dist_rows))
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    # --- 3. kernels against their plain versions -----------------------------
    kernels = kernel_phases(torch)
    lap("3")
    kway_rows = kway_phase(torch)
    lap("3b")

    # --- 4. psort end to end at p = 256, n = 2^26 ----------------------------
    n = 1 << LOG_N_MAIN
    cfg = SortConfig(p=P_MAIN, algorithm="rams")
    main_launches = rams_uniform_wall = None
    for i, name in enumerate(INSTANCES_MAIN):
        x = generate_instance(name, P_MAIN, n).astype(np.uint32)
        if i == 0:                                   # warm-up
            psort(x, cfg)
            torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, info = psort(x, cfg, return_info=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check_sorted(torch, np, x, out, info, n)
        missing = [k for k in RAMS_LAUNCHES if launches[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the main path: "
                                 f"{missing}")
        if main_launches is None:
            main_launches, rams_uniform_wall = launches, wall
        emit({"phase": "psort", "instance": name, "p": P_MAIN, "n": n,
              "algorithm": info["algorithm"], "wall_s": wall,
              "keys_per_s": n / wall, "max_memory_allocated": peak,
              "balance": info["balance"], "overflow": info["overflow"],
              "launches": launches})
        del out, info, x

    lap("4")

    # --- 5. card vs CPU at p = 64, n = 2^20 ----------------------------------
    n = 1 << LOG_N_CHECK
    x = generate_instance("Uniform", P_CHECK, n).astype(np.uint32)
    cfg = SortConfig(p=P_CHECK, algorithm="rams")
    go, gi = psort(x, cfg, return_info=True, device="cuda")
    co, ci = psort(x, cfg, return_info=True, device="cpu")
    same = (torch.equal(go.view(torch.int32).cpu(), co.view(torch.int32))
            and torch.equal(gi["perm"].cpu(), ci["perm"])
            and torch.equal(gi["counts"].cpu(), ci["counts"])
            and gi["overflow"] == ci["overflow"])
    emit({"phase": "cuda_vs_cpu", "p": P_CHECK, "n": n, "instance": "Uniform",
          "identical": same, "overflow_cuda": gi["overflow"],
          "overflow_cpu": ci["overflow"]})
    if not same:
        raise AssertionError("cuda and cpu runs differ")
    if gi["overflow"] != OVERFLOW_CHECK:
        raise AssertionError(f"overflow {gi['overflow']} != the reference's "
                             f"{OVERFLOW_CHECK}")
    check_sorted(torch, np, x, go, gi, n)

    lap("5")

    # --- 6. psort through the external lane at p = 16, n = 2^27 ------------
    n = 1 << LOG_N_EXT
    cfg = SortConfig(p=P_EXT, external=ExternalPolicy(budget=BUDGET_EXT))
    warm = generate_instance("Uniform", P_EXT, 1 << 22).astype(np.uint32)
    psort(warm, SortConfig(p=P_EXT, external=ExternalPolicy(          # 8 runs
        budget=BUDGET_EXT >> 6)))
    torch.cuda.synchronize()
    del warm
    ext_launches = None
    for name in INSTANCES_EXT:
        x = generate_instance(name, P_EXT, n).astype(np.uint32)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, info = psort(x, cfg, return_info=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        check_external(torch, np, x, out, info, n)
        missing = [k for k in EXTERNAL_KERNELS if launches[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the external "
                                 f"lane: {missing}")
        if ext_launches is None:
            ext_launches = launches
        emit({"phase": "external", "instance": name, "p": P_EXT, "n": n,
              "budget": BUDGET_EXT, "runs": info["external"]["runs"],
              "merge": info["external"]["merge"], "wall_s": wall,
              "keys_per_s": n / wall, "max_memory_allocated": peak,
              "peak_host_rss_bytes": rss,
              "pass_seconds": info["pass_seconds"],
              "balance": info["balance"], "overflow": info["overflow"],
              "counts": info["counts"].tolist(), "launches": launches})
        del out, info, x

    lap("6")

    # --- 7. card vs CPU on the external lane at p = 16, n = 2^20 -----------
    n = 1 << LOG_N_EXT_CHECK
    x = generate_instance("Uniform", P_EXT, n).astype(np.uint32)
    cfg = SortConfig(p=P_EXT, external=ExternalPolicy(
        budget=BUDGET_EXT_CHECK))
    runs = {}
    for label, dev, db in (("cuda", "cuda", True), ("cpu", "cpu", True),
                           ("cuda_single_buffer", "cuda", False)):
        c = cfg.replace(external=ExternalPolicy(budget=BUDGET_EXT_CHECK,
                                                double_buffer=db))
        o, i = psort(x, c, return_info=True, device=dev)
        runs[label] = (o.view(torch.int32).cpu(), i["perm"].cpu(),
                       i["counts"].cpu(), i["overflow"])
    same = {label: all(torch.equal(a, b) if torch.is_tensor(a) else a == b
                       for a, b in zip(runs["cuda"], r))
            for label, r in runs.items() if label != "cuda"}
    emit({"phase": "external_cuda_vs_cpu", "p": P_EXT, "n": n,
          "budget": BUDGET_EXT_CHECK, "instance": "Uniform",
          "identical": same, "overflow": runs["cuda"][3]})
    if not all(same.values()):
        raise AssertionError(f"external runs differ: {same}")
    if not np.array_equal(np.sort(x), runs["cuda"][0].numpy().view(
            np.uint32)):
        raise AssertionError("external output differs from np.sort(input)")

    lap("7")

    # --- 8. RQuick at p = 2^18, n = 2^26 --------------------------------------
    rquick_rows = rquick_kernel_phase(torch)
    rquick_launches = rquick_phase(torch, np, psort, SortConfig,
                                   generate_instance, launch_counts,
                                   reset_launch_counts)
    lap("8")

    # --- 10. the other algorithms at their sizes ----------------------------
    t10 = time.perf_counter()
    other_rows = other_kernel_phase(torch)
    other_launches = other_paths_phase(torch, np, psort, SortConfig,
                                       generate_instance, launch_counts,
                                       reset_launch_counts)
    emit({"phase": "other_done", "seconds": time.perf_counter() - t10})
    lap("10")

    # --- 11. 8-byte keys -----------------------------------------------------
    t11 = time.perf_counter()
    keys64_launches = keys64_phase(torch, np, psort, SortConfig,
                                   generate_instance, launch_counts,
                                   reset_launch_counts)
    emit({"phase": "keys64_done", "seconds": time.perf_counter() - t11})
    lap("11")

    # --- 12. collective traces ----------------------------------------------
    t12 = time.perf_counter()
    trace_phase(torch, SortConfig, ExternalPolicy, trace_collectives)
    emit({"phase": "trace_done", "seconds": time.perf_counter() - t12})
    lap("12")

    # --- 13. selection ---------------------------------------------------------
    selection_phase(torch, np, psort, SortConfig, generate_instance,
                    launch_counts, reset_launch_counts)
    lap("13")

    # --- 14. the streamed exchange ---------------------------------------------
    overlap_launches, chunk_rows = overlap_phase(
        torch, np, psort, SortConfig, ExternalPolicy, generate_instance,
        launch_counts, reset_launch_counts, trace_collectives)
    lap("14")

    # --- 15. batched keys and nested meshes -----------------------------------
    batch_rows, batch_sort_rows = batch_kernel_rows(torch)
    batch_launches = batched_phase(torch, np, psort, SortConfig,
                                   generate_instance, launch_counts,
                                   reset_launch_counts, trace_collectives)
    lap("15")

    # --- 16. query serving ----------------------------------------------------
    serve_rows = ingest_kernel_rows(torch)
    serve_launches = serve_phase(torch, np, generate_instance, launch_counts,
                                 reset_launch_counts, rams_uniform_wall)
    lap("16")

    # --- 17. faults and elastic rescale --------------------------------------
    fault_rows, fault_sort_rows = rams_kernel_rows(
        torch, P_MAIN // 2, P_MAIN // 2, (1 << LOG_N_FAULT) // (P_MAIN // 2),
        "rams-fault", seed=17)
    fault_launches = fault_phase(torch, np, psort, SortConfig,
                                 ExternalPolicy, generate_instance,
                                 launch_counts, reset_launch_counts)
    lap("17")

    # --- 18. the distributed backend ----------------------------------------
    dist_launches = dist_phase(torch, np, psort, SortConfig,
                               generate_instance)
    dist_ams, dist_rows = dist_kernel_rows(torch)
    lap("18")

    # --- 19. the model-serving stack -----------------------------------------
    lbb_launches = model_phase(torch, np, card, psort, SortConfig,
                               launch_counts, reset_launch_counts)
    lap("19")

    # --- 20. the training stack --------------------------------------------
    train_phase(torch, np, card)
    lap("20")

    # --- 21. serving on a mesh -------------------------------------------------
    mesh_phase(torch, np, card)
    lap("21")

    # --- 22. training on a mesh ------------------------------------------------
    mesh_train_phase(torch, np, card)
    lap("22")

    # --- 23. the dry-run against the card ---------------------------------
    dryrun_phase(torch, card)
    lap("23")
    emit({"phase": "seconds", "of": "all",
          "seconds": time.perf_counter() - start})

    # --- 9. summary (printed last) -----------------------------------------
    # a row per kernel (classify: per variant), path and shape: its time at
    # that shape and its launches in that path's measured run
    rows = []
    for key, row in kernels.items():
        rows.append((row, "rams", main_launches[key]))
    for row in kway_rows:
        rows.append((row, "external", ext_launches["kway_classify"]))
    for row in rquick_rows:
        rows.append((row, "rquick", rquick_launches[launch_key(row)]))
    for key, row in kernels.items():          # NTB-AMS: RAMS's shapes
        if row["name"] in RAMS_KERNELS:
            rows.append((row, "ntb-ams", other_launches["ntb-ams"][key]))
    for row, paths in other_rows:
        for path in paths:
            launches = keys64_launches["ssort"] if path == "ssort-int64" \
                else other_launches[path]
            rows.append((row, path, launches[launch_key(row)]))
    # the streamed paths of phase 14: the same kernels at the shapes of
    # their barrier paths, with the streamed sort's launches
    for key, row in kernels.items():
        rows.append((row, "rams-overlap", overlap_launches["rams"][key]))
    for row, paths in other_rows:
        if "ssort" in paths:
            rows.append((row, "ssort-overlap",
                         overlap_launches["ssort"][launch_key(row)]))
    for row in kway_rows:
        rows.append((row, "external-overlap",
                     overlap_launches["external"]["kway_classify"]))
    for row, paths in chunk_rows:
        for path in paths:
            rows.append((row, path, overlap_launches[path.split("-")[0]][
                launch_key(row)]))
    # phase 15: the RAMS kernels at the batched cell's shapes, RQuick's at
    # its cell's (the batched RQuick's rows), RAMS's main-path shapes for
    # the nested meshes; each with that path's launches
    for key, row in batch_rows.items():
        rows.append((row, "rams-batched", batch_launches["rams-batched"][key]))
    for row, paths in batch_sort_rows:
        rows.append((row, "rams-batched",
                     batch_launches["rams-batched"][launch_key(row)]))
    for row in rquick_rows:
        rows.append((row, "rquick-batched",
                     batch_launches["rquick-batched"][launch_key(row)]))
    for key, row in kernels.items():
        if row["name"] in RAMS_KERNELS:
            rows.append((row, "rams-nested",
                         batch_launches["rams-nested"][key]))
    # phase 16: the serving ingest's local sort, with its launches
    for key, row in serve_rows.items():
        rows.append((row, "serve-ingest", serve_launches[key]))
    # phase 17: the RAMS kernels at the rescaled attempt's shapes (p = 128,
    # n = 2^25), with the killed run's launches (both attempts)
    for key, row in fault_rows.items():
        rows.append((row, "rams-fault", fault_launches[key]))
    for row, paths in fault_sort_rows:
        rows.append((row, "rams-fault", fault_launches[launch_key(row)]))
    # phase 18: each kernel at a rank's shapes, with the launches of every
    # distributed path, summed over its ranks
    rows += dist_summary_rows(dist_launches, dist_ams, dist_rows)
    # phase 19: length-balanced batching sorts 2^26 lengths at p = 256 with
    # RAMS, the main path's shapes, with its own launches
    for key, row in kernels.items():
        rows.append((row, "lbb", lbb_launches["rams"][key]))
    emit_kernels(rows)
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def emit_kernels(rows) -> None:
    emit({"kernels": [
        {"name": row["name"], "variant": row["variant"], "path": path,
         "what": row.get("what"),
         "shape": row["shape"], "route": row["route"],
         "source": row["source"], "replaces": row["replaces"],
         "launches": launches, "max_abs_err": row["max_abs_err"],
         "ms": row["ms"], "plain_ms": row["plain_ms"],
         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
         "library_ms": row["library_ms"]} for row, path, launches in rows]})


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        close_pool()
