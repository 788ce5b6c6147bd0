#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``tianshou_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device: the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build: every kernel under ``tianshou_tpu_torch/csrc`` with ``nvcc``;
3. kernels: each kernel against its plain PyTorch version on the card
   (bitwise) at the shapes its paths give it and at edge cases (for
   ``gather_rows_cast``: an unaligned width and base, one row, unequal
   persistent runs, rings past 2^32 bytes; every route the inputs allow),
   then, at each caller's shape, timed L2-cold (8
   index sets in turn, each with its own output) as device ms a launch
   (the profiler's kernel records), host issue us a call and wall ms a
   call: the previous kernel and the new one in turns (old, new, new, old),
   the plain version and the PyTorch library call, beside the least time
   the card could take (its bound); ``dist_atari``'s shape is the
   distributed trainer's per-update presample (512 rows of atari's ring);
4. reference: small slices run on the card and on the CPU from the same
   parameters and env phases (the pixel path, and the pixel path with the
   deduplicated frame-stack buffer): identical actions and replay storage,
   the same bf16 presample (through the kernel on the card), the same
   update losses.  Then, in float32 with TF32 off: 3 SAC and 3 TD3 updates
   from the same parameters, batch and injected noise (losses and
   parameters within rtol 1e-4 / atol 1e-5), a 20-step on-device Pendulum
   segment (storage within atol 1e-5: the card's sin/cos may differ from
   the CPU's in the last bit), and the host path's packed transfer
   (``TreePacker``) bitwise, including three copies queued behind a busy
   stream, which would show a pinned buffer overwritten under a copy.
   Then the on-policy slice, in float32 with TF32 off: GAE on a [256, 8]
   rollout; a PPO rollout processed with ``ret_norm`` (critic values, GAE,
   the running return statistics) and 3 minibatch updates of it with value
   clipping; one TRPO learn (conjugate gradient, line search, 5 critic
   steps); all within rtol 1e-4 / atol 1e-5 of the CPU's.  Then one TRPO
   learn at the ``trpo_pendulum`` widths on observations at Pendulum's own
   scale, unscaled: in float64 the card's within rtol 1e-7 / atol 1e-9 of
   the CPU's, and in float32 the card's and the CPU's actor steps each
   within ``TRPO_FLOAT32_STEP_LIMIT`` (relative) of the CPU's float64 step.
   Then prioritized replay and the distributional family, in float32 with
   TF32 off, within rtol 1e-4 / atol 1e-5 of the CPU (indices exact): the
   sum tree at ``rainbow_per``'s 20,000 slots (update, and the draw's
   ``(env, pos, p)`` on the same ``u``), PER weights in both modes, and one update each of DQN
   on a PER buffer (the tree after the write-back included), C51, Rainbow
   (the same noise), QRDQN, IQN (the same fractions) and FQF (both of its
   parameter sets).  Then the rest of the off-policy families, in float32
   with TF32 off, within rtol 1e-4 / atol 1e-5 of the CPU: one update each
   of REDQ (the critic subset and the normals injected), DiscreteSAC, BDQ
   and DRQN (the same sampled slots of the same ring), and a greedy DRQN
   CartPole segment, one step at a time, whose carries cross episode ends
   (the same actions, the carries reset to zeros at each end).  Then slice
   7, in float32 with TF32 off, within rtol 1e-4 / atol 1e-5 of the CPU,
   from the same parameters, ring, sampled slots and draws: one update each
   of BC, TD3BC, BCQ, CQL (plain, CQL(Lagrange), and CalQL with its
   calibration returns), DiscreteBCQ, DiscreteCQL, DiscreteCRR in each mode
   and ICM around DQN; GAIL's discriminator steps and reward rewrite; one
   PSRL learn with the same Dirichlet draw; ``sample_her`` and one DDPG
   update from a HER presample;
5. paths, each at full width: 1 warm-up and 2 timed supersteps, one more
   superstep in which a host synchronisation raises, one under the profiler
   (device kernels and busy time), where the time of a superstep goes
   (median of 3), then the trainer's ``run()`` for one epoch of two
   supersteps with a test phase, the launch counts read over exactly that
   run.  On the paths whose trainer replays CUDA graphs (``COMPILED_PATHS``)
   1 superstep is timed and the breakdown runs once (the graph phases time
   eager and replayed steps in turns); the profile moves into the
   learn-graph phase on ``LEARN_GRAPH_PATHS`` and is skipped with the
   breakdown on ``GRAPH_COVERED``; ``atari_host`` warms up 1,000 steps
   outside its ``run()`` (``PHASE_SMALL``).  The paths (``PATHS``):
   - ``atari``: SyntheticPixelEnv 84x84x4, NatureCNN in bf16, 128 envs x
     16 steps, batch 512, 26 updates a superstep, 2 ``gather_rows_cast``
     launches each;
   - ``atari_dedup``: the same with 4 frames a stack, channel-first, in a
     ``ReplayBuffer(stack_num=4, save_only_last_obs=True,
     ignore_obs_next=True)`` that stores each frame once; still exactly 2
     launches a superstep (one per stacked key);
   - ``cartpole``: the CartPole headline, QNet (128, 128, 128) in float32,
     1024 envs x 64 steps, batch 1024, 410 updates a superstep;
   - ``minatar``: MinAtar Breakout, the MinAtar CNN in bf16, 256 envs x 32
     steps, batch 512, 102 updates a superstep;
   - ``minatar_space_invaders``, ``minatar_freeway``, ``minatar_asterix``,
     ``minatar_seaquest`` (slice 12): MinAtar's other four games at the
     ``minatar`` path's configuration, the CNN at each game's channel
     count; no kernel (float32 grids);
   - ``sac_pendulum``: the JAX package's SAC threshold configuration on the
     on-device Pendulum: 10 envs x 10 steps, 12 updates of batch 256 a
     superstep, GaussianActor and twin critics (128, 128), automatic alpha,
     a 2000-slot ring per env, 1000 warm-up steps in ``run()``;
   - ``td3_pendulum``: the same with TD3 (DeterministicActor (128, 128),
     exploration noise 0.1, policy noise 0.2, noise clip 0.5, delay 2);
   - ``sac_host``: the host-env path at the widths of the JAX ``bench.py``
     host stage (SAC HalfCheetah): 8 ``HostVectorEnv`` envs x 8 steps, 64
     updates of batch 256 a segment, GaussianActor and twin critics
     (256, 256), fixed alpha, a 5000-slot ring per env, 2000 warm-up steps.
     The envs are a numpy stand-in with HalfCheetah-v4's spaces
     (``HalfCheetahStandIn``: the card's machine has no MuJoCo), whose step
     costs microseconds: host-path times understate the env's share.  Its
     sync guard covers the device part of a segment (unpack,
     ``add_trajectory`` and the updates), in which with the upload PyTorch
     must dispatch exactly one host-to-device copy, the packed segment;
     segments are also timed with ``pipeline_host_updates`` on, in turns
     with it off;
   - ``ppo_cartpole``: the JAX package's PPO CartPole test configuration on
     the on-device CartPole: 16 envs x 128 steps, QNet and ValueNet
     (64, 64), 10 passes of 8 minibatches of 256 (80 updates) a superstep,
     lr 3e-4, GAE 0.95, grad norm 0.5, advantage normalisation;
   - ``trpo_pendulum``: the JAX package's TRPO Pendulum test configuration:
     16 envs x 128 steps, GaussianActor and ValueNet (64, 64), 2 learns of
     batch 2048 a superstep, max KL 0.005, backtracking 0.8, 5 critic steps,
     return and advantage normalisation;
   - ``ppo_host``: the host-env path at the MuJoCo PPO widths
     (``examples/mujoco_ppo.py``): 8 ``NormObsHostVectorEnv`` envs of
     ``HalfCheetahStandIn`` x 256 steps, GaussianActor (sigma_init -0.5)
     and ValueNet (64, 64), 10 passes of 32 minibatches of 64 (320 updates)
     a segment, a linear learning-rate decay, value coefficient 0.25, return
     normalisation and ``recompute_advantage``, 10 test envs.  Its sync
     guard and its one copy are checked as ``sac_host``'s, with the
     learning as the device part;
   - ``rainbow_per``: the JAX package's Rainbow CartPole test configuration
     on a ``PrioritizedReplayBuffer`` (alpha 0.6, beta 0.4): 10 envs x 10
     steps, 10 updates of batch 64, each sampling its own batch from the sum
     tree and writing its cross-entropy back, ``C51Net((128, 128), 51
     atoms, noisy)``, 1000 warm-up steps; its breakdown times the tree's
     descent, the sample with its gathers, one write-back and one PER add
     on their own;
   - ``qrdqn_minatar``: ``examples/dqn_minatar.py --algo qrdqn`` at its
     defaults: MinAtar Breakout, ``ConvQRDQNNet`` (200 quantiles, the MinAtar
     CNN in bf16), 32 envs x 4 steps, 32 presampled updates of batch 64, a
     3125-slot ring per env, 5000 warm-up steps;
   - ``redq_pendulum``: REDQ on the on-device Pendulum at the JAX package's
     REDQ widths (``highlevel/experiment.py``): GaussianActor and a
     10-critic ensemble (256, 256), a target subset of 2, the actor and
     alpha stepped every 20th update, automatic alpha; 10 envs x 10 steps,
     25 presampled updates of batch 256, 1000 warm-up steps;
   - ``discrete_sac_cartpole``: DiscreteSAC on the on-device CartPole at its
     ``highlevel`` defaults: QNet actor and a 2-critic QNetEnsemble
     (128, 128), alpha 0.05 tuned automatically; 10 envs x 10 steps, 10
     presampled updates of batch 64;
   - ``bdq_pendulum``: BDQ on ``ContinuousToDiscrete(Pendulum, 11,
     force_multidiscrete=True)``, ``BranchingQNet((128, 128), 1 branch, 11
     actions)``; 10 envs x 10 steps, 10 presampled updates of batch 128;
   - ``drqn_cartpole``: DRQN on the on-device CartPole, ``RecurrentQNet``
     (hidden 128) with its LSTM carries threaded through the collector,
     histories of 4 rebuilt for each update; 10 envs x 10 steps, 10 updates
     of batch 64, each sampling its own batch (the per-update branch);
   - ``cql_d4rl``: ``examples/offline_d4rl_cql.py`` at its full widths on a
     dataset of ``halfcheetah-medium-v2``'s schema and size (1,000,000
     transitions, obs 17, actions 6, episodes of 1,000 steps) made from a
     seed by running ``HalfCheetahStandIn``'s dynamics in numpy under a
     noisy linear policy, written to ``build/`` as ``.npz`` and loaded by
     ``buffer_from_d4rl`` (no ``h5py``): CQL(Lagrange, threshold 10) over a
     conditioned ``GaussianActor`` and twin critics (256, 256), actor lr
     1e-4, critic lr 3e-4, 10 repeated actions, ``calibrated=False``, 100
     updates of batch 256 a superstep through ``OfflineTrainer``, tested on
     10 host envs of the stand-in, one episode each.  An offline superstep
     collects nothing: its rate is gradient steps/s (and samples/s);
   - ``discrete_cql_cartpole``: DiscreteCQL over ``QRDQNNet((128, 128), 32
     quantiles)``, min_q_weight 10, gamma 0.95, n 3, target every 320, 100
     updates of batch 64 a superstep, from a [10, 2000] ring that one
     epsilon-greedy rollout fills on the on-device CartPole;
   - ``gail_pendulum``: GAIL (PPO over ``GaussianActor`` and ``ValueNet``
     (64, 64), a ``Critic`` (64, 64) discriminator, 2 discriminator steps
     at lr 2.5e-4) on the on-device Pendulum, 16 envs x 128 steps, 10 passes
     of 8 minibatches of 256, against a [10, 2400] expert ring from a
     random rollout on the card;
   - ``icm_cartpole``: ICM (``ICMNet((64,), 32 features)``, lr 1e-3, reward
     scale 0.01) around DQN (``QNet((128, 128))``, gamma 0.95, n 1, target
     every 320) on the on-device CartPole, 10 envs x 10 steps, 10 updates
     of batch 64, each a curiosity step and a DQN step through the
     buffer view (the per-update branch);
   - ``hl_cartpole``: the README's Quick start through the public builder,
     ``DQNExperimentBuilder(TorchEnvFactory("CartPole-v1"))`` with its
     ``SamplingConfig`` (16 envs x 6 steps, 10 updates of batch 64 a
     superstep, a 20,000-slot ring, 10 test envs) and ``DQNParams()``, cut
     to one epoch (105 supersteps), with an in-memory logger (the card's
     machine has no tensorboard) and the watch episodes;
   - ``hl_atari``: the same builder over ``SyntheticPixelEnv(84, 84, 4)`` at
     the ``atari`` path's configuration (128 envs x 16 steps, 26 updates of
     batch 512, capacity 64, 1 test env for 1 episode), one epoch of 4
     supersteps; its kernels a superstep must stay within 13 of ``atari``'s
     in the same call.  Then its train and buffer states are checkpointed
     and restored into a freshly built trainer's states on the card
     (bitwise, no storage shared), a second experiment resumes from the
     logger's counters, and a run of 2 supersteps with ``profile_dir``
     writes a trace whose kernels include ``gather_rows_cast``;
   - ``atari_host``: ``examples/atari_dqn.py --fake-ale`` at its defaults:
     10 ``FakeAtariEnv``\\ s (ALE is not on the card's machine) through
     ``wrap_deepmind`` (the numpy warp) in ``HostVectorEnv``, frame stacks
     of 4 into a ``ReplayBuffer(10,000 a env, stack_num=4,
     save_only_last_obs, ignore_obs_next)`` of 100,000 frames, NatureCNN in
     bf16, 10 steps a env and 10 updates of batch 32 a segment, epsilon 1.0
     -> 0.05, 5,000 warm-up steps, 10 test envs: ``gather_rows_cast`` at
     that ring, 2 launches a segment;
   - ``cpp_cartpole``: ``examples/cpp_pool_dqn.py``: the native pool
     (``CppVectorEnv("CartPole-v1", 16)``, compiled with ``g++`` into
     ``build/``), QNet (128, 128, 128), 10 steps a env and 16 updates of
     batch 64, 1,000 warm-up steps; then the pool's raw step rate on
     CartPole-v1 and Reacher2 (16 envs x 2,000 steps);
   - ``sac_fine``: ``examples/mujoco_sac.py`` at its defaults, 8 envs of
     ``HalfCheetahStandIn`` one step each and 8 updates of batch 256 a
     cycle, SAC (256, 256) with alpha 0.2, a 1,000,000-transition ring,
     10,000 warm-up steps: the fused fine cycle, whose device part runs
     under the sync guard and whose whole cycle makes one host
     synchronisation (the action fetch), timed in turns with the segment
     path (``fused_fine_host=False``);
   - ``marl_tictactoe``: ``tests/test_marl.py``'s self-play: two DQN agents
     (QNet (128, 128), gamma 0.95, n 2, target every 320) under
     ``MultiAgentPolicyManager`` on 16 on-device ``TicTacToe`` envs, 10
     steps a env and 16 updates of batch 128 (each agent samples its own),
     epsilon 0.2, 2,000 warm-up steps.
   On each path whose superstep ``OffPolicyTrainer.run()`` launches as CUDA
   graphs (``GRAPH_PATHS``, slice 14: the on-device off-policy paths) the
   graph phase follows (``phase_graph``): ``_compile_superstep``'s first
   calls from the path's initial state, each branch pattern's first call an
   eager superstep (the capture's warm-up) and then its capture (their
   times, the graphs: TD3's one, REDQ's four, the peak memory); from copies
   of the state they leave, two eager supersteps (``_build_superstep``,
   optimizers made capturable as the graph's are) against two replays,
   bitwise in every carried tensor, the generators' states, ``outputs`` and
   ``metrics``, the second replay's draws not the first's; ms a superstep
   in turns (eager, graph, graph, eager); one replay profiled (kernels,
   busy time, the host's launch calls: one graph launch and a few fills a
   replay; ``gather_rows_cast``'s device launches
   in the replay); one replay under the sync guard; peak memory a replay;
   the bytes of carried state copied back a superstep, the ring's storage
   unmoved.  In the main run every superstep must be a pattern's warm-up or
   a replay, and at least one a replay; the kernel's launches there are
   the wrapper's count (the launches from the host: the warm-ups') and the
   profiler's device records over the run (every superstep's).  The
   prioritized paths' (``rainbow_per``, ``dist_rainbow_per``) sum-tree
   kernels are held the same way: per superstep one ``segtree_draw_kernel``
   an update and one ``segtree_update_kernel`` a write-back and a rollout
   step, and one ``segtree_update_kernel`` a step of the warm-up's ring
   fill (``_check_segtree_run``).  On
   ``hl_atari`` the trained state also goes through a checkpoint, and a
   superstep compiled over the restored state replays bitwise equal to
   eager supersteps from it.  On the paths whose superstep another path
   already covers (``GRAPH_COVERED``: the four other MinAtar games, the
   builders' ``hl_cartpole`` and ``hl_atari``) the graph phase keeps every
   check and drops the turns and the two profiles.
   On the paths whose other learn steps the trainers launch as CUDA graphs
   (``LEARN_GRAPH_PATHS``, slice 15: the offline superstep of ``cql_d4rl``
   and ``discrete_cql_cartpole``, the on-policy superstep of
   ``ppo_cartpole``, ``trpo_pendulum`` and ``gail_pendulum``, the on-policy
   host learning of ``ppo_host`` and the off-policy host step of
   ``sac_host``, ``atari_host`` and ``cpp_cartpole``) the learn-graph phase
   follows (``phase_learn_graph``): an eager step's peak memory, the
   compiled step's warm-up and capture (times, peak at most 1.2x the eager
   step's), two replays against two eager steps from copies of the state on
   the same inputs, bitwise; ms a step in turns (the host paths' upload and
   device part of one segment); one eager step and one replay profiled
   (kernels, busy time, host launch calls: one graph launch and a handful of
   fills and copies a replay); a replay under the sync guard; peak memory a
   replay; the bytes copied back; the ring's or dataset's storage unmoved;
   ``ppo_host``'s scheduled learning rate advancing as the schedule says;
   ``atari_host``'s ``gather_rows_cast`` twice in a profiled replay and never
   from the host there.  Their main runs, like the graph paths', must be a
   warm-up and replays.
   Then slice 16's collect-graph phase (``phase_collect_graph``): the
   compiled collection against its eager form (``compile_step`` made the
   step itself, ``_eager_collection``): the host collectors' acting step
   over whole host segments of ``sac_host`` (also pipelined, on a side
   stream through a snapshot module), ``ppo_host``, ``atari_host`` and
   ``cpp_cartpole`` (two eager and two graph segments from one state and
   generator, bitwise in every trajectory leaf, the next observations and
   the generator; a later segment leaves an earlier trajectory unchanged
   and shares no storage with it; ms a segment and of the acting steps
   alone in turns; a profiled segment's host launch calls, about 5 a step;
   the peak memory of the first graph segment, its warm-up and capture,
   at most 1.2x an eager segment's), ``AsyncHostCollector`` at ``wait_num``
   4 of 8 (segments in turns; the acting step on the rounds' recorded
   observations and a DRQN carry advanced for masked rows, bitwise), the
   fused fine cycle of ``sac_fine`` (two replays against two eager cycles
   bitwise, in turns, a replay profiled, the peak) and a 10-episode test
   phase on ``cartpole``, ``atari`` and ``hl_cartpole`` (two phases against
   two eager ones, bitwise in returns, lengths and both streams, the second
   phase's re-seeded registered generator honoured by the replays; in
   turns; a chunk profiled; the peak).  Every main ``run()`` also counts
   its collection's compiled steps, each call a capture's warm-up or a
   replay, with replays on the host paths.
   Last, ``sac_host``'s configuration through the host path's variants, in
   turns with plain ``sac_host``: a ``RemoteVectorEnv`` over an env farm
   subprocess on 127.0.0.1 (killed at the end), ``AsyncHostCollector``
   with ``wait_num`` 4 of 8, and ``act_on_host=True``; ms a segment and the
   copies the card ran each way.
6. the distributed trainers (slice 11) on a world-1 NCCL group, each at its
   plain path's configuration (``DIST_PATHS``: ``dist_atari`` is
   ``DistributedOffPolicyTrainer`` at ``atari``'s, each of its 26 updates
   presampling its own 512 rows, 52 ``gather_rows_cast`` launches a
   segment; ``dist_rainbow_per`` the same trainer on ``rainbow_per``'s
   prioritized ring; ``dist_ppo_cartpole`` ``DistributedOnPolicyTrainer`` at
   ``ppo_cartpole``'s), each compiled since slice 17 (``phase_dist_graph``:
   ``_compile_superstep``, CUDA graphs of the eager segment with the NCCL
   collectives as nodes): an eager segment's peak memory, the compiled
   segment's warm-up and capture (the peak with the static state at most
   1.2x the eager one's), two replays against two eager segments from
   copies of the state, bitwise (``dist_rainbow_per`` within phase 4's
   limits where ``C51._project``'s ``scatter_add_`` forbids it), the
   collectives each capture counted (every one on the capturing stream)
   against the eager segment's ``all_reduce`` calls and bytes, ms a segment
   in turns (eager, graph, the plain trainer's graph, and back), an eager
   segment and a replay profiled (kernels, busy time, NCCL kernels, host
   launch calls), a replay under the sync guard; then the per-update
   presample and gradient all-reduce alone, and ``run()`` for one epoch of
   two segments, each a warm-up or a replay, the kernel's launches read
   over exactly that run (52 from the host in ``dist_atari``'s warm-up, 104
   on the card); ``dist_atari`` also holds one distributed update against
   the plain one on the same batch.  Then ``make_distributed_update``
   (``DIST_UPDATE``: cartpole's widths, one-step targets, batch 1024):
   two replays against eager updates bitwise, the capture's collectives
   against the eager update's, and the plain ``update_sampled`` within
   rtol 1e-4 / atol 1e-5.  Last, two gloo ranks share the card (this script
   again, with ``--gloo-rank``, as two subprocesses on CUDA tensors): DQN
   on the on-device CartPole through ``DistributedOffPolicyTrainer``, their
   parameters bitwise equal after the run and the losses they read equal,
   the segment eager (gloo's collectives run on the host, which a stream
   capture cannot record).  Between the two, ``redq_ep`` (slice 12,
   ``REDQ_EP``): REDQ at ``redq_pendulum``'s configuration with its 10
   critics sharded over the ``"ep"`` axis of a ``make_mesh2`` mesh.  At
   world size 1 on the NCCL group (``dp 1 x ep 1``) one sharded update
   equals the plain one bitwise, and the trainer's segment replays a graph
   per pattern of the actor delay, held as the distributed paths' are
   (the ensembles' gathers and their backward all-reduce among the
   counted collectives), and its ``run()`` for ``REDQ_EP_GRAPH_SEGMENTS``
   segments is warm-ups and replays; then two gloo ranks share the card (``--redq-ep-rank``
   subprocesses, ``dp 1 x ep 2``, 5 critics each): REDQ's first update
   (its critics' step) sharded against the one-process update from the
   same parameters, batch and draws (losses rtol 1e-5, gathered parameters
   rtol 2e-5 / atol 1e-6, float32, TF32 off; an update that steps the
   actor too is measured beside it), ms a segment of ``DistributedOffPolicyTrainer`` in
   turns with the plain ``redq_pendulum`` superstep (plain, ep, ep, plain,
   one segment a turn; the plain one on rank 0 alone), the all-reduces and
   ensemble gathers of a segment with their bytes, rank 0's kernels a
   segment, and ``run()`` for 3 segments after the warm-up (the segment
   eager over gloo), after which the ranks' parameters (replicated, and the
   critics gathered) are bitwise equal;
7. ``Batch`` on the card: ``cat``, ``stack``, ``split``, index reads and
   slice assignment on CUDA tensors equal the same calls on the CPU;
8. examples (slice 13): the example scripts of ``tianshou_tpu_torch/examples/``
   that the card's machine can run, each through its ``main()`` (``atari_dqn``
   through ``build()``, to keep its ring) with the in-memory logger, at its
   defaults cut only in run length (``EXAMPLE_RUNS``): ``atari_dqn
   --fake-ale`` (``gather_rows_cast`` twice a training segment; a presample
   of the trained ring through the kernel bitwise against the plain
   version), ``dqn_cartpole`` and ``highlevel_dqn`` to their own stop (195
   within their 10 epochs), ``dqn_minatar`` on the five games and with
   ``--algo qrdqn``, ``sac_pendulum`` and ``ppo_classic`` with each
   algorithm, ``cpp_pool_dqn`` and ``offline_d4rl_cql`` on a Pendulum
   dataset written by ``make_d4rl_demo``; a line for each run (flags, wall
   time, rate, best reward, launches, cuts) and one naming the gymnasium
   scripts the card's machine cannot run.

Each phase prints its seconds (``phase_s``) as it ends, and the script its
own total before the JSON lines.  It then prints a ``paths`` JSON line, the
``kernels`` JSON line and, last, the ``ok`` JSON line.  Without CUDA, or without the package beside it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import select
import shutil
import socket
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

H100_BYTES_PER_S = 3.35e12  # HBM3 of an H100 SXM
H100_FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores

# per path: envs, steps a segment, batch, updates a superstep, ring capacity
PATHS = {
    "atari": dict(num_envs=128, segment=16, batch=512, updates=26, capacity=64),
    "atari_dedup": dict(num_envs=128, segment=16, batch=512, updates=26, capacity=64),
    "cartpole": dict(num_envs=1024, segment=64, batch=1024, updates=410, capacity=64),
    "minatar": dict(num_envs=256, segment=32, batch=512, updates=102, capacity=64),
    # slice 12: MinAtar's other four games at the minatar path's configuration
    "minatar_space_invaders": dict(num_envs=256, segment=32, batch=512, updates=102, capacity=64),
    "minatar_freeway": dict(num_envs=256, segment=32, batch=512, updates=102, capacity=64),
    "minatar_asterix": dict(num_envs=256, segment=32, batch=512, updates=102, capacity=64),
    "minatar_seaquest": dict(num_envs=256, segment=32, batch=512, updates=102, capacity=64),
    "sac_pendulum": dict(num_envs=10, segment=10, batch=256, updates=12, capacity=2000, warmup=1000,
                         update_per_step=0.125),
    "td3_pendulum": dict(num_envs=10, segment=10, batch=256, updates=12, capacity=2000, warmup=1000,
                         update_per_step=0.125),
    "sac_host": dict(num_envs=8, segment=8, batch=256, updates=64, capacity=5000, warmup=2000),
    # on-policy: envs, steps a segment, minibatch, passes over the rollout,
    # minibatch updates (learn calls) a superstep, test envs and episodes
    "ppo_cartpole": dict(num_envs=16, segment=128, batch=256, repeat=10, updates=80, test_envs=16, episodes=10),
    "trpo_pendulum": dict(num_envs=16, segment=128, batch=2048, repeat=2, updates=2, test_envs=16, episodes=10),
    "ppo_host": dict(num_envs=8, segment=256, batch=64, repeat=10, updates=320, test_envs=10, episodes=10),
    # the distributional family: Rainbow on a prioritized ring (each update
    # samples its own batch), QRDQN at MinAtar conv width (presampled)
    "rainbow_per": dict(num_envs=10, segment=10, batch=64, updates=10, capacity=2000, warmup=1000,
                        update_per_step=0.1),
    "qrdqn_minatar": dict(num_envs=32, segment=4, batch=64, updates=32, capacity=100_000 // 32, warmup=5000,
                          update_per_step=0.25),
    # the rest of the off-policy families
    # run() for 5 supersteps: its actor delay cycles through 4 branch
    # patterns, each first met by a capture's eager warm-up, so the fifth
    # is the first replay
    "redq_pendulum": dict(num_envs=10, segment=10, batch=256, updates=25, capacity=2000, warmup=1000,
                          update_per_step=0.25, main_supersteps=5),
    "discrete_sac_cartpole": dict(num_envs=10, segment=10, batch=64, updates=10, capacity=2000, warmup=1000,
                                  update_per_step=0.1),
    "bdq_pendulum": dict(num_envs=10, segment=10, batch=128, updates=10, capacity=2000, warmup=1000,
                         update_per_step=0.1),
    "drqn_cartpole": dict(num_envs=10, segment=10, batch=64, updates=10, capacity=2000, warmup=1000,
                          update_per_step=0.1),
    # slice 7.  The offline paths collect nothing: updates and batch a
    # superstep, the dataset (cql_d4rl: transitions in episodes of 1000
    # steps; discrete_cql_cartpole: a [num_envs, capacity] ring), test envs
    # and episodes
    "cql_d4rl": dict(batch=256, updates=100, transitions=1_000_000, episode_len=1000, test_envs=10, episodes=10),
    "discrete_cql_cartpole": dict(num_envs=10, capacity=2000, batch=64, updates=100, test_envs=10, episodes=10),
    "gail_pendulum": dict(num_envs=16, segment=128, batch=256, repeat=10, updates=80, test_envs=16, episodes=10,
                          expert_envs=10, expert_capacity=2400),
    "icm_cartpole": dict(num_envs=10, segment=10, batch=64, updates=10, capacity=2000, warmup=1000,
                         update_per_step=0.1),
    # slice 8: the public builders.  hl_cartpole is the README's Quick start
    # (its SamplingConfig and DQNParams() at their defaults: 16 train envs,
    # 100 steps a collect, 10 test envs, ring 20,000, batch 64); hl_atari
    # the same builder at the atari path's configuration.  supersteps: of
    # the main path's run (one epoch)
    "hl_cartpole": dict(num_envs=16, segment=6, batch=64, updates=10, capacity=1250, test_envs=10, episodes=10,
                        supersteps=105),
    "hl_atari": dict(num_envs=128, segment=16, batch=512, updates=26, capacity=64, test_envs=1, episodes=1,
                     supersteps=4),
    # slice 9: the host env layer.  atari_host is examples/atari_dqn.py
    # --fake-ale at its defaults (a ring of 100,000 frames over 10 envs,
    # 10 steps a env and 10 updates of batch 32 a segment, epsilon 1.0 ->
    # 0.05 over 1,000,000 steps, 0.005 in tests); cpp_cartpole
    # examples/cpp_pool_dqn.py; sac_fine examples/mujoco_sac.py (one step a
    # env and 8 updates a cycle: the fused fine cycle); marl_tictactoe
    # tests/test_marl.py's self-play
    "atari_host": dict(num_envs=10, segment=10, batch=32, updates=10, capacity=10_000, warmup=5000, test_envs=10,
                       episodes=10, eps_decay=(1.0, 0.05, 1_000_000), eps_test=0.005),
    "cpp_cartpole": dict(num_envs=16, segment=10, batch=64, updates=16, capacity=2000, warmup=1000, test_envs=16,
                         episodes=10, eps=0.1),
    "sac_fine": dict(num_envs=8, segment=1, batch=256, updates=8, capacity=1_000_000 // 8, warmup=10_000,
                     test_envs=10, episodes=10),
    "marl_tictactoe": dict(num_envs=16, segment=10, batch=128, updates=16, capacity=2000, warmup=2000, eps=0.2),
}
HIGHLEVEL_PATHS = ("hl_cartpole", "hl_atari")
# the MinAtar paths' games
MINATAR_GAMES = {"minatar": "breakout", "minatar_space_invaders": "space_invaders", "minatar_freeway": "freeway",
                 "minatar_asterix": "asterix", "minatar_seaquest": "seaquest"}
DQN_PATHS = HIGHLEVEL_PATHS + tuple(MINATAR_GAMES) + (
    "atari", "atari_dedup", "cartpole", "rainbow_per", "qrdqn_minatar", "bdq_pendulum", "drqn_cartpole",
    "atari_host", "cpp_cartpole")
PER_PATHS = ("rainbow_per",)
HOST_PATHS = ("sac_host", "ppo_host", "atari_host", "cpp_cartpole")
FUSED_PATHS = ("sac_fine",)
ONPOLICY_PATHS = ("ppo_cartpole", "trpo_pendulum", "ppo_host", "gail_pendulum")
OFFLINE_PATHS = ("cql_d4rl", "discrete_cql_cartpole")
# the paths whose exploration is epsilon-greedy at 0.1
EPSILON_PATHS = DQN_PATHS + ("icm_cartpole",)
SLICE7_FAMILY = {"cql_d4rl": "cql", "discrete_cql_cartpole": "discrete_cql", "gail_pendulum": "gail",
                 "icm_cartpole": "icm", "marl_tictactoe": "marl"}
# the metrics each family's superstep (segment) and run() must report, finite
FAMILY_METRICS = {"dqn": ("loss",), "continuous": ("critic_loss", "actor_loss"),
                  "ppo": ("loss", "policy_loss", "value_loss"), "trpo": ("value_loss", "accepted", "kl"),
                  "redq": ("critic_loss", "alpha"),
                  "cql": ("critic_loss", "td_loss", "cql_penalty", "actor_loss", "alpha", "cql_alpha"),
                  "discrete_cql": ("loss", "qr_loss", "cql_loss"),
                  "gail": ("loss", "policy_loss", "value_loss", "disc_loss", "acc_pi", "acc_exp"),
                  "icm": ("loss", "icm_loss", "icm_forward", "icm_inverse"),
                  "marl": ("agent0/loss", "agent1/loss")}
# launches of gather_rows_cast a superstep: obs and obs_next of the presample;
# the on-policy paths use no replay buffer
KERNEL_LAUNCHES = {"atari": 2, "atari_dedup": 2, "cartpole": 0, "minatar": 0, "minatar_space_invaders": 0,
                   "minatar_freeway": 0, "minatar_asterix": 0, "minatar_seaquest": 0, "sac_pendulum": 0,
                   "td3_pendulum": 0, "sac_host": 0, "ppo_cartpole": 0, "trpo_pendulum": 0, "ppo_host": 0,
                   "rainbow_per": 0, "qrdqn_minatar": 0, "redq_pendulum": 0, "discrete_sac_cartpole": 0,
                   "bdq_pendulum": 0, "drqn_cartpole": 0, "cql_d4rl": 0, "discrete_cql_cartpole": 0,
                   "gail_pendulum": 0, "icm_cartpole": 0, "hl_cartpole": 0, "hl_atari": 2, "atari_host": 2,
                   "cpp_cartpole": 0, "sac_fine": 0, "marl_tictactoe": 0}
# slice 11: the distributed trainers, each at its plain path's configuration
# (PATHS) on a world-1 NCCL group (the card's machine has one GPU), in turns
# with the plain trainer
DIST_PATHS = {"dist_atari": "atari", "dist_rainbow_per": "rainbow_per", "dist_ppo_cartpole": "ppo_cartpole"}
# launches of gather_rows_cast a segment of the distributed trainer: each of
# atari's 26 updates presamples its own 512 rows (obs and obs_next), as the
# JAX distributed trainer does
DIST_KERNEL_LAUNCHES = {"dist_atari": 52, "dist_rainbow_per": 0, "dist_ppo_cartpole": 0, "redq_ep": 0}
# slice 17: the one distributed path whose replays may differ from eager
# segments (held to phase 4's limits), and the operation that forbids bitwise
DIST_NOT_BITWISE = {"dist_rainbow_per": "C51._project's Tensor.scatter_add_, not deterministic on the card"}
# slice 17: make_distributed_update on the world-1 NCCL group at cartpole's
# widths, one-step targets: a batch of 1024 rows, 3 staged calls (the
# capture's warm-up and two replays)
DIST_UPDATE = dict(batch=1024, updates=3)
# the compiled segments' launches are read where the supersteps' are
# (_counted_run, _run_launches)
KERNEL_LAUNCHES.update(DIST_KERNEL_LAUNCHES)
# two gloo ranks on the one card: DQN on the on-device CartPole at
# tests/_dist_trainer_worker.py's widths (QNet (64, 64), n 3, 8 envs a rank,
# batch 64 global), 3 segments of 10 steps a env after 1,000 warm-up steps
GLOO_RANKS = dict(num_envs=8, segment=10, batch=64, update_per_step=0.1, capacity=1000, warmup=1000, segments=3)
GLOO_RANK_TIMEOUT = 300
# slice 12: redq_pendulum's configuration (PATHS) on DistributedOffPolicyTrainer
# over a dp 1 x ep 2 mesh, two gloo ranks sharing the card, 5 critics each:
# one sharded update held against the one-process update (the JAX test's
# limits), then run() for 3 segments after the path's warm-up
REDQ_EP = dict(base="redq_pendulum", ranks=2, ep=2, segments=3, loss_rtol=1e-5, param_rtol=2e-5, param_atol=1e-6)
# slice 17: redq_ep at dp 1 x ep 1 on the NCCL group, compiled: run() for 5
# segments, the first meeting of each of the actor delay's 4 branch
# patterns a capture's warm-up, the fifth a replay (redq_pendulum's
# main_supersteps)
REDQ_EP_GRAPH_SEGMENTS = 5
# slice 14: the paths whose superstep OffPolicyTrainer.run() launches as CUDA
# graphs (_compile_superstep), each held bitwise against the eager superstep
# (phase_graph), and the supersteps of each turn of its timing
GRAPH_PATHS = ("atari", "atari_dedup", "hl_atari", "cartpole", "hl_cartpole", *MINATAR_GAMES, "qrdqn_minatar",
               "sac_pendulum", "td3_pendulum", "redq_pendulum", "rainbow_per", "discrete_sac_cartpole",
               "bdq_pendulum", "drqn_cartpole", "icm_cartpole", "marl_tictactoe")
GRAPH_TURN = 1
# the GRAPH_PATHS whose superstep another path of the list already runs (the
# four other MinAtar games beside minatar, the builders' paths beside
# cartpole and atari): their graph phase keeps the bitwise replays, the
# warm-up, the peaks and the copy-back, and drops the turns and the profiles
GRAPH_COVERED = ("minatar_space_invaders", "minatar_freeway", "minatar_asterix", "minatar_seaquest", "hl_cartpole",
                 "hl_atari")
# slice 15: the paths whose other learn steps the trainers launch as CUDA
# graphs (phase_learn_graph): the offline superstep
# (OfflineTrainer._compile_superstep), the on-policy superstep
# (OnPolicyTrainer._compile_superstep), the on-policy host learn
# (_compile_learn) and the off-policy host step (_compile_host_step)
LEARN_GRAPH_PATHS = ("cql_d4rl", "discrete_cql_cartpole", "ppo_cartpole", "trpo_pendulum", "gail_pendulum",
                     "ppo_host", "sac_host", "atari_host", "cpp_cartpole")
# slice 17: the distributed trainers' segments on the world-1 NCCL group
# (phase_dist_graph), redq_ep's at dp 1 x ep 1
COMPILED_PATHS = GRAPH_PATHS + LEARN_GRAPH_PATHS + tuple(DIST_KERNEL_LAUNCHES)
# a replayed learn step's host launch calls at most: the graph launch, the
# fills of explore_param and the generators' offsets, and on the host paths
# the segment's packed copy into the staging and the copies of its tensor
# leaves
LEARN_REPLAY_HOST_LAUNCHES = 12
# short spin kernels that open a profiled window after the long one (see
# _device_records)
PROFILE_PADDING = 64
# timed supersteps (segments) of every path, after WARMUP untimed ones; cut
# from 5 to 3 so that twenty paths ran in about the time sixteen took, and to
# 2 so that the graph phase fits in the script's time
TIMED, WARMUP = 2, 1
# on the paths whose trainer replays CUDA graphs (COMPILED_PATHS) phase 5
# times one eager superstep (the graph phase times eager and replayed ones in
# turns) and runs its breakdown once, so that slice 15's learn-graph phase
# fits in the script's time; its profile of the eager superstep as built
# stays on GRAPH_PATHS, and moves into the learn-graph phase (optimizers
# capturable) on LEARN_GRAPH_PATHS
TIMED_COMPILED, BREAKDOWN_REPS, BREAKDOWN_REPS_COMPILED = 1, 3, 1
# atari_host's warm-up in phase 5 and its learn-graph phase, cut from its
# 5,000 steps (the path's run() keeps them) to spare twice 4,000 steps of the
# DeepMind chain on the host: a segment's time does not depend on the fill
PHASE_SMALL = {"atari_host": dict(warmup=1000)}
# the MuJoCo PPO example's learning-rate decay runs to zero over every
# minibatch update of its default run: 100 epochs x 5 segments x 10 passes x
# 32 minibatches (examples/mujoco_ppo.py)
PPO_HOST_DECAY_UPDATES = 100 * 5 * 10 * 32
# trpo_pendulum's TRPO settings (tests/test_algos_e2e.py:176-194)
TRPO_PENDULUM = dict(critic_lr=1e-3, gamma=0.95, gae_lambda=0.95, optim_critic_iters=5, max_kl=0.005,
                     backtrack_coeff=0.8)
# how far a float32 TRPO step at Pendulum's scale may sit from the float64
# step, relative to its length: 10 conjugate-gradient iterations amplify
# float32 rounding by the Fisher matrix's condition number.  About 5x the
# larger of the readings on an H100 (the card 1.09e-3, the CPU 1.48e-4;
# PERF.md)
TRPO_FLOAT32_STEP_LIMIT = 5e-3


def family(path: str) -> str:
    if path in SLICE7_FAMILY:
        return SLICE7_FAMILY[path]
    if path in DQN_PATHS:
        return "dqn"
    if path in ONPOLICY_PATHS or path == "redq_pendulum":
        return path.split("_")[0]
    return "continuous"


def log(msg: str) -> None:
    print(msg, flush=True)


class HalfCheetahStandIn:
    """A numpy env with HalfCheetah-v4's spaces, for the host path on a
    machine without MuJoCo: float64 observations in ``Box(-inf, inf,
    (17,))``, actions in ``Box(-1, 1, (6,))``, never terminated, truncated
    at 1000 steps.  ``reset(seed)`` draws its dynamics (a tanh of a random
    linear map plus noise) and its reward weights; the reward is a
    projection of the state minus HalfCheetah's control cost ``0.1 *
    |a|^2``.  A step costs microseconds, far less than MuJoCo's."""

    OBS_DIM, ACT_DIM, MAX_STEPS = 17, 6, 1000

    def __init__(self):
        from tianshou_tpu_torch.envs.spaces import Box

        self.observation_space = Box(low=-math.inf, high=math.inf, shape=(self.OBS_DIM,))
        self.action_space = Box(low=-1.0, high=1.0, shape=(self.ACT_DIM,))
        self._draw(None)

    def _draw(self, seed):
        self._rng = np.random.default_rng(seed)
        n, m = self.OBS_DIM, self.ACT_DIM
        self._a = self._rng.normal(0.0, 0.9 / math.sqrt(n), (n, n))
        self._b = self._rng.normal(0.0, 0.5 / math.sqrt(m), (n, m))
        self._w = self._rng.normal(0.0, 1.0 / math.sqrt(n), n)

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._draw(seed)
        self._t = 0
        self._x = self._rng.normal(0.0, 0.1, self.OBS_DIM)
        return self._x.copy(), {}

    def step(self, action):
        a = np.clip(np.asarray(action, np.float64), -1.0, 1.0)
        self._x = np.tanh(self._a @ self._x + self._b @ a) + self._rng.normal(0.0, 0.01, self.OBS_DIM)
        self._t += 1
        reward = float(self._w @ self._x) - 0.1 * float(a @ a)
        return self._x.copy(), reward, False, self._t >= self.MAX_STEPS, {}

    def close(self):
        pass


def _device_ms(fn, calls: int) -> float:
    """Device milliseconds of one call of ``fn``: under ``torch.profiler``,
    the mean duration of each kernel that ``calls`` calls ran, summed over
    the kernels' names (a call of ``index_select().to()`` runs two).  A mean
    by name is not biased by the records the profiler drops at a window's
    start."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, list[int]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and "Memcpy" not in e.name() and "Memset" not in e.name():
            by_name.setdefault(e.name(), []).append(e.end_ns() - e.start_ns())
    if not by_name:
        raise AssertionError("the profiler recorded no kernel")
    return sum(sum(d) / len(d) for d in by_name.values()) / 1e6


def _host_issue_us(fn, calls: int) -> float:
    """Host microseconds to issue one call of ``fn``: a host clock around
    ``calls`` calls with no synchronisation between them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _wall_ms(fn, calls: int) -> float:
    """Milliseconds a call of ``fn`` over ``calls`` calls issued back to back,
    by CUDA events around them: the card's time where a call outlasts its
    issue, the host's issue time where it does not."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _timings(fn, calls: int, warmup: int = 3) -> dict[str, float]:
    for _ in range(warmup):
        fn()
    return {"device_ms": _device_ms(fn, calls), "host_issue_us": _host_issue_us(fn, calls),
            "wall_ms": _wall_ms(fn, calls)}


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    nccl = ".".join(map(str, torch.cuda.nccl.version())) if torch.distributed.is_nccl_available() else "none"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} nccl {nccl} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from tianshou_tpu_torch.ops import _build

    secs = _build.build()
    log(f"build: {_build.kernel_names()} in {secs:.2f} s into {_build.BUILD_DIR}")


# phase 3's timings rotate among this many index sets, each with its own
# output, so that a launch finds its rows and its output cold in the 50 MB L2
# at every caller shape, as a caller with a ring larger than L2 finds them
GATHER_SETS, GATHER_CALLS = 8, 24
# the paths whose presample calls gather_rows_cast, one caller shape each
GATHER_CALLERS = ("atari", "hl_atari", "atari_dedup", "atari_host", "dist_atari")


def _gather_storage(gen, rows: int, feat: int, offset: int = 0) -> torch.Tensor:
    flat = torch.randint(0, 256, (rows * feat + offset,), generator=gen, device="cuda", dtype=torch.uint8)
    return flat[offset:].view(rows, feat)


def _random_idx(gen, rows: int, batch: int) -> torch.Tensor:
    return torch.randint(0, rows, (batch,), generator=gen, device="cuda")


def _stacked_idx(gen, num_envs: int, capacity: int, batch: int, stack: int) -> torch.Tensor:
    """Rows of ``batch`` frame stacks: each a chain of ``stack`` consecutive
    slots of one env's ring, flattened oldest first."""
    env = torch.randint(0, num_envs, (batch, 1), generator=gen, device="cuda")
    pos = torch.randint(0, capacity, (batch, 1), generator=gen, device="cuda")
    chain = torch.remainder(pos - torch.arange(stack - 1, -1, -1, device="cuda"), capacity)
    return (env * capacity + chain).reshape(-1)


def _caller_inputs(path: str, gen, sets: int) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The ring and ``sets`` presamples' indices of ``path``'s caller: the
    stored ``[84, 84, 4]`` stacks of ``atari`` and ``hl_atari`` (random
    rows), or stacks of 4 single 84x84 frames rebuilt from one env's ring
    (``atari_dedup``, and ``atari_host``: examples/atari_dqn.py's ring of
    10 x 10,000 frames); ``dist_atari`` presamples each update's 512 rows
    of atari's ring on its own."""
    base = DIST_PATHS.get(path, path)
    cfg = PATHS[base]
    ring = cfg["num_envs"] * cfg["capacity"]
    batch = cfg["batch"] if path in DIST_PATHS else cfg["updates"] * cfg["batch"]
    if base in ("atari", "hl_atari"):
        return _gather_storage(gen, ring, 84 * 84 * 4), [_random_idx(gen, ring, batch) for _ in range(sets)]
    return (_gather_storage(gen, ring, 84 * 84),
            [_stacked_idx(gen, cfg["num_envs"], cfg["capacity"], batch, 4) for _ in range(sets)])


def _gather_bound(feat: int, batch: int, distinct: int) -> tuple[float, str]:
    """The least time of one launch: the distinct rows read, the bf16 rows
    written and the indices over the memory rate, or one conversion a byte
    over the float32 rate."""
    bytes_ms = (distinct * feat + batch * feat * 2 + batch * 8) / H100_BYTES_PER_S * 1e3
    ops_ms = batch * feat / H100_FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _time_gather(path: str, storage: torch.Tensor, idx_sets: list[torch.Tensor]) -> dict:
    """At one caller's shape, each timed as device ms, host issue us and wall
    ms a call, every call on the next index set: the previous kernel (the
    simple route) and the new one in turns (old, new, new, old), then the
    plain version and ``index_select().to()``; the bound per launch from the
    distinct rows each set reads, averaged over the sets."""
    from tianshou_tpu_torch.ops.gather import gather_rows_cast, gather_rows_cast_plain

    outs, turn = [None] * len(idx_sets), [0]

    def rotating(call):
        def fn():
            k = turn[0] % len(idx_sets)
            turn[0] += 1
            outs[k] = call(idx_sets[k])
        return fn

    runs = {"old": rotating(lambda i: gather_rows_cast(storage, i, route="simple")),
            "new": rotating(lambda i: gather_rows_cast(storage, i)),
            "plain": rotating(lambda i: gather_rows_cast_plain(storage, i)),
            "library": rotating(lambda i: torch.index_select(storage, 0, i).to(torch.bfloat16))}
    measured = {k: [] for k in runs}
    for name in ("old", "new", "new", "old", "plain", "library"):
        measured[name].append(_timings(runs[name], GATHER_CALLS))
    (rows, feat), batch = storage.shape, idx_sets[0].shape[0]
    distinct = [int(torch.unique(i).numel()) for i in idx_sets]
    bounds = [_gather_bound(feat, batch, d) for d in distinct]
    bound_ms = sum(b for b, _ in bounds) / len(bounds)

    def mean(name, key):
        return sum(m[key] for m in measured[name]) / len(measured[name])

    def said(name):
        def each(key, digits):
            return " / ".join(format(m[key], f".{digits}f") for m in measured[name])

        return (f"device {each('device_ms', 4)} ms ({bound_ms / mean(name, 'device_ms'):.3f} of the bound), "
                f"host issue {each('host_issue_us', 1)} us, wall {each('wall_ms', 4)} ms")

    log(f"gather_rows_cast at {path}'s shape R={rows} F={feat} B={batch} ({len(idx_sets)} index sets in turn, "
        f"{sum(distinct) / len(distinct):.0f} distinct rows a launch): bound {bound_ms:.4f} ms ({bounds[0][1]}); "
        f"new {said('new')}; old {said('old')}; plain {said('plain')}; index_select+to {said('library')}")
    return {"shape": [rows, feat, batch], "distinct_rows": sum(distinct) / len(distinct), "bound_ms": bound_ms,
            "bound_by": bounds[0][1], "share_of_bound": bound_ms / mean("new", "device_ms"),
            **{name: {key: [m[key] for m in measured[name]] for key in ("device_ms", "host_issue_us", "wall_ms")}
               for name in runs}}


def phase_kernels() -> dict:
    """Each kernel bitwise against its plain version at every case, then
    timed at every caller's shape."""
    from tianshou_tpu_torch.ops.gather import ROUTES, _sm_count, gather_rows_cast, gather_rows_cast_plain, launch_plan

    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = _sm_count(torch.cuda.current_device())
    # a batch that leaves the output-order pipeline's blocks unequal runs of
    # more than 64 rows (the producer's index registers refill twice)
    blocks = launch_plan(4096, 84 * 84, 1 << 30, True, sms).grid

    def past_2_32(rows, feat, batch):
        idx = _random_idx(gen, rows, batch)
        assert int(idx.max()) * feat >= 2**32, "no index reaches past 2^32 bytes"
        return _gather_storage(gen, rows, feat), idx

    def cases():
        """(what, storage, idx), one at a time: the callers' shapes; an
        unaligned row width; a batch that fills no round number of blocks
        with rows wider than one block; a storage base off the 16-byte
        alignment; one row; unequal runs; rings past 2^32 bytes, at the
        Atari recipe's frame (4.94 GB) and with the rows the grouped route
        takes (4.5 GB)."""
        for path in ("atari", "atari_dedup", "atari_host", "dist_atari"):
            storage, (idx,) = _caller_inputs(path, gen, 1)
            yield path, storage, idx
        yield "F=13", _gather_storage(gen, 16, 13), _random_idx(gen, 16, 9)
        yield "F=4100", _gather_storage(gen, 300, 4100), _random_idx(gen, 300, 1001)
        yield "offset 3", _gather_storage(gen, 64, 28224, offset=3), _random_idx(gen, 64, 77)
        yield "B=1", _gather_storage(gen, 1000, 84 * 84), _random_idx(gen, 1000, 1)
        yield f"{blocks} blocks", _gather_storage(gen, 4096, 84 * 84), _random_idx(gen, 4096, blocks * 70 + 37)
        yield "idx * F > 2^32", *past_2_32(700_000, 84 * 84, 4096)
        yield "idx * F > 2^32, grouped", *past_2_32(30_000, 150_000, 7500)

    max_err = 0.0
    for what, storage, idx in cases():
        (rows, feat), batch = storage.shape, idx.shape[0]
        aligned = storage.data_ptr() % 16 == 0
        ref = gather_rows_cast_plain(storage, idx)
        # the plan's own route, then every route these inputs allow
        routes = [None]
        for route in ROUTES:
            with contextlib.suppress(ValueError):
                launch_plan(rows, feat, batch, aligned, sms, route)
                routes.append(route)
        for route in routes:
            got = gather_rows_cast(storage, idx, route=route)
            torch.cuda.synchronize()
            taken = route or f"{launch_plan(rows, feat, batch, aligned, sms).route} (the plan's)"
            where = f"{what}: R={rows} F={feat} B={batch} offset={storage.storage_offset()}, route {taken}"
            if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
                raise AssertionError(f"gather_rows_cast differs from its plain version at {where}")
            max_err = max(max_err, float((got.float() - ref.float()).abs().max()))
            log(f"kernel check gather_rows_cast {where}: bitwise equal")
        del storage, idx, ref, got
    torch.cuda.empty_cache()

    shapes = {}
    for path in GATHER_CALLERS:
        shapes[path] = _time_gather(path, *_caller_inputs(path, gen, GATHER_SETS))
        torch.cuda.empty_cache()
    atari = shapes["atari"]
    return {
        "name": "gather_rows_cast",
        "route": "cuda",
        "source": "tianshou_tpu_torch/csrc/gather_rows_cast.cu",
        "replaces": "tianshou_tpu/ops/pallas_gather.py:38",
        "launches": None,
        "max_abs_err": max_err,
        "ms": sum(atari["new"]["wall_ms"]) / 2,
        "plain_ms": atari["plain"]["wall_ms"][0],
        "bound_ms": atari["bound_ms"],
        "bound_by": atari["bound_by"],
        "library_ms": atari["library"]["wall_ms"][0],
        "device_ms": sum(atari["new"]["device_ms"]) / 2,
        "plain_device_ms": atari["plain"]["device_ms"][0],
        "library_device_ms": atari["library"]["device_ms"][0],
        "host_issue_us": sum(atari["new"]["host_issue_us"]) / 2,
        "shapes": shapes,
    }


# phase 3b: the sum tree at nature_rainbow.replay's shapes: a 128 x 782 ring
# (100,096 slots, 2^17 leaves), 512 draws an update, a 512-row write-back, a
# 128-row add (a rollout step's new slots); graphs replayed back to back
SEGTREE_RING, SEGTREE_DRAWS, SEGTREE_ADD = (128, 782), 512, 128
SEGTREE_REPLAYS, SEGTREE_CALLS = 400, 20


def _segtree_ops(tree: torch.Tensor, gen, kernel: bool) -> dict:
    """One prioritized update's draw and write-back and one rollout step's
    add on ``tree``, through the kernels' wrappers or the plain loops run on
    the card's tensors (the flat index computed as the old buffer did)."""
    from tianshou_tpu_torch.ops import segtree as st

    envs, capacity = SEGTREE_RING
    slots = envs * capacity
    u = torch.rand(SEGTREE_DRAWS, generator=gen, device="cuda")
    flat = torch.randperm(slots, generator=gen, device="cuda")[:SEGTREE_DRAWS]
    env_idx, pos = flat // capacity, flat % capacity
    values = torch.rand(SEGTREE_DRAWS, generator=gen, device="cuda") + 0.01
    cursor = torch.randint(0, capacity, (SEGTREE_ADD,), generator=gen, device="cuda")
    top = torch.full((), 1.5, device="cuda")
    if kernel:
        return {"draw": lambda: st.segtree_draw(tree, u, slots, capacity),
                "write_back": lambda: st.segtree_update(tree, pos, values, rows=env_idx, row_stride=capacity),
                "add": lambda: st.segtree_update(tree, cursor, top, row_stride=capacity)}
    return {"draw": lambda: st.segtree_draw_plain(tree, u, slots, capacity),
            "write_back": lambda: st.segtree_update_plain(tree, env_idx * capacity + pos, values),
            "add": lambda: st.segtree_update_plain(
                tree, torch.arange(SEGTREE_ADD, device="cuda") * capacity + cursor, top.expand(SEGTREE_ADD))}


def _graph_ms(fn, replays: int) -> float:
    """Milliseconds a replay of a CUDA graph of one ``fn()`` call, by events
    around ``replays`` replays back to back (L2-warm, as in a superstep)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / replays


def _device_sum_ms(fn, calls: int) -> tuple[float, float]:
    """Device milliseconds of one eager ``fn()`` summed over every kernel it
    runs, and its kernels, from the profiler's records of ``calls`` calls."""
    events = _device_records(lambda: [fn() for _ in range(calls)])
    events = [e for e in events if "Memcpy" not in e.name() and "Memset" not in e.name()]
    return sum(e.end_ns() - e.start_ns() for e in events) / calls / 1e6, len(events) / calls


def phase_segtree() -> dict:
    """The sum tree's kernels at ``nature_rainbow.replay``'s shapes: each
    operation bitwise against the plain loop on the card (the tree and every
    output), then timed against it in turns (kernel, plain, plain, kernel)
    as a replayed graph, with the device time, the kernels a call and the
    floor: the larger of the bytes over the memory rate and the device time
    of one 1-element kernel, since a call is a chain of dependent reads."""
    from tianshou_tpu_torch.ops import segtree as st

    gen = torch.Generator(device="cuda").manual_seed(0)
    envs, capacity = SEGTREE_RING
    slots = envs * capacity
    base = st.segtree_init(slots, "cuda")
    st.segtree_update_plain(base, torch.arange(slots, device="cuda"), torch.rand(slots, generator=gen, device="cuda"))
    trees = {True: base.clone(), False: base.clone()}
    ops = {route: _segtree_ops(trees[route], torch.Generator(device="cuda").manual_seed(1), route)
           for route in (True, False)}
    for op in ops[True]:
        got, want = ops[True][op](), ops[False][op]()
        torch.cuda.synchronize()
        pairs = [("tree", trees[True], trees[False])]
        if op == "draw":
            pairs += list(zip(("env", "pos", "p"), got, want))
        for what, g, w in pairs:
            if not _bitwise(g, w):
                raise AssertionError(f"segtree {op}: the kernel's {what} differs from the plain loop's")
        log(f"kernel check segtree {op} at {slots} slots: bitwise equal to the plain loop (tree and outputs)")

    one = torch.zeros(1, device="cuda")
    floor_ms, _ = _device_sum_ms(lambda: one.add_(1), SEGTREE_CALLS)
    rows = {"draw": SEGTREE_DRAWS, "write_back": SEGTREE_DRAWS, "add": SEGTREE_ADD}
    levels = st.segtree_capacity(base).bit_length() - 1
    shapes = {}
    for op, n in rows.items():
        # draw: u in, (env, pos, p) out, a node a level; an update: the row
        # index and value in, the leaf and a node a level written from two
        # children read
        nbytes = n * (4 + 20 + 4 * levels) if op == "draw" else n * (20 + 4 + 12 * levels)
        bound_ms = max(nbytes / H100_BYTES_PER_S * 1e3, floor_ms)
        graph = {True: [], False: []}
        for route in (True, False, False, True):
            graph[route].append(_graph_ms(ops[route][op], SEGTREE_REPLAYS))
        device = {route: _device_sum_ms(ops[route][op], SEGTREE_CALLS) for route in (True, False)}
        shapes[op] = {"rows": n, "bytes": nbytes, "bound_ms": bound_ms,
                      "bound_by": "bytes" if bound_ms > floor_ms else "one launch",
                      "graph_ms": graph[True], "plain_graph_ms": graph[False],
                      "device_ms": device[True][0], "kernels": device[True][1],
                      "plain_device_ms": device[False][0], "plain_kernels": device[False][1]}
        log(f"segtree {op} at {slots} slots, {n} rows: replayed graph {' / '.join(f'{x:.4f}' for x in graph[True])} "
            f"ms a call, plain loop {' / '.join(f'{x:.4f}' for x in graph[False])} ms; device "
            f"{device[True][0]:.4f} ms in {device[True][1]:.0f} kernels, plain {device[False][0]:.4f} ms in "
            f"{device[False][1]:.0f}; bound {bound_ms:.4f} ms ({shapes[op]['bound_by']}: {nbytes} bytes, one "
            f"1-element kernel {floor_ms:.4f} ms); {levels} levels")
    draw = shapes["draw"]
    return {
        "name": "segtree",
        "route": "cuda",
        "source": "tianshou_tpu_torch/csrc/segtree.cu",
        "replaces": None,
        "launches": None,
        "max_abs_err": 0.0,
        "ms": sum(draw["graph_ms"]) / 2,
        "plain_ms": sum(draw["plain_graph_ms"]) / 2,
        "bound_ms": draw["bound_ms"],
        "bound_by": draw["bound_by"],
        "library_ms": None,
        "device_ms": draw["device_ms"],
        "plain_device_ms": draw["plain_device_ms"],
        "library_device_ms": None,
        "host_issue_us": None,
        "shapes": shapes,
    }


def continuous_algo(kind: str, obs_dim: int, act_dim: int, action_space, hidden, device, **kw):
    """SAC (``kind`` "sac", automatic alpha unless ``auto_alpha=False``) or
    TD3 with the JAX package's threshold settings."""
    from tianshou_tpu_torch.algos.ddpg import TD3
    from tianshou_tpu_torch.algos.sac import SAC
    from tianshou_tpu_torch.networks.continuous import CriticEnsemble, DeterministicActor, GaussianActor

    critic = CriticEnsemble(obs_dim, act_dim, hidden, num_critics=2)
    if kind == "sac":
        return SAC(GaussianActor(obs_dim, hidden, act_dim, conditioned_sigma=True), critic, action_space,
                   actor_lr=1e-3, critic_lr=1e-3, gamma=0.99, tau=0.005, n_step=1, device=device, **kw)
    return TD3(DeterministicActor(obs_dim, hidden, act_dim), critic, action_space, actor_lr=1e-3, critic_lr=1e-3,
               gamma=0.99, tau=0.005, n_step=1, exploration_noise=0.1, policy_noise=0.2, noise_clip=0.5,
               update_actor_freq=2, device=device, **kw)


def _train_param_fn(path: str, cfg: dict):
    """The path's exploration schedule: a constant epsilon, a linear decay
    (``eps_decay``: start, end, steps), or the algorithm's own (None)."""
    if "eps_decay" in cfg:
        start, end, steps = cfg["eps_decay"]
        return lambda epoch, step: start + min(1.0, step / steps) * (end - start)
    if "eps" in cfg or path in EPSILON_PATHS:
        eps = cfg.get("eps", 0.1)
        return lambda epoch, step: eps
    return None


def build_path(path: str, device, test_envs: int = 8, pipeline: bool = False, fused: bool | None = None, **small):
    """A path's configuration through the port's entry points; ``small``
    overrides sizes (the card-vs-CPU reference runs a small slice)."""
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer

    cfg = {**PATHS[path], **small}
    num_envs, segment, batch, updates, capacity = (
        cfg[k] for k in ("num_envs", "segment", "batch", "updates", "capacity"))
    buffer_options = {}
    dqn = None
    if path in ("atari", "atari_dedup"):
        from tianshou_tpu_torch.envs.synthetic import SyntheticPixelEnv
        from tianshou_tpu_torch.networks.conv import ConvQNet

        channels, num_actions = cfg.get("channels", 4), cfg.get("num_actions", 6)
        env = SyntheticPixelEnv(cfg.get("height", 84), cfg.get("width", 84), channels, num_actions=num_actions,
                                episode_len=cfg.get("episode_len", 512), channel_first=path == "atari_dedup")
        if path == "atari_dedup":
            buffer_options = dict(stack_num=channels, save_only_last_obs=True, ignore_obs_next=True)
        net = ConvQNet(env.observation_space.shape, num_actions, "nature",
                       encoder_kwargs={"compute_dtype": cfg.get("compute_dtype", torch.bfloat16)})
        dqn = dict(gamma=0.99, n_step=3, target_update_freq=1000)
    elif path == "cartpole":
        from tianshou_tpu_torch.envs.classic import CartPole
        from tianshou_tpu_torch.networks.common import QNet

        env = CartPole()
        net = QNet(env.observation_space.shape, (128, 128, 128), env.action_space.n)
        dqn = dict(gamma=0.9, n_step=3, target_update_freq=320)
    elif path in MINATAR_GAMES:
        from tianshou_tpu_torch.envs.minatar import make_minatar
        from tianshou_tpu_torch.networks.conv import ConvQNet

        env = make_minatar(MINATAR_GAMES[path])
        net = ConvQNet(env.observation_space.shape, env.action_space.n, "minatar",
                       encoder_kwargs={"compute_dtype": torch.bfloat16})
        dqn = dict(gamma=0.99, n_step=3, target_update_freq=1000)
    elif path == "rainbow_per":
        # tests/test_distributional_e2e.py:109-121, the PER of tests/test_prio.py:151
        from tianshou_tpu_torch.algos.c51 import Rainbow
        from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer
        from tianshou_tpu_torch.envs.classic import CartPole
        from tianshou_tpu_torch.networks.discrete import C51Net

        env = CartPole()
        algo = Rainbow(C51Net(4, (128, 128), 2, num_atoms=51, noisy=True), env.action_space,
                       num_atoms=51, v_min=0.0, v_max=200.0, gamma=0.95, n_step=3, target_update_freq=320,
                       device=device)
        buffer = PrioritizedReplayBuffer(capacity, num_envs, alpha=0.6, beta=0.4)
        test_envs = 10
    elif path == "qrdqn_minatar":
        # examples/dqn_minatar.py --algo qrdqn, its defaults
        from tianshou_tpu_torch.algos.qrdqn import QRDQN
        from tianshou_tpu_torch.envs.minatar import make_minatar
        from tianshou_tpu_torch.networks.conv import ConvQRDQNNet

        env = make_minatar("breakout")
        net = ConvQRDQNNet(env.observation_space.shape, env.action_space.n, 200, "minatar")
        algo = QRDQN(net, env.action_space, num_quantiles=200, lr=3e-4, gamma=0.99, n_step=3,
                     target_update_freq=1000, device=device)
    elif path in ("sac_pendulum", "td3_pendulum"):
        from tianshou_tpu_torch.envs.classic import Pendulum

        env = Pendulum()
        algo = continuous_algo(path[:3], 3, 1, env.action_space, cfg.get("hidden", (128, 128)), device)
        test_envs = 10
    elif path in ("sac_host", "sac_fine"):
        # bench.py's host stage; sac_fine: examples/mujoco_sac.py (fixed alpha 0.2)
        from tianshou_tpu_torch.envs.host import HostVectorEnv

        env = HalfCheetahStandIn()
        algo = continuous_algo("sac", env.OBS_DIM, env.ACT_DIM, env.action_space, (256, 256), device,
                               auto_alpha=False)
        host_venvs = (HostVectorEnv([HalfCheetahStandIn] * num_envs),
                      HostVectorEnv([HalfCheetahStandIn] * cfg.get("test_envs", 2)))
    elif path == "atari_host":
        # examples/atari_dqn.py --fake-ale: the DeepMind chain, NatureCNN in bf16
        from tianshou_tpu_torch.envs.atari import FakeAtariEnv, make_atari_env
        from tianshou_tpu_torch.networks.conv import ConvQNet

        host_venvs = make_atari_env("ALE/Pong-v5", num_envs, cfg["test_envs"], env_fn=lambda: FakeAtariEnv(seed=0))
        env = host_venvs[0]
        net = ConvQNet((4, 84, 84), env.action_space.n, "nature", encoder_kwargs={"compute_dtype": torch.bfloat16})
        algo = DQN(net, env.action_space, lr=1e-4, gamma=0.99, n_step=3, target_update_freq=500, device=device)
        buffer_options = dict(stack_num=4, save_only_last_obs=True, ignore_obs_next=True)
    elif path == "cpp_cartpole":
        # examples/cpp_pool_dqn.py
        from tianshou_tpu_torch.envs.cpp_pool import CppVectorEnv
        from tianshou_tpu_torch.networks.common import QNet

        host_venvs = (CppVectorEnv("CartPole-v1", num_envs, seed=0),
                      CppVectorEnv("CartPole-v1", cfg["test_envs"], seed=99))
        env = host_venvs[0]
        net = QNet(4, (128, 128, 128), 2)
        dqn = dict(gamma=0.9, n_step=3, target_update_freq=320)
    elif path == "marl_tictactoe":
        # tests/test_marl.py:46-77: two DQN agents in self-play
        from tianshou_tpu_torch.algos.multiagent import MultiAgentPolicyManager
        from tianshou_tpu_torch.envs.tictactoe import TicTacToe
        from tianshou_tpu_torch.networks.common import QNet

        env = TicTacToe()
        algo = MultiAgentPolicyManager([
            DQN(QNet(19, cfg.get("hidden", (128, 128)), 9), env.action_space, gamma=0.95, n_step=2,
                target_update_freq=320, device=device) for _ in range(2)])
        test_envs = 16
    elif path == "redq_pendulum":
        # highlevel/experiment.py:860-883; the rest tests/test_utils_misc.py:127-160
        from tianshou_tpu_torch.algos.redq import REDQ
        from tianshou_tpu_torch.envs.classic import Pendulum
        from tianshou_tpu_torch.networks.continuous import CriticEnsemble, GaussianActor

        env, hidden = Pendulum(), cfg.get("hidden", (256, 256))
        algo = REDQ(GaussianActor(3, hidden, 1, conditioned_sigma=True), CriticEnsemble(3, 1, hidden, num_critics=10),
                    env.action_space, ensemble_size=10, subset_size=2, actor_delay=20, auto_alpha=True, device=device)
        test_envs = 10
    elif path == "discrete_sac_cartpole":
        # highlevel/experiment.py:653-682
        from tianshou_tpu_torch.algos.sac import DiscreteSAC
        from tianshou_tpu_torch.envs.classic import CartPole
        from tianshou_tpu_torch.networks.common import QNet, QNetEnsemble

        env, hidden = CartPole(), cfg.get("hidden", (128, 128))
        algo = DiscreteSAC(QNet(4, hidden, 2), QNetEnsemble(4, hidden, 2, num_critics=2), env.action_space,
                           actor_lr=1e-3, critic_lr=1e-3, alpha=0.05, auto_alpha=True, alpha_lr=3e-4, gamma=0.99,
                           tau=0.005, n_step=1, device=device)
        test_envs = 10
    elif path == "bdq_pendulum":
        # tests/test_distributional_e2e.py:168-192
        from tianshou_tpu_torch.algos.bdq import BDQ
        from tianshou_tpu_torch.envs.classic import Pendulum
        from tianshou_tpu_torch.envs.wrappers import ContinuousToDiscrete
        from tianshou_tpu_torch.networks.common import BranchingQNet

        env = ContinuousToDiscrete(Pendulum(), action_per_dim=11, force_multidiscrete=True)
        algo = BDQ(BranchingQNet(3, (128, 128), num_branches=1, actions_per_branch=11), env.action_space,
                   gamma=0.99, target_update_freq=320, device=device)
        test_envs = 10
    elif path == "drqn_cartpole":
        # tests/test_distributional_e2e.py:195-207 with its _train
        from tianshou_tpu_torch.algos.drqn import DRQN
        from tianshou_tpu_torch.envs.classic import CartPole
        from tianshou_tpu_torch.networks.common import RecurrentQNet

        env = CartPole()
        algo = DRQN(RecurrentQNet(4, cfg.get("hidden", 128), 2), env.action_space, stack_num=4, gamma=0.95,
                    target_update_freq=320, device=device)
        test_envs = 10
    elif path == "icm_cartpole":
        # tests/test_utils_misc.py:210-254
        from tianshou_tpu_torch.algos.icm import ICM, ICMNet
        from tianshou_tpu_torch.envs.classic import CartPole
        from tianshou_tpu_torch.networks.common import QNet

        env = CartPole()
        inner = DQN(QNet(4, cfg.get("hidden", (128, 128)), 2), env.action_space, lr=1e-3, gamma=0.95, n_step=1,
                    target_update_freq=320, device=device)
        algo = ICM(inner, ICMNet(4, (64,), feature_dim=32, num_actions=2), lr=1e-3, reward_scale=0.01)
        test_envs = 10
    else:
        raise ValueError(f"unknown path {path!r}; have {sorted(PATHS)}")
    if path not in PER_PATHS:
        buffer = ReplayBuffer(capacity, num_envs, **buffer_options)
    if dqn is not None:
        algo = DQN(net, env.action_space, lr=1e-3, device=device, **dqn)
    if path in HOST_PATHS + FUSED_PATHS:
        from tianshou_tpu_torch.collect.host_collector import HostCollector

        train = HostCollector(algo, host_venvs[0], buffer, device=device)
        test = HostCollector(algo, host_venvs[1], device=device)
        episodes = cfg.get("episodes", 1)
    else:
        train = Collector(algo, VectorEnv(env, num_envs, device=device), buffer, device=device)
        test = Collector(algo, VectorEnv(env, test_envs, device=device), device=device)
        episodes = test_envs
    steps = num_envs * segment
    trainer = OffPolicyTrainer(
        algo, train, test, buffer, max_epoch=1, step_per_epoch=cfg.get("main_supersteps", 2) * steps,
        step_per_collect=steps,
        update_per_step=cfg.get("update_per_step", updates / steps), batch_size=batch, episode_per_test=episodes, device=device,
        # the DQN family explores with epsilon 0.1 (Rainbow through its
        # weight noise, ignoring it); TD3 takes its default, its own
        # exploration noise (SAC samples and ignores it)
        train_param_fn=_train_param_fn(path, cfg), test_param=cfg.get("eps_test", 0.0),
        warmup_steps=cfg.get("warmup", 0), pipeline_host_updates=pipeline, fused_fine_host=fused,
    )
    if (trainer.segment_len, trainer.updates_per_segment) != (segment, updates):
        raise AssertionError(f"trainer split {trainer.segment_len} steps / {trainer.updates_per_segment} updates")
    return env, algo, train, buffer, trainer


def init_states(algo, collector, buffer, seed=0):
    from tianshou_tpu_torch.utils.device import fork_generator, make_generator

    gen = make_generator(seed, collector.device)
    cstate = collector.reset(fork_generator(gen))
    ts = algo.init(fork_generator(gen))
    bstate = None if buffer is None else buffer.init(collector.example_transition(ts, cstate), device=collector.device)
    return gen, ts, cstate, bstate


def phase_reference(path: str) -> None:
    """A small slice on the card and on the CPU from the same start: the card
    must take the same greedy actions (float32, TF32 off), store the same
    ring bitwise, gather the same bf16 presample (through the kernel, whole
    stacks in one launch on the deduplicated layout), and find the same
    update losses (rtol 1e-3: cuDNN and the CPU sum the convolutions in
    different orders)."""
    from tianshou_tpu_torch.collect.collector import rollout_segment
    from tianshou_tpu_torch.envs.synthetic import SyntheticPixelState
    from tianshou_tpu_torch.ops.gather import gather_rows_cast
    from tianshou_tpu_torch.trainer.offpolicy import build_update_scan

    small = dict(height=36, width=36, channels=2, num_actions=4, num_envs=4, segment=20,
                 batch=16, updates=3, capacity=16, compute_dtype=torch.float32, episode_len=64)
    seeds = torch.tensor([11, 222, 3333, 44444], dtype=torch.int32)
    runs = {}
    state_dict = None
    for device in ("cuda", "cpu"):
        env, algo, col, buffer, _ = build_path(path, device, **small)
        _, ts, cstate, bstate = init_states(algo, col, buffer)
        if state_dict is None:
            state_dict = {k: v.cpu() for k, v in ts.online.state_dict().items()}
        ts.online.load_state_dict(state_dict)
        ts.target.load_state_dict(state_dict)
        es = SyntheticPixelState(torch.zeros(4, dtype=torch.int32, device=device), seeds.to(device))
        cstate.env_state, cstate.obs = es, env.frame(es.t, es.seed)
        cstate, bstate, _ = rollout_segment(algo, col.venv, buffer, small["segment"], explore=False)(
            ts, cstate, bstate, 0.0)
        env_idx = torch.arange(48, device=device) % 4
        pos = (torch.arange(48, device=device) * 7) % 16
        gather_rows_cast.launches = 0
        bf16 = buffer.get(bstate, env_idx, pos, keys=("obs", "obs_next"),
                          dtypes={"obs": torch.bfloat16, "obs_next": torch.bfloat16})
        if gather_rows_cast.launches != (2 if device == "cuda" else 0):
            raise AssertionError(f"{device}: {gather_rows_cast.launches} gather_rows_cast launches for 2 keys")
        buffer.sample_with_weights = lambda st, g, b, e=env_idx, p=pos: (e, p, torch.ones(b, device=e.device))
        ts, bstate, metrics = build_update_scan(algo, buffer, small["batch"], small["updates"])(
            ts, bstate, None)
        runs[device] = (bstate, bf16, {k: float(v) for k, v in metrics.items()})
    (gb, gbf, gm), (cb, cbf, cm) = runs["cuda"], runs["cpu"]
    for k in cb.storage:
        if not torch.equal(gb.storage[k].cpu(), cb.storage[k]):
            raise AssertionError(f"{path}: replay storage {k!r} differs between the card and the CPU")
    for k in ("obs", "obs_next"):
        if not torch.equal(gbf[k].cpu().view(torch.int16), cbf[k].view(torch.int16)):
            raise AssertionError(f"{path}: bf16 presample of {k!r} differs between the card and the CPU")
    for k in cm:
        if not math.isclose(gm[k], cm[k], rel_tol=1e-3):
            raise AssertionError(f"{path}: {k}: card {gm[k]} vs CPU {cm[k]}")
    log(f"reference {path}: card equals CPU on actions, replay storage and bf16 presample "
        f"{tuple(gbf['obs'].shape)}; losses card {gm['loss']:.6f} CPU {cm['loss']:.6f}")


def _assert_close(what: str, got, ref, rtol=1e-4, atol=1e-5) -> float:
    """Raise unless ``got`` (on the card) is within the tolerance of
    ``ref`` (on the CPU); returns the largest absolute difference."""
    got = got.detach().cpu()
    ref = ref.detach().cpu()
    if got.shape != ref.shape or not torch.allclose(got, ref, rtol=rtol, atol=atol):
        diff = float((got.float() - ref.float()).abs().max()) if got.shape == ref.shape else math.nan
        raise AssertionError(f"{what}: card and CPU differ beyond rtol {rtol} / atol {atol} (largest difference "
                             f"{diff:.3e})")
    return float((got - ref).abs().max()) if got.numel() else 0.0


def phase_reference_continuous() -> None:
    """The continuous slice on the card against the CPU (float32, TF32
    off): 3 SAC and 3 TD3 updates from the same parameters, batch and
    noise; a 20-step greedy Pendulum segment; the packed host transfer."""
    from tianshou_tpu_torch.collect.collector import rollout_segment
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.envs.classic import Pendulum, PendulumState
    from tianshou_tpu_torch.envs.spaces import Box
    from tianshou_tpu_torch.utils.transfer import TreePacker

    obs_dim, act_dim, hidden, batch = 3, 1, (32, 32), 16
    box = Box(low=-2.0, high=2.0, shape=(act_dim,))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        a = dict(env_idx=rng.integers(0, 2, batch), pos=rng.integers(0, 8, batch),
                 weight=rng.uniform(0.5, 1.5, batch).astype(np.float32),
                 obs=rng.normal(size=(batch, obs_dim)).astype(np.float32),
                 act=rng.uniform(-1, 1, (batch, act_dim)).astype(np.float32),
                 rew=rng.normal(size=(batch, 1)).astype(np.float32),
                 done=(rng.random((batch, 1)) < 0.2).astype(np.int32),
                 obs_next=rng.normal(size=(batch, obs_dim)).astype(np.float32),
                 terminated=rng.random(batch) < 0.3,
                 noise=rng.normal(size=(2, batch, act_dim)).astype(np.float32))
        batches.append(a)
    for kind in ("sac", "td3"):
        runs = {}
        for device in ("cuda", "cpu"):
            algo = continuous_algo(kind, obs_dim, act_dim, box, hidden, device)
            ts = algo.init(torch.Generator(device=device).manual_seed(0))
            if device == "cuda":
                init = {k: {n: v.detach().cpu() for n, v in getattr(ts, k).state_dict().items()}
                        for k in ("actor", "critic", "target_actor", "target_critic") if getattr(ts, k) is not None}
            for k, sd in init.items():
                getattr(ts, k).load_state_dict(sd)
            losses = []
            for b in batches:
                t = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
                sampled = (t["env_idx"], t["pos"], t["weight"], Batch(obs=t["obs"], act=t["act"]), t["rew"],
                           t["done"], Batch(obs_next=t["obs_next"], terminated=t["terminated"]))
                noise = (t["noise"][0], t["noise"][1]) if kind == "sac" else t["noise"][0]
                ts, _, m = algo.update_sampled(ts, None, None, sampled, noise=noise)
                losses.append(torch.stack([m["critic_loss"], m["actor_loss"]]))
            runs[device] = (ts, torch.stack(losses))
        (gts, gl), (cts, cl) = runs["cuda"], runs["cpu"]
        err = _assert_close(f"{kind} losses", gl, cl)
        for k in ("actor", "critic", "target_actor", "target_critic"):
            if getattr(gts, k) is None:
                continue
            for n, v in getattr(gts, k).state_dict().items():
                err = max(err, _assert_close(f"{kind} {k}.{n}", v, getattr(cts, k).state_dict()[n]))
        if kind == "sac":
            err = max(err, _assert_close("sac log_alpha", gts.log_alpha, cts.log_alpha))
        log(f"reference {kind}: 3 updates on the card equal the CPU's within rtol 1e-4 / atol 1e-5 "
            f"(largest difference {err:.3e}); critic losses card {gl[:, 0].tolist()} CPU {cl[:, 0].tolist()}")

    # a 20-step greedy SAC segment of the on-device Pendulum from the same
    # start states and parameters
    start = rng.uniform(-3.0, 3.0, (2, 4)).astype(np.float32)
    storage, sd = {}, None
    for device in ("cuda", "cpu"):
        _, algo, col, buffer, _ = build_path("sac_pendulum", device, num_envs=4, capacity=32, hidden=hidden,
                                             updates=5)
        _, ts, cstate, bstate = init_states(algo, col, buffer)
        sd = sd or {n: v.detach().cpu() for n, v in ts.actor.state_dict().items()}
        ts.actor.load_state_dict(sd)
        st = PendulumState(torch.from_numpy(start[0]).to(device), torch.from_numpy(start[1]).to(device),
                           torch.zeros(4, dtype=torch.int32, device=device))
        cstate.env_state, cstate.obs = st, Pendulum._obs(st)
        cstate, bstate, _ = rollout_segment(algo, col.venv, buffer, 20, explore=False)(ts, cstate, bstate, 0.0)
        storage[device] = bstate.storage
    err = max(_assert_close(f"pendulum storage {k}", storage["cuda"][k].float(), storage["cpu"][k].float(),
                            rtol=0, atol=1e-5) for k in storage["cpu"])
    log(f"reference sac_pendulum: a 20-step greedy segment stores the same ring on the card and the CPU "
        f"(largest difference {err:.3e}, atol 1e-5)")

    # the packed host transfer: bitwise, and three copies queued behind a
    # busy stream (the third reuses the first pinned buffer, so its pack
    # must wait for the first copy to have read it)
    def tree(seed):
        r = np.random.default_rng(seed)
        return {"obs": r.normal(size=(8, 8, 17)), "rew": r.normal(size=(8, 8)).astype(np.float32),
                "terminated": r.random((8, 8)) < 0.1, "truncated": r.random((8, 8)) < 0.1,
                "obs_next": r.normal(size=(8, 8, 17))}

    trees = [tree(i) for i in range(3)]
    packer = TreePacker(trees[0], "cuda")
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # about 0.1 s of a busy stream ahead of the copies
    flats = [packer.to_device(t) for t in trees]
    for i, (t, flat) in enumerate(zip(trees, flats)):
        got = packer.unpack(flat)
        ref = TreePacker(t, "cpu").unpack(torch.from_numpy(packer.pack(t)))
        for k in t:
            if not torch.equal(got[k].cpu(), ref[k]):
                raise AssertionError(f"TreePacker: copy {i} leaf {k!r} differs on the card")
    log(f"reference TreePacker: 3 packed copies of {packer.total} floats, queued behind a busy stream, "
        "arrive bitwise equal")


def _fresh_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _read(metrics: dict) -> dict[str, float]:
    """Device metrics on the host, in one synchronising copy."""
    return dict(zip(metrics, torch.stack([v.float() for v in metrics.values()]).tolist()))


def _check_metrics(path: str, metrics: dict[str, float]) -> None:
    missing = [k for k in FAMILY_METRICS[family(path)] if k not in metrics]
    if missing or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{path}: metrics {metrics}, missing {missing}")


def timed(step, n: int, warmup: int = WARMUP) -> tuple[float, dict[str, float]]:
    """``warmup`` calls of ``step`` (which returns device metrics), then
    ``n`` timed ones closed by reading the last metrics: ``(seconds,
    metrics)``."""
    for _ in range(warmup):
        metrics = step()
    _read(metrics)
    t0 = time.perf_counter()
    for _ in range(n):
        metrics = step()
    metrics = _read(metrics)
    return time.perf_counter() - t0, metrics


def sync_guarded(fn) -> None:
    """``fn()`` with every host synchronisation PyTorch knows of made an
    error."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def breakdown(parts: dict, reps: int = 3) -> dict[str, float]:
    """The parts of a superstep (segment) run in turn, each alone between
    two synchronisations, ``reps`` times: each part's median ms."""
    times = {k: [] for k in parts}
    for _ in range(reps):
        for k, fn in parts.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[k].append(time.perf_counter() - t0)
    return {k: sorted(v)[reps // 2] * 1e3 for k, v in times.items()}


def superstep_of(trainer, state: list, generator):
    """The trainer's superstep over ``state`` (``[ts, cstate, bstate]``,
    updated in place; ``bstate`` is None on the on-policy paths): ``step()
    -> device metrics``."""
    fn = trainer._build_superstep()

    def step():
        if state[2] is None:
            state[0], state[1], _, metrics = fn(state[0], state[1], generator)
        else:
            state[0], state[1], state[2], _, metrics = fn(*state, generator, 0.1)
        return metrics

    return step


def phase_superstep(path: str, gather) -> dict:
    """An on-device path at full width: 1 warm-up and 2 timed supersteps,
    one under the sync guard, one under the profiler (device kernels and
    busy time), and the breakdown: the rollout, then the presample and the
    updates (off-policy) or one processing pass and the learning (on-policy:
    every processing pass and the minibatch updates)."""
    from tianshou_tpu_torch.collect.collector import rollout_segment
    from tianshou_tpu_torch.data.tree import tree_leaves, tree_map
    from tianshou_tpu_torch.trainer.offpolicy import build_update_scan

    cfg = PATHS[path]
    _fresh_memory()
    base = torch.cuda.memory_allocated() / 2**30
    env, algo, col, buffer, trainer = build(path)
    gen, *state = init_states(algo, col, buffer)
    step = superstep_of(trainer, state, gen)
    n, steps = TIMED_COMPILED if path in COMPILED_PATHS else TIMED, cfg["num_envs"] * cfg["segment"]
    gather.launches = 0
    dt, metrics = timed(step, n)
    launches = gather.launches
    if launches != KERNEL_LAUNCHES[path] * (n + WARMUP):
        raise AssertionError(f"{path}: gather_rows_cast launched {launches} times in {n + WARMUP} supersteps, "
                             f"not {KERNEL_LAUNCHES[path] * (n + WARMUP)}")
    _check_metrics(path, metrics)
    # the superstep keeps everything on the device: an operation in it that
    # PyTorch knows to synchronise the host with the card raises
    sync_guarded(step)
    check_policy(path, algo, state[0], state[1].obs, gen, env, state[1].policy_state)
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile = _profile(step) if path not in LEARN_GRAPH_PATHS + GRAPH_COVERED else None
    kernels, busy_ms = (profile["kernels"], profile["busy_ms"]) if profile else (None, None)
    result = {"env_steps_per_s": n * steps / dt, "ms_per_superstep": dt / n * 1e3, **metrics, "profile": profile,
              "updates_per_superstep": cfg["updates"], "gather_rows_cast_per_superstep": launches / (n + WARMUP),
              "device_kernels_per_superstep": kernels, "device_busy_ms_per_superstep_profiled": busy_ms,
              "max_memory_allocated_gib": peak, "memory_base_gib": base}
    if buffer is not None:
        result["ring_gb"] = sum(x.numel() * x.element_size() for x in tree_leaves(state[2].storage)) / 1e9
    log(f"{path}: {n} supersteps of {cfg['num_envs']} envs x {cfg['segment']} steps + {cfg['updates']} updates of "
        f"batch {cfg['batch']}: {result['env_steps_per_s']:.1f} env-steps/s, {result['ms_per_superstep']:.2f} ms "
        f"per superstep, metrics {metrics}, gather_rows_cast launches {launches} in {n + WARMUP}, max_memory_allocated "
        f"{peak:.3f} GiB; a superstep under torch.cuda.set_sync_debug_mode('error') raised no host sync"
        + (f"; profiled superstep: {kernels} device kernels, device busy {busy_ms:.2f} ms" if profile else ""))
    if path in GRAPH_COVERED:
        return result

    # where a superstep's time goes: its parts timed alone
    if buffer is None:
        seg = rollout_segment(algo, col.venv, None, cfg["segment"], explore=True, record_traj=True)
        learn = trainer._build_learn()
        held = {}

        def rollout():
            state[1], _, outputs = seg(state[0], state[1], None, 0.0)
            held["traj"] = outputs["traj"]

        def learning():
            state[0], _ = learn(state[0], held["traj"], gen)

        parts = {"rollout": rollout, "processing pass": lambda: algo.process_rollout(state[0], held["traj"]),
                 "learn incl. processing": learning}
        if hasattr(algo, "pre_learn"):
            parts["discriminator steps (pre_learn)"] = lambda: algo.pre_learn(state[0], held["traj"], gen)
        result["processing_passes_per_superstep"] = _processing_passes(algo, cfg["repeat"])
    else:
        seg = rollout_segment(algo, col.venv, buffer, cfg["segment"], explore=True)
        updates_fn = build_update_scan(algo, buffer, cfg["batch"], cfg["updates"])

        def rollout():
            state[1], state[2], _ = seg(state[0], state[1], state[2], 0.1)

        def updates():
            state[0], state[2], _ = updates_fn(state[0], state[2], gen)

        if path == "drqn_cartpole":
            # each update samples its own batch and rebuilds its histories
            def history_sample():
                env_idx, pos = buffer.sample_indices(state[2], gen, cfg["batch"])
                buffer.stacked_obs(state[2], env_idx, pos, algo.stack_num)
                buffer.stacked_obs(state[2], env_idx, pos, algo.stack_num, obs_key="obs_next")

            parts = {"rollout": rollout, "history sample (one update)": history_sample,
                     "updates incl. sampling": updates}
        elif path == "icm_cartpole":
            # each update samples its own batches: the curiosity step's and
            # the inner DQN's, through the buffer view
            parts = {"rollout": rollout,
                     "one update (curiosity step + DQN through the view)": lambda: algo.update(
                         state[0], buffer, state[2], gen, cfg["batch"]),
                     "updates incl. sampling": updates}
        elif path in PER_PATHS:
            # each update samples its own batch: the sum-tree descent and
            # weights alone, with the gathers, the write-back of one update
            # and the PER add of one rollout step, each on its own
            held = {"sampled": algo.presample(buffer, state[2], gen, cfg["batch"]),
                    "step": tree_map(lambda x: x[:, 0], state[2].storage)}

            def write_back():
                env_idx, pos, weight = held["sampled"][:3]
                state[2] = buffer.update_priorities(state[2], env_idx, pos, weight)

            parts = {"rollout": rollout,
                     "per sample_with_weights": lambda: buffer.sample_with_weights(state[2], gen, cfg["batch"]),
                     "per sample incl. gathers": lambda: algo.presample(buffer, state[2], gen, cfg["batch"]),
                     "per write-back": write_back,
                     "per add (one rollout step)": lambda: buffer.add(state[2], held["step"]),
                     "updates incl. sampling": updates}
        elif not algo.supports_presampled:
            # each update samples its own batch (the manager: one a agent)
            parts = {"rollout": rollout, "updates incl. sampling": updates}
        else:
            parts = {"rollout": rollout,
                     "presample": lambda: algo.presample(buffer, state[2], gen, cfg["updates"] * cfg["batch"]),
                     "updates incl. presample": updates}
    reps = BREAKDOWN_REPS_COMPILED if path in COMPILED_PATHS else BREAKDOWN_REPS
    result["breakdown_ms"] = breakdown(parts, reps)
    log(f"{path} breakdown (median of {reps}, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in result["breakdown_ms"].items()))
    if path in PER_PATHS:
        # device kernels and busy time of each PER operation, profiled alone
        result["per_kernels_busy_ms"] = {k: _profile_counts(parts[k]) for k in parts if k.startswith("per ")}
        log(f"{path} PER operations profiled alone (device kernels, busy ms): " + ", ".join(
            f"{k} {n} / {b:.3f}" for k, (n, b) in result["per_kernels_busy_ms"].items()))
    return result


def _copy_generator(g: torch.Generator) -> torch.Generator:
    c = torch.Generator(device=g.device)
    c.set_state(g.get_state())
    return c


def _clone_run_state(ts, cstate, bstate, generator) -> list:
    """``[ts, cstate, bstate, generator]`` copied, sharing no tensor or
    generator with the originals (the generators in the states they
    hold)."""
    memo = {id(g): _copy_generator(g) for g in (generator, cstate.rng)}
    return [*copy.deepcopy((ts, cstate, bstate), memo), memo[id(generator)]]


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` and ``b`` hold the same bits (NaNs included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = (t.detach().reshape(-1).contiguous() for t in (a, b))
    return bool(torch.equal(a.view(torch.uint8), b.view(torch.uint8))) if a.numel() else True


def _run_leaves(state: list, outputs=None, metrics=None) -> list[tuple[str, torch.Tensor]]:
    """The named tensors of a run state ``[ts, cstate, bstate, generator]``
    (its generators' states included) and of a superstep's outputs and
    metrics."""
    from tianshou_tpu_torch.data.tree import tree_leaves
    from tianshou_tpu_torch.utils.graphs import named_tensors

    leaves = named_tensors(tuple(state[:3]))
    leaves += [("generator", state[3].get_state()), ("collect rng", state[1].rng.get_state())]
    if outputs is not None:
        leaves += [(f"outputs[{i}]", t) for i, t in enumerate(tree_leaves(outputs))]
        leaves += [(f"metrics[{k!r}]", v) for k, v in metrics.items()]
    return leaves


def _differing(a: list, b: list) -> list[str]:
    if [n for n, _ in a] != [n for n, _ in b]:
        raise AssertionError(f"leaf names differ: {sorted(set(n for n, _ in a) ^ set(n for n, _ in b))[:8]}")
    return [n for (n, x), (_, y) in zip(a, b) if not _bitwise(x, y)]


def _pattern_count(algo, ts, updates: int, supersteps: int = 64) -> int:
    """The branch patterns (``Algorithm.update_pattern``) that ``supersteps``
    supersteps from ``ts`` meet, from its host update counts alone."""
    from tianshou_tpu_torch.utils.graphs import step_counters

    counters = step_counters(ts)
    saved = [c.step for c in counters]
    keys = set()
    try:
        for _ in range(supersteps):
            keys.add(algo.update_pattern(ts, updates))
            for c in counters:
                c.step += updates
    finally:
        for c, s0 in zip(counters, saved):
            c.step = s0
    return len(keys)


def phase_graph(path: str, gather, eager_profile: dict) -> dict:
    """The compiled superstep (``OffPolicyTrainer._compile_superstep``: CUDA
    graphs of the eager superstep) at full width.  First its warm-ups:
    calls from the path's initial state until every branch pattern that the
    later calls meet is captured, each pattern's first call an eager
    superstep followed by its capture (their times, the graphs, the peak
    memory, the kernel's host launches).  Then, from copies of that state,
    two eager supersteps (``_build_superstep``, its optimizers made
    capturable as the capture made the graph's) against two replays,
    bitwise: every carried tensor (parameters, optimizer state, targets,
    ring, cursors, collect state), the generators' states, ``outputs`` and
    ``metrics`` of each superstep; ms a superstep in turns (eager, graph,
    graph, eager); one replay under the profiler (the card's kernels and
    busy time, the host's launch calls, the kernel's device launches in the
    replay), beside ``eager_profile`` (``phase_superstep``'s, whose Adam is
    not capturable; None on the ``GRAPH_COVERED`` paths, which skip the
    turns and the profiles); one replay under the sync guard; peak memory;
    the bytes of carried state copied back a superstep, the ring's storage unmoved.  A leaf that is not bitwise is
    held to phase 4's limits and named in the result (with whether two
    eager runs agree on it)."""
    from tianshou_tpu_torch.data.tree import tree_leaves
    from tianshou_tpu_torch.utils.graphs import CapturedStep

    _fresh_memory()
    _, algo, col, buffer, trainer = build(path)
    gen, ts, cstate, bstate = init_states(algo, col, buffer)
    graph_state = [ts, cstate, bstate, gen]
    explore = torch.full((), 0.1, device="cuda")
    eager_fn = trainer._build_superstep()
    compiled = trainer._compile_superstep(*graph_state[:3])
    if not isinstance(compiled, CapturedStep):
        raise AssertionError(f"{path}: _compile_superstep gave a {type(compiled).__name__}")

    def eager_step(state):
        state[0], state[1], state[2], outputs, metrics = eager_fn(*state[:3], state[3], explore)
        return outputs, metrics

    def graph_step(state):
        state[0], state[1], state[2], outputs, metrics = compiled(*state[:3], state[3], explore)
        return outputs, metrics

    storage = [t.data_ptr() for t in tree_leaves(graph_state[2].storage)]
    patterns = _pattern_count(algo, graph_state[0], trainer.updates_per_segment)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gather.launches = 0
    calls = 0
    t0 = time.perf_counter()
    while len(compiled.graphs) < patterns and calls < 64:
        graph_step(graph_state)
        calls += 1
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    capture_peak = torch.cuda.max_memory_allocated() / 2**30
    warm_launches = gather.launches
    if len(compiled.graphs) != patterns:
        raise AssertionError(f"{path}: {len(compiled.graphs)} graphs captured in {calls} calls, {patterns} patterns")
    if warm_launches != KERNEL_LAUNCHES[path] * patterns:
        raise AssertionError(f"{path}: gather_rows_cast launched {warm_launches} times from the host in "
                             f"{patterns} warm-up supersteps")
    eager_state, spare = (_clone_run_state(*graph_state) for _ in range(2))
    # two supersteps each, from the same state
    snaps: dict[str, list] = {"eager": [], "graph": []}
    launches, replays = {}, sum(g.replays for g in compiled.graphs.values())
    for name, state, step in (("eager", eager_state, eager_step), ("graph", graph_state, graph_step)):
        gather.launches = 0
        for _ in range(2):
            outputs, metrics = step(state)
            # detached: a clone that kept an autograd edge to a parameter
            # would keep its gradient accumulator, made on this stream, alive
            # into the next capture
            snaps[name].append([(n, t.detach().clone()) for n, t in _run_leaves(state, outputs, metrics)
                                if not n.startswith("state[2].storage")])
        launches[name] = gather.launches
    if sum(g.replays for g in compiled.graphs.values()) != replays + 2 or len(compiled.graphs) != patterns:
        raise AssertionError(f"{path}: the two compared graph supersteps were not both replays")
    # a replay launches the kernel on the card, not from the host
    if launches["graph"] != 0 or launches["eager"] != 2 * KERNEL_LAUNCHES[path]:
        raise AssertionError(f"{path}: gather_rows_cast launched {launches} times from the host in two supersteps")
    differ = sorted(set(_differing(snaps["eager"][0], snaps["graph"][0])
                        + _differing(snaps["eager"][1], snaps["graph"][1])
                        + _differing(_run_leaves(eager_state), _run_leaves(graph_state))))
    # the generators advance across replays: the second superstep drew
    # other numbers than the first, as the eager second superstep did
    gens = [dict(s)["generator"] for s in snaps["graph"]] + [dict(s)["collect rng"] for s in snaps["graph"]]
    if torch.equal(gens[0], gens[1]) or torch.equal(gens[2], gens[3]):
        raise AssertionError(f"{path}: a generator did not advance between two replays")
    not_bitwise = {}
    if differ:
        # two eager runs from the same state: the ops whose results vary alone
        for _ in range(2):
            eager_step(spare)
        eager_varies = set(_differing(_run_leaves(eager_state), _run_leaves(spare)))
        # each superstep's leaves, outputs and metrics included, and the state left
        pairs = [(dict(snaps["graph"][i]), dict(snaps["eager"][i])) for i in range(2)]
        pairs.append((dict(_run_leaves(graph_state)), dict(_run_leaves(eager_state))))
        for n in differ:
            errs = []
            for got, ref in pairs:
                if n not in got or _bitwise(got[n], ref[n]):
                    continue
                if not got[n].is_floating_point():
                    raise AssertionError(f"{path}: graph and eager supersteps differ at {n}")
                errs.append(_assert_close(f"{path} graph vs eager {n}", got[n], ref[n]))
            not_bitwise[n] = {"max_abs_err": max(errs), "eager_runs_differ": n in eager_varies}
        log(f"{path}: graph vs eager not bitwise at {len(differ)} leaves, within phase 4's limits: {not_bitwise}")
    del spare, snaps
    covered = path in GRAPH_COVERED
    ms = {"eager": [], "graph": []} if not covered else None
    for name in ("eager", "graph", "graph", "eager") if not covered else ():
        state, step = (eager_state, eager_step) if name == "eager" else (graph_state, graph_step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GRAPH_TURN):
            metrics = step(state)[1]
        _read(metrics)
        ms[name].append((time.perf_counter() - t0) / GRAPH_TURN * 1e3)
    profiled = None
    if not covered:
        profiled = {"eager": eager_profile, "graph": _profile(lambda: graph_step(graph_state))}
        if len(profiled["graph"]["gather_rows_cast_ms"]) != KERNEL_LAUNCHES[path]:
            raise AssertionError(f"{path}: a profiled replay ran gather_rows_cast "
                                 f"{len(profiled['graph']['gather_rows_cast_ms'])} times, not "
                                 f"{KERNEL_LAUNCHES[path]}")
    sync_guarded(lambda: graph_step(graph_state))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    graph_step(graph_state)
    torch.cuda.synchronize()
    replay_peak = torch.cuda.max_memory_allocated() / 2**30
    if [t.data_ptr() for t in tree_leaves(graph_state[2].storage)] != storage:
        raise AssertionError(f"{path}: the ring's storage moved")
    result = {"warm_up_calls": calls, "warm_up_and_capture_s": warm_s, "warm_ups_s": compiled.warm_up_s,
              "captures_s": compiled.capture_s, "graphs": len(compiled.graphs), "patterns": patterns,
              "warm_up_gather_launches": warm_launches, "bitwise": not differ, "not_bitwise": not_bitwise,
              "capture_peak_gib": capture_peak, "replay_peak_gib": replay_peak,
              "copy_back_bytes": compiled.copy_back_bytes}
    if covered:
        log(f"{path} graph (its superstep covered by another path's: no turns, no profiles): "
            f"{len(compiled.graphs)} graph(s) for {patterns} pattern(s) in {calls} call(s), {warm_s:.2f} s (warm-up "
            f"supersteps {compiled.warm_up_s:.2f} s, captures {compiled.capture_s:.2f} s); two replays vs two eager "
            f"supersteps {'bitwise' if not differ else 'within limits'}; peak {capture_peak:.3f} GiB over the "
            f"warm-ups and captures, {replay_peak:.3f} GiB a replay; {compiled.copy_back_bytes} bytes copied back a "
            f"superstep; gather_rows_cast {warm_launches} host launches in the warm-ups; a replay under the sync "
            f"guard raised nothing")
        del compiled, eager_state, graph_state
        _fresh_memory()
        return result
    if profiled["graph"]["host_launch_calls"].get("cudaGraphLaunch", 0) + profiled["graph"]["host_launch_calls"].get(
            "cuGraphLaunch", 0) != 1 or profiled["graph"]["host_launches"] > 8:
        raise AssertionError(f"{path}: a replayed superstep's host launches {profiled['graph']}")
    busy = {k: profiled[k]["busy_ms"] / (sum(ms[k]) / len(ms[k])) for k in ("eager", "graph")}
    result.update({"ms_per_superstep_turns": ms, "profiled": profiled, "device_busy_share": busy,
                   "gather_rows_cast_per_replay_profiled": len(profiled["graph"]["gather_rows_cast_ms"])})
    log(f"{path} graph: {len(compiled.graphs)} graph(s) for {patterns} pattern(s) in {calls} call(s), "
        f"{warm_s:.2f} s (warm-up supersteps {compiled.warm_up_s:.2f} s, captures {compiled.capture_s:.2f} s); two "
        f"replays vs two eager supersteps {'bitwise' if not differ else 'within limits'}; ms a superstep in turns "
        f"eager {[round(x, 2) for x in ms['eager']]} graph {[round(x, 2) for x in ms['graph']]}; profiled: eager "
        f"(phase 5, Adam as built) {profiled['eager']['kernels']} records / {profiled['eager']['host_launches']} host "
        f"launches, graph {profiled['graph']['kernels']} records ({profiled['graph']['memsets']} memsets) / "
        f"{profiled['graph']['host_launches']} host launches {profiled['graph']['host_launch_calls']}; busy share "
        f"eager {busy['eager']:.3f} graph {busy['graph']:.3f}; peak {capture_peak:.3f} GiB over the warm-ups and "
        f"captures, {replay_peak:.3f} GiB a replay; {compiled.copy_back_bytes} bytes copied back a superstep; "
        f"gather_rows_cast {warm_launches} host launches in the warm-ups, "
        f"{len(profiled['graph']['gather_rows_cast_ms'])} device launches in a profiled replay; a replay under the "
        f"sync guard raised nothing")
    del compiled, eager_state, graph_state
    _fresh_memory()
    return result


class _LearnGraph:
    """A path of ``LEARN_GRAPH_PATHS`` with its compiled learn step and the
    eager step it replays, both over states ``[ts, cstate, bstate,
    generator]``.  :meth:`next_input` is the host paths' next segment (None
    elsewhere); :meth:`graph` writes it into the static staging (one packed
    copy) and calls the compiled step; :meth:`eager` runs the eager builder
    on a state of its own (``HostStep.device``, the host learning, the
    superstep), the segment through the eager upload.  ``start`` makes the
    compiled step over the initial state (the host paths' first segment its
    staging) and returns the first input."""

    def __init__(self, path: str):
        from tianshou_tpu_torch.utils.device import fork_generator, make_generator

        self.path, self.closing = path, []
        self.host_onpolicy = path in HOST_PATHS and path in ONPOLICY_PATHS
        self.host_offpolicy = path in HOST_PATHS and not self.host_onpolicy
        if path in OFFLINE_PATHS:
            _, self.algo, test, buffer, bstate, trainer = build_offline_path(path, "cuda")
            self.closing.append(test.venv)
            gen = make_generator(0, "cuda")
            ts = self.algo.init(fork_generator(gen))
            if hasattr(self.algo, "prepare_offline"):
                bstate = self.algo.prepare_offline(buffer, bstate)
            self.state = [ts, (), bstate, gen]
            self.updates = trainer.updates_per_superstep
        else:
            _, self.algo, col, _, trainer = build(path, **PHASE_SMALL.get(path, {}))
            self.col = col
            self.closing += [trainer.train_collector.venv, trainer.test_collector.venv]
            self.updates = trainer.updates_per_segment
            if self.host_offpolicy:
                self.loop, _ = trainer._host_setup()
                self.state = [self.loop.ts, None, self.loop.bstate, self.loop.generator]
            elif self.host_onpolicy:
                ts, gen, self.g_collect = trainer._host_setup()
                self.state = [ts, None, None, gen]
            else:
                gen = make_generator(0, "cuda")
                g_init, g_reset = fork_generator(gen), fork_generator(gen)
                cstate = col.reset(g_reset)
                self.state = [self.algo.init(g_init), cstate, None, gen]
        self.trainer = trainer
        self.eager_fn = (trainer._build_learn() if self.host_onpolicy else None if self.host_offpolicy
                         else trainer._build_superstep())

    def generators(self, state) -> list:
        """The step's generator and, on the on-policy device path, the
        collect state's."""
        rng = getattr(state[1], "rng", None)
        return [state[3]] + ([rng] if rng is not None else [])

    def next_input(self):
        if self.host_offpolicy:
            return self.loop.collect(0.0)[1]
        if self.host_onpolicy:
            return self.col.collect(self.state[0], None, self.trainer.segment_len, self.g_collect, explore=True,
                                    record_traj=True)[2]
        return None

    def start(self):
        """The compiled step over the initial state; returns the first
        input (written into the staging)."""
        t, (ts, cstate, bstate, _) = self.trainer, self.state
        inp = self.next_input()
        if self.host_offpolicy:
            self.compiled = t._compile_host_step(self.loop.host_step, ts, bstate, self.loop.host_step.upload(inp))
        elif self.host_onpolicy:
            self.compiled = t._compile_learn(ts, self.col.upload(inp))
        elif self.path in OFFLINE_PATHS:
            self.compiled = t._compile_superstep(ts, bstate)
        else:
            self.compiled = t._compile_superstep(ts, cstate)
        if self.host_onpolicy or self.host_offpolicy:
            self.state[1] = self.compiled.cstate
        return inp

    def stage(self, inp) -> None:
        """``inp`` into the static staging: the segment's one packed copy."""
        if self.host_offpolicy:
            self.loop.host_step.upload(inp, self.state[1])
        elif self.host_onpolicy:
            self.col.upload(inp, self.state[1])

    def replay(self):
        """The compiled step on the graph's state as staged: ``(outputs,
        metrics)``."""
        st = self.state
        st[0], st[1], st[2], outputs, metrics = self.compiled(*st[:3], st[3], 0.0)
        return outputs, metrics

    def graph(self, inp):
        self.stage(inp)
        return self.replay()

    def eager(self, state, inp):
        fn = self.eager_fn
        if self.host_offpolicy:
            hs = self.loop.host_step
            state[0], state[2], metrics = hs.device(state[0], state[2], hs.upload(inp), state[3])
            return None, metrics
        if self.host_onpolicy:
            state[0], metrics = fn(state[0], self.col.unpack(self.col.upload(inp)), state[3])
            return None, metrics
        if self.path in OFFLINE_PATHS:
            state[0], state[2], metrics = fn(state[0], state[2], state[3])
            return None, metrics
        state[0], state[1], outputs, metrics = fn(state[0], state[1], state[3])
        return outputs, metrics

    def clone(self) -> list:
        """The graph's state copied for the eager steps (the host paths'
        staging left out: their input comes from the segment), its
        generators too."""
        st = self.state
        memo = {id(g): _copy_generator(g) for g in self.generators(st)}
        device_cstate = not (self.host_onpolicy or self.host_offpolicy)
        ts, cstate, bstate = copy.deepcopy((st[0], st[1] if device_cstate else None, st[2]), memo)
        return [ts, cstate, bstate, memo[id(st[3])]]

    def leaves(self, state, outputs=None, metrics=None) -> list:
        from tianshou_tpu_torch.data.tree import tree_leaves
        from tianshou_tpu_torch.utils.graphs import named_tensors

        device_cstate = not (self.host_onpolicy or self.host_offpolicy)
        out = named_tensors((state[0], state[1] if device_cstate else None, state[2]))
        out += [(f"generator[{i}]", g.get_state()) for i, g in enumerate(self.generators(state))]
        if outputs is not None:
            out += [(f"outputs[{i}]", t) for i, t in enumerate(tree_leaves(outputs))]
        return out + [(f"metrics[{k!r}]", v) for k, v in (metrics or {}).items()]

    def close(self) -> None:
        for venv in self.closing:
            if hasattr(venv, "close"):
                venv.close()


def _capture_stream_setup_bytes(lg: _LearnGraph) -> int:
    """The bytes that one eager step of ``lg``'s path, run on a copy of its
    state on the capture stream (``utils.graphs.capture_stream``), leaves
    allocated once the copy is freed: the workspaces that cuBLAS and
    cuBLASLt keep for that stream (held for the process; 0 where an earlier
    capture set them up), made before the warm-up so that the capture's
    peak shows what the capture itself holds."""
    from tianshou_tpu_torch.utils.graphs import capture_stream, named_tensors

    inp = lg.next_input()  # a host segment's collection (its acting graph's capture) outside the count
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    state = lg.clone()
    stream = capture_stream(named_tensors(state[0])[0][1].device)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        lg.eager(state, inp)
    torch.cuda.current_stream().wait_stream(stream)
    del state, inp
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() - before


def phase_learn_graph(path: str, gather, eager_peak: float, eager_base: float) -> dict:
    """A compiled learn step of slice 15 (``LEARN_GRAPH_PATHS``) at full
    width: the offline superstep, the on-policy superstep, the on-policy
    host learn or the off-policy host step, each a CUDA graph of its eager
    builder (:class:`_LearnGraph`).  First the compiled step's first call
    (the capture's warm-up, then the capture; its times and peak memory:
    above the memory allocated when the phase began, at most 1.2x phase 5's
    ``eager_peak`` above its own ``eager_base``, once the capture stream's
    library workspaces are counted apart, :func:`_capture_stream_setup_bytes`:
    what earlier phases leave allocated, other streams' workspaces among
    it, moves both bases); from copies
    of the state it leaves, two eager steps against two replays on the same
    inputs, bitwise in every carried tensor, the generators' states,
    ``outputs`` and ``metrics`` (a leaf that is not bitwise is held to phase
    4's limits and named); ms a step in turns (eager, graph, graph, eager;
    the host paths' steps take a segment collected before, through its
    upload); one eager step (its optimizers capturable as the graph's) and
    one replay profiled (kernels, busy time, host launch calls); one replay
    under the sync guard; peak memory a replay; bytes copied back; the
    storage of the ring or dataset unmoved.  ``ppo_host``'s learning rate
    follows its schedule across replays; ``atari_host`` runs
    ``gather_rows_cast`` twice in a profiled replay, none from the host."""
    from tianshou_tpu_torch.data.tree import tree_leaves
    from tianshou_tpu_torch.utils.graphs import CapturedStep, optimizers, prepare_optimizer

    _fresh_memory()
    base = torch.cuda.memory_allocated() / 2**30
    lg = _LearnGraph(path)
    want = KERNEL_LAUNCHES[path]
    storage = ([t.data_ptr() for t in tree_leaves(lg.state[2].storage)] if lg.state[2] is not None else [])
    workspace = _capture_stream_setup_bytes(lg) / 2**30
    torch.cuda.reset_peak_memory_stats()
    gather.launches = 0
    t0 = time.perf_counter()
    lg.start()
    if not isinstance(lg.compiled, CapturedStep):
        raise AssertionError(f"{path}: the trainer compiled a {type(lg.compiled).__name__}")
    patterns = _pattern_count(lg.algo, lg.state[0], lg.updates)
    calls = 0
    while len(lg.compiled.graphs) < patterns and calls < 64:
        lg.replay() if calls == 0 else lg.graph(lg.next_input())
        calls += 1
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    capture_peak = torch.cuda.max_memory_allocated() / 2**30
    warm_launches = gather.launches
    if len(lg.compiled.graphs) != patterns or warm_launches != want * patterns:
        raise AssertionError(f"{path}: {len(lg.compiled.graphs)} graphs for {patterns} patterns in {calls} calls, "
                             f"gather_rows_cast launched {warm_launches} times from the host")
    lr_seen = []
    eager_state = lg.clone()
    for opt in optimizers(eager_state[0]):  # as the capture made the graph's
        prepare_optimizer(opt)
    inputs = [lg.next_input() for _ in range(2)]
    snaps: dict[str, list] = {"eager": [], "graph": []}
    launches, replays = {}, sum(g.replays for g in lg.compiled.graphs.values())
    for name in ("eager", "graph"):
        gather.launches = 0
        for x in inputs:
            outputs, metrics = lg.eager(eager_state, x) if name == "eager" else lg.graph(x)
            state = eager_state if name == "eager" else lg.state
            snaps[name].append([(n, t.detach().clone()) for n, t in lg.leaves(state, outputs, metrics)
                                if not n.startswith("state[2].storage")])
            if name == "graph" and path == "ppo_host":
                lr_seen.append(lg.state[0].optimizer.param_groups[0]["lr"].clone())
        launches[name] = gather.launches
    if sum(g.replays for g in lg.compiled.graphs.values()) != replays + 2:
        raise AssertionError(f"{path}: the two compared graph steps were not both replays")
    if launches["graph"] != 0 or launches["eager"] != 2 * want:
        raise AssertionError(f"{path}: gather_rows_cast launched {launches} times from the host in two steps")
    differ = sorted(set(_differing(snaps["eager"][0], snaps["graph"][0])
                        + _differing(snaps["eager"][1], snaps["graph"][1])
                        + _differing(lg.leaves(eager_state), lg.leaves(lg.state))))
    gens = [[v for n, v in s if n.startswith("generator[")] for s in snaps["graph"]]
    if any(torch.equal(a, b) for a, b in zip(*gens)):
        raise AssertionError(f"{path}: a generator did not advance between two replays")
    not_bitwise = {}
    for n in differ:
        errs = []
        for i in range(2):
            got, ref = dict(snaps["graph"][i]), dict(snaps["eager"][i])
            if n in got and not _bitwise(got[n], ref[n]):
                if not got[n].is_floating_point():
                    raise AssertionError(f"{path}: graph and eager steps differ at {n}")
                errs.append(_assert_close(f"{path} graph vs eager {n}", got[n], ref[n]))
        not_bitwise[n] = {"max_abs_err": max(errs, default=0.0)}
    if differ:
        log(f"{path}: learn graph vs eager not bitwise at {len(differ)} leaves, within phase 4's limits: "
            f"{not_bitwise}")
    del snaps
    x = inputs[-1]
    ms = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = (lg.eager(eager_state, x) if name == "eager" else lg.graph(x))[1]
        _read(metrics)
        ms[name].append((time.perf_counter() - t0) * 1e3)
    profiled = {"eager_capturable": _profile(lambda: lg.eager(eager_state, x)),
                "graph": _profile(lambda: lg.graph(x))}
    host_calls = profiled["graph"]["host_launch_calls"]
    if (host_calls.get("cudaGraphLaunch", 0) + host_calls.get("cuGraphLaunch", 0) != 1
            or profiled["graph"]["host_launches"] > LEARN_REPLAY_HOST_LAUNCHES):
        raise AssertionError(f"{path}: a replayed learn step's host launches {profiled['graph']}")
    if len(profiled["graph"]["gather_rows_cast_ms"]) != want:
        raise AssertionError(f"{path}: a profiled replay ran gather_rows_cast "
                             f"{len(profiled['graph']['gather_rows_cast_ms'])} times, not {want}")
    del eager_state  # the eager steps' copy of the state (a ring, a dataset) outside the replay's peak
    lg.stage(lg.next_input())
    sync_guarded(lg.replay)
    lg.stage(lg.next_input())  # the segment's collection (acting) and copy outside the replay's peak
    _fresh_memory()
    torch.cuda.reset_peak_memory_stats()
    lg.replay()
    torch.cuda.synchronize()
    replay_peak = torch.cuda.max_memory_allocated() / 2**30
    if lg.state[2] is not None and [t.data_ptr() for t in tree_leaves(lg.state[2].storage)] != storage:
        raise AssertionError(f"{path}: the storage of the ring or dataset moved")
    if capture_peak - base - workspace > 1.2 * (eager_peak - eager_base):
        raise AssertionError(f"{path}: peak {capture_peak:.3f} GiB over the warm-up and capture on {base:.3f} allocated "
                             f"before ({workspace:.3f} of it the capture stream's library workspaces), above 1.2x the "
                             f"eager {eager_peak:.3f} on {eager_base:.3f}")
    result = {"warm_up_and_capture_s": warm_s, "warm_ups_s": lg.compiled.warm_up_s,
              "captures_s": lg.compiled.capture_s, "graphs": len(lg.compiled.graphs), "patterns": patterns,
              "warm_up_gather_launches": warm_launches, "bitwise": not differ, "not_bitwise": not_bitwise,
              "ms_per_step_turns": ms, "profiled": profiled,
              "device_busy_share": {k: profiled[k]["busy_ms"] / (sum(ms[m]) / len(ms[m]))
                                    for k, m in (("eager_capturable", "eager"), ("graph", "graph"))},
              "eager_peak_gib": eager_peak, "capture_peak_gib": capture_peak, "replay_peak_gib": replay_peak,
              "eager_base_gib": eager_base, "base_gib": base, "capture_stream_workspace_gib": workspace,
              "copy_back_bytes": lg.compiled.copy_back_bytes,
              "gather_rows_cast_per_replay_profiled": len(profiled["graph"]["gather_rows_cast_ms"])}
    if path == "ppo_host":
        # the schedule's rate for the last update, from the host update count
        ts = lg.state[0]
        lr = ts.optimizer.param_groups[0]["lr"]
        expect = lg.algo.lr(torch.tensor(ts.step - 1, device=lr.device))
        if not _bitwise(lr, expect.to(lr.dtype)) or torch.equal(lr_seen[0], lr) or int(ts.lr_count) != ts.step:
            raise AssertionError(f"{path}: learning rate {float(lr)} after {ts.step} updates (schedule "
                                 f"{float(expect)}; first replay's {float(lr_seen[0])})")
        result["learning_rate"] = {"first_replay": float(lr_seen[0]), "last": float(lr), "updates": ts.step}
        log(f"{path}: learning rate {float(lr_seen[0]):.9g} after the first compared replay, {float(lr):.9g} "
            f"after {ts.step} updates, the schedule's at that count bitwise")
    if path in OFFLINE_PATHS:
        result["dataset_gb"] = sum(x.numel() * x.element_size() for x in tree_leaves(lg.state[2].storage)) / 1e9
    log(f"{path} learn graph ({type(lg.trainer).__name__}): {len(lg.compiled.graphs)} graph(s) in {calls} "
        f"call(s), {warm_s:.2f} s (warm-up {lg.compiled.warm_up_s:.2f} s, capture {lg.compiled.capture_s:.2f} s); "
        f"two replays vs two eager steps {'bitwise' if not differ else 'within limits'}; ms a step in turns eager "
        f"{[round(v, 2) for v in ms['eager']]} graph {[round(v, 2) for v in ms['graph']]}; profiled: eager "
        f"(capturable optimizers) {profiled['eager_capturable']['kernels']} records / "
        f"{profiled['eager_capturable']['host_launches']} host launches, graph {profiled['graph']['kernels']} "
        f"records / {profiled['graph']['host_launches']} host launches {host_calls}; busy share eager "
        f"{result['device_busy_share']['eager_capturable']:.3f} graph {result['device_busy_share']['graph']:.3f}; "
        f"peak {eager_peak:.3f} GiB eager (phase 5, on {eager_base:.3f} allocated before it), {capture_peak:.3f} over "
        f"the warm-up and capture (on {base:.3f}; the capture stream's library workspaces {workspace:.3f} of it), "
        f"{replay_peak:.3f} a replay; "
        f"{lg.compiled.copy_back_bytes} bytes copied back a step; gather_rows_cast "
        f"{warm_launches} host launches in the warm-up, {len(profiled['graph']['gather_rows_cast_ms'])} device "
        f"launches in a profiled replay; the storage unmoved; a replay under the sync guard raised nothing")
    lg.close()
    del lg
    _fresh_memory()
    return result


def check_policy(path: str, algo, ts, obs, gen, env, policy_state=()) -> None:
    """The trained policy's outputs on the last observations: finite
    Q-values of the right shape (the DQN family over ``Discrete`` actions);
    else finite greedy actions of the action space's shape, in [-1, 1] for
    the off-policy continuous actors and legal for a discrete space, acting
    from ``policy_state`` (a recurrent policy's carries, which must come out
    finite)."""
    space = env.action_space
    if path == "marl_tictactoe":
        # the manager acts for the agent to move, legally under the mask
        with torch.no_grad():
            act = algo.act(ts, obs, gen, explore=False)
        legal = obs["mask"][torch.arange(act.shape[0], device=act.device), act]
        if tuple(act.shape) != (obs["mask"].shape[0],) or not bool((legal > 0).all()):
            raise AssertionError(f"{path}: illegal or misshapen actions {act}")
        return
    q_values = (path in DQN_PATHS and path not in ("bdq_pendulum", "drqn_cartpole")) or path == "discrete_cql_cartpole"
    with torch.no_grad():
        if q_values:
            out, state = algo.q_values(ts.online, obs), ()
        else:
            out, _, state = algo.act_with_state(ts, obs, policy_state, gen, explore=False)
    shape = (obs.shape[0],) + ((space.n,) if q_values else tuple(space.shape))
    if tuple(out.shape) != shape or not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"{path}: bad policy output: {tuple(out.shape)}, expected {shape}")
    if not all(bool(torch.isfinite(x).all()) for x in state):
        raise AssertionError(f"{path}: non-finite policy state")
    if family(path) in ("continuous", "redq", "cql") and out.is_floating_point() and float(out.abs().max()) > 1.0:
        raise AssertionError(f"{path}: actions outside [-1, 1]")
    if not out.is_floating_point() and not space.contains(out):
        raise AssertionError(f"{path}: illegal discrete actions")


class _OffPolicyHost:
    """A segment of ``sac_host`` in its parts, through the trainer's host
    loop: :meth:`collect` on the host envs, :meth:`upload` (the one packed
    copy), :meth:`device` (unpack, ``add_trajectory`` and the updates)."""

    def __init__(self, trainer):
        self.loop, _ = trainer._host_setup()

    @property
    def ts(self):
        return self.loop.ts

    @property
    def generator(self):
        return self.loop.generator

    def collect(self):
        return self.loop.collect(0.0)[1]

    def upload(self, traj):
        return self.loop.host_step.upload(traj)

    def device(self, uploaded):
        lp = self.loop
        lp.ts, lp.bstate, lp.metrics = lp.host_step.device(lp.ts, lp.bstate, uploaded, lp.generator)
        lp.ts_act = lp.ts
        return lp.metrics


class _OnPolicyHost:
    """A segment of ``ppo_host`` in the same parts: :meth:`device` unpacks
    and learns (every processing pass and the minibatch updates)."""

    def __init__(self, trainer):
        self.ts, self.generator, self._g_collect = trainer._host_setup()
        self._learn = trainer._build_learn()
        self._col, self._segment = trainer.train_collector, trainer.segment_len

    def collect(self):
        return self._col.collect(self.ts, None, self._segment, self._g_collect, explore=True, record_traj=True)[2]

    def upload(self, traj):
        return self._col.upload(traj)

    def device(self, uploaded):
        self.ts, metrics = self._learn(self.ts, self._col.unpack(uploaded), self.generator)
        return metrics


def phase_host(path: str, gather) -> dict:
    """A host-env path at full width: 1 warm-up and 2 timed segments
    (collect on the host envs, one packed copy, the device part), the device
    part of one more under the sync guard, one in which PyTorch must
    dispatch exactly one host-to-device copy (the packed segment), one under
    the profiler, the breakdown, and for ``sac_host`` segments with
    ``pipeline_host_updates`` on and off in turns."""
    from tianshou_tpu_torch.data.tree import tree_leaves
    from tianshou_tpu_torch.utils.transfer import TreePacker

    cfg = PATHS[path]
    onpolicy = path in ONPOLICY_PATHS
    _fresh_memory()
    base = torch.cuda.memory_allocated() / 2**30
    env, algo, col, _, trainer = build(path, **PHASE_SMALL.get(path, {}))
    hp = (_OnPolicyHost if onpolicy else _OffPolicyHost)(trainer)
    n, steps = TIMED_COMPILED if path in COMPILED_PATHS else TIMED, cfg["num_envs"] * cfg["segment"]
    gather.launches = 0
    copies = TreePacker.copies
    dt, metrics = timed(lambda: hp.device(hp.upload(hp.collect())), n)
    copies = TreePacker.copies - copies
    launches = gather.launches
    if launches != KERNEL_LAUNCHES[path] * (n + WARMUP) or copies != n + WARMUP:
        raise AssertionError(f"{path}: {copies} packed copies and {launches} gather launches in {n + WARMUP} "
                             "segments")
    _check_metrics(path, metrics)

    # the device part of a segment makes no host synchronisation
    uploaded = hp.upload(hp.collect())
    sync_guarded(lambda: hp.device(uploaded))

    # exactly one host-to-device copy in a segment's upload and device part:
    # every tensor copy from the host that PyTorch dispatches is counted (the
    # profiler's device trace loses this copy's record in a long process,
    # while its runtime call is always traced)
    traj = hp.collect()
    floats = sum(np.size(x) for x in tree_leaves(traj) if isinstance(x, np.ndarray))
    with _HostToDeviceCopies() as h2d:
        hp.device(hp.upload(traj))
    if h2d.copies != [(floats,)]:
        raise AssertionError(f"{path}: host-to-device copies in a segment, not one of {floats} floats: "
                             f"{h2d.copies}")
    kernels = busy_ms = None
    if path not in LEARN_GRAPH_PATHS:
        traj = hp.collect()
        kernels, busy_ms = _profile_counts(lambda: hp.device(hp.upload(traj)))
    check_policy(path, algo, hp.ts, torch.as_tensor(col.obs, device=algo.device), hp.generator, env)
    peak = torch.cuda.max_memory_allocated() / 2**30

    held = {}

    def collect():
        held["traj"] = hp.collect()

    def upload():
        held["up"] = hp.upload(held["traj"])

    parts = {"host collect": collect, "pack + copy": upload}
    if onpolicy:
        parts["processing pass"] = lambda: algo.process_rollout(hp.ts, col.unpack(held["up"]))
    parts["device part"] = lambda: hp.device(held["up"])
    reps = BREAKDOWN_REPS_COMPILED if path in COMPILED_PATHS else BREAKDOWN_REPS
    result = {"env_steps_per_s": n * steps / dt, "ms_per_segment": dt / n * 1e3, **metrics,
              "updates_per_segment": cfg["updates"], "h2d_copies_per_segment": len(h2d.copies),
              "gather_rows_cast_per_segment": launches / (n + WARMUP),
              "device_kernels_per_segment": kernels, "device_busy_ms_per_segment_profiled": busy_ms,
              "max_memory_allocated_gib": peak, "memory_base_gib": base, "breakdown_ms": breakdown(parts, reps)}
    log(f"{path}: {n} segments of {cfg['num_envs']} host envs x {cfg['segment']} steps + {cfg['updates']} updates "
        f"of batch {cfg['batch']}: {result['env_steps_per_s']:.1f} env-steps/s, {result['ms_per_segment']:.2f} ms "
        f"per segment, metrics {metrics}, {copies} packed copies and {launches} gather_rows_cast launches in "
        f"{n + WARMUP}, "
        f"max_memory_allocated {peak:.3f} GiB; the device part under torch.cuda.set_sync_debug_mode('error') raised "
        f"no host sync; one host-to-device copy dispatched in a segment ({floats} floats)"
        + (f"; {kernels} device kernels and device busy {busy_ms:.2f} ms in its device part" if kernels else ""))
    if onpolicy:
        result["processing_passes_per_segment"] = _processing_passes(algo, cfg["repeat"])
    log(f"{path} breakdown (median of {reps}, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in result["breakdown_ms"].items()))
    closing = [trainer]
    if path == "sac_host":
        result["pipeline_ms_per_segment"], piped_trainer = _pipeline_turns(path, hp.loop, n)
        closing.append(piped_trainer)
    for t in closing:
        t.train_collector.venv.close()
        t.test_collector.venv.close()
    return result


def _pipeline_turns(path: str, loop, n: int):
    """``pipeline_host_updates``: segments with acting on a side stream from
    a snapshot of the actor, in turns with ``loop``'s sequential ones: the
    mean ms a segment of each, and the pipelined trainer."""

    def segments(lp, k):
        for _ in range(k):
            _, traj = lp.collect(0.0)
            lp.update(traj)
        lp.read_metrics()  # synchronises

    _, _, _, _, piped_trainer = build_path(path, "cuda", pipeline=True)
    piped, _ = piped_trainer._host_setup()
    segments(piped, 2)
    segments(loop, 2)  # each loop's first segment is its host step's capture
    turns = {"sequential": [], "pipelined": []}
    for name in ("sequential", "pipelined", "pipelined", "sequential"):
        lp = loop if name == "sequential" else piped
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        segments(lp, n)
        turns[name].append((time.perf_counter() - t0) / n * 1e3)
    means = {k: sum(v) / len(v) for k, v in turns.items()}
    log(f"{path} pipeline_host_updates (ms a segment, mean of 2 turns of {n}, order seq/pipe/pipe/seq): "
        + ", ".join(f"{k} {v:.2f} ({', '.join(f'{x:.2f}' for x in turns[k])})" for k, v in means.items()))
    return means, piped_trainer


def _run_captures(path: str, trainer, supersteps: int) -> int:
    """The graphs that ``trainer.run()`` captured, on a path of
    ``COMPILED_PATHS`` (0 elsewhere): each of its supersteps (segments) must
    have been a pattern's first call (run eagerly as its capture's warm-up)
    or a replay, and at least one a replay.  The compiled step is the
    superstep, or on the host paths the learning or the host step."""
    from tianshou_tpu_torch.utils.graphs import CapturedStep

    if path not in COMPILED_PATHS:
        return 0
    compiled = next((c for c in (getattr(trainer, name, None) for name in (
        "compiled_superstep", "compiled_learn", "compiled_host_step")) if c is not None), None)
    if not isinstance(compiled, CapturedStep):
        raise AssertionError(f"{path}: run() did not launch the compiled superstep ({type(compiled).__name__})")
    captures, replays = len(compiled.graphs), sum(g.replays for g in compiled.graphs.values())
    if captures + replays != supersteps or not replays:
        raise AssertionError(f"{path}: run() made {captures} captures and {replays} replays in {supersteps} "
                             f"supersteps")
    log(f"{path} run(): {supersteps} supersteps, {captures} of them a pattern's warm-up before its capture "
        f"({compiled.warm_up_s:.2f} s, captures {compiled.capture_s:.2f} s), {replays} replays")
    return captures


def _counted_run(path: str, gather, run, segtree: dict | None = None):
    """``run()`` with ``gather``'s count set to 0 just before it: its
    result, the count read just after it (the wrapper's launches from the
    host) and, where the path's superstep runs the kernel inside a CUDA
    graph (``COMPILED_PATHS``), the kernel's device records in the profiler
    over the same run (the host's launches and the replays' alike; None
    elsewhere).  With ``segtree`` (a dict; the prioritized paths) the sum
    tree's the same way: its wrappers' counts set to 0 just before ``run()``
    and read just after it into ``segtree["host"]``, the profiler's records
    of its two kernels over the run into ``segtree["card"]``."""
    from tianshou_tpu_torch.ops import segtree as st

    gather.launches = 0
    profile_gather = path in COMPILED_PATHS and bool(KERNEL_LAUNCHES[path])
    if segtree is not None:
        st.segtree_draw.launches = st.segtree_update.launches = 0
    elif not profile_gather:
        out = run()
        return out, gather.launches, None
    result = []
    records = _device_records(lambda: result.append(run()))
    if segtree is not None:
        segtree["host"] = {"draw": st.segtree_draw.launches, "update": st.segtree_update.launches}
        segtree["card"] = {op: sum(f"segtree_{op}_kernel" in e.name() for e in records) for op in ("draw", "update")}
    device = sum("gather_rows_cast" in e.name() for e in records) if profile_gather else None
    return result[0], gather.launches, device


# the sum tree's launches in each prioritized path's main run, host and
# card, as _check_segtree_run found them
SEGTREE_RUNS: dict[str, dict] = {}


def _check_segtree_run(path: str, counts: dict, supersteps: int, captures: int) -> None:
    """Holds a prioritized path's main run (``_counted_run``'s ``segtree``)
    to its sum-tree launches: on the card, every superstep's one draw an
    update, one write-back an update and one add a rollout step, and one add
    a step of the warm-up's ring fill; from the host, the same of the eager
    steps only (the ring fill and the ``captures`` supersteps that warmed a
    capture up; a capture and its replays launch nothing from the host)."""
    cfg = PATHS[DIST_PATHS.get(path, path)]
    fill = cfg.get("warmup", 0) // cfg["num_envs"]
    want = {side: {"draw": cfg["updates"] * n, "update": fill + (cfg["segment"] + cfg["updates"]) * n}
            for side, n in (("card", supersteps), ("host", captures))}
    got = {side: counts[side] for side in want}
    if got != want:
        raise AssertionError(f"{path}: the sum tree's kernels launched {got} in run() ({supersteps} supersteps, "
                             f"{captures} warm-ups, a ring fill of {fill} steps), not {want}")
    log(f"{path} run(): the sum tree's kernels {got['card']} on the card, {got['host']} from the host")
    SEGTREE_RUNS[path] = got


def _run_launches(path: str, host: int, device: int | None, supersteps: int, captures: int) -> int:
    """The kernel's launches in a main run of ``supersteps`` supersteps,
    ``captures`` of them a capture's eager warm-up: from the host, the
    warm-ups' (every superstep's off the graph paths); on the card (the
    profiler), every superstep's.  Returns the launches the card ran."""
    want = KERNEL_LAUNCHES[path]
    if host != want * (captures if path in COMPILED_PATHS else supersteps):
        raise AssertionError(f"{path}: gather_rows_cast launched {host} times from the host in run() "
                             f"({supersteps} supersteps, {captures} warm-ups)")
    if device is not None and device != want * supersteps:
        raise AssertionError(f"{path}: the profiler saw gather_rows_cast run {device} times in run(), "
                             f"not {want * supersteps}")
    return host if device is None else device


def phase_main_path(path: str, gather) -> int:
    """The trainer's ``run()`` on the path for one epoch of two supersteps
    (segments; ``main_supersteps`` where the path sets it) with a test
    phase; the launch count is read over exactly that run."""
    cfg = PATHS[path]
    trainer = build_offline_path(path, "cuda")[-1] if path in OFFLINE_PATHS else build(path)[-1]
    segtree = {} if path in PER_PATHS else None
    info, host, device = _counted_run(path, gather, trainer.run, segtree)
    log(f"{path} {type(trainer).__name__}.run(): {info}")
    supersteps = cfg.get("main_supersteps", 2)
    captures = _run_captures(path, trainer, supersteps)
    launches = _run_launches(path, host, device, supersteps, captures)
    if segtree is not None:
        _check_segtree_run(path, segtree, supersteps, captures)
    if path in OFFLINE_PATHS:
        # the offline accounting: env_step = gradient_step * batch
        env_steps = supersteps * cfg["updates"] * cfg["batch"]
    else:
        warmup = cfg.get("warmup", 0) // cfg["num_envs"] * cfg["num_envs"]  # whole steps of every env
        env_steps = warmup + supersteps * cfg["num_envs"] * cfg["segment"]
    if info.env_step != env_steps or info.gradient_step != supersteps * cfg["updates"]:
        raise AssertionError(f"{path}: counters env_step={info.env_step} gradient_step={info.gradient_step}")
    _check_metrics(path, info.last_metrics)
    if not math.isfinite(info.best_reward):
        raise AssertionError(f"{path}: non-finite best reward: {info}")
    if path in FUSED_PATHS and not trainer.last_run_used_fused:
        raise AssertionError(f"{path}: run() did not take the fused fine cycle")
    _run_collection(path, trainer)
    if path in HOST_PATHS + FUSED_PATHS:
        trainer.train_collector.venv.close()
        trainer.test_collector.venv.close()
    if path == "cql_d4rl":
        trainer.test_collector.venv.close()
    return launches


def build_onpolicy_path(path: str, device):
    """An on-policy path through the port's entry points: ``(env, algo,
    train collector, None, trainer)``, the shape of :func:`build_path`'s."""
    from tianshou_tpu_torch.algos.npg import TRPO
    from tianshou_tpu_torch.algos.pg import linear_schedule
    from tianshou_tpu_torch.algos.ppo import PPO
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.networks.continuous import GaussianActor, ValueNet
    from tianshou_tpu_torch.trainer.onpolicy import OnPolicyTrainer

    cfg = PATHS[path]
    hidden = (64, 64)
    if path == "ppo_cartpole":
        from tianshou_tpu_torch.envs.classic import CartPole

        env = CartPole()
        algo = PPO(QNet(4, hidden, 2), ValueNet(4, hidden), env.action_space, lr=3e-4, gamma=0.99, gae_lambda=0.95,
                   max_grad_norm=0.5, ent_coef=0.0, device=device)
    elif path == "trpo_pendulum":
        from tianshou_tpu_torch.envs.classic import Pendulum

        env = Pendulum()
        algo = TRPO(GaussianActor(3, hidden, 1), ValueNet(3, hidden), env.action_space, device=device, **TRPO_PENDULUM)
    elif path == "ppo_host":
        env = HalfCheetahStandIn()
        algo = PPO(GaussianActor(env.OBS_DIM, hidden, env.ACT_DIM, sigma_init=-0.5), ValueNet(env.OBS_DIM, hidden),
                   env.action_space, lr=linear_schedule(3e-4, 0.0, PPO_HOST_DECAY_UPDATES), gamma=0.99,
                   gae_lambda=0.95, eps_clip=0.2, vf_coef=0.25, ent_coef=0.0, max_grad_norm=0.5, adv_norm=False,
                   ret_norm=True, recompute_advantage=True, device=device)
    elif path == "gail_pendulum":
        # tests/test_offline_e2e.py:225-261
        from tianshou_tpu_torch.algos.gail import GAIL
        from tianshou_tpu_torch.envs.classic import Pendulum
        from tianshou_tpu_torch.networks.continuous import Critic

        env = Pendulum()
        ebuf, ebs = pendulum_expert_ring(device, cfg["expert_envs"], cfg["expert_capacity"])
        algo = GAIL(GaussianActor(3, hidden, 1), ValueNet(3, hidden), env.action_space, disc_net=Critic(3, 1, hidden),
                    expert_buffer=ebuf, expert_buffer_state=ebs, disc_lr=2.5e-4, disc_update_num=2, lr=3e-4,
                    gamma=0.95, gae_lambda=0.95, max_grad_norm=0.5, ent_coef=0.0, device=device)
    else:
        raise ValueError(f"unknown on-policy path {path!r}; have {ONPOLICY_PATHS}")
    if path in HOST_PATHS:
        from tianshou_tpu_torch.collect.host_collector import HostCollector
        from tianshou_tpu_torch.envs.host import NormObsHostVectorEnv

        train_venv = NormObsHostVectorEnv([HalfCheetahStandIn] * cfg["num_envs"])
        test_venv = NormObsHostVectorEnv([HalfCheetahStandIn] * cfg["test_envs"], update_rms=False)
        test_venv.set_rms(train_venv.get_rms())  # the test envs read the live statistics
        train = HostCollector(algo, train_venv, device=device)
        test = HostCollector(algo, test_venv, device=device)
    else:
        train = Collector(algo, VectorEnv(env, cfg["num_envs"], device=device), device=device)
        test = Collector(algo, VectorEnv(env, cfg["test_envs"], device=device), device=device)
    steps = cfg["num_envs"] * cfg["segment"]
    trainer = OnPolicyTrainer(algo, train, test, max_epoch=1, step_per_epoch=2 * steps, step_per_collect=steps,
                              repeat_per_collect=cfg["repeat"], batch_size=cfg["batch"],
                              episode_per_test=cfg["episodes"], device=device)
    if (trainer.segment_len, trainer.updates_per_segment) != (cfg["segment"], cfg["updates"]):
        raise AssertionError(f"trainer split {trainer.segment_len} steps / {trainer.updates_per_segment} updates")
    return env, algo, train, None, trainer


def build(path: str, **small):
    """A path at full width on the card: ``(env, algo, train collector,
    buffer or None, trainer)``; ``small`` overrides an off-policy path's
    sizes (:func:`build_path`)."""
    if path in HIGHLEVEL_PATHS:
        world = highlevel_experiment(path).build_world(logger=memory_logger())
        trainer, cfg = world.trainer, PATHS[path]
        wired = (trainer.segment_len, trainer.updates_per_segment, trainer.batch_size, trainer.buffer.capacity)
        if wired != (cfg["segment"], cfg["updates"], cfg["batch"], cfg["capacity"]):
            raise AssertionError(f"{path}: the builder wired (segment, updates, batch, capacity) {wired}")
        return world.envs.train_venv.env, world.algo, trainer.train_collector, trainer.buffer, trainer
    return build_onpolicy_path(path, "cuda") if path in ONPOLICY_PATHS else build_path(path, "cuda", **small)


def memory_logger():
    """A logger that keeps its writes in memory (the card's machine has no
    tensorboard): the writes' steps and keys, the saved counters, and those
    counters back for a resumed run.  The default intervals of
    ``BaseLogger``."""
    from tianshou_tpu_torch.utils.logger import BaseLogger

    class MemoryLogger(BaseLogger):
        def __init__(self):
            super().__init__()
            self.writes: list[tuple[int, tuple[str, ...]]] = []
            self.saves: list[tuple[int, int, int]] = []

        def write(self, step, data):
            self.writes.append((step, tuple(sorted(data))))

        def save_data(self, epoch, env_step, gradient_step, save_checkpoint_fn=None):
            self.saves.append((epoch, env_step, gradient_step))
            super().save_data(epoch, env_step, gradient_step, save_checkpoint_fn)

        def restore_data(self):
            return self.saves[-1] if self.saves else (0, 0, 0)

    return MemoryLogger()


def highlevel_experiment(path: str, **sampling):
    """A high-level path's experiment through the port's public builders, on
    the card, logging nowhere but the logger ``run`` is given; ``sampling``
    overrides ``SamplingConfig`` fields."""
    from tianshou_tpu_torch.envs.synthetic import SyntheticPixelEnv
    from tianshou_tpu_torch.highlevel.config import SamplingConfig
    from tianshou_tpu_torch.highlevel.env import TorchEnvFactory
    from tianshou_tpu_torch.highlevel.experiment import DQNExperimentBuilder, DQNParams, ExperimentConfig

    cfg = PATHS[path]
    if path == "hl_cartpole":
        # README.md's Quick start as published, cut to one epoch
        factory, params = TorchEnvFactory("CartPole-v1"), DQNParams()
        base = SamplingConfig(num_epochs=10, step_per_epoch=10000, step_per_collect=100, update_per_step=0.1)
    else:
        # the atari path (bench.py's atari stage) through the same builder
        steps = cfg["num_envs"] * cfg["segment"]
        factory, params = TorchEnvFactory(SyntheticPixelEnv(84, 84, 4)), DQNParams(
            gamma=0.99, n_step=3, target_update_freq=1000)
        base = SamplingConfig(num_epochs=1, step_per_epoch=cfg["supersteps"] * steps, step_per_collect=steps,
                              update_per_step=cfg["updates"] / steps, batch_size=cfg["batch"],
                              num_train_envs=cfg["num_envs"], num_test_envs=cfg["test_envs"],
                              episode_per_test=cfg["episodes"], buffer_size=cfg["num_envs"] * cfg["capacity"],
                              start_timesteps=PATHS["atari"].get("warmup", 0))
    config = ExperimentConfig(seed=0, logger="none", watch=path == "hl_cartpole", device="cuda")
    builder = DQNExperimentBuilder(factory, config=config, sampling=dataclasses.replace(base, **{"num_epochs": 1, **sampling}))
    return builder.with_params(params).with_seed(0).with_stop_fn(lambda rew: rew >= 195).build()


def _state_leaves(state) -> list[torch.Tensor]:
    """Every tensor of a train or buffer state in a fixed order: module
    parameters and buffers, optimizer state, tensor fields and dict leaves."""
    from tianshou_tpu_torch.data.tree import tree_leaves

    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.nn.Module):
            out += list(v.state_dict().values())
        elif isinstance(v, torch.optim.Optimizer):
            out += [t for st in v.state_dict()["state"].values() for t in st.values() if isinstance(t, torch.Tensor)]
        elif isinstance(v, (torch.Tensor, dict)):
            out += tree_leaves(v)
    return out


def phase_checkpoint(path: str, trainer) -> dict:
    """The trainer's train and buffer states through ``save_checkpoint`` and
    ``restore_checkpoint`` into a freshly built trainer's states, on the
    card: bitwise equal, sharing no storage with the source or the
    template.  Then a trainer that replays graphs continues from the
    restored states: its superstep compiled over them (a warm-up, then a
    replay) equals two eager supersteps from a copy of them, bitwise.  The
    files go under ``build/`` and are removed after."""
    from tianshou_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    source = {"train": trainer.train_state, "buffer": trainer.buffer_state}
    _, algo, col, buffer, fresh = build(path)
    gen, ts, cstate, bstate = init_states(algo, col, buffer, seed=1)
    template = {"train": ts, "buffer": bstate}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", f"{path}_checkpoint")
    shutil.rmtree(root, ignore_errors=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt = save_checkpoint(root, source, step=1)
        save_ms = (time.perf_counter() - t0) * 1e3
        nbytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
        t0 = time.perf_counter()
        restored = restore_checkpoint(ckpt, template)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
    finally:
        shutil.rmtree(root, ignore_errors=True)
    compared = 0
    for key in source:
        got, ref, tmpl = (_state_leaves(x[key]) for x in (restored, source, template))
        if len(got) != len(ref) or not got:
            raise AssertionError(f"{path} checkpoint: {len(got)} {key} tensors restored, {len(ref)} saved")
        for g, r in zip(got, ref):
            if g.dtype != r.dtype or g.shape != r.shape or g.device != r.device or not torch.equal(g, r):
                raise AssertionError(f"{path} checkpoint: a {key} tensor {tuple(r.shape)} differs after the restore")
        own = {t.untyped_storage().data_ptr() for t in got if t.numel()}
        if own & {t.untyped_storage().data_ptr() for t in ref + tmpl if t.numel()}:
            raise AssertionError(f"{path} checkpoint: the restored {key} state shares storage with another state")
        compared += len(got)
    del source, template
    graph_state = [restored["train"], cstate, restored["buffer"], gen]
    eager_state = _clone_run_state(*graph_state)
    compiled, eager_fn = fresh._compile_superstep(*graph_state[:3]), fresh._build_superstep()
    explore = torch.full((), 0.1, device="cuda")
    for call in range(2):
        graph_state[0], graph_state[1], graph_state[2], g_out, g_met = compiled(*graph_state[:3], graph_state[3],
                                                                                explore)
        eager_state[0], eager_state[1], eager_state[2], e_out, e_met = eager_fn(*eager_state[:3], eager_state[3],
                                                                                explore)
        differ = _differing(_run_leaves(eager_state, e_out, e_met), _run_leaves(graph_state, g_out, g_met))
        if differ:
            raise AssertionError(f"{path} checkpoint: superstep {call + 1} compiled over the restored states differs "
                                 f"from the eager one at {differ[:5]}")
    if sum(g.replays for g in compiled.graphs.values()) != 1:
        raise AssertionError(f"{path} checkpoint: the second superstep over the restored states was not a replay")
    result = {"bytes": nbytes, "save_ms": save_ms, "restore_ms": restore_ms, "tensors": compared,
              "replay_from_restored_bitwise": True}
    log(f"{path} checkpoint of the train and buffer states: {nbytes / 1e9:.4f} GB written in {save_ms:.1f} ms, "
        f"restored on the card in {restore_ms:.1f} ms; {compared} tensors bitwise equal, no storage shared; a "
        f"superstep compiled over the restored states (its warm-up, then a replay) bitwise equal to two eager ones")
    del compiled, graph_state, eager_state, restored
    _fresh_memory()
    return result


def phase_builder_beside_atari(reps: int = 1) -> dict:
    """``hl_atari`` (the builder's wiring) and ``atari`` (the wiring by
    hand) built side by side, each warmed up by 5 supersteps, then profiled
    and timed in turns (atari, hl_atari, hl_atari, atari, ...): kernels a
    superstep, within 13 of each other, and ms a superstep.  Profiling the
    two in turns keeps the profiler's dropped records, which grow as the
    process ages, out of the comparison."""
    steps = {}
    for path in ("atari", "hl_atari"):
        _, algo, col, buffer, trainer = build(path)
        gen, *state = init_states(algo, col, buffer)
        steps[path] = superstep_of(trainer, state, gen)
        for _ in range(5):
            steps[path]()
    kernels: dict[str, list[int]] = {p: [] for p in steps}
    ms: dict[str, list[float]] = {p: [] for p in steps}
    for i in range(reps):
        for p in ("atari", "hl_atari") if i % 2 == 0 else ("hl_atari", "atari"):
            kernels[p].append(_profile_counts(steps[p])[0])
            dt, _ = timed(steps[p], TIMED_COMPILED)
            ms[p].append(dt / TIMED_COMPILED * 1e3)
    hl, atari = (sorted(kernels[p])[reps // 2] for p in ("hl_atari", "atari"))
    log(f"hl_atari beside atari, in turns: kernels a superstep {kernels['hl_atari']} vs {kernels['atari']}, "
        f"ms a superstep {[round(x, 2) for x in ms['hl_atari']]} vs {[round(x, 2) for x in ms['atari']]}")
    if abs(hl - atari) > 13:
        raise AssertionError(f"hl_atari launches {hl} kernels a superstep, atari {atari}")
    del steps
    _fresh_memory()
    return {"kernels": kernels, "ms_per_superstep": ms}


def _trace_kernels(trace_path: str, name: str) -> tuple[int, int]:
    """Device kernel events in a Chrome trace: all of them, and those whose
    name holds ``name``."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return len(kernels), sum(name in e.get("name", "") for e in kernels)


def phase_main_highlevel(path: str, gather) -> tuple[int, dict]:
    """The high-level path's main run: the public builder's experiment with
    an in-memory logger, for one epoch; its launches, counters, logger
    writes and (hl_cartpole) watch episodes.  On hl_atari also the
    checkpoint of its states on the card, a second experiment resumed from
    the logger's counters, and a traced run whose kernels include
    ``gather_rows_cast``."""
    cfg = PATHS[path]
    logger = memory_logger()
    result, host, device = _counted_run(path, gather, lambda: highlevel_experiment(path).run(logger=logger))
    info = result.info
    log(f"{path} Experiment.run(): {info}; logger {len(logger.writes)} writes, {len(logger.saves)} saves "
        f"{logger.saves}")
    supersteps, steps = cfg["supersteps"], cfg["num_envs"] * cfg["segment"]
    launches = _run_launches(path, host, device, supersteps, _run_captures(path, result.world.trainer, supersteps))
    if (info.env_step, info.gradient_step, info.epoch) != (supersteps * steps, supersteps * cfg["updates"], 1):
        raise AssertionError(f"{path}: counters {info}")
    if logger.saves != [(1, info.env_step, info.gradient_step)] or not logger.writes:
        raise AssertionError(f"{path}: logger writes {logger.writes}, saves {logger.saves}")
    _check_metrics(path, info.last_metrics)
    if not math.isfinite(info.best_reward):
        raise AssertionError(f"{path}: non-finite best reward: {info}")
    out = {"run_env_step": info.env_step, "run_gradient_step": info.gradient_step, "best_reward": info.best_reward,
           "run_s": info.duration, "logger_writes": len(logger.writes), "logger_saves": len(logger.saves)}
    if path == "hl_cartpole":
        watch = result.watch_stats
        if watch is None or watch.n_collected_episodes != 10 or not math.isfinite(watch.returns_mean):
            raise AssertionError(f"{path}: watch episodes {watch}")
        out["watch_returns_mean"] = watch.returns_mean
        return launches, out

    out["checkpoint"] = phase_checkpoint(path, result.world.trainer)
    del result
    _fresh_memory()
    # resume: a second experiment of two epochs restores the checkpoint,
    # continues from the saved epoch and counters, captures its graph over
    # the restored state and runs the second epoch only
    resumed_result, host, device = _counted_run(path, gather, lambda: highlevel_experiment(
        path, num_epochs=2).run(logger=logger, resume_from_log=True))
    resumed = resumed_result.info
    resumed_launches = _run_launches(path, host, device, supersteps,
                                     _run_captures(path, resumed_result.world.trainer, supersteps))
    del resumed_result
    want = (2, 2 * supersteps * steps, 2 * supersteps * cfg["updates"])
    if (resumed.epoch, resumed.env_step, resumed.gradient_step) != want:
        raise AssertionError(f"{path}: resumed run {resumed}; wanted {want}")
    log(f"{path} resumed from {logger.saves[0]}: epoch {resumed.epoch}, env_step {resumed.env_step}, "
        f"gradient_step {resumed.gradient_step}, {resumed_launches} gather_rows_cast launches on the card")
    out["resumed"] = {"epoch": resumed.epoch, "env_step": resumed.env_step, "gradient_step": resumed.gradient_step}
    # a traced run of two supersteps: the profiler may drop the first
    # records of a window, so the kernel is looked for in either
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", f"{path}_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    try:
        traced = highlevel_experiment(path, step_per_epoch=2 * steps).run(logger=memory_logger(),
                                                                        profile_dir=trace_dir)
        trace = traced.world.trainer.trace_path
        kernels, gathers = _trace_kernels(trace, "gather_rows_cast")
        trace_mb = os.path.getsize(trace) / 1e6
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    if not gathers:
        raise AssertionError(f"{path}: the profile_dir trace holds {kernels} kernels, none of gather_rows_cast")
    log(f"{path} profile_dir trace of 2 supersteps and a test phase: {trace_mb:.1f} MB, {kernels} device kernels, "
        f"{gathers} of them gather_rows_cast")
    out["trace"] = {"kernels": kernels, "gather_rows_cast": gathers, "mb": trace_mb}
    return launches, out


_DATA: dict = {}


def pendulum_expert_ring(device, num_envs: int, capacity: int):
    """GAIL's expert data: a ``[num_envs, capacity]`` ring filled by one
    rollout of uniform random actions over the on-device Pendulum (made once
    per device)."""
    key = ("pendulum", str(device), num_envs, capacity)
    if key not in _DATA:
        from tianshou_tpu_torch.algos.base import RandomPolicy
        from tianshou_tpu_torch.collect.collector import Collector
        from tianshou_tpu_torch.data.buffer import ReplayBuffer
        from tianshou_tpu_torch.envs.base import VectorEnv
        from tianshou_tpu_torch.envs.classic import Pendulum

        env = Pendulum()
        policy = RandomPolicy(env.action_space, device=device)
        buf = ReplayBuffer(capacity, num_envs)
        col = Collector(policy, VectorEnv(env, num_envs, device=device), buf, device=device)
        _, ts, cstate, bstate = init_states(policy, col, buf, seed=3)
        _, bstate, _, _ = col.collect(ts, cstate, bstate, capacity, random=True)
        _DATA[key] = (buf, bstate)
    return _DATA[key]


def cartpole_offline_ring(device, num_envs: int, capacity: int):
    """DiscreteCQL's data: a ``[num_envs, capacity]`` ring filled by one
    epsilon-greedy (0.1) rollout of a freshly drawn QNet((128, 128, 128))
    over the on-device CartPole (made once per device)."""
    key = ("cartpole", str(device), num_envs, capacity)
    if key not in _DATA:
        from tianshou_tpu_torch.algos.dqn import DQN
        from tianshou_tpu_torch.collect.collector import Collector
        from tianshou_tpu_torch.data.buffer import ReplayBuffer
        from tianshou_tpu_torch.envs.base import VectorEnv
        from tianshou_tpu_torch.envs.classic import CartPole
        from tianshou_tpu_torch.networks.common import QNet

        env = CartPole()
        policy = DQN(QNet(4, (128, 128, 128), 2), env.action_space, device=device)
        buf = ReplayBuffer(capacity, num_envs)
        col = Collector(policy, VectorEnv(env, num_envs, device=device), buf, device=device)
        _, ts, cstate, bstate = init_states(policy, col, buf, seed=9)
        _, bstate, _, _ = col.collect(ts, cstate, bstate, capacity, explore=True, explore_param=0.1)
        _DATA[key] = (buf, bstate)
    return _DATA[key]


def d4rl_standin_dataset(transitions: int, episode_len: int, seed: int = 0) -> dict[str, np.ndarray]:
    """A dataset in the D4RL qlearning schema at the size and shapes of
    ``halfcheetah-medium-v2`` (obs 17 float32, actions 6 in [-1, 1]):
    ``transitions // episode_len`` episodes of ``HalfCheetahStandIn``'s
    dynamics run at once in numpy under a noisy linear policy, stored
    episode after episode.  ``terminals`` are all false and ``timeouts``
    mark each episode's last step."""
    env = HalfCheetahStandIn()
    env.reset(seed=seed)  # draws the dynamics and the reward weights
    rng = np.random.default_rng(seed + 1)
    n, m, episodes = env.OBS_DIM, env.ACT_DIM, transitions // episode_len
    policy = rng.normal(0.0, 1.0 / math.sqrt(n), (n, m))
    obs = np.empty((episodes, episode_len, n), np.float32)
    act = np.empty((episodes, episode_len, m), np.float32)
    rew = np.empty((episodes, episode_len), np.float32)
    nxt = np.empty((episodes, episode_len, n), np.float32)
    x = rng.normal(0.0, 0.1, (episodes, n))
    for t in range(episode_len):
        a = np.clip(np.tanh(x @ policy) + rng.normal(0.0, 0.3, (episodes, m)), -1.0, 1.0)
        x_next = np.tanh(x @ env._a.T + a @ env._b.T) + rng.normal(0.0, 0.01, (episodes, n))
        obs[:, t], act[:, t], nxt[:, t] = x, a, x_next
        rew[:, t] = x_next @ env._w - 0.1 * (a * a).sum(-1)
        x = x_next
    timeouts = np.zeros((episodes, episode_len), bool)
    timeouts[:, -1] = True
    return {"observations": obs.reshape(-1, n), "actions": act.reshape(-1, m), "rewards": rew.reshape(-1),
            "next_observations": nxt.reshape(-1, n), "terminals": np.zeros(episodes * episode_len, bool),
            "timeouts": timeouts.reshape(-1)}


def d4rl_standin_file(cfg: dict) -> str:
    """:func:`d4rl_standin_dataset` written to ``build/`` as ``.npz`` (once
    per run)."""
    if "d4rl" not in _DATA:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "halfcheetah_standin_1m.npz")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        t0 = time.perf_counter()
        np.savez(path, **d4rl_standin_dataset(cfg["transitions"], cfg["episode_len"]))
        log(f"cql_d4rl dataset: {cfg['transitions']} transitions in the D4RL schema written to {path} "
            f"({os.path.getsize(path) / 2**30:.3f} GiB) in {time.perf_counter() - t0:.1f} s")
        _DATA["d4rl"] = path
    return _DATA["d4rl"]


def build_offline_path(path: str, device):
    """An offline path through the port's entry points: ``(env, algo, test
    collector, buffer, buffer state, trainer)``.  The trainer runs one epoch
    of two supersteps."""
    from tianshou_tpu_torch.algos.offline import CQL, DiscreteCQL
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.trainer.offline import OfflineTrainer

    cfg = PATHS[path]
    if path == "cql_d4rl":
        # examples/offline_d4rl_cql.py:26-103 at its defaults, calibrated=False
        from tianshou_tpu_torch.collect.host_collector import HostCollector
        from tianshou_tpu_torch.data.persistence import buffer_from_d4rl
        from tianshou_tpu_torch.envs.host import HostVectorEnv
        from tianshou_tpu_torch.networks.continuous import CriticEnsemble, GaussianActor

        buffer, bstate = buffer_from_d4rl(d4rl_standin_file(cfg), device=device)
        env, hidden = HalfCheetahStandIn(), (256, 256)
        algo = CQL(GaussianActor(env.OBS_DIM, hidden, env.ACT_DIM, conditioned_sigma=True),
                   CriticEnsemble(env.OBS_DIM, env.ACT_DIM, hidden, num_critics=2), env.action_space, actor_lr=1e-4,
                   critic_lr=3e-4, cql_weight=1.0, num_repeat_actions=10, with_lagrange=True, lagrange_threshold=10.0,
                   calibrated=False, device=device)
        test = HostCollector(algo, HostVectorEnv([HalfCheetahStandIn] * cfg["test_envs"]), device=device)
    elif path == "discrete_cql_cartpole":
        # tests/test_offline_e2e.py:197-209
        from tianshou_tpu_torch.envs.base import VectorEnv
        from tianshou_tpu_torch.envs.classic import CartPole
        from tianshou_tpu_torch.networks.discrete import QRDQNNet

        env = CartPole()
        buffer, bstate = cartpole_offline_ring(device, cfg["num_envs"], cfg["capacity"])
        algo = DiscreteCQL(QRDQNNet(4, (128, 128), 2, num_quantiles=32), env.action_space, num_quantiles=32,
                           min_q_weight=10.0, gamma=0.95, n_step=3, target_update_freq=320, device=device)
        test = Collector(algo, VectorEnv(env, cfg["test_envs"], device=device), device=device)
    else:
        raise ValueError(f"unknown offline path {path!r}; have {OFFLINE_PATHS}")
    trainer = OfflineTrainer(algo, buffer, bstate, test, max_epoch=1, update_per_epoch=2 * cfg["updates"],
                             batch_size=cfg["batch"], episode_per_test=cfg["episodes"],
                             updates_per_superstep=cfg["updates"], device=device)
    return env, algo, test, buffer, bstate, trainer


def phase_offline(path: str, gather) -> dict:
    """An offline path at full width: 1 warm-up and timed supersteps of
    ``updates`` updates, one under the sync guard, and the breakdown (one
    sampled batch, one update); the profile of a superstep is the
    learn-graph phase's."""
    from tianshou_tpu_torch.data.tree import tree_leaves
    from tianshou_tpu_torch.utils.device import fork_generator, make_generator

    cfg = PATHS[path]
    _fresh_memory()
    base = torch.cuda.memory_allocated() / 2**30
    env, algo, test, buffer, bstate, trainer = build_offline_path(path, "cuda")
    gen = make_generator(0, algo.device)
    state = [algo.init(fork_generator(gen)), algo.prepare_offline(buffer, bstate)
             if hasattr(algo, "prepare_offline") else bstate]
    fn = trainer._build_superstep()

    def step():
        state[0], state[1], metrics = fn(state[0], state[1], gen)
        return metrics

    n, updates, batch = TIMED_COMPILED if path in COMPILED_PATHS else TIMED, cfg["updates"], cfg["batch"]
    gather.launches = 0
    dt, metrics = timed(step, n)
    if gather.launches != KERNEL_LAUNCHES[path] * (n + WARMUP):
        raise AssertionError(f"{path}: gather_rows_cast launched {gather.launches} times in {n + WARMUP} supersteps")
    _check_metrics(path, metrics)
    sync_guarded(step)
    obs = buffer.get(state[1], torch.zeros(256, dtype=torch.int64, device=algo.device),
                     torch.arange(256, device=algo.device) * 997 % buffer.capacity, keys=("obs",))["obs"]
    check_policy(path, algo, state[0], obs, gen, env)
    peak = torch.cuda.max_memory_allocated() / 2**30
    data_gb = sum(x.numel() * x.element_size() for x in tree_leaves(state[1].storage)) / 1e9
    result = {"gradient_steps_per_s": n * updates / dt, "samples_per_s": n * updates * batch / dt,
              "ms_per_superstep": dt / n * 1e3, **metrics, "updates_per_superstep": updates, "batch": batch,
              "max_memory_allocated_gib": peak, "memory_base_gib": base, "dataset_gb": data_gb}

    def sample():
        env_idx, pos, _ = buffer.sample_with_weights(state[1], gen, batch)
        buffer.get(state[1], env_idx, pos, keys=("obs", "act", "rew", "obs_next", "terminated", "truncated"))

    result["breakdown_ms"] = breakdown({"sample (one batch)": sample,
                                        "one update": lambda: algo.update(state[0], buffer, state[1], gen, batch)})
    log(f"{path}: {n} supersteps of {updates} updates of batch {batch} on a dataset of {data_gb:.3f} GB: "
        f"{result['gradient_steps_per_s']:.1f} gradient steps/s ({result['samples_per_s']:.0f} samples/s), "
        f"{result['ms_per_superstep']:.2f} ms per superstep, metrics {metrics}, max_memory_allocated {peak:.3f} GiB; "
        f"a superstep under torch.cuda.set_sync_debug_mode('error') raised no host sync")
    log(f"{path} breakdown (median of 3, ms): " + ", ".join(f"{k} {v:.2f}" for k, v in result["breakdown_ms"].items()))
    if hasattr(test.venv, "close"):
        test.venv.close()
    return result


def _processing_passes(algo, repeat: int) -> int:
    """Critic + GAE passes over the rollout a superstep: the first
    processing, the return statistics' own, one a pass with
    ``recompute_advantage``."""
    return (1 + bool(getattr(algo, "ret_norm", False)) + repeat * bool(getattr(algo, "recompute_advantage", False))
            if hasattr(algo, "gae_lambda") else 1)


class _HostToDeviceCopies(TorchDispatchMode):
    """While on, records the shape of every tensor copy from the host to the
    card that PyTorch dispatches (``copy_`` into a CUDA tensor from a CPU
    one, or a ``to``/``_to_copy`` of a CPU tensor onto the card)."""

    def __init__(self):
        super().__init__()
        self.copies: list[tuple[int, ...]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.copy_.default:
            dst, src = args[0], args[1]
        elif func is torch.ops.aten._to_copy.default:
            dst, src = out, args[0]
        else:
            return out
        if src.device.type == "cpu" and dst.device.type == "cuda":
            self.copies.append(tuple(src.shape))
        return out


def _busy_ms(events) -> float:
    """The device's busy milliseconds over ``events`` (the union of their
    intervals)."""
    busy_ns, end = 0, -1
    for start, stop in sorted((e.start_ns(), e.end_ns()) for e in events):
        busy_ns += max(0, stop - max(start, end))
        end = max(end, stop)
    return busy_ns / 1e6


def _profile(fn) -> dict:
    """``fn`` under ``torch.profiler``: the card's records (kernels, of which
    memsets and memcpys), its busy milliseconds, its NCCL kernels and their
    busy milliseconds, the host's launch calls (``LAUNCH_CALLS``, by name)
    and ``gather_rows_cast``'s device ms a launch."""
    host: list = []
    events = _device_records(fn, host)
    names = [e.name() for e in events]
    nccl = [e for e in events if "nccl" in e.name().lower()]
    return {"kernels": len(events), "memsets": sum("Memset" in n for n in names),
            "memcpys": sum("Memcpy" in n for n in names), "busy_ms": _busy_ms(events), "host_launches": len(host),
            "nccl_kernels": len(nccl), "nccl_ms": _busy_ms(nccl),
            "host_launch_calls": dict(collections.Counter(e.name() for e in host)),
            "gather_rows_cast_ms": [(e.end_ns() - e.start_ns()) / 1e6 for e in events
                                    if "gather_rows_cast" in e.name()]}


def _profile_counts(fn) -> tuple[int, float]:
    """``fn`` under ``torch.profiler``: device kernels and the device's busy
    milliseconds."""
    events = _device_records(fn)
    return len(events), _busy_ms(events)


def _profile_memcpys(fn) -> tuple[int, int]:
    """``fn`` under ``torch.profiler``: the host-to-device and the
    device-to-host copies the card ran (its device records; a copy made by
    ``torch.as_tensor(array, device=...)`` is not a dispatched operation,
    so only the profiler sees it)."""
    names = [e.name() for e in _device_records(fn)]
    return sum("HtoD" in n for n in names), sum("DtoH" in n for n in names)


# the host's launches of work onto the card: the CUDA calls (`cuda*`, `cu*`)
# that the profiler records
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync", "cudaLaunchCooperativeKernel")


def _device_records(fn, host_launches: list | None = None) -> list:
    """The device records of ``fn``'s work under ``torch.profiler``; with
    ``host_launches`` (a list) also the host's launch calls of that work
    (``LAUNCH_CALLS``, the padding's left out) appended to it.  The
    window opens with about a second of a busy stream
    (``torch.cuda._sleep``'s spin kernel) and then ``PROFILE_PADDING``
    short spins, all left out, before ``fn``'s work: the profiler drops the
    first device records of a window, more of them the longer the process
    has run (up to 19 of a superstep late in a run), and the spins take the
    loss.  A window that lost every spin is reported."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2_000_000_000)
        for _ in range(PROFILE_PADDING):
            torch.cuda._sleep(1)
        fn()
        torch.cuda.synchronize()
    # the trace's raw records hold the same kernels as ``prof.events()``,
    # without building a function event for each of tens of thousands of
    # records
    records = prof.profiler.kineto_results.events()
    device = [e for e in records if e.device_type() == torch.autograd.DeviceType.CUDA]
    events = [e for e in device if "spin_kernel" not in e.name()]
    if host_launches is not None:
        calls = sorted((e for e in records if e.device_type() != torch.autograd.DeviceType.CUDA
                        and e.name() in LAUNCH_CALLS), key=lambda e: e.start_ns())
        # the padding: one long spin and PROFILE_PADDING short ones
        host_launches.extend(calls[1 + PROFILE_PADDING:])
    if len(device) - len(events) == 0:
        log(f"profiler: every padding spin was dropped; {len(events)} kernels may undercount")
    return events


def phase_reference_onpolicy() -> None:
    """The on-policy slice on the card against the CPU (float32, TF32 off),
    from the same parameters and inputs: GAE on a [256, 8] rollout; a PPO
    rollout processed with ret_norm (critic values, GAE, the return
    statistics) and 3 minibatch updates of it with value clipping; one TRPO
    learn.  Within rtol 1e-4 / atol 1e-5."""
    from tianshou_tpu_torch.algos.npg import TRPO
    from tianshou_tpu_torch.algos.ppo import PPO
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.envs.spaces import Box
    from tianshou_tpu_torch.networks.continuous import GaussianActor, ValueNet
    from tianshou_tpu_torch.ops.returns import gae_advantages

    rng = np.random.default_rng(0)
    T, N = 256, 8
    arrays = dict(rew=rng.normal(size=(T, N)), val=rng.normal(size=(T, N)), val_next=rng.normal(size=(T, N)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    terminated = rng.random((T, N)) < 0.02
    done = terminated | (rng.random((T, N)) < 0.02)
    got, ref = (gae_advantages(*(torch.from_numpy(x).to(dev) for x in (*arrays.values(), terminated, done)),
                               0.99, 0.95) for dev in ("cuda", "cpu"))
    err = max(_assert_close(f"gae {name}", g, r) for name, g, r in zip(("adv", "ret"), got, ref))
    log(f"reference gae_advantages [256, 8]: card equals CPU within rtol 1e-4 / atol 1e-5 (largest difference "
        f"{err:.3e})")

    obs_dim, act_dim, hidden, B = 5, 2, (32, 32), 64
    box = Box(low=-1.0, high=1.0, shape=(act_dim,))
    traj = dict(obs=rng.normal(size=(32, 8, obs_dim)).astype(np.float32),
                act=rng.normal(size=(32, 8, act_dim)).astype(np.float32),
                rew=rng.normal(size=(32, 8)).astype(np.float32), terminated=rng.random((32, 8)) < 0.05,
                truncated=rng.random((32, 8)) < 0.05, obs_next=rng.normal(size=(32, 8, obs_dim)).astype(np.float32),
                log_prob=(rng.normal(size=(32, 8)) - 2.0).astype(np.float32))
    perm = rng.permutation(32 * 8)[: 3 * B].reshape(3, B)
    # observations small enough that the Fisher matrix is well conditioned:
    # 10 conjugate-gradient iterations amplify float32 rounding by its
    # condition number (at half this scale a float32 learn on the CPU sits
    # 1.6e-4 beyond rtol 1e-4 of a float64 one; at this scale within it)
    mb_trpo = dict(obs=rng.normal(size=(B, obs_dim)).astype(np.float32) / 8,
                   act=rng.normal(size=(B, act_dim)).astype(np.float32),
                   adv=rng.normal(size=B).astype(np.float32), ret=rng.normal(size=B).astype(np.float32),
                   logp_old=(rng.normal(size=B) - 2.0).astype(np.float32))
    for kind in ("ppo", "trpo"):
        runs, init = {}, None
        for dev in ("cuda", "cpu"):
            actor, critic = GaussianActor(obs_dim, hidden, act_dim, sigma_init=-0.5), ValueNet(obs_dim, hidden)
            if kind == "ppo":
                algo = PPO(actor, critic, box, lr=1e-3, ret_norm=True, value_clip=True, max_grad_norm=0.5, device=dev)
            else:
                algo = TRPO(actor, critic, box, critic_lr=1e-3, max_kl=0.01, device=dev)
            ts = algo.init(torch.Generator(device=dev).manual_seed(0))
            if init is None:
                init = {k: {n: v.detach().cpu() for n, v in getattr(ts, k).state_dict().items()}
                        for k in ("actor", "critic")}
            ts.actor.load_state_dict(init["actor"])
            ts.critic.load_state_dict(init["critic"])
            out = []
            if kind == "ppo":
                t = {k: torch.from_numpy(v).to(dev) for k, v in traj.items()}
                rollout = Batch(obs=t["obs"], act=t["act"], rew=t["rew"], terminated=t["terminated"],
                                truncated=t["truncated"], obs_next=t["obs_next"], policy=Batch(log_prob=t["log_prob"]))
                ts = algo.update_rollout_stats(ts, rollout)  # so that the return scale is not 1
                processed = algo.process_rollout(ts, rollout)
                out += [processed["adv"], processed["ret"], ts.ret_var]
                idx = torch.from_numpy(perm).to(dev)
                for i in range(3):
                    ts, m = algo.learn(ts, Batch({k: v[idx[i]] for k, v in processed.items()}))
                    out.append(torch.stack([m[k] for k in sorted(m)]))
            else:
                ts, m = algo.learn(ts, Batch({k: torch.from_numpy(v).to(dev) for k, v in mb_trpo.items()}))
                out.append(torch.stack([m[k] for k in sorted(m)]))
            runs[dev] = (ts, out)
        (gts, gout), (cts, cout) = runs["cuda"], runs["cpu"]
        err = max(_assert_close(f"{kind} output {i}", g, c) for i, (g, c) in enumerate(zip(gout, cout)))
        for part in ("actor", "critic"):
            for name, v in getattr(gts, part).state_dict().items():
                err = max(err, _assert_close(f"{kind} {part}.{name}", v, getattr(cts, part).state_dict()[name]))
        what = ("a rollout processed with ret_norm and 3 minibatch updates" if kind == "ppo"
                else f"one learn (accepted {float(gout[-1][0]):.0f} on both)")
        log(f"reference {kind}: {what} on the card equal the CPU's within rtol 1e-4 / atol 1e-5 (largest "
            f"difference {err:.3e})")

    # TRPO at the trpo_pendulum path's widths and settings on observations
    # at Pendulum's own scale (cos, sin and an angular velocity in [-8, 8]),
    # unscaled: in float64 the card must equal the CPU within rtol 1e-7 /
    # atol 1e-9; in float32 the card's and the CPU's natural-gradient steps
    # are read against the CPU's float64 step
    B = 2048
    theta, speed = rng.uniform(-np.pi, np.pi, B), rng.uniform(-8.0, 8.0, B)
    mb = dict(obs=np.stack([np.cos(theta), np.sin(theta), speed], 1), act=rng.normal(0.0, 1.0, (B, 1)),
              adv=rng.normal(size=B), ret=rng.normal(0.0, 3.0, B), logp_old=rng.normal(-1.5, 0.3, B))
    mb = {k: v.astype(np.float32) for k, v in mb.items()}
    runs, init = {}, None
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.float32), ("cpu", torch.float64),
                       ("cuda", torch.float64)):
        algo = TRPO(GaussianActor(3, (64, 64), 1, compute_dtype=dtype).to(dtype),
                    ValueNet(3, (64, 64), compute_dtype=dtype).to(dtype), Box(low=-2.0, high=2.0, shape=(1,)),
                    device=dev, **TRPO_PENDULUM)
        ts = algo.init(torch.Generator(device=dev).manual_seed(0))
        if init is None:
            init = {k: {n: v.detach().clone() for n, v in getattr(ts, k).state_dict().items()}
                    for k in ("actor", "critic")}
        ts.actor.load_state_dict(init["actor"])
        ts.critic.load_state_dict(init["critic"])
        ts, m = algo.learn(ts, Batch({k: torch.from_numpy(v).to(dev, dtype) for k, v in mb.items()}))
        runs[dev, dtype] = ({part: {n: v.detach().cpu().double() for n, v in getattr(ts, part).state_dict().items()}
                             for part in ("actor", "critic")}, {k: float(v) for k, v in m.items()})

    def step_error(key) -> float:
        """The relative distance of ``key``'s actor step from the CPU's
        float64 step."""
        (got, _), (ref, _), a0 = runs[key], runs["cpu", torch.float64], init["actor"]
        diff = sum(float(((got["actor"][n] - ref["actor"][n]) ** 2).sum()) for n in a0)
        size = sum(float(((ref["actor"][n] - a0[n].double()) ** 2).sum()) for n in a0)
        return math.sqrt(diff / size)

    accepted = {f"{dev} {str(dtype)[6:]}": m["accepted"] for (dev, dtype), (_, m) in runs.items()}
    if set(accepted.values()) != {1.0}:
        raise AssertionError(f"trpo at Pendulum's scale: accepted {accepted}")
    err = max(_assert_close(f"trpo float64 {part}.{n}", v, runs["cpu", torch.float64][0][part][n], rtol=1e-7,
                            atol=1e-9)
              for part, sd in runs["cuda", torch.float64][0].items() for n, v in sd.items())
    errors = {f"{dev} {str(dtype)[6:]}": step_error((dev, dtype)) for dev, dtype in runs if (dev, dtype) != (
        "cpu", torch.float64)}
    if max(errors.values()) > TRPO_FLOAT32_STEP_LIMIT:
        raise AssertionError(f"trpo at Pendulum's scale: steps' relative distance from the CPU's float64 step "
                             f"{errors}, limit {TRPO_FLOAT32_STEP_LIMIT}")
    log(f"reference trpo at Pendulum's scale (batch {B}, (64, 64), max KL 0.005, accepted on all four): the "
        f"float64 learn on the card equals the CPU's within rtol 1e-7 / atol 1e-9 (largest difference {err:.3e}); "
        f"the actor steps' relative distance from the CPU's float64 step: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errors.items()) + f" (limit {TRPO_FLOAT32_STEP_LIMIT} for float32)")


def phase_reference_distributional() -> None:
    """Prioritized replay and the distributional family on the card against
    the CPU (float32, TF32 off, rtol 1e-4 / atol 1e-5, indices exact): the
    sum tree at 20,000 slots (update, and draw on the same ``u``); PER
    weights in both modes; one update each of DQN on a PER buffer (with the
    tree after the write-back), C51, Rainbow (the same noise), QRDQN, IQN
    (the same fractions) and FQF (the quantile net and the fraction
    proposal after the step), from the same parameters and batch."""
    from tianshou_tpu_torch.algos.c51 import C51, Rainbow
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.algos.qrdqn import FQF, IQN, QRDQN
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer
    from tianshou_tpu_torch.data.tree import tree_map
    from tianshou_tpu_torch.envs.spaces import Discrete
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.networks.discrete import (
        C51Net, FractionProposalNetwork, FullQuantileFunction, ImplicitQuantileNetwork, QRDQNNet, draw_noise)
    from tianshou_tpu_torch.ops.segtree import segtree_draw, segtree_init, segtree_update

    rng = np.random.default_rng(0)
    # the sum tree at the rainbow_per ring's 20,000 slots: the card's kernels
    # against the CPU's plain loop
    capacity = PATHS["rainbow_per"]["capacity"]
    slots = PATHS["rainbow_per"]["num_envs"] * capacity
    n = min(4096, slots // 2)
    idx = rng.choice(slots, n, replace=False)
    vals = rng.random(n).astype(np.float32)
    u01 = rng.random(n).astype(np.float32)
    trees, draws = {}, {}
    launches = segtree_update.launches, segtree_draw.launches
    for dev in ("cuda", "cpu"):
        tree = segtree_init(slots, dev)
        segtree_update(tree, torch.from_numpy(idx).to(dev), torch.from_numpy(vals).to(dev))
        trees[dev] = tree
        draws[dev] = segtree_draw(tree, torch.from_numpy(u01).to(dev), slots, capacity)
    if (segtree_update.launches, segtree_draw.launches) != (launches[0] + 1, launches[1] + 1):
        raise AssertionError("the card's sum tree did not run on its kernels")
    err = _assert_close("segtree_update tree", trees["cuda"], trees["cpu"])
    for what, card, cpu in zip(("env", "pos", "p"), draws["cuda"], draws["cpu"]):
        if not torch.equal(card.cpu(), cpu):
            raise AssertionError(f"segtree_draw: the card and the CPU draw different {what}")
    log(f"reference segtree at {slots} slots: {n} updated leaves give the same tree (largest difference "
        f"{err:.3e}) and {n} draws the same (env, pos, p) on the card's kernels and the CPU's plain loop")

    obs_dim, n_act, hidden, batch = 4, 3, (32, 32), 16
    steps = [dict(obs=rng.normal(size=(2, obs_dim)).astype(np.float32), act=rng.integers(0, n_act, 2),
                  rew=rng.normal(size=2).astype(np.float32), terminated=rng.random(2) < 0.15,
                  truncated=rng.random(2) < 0.05, obs_next=rng.normal(size=(2, obs_dim)).astype(np.float32))
             for _ in range(40)]
    td = (rng.normal(size=24) * 3).astype(np.float32)
    written = rng.choice(64, 24, replace=False)

    def per_state(dev, weight_norm=True):
        buf = PrioritizedReplayBuffer(32, 2, alpha=0.6, beta=0.4, weight_norm=weight_norm)
        bs = buf.init(Batch({k: torch.as_tensor(v[0]) for k, v in steps[0].items()}), device=dev)
        for tr in steps:
            bs = buf.add(bs, Batch({k: torch.from_numpy(v).to(dev) for k, v in tr.items()}))
        w = torch.from_numpy(written).to(dev)
        return buf, buf.update_priorities(bs, w // 32, w % 32, torch.from_numpy(td).to(dev))

    # a u whose sample names no slot twice: a duplicated slot's write-back
    # keeps one of its values, in no fixed order on the card
    buf, bs = per_state("cpu")
    for _ in range(100):
        u = torch.from_numpy(rng.random(batch).astype(np.float32))
        env_idx, pos, _ = buf.sample_at(bs, u)
        if len(set((env_idx * 32 + pos).tolist())) == batch:
            break
    for weight_norm in (True, False):
        out = {dev: per_state(dev, weight_norm) for dev in ("cuda", "cpu")}
        got = {dev: b.sample_at(st, u.to(dev)) for dev, (b, st) in out.items()}
        for name, g, c in zip(("env_idx", "pos"), got["cuda"][:2], got["cpu"][:2]):
            if not torch.equal(g.cpu(), c):
                raise AssertionError(f"PER sample: {name} differs between the card and the CPU")
        err = _assert_close(f"PER weights (weight_norm={weight_norm})", got["cuda"][2], got["cpu"][2])
        log(f"reference PER (weight_norm={weight_norm}): the same slots and weights on the card and the CPU "
            f"(largest difference {err:.3e})")

    def quantile_sample(dev):
        r = np.random.default_rng(1)
        a = dict(env_idx=r.integers(0, 2, batch), pos=r.permutation(batch), weight=r.uniform(0.5, 1.5, batch),
                 obs=r.normal(size=(batch, obs_dim)), act=r.integers(0, n_act, batch),
                 obs_next=r.normal(size=(batch, obs_dim)), terminated=r.random(batch) < 0.3,
                 returns=r.normal(size=batch) * 2, discount=r.choice([0.9, 0.81], batch))
        t = {k: torch.from_numpy(v.astype(np.float32) if v.dtype == np.float64 else v).to(dev) for k, v in a.items()}
        mask = 1.0 - t["terminated"].to(torch.float32)
        return (t["env_idx"], t["pos"], t["weight"], Batch(obs=t["obs"], act=t["act"]),
                Batch(obs_next=t["obs_next"], terminated=t["terminated"]), mask, t["returns"], t["discount"])

    def c51_sample(dev):
        r = np.random.default_rng(2)
        a = dict(env_idx=r.integers(0, 2, batch), pos=r.permutation(batch),
                 weight=r.uniform(0.5, 1.5, batch).astype(np.float32),
                 obs=r.normal(size=(batch, obs_dim)).astype(np.float32), act=r.integers(0, n_act, batch),
                 rew=(r.normal(size=(batch, 3)) * 2).astype(np.float32),
                 done=(r.random((batch, 3)) < 0.2).astype(np.int32),
                 obs_next=r.normal(size=(batch, obs_dim)).astype(np.float32), terminated=r.random(batch) < 0.3)
        t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
        return (t["env_idx"], t["pos"], t["weight"], Batch(obs=t["obs"], act=t["act"]), t["rew"], t["done"],
                Batch(obs_next=t["obs_next"], terminated=t["terminated"]))

    kw = dict(gamma=0.9, n_step=3, lr=1e-3, target_update_freq=1)
    space = Discrete(n_act)
    makers = {
        "dqn-per": lambda dev: DQN(QNet(obs_dim, hidden, n_act), space, device=dev, **kw),
        "c51": lambda dev: C51(C51Net(obs_dim, hidden, n_act, num_atoms=11), space, num_atoms=11, v_min=-5.0,
                               v_max=5.0, device=dev, **kw),
        "rainbow": lambda dev: Rainbow(C51Net(obs_dim, hidden, n_act, num_atoms=11, noisy=True), space,
                                       num_atoms=11, v_min=-5.0, v_max=5.0, device=dev, **kw),
        "qrdqn": lambda dev: QRDQN(QRDQNNet(obs_dim, hidden, n_act, num_quantiles=16), space, num_quantiles=16,
                                   device=dev, **kw),
        "iqn": lambda dev: IQN(ImplicitQuantileNetwork(obs_dim, hidden, n_act), space, sample_size=8,
                               online_sample_size=6, target_sample_size=5, device=dev, **kw),
        "fqf": lambda dev: FQF(FullQuantileFunction(obs_dim, hidden, n_act),
                               FractionProposalNetwork(hidden[-1], 8), space, num_fractions=8, fraction_lr=1e-3,
                               device=dev, **kw),
    }
    for kind, make in makers.items():
        runs, init, extra = {}, None, {}
        for dev in ("cuda", "cpu"):
            algo = make(dev)
            ts = algo.init(torch.Generator(device=dev).manual_seed(0))
            parts = ("online", "fraction") if kind == "fqf" else ("online",)
            if init is None:
                init = {p: {n: v.detach().cpu() for n, v in getattr(ts, p).state_dict().items()} for p in parts}
                g = torch.Generator(device=dev).manual_seed(1)
                if kind == "rainbow":
                    extra = dict(noise=(draw_noise(ts.target, g), draw_noise(ts.online, g)))
                elif kind == "iqn":
                    extra = dict(taus=tuple(torch.rand((batch, k), generator=g, device=dev) for k in (5, 6, 5)))
            for p in parts:
                getattr(ts, p).load_state_dict(init[p])
            ts.target.load_state_dict(init["online"])
            dev_extra = {k: tree_map(lambda x: x.to(dev), v) for k, v in extra.items()}
            if kind == "dqn-per":
                buf, bs = per_state(dev)
                buf.sample_with_weights = lambda st, gen, b, buf=buf, dev=dev: buf.sample_at(st, u.to(dev))
                sampled = algo.presample(buf, bs, None, batch)
                ts, bs, m = algo.update_sampled(ts, buf, bs, sampled)
                out = [m["loss"], bs.tree, bs.max_prio, bs.min_prio]
            else:
                sampled = (quantile_sample if kind in ("qrdqn", "iqn", "fqf") else c51_sample)(dev)
                ts, _, m = algo.update_sampled(ts, None, None, sampled, **dev_extra)
                out = [torch.stack([m[k] for k in sorted(m)])]
            runs[dev] = (ts, out, parts)
        (gts, gout, parts), (cts, cout, _) = runs["cuda"], runs["cpu"]
        err = max(_assert_close(f"{kind} output {i}", g, c) for i, (g, c) in enumerate(zip(gout, cout)))
        for p in (*parts, "target"):
            for name, v in getattr(gts, p).state_dict().items():
                err = max(err, _assert_close(f"{kind} {p}.{name}", v, getattr(cts, p).state_dict()[name]))
        log(f"reference {kind}: one update on the card equals the CPU's within rtol 1e-4 / atol 1e-5 (largest "
            f"difference {err:.3e}" + (", the tree after the write-back included)" if kind == "dqn-per" else ")"))


def fixed_reset_cartpole(start=(0.03, -0.02, 0.04, 0.01)):
    """A CartPole whose resets put every env in ``start`` (the card's and
    the CPU's reset draws differ), so that a segment on each crosses its
    episode ends alike."""
    from tianshou_tpu_torch.envs.classic import CartPole, CartPoleState

    class FixedResetCartPole(CartPole):
        def reset(self, generator, num_envs, device):
            v = torch.tensor(start, device=device).repeat(num_envs, 1)
            s = CartPoleState(*v.unbind(1), torch.zeros(num_envs, dtype=torch.int32, device=device))
            return s, self._obs(s)

    return FixedResetCartPole()


def phase_reference_offpolicy_rest() -> None:
    """The rest of the off-policy families on the card against the CPU
    (float32, TF32 off, rtol 1e-4 / atol 1e-5), from the same parameters
    and inputs: one update each of REDQ (subset and normals injected),
    DiscreteSAC, BDQ and DRQN (the same slots of the same ring); a greedy
    DRQN CartPole segment, one step at a time, whose carries cross episode
    ends: the same actions at every step, the carries within the
    tolerance, and each ended env's carry reset to zeros."""
    from tianshou_tpu_torch.algos.bdq import BDQ
    from tianshou_tpu_torch.algos.drqn import DRQN
    from tianshou_tpu_torch.algos.redq import REDQ
    from tianshou_tpu_torch.algos.sac import DiscreteSAC
    from tianshou_tpu_torch.collect.collector import Collector, rollout_segment
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.envs.classic import CartPoleState
    from tianshou_tpu_torch.envs.spaces import Box, Discrete, MultiDiscrete
    from tianshou_tpu_torch.networks.common import BranchingQNet, QNet, QNetEnsemble, RecurrentQNet
    from tianshou_tpu_torch.networks.continuous import CriticEnsemble, GaussianActor

    rng = np.random.default_rng(6)
    obs_dim, hidden, batch = 4, (32, 32), 16

    def sampled(dev, kind):
        """The same batch on ``dev``, with box, discrete or 2-branch actions."""
        r = np.random.default_rng(7)
        act = {"box": r.uniform(-1, 1, (batch, 1)).astype(np.float32), "discrete": r.integers(0, 3, batch),
               "multi": r.integers(0, 4, (batch, 2))}[kind]
        a = dict(env_idx=r.integers(0, 2, batch), pos=r.permutation(batch),
                 weight=r.uniform(0.5, 1.5, batch).astype(np.float32),
                 obs=r.normal(size=(batch, obs_dim)).astype(np.float32), act=act,
                 rew=r.normal(size=(batch, 2)).astype(np.float32), done=(r.random((batch, 2)) < 0.2).astype(np.int32),
                 obs_next=r.normal(size=(batch, obs_dim)).astype(np.float32), terminated=r.random(batch) < 0.3)
        t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
        return (t["env_idx"], t["pos"], t["weight"], Batch(obs=t["obs"], act=t["act"]), t["rew"], t["done"],
                Batch(obs_next=t["obs_next"], terminated=t["terminated"]))

    steps = [dict(obs=rng.normal(size=(2, obs_dim)).astype(np.float32), act=rng.integers(0, 2, 2),
                  rew=rng.normal(size=2).astype(np.float32), terminated=rng.random(2) < 0.15,
                  truncated=rng.random(2) < 0.05, obs_next=rng.normal(size=(2, obs_dim)).astype(np.float32))
             for _ in range(40)]
    slots = torch.from_numpy(rng.choice(64, batch, replace=False))

    def drqn_update(algo, ts, dev):
        buf = ReplayBuffer(32, 2)
        bs = buf.init(Batch({k: torch.as_tensor(v[0]) for k, v in steps[0].items()}), device=dev)
        for tr in steps:
            bs = buf.add(bs, Batch({k: torch.from_numpy(v).to(dev) for k, v in tr.items()}))
        s = slots.to(dev)
        buf.sample_with_weights = lambda st, g, b: (s // 32, s % 32, torch.ones(b, device=dev))
        buf.update_priorities = lambda st, env_idx, pos, td_abs: td_abs
        return algo.update(ts, buf, bs, None, batch)

    noise = rng.normal(size=(2, batch, 1)).astype(np.float32)
    subset = torch.tensor([3, 0])
    makers = {
        "redq": (lambda dev: REDQ(GaussianActor(obs_dim, hidden, 1, conditioned_sigma=True),
                                  CriticEnsemble(obs_dim, 1, hidden, num_critics=5), Box(-1.0, 1.0, (1,)),
                                  ensemble_size=5, subset_size=2, actor_delay=1, alpha_lr=3e-2, device=dev),
                 lambda algo, ts, dev: algo.update_sampled(
                     ts, None, None, sampled(dev, "box"), noise=tuple(torch.from_numpy(noise).to(dev)),
                     subset=subset.to(dev))),
        "discrete_sac": (lambda dev: DiscreteSAC(QNet(obs_dim, hidden, 3), QNetEnsemble(obs_dim, hidden, 3),
                                                 Discrete(3), alpha_lr=3e-2, device=dev),
                         lambda algo, ts, dev: algo.update_sampled(ts, None, None, sampled(dev, "discrete"))),
        "bdq": (lambda dev: BDQ(BranchingQNet(obs_dim, hidden, 2, 4, (16,), (16,)), MultiDiscrete((4, 4)),
                                n_step=2, target_update_freq=1, device=dev),
                lambda algo, ts, dev: algo.update_sampled(ts, None, None, sampled(dev, "multi"))),
        "drqn": (lambda dev: DRQN(RecurrentQNet(obs_dim, 16, 2), Discrete(2), stack_num=4, target_update_freq=1,
                                  device=dev), drqn_update),
    }

    for kind, (make, update) in makers.items():
        runs, init = {}, None
        for dev in ("cuda", "cpu"):
            algo = make(dev)
            ts = algo.init(torch.Generator(device=dev).manual_seed(0))
            parts = ("actor", "critic", "target_critic") if kind in ("redq", "discrete_sac") else ("online", "target")
            if init is None:
                init = {p: {n: v.detach().cpu() for n, v in getattr(ts, p).state_dict().items()} for p in parts}
            for p in parts:
                getattr(ts, p).load_state_dict(init[p])
            ts, out, m = update(algo, ts, dev)
            runs[dev] = (ts, [torch.stack([m[k].float() for k in sorted(m)]), *([out] if out is not None else [])])
        (gts, gout), (cts, cout) = runs["cuda"], runs["cpu"]
        err = max(_assert_close(f"{kind} output {i}", g, c) for i, (g, c) in enumerate(zip(gout, cout)))
        for p in parts:
            for name, v in getattr(gts, p).state_dict().items():
                err = max(err, _assert_close(f"{kind} {p}.{name}", v, getattr(cts, p).state_dict()[name]))
        if kind in ("redq", "discrete_sac"):
            err = max(err, _assert_close(f"{kind} log_alpha", gts.log_alpha, cts.log_alpha))
        log(f"reference {kind}: one update on the card equals the CPU's within rtol 1e-4 / atol 1e-5 (largest "
            f"difference {err:.3e})")

    # a greedy DRQN segment, one step at a time, across episode ends
    env, n_envs, seg_steps = fixed_reset_cartpole(), 4, 40
    start = rng.uniform(-0.15, 0.15, (4, n_envs)).astype(np.float32)
    carry = rng.normal(0.0, 0.5, (2, n_envs, 16)).astype(np.float32)
    runs, init = {}, None
    for dev in ("cuda", "cpu"):
        algo = makers["drqn"][0](dev)
        ts = algo.init(torch.Generator(device=dev).manual_seed(0))
        init = init or {n: v.detach().cpu() for n, v in ts.online.state_dict().items()}
        ts.online.load_state_dict(init)
        venv = VectorEnv(env, n_envs, device=dev)
        st = CartPoleState(*torch.from_numpy(start).to(dev).unbind(0),
                           torch.zeros(n_envs, dtype=torch.int32, device=dev))
        cstate = Collector(algo, venv, device=dev).reset(torch.Generator(device=dev).manual_seed(0))
        cstate.env_state, cstate.obs = st, env._obs(st)
        cstate.policy_state = tuple(torch.from_numpy(carry).to(dev).unbind(0))
        step = rollout_segment(algo, venv, None, 1, explore=False, record_traj=True)
        acts, dones, carries = [], [], []
        for _ in range(seg_steps):
            cstate, _, out = step(ts, cstate, None, 0.0)
            acts.append(out["traj"]["act"][0])
            dones.append(out["done"][0])
            carries.append(torch.stack(cstate.policy_state))
        runs[dev] = (torch.stack(acts), torch.stack(dones), torch.stack(carries))
    (ga, gd, gc), (ca, cd, cc) = runs["cuda"], runs["cpu"]
    if not (torch.equal(ga.cpu(), ca) and torch.equal(gd.cpu(), cd)):
        raise AssertionError("drqn segment: the card's actions or episode ends differ from the CPU's")
    ends = int(cd.sum())
    reset = cc.permute(0, 2, 1, 3)[cd]  # [ends, 2, hidden]: the carries of the envs that just ended
    if ends < 2 or bool(reset.ne(0).any()):
        raise AssertionError(f"drqn segment: {ends} episode ends, carries reset to zeros: {not bool(reset.ne(0).any())}")
    err = _assert_close("drqn segment carries", gc, cc)
    log(f"reference drqn segment: {seg_steps} greedy steps of {n_envs} CartPole envs with {ends} episode ends: the "
        f"same actions on the card and the CPU, each ended env's carry reset to zeros, the carries within rtol "
        f"1e-4 / atol 1e-5 (largest difference {err:.3e})")


def phase_reference_offline() -> None:
    """Slice 7 on the card against the CPU (float32, TF32 off, rtol 1e-4 /
    atol 1e-5), from the same parameters, ring, sampled slots and draws: one
    update each of BC, TD3BC, BCQ, CQL (plain, Lagrange, and CalQL with
    ``prepare_offline``'s returns), DiscreteBCQ, DiscreteCQL, DiscreteCRR in
    each mode and ICM around DQN; GAIL's ``pre_learn`` and
    ``process_rollout``; one PSRL ``learn`` with the same Dirichlet draw;
    ``sample_her`` and one DDPG update from a HER presample."""
    from tianshou_tpu_torch.algos.ddpg import DDPG
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.algos.gail import GAIL
    from tianshou_tpu_torch.algos.icm import ICM, ICMNet
    from tianshou_tpu_torch.algos.offline import BC, BCQ, CQL, TD3BC, DiscreteBCQ, DiscreteCQL, DiscreteCRR
    from tianshou_tpu_torch.algos.psrl import PSRL
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.data.her import HERReplayBuffer
    from tianshou_tpu_torch.envs.spaces import Box, Discrete
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.networks.continuous import (
        VAE, Critic, CriticEnsemble, DeterministicActor, GaussianActor, Perturbation, ValueNet)
    from tianshou_tpu_torch.networks.discrete import QRDQNNet

    rng = np.random.default_rng(8)
    obs_dim, hidden, batch, cap, n_envs = 4, (32, 32), 16, 16, 2
    box, disc = Box(-1.0, 1.0, (2,)), Discrete(3)

    def steps_of(kind, seed):
        r = np.random.default_rng(seed)
        out = []
        for _ in range(40):
            act = (r.uniform(-1, 1, (n_envs, 2)).astype(np.float32) if kind == "box"
                   else r.integers(0, 3, n_envs).astype(np.int32))
            obs, nxt = (r.normal(size=(n_envs, obs_dim)).astype(np.float32) for _ in range(2))
            if kind == "goal":  # [pos, achieved, desired, 0]
                obs[:, 1], nxt[:, 1] = obs[:, 0], nxt[:, 0]
                nxt[:, 2] = obs[:, 2]
                act = r.uniform(-1, 1, (n_envs, 2)).astype(np.float32)
            out.append(dict(obs=obs, act=act, rew=r.normal(size=n_envs).astype(np.float32),
                            terminated=r.random(n_envs) < 0.1, truncated=r.random(n_envs) < 0.1, obs_next=nxt))
        return out

    data = {kind: steps_of(kind, i) for i, kind in enumerate(("box", "discrete", "goal"))}
    slots = torch.from_numpy(rng.choice(n_envs * cap, batch, replace=False))

    def ring(dev, kind, buf=None):
        """The ring of ``kind``'s 40 steps on ``dev``; every sample draws
        ``slots``."""
        buf = buf or ReplayBuffer(cap, n_envs)
        steps = data[kind]
        bs = buf.init(Batch({k: torch.as_tensor(v[0]) for k, v in steps[0].items()}), device=dev)
        for tr in steps:
            bs = buf.add(bs, Batch({k: torch.from_numpy(v).to(dev) for k, v in tr.items()}))
        s = slots.to(dev)
        buf.sample_with_weights = lambda st, g, b: (s // cap, s % cap, torch.ones(b, device=dev))
        return buf, bs

    normals = {shape: rng.normal(size=shape).astype(np.float32) for shape in
               ((batch, 2), (batch * 5, 3), (batch, 3), (batch * 4, 2))}
    uniform = rng.uniform(-1, 1, (batch * 4, 2)).astype(np.float32)

    def on(dev, *arrays):
        return tuple(torch.from_numpy(a).to(dev) for a in arrays)

    def offline_update(kind):
        def update(algo, ts, dev):
            buf, bs = ring(dev, kind)
            ts, _, m = algo.update(ts, buf, bs, None, batch)
            return ts, m, []
        return update

    def td3bc_update(algo, ts, dev):
        buf, bs = ring(dev, "box")
        ts, _, m = algo.update_sampled(ts, buf, bs, algo.presample(buf, bs, None, batch),
                                       noise=on(dev, normals[batch, 2])[0])
        return ts, m, []

    def bcq_update(algo, ts, dev):
        buf, bs = ring(dev, "box")
        noise = on(dev, normals[batch, 3], normals[batch * 5, 3], normals[batch, 3] * 0.5)
        ts, _, m = algo.update(ts, buf, bs, None, batch, noise=noise)
        return ts, m, []

    def cql_update(algo, ts, dev):
        buf, bs = ring(dev, "box")
        bs = algo.prepare_offline(buf, bs)
        noise = on(dev, normals[batch, 2], normals[batch, 2] * 0.5, normals[batch * 4, 2],
                   normals[batch * 4, 2][::-1].copy(), uniform)
        ts, _, m = algo.update(ts, buf, bs, None, batch, noise=noise)
        return ts, m, [bs.storage["calibration_return"]] if algo.calibrated else []

    def icm_update(algo, ts, dev):
        buf, bs = ring(dev, "discrete")
        ts, _, m = algo.update(ts, buf, bs, None, batch)
        return ts, m, []

    traj_np = dict(obs=rng.normal(size=(8, 4, obs_dim)).astype(np.float32),
                   act=rng.normal(size=(8, 4, 2)).astype(np.float32), rew=rng.normal(size=(8, 4)).astype(np.float32),
                   terminated=rng.random((8, 4)) < 0.05, truncated=rng.random((8, 4)) < 0.05,
                   obs_next=rng.normal(size=(8, 4, obs_dim)).astype(np.float32),
                   log_prob=(rng.normal(size=(8, 4)) - 1).astype(np.float32))
    gail_rows = [torch.from_numpy(rng.integers(0, 32, batch)) for _ in range(2)]

    def gail_make(dev):
        buf, bs = ring(dev, "box")
        return GAIL(GaussianActor(obs_dim, hidden, 2), ValueNet(obs_dim, hidden), box,
                    disc_net=Critic(obs_dim, 2, hidden), expert_buffer=buf, expert_buffer_state=bs, disc_lr=1e-2,
                    disc_update_num=2, lr=1e-3, gamma=0.95, gae_lambda=0.95, max_grad_norm=0.5, device=dev)

    def gail_update(algo, ts, dev):
        t = {k: torch.from_numpy(v).to(dev) for k, v in traj_np.items()}
        traj = Batch({k: v for k, v in t.items() if k != "log_prob"}, policy=Batch(log_prob=t["log_prob"]))
        s = slots.to(dev)
        ts, m = algo.pre_learn(ts, traj, None, draws=[(r.to(dev), s // cap, s % cap) for r in gail_rows])
        processed = algo.process_rollout(ts, traj)
        return ts, m, [processed[k] for k in sorted(processed)]

    mb_np = dict(obs=rng.integers(0, 5, (40, 1)), act=rng.integers(0, 2, 40), rew=rng.normal(size=40).astype(np.float32),
                 obs_next=rng.integers(0, 5, (40, 1)))
    dirichlet = rng.dirichlet(np.ones(5), size=(5, 2)).astype(np.float32)

    def psrl_update(algo, ts, dev):
        ts, m = algo.learn(ts, Batch({k: torch.from_numpy(v).to(dev) for k, v in mb_np.items()}),
                           transitions=on(dev, dirichlet)[0])
        return ts, m, [ts.trans_counts, ts.rew_sum, ts.rew_count, ts.value_table, ts.policy_table]

    def her_reward(achieved, desired):
        return torch.where((achieved[:, 0] - desired[:, 0]).abs() <= 0.5, 0.0, -1.0)

    her_u = rng.random((2, batch)).astype(np.float32)

    def her_update(algo, ts, dev):
        buf, bs = ring(dev, "goal", HERReplayBuffer(cap, n_envs, compute_reward_fn=her_reward, achieved_slice=(1, 2),
                                                    desired_slice=(2, 3), horizon=6, future_k=4.0))
        s = slots.to(dev)
        draws = (s // cap, s % cap, *on(dev, *her_u))
        buf.sample_her = lambda st, g, b: HERReplayBuffer.sample_her(buf, st, g, b, draws=draws)
        sampled = algo.presample(buf, bs, None, batch)
        ts, _, m = algo.update_sampled(ts, buf, bs, sampled)
        return ts, m, [sampled[3][k] for k in sorted(sampled[3])]

    ac = ("actor", "critic", "target_actor", "target_critic")
    sac_like = ("actor", "critic", "target_critic")
    dq = ("online", "target")
    cases = {
        "bc": (lambda dev: BC(DeterministicActor(obs_dim, hidden, 2), box, lr=1e-2, device=dev), ("online",),
               offline_update("box")),
        "td3bc": (lambda dev: TD3BC(DeterministicActor(obs_dim, hidden, 2), CriticEnsemble(obs_dim, 2, hidden), box,
                                    update_actor_freq=1, device=dev), ac, td3bc_update),
        "bcq": (lambda dev: BCQ(Perturbation(obs_dim, hidden, 2, phi=0.5), CriticEnsemble(obs_dim, 2, hidden),
                                VAE(obs_dim, hidden, 2, 3), box, num_sampled_action=5, device=dev), ac + ("vae",),
                bcq_update),
        "discrete_bcq": (lambda dev: DiscreteBCQ(QNet(obs_dim, hidden, 3), QNet(obs_dim, hidden, 3), disc,
                                                 target_update_freq=1, device=dev), dq, offline_update("discrete")),
        "discrete_cql": (lambda dev: DiscreteCQL(QRDQNNet(obs_dim, hidden, 3, num_quantiles=8), disc, num_quantiles=8,
                                                 n_step=3, target_update_freq=1, device=dev), dq,
                         offline_update("discrete")),
        "icm": (lambda dev: ICM(DQN(QNet(obs_dim, hidden, 3), disc, n_step=1, target_update_freq=1, device=dev),
                                ICMNet(obs_dim, (16,), 8, 3), reward_scale=0.5), ("icm", "inner.online", "inner.target"),
                icm_update),
        "gail": (gail_make, ("actor", "critic", "disc"), gail_update),
        "psrl": (lambda dev: PSRL(5, Discrete(2), gamma=0.9, device=dev), (), psrl_update),
        "her_ddpg": (lambda dev: DDPG(DeterministicActor(obs_dim, hidden, 2), CriticEnsemble(obs_dim, 2, hidden, 1),
                                      box, device=dev), ac, her_update),
    }
    for variant, kw in (("cql", dict(with_lagrange=False)), ("cql_lagrange", dict(lagrange_threshold=0.5)),
                        ("calql", dict(lagrange_threshold=0.5, calibrated=True))):
        cases[variant] = (lambda dev, kw=kw: CQL(GaussianActor(obs_dim, hidden, 2, conditioned_sigma=True),
                                                 CriticEnsemble(obs_dim, 2, hidden), box, num_repeat_actions=4,
                                                 alpha_lr=3e-2, cql_alpha_lr=3e-2, device=dev, **kw),
                          sac_like + ("log_alpha",) + (("cql_log_alpha",) if variant != "cql" else ()), cql_update)
    for mode in ("exp", "binary", "all"):
        cases[f"discrete_crr_{mode}"] = (
            lambda dev, mode=mode: DiscreteCRR(QNet(obs_dim, hidden, 3), QNet(obs_dim, hidden, 3), disc,
                                               policy_improvement_mode=mode, beta=0.5, target_update_freq=1,
                                               device=dev), dq, offline_update("discrete"))

    def part(ts, name):
        for attr in name.split("."):
            ts = getattr(ts, attr)
        return ts

    def values(obj) -> dict[str, torch.Tensor]:
        return obj.state_dict() if isinstance(obj, torch.nn.Module) else {"": obj}

    for kind, (make, parts, update) in cases.items():
        runs, init = {}, None
        for dev in ("cuda", "cpu"):
            algo = make(dev)
            ts = algo.init(torch.Generator(device=dev).manual_seed(0))
            if init is None:
                init = {p: {n: v.detach().cpu().clone() for n, v in values(part(ts, p)).items()} for p in parts}
            with torch.no_grad():
                for p in parts:
                    for n, v in values(part(ts, p)).items():
                        v.copy_(init[p][n])
            ts, m, out = update(algo, ts, dev)
            runs[dev] = (ts, [torch.stack([m[k].float() for k in sorted(m)]), *out])
        (gts, gout), (cts, cout) = runs["cuda"], runs["cpu"]
        err = max(_assert_close(f"{kind} output {i}", g.float(), c.float()) for i, (g, c) in enumerate(zip(gout, cout)))
        for p in parts:
            for n, v in values(part(gts, p)).items():
                err = max(err, _assert_close(f"{kind} {p} {n}", v, values(part(cts, p))[n]))
        log(f"reference {kind}: one update on the card equals the CPU's within rtol 1e-4 / atol 1e-5 (largest "
            f"difference {err:.3e})")


# -- slice 9: the host path's latency modes, the env pool, host variants -------


def _turns(runs: dict, n: int) -> dict[str, float]:
    """Each of ``runs`` (name -> ``step()``) for ``n`` steps in turns (a, b,
    b, a for two), closed by a synchronisation: the mean ms a step of each."""
    names = list(runs)
    order = names + names[::-1]
    times: dict[str, list[float]] = {k: [] for k in names}
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            runs[name]()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / n * 1e3)
    log("in turns (ms a step, mean of " + f"{len(order) // len(names)} turns of {n}): " + ", ".join(
        f"{k} {sum(v) / len(v):.2f} ({', '.join(f'{x:.2f}' for x in v)})" for k, v in times.items()))
    return {k: sum(v) / len(v) for k, v in times.items()}


def phase_fused(path: str, gather) -> dict:
    """``sac_fine``: the fused fine host cycle at examples/mujoco_sac.py's
    defaults (8 envs, one step each and 8 updates of batch 256 a cycle).
    1 warm-up and 2 timed cycles, its device part (the transition into the
    ring, the updates, the next action) under the sync guard with the action
    fetch left out, the synchronisations of a whole cycle counted, one
    host-to-device copy a cycle, one cycle profiled, then cycles of the
    fused loop and of the segment path (``fused_fine_host=False``) in
    turns."""
    from tianshou_tpu_torch.trainer.offpolicy import FusedHostLoop
    from tianshou_tpu_torch.utils.transfer import TreePacker

    cfg = PATHS[path]
    _fresh_memory()
    env, algo, col, _, trainer = build(path)
    loop, _ = trainer._host_setup()
    if not isinstance(loop, FusedHostLoop):
        raise AssertionError(f"{path}: the trainer did not take the fused fine cycle")
    loop.prime(0.0)
    n = TIMED
    gather.launches = 0
    copies = TreePacker.copies
    dt, metrics = timed(lambda: (loop.cycle(0.0), loop.metrics)[1], n)
    copies = TreePacker.copies - copies
    if gather.launches != 0 or copies != n + WARMUP:
        raise AssertionError(f"{path}: {copies} packed copies and {gather.launches} gather launches in "
                             f"{n + WARMUP} cycles")
    _check_metrics(path, metrics)

    # the device part makes no host synchronisation; the fetch of the next
    # action is the cycle's one
    _, host = loop.step_envs()
    flat = loop.upload(host)
    sync_guarded(lambda: loop.device(flat, 0.0))
    loop.env_act = loop.env_act_device.cpu().numpy()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            loop.cycle(0.0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    if syncs != 1:
        raise AssertionError(f"{path}: {syncs} host synchronisations in a cycle, not 1: "
                             f"{[str(w.message) for w in caught]}")
    _, host = loop.step_envs()
    floats = sum(np.size(x) for x in host.values())
    with _HostToDeviceCopies() as h2d:
        loop.device(loop.upload(host), 0.0)
    loop.env_act = loop.env_act_device.cpu().numpy()
    if h2d.copies != [(floats,)]:
        raise AssertionError(f"{path}: host-to-device copies in a cycle, not one of {floats} floats: {h2d.copies}")
    _, host = loop.step_envs()
    kernels, busy_ms = _profile_counts(lambda: loop.device(loop.upload(host), 0.0))
    loop.env_act = loop.env_act_device.cpu().numpy()
    check_policy(path, algo, loop.ts, torch.as_tensor(col.obs, device=algo.device), loop.generator, env)
    peak = torch.cuda.max_memory_allocated() / 2**30

    # the fused cycle beside the segment path at one step a env
    _, _, _, _, plain_trainer = build_path(path, "cuda", fused=False)
    plain, _ = plain_trainer._host_setup()

    def plain_cycle():
        _, traj = plain.collect(0.0)
        plain.update(traj)
        plain.read_metrics()  # the segment path's own read, as the fused cycle's fetch

    turns = _turns({"fused": lambda: loop.cycle(0.0), "segment path": plain_cycle}, 10)
    result = {"ms_per_cycle": dt / n * 1e3, "env_steps_per_s": n * cfg["num_envs"] / dt, **metrics,
              "updates_per_cycle": cfg["updates"], "syncs_per_cycle": syncs, "h2d_copies_per_cycle": len(h2d.copies),
              "device_kernels_per_cycle": kernels, "device_busy_ms_per_cycle_profiled": busy_ms,
              "max_memory_allocated_gib": peak, "turns_ms_per_cycle": turns}
    log(f"{path}: {n} fused cycles of {cfg['num_envs']} host envs x 1 step + {cfg['updates']} updates of batch "
        f"{cfg['batch']}: {result['ms_per_cycle']:.2f} ms a cycle, metrics {metrics}, {copies} packed copies in "
        f"{n + WARMUP}; the device part under torch.cuda.set_sync_debug_mode('error') raised no host sync, a whole "
        f"cycle made {syncs} (the action fetch); one host-to-device copy of {floats} floats; {kernels} device "
        f"kernels and device busy {busy_ms:.2f} ms in its device part; max_memory_allocated {peak:.3f} GiB")
    for t in (trainer, plain_trainer):
        t.train_collector.venv.close()
        t.test_collector.venv.close()
    return result


# the host variants' segments a turn, cut from 2 to 1 to pay for slice 16's
# collect-graph phase
HOST_VARIANT_TURN = 1
# slice 16: the compiled collection (phase_collect_graph).  The host paths
# whose acting step it holds against eager acting over whole segments, the
# device paths whose test phase it holds against an eager one, and the
# episodes of a test phase
COLLECT_ACTING_PATHS = ("sac_host", "ppo_host", "atari_host", "cpp_cartpole")
COLLECT_TEST_PATHS = ("cartpole", "atari", "hl_cartpole")
TEST_EPISODES = 10
# host launch calls of one replayed acting step at most: the graph launch,
# the generator's seed and offset fills, the observation's copy in and the
# action's copy out
ACTING_REPLAY_HOST_LAUNCHES = 6


@contextlib.contextmanager
def _eager_collection():
    """The collectors and the fused cycle built inside run their steps
    eagerly on the card (``compile_step`` returning the step itself), as the
    reference of the compiled ones: a step keeps the form it was built in."""
    from tianshou_tpu_torch.collect import collector, host_collector
    from tianshou_tpu_torch.trainer import offpolicy

    modules = (collector, host_collector, offpolicy)
    saved = [m.compile_step for m in modules]
    for m in modules:
        m.compile_step = lambda fn, *args, **kwargs: fn
    try:
        yield
    finally:
        for m, fn in zip(modules, saved):
            m.compile_step = fn


def _tree_leaves_named(tree, prefix: str) -> list[tuple[str, torch.Tensor]]:
    """A tree of numpy arrays and tensors (dicts, Batches, tuples) as named
    tensors (numpy leaves wrapped, not copied)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves_named(tree[k], f"{prefix}.{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _tree_leaves_named(v, f"{prefix}[{i}]")]
    if isinstance(tree, np.ndarray) or np.isscalar(tree):
        return [(prefix, torch.from_numpy(np.ascontiguousarray(tree)))]
    return [(prefix, tree)] if isinstance(tree, torch.Tensor) else []


def _hold_equal(what: str, eager: list, graph: list) -> dict:
    """Each pair of named leaves bitwise equal; a float leaf that is not is
    held to phase 4's limits and named (``{name: max abs err}``)."""
    not_bitwise = {}
    for n in _differing(eager, graph):
        a, b = dict(eager)[n], dict(graph)[n]
        if not a.is_floating_point():
            raise AssertionError(f"{what}: graph and eager differ at {n}")
        not_bitwise[n] = _assert_close(f"{what} graph vs eager {n}", b.cpu(), a.cpu())
    if not_bitwise:
        log(f"{what}: graph vs eager not bitwise at {len(not_bitwise)} leaves, within phase 4's limits: "
            f"{not_bitwise}")
    return not_bitwise


def _capture_stream_workspace() -> int:
    """The bytes that one float32 and one bf16 product on the capture
    stream (``utils.graphs.capture_stream``) leave allocated: its library
    workspaces, held for the process (0 where an earlier capture made
    them), counted apart from a capture's peak."""
    from tianshou_tpu_torch.utils.graphs import capture_stream

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    stream = capture_stream(torch.device("cuda", torch.cuda.current_device()))
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.ones(64, 64, device="cuda", dtype=dtype)
            x @ x
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() - before


def _peak_over(fn) -> float:
    """``fn()``'s peak device memory above what was allocated before it,
    in GiB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def _state_gib(*trees) -> float:
    """The GiB of the tensors of ``trees`` (each storage once): a step's
    static state, which its eager form and its graph both hold."""
    from tianshou_tpu_torch.utils.graphs import named_tensors

    seen = {}
    for _, t in named_tensors(trees):
        if t.is_cuda:
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    return sum(seen.values()) / 2**30


def _hold_peak(what: str, state_gib: float, eager: float, graph: float, workspace: float) -> None:
    """The peak memory of a step's first graph unit (its warm-up and
    capture), its static state and the unit's own peak above what was
    allocated before it, less the capture stream's library workspaces, at
    most 1.2x the eager unit's over the same state."""
    if state_gib + graph - workspace > 1.2 * (state_gib + eager):
        raise AssertionError(f"{what}: peak {state_gib:.4f} GiB of static state + {graph:.4f} over the warm-up and "
                             f"capture ({workspace:.4f} the capture stream's workspaces), above 1.2x the eager "
                             f"{state_gib:.4f} + {eager:.4f}")


def _compiled_of(obj) -> list:
    """The compiled steps a collector (acting steps, segments, test chunks)
    holds, CUDA graphs or not."""
    steps = [e[0] for a in getattr(obj, "_acting_steps", {}).values() for e in a._steps.values()]
    acting = getattr(obj, "acting", None)
    if hasattr(acting, "_steps"):
        steps += [e[0] for e in acting._steps.values()]
    return steps + list(getattr(obj, "_compiled", {}).values())


def _graph_counts(steps: list) -> tuple[int, int]:
    """``(captures, replays)`` of compiled steps: each call of a
    ``CapturedStep`` is one or the other (a capture's call runs the step
    eagerly, its warm-up)."""
    from tianshou_tpu_torch.utils.graphs import CapturedStep

    steps = [s for s in steps if isinstance(s, CapturedStep)]
    return sum(len(s.graphs) for s in steps), sum(g.replays for s in steps for g in s.graphs.values())


def _host_segment_case(path: str, pipelined: bool = False) -> dict:
    """A host path's acting step in the host segment (``sac_host``,
    ``ppo_host``, ``atari_host``, ``cpp_cartpole``; ``sac_host`` also on the
    pipelined path, acting on a side stream through a snapshot module): two
    train collectors of the path, reset alike, one acting eagerly and one
    through the compiled acting step, over the same acting module, each
    from its own copy of one collect generator.  Two segments each
    (``HostCollector.collect``, the first the graph's warm-up and capture),
    bitwise in every trajectory leaf, the next observations and the
    generators' states; the first graph trajectory unchanged by the second
    segment and sharing no storage with it; ms a segment in turns (eager,
    graph, graph, eager) and of the acting steps alone; one graph segment
    profiled (host launch calls a step, device records); the peak memory of
    the graph's first segment (its warm-up and capture) against an eager
    segment's."""
    from tianshou_tpu_torch.utils.device import make_generator
    from tianshou_tpu_torch.utils.graphs import CapturedStep

    _fresh_memory()
    small = PHASE_SMALL.get(path, {})
    _, algo, col, _, trainer = build(path, **small)
    _, _, col_e, _, trainer_e = build(path, **small)
    col_e.algo = algo  # both act through one algorithm and one acting module
    ts = algo.init(make_generator(0, "cuda"))
    side = torch.cuda.Stream() if pipelined else None
    if pipelined:
        snapshot = copy.deepcopy(algo.act_params(ts)).requires_grad_(False)
    for c in (col, col_e):
        c.reset(seed=5)
    gens = {"graph": make_generator(1, "cuda")}
    gens["eager"] = _copy_generator(gens["graph"])
    steps = trainer.segment_len

    def acting_ts():
        # the pipelined loop's: a fresh shallow copy each segment, over one snapshot module
        return algo.with_act_params(ts, snapshot) if pipelined else ts

    def segment(name):
        c = col if name == "graph" else col_e
        with _eager_collection() if name == "eager" else contextlib.nullcontext():
            out = c.collect(acting_ts(), None, steps, gens[name], explore=True, explore_param=0.1, record_traj=True,
                            stream=side)[2]
        return out

    def leaves(name, traj):
        c = col if name == "graph" else col_e
        return (_tree_leaves_named(traj, "traj") + _tree_leaves_named(c.obs, "obs")
                + [("generator", gens[name].get_state())])

    workspace = _capture_stream_workspace() / 2**30
    peaks, trajs, first = {}, {}, []
    for name in ("eager", "graph"):
        held = {}
        peaks[name] = _peak_over(lambda: held.setdefault("traj", segment(name)))
        if name == "graph":  # the first graph trajectory as returned, before the next segment
            first = [(n, t.clone()) for n, t in _tree_leaves_named(held["traj"], "traj")]
        trajs[name] = [held["traj"], segment(name)]
    not_bitwise = {}
    for i in range(2):
        not_bitwise.update(_hold_equal(f"{path} acting segment {i}", leaves("eager", trajs["eager"][i]),
                                       leaves("graph", trajs["graph"][i])))
    if _differing(first, _tree_leaves_named(trajs["graph"][0], "traj")):
        raise AssertionError(f"{path}: a later segment changed an earlier returned trajectory")
    ptrs = [t.data_ptr() for _, t in _tree_leaves_named(trajs["graph"][1], "traj") if t.is_cuda]
    if any(t.data_ptr() in ptrs for _, t in _tree_leaves_named(trajs["graph"][0], "traj") if t.is_cuda):
        raise AssertionError(f"{path}: two segments' trajectories share storage")
    compiled = col.acting(acting_ts(), gens["graph"], True, 0.1, steps).compiled
    if not isinstance(compiled, CapturedStep) or len(compiled.graphs) != 1:
        raise AssertionError(f"{path}: the acting step is a {type(compiled).__name__}")
    replays = sum(g.replays for g in compiled.graphs.values())
    if replays != 2 * steps - 1:
        raise AssertionError(f"{path}: {replays} replays in 2 segments of {steps} steps, 1 capture")
    del trajs
    turns = _turns({"eager": lambda: segment("eager"), "graph": lambda: segment("graph")}, 1)
    obs = col.obs

    def acting_alone(name):
        c = col if name == "graph" else col_e
        with _eager_collection() if name == "eager" else contextlib.nullcontext():
            a = c.acting(acting_ts(), gens[name], True, 0.1, steps)
        for _ in range(steps):
            a(obs)

    acting_turns = _turns({"eager": lambda: acting_alone("eager"), "graph": lambda: acting_alone("graph")}, 1)
    profiled = {"eager": _profile(lambda: segment("eager")), "graph": _profile(lambda: segment("graph"))}
    calls = profiled["graph"]["host_launch_calls"]
    launches = calls.get("cudaGraphLaunch", 0) + calls.get("cuGraphLaunch", 0)
    # a segment: its replays, and the fills of explore_param and the cursor
    # and the copies out of the segment
    per_step = profiled["graph"]["host_launches"] / steps
    if launches != steps or profiled["graph"]["host_launches"] > ACTING_REPLAY_HOST_LAUNCHES * steps + 4:
        raise AssertionError(f"{path}: a replayed segment's host launches {profiled['graph']}")
    eager_peak = peaks["eager"]
    state = _state_gib(algo.act_params(ts), compiled.cstate)
    _hold_peak(f"{path} acting", state, eager_peak, peaks["graph"], workspace)
    name = f"{path}{' pipelined' if pipelined else ''}"
    result = {"bitwise": not not_bitwise, "not_bitwise": not_bitwise, "segment_ms_turns": turns,
              "acting_steps_alone_ms_turns": acting_turns, "profiled": profiled,
              "host_launches_per_replay": per_step, "peak_gib": {"eager": eager_peak, "graph": peaks["graph"],
                                                                 "capture_stream_workspace": workspace,
                                                                 "static_state": state},
              "warm_up_s": compiled.warm_up_s, "capture_s": compiled.capture_s, "replays": replays,
              "copy_back_bytes": compiled.copy_back_bytes}
    log(f"{name} acting graph: two segments of {steps} steps vs eager acting "
        f"{'bitwise' if not not_bitwise else 'within limits'} (trajectories, next observations, generator); "
        f"segments own their trajectories; ms a segment in turns eager {turns['eager']:.2f} graph "
        f"{turns['graph']:.2f}, the acting steps alone eager {acting_turns['eager']:.2f} graph "
        f"{acting_turns['graph']:.2f}; profiled segment: eager {profiled['eager']['kernels']} records / "
        f"{profiled['eager']['host_launches']} host launches, graph {profiled['graph']['kernels']} records / "
        f"{profiled['graph']['host_launches']} host launches {calls} ({per_step:.2f} a step); peak over the first "
        f"segment eager {eager_peak * 2**10:.3f} MiB, graph {peaks['graph'] * 2**10:.3f} MiB on a static state of "
        f"{state * 2**10:.3f} MiB (warm-up "
        f"{compiled.warm_up_s * 1e3:.1f} ms, capture {compiled.capture_s * 1e3:.1f} ms)")
    for t in (trainer, trainer_e):
        t.train_collector.venv.close()
        t.test_collector.venv.close()
    return result


def _async_case() -> dict:
    """``AsyncHostCollector`` at ``sac_host``'s configuration, ``wait_num`` 4
    of 8: segments of 64 transitions acting eagerly and through the
    compiled acting step in turns (the envs finish in a racing order, so
    the two are held bitwise on recorded inputs instead: the acting step
    over the rounds' recorded observations, from one generator state);
    then a DRQN carry advanced for a random half of the rows each round,
    eager against the graph, bitwise (carries, actions, generator)."""
    from tianshou_tpu_torch.algos.drqn import DRQN
    from tianshou_tpu_torch.collect.async_collector import AsyncHostCollector, AsyncHostVectorEnv
    from tianshou_tpu_torch.collect.host_collector import ActingStep
    from tianshou_tpu_torch.envs.spaces import Discrete
    from tianshou_tpu_torch.networks.common import RecurrentQNet
    from tianshou_tpu_torch.utils.device import make_generator
    from tianshou_tpu_torch.utils.graphs import own_storage

    cfg = PATHS["sac_host"]
    _fresh_memory()
    _, algo, _, buffer, trainer = build_path("sac_host", "cuda")
    loop, _ = trainer._host_setup()
    ts = loop.ts
    venvs = {k: AsyncHostVectorEnv([HalfCheetahStandIn] * cfg["num_envs"], wait_num=4) for k in ("eager", "graph")}
    cols = {k: AsyncHostCollector(algo, v, buffer, device="cuda") for k, v in venvs.items()}
    bstates = {"eager": loop.bstate, "graph": copy.deepcopy(loop.bstate)}
    gen = make_generator(2, "cuda")
    recorded = []
    call = ActingStep.__call__

    def spy(self, obs, mask=None):
        recorded.append(np.array(obs))
        return call(self, obs, mask)

    def segment(name):
        with _eager_collection() if name == "eager" else contextlib.nullcontext():
            bstates[name], stats = cols[name].collect(ts, bstates[name], cfg["num_envs"] * cfg["segment"], gen)
        return stats

    try:
        for c in cols.values():
            c.reset(seed=1)
        ActingStep.__call__ = spy
        try:
            segment("eager")
        finally:
            ActingStep.__call__ = call
        segment("graph")
        turns = _turns({"eager": lambda: segment("eager"), "graph": lambda: segment("graph")}, 1)
        h2d, d2h = _profile_memcpys(lambda: segment("graph"))
    finally:
        for v in venvs.values():
            v.close()
    # the acting step alone on the recorded rounds, eager against the graph
    acts, gens_ = {}, {k: make_generator(3, "cuda") for k in ("eager", "graph")}
    for name in ("eager", "graph"):
        with _eager_collection() if name == "eager" else contextlib.nullcontext():
            a = ActingStep(algo, torch.device("cuda")).begin(ts, recorded[0], gens_[name], True, 0.1)
        acts[name] = [("act", torch.from_numpy(a(o))) for o in recorded * 2]
    not_bitwise = _hold_equal("async acting rounds", acts["eager"] + [("gen", gens_["eager"].get_state())],
                              acts["graph"] + [("gen", gens_["graph"].get_state())])
    # a recurrent carry advanced for the dispatched rows only
    drqn = DRQN(RecurrentQNet(17, 128, 4), Discrete(4), device="cuda")
    dts = drqn.init(make_generator(4, "cuda"))
    rng = np.random.default_rng(5)
    obs = [rng.normal(size=(8, 17)).astype(np.float32) for _ in range(8)]
    masks = [rng.random(8) < 0.5 for _ in obs]
    carry_leaves = {}
    for name in ("eager", "graph"):
        carry = own_storage(drqn.init_policy_state(8))
        g = make_generator(6, "cuda")
        with _eager_collection() if name == "eager" else contextlib.nullcontext():
            a = ActingStep(drqn, torch.device("cuda")).begin(dts, obs[0], g, True, 0.3, policy_state=carry)
        out = [(f"act[{i}]", torch.from_numpy(a(o, m))) for i, (o, m) in enumerate(zip(obs * 2, masks * 2))]
        carry_leaves[name] = out + [(f"carry[{i}]", t) for i, t in enumerate(carry)] + [("gen", g.get_state())]
        if name == "graph" and sum(gr.replays for gr in a.compiled.graphs.values()) != 15:
            raise AssertionError("async DRQN acting: not 15 replays after a capture")
    not_bitwise.update(_hold_equal("async DRQN carry", carry_leaves["eager"], carry_leaves["graph"]))
    result = {"segment_ms_turns": turns, "bitwise": not not_bitwise, "not_bitwise": not_bitwise,
              "rounds_recorded": len(recorded), "h2d_copies_per_segment": h2d, "d2h_copies_per_segment": d2h}
    log(f"async wait_num 4 of 8 acting graph: ms a segment of {cfg['num_envs'] * cfg['segment']} transitions in turns "
        f"eager {turns['eager']:.2f} "
        f"graph {turns['graph']:.2f}; the acting step over {2 * len(recorded)} recorded rounds and a DRQN carry "
        f"advanced for the dispatched rows over 16 rounds {'bitwise' if not not_bitwise else 'within limits'} "
        f"against eager; the card ran {h2d} host-to-device and {d2h} device-to-host copies in a graph segment")
    trainer.train_collector.venv.close()
    trainer.test_collector.venv.close()
    return result


def _fused_case() -> dict:
    """``sac_fine``'s fused fine cycle compiled (``_compile_fused_cycle``):
    after the first cycle (the warm-up and capture), two cycles replayed
    against two eager cycles (``FusedHostLoop.device_fn`` on a copy of the
    state and a staging of its own) on the same host transitions, bitwise in
    the train state, the ring, the staging (the pending raw and env
    actions), the metrics and the generator; ms a cycle in turns; one replay
    profiled; the peak memory of the first cycle against an eager cycle's."""
    from tianshou_tpu_torch.utils.graphs import CapturedStep, named_tensors

    _fresh_memory()
    _, algo, col, _, trainer = build("sac_fine")
    loop, _ = trainer._host_setup()
    loop.prime(0.0)
    workspace = _capture_stream_workspace() / 2**30
    _, host = loop.step_envs()
    graph_peak = _peak_over(lambda: loop.device(loop.upload(host), 0.0))
    if not isinstance(loop.compiled, CapturedStep):
        raise AssertionError(f"sac_fine: the fused cycle compiled a {type(loop.compiled).__name__}")
    loop.env_act = loop.env_act_device.cpu().numpy()
    memo = {id(loop.generator): _copy_generator(loop.generator)}
    e_ts, e_staging, e_bstate = copy.deepcopy((loop.ts, loop.staging, loop.bstate), memo)
    e_gen = memo[id(loop.generator)]

    def eager(host):
        nonlocal e_ts, e_bstate
        loop._packer.to_device(host, out=e_staging[0])
        e_ts, _, e_bstate, _, metrics = loop.device_fn(e_ts, e_staging, e_bstate, e_gen, 0.0)
        return metrics

    def leaves(ts, staging, bstate, gen, metrics):
        return (named_tensors((ts, staging[1:], bstate)) + [("generator", gen.get_state())]
                + [(f"metrics[{k!r}]", v) for k, v in metrics.items()])

    not_bitwise = {}
    for i in range(2):
        _, host = loop.step_envs()
        held = {}
        peak = _peak_over(lambda: held.setdefault("metrics", eager(host)))
        eager_peak = peak if i == 0 else eager_peak
        loop.device(loop.upload(host), 0.0)
        loop.env_act = loop.env_act_device.cpu().numpy()
        not_bitwise.update(_hold_equal(f"sac_fine cycle {i}",
                                       leaves(e_ts, e_staging, e_bstate, e_gen, held["metrics"]),
                                       leaves(loop.ts, loop.staging, loop.bstate, loop.generator, loop.metrics)))
    replays = sum(g.replays for g in loop.compiled.graphs.values())

    def eager_cycle():
        _, h = loop.step_envs()
        eager(h)
        e_staging[2].cpu()

    turns = _turns({"eager": eager_cycle, "graph": lambda: loop.cycle(0.0)}, 5)
    _, host = loop.step_envs()
    eager_profiled = _profile(lambda: eager(host))
    profiled = _profile(lambda: loop.device(loop.upload(host), 0.0))
    loop.env_act = loop.env_act_device.cpu().numpy()
    calls = profiled["host_launch_calls"]
    if calls.get("cudaGraphLaunch", 0) + calls.get("cuGraphLaunch", 0) != 1 or profiled["host_launches"] > 8:
        raise AssertionError(f"sac_fine: a replayed cycle's host launches {profiled}")
    state = _state_gib(loop.ts, loop.staging, loop.bstate)
    _hold_peak("sac_fine cycle", state, eager_peak, graph_peak, workspace)
    result = {"bitwise": not not_bitwise, "not_bitwise": not_bitwise, "cycle_ms_turns": turns,
              "profiled": {"eager": eager_profiled, "graph": profiled},
              "peak_gib": {"eager": eager_peak, "graph": graph_peak, "capture_stream_workspace": workspace,
                           "static_state": state},
              "warm_up_s": loop.compiled.warm_up_s, "capture_s": loop.compiled.capture_s, "replays": replays,
              "copy_back_bytes": loop.compiled.copy_back_bytes}
    log(f"sac_fine cycle graph: {len(loop.compiled.graphs)} graph(s); two replays vs two eager cycles "
        f"{'bitwise' if not not_bitwise else 'within limits'}; ms a cycle in turns eager {turns['eager']:.2f} graph "
        f"{turns['graph']:.2f}; profiled: eager {eager_profiled['kernels']} records, busy {eager_profiled['busy_ms']:.2f} "
        f"ms, {eager_profiled['host_launches']} host launches; a replay {profiled['kernels']} records, busy "
        f"{profiled['busy_ms']:.2f} ms, {profiled['host_launches']} host launches {calls}; peak eager {eager_peak * 2**10:.2f} MiB, warm-up and "
        f"capture {graph_peak * 2**10:.2f} MiB on a static state of {state * 2**10:.2f} MiB (warm-up {loop.compiled.warm_up_s:.2f} s, capture "
        f"{loop.compiled.capture_s:.2f} s)")
    trainer.train_collector.venv.close()
    trainer.test_collector.venv.close()
    return result


def _test_phase_case(path: str) -> dict:
    """A device path's test phase (``Collector.collect_episodes``, 10
    episodes): the path's test collector replaying its chunk graph against a
    second collector over the same envs acting eagerly, from one train
    state and copies of one generator: two test phases each (the graph's
    first chunk its warm-up and capture; the second phase resets the static
    collect state in place and re-seeds its registered generator, which the
    replays must honour), bitwise in the returns, lengths, the collect
    state and the generators; ms a test phase in turns; one replayed chunk
    profiled; the peak memory of the first graph phase against an eager
    phase's."""
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.utils.device import fork_generator, make_generator
    from tianshou_tpu_torch.utils.graphs import CapturedStep

    _fresh_memory()
    _, algo, _, _, trainer = build(path)
    col = trainer.test_collector
    col_e = Collector(algo, col.venv, device="cuda", reward_metric=col.reward_metric)
    gen = make_generator(0, "cuda")
    ts = algo.init(fork_generator(gen))
    gens = {"graph": gen, "eager": _copy_generator(gen)}
    cols = {"graph": col, "eager": col_e}

    def phase(name):
        with _eager_collection() if name == "eager" else contextlib.nullcontext():
            return cols[name].collect_episodes(ts, gens[name], TEST_EPISODES, explore=False)

    def leaves(name, stats):
        # the eager chunks hand back new collect states, so the draws are
        # held through both streams' states
        return [("returns", torch.from_numpy(stats.returns)), ("lens", torch.from_numpy(stats.lens)),
                ("generator", gens[name].get_state()), ("collect rng", cols[name]._episode_state.rng.get_state())]

    workspace = _capture_stream_workspace() / 2**30
    stats, peaks = {}, {}
    for name in ("eager", "graph"):
        held = {}
        peaks[name] = _peak_over(lambda: held.setdefault("s", phase(name)))
        stats[name] = [held["s"], phase(name)]
        if name == "graph":
            replays_after = _graph_counts(_compiled_of(col))
    not_bitwise = {}
    for i in range(2):
        not_bitwise.update(_hold_equal(f"{path} test phase {i}", leaves("eager", stats["eager"][i]),
                                       leaves("graph", stats["graph"][i])))
    step = col._compiled["episodes"]
    if not isinstance(step, CapturedStep) or len(step.graphs) != 1 or not replays_after[1]:
        raise AssertionError(f"{path}: the test phase's chunks {replays_after} (captures, replays)")
    turns = _turns({"eager": lambda: phase("eager"), "graph": lambda: phase("graph")}, 1)
    eager_chunk = col_e._compiled["episodes"]  # the step itself (made under _eager_collection)
    eager_profiled = _profile(lambda: eager_chunk(ts, col_e._episode_state, None, col_e._episode_state.rng, 0.0))
    profiled = _profile(lambda: step(ts, col._episode_state, None, col._episode_state.rng, 0.0))
    chunks = sum(g.replays for g in step.graphs.values()) + 1
    state = _state_gib(ts, col._episode_state)
    _hold_peak(f"{path} test phase", state, peaks["eager"], peaks["graph"], workspace)
    s = stats["graph"][0]
    result = {"bitwise": not not_bitwise, "not_bitwise": not_bitwise, "phase_ms_turns": turns,
              "returns_mean": s.returns_mean, "episodes": s.n_collected_episodes, "chunks_run": chunks,
              "profiled_chunk": {"eager": eager_profiled, "graph": profiled},
              "copy_back_bytes": step.copy_back_bytes, "peak_gib": {"eager": peaks["eager"], "graph": peaks["graph"],
                                                       "capture_stream_workspace": workspace,
                                                       "static_state": state},
              "warm_up_s": step.warm_up_s, "capture_s": step.capture_s}
    log(f"{path} test-phase graph: {s.n_collected_episodes} episodes (mean return {s.returns_mean:.2f}); two "
        f"phases vs eager {'bitwise' if not not_bitwise else 'within limits'} (returns, lengths, collect state, "
        f"generators: the re-seeded registered generator honoured); ms a phase in turns eager {turns['eager']:.2f} "
        f"graph {turns['graph']:.2f}; {chunks} chunks of 128 steps so far, 1 capture; an eager chunk profiled "
        f"{eager_profiled['kernels']} records, busy {eager_profiled['busy_ms']:.2f} ms, "
        f"{eager_profiled['host_launches']} host launches; a replayed chunk {profiled['kernels']} records, busy {profiled['busy_ms']:.2f} ms, {profiled['host_launches']} host launches "
        f"{profiled['host_launch_calls']}; peak eager {peaks['eager'] * 2**10:.2f} MiB, graph "
        f"{peaks['graph'] * 2**10:.2f} MiB on a static state of {state * 2**10:.2f} MiB (warm-up {step.warm_up_s:.2f} s, capture {step.capture_s:.2f} s)")
    return result


def phase_collect_graph() -> dict:
    """Slice 16, the compiled collection, each compiled step against its
    eager form on the card: the host collectors' acting step in the host
    segment (``COLLECT_ACTING_PATHS``, and ``sac_host`` pipelined), the
    async collector's at ``wait_num`` 4 of 8 (with a DRQN carry), the fused
    fine cycle (``sac_fine``) and a 10-episode test phase of the device
    ``Collector`` (``COLLECT_TEST_PATHS``)."""
    out = {}
    for path in COLLECT_ACTING_PATHS:
        out[path] = _host_segment_case(path)
    out["sac_host pipelined"] = _host_segment_case("sac_host", pipelined=True)
    out["async"] = _async_case()
    out["sac_fine"] = _fused_case()
    for path in COLLECT_TEST_PATHS:
        out[f"{path} test phase"] = _test_phase_case(path)
    return out


def _run_collection(path: str, trainer) -> dict:
    """The collection steps that ``trainer.run()`` compiled: each call of
    an acting step, a fused cycle, a segment or a test chunk was a capture's
    warm-up or a replay (a ``CapturedStep`` has no third way); their counts,
    with at least one replay on the host paths."""
    from tianshou_tpu_torch.utils.graphs import CapturedStep

    steps = _compiled_of(getattr(trainer, "train_collector", None)) + _compiled_of(trainer.test_collector)
    steps += [s for s in (getattr(trainer, "compiled_fused_cycle", None),) if s is not None]
    captures, replays = _graph_counts(steps)
    if any(not isinstance(s, CapturedStep) for s in steps):
        raise AssertionError(f"{path}: run() stepped an eager collection step on the card")
    if replays == 0 and path in HOST_PATHS + FUSED_PATHS:
        raise AssertionError(f"{path}: run()'s collection replayed no graph")
    log(f"{path} run() collection: {len(steps)} compiled steps, {captures} warm-ups (each before its capture), "
        f"{replays} replays")
    return {"steps": len(steps), "captures": captures, "replays": replays}


def phase_cpp_bench(num_envs: int = 16, steps: int = 2000) -> dict[str, float]:
    """examples/cpp_pool_dqn.py --bench: the native pool's raw step rate,
    env steps a second, on CartPole-v1 and Reacher2 (the host's CPU, no
    card)."""
    from tianshou_tpu_torch.envs.cpp_pool import CppVectorEnv

    rng = np.random.default_rng(0)
    rows = {}
    for task, act_fn in (("CartPole-v1", lambda: rng.integers(0, 2, num_envs)),
                         ("Reacher2", lambda: rng.uniform(-1, 1, (num_envs, 2)).astype(np.float32))):
        env = CppVectorEnv(task, num_envs, seed=0)
        env.reset()
        for _ in range(10):
            env.step(act_fn())
        t0 = time.perf_counter()
        for _ in range(steps):
            env.step(act_fn())
        rows[task] = num_envs * steps / (time.perf_counter() - t0)
        env.close()
    log(f"cpp pool raw step rate, {num_envs} envs x {steps} steps: "
        + ", ".join(f"{k} {v:,.0f} env-steps/s" for k, v in rows.items()))
    return rows


@contextlib.contextmanager
def _farm(num_envs: int):
    """A port env farm in a subprocess on 127.0.0.1 serving
    ``HalfCheetahStandIn``; yields its address; killed at exit."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tianshou_tpu_torch.envs.remote", "--env", "chip_smoke:HalfCheetahStandIn",
         "--num-envs", str(num_envs), "--port", "0", "--host", "127.0.0.1"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline, line = time.monotonic() + 120, ""
        while "serving" not in line:
            ready, _, _ = select.select([proc.stdout], [], [], max(0.0, deadline - time.monotonic()))
            if not ready:
                raise TimeoutError("the env farm did not report its port in 120 s")
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError(f"the env farm exited with {proc.wait(timeout=10)}")
        yield f"127.0.0.1:{int(line.rsplit(':', 1)[1])}"
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()


def phase_host_variants(n: int = 2) -> dict:
    """sac_host's configuration through the host path's variants, each in
    turns with plain sac_host (plain, variant, variant, plain; ``n``
    segments a turn): a ``RemoteVectorEnv`` over a farm subprocess,
    ``AsyncHostCollector`` with ``wait_num`` 4 of 8 (64 transitions into
    the ring, then the 64 updates), and ``act_on_host=True``.  For each, ms
    a segment and the copies the card ran each way in one segment."""
    from tianshou_tpu_torch.collect.async_collector import AsyncHostCollector, AsyncHostVectorEnv
    from tianshou_tpu_torch.collect.host_collector import HostCollector
    from tianshou_tpu_torch.envs.host import HostVectorEnv
    from tianshou_tpu_torch.envs.remote import RemoteVectorEnv
    from tianshou_tpu_torch.trainer.offpolicy import build_update_scan

    cfg = PATHS["sac_host"]
    _fresh_memory()
    opened = []

    def host_loop(venv=None, act_on_host=False):
        _, algo, col, buffer, trainer = build_path("sac_host", "cuda")
        if venv is not None or act_on_host:
            col.venv.close()
            trainer.train_collector = HostCollector(
                algo, venv or HostVectorEnv([HalfCheetahStandIn] * cfg["num_envs"]), buffer, device="cuda",
                act_on_host=act_on_host)
        opened.append(trainer)
        loop, _ = trainer._host_setup()

        def segment():
            _, traj = loop.collect(0.0)
            loop.update(traj)
            loop.read_metrics()
        return segment

    def async_loop():
        _, algo, _, buffer, trainer = build_path("sac_host", "cuda")
        opened.append(trainer)
        loop, _ = trainer._host_setup()
        venv = AsyncHostVectorEnv([HalfCheetahStandIn] * cfg["num_envs"], wait_num=4)
        opened.append(venv)
        acol = AsyncHostCollector(algo, venv, buffer, device="cuda")
        acol.reset(seed=1)
        updates = build_update_scan(algo, buffer, cfg["batch"], cfg["updates"])

        def segment():
            loop.bstate, _ = acol.collect(loop.ts, loop.bstate, cfg["num_envs"] * cfg["segment"], loop.generator)
            loop.ts, loop.bstate, loop.metrics = updates(loop.ts, loop.bstate, loop.generator)
            loop.read_metrics()
        return segment

    results = {}
    plain = host_loop()
    try:
        with _farm(cfg["num_envs"]) as address:
            variants = {"remote farm": lambda: host_loop(RemoteVectorEnv([address])),
                        "async wait_num 4 of 8": async_loop,
                        "act_on_host": lambda: host_loop(act_on_host=True)}
            for name, make in variants.items():
                step = make()
                for fn in (plain, step):
                    fn()  # warm-up
                turns = _turns({"plain sac_host": plain, name: step}, n)
                h2d, d2h = _profile_memcpys(step)
                results[name] = {"ms_per_segment": turns[name], "plain_ms_per_segment": turns["plain sac_host"],
                                 "h2d_copies_per_segment": h2d, "d2h_copies_per_segment": d2h}
                log(f"host variant {name}: {turns[name]:.2f} ms a segment beside plain sac_host's "
                    f"{turns['plain sac_host']:.2f}; the card ran {h2d} host-to-device and {d2h} device-to-host "
                    "copies in one segment")
            h2d, d2h = _profile_memcpys(plain)
            results["plain sac_host"] = {"h2d_copies_per_segment": h2d, "d2h_copies_per_segment": d2h}
            log(f"host variant plain sac_host: the card ran {h2d} host-to-device and {d2h} device-to-host copies "
                "in one segment")
    finally:
        for t in opened:
            if isinstance(t, AsyncHostVectorEnv):
                t.close()
            else:
                t.train_collector.venv.close()
                t.test_collector.venv.close()
    return results


def _free_port() -> int:
    with contextlib.closing(socket.socket()) as sock:
        sock.settimeout(5.0)
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_nccl_world1() -> None:
    """The default process group over NCCL at world size 1, as a launch on
    the one card would start it (``init_distributed`` starts nothing for
    one process)."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=300))
    log(f"process group: backend {dist.get_backend()}, world size {dist.get_world_size()}")


def build_dist_path(path: str):
    """A distributed path at its plain path's full width: ``(algo, buffer or
    None, plain trainer, distributed trainer)``, the two trainers sharing the
    algorithm, collectors and buffer (their states are their own)."""
    from tianshou_tpu_torch.trainer.distributed import DistributedOffPolicyTrainer, DistributedOnPolicyTrainer

    base = DIST_PATHS[path]
    cfg = PATHS[base]
    _, algo, train, buffer, plain = build(base)
    steps = cfg["num_envs"] * cfg["segment"]
    common = dict(max_epoch=1, step_per_epoch=2 * steps, step_per_collect=steps, batch_size=cfg["batch"],
                  episode_per_test=plain.episode_per_test, device="cuda")
    if buffer is None:
        trainer = DistributedOnPolicyTrainer(algo, train, plain.test_collector, repeat_per_collect=cfg["repeat"],
                                             **common)
    else:
        trainer = DistributedOffPolicyTrainer(
            algo, train, plain.test_collector, buffer, update_per_step=plain.update_per_step,
            train_param_fn=plain.train_param_fn, test_param=plain.test_param, warmup_steps=plain.warmup_steps,
            **common)
    if (trainer.segment_len, trainer.updates_per_segment) != (plain.segment_len, plain.updates_per_segment):
        raise AssertionError(f"{path}: distributed split {trainer.segment_len} / {trainer.updates_per_segment}")
    return algo, buffer, plain, trainer


def dist_superstep_of(trainer, state: list, generators):
    """The distributed trainer's eager segment over ``state`` (``[ts, cstate,
    bstate]``, updated in place; ``bstate`` None on-policy), its metrics
    averaged over the ranks inside it, as ``run()`` reads them: ``step() ->
    device metrics``."""
    fn = trainer._build_superstep()

    def step():
        if state[2] is None:
            state[0], state[1], _, metrics = fn(state[0], state[1], generators)
        else:
            state[0], state[1], state[2], _, metrics = fn(*state, generators, 0.1)
        return metrics

    return step


def _all_reduces(fn) -> list[int]:
    """The bytes of each ``torch.distributed.all_reduce`` that ``fn()``
    calls."""
    import torch.distributed as dist

    sizes, original = [], dist.all_reduce

    def counting(tensor, *args, **kwargs):
        sizes.append(tensor.numel() * tensor.element_size())
        return original(tensor, *args, **kwargs)

    dist.all_reduce = counting
    try:
        fn()
    finally:
        dist.all_reduce = original
    return sizes


def phase_dist_update_check(algo, buffer, bstate, group) -> float:
    """``dist_atari``: one update of the distributed trainer (gradients
    all-reduced over the NCCL group) against the plain trainer's update,
    from the same parameters and the same presampled batch: losses and
    parameters within the card-vs-CPU update tolerance (rtol 1e-4 / atol
    1e-5).  Returns the largest parameter difference."""
    from tianshou_tpu_torch.parallel.distributed import data_parallel
    from tianshou_tpu_torch.utils.device import make_generator

    batch = PATHS["atari"]["batch"]
    sampled = algo.presample(buffer, bstate, make_generator(6, "cuda"), batch)
    runs = []
    for distributed in (False, True):
        ts = algo.init(make_generator(5, "cuda"))
        with data_parallel(algo, group if distributed else None, batch):
            ts, _, metrics = algo.update_sampled(ts, buffer, bstate, sampled, make_generator(7, "cuda"))
        runs.append((ts, _read(metrics)))
    (plain, pm), (dist_ts, dm) = runs
    for k in pm:
        if not math.isclose(pm[k], dm[k], rel_tol=1e-4, abs_tol=1e-5):
            raise AssertionError(f"dist_atari update: {k} plain {pm[k]} vs distributed {dm[k]}")
    err = max(_assert_close(f"dist_atari update {k}", v, plain.online.state_dict()[k])
              for k, v in dist_ts.online.state_dict().items())
    log(f"dist_atari: one distributed update (NCCL all-reduce) equals the plain update on the same batch of "
        f"{batch}: loss {dm['loss']:.6f} vs {pm['loss']:.6f}, largest parameter difference {err:.3e}")
    return err


def _dist_gens(state: list) -> list:
    """A distributed run state's generators (``[ts, cstate, bstate,
    generators]``): the step's (one, or the learn and sample pair), then
    the collect state's."""
    g = state[3]
    return [*(g if isinstance(g, tuple) else (g,)), state[1].rng]


def _clone_dist_state(state: list) -> list:
    """``[ts, cstate, bstate, generators]`` copied, sharing no tensor or
    generator with the original."""
    memo = {id(g): _copy_generator(g) for g in _dist_gens(state)}
    g = state[3]
    return [*copy.deepcopy(tuple(state[:3]), memo),
            tuple(memo[id(x)] for x in g) if isinstance(g, tuple) else memo[id(g)]]


def _dist_leaves(state: list, outputs=None, metrics=None, ring: bool = True) -> list[tuple[str, torch.Tensor]]:
    """The named tensors of a distributed run state, its generators' states
    included (the ring's storage only with ``ring``), and of a segment's
    outputs and metrics."""
    from tianshou_tpu_torch.data.tree import tree_leaves
    from tianshou_tpu_torch.utils.graphs import named_tensors

    leaves = [(n, t) for n, t in named_tensors(tuple(state[:3])) if ring or not n.startswith("state[2].storage")]
    leaves += [(f"generator[{i}]", g.get_state()) for i, g in enumerate(_dist_gens(state))]
    if outputs is not None:
        leaves += [(f"outputs[{i}]", t) for i, t in enumerate(tree_leaves(outputs))]
        leaves += [(f"metrics[{k!r}]", v) for k, v in metrics.items()]
    return leaves


def _dist_eager(trainer):
    """The distributed trainer's eager segment in the compiled step's form
    ``(ts, cstate, bstate, generators, explore_param) -> (ts, cstate,
    bstate, outputs, metrics)``."""
    from tianshou_tpu_torch.trainer.distributed import DistributedOnPolicyTrainer

    fn = trainer._build_superstep()
    if not isinstance(trainer, DistributedOnPolicyTrainer):
        return fn

    def step(ts, cstate, bstate, generator, explore_param):
        ts, cstate, outputs, metrics = fn(ts, cstate, generator)
        return ts, cstate, bstate, outputs, metrics

    return step


def phase_dist_graph(what: str, trainer, state: list, gather, launches: int, beside: dict | None = None,
                     not_bitwise_op: str | None = None) -> dict:
    """A distributed trainer's compiled segment (``_compile_superstep``: CUDA
    graphs of ``_build_superstep`` with the collectives as nodes) on the
    world-1 NCCL group, from ``state`` (``[ts, cstate, bstate,
    generators]``).  An eager segment's peak memory on a copy of the state,
    then the compiled segment's first calls until every branch pattern is
    captured (each an eager warm-up, then its capture; the peak over them
    with the static state at most 1.2x the eager one's, the capture
    stream's workspace apart; ``gather_rows_cast``'s host launches:
    ``launches`` a warm-up); from copies of the state they leave, two eager
    segments (optimizers capturable, as the graph's) against two replays,
    bitwise in every carried tensor, every generator's state, ``outputs``
    and ``metrics`` (where ``not_bitwise_op`` names an operation that
    forbids it, a leaf that is not bitwise is held to phase 4's limits and
    named), none from the host in the replays (as many of each as there are
    patterns, where more than two); the
    collectives each capture counted against the eager segment's
    ``all_reduce`` calls and bytes of the same pattern, every one issued on
    the capturing stream; ms a segment in turns (eager,
    graph and ``beside``'s steps, then back); an eager segment and a replay
    profiled (kernels, busy time, NCCL kernels, host launch calls: one graph
    launch and a few fills a replay; the kernel's device launches in the
    replay); a replay under the sync guard; the peak a replay; the ring's
    storage unmoved."""
    from tianshou_tpu_torch.data.tree import tree_leaves
    from tianshou_tpu_torch.utils.graphs import CapturedStep

    explore = torch.full((), 0.1, device="cuda")
    eager_fn = _dist_eager(trainer)

    def eager_step(st):
        st[0], st[1], st[2], outputs, metrics = eager_fn(*st[:3], st[3], explore)
        return outputs, metrics

    workspace = _capture_stream_workspace() / 2**30
    state_gib = _state_gib(*state[:3])
    spare = _clone_dist_state(state)
    eager_peak = _peak_over(lambda: eager_step(spare))
    del spare
    compiled = trainer._compile_superstep(*state[:2]) if state[2] is None else trainer._compile_superstep(*state[:3])
    if not isinstance(compiled, CapturedStep):
        raise AssertionError(f"{what}: _compile_superstep gave a {type(compiled).__name__} on the NCCL group")

    def graph_step(st):
        st[0], st[1], st[2], outputs, metrics = compiled(*st[:3], st[3], explore)
        return outputs, metrics

    storage = [t.data_ptr() for t in tree_leaves(state[2].storage)] if state[2] is not None else []
    patterns = _pattern_count(trainer.algo, state[0], trainer.updates_per_segment)
    calls = 0

    def warm_up():
        nonlocal calls
        while len(compiled.graphs) < patterns and calls < 64:
            graph_step(state)
            calls += 1

    gather.launches = 0
    t0 = time.perf_counter()
    capture_peak = _peak_over(warm_up)
    warm_s = time.perf_counter() - t0
    warm_launches = gather.launches
    if len(compiled.graphs) != patterns or warm_launches != launches * patterns:
        raise AssertionError(f"{what}: {len(compiled.graphs)} graphs for {patterns} patterns in {calls} calls, "
                             f"gather_rows_cast launched {warm_launches} times from the host")
    _hold_peak(what, state_gib, eager_peak, capture_peak, workspace)
    eager_state = _clone_dist_state(state)
    snaps: dict[str, list] = {"eager": [], "graph": []}
    eager_reduces, graph_collectives, seen = [], [], {}
    replays, compared = sum(g.replays for g in compiled.graphs.values()), max(2, patterns)
    for name in ("eager", "graph"):
        gather.launches = 0
        for _ in range(compared):
            if name == "eager":
                out = []
                eager_reduces.append(_all_reduces(lambda: out.append(eager_step(eager_state))))
                outputs, metrics = out[0]
            else:
                graph_collectives.append(compiled.graphs[compiled.key()].collectives)
                outputs, metrics = graph_step(state)
            st = eager_state if name == "eager" else state
            snaps[name].append([(n, t.detach().clone()) for n, t in _dist_leaves(st, outputs, metrics, ring=False)])
        seen[name] = gather.launches
    if sum(g.replays for g in compiled.graphs.values()) != replays + compared:
        raise AssertionError(f"{what}: the {compared} compared graph segments were not all replays")
    if seen["graph"] != 0 or seen["eager"] != compared * launches:
        raise AssertionError(f"{what}: gather_rows_cast launched {seen} times from the host in {compared} segments")
    for got, sizes in zip(graph_collectives, eager_reduces):
        if got != [("allreduce_", b) for b in sizes]:
            raise AssertionError(f"{what}: a capture counted the collectives {got}, an eager segment all_reduce "
                                 f"{sizes}")
    differ = sorted(set(sum((_differing(e, g) for e, g in zip(snaps["eager"], snaps["graph"])), [])
                        + _differing(_dist_leaves(eager_state), _dist_leaves(state))))
    # the collect stream draws every step: it advances across replays (the
    # others, as far as the eager segments advance them)
    rngs = [[v for n, v in s if n.startswith("generator[")][-1] for s in snaps["graph"][:2]]
    if torch.equal(*rngs):
        raise AssertionError(f"{what}: the collect generator did not advance between two replays")
    if differ and not_bitwise_op is None:
        raise AssertionError(f"{what}: graph and eager segments differ at {differ[:8]}")
    not_bitwise = {}
    for n in differ:
        errs = []
        for i in range(compared):
            got, ref = dict(snaps["graph"][i]), dict(snaps["eager"][i])
            if n in got and not _bitwise(got[n], ref[n]):
                if not got[n].is_floating_point():
                    raise AssertionError(f"{what}: graph and eager segments differ at {n}")
                errs.append(_assert_close(f"{what} graph vs eager {n}", got[n], ref[n]))
        not_bitwise[n] = max(errs, default=0.0)
    if differ:
        log(f"{what}: graph vs eager not bitwise at {len(differ)} leaves ({not_bitwise_op}), within phase 4's "
            f"limits, largest difference {max(not_bitwise.values()):.3e} at {max(not_bitwise, key=not_bitwise.get)}")
    del snaps
    runs = {"eager": lambda: eager_step(eager_state), "graph": lambda: graph_step(state), **(beside or {})}
    turns = _turns(runs, 1)
    profiled = {"eager": _profile(lambda: eager_step(eager_state)), "graph": _profile(lambda: graph_step(state))}
    host_calls = profiled["graph"]["host_launch_calls"]
    if (host_calls.get("cudaGraphLaunch", 0) + host_calls.get("cuGraphLaunch", 0) != 1
            or profiled["graph"]["host_launches"] > LEARN_REPLAY_HOST_LAUNCHES):
        raise AssertionError(f"{what}: a replayed segment's host launches {profiled['graph']}")
    if len(profiled["graph"]["gather_rows_cast_ms"]) != launches:
        raise AssertionError(f"{what}: a profiled replay ran gather_rows_cast "
                             f"{len(profiled['graph']['gather_rows_cast_ms'])} times, not {launches}")
    del eager_state
    sync_guarded(lambda: graph_step(state))
    replay_peak = _peak_over(lambda: graph_step(state))
    metrics = _read(graph_step(state)[1])
    if storage and [t.data_ptr() for t in tree_leaves(state[2].storage)] != storage:
        raise AssertionError(f"{what}: the ring's storage moved")
    collectives = [c for g in compiled.graphs.values() for c in g.collectives]
    result = {"graphs": len(compiled.graphs), "patterns": patterns, "warm_up_calls": calls,
              "warm_up_and_capture_s": warm_s, "warm_ups_s": compiled.warm_up_s, "captures_s": compiled.capture_s,
              "warm_up_gather_launches": warm_launches, "bitwise": not differ, "not_bitwise": not_bitwise,
              "turns_ms": turns, "ms_per_segment": turns["graph"], "eager_ms_per_segment": turns["eager"],
              "profiled": profiled, "device_busy_share": {k: profiled[k]["busy_ms"] / turns[k] for k in profiled},
              "graphs_replayed": sum(g.replays > 0 for g in compiled.graphs.values()),
              "collectives_per_capture": [len(g.collectives) for g in compiled.graphs.values()],
              "collective_bytes_per_capture": [sum(b for _, b in g.collectives) for g in compiled.graphs.values()],
              "eager_all_reduce_calls": [len(x) for x in eager_reduces],
              "eager_all_reduce_bytes": [sum(x) for x in eager_reduces],
              "state_gib": state_gib, "eager_peak_gib": eager_peak, "capture_peak_gib": capture_peak,
              "replay_peak_gib": replay_peak, "capture_stream_workspace_gib": workspace,
              "copy_back_bytes": compiled.copy_back_bytes, "metrics": metrics,
              "gather_rows_cast_per_replay_profiled": len(profiled["graph"]["gather_rows_cast_ms"])}
    log(f"{what} graph: {len(compiled.graphs)} graph(s) for {patterns} pattern(s) in {calls} call(s), {warm_s:.2f} s "
        f"(warm-ups {compiled.warm_up_s:.2f} s, captures {compiled.capture_s:.2f} s); {compared} replays (of "
        f"{result['graphs_replayed']} graphs) vs {compared} eager segments {'bitwise' if not differ else 'within limits'}; collectives counted at the captures "
        f"{result['collectives_per_capture']} ({result['collective_bytes_per_capture']} bytes; {len(collectives)} "
        f"in all, every one on the capturing stream), an eager segment's all_reduce {result['eager_all_reduce_calls']}"
        f" ({result['eager_all_reduce_bytes']} bytes); ms a segment in turns "
        + ", ".join(f"{k} {v:.2f}" for k, v in turns.items())
        + f"; profiled: eager {profiled['eager']['kernels']} records ({profiled['eager']['nccl_kernels']} NCCL) / "
        f"{profiled['eager']['host_launches']} host launches, graph {profiled['graph']['kernels']} records "
        f"({profiled['graph']['nccl_kernels']} NCCL) / {profiled['graph']['host_launches']} host launches "
        f"{host_calls}; busy share eager {result['device_busy_share']['eager']:.3f} graph "
        f"{result['device_busy_share']['graph']:.3f}; peak {state_gib:.3f} GiB of static state + eager "
        f"{eager_peak:.3f} / warm-ups and captures {capture_peak:.3f} (workspace {workspace:.3f}) / a replay "
        f"{replay_peak:.3f}; {compiled.copy_back_bytes} bytes copied back a segment; gather_rows_cast "
        f"{warm_launches} host launches in the warm-ups, {result['gather_rows_cast_per_replay_profiled']} device "
        f"launches in a profiled replay; a replay under the sync guard raised nothing")
    return result


def phase_distributed(path: str, gather) -> dict:
    """A distributed path on the world-1 NCCL group: the compiled segment
    against its eager form (:func:`phase_dist_graph`), the plain trainer's
    compiled superstep beside it in the turns; on the off-policy paths the
    per-update presample and gradient all-reduce alone; ``dist_atari`` also
    holds one distributed update against the plain one."""
    base = DIST_PATHS[path]
    cfg = PATHS[base]
    _fresh_memory()
    algo, buffer, plain, trainer = build_dist_path(path)
    gen, *plain_state = init_states(algo, plain.train_collector, buffer)
    plain_state.append(gen)
    plain_compiled = (plain._compile_superstep(*plain_state[:2]) if buffer is None
                      else plain._compile_superstep(*plain_state[:3]))

    def plain_graph():
        st = plain_state
        st[0], st[1], st[2], _, metrics = plain_compiled(*st[:3], st[3], 0.1)
        return metrics

    plain_graph()  # its warm-up and capture, before the turns
    if buffer is None:
        g, ts, cstate, _ = init_states(algo, trainer.train_collector, None, seed=1)
        state = [ts, cstate, None, g]
    else:
        ts, cstate, bstate, generators, _ = trainer.init_states()
        state = [ts, cstate, bstate, generators]
    result = phase_dist_graph(path, trainer, state, gather, DIST_KERNEL_LAUNCHES[path], {"plain graph": plain_graph},
                              DIST_NOT_BITWISE.get(path))
    _check_metrics(base, result["metrics"])
    result["updates_per_segment"] = updates = trainer.updates_per_segment
    result["gradient_bytes_per_update"] = (
        sum(p.numel() * p.element_size() for p in algo.act_params(state[0]).parameters()) if buffer is not None else 0)
    if buffer is not None:
        # the two parts the distributed segment adds per update, each alone
        from tianshou_tpu_torch.algos.base import sync_gradients

        ts, bstate, generators = state[0], state[2], state[3]
        result["breakdown_ms"] = breakdown({
            "presample (one update)": lambda: algo.presample(buffer, bstate, generators[1], trainer.batch_local),
            "gradient all-reduce (one update)": lambda: sync_gradients(ts.optimizer, trainer.group)})
        log(f"{path} breakdown (median of 3, ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in result["breakdown_ms"].items()))
    log(f"{path}: {cfg['num_envs']} envs x {cfg['segment']} steps + {updates} updates of batch {cfg['batch']} "
        f"(world 1, NCCL): replayed {result['ms_per_segment']:.2f} ms a segment, eager "
        f"{result['eager_ms_per_segment']:.2f}, the plain trainer's graph {result['turns_ms']['plain graph']:.2f}; "
        f"metrics {result['metrics']}; gradients {result['gradient_bytes_per_update']} bytes an update")
    if path == "dist_atari":
        result["update_check_max_abs_err"] = phase_dist_update_check(algo, buffer, state[2], trainer.group)
    del plain_compiled, plain_state, state
    _fresh_memory()
    result["trainer"] = trainer
    return result


def phase_dist_main(path: str, trainer, gather) -> int:
    """The distributed trainer's ``run()`` for one epoch of two segments with
    a test phase: every segment a warm-up (before its capture) or a
    replay, at least one a replay; the kernel's launches from the host (the
    warm-up's) and on the card (the profiler's, every segment's) over
    exactly that run."""
    cfg = PATHS[DIST_PATHS[path]]
    segtree = {} if DIST_PATHS[path] in PER_PATHS else None
    info, host, device = _counted_run(path, gather, trainer.run, segtree)
    log(f"{path} {type(trainer).__name__}.run(): {info}")
    captures = _run_captures(path, trainer, 2)
    launches = _run_launches(path, host, device, 2, captures)
    if segtree is not None:
        _check_segtree_run(path, segtree, 2, captures)
    warmup = cfg.get("warmup", 0) // cfg["num_envs"] * cfg["num_envs"]
    if info.env_step != warmup + 2 * cfg["num_envs"] * cfg["segment"] or info.gradient_step != 2 * cfg["updates"]:
        raise AssertionError(f"{path}: counters env_step={info.env_step} gradient_step={info.gradient_step}")
    _check_metrics(DIST_PATHS[path], info.last_metrics)
    if not math.isfinite(info.best_reward):
        raise AssertionError(f"{path}: non-finite best reward: {info}")
    return launches


def phase_dist_update_graph() -> dict:
    """``make_distributed_update`` on the world-1 NCCL group at
    ``cartpole``'s widths (QNet (128, 128, 128), gamma 0.9, target every
    320) with one-step targets (the function serves those only), batch
    1024 made from a seed: three staged calls (the warm-up and capture, then
    two replays) against three eager updates (``update.eager``, Adam
    capturable as the graph's), bitwise in the train state and the metrics,
    the capture's collectives against the eager update's all-reduces, and
    against the plain ``update_sampled`` (no group, Adam as built) within
    rtol 1e-4 / atol 1e-5; ms an update in turns."""
    import torch.distributed as dist

    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.envs.classic import CartPole
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.parallel.distributed import make_distributed_update
    from tianshou_tpu_torch.utils.device import make_generator
    from tianshou_tpu_torch.utils.graphs import CapturedStep, named_tensors, optimizers, prepare_optimizer

    batch = DIST_UPDATE["batch"]
    env = CartPole()
    algo = DQN(QNet(4, (128, 128, 128), 2), env.action_space, gamma=0.9, n_step=1, target_update_freq=320,
               device="cuda")
    rng = np.random.default_rng(11)

    def transitions():
        terminated = rng.random(batch) < 0.05
        on = lambda x: torch.from_numpy(x).to("cuda")  # noqa: E731
        return dict(obs=on(rng.normal(size=(batch, 4)).astype(np.float32)), act=on(rng.integers(0, 2, batch)),
                    rew=on(rng.normal(size=batch).astype(np.float32)), terminated=on(terminated),
                    truncated=on((rng.random(batch) < 0.05) & ~terminated),
                    obs_next=on(rng.normal(size=(batch, 4)).astype(np.float32)))

    batches = [transitions() for _ in range(DIST_UPDATE["updates"])]
    ts, e_ts, p_ts = (algo.init(make_generator(5, "cuda")) for _ in range(3))
    for opt in optimizers(e_ts):  # as the capture prepares the graph's
        prepare_optimizer(opt)
    update = make_distributed_update(algo)
    gen, e_gen, p_gen = (make_generator(7, "cuda") for _ in range(3))
    differ = []
    for tr in batches:
        out, metrics = update(ts, tr, gen)
        eager = []
        sizes = _all_reduces(lambda: eager.append(update.eager(e_ts, tr, e_gen)))
        e_ts, e_metrics = eager[0]
        graph = next(iter(update.compiled.graphs.values()))
        if graph.collectives != [("allreduce_", b) for b in sizes]:
            raise AssertionError(f"make_distributed_update: the capture counted {graph.collectives}, the eager update "
                                 f"all_reduce {sizes}")
        differ += _differing(named_tensors(out) + [(f"metrics[{k!r}]", v) for k, v in metrics.items()],
                             named_tensors(e_ts) + [(f"metrics[{k!r}]", v) for k, v in e_metrics.items()])
        done = tr["terminated"] | tr["truncated"]
        sampled = (torch.zeros(batch, dtype=torch.int64, device="cuda"),
                   torch.zeros(batch, dtype=torch.int64, device="cuda"), torch.ones(batch, device="cuda"),
                   Batch(obs=tr["obs"], act=tr["act"]), tr["rew"][:, None], done.to(torch.int32)[:, None],
                   Batch(obs_next=tr["obs_next"], terminated=tr["terminated"]))
        p_ts, _, p_metrics = algo.update_sampled(p_ts, None, None, sampled, p_gen)
    compiled = update.compiled
    if not isinstance(compiled, CapturedStep) or len(compiled.graphs) != 1 or graph.replays != len(batches) - 1:
        raise AssertionError(f"make_distributed_update: {type(compiled).__name__}, {len(compiled.graphs)} graphs, "
                             f"{graph.replays} replays")
    if differ:
        raise AssertionError(f"make_distributed_update: replays differ from eager updates at {sorted(set(differ))}")
    err = max(_assert_close(f"make_distributed_update vs update_sampled {k}", v, p_ts.online.state_dict()[k])
              for k, v in ts.online.state_dict().items())
    for k, v in _read(metrics).items():
        if not math.isclose(v, float(p_metrics[k]), rel_tol=1e-4, abs_tol=1e-5):
            raise AssertionError(f"make_distributed_update: {k} {v} vs update_sampled {float(p_metrics[k])}")
    replays, tr = graph.replays, batches[-1]
    turns = _turns({"eager": lambda: update.eager(e_ts, tr, e_gen), "graph": lambda: update(ts, tr, gen)}, 3)
    result = {"backend": dist.get_backend(), "batch": batch, "replays": replays, "bitwise": True,
              "collectives": graph.collectives, "plain_max_abs_err": err, "turns_ms": turns,
              "metrics": _read(metrics)}
    log(f"make_distributed_update (world 1, NCCL, batch {batch}, cartpole widths, n 1): {replays} replays of "
        f"one graph bitwise equal to eager updates, the capture's collectives {graph.collectives} equal to the "
        f"eager update's all-reduces; against the plain update_sampled: largest parameter difference {err:.3e}; ms "
        f"an update in turns eager {turns['eager']:.3f} graph {turns['graph']:.3f}")
    return result


def gloo_rank_main(rank: int, port: int, out: str) -> int:
    """One of two gloo ranks sharing the card (``--gloo-rank``): DQN on the
    on-device CartPole through ``DistributedOffPolicyTrainer`` on CUDA
    tensors (``GLOO_RANKS``); saves the parameters and the run's result."""
    import datetime

    import torch.distributed as dist

    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.envs.classic import CartPole
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.trainer.distributed import DistributedOffPolicyTrainer

    cfg = GLOO_RANKS
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=GLOO_RANK_TIMEOUT))
    try:
        env = CartPole()
        algo = DQN(QNet(4, (64, 64), 2), env.action_space, lr=1e-3, gamma=0.9, n_step=3, target_update_freq=320,
                   device="cuda")
        buffer = ReplayBuffer(cfg["capacity"], cfg["num_envs"])
        steps = 2 * cfg["num_envs"] * cfg["segment"]
        trainer = DistributedOffPolicyTrainer(
            algo, Collector(algo, VectorEnv(env, cfg["num_envs"], device="cuda"), buffer, device="cuda"),
            Collector(algo, VectorEnv(env, cfg["num_envs"], device="cuda"), device="cuda"), buffer, max_epoch=1,
            step_per_epoch=cfg["segments"] * steps, step_per_collect=steps, update_per_step=cfg["update_per_step"],
            batch_size=cfg["batch"], episode_per_test=5, train_param_fn=lambda epoch, step: 0.1,
            warmup_steps=cfg["warmup"], seed=0, device="cuda")
        t0 = time.perf_counter()
        info = trainer.run()
        torch.save({"params": {k: v.cpu() for k, v in trainer.train_state.online.state_dict().items()},
                    "metrics": info.last_metrics, "env_step": info.env_step, "gradient_step": info.gradient_step,
                    "best_reward": info.best_reward, "seconds": time.perf_counter() - t0,
                    "backend": dist.get_backend(), "segment": type(trainer.compiled_superstep).__name__}, out)
    finally:
        dist.destroy_process_group()
    return 0


def phase_gloo_ranks() -> dict:
    """Two ranks on the one card over gloo, each a subprocess of this script
    on CUDA tensors: after the run their parameters must be bitwise equal
    and the losses they read equal, and ``run()`` must have stepped the
    eager segment (gloo's collectives run on the host, which a stream
    capture cannot record).  Every process is killed in a ``finally``; each
    wait is bounded."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": root}
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(2)]
        procs, logs = [], []
        try:
            for r in range(2):
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--gloo-rank", str(r), "--port", str(port),
                     "--out", outs[r]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=root, env=env))
            for p in procs:
                logs.append(p.communicate(timeout=GLOO_RANK_TIMEOUT)[0].decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        for r, (p, out) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"gloo rank {r} failed (rc {p.returncode}):\n{out[-4000:]}")
        ranks = [torch.load(o, weights_only=False) for o in outs]
    a, b = ranks
    unequal = [k for k in a["params"] if not torch.equal(a["params"][k], b["params"][k])]
    if unequal or a["metrics"] != b["metrics"]:
        raise AssertionError(f"the two gloo ranks differ: parameters {unequal}, metrics {a['metrics']} vs "
                             f"{b['metrics']}")
    if not all(math.isfinite(v) for v in a["metrics"].values()):
        raise AssertionError(f"gloo ranks: non-finite metrics {a['metrics']}")
    if a["segment"] == "CapturedStep" or b["segment"] == "CapturedStep":
        raise AssertionError("gloo ranks: run() captured a segment over a gloo group")
    result = {k: a[k] for k in ("metrics", "env_step", "gradient_step", "best_reward", "backend", "segment")}
    result["seconds"] = [r["seconds"] for r in ranks]
    log(f"two gloo ranks on one card (CUDA tensors): parameters bitwise equal, losses read equal {a['metrics']}; "
        f"env_step {a['env_step']}, gradient_step {a['gradient_step']}, best {a['best_reward']}, run() "
        f"{result['seconds'][0]:.1f} / {result['seconds'][1]:.1f} s; the segment eager ({a['segment']}): gloo runs "
        f"its collectives on the host, which a stream capture cannot record")
    return result


def _redq_ep_sampled(batch: int, seed: int = 3) -> tuple:
    """A presample tuple of ``batch`` Pendulum-shaped rows made from a seed,
    on the card."""
    from tianshou_tpu_torch.data.batch import Batch

    rng = np.random.default_rng(seed)

    def on(x):
        return torch.from_numpy(x).to("cuda")

    zeros = torch.zeros(batch, dtype=torch.int64, device="cuda")
    return (zeros, zeros, on(rng.uniform(0.5, 1.5, batch).astype(np.float32)),
            Batch(obs=on(rng.normal(size=(batch, 3)).astype(np.float32)),
                  act=on(rng.uniform(-1, 1, (batch, 1)).astype(np.float32))),
            on(rng.normal(size=(batch, 1)).astype(np.float32)), on((rng.random((batch, 1)) < 0.05).astype(np.int32)),
            Batch(obs_next=on(rng.normal(size=(batch, 3)).astype(np.float32)),
                  terminated=on(rng.random(batch) < 0.05)))


def _redq_state(ts) -> dict[str, torch.Tensor]:
    """A REDQ train state's parameters on the host, its ensembles gathered
    (every rank of a sharded one calls it)."""
    from tianshou_tpu_torch.networks.common import full_state_dict

    out = {f"actor.{k}": v.detach().cpu().clone() for k, v in ts.actor.state_dict().items()}
    out.update({f"critic.{k}": v.detach().cpu().clone() for k, v in full_state_dict(ts.critic).items()})
    out.update({f"target.{k}": v.detach().cpu().clone() for k, v in full_state_dict(ts.target_critic).items()})
    out["log_alpha"] = ts.log_alpha.detach().cpu().clone()
    return out


def _redq_ep_update(mesh, actor_step: bool):
    """One REDQ update at ``redq_pendulum``'s widths from the seed-5
    parameters on ``_redq_ep_sampled``'s batch with the update generator
    seeded alike, once in one process and once with the critics sharded
    over the mesh's ``"ep"`` axis (rows and gradients over ``"dp"``);
    ``actor_step``: the update is the actor delay's, so the actor and alpha
    step too.  Float32, TF32 off.  Returns both runs' gathered parameters
    and metrics and the critics a rank holds."""
    from tianshou_tpu_torch.parallel.distributed import average_metrics, data_parallel
    from tianshou_tpu_torch.parallel.mesh import shard_ensemble_modules
    from tianshou_tpu_torch.utils.device import make_generator

    cfg = PATHS[REDQ_EP["base"]]
    _, algo, _, _, _ = build(REDQ_EP["base"])
    sampled = _redq_ep_sampled(cfg["batch"])
    dp, ep = mesh.get_group("dp"), mesh.get_group("ep")
    runs = []
    torch.backends.cuda.matmul.allow_tf32, saved = False, torch.backends.cuda.matmul.allow_tf32
    try:
        for sharded in (False, True):
            ts = algo.init(make_generator(5, "cuda"))
            if sharded:
                shard_ensemble_modules(ts, ep)
            if actor_step:
                ts.step = algo.actor_delay - 1
            with data_parallel(algo, dp if sharded else None, cfg["batch"]):
                ts, _, metrics = algo.update_sampled(ts, None, None, sampled, make_generator(7, "cuda"))
            runs.append((_redq_state(ts), _read(average_metrics(metrics, dp) if sharded else metrics),
                         ts.critic.weights[0].shape[0]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return runs


def _hold_redq_ep(what: str, one, sharded, bitwise: bool) -> float:
    """A sharded update's gathered parameters and metrics against the
    one-process update's: bitwise (``bitwise``) or within ``REDQ_EP``'s
    limits (the JAX test's).  Returns the largest parameter difference."""
    (ref, ref_m, _), (got, got_m, _) = one, sharded
    err = 0.0
    for k, v in ref.items():
        diff = float((got[k] - v).abs().max())
        err = max(err, diff)
        ok = torch.equal(got[k], v) if bitwise else torch.allclose(
            got[k], v, rtol=REDQ_EP["param_rtol"], atol=REDQ_EP["param_atol"])
        if not ok:
            raise AssertionError(f"redq_ep {what}: {k} differs by {diff:.3e} (bitwise={bitwise})")
    for k, v in ref_m.items():
        if (got_m[k] != v) if bitwise else not math.isclose(got_m[k], v, rel_tol=REDQ_EP["loss_rtol"], abs_tol=1e-7):
            raise AssertionError(f"redq_ep {what}: {k} {got_m[k]} vs one process {v} (bitwise={bitwise})")
    return err


def redq_ep_update_check(mesh, bitwise: bool) -> dict:
    """REDQ's first update (its critics' step) and an update that steps the
    actor and alpha too, each with the critics sharded against the
    one-process update: the losses and the gathered parameters bitwise
    (``bitwise``, ``ep = 1``) or within ``REDQ_EP``'s limits (the JAX
    test's).  Only the actor step runs the input operator's backward (the
    critics' input has no gradient in their own step)."""
    one, sharded = _redq_ep_update(mesh, actor_step=False)
    k_full, k_local = one[2], sharded[2]
    if k_local * torch.distributed.get_world_size(mesh.get_group("ep")) != k_full:
        raise AssertionError(f"redq_ep: a rank holds {k_local} of {k_full} critics")
    err = _hold_redq_ep("update", one, sharded, bitwise)
    one_a, sharded_a = _redq_ep_update(mesh, actor_step=True)
    err_a = _hold_redq_ep("update with an actor step", one_a, sharded_a, bitwise)
    (ref, _, _), (got, _, _) = one_a, sharded_a
    actor = {k: float((got[k] - v).abs().max()) for k, v in ref.items()}
    return {"metrics": sharded[1], "one_process_metrics": one[1], "max_abs_err": err, "critics_a_rank": k_local,
            "bitwise": bitwise, "bitwise_equal": all(torch.equal(sharded[0][k], v) for k, v in one[0].items()),
            "actor_step_max_abs_err": err_a, "actor_step_worst": max(actor, key=actor.get),
            "actor_step_metrics": [sharded_a[1], one_a[1]]}


class _Collectives:
    """Counts, while on, the ``torch.distributed.all_reduce`` calls and bytes
    and, among them, the ensembles' gathers (``EnsembleShard.gather``)."""

    def __enter__(self):
        import torch.distributed as dist

        from tianshou_tpu_torch.networks.common import EnsembleShard

        self.all_reduce, self.gathers = [], []
        self._saved = dist.all_reduce, EnsembleShard.gather
        reduce, gather = self._saved

        def counting_reduce(tensor, *args, **kwargs):
            self.all_reduce.append(tensor.numel() * tensor.element_size())
            return reduce(tensor, *args, **kwargs)

        def counting_gather(shard, local):
            out = gather(shard, local)
            self.gathers.append(out.numel() * out.element_size())
            return out

        dist.all_reduce, EnsembleShard.gather = counting_reduce, counting_gather
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        from tianshou_tpu_torch.networks.common import EnsembleShard

        dist.all_reduce, EnsembleShard.gather = self._saved


def redq_ep_rank_main(rank: int, port: int, out: str) -> int:
    """One of the two gloo ranks of ``redq_ep`` (``--redq-ep-rank``) on CUDA
    tensors: the update check, then the ep segments in turns with the plain
    ``redq_pendulum`` superstep (the plain one on rank 0 alone, rank 1 at a
    barrier), their collectives and kernels, then ``run()`` for
    ``REDQ_EP["segments"]`` segments; saves what it measured and its
    parameters."""
    import datetime

    import torch.distributed as dist

    from tianshou_tpu_torch.parallel.mesh import make_mesh2
    from tianshou_tpu_torch.trainer.distributed import DistributedOffPolicyTrainer

    cfg = PATHS[REDQ_EP["base"]]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=REDQ_EP["ranks"], rank=rank,
                            timeout=datetime.timedelta(seconds=GLOO_RANK_TIMEOUT))
    try:
        mesh = make_mesh2(REDQ_EP["ranks"], second_size=REDQ_EP["ep"], device="cuda")
        result = {"update_check": redq_ep_update_check(mesh, bitwise=False), "backend": dist.get_backend()}
        _, algo, train, buffer, plain = build(REDQ_EP["base"])
        steps = cfg["num_envs"] * cfg["segment"]

        def trainer(segments):
            return DistributedOffPolicyTrainer(
                algo, train, plain.test_collector, buffer, max_epoch=1, step_per_epoch=segments * steps,
                step_per_collect=steps, update_per_step=plain.update_per_step, batch_size=cfg["batch"],
                episode_per_test=plain.episode_per_test, warmup_steps=plain.warmup_steps, mesh=mesh, device="cuda")

        ep_trainer = trainer(REDQ_EP["segments"])
        ts, cstate, bstate, generators, _ = ep_trainer.init_states()
        ep_step = dist_superstep_of(ep_trainer, [ts, cstate, bstate], generators)
        gen, *plain_state = init_states(algo, plain.train_collector, buffer)
        plain_step = superstep_of(plain, plain_state, gen)
        turns = {"plain": [], "ep": []}
        for kind in ("plain", "ep", "ep", "plain"):
            dist.barrier()
            if kind == "ep" or rank == 0:
                dt, _ = timed(ep_step if kind == "ep" else plain_step, 1)
                turns[kind].append(dt * 1e3)
            dist.barrier()
        with _Collectives() as coll:
            metrics = _read(ep_step())
        if rank == 0:
            kernels, busy_ms = _profile_counts(ep_step)
        else:  # its peer's segment, unprofiled
            ep_step()
            kernels, busy_ms = 0, 0.0
        result.update(turns_ms=turns, metrics=metrics, all_reduce_calls_per_segment=len(coll.all_reduce),
                      all_reduce_bytes_per_segment=sum(coll.all_reduce), gathers_per_segment=len(coll.gathers),
                      gather_bytes_per_segment=sum(coll.gathers), device_kernels_per_segment=kernels,
                      device_busy_ms_per_segment_profiled=busy_ms,
                      updates_per_segment=ep_trainer.updates_per_segment)
        # the main path: run() for the configured segments after the warm-up
        t0 = time.perf_counter()
        main = trainer(REDQ_EP["segments"])
        info = main.run()
        result.update(run_seconds=time.perf_counter() - t0, env_step=info.env_step, gradient_step=info.gradient_step,
                      best_reward=info.best_reward, last_metrics=info.last_metrics,
                      params=_redq_state(main.train_state),
                      critics_a_rank=main.train_state.critic.weights[0].shape[0],
                      segment=type(main.compiled_superstep).__name__)
        torch.save(result, out)
    finally:
        dist.destroy_process_group()
    return 0


def phase_redq_ep_graph(mesh, gather) -> dict:
    """``redq_ep`` at ``dp 1 x ep 1`` on the NCCL group, compiled: the
    segment's graphs, one per pattern of the actor delay, against eager
    segments (:func:`phase_dist_graph`: the ensembles' gathers and their
    backward all-reduce among the collectives counted at each capture, on
    the capturing stream), then ``run()`` for ``REDQ_EP_GRAPH_SEGMENTS``
    segments, each a pattern's warm-up or a replay, at least one a
    replay."""
    from tianshou_tpu_torch.trainer.distributed import DistributedOffPolicyTrainer

    cfg = PATHS[REDQ_EP["base"]]
    _, algo, train, buffer, plain = build(REDQ_EP["base"])
    steps = cfg["num_envs"] * cfg["segment"]

    def trainer():
        return DistributedOffPolicyTrainer(
            algo, train, plain.test_collector, buffer, max_epoch=1, step_per_epoch=REDQ_EP_GRAPH_SEGMENTS * steps,
            step_per_collect=steps, update_per_step=plain.update_per_step, batch_size=cfg["batch"],
            episode_per_test=plain.episode_per_test, warmup_steps=plain.warmup_steps, mesh=mesh, device="cuda")

    t = trainer()
    ts, cstate, bstate, generators, _ = t.init_states()
    result = phase_dist_graph("redq_ep (dp 1 x ep 1)", t, [ts, cstate, bstate, generators], gather, 0)
    del ts, cstate, bstate, generators
    main = trainer()
    info = main.run()
    result["run_captures"] = _run_captures("redq_ep", main, REDQ_EP_GRAPH_SEGMENTS)
    warmup = cfg["warmup"] // cfg["num_envs"] * cfg["num_envs"]
    if (info.env_step != warmup + REDQ_EP_GRAPH_SEGMENTS * steps
            or info.gradient_step != REDQ_EP_GRAPH_SEGMENTS * cfg["updates"]):
        raise AssertionError(f"redq_ep (dp 1 x ep 1): counters env_step={info.env_step} "
                             f"gradient_step={info.gradient_step}")
    _check_metrics(REDQ_EP["base"], info.last_metrics)
    result["run"] = {"env_step": info.env_step, "gradient_step": info.gradient_step, "best_reward": info.best_reward,
                     "last_metrics": info.last_metrics}
    return result


def phase_redq_ep(gather) -> dict:
    """``redq_ep``: at world size 1 over NCCL (``dp 1 x ep 1``; the default
    group must be up) the sharded update equals the plain one bitwise, and
    the trainer's segment replays CUDA graphs (:func:`phase_redq_ep_graph`);
    then two gloo ranks share the card as ``dp 1 x ep 2`` (this script
    again, with ``--redq-ep-rank``, as two subprocesses), whose segment
    stays eager (gloo's collectives run on the host): the sharded update
    within the JAX test's limits, ms a segment in turns with the plain
    superstep, the segment's all-reduces and gathers with their bytes, its
    kernels, and after ``run()`` the two ranks' parameters (replicated and
    gathered) bitwise equal.  Every process is killed in a ``finally``."""
    import tempfile

    from tianshou_tpu_torch.parallel.mesh import make_mesh2

    mesh = make_mesh2(1, second_size=1, device="cuda")
    world1 = redq_ep_update_check(mesh, bitwise=True)
    log(f"redq_ep at world size 1 over NCCL (dp 1 x ep 1): the sharded update equals the plain one bitwise, "
        f"with an actor step too, metrics {world1['metrics']}")
    world1["graph"] = phase_redq_ep_graph(mesh, gather)
    root = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": root}
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(REDQ_EP["ranks"])]
        procs, logs = [], []
        try:
            for r in range(REDQ_EP["ranks"]):
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--redq-ep-rank", str(r), "--port", str(port),
                     "--out", outs[r]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=root, env=env))
            for p in procs:
                logs.append(p.communicate(timeout=GLOO_RANK_TIMEOUT)[0].decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        for r, (p, out) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"redq_ep rank {r} failed (rc {p.returncode}):\n{out[-4000:]}")
        a, b = [torch.load(o, weights_only=False) for o in outs]
    unequal = [k for k in a["params"] if not torch.equal(a["params"][k], b["params"][k])]
    if unequal or a["last_metrics"] != b["last_metrics"]:
        raise AssertionError(f"redq_ep: the two ranks differ after run(): {unequal}, {a['last_metrics']} vs "
                             f"{b['last_metrics']}")
    cfg = PATHS[REDQ_EP["base"]]
    warmup = cfg["warmup"] // cfg["num_envs"] * cfg["num_envs"]
    if (a["env_step"] != warmup + REDQ_EP["segments"] * cfg["num_envs"] * cfg["segment"]
            or a["gradient_step"] != REDQ_EP["segments"] * cfg["updates"] or a["critics_a_rank"] != 5):
        raise AssertionError(f"redq_ep: env_step {a['env_step']}, gradient_step {a['gradient_step']}, "
                             f"{a['critics_a_rank']} critics a rank")
    if "CapturedStep" in (a["segment"], b["segment"]):
        raise AssertionError("redq_ep: run() captured a segment over the gloo groups")
    _check_metrics(REDQ_EP["base"], a["last_metrics"])
    turns = {k: sum(v) / len(v) for k, v in a["turns_ms"].items()}
    result = {"world1_update_check": world1, "update_check": a["update_check"],
              "ms_per_segment_turns": a["turns_ms"], "ms_per_segment": turns["ep"], "plain_ms_per_superstep": turns["plain"],
              **{k: a[k] for k in ("metrics", "all_reduce_calls_per_segment", "all_reduce_bytes_per_segment",
                                   "gathers_per_segment", "gather_bytes_per_segment", "device_kernels_per_segment",
                                   "device_busy_ms_per_segment_profiled", "updates_per_segment", "run_seconds",
                                   "env_step", "gradient_step", "best_reward", "last_metrics", "backend",
                                   "segment")},
              "critics_a_rank": a["critics_a_rank"], "gather_rows_cast_launches": 0}
    log(f"redq_ep (dp 1 x ep 2, two gloo ranks on one card, {a['critics_a_rank']} critics a rank): one sharded "
        f"update vs one process: largest parameter difference {a['update_check']['max_abs_err']:.3e} (bitwise "
        f"{a['update_check']['bitwise_equal']}), metrics {a['update_check']['metrics']} vs "
        f"{a['update_check']['one_process_metrics']}; an update with an actor step, held alike: largest "
        f"difference {a['update_check']['actor_step_max_abs_err']:.3e} in {a['update_check']['actor_step_worst']}; "
        f"in turns: plain "
        f"{a['turns_ms']['plain']} ms, ep {a['turns_ms']['ep']} ms a segment of {cfg['num_envs']} envs x "
        f"{cfg['segment']} steps + {a['updates_per_segment']} updates; a segment: {a['gathers_per_segment']} gathers "
        f"({a['gather_bytes_per_segment']} bytes), {a['all_reduce_calls_per_segment']} all-reduces "
        f"({a['all_reduce_bytes_per_segment']} bytes, the gathers' included), rank 0's {a['device_kernels_per_segment']} "
        f"device kernels busy {a['device_busy_ms_per_segment_profiled']:.2f} ms; run(): env_step {a['env_step']}, "
        f"gradient_step {a['gradient_step']}, best {a['best_reward']:.2f}, {a['run_seconds']:.1f} s; the two ranks' "
        f"parameters bitwise equal; the segment eager ({a['segment']}): gloo runs its collectives on the host, which "
        f"a stream capture cannot record")
    return result


def phase_batch_cuda() -> dict:
    """``Batch`` on the card: ``cat`` (a key missing from one batch
    zero-filled), ``stack``, ``split`` (no shuffle, and a generator on the
    card), index reads and slice assignment on CUDA tensors equal the same
    calls on the CPU, bitwise."""
    from tianshou_tpu_torch.data.batch import Batch

    rng = np.random.default_rng(0)

    def make(n, extra):
        b = Batch(obs=torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32)),
                  info=Batch(p=torch.from_numpy(rng.integers(0, 9, n))))
        if extra:
            b.info.q = torch.from_numpy(rng.random((n, 2)).astype(np.float32))
        return b

    cpu = [make(5, True), make(3, False)]
    card = [b.to_torch("cuda") for b in cpu]
    idx = np.array([4, 0, 2])

    def ops(bs, dev):
        c = Batch.cat(bs)
        s = Batch.stack([bs[0], bs[0]])
        parts = c.split(3, shuffle=False, merge_last=True)
        w = Batch(c)
        w.obs, w.info = c.obs.clone(), Batch(p=c.info.p.clone(), q=c.info.q.clone())
        w[1:3] = c[5:7]
        g = torch.Generator(device=dev).manual_seed(0)
        shuffled = Batch.cat(c.split(3, generator=g))
        return {"cat": c, "stack": s, "split": Batch.cat(parts), "index": c[idx], "row": c[2], "assign": w,
                "shuffled_sorted": Batch(p=shuffled.info.p.sort().values)}

    got, ref = ops(card, "cuda"), ops(cpu, "cpu")
    for name in ref:
        for (k, a), (_, b) in zip(_flat_items(got[name]), _flat_items(ref[name])):
            if a.device.type != "cuda" or not torch.equal(a.cpu(), b):
                raise AssertionError(f"Batch on the card: {name}.{k} differs from the CPU's")
    log(f"Batch on the card: cat, stack, split, index, slice assignment and a shuffled split equal the CPU's "
        f"({len(ref)} operations)")
    return {"operations": sorted(ref)}


# slice 13: the example scripts (tianshou_tpu_torch/examples/) that the card's
# machine can run, each through its own main(): (module, flags, the cuts they
# make).  A run is its script's defaults but for the cuts, which shorten it
EXAMPLE_RUNS = (
    [("atari_dqn", ["--fake-ale", "--max-epoch", "1", "--step-per-epoch", "2000"],
      "max_epoch 100 -> 1, step_per_epoch 100,000 -> 2,000; the fake-ALE double for ALE"),
     ("dqn_cartpole", [], "none: to its own stop"),
     ("highlevel_dqn", [], "none: to its own stop")]
    + [("dqn_minatar", [*flags, "--max-epoch", "1", "--step-per-epoch", "1024"],
        "max_epoch 10 -> 1, step_per_epoch 100,000 -> 1,024")
       for flags in (["--algo", "qrdqn"], *(["--game", game] for game in (
           "breakout", "space_invaders", "freeway", "asterix", "seaquest")))]
    + [("sac_pendulum", ["--algo", algo, "--max-epoch", "1", "--step-per-epoch", "600"],
        "max_epoch 8 -> 1, step_per_epoch 6,000 -> 600") for algo in ("sac", "td3", "ddpg")]
    + [("ppo_classic", ["--algo", algo, "--max-epoch", "1", "--step-per-epoch", "4096"],
        "max_epoch 15 -> 1, step_per_epoch 30,000 -> 4,096") for algo in ("ppo", "a2c", "pg")]
    + [("cpp_pool_dqn", ["--max-epoch", "1", "--step-per-epoch", "2000"],
        "max_epoch 4 -> 1, step_per_epoch 10,000 -> 2,000"),
       ("offline_d4rl_cql", ["{dataset}", "--task", "Pendulum-v1", "--max-epoch", "1", "--update-per-epoch", "200"],
        "max_epoch 20 -> 1, update_per_epoch 1,000 -> 200; a 20,000-step random Pendulum dataset "
        "(make_d4rl_demo) for D4RL's")]
)
# the scripts that need gymnasium with MuJoCo or Box2D, which the card's
# machine lacks: they run in the CPU tests (tests/test_torch_examples_*.py)
EXAMPLES_OFF_CARD = ("mujoco_sac", "mujoco_td3", "mujoco_ppo", "mujoco_a2c", "mujoco_reinforce", "mujoco_trpo",
                     "box2d_dqn", "box2d_sac")
# the reference's CartPole threshold, which dqn_cartpole and highlevel_dqn
# must reach within their own 10 epochs
CARTPOLE_THRESHOLD = 195.0


def phase_examples(gather) -> tuple[dict, int]:
    """The ported example scripts on the card, each through its ``main`` with
    the in-memory logger: wall time, rate, best reward and the kernel's
    launches over the run (counted from 0 just before it).  ``atari_dqn``
    must run ``gather_rows_cast`` twice a training segment (its presample's
    two stacked keys; the profiler's device records, since its host step
    replays a graph: from the host only in the capture's warm-up), and a
    presample of its trained ring
    through the kernel must equal the plain version's bitwise;
    ``dqn_cartpole`` and ``highlevel_dqn`` must reach 195 within their 10
    epochs.  Returns the rows and the launches of the runs."""
    import importlib

    from tianshou_tpu_torch.examples import make_d4rl_demo
    from tianshou_tpu_torch.examples import run as run_example

    dataset = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "pendulum_demo_20k.npz")
    os.makedirs(os.path.dirname(dataset), exist_ok=True)
    make_d4rl_demo.main([dataset, "--steps", "20000"])
    log(f"examples the card's machine cannot run (no gymnasium, MuJoCo or Box2D there; the CPU tests run them): "
        f"{', '.join(EXAMPLES_OFF_CARD)}")
    rows, launches = [], 0
    for name, flags, cuts in EXAMPLE_RUNS:
        argv = [a.format(dataset=dataset) for a in flags]
        module = importlib.import_module(f"tianshou_tpu_torch.examples.{name}")
        gather.launches = 0
        t0 = time.perf_counter()
        if name == "atari_dqn":  # through build(), to keep the trainer and its ring
            trainer, venvs = module.build(module.parser().parse_args(argv), memory_logger())
            # the host step replays a graph: the kernel's launches are the
            # profiler's device records (the warm-up's from the host too)
            out = []
            records = _device_records(lambda: out.append(run_example(trainer, venvs)))
            info, host = out[0][0], gather.launches
            n = sum("gather_rows_cast" in e.name() for e in records)
        else:
            info = module.main(argv, logger=memory_logger())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if name != "atari_dqn":
            n = gather.launches
        launches += n
        offline = name == "offline_d4rl_cql"
        row = dict(script=name, argv=argv, wall_s=wall, best_reward=info.best_reward, epochs=info.epoch,
                   env_steps=info.env_step, gradient_steps=info.gradient_step,
                   rate=(info.gradient_step if offline else info.env_step) / wall,
                   rate_unit="gradient steps/s" if offline else "env steps/s", launches=n, cuts=cuts)
        if not math.isfinite(info.best_reward) or info.gradient_step <= 0:
            raise AssertionError(f"examples {name} {argv}: {info}")
        if name == "atari_dqn":
            segments = info.gradient_step // trainer.updates_per_segment
            captures = len(trainer.compiled_host_step.graphs)
            if segments <= captures or n != 2 * segments or host != 2 * captures:
                raise AssertionError(f"atari_dqn: gather_rows_cast ran {n} times on the card and {host} from the host "
                                     f"over {segments} segments ({captures} a capture's warm-up), not 2 a segment")
            row["segments"], row["presample_rows_bitwise"] = segments, _examples_atari_presample(trainer, gather)
        elif n:
            raise AssertionError(f"examples {name}: gather_rows_cast launched {n} times")
        if name in ("dqn_cartpole", "highlevel_dqn") and not (
                info.best_reward >= CARTPOLE_THRESHOLD and info.epoch <= 10):
            raise AssertionError(f"examples {name}: best reward {info.best_reward} in {info.epoch} epochs, "
                                 f"not {CARTPOLE_THRESHOLD} within 10")
        rows.append(row)
        log(f"examples {name} {' '.join(argv)}: wall {wall:.2f} s, {row['rate']:.1f} {row['rate_unit']}, "
            f"best reward {info.best_reward:.2f} in {info.epoch} epochs ({info.env_step} env steps, "
            f"{info.gradient_step} gradient steps), gather_rows_cast launches {n}; cuts: {cuts}")
    return {"runs": rows}, launches


def _examples_atari_presample(trainer, gather) -> int:
    """A presample of ``atari_dqn``'s trained ring (its ``updates x batch``
    frame stacks, ``obs`` and ``obs_next``) through the kernel, held bitwise
    against the plain version (the uint8 stacks cast to bf16) on the card;
    the rows gathered."""
    from tianshou_tpu_torch.utils.device import make_generator

    buffer, bstate = trainer.buffer, trainer.buffer_state
    env_idx, pos = buffer.sample_indices(bstate, make_generator(7, trainer.device),
                                         trainer.updates_per_segment * trainer.batch_size)
    keys = ("obs", "obs_next")
    before = gather.launches
    kernel = buffer.get(bstate, env_idx, pos, keys=keys, dtypes=dict.fromkeys(keys, torch.bfloat16))
    if gather.launches - before != 2:
        raise AssertionError(f"atari_dqn presample: {gather.launches - before} kernel launches for 2 keys")
    plain = buffer.get(bstate, env_idx, pos, keys=keys)
    for k in keys:
        if kernel[k].dtype != torch.bfloat16 or not torch.equal(
                kernel[k].view(torch.int16), plain[k].to(torch.bfloat16).view(torch.int16)):
            raise AssertionError(f"atari_dqn presample {k!r}: the kernel's bf16 stacks differ from the plain version's")
    rows = sum(kernel[k].shape[0] * kernel[k].shape[1] for k in keys)  # [batch, stack, 84, 84] a key
    log(f"atari_dqn presample of the trained ring: {tuple(kernel['obs'].shape)} bf16 stacks a key, "
        f"{rows} rows of {kernel['obs'].shape[-1] * kernel['obs'].shape[-2]} bytes, bitwise equal to the plain version")
    return rows


def _flat_items(b, prefix: str = ""):
    for k in sorted(b):
        v = b[k]
        yield from (_flat_items(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if "--gloo-rank" in sys.argv:  # one of phase_gloo_ranks' two subprocesses
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        return gloo_rank_main(int(args["--gloo-rank"]), int(args["--port"]), args["--out"])
    if "--redq-ep-rank" in sys.argv:  # one of phase_redq_ep's two subprocesses
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        return redq_ep_rank_main(int(args["--redq-ep-rank"]), int(args["--port"]), args["--out"])
    from tianshou_tpu_torch.ops.gather import gather_rows_cast

    t0 = time.perf_counter()
    phase_times: dict[str, float] = {}

    def timed_phase(name: str, fn, *args):
        """``fn(*args)``, its seconds kept and printed as ``phase_s``."""
        t = time.perf_counter()
        out = fn(*args)
        phase_times[name] = time.perf_counter() - t
        log(f"phase_s {name} {phase_times[name]:.1f} (script at {time.perf_counter() - t0:.1f} s)")
        return out

    smi = timed_phase("device", phase_device)
    timed_phase("build", phase_build)
    kernel = timed_phase("kernels", phase_kernels)
    segtree = timed_phase("segtree", phase_segtree)
    for path in ("atari", "atari_dedup"):
        timed_phase(f"reference {path}", phase_reference, path)
    for fn in (phase_reference_continuous, phase_reference_onpolicy, phase_reference_distributional,
               phase_reference_offpolicy_rest, phase_reference_offline):
        timed_phase(fn.__name__, fn)
    log(f"chip_smoke: checks and references passed at {time.perf_counter() - t0:.1f} s")
    results, launches = {}, 0
    for path in PATHS:
        t_path = time.perf_counter()
        phase = (phase_host if path in HOST_PATHS else phase_fused if path in FUSED_PATHS
                 else phase_offline if path in OFFLINE_PATHS else phase_superstep)
        results[path] = timed_phase(f"{path} eager", phase, path, gather_rows_cast)
        if path in GRAPH_PATHS:
            results[path]["graph"] = timed_phase(f"{path} graph", phase_graph, path, gather_rows_cast,
                                                 results[path]["profile"])
        if path in LEARN_GRAPH_PATHS:
            results[path]["graph"] = timed_phase(f"{path} graph", phase_learn_graph, path, gather_rows_cast,
                                                 results[path]["max_memory_allocated_gib"],
                                                 results[path]["memory_base_gib"])
        if path in HIGHLEVEL_PATHS:
            n, results[path]["main_run"] = timed_phase(f"{path} run", phase_main_highlevel, path, gather_rows_cast)
            launches += n
        else:
            launches += timed_phase(f"{path} run", phase_main_path, path, gather_rows_cast)
        results[path]["phase_s"] = time.perf_counter() - t_path
    # slice 16: the compiled collection against its eager form
    results["collect_graph"] = timed_phase("collect graph", phase_collect_graph)
    results["hl_atari"]["beside_atari"] = timed_phase("hl_atari beside atari", phase_builder_beside_atari)
    results["cpp_cartpole"]["raw_step_rate"] = timed_phase("cpp pool raw rate", phase_cpp_bench)
    results["sac_host"]["variants"] = timed_phase("host variants", phase_host_variants, HOST_VARIANT_TURN)
    # slice 11: the distributed trainers over NCCL at world size 1, then two
    # gloo ranks sharing the card
    start_nccl_world1()
    for path in DIST_PATHS:
        t_path = time.perf_counter()
        results[path] = timed_phase(path, phase_distributed, path, gather_rows_cast)
        launches += timed_phase(f"{path} run", phase_dist_main, path, results[path].pop("trainer"), gather_rows_cast)
        results[path]["phase_s"] = time.perf_counter() - t_path
    # slice 17: make_distributed_update compiled on the NCCL group
    results["dist_update"] = timed_phase("make_distributed_update", phase_dist_update_graph)
    # slice 12: the ensemble axis, at world size 1 on the NCCL group (compiled
    # since slice 17), then as two gloo ranks sharing the card
    t_path = time.perf_counter()
    gather_rows_cast.launches = 0
    results["redq_ep"] = timed_phase("redq_ep", phase_redq_ep, gather_rows_cast)
    if gather_rows_cast.launches:
        raise AssertionError(f"redq_ep: gather_rows_cast launched {gather_rows_cast.launches} times")
    results["redq_ep"]["phase_s"] = time.perf_counter() - t_path
    torch.distributed.destroy_process_group()
    results["gloo_two_ranks"] = timed_phase("gloo two ranks", phase_gloo_ranks)
    results["batch_cuda"] = timed_phase("batch on the card", phase_batch_cuda)
    # slice 13: the example scripts
    t_path = time.perf_counter()
    results["examples"], n = timed_phase("examples", phase_examples, gather_rows_cast)
    launches += n
    results["examples"]["phase_s"] = time.perf_counter() - t_path
    kernel["launches"] = launches
    if set(SEGTREE_RUNS) != {"rainbow_per", "dist_rainbow_per"}:
        raise AssertionError(f"the sum tree's launches were checked on {sorted(SEGTREE_RUNS)}")
    segtree["launches"] = SEGTREE_RUNS
    stored, dedup = results["atari"], results["atari_dedup"]
    log("atari memory regime: frames stored once (atari_dedup) beside stored stacks (atari): "
        + ", ".join(f"{k} {dedup[k]:.4f} vs {stored[k]:.4f}" for k in (
            "ring_gb", "max_memory_allocated_gib", "ms_per_superstep", "env_steps_per_s")))
    log(f"chip_smoke: all phases passed; {time.perf_counter() - t0:.1f} s of its own clock")
    print(json.dumps({"card": smi, "paths": results, "phase_s": phase_times}))
    print(json.dumps({"kernels": [kernel, segtree]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
