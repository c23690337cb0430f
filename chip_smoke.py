#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds every kernel in ``multimodalfilter_tpu_torch/csrc`` with nvcc (into
``build/``) and holds each against its plain PyTorch version at the main
paths' shapes. Then it drives the port's two paths through the user's entry
points, with seeded random weights at full width, checks that each went
through its kernels, and times them:

- eval: ``DoorCrossmodalParticleFilter.forward_loop`` at N=16, T=100, M=300
  through B1, against the same model run on the CPU through the plain tail;
- training: ``train_helpers.train_e2e`` (BPTT, B=32, L=16, M=30) through the
  B2 kernels, forward and backward, with one optimizer step held against the
  same step on the CPU through the plain tail;
- serving: the same model built through ``StatefulFilter`` with
  ``MMF_TPU_FUSED_STEP=1``, whose eval loop at N=16, T=100, M=300 is one
  launch of B3, against the per-step path of the same model, with
  filter-steps/s at N=16 and the latency of a step at N=1 for both;
- the per-step eval loop through B4 (soft resampling) and B5 (M=2048 and
  M=16384).

B3 is also held against its plain version step by step (T=100 launches of
one step, each from the plain run's belief), over a whole loop, and at other
shapes, the edges of its thread-block clusters among them (one block per
64-particle tile: M=64, 65, 300, 512; N=1 and 16; and an N whose clusters
do not all fit the card at once); B5 at twelve shapes up to M=60,000 (B5
splits each row over a cluster of up to 8 blocks; rows of more than
~52,000 particles take its strided kernel); B1 and B4 at the edges of their
one-block-a-row kernel (ragged and whole warps, one and 512 rows, D=8 at
M=1024, a row whose leading particle is 80 nats ahead); B2f and B2b at the
edges of their register slots and looped instance (M = 1 to 5,000), every
D <= 8, N = 1 and 512, a row 80 nats ahead, and with one output unused
(its gradient absent). The times report
each cluster kernel's cluster size, blocks and
cudaOccupancyMaxActiveClusters, as its C entry reports them; B1's and B4's
device and host-paced times beside the floor (one copy kernel over the same
particles) and the host cost of a call's parts; B2f's and B2b's the same at
B=32 and B=512, and their device times with 1, 2, 4 and 8 rows a block.

    python3 chip_smoke.py --yardstick DIR

also times B1, B4, B2f and B2b against the wrappers and kernels of another
checkout at DIR (an earlier commit unpacked with ``git archive``), in turns
on the same card: device and host-paced times, a call's parts, and the
per-step eval loop and train filter-steps/s with each wrapper.

TF32 is off for matmuls and cuDNN throughout, so fp32 means fp32.

Prints one JSON line per phase, the card's name and power limit as
nvidia-smi gives them, a ``kernels`` line, and as its last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before that line. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

# Main path (bench.py's shapes): N trajectories, T steps, M eval particles.
N, T, M = 16, 100, 300
SAT_N, SAT_M = 512, 100
TIE = 1e-6  # a uniform this close to a CDF entry may pick a neighbour
# The main path's random model (the eval loop, B3's step-by-step check and
# the serving route). Most seeded draws of flax's lecun_normal
# init give eval dynamics that diverge over T=100 steps at these inputs
# (states to 1e5-1e33 or non-finite, the card's run equal to the CPU's), and
# then the absolute per-step comparison below holds nothing; 3 is the first
# seed of 0-11 whose loop stays bounded (1, 3, 5 and 9 do).
MAIN_SEED = 3
EST_ATOL_KERNEL = 1e-5  # B1 estimate, fp32 sums in another order
LOOP_ATOL = 1e-4  # forward_loop estimates, GPU vs CPU fp32 nets
# B1 against its plain version at these (N, M, D, lead): the main paths'
# shapes, then the edges of the one-pass kernel (ragged and whole warps, 1,
# 2 and 4 slots a thread, one row, D = 8 at M = 1024) and a row whose
# particle M // 3 leads the rest by `lead` nats (its CDF flat past it).
B1_SHAPES = [(16, 300, 3, 0.0), (16, 100, 3, 0.0), (512, 100, 3, 0.0),
             (16, 1, 2, 0.0), (16, 1000, 2, 0.0), (16, 1024, 2, 0.0),
             (16, 31, 3, 0.0), (16, 32, 3, 0.0), (16, 33, 3, 0.0), (16, 1023, 3, 0.0),
             (1, 300, 3, 0.0), (16, 1024, 8, 0.0), (16, 300, 3, 80.0)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores

# The remaining eval kernels. B4 and B5 against their plain version at these
# (N, M, D, alpha, lead); B4 takes M <= 1024 with alpha < 1, B5 every M > 1024.
B45_SHAPES = [(16, 300, 3, 0.9, 0.0), (16, 1, 2, 0.9, 0.0), (16, 1025, 3, 1.0, 0.0),
              (16, 1025, 3, 0.5, 0.0), (16, 2048, 3, 1.0, 0.0), (16, 2048, 3, 0.5, 0.0),
              (4, 16384, 3, 1.0, 0.0), (4, 16384, 3, 0.5, 0.0), (2, 20000, 3, 1.0, 0.0),
              (2, 20000, 3, 0.5, 0.0),
              (2, 60000, 3, 1.0, 0.0), (2, 60000, 3, 0.5, 0.0),  # B5's strided kernel
              # B4's edges, as B1's above.
              (16, 31, 3, 0.9, 0.0), (16, 32, 3, 0.9, 0.0), (16, 33, 3, 0.9, 0.0),
              (16, 1023, 3, 0.5, 0.0), (1, 300, 3, 0.9, 0.0), (512, 100, 3, 0.9, 0.0),
              (16, 1024, 8, 0.5, 0.0), (16, 300, 3, 0.9, 80.0)]
SOFT_ALPHA = 0.9
ROW_TAIL_KERNEL = "pf_row_tail_kernel"  # B1's and B4's kernel, by its name in a trace
# Soft log-weights: values near -log M (to -9.9 at M = 20,000, where one fp32
# ulp is ~1e-6), normalised by sums of M exponentials in another order.
SOFT_LW_ATOL = 2e-5
# B3 against its plain version: resampled particles whose draw is off a tie
# come from the same source slot, so they differ only by the trunks' fp32
# rounding (the states are O(10) at random weights, ulp ~1e-6); two source
# slots differ by far more.
PARTICLE_ATOL = 1e-4
# B3's fused log-likelihoods against the plain trunks', relative to their
# scale where it exceeds 1: fp32 sums of 64 terms through 16 layers in two
# orders, with cancellation (about 100x one layer's rounding).
LL_RTOL = 1e-4
# A whole B3 loop against its plain run, over each trajectory's steps before
# its draws first diverge: rounding carried through up to T steps of the
# belief, relative to the estimates' scale where that exceeds 1.
B3_LOOP_ATOL = 1e-4
B3_OTHER = [("DoorParticleFilter", 2, 300, None),
            ("DoorCrossmodalParticleFilter", 2, 300, (True, False)),
            ("DoorCrossmodalParticleFilter", 2, 512, None),
            ("DoorCrossmodalParticleFilter", 4, 1, None),
            ("DoorCrossmodalParticleFilter", 1, 300, None),
            # The edges of B3's clusters (one block per 64 particles).
            ("DoorCrossmodalParticleFilter", 1, 64, None),
            ("DoorCrossmodalParticleFilter", 16, 64, None),
            ("DoorCrossmodalParticleFilter", 16, 65, None),
            ("DoorCrossmodalParticleFilter", 1, 65, None),
            ("DoorCrossmodalParticleFilter", 16, 300, None),
            ("DoorCrossmodalParticleFilter", 1, 512, None),
            ("DoorCrossmodalParticleFilter", 16, 512, None)]
B3_OTHER_T = 10
B3_WAVE_T = 3  # the launch whose clusters do not all fit at once
# The per-step eval loop through each tail: (kernel, M, T, alpha) at N=16.
TAIL_PATHS = [("b4", 300, T, SOFT_ALPHA), ("b5", 2048, T, 1.0), ("b5", 16384, 20, 1.0)]

# Training path (bench.py make_train_program's shapes): batch B of windows
# of L steps, M train particles; the data are TRAJ trajectories of TRAJ_T
# steps (32 x floor(100/16) = 192 windows: 6 optimizer steps at B=32).
TRAIN_B, TRAIN_L, TRAIN_M = 32, 16, 30
TRAIN_SAT_B = 512
TRAJ, TRAJ_T = 32, 100
# B2f and B2b against their plain versions at these (N, M, D, lead): the
# training paths' shapes, then the edges of the kernels' register slots (M
# up to 32, 64, 128 and 256, 1, 2, 4 and 8 slots a lane) and of their looped
# instance above, every D <= 8, one row, and rows whose slot M // 3 leads the
# rest by `lead` nats.
B2_SHAPES = [(32, 30, 3, 0.0), (512, 30, 3, 0.0), (16, 300, 3, 0.0), (3, 1, 2, 0.0),
             (4, 1000, 8, 0.0), (2, 5000, 3, 0.0),
             (16, 31, 3, 0.0), (16, 32, 3, 0.0), (16, 33, 3, 0.0), (16, 64, 3, 0.0),
             (16, 65, 3, 0.0), (16, 128, 3, 0.0), (16, 129, 3, 0.0), (16, 256, 3, 0.0),
             (16, 257, 3, 0.0), (16, 256, 8, 0.0), (16, 257, 8, 0.0),
             (8, 30, 1, 0.0), (8, 30, 2, 0.0), (8, 30, 4, 0.0), (8, 30, 5, 0.0),
             (8, 30, 6, 0.0), (8, 30, 7, 0.0), (8, 30, 8, 0.0), (8, 100, 5, 0.0),
             (1, 30, 3, 0.0), (1, 1, 1, 0.0), (512, 100, 3, 0.0),
             (32, 30, 3, 80.0), (4, 1000, 3, 80.0)]
B2_ROWS = (1, 2, 4, 8)  # batch rows a block that the sweep times
# B2 against its plain version: fp32 sums over M in a warp-shuffle tree
# against torch's reductions, expf/logf against torch's exp/log; values are
# O(1-10) and M reaches 5000.
B2_ATOL = 1e-5
# One optimizer step on the card against the CPU (B=32, L=16, TF32 off):
# cuDNN and CPU convolutions and GEMMs sum in other orders, carried through
# 15 filter steps and back. Loss relative; gradients per parameter relative
# to its largest entry. The loosest gradients are the gate's image convs:
# sums over 512 frames x 1024 pixels that cancel to a small fraction of
# their terms (up to 3.6e-3 of their scale apart on the H100), so 1e-2.
# Adam's first step is lr * g / (|g| + 1e-8): an entry whose gradient is
# below 1e-5 or within twice its own device difference of zero (many of the
# gate's, whose two-way softmax saturates at random weights) may step +lr on
# one device and -lr on the other. On every other entry the step moves by at
# most 1e-8 |dg| / |g|^2 <= 5e-4 lr, so the updates must agree within
# 1e-3 lr; and no update exceeds Adam's first-step bound lr. Both beyond the
# fp32 rounding of the parameter the update is read back from (2 ulp).
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_RTOL = 1e-2
STEP_UPDATE_ATOL_LR = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, repeats: int, warmup: int = 3) -> float:
    """Median of `repeats` CUDA-event timings of fn(), in ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def loop_ms(run, repeats: int) -> tuple:
    """(CUDA-event ms, host ms) medians of `repeats` timings of run()."""
    import torch

    ms = cuda_ms(run, repeats=repeats, warmup=1)
    host = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    return ms, statistics.median(host)


def device_kernels(prof):
    """The device-side events of a torch.profiler run: kernels and copies,
    not the annotations the profiler mirrors onto the device timeline."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def kernel_totals(kernels):
    """({kernel name: [launches, device µs]}, total device µs)."""
    import collections

    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    return by_name, sum(v[1] for v in by_name.values())


def b1_inputs(n, m, d, device, seed, lead=0.0):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    lw = torch.log_softmax(torch.randn(n, m, generator=g, device=device), dim=1)
    ll = torch.randn(n, m, generator=g, device=device)
    ll[0, m // 3] += lead
    particles = torch.randn(n, m, d, generator=g, device=device)
    uniforms = torch.rand(n, m, generator=g, device=device)
    return lw, ll, particles, uniforms


def phase_b1(pf_kernels, device) -> dict:
    """B1 against its plain version on the card at every listed shape."""
    import torch

    worst_est, results = 0.0, []
    for i, (n, m, d, lead) in enumerate(B1_SHAPES):
        args = b1_inputs(n, m, d, device, seed=i, lead=lead)
        kp, klw, kest = pf_kernels.pf_update_and_resample(*args)
        torch.cuda.synchronize()
        rp, rlw, rest = pf_kernels.pf_update_and_resample_reference(*args)
        _, cdf = pf_kernels.resample_cdf(args[0], args[1])
        tie = pf_kernels.tie_gaps(cdf, args[3]) <= TIE
        differs = (kp != rp).any(dim=-1)
        non_tie = int((differs & ~tie).sum())
        est_err = float((kest - rest).abs().max())
        lw_err = float((klw - rlw).abs().max())
        results.append({"shape": [n, m, d], "lead": lead, "index_mismatch_non_tie": non_tie,
                        "tie_slots": int(tie.sum()), "mismatch_at_ties": int((differs & tie).sum()),
                        "max_abs_err_est": est_err, "max_abs_err_lw": lw_err})
        check(non_tie == 0, f"B1 {n, m, d}: {non_tie} non-tie index mismatches")
        check(est_err <= EST_ATOL_KERNEL, f"B1 {n, m, d}: estimate error {est_err}")
        check(lw_err == 0.0, f"B1 {n, m, d}: log-weight error {lw_err}")
        worst_est = max(worst_est, est_err)
    emit({"phase": "b1_vs_plain", "tie": TIE, "est_atol": EST_ATOL_KERNEL,
          "results": results})
    return {"max_abs_err_est": worst_est, "index_mismatch_non_tie": 0}


def b1_along_path(pf_kernels, calls) -> dict:
    """B1 against its plain version on the inputs that a loop on the card
    gave it, one (log_weights, log_liks, uniforms, particles, kwargs,
    outputs) per call: no resampled particle off a tie from another source
    slot, the estimate within EST_ATOL_KERNEL of its scale where that
    exceeds 1, the log-weights equal. Each step is held on its own inputs,
    so a wrong draw at one step cannot hide behind the divergence it causes
    in the next."""
    import torch

    worst = {"calls": len(calls), "index_mismatch_non_tie": 0, "tie_slots": 0,
             "mismatch_at_ties": 0, "max_abs_err_est": 0.0, "max_rel_err_est": 0.0,
             "max_abs_err_lw": 0.0}
    with torch.no_grad():
        for lw, ll, u, particles, kwargs, (kp, klw, kest) in calls:
            rp, rlw, rest = pf_kernels.pf_update_and_resample_reference(
                lw, ll, particles, u, **kwargs)
            tie = pf_kernels.draw_gaps(lw, ll, u) <= TIE
            differs = (kp != rp).any(dim=-1)
            err = float((kest - rest).abs().max())
            worst["index_mismatch_non_tie"] += int((differs & ~tie).sum())
            worst["tie_slots"] += int(tie.sum())
            worst["mismatch_at_ties"] += int((differs & tie).sum())
            worst["max_abs_err_est"] = max(worst["max_abs_err_est"], err)
            worst["max_rel_err_est"] = max(worst["max_rel_err_est"],
                                           err / max(1.0, float(rest.abs().max())))
            worst["max_abs_err_lw"] = max(worst["max_abs_err_lw"],
                                          float((klw - rlw).abs().max()))
    check(worst["calls"] > 0, "B1 along the path: no calls recorded")
    check(worst["index_mismatch_non_tie"] == 0, f"B1 along the path: {worst}")
    check(worst["max_rel_err_est"] <= EST_ATOL_KERNEL, f"B1 along the path: {worst}")
    check(worst["max_abs_err_lw"] == 0.0, f"B1 along the path: {worst}")
    return worst


def sequences(t, n, seed):
    import numpy as np

    r = np.random.default_rng(seed)
    obs = {
        "image": r.normal(size=(t, n, 32, 32)).astype(np.float32),
        "gripper_pos": r.normal(size=(t, n, 3)).astype(np.float32),
        "gripper_sensors": r.normal(size=(t, n, 7)).astype(np.float32),
    }
    return obs, r.normal(size=(t, n, 7)).astype(np.float32)


def initial_state(n):
    import numpy as np

    mean = np.zeros((n, 3), np.float32)
    cov = np.tile(np.diag([0.1, 0.05, 0.05]).astype(np.float32), (n, 1, 1))
    return mean, cov


def phase_main_path(door_models, pf_kernels, pf_module, device) -> dict:
    """The port's main path through the facade, on the card."""
    import dataclasses

    import torch

    from multimodalfilter_tpu_torch.types import ParticleBelief

    b1 = pf_kernels.launch_b1
    model = door_models.DoorCrossmodalParticleFilter(device=device, seed=MAIN_SEED)
    model.eval()
    model.definition = dataclasses.replace(model.definition, num_particles_eval=M)
    obs, controls = sequences(T, N, seed=1)
    mean, cov = initial_state(N)
    model.initialize_beliefs(mean=mean, covariance=cov)
    belief0 = ParticleBelief(*(x.clone() for x in model.belief))
    g = torch.Generator(device=device).manual_seed(2)
    eps_seq = torch.randn((T, N * M, 3), generator=g, device=device)
    uni_seq = torch.rand((T, N, M), generator=g, device=device)

    b1.launches = 0
    est = model.forward_loop(observations=obs, controls=controls,
                             eps_seq=eps_seq, uniforms_seq=uni_seq)
    torch.cuda.synchronize()
    launches = b1.launches
    check(launches == T, f"B1 launched {launches} times in a {T}-step loop")
    check(tuple(est.shape) == (T, N, 3), f"estimates shape {tuple(est.shape)}")
    check(bool(torch.isfinite(est).all()), "non-finite estimates")

    # The same model on the CPU, through the plain tail, from the same
    # weights, inputs, initial belief, noise and uniforms.
    cpu_model = door_models.DoorCrossmodalParticleFilter(device="cpu", seed=MAIN_SEED)
    cpu_model.params.load_state_dict(model.params.state_dict())
    cpu = torch.device("cpu")
    obs_cpu = {k: torch.from_numpy(v) for k, v in obs.items()}
    ctrl_cpu = torch.from_numpy(controls)
    gaps = []  # per step: each uniform's distance to the CPU run's CDF
    real_tail = pf_module.pf_update_and_resample

    def recording_tail(log_weights, log_liks, particles, uniforms, **kwargs):
        if not particles.is_cuda:
            _, cdf = pf_kernels.resample_cdf(log_weights, log_liks)
            gaps.append(pf_kernels.tie_gaps(cdf, uniforms))
        return real_tail(log_weights, log_liks, particles, uniforms, **kwargs)

    pf_module.pf_update_and_resample = recording_tail
    try:
        # (a) Free run over all T steps.
        _, est_cpu = cpu_model.definition.forward_loop(
            ParticleBelief(*(x.to(cpu) for x in belief0)), obs_cpu, ctrl_cpu,
            train=False, eps_seq=eps_seq.cpu(), uniforms_seq=uni_seq.cpu(),
        )
        free_gaps, gaps[:] = list(gaps), []
        free_err = float((est.cpu() - est_cpu).abs().max())
        free_ties = int(sum(int((x <= TIE).sum()) for x in free_gaps))
        if free_ties == 0:
            check(free_err <= LOOP_ATOL, f"free-run estimate error {free_err}")

        # (b) Step by step from the GPU run's beliefs, so that a draw on a
        # tie at one step cannot carry into the next: estimates (taken
        # before resampling) must agree at every step, and resampled
        # particles at every slot whose uniform is not on a tie.
        gdefn = model.definition
        belief = belief0
        step_est_err = step_part_err = 0.0
        step_ties = 0
        with torch.no_grad():
            for i in range(T):
                sl = slice(i, i + 1)
                obs_i = {k: v[sl] for k, v in obs.items()}
                nb_gpu, e_gpu = gdefn.forward_loop(
                    belief, {k: torch.from_numpy(v).to(device) for k, v in obs_i.items()},
                    torch.from_numpy(controls[sl]).to(device), train=False,
                    eps_seq=eps_seq[sl], uniforms_seq=uni_seq[sl],
                )
                nb_cpu, e_cpu = cpu_model.definition.forward_loop(
                    ParticleBelief(*(x.to(cpu) for x in belief)),
                    {k: v[sl] for k, v in obs_cpu.items()}, ctrl_cpu[sl],
                    train=False, eps_seq=eps_seq[sl].cpu(),
                    uniforms_seq=uni_seq[sl].cpu(),
                )
                ok = gaps.pop() > TIE
                step_ties += int((~ok).sum())
                step_est_err = max(step_est_err, float((e_gpu.cpu() - e_cpu).abs().max()))
                diff = (nb_gpu.particles.cpu() - nb_cpu.particles).abs().amax(-1)
                if ok.any():
                    step_part_err = max(step_part_err, float(diff[ok].max()))
                belief = nb_gpu
    finally:
        pf_module.pf_update_and_resample = real_tail
    check(step_est_err <= LOOP_ATOL, f"per-step estimate error {step_est_err}")
    check(step_part_err <= LOOP_ATOL, f"per-step particle error {step_part_err}")

    # A second run at the saturated batch.
    model.definition = dataclasses.replace(model.definition, num_particles_eval=SAT_M)
    obs_s, controls_s = sequences(T, SAT_N, seed=3)
    mean_s, cov_s = initial_state(SAT_N)
    model.initialize_beliefs(mean=mean_s, covariance=cov_s)
    b1.launches = 0
    est_s = model.forward_loop(observations=obs_s, controls=controls_s)
    torch.cuda.synchronize()
    sat_launches = b1.launches
    check(sat_launches == T, f"B1 launched {sat_launches} times at N={SAT_N}")
    check(bool(torch.isfinite(est_s).all()), f"non-finite estimates at N={SAT_N}")
    model.definition = dataclasses.replace(model.definition, num_particles_eval=M)

    emit({"phase": "main_path", "model": "DoorCrossmodalParticleFilter",
          "units": 64, "N": N, "T": T, "M": M, "b1_launches": launches,
          "estimates_finite": True, "loop_atol": LOOP_ATOL, "tie": TIE,
          "free_run_max_abs_err": free_err, "free_run_tie_draws": free_ties,
          "free_run_checked": free_ties == 0,
          "per_step_max_abs_err_est": step_est_err,
          "per_step_max_abs_err_particles_non_tie": step_part_err,
          "per_step_tie_draws": step_ties,
          "saturated": {"N": SAT_N, "M": SAT_M, "b1_launches": sat_launches,
                        "estimates_finite": True}})
    return {"model": model, "launches": launches}


def phase_times(model, pf_kernels, device) -> dict:
    import dataclasses

    import torch

    loops = []
    for n, m in ((N, 100), (N, M), (SAT_N, SAT_M)):
        model.definition = dataclasses.replace(model.definition, num_particles_eval=m)
        obs, controls = sequences(T, n, seed=4)
        obs = {k: torch.from_numpy(v).to(device) for k, v in obs.items()}
        controls = torch.from_numpy(controls).to(device)
        mean, cov = initial_state(n)

        def run():
            model.initialize_beliefs(mean=mean, covariance=cov)
            model.forward_loop(observations=obs, controls=controls)

        ms, host_ms = loop_ms(run, repeats=3 if n == SAT_N else 5)
        loops.append({"N": n, "M": m, "T": T, "ms_per_loop": ms,
                      "host_ms_per_loop": host_ms,
                      "filter_steps_per_s": T * n / (ms / 1e3)})
    model.definition = dataclasses.replace(model.definition, num_particles_eval=M)

    kernel = {}
    for name, n, m, d, alpha in (("b1", N, M, 3, 1.0), ("b1", N, 100, 3, 1.0),
                                 ("b1", SAT_N, SAT_M, 3, 1.0), ("b1", N, 1024, 8, 1.0),
                                 ("b4", N, M, 3, SOFT_ALPHA)):
        args = b1_inputs(n, m, d, device, seed=9)
        reps = 200

        def many(fn):
            return lambda: [fn(*args, alpha=alpha) for _ in range(reps)]

        k_ms = cuda_ms(many(pf_kernels.pf_update_and_resample), repeats=5) / reps
        p_ms = cuda_ms(many(pf_kernels.pf_update_and_resample_reference), repeats=5) / reps
        bound, bound_by = tail_bound_ms(n, m, d, soft=alpha < 1.0)
        kernel[f"{name}_{n}x{m}x{d}"] = {
            "alpha": alpha, "ms": k_ms, "plain_ms": p_ms,
            "device_us": device_us(lambda: pf_kernels.pf_update_and_resample(*args, alpha=alpha),
                                   ROW_TAIL_KERNEL),
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
    particles = b1_inputs(N, M, 3, device, seed=9)[2]
    floor = {"shape": [N, M, 3], "what": "particles.clone()",
             "ms": cuda_ms(lambda: [particles.clone() for _ in range(200)], repeats=5) / 200,
             "device_us": device_us(particles.clone, "")}
    emit({"phase": "times", "forward_loop": loops, "tails": kernel, "floor": floor,
          "launch_path_us": launch_parts(pf_kernels, b1_inputs(N, M, 3, device, seed=9)),
          "b1_library_ms": None, "tf32": False})
    return {"b1": kernel[f"b1_{N}x{M}x3"], "b4": {**kernel[f"b4_{N}x{M}x3"], "shape": [N, M, 3]}}


def device_us(fn, name: str, reps: int = 50):
    """Median device time (torch.profiler) of the kernels whose name holds
    `name` over `reps` calls of fn(), in µs; None where two profiled runs
    both saw none (a trace can come back without device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in device_kernels(prof) if name in e.name]
        if us:
            return statistics.median(us)
    return None


def launch_parts(pf_kernels, args, calls: int = 10000) -> dict:
    """Host µs of one B1 call through `pf_kernels` (the port's module, or a
    copy of an earlier one) and of its parts, each the mean of `calls`
    back-to-back repeats on the host clock (perf_counter_ns), the device
    drained before and after: the whole wrapper, its input checks, the three
    output allocations, finding the stream, and the bare C call with its
    pointers (one launch)."""
    import torch

    lw, ll, particles, uniforms = args
    n, m, d = particles.shape
    outs = (torch.empty_like(particles), torch.empty_like(lw), particles.new_empty((n, d)))
    ptrs = [t.data_ptr() for t in (lw, ll, uniforms, particles, *outs)]
    index = particles.get_device()
    if hasattr(pf_kernels, "_Entries"):  # this PR's wrapper
        entry = pf_kernels._Entries.b1 or pf_kernels._Entries.bind().b1

        def stream():
            return torch.cuda.current_device() == index and pf_kernels._Entries.stream(index)
    else:  # the wrapper before it
        entry = pf_kernels._kernels()["b1"]

        def stream():
            with torch.cuda.device(particles.device):
                return torch.cuda.current_stream().cuda_stream
    raw = stream()
    parts = {
        "call": lambda: pf_kernels.pf_update_and_resample(*args),
        "checks": lambda: pf_kernels._check_cuda_inputs(*args),
        "outputs": lambda: (torch.empty_like(particles), torch.empty_like(lw),
                            torch.empty((n, d), dtype=particles.dtype, device=particles.device)),
        "stream": stream,
        "pointers": lambda: [t.data_ptr() for t in (lw, ll, uniforms, particles, *outs)],
        "c_call": lambda: entry(*ptrs, n, m, d, raw),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter_ns()
        torch.cuda.synchronize()
        out[name] = (t1 - t0) / calls / 1e3
    return out


def phase_profile(model, pf_kernels, device) -> None:
    """Where the time goes: one warm forward_loop at N=16, M=300 under
    torch.profiler — device busy share, kernels per step, the largest
    kernels — and B1's and B4's device time per launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    obs, controls = sequences(T, N, seed=5)
    mean, cov = initial_state(N)

    def run():
        model.initialize_beliefs(mean=mean, covariance=cov)
        model.forward_loop(observations=obs, controls=controls)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(prof)
    if not kernels:
        emit({"phase": "profile", "device_time": "not measured"})
        return
    by_name, busy_us = kernel_totals(kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]

    args = b1_inputs(N, M, 3, device, seed=6)
    emit({"phase": "profile", "N": N, "M": M, "T": T, "wall_ms": wall_us / 1e3,
          "device_busy_ms": busy_us / 1e3, "device_busy_share": busy_us / wall_us,
          "device_kernels_per_step": len(kernels) / T,
          "top_kernels": [{"name": k[:80], "count": c, "ms": us / 1e3}
                          for k, (c, us) in top],
          "b1_device_us_per_launch": device_us(
              lambda: pf_kernels.pf_update_and_resample(*args), ROW_TAIL_KERNEL),
          "b4_device_us_per_launch": device_us(
              lambda: pf_kernels.pf_update_and_resample(*args, alpha=SOFT_ALPHA),
              ROW_TAIL_KERNEL)})


# ---------------------------------------------------------------------------
# Training path: B2 and train_e2e
# ---------------------------------------------------------------------------


def b2_bound_ms(n: int, m: int, d: int, backward: bool) -> tuple:
    """Least time for B2f or B2b: each input read once and each output
    written once, against the arithmetic (one operation per add, multiply,
    max, exp, log or divide).

    B2f reads lw, ll, particles and writes lw', est: 4 (N M (3 + D) + N D)
    bytes; per particle s, max, exp, sum, the shift, lw', p and D
    multiply-adds: 8 + 2D operations.
    B2b reads lw', particles, est, g_lw', g_est and writes g_s, g_x:
    4 (N M (3 + 2D) + 2 N D) bytes; per particle exp, the sum of g_lw',
    x . g_est, g_s, g_x: 6 + 3D operations."""
    if backward:
        nbytes = 4 * (n * m * (3 + 2 * d) + 2 * n * d)
        ops = n * m * (6 + 3 * d)
    else:
        nbytes = 4 * (n * m * (3 + d) + n * d)
        ops = n * m * (8 + 2 * d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def b2_inputs(n, m, d, device, seed, lead=0.0):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    lw = torch.log_softmax(torch.randn(n, m, generator=g, device=device), dim=1)
    ll = torch.randn(n, m, generator=g, device=device)
    ll[0, m // 3] += lead
    particles = torch.randn(n, m, d, generator=g, device=device)
    g_lw = torch.randn(n, m, generator=g, device=device)
    g_est = torch.randn(n, d, generator=g, device=device)
    return lw, ll, particles, g_lw, g_est


def phase_b2(pf_estimate, device) -> dict:
    """B2f and B2b against their plain versions at every listed shape;
    torch.autograd.grad through the Function against the plain forward; and
    the Function's gradients when one output is unused (its gradient absent:
    a null g_lw' to B2b, or zeros for g_est) against the plain backward
    with that gradient zero, each launching B2b once."""
    import torch

    def err(a, b):
        return float((a - b).abs().max())

    fwd, bwd = pf_estimate.pf_update_estimate_fwd, pf_estimate.pf_update_estimate_bwd
    worst = {"fwd": 0.0, "bwd": 0.0, "autograd": 0.0, "absent": 0.0}
    results = []
    for i, (n, m, d, lead) in enumerate(B2_SHAPES):
        lw, ll, particles, g_lw, g_est = b2_inputs(n, m, d, device, seed=20 + i, lead=lead)
        klw, kest = fwd(lw, ll, particles)
        torch.cuda.synchronize()
        rlw, rest = pf_estimate.pf_update_estimate_reference(lw, ll, particles)
        kgs, kgx = bwd(rlw, particles, rest, g_lw, g_est)
        torch.cuda.synchronize()
        rgs, rgx = pf_estimate.pf_update_estimate_backward_reference(
            rlw, particles, rest, g_lw, g_est)
        grads = []
        for fn in (pf_estimate.pf_update_estimate,
                   pf_estimate.pf_update_estimate_reference):
            args = [x.clone().requires_grad_() for x in (lw, ll, particles)]
            with torch.enable_grad():
                out_lw, est = fn(*args)
                grads.append(torch.autograd.grad(
                    (out_lw * g_lw).sum() + (est * g_est).sum(), args))
        absent = 0.0
        for used in ("est", "lw"):
            args = [x.clone().requires_grad_() for x in (lw, ll, particles)]
            launched = bwd.launches
            with torch.enable_grad():
                out_lw, est = pf_estimate.pf_update_estimate(*args)
                loss = (est * g_est).sum() if used == "est" else (out_lw * g_lw).sum()
                got = torch.autograd.grad(loss, args)
            torch.cuda.synchronize()
            check(bwd.launches == launched + 1, f"B2b with an absent gradient {n, m, d}")
            zs, zx = pf_estimate.pf_update_estimate_backward_reference(
                out_lw.detach(), particles, est.detach(),
                g_lw if used == "lw" else torch.zeros_like(g_lw),
                g_est if used == "est" else torch.zeros_like(g_est))
            absent = max(absent, *(err(a, b) for a, b in zip(got, (zs, zs, zx))))
        row = {"shape": [n, m, d], "lead": lead,
               "fwd": max(err(klw, rlw), err(kest, rest)),
               "bwd": max(err(kgs, rgs), err(kgx, rgx)),
               "autograd": max(err(a, b) for a, b in zip(*grads)),
               "absent": absent}
        for key in worst:
            check(row[key] <= B2_ATOL, f"B2 {key} {n, m, d}: error {row[key]}")
            worst[key] = max(worst[key], row[key])
        results.append(row)
    emit({"phase": "b2_vs_plain", "atol": B2_ATOL, "results": results})
    return worst


def trajectories(count, t, seed):
    """Seeded synthetic door trajectories (states, 32x32 images, gripper
    pos and sensors, controls)."""
    import numpy as np

    from multimodalfilter_tpu_torch.types import Trajectory

    r = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        obs = {"image": r.normal(size=(t, 32, 32)).astype(np.float32),
               "gripper_pos": r.normal(size=(t, 3)).astype(np.float32),
               "gripper_sensors": r.normal(size=(t, 7)).astype(np.float32)}
        states = np.cumsum(0.1 * r.normal(size=(t, 3)), axis=0).astype(np.float32)
        out.append(Trajectory(states, obs, r.normal(size=(t, 7)).astype(np.float32)))
    return out


def one_step_dataset(trajs):
    """The first trajectories' windows, enough for one batch of TRAIN_B
    (36 windows at the script's sizes: one optimizer step)."""
    from multimodalfilter_tpu_torch.data import SubsequenceDataset

    per_traj = TRAJ_T // TRAIN_L
    return SubsequenceDataset(trajs[: -(-TRAIN_B // per_traj)], TRAIN_L)


def snapshot(model):
    return {k: v.detach().clone() for k, v in model.params.state_dict().items()}


def one_step(model, batch, noise, loops, optim):
    """The e2e loss, its gradients and one fresh Adam step on `model`, from
    a fixed batch and fixed noise. Returns (loss, grads, params after)."""
    import torch

    device = model.device
    real = loops.draw_noise
    loops.draw_noise = lambda generator, shapes, dev: tuple(x.to(dev) for x in noise)
    try:
        optimizer = optim.make_optimizer(model.params.parameters())
        with torch.enable_grad():
            loss = loops.e2e_loss(model.definition, loops._to_device(batch, device),
                                  enabled=model._enabled_tuple, initial_cov_scale=0.1,
                                  generator=None)
            loss.backward()
        grads = {k: p.grad.detach().cpu().clone() for k, p in model.params.named_parameters()}
        optim.apply_gradients(optimizer, model.params, frozenset())
    finally:
        loops.draw_noise = real
    return float(loss.detach()), grads, {k: v.cpu() for k, v in snapshot(model).items()}


def phase_train_path(door_models, kernels, device) -> dict:
    """The training path through train_helpers on the card: B2f and B2b
    launch once per filter step, B1 never; the loss is finite and every
    parameter moves. Then one optimizer step on the card against the CPU,
    and a step with the gate frozen."""
    import math

    import torch

    from multimodalfilter_tpu_torch.crossmodal import train_helpers
    from multimodalfilter_tpu_torch.data import SubsequenceDataset
    from multimodalfilter_tpu_torch.experiments import Buddy
    from multimodalfilter_tpu_torch.filtering.wrappers import freeze_module
    from multimodalfilter_tpu_torch.train import loops, optim

    b1, b2f, b2b = kernels
    trajs = trajectories(TRAJ, TRAJ_T, seed=10)
    model = door_models.DoorCrossmodalParticleFilter(device=device, seed=0)
    check(model.definition.num_particles_train == TRAIN_M, "train particle count")
    before = snapshot(model)
    with tempfile.TemporaryDirectory() as log_dir:
        buddy = Buddy("chip_smoke", model, log_dir=log_dir)
        train_helpers.configure(buddy=buddy, trajectories=trajs)
        b1.launches = b2f.launches = b2b.launches = 0
        loss = train_helpers.train_e2e(subsequence_length=TRAIN_L, epochs=1,
                                       batch_size=TRAIN_B)
        torch.cuda.synchronize()
        launches = {"b1": b1.launches, "b2f": b2f.launches, "b2b": b2b.launches}
    steps = buddy.optimizer_steps
    windows = TRAJ * (TRAJ_T // TRAIN_L)
    check(steps == windows // TRAIN_B, f"{steps} optimizer steps")
    per = steps * (TRAIN_L - 1)
    check(launches == {"b1": 0, "b2f": per, "b2b": per}, f"launches {launches}")
    check(math.isfinite(loss), f"loss {loss}")
    after = snapshot(model)
    unmoved = [k for k in after if torch.equal(after[k], before[k])]
    check(not unmoved, f"parameters that did not move: {unmoved}")

    # One step on the card against the same step on the CPU (plain tail).
    gpu_model = door_models.DoorCrossmodalParticleFilter(device=device, seed=1)
    cpu_model = door_models.DoorCrossmodalParticleFilter(device="cpu", seed=1)
    ds = SubsequenceDataset(trajs, TRAIN_L)
    batch = {"states": ds.states[:TRAIN_B], "controls": ds.controls[:TRAIN_B],
             "obs": {k: v[:TRAIN_B] for k, v in ds.observations.items()}}
    g = torch.Generator().manual_seed(11)
    noise = (torch.randn((TRAIN_B, TRAIN_M, 3), generator=g),
             torch.randn((TRAIN_L - 1, TRAIN_B * TRAIN_M, 3), generator=g))
    start = {k: v.cpu() for k, v in snapshot(gpu_model).items()}
    f0 = b2f.launches
    g_loss, g_grads, g_params = one_step(gpu_model, batch, noise, loops, optim)
    check(b2f.launches - f0 == TRAIN_L - 1, "the card's step did not run B2f")
    c_loss, c_grads, c_params = one_step(cpu_model, batch, noise, loops, optim)
    loss_err = abs(g_loss - c_loss) / abs(c_loss)
    check(loss_err <= STEP_LOSS_RTOL, f"step loss {g_loss} vs {c_loss}")
    lr = optim.DEFAULT_LEARNING_RATE
    grad_errs, update_errs = {}, {}
    resolved = entries = 0
    largest_step = 0.0
    for k in c_grads:
        gg, gc = g_grads[k], c_grads[k]
        grad_errs[k] = float((gg - gc).abs().max()) / float(gc.abs().max())
        dg, dc = g_params[k] - start[k], c_params[k] - start[k]
        ulp = 2 * torch.finfo(torch.float32).eps * start[k].abs()
        ok = (gc.abs() >= 1e-5) & (gc.abs() >= 2 * (gg - gc).abs())
        excess = ((dg - dc).abs() - ulp)[ok]
        update_errs[k] = max(0.0, float(excess.max()) / lr) if ok.any() else 0.0
        resolved, entries = resolved + int(ok.sum()), entries + ok.numel()
        largest_step = max(largest_step, float((dg.abs() - ulp).max()) / lr,
                           float((dc.abs() - ulp).max()) / lr)
    worst_grads = sorted(grad_errs.items(), key=lambda kv: -kv[1])[:3]
    worst_updates = sorted(update_errs.items(), key=lambda kv: -kv[1])[:3]
    emit({"phase": "train_step_card_vs_cpu", "worst_grad_err_of_scale": worst_grads,
          "worst_update_err_lr": worst_updates, "resolved_entries": resolved,
          "entries": entries, "largest_step_lr": largest_step})
    grad_err, update_err = worst_grads[0][1], worst_updates[0][1]
    check(grad_err <= STEP_GRAD_RTOL, f"gradient {worst_grads[0]} of its scale")
    check(update_err <= STEP_UPDATE_ATOL_LR, f"Adam update {worst_updates[0]} lr")
    check(largest_step <= 1 + 1e-6, f"an Adam first step of {largest_step} lr")

    # A step with the gate frozen, from a fresh optimizer: the gate stays.
    freeze_module(gpu_model.measurement_model.crossmodal_weight_model)
    held = snapshot(gpu_model)
    with tempfile.TemporaryDirectory() as log_dir:
        buddy2 = Buddy("chip_smoke_frozen", gpu_model, log_dir=log_dir)
        one = one_step_dataset(trajs)
        loops.train_e2e(buddy2, gpu_model, one, epochs=1, batch_size=TRAIN_B,
                        optimizer_name="frozen_gate")
    check(buddy2.optimizer_steps == len(one) // TRAIN_B, "frozen step count")
    now = snapshot(gpu_model)
    gate = "measurement_model.crossmodal_weight_model."
    for k in now:
        check(torch.equal(now[k], held[k]) == k.startswith(gate), f"frozen step: {k}")

    emit({"phase": "train_path", "model": "DoorCrossmodalParticleFilter", "units": 64,
          "B": TRAIN_B, "L": TRAIN_L, "M": TRAIN_M, "windows": windows,
          "optimizer_steps": steps, "launches": launches, "epoch_loss": loss,
          "every_parameter_moved": True,
          "card_vs_cpu_step": {"loss_gpu": g_loss, "loss_cpu": c_loss,
                               "loss_rel_err": loss_err,
                               "max_grad_err_of_scale": grad_err,
                               "max_update_err_lr": update_err,
                               "resolved_share": resolved / entries,
                               "tolerances": [STEP_LOSS_RTOL, STEP_GRAD_RTOL,
                                              STEP_UPDATE_ATOL_LR]},
          "frozen_gate_unchanged": True, "tf32": False})
    return {"model": model, "trajectories": trajs, "launches": launches}


def train_datasets(trajs):
    """The training paths' datasets: (B, windows) at B=32 (`trajs`) and
    B=512 (enough seeded trajectories for two optimizer steps)."""
    from multimodalfilter_tpu_torch.data import SubsequenceDataset

    sat = trajectories(2 * TRAIN_SAT_B // (TRAJ_T // TRAIN_L) + 1, TRAJ_T, seed=12)
    return [(TRAIN_B, SubsequenceDataset(trajs, TRAIN_L)),
            (TRAIN_SAT_B, SubsequenceDataset(sat, TRAIN_L))]


def train_rates(model, datasets, label: str) -> list:
    """Train filter-steps/s = steps * B * (L-1) / epoch time (bench.py:707)
    for each (B, dataset), a median of CUDA-event timings of a whole
    ``train_e2e`` epoch (the dataset's push to the card included)."""
    from multimodalfilter_tpu_torch.experiments import Buddy
    from multimodalfilter_tpu_torch.train import loops

    rates = []
    with tempfile.TemporaryDirectory() as log_dir:
        buddy = Buddy(f"chip_smoke_{label}", model, log_dir=log_dir)
        for b, ds in datasets:
            steps = len(ds) // b

            def epoch():
                loops.train_e2e(buddy, model, ds, epochs=1, batch_size=b,
                                optimizer_name=f"{label}_{b}")

            ms = cuda_ms(epoch, repeats=3, warmup=1)
            rates.append({"B": b, "L": TRAIN_L, "M": TRAIN_M, "optimizer_steps": steps,
                          "ms_per_epoch": ms, "ms_per_step": ms / steps,
                          "train_filter_steps_per_s": steps * b * (TRAIN_L - 1) / (ms / 1e3)})
    return rates


def b2_calls(pf_estimate, args):
    """(B2f call, B2b call) through `pf_estimate` (the port's module or an
    earlier copy) on the inputs of ``b2_inputs``."""
    lw, ll, particles, g_lw, g_est = args
    lwn, est = pf_estimate.pf_update_estimate_reference(lw, ll, particles)
    return (lambda: pf_estimate.pf_update_estimate_fwd(lw, ll, particles),
            lambda: pf_estimate.pf_update_estimate_bwd(lwn, particles, est, g_lw, g_est))


def b2_launch_parts(pf_estimate, args, calls: int = 10000) -> dict:
    """Host µs of B2 calls through `pf_estimate` (the port's module, or a
    copy of an earlier one) and of B2f's parts, each the mean of `calls`
    back-to-back repeats on the host clock (perf_counter_ns), the device
    drained before and after: a B2f call, a B2b call, one forward and
    backward through ``pf_update_estimate`` with the estimate alone used
    (lw' unused, as at a window's last step; `calls` / 5 repeats), and
    B2f's input checks, two output allocations, finding the stream, and
    the bare C call with its pointers (one launch)."""
    import torch

    lw, ll, particles, g_lw, g_est = args
    n, m, d = particles.shape
    outs = (torch.empty_like(lw), particles.new_empty((n, d)))
    ptrs = [t.data_ptr() for t in (lw, ll, particles, *outs)]
    index = particles.get_device()
    if hasattr(pf_estimate, "_Entries"):  # a wrapper that binds its entries once
        entry = pf_estimate._Entries.fwd or pf_estimate._Entries.bind().fwd
        extra = (pf_estimate.ROWS_PER_BLOCK,)

        def stream():
            return torch.cuda.current_device() == index and pf_estimate._Entries.stream(index)
    else:  # an earlier wrapper (``_kernels()``)
        entry, extra = pf_estimate._kernels()[0], ()

        def stream():
            with torch.cuda.device(particles.device):
                return torch.cuda.current_stream().cuda_stream
    raw = stream()
    fwd_call, bwd_call = b2_calls(pf_estimate, args)
    leaves = [x.clone().requires_grad_() for x in (lw, ll, particles)]

    def function_round_trip():
        with torch.enable_grad():
            _, est = pf_estimate.pf_update_estimate(*leaves)
            torch.autograd.grad(est, leaves, grad_outputs=g_est)

    parts = {
        "fwd_call": (fwd_call, calls),
        "bwd_call": (bwd_call, calls),
        "function_fwd_bwd": (function_round_trip, calls // 5),
        "checks": (lambda: pf_estimate._check_cuda_inputs((lw, ll), particles, ()), calls),
        "outputs": (lambda: (torch.empty_like(lw), particles.new_empty((n, d))), calls),
        "stream": (stream, calls),
        "pointers": (lambda: [t.data_ptr() for t in (lw, ll, particles, *outs)], calls),
        "c_call": (lambda: entry(*ptrs, n, m, d, *extra, raw), calls),
    }
    out = {}
    for name, (fn, count) in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(count):
            fn()
        t1 = time.perf_counter_ns()
        torch.cuda.synchronize()
        out[name] = (t1 - t0) / count / 1e3
    return out


def b2_rows_sweep(pf_estimate, device) -> dict:
    """B2f's and B2b's device µs per launch (torch.profiler) with 1, 2, 4
    and 8 batch rows a block, through the C entries, at B=32 and B=512."""
    import torch

    entries = pf_estimate._Entries if pf_estimate._Entries.fwd else pf_estimate._Entries.bind()
    out = {}
    for n in (TRAIN_B, TRAIN_SAT_B):
        lw, ll, particles, g_lw, g_est = b2_inputs(n, TRAIN_M, 3, device, seed=32)
        lwn, est = pf_estimate.pf_update_estimate_reference(lw, ll, particles)
        o_lw, o_est = torch.empty_like(lw), particles.new_empty((n, 3))
        g_s, g_x = torch.empty_like(lw), torch.empty_like(particles)
        stream = torch.cuda.current_stream().cuda_stream
        for rows in B2_ROWS:
            fwd_ptrs = [t.data_ptr() for t in (lw, ll, particles, o_lw, o_est)]
            bwd_ptrs = [t.data_ptr() for t in (lwn, particles, est, g_lw, g_est, g_s, g_x)]
            for key, entry, ptrs, name in (("b2f", entries.fwd, fwd_ptrs, "pf_estimate_fwd"),
                                           ("b2b", entries.bwd, bwd_ptrs, "pf_estimate_bwd")):
                def call():
                    check(entry(*ptrs, n, TRAIN_M, 3, rows, stream) == 0, f"{key} rows {rows}")

                out[f"{key}_{n}x{TRAIN_M}x3_rows{rows}"] = device_us(call, name)
    return out


def phase_train_times(model, trajs, pf_estimate, device) -> dict:
    """Train filter-steps/s at B=32 and B=512 (``train_rates``); B2f, B2b
    and their plain versions per launch at both B: host-paced (CUDA events
    around 200 back-to-back calls) and device time (torch.profiler); the
    floor (one copy kernel over the particles at B=32); the rows-a-block
    sweep; and the host cost of B2's calls and of their parts."""
    import torch

    rates = train_rates(model, train_datasets(trajs), "times")
    kernel = {}
    for n in (TRAIN_B, TRAIN_SAT_B):
        lw, ll, particles, g_lw, g_est = b2_inputs(n, TRAIN_M, 3, device, seed=30)
        lwn, est = pf_estimate.pf_update_estimate_reference(lw, ll, particles)
        reps = 200

        def many(fn, *args):
            return lambda: [fn(*args) for _ in range(reps)]

        fwd_args, bwd_args = (lw, ll, particles), (lwn, particles, est, g_lw, g_est)
        for name, k_fn, p_fn, args, backward in (
            ("b2f", pf_estimate.pf_update_estimate_fwd,
             pf_estimate.pf_update_estimate_reference, fwd_args, False),
            ("b2b", pf_estimate.pf_update_estimate_bwd,
             pf_estimate.pf_update_estimate_backward_reference, bwd_args, True),
        ):
            bound, bound_by = b2_bound_ms(n, TRAIN_M, 3, backward)
            kernel[f"{name}_{n}x{TRAIN_M}x3"] = {
                "ms": cuda_ms(many(k_fn, *args), repeats=5) / reps,
                "plain_ms": cuda_ms(many(p_fn, *args), repeats=5) / reps,
                "device_us": device_us(lambda: k_fn(*args),
                                       "pf_estimate_bwd" if backward else "pf_estimate_fwd"),
                "bound_ms": bound, "bound_by": bound_by}
    particles = b2_inputs(TRAIN_B, TRAIN_M, 3, device, seed=30)[2]
    floor = {"shape": [TRAIN_B, TRAIN_M, 3], "what": "particles.clone()",
             "ms": cuda_ms(lambda: [particles.clone() for _ in range(200)], repeats=5) / 200,
             "device_us": device_us(particles.clone, "")}
    emit({"phase": "train_times", "train": rates, "b2": kernel, "b2_floor": floor,
          "b2_rows_per_block": pf_estimate.ROWS_PER_BLOCK,
          "b2_rows_sweep_device_us": b2_rows_sweep(pf_estimate, device),
          "b2_launch_path_us": b2_launch_parts(
              pf_estimate, b2_inputs(TRAIN_B, TRAIN_M, 3, device, seed=33)),
          "b2_library_ms": None, "tf32": False})
    return kernel, rates


def host_breakdown_ms(model, trajs, loops, optim) -> dict:
    """Host time of one optimizer step's parts at B=32 (the loss forward,
    its backward, Adam), each ended by a synchronize: median of 3."""
    import torch

    ds = one_step_dataset(trajs)
    batch = loops._to_device({"states": ds.states[:TRAIN_B], "controls": ds.controls[:TRAIN_B],
                              "obs": {k: v[:TRAIN_B] for k, v in ds.observations.items()}},
                             model.device)
    optimizer = optim.make_optimizer(model.params.parameters())
    parts = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(4):
        optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.enable_grad():
            loss = loops.e2e_loss(model.definition, batch, enabled=model._enabled_tuple,
                                  initial_cov_scale=0.1, generator=model.generator)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        optim.apply_gradients(optimizer, model.params, frozenset())
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for name, dt in (("forward", t1 - t0), ("backward", t2 - t1), ("optimizer", t3 - t2)):
            parts[name].append(dt * 1e3)
    return {k: statistics.median(v[1:]) for k, v in parts.items()}


def phase_train_profile(model, trajs, pf_estimate, device, step_ms) -> None:
    """Where a training step's time goes: one warm optimizer step at B=32
    under torch.profiler, tracing the device only (device busy time, its
    share of the profiled wall time and of the unprofiled `step_ms`, kernels
    per optimizer step, the largest kernels); the host time of the step's
    parts; and B2f's and B2b's device time per launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multimodalfilter_tpu_torch.experiments import Buddy
    from multimodalfilter_tpu_torch.train import loops, optim

    one = one_step_dataset(trajs)
    with tempfile.TemporaryDirectory() as log_dir:
        buddy = Buddy("chip_smoke_profile", model, log_dir=log_dir)

        def step():
            loops.train_e2e(buddy, model, one, epochs=1, batch_size=TRAIN_B,
                            optimizer_name="profile")

        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(prof)
    if not kernels:
        emit({"phase": "train_profile", "device_time": "not measured"})
        return
    by_name, busy_us = kernel_totals(kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]

    lw, ll, particles, g_lw, g_est = b2_inputs(TRAIN_B, TRAIN_M, 3, device, seed=31)
    lwn, est = pf_estimate.pf_update_estimate_reference(lw, ll, particles)
    with profile(activities=[ProfilerActivity.CUDA]) as prof_b2:
        for _ in range(50):
            pf_estimate.pf_update_estimate_fwd(lw, ll, particles)
            pf_estimate.pf_update_estimate_bwd(lwn, particles, est, g_lw, g_est)
        torch.cuda.synchronize()
    per = {"b2f": [], "b2b": []}
    for e in device_kernels(prof_b2):
        if "pf_estimate_fwd" in e.name:
            per["b2f"].append(e.time_range.elapsed_us())
        elif "pf_estimate_bwd" in e.name:
            per["b2b"].append(e.time_range.elapsed_us())
    b2_names = sum(c for k, (c, _) in by_name.items() if "pf_estimate" in k)
    emit({"phase": "train_profile", "B": TRAIN_B, "L": TRAIN_L, "M": TRAIN_M,
          "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
          "device_busy_share": busy_us / wall_us, "unprofiled_step_ms": step_ms,
          "device_busy_share_of_unprofiled_step": busy_us / 1e3 / step_ms,
          "device_kernels_per_optimizer_step": len(kernels),
          "host_ms": host_breakdown_ms(model, trajs, loops, optim),
          "b2_kernels_in_step": b2_names,
          "top_kernels": [{"name": k[:80], "count": c, "ms": us / 1e3}
                          for k, (c, us) in top],
          "b2f_device_us_per_launch": statistics.median(per["b2f"]) if per["b2f"] else None,
          "b2b_device_us_per_launch": statistics.median(per["b2b"]) if per["b2b"] else None})


# ---------------------------------------------------------------------------
# The remaining eval kernels: B4 (soft), B5 (large M), B3 (whole loop)
# ---------------------------------------------------------------------------


def tail_bound_ms(n: int, m: int, d: int, soft: bool) -> tuple:
    """Least time for B1, B4 or B5: the bytes of B1 (each input read once,
    each output written once), against the arithmetic; soft resampling adds
    the mixture, its log and the reweight (about 8 operations a slot)."""
    nbytes = 4 * (n * m * (3 + 2 * d + 1) + n * d)
    ops = n * m * (7 + 2 * d + max(1, m.bit_length()) + (8 if soft else 0))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def b3_bound_ms(t: int, n: int, m: int, d: int, k: int) -> tuple:
    """Least time for B3's work. Operations: 2 per multiply-add of the
    trunks' real (unpadded) layers: per particle-step 9 full 64x64 dynamics
    layers, its D-wide input and D+1-wide output, and per modality 7 full
    layers, its D-wide input and 1-wide output; plus ~20 per slot for the
    fusion and the tail. Bytes: noise, uniforms, hoisted rows and gate,
    weights and biases, the belief in and out, the estimates."""
    per = (2 * 64 * 64 * 9 + 2 * 64 * (d + d + 1)
           + k * (2 * 64 * 64 * 7 + 2 * 64 * (d + 1)) + 20 + 4 * k)
    ops = per * t * n * m
    weights = 11 * 64 * 65 + k * 9 * 64 * 65
    nbytes = 4 * (t * n * m * (d + 1) + t * n * ((1 + k) * 64 + k) + weights
                  + 2 * n * m * (d + 1) + t * n * d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), ops


def phase_b45(pf_kernels, device) -> dict:
    """B4 and B5 against their plain version at every listed shape: the
    estimate within 1e-5 and the drawn indices equal off ties. The log-
    weights: -log M exactly (multinomial); for soft resampling the weights
    that the kernel's own draws must carry (a draw that flips on a tie
    changes its row's normaliser, so the plain version's are not the
    yardstick), within 2e-5."""
    import torch

    worst = {"b4": 0.0, "b5": 0.0}
    results = []
    for i, (n, m, d, alpha, lead) in enumerate(B45_SHAPES):
        args = b1_inputs(n, m, d, device, seed=40 + i, lead=lead)
        name = "b5" if m > pf_kernels.SMALL_M_MAX else "b4"
        counter = getattr(pf_kernels, f"launch_{name}")
        before = counter.launches
        kp, klw, kest = pf_kernels.pf_update_and_resample(*args, alpha=alpha)
        torch.cuda.synchronize()
        check(counter.launches == before + 1, f"{name} did not launch at {(n, m, d)}")
        rp, rlw, rest = pf_kernels.pf_update_and_resample_reference(*args, alpha=alpha)
        tie = pf_kernels.draw_gaps(args[0], args[1], args[3], alpha) <= TIE
        kidx, drawn = pf_kernels.source_slots(args[2], kp)
        check(drawn, f"{name} {n, m, d, alpha}: an output is not a draw of the input particles")
        differs = kidx != pf_kernels.source_slots(args[2], rp)[0]
        non_tie = int((differs & ~tie).sum())
        est_err = float((kest - rest).abs().max())
        if alpha >= 1.0:
            lw_err = float((klw - rlw).abs().max())
        else:
            lw_err = float((klw - pf_kernels.importance_weights(args[0], args[1], kidx, alpha))
                           .abs().max())
        results.append({"kernel": name, "shape": [n, m, d], "alpha": alpha, "lead": lead,
                        "index_mismatch_non_tie": non_tie, "tie_slots": int(tie.sum()),
                        "mismatch_at_ties": int((differs & tie).sum()),
                        "max_abs_err_est": est_err, "max_abs_err_lw": lw_err})
        check(non_tie == 0, f"{name} {n, m, d, alpha}: {non_tie} non-tie index mismatches")
        check(est_err <= EST_ATOL_KERNEL, f"{name} {n, m, d, alpha}: estimate error {est_err}")
        check(lw_err <= (0.0 if alpha >= 1 else SOFT_LW_ATOL),
              f"{name} {n, m, d, alpha}: log-weight error {lw_err}")
        worst[name] = max(worst[name], est_err)
    emit({"phase": "b4_b5_vs_plain", "tie": TIE, "est_atol": EST_ATOL_KERNEL,
          "soft_lw_atol": SOFT_LW_ATOL, "results": results})
    return worst


def door_sequences(defn, t, n, m, device, seed, enabled=None):
    """Seeded inputs of an eval loop on the card, and B3's operands: (obs,
    controls, belief, eps, uniforms, ops)."""
    import torch

    from multimodalfilter_tpu_torch.ops import fused_step
    from multimodalfilter_tpu_torch.types import ParticleBelief

    obs, controls = sequences(t, n, seed)
    obs = {k: torch.from_numpy(v).to(device) for k, v in obs.items()}
    controls = torch.from_numpy(controls).to(device)
    g = torch.Generator(device=device).manual_seed(seed)
    belief = ParticleBelief(0.3 * torch.randn((n, m, 3), generator=g, device=device),
                            torch.full((n, m), -math.log(m), device=device))
    eps = torch.randn((t, n * m, 3), generator=g, device=device)
    uniforms = torch.rand((t, n, m), generator=g, device=device)
    with torch.no_grad():
        features, ctrl = defn.encode_sequences(obs, controls, enabled)
        ops = fused_step.pack_operands(defn, features, ctrl, eps, enabled, m)
    return obs, controls, belief, eps, uniforms, ops


def first_divergence(record, log_liks, pf_kernels):
    """Per trajectory (N,), the first step whose draws from the other run's
    log-likelihoods `log_liks` (T, N, M) differ from the plain run's, or
    hold a tie (T if none). `record` holds the plain run's tail inputs, one
    (log_weights, log_liks, uniforms, ...) per step. Up to that step both
    runs resample the same particles, so their beliefs differ by rounding
    only."""
    import torch

    t_total = len(record)
    first = torch.full((record[0][1].shape[0],), t_total, dtype=torch.long,
                       device=log_liks.device)
    for t, (lw, ll, u) in enumerate(r[:3] for r in record):
        _, cdf_a = pf_kernels.resample_cdf(lw, ll)
        _, cdf_b = pf_kernels.resample_cdf(lw, log_liks[t])
        a = torch.searchsorted(cdf_a, u.contiguous())
        b = torch.searchsorted(cdf_b, u.contiguous())
        bad = (a != b).any(dim=1) | (pf_kernels.draw_gaps(lw, log_liks[t], u) <= TIE).any(dim=1)
        first = torch.where(bad & (first == t_total), t, first)
    return first


def compare_through(est_a, est_b, first):
    """(max |est_a - est_b|, max |est_b|, steps compared) over each
    trajectory's steps before `first`."""
    import torch

    mask = torch.arange(est_a.shape[0], device=est_a.device)[:, None] < first[None, :]
    if not bool(mask.any()):
        return 0.0, 0.0, 0
    return (float((est_a - est_b).abs().amax(-1)[mask].max()),
            float(est_b.abs().amax(-1)[mask].max()), int(mask.sum()))


def b3_whole_loop(fused_step, pf_kernels, ops, belief, uniforms) -> dict:
    """One launch over all T steps against the plain run: the kernel's
    log-likelihoods within LL_RTOL of the plain run's and its estimates
    within B3_LOOP_ATOL, both relative to their scale where it exceeds 1,
    over each trajectory's steps before its draws first diverge."""
    import torch

    with torch.no_grad():
        record = []
        rb, rest = fused_step.fused_forward_reference(ops, belief, uniforms, record=record)
        lls = torch.empty(uniforms.shape, device=uniforms.device)
        kb, kest = fused_step.fused_forward_kernel(ops, belief, uniforms, log_liks_out=lls)
        torch.cuda.synchronize()
    check(bool(torch.isfinite(kest).all()), "B3: non-finite estimates")
    first = first_divergence(record, lls, pf_kernels)
    err, scale, steps = compare_through(kest, rest, first)
    ll_ref = torch.stack([r[1] for r in record])
    mask = torch.arange(len(record), device=lls.device)[:, None] < first[None, :]
    ll_rel = 0.0
    if bool(mask.any()):
        ll_rel = float((lls - ll_ref).abs().amax(-1)[mask].max()) / max(
            1.0, float(ll_ref.abs().amax(-1)[mask].max()))
    out = {"T": uniforms.shape[0], "trajectory_steps_compared": steps,
           "trajectories_never_diverged": int((first == len(record)).sum()),
           "max_abs_err_est": err, "est_scale": scale, "max_rel_err_log_liks": ll_rel}
    check(steps > 0, f"B3 whole loop: the draws diverged at the first step: {out}")
    check(err <= B3_LOOP_ATOL * max(1.0, scale), f"B3 whole loop: {out}")
    check(ll_rel <= LL_RTOL, f"B3 whole loop log-likelihoods: {out}")
    return out


def b3_per_step(fused_step, pf_kernels, ops, belief, uniforms) -> dict:
    """B3 step by step against fused_forward_reference: every step one
    launch with T=1 from the plain run's belief. The kernel's
    log-likelihoods must agree with the plain trunks' (LL_RTOL of their
    scale); then, given the kernel's own log-likelihoods, its estimate must
    agree with the plain tail's within EST_ATOL_KERNEL and its resampled
    particles with the plain tail's draws off ties (PARTICLE_ATOL), both
    relative to their scale where it exceeds 1."""
    import torch

    t_total, n, m = uniforms.shape
    worst = {"ll_rel": 0.0, "est": 0.0, "est_rel": 0.0, "particles_rel": 0.0,
             "plain_est": 0.0}
    ties = plain_flips = 0
    with torch.no_grad():
        b = belief
        for i in range(t_total):
            record = []
            rb, rest = fused_step.fused_forward_reference(ops.step(i), b, uniforms[i:i + 1],
                                                          record=record)
            lls = torch.empty((1, n, m), device=uniforms.device)
            kb, kest = fused_step.fused_forward_kernel(ops.step(i), b, uniforms[i:i + 1],
                                                       log_liks_out=lls)
            torch.cuda.synchronize()
            lw, ll, u, new = record[0]
            ll_k = lls[0]
            worst["ll_rel"] = max(worst["ll_rel"], float((ll_k - ll).abs().max())
                                  / max(1.0, float(ll.abs().max())))
            ep, _, eest = pf_kernels.pf_update_and_resample_reference(lw, ll_k, new, u)
            err = float((kest[0] - eest).abs().max())
            worst["est"] = max(worst["est"], err)
            worst["est_rel"] = max(worst["est_rel"], err / max(1.0, float(eest.abs().max())))
            worst["plain_est"] = max(worst["plain_est"], float((kest - rest).abs().max()))
            ok = pf_kernels.draw_gaps(lw, ll_k, u) > TIE
            ties += int((~ok).sum())
            # Draws that the two trunks' rounding alone moved.
            _, cdf_r = pf_kernels.resample_cdf(lw, ll)
            _, cdf_k = pf_kernels.resample_cdf(lw, ll_k)
            plain_flips += int((torch.searchsorted(cdf_r, u.contiguous())
                                != torch.searchsorted(cdf_k, u.contiguous())).sum())
            if bool(ok.any()):
                diff = (kb.particles - ep).abs().amax(-1)[ok].max()
                worst["particles_rel"] = max(worst["particles_rel"], float(diff) / max(
                    1.0, float(new.abs().max())))
            b = rb
    check(worst["ll_rel"] <= LL_RTOL, f"B3 per-step log-likelihoods: {worst}")
    check(worst["est_rel"] <= EST_ATOL_KERNEL, f"B3 per-step estimates: {worst}")
    check(worst["particles_rel"] <= PARTICLE_ATOL, f"B3 per-step particles: {worst}")
    return {"steps": t_total, "worst": worst, "tie_draws": ties,
            "draws_moved_by_trunk_rounding": plain_flips}


def phase_b3(door_models, fused_step, pf_kernels, device) -> dict:
    """B3 against fused_forward_reference on the card. Step by step at the
    main path's shapes (N=16, T=100, M=300, K=2; b3_per_step). (At random
    weights the log-likelihoods reach magnitudes where the two trunks'
    rounding moves the CDF by more than TIE, so the plain run's own draws
    are not the yardstick; they are reported.) Then one whole-loop launch,
    and other shapes."""
    import dataclasses

    model = door_models.DoorCrossmodalParticleFilter(device=device, seed=MAIN_SEED)
    defn = dataclasses.replace(model.definition, num_particles_eval=M)
    _, _, belief, _, uniforms, ops = door_sequences(defn, T, N, M, device, seed=50)
    per_step = b3_per_step(fused_step, pf_kernels, ops, belief, uniforms)
    worst = per_step["worst"]
    whole = b3_whole_loop(fused_step, pf_kernels, ops, belief, uniforms)

    # The cluster edges, and one launch of more trajectories than the card
    # holds clusters at once (the rest run in a second wave).
    wave_n = fused_step.launch_plan(1, M).max_active_clusters + 4
    others = []
    for name, n, m, enabled, t in [(*o, B3_OTHER_T) for o in B3_OTHER] + [
            ("DoorCrossmodalParticleFilter", wave_n, M, None, B3_WAVE_T)]:
        other = getattr(door_models, name)(device=device, seed=0)
        odefn = dataclasses.replace(other.definition, num_particles_eval=m)
        _, _, ob, _, ou, oops = door_sequences(odefn, t, n, m, device, seed=51,
                                               enabled=enabled)
        plan = fused_step.launch_plan(n, m)
        others.append({"model": name, "N": n, "M": m, "enabled": enabled,
                       "cluster": plan.cluster, "blocks": plan.blocks,
                       **b3_whole_loop(fused_step, pf_kernels, oops, ob, ou)})
    emit({"phase": "b3_vs_plain", "N": N, "T": T, "M": M, "K": 2, "tie": TIE,
          "est_atol": EST_ATOL_KERNEL, "particle_atol": PARTICLE_ATOL, "ll_rtol": LL_RTOL,
          "loop_atol": B3_LOOP_ATOL, "per_step": worst,
          "per_step_tie_draws": per_step["tie_draws"],
          "per_step_draws_moved_by_trunk_rounding": per_step["draws_moved_by_trunk_rounding"],
          "whole_loop": whole, "other_shapes": others})
    return {"max_abs_err_est": worst["est"], "defn": defn}


def phase_serving(door_models, fused_step, pf_kernels, pf_module, device) -> dict:
    """The serving route: DoorCrossmodalParticleFilter built through
    StatefulFilter with MMF_TPU_FUSED_STEP=1 in its environment,
    forward_loop at N=16, T=100, M=300: B3 once per loop, B1 never; its
    estimates against the per-step path of the same model (same weights,
    noise and uniforms) through the steps before the per-step run's first
    tie; then filter-steps/s of both at N=16 and per-step latency at N=1."""
    import dataclasses
    import os

    import torch

    os.environ["MMF_TPU_FUSED_STEP"] = "1"
    try:
        model = door_models.DoorCrossmodalParticleFilter(device=device, seed=MAIN_SEED)
    finally:
        del os.environ["MMF_TPU_FUSED_STEP"]
    check(model.definition.fused_step, "MMF_TPU_FUSED_STEP=1 did not set fused_step")
    model.eval()
    fused_defn = dataclasses.replace(model.definition, num_particles_eval=M)
    step_defn = dataclasses.replace(fused_defn, fused_step=False)
    obs, controls = sequences(T, N, seed=60)
    mean, cov = initial_state(N)
    g = torch.Generator(device=device).manual_seed(61)
    eps_seq = torch.randn((T, N * M, 3), generator=g, device=device)
    uni_seq = torch.rand((T, N, M), generator=g, device=device)

    model.definition = fused_defn
    model.initialize_beliefs(mean=mean, covariance=cov)
    belief0 = type(model.belief)(*(x.clone() for x in model.belief))
    b3, b1 = fused_step.fused_forward_kernel, pf_kernels.launch_b1
    b3.launches = b1.launches = 0
    est_fused = model.forward_loop(observations=obs, controls=controls,
                                   eps_seq=eps_seq, uniforms_seq=uni_seq)
    torch.cuda.synchronize()
    launches = {"b3": b3.launches, "b1": b1.launches}
    check(fused_step.packing_report() is None, f"fused route fell back: {fused_step.packing_report()}")
    check(launches == {"b3": 1, "b1": 0}, f"serving launches {launches}")
    check(tuple(est_fused.shape) == (T, N, 3) and bool(torch.isfinite(est_fused).all()),
          "serving estimates")

    # The same operands through B3 directly: the route must give the same
    # estimates, and its log-likelihoods let the per-step path's draws be
    # compared step by step.
    with torch.no_grad():
        obs_d = {k: torch.from_numpy(v).to(device) for k, v in obs.items()}
        features, ctrl = fused_defn.encode_sequences(obs_d, torch.from_numpy(controls).to(device))
        ops = fused_step.pack_operands(fused_defn, features, ctrl, eps_seq, None, M)
        lls = torch.empty((T, N, M), device=device)
        _, est_direct = fused_step.fused_forward_kernel(ops, belief0, uni_seq, log_liks_out=lls)
        torch.cuda.synchronize()
    route_err = float((est_direct - est_fused).abs().max())
    check(route_err <= 1e-6 * max(1.0, float(est_fused.abs().max())),
          f"the route and a direct B3 launch differ by {route_err}")

    # The per-step path of the same model, recording its tail inputs.
    record = []
    real_tail = pf_module.pf_update_and_resample

    def recording_tail(log_weights, log_liks, particles, uniforms, **kwargs):
        record.append((log_weights, log_liks, uniforms))
        return real_tail(log_weights, log_liks, particles, uniforms, **kwargs)

    pf_module.pf_update_and_resample = recording_tail
    try:
        model.definition = step_defn
        model._belief = belief0
        est_step = model.forward_loop(observations=obs, controls=controls,
                                      eps_seq=eps_seq, uniforms_seq=uni_seq)
        torch.cuda.synchronize()
    finally:
        pf_module.pf_update_and_resample = real_tail
    check(b1.launches == T, f"per-step path launched B1 {b1.launches} times")
    first = first_divergence(record, lls, pf_kernels)
    err, scale, steps = compare_through(est_fused, est_step, first)
    check(steps > 0, "the per-step path's draws diverged from B3's at the first step")
    check(err <= LOOP_ATOL * max(1.0, scale), f"fused vs per-step estimates {err}")

    rates = {}
    for n in (N, 1):
        o, c = sequences(T, n, seed=62)
        o = {k: torch.from_numpy(v).to(device) for k, v in o.items()}
        c = torch.from_numpy(c).to(device)
        mn, cv = initial_state(n)
        for route, defn in (("per_step", step_defn), ("fused", fused_defn),
                            ("fused_2", fused_defn), ("per_step_2", step_defn)):
            model.definition = defn

            def run():
                model.initialize_beliefs(mean=mn, covariance=cv)
                model.forward_loop(observations=o, controls=c)

            ms, host_ms = loop_ms(run, repeats=5)
            rates[f"N{n}_{route}"] = {"ms_per_loop": ms, "host_ms_per_loop": host_ms,
                                      "filter_steps_per_s": T * n / (ms / 1e3),
                                      "ms_per_step": ms / T}
    model.definition = fused_defn
    profile = serving_profile(model, device)
    emit({"phase": "serving_path", "model": "DoorCrossmodalParticleFilter",
          "knob": "MMF_TPU_FUSED_STEP=1", "units": 64, "N": N, "T": T, "M": M,
          "launches": launches, "route_vs_direct_launch": route_err,
          "vs_per_step": {"trajectory_steps_compared": steps, "max_abs_err_est": err,
                          "est_scale": scale, "atol": LOOP_ATOL},
          "times": rates, "profile": profile, "tf32": False})
    return {"launches": launches, "rates": rates}


# The eval pipeline: the door eval set in memory (10 + 10 trajectories of
# 120-149 steps, the synthetic files' default size, from these seeds), M =
# EVAL_M particles, the model's weights from numpy_weights(EVAL_WEIGHTS_SEED)
# (not the port's seeded init, whose truncated-normal draws change with the
# torch version). At random weights most draws give dynamics that run to
# inf or nan over the eval set, and then the comparisons below hold
# nothing; seed 10's stay bounded (dynamics raw RMSEs about 2.1, 0.4, 2.7).
EVAL_FILES = (("panda_door_pull_10.hdf5", 0), ("panda_door_push_10.hdf5", 1))
EVAL_M = 300
EVAL_WEIGHTS_SEED = 10
EVAL_REPEATS = 20
EVAL_DATASET_ARGS = {"use_vision": True, "use_proprioception": True, "use_haptics": True,
                     "image_blackout_ratio": 0.0, "sequential_image_rate": 1}
EVAL_BLACKOUT = 0.1
# The noise-free dynamics rollout is deterministic: cuDNN and CPU GEMMs sum
# in other orders through up to 148 steps, so its raw RMSEs (O(1-10)) agree
# within 1e-5 of their scale.
EVAL_DYNAMICS_RTOL = 1e-5
# The eval CLI's result keys: the JAX CLI's, run_eval_stats over the door
# metrics.
EVAL_STAT_KEYS = sorted(f"{k}_{s}" for k in (
    "theta_rmse_deg", "x_rmse_cm", "y_rmse_cm", "filter_steps_per_sec",
    "filter_steps_per_sec_e2e") for s in ("mean", "std"))


class Replay:
    """Makes a facade's run_eval start every loop from `belief0` with the
    given noise and uniforms (belief setter, eps_seq, uniforms_seq), and
    records each loop's estimates and the launches of `counters` in it (each
    set to 0 just before the loop and read just after)."""

    def __init__(self, model, belief0, eps, uniforms, counters):
        import torch

        from multimodalfilter_tpu_torch.types import ParticleBelief

        self.model, self.counters, self.runs = model, counters, []
        device = model.device
        belief0 = ParticleBelief(*(x.to(device) for x in belief0))
        eps, uniforms = eps.to(device), uniforms.to(device)
        real_loop = model.forward_loop

        def init(**kwargs):
            model.belief = ParticleBelief(*(x.clone() for x in belief0))

        def loop(**kwargs):
            for c in counters.values():
                c.launches = 0
            est = real_loop(**kwargs, eps_seq=eps, uniforms_seq=uniforms)
            if est.is_cuda:
                torch.cuda.synchronize()
            self.runs.append((est, {k: c.launches for k, c in counters.items()}))
            return est

        model.initialize_beliefs, model.forward_loop = init, loop

    def restore(self):
        del self.model.initialize_beliefs, self.model.forward_loop


def numpy_weights(module, seed: int) -> None:
    """Random weights that are the same on every torch version: each weight
    uniform on +-sqrt(3 / fan_in) (variance 1/fan_in, as the seeded init's
    lecun_normal) from numpy's Generator, zero biases, loaded with
    load_state_dict."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    state = {}
    for name, p in module.state_dict().items():
        if name.endswith("bias"):
            state[name] = torch.zeros_like(p)
            continue
        limit = math.sqrt(3.0 / p[0].numel())
        draw = rng.uniform(-limit, limit, size=tuple(p.shape)).astype(np.float32)
        state[name] = torch.from_numpy(draw).to(p.device)
    module.load_state_dict(state)


def eval_set(cache, synthetic) -> None:
    """The door eval set in memory under the current cache path."""
    for name, seed in EVAL_FILES:
        cache.keep_in_memory(name, synthetic.named_trajectories(name, seed=seed))


def eval_profile(model, observations, controls, states) -> dict:
    """Where run_eval's time goes: one warm per-step forward_loop over the
    eval batch, as run_eval runs it, under torch.profiler (device busy
    share, B1's share, device kernels a step, the largest kernels)."""
    from torch.profiler import ProfilerActivity, profile

    import torch

    n, d = states.shape[1:]
    mean = torch.from_numpy(states[0]).to(model.device)
    cov = torch.eye(d, device=model.device).expand(n, d, d) * 0.1
    obs_rest = {k: v[1:] for k, v in observations.items()}

    def run():
        model.initialize_beliefs(mean=mean, covariance=cov)
        model.forward_loop(observations=obs_rest, controls=controls[1:]).cpu()

    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(prof)
    if not kernels:
        return {"device_time": "not measured"}
    by_name, busy_us = kernel_totals(kernels)
    b1_us = sum(v[1] for k, v in by_name.items() if ROW_TAIL_KERNEL in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    steps = controls.shape[0] - 1
    return {"N": n, "T": steps, "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us, "b1_ms": b1_us / 1e3,
            "device_kernels": len(kernels), "device_kernels_per_step": len(kernels) / steps,
            "host_ms_per_step": wall_us / 1e3 / steps,
            "top_kernels": [{"name": k[:80], "count": c, "ms": us / 1e3}
                            for k, (c, us) in top]}


def phase_eval_pipeline(door_models, fused_step, pf_kernels, pf_module, device) -> dict:
    """The door eval pipeline on the card through its entry points:
    DoorTask's eval set synthesised in memory, eval_helpers.configure,
    run_eval (both modes, card against CPU), run_eval_stats (sequential and
    batched), the fused route, a blackout run, and the eval CLI from a
    checkpoint saved with Buddy."""
    import contextlib
    import dataclasses
    import io
    import os

    import numpy as np
    import torch

    from multimodalfilter_tpu_torch.crossmodal import _eval_batching, eval_helpers
    from multimodalfilter_tpu_torch.crossmodal.tasks import DoorTask
    from multimodalfilter_tpu_torch.data import cache, synthetic
    from multimodalfilter_tpu_torch.experiments import Buddy
    from multimodalfilter_tpu_torch.scripts.door_task import eval_door
    from multimodalfilter_tpu_torch.types import ParticleBelief

    phase_start = time.perf_counter()
    saved_env = {k: os.environ.get(k) for k in (
        "MMF_TPU_SYNTHESIZE_DATA", "MMF_TPU_OFFLINE", "MMF_TPU_SYNTH_T", "MMF_TPU_SYNTH_TRAJ",
        "MMF_TPU_EVAL_DEVICE_THROUGHPUT", "MMF_TPU_EVAL_BATCH_REPEATS",
        "MMF_TPU_EVAL_BATCH_REPEATS_CAP", "MMF_TPU_FUSED_STEP")}
    saved_cache, saved_cwd = cache._cache_path, os.getcwd()
    workdir = tempfile.TemporaryDirectory(prefix="chip_smoke_eval_")
    work = workdir.name
    quiet = contextlib.redirect_stdout(io.StringIO())
    try:
        for k in saved_env:
            os.environ.pop(k, None)
        os.environ["MMF_TPU_SYNTHESIZE_DATA"] = "1"
        os.environ["MMF_TPU_OFFLINE"] = "1"
        os.chdir(work)  # Buddy's default directories, for the CLI
        cache.set_cache_path(os.path.join(work, "cache"))
        t0 = time.perf_counter()
        eval_set(cache, synthetic)
        synth_s = time.perf_counter() - t0

        cls = DoorTask.model_types["DoorCrossmodalParticleFilter"]
        model, cpu_model = cls(device=device), cls(device="cpu")
        numpy_weights(model.params, EVAL_WEIGHTS_SEED)
        cpu_model.params.load_state_dict(model.params.state_dict())
        for mdl in (model, cpu_model):
            mdl.definition = dataclasses.replace(mdl.definition, num_particles_eval=EVAL_M)
        buddy = Buddy("chip_smoke_eval", model, log_dir=os.path.join(work, "logs"),
                      verbose=False)
        cpu_buddy = Buddy("chip_smoke_eval_cpu", cpu_model,
                          log_dir=os.path.join(work, "logs"), verbose=False)

        def configure(b, **dataset_args):
            eval_helpers.configure(buddy=b, task=DoorTask,
                                   dataset_args={**EVAL_DATASET_ARGS, **dataset_args})

        # get_eval_batch's host time: the first call loads, preprocesses,
        # stacks and uploads the eval set; later calls hit the cache.
        configure(buddy)
        t0 = time.perf_counter()
        states, obs, controls = _eval_batching.get_eval_batch()
        torch.cuda.synchronize()
        batch_first_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        _eval_batching.get_eval_batch()
        batch_cached_ms = (time.perf_counter() - t0) * 1e3
        t_len, n = states.shape[:2]
        t1 = t_len - 1
        check(n == 20 and 120 <= t_len < 150, f"eval set of {n} trajectories of {t_len} steps")

        # (1) run_eval on the card against the same run_eval on the CPU: the
        # same initial belief, noise and uniforms; the tail inputs and
        # outputs of each step recorded (the CPU run's are the plain run's).
        g = torch.Generator(device=device).manual_seed(80)
        mean0 = torch.from_numpy(states[0]).to(device)
        belief0 = (mean0[:, None, :] + 0.3 * torch.randn((n, EVAL_M, 3), generator=g,
                                                          device=device),
                   torch.full((n, EVAL_M), -math.log(EVAL_M), device=device))
        eps = torch.randn((t1, n * EVAL_M, 3), generator=g, device=device)
        uni = torch.rand((t1, n, EVAL_M), generator=g, device=device)
        counters = {"b1": pf_kernels.launch_b1, "b3": fused_step.fused_forward_kernel}
        records = {"cuda": [], "cpu": []}
        into = ["cuda"]  # the run whose tail inputs are being recorded
        real_tail = pf_module.pf_update_and_resample

        def recording_tail(log_weights, log_liks, particles, uniforms, **kwargs):
            out = real_tail(log_weights, log_liks, particles, uniforms, **kwargs)
            records[into[0]].append((log_weights, log_liks, uniforms, particles, kwargs, out))
            return out

        os.environ["MMF_TPU_EVAL_DEVICE_THROUGHPUT"] = "0"
        results = {}
        pf_module.pf_update_and_resample = recording_tail
        try:
            for name, mdl, b in (("cuda", model, buddy), ("cpu", cpu_model, cpu_buddy)):
                replay = Replay(mdl, belief0, eps.cpu() if name == "cpu" else eps, uni, counters)
                configure(b)
                try:
                    into[0] = name
                    with quiet:
                        r = eval_helpers.run_eval()
                finally:
                    replay.restore()
                results[name] = (r, replay.runs)
                if name == "cuda":
                    # Every B1 call of the card's loops against its plain
                    # version on the same inputs, at the eval's shape.
                    b1_eval = b1_along_path(pf_kernels, records["cuda"])
                    records["cuda"] = records["cuda"][-t1:]  # the timed loop's
        finally:
            pf_module.pf_update_and_resample = real_tail
        (gpu_r, gpu_runs), (cpu_r, cpu_runs) = results["cuda"], results["cpu"]
        gpu_est, cpu_est = gpu_runs[-1][0], cpu_runs[-1][0]
        for est, launches in gpu_runs:
            check(launches == {"b1": t1, "b3": 0}, f"run_eval loop launches {launches}")
        check(tuple(gpu_est.shape) == (t1, n, 3) and bool(torch.isfinite(gpu_est).all()),
              "run_eval estimates on the card")
        check(len(records["cpu"]) == t1, f"{len(records['cpu'])} CPU tail calls")
        gpu_lls = torch.stack([r[1] for r in records["cuda"]]).cpu()
        first = first_divergence(records["cpu"], gpu_lls, pf_kernels)
        err, scale, steps = compare_through(gpu_est.cpu(), cpu_est, first)
        check(steps > 0, "run_eval: the card's draws diverged from the CPU's at the first step")
        check(err <= LOOP_ATOL * max(1.0, scale), f"run_eval card vs CPU estimates {err}")
        no_tie = bool((first == t1).all())
        rmse_err = float(np.abs(np.subtract(gpu_r["raw_rmse"], cpu_r["raw_rmse"])).max())
        if no_tie:
            check(rmse_err <= LOOP_ATOL * max(1.0, scale), f"run_eval RMSE gap {rmse_err}")

        # (2) The dynamics rollout, card against CPU.
        dyn = {}
        for name, b in (("cuda", buddy), ("cpu", cpu_buddy)):
            configure(b)
            with quiet:
                dyn[name] = eval_helpers.run_eval(eval_dynamics=True)
        dyn_err = float(np.abs(np.subtract(dyn["cuda"]["raw_rmse"], dyn["cpu"]["raw_rmse"])).max())
        dyn_scale = max(1.0, float(np.max(dyn["cpu"]["raw_rmse"])))
        check(np.isfinite(dyn["cuda"]["raw_rmse"]).all(), "dynamics RMSE not finite")
        check(dyn_err <= EVAL_DYNAMICS_RTOL * dyn_scale, f"dynamics RMSE gap {dyn_err}")

        # (3) run_eval_stats, sequential (the chained timer off: it would run
        # 20 loops a repeat) and batched (2 rollouts of batch 200, the chained
        # timer on, at N=20).
        stats = {}
        for mode, batched, timer in (("sequential", "0", "0"), ("batched", "1", "1")):
            os.environ["MMF_TPU_EVAL_BATCH_REPEATS"] = batched
            os.environ["MMF_TPU_EVAL_DEVICE_THROUGHPUT"] = timer
            configure(buddy)
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            with quiet:
                s = eval_helpers.run_eval_stats(repeats=EVAL_REPEATS)
            torch.cuda.synchronize()
            stats[mode] = {"wall_s": time.perf_counter() - t0, "chained_timer": timer == "1",
                           "b1_launches": counters["b1"].launches, **s}
            check(sorted(s) == EVAL_STAT_KEYS and all(np.isfinite(v) for v in s.values()),
                  f"run_eval_stats ({mode}): {s}")
            check(counters["b1"].launches > 0 and counters["b3"].launches == 0,
                  f"run_eval_stats ({mode}) launches")

        configure(buddy)
        profile = eval_profile(model, obs, controls, states)

        # (4) The fused route (MMF_TPU_FUSED_STEP=1): one B3 launch a loop,
        # its estimates against the per-step route's through each
        # trajectory's first divergent draw (B3's log-likelihoods against
        # the per-step run's record).
        os.environ["MMF_TPU_FUSED_STEP"] = "1"
        try:
            fused_model = cls(device=device)
        finally:
            del os.environ["MMF_TPU_FUSED_STEP"]
        check(fused_model.definition.fused_step, "MMF_TPU_FUSED_STEP=1 did not set fused_step")
        fused_model.params.load_state_dict(model.params.state_dict())
        fused_model.definition = dataclasses.replace(fused_model.definition,
                                                     num_particles_eval=EVAL_M)
        os.environ["MMF_TPU_EVAL_DEVICE_THROUGHPUT"] = "1"
        replay = Replay(fused_model, belief0, eps, uni, counters)
        configure(Buddy("chip_smoke_eval_fused", fused_model,
                        log_dir=os.path.join(work, "logs"), verbose=False))
        try:
            with quiet:
                fused_r = eval_helpers.run_eval()
        finally:
            replay.restore()
        for est, launches in replay.runs:
            check(launches == {"b1": 0, "b3": 1}, f"fused run_eval loop launches {launches}")
        check(fused_step.packing_report() is None, f"fused route fell back: "
              f"{fused_step.packing_report()}")
        fused_est = replay.runs[-1][0]
        with torch.no_grad():
            fdefn = fused_model.definition
            features, ctrl = fdefn.encode_sequences({k: v[1:] for k, v in obs.items()},
                                                    controls[1:])
            ops = fused_step.pack_operands(fdefn, features, ctrl, eps, None, EVAL_M)
            lls = torch.empty((t1, n, EVAL_M), device=device)
            fused_step.fused_forward_kernel(ops, ParticleBelief(*belief0), uni,
                                            log_liks_out=lls)
            torch.cuda.synchronize()
        ffirst = first_divergence(records["cuda"], lls, pf_kernels)
        ferr, fscale, fsteps = compare_through(fused_est, gpu_est, ffirst)
        check(fsteps > 0, "fused route: the draws diverged at the first step")
        check(ferr <= LOOP_ATOL * max(1.0, fscale), f"fused vs per-step estimates {ferr}")
        # B3 against its plain version on the eval's operands (N=20, M=300):
        # step by step, each step on its own inputs, then one whole launch.
        b3_eval = b3_per_step(fused_step, pf_kernels, ops, ParticleBelief(*belief0), uni)
        b3_eval_whole = b3_whole_loop(fused_step, pf_kernels, ops, ParticleBelief(*belief0),
                                      uni)

        # (5) A blackout run: every call re-masks the cached images on the
        # card; the zeroed share of frames lies within 4 sigma of the ratio.
        os.environ["MMF_TPU_EVAL_DEVICE_THROUGHPUT"] = "0"
        configure(buddy, image_blackout_ratio=EVAL_BLACKOUT)
        _, bobs, _ = _eval_batching.get_eval_batch()
        zeroed = float((bobs["image"].abs().amax(dim=(-2, -1)) == 0).float().mean())
        frames = bobs["image"].shape[0] * bobs["image"].shape[1]
        sigma = math.sqrt(EVAL_BLACKOUT * (1 - EVAL_BLACKOUT) / frames)
        check(abs(zeroed - EVAL_BLACKOUT) <= 4 * sigma, f"blackout share {zeroed}")
        with quiet:
            blackout_r = eval_helpers.run_eval()
        check(np.isfinite(blackout_r["raw_rmse"]).all(), "blackout run_eval RMSE")

        # (6) The eval CLI at its defaults, from a checkpoint and metadata
        # saved with Buddy under the working directory.
        os.environ["MMF_TPU_EVAL_DEVICE_THROUGHPUT"] = "1"
        saver = Buddy("chip_smoke_cli", model, verbose=False)
        saver.set_metadata({"model_type": "DoorCrossmodalParticleFilter",
                            "dataset_args": EVAL_DATASET_ARGS})
        saver.save_checkpoint("eval")
        t0 = time.perf_counter()
        with quiet:
            cli = eval_door.main(["--experiment-name", "chip_smoke_cli", "--save"],
                                 cache_dir=cache.get_cache_path())
        cli_s = time.perf_counter() - t0
        loaded = eval_helpers.filter_model
        check(loaded is not model and loaded.device == model.device, "CLI model")
        saved_sd, loaded_sd = model.params.state_dict(), loaded.params.state_dict()
        check(saved_sd.keys() == loaded_sd.keys()
              and all(torch.equal(saved_sd[k], loaded_sd[k]) for k in saved_sd),
              "the CLI's loaded parameters differ from the saved ones")
        check(sorted(cli) == EVAL_STAT_KEYS, f"CLI result keys {sorted(cli)}")
        with open(os.path.join(work, "metadata", "chip_smoke_cli.json")) as f:
            check(json.load(f).get("eval_results_stats") == cli, "--save metadata")
    finally:
        os.chdir(saved_cwd)
        workdir.cleanup()
        cache._cache_path = saved_cache
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def rmse(r):
        return {k: r[k] for k in ("raw_rmse", "theta_rmse_deg", "x_rmse_cm", "y_rmse_cm")}

    def stat(s):
        return {k: s[k] for k in ("wall_s", "chained_timer", "b1_launches",
                                  "theta_rmse_deg_mean", "theta_rmse_deg_std",
                                  "x_rmse_cm_mean", "x_rmse_cm_std",
                                  "y_rmse_cm_mean", "y_rmse_cm_std",
                                  "filter_steps_per_sec_mean",
                                  "filter_steps_per_sec_e2e_mean")}

    emit({"phase": "eval_pipeline", "model": "DoorCrossmodalParticleFilter", "units": 64,
          "weights_seed": EVAL_WEIGHTS_SEED, "N": n, "T": t_len, "M": EVAL_M,
          "synth_s": synth_s,
          "get_eval_batch_host_ms": {"first": batch_first_ms, "cached": batch_cached_ms},
          "run_eval": {"card": rmse(gpu_r), "cpu": rmse(cpu_r),
                       "e2e_filter_steps_per_s": gpu_r["filter_steps_per_sec_e2e"],
                       "b1_launches_per_loop": gpu_runs[-1][1]["b1"],
                       "loops": len(gpu_runs), "trajectory_steps_compared": steps,
                       "trajectories_never_diverged": int((first == t1).sum()),
                       "max_abs_err_est": err, "est_scale": scale, "atol": LOOP_ATOL,
                       "rmse_checked": no_tie, "max_abs_err_raw_rmse": rmse_err,
                       "b1_vs_plain": b1_eval},
          "eval_dynamics": {"card": rmse(dyn["cuda"]), "cpu": rmse(dyn["cpu"]),
                            "max_abs_err_raw_rmse": dyn_err, "rtol": EVAL_DYNAMICS_RTOL},
          "run_eval_stats": {mode: stat(s) for mode, s in stats.items()},
          "profile": profile,
          "fused": {"b3_launches_per_loop": replay.runs[-1][1]["b3"],
                    "loops": len(replay.runs), "trajectory_steps_compared": fsteps,
                    "max_abs_err_est": ferr, "est_scale": fscale,
                    "b3_per_step": b3_eval, "b3_whole_loop": b3_eval_whole,
                    "filter_steps_per_sec": fused_r["filter_steps_per_sec"],
                    "filter_steps_per_sec_e2e": fused_r["filter_steps_per_sec_e2e"],
                    **rmse(fused_r)},
          "blackout": {"ratio": EVAL_BLACKOUT, "zeroed_share": zeroed, "frames": frames,
                       "four_sigma": 4 * sigma, **rmse(blackout_r)},
          "cli": {"wall_s": cli_s, "keys_match_jax_cli": True, "params_bitwise": True,
                  "saved_eval_results_stats": True, **cli},
          "wall_s": time.perf_counter() - phase_start, "tf32": False})
    return {"b1_launches": gpu_runs[-1][1]["b1"], "b3_launches": replay.runs[-1][1]["b3"]}


def serving_profile(model, device) -> dict:
    """Where the serving loop's time goes: one warm fused forward_loop at
    N=16, T=100, M=300 under torch.profiler (device busy share, B3's share
    of it, the largest kernels)."""
    from torch.profiler import ProfilerActivity, profile

    import torch

    obs, controls = sequences(T, N, seed=63)
    mean, cov = initial_state(N)

    def run():
        model.initialize_beliefs(mean=mean, covariance=cov)
        model.forward_loop(observations=obs, controls=controls)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(prof)
    if not kernels:
        return {"device_time": "not measured"}
    by_name, busy_us = kernel_totals(kernels)
    b3_us = sum(v[1] for k, v in by_name.items() if "pf_fused_forward" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us, "b3_ms": b3_us / 1e3,
            "b3_share_of_wall": b3_us / wall_us, "device_kernels": len(kernels),
            "top_kernels": [{"name": k[:80], "count": c, "ms": us / 1e3}
                            for k, (c, us) in top]}


def phase_tail_paths(door_models, pf_kernels, device) -> dict:
    """The per-step eval loop through B4 (alpha=0.9) and through B5 (M=2048
    and M=16384): each launches its kernel once a step, B1 never."""
    import dataclasses

    import torch

    model = door_models.DoorCrossmodalParticleFilter(device=device, seed=0)
    model.eval()
    out = {}
    for name, m, t, alpha in TAIL_PATHS:
        model.definition = dataclasses.replace(model.definition, num_particles_eval=m,
                                               soft_resample_alpha=alpha)
        obs, controls = sequences(t, N, seed=70)
        mean, cov = initial_state(N)
        model.initialize_beliefs(mean=mean, covariance=cov)
        counters = {k: getattr(pf_kernels, f"launch_{k}") for k in ("b1", "b4", "b5")}
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        est = model.forward_loop(observations=obs, controls=controls)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        expected = {k: (t if k == name else 0) for k in counters}
        check(launches == expected, f"{name} path M={m}: launches {launches}")
        check(bool(torch.isfinite(est).all()), f"{name} path M={m}: non-finite estimates")
        out[f"{name}_M{m}"] = {"N": N, "M": m, "T": t, "alpha": alpha, "launches": launches,
                               "host_ms_first_loop": wall * 1e3}
    emit({"phase": "tail_paths", "runs": out})
    return out


def phase_new_times(fused_step, pf_kernels, b3_defn, device) -> dict:
    """B3 and B5 at their paths' shapes: host-paced time (CUDA events
    around back-to-back calls), device time per launch (torch.profiler), the
    plain version's time and the bound."""
    from torch.profiler import ProfilerActivity, profile

    import torch

    _, _, belief, _, uniforms, ops = door_sequences(b3_defn, T, N, M, device, seed=80)
    with torch.no_grad():
        k_ms = cuda_ms(lambda: fused_step.fused_forward_kernel(ops, belief, uniforms), repeats=5)
        p_ms = cuda_ms(lambda: fused_step.fused_forward_reference(ops, belief, uniforms),
                       repeats=3, warmup=1)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fused_step.fused_forward_kernel(ops, belief, uniforms)
            torch.cuda.synchronize()
    dev = [e.time_range.elapsed_us() for e in device_kernels(prof)
           if "pf_fused_forward" in e.name]
    bound, bound_by, flops = b3_bound_ms(T, N, M, 3, 2)
    plan = fused_step.launch_plan(N, M)
    out = {"b3": {"shape": [T, N, M, 3, 2], "ms": k_ms, "plain_ms": p_ms,
                  "device_ms": statistics.median(dev) / 1e3 if dev else None,
                  "bound_ms": bound, "bound_by": bound_by, "flops": flops,
                  "achieved_tflops": flops / (k_ms / 1e3) / 1e12,
                  "cluster": plan.cluster, "blocks": plan.blocks,
                  "max_active_clusters": plan.max_active_clusters,
                  "second_wave_from_N": plan.max_active_clusters + 1,
                  "trunks": "fp32 FMA", "library_ms": None}}
    for name, (n, m, d, alpha) in (("b5", (N, 2048, 3, 1.0)),
                                   ("b5_M16384", (N, 16384, 3, 1.0))):
        args = b1_inputs(n, m, d, device, seed=81)
        reps = 200 if m <= 2048 else 50

        def many(fn):
            return lambda: [fn(*args, alpha=alpha) for _ in range(reps)]

        k = cuda_ms(many(pf_kernels.pf_update_and_resample), repeats=5) / reps
        p = cuda_ms(many(pf_kernels.pf_update_and_resample_reference), repeats=5) / reps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                pf_kernels.pf_update_and_resample(*args, alpha=alpha)
            torch.cuda.synchronize()
        dev = [e.time_range.elapsed_us() for e in device_kernels(prof) if "cluster_tail" in e.name]
        bound, bound_by = tail_bound_ms(n, m, d, alpha < 1.0)
        out[name] = {"shape": [n, m, d], "alpha": alpha, "ms": k, "plain_ms": p,
                     "device_ms": statistics.median(dev) / 1e3 if dev else None,
                     "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
                     **pf_kernels.b5_launch(n, m, alpha)._asdict()}
    emit({"phase": "new_kernel_times", **out, "tf32": False})
    return out


def load_yardstick(root: str):
    """The tail wrappers ``ops/pf_kernels.py`` (B1, B4, B5) and
    ``ops/pf_estimate.py`` (B2) of another checkout of the port at `root`
    (an earlier commit unpacked with ``git archive``), loaded as a package
    of its own beside the port; its kernels build into `root`/build."""
    import importlib
    import importlib.util
    from pathlib import Path

    ops = Path(root).resolve() / "multimodalfilter_tpu_torch" / "ops"
    spec = importlib.util.spec_from_file_location(
        "yardstick_ops", ops / "__init__.py", submodule_search_locations=[str(ops)])
    package = importlib.util.module_from_spec(spec)
    sys.modules["yardstick_ops"] = package
    spec.loader.exec_module(package)
    return (importlib.import_module("yardstick_ops.pf_kernels"),
            importlib.import_module("yardstick_ops.pf_estimate"))


def phase_yardstick(old, pf_kernels, pf_module, model, device) -> None:
    """This checkout's B1 and B4 against `old` (the same wrapper and kernels
    from another checkout) on the same card, each measurement in turns (old,
    new, new, old): device µs per launch (torch.profiler) at the eval
    paths' shapes, host-paced µs (CUDA events around 200 back-to-back
    calls), the host µs of a call and its parts (``launch_parts``), and
    filter-steps/s of the per-step eval loop at N=16, T=100, M=300 with
    each wrapper in the loop."""
    import dataclasses

    import torch

    turns = (("old", old), ("new", pf_kernels), ("new_2", pf_kernels), ("old_2", old))
    names = {"old": "pf_tail_kernel", "new": ROW_TAIL_KERNEL}
    out = {}
    for label, n, m, d, alpha in (("b1", N, M, 3, 1.0), ("b4", N, M, 3, SOFT_ALPHA),
                                  ("b1", SAT_N, SAT_M, 3, 1.0), ("b1", N, 1024, 8, 1.0),
                                  ("b4", N, 1024, 8, 0.5)):
        args = b1_inputs(n, m, d, device, seed=90)
        row = {}
        for turn, mod in turns:
            def call():
                return mod.pf_update_and_resample(*args, alpha=alpha)

            row[turn] = {"device_us": device_us(call, names[turn.split("_")[0]]),
                         "host_paced_us": 1e3 * cuda_ms(
                             lambda: [call() for _ in range(200)], repeats=5) / 200}
        out[f"{label}_{n}x{m}x{d}"] = row
    parts = {turn: launch_parts(mod, b1_inputs(N, M, 3, device, seed=91))
             for turn, mod in turns}

    model.definition = dataclasses.replace(model.definition, num_particles_eval=M)
    obs, controls = sequences(T, N, seed=92)
    obs = {k: torch.from_numpy(v).to(device) for k, v in obs.items()}
    controls = torch.from_numpy(controls).to(device)
    mean, cov = initial_state(N)

    def run():
        model.initialize_beliefs(mean=mean, covariance=cov)
        model.forward_loop(observations=obs, controls=controls)

    loop = {}
    real_tail = pf_module.pf_update_and_resample
    try:
        for turn, mod in turns:
            pf_module.pf_update_and_resample = mod.pf_update_and_resample
            ms, host_ms = loop_ms(run, repeats=5)
            loop[turn] = {"ms_per_loop": ms, "host_ms_per_loop": host_ms,
                          "filter_steps_per_s": T * N / (ms / 1e3)}
    finally:
        pf_module.pf_update_and_resample = real_tail
    emit({"phase": "yardstick", "tails": out, "launch_path_us": parts,
          "forward_loop": {"N": N, "M": M, "T": T, **loop}})


def phase_yardstick_b2(old, pf_estimate, pf_module, model, trajs, device) -> None:
    """This checkout's B2f and B2b against `old` (the same wrapper and
    kernels from another checkout) on the same card, each measurement in
    turns (old, new, new, old): device µs per launch (torch.profiler) and
    host-paced µs (CUDA events around 200 back-to-back calls) at B=32 and
    B=512, the host µs of calls and their parts (``b2_launch_parts``), and
    train filter-steps/s at both B with each wrapper in the filter."""
    turns = (("old", old), ("new", pf_estimate), ("new_2", pf_estimate), ("old_2", old))
    out = {}
    for n in (TRAIN_B, TRAIN_SAT_B):
        args = b2_inputs(n, TRAIN_M, 3, device, seed=93)
        calls = {turn: b2_calls(mod, args) for turn, mod in turns}
        for i, (key, name) in enumerate((("b2f", "pf_estimate_fwd"), ("b2b", "pf_estimate_bwd"))):
            row = {}
            for turn, _ in turns:
                call = calls[turn][i]
                row[turn] = {"device_us": device_us(call, name),
                             "host_paced_us": 1e3 * cuda_ms(
                                 lambda: [call() for _ in range(200)], repeats=5) / 200}
            out[f"{key}_{n}x{TRAIN_M}x3"] = row
    parts = {turn: b2_launch_parts(mod, b2_inputs(TRAIN_B, TRAIN_M, 3, device, seed=94))
             for turn, mod in turns}
    datasets = train_datasets(trajs)
    rates = {}
    real = pf_module.pf_update_estimate
    try:
        for turn, mod in turns:
            pf_module.pf_update_estimate = mod.pf_update_estimate
            rates[turn] = train_rates(model, datasets, f"yardstick_{turn}")
    finally:
        pf_module.pf_update_estimate = real
    emit({"phase": "yardstick_b2", "kernels": out, "launch_path_us": parts, "train": rates})


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--yardstick", metavar="DIR",
                        help="also time B1, B4, B2f and B2b against the wrappers and kernels "
                             "of the checkout at DIR, in turns")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from multimodalfilter_tpu_torch.crossmodal import door_models
        from multimodalfilter_tpu_torch.filtering import pf as pf_module
        from multimodalfilter_tpu_torch.ops import _build, fused_step, pf_estimate, pf_kernels
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    start = t0 = time.perf_counter()
    old = None
    if opts.yardstick:  # its build runs beside this checkout's
        import threading

        old, old_b2 = load_yardstick(opts.yardstick)
        old_build = threading.Thread(target=sys.modules["yardstick_ops._build"].build,
                                     args=(["pf_resample", "pf_estimate"],))
        old_build.start()
    built = _build.build()
    if old is not None:
        old_build.join()
    build_s = time.perf_counter() - t0
    emit({"phase": "card", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "built": built, "build_s": build_s,
          "tf32_matmul": False, "tf32_cudnn": False})

    b1_check = phase_b1(pf_kernels, device)
    b45_check = phase_b45(pf_kernels, device)
    b2_check = phase_b2(pf_estimate, device)
    b3_check = phase_b3(door_models, fused_step, pf_kernels, device)
    main_path = phase_main_path(door_models, pf_kernels, pf_module, device)
    serving = phase_serving(door_models, fused_step, pf_kernels, pf_module, device)
    eval_pipeline = phase_eval_pipeline(door_models, fused_step, pf_kernels, pf_module, device)
    tail_paths = phase_tail_paths(door_models, pf_kernels, device)
    train_path = phase_train_path(
        door_models, (pf_kernels.launch_b1,
                      pf_estimate.pf_update_estimate_fwd,
                      pf_estimate.pf_update_estimate_bwd), device)
    times = phase_times(main_path["model"], pf_kernels, device)
    if old is not None:
        phase_yardstick(old, pf_kernels, pf_module, main_path["model"], device)
    new_times = phase_new_times(fused_step, pf_kernels, b3_check["defn"], device)
    b2_times, rates = phase_train_times(
        train_path["model"], train_path["trajectories"], pf_estimate, device)
    if old is not None:
        phase_yardstick_b2(old_b2, pf_estimate, pf_module, train_path["model"],
                           train_path["trajectories"], device)
    phase_profile(main_path["model"], pf_kernels, device)
    phase_train_profile(train_path["model"], train_path["trajectories"], pf_estimate,
                        device, rates[0]["ms_per_step"])

    emit({"phase": "done", "wall_s": time.perf_counter() - start})
    emit({"kernels": [{
        "name": "pf_update_and_resample",
        "route": "cuda",
        "source": "multimodalfilter_tpu_torch/csrc/pf_resample.cu",
        "replaces": "multimodalfilter_tpu/ops/pallas_pf.py:65",
        "launches": main_path["launches"],
        "eval_pipeline_launches": eval_pipeline["b1_launches"],
        "max_abs_err": b1_check["max_abs_err_est"],
        "max_abs_err_est": b1_check["max_abs_err_est"],
        "index_mismatch_non_tie": b1_check["index_mismatch_non_tie"],
        "shape": [N, M, 3],
        "ms": times["b1"]["ms"],
        "plain_ms": times["b1"]["plain_ms"],
        "bound_ms": times["b1"]["bound_ms"],
        "bound_by": times["b1"]["bound_by"],
        "library_ms": None,
    }] + [{
        "name": f"pf_update_estimate_{part}",
        "route": "cuda",
        "source": "multimodalfilter_tpu_torch/csrc/pf_estimate.cu",
        "replaces": f"multimodalfilter_tpu/ops/pallas_pf.py:{line}",
        "launches": train_path["launches"][key],
        "max_abs_err": b2_check[part],
        "shape": [TRAIN_B, TRAIN_M, 3],
        "ms": b2_times[f"{key}_{TRAIN_B}x{TRAIN_M}x3"]["ms"],
        "plain_ms": b2_times[f"{key}_{TRAIN_B}x{TRAIN_M}x3"]["plain_ms"],
        "bound_ms": b2_times[f"{key}_{TRAIN_B}x{TRAIN_M}x3"]["bound_ms"],
        "bound_by": b2_times[f"{key}_{TRAIN_B}x{TRAIN_M}x3"]["bound_by"],
        "library_ms": None,
    } for part, key, line in (("fwd", "b2f", 458), ("bwd", "b2b", 486))] + [{
        "name": "pf_fused_forward",
        "route": "cuda",
        "source": "multimodalfilter_tpu_torch/csrc/pf_fused_step.cu",
        "replaces": "multimodalfilter_tpu/ops/pallas_fused_step.py:158",
        "launches": serving["launches"]["b3"],
        "eval_pipeline_launches": eval_pipeline["b3_launches"],
        "max_abs_err": b3_check["max_abs_err_est"],
        "shape": [T, N, M, 3, 2],
        **{k: new_times["b3"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")},
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "multimodalfilter_tpu_torch/csrc/pf_resample.cu",
        "replaces": f"multimodalfilter_tpu/ops/pallas_pf.py:{line}",
        "launches": tail_paths[path]["launches"][key],
        "max_abs_err": b45_check[key],
        "shape": source[key]["shape"],
        **{k: source[key][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")},
    } for name, key, line, path, source in (
        ("pf_soft_resample", "b4", 134, f"b4_M{M}", times),
        ("pf_resample_large", "b5", 217, "b5_M2048", new_times))]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
