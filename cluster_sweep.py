#!/usr/bin/env python3
"""The measurements behind the cluster sizes of the port's two cluster
kernels, on one CUDA card.

    python3 cluster_sweep.py

B5 (``csrc/pf_resample.cu``) splits each row over a thread-block cluster of
``pf_kernels.b5_cluster_size(M)`` blocks. This script times B5's device
time per launch (torch.profiler, median of 20) at every cluster size from 2
to 8, in both modes, at M = 2,048 and 16,384 with N = 16 rows, beside how
many such clusters the card holds at once. B3 (``csrc/pf_fused_step.cu``)
runs a cluster per trajectory; the script times its T=100, M=300 loop at
N=1 and on both sides of the N where a second wave begins. Prints the
card's name and power limit, then one JSON line. Not part of
``chip_smoke.py``: it informs a choice, and is rerun when the kernels
change.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys

import chip_smoke

CLUSTERS = (2, 3, 4, 5, 6, 7, 8)
SWEEP_M = (2048, 16384)
N, T, M = 16, 100, 300


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("cluster_sweep: CUDA is not available", file=sys.stderr)
        return 1
    from multimodalfilter_tpu_torch.crossmodal import door_models
    from multimodalfilter_tpu_torch.ops import _build, fused_step, pf_kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    _build.build()

    b5 = {}
    for m in SWEEP_M:
        args = chip_smoke.b1_inputs(N, m, 3, device, seed=83)
        for c in CLUSTERS:
            for alpha in (1.0, 0.5):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        pf_kernels._launch_b5_in_clusters(args, alpha, c)
                    torch.cuda.synchronize()
                dev = [e.time_range.elapsed_us() for e in chip_smoke.device_kernels(prof)
                       if "cluster_tail" in e.name]
                plan = pf_kernels._b5_plan(N, m, c, alpha < 1.0, occupancy=True)
                b5[f"M{m}_C{c}_alpha{alpha}"] = {
                    "device_us": statistics.median(dev), "strided": plan.strided,
                    "max_active_clusters": plan.max_active_clusters}

    model = door_models.DoorCrossmodalParticleFilter(device=device, seed=0)
    defn = dataclasses.replace(model.definition, num_particles_eval=M)
    max_clusters = fused_step.launch_plan(1, M).max_active_clusters
    b3 = {"max_active_clusters": max_clusters}
    for n in (1, max_clusters, max_clusters + 1):
        _, _, belief, _, uniforms, ops = chip_smoke.door_sequences(defn, T, n, M, device,
                                                                   seed=82)
        with torch.no_grad():
            b3[f"ms_N{n}"] = chip_smoke.cuda_ms(
                lambda: fused_step.fused_forward_kernel(ops, belief, uniforms),
                repeats=3, warmup=1)
    print(json.dumps({"b5_device_us_by_cluster": b5, "b3_T100_M300": b3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
