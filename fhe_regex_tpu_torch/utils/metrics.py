"""Cost model + run counters.

The reference's only observability is the ct_ops / cache_hits pair logged at
the end of a run (execution.rs:56-62, engine.rs:36-40).  We keep those
(emitted by has_match) and add the quantities that matter on TPU: bootstrap
counts, level counts, and an analytic FLOP model of the blind-rotation
kernel for roofline comparisons.
"""

from __future__ import annotations

import dataclasses

from fhe_regex_tpu_torch.params import Params


@dataclasses.dataclass
class PbsCost:
    macs_per_pbs: float        # MXU multiply-accumulates per bootstrap
    hbm_bytes_per_pbs: float   # bootstrap-key traffic per bootstrap


def pbs_cost_model(params: Params, limbs: int = 4) -> PbsCost:
    """MXU/HBM cost of one programmable bootstrap in the matmul formulation.

    Per CMUX step: (k+1)*level digit polys each convolved into (k+1) output
    polys; each negacyclic polymul is an N x N matmul done `limbs` times for
    exactness.
    """
    n = params.lwe_dimension
    k1 = params.glwe_dimension + 1
    rows = k1 * params.pbs_level
    N = params.polynomial_size
    macs = float(n) * rows * k1 * limbs * N * N
    # bootstrap key bytes streamed once per *batch*, amortized over batch=1
    hbm = float(n) * rows * k1 * N * 4
    return PbsCost(macs_per_pbs=macs, hbm_bytes_per_pbs=hbm)


def speed_of_light_pbs_per_sec(params: Params, tflops: float = 197.0,
                               mxu_util: float = 1.0, batch: int = 256) -> float:
    """Upper bound on bootstraps/s/chip at the given bf16 TFLOPs."""
    cost = pbs_cost_model(params)
    flops = 2.0 * cost.macs_per_pbs
    return tflops * 1e12 * mxu_util / flops


# ---------------- multi-chip communication model (VERDICT r3 #10) -------
#
# Real >1-chip hardware is unavailable in this environment, so the scaling
# claim must be FALSIFIABLE instead of measured: this model predicts the
# collective traffic and scaling efficiency of each parallelism strategy
# (parallel/mesh.py, parallel/collective.py, parallel/tensor.py) from first
# principles.  The day multi-chip hardware appears, benchmarks/scaling.py's
# measured efficiency is compared against `predicted_efficiency` — a
# mismatch falsifies the model (and the >=80% BASELINE target rests on it).
#
# Bandwidth anchors (public v5e specs): ICI ~ 4 x 100 GB/s links per chip
# (use 400e9 aggregate, 45e9 per-direction per-link conservative for ring
# collectives); DCN ~ 25 GB/s per host.  Latency floor per collective hop:
# ~5 us (ICI) / ~50 us (DCN).

# Provenance of the TP stage-split constant (VERDICT r4 weak #6): under
# tensor parallelism the external-product MXU work divides by D while the
# stage-1 rotate/decompose + keyswitch + glue is replicated on every chip.
# The split is MEASURED, not assumed: benchmarks/profile_fused.py times the
# fused launch at limbs=(0,), (0,1,2), (0,1,2,3) and separates the per-limb
# MXU slope from the fixed glue.  Numbers below are its 2026-08-20 v5e run
# (pallas-fused int8, B=1792, TPU_MESSAGE_2_CARRY_2: ~378 ms/limb x 4 +
# ~415 ms fixed = 1926 ms/launch).  profile_fused.py now writes each fresh
# run to benchmarks/profiles/fused_profile.json; tests/test_comm_model.py
# fails if a recorded profile drifts materially from these constants, so a
# kernel change that shifts the split forces this block to be re-derived.
TP_PROFILE = {
    "source": "benchmarks/profile_fused.py",
    "measured": "2026-08-20 v5e, pallas-fused int8, B=1792, "
                "TPU_MESSAGE_2_CARRY_2",
    "per_limb_mxu_s": 0.378,
    "fixed_glue_s": 0.415,
    "total_s": 1.926,
}
# replicated (non-divisible) fraction of a launch under TP
TP_GLUE_FRACTION = TP_PROFILE["fixed_glue_s"] / TP_PROFILE["total_s"]


def comm_model(params: Params, n_devices: int, batch_per_device: int,
               *, pbs_rate_per_chip: float = 950.0,
               ici_bw: float = 45e9, ici_lat: float = 5e-6,
               dcn_bw: float = 25e9, dcn_lat: float = 50e-6,
               hosts: int = 1) -> dict:
    """Bytes-and-time model for the three parallelism strategies.

    Returns per-strategy dicts with the bytes each collective moves, the
    rounds it takes, and the predicted scaling efficiency at the given
    per-chip bootstrap rate.

    * batch (parallel/mesh.py): levels shard the PBS batch; NO steady-state
      collective (each chip bootstraps its slice; key material replicated).
      The only cross-chip traffic is the final OR-tree.
    * or-tree (parallel/collective.py): ceil(log2(D)) ppermute rounds, one
      LWE ciphertext [n+1] per device per round (x2 limb words at 64 bit),
      plus ONE bootstrap per round per device.
    * tensor (parallel/tensor.py): the (k+1)*l GGSW rows of each CMUX step
      shard over D; every step psums [B, (k+1), N] int32 partials — a ring
      all-reduce moves 2(D-1)/D of that per chip per step, n steps per PBS.
    """
    n = params.lwe_dimension
    k1 = params.glwe_dimension + 1
    N = params.polynomial_size
    word = 4 if params.torus_bits == 32 else 8
    D = n_devices
    B = batch_per_device

    lwe_bytes = (n + 1) * word
    rounds = (D - 1).bit_length()          # ceil(log2 D); 0 at D == 1
    bw = dcn_bw if hosts > 1 else ici_bw
    lat = dcn_lat if hosts > 1 else ici_lat

    # --- OR-tree: log rounds, one ct + one bootstrap each ---
    or_bytes = rounds * lwe_bytes
    or_time = rounds * (lwe_bytes / bw + lat + 1.0 / pbs_rate_per_chip)

    # --- batch parallelism over a whole run_many-style launch ---
    # compute time for the local slice vs the OR-tree epilogue
    t_compute = B / pbs_rate_per_chip
    batch_eff = t_compute / (t_compute + or_time)

    # --- tensor parallelism inside one bootstrap ---
    psum_bytes_step = B * k1 * N * word          # the partial accumulator
    ring = 2.0 * (D - 1) / D if D > 1 else 0.0
    tp_bytes = n * psum_bytes_step * ring        # per chip per batched PBS
    t_tp_comm = n * (psum_bytes_step * ring / bw + 2 * lat)
    # MXU work divides by D; stage-1/VPU work is replicated — the split is
    # the measured TP_PROFILE decomposition (415 ms glue of ~1926 ms at 32
    # bit => glue fraction ~0.215), kept in sync by the drift test
    t_one = B / pbs_rate_per_chip
    g = TP_GLUE_FRACTION
    t_tp = t_one * (1.0 - g) / D + t_one * g + t_tp_comm
    tp_speedup = t_one / t_tp if t_tp > 0 else float("inf")

    return {
        "devices": D, "hosts": hosts, "word_bytes": word,
        "or_tree": {"rounds": rounds, "bytes_per_device": or_bytes,
                    "seconds": or_time},
        "batch": {"steady_state_bytes": 0, "efficiency": batch_eff},
        "tensor": {"bytes_per_chip_per_batched_pbs": tp_bytes,
                   "psum_bytes_per_step": psum_bytes_step,
                   "comm_seconds": t_tp_comm,
                   "speedup_at_D": tp_speedup},
    }
