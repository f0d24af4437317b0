"""The multi-card communication model.

Every default below is an NVIDIA H100 SXM figure: a data-sheet figure, or
a rate measured on the card by a script of this repository, each named
where it is set.  (The least times of the rotations, the benchmark's
roofline, are ``portbench/roofline.py``'s.)
"""

from __future__ import annotations

from fhe_regex_tpu_torch.params import Params

# No machine with more than one card has run the port yet, so the scaling
# claim is FALSIFIABLE instead of measured: this model predicts the
# collective traffic and scaling efficiency of each parallelism strategy
# (parallel/mesh.py, parallel/collective.py, parallel/tensor.py) from first
# principles, to be held against the first run over 2-4 cards.
#
# Bandwidth defaults are H100 SXM data-sheet figures, not measurements:
# NVLink 4, 18 links and 900 GB/s per card in both directions together, so
# 450 GB/s each way (link_bw); across hosts one 400 Gb/s NDR InfiniBand
# port per card, 50 GB/s (net_bw).  The latency floors per collective hop
# (link_lat, net_lat) are neither data-sheet figures nor measured: they
# are assumptions until a multi-card run measures them.  The port's TP
# all-reduce sums int64 partials (exact in any order), twice the 32-bit
# words the model counts.

# The TP stage split: under tensor parallelism the external product
# divides by D while the digit pass, sample extract, keyswitch and the
# rest of the bootstrap are replicated on every card.  The split is
# MEASURED: chip_profile.py (tp_split) profiles one cuda-fused bootstrap
# batch and separates the external product's device time from the rest.
TP_PROFILE = {
    "source": "chip_profile.py tp_split",
    "measured": "NVIDIA H100 80GB HBM3, 700.00 W, cuda-fused, B=256, "
                "TPU_MESSAGE_2_CARRY_2",
    "ext_product_s": 0.136015,
    "glue_s": 0.004088,
    "total_s": 0.140103,
}
# replicated (non-divisible) fraction of a bootstrap batch under TP
TP_GLUE_FRACTION = TP_PROFILE["glue_s"] / TP_PROFILE["total_s"]


def comm_model(params: Params, n_devices: int, batch_per_device: int,
               *, pbs_rate_per_chip: float = 1829.0,
               link_bw: float = 450e9, link_lat: float = 1e-5,
               net_bw: float = 50e9, net_lat: float = 2e-5,
               hosts: int = 1) -> dict:
    """Bytes-and-time model for the three parallelism strategies.

    Returns per-strategy dicts with the bytes each collective moves, the
    rounds it takes, and the predicted scaling efficiency at the given
    per-card bootstrap rate (default: 1829 PBS/s, cuda-fused at B = 256 on
    an NVIDIA H100 80GB HBM3 at 700 W, measured by chip_smoke.py phase 4).

    * batch (parallel/mesh.py): levels shard the PBS batch; NO steady-state
      collective in this model (each card bootstraps its slice; key
      material replicated).  The only cross-card traffic counted is the
      final OR-tree.
    * or-tree (parallel/collective.py): ceil(log2(D)) ring-shift rounds,
      one LWE ciphertext [n+1] per card per round (x2 words at 64 bit),
      plus ONE bootstrap per round per card.
    * tensor (parallel/tensor.py): the (k+1)*l GGSW rows of each CMUX step
      shard over D; every step all-reduces [B, (k+1), N] partials — a ring
      all-reduce moves 2(D-1)/D of that per card per step, n steps per
      PBS.  ``link_*`` within a host, ``net_*`` across hosts.
    """
    n = params.lwe_dimension
    k1 = params.glwe_dimension + 1
    N = params.polynomial_size
    word = 4 if params.torus_bits == 32 else 8
    D = n_devices
    B = batch_per_device

    lwe_bytes = (n + 1) * word
    rounds = (D - 1).bit_length()          # ceil(log2 D); 0 at D == 1
    bw = net_bw if hosts > 1 else link_bw
    lat = net_lat if hosts > 1 else link_lat

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
    tp_bytes = n * psum_bytes_step * ring        # per card per batched PBS
    t_tp_comm = n * (psum_bytes_step * ring / bw + 2 * lat)
    # the external product divides by D; the rest is replicated — the
    # split is the measured TP_PROFILE decomposition
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
