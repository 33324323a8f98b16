"""Measure the CPU reference baseline (the anchor of a benchmark's vs_baseline).

Runs the faithful single-core re-implementation of the reference's CSR
red/black SOR hot loop (``parmgmc_tpu_torch/native/ref_sor_bench.cpp``;
the semantics of the reference's src/mc_sor.c:241-296) plus the
std-normal fill (src/parmgmc.c:70-116, its fallback path), then derives
the 64-rank MPI baseline ESS/sec under a perfect-scaling model that is
deliberately generous to the reference:

  * 64 ranks x the measured per-core sweep rate, zero halo/latency cost,
  * the RNG fill free (the reference's MKL ICDF path is much faster than
    the Box-Muller fallback timed here),
  * a V(1,0) MGMC cycle = 2.57 fine-sweep-equivalents of traffic
    (sweep 1.0 + residual matvec 1.0 + transfers 0.25, x 1.143 for the
    coarser-level recursion sum(1/8^l)),
  * a matched IACT tau = 1.07 (the rebuild's own measured tau).

It runs on the host alone (no ``--device``).

    python -m parmgmc_tpu_torch.examples.baseline_cpu_reference [edge=128]
"""

import argparse

from parmgmc_tpu_torch.native import ref_sor_bench

N_FINE = 256  # the flagship grid the baseline is quoted for
CYCLE_SWEEP_EQUIV = 2.57
TAU = 1.07
RANKS = 64


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("edge", nargs="?", type=int, default=128)
    edge = ap.parse_args(argv).edge
    ndof, sec_sweep, sec_fill = ref_sor_bench(edge, nsweeps=6)
    rate = ndof / sec_sweep
    print(f"grid {edge}^3 = {ndof} DOF (f64 CSR, one core)")
    print(f"  SOR sweep : {sec_sweep * 1e3:8.2f} ms  ({rate / 1e6:6.1f} MDOF/s,"
          f" ~{rate * 100 / 1e9:.1f} GB/s at ~100 B/DOF)")
    print(f"  N(0,1) fill: {sec_fill * 1e3:8.2f} ms  "
          f"({ndof / sec_fill / 1e6:6.1f} MDOF/s, Box-Muller fallback)")

    n_flag = N_FINE**3
    cycles_per_sec = RANKS * rate / (n_flag * CYCLE_SWEEP_EQUIV)
    ess = cycles_per_sec / TAU
    print(f"\n64-rank perfect-scaling model on {N_FINE}^3:")
    print(f"  {cycles_per_sec:6.1f} V(1,0)-cycles/s  ->  {ess:6.1f} ESS/sec "
          f"(tau={TAU})")
    print("bench.py BASELINE_ESS_PER_SEC rounds this up in the reference's "
          "favour (see BENCH_NOTES.md).")
    return dict(edge=edge, ndof=ndof, sec_sweep=sec_sweep, sec_fill=sec_fill, mdof_per_s=rate / 1e6,
                cycles_per_sec=cycles_per_sec, ess_per_sec=ess)


if __name__ == "__main__":
    main()
