"""Coarse host-pipeline profiling on a synthetic genome.

Usage: python scripts/host_profile.py [length] [coverage] [--cprofile]
Caches generated data under /tmp/rovaca_prof_<len>_<cov>.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402


def make_data(length, coverage):
    import simdata
    from rovaca_tpu.io.fasta import write_fasta

    cache = f"/tmp/rovaca_prof_{length}_{coverage}"
    fasta, bam = cache + ".fa", cache + ".bam"
    if os.path.exists(fasta) and os.path.exists(bam):
        return fasta, bam
    rng = np.random.default_rng(5)
    ref = simdata.random_ref(rng, length)
    variants = []
    pos = 500
    while pos < length - 1000:
        t = int(rng.integers(0, 3))
        if t == 0:
            variants.append((pos, ref[pos],
                             "ACGT"[("ACGT".index(ref[pos]) + 1) % 4]))
        elif t == 1:
            variants.append((pos, ref[pos:pos + 3], ref[pos]))
        else:
            variants.append((pos, ref[pos], ref[pos] + "TG"))
        pos += int(rng.integers(400, 1200))
    hap2 = simdata.apply_variants(ref, variants)
    n = coverage * length // 100 // 2
    t0 = time.perf_counter()
    reads = (simdata.simulate_reads(rng, ref, ref, "chr1", n,
                                    name_prefix="h1_")
             + simdata.simulate_reads(rng, ref, hap2, "chr1", n,
                                      name_prefix="h2_"))
    print(f"[gen] {len(reads)} reads in {time.perf_counter() - t0:.1f}s",
          flush=True)
    write_fasta(fasta, {"chr1": ref})
    simdata.write_test_bam(bam, reads, "chr1", length)
    return fasta, bam


def main():
    length = int(sys.argv[1]) if len(sys.argv) > 1 else 20000
    coverage = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    fasta, bam = make_data(length, coverage)

    from rovaca_tpu.pipeline.caller import HaplotypeCaller, HCArgs
    args = HCArgs(bam_paths=[bam], reference_path=fasta,
                  output_path="/tmp/rovaca_prof_out.vcf",
                  pairhmm_engine=os.environ.get("ENGINE", "xla"),
                  log_level="WARNING")

    use_cprofile = "--cprofile" in sys.argv
    t0 = time.perf_counter()
    c0 = time.process_time()
    if use_cprofile:
        import cProfile
        import pstats
        pr = cProfile.Profile()
        pr.enable()
        stats = HaplotypeCaller(args).run()
        pr.disable()
        dt = time.perf_counter() - t0
        ps = pstats.Stats(pr)
        ps.sort_stats("cumulative")
        ps.print_stats(25)
    else:
        stats = HaplotypeCaller(args).run()
        dt = time.perf_counter() - t0
    bases = length * coverage
    import jax
    print(f"[run] backend={jax.default_backend()} {stats} in {dt:.1f}s "
          f"(cpu {time.process_time() - c0:.1f}s) -> "
          f"{bases / dt / 1e3:.1f} kbases/s aligned throughput", flush=True)


if __name__ == "__main__":
    main()
