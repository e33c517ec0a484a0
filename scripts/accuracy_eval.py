"""Accuracy evaluation on a synthetic diploid truth set.

Generates a genome with known het/hom SNPs and indels, simulates reads,
runs the caller, and reports recall / precision / genotype concordance.

Usage: python scripts/accuracy_eval.py [length] [coverage] [n_variants]
"""

import faulthandler
import os
import signal
import sys
import time

faulthandler.register(signal.SIGUSR1)  # kill -USR1 <pid> dumps all stacks

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
# ENGINE_PLATFORM=cuda runs the caller on the GPU; the default pins the CPU
os.environ["JAX_PLATFORMS"] = os.environ.get("ENGINE_PLATFORM", "cpu")

import numpy as np  # noqa: E402


def make_truth(rng, ref, n_variants):
    """[(pos, ref_allele, alt_allele, genotype)] with genotype het/hom."""
    truth = []
    pos = 400
    step = (len(ref) - 800) // n_variants
    for _ in range(n_variants):
        t = int(rng.integers(0, 4))
        gt = "hom" if rng.random() < 0.3 else "het"
        if t <= 1:  # SNP
            alt = "ACGT"[("ACGT".index(ref[pos]) + 1 + int(rng.integers(0, 3))) % 4]
            if alt == ref[pos]:
                alt = "ACGT"[("ACGT".index(ref[pos]) + 1) % 4]
            truth.append((pos, ref[pos], alt, gt))
        elif t == 2:  # deletion 1-6bp
            n = int(rng.integers(1, 7))
            truth.append((pos, ref[pos:pos + n + 1], ref[pos], gt))
        else:  # insertion 1-6bp
            ins = "".join(rng.choice(list("ACGT"), size=int(rng.integers(1, 7))))
            truth.append((pos, ref[pos], ref[pos] + ins, gt))
        pos += step + int(rng.integers(-step // 4, step // 4))
        if pos >= len(ref) - 400:
            break
    return truth


def main():
    import simdata
    from rovaca_tpu.io.fasta import write_fasta
    from rovaca_tpu.pipeline.caller import HaplotypeCaller, HCArgs

    length = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    coverage = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    n_variants = int(sys.argv[3]) if len(sys.argv) > 3 else 150

    rng = np.random.default_rng(42)
    ref = simdata.random_ref(rng, length)
    truth = make_truth(rng, ref, n_variants)

    hom = [(p, r, a) for p, r, a, g in truth if g == "hom"]
    het = [(p, r, a) for p, r, a, g in truth if g == "het"]
    hap1 = simdata.apply_variants(ref, sorted(hom))
    hap2 = simdata.apply_variants(ref, sorted(hom + het))

    n_per_hap = coverage * length // 100 // 2
    reads = (simdata.simulate_reads(rng, ref, hap1, "chr1", n_per_hap,
                                    name_prefix="h1_")
             + simdata.simulate_reads(rng, ref, hap2, "chr1", n_per_hap,
                                      name_prefix="h2_"))
    tmp = "/tmp/rovaca_acc"
    os.makedirs(tmp, exist_ok=True)
    write_fasta(f"{tmp}/ref.fa", {"chr1": ref})
    simdata.write_test_bam(f"{tmp}/s.bam", reads, "chr1", length)
    print(f"[gen] {len(truth)} truth variants "
          f"({len(hom)} hom, {len(het)} het), {len(reads)} reads")

    t0 = time.perf_counter()
    args = HCArgs(bam_paths=[f"{tmp}/s.bam"], reference_path=f"{tmp}/ref.fa",
                  output_path=f"{tmp}/out.vcf",
                  pairhmm_engine=os.environ.get("ENGINE", "xla"),
                  log_level="WARNING")
    HaplotypeCaller(args).run()
    dt = time.perf_counter() - t0

    # parse calls; normalize alleles to (pos, ref, alt) left-aligned
    # against the reference (indels in repeats have many representations)
    calls = {}
    with open(f"{tmp}/out.vcf") as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.split("\t")
            pos0 = int(f[1]) - 1
            gt = f[9].split(":")[0]
            for alt in f[4].split(","):
                calls[_norm(pos0, f[3], alt, ref)] = gt

    truth_keys = {_norm(p, r, a, ref): g for p, r, a, g in truth}
    tp = [k for k in truth_keys if k in calls]
    fn_ = [k for k in truth_keys if k not in calls]
    fp = [k for k in calls if k not in truth_keys]
    gt_ok = 0
    for k in tp:
        want_hom = truth_keys[k] == "hom"
        got = calls[k]
        if (want_hom and got == "1/1") or (not want_hom
                                           and got in ("0/1", "1/0")):
            gt_ok += 1
    recall = len(tp) / len(truth_keys)
    precision = len(tp) / max(1, len(tp) + len(fp))
    print(f"[acc] recall={recall:.3f} ({len(tp)}/{len(truth_keys)}) "
          f"precision={precision:.3f} (FP={len(fp)}) "
          f"genotype_concordance={gt_ok / max(1, len(tp)):.3f} "
          f"wall={dt:.0f}s")
    if fn_:
        print("[acc] missed:", fn_[:8])
    if fp:
        print("[acc] spurious:", fp[:8])


def _norm(pos, ref, alt, seq):
    """VCF-normalize an allele pair: trim shared suffix, left-align through
    repeat context (the same indel has many representations), trim prefix."""
    r, a = ref, alt

    def trim_suffix(pos, r, a):
        while len(r) > 1 and len(a) > 1 and r[-1] == a[-1]:
            r, a = r[:-1], a[:-1]
        return r, a

    r, a = trim_suffix(pos, r, a)
    # left shift: while both alleles end in the same base, rotate it out
    while len(r) != len(a) and r[-1] == a[-1] and pos > 0:
        prev = seq[pos - 1]
        r, a = prev + r[:-1], prev + a[:-1]
        pos -= 1
        r, a = trim_suffix(pos, r, a)
    while len(r) > 1 and len(a) > 1 and r[0] == a[0]:
        r, a = r[1:], a[1:]
        pos += 1
    return (pos, r, a)


if __name__ == "__main__":
    main()
